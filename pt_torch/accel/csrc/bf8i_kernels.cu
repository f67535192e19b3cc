// CUDA kernels K5 (closest hit) and K6 (occlusion) over an instanced BF8 BVH
// (shared object-space pages behind per-leaf instance transforms), for
// sm_90a, with extern "C" launchers for ctypes: their first design, one
// thread per ray.
//
// K5 replaces pt/accel/instanced.py:packet_closest_bf8i and K6 replaces
// pt/accel/instanced.py:packet_occluded_bf8i. The render path launches the
// warp-cooperative design (bf8i_warp_kernels.cu); these kernels are the
// per-ray arm of its A/B and its counted variant (the walk is the same),
// exported as `pt_bf8i_closest_per_ray` / `pt_bf8i_occluded_per_ray`. One
// thread per ray, blocks of 128 threads on a 1-D grid; the per-ray code is
// bf8i_traverse.cuh. Rays come as contiguous (N, 3) f32 origins and
// directions and an (N,) f32 tmax or dist. A launch with `stats` (4 uint64)
// null runs the uncounted variant, which carries no counting code; with it,
// the counted variant adds the run's totals of node visits, leaf-box
// retests, leaf visits and triangle tests there and sets node_seen (n8,),
// leaf_seen (L,) and tri_seen (P * block,) to 1 where a wide node or a leaf
// was visited or a page column tested. The kernels allocate nothing; each
// launcher returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.
//
// What bounds them: dependent global loads of node, index, transform and
// page rows, not FLOPs; a lane tests each leaf alone, `block` iterations of
// scattered page loads (see bf8i_warp_kernels.cu).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf8i_traverse.cuh"

namespace {

constexpr int kThreads = 128;

// Where a counted launch writes: totals (4 uint64) and the seen flags.
struct Stats {
    unsigned long long* totals;
    uint8_t* node_seen;
    uint8_t* leaf_seen;
    uint8_t* tri_seen;
};

template <bool kCount>
__device__ void add_counts(const Stats& stats, const bf8i::Counts& c) {
    if constexpr (kCount) {
        atomicAdd(stats.totals + 0, c.nodes);
        atomicAdd(stats.totals + 1, c.leaf_boxes);
        atomicAdd(stats.totals + 2, c.leaf_visits);
        atomicAdd(stats.totals + 3, c.tris);
    }
}

__device__ bf8i::Counts start_counts(const Stats& stats) {
    bf8i::Counts c = {0, 0, 0, 0, stats.node_seen, stats.leaf_seen,
                      stats.tri_seen};
    return c;
}

template <bool kCount>
__global__ void closest_kernel(bf8i::Tree tree,
                               const float* __restrict__ orig,
                               const float* __restrict__ dir,
                               const float* __restrict__ tmax, float tmin,
                               int raw_ids, int n, float* __restrict__ t_out,
                               int32_t* __restrict__ tri_out,
                               float* __restrict__ u_out,
                               float* __restrict__ v_out, Stats stats) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    rt::Ray r = rt::make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                             dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]);
    float t, u, v;
    int32_t tri;
    bf8i::Counts counts = start_counts(stats);
    bf8i::closest<kCount>(tree, r, tmin, tmax[i], raw_ids != 0, &t, &tri, &u,
                          &v, &counts);
    add_counts<kCount>(stats, counts);
    t_out[i] = t;
    tri_out[i] = tri;
    u_out[i] = u;
    v_out[i] = v;
}

template <bool kCount>
__global__ void occluded_kernel(bf8i::Tree tree,
                                const float* __restrict__ orig,
                                const float* __restrict__ dir,
                                const float* __restrict__ dist, float tmin,
                                int opaque_only, int n,
                                uint8_t* __restrict__ out, Stats stats) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    rt::Ray r = rt::make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                             dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]);
    bf8i::Counts counts = start_counts(stats);
    out[i] = bf8i::occluded<kCount>(tree, r, tmin, dist[i], opaque_only != 0,
                                    &counts) ? 1 : 0;
    add_counts<kCount>(stats, counts);
}

bf8i::Tree make_tree(const float* c_lo, const float* c_hi,
                     const int32_t* c_ent, const float* l_lo,
                     const float* l_hi, const int32_t* leaf_page,
                     const int32_t* leaf_seg, const float* seg_inv,
                     const float* pages, int block, int page_cols) {
    bf8i::Tree tree;
    tree.top.c_lo = c_lo;
    tree.top.c_hi = c_hi;
    tree.top.c_ent = c_ent;
    tree.top.l_lo = l_lo;
    tree.top.l_hi = l_hi;
    tree.top.pages = pages;
    tree.top.block = block;
    tree.top.page_cols = page_cols;
    tree.leaf_page = leaf_page;
    tree.leaf_seg = leaf_seg;
    tree.seg_inv = seg_inv;
    return tree;
}

}  // namespace

extern "C" {

int pt_bf8i_closest_per_ray(const float* c_lo, const float* c_hi,
                            const int32_t* c_ent, const float* l_lo,
                            const float* l_hi, const int32_t* leaf_page,
                            const int32_t* leaf_seg, const float* seg_inv,
                            const float* pages, int block, int page_cols,
                            const float* orig, const float* dir,
                            const float* tmax, float tmin, int raw_ids,
                            int n, float* t_out, int32_t* tri_out,
                            float* u_out, float* v_out,
                            unsigned long long* stats, uint8_t* node_seen,
                            uint8_t* leaf_seen, uint8_t* tri_seen,
                            void* stream) {
    if (n <= 0) return 0;
    bf8i::Tree tree = make_tree(c_lo, c_hi, c_ent, l_lo, l_hi, leaf_page,
                                leaf_seg, seg_inv, pages, block, page_cols);
    Stats st = {stats, node_seen, leaf_seen, tri_seen};
    int blocks = (n + kThreads - 1) / kThreads;
    if (stats == nullptr)
        closest_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            tree, orig, dir, tmax, tmin, raw_ids, n, t_out, tri_out, u_out,
            v_out, st);
    else
        closest_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            tree, orig, dir, tmax, tmin, raw_ids, n, t_out, tri_out, u_out,
            v_out, st);
    return (int)cudaGetLastError();
}

int pt_bf8i_occluded_per_ray(const float* c_lo, const float* c_hi,
                             const int32_t* c_ent, const float* l_lo,
                             const float* l_hi, const int32_t* leaf_page,
                             const int32_t* leaf_seg, const float* seg_inv,
                             const float* pages, int block, int page_cols,
                             const float* orig, const float* dir,
                             const float* dist, float tmin, int opaque_only,
                             int n, uint8_t* out, unsigned long long* stats,
                             uint8_t* node_seen, uint8_t* leaf_seen,
                             uint8_t* tri_seen, void* stream) {
    if (n <= 0) return 0;
    bf8i::Tree tree = make_tree(c_lo, c_hi, c_ent, l_lo, l_hi, leaf_page,
                                leaf_seg, seg_inv, pages, block, page_cols);
    Stats st = {stats, node_seen, leaf_seen, tri_seen};
    int blocks = (n + kThreads - 1) / kThreads;
    if (stats == nullptr)
        occluded_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            tree, orig, dir, dist, tmin, opaque_only, n, out, st);
    else
        occluded_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            tree, orig, dir, dist, tmin, opaque_only, n, out, st);
    return (int)cudaGetLastError();
}

const char* pt_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
