// The first design of K3 (closest hit) and K4 (occlusion) over a binary
// PacketBVH, for sm_90a, with extern "C" launchers for ctypes: the per-ray
// arm of the A/B against the warp-cooperative kernels of
// v4_warp_kernels.cu, which the render path launches. Exported as
// pt_v4_closest_per_ray / pt_v4_occluded_per_ray; the counted variant lives
// only here (its walk is the warp kernels' walk, so its counts describe
// their work too).
//
// K3 replaces pt/accel/pallas_bvh.py:packet_closest_v4 and K4 replaces
// pt/accel/pallas_bvh.py:packet_occluded_v4. One thread per ray, blocks of
// 128 threads on a 1-D grid; the per-ray code is v4_traverse.cuh (a stackless
// walk along the preorder skip links). Rays come as contiguous (N, 3) f32
// origins and directions and an (N,) f32 tmax or dist. A launch with `stats`
// (2 uint64) null runs the uncounted variant, which carries no counting
// code; with it, the counted variant adds the run's totals of node visits
// and triangle tests there and sets node_seen (n_top,) and tri_seen
// (L * block,) to 1 where a node was visited or a page column tested. The
// kernels allocate nothing; each launcher returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
//
// What bounds them: dependent global loads of node and page rows, not FLOPs;
// a lane tests each leaf alone with scattered scalar loads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "v4_traverse.cuh"

namespace {

constexpr int kThreads = 128;

// Where a counted launch writes: totals (2 uint64) and the seen flags.
struct Stats {
    unsigned long long* totals;
    uint8_t* node_seen;
    uint8_t* tri_seen;
};

template <bool kCount>
__device__ void add_counts(const Stats& stats, const v4::Counts& c) {
    if constexpr (kCount) {
        atomicAdd(stats.totals + 0, c.nodes);
        atomicAdd(stats.totals + 1, c.tris);
    }
}

template <bool kCount>
__global__ void closest_kernel(v4::Tree tree, const float* __restrict__ orig,
                               const float* __restrict__ dir,
                               const float* __restrict__ tmax, float tmin,
                               int n, float* __restrict__ t_out,
                               int32_t* __restrict__ tri_out,
                               float* __restrict__ u_out,
                               float* __restrict__ v_out, Stats stats) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    rt::Ray r = rt::make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                             dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]);
    float t, u, v;
    int32_t tri;
    v4::Counts counts = {0, 0, stats.node_seen, stats.tri_seen};
    v4::closest<kCount>(tree, r, tmin, tmax[i], &t, &tri, &u, &v, &counts);
    add_counts<kCount>(stats, counts);
    t_out[i] = t;
    tri_out[i] = tri;
    u_out[i] = u;
    v_out[i] = v;
}

template <bool kCount>
__global__ void occluded_kernel(v4::Tree tree,
                                const float* __restrict__ orig,
                                const float* __restrict__ dir,
                                const float* __restrict__ dist, float tmin,
                                int n, uint8_t* __restrict__ out,
                                Stats stats) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    rt::Ray r = rt::make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                             dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]);
    v4::Counts counts = {0, 0, stats.node_seen, stats.tri_seen};
    out[i] = v4::occluded<kCount>(tree, r, tmin, dist[i], &counts) ? 1 : 0;
    add_counts<kCount>(stats, counts);
}

v4::Tree make_tree(const float* top_lo, const float* top_hi,
                   const int32_t* top_miss, const int32_t* top_leaf,
                   const float* pages, int n_top, int block, int page_cols) {
    v4::Tree tree;
    tree.top_lo = top_lo;
    tree.top_hi = top_hi;
    tree.top_miss = top_miss;
    tree.top_leaf = top_leaf;
    tree.pages = pages;
    tree.n_top = n_top;
    tree.block = block;
    tree.page_cols = page_cols;
    return tree;
}

}  // namespace

extern "C" {

int pt_v4_closest_per_ray(const float* top_lo, const float* top_hi,
                  const int32_t* top_miss, const int32_t* top_leaf,
                  const float* pages, int n_top, int block, int page_cols,
                  const float* orig, const float* dir, const float* tmax,
                  float tmin, int n, float* t_out, int32_t* tri_out,
                  float* u_out, float* v_out, unsigned long long* stats,
                  uint8_t* node_seen, uint8_t* tri_seen, void* stream) {
    if (n <= 0) return 0;
    v4::Tree tree = make_tree(top_lo, top_hi, top_miss, top_leaf, pages,
                              n_top, block, page_cols);
    Stats st = {stats, node_seen, tri_seen};
    int blocks = (n + kThreads - 1) / kThreads;
    if (stats == nullptr)
        closest_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            tree, orig, dir, tmax, tmin, n, t_out, tri_out, u_out, v_out, st);
    else
        closest_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            tree, orig, dir, tmax, tmin, n, t_out, tri_out, u_out, v_out, st);
    return (int)cudaGetLastError();
}

int pt_v4_occluded_per_ray(const float* top_lo, const float* top_hi,
                   const int32_t* top_miss, const int32_t* top_leaf,
                   const float* pages, int n_top, int block, int page_cols,
                   const float* orig, const float* dir, const float* dist,
                   float tmin, int n, uint8_t* out,
                   unsigned long long* stats, uint8_t* node_seen,
                   uint8_t* tri_seen, void* stream) {
    if (n <= 0) return 0;
    v4::Tree tree = make_tree(top_lo, top_hi, top_miss, top_leaf, pages,
                              n_top, block, page_cols);
    Stats st = {stats, node_seen, tri_seen};
    int blocks = (n + kThreads - 1) / kThreads;
    if (stats == nullptr)
        occluded_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            tree, orig, dir, dist, tmin, n, out, st);
    else
        occluded_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            tree, orig, dir, dist, tmin, n, out, st);
    return (int)cudaGetLastError();
}

const char* pt_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
