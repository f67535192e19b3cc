// CUDA kernels K1 (closest hit) and K2 (occlusion) over a BF8 BVH, for
// sm_90a, with extern "C" launchers for ctypes.
//
// K1 replaces pt/accel/pallas_bvh.py:packet_closest_bf8 and K2 replaces
// pt/accel/pallas_bvh.py:packet_occluded_bf8. One thread per ray, blocks of
// 128 threads on a 1-D grid; the per-ray code is bf8_traverse.cuh. Rays come
// as contiguous (N, 3) f32 origins and directions and an (N,) f32 tmax or
// dist. A launch with `stats` (3 uint64) null runs the uncounted variant,
// which carries no counting code; with it, the counted variant adds the
// run's totals of node visits, leaf-box retests and triangle tests there and
// sets node_seen (n8,) and tri_seen (L * block,) to 1 where a wide node was
// visited or a page column tested. A closest launch with `pops` (N int32)
// non-null runs the pops variant, which writes each lane's iterations of its
// walk loop there (one per pop of a wide node or a leaf; no atomics): the
// per-ray arm of the pops launch that the port's benches/budget.py:rounds_of
// and benches/drain_sim.py:done_rounds_of read (pt's diagnostic rows 4 and
// 5, the lockstep rounds), bf8_warp_kernels.cu's pops instance. A warp of
// 32 lanes steps in lockstep until its slowest lane is done, so the max of
// a warp's pops is its rounds. The hits are those of the
// uncounted launch. The kernels allocate nothing; each launcher returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// What bounds them: dependent global loads of node and page rows, not
// FLOPs; this first design does nothing about that yet.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf8_traverse.cuh"

namespace {

constexpr int kThreads = 128;

// Where a counted launch writes: totals (3 uint64) and the seen flags.
struct Stats {
    unsigned long long* totals;
    uint8_t* node_seen;
    uint8_t* tri_seen;
};

template <bool kCount>
__device__ void add_counts(const Stats& stats, const bf8::Counts& c) {
    if constexpr (kCount) {
        atomicAdd(stats.totals + 0, c.nodes);
        atomicAdd(stats.totals + 1, c.leaf_boxes);
        atomicAdd(stats.totals + 2, c.tris);
    }
}

template <bool kCount, bool kPops>
__global__ void closest_kernel(bf8::Tree tree, const float* __restrict__ orig,
                               const float* __restrict__ dir,
                               const float* __restrict__ tmax, float tmin,
                               int n, float* __restrict__ t_out,
                               int32_t* __restrict__ tri_out,
                               float* __restrict__ u_out,
                               float* __restrict__ v_out, Stats stats,
                               int32_t* __restrict__ pops) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    bf8::Ray r = bf8::make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                               dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]);
    float t, u, v;
    int32_t tri, n_pops;
    bf8::Counts counts = {0, 0, 0, stats.node_seen, stats.tri_seen};
    bf8::closest<kCount, kPops>(tree, r, tmin, tmax[i], &t, &tri, &u, &v,
                                &counts, &n_pops);
    add_counts<kCount>(stats, counts);
    t_out[i] = t;
    tri_out[i] = tri;
    u_out[i] = u;
    v_out[i] = v;
    if constexpr (kPops) pops[i] = n_pops;
}

template <bool kCount, bool kPops>
void launch_closest(const bf8::Tree& tree, const float* orig,
                    const float* dir, const float* tmax, float tmin, int n,
                    float* t_out, int32_t* tri_out, float* u_out,
                    float* v_out, const Stats& st, int32_t* pops,
                    cudaStream_t stream) {
    int blocks = (n + kThreads - 1) / kThreads;
    closest_kernel<kCount, kPops><<<blocks, kThreads, 0, stream>>>(
        tree, orig, dir, tmax, tmin, n, t_out, tri_out, u_out, v_out, st,
        pops);
}

template <bool kCount>
__global__ void occluded_kernel(bf8::Tree tree,
                                const float* __restrict__ orig,
                                const float* __restrict__ dir,
                                const float* __restrict__ dist, float tmin,
                                int opaque_only, int n,
                                uint8_t* __restrict__ out, Stats stats) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    bf8::Ray r = bf8::make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                               dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]);
    bf8::Counts counts = {0, 0, 0, stats.node_seen, stats.tri_seen};
    out[i] = bf8::occluded<kCount>(tree, r, tmin, dist[i], opaque_only != 0,
                                   &counts) ? 1 : 0;
    add_counts<kCount>(stats, counts);
}

bf8::Tree make_tree(const float* c_lo, const float* c_hi, const int32_t* c_ent,
                    const float* l_lo, const float* l_hi, const float* pages,
                    int block, int page_cols) {
    bf8::Tree tree;
    tree.c_lo = c_lo;
    tree.c_hi = c_hi;
    tree.c_ent = c_ent;
    tree.l_lo = l_lo;
    tree.l_hi = l_hi;
    tree.pages = pages;
    tree.block = block;
    tree.page_cols = page_cols;
    return tree;
}

}  // namespace

extern "C" {

int pt_bf8_closest(const float* c_lo, const float* c_hi, const int32_t* c_ent,
                   const float* l_lo, const float* l_hi, const float* pages,
                   int block, int page_cols, const float* orig,
                   const float* dir, const float* tmax, float tmin, int n,
                   float* t_out, int32_t* tri_out, float* u_out,
                   float* v_out, unsigned long long* stats,
                   uint8_t* node_seen, uint8_t* tri_seen, int32_t* pops,
                   void* stream) {
    if (n <= 0) return 0;
    bf8::Tree tree = make_tree(c_lo, c_hi, c_ent, l_lo, l_hi, pages, block,
                               page_cols);
    Stats st = {stats, node_seen, tri_seen};
    cudaStream_t s = (cudaStream_t)stream;
    if (stats == nullptr && pops == nullptr)
        launch_closest<false, false>(tree, orig, dir, tmax, tmin, n, t_out,
                                     tri_out, u_out, v_out, st, pops, s);
    else if (stats == nullptr)
        launch_closest<false, true>(tree, orig, dir, tmax, tmin, n, t_out,
                                    tri_out, u_out, v_out, st, pops, s);
    else if (pops == nullptr)
        launch_closest<true, false>(tree, orig, dir, tmax, tmin, n, t_out,
                                    tri_out, u_out, v_out, st, pops, s);
    else
        launch_closest<true, true>(tree, orig, dir, tmax, tmin, n, t_out,
                                   tri_out, u_out, v_out, st, pops, s);
    return (int)cudaGetLastError();
}

// Threads per block of every launch above: lane i runs in block i / T and,
// within it, in warp (i % T) / 32.
int pt_bf8_threads_per_block(void) { return kThreads; }

int pt_bf8_occluded(const float* c_lo, const float* c_hi,
                    const int32_t* c_ent, const float* l_lo,
                    const float* l_hi, const float* pages, int block,
                    int page_cols, const float* orig, const float* dir,
                    const float* dist, float tmin, int opaque_only, int n,
                    uint8_t* out, unsigned long long* stats,
                    uint8_t* node_seen, uint8_t* tri_seen, void* stream) {
    if (n <= 0) return 0;
    bf8::Tree tree = make_tree(c_lo, c_hi, c_ent, l_lo, l_hi, pages, block,
                               page_cols);
    Stats st = {stats, node_seen, tri_seen};
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
