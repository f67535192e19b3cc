// CUDA kernels over a BF8V6 tree, for sm_90a, with extern "C" launchers
// for ctypes:
//   closest_v6    replaces pt/accel/pallas_bvh_archive.py:packet_closest_v6
//                 (A3), one pop per iteration (`walk` = 0);
//   closest_v6k2  replaces :packet_closest_v6k2 (A4), two pops per
//                 iteration (same launcher, `walk` = 1);
//   closest_v7    replaces :packet_closest_v7 (A5), leaf tests deferred into
//                 a queue drained every `window` pops (`walk` = 2);
//   occluded_v6   replaces :packet_occluded_v6 (A6).
// One thread per ray, blocks of 128 threads on a 1-D grid; the per-ray code
// is v6_traverse.cuh, a 128-entry stack per thread in local memory (and, for
// closest_v7, a 48-entry leaf queue). Rays come as contiguous (N, 3) f32
// origins and directions and an (N,) f32 tmax or dist. A launch with `stats` (3 uint64) null runs the uncounted
// variant, which carries no counting code; with it, the counted variant adds
// the run's totals of wide-node visits, leaf-box retests and triangle tests
// there and sets node_seen (n8,) and tri_seen (L * block,) to 1 where a
// wide node was visited or a page column tested. The kernels allocate
// nothing; each launcher returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.
//
// What bounds them: dependent global loads of node rows and pages, not
// FLOPs, as K1/K2; this first design does nothing about that yet.
#include <cuda_runtime.h>
#include <stdint.h>

#include "v6_traverse.cuh"

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

enum Walk { kOnePop = 0, kTwoPops = 1, kLeafQueue = 2 };

template <bool kCount, int kWalk>
__global__ void closest_kernel(v6::Tree tree, const float* __restrict__ orig,
                               const float* __restrict__ dir,
                               const float* __restrict__ tmax, float tmin,
                               int window, int n, float* __restrict__ t_out,
                               int32_t* __restrict__ tri_out,
                               float* __restrict__ u_out,
                               float* __restrict__ v_out, Stats stats) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    rt::Ray r = rt::make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                             dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]);
    float t, u, v;
    int32_t tri;
    bf8::Counts counts = {0, 0, 0, stats.node_seen, stats.tri_seen};
    if constexpr (kWalk == kTwoPops)
        v6::closest_two_pops<kCount>(tree, r, tmin, tmax[i], &t, &tri, &u,
                                     &v, &counts);
    else if constexpr (kWalk == kLeafQueue)
        v6::closest_leaf_queue<kCount>(tree, r, tmin, tmax[i], window, &t,
                                       &tri, &u, &v, &counts);
    else
        v6::closest<kCount>(tree, r, tmin, tmax[i], &t, &tri, &u, &v,
                            &counts);
    add_counts<kCount>(stats, counts);
    t_out[i] = t;
    tri_out[i] = tri;
    u_out[i] = u;
    v_out[i] = v;
}

template <bool kCount>
__global__ void occluded_kernel(v6::Tree tree, const float* __restrict__ orig,
                                const float* __restrict__ dir,
                                const float* __restrict__ dist, float tmin,
                                int n, uint8_t* __restrict__ out,
                                Stats stats) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    rt::Ray r = rt::make_ray(orig[3 * i], orig[3 * i + 1], orig[3 * i + 2],
                             dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]);
    bf8::Counts counts = {0, 0, 0, stats.node_seen, stats.tri_seen};
    out[i] = v6::occluded<kCount>(tree, r, tmin, dist[i], &counts) ? 1 : 0;
    add_counts<kCount>(stats, counts);
}

v6::Tree make_tree(const float* u_lo, const float* u_hi, const int32_t* c_ent,
                   const int32_t* c_order, const float* pages, int n8,
                   int block, int page_cols) {
    v6::Tree tree;
    tree.u_lo = u_lo;
    tree.u_hi = u_hi;
    tree.c_ent = c_ent;
    tree.c_order = c_order;
    tree.pages = pages;
    tree.n8 = n8;
    tree.block = block;
    tree.page_cols = page_cols;
    return tree;
}

template <int kWalk>
void launch_closest(const v6::Tree& tree, const float* orig, const float* dir,
                    const float* tmax, float tmin, int window, int n,
                    float* t_out, int32_t* tri_out, float* u_out,
                    float* v_out, const Stats& st, cudaStream_t stream) {
    int blocks = (n + kThreads - 1) / kThreads;
    if (st.totals == nullptr)
        closest_kernel<false, kWalk><<<blocks, kThreads, 0, stream>>>(
            tree, orig, dir, tmax, tmin, window, n, t_out, tri_out, u_out,
            v_out, st);
    else
        closest_kernel<true, kWalk><<<blocks, kThreads, 0, stream>>>(
            tree, orig, dir, tmax, tmin, window, n, t_out, tri_out, u_out,
            v_out, st);
}

}  // namespace

extern "C" {

int pt_v6_closest(const float* u_lo, const float* u_hi, const int32_t* c_ent,
                  const int32_t* c_order, const float* pages, int n8,
                  int block, int page_cols, const float* orig,
                  const float* dir, const float* tmax, float tmin,
                  int walk, int window, int n, float* t_out,
                  int32_t* tri_out, float* u_out, float* v_out,
                  unsigned long long* stats, uint8_t* node_seen,
                  uint8_t* tri_seen, void* stream) {
    if (n <= 0) return 0;
    if (walk < kOnePop || walk > kLeafQueue || window < 1)
        return (int)cudaErrorInvalidValue;
    v6::Tree tree = make_tree(u_lo, u_hi, c_ent, c_order, pages, n8, block,
                              page_cols);
    Stats st = {stats, node_seen, tri_seen};
    cudaStream_t s = (cudaStream_t)stream;
    if (walk == kTwoPops)
        launch_closest<kTwoPops>(tree, orig, dir, tmax, tmin, window, n,
                                 t_out, tri_out, u_out, v_out, st, s);
    else if (walk == kLeafQueue)
        launch_closest<kLeafQueue>(tree, orig, dir, tmax, tmin, window, n,
                                   t_out, tri_out, u_out, v_out, st, s);
    else
        launch_closest<kOnePop>(tree, orig, dir, tmax, tmin, window, n,
                                t_out, tri_out, u_out, v_out, st, s);
    return (int)cudaGetLastError();
}

int pt_v6_occluded(const float* u_lo, const float* u_hi,
                   const int32_t* c_ent, const int32_t* c_order,
                   const float* pages, int n8, int block, int page_cols,
                   const float* orig, const float* dir, const float* dist,
                   float tmin, int n, uint8_t* out,
                   unsigned long long* stats, uint8_t* node_seen,
                   uint8_t* tri_seen, void* stream) {
    if (n <= 0) return 0;
    v6::Tree tree = make_tree(u_lo, u_hi, c_ent, c_order, pages, n8, block,
                              page_cols);
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
