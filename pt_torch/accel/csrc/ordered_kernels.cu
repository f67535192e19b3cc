// CUDA kernel `closest_ordered`: the ordered (near-child-first) stack walk
// of a binary PacketBVH, for sm_90a, with an extern "C" launcher for ctypes.
//
// Replaces pt/accel/pallas_bvh_archive.py:packet_closest (A7),
// :packet_closest_sub (A10) and :packet_closest_v3 (A1), whose Pallas
// bodies walk the same tree in the same order and differ only in how they
// schedule 1024-ray packets on the TPU. The first design, kept as the
// per-ray arm of the A/B against the warp-cooperative kernel
// (ordered_warp_kernels.cu, which the wrappers launch) and as the counted
// variant. One thread per ray, blocks of 128 threads on a 1-D grid; the
// per-ray code is ordered_traverse.cuh, a 64-entry stack per thread in
// local memory. Rays come as contiguous (N, 3) f32 origins and directions
// and an (N,) f32 tmax. A launch with `stats`
// (2 uint64) null runs the uncounted variant, which carries no counting
// code; with it, the counted variant adds the run's totals of box tests
// (each node's box counted once, not its pop retest) and triangle tests
// there and sets node_seen (n_top,) and tri_seen (L * block,) to 1 where a
// node's box was read or a page column tested.
// The kernel allocates nothing; the launcher returns cudaGetLastError() so
// the Python wrapper can raise on a refused launch.
//
// What bounds it: dependent global loads of node rows and pages, as K3; the
// design's point is fewer of them than K3's stackless walk makes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ordered_traverse.cuh"

namespace {

constexpr int kThreads = 128;

// Where a counted launch writes: totals (2 uint64) and the seen flags.
struct Stats {
    unsigned long long* totals;
    uint8_t* node_seen;
    uint8_t* tri_seen;
};

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
    ordered::closest<kCount>(tree, r, tmin, tmax[i], &t, &tri, &u, &v,
                             &counts);
    if constexpr (kCount) {
        atomicAdd(stats.totals + 0, counts.nodes);
        atomicAdd(stats.totals + 1, counts.tris);
    }
    t_out[i] = t;
    tri_out[i] = tri;
    u_out[i] = u;
    v_out[i] = v;
}

}  // namespace

extern "C" {

int pt_ordered_closest(const float* top_lo, const float* top_hi,
                       const int32_t* top_miss, const int32_t* top_leaf,
                       const float* pages, int n_top, int block,
                       int page_cols, const float* orig, const float* dir,
                       const float* tmax, float tmin, int n, float* t_out,
                       int32_t* tri_out, float* u_out, float* v_out,
                       unsigned long long* stats, uint8_t* node_seen,
                       uint8_t* tri_seen, void* stream) {
    if (n <= 0) return 0;
    v4::Tree tree;
    tree.top_lo = top_lo;
    tree.top_hi = top_hi;
    tree.top_miss = top_miss;
    tree.top_leaf = top_leaf;
    tree.pages = pages;
    tree.n_top = n_top;
    tree.block = block;
    tree.page_cols = page_cols;
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

const char* pt_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
