// CUDA kernels K3 (closest hit) and K4 (occlusion) over a binary PacketBVH,
// designed for Hopper (sm_90a): every ray keeps its own walk, and the warp
// tests each leaf together. extern "C" launchers for ctypes.
//
// Replaces pt/accel/pallas_bvh.py:1388 packet_closest_v4 (kernel body :600)
// and :1512 packet_occluded_v4 (body :1183). The TPU kernels DMA each leaf
// page once per 1024-ray packet and test the whole packet on the MXU. The
// card's lockstep unit is the warp of 32 lanes, so this design takes the
// part of that idea that fits it: a leaf's page is read once per warp, and
// its test is shared by the lanes that want it. It does not take the packet
// walk: no lane visits a node or a leaf that its own walk would not visit.
//
// What bounded the first design (v4_kernels.cu, kept as the per-ray arm of
// the A/B, `pt_v4_closest_per_ray` / `pt_v4_occluded_per_ray`):
//   * the leaf test was a per-lane stream of scattered scalar loads: one
//     lane tested a leaf alone, 22 loads per triangle from 7 page rows
//     page_cols * 4 bytes apart, 1,408 loads per lane for a leaf of 64; when
//     the lanes of a warp sat in different leaves each load split into up to
//     32 transactions;
//   * a warp paid `block` iterations for a leaf round however many of its
//     lanes were in it, and an any-hit lane that found an occluder idled
//     while the others walked on.
//
// This design (each lane's sequence of node and leaf visits is exactly the
// per-ray walk's, v4_traverse.cuh, so v4::Counts still describes its work):
//   1. A lane walks the preorder skip links as before, pruning closest with
//      its own best t. At a leaf whose box it hits it stops with the leaf
//      pending.
//   2. When every live lane of the warp holds a pending leaf or is done,
//      __match_any_sync groups the pending lanes by leaf. Each group's leaf
//      is staged into shared memory in chunks of 32 triangles (warp_leaf.cuh:
//      22 rows of the page, 2,816 bytes, by cp.async 16-byte copies; a row
//      segment is one coalesced 128-byte line). The copy of the next chunk
//      (of this leaf, or the next group's first) is in flight while the
//      current one is tested (two stages per warp).
//   3. Lane l takes triangle l of the chunk into registers. The rays of the
//      group are broadcast by shuffle, one at a time, and every lane tests
//      its triangle against the ray: block/32 warp-wide tests per (ray,
//      leaf), one page read per group.
//   4. Closest: an order-preserving key of t (-0.0 folded into +0.0) is
//      reduced with __reduce_min_sync over the lanes that accepted, then the
//      id (ALPHA_TRI_BIT stripped) among the lanes at that key; t, u, v come
//      from the winning lane by shuffle, and the ray's own lane merges them
//      into its best with v4_traverse.cuh's rule. That rule is a running
//      lexicographic minimum of (t, id), so the chunk order does not change
//      its bits. Occlusion: a ballot; an occluded lane is done and leaves
//      the group, and a group whose lanes are all occluded stops staging.
//   5. The members resume their walks at top_miss of the leaf's node.
// The Woop and slab arithmetic is rt_common.cuh's, in its order, built with
// -fmad=false: every t, u and v rounds as in the per-ray kernels.
//
// Resources: 128 threads (4 warps) a block; shared memory 4 warps x 2
// stages x 22 x 32 f32 = 22,528 bytes a block (static). The SM's 228 KB
// would hold 10 such blocks; registers decide the occupancy: on an H100
// (nvcc 12.8) ptxas gives the closest kernel 71 registers, 7 blocks (28
// warps) a SM, and the occlusion kernel 64, 8 blocks (32 warps), as
// `pt_v4w_blocks_per_sm` reports (chip_smoke.py prints it beside ptxas's
// -v line). The launchers refuse a tree whose pages cannot be staged
// (warp_leaf.cuh's `stageable`) with cudaErrorInvalidValue.
//
// The staging, the register triangle, its Woop test and the key are
// warp_leaf.cuh's, shared with the warp K5/K6 (bf8i_warp_kernels.cu). The
// group loop below stays this kernel's own: compiled through K5/K6's loop
// and a winner function, it ran slower in an in-call A/B on an H100.
#include <cuda_runtime.h>
#include <stdint.h>

#include "v4_traverse.cuh"
#include "warp_leaf.cuh"

namespace {

using namespace warp_leaf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kLanes;

template <bool kAny>
__global__ void __launch_bounds__(kThreads)
warp_kernel(v4::Tree tree, const float* __restrict__ orig,
            const float* __restrict__ dir, const float* __restrict__ limit,
            float tmin, int n, float* __restrict__ t_out,
            int32_t* __restrict__ tri_out, float* __restrict__ u_out,
            float* __restrict__ v_out, uint8_t* __restrict__ occ_out) {
    __shared__ __align__(16) float staged[kWarps][kStages][kChunkFloats];
    const int lane = threadIdx.x & (kLanes - 1);
    const unsigned below = (1u << lane) - 1u;
    float* bufs = &staged[threadIdx.x / kLanes][0][0];
    const int i = blockIdx.x * kThreads + threadIdx.x;
    // lanes past n take part in the warp's collectives as finished lanes
    const bool valid = i < n;
    rt::Ray r = valid ? rt::make_ray(orig[3 * i], orig[3 * i + 1],
                                     orig[3 * i + 2], dir[3 * i],
                                     dir[3 * i + 1], dir[3 * i + 2])
                      : rt::make_ray(0.f, 0.f, 0.f, 1.f, 1.f, 1.f);
    const float lim = valid ? limit[i] : 0.0f;
    float best_t = lim;
    int32_t best_tri = -1;
    float best_u = 0.0f, best_v = 0.0f;
    bool occluded = false;
    int32_t node = valid ? 0 : tree.n_top;
    const int n_chunks = tree.block / kLanes;
    const size_t page_floats = (size_t)8 * (size_t)tree.page_cols;

    while (true) {
        // 1. walk on to the next leaf whose box the ray hits
        int32_t lid = -1;
        while (node >= 0 && node < tree.n_top) {
            float tn;
            if (!rt::slab(tree.top_lo + 3 * node, tree.top_hi + 3 * node, r,
                          best_t, &tn)) {
                node = tree.top_miss[node];
                continue;
            }
            int32_t l = tree.top_leaf[node];
            if (l < 0) {
                ++node;
                continue;
            }
            lid = l;
            break;
        }
        __syncwarp();
        if (__ballot_sync(kFull, lid >= 0) == 0u) break;

        // 2. group the pending lanes by leaf; a group's leader is its
        // lowest lane
        const unsigned group = __match_any_sync(kFull, lid);
        unsigned leaders = __ballot_sync(kFull,
                                         lid >= 0 && (group & below) == 0u);
        int L = __ffs(leaders) - 1;
        leaders &= leaders - 1u;
        int g_lid = __shfl_sync(kFull, lid, L);
        unsigned g_act = __shfl_sync(kFull, group, L);   // rays to test
        int g_c = 0;
        int buf = 0;
        stage_chunk(bufs, tree.pages + (size_t)g_lid * page_floats,
                    tree.page_cols, tree.block, 0, lane);
        cp_async_commit();
        while (true) {
            // the unit after this one: the leaf's next chunk while rays of
            // the group are left, else the next group's first chunk
            int n_lid = g_lid, n_c = g_c + 1;
            unsigned n_act = g_act;
            if (n_c >= n_chunks || g_act == 0u) {
                n_c = 0;
                if (leaders != 0u) {
                    L = __ffs(leaders) - 1;
                    leaders &= leaders - 1u;
                    n_lid = __shfl_sync(kFull, lid, L);
                    n_act = __shfl_sync(kFull, group, L);
                } else {
                    n_lid = -1;
                }
            }
            if (n_lid >= 0)
                stage_chunk(bufs + (buf ^ 1) * kChunkFloats,
                            tree.pages + (size_t)n_lid * page_floats,
                            tree.page_cols, tree.block, n_c, lane);
            cp_async_commit();
            cp_async_wait_one();
            __syncwarp();
            if (g_act != 0u) {
                const Tri tr = load_tri(bufs + buf * kChunkFloats, lane);
                __syncwarp();    // read before the next stage overwrites
                unsigned todo = g_act;
                while (todo != 0u) {
                    const int m = __ffs(todo) - 1;
                    todo &= todo - 1u;
                    const float ox = __shfl_sync(kFull, r.ox, m);
                    const float oy = __shfl_sync(kFull, r.oy, m);
                    const float oz = __shfl_sync(kFull, r.oz, m);
                    const float dx = __shfl_sync(kFull, r.dx, m);
                    const float dy = __shfl_sync(kFull, r.dy, m);
                    const float dz = __shfl_sync(kFull, r.dz, m);
                    const float mlim = __shfl_sync(kFull, lim, m);
                    float u, v;
                    const float t = woop(tr, ox, oy, oz, dx, dy, dz, &u, &v);
                    const bool ok = tr.id >= 0
                                    && rt::accept(t, u, v, tmin, mlim);
                    if constexpr (kAny) {
                        if (__any_sync(kFull, ok)) {
                            g_act &= ~(1u << m);
                            if (lane == m) {
                                occluded = true;
                                node = tree.n_top;
                            }
                        }
                    } else {
                        const unsigned key = ok ? t_key(t) : kNoKey;
                        const unsigned kmin = __reduce_min_sync(kFull, key);
                        if (kmin == kNoKey) continue;
                        const unsigned idc =
                            (ok && key == kmin)
                                ? (unsigned)(tr.id & ~rt::kAlphaTriBit)
                                : kNoKey;
                        const unsigned imin = __reduce_min_sync(kFull, idc);
                        const int win =
                            __ffs(__ballot_sync(kFull, idc == imin)) - 1;
                        const float wt = __shfl_sync(kFull, t, win);
                        const float wu = __shfl_sync(kFull, u, win);
                        const float wv = __shfl_sync(kFull, v, win);
                        const int32_t wid = (int32_t)imin;
                        if (lane == m && (wt < best_t
                                          || (wt == best_t && best_tri >= 0
                                              && wid < best_tri))) {
                            best_t = wt;
                            best_tri = wid;
                            best_u = wu;
                            best_v = wv;
                        }
                    }
                }
            }
            if (n_lid < 0) break;
            if (n_c == 0) g_act = n_act;   // a new group
            g_lid = n_lid;
            g_c = n_c;
            buf ^= 1;
        }
        // 3. the members resume their walks after the leaf
        if (lid >= 0 && !occluded) node = tree.top_miss[node];
    }
    if (!valid) return;
    if constexpr (kAny) {
        occ_out[i] = occluded ? 1 : 0;
    } else {
        t_out[i] = best_t;
        tri_out[i] = best_tri;
        u_out[i] = best_u;
        v_out[i] = best_v;
    }
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

int pt_v4w_closest(const float* top_lo, const float* top_hi,
                   const int32_t* top_miss, const int32_t* top_leaf,
                   const float* pages, int n_top, int block, int page_cols,
                   const float* orig, const float* dir, const float* tmax,
                   float tmin, int n, float* t_out, int32_t* tri_out,
                   float* u_out, float* v_out, void* stream) {
    if (n <= 0) return 0;
    if (!stageable(pages, block, page_cols))
        return (int)cudaErrorInvalidValue;
    v4::Tree tree = make_tree(top_lo, top_hi, top_miss, top_leaf, pages,
                              n_top, block, page_cols);
    int blocks = (n + kThreads - 1) / kThreads;
    warp_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        tree, orig, dir, tmax, tmin, n, t_out, tri_out, u_out, v_out,
        nullptr);
    return (int)cudaGetLastError();
}

int pt_v4w_occluded(const float* top_lo, const float* top_hi,
                    const int32_t* top_miss, const int32_t* top_leaf,
                    const float* pages, int n_top, int block, int page_cols,
                    const float* orig, const float* dir, const float* dist,
                    float tmin, int n, uint8_t* out, void* stream) {
    if (n <= 0) return 0;
    if (!stageable(pages, block, page_cols))
        return (int)cudaErrorInvalidValue;
    v4::Tree tree = make_tree(top_lo, top_hi, top_miss, top_leaf, pages,
                              n_top, block, page_cols);
    int blocks = (n + kThreads - 1) / kThreads;
    warp_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        tree, orig, dir, dist, tmin, n, nullptr, nullptr, nullptr, nullptr,
        out);
    return (int)cudaGetLastError();
}

// Resident blocks per SM of the closest (any_hit 0) or occlusion kernel,
// and the static shared memory per block; a negative CUDA error code on
// failure.
int pt_v4w_blocks_per_sm(int any_hit) {
    int blocks = 0;
    cudaError_t e = any_hit
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, warp_kernel<true>, kThreads, 0)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, warp_kernel<false>, kThreads, 0);
    return e == cudaSuccess ? blocks : -(int)e;
}

int pt_v4w_smem_per_block() {
    return (int)(sizeof(float) * kWarps * kStages * kChunkFloats);
}

const char* pt_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
