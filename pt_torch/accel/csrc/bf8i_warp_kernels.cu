// CUDA kernels K5 (closest hit) and K6 (occlusion) over an instanced BF8
// BVH, designed for Hopper (sm_90a): every ray keeps its own walk in its own
// instance space, and the warp tests each pending shared page together.
// extern "C" launchers for ctypes.
//
// Replaces pt/accel/instanced.py:811 packet_closest_bf8i (kernel body :457)
// and :858 packet_occluded_bf8i (body :643). The TPU kernels DMA each
// shared page once per packet and test the packet's object-space rays on
// the MXU. Here a page is read once per group of a warp's lanes that want
// it, and its test is shared by those lanes; no lane visits a node or a
// leaf that its own walk would not visit.
//
// What bounded the first design (bf8i_kernels.cu, kept as the per-ray arm
// of the A/B, `pt_bf8i_closest_per_ray` / `pt_bf8i_occluded_per_ray`): one
// lane tested a leaf alone, `block` iterations (pt's caps force leaves of
// 128) of 22 scattered loads from 7 page rows page_cols * 4 bytes apart,
// however many lanes of the warp were in that leaf.
//
// This design (each lane's sequence of node and leaf visits is exactly the
// per-ray walk's, bf8i_traverse.cuh, so bf8i::Counts still describes its
// work):
//   1. A lane runs bf8i::closest's / ::occluded's stack walk over the world
//      boxes: closest pushes far-first (push_near_first) and retests a
//      popped leaf's box against its own best t, occlusion pushes in child
//      order (push_hit). It stops at a leaf to test, with the leaf pending.
//   2. The lane reads the leaf's page and segment and maps its ray into the
//      segment's object space (bf8i::to_object, in its order of
//      operations).
//   3. When every live lane of the warp holds a pending leaf or is done,
//      the warp groups the lanes by *page*, not by leaf: many leaves share
//      a page (P << L), so lanes in different instances of the same mesh
//      part share one staged page (warp_leaf.cuh's `test_groups`:
//      32-triangle chunks staged by cp.async, the next chunk in flight, as
//      v4_warp_kernels.cu does). Each member's object-space ray
//      and limit are broadcast by shuffle in turn; lane l tests triangle l.
//      A chunk with fewer columns that can accept than rays to test (the
//      alpha cards' pages hold a few triangles padded out to `block`) is
//      tested the other way round: each member's own lane runs its ray
//      against those columns, read from the staged chunk, in column order.
//   4. Closest: the chunk's winner (least key of t, then least mesh-local
//      id, ALPHA_TRI_BIT stripped; t, u, v and the raw id from the winning
//      lane) is branded with the member's segment on the member's own lane
//      and merged with bf8i_traverse.cuh's rule. Within one (ray, page)
//      test the brand is constant, so the least mesh-local id is the least
//      branded id; the rule is a running lexicographic minimum of (t, id),
//      so chunk and group order change no bit; a member's own lane merges
//      columns with the same rule. Occlusion: a ballot, columns tagged
//      ALPHA_TRI_BIT rejected under opaque_only; an occluded lane is done
//      and leaves its group.
//   5. The members resume their walks (the next pop of their own stacks).
// Built with -fmad=false: every t, u and v rounds as in the per-ray kernels.
//
// Resources: 128 threads (4 warps) a block; 22,528 bytes of static shared
// memory a block (4 warps x 2 stages x 22 x 32 f32); each lane's stack of
// bf8::kStackDepth entries lives in local memory, as in the per-ray kernels.
// `pt_bf8iw_blocks_per_sm` reports the resident blocks (chip_smoke.py prints
// it beside ptxas's -v line). The launchers refuse a structure whose pages
// cannot be staged (`stageable`) with cudaErrorInvalidValue.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf8i_traverse.cuh"
#include "warp_leaf.cuh"

namespace {

using namespace warp_leaf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kLanes;

// `flag`: raw_ids for closest, opaque_only for occlusion
template <bool kAny>
__global__ void __launch_bounds__(kThreads)
warp_kernel(bf8i::Tree tree, const float* __restrict__ orig,
            const float* __restrict__ dir, const float* __restrict__ limit,
            float tmin, int flag, int n, float* __restrict__ t_out,
            int32_t* __restrict__ tri_out, float* __restrict__ u_out,
            float* __restrict__ v_out, uint8_t* __restrict__ occ_out) {
    __shared__ __align__(16) float staged[kWarps][kStages][kChunkFloats];
    const bf8::Tree& top = tree.top;
    const int lane = threadIdx.x & (kLanes - 1);
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
    int32_t best_tri = -1;     // branded, ALPHA_TRI_BIT stripped
    int32_t best_raw = -1;     // branded, with its ALPHA_TRI_BIT
    float best_u = 0.0f, best_v = 0.0f;
    bool occluded = false;
    int32_t stack[bf8::kStackDepth];
    int sp = 0;
    if (valid) stack[sp++] = 0;
    const size_t page_floats = (size_t)8 * (size_t)top.page_cols;

    while (true) {
        // 1. walk on to the next leaf to test
        int32_t page = -1, seg = 0;
        while (sp > 0) {
            const int32_t ent = stack[--sp];
            if (ent >= bf8::kLeafBit) {
                const int32_t lid = ent - bf8::kLeafBit;
                if constexpr (!kAny) {
                    float tn;
                    if (!rt::slab(top.l_lo + 3 * lid, top.l_hi + 3 * lid, r,
                                  best_t, &tn))
                        continue;
                }
                page = tree.leaf_page[lid];
                seg = tree.leaf_seg[lid];
                break;
            }
            if constexpr (kAny)
                bf8i::push_hit(top, ent, r, lim, stack, &sp);
            else
                bf8i::push_near_first(top, ent, r, best_t, stack, &sp);
        }
        __syncwarp();
        if (__ballot_sync(kFull, page >= 0) == 0u) break;

        // 2. the ray in the leaf's instance space
        rt::Ray q = r;
        if (page >= 0) q = bf8i::to_object(tree.seg_inv, seg, r);
        const int32_t brand = seg << bf8i::kSegShift;

        // the walk's rule, on the lane's own best (bf8i_traverse.cuh)
        auto merge = [&](float t, float u, float v, int32_t id) {
            const int32_t idc = (id & ~rt::kAlphaTriBit) | brand;
            if (t < best_t || (t == best_t && best_tri >= 0
                               && idc < best_tri)) {
                best_t = t;
                best_tri = idc;
                best_raw = id | brand;
                best_u = u;
                best_v = v;
            }
        };

        // 3-4. the warp tests each pending page together
        test_groups(bufs, top.pages, page_floats, top.page_cols, top.block,
                    page, [&](const Tri& tr, const float* chunk,
                              unsigned& act) {
            // the chunk's columns that can accept
            const unsigned cols = __ballot_sync(
                kFull, tr.id >= 0
                       && !(kAny && flag && (tr.id & rt::kAlphaTriBit)));
            if (__popc(cols) < __popc(act)) {
                // fewer columns than rays: each ray's own lane tests the
                // columns in order, as its per-ray loop does
                if ((act >> lane) & 1u) {
                    for (unsigned todo = cols; todo != 0u; todo &= todo - 1u) {
                        const Tri tc = load_tri(chunk, __ffs(todo) - 1);
                        float u, v;
                        const float t = woop(tc, q.ox, q.oy, q.oz, q.dx, q.dy,
                                             q.dz, &u, &v);
                        if (!rt::accept(t, u, v, tmin, lim)) continue;
                        if constexpr (kAny) {
                            occluded = true;
                            sp = 0;
                            break;
                        } else {
                            merge(t, u, v, tc.id);
                        }
                    }
                }
                if constexpr (kAny)
                    act &= ~__ballot_sync(kFull, occluded);
                __syncwarp();
                return;
            }
            // else each ray of the group in turn, against the chunk's 32
            // triangles at once
            unsigned todo = act;
            while (todo != 0u) {
                const int m = __ffs(todo) - 1;
                todo &= todo - 1u;
                const float ox = __shfl_sync(kFull, q.ox, m);
                const float oy = __shfl_sync(kFull, q.oy, m);
                const float oz = __shfl_sync(kFull, q.oz, m);
                const float dx = __shfl_sync(kFull, q.dx, m);
                const float dy = __shfl_sync(kFull, q.dy, m);
                const float dz = __shfl_sync(kFull, q.dz, m);
                const float mlim = __shfl_sync(kFull, lim, m);
                float u, v;
                const float t = woop(tr, ox, oy, oz, dx, dy, dz, &u, &v);
                const bool ok = ((cols >> lane) & 1u)
                                && rt::accept(t, u, v, tmin, mlim);
                if constexpr (kAny) {
                    if (__any_sync(kFull, ok)) {
                        act &= ~(1u << m);
                        if (lane == m) {
                            occluded = true;
                            sp = 0;
                        }
                    }
                } else {
                    // the least key of t, then the least id at that key;
                    // t, u, v and the raw id from that lane
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
                    const int32_t wraw = __shfl_sync(kFull, tr.id, win);
                    if (lane == m) merge(wt, wu, wv, wraw);
                }
            }
        });
        // 5. the members resume their walks with the next pop
    }
    if (!valid) return;
    if constexpr (kAny) {
        occ_out[i] = occluded ? 1 : 0;
    } else {
        t_out[i] = best_t;
        tri_out[i] = flag ? best_raw : best_tri;
        u_out[i] = best_u;
        v_out[i] = best_v;
    }
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

int pt_bf8iw_closest(const float* c_lo, const float* c_hi,
                     const int32_t* c_ent, const float* l_lo,
                     const float* l_hi, const int32_t* leaf_page,
                     const int32_t* leaf_seg, const float* seg_inv,
                     const float* pages, int block, int page_cols,
                     const float* orig, const float* dir, const float* tmax,
                     float tmin, int raw_ids, int n, float* t_out,
                     int32_t* tri_out, float* u_out, float* v_out,
                     void* stream) {
    if (n <= 0) return 0;
    if (!stageable(pages, block, page_cols))
        return (int)cudaErrorInvalidValue;
    bf8i::Tree tree = make_tree(c_lo, c_hi, c_ent, l_lo, l_hi, leaf_page,
                                leaf_seg, seg_inv, pages, block, page_cols);
    int blocks = (n + kThreads - 1) / kThreads;
    warp_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        tree, orig, dir, tmax, tmin, raw_ids, n, t_out, tri_out, u_out,
        v_out, nullptr);
    return (int)cudaGetLastError();
}

int pt_bf8iw_occluded(const float* c_lo, const float* c_hi,
                      const int32_t* c_ent, const float* l_lo,
                      const float* l_hi, const int32_t* leaf_page,
                      const int32_t* leaf_seg, const float* seg_inv,
                      const float* pages, int block, int page_cols,
                      const float* orig, const float* dir, const float* dist,
                      float tmin, int opaque_only, int n, uint8_t* out,
                      void* stream) {
    if (n <= 0) return 0;
    if (!stageable(pages, block, page_cols))
        return (int)cudaErrorInvalidValue;
    bf8i::Tree tree = make_tree(c_lo, c_hi, c_ent, l_lo, l_hi, leaf_page,
                                leaf_seg, seg_inv, pages, block, page_cols);
    int blocks = (n + kThreads - 1) / kThreads;
    warp_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        tree, orig, dir, dist, tmin, opaque_only, n, nullptr, nullptr,
        nullptr, nullptr, out);
    return (int)cudaGetLastError();
}

// Resident blocks per SM of the closest (any_hit 0) or occlusion kernel; a
// negative CUDA error code on failure.
int pt_bf8iw_blocks_per_sm(int any_hit) {
    int blocks = 0;
    cudaError_t e = any_hit
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, warp_kernel<true>, kThreads, 0)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, warp_kernel<false>, kThreads, 0);
    return e == cudaSuccess ? blocks : -(int)e;
}

int pt_bf8iw_smem_per_block() {
    return (int)(sizeof(float) * kWarps * kStages * kChunkFloats);
}

const char* pt_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
