// CUDA kernels closest_v6k2 (two pops a round) and closest_v7 (leaf tests
// queued for `window` pops) over a BF8V6, designed for Hopper (sm_90a):
// every ray keeps its own walk, and the warp tests each pending leaf
// together. extern "C" launchers for ctypes.
//
// Replaces pt/accel/pallas_bvh_archive.py:1893 packet_closest_v6k2 (A4,
// body :137) and :1933 packet_closest_v7 (A5, body :525). The TPU kernels
// DMA each leaf page once per packet and test the packet on the MXU. Here a
// page is read once per group of a warp's lanes that want it, and its test
// is shared by those lanes; no lane visits a node or a leaf that its own
// walk would not visit.
//
// What bounded the first design (v6_kernels.cu, kept as the per-ray arm of
// the A/B and as the counted variant, `pt_v6_closest` with walk 1 or 2):
// one lane tested a leaf alone, `block` iterations of 22 scattered loads
// from 7 page rows page_cols * 4 bytes apart, however many lanes of the
// warp were in that leaf; and a warp stepped through those iterations
// until its slowest lane was done.
//
// Where these walks differ from closest_v6's (bf8_warp_kernels.cu): a lane
// can hold more than one leaf to test at once, so it keeps a pending list,
// sorted by leaf id, in place of one pending leaf. This design (each lane's
// sequence of node and leaf visits is exactly the per-ray walk's,
// v6_traverse.cuh, so bf8::Counts of the counted variant still describes
// its work):
//   1. A lane runs rounds of its walk over its own stack, v6::test_entry
//      and v6::push_children as the per-ray walk calls them, and collects
//      the leaves whose boxes pass into its list instead of testing them:
//        * two pops (`closest_two_pops`): the top entry e0 and the one below
//          it, e1, are slab-tested against the lane's best t as the round
//          starts, then e1's pushes run and e0's last; a leaf adds at most
//          2 entries a round;
//        * leaf queue (`closest_leaf_queue`): up to `window` pops against
//          t_slab, fewer once the stack empties or kQueueCap (48) leaves
//          are listed. t_slab, the best t as the last drain left it, is the
//          lane's best t at every round's start, since no leaf is tested
//          inside a round.
//      Deferring the leaf tests to the end of the round changes no bit:
//      `leaf::closest` accepts against the ray's tmax, not its best t, and
//      merges by a running lexicographic minimum of (t, id), and the round's
//      pushes use hits computed as the round started. The lane stops after
//      the first round that lists a leaf.
//   2. When every live lane of the warp holds a non-empty list or is done,
//      the warp drains the lists together, step by step. At each step a
//      lane offers the head of its list when it is below every lane's
//      second entry, or is the least head of the warp; so each distinct
//      leaf of the warp's lists is offered once, by every lane that holds
//      it, whatever its place in their lists. The offered leaves are tested
//      by warp_leaf.cuh's `test_groups` (lanes grouped by leaf with
//      __match_any_sync, a leaf's page staged in 32-triangle chunks by
//      cp.async, the next chunk in flight); the lanes that offered move on
//      to their next entry. A walk whose lists hold one leaf drains in one
//      step, as closest_v6's does.
//   3. Each group's chunk is tested as in bf8_warp_kernels.cu: each member's
//      ray and limit broadcast by shuffle in turn, lane l testing triangle l
//      of the chunk, or, where the chunk has fewer valid columns than rays
//      to test, each member's own lane running its ray against those
//      columns in column order. The chunk's winner is the least key of t
//      (`t_key`), then the least id with ALPHA_TRI_BIT stripped; the
//      member's own lane merges it by page_leaf.cuh's rule, so neither the
//      drain order nor the chunk order changes a bit, and on an exact t tie
//      across two leaves the smaller id wins.
//   4. The lanes resume their walks with their next round.
// The chunk test (3) is bf8_warp_kernels.cu's, written out again here, as
// in ordered_warp_kernels.cu: that library's machine code is held fixed
// (pt_torch/benches/sass_diff.py).
// Built with -fmad=false: every t, u and v rounds as in the per-ray kernels.
//
// Resources: 128 threads (4 warps) a block; 22,528 bytes of static shared
// memory a block (4 warps x 2 stages x 22 x 32 f32); each lane's stack of
// v6::kStackDepth entries and its pending list (2 entries, or kQueueCap
// for the leaf queue) live in local memory, as in the per-ray kernels.
// `pt_v6w_blocks_per_sm` reports the resident blocks of each walk
// (chip_smoke.py prints it beside ptxas's -v line). The launcher refuses a
// tree whose pages cannot be staged (`stageable`), an unknown walk or a
// window below 1 with cudaErrorInvalidValue. The kernels allocate nothing;
// the launcher returns cudaGetLastError() so that the Python wrapper can
// raise on a refused launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "v6_traverse.cuh"
#include "warp_leaf.cuh"

namespace {

using namespace warp_leaf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kLanes;
constexpr int32_t kNone = 0x7fffffff;   // no list entry: above every leaf

// Insert leaf `lid` into `list`, `*n` entries in ascending order.
__device__ __forceinline__ void insert_sorted(int32_t* list, int* n,
                                              int32_t lid) {
    int p = (*n)++;
    while (p > 0 && list[p - 1] > lid) {
        list[p] = list[p - 1];
        --p;
    }
    list[p] = lid;
}

// What a popped entry does once its slab tests are in: a wide node pushes
// its hit children (v6::push_children), a leaf whose box passed is listed.
__device__ __forceinline__ void apply(const v6::Tree& tree, int32_t ent,
                                      unsigned hits, int oct, int32_t* stack,
                                      int* sp, int32_t* list, int* n) {
    if (ent < bf8::kLeafBit)
        v6::push_children(tree, ent, hits, oct, stack, sp);
    else if (hits)
        insert_sorted(list, n, ent - bf8::kLeafBit);
}

// v6::closest_two_pops's round
struct TwoPops {
    static constexpr int kCap = 2;
    v6::Tree tree;

    __device__ __forceinline__ void round(const rt::Ray& r, int oct,
                                          float t_limit, int32_t* stack,
                                          int* sp, int32_t* list,
                                          int* n) const {
        const int32_t e0 = stack[*sp - 1];
        const bool two = *sp > 1;
        const int32_t e1 = two ? stack[*sp - 2] : 0;
        const unsigned h0 = v6::test_entry<false>(tree, e0, r, t_limit,
                                                  nullptr);
        const unsigned h1 = two ? v6::test_entry<false>(tree, e1, r, t_limit,
                                                        nullptr)
                                : 0u;
        *sp -= two ? 2 : 1;
        if (two) apply(tree, e1, h1, oct, stack, sp, list, n);
        apply(tree, e0, h0, oct, stack, sp, list, n);
    }
};

// v6::closest_leaf_queue's round
struct LeafQueue {
    static constexpr int kCap = v6::kQueueCap;
    v6::Tree tree;
    int window;

    __device__ __forceinline__ void round(const rt::Ray& r, int oct,
                                          float t_limit, int32_t* stack,
                                          int* sp, int32_t* list,
                                          int* n) const {
        for (int k = 0; k < window && *sp > 0 && *n < kCap; ++k) {
            const int32_t ent = stack[--*sp];
            const unsigned hits = v6::test_entry<false>(tree, ent, r,
                                                        t_limit, nullptr);
            apply(tree, ent, hits, oct, stack, sp, list, n);
        }
    }
};

template <class Walk>
__global__ void __launch_bounds__(kThreads)
closest_kernel(Walk walk, const float* __restrict__ orig,
               const float* __restrict__ dir, const float* __restrict__ tmax,
               float tmin, int n, float* __restrict__ t_out,
               int32_t* __restrict__ tri_out, float* __restrict__ u_out,
               float* __restrict__ v_out) {
    __shared__ __align__(16) float staged[kWarps][kStages][kChunkFloats];
    const int lane = threadIdx.x & (kLanes - 1);
    float* bufs = &staged[threadIdx.x / kLanes][0][0];
    const int i = blockIdx.x * kThreads + threadIdx.x;
    // lanes past n take part in the warp's collectives as finished lanes
    const bool valid = i < n;
    const rt::Ray r = valid ? rt::make_ray(orig[3 * i], orig[3 * i + 1],
                                           orig[3 * i + 2], dir[3 * i],
                                           dir[3 * i + 1], dir[3 * i + 2])
                            : rt::make_ray(0.f, 0.f, 0.f, 1.f, 1.f, 1.f);
    const float lim = valid ? tmax[i] : 0.0f;
    const int oct = v6::octant(r);
    float best_t = lim;
    int32_t best_tri = -1;     // ALPHA_TRI_BIT stripped
    float best_u = 0.0f, best_v = 0.0f;
    int32_t stack[v6::kStackDepth];
    int sp = 0;
    if (valid) stack[sp++] = 0;
    int32_t list[Walk::kCap];
    int n_list = 0;
    const float* pages = walk.tree.pages;
    const int block = walk.tree.block;
    const int cols = walk.tree.page_cols;
    const size_t page_floats = (size_t)8 * (size_t)cols;

    // page_leaf.cuh's rule, on the lane's own best
    auto merge = [&](float t, float u, float v, int32_t id) {
        const int32_t idc = id & ~rt::kAlphaTriBit;
        if (t < best_t || (t == best_t && best_tri >= 0 && idc < best_tri)) {
            best_t = t;
            best_tri = idc;
            best_u = u;
            best_v = v;
        }
    };

    while (true) {
        // 1. rounds of the lane's walk until one lists a leaf
        while (n_list == 0 && sp > 0)
            walk.round(r, oct, best_t, stack, &sp, list, &n_list);
        __syncwarp();
        if (__ballot_sync(kFull, n_list > 0) == 0u) break;

        // 2. the warp drains the lists, each distinct leaf once
        int head = 0;
        while (true) {
            const int32_t h = head < n_list ? list[head] : kNone;
            const int32_t least = __reduce_min_sync(kFull, h);
            if (least == kNone) break;
            const int32_t second = head + 1 < n_list ? list[head + 1] : kNone;
            const int32_t below = __reduce_min_sync(kFull, second);
            const bool offer = h != kNone && (h < below || h == least);

            // 3. the warp tests each offered leaf together
            test_groups(bufs, pages, page_floats, cols, block,
                        offer ? h : -1,
                        [&](const Tri& tr, const float* chunk,
                            unsigned& act) {
                const unsigned valid_cols = __ballot_sync(kFull, tr.id >= 0);
                if (__popc(valid_cols) < __popc(act)) {
                    // fewer columns than rays: each ray's own lane tests the
                    // columns in order, as its per-ray loop does
                    if ((act >> lane) & 1u) {
                        for (unsigned todo = valid_cols; todo != 0u;
                             todo &= todo - 1u) {
                            const Tri tc = load_tri(chunk, __ffs(todo) - 1);
                            float u, v;
                            const float t = woop(tc, r.ox, r.oy, r.oz, r.dx,
                                                 r.dy, r.dz, &u, &v);
                            if (rt::accept(t, u, v, tmin, lim))
                                merge(t, u, v, tc.id);
                        }
                    }
                    __syncwarp();
                    return;
                }
                // else each ray of the group in turn, against the chunk's 32
                // triangles at once
                unsigned todo = act;
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
                    const bool ok = ((valid_cols >> lane) & 1u)
                                    && rt::accept(t, u, v, tmin, mlim);
                    // the least key of t, then the least id at that key; t,
                    // u and v from that lane
                    const unsigned key = ok ? t_key(t) : kNoKey;
                    const unsigned kmin = __reduce_min_sync(kFull, key);
                    if (kmin == kNoKey) continue;
                    const unsigned idc =
                        (ok && key == kmin)
                            ? (unsigned)(tr.id & ~rt::kAlphaTriBit) : kNoKey;
                    const unsigned imin = __reduce_min_sync(kFull, idc);
                    const int win =
                        __ffs(__ballot_sync(kFull, idc == imin)) - 1;
                    const float wt = __shfl_sync(kFull, t, win);
                    const float wu = __shfl_sync(kFull, u, win);
                    const float wv = __shfl_sync(kFull, v, win);
                    if (lane == m) merge(wt, wu, wv, (int32_t)imin);
                }
            });
            if (offer) ++head;
        }
        // 4. the lanes resume their walks with their next round
        n_list = 0;
    }
    if (!valid) return;
    t_out[i] = best_t;
    tri_out[i] = best_tri;
    u_out[i] = best_u;
    v_out[i] = best_v;
}

enum WalkId { kTwoPops = 0, kLeafQueue = 1 };

template <class Walk>
int launch(const Walk& walk, const float* orig, const float* dir,
           const float* tmax, float tmin, int n, float* t_out,
           int32_t* tri_out, float* u_out, float* v_out, void* stream) {
    const int blocks = (n + kThreads - 1) / kThreads;
    closest_kernel<Walk><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        walk, orig, dir, tmax, tmin, n, t_out, tri_out, u_out, v_out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// closest_v6k2 (`walk` 0) or closest_v7 (`walk` 1, `window` >= 1 pops a
// round); `window` is not read by walk 0.
int pt_v6w_closest(const float* u_lo, const float* u_hi,
                   const int32_t* c_ent, const int32_t* c_order,
                   const float* pages, int n8, int block, int page_cols,
                   const float* orig, const float* dir, const float* tmax,
                   float tmin, int walk, int window, int n, float* t_out,
                   int32_t* tri_out, float* u_out, float* v_out,
                   void* stream) {
    if (n <= 0) return 0;
    if (!stageable(pages, block, page_cols) || walk < kTwoPops
        || walk > kLeafQueue || window < 1)
        return (int)cudaErrorInvalidValue;
    const v6::Tree tree{u_lo, u_hi, c_ent, c_order, pages, n8, block,
                        page_cols};
    if (walk == kTwoPops)
        return launch(TwoPops{tree}, orig, dir, tmax, tmin, n, t_out,
                      tri_out, u_out, v_out, stream);
    return launch(LeafQueue{tree, window}, orig, dir, tmax, tmin, n, t_out,
                  tri_out, u_out, v_out, stream);
}

// Resident blocks per SM of the closest_v6k2 (walk 0) or closest_v7 (walk
// 1) kernel; a negative CUDA error code on failure.
int pt_v6w_blocks_per_sm(int walk) {
    if (walk < kTwoPops || walk > kLeafQueue)
        return -(int)cudaErrorInvalidValue;
    int blocks = 0;
    cudaError_t e = walk == kTwoPops
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, closest_kernel<TwoPops>, kThreads, 0)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, closest_kernel<LeafQueue>, kThreads, 0);
    return e == cudaSuccess ? blocks : -(int)e;
}

int pt_v6w_smem_per_block() {
    return (int)(sizeof(float) * kWarps * kStages * kChunkFloats);
}

const char* pt_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
