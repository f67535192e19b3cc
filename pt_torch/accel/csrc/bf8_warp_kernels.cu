// CUDA kernels K1 (closest hit over a BF8 tree) and closest_v6 (closest hit
// over a BF8V6), designed for Hopper (sm_90a): every ray keeps its own
// walk, and the warp tests each pending leaf together. extern "C" launchers
// for ctypes.
//
// Replaces pt/accel/pallas_bvh.py:1427 packet_closest_bf8 (kernel body
// :823) and pt/accel/pallas_bvh_archive.py:1854 packet_closest_v6 (body
// :344). The TPU kernels DMA each leaf page once per packet and test the
// packet on the MXU. Here a page is read once per group of a warp's lanes
// that want it, and its test is shared by those lanes; no lane visits a
// node or a leaf that its own walk would not visit.
//
// What bounded the first design (bf8_kernels.cu and v6_kernels.cu, kept as
// the per-ray arm of the A/B (K1's also of its pops instance) and as the
// counted variants, `pt_bf8_closest`, `pt_v6_closest`): one lane tested a leaf alone, `block`
// iterations of 22 scattered loads from 7 page rows page_cols * 4 bytes
// apart, however many lanes of the warp were in that leaf; and a warp
// stepped through those iterations until its slowest lane was done.
//
// The two walks differ only in how a wide node pushes its children and
// where a popped leaf's box lies; the page test is the same. This design
// (each lane's sequence of node and leaf visits is exactly the per-ray
// walk's, bf8_traverse.cuh / v6_traverse.cuh, so bf8::Counts still
// describes its work):
//   1. A lane runs its walk over its own stack: K1 pushes the children far
//      first by tnear (bf8::push_near_first), closest_v6 in its node's
//      static order for the ray's octant (v6::test_entry, v6::push_children).
//      A popped leaf's box is retested against the lane's own best t (K1:
//      l_lo/l_hi; v6: the unified table's leaf row). If it passes, the lane
//      stops with that leaf pending.
//   2. When every live lane of the warp holds a pending leaf or is done,
//      the warp groups its lanes by leaf (__match_any_sync; a leaf's page
//      index is its leaf id) and tests each group's page together
//      (warp_leaf.cuh's `test_groups`: 32-triangle chunks staged by
//      cp.async, the next chunk in flight). Each member's ray and limit are
//      broadcast by shuffle in turn; lane l tests triangle l of the chunk.
//   3. A chunk with fewer valid columns than rays to test (the Heightfield's
//      SBVH leaves are about 70% full, the alpha subset trees' far less) is
//      tested the other way round: each member's own lane runs its ray
//      against those columns, read from the staged chunk, in column order.
//   4. The chunk's winner is the least key of t (`t_key`), then the least id
//      with ALPHA_TRI_BIT stripped; t, u and v come from the winning lane.
//      The member's own lane merges it with bf8_traverse.cuh's rule, a
//      running lexicographic minimum of (t, id), so neither the group nor
//      the chunk order changes a bit; in the column mode the member's lane
//      merges column by column with the same rule.
//   5. The members resume their walks with the next pop of their own stacks.
// Built with -fmad=false: every t, u and v rounds as in the per-ray kernels.
//
// K1's kernel has a pops instance (`Bf8PopsWalk`, `pt_bf8w_closest_pops`),
// which B1/B2 (pt's benches/budget.py:rounds_of and benches/drain_sim.py:
// done_rounds_of) read: each lane writes the iterations of its walk loop
// (one per pop of a wide node or of a leaf, as bf8_traverse.cuh's kPops
// counts them), with no atomics. A lane pops what its per-ray walk pops, in
// the same order, so the pops are the per-ray pops variant's on every lane;
// lanes past n make no iteration. The flag is the walk's compile-time
// `kPops`, off in Bf8Walk and V6Walk, whose kernels carry no counting code.
//
// Resources: 128 threads (4 warps) a block; 22,528 bytes of static shared
// memory a block (4 warps x 2 stages x 22 x 32 f32); each lane's stack of
// bf8::kStackDepth entries lives in local memory, as in the per-ray
// kernels. `pt_bf8w_blocks_per_sm` reports the resident blocks of each walk
// (chip_smoke.py prints it beside ptxas's -v line). The launchers refuse a
// tree whose pages cannot be staged (`stageable`) with
// cudaErrorInvalidValue.
#include <cuda_runtime.h>
#include <stdint.h>

#include "v6_traverse.cuh"
#include "warp_leaf.cuh"

namespace {

using namespace warp_leaf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kLanes;

// K1's walk (bf8::closest)
struct Bf8Walk {
    static constexpr bool kPops = false;
    bf8::Tree tree;

    __device__ __forceinline__ bool leaf_box(int32_t lid, const rt::Ray& r,
                                             float t_limit) const {
        float tn;
        return rt::slab(tree.l_lo + 3 * lid, tree.l_hi + 3 * lid, r, t_limit,
                        &tn);
    }

    __device__ __forceinline__ void push(int32_t node, const rt::Ray& r,
                                         float t_limit, int32_t* stack,
                                         int* sp) const {
        bf8::push_near_first(tree, node, r, t_limit, stack, sp);
    }
};

// K1's walk with its pops written to `pops` (N,)
struct Bf8PopsWalk : Bf8Walk {
    static constexpr bool kPops = true;
    int32_t* pops;
};

// closest_v6's walk (v6::closest, one pop per iteration)
struct V6Walk {
    static constexpr bool kPops = false;
    v6::Tree tree;

    __device__ __forceinline__ bool leaf_box(int32_t lid, const rt::Ray& r,
                                             float t_limit) const {
        return v6::test_entry<false>(tree, lid + bf8::kLeafBit, r, t_limit,
                                     nullptr) != 0u;
    }

    __device__ __forceinline__ void push(int32_t node, const rt::Ray& r,
                                         float t_limit, int32_t* stack,
                                         int* sp) const {
        const unsigned hits = v6::test_entry<false>(tree, node, r, t_limit,
                                                    nullptr);
        v6::push_children(tree, node, hits, v6::octant(r), stack, sp);
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
    float best_t = lim;
    int32_t best_tri = -1;     // ALPHA_TRI_BIT stripped
    float best_u = 0.0f, best_v = 0.0f;
    int32_t stack[bf8::kStackDepth];
    int sp = 0;
    if (valid) stack[sp++] = 0;
    const float* pages = walk.tree.pages;
    const int block = walk.tree.block;
    const int cols = walk.tree.page_cols;
    const size_t page_floats = (size_t)8 * (size_t)cols;
    [[maybe_unused]] int32_t n_pops = 0;

    // the walk's rule, on the lane's own best (bf8_traverse.cuh)
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
        // 1. walk on to the next leaf to test
        int32_t pending = -1;
        while (sp > 0) {
            const int32_t ent = stack[--sp];
            if constexpr (Walk::kPops) ++n_pops;
            if (ent >= bf8::kLeafBit) {
                const int32_t lid = ent - bf8::kLeafBit;
                if (walk.leaf_box(lid, r, best_t)) {
                    pending = lid;
                    break;
                }
                continue;
            }
            walk.push(ent, r, best_t, stack, &sp);
        }
        __syncwarp();
        if (__ballot_sync(kFull, pending >= 0) == 0u) break;

        // 2-4. the warp tests each pending leaf together
        test_groups(bufs, pages, page_floats, cols, block, pending,
                    [&](const Tri& tr, const float* chunk, unsigned& act) {
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
                // the least key of t, then the least id at that key; t, u
                // and v from that lane
                const unsigned key = ok ? t_key(t) : kNoKey;
                const unsigned kmin = __reduce_min_sync(kFull, key);
                if (kmin == kNoKey) continue;
                const unsigned idc =
                    (ok && key == kmin)
                        ? (unsigned)(tr.id & ~rt::kAlphaTriBit) : kNoKey;
                const unsigned imin = __reduce_min_sync(kFull, idc);
                const int win = __ffs(__ballot_sync(kFull, idc == imin)) - 1;
                const float wt = __shfl_sync(kFull, t, win);
                const float wu = __shfl_sync(kFull, u, win);
                const float wv = __shfl_sync(kFull, v, win);
                if (lane == m) merge(wt, wu, wv, (int32_t)imin);
            }
        });
        // 5. the members resume their walks with the next pop
    }
    if (!valid) return;
    if constexpr (Walk::kPops) walk.pops[i] = n_pops;
    t_out[i] = best_t;
    tri_out[i] = best_tri;
    u_out[i] = best_u;
    v_out[i] = best_v;
}

template <class Walk>
int launch(const Walk& walk, const float* orig, const float* dir,
           const float* tmax, float tmin, int n, float* t_out,
           int32_t* tri_out, float* u_out, float* v_out, void* stream) {
    if (n <= 0) return 0;
    if (!stageable(walk.tree.pages, walk.tree.block, walk.tree.page_cols))
        return (int)cudaErrorInvalidValue;
    const int blocks = (n + kThreads - 1) / kThreads;
    closest_kernel<Walk><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        walk, orig, dir, tmax, tmin, n, t_out, tri_out, u_out, v_out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pt_bf8w_closest(const float* c_lo, const float* c_hi,
                    const int32_t* c_ent, const float* l_lo,
                    const float* l_hi, const float* pages, int block,
                    int page_cols, const float* orig, const float* dir,
                    const float* tmax, float tmin, int n, float* t_out,
                    int32_t* tri_out, float* u_out, float* v_out,
                    void* stream) {
    Bf8Walk walk;
    walk.tree = bf8::Tree{c_lo, c_hi, c_ent, l_lo, l_hi, pages, block,
                          page_cols};
    return launch(walk, orig, dir, tmax, tmin, n, t_out, tri_out, u_out,
                  v_out, stream);
}

// K1 with each lane's pops written to `pops` (N,) int32
int pt_bf8w_closest_pops(const float* c_lo, const float* c_hi,
                         const int32_t* c_ent, const float* l_lo,
                         const float* l_hi, const float* pages, int block,
                         int page_cols, const float* orig, const float* dir,
                         const float* tmax, float tmin, int n, float* t_out,
                         int32_t* tri_out, float* u_out, float* v_out,
                         int32_t* pops, void* stream) {
    Bf8PopsWalk walk;
    walk.tree = bf8::Tree{c_lo, c_hi, c_ent, l_lo, l_hi, pages, block,
                          page_cols};
    walk.pops = pops;
    return launch(walk, orig, dir, tmax, tmin, n, t_out, tri_out, u_out,
                  v_out, stream);
}

int pt_bf8w_closest_v6(const float* u_lo, const float* u_hi,
                       const int32_t* c_ent, const int32_t* c_order,
                       const float* pages, int n8, int block, int page_cols,
                       const float* orig, const float* dir,
                       const float* tmax, float tmin, int n, float* t_out,
                       int32_t* tri_out, float* u_out, float* v_out,
                       void* stream) {
    V6Walk walk;
    walk.tree = v6::Tree{u_lo, u_hi, c_ent, c_order, pages, n8, block,
                         page_cols};
    return launch(walk, orig, dir, tmax, tmin, n, t_out, tri_out, u_out,
                  v_out, stream);
}

// Resident blocks per SM of the K1 (walk 0) or closest_v6 (walk 1) kernel;
// a negative CUDA error code on failure.
int pt_bf8w_blocks_per_sm(int walk) {
    int blocks = 0;
    cudaError_t e = walk
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, closest_kernel<V6Walk>, kThreads, 0)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, closest_kernel<Bf8Walk>, kThreads, 0);
    return e == cudaSuccess ? blocks : -(int)e;
}

// threads per block of every launch of this library (lane i runs in block
// i / kThreads, warp (i % kThreads) / 32)
int pt_bf8w_threads_per_block() { return kThreads; }

int pt_bf8w_smem_per_block() {
    return (int)(sizeof(float) * kWarps * kStages * kChunkFloats);
}

const char* pt_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
