// CUDA kernels K2 (occlusion over a BF8 tree) and occluded_v6 (occlusion
// over a BF8V6), designed for Hopper (sm_90a): every ray keeps its own
// any-hit walk, the warp tests each pending leaf together, and an occluded
// ray leaves its group. extern "C" launchers for ctypes.
//
// Replaces pt/accel/pallas_bvh.py:1471 packet_occluded_bf8 (kernel body
// :1014) and pt/accel/pallas_bvh_archive.py:1975 packet_occluded_v6 (body
// :769). The TPU kernels DMA each leaf page once per packet and test the
// packet on the MXU. Here a page is read once per group of a warp's lanes
// that want it, and its test is shared by those lanes; no lane visits a
// node or a leaf that its own walk would not visit.
//
// What bounded the first design (bf8_kernels.cu and v6_kernels.cu, kept as
// the per-ray arm of the A/B and as the counted variants, `pt_bf8_occluded`,
// `pt_v6_occluded`): one lane tested a leaf alone, up to `block` iterations
// of 22 scattered loads from 7 page rows page_cols * 4 bytes apart, however
// many lanes of the warp were in that leaf; and a warp stepped through
// those iterations until its slowest lane was done.
//
// The two walks differ only in where a popped entry's boxes lie; the page
// test is the same. The answer does not depend on the order of visits (the
// limit `dist` never shrinks), but each lane keeps exactly the per-ray
// walk's sequence of node and leaf visits (bf8_traverse.cuh's and
// v6_traverse.cuh's `occluded`), so bf8::Counts still describes its work:
//   1. A lane runs its walk over its own stack. A wide node pushes each
//      non-empty child whose box the ray hits before `dist`, in child order
//      (the last on top). K2 sends a popped leaf straight to its page, with
//      no leaf-box retest (bf8::occluded has none); occluded_v6 slab-tests
//      every pop against the unified table (v6::test_entry), so its leaf is
//      pending only where the leaf's own row passes. The lane stops with
//      the leaf pending.
//   2. When every live lane of the warp holds a pending leaf or is done,
//      the warp groups its lanes by leaf (__match_any_sync; a leaf's page
//      index is its leaf id) and stages each group's page once
//      (warp_leaf.cuh's `test_groups`: 32-triangle chunks by cp.async, the
//      next chunk in flight).
//   3. The chunk's columns that can accept: a real triangle, and under
//      opaque_only (K2 only) not tagged ALPHA_TRI_BIT.
//   4. Row mode: each member ray in turn is broadcast by shuffle and lane l
//      tests triangle l; __any_sync marks the member occluded, its own lane
//      sets `occluded` and empties its stack, and it leaves the group.
//   5. Column mode, where fewer columns can accept than rays are left to
//      test (the Heightfield's SBVH leaves are about 70% full, the alpha
//      subset trees far less): each member's own lane runs its ray against
//      those columns, read from the staged chunk, in column order, and
//      stops at the first that accepts; the occluded leave the group.
//   6. A group with no member left stops staging. An occluded lane is done
//      and takes part in the later collectives as a finished lane; the
//      others resume their walks with the next pop of their own stacks.
// Built with -fmad=false: every t, u and v rounds as in the per-ray kernels.
//
// Resources: 128 threads (4 warps) a block; 22,528 bytes of static shared
// memory a block (4 warps x 2 stages x 22 x 32 f32); each lane's stack of
// bf8::kStackDepth entries lives in local memory, as in the per-ray
// kernels. The any-hit walk keeps no best t, u or v. `pt_bf8wo_blocks_per_sm`
// reports the resident blocks of each walk (chip_smoke.py prints it beside
// ptxas's -v line). The launchers refuse a tree whose pages cannot be
// staged (`stageable`) with cudaErrorInvalidValue.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf8i_traverse.cuh"
#include "v6_traverse.cuh"
#include "warp_leaf.cuh"

namespace {

using namespace warp_leaf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kLanes;

// K2's walk (bf8::occluded)
struct Bf8AnyHit {
    bf8::Tree tree;

    __device__ __forceinline__ bool leaf_box(int32_t, const rt::Ray&,
                                             float) const {
        return true;                  // no retest
    }

    __device__ __forceinline__ void push(int32_t node, const rt::Ray& r,
                                         float dist, int32_t* stack,
                                         int* sp) const {
        bf8i::push_hit(tree, node, r, dist, stack, sp);   // child order
    }
};

// occluded_v6's walk (v6::occluded)
struct V6AnyHit {
    v6::Tree tree;

    __device__ __forceinline__ bool leaf_box(int32_t lid, const rt::Ray& r,
                                             float dist) const {
        return v6::test_entry<false>(tree, lid + bf8::kLeafBit, r, dist,
                                     nullptr) != 0u;
    }

    __device__ __forceinline__ void push(int32_t node, const rt::Ray& r,
                                         float dist, int32_t* stack,
                                         int* sp) const {
        const unsigned hits = v6::test_entry<false>(tree, node, r, dist,
                                                    nullptr);
        for (int c = 0; c < 8; ++c)
            if ((hits >> c) & 1u) stack[(*sp)++] = tree.c_ent[node * 8 + c];
    }
};

template <class Walk>
__global__ void __launch_bounds__(kThreads)
occluded_kernel(Walk walk, const float* __restrict__ orig,
                const float* __restrict__ dir,
                const float* __restrict__ dist, float tmin, int opaque_only,
                int n, uint8_t* __restrict__ out) {
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
    const float lim = valid ? dist[i] : 0.0f;
    bool occluded = false;
    int32_t stack[bf8::kStackDepth];
    int sp = 0;
    if (valid) stack[sp++] = 0;
    const float* pages = walk.tree.pages;
    const int block = walk.tree.block;
    const int cols = walk.tree.page_cols;
    const size_t page_floats = (size_t)8 * (size_t)cols;

    while (true) {
        // 1. walk on to the next leaf to test
        int32_t pending = -1;
        while (sp > 0) {
            const int32_t ent = stack[--sp];
            if (ent >= bf8::kLeafBit) {
                const int32_t lid = ent - bf8::kLeafBit;
                if (walk.leaf_box(lid, r, lim)) {
                    pending = lid;
                    break;
                }
                continue;
            }
            walk.push(ent, r, lim, stack, &sp);
        }
        __syncwarp();
        if (__ballot_sync(kFull, pending >= 0) == 0u) break;

        // 2-6. the warp tests each pending leaf together
        test_groups(bufs, pages, page_floats, cols, block, pending,
                    [&](const Tri& tr, const float* chunk, unsigned& act) {
            // 3. the chunk's columns that can accept
            const unsigned can = __ballot_sync(
                kFull, tr.id >= 0
                       && !(opaque_only && (tr.id & rt::kAlphaTriBit)));
            if (__popc(can) < __popc(act)) {
                // 5. fewer columns than rays: each ray's own lane tests the
                // columns in order, as its per-ray loop does
                if ((act >> lane) & 1u) {
                    for (unsigned todo = can; todo != 0u; todo &= todo - 1u) {
                        const Tri tc = load_tri(chunk, __ffs(todo) - 1);
                        float u, v;
                        const float t = woop(tc, r.ox, r.oy, r.oz, r.dx,
                                             r.dy, r.dz, &u, &v);
                        if (rt::accept(t, u, v, tmin, lim)) {
                            occluded = true;
                            sp = 0;
                            break;
                        }
                    }
                }
                act &= ~__ballot_sync(kFull, occluded);
                __syncwarp();
                return;
            }
            // 4. else each ray of the group in turn, against the chunk's 32
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
                const bool ok = ((can >> lane) & 1u)
                                && rt::accept(t, u, v, tmin, mlim);
                if (__any_sync(kFull, ok)) {
                    act &= ~(1u << m);
                    if (lane == m) {
                        occluded = true;
                        sp = 0;
                    }
                }
            }
        });
        // 6. the others resume their walks with the next pop
    }
    if (valid) out[i] = occluded ? 1 : 0;
}

template <class Walk>
int launch(const Walk& walk, const float* orig, const float* dir,
           const float* dist, float tmin, int opaque_only, int n,
           uint8_t* out, void* stream) {
    if (n <= 0) return 0;
    if (!stageable(walk.tree.pages, walk.tree.block, walk.tree.page_cols))
        return (int)cudaErrorInvalidValue;
    const int blocks = (n + kThreads - 1) / kThreads;
    occluded_kernel<Walk><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        walk, orig, dir, dist, tmin, opaque_only, n, out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pt_bf8wo_occluded(const float* c_lo, const float* c_hi,
                      const int32_t* c_ent, const float* l_lo,
                      const float* l_hi, const float* pages, int block,
                      int page_cols, const float* orig, const float* dir,
                      const float* dist, float tmin, int opaque_only, int n,
                      uint8_t* out, void* stream) {
    Bf8AnyHit walk;
    walk.tree = bf8::Tree{c_lo, c_hi, c_ent, l_lo, l_hi, pages, block,
                          page_cols};
    return launch(walk, orig, dir, dist, tmin, opaque_only, n, out, stream);
}

// pt's v6 has no opaque_only: every triangle occludes
int pt_bf8wo_occluded_v6(const float* u_lo, const float* u_hi,
                         const int32_t* c_ent, const int32_t* c_order,
                         const float* pages, int n8, int block,
                         int page_cols, const float* orig, const float* dir,
                         const float* dist, float tmin, int n, uint8_t* out,
                         void* stream) {
    V6AnyHit walk;
    walk.tree = v6::Tree{u_lo, u_hi, c_ent, c_order, pages, n8, block,
                         page_cols};
    return launch(walk, orig, dir, dist, tmin, 0, n, out, stream);
}

// Resident blocks per SM of the K2 (walk 0) or occluded_v6 (walk 1)
// kernel; a negative CUDA error code on failure.
int pt_bf8wo_blocks_per_sm(int walk) {
    int blocks = 0;
    cudaError_t e = walk
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, occluded_kernel<V6AnyHit>, kThreads, 0)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, occluded_kernel<Bf8AnyHit>, kThreads, 0);
    return e == cudaSuccess ? blocks : -(int)e;
}

int pt_bf8wo_smem_per_block() {
    return (int)(sizeof(float) * kWarps * kStages * kChunkFloats);
}

const char* pt_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
