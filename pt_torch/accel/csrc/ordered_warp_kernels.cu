// CUDA kernel `closest_ordered` (the ordered, near-child-first stack walk of
// a binary PacketBVH), designed for Hopper (sm_90a): every ray keeps its own
// walk, and the warp tests each pending leaf together. extern "C" launcher
// for ctypes.
//
// Replaces pt/accel/pallas_bvh_archive.py:1763 packet_closest_v3 (A1, body
// :1228), :2009 packet_closest (A7, body :972) and :2089 packet_closest_sub
// (A10, body :1073): three TPU schedules of one walk, which DMA each leaf
// page once per packet and test the packet on the MXU. Here a page is read
// once per group of a warp's lanes that want it, and its test is shared by
// those lanes; no lane visits a node or a leaf that its own walk would not
// visit.
//
// What bounded the first design (ordered_kernels.cu, kept as the per-ray arm
// of the A/B and as the counted variant, `pt_ordered_closest`): the walk is
// bound by its leaf tests (664 triangle tests a ray on the bvh_kernels
// harness), and one lane tested a leaf alone, `block` iterations of 22
// scattered loads from 7 page rows page_cols * 4 bytes apart, however many
// lanes of the warp were in that leaf, while the warp stepped through those
// iterations until its slowest lane was done. The leaves are K3's v4 pages.
//
// This design (each lane's sequence of node and leaf visits is exactly the
// per-ray walk's, ordered_traverse.cuh, so v4::Counts of the counted variant
// still describes its work):
//   1. A lane runs ordered_traverse.cuh's loop over its own stack of node
//      ids: it pops a node and retests its box against its own best t; at
//      an internal node it slab-tests both children (left = node + 1, right
//      = top_miss[left]) and pushes the far one first (its own tnear, left
//      winning ties); at a leaf whose retest passes it stops with that leaf
//      pending. A leaf is known only after the pop retest (top_leaf), which
//      is why this walk is not bf8_warp_kernels.cu's template: K1's stack
//      carries leaf entries (kLeafBit) instead.
//   2. When every live lane of the warp holds a pending leaf or is done,
//      the warp groups its lanes by leaf (__match_any_sync; a leaf's page
//      index is its leaf id) and tests each group's page together
//      (warp_leaf.cuh's `test_groups`: 32-triangle chunks staged by
//      cp.async, the next chunk in flight). Each member's ray and limit are
//      broadcast by shuffle in turn; lane l tests triangle l of the chunk.
//      A chunk with fewer valid columns than rays to test is tested the
//      other way round: each member's own lane runs its ray against those
//      columns, read from the staged chunk, in column order.
//   3. The chunk's winner is the least key of t (`t_key`), then the least id
//      with ALPHA_TRI_BIT stripped; t, u and v come from the winning lane.
//      Every column is accepted against the member's own tmax, not its best
//      t, as page_leaf.cuh's `leaf::closest` does, and the member's own lane
//      merges with that rule, a running lexicographic minimum of (t, id), so
//      neither the group nor the chunk order changes a bit. A tie across
//      two leaves that the pop retest culls (tnear < best t) resolves as in
//      the per-ray walk, since each lane pops what that walk pops.
//   4. The members resume their walks with the next pop of their own stacks.
// The chunk test (2-3) is bf8_warp_kernels.cu's, written out again here:
// that library's machine code is held fixed (pt_torch/benches/sass_diff.py).
// Built with -fmad=false: every t, u and v rounds as in the per-ray kernel.
//
// Resources: 128 threads (4 warps) a block; 22,528 bytes of static shared
// memory a block (4 warps x 2 stages x 22 x 32 f32); each lane's stack of
// ordered::kStackDepth (64) node ids, 256 bytes, lives in local memory, as
// in the per-ray kernel. `pt_ordw_blocks_per_sm` reports the resident
// blocks (chip_smoke.py prints it beside ptxas's -v line). The launcher
// refuses a tree whose pages cannot be staged (`stageable`) with
// cudaErrorInvalidValue. The kernel allocates nothing; the launcher returns
// cudaGetLastError() so that the Python wrapper can raise on a refused
// launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ordered_traverse.cuh"
#include "warp_leaf.cuh"

namespace {

using namespace warp_leaf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kLanes;

__global__ void __launch_bounds__(kThreads)
closest_kernel(v4::Tree tree, const float* __restrict__ orig,
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
    int32_t stack[ordered::kStackDepth];
    int sp = 0;
    if (valid) stack[sp++] = 0;
    const int block = tree.block;
    const int cols = tree.page_cols;
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
        // 1. walk on to the next leaf to test (ordered_traverse.cuh's loop)
        int32_t pending = -1;
        while (sp > 0) {
            const int32_t node = stack[--sp];
            float tn;
            if (!rt::slab(tree.top_lo + 3 * node, tree.top_hi + 3 * node, r,
                          best_t, &tn))
                continue;
            const int32_t lid = tree.top_leaf[node];
            if (lid >= 0) {
                pending = lid;
                break;
            }
            const int32_t left = node + 1;
            const int32_t right = tree.top_miss[left];
            float tn_l, tn_r;
            const bool hit_l = rt::slab(tree.top_lo + 3 * left,
                                        tree.top_hi + 3 * left, r, best_t,
                                        &tn_l);
            const bool hit_r = rt::slab(tree.top_lo + 3 * right,
                                        tree.top_hi + 3 * right, r, best_t,
                                        &tn_r);
            const bool near_left = !(hit_l && hit_r) || tn_l <= tn_r;
            if (near_left ? hit_r : hit_l)
                stack[sp++] = near_left ? right : left;     // far first
            if (near_left ? hit_l : hit_r)
                stack[sp++] = near_left ? left : right;
        }
        __syncwarp();
        if (__ballot_sync(kFull, pending >= 0) == 0u) break;

        // 2-3. the warp tests each pending leaf together
        test_groups(bufs, tree.pages, page_floats, cols, block, pending,
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
        // 4. the members resume their walks with the next pop
    }
    if (!valid) return;
    t_out[i] = best_t;
    tri_out[i] = best_tri;
    u_out[i] = best_u;
    v_out[i] = best_v;
}

}  // namespace

extern "C" {

int pt_ordw_closest(const float* top_lo, const float* top_hi,
                    const int32_t* top_miss, const int32_t* top_leaf,
                    const float* pages, int n_top, int block, int page_cols,
                    const float* orig, const float* dir, const float* tmax,
                    float tmin, int n, float* t_out, int32_t* tri_out,
                    float* u_out, float* v_out, void* stream) {
    if (n <= 0) return 0;
    if (!stageable(pages, block, page_cols))
        return (int)cudaErrorInvalidValue;
    v4::Tree tree{top_lo, top_hi, top_miss, top_leaf, pages, n_top, block,
                  page_cols};
    const int blocks = (n + kThreads - 1) / kThreads;
    closest_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        tree, orig, dir, tmax, tmin, n, t_out, tri_out, u_out, v_out);
    return (int)cudaGetLastError();
}

// Resident blocks per SM of the kernel (`kernel` 0, its only one); a
// negative CUDA error code on failure.
int pt_ordw_blocks_per_sm(int kernel) {
    if (kernel != 0) return -(int)cudaErrorInvalidValue;
    int blocks = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, closest_kernel, kThreads, 0);
    return e == cudaSuccess ? blocks : -(int)e;
}

int pt_ordw_smem_per_block() {
    return (int)(sizeof(float) * kWarps * kStages * kChunkFloats);
}

const char* pt_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
