// Pieces shared by the warp-cooperative traversal kernels
// (v4_warp_kernels.cu: K3/K4 over a PacketBVH; bf8i_warp_kernels.cu: K5/K6
// over an instanced BF8 tree; bf8_warp_kernels.cu: K1 over a BF8 tree and
// closest_v6 over a BF8V6; bf8_occluded_warp_kernels.cu: K2 and
// occluded_v6; ordered_warp_kernels.cu: closest_ordered's near-child-first
// walk over a PacketBVH). Each lane walks its own ray; when every live
// lane of the warp holds a pending page or is done, the warp groups its
// lanes by page and tests each page together. What they share:
//   * the staging: a page is staged into shared memory in chunks of 32
//     triangles (`stage_chunk`): 22 rows of the page (W_k and b_k: rows 0-3
//     of column groups 0-2; W_k again: rows 4-6 of groups 3-5; the ids: row
//     0 of group 6), 32 columns each, 2,816 bytes, by cp.async 16-byte
//     copies; a row segment is one coalesced 128-byte line. The kernels keep
//     the next chunk in flight while the current one is tested (kStages);
//   * the register triangle: lane l takes triangle l of the chunk
//     (`load_tri`) and tests it against a ray broadcast by shuffle (`woop`,
//     rt::woop's arithmetic in its order);
//   * the key: closest reduces an order-preserving key of t (`t_key`, -0.0
//     folded into +0.0) over the lanes, then the id at that key;
//   * the group loop (`test_groups`) of every warp kernel but K3/K4, which
//     keep their own, which their A/B measured;
//   * the pages' conditions (`stageable`): block % 32 == 0 (every
//     builder's page-group granularity), page_cols % 4 == 0 and a 16-byte
//     aligned base.
// Page layout: rt_common.cuh. Built with -fmad=false, every t, u and v
// rounds as in the per-ray kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "rt_common.cuh"

namespace warp_leaf {

constexpr int kLanes = 32;
constexpr int kRows = 22;       // staged page rows of a chunk
constexpr int kStages = 2;
constexpr int kChunkFloats = kRows * kLanes;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoKey = 0xffffffffu;

// A triangle's Woop rows in registers: w[4k + r] is row r of column group k
// (W_k's three entries, then b_k), wd[3k + r] row 4 + r of group 3 + k.
struct Tri {
    float w[12];
    float wd[9];
    int32_t id;
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
    unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage chunk `c` (triangles 32c .. 32c + 31) of the page at `page` into
// `buf` (kRows x 32 f32): 22 rows x 8 pieces of 16 bytes, spread over the
// lanes.
__device__ __forceinline__ void stage_chunk(float* buf, const float* page,
                                            int cols, int block, int c,
                                            int lane) {
    for (int p = lane; p < kRows * 8; p += kLanes) {
        int s = p >> 3, q = p & 7;
        int off;
        if (s < 12) {
            off = (s & 3) * cols + (s >> 2) * block;
        } else if (s < 21) {
            int r = s - 12;
            off = (4 + r % 3) * cols + (3 + r / 3) * block;
        } else {
            off = 6 * block;
        }
        cp_async16(buf + s * kLanes + 4 * q,
                   page + off + c * kLanes + 4 * q);
    }
}

__device__ __forceinline__ Tri load_tri(const float* buf, int lane) {
    Tri tr;
#pragma unroll
    for (int s = 0; s < 12; ++s) tr.w[s] = buf[s * kLanes + lane];
#pragma unroll
    for (int s = 0; s < 9; ++s) tr.wd[s] = buf[(12 + s) * kLanes + lane];
    tr.id = __float_as_int(buf[21 * kLanes + lane]);
    return tr;
}

// rt::woop's arithmetic, in its order, on a triangle held in registers
__device__ __forceinline__ float woop(const Tri& tr, float ox, float oy,
                                      float oz, float dx, float dy, float dz,
                                      float* u_out, float* v_out) {
    float op[3], dp[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        op[k] = ((tr.w[4 * k] * ox + tr.w[4 * k + 1] * oy)
                 + tr.w[4 * k + 2] * oz) + tr.w[4 * k + 3];
        dp[k] = (tr.wd[3 * k] * dx + tr.wd[3 * k + 1] * dy)
                + tr.wd[3 * k + 2] * dz;
    }
    float t = -op[2] / dp[2];
    *u_out = op[0] + t * dp[0];
    *v_out = op[1] + t * dp[1];
    return t;
}

// Order-preserving key of a float that is not NaN: a < b as floats iff
// key(a) < key(b); -0.0 and +0.0 share the key of +0.0. kNoKey is above
// every such key.
__device__ __forceinline__ unsigned t_key(float t) {
    unsigned b = __float_as_uint(t);
    if ((b << 1) == 0u) b = 0u;
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Test every pending page of the warp, group by group. `page` is this
// lane's pending page index, -1 for none; at least one lane of the warp
// has one. `bufs` is the warp's kStages x kChunkFloats of shared memory.
// For every staged chunk, `test(tr, chunk, act)` runs on all lanes with
// triangle `lane` of the chunk in `tr`, the staged chunk (kRows x 32 f32;
// `load_tri(chunk, c)` reads column c) and the lanes of the group still to
// be tested in `act`; it may clear lanes from `act` (an occluded ray), and
// a group with none left stops staging (a chunk already in flight is then
// consumed untested). A test that reads `chunk` itself ends with a
// __syncwarp(): the stage after next overwrites it.
template <class Test>
__device__ __forceinline__ void test_groups(float* bufs, const float* pages,
                                            size_t page_floats, int cols,
                                            int block, int32_t page,
                                            Test&& test) {
    const int lane = threadIdx.x & (kLanes - 1);
    const unsigned below = (1u << lane) - 1u;
    const int n_chunks = block / kLanes;
    const unsigned group = __match_any_sync(kFull, page);
    unsigned leaders = __ballot_sync(kFull,
                                     page >= 0 && (group & below) == 0u);
    int L = __ffs(leaders) - 1;
    leaders &= leaders - 1u;
    int g_page = __shfl_sync(kFull, page, L);
    unsigned g_act = __shfl_sync(kFull, group, L);   // rays to test
    int g_c = 0;
    int buf = 0;
    stage_chunk(bufs, pages + (size_t)g_page * page_floats, cols, block, 0,
                lane);
    cp_async_commit();
    while (true) {
        // the unit after this one: the page's next chunk while rays of the
        // group are left, else the next group's first chunk
        int n_page = g_page, n_c = g_c + 1;
        unsigned n_act = g_act;
        if (n_c >= n_chunks || g_act == 0u) {
            n_c = 0;
            if (leaders != 0u) {
                L = __ffs(leaders) - 1;
                leaders &= leaders - 1u;
                n_page = __shfl_sync(kFull, page, L);
                n_act = __shfl_sync(kFull, group, L);
            } else {
                n_page = -1;
            }
        }
        if (n_page >= 0)
            stage_chunk(bufs + (buf ^ 1) * kChunkFloats,
                        pages + (size_t)n_page * page_floats, cols, block,
                        n_c, lane);
        cp_async_commit();
        cp_async_wait_one();
        __syncwarp();
        if (g_act != 0u) {
            const float* chunk = bufs + buf * kChunkFloats;
            const Tri tr = load_tri(chunk, lane);
            __syncwarp();    // read before the next stage overwrites
            test(tr, chunk, g_act);
        }
        if (n_page < 0) break;
        if (n_c == 0) g_act = n_act;   // a new group
        g_page = n_page;
        g_c = n_c;
        buf ^= 1;
    }
}

// the staging layout's conditions on the pages (see the note above)
inline bool stageable(const float* pages, int block, int page_cols) {
    return block > 0 && block % kLanes == 0 && page_cols % 4 == 0
           && page_cols >= 7 * block
           && reinterpret_cast<uintptr_t>(pages) % 16 == 0;
}

}  // namespace warp_leaf
