// The round kernels of the integrator's split any-hit loops, for Hopper
// (sm_90a): one launch a round does all a round does besides its trace.
// extern "C" launchers for ctypes.
//
// Replaces no TPU kernel: pt runs the same rounds as XLA-fused tensor code
// (pt/render/integrator.py `_trace_closest_alpha_split`,
// `_trace_occluded_alpha_split`). In the port's eager PyTorch each round
// was ~90 full-width ops (the subset remap, the texel fetch's ten gathers
// with their int64 index arithmetic, the accept/skip/decal selects, the
// advance, the next round's masked ray), though only about one lane in
// eight is pending after a wavefront's first round.
//
// What bounds it: bytes, at least (bf16 texels; f32 add 32 B a fetch):
//   closest: N + 45 P + 120 H     shadow: N + 33 P + 93 H
// over 3.35 TB/s, for a round over N lanes of which P are pending and H
// fetch a texel (pending with a hit, in the closest loop in front of the
// bound). Every lane reads its pending byte (the N). A pending lane reads
// its hit's t and id (closest also t_accum and the bound: 16 B; shadow the
// id: 4 B), writes its pending byte and at least the degenerate ray (28 B).
// A fetching lane reads u, v, the subset id, the uv rows, the material row,
// its color-texture index and factor (closest 4 channels, shadow alpha
// only), the mip-0 offset and size (closest 72 B, shadow 60 B) and its
// texels (32 B in every layout: one quad row, two paired rows or four flat
// ones), and writes at least its outcome (closest the final hit or the
// skip's advance beyond the degenerate ray: 16 B; shadow the occluded
// byte). chip_smoke.py computes the bound from the same counts.
//
// One thread per lane: the pending lanes' gathers are scattered, and the
// many lanes that leave at once keep the rest of the card's bandwidth free.
//
// Each pool layout and texel type is a template instance, so every pool
// that DeviceTextures can carry has its kernel. Built with -fmad=false:
// the arithmetic rounds as the plain twins' does, and the films are
// bit-equal.

#include <cuda_runtime.h>

#include "alpha_round.cuh"

namespace {

constexpr int kThreads = 256;

template <int L, typename T>
__global__ void __launch_bounds__(kThreads)
alpha_closest_round(alpha::Hits h, alpha::ClosestState s, alpha::NextRay r,
                    alpha::Tables tb, alpha::Pool pool, int n) {
    const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (i < n) alpha::closest_lane<L, T>(i, h, s, r, tb, pool);
}

template <int L, typename T>
__global__ void __launch_bounds__(kThreads)
alpha_shadow_round(alpha::Hits h, alpha::ShadowState s, alpha::NextRay r,
                   alpha::Tables tb, alpha::Pool pool, int n) {
    const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (i < n) alpha::shadow_lane<L, T>(i, h, s, r, tb, pool);
}

int status(int rc) {
    return rc != 0 ? (int)cudaErrorInvalidValue : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pt_alpha_closest_round(const alpha::Hits* h, const alpha::ClosestState* s,
                           const alpha::NextRay* r, const alpha::Tables* tb,
                           const alpha::Pool* pool, int n, void* stream) {
    if (n <= 0) return 0;
    const int blocks = (n + kThreads - 1) / kThreads;
    return status(alpha::with_pool(*pool, [&](auto kind) {
        using K = decltype(kind);
        alpha_closest_round<K::layout, typename K::texel_t>
            <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*h, *s, *r, *tb,
                                                            *pool, n);
        return 0;
    }));
}

int pt_alpha_shadow_round(const alpha::Hits* h, const alpha::ShadowState* s,
                          const alpha::NextRay* r, const alpha::Tables* tb,
                          const alpha::Pool* pool, int n, void* stream) {
    if (n <= 0) return 0;
    const int blocks = (n + kThreads - 1) / kThreads;
    return status(alpha::with_pool(*pool, [&](auto kind) {
        using K = decltype(kind);
        alpha_shadow_round<K::layout, typename K::texel_t>
            <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*h, *s, *r, *tb,
                                                            *pool, n);
        return 0;
    }));
}

const char* pt_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
