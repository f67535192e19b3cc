// Per-ray pieces shared by the traversal kernels: the ray with its clamped
// reciprocal direction, the slab test, the full-f32 Woop leaf test on a
// Woop page and the hit acceptance rule. bf8_traverse.cuh (K1/K2) and
// v4_traverse.cuh (K3/K4) build on them.
//
// Page layout (as pt_torch/accel/bvh8.py packs it), per leaf of `block`
// triangles, (8, cols) f32:
//   rows 0-3 of column group k (k = 0..2): W_k (3 values) and b_k,
//   so o'_k = W_k . o + b_k;
//   rows 4-6 of column group 3+k: W_k again, so d'_k = W_k . d;
//   row 0 of column group 6: the triangle id's int32 bits (-1 = padding,
//   ALPHA_TRI_BIT marks a non-opaque triangle).
//
// Everything is __host__ __device__: nvcc builds it into the CUDA kernels
// and g++ into a host library that the CPU tests run. The arithmetic is
// plain f32 in a fixed order; built with -fmad=false (nvcc) or
// -ffp-contract=off (g++) it rounds exactly like the plain PyTorch versions
// in pt_torch/accel/kernels.py.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define RT_HD __host__ __device__ __forceinline__
#else
#define RT_HD inline
#endif

namespace rt {

constexpr int32_t kAlphaTriBit = 1 << 30;

struct Ray {
    float ox, oy, oz;
    float dx, dy, dz;
    float ix, iy, iz;   // clamped reciprocal directions
};

// pt's safe_inv: |a| < 1e-12 is clamped to +-1e-12 before the reciprocal
RT_HD float safe_inv(float a) {
    float s = fabsf(a) < 1e-12f ? (a < 0.0f ? -1e-12f : 1e-12f) : a;
    return 1.0f / s;
}

RT_HD Ray make_ray(float ox, float oy, float oz, float dx, float dy,
                  float dz) {
    Ray r;
    r.ox = ox; r.oy = oy; r.oz = oz;
    r.dx = dx; r.dy = dy; r.dz = dz;
    r.ix = safe_inv(dx); r.iy = safe_inv(dy); r.iz = safe_inv(dz);
    return r;
}

// Slab test of box [lo, hi] against the ray up to t_limit; writes tnear.
RT_HD bool slab(const float* lo, const float* hi, const Ray& r,
                float t_limit, float* tnear_out) {
    float t0x = (lo[0] - r.ox) * r.ix;
    float t1x = (hi[0] - r.ox) * r.ix;
    float t0y = (lo[1] - r.oy) * r.iy;
    float t1y = (hi[1] - r.oy) * r.iy;
    float t0z = (lo[2] - r.oz) * r.iz;
    float t1z = (hi[2] - r.oz) * r.iz;
    float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                        fminf(t0z, t1z));
    float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                       fmaxf(t0z, t1z));
    *tnear_out = tnear;
    return tnear <= tfar && tfar > 0.0f && tnear < t_limit;
}

RT_HD int32_t float_bits(float f) {
    int32_t i;
    memcpy(&i, &f, sizeof(i));
    return i;
}

// Woop test of triangle j of page `page`. Returns t (u, v written); the
// caller applies the acceptance rule.
RT_HD float woop(const float* page, int cols, int block, int j,
                 const Ray& r, float* u_out, float* v_out) {
    float op[3], dp[3];
    for (int k = 0; k < 3; ++k) {
        int c = k * block + j;
        op[k] = ((page[0 * cols + c] * r.ox + page[1 * cols + c] * r.oy)
                 + page[2 * cols + c] * r.oz) + page[3 * cols + c];
        int cd = (3 + k) * block + j;
        dp[k] = (page[4 * cols + cd] * r.dx + page[5 * cols + cd] * r.dy)
                + page[6 * cols + cd] * r.dz;
    }
    float t = -op[2] / dp[2];
    *u_out = op[0] + t * dp[0];
    *v_out = op[1] + t * dp[1];
    return t;
}

RT_HD bool accept(float t, float u, float v, float tmin, float tmax) {
    return t > tmin && t < tmax && u >= 0.0f && v >= 0.0f
           && u + v <= 1.0f;
}

}  // namespace rt
