// One round of the integrator's split any-hit loops, per lane: what a round
// does besides its trace (pt_torch/render/integrator.py
// `_closest_round_plain` and `_shadow_round_plain`, the plain twins).
//
// A lane that is not pending reads one byte and leaves. A pending lane reads
// the round's hit of the alpha subset tree, maps it to its global triangle,
// fetches the level-0 bilinear color texel there times the material's color
// factor (pt_torch/render/textures.py `sample_texture_grad` without
// derivatives: the texture index clamp, the floor-modulo wrap, the row
// clamp, bf16 -> f32, the lerp order), decides, updates the loop's state in
// place and writes its ray for the next round: its advanced origin and limit
// while it stays pending, else the degenerate ray (origin outside the root
// box, +x, TMIN) that leaves the next trace at the root. A lane writes a
// degenerate ray once, when it stops; the buffers keep it for the rounds
// after. Without a root box (brute force) the rays are left as they are, as
// `_degenerate_masked` leaves them.
//
// The state and the next ray share memory: while a lane is pending, its
// current origin is the next ray's origin (`o`), and in the shadow loop its
// remaining distance the next ray's limit (`t`). In the closest loop the
// final hit's t starts as the opaque bound and may share its buffer: each
// lane reads everything before it writes.
//
// Everything is __host__ __device__ f32 arithmetic in the tensor code's
// order: built with -fmad=false (nvcc) or -ffp-contract=off (g++) it
// rounds as the plain twins do. The CPU tests build this header with g++.
//
// The structs are the launchers' arguments, passed by pointer:
// pt_torch/accel/kernels.py declares them field for field as ctypes
// structures, which both the CUDA launchers and the CPU tests' host build
// take.
#pragma once

#include <stdint.h>
#include <string.h>

#include "rt_common.cuh"

namespace alpha {

constexpr float kTmin = 1e-5f;       // pt_torch.render.rays.TMIN
constexpr float kStepPad = 1e-4f;    // the advance past a skipped surface
constexpr float kOutside = 1.0e6f;   // beyond the root box's upper corner

// pool layouts (DeviceTextures: quad, paired, flat rows, all 1x1 constants)
enum Layout { kQuad = 0, kPaired = 1, kFlat = 2, kConstant = 3 };

struct Hits {                 // the round's trace of the alpha subset tree
    const float* t;
    const int32_t* tri;       // subset-local id, -1 on a miss
    const float* u;
    const float* v;
};

struct Tables {               // the alpha subset and the material tables
    const int32_t* sel;       // (K,) subset id -> global triangle id
    const float* tri_uv;      // (T, 6) uv0|uv1|uv2
    const int32_t* tri_mat;   // (T,) material row
    const int32_t* mat_tex;   // (M, mat_tex_cols) texture-table indices
    const float* mat_params;  // (M, mat_params_cols)
    int mat_tex_cols, t_color, mat_params_cols, f_color;
};

struct Pool {                 // DeviceTextures
    const void* data;         // (rows, width) bf16 bits or f32
    int64_t rows;
    int width;
    const int32_t* offsets;   // (count, max_mips) texel row of each mip
    const int32_t* sizes;     // (count, max_mips, 2) (w, h) of each mip
    int count, max_mips;
    int layout;               // Layout
    int bf16;                 // 1: bf16 texels, 0: f32
};

struct NextRay {
    const float* dirs;        // (N, 3) the loop's directions
    float* o;                 // (N, 3)
    float* d;                 // (N, 3); null where the rays keep `dirs`
    float* t;                 // (N,)
    const float* root_hi;     // (3,) root box's upper corner; null: none
};

struct ClosestState {
    uint8_t* pending;
    float* t_accum;
    const float* bound;       // the opaque hit's t
    float* final_t;           // may be `bound`'s buffer
    int32_t* final_tri;
    float* final_u;
    float* final_v;
    float* decal_color;       // (N, 3)
    float* decal_alpha;
    uint8_t* has_decal;
};

struct ShadowState {
    uint8_t* pending;
    uint8_t* occluded;
};

RT_HD float texel(const uint16_t* p, int64_t k) {   // bf16 -> f32, exact
    const uint32_t bits = (uint32_t)p[k] << 16;
    float f;
    memcpy(&f, &bits, sizeof(f));
    return f;
}

RT_HD float texel(const float* p, int64_t k) { return p[k]; }

// torch.remainder of integers: the result takes the divisor's sign
RT_HD int64_t floor_mod(int64_t a, int64_t b) {
    int64_t r = a % b;
    if (r != 0 && ((r < 0) != (b < 0))) r += b;
    return r;
}

RT_HD int64_t clamp64(int64_t a, int64_t lo, int64_t hi) {
    return a < lo ? lo : (a > hi ? hi : a);
}

// `_bilinear_at_level`'s row(xi, yi): f32 -> int32 -> int64, wrapped, then
// clamped to the pool
RT_HD int64_t wrap_row(float xf, float yf, int64_t off, int64_t w, int64_t h,
                       int64_t rows_max) {
    const int64_t xi = floor_mod((int64_t)(int32_t)xf, w);
    const int64_t yi = floor_mod((int64_t)(int32_t)yf, h);
    return clamp64(off + yi * w + xi, 0, rows_max);
}

// `_surface_color_alpha_tri` at global triangle `tri`: channels c0..3 of
// texture(colorTex, uv) * colorFactor into rgba[c0..3]
template <int L, typename T>
RT_HD void color_alpha(const Tables& tb, const Pool& pool, int32_t tri,
                       float u, float v, int c0, float* rgba) {
    const float b0 = (1.0f - u) - v;
    const float* ru = tb.tri_uv + 6 * (int64_t)tri;
    const float uvx = (ru[0] * b0 + ru[2] * u) + ru[4] * v;
    const float uvy = (ru[1] * b0 + ru[3] * u) + ru[5] * v;
    const int64_t row = tb.tri_mat[tri];
    const int64_t tex = clamp64(tb.mat_tex[row * tb.mat_tex_cols + tb.t_color],
                                0, pool.count - 1);
    const float* factor = tb.mat_params + row * tb.mat_params_cols
                          + tb.f_color;
    const T* data = (const T*)pool.data;
    const int64_t off = pool.offsets[tex * pool.max_mips];
    const int64_t rows_max = pool.rows - 1;
    if (L == kConstant) {
        // one texel, no filtering (the pool's offsets always lie in it; the
        // clamp only keeps a bad table inside the buffer)
        const int64_t base = clamp64(off, 0, rows_max) * pool.width;
        for (int c = c0; c < 4; ++c) rgba[c] = texel(data, base + c) * factor[c];
        return;
    }
    const int32_t* size = pool.sizes + tex * pool.max_mips * 2;
    const int64_t wi = size[0], hi = size[1];
    const float w = (float)wi, h = (float)hi;
    const float x = uvx * w - 0.5f;
    const float y = uvy * h - 0.5f;
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    int64_t c00, c10, c01, c11;   // element offsets of the four corners
    if (L == kQuad) {
        const int64_t r = wrap_row(x0, y0, off, wi, hi, rows_max) * pool.width;
        c00 = r; c10 = r + 4; c01 = r + 8; c11 = r + 12;
    } else if (L == kPaired) {
        const int64_t r0 = wrap_row(x0, y0, off, wi, hi, rows_max) * pool.width;
        const int64_t r1 = wrap_row(x0, y0 + 1.0f, off, wi, hi, rows_max)
                           * pool.width;
        c00 = r0; c10 = r0 + 4; c01 = r1; c11 = r1 + 4;
    } else {
        c00 = wrap_row(x0, y0, off, wi, hi, rows_max) * pool.width;
        c10 = wrap_row(x0 + 1.0f, y0, off, wi, hi, rows_max) * pool.width;
        c01 = wrap_row(x0, y0 + 1.0f, off, wi, hi, rows_max) * pool.width;
        c11 = wrap_row(x0 + 1.0f, y0 + 1.0f, off, wi, hi, rows_max)
              * pool.width;
    }
    const float gx = 1.0f - fx, gy = 1.0f - fy;
    for (int c = c0; c < 4; ++c) {
        const float top = texel(data, c00 + c) * gx + texel(data, c10 + c) * fx;
        const float bot = texel(data, c01 + c) * gx + texel(data, c11 + c) * fx;
        rgba[c] = (top * gy + bot * fy) * factor[c];
    }
}

// `_degenerate_masked` for a lane that stops: a ray that exits at the root
RT_HD void degenerate(int64_t i, const NextRay& r) {
    for (int k = 0; k < 3; ++k) r.o[3 * i + k] = r.root_hi[k] + kOutside;
    r.d[3 * i] = 1.0f;
    r.d[3 * i + 1] = 0.0f;
    r.d[3 * i + 2] = 0.0f;
    r.t[i] = kTmin;
}

// advance a skipping lane's origin (the next ray's) by `step` along its ray
RT_HD void advance(int64_t i, const NextRay& r, float step) {
    for (int k = 0; k < 3; ++k)
        r.o[3 * i + k] = r.o[3 * i + k] + r.dirs[3 * i + k] * step;
}

// One round of the closest loop: the first alpha >= 0.5 surface in front of
// the opaque bound accepts, one below skips (the first skip records the
// decal), anything else ends the lane with the opaque hit.
template <int L, typename T>
RT_HD void closest_lane(int64_t i, const Hits& h, const ClosestState& s,
                        const NextRay& r, const Tables& tb, const Pool& pool) {
    if (!s.pending[i]) return;
    const float t = h.t[i];
    const int32_t tri = h.tri[i];
    const float ta = s.t_accum[i];
    const float bound = s.bound[i];
    bool skips = false;
    if (tri >= 0 && ta + t < bound) {
        const int32_t g = tb.sel[tri];
        const float u = h.u[i], v = h.v[i];
        float rgba[4];
        color_alpha<L, T>(tb, pool, g, u, v, 0, rgba);
        skips = rgba[3] < 0.5f;
        if (rgba[3] >= 0.5f) {
            s.final_t[i] = ta + t;
            s.final_tri[i] = g;
            s.final_u[i] = u;
            s.final_v[i] = v;
        } else if (skips && !s.has_decal[i]) {
            for (int k = 0; k < 3; ++k) s.decal_color[3 * i + k] = rgba[k];
            s.decal_alpha[i] = rgba[3];
            s.has_decal[i] = 1;
        }
    }
    s.pending[i] = skips ? 1 : 0;
    if (skips) {
        const float step = t + kStepPad;
        advance(i, r, step);
        const float ta2 = ta + step;
        s.t_accum[i] = ta2;
        const float rem = bound - ta2;
        r.t[i] = rem < 0.0f ? 0.0f : rem;
    } else if (r.root_hi != nullptr) {
        degenerate(i, r);
    }
}

// One round of the shadow loop: an alpha >= 1 surface within the remaining
// distance blocks; a translucent one passes the lane on behind it.
template <int L, typename T>
RT_HD void shadow_lane(int64_t i, const Hits& h, const ShadowState& s,
                       const NextRay& r, const Tables& tb, const Pool& pool) {
    if (!s.pending[i]) return;
    const int32_t tri = h.tri[i];
    bool translucent = false;
    if (tri >= 0) {
        float rgba[4];
        color_alpha<L, T>(tb, pool, tb.sel[tri], h.u[i], h.v[i], 3, rgba);
        translucent = rgba[3] < 1.0f;
        if (!translucent) s.occluded[i] = 1;
    }
    s.pending[i] = translucent ? 1 : 0;
    if (translucent) {
        const float step = h.t[i] + kStepPad;
        advance(i, r, step);
        r.t[i] = r.t[i] - step;
    } else if (r.root_hi != nullptr) {
        degenerate(i, r);
    }
}

// Calls f(PoolKind<layout, texel type>()) for the pool's layout and texel
// type; -1 on a layout it does not know.
template <int L, typename T>
struct PoolKind {
    static constexpr int layout = L;
    using texel_t = T;
};

template <class F>
int with_pool(const Pool& pool, F&& f) {
    const bool bf16 = pool.bf16 != 0;
    switch (pool.layout) {
    case kQuad:
        return bf16 ? f(PoolKind<kQuad, uint16_t>()) : f(PoolKind<kQuad, float>());
    case kPaired:
        return bf16 ? f(PoolKind<kPaired, uint16_t>())
                    : f(PoolKind<kPaired, float>());
    case kFlat:
        return bf16 ? f(PoolKind<kFlat, uint16_t>()) : f(PoolKind<kFlat, float>());
    case kConstant:
        return bf16 ? f(PoolKind<kConstant, uint16_t>())
                    : f(PoolKind<kConstant, float>());
    }
    return -1;
}

}  // namespace alpha
