// Per-ray traversal of an instanced BF8 BVH: a world-space BF8 top tree whose
// leaves reference shared object-space Woop pages through (page, segment)
// indirection (TLAS semantics).
//
// Replaces the Pallas kernels pt/accel/instanced.py:packet_closest_bf8i and
// :packet_occluded_bf8i by what they compute, not by how they schedule on the
// TPU. The internal phase is bf8_traverse.cuh's over world-space child boxes.
// At a leaf `lid` the page is pages[leaf_page[lid]], the segment is
// leaf_seg[lid], and the ray is mapped into that instance's object space:
//   o' = A o + b,  d' = A d,  A = seg_inv[12 s .. 12 s + 9) row-major,
//                             b = seg_inv[12 s + 9 .. 12 s + 12)
// d' is not renormalised: t is invariant under an affine map applied to o
// and d alike, so tmin, tmax and the best hit stay in world parameterisation.
// Only the Woop rows read (o', d'); every slab test uses the world ray.
//
// Structure (as pt_torch/accel/instanced.py lays it out): the BF8 arrays of
// bf8_traverse.cuh in world space, plus
//   leaf_page (L,)     i32  shared page of the leaf
//   leaf_seg  (L,)     i32  owning segment
//   seg_inv   (S * 12,) f32 inverse transform rows [A | b] per segment
//   pages     (P, 8, cols) f32 object-space pages, P << L; ids are
//                           mesh-local (-1 = padding, ALPHA_TRI_BIT kept)
//
// Contract: accept tmin < t < tmax with u >= 0, v >= 0, u + v <= 1. The
// winning mesh-local id is branded with segment << kSegShift. Smallest t
// wins; on an exact t tie the smallest branded id (ALPHA_TRI_BIT stripped)
// wins and u/v come from that triangle. A miss gives t = tmax, tri = -1,
// u = v = 0. The id comes back with its ALPHA_TRI_BIT when raw_ids is set,
// stripped otherwise.
//
// The arithmetic is plain f32 in a fixed order (the transform left to right:
// ((a0 ox + a1 oy) + a2 oz) + b0). Built with -fmad=false (nvcc) or
// -ffp-contract=off (g++) it rounds exactly like the plain PyTorch version
// in pt_torch/accel/kernels.py.
//
// Bound: as bf8_traverse.cuh, dependent global loads of node and page rows,
// with two index loads and twelve transform loads more per leaf visit. The
// per-ray kernels (bf8i_kernels.cu) test each leaf on one lane;
// bf8i_warp_kernels.cu runs the same walk per lane and tests each pending
// page with the whole warp.
#pragma once

#include "bf8_traverse.cuh"

namespace bf8i {

using bf8::kLeafBit;
using bf8::kStackDepth;
using bf8::push_near_first;
using rt::Ray;
using rt::accept;
using rt::float_bits;
using rt::kAlphaTriBit;
using rt::slab;
using rt::woop;

constexpr int kSegShift = 20;

struct Tree {
    bf8::Tree top;             // world-space BF8 arrays; pages object-space
    const int32_t* leaf_page;  // (L,)
    const int32_t* leaf_seg;   // (L,)
    const float* seg_inv;      // (S * 12,)
};

// Work done by a counted traversal: wide-node visits, leaf-box retests,
// leaf visits (retest passed: the indices and the transform are read) and
// triangle tests of this ray, and the structure it touched, shared by all
// rays: node_seen[node], leaf_seen[leaf] and tri_seen[page * block + j].
struct Counts {
    unsigned long long nodes;
    unsigned long long leaf_boxes;
    unsigned long long leaf_visits;
    unsigned long long tris;
    uint8_t* node_seen;   // (n8,)
    uint8_t* leaf_seen;   // (L,)
    uint8_t* tri_seen;    // (P * block,)
};

// The ray in the object space of segment `seg`. Its reciprocal directions
// are not set: no slab test runs in object space.
BF8_HD Ray to_object(const float* seg_inv, int32_t seg, const Ray& r) {
    const float* a = seg_inv + 12 * (size_t)seg;
    Ray q;
    q.ox = ((a[0] * r.ox + a[1] * r.oy) + a[2] * r.oz) + a[9];
    q.oy = ((a[3] * r.ox + a[4] * r.oy) + a[5] * r.oz) + a[10];
    q.oz = ((a[6] * r.ox + a[7] * r.oy) + a[8] * r.oz) + a[11];
    q.dx = (a[0] * r.dx + a[1] * r.dy) + a[2] * r.dz;
    q.dy = (a[3] * r.dx + a[4] * r.dy) + a[5] * r.dz;
    q.dz = (a[6] * r.dx + a[7] * r.dy) + a[8] * r.dz;
    q.ix = q.iy = q.iz = 0.0f;
    return q;
}

// Push the children of wide node `ent` whose boxes the ray hits before
// `t_limit`, in child order (the last pops first).
BF8_HD void push_hit(const bf8::Tree& top, int32_t ent, const Ray& r,
                     float t_limit, int32_t* stack, int* sp) {
    for (int c = 0; c < 8; ++c) {
        int k = ent * 8 + c;
        int32_t e = top.c_ent[k];
        if (e == -1) continue;
        float tn;
        if (slab(top.c_lo + 3 * k, top.c_hi + 3 * k, r, t_limit, &tn))
            stack[(*sp)++] = e;
    }
}

// Closest hit of one ray. Children that pass the slab test are pushed
// far-first (push_near_first), so the nearest pops first. kCount and
// `counts` as in bf8::closest.
template <bool kCount>
BF8_HD void closest(const Tree& tree, const Ray& r, float tmin, float tmax,
                    bool raw_ids, float* t_out, int32_t* tri_out,
                    float* u_out, float* v_out, Counts* counts) {
    const bf8::Tree& top = tree.top;
    int32_t stack[kStackDepth];
    int sp = 0;
    stack[sp++] = 0;
    float best_t = tmax;
    int32_t best_tri = -1;     // branded, ALPHA_TRI_BIT stripped
    int32_t best_raw = -1;     // branded, with its ALPHA_TRI_BIT
    float best_u = 0.0f, best_v = 0.0f;
    while (sp > 0) {
        int32_t ent = stack[--sp];
        if (ent >= kLeafBit) {
            int32_t lid = ent - kLeafBit;
            float tn;
            if constexpr (kCount) ++counts->leaf_boxes;
            if (!slab(top.l_lo + 3 * lid, top.l_hi + 3 * lid, r, best_t, &tn))
                continue;
            int32_t pid = tree.leaf_page[lid];
            int32_t seg = tree.leaf_seg[lid];
            if constexpr (kCount) {
                ++counts->leaf_visits;
                counts->leaf_seen[lid] = 1;
            }
            Ray q = to_object(tree.seg_inv, seg, r);
            const float* page = top.pages
                + (size_t)pid * 8 * (size_t)top.page_cols;
            const float* ids = page + 6 * top.block;
            int32_t brand = seg << kSegShift;
            for (int j = 0; j < top.block; ++j) {
                int32_t id = float_bits(ids[j]);
                if (id < 0) continue;
                if constexpr (kCount) {
                    ++counts->tris;
                    counts->tri_seen[(size_t)pid * top.block + j] = 1;
                }
                float u, v;
                float t = woop(page, top.page_cols, top.block, j, q, &u, &v);
                if (!accept(t, u, v, tmin, tmax)) continue;
                int32_t raw = id | brand;
                int32_t idc = raw & ~kAlphaTriBit;
                if (t < best_t || (t == best_t && best_tri >= 0
                                   && idc < best_tri)) {
                    best_t = t;
                    best_tri = idc;
                    best_raw = raw;
                    best_u = u;
                    best_v = v;
                }
            }
        } else {
            if constexpr (kCount) {
                ++counts->nodes;
                counts->node_seen[ent] = 1;
            }
            push_near_first(top, ent, r, best_t, stack, &sp);
        }
    }
    *t_out = best_t;
    *tri_out = raw_ids ? best_raw : best_tri;
    *u_out = best_u;
    *v_out = best_v;
}

// Any hit with tmin < t < dist. Children push unsorted (push_hit); with
// opaque_only, triangles tagged ALPHA_TRI_BIT are ignored.
template <bool kCount>
BF8_HD bool occluded(const Tree& tree, const Ray& r, float tmin, float dist,
                     bool opaque_only, Counts* counts) {
    const bf8::Tree& top = tree.top;
    int32_t stack[kStackDepth];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
        int32_t ent = stack[--sp];
        if (ent >= kLeafBit) {
            int32_t lid = ent - kLeafBit;
            int32_t pid = tree.leaf_page[lid];
            int32_t seg = tree.leaf_seg[lid];
            if constexpr (kCount) {
                ++counts->leaf_visits;
                counts->leaf_seen[lid] = 1;
            }
            Ray q = to_object(tree.seg_inv, seg, r);
            const float* page = top.pages
                + (size_t)pid * 8 * (size_t)top.page_cols;
            const float* ids = page + 6 * top.block;
            for (int j = 0; j < top.block; ++j) {
                int32_t id = float_bits(ids[j]);
                if (id < 0) continue;
                if (opaque_only && (id & kAlphaTriBit)) continue;
                if constexpr (kCount) {
                    ++counts->tris;
                    counts->tri_seen[(size_t)pid * top.block + j] = 1;
                }
                float u, v;
                float t = woop(page, top.page_cols, top.block, j, q, &u, &v);
                if (accept(t, u, v, tmin, dist)) return true;
            }
        } else {
            if constexpr (kCount) {
                ++counts->nodes;
                counts->node_seen[ent] = 1;
            }
            push_hit(top, ent, r, dist, stack, &sp);
        }
    }
    return false;
}

}  // namespace bf8i
