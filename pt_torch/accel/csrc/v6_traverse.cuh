// Per-ray traversal of a BF8V6 tree: the BF8 collapse with child and leaf
// bounds in one table and a static push order per (node, direction octant).
//
// Replaces the Pallas kernels of pt/accel/pallas_bvh_archive.py over a
// BF8V6 by what a ray visits, not by how they schedule packets on the TPU:
//   packet_closest_v6 (_make_closest_kernel_v6) -> closest(), one pop per
//   iteration;
//   packet_closest_v6k2 (_make_closest_kernel_v6k2) -> closest_two_pops();
//   packet_closest_v7 (_make_closest_kernel_v7) -> closest_leaf_queue(),
//   which defers leaf tests into a queue drained every `window` pops and so
//   prunes against a best t up to `window` pops old;
//   packet_occluded_v6 (_make_occluded_kernel_v6) -> occluded().
// It is K1's stack walk (bf8_traverse.cuh) over the unified table: child
// slot node*8 + c holds the bounds of child c, row n8*8 + leaf the bounds
// of a leaf, which its pop retests. Where K1 sorts a node's hit children by
// tnear, here they are pushed in the order c_order[node*8 + octant]
// decodes to (eight 3-bit fields, field 0 pushed first: farthest first along
// the octant's diagonal, so the nearest pops first), with `octant` from this
// ray's own direction signs: bit 4 for dx < 0, bit 2 for dy < 0, bit 1 for
// dz < 0 (pt takes the majority of a 1024-ray packet).
//
// Structure (pt_torch/accel/archive.py:BF8V6):
//   u_lo, u_hi (n8*8 + L, 3) f32  child rows, then leaf rows (1e30 = empty)
//   c_ent      (n8*8,)       i32  child entry: node, LEAF_BIT|leaf, or -1
//   c_order    (n8*8,)       i32  packed push order per (node, octant)
//   pages      (L, 8, cols)  f32  Woop pages, see rt_common.cuh
//
// Stack bounds, D8 the tree's wide-node levels: one pop per iteration, as
// K1 (and the leaf-queue walk, whose leaves push nothing), leaves at most 7
// entries per level and 8 on top, 7*D8 + 1; two pops per iteration can
// leave the children of both popped nodes on one level, at most 16 per
// level, 16*D8. The wrappers check them against kStackDepth.
//
// Contract: as bf8_traverse.cuh (pt's, ROADMAP §2). Occlusion is true at
// the first accepted triangle, alpha-tagged or not (pt's v6 has no
// opaque_only).
//
// Bound: dependent global loads of node rows and pages, as K1; the static
// order saves K1's per-node sort, a few compares and moves per visit.
#pragma once

#include "bf8_traverse.cuh"
#include "page_leaf.cuh"

namespace v6 {

using bf8::Counts;      // nodes: wide-node visits; leaf_boxes; tris
using bf8::kLeafBit;
using rt::Ray;

constexpr int kStackDepth = 128;
constexpr int kQueueCap = 48;    // leaves queued per drain at most (pt's qcap)

struct Tree {
    const float* u_lo;
    const float* u_hi;
    const int32_t* c_ent;
    const int32_t* c_order;
    const float* pages;
    int n8;
    int block;       // triangles per leaf page
    int page_cols;   // padded page width (>= 7 * block)
};

RT_HD int octant(const Ray& r) {
    return (r.dx < 0.0f ? 4 : 0) | (r.dy < 0.0f ? 2 : 0)
           | (r.dz < 0.0f ? 1 : 0);
}

// Slab tests for a popped entry against t_limit: a leaf's own box (bit 0 of
// the result), or each non-empty child of a wide node (bit c for child c).
template <bool kCount>
RT_HD unsigned test_entry(const Tree& tree, int32_t ent, const Ray& r,
                          float t_limit, Counts* counts) {
    float tn;
    if (ent >= kLeafBit) {
        if constexpr (kCount) ++counts->leaf_boxes;
        size_t row = (size_t)tree.n8 * 8 + (ent - kLeafBit);
        return rt::slab(tree.u_lo + 3 * row, tree.u_hi + 3 * row, r, t_limit,
                        &tn) ? 1u : 0u;
    }
    bf8::count_node<kCount>(counts, ent);
    unsigned hits = 0;
    for (int c = 0; c < 8; ++c) {
        int k = ent * 8 + c;
        if (tree.c_ent[k] == -1) continue;
        if (rt::slab(tree.u_lo + 3 * k, tree.u_hi + 3 * k, r, t_limit, &tn))
            hits |= 1u << c;
    }
    return hits;
}

// Push wide node `node`'s hit children in its octant's static order.
RT_HD void push_children(const Tree& tree, int32_t node, unsigned hits,
                         int oct, int32_t* stack, int* sp) {
    int32_t perm = tree.c_order[node * 8 + oct];
    for (int j = 0; j < 8; ++j) {
        int c = (perm >> (3 * j)) & 7;
        if ((hits >> c) & 1u) stack[(*sp)++] = tree.c_ent[node * 8 + c];
    }
}

// What a popped entry does once its slab tests are in: a leaf whose box was
// hit tests its page; a wide node pushes its hit children.
template <bool kCount>
RT_HD void apply_closest(const Tree& tree, int32_t ent, unsigned hits,
                         int oct, const Ray& r, float tmin, float tmax,
                         leaf::Best* best, int32_t* stack, int* sp,
                         Counts* counts) {
    if (ent < kLeafBit)
        push_children(tree, ent, hits, oct, stack, sp);
    else if (hits)
        leaf::closest<kCount>(tree, ent - kLeafBit, r, tmin, tmax, best,
                              counts);
}

RT_HD void write_best(const leaf::Best& best, float* t_out, int32_t* tri_out,
                      float* u_out, float* v_out) {
    *t_out = best.t;
    *tri_out = best.tri;
    *u_out = best.u;
    *v_out = best.v;
}

// Closest hit of one ray, one pop per iteration. With kCount, `counts`
// (then never null) accumulates the work of this walk; without it,
// `counts` is not read and no counting code is built.
template <bool kCount>
RT_HD void closest(const Tree& tree, const Ray& r, float tmin, float tmax,
                   float* t_out, int32_t* tri_out, float* u_out,
                   float* v_out, Counts* counts) {
    int32_t stack[kStackDepth];
    int sp = 0;
    stack[sp++] = 0;
    int oct = octant(r);
    leaf::Best best = {tmax, -1, 0.0f, 0.0f};
    while (sp > 0) {
        int32_t ent = stack[--sp];
        unsigned hits = test_entry<kCount>(tree, ent, r, best.t, counts);
        apply_closest<kCount>(tree, ent, hits, oct, r, tmin, tmax, &best,
                              stack, &sp, counts);
    }
    write_best(best, t_out, tri_out, u_out, v_out);
}

// Closest hit of one ray, two pops per iteration (pt's v6k2): the top entry
// e0 and the one below it, e1, are both slab-tested against the best t as
// the iteration starts (e1 does not see what e0 finds in the same
// iteration: conservative), then e1's action runs first and e0's last, so
// that e0's children end on top and the nearest entries still pop first.
template <bool kCount>
RT_HD void closest_two_pops(const Tree& tree, const Ray& r, float tmin,
                            float tmax, float* t_out, int32_t* tri_out,
                            float* u_out, float* v_out, Counts* counts) {
    int32_t stack[kStackDepth];
    int sp = 0;
    stack[sp++] = 0;
    int oct = octant(r);
    leaf::Best best = {tmax, -1, 0.0f, 0.0f};
    while (sp > 0) {
        int32_t e0 = stack[sp - 1];
        bool two = sp > 1;
        int32_t e1 = two ? stack[sp - 2] : 0;
        unsigned h0 = test_entry<kCount>(tree, e0, r, best.t, counts);
        unsigned h1 = two ? test_entry<kCount>(tree, e1, r, best.t, counts)
                          : 0u;
        sp -= two ? 2 : 1;
        if (two)
            apply_closest<kCount>(tree, e1, h1, oct, r, tmin, tmax, &best,
                                  stack, &sp, counts);
        apply_closest<kCount>(tree, e0, h0, oct, r, tmin, tmax, &best, stack,
                              &sp, counts);
    }
    write_best(best, t_out, tri_out, u_out, v_out);
}

// Closest hit of one ray by pt's v7 walk. Each round pops up to `window`
// entries (fewer once the stack empties or kQueueCap leaves wait) and
// slab-tests them against t_slab, the best t as the last drain left it: a
// wide node pushes its hit children, a leaf whose box passes is queued, not
// tested. Then the queued leaves are tested in queue order against the
// current best t, and t_slab takes the best t. The result is the same
// function as closest(); the stale t_slab lets more boxes pass, so the walk
// can queue leaves that closest() culls.
template <bool kCount>
RT_HD void closest_leaf_queue(const Tree& tree, const Ray& r, float tmin,
                              float tmax, int window, float* t_out,
                              int32_t* tri_out, float* u_out, float* v_out,
                              Counts* counts) {
    int32_t stack[kStackDepth];
    int32_t queue[kQueueCap];
    int sp = 0;
    stack[sp++] = 0;
    int oct = octant(r);
    leaf::Best best = {tmax, -1, 0.0f, 0.0f};
    float t_slab = tmax;
    while (sp > 0) {
        int q = 0;
        for (int k = 0; k < window && sp > 0 && q < kQueueCap; ++k) {
            int32_t ent = stack[--sp];
            unsigned hits = test_entry<kCount>(tree, ent, r, t_slab, counts);
            if (ent < kLeafBit)
                push_children(tree, ent, hits, oct, stack, &sp);
            else if (hits)
                queue[q++] = ent - kLeafBit;
        }
        for (int j = 0; j < q; ++j)
            leaf::closest<kCount>(tree, queue[j], r, tmin, tmax, &best,
                                  counts);
        t_slab = best.t;
    }
    write_best(best, t_out, tri_out, u_out, v_out);
}

// Any hit with tmin < t < dist. Hit children push unordered (child 0
// first); the walk stops at the first accepted triangle. kCount and
// `counts` as for closest().
template <bool kCount>
RT_HD bool occluded(const Tree& tree, const Ray& r, float tmin, float dist,
                    Counts* counts) {
    int32_t stack[kStackDepth];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
        int32_t ent = stack[--sp];
        unsigned hits = test_entry<kCount>(tree, ent, r, dist, counts);
        if (ent < kLeafBit) {
            for (int c = 0; c < 8; ++c)
                if ((hits >> c) & 1u) stack[sp++] = tree.c_ent[ent * 8 + c];
        } else if (hits && leaf::any<kCount>(tree, ent - kLeafBit, r, tmin,
                                             dist, counts)) {
            return true;
        }
    }
    return false;
}

}  // namespace v6
