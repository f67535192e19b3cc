// Per-ray traversal of a binary PacketBVH (preorder top tree with skip links)
// with Woop-page leaves.
//
// Replaces the Pallas kernels pt/accel/pallas_bvh.py:packet_closest_v4 and
// :packet_occluded_v4 by what they compute, not by how they schedule on the
// TPU (1024-ray sub-packets in three phases, an SMEM stack, prefetched leaf
// DMAs, a bf16 MXU leaf product). Here one ray walks the tree alone and
// without a stack: the structure is stored in preorder, so the left child of
// an internal node i is i + 1, and top_miss[i] is the next node once i's
// subtree is skipped or done. A node whose box the ray misses goes to
// top_miss[i]; an internal node that is hit goes to i + 1; a leaf that is
// hit tests its page and goes to top_miss[i]. The walk ends at the sentinel
// top_miss value n_top (what pt_torch/accel/lbvh.py:_topology and the native
// SAH builder both write for "past the last node").
//
// Why stackless and not a near-child-first stack walk: the result does not
// depend on the visit order, the state is one int per ray, and no bound on
// the tree depth is needed (the SAH trees of the static fallback have no
// fixed depth; the Morton trees are rebuilt on the device every frame, where
// reading a depth back would cost a sync). The price is that closest hits
// prune later than a front-to-back walk would.
//
// Structure (as pt_torch/accel/bvh8.py lays it out):
//   top_lo, top_hi (n_top, 3) f32  node bounds; subtrees that hold only
//                                  padding are the far point box 1e30,
//                                  which the slab test reads as a miss
//   top_miss       (n_top,)   i32  skip links
//   top_leaf       (n_top,)   i32  leaf id, or -1 for an internal node
//   pages          (L, 8, cols) f32  Woop pages, see rt_common.cuh
//
// Contract (pt's): accept tmin < t < tmax with u >= 0, v >= 0, u + v <= 1;
// on an exact t tie the smallest id (ALPHA_TRI_BIT stripped) wins and u/v
// come from that triangle; a miss gives t = tmax, tri = -1, u = v = 0.
// Occlusion is true at the first accepted triangle, alpha-tagged or not.
// Padded page columns (id -1) never hit.
//
// Bound: dependent global loads (each step waits on the node it loads), not
// FLOPs. v4_kernels.cu runs closest()/occluded() one thread per ray (the
// first design, and the counted variant); v4_warp_kernels.cu walks the same
// way per lane but tests each leaf with the warp.
#pragma once

#include "rt_common.cuh"

namespace v4 {

using rt::Ray;

struct Tree {
    const float* top_lo;
    const float* top_hi;
    const int32_t* top_miss;
    const int32_t* top_leaf;
    const float* pages;
    int n_top;
    int block;       // triangles per leaf page
    int page_cols;   // padded page width (>= 7 * block)
};

// Work done by a counted traversal, for bounds worked out from this run's
// data: node visits (one slab test each) and triangle (Woop) tests of this
// ray, and the structure it touched, shared by all rays: node_seen[node] and
// tri_seen[leaf * block + j] are set to 1 where a node was visited or a page
// column tested.
struct Counts {
    unsigned long long nodes;
    unsigned long long tris;
    uint8_t* node_seen;   // (n_top,)
    uint8_t* tri_seen;    // (L * block,)
};

template <bool kCount>
RT_HD void count_node(Counts* c, int32_t node) {
    if constexpr (kCount) {
        ++c->nodes;
        c->node_seen[node] = 1;
    }
}

template <bool kCount>
RT_HD void count_tri(Counts* c, const Tree& tree, int32_t lid, int j) {
    if constexpr (kCount) {
        ++c->tris;
        c->tri_seen[(size_t)lid * tree.block + j] = 1;
    }
}

// Closest hit of one ray. With kCount, `counts` (then never null)
// accumulates the work of this traversal; without it, `counts` is not read
// and no counting code is built.
template <bool kCount>
RT_HD void closest(const Tree& tree, const Ray& r, float tmin, float tmax,
                   float* t_out, int32_t* tri_out, float* u_out,
                   float* v_out, Counts* counts) {
    float best_t = tmax;
    int32_t best_tri = -1;
    float best_u = 0.0f, best_v = 0.0f;
    int32_t i = 0;
    while (i >= 0 && i < tree.n_top) {
        count_node<kCount>(counts, i);
        float tn;
        if (!rt::slab(tree.top_lo + 3 * i, tree.top_hi + 3 * i, r, best_t,
                      &tn)) {
            i = tree.top_miss[i];
            continue;
        }
        int32_t lid = tree.top_leaf[i];
        if (lid < 0) {
            ++i;
            continue;
        }
        const float* page = tree.pages
            + (size_t)lid * 8 * (size_t)tree.page_cols;
        const float* ids = page + 6 * tree.block;
        for (int j = 0; j < tree.block; ++j) {
            int32_t id = rt::float_bits(ids[j]);
            if (id < 0) continue;
            count_tri<kCount>(counts, tree, lid, j);
            float u, v;
            float t = rt::woop(page, tree.page_cols, tree.block, j, r, &u, &v);
            if (!rt::accept(t, u, v, tmin, tmax)) continue;
            int32_t idc = id & ~rt::kAlphaTriBit;
            if (t < best_t || (t == best_t && best_tri >= 0
                               && idc < best_tri)) {
                best_t = t;
                best_tri = idc;
                best_u = u;
                best_v = v;
            }
        }
        i = tree.top_miss[i];
    }
    *t_out = best_t;
    *tri_out = best_tri;
    *u_out = best_u;
    *v_out = best_v;
}

// Any hit with tmin < t < dist. kCount and `counts` as for closest().
template <bool kCount>
RT_HD bool occluded(const Tree& tree, const Ray& r, float tmin, float dist,
                    Counts* counts) {
    int32_t i = 0;
    while (i >= 0 && i < tree.n_top) {
        count_node<kCount>(counts, i);
        float tn;
        if (!rt::slab(tree.top_lo + 3 * i, tree.top_hi + 3 * i, r, dist,
                      &tn)) {
            i = tree.top_miss[i];
            continue;
        }
        int32_t lid = tree.top_leaf[i];
        if (lid < 0) {
            ++i;
            continue;
        }
        const float* page = tree.pages
            + (size_t)lid * 8 * (size_t)tree.page_cols;
        const float* ids = page + 6 * tree.block;
        for (int j = 0; j < tree.block; ++j) {
            if (rt::float_bits(ids[j]) < 0) continue;
            count_tri<kCount>(counts, tree, lid, j);
            float u, v;
            float t = rt::woop(page, tree.page_cols, tree.block, j, r, &u, &v);
            if (rt::accept(t, u, v, tmin, dist)) return true;
        }
        i = tree.top_miss[i];
    }
    return false;
}

}  // namespace v4
