// The Woop tests of one leaf page, shared by the archive walks
// (ordered_traverse.cuh over a PacketBVH, v6_traverse.cuh over a BF8V6):
// the closest-hit form, which keeps the best hit under the tie rule, and the
// any-hit form. `Tree` is either walk's structure (fields pages, block,
// page_cols) and `Counts` either walk's work counters (fields tris and
// tri_seen); page layout and arithmetic as rt_common.cuh.
#pragma once

#include "rt_common.cuh"

namespace leaf {

struct Best {
    float t;
    int32_t tri;
    float u, v;
};

template <bool kCount, class Tree, class Counts>
RT_HD void count_tri(Counts* c, const Tree& tree, int32_t lid, int j) {
    if constexpr (kCount) {
        ++c->tris;
        c->tri_seen[(size_t)lid * tree.block + j] = 1;
    }
}

template <class Tree>
RT_HD const float* page_of(const Tree& tree, int32_t lid) {
    return tree.pages + (size_t)lid * 8 * (size_t)tree.page_cols;
}

// Woop tests of leaf `lid`'s page: accept tmin < t < tmax; on an exact t tie
// the smallest id (ALPHA_TRI_BIT stripped) wins and u/v come from it.
template <bool kCount, class Tree, class Counts>
RT_HD void closest(const Tree& tree, int32_t lid, const rt::Ray& r,
                   float tmin, float tmax, Best* best, Counts* counts) {
    const float* page = page_of(tree, lid);
    const float* ids = page + 6 * tree.block;
    for (int j = 0; j < tree.block; ++j) {
        int32_t id = rt::float_bits(ids[j]);
        if (id < 0) continue;
        count_tri<kCount>(counts, tree, lid, j);
        float u, v;
        float t = rt::woop(page, tree.page_cols, tree.block, j, r, &u, &v);
        if (!rt::accept(t, u, v, tmin, tmax)) continue;
        int32_t idc = id & ~rt::kAlphaTriBit;
        if (t < best->t || (t == best->t && best->tri >= 0
                            && idc < best->tri)) {
            best->t = t;
            best->tri = idc;
            best->u = u;
            best->v = v;
        }
    }
}

// True at the first triangle of leaf `lid`'s page with tmin < t < dist,
// alpha-tagged or not.
template <bool kCount, class Tree, class Counts>
RT_HD bool any(const Tree& tree, int32_t lid, const rt::Ray& r, float tmin,
               float dist, Counts* counts) {
    const float* page = page_of(tree, lid);
    const float* ids = page + 6 * tree.block;
    for (int j = 0; j < tree.block; ++j) {
        if (rt::float_bits(ids[j]) < 0) continue;
        count_tri<kCount>(counts, tree, lid, j);
        float u, v;
        float t = rt::woop(page, tree.page_cols, tree.block, j, r, &u, &v);
        if (rt::accept(t, u, v, tmin, dist)) return true;
    }
    return false;
}

}  // namespace leaf
