// Per-ray traversal of a BF8 (branching-factor-8) BVH with Woop-page leaves.
//
// Replaces the Pallas kernels pt/accel/pallas_bvh.py:packet_closest_bf8 and
// :packet_occluded_bf8 by what they compute, not by how they schedule on the
// TPU: one ray per call, a 128-deep stack of int32 entries, 8 slab tests per
// wide node and a full-f32 Woop leaf test. The functions are
// __host__ __device__ so that the same code builds into the CUDA kernels
// (bf8_kernels.cu) and, with g++, into a host library the CPU tests run.
//
// Structure (as pt_torch/accel/bvh8.py lays it out):
//   c_lo, c_hi  (n8*8, 3) f32  child bounds; empty slots are 1e30 points
//   c_ent       (n8*8,)   i32  child entry: node index, LEAF_BIT|leaf id,
//                              or -1 for an empty slot
//   l_lo, l_hi  (L, 3)    f32  leaf bounds (retested when a leaf pops)
//   pages       (L, 8, cols) f32  Woop page per leaf of `block` triangles:
//       rows 0-3 of column group k (k = 0..2): W_k (3 values) and b_k,
//       so o'_k = W_k . o + b_k;
//       rows 4-6 of column group 3+k: W_k again, so d'_k = W_k . d;
//       row 0 of column group 6: the triangle id's int32 bits (-1 = padding,
//       ALPHA_TRI_BIT marks a non-opaque triangle).
//
// Contract (pt's, ROADMAP §2): accept tmin < t < tmax with u >= 0, v >= 0,
// u + v <= 1; on an exact t tie the smallest id (ALPHA_TRI_BIT stripped)
// wins and u/v come from that triangle; a miss gives t = tmax, tri = -1,
// u = v = 0.
//
// The arithmetic is plain f32 in a fixed order. Built with -fmad=false
// (nvcc) or -ffp-contract=off (g++) it rounds exactly like the plain
// PyTorch version in pt_torch/accel/kernels.py.
//
// Bound: the traversal is bound by dependent global loads of node and page
// rows (each pop waits on the loads of the node it popped), not by FLOPs.
// The per-ray kernels (bf8_kernels.cu) test each leaf on one lane;
// bf8_warp_kernels.cu runs the same walk per lane and tests each pending
// leaf with the whole warp.
#pragma once

#include "rt_common.cuh"

#define BF8_HD RT_HD

namespace bf8 {

using rt::Ray;
using rt::accept;
using rt::float_bits;
using rt::kAlphaTriBit;
using rt::make_ray;
using rt::slab;
using rt::woop;

constexpr int32_t kLeafBit = 1 << 24;
constexpr int kStackDepth = 128;

struct Tree {
    const float* c_lo;
    const float* c_hi;
    const int32_t* c_ent;
    const float* l_lo;
    const float* l_hi;
    const float* pages;
    int block;       // triangles per leaf page
    int page_cols;   // padded page width (>= 7 * block)
};

// Work done by a counted traversal, for bounds worked out from this run's
// data: wide-node visits (8 child slab tests each), leaf-box retests and
// triangle (Woop) tests of this ray, and the structure it touched, shared
// by all rays: node_seen[node] and tri_seen[leaf * block + j] are set to 1
// where a wide node was visited or a page column tested.
struct Counts {
    unsigned long long nodes;
    unsigned long long leaf_boxes;
    unsigned long long tris;
    uint8_t* node_seen;   // (n8,)
    uint8_t* tri_seen;    // (L * block,)
};

template <bool kCount>
BF8_HD void count_node(Counts* c, int32_t node) {
    if constexpr (kCount) {
        ++c->nodes;
        c->node_seen[node] = 1;
    }
}

template <bool kCount>
BF8_HD void count_tri(Counts* c, const Tree& tree, int32_t lid, int j) {
    if constexpr (kCount) {
        ++c->tris;
        c->tri_seen[(size_t)lid * tree.block + j] = 1;
    }
}

// Push the children of wide node `ent` whose boxes the ray hits before
// `t_limit`, far-first (an insertion sort on max(tnear, 0), equal keys in
// child order), so that the nearest pops first. bf8i's walks and the warp
// kernels' walks (bf8_warp_kernels.cu, bf8i_warp_kernels.cu) push through
// it; closest() below writes the same loop out.
BF8_HD void push_near_first(const Tree& tree, int32_t ent, const Ray& r,
                            float t_limit, int32_t* stack, int* sp) {
    float keys[8];
    int32_t ents[8];
    int cnt = 0;
    for (int c = 0; c < 8; ++c) {
        int k = ent * 8 + c;
        int32_t e = tree.c_ent[k];
        if (e == -1) continue;
        float tn;
        if (!slab(tree.c_lo + 3 * k, tree.c_hi + 3 * k, r, t_limit, &tn))
            continue;
        float key = fmaxf(tn, 0.0f);
        int p = cnt++;
        while (p > 0 && keys[p - 1] > key) {
            keys[p] = keys[p - 1];
            ents[p] = ents[p - 1];
            --p;
        }
        keys[p] = key;
        ents[p] = e;
    }
    for (int q = cnt - 1; q >= 0; --q) stack[(*sp)++] = ents[q];
}

// Closest hit of one ray. Children that pass the slab test are pushed
// far-first (insertion sort on max(tnear, 0)), so the nearest pops first.
// With kCount, `counts` (then never null) accumulates the work of this
// traversal; without it, `counts` is not read and no counting code is built.
// With kPops, `pops` (then never null) receives the iterations of the walk
// loop: one per pop, of a wide node or of a leaf. Each pop is a node visit
// or a leaf-box retest, so the pops of a launch's lanes sum to its
// Counts.nodes + Counts.leaf_boxes. Without kPops `pops` is not read and no
// counting code is built.
template <bool kCount, bool kPops = false>
BF8_HD void closest(const Tree& tree, const Ray& r, float tmin, float tmax,
                    float* t_out, int32_t* tri_out, float* u_out,
                    float* v_out, Counts* counts, int32_t* pops = nullptr) {
    int32_t stack[kStackDepth];
    int sp = 0;
    stack[sp++] = 0;
    float best_t = tmax;
    int32_t best_tri = -1;
    float best_u = 0.0f, best_v = 0.0f;
    [[maybe_unused]] int32_t n_pops = 0;
    while (sp > 0) {
        int32_t ent = stack[--sp];
        if constexpr (kPops) ++n_pops;
        if (ent >= kLeafBit) {
            int32_t lid = ent - kLeafBit;
            float tn;
            if constexpr (kCount) ++counts->leaf_boxes;
            if (!slab(tree.l_lo + 3 * lid, tree.l_hi + 3 * lid, r, best_t,
                      &tn))
                continue;
            const float* page = tree.pages
                + (size_t)lid * 8 * (size_t)tree.page_cols;
            const float* ids = page + 6 * tree.block;
            for (int j = 0; j < tree.block; ++j) {
                int32_t id = float_bits(ids[j]);
                if (id < 0) continue;
                count_tri<kCount>(counts, tree, lid, j);
                float u, v;
                float t = woop(page, tree.page_cols, tree.block, j, r, &u, &v);
                if (!accept(t, u, v, tmin, tmax)) continue;
                int32_t idc = id & ~kAlphaTriBit;
                if (t < best_t || (t == best_t && best_tri >= 0
                                   && idc < best_tri)) {
                    best_t = t;
                    best_tri = idc;
                    best_u = u;
                    best_v = v;
                }
            }
        } else {
            // push_near_first's loop, written out: through the helper this
            // kernel compiled to other machine code and ran 5-13% slower
            // (pt_torch/benches/k1_per_ray.py on an H100)
            count_node<kCount>(counts, ent);
            float keys[8];
            int32_t ents[8];
            int cnt = 0;
            for (int c = 0; c < 8; ++c) {
                int k = ent * 8 + c;
                int32_t e = tree.c_ent[k];
                if (e == -1) continue;
                float tn;
                if (!slab(tree.c_lo + 3 * k, tree.c_hi + 3 * k, r, best_t, &tn))
                    continue;
                float key = fmaxf(tn, 0.0f);
                int p = cnt++;
                while (p > 0 && keys[p - 1] > key) {
                    keys[p] = keys[p - 1];
                    ents[p] = ents[p - 1];
                    --p;
                }
                keys[p] = key;
                ents[p] = e;
            }
            for (int q = cnt - 1; q >= 0; --q) stack[sp++] = ents[q];
        }
    }
    *t_out = best_t;
    *tri_out = best_tri;
    *u_out = best_u;
    *v_out = best_v;
    if constexpr (kPops) *pops = n_pops;
}

// Any hit with tmin < t < dist. Children push unsorted; with opaque_only,
// triangles tagged ALPHA_TRI_BIT are ignored. kCount and `counts` as for
// closest().
template <bool kCount>
BF8_HD bool occluded(const Tree& tree, const Ray& r, float tmin, float dist,
                     bool opaque_only, Counts* counts) {
    int32_t stack[kStackDepth];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
        int32_t ent = stack[--sp];
        if (ent >= kLeafBit) {
            int32_t lid = ent - kLeafBit;
            const float* page = tree.pages
                + (size_t)lid * 8 * (size_t)tree.page_cols;
            const float* ids = page + 6 * tree.block;
            for (int j = 0; j < tree.block; ++j) {
                int32_t id = float_bits(ids[j]);
                if (id < 0) continue;
                if (opaque_only && (id & kAlphaTriBit)) continue;
                count_tri<kCount>(counts, tree, lid, j);
                float u, v;
                float t = woop(page, tree.page_cols, tree.block, j, r, &u, &v);
                if (accept(t, u, v, tmin, dist)) return true;
            }
        } else {
            count_node<kCount>(counts, ent);
            for (int c = 0; c < 8; ++c) {
                int k = ent * 8 + c;
                int32_t e = tree.c_ent[k];
                if (e == -1) continue;
                float tn;
                if (slab(tree.c_lo + 3 * k, tree.c_hi + 3 * k, r, dist, &tn))
                    stack[sp++] = e;
            }
        }
    }
    return false;
}

}  // namespace bf8
