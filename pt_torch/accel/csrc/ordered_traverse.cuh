// Per-ray ordered (near-child-first) stack walk of a binary PacketBVH with
// Woop-page leaves.
//
// Replaces the Pallas kernels of pt/accel/pallas_bvh_archive.py that walk a
// PacketBVH near-child first: packet_closest (_make_closest_kernel_ordered,
// one 1024-ray packet), packet_closest_sub (_make_closest_kernel_subpacket,
// 8 sub-packets of 128 lanes) and packet_closest_v3 (_make_closest_kernel_v3,
// n_sub sub-packets of 1024 rays in full vregs). The three differ only in how
// they schedule packets on the TPU; what a ray visits is the same walk, and
// here one thread walks it for its own ray:
//   pop a node and retest its box against the current best t (a far child
//   pushed earlier is culled once a nearer hit has tightened t); a leaf that
//   passes tests its page; an internal node that passes slab-tests its two
//   children, left = node + 1 and right = top_miss[left] (the preorder
//   layout), and pushes the far one first, so that the near one pops first.
// "Near" is this ray's own tnear comparison, left winning ties; pt takes a
// majority vote of the packet's lanes, which only changes the visit order.
//
// Structure and page layout: as v4_traverse.cuh (top_lo, top_hi, top_miss,
// top_leaf, pages; padding subtrees are 1e30 point boxes, which every ray
// misses). The walk pops one entry and pushes at most two, so the stack never
// holds more entries than the tree has levels; the wrapper checks that
// against kStackDepth (pt's tightest per-walker stack: 512 entries for 8
// sub-packets) before a launch.
//
// Contract (pt's, ROADMAP §2): accept tmin < t < tmax with u >= 0, v >= 0,
// u + v <= 1; on an exact t tie the smallest id (ALPHA_TRI_BIT stripped)
// wins and u/v come from that triangle; a miss gives t = tmax, tri = -1,
// u = v = 0. A tie between two leaves can still resolve otherwise than the
// plain version does when the pop retest (tnear < best_t) culls the second
// leaf before its smaller id is seen.
//
// Bound: dependent global loads of node rows and pages, as K3; the ordered
// walk is there to cut the number of triangle tests that K3's stackless walk
// makes (it prunes only against the t found so far, in preorder).
#pragma once

#include "page_leaf.cuh"
#include "v4_traverse.cuh"

namespace ordered {

using rt::Ray;
using v4::Counts;      // nodes: box tests, one per node tested (see below);
using v4::Tree;        // tris: Woop tests
using v4::count_node;

constexpr int kStackDepth = 64;

// Closest hit of one ray. With kCount, `counts` (then never null)
// accumulates the work of this walk; without it, `counts` is not read and no
// counting code is built. `nodes` counts each box test the walk needs once:
// the root's, and the two children's of each internal node whose box
// passed; the pop retest of a box already tested as a child is not counted.
template <bool kCount>
RT_HD void closest(const Tree& tree, const Ray& r, float tmin, float tmax,
                   float* t_out, int32_t* tri_out, float* u_out,
                   float* v_out, Counts* counts) {
    int32_t stack[kStackDepth];
    int sp = 0;
    stack[sp++] = 0;
    count_node<kCount>(counts, 0);
    leaf::Best best = {tmax, -1, 0.0f, 0.0f};
    while (sp > 0) {
        int32_t node = stack[--sp];
        float tn;
        if (!rt::slab(tree.top_lo + 3 * node, tree.top_hi + 3 * node, r,
                      best.t, &tn))
            continue;
        int32_t lid = tree.top_leaf[node];
        if (lid >= 0) {
            leaf::closest<kCount>(tree, lid, r, tmin, tmax, &best, counts);
            continue;
        }
        int32_t left = node + 1;
        int32_t right = tree.top_miss[left];
        count_node<kCount>(counts, left);
        count_node<kCount>(counts, right);
        float tn_l, tn_r;
        bool hit_l = rt::slab(tree.top_lo + 3 * left, tree.top_hi + 3 * left,
                              r, best.t, &tn_l);
        bool hit_r = rt::slab(tree.top_lo + 3 * right,
                              tree.top_hi + 3 * right, r, best.t, &tn_r);
        bool near_left = !(hit_l && hit_r) || tn_l <= tn_r;
        if (near_left ? hit_r : hit_l)
            stack[sp++] = near_left ? right : left;     // far first
        if (near_left ? hit_l : hit_r)
            stack[sp++] = near_left ? left : right;
    }
    *t_out = best.t;
    *tri_out = best.tri;
    *u_out = best.u;
    *v_out = best.v;
}

}  // namespace ordered
