"""The archived traversal generations of `pt.accel.pallas_bvh_archive`.

`pt` keeps ten superseded kernel generations as its measured A/B record:
the entry points below, with `pt`'s names and signatures, and the `BF8V6`
structure (`build_bf8_v6`). `pt`'s A/B harnesses select them by name
(`pt_torch.benches.bvh_kernels`, `pt_torch.benches.widesub_ab`), and the
integrator routes a `BF8V6` through its `closest` / `occluded` methods, as
`pt`'s duck dispatch does.

`pt`'s generations differ in two ways: in what a ray visits, and in how
1024-ray packets are scheduled on the TPU (sub-packets, full-vreg cubes,
wide walkers). A per-thread walk on Hopper has no packet to schedule, so the
port has one kernel per distinct walk (`pt_torch.accel.kernels`):

  packet_closest_v3, packet_closest, packet_closest_sub -> closest_ordered
  packet_closest_v6                                     -> closest_v6
  packet_closest_v6k2                                   -> closest_v6k2
  packet_closest_v7                                     -> closest_v7
  packet_occluded_v6                                    -> occluded_v6
  packet_closest_bf8w                                   -> closest_bf8 (K1)
  packet_occluded, packet_occluded_sub                  -> occluded_v4 (K4)

`packet_closest_bf8w` walks K1's tree with wider walkers ("r_sub=1 ==
packet_closest_bf8"), and `packet_occluded` / `packet_occluded_sub` walk the
threaded preorder with a cursor, as K4 does. `r_sub` picks a packet schedule
in `pt`; it is checked as `pt` takes it and changes no result here.
`window` is v7's: how many pops run between two drains of the leaf queue,
which changes what a ray visits. On the CPU every entry point runs its
kernel's plain version. Each one adds one to `calls[name]` per call and,
to `launches[name]`, the launches of its kernel that the call made (read
from `kernels.launches`, so 0 on the CPU), so that a run can show which
entry point ran which kernel.

This module imports neither JAX nor `pt`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pt_torch.accel import kernels
from pt_torch.accel.bvh8 import (BF8BVH, PacketBVH, TRIS_PER_BLOCK,
                                 build_bf8, build_packet_bvh_sah)
from pt_torch.accel.intersect import Hit

ENTRY_POINTS = ("packet_closest_v3", "packet_closest_bf8w",
                "packet_closest_v6", "packet_closest_v6k2",
                "packet_closest_v7", "packet_occluded_v6", "packet_closest",
                "packet_occluded", "packet_occluded_sub",
                "packet_closest_sub")
# the port's kernel behind each entry point
KERNEL_OF = {"packet_closest_v3": "closest_ordered",
             "packet_closest_bf8w": "closest_bf8",
             "packet_closest_v6": "closest_v6",
             "packet_closest_v6k2": "closest_v6k2",
             "packet_closest_v7": "closest_v7",
             "packet_occluded_v6": "occluded_v6",
             "packet_closest": "closest_ordered",
             "packet_occluded": "occluded_v4",
             "packet_occluded_sub": "occluded_v4",
             "packet_closest_sub": "closest_ordered"}
# calls per entry point, and the kernel launches those calls made
calls = {name: 0 for name in ENTRY_POINTS}
launches = {name: 0 for name in ENTRY_POINTS}


def reset_call_counts() -> None:
    for k in calls:
        calls[k] = 0
        launches[k] = 0


def _run(entry: str, *args, **kw):
    """Call entry point `entry`'s kernel wrapper, counting the call and
    the launches it made."""
    kernel = KERNEL_OF[entry]
    calls[entry] += 1
    before = kernels.launches[kernel]
    out = getattr(kernels, kernel)(*args, **kw)
    launches[entry] += kernels.launches[kernel] - before
    return out


@dataclasses.dataclass
class BF8V6:
    """The BF8 collapse with (a) child and leaf bounds in one table (leaf
    rows after the n8*8 child rows: a leaf's pop retest reads row n8*8 +
    leaf) and (b) a push order per (node, octant), farthest first along the
    octant's diagonal, in place of the per-visit sort of the children by
    tnear (the CWBVH static-order trick). `c_order[node*8 + octant]` packs
    eight 3-bit child slots, slot j in bits 3j..3j+2, pushed in that order;
    octant bit 4 means x < 0, bit 2 y < 0, bit 1 z < 0."""
    u_lo: torch.Tensor         # (n8*8 + n_leaves, 3) f32 (1e30 = empty)
    u_hi: torch.Tensor         # (n8*8 + n_leaves, 3) f32
    c_ent: torch.Tensor        # (n8*8,) i32 child entry (-1 empty)
    c_order: torch.Tensor      # (n8*8,) i32 packed push order per octant
    pages: torch.Tensor        # the BF8 tree's pages, shared, not copied
    n8: int = 0
    n_leaves: int = 0
    block: int = TRIS_PER_BLOCK
    root_lo: Optional[torch.Tensor] = None     # (3,) f32 scene root AABB
    root_hi: Optional[torch.Tensor] = None
    # wide-node levels D8, as BF8BVH.depth; one pop per iteration never
    # holds more than 7*D8 + 1 stack entries
    depth: int = 0

    @property
    def device(self) -> torch.device:
        return self.pages.device

    @property
    def stack_bound(self) -> int:
        return 7 * self.depth + 1

    # the integrator routes any structure that carries these methods
    # (trace_closest / trace_occluded), as pt's does
    def closest(self, origins, dirs, tmax, tmin):
        return packet_closest_v6(self, origins, dirs, tmax, tmin)

    def occluded(self, origins, dirs, dist, tmin):
        return packet_occluded_v6(self, origins, dirs, dist, tmin)

    def root_bounds(self):
        if self.root_lo is not None:
            return self.root_lo, self.root_hi
        valid = self.u_lo[:, 0] < 1e29
        inf = float("inf")
        return (torch.where(valid[:, None], self.u_lo, inf).amin(dim=0),
                torch.where(valid[:, None], self.u_hi, -inf).amax(dim=0))


def build_bf8_v6(pbvh: PacketBVH) -> Optional[BF8V6]:
    """Derive the v6 structure from a PacketBVH (through the BF8 collapse).
    Returns None where `build_bf8` does, or where the unified table would be
    over pt's SMEM budget of 640 KiB (kept for parity)."""
    b8 = build_bf8(pbvh)
    return None if b8 is None else bf8_v6_of(b8)


def bf8_v6_of(b8: BF8BVH) -> Optional[BF8V6]:
    """The v6 structure of a BF8 tree, sharing its pages and child entries;
    None where the unified table would be over pt's SMEM budget of 640
    KiB."""
    c_lo = b8.c_lo.cpu().numpy()
    c_hi = b8.c_hi.cpu().numpy()
    l_lo = b8.l_lo.cpu().numpy()
    l_hi = b8.l_hi.cpu().numpy()
    n8, n_leaves = b8.n8, b8.n_leaves
    rows = n8 * 8 + n_leaves
    kb = (rows * 6 + n8 * 8 * 2) * 4 / 1024
    if kb > 640:
        return None

    centers = (c_lo + c_hi) * 0.5                    # (n8*8, 3)
    orders = np.zeros((n8 * 8,), np.int32)
    for o in range(8):
        d = np.asarray([-1.0 if o & 4 else 1.0,
                        -1.0 if o & 2 else 1.0,
                        -1.0 if o & 1 else 1.0])
        key = (centers @ d).reshape(n8, 8)
        # farthest-first push order so that the nearest pops first
        perm = np.argsort(-key, axis=1, kind="stable")   # (n8, 8)
        packed = np.zeros(n8, np.int64)
        for j in range(8):
            packed |= perm[:, j].astype(np.int64) << (3 * j)
        orders[np.arange(n8) * 8 + o] = packed.astype(np.int32)
    dev = b8.device
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    return BF8V6(u_lo=t(np.concatenate([c_lo, l_lo], axis=0)),
                 u_hi=t(np.concatenate([c_hi, l_hi], axis=0)),
                 c_ent=b8.c_ent, c_order=t(orders), pages=b8.pages, n8=n8,
                 n_leaves=n_leaves, block=b8.block, root_lo=b8.root_lo,
                 root_hi=b8.root_hi, depth=b8.depth)


def _limit(origins: torch.Tensor, limit) -> torch.Tensor:
    """tmax or dist as pt takes it, a scalar or an (N,) array, as the
    contiguous (N,) f32 tensor the kernels take."""
    if isinstance(limit, torch.Tensor):
        limit = limit.to(torch.float32)
    else:
        limit = torch.tensor(float(limit), device=origins.device)
    if limit.dim() == 0:
        limit = limit.expand(origins.shape[0])
    return limit.contiguous()


# ------------------------------------------------ closest over a PacketBVH


def packet_closest_v3(pbvh: PacketBVH, origins, dirs, tmax,
                      tmin=1e-5) -> Hit:
    """pt's full-vreg sub-packet closest hit (v3): the ordered walk."""
    return _run("packet_closest_v3", pbvh, origins, dirs,
                _limit(origins, tmax), tmin)


def packet_closest(pbvh: PacketBVH, origins, dirs, tmax, tmin=1e-5) -> Hit:
    """pt's monolithic-packet ordered closest hit (v1): the ordered walk."""
    return _run("packet_closest", pbvh, origins, dirs, _limit(origins, tmax),
                tmin)


def packet_closest_sub(pbvh: PacketBVH, origins, dirs, tmax,
                       tmin=1e-5) -> Hit:
    """pt's 8x128-lane sub-packet closest hit (v2): the ordered walk."""
    return _run("packet_closest_sub", pbvh, origins, dirs,
                _limit(origins, tmax), tmin)


# ----------------------------------------------- occlusion over a PacketBVH


def packet_occluded(pbvh: PacketBVH, origins, dirs, dist, tmin=1e-5):
    """pt's monolithic-packet occlusion: the threaded preorder walk (K4)."""
    return _run("packet_occluded", pbvh, origins, dirs, _limit(origins, dist),
                tmin)


def packet_occluded_sub(pbvh: PacketBVH, origins, dirs, dist, tmin=1e-5):
    """pt's 8x128-lane sub-packet occlusion: the threaded preorder walk
    (K4)."""
    return _run("packet_occluded_sub", pbvh, origins, dirs,
                _limit(origins, dist), tmin)


# ------------------------------------------------------ over a BF8BVH/BF8V6


def packet_closest_bf8w(bvh8: BF8BVH, origins, dirs, tmax, tmin=1e-5,
                        r_sub: int = 8) -> Hit:
    """pt's wide-walker BF8 closest hit: K1's walk. `r_sub` (1024-ray
    groups per walker in pt, >= 1) changes no result."""
    if int(r_sub) < 1:
        raise ValueError(f"r_sub must be >= 1, got {r_sub}")
    return _run("packet_closest_bf8w", bvh8, origins, dirs,
                _limit(origins, tmax), tmin)


def packet_closest_v6(bvh6: BF8V6, origins, dirs, tmax, tmin=1e-5) -> Hit:
    """pt's v6 closest hit: static octant-ordered pushes."""
    return _run("packet_closest_v6", bvh6, origins, dirs,
                _limit(origins, tmax), tmin)


def packet_closest_v6k2(bvh6: BF8V6, origins, dirs, tmax, tmin=1e-5) -> Hit:
    """pt's v6 with two pops per round."""
    return _run("packet_closest_v6k2", bvh6, origins, dirs,
                _limit(origins, tmax), tmin)


def packet_closest_v7(bvh6: BF8V6, origins, dirs, tmax, tmin=1e-5,
                      window: int = 8) -> Hit:
    """pt's v7 closest hit: v6's order, with the leaves whose boxes pass
    queued for `window` pops (>= 1) and tested together, the boxes pruned
    against the best t of the last drain."""
    return _run("packet_closest_v7", bvh6, origins, dirs,
                _limit(origins, tmax), tmin, window=window)


def packet_occluded_v6(bvh6: BF8V6, origins, dirs, dist, tmin=1e-5):
    """pt's v6 occlusion: unordered pushes, every triangle occludes."""
    return _run("packet_occluded_v6", bvh6, origins, dirs,
                _limit(origins, dist), tmin)


# ------------------------------------------------- a renderer over a BF8V6


def swap_in_bf8_v6(renderer):
    """Swap the built tree of the static, opaque `renderer` for a BF8V6, as
    pt's A/B work does (pt's Renderer has no option for it): the fine tree
    from the renderer's own SBVH arguments (block 32, 8192 leaves, spatial
    splits) on the accel's world positions, then `build_bf8_v6`. Every
    closest and shadow trace of the renderer then goes through
    `packet_closest_v6` / `packet_occluded_v6`, until its accel is rebuilt.
    Returns (the BF8V6, the fine PacketBVH); raises where no BF8V6 fits."""
    r = renderer
    r._ensure_accel()
    fine = build_packet_bvh_sah(r.accel.wpos.cpu().numpy(),
                                r.ds.tri_idx.cpu().numpy(), block=32,
                                max_leaves=8192,
                                tri_opaque_np=r.ds.tri_opaque.cpu().numpy(),
                                spatial=True, device=r.device)
    v6 = build_bf8_v6(fine)
    if v6 is None:
        raise ValueError("no BF8V6 fits this scene: the BF8 collapse failed "
                         "or the unified table is over 640 KiB")
    r.accel = r.accel._replace(bvh=v6)
    return v6, fine
