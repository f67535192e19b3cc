"""Plain reference: a frozen copy of pt_torch/accel/intersect.py,
which the port may change without moving the yardstick.

Batched ray-triangle intersection (Möller–Trumbore), brute-force oracle.

Port of `pt.accel.intersect`: every ray against every triangle in f32,
two-sided, tiled into ray chunks. It is the correctness oracle the
traversal kernels are held against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_RAY_TRI_BUDGET = 1 << 24   # max rays*tris elements materialized per chunk


class Hit(NamedTuple):
    """Closest-hit record: distance, triangle id, barycentrics."""
    t: torch.Tensor        # (N,) hit distance; tmax on a miss
    tri: torch.Tensor      # (N,) i32 triangle index; -1 on miss
    u: torch.Tensor        # (N,) barycentric u (weight of vertex 1)
    v: torch.Tensor        # (N,) barycentric v (weight of vertex 2)

    @property
    def is_hit(self) -> torch.Tensor:
        return self.tri >= 0


def _mt_chunk(o, d, v0, e1, e2, tmin, tmax):
    """Möller–Trumbore for a (C rays) x (T tris) block."""
    o = o[:, None, :]
    d = d[:, None, :]
    d_b, e2_b = torch.broadcast_tensors(d, e2[None])
    pvec = torch.linalg.cross(d_b, e2_b, dim=-1)
    det = torch.sum(e1[None] * pvec, dim=-1)                     # (C, T)
    ok_det = torch.abs(det) > 1e-12
    inv_det = torch.where(torch.abs(det) < 1e-12, torch.zeros_like(det),
                          1.0 / torch.where(det == 0, torch.ones_like(det), det))
    tvec = o - v0[None]
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    e1_b = e1[None].expand_as(tvec)
    qvec = torch.linalg.cross(tvec, e1_b, dim=-1)
    v = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2[None] * qvec, dim=-1) * inv_det
    ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > tmin) & (t < tmax[:, None]))
    t = torch.where(ok, t, torch.full_like(t, float("inf")))
    best_t, best = torch.min(t, dim=-1)   # first occurrence on ties
    rows = torch.arange(t.shape[0], device=t.device)
    hit = torch.isfinite(best_t)
    zero = torch.zeros_like(best_t)
    return (torch.where(hit, best_t, tmax),
            torch.where(hit, best.to(torch.int32),
                        torch.full_like(best, -1, dtype=torch.int32)),
            torch.where(hit, u[rows, best], zero),
            torch.where(hit, v[rows, best], zero))


def intersect_brute(positions: torch.Tensor, tri_idx: torch.Tensor,
                    origins: torch.Tensor, dirs: torch.Tensor,
                    tmin: float = 1e-5, tmax=1e4) -> Hit:
    """Closest hit of each ray against all triangles.

    positions: (V, 3); tri_idx: (T, 3); origins/dirs: (N, 3).
    tmax may be a scalar or (N,).
    """
    idx = tri_idx.long()
    v0 = positions[idx[:, 0]]
    e1 = positions[idx[:, 1]] - v0
    e2 = positions[idx[:, 2]] - v0
    n = origins.shape[0]
    tmax = torch.as_tensor(tmax, dtype=torch.float32,
                           device=origins.device).expand(n)
    chunk = max(1, min(n, _RAY_TRI_BUDGET // max(tri_idx.shape[0], 1)))
    parts = [_mt_chunk(origins[s:s + chunk], dirs[s:s + chunk], v0, e1, e2,
                       tmin, tmax[s:s + chunk])
             for s in range(0, n, chunk)]
    return Hit(*(torch.cat(p) for p in zip(*parts)))
