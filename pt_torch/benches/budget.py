"""Frame budget: where does a bench frame go, stage by stage, on the card?

Port of `benches/budget.py`, `pt`'s measurement behind docs/perf_budget.md.
On the production bench frame (the Heightfield at n=224, 99,458 triangles,
512², 5 bounces, 1 spp; its binned-SAH tree at block 32 collapsed to BF8)
it prints, in five sections:

1. per bounce: the live lanes, the host ms (each call ended by a
   synchronize) of the closest trace, `_shade_hit`, the occlusion trace of
   the NEE rays and the coherence keys plus their argsort over the binary
   tree, and the lockstep rounds of a one-thread-per-ray schedule of K1's
   walks (`rounds_of`, from K1's pops launch `kernels.closest_bf8(...,
   pops=)`: the most pops of any lane of a block, per block) with the warp
   lockstep share (the lanes' mean pops over their warp's max). Each lane
   of the warp K1 pops what its per-ray walk pops, so these are the numbers
   of K1's first design, one thread per ray, and not the warp kernel's own
   leaf-group rounds (see `pt_torch.benches.drain_sim` for what a round is
   on this card);
2. leaf-visit waste on `n_sample` of bounce 1's rays, the live lanes first:
   the oracle's leaf visits per ray (leaves whose box the ray enters before
   its hit) against the union that a packet of 1024 lanes pays, unsorted
   and sorted by the coherence keys;
3. that union by sub size (32, the card's lockstep width, and `pt`'s 128
   to 1024) and sort key;
4. the shade stage in parts: attribute gathers, ray differentials to uv
   footprints, `sample_material`, BSDF sample and evaluation;
5. one full `bounce_once` against lane count (262,144 down to 4,096).

Two departures from `pt`, both where its bench measured something other
than it meant to. `pt` clamped the NEE distance to a box whose upper corner
was the largest child bound of the BF8 tree, which counts the 1e30 empty
slots, so its clamp never bound; the port clamps to the tree's root box, as
the integrator does. `pt` took the first `n_sample` lanes of bounce 1 for
section 2: at 512² those are the film's top 64 rows, which all miss at
bounce 0 (sky), so every ray it measured was a dead lane's leftover, which
the integrator never traces. The port takes the lanes alive at bounce 1
first, in lane order, and dead ones only to make up `n_sample`.

    python -m pt_torch.benches.budget [--device cpu] [--width W]
        [--bounces B] [--n N] [--n-sample S]

On the CPU every stage runs once and no time is taken (ms are None).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from pt_torch import default_device
from pt_torch.accel import kernels
from pt_torch.benches import bench_frame
from pt_torch.benches.drain_sim import WARP, done_rounds_of, lanes_of
from pt_torch.render.bsdf import evaluate_bsdf, sample_bsdf
from pt_torch.render.differentials import (compute_dp_dxy, compute_dpn_duv,
                                           compute_uv_derivatives)
from pt_torch.render.integrator import (BounceCarry, _aabb_exit_t,
                                        _coherence_keys, _shade_hit,
                                        bounce_once, trace_closest,
                                        trace_occluded)
from pt_torch.render.materials import sample_material
from pt_torch.render.rays import TMAX
from pt_torch.render.sampling import compute_tangent_space
from pt_torch.render.shading import _normalize, matvec
from pt_torch.scene.examples import make_heightfield_scene

UNION_SIZES = (32, 128, 256, 512, 1024)
UNION_KEYS = ("none", "octant|omorton", "omorton|octant", "omorton|dmorton",
              "coarse-o|dmorton")
LANE_COUNTS = (262144, 65536, 16384, 4096)


def timed(fn, *args, reps=5, warmup=2, label="", card=True, emit=print):
    """`pt`'s timer: mean host ms of `reps` calls after `warmup`, each call
    ended by a torch.cuda.synchronize(). Returns (ms, the last output). Off
    the card `fn` runs once and ms is None."""
    if not card:
        return None, fn(*args)
    for _ in range(warmup):
        fn(*args)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps * 1000
    if label:
        emit(f"  {label}: {dt:.2f} ms")
    return dt, out


def rounds_of(bvh8, origins, dirs, tmax=TMAX, pops=None):
    """The lockstep rounds per block of a one-thread-per-ray schedule of
    K1's walks (numpy int64 (B,)): the most pops of any lane in the block,
    from one pops launch of K1 (`closest_bf8(..., pops=)`). `pops`, an (N,)
    int32 tensor on the rays' device, also receives each lane's."""
    return done_rounds_of(bvh8, origins, dirs, tmax, pops)[0]


def _leaf_visit_counts(l_lo, l_hi, origins, dirs, t_final, chunk: int = 64):
    """Per-ray oracle leaf visits: leaves whose box the ray enters with
    tnear <= t_final (what a perfect per-ray ordered traversal intersects),
    and per-leaf ray-hit masks for union stats, (L, N) bool on the rays'
    device. Chunked over leaves."""
    inv = 1.0 / torch.where(torch.abs(dirs) < 1e-12, 1e-12, dirs)
    n = origins.shape[0]
    counts = torch.zeros(n, dtype=torch.int32, device=origins.device)
    hits = torch.empty((l_lo.shape[0], n), dtype=torch.bool,
                       device=origins.device)
    for s in range(0, l_lo.shape[0], chunk):
        t0 = (l_lo[s:s + chunk, None] - origins) * inv
        t1 = (l_hi[s:s + chunk, None] - origins) * inv
        tnear = torch.minimum(t0, t1).amax(dim=-1)
        tfar = torch.maximum(t0, t1).amin(dim=-1)
        hit = (tnear <= tfar) & (tfar > 0.0) & (tnear <= t_final)
        hits[s:s + chunk] = hit
        counts += hit.sum(dim=0, dtype=torch.int32)
    return counts, hits


def _morton(q, bits):
    out = np.zeros(q.shape[0], np.uint64)
    for b in range(bits):
        for a in range(3):
            out |= ((q[:, a].astype(np.uint64) >> b) & 1) << \
                np.uint64(3 * b + (2 - a))
    return out


def sort_key(name, o_np, d_np, lo, ext):
    """`pt`'s sort-key variants (numpy uint64, None for "none") of rays
    within the box (lo, lo + ext)."""
    qo = np.clip((o_np - lo) / ext * 512, 0, 511).astype(np.uint64)
    octant = ((d_np[:, 0] < 0).astype(np.uint64) * np.uint64(4)
              + (d_np[:, 1] < 0).astype(np.uint64) * np.uint64(2)
              + (d_np[:, 2] < 0).astype(np.uint64))
    dmorton = _morton(np.clip((d_np * 0.5 + 0.5) * 32, 0,
                              31).astype(np.uint64), 5)
    omorton = _morton(qo, 9)
    if name == "none":
        return None
    if name == "octant|omorton":           # pt's production key
        return (octant << np.uint64(27)) | omorton
    if name == "omorton|octant":
        return (omorton << np.uint64(3)) | octant
    if name == "omorton|dmorton":
        return (omorton << np.uint64(15)) | dmorton
    if name == "coarse-o|dmorton":         # 6-bit/axis origin cell
        qoc = _morton((qo >> np.uint64(3)).astype(np.uint64), 6)
        return (qoc << np.uint64(15)) | dmorton
    raise ValueError(name)


def _mean_union(hits, size: int) -> float:
    """Mean over subs of `size` consecutive rays of the leaves any ray of
    the sub visits (`hits` (L, N) bool, N a multiple of `size`)."""
    u = hits.reshape(hits.shape[0], -1, size).any(dim=2).sum(dim=0)
    return int(u.sum()) / u.numel()


def union_table(hits, o_np, d_np, c_lo, c_hi):
    """Mean per-sub union of leaf visits {key: {size: mean}}: the rays
    (numpy) sorted stably by each key of UNION_KEYS, cut into subs of each
    of UNION_SIZES, and per sub the leaves any of its rays visits (`hits` (L, N) bool,
    on its device). The box is `pt`'s: the children's least lower corner
    and the largest upper corner of the non-empty child slots."""
    lo = c_lo.min(axis=0)
    hi = c_hi[c_hi[:, 0] < 1e29].max(axis=0)
    ext = np.maximum(hi - lo, 1e-9)
    table = {}
    for name in UNION_KEYS:
        k = sort_key(name, o_np, d_np, lo, ext)
        hh = hits if k is None else hits[:, torch.as_tensor(
            np.argsort(k, kind="stable"), device=hits.device)]
        table[name] = {size: _mean_union(hh, size) for size in UNION_SIZES}
    return table


def _take(carry: BounceCarry, k: int) -> BounceCarry:
    """The first k lanes of a carry (the ray counter stays)."""
    def cut(a):
        return a[:k] if a.dim() else a
    return BounceCarry(*(type(f)(*(cut(a) for a in f))
                         if isinstance(f, tuple) else cut(f)
                         for f in carry))


def main(device=None, width: int = 512, bounces: int = 5, n: int = 224,
         n_sample: int = 65536, emit=print) -> dict:
    """The frame budget on `device` (the card unless "cpu" is named): the
    Heightfield at grid size `n`, width², `bounces` bounces. Returns one
    dict with every section: "bounces" (per bounce the stage ms, the
    rounds, the lockstep share, the pops and the traced rays), "sum_ms",
    "leaf_visits", "union", "shade", "lanes", with "tree" (the BF8BVH) and
    "device"."""
    dev = default_device(device)
    card = dev.type == "cuda"

    def tm(fn, *args, label=""):
        return timed(fn, *args, label=label, card=card, emit=emit)

    f = bench_frame(make_heightfield_scene(n), width, bounces, dev, block=32,
                    spatial=False)
    ds, tex, accel, fine, bvh8 = f.ds, f.tex, f.accel, f.fine, f.bvh8
    threads = kernels.bf8_threads_per_block(dev)
    emit(f"tree: {bvh8.n8} bf8 nodes, {bvh8.n_leaves} leaves, block "
         f"{bvh8.block}, retest {bvh8.leaf_retest}; {threads} threads per "
         "block")

    # ---- real per-bounce ray populations
    states = [f.carry]
    for b in range(bounces):
        states.append(bounce_once(ds, tex, accel, states[-1], f.settings, b))

    def stage_trace(o, d):
        return trace_closest(bvh8, o, d, torch.full_like(o[:, 0], TMAX))

    def stage_shade(hit, o, d, state, alive, mr, diff):
        return _shade_hit(ds, tex, accel, hit, o, d, state, alive, mr, None,
                          diff)

    def stage_occl(o, d, dist):
        return trace_occluded(bvh8, o, d, dist)

    def stage_sortkeys(o, d, alive):
        return torch.argsort(_coherence_keys(fine, o, d, alive), stable=True)

    # ---- 1. stage times per bounce
    emit("per-bounce stage times (full batch, no compaction):")
    rows = []
    for b in range(bounces):
        c = states[b]
        alive = int(c.alive.sum())
        dt_tr, hit = tm(stage_trace, c.origin, c.direction)
        dt_sh, payload = tm(stage_shade, hit, c.origin, c.direction, c.state,
                            c.alive, c.max_roughness, c.diff)
        sdir = -_normalize(payload["light_dir"])
        sdist = torch.minimum(payload["light_dist"], _aabb_exit_t(
            bvh8.root_lo, bvh8.root_hi, payload["next_origin"], sdir) + 1e-3)
        dt_oc, _ = tm(stage_occl, payload["next_origin"], sdir, sdist)
        dt_so, _ = tm(stage_sortkeys, c.origin, c.direction, c.alive)
        pops = torch.empty(c.origin.shape[0], dtype=torch.int32, device=dev)
        rounds = rounds_of(bvh8, c.origin, c.direction, pops=pops)
        lanes = lanes_of(pops, threads)
        lockstep = float(lanes.sum()) / max(WARP * int(lanes.max(2).sum()),
                                            1)
        row = dict(bounce=b, alive=alive, closest_ms=dt_tr, shade_ms=dt_sh,
                   occluded_ms=dt_oc, sortkeys_ms=dt_so,
                   rounds_p50=int(np.median(rounds)),
                   rounds_max=int(rounds.max()), blocks=len(rounds),
                   lockstep=lockstep, pops=pops,
                   wavefront=(c.origin, c.direction, TMAX))
        rows.append(row)
        ms = ("" if not card else
              f"closest {dt_tr:7.2f} ms  shade {dt_sh:6.2f} ms  occl "
              f"{dt_oc:7.2f} ms  sortkeys+argsort {dt_so:6.2f} ms  ")
        emit(f"  bounce {b}: alive {alive:7d}  {ms}rounds/block p50 "
             f"{row['rounds_p50']} max {row['rounds_max']} (x{len(rounds)} "
             f"blocks), warp lockstep {lockstep:.3f}")
    total = (sum(r["closest_ms"] + r["shade_ms"] + r["occluded_ms"]
                 for r in rows) if card else None)
    if card:
        emit(f"sum of stages (1 sample, no compaction): {total:.1f} ms")

    # ---- 2. leaf-visit waste: oracle against the packet union
    emit("leaf-visit oracle vs packet union (bounce 1 rays, live lanes "
         "first):")
    c = states[1]
    pick = torch.argsort((~c.alive).to(torch.int8), stable=True)[:n_sample]
    o = c.origin[pick].contiguous()
    d = c.direction[pick].contiguous()
    alive = c.alive[pick]
    hit = stage_trace(o, d)
    t_fin = torch.where(hit.t < 1e30, hit.t, TMAX)
    counts, hits = _leaf_visit_counts(bvh8.l_lo, bvh8.l_hi, o, d, t_fin)
    cnt = counts.cpu().numpy()
    key_perm = stage_sortkeys(o, d, alive)
    leaf = dict(rays=len(cnt), live=int(alive.sum()), mean=float(cnt.mean()),
                p50=float(np.median(cnt)),
                p95=float(np.percentile(cnt, 95)),
                union=_mean_union(hits, 1024),
                sorted_union=_mean_union(hits[:, key_perm], 1024))
    emit(f"  {leaf['rays']} rays, {leaf['live']} of them live; oracle "
         f"visits/ray: mean {leaf['mean']:.1f} p50 {leaf['p50']:.0f} p95 "
         f"{leaf['p95']:.0f}")
    for what, key in (("per-1024-sub union", "union"),
                      ("sorted union", "sorted_union")):
        emit(f"  {what} visits: mean {leaf[key]:.1f} (waste factor "
             f"{leaf[key] / max(leaf['mean'], 1e-9):.1f}x)")

    # ---- 3. union by sub size x sort key (the kernel design matrix)
    table = union_table(hits, o.cpu().numpy(), d.cpu().numpy(),
                        bvh8.c_lo.cpu().numpy(), bvh8.c_hi.cpu().numpy())
    del hits
    emit("per-sub union by sub size x sort key:")
    emit(f"  {'key':>16} " + "".join(f"{s:>8}" for s in UNION_SIZES))
    for name, row in table.items():
        emit(f"  {name:>16} " + "".join(f"{row[s]:8.1f}" for s in UNION_SIZES))

    # ---- 4. shade internals
    emit(f"shade breakdown (bounce-1 rays, {c.origin.shape[0]} lanes):")
    hit = stage_trace(c.origin, c.direction)

    def part_gather(hit):
        tri = torch.clamp(hit.tri, min=0).long()
        return (accel.tri_pos[tri], accel.tri_nrm[tri], accel.tri_tan[tri],
                accel.tri_bit[tri], accel.tri_uv[tri], ds.tri_mat[tri])

    rp, rn, rt, rb, ru, rowm = part_gather(hit)
    bary = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)
    uv = (ru[:, 0:2] * bary[:, 0:1] + ru[:, 2:4] * bary[:, 1:2]
          + ru[:, 4:6] * bary[:, 2:3])

    def part_diff(diff):
        p0, p1, p2 = rp[:, 0:3], rp[:, 3:6], rp[:, 6:9]
        n0, n1, n2 = rn[:, 0:3], rn[:, 3:6], rn[:, 6:9]
        pos = p0 * bary[:, 0:1] + p1 * bary[:, 1:2] + p2 * bary[:, 2:3]
        nrm = n0 * bary[:, 0:1] + n1 * bary[:, 1:2] + n2 * bary[:, 2:3]
        dpdu, dpdv, _, _ = compute_dpn_duv(
            p0, p1, p2, ru[:, 0:2], ru[:, 2:4], ru[:, 4:6],
            n0, n1, n2, rt[:, 0:3], rb[:, 0:3])
        dpdx, dpdy = compute_dp_dxy(pos, diff, nrm)
        return compute_uv_derivatives(dpdx, dpdy, dpdu, dpdv)

    def part_material(uv, duv):
        inside = torch.zeros(uv.shape[0], dtype=torch.bool, device=dev)
        return sample_material(ds, tex, rowm, uv, inside, *duv)

    def part_bsdf(mat, state):
        tbn = compute_tangent_space(rn[:, 0:3])
        v_local = matvec(tbn.transpose(-1, -2), -c.direction)
        st, bs = sample_bsdf(mat, v_local, state)
        lb, _ = evaluate_bsdf(mat, v_local, v_local)
        return st, bs.pdf, lb

    shade = {}
    shade["gathers_ms"], _ = tm(part_gather, hit,
                                label="attribute gathers (6 fat rows)")
    shade["differentials_ms"], duv = tm(part_diff, c.diff,
                                        label="ray differentials -> duv")
    shade["material_ms"], mat = tm(part_material, uv, duv,
                                   label="sample_material (textures)")
    shade["bsdf_ms"], _ = tm(part_bsdf, mat, c.state,
                             label="bsdf sample+eval")

    # ---- 5. one full bounce against lane count
    emit("full bounce against lane count (compaction size classes):")
    lane_rows = {}
    n_lanes = c.origin.shape[0]
    for k in sorted({min(k, n_lanes) for k in LANE_COUNTS}, reverse=True):
        sub = _take(c, k)
        dt, _ = tm(lambda s: bounce_once(ds, tex, accel, s, f.settings, 1),
                   sub)
        lane_rows[k] = dict(ms=dt, mlanes=None if dt is None
                            else k / dt / 1e3)
        if card:
            emit(f"  {k:7d} lanes: {dt:7.2f} ms ({k / dt / 1e3:.2f} "
                 "Mlanes/s)")
    return dict(tree=bvh8, device=(torch.cuda.get_device_name(dev) if card
                                   else "cpu"),
                bounces=rows, sum_ms=total, leaf_visits=leaf, union=table,
                shade=shade, lanes=lane_rows)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--bounces", type=int, default=5)
    ap.add_argument("--n", type=int, default=224)
    ap.add_argument("--n-sample", type=int, default=65536)
    a = ap.parse_args()
    main(a.device, a.width, a.bounces, a.n, a.n_sample)
