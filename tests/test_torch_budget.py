"""The frame budget and the drain model of the PyTorch port: the pops
launch of K1 (`closest_bf8(..., pops=)`, the warp kernel's pops instance,
and its per-ray arm `closest_bf8_per_ray(..., pops=)`), its plain version,
and `pt_torch.benches.budget` / `pt_torch.benches.drain_sim` against `pt`'s
`benches/budget.py` and `benches/drain_sim.py`.

* `closest_bf8_walk_plain` (the plain version of the pops launch) gives
  hits bit-equal to the brute plain version, and pops equal, lane by lane,
  to `csrc/bf8_traverse.cuh` built for the host by g++ with a pops pointer;
  the pops sum to the host build's node visits plus leaf-box retests.
* The warp kernel's plain schedule (`closest_bf8_warp_plain`) pops what
  the walk pops on every lane: each lane pauses at its leaves but pops the
  same entries in the same order.
* `done_rounds_of` / `rounds_of` lay lanes out as K1's launch runs them
  (block i // T, warp (i % T) // 32, T from the kernel source), and lanes
  past N count 0.
* `simulate` is bit-equal to `pt`'s on `pt`'s own `done_rounds_of` output
  (its Pallas kernel in interpret mode) and on the port's.
* `_leaf_visit_counts` and the union table equal `pt`'s on the same rays,
  leaves and hit masks, exactly (integer counts).
* Both benches run to their end on the CPU at a small size.

The pops variant on the card is tested in tests/test_torch_gpu.py.
"""

import ctypes
import pathlib
import subprocess

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pt.accel import pallas_bvh as jbvh
from pt_torch import convert
from pt_torch.accel import bvh8 as tbvh
from pt_torch.accel import kernels
from pt_torch.benches import bench_frame, budget, drain_sim
from pt_torch.render.integrator import bounce_once
from pt_torch.scene.examples import make_heightfield_scene

CSRC = pathlib.Path(kernels.__file__).resolve().parent / "csrc"


def _random_tris(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (n, 3))
    verts = (centers[:, None, :]
             + rng.normal(0, 0.4, (n, 3, 3))).reshape(-1, 3)
    return (verts.astype(np.float32),
            np.arange(n * 3, dtype=np.int32).reshape(n, 3))


def _random_rays(n, seed, spread=12.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return torch.as_tensor(o), torch.as_tensor(d)


def _soup_tree(seed=3):
    verts, tri = _random_tris(1000, seed)
    opaque = (np.arange(1000) % 3) != 0
    return tbvh.build_bf8(tbvh.build_packet_bvh_sah(
        verts, tri, block=32, max_leaves=8192, tri_opaque_np=opaque,
        spatial=True, device="cpu"))


@pytest.fixture(scope="module")
def wavefront():
    """A real small wavefront: bounce 1 of `pt`'s drain frame over the
    Heightfield at n=24, 32x32, under its SBVH at block 32."""
    f = bench_frame(make_heightfield_scene(24), 32, 5, "cpu", block=32,
                    spatial=True)
    c = bounce_once(f.ds, f.tex, f.accel, f.carry, f.settings, 0)
    return f.bvh8, c.origin.contiguous(), c.direction.contiguous()


def _rays_of(case, wavefront):
    """(tree, origins, dirs, tmax) of a case: a random soup with random
    rays, or the real wavefront with drain_sim's tmax."""
    if case == "random":
        o, d = _random_rays(2048, 4)
        return _soup_tree(), o, d, torch.full((2048,), 1e4)
    b8, o, d = wavefront
    return b8, o, d, torch.full((o.shape[0],), 1e30)


# --------------------------------------- the kernel's per-ray code, on host

_HOST_SRC = r"""
#include "bf8_traverse.cuh"
extern "C" void host_closest_pops(
        const float* c_lo, const float* c_hi, const int32_t* c_ent,
        const float* l_lo, const float* l_hi, const float* pages, int block,
        int cols, const float* o, const float* d, const float* tmax,
        float tmin, int n, float* t, int32_t* tri, float* u, float* v,
        unsigned long long* stats, uint8_t* node_seen, uint8_t* tri_seen,
        int32_t* pops) {
    bf8::Tree tree{c_lo, c_hi, c_ent, l_lo, l_hi, pages, block, cols};
    for (int i = 0; i < n; ++i) {
        bf8::Counts c{0, 0, 0, node_seen, tri_seen};
        bf8::Ray r = bf8::make_ray(o[3*i], o[3*i+1], o[3*i+2],
                                   d[3*i], d[3*i+1], d[3*i+2]);
        bf8::closest<true, true>(tree, r, tmin, tmax[i], t + i, tri + i,
                                 u + i, v + i, &c, pops + i);
        stats[0] += c.nodes; stats[1] += c.leaf_boxes; stats[2] += c.tris;
    }
}
"""


@pytest.fixture(scope="module")
def host_pops(tmp_path_factory):
    """bf8_traverse.cuh built for the host by g++ (no torch headers), with
    -ffp-contract=off so it rounds as the -fmad=false CUDA build does; the
    counted variant with a pops pointer."""
    tmp = tmp_path_factory.mktemp("bf8_pops_host")
    src = tmp / "bf8_pops_host.cpp"
    src.write_text(_HOST_SRC)
    lib = tmp / "libbf8_pops_host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", f"-I{CSRC}", str(src), "-o",
                    str(lib)], check=True, capture_output=True, timeout=120)
    h = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    h.host_closest_pops.argtypes = [p] * 6 + [i, i, p, p, p, f, i] + [p] * 8
    return h


@pytest.mark.parametrize("case", ["random", "wavefront"])
def test_walk_plain_matches_plain_and_host_build(host_pops, wavefront, case):
    """Hits bit-equal to the brute plain version; pops equal to the host
    build's lane by lane, summing to its node visits plus leaf retests."""
    b8, o, d, tmax = _rays_of(case, wavefront)
    n = o.shape[0]
    peak = torch.zeros(n, dtype=torch.int32)
    hit, pops = kernels.closest_bf8_walk_plain(b8, o, d, tmax, peak=peak)
    plain = kernels.closest_bf8_plain(b8, o, d, tmax)
    for a, b in zip(hit, plain):
        assert torch.equal(a, b)
    assert int((plain.tri >= 0).sum()) > n // 20

    t, u, v = torch.empty(n), torch.empty(n), torch.empty(n)
    tri = torch.empty(n, dtype=torch.int32)
    host = torch.empty(n, dtype=torch.int32)
    counts = kernels.work_counts(b8)
    host_pops.host_closest_pops(
        *kernels._tree_args(b8), o.data_ptr(), d.data_ptr(), tmax.data_ptr(),
        1e-5, n, t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
        *(a.data_ptr() for a in counts), host.data_ptr())
    assert torch.equal(host, pops)
    assert torch.equal(tri, hit.tri) and torch.equal(t, hit.t)
    nodes, leaf_boxes, _ = counts.totals.tolist()
    assert int(pops.sum()) == nodes + leaf_boxes
    assert int(pops.min()) >= 1 and int(pops.max()) > int(pops.min())
    assert 1 <= int(peak.max()) <= b8.stack_bound


def test_cpu_pops_launch_routes_to_the_walk(wavefront):
    """closest_bf8(..., pops=) and closest_bf8_per_ray(..., pops=) on CPU
    tensors fill pops from the plain walk and launch nothing."""
    b8, o, d, tmax = _rays_of("wavefront", wavefront)
    before = dict(kernels.launches)
    want, want_pops = kernels.closest_bf8_walk_plain(b8, o, d, tmax)
    for fn in (kernels.closest_bf8, kernels.closest_bf8_per_ray):
        pops = torch.full((o.shape[0],), -7, dtype=torch.int32)
        hit = fn(b8, o, d, tmax, pops=pops)
        assert torch.equal(pops, want_pops)
        for a, b in zip(hit, want):
            assert torch.equal(a, b)
    assert kernels.launches == before


@pytest.mark.parametrize("case", ["random", "wavefront"])
def test_warp_schedule_pops_equal_walk_pops(wavefront, case):
    """The warp K1's plain schedule writes each lane's pops as its pops
    instance does: equal to the walk's on every lane, with the same hits;
    their sum is the schedule's node visits plus leaf-box retests."""
    b8, o, d, tmax = _rays_of(case, wavefront)
    hit, want = kernels.closest_bf8_walk_plain(b8, o, d, tmax)
    pops = torch.full((o.shape[0],), -7, dtype=torch.int32)
    whit, sched = kernels.closest_bf8_warp_plain(b8, o, d, tmax, pops=pops)
    assert torch.equal(pops, want)
    for a, b in zip(whit, hit):
        assert torch.equal(a, b)
    assert int(pops.sum()) == sched.node_visits + sched.leaf_boxes
    assert sched.rounds > sched.warps       # lanes paused at leaves


def test_pops_argument_checks():
    b8 = _soup_tree()
    o, d = _random_rays(64, 5)
    tmax = torch.full((64,), 1e4)
    good = torch.zeros(64, dtype=torch.int32)
    for fn in (kernels.closest_bf8, kernels.closest_bf8_per_ray):
        fn(b8, o, d, tmax, pops=good)
        with pytest.raises(TypeError):
            fn(b8, o, d, tmax, pops=good.long())
        with pytest.raises(TypeError):
            fn(b8, o, d, tmax, pops=good.numpy())
        with pytest.raises(ValueError):
            fn(b8, o, d, tmax, pops=good[:63])
        with pytest.raises(ValueError):
            fn(b8, o, d, tmax, pops=torch.zeros(128, dtype=torch.int32)[::2])
        with pytest.raises(ValueError):
            fn(b8, o, d, tmax,
               pops=torch.zeros(64, dtype=torch.int32, device="meta"))


# ------------------------------------------------------ rounds and warps

@pytest.mark.parametrize("n", [1024, 900])
def test_done_rounds_of_lays_lanes_out_as_the_launch(n):
    """Shapes (ceil(N/T),) and (ceil(N/T), T/32); done is the most pops of
    each warp's 32 lanes, rounds the most of each block's warps; lanes past
    N count 0 (N = 900 is no multiple of 32)."""
    threads = kernels.bf8_threads_per_block("cpu")
    assert threads > 0 and threads % drain_sim.WARP == 0
    b8 = _soup_tree()
    o, d = _random_rays(n, 6)
    pops = torch.zeros(n, dtype=torch.int32)
    rounds, done = drain_sim.done_rounds_of(b8, o, d, pops=pops)
    blocks = -(-n // threads)
    assert rounds.shape == (blocks,) and rounds.dtype == np.int64
    assert done.shape == (blocks, threads // 32)
    np.testing.assert_array_equal(rounds, done.max(axis=1))
    padded = np.zeros(blocks * threads, np.int64)
    padded[:n] = pops.numpy()
    for b in range(blocks):
        for w in range(threads // 32):
            lo = b * threads + w * 32
            assert done[b, w] == padded[lo:lo + 32].max()
    _, want = kernels.closest_bf8_walk_plain(b8, o, d,
                                             torch.full((n,), 1e30))
    assert torch.equal(pops, want)
    if n % 32:
        first_empty = -(-n // 32) * 32
        assert (padded[n:] == 0).all()
        assert (done.reshape(-1)[first_empty // 32:] == 0).all()
    assert done.min() >= 0 and (done.reshape(-1)[:n // 32] >= 1).all()
    # budget's rounds_of shares the helper: the same rounds at its tmax
    np.testing.assert_array_equal(
        budget.rounds_of(b8, o, d, tmax=1e30), rounds)


# ------------------------------------------------- against pt's benches

@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run pt's Pallas kernels in interpret mode on the CPU (nothing in pt
    changes: pl.pallas_call is patched to pass InterpretParams)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    orig = pl.pallas_call

    def interpreted(*args, **kw):
        kw.setdefault("interpret", pltpu.InterpretParams())
        return orig(*args, **kw)
    monkeypatch.setattr(pl, "pallas_call", interpreted)


def _fields(obj):
    import dataclasses
    return {f.name: (np.asarray(getattr(obj, f.name))
                     if hasattr(getattr(obj, f.name), "shape")
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _same_model(a, b):
    assert a == b            # (current, lower, rows): Python ints, exact


def test_simulate_matches_pt_on_pt_done(pallas_interpret):
    """pt's done_rounds_of (its K1 body in interpret mode) on 2,048 rays
    over 1,000 triangles: both simulates give the same numbers."""
    from benches import drain_sim as jdrain
    verts, tri = _random_tris(1000, 7)
    j8 = jbvh.build_bf8(jbvh.build_packet_bvh_sah(
        verts, tri, block=32, max_leaves=8192, spatial=True))
    o, d = _random_rays(2048, 8)
    rounds, done = jdrain.done_rounds_of(j8, jnp.asarray(o.numpy()),
                                         jnp.asarray(d.numpy()))
    assert done.shape[0] == rounds.shape[0] and (done > 0).all()
    np.testing.assert_array_equal(rounds, done.max(axis=1))
    _same_model(drain_sim.simulate(done), jdrain.simulate(done))
    # the same rays through the port, on pt's own structure
    b8 = convert.bf8_bvh(_fields(j8), device="cpu")
    p_rounds, p_done = drain_sim.done_rounds_of(b8, o, d)
    assert p_done.shape[1] == 4
    np.testing.assert_array_equal(p_rounds, p_done.max(axis=1))
    _same_model(drain_sim.simulate(p_done), jdrain.simulate(p_done))


def test_simulate_matches_pt_on_port_done(wavefront):
    """On the port's warps-in-blocks and lanes-in-warps arrays of a real
    wavefront, both simulates give the same numbers."""
    from benches import drain_sim as jdrain
    b8, o, d, _ = _rays_of("wavefront", wavefront)
    pops = torch.zeros(o.shape[0], dtype=torch.int32)
    _, done = drain_sim.done_rounds_of(b8, o, d, pops=pops)
    lanes = drain_sim.lanes_of(pops, kernels.bf8_threads_per_block("cpu"))
    for arr in (done, lanes.reshape(-1, drain_sim.WARP)):
        _same_model(drain_sim.simulate(arr), jdrain.simulate(arr))
    current = drain_sim.simulate(lanes.reshape(-1, 32))[0]
    assert current == int(lanes.max(axis=2).sum()) >= int(done.sum())


def test_leaf_visit_counts_match_pt(wavefront):
    """Integer counts and hit masks equal pt's on the same rays, leaves and
    final t (no lane differs)."""
    from benches import budget as jbudget
    b8, o, d, _ = _rays_of("wavefront", wavefront)
    hit = kernels.closest_bf8_plain(b8, o, d, torch.full((o.shape[0],), 1e4))
    t_fin = torch.where(hit.t < 1e30, hit.t, 1e4)
    counts, hits = budget._leaf_visit_counts(b8.l_lo, b8.l_hi, o, d, t_fin,
                                             chunk=7)
    j_counts, j_hits = jbudget._leaf_visit_counts(
        *(jnp.asarray(a.numpy()) for a in (b8.l_lo, b8.l_hi, o, d, t_fin)))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(hits.numpy(), np.asarray(j_hits))
    assert 0 < counts.float().mean() < b8.n_leaves


def _pt_union_table(hits, o_np, d_np, c_lo, c_hi, sizes):
    """benches/budget.py:249-296 as pt runs it, in numpy, returning the
    table it prints."""
    lo = c_lo.min(axis=0)
    hi = c_hi[c_hi[:, 0] < 1e29].max(axis=0)
    ext = np.maximum(hi - lo, 1e-9)

    def morton(q, bits):
        out = np.zeros(q.shape[0], np.uint64)
        for b in range(bits):
            for a in range(3):
                out |= ((q[:, a].astype(np.uint64) >> b) & 1) << \
                    np.uint64(3 * b + (2 - a))
        return out

    def key_variant(name):
        qo = np.clip((o_np - lo) / ext * 512, 0, 511).astype(np.uint64)
        octant = ((d_np[:, 0] < 0).astype(np.uint64) * np.uint64(4)
                  + (d_np[:, 1] < 0).astype(np.uint64) * np.uint64(2)
                  + (d_np[:, 2] < 0).astype(np.uint64))
        dmorton = morton(np.clip((d_np * 0.5 + 0.5) * 32, 0,
                                 31).astype(np.uint64), 5)
        omorton = morton(qo, 9)
        if name == "none":
            return None
        if name == "octant|omorton":
            return (octant << np.uint64(27)) | omorton
        if name == "omorton|octant":
            return (omorton << np.uint64(3)) | octant
        if name == "omorton|dmorton":
            return (omorton << np.uint64(15)) | dmorton
        if name == "coarse-o|dmorton":
            qoc = morton((qo >> np.uint64(3)).astype(np.uint64), 6)
            return (qoc << np.uint64(15)) | dmorton

    table = {}
    for name in ("none", "octant|omorton", "omorton|octant",
                 "omorton|dmorton", "coarse-o|dmorton"):
        k = key_variant(name)
        hh = hits if k is None else hits[:, np.argsort(k, kind="stable")]
        table[name] = {}
        for size in sizes:
            u = hh.reshape(hh.shape[0], -1, size).any(axis=2).sum(axis=0)
            table[name][size] = u.mean()
    return table


def test_union_table_matches_pt_numpy(wavefront):
    """Each key variant and sub size (pt's 128-1024 and the warp's 32) on
    the same hit masks: the same mean union."""
    b8, o, d, _ = _rays_of("wavefront", wavefront)
    o, d = o[:1024], d[:1024]
    hit = kernels.closest_bf8_plain(b8, o, d, torch.full((1024,), 1e4))
    _, hits = budget._leaf_visit_counts(b8.l_lo, b8.l_hi, o, d, hit.t)
    args = (o.numpy(), d.numpy(), b8.c_lo.numpy(), b8.c_hi.numpy())
    got = budget.union_table(hits, *args)
    want = _pt_union_table(hits.numpy(), *args, budget.UNION_SIZES)
    assert got == want
    assert got["none"][32] < got["none"][1024]


# ------------------------------------------------------- the benches

def test_budget_main_runs_every_section_on_cpu():
    lines = []
    out = budget.main(device="cpu", width=32, bounces=2, n=32,
                      n_sample=1024, emit=lines.append)
    assert out["device"] == "cpu" and out["sum_ms"] is None
    assert [r["bounce"] for r in out["bounces"]] == [0, 1]
    for r in out["bounces"]:
        assert r["closest_ms"] is None and r["blocks"] == 1024 // 128
        assert 1 <= r["rounds_p50"] <= r["rounds_max"]
        assert 0.0 < r["lockstep"] <= 1.0
        assert r["pops"].shape == (1024,) and int(r["pops"].min()) >= 1
    assert out["bounces"][0]["alive"] == 1024
    lv = out["leaf_visits"]
    assert 0 < lv["mean"] <= lv["union"] and lv["sorted_union"] > 0
    # the lanes alive at bounce 1 are sampled first
    assert lv["rays"] == 1024 and lv["live"] == out["bounces"][1]["alive"]
    assert set(out["union"]) == set(budget.UNION_KEYS)
    assert all(set(row) == set(budget.UNION_SIZES)
               for row in out["union"].values())
    assert set(out["shade"]) == {"gathers_ms", "differentials_ms",
                                 "material_ms", "bsdf_ms"}
    assert list(out["lanes"]) == [1024]
    assert any(line.startswith("per-sub union") for line in lines)


def test_drain_main_runs_every_section_on_cpu():
    lines = []
    out = drain_sim.main(device="cpu", width=32, bounces=2, n=32,
                         emit=lines.append)
    assert out["scene"] == "heightfield" and out["triangles"] == 2 * 31 * 31
    assert len(out["bounces"]) == 2
    for r in out["bounces"]:
        np.testing.assert_array_equal(r["rounds"], r["done"].max(axis=1))
        assert r["done"].shape == (8, 4) and len(r["rows"]) == 5
        assert r["lower"] <= r["current"] and r["lane_lower"] <= \
            r["lane_current"]
        assert 0.0 < r["lockstep"] <= 1.0
    assert out["bounces"][0]["alive"] == 1024 > out["bounces"][1]["alive"]
    assert sum("lockstep" in line for line in lines) == 2


def test_courtyard_texture_cut_changes_no_triangle():
    """drain_sim's Courtyard at two texture scales: the same triangles, bit
    for bit (the scene draws a fixed count of random numbers per texture)."""
    from pt_torch.scene.flatten import flatten_scene, world_vertices
    got = []
    for scale in (0.05, 0.1):
        ds = flatten_scene(drain_sim.make_scene("courtyard", tex_scale=scale),
                           device="cpu")
        got.append((world_vertices(ds)[0], ds.tri_idx, ds.tri_opaque))
    assert got[0][1].shape[0] == 212884
    for a, b in zip(*got):
        assert torch.equal(a, b)
