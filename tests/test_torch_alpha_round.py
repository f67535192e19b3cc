"""The round kernels of the split any-hit loops (`csrc/alpha_round.cuh`,
the per-lane body of `csrc/alpha_round_kernels.cu`), built for the host by
g++ with -ffp-contract=off, against their plain twins
(`integrator._closest_round_plain` / `_shadow_round_plain`), bit for bit.

Each case runs three rounds of one loop on 3,000 lanes from the same
start, one pool layout (quad, paired, flat rows, all 1x1 constants) in bf16
or f32, over an alpha tree with a root box or without one (brute force),
and compares the whole state and the next round's ray after every round.
The arguments reach the host build as they reach the CUDA launchers: as
pointers to the ctypes structures that `kernels.alpha_round_tables`,
`closest_round_args` / `shadow_round_args` and `round_call_args` fill, so
the structures' layout and filling are checked too. Each case also checks that its rounds held misses,
hits at and beyond the bound (closest) or the remaining distance (shadow),
alphas of exactly 0.5 and 1.0, a second skip that records no decal, and
that lanes not pending kept their state and, with a root box, got the
degenerate ray.

The CUDA kernels themselves are tested in tests/test_torch_gpu.py.
"""

import ctypes
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pt_torch.accel import kernels
from pt_torch.accel.intersect import Hit
from pt_torch.render import integrator as integ
from pt_torch.render.rays import TMIN
from pt_torch.render.textures import TexturePoolBuilder
from pt_torch.scene.flatten import F_COLOR, NUM_MAT_FIELDS, NUM_MAT_TEX, T_COLOR

from torch_threads import one_torch_thread  # noqa: F401

N = 3000          # lanes
K = 40            # alpha subset triangles
T = 100           # triangles
M = 8             # materials
ROUNDS = 3

# the CUDA launchers' signatures without the stream, over the same structs
_HOST_SRC = r"""
#include "alpha_round.cuh"
using namespace alpha;
template <class State, class Lane>
int rounds(const Hits* h, const State* s, const NextRay* r, const Tables* tb,
           const Pool* pool, int n, Lane lane) {
    return with_pool(*pool, [&](auto kind) {
        for (int64_t i = 0; i < n; ++i) lane(kind, i, *h, *s, *r, *tb, *pool);
        return 0;
    });
}
extern "C" {
int host_closest_round(const Hits* h, const ClosestState* s, const NextRay* r,
                       const Tables* tb, const Pool* pool, int n) {
    return rounds(h, s, r, tb, pool, n, [](auto kind, auto... a) {
        using K = decltype(kind);
        closest_lane<K::layout, typename K::texel_t>(a...);
    });
}
int host_shadow_round(const Hits* h, const ShadowState* s, const NextRay* r,
                      const Tables* tb, const Pool* pool, int n) {
    return rounds(h, s, r, tb, pool, n, [](auto kind, auto... a) {
        using K = decltype(kind);
        shadow_lane<K::layout, typename K::texel_t>(a...);
    });
}
}
"""

LAYOUTS = ("quad", "paired", "flat", "constant")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
ROOTS = ("box", "none")
CASES = [(lay, dt, root) for lay in LAYOUTS for dt in DTYPES
         for root in ROOTS]


@pytest.fixture(scope="module")
def host_rounds(tmp_path_factory):
    """alpha_round.cuh's two lane bodies over all lanes, built by g++ (no
    torch headers) with -ffp-contract=off, so that they round as the
    -fmad=false CUDA build does."""
    tmp = tmp_path_factory.mktemp("alpha_round_host")
    src = tmp / "rounds.cpp"
    src.write_text(_HOST_SRC)
    lib = tmp / "librounds.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", f"-I{kernels.CSRC}", str(src), "-o",
                    str(lib)], check=True, capture_output=True, timeout=120)
    h = ctypes.CDLL(str(lib))
    for fn in (h.host_closest_round, h.host_shadow_round):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]
        fn.restype = ctypes.c_int
    return h


def _pool(layout, dtype, rng):
    """A pool with 1x1 textures of alpha 0.5 and 1.0 (exact at any uv) and,
    but for the constant layout, textures of several sizes whose texels
    hold alphas of exactly 0.5 and 1.0 among random ones."""
    if layout == "constant":
        b = TexturePoolBuilder()
    else:
        b = TexturePoolBuilder(paired=layout == "paired",
                               quad=layout == "quad")
    for a in (0.5, 1.0, 0.25, 0.75):
        b.add(np.array([[[0.2, 0.6, 0.9, a]]], np.float32),
              generate_mips=False)
    if layout != "constant":
        for w, h in ((4, 4), (5, 3), (8, 8), (2, 7)):
            px = rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
            px[..., 3] = rng.choice([0.0, 0.3, 0.5, 0.5, 0.7, 1.0, 1.0],
                                    (h, w))
            b.add(px)
    tex = b.build(dtype=dtype, device="cpu")
    assert tex.all_constant == (layout == "constant")
    assert (tex.quad, tex.paired) == {"quad": (True, False),
                                      "paired": (False, True),
                                      "flat": (False, False),
                                      "constant": (True, False)}[layout]
    return tex


def _scene(layout, dtype, root, seed):
    """Stand-ins for the DeviceScene, Accel and AlphaSplit fields a round
    reads, and the loop's rays."""
    rng = np.random.default_rng(seed)
    tex = _pool(layout, dtype, rng)
    uv = rng.uniform(-2.0, 3.0, (T, 6)).astype(np.float32)
    # uv0 on texel centres of the 4x4 and of the 1x1 textures: a hit there
    # with u = v = 0 reads one texel exactly
    pick = rng.integers(0, 3, T)
    quarter = (rng.integers(0, 4, (T, 2)) + 0.5) / 4
    uv[:, 0:2] = np.where((pick == 0)[:, None], quarter, uv[:, 0:2])
    uv[:, 0:2] = np.where((pick == 1)[:, None], 0.5, uv[:, 0:2])
    uv[:, 0:2] += np.where((pick < 2)[:, None],
                           rng.integers(-2, 3, (T, 2)), 0)
    mat_tex = rng.integers(0, tex.count, (M, NUM_MAT_TEX)).astype(np.int32)
    mat_tex[:, T_COLOR] = np.arange(M) % tex.count
    mat_tex[M - 1, T_COLOR] = tex.count + 3          # clamped to the last
    mat_tex[M - 2, T_COLOR] = -2                     # clamped to 0
    params = rng.uniform(0, 1, (M, NUM_MAT_FIELDS)).astype(np.float32)
    params[:, F_COLOR:F_COLOR + 4] = rng.choice([1.0, 0.5, 2.0, 0.8],
                                                (M, 4))
    params[:4, F_COLOR + 3] = 1.0                    # the exact 1x1 alphas
    ds = SimpleNamespace(
        tri_mat=torch.as_tensor(rng.integers(0, M, T).astype(np.int32)),
        mat_tex=torch.as_tensor(mat_tex),
        mat_params=torch.as_tensor(params))
    accel = SimpleNamespace(tri_uv=torch.as_tensor(uv))
    box = SimpleNamespace(root_lo=torch.tensor([-3.0, -2.0, -4.0]),
                          root_hi=torch.tensor([5.0, 6.5, 3.25]))
    sel = torch.as_tensor(rng.choice(T, K, replace=False).astype(np.int32))
    sp = integ.AlphaSplit(None, None, box if root == "box" else
                          integ.BruteTriangles(None, None), sel)
    o = torch.as_tensor(rng.uniform(-2, 2, (N, 3)).astype(np.float32))
    d = rng.normal(size=(N, 3))
    d = torch.as_tensor((d / np.linalg.norm(d, axis=1, keepdims=True))
                        .astype(np.float32))
    alive = torch.as_tensor(rng.random(N) < 0.85)
    return rng, tex, ds, accel, sp, o, d, alive


def _round_hit(rng, limit, pending_t=None):
    """A random round hit against `limit` (the lanes' remaining t): a
    quarter misses (t = the ray's limit), the rest hit in front of it,
    within 1e-4 in front of it (the skip's step then passes the bound), at
    it or up to half again beyond it; u = v = 0 on some."""
    lim = limit.numpy()
    tri = rng.integers(0, K, N).astype(np.int32)
    miss = rng.random(N) < 0.25
    tri[miss] = -1
    kind = rng.integers(0, 4, N)
    frac = np.select([kind == 0, kind == 1, kind == 2],
                     [rng.uniform(0.02, 0.98, N), 1.0 - 1e-6, 1.0],
                     rng.uniform(1.0, 1.5, N))
    t = (lim * frac).astype(np.float32)
    t[miss] = lim[miss]
    u = rng.uniform(0, 1, N)
    v = rng.uniform(0, 1, N) * (1 - u)
    zero = rng.random(N) < 0.3
    u[zero | miss] = 0.0
    v[zero | miss] = 0.0
    return Hit(torch.as_tensor(t), torch.as_tensor(tri),
               torch.as_tensor(u.astype(np.float32)),
               torch.as_tensor(v.astype(np.float32)))


def _bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


def _same(a, b, what):
    assert torch.equal(_bits(a), _bits(b)), (
        what, int((_bits(a) != _bits(b)).sum()))


def _tables(ds, tex, accel, sp):
    return kernels.alpha_round_tables(sp.sel_alpha, accel.tri_uv, ds.tri_mat,
                                      ds.mat_tex, T_COLOR, ds.mat_params,
                                      F_COLOR, tex)


def _alphas(ds, tex, accel, sp, hit, lanes):
    tri_g = integ._remap_subset_tri(sp.sel_alpha, hit.tri)
    a = integ._surface_color_alpha_tri(ds, tex, accel, tri_g, hit.u,
                                       hit.v)[:, 3]
    return a[lanes & hit.is_hit]


def _check_ray(st_p, st_k, what):
    for name, a, b in zip("odt", st_p.ray, st_k.ray):
        _same(a, b, f"{what}: next ray {name}")


def _check_untouched(before, after, idle, root, what):
    """Lanes not pending at a round's start keep their state; with a root
    box their ray is the degenerate one."""
    for name, a in before:
        _same(a[idle], after[name][idle], f"{what}: idle lanes' {name}")
    if root == "box":
        o, d, t = after["ray"]
        assert torch.equal(o[idle], (torch.tensor([5.0, 6.5, 3.25]) + 1e6)
                           .expand_as(o[idle]))
        assert torch.equal(d[idle], torch.tensor([1.0, 0.0, 0.0])
                           .expand_as(d[idle]))
        assert torch.equal(t[idle], torch.full_like(t[idle], TMIN))


@pytest.mark.parametrize("layout,dtype,root", CASES)
def test_closest_round_kernel_matches_plain_twin(host_rounds, layout, dtype,
                                                 root):
    rng, tex, ds, accel, sp, o, d, alive = _scene(layout, DTYPES[dtype],
                                                  root, 7)
    t_o = torch.as_tensor(rng.uniform(0.5, 20.0, N).astype(np.float32))
    tri_o = torch.as_tensor(rng.integers(-1, T, N).astype(np.int32))
    hit_o = Hit(t_o, tri_o, torch.rand(N), torch.rand(N))

    def start(kernel):
        h = Hit(*(a.clone() for a in hit_o))   # the opaque trace's own
        return integ._closest_rounds_start(sp, h, h.tri.clone(), o, d,
                                           alive, kernel)
    st_p = start(None)
    st_k = start(_tables(ds, tex, accel, sp))
    assert st_k.kernel is not None and st_k.final.t is st_k.bound
    seen = dict(miss=0, beyond=0, accept=0, skip=0, second_skip=0,
                past_bound=0, half=0, one=0)
    for _ in range(ROUNDS):
        pending = st_p.pending.clone()
        had_decal = st_p.has_decal.clone()
        t_accum = st_p.t_accum.clone()
        hit = _round_hit(rng, torch.clamp(st_p.bound - st_p.t_accum, min=0))
        before = [("t_accum", st_k.t_accum.clone()),
                  ("final_t", st_k.final.t.clone()),
                  ("final_tri", st_k.final.tri.clone()),
                  ("decal_color", st_k.decal_color.clone()),
                  ("has_decal", st_k.has_decal.clone())]
        st_p = integ._closest_round_plain(ds, tex, accel, sp, st_p, d, hit,
                                          last=False)
        assert host_rounds.host_closest_round(
            *kernels.round_call_args(hit, st_k.kernel)) == 0
        for name in ("pending", "t_accum", "decal_color", "decal_alpha",
                     "has_decal"):
            _same(getattr(st_p, name), getattr(st_k, name), name)
        for name, a, b in zip(Hit._fields, st_p.final, st_k.final):
            _same(a, b, f"final {name}")
        _check_ray(st_p, st_k, "closest")
        _check_untouched(before, dict(
            t_accum=st_k.t_accum, final_t=st_k.final.t,
            final_tri=st_k.final.tri, decal_color=st_k.decal_color,
            has_decal=st_k.has_decal, ray=st_k.ray), ~pending, root,
            "closest")
        live = pending & hit.is_hit
        beyond = live & ~(t_accum + hit.t < st_p.bound)
        alpha = _alphas(ds, tex, accel, sp, hit, pending & ~beyond)
        seen["miss"] += int((pending & ~hit.is_hit).sum())
        seen["beyond"] += int(beyond.sum())
        seen["skip"] += int(st_p.pending.sum())
        seen["second_skip"] += int((st_p.pending & had_decal).sum())
        seen["past_bound"] += int((st_p.pending & (st_p.t_accum
                                                   > st_p.bound)).sum())
        seen["accept"] += int((live & ~beyond & ~st_p.pending).sum())
        seen["half"] += int((alpha == 0.5).sum())
        seen["one"] += int((alpha == 1.0).sum())
    assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("layout,dtype,root", CASES)
def test_shadow_round_kernel_matches_plain_twin(host_rounds, layout, dtype,
                                                root):
    rng, tex, ds, accel, sp, o, d, alive = _scene(layout, DTYPES[dtype],
                                                  root, 11)
    dist = torch.as_tensor(rng.uniform(0.5, 20.0, N).astype(np.float32))
    occluded0 = alive & torch.as_tensor(rng.random(N) < 0.2)

    def start(kernel):
        return integ._shadow_rounds_start(sp, occluded0.clone(), o, d, dist,
                                          alive, kernel)
    st_p = start(None)
    st_k = start(_tables(ds, tex, accel, sp))
    assert st_k.kernel is not None and st_k.remaining is st_k.ray[2]
    seen = dict(miss=0, beyond=0, blocked=0, passed=0, half=0, one=0)
    for _ in range(ROUNDS):
        pending = st_p.pending.clone()
        remaining = st_p.remaining.clone()
        hit = _round_hit(rng, remaining)
        before = [("occluded", st_k.occluded.clone())]
        st_p = integ._shadow_round_plain(ds, tex, accel, sp, st_p, d, hit,
                                         last=False)
        assert host_rounds.host_shadow_round(
            *kernels.round_call_args(hit, st_k.kernel)) == 0
        _same(st_p.pending, st_k.pending, "pending")
        _same(st_p.occluded, st_k.occluded, "occluded")
        _check_ray(st_p, st_k, "shadow")
        _check_untouched(before, dict(occluded=st_k.occluded, ray=st_k.ray),
                         ~pending, root, "shadow")
        alpha = _alphas(ds, tex, accel, sp, hit, pending)
        seen["miss"] += int((pending & ~hit.is_hit).sum())
        seen["beyond"] += int((pending & hit.is_hit
                               & (hit.t >= remaining)).sum())
        seen["blocked"] += int((pending & st_p.occluded).sum())
        seen["passed"] += int(st_p.pending.sum())
        seen["half"] += int((alpha == 0.5).sum())
        seen["one"] += int((alpha == 1.0).sum())
    assert all(v > 0 for v in seen.values()), seen


def test_round_launchers_refuse_cpu_tensors():
    """The launchers take CUDA tensors only: on the CPU the integrator runs
    the plain twins, and a launcher called there raises."""
    rng, tex, ds, accel, sp, o, d, alive = _scene("quad", torch.bfloat16,
                                                  "box", 3)
    occluded = torch.zeros(N, dtype=torch.bool)
    st = integ._shadow_rounds_start(sp, occluded, o, d, torch.ones(N), alive,
                                    _tables(ds, tex, accel, sp))
    hit = _round_hit(rng, st.remaining)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.alpha_shadow_round(hit, st.kernel)
    assert kernels.launches == before
