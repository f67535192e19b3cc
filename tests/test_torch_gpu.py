"""The port's CUDA kernels on a card (marker `gpu`; they skip without one).

Whether a card is present is decided inside the `cuda_device` fixture, never
at import, so every test process collects the same tests. This file imports
neither JAX nor `pt`, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

(`--noconftest`: tests/conftest.py configures JAX for the other files.)
K1-K6 and the archive kernels (closest_ordered, closest_v6, closest_v6k2,
closest_v7, occluded_v6) hold bit-equal to their plain PyTorch versions: the kernels are
built with -fmad=false and run the plain version's f32 arithmetic in its
order. K1's pops launch (the warp kernel's pops instance) gives its per-ray
arm's hits and pops bit for bit, and the plain walk's pops. The
warp-cooperative K1/K2, closest_v6, occluded_v6, closest_v6k2, closest_v7,
K3/K4, K5/K6 and closest_ordered give the per-ray arm's bits on every lane
(K1/K2, the v6 walks, K5/K6 and closest_ordered also the plain warp
schedule's), and K1/K2, the v6 walks and closest_ordered raise on a tree
whose pages cannot be staged; closest_ordered also on a tree deeper than
its stack.
"""

import numpy as np
import pytest
import torch

from pt_torch.accel import archive, bvh8, instanced, kernels


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _random_tris(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (n, 3))
    verts = (centers[:, None, :] + rng.normal(0, 0.4, (n, 3, 3))).reshape(-1, 3)
    return (verts.astype(np.float32),
            np.arange(n * 3, dtype=np.int32).reshape(n, 3))


def _heightfield(n):
    from pt_torch.scene.examples import make_heightfield_scene
    from pt_torch.scene.flatten import flatten_scene, world_vertices
    ds = flatten_scene(make_heightfield_scene(n), device="cpu")
    return world_vertices(ds)[0].numpy(), ds.tri_idx.numpy()


def _rays(n, seed, device):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return torch.as_tensor(o, device=device), torch.as_tensor(d, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("soup", ["random", "heightfield"])
def test_cuda_kernels_match_plain(cuda_device, soup):
    verts, tri = (_random_tris(2000, 31) if soup == "random"
                  else _heightfield(64))
    opaque = (np.arange(tri.shape[0]) % 2) == 0
    b8 = bvh8.build_bf8(bvh8.build_packet_bvh_sah(
        verts, tri, block=32, max_leaves=8192, tri_opaque_np=opaque,
        spatial=True, device=cuda_device))
    o, d = _rays(8192, 32, cuda_device)
    tmax = torch.full((8192,), 1e4, device=cuda_device)
    before = kernels.launches["closest_bf8"]
    hk = kernels.closest_bf8(b8, o, d, tmax)
    hp = kernels.closest_bf8_plain(b8, o, d, tmax)
    torch.cuda.synchronize()
    assert kernels.launches["closest_bf8"] == before + 1
    assert int((hp.tri >= 0).sum()) > 100
    for a, b in zip(hk, hp):
        assert torch.equal(a, b)
    dist = torch.full((8192,), 6.0, device=cuda_device)
    for flag in (False, True):
        got = kernels.occluded_bf8(b8, o, d, dist, opaque_only=flag)
        assert torch.equal(got, kernels.occluded_bf8_plain(
            b8, o, d, dist, opaque_only=flag))
    counts = kernels.work_counts(b8)
    counted = kernels.closest_bf8_per_ray(b8, o, d, tmax, counts=counts)
    for a, b in zip(counted, hk):          # the counted variant: same hits
        assert torch.equal(a, b)
    nodes, _, tris = counts.totals.tolist()
    assert nodes > 0 and 0 < tris < 8192 * tri.shape[0]
    assert 0 < int(counts.node_seen.sum()) <= nodes
    ids = b8.pages[:, 0, 6 * b8.block:7 * b8.block].contiguous()
    valid = ids.view(torch.int32).reshape(-1) >= 0
    assert 0 < int(counts.tri_seen.sum()) <= min(tris, int(valid.sum()))
    assert not bool(counts.tri_seen.bool()[~valid].any())


@pytest.mark.gpu
@pytest.mark.parametrize("soup", ["random", "padded", "single", "heightfield",
                                  "sah"])
def test_cuda_v4_kernels_match_plain(cuda_device, soup):
    """K3/K4 over the Morton tree built on the card (full, with empty
    subtrees, single-leaf, a real mesh) and over a static binary SBVH
    tree."""
    verts, tri = {"random": lambda: _random_tris(2000, 41),
                  "padded": lambda: _random_tris(1100, 42),
                  "single": lambda: _random_tris(30, 43),
                  "heightfield": lambda: _heightfield(64),
                  "sah": lambda: _random_tris(2000, 44)}[soup]()
    opaque = (np.arange(tri.shape[0]) % 2) == 0
    if soup == "sah":
        pb = bvh8.build_packet_bvh_sah(verts, tri, tri_opaque_np=opaque,
                                       spatial=True, device=cuda_device)
    else:
        pb = bvh8.build_packet_bvh(
            torch.as_tensor(verts, device=cuda_device),
            torch.as_tensor(tri, device=cuda_device),
            tri_opaque=torch.as_tensor(opaque, device=cuda_device))
        cpu = bvh8.build_packet_bvh(torch.as_tensor(verts),
                                    torch.as_tensor(tri),
                                    tri_opaque=torch.as_tensor(opaque))
        # the rebuild on the card orders the triangles as on the CPU
        b = pb.block
        assert torch.equal(
            pb.pages[:, 0, 6 * b:7 * b].contiguous().view(torch.int32).cpu(),
            cpu.pages[:, 0, 6 * b:7 * b].contiguous().view(torch.int32))
        assert torch.equal(pb.top_lo.cpu(), cpu.top_lo)
    o, d = _rays(8192, 45, cuda_device)
    tmax = torch.full((8192,), 1e4, device=cuda_device)
    before = dict(kernels.launches)
    hk = kernels.closest_v4(pb, o, d, tmax)
    hp = kernels.closest_v4_plain(pb, o, d, tmax)
    torch.cuda.synchronize()
    assert kernels.launches["closest_v4"] == before["closest_v4"] + 1
    if soup != "single":
        assert int((hp.tri >= 0).sum()) > 100
    for a, b in zip(hk, hp):
        assert torch.equal(a, b)
    dist = torch.full((8192,), 6.0, device=cuda_device)
    got = kernels.occluded_v4(pb, o, d, dist)
    assert kernels.launches["occluded_v4"] == before["occluded_v4"] + 1
    assert torch.equal(got, kernels.occluded_v4_plain(pb, o, d, dist))
    assert kernels.launches["closest_v4_per_ray"] == \
        before["closest_v4_per_ray"]
    counts = kernels.work_counts(pb)
    # the counted variant is the per-ray walk's: same hits
    counted = kernels.closest_v4_per_ray(pb, o, d, tmax, counts=counts)
    assert kernels.launches["closest_v4_per_ray"] == \
        before["closest_v4_per_ray"] + 1
    for a, b in zip(counted, hk):
        assert torch.equal(a, b)
    nodes, tris = counts.totals.tolist()
    assert nodes >= 8192 and tris < 8192 * tri.shape[0]
    assert 0 < int(counts.node_seen.sum()) <= pb.n_top
    ids = pb.pages[:, 0, 6 * pb.block:7 * pb.block].contiguous()
    valid = ids.view(torch.int32).reshape(-1) >= 0
    assert int(counts.tri_seen.sum()) <= min(tris, int(valid.sum()))
    assert not bool(counts.tri_seen.bool()[~valid].any())
    # degenerate lanes end at the root
    from pt_torch.render.integrator import _degenerate_masked
    dead = torch.zeros(8192, dtype=torch.bool, device=cuda_device)
    od, dd, td = _degenerate_masked(pb, o, d, 1e4, dead)
    counts = kernels.work_counts(pb)
    h = kernels.closest_v4_per_ray(pb, od.contiguous(), dd.contiguous(), td,
                                   counts=counts)
    assert counts.totals.tolist() == [8192, 0] and bool((h.tri == -1).all())


def _bits(h):
    return [a.view(torch.int32) if a.dtype == torch.float32 else a
            for a in h]


@pytest.mark.gpu
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("n", [1, 31, 33, 1000])
def test_cuda_v4_warp_kernels_match_per_ray(cuda_device, block, n):
    """The warp-cooperative K3/K4 against the per-ray arm on every lane:
    t, u, v bits, ids and occlusion, on a seeded soup with alpha tags and
    padded leaves, with lanes that fill no whole warp."""
    verts, tri = _random_tris(1100 if block == 64 else 2300, 50 + block)
    opaque = (np.arange(tri.shape[0]) % 3) != 0
    pb = bvh8.build_packet_bvh(
        torch.as_tensor(verts, device=cuda_device),
        torch.as_tensor(tri, device=cuda_device), block=block,
        tri_opaque=torch.as_tensor(opaque, device=cuda_device))
    assert pb.block == block
    o, d = _rays(4096, 51, cuda_device)
    o, d = o[:n].contiguous(), d[:n].contiguous()
    tmax = torch.full((n,), 1e4, device=cuda_device)
    dist = torch.linspace(0.5, 20.0, n, device=cuda_device)
    before = dict(kernels.launches)
    hw = kernels.closest_v4(pb, o, d, tmax)
    hr = kernels.closest_v4_per_ray(pb, o, d, tmax)
    ow = kernels.occluded_v4(pb, o, d, dist)
    orr = kernels.occluded_v4_per_ray(pb, o, d, dist)
    torch.cuda.synchronize()
    for k in ("closest_v4", "closest_v4_per_ray", "occluded_v4",
              "occluded_v4_per_ray"):
        assert kernels.launches[k] == before[k] + 1, k
    for a, b in zip(_bits(hw), _bits(hr)):
        assert torch.equal(a, b)
    assert torch.equal(ow, orr)
    if n == 1000:
        assert int((hr.tri >= 0).sum()) > 20 and 0 < int(orr.sum()) < n


@pytest.mark.gpu
def test_cuda_v4_warp_kernels_launch_nothing_on_no_rays(cuda_device):
    verts, tri = _random_tris(300, 52)
    pb = bvh8.build_packet_bvh(torch.as_tensor(verts, device=cuda_device),
                               torch.as_tensor(tri, device=cuda_device))
    empty = torch.empty((0, 3), device=cuda_device)
    none = torch.empty((0,), device=cuda_device)
    before = dict(kernels.launches)
    h = kernels.closest_v4(pb, empty, empty, none)
    occ = kernels.occluded_v4(pb, empty, empty, none)
    assert h.t.shape == (0,) and occ.shape == (0,) and occ.dtype == torch.bool
    assert kernels.launches == before


@pytest.mark.gpu
def test_cuda_v4_warp_kernels_on_a_static_sah_tree(cuda_device):
    """The static fallback at a large block: pages staged in many chunks."""
    verts, tri = _random_tris(3000, 53)
    opaque = (np.arange(3000) % 2) == 0
    pb = bvh8.build_packet_bvh_sah(verts, tri, tri_opaque_np=opaque,
                                   spatial=True, max_leaves=8,
                                   device=cuda_device)
    assert pb.block >= 512
    o, d = _rays(4096, 54, cuda_device)
    tmax = torch.full((4096,), 1e4, device=cuda_device)
    dist = torch.full((4096,), 6.0, device=cuda_device)
    for a, b in zip(_bits(kernels.closest_v4(pb, o, d, tmax)),
                    _bits(kernels.closest_v4_per_ray(pb, o, d, tmax))):
        assert torch.equal(a, b)
    assert torch.equal(kernels.occluded_v4(pb, o, d, dist),
                       kernels.occluded_v4_per_ray(pb, o, d, dist))


@pytest.mark.gpu
def test_cuda_animated_alpha_film_matches_cpu_film(cuda_device):
    """Two animated frames of a small alpha scene (Morton rebuild, K3/K4,
    the single-tree alpha loops) and its static variant (split trees,
    K1/K2) on the card against the CPU's plain versions."""
    import chip_smoke
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run.renderer import Renderer
    for animate in (True, False):
        films = {}
        for dev in (cuda_device, "cpu"):
            scene = chip_smoke.build_animated_scene(
                chip_smoke.port_namespace(), 12, 40, animate)
            r = Renderer(PathTracingSettings(bounce_count=3), device=dev)
            r.set_scene(scene, stream_textures=False)
            r.on_resize(32, 32)
            kernels.reset_launch_counts()
            for _ in range(2):
                r.update_scene_data(scene_changed=scene.update(1 / 24))
                r.render(1)
            if dev != "cpu":
                used = {k for k, v in kernels.launches.items() if v}
                assert used == ({"closest_v4"} if animate else
                                {"closest_bf8", "occluded_bf8"}), used
            films[str(dev)] = r.film_mean()
        a, b = films.values()
        assert np.isfinite(a).all()
        assert float(np.mean((a - b) ** 2)) < 1e-3


@pytest.mark.gpu
def test_cuda_wrapper_rejects_mixed_devices(cuda_device):
    verts, tri = _random_tris(500, 33)
    b8 = bvh8.build_bf8(bvh8.build_packet_bvh_sah(verts, tri, block=32,
                                                  device="cpu"))
    o, d = _rays(16, 34, cuda_device)
    with pytest.raises(ValueError):
        kernels.closest_bf8(b8, o, d, torch.full((16,), 1e4,
                                                 device=cuda_device))
    pb = bvh8.build_packet_bvh(torch.as_tensor(verts), torch.as_tensor(tri))
    far = torch.full((16,), 1e4, device=cuda_device)
    for fn in (kernels.closest_v4, kernels.occluded_v4,
               kernels.closest_v4_per_ray, kernels.occluded_v4_per_ray):
        with pytest.raises(ValueError):
            fn(pb, o, d, far)
    b = _instanced_structure("cpu")
    for fn in (kernels.closest_bf8i, kernels.occluded_bf8i,
               kernels.closest_bf8i_per_ray, kernels.occluded_bf8i_per_ray):
        with pytest.raises(ValueError):
            fn(b, o, d, far)


@pytest.mark.gpu
def test_cuda_film_matches_cpu_film(cuda_device):
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run.renderer import Renderer
    from pt_torch.scene.examples import make_heightfield_scene
    films = []
    for dev in (cuda_device, "cpu"):
        r = Renderer(PathTracingSettings(bounce_count=3), device=dev)
        r.set_scene(make_heightfield_scene(16), stream_textures=False)
        r.on_resize(32, 32)
        kernels.reset_launch_counts()
        r.render(1)
        if dev != "cpu":
            assert kernels.launches["closest_bf8"] == 3
            assert kernels.launches["occluded_bf8"] == 3
        films.append(r.film_mean())
    assert np.isfinite(films[0]).all()
    assert float(np.mean((films[0] - films[1]) ** 2)) < 1e-3


def _instanced_structure(device, alpha_mesh=None, n_segs=12, block=32):
    """`n_segs` instances of two wavy grids on a lattice (no overlaps), each
    with its own scale and turn, at leaves of `block` or more; mesh
    `alpha_mesh` is non-opaque."""
    import chip_smoke
    rng = np.random.default_rng(51)
    meshes = []
    for m, n in enumerate((14, 20)):
        pos, _, _, tris = chip_smoke._wavy_grid(n)
        opq = None if alpha_mesh is None else \
            np.full(len(tris), m != alpha_mesh, bool)
        meshes.append((pos, tris.astype(np.int32), opq))
    seg_t = np.tile(np.eye(4), (n_segs, 1, 1))
    for s in range(n_segs):
        ang = rng.uniform(0, 2 * np.pi)
        c, sn = np.cos(ang), np.sin(ang)
        seg_t[s, :3, :3] = rng.uniform(0.5, 1.9) * np.asarray(
            [[c, 0, sn], [0, 1, 0], [-sn, 0, c]])
        seg_t[s, :3, 3] = (6.0 * (s % 4) - 9, 0.2 * s, 6.0 * (s // 4) - 6)
    seg_mesh = [s % 2 for s in range(n_segs)]
    b = instanced.build_instanced_bf8(meshes, seg_mesh, seg_t, block,
                                      device=device)
    assert b is not None and b.pages.shape[0] < b.n_leaves
    return b


@pytest.mark.gpu
@pytest.mark.parametrize("alpha_mesh", [None, 1], ids=["opaque", "alpha"])
def test_cuda_bf8i_kernels_match_plain(cuda_device, alpha_mesh):
    """K5/K6 over a small instanced structure against their plain versions:
    ids, t, u and v bit-equal, with `raw_ids` and `opaque_only`."""
    b = _instanced_structure(cuda_device, alpha_mesh)
    rng = np.random.default_rng(52)
    n = 8192
    target = np.stack([rng.uniform(-11, 11, n), rng.uniform(0, 3, n),
                       rng.uniform(-8, 8, n)], -1)
    o = target + rng.normal(0, 1, (n, 3)) * 4 + [0, 6, 0]
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = torch.as_tensor(o.astype(np.float32), device=cuda_device)
    d = torch.as_tensor(d.astype(np.float32), device=cuda_device)
    tmax = torch.full((n,), 1e4, device=cuda_device)
    before = dict(kernels.launches)
    for raw in (False, True):
        hk = kernels.closest_bf8i(b, o, d, tmax, raw_ids=raw)
        hp = kernels.closest_bf8i_plain(b, o, d, tmax, raw_ids=raw)
        torch.cuda.synchronize()
        assert int((hp.tri >= 0).sum()) > 1000
        for x, y in zip(hk, hp):
            assert torch.equal(x, y)
    assert kernels.launches["closest_bf8i"] == before["closest_bf8i"] + 2
    if alpha_mesh is not None:
        assert bool((hk.tri[hk.tri >= 0] & bvh8.ALPHA_TRI_BIT).any())
    dist = torch.full((n,), 9.0, device=cuda_device)
    for flag in (False, True):
        got = kernels.occluded_bf8i(b, o, d, dist, opaque_only=flag)
        assert torch.equal(got, kernels.occluded_bf8i_plain(
            b, o, d, dist, opaque_only=flag))
        assert 0 < int(got.sum()) < n
    assert kernels.launches["occluded_bf8i"] == before["occluded_bf8i"] + 2
    counts = kernels.work_counts(b)
    counted = kernels.closest_bf8i_per_ray(b, o, d, tmax, raw_ids=True,
                                           counts=counts)
    assert kernels.launches["closest_bf8i_per_ray"] == \
        before["closest_bf8i_per_ray"] + 1
    for x, y in zip(counted, hk):          # the counted variant: same hits
        assert torch.equal(x, y)
    nodes, leaf_boxes, leaf_visits, tris = counts.totals.tolist()
    assert nodes >= n and 0 < leaf_visits <= leaf_boxes and tris > 0
    assert 0 < int(counts.leaf_seen.sum()) <= min(leaf_visits, b.n_leaves)
    ids = b.pages[:, 0, 6 * b.block:7 * b.block].contiguous()
    valid = ids.view(torch.int32).reshape(-1) >= 0
    assert 0 < int(counts.tri_seen.sum()) <= int(valid.sum())
    assert not bool(counts.tri_seen.bool()[~valid].any())
    counts = kernels.work_counts(b)
    kernels.occluded_bf8i_per_ray(b, o, d, dist, counts=counts)
    assert counts.totals[0] > 0 and counts.totals[2] > 0
    assert kernels.launches["occluded_bf8i_per_ray"] == \
        before["occluded_bf8i_per_ray"] + 1


def _instanced_rays(n, seed, device):
    """Rays from above the lattice of `_instanced_structure`, aimed at
    points among the instances."""
    rng = np.random.default_rng(seed)
    target = np.stack([rng.uniform(-11, 11, n), rng.uniform(0, 3, n),
                       rng.uniform(-8, 8, n)], -1)
    o = target + rng.normal(0, 1, (n, 3)) * 4 + [0, 6, 0]
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o.astype(np.float32), device=device),
            torch.as_tensor(d.astype(np.float32), device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("n", [1, 31, 33, 1000])
def test_cuda_bf8i_warp_kernels_match_per_ray(cuda_device, block, n):
    """The warp-cooperative K5/K6 against the per-ray arm and the plain
    warp schedule on every lane: t, u, v bits, ids (with and without
    `raw_ids`) and occlusion (with and without `opaque_only`), on the small
    instanced structure with an alpha mesh, with lanes that fill no whole
    warp; each wrapper counts its own launches."""
    b = _instanced_structure(cuda_device, alpha_mesh=1, block=block)
    assert b.block == block
    o, d = _instanced_rays(4096, 53, cuda_device)
    o, d = o[:n].contiguous(), d[:n].contiguous()
    tmax = torch.full((n,), 1e4, device=cuda_device)
    dist = torch.linspace(0.5, 14.0, n, device=cuda_device)
    for flag in (False, True):
        before = dict(kernels.launches)
        hw = kernels.closest_bf8i(b, o, d, tmax, raw_ids=flag)
        hr = kernels.closest_bf8i_per_ray(b, o, d, tmax, raw_ids=flag)
        ow = kernels.occluded_bf8i(b, o, d, dist, opaque_only=flag)
        orr = kernels.occluded_bf8i_per_ray(b, o, d, dist, opaque_only=flag)
        torch.cuda.synchronize()
        for k in ("closest_bf8i", "closest_bf8i_per_ray", "occluded_bf8i",
                  "occluded_bf8i_per_ray"):
            assert kernels.launches[k] == before[k] + 1, k
        hp, _ = kernels.closest_bf8i_warp_plain(b, o, d, tmax, raw_ids=flag)
        op, _ = kernels.occluded_bf8i_warp_plain(b, o, d, dist,
                                                 opaque_only=flag)
        for a, x, y in zip(_bits(hw), _bits(hr), _bits(hp)):
            assert torch.equal(a, x) and torch.equal(a, y)
        assert torch.equal(ow, orr) and torch.equal(ow, op)
        if n == 1000:
            assert int((hr.tri >= 0).sum()) > 100 and 0 < int(orr.sum()) < n


def sparse_page_structure(device):
    """36 instances of an 8-triangle wavy grid on a lattice at block 32: 36
    leaves over one shared page of 8 triangles padded out to 32 columns, as
    the alpha cards' trees are; half the triangles alpha-tagged. With
    coherent rays from above (`sparse_page_rays`) the page groups hold more
    rays than the page has triangles."""
    import chip_smoke
    pos, _, _, tris = chip_smoke._wavy_grid(3)
    opaque = np.arange(len(tris)) % 2 == 0
    seg_t = np.tile(np.eye(4), (36, 1, 1))
    for s in range(36):
        seg_t[s, :3, 3] = (2.5 * (s % 6), 0.1 * s, 2.5 * (s // 6))
    b = instanced.build_instanced_bf8([(pos, tris.astype(np.int32), opaque)],
                                      [0] * 36, seg_t, device=device)
    assert b.pages.shape[0] == 1 and b.n_leaves == 36 and b.block == 32
    return b


def sparse_page_rays(n, device):
    """Rays from above the lattice of `sparse_page_structure`, neighbours in
    neighbouring lanes."""
    side = int(np.ceil(np.sqrt(n)))
    gx, gz = np.meshgrid(np.linspace(-1.2, 13.7, side),
                         np.linspace(-1.2, 13.7, side), indexing="ij")
    o = np.stack([gx.ravel(), np.full(side * side, 5.0), gz.ravel()],
                 -1)[:n]
    d = np.tile(np.asarray([[0.05, -1.0, 0.03]]), (n, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o.astype(np.float32), device=device),
            torch.as_tensor(d.astype(np.float32), device=device))


@pytest.mark.gpu
def test_cuda_bf8i_warp_kernels_on_sparse_pages(cuda_device):
    """A page of 8 triangles tested by groups of up to 32 rays: the warp
    kernels test such chunks column by column on each ray's own lane; bits
    and occlusion equal the per-ray arm's and the plain schedule's."""
    b = sparse_page_structure(cuda_device)
    n = 4096
    o, d = sparse_page_rays(n, cuda_device)
    tmax = torch.full((n,), 1e4, device=cuda_device)
    dist = torch.linspace(0.5, 9.0, n, device=cuda_device)
    for flag in (False, True):
        hw = kernels.closest_bf8i(b, o, d, tmax, raw_ids=flag)
        hr = kernels.closest_bf8i_per_ray(b, o, d, tmax, raw_ids=flag)
        hp, sched = kernels.closest_bf8i_warp_plain(b, o, d, tmax,
                                                    raw_ids=flag)
        for a, x, y in zip(_bits(hw), _bits(hr), _bits(hp)):
            assert torch.equal(a, x) and torch.equal(a, y)
        assert sched.warp_tests < sched.ray_chunk_tests
        ow = kernels.occluded_bf8i(b, o, d, dist, opaque_only=flag)
        orr = kernels.occluded_bf8i_per_ray(b, o, d, dist, opaque_only=flag)
        op, _ = kernels.occluded_bf8i_warp_plain(b, o, d, dist,
                                                 opaque_only=flag)
        assert torch.equal(ow, orr) and torch.equal(ow, op)
        assert 0 < int(orr.sum()) < n
    assert int((hr.tri >= 0).sum()) > n // 4


@pytest.mark.gpu
def test_cuda_bf8i_warp_kernels_launch_nothing_on_no_rays(cuda_device):
    b = _instanced_structure(cuda_device)
    empty = torch.empty((0, 3), device=cuda_device)
    none = torch.empty((0,), device=cuda_device)
    before = dict(kernels.launches)
    h = kernels.closest_bf8i(b, empty, empty, none)
    occ = kernels.occluded_bf8i(b, empty, empty, none)
    assert h.t.shape == (0,) and occ.shape == (0,) and occ.dtype == torch.bool
    assert kernels.launches == before


@pytest.mark.gpu
def test_cuda_instanced_film_matches_cpu_film(cuda_device):
    """A small instanced alpha scene (K5/K6 over the full tree and both
    instanced subset trees) on the card against the CPU's plain versions."""
    import chip_smoke
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run.renderer import Renderer
    films = []
    for dev in (cuda_device, "cpu"):
        scene = chip_smoke.build_instanced_scene(
            chip_smoke.port_namespace(), 6, 12, alpha=True)
        r = Renderer(PathTracingSettings(bounce_count=3), device=dev,
                     instancing="shared")
        r.set_scene(scene, stream_textures=False)
        r.on_resize(32, 32)
        kernels.reset_launch_counts()
        r.render(1)
        sp = r.accel.alpha_split
        assert {type(x).__name__ for x in (r.accel.bvh, sp.bvh_opaque,
                                           sp.bvh_alpha)} == {"BF8Instanced"}
        if dev != "cpu":
            used = {k: v for k, v in kernels.launches.items() if v}
            assert used == {"closest_bf8i": 27, "occluded_bf8i": 3}, used
        films.append(r.film_mean())
    assert np.isfinite(films[0]).all() and films[0].max() > 0
    assert float(np.mean((films[0] - films[1]) ** 2)) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("soup", ["random", "heightfield"])
def test_cuda_archive_kernels_match_plain(cuda_device, soup):
    """closest_ordered over an SAH tree and a Morton tree, and the four
    BF8V6 kernels over the SBVH's BF8V6, against their plain versions; the
    counted variants give the same hits; dead lanes end at the root."""
    from pt_torch.render.integrator import _degenerate_masked
    verts, tri = (_random_tris(2000, 61) if soup == "random"
                  else _heightfield(64))
    opaque = (np.arange(tri.shape[0]) % 2) == 0
    sah = bvh8.build_packet_bvh_sah(verts, tri, device=cuda_device)
    morton = bvh8.build_packet_bvh(torch.as_tensor(verts, device=cuda_device),
                                   torch.as_tensor(tri, device=cuda_device))
    v6 = archive.build_bf8_v6(bvh8.build_packet_bvh_sah(
        verts, tri, block=32, max_leaves=8192, tri_opaque_np=opaque,
        spatial=True, device=cuda_device))
    o, d = _rays(8192, 62, cuda_device)
    tmax = torch.full((8192,), 1e4, device=cuda_device)
    dead = torch.zeros(8192, dtype=torch.bool, device=cuda_device)
    runs = [(kernels.closest_ordered, sah), (kernels.closest_ordered, morton),
            (kernels.closest_v6, v6), (kernels.closest_v6k2, v6),
            (kernels.closest_v7, v6)]
    for fn, bvh in runs:
        before = kernels.launches[fn.__name__]
        hk = fn(bvh, o, d, tmax)
        hp = getattr(kernels, fn.__name__ + "_plain")(bvh, o, d, tmax)
        torch.cuda.synchronize()
        assert kernels.launches[fn.__name__] == before + 1
        assert int((hp.tri >= 0).sum()) > 100
        for a, b in zip(hk, hp):
            assert torch.equal(a, b), fn.__name__
        # closest_v6's counted variant is its per-ray design's
        counted = getattr(kernels, fn.__name__ + "_per_ray", fn)
        counts = kernels.work_counts(bvh)
        for a, b in zip(counted(bvh, o, d, tmax, counts=counts), hk):
            assert torch.equal(a, b)
        assert 0 < int(counts.totals[-1]) < 8192 * tri.shape[0]
        od, dd, td = _degenerate_masked(bvh, o, d, 1e4, dead)
        counts = kernels.work_counts(bvh)
        h = counted(bvh, od.contiguous(), dd.contiguous(), td, counts=counts)
        assert int(counts.totals[0]) == 8192 and int(counts.totals[-1]) == 0
        assert bool((h.tri == -1).all())
    dist = torch.full((8192,), 6.0, device=cuda_device)
    got = kernels.occluded_v6(v6, o, d, dist)
    assert torch.equal(got, kernels.occluded_v6_plain(v6, o, d, dist))
    assert 0 < int(got.sum()) < 8192
    # the warp v6k2 and v7 (at windows 1 and 8) bit-equal to their per-ray
    # arms and their plain warp schedules, each arm counting its launches
    for name, kw in V6_LIST_WALKS:
        before = dict(kernels.launches)
        hw = getattr(kernels, name)(v6, o, d, tmax, **kw)
        hr = getattr(kernels, name + "_per_ray")(v6, o, d, tmax, **kw)
        torch.cuda.synchronize()
        for k in (name, name + "_per_ray"):
            assert kernels.launches[k] == before[k] + 1, (k, kw)
        hp, _ = getattr(kernels, name + "_warp_plain")(v6, o, d, tmax, **kw)
        for a, x, y in zip(_bits(hw), _bits(hr), _bits(hp)):
            assert torch.equal(a, x) and torch.equal(a, y), (name, kw)


# the warp kernels of v6_warp_kernels.cu, with their window
V6_LIST_WALKS = (("closest_v6k2", {}), ("closest_v7", {"window": 1}),
                 ("closest_v7", {"window": 8}))


@pytest.mark.gpu
@pytest.mark.parametrize("walk", range(len(V6_LIST_WALKS)))
@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("n", [1, 31, 33, 1000])
def test_cuda_v6_list_warp_kernels_match_per_ray(cuda_device, walk, block,
                                                 n):
    """The warp closest_v6k2 and closest_v7 against their per-ray arm and
    the plain warp schedule on every lane (t, u, v bits and ids), at leaves
    of `block`, with lanes that fill no whole warp."""
    tree = bf8_walk_trees(cuda_device, block)["v6"]
    name, kw = V6_LIST_WALKS[walk]
    o, d = _rays(4096, 84, cuda_device)
    o, d = o[:n].contiguous(), d[:n].contiguous()
    tmax = torch.full((n,), 1e4, device=cuda_device)
    hw = getattr(kernels, name)(tree, o, d, tmax, **kw)
    hr = getattr(kernels, name + "_per_ray")(tree, o, d, tmax, **kw)
    hp, _ = getattr(kernels, name + "_warp_plain")(tree, o, d, tmax, **kw)
    for a, x, y in zip(_bits(hw), _bits(hr), _bits(hp)):
        assert torch.equal(a, x) and torch.equal(a, y)
    if n == 1000:
        assert int((hr.tri >= 0).sum()) > 20


@pytest.mark.gpu
def test_cuda_v6_list_warp_kernels_on_sparse_leaves_and_bad_trees(
        cuda_device):
    """Leaves of 8 triangles under groups of up to 32 rays, tested column by
    column: bits equal the per-ray arm's and the plain schedule's. Pages
    the warp kernels cannot stage, and a window below 1, raise and launch
    nothing: no fallback to the per-ray kernel."""
    import dataclasses
    n = 4096
    o, d = sparse_leaf_rays(n, cuda_device)
    tmax = torch.full((n,), 1e4, device=cuda_device)
    tree = sparse_leaf_trees(cuda_device)[1]
    for name, kw in V6_LIST_WALKS:
        hw = getattr(kernels, name)(tree, o, d, tmax, **kw)
        hr = getattr(kernels, name + "_per_ray")(tree, o, d, tmax, **kw)
        hp, sched = getattr(kernels, name + "_warp_plain")(tree, o, d, tmax,
                                                           **kw)
        for a, x, y in zip(_bits(hw), _bits(hr), _bits(hp)):
            assert torch.equal(a, x) and torch.equal(a, y)
        assert sched.warp_tests < sched.ray_chunk_tests // 2
    off = torch.empty(tree.pages.numel() + 1, device=cuda_device)[1:]
    off = off.view(tree.pages.shape).copy_(tree.pages)
    before = dict(kernels.launches)
    for name, kw in V6_LIST_WALKS:
        for bad in (dataclasses.replace(tree, pages=off),
                    dataclasses.replace(tree, block=48)):
            with pytest.raises(ValueError, match="multiples of 32"):
                getattr(kernels, name)(bad, o, d, tmax, **kw)
    with pytest.raises(ValueError, match="window"):
        kernels.closest_v7(tree, o, d, tmax, window=0)
    assert kernels.launches == before


@pytest.mark.gpu
def test_cuda_bf8_v6_film_matches_cpu_film(cuda_device):
    """The Heightfield with its tree swapped for a BF8V6: every trace of the
    card's render goes through closest_v6 / occluded_v6, and its film is
    within MSE 1e-3 of the CPU's."""
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run.renderer import Renderer
    from pt_torch.scene.examples import make_heightfield_scene
    films = []
    for dev in (cuda_device, "cpu"):
        r = Renderer(PathTracingSettings(bounce_count=3), device=dev)
        r.set_scene(make_heightfield_scene(16), stream_textures=False)
        r.on_resize(32, 32)
        archive.swap_in_bf8_v6(r)
        kernels.reset_launch_counts()
        archive.reset_call_counts()
        r.render(1)
        if dev != "cpu":
            used = {k: v for k, v in kernels.launches.items() if v}
            assert used == {"closest_v6": 3, "occluded_v6": 3}, used
            assert archive.launches == dict(
                archive.calls, packet_closest_v6=3, packet_occluded_v6=3)
        films.append(r.film_mean())
    assert np.isfinite(films[0]).all()
    assert float(np.mean((films[0] - films[1]) ** 2)) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("soup", ["random", "heightfield"])
def test_cuda_pops_variant_matches_plain_walk(cuda_device, soup):
    """K1's pops launch (the warp kernel's pops instance) and its per-ray
    arm: hits bit-equal to K1's, pops equal to each other and to
    `closest_bf8_walk_plain`'s on every lane and summing to a counted
    launch's node visits plus leaf retests; each counts its own launch; the
    drain layout uses the library's threads per block, which the kernel
    source states."""
    from pt_torch.benches import drain_sim
    verts, tri = (_random_tris(2000, 71) if soup == "random"
                  else _heightfield(64))
    b8 = bvh8.build_bf8(bvh8.build_packet_bvh_sah(
        verts, tri, block=32, max_leaves=8192, spatial=True,
        device=cuda_device))
    n = 8000                                   # no multiple of 32
    o, d = _rays(n, 72, cuda_device)
    tmax = torch.full((n,), 1e4, device=cuda_device)
    before = dict(kernels.launches)
    hk = kernels.closest_bf8(b8, o, d, tmax)
    pops = torch.full((n,), -7, dtype=torch.int32, device=cuda_device)
    hp = kernels.closest_bf8(b8, o, d, tmax, pops=pops)
    pops_r = torch.full((n,), -7, dtype=torch.int32, device=cuda_device)
    hr = kernels.closest_bf8_per_ray(b8, o, d, tmax, pops=pops_r)
    torch.cuda.synchronize()
    for k in ("closest_bf8", "closest_bf8_pops", "closest_bf8_pops_per_ray"):
        assert kernels.launches[k] == before[k] + 1, k
    for a, b, c in zip(_bits(hp), _bits(hk), _bits(hr)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(pops, pops_r)
    hw, pw = kernels.closest_bf8_walk_plain(b8, o, d, tmax)
    assert torch.equal(pops, pw)
    for a, b in zip(hw, hk):
        assert torch.equal(a, b)
    counts = kernels.work_counts(b8)
    kernels.closest_bf8_per_ray(b8, o, d, tmax, counts=counts)
    nodes, leaf_boxes, _ = counts.totals.tolist()
    assert int(pops.sum()) == nodes + leaf_boxes
    threads = kernels.bf8_threads_per_block(cuda_device)
    assert threads == kernels.bf8_threads_per_block("cpu")
    rounds, done = drain_sim.done_rounds_of(b8, o, d, tmax=1e4)
    assert done.shape == (-(-n // threads), threads // 32)
    assert (rounds == done.max(axis=1)).all()
    for fn in (kernels.closest_bf8, kernels.closest_bf8_per_ray):
        with pytest.raises(ValueError):
            fn(b8, o, d, tmax, pops=pops.cpu())


def bf8_walk_trees(device, block, seed=81):
    """{"bf8": an SBVH's BF8 tree over a seeded soup with every third
    triangle alpha-tagged, at leaves of `block`, "v6": its BF8V6}."""
    verts, tri = _random_tris(700 * block // 32, seed)
    opaque = (np.arange(tri.shape[0]) % 3) != 0
    b8 = bvh8.build_bf8(bvh8.build_packet_bvh_sah(
        verts, tri, block=block, max_leaves=8192, tri_opaque_np=opaque,
        spatial=True, device=device))
    assert b8 is not None and b8.block == block
    return {"bf8": b8, "v6": archive.bf8_v6_of(b8)}


# the warp kernel behind each walk of bf8_warp_kernels.cu
BF8_WALKS = {"bf8": "closest_bf8", "v6": "closest_v6"}


def leaf_tree(device, leaves, pad=0.0, blk=32):
    """A BF8 tree of one wide node over up to 8 leaves of `blk` columns, and
    its BF8V6. `leaves`: per leaf its triangles' corners (k, 3, 3), ids (k,)
    and alpha tags (k,), padded out to `blk` columns; each leaf's box (child
    and leaf bounds alike) is its triangles' widened by `pad`."""
    n = len(leaves)
    v0 = np.zeros((n * blk, 3), np.float32)
    e1, e2 = np.zeros_like(v0), np.zeros_like(v0)
    ids = np.full(n * blk, -1, np.int32)
    alpha = np.zeros(n * blk, bool)
    lo, hi = [], []
    for s, (corners, tri_ids, tri_alpha) in enumerate(leaves):
        rows = slice(s * blk, s * blk + len(tri_ids))
        v0[rows] = corners[:, 0]
        e1[rows] = corners[:, 1] - corners[:, 0]
        e2[rows] = corners[:, 2] - corners[:, 0]
        ids[rows] = tri_ids
        alpha[rows] = tri_alpha
        lo.append(corners.reshape(-1, 3).min(axis=0) - pad)
        hi.append(corners.reshape(-1, 3).max(axis=0) + pad)
    lo, hi = np.stack(lo).astype(np.float32), np.stack(hi).astype(np.float32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    b8 = bvh8.BF8BVH(
        c_lo=t(np.concatenate([lo, np.full((8 - n, 3), 1e30, np.float32)])),
        c_hi=t(np.concatenate([hi, np.full((8 - n, 3), 1e30, np.float32)])),
        c_ent=t(np.concatenate([bvh8.LEAF_BIT + np.arange(n, dtype=np.int32),
                                np.full(8 - n, -1, np.int32)])),
        l_lo=t(lo), l_hi=t(hi),
        pages=t(bvh8._woop_pages(v0, e1, e2, ids, n, blk, tri_alpha=alpha)),
        n8=1, n_leaves=n, block=blk, root_lo=t(lo.min(axis=0)),
        root_hi=t(hi.max(axis=0)), depth=1)
    return b8, archive.bf8_v6_of(b8)


def sparse_leaf_trees(device):
    """`leaf_tree` over 8 leaves, each an 8-triangle wavy grid (every other
    triangle alpha-tagged) padded out to 32 columns, as the alpha subset
    trees' leaves are. With coherent rays from above (`sparse_leaf_rays`)
    the leaf groups hold more rays than the leaf has triangles."""
    import chip_smoke
    pos, _, _, tris = chip_smoke._wavy_grid(3)
    k = len(tris)
    return leaf_tree(device, [
        ((pos + [2.5 * (s % 4), 0.1 * s, 2.5 * (s // 4)])[tris],
         np.arange(k) + k * s, np.arange(k) % 2 == 1) for s in range(8)])


def first_chunk_trees(device):
    """`leaf_tree` over 8 leaves of 128 columns (four chunks), each a wavy
    grid on top (columns 0-7) over 15 copies of it lowered one below the
    other: a ray from above through a leaf's interior (`first_chunk_rays`)
    is occluded by the top grid, in the leaf's first chunk."""
    import chip_smoke
    pos, _, _, tris = chip_smoke._wavy_grid(3)
    k = len(tris)
    stack = np.concatenate([pos[tris] - [0, 0.6 + 0.05 * j, 0] if j else
                            pos[tris] for j in range(16)])
    none = np.zeros(16 * k, bool)
    return leaf_tree(device, [
        (stack + [2.5 * (s % 4), 0.1 * s, 2.5 * (s // 4)],
         np.arange(16 * k) + 16 * k * s, none) for s in range(8)], blk=128)


def first_chunk_rays(n, device):
    """Rays from above through the interiors of `first_chunk_trees`'
    leaves, neighbours in neighbouring lanes."""
    rng = np.random.default_rng(84)
    leaf = np.sort(rng.integers(0, 8, n))
    o = np.stack([rng.uniform(-0.8, 0.8, n) + 2.5 * (leaf % 4),
                  np.full(n, 5.0),
                  rng.uniform(-0.8, 0.8, n) + 2.5 * (leaf // 4)], -1)
    d = np.tile(np.asarray([[0.01, -1.0, 0.02]]), (n, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o.astype(np.float32), device=device),
            torch.as_tensor(d.astype(np.float32), device=device))


def sparse_leaf_rays(n, device):
    """Rays from above the leaves of `sparse_leaf_trees`, neighbours in
    neighbouring lanes."""
    side = int(np.ceil(np.sqrt(n)))
    gx, gz = np.meshgrid(np.linspace(-1.2, 8.7, side),
                         np.linspace(-1.2, 3.7, side), indexing="ij")
    o = np.stack([gx.ravel(), np.full(side * side, 5.0), gz.ravel()],
                 -1)[:n]
    d = np.tile(np.asarray([[0.05, -1.0, 0.03]]), (n, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o.astype(np.float32), device=device),
            torch.as_tensor(d.astype(np.float32), device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("walk", list(BF8_WALKS))
@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("n", [1, 31, 33, 1000])
def test_cuda_bf8_warp_kernels_match_per_ray(cuda_device, walk, block, n):
    """The warp K1 and closest_v6 against their per-ray arm and the plain
    warp schedule on every lane (t, u, v bits and ids), at leaves of
    `block`, with lanes that fill no whole warp; each wrapper counts its own
    launches."""
    tree = bf8_walk_trees(cuda_device, block)[walk]
    name = BF8_WALKS[walk]
    o, d = _rays(4096, 82, cuda_device)
    o, d = o[:n].contiguous(), d[:n].contiguous()
    tmax = torch.full((n,), 1e4, device=cuda_device)
    before = dict(kernels.launches)
    hw = getattr(kernels, name)(tree, o, d, tmax)
    hr = getattr(kernels, name + "_per_ray")(tree, o, d, tmax)
    torch.cuda.synchronize()
    for k in (name, name + "_per_ray"):
        assert kernels.launches[k] == before[k] + 1, k
    hp, _ = getattr(kernels, name + "_warp_plain")(tree, o, d, tmax)
    for a, x, y in zip(_bits(hw), _bits(hr), _bits(hp)):
        assert torch.equal(a, x) and torch.equal(a, y)
    if n == 1000:
        assert int((hr.tri >= 0).sum()) > 20


@pytest.mark.gpu
def test_cuda_bf8_warp_kernels_on_sparse_leaves(cuda_device):
    """Leaves of 8 triangles tested by groups of up to 32 rays: the warp
    kernels test such chunks column by column on each ray's own lane; bits
    equal the per-ray arm's and the plain schedule's."""
    n = 4096
    o, d = sparse_leaf_rays(n, cuda_device)
    tmax = torch.full((n,), 1e4, device=cuda_device)
    for tree, name in zip(sparse_leaf_trees(cuda_device),
                          BF8_WALKS.values()):
        hw = getattr(kernels, name)(tree, o, d, tmax)
        hr = getattr(kernels, name + "_per_ray")(tree, o, d, tmax)
        hp, sched = getattr(kernels, name + "_warp_plain")(tree, o, d, tmax)
        for a, x, y in zip(_bits(hw), _bits(hr), _bits(hp)):
            assert torch.equal(a, x) and torch.equal(a, y)
        assert sched.warp_tests < sched.ray_chunk_tests // 2
        assert int((hr.tri >= 0).sum()) > n // 4


@pytest.mark.gpu
def test_cuda_bf8_warp_kernels_raise_on_unstageable_trees(cuda_device):
    """closest_bf8 and closest_v6 raise on pages the warp kernels cannot
    stage (a base off 16 bytes, a block off 32) and launch nothing: no
    fallback to the per-ray kernel."""
    import dataclasses
    trees = bf8_walk_trees(cuda_device, 32)
    o, d = _rays(64, 83, cuda_device)
    tmax = torch.full((64,), 1e4, device=cuda_device)
    for walk, name in BF8_WALKS.items():
        tree = trees[walk]
        pages = tree.pages
        off = torch.empty(pages.numel() + 1, device=cuda_device)[1:]
        off = off.view(pages.shape).copy_(pages)
        assert off.data_ptr() % 16 != 0
        before = dict(kernels.launches)
        for bad in (dataclasses.replace(tree, pages=off),
                    dataclasses.replace(tree, block=48)):
            with pytest.raises(ValueError, match="multiples of 32"):
                getattr(kernels, name)(bad, o, d, tmax)
        assert kernels.launches == before


@pytest.mark.gpu
def test_cuda_bench_pops_hits_equal_warp_k1(cuda_device):
    """B1/B2 (the benches' pops launches, K1's warp kernel) on every
    bounce's wavefront of a small budget frame: the bench's own launch
    counted, and the per-ray arm's pops launch with pops equal to the
    bench's and hits bit-equal to the warp K1's on every lane."""
    from pt_torch.benches import budget
    kernels.reset_launch_counts()
    res = budget.main(device=cuda_device, width=32, bounces=3, n=16,
                      n_sample=1024, emit=lambda line: None)
    assert kernels.launches["closest_bf8_pops"] == len(res["bounces"])
    b8 = res["tree"]
    for row in res["bounces"]:
        o, d, tmax = row["wavefront"]
        o, d = o.contiguous(), d.contiguous()
        limit = torch.full((o.shape[0],), float(tmax), device=cuda_device)
        pops = torch.empty(o.shape[0], dtype=torch.int32, device=cuda_device)
        hp = kernels.closest_bf8_per_ray(b8, o, d, limit, pops=pops)
        hk = kernels.closest_bf8(b8, o, d, limit)
        for a, b in zip(_bits(hp), _bits(hk)):
            assert torch.equal(a, b)
        assert torch.equal(pops, row["pops"])
    assert kernels.launches["closest_bf8_pops_per_ray"] == len(res["bounces"])


# the warp kernel behind each walk of bf8_occluded_warp_kernels.cu
BF8_OCC_WALKS = {"bf8": "occluded_bf8", "v6": "occluded_v6"}


def _occ_flags(walk):
    """The keyword sets to run a walk's occlusion with: K2 with opaque_only
    off and on; pt's v6 has no flag."""
    return ({}, {"opaque_only": True}) if walk == "bf8" else ({},)


def _occ_arms(name, tree, o, d, dist, **kw):
    """The warp kernel, its per-ray arm and its plain warp schedule on one
    ray set: (warp, per-ray, plain, schedule); each wrapper counts its own
    launch."""
    before = dict(kernels.launches)
    ow = getattr(kernels, name)(tree, o, d, dist, **kw)
    orr = getattr(kernels, name + "_per_ray")(tree, o, d, dist, **kw)
    torch.cuda.synchronize()
    for k in (name, name + "_per_ray"):
        assert kernels.launches[k] == before[k] + 1, k
    op, sched = getattr(kernels, name + "_warp_plain")(tree, o, d, dist, **kw)
    return ow, orr, op, sched


@pytest.mark.gpu
@pytest.mark.parametrize("walk", list(BF8_OCC_WALKS))
@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("n", [1, 31, 33, 1000])
def test_cuda_bf8_occluded_warp_kernels_match_per_ray(cuda_device, walk,
                                                      block, n):
    """The warp K2 (opaque_only off and on) and occluded_v6 against their
    per-ray arm and the plain warp schedule on every lane, at leaves of
    `block`, with lanes that fill no whole warp."""
    tree = bf8_walk_trees(cuda_device, block)[walk]
    name = BF8_OCC_WALKS[walk]
    o, d = _rays(4096, 85, cuda_device)
    o, d = o[:n].contiguous(), d[:n].contiguous()
    dist = torch.as_tensor(np.random.default_rng(86).uniform(1, 25, n)
                           .astype(np.float32), device=cuda_device)
    for kw in _occ_flags(walk):
        ow, orr, op, _ = _occ_arms(name, tree, o, d, dist, **kw)
        assert ow.dtype == torch.bool
        assert torch.equal(ow, orr) and torch.equal(ow, op)
        if n == 1000:
            assert 0 < int(orr.sum()) < n


@pytest.mark.gpu
def test_cuda_bf8_occluded_warp_kernels_on_sparse_and_first_chunk_leaves(
        cuda_device):
    """Leaves of 8 triangles tested by groups of up to 32 rays (the column
    mode), and leaves of 128 columns whose first chunk occludes every
    member (the group stops staging): the bools equal the per-ray arm's
    and the plain schedule's."""
    n = 4096
    dist = torch.full((n,), 1e4, device=cuda_device)
    for trees, rays in ((sparse_leaf_trees, sparse_leaf_rays),
                        (first_chunk_trees, first_chunk_rays)):
        o, d = rays(n, cuda_device)
        for tree, (walk, name) in zip(trees(cuda_device),
                                      BF8_OCC_WALKS.items()):
            for kw in _occ_flags(walk):
                ow, orr, op, sched = _occ_arms(name, tree, o, d, dist, **kw)
                assert torch.equal(ow, orr) and torch.equal(ow, op)
                assert int(orr.sum()) > n // 4
                if trees is sparse_leaf_trees:
                    assert sched.warp_tests < sched.ray_chunk_tests // 2
                else:
                    assert sched.chunk_loads == 2 * sched.groups


@pytest.mark.gpu
def test_cuda_bf8_occluded_warp_kernels_launch_nothing_on_no_rays(
        cuda_device):
    trees = bf8_walk_trees(cuda_device, 32)
    empty = torch.empty((0, 3), device=cuda_device)
    none = torch.empty((0,), device=cuda_device)
    before = dict(kernels.launches)
    for walk, name in BF8_OCC_WALKS.items():
        occ = getattr(kernels, name)(trees[walk], empty, empty, none)
        assert occ.shape == (0,) and occ.dtype == torch.bool
    assert kernels.launches == before


@pytest.mark.gpu
def test_cuda_bf8_occluded_warp_kernels_raise_on_unstageable_trees(
        cuda_device):
    """occluded_bf8 and occluded_v6 raise on pages the warp kernels cannot
    stage (a base off 16 bytes, a block off 32) and launch nothing: no
    fallback to the per-ray kernel."""
    import dataclasses
    trees = bf8_walk_trees(cuda_device, 32)
    o, d = _rays(64, 87, cuda_device)
    dist = torch.full((64,), 20.0, device=cuda_device)
    for walk, name in BF8_OCC_WALKS.items():
        tree = trees[walk]
        pages = tree.pages
        off = torch.empty(pages.numel() + 1, device=cuda_device)[1:]
        off = off.view(pages.shape).copy_(pages)
        assert off.data_ptr() % 16 != 0
        before = dict(kernels.launches)
        for bad in (dataclasses.replace(tree, pages=off),
                    dataclasses.replace(tree, block=48)):
            with pytest.raises(ValueError, match="multiples of 32"):
                getattr(kernels, name)(bad, o, d, dist)
        assert kernels.launches == before


# ------------------------------------------------ the warp closest_ordered


def ordered_trees(device):
    """{name: PacketBVH} over a seeded soup with every third triangle
    alpha-tagged: Morton trees at blocks 64 and 128 (built on the card,
    padded subtrees) and SAH trees at blocks 32, 64 and 1024 (32 chunks a
    page)."""
    verts, tri = _random_tris(6200, 91)
    opaque = (np.arange(tri.shape[0]) % 3) != 0
    trees = {f"morton {b}": bvh8.build_packet_bvh(
        torch.as_tensor(verts, device=device),
        torch.as_tensor(tri, device=device), block=b,
        tri_opaque=torch.as_tensor(opaque, device=device)) for b in (64, 128)}
    trees.update({f"sah {b}": bvh8.build_packet_bvh_sah(
        verts, tri, block=b, tri_opaque_np=opaque, device=device)
        for b in (32, 64, 1024)})
    for name, tree in trees.items():
        assert tree.block == int(name.split()[1]), name
        assert tree.depth <= kernels.ORDERED_STACK, name
    return trees


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 33, 1000])
def test_cuda_ordered_warp_kernel_matches_per_ray(cuda_device, n):
    """The warp closest_ordered against its per-ray arm and the plain warp
    schedule on every lane (t, u, v bits and ids) over every tree of
    `ordered_trees`, with lanes that fill no whole warp; each wrapper counts
    its own launches; a counted call runs the per-ray arm."""
    o, d = _rays(4096, 92, cuda_device)
    o, d = o[:n].contiguous(), d[:n].contiguous()
    tmax = torch.as_tensor(np.random.default_rng(93).uniform(5, 40, n)
                           .astype(np.float32), device=cuda_device)
    for name, tree in ordered_trees(cuda_device).items():
        before = dict(kernels.launches)
        hw = kernels.closest_ordered(tree, o, d, tmax)
        hr = kernels.closest_ordered_per_ray(tree, o, d, tmax)
        counts = kernels.work_counts(tree)
        hc = kernels.closest_ordered(tree, o, d, tmax, counts=counts)
        torch.cuda.synchronize()
        assert kernels.launches["closest_ordered"] == \
            before["closest_ordered"] + 1, name
        assert kernels.launches["closest_ordered_per_ray"] == \
            before["closest_ordered_per_ray"] + 2, name
        hp, sched = kernels.closest_ordered_warp_plain(tree, o, d, tmax)
        for a, x, y, z in zip(_bits(hw), _bits(hr), _bits(hp), _bits(hc)):
            assert torch.equal(a, x) and torch.equal(a, y), name
            assert torch.equal(a, z), name
        assert counts.totals.tolist() == [sched.node_visits,
                                          sched.tri_tests], name
        if n == 1000:
            assert 20 < int((hr.tri >= 0).sum()) < n, name


def binary_leaf_tree(device, leaves, pad, blk=32):
    """A PacketBVH over three leaves of `blk` columns, root -> (leaf 0,
    node -> (leaf 1, leaf 2)) in preorder. `leaves`: per leaf its
    triangles' corners (k, 3, 3) and ids (k,); each leaf's box is its
    triangles' widened by `pad`."""
    v0 = np.zeros((3 * blk, 3), np.float32)
    e1, e2 = np.zeros_like(v0), np.zeros_like(v0)
    ids = np.full(3 * blk, -1, np.int32)
    lo, hi = [], []
    for s, (corners, tri_ids) in enumerate(leaves):
        rows = slice(s * blk, s * blk + len(tri_ids))
        v0[rows] = corners[:, 0]
        e1[rows] = corners[:, 1] - corners[:, 0]
        e2[rows] = corners[:, 2] - corners[:, 0]
        ids[rows] = tri_ids
        lo.append(corners.reshape(-1, 3).min(axis=0) - pad)
        hi.append(corners.reshape(-1, 3).max(axis=0) + pad)
    lo, hi = np.stack(lo), np.stack(hi)
    top_lo = np.stack([lo.min(0), lo[0], lo[1:].min(0), lo[1], lo[2]])
    top_hi = np.stack([hi.max(0), hi[0], hi[1:].max(0), hi[1], hi[2]])

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype),
                               device=device)
    return bvh8.PacketBVH(
        top_lo=t(top_lo, np.float32), top_hi=t(top_hi, np.float32),
        top_miss=t([5, 2, 5, 4, 5], np.int32),
        top_leaf=t([-1, 0, -1, 1, 2], np.int32),
        pages=t(bvh8._woop_pages(v0, e1, e2, ids, 3, blk), np.float32),
        n_top=5, block=blk)


@pytest.mark.gpu
def test_cuda_ordered_warp_kernel_on_a_tie_across_leaves(cuda_device):
    """The same 8 triangles in two leaves under ids 8-15 and 0-7 (boxes
    widened so that no pop retest culls): the smaller id wins on every
    lane, bit-equal to the per-ray arm and the plain schedule."""
    import chip_smoke
    pos, _, _, tris = chip_smoke._wavy_grid(3)
    k = len(tris)
    corners = pos[tris]
    tree = binary_leaf_tree(cuda_device, [
        (corners, np.arange(k) + k), (corners, np.arange(k)),
        (corners + [2.5, 0, 0], np.arange(k) + 2 * k)], pad=0.5)
    n = 1024
    gx, gz = np.meshgrid(np.linspace(-0.9, 3.4, 32),
                         np.linspace(-0.9, 0.9, 32), indexing="ij")
    o = torch.as_tensor(np.stack([gx.ravel(), np.full(n, 3.0), gz.ravel()],
                                 -1).astype(np.float32), device=cuda_device)
    d = torch.as_tensor(np.tile(np.asarray([[0.01, -1.0, 0.02]], np.float32),
                                (n, 1)), device=cuda_device)
    tmax = torch.full((n,), 1e4, device=cuda_device)
    hw = kernels.closest_ordered(tree, o, d, tmax)
    hr = kernels.closest_ordered_per_ray(tree, o, d, tmax)
    hp, _ = kernels.closest_ordered_warp_plain(tree, o, d, tmax)
    for a, x, y in zip(_bits(hw), _bits(hr), _bits(hp)):
        assert torch.equal(a, x) and torch.equal(a, y)
    on_pair = (hw.tri >= 0) & (hw.tri < 2 * k)
    assert int(on_pair.sum()) > n // 4
    assert int(hw.tri[on_pair].max()) < k


@pytest.mark.gpu
def test_cuda_ordered_warp_kernel_raises_on_unstageable_and_deep_trees(
        cuda_device):
    """closest_ordered raises on pages the warp kernel cannot stage (a base
    off 16 bytes, a block off 32) and on a tree deeper than its stack, and
    launches nothing: no fallback to the per-ray kernel."""
    import dataclasses
    tree = ordered_trees(cuda_device)["sah 32"]
    o, d = _rays(64, 94, cuda_device)
    tmax = torch.full((64,), 20.0, device=cuda_device)
    pages = tree.pages
    off = torch.empty(pages.numel() + 1, device=cuda_device)[1:]
    off = off.view(pages.shape).copy_(pages)
    assert off.data_ptr() % 16 != 0
    before = dict(kernels.launches)
    for bad in (dataclasses.replace(tree, pages=off),
                dataclasses.replace(tree, block=48)):
        with pytest.raises(ValueError, match="multiples of 32"):
            kernels.closest_ordered(bad, o, d, tmax)
    deep = dataclasses.replace(tree)
    deep._depth = kernels.ORDERED_STACK + 1
    with pytest.raises(ValueError, match="stack"):
        kernels.closest_ordered(deep, o, d, tmax)
    assert kernels.launches == before
    empty = torch.empty((0, 3), device=cuda_device)
    h = kernels.closest_ordered(tree, empty, empty,
                                torch.empty((0,), device=cuda_device))
    assert h.t.shape == (0,) and kernels.launches == before


@pytest.mark.gpu
def test_cuda_render_image_stats_matches_cpu(cuda_device):
    """`render_image_stats` at `entry()`'s settings (the Default, 32², 1
    spp, 3 bounces) with no device argument: on the card, through the warp
    K3/K4 only (sample_count x bounce_count launches each); film within
    MSE 1e-3 of the CPU's, ray counts equal."""
    from pt_torch.render.integrator import (PathTracingSettings,
                                            render_image_stats)
    from pt_torch.scene.examples import make_default_scene
    from pt_torch.scene.flatten import flatten_scene
    from pt_torch.scene.textures import build_scene_textures
    out = {}
    for dev in (None, "cpu"):
        scene = make_default_scene()
        cam = scene.cameras[0]
        cam.on_resize(32, 32)
        on = dev or cuda_device
        kernels.reset_launch_counts()
        img, rays = render_image_stats(
            flatten_scene(scene, device=on),
            build_scene_textures(scene, device=on), cam.inv_view,
            cam.inv_proj, 32, 32, 0,
            PathTracingSettings(sample_count=1, bounce_count=3), device=dev)
        if dev is None:
            assert img.device == cuda_device
            assert {k: v for k, v in kernels.launches.items() if v} == {
                "closest_v4": 3, "occluded_v4": 3}
        out[dev] = (img.cpu().numpy(), int(rays))
    assert np.isfinite(out[None][0]).all() and out[None][0].max() > 0
    assert float(np.mean((out[None][0] - out["cpu"][0]) ** 2)) < 1e-3
    assert out[None][1] == out["cpu"][1]


@pytest.mark.gpu
def test_cuda_cli_render(cuda_device, tmp_path):
    """`python -m pt_torch.run.cli render` at 32² with no --device renders
    on the card (K1/K2) and writes a PNG; its HDR film is within MSE 1e-3
    of the same command's with --device cpu."""
    from pt_torch.run import cli
    from pt_torch.scene.textures import decode_png, read_radiance_hdr
    base = ["render", "--scene", "Test Scenes/Default", "--size", "32x32",
            "--spp", "2", "--bounces", "3"]
    png = tmp_path / "card.png"
    kernels.reset_launch_counts()
    assert cli.main(base + ["--out", str(png)]) == 0
    # one step of 2 spp: the merged bounce 0, then 2 tails of 2 bounces
    assert {k: v for k, v in kernels.launches.items() if v} == {
        "closest_bf8": 5, "occluded_bf8": 5}
    assert decode_png(png.read_bytes()).shape == (32, 32, 4)
    films = []
    for extra in ([], ["--device", "cpu"]):
        hdr = tmp_path / f"film{len(films)}.hdr"
        assert cli.main(base + ["--format", "hdr", "--out", str(hdr)]
                        + extra) == 0
        films.append(read_radiance_hdr(hdr.read_bytes()))
    assert films[0].max() > 0
    assert float(np.mean((films[0] - films[1]) ** 2)) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["pallas", "brute"])
def test_cuda_debug_frames_match_cpu(cuda_device, backend):
    """Every debug mode on the Default at 64x48, on the card against the
    CPU: at most 0.5% of the pixels off by more than 1e-4 (near-edge
    lanes). With the kernels a frame launches closest_v4 once and, in COLOR
    mode with shadows, occluded_v4 once; brute force launches nothing."""
    from pt_torch.render.debug import (DebugFlags, DebugRenderMode,
                                       render_debug_image)
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.scene.examples import make_default_scene
    from pt_torch.scene.flatten import flatten_scene
    from pt_torch.scene.textures import build_scene_textures
    scene = make_default_scene()
    cam = scene.cameras[0]
    cam.on_resize(64, 48)
    state = {dev: (flatten_scene(scene, device=dev),
                   build_scene_textures(scene, device=dev))
             for dev in (cuda_device, "cpu")}
    settings = PathTracingSettings(backend=backend)
    for mode in DebugRenderMode:
        for flags in (DebugFlags(), DebugFlags(disable_shadows=True)):
            frames = {}
            for dev, (ds, tex) in state.items():
                kernels.reset_launch_counts()
                frames[str(dev)] = render_debug_image(
                    ds, tex, cam.inv_view, cam.inv_proj, 64, 48, mode,
                    settings, flags, device=dev).cpu().numpy()
                if dev == cuda_device:
                    got = {k: v for k, v in kernels.launches.items() if v}
            want = {}
            if backend == "pallas":
                want = {"closest_v4": 1}
                if mode == DebugRenderMode.COLOR and not flags.disable_shadows:
                    want["occluded_v4"] = 1
            assert got == want, (mode, flags, got)
            card, cpu = frames[str(cuda_device)], frames["cpu"]
            assert np.isfinite(card).all() and card.shape == (48, 64, 3)
            off = np.mean(np.abs(card - cpu).max(axis=-1) > 1e-4)
            assert off <= 0.005, (mode, flags, off)


@pytest.mark.gpu
def test_cuda_hdr10_snapshot_matches_cpu(cuda_device, tmp_path):
    """The Default at 64², 2 spp, 3 bounces through `Renderer` with
    `snapshot(hdr=True)`: the PQ image on the card within MSE 1e-3 of the
    CPU's; `render --hdr` with no --device writes a PNG on the card."""
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run import cli
    from pt_torch.run.renderer import Renderer
    from pt_torch.scene.examples import make_default_scene
    from pt_torch.scene.textures import decode_png
    images = []
    for dev in (cuda_device, "cpu"):
        r = Renderer(PathTracingSettings(bounce_count=3), device=dev)
        r.set_scene(make_default_scene(), stream_textures=False)
        r.on_resize(64, 64)
        r.render(2)
        images.append(r.snapshot(hdr=True))
    assert np.isfinite(images[0]).all() and images[0].max() > 0
    assert float(np.mean((images[0] - images[1]) ** 2)) < 1e-3
    png = tmp_path / "hdr.png"
    kernels.reset_launch_counts()
    assert cli.main(["render", "--size", "32x32", "--spp", "2", "--bounces",
                     "3", "--hdr", "--out", str(png)]) == 0
    # one step of 2 spp: the merged bounce 0, then 2 tails of 2 bounces
    assert {k: v for k, v in kernels.launches.items() if v} == {
        "closest_bf8": 5, "occluded_bf8": 5}
    assert decode_png(png.read_bytes()).shape == (32, 32, 4)


@pytest.mark.gpu
def test_cuda_bvh_closest_equals_brute(cuda_device):
    """`backend="bvh"`'s threaded walk on the card: exact ids against the
    brute oracle on independent random triangles, every tree tensor on the
    card, no kernel launched."""
    from pt_torch.accel import lbvh, traverse
    from pt_torch.accel.intersect import intersect_brute
    v, t = _random_tris(2000, seed=5)
    V = torch.as_tensor(v, device=cuda_device)
    T = torch.as_tensor(t, device=cuda_device)
    o, d = _rays(8192, seed=6, device=cuda_device)
    tree = lbvh.build_bvh(V, T, 4)
    for name in ("aabb_lo", "aabb_hi", "miss_next", "leaf_id", "leaf_tris"):
        assert getattr(tree, name).device.type == "cuda", name
    kernels.reset_launch_counts()
    hit = traverse.bvh_closest(tree, V, T, o, d)
    occ = traverse.bvh_occluded(tree, V, T, o, d, 6.0)
    assert not any(kernels.launches.values())
    ref = intersect_brute(V, T, o, d)
    assert torch.equal(hit.tri, ref.tri)
    assert int((hit.tri >= 0).sum()) > 0
    assert torch.equal(occ, intersect_brute(V, T, o, d, tmax=6.0).is_hit)


@pytest.mark.gpu
def test_cuda_viewer_serves_a_frame(cuda_device):
    """The viewer on `cuda:0` (the Default at 64², one frame a loop): GET
    /frame is a JPEG of the card's film, GET /state reports its samples."""
    import json
    import threading
    import time
    import urllib.request

    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run import viewer
    from pt_torch.run.app import Application

    app = Application()
    assert app.renderer.device.type == "cuda"
    app.renderer.set_settings(PathTracingSettings(sample_count=1,
                                                  bounce_count=3))
    app.init(width=64, height=64)
    holder = {}
    orig = viewer.ViewerServer

    class Hooked(orig):
        def start(self):
            super().start()
            holder["base"] = f"http://{self.host}:{self.port}"

    viewer.ViewerServer = Hooked
    try:
        t = threading.Thread(target=viewer.run_viewer, args=(app,),
                             kwargs=dict(port=0, duration_seconds=6.0,
                                         show_hud=False))
        t.start()
        deadline = time.monotonic() + 60.0
        state = {}
        while time.monotonic() < deadline and not state.get("total_samples"):
            time.sleep(0.2)
            if "base" in holder:
                state = json.loads(urllib.request.urlopen(
                    holder["base"] + "/state", timeout=5).read())
        jpeg = urllib.request.urlopen(holder["base"] + "/frame",
                                      timeout=5).read()
        t.join()
    finally:
        viewer.ViewerServer = orig
    assert jpeg[:2] == b"\xff\xd8" and len(jpeg) > 200
    assert state["total_samples"] >= 1 and state["size"] == [64, 64]
