"""Rank bodies of tests/test_torch_dist.py and the independence test. Each
function runs in every rank of a `pt_torch.dist.launch.Gang` of CPU ranks
over gloo and returns what the test process compares. This module imports
the port only: never JAX, never `pt`.

Every rank calls every mesh constructor and every collective method in the
same order; a rank outside a sub-mesh returns None for it.
"""

import contextlib
import functools
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from pt_torch.dist import mesh as dm
from pt_torch.render.integrator import PathTracingSettings
from pt_torch.run import renderer as R
from pt_torch.scene.examples import make_default_scene
from pt_torch.scene.flatten import flatten_scene
from pt_torch.scene.textures import build_scene_textures


@functools.lru_cache(maxsize=None)
def _scene():
    return make_default_scene()


@functools.lru_cache(maxsize=None)
def _inputs(width: int, height: int):
    """The Default scene's flattened arrays, texture pool and camera
    matrices at a width x height film, on the CPU."""
    scene = _scene()
    cam = scene.cameras[0]
    cam.on_resize(width, height)
    return (flatten_scene(scene, device="cpu"),
            build_scene_textures(scene, device="cpu"),
            np.asarray(cam.inv_view, np.float32),
            np.asarray(cam.inv_proj, np.float32))


def loaded_roots():
    """The top-level names of the modules this rank has loaded."""
    return sorted({m.split(".")[0] for m, v in sys.modules.items()
                   if v is not None})


def backend_and_device():
    return dist.get_backend(), str(dm.rank_device("cpu"))


def fail_on_rank(rank: int):
    """Rank `rank` raises; the others wait in a collective for it."""
    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.all_reduce(torch.ones(1))


def _film_of(band, rays, mesh):
    return dm.assemble_film(band, mesh), int(rays)


def image_modes(width: int, height: int, spp: int, bounces: int,
                frame: int = 0):
    """The three `pt_torch.dist.mesh` modes over the world's 4 ranks: film
    bands (1-D), samples (1-D), and the 2-D meshes 4x1, 1x4 and 2x2. Each is
    (the whole film, the rays of every rank), on every rank."""
    st = PathTracingSettings(sample_count=spp, bounce_count=bounces)
    args = (*_inputs(width, height), width, height, frame, st)
    film = dm.film_mesh(device="cpu")
    out = {"film": _film_of(*dm.render_image_sharded(*args, film, "cpu"),
                            film)}
    img, rays = dm.render_spp_sharded(*args, film, "cpu")
    out["spp"] = (img.numpy(), int(rays))
    for f, s in ((4, 1), (1, 4), (2, 2)):
        mesh = dm.film_spp_mesh(f, s, device="cpu")
        out[f"{f}x{s}"] = _film_of(
            *dm.render_image_spp_sharded(*args, mesh, "cpu"), mesh)
    return out


def _renderer(mesh, settings, width, height, **kw):
    r = R.Renderer(settings, mesh=mesh, device="cpu", **kw)
    r.set_scene(_scene(), stream_textures=False)
    r.on_resize(width, height)
    return r


def renderer_films(width: int, height: int, samples: int, bounces: int,
                   sizes=(1, 2, 4), backend: str = "pallas", steps: int = 1):
    """`Renderer(mesh=film_mesh(ranks[:n]))` for each n of `sizes`:
    `steps` calls of render(samples), then (film_mean, rays_traced, total
    samples, this rank's K1/K2 plain-version calls unused) on the mesh's
    ranks, None elsewhere."""
    st = PathTracingSettings(sample_count=samples, bounce_count=bounces,
                             backend=backend)
    out = {}
    for n in sizes:
        mesh = dm.film_mesh(range(n), device="cpu")
        if mesh.get_coordinate() is None:
            out[n] = None
            continue
        r = _renderer(mesh, st, width, height)
        for _ in range(steps):
            r.render()
        out[n] = (r.film_mean(), r.rays_traced, r.total_samples)
    return out


@contextlib.contextmanager
def _size_class(fn):
    orig = R._size_class
    R._size_class = fn
    try:
        yield
    finally:
        R._size_class = orig


def compaction_films(width: int, height: int, steps: int, bounces: int):
    """A 4-band `Renderer` with compaction (size classes from 64 lanes up,
    so the bands' 1024 lanes compact) and without (every class huge):
    (film, rays) each, and the tail plan of the compacted run."""
    st = PathTracingSettings(sample_count=1, bounce_count=bounces,
                             backend="brute")
    mesh = dm.film_mesh(device="cpu")
    out = {}
    orig = R._size_class
    for name, fn in (("on", lambda n, minimum=64: orig(n, minimum)),
                     ("off", lambda n, minimum=1024: 1 << 30)):
        with _size_class(fn):
            r = _renderer(mesh, st, width, height)
            for _ in range(steps):
                r.render(1)
            out[name] = (r.film_mean(), r.rays_traced)
            out[name + "_plan"] = r._plans.get(("tail", r._lanes))
    return out


def band_tiling(width: int, height: int):
    """This rank's band arrays after on_resize (lane order within the band,
    pixel coordinates, the band-local scatter permutation), and the film
    of one render(1)."""
    st = PathTracingSettings(sample_count=1, bounce_count=1, backend="brute")
    r = _renderer(dm.film_mesh(device="cpu"), st, width, height)
    arrays = dict(order=r._order_np.copy(), px=r._px.numpy(),
                  py=r._py.numpy(), perm=r._film_perm.numpy(),
                  rows=r._rows, band=r.band)
    r.render(1)
    return arrays, r.film_mean()


def adaptive_films(width: int, height: int, bounces: int, single=True,
                   **kw):
    """`render_adaptive(**kw)` over the 4-band mesh, and with `single` on
    one device too (each rank alone): (stats, film, snapshot) of each."""
    st = PathTracingSettings(sample_count=1, bounce_count=bounces)
    out = {}
    runs = [("single", None)] if single else []
    for name, mesh in runs + [("mesh", dm.film_mesh(device="cpu"))]:
        r = _renderer(mesh, st, width, height)
        stats = r.render_adaptive(**kw)
        out[name] = (stats, r.film_mean(), r.snapshot())
    return out


def adaptive_deadlines(width: int, height: int):
    """`render_adaptive` over the 4-band mesh with a deadline already past,
    then with one far off: the stats of each."""
    st = PathTracingSettings(sample_count=1, bounce_count=2, backend="brute")
    r = _renderer(dm.film_mesh(device="cpu"), st, width, height)
    past = r.render_adaptive(tol=0.0, max_spp=64, min_spp=1, check_every=1,
                             max_seconds=0.0)
    far = r.render_adaptive(tol=0.0, max_spp=4, min_spp=1, check_every=4,
                            max_seconds=1e9)
    return past, far, bool(np.isfinite(r.snapshot()).all())


def checkpoint_round_trip(width: int, height: int, path: str):
    """Two 4-band steps saved under the mesh, resumed on one device and
    under 2 bands, each then stepped once more, beside an uninterrupted
    run: the films of the three."""
    st = PathTracingSettings(sample_count=2, bounce_count=3)
    mesh = dm.film_mesh(device="cpu")
    r = _renderer(mesh, st, width, height)
    r.render()
    r.save_checkpoint(path)
    r.render()
    whole = r.film_mean(), r.rays_traced
    single = _renderer(None, st, width, height)
    single.load_checkpoint(path)
    single.render()
    two = dm.film_mesh(range(2), device="cpu")
    half = None
    if two.get_coordinate() is not None:
        h = _renderer(two, st, width, height)
        h.load_checkpoint(path)
        h.render()
        half = h.film_mean(), h.rays_traced
    return whole, (single.film_mean(), single.rays_traced), half


def dryrun(directory: str):
    """`pt`'s `dryrun_multichip(4)` sequence (`__graft_entry__.py`) on the
    port: the three modes at 16x16, `Renderer.render(1)`, the adaptive film
    (spp_min == 2), the offline save under the multi-host mesh (the first
    rank writes), and the weak-scaling shapes (k ranks render 8k rows of
    32). Returns what each step produced."""
    from pt_torch.out.saver import OutputInfo
    from pt_torch.run.offline import OfflineRenderer, RenderSettings
    st = PathTracingSettings(sample_count=1, bounce_count=2, backend="brute")
    width = height = 16
    args = (*_inputs(width, height), width, height, 0, st)
    mesh = dm.film_mesh(device="cpu")
    band, _ = dm.render_image_sharded(*args, mesh, "cpu")
    out = {"film": dm.assemble_film(band, mesh).shape,
           "film_finite": bool(torch.isfinite(band).all())}
    img, _ = dm.render_spp_sharded(*args, mesh, "cpu")
    out["spp_finite"] = bool(torch.isfinite(img).all())
    mesh2d = dm.film_spp_mesh(2, 2, device="cpu")
    band, _ = dm.render_image_spp_sharded(*args, mesh2d, "cpu")
    out["2d_finite"] = bool(torch.isfinite(band).all())
    r = _renderer(mesh, st, width, height)
    r.render(1)
    out["render_finite"] = bool(np.isfinite(r.snapshot()).all())
    r.reset_accumulation()
    out["adaptive"] = r.render_adaptive(tol=0.0, max_spp=2, min_spp=1,
                                        check_every=2)
    out["adaptive_finite"] = bool(np.isfinite(r.snapshot()).all())
    rmh = _renderer(dm.film_mesh_multihost(device="cpu"), st, width, height)
    path = os.path.join(directory, "frame.png")
    out["frames"] = OfflineRenderer(rmh).render(RenderSettings(
        output=OutputInfo(path, width, height, 30.0, "png"),
        frame_count=1, max_sample_count=2, samples_per_step=1))
    shapes = []
    for k in (1, 2, 4):
        sub = dm.film_mesh(range(k), device="cpu")
        if sub.get_coordinate() is None:
            continue
        cam = _scene().cameras[0]
        cam.on_resize(32, 8 * k)
        ds, tex = _inputs(width, height)[:2]
        band, _ = dm.render_image_sharded(ds, tex, cam.inv_view,
                                          cam.inv_proj, 32, 8 * k, 0, st,
                                          sub, "cpu")
        film = dm.assemble_film(band, sub)
        shapes.append((k, film.shape, bool(np.isfinite(film).all())))
    out["weak_scaling"] = shapes
    return out


def offline_runs(directory: str, width: int = 16, height: int = 16):
    """`OfflineRenderer` under the 4-band mesh to `mesh.png`, and on the
    first rank alone (one device) to `one.png`, 3 samples in steps of 2;
    then under the mesh with a checkpoint, cancelled by rank 1 alone after
    its first step. Returns (frames, total samples) of each run."""
    from pt_torch.out.saver import OutputInfo
    from pt_torch.run.offline import OfflineRenderer, RenderSettings
    st = PathTracingSettings(sample_count=1, bounce_count=3)
    mesh = dm.film_mesh(device="cpu")

    def settings(name, **kw):
        return RenderSettings(output=OutputInfo(
            os.path.join(directory, name), width, height, 30.0, "png"),
            frame_count=1, max_sample_count=3, samples_per_step=2, **kw)
    out = {}
    r = _renderer(mesh, st, width, height)
    out["mesh"] = OfflineRenderer(r).render(settings("mesh.png")), \
        r.total_samples
    if dist.get_rank() == 0:
        r = _renderer(None, st, width, height)
        out["one"] = OfflineRenderer(r).render(settings("one.png")), \
            r.total_samples
    r = _renderer(mesh, st, width, height)
    off = OfflineRenderer(r)

    def progress(frame, frames, samples):
        if dist.get_rank() == 1:
            off.cancel()
    out["cancelled"] = off.render(settings(
        "cancelled.png", checkpoint_path=os.path.join(directory, "c.npz")),
        progress), r.total_samples
    return out
