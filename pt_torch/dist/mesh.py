"""Film sharding over ranks: one process per device, `torch.distributed`.

Port of `pt.dist.mesh`. `pt` runs one controller over a `jax.sharding.Mesh`
and shards through `shard_map`; the port runs one process ("rank") per
device, started by `torchrun` or by `pt_torch.dist.launch.Gang`, and a mesh
is a `torch.distributed.device_mesh.DeviceMesh` over ranks with `pt`'s axis
names (`"film"`, or `("film", "spp")`). Paths are pixel-independent and each
pixel's RNG stream is seeded by (pixel, frame), so no step needs the other
ranks' rays: every rank holds the scene, the texture pool and its own tree,
renders its part, and the only collectives are the ray count, the sum over
the spp axis, and the film's gather at a save (`assemble_film`).

Every function here is collective. Every rank of the world builds each mesh,
with the same arguments (a rank outside it gets a mesh whose
`get_coordinate()` is None and takes no part in its renders). Every rank of
a mesh calls a render function or `assemble_film` on it with the same
arguments, in the same order. A render function's `device` (None: the
rank's, `rank_device`) must hold the scene and the texture pool. The
process group must exist
(`init_process_group`, as the launcher or torchrun's caller makes it); a
collective of a mesh's groups raises after COLLECTIVE_TIMEOUT_S seconds, as
one of the launcher's world group does.

Over gloo the collectives run on host copies, made here (gloo does not take
every collective on CUDA tensors, and reduce-scatter not at all); over nccl
they run on the device. The spp sum is an all-reduce. nccl, one rank per
card, and meshes across hosts (`film_mesh_multihost`) have not been run
here: the tests and the card's smoke run use gloo on one host.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pt_torch import default_device
from pt_torch.render.integrator import (PathTracingSettings, render_flat,
                                        scene_device)

# `pt`'s per-rank frame stride over the spp axis (golden ratio * 2^32): the
# map (rank, step) -> frame stays injective for any realistic step count
GOLDEN_STRIDE = 2654435761
_MASK32 = 0xFFFFFFFF

# a rank waits this long in a collective for the others before it raises
COLLECTIVE_TIMEOUT_S = 60.0


def rank_device(device=None) -> torch.device:
    """The device a rank renders on: `device` when the caller names one
    (`default_device`'s rules), else `cuda:(LOCAL_RANK % device_count)`.
    Without a card that raises: a rank runs on the CPU only when asked."""
    if device is not None or not torch.cuda.is_available():
        return default_device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def spp_frame(frame, index: int) -> int:
    """The frame of spp-group `index`: `frame + index * GOLDEN_STRIDE` mod
    2^32, computed with Python integers (`pt` wraps it in uint32)."""
    return (int(frame) + index * GOLDEN_STRIDE) & _MASK32


def _group_backend(backend: str):
    """(backend, options) for a mesh dimension's group: the world's backend
    and COLLECTIVE_TIMEOUT_S on each collective."""
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
    elif backend == "gloo":
        opts = dist.ProcessGroupGloo._Options()
    else:
        raise ValueError(f"backend {backend!r}: the mesh takes gloo or nccl")
    opts._timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    return backend, opts


def _device_mesh(grid: np.ndarray, names: tuple, device):
    from torch.distributed.device_mesh import DeviceMesh
    dev = rank_device(device)
    if dev.type == "cuda":
        # before the mesh, which would otherwise pick a card by LOCAL_RANK
        # alone (several ranks share one card over gloo)
        torch.cuda.set_device(dev)
    group = _group_backend(dist.get_backend())
    return DeviceMesh(dev.type, torch.as_tensor(grid, dtype=torch.int64),
                      mesh_dim_names=names,
                      backend_override=(group,) * len(names))


def _ranks(ranks: Optional[Sequence[int]]) -> np.ndarray:
    return np.asarray(list(range(dist.get_world_size())) if ranks is None
                      else list(ranks), np.int64)


def film_mesh(ranks: Optional[Sequence[int]] = None, axis: str = "film",
              device=None):
    """1-D mesh of film-row bands over `ranks` (every rank of the world by
    default), band i on `ranks[i]`. `device` is the rank's
    (`rank_device`)."""
    return _device_mesh(_ranks(ranks), (axis,), device)


def film_spp_mesh(film: int, spp: int, ranks: Optional[Sequence[int]] = None,
                  axes=("film", "spp"), device=None):
    """2-D mesh: `film` row bands x `spp` decorrelated sample groups over the
    first film * spp of `ranks`, row-major (rank `ranks[f * spp + s]` holds
    band f, group s)."""
    ranks = _ranks(ranks)
    if film * spp > len(ranks):
        raise ValueError(f"need {film * spp} ranks, have {len(ranks)}")
    return _device_mesh(ranks[:film * spp].reshape(film, spp), tuple(axes),
                        device)


def film_mesh_multihost(axis: str = "film", device=None):
    """Film-row mesh over every rank of the world, on however many hosts
    (`torchrun --nnodes`): the same code as `film_mesh()`. Bands stay with
    their ranks; nothing in a step crosses hosts but the ray count and the
    compaction plan's maximum, and the film only at a save
    (`assemble_film`)."""
    return film_mesh(None, axis, device)


def coordinate(mesh) -> tuple:
    """This rank's coordinate in `mesh`; ValueError outside it."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in {mesh}")
    return tuple(coord)


def _host(t: torch.Tensor, group) -> torch.Tensor:
    """The copy of `t` that `group`'s collectives take: on the host over
    gloo, on the rank's card over nccl."""
    dev = ("cpu" if dist.get_backend(group) == "gloo"
           else torch.device("cuda", torch.cuda.current_device()))
    return t.detach().to(dev, copy=True).contiguous()


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`t` reduced by `op` over `group`, on `t`'s device (a new tensor)."""
    x = _host(t, group)
    dist.all_reduce(x, op=op, group=group)
    return x.to(t.device)


def any_rank(flags, group) -> list:
    """Each of `flags` OR-ed over `group` (one collective): every rank then
    takes the same branch."""
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int64)
    return [bool(v) for v in all_reduce(t, group, dist.ReduceOp.MAX)]


def _along(mesh, dim: int) -> list:
    """The global ranks along `dim` through this rank's coordinate, in
    coordinate order."""
    coord = coordinate(mesh)
    index = tuple(slice(None) if d == dim else c for d, c in enumerate(coord))
    return mesh.mesh[index].tolist()


def assemble_film(accum: torch.Tensor, mesh) -> np.ndarray:
    """This rank's band of a band-sharded film (film rows, or film-order
    pixels, on dim 0) gathered with the bands of the other ranks along
    `mesh`'s film axis (dim 0) into the whole film, joined on dim 0 in band
    order: a host array on every such rank (over a 2-D mesh each spp group
    gathers the same bands). One all-gather, made once per saved frame,
    never per step."""
    group = mesh.get_group(0)
    x = _host(accum, group)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat([parts[dist.get_group_rank(group, r)]
                      for r in _along(mesh, 0)]).cpu().numpy()


def _render(ds, tex, inv_view, inv_proj, width, height, row0, rows, frame,
            settings, device):
    """`render_flat` of film rows [row0, row0 + rows) in row-major order:
    ((rows, W, 3) radiance sum, this rank's rays)."""
    device = scene_device(ds, tex, rank_device(device))
    mat = lambda m: torch.as_tensor(np.asarray(m, np.float32),  # noqa: E731
                                    device=device)
    ys, xs = torch.meshgrid(torch.arange(row0, row0 + rows, device=device),
                            torch.arange(width, device=device), indexing="ij")
    radiance, rays = render_flat(ds, tex, mat(inv_view), mat(inv_proj),
                                 xs.reshape(-1), ys.reshape(-1), width,
                                 height, frame, settings)
    return radiance.reshape(rows, width, 3), rays


def render_image_sharded(ds, tex, inv_view, inv_proj, width: int,
                         height: int, frame, settings: PathTracingSettings,
                         mesh, device=None):
    """Render the frame with film rows sharded over the 1-D `mesh`.

    Rank i of the mesh holds band i: rows [i * H / n, (i + 1) * H / n).
    Returns (this rank's (H / n, W, 3) radiance sum, the rays of every rank:
    a 0-d int64 tensor). H must be divisible by the mesh size. The bands
    joined (`assemble_film`) equal `render_image_stats`' film bit for bit."""
    n = mesh.size()
    if height % n:
        raise ValueError(f"height {height} not divisible by mesh size {n}")
    (band,) = coordinate(mesh)
    rows = height // n
    radiance, rays = _render(ds, tex, inv_view, inv_proj, width, height,
                             band * rows, rows, frame, settings, device)
    return radiance, all_reduce(rays, mesh.get_group(0))


def render_spp_sharded(ds, tex, inv_view, inv_proj, width: int, height: int,
                       frame, settings: PathTracingSettings, mesh,
                       device=None):
    """Sample-parallel mode: rank i of the 1-D `mesh` renders the whole film
    at frame `spp_frame(frame, i)`, and the films are summed over the mesh.
    Returns (the (H, W, 3) sum, the same on every rank; the rays of every
    rank). Total spp per call = settings.sample_count * mesh size."""
    (index,) = coordinate(mesh)
    radiance, rays = _render(ds, tex, inv_view, inv_proj, width, height, 0,
                             height, spp_frame(frame, index), settings,
                             device)
    group = mesh.get_group(0)
    return all_reduce(radiance, group), all_reduce(rays, group)


def render_image_spp_sharded(ds, tex, inv_view, inv_proj, width: int,
                             height: int, frame,
                             settings: PathTracingSettings, mesh,
                             device=None):
    """Both over a 2-D (film, spp) `mesh`: the rank at (f, s) renders band f
    at frame `spp_frame(frame, s)`, and each band is summed over the spp
    axis (the film axis needs no collective). The 1-wide meshes equal the
    1-D modes bit for bit. Returns (this rank's (H / nf, W, 3) band, the same
    on every rank of its spp group; the rays of every rank). H must be
    divisible by the film axis' size nf."""
    nf = mesh.shape[0]
    if height % nf:
        raise ValueError(f"height {height} not divisible by film axis {nf}")
    band, index = coordinate(mesh)
    rows = height // nf
    radiance, rays = _render(ds, tex, inv_view, inv_proj, width, height,
                             band * rows, rows, spp_frame(frame, index),
                             settings, device)
    spp = mesh.get_group(1)
    rays = all_reduce(all_reduce(rays, mesh.get_group(0)), spp)
    return all_reduce(radiance, spp), rays
