"""Start ranks and run functions in them: the launcher of the tests and of
`chip_smoke.py` (a user's program starts its ranks with `torchrun`).

    with Gang(4, backend="gloo", device="cpu") as gang:
        films = gang.run(module.function, arg)     # one result per rank

`Gang(nprocs, backend, device=None)` starts `nprocs` processes by the spawn
method (each starts from a fresh import: nothing the parent loaded, JAX
included, comes along). Rank r sets `LOCAL_RANK`, `RANK` and `WORLD_SIZE`
as torchrun does, takes `device` (None: `pt_torch.dist.mesh.rank_device`,
cuda:(r % cards)), runs PyTorch on one thread if that is the CPU, and
joins the process group with `backend` (never another), a file://
rendezvous in a fresh temporary directory and the mesh module's
COLLECTIVE_TIMEOUT_S on each collective. The gang prints the backend once
every rank joined.

`gang.run(fn, *args, deadline=, **kwargs)` calls `fn(*args, **kwargs)` in
every rank and returns the results in rank order. `fn` is sent by
reference, so it must be a module-level function of a module that imports
neither JAX nor `pt`, and its arguments and results must pickle. A rank that raises sends its
traceback: the gang then kills every rank and raises `RankError` with it.
A run that is not done within `deadline` seconds, or a rank that dies,
kills the gang too. A gang that failed runs nothing more.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch


# seconds for every rank to import, take its device and join the group
_START_DEADLINE_S = 180.0


class RankError(RuntimeError):
    """A rank of a gang raised (the message holds its traceback) or died."""


def _rank_main(rank, world, init_method, backend, device, tasks, results):
    """Body of rank `rank`: join the group, then run tasks until None."""
    try:
        os.environ.update(LOCAL_RANK=str(rank), RANK=str(rank),
                          WORLD_SIZE=str(world))
        import torch.distributed as dist
        from pt_torch.dist.mesh import COLLECTIVE_TIMEOUT_S, rank_device
        dev = rank_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)    # beside the other ranks' processes
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        results.put((rank, "ready", f"{dist.get_backend()} on {dev}"))
        while (task := tasks.get()) is not None:
            fn, args, kwargs = task
            results.put((rank, "ok", fn(*args, **kwargs)))
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))


class Gang:
    """`nprocs` ranks in one process group, running functions on request
    (see the module's docstring)."""

    def __init__(self, nprocs: int, backend: str, device=None):
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend {backend!r}: gloo or nccl")
        ctx = multiprocessing.get_context("spawn")
        self.nprocs = nprocs
        self._dir = tempfile.mkdtemp(prefix="pt_torch_ranks_")
        init = "file://" + os.path.join(self._dir, "rendezvous")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(nprocs)]
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, nprocs, init, backend,
                              None if device is None else str(device),
                              self._tasks[r], self._results))
            for r in range(nprocs)]
        for p in self._procs:
            p.start()
        self.joined = self._collect(_START_DEADLINE_S, "start")
        print(f"pt_torch.dist: {nprocs} ranks joined over {backend}: "
              f"{', '.join(self.joined)}", flush=True)

    def run(self, fn, *args, deadline: float = 600.0, **kwargs) -> list:
        """`fn(*args, **kwargs)` in every rank; the results in rank
        order."""
        if self._procs is None:
            raise RankError("the gang has stopped")
        for q in self._tasks:
            q.put((fn, args, kwargs))
        return self._collect(deadline, getattr(fn, "__name__", str(fn)))

    def _collect(self, deadline: float, what: str) -> list:
        out, got = [None] * self.nprocs, 0
        end = time.monotonic() + deadline
        while got < self.nprocs:
            left = end - time.monotonic()
            if left <= 0:
                self.kill()
                raise TimeoutError(f"{what}: the ranks did not finish "
                                   f"within {deadline} s")
            try:
                rank, kind, payload = self._results.get(timeout=min(left,
                                                                    1.0))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                if not dead:
                    continue
                try:        # a rank that raised sent its traceback first
                    rank, kind, payload = self._results.get(timeout=1.0)
                except queue.Empty:
                    self.kill()
                    raise RankError(f"{what}: rank {dead[0][0]} exited with "
                                    f"code {dead[0][1]}") from None
            if kind == "error":
                self.kill()
                raise RankError(f"{what}: rank {rank} raised:\n{payload}")
            out[rank] = payload
            got += 1
        return out

    def kill(self) -> None:
        """Stop every rank now (terminate, then kill)."""
        procs, self._procs = self._procs, None
        for p in procs or ():
            if p.is_alive():
                p.terminate()
        for p in procs or ():
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(self._dir, ignore_errors=True)

    def close(self, deadline: float = 60.0) -> None:
        """Let every rank leave the group and exit; kill what is left after
        `deadline` seconds."""
        if self._procs is None:
            return
        for q in self._tasks:
            q.put(None)
        end = time.monotonic() + deadline
        for p in self._procs:
            p.join(max(0.0, end - time.monotonic()))
        self.kill()

    def __enter__(self) -> "Gang":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def launch(fn, nprocs: int, backend: str, *args, device=None,
           deadline: float = 600.0) -> list:
    """`fn(*args)` in each of `nprocs` new ranks (a gang of its own); the
    results in rank order."""
    with Gang(nprocs, backend, device) as gang:
        return gang.run(fn, *args, deadline=deadline)
