"""Traversal kernels K1/K2 (BF8 tree), K3/K4 (binary PacketBVH), K5/K6
(instanced BF8 tree over shared pages) and the archive's walks: the ordered
binary walk and the BF8V6 walks.

K1 `closest_bf8` replaces pt/accel/pallas_bvh.py:packet_closest_bf8, K2
`occluded_bf8` replaces :packet_occluded_bf8, K3 `closest_v4` replaces
:packet_closest_v4, K4 `occluded_v4` replaces :packet_occluded_v4, K5
`closest_bf8i` replaces pt/accel/instanced.py:packet_closest_bf8i and K6
`occluded_bf8i` replaces :packet_occluded_bf8i. Of
pt/accel/pallas_bvh_archive.py, `closest_ordered` replaces packet_closest,
packet_closest_sub and packet_closest_v3 (one near-child-first walk, three
TPU schedules of it), `closest_v6` packet_closest_v6, `closest_v6k2`
packet_closest_v6k2, `closest_v7` packet_closest_v7 and `occluded_v6`
packet_occluded_v6 (pt_torch/accel/archive.py binds each of pt's entry
points). The kernels are CUDA C++ for sm_90a (csrc/bf8_warp_kernels.cu,
csrc/bf8_occluded_warp_kernels.cu and csrc/bf8_kernels.cu over
csrc/bf8_traverse.cuh, csrc/v4_warp_kernels.cu and csrc/v4_kernels.cu over
csrc/v4_traverse.cuh, csrc/bf8i_warp_kernels.cu and csrc/bf8i_kernels.cu
over csrc/bf8i_traverse.cuh (the warp sources sharing their leaf test in
csrc/warp_leaf.cuh), csrc/ordered_warp_kernels.cu and
csrc/ordered_kernels.cu over csrc/ordered_traverse.cuh,
csrc/v6_warp_kernels.cu and csrc/v6_kernels.cu (and, for closest_v6 and
occluded_v6, the two BF8 warp sources) over csrc/v6_traverse.cuh, the last
two sharing their leaf tests in csrc/page_leaf.cuh, all over
csrc/rt_common.cuh), built with nvcc at first use into the port's
git-ignored build directory, one library per source, and bound through
ctypes. They are bound by dependent global loads of node and page rows,
not by FLOPs: one thread per ray walks its own stack (K1/K2, K5/K6, the
archive walks) or the preorder skip links (K3/K4). Every kernel is
redesigned for the card: each ray keeps its walk (K5/K6: in its own
instance space), and the warp tests each pending leaf (K5/K6: each pending
shared page) together, the page staged into shared memory once per group
of lanes (csrc/bf8_warp_kernels.cu, csrc/bf8_occluded_warp_kernels.cu,
csrc/v4_warp_kernels.cu, csrc/bf8i_warp_kernels.cu,
csrc/ordered_warp_kernels.cu, csrc/v6_warp_kernels.cu: closest_v6k2 and
closest_v7, whose lanes list more than one leaf at once and drain the
lists together). Their first design, one thread per ray
testing each leaf alone, stays as the baseline arm of the A/B and as their
counted variant, reached only by name: `closest_bf8_per_ray` (also the A/B
arm of K1's pops launch), `occluded_bf8_per_ray` (csrc/bf8_kernels.cu),
`closest_v6_per_ray`, `closest_v6k2_per_ray`, `closest_v7_per_ray`,
`occluded_v6_per_ray` (csrc/v6_kernels.cu),
`closest_v4_per_ray`, `occluded_v4_per_ray` (csrc/v4_kernels.cu),
`closest_bf8i_per_ray`, `occluded_bf8i_per_ray` (csrc/bf8i_kernels.cu),
`closest_ordered_per_ray` (csrc/ordered_kernels.cu).

Beside each kernel sits its plain PyTorch version (`closest_bf8_plain`,
`occluded_bf8_plain`, `closest_v4_plain`, `occluded_v4_plain`,
`closest_bf8i_plain`, `occluded_bf8i_plain`, and `closest_ordered_plain`,
`closest_v6_plain`, `closest_v6k2_plain`, `closest_v7_plain`,
`occluded_v6_plain`): every valid page column decoded into (W, b, id) and
all rays tested against all of them in chunks
(for K5/K6 segment by segment, the rays mapped into the segment's object
space first), with the kernel's Woop arithmetic and tie rule. The trees are
conservative, so it computes the same function as the traversal. The warp
kernels' schedules have their own plain versions (`closest_bf8_warp_plain`,
`occluded_bf8_warp_plain`, `closest_v6_warp_plain`,
`occluded_v6_warp_plain`, `closest_v4_warp_plain`, `occluded_v4_warp_plain`,
`closest_bf8i_warp_plain`, `occluded_bf8i_warp_plain`,
`closest_ordered_warp_plain`, `closest_v6k2_warp_plain`,
`closest_v7_warp_plain`): the per-ray walk of every lane at once, paused
at each leaf (v6k2 and v7: after each round that lists one), grouped by
(warp, leaf) or (warp, page) and reduced with the kernels' key; their hits
are the per-ray walk's bit for bit, and they count the groups.

K1 has a pops launch (`closest_bf8(..., pops=...)`, the warp kernel's
pops instance; its A/B arm `closest_bf8_per_ray(..., pops=...)`): each
lane writes the iterations of its walk loop, one per pop of a wide node or
a leaf, and the hits are K1's. A lane of the warp kernel pops what its
per-ray walk pops, so the two write the same pops. It is the port's
counterpart of the diagnostic rows that benches/budget.py:rounds_of and
benches/drain_sim.py:done_rounds_of read from pt's K1 (lockstep rounds per
program, per sub-packet), reduced per warp by pt_torch/benches/: the
lockstep of a one-thread-per-ray schedule. Its plain version is
`closest_bf8_walk_plain`, a vectorised stack walk over all lanes that
repeats the kernel step by step.

Beside the traversal kernels sit the round kernels of the integrator's
split any-hit loops (csrc/alpha_round_kernels.cu over
csrc/alpha_round.cuh; `alpha_closest_round`, `alpha_shadow_round`): one
launch a round does what a round does besides its trace, in place. Their
plain twins are the integrator's tensor round bodies
(`pt_torch.render.integrator._closest_round_plain` / `_shadow_round_plain`),
which the integrator runs for CPU tensors; the launchers here take CUDA
tensors only.

The wrappers check device, dtype, shape and contiguity. A CPU tensor goes
to the plain version; a CUDA tensor launches the kernel or raises. Each
launch adds one to `launches[name]` (a pops launch to
`launches["closest_bf8_pops"]` or `["closest_bf8_pops_per_ray"]`, a per-ray
launch to `launches["closest_bf8_per_ray"]`, `["closest_v4_per_ray"]` and
so on).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import re
import shutil
import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from pt_torch.accel.bvh8 import ALPHA_TRI_BIT, LEAF_BIT, BF8BVH, PacketBVH
from pt_torch.accel.instanced import SEG_SHIFT, BF8Instanced
from pt_torch.accel.intersect import Hit
from pt_torch.accel.native import BUILD_DIR, compile_shared
from pt_torch.core.compilewatch import stage_call

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_COMMON = CSRC / "rt_common.cuh"
# library name -> (output, sources; the first is the one nvcc compiles)
_CUDA_LIBS = {
    "bf8": (BUILD_DIR / "libpt_bf8_sm90a.so",
            (CSRC / "bf8_kernels.cu", CSRC / "bf8_traverse.cuh", _COMMON)),
    "bf8w": (BUILD_DIR / "libpt_bf8w_sm90a.so",
             (CSRC / "bf8_warp_kernels.cu", CSRC / "warp_leaf.cuh",
              CSRC / "v6_traverse.cuh", CSRC / "bf8_traverse.cuh",
              CSRC / "page_leaf.cuh", _COMMON)),
    "bf8wo": (BUILD_DIR / "libpt_bf8wo_sm90a.so",
              (CSRC / "bf8_occluded_warp_kernels.cu", CSRC / "warp_leaf.cuh",
               CSRC / "bf8i_traverse.cuh", CSRC / "v6_traverse.cuh",
               CSRC / "bf8_traverse.cuh", CSRC / "page_leaf.cuh", _COMMON)),
    "v4": (BUILD_DIR / "libpt_v4_sm90a.so",
           (CSRC / "v4_kernels.cu", CSRC / "v4_traverse.cuh", _COMMON)),
    "v4w": (BUILD_DIR / "libpt_v4w_sm90a.so",
            (CSRC / "v4_warp_kernels.cu", CSRC / "warp_leaf.cuh",
             CSRC / "v4_traverse.cuh", _COMMON)),
    "bf8i": (BUILD_DIR / "libpt_bf8i_sm90a.so",
             (CSRC / "bf8i_kernels.cu", CSRC / "bf8i_traverse.cuh",
              CSRC / "bf8_traverse.cuh", _COMMON)),
    "bf8iw": (BUILD_DIR / "libpt_bf8iw_sm90a.so",
              (CSRC / "bf8i_warp_kernels.cu", CSRC / "warp_leaf.cuh",
               CSRC / "bf8i_traverse.cuh", CSRC / "bf8_traverse.cuh",
               _COMMON)),
    "ordered": (BUILD_DIR / "libpt_ordered_sm90a.so",
                (CSRC / "ordered_kernels.cu", CSRC / "ordered_traverse.cuh",
                 CSRC / "v4_traverse.cuh", CSRC / "page_leaf.cuh", _COMMON)),
    "ordw": (BUILD_DIR / "libpt_ordw_sm90a.so",
             (CSRC / "ordered_warp_kernels.cu", CSRC / "warp_leaf.cuh",
              CSRC / "ordered_traverse.cuh", CSRC / "v4_traverse.cuh",
              CSRC / "page_leaf.cuh", _COMMON)),
    "v6": (BUILD_DIR / "libpt_v6_sm90a.so",
           (CSRC / "v6_kernels.cu", CSRC / "v6_traverse.cuh",
            CSRC / "bf8_traverse.cuh", CSRC / "page_leaf.cuh", _COMMON)),
    "v6w": (BUILD_DIR / "libpt_v6w_sm90a.so",
            (CSRC / "v6_warp_kernels.cu", CSRC / "warp_leaf.cuh",
             CSRC / "v6_traverse.cuh", CSRC / "bf8_traverse.cuh",
             CSRC / "page_leaf.cuh", _COMMON)),
    "alpha": (BUILD_DIR / "libpt_alpha_sm90a.so",
              (CSRC / "alpha_round_kernels.cu", CSRC / "alpha_round.cuh",
               _COMMON)),
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

# launch counts per kernel: each wrapper adds one where it launches
launches = {"closest_bf8": 0, "closest_bf8_per_ray": 0,
            "closest_bf8_pops": 0, "closest_bf8_pops_per_ray": 0,
            "occluded_bf8": 0, "occluded_bf8_per_ray": 0, "closest_v4": 0,
            "occluded_v4": 0, "closest_v4_per_ray": 0,
            "occluded_v4_per_ray": 0, "closest_bf8i": 0,
            "occluded_bf8i": 0, "closest_bf8i_per_ray": 0,
            "occluded_bf8i_per_ray": 0, "closest_ordered": 0,
            "closest_ordered_per_ray": 0, "closest_v6": 0,
            "closest_v6_per_ray": 0, "closest_v6k2": 0,
            "closest_v6k2_per_ray": 0, "closest_v7": 0,
            "closest_v7_per_ray": 0, "occluded_v6": 0,
            "occluded_v6_per_ray": 0, "alpha_closest_round": 0,
            "alpha_shadow_round": 0}
# per-thread stack entries of the archive kernels (ordered_traverse.cuh,
# v6_traverse.cuh); the wrappers raise on a tree that could overflow them
ORDERED_STACK = 64
V6_STACK = 128
# leaves a v7 round queues at most (kQueueCap in v6_traverse.cuh)
V6_QUEUE = 48
# K1's per-thread stack (kStackDepth in bf8_traverse.cuh)
BF8_STACK = 128

_lock = threading.Lock()
_cuda_handles: Dict[str, ctypes.CDLL] = {}
_RAY_TRI_BUDGET = 1 << 24   # rays*columns elements per plain-version chunk
_INT32_MAX = 0x7FFFFFFF


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the traversal kernels need the "
                           "CUDA toolkit to build")
    return path


def build_kernels(ptxas_verbose: bool = False) -> str:
    """Compile every kernel source for sm_90a into the build directory, one
    nvcc per source, all started together (always, when `ptxas_verbose`;
    else only the libraries older than their sources). Returns the
    compilers' output (`-Xptxas -v` reports registers, local memory and
    spills per kernel)."""
    with _lock:
        todo = [name for name, (lib, srcs) in _CUDA_LIBS.items()
                if ptxas_verbose or not lib.exists() or lib.stat().st_mtime
                < max(s.stat().st_mtime for s in srcs)]
        if not todo:
            return ""
        flags = NVCC_FLAGS + (["-Xptxas", "-v"] if ptxas_verbose else [])
        nvcc = _nvcc()
        logs: Dict[str, str] = {}
        errors = []

        def build(name):
            lib, srcs = _CUDA_LIBS[name]
            try:
                logs[name] = compile_shared([nvcc] + flags, [srcs[0]], lib,
                                            timeout=900)
            except Exception as e:   # re-raised below, on the caller's thread
                errors.append(e)
        threads = [threading.Thread(target=build, args=(n,)) for n in todo]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for name in todo:
            _cuda_handles.pop(name, None)
        if errors:
            raise errors[0]
        return "".join(logs[n] for n in todo)


def _lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name` (a key of _CUDA_LIBS), built if
    stale. The check runs at the library's first use in the process, not
    at every launch: it stats every library and source, which costs
    milliseconds per launch where the file system is slow."""
    lib = _cuda_handles.get(name)
    if lib is not None:
        return lib
    stage_call(build_kernels, what="kernel build", hang_warn_s=600.0)
    with _lock:
        lib = _cuda_handles.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_CUDA_LIBS[name][0]))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            rays = [p, p, p, f]                  # origins, dirs, limit, tmin
            if name == "bf8":
                tree = [p, p, p, p, p, p, i, i]
                lib.pt_bf8_closest.restype = i
                lib.pt_bf8_closest.argtypes = (tree + rays + [i]
                                               + [p] * 9)
                lib.pt_bf8_threads_per_block.restype = i
                lib.pt_bf8_threads_per_block.argtypes = []
                lib.pt_bf8_occluded.restype = i
                lib.pt_bf8_occluded.argtypes = (tree + rays
                                                + [i, i, p, p, p, p, p])
            elif name == "bf8i":
                tree = [p] * 9 + [i, i]
                closest = getattr(lib, _closest_symbol(name))
                closest.restype = i
                closest.argtypes = (tree + rays
                                    + [i, i, p, p, p, p, p, p, p, p, p])
                occluded = getattr(lib, _occluded_symbol(name))
                occluded.restype = i
                occluded.argtypes = tree + rays + [i, i, p, p, p, p, p, p]
            elif name == "bf8w":        # K1 and closest_v6: closest only
                lib.pt_bf8w_closest.restype = i
                lib.pt_bf8w_closest.argtypes = ([p] * 6 + [i, i] + rays
                                                + [i] + [p] * 5)
                lib.pt_bf8w_closest_pops.restype = i
                lib.pt_bf8w_closest_pops.argtypes = ([p] * 6 + [i, i] + rays
                                                     + [i] + [p] * 6)
                lib.pt_bf8w_threads_per_block.restype = i
                lib.pt_bf8w_threads_per_block.argtypes = []
                lib.pt_bf8w_closest_v6.restype = i
                lib.pt_bf8w_closest_v6.argtypes = ([p] * 5 + [i] * 3 + rays
                                                   + [i] + [p] * 5)
                lib.pt_bf8w_blocks_per_sm.restype = i
                lib.pt_bf8w_blocks_per_sm.argtypes = [i]
                lib.pt_bf8w_smem_per_block.restype = i
                lib.pt_bf8w_smem_per_block.argtypes = []
            elif name == "bf8wo":       # K2 and occluded_v6: occlusion only
                lib.pt_bf8wo_occluded.restype = i
                lib.pt_bf8wo_occluded.argtypes = ([p] * 6 + [i, i] + rays
                                                  + [i, i, p, p])
                lib.pt_bf8wo_occluded_v6.restype = i
                lib.pt_bf8wo_occluded_v6.argtypes = ([p] * 5 + [i] * 3
                                                     + rays + [i, p, p])
                lib.pt_bf8wo_blocks_per_sm.restype = i
                lib.pt_bf8wo_blocks_per_sm.argtypes = [i]
                lib.pt_bf8wo_smem_per_block.restype = i
                lib.pt_bf8wo_smem_per_block.argtypes = []
            elif name == "ordw":        # closest_ordered: closest only
                lib.pt_ordw_closest.restype = i
                lib.pt_ordw_closest.argtypes = ([p] * 5 + [i] * 3 + rays
                                                + [i] + [p] * 5)
                lib.pt_ordw_blocks_per_sm.restype = i
                lib.pt_ordw_blocks_per_sm.argtypes = [i]
                lib.pt_ordw_smem_per_block.restype = i
                lib.pt_ordw_smem_per_block.argtypes = []
            elif name == "v6w":         # closest_v6k2 and closest_v7
                lib.pt_v6w_closest.restype = i
                lib.pt_v6w_closest.argtypes = ([p] * 5 + [i] * 3 + rays
                                               + [i, i, i] + [p] * 5)
                lib.pt_v6w_blocks_per_sm.restype = i
                lib.pt_v6w_blocks_per_sm.argtypes = [i]
                lib.pt_v6w_smem_per_block.restype = i
                lib.pt_v6w_smem_per_block.argtypes = []
            elif name == "alpha":       # the split loops' round kernels
                for fn in (lib.pt_alpha_closest_round,
                           lib.pt_alpha_shadow_round):
                    fn.restype = i
                    fn.argtypes = [p] * 5 + [i, p]   # structs, n, stream
            elif name in _WARP_LIBS:    # no counted variant
                # v4w: five pointers, three ints; bf8iw: nine pointers, two
                # ints, and an int flag (raw_ids, opaque_only)
                tree, flags = (([p] * 5 + [i] * 3, []) if name == "v4w"
                               else ([p] * 9 + [i, i], [i]))
                closest = getattr(lib, _closest_symbol(name))
                closest.restype = i
                closest.argtypes = tree + rays + flags + [i] + [p] * 5
                occluded = getattr(lib, _occluded_symbol(name))
                occluded.restype = i
                occluded.argtypes = tree + rays + flags + [i, p, p]
                getattr(lib, f"pt_{name}_blocks_per_sm").restype = i
                getattr(lib, f"pt_{name}_blocks_per_sm").argtypes = [i]
                getattr(lib, f"pt_{name}_smem_per_block").restype = i
                getattr(lib, f"pt_{name}_smem_per_block").argtypes = []
            else:           # v4, ordered, v6: five pointers, three ints
                tree = [p, p, p, p, p, i, i, i]
                flags = [i, i] if name == "v6" else []  # walk, window
                closest = getattr(lib, _closest_symbol(name))
                closest.restype = i
                closest.argtypes = (tree + rays + flags
                                    + [i, p, p, p, p, p, p, p, p])
                if name != "ordered":
                    occluded = getattr(lib, _occluded_symbol(name))
                    occluded.restype = i
                    occluded.argtypes = tree + rays + [i, p, p, p, p, p]
            lib.pt_cuda_error_string.restype = ctypes.c_char_p
            lib.pt_cuda_error_string.argtypes = [i]
            _cuda_handles[name] = lib
        return lib


# the per-ray K3-K6 (v4_kernels.cu, bf8i_kernels.cu) are exported under
# this suffix (K1's and closest_v6's per-ray designs keep their names)
_PER_RAY = {"v4": "_per_ray", "bf8i": "_per_ray"}
# the warp-cooperative K3/K4, K5/K6, K1 with closest_v6, K2 with
# occluded_v6, closest_ordered, and closest_v6k2 with closest_v7: no
# counted variant
_WARP_LIBS = ("v4w", "bf8iw", "bf8w", "bf8wo", "ordw", "v6w")


def _closest_symbol(lib_name: str) -> str:
    return f"pt_{lib_name}_closest" + _PER_RAY.get(lib_name, "")


def _occluded_symbol(lib_name: str) -> str:
    return f"pt_{lib_name}_occluded" + _PER_RAY.get(lib_name, "")


def _check_rays(bvh, origins, dirs, limit, what: str) -> int:
    """Validate the rays against what the kernels take; returns N."""
    dev = bvh.device
    n = origins.shape[0] if origins.dim() == 2 else -1
    for name, a, shape, dtype in (("origins", origins, (n, 3), torch.float32),
                                  ("dirs", dirs, (n, 3), torch.float32),
                                  (what, limit, (n,), torch.float32)):
        if tuple(a.shape) != shape or n < 0:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(a.shape)}")
        if a.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {a.dtype}")
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, the BVH on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no traversal kernel for device {dev}")
    return n


def _check(bvh8, origins, dirs, limit, what: str) -> int:
    """`_check_rays` plus the stack bound of a BF8BVH or BF8Instanced."""
    n = _check_rays(bvh8, origins, dirs, limit, what)
    if bvh8.stack_bound > BF8_STACK:
        raise ValueError(f"BF8 tree depth {bvh8.depth} needs a stack of "
                         f"{bvh8.stack_bound} entries; the kernels hold "
                         f"{BF8_STACK}")
    return n


def _check_pops(pops, n: int, device) -> None:
    """`pops` must be a contiguous (N,) int32 tensor on the rays' device."""
    if not isinstance(pops, torch.Tensor):
        raise TypeError(f"pops: expected a tensor, got {type(pops).__name__}")
    if tuple(pops.shape) != (n,):
        raise ValueError(f"pops: expected shape {(n,)}, got "
                         f"{tuple(pops.shape)}")
    if pops.dtype != torch.int32:
        raise TypeError(f"pops: expected torch.int32, got {pops.dtype}")
    if pops.device != device:
        raise ValueError(f"pops is on {pops.device}, the rays on {device}")
    if not pops.is_contiguous():
        raise ValueError("pops must be contiguous")


def bf8_threads_per_block(device) -> int:
    """Threads per block of K1's launches, its pops launch's included: lane
    i runs in block i // T and warp (i % T) // 32. On the card the built
    library reports it (`pt_bf8w_threads_per_block`); on the CPU, where
    nothing is built, it is read from the same constant in
    csrc/bf8_warp_kernels.cu."""
    if torch.device(device).type == "cuda":
        return int(_lib("bf8w").pt_bf8w_threads_per_block())
    src = (CSRC / "bf8_warp_kernels.cu").read_text()
    return int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))


def _tree_args(bvh8: BF8BVH):
    for a in (bvh8.c_lo, bvh8.c_hi, bvh8.c_ent, bvh8.l_lo, bvh8.l_hi,
              bvh8.pages):
        if not a.is_contiguous():
            raise ValueError("BF8BVH tensors must be contiguous")
    if bvh8.c_ent.dtype != torch.int32 or bvh8.pages.dtype != torch.float32:
        raise TypeError("BF8BVH: c_ent must be int32 and pages float32")
    return (bvh8.c_lo.data_ptr(), bvh8.c_hi.data_ptr(),
            bvh8.c_ent.data_ptr(), bvh8.l_lo.data_ptr(),
            bvh8.l_hi.data_ptr(), bvh8.pages.data_ptr(), bvh8.block,
            bvh8.pages.shape[-1])


def _tree_args_bf8i(bvh: BF8Instanced):
    n8, n_leaves = bvh.n8, bvh.n_leaves
    f32, i32 = torch.float32, torch.int32
    for name, shape, dtype in (("c_lo", (n8 * 8, 3), f32),
                               ("c_hi", (n8 * 8, 3), f32),
                               ("c_ent", (n8 * 8,), i32),
                               ("l_lo", (n_leaves, 3), f32),
                               ("l_hi", (n_leaves, 3), f32),
                               ("leaf_page", (n_leaves,), i32),
                               ("leaf_seg", (n_leaves,), i32),
                               ("seg_inv", (bvh.n_segs * 12,), f32)):
        a = getattr(bvh, name)
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise TypeError(f"BF8Instanced.{name}: expected {shape} {dtype}, "
                            f"got {tuple(a.shape)} {a.dtype}")
        if not a.is_contiguous() or a.device != bvh.device:
            raise ValueError("BF8Instanced tensors must be contiguous and "
                             "on one device")
    if bvh.pages.dtype != f32 or not bvh.pages.is_contiguous():
        raise TypeError("BF8Instanced: pages must be contiguous float32")
    if n8 < 1 or bvh.pages.shape[-1] < 7 * bvh.block:
        raise ValueError("BF8Instanced: empty tree or pages narrower than "
                         "7 * block")
    return (bvh.c_lo.data_ptr(), bvh.c_hi.data_ptr(), bvh.c_ent.data_ptr(),
            bvh.l_lo.data_ptr(), bvh.l_hi.data_ptr(),
            bvh.leaf_page.data_ptr(), bvh.leaf_seg.data_ptr(),
            bvh.seg_inv.data_ptr(), bvh.pages.data_ptr(), bvh.block,
            bvh.pages.shape[-1])


def _tree_args_v4(pbvh: PacketBVH):
    n_top = pbvh.n_top
    for a, shape, dtype in ((pbvh.top_lo, (n_top, 3), torch.float32),
                            (pbvh.top_hi, (n_top, 3), torch.float32),
                            (pbvh.top_miss, (n_top,), torch.int32),
                            (pbvh.top_leaf, (n_top,), torch.int32)):
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise TypeError(f"PacketBVH: expected {shape} {dtype}, got "
                            f"{tuple(a.shape)} {a.dtype}")
        if not a.is_contiguous() or a.device != pbvh.device:
            raise ValueError("PacketBVH tensors must be contiguous and on "
                             "one device")
    if pbvh.pages.dtype != torch.float32 or not pbvh.pages.is_contiguous():
        raise TypeError("PacketBVH: pages must be contiguous float32")
    if n_top < 1 or pbvh.pages.shape[-1] < 7 * pbvh.block:
        raise ValueError("PacketBVH: empty tree or pages narrower than "
                         "7 * block")
    return (pbvh.top_lo.data_ptr(), pbvh.top_hi.data_ptr(),
            pbvh.top_miss.data_ptr(), pbvh.top_leaf.data_ptr(),
            pbvh.pages.data_ptr(), n_top, pbvh.block, pbvh.pages.shape[-1])


def _tree_args_v6(bvh6):
    n8, rows = bvh6.n8, bvh6.n8 * 8 + bvh6.n_leaves
    f32, i32 = torch.float32, torch.int32
    for name, shape, dtype in (("u_lo", (rows, 3), f32),
                               ("u_hi", (rows, 3), f32),
                               ("c_ent", (n8 * 8,), i32),
                               ("c_order", (n8 * 8,), i32)):
        a = getattr(bvh6, name)
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise TypeError(f"BF8V6.{name}: expected {shape} {dtype}, got "
                            f"{tuple(a.shape)} {a.dtype}")
        if not a.is_contiguous() or a.device != bvh6.device:
            raise ValueError("BF8V6 tensors must be contiguous and on one "
                             "device")
    if bvh6.pages.dtype != f32 or not bvh6.pages.is_contiguous():
        raise TypeError("BF8V6: pages must be contiguous float32")
    if n8 < 1 or bvh6.pages.shape[-1] < 7 * bvh6.block:
        raise ValueError("BF8V6: empty tree or pages narrower than "
                         "7 * block")
    return (bvh6.u_lo.data_ptr(), bvh6.u_hi.data_ptr(),
            bvh6.c_ent.data_ptr(), bvh6.c_order.data_ptr(),
            bvh6.pages.data_ptr(), n8, bvh6.block, bvh6.pages.shape[-1])


class WorkCounts(NamedTuple):
    """What a counted launch did, for bounds from the run's own data.
    `totals` int64, summed over rays: for a BF8BVH or BF8V6 (3,) wide-node
    visits, leaf-box retests and triangle tests; for a PacketBVH (2,) box
    tests (K3/K4: one per node visit; the ordered walk: the root's and two
    per internal node whose box passed, its pop retests not counted) and
    triangle tests. `node_seen` (n8,) or (n_top,)
    and `tri_seen` (L*block,) uint8: 1 where any ray visited the node (read
    its box) or tested the page column (leaf * block + j)."""
    totals: torch.Tensor
    node_seen: torch.Tensor
    tri_seen: torch.Tensor


class InstancedWorkCounts(NamedTuple):
    """WorkCounts of a launch over a BF8Instanced, in the kernels' argument
    order. `totals` (4,) int64: wide-node visits, leaf-box retests, leaf
    visits and triangle tests. `node_seen` (n8,), `leaf_seen` (L,) and
    `tri_seen` (pages*block,) uint8: 1 where any ray visited the node,
    visited the leaf (read its page and segment indices and its transform)
    or tested the shared page column (page * block + j)."""
    totals: torch.Tensor
    node_seen: torch.Tensor
    leaf_seen: torch.Tensor
    tri_seen: torch.Tensor


def work_counts(bvh):
    """Zeroed WorkCounts for launches over `bvh` (a BF8BVH, BF8V6 or
    PacketBVH; InstancedWorkCounts for a BF8Instanced), on its device."""
    def zeros(n, dtype):
        return torch.zeros(n, dtype=dtype, device=bvh.device)
    tri_seen = zeros(bvh.pages.shape[0] * bvh.block, torch.uint8)
    if isinstance(bvh, BF8Instanced):
        return InstancedWorkCounts(zeros(4, torch.int64),
                                   zeros(bvh.n8, torch.uint8),
                                   zeros(bvh.n_leaves, torch.uint8), tri_seen)
    n_totals, n_nodes = ((2, bvh.n_top) if isinstance(bvh, PacketBVH)
                         else (3, bvh.n8))
    return WorkCounts(zeros(n_totals, torch.int64),
                      zeros(n_nodes, torch.uint8), tri_seen)


def _counts_ptrs(counts, bvh):
    """Launcher arguments for `counts`: null pointers when None, which
    selects the uncounted kernel variant."""
    want = work_counts(bvh)
    if counts is None:
        return (None,) * len(want)
    if len(counts) != len(want) or any(
            a.shape != w.shape or a.dtype != w.dtype or a.device != w.device
            or not a.is_contiguous() for a, w in zip(counts, want)):
        raise ValueError("counts must be shaped as work_counts(bvh)")
    return tuple(a.data_ptr() for a in counts)


def _raise_on(lib, code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.pt_cuda_error_string(code).decode()}")


def _launch_closest(name: str, lib_name: str, tree_args, bvh, origins, dirs,
                    tmax, tmin: float, n: int,
                    counts=None, flags=(), tail=(), symbol=None) -> Hit:
    """Allocate the outputs and launch closest kernel `name` on the rays'
    stream; adds one to its launch count. `flags`: the kernel's int
    arguments between tmin and n; `counts`: the counted variant's (not for
    a warp library, which has none); `tail`: its pointers between the
    counts' and the stream; `symbol`: the launcher, where it is not the
    library's closest one."""
    t = torch.empty(n, dtype=torch.float32, device=origins.device)
    tri = torch.empty(n, dtype=torch.int32, device=origins.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n == 0:
        return Hit(t, tri, u, v)
    lib = _lib(lib_name)
    stream = torch.cuda.current_stream(origins.device).cuda_stream
    counted = () if lib_name in _WARP_LIBS else _counts_ptrs(counts, bvh)
    code = getattr(lib, symbol or _closest_symbol(lib_name))(
        *tree_args, origins.data_ptr(), dirs.data_ptr(), tmax.data_ptr(),
        float(tmin), *flags, n, t.data_ptr(), tri.data_ptr(), u.data_ptr(),
        v.data_ptr(), *counted, *tail, stream)
    _raise_on(lib, code, name)
    launches[name] += 1
    return Hit(t, tri, u, v)


def _launch_occluded(name: str, lib_name: str, tree_args, bvh, origins,
                     dirs, dist, tmin: float, n: int, counts=None,
                     flags=(), symbol=None) -> torch.Tensor:
    """As `_launch_closest`, for an occlusion kernel: a bool (N,)."""
    out = torch.empty(n, dtype=torch.uint8, device=origins.device)
    if n == 0:
        return out.view(torch.bool)
    lib = _lib(lib_name)
    stream = torch.cuda.current_stream(origins.device).cuda_stream
    counted = () if lib_name in _WARP_LIBS else _counts_ptrs(counts, bvh)
    code = getattr(lib, symbol or _occluded_symbol(lib_name))(
        *tree_args, origins.data_ptr(), dirs.data_ptr(), dist.data_ptr(),
        float(tmin), *flags, n, out.data_ptr(), *counted, stream)
    _raise_on(lib, code, name)
    launches[name] += 1
    return out.view(torch.bool)


def closest_bf8(bvh8: BF8BVH, origins: torch.Tensor, dirs: torch.Tensor,
                tmax: torch.Tensor, tmin: float = 1e-5,
                pops: Optional[torch.Tensor] = None) -> Hit:
    """Closest hit of N rays (origins/dirs (N,3) f32, tmax (N,) f32) over a
    BF8BVH. Returns Hit(t, tri, u, v); a miss gives t = tmax, tri = -1. On
    the card it launches the warp kernel (bf8_warp_kernels.cu): each ray
    walks as the per-ray kernel does, and the warp tests each pending leaf
    together. `pops`, a (N,) int32 tensor on the rays' device, selects its
    pops instance (launch count `launches["closest_bf8_pops"]`), which B1/B2
    read: each lane writes the iterations of its walk loop there, one per
    pop of a wide node or a leaf, and the hits stay the same (on the CPU
    `closest_bf8_walk_plain` fills it). Its counted variant is the per-ray
    one (`closest_bf8_per_ray(..., counts=)`), since the walk is the
    same."""
    n = _check(bvh8, origins, dirs, tmax, "tmax")
    if pops is not None:
        _check_pops(pops, n, origins.device)
    if origins.device.type == "cpu":
        if pops is None:
            return closest_bf8_plain(bvh8, origins, dirs, tmax, tmin)
        hit, walked = closest_bf8_walk_plain(bvh8, origins, dirs, tmax, tmin)
        pops.copy_(walked)
        return hit
    _check_warp_pages(bvh8)
    if pops is None:
        return _launch_closest("closest_bf8", "bf8w", _tree_args(bvh8), bvh8,
                               origins, dirs, tmax, tmin, n)
    return _launch_closest("closest_bf8_pops", "bf8w", _tree_args(bvh8),
                           bvh8, origins, dirs, tmax, tmin, n,
                           tail=(pops.data_ptr(),),
                           symbol="pt_bf8w_closest_pops")


def closest_bf8_per_ray(bvh8: BF8BVH, origins: torch.Tensor,
                        dirs: torch.Tensor, tmax: torch.Tensor,
                        tmin: float = 1e-5,
                        counts: Optional[WorkCounts] = None,
                        pops: Optional[torch.Tensor] = None) -> Hit:
    """K1's first design, one thread per ray testing each leaf alone
    (bf8_kernels.cu): the baseline arm of the A/B against closest_bf8 (and,
    with `pops`, against its pops instance), and its counted variant.
    `counts`, from `work_counts(bvh8)` on the card, selects the counted
    variant, which adds the launch's work there. `pops` as for closest_bf8
    (launch count `launches["closest_bf8_pops_per_ray"]`): the same pops
    and hits. Nothing on the render path calls it."""
    n = _check(bvh8, origins, dirs, tmax, "tmax")
    if pops is not None:
        _check_pops(pops, n, origins.device)
    if origins.device.type == "cpu":
        if pops is None:
            return closest_bf8_plain(bvh8, origins, dirs, tmax, tmin)
        hit, walked = closest_bf8_walk_plain(bvh8, origins, dirs, tmax, tmin)
        pops.copy_(walked)
        return hit
    return _launch_closest("closest_bf8_per_ray" if pops is None
                           else "closest_bf8_pops_per_ray", "bf8",
                           _tree_args(bvh8), bvh8, origins, dirs, tmax, tmin,
                           n, counts,
                           tail=(None if pops is None else pops.data_ptr(),))


def occluded_bf8(bvh8: BF8BVH, origins: torch.Tensor, dirs: torch.Tensor,
                 dist: torch.Tensor, tmin: float = 1e-5,
                 opaque_only: bool = False) -> torch.Tensor:
    """Any hit with tmin < t < dist for N rays over a BF8BVH; bool (N,).
    With `opaque_only`, triangles tagged ALPHA_TRI_BIT are ignored. On the
    card it launches the warp kernel (bf8_occluded_warp_kernels.cu): each
    ray walks as the per-ray kernel does, the warp tests each pending leaf
    together, and an occluded ray leaves its group. Its counted variant is
    the per-ray one (`occluded_bf8_per_ray(..., counts=)`), since the walk
    is the same."""
    n = _check(bvh8, origins, dirs, dist, "dist")
    if origins.device.type == "cpu":
        return occluded_bf8_plain(bvh8, origins, dirs, dist, tmin,
                                  opaque_only)
    _check_warp_pages(bvh8)
    return _launch_occluded("occluded_bf8", "bf8wo", _tree_args(bvh8), bvh8,
                            origins, dirs, dist, tmin, n,
                            flags=(int(bool(opaque_only)),))


def occluded_bf8_per_ray(bvh8: BF8BVH, origins: torch.Tensor,
                         dirs: torch.Tensor, dist: torch.Tensor,
                         tmin: float = 1e-5, opaque_only: bool = False,
                         counts: Optional[WorkCounts] = None
                         ) -> torch.Tensor:
    """K2's first design, one thread per ray testing each leaf alone
    (bf8_kernels.cu): the baseline arm of the A/B against occluded_bf8, and
    its counted variant (`counts` as for closest_bf8_per_ray). Nothing on
    the render path calls it."""
    n = _check(bvh8, origins, dirs, dist, "dist")
    if origins.device.type == "cpu":
        return occluded_bf8_plain(bvh8, origins, dirs, dist, tmin,
                                  opaque_only)
    return _launch_occluded("occluded_bf8_per_ray", "bf8", _tree_args(bvh8),
                            bvh8, origins, dirs, dist, tmin, n, counts,
                            flags=(int(bool(opaque_only)),))


def _check_warp_pages(bvh) -> None:
    """The warp kernels stage a page in chunks of 32 columns by 16-byte
    copies: block % 32 == 0 (every builder's page-group granularity),
    page width % 4 == 0 and a 16-byte aligned base. A tree that fails
    raises: no warp wrapper falls back to the per-ray kernel."""
    if (bvh.block % 32 or bvh.pages.shape[-1] % 4
            or bvh.pages.data_ptr() % 16):
        raise ValueError(f"{type(bvh).__name__}: block {bvh.block} and page "
                         f"width {bvh.pages.shape[-1]} must be multiples of "
                         "32 and 4 and the pages 16-byte aligned")


def closest_v4(pbvh: PacketBVH, origins: torch.Tensor, dirs: torch.Tensor,
               tmax: torch.Tensor, tmin: float = 1e-5) -> Hit:
    """Closest hit of N rays over a binary PacketBVH (the Morton tree of an
    animated frame, or a static SAH tree whose BF8 collapse did not fit).
    Arguments and result as closest_bf8. On the card it launches the warp
    kernel (v4_warp_kernels.cu): each ray walks as the per-ray kernel does,
    and the warp tests each pending leaf together. Its counted variant is
    the per-ray one (`closest_v4_per_ray(..., counts=)`), since the walk is
    the same."""
    n = _check_rays(pbvh, origins, dirs, tmax, "tmax")
    if origins.device.type == "cpu":
        return closest_v4_plain(pbvh, origins, dirs, tmax, tmin)
    _check_warp_pages(pbvh)
    return _launch_closest("closest_v4", "v4w", _tree_args_v4(pbvh), pbvh,
                           origins, dirs, tmax, tmin, n)


def occluded_v4(pbvh: PacketBVH, origins: torch.Tensor, dirs: torch.Tensor,
                dist: torch.Tensor, tmin: float = 1e-5) -> torch.Tensor:
    """Any hit with tmin < t < dist for N rays over a PacketBVH; bool (N,).
    An alpha-tagged triangle occludes like any other. On the card the warp
    kernel, as closest_v4; counted variant: `occluded_v4_per_ray`."""
    n = _check_rays(pbvh, origins, dirs, dist, "dist")
    if origins.device.type == "cpu":
        return occluded_v4_plain(pbvh, origins, dirs, dist, tmin)
    _check_warp_pages(pbvh)
    return _launch_occluded("occluded_v4", "v4w", _tree_args_v4(pbvh), pbvh,
                            origins, dirs, dist, tmin, n)


# the kernels of each warp library, in its blocks_per_sm argument's order
_WARP_KERNELS = {"v4w": ("closest", "occluded"),
                 "bf8iw": ("closest", "occluded"),
                 "bf8w": ("closest_bf8", "closest_v6"),
                 "bf8wo": ("occluded_bf8", "occluded_v6"),
                 "ordw": ("closest_ordered",),
                 "v6w": ("closest_v6k2", "closest_v7")}


def warp_occupancy(lib_name: str, device) -> Dict[str, int]:
    """A warp library's ("v4w": K3/K4, "bf8iw": K5/K6, "bf8w": K1 and
    closest_v6, "bf8wo": K2 and occluded_v6, "ordw": closest_ordered,
    "v6w": closest_v6k2 and closest_v7)
    resident blocks per SM of each kernel (`<kernel>_blocks_per_sm`) and
    static shared memory per block, as the built library reports them."""
    if lib_name not in _WARP_LIBS:
        raise ValueError(f"{lib_name!r} is not a warp library: {_WARP_LIBS}")
    if torch.device(device).type != "cuda":
        raise ValueError("the warp kernels' occupancy needs the card")
    lib = _lib(lib_name)
    per_sm = getattr(lib, f"pt_{lib_name}_blocks_per_sm")
    out = {f"{k}_blocks_per_sm": int(per_sm(j))
           for j, k in enumerate(_WARP_KERNELS[lib_name])}
    out["smem_bytes_per_block"] = int(
        getattr(lib, f"pt_{lib_name}_smem_per_block")())
    return out


def closest_v4_per_ray(pbvh: PacketBVH, origins: torch.Tensor,
                       dirs: torch.Tensor, tmax: torch.Tensor,
                       tmin: float = 1e-5,
                       counts: Optional[WorkCounts] = None) -> Hit:
    """K3's first design, one thread per ray testing each leaf alone
    (v4_kernels.cu): the baseline arm of the A/B against closest_v4, and
    its counted variant (`counts` as for closest_bf8). Nothing on the
    render path calls it."""
    n = _check_rays(pbvh, origins, dirs, tmax, "tmax")
    if origins.device.type == "cpu":
        return closest_v4_plain(pbvh, origins, dirs, tmax, tmin)
    return _launch_closest("closest_v4_per_ray", "v4", _tree_args_v4(pbvh),
                           pbvh, origins, dirs, tmax, tmin, n, counts)


def occluded_v4_per_ray(pbvh: PacketBVH, origins: torch.Tensor,
                        dirs: torch.Tensor, dist: torch.Tensor,
                        tmin: float = 1e-5,
                        counts: Optional[WorkCounts] = None) -> torch.Tensor:
    """K4's first design, one thread per ray: the baseline arm of the A/B
    against occluded_v4, and its counted variant."""
    n = _check_rays(pbvh, origins, dirs, dist, "dist")
    if origins.device.type == "cpu":
        return occluded_v4_plain(pbvh, origins, dirs, dist, tmin)
    return _launch_occluded("occluded_v4_per_ray", "v4", _tree_args_v4(pbvh),
                            pbvh, origins, dirs, dist, tmin, n, counts)


def closest_bf8i(bvh: BF8Instanced, origins: torch.Tensor,
                 dirs: torch.Tensor, tmax: torch.Tensor, tmin: float = 1e-5,
                 raw_ids: bool = False) -> Hit:
    """Closest hit of N rays over a BF8Instanced. Hit ids carry the segment
    in bits [SEG_SHIFT, SEG_SHIFT + 10) and the mesh-local triangle id below
    (`decode_instanced_tri`); `raw_ids` keeps ALPHA_TRI_BIT. A miss gives
    t = tmax, tri = -1. On the card it launches the warp kernel
    (bf8i_warp_kernels.cu): each ray walks as the per-ray kernel does, and
    the warp tests each pending shared page together. Its counted variant
    is the per-ray one (`closest_bf8i_per_ray(..., counts=)`)."""
    n = _check(bvh, origins, dirs, tmax, "tmax")
    if origins.device.type == "cpu":
        return closest_bf8i_plain(bvh, origins, dirs, tmax, tmin, raw_ids)
    _check_warp_pages(bvh)
    return _launch_closest("closest_bf8i", "bf8iw", _tree_args_bf8i(bvh), bvh,
                           origins, dirs, tmax, tmin, n,
                           flags=(int(bool(raw_ids)),))


def occluded_bf8i(bvh: BF8Instanced, origins: torch.Tensor,
                  dirs: torch.Tensor, dist: torch.Tensor, tmin: float = 1e-5,
                  opaque_only: bool = False) -> torch.Tensor:
    """Any hit with tmin < t < dist for N rays over a BF8Instanced; bool
    (N,). With `opaque_only`, triangles tagged ALPHA_TRI_BIT are ignored.
    On the card the warp kernel, as closest_bf8i; counted variant:
    `occluded_bf8i_per_ray`."""
    n = _check(bvh, origins, dirs, dist, "dist")
    if origins.device.type == "cpu":
        return occluded_bf8i_plain(bvh, origins, dirs, dist, tmin,
                                   opaque_only)
    _check_warp_pages(bvh)
    return _launch_occluded("occluded_bf8i", "bf8iw", _tree_args_bf8i(bvh),
                            bvh, origins, dirs, dist, tmin, n,
                            flags=(int(bool(opaque_only)),))


def closest_bf8i_per_ray(bvh: BF8Instanced, origins: torch.Tensor,
                         dirs: torch.Tensor, tmax: torch.Tensor,
                         tmin: float = 1e-5, raw_ids: bool = False,
                         counts: Optional[InstancedWorkCounts] = None) -> Hit:
    """K5's first design, one thread per ray testing each leaf alone
    (bf8i_kernels.cu): the baseline arm of the A/B against closest_bf8i,
    and its counted variant (`counts` from `work_counts(bvh)`). Nothing on
    the render path calls it."""
    n = _check(bvh, origins, dirs, tmax, "tmax")
    if origins.device.type == "cpu":
        return closest_bf8i_plain(bvh, origins, dirs, tmax, tmin, raw_ids)
    return _launch_closest("closest_bf8i_per_ray", "bf8i",
                           _tree_args_bf8i(bvh), bvh, origins, dirs, tmax,
                           tmin, n, counts, flags=(int(bool(raw_ids)),))


def occluded_bf8i_per_ray(bvh: BF8Instanced, origins: torch.Tensor,
                          dirs: torch.Tensor, dist: torch.Tensor,
                          tmin: float = 1e-5, opaque_only: bool = False,
                          counts: Optional[InstancedWorkCounts] = None
                          ) -> torch.Tensor:
    """K6's first design, one thread per ray: the baseline arm of the A/B
    against occluded_bf8i, and its counted variant."""
    n = _check(bvh, origins, dirs, dist, "dist")
    if origins.device.type == "cpu":
        return occluded_bf8i_plain(bvh, origins, dirs, dist, tmin,
                                   opaque_only)
    return _launch_occluded("occluded_bf8i_per_ray", "bf8i",
                            _tree_args_bf8i(bvh), bvh, origins, dirs, dist,
                            tmin, n, counts, flags=(int(bool(opaque_only)),))


def _check_ordered(pbvh, origins, dirs, tmax) -> int:
    """`_check_rays` plus the ordered walk's stack bound: ORDERED_STACK
    entries; a tree with more levels raises (`pbvh.depth`, worked out once
    on the host)."""
    n = _check_rays(pbvh, origins, dirs, tmax, "tmax")
    if pbvh.depth > ORDERED_STACK:
        raise ValueError(f"binary tree depth {pbvh.depth} needs a stack of "
                         f"{pbvh.depth} entries; the ordered kernel holds "
                         f"{ORDERED_STACK}")
    return n


def closest_ordered(pbvh: PacketBVH, origins: torch.Tensor,
                    dirs: torch.Tensor, tmax: torch.Tensor,
                    tmin: float = 1e-5,
                    counts: Optional[WorkCounts] = None) -> Hit:
    """Closest hit of N rays over a binary PacketBVH by the ordered
    (near-child-first) stack walk. Arguments and result as closest_bf8. On
    the card it launches the warp kernel (ordered_warp_kernels.cu): each
    ray walks as the per-ray kernel does, and the warp tests each pending
    leaf together. `counts` runs the per-ray counted variant instead
    (`closest_ordered_per_ray(..., counts=)`), since the walk is the same."""
    if counts is not None:
        return closest_ordered_per_ray(pbvh, origins, dirs, tmax, tmin,
                                       counts)
    n = _check_ordered(pbvh, origins, dirs, tmax)
    if origins.device.type == "cpu":
        return closest_ordered_plain(pbvh, origins, dirs, tmax, tmin)
    _check_warp_pages(pbvh)
    return _launch_closest("closest_ordered", "ordw", _tree_args_v4(pbvh),
                           pbvh, origins, dirs, tmax, tmin, n)


def closest_ordered_per_ray(pbvh: PacketBVH, origins: torch.Tensor,
                            dirs: torch.Tensor, tmax: torch.Tensor,
                            tmin: float = 1e-5,
                            counts: Optional[WorkCounts] = None) -> Hit:
    """closest_ordered's first design, one thread per ray testing each leaf
    alone (ordered_kernels.cu): the baseline arm of the A/B against
    closest_ordered, and its counted variant (`counts` as for
    closest_bf8_per_ray). Nothing on the render path calls it."""
    n = _check_ordered(pbvh, origins, dirs, tmax)
    if origins.device.type == "cpu":
        return closest_ordered_plain(pbvh, origins, dirs, tmax, tmin)
    return _launch_closest("closest_ordered_per_ray", "ordered",
                           _tree_args_v4(pbvh), pbvh, origins, dirs, tmax,
                           tmin, n, counts)


def _check_v6(bvh6, origins, dirs, limit, what: str, stack: int) -> int:
    """`_check_rays` plus a BF8V6 walk's stack bound `stack`."""
    n = _check_rays(bvh6, origins, dirs, limit, what)
    if stack > V6_STACK:
        raise ValueError(f"BF8V6 tree depth {bvh6.depth} needs a stack of "
                         f"{stack} entries; the kernels hold {V6_STACK}")
    return n


def closest_v6(bvh6, origins: torch.Tensor, dirs: torch.Tensor,
               tmax: torch.Tensor, tmin: float = 1e-5) -> Hit:
    """Closest hit of N rays over a BF8V6, children pushed in their static
    per-octant order, one pop per iteration (stack 7*D8 + 1). Arguments and
    result as closest_bf8. On the card it launches the warp kernel
    (bf8_warp_kernels.cu, `pt_bf8w_closest_v6`): each ray walks as the
    per-ray kernel does, and the warp tests each pending leaf together. Its
    counted variant is the per-ray one (`closest_v6_per_ray(...,
    counts=)`)."""
    n = _check_v6(bvh6, origins, dirs, tmax, "tmax", bvh6.stack_bound)
    if origins.device.type == "cpu":
        return closest_v6_plain(bvh6, origins, dirs, tmax, tmin)
    _check_warp_pages(bvh6)
    return _launch_closest("closest_v6", "bf8w", _tree_args_v6(bvh6), bvh6,
                           origins, dirs, tmax, tmin, n,
                           symbol="pt_bf8w_closest_v6")


def closest_v6_per_ray(bvh6, origins: torch.Tensor, dirs: torch.Tensor,
                       tmax: torch.Tensor, tmin: float = 1e-5,
                       counts: Optional[WorkCounts] = None) -> Hit:
    """closest_v6's first design, one thread per ray testing each leaf
    alone (v6_kernels.cu): the baseline arm of the A/B against closest_v6,
    and its counted variant (`counts` as for closest_bf8_per_ray). Nothing
    on the render path calls it."""
    n = _check_v6(bvh6, origins, dirs, tmax, "tmax", bvh6.stack_bound)
    if origins.device.type == "cpu":
        return closest_v6_plain(bvh6, origins, dirs, tmax, tmin)
    return _launch_closest("closest_v6_per_ray", "v6", _tree_args_v6(bvh6),
                           bvh6, origins, dirs, tmax, tmin, n, counts,
                           flags=(0, 1))


def closest_v6k2(bvh6, origins: torch.Tensor, dirs: torch.Tensor,
                 tmax: torch.Tensor, tmin: float = 1e-5) -> Hit:
    """closest_v6 with two pops per round, both tested against the best t
    as the round starts (stack 16*D8, see v6_traverse.cuh). On the card it
    launches the warp kernel (v6_warp_kernels.cu, walk 0): each ray walks
    as the per-ray kernel does and lists the leaves whose boxes pass in a
    round, and the warp tests the listed leaves together. Its counted
    variant is the per-ray one (`closest_v6k2_per_ray(..., counts=)`)."""
    n = _check_v6(bvh6, origins, dirs, tmax, "tmax", 16 * bvh6.depth)
    if origins.device.type == "cpu":
        return closest_v6k2_plain(bvh6, origins, dirs, tmax, tmin)
    _check_warp_pages(bvh6)
    return _launch_closest("closest_v6k2", "v6w", _tree_args_v6(bvh6), bvh6,
                           origins, dirs, tmax, tmin, n, flags=(0, 1))


def closest_v6k2_per_ray(bvh6, origins: torch.Tensor, dirs: torch.Tensor,
                         tmax: torch.Tensor, tmin: float = 1e-5,
                         counts: Optional[WorkCounts] = None) -> Hit:
    """closest_v6k2's first design, one thread per ray testing each leaf
    alone (v6_kernels.cu, walk 1): the baseline arm of the A/B against
    closest_v6k2, and its counted variant (`counts` as for
    closest_bf8_per_ray). Nothing on the render path calls it."""
    n = _check_v6(bvh6, origins, dirs, tmax, "tmax", 16 * bvh6.depth)
    if origins.device.type == "cpu":
        return closest_v6k2_plain(bvh6, origins, dirs, tmax, tmin)
    return _launch_closest("closest_v6k2_per_ray", "v6", _tree_args_v6(bvh6),
                           bvh6, origins, dirs, tmax, tmin, n, counts,
                           flags=(1, 1))


def _check_window(window) -> int:
    if int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return int(window)


def closest_v7(bvh6, origins: torch.Tensor, dirs: torch.Tensor,
               tmax: torch.Tensor, tmin: float = 1e-5,
               window: int = 8) -> Hit:
    """Closest hit of N rays over a BF8V6 by pt's v7 walk: rounds of up to
    `window` pops (>= 1) prune against the best t of the last round and
    queue the leaves whose boxes pass, then test the queue (at most 48
    leaves a round; see v6_traverse.cuh). The same function as closest_v6,
    with more leaves visited; stack 7*D8 + 1. On the card it launches the
    warp kernel (v6_warp_kernels.cu, walk 1): each ray walks as the per-ray
    kernel does, and the warp tests the queued leaves together. Its counted
    variant is the per-ray one (`closest_v7_per_ray(..., counts=)`)."""
    window = _check_window(window)
    n = _check_v6(bvh6, origins, dirs, tmax, "tmax", bvh6.stack_bound)
    if origins.device.type == "cpu":
        return closest_v7_plain(bvh6, origins, dirs, tmax, tmin)
    _check_warp_pages(bvh6)
    return _launch_closest("closest_v7", "v6w", _tree_args_v6(bvh6), bvh6,
                           origins, dirs, tmax, tmin, n, flags=(1, window))


def closest_v7_per_ray(bvh6, origins: torch.Tensor, dirs: torch.Tensor,
                       tmax: torch.Tensor, tmin: float = 1e-5,
                       window: int = 8,
                       counts: Optional[WorkCounts] = None) -> Hit:
    """closest_v7's first design, one thread per ray testing each queued
    leaf alone (v6_kernels.cu, walk 2): the baseline arm of the A/B against
    closest_v7, and its counted variant. Nothing on the render path calls
    it."""
    window = _check_window(window)
    n = _check_v6(bvh6, origins, dirs, tmax, "tmax", bvh6.stack_bound)
    if origins.device.type == "cpu":
        return closest_v7_plain(bvh6, origins, dirs, tmax, tmin)
    return _launch_closest("closest_v7_per_ray", "v6", _tree_args_v6(bvh6),
                           bvh6, origins, dirs, tmax, tmin, n, counts,
                           flags=(2, window))


def occluded_v6(bvh6, origins: torch.Tensor, dirs: torch.Tensor,
                dist: torch.Tensor, tmin: float = 1e-5) -> torch.Tensor:
    """Any hit with tmin < t < dist for N rays over a BF8V6; bool (N,).
    Every triangle occludes (pt's v6 has no `opaque_only`). On the card it
    launches the warp kernel (bf8_occluded_warp_kernels.cu,
    `pt_bf8wo_occluded_v6`), as occluded_bf8. Its counted variant is the
    per-ray one (`occluded_v6_per_ray(..., counts=)`)."""
    n = _check_v6(bvh6, origins, dirs, dist, "dist", bvh6.stack_bound)
    if origins.device.type == "cpu":
        return occluded_v6_plain(bvh6, origins, dirs, dist, tmin)
    _check_warp_pages(bvh6)
    return _launch_occluded("occluded_v6", "bf8wo", _tree_args_v6(bvh6),
                            bvh6, origins, dirs, dist, tmin, n,
                            symbol="pt_bf8wo_occluded_v6")


def occluded_v6_per_ray(bvh6, origins: torch.Tensor, dirs: torch.Tensor,
                        dist: torch.Tensor, tmin: float = 1e-5,
                        counts: Optional[WorkCounts] = None) -> torch.Tensor:
    """occluded_v6's first design, one thread per ray testing each leaf
    alone (v6_kernels.cu): the baseline arm of the A/B against occluded_v6,
    and its counted variant. Nothing on the render path calls it."""
    n = _check_v6(bvh6, origins, dirs, dist, "dist", bvh6.stack_bound)
    if origins.device.type == "cpu":
        return occluded_v6_plain(bvh6, origins, dirs, dist, tmin)
    return _launch_occluded("occluded_v6_per_ray", "v6", _tree_args_v6(bvh6),
                            bvh6, origins, dirs, dist, tmin, n, counts)


# ------------------------------------------- the split loops' round kernels

# alpha_round.cuh's structs, field for field; the launchers take pointers
_P, _I = ctypes.c_void_p, ctypes.c_int


class RoundHits(ctypes.Structure):
    """alpha::Hits: the round's trace of the alpha subset tree."""
    _fields_ = [(k, _P) for k in ("t", "tri", "u", "v")]


class RoundTables(ctypes.Structure):
    """alpha::Tables: the alpha subset and the material tables."""
    _fields_ = ([(k, _P) for k in ("sel", "tri_uv", "tri_mat", "mat_tex",
                                   "mat_params")]
                + [(k, _I) for k in ("mat_tex_cols", "t_color",
                                     "mat_params_cols", "f_color")])


class RoundPool(ctypes.Structure):
    """alpha::Pool: a DeviceTextures and its layout."""
    _fields_ = [("data", _P), ("rows", ctypes.c_int64), ("width", _I),
                ("offsets", _P), ("sizes", _P), ("count", _I),
                ("max_mips", _I), ("layout", _I), ("bf16", _I)]


class RoundRay(ctypes.Structure):
    """alpha::NextRay: the loop's directions and the next round's ray."""
    _fields_ = [(k, _P) for k in ("dirs", "o", "d", "t", "root_hi")]


class ClosestRoundState(ctypes.Structure):
    """alpha::ClosestState."""
    _fields_ = [(k, _P) for k in ("pending", "t_accum", "bound", "final_t",
                                  "final_tri", "final_u", "final_v",
                                  "decal_color", "decal_alpha", "has_decal")]


class ShadowRoundState(ctypes.Structure):
    """alpha::ShadowState."""
    _fields_ = [(k, _P) for k in ("pending", "occluded")]


class RoundArgs(NamedTuple):
    """A split loop's arguments to its round kernel besides the round's
    hit, made once a loop (`closest_round_args`, `shadow_round_args`).
    `held`: the lane tensors the structs point into, kept alive with them
    (the tables' tensors belong to the scene and its accel)."""
    state: ctypes.Structure      # ClosestRoundState or ShadowRoundState
    ray: RoundRay
    tables: RoundTables
    pool: RoundPool
    n: int
    held: tuple


# alpha_round.cuh's pool layouts: (layout, values a row)
_ALPHA_LAYOUTS = {"quad": (0, 16), "paired": (1, 8), "flat": (2, 4),
                  "constant": (3, 4)}


def _check_lanes(device, *named) -> None:
    """Each (name, tensor, shape, dtype) must be a contiguous tensor of that
    shape and dtype on `device`."""
    for name, a, shape, dtype in named:
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise TypeError(f"{name}: expected {shape} {dtype}, got "
                            f"{tuple(a.shape)} {a.dtype}")
        if a.device != device or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}, "
                             f"not {a.device}")


def alpha_round_tables(sel, tri_uv, tri_mat, mat_tex, t_color: int,
                       mat_params, f_color: int,
                       tex) -> tuple[RoundTables, RoundPool]:
    """The round kernels' arguments that stay fixed through a loop, checked
    once: the alpha subset's global ids `sel` (K,) int32, the per-triangle
    uv rows `tri_uv` (T, 6) and materials `tri_mat` (T,) int32, the material
    tables `mat_tex` (M, *) int32 with its color column `t_color` and
    `mat_params` (M, *) f32 with its color factor's first column `f_color`,
    and the texture pool `tex` (a DeviceTextures: quad, paired or flat rows,
    or all 1x1 constants, in bf16 or f32), all on the device of the
    rounds."""
    dev = sel.device
    t, m = tri_uv.shape[0], mat_tex.shape[0]
    i32, f32 = torch.int32, torch.float32
    _check_lanes(dev, ("sel", sel, (sel.shape[0],), i32),
                 ("tri_uv", tri_uv, (t, 6), f32),
                 ("tri_mat", tri_mat, (t,), i32),
                 ("mat_tex", mat_tex, (m, mat_tex.shape[1]), i32),
                 ("mat_params", mat_params, (m, mat_params.shape[1]), f32),
                 ("offsets", tex.offsets, tuple(tex.offsets.shape), i32),
                 ("sizes", tex.sizes, tex.offsets.shape + (2,), i32))
    data = tex.data
    if data.dtype not in (torch.bfloat16, f32):
        raise TypeError(f"texture pool: bf16 or f32 rows, not {data.dtype}")
    if data.device != dev or not data.is_contiguous() or data.dim() != 2:
        raise ValueError("texture pool: rows must be a contiguous 2-D tensor "
                         f"on {dev}")
    layout, width = _ALPHA_LAYOUTS[
        "constant" if tex.all_constant else "quad" if tex.quad else
        "paired" if tex.paired else "flat"]
    if data.shape[1] < width or (not tex.all_constant
                                 and data.shape[1] != width):
        raise ValueError(f"texture pool: rows of {data.shape[1]} values do "
                         "not fit its layout")
    return (RoundTables(sel.data_ptr(), tri_uv.data_ptr(), tri_mat.data_ptr(),
                        mat_tex.data_ptr(), mat_params.data_ptr(),
                        mat_tex.shape[1], int(t_color), mat_params.shape[1],
                        int(f_color)),
            RoundPool(data.data_ptr(), data.shape[0], data.shape[1],
                      tex.offsets.data_ptr(), tex.sizes.data_ptr(),
                      tex.offsets.shape[0], tex.offsets.shape[1], layout,
                      int(data.dtype == torch.bfloat16)))


def _next_ray(n: int, dev, dirs, ray, root_hi) -> RoundRay:
    """The next ray `ray` (o (N, 3), d (N, 3), t (N,)), which the kernel
    writes in place; with no root box (`root_hi` None) it writes neither
    `d` nor a degenerate ray."""
    o, d, t = ray
    f32 = torch.float32
    named = [("dirs", dirs, (n, 3), f32), ("ray origins", o, (n, 3), f32),
             ("ray limits", t, (n,), f32)]
    if root_hi is not None:
        named += [("ray directions", d, (n, 3), f32),
                  ("root_hi", root_hi, (3,), f32)]
    _check_lanes(dev, *named)
    if root_hi is None:
        return RoundRay(dirs.data_ptr(), o.data_ptr(), None, t.data_ptr(),
                       None)
    return RoundRay(dirs.data_ptr(), o.data_ptr(), d.data_ptr(), t.data_ptr(),
                   root_hi.data_ptr())


def closest_round_args(pending, t_accum, bound, final: Hit, decal_color,
                       decal_alpha, has_decal, dirs, ray, root_hi,
                       tables) -> RoundArgs:
    """The closest loop's arguments to `alpha_closest_round`, checked once
    a loop: its state on N lanes (`pending` (N,) bool, `t_accum`, the opaque
    hit's t `bound`, the `final` hit (global ids), `decal_color` (N, 3),
    `decal_alpha`, `has_decal` bool), its directions `dirs`, the next
    round's `ray`, the root box's upper corner `root_hi` (or None) and
    `tables` from `alpha_round_tables`. The kernel writes the state and the
    ray in place, and reads a lane's all before it writes any: the buffers
    it writes are the caller's to set up (the integrator's
    `_closest_rounds_start`)."""
    dev, n = pending.device, pending.shape[0]
    f32, b = torch.float32, torch.bool
    _check_lanes(dev, ("pending", pending, (n,), b),
                 ("t_accum", t_accum, (n,), f32), ("bound", bound, (n,), f32),
                 ("final t", final.t, (n,), f32),
                 ("final tri", final.tri, (n,), torch.int32),
                 ("final u", final.u, (n,), f32),
                 ("final v", final.v, (n,), f32),
                 ("decal_color", decal_color, (n, 3), f32),
                 ("decal_alpha", decal_alpha, (n,), f32),
                 ("has_decal", has_decal, (n,), b))
    state = ClosestRoundState(pending.data_ptr(), t_accum.data_ptr(),
                         bound.data_ptr(), *(a.data_ptr() for a in final),
                         decal_color.data_ptr(), decal_alpha.data_ptr(),
                         has_decal.data_ptr())
    return RoundArgs(state, _next_ray(n, dev, dirs, ray, root_hi), *tables,
                     n, (pending, t_accum, bound, *final, decal_color,
                         decal_alpha, has_decal, dirs, *ray, root_hi))


def shadow_round_args(pending, occluded, dirs, ray, root_hi,
                      tables) -> RoundArgs:
    """The shadow loop's arguments to `alpha_shadow_round`: `pending` and
    `occluded` (N,) bool, and the rest as `closest_round_args`."""
    dev, n = pending.device, pending.shape[0]
    _check_lanes(dev, ("pending", pending, (n,), torch.bool),
                 ("occluded", occluded, (n,), torch.bool))
    return RoundArgs(ShadowRoundState(pending.data_ptr(),
                                      occluded.data_ptr()),
                     _next_ray(n, dev, dirs, ray, root_hi), *tables, n,
                     (pending, occluded, dirs, *ray, root_hi))


def round_call_args(hit: Hit, args: RoundArgs) -> tuple:
    """A round launcher's arguments before the stream: pointers to the
    round's hit (t, tri, u, v over the loop's lanes, checked) and to the
    loop's structs, and the lane count."""
    n, f32 = args.n, torch.float32
    _check_lanes(hit.t.device, ("hit t", hit.t, (n,), f32),
                 ("hit tri", hit.tri, (n,), torch.int32),
                 ("hit u", hit.u, (n,), f32), ("hit v", hit.v, (n,), f32))
    hits = RoundHits(*(a.data_ptr() for a in hit))
    return (*(ctypes.byref(x) for x in (hits, args.state, args.ray,
                                        args.tables, args.pool)), n)


def _launch_round(name: str, hit: Hit, args: RoundArgs) -> None:
    """Launch round kernel `name` on the round's `hit` and the loop's `args`
    on the current stream of the hit's device, which must be a CUDA device
    (the integrator runs the plain twins on the CPU)."""
    dev = hit.t.device
    if dev.type != "cuda":
        raise ValueError(f"the round kernels run on a CUDA device, not {dev}")
    call = round_call_args(hit, args)
    if args.n == 0:
        return
    lib = _lib("alpha")
    code = getattr(lib, "pt_" + name)(
        *call, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, code, name)
    launches[name] += 1


def alpha_closest_round(hit: Hit, args: RoundArgs) -> None:
    """One round of the closest split loop, in place: `hit`, the round's
    trace of the alpha subset tree (subset ids), and `args` from
    `closest_round_args`. Launches alpha_round_kernels.cu's closest kernel
    on the current stream, or raises."""
    _launch_round("alpha_closest_round", hit, args)


def alpha_shadow_round(hit: Hit, args: RoundArgs) -> None:
    """One round of the shadow split loop, in place: `hit` and `args` from
    `shadow_round_args`; as `alpha_closest_round`."""
    _launch_round("alpha_shadow_round", hit, args)


# ---------------------------------------------------------------- plain


def decode_pages(bvh):
    """Every valid page column of a BF8BVH or PacketBVH as (W (T,3,3),
    b (T,3), Wd (T,3,3), id (T,) int32 with its ALPHA_TRI_BIT): W and b from
    rows 0-3 of column groups 0-2, Wd from rows 4-6 of groups 3-5, ids from
    row 0 of group 6. Columns with id -1 (padding) are dropped."""
    pages = bvh.pages
    b = bvh.block
    ids = pages[:, 0, 6 * b:7 * b].contiguous().view(torch.int32).reshape(-1)
    valid = ids >= 0
    groups = pages[:, :, :6 * b].reshape(pages.shape[0], 8, 6, b)
    cols = groups.permute(0, 3, 2, 1).reshape(-1, 6, 8)[valid]  # (T, group, row)
    w = cols[:, 0:3, 0:3]           # W_k[j] = row j of group k
    bias = cols[:, 0:3, 3]
    wd = cols[:, 3:6, 4:7]          # row 4+j of group 3+k
    return w.contiguous(), bias.contiguous(), wd.contiguous(), ids[valid]


def _woop_chunk(o, d, w, bias, wd, tmin, limit):
    """(C, T) Woop t/u/v and the acceptance mask, in the kernel's order: C
    rays against T columns (w (T, 3, 3)), or each ray against its own row
    of T columns (w (C, T, 3, 3))."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]

    def op(k):
        return ((w[..., k, 0] * ox + w[..., k, 1] * oy)
                + w[..., k, 2] * oz) + bias[..., k]

    def dp(k):
        return (wd[..., k, 0] * dx + wd[..., k, 1] * dy) + wd[..., k, 2] * dz

    t = -op(2) / dp(2)
    u = op(0) + t * dp(0)
    v = op(1) + t * dp(1)
    ok = ((t > tmin) & (t < limit[:, None]) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0))
    return t, u, v, ok


def _plain_decoded(bvh):
    """decode_pages, kept on the structure: its pages never change (an
    animated frame builds a new structure)."""
    cache = getattr(bvh, "_plain_cache", None)
    if cache is None:
        cache = decode_pages(bvh)
        bvh._plain_cache = cache
    return cache


def closest_bf8_plain(bvh, origins, dirs, tmax, tmin: float = 1e-5) -> Hit:
    """Plain PyTorch closest hit: all rays against all decoded triangles.
    Smallest t wins; on an exact tie the smallest id, with u/v from it."""
    w, bias, wd, ids = _plain_decoded(bvh)
    idc = (ids & ~ALPHA_TRI_BIT).to(torch.int64)[None, :]
    no_id = torch.full((), _INT32_MAX, dtype=torch.int64, device=idc.device)
    chunk = max(1, _RAY_TRI_BUDGET // max(ids.shape[0], 1))
    out = [Hit(*(torch.empty(0, dtype=dt, device=origins.device)
                 for dt in (torch.float32, torch.int32, torch.float32,
                            torch.float32)))]
    for s in range(0, origins.shape[0], chunk):
        lim = tmax[s:s + chunk]
        t, u, v, ok = _woop_chunk(origins[s:s + chunk], dirs[s:s + chunk],
                                  w, bias, wd, tmin, lim)
        tm = torch.where(ok, t, float("inf"))
        best_t = tm.min(dim=1).values
        at_min = ok & (tm == best_t[:, None])
        sel_id = torch.where(at_min, idc, no_id).min(dim=1).values
        j = torch.argmax((at_min & (idc == sel_id[:, None])).to(torch.int8),
                         dim=1)[:, None]
        hit = torch.isfinite(best_t)
        zero = torch.zeros_like(lim)
        out.append(Hit(torch.where(hit, best_t, lim),
                       torch.where(hit, sel_id, -1).to(torch.int32),
                       torch.where(hit, u.gather(1, j)[:, 0], zero),
                       torch.where(hit, v.gather(1, j)[:, 0], zero)))
    return Hit(*(torch.cat(p) for p in zip(*out)))


def _safe_inv(d):
    """pt's safe_inv, as rt_common.cuh: |a| < 1e-12 becomes +-1e-12 (the
    sign of a; +0 and -0 both +1e-12) before the reciprocal."""
    tiny = torch.where(d < 0, -1e-12, 1e-12)
    return 1.0 / torch.where(torch.abs(d) < 1e-12, tiny, d)


def _slab(lo, hi, o, inv, limit):
    """rt::slab on broadcast tensors (..., 3): (passes, tnear)."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    near = torch.minimum(t0, t1)
    far = torch.maximum(t0, t1)
    tnear = torch.maximum(torch.maximum(near[..., 0], near[..., 1]),
                          near[..., 2])
    tfar = torch.minimum(torch.minimum(far[..., 0], far[..., 1]), far[..., 2])
    return (tnear <= tfar) & (tfar > 0.0) & (tnear < limit), tnear


def _leaf_columns(bvh8):
    """Every page column of every leaf, decoded as `decode_pages` does but
    kept per leaf: W (L, B, 3, 3), b (L, B, 3), Wd (L, B, 3, 3) and the id
    (L, B) int32 (-1: padding; ALPHA_TRI_BIT kept). Kept on the structure."""
    cache = getattr(bvh8, "_walk_cache", None)
    if cache is None:
        pages, b = bvh8.pages, bvh8.block
        ids = pages[:, 0, 6 * b:7 * b].contiguous().view(torch.int32)
        cols = pages[:, :, :6 * b].reshape(pages.shape[0], 8, 6, b) \
            .permute(0, 3, 2, 1)                   # (L, B, group, row)
        cache = (cols[:, :, 0:3, 0:3].contiguous(),
                 cols[:, :, 0:3, 3].contiguous(),
                 cols[:, :, 3:6, 4:7].contiguous(), ids)
        bvh8._walk_cache = cache
    return cache


class _WalkTree(NamedTuple):
    """The arrays a BF8 stack walk reads, of a BF8BVH (or BF8Instanced) or
    of a BF8V6: child bounds and entries, leaf bounds (a BF8V6's leaf rows
    of its unified table) and, for a BF8V6, the packed push orders."""
    c_lo: torch.Tensor
    c_hi: torch.Tensor
    c_ent: torch.Tensor
    l_lo: torch.Tensor
    l_hi: torch.Tensor
    c_order: Optional[torch.Tensor]


def _walk_tree(bvh) -> _WalkTree:
    if getattr(bvh, "c_order", None) is None:
        return _WalkTree(bvh.c_lo, bvh.c_hi, bvh.c_ent, bvh.l_lo, bvh.l_hi,
                         None)
    rows = bvh.n8 * 8
    return _WalkTree(bvh.u_lo[:rows], bvh.u_hi[:rows], bvh.c_ent,
                     bvh.u_lo[rows:], bvh.u_hi[rows:], bvh.c_order)


class _Stacks:
    """The per-lane stacks of the BF8 walks (bf8_traverse.cuh,
    bf8i_traverse.cuh, v6_traverse.cuh), every lane at once: a
    BF8_STACK-deep int32 stack per lane, holding the root first; `high` is
    each lane's highest height."""

    def __init__(self, n: int, device):
        self.stack = torch.zeros((n, BF8_STACK), dtype=torch.int32,
                                 device=device)
        self.sp = torch.ones(n, dtype=torch.int64, device=device)
        self.high = torch.ones(n, dtype=torch.int64, device=device)

    def pop(self, lanes):
        """The top entry of each lane of `lanes` (int64), popped."""
        self.sp[lanes] -= 1
        return self.stack[lanes, self.sp[lanes]].to(torch.int64)

    def push(self, lanes, ent, where, bound: int):
        """Push ent[i] onto lane lanes[i]'s stack where where[i]. Raises
        where a stack would pass `bound` entries."""
        lanes, ent = lanes[where], ent[where]
        if lanes.numel() == 0:
            return
        sp = self.sp[lanes]
        if int(sp.max()) >= bound:
            raise ValueError(f"a lane's stack passes {bound} entries")
        self.stack[lanes, sp] = ent.to(torch.int32)
        self.sp[lanes] = sp + 1
        self.high[lanes] = torch.maximum(self.high[lanes], sp + 1)

    def push_children(self, tree, lanes, ent, origins, inv, limit,
                      order: str, dirs=None):
        """Push the children of wide node ent[i] whose boxes lane lanes[i]'s
        ray hits before limit[i], by `order`: "near", far-first, so that the
        nearest ends on top (bf8::push_near_first; a stable sort on
        max(tnear, 0) keeps equal keys in child order, as the kernel's
        insertion sort does); "child", in child order, the last on top
        (bf8i::push_hit); "octant", in the node's static order for the ray's
        octant (v6::push_children: `tree.c_order`, the octant from `dirs`).
        Raises where a stack would pass BF8_STACK entries."""
        slot = torch.arange(8, device=lanes.device)
        k = ent[:, None] * 8 + slot                               # (A, 8)
        e = tree.c_ent[k]
        ok, tn = _slab(tree.c_lo[k], tree.c_hi[k], origins[lanes][:, None],
                       inv[lanes][:, None], limit[:, None])
        ok &= e != -1
        cnt = ok.sum(dim=1)
        sp = self.sp[lanes]
        top = sp + cnt
        if int(top.max()) > BF8_STACK:
            raise ValueError(f"a lane's stack passes {BF8_STACK} entries")
        if order == "near":
            key = torch.where(ok, torch.clamp(tn, min=0.0), float("inf"))
            src = torch.clamp(cnt[:, None] - 1 - slot, min=0)
        else:
            if order == "octant":                 # v6::octant, then c_order
                d = dirs[lanes]
                oct_ = ((d[:, 0] < 0).long() * 4 + (d[:, 1] < 0).long() * 2
                        + (d[:, 2] < 0).long())
                code = tree.c_order[ent * 8 + oct_].to(torch.int64)
                perm = (code[:, None] >> (3 * slot)) & 7
                e, ok = e.gather(1, perm), ok.gather(1, perm)
            key = torch.where(ok, 0.0, 1.0)
            src = slot.expand(lanes.numel(), -1)
        seq = e.gather(1, torch.sort(key, dim=1, stable=True).indices)
        push = slot < cnt[:, None]
        rows = lanes[:, None].expand(-1, 8)[push]
        self.stack[rows, (sp[:, None] + slot)[push]] = \
            seq.gather(1, src)[push]
        self.sp[lanes] = top
        self.high[lanes] = torch.maximum(self.high[lanes], top)


def closest_bf8_walk_plain(bvh8: BF8BVH, origins, dirs, tmax,
                           tmin: float = 1e-5,
                           peak: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K1's pops variant: the kernel's stack walk
    (bf8_traverse.cuh), one step of every live lane at a time. Returns
    (Hit, pops (N,) int32): pops counts each lane's iterations, one per pop
    of a wide node or a leaf. Step by step as the kernel (`_Stacks`): a
    popped leaf retests its box against the lane's best t, then tests its
    page's columns with the Woop arithmetic and the (t, id) tie rule; a
    popped wide node slab-tests its 8 children against the best t and
    pushes those that pass far-first. Its hits are bit-equal to
    `closest_bf8_plain`'s but on a lane whose t ties exactly across two
    leaves (the retest can cull the second). `peak`, an (N,) int32 tensor,
    receives each lane's highest stack height. Raises where a lane's stack
    would pass BF8_STACK entries."""
    w, bias, wd, ids = _leaf_columns(bvh8)
    dev = origins.device
    n = origins.shape[0]
    inv = _safe_inv(dirs)
    st = _Stacks(n, dev)
    best_t = tmax.clone()
    best_id = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    pops = torch.zeros(n, dtype=torch.int32, device=dev)
    while True:
        lanes = torch.nonzero(st.sp > 0).squeeze(1)
        if lanes.numel() == 0:
            break
        ent = st.pop(lanes)
        pops[lanes] += 1
        leaf = ent >= LEAF_BIT

        ll = lanes[leaf]                        # leaf pops: retest, then page
        lid = ent[leaf] - LEAF_BIT
        ok, _ = _slab(bvh8.l_lo[lid], bvh8.l_hi[lid], origins[ll], inv[ll],
                      best_t[ll])
        ll, lid = ll[ok], lid[ok]
        if ll.numel():
            t, u, v, acc = _woop_chunk(origins[ll], dirs[ll], w[lid],
                                       bias[lid], wd[lid], tmin, tmax[ll])
            col_id = ids[lid].to(torch.int64)
            acc &= col_id >= 0
            idc = col_id & ~ALPHA_TRI_BIT
            tm = torch.where(acc, t, float("inf"))
            leaf_t = tm.min(dim=1).values
            at_min = acc & (tm == leaf_t[:, None])
            leaf_id = torch.where(at_min, idc, _INT32_MAX).min(dim=1).values
            j = torch.argmax((at_min & (idc == leaf_id[:, None]))
                             .to(torch.int8), dim=1)[:, None]
            bt, bi = best_t[ll], best_id[ll]
            better = (leaf_t < bt) | ((leaf_t == bt) & (leaf_id < bi))
            best_t[ll] = torch.where(better, leaf_t, bt)
            best_id[ll] = torch.where(better, leaf_id, bi)
            best_u[ll] = torch.where(better, u.gather(1, j)[:, 0], best_u[ll])
            best_v[ll] = torch.where(better, v.gather(1, j)[:, 0], best_v[ll])

        nl = lanes[~leaf]                       # wide-node pops: push children
        if nl.numel():
            st.push_children(bvh8, nl, ent[~leaf], origins, inv, best_t[nl],
                             "near")
    if peak is not None:
        peak.copy_(st.high)
    hit = best_id >= 0
    return Hit(best_t, torch.where(hit, best_id, -1).to(torch.int32), best_u,
               best_v), pops


def occluded_bf8_plain(bvh, origins, dirs, dist, tmin: float = 1e-5,
                       opaque_only: bool = False) -> torch.Tensor:
    """Plain PyTorch occlusion: any accepted hit among all triangles."""
    w, bias, wd, ids = _plain_decoded(bvh)
    if opaque_only:
        keep = (ids & ALPHA_TRI_BIT) == 0
        w, bias, wd = w[keep], bias[keep], wd[keep]
    n = origins.shape[0]
    chunk = max(1, _RAY_TRI_BUDGET // max(w.shape[0], 1))
    out = [torch.zeros(0, dtype=torch.bool, device=origins.device)]
    for s in range(0, n, chunk):
        _, _, _, ok = _woop_chunk(origins[s:s + chunk], dirs[s:s + chunk],
                                  w, bias, wd, tmin, dist[s:s + chunk])
        out.append(ok.any(dim=1))
    return torch.cat(out)


def closest_v4_plain(pbvh: PacketBVH, origins, dirs, tmax,
                     tmin: float = 1e-5) -> Hit:
    """Plain PyTorch version of K3. The function does not depend on the
    tree over the pages, so it is the BF8 plain version on the PacketBVH's
    pages."""
    return closest_bf8_plain(pbvh, origins, dirs, tmax, tmin)


def occluded_v4_plain(pbvh: PacketBVH, origins, dirs, dist,
                      tmin: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K4 (no `opaque_only`: every triangle
    occludes)."""
    return occluded_bf8_plain(pbvh, origins, dirs, dist, tmin)


# ----------------------------------------- the warp kernels' schedule

WARP = 32
_NO_KEY = 0xFFFFFFFF


class WarpSchedule(NamedTuple):
    """What the warp kernels (v4_warp_kernels.cu, bf8i_warp_kernels.cu,
    bf8_warp_kernels.cu, bf8_occluded_warp_kernels.cu,
    v6_warp_kernels.cu) do on a launch's rays, as their plain schedules
    (`closest_v4_warp_plain`, `closest_bf8i_warp_plain`,
    `closest_bf8_warp_plain`, `closest_v6_warp_plain`,
    `closest_v6k2_warp_plain`, `closest_v7_warp_plain` and the occlusion
    twins) count it. A warp is
    32 consecutive lanes; in a round every lane of a warp that is not done
    holds a pending leaf (v6k2 and v7: a pending list, drained in several
    rounds, one `test_groups` call each). Per launch:
    `node_visits` (slab tests of a binary node or wide-node visits, as the
    per-ray walk's counted variant counts them), `warps` with any leaf
    round, `rounds` (summed over warps), `groups` (distinct pages of a
    warp's round, K1-K4 and the v6 walks a leaf's own page, K5/K6 a shared
    page: one page read each), `leaves` (distinct leaves in those groups;
    but for K5/K6, `groups`), `leaf_visits` ((lane, leaf) pairs, the sum of
    the lanes in each group), `chunk_loads` (32-triangle chunks staged; an
    occlusion group stops after its last member is occluded, with the
    chunk already in flight), `ray_chunk_tests` (tests of one ray against
    one chunk), `warp_tests` (the warp's steps through them: per chunk, one
    per ray; the BF8 kernels take, where fewer, one per column that can
    accept, each ray's own lane testing it), `lanes_per_group` (groups of
    1, 2-3, 4-7, 8-15, 16-31 and 32 lanes), and, as the per-ray walk's
    counted variant counts them, `leaf_boxes` (popped leaves whose box a
    closest BF8 walk or occluded_v6 retested; the other walks retest none)
    and `tri_tests` (the triangle columns the walk tests: every valid one
    of a visited leaf, an occlusion walk's up to the first that
    occludes)."""
    warps: int
    rounds: int
    groups: int
    leaves: int
    leaf_visits: int
    chunk_loads: int
    ray_chunk_tests: int
    warp_tests: int
    lanes_per_group: tuple
    node_visits: int
    leaf_boxes: int
    tri_tests: int


def _tri_tests(counted, acc, any_hit: bool) -> int:
    """The per-ray walks' triangle tests on (lane, leaf) rows: the columns
    they count (`counted`, (C, B) bool), an occlusion walk's up to the first
    accepted one (`acc`, (C, B))."""
    if not any_hit:
        return int(counted.sum())
    blk = counted.shape[1]
    col = torch.arange(blk, device=counted.device)
    first = torch.where(acc.any(dim=1),
                        torch.argmax(acc.to(torch.int8), dim=1), blk)
    return int((counted & (col <= first[:, None])).sum())


def t_order_key(t: torch.Tensor) -> torch.Tensor:
    """The warp kernels' order-preserving key of f32 `t` (no NaN), int64 in
    [0, 2**32): a < b iff key(a) < key(b), and -0.0 shares +0.0's key."""
    b = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = torch.where((b & 0x7FFFFFFF) == 0, torch.zeros_like(b), b)
    return torch.where((b & 0x80000000) != 0, b ^ 0xFFFFFFFF,
                       b | 0x80000000)


def _chunk_winner(t, u, v, acc, idc, *extra):
    """The warp kernels' reduction over the columns of a chunk ((C, 32)
    each; `idc` the ids with ALPHA_TRI_BIT stripped): per row, whether any
    column accepted, and the winner's (t, id, u, v), then its entries of
    each of `extra` ((C, 32) each): the least key of t, then the least id
    at that key, the first such column."""
    key = torch.where(acc, t_order_key(t), _NO_KEY)
    kmin = key.min(dim=1).values
    at = acc & (key == kmin[:, None])
    imin = torch.where(at, idc, _NO_KEY).min(dim=1).values
    col = torch.argmax((at & (idc == imin[:, None])).to(torch.int8),
                       dim=1)[:, None]
    return (kmin != _NO_KEY, t.gather(1, col)[:, 0], imin,
            u.gather(1, col)[:, 0], v.gather(1, col)[:, 0],
            *(e.gather(1, col)[:, 0] for e in extra))


def _merge_best(best, has, wt, wid, wu, wv, *extra):
    """v4_traverse.cuh's rule (and bf8i_traverse.cuh's), applied by a ray's
    own lane to a chunk's winner: a smaller t, or an exact tie with a
    smaller id. `best` holds (t, id, u, v) and one entry per `extra`."""
    bt, bi = best[0], best[1]
    better = has & ((wt < bt) | ((wt == bt) & (bi >= 0) & (wid < bi)))
    return tuple(torch.where(better, w, b)
                 for w, b in zip((wt, wid, wu, wv, *extra), best))


def _group_stats(lanes, page, n_pages: int):
    """The groups of one round: lanes `lanes` pending on pages `page`,
    grouped by (warp, page). Returns (inverse, counts per group, histogram
    of lanes per group)."""
    gkey = (lanes // WARP) * n_pages + page
    _, inverse, cnt = torch.unique(gkey, return_inverse=True,
                                   return_counts=True)
    hist = torch.bincount(sum((cnt >= k).long() for k in (2, 4, 8, 16, 32)),
                          minlength=6)
    return inverse, cnt, hist


def _occlusion_loads(occ_l, inverse, tested, n_groups: int, nc: int) -> int:
    """Chunks an occlusion round stages: a group stops staging once its
    last member is occluded; the chunk after that one is already in
    flight. `tested`: the chunks each lane was tested against."""
    last = torch.zeros(n_groups, dtype=torch.int64,
                       device=tested.device).scatter_reduce(
        0, inverse, tested, "amax")
    all_occ = torch.ones(n_groups, dtype=torch.int64,
                         device=tested.device).scatter_reduce(
        0, inverse, occ_l.long(), "amin")
    return int(torch.where(all_occ > 0, torch.clamp(last + 1, max=nc),
                           nc).sum())


def _any_chunk_hit(acc, nc: int):
    """An occlusion test of C rays against nc chunks ((C, nc*32) accepted
    columns): (occluded (C,), chunks tested (C,): through the first chunk
    that occludes, else all)."""
    hit = acc.reshape(-1, nc, WARP).any(dim=2)
    occ = hit.any(dim=1)
    return occ, torch.where(occ, torch.argmax(hit.to(torch.int8), dim=1) + 1,
                            nc)


def _v4_warp_schedule(pbvh: PacketBVH, origins, dirs, limit, tmin: float,
                      any_hit: bool):
    """The warp kernels' schedule, every lane at once: each live lane walks
    the skip links (pruning closest with its best t) to its next leaf whose
    box it hits; the round's pending lanes are grouped by (warp, leaf) and
    tested chunk by chunk with the kernels' reduction; then they resume.
    A lane's r-th leaf is its warp's r-th round, whatever the other warps
    do, so all warps run together here. Returns ((t, id, u, v) or the
    occlusion bools, WarpSchedule)."""
    w, bias, wd, ids = _leaf_columns(pbvh)
    dev = origins.device
    n, blk, n_top = origins.shape[0], pbvh.block, pbvh.n_top
    nc = blk // WARP
    inv = _safe_inv(dirs)
    top_miss = pbvh.top_miss.to(torch.int64)
    top_leaf = pbvh.top_leaf.to(torch.int64)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    best = (limit.clone(), torch.full((n,), -1, dtype=torch.int64,
                                      device=dev),
            torch.zeros_like(limit), torch.zeros_like(limit))
    occluded = torch.zeros(n, dtype=torch.bool, device=dev)
    warp_rounds = torch.zeros((n + WARP - 1) // WARP, dtype=torch.int64,
                              device=dev)
    hist = torch.zeros(6, dtype=torch.int64, device=dev)
    groups = visits = loads = tests = nodes = tris = 0
    per_slice = max(1, (1 << 22) // blk)
    while True:
        pending = torch.full((n,), -1, dtype=torch.int64, device=dev)
        walking = torch.nonzero((node >= 0) & (node < n_top)).squeeze(1)
        while walking.numel():
            nodes += walking.numel()
            i = node[walking]
            ok, _ = _slab(pbvh.top_lo[i], pbvh.top_hi[i], origins[walking],
                          inv[walking], best[0][walking])
            leaf = top_leaf[i]
            at_leaf = ok & (leaf >= 0)
            pending[walking[at_leaf]] = leaf[at_leaf]
            node[walking] = torch.where(ok, torch.where(leaf >= 0, i, i + 1),
                                        top_miss[i])
            walking = walking[~at_leaf]
            walking = walking[(node[walking] >= 0)
                              & (node[walking] < n_top)]
        lanes = torch.nonzero(pending >= 0).squeeze(1)
        if lanes.numel() == 0:
            break
        lid = pending[lanes]
        inverse, cnt, h = _group_stats(lanes, lid, pbvh.pages.shape[0])
        warp_rounds[torch.unique(lanes // WARP)] += 1
        groups += cnt.numel()
        visits += lanes.numel()
        hist += h
        tested = torch.empty(lanes.numel(), dtype=torch.int64, device=dev)
        for s0 in range(0, lanes.numel(), per_slice):
            sl = slice(s0, s0 + per_slice)
            ln, li = lanes[sl], lid[sl]
            t, u, v, acc = _woop_chunk(origins[ln], dirs[ln], w[li],
                                       bias[li], wd[li], tmin, limit[ln])
            col_id = ids[li].to(torch.int64)
            acc &= col_id >= 0
            tris += _tri_tests(col_id >= 0, acc, any_hit)
            if any_hit:
                occ, tested[sl] = _any_chunk_hit(acc, nc)
                occluded[ln[occ]] = True
                continue
            idc = col_id & ~ALPHA_TRI_BIT
            mine = tuple(b[ln] for b in best)
            for c in range(nc):
                cs = slice(c * WARP, (c + 1) * WARP)
                mine = _merge_best(mine, *_chunk_winner(
                    t[:, cs], u[:, cs], v[:, cs], acc[:, cs], idc[:, cs]))
            for b, m in zip(best, mine):
                b[ln] = m
            tested[sl] = nc
        tests += int(tested.sum())
        if any_hit:
            occ_l = occluded[lanes]
            loads += _occlusion_loads(occ_l, inverse, tested, cnt.numel(), nc)
            node[lanes] = torch.where(occ_l, n_top, top_miss[node[lanes]])
        else:
            loads += cnt.numel() * nc
            node[lanes] = top_miss[node[lanes]]
    sched = WarpSchedule(int((warp_rounds > 0).sum()),
                         int(warp_rounds.sum()), groups, groups, visits,
                         loads, tests, tests,
                         tuple(int(x) for x in hist.tolist()), nodes, 0,
                         tris)
    if any_hit:
        return occluded, sched
    t, bid, u, v = best
    return (t, torch.where(bid >= 0, bid, -1).to(torch.int32), u, v), sched


def closest_v4_warp_plain(pbvh: PacketBVH, origins, dirs, tmax,
                          tmin: float = 1e-5):
    """Plain PyTorch version of the closest_v4 warp kernel's schedule:
    (Hit, WarpSchedule). Its hits are bit-equal to the per-ray walk's
    (v4_traverse.cuh), ties across leaves included."""
    (t, tri, u, v), sched = _v4_warp_schedule(pbvh, origins, dirs, tmax,
                                              tmin, any_hit=False)
    return Hit(t, tri, u, v), sched


def occluded_v4_warp_plain(pbvh: PacketBVH, origins, dirs, dist,
                           tmin: float = 1e-5):
    """Plain PyTorch version of the occluded_v4 warp kernel's schedule:
    (bool (N,), WarpSchedule)."""
    return _v4_warp_schedule(pbvh, origins, dirs, dist, tmin, any_hit=True)


def _bf8i_warp_schedule(bvh: BF8Instanced, origins, dirs, limit,
                        tmin: float, any_hit: bool, flag: bool):
    """The warp K5/K6's schedule, every lane at once: each live lane runs
    its own stack walk (`_Stacks`: closest pushes far-first and retests a
    popped leaf's box against its best t; occlusion pushes in child order)
    to its next leaf to test; the round's pending lanes, each with its ray
    mapped into its leaf's segment space, are grouped by (warp, page) and
    tested chunk by chunk with the kernels' reduction, the winner branded
    with the lane's segment on its own lane; then they resume. `flag`:
    raw_ids (closest) or opaque_only (occlusion). A chunk with fewer
    columns that can accept than rays to test is tested per ray in the
    kernel (`warp_tests` counts it so); the bits are the same either way.
    Returns ((t, id, u, v) or the occlusion bools, WarpSchedule)."""
    w, bias, wd, ids = _leaf_columns(bvh)         # per shared page
    dev = origins.device
    n, nc = origins.shape[0], bvh.block // WARP
    inv = _safe_inv(dirs)
    seg_inv = bvh.seg_inv.reshape(bvh.n_segs, 12)
    leaf_page = bvh.leaf_page.to(torch.int64)
    leaf_seg = bvh.leaf_seg.to(torch.int64)
    st = _Stacks(n, dev)
    none = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best = (limit.clone(), none, torch.zeros_like(limit),
            torch.zeros_like(limit), none.clone())      # t, id, u, v, raw
    occluded = torch.zeros(n, dtype=torch.bool, device=dev)
    warp_rounds = torch.zeros((n + WARP - 1) // WARP, dtype=torch.int64,
                              device=dev)
    hist = torch.zeros(6, dtype=torch.int64, device=dev)
    groups = leaves = visits = loads = tests = steps = nodes = 0
    boxes = tris = 0
    per_slice = max(1, (1 << 22) // bvh.block)
    # per page and chunk, the columns that can accept
    can = ids >= 0
    if any_hit and flag:
        can &= (ids & ALPHA_TRI_BIT) == 0
    n_cols = can.reshape(-1, nc, WARP).sum(dim=2)             # (P, nc)
    chunk = torch.arange(nc, device=dev)
    while True:
        pending = torch.full((n,), -1, dtype=torch.int64, device=dev)
        walking = torch.nonzero(st.sp > 0).squeeze(1)
        while walking.numel():
            ent = st.pop(walking)
            leaf = ent >= LEAF_BIT
            ll, lid = walking[leaf], ent[leaf] - LEAF_BIT
            if not any_hit:                       # the leaf-box retest
                boxes += ll.numel()
                ok, _ = _slab(bvh.l_lo[lid], bvh.l_hi[lid], origins[ll],
                              inv[ll], best[0][ll])
                ll, lid = ll[ok], lid[ok]
            pending[ll] = lid
            nl = walking[~leaf]
            if nl.numel():
                nodes += nl.numel()
                st.push_children(bvh, nl, ent[~leaf], origins, inv,
                                 (limit if any_hit else best[0])[nl],
                                 "child" if any_hit else "near")
            walking = walking[pending[walking] < 0]
            walking = walking[st.sp[walking] > 0]
        lanes = torch.nonzero(pending >= 0).squeeze(1)
        if lanes.numel() == 0:
            break
        lid = pending[lanes]
        page, seg = leaf_page[lid], leaf_seg[lid]
        inverse, cnt, h = _group_stats(lanes, page, bvh.pages.shape[0])
        warp_rounds[torch.unique(lanes // WARP)] += 1
        groups += cnt.numel()
        leaves += torch.unique((lanes // WARP) * bvh.n_leaves + lid).numel()
        visits += lanes.numel()
        hist += h
        tested = torch.empty(lanes.numel(), dtype=torch.int64, device=dev)
        for s0 in range(0, lanes.numel(), per_slice):
            sl = slice(s0, s0 + per_slice)
            ln, pg, sg = lanes[sl], page[sl], seg[sl]
            o2, d2 = _to_object(seg_inv[sg], origins[ln], dirs[ln])
            t, u, v, acc = _woop_chunk(o2, d2, w[pg], bias[pg], wd[pg], tmin,
                                       limit[ln])
            col_id = ids[pg].to(torch.int64)
            acc &= can[pg]
            tris += _tri_tests(can[pg], acc, any_hit)
            if any_hit:
                occ, tested[sl] = _any_chunk_hit(acc, nc)
                occluded[ln[occ]] = True
                continue
            brand = sg << SEG_SHIFT
            idc = col_id & ~ALPHA_TRI_BIT
            mine = tuple(b[ln] for b in best)
            for c in range(nc):
                cs = slice(c * WARP, (c + 1) * WARP)
                has, wt, wid, wu, wv, wraw = _chunk_winner(
                    t[:, cs], u[:, cs], v[:, cs], acc[:, cs], idc[:, cs],
                    col_id[:, cs])
                mine = _merge_best(mine, has, wt, wid | brand, wu, wv,
                                   wraw | brand)
            for b, m in zip(best, mine):
                b[ln] = m
            tested[sl] = nc
        tests += int(tested.sum())
        # the rays each group still tests at each chunk against its columns
        # that can accept: the warp steps through the fewer of the two
        active = torch.zeros((cnt.numel(), nc), dtype=torch.int64,
                             device=dev).index_add_(
            0, inverse, (tested[:, None] > chunk).long())
        g_page = torch.zeros_like(cnt).scatter_(0, inverse, page)
        steps += int(torch.minimum(active, n_cols[g_page]).sum())
        if any_hit:
            occ_l = occluded[lanes]
            loads += _occlusion_loads(occ_l, inverse, tested, cnt.numel(), nc)
            st.sp[lanes[occ_l]] = 0               # an occluded lane is done
        else:
            loads += cnt.numel() * nc
    sched = WarpSchedule(int((warp_rounds > 0).sum()),
                         int(warp_rounds.sum()), groups, leaves, visits,
                         loads, tests, steps,
                         tuple(int(x) for x in hist.tolist()), nodes, boxes,
                         tris)
    if any_hit:
        return occluded, sched
    t, bid, u, v, raw = best
    tri = raw if flag else torch.where(bid >= 0, bid, -1)
    return Hit(t, tri.to(torch.int32), u, v), sched


def closest_bf8i_warp_plain(bvh: BF8Instanced, origins, dirs, tmax,
                            tmin: float = 1e-5, raw_ids: bool = False):
    """Plain PyTorch version of the closest_bf8i warp kernel's schedule:
    (Hit, WarpSchedule). Its hits are bit-equal to the per-ray walk's
    (bf8i_traverse.cuh), ties across leaves and instances included."""
    return _bf8i_warp_schedule(bvh, origins, dirs, tmax, tmin,
                               any_hit=False, flag=raw_ids)


def occluded_bf8i_warp_plain(bvh: BF8Instanced, origins, dirs, dist,
                             tmin: float = 1e-5, opaque_only: bool = False):
    """Plain PyTorch version of the occluded_bf8i warp kernel's schedule:
    (bool (N,), WarpSchedule)."""
    return _bf8i_warp_schedule(bvh, origins, dirs, dist, tmin, any_hit=True,
                               flag=opaque_only)


def _drain_steps(pending):
    """The steps in which a warp kernel tests its lanes' pending leaves,
    (lanes, leaf ids) each; the caller tests a step before the next is
    made. One step for `pending` (N,), a leaf or -1 a lane. Pending lists
    ((N, cap), -1 past a list's end) drain as v6_warp_kernels.cu drains
    them, each in ascending leaf order: at each step a lane offers its next
    leaf when it is below the entry after the next of every lane of its
    warp, or is the least next leaf of the warp, so each distinct leaf of a
    warp's lists is offered once, by all its lanes together."""
    if pending.dim() == 1:
        lanes = torch.nonzero(pending >= 0).squeeze(1)
        yield lanes, pending[lanes]
        return
    none = torch.iinfo(torch.int64).max
    lists = torch.where(pending >= 0, pending, none).sort(dim=1).values
    count = (pending >= 0).sum(dim=1)
    head = torch.zeros_like(count)
    warp = torch.arange(pending.shape[0], device=pending.device) // WARP
    n_warps = int(warp[-1]) + 1

    def entry(k):
        got = lists.gather(1, torch.clamp(k, max=lists.shape[1] - 1)[:, None])
        return torch.where(k < count, got[:, 0], none)

    def warp_min(x):
        least = torch.full((n_warps,), none, dtype=torch.int64,
                           device=x.device)
        return least.scatter_reduce(0, warp, x, "amin")[warp]

    while True:
        h = entry(head)
        least = warp_min(h)
        if not bool((least != none).any()):
            return
        offer = (h != none) & ((h < warp_min(entry(head + 1)))
                               | (h == least))
        lanes = torch.nonzero(offer).squeeze(1)
        yield lanes, h[lanes]
        head[lanes] += 1


def _list_leaves(pending, lanes, lid):
    """Add leaf lid[i] to lane lanes[i]'s pending list (`pending` (N, cap),
    -1 past each list's end; a lane at most once a call)."""
    pending[lanes, (pending[lanes] >= 0).sum(dim=1)] = lid


def _warp_rounds(bvh, origins, dirs, limit, tmin: float, any_hit: bool,
                 opaque_only: bool, st: "_Stacks", step, nodes: int = 0,
                 pops: Optional[torch.Tensor] = None, cap: int = 1):
    """The leaf rounds of a warp kernel whose lanes walk their own stacks
    (`st`), every lane at once: every live lane runs `step(walking, best_t,
    pending)` (one pop of each lane of `walking`, or with `cap` > 1 one
    round of its walk; a lane that stops at a leaf to test gets it in
    `pending`, with `cap` > 1 in its pending list (`_list_leaves`); returns
    the node visits and leaf-box retests it counted) until it holds a
    pending leaf or its stack is empty; the pending leaves are tested in
    `_drain_steps` (one step for one pending leaf a lane), each step's
    lanes grouped by (warp, leaf) and tested chunk by chunk, closest with
    the kernels' reduction, occlusion by whether any column accepts; then
    they resume. An occluded
    lane is done (its stack emptied); with `opaque_only` columns tagged
    ALPHA_TRI_BIT cannot accept. A chunk with fewer columns that can accept
    than rays to test is tested per ray in the kernel (`warp_tests` counts
    it so); the bits are the same either way. `nodes`: node visits counted
    before the first pop. `pops`, an (N,) int32 tensor, receives each
    lane's pops. Returns ((t, id, u, v) or the occlusion bools,
    WarpSchedule)."""
    w, bias, wd, ids = _leaf_columns(bvh)
    dev = origins.device
    n, nc = origins.shape[0], bvh.block // WARP
    best = (limit.clone(), torch.full((n,), -1, dtype=torch.int64,
                                      device=dev),
            torch.zeros_like(limit), torch.zeros_like(limit))
    occluded = torch.zeros(n, dtype=torch.bool, device=dev)
    lane_pops = torch.zeros(n, dtype=torch.int32, device=dev)
    warp_rounds = torch.zeros((n + WARP - 1) // WARP, dtype=torch.int64,
                              device=dev)
    hist = torch.zeros(6, dtype=torch.int64, device=dev)
    groups = visits = loads = tests = steps = boxes = tris = 0
    per_slice = max(1, (1 << 22) // bvh.block)
    # per leaf and chunk, the columns that can accept
    can = ids >= 0
    if any_hit and opaque_only:
        can &= (ids & ALPHA_TRI_BIT) == 0
    n_cols = can.reshape(-1, nc, WARP).sum(dim=2)             # (L, nc)
    chunk = torch.arange(nc, device=dev)
    while True:
        pending = torch.full((n, cap) if cap > 1 else (n,), -1,
                             dtype=torch.int64, device=dev)
        first = pending if cap == 1 else pending[:, 0]
        walking = torch.nonzero(st.sp > 0).squeeze(1)
        while walking.numel():
            lane_pops[walking] += 1
            nv, nb = step(walking, best[0], pending)
            nodes += nv
            boxes += nb
            walking = walking[first[walking] < 0]
            walking = walking[st.sp[walking] > 0]
        if not bool((first >= 0).any()):
            break
        for lanes, lid in _drain_steps(pending):
            inverse, cnt, h = _group_stats(lanes, lid, bvh.pages.shape[0])
            warp_rounds[torch.unique(lanes // WARP)] += 1
            groups += cnt.numel()
            visits += lanes.numel()
            hist += h
            tested = torch.full((lanes.numel(),), nc, dtype=torch.int64,
                                device=dev)
            for s0 in range(0, lanes.numel(), per_slice):
                sl = slice(s0, s0 + per_slice)
                ln, li = lanes[sl], lid[sl]
                t, u, v, acc = _woop_chunk(origins[ln], dirs[ln], w[li],
                                           bias[li], wd[li], tmin, limit[ln])
                acc &= can[li]
                tris += _tri_tests(can[li], acc, any_hit)
                if any_hit:
                    occ, tested[sl] = _any_chunk_hit(acc, nc)
                    occluded[ln[occ]] = True
                    continue
                idc = ids[li].to(torch.int64) & ~ALPHA_TRI_BIT
                mine = tuple(b[ln] for b in best)
                for c in range(nc):
                    cs = slice(c * WARP, (c + 1) * WARP)
                    mine = _merge_best(mine, *_chunk_winner(
                        t[:, cs], u[:, cs], v[:, cs], acc[:, cs],
                        idc[:, cs]))
                for b, m in zip(best, mine):
                    b[ln] = m
            tests += int(tested.sum())
            # the rays each group still tests at each chunk against its
            # columns that can accept: the warp steps through the fewer of
            # the two
            active = torch.zeros((cnt.numel(), nc), dtype=torch.int64,
                                 device=dev).index_add_(
                0, inverse, (tested[:, None] > chunk).long())
            g_leaf = torch.zeros_like(cnt).scatter_(0, inverse, lid)
            steps += int(torch.minimum(active, n_cols[g_leaf]).sum())
            if any_hit:
                occ_l = occluded[lanes]
                loads += _occlusion_loads(occ_l, inverse, tested,
                                          cnt.numel(), nc)
                st.sp[lanes[occ_l]] = 0           # an occluded lane is done
            else:
                loads += cnt.numel() * nc
    if pops is not None:
        pops.copy_(lane_pops)
    sched = WarpSchedule(int((warp_rounds > 0).sum()),
                         int(warp_rounds.sum()), groups, groups, visits,
                         loads, tests, steps,
                         tuple(int(x) for x in hist.tolist()), nodes, boxes,
                         tris)
    if any_hit:
        return occluded, sched
    t, bid, u, v = best
    return Hit(t, torch.where(bid >= 0, bid, -1).to(torch.int32), u,
               v), sched


def _bf8_warp_schedule(bvh, origins, dirs, limit, tmin: float,
                       any_hit: bool = False, opaque_only: bool = False,
                       pops: Optional[torch.Tensor] = None):
    """The warp K1's or K2's (a BF8BVH) or closest_v6's or occluded_v6's (a
    BF8V6) schedule (`_warp_rounds`): each live lane runs its own stack
    walk (`_Stacks`) to its next leaf to test. The walks: K1 pushes
    far-first, closest_v6 in the node's static order for the ray's octant,
    both retesting a popped leaf's box against the lane's best t; the
    occlusion walks push in child order, K2 with no leaf-box retest,
    occluded_v6 retesting against `limit`."""
    tree = _walk_tree(bvh)
    if any_hit:
        order = "child"
    else:
        order = "near" if tree.c_order is None else "octant"
    retest = not any_hit or tree.c_order is not None
    inv = _safe_inv(dirs)
    st = _Stacks(origins.shape[0], origins.device)

    def step(walking, best_t, pending):
        ent = st.pop(walking)
        leaf = ent >= LEAF_BIT
        ll, lid = walking[leaf], ent[leaf] - LEAF_BIT
        if retest:                                # the leaf-box retest
            ok, _ = _slab(tree.l_lo[lid], tree.l_hi[lid], origins[ll],
                          inv[ll], best_t[ll])
            pending[ll[ok]] = lid[ok]
        else:
            pending[ll] = lid
        nl = walking[~leaf]
        if nl.numel():
            st.push_children(tree, nl, ent[~leaf], origins, inv, best_t[nl],
                             order, dirs)
        return nl.numel(), ll.numel() if retest else 0

    return _warp_rounds(bvh, origins, dirs, limit, tmin, any_hit,
                        opaque_only, st, step, pops=pops)


def closest_bf8_warp_plain(bvh8: BF8BVH, origins, dirs, tmax,
                           tmin: float = 1e-5,
                           pops: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the closest_bf8 warp kernel's schedule:
    (Hit, WarpSchedule). Its hits are bit-equal to the per-ray walk's
    (bf8_traverse.cuh), ties across leaves included. `pops`, an (N,) int32
    tensor, receives each lane's pops as the kernel's pops instance writes
    them."""
    return _bf8_warp_schedule(bvh8, origins, dirs, tmax, tmin, pops=pops)


def closest_v6_warp_plain(bvh6, origins, dirs, tmax, tmin: float = 1e-5):
    """Plain PyTorch version of the closest_v6 warp kernel's schedule over a
    BF8V6: (Hit, WarpSchedule). Its hits are bit-equal to the per-ray walk's
    (v6_traverse.cuh's `closest`), ties across leaves included."""
    return _bf8_warp_schedule(bvh6, origins, dirs, tmax, tmin)


def _v6_list_schedule(bvh6, origins, dirs, tmax, tmin: float,
                      window: Optional[int]):
    """The warp closest_v6k2's (`window` None) or closest_v7's schedule
    (`_warp_rounds` with pending lists): each live lane runs rounds of its
    own stack walk (`_Stacks`), slab-testing each popped entry against its
    best t as the round starts (v7's t_slab: no leaf is tested inside a
    round), pushing a wide node's hit children in the node's static order
    for the ray's octant and listing a leaf whose box passes, until a
    round lists a leaf or the stack is empty. A v6k2 round pops the top
    entry e0 and, if there is one, e1 below it, then runs e1's pushes and
    e0's last; a v7 round pops up to `window` entries, fewer once the stack
    empties or V6_QUEUE leaves are listed."""
    tree = _walk_tree(bvh6)
    inv = _safe_inv(dirs)
    st = _Stacks(origins.shape[0], origins.device)
    cap = 2 if window is None else V6_QUEUE

    def visit(lanes, ent, best_t, pending):
        """Popped entries `ent` of `lanes`: (node visits, leaf-box
        retests)."""
        leaf = ent >= LEAF_BIT
        ll, lid = lanes[leaf], ent[leaf] - LEAF_BIT
        ok, _ = _slab(tree.l_lo[lid], tree.l_hi[lid], origins[ll], inv[ll],
                      best_t[ll])
        _list_leaves(pending, ll[ok], lid[ok])
        nl = lanes[~leaf]
        if nl.numel():
            st.push_children(tree, nl, ent[~leaf], origins, inv, best_t[nl],
                             "octant", dirs)
        return nl.numel(), ll.numel()

    def two_pops(walking, best_t, pending):
        e0 = st.pop(walking)
        two = walking[st.sp[walking] > 0]
        e1 = st.pop(two)
        n1, b1 = visit(two, e1, best_t, pending)
        n0, b0 = visit(walking, e0, best_t, pending)
        return n0 + n1, b0 + b1

    def leaf_queue(walking, best_t, pending):
        nodes = boxes = 0
        for _ in range(window):
            walking = walking[(st.sp[walking] > 0)
                              & (pending[walking, -1] < 0)]
            if walking.numel() == 0:
                break
            nv, nb = visit(walking, st.pop(walking), best_t, pending)
            nodes += nv
            boxes += nb
        return nodes, boxes

    return _warp_rounds(bvh6, origins, dirs, tmax, tmin, False, False, st,
                        two_pops if window is None else leaf_queue, cap=cap)


def closest_v6k2_warp_plain(bvh6, origins, dirs, tmax, tmin: float = 1e-5):
    """Plain PyTorch version of the closest_v6k2 warp kernel's schedule over
    a BF8V6 (`_v6_list_schedule`): (Hit, WarpSchedule). Its hits are
    bit-equal to the per-ray walk's (v6_traverse.cuh's `closest_two_pops`),
    ties across leaves included, and it counts that walk's work."""
    return _v6_list_schedule(bvh6, origins, dirs, tmax, tmin, None)


def closest_v7_warp_plain(bvh6, origins, dirs, tmax, tmin: float = 1e-5,
                          window: int = 8):
    """Plain PyTorch version of the closest_v7 warp kernel's schedule over a
    BF8V6 (`_v6_list_schedule`), `window` pops a round: (Hit,
    WarpSchedule). Its hits are bit-equal to the per-ray walk's
    (v6_traverse.cuh's `closest_leaf_queue`), ties across leaves included,
    and it counts that walk's work."""
    return _v6_list_schedule(bvh6, origins, dirs, tmax, tmin,
                             _check_window(window))


def occluded_bf8_warp_plain(bvh8: BF8BVH, origins, dirs, dist,
                            tmin: float = 1e-5, opaque_only: bool = False):
    """Plain PyTorch version of the occluded_bf8 warp kernel's schedule:
    (bool (N,), WarpSchedule), the bools the per-ray walk's
    (bf8_traverse.cuh's `occluded`)."""
    return _bf8_warp_schedule(bvh8, origins, dirs, dist, tmin, any_hit=True,
                              opaque_only=opaque_only)


def occluded_v6_warp_plain(bvh6, origins, dirs, dist, tmin: float = 1e-5):
    """Plain PyTorch version of the occluded_v6 warp kernel's schedule over a
    BF8V6: (bool (N,), WarpSchedule), the bools the per-ray walk's
    (v6_traverse.cuh's `occluded`)."""
    return _bf8_warp_schedule(bvh6, origins, dirs, dist, tmin, any_hit=True)


def closest_ordered_warp_plain(pbvh: PacketBVH, origins, dirs, tmax,
                               tmin: float = 1e-5):
    """Plain PyTorch version of the closest_ordered warp kernel's schedule
    (`_warp_rounds`): (Hit, WarpSchedule). Each live lane runs
    ordered_traverse.cuh's walk over its own stack of node ids: it pops a
    node and retests its box against its best t; a leaf that passes is its
    pending leaf; an internal node slab-tests its two children (node + 1
    and top_miss of it) and pushes the far one first, by the lane's own
    tnear, left winning ties. Its hits are bit-equal to the per-ray walk's,
    ties across leaves included; `node_visits` counts box tests as the
    per-ray counted variant does (the root's, and both children's of each
    internal node whose pop retest passed). Raises where a lane's stack
    would pass ORDERED_STACK entries."""
    n = origins.shape[0]
    inv = _safe_inv(dirs)
    st = _Stacks(n, origins.device)
    lo, hi = pbvh.top_lo, pbvh.top_hi
    top_miss = pbvh.top_miss.to(torch.int64)
    top_leaf = pbvh.top_leaf.to(torch.int64)

    def step(walking, best_t, pending):
        node = st.pop(walking)
        o, iv, lim = origins[walking], inv[walking], best_t[walking]
        ok, _ = _slab(lo[node], hi[node], o, iv, lim)
        leaf = top_leaf[node]
        at_leaf = ok & (leaf >= 0)
        pending[walking[at_leaf]] = leaf[at_leaf]
        inner = ok & (leaf < 0)
        il, o, iv, lim = walking[inner], o[inner], iv[inner], lim[inner]
        left = node[inner] + 1
        right = top_miss[left]
        hit_l, tn_l = _slab(lo[left], hi[left], o, iv, lim)
        hit_r, tn_r = _slab(lo[right], hi[right], o, iv, lim)
        near_left = ~(hit_l & hit_r) | (tn_l <= tn_r)
        st.push(il, torch.where(near_left, right, left),          # far first
                torch.where(near_left, hit_r, hit_l), ORDERED_STACK)
        st.push(il, torch.where(near_left, left, right),
                torch.where(near_left, hit_l, hit_r), ORDERED_STACK)
        return 2 * il.numel(), 0

    return _warp_rounds(pbvh, origins, dirs, tmax, tmin, False, False, st,
                        step, nodes=n)


# the archive kernels' plain versions: the page brute does not depend on
# the walk or the tree over the pages (a BF8V6 shares its BF8 tree's pages)
closest_ordered_plain = closest_v6_plain = closest_v6k2_plain = \
    closest_v7_plain = closest_bf8_plain
occluded_v6_plain = occluded_v4_plain


def _instanced_decoded(bvh: BF8Instanced):
    """For the plain versions of K5/K6: `decode_pages` of the shared pages
    and, per segment, its inverse transform and the decoded columns of its
    mesh's pages (the pages its leaves reference). Kept on the structure."""
    cache = getattr(bvh, "_plain_cache", None)
    if cache is not None:
        return cache
    w, bias, wd, ids = decode_pages(bvh)
    all_ids = bvh.pages[:, 0, 6 * bvh.block:7 * bvh.block].contiguous() \
        .view(torch.int32).reshape(-1)
    col_page = (torch.arange(all_ids.shape[0], device=bvh.device)
                // bvh.block)[all_ids >= 0].cpu().numpy()
    leaf_page = bvh.leaf_page.cpu().numpy()
    leaf_seg = bvh.leaf_seg.cpu().numpy()
    order = leaf_seg.argsort(kind="stable")
    starts = leaf_seg[order].searchsorted(range(bvh.n_segs + 1))
    cols_of_pages = {}      # segments of one mesh share their column set
    segs = []
    for s in range(bvh.n_segs):
        pages = tuple(sorted(set(
            leaf_page[order[starts[s]:starts[s + 1]]].tolist())))
        cols = cols_of_pages.get(pages)
        if cols is None:
            mask = torch.as_tensor(np.isin(col_page, pages),
                                   device=bvh.device)
            cols = (w[mask], bias[mask], wd[mask], ids[mask])
            cols_of_pages[pages] = cols
        segs.append(cols)
    cache = (bvh.seg_inv.reshape(bvh.n_segs, 12), segs)
    bvh._plain_cache = cache
    return cache


def _to_object(a, o, d):
    """Rays (C, 3) into the object space of the segment whose inverse
    transform row is `a` (12,), or of each ray's own row (a (C, 12)), in
    the kernel's order of operations (bf8i::to_object)."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    o2 = torch.stack([((a[..., 3 * k] * ox + a[..., 3 * k + 1] * oy)
                       + a[..., 3 * k + 2] * oz) + a[..., 9 + k]
                      for k in range(3)], dim=1)
    d2 = torch.stack([(a[..., 3 * k] * dx + a[..., 3 * k + 1] * dy)
                      + a[..., 3 * k + 2] * dz for k in range(3)], dim=1)
    return o2, d2


def _seg_chunks(n_rays: int, n_cols: int):
    """Ray slices for one segment of the plain K5/K6: rays times the
    segment's columns stay within _RAY_TRI_BUDGET."""
    chunk = max(1, _RAY_TRI_BUDGET // n_cols)
    return [slice(s0, s0 + chunk) for s0 in range(0, n_rays, chunk)]


def closest_bf8i_plain(bvh: BF8Instanced, origins, dirs, tmax,
                       tmin: float = 1e-5, raw_ids: bool = False) -> Hit:
    """Plain PyTorch version of K5: for each segment, the rays mapped into
    its object space and tested against all of its mesh's triangles; ids
    branded with segment << SEG_SHIFT. Smallest t wins; on an exact tie the
    smallest branded id (ALPHA_TRI_BIT stripped), with u/v from it."""
    seg_inv, segs = _instanced_decoded(bvh)
    dev = origins.device
    n = origins.shape[0]
    inf = float("inf")
    best_t = torch.full((n,), inf, dtype=torch.float32, device=dev)
    best_id = torch.full((n,), _INT32_MAX, dtype=torch.int64, device=dev)
    best_raw = torch.full_like(best_id, -1)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    for s, (w, bias, wd, ids) in enumerate(segs):
        if ids.shape[0] == 0:
            continue
        raw = (ids.to(torch.int64) | (s << SEG_SHIFT))[None, :]
        idc = raw & ~ALPHA_TRI_BIT
        for sl in _seg_chunks(n, ids.shape[0]):
            o2, d2 = _to_object(seg_inv[s], origins[sl], dirs[sl])
            t, u, v, ok = _woop_chunk(o2, d2, w, bias, wd, tmin, tmax[sl])
            tm = torch.where(ok, t, inf)
            seg_t = tm.min(dim=1).values
            at_min = ok & (tm == seg_t[:, None])
            sel_id = torch.where(at_min, idc, _INT32_MAX).min(dim=1).values
            j = torch.argmax((at_min & (idc == sel_id[:, None]))
                             .to(torch.int8), dim=1)[:, None]
            better = (seg_t < best_t[sl]) | ((seg_t == best_t[sl])
                                             & (sel_id < best_id[sl]))
            best_t[sl] = torch.where(better, seg_t, best_t[sl])
            best_id[sl] = torch.where(better, sel_id, best_id[sl])
            best_raw[sl] = torch.where(better, raw.expand(j.shape[0], -1)
                                       .gather(1, j)[:, 0], best_raw[sl])
            best_u[sl] = torch.where(better, u.gather(1, j)[:, 0], best_u[sl])
            best_v[sl] = torch.where(better, v.gather(1, j)[:, 0], best_v[sl])
    hit = torch.isfinite(best_t)
    tri = best_raw if raw_ids else torch.where(hit, best_id, -1)
    return Hit(torch.where(hit, best_t, tmax), tri.to(torch.int32), best_u,
               best_v)


def occluded_bf8i_plain(bvh: BF8Instanced, origins, dirs, dist,
                        tmin: float = 1e-5,
                        opaque_only: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K6: any accepted hit in any segment."""
    seg_inv, segs = _instanced_decoded(bvh)
    n = origins.shape[0]
    occ = torch.zeros((n,), dtype=torch.bool, device=origins.device)
    for s, (w, bias, wd, ids) in enumerate(segs):
        if opaque_only:
            keep = (ids & ALPHA_TRI_BIT) == 0
            w, bias, wd = w[keep], bias[keep], wd[keep]
        if w.shape[0] == 0:
            continue
        for sl in _seg_chunks(n, w.shape[0]):
            o2, d2 = _to_object(seg_inv[s], origins[sl], dirs[sl])
            _, _, _, ok = _woop_chunk(o2, d2, w, bias, wd, tmin, dist[sl])
            occ[sl] |= ok.any(dim=1)
    return occ
