"""ctypes loader of the native SAH/SBVH builder (`csrc/sah_bvh.cpp`).

The port's own build of the repository's framework-free C++ builder: it
compiles with the host g++ into the port's git-ignored build directory
(`pt_torch/.build/`), never sharing another package's library, and loads
through a plain C ABI. There is no silent fallback: if the compiler or the
library fails, the build raises.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

from pt_torch.core.compilewatch import stage_call

_SRC = pathlib.Path(__file__).resolve().parents[2] / "csrc" / "sah_bvh.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / ".build"
_LIB = BUILD_DIR / "libptsah_torch.so"
_lock = threading.Lock()
_lib_handle: Optional[ctypes.CDLL] = None

# flags as pt/accel/native.py builds the same source, so that both packages
# produce the same trees from the same input
_CXXFLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def compile_shared(cmd_prefix, sources, out: pathlib.Path,
                   timeout: float = 600) -> str:
    """Compile `sources` into the shared library `out`, atomically: the
    library is written under a temporary name and renamed, so concurrent
    processes never load a half-written file. Returns the compiler's
    output; raises with it on failure."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = list(cmd_prefix) + [str(s) for s in sources] + ["-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"build of {out.name} failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def _load() -> ctypes.CDLL:
    global _lib_handle
    with _lock:
        if _lib_handle is not None:
            return _lib_handle
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            stage_call(compile_shared, ["g++"] + _CXXFLAGS, [_SRC], _LIB,
                       what="SBVH library build", hang_warn_s=600.0)
        lib = ctypes.CDLL(str(_LIB))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.pt_build_sah_bvh.restype = ctypes.c_int
        lib.pt_build_sah_bvh.argtypes = [f32p, f32p, f32p, ctypes.c_int,
                                         ctypes.c_int, i32p, f32p, f32p,
                                         i32p, i32p, i32p, ctypes.c_int]
        lib.pt_build_sbvh.restype = ctypes.c_int
        lib.pt_build_sbvh.argtypes = [f32p, f32p, f32p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, i32p,
                                      f32p, f32p, i32p, i32p, i32p, i32p,
                                      ctypes.c_float, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_int]
        _lib_handle = lib
        return lib


# Distinct sentinel returned when a build aborts on its node budget
# (callers retry at a coarser block).
OVERFLOW = object()

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)


def _as_f(a):
    return a.ctypes.data_as(_f32p)


def _as_i(a):
    return a.ctypes.data_as(_i32p)


def _result(n, order, node_lo, node_hi, miss, leaf_start, leaf_count):
    if n == -2:
        return OVERFLOW
    if n <= 0:
        raise RuntimeError(f"native BVH build failed (code {n})")
    return (order, node_lo[:n], node_hi[:n], miss[:n], leaf_start[:n],
            leaf_count[:n])


def build_sah(tri_lo: np.ndarray, tri_hi: np.ndarray, centroids: np.ndarray,
              max_leaf: int, max_nodes: int = 0):
    """Native binned-SAH build over (T, 3) f32 bounds/centroids. Returns
    (order, node_lo, node_hi, miss, leaf_start, leaf_count) in threaded
    preorder, or OVERFLOW when the build exceeded `max_nodes` (> 0)."""
    lib = _load()
    t = tri_lo.shape[0]
    tri_lo = np.ascontiguousarray(tri_lo, np.float32)
    tri_hi = np.ascontiguousarray(tri_hi, np.float32)
    centroids = np.ascontiguousarray(centroids, np.float32)
    cap = 2 * t + 1
    order = np.zeros(t, np.int32)
    node_lo = np.zeros((cap, 3), np.float32)
    node_hi = np.zeros((cap, 3), np.float32)
    miss = np.zeros(cap, np.int32)
    leaf_start = np.zeros(cap, np.int32)
    leaf_count = np.zeros(cap, np.int32)
    n = lib.pt_build_sah_bvh(_as_f(tri_lo), _as_f(tri_hi), _as_f(centroids),
                             t, max_leaf, _as_i(order), _as_f(node_lo),
                             _as_f(node_hi), _as_i(miss), _as_i(leaf_start),
                             _as_i(leaf_count), max_nodes)
    return _result(n, order, node_lo, node_hi, miss, leaf_start, leaf_count)


def build_sbvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
               max_leaf: int, ref_budget: float = 1.75, alpha: float = 1e-5,
               max_nodes: int = 0, presplit_mult: float = 0.0,
               spatial_min_count: int = 0):
    """Native SBVH build (binned SAH + spatial splits, Stich et al. 2009).
    Triangles may be referenced by several leaves, so `order` is a
    reference list (len ≥ T). Returns as `build_sah`."""
    lib = _load()
    t = v0.shape[0]
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    max_refs = max(t, int(ref_budget * t) + 16)
    cap = 2 * max_refs + 1
    order = np.zeros(max_refs, np.int32)
    node_lo = np.zeros((cap, 3), np.float32)
    node_hi = np.zeros((cap, 3), np.float32)
    miss = np.zeros(cap, np.int32)
    leaf_start = np.zeros(cap, np.int32)
    leaf_count = np.zeros(cap, np.int32)
    nrefs = np.zeros(1, np.int32)
    n = lib.pt_build_sbvh(_as_f(v0), _as_f(v1), _as_f(v2), t, max_leaf,
                          max_refs, _as_i(order), _as_f(node_lo),
                          _as_f(node_hi), _as_i(miss), _as_i(leaf_start),
                          _as_i(leaf_count), _as_i(nrefs),
                          ctypes.c_float(alpha), max_nodes,
                          ctypes.c_float(presplit_mult), spatial_min_count)
    res = _result(n, order, node_lo, node_hi, miss, leaf_start, leaf_count)
    if res is OVERFLOW:
        return res
    return (order[:int(nrefs[0])],) + res[1:]
