"""Compare the machine code (SASS) of the kernel libraries built from this
checkout and from another checkout of the repository.

A change that only moves inlined device code between headers (a helper
shared by two kernels, say) should leave the machine code of the kernels
it does not mean to change identical; identical SASS settles that no
timing noise could. Each library of `pt_torch.accel.kernels._CUDA_LIBS`
that both checkouts have is built with the port's nvcc flags into a
temporary directory, disassembled with `cuobjdump -sass`, and the two
listings are compared kernel by kernel (by mangled name), with their
addresses and the sources' file-name hashes masked. One line per library:
"same" when every kernel of both is the same, else per kernel "same", the
count of differing lines, or that it is only in one of the two (a kernel
that a change adds beside the others, whose own code must not move).

    python -m pt_torch.benches.sass_diff OTHER_CHECKOUT [LIB ...]

Needs nvcc and cuobjdump (the CUDA toolkit); runs no kernel.
"""

from __future__ import annotations

import argparse
import difflib
import pathlib
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

from pt_torch.accel import kernels

_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")
_MANGLED = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?)_cu_[0-9a-f]{8}")


def _sass(src: pathlib.Path, out: pathlib.Path) -> dict:
    """{kernel's mangled name (masked): its SASS lines (masked)}."""
    nvcc = kernels._nvcc()
    subprocess.run([nvcc] + kernels.NVCC_FLAGS + [str(src), "-o", str(out)],
                   check=True, capture_output=True, timeout=900)
    cuobjdump = str(pathlib.Path(nvcc).with_name("cuobjdump"))
    if not pathlib.Path(cuobjdump).exists():
        cuobjdump = shutil.which("cuobjdump") or "cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(out)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    out, name = {}, None
    for line in text.splitlines():
        line = _MANGLED.sub(r"<anon \1>", _ADDR.sub("", line)).rstrip()
        if line.strip().startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            out[name] = []
        elif name is not None and line.strip():
            out[name].append(line)
    return out


def _compare(a: dict, b: dict) -> dict:
    """{kernel: differing lines between here (`a`) and there (`b`), or
    "only here" / "only there"}."""
    out = {}
    for name in sorted(set(a) | set(b)):
        if name not in b:
            out[name] = "only here"
        elif name not in a:
            out[name] = "only there"
        else:
            out[name] = sum(1 for line in difflib.unified_diff(
                b[name], a[name], lineterm="", n=0)
                if line[:1] in "+-" and line[:3] not in ("+++", "---"))
    return out


def main(other: str, libs=None, emit=print) -> dict:
    """{library: {kernel: differing SASS lines, or "only here" / "only
    there"}} between this checkout's build and `other`'s, for `libs`
    (default: every library both have)."""
    other_csrc = (pathlib.Path(other).resolve() / "pt_torch" / "accel"
                  / "csrc")
    names = libs or sorted(kernels._CUDA_LIBS)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        pairs = {}
        for name in names:
            src = kernels._CUDA_LIBS[name][1][0]
            theirs = other_csrc / src.name
            if not theirs.exists():
                emit(f"{name}: {src.name} is not in {other}")
                continue
            pairs[name] = (src, theirs)
        # one nvcc per source, all started together
        with ThreadPoolExecutor(max_workers=2 * max(len(pairs), 1)) as pool:
            built = {(name, side): pool.submit(
                _sass, path, pathlib.Path(tmp) / f"{side}_{name}.so")
                for name, paths in pairs.items()
                for side, path in zip("ab", paths)}
        for name in pairs:
            a, b = built[(name, "a")].result(), built[(name, "b")].result()
            out[name] = per = _compare(a, b)
            lines = (sum(map(len, a.values())), sum(map(len, b.values())))
            if all(v == 0 for v in per.values()):
                emit(f"{name}: same ({len(per)} kernels, {lines[0]} SASS "
                     f"lines here, {lines[1]} there)")
                continue
            emit(f"{name}: " + "; ".join(
                f"{k}: " + ("same" if v == 0 else v if isinstance(v, str)
                            else f"{v} lines differ")
                for k, v in per.items()))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("libs", nargs="*", help="libraries (default: all)")
    args = ap.parse_args()
    main(args.other, args.libs or None)
