"""Compare the machine code (SASS) of the kernel libraries built from this
checkout and from another checkout of the repository.

A change that only moves inlined device code between headers (a helper
shared by two kernels, say) should leave the machine code of the kernels
it does not mean to change identical; identical SASS settles that no
timing noise could. Each library of `pt_torch.accel.kernels._CUDA_LIBS`
that both checkouts have is built with the port's nvcc flags into a
temporary directory, disassembled with `cuobjdump -sass`, and the two
listings are compared with their addresses and the sources' file-name
hashes masked. One line per library: "same", or the count of differing
lines.

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

from pt_torch.accel import kernels

_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")
_MANGLED = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]+")


def _sass(src: pathlib.Path, out: pathlib.Path) -> list:
    nvcc = kernels._nvcc()
    subprocess.run([nvcc] + kernels.NVCC_FLAGS + [str(src), "-o", str(out)],
                   check=True, capture_output=True, timeout=900)
    cuobjdump = str(pathlib.Path(nvcc).with_name("cuobjdump"))
    if not pathlib.Path(cuobjdump).exists():
        cuobjdump = shutil.which("cuobjdump") or "cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(out)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    return [_MANGLED.sub(r"<anon \1>", _ADDR.sub("", line)).rstrip()
            for line in text.splitlines() if line.strip()]


def main(other: str, libs=None, emit=print) -> dict:
    """{library: number of differing SASS lines} between this checkout's
    build and `other`'s, for `libs` (default: every library both have)."""
    other_csrc = (pathlib.Path(other).resolve() / "pt_torch" / "accel"
                  / "csrc")
    names = libs or sorted(kernels._CUDA_LIBS)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            src = kernels._CUDA_LIBS[name][1][0]
            theirs = other_csrc / src.name
            if not theirs.exists():
                emit(f"{name}: {src.name} is not in {other}")
                continue
            a = _sass(src, pathlib.Path(tmp) / f"a_{name}.so")
            b = _sass(theirs, pathlib.Path(tmp) / f"b_{name}.so")
            diff = [line for line in difflib.unified_diff(b, a, lineterm="",
                                                          n=0)
                    if line[:1] in "+-" and line[:3] not in ("+++", "---")]
            out[name] = len(diff)
            verdict = f"{len(diff)} lines differ" if diff else "same"
            emit(f"{name}: {verdict} ({len(a)} SASS lines here, {len(b)} "
                 "there)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("libs", nargs="*", help="libraries (default: all)")
    args = ap.parse_args()
    main(args.other, args.libs or None)
