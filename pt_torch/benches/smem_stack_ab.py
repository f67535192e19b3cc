"""A/B of where the warp K1 keeps each lane's stack, inside one call on the
card: local memory (the shipped kernel of csrc/bf8_warp_kernels.cu, 128
entries a lane) against shared memory sized to the tree's stack bound.

The variant is generated from the shipped source: the lane's
`int32_t stack[bf8::kStackDepth]` becomes row threadIdx.x of a static
`__shared__ int32_t [128][S]` array, S the Heightfield tree's stack bound
(7 * D8 + 1) made odd, so that neighbouring lanes' rows start in different
banks. It is built by nvcc with the port's flags and `-Xptxas -v` into a
temporary directory and bound by ctypes. On the Heightfield's (n=224, SBVH
at block 32 collapsed to BF8) bounce-0 and bounce-2 wavefronts at 512², 1
spp, the variant must be bit-equal to the shipped kernel; both are timed in
turns (shipped, shared, shared, shipped; CUDA events, the least of 3 blocks
of 5 launches behind a device sleep), beside each build's resident blocks
per SM and ptxas's line. Prints one JSON line.

    python -m pt_torch.benches.smem_stack_ab
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import tempfile
import pathlib


def _variant_source(src: str, entries: int) -> str:
    """The shipped source with each lane's stack moved into shared
    memory, `entries` int32 a lane."""
    local = "    int32_t stack[bf8::kStackDepth];\n"
    shared = ("    __shared__ int32_t lane_stacks[kThreads][kSmemStack];\n"
              "    int32_t* stack = lane_stacks[threadIdx.x];\n")
    warps = "constexpr int kWarps = kThreads / kLanes;\n"
    if src.count(local) != 1 or src.count(warps) != 1:
        raise RuntimeError("bf8_warp_kernels.cu no longer has the lines the "
                           "variant replaces")
    return src.replace(local, shared).replace(
        warps, warps + f"constexpr int kSmemStack = {entries};\n")


def _bind(path):
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pt_bf8w_closest.restype = i
    lib.pt_bf8w_closest.argtypes = [p] * 6 + [i, i, p, p, p, f, i] + [p] * 5
    lib.pt_bf8w_blocks_per_sm.restype = i
    lib.pt_bf8w_blocks_per_sm.argtypes = [i]
    return lib


def main(emit=print) -> dict:
    import torch
    from pt_torch.accel import kernels
    from pt_torch.benches import cuda_ms
    from pt_torch.render import integrator
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run.renderer import Renderer
    from pt_torch.scene.examples import make_heightfield_scene
    if not torch.cuda.is_available():
        raise SystemExit("smem_stack_ab: needs a CUDA device")
    r = Renderer(PathTracingSettings(sample_count=1, bounce_count=3),
                 device="cuda")
    r.set_scene(make_heightfield_scene(224))
    r.on_resize(512, 512)
    r.render(1)                                       # builds the accel
    waves = []
    orig = integrator.trace_closest

    def record(bvh, o, d, t):
        waves.append((o.clone(), d.clone(), t.clone()))
        return orig(bvh, o, d, t)
    integrator.trace_closest = record
    try:
        r.render(1)
    finally:
        integrator.trace_closest = orig
    bvh = r.accel.bvh
    entries = bvh.stack_bound | 1
    shipped = kernels._lib("bf8w")
    with tempfile.TemporaryDirectory() as tmp:
        src = pathlib.Path(tmp) / "bf8_warp_smem_stack.cu"
        src.write_text(_variant_source(
            (kernels.CSRC / "bf8_warp_kernels.cu").read_text(), entries))
        lib_path = pathlib.Path(tmp) / "libbf8w_smem_stack.so"
        build = subprocess.run(
            [kernels._nvcc()] + kernels.NVCC_FLAGS
            + ["-Xptxas", "-v", f"-I{kernels.CSRC}", str(src), "-o",
               str(lib_path)], capture_output=True, text=True, timeout=900)
        if build.returncode:
            raise RuntimeError(build.stderr)
        variant = _bind(lib_path)
        ptxas = [line.replace("ptxas info    :", "").strip()
                 for line in build.stderr.splitlines()
                 if "Used" in line or "stack frame" in line]
        stream = torch.cuda.current_stream().cuda_stream

        def launch(lib, o, d, t, out):
            code = lib.pt_bf8w_closest(
                *kernels._tree_args(bvh), o.data_ptr(), d.data_ptr(),
                t.data_ptr(), 1e-5, o.shape[0],
                *(a.data_ptr() for a in out), stream)
            if code:
                raise RuntimeError(f"launch failed: {code}")

        res = {"device": torch.cuda.get_device_name(0),
               "power": subprocess.run(
                   ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], capture_output=True,
                   text=True, timeout=60).stdout.strip(),
               "tree_depth": bvh.depth, "smem_stack_entries": entries,
               "blocks_per_sm": {
                   arm: int(lib.pt_bf8w_blocks_per_sm(0))
                   for arm, lib in (("local", shipped), ("shared", variant))},
               "ptxas_shared": ptxas, "ms": {}}
        for b in (0, 2):
            o, d, t = waves[b]
            n = o.shape[0]
            outs = {}
            for arm, lib in (("local", shipped), ("shared", variant)):
                out = (torch.empty(n, device=o.device),
                       torch.empty(n, dtype=torch.int32, device=o.device),
                       torch.empty(n, device=o.device),
                       torch.empty(n, device=o.device))
                launch(lib, o, d, t, out)
                outs[arm] = out
            torch.cuda.synchronize()
            same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                       for x, y in zip(outs["local"], outs["shared"]))
            if not same:
                raise RuntimeError(f"bounce {b}: the shared-stack variant "
                                   "differs from the shipped kernel")
            times = {"local": [], "shared": []}
            for arm in ("local", "shared", "shared", "local"):
                lib = shipped if arm == "local" else variant
                times[arm].append(min(cuda_ms(
                    lambda: launch(lib, o, d, t, outs[arm]), 5)
                    for _ in range(3)))
            res["ms"][f"bounce{b}"] = times
    emit(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
