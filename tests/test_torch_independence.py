"""The PyTorch port stands alone: no JAX, no `pt`, no `benches`, no Pillow.

An AST scan finds no import of them under pt_torch/ (the archive module and
the ported A/B harnesses under pt_torch/benches/ included) or in
chip_smoke.py; each CUDA kernel library builds from the port's own csrc/
(every header it includes is one of its listed sources); in a subprocess
where they are made unimportable, pt_torch imports and renders an 8²
Heightfield, the Default scene, a small Courtyard and an instanced alpha
scene on the CPU, runs the archive path (both
harnesses, a frame through a BF8V6) and the frame budget and drain model
(`pt_torch.benches.budget`, `.drain_sim`); and with no device named, the
entry points take the card and raise when there is none.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "pt", "benches", "PIL"}


def _port_sources():
    files = sorted((ROOT / "pt_torch").rglob("*.py"))
    assert len(files) > 15
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_pt_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [] if node.level else [(node.module or "").split(".")[0]]
        else:
            continue
        bad = FORBIDDEN.intersection(roots)
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def _kernel_libraries():
    from pt_torch.accel import kernels
    return sorted(kernels._CUDA_LIBS)


@pytest.mark.parametrize("name", _kernel_libraries())
def test_kernel_sources_stand_alone(name):
    """Each kernel library (`kernels._CUDA_LIBS`; `bf8w`, the warp K1 and
    closest_v6, among them) compiles from the port's own csrc/ and the CUDA
    runtime's headers only: every quoted include, followed to the end,
    names a file of csrc/ that the library lists as a source (so a change
    to it rebuilds the library), and nothing reaches JAX, `pt` or `csrc/`
    at the repository's root."""
    import re
    from pt_torch.accel import kernels
    _, sources = kernels._CUDA_LIBS[name]
    system = {"cuda_runtime.h", "stdint.h", "math.h", "string.h"}
    seen, todo = set(), [sources[0]]
    while todo:
        src = todo.pop()
        if src in seen:
            continue
        seen.add(src)
        assert src.parent == kernels.CSRC, src
        text = src.read_text()
        assert not re.search(r"\b(jax|jaxlib|pallas)\b", "\n".join(
            line for line in text.splitlines() if line.startswith("#")))
        for quoted, angled in re.findall(
                r'^#include\s+(?:"([^"]+)"|<([^>]+)>)', text, re.M):
            if angled:
                assert angled in system, f"{src.name} includes <{angled}>"
            else:
                todo.append(kernels.CSRC / quoted)
    assert seen == set(sources), sorted(p.name for p in seen ^ set(sources))


def test_port_renders_without_jax_or_pt():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pt'] = None\n"
        "import numpy as np\n"
        "from pt_torch.render.integrator import PathTracingSettings\n"
        "from pt_torch.run.renderer import Renderer\n"
        "from pt_torch.scene.examples import make_heightfield_scene\n"
        "r = Renderer(PathTracingSettings(bounce_count=2), device='cpu')\n"
        "r.set_scene(make_heightfield_scene(8))\n"
        "r.on_resize(8, 8)\n"
        "r.render(1)\n"
        "film = r.film_mean()\n"
        "assert film.shape == (8, 8, 3) and np.isfinite(film).all()\n"
        "assert 'jax' not in {m.split('.')[0] for m, v in sys.modules.items()"
        " if v is not None}\n"
        "print('OK', float(film.mean()))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_instanced_and_default_scenes_render_without_jax_pt_or_pillow():
    """The shared-BLAS path, the Courtyard and the Default scene
    with its embedded PNGs, in a process where `jax`, `pt`, `benches` and
    Pillow cannot be imported."""
    code = (
        "import sys\n"
        "for m in ('jax', 'pt', 'benches', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "import chip_smoke\n"
        "from pt_torch.render.integrator import PathTracingSettings\n"
        "from pt_torch.run.renderer import Renderer\n"
        "from pt_torch.scene.examples import TEST_SCENES\n"
        "from pt_torch.scene.standin import make_courtyard_scene\n"
        "scenes = [(TEST_SCENES['Default'](), 'auto', 'BF8BVH'),\n"
        "          (make_courtyard_scene(0.1, 0.05), 'shared',"
        " 'BF8Instanced'),\n"
        "          (chip_smoke.build_instanced_scene("
        "chip_smoke.port_namespace(), 4, 8, True), 'shared',"
        " 'BF8Instanced')]\n"
        "for scene, mode, kind in scenes:\n"
        "    r = Renderer(PathTracingSettings(bounce_count=2), device='cpu',"
        " instancing=mode)\n"
        "    r.set_scene(scene)\n"
        "    r.on_resize(8, 8)\n"
        "    r.render(1)\n"
        "    assert type(r.accel.bvh).__name__ == kind, type(r.accel.bvh)\n"
        "    film = r.film_mean()\n"
        "    assert np.isfinite(film).all() and film.max() > 0\n"
        "loaded = {m.split('.')[0] for m, v in sys.modules.items()"
        " if v is not None}\n"
        "assert not loaded & {'jax', 'pt', 'benches', 'PIL'}\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_archive_path_runs_without_jax_or_pt():
    """`pt_torch.benches.bvh_kernels` / `.widesub_ab` and a frame whose tree
    is a BF8V6, in a process where `jax`, `pt` and `benches` cannot be
    imported."""
    assert {"archive.py", "bvh_kernels.py", "widesub_ab.py"} <= {
        p.name for p in _port_sources()}
    code = (
        "import sys\n"
        "for m in ('jax', 'pt', 'benches'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from pt_torch.accel import archive\n"
        "from pt_torch.benches import bvh_kernels, widesub_ab\n"
        "for bench in (bvh_kernels, widesub_ab):\n"
        "    out = bench.main(device='cpu', n_rays=256, n=8,"
        " emit=lambda line: None)\n"
        "    assert all(a['oracle_mismatches'] == 0 for a in out['arms'])\n"
        "from pt_torch.render.integrator import PathTracingSettings\n"
        "from pt_torch.run.renderer import Renderer\n"
        "from pt_torch.scene.examples import make_heightfield_scene\n"
        "r = Renderer(PathTracingSettings(sample_count=1, bounce_count=2),"
        " device='cpu')\n"
        "r.set_scene(make_heightfield_scene(8))\n"
        "r.on_resize(8, 8)\n"
        "archive.swap_in_bf8_v6(r)\n"
        "archive.reset_call_counts()\n"
        "r.render()\n"
        "assert archive.calls['packet_closest_v6'] == 2, archive.calls\n"
        "assert not any(archive.launches.values())\n"
        "assert np.isfinite(r.film_mean()).all()\n"
        "loaded = {m.split('.')[0] for m, v in sys.modules.items()"
        " if v is not None}\n"
        "assert not loaded & {'jax', 'pt', 'benches'}\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_budget_and_drain_run_without_jax_or_pt():
    """`pt_torch.benches.budget` and `.drain_sim` (K1's pops variant through
    its plain walk) in a process where `jax`, `pt` and `benches` cannot be
    imported."""
    assert {"budget.py", "drain_sim.py"} <= {p.name for p in _port_sources()}
    code = (
        "import sys\n"
        "for m in ('jax', 'pt', 'benches'):\n"
        "    sys.modules[m] = None\n"
        "from pt_torch.benches import budget, drain_sim\n"
        "b = budget.main(device='cpu', width=32, bounces=1, n=16,"
        " n_sample=1024, emit=lambda line: None)\n"
        "assert b['bounces'][0]['rounds_max'] >= 1 and b['union']\n"
        "d = drain_sim.main(device='cpu', width=32, bounces=1, n=16,"
        " emit=lambda line: None)\n"
        "r = d['bounces'][0]\n"
        "assert (r['rounds'] == r['done'].max(axis=1)).all()\n"
        "loaded = {m.split('.')[0] for m, v in sys.modules.items()"
        " if v is not None}\n"
        "assert not loaded & {'jax', 'pt', 'benches'}\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_default_device_is_the_card():
    from pt_torch import default_device
    from pt_torch.run.renderer import Renderer
    assert default_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert default_device() == torch.device("cuda:0")
        assert Renderer().device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            default_device()
        with pytest.raises(RuntimeError):
            Renderer()
        with pytest.raises(RuntimeError):
            default_device("cuda")
