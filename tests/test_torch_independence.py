"""The PyTorch port stands alone: no JAX, no `pt`, no `benches`, no Pillow.

An AST scan finds no import of them under pt_torch/ (the archive module and
the ported A/B harnesses under pt_torch/benches/ included) or in
chip_smoke.py; each CUDA kernel library builds from the port's own csrc/
(every header it includes is one of its listed sources); in a subprocess
where they are made unimportable, pt_torch imports and renders an 8²
Heightfield, the Default scene, a small Courtyard and an instanced alpha
scene on the CPU, runs the archive path (both
harnesses, a frame through a BF8V6) and the frame budget and drain model
(`pt_torch.benches.budget`, `.drain_sim`), and runs `python -m
pt_torch.run.cli` (`list-scenes`, a 16² `render --device cpu` to PNG, and
`debug`, `stats` and `render --hdr`);
and with no device named, the entry points take the card and raise when
there is none. Ranks that `pt_torch.dist.launch` spawns from this process,
which has JAX and `pt` loaded, load neither.
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
# the functions that import Pillow, where `pt` does: JPG/TGA/WEBP decoding,
# JPG/TGA writing, the MJPEG AVI's frames and the viewer's JPEG stream; and
# chip_smoke's video arm and viewer phase, which decode those JPEGs where
# Pillow is installed
PILLOW_ONLY_IN = {("textures.py", "decode_image_u8"),
                  ("textures.py", "get_texture_info"),
                  ("saver.py", "write_image"), ("avi.py", "write_frame"),
                  ("viewer.py", "_encode_jpeg"),
                  ("chip_smoke.py", "phase_import"),
                  ("chip_smoke.py", "phase_view")}


def _port_sources():
    files = sorted((ROOT / "pt_torch").rglob("*.py"))
    assert len(files) > 15
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_pt_imports(path):
    """No import of JAX, `pt` or `benches` anywhere; Pillow only inside
    the functions of PILLOW_ONLY_IN, so that importing any module of the
    port never loads it."""
    tree = ast.parse(path.read_text(), filename=str(path))
    owner = {}
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for inner in ast.walk(fn):
                owner.setdefault(inner, fn.name)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [] if node.level else [(node.module or "").split(".")[0]]
        else:
            continue
        bad = FORBIDDEN.intersection(roots)
        if bad == {"PIL"} and (path.name, owner.get(node)) in PILLOW_ONLY_IN:
            continue
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
        "    r.set_scene(scene, stream_textures=False)\n"
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


def test_cli_runs_without_jax_pt_or_pillow(tmp_path):
    """`python -m pt_torch.run.cli list-scenes` and a 16² `render --device
    cpu` to PNG, in a process where `jax`, `pt`, `benches` and Pillow
    cannot be imported."""
    png = tmp_path / "cli.png"
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'pt', 'benches', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "for argv in (['list-scenes'], ['render', '--scene',"
        " 'Test Scenes/Default', '--size', '16x16', '--spp', '1',"
        f" '--bounces', '2', '--device', 'cpu', '--out', {str(png)!r}]):\n"
        "    sys.argv = ['pt_torch.run.cli'] + argv\n"
        "    try:\n"
        "        runpy.run_module('pt_torch.run.cli', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (argv, e.code)\n"
        "loaded = {m.split('.')[0] for m, v in sys.modules.items()"
        " if v is not None}\n"
        "assert not loaded & {'jax', 'pt', 'benches', 'PIL'}\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "Test Scenes" and lines[-1] == "OK"
    assert "  Test Scenes/Reuse Mesh" in lines
    from pt_torch.scene.textures import decode_png
    assert decode_png(png.read_bytes()).shape == (16, 16, 4)


def test_debug_stats_and_hdr_run_without_jax_pt_or_pillow(tmp_path):
    """`python -m pt_torch.run.cli debug` (every flag), `stats` and `render
    --hdr`, on the CPU, in a process where `jax`, `pt`, `benches` and
    Pillow cannot be imported."""
    code = (
        "import runpy, sys, torch\n"
        "torch.set_num_threads(1)   # beside the other test processes\n"
        "for m in ('jax', 'pt', 'benches', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "for argv in (['debug', '--mode', 'color', '--size', '16x12',"
        " '--force-opaque', '--cull-backfaces', '--disable-color-texture',"
        " '--disable-shadows', '--out', 'd.png'],"
        " ['stats'], ['render', '--hdr', '--size', '16x16', '--spp', '1',"
        " '--bounces', '2', '--out', 'h.png']):\n"
        "    sys.argv = ['pt_torch.run.cli'] + argv + ['--device', 'cpu']\n"
        "    try:\n"
        "        runpy.run_module('pt_torch.run.cli', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (argv, e.code)\n"
        "loaded = {m.split('.')[0] for m, v in sys.modules.items()"
        " if v is not None}\n"
        "assert not loaded & {'jax', 'pt', 'benches', 'PIL'}\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "OK" and any(line.startswith("Render: ")
                                     for line in lines)
    from pt_torch.scene.textures import decode_png
    assert decode_png((tmp_path / "d.png").read_bytes()).shape == (12, 16, 4)
    assert decode_png((tmp_path / "h.png").read_bytes()).shape == (16, 16, 4)


def test_importers_and_cli_import_without_jax_pt_or_pillow():
    """The importers, `dds`, `gltf_export`, `avi`, the catalog, the saver
    and the CLI import in a process where `jax`, `pt`, `benches` and
    Pillow cannot be imported."""
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'pt', 'benches', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "for m in ('scene.gltf', 'scene.obj', 'scene.fbx', 'scene.dds',"
        " 'scene.gltf_export', 'scene.catalog', 'scene.manager',"
        " 'out.avi', 'out.saver', 'core.threads', 'core.config',"
        " 'run.cli', 'run.app'):\n"
        "    importlib.import_module('pt_torch.' + m)\n"
        "loaded = {m.split('.')[0] for m, v in sys.modules.items()"
        " if v is not None}\n"
        "assert not loaded & {'jax', 'pt', 'benches', 'PIL'}\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_export_import_and_render_without_pillow(tmp_path):
    """A small Courtyard exported to .glb (its textures as the port's PNG),
    imported, its DDS, PNG and HDR textures decoded, and the glb rendered
    to PNG through the CLI, in a process where `jax`, `pt`, `benches` and
    Pillow cannot be imported."""
    glb, png = tmp_path / "c.glb", tmp_path / "c.png"
    code = (
        "import runpy, sys, torch\n"
        "torch.set_num_threads(1)   # beside the other test processes\n"
        "for m in ('jax', 'pt', 'benches', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from pt_torch.out.saver import write_radiance_hdr\n"
        "from pt_torch.scene.builder import SceneBuilder\n"
        "from pt_torch.scene.gltf import import_gltf\n"
        "from pt_torch.scene.gltf_export import export_glb\n"
        "from pt_torch.scene.standin import make_courtyard_scene\n"
        "from pt_torch.scene.textures import build_texture_pool\n"
        "from pt_torch.scene.types import TextureInfo, TextureType\n"
        f"export_glb(make_courtyard_scene(0.1, 0.05), {str(glb)!r})\n"
        "b = SceneBuilder('c')\n"
        f"import_gltf(b, {str(glb)!r})\n"
        "scene = b.create_scene()\n"
        "assert len(scene.textures) >= 40, len(scene.textures)\n"
        f"write_radiance_hdr({str(tmp_path / 'e.hdr')!r},"
        " np.ones((2, 2, 3), np.float32))\n"
        "infos = scene.textures[:3] + [TextureInfo('d', TextureType.COLOR,"
        f" path={str(ROOT / 'tests/data/adv_legacy_dxt1.dds')!r}),"
        f" TextureInfo('e', TextureType.COLOR, path={str(tmp_path / 'e.hdr')!r})]\n"
        "pool = build_texture_pool(infos, device='cpu')\n"
        "assert pool.count == 9 + 5 and int(pool.sizes[9 + 3, 0, 0]) == 8\n"
        "assert pool.sizes[9:, 0].prod(-1).min() > 1   # none a placeholder\n"
        "sys.argv = ['pt_torch.run.cli', 'render', '--scene',"
        f" {str(glb)!r}, '--size', '16x16', '--spp', '1', '--bounces', '2',"
        f" '--device', 'cpu', '--out', {str(png)!r}]\n"
        "try:\n"
        "    runpy.run_module('pt_torch.run.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "loaded = {m.split('.')[0] for m, v in sys.modules.items()"
        " if v is not None}\n"
        "assert not loaded & {'jax', 'pt', 'benches', 'PIL'}\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "OK"
    from pt_torch.scene.textures import decode_png
    image = decode_png(png.read_bytes())
    assert image.shape == (16, 16, 4) and image[..., :3].max() > 0


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


def test_spawned_ranks_load_neither_jax_nor_pt():
    """Two CPU ranks over gloo, spawned by `pt_torch.dist.launch` from this
    process (JAX and `pt` loaded), import the port and the rank bodies of
    tests/torch_dist_ranks.py, and find neither `jax` nor `pt` among their
    modules."""
    import jax  # noqa: F401
    import pt.dist.mesh  # noqa: F401
    import torch_dist_ranks
    from pt_torch.dist.launch import launch
    roots = launch(torch_dist_ranks.loaded_roots, 2, "gloo", device="cpu")
    assert len(roots) == 2
    for loaded in roots:
        assert {"torch", "pt_torch", "torch_dist_ranks"} <= set(loaded)
        assert not {"jax", "jaxlib", "pt", "benches"} & set(loaded), loaded
