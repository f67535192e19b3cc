"""The import check by whole top-level names, and what the benchmark's
modules load: no JAX, no JAX package `pt`, and in the reference no port."""

import subprocess
import sys

import pytest

from portbench.lib import guard
from portbench.lib.spec import BENCH_DIR, REPO_ROOT


@pytest.mark.parametrize("name, bad", [
    ("pt_torch", False), ("pt_torch.run.offline", False),
    ("portbench.lib.main", False), ("ptx", False), ("jax_like", False),
    ("pt", True), ("pt.render.integrator", True), ("jax", True),
    ("jax.numpy", True), ("jaxlib", True), ("jaxlib.xla_client", True),
    ("flax", True)])
def test_whole_top_level_names(name, bad):
    assert bool(guard.forbidden_modules([name])) == bad


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(REPO_ROOT)!r})\n{code}\n"
         "print('\\n'.join(sorted(sys.modules)))"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO_ROOT))
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_nothing_the_benchmark_runs_loads_jax_or_pt():
    metrics = sorted(p.stem for p in (BENCH_DIR / "metrics").glob("*.py"))
    code = ("import portbench.lib.main, portbench.lib.drive, "
            "portbench.readings\n"
            "from portbench.lib import spec, namespaces\n"
            "namespaces.port_namespace(); namespaces.reference_namespace()\n"
            "import pt_torch.run.offline, pt_torch.run.renderer\n"
            + "".join(f"spec.load_metric({m!r})\n" for m in metrics))
    loaded = _loaded_after(code)
    assert not guard.forbidden_modules(loaded)
    assert "pt_torch" in loaded


def test_the_reference_imports_no_port():
    code = ("import portbench.reference.compare, portbench.reference.render\n"
            "from portbench.lib import namespaces\n"
            "namespaces.reference_namespace()")
    loaded = _loaded_after(code)
    assert not guard.forbidden_modules(loaded)
    assert not [m for m in loaded if m.split(".")[0] == "pt_torch"]
