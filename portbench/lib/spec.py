"""`BENCHMARK.json` and the files it names, found by name.

A configuration is `portbench/configs/<config>.py`, a traffic mix
`portbench/traffic/<traffic>.json` (data), the code that drives and checks
a mix's `kind` `portbench/kinds/<kind>.py`, a metric
`portbench/metrics/<name>.py`. A metric split by cell, `<quantity>.<part>`,
is read by `metrics/<quantity>.py` where it has no file of its own. A later
change adds a cell, a mix, a kind or a metric by adding such a file and its
entry in `BENCHMARK.json`; nothing here changes for it."""

from __future__ import annotations

import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
REPO_ROOT = BENCH_DIR.parent


def load_spec(root: pathlib.Path = REPO_ROOT) -> Dict[str, Any]:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def load_module(path: pathlib.Path, name: str) -> ModuleType:
    """The Python file at `path` as a module (names may hold dots, so it is
    loaded by path, not imported by name)."""
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(
        "portbench_file_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(spec: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(spec: Dict[str, Any], name: str) -> Dict[str, Any]:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config(spec, name: str, root: pathlib.Path = REPO_ROOT):
    """The configuration module that `BENCHMARK.json` names as `name`."""
    return load_module(root / config_entry(spec, name)["file"], name)


def load_traffic(name: str, bench_dir: pathlib.Path = BENCH_DIR) -> Dict:
    path = bench_dir / "traffic" / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def load_kind(kind: str, bench_dir: pathlib.Path = BENCH_DIR) -> ModuleType:
    """The module that drives (`run`) and checks (`check`) a traffic mix of
    `kind`."""
    return load_module(bench_dir / "kinds" / f"{kind}.py", "kind_" + kind)


def load_metric(name: str, bench_dir: pathlib.Path = BENCH_DIR) -> ModuleType:
    """The reader of metric `name`: its own file, else that of its quantity
    (the name up to its first dot) for a metric split by cell."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.exists():
        path = bench_dir / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, "metric_" + name)


def metrics_of(spec, cell: str, kind: str) -> List[Dict[str, Any]]:
    """The `end_to_end` or `per_layer` metrics that `cell` reports: those
    whose `workloads` list it, or that have none."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]
