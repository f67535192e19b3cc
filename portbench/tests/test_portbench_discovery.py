"""Configurations, traffic mixes, traffic kinds and metrics are found by
name: every entry of BENCHMARK.json has its file, and a dummy of each added
from another folder is found the same way."""

import json

import pytest

from portbench.lib import spec as bench_spec


@pytest.fixture(scope="module")
def spec():
    return bench_spec.load_spec()


def test_every_config_loads(spec):
    for entry in spec["configs"]:
        cfg = bench_spec.load_config(spec, entry["name"])
        assert cfg.NAME == entry["name"]
        assert cfg.SOURCE == entry["source"]
        assert cfg.REDUCED == entry["reduced"]
        assert callable(cfg.generate)


def test_every_cell_has_its_traffic_and_limits(spec):
    from portbench.reference.compare import load_limits
    for cell in spec["workloads"]:
        traffic = bench_spec.load_traffic(cell["traffic"])
        kind = bench_spec.load_kind(traffic["kind"])
        assert callable(kind.run) and callable(kind.check)
        assert load_limits(cell["name"])


def test_every_metric_has_a_reader(spec):
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            assert callable(bench_spec.load_metric(m["name"]).read)


def test_metrics_of_follow_workloads(spec):
    still = {m["name"] for m in
             bench_spec.metrics_of(spec, "courtyard.still", "end_to_end")}
    video = {m["name"] for m in bench_spec.metrics_of(
        spec, "heightfield_anim.video", "end_to_end")}
    assert "frame_ms_p90" in video and "frame_ms_p90" not in still
    assert "samples_per_s" in still and "samples_per_s.video" in video
    assert {"setup_s", "peak_mem_gib"} <= still & video


def test_every_cell_reports_what_its_layer_metrics_move(spec):
    e2e = {c["name"]: {m["name"] for m in bench_spec.metrics_of(
        spec, c["name"], "end_to_end")} for c in spec["workloads"]}
    for m in spec["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in e2e[cell], (m["name"], cell)
    for cell, names in e2e.items():
        assert "setup_s" in names and len(names) >= 2
        assert bench_spec.metrics_of(spec, cell, "per_layer")


def test_a_dummy_of_each_is_discovered(tmp_path):
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "traffic").mkdir()
    (tmp_path / "portbench" / "metrics").mkdir()
    (tmp_path / "portbench" / "kinds").mkdir()
    (tmp_path / "portbench" / "configs" / "dummy.py").write_text(
        "NAME = 'dummy'\nPARAMS = {}\nSETTINGS = {}\n"
        "def generate(builder, ns):\n    pass\n")
    (tmp_path / "portbench" / "traffic" / "tiny.json").write_text(
        json.dumps({"kind": "sweep", "width": 4, "height": 4}))
    (tmp_path / "portbench" / "kinds" / "sweep.py").write_text(
        "def run(cell, renderer, workdir):\n    cell.outputs = {'ran': 1}\n"
        "def check(cell, outputs, lowp=False, cache=None):\n"
        "    return {'ran': outputs['ran']}\n")
    (tmp_path / "portbench" / "metrics" / "dummy.metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    # a metric split by cell, with no file of its own: its quantity's
    (tmp_path / "portbench" / "metrics" / "quantity.py").write_text(
        "def read(run):\n    return 7.0\n")
    spec = {"configs": [{"name": "dummy",
                         "file": "portbench/configs/dummy.py"}],
            "workloads": [{"name": "dummy.tiny", "config": "dummy",
                           "traffic": "tiny", "chips": 1}],
            "end_to_end": [{"name": "dummy.metric",
                            "workloads": ["dummy.tiny"]}],
            "per_layer": []}
    cell = bench_spec.workload(spec, "dummy.tiny")
    cfg = bench_spec.load_config(spec, cell["config"], root=tmp_path)
    assert cfg.NAME == "dummy"
    traffic = bench_spec.load_traffic(cell["traffic"],
                                      bench_dir=tmp_path / "portbench")
    assert traffic["width"] == 4
    kind = bench_spec.load_kind(traffic["kind"],
                                bench_dir=tmp_path / "portbench")

    class FakeCell:
        outputs: dict = {}
    fake = FakeCell()
    kind.run(fake, None, tmp_path)
    assert kind.check(fake, fake.outputs) == {"ran": 1}
    names = [m["name"] for m in
             bench_spec.metrics_of(spec, "dummy.tiny", "end_to_end")]
    assert names == ["dummy.metric"]
    reader = bench_spec.load_metric("dummy.metric",
                                    bench_dir=tmp_path / "portbench")
    assert reader.read(None) == 42.0
    split = bench_spec.load_metric("quantity.video",
                                   bench_dir=tmp_path / "portbench")
    assert split.read(None) == 7.0


def test_missing_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        bench_spec.load_traffic("nope", bench_dir=tmp_path)
    with pytest.raises(FileNotFoundError):
        bench_spec.load_metric("nope", bench_dir=tmp_path)
    with pytest.raises(FileNotFoundError):
        bench_spec.load_metric("nope.video", bench_dir=tmp_path)
    with pytest.raises(FileNotFoundError):
        bench_spec.load_kind("nope", bench_dir=tmp_path)
    with pytest.raises(KeyError):
        bench_spec.workload({"workloads": []}, "nope")
