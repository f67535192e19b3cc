"""The plain reference against the port's film of a tiny scene, both on the
CPU, computed independently: the reference rebuilds the scene from the
recorded inputs with its own copies and traces by brute force."""

import numpy as np
import pytest
import torch

from portbench.lib import spec as bench_spec
from portbench.lib.namespaces import port_namespace
from portbench.lib.scenecache import replay, scene_inputs
from portbench.reference.compare import mismatch_pct
from portbench.reference.render import ReferenceScene


def _port_film(cfg, calls, width, height, first, samples, dts=()):
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run.renderer import Renderer
    ns = port_namespace()
    b = ns.SceneBuilder(cfg.NAME)
    replay(calls, b, ns)
    scene = b.create_scene()
    r = Renderer(settings=PathTracingSettings(**cfg.SETTINGS), device="cpu")
    r.set_scene(scene, stream_textures=False)
    r.on_resize(width, height)
    for dt in dts:
        r.update_scene_data(scene_changed=scene.update(dt))
    r.total_samples = first
    for _ in range(samples):
        r.render(1)
    return r.accum.numpy()


@pytest.mark.parametrize("config, params, dts", [
    ("heightfield_anim", {"n": 16}, (5 / 24, 1 / 24)),
    ("courtyard", {"detail": 0.1, "tex_scale": 0.0625}, ())])
def test_reference_film_matches_the_port(config, params, dts, tmp_path):
    spec = bench_spec.load_spec()
    cfg = bench_spec.load_config(spec, config)
    calls, _ = scene_inputs(cfg, params, port_namespace(), root=tmp_path)
    w, h, first, n = 12, 8, 1234, 2
    film = _port_film(cfg, calls, w, h, first, n, dts)
    ref = ReferenceScene(calls, cfg.NAME, cfg.SETTINGS, "cpu")
    ref.advance(dts)
    ys, xs = np.divmod(np.arange(w * h), w)
    mine = ref.film(xs, ys, range(first, first + n), w, h)
    assert mismatch_pct(film[ys, xs] / n, mine / n) == 0.0
    # the control (bfloat16 storage) disagrees on most pixels
    low = ReferenceScene(calls, cfg.NAME, cfg.SETTINGS, "cpu", lowp=True)
    low.advance(dts)
    assert mismatch_pct(film[ys, xs] / n,
                        low.film(xs, ys, range(first, first + n), w, h)
                        / n) > 20.0


def test_post_matches_the_port():
    from pt_torch.post.pipeline import PostProcessSettings, postprocess
    g = torch.Generator().manual_seed(3)
    film = torch.rand((24, 32, 3), generator=g) * 4.0
    port = postprocess(film, 2.0, PostProcessSettings()).numpy()
    ref = ReferenceScene.post(type("R", (), {"lowp": False})(), film, 2)
    assert np.array_equal(port, ref)


def test_scene_inputs_are_cached_and_replayed_alike(tmp_path):
    spec = bench_spec.load_spec()
    cfg = bench_spec.load_config(spec, "heightfield_anim")
    first, cached = scene_inputs(cfg, {"n": 8}, port_namespace(),
                                 root=tmp_path)
    again, hit = scene_inputs(cfg, {"n": 8}, port_namespace(),
                              root=tmp_path)
    assert not cached and hit
    assert [c[0] for c in first] == [c[0] for c in again]
    assert len(list(tmp_path.iterdir())) == 1
