"""The port's command line and application shell against `pt` on the CPU.

* `python -m pt_torch.run.cli render --scene "Test Scenes/Default" --size
  32x32 --spp 2 --bounces 3 --device cpu` writes a PNG whose image, and an
  HDR whose film, are within MSE 1e-3 (the project's film contract) of
  `pt`'s application path on its brute backend. `pt`'s app streams its
  textures; its side waits for them first (`wait_for_textures`), or a
  short render would be shaded with the placeholder pool.
* `list-scenes` prints what `pt`'s prints.
* Without `--device` the render takes the card: on a host without one it
  exits non-zero and writes nothing. Every option that a later item of the
  port's queue brings exits non-zero and names that item. `--adaptive` and
  `--adaptive-mse` render the adaptive film with `pt`'s arguments.
  `render --backend brute|pallas`, `render --hdr`, `debug` and `stats` run
  on `--device cpu` and write their file or print their board.
* `Application`: the boot scene, the device it hands its `Renderer`, and
  the scene-import and rendering counters.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from pt.post.pipeline import PostProcessSettings as JPost
from pt.render.integrator import PathTracingSettings as JSettings
from pt.run import cli as jcli
from pt.run.app import Application as JApplication
from pt.run.offline import RenderSettings as JRenderSettings
from pt.out.saver import OutputInfo as JOutputInfo
from pt_torch.run import cli
from pt_torch.run.app import Application, BackgroundTasks
from pt_torch.scene.textures import decode_png, read_radiance_hdr

FILM_MSE = 1e-3


def _main(argv):
    """cli.main(argv) → (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def pt_default_32(tmp_path_factory):
    """`pt`'s application path for the Default scene at 32², 2 spp, 3
    bounces: (film mean, the PNG's pixels in [0, 1])."""
    png = tmp_path_factory.mktemp("pt_app") / "pt.png"
    app = JApplication()
    app.init("Test Scenes", "Default", 32, 32)
    app.renderer.wait_for_textures()
    frames = app.render_offline(
        JRenderSettings(output=JOutputInfo(str(png), 32, 32, 30.0, "png"),
                        max_sample_count=2),
        JSettings(sample_count=1, bounce_count=3, backend="brute"), JPost())
    assert frames == 1 and app.renderer.total_samples == 2
    film = app.renderer.film_mean()
    app.shutdown()
    return film, decode_png(png.read_bytes())[..., :3] / 255.0


def test_cli_render_png_and_hdr_match_pt_app(tmp_path, pt_default_32):
    film, image = pt_default_32
    base = ["render", "--scene", "Test Scenes/Default", "--size", "32x32",
            "--spp", "2", "--bounces", "3", "--device", "cpu"]
    png = tmp_path / "port.png"
    rc, _, err = _main(base + ["--out", str(png)])
    assert rc == 0, err
    assert "wrote 1 frame(s)" in err and "on cpu" in err
    got = decode_png(png.read_bytes())
    assert got.shape == (32, 32, 4)
    mse = float(np.mean((got[..., :3] / 255.0 - image) ** 2))
    assert mse < FILM_MSE, mse
    hdr = tmp_path / "port.hdr"
    rc, _, err = _main(base + ["--format", "hdr", "--out", str(hdr)])
    assert rc == 0, err
    port_film = read_radiance_hdr(hdr.read_bytes())
    assert port_film.shape == (32, 32, 3) and port_film.max() > 0
    mse = float(np.mean((port_film - film) ** 2))
    assert mse < FILM_MSE, mse


def test_cli_list_scenes_matches_pt():
    rc, out, _ = _main(["list-scenes"])
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        assert jcli.main(["list-scenes"]) == 0
    assert rc == 0 and out == jout.getvalue()
    assert out.splitlines()[0] == "Test Scenes"
    assert [line.strip() for line in out.splitlines()[1:]] == [
        f"Test Scenes/{n}" for n in (
            "Default", "MetallicRoughness Cubes", "Roughness Test Cubes",
            "Heightfield", "Reuse Mesh", "Courtyard", "Courtyard Flythrough")]


def test_cli_parser_keeps_pts_flags_and_defaults():
    """Every command of `pt`'s parser is there. `list-scenes`, `render`,
    `debug`, `stats` and `view` have each of `pt`'s options with `pt`'s
    default; `render`, `debug`, `stats` and `view` add `--device`."""
    def options(parser):
        sub = next(a for a in parser._actions
                   if a.dest == "command").choices
        return {name: {a.dest: a.default for a in p._actions
                       if a.dest != "help"} for name, p in sub.items()}
    got, want = options(cli.build_parser()), options(jcli.build_parser())
    assert got.keys() == want.keys()
    assert not hasattr(cli, "DEFERRED_COMMANDS")
    for name in ("render", "debug", "stats", "view"):
        assert got[name].pop("device") is None
    assert got["render"]["backend"] == got["view"]["backend"] == "pallas"
    assert got == want


def test_cli_without_device_needs_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.png"
    rc, _, err = _main(["render", "--size", "8x8", "--spp", "1",
                        "--bounces", "1", "--out", str(out)])
    assert rc != 0 and "no CUDA device" in err and "--device cpu" in err
    assert not out.exists()


_SMALL = ["--size", "8x8", "--spp", "1", "--bounces", "1"]


@pytest.mark.parametrize("argv, item", [
    (["render", "--backend", "bvh", "--device", "cpu", *_SMALL], 7),
    (["render", "--format", "mp4", "--device", "cpu", *_SMALL], 5),
    (["render", "--format", "tga", "--device", "cpu", *_SMALL], 5),
    (["render", "--out", "frame.jpg", "--device", "cpu", *_SMALL], 5),
    (["render", "--scene", "scene.gltf", "--device", "cpu"], 6),
    (["render", "--scene", "scene.obj", "--device", "cpu"], 6),
    (["render", "--scene", "scene.fbx", "--device", "cpu"], 6),
    (["debug", "--out", "d.jpg", "--device", "cpu", "--size", "8x8"], 5),
    (["debug", "--scene", "scene.glb", "--device", "cpu"], 6),
    (["view"], 8),
    # port 0 takes a free one; the id is the one this case has always had
    pytest.param(["view", "--port", "0", "--duration", "0.5", "--size",
                  "8x8", "--bounces", "1", "--device", "cpu"], 8,
                 id="view_--port_9000"),
    (["-A", "Assets", "list-scenes"], 6),
    (["-S", "Scenes", "render", "--device", "cpu"], 6),
], ids=lambda v: v if isinstance(v, int) else "_".join(v[:3]))
def test_cli_deferred_options_name_their_queue_item(tmp_path, monkeypatch,
                                                    argv, item):
    """The options of queue 1, items 5 to 8, all ported. Item 7:
    `--backend bvh` renders. Item 8: `view` serves the viewer for
    `--duration` seconds, and without `--device` on a host with no card
    exits 2 as the other commands do. Items 5 and 6: mp4 (the MJPEG AVI
    where there is no ffmpeg), tga and jpg files are written; a scene file
    that does not exist exits 2 as in `pt`, and so does an `-A`/`-S` path
    that is not a directory."""
    from pt_torch.out import saver
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(saver, "ffmpeg_available", lambda: False)
    if argv[0] == "view" and "--device" not in argv:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _main(argv)
    if item == 8:
        if "--device" in argv:
            assert rc == 0, err
            assert re.search(r"viewer at http://127\.0\.0\.1:\d+/", out), out
        else:
            assert rc == 2 and "no CUDA device" in err, err
        assert not list(tmp_path.iterdir())
    elif "--scene" in argv:
        assert rc == 2 and "scene file not found" in err, err
        assert not list(tmp_path.iterdir())
    elif argv[0] in ("-A", "-S"):
        assert rc == 2 and "is not a directory" in err, err
    else:
        assert rc == 0, err
        written = {"mp4": "render.avi", "tga": "render.png",
                   "frame.jpg": "frame.jpg", "d.jpg": "d.jpg",
                   "bvh": "render.png"}[argv[2]]
        assert [p.name for p in tmp_path.iterdir()] == [written]


def _pixels(path):
    image = decode_png(path.read_bytes())
    assert image[..., :3].max() > 0
    return image


@pytest.mark.parametrize("argv, check", [
    (["render", "--backend", "brute", "--size", "16x16", "--spp", "1",
      "--bounces", "2", "--out", "b.png"],
     lambda d, out: _pixels(d / "b.png").shape == (16, 16, 4)),
    (["render", "--backend", "pallas", "--size", "16x16", "--spp", "1",
      "--bounces", "2", "--out", "p.png"],
     lambda d, out: _pixels(d / "p.png").shape == (16, 16, 4)),
    (["render", "--hdr", "--size", "16x16", "--spp", "1", "--bounces", "2",
      "--out", "h.png"],
     lambda d, out: _pixels(d / "h.png").shape == (16, 16, 4)),
    (["debug", "--size", "24x16"],
     lambda d, out: _pixels(d / "debug.png").shape == (16, 24, 4)),
    (["debug", "--mode", "geometry", "--size", "8x8", "--force-opaque",
      "--cull-backfaces", "--disable-color-texture", "--disable-shadows",
      "--out", "g.png"],
     lambda d, out: _pixels(d / "g.png").shape == (8, 8, 4)),
    (["stats"],
     lambda d, out: {"Render", "Total Samples", "Samples Per Frame",
                     "Frame total"} <= {line.split(": ")[0]
                                        for line in out.splitlines()}),
], ids=lambda v: "_".join(v[:3]) if isinstance(v, list) else "")
def test_cli_item4_commands_run(tmp_path, monkeypatch, argv, check):
    """`render --backend brute|pallas`, `render --hdr`, `debug` (with every
    flag) and `stats` on the CPU: exit code 0 and the file or the board.
    PyTorch runs on one thread here (`stats` renders 256², and the suite's
    other test processes contend for the same cores)."""
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc, out, err = _main(argv + ["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    assert rc == 0, err
    assert check(tmp_path, out)


@pytest.mark.parametrize("flag, value, tol, target_mse", [
    ("--adaptive", "0.05", 0.05, None),
    ("--adaptive-mse", "1e-3", 5e-3, 1e-3),
])
def test_cli_adaptive_flags_render_the_adaptive_film(tmp_path, monkeypatch,
                                                      flag, value, tol,
                                                      target_mse):
    """`pt`'s rules (`pt/run/offline.py:111-118`): the flag's stopping
    rule, --spp as the per-pixel cap, min_spp = min(16, --spp), --max-time
    as the time budget; the PNG is written from the adaptive film."""
    from pt_torch.run.renderer import Renderer
    calls = []
    real = Renderer.render_adaptive

    def spy(self, **kw):
        calls.append(kw)
        return real(self, **kw)
    monkeypatch.setattr(Renderer, "render_adaptive", spy)
    png = tmp_path / "a.png"
    rc, _, err = _main(["render", "--size", "16x16", "--spp", "8",
                        "--bounces", "2", "--max-time", "600", flag, value,
                        "--device", "cpu", "--out", str(png)])
    assert rc == 0, err
    assert calls == [dict(tol=tol, target_mse=target_mse, max_spp=8,
                          min_spp=8, max_seconds=600.0)]
    image = decode_png(png.read_bytes())
    assert image.shape == (16, 16, 4) and image[..., :3].max() > 0


def test_cli_rejects_unknown_format_and_scene_name(tmp_path):
    rc, _, err = _main(["render", "--out", str(tmp_path / "x.bmp"),
                        "--device", "cpu"])
    assert rc != 0 and "unsupported output format 'bmp'" in err
    rc, _, err = _main(["render", "--scene", "Default", "--device", "cpu"])
    assert rc != 0 and "Group/Name" in err


def test_application_boots_and_renders_offline(tmp_path):
    from pt_torch.out.saver import OutputInfo
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run.offline import RenderSettings
    app = Application(device="cpu")
    assert app.renderer.device == torch.device("cpu")
    app.init(width=16, height=12)
    assert app.renderer.scene.name == "Default"
    assert app.renderer.accum.shape == (12, 16, 3)
    app.set_scene("Test Scenes", "Roughness Test Cubes")
    assert app.renderer.scene.name == "Roughness Test Cubes"
    assert app.tasks.progress("SceneImport") == (2, 1)   # + the callback
    seen = []
    frames = app.render_offline(
        RenderSettings(output=OutputInfo(str(tmp_path / "a.png"), 16, 12),
                       max_sample_count=2, samples_per_step=1),
        PathTracingSettings(bounce_count=2),
        progress=lambda f, t, s: seen.append(s))
    assert frames == 1 and seen == [1, 2]
    assert app.tasks.progress("Rendering") == (1, 1)
    assert decode_png((tmp_path / "a.png").read_bytes()).shape == (12, 16, 4)
    app.shutdown()


def test_application_takes_the_card_by_default():
    if torch.cuda.is_available():
        assert Application().renderer.device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Application()


def test_background_tasks_count_like_pt():
    from pt.run.app import BackgroundTasks as JTasks
    ours, theirs = BackgroundTasks(), JTasks()
    assert set(ours.TYPES) <= set(theirs.TYPES)
    for t in (ours, theirs):
        t.begin("Rendering", 5)
        t.advance("Rendering")
        t.advance("Rendering", 2)
        t.set_progress("SceneImport", 4)
    for task in ours.TYPES:
        assert ours.progress(task) == theirs.progress(task)
    assert ours.progress("Rendering") == (3, 5)


def test_cli_rejects_unknown_options():
    """Only the bare command of a later item takes what follows it
    unparsed: an unknown option of `render`, `list-scenes`, `debug` or
    `stats` is an error."""
    for argv in (["render", "--bogus", "--device", "cpu"],
                 ["list-scenes", "--mode", "normal"],
                 ["debug", "--bogus", "--device", "cpu"],
                 ["stats", "--mode", "normal", "--device", "cpu"]):
        with pytest.raises(SystemExit) as exc:
            _main(argv)
        assert exc.value.code == 2
