"""The port's live viewer, input shim and fly-camera polling, on the CPU:
the counterparts of `tests/test_viewer.py`'s 21 cases, each bound to a
loopback port with the renderer on `device="cpu"` (brute force, as `pt`'s
suite runs), and one scripted key/mouse sequence whose camera poses are
bit-equal to `pt`'s.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from pt.core.camera import InputCamera as JInputCamera
from pt.core.input import Input as JInput
from pt_torch.core.camera import InputCamera
from pt_torch.core.input import Input

from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_input():
    yield
    for inp in (Input, JInput):
        inp.set_key_release_callback(None)
        for k in ("w", "a", "s", "d", "q", "e", "p", "h", "space"):
            inp.set_key(k, False)
        inp.set_mouse_button(1, False)
        inp.consume_mouse_delta()
        inp.set_ui_focused(False)


def _script():
    """One scripted key and mouse sequence: (keys held, right button,
    mouse delta, dt) per frame, with a stale delta before the button and a
    delta past the ±250 px clamp."""
    return [({"w"}, False, (0.0, 0.0), 1 / 60.0),
            ({"w", "d"}, False, (40.0, 0.0), 1 / 30.0),   # dropped: no RMB
            (set(), True, (12.5, -7.25), 1 / 60.0),
            ({"q", "a"}, True, (400.0, -300.0), 1 / 45.0),  # clamped
            ({"s", "e"}, True, (-3.0, 2.0), 1 / 60.0),
            ({"w", "s"}, False, (0.0, 0.0), 1 / 60.0),    # cancels
            (set(), True, (0.0, 0.0), 1 / 60.0)]


def test_input_camera_poses_equal_pts():
    """`Input` + `InputCamera.on_update` against `pt`'s on one scripted
    sequence: every frame's changed flag, position, direction and view
    matrix bit-equal."""
    cams = [InputCamera(45.0, 0.1, 100.0, (1.0, 2.0, -5.0), (0.3, -0.2, 0.9)),
            JInputCamera(45.0, 0.1, 100.0, (1.0, 2.0, -5.0),
                         (0.3, -0.2, 0.9))]
    for cam in cams:
        cam.on_resize(64, 48)
    for keys, rmb, (dx, dy), dt in _script():
        out = []
        for inp, cam in zip((Input, JInput), cams):
            for k in "wasdqe":
                inp.set_key(k, k in keys)
            inp.set_mouse_button(1, rmb)
            inp.add_mouse_delta(dx, dy)
            out.append((cam.on_update(dt), cam.position.copy(),
                        cam.direction.copy(), cam.inv_view.copy()))
        assert out[0][0] == out[1][0]
        for a, b in zip(out[0][1:], out[1][1:]):
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(cams[0].position, (1.0, 2.0, -5.0))


def test_input_shim_state_equals_pts():
    """The shim's state and callbacks behave as `pt`'s for the same calls."""
    seen = {Input: [], JInput: []}
    for inp in (Input, JInput):
        inp.set_key_release_callback(seen[inp].append)
        inp.set_key("h", True)
        inp.set_key("h", False)
        inp.set_key("x", False)                 # never pressed: no release
        inp.set_mouse_position(3.0, 4.0)
        inp.add_mouse_delta(1.5, 2.0)
        inp.add_mouse_delta(-0.5, 1.0)
        inp.set_ui_focused(True)
        inp.set_key("w", True)
    assert seen[Input] == seen[JInput] == ["h"]
    for name, args in (("is_key_pressed", ("w",)),
                       ("is_mouse_button_pressed", (1,)),
                       ("get_mouse_position", ()),
                       ("consume_mouse_delta", ()),
                       ("consume_mouse_delta", ())):
        assert getattr(Input, name)(*args) == getattr(JInput, name)(*args)
    for inp in (Input, JInput):
        inp.set_ui_focused(False)
    assert Input.is_key_pressed("w") and JInput.is_key_pressed("w")


def make_cam():
    cam = InputCamera(45.0, 0.1, 100.0, (0.0, 0.0, -5.0), (0.0, 0.0, 1.0))
    cam.on_resize(64, 64)
    return cam


class TestInputCameraPolling:
    def test_idle_no_change(self):
        cam = make_cam()
        assert cam.on_update(1 / 60.0) is False

    def test_wasd_moves(self):
        cam = make_cam()
        p0 = cam.position.copy()
        Input.set_key("w", True)
        assert cam.on_update(1 / 60.0) is True
        Input.set_key("w", False)
        moved = cam.position - p0
        # forward along +Z view direction
        assert moved[2] > 0 and abs(moved[0]) < 1e-12

    def test_mouse_look_requires_rmb(self):
        cam = make_cam()
        d0 = cam.direction.copy()
        Input.add_mouse_delta(50.0, 0.0)
        assert cam.on_update(1 / 60.0) is False      # no RMB: deltas dropped
        Input.set_mouse_button(1, True)
        Input.add_mouse_delta(50.0, 0.0)
        assert cam.on_update(1 / 60.0) is True
        assert not np.allclose(cam.direction, d0)

    def test_ui_focus_suppresses(self):
        cam = make_cam()
        Input.set_key("w", True)
        Input.set_ui_focused(True)
        assert cam.on_update(1 / 60.0) is False

    def test_key_release_callback(self):
        seen = []
        Input.set_key_release_callback(seen.append)
        Input.set_key("p", True)
        Input.set_key("p", False)
        assert seen == ["p"]

    def test_space_release_reaches_callback(self):
        # ≙ UserInterface::OnKeyRelease Key::Space (HUD show/hide)
        seen = []
        Input.set_key_release_callback(seen.append)
        Input.set_key("space", True)
        Input.set_key("space", False)
        assert seen == ["space"]

    def test_page_advertises_space_binding(self):
        from pt_torch.run.viewer import _PAGE
        assert "space" in _PAGE.lower()


class TestScene_UpdateSplit:
    def test_camera_only_change(self):
        from pt_torch.scene.examples import make_default_scene
        scene = make_default_scene()
        cam_changed, anim_changed = scene.update_split(1 / 60.0)
        assert (cam_changed, anim_changed) == (False, False)
        Input.set_key("w", True)
        cam_changed, anim_changed = scene.update_split(1 / 60.0)
        assert cam_changed is True and anim_changed is False


class TestViewerServer:
    def test_endpoints_and_input_round_trip(self):
        from pt_torch.run.viewer import ViewerServer
        server = ViewerServer(port=0)          # ephemeral port
        server.start()
        base = f"http://{server.host}:{server.port}"
        try:
            page = urllib.request.urlopen(f"{base}/", timeout=5).read()
            assert b"/stream" in page

            server.publish(np.full((4, 4, 3), 0.5, np.float32),
                           {"total_samples": 7})
            jpeg = urllib.request.urlopen(f"{base}/frame", timeout=5).read()
            assert jpeg[:2] == b"\xff\xd8"     # JPEG SOI

            state = json.loads(urllib.request.urlopen(
                f"{base}/state", timeout=5).read())
            assert state["total_samples"] == 7

            events = {"events": [
                {"type": "key", "key": "w", "pressed": True},
                {"type": "button", "button": 1, "pressed": True},
                {"type": "move", "dx": 3.0, "dy": -2.0}]}
            req = urllib.request.Request(f"{base}/input",
                                         data=json.dumps(events).encode(),
                                         method="POST")
            assert urllib.request.urlopen(req, timeout=5).status == 204
            assert Input.is_key_pressed("w")
            assert Input.is_mouse_button_pressed(1)
            assert Input.consume_mouse_delta() == (3.0, -2.0)
        finally:
            server.stop()

    def test_run_viewer_end_to_end(self):
        """Drive the full loop: app renders frames into the server while
        posted input flies the camera (interactive fly-through)."""
        from pt_torch.render.integrator import PathTracingSettings
        from pt_torch.run.app import Application
        from pt_torch.run.viewer import run_viewer

        app = Application(device="cpu")
        app.init(width=32, height=32)
        app.renderer.set_settings(PathTracingSettings(
            sample_count=1, bounce_count=2, backend="brute"))
        cam = app.renderer.scene.cameras[0]
        p0 = cam.position.copy()

        Input.set_key("w", True)      # held for the whole fly-through
        frames = run_viewer(app, port=0, duration_seconds=0.5)
        Input.set_key("w", False)
        assert frames >= 1
        assert not np.array_equal(cam.position, p0)  # camera flew forward

    def test_run_viewer_adaptive_refinement(self):
        """`pt view --adaptive`: the loop refines through the adaptive
        film (per-pixel counts populate); a camera move resets them."""
        from pt_torch.render.integrator import PathTracingSettings
        from pt_torch.run.app import Application
        from pt_torch.run.viewer import run_viewer

        app = Application(device="cpu")
        app.init(width=32, height=32)
        app.renderer.set_settings(PathTracingSettings(
            sample_count=1, bounce_count=2, backend="brute"))
        frames = run_viewer(app, port=0, duration_seconds=0.5,
                            adaptive_tol=0.1)
        assert frames >= 1
        r = app.renderer
        assert r._spp_map is not None and r._spp_map.min() >= 1
        r.reset_accumulation()
        assert r._spp_map is None          # move/reset clears the film


class TestSceneSwitch:
    def test_scene_endpoints(self):
        from pt_torch.run.viewer import ViewerServer
        picked = []
        server = ViewerServer(port=0, scenes=["A/B", "C/D"],
                              on_scene_select=picked.append)
        server.start()
        base = f"http://{server.host}:{server.port}"
        try:
            data = json.loads(
                urllib.request.urlopen(f"{base}/scenes", timeout=5).read())
            assert data["scenes"] == ["A/B", "C/D"]
            req = urllib.request.Request(
                f"{base}/scene", data=json.dumps({"scene": "C/D"}).encode(),
                method="POST")
            assert urllib.request.urlopen(req, timeout=5).status == 204
            assert picked == ["C/D"]
            bad = urllib.request.Request(
                f"{base}/scene", data=json.dumps({"scene": "nope"}).encode(),
                method="POST")
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(bad, timeout=5)
        finally:
            server.stop()

    def test_live_scene_switch_applies_between_frames(self):
        """POST /scene mid-session swaps the active scene on the render
        loop thread (≙ the UI Scenes tab → SetActiveScene,
        UserInterface.cpp:253-275)."""
        import threading
        import time as _time

        from pt_torch.render.integrator import PathTracingSettings
        from pt_torch.run.app import Application
        from pt_torch.run.viewer import run_viewer

        app = Application(device="cpu")
        app.renderer.set_settings(PathTracingSettings(
            sample_count=1, bounce_count=2, backend="brute"))
        app.init(width=24, height=24)
        assert app.renderer.scene.name == "Default"

        holder = {}

        def poke():
            # wait for the server port to be known, then switch scenes
            while "base" not in holder:
                _time.sleep(0.02)
            req = urllib.request.Request(
                holder["base"] + "/scene",
                data=json.dumps({"scene": "Test Scenes/Reuse Mesh"}).encode(),
                method="POST")
            urllib.request.urlopen(req, timeout=5)

        t = threading.Thread(target=poke, daemon=True)

        import pt_torch.run.viewer as V
        orig = V.ViewerServer

        class Hooked(orig):
            def start(self):
                super().start()
                holder["base"] = f"http://{self.host}:{self.port}"
                t.start()

        V.ViewerServer = Hooked
        try:
            run_viewer(app, port=0, duration_seconds=3.0, show_hud=False)
        finally:
            V.ViewerServer = orig
        assert app.renderer.scene.name == "Reuse Mesh"


class TestLiveSettings:
    def test_settings_endpoint(self):
        from pt_torch.run.viewer import ViewerServer
        got = []
        server = ViewerServer(port=0, on_settings=got.append)
        server.start()
        base = f"http://{server.host}:{server.port}"
        try:
            req = urllib.request.Request(
                f"{base}/settings",
                data=json.dumps({"bounce_count": 3,
                                 "exposure": 2.0}).encode(),
                method="POST")
            assert urllib.request.urlopen(req, timeout=5).status == 204
            assert got == [{"bounce_count": 3, "exposure": 2.0}]
        finally:
            server.stop()

    def test_apply_settings_maps_both_dataclasses(self):
        from pt_torch.render.integrator import PathTracingSettings
        from pt_torch.run.app import Application
        from pt_torch.run.viewer import apply_settings

        app = Application(device="cpu")
        app.renderer.set_settings(PathTracingSettings(
            sample_count=1, bounce_count=2, backend="brute"))
        apply_settings(app, {"bounce_count": 4, "exposure": 2.5,
                             "enable_bloom": False, "unknown_key": 9})
        assert app.renderer.settings.bounce_count == 4
        assert app.renderer.settings.backend == "brute"   # untouched
        assert app.renderer.post.exposure == 2.5
        assert app.renderer.post.enable_bloom is False


class TestUserSceneLoad:
    def test_post_path_loads_user_scene(self, tmp_path):
        """POST /scene {"path": file} loads an arbitrary file as 'User
        Scene' (≙ the file-dialog open flow, UserInterface.cpp:768)."""
        import threading
        import time as _time

        from pt_torch.render.integrator import PathTracingSettings
        from pt_torch.run.app import Application
        from pt_torch.run.viewer import run_viewer
        from pt_torch.scene.examples import make_roughness_test_scene
        from pt_torch.scene.gltf_export import export_glb

        glb = str(tmp_path / "user.glb")
        export_glb(make_roughness_test_scene(), glb)

        app = Application(device="cpu")
        app.renderer.set_settings(PathTracingSettings(
            sample_count=1, bounce_count=2, backend="brute"))
        app.init(width=24, height=24)

        holder = {}

        def poke():
            while "base" not in holder:
                _time.sleep(0.02)
            req = urllib.request.Request(
                holder["base"] + "/scene",
                data=json.dumps({"path": glb}).encode(), method="POST")
            urllib.request.urlopen(req, timeout=5)

        t = threading.Thread(target=poke, daemon=True)
        import pt_torch.run.viewer as V
        orig = V.ViewerServer

        class Hooked(orig):
            def start(self):
                super().start()
                holder["base"] = f"http://{self.host}:{self.port}"
                t.start()

        V.ViewerServer = Hooked
        try:
            run_viewer(app, port=0, duration_seconds=3.0, show_hud=False)
        finally:
            V.ViewerServer = orig
        assert app.renderer.scene.name == "User Scene"
        assert "User Scene" in app.scene_manager.groups["User Scenes"]


class TestDebugAndCameraControls:
    """Round-3 viewer control-surface parity (VERDICT round-2 task 5):
    live DoF, debug mode + flags, camera index, offline-render trigger
    (≙ UserInterface.cpp:1294-1313, 1700-1764, 774-1212)."""

    def _app(self):
        from pt_torch.render.integrator import PathTracingSettings
        from pt_torch.run.app import Application
        app = Application(device="cpu")
        app.renderer.set_settings(PathTracingSettings(
            sample_count=1, bounce_count=2, backend="brute"))
        app.init(width=16, height=16)
        return app

    def test_apply_settings_debug_camera_dof(self):
        from pt_torch.render.debug import DebugRenderMode
        from pt_torch.run.viewer import apply_settings
        app = self._app()
        apply_settings(app, {"debug_mode": "normal",
                             "debug_flags": {"disable_shadows": True,
                                             "bogus_flag": 1}})
        assert app.debug_mode == DebugRenderMode.NORMAL
        assert app.debug_flags.disable_shadows is True
        apply_settings(app, {"debug_mode": 4})
        assert app.debug_mode == DebugRenderMode.MIPS
        apply_settings(app, {"debug_mode": "off"})
        assert app.debug_mode is None
        with pytest.raises(ValueError):
            apply_settings(app, {"debug_mode": "nonsense"})
        with pytest.raises(ValueError):
            apply_settings(app, {"camera_index": 7})
        apply_settings(app, {"camera_index": 0})
        assert app.renderer.camera_index == 0
        # live DoF (lens radius / focal distance sliders)
        apply_settings(app, {"lens_radius": 0.05, "focal_distance": 2.5})
        assert app.renderer.settings.lens_radius == 0.05
        assert app.renderer.settings.focal_distance == 2.5

    def test_all_debug_modes_render_live(self):
        """Drive all 8 debug modes through the run loop (the round-3
        'done' criterion)."""
        from pt_torch.render.debug import DebugRenderMode
        app = self._app()
        frames = []
        for mode in DebugRenderMode:
            app.debug_mode = mode
            app.run(target_frames=1,
                    on_frame=lambda s, t: frames.append(np.asarray(s)))
        assert len(frames) == len(DebugRenderMode) == 8
        for f in frames:
            assert f.shape == (16, 16, 3)
            assert np.isfinite(f).all()
        # debug frames replace the film; accumulation must not advance
        app.debug_mode = None

    def test_render_endpoint(self, tmp_path):
        from pt_torch.run.viewer import ViewerServer
        got = []
        server = ViewerServer(port=0, on_render=got.append,
                              render_dir=str(tmp_path))
        server.start()
        base = f"http://{server.host}:{server.port}"
        try:
            req = urllib.request.Request(
                f"{base}/render", data=json.dumps({}).encode(),
                method="POST")
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(req, timeout=5)   # no path → 400
            req = urllib.request.Request(
                f"{base}/render",
                data=json.dumps({"path": str(tmp_path / "out.png"),
                                 "max_samples": 4}).encode(),
                method="POST")
            assert urllib.request.urlopen(req, timeout=5).status == 204
            assert got == [{"path": str(tmp_path / "out.png"),
                            "max_samples": 4}]
            # a path escaping the render dir is rejected (400), and the
            # sink never sees it
            req = urllib.request.Request(
                f"{base}/render",
                data=json.dumps({"path": "../etc/evil.png"}).encode(),
                method="POST")
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(req, timeout=5)
            assert exc.value.code == 400
            # a cross-site Origin is rejected (403) on every mutating
            # endpoint before the body is interpreted
            req = urllib.request.Request(
                f"{base}/render",
                data=json.dumps({"path": str(tmp_path / "out.png")}).encode(),
                headers={"Origin": "http://evil.example"},
                method="POST")
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(req, timeout=5)
            assert exc.value.code == 403
            assert len(got) == 1
        finally:
            server.stop()

    def test_offline_trigger_end_to_end(self, tmp_path):
        """POST /render produces a file through the loop thread."""
        import threading
        import time as _time

        import pt_torch.run.viewer as V
        from pt_torch.run.viewer import run_viewer

        app = self._app()
        out = str(tmp_path / "shot.png")
        holder = {}

        def poke():
            while "base" not in holder:
                _time.sleep(0.02)
            req = urllib.request.Request(
                holder["base"] + "/render",
                data=json.dumps({"path": out, "max_samples": 2}).encode(),
                method="POST")
            urllib.request.urlopen(req, timeout=5)

        t = threading.Thread(target=poke, daemon=True)
        orig = V.ViewerServer

        class Hooked(orig):
            def start(self):
                super().start()
                holder["base"] = f"http://{self.host}:{self.port}"
                t.start()

        V.ViewerServer = Hooked
        try:
            run_viewer(app, port=0, duration_seconds=4.0, show_hud=False,
                       render_dir=str(tmp_path))
        finally:
            V.ViewerServer = orig
        import pathlib
        assert pathlib.Path(out).exists()


@pytest.fixture
def restore_reloaded_modules():
    """Give back, after the test, the module contents `reload_shaders`
    replaced, so that later tests in this process see the classes their
    modules imported."""
    import importlib
    names = [f"pt_torch.render.{m}" for m in (
        "shading", "rng", "rays", "sampling", "bsdf", "materials",
        "differentials", "textures", "integrator")]
    names += ["pt_torch.post.pipeline", "pt_torch.run.renderer"]
    mods = [importlib.import_module(n) for n in names]
    saved = [dict(m.__dict__) for m in mods]
    yield
    for m, d in zip(mods, saved):
        m.__dict__.clear()
        m.__dict__.update(d)


@pytest.mark.usefixtures("restore_reloaded_modules")
class TestShaderHotReload:
    def test_reload_shaders_reverts_patches_and_renders(self):
        """Application.reload_shaders (H key; ≙ ReloadShaders,
        Renderer.cpp:756) re-imports the shading modules from disk —
        a monkeypatched constant reverts — and the renderer keeps
        working afterward with its state intact."""
        from pt_torch.render.integrator import PathTracingSettings
        from pt_torch.run.app import Application
        app = Application(device="cpu")
        app.renderer.set_settings(PathTracingSettings(
            sample_count=1, bounce_count=2, backend="brute"))
        app.init(width=16, height=16)
        app.renderer.render(1)

        import pt_torch.render.shading as shading
        orig_pi = shading.PI
        shading.PI = 999.0                 # simulated on-disk edit
        try:
            app.reload_shaders()
        finally:
            import pt_torch.render.shading as shading2
            assert shading2.PI == orig_pi  # reloaded from disk
        scene = app.renderer.scene
        assert app.renderer.scene is scene  # state survived
        app.renderer.render(1)              # fresh jits still render
        snap = app.renderer.snapshot()
        assert np.isfinite(snap).all()

    @pytest.mark.parametrize("backend", ["brute", "pallas", "bvh"])
    def test_reload_moves_the_renderer_and_counts(self, backend):
        """The live renderer moves onto the reloaded class, the film
        restarts, the accel built before the reload keeps tracing (its
        structure classes are not reloaded, or answer by attribute), and
        each re-imported module advances "ShaderCompilation"."""
        import sys

        from pt_torch.render.integrator import PathTracingSettings
        from pt_torch.run.app import Application
        app = Application(device="cpu")
        app.renderer.set_settings(PathTracingSettings(
            sample_count=1, bounce_count=2, backend=backend))
        app.init(width=16, height=16)
        app.renderer.render(1)
        accel = app.renderer.accel
        assert app.tasks.progress("ShaderCompilation") == (0, 0)
        app.reload_shaders()
        assert app.tasks.progress("ShaderCompilation") == (11, 11)
        assert type(app.renderer) is sys.modules[
            "pt_torch.run.renderer"].Renderer
        assert app.renderer.total_samples == 0
        assert app.renderer.accel is accel
        app.renderer.render(1)
        assert np.isfinite(app.renderer.snapshot()).all()


class TestBackgroundTasks:
    def test_counters_as_pt(self):
        """`pt`'s four counters; a frame of the loop on a streamed scene
        advances "SceneImport" (through the boot) and leaves
        "TextureUpload" untouched, as `pt` does."""
        from pt_torch.render.integrator import PathTracingSettings
        from pt_torch.run.app import Application
        app = Application(device="cpu")
        app.renderer.set_settings(PathTracingSettings(
            sample_count=1, bounce_count=1, backend="brute"))
        app.init(width=8, height=8)
        app.renderer.wait_for_textures()
        app.run(target_frames=1)
        assert app.tasks.progress("TextureUpload") == (0, 0)
        from pt.run.app import BackgroundTasks as JTasks
        assert app.tasks.TYPES == JTasks.TYPES
