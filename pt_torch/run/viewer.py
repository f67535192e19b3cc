"""Live browser viewer: MJPEG stream + WASD/mouse fly-camera input.

Port of `pt.run.viewer`, the headless stand-in for the reference's
interactive window and ImGui control surface (Window.cpp:17-143,
UserInterface.cpp:1214-1424): the progressive film streams to a browser as
multipart JPEG, and browser key/mouse events feed the
`pt_torch.core.input.Input` shim that `InputCamera.on_update` polls (≙
Core/Input.cpp:31-45, Core/Camera.cpp:82-137). The renderer runs on the
card by default (`Application(device=None)`), on the CPU when asked.

Controls (mirroring the reference): WASD move, Q/E down/up, hold the right
mouse button (or click to pointer-lock) to look around, P pauses animation,
H reloads the shader modules, Space shows/hides the HUD
(≙ UserInterface::OnKeyRelease, UserInterface.cpp:202-220).

Serves:
  GET  /         viewer page
  GET  /stream   multipart/x-mixed-replace MJPEG of the latest snapshot
  GET  /frame    single JPEG (poll fallback)
  GET  /state    JSON render stats
  GET  /scenes   JSON {"scenes": ["Group/Name", ...]} (≙ the UI scene tab)
  POST /input    JSON input events: {"events": [{"type": "key"|"button"|
                 "move", ...}]}
  POST /scene    JSON {"scene": "Group/Name"}, or {"path": file} to load a
                 scene file as "User Scenes/User Scene" (≙ the UI Scenes
                 tab + SetActiveScene, UserInterface.cpp:253-275,
                 1429-1452, and the file-dialog open flow,
                 UserInterface.cpp:768)
  POST /settings JSON with any field of PathTracingSettings or
                 PostProcessSettings, and camera_index, debug_mode,
                 debug_flags (≙ the UI Settings and Debug tabs →
                 Renderer::SetSettings, Renderer.cpp:825-852)
  POST /render   the offline-render trigger: JSON {path, format, width,
                 height, max_samples, max_time_s, frame_count, framerate};
                 the file lands inside `render_dir` (≙ the Render-button
                 modal, UserInterface.cpp:774-1212)

Scene, settings, reload and render requests are applied on the render-loop
thread between frames, so the renderer is never changed mid-frame. Pillow
is needed only by `_encode_jpeg`, as in `pt`; the HUD's logo is decoded and
scaled without it.
"""

from __future__ import annotations

import io
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from pt_torch.core.input import Input

log = logging.getLogger("pt_torch.viewer")

_PAGE = """<!doctype html>
<html><head><title>pt_torch viewer</title><style>
  body { margin:0; background:#111; color:#ccc; font:13px monospace;
         display:flex; flex-direction:column; align-items:center }
  #v { margin-top:8px; outline:none; image-rendering:auto }
  #hud { padding:6px }
</style></head><body>
<img id="v" src="/stream" tabindex="0" draggable="false">
<div id="hud">WASD move &middot; Q/E down/up &middot; hold RMB / click to
look &middot; P pause animation &middot; H reload shaders &middot;
Space show/hide HUD &middot;
<select id="scene"><option>loading scenes...</option></select></div>
<div id="ctl">
bounces <input id="bounces" type="number" min="1" max="16" value="5"
 style="width:3em">
lens <input id="lens_radius" type="number" min="0" step="0.01" value="0"
 style="width:4em">
focal <input id="focal_distance" type="number" min="0.01" step="0.1"
 value="1" style="width:4em">
exposure <input id="exposure" type="number" min="0" step="0.1" value="1"
 style="width:4em">
cam <select id="cam"><option value="0">0</option></select>
debug <select id="dbg">
  <option value="off">off</option><option>color</option>
  <option>world_position</option><option>normal</option>
  <option>tex_coords</option><option>mips</option><option>geometry</option>
  <option>primitive</option><option>instance</option></select>
<label><input id="force_opaque" type="checkbox">opaque</label>
<label><input id="cull_backfaces" type="checkbox">cull</label>
<label><input id="disable_color_texture" type="checkbox">no-tex</label>
<label><input id="disable_shadows" type="checkbox">no-shadow</label>
&middot; <input id="rpath" placeholder="render.png" style="width:8em">
<input id="rspp" type="number" value="256" style="width:4em">spp
<button id="rbtn">render</button>
</div>
<div id="stats"></div>
<script>
const sel = document.getElementById('scene');
fetch('/scenes').then(r => r.json()).then(d => {
  sel.innerHTML = '';
  for (const s of d.scenes) {
    const o = document.createElement('option');
    o.value = o.textContent = s;
    sel.appendChild(o);
  }
});
sel.addEventListener('change', () =>
  fetch('/scene', {method: 'POST',
                   body: JSON.stringify({scene: sel.value})}));
const send = obj =>
  fetch('/settings', {method: 'POST', body: JSON.stringify(obj)});
for (const id of ['bounces', 'lens_radius', 'focal_distance', 'exposure'])
  document.getElementById(id).addEventListener('change', e => {
    const key = id === 'bounces' ? 'bounce_count' : id;
    send({[key]: parseFloat(e.target.value)});
  });
document.getElementById('cam').addEventListener('change', e =>
  send({camera_index: parseInt(e.target.value)}));
const flagIds = ['force_opaque', 'cull_backfaces', 'disable_color_texture',
                 'disable_shadows'];
const sendDebug = () => {
  const flags = {};
  for (const f of flagIds) flags[f] = document.getElementById(f).checked;
  send({debug_mode: document.getElementById('dbg').value,
        debug_flags: flags});
};
document.getElementById('dbg').addEventListener('change', sendDebug);
for (const f of flagIds)
  document.getElementById(f).addEventListener('change', sendDebug);
document.getElementById('rbtn').addEventListener('click', () =>
  fetch('/render', {method: 'POST', body: JSON.stringify({
    path: document.getElementById('rpath').value || 'render.png',
    max_samples: parseInt(document.getElementById('rspp').value) || 256})}));
setInterval(() => fetch('/state').then(r => r.json()).then(s => {
  document.getElementById('stats').textContent =
    `${s.total_samples || 0} spp · ${((s.rays_traced || 0) / 1e6).toFixed(0)}` +
    ` Mrays · ${(s.size || []).join('x')} ${s.offline || ''}`;
  const cam = document.getElementById('cam');
  if (s.camera_count && cam.options.length !== s.camera_count) {
    cam.innerHTML = '';
    for (let i = 0; i < s.camera_count; i++) {
      const o = document.createElement('option');
      o.value = o.textContent = i;
      cam.appendChild(o);
    }
    cam.value = s.camera_index || 0;
  }
}), 1000);
for (const el of document.querySelectorAll('#ctl input, #ctl select, #scene')) {
  el.addEventListener('keydown', e => e.stopPropagation());
  el.addEventListener('keyup', e => e.stopPropagation());
}
const v = document.getElementById('v');
let queue = [];
function post(ev) {
  queue.push(ev);
}
setInterval(() => {
  if (!queue.length) return;
  const events = queue; queue = [];
  fetch('/input', {method: 'POST', body: JSON.stringify({events})});
}, 33);
const keys = 'wasdqeph';
const name = k => k === ' ' ? 'space' : k;
window.addEventListener('keydown', e => {
  const k = e.key.toLowerCase();
  if ((keys.includes(k) || k === ' ') && !e.repeat)
    post({type:'key', key:name(k), pressed:true});
});
window.addEventListener('keyup', e => {
  const k = e.key.toLowerCase();
  if (keys.includes(k) || k === ' ')
    post({type:'key', key:name(k), pressed:false});
});
v.addEventListener('mousedown', e => {
  if (e.button === 2) post({type:'button', button:1, pressed:true});
  else if (e.button === 0 && document.pointerLockElement !== v)
    v.requestPointerLock();
});
window.addEventListener('mouseup', e => {
  if (e.button === 2) post({type:'button', button:1, pressed:false});
});
document.addEventListener('pointerlockchange', () => {
  post({type:'button', button:1,
        pressed: document.pointerLockElement === v});
});
window.addEventListener('mousemove', e => {
  const looking = document.pointerLockElement === v || (e.buttons & 2);
  if (looking && (e.movementX || e.movementY))
    post({type:'move', dx:e.movementX, dy:e.movementY});
});
v.addEventListener('contextmenu', e => e.preventDefault());
</script></body></html>"""


def _encode_jpeg(img: np.ndarray, quality: int = 85) -> bytes:
    from PIL import Image
    arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


class ViewerServer:
    """HTTP server owning the latest-frame slot; the render loop pushes
    frames via publish() (typically from Application.run's on_frame)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 on_key_release=None, scenes=None, on_scene_select=None,
                 on_settings=None, on_render=None, render_dir=None):
        import os
        import pathlib
        # offline renders may only land inside this directory (default:
        # cwd). POST /render is reachable by any web page via a
        # no-preflight cross-origin POST, so an unconstrained path would
        # let a visited page overwrite arbitrary writable files.
        self._render_dir = pathlib.Path(render_dir or os.getcwd()).resolve()
        self._frame_lock = threading.Condition()
        self._jpeg: bytes = _encode_jpeg(np.zeros((8, 8, 3), np.float32))
        self._seq = 0
        self._state = {}
        self._scenes = list(scenes or [])
        self._on_scene_select = on_scene_select
        self._on_settings = on_settings
        self._on_render = on_render
        if on_key_release is not None:
            Input.set_key_release_callback(on_key_release)
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                log.debug(fmt, *args)

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/frame":
                    jpeg, _ = server.latest()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(jpeg)))
                    self.end_headers()
                    self.wfile.write(jpeg)
                elif self.path == "/state":
                    body = json.dumps(server._state).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/scenes":
                    body = json.dumps({"scenes": server._scenes}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=ptframe")
                    self.end_headers()
                    seq = -1
                    try:
                        while True:
                            jpeg, seq = server.latest(after=seq)
                            self.wfile.write(
                                b"--ptframe\r\nContent-Type: image/jpeg\r\n"
                                + f"Content-Length: {len(jpeg)}\r\n\r\n"
                                .encode())
                            self.wfile.write(jpeg)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_error(404)

            def _origin_ok(self) -> bool:
                """Reject cross-site POSTs: browsers attach an Origin
                header to cross-origin (and fetch-issued) POSTs; accept
                only origins whose host part matches the Host header /
                loopback names. Header-free clients (curl, tests) pass."""
                origin = self.headers.get("Origin")
                if not origin:
                    return True
                try:
                    from urllib.parse import urlsplit
                    ohost = urlsplit(origin).hostname or ""
                except ValueError:
                    return False
                allowed = {"localhost", "127.0.0.1", "::1",
                           (self.headers.get("Host") or "").rsplit(":", 1)[0]}
                return ohost in allowed

            def do_POST(self):
                if not self._origin_ok():
                    self.send_error(403, "cross-origin POST rejected")
                    return
                if self.path == "/scene":
                    length = int(self.headers.get("Content-Length", 0))
                    try:
                        data = json.loads(self.rfile.read(length) or b"{}")
                        name = str(data.get("scene", ""))
                        # a filesystem path loads as a User Scene (≙ the
                        # file-dialog open flow, UserInterface.cpp:768)
                        is_path = str(data.get("path", ""))
                        if server._on_scene_select and is_path:
                            server._on_scene_select("path:" + is_path)
                        elif server._on_scene_select and \
                                name in server._scenes:
                            server._on_scene_select(name)
                        else:
                            self.send_error(400)
                            return
                    except ValueError:
                        self.send_error(400)
                        return
                    self.send_response(204)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                if self.path == "/settings":
                    length = int(self.headers.get("Content-Length", 0))
                    try:
                        data = json.loads(self.rfile.read(length) or b"{}")
                        if not isinstance(data, dict) or \
                                server._on_settings is None:
                            raise ValueError("no settings sink")
                        server._on_settings(data)
                    except ValueError as exc:
                        log.warning("bad settings: %s", exc)
                        self.send_error(400)
                        return
                    self.send_response(204)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                if self.path == "/render":
                    # offline-render trigger (≙ the Render-button modal,
                    # UserInterface.cpp:774-1212): {path, format, width,
                    # height, max_samples, max_time_s, frame_count,
                    # framerate}; runs on the loop thread — the viewer
                    # freezes while it renders, like the reference's
                    # offline state machine disabling interaction
                    length = int(self.headers.get("Content-Length", 0))
                    try:
                        data = json.loads(self.rfile.read(length) or b"{}")
                        if not isinstance(data, dict) or \
                                server._on_render is None or \
                                not str(data.get("path", "")):
                            raise ValueError("need a render sink + path")
                        import pathlib
                        out = (server._render_dir /
                               str(data["path"])).resolve()
                        if not out.is_relative_to(server._render_dir):
                            raise ValueError("path escapes render dir")
                        data = dict(data, path=str(out))
                        server._on_render(data)
                    except ValueError as exc:
                        log.warning("bad render request: %s", exc)
                        self.send_error(400)
                        return
                    self.send_response(204)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                if self.path != "/input":
                    self.send_error(404)
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    data = json.loads(self.rfile.read(length) or b"{}")
                    for ev in data.get("events", []):
                        kind = ev.get("type")
                        if kind == "key":
                            Input.set_key(str(ev["key"]),
                                          bool(ev["pressed"]))
                        elif kind == "button":
                            Input.set_mouse_button(int(ev["button"]),
                                                   bool(ev["pressed"]))
                        elif kind == "move":
                            Input.add_mouse_delta(float(ev["dx"]),
                                                  float(ev["dy"]))
                except (ValueError, KeyError) as exc:
                    log.warning("bad input event: %s", exc)
                self.send_response(204)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    def start(self) -> None:
        self._thread.start()
        log.info("viewer at http://%s:%d/", self.host, self.port)

    def stop(self) -> None:
        """Stop serving and close the listening socket."""
        self._httpd.shutdown()
        self._httpd.server_close()

    def publish(self, img: np.ndarray, state: dict | None = None) -> None:
        jpeg = _encode_jpeg(img)
        with self._frame_lock:
            self._jpeg = jpeg
            self._seq += 1
            if state:
                self._state = state
            self._frame_lock.notify_all()

    def latest(self, after: int = -1, timeout: float = 5.0):
        with self._frame_lock:
            if after >= 0:
                self._frame_lock.wait_for(lambda: self._seq != after,
                                          timeout=timeout)
            return self._jpeg, self._seq


def _build_hud(width: int, height: int) -> np.ndarray:
    """Engine-logo overlay as an (H, W, 4) uint8 RGBA array, the headless
    analogue of the UI image the reference composites over the film
    (uiComposition.comp; logo art from the embedded `pt_torch.resources`).
    As `pt`'s: the logo a fifth of the width (at least 32 px) at (6, 6),
    left out when it does not fit; it is decoded by the port's PNG decoder
    and scaled with an antialiased bicubic filter instead of Pillow's."""
    from pt_torch import resources

    hud = np.zeros((height, width, 4), np.uint8)
    logo = resources.texture_rgba("logo")
    lw = max(32, width // 5)
    lh = max(1, logo.shape[0] * lw // logo.shape[1])
    if lw + 6 < width and lh + 6 < height:
        img = torch.as_tensor(logo).permute(2, 0, 1)[None].to(torch.float32)
        img = torch.nn.functional.interpolate(img, size=(lh, lw),
                                              mode="bicubic", antialias=True)
        hud[6:6 + lh, 6:6 + lw] = (img[0].permute(1, 2, 0).round()
                                   .clamp(0, 255).to(torch.uint8).numpy())
    return hud


def apply_settings(app, data: dict) -> None:
    """Map a JSON settings dict onto the renderer's PathTracingSettings /
    PostProcessSettings dataclasses (unknown keys ignored; ≙ the Settings
    tab writing Renderer::SetSettings, Renderer.cpp:825-852), plus the
    non-dataclass controls of the reference UI:

    - "camera_index": int — scene camera radio list
      (UserInterface.cpp:1230-1243); resets accumulation on change
    - "debug_mode": name | int | "off" — swaps the debug pipeline in or
      out live (UserInterface.cpp:1700-1727)
    - "debug_flags": {force_opaque, cull_backfaces,
      disable_color_texture, disable_shadows} bools
      (UserInterface.cpp:1728-1764)

    Values are coerced to the field's declared type here: a bad payload
    must raise NOW (where the caller logs and rejects the update), not as
    a TypeError inside the next frame's render loop — that would kill the
    whole viewer from one HTTP request."""
    import dataclasses

    def coerce(dc, updates: dict) -> dict:
        out = {}
        for f in dataclasses.fields(type(dc)):
            if f.name not in updates:
                continue
            v = updates[f.name]
            if f.type in ("int", int):
                out[f.name] = int(v)
            elif f.type in ("float", float):
                out[f.name] = float(v)
            elif f.type in ("bool", bool):
                out[f.name] = bool(v)
            else:
                out[f.name] = v
        return out

    if "camera_index" in data:
        idx = int(data["camera_index"])
        cams = app.renderer.scene.cameras if app.renderer.scene else []
        if not 0 <= idx < max(len(cams), 1):
            raise ValueError(f"camera_index {idx} out of range")
        if idx != app.renderer.camera_index:
            app.renderer.camera_index = idx
            app.renderer.reset_accumulation()
    if "debug_mode" in data:
        from pt_torch.render.debug import DebugRenderMode
        v = data["debug_mode"]
        if v in (None, "", "off", "Off", -1, "-1"):
            app.debug_mode = None
        elif isinstance(v, str) and not v.lstrip("-").isdigit():
            try:
                app.debug_mode = DebugRenderMode[
                    v.upper().replace("-", "_")]
            except KeyError:
                raise ValueError(f"unknown debug mode {v!r}")
        else:
            app.debug_mode = DebugRenderMode(int(v))
    if "debug_flags" in data:
        from pt_torch.render.debug import DebugFlags
        flags = dict(data["debug_flags"])
        known = {f.name for f in dataclasses.fields(DebugFlags)}
        app.debug_flags = DebugFlags(
            **{k: bool(v) for k, v in flags.items() if k in known})

    st, post = app.renderer.settings, app.renderer.post
    st_up = coerce(st, data)
    post_up = coerce(post, data)
    app.renderer.set_settings(
        dataclasses.replace(st, **st_up) if st_up else None,
        dataclasses.replace(post, **post_up) if post_up else None)


def run_viewer(app, host: str = "127.0.0.1", port: int = 8000,
               duration_seconds: float = 1e30, show_hud: bool = True,
               adaptive_tol=None, render_dir=None) -> int:
    """Drive Application.run with frames streaming to the browser and
    browser input driving the fly camera, for `duration_seconds` or until
    interrupted. Returns the frames looped. `port=0` binds a free port (the
    server's `port` attribute, printed, says which)."""

    hud_state = {"visible": show_hud}
    pending_scene: list = []
    pending_settings: list = []
    pending_render: list = []
    render_note = {"msg": ""}

    pending_reload: list = []

    def on_key_release(key: str) -> None:
        # ≙ UserInterface::OnKeyRelease (UserInterface.cpp:202-220):
        # P toggles animation pause, Space shows/hides the UI overlay,
        # H hot-reloads the shader-equivalent modules
        if key == "p" and app.renderer.scene is not None:
            app.renderer.scene.animation_paused = \
                not app.renderer.scene.animation_paused
        elif key == "space":
            hud_state["visible"] = not hud_state["visible"]
        elif key == "h":
            pending_reload.append(1)     # applied on the loop thread

    scene_names = [f"{g}/{n}"
                   for g, scenes in app.scene_manager.groups.items()
                   for n in scenes]
    server = ViewerServer(host, port, on_key_release, scenes=scene_names,
                          on_scene_select=pending_scene.append,
                          on_settings=pending_settings.append,
                          on_render=pending_render.append,
                          render_dir=render_dir)
    server.start()
    print(f"viewer at http://{server.host}:{server.port}/  (Ctrl-C stops)",
          flush=True)

    hud_cache: dict = {}

    def on_frame(snapshot: np.ndarray, total_samples: int) -> None:
        # scene switches requested over HTTP apply here, on the loop
        # thread, so the renderer is never mutated mid-frame
        if pending_scene:
            # last-wins for scene targets, but delete only what was seen —
            # a pop()+clear() pair would discard a concurrently-appended
            # newer request without effect
            batch = pending_scene[:]
            del pending_scene[:len(batch)]
            target = batch[-1]
            try:
                if target.startswith("path:"):
                    # ≙ UserInterface.cpp:768: load an arbitrary file as
                    # "User Scene" and make it active
                    from pt_torch.core.camera import InputCamera
                    from pt_torch.scene.manager import SceneDescription
                    path = target[5:]
                    loader = SceneDescription("User Scene",
                                              [path]).to_loader()
                    if loader is None:
                        raise FileNotFoundError(path)
                    if loader.default_camera is None:
                        # the reference's default scene camera (Scene.h:
                        # 259-260, reversed-arg quirk preserved)
                        loader.default_camera = InputCamera(
                            45.0, 100.0, 0.1, (3.0, 1.0, 0.0),
                            (-1.0, 0.0, 0.0))
                    app.scene_manager.register("User Scenes", "User Scene",
                                               loader)
                    app.set_scene("User Scenes", "User Scene",
                                  blocking=True)
                else:
                    group, _, name = target.rpartition("/")
                    app.set_scene(group, name, blocking=True)
            except Exception as exc:       # keep-prev-on-failure semantics
                log.warning("scene switch to %s failed: %s", target, exc)
        if pending_reload:
            del pending_reload[:]
            try:
                app.reload_shaders()
                log.info("shaders reloaded")
            except Exception as exc:    # keep the old code on failure,
                log.warning("shader reload failed: %s", exc)  # ≙ the
                # reference keeping the old SPIR-V on a compile error
        if pending_settings:
            # drain in arrival order: payloads are partial deltas, so
            # applying only the newest would silently drop earlier ones
            # (snapshot-slice + del avoids racing concurrent appends)
            batch = pending_settings[:]
            del pending_settings[:len(batch)]
            for data in batch:
                try:
                    apply_settings(app, data)
                except (TypeError, ValueError, KeyError) as exc:
                    log.warning("settings update rejected: %s", exc)
        if pending_render:
            # offline-render trigger, last-wins (≙ one modal at a time)
            batch = pending_render[:]
            del pending_render[:len(batch)]
            data = batch[-1]
            try:
                from pt_torch.out.saver import OutputInfo
                from pt_torch.run.offline import RenderSettings
                out = OutputInfo(
                    path=str(data["path"]),
                    width=int(data.get("width", app.renderer.width)),
                    height=int(data.get("height", app.renderer.height)),
                    framerate=float(data.get("framerate", 30.0)),
                    format=str(data.get("format",
                                        str(data["path"]).rsplit(".", 1)[-1]
                                        if "." in str(data["path"])
                                        else "png")))
                rs = RenderSettings(
                    output=out,
                    frame_count=int(data.get("frame_count", 1)),
                    max_sample_count=int(data.get("max_samples", 256)),
                    max_time_seconds=(float(data["max_time_s"])
                                      if data.get("max_time_s") else None))
                render_note["msg"] = f"rendering {out.path}..."
                server.publish(np.asarray(app.renderer.snapshot()), {
                    **server._state, "offline": render_note["msg"]})
                app.render_offline(rs)
                render_note["msg"] = f"saved {out.path}"
            except Exception as exc:    # never kill the viewer loop
                log.warning("offline render failed: %s", exc)
                render_note["msg"] = f"render failed: {exc}"
        if show_hud and hud_state["visible"]:
            from pt_torch.post.pipeline import compose_ui
            h, w = snapshot.shape[:2]
            hud = hud_cache.get((w, h))
            if hud is None:
                hud = hud_cache[(w, h)] = _build_hud(w, h)
            if hud[..., 3].any():
                snapshot = compose_ui(torch.as_tensor(snapshot),
                                      hud).numpy()
        cams = app.renderer.scene.cameras if app.renderer.scene else []
        server.publish(snapshot, {
            "total_samples": total_samples,
            "rays_traced": app.renderer.rays_traced,
            "size": [app.renderer.width, app.renderer.height],
            "camera_count": len(cams),
            "camera_index": app.renderer.camera_index,
            "debug_mode": (app.debug_mode.name.lower()
                           if app.debug_mode is not None else "off"),
            "bounce_count": app.renderer.settings.bounce_count,
            "lens_radius": app.renderer.settings.lens_radius,
            "focal_distance": app.renderer.settings.focal_distance,
            "exposure": app.renderer.post.exposure,
            "offline": render_note["msg"]})

    try:
        return app.run(duration_seconds=duration_seconds, on_frame=on_frame,
                       adaptive_tol=adaptive_tol)
    except KeyboardInterrupt:
        return 0
    finally:
        server.stop()
