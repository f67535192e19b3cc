"""Command-line interface of the port.

Port of `pt.run.cli`, run as `python -m pt_torch.run.cli <command>`:

  list-scenes                      scene catalog (≙ Scenes tab)
  render ...                       offline render (≙ Offline Render modal)
  debug ...                        debug view modes (≙ Debug tab)
  stats                            stat board dump (≙ Statistics tab)
  view ...                         live browser viewer with fly camera

with `pt`'s flags and defaults, and `--device` on `render`, `debug`,
`stats` and `view` (default: the card, `cuda:0`; `--device cpu` runs the
kernels' plain versions). `-A/-S` name the Assets and Scenes directories
(`Config.create`); `--scene` takes "Group/Name" or a .gltf/.glb/.obj/.fbx
file, registered as "CLI/file". `render --format` writes png, hdr, jpg or
tga (jpg and tga need Pillow) or mp4 (through ffmpeg, or an MJPEG AVI,
which needs Pillow, where there is no ffmpeg). `render --backend pallas`
(the default) and `view --backend pallas` run the port's kernels,
`--backend bvh` `pt`'s threaded LBVH in tensor code, `--backend brute`
brute force; `debug` and `stats` trace by brute force, as in `pt`. `view`
serves the viewer on `--host:--port` (loopback, 8000 by default) for
`--duration` seconds, or until Ctrl-C; its JPEG stream needs Pillow.
"""

from __future__ import annotations

import argparse
import sys

SCENE_FILES = (".gltf", ".glb", ".obj", ".fbx")

BACKENDS = ["pallas", "bvh", "brute"]
BACKEND_HELP = ("pallas: the port's kernels; bvh: pt's threaded LBVH, "
                "walked in tensor code; brute: every ray against every "
                "triangle")

DEBUG_MODES = ["color", "world-position", "normal", "tex-coords", "mips",
               "geometry", "primitive", "instance"]


def _parse_size(s: str):
    w, _, h = s.partition("x")
    return int(w), int(h or w)


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:0; 'cpu' "
                        "runs the kernels' plain versions)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pt_torch",
                                description="path tracer on PyTorch and "
                                "CUDA")
    p.add_argument("-A", "--assets", default=None,
                   help="assets directory (the curated catalog's files)")
    p.add_argument("-S", "--scenes", default=None,
                   help="scenes directory (glTF sample directories)")
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("list-scenes", help="list the scene catalog")

    r = sub.add_parser("render", help="offline render to image files")
    r.add_argument("--scene", default="Test Scenes/Default",
                   help='"Group/Name" from list-scenes, or a '
                        '.gltf/.glb/.obj/.fbx path')
    r.add_argument("--out", default="render.png")
    r.add_argument("--size", type=_parse_size, default=(1280, 720),
                   metavar="WxH")
    r.add_argument("--spp", type=int, default=256,
                   help="max samples (≙ UI max samples, ≤10000)")
    r.add_argument("--max-time", type=float, default=None,
                   help="per-frame time budget in seconds")
    r.add_argument("--bounces", type=int, default=5)
    r.add_argument("--frames", type=int, default=1,
                   help=">1 renders an animation (mp4 or numbered frames)")
    r.add_argument("--camera", type=int, default=0,
                   help="scene camera index (≙ the Settings-tab camera "
                        "list)")
    r.add_argument("--framerate", type=float, default=30.0)
    r.add_argument("--format", default=None,
                   choices=[None, "png", "jpg", "tga", "hdr", "mp4"],
                   help="output format (default: the --out suffix)")
    r.add_argument("--exposure", type=float, default=1.0)
    r.add_argument("--bloom-threshold", type=float, default=1.0)
    r.add_argument("--bloom-intensity", type=float, default=0.1)
    r.add_argument("--no-bloom", action="store_true")
    r.add_argument("--lens-radius", type=float, default=0.0)
    r.add_argument("--focal-distance", type=float, default=1.0)
    r.add_argument("--backend", default="pallas",
                   choices=BACKENDS, help=BACKEND_HELP)
    r.add_argument("--checkpoint", default=None,
                   help="film checkpoint file for long single-frame "
                        "renders: resumed if present, saved every 5 min, "
                        "deleted on success")
    r.add_argument("--hdr", action="store_true",
                   help="HDR10 PQ output encoding")
    r.add_argument("--adaptive", type=float, default=None, metavar="TOL",
                   help="noise-driven per-pixel stopping: pixels stop "
                        "sampling once their 95%% CI (tonemapped) is below "
                        "TOL; --spp becomes the per-pixel cap")
    r.add_argument("--adaptive-mse", type=float, default=None, metavar="MSE",
                   help="stop at an estimated global tonemapped-MSE "
                        "target instead of per-pixel CIs; overrides "
                        "--adaptive")
    _add_device(r)

    d = sub.add_parser("debug", help="debug visualization render")
    d.add_argument("--scene", default="Test Scenes/Default")
    d.add_argument("--mode", default="normal", choices=DEBUG_MODES)
    d.add_argument("--out", default="debug.png")
    d.add_argument("--size", type=_parse_size, default=(640, 480),
                   metavar="WxH")
    # ≙ the Debug tab's raygen/hit flag checkboxes (UserInterface.cpp:1700+)
    d.add_argument("--force-opaque", action="store_true")
    d.add_argument("--cull-backfaces", action="store_true")
    d.add_argument("--disable-color-texture", action="store_true")
    d.add_argument("--disable-shadows", action="store_true")
    _add_device(d)

    s = sub.add_parser("stats", help="render one frame and dump the stat "
                                     "board")
    _add_device(s)

    v = sub.add_parser("view", help="live browser viewer with fly camera")
    v.add_argument("--scene", default="Test Scenes/Default")
    v.add_argument("--size", type=_parse_size, default=(640, 480),
                   metavar="WxH")
    v.add_argument("--bounces", type=int, default=5)
    v.add_argument("--backend", default="pallas", choices=BACKENDS,
                   help=BACKEND_HELP)
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=8000)
    v.add_argument("--duration", type=float, default=1e30,
                   help="stop after this many seconds (default: run forever)")
    v.add_argument("--adaptive", type=float, default=None, metavar="TOL",
                   help="adaptive progressive refinement: converged pixels "
                        "stop sampling; a fully-converged still view idles")
    _add_device(v)
    return p


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def _config(args):
    """(`Config.create` from `-A/-S`, None), or (None, exit code) after
    printing why not."""
    from pt_torch.core.config import Config
    try:
        return Config.create(
            (["-A", args.assets] if args.assets else [])
            + (["-S", args.scenes] if args.scenes else [])), None
    except ValueError as exc:
        return None, _error(str(exc))


def _load_app(args, width: int, height: int, fmt: str = "png"):
    """(Application on `--device` with `--scene` active and a width x height
    film, None), or (None, exit code) after printing why not. A scene file
    is registered as "CLI/file" (exit 2 if it is missing)."""
    from pt_torch import default_device
    from pt_torch.out.saver import FORMATS
    from pt_torch.run.app import Application
    from pt_torch.scene.manager import SceneDescription
    if fmt not in FORMATS:
        return None, _error(f"unsupported output format '{fmt}' (png, jpg, "
                            "tga, hdr or mp4)")
    scene = getattr(args, "scene", "Test Scenes/Default")   # stats: none
    loader = None
    if scene.endswith(SCENE_FILES):
        loader = SceneDescription("cli", [scene]).to_loader()
        if loader is None:
            return None, _error(f"scene file not found: {scene}")
        group, name = "CLI", "file"
    else:
        group, _, name = scene.partition("/")
        if not name:
            return None, _error('--scene must be "Group/Name" or a .gltf '
                                'path')
    cfg, rc = _config(args)
    if cfg is None:
        return None, rc
    try:
        device = default_device(args.device)
    except RuntimeError as exc:
        return None, _error(f"{exc} (on the command line: --device cpu)")
    app = Application(cfg, device=device)
    if loader is not None:
        app.scene_manager.register(group, name, loader)
    app.init(group, name, width, height)
    return app, None


def _out_format(args) -> str:
    return (getattr(args, "format", None)
            or args.out.rsplit(".", 1)[-1]).lower()


def cmd_list_scenes(args) -> int:
    from pt_torch.scene.manager import SceneManager
    cfg, rc = _config(args)
    if cfg is None:
        return rc
    mgr = SceneManager(cfg)
    for group, scenes in mgr.groups.items():
        print(group)
        for name in scenes:
            print(f"  {group}/{name}")
    return 0


def cmd_render(args) -> int:
    from pt_torch.out.saver import OutputInfo
    from pt_torch.post.pipeline import PostProcessSettings
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run.offline import RenderSettings

    width, height = args.size
    fmt = _out_format(args)
    app, rc = _load_app(args, width, height, fmt)
    if app is None:
        return rc
    settings = PathTracingSettings(
        sample_count=1, bounce_count=args.bounces,
        lens_radius=args.lens_radius, focal_distance=args.focal_distance,
        backend=args.backend)
    post = PostProcessSettings(exposure=args.exposure,
                               bloom_threshold=args.bloom_threshold,
                               bloom_intensity=args.bloom_intensity,
                               enable_bloom=not args.no_bloom)
    rs = RenderSettings(
        output=OutputInfo(args.out, width, height, args.framerate, fmt),
        frame_count=args.frames, max_sample_count=args.spp,
        max_time_seconds=args.max_time, hdr=args.hdr,
        checkpoint_path=args.checkpoint, adaptive_tol=args.adaptive,
        adaptive_target_mse=args.adaptive_mse)

    def progress(frame, total, samples):
        print(f"\rframe {frame + 1}/{total}  {samples}/{args.spp} spp",
              end="", file=sys.stderr)

    app.renderer.camera_index = args.camera
    frames = app.render_offline(rs, settings, post, progress)
    print(f"\nwrote {frames} frame(s) to {args.out} on "
          f"{app.renderer.device}", file=sys.stderr)
    app.shutdown()
    return 0 if frames else 1


def cmd_debug(args) -> int:
    """One debug frame of the scene's first camera to `--out`, by brute
    force (`render_debug_image`'s default, as `pt`'s command). Unlike
    `pt`'s, it first waits for the streamed texture pool."""
    from pt_torch.out.saver import write_image
    from pt_torch.render.debug import (DebugFlags, DebugRenderMode,
                                       render_debug_image)

    width, height = args.size
    app, rc = _load_app(args, width, height, _out_format(args))
    if app is None:
        return rc
    mode = DebugRenderMode[args.mode.upper().replace("-", "_")]
    flags = DebugFlags(force_opaque=args.force_opaque,
                       cull_backfaces=args.cull_backfaces,
                       disable_color_texture=args.disable_color_texture,
                       disable_shadows=args.disable_shadows)
    r = app.renderer
    r.wait_for_textures()
    cam = r.scene.cameras[0]
    cam.on_resize(width, height)
    img = render_debug_image(r.ds, r.tex, cam.inv_view, cam.inv_proj,
                             width, height, mode, flags=flags,
                             device=r.device)
    write_image(args.out, img.cpu().numpy())
    print(f"wrote {args.out} on {r.device}", file=sys.stderr)
    app.shutdown()
    return 0


def cmd_stats(args) -> int:
    """`pt`'s `stats`: the Default at 256², brute force, 3 bounces, two
    frames of `Application.run`, then the stat board, sorted."""
    import torch

    from pt_torch.core.stats import Stats
    from pt_torch.render.integrator import PathTracingSettings
    app, rc = _load_app(args, 256, 256)
    if app is None:
        return rc
    # a diagnostic command: fast start-up over kernel throughput
    app.renderer.set_settings(PathTracingSettings(
        sample_count=1, bounce_count=3, backend="brute"))
    app.run(target_frames=2)
    if app.renderer.device.type == "cuda":
        # the "Render" stat is timed by CUDA events, folded in once they
        # have run: let the last frame's run first
        torch.cuda.synchronize(app.renderer.device)
        Stats.flush_timers()
    for key, value in sorted(Stats.get_stats().items()):
        print(f"{key}: {value}")
    app.shutdown()
    return 0


def cmd_view(args) -> int:
    """`pt`'s `view`: the scene at `--size` with one sample a frame and
    `--bounces` over `--backend`, served by `run_viewer`."""
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run.viewer import run_viewer

    width, height = args.size
    app, rc = _load_app(args, width, height)
    if app is None:
        return rc
    app.renderer.set_settings(PathTracingSettings(
        sample_count=1, bounce_count=args.bounces, backend=args.backend))
    run_viewer(app, args.host, args.port, duration_seconds=args.duration,
               adaptive_tol=args.adaptive)
    app.shutdown()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    handlers = {"list-scenes": cmd_list_scenes, "render": cmd_render,
                "debug": cmd_debug, "stats": cmd_stats, "view": cmd_view}
    return handlers[args.command](args)


if __name__ == "__main__":
    raise SystemExit(main())
