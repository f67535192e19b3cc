"""The port's scene importers and glTF exporter against `pt` on the CPU.

* Every file of `tests/data` and every file that `pt`'s importer suites
  generate (`tests/test_gltf.py`, `test_obj.py`, `test_fbx.py`,
  `test_import_robustness.py`, `test_catalog.py`; built here with the same
  generators) imports into a scene whose whole state is bit-equal to
  `pt`'s: geometry, materials, textures, lights, cameras, skins, animation
  keys and the graph (`pt_torch.convert.scene_state`), also after an
  animation step, and whose flattened arrays are equal to `pt`'s.
* Corrupt input: the truncations and byte flips of
  `tests/test_import_robustness.py` fail in the port as they fail in `pt`
  (same exception type and message) or succeed with the same scene, each
  within the same time bound.
* The exporter: for the same scene the glTF JSON equals `pt`'s but for
  the image buffer views' offsets and lengths, every other buffer view is
  byte-equal, and each embedded PNG (the port's encoder, not Pillow's)
  decodes to the pixels of `pt`'s. The Courtyard round trip holds as
  `tests/test_standin.py` holds it for `pt`.
* `render --scene <glb|obj|fbx> --device cpu` at 32², 1 spp gives a film
  within MSE 1e-3 of `pt`'s application path on the same file (brute
  backend, after its textures are in), and a missing file exits 2.
"""

import contextlib
import dataclasses
import io
import json
import pathlib
import struct
import threading

import numpy as np
import pytest
import torch

from pt.scene.builder import SceneBuilder as JBuilder
from pt_torch.convert import scene_state
from pt_torch.scene.textures import read_radiance_hdr
from pt_torch.scene.builder import SceneBuilder as TBuilder

from tests import test_fbx as jfbx
from tests.test_fbx import ASCII_CUBE, N, _cube_fbx, write_fbx
from tests.test_gltf import _tri_gltf
from tests.test_import_robustness import TIMEOUT, _flips, _truncations
from tests.test_obj import MTL, OBJ
from torch_threads import one_torch_thread  # noqa: F401

DATA = pathlib.Path(__file__).parent / "data"
FILM_MSE = 1e-3


# ------------------------------------------------------------ comparison

def assert_same(a, b, where="scene"):
    """Two `scene_state` values equal: arrays of one dtype and shape with
    the same bits (NaN payloads included), everything else ==."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), \
            (where, a.dtype, b.dtype, a.shape, b.shape)
        if a.dtype == object:
            for i, (x, y) in enumerate(zip(a.ravel(), b.ravel())):
                assert_same(scene_state(x), scene_state(y), f"{where}[{i}]")
        elif a.size:
            assert np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                                  np.ascontiguousarray(b).view(np.uint8)), \
                where
        return
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), (where, a.keys() ^ b.keys())
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (where, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and a != a:
        assert b != b, where
    else:
        assert a == b, (where, a, b)


def _builder(pkg):
    return JBuilder("s") if pkg == "pt" else TBuilder("s")


def _importer(pkg, suffix):
    import importlib
    kind = {".obj": "obj", ".fbx": "fbx"}.get(suffix, "gltf")
    mod = importlib.import_module(f"{pkg}.scene.{kind}")
    return getattr(mod, f"import_{kind}")


def import_both(path, texture_mapping=None):
    """(pt's scene, the port's scene) imported from `path`."""
    out = []
    for pkg in ("pt", "pt_torch"):
        b = _builder(pkg)
        fn = _importer(pkg, pathlib.Path(path).suffix.lower())
        if texture_mapping is not None:
            import importlib
            cat = importlib.import_module(f"{pkg}.scene.catalog")
            fn(b, path, cat.NVIDIA_ORCA_TEXTURE_MAPPING)
        else:
            fn(b, path)
        out.append(b.create_scene())
    return out


def assert_flattened_equal(js, ts):
    from pt.scene.flatten import flatten_scene as j_flatten
    from pt_torch.scene.flatten import DeviceScene
    from pt_torch.scene.flatten import flatten_scene as t_flatten
    jd, td = j_flatten(js), t_flatten(ts, device="cpu")
    for f in dataclasses.fields(DeviceScene):
        got, want = getattr(td, f.name), getattr(jd, f.name)
        if isinstance(got, torch.Tensor):
            want = np.asarray(want)
            got = got.numpy()
            assert (got.dtype, got.shape) == (want.dtype, want.shape), f.name
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            assert got == want, f.name


# ------------------------------------------------------------ the files

def _camera_gltf(tmp_path):
    """`_tri_gltf` with a perspective camera on the animated quad node: an
    AnimatedCamera that follows the node."""
    path = _tri_gltf(tmp_path)
    g = json.loads(path.read_text())
    g["cameras"] = [{"type": "perspective", "perspective": {
        "yfov": 0.7, "znear": 0.05, "zfar": 50.0}}]
    g["nodes"][1]["camera"] = 0
    out = tmp_path / "camera.gltf"
    out.write_text(json.dumps(g))
    return out


def _sparse_gltf(tmp_path):
    """The sparse accessor of `tests/test_gltf.py::test_sparse_accessor`,
    under a mesh so that the importer reads it."""
    import base64
    base = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    blob = base.tobytes()
    off_i = len(blob)
    blob += np.array([2], np.uint16).tobytes() + b"\0\0"
    off_v = len(blob)
    blob += np.array([[7.0, 8.0, 9.0]], np.float32).tobytes()
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": off_i, "byteLength": 2},
            {"buffer": 0, "byteOffset": off_v, "byteLength": 12}],
        "accessors": [{
            "bufferView": 0, "componentType": 5126, "count": 3,
            "type": "VEC3",
            "sparse": {"count": 1,
                       "indices": {"bufferView": 1, "componentType": 5123},
                       "values": {"bufferView": 2}}}],
        "buffers": [{"byteLength": len(blob),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(blob).decode()}],
    }
    path = tmp_path / "sparse.gltf"
    path.write_text(json.dumps(gltf))
    return path


def _obj(tmp_path):
    (tmp_path / "test.mtl").write_text(MTL)
    path = tmp_path / "test.obj"
    path.write_text(OBJ)
    return path


def _fbx(tmp_path, **kw):
    nodes, version = _cube_fbx(**kw)
    path = tmp_path / "cube.fbx"
    write_fbx(path, nodes, version)
    return path


def _multi_material_fbx(tmp_path):
    """The two-material cube of `tests/test_fbx.py::
    test_multi_material_mesh_splits`."""
    verts = np.asarray([
        [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
        [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float64)
    polys = [(0, 1, 2, 3), (4, 7, 6, 5), (0, 4, 5, 1),
             (2, 6, 7, 3), (0, 3, 7, 4), (1, 5, 6, 2)]
    pvi = []
    for p in polys:
        pvi.extend(p[:-1])
        pvi.append(~p[-1])
    geometry = N("Geometry", [1001, "cube\x00\x01Geometry", "Mesh"], [
        N("Vertices", [verts.reshape(-1)]),
        N("PolygonVertexIndex", [np.asarray(pvi, np.int32)]),
        N("LayerElementMaterial", [0], [
            N("MappingInformationType", ["ByPolygon"]),
            N("ReferenceInformationType", ["IndexToDirect"]),
            N("Materials", [np.asarray([0, 0, 0, 1, 1, 1], np.int32)])])])
    model = N("Model", [2001, "cube\x00\x01Model", "Mesh"], [])
    mats = [N("Material", [3001 + i, f"m{i}\x00\x01Material", ""], [
        N("Properties70", [], [
            N("P", ["DiffuseColor", "Color", "", "A", *c]),
            N("P", ["Opacity", "double", "Number", "", 1.0])])])
        for i, c in enumerate([(0.8, 0.2, 0.2), (0.1, 0.9, 0.1)])]
    objects = N("Objects", [], [geometry, model, *mats])
    connections = N("Connections", [], [
        N("C", ["OO", 1001, 2001]), N("C", ["OO", 2001, 0]),
        N("C", ["OO", 3001, 2001]), N("C", ["OO", 3002, 2001])])
    path = tmp_path / "two_mats.fbx"
    write_fbx(path, [objects, connections])
    return path


def _text(name, text):
    def make(tmp_path):
        path = tmp_path / name
        path.write_text(text)
        return path
    return make


def _pt_export(make_scene):
    """A glb that `pt`'s exporter writes (as `pt`'s robustness and catalog
    suites make theirs)."""
    def make(tmp_path):
        from pt.scene.gltf_export import export_glb
        path = tmp_path / "exported.glb"
        export_glb(make_scene(), str(path))
        return path
    return make


def _examples(name):
    def make():
        from pt.scene import examples
        return getattr(examples, name)()
    return make


def _small_courtyard():
    from pt.scene.standin import make_courtyard_scene
    return make_courtyard_scene(detail=0.1, tex_scale=0.05)


FILES = {
    **{f.name: (lambda p, f=f: f) for f in sorted(DATA.iterdir())
       if f.suffix in (".gltf", ".obj", ".fbx")},
    "tri.gltf": lambda p: _tri_gltf(p),
    "tri.glb": lambda p: _tri_gltf(p, binary=True),
    "tri_static.gltf": lambda p: _tri_gltf(p, with_anim=False),
    "camera.gltf": _camera_gltf,
    "sparse.gltf": _sparse_gltf,
    "reuse_mesh.glb": _pt_export(_examples("make_reuse_mesh_scene")),
    "roughness.glb": _pt_export(_examples("make_roughness_test_scene")),
    "courtyard.glb": _pt_export(_small_courtyard),
    "test.obj": _obj,
    "cube7400.fbx": lambda p: _fbx(p, version=7400),
    "cube7500.fbx": lambda p: _fbx(p, version=7500),
    "cube_bypolygon.fbx": lambda p: _fbx(p, mapping="ByPolygon"),
    "cube_byvertice.fbx": lambda p: _fbx(p, mapping="ByVertice"),
    "cube_uv_index.fbx": lambda p: _fbx(p, ref="IndexToDirect"),
    "skin.fbx": lambda p: jfbx.TestSkinning()._skinned_fbx(p),
    "ascii_cube.fbx": _text("cube_ascii.fbx", ASCII_CUBE),
    "ascii_comments.fbx": _text("c.fbx", ASCII_CUBE.replace(
        "Objects:", "; a comment line\nObjects:")),
    "two_mats.fbx": _multi_material_fbx,
}


@pytest.mark.parametrize("name", sorted(FILES))
def test_imported_scene_equals_pt(tmp_path, name):
    path = FILES[name](tmp_path)
    js, ts = import_both(path)
    assert_same(scene_state(js), scene_state(ts))
    assert_flattened_equal(js, ts)
    if js.graph.has_animations:
        assert js.update(0.7) == ts.update(0.7) is True
        assert_same(scene_state(js), scene_state(ts))
        assert_flattened_equal(js, ts)


def test_texture_mapping_and_animated_camera_equal_pt(tmp_path):
    """The catalog's texture remap passes through `import_gltf` as in
    `pt`; a camera on an animated node follows it in both packages."""
    js, ts = import_both(_pt_export(_small_courtyard)(tmp_path),
                         texture_mapping=True)
    assert_same(scene_state(js), scene_state(ts))
    js, ts = import_both(_camera_gltf(tmp_path))
    assert type(ts.cameras[0]).__name__ == "AnimatedCamera"
    before = ts.cameras[0].position.copy()
    js.update(1.0)
    ts.update(1.0)
    assert not np.array_equal(before, ts.cameras[0].position)
    np.testing.assert_array_equal(js.cameras[0].inv_view,
                                  ts.cameras[0].inv_view)


def test_gltf_accessors_equal_pt(tmp_path):
    """Sparse and interleaved accessors read through `GLTFFile` as `pt`'s
    do."""
    from pt.scene.gltf import GLTFFile as JFile
    from pt_torch.scene.gltf import GLTFFile as TFile
    for path in (_sparse_gltf(tmp_path), DATA / "adv_interleaved.gltf"):
        jf, tf = JFile(path), TFile(path)
        for i in range(len(jf.json["accessors"])):
            want, got = jf.accessor(i), tf.accessor(i)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- corrupt input

def _outcome(fn):
    """("ok", scene state) or ("raise", type name, message); a hang fails
    the test (`tests/test_import_robustness.py`'s bound)."""
    box = {}

    def run():
        try:
            box["out"] = ("ok", scene_state(fn()))
        except Exception as exc:
            box["out"] = ("raise", type(exc).__name__, str(exc))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(TIMEOUT)
    assert not t.is_alive(), "parser hung on corrupt input"
    return box["out"]


def _same_outcome(fn_pt, fn_port):
    want, got = _outcome(fn_pt), _outcome(fn_port)
    assert want[0] == got[0], (want[:3], got[:3])
    if want[0] == "raise":
        assert want == got
    else:
        assert_same(want[1], got[1])


def _parse_fbx_both(data):
    from pt.scene.fbx import parse_fbx as j_parse
    from pt_torch.scene.fbx import parse_fbx as t_parse
    _same_outcome(lambda: j_parse(data), lambda: t_parse(data))


def _import_both(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)

    def run(pkg):
        b = _builder(pkg)
        _importer(pkg, path.suffix)(b, path)
        return b.create_scene()
    _same_outcome(lambda: run("pt"), lambda: run("pt_torch"))


@pytest.mark.parametrize("case", ["fbx_truncations", "fbx_flips",
                                  "glb_truncations", "glb_flips",
                                  "obj_garbage", "fbx_ascii_garbage",
                                  "fixture_flips"])
def test_corrupt_input_fails_as_pt_fails(tmp_path, case):
    rng = np.random.default_rng({"fbx_flips": 0, "glb_flips": 1,
                                 "fixture_flips": 3}.get(case, 0))
    if case.startswith("fbx_") and case != "fbx_ascii_garbage":
        data = _fbx(tmp_path).read_bytes()
        variants = (_truncations(data) if case == "fbx_truncations"
                    else _flips(data, rng, 40))
        for v in variants:
            _parse_fbx_both(v)
            _import_both(tmp_path, "v.fbx", v)
    elif case.startswith("glb_"):
        data = _pt_export(_examples("make_reuse_mesh_scene"))(
            tmp_path).read_bytes()
        variants = (_truncations(data) if case == "glb_truncations"
                    else _flips(data, rng, 40))
        for v in variants:
            _import_both(tmp_path, "corrupt.glb", v)
    elif case == "obj_garbage":
        for text in [
                "v 1 2\nf 1 2 3\n",
                "v 1 2 3\nv 4 5 6\nv 7 8 9\nf 1 2 99\n",
                "f -1000000/2/3 2 3\n",
                "v nan nan nan\nv 0 0 1\nv 1 0 0\nf 1 2 3\n",
                "mtllib missing.mtl\nusemtl nope\nv 0 0 0\nv 1 0 0\n"
                "v 0 1 0\nf 1 2 3\n",
                "\x00\x01\x02 binary garbage \xff\xfe\n"]:
            _import_both(tmp_path, "bad.obj", text.encode("latin-1"))
    elif case == "fbx_ascii_garbage":
        for text in ["FBXHeaderExtension: {",
                     "FBXHeaderExtension: { a: *4 {",
                     'Objects: "unterminated',
                     "Objects: { Geometry: *99999999 { a: 1,2,3 } }",
                     ";" * 5000, "}" * 100 + "{" * 100]:
            _parse_fbx_both(b"; FBX ASCII\nFBXHeaderExtension: {}\n"
                            + text.encode())
    else:            # the repo's own fixtures, cut and flipped
        for f in sorted(DATA.iterdir()):
            if f.suffix not in (".gltf", ".obj", ".fbx"):
                continue
            data = f.read_bytes()
            for v in _truncations(data, 6) + _flips(data, rng, 6):
                _import_both(tmp_path, "v" + f.suffix, v)


def test_gltf_bounds_on_corrupt_json_equal_pt(tmp_path):
    """The accessor allocation bomb raises ValueError and a node cycle
    RecursionError, in both packages."""
    bomb = {"asset": {"version": "2.0"}, "scene": 0,
            "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
            "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
            "accessors": [{"count": 2 ** 40, "type": "VEC3",
                           "componentType": 5126}]}
    cycle = {"asset": {"version": "2.0"}, "scene": 0,
             "scenes": [{"nodes": [0]}],
             "nodes": [{"children": [1]}, {"children": [0]}]}
    for name, g, exc in (("bomb.gltf", bomb, "ValueError"),
                         ("cycle.gltf", cycle, "RecursionError")):
        path = tmp_path / name
        path.write_text(json.dumps(g))
        outcomes = [_outcome(lambda pkg=pkg: _importer(pkg, ".gltf")(
            _builder(pkg), path)) for pkg in ("pt", "pt_torch")]
        assert outcomes[0][:2] == outcomes[1][:2] == ("raise", exc)


# ------------------------------------------------------------ the exporter

def _glb_parts(data):
    """(JSON dict, binary chunk) of a .glb."""
    magic, _, _ = struct.unpack("<III", data[:12])
    assert magic == 0x46546C67
    jlen, _ = struct.unpack("<II", data[12:20])
    g = json.loads(data[20:20 + jlen])
    pos = 20 + jlen
    blen, _ = struct.unpack("<II", data[pos:pos + 8])
    return g, data[pos + 8:pos + 8 + blen]


def _view(g, blob, i):
    v = g["bufferViews"][i]
    return blob[v["byteOffset"]:v["byteOffset"] + v["byteLength"]]


@pytest.mark.parametrize("which", ["courtyard", "default", "roughness"])
def test_export_glb_equals_pt(tmp_path, which):
    from pt.scene.gltf_export import export_glb as j_export
    from pt.scene.textures import load_texture_pixels as j_load
    from pt_torch.scene.gltf_export import export_glb as t_export
    from pt_torch.scene.textures import decode_png
    if which == "courtyard":
        from pt.scene.standin import make_courtyard_scene as jmake
        from pt_torch.scene.standin import make_courtyard_scene as tmake
        jsc, tsc = jmake(0.1, 0.05), tmake(0.1, 0.05)
    else:
        from pt.scene import examples as je
        from pt_torch.scene import examples as te
        name = {"default": "make_default_scene",
                "roughness": "make_roughness_test_scene"}[which]
        jsc, tsc = getattr(je, name)(), getattr(te, name)()
    j_export(jsc, str(tmp_path / "pt.glb"))
    t_export(tsc, str(tmp_path / "port.glb"))
    jg, jb = _glb_parts((tmp_path / "pt.glb").read_bytes())
    tg, tb = _glb_parts((tmp_path / "port.glb").read_bytes())
    image_views = {im["bufferView"] for im in jg.get("images", [])}
    assert image_views == {im["bufferView"] for im in tg.get("images", [])}
    if which != "roughness":
        assert image_views                       # the scene has textures

    def without_layout(g):
        g = json.loads(json.dumps(g))
        for v in g["bufferViews"]:
            del v["byteOffset"], v["byteLength"]
        del g["buffers"][0]["byteLength"]
        return g
    assert without_layout(jg) == without_layout(tg)
    for i in range(len(jg["bufferViews"])):
        want, got = _view(jg, jb, i), _view(tg, tb, i)
        if i in image_views:
            from pt.scene.types import TextureInfo, TextureType
            pil = j_load(TextureInfo("x", TextureType.COLOR, data=want))
            np.testing.assert_array_equal(
                decode_png(got).astype(np.float32) / 255.0, pil)
        else:
            assert want == got, i


def test_courtyard_round_trip_holds_as_for_pt(tmp_path):
    """`tests/test_standin.py::TestGlbRoundTrip` for the port: the
    triangle and alpha-triangle counts, the lights, at least 40 textures
    and a camera survive export and import; the world-space bounds and
    centroid agree."""
    from pt_torch.scene.flatten import flatten_scene, world_vertices
    from pt_torch.scene.gltf import import_gltf
    from pt_torch.scene.gltf_export import export_glb
    from pt_torch.scene.standin import make_courtyard_scene
    scene = make_courtyard_scene(detail=0.3, tex_scale=1 / 16)
    path = str(tmp_path / "courtyard.glb")
    export_glb(scene, path)
    b = TBuilder("rt")
    import_gltf(b, path)
    s2 = b.create_scene()
    ds1, ds2 = flatten_scene(scene, device="cpu"), flatten_scene(s2,
                                                                 device="cpu")
    assert ds1.num_triangles == ds2.num_triangles
    assert ds2.has_alpha
    assert int((~ds2.tri_opaque).sum()) == int((~ds1.tri_opaque).sum()) > 0
    assert len(s2.point_lights) == len(scene.point_lights)
    d1 = np.asarray(scene.directional_light.direction, np.float64)
    d2 = np.asarray(s2.directional_light.direction, np.float64)
    np.testing.assert_allclose(d1 / np.linalg.norm(d1), d2, atol=1e-5)
    assert len(s2.textures) >= 40 and len(s2.cameras) >= 1
    w1, w2 = world_vertices(ds1)[0].numpy(), world_vertices(ds2)[0].numpy()
    for f in (np.min, np.max, np.mean):
        np.testing.assert_allclose(f(w1, 0), f(w2, 0), atol=1e-3)


# ----------------------------------------------------------------- the CLI

def _main(argv):
    from pt_torch.run import cli
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _pt_app_film(path):
    """`pt`'s application path on a scene file as its CLI loads one
    (`SceneDescription` registered as CLI/file), 32², 1 spp, 3 bounces,
    brute backend, after the streamed textures are in: the film as its
    Radiance HDR file holds it (RGBE, negative radiance clipped to 0, as
    the port's file holds its own)."""
    from pt.out.saver import OutputInfo
    from pt.post.pipeline import PostProcessSettings
    from pt.render.integrator import PathTracingSettings
    from pt.run.app import Application
    from pt.run.offline import RenderSettings
    from pt.scene.manager import SceneDescription
    app = Application()
    app.scene_manager.register("CLI", "file",
                               SceneDescription("cli", [path]).to_loader())
    app.init("CLI", "file", 32, 32)
    app.renderer.wait_for_textures()
    out = str(pathlib.Path(path).with_suffix(".pt.hdr"))
    app.render_offline(
        RenderSettings(output=OutputInfo(out, 32, 32, 30.0, "hdr"),
                       max_sample_count=1),
        PathTracingSettings(sample_count=1, bounce_count=3,
                            backend="brute"), PostProcessSettings())
    app.shutdown()
    return read_radiance_hdr(pathlib.Path(out).read_bytes())


@pytest.mark.parametrize("name", ["courtyard.glb", "test.obj",
                                  "cube7400.fbx"])
def test_cli_renders_a_scene_file_like_pt(tmp_path, name):
    path = FILES[name](tmp_path)
    want = _pt_app_film(str(path))
    hdr = tmp_path / "port.hdr"
    rc, _, err = _main(["render", "--scene", str(path), "--size", "32x32",
                        "--spp", "1", "--bounces", "3", "--device", "cpu",
                        "--format", "hdr", "--out", str(hdr)])
    assert rc == 0, err
    got = read_radiance_hdr(hdr.read_bytes())
    assert got.shape == (32, 32, 3) and got.max() > 0
    mse = float(np.mean((got - want) ** 2))
    assert mse < FILM_MSE, mse


def test_cli_missing_scene_file_exits_2(tmp_path):
    from pt.run import cli as jcli
    missing = str(tmp_path / "nope.glb")
    rc, _, err = _main(["render", "--scene", missing, "--device", "cpu",
                        "--out", str(tmp_path / "x.png")])
    assert rc == 2 and f"scene file not found: {missing}" in err
    jerr = io.StringIO()
    with contextlib.redirect_stderr(jerr), pytest.raises(SystemExit) as exc:
        jcli.main(["render", "--scene", missing])
    assert exc.value.code == 2 and jerr.getvalue() == err
    assert not list(tmp_path.iterdir())
