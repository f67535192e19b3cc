"""The port's configuration, scene manager and curated catalog against
`pt` on the CPU.

* `Config.create` gives `pt`'s paths for the same argv and working
  directory (flags, discovery, the "not a directory" check), except that
  it looks for Assets and Scenes in the working directory only, where
  `pt` walks up to three parents.
* `list-scenes` with `-S` (a Khronos-shaped directory of exported glbs)
  and `-A` (a stand-in at a catalog path, as `tests/test_catalog.py`
  places one) prints what `pt`'s prints.
* The catalog's 14 descriptions, `NVIDIA_ORCA_TEXTURE_MAPPING` and the
  FBX → glTF fallback resolve as `pt`'s; a registered entry loads through
  the manager into the scene `pt` loads. `CombinedSceneLoader` merges
  components by suffix with the skybox, `dx_normals` and a default camera
  as `pt`'s does.
"""

import contextlib
import io
import pathlib

import numpy as np
import pytest

from pt.core import config as jconfig
from pt_torch.convert import scene_state
from pt_torch.core.config import Config

from tests.test_torch_import import FILES, _small_courtyard, assert_same
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def pt_global_config(monkeypatch):
    """`pt`'s CLI sets its process-wide Config: keep it to this test."""
    monkeypatch.setattr(jconfig, "_global_config", None)


def _paths(cfg):
    return {k: getattr(cfg, k) for k in ("assets_path", "scenes_path")}


def _outcome(create, argv):
    try:
        return "ok", _paths(create(argv))
    except ValueError as exc:
        return "raise", str(exc)


@pytest.mark.parametrize("argv", [
    [], ["-A", "mine/A"], ["-S", "mine/S", "-L", "logs"],
    ["-C", "cache", "--scenes", "mine/S", "extra", "--unknown"],
    ["-A", "missing"], ["-S", "a_file"]], ids=lambda a: "_".join(a) or "none")
def test_config_create_equals_pt(tmp_path, monkeypatch, argv):
    """In a directory that holds Assets and Scenes, the port finds them as
    `pt` does; three directories below it, `pt` walks up to them and the
    port finds none. Flags and their errors are `pt`'s in both."""
    deep = tmp_path / "deep/er/here"
    for d in ("Assets", "Scenes", "ShaderCache"):
        (tmp_path / d).mkdir()
    for root in (tmp_path, deep):
        for d in ("mine/A", "mine/S"):
            (root / d).mkdir(parents=True)
        (root / "a_file").write_text("x")
    for cwd in (tmp_path, deep):
        monkeypatch.chdir(cwd)
        theirs = _outcome(jconfig.Config.create, argv)
        mine = _outcome(Config.create, argv)
        if cwd == deep and theirs[0] == "ok":
            theirs = ("ok", {k: None if v is not None
                             and v.parent == tmp_path else v
                             for k, v in theirs[1].items()})
        assert mine == theirs
    if not argv:          # found in the working directory
        monkeypatch.chdir(tmp_path)
        assert Config.create([]).assets_path == tmp_path / "Assets"
    theirs = {f: getattr(jconfig.Config(), f) for f in vars(Config())}
    assert vars(Config()) == theirs


def _khronos_dir(tmp_path):
    """A Scenes directory shaped like the Khronos samples: glTF/ sub
    directory, a bare .glb, a directory with no scene, a stray file."""
    from pt.scene import examples
    from pt.scene.gltf_export import export_glb
    root = tmp_path / "Scenes"
    (root / "Cubes" / "glTF").mkdir(parents=True)
    export_glb(examples.make_roughness_test_scene(),
               str(root / "Cubes" / "glTF" / "Cubes.gltf"))
    (root / "Reuse").mkdir()
    export_glb(examples.make_reuse_mesh_scene(), str(root / "Reuse" / "r.glb"))
    (root / "Empty").mkdir()
    (root / "notes.txt").write_text("not a scene")
    return root


def _assets_dir(tmp_path):
    """A stand-in under the catalog's Barcelona Pavilion path
    (`tests/test_catalog.py`), and one under an FBX entry's path as the
    .glb the fallback probes."""
    from pt.scene.examples import make_roughness_test_scene
    from pt.scene.gltf_export import export_glb
    base = tmp_path / "Assets"
    pav = base / "scenes" / "EMirageBarcelonaPavilion"
    pav.mkdir(parents=True)
    export_glb(make_roughness_test_scene(),
               str(pav / "barcelona_pavilion_day.gltf"))
    temple = base / "scenes/UE4SunTemple/SunTemple_v4/SunTemple"
    temple.mkdir(parents=True)
    export_glb(_small_courtyard(), str(temple / "SunTemple.glb"))
    return base


def _list(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def test_list_scenes_with_scenes_and_assets_equals_pt(tmp_path, monkeypatch):
    from pt.run import cli as jcli
    from pt_torch.run import cli as tcli
    scenes, assets = _khronos_dir(tmp_path), _assets_dir(tmp_path)
    monkeypatch.chdir(tmp_path)
    for argv in (["-S", str(scenes), "list-scenes"],
                 ["-A", str(assets), "list-scenes"],
                 ["-A", str(assets), "-S", str(scenes), "list-scenes"]):
        ours = _list(tcli.main, argv)
        assert ours == _list(jcli.main, argv)
    groups = [line for line in ours.splitlines() if not line[:1].isspace()]
    assert groups == ["Test Scenes", "Khronos Scenes", "High Quality Scenes"]
    assert "  Khronos Scenes/Cubes" in ours and "  Khronos Scenes/Reuse" \
        in ours and "Empty" not in ours
    assert "  High Quality Scenes/UE4 Sun Temple" in ours
    # discovered in the working directory without flags, as in pt
    assert _list(tcli.main, ["list-scenes"]) == _list(jcli.main,
                                                      ["list-scenes"])
    # a file for a directory: pt raises ValueError, the port exits 2
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert tcli.main(["-S", str(scenes / "notes.txt"),
                          "list-scenes"]) == 2
    assert "is not a directory" in err.getvalue()


def test_catalog_resolves_and_loads_as_pt(tmp_path):
    from pt.scene import catalog as jcat
    from pt.scene.manager import SceneManager as JManager
    from pt_torch.scene import catalog as tcat
    from pt_torch.scene.manager import SceneManager
    base = pathlib.Path("/nonexistent")
    jd, td = jcat._hq_descriptions(base), tcat._hq_descriptions(base)
    assert len(td) == 14 and list(td) == list(jd)
    for name in td:
        j, t = jd[name], td[name]
        assert [str(p) for p in t.paths] == [str(p) for p in j.paths]
        assert (t.skybox, t.dx_normals) == (j.skybox, j.dx_normals)
        assert scene_state(t.texture_mapping) == \
            scene_state(j.texture_mapping)
    assert scene_state(tcat.NVIDIA_ORCA_TEXTURE_MAPPING) == \
        scene_state(jcat.NVIDIA_ORCA_TEXTURE_MAPPING)

    assets = _assets_dir(tmp_path)
    empty = tmp_path / "none"
    empty.mkdir()
    jm, tm = JManager(), SceneManager()
    assert tcat.add_high_quality_scenes(tm, empty) == 0
    assert "High Quality Scenes" not in tm.groups
    assert tcat.add_high_quality_scenes(tm, assets) == \
        jcat.add_high_quality_scenes(jm, assets) == 2
    assert list(tm.groups["High Quality Scenes"]) == \
        list(jm.groups["High Quality Scenes"])
    # the manager's Config gives the assets path when none is passed
    cm = SceneManager(Config(assets_path=assets))
    assert list(cm.groups["High Quality Scenes"]) == \
        list(tm.groups["High Quality Scenes"])
    for name in tm.groups["High Quality Scenes"]:
        jm.set_active_scene("High Quality Scenes", name, blocking=True)
        tm.set_active_scene("High Quality Scenes", name, blocking=True)
        js, ts = jm.get_active_scene(), tm.get_active_scene()
        assert ts is not None and ts.name == name
        assert_same(scene_state(js), scene_state(ts))


def test_combined_loader_equals_pt(tmp_path):
    """Three components by suffix (glb, obj, fbx), an HDR skybox, the
    texture remap, DX normals and a default camera."""
    from pt.core.camera import InputCamera as JCamera
    from pt.out.saver import write_radiance_hdr
    from pt.scene.builder import SceneBuilder as JBuilder
    from pt.scene.catalog import NVIDIA_ORCA_TEXTURE_MAPPING as JMAP
    from pt.scene.manager import SceneDescription as JDesc
    from pt_torch.core.camera import InputCamera as TCamera
    from pt_torch.scene.builder import SceneBuilder as TBuilder
    from pt_torch.scene.catalog import NVIDIA_ORCA_TEXTURE_MAPPING as TMAP
    from pt_torch.scene.manager import SceneDescription as TDesc
    paths = []
    for name in ("reuse_mesh.glb", "test.obj", "cube7400.fbx"):
        (tmp_path / name[:-4]).mkdir()
        paths.append(FILES[name](tmp_path / name[:-4]))
    sky = tmp_path / "sky.hdr"
    write_radiance_hdr(str(sky), np.linspace(0, 3, 96, dtype=np.float32)
                       .reshape(4, 8, 3))
    states = []
    for desc, builder, cam, mapping in (
            (JDesc, JBuilder, JCamera, JMAP), (TDesc, TBuilder, TCamera,
                                               TMAP)):
        loader = desc("c", paths, skybox=str(sky), texture_mapping=mapping,
                      dx_normals=True).to_loader()
        loader.default_camera = cam(50.0, 0.1, 100.0, (1, 2, 3), (0, 0, 1))
        b = builder("c")
        loader.load(b)
        states.append(scene_state(b.create_scene()))
        assert desc("m", paths + [tmp_path / "gone.glb"]).to_loader() is None
        assert desc("s", paths, skybox=str(tmp_path / "no.hdr")) \
            .to_loader().skybox_path is None
    assert_same(*states)
    assert states[1]["texture_mapping"]["dx_normals"] is True
    assert states[1]["skybox"]["kind"] == "SkyboxKind.EQUIRECT"
