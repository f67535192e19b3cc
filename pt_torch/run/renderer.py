"""Frame orchestrator: the progressive wavefront render of a scene.

Port of `pt.run.renderer.Renderer`: it owns the device scene, textures,
acceleration structure and accumulation film. `_ensure_accel` builds the
structure. A static scene gets the native SBVH at block 32 collapsed to BF8
(kernels K1/K2), with opaque and alpha subset trees when it has
alpha-tested triangles, and the binary SBVH tree (K3/K4) when the collapse
does not fit. A static scene whose `instancing` policy selects it gets the
shared-BLAS structure instead (`BF8Instanced`, kernels K5/K6): one
object-space page set per unique mesh under a world-space top tree, with
instanced subset trees on an alpha scene; where that build is infeasible
the scene is flattened as above. A scene with animated instances or skinned
geometry gets the Morton `PacketBVH`, rebuilt on the device after every
`update_scene_data(scene_changed=True)` (K3/K4). `render(samples)` traces
the samples one at a time, each a full-film wavefront through raygen,
`bounce_count` bounces (a closest and a shadow trace per bounce, more on an
alpha scene) and the film scatter-add. Lanes are tile-ordered
(`_tile_order`) so each run of neighbouring rays covers a compact square of
pixels.

`pt` gives the same film with wavefront compaction on or off and with
spp-major groups; this port runs the uncompacted per-sample loop. Nothing
in a render step reads a device value back: the ray counts stay on the
device until `rays_traced` is read.

For the offline path and the app: `set_settings` (a change resets the
film) and `save_checkpoint` / `load_checkpoint` in `pt`'s `.npz` keys.
Each sample seeds its RNG from (pixel, total samples so far), so a
resumed render continues the exact RNG stream.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pt_torch import default_device
from pt_torch.accel.bvh8 import build_bf8, build_packet_bvh_sah
from pt_torch.post.pipeline import PostProcessSettings, postprocess
from pt_torch.render.integrator import (Accel, AlphaSplit,
                                        PathTracingSettings, _finite_or_zero,
                                        bounce_once, init_rng_state,
                                        prepare_accel, prepare_attribs,
                                        raygen, start_carry)
from pt_torch.render.textures import DeviceTextures, default_texture_pool
from pt_torch.scene.builder import Scene
from pt_torch.accel.instanced import (build_instanced_bf8,
                                      build_instanced_split)
from pt_torch.scene.flatten import (DeviceScene, flatten_scene,
                                    shared_dup_ratio, shared_mesh_layout,
                                    update_seg_transforms)
from pt_torch.scene.textures import build_scene_textures


def _tile_order(width: int, height: int, tile: int = 32) -> np.ndarray:
    """Pixel visit order grouping 32x32 tiles: each run of 1024 lanes then
    covers a compact square tile instead of a thin scanline strip."""
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    lin = (ys * width + xs)
    ty, iy = np.divmod(ys, tile)
    tx, ix = np.divmod(xs, tile)
    tiles_x = (width + tile - 1) // tile
    key = ((ty * tiles_x + tx) * tile + iy) * tile + ix
    return lin.reshape(-1)[np.argsort(key.reshape(-1), kind="stable")]


class Renderer:
    """Progressive wavefront renderer for one scene."""

    def __init__(self, settings: Optional[PathTracingSettings] = None,
                 post: Optional[PostProcessSettings] = None,
                 device=None, mesh=None, instancing: str = "auto"):
        """`device`: None → `cuda:0` (raises without a card); "cpu" runs
        the kernels' plain versions. `instancing`: the shared-BLAS policy
        for static scenes: "auto" switches to the instanced structure when
        geometry reuse is heavy (see `_want_instanced`), "shared" forces it
        where it is feasible, "flatten" disables it. `mesh` (multi-device
        film sharding) is a later slice of the port: a mesh raises."""
        self.device = default_device(device)
        self.mesh = mesh
        self.instancing = instancing
        self.settings = settings or PathTracingSettings()
        self.post = post or PostProcessSettings()
        self.width = 0
        self.height = 0
        self.ds: Optional[DeviceScene] = None
        self.tex: Optional[DeviceTextures] = None
        self.accel: Optional[Accel] = None
        self.scene: Optional[Scene] = None
        self.accum: Optional[torch.Tensor] = None   # (H, W, 3) f32 film
        self.total_samples = 0
        # ray counter: per-sample 0-d device tensors, folded into a host
        # int only when read
        self._rays_chunks: list = []
        self._rays_host = 0
        self.camera_index = 0
        self._px = self._py = self._film_perm = None
        self._accel_dirty = True

    # -- scene management --------------------------------------------------
    def set_scene(self, scene: Scene,
                  tex: Optional[DeviceTextures] = None) -> None:
        """Upload a new scene (≙ Renderer::UpdateSceneData). Without `tex`
        the pool is built from the scene's textures (in-memory pixels)."""
        self.scene = scene
        self.ds = flatten_scene(scene, device=self.device)
        if tex is not None:
            self.tex = tex
        elif scene.textures:
            self.tex = build_scene_textures(scene, device=self.device)
        else:
            self.tex = default_texture_pool(device=self.device)
        self._accel_dirty = True
        self.reset_accumulation()

    def update_scene_data(self, scene_changed: bool = False) -> None:
        """Per frame: after `scene.update(dt)` moved something, refresh the
        animated transforms, mark the accel for its rebuild and reset the
        accumulation."""
        if self.scene is None:
            raise RuntimeError("no scene set")
        if scene_changed:
            self.ds = update_seg_transforms(self.ds, self.scene)
            self._accel_dirty = True
            self.reset_accumulation()

    def on_resize(self, width: int, height: int) -> None:
        if (self.width, self.height) == (width, height):
            return
        self.width, self.height = width, height
        ys, xs = np.meshgrid(np.arange(height, dtype=np.int64),
                             np.arange(width, dtype=np.int64), indexing="ij")
        order = _tile_order(width, height)
        self._px = torch.as_tensor(xs.reshape(-1)[order], device=self.device)
        self._py = torch.as_tensor(ys.reshape(-1)[order], device=self.device)
        self._film_perm = torch.as_tensor(order.astype(np.int64),
                                          device=self.device)
        self.reset_accumulation()

    def set_settings(self, settings: Optional[PathTracingSettings] = None,
                     post: Optional[PostProcessSettings] = None) -> None:
        """≙ Renderer::SetSettings (Renderer.cpp:825-852): a change of the
        path-tracing settings resets the accumulation. (`pt` also rebuilds
        its accel when its backend or leaf size changes; the port's
        settings have neither.)"""
        if settings is not None and settings != self.settings:
            self.settings = settings
            self.reset_accumulation()
        if post is not None:
            self.post = post

    def reset_accumulation(self) -> None:
        """≙ ResetAccumulationImage (Renderer.cpp:801-808)."""
        if self.width and self.height:
            self.accum = torch.zeros((self.height, self.width, 3),
                                     dtype=torch.float32, device=self.device)
        self.total_samples = 0
        self._rays_chunks = []
        self._rays_host = 0

    @staticmethod
    def _want_instanced(mode: str, dup_ratio: float, n_tris: int) -> bool:
        """pt's shared-BLAS selection policy: "auto" switches at heavy
        reuse (>= 4x) of at least 200k flattened triangles."""
        if mode == "flatten":
            return False
        if mode == "shared":
            return True
        return dup_ratio >= 4.0 and n_tris >= 200_000

    def _build_instanced(self, tri_np, opq_np, build_static, base):
        """Shared-BLAS Accel for the current scene, or None → flatten.

        Opaque scenes: one BF8Instanced with the global-id remap. Alpha
        scenes: `build_instanced_split` gives the full tree (root bounds)
        plus instanced opaque/alpha subset trees for the AlphaSplit scheme;
        a subset whose instanced build is infeasible gets a flat subset
        tree from `build_static` (hybrid: the duplicated bytes of a small
        subset are acceptable). Wholly opaque or wholly alpha content has
        no split: the single-tree loops walk the full instanced tree, as
        they do when a subset has no tree at all."""
        layout = shared_mesh_layout(self.scene)
        if layout is None:
            return None
        meshes, seg_mesh, seg_base, _dup = layout
        st = self.ds.seg_transform.cpu().numpy().astype(np.float64)
        if not self.ds.has_alpha:
            inst = build_instanced_bf8(meshes, seg_mesh, st,
                                       seg_tri_base=seg_base,
                                       device=self.device)
            if inst is None:
                return None
            return base._replace(bvh=inst, alpha_split=None)
        out = build_instanced_split(meshes, seg_mesh, st, seg_base,
                                    device=self.device)
        if out is None:
            return None
        full, (tree_o, sel_o), (tree_a, sel_a) = out
        split = None
        if len(sel_o) and len(sel_a):
            if tree_o is None:
                tree_o = build_static(tri_np[sel_o], opq_np[sel_o])
            if tree_a is None:
                tree_a = build_static(tri_np[sel_a], opq_np[sel_a])
            if tree_o is not None and tree_a is not None:
                t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
                split = AlphaSplit(tree_o, t(sel_o), tree_a, t(sel_a))
        return base._replace(bvh=full, alpha_split=split)

    def _ensure_accel(self) -> None:
        """Build the acceleration structure when the scene changed
        (≙ pt's `_ensure_accel`). Animated scenes: the Morton tree, on the
        device. Static scenes: the shared-BLAS structure when the
        instancing policy selects it and it is feasible, else the host SBVH
        build, BF8 where it fits; either with opaque/alpha split trees on
        an alpha scene."""
        if not (self._accel_dirty or self.accel is None):
            return
        if self.mesh is not None:
            raise NotImplementedError(
                "multi-device film sharding is a later slice of the port")
        if (self.scene.has_animated_instances
                or self.scene.has_skinned_geometry):
            self.accel = prepare_accel(self.ds)
            self._accel_dirty = False
            return
        tri_np = self.ds.tri_idx.cpu().numpy()
        base = prepare_attribs(self.ds)
        wpos_np = base.wpos.cpu().numpy()
        opq_np = self.ds.tri_opaque.cpu().numpy()

        def build_static(rows, opq_rows):
            """SBVH at block 32 collapsed to BF8; when the collapse gives
            None (a single leaf, or over pt's budget), the binary SBVH tree
            at the default block, walked by K3/K4."""
            fine = build_packet_bvh_sah(wpos_np, rows, block=32,
                                        max_leaves=8192,
                                        tri_opaque_np=opq_rows, spatial=True,
                                        device=self.device)
            bvh = build_bf8(fine) if fine is not None else None
            if bvh is None:
                bvh = build_packet_bvh_sah(wpos_np, rows,
                                           tri_opaque_np=opq_rows,
                                           spatial=True, device=self.device)
            return bvh

        # shared-BLAS arm: the policy gates on counts first, so a scene it
        # rejects never pays for the layout's copies
        if self.instancing != "flatten":
            dup = shared_dup_ratio(self.scene)
            if dup is not None and self._want_instanced(
                    self.instancing, dup[0], int(tri_np.shape[0])):
                inst_accel = self._build_instanced(tri_np, opq_np,
                                                   build_static, base)
                if inst_accel is not None:
                    self.accel = inst_accel
                    self._accel_dirty = False
                    return
                # infeasible (capacity or singular transform): flatten

        bvh = build_static(tri_np, opq_np)
        if bvh is None:
            # no static tree fits pt's node budget: the Morton tree
            self.accel = prepare_accel(self.ds)
            self._accel_dirty = False
            return
        split = None
        if opq_np.any() and (~opq_np).any():
            # opaque/alpha partition for the any-hit emulation loops: the
            # re-trace rounds walk a tree over the non-opaque subset only
            sel_o = np.nonzero(opq_np)[0].astype(np.int32)
            sel_a = np.nonzero(~opq_np)[0].astype(np.int32)
            bvh_o = build_static(tri_np[sel_o], opq_np[sel_o])
            bvh_a = build_static(tri_np[sel_a], opq_np[sel_a])
            # pt traces a subset without a tree by brute force; the port
            # has no brute backend, so such a scene keeps the single tree
            if bvh_o is not None and bvh_a is not None:
                t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
                split = AlphaSplit(bvh_o, t(sel_o), bvh_a, t(sel_a))
        self.accel = base._replace(bvh=bvh, alpha_split=split)
        self._accel_dirty = False

    # -- rendering ---------------------------------------------------------
    def render(self, samples: Optional[int] = None) -> int:
        """One progressive accumulation step: trace `samples` (default
        settings.sample_count) full paths per pixel and add them to the
        film. Returns the new total sample count."""
        if self.ds is None or not self.width:
            raise RuntimeError("scene or film not initialized")
        self._ensure_accel()
        inv_view, inv_proj = self._camera_mats()
        samples = samples if samples is not None else self.settings.sample_count
        flat = self.accum.view(-1, 3)
        for rep in range(samples):
            frame = (self.total_samples + rep) & 0xFFFFFFFF
            state = init_rng_state(self._px, self._py, self.width, frame)
            state, o, d, diff = raygen(self._px, self._py, self.width,
                                       self.height, inv_view, inv_proj,
                                       state, self.settings)
            carry = start_carry(state, o, d, diff)
            for bounce in range(self.settings.bounce_count):
                carry = bounce_once(self.ds, self.tex, self.accel, carry,
                                    self.settings, bounce)
            flat.index_add_(0, self._film_perm,
                            _finite_or_zero(carry.radiance))
            self._rays_chunks.append(carry.rays)
        self.total_samples += samples
        return self.total_samples

    def _camera_mats(self):
        cams = self.scene.cameras
        cam = cams[self.camera_index if 0 <= self.camera_index < len(cams)
                   else 0]
        cam.on_resize(self.width, self.height)
        t = lambda m: torch.as_tensor(np.asarray(m, np.float32),  # noqa: E731
                                      device=self.device)
        return t(cam.inv_view), t(cam.inv_proj)

    def film_mean(self) -> np.ndarray:
        """Linear per-pixel mean radiance (host)."""
        return self.accum.cpu().numpy() / max(self.total_samples, 1)

    def snapshot(self, hdr: bool = False) -> np.ndarray:
        """Resolve the film through the post stack → float image (host).
        `hdr=True` (HDR10 PQ encoding) is queue 1, item 4 of the port."""
        if hdr:
            raise NotImplementedError("HDR10 output comes with queue 1, "
                                      "item 4 of the port")
        out = postprocess(self.accum, float(max(self.total_samples, 1)),
                          self.post)
        return out.cpu().numpy()

    @property
    def rays_traced(self) -> int:
        """Useful rays traced since the last reset (`pt`'s count: live
        lanes of every closest trace plus every traced shadow ray)."""
        self._rays_host += sum(int(c) for c in self._rays_chunks)
        self._rays_chunks = []
        return self._rays_host

    # -- checkpoint / resume ------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Persist the accumulation film + counters in `pt`'s keys; a
        resumed render continues the exact RNG stream (seeding is (pixel,
        total_samples))."""
        np.savez(path, accum=self.accum.cpu().numpy(),
                 total_samples=self.total_samples,
                 rays_total=self.rays_traced,
                 width=self.width, height=self.height)

    def load_checkpoint(self, path: str) -> None:
        with np.load(path) as data:
            self.on_resize(int(data["width"]), int(data["height"]))
            self.accum = torch.as_tensor(data["accum"], device=self.device)
            self.total_samples = int(data["total_samples"])
            self._rays_host = int(data["rays_total"])
        self._rays_chunks = []
