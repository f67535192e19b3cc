"""The plain reference: a configuration's scene, rebuilt from its recorded
inputs, traced pixel by pixel by brute force.

Nothing here imports the port, nor takes anything it built: the scene is
replayed from the benchmark's own recorded calls onto this folder's copy of
the builder, flattened and given its texture pool by this folder's copies,
and every trace tests every triangle. A pixel's sample depends only on the
pixel, its frame index and the scene, so any set of pixels can be traced
without the rest of the film.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from portbench.lib.namespaces import reference_namespace
from portbench.lib.scenecache import replay
from portbench.reference.flatten import flatten_scene, update_seg_transforms
from portbench.reference.integrator import (BruteTriangles,
                                            PathTracingSettings,
                                            _finite_or_zero, bounce_once,
                                            init_rng_state,
                                            make_alpha_split_brute,
                                            prepare_attribs, raygen,
                                            start_carry)
from portbench.reference.post import PostProcessSettings, postprocess
from portbench.reference.texpool import build_scene_textures

_MASK32 = 0xFFFFFFFF
# (pixel, frame) lanes traced together
_LANES = 1 << 16


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to bfloat16, kept in float32 (the control's storage)."""
    return t.to(torch.bfloat16).to(torch.float32)


class ReferenceScene:
    """A configuration's scene as the reference holds it: built from the
    recorded calls, flattened on `device`, with its texture pool."""

    def __init__(self, calls, name: str, settings: dict, device,
                 lowp: bool = False):
        ns = reference_namespace()
        builder = ns.SceneBuilder(name)
        replay(calls, builder, ns)
        self.scene = builder.create_scene()
        self.device = torch.device(device)
        self.settings = PathTracingSettings(**{
            k: v for k, v in settings.items()
            if k in PathTracingSettings.__dataclass_fields__})
        self.lowp = lowp
        self.ds = flatten_scene(self.scene, device=self.device)
        self.tex = build_scene_textures(self.scene.textures,
                                        device=self.device)
        self._accel = None

    def advance(self, dts: Sequence[float]) -> None:
        """Step the animation by each of `dts` in turn, as the port's
        `scene.update` + `update_scene_data` do."""
        for dt in dts:
            if self.scene.update(dt):
                self.ds = update_seg_transforms(self.ds, self.scene)
                self._accel = None

    def accel(self):
        """World-space triangle rows and brute-force structures; a static
        alpha scene gets the opaque/alpha split (the port's static scenes
        do), an animated one none (its Morton tree has none)."""
        if self._accel is None:
            base = prepare_attribs(self.ds)
            if self.lowp:
                base = base._replace(**{
                    f: _bf16(getattr(base, f))
                    for f in ("wpos", "tri_pos", "tri_nrm", "tri_tan",
                              "tri_bit", "tri_uv")})
            split = (None if self.scene.has_animated_instances
                     else make_alpha_split_brute(self.ds, base.wpos))
            self._accel = base._replace(
                bvh=BruteTriangles(base.wpos, self.ds.tri_idx),
                alpha_split=split)
        return self._accel

    def camera(self, width: int, height: int):
        cam = self.scene.cameras[0]
        cam.on_resize(width, height)
        t = lambda m: torch.as_tensor(np.asarray(m, np.float32),  # noqa: E731
                                      device=self.device)
        return t(cam.inv_view), t(cam.inv_proj)

    def _trace(self, px, py, frames, width, height):
        """One sample of each lane (px, py, frame): its radiance, NaN/Inf
        zeroed."""
        inv_view, inv_proj = self.camera(width, height)
        accel = self.accel()
        state = init_rng_state(px, py, width, frames & _MASK32)
        state, o, d, diff = raygen(px, py, width, height, inv_view, inv_proj,
                                   state, self.settings)
        carry = start_carry(state, o, d, diff)
        for bounce in range(self.settings.bounce_count):
            carry = bounce_once(self.ds, self.tex, accel, carry,
                                self.settings, bounce)
            if self.lowp:
                carry = carry._replace(
                    origin=_bf16(carry.origin),
                    direction=_bf16(carry.direction),
                    throughput=_bf16(carry.throughput),
                    radiance=_bf16(carry.radiance))
        return _finite_or_zero(carry.radiance)

    def film(self, xs: np.ndarray, ys: np.ndarray, frames: Sequence[int],
             width: int, height: int) -> np.ndarray:
        """The film at pixels (xs, ys) after one sample at each frame index
        of `frames`, added in that order from zero: (P, 3) float32."""
        dev = self.device
        xs_t = torch.as_tensor(np.asarray(xs, np.int64), device=dev)
        ys_t = torch.as_tensor(np.asarray(ys, np.int64), device=dev)
        frames = np.asarray(frames, np.int64)
        acc = torch.zeros((len(xs), 3), dtype=torch.float32, device=dev)
        per = max(1, _LANES // max(len(xs), 1))
        for f0 in range(0, len(frames), per):
            fr = torch.as_tensor(frames[f0:f0 + per], device=dev)
            k = fr.shape[0]
            rad = self._trace(xs_t.repeat(k), ys_t.repeat(k),
                              fr.repeat_interleave(len(xs)), width, height)
            for r in rad.view(k, len(xs), 3):
                acc = acc + r
        return acc.cpu().numpy()

    def post(self, film: torch.Tensor, total_samples: int,
             settings: Optional[PostProcessSettings] = None) -> np.ndarray:
        """The SDR image of a whole (H, W, 3) film through the post stack
        (the control: its input and output rounded to bfloat16)."""
        settings = settings or PostProcessSettings()
        film = _bf16(film) if self.lowp else film
        out = postprocess(film, float(max(total_samples, 1)), settings)
        return (_bf16(out) if self.lowp else out).cpu().numpy()
