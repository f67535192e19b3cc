"""Plain reference: a frozen copy of pt_torch/render/textures.py (quad rows
only) with the in-memory path of pt_torch/scene/textures.py (textures
prepared on threads), which the port may change without moving the
yardstick.

Device texture pool: flat texel buffer + per-(texture, mip) offset table.

Port of `pt.render.textures`. All textures live in one flat texel pool; a
(NT, MAX_MIPS) offset table and a (NT, MAX_MIPS, 2) size table locate each
mip. The pool layout is `pt`'s default: bf16 quad rows of shape (P, 16),
each row holding the four repeat-wrap bilinear corners
[(x,y), (x+1,y), (x,y+1), (x+1,y+1)] of one texel, so a bilinear fetch is
one row gather. Pools with HDR-range texels keep f32 rows.

Filtering: bilinear per mip + linear mip blend (trilinear), LOD from the
ray-differential UV derivatives like textureGrad; repeat wrap.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from portbench.reference.device import default_device

MAX_MIPS = 14   # up to 8192x8192
# threads that prepare textures and rows (numpy releases the GIL)
_THREADS = 8


@dataclasses.dataclass
class DeviceTextures:
    data: torch.Tensor        # (P, 16) quad rows
    offsets: torch.Tensor     # (NT, MAX_MIPS) i32 texel offset of each mip
    sizes: torch.Tensor       # (NT, MAX_MIPS, 2) i32 (w, h) per mip
    mip_counts: torch.Tensor  # (NT,) i32
    # every texture is a 1x1 constant: sampling is one gather per lookup
    all_constant: bool = False
    quad: bool = True

    @property
    def count(self) -> int:
        return self.offsets.shape[0]


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 decode (≙ hardware sRGB sampling)."""
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _downsample2x(img: np.ndarray) -> np.ndarray:
    """Box-filter 2x downsample (≙ the blit-based mip generation)."""
    h, w = img.shape[:2]
    nh, nw = max(1, h // 2), max(1, w // 2)
    img = img[:nh * 2 if h > 1 else 1, :nw * 2 if w > 1 else 1]
    img = img.reshape(nh, -1, nw, img.shape[1] // nw, img.shape[-1])
    return img.mean(axis=(1, 3))


def build_mip_chain(pixels: np.ndarray) -> List[np.ndarray]:
    """Full mip pyramid down to 1x1."""
    mips = [pixels.astype(np.float32)]
    while mips[-1].shape[0] > 1 or mips[-1].shape[1] > 1:
        mips.append(_downsample2x(mips[-1]))
    return mips[:MAX_MIPS]


def prepare_texture(pixels: np.ndarray, srgb: bool = False,
                    generate_mips: bool = True) -> List[np.ndarray]:
    """The linear RGBA mip chain of one texture, as the pool builder's
    `add` makes it (a pure function: textures may be prepared in
    parallel)."""
    pixels = np.asarray(pixels, np.float32)
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    if pixels.shape[-1] == 1:                      # gray → RGB
        pixels = np.repeat(pixels, 3, axis=-1)
    elif pixels.shape[-1] == 2:                    # gray+alpha
        pixels = np.concatenate(
            [np.repeat(pixels[..., :1], 3, axis=-1), pixels[..., 1:]], -1)
    if pixels.shape[-1] == 3:
        pixels = np.concatenate([pixels, np.ones_like(pixels[..., :1])], -1)
    if pixels.shape[-1] != 4:
        raise ValueError(f"texel rows must have 4 channels, got "
                         f"{pixels.shape}")
    if srgb:
        pixels = np.concatenate([srgb_to_linear(pixels[..., :3]),
                                 pixels[..., 3:]], -1)
    return build_mip_chain(pixels) if generate_mips else [pixels]


def _quad_rows(m: np.ndarray) -> np.ndarray:
    """Each texel's repeat-wrap bilinear corners in one 16-wide row."""
    rx = np.roll(m, -1, axis=1)
    ry = np.roll(m, -1, axis=0)
    rxy = np.roll(rx, -1, axis=0)
    return np.concatenate([m, rx, ry, rxy], axis=-1).reshape(-1, 16)


class TexturePoolBuilder:
    """Accumulates decoded textures into the flat pool of quad rows."""

    def __init__(self):
        self._levels: List[np.ndarray] = []      # (H, W, 4) f32 per mip
        self._offsets: List[np.ndarray] = []
        self._sizes: List[np.ndarray] = []
        self._mip_counts: List[int] = []
        self._cursor = 0
        self._has_hdr = False

    def _push_level(self, m: np.ndarray) -> None:
        self._levels.append(np.ascontiguousarray(m, np.float32))
        self._cursor += m.shape[0] * m.shape[1]

    def _note_range(self, pixels: np.ndarray) -> None:
        """Float/HDR-sourced texels (outside [0,1]) make the pool keep f32
        rows, as the reference keeps RGBAF32 textures in f32 storage."""
        if not self._has_hdr and pixels.size:
            if float(pixels[..., :3].max(initial=0.0)) > 1.0 + 1e-3:
                self._has_hdr = True

    def add(self, pixels: np.ndarray, srgb: bool = False,
            generate_mips: bool = True) -> int:
        """pixels: (H, W, 4) float in [0,1] (or any float range for HDR).
        Returns the texture-table index."""
        return self.add_prepared(prepare_texture(pixels, srgb,
                                                 generate_mips))

    def add_prepared(self, mips: List[np.ndarray]) -> int:
        """A texture whose linear RGBA mips `prepare_texture` made."""
        self._note_range(mips[0])
        offsets = np.zeros(MAX_MIPS, np.int32)
        sizes = np.zeros((MAX_MIPS, 2), np.int32)
        for i, m in enumerate(mips):
            offsets[i] = self._cursor
            sizes[i] = (m.shape[1], m.shape[0])
            self._push_level(m)
        for i in range(len(mips), MAX_MIPS):
            offsets[i] = offsets[len(mips) - 1]
            sizes[i] = sizes[len(mips) - 1]
        self._offsets.append(offsets)
        self._sizes.append(sizes)
        self._mip_counts.append(len(mips))
        return len(self._mip_counts) - 1

    def build(self, dtype=None, device=None) -> DeviceTextures:
        """Quad rows: bf16, or f32 when any texture carried HDR-range
        texels; bf16 rounds to nearest even, on either device."""
        dev = default_device(device)
        sizes = np.stack(self._sizes)
        if dtype is None:
            dtype = torch.float32 if self._has_hdr else torch.bfloat16
        with ThreadPoolExecutor(_THREADS) as pool:
            texels = list(pool.map(_quad_rows, self._levels))
        data = torch.from_numpy(np.ascontiguousarray(
            np.concatenate(texels, axis=0), np.float32)).to(dev).to(dtype)
        return DeviceTextures(
            data=data,
            offsets=torch.as_tensor(np.stack(self._offsets), device=dev),
            sizes=torch.as_tensor(sizes, device=dev),
            mip_counts=torch.as_tensor(
                np.asarray(self._mip_counts, np.int32), device=dev),
            all_constant=bool((sizes[:, 0] == 1).all()),
            quad=True,
        )


def add_default_textures(builder: TexturePoolBuilder) -> None:
    """Slots 0..8 with the reference's exact 1x1 texels
    (ShaderRendererTypes.incl:49-56; placeholder slot 8 reuses white)."""
    def const(rgba):
        builder.add(np.asarray(rgba, np.float32).reshape(1, 1, 4),
                    srgb=False, generate_mips=False)
    half = 128.0 / 255.0
    const([1, 1, 1, 1])                 # 0 color (white)
    const([half, half, 1, 1])           # 1 normal (0x80,0x80,0xff)
    const([1, 1, 1, 1])                 # 2 roughness
    const([1, 1, 1, 1])                 # 3 metalness
    const([0, 0, 0, 0])                 # 4 emissive (black)
    const([1, 1, 1, 1])                 # 5 specular
    const([0, 0, 0, 0])                 # 6 glossiness
    const([0, 0, 0, 0])                 # 7 shininess
    const([1, 1, 1, 1])                 # 8 placeholder


def _bilinear_at_level(tex: DeviceTextures, tex_idx, uv, level):
    """Bilinear fetch of one mip level. tex_idx (N,), uv (N,2), level (N,).
    Texture indices and levels are clamped to the tables, as JAX clamps
    out-of-range gathers."""
    tex_idx = torch.clamp(tex_idx.long(), 0, tex.count - 1)
    level = torch.clamp(level.long(), 0, MAX_MIPS - 1)
    off = tex.offsets[tex_idx, level].long()                # (N,)
    size = tex.sizes[tex_idx, level].long()                 # (N, 2)
    w = size[..., 0].to(torch.float32)
    h = size[..., 1].to(torch.float32)
    # repeat wrap, half-texel center convention
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    wi = size[..., 0]
    hi = size[..., 1]
    rows_max = tex.data.shape[0] - 1

    def row(xi, yi):
        xi = torch.remainder(xi.to(torch.int32).long(), wi)
        yi = torch.remainder(yi.to(torch.int32).long(), hi)
        return torch.clamp(off + yi * wi + xi, 0, rows_max)

    rows = tex.data[row(x0, y0)].to(torch.float32)          # (N, 16)
    c00, c10 = rows[..., 0:4], rows[..., 4:8]
    c01, c11 = rows[..., 8:12], rows[..., 12:16]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def sample_texture_grad(tex: DeviceTextures, tex_idx, uv, dudx_dvdx=None,
                        dudy_dvdy=None, nearest_mip: bool = False):
    """Trilinear sample with LOD from UV derivatives (≙ textureGrad).

    tex_idx (N,) int, uv (N,2). Derivatives (N,2) each or None for level 0.
    Returns (N,4) linear texels. `nearest_mip` samples the rounded level
    only (the incoherent-tail path of `pt`).
    """
    if tex.all_constant:
        # 1x1 constants: one gather, no filtering
        idx = torch.clamp(tex_idx.long(), 0, tex.count - 1)
        texel = tex.data[tex.offsets[idx, 0].long()]
        return texel[..., :4].to(torch.float32)
    tex_idx = torch.clamp(tex_idx.long(), 0, tex.count - 1)
    mip_count = tex.mip_counts[tex_idx]
    if dudx_dvdx is None:
        return _bilinear_at_level(tex, tex_idx, uv,
                                  torch.zeros_like(tex_idx))
    size0 = tex.sizes[tex_idx, 0].to(torch.float32)         # (N, 2)
    px = dudx_dvdx * size0
    py = dudy_dvdy * size0
    rho = torch.sqrt(torch.maximum(torch.sum(px * px, -1),
                                   torch.sum(py * py, -1)))
    level = torch.log2(torch.clamp(rho, min=1e-12))
    level = torch.clamp(level, min=0.0)
    level = torch.minimum(level, (mip_count - 1).to(torch.float32))
    if nearest_mip:
        near = torch.round(level).to(torch.int32)
        return _bilinear_at_level(tex, tex_idx, uv, near)
    lo = torch.floor(level).to(torch.int32)
    hi = torch.minimum(lo + 1, mip_count - 1)
    frac = (level - lo.to(torch.float32))[..., None]
    a = _bilinear_at_level(tex, tex_idx, uv, lo)
    b = _bilinear_at_level(tex, tex_idx, uv, hi)
    return a * (1 - frac) + b * frac


# --- the scene's pool (copy of `pt_torch.scene.textures`'s in-memory path) --

MAX_TEXTURE_SIZE = 4096            # the port's `Config.max_texture_size`
TEXTURE_MEMORY_BUDGET = 2 << 30    # the port's `Config.texture_memory_budget`


def load_texture_pixels(info) -> np.ndarray:
    """An in-memory texture as (H, W, 4) float32: gray and gray+alpha
    expand to RGB(A), RGB gains alpha = 1, integer sources are normalised
    by their dtype."""
    raw = np.asarray(info.pixels)
    px = raw.astype(np.float32)
    if px.ndim == 2:
        px = px[..., None]
    if px.shape[-1] == 1:
        px = np.repeat(px, 3, axis=-1)
    elif px.shape[-1] == 2:
        px = np.concatenate(
            [np.repeat(px[..., :1], 3, axis=-1), px[..., 1:]], -1)
    if px.shape[-1] == 3:
        px = np.concatenate([px, np.ones_like(px[..., :1])], -1)
    if raw.dtype == np.uint8:
        px = px / 255.0
    elif raw.dtype == np.uint16:
        px = px / 65535.0
    return px


def _downscale_to(pixels: np.ndarray, max_dim: int) -> np.ndarray:
    """Repeated 2x box downsample until both dims <= max_dim."""
    while max(pixels.shape[0], pixels.shape[1]) > max_dim:
        pixels = _downsample2x(pixels)
    return pixels


def _budget_max_dim(sizes) -> int:
    """Shrink the size cap until the estimated pool (32 bytes a texel,
    times 4/3 for the mips) fits the memory budget."""
    max_dim = MAX_TEXTURE_SIZE
    bytes_per_texel = 32 * 4 // 3
    while max_dim > 64:
        total = 0
        for w, h in sizes:
            total += min(w, max_dim) * min(h, max_dim) * bytes_per_texel
        if total <= TEXTURE_MEMORY_BUDGET:
            break
        max_dim //= 2
    return max_dim


def build_scene_textures(textures, device=None) -> DeviceTextures:
    """The pool of a scene whose textures are all in-memory pixels: the
    defaults in slots 0..8, then the scene's textures in order, each capped
    by the memory budget's size and given its generated mips."""
    max_dim = _budget_max_dim(
        [(t.pixels.shape[1], t.pixels.shape[0]) for t in textures])
    builder = TexturePoolBuilder()
    add_default_textures(builder)

    def prepare(info):
        return prepare_texture(_downscale_to(load_texture_pixels(info),
                                             max_dim), srgb=info.is_srgb)
    with ThreadPoolExecutor(_THREADS) as pool:
        for mips in pool.map(prepare, textures):
            builder.add_prepared(mips)
    return builder.build(device=device)
