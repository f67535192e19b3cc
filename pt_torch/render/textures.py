"""Device texture pool: flat texel buffer + per-(texture, mip) offset table.

Port of `pt.render.textures`. All textures live in one flat texel pool; a
(NT, MAX_MIPS) offset table and a (NT, MAX_MIPS, 2) size table locate each
mip. The default pool layout is `pt`'s: bf16 quad rows of shape (P, 16),
each row holding the four repeat-wrap bilinear corners
[(x,y), (x+1,y), (x,y+1), (x+1,y+1)] of one texel, so a bilinear fetch is
one row gather. Pools with HDR-range texels keep f32 rows; `paired` (P, 8)
and flat (P, 4) rows stay available as explicit layouts.

Filtering: bilinear per mip + linear mip blend (trilinear), LOD from the
ray-differential UV derivatives like textureGrad; repeat wrap.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from pt_torch import default_device

MAX_MIPS = 14   # up to 8192x8192


@dataclasses.dataclass
class DeviceTextures:
    data: torch.Tensor        # (P, 16) quad rows (or (P, 8) paired, (P, 4) flat)
    offsets: torch.Tensor     # (NT, MAX_MIPS) i32 texel offset of each mip
    sizes: torch.Tensor       # (NT, MAX_MIPS, 2) i32 (w, h) per mip
    mip_counts: torch.Tensor  # (NT,) i32
    # every texture is a 1x1 constant: sampling is one gather per lookup
    all_constant: bool = False
    paired: bool = False
    quad: bool = False

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


class TexturePoolBuilder:
    """Accumulates decoded textures into the flat pool. Row layout defaults
    to quad rows; `paired=True, quad=False` gives pair rows and
    `paired=False, quad=False` flat rows."""

    def __init__(self, paired: Optional[bool] = None,
                 quad: Optional[bool] = None):
        self._levels: List[np.ndarray] = []      # (H, W, 4) f32 per mip
        self._offsets: List[np.ndarray] = []
        self._sizes: List[np.ndarray] = []
        self._mip_counts: List[int] = []
        self._cursor = 0
        self._has_hdr = False
        self.paired = paired
        self.quad = quad

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
        pixels = np.asarray(pixels, np.float32)
        if pixels.ndim == 2:
            pixels = pixels[..., None]
        if pixels.shape[-1] == 1:                      # gray → RGB
            pixels = np.repeat(pixels, 3, axis=-1)
        elif pixels.shape[-1] == 2:                    # gray+alpha
            pixels = np.concatenate(
                [np.repeat(pixels[..., :1], 3, axis=-1), pixels[..., 1:]],
                -1)
        if pixels.shape[-1] == 3:
            pixels = np.concatenate([pixels, np.ones_like(pixels[..., :1])], -1)
        if pixels.shape[-1] != 4:
            raise ValueError(f"texel rows must have 4 channels, got "
                             f"{pixels.shape}")
        if srgb:
            pixels = np.concatenate([srgb_to_linear(pixels[..., :3]),
                                     pixels[..., 3:]], -1)
        self._note_range(pixels)
        mips = build_mip_chain(pixels) if generate_mips else [pixels]
        offsets = np.zeros(MAX_MIPS, np.int32)
        sizes = np.zeros((MAX_MIPS, 2), np.int32)
        for i, m in enumerate(mips):
            offsets[i] = self._cursor
            sizes[i] = (m.shape[1], m.shape[0])
            self._push_level(m)
        # clamp unused mip slots to the last mip (safe gather targets)
        for i in range(len(mips), MAX_MIPS):
            offsets[i] = offsets[len(mips) - 1]
            sizes[i] = sizes[len(mips) - 1]
        self._offsets.append(offsets)
        self._sizes.append(sizes)
        self._mip_counts.append(len(mips))
        return len(self._mip_counts) - 1

    def add_mips(self, mips: List[np.ndarray], srgb: bool = False) -> int:
        """Add a texture from a pre-built mip chain (≙ the pre-mipped BCn
        upload path, Image::UploadWithMips / TextureUploader DDS ingest).
        Each level (H, W, 4) float; levels beyond MAX_MIPS are dropped,
        missing tail levels are box-generated down to 1x1."""
        chain = []
        for m in mips[:MAX_MIPS]:
            m = np.asarray(m, np.float32)
            if m.shape[-1] == 3:
                m = np.concatenate([m, np.ones_like(m[..., :1])], -1)
            if srgb:
                m = np.concatenate([srgb_to_linear(m[..., :3]), m[..., 3:]],
                                   -1)
            self._note_range(m)
            chain.append(m)
        while (len(chain) < MAX_MIPS
               and (chain[-1].shape[0] > 1 or chain[-1].shape[1] > 1)):
            chain.append(_downsample2x(chain[-1]))
        offsets = np.zeros(MAX_MIPS, np.int32)
        sizes = np.zeros((MAX_MIPS, 2), np.int32)
        for i, m in enumerate(chain):
            offsets[i] = self._cursor
            sizes[i] = (m.shape[1], m.shape[0])
            self._push_level(m)
        for i in range(len(chain), MAX_MIPS):
            offsets[i] = offsets[len(chain) - 1]
            sizes[i] = sizes[len(chain) - 1]
        self._offsets.append(offsets)
        self._sizes.append(sizes)
        self._mip_counts.append(len(chain))
        return len(self._mip_counts) - 1

    def build(self, dtype=None, device=None) -> DeviceTextures:
        """dtype None → bf16 rows, or f32 when any texture carried
        HDR-range texels. bf16 comes from `Tensor.to(torch.bfloat16)`,
        round-to-nearest-even like JAX's cast."""
        dev = default_device(device)
        sizes = np.stack(self._sizes)
        if dtype is None:
            dtype = torch.float32 if self._has_hdr else torch.bfloat16
        quad = True if self.quad is None else self.quad
        paired = False if self.paired is None else self.paired
        if quad:
            paired = False                # mutually exclusive layouts

            def quad_rows(m):
                rx = np.roll(m, -1, axis=1)
                ry = np.roll(m, -1, axis=0)
                rxy = np.roll(rx, -1, axis=0)
                return np.concatenate([m, rx, ry, rxy],
                                      axis=-1).reshape(-1, 16)
            texels = [quad_rows(m) for m in self._levels]
        elif paired:
            texels = [np.concatenate([m, np.roll(m, -1, axis=1)],
                                     axis=-1).reshape(-1, 8)
                      for m in self._levels]
        else:
            texels = [m.reshape(-1, 4) for m in self._levels]
        data = torch.from_numpy(np.ascontiguousarray(
            np.concatenate(texels, axis=0), np.float32)).to(dtype)
        return DeviceTextures(
            data=data.to(dev),
            offsets=torch.as_tensor(np.stack(self._offsets), device=dev),
            sizes=torch.as_tensor(sizes, device=dev),
            mip_counts=torch.as_tensor(
                np.asarray(self._mip_counts, np.int32), device=dev),
            all_constant=bool((sizes[:, 0] == 1).all()),
            paired=paired,
            quad=quad,
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


def default_texture_pool(device=None) -> DeviceTextures:
    b = TexturePoolBuilder()
    add_default_textures(b)
    return b.build(device=device)


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

    if tex.quad:
        rows = tex.data[row(x0, y0)].to(torch.float32)      # (N, 16)
        c00, c10 = rows[..., 0:4], rows[..., 4:8]
        c01, c11 = rows[..., 8:12], rows[..., 12:16]
    elif tex.paired:
        r0 = tex.data[row(x0, y0)].to(torch.float32)
        r1 = tex.data[row(x0, y0 + 1)].to(torch.float32)
        c00, c10 = r0[..., :4], r0[..., 4:]
        c01, c11 = r1[..., :4], r1[..., 4:]
    else:
        c00 = tex.data[row(x0, y0)].to(torch.float32)
        c10 = tex.data[row(x0 + 1, y0)].to(torch.float32)
        c01 = tex.data[row(x0, y0 + 1)].to(torch.float32)
        c11 = tex.data[row(x0 + 1, y0 + 1)].to(torch.float32)
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
