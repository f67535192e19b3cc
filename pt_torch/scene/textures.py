"""Scene textures → the device texture pool.

Port of the upload half of `pt.scene.textures`: `build_texture_pool` /
`build_scene_textures` with the memory-budget policy (`_budget_max_dim`,
`_downscale_to`), for textures given as in-memory `pixels`. Slot order is
`pt`'s: the defaults at 0..8, then the scene's textures in registration
order from SCENE_TEXTURE_OFFSET.

The file decoders (PNG/JPG/TGA/DDS/HDR from `path` or encoded `data`) belong
to slice 3 of the port, with a PNG decoder that needs no Pillow; a texture
that carries no `pixels` raises here.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from pt_torch.core.config import Config
from pt_torch.render.textures import (DeviceTextures, TexturePoolBuilder,
                                      _downsample2x, add_default_textures)
from pt_torch.scene.types import TextureInfo

DECODER_SLICE = ("slice 3 of the port (the texture file decoders: PNG "
                 "without Pillow, JPG, TGA, DDS, Radiance HDR)")


def load_texture_pixels(info: TextureInfo) -> np.ndarray:
    """In-memory `pixels` → (H, W, 4) float32: gray and gray+alpha expand to
    RGB(A), RGB gains α = 1, and integer sources are normalised by their
    dtype (uint8 / 255, uint16 / 65535)."""
    if info.pixels is None:
        raise NotImplementedError(
            f"texture '{info.name}' is given as a file or encoded bytes; "
            f"decoding them is {DECODER_SLICE}")
    raw = np.asarray(info.pixels)
    px = raw.astype(np.float32)
    if px.ndim == 2:
        px = px[..., None]
    if px.shape[-1] == 1:                      # gray → RGB
        px = np.repeat(px, 3, axis=-1)
    elif px.shape[-1] == 2:                    # gray+alpha
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
    """Repeated 2x box downsample until both dims ≤ max_dim."""
    while max(pixels.shape[0], pixels.shape[1]) > max_dim:
        pixels = _downsample2x(pixels)
    return pixels


def _budget_max_dim(infos: List[TextureInfo], cfg: Config) -> int:
    """Shrink the global size cap until the estimated pool fits the memory
    budget. The estimate is `pt`'s, whatever the pool's row format: 32
    bytes per texel (quad rows of 16 bf16 channels), times 4/3 for the
    generated mips."""
    max_dim = cfg.max_texture_size
    bytes_per_texel = 32 * 4 // 3
    while max_dim > 64:
        total = 0
        for info in infos:
            w = min(info.width or max_dim, max_dim)
            h = min(info.height or max_dim, max_dim)
            total += w * h * bytes_per_texel
        if total <= cfg.texture_memory_budget:
            break
        max_dim //= 2
    return max_dim


def build_texture_pool(infos: List[TextureInfo],
                       cfg: Optional[Config] = None,
                       paired: Optional[bool] = None, dtype=None,
                       quad: Optional[bool] = None,
                       device=None) -> DeviceTextures:
    """Build the device pool from the scene's textures: defaults in slots
    0..8, then `infos` in order. `paired`/`quad`/`dtype` override the pool's
    row format as in `TexturePoolBuilder`; as there, `paired=True` alone
    still gives quad rows (pass `quad=False` with it)."""
    cfg = cfg or Config()
    decoded = [load_texture_pixels(info) for info in infos]
    for info, px in zip(infos, decoded):
        info.height, info.width = px.shape[:2]
    max_dim = _budget_max_dim(infos, cfg)
    builder = TexturePoolBuilder(paired=paired, quad=quad)
    add_default_textures(builder)
    for info, px in zip(infos, decoded):
        builder.add(_downscale_to(px, max_dim), srgb=info.is_srgb,
                    generate_mips=True)
    return builder.build(dtype=dtype, device=device)


def build_scene_textures(scene, cfg: Optional[Config] = None,
                         paired: Optional[bool] = None, dtype=None,
                         quad: Optional[bool] = None,
                         device=None) -> DeviceTextures:
    return build_texture_pool(scene.textures, cfg, paired=paired,
                              dtype=dtype, quad=quad, device=device)
