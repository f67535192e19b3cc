"""Post-processing: accumulation resolve, bloom, composition, tone mapping.

Port of `pt.post.pipeline` (the reference's post compute chain,
Renderer::RecordPostProcessCommands):

* resolve: accumulation / TotalSamples * Exposure with NaN→red / Inf→green
  sentinel pixels (postprocess.comp:18-27)
* Unity-style soft-knee bloom threshold curve (postprocess.comp:29-39)
* 13-tap downsample / 9-tap tent additive upsample pyramid over ≤13 mip
  levels (bloomDownsample.comp / bloomUpsample.comp)
* composition: post += BloomIntensity * 0.1 * bloom (composition.comp:22-24)
* tone mapping: SDR 1−exp(−c), HDR passthrough (toneMapping.comp:20-22)
* UI composition: an sRGB RGBA overlay blended over the image
  (uiComposition.comp:55-60)
* HDR10: BT.709 → BT.2020 primaries and the ST.2084 PQ encode
  (uiComposition.comp:14-43)
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

MAX_BLOOM_MIP_LEVEL = 12   # ≙ MaxBloomMipmapLevel (ShaderRendererTypes.incl:68)


@dataclasses.dataclass(frozen=True)
class PostProcessSettings:
    """≙ PostProcessSettings (Renderer.h:68-73)."""
    exposure: float = 1.0
    bloom_threshold: float = 1.0
    bloom_intensity: float = 0.1
    enable_bloom: bool = True


def resolve_accumulation(accum, total_samples, exposure):
    """≙ postprocess.comp:18-27 (sentinels included)."""
    color = accum / max(float(total_samples), 1.0) * float(exposure)
    is_nan = torch.any(torch.isnan(color), dim=-1, keepdim=True)
    is_inf = torch.any(torch.isinf(color), dim=-1, keepdim=True)
    red = torch.eye(3, device=color.device)[0] * 5000.0
    green = torch.eye(3, device=color.device)[1] * 5000.0
    color = torch.where(is_nan, red, color)
    color = torch.where(is_inf, green, color)
    return color


def bloom_threshold_curve(color, threshold, knee: float = 0.5):
    """Unity soft-knee prefilter (≙ postprocess.comp:29-39)."""
    br = torch.max(color, dim=-1, keepdim=True).values
    curve_x = threshold - knee
    curve_y = knee * 2.0
    curve_z = 0.25 / knee
    rq = torch.clamp(br - curve_x, 0.0, curve_y)
    rq = curve_z * rq * rq
    return color * (torch.maximum(rq, br - threshold)
                    / torch.clamp(br, min=1e-4))


def _sample_bilinear(img, uv_x, uv_y):
    """Clamp-to-edge bilinear lookup on a (H, W, 3) image with normalized
    UVs (the bloom passes' linear clamped sampler)."""
    h, w = img.shape[0], img.shape[1]
    x = uv_x * w - 0.5
    y = uv_y * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def fetch(xi, yi):
        xi = torch.clamp(xi.to(torch.int64), 0, w - 1)
        yi = torch.clamp(yi.to(torch.int64), 0, h - 1)
        return img[yi, xi]

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def _dst_uv_grid(dh, dw, device):
    ys = (torch.arange(dh, dtype=torch.float32, device=device) + 0.5) / dh
    xs = (torch.arange(dw, dtype=torch.float32, device=device) + 0.5) / dw
    uy, ux = torch.meshgrid(ys, xs, indexing="ij")
    return ux, uy                  # each (dh, dw)


def bloom_downsample(src, dh: int, dw: int):
    """13-tap downsample (≙ bloomDownsample.comp:28-56)."""
    sh, sw = src.shape[0], src.shape[1]
    tx, ty = 1.0 / sw, 1.0 / sh
    ux, uy = _dst_uv_grid(dh, dw, src.device)

    def s(ox, oy):
        return _sample_bilinear(src, ux + ox * tx, uy + oy * ty)
    a = s(-2, 2); b = s(0, 2); c = s(2, 2)          # noqa: E702
    d = s(-2, 0); e = s(0, 0); f = s(2, 0)          # noqa: E702
    g = s(-2, -2); h_ = s(0, -2); i = s(2, -2)      # noqa: E702
    j = s(-1, 1); k = s(1, 1); l_ = s(-1, -1); m = s(1, -1)  # noqa: E702
    return (e * 0.125 + (a + c + g + i) * 0.03125
            + (b + d + f + h_) * 0.0625 + (j + k + l_ + m) * 0.125)


def bloom_upsample_add(src, dst):
    """9-tap tent upsample of src added into dst
    (≙ bloomUpsample.comp:33-53)."""
    sh, sw = src.shape[0], src.shape[1]
    dh, dw = dst.shape[0], dst.shape[1]
    tx, ty = 1.0 / sw, 1.0 / sh
    ux, uy = _dst_uv_grid(dh, dw, src.device)

    def s(ox, oy):
        return _sample_bilinear(src, ux + ox * tx, uy + oy * ty)
    a = s(-1, 1); b = s(0, 1); c = s(1, 1)          # noqa: E702
    d = s(-1, 0); e = s(0, 0); f = s(1, 0)          # noqa: E702
    g = s(-1, -1); h_ = s(0, -1); i = s(1, -1)      # noqa: E702
    up = (e * 4.0 + (b + d + f + h_) * 2.0 + (a + c + g + i)) / 16.0
    return dst + up


def bloom_pyramid(color, threshold):
    """Full bloom chain: threshold → down ladder → additive up ladder.
    Returns the mip-0 bloom image."""
    h, w = color.shape[0], color.shape[1]
    levels: List = [bloom_threshold_curve(color, threshold)]
    sizes = [(h, w)]
    while len(levels) <= MAX_BLOOM_MIP_LEVEL:
        nh, nw = max(1, sizes[-1][0] // 2), max(1, sizes[-1][1] // 2)
        if (nh, nw) == sizes[-1]:
            break
        levels.append(bloom_downsample(levels[-1], nh, nw))
        sizes.append((nh, nw))
    for lvl in range(len(levels) - 1, 0, -1):
        levels[lvl - 1] = bloom_upsample_add(levels[lvl], levels[lvl - 1])
    return levels[0]


def tonemap_sdr(color):
    """Exponential SDR tonemap (≙ toneMapping.comp:20-22)."""
    return 1.0 - torch.exp(-color)


def _srgb_to_linear(color):
    """Piecewise sRGB EOTF (≙ uiComposition.comp:41-48)."""
    low = color / 12.92
    high = ((color + 0.055) / 1.055) ** 2.4
    return torch.where(color >= 0.0404482362771082, high, low)


def compose_ui(screen_color, ui_rgba):
    """Blend a UI overlay over the screen image (≙ uiComposition.comp:55-60:
    where ui.a > 0 the pixel becomes srgb_to_linear(ui.rgb) * 0.99 +
    screen.rgb * 0.01; the PQ encode, when HDR, comes after this blend).
    `ui_rgba` is (H, W, 4) sRGB-encoded, float in [0, 1] or uint8, a tensor
    or a numpy array; it is moved to the screen image's device."""
    ui = torch.as_tensor(ui_rgba, device=screen_color.device)
    ui = ui.to(torch.float32) / 255.0 if ui.dtype == torch.uint8 else ui
    blended = _srgb_to_linear(ui[..., :3]) * 0.99 + screen_color * 0.01
    return torch.where(ui[..., 3:4] > 0.0, blended, screen_color)


# BT.709 → BT.2020 primaries (uiComposition.comp:14-18)
_M709_TO_2020 = ((0.6274040, 0.3292820, 0.0433136),
                 (0.0690970, 0.9195400, 0.0113612),
                 (0.0163916, 0.0880132, 0.8955950))


def linear_to_hdr10(color, white_point: float = 203.0):
    """BT.2020 + ST.2084 PQ encode (≙ uiComposition.comp:14-43) of a linear
    (..., 3) image, `white_point` nits at 1.0."""
    m = torch.tensor(_M709_TO_2020, dtype=torch.float32, device=color.device)
    c = (color[..., None, :] * m).sum(-1)
    c = c * (white_point / 10000.0)
    m1 = 2610.0 / 4096.0 / 4
    m2 = 2523.0 / 4096.0 * 128
    c1 = 3424.0 / 4096.0
    c2 = 2413.0 / 4096.0 * 32
    c3 = 2392.0 / 4096.0 * 32
    cp = torch.abs(c) ** m1
    return ((c1 + c2 * cp) / (1 + c3 * cp)) ** m2


def postprocess(accum, total_samples, settings: PostProcessSettings,
                hdr: bool = False, ui=None):
    """Post chain on an (H, W, 3) accumulation image → display-ready float
    image: in [0, 1] (SDR) or PQ-encoded (`hdr`). `ui`, when given, is an
    (H, W, 4) sRGB RGBA overlay composed after tone mapping and before the
    PQ encode, `pt`'s order (≙ toneMapping → uiComposition,
    Renderer.cpp:1766-1776)."""
    color = resolve_accumulation(accum, total_samples, settings.exposure)
    if settings.enable_bloom:
        bloom = bloom_pyramid(color, settings.bloom_threshold)
        color = color + (settings.bloom_intensity * 0.1) * bloom
    if not hdr:
        color = tonemap_sdr(color)           # HDR passes through
    if ui is not None:
        color = compose_ui(color, ui)
    if hdr:
        color = linear_to_hdr10(color)
    return color
