"""Radius -> RGBA color mapping for rendering.

Port of ``particlerobotsimulations_tpu.ops.color`` — ``updateCol_k``
(particlebot_kernel_impl.cuh:400-443): green falls with the square of the
remaining expansion headroom, blue rises with the square root of the
expansion, dead bots render black; with ``display_shadow`` and obstacles,
shadowed bots have their HSL lightness halved.  Colors feed only the
renderer, so this runs on the state's device only when a frame is drawn.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimParams
from .phase import in_shadow

f32 = np.float32


def _rgb_to_hsl(r, g, b):
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    l = (mx + mn) / 2.0
    d = mx - mn
    achroma = d == 0
    one, zero = torch.ones_like(d), torch.zeros_like(d)
    safe_d = torch.where(achroma, one, d)
    s = torch.where(
        achroma,
        zero,
        torch.where(
            l > 0.5,
            d / torch.clamp(2.0 - mx - mn, min=f32(1e-12)),
            d / torch.clamp(mx + mn, min=f32(1e-12)),
        ),
    )
    h_r = (g - b) / safe_d + torch.where(g < b, one * 6.0, zero)
    h_g = (b - r) / safe_d + 2.0
    h_b = (r - g) / safe_d + 4.0
    h = torch.where(mx == r, h_r, torch.where(mx == g, h_g, h_b)) / 6.0
    h = torch.where(achroma, zero, h)
    return h, s, l


def _hue_to_rgb(p, q, t):
    t = torch.where(t < 0, t + 1.0, t)
    t = torch.where(t > 1, t - 1.0, t)
    return torch.where(
        t < 1.0 / 6.0,
        p + (q - p) * 6.0 * t,
        torch.where(
            t < 0.5,
            q,
            torch.where(t < 2.0 / 3.0, p + (q - p) * (2.0 / 3.0 - t) * 6.0, p),
        ),
    )


def _hsl_to_rgb(h, s, l):
    q = torch.where(l < 0.5, l * (1.0 + s), l + s - l * s)
    p = 2.0 * l - q
    r = _hue_to_rgb(p, q, h + 1.0 / 3.0)
    g = _hue_to_rgb(p, q, h)
    b = _hue_to_rgb(p, q, h - 1.0 / 3.0)
    achroma = s == 0
    return (
        torch.where(achroma, l, r),
        torch.where(achroma, l, g),
        torch.where(achroma, l, b),
    )


def bot_colors(
    params: SimParams,
    rad: torch.Tensor,    # (n,)
    pos: torch.Tensor,    # (n, 2)
    dead: torch.Tensor,   # (n,) bool
) -> torch.Tensor:
    """(n, 4) float32 RGBA in [0, 1], on ``rad``'s device."""
    span = max(f32(params.max_radius - params.min_radius), f32(1e-9))
    r = torch.full_like(rad, f32(30.0 / 255.0))
    g = (20.0 + 180.0 * (f32(params.max_radius) - rad) ** 2 / f32(span) ** 2) / 255.0
    b = (
        30.0
        + 180.0
        * torch.sqrt(torch.clamp(rad - f32(params.min_radius), min=0.0))
        / np.sqrt(span, dtype=np.float32)
    ) / 255.0

    if params.display_shadow and (params.rect_obstacles or params.circle_obstacles):
        shadowed = in_shadow(params, pos)
        h, s, l = _rgb_to_hsl(r, g, b)
        r2, g2, b2 = _hsl_to_rgb(h, s, l / 2.0)
        r = torch.where(shadowed, r2, r)
        g = torch.where(shadowed, g2, g)
        b = torch.where(shadowed, b2, b)

    rgb = torch.stack([r, g, b], dim=-1)
    rgb = torch.where(dead[..., None], torch.zeros_like(rgb), rgb)
    return torch.cat([rgb, torch.ones_like(rad)[..., None]], dim=-1)
