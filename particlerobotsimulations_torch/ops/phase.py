"""Light-distance phase controller + shadow raycaster.

Port of ``particlerobotsimulations_tpu.ops.phase`` — the reference's
``updatePhase`` / ``checkIntersection`` (particlebot_kernel_impl.cuh:184-290).

Phase law: the bot nearest the light leads the wave,
``phase = (min_d - dist) / (2 * min_radius) * rise_period``
(particlebot_kernel_impl.cuh:286).  Shadowed bots (segment from light to bot
intersects an obstacle) get ``-(Nx-1)*rise_period`` in mode 1 (modulate
last) or the 1e10 "never modulate" sentinel in mode 2
(particlebot_kernel_impl.cuh:276-284).  Gaussian noise of std ``phase_std``
is then added to every bot's phase, drawn through ``rng.normal`` from the
run's draw source for the step (a ``torch.Generator`` by default, or the
JAX package's draws through a step-keyed provider).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import rng
from ..config import SimParams

f32 = np.float32

PHASE_NEVER = 9999999999.0
_EPS = 1.0e-12


def _cross2(ax, ay, bx, by):
    return ax * by - ay * bx


def segment_hits_segment(ax, ay, bx, by, cx, cy, dx, dy):
    """True where open segment AB strictly crosses open segment CD
    (checkIntersectionLine, particlebot_kernel_impl.cuh:184-209); parallel
    segments never intersect.  A, C and D are scalars, B is per bot."""
    r_x, r_y = bx - ax, by - ay
    s_x, s_y = dx - cx, dy - cy
    denom = _cross2(r_x, r_y, s_x, s_y)
    safe = torch.where(denom.abs() < f32(_EPS), torch.ones_like(denom), denom)
    qp_x, qp_y = cx - ax, cy - ay
    t = _cross2(qp_x, qp_y, s_x, s_y) / safe
    u = _cross2(qp_x, qp_y, r_x, r_y) / safe
    return (denom.abs() >= f32(_EPS)) & (t > 0) & (t < 1) & (u > 0) & (u < 1)


def segment_hits_circle(ax, ay, bx, by, cx, cy, cr):
    """True where open segment AB crosses the circle boundary with a
    parameter in (0, 1) (checkIntersectionCircle,
    particlebot_kernel_impl.cuh:211-236)."""
    dx, dy = bx - ax, by - ay
    fx, fy = ax - cx, ay - cy
    a = dx * dx + dy * dy
    b = f32(2.0) * (fx * dx + fy * dy)
    c = fx * fx + fy * fy - cr * cr
    disc = b * b - f32(4.0) * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    safe_a = torch.clamp(a, min=f32(_EPS))
    r1 = (-b + sq) / (f32(2.0) * safe_a)
    r2 = (-b - sq) / (f32(2.0) * safe_a)

    def inside(t):
        return (t > 0) & (t < 1)

    return (disc >= 0) & (inside(r1) | inside(r2))


def in_shadow(params: SimParams, pos: torch.Tensor) -> torch.Tensor:
    """(..., n) bool: light->bot segment blocked by any obstacle
    (checkIntersection, particlebot_kernel_impl.cuh:238-262)."""
    lx, ly = f32(params.light_x), f32(params.light_y)
    px, py = pos[..., 0], pos[..., 1]
    shadowed = torch.zeros(px.shape, dtype=torch.bool, device=pos.device)
    for cx, cy, cr in params.circle_obstacles:
        shadowed = shadowed | segment_hits_circle(
            lx, ly, px, py, f32(cx), f32(cy), f32(cr)
        )
    for x1, x2, y1, y2 in params.rect_obstacles:
        x1, x2, y1, y2 = f32(x1), f32(x2), f32(y1), f32(y2)
        for (sx, sy, ex, ey) in (
            (x1, y1, x1, y2),  # left
            (x1, y2, x2, y2),  # top
            (x2, y2, x2, y1),  # right
            (x2, y1, x1, y1),  # bottom
        ):
            shadowed = shadowed | segment_hits_segment(lx, ly, px, py, sx, sy, ex, ey)
    return shadowed


def light_distance(params: SimParams, pos: torch.Tensor) -> torch.Tensor:
    """(..., n) distance of each bot to the light.  The light's coordinates
    enter as float32 scalars: no tensor is copied from the host."""
    d = torch.stack(
        [pos[..., 0] - f32(params.light_x), pos[..., 1] - f32(params.light_y)], dim=-1
    )
    return torch.sqrt(torch.sum(d * d, dim=-1))


def update_phase(
    params: SimParams,
    pos: torch.Tensor,     # (..., n, 2)
    phase: torch.Tensor,   # (..., n)
    mask: torch.Tensor,    # (..., n) bool
    generator,
    min_d: torch.Tensor | None = None,
    step: int = 0,
) -> torch.Tensor:
    """New phase for every masked bot; unmasked rows keep theirs.
    ``generator`` is the run's draw source (``rng``), drawn from for
    ``step`` in the layout of ``phase`` only when ``params.phase_std`` is
    nonzero.  A leading scene axis (the batched table loop's planes) takes
    each scene's own minimum distance."""
    dist = light_distance(params, pos)
    if min_d is None:
        min_d = torch.amin(
            torch.where(mask, dist, torch.full_like(dist, float("inf"))),
            dim=-1, keepdim=True,
        )
    spacing = f32(2.0) * f32(params.min_radius)
    base = (min_d - dist) / spacing * f32(params.rise_period)

    if params.light_shadow:
        shadowed = in_shadow(params, pos)
        if params.light_shadow == 1:
            blocked_val = f32(-(params.nx - 1) * params.rise_period)
        else:
            blocked_val = f32(PHASE_NEVER)
        base = torch.where(shadowed, torch.full_like(base, blocked_val), base)

    if params.phase_std:
        noise = f32(params.phase_std) * rng.normal(
            generator, step, phase.shape, phase.device
        )
        base = base + noise

    return torch.where(mask, base, phase)
