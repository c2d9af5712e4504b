"""Contact + magnet + obstacle forces and stick-slip friction.

Port of ``particlerobotsimulations_tpu.ops.forces`` (itself a re-derivation
of the reference's ``collideD``, particlebot_kernel_impl.cuh:540-831).  Same
physics, same constants, same expression order, float32 throughout:

* Overlapping pair (DEM): spring ``-k (d_c - d) n`` + dashpot ``c v_rel`` +
  tangential shear ``s v_t``  (particlebot_kernel_impl.cuh:560-573).
* Non-overlapping pair (magnet): piecewise in the surface gap g —
  constant 2.5 for g < 0.9 mm, linear ramp to ``attraction/int2^2`` at
  g = 1.9 mm, then inverse-square ``attraction / g^2``
  (particlebot_kernel_impl.cuh:576-593).
* Payload (last bot when n_dead == -1) scales attraction by
  ``attraction_factor`` on either side of the pair.
* Stick-slip friction: zero net force if nearly static and |F| below the
  static threshold, then kinetic mu*g*dt opposing motion
  (particlebot_kernel_impl.cuh:801-825).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SimParams

f32 = np.float32

_EPS = 1.0e-12
# Magnet-force breakpoints (surface gap) — particlebot_kernel_impl.cuh:578-580.
MAGNET_INT1 = 0.0009
MAGNET_INT2 = 0.0019
MAGNET_MIN_ATTR = 2.5


class PairForces(NamedTuple):
    force: torch.Tensor        # (..., 2) net force on i from each pair
    mag_contact: torch.Tensor  # (...,) |contact force| per pair
    mag_attract: torch.Tensor  # (...,) |magnet force| per pair


def _norm(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.sqrt(torch.clamp(torch.sum(v * v, dim=dim), min=1.0e-30))


def _where(cond, a, b):
    """``jnp.where`` with a python-scalar branch: ``torch.where`` takes the
    scalar as it is, and the tensor branch's float32 sets the result's
    type.  No tensor is built from the scalar, so nothing is copied from
    the host (a CUDA graph can capture the call)."""
    return torch.where(cond, a, b)


def pair_forces(
    params: SimParams,
    diff: torch.Tensor,           # (..., 2) pos_j - pos_i
    rel_vel: torch.Tensor,        # (..., 2) vel_j - vel_i
    rad_i: torch.Tensor,          # (...,)
    rad_j: torch.Tensor,          # (...,)
    attraction_ij: torch.Tensor,  # (...,) pre-scaled attraction constant
    valid: torch.Tensor,          # (...,) bool — real, non-self pair
) -> PairForces:
    """Force on bot i from each candidate pair (i, j) — ``collideSpheres``
    (particlebot_kernel_impl.cuh:540-594) in branch-free form."""
    dist = _norm(diff)
    safe_dist = torch.clamp(dist, min=f32(_EPS))
    norm = diff / safe_dist[..., None]

    collide_dist = rad_i + rad_j
    overlap = valid & (dist < collide_dist)
    attract = valid & ~(dist < collide_dist) & (dist < f32(params.cutoff()))

    vn = torch.sum(rel_vel * norm, dim=-1)
    tan_vel = rel_vel - vn[..., None] * norm
    f_contact = (
        -f32(params.spring) * (collide_dist - dist)[..., None] * norm
        + f32(params.damping) * rel_vel
        + f32(params.shear) * tan_vel
    )

    gap = dist - collide_dist
    gap_inv2 = _where(gap >= f32(MAGNET_INT2), gap, 1.0)
    ramp_slope = (
        attraction_ij / f32(MAGNET_INT2) ** 2 - f32(MAGNET_MIN_ATTR)
    ) / f32(MAGNET_INT2 - MAGNET_INT1)
    attr_mag = _where(
        gap < f32(MAGNET_INT1),
        float(MAGNET_MIN_ATTR),
        torch.where(
            gap < f32(MAGNET_INT2),
            f32(MAGNET_MIN_ATTR) + ramp_slope * (gap - f32(MAGNET_INT1)),
            attraction_ij / (gap_inv2 * gap_inv2),
        ),
    )
    f_attract = attr_mag[..., None] * norm

    mag_c = _where(overlap, _norm(f_contact), 0.0)
    mag_a = _where(attract, _norm(f_attract), 0.0)
    force = _where(overlap[..., None], f_contact, 0.0) + _where(
        attract[..., None], f_attract, 0.0
    )
    return PairForces(force=force, mag_contact=mag_c, mag_attract=mag_a)


def attraction_scale(params: SimParams, payload: torch.Tensor) -> torch.Tensor:
    """Per-bot attraction multiplier; pairwise scale is the product of the two
    endpoints' factors (particlebot_kernel_impl.cuh:629-649)."""
    one = torch.ones(payload.shape, dtype=torch.float32, device=payload.device)
    return torch.where(payload, one * f32(params.attraction_factor), one)


def obstacle_forces(params: SimParams, pos, vel, rad):
    """Circle + axis-aligned rectangle obstacle contact forces
    (particlebot_kernel_impl.cuh:703-798): (force (n, 2), repulsive
    magnitude (n,))."""
    fx, fy, mag_r = obstacle_forces_xy(
        params, pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], rad
    )
    return torch.stack([fx, fy], dim=-1), mag_r


def obstacle_forces_xy(params: SimParams, px, py, vx, vy, rad):
    """Component-form obstacle contact forces: (fx, fy, repulsive magnitude).

    Same physics and branch semantics as the JAX ``obstacle_forces_xy``:
    the obstacle spring is doubled relative to bot-bot contact
    (particlebot_kernel_impl.cuh:719, 789); rectangle sides follow the
    reference's sequential ifs (later wins), corners its elif chain."""
    fx = torch.zeros_like(px)
    fy = torch.zeros_like(py)
    mag_r = torch.zeros_like(px)

    def norm2(x, y):
        return torch.sqrt(torch.clamp(x * x + y * y, min=f32(1.0e-30)))

    def dem(dirx, diry, overlap, hit):
        rvx, rvy = -vx, -vy
        vn = rvx * dirx + rvy * diry
        tanx = rvx - vn * dirx
        tany = rvy - vn * diry
        ffx = (
            -2.0 * f32(params.spring) * overlap * dirx
            + f32(params.damping) * rvx
            + f32(params.shear) * tanx
        )
        ffy = (
            -2.0 * f32(params.spring) * overlap * diry
            + f32(params.damping) * rvy
            + f32(params.shear) * tany
        )
        return (
            _where(hit, ffx, 0.0),
            _where(hit, ffy, 0.0),
            _where(hit, norm2(ffx, ffy), 0.0),
        )

    for cx, cy, cr in params.circle_obstacles:
        tcx = f32(cx) - px
        tcy = f32(cy) - py
        d2 = tcx * tcx + tcy * tcy
        hit = d2 < (rad + f32(cr)) ** 2
        inv = 1.0 / torch.clamp(norm2(tcx, tcy), min=f32(_EPS))
        dirx = tcx * inv
        diry = tcy * inv
        overlap = rad + f32(cr) - torch.sqrt(torch.clamp(d2, min=f32(_EPS)))
        a, b, m = dem(dirx, diry, overlap, hit)
        fx, fy, mag_r = fx + a, fy + b, mag_r + m

    for x1, x2, y1, y2 in params.rect_obstacles:
        x1, x2, y1, y2 = f32(x1), f32(x2), f32(y1), f32(y2)
        in_y = (py > y1) & (py < y2)
        in_x = (px > x1) & (px < x2)

        left = in_y & (px > x1 - rad) & (px < x2 - rad)
        right = in_y & (px < x2 + rad) & (px > x1 + rad)
        bottom = ~in_y & in_x & (py > y1 - rad) & (py < y2 - rad)
        top = ~in_y & in_x & (py < y2 + rad) & (py > y1 + rad)

        zeros = torch.zeros_like(px)
        ones = torch.ones_like(px)
        side_hit = left | right | bottom | top
        sdx, sdy = ones, zeros
        side_over = px - x1 + rad
        for cond, dxs, dys, o in (
            (right, -ones, zeros, -px + x2 + rad),
            (bottom, zeros, ones, py - y1 + rad),
            (top, zeros, -ones, -py + y2 + rad),
        ):
            sdx = torch.where(cond, dxs, sdx)
            sdy = torch.where(cond, dys, sdy)
            side_over = torch.where(cond, o, side_over)

        corner_hit = torch.zeros_like(in_y)
        cdx = zeros
        cdy = zeros
        corner_over = zeros
        for corx, cory in ((x2, y2), (x1, y2), (x1, y1), (x2, y1)):
            dvx = px - corx
            dvy = py - cory
            d = norm2(dvx, dvy)
            hit_c = (d < rad) & ~in_y & ~in_x & ~corner_hit
            inv = 1.0 / torch.clamp(d, min=f32(_EPS))
            cdx = torch.where(hit_c, -dvx * inv, cdx)
            cdy = torch.where(hit_c, -dvy * inv, cdy)
            corner_over = torch.where(hit_c, rad - d, corner_over)
            corner_hit = corner_hit | hit_c

        hit = side_hit | corner_hit
        dirx = torch.where(side_hit, sdx, cdx)
        diry = torch.where(side_hit, sdy, cdy)
        overlap = torch.where(side_hit, side_over, corner_over)
        a, b, m = dem(dirx, diry, overlap, hit)
        fx, fy, mag_r = fx + a, fy + b, mag_r + m

    return fx, fy, mag_r


def friction_velocity_update_xy(params: SimParams, vx, vy, fx, fy, payload, dt):
    """Component-form stick-slip friction + explicit velocity update
    (particlebot_kernel_impl.cuh:801-825): static hold zeroes the net force
    when the bot is at rest below the 2*mu*g threshold; the velocity then
    integrates F*dt (payload: F/massFactor*dt); kinetic friction removes
    mu*g*dt from the speed, clamping through zero."""
    one = torch.ones_like(vx)
    fric = f32(params.friction) * torch.where(
        payload, one * f32(params.friction_factor), one
    )
    grav = f32(params.gravity) * torch.where(
        payload, one * f32(params.mass_factor), one
    )

    def norm2(x, y):
        return torch.sqrt(torch.clamp(x * x + y * y, min=f32(1.0e-30)))

    speed = norm2(vx, vy)
    fmag = norm2(fx, fy)
    static_hold = (speed < f32(1.0e-6)) & (fmag < 2.0 * fric * grav)
    fx = _where(static_hold, 0.0, fx)
    fy = _where(static_hold, 0.0, fy)

    inv_mass_dt = torch.where(
        payload, one * f32(1.0 / params.mass_factor), one
    ) * f32(dt)
    vx = vx + fx * inv_mass_dt
    vy = vy + fy * inv_mass_dt

    new_speed = norm2(vx, vy)
    kin = fric * grav * f32(dt)
    inv = torch.clamp(new_speed, min=f32(_EPS))
    stopped = new_speed < kin
    return (
        _where(stopped, 0.0, vx - kin * (vx / inv)),
        _where(stopped, 0.0, vy - kin * (vy / inv)),
    )


def friction_velocity_update(params: SimParams, vel, force, payload, dt):
    """Vector-form stick-slip friction + explicit velocity update; the same
    physics as :func:`friction_velocity_update_xy` in the JAX package's
    historical (n, 2) expression order."""
    one = torch.ones(payload.shape, dtype=torch.float32, device=vel.device)
    fric = f32(params.friction) * torch.where(
        payload, one * f32(params.friction_factor), one
    )
    grav = f32(params.gravity) * torch.where(
        payload, one * f32(params.mass_factor), one
    )

    speed = _norm(vel)
    fmag = _norm(force)
    static_hold = (speed < f32(1.0e-6)) & (fmag < 2.0 * fric * grav)
    force = _where(static_hold[..., None], 0.0, force)

    inv_mass = torch.where(payload, one * f32(1.0 / params.mass_factor), one)
    vel = vel + force * (inv_mass * f32(dt))[..., None]

    new_speed = _norm(vel)
    kin = fric * grav * f32(dt)
    unit = vel / torch.clamp(new_speed, min=f32(_EPS))[..., None]
    return _where(
        (new_speed < kin)[..., None], 0.0, vel - kin[..., None] * unit
    )


def dense_collide(params: SimParams, pos, vel, rad, mask, payload, dt):
    """Full collide pass with dense masked O(N^2) pairs: (new_vel,
    abs_force_a, abs_force_r) in the reference's semantics
    (particlebot_kernel_impl.cuh:657-831)."""
    n = pos.shape[0]
    diff = pos[None, :, :] - pos[:, None, :]        # (i, j, 2): pos_j - pos_i
    rel_vel = vel[None, :, :] - vel[:, None, :]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    valid = mask[:, None] & mask[None, :] & ~eye

    afac = attraction_scale(params, payload)
    attraction_ij = f32(params.attraction) * afac[:, None] * afac[None, :]

    pf = pair_forces(
        params, diff, rel_vel, rad[:, None], rad[None, :], attraction_ij, valid
    )
    force = torch.sum(pf.force, dim=1)
    abs_a = torch.sum(pf.mag_attract, dim=1)
    abs_r = torch.sum(pf.mag_contact, dim=1)

    f_obs, m_obs = obstacle_forces(params, pos, vel, rad)
    force = force + f_obs
    abs_r = abs_r + m_obs

    new_vel = friction_velocity_update(params, vel, force, payload, dt)
    new_vel = _where(mask[..., None], new_vel, 0.0)
    return new_vel, abs_a, abs_r
