"""Force-limited radius controller (hot loop #2).

Port of ``particlerobotsimulations_tpu.ops.actuation`` — the reference's
``updateRad_light_wave`` (particlebot_kernel_impl.cuh:124-181): each bot
tracks a triangle-wave radius target on its local clock ``t + phase``
wrapped modulo ``(Nx+1) * rise_period``; it only actuates during the first
two ``rise_period`` windows (expand, then contract) and holds ``min_radius``
otherwise.  Expansion is torque-limited against the previous step's
repulsive force magnitude; contraction is optionally limited against the
attraction magnitude (``constrained_contraction``).

Dead bots and bots with ``phase > 1e7`` (the light_shadow==2 sentinel) never
actuate (particlebot_kernel_impl.cuh:133-134).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimParams

f32 = np.float32

# Reference hard-codes the actuator's no-load speed (particlebot_kernel_impl.cuh:155).
MAX_SPEED = 0.1
PHASE_FROZEN = 1.0e7


def update_radius(
    params: SimParams,
    rad: torch.Tensor,          # (n,)
    phase: torch.Tensor,        # (n,)
    abs_force_a: torch.Tensor,  # (n,) previous-step attraction magnitudes
    abs_force_r: torch.Tensor,  # (n,) previous-step repulsion magnitudes
    dead: torch.Tensor,         # (n,) bool
    mask: torch.Tensor,         # (n,) bool
    time,                       # sim time: a float32 value, or a 0-dim
                                # float32 tensor on rad's device
    dt: float,
) -> torch.Tensor:
    period = f32(params.wave_period())
    rise = f32(params.rise_period)
    min_r = f32(params.min_radius)
    max_r = f32(params.max_radius)

    # local clock with the reference's conditional wrap
    # (particlebot_kernel_impl.cuh:137-141): +100 periods once if negative,
    # fmod only when t1 >= period
    t1 = (time if torch.is_tensor(time) else f32(time)) + phase
    t1 = torch.where(t1 < 0, t1 + f32(100.0) * period, t1)
    t1 = torch.where(t1 >= period, t1 - period * torch.floor(t1 / period), t1)
    in_window = t1 < f32(2.0) * rise

    target = torch.where(
        t1 <= rise,
        min_r + (max_r - min_r) / rise * t1,
        max_r + (min_r - max_r) / rise * (t1 - rise),
    )
    dr1 = target - rad

    safe_rad = torch.clamp(rad, min=f32(1.0e-9))
    torque = dr1 * f32(params.constraint) * rad / f32(MAX_SPEED) / max_r / f32(dt)
    torque = torch.clamp(torque, max=f32(params.constraint))

    # expansion: only the torque surplus over the contact load moves the shell
    # (particlebot_kernel_impl.cuh:160-165)
    surplus = torque / safe_rad
    expand = torch.where(
        surplus > abs_force_r,
        f32(MAX_SPEED) * max_r / f32(params.constraint)
        * (surplus - abs_force_r)
        * f32(dt),
        torch.zeros_like(rad),
    )

    if params.constrained_contraction:
        cc = f32(params.constraint_contraction)
        contract = torch.where(
            -cc * dr1 > abs_force_a * rad,
            (cc * dr1 + abs_force_a * rad) / cc,
            torch.zeros_like(rad),
        )
        contract = torch.clamp(contract, min=-max_r * f32(dt))
    else:
        contract = dr1

    dr = torch.where(dr1 > 0, expand, contract)
    new_rad = torch.clamp(rad + dr, min=min_r, max=max_r)

    frozen = dead | (phase > f32(PHASE_FROZEN)) | ~in_window | ~mask
    return torch.where(frozen, rad, new_rad)
