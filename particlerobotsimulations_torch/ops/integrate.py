"""Position integrator + world-boundary response.

Port of ``particlerobotsimulations_tpu.ops.integrate`` — the reference's
``integrate_functor`` (particlebot_kernel_impl.cuh:53-103): split
symplectic Euler (collide updates velocity at step k, this op moves the
position at step k+1), clamped to the ±world_half box with the velocity
component flipped by ``boundary_damping`` (default -1, elastic).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimParams

f32 = np.float32


def _require_resolved_world(params: SimParams) -> None:
    """The ``world_half == 0`` auto-fit sentinel must be resolved from the
    placement extent before stepping — a 0 box would clamp every bot to the
    origin.  Simulation/initial_state_arrays resolve it."""
    if params.world_half == 0:
        raise ValueError(
            "world_half=0 (auto-fit) is unresolved: build state via "
            "Simulation/initial_state_arrays (which derive the box from "
            "the placement extent) or set world_half explicitly"
        )


def integrate(params: SimParams, pos, vel, rad, dt: float):
    """(new_pos, new_vel) for (n, 2) positions/velocities and (n,) radii."""
    _require_resolved_world(params)
    half = f32(params.world_half)
    bd = f32(params.boundary_damping)

    new_pos = pos + vel * f32(dt)
    hi = (half - rad)[..., None]
    lo = (-half + rad)[..., None]
    out = (new_pos > hi) | (new_pos < lo)
    new_pos = torch.minimum(torch.maximum(new_pos, lo), hi)
    new_vel = torch.where(out, vel * bd, vel)
    return new_pos, new_vel


def radius_integrate_planes(params: SimParams, f: dict, time) -> dict:
    """Radius controller + integrate/boundary on a dict of flat component
    planes (keys rad/phase/aa/ar/dead/val/px/py/vx/vy) — the table-resident
    form of steps 4 and 5: radius from the PREVIOUS step's force
    magnitudes, then position integrate with the ±world_half clamp and the
    boundary_damping velocity flip.  The expression shape is the JAX
    package's (``integrate.py:62-64`` pins it there).  ``time`` is a
    float32 value or a 0-dim float32 tensor on the planes' device (the
    table loop's, so that the step reads no host value).  Mutates and
    returns ``f``."""
    from .actuation import update_radius

    _require_resolved_world(params)
    dt = params.timestep
    f["rad"] = update_radius(
        params, f["rad"], f["phase"], f["aa"], f["ar"],
        f["dead"] > 0.5, f["val"] > 0.5, time, dt,
    )
    hi = f32(params.world_half) - f["rad"]
    lo = -f32(params.world_half) + f["rad"]
    bd = f32(params.boundary_damping)
    for c, v in (("px", "vx"), ("py", "vy")):
        new_p = f[c] + f[v] * f32(dt)
        out = (new_p > hi) | (new_p < lo)
        f[c] = torch.minimum(torch.maximum(new_p, lo), hi)
        f[v] = torch.where(out, f[v] * bd, f[v])
    return f
