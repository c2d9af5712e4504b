"""Steps 4-6 of the per-bot step, and the dense step that runs them on DENSE.

The per-bot step (``engine._make_body``) runs its gated ops (the dead
injection, the centroid ring, the phase controller), then :func:`step_tail`:
the radius controller from the previous step's force magnitudes, integrate
with the world-boundary clamp, and the backend's collide.  On DENSE on the
card that tail runs as the dense step, one launch of the hand-written
kernel for every scene (``kernels.dense_step_cuda``, ``csrc/dense_step.cu``,
no (B, N, N) pair plane); :func:`dense_step_plain` is its plain twin, the
PyTorch ops of the body's tail, which the kernel equals but for the order
of its pair sums.
"""

from __future__ import annotations

import torch

from ..config import SimParams
from ..state import active_mask, payload_mask
from .actuation import update_radius
from .forces import dense_collide
from .integrate import integrate

# the fields the tail reads and those it writes
IN_FIELDS = ("pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r")
TAIL_FIELDS = ("pos", "vel", "rad", "abs_force_a", "abs_force_r")


def step_tail(params: SimParams, collide, arrays: dict, mask, payload, time,
              slot=None) -> dict:
    """Steps 4-6 of the step on one scene's arrays (``SimState`` fields)
    with its real-bot and payload masks and its sim time: the new
    :data:`TAIL_FIELDS`.  ``collide`` is the backend's collide;
    ``slot`` (PALLAS) a reused slot assignment."""
    dt = params.timestep
    # 4. radius controller — consumes previous collide's magnitudes
    rad = update_radius(
        params, arrays["rad"], arrays["phase"], arrays["abs_force_a"],
        arrays["abs_force_r"], arrays["dead"], mask, time, dt,
    )

    # 5. integrate + boundary
    pos, vel = integrate(params, arrays["pos"], arrays["vel"], rad, dt)

    # 6. collide -> next-step velocity + force magnitudes
    if slot is not None:
        new_vel, abs_a, abs_r = collide(params, pos, vel, rad, mask, payload, dt, slot=slot)
    else:
        new_vel, abs_a, abs_r = collide(params, pos, vel, rad, mask, payload, dt)
    return {"pos": pos, "vel": new_vel, "rad": rad, "abs_force_a": abs_a,
            "abs_force_r": abs_r}


def dense_step_plain(params: SimParams, arrays: dict, step: torch.Tensor,
                     offset: int = 0) -> dict:
    """Plain PyTorch twin of the dense step: :func:`step_tail` on DENSE at
    the sim time of the step ``step + offset`` (``step`` a 0-dim int64
    tensor on the arrays' device), vmapped over a leading scene axis."""
    from ..engine_table import sim_time

    at = step + offset if offset else step

    def one(a: dict) -> dict:
        n_pad, dev = a["pos"].shape[-2], a["pos"].device
        return step_tail(params, dense_collide, a, active_mask(params, n_pad, dev),
                         payload_mask(params, n_pad, dev), sim_time(at, params.timestep))

    fields = {k: arrays[k] for k in IN_FIELDS}
    if arrays["pos"].dim() == 3:
        return torch.func.vmap(one)(fields)
    return one(fields)

