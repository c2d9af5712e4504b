"""The STENCIL force backend: neighbour search as a dense 3x3 roll.

Port of ``particlerobotsimulations_tpu.ops.stencil`` (plain XLA there, no
Pallas kernel; plain PyTorch here):

1. scatter the bots' fields into a dense wrapped cell-major table
   ``(G, G, C)`` (one stable sort and rank, :func:`assign_slots`);
2. the 3x3 neighbourhood is nine ``torch.roll`` views of the table along the
   grid axes, in the JAX order (dy, then dx, each from -1);
3. the pair law of ``ops/forces.py`` on the ``(G, G, C, C)`` slot pairs of
   each view, summed over the candidate slot axis, view after view;
4. the per-bot results come back through flat gathers.

Work is O(G^2 * C^2 * 9) pair evaluations whatever the occupancy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SimParams
from .forces import attraction_scale, friction_velocity_update, obstacle_forces, pair_forces
from .grid import cell_ids, rank_cells

f32 = np.float32


class SlotAssignment(NamedTuple):
    slot: torch.Tensor      # (n_pad,) int32: flat cell-major slot (G*G*C = dropped)
    overflow: torch.Tensor  # () int32


def assign_slots(params: SimParams, pos, mask) -> SlotAssignment:
    """Cell-major slot ``cell * C + rank`` per bot; padding and bots beyond
    a cell's capacity get ``G*G*C``."""
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    cid = cell_ids(params, pos, mask)
    order, scid, rank, in_range, overflow = rank_cells(cid, g, cap)
    keep = in_range & (rank < cap)
    slot_sorted = torch.where(keep, scid * cap + rank, torch.full_like(scid, g * g * cap))
    slot = torch.zeros((pos.shape[0],), dtype=torch.int32, device=pos.device)
    slot = slot.index_put((order,), slot_sorted)
    return SlotAssignment(slot=slot, overflow=overflow)


def stencil_collide(params: SimParams, pos, vel, rad, mask, payload, dt):
    """Collide pass in table space: ``dense_collide``'s semantics.  Returns
    (new velocity, attraction magnitude sums, contact magnitude sums), per
    bot."""
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    total = g * g * cap
    dev = pos.device
    slot = assign_slots(params, pos, mask).slot.long()

    def scat(v):
        # one spare row takes the dropped bots' writes (out of place, so
        # that the batched step can vmap it)
        out = torch.zeros((total + 1,) + tuple(v.shape[1:]), dtype=v.dtype, device=dev)
        out = out.index_put((slot,), v)
        return out[:total].reshape((g, g, cap) + tuple(v.shape[1:]))

    afac = attraction_scale(params, payload)
    tpos, tvel, trad, tval, tafac = scat(pos), scat(vel), scat(rad), scat(mask), scat(afac)

    force = torch.zeros((g, g, cap, 2), dtype=torch.float32, device=dev)
    abs_a = torch.zeros((g, g, cap), dtype=torch.float32, device=dev)
    abs_r = torch.zeros((g, g, cap), dtype=torch.float32, device=dev)
    not_self = ~torch.eye(cap, dtype=torch.bool, device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            views = (tpos, tvel, trad, tval, tafac)
            if (dy, dx) != (0, 0):
                views = tuple(torch.roll(v, (dy, dx), dims=(0, 1)) for v in views)
            qpos, qvel, qrad, qval, qafac = views
            # pairs: my slot c x their slot k -> (G, G, C, K)
            diff = qpos[:, :, None, :, :] - tpos[:, :, :, None, :]
            rel_vel = qvel[:, :, None, :, :] - tvel[:, :, :, None, :]
            valid = tval[:, :, :, None] & qval[:, :, None, :]
            if (dy, dx) == (0, 0):
                valid = valid & not_self
            attraction_ij = (
                f32(params.attraction) * tafac[:, :, :, None] * qafac[:, :, None, :]
            )
            pf = pair_forces(
                params, diff, rel_vel, trad[:, :, :, None], qrad[:, :, None, :],
                attraction_ij, valid,
            )
            force = force + torch.sum(pf.force, dim=3)
            abs_a = abs_a + torch.sum(pf.mag_attract, dim=3)
            abs_r = abs_r + torch.sum(pf.mag_contact, dim=3)

    # back to bot order
    safe = torch.clamp(slot, max=total - 1)
    got = mask & (slot < total)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    bot_force = torch.where(got[:, None], force.reshape(total, 2)[safe], zero)
    bot_a = torch.where(got, abs_a.reshape(total)[safe], zero)
    bot_r = torch.where(got, abs_r.reshape(total)[safe], zero)

    f_obs, m_obs = obstacle_forces(params, pos, vel, rad)
    bot_force = bot_force + f_obs
    bot_r = bot_r + m_obs
    new_vel = friction_velocity_update(params, vel, bot_force, payload, dt)
    return torch.where(mask[..., None], new_vel, zero), bot_a, bot_r
