"""Cell-table neighbour search: the geometry every slot table shares, and
the CELLGRID force backend.

Port of ``particlerobotsimulations_tpu.ops.grid``: the 3x3 offset order,
the bbox anchor, wrapped cell ids and the stable sort-and-rank that assigns
slots (shared by the table loop and the STENCIL and PALLAS backends), and
the CELLGRID collide — a fixed-capacity ``(G*G*C,)`` index table of bots
and an ``(n_pad, 9*C)`` candidate gather per bot, the pair law of
``ops/forces.py`` on the gathered candidates.  No TPU kernel lies behind
it; it is plain PyTorch on both devices.  The grid wraps modulo
``grid_dim`` like the reference's ``calcGridHash``
(particlebot_kernel_impl.cuh:114-120); aliased far pairs are eliminated by
the true-distance cutoff in the pair math.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SimParams
from .forces import attraction_scale, friction_velocity_update, obstacle_forces, pair_forces

f32 = np.float32

# the full 3x3 neighborhood (dx, dy), center first — shared by the
# force-kernel candidate cells and the compaction-rebuild mover offsets
OFFSETS9 = (
    (0, 0),
    (1, 0), (-1, 0), (0, 1), (0, -1),
    (1, 1), (1, -1), (-1, 1), (-1, -1),
)


def cell_origin(params: SimParams, pos: torch.Tensor, mask: torch.Tensor):
    """(2,) grid anchor: the swarm's bounding-box min (active bots only)."""
    big = torch.full_like(pos[..., 0], f32(4.0 * params.world_half))
    ox = torch.min(torch.where(mask, pos[..., 0], big))
    oy = torch.min(torch.where(mask, pos[..., 1], big))
    return torch.stack([ox, oy])


def cell_ids(params: SimParams, pos, mask, origin=None) -> torch.Tensor:
    """Wrapped cell id ``iy * G + ix`` per bot; padding routed to ``G*G``
    (out of range, dropped later).  An explicit ``origin`` pins the anchor
    (the table loop keeps it fixed per chunk)."""
    g = params.resolved_grid_dim()
    h = f32(params.cutoff())
    if origin is None:
        origin = cell_origin(params, pos, mask)
    ix = torch.floor((pos[..., 0] - origin[0]) / h).to(torch.int32) % g
    iy = torch.floor((pos[..., 1] - origin[1]) / h).to(torch.int32) % g
    cid = iy * g + ix
    return torch.where(mask, cid, torch.full_like(cid, g * g))


def rank_cells(cid: torch.Tensor, g: int, cap: int):
    """Sort bots by cell id and rank each within its cell's run.

    A STABLE argsort groups bots by cell (``torch.argsort`` is stable only
    with ``stable=True``; the JAX argsort always is, and slot order depends
    on it).  Returns ``(order, scid, rank, in_range, overflow)`` where
    ``scid``/``rank``/``in_range`` are in sorted order and ``overflow``
    counts in-range bots beyond ``cap`` per cell (they get no slot)."""
    n = cid.shape[0]
    order = torch.argsort(cid, stable=True)
    scid = cid[order]
    arange = torch.arange(n, dtype=torch.int32, device=cid.device)
    is_start = torch.ones_like(scid, dtype=torch.bool)
    is_start[1:] = scid[1:] != scid[:-1]
    run_start = torch.cummax(
        torch.where(is_start, arange, torch.zeros_like(arange)), dim=0
    ).values
    rank = arange - run_start
    in_range = scid < g * g
    overflow = torch.sum((in_range & (rank >= cap)).to(torch.int32))
    return order, scid, rank, in_range, overflow


class CellTable(NamedTuple):
    idx: torch.Tensor       # (G*G*C,) int32: bot index or -1
    cell_id: torch.Tensor   # (n_pad,) int32: each bot's cell (G*G = padding)
    overflow: torch.Tensor  # () int32: bots dropped for exceeding capacity


def build_cell_table(params: SimParams, pos, mask) -> CellTable:
    """The cell-major index table: bot ``order[k]`` at ``cell * C + rank``,
    overflowing and padding bots dropped."""
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    cid = cell_ids(params, pos, mask)
    order, scid, rank, in_range, overflow = rank_cells(cid, g, cap)
    keep = in_range & (rank < cap)
    slot = torch.where(keep, scid * cap + rank, torch.full_like(scid, g * g * cap))
    # one spare row takes the dropped bots' writes (out of place, so that
    # the batched step can vmap it)
    table = torch.full((g * g * cap + 1,), -1, dtype=torch.int32, device=pos.device)
    table = table.index_put((slot.long(),), order.to(torch.int32))
    return CellTable(idx=table[: g * g * cap], cell_id=cid, overflow=overflow)


def neighbor_candidates(params: SimParams, table: CellTable) -> torch.Tensor:
    """(n_pad, 9*C) int32 candidate bot indices (-1 = empty): the C slots of
    the 3x3 wrapped cells around each bot, offsets (dy, dx) row-major."""
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    dev = table.cell_id.device
    cid = torch.clamp(table.cell_id, max=g * g - 1)
    cx, cy = cid % g, cid // g
    # (dy, dx) row-major over {-1, 0, 1}^2, made on the device (a copy from
    # the host would wait for the card, and a CUDA graph cannot hold it)
    o = torch.arange(9, dtype=torch.int32, device=dev)
    dy, dx = o // 3 - 1, o % 3 - 1
    nx = (cx[:, None] + dx[None, :]) % g
    ny = (cy[:, None] + dy[None, :]) % g
    ncell = ny * g + nx                                              # (n, 9)
    base = ncell[..., None] * cap + torch.arange(cap, dtype=torch.int32, device=dev)
    return table.idx[base.reshape(base.shape[0], -1).long()]        # (n, 9*cap)


def cellgrid_collide(params: SimParams, pos, vel, rad, mask, payload, dt):
    """Collide pass over the 3x3-cell candidates: ``dense_collide``'s
    semantics in O(N * 9 * C).  Returns (new velocity, attraction
    magnitude sums, contact magnitude sums), per bot."""
    n = pos.shape[0]
    table = build_cell_table(params, pos, mask)
    cand = neighbor_candidates(params, table)                       # (n, K)
    arange = torch.arange(n, dtype=torch.int32, device=pos.device)
    cand_valid = (cand >= 0) & (cand != arange[:, None]) & mask[:, None]
    cj = torch.clamp(cand, min=0).long()

    diff = pos[cj] - pos[:, None, :]
    rel_vel = vel[cj] - vel[:, None, :]
    afac = attraction_scale(params, payload)
    attraction_ij = f32(params.attraction) * afac[:, None] * afac[cj]
    pf = pair_forces(params, diff, rel_vel, rad[:, None], rad[cj], attraction_ij, cand_valid)
    force = torch.sum(pf.force, dim=1)
    abs_a = torch.sum(pf.mag_attract, dim=1)
    abs_r = torch.sum(pf.mag_contact, dim=1)

    f_obs, m_obs = obstacle_forces(params, pos, vel, rad)
    force = force + f_obs
    abs_r = abs_r + m_obs
    new_vel = friction_velocity_update(params, vel, force, payload, dt)
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    return torch.where(mask[..., None], new_vel, zero), abs_a, abs_r
