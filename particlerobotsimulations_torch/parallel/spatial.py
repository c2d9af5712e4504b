"""Spatial (bot-axis) split of one scene over a ring of shards: the dense path.

Port of ``particlerobotsimulations_tpu.parallel.spatial``.  When one swarm
outgrows a place, its bot axis is split over a ring of D shards
(``ring.py``): shard d owns the bots ``[d*n_pad/D, (d+1)*n_pad/D)``.  The
step is the per-bot engine's (``engine.make_step``) with dense O(N^2)
pairs, and all per-step work is local except:

* **collide**: ``ring.all_gather`` of the positions, velocities and radii
  feeds each shard's ``(n_pad/D, n_pad)`` pair rows, so each shard
  computes the forces on its own bots (the tensor-parallel form);
* **reductions**: ``ring.pmin`` gives the phase law's minimum light
  distance, ``ring.psum`` the centroid (pre-integrate positions, as the
  engine takes it), and an all-gathered ``topk`` picks the dead cells.

It runs no kernel of its own: the JAX package's ``pair_forces`` is plain
XLA, and the port's is plain torch (``ops/forces.py``).  The table loop's
split over grid rows, with kernels 4 and 2, is ``spatial_table.py``.

Layout (:func:`shard_state`): every per-bot field is a per-shard stack
``(S, n_pad/D, ...)`` of the S shards this process holds (S = D on a
``LocalRing``, 1 on a ``DistRing``); the step counter, the draw source and
the centroid ring are the whole scene's, the same on every shard.  With
``batch=True`` (dp x tp: a lockstep batch of B scenes, ``sweep.
make_batch_state``) the fields are laid out shard-major, ``(S, B,
n_pad/D, ...)``, so that both rings shift and reduce on the leading axis
unchanged (``LocalRing.psum`` sums dim 0 into per-scene values;
``DistRing`` reduces its one shard's ``(B, ...)``), and the centroid ring
is ``(B, centroid_steps, 2)``.

Random draws: dead-cell scores and phase noise are drawn from the run's
draw source in the single-scene layout, ``(n_pad,)`` per scene, in the
order ``engine.make_step`` draws them, and each shard takes its own bots'
values: a split run draws what the unsplit run draws, and every rank of a
``DistRing`` draws the same.  (The JAX package draws phase noise per
shard, so comparisons with it run at ``phase_std=0``.)
"""

from __future__ import annotations

import numpy as np
import torch

from .. import chunk, rng
from ..config import SimParams, padded_n
from ..ops.actuation import update_radius
from ..ops.forces import (
    _where,
    attraction_scale,
    friction_velocity_update,
    obstacle_forces_xy,
    pair_forces,
)
from ..ops.integrate import integrate
from ..ops.phase import light_distance, update_phase
from ..state import SimState, active_mask, payload_mask
from .ring import LocalRing

f32 = np.float32

# per-bot fields, split over the shards; the rest are the whole scene's
BOT_FIELDS = ("pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r")
# shards of the default ring
DEFAULT_SHARDS = 4


def _split(x: torch.Tensor, ring, batch: bool) -> torch.Tensor:
    """A whole scene's ([B,] n_pad, ...) tensor -> this process's shards
    (S, [B,] n_pad/D, ...)."""
    ax = int(batch)
    y = x.unflatten(ax, (ring.n_shards, x.shape[ax] // ring.n_shards))
    return y.index_select(ax, ring.shard_ids().to(x.device)).movedim(ax, 0).contiguous()


def _join(x: torch.Tensor, ring, batch: bool) -> torch.Tensor:
    """The all-gathered whole scene of shard stacks (S, [B,] n_pad/D,
    ...) -> ([B,] n_pad, ...), the same on every shard."""
    ax = int(batch)
    return ring.all_gather(x).movedim(0, ax).flatten(ax, ax + 1)


def shard_state(state: SimState, ring, batch: bool = False) -> SimState:
    """A bot-order state (``batch``: a batched one) in the split layout of
    :func:`make_sharded_step` on ``ring``: the per-bot fields cut into this
    process's shards, the rest as they are."""
    return state.replace(**{k: _split(getattr(state, k), ring, batch) for k in BOT_FIELDS})


def gather_state(state: SimState, ring, batch: bool = False) -> SimState:
    """The bot-order state of a split one (inverse of
    :func:`shard_state`): the per-bot fields all-gathered over the ring."""
    out = {k: _join(getattr(state, k), ring, batch) for k in BOT_FIELDS if k != "dead"}
    out["dead"] = _join(state.dead.to(torch.uint8), ring, batch) > 0
    return state.replace(**out)


def make_sharded_step(params: SimParams, ring=None, batch: bool = False, device="cuda"):
    """One physics step with the bot axis split over ``ring`` (default
    ``LocalRing(DEFAULT_SHARDS, device)``): ``step(state) -> state`` on a
    state in :func:`shard_state`'s layout on the ring's device, in
    ``engine.make_step``'s op order with its dense pair law.  ``batch=True``
    steps a lockstep batch of scenes laid out shard-major.  Raises
    ValueError when the padded bot count does not split into the ring's
    shards."""
    ring = ring if ring is not None else LocalRing(DEFAULT_SHARDS, device)
    params = params.validate()
    dt = params.timestep
    n_pad = padded_n(params)
    D = ring.n_shards
    if n_pad % D:
        raise ValueError(f"padded bot count {n_pad} not divisible by {D} shards")
    n_loc = n_pad // D
    dev = ring.device
    ids = ring.shard_ids()
    S = ids.numel()
    cog_steps = params.centroid_steps_interval

    # this process's bots: global index, real-bot mask, payload; a batch
    # broadcasts them over its scene axis
    idx = ids[:, None] * n_loc + torch.arange(n_loc, device=dev)
    if batch:
        idx = idx[:, None, :]
    mask = idx < params.n_cells
    payload = (idx == params.n_cells - 1) if params.has_payload else torch.zeros_like(mask)
    gidx = torch.arange(n_pad, device=dev)
    gmask = active_mask(params, n_pad, dev)
    valid = mask[..., :, None] & gmask & (idx[..., :, None] != gidx)
    attraction_ij = (
        f32(params.attraction) * attraction_scale(params, payload)[..., :, None]
        * attraction_scale(params, payload_mask(params, n_pad, dev))
    )
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)

    def step(state: SimState) -> SimState:
        if state.device != dev:
            raise ValueError(f"state on {state.device}, ring on {dev}")
        t = state.step
        gates = chunk.step_gates(params, t)
        dead_gate, cog_gate, phase_gate = gates
        scene = (state.pos.shape[1],) if batch else ()
        draws = chunk.draws(params, state.generator, t, gates, scene + (n_pad,), dev)
        pos, vel, rad, phase, dead = state.pos, state.vel, state.rad, state.phase, state.dead
        ring_buf = state.centroid_ring
        time = float(f32(t) * f32(dt))
        mask_f = mask.expand(rad.shape)

        # 1. dead-cell injection: the n_dead smallest scores of the live
        #    bots of the whole scene, each shard keeping its own
        if dead_gate:
            gdead = _join(dead.to(torch.uint8), ring, batch) > 0
            scores = torch.where(gmask & ~gdead, draws["scores"], inf)
            kill = torch.topk(-scores, params.n_dead, dim=-1).indices
            killed = torch.zeros_like(gdead).scatter(-1, kill, True)
            dead = dead | _split(killed, ring, batch)

        # 2. centroid ring (pre-integrate positions): a ring-wide sum
        if cog_gate:
            local = torch.sum(torch.where(mask_f[..., None], pos, zero), dim=-2)
            centroid = ring.psum(local) / f32(params.n_cells)
            row = torch.arange(ring_buf.shape[-2], device=dev)[:, None]
            ring_buf = torch.where(
                row == (t // cog_steps) % params.centroid_steps,
                centroid[..., None, :], ring_buf,
            )

        # 3. phase law: the ring-wide minimum light distance
        if phase_gate:
            dist = light_distance(params, pos)
            min_d = ring.pmin(torch.amin(torch.where(mask_f, dist, inf), dim=-1, keepdim=True))
            noise = draws.get("noise")
            phase = update_phase(
                params, pos, phase, mask_f,
                rng.Drawn(normal=None if noise is None else _split(noise, ring, batch)),
                min_d=min_d, step=t,
            )

        # 4. radius controller (previous collide's magnitudes), 5. integrate
        rad = update_radius(
            params, rad, phase, state.abs_force_a, state.abs_force_r, dead, mask_f, time, dt,
        )
        pos, vel = integrate(params, pos, vel, rad, dt)

        # 6. collide: the whole scene's kinematics against this shard's rows
        all_pos, all_vel, all_rad = (_join(x, ring, batch) for x in (pos, vel, rad))
        pf = pair_forces(
            params,
            all_pos[..., None, :, :] - pos[..., :, None, :],
            all_vel[..., None, :, :] - vel[..., :, None, :],
            rad[..., :, None], all_rad[..., None, :], attraction_ij, valid,
        )
        force = torch.sum(pf.force, dim=-2)
        abs_a = torch.sum(pf.mag_attract, dim=-1)
        abs_r = torch.sum(pf.mag_contact, dim=-1)
        ofx, ofy, m_obs = obstacle_forces_xy(
            params, pos[..., 0], pos[..., 1], vel[..., 0], vel[..., 1], rad
        )
        force = force + torch.stack([ofx, ofy], dim=-1)
        abs_r = abs_r + m_obs
        new_vel = friction_velocity_update(params, vel, force, payload.expand(rad.shape), dt)
        new_vel = _where(mask_f[..., None], new_vel, 0.0)
        return state.replace(
            pos=pos, vel=new_vel, rad=rad, phase=phase, dead=dead,
            abs_force_a=abs_a, abs_force_r=abs_r, step=t + 1, centroid_ring=ring_buf,
        )

    return step
