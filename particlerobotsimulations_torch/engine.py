"""Simulation engine: the per-step pipeline and the chunk runners.

Port of ``particlerobotsimulations_tpu.engine`` — ``Particlebot::update``
(particlebot.cpp:170-300).  One ``step`` call is one physics step of
``timestep`` seconds, in the reference's op order:

  1. dead-cell injection at ``time_to_dead``   (particlebot.cpp:178-194)
  2. centroid tracking every ``centroid_int``  (particlebot.cpp:207-209)
  3. phase update every ``phase_update_interval`` + gaussian noise
                                               (particlebot.cpp:211-237)
  4. force-limited radius update from the *previous* step's force
     magnitudes (the one-step-lag feedback)   (particlebot.cpp:238-242)
  5. position integrate + boundary clamp       (particlebot.cpp:246-252)
  6. neighbor collide -> new velocity + force magnitudes
                                               (particlebot.cpp:256-296)

:func:`make_step` runs every force backend's collide per bot: DENSE
(``ops/forces.py``), CELLGRID (``ops/grid.py``), STENCIL
(``ops/stencil.py``) and the per-bot PALLAS collide
(``ops/pallas_stencil.pallas_stencil_collide``: kernel 1 on the card, with
an optional reused slot assignment).  :func:`make_run_chunk` sends the
PALLAS backend to the table-resident loop (``engine_table.py``) and the
others to the per-bot block runner: gated steps one at a time, ungated
stretches as blocks of :data:`BLOCK_STEPS` steps that the card replays
from CUDA graphs, the sim time a device scalar, nothing read inside a
chunk (the JAX package's scanned chunk).  The random draws go through
``rng.py`` with the step they are drawn for.  :func:`make_run_chunk_batched`
runs a batch of scenes in lockstep (the seed sweep): PALLAS through the
batched table loop, the other backends through the same block runner on
:func:`make_step_batched`, the per-scene step vmapped over the scene
axis.  ``make_step(...,
differentiable=True)`` is the step that ``torch.autograd`` differentiates
(``models/optimize.py``): PALLAS through ``ops/pallas_stencil.
make_diff_pallas_collide`` (kernel 1 forward, the STENCIL collide
backward), the other backends as written.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from . import rng
from .config import Control, ForceBackend, SimParams
from .ops.actuation import update_radius
from .ops.forces import dense_collide
from .ops.grid import cellgrid_collide
from .ops.integrate import integrate
from .ops.pallas_stencil import make_diff_pallas_collide, pallas_stencil_collide
from .ops.phase import update_phase
from .ops.stencil import stencil_collide
from .engine_table import (
    _gates,
    _graphed,
    _one_chunk_at_a_time,
    drain,
    make_adaptive_run_chunk,
    make_run_chunk_table,
    make_run_chunk_table_batched,
    sim_time,
    step_tensor,
)
from .state import ARRAY_FIELDS, SimState, active_mask, payload_mask

f32 = np.float32

# steps per block of the per-bot chunk runner: an ungated stretch of the
# DENSE, STENCIL or CELLGRID loop runs as blocks of this many steps, each
# replayed on the card from one CUDA graph.  8 beat 32 at 500 DENSE bots
# (chip_smoke.py phase 17, PERF.md): a gate interval of L steps leaves
# (L - 1) mod 8 of them eager, and a replay's host cost is small beside 8
# steps
BLOCK_STEPS = 8

# what an ungated step changes: the other arrays pass through it
_UNGATED_OUT = ("pos", "vel", "rad", "abs_force_a", "abs_force_r")


_COLLIDES = {
    ForceBackend.DENSE: dense_collide,
    ForceBackend.CELLGRID: cellgrid_collide,
    ForceBackend.STENCIL: stencil_collide,
    ForceBackend.PALLAS: pallas_stencil_collide,
}


def _inject_dead(params: SimParams, dead, mask, scores) -> torch.Tensor:
    """Kill ``n_dead`` distinct live bots (particlebot.cpp:178-194): the
    ``n_dead`` smallest of a uniform score per bot die."""
    scores = torch.where(
        mask & ~dead, scores, torch.full_like(scores, float("inf"))
    )
    kill = torch.topk(-scores, params.n_dead).indices
    return dead.index_fill(0, kill, True)


def _step_gates(params: SimParams, step: int) -> tuple:
    """(dead, cog, phase) gate decisions for a step counter, the phase gate
    only under the light-wave controller (FIXED_PHASE keeps scripted
    offsets)."""
    dead_gate, cog_gate, phase_gate = _gates(params, step)
    return dead_gate, cog_gate, phase_gate and params.control == Control.LIGHT_WAVE


def _draws(params: SimParams, source, step: int, gates: tuple, shape: tuple,
           device) -> dict:
    """The step's random draws, in the order the step consumes them: dead
    scores, then phase noise."""
    dead_gate, _, phase_gate = gates
    out = {}
    if dead_gate:
        out["scores"] = rng.uniform(source, step, shape, device)
    if phase_gate and params.phase_std:
        out["noise"] = rng.normal(source, step, shape, device)
    return out


def _collide_fn(params: SimParams, backend: ForceBackend, differentiable: bool):
    """The backend's collide; on PALLAS with ``differentiable`` the
    autograd wrapper of kernel 1 (the slot argument is not taken: the
    wrapper assigns slots itself)."""
    if not (differentiable and backend == ForceBackend.PALLAS):
        return _COLLIDES[backend]
    diff = make_diff_pallas_collide(params, params.timestep)

    def collide(p, pos, vel, rad, mask, payload, dt, slot=None):
        return diff(pos, vel, rad, mask, payload)

    return collide


def _make_body(params: SimParams, backend: ForceBackend, differentiable: bool = False):
    """The step on one scene's arrays, with its draws taken beforehand
    (``_draws``) and its gates decided on the host: pure, so the batched
    step can ``torch.func.vmap`` it over a scene axis, and
    ``torch.utils.checkpoint`` can run it again in a backward pass.

    ``body(arrays, draws, step, gates, slot=None, step_t=None)``: the sim
    time is ``engine_table.sim_time`` of ``step_t``, the step as a 0-dim
    int64 tensor on the arrays' device (by default made from the host
    ``step``), so that a CUDA graph of ungated steps reads it from a
    tensor it refills; the host ``step`` serves the gated branches."""
    collide = _collide_fn(params, backend, differentiable)
    dt = params.timestep
    cog_steps = params.centroid_steps_interval

    def body(arrays: dict, draws: dict, step: int, gates: tuple, slot=None,
             step_t: torch.Tensor | None = None) -> dict:
        pos, vel, rad, phase, dead, ring = (
            arrays[k] for k in ("pos", "vel", "rad", "phase", "dead", "centroid_ring")
        )
        dev = pos.device
        n_pad = pos.shape[-2]
        mask = active_mask(params, n_pad, dev)
        payload = payload_mask(params, n_pad, dev)
        time = sim_time(step_tensor(step, dev) if step_t is None else step_t, dt)
        dead_gate, cog_gate, phase_gate = gates

        # 1. dead-cell injection (one-shot)
        if dead_gate:
            dead = _inject_dead(params, dead, mask, draws["scores"])

        # 2. centroid ring buffer (reference ring index:
        #    (int)(time / centroid_int) % centroid_steps), written out of
        #    place
        if cog_gate:
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            centroid = torch.sum(
                torch.where(mask[:, None], pos, zero), dim=0
            ) / f32(params.n_cells)
            row = torch.arange(ring.shape[-2], device=dev)[:, None]
            idx = (step // cog_steps) % params.centroid_steps
            ring = torch.where(row == idx, centroid[None, :], ring)

        # 3. phase controller
        if phase_gate:
            phase = update_phase(
                params, pos, phase, mask, rng.Drawn(normal=draws.get("noise")),
                step=step,
            )

        # 4. radius controller — consumes previous collide's magnitudes
        rad = update_radius(
            params, rad, phase, arrays["abs_force_a"], arrays["abs_force_r"],
            dead, mask, time, dt,
        )

        # 5. integrate + boundary
        pos, vel = integrate(params, pos, vel, rad, dt)

        # 6. collide -> next-step velocity + force magnitudes
        if slot is not None:
            new_vel, abs_a, abs_r = collide(
                params, pos, vel, rad, mask, payload, dt, slot=slot
            )
        else:
            new_vel, abs_a, abs_r = collide(params, pos, vel, rad, mask, payload, dt)
        return {
            "pos": pos, "vel": new_vel, "rad": rad, "phase": phase, "dead": dead,
            "abs_force_a": abs_a, "abs_force_r": abs_r, "centroid_ring": ring,
        }

    return body


def make_step(params: SimParams, device="cuda",
              differentiable: bool = False) -> Callable[[SimState], SimState]:
    """The one-step transition on ``params``' backend as resolved for
    ``device``.  ``step(state, slot=None)``: on PALLAS, ``slot`` may carry a
    slot assignment reused over a few steps (``ops.pallas_stencil.
    assign_slots_slotmajor``); the other backends build their tables every
    step.  ``differentiable=True`` puts the PALLAS collide behind its
    autograd wrapper (``make_diff_pallas_collide``), so that a gradient
    flows through the whole step; the other backends are differentiable
    as they are."""
    params = params.validate()
    backend = params.resolved_backend(device)
    body = _make_body(params, backend, differentiable)

    def step(state: SimState, slot: torch.Tensor | None = None) -> SimState:
        gates = _step_gates(params, state.step)
        draws = _draws(params, state.generator, state.step, gates,
                       (state.n_pad,), state.device)
        if backend != ForceBackend.PALLAS:
            slot = None
        out = body({k: getattr(state, k) for k in ARRAY_FIELDS}, draws,
                   state.step, gates, slot)
        return state.replace(step=state.step + 1, **out)

    return step


def make_step_batched(params: SimParams, device="cuda") -> Callable[[SimState], SimState]:
    """The one-step transition of a batch of scenes in lockstep (a
    ``SimState`` with a leading scene axis, ``state.stack_states``) on the
    DENSE, STENCIL or CELLGRID backend: the gates are decided once from
    the shared step counter, every scene's draws are taken from its own
    source (``rng.SceneDraws``), and the per-scene step is
    ``torch.func.vmap`` ped over the scene axis, so one sequence of
    launches serves every scene.  The PALLAS backend's batched run is the
    table loop (``engine_table.make_run_chunk_table_batched``)."""
    params = params.validate()
    backend = params.resolved_backend(device)
    if backend == ForceBackend.PALLAS:
        raise ValueError(
            "the batched per-bot step takes DENSE, STENCIL or CELLGRID; PALLAS "
            "batches run the table loop (make_run_chunk_batched)"
        )
    body = _make_body(params, backend)

    def step(state: SimState) -> SimState:
        gates = _step_gates(params, state.step)
        shape = (state.pos.shape[0], state.n_pad)
        draws = _draws(params, state.generator, state.step, gates, shape, state.device)
        out = torch.func.vmap(
            functools.partial(body, step=state.step, gates=gates)
        )({k: getattr(state, k) for k in ARRAY_FIELDS}, draws)
        return state.replace(step=state.step + 1, **out)

    return step


def make_run_chunk(params: SimParams, device="cuda"):
    """``run_chunk(state, n_steps, seg_aligned=False) -> state`` for a run
    on ``device``.  PALLAS goes to the table-resident loop (the adaptive-K
    runner from 4096 bots up), DENSE, STENCIL and CELLGRID to the per-bot
    block runner (:func:`_step_runner`).  Every runner has
    ``run_chunk.blocks``, the chunk as a block iterator
    (``engine_table.interleave`` runs several)."""
    params = params.validate()
    backend = params.resolved_backend(device)
    if backend == ForceBackend.PALLAS:
        if params.adaptive_rebuild():
            return make_adaptive_run_chunk(params)
        return make_run_chunk_table(params)
    return _step_runner(params, device, batched=False)


def _step_runner(params: SimParams, device, batched: bool):
    """The per-bot chunk runner of DENSE, STENCIL or CELLGRID, on one scene
    or (``batched``) on a batch in lockstep (:func:`make_step_batched`'s).

    Like the JAX package's scanned chunk it reads nothing from the device.
    Gated steps (dead injection, centroid or phase gate: the steps that
    draw or write the ring) and the ragged end of the chunk run eagerly,
    one at a time; every stretch of :data:`BLOCK_STEPS` steps that fires
    no gate runs as one block, whose sim times come from a device step
    tensor.  On the card each block replays a CUDA graph
    (``engine_table._CapturedBlock``) captured once per runner and carry
    layout after the first block ran eagerly; a failed capture raises.  On
    the CPU every block runs eagerly, through the same code.
    ``run_chunk.blocks(state, n_steps, seg_aligned=False)`` yields after
    each step or block (``seg_aligned`` is taken for the table runners'
    signature, and changes nothing here).  A runner advances one chunk at
    a time (its graphs hold that chunk's carry)."""
    eager_step = (make_step_batched if batched else make_step)(params, device)
    body = _make_body(params, params.resolved_backend(device))
    no_gates = (False, False, False)

    def ungated(arrays: dict, step_t: torch.Tensor) -> dict:
        if batched:
            return torch.func.vmap(functools.partial(
                body, step=None, gates=no_gates, step_t=step_t))(arrays, {})
        return body(arrays, {}, None, no_gates, step_t=step_t)

    def block(carry: dict, step0: torch.Tensor) -> dict:
        arrays = dict(carry)
        for j in range(BLOCK_STEPS):
            out = ungated(arrays, step0 + j)
            arrays.update({k: out[k] for k in _UNGATED_OUT})
        return {k: arrays[k] for k in _UNGATED_OUT}

    def gated(s: int) -> bool:
        return any(_step_gates(params, s))

    graphs: dict = {}

    @_one_chunk_at_a_time
    def blocks(state: SimState, n_steps: int, seg_aligned: bool = False):
        j, on_card = 0, state.device.type == "cuda"
        graphed = False
        while j < n_steps:
            s = state.step
            if j + BLOCK_STEPS <= n_steps and not any(
                    gated(s + i) for i in range(BLOCK_STEPS)):
                arrays = {k: getattr(state, k) for k in ARRAY_FIELDS}
                out = _graphed(graphs, (state.device, tuple(state.pos.shape)), block,
                               arrays, s)
                state = state.replace(step=s + BLOCK_STEPS, **out)
                graphed = graphed or on_card
                j += BLOCK_STEPS
            else:
                state = eager_step(state)
                j += 1
            yield
        if graphed:
            # arrays may sit in a graph's buffers, which the runner's next
            # chunk overwrites
            state = state.replace(**{k: getattr(state, k).clone() for k in ARRAY_FIELDS})
        return state

    def run_chunk(state: SimState, n_steps: int, seg_aligned: bool = False):
        return drain(blocks(state, n_steps, seg_aligned))

    run_chunk.blocks = blocks
    return run_chunk


def make_run_chunk_batched(params: SimParams, device="cuda"):
    """``run_chunk(state, n_steps, seg_aligned=False) -> state`` for a batch
    of scenes in lockstep (a ``SimState`` with a leading scene axis; every
    batch builder of the package starts its scenes at one step).  PALLAS
    goes to the batched table loop
    (``engine_table.make_run_chunk_table_batched``: kernels 1 to 3 each
    take every scene in one launch), DENSE, STENCIL and CELLGRID to the
    per-bot block runner on :func:`make_step_batched`'s vmapped step."""
    params = params.validate()
    if params.resolved_backend(device) == ForceBackend.PALLAS:
        return make_run_chunk_table_batched(params)
    return _step_runner(params, device, batched=True)
