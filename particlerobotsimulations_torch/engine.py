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
others to the per-bot block runner: from each gate, blocks of up to
:data:`BLOCK_STEPS` steps that the card replays from CUDA graphs (the
gated step's draws taken beforehand and fed in), the sim time a device
scalar, nothing read inside a chunk (the JAX package's scanned chunk).
The random draws go through ``rng.py`` with the step they are drawn for.  :func:`make_run_chunk_batched`
runs a batch of scenes in lockstep (the seed sweep): PALLAS through the
batched table loop, the other backends through the same block runner on
:func:`make_step_batched`, the per-scene step vmapped over the scene
axis.  On DENSE on the card, steps 4-6 of every scene are one launch of
the dense step (``ops/dense_step.py``, ``csrc/dense_step.cu``), outside
the ``vmap``.  ``make_step(...,
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

from . import kernels, rng
from .config import ForceBackend, SimParams
from .ops.dense_step import step_tail
from .ops.forces import dense_collide
from .ops.grid import cellgrid_collide
from .ops.pallas_stencil import make_diff_pallas_collide, pallas_stencil_collide
from .ops.phase import update_phase
from .ops.stencil import stencil_collide
from .engine_table import (
    NO_GATES,
    _draws,
    _graphed,
    _one_chunk_at_a_time,
    _ring_write,
    _step_gates,
    drain,
    make_adaptive_run_chunk,
    make_run_chunk_table,
    make_run_chunk_table_batched,
    sim_time,
    step_tensor,
)
from .state import ARRAY_FIELDS, SimState, active_mask, payload_mask
from .utils import trace

f32 = np.float32

# steps per block of the per-bot chunk runner: a stretch between gates of
# the DENSE, STENCIL or CELLGRID loop runs as blocks of this many steps
# and one shorter block, each replayed on the card from one CUDA graph.
# 8 beat 32 at 500 DENSE bots (chip_smoke.py phase 17, PERF.md): a
# replay's host cost is small beside 8 steps
BLOCK_STEPS = 8


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


def _gated(arrays: dict, draws: dict, *, params: SimParams, step, gates: tuple,
           step_t: torch.Tensor, mask=None) -> dict:
    """Steps 1-3 of the step on one scene's arrays: the arrays with
    ``dead``, ``centroid_ring`` and ``phase`` as the gates that fire leave
    them (``mask``, the real bots, made when not given)."""
    pos, phase, dead, ring = (arrays[k] for k in ("pos", "phase", "dead", "centroid_ring"))
    dev = pos.device
    if mask is None:
        mask = active_mask(params, pos.shape[-2], dev)
    dead_gate, cog_gate, phase_gate = gates

    # 1. dead-cell injection (one-shot)
    if dead_gate:
        dead = _inject_dead(params, dead, mask, draws["scores"])

    # 2. centroid ring buffer (reference ring index:
    #    (int)(time / centroid_int) % centroid_steps, of the step
    #    tensor), written out of place
    if cog_gate:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        centroid = torch.sum(
            torch.where(mask[:, None], pos, zero), dim=0
        ) / f32(params.n_cells)
        ring = _ring_write(params, ring, step_t, centroid)

    # 3. phase controller
    if phase_gate:
        phase = update_phase(
            params, pos, phase, mask, rng.Drawn(normal=draws.get("noise")),
            step=step,
        )
    return {**arrays, "phase": phase, "dead": dead, "centroid_ring": ring}


def _kernel_step(params: SimParams, arrays: dict, draws: dict, step, gates: tuple,
                 step_t: torch.Tensor, offset: int, batched: bool) -> dict:
    """DENSE on the card: steps 1-3 where a gate fires (vmapped over the
    scenes where ``batched``), then steps 4-6 of every scene in one launch
    of the dense step (``kernels.dense_step_cuda``) at the step ``step_t +
    offset``."""
    if any(gates):
        gated = functools.partial(_gated, params=params, step=step, gates=gates,
                                  step_t=step_t + offset if offset else step_t)
        arrays = (torch.func.vmap(gated) if batched else gated)(arrays, draws)
    return {**arrays, **kernels.dense_step_cuda(params, arrays, step_t, offset)}


def _make_body(params: SimParams, backend: ForceBackend, differentiable: bool = False):
    """The step on one scene's arrays in PyTorch ops, with its draws taken
    beforehand (``_draws``) and its gates decided on the host: pure, so the
    batched step can ``torch.func.vmap`` it over a scene axis, and
    ``torch.utils.checkpoint`` can run it again in a backward pass.

    ``body(arrays, draws, step, gates, slot=None, step_t=None, offset=0)``:
    the sim time is ``engine_table.sim_time`` of ``step_t + offset``, the
    step as a 0-dim int64 tensor on the arrays' device (``step_t`` by
    default made from the host ``step``), so that a CUDA graph of ungated
    steps reads it from a tensor it refills; the host ``step`` serves the
    gated branches.  Steps 1-3 are :func:`_gated`, steps 4-6
    ``ops/dense_step.step_tail``.  The runners and ``make_step`` take it
    through :func:`_make_step_fn`, which sends DENSE on the card to the
    dense step instead."""
    collide = _collide_fn(params, backend, differentiable)

    def body(arrays: dict, draws: dict, step: int, gates: tuple, slot=None,
             step_t: torch.Tensor | None = None, offset: int = 0) -> dict:
        pos = arrays["pos"]
        dev = pos.device
        if step_t is None:
            step_t = step_tensor(step, dev)
        if offset:
            step_t = step_t + offset
        n_pad = pos.shape[-2]
        mask = active_mask(params, n_pad, dev)
        payload = payload_mask(params, n_pad, dev)
        time = sim_time(step_t, params.timestep)
        arrays = _gated(arrays, draws, params=params, step=step, gates=gates,
                        step_t=step_t, mask=mask)
        return {**arrays, **step_tail(params, collide, arrays, mask, payload, time, slot)}

    return body


def _make_step_fn(params: SimParams, backend: ForceBackend, batched: bool,
                  differentiable: bool = False):
    """``fn(arrays, draws, step, gates, step_t=None, offset=0, slot=None)``:
    :func:`_make_body`'s step on one scene's arrays, or (``batched``) on B
    scenes' with a leading scene axis, vmapped over it.  The one place that
    routes a step to the dense step: on DENSE on the card, unless
    ``differentiable``, the gated ops run as PyTorch ops (vmapped where
    ``batched``) and steps 4-6 of every scene are one launch
    (:func:`_kernel_step`), which no ``vmap`` may wrap."""
    body = _make_body(params, backend, differentiable)
    kernel = backend == ForceBackend.DENSE and not differentiable

    def fn(arrays: dict, draws: dict, step, gates: tuple,
           step_t: torch.Tensor | None = None, offset: int = 0, slot=None) -> dict:
        dev = arrays["pos"].device
        if kernel and dev.type == "cuda":
            if step_t is None:
                step_t = step_tensor(step, dev)
            return _kernel_step(params, arrays, draws, step, gates, step_t, offset, batched)
        if batched:
            return torch.func.vmap(functools.partial(
                body, step=step, gates=gates, step_t=step_t, offset=offset))(arrays, draws)
        return body(arrays, draws, step, gates, slot, step_t, offset)

    return fn


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
    fn = _make_step_fn(params, backend, batched=False, differentiable=differentiable)

    def step(state: SimState, slot: torch.Tensor | None = None) -> SimState:
        gates = _step_gates(params, state.step)
        draws = _draws(params, state.generator, state.step, gates,
                       (state.n_pad,), state.device)
        if backend != ForceBackend.PALLAS:
            slot = None
        out = fn({k: getattr(state, k) for k in ARRAY_FIELDS}, draws,
                 state.step, gates, slot=slot)
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
    fn = _make_step_fn(params, backend, batched=True)

    def step(state: SimState) -> SimState:
        gates = _step_gates(params, state.step)
        shape = (state.pos.shape[0], state.n_pad)
        draws = _draws(params, state.generator, state.step, gates, shape, state.device)
        out = fn({k: getattr(state, k) for k in ARRAY_FIELDS}, draws, state.step, gates,
                 step_tensor(state.step, state.device))
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


def bot_pieces(params: SimParams, start: int, n: int, block_steps: int) -> list:
    """The per-bot runner's schedule of ``n`` steps from step ``start``:
    ``[(gates, length)]``, each a block that a CUDA graph replays on the
    card.  A block starts at each gated step, the dead injection's
    included (``gates`` are its first step's; the others fire none), and
    runs to the next gated step or the chunk's end, at most
    ``block_steps`` steps: a stretch of L steps between gates is ``L //
    block_steps`` whole blocks and one short block."""
    pieces, j = [], 0
    while j < n:
        s = start + j
        length = 1
        while (length < block_steps and j + length < n
               and not any(_step_gates(params, s + length))):
            length += 1
        pieces.append((_step_gates(params, s), length))
        j += length
    return pieces


def _step_runner(params: SimParams, device, batched: bool):
    """The per-bot chunk runner of DENSE, STENCIL or CELLGRID, on one scene
    or (``batched``) on a batch in lockstep (:func:`make_step_batched`'s).

    Like the JAX package's scanned chunk it reads nothing from the device.
    The chunk runs as :func:`bot_pieces`: a block starts at each gated
    step (the dead injection's too), its first step fires the gates with
    the draws taken just before the block (``_draws``, fed in with the
    carry: the dead step's scores, the phase noise) and its other steps
    fire none, its sim times and centroid row come from a device step
    tensor.  On the card each block, the chunk's last short one included,
    replays a CUDA graph (``engine_table._CapturedBlock``, through
    ``_graphed``) captured once per runner, carry layout, first-step gates
    and length; a failed capture raises.  The runner's first block of a
    layout runs eagerly before its capture, and on the CPU every block
    does, through the same code.  ``run_chunk.blocks(state, n_steps,
    seg_aligned=False)`` yields after each piece (``seg_aligned`` is taken
    for the table runners' signature, and changes nothing here);
    ``run_chunk.eager_steps`` is 0 (no step of a chunk runs eagerly by
    design).  A runner advances one chunk at a time (its graphs hold that
    chunk's carry).  A call is a ``chunk`` span where tracing is on
    (``utils/trace``)."""
    backend = params.resolved_backend(device)
    step = _make_step_fn(params, backend, batched)
    graphs: dict = {}
    fns: dict = {}

    def piece(gates: tuple, length: int):
        if (gates, length) not in fns:
            def block(carry: dict, step0: torch.Tensor) -> dict:
                arrays = {k: carry[k] for k in ARRAY_FIELDS}
                draws = {k: carry[k] for k in ("scores", "noise") if k in carry}
                for j in range(length):
                    arrays = step(arrays, draws if j == 0 else {}, None,
                                  gates if j == 0 else NO_GATES, step0, j)
                return arrays

            block.steps = length
            fns[gates, length] = block
        return fns[gates, length]

    @_one_chunk_at_a_time
    def blocks(state: SimState, n_steps: int, seg_aligned: bool = False):
        dev = state.device
        shape = (state.pos.shape[0], state.n_pad) if batched else (state.n_pad,)
        for gates, length in bot_pieces(params, state.step, n_steps, BLOCK_STEPS):
            s = state.step
            carry = {k: getattr(state, k) for k in ARRAY_FIELDS}
            with trace.work(dev):
                carry.update(_draws(params, state.generator, s, gates, shape, dev))
            out = _graphed(graphs, ("bot", dev, tuple(state.pos.shape), gates, length),
                           piece(gates, length), carry, s)
            state = state.replace(step=s + length, **{k: out[k] for k in ARRAY_FIELDS})
            yield
        if dev.type == "cuda":
            # arrays may sit in a graph's buffers, which the runner's next
            # chunk overwrites
            with trace.work(dev):
                state = state.replace(**{k: getattr(state, k).clone() for k in ARRAY_FIELDS})
        return state

    def run_chunk(state: SimState, n_steps: int, seg_aligned: bool = False):
        if not trace.ON:
            return drain(blocks(state, n_steps, seg_aligned))
        with trace.span("chunk", steps=n_steps, scenes=state.pos.shape[0] if batched else 1,
                        path=backend.name):
            return drain(blocks(state, n_steps, seg_aligned))

    run_chunk.blocks = blocks
    run_chunk.eager_steps = 0
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
