"""PyTorch port, the gated blocks: every step of a chunk from a block, on
the CPU.

The port's loops take a gated step's random draws before the block that
holds it (``chunk.draws``) and feed them
in with the block's carry (``rng.Drawn``), so that a CUDA graph replays
gated blocks as it replays ungated ones: the table loop's K-step blocks
(single and batched), the per-bot runner's blocks from each gate (DENSE,
STENCIL, CELLGRID), the sharded loop's blocks and the adaptive probe's
segment, with its running maximum in the carry.  On the CPU every block
runs eagerly through the code a graph captures.

Held here, bit for bit: ``step_pre`` with its draws fed in against the
step as it was (the draws made in place, the centroid ring written by
index; kept in this file), the generator's state included; each runner
against a one-step-at-a-time loop over a chunk that crosses at least
three gate steps and the dead injection; the probe against the
step-by-step probe (state and maximum); that every step of each went
through ``chunk.graphed`` (its count of eager steps, ``chunk.EAGER``);
and no tensor converted to a Python value inside a chunk.  Against the JAX package on its own draws
(``JaxDraws``, ``tests/test_torch_rng.py``) at 24 bots: the table loop's
and DENSE's chunks over 24 steps at the slice tests' tolerances
(positions 1e-5, velocities 1e-4, radii and ring 1e-6, phases 1e-4; dead
sets equal), and the probe (state at those tolerances, its maximum within
1e-4 relative).  Also the launch counts' settlement of a conditional
body's launches.  Sizes: 24-40 bots, at most 24 steps.
"""

import dataclasses

import numpy as np
import pytest
import torch

import particlerobotsimulations_torch as pt
import particlerobotsimulations_tpu as pj
from particlerobotsimulations_torch import chunk as t_chunk
from particlerobotsimulations_torch import engine as t_engine
from particlerobotsimulations_torch import engine_table as t_et
from particlerobotsimulations_torch import kernels, rng
from particlerobotsimulations_torch import state as t_state
from particlerobotsimulations_torch.config import Control
from particlerobotsimulations_torch.ops.integrate import radius_integrate_planes
from particlerobotsimulations_torch.ops.phase import update_phase
from particlerobotsimulations_torch.parallel import spatial_table as t_st
from particlerobotsimulations_torch.parallel.ring import LocalRing
from particlerobotsimulations_torch.parallel.sweep import make_batch_state
from particlerobotsimulations_torch.state import ARRAY_FIELDS, state_to_arrays
from particlerobotsimulations_tpu import engine_table as j_et

from test_torch_rng import arrays_of, jittered, port_state

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

f32 = np.float32
TOL = {"pos": 1e-5, "vel": 1e-4, "rad": 1e-6, "centroid_ring": 1e-6, "phase": 1e-4}
# what a chunk must not call on a tensor: each converts it to a Python value
HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu",
              "numpy")


def gated_params(**kw):
    """24 HEX bots, K=4: the centroid every 4 steps, the noisy phase law
    every 6, three bots killed at step 5."""
    base = dict(n_cells=24, n_dead=3, time_to_dead=0.05, seed=4, config=pt.Config.HEX,
                phase_std=0.5, centroid_int=0.04, phase_update_interval=0.06,
                light_x=-3.0, light_y=1.0, slot_rebuild_steps=4,
                force_backend=pt.ForceBackend.PALLAS)
    base.update(kw)
    return pt.SimParams(**base).validate()


def fresh(p, batched, seeds=(0, 1)):
    if batched:
        return make_batch_state(p, list(seeds), "cpu")
    return pt.Simulation(p, device="cpu").state


def sources(gen):
    return gen.sources if isinstance(gen, rng.SceneDraws) else [gen]


def assert_states_equal(got, want):
    for k in ARRAY_FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert got.step == want.step
    for a, b in zip(sources(got.generator), sources(want.generator)):
        assert torch.equal(a.get_state(), b.get_state())


def eager_counts(fn):
    """``(fn(), counts)``: ``chunk.EAGER``, the steps blocks ran eagerly
    on the card and off it, counted from 0 while ``fn`` runs.  Off the
    card every block runs eagerly through ``chunk.graphed``, so a chunk
    whose every step went through it counts all of its steps
    ``off_card``."""
    for key in t_chunk.EAGER:
        t_chunk.EAGER[key] = 0
    out = fn()
    return out, dict(t_chunk.EAGER)


def gate_steps(p, start, n):
    """The steps of ``start`` .. ``start + n - 1`` that fire a gate."""
    return [s for s in range(start, start + n) if any(t_chunk.step_gates(p, s))]


# ------------------------------------------------------------- the draws

def old_step_pre(params):
    """``step_pre`` as it was: the draws made in place from the carry's
    source, the centroid ring written by index at the host step."""
    def step_pre(ts, dead_gate, cog_gate, phase_gate):
        f = dict(ts.fields)
        time = t_state.sim_time(t_state.step_tensor(ts.step, "cpu"), params.timestep)
        val = f["val"] > 0.5
        if params.n_dead > 0 and dead_gate:
            f["dead"] = t_et._inject_dead_table(params, f, ts.generator, ts.step)
        ring = ts.centroid_ring
        if cog_gate:
            cx = torch.sum(f["px"] * f["val"], dim=-1) / f32(params.n_cells)
            cy = torch.sum(f["py"] * f["val"], dim=-1) / f32(params.n_cells)
            idx = (ts.step // params.centroid_steps_interval) % params.centroid_steps
            ring = ring.clone()
            ring[..., idx, :] = torch.stack([cx, cy], dim=-1)
        if params.control == Control.LIGHT_WAVE and phase_gate:
            pos_t = torch.stack([f["px"], f["py"]], dim=-1)
            f["phase"] = update_phase(params, pos_t, f["phase"], val, ts.generator,
                                      step=ts.step)
        f = radius_integrate_planes(params, f, time)
        return ts.replace(fields=f, centroid_ring=ring)

    return step_pre


PATTERNS = {
    "dead": (True, False, False),
    "cog": (False, True, False),
    "phase": (False, False, True),
    "cog+phase": (False, True, True),
}


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_fed_draws_equal_draws_in_place(pattern, batched):
    """``step_pre`` with the step's draws taken beforehand
    (``_draws``) and fed in (``rng.Drawn``) equals the step drawing
    in place, bit for bit: fields, centroid ring, and every generator's
    state after the step (a draw made where the old step made none would
    shift it)."""
    p = gated_params()
    gates = PATTERNS[pattern]
    pre, _ = t_et.make_table_step_parts(p)
    a, b = (t_et.enter_table(p, fresh(p, batched).replace(step=12)) for _ in range(2))
    want = old_step_pre(p)(a, *gates)
    draws = t_chunk.draws(p, b.generator, 12, gates, b.fields["dead"].shape, "cpu")
    assert set(draws) == ({"scores"} if gates[0] else set()) | (
        {"noise"} if gates[2] else set())
    got = pre(b, *gates, source=rng.Drawn(draws.get("scores"), draws.get("noise")))
    for k in t_state.TABLE_FIELDS:
        assert torch.equal(got.fields[k], want.fields[k]), k
    assert torch.equal(got.centroid_ring, want.centroid_ring)
    for ga, gb in zip(sources(a.generator), sources(b.generator)):
        assert torch.equal(ga.get_state(), gb.get_state())
    changed = {"dead": "dead", "cog": None, "phase": "phase", "cog+phase": "phase"}[pattern]
    if changed:
        assert not torch.equal(got.fields[changed], b.fields[changed])
    if gates[1]:
        assert not torch.equal(got.centroid_ring, b.centroid_ring)


# ------------------------------------------- the runners, one step at a time

START, N_STEPS = 1, 22


def table_step_loop(p, state, n):
    """``make_table_step`` one step at a time on the regular schedule,
    drawing in place."""
    step = t_et.make_table_step(p)
    k = p.resolved_slot_rebuild_steps()
    ts = t_et.enter_table(p, state)
    for j in range(n):
        ts = step(ts, *t_chunk.gates(p, ts.step), j % k == k - 1)
    return t_et.exit_table(p, ts)


@pytest.mark.parametrize("batched", [False, True])
def test_table_runner_equals_step_loop(batched):
    """22 steps from step 1 (the centroid at 4, 8, 12, 16, 20, the phase
    law at 6, 12, 18, the dead injection at 5) through the table runner's
    blocks equal ``make_table_step`` one step at a time, bit for bit, with
    the same rebuild counts; every step went through ``chunk.graphed``
    (the dead step rides in its block, the 2-step ragged tail is a
    block)."""
    p = gated_params()
    assert len(gate_steps(p, START, N_STEPS)) >= 7 and START <= p.dead_step < START + N_STEPS
    run = (t_et.make_run_chunk_table_batched if batched else t_et.make_run_chunk_table)(p)
    for k in t_et.REBUILDS:
        t_et.REBUILDS[k] = 0
    got, eager = eager_counts(lambda: run(fresh(p, batched).replace(step=START), N_STEPS))
    counts = dict(t_et.REBUILDS)
    for k in t_et.REBUILDS:
        t_et.REBUILDS[k] = 0
    want = table_step_loop(p, fresh(p, batched).replace(step=START), N_STEPS)
    assert_states_equal(got, want)
    assert counts == dict(t_et.REBUILDS) and sum(counts.values()) == 5
    assert eager == {"card": 0, "off_card": N_STEPS}
    assert int(got.dead[..., : p.n_cells].sum()) == 3 * (2 if batched else 1)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("backend", ["DENSE", "STENCIL", "CELLGRID"])
def test_per_bot_runner_equals_step_loop(backend, batched, monkeypatch):
    """The per-bot runner at 4-step blocks over the same 22 steps (a block
    from each gate, short blocks before the next gate) equals
    ``make_step`` (``make_step_batched``) one step at a time, bit for bit;
    every step went through ``chunk.graphed`` (the dead step starts a
    block, the 3-step ragged tail is a short block)."""
    monkeypatch.setattr(t_engine, "BLOCK_STEPS", 4)
    p = gated_params(force_backend=pt.ForceBackend[backend])
    pieces = t_engine.bot_pieces(p, START, N_STEPS, 4)
    assert [n for _, n in pieces] == [3, 1, 1, 2, 4, 4, 2, 2, 3]
    assert [g[0] for g, _ in pieces] == [False, False, True] + [False] * 6
    run = (t_engine.make_run_chunk_batched if batched else t_engine.make_run_chunk)(p, "cpu")
    got, eager = eager_counts(lambda: run(fresh(p, batched).replace(step=START), N_STEPS))
    step = (t_engine.make_step_batched if batched else t_engine.make_step)(p, "cpu")
    want = fresh(p, batched).replace(step=START)
    for _ in range(N_STEPS):
        want = step(want)
    assert_states_equal(got, want)
    assert eager == {"card": 0, "off_card": N_STEPS}


@pytest.mark.parametrize("batched", [False, True])
def test_sharded_runner_equals_step_loop(batched, monkeypatch):
    """The sharded loop on ``LocalRing(2)`` over the same 22 steps, its
    K-step blocks gated or not, equals the same loop cut into one-step
    pieces (each step alone, its draws taken just before it), bit for bit
    with equal fallback counts."""
    p = t_st.resolve_tp_params(gated_params(n_cells=40), 2)
    make = t_st.make_sharded_table_run_batched if batched else t_st.make_sharded_table_run
    run, _ = make(p, LocalRing(2, "cpu"), with_stats=True)
    (got, stats), eager = eager_counts(lambda: run(fresh(p, batched).replace(step=START),
                                                   N_STEPS))
    assert eager == {"card": 0, "off_card": N_STEPS}

    real = t_st.table_pieces

    def one_step_pieces(params, k, start, n):
        return [(step,) for pattern in real(params, k, start, n) for step in pattern]

    monkeypatch.setattr(t_st, "table_pieces", one_step_pieces)
    run, _ = make(p, LocalRing(2, "cpu"), with_stats=True)
    (want, w_stats), eager = eager_counts(lambda: run(fresh(p, batched).replace(step=START),
                                                      N_STEPS))
    assert_states_equal(got, want)
    assert stats == w_stats and eager == {"card": 0, "off_card": N_STEPS}
    assert int(got.dead[..., : p.n_cells].sum()) == 3 * (2 if batched else 1)


# ------------------------------------------------------------ against JAX

def jax_pair(backend="PALLAS", **kw):
    """(JAX params, port params) of :func:`gated_params`."""
    base = dict(n_cells=24, n_dead=3, time_to_dead=0.05, seed=4, config=pj.Config.HEX,
                phase_std=0.5, centroid_int=0.04, phase_update_interval=0.06,
                light_x=-3.0, light_y=1.0, slot_rebuild_steps=4,
                force_backend=pj.ForceBackend[backend])
    base.update(kw)
    jp = pj.SimParams(**base).validate()
    tp = pt.SimParams(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})
    return jp, tp.validate()


def assert_close(got: dict, want: dict, n: int):
    for k, tol in TOL.items():
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0, err_msg=k)
    np.testing.assert_array_equal(got["dead"], want["dead"])
    assert int(got["step"]) == int(want["step"])
    assert int(want["dead"][:n].sum()) == 3


@pytest.mark.parametrize("backend", ["PALLAS", "DENSE"])
def test_runner_matches_jax_on_jax_draws(backend):
    """24 steps from step 0 (the dead injection at 5, the centroid and the
    phase law from step 0) on JAX's draws: the table loop (PALLAS) and the
    per-bot runner (DENSE) against the JAX package's chunks."""
    jp, tp = jax_pair(backend)
    st = jittered(jp)
    start = arrays_of(st)
    if backend == "PALLAS":
        want = arrays_of(j_et.make_run_chunk_table(jp)(st, 24))
        run = t_et.make_run_chunk_table(tp)
    else:
        want = arrays_of(pj.engine.make_run_chunk(jp)(st, 24))
        run = t_engine.make_run_chunk(tp, "cpu")
    got = state_to_arrays(run(port_state(tp, start), 24))
    assert_close(got, want, tp.n_cells)


# ------------------------------------------------------------- the probe

def probe_params(**kw):
    """K=4 in gate segments of 8 steps (the centroid every 8, the phase law
    every 16), the dead injection on the segment boundary at step 8."""
    return dict(centroid_int=0.08, phase_update_interval=0.16, time_to_dead=0.08, **kw)


def step_probe(p, state):
    """The probe one step at a time, as it was."""
    step = t_et.make_table_step(p)
    k = p.resolved_slot_rebuild_steps()
    ts = t_et.enter_table(p, state)
    pm = t_et.neighbor_rel_speed_bound(p, ts.fields)
    for j in range(t_et.gate_seg(p)):
        ts = step(ts, *t_chunk.gates(p, ts.step), j % k == k - 1)
        if j % k == k - 1:
            pm = torch.maximum(pm, t_et.neighbor_rel_speed_bound(p, ts.fields))
    return t_et.exit_table(p, ts), pm


@pytest.mark.parametrize("start", [0, 8])
def test_probe_blocks_equal_step_probe(start):
    """The probe as blocks (the gated first block, then an ungated one, the
    maximum in the carry) equals the step-by-step probe bit for bit in
    state and maximum, from step 0 and from the dead step 8 (the first
    step of the gated block); every step went through ``chunk.graphed``."""
    p = gated_params(**probe_params())
    assert t_et.gate_seg(p) == 8 and p.dead_step == 8
    probe = t_et.make_probe_chunk(p)
    (got, pm), eager = eager_counts(lambda: probe(fresh(p, False).replace(step=start)))
    want, wpm = step_probe(p, fresh(p, False).replace(step=start))
    assert_states_equal(got, want)
    assert torch.equal(pm, wpm) and float(pm) > 0
    assert eager == {"card": 0, "off_card": 8}


def test_probe_matches_jax_probe():
    """The probe over its first segment (0 .. 7), which holds the dead
    step (moved to 0), on JAX's draws against JAX's
    ``make_probe_chunk``."""
    jp, tp = jax_pair("PALLAS", **dict(probe_params(), time_to_dead=0.0))
    assert jp.dead_step == 0
    st = jittered(jp)
    start = arrays_of(st)
    want, wpm = j_et.make_probe_chunk(jp)(st)
    got, pm = t_et.make_probe_chunk(tp)(port_state(tp, start))
    assert_close(state_to_arrays(got), arrays_of(want), tp.n_cells)
    np.testing.assert_allclose(float(pm), float(wpm), rtol=1e-4)


# ---------------------------------------------------------------- no reads

READ_CASES = {
    "table": (t_et.make_run_chunk_table, "PALLAS", False),
    "table batched": (t_et.make_run_chunk_table_batched, "PALLAS", True),
    "DENSE": (lambda p: t_engine.make_run_chunk(p, "cpu"), "DENSE", False),
    "DENSE batched": (lambda p: t_engine.make_run_chunk_batched(p, "cpu"), "DENSE", True),
}


@pytest.mark.parametrize("case", list(READ_CASES))
def test_gated_chunk_reads_nothing(case, monkeypatch):
    """Between a chunk's entry and its exit nothing converts a tensor to a
    Python value: every such conversion raises while the chunk's gated
    blocks, its dead step and its tail run."""
    make, backend, batched = READ_CASES[case]
    p = gated_params(force_backend=pt.ForceBackend[backend])
    run = make(p)
    gen = run.blocks(fresh(p, batched).replace(step=START), N_STEPS)

    def refuse(name):
        def read(self, *args, **kw):
            raise AssertionError(f"a chunk called Tensor.{name}")
        return read

    with monkeypatch.context() as m:
        for name in HOST_READS:
            m.setattr(torch.Tensor, name, refuse(name))
        out = t_chunk.drain(gen)
    assert out.step == START + N_STEPS and bool(torch.isfinite(out.pos).all())


# ------------------------------------------------------- the launch counts

def test_launch_counts_settle_a_bodys_launches():
    """``kernels.LAUNCHES``: host counts add without a read; a body's
    launches, deferred on its device counter, count once per run of the
    counter when read; setting a count sets what it reads from then on."""
    counts = kernels.LaunchCounts(("a", "b"))
    counter = torch.zeros((), dtype=torch.int64)
    counts.count("a", 3)
    counts.defer({"a": 2, "b": -1}, counter)
    counts.defer({}, torch.zeros((), dtype=torch.int64))
    counter.add_(2)
    assert dict(counts) == {"a": 7, "b": -2}
    counts["a"] = 0
    counts["b"] = 0
    counter.add_(1)
    counts.count("b")
    assert dict(counts) == {"a": 2, "b": 0}
    host = counts.host_counts()
    counts.count("a", 5)
    counts.restore(host)
    assert counts["a"] == 2 and repr(counts) == "{'a': 2, 'b': 0}"
    with pytest.raises(KeyError):
        counts["c"] = 1
