"""PyTorch port, the sharded table loop's compiled chunk, on the CPU.

The sharded loop (``parallel/spatial_table.py``) reads nothing from the
device between a chunk's entry and its exit: the rebuild decision is a
select on the device (the JAX package's ``lax.cond``), the sim time comes
from a device step, and the ``with_stats`` counters are device counters
read at the exit.  The chunk is a block iterator (``run_chunk.blocks``):
K-step blocks, gated or not (replayed from CUDA graphs on the card,
eagerly here through the same code), the dead step and the ragged tail.

Held here: the loop on ``LocalRing(4)`` against the JAX package's
``make_sharded_table_run`` on 4 of the conftest's virtual CPU devices, in
the plain, forced-fallback and spill-row cases, with equal fallback counts
(the tolerances of ``tests/test_torch_spatial_table.py``: positions 1e-5,
velocities 1e-4, 1e-3 under 50 u/s bulk motion, radii 1e-6 without
it, as that file compares them; no phase
noise, no dead injection, as the two packages draw from different
streams); ``blocks`` drained bit for bit ``run_chunk``; the number of
blocks against the schedule; one chunk at a time; the dp x tp mesh entry
(its places interleaved) bit for bit each group alone; and no tensor
converted to a Python value inside a chunk.  Sizes: 64-96 bots, 12-30
steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import particlerobotsimulations_torch as pt
import particlerobotsimulations_tpu as pj
from particlerobotsimulations_torch.chunk import drain
from particlerobotsimulations_torch.parallel import spatial_table as t_st
from particlerobotsimulations_torch.parallel.mesh import Mesh as TorchMesh
from particlerobotsimulations_torch.parallel.ring import LocalRing
from particlerobotsimulations_torch.parallel.sweep import make_batch_state
from particlerobotsimulations_torch.rng import SceneDraws
from particlerobotsimulations_torch.state import (
    ARRAY_FIELDS,
    scene_state,
    state_from_arrays,
    state_to_arrays,
)
from particlerobotsimulations_tpu.parallel import spatial_table as j_st

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

D = 4
STATE_KEYS = ("pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r",
              "centroid_ring")
# what a chunk must not call on a tensor: each converts it to a Python value
HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu",
              "numpy")


def params_pair(n_shards=D, **kw):
    """(JAX params, port params), both resolved for ``n_shards`` shards."""
    base = dict(
        n_cells=64, n_dead=0, seed=3, config=pj.Config.HEX,
        force_backend=pj.ForceBackend.PALLAS, phase_std=0.0, light_x=-5.0,
    )
    base.update(kw)
    jp = j_st.resolve_tp_params(pj.SimParams(**base), n_shards)
    tp = pt.SimParams(
        **{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    ).validate()
    return jp, tp


def start_arrays(tp, vel=None, seed=99):
    """Bot-order arrays of a fresh scene, positions jittered by 1e-4 (the
    HEX lattice's tangencies broken), every bot at ``vel``, from numpy."""
    a = state_to_arrays(pt.Simulation(tp, device="cpu").state)
    n = tp.n_cells
    rng = np.random.default_rng(seed)
    a["pos"][:n] += (1e-4 * rng.standard_normal((n, 2))).astype(np.float32)
    if vel is not None:
        a["vel"][:n] = np.asarray(vel, np.float32)
    return a


def assert_states_equal(got, want):
    for k in STATE_KEYS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert got.step == want.step


# ------------------------------------------------------------ against JAX

CASES = {
    # name: (extra params, velocity of every bot, steps, velocity atol)
    "plain": ({}, None, 12, 1e-4),
    "fallback": ({}, (50.0, 0.0), 12, 1e-3),
    "spill": ({"n_cells": 96, "cell_capacity": 8, "overflow_slots": 8}, (0.0, 2.0), 12, 1e-4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_chunk_matches_jax(case):
    """The chunk on ``LocalRing(4)`` against JAX's sharded loop on 4 virtual
    devices from one state: per bot within the stated tolerances, the
    fallback and spill counts equal.  ``fallback`` moves every bot 50 u/s:
    the incremental rebuild refuses (>1-cell moves) and both loops take the
    exact global rebuild; ``spill`` packs 8 force-visible slots and 8 spill
    rows per cell, and the HEX blob fills spill rows."""
    extra, vel, n_steps, vel_atol = CASES[case]
    jp, tp = params_pair(**extra)
    a = start_arrays(tp, vel)
    mesh = Mesh(np.array(jax.devices()[:D]), ("bots",))
    jrun, jp2 = j_st.make_sharded_table_run(jp, mesh, axis="bots", with_stats=True)
    assert jp2 == jp
    st = pj.Simulation(jp).state
    st = st._replace(**{k: jnp.asarray(a[k]) for k in ("pos", "vel", "rad", "phase", "dead")})
    want, jstats = jrun(st, n_steps)
    jstats = {k: int(v) for k, v in jstats.items()}

    run, p2 = t_st.make_sharded_table_run(tp, LocalRing(D, "cpu"), with_stats=True)
    assert p2 == tp
    out, stats = run(state_from_arrays(tp, a, "cpu"), n_steps)
    got = state_to_arrays(out)
    n = tp.n_cells
    np.testing.assert_allclose(got["pos"][:n], np.asarray(want.pos)[:n], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["vel"][:n], np.asarray(want.vel)[:n], atol=vel_atol, rtol=0)
    if case != "fallback":
        np.testing.assert_allclose(got["rad"][:n], np.asarray(want.rad)[:n], atol=1e-6, rtol=0)
    assert int(got["step"]) == int(want.step) == n_steps
    assert stats["fallbacks"] == jstats["fallbacks"]
    if case == "fallback":
        assert stats["fallbacks"] == n_steps // tp.resolved_slot_rebuild_steps()
        assert got["pos"][:n, 0].mean() - a["pos"][:n, 0].mean() > 2.0
    elif case == "spill":
        assert stats["spill_rows_max"] == jstats["spill_rows_max"] > 0
    else:
        assert stats == {"fallbacks": 0, "spill_rows_max": 0}


# ------------------------------------------------------------- the blocks


def count_blocks(run, state, n_steps):
    """(final result, blocks yielded) of ``run.blocks``."""
    gen = run.blocks(state, n_steps)
    n = 0
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value, n
        n += 1


@pytest.mark.parametrize("batched", [False, True])
def test_blocks_drained_equal_run_chunk(batched):
    """``drain(run_chunk.blocks(...))`` is bit for bit ``run_chunk(...)``,
    stats included (read by ``read_stats``): 64 bots (two scenes of 64 for
    the dp x tp entry) with dead injection and phase noise, 20 steps across
    a centroid and a phase gate, on ``LocalRing(2)``."""
    _, tp = params_pair(n_shards=2, n_dead=5, time_to_dead=0.06, phase_std=0.5,
                        phase_update_interval=0.08, centroid_int=0.1)
    if batched:
        run, _ = t_st.make_sharded_table_run_batched(tp, LocalRing(2, "cpu"), with_stats=True)

        def fresh():
            return make_batch_state(tp, [0, 1], "cpu")
    else:
        run, _ = t_st.make_sharded_table_run(tp, LocalRing(2, "cpu"), with_stats=True)

        def fresh():
            return pt.Simulation(tp, device="cpu").state
    # each run from a fresh state: a run advances its state's draw source
    got, stats = run.read_stats(drain(run.blocks(fresh(), 20)))
    want, want_stats = run(fresh(), 20)
    assert_states_equal(got, want)
    assert stats == want_stats and all(isinstance(v, int) for v in stats.values())
    assert int(got.dead[..., : tp.n_cells].sum()) == 5 * (2 if batched else 1)


SCHEDULES = {
    # name: (K, phase gate period, start step, steps, blocks yielded, rebuilds)
    # the phase gate at step 12: steps 12-15 (j = 4..7) are a gated block
    "phase gate": (4, 12, 8, 12, 3, 3),
    # 10 steps from step 1: two blocks of 4, then the ragged tail of two
    # steps with no rebuild, one piece
    "ragged tail": (4, 12, 1, 10, 2 + 1, 2),
    # K > 8 is absolute: steps 13-23 a block (the rebuild at 23), a block
    # from 24, the block from 36 crosses the gate at 40 (the rebuild at
    # 47), then the ragged 48-50
    "K > 8": (12, 40, 13, 38, 4, 3),
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_blocks_follow_the_schedule(case, monkeypatch):
    """The blocks yielded and the rebuilds taken match the schedule: a
    K-step block, gated or not, yields once, and so does the ragged tail;
    K <= 8 rebuilds at chunk-relative ``j % K == K - 1``,
    K > 8 at absolute ``step % K == K - 1``.  The centroid gate fires every
    1,000 steps, outside these chunks."""
    k, period, start, n_steps, want_blocks, want_rebuilds = SCHEDULES[case]
    _, tp = params_pair(n_shards=2, slot_rebuild_steps=k,
                        phase_update_interval=period / 100, centroid_int=10.0)
    assert tp.phase_update_steps == period and tp.centroid_steps_interval == 1000
    rebuilds = []
    real = t_st._all_ok

    def counted(ring, ok_local):
        rebuilds.append(None)
        return real(ring, ok_local)

    monkeypatch.setattr(t_st, "_all_ok", counted)
    run, _ = t_st.make_sharded_table_run(tp, LocalRing(2, "cpu"))
    state = pt.Simulation(tp, device="cpu").state.replace(step=start)
    out, n_blocks = count_blocks(run, state, n_steps)
    assert (n_blocks, len(rebuilds)) == (want_blocks, want_rebuilds)
    assert out.step == start + n_steps


def test_blocks_refuse_a_second_chunk_at_once():
    """A runner's graphs hold one chunk's carry: a second chunk on the same
    runner while one is open raises."""
    _, tp = params_pair(n_shards=2)
    run, _ = t_st.make_sharded_table_run(tp, LocalRing(2, "cpu"))
    st = pt.Simulation(tp, device="cpu").state
    first = run.blocks(st, 8)
    next(first)
    with pytest.raises(RuntimeError, match="one chunk at a time"):
        next(run.blocks(st, 8))
    first.close()
    assert drain(run.blocks(st, 8)).step == 8


def test_mesh_entry_interleaves_its_places(monkeypatch):
    """The dp x tp mesh entry on two data places of two shards each (4
    scenes, 2 per place; scene 3 kicked to 60 u/s, so its place falls
    back): the places' blocks alternate, its blocks drained are bit for
    bit the entry's chunk, every scene is bit for bit its group run alone
    through the ring entry, and the stats are the groups' summed and
    maxed."""
    order = []
    real = t_st.interleaved

    def logged(iterators):
        def wrap(i, it):
            while True:
                try:
                    next(it)
                except StopIteration as stop:
                    return stop.value
                order.append(i)
                yield

        return (yield from real(wrap(i, it) for i, it in enumerate(iterators)))

    monkeypatch.setattr(t_st, "interleaved", logged)
    _, tp = params_pair(n_shards=2)

    def fresh():
        batch = make_batch_state(tp, [0, 1, 2, 3], "cpu")
        vel = batch.vel.clone()
        vel[3, 0, 0] = 60.0
        return batch.replace(vel=vel)

    mesh = TorchMesh(np.array(["cpu"] * 4).reshape(2, 2), ("data", "bots"))
    mrun, _ = t_st.make_sharded_table_run_batched(tp, mesh=mesh, with_stats=True)
    got, stats = mrun.read_stats(drain(mrun.blocks(fresh(), 12)))
    assert order == [0, 1] * 3
    order.clear()
    assert_states_equal(mrun(fresh(), 12)[0], got)
    assert order[:6] == [0, 1] * 3
    run, _ = t_st.make_sharded_table_run_batched(tp, LocalRing(2, "cpu"), with_stats=True)
    group_stats = []
    for g in range(2):
        whole = fresh()
        lo, hi = 2 * g, 2 * g + 2
        group = whole.replace(generator=SceneDraws(whole.generator.sources[lo:hi]),
                              **{k: getattr(whole, k)[lo:hi] for k in ARRAY_FIELDS})
        want, s = run(group, 12)
        group_stats.append(s)
        for b in range(2):
            assert_states_equal(scene_state(got, 2 * g + b), scene_state(want, b))
    assert group_stats[0]["fallbacks"] == 0 < group_stats[1]["fallbacks"]
    assert stats == {"fallbacks": sum(s["fallbacks"] for s in group_stats),
                     "spill_rows_max": max(s["spill_rows_max"] for s in group_stats)}


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("with_stats", [False, True])
def test_no_host_read_inside_a_chunk(batched, with_stats, monkeypatch):
    """Between a chunk's entry and its exit nothing converts a tensor to a
    Python value: every such conversion raises while the chunk's blocks
    run (dead injection, phase noise, a forced fallback and both gates
    included).  The stats' counters are read after the chunk."""
    _, tp = params_pair(n_shards=2, n_dead=3, time_to_dead=0.03, phase_std=0.5,
                        phase_update_interval=0.05, centroid_int=0.05)
    if batched:
        run, _ = t_st.make_sharded_table_run_batched(tp, LocalRing(2, "cpu"),
                                                     with_stats=with_stats)
        state = make_batch_state(tp, [0, 1], "cpu")
    else:
        run, _ = t_st.make_sharded_table_run(tp, LocalRing(2, "cpu"), with_stats=with_stats)
        state = pt.Simulation(tp, device="cpu").state
    vel = state.vel.clone()
    vel[..., : tp.n_cells, 0] = 55.0
    state = state.replace(vel=vel)
    gen = run.blocks(state, 16)

    def refuse(name):
        def read(self, *args, **kw):
            raise AssertionError(f"a chunk called Tensor.{name}")
        return read

    with monkeypatch.context() as m:
        for name in HOST_READS:
            m.setattr(torch.Tensor, name, refuse(name))
        result = drain(gen)
    out, stats = run.read_stats(result) if with_stats else (result, None)
    assert out.step == 16 and bool(torch.isfinite(out.pos).all())
    if with_stats:
        # every rebuild falls back, for each scene of a batch
        assert stats["fallbacks"] == 4 * (2 if batched else 1)
