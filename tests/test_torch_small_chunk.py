"""PyTorch port, the compiled chunk of the small-scene paths, on the CPU.

The per-bot chunk runner (DENSE, STENCIL, CELLGRID; ``engine.
make_run_chunk`` and ``make_run_chunk_batched``) runs a block from each
gated step, of at most ``engine.BLOCK_STEPS`` steps, its sim times made on
the device from a step tensor (``state.sim_time``); on the card a
block replays a CUDA graph, on the CPU it runs eagerly through the same
code.  The span path (``engine_table.make_run_chunk_table`` on a
mega-eligible table with ``seg_aligned``) decides each segment's
adopt-or-redo with ``ops/cond.branch`` (a conditional node on the card),
and kernel 3 and its twin take the span's first step as a device tensor.

Each is held here bit for bit against what it replaces, kept in this file:
the body with the host-float sim time, a plain loop of ``make_step``, the
span path that reads each segment's flag before the next segment is
enqueued (with equal ``redos``, rebuild counts and launch counts), and the
twin with its host-int step.  The DENSE chunk is held against the JAX
package's ``make_run_chunk`` at the slice tests' tolerances after 16
steps (positions 1e-5, velocities 1e-4, radii and ring 1e-6, phases 1e-4)
and in macrostate after 30 (centroid 1e-4, mean radius and ring 1e-6),
``tests/test_torch_slice.py``'s DENSE test through the chunk runners.
Sizes: at most 300 bots, at most 130 steps.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
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
from particlerobotsimulations_torch.ops import megakernel as t_mk
from particlerobotsimulations_torch.ops.actuation import update_radius
from particlerobotsimulations_torch.ops.forces import (
    friction_velocity_update_xy,
    obstacle_forces_xy,
)
from particlerobotsimulations_torch.ops.integrate import integrate, radius_integrate_planes
from particlerobotsimulations_torch.ops.pallas_stencil import stencil_forces_plain
from particlerobotsimulations_torch.ops.phase import update_phase
from particlerobotsimulations_torch.parallel.sweep import make_batch_state
from particlerobotsimulations_torch.state import (
    ARRAY_FIELDS,
    active_mask,
    payload_mask,
    state_from_arrays,
    state_to_arrays,
)

from test_torch_gated_blocks import eager_counts

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

f32 = np.float32
STATE_KEYS = (
    "pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r",
    "centroid_ring", "step",
)
TOL = {"pos": 1e-5, "vel": 1e-4, "rad": 1e-6, "centroid_ring": 1e-6, "phase": 1e-4}
PER_BOT = ("DENSE", "STENCIL", "CELLGRID")


def assert_states_equal(a, b):
    for k in ARRAY_FIELDS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert a.step == b.step


# --------------------------------------------- the body's device sim time

def old_body(params, backend):
    """``engine._make_body`` with the sim time a host float
    (``float(f32(step) * f32(dt))``), as it was before the time became a
    device scalar."""
    collide = t_engine._COLLIDES[backend]
    dt = params.timestep
    cog_steps = params.centroid_steps_interval

    def body(arrays, draws, step, gates):
        pos, vel, rad, phase, dead, ring = (
            arrays[k] for k in ("pos", "vel", "rad", "phase", "dead", "centroid_ring")
        )
        dev = pos.device
        n_pad = pos.shape[-2]
        mask = active_mask(params, n_pad, dev)
        payload = payload_mask(params, n_pad, dev)
        time = float(f32(step) * f32(dt))
        dead_gate, cog_gate, phase_gate = gates
        if dead_gate:
            dead = t_engine._inject_dead(params, dead, mask, draws["scores"])
        if cog_gate:
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            centroid = torch.sum(torch.where(mask[:, None], pos, zero), dim=0) / f32(
                params.n_cells)
            row = torch.arange(ring.shape[-2], device=dev)[:, None]
            idx = (step // cog_steps) % params.centroid_steps
            ring = torch.where(row == idx, centroid[None, :], ring)
        if phase_gate:
            phase = update_phase(params, pos, phase, mask, rng.Drawn(normal=draws.get("noise")),
                                 step=step)
        rad = update_radius(params, rad, phase, arrays["abs_force_a"], arrays["abs_force_r"],
                            dead, mask, time, dt)
        pos, vel = integrate(params, pos, vel, rad, dt)
        new_vel, abs_a, abs_r = collide(params, pos, vel, rad, mask, payload, dt)
        return {"pos": pos, "vel": new_vel, "rad": rad, "phase": phase, "dead": dead,
                "abs_force_a": abs_a, "abs_force_r": abs_r, "centroid_ring": ring}

    return body


def old_step(params, batched):
    """``make_step`` / ``make_step_batched`` on :func:`old_body`."""
    backend = params.resolved_backend("cpu")
    body = old_body(params, backend)

    def step(state):
        gates = t_chunk.step_gates(params, state.step)
        shape = (state.pos.shape[0], state.n_pad) if batched else (state.n_pad,)
        draws = t_chunk.draws(params, state.generator, state.step, gates, shape, state.device)
        arrays = {k: getattr(state, k) for k in ARRAY_FIELDS}
        if batched:
            out = torch.func.vmap(functools.partial(body, step=state.step, gates=gates))(
                arrays, draws)
        else:
            out = body(arrays, draws, state.step, gates)
        return state.replace(step=state.step + 1, **out)

    return step


def gated_params(backend, **kw):
    """40 bots with every gate firing within 12 steps: the centroid every
    2 steps, the noisy phase law every 4, three bots killed at step 3."""
    base = dict(n_cells=40, n_dead=3, time_to_dead=0.03, seed=4, phase_std=0.5,
                centroid_int=0.02, phase_update_interval=0.04, light_x=-3.0, light_y=1.0,
                force_backend=pt.ForceBackend[backend])
    base.update(kw)
    return pt.SimParams(**base).validate()


def fresh(p, batched, seeds=(0, 1)):
    if batched:
        return make_batch_state(p, list(seeds), "cpu")
    return pt.Simulation(p, device="cpu").state


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("backend", PER_BOT)
def test_device_time_body_equals_host_float_body(backend, batched):
    """12 steps of ``make_step`` (``make_step_batched``: two scenes) with
    the device sim time against the host-float body, bit for bit after
    every step, the draws and every gate included."""
    p = gated_params(backend)
    new = (t_engine.make_step_batched if batched else t_engine.make_step)(p, "cpu")
    old = old_step(p, batched)
    a, b = fresh(p, batched), fresh(p, batched)
    fired = set()
    for _ in range(12):
        fired.update(i for i, g in enumerate(t_chunk.step_gates(p, a.step)) if g)
        a, b = new(a), old(b)
        assert_states_equal(a, b)
    assert fired == {0, 1, 2}
    assert int(a.dead[..., : p.n_cells].sum()) == 3 * (2 if batched else 1)


# ------------------------------------------------ the per-bot block runner

def schedule(p, start, n, block):
    """The runner's pieces: from each gated step (the dead step's too) to
    the next, at most ``block`` steps at a time."""
    out, j = [], 0
    while j < n:
        s = start + j
        length = 1
        while length < block and j + length < n and not any(
                t_chunk.step_gates(p, s + length)):
            length += 1
        out.append(length)
        j += length
    return out


# (block size, params, start step, chunk): a chunk that starts off the gate
# lattice and ends ragged, with gated steps between blocks
RUNNER_CASES = {
    "4": (4, dict(centroid_int=0.16, phase_update_interval=0.24, time_to_dead=0.3), 5, 37),
    "module": (t_engine.BLOCK_STEPS, dict(centroid_int=1.0, phase_update_interval=1.2,
                                          time_to_dead=0.5), 5, 130),
}


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("case", sorted(RUNNER_CASES))
def test_block_runner_equals_make_step_loop(case, batched, monkeypatch):
    """The runner's ``blocks`` over a chunk from step 5 that ends ragged
    equals a plain loop of ``make_step`` (``make_step_batched``), bit for
    bit, yielding once per piece (whole blocks, the short blocks before a
    gate, the block the dead step starts, the ragged tail's short block),
    every step through ``chunk.graphed``; at ``BLOCK_STEPS`` 4 and at the
    module's own."""
    block, kw, start, n = RUNNER_CASES[case]
    monkeypatch.setattr(t_engine, "BLOCK_STEPS", block)
    p = gated_params("DENSE", **kw)
    want_blocks = schedule(p, start, n, block)
    assert want_blocks.count(block) >= 2 and want_blocks[-1] < block
    assert any(1 < b < block for b in want_blocks[:-1])
    run = (t_engine.make_run_chunk_batched if batched else t_engine.make_run_chunk)(p, "cpu")
    state = fresh(p, batched).replace(step=start)

    def drained():
        gen, yields = run.blocks(state, n), 0
        while True:
            try:
                next(gen)
                yields += 1
            except StopIteration as stop:
                return stop.value, yields

    (got, yields), eager = eager_counts(drained)
    assert yields == len(want_blocks)
    assert start <= p.dead_step < start + n and eager == {"card": 0, "off_card": n}
    step = (t_engine.make_step_batched if batched else t_engine.make_step)(p, "cpu")
    want = fresh(p, batched).replace(step=start)
    for _ in range(n):
        want = step(want)
    assert_states_equal(got, want)
    assert int(got.dead[..., : p.n_cells].sum()) == 3 * (2 if batched else 1)


def test_block_runner_refuses_a_second_chunk_at_once():
    p = gated_params("DENSE")
    run = t_engine.make_run_chunk(p, "cpu")
    st = pt.Simulation(p, device="cpu").state
    first = run.blocks(st, 8)
    next(first)
    with pytest.raises(RuntimeError, match="one chunk at a time"):
        next(run.blocks(st, 8))
    first.close()
    assert t_chunk.drain(run.blocks(st, 8)).step == 8


def params_pair(**kw):
    base = dict(n_cells=300, n_dead=0, seed=3, config=pj.Config.HEX,
                force_backend=pj.ForceBackend.DENSE, phase_std=0.0,
                light_x=-5.0, light_y=0.0, centroid_int=0.08)
    base.update(kw)
    jp = pj.SimParams(**base).validate()
    tp = pt.SimParams(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})
    return jp, tp.validate()


def test_dense_chunk_matches_jax_run_chunk(monkeypatch):
    """300 jittered HEX bots on DENSE, the centroid every 8 steps: two
    chunks (16 + 14) of the block runner at 4-step blocks against the JAX
    package's ``make_run_chunk``: per bot after 16 steps, in macrostate
    after 30 (past ~20 steps a contact or magnet branch flips)."""
    monkeypatch.setattr(t_engine, "BLOCK_STEPS", 4)
    jp, tp = params_pair()
    st = pj.Simulation(jp).state
    pos = np.asarray(st.pos).copy()
    noise = 1e-4 * np.random.default_rng(99).standard_normal((jp.n_cells, 2))
    pos[: jp.n_cells] += noise.astype(f32)
    st = st._replace(pos=jnp.asarray(pos))
    start = {k: np.asarray(jax.device_get(getattr(st, k))) for k in STATE_KEYS}
    run_j = pj.engine.make_run_chunk(jp)
    run_t = t_engine.make_run_chunk(tp, "cpu")
    ts = state_from_arrays(tp, start, "cpu")
    for n, per_bot in ((16, True), (14, False)):
        st, ts = run_j(st, n), run_t(ts, n)
        got = state_to_arrays(ts)
        want = {k: np.asarray(jax.device_get(getattr(st, k))) for k in STATE_KEYS}
        if per_bot:
            for k, tol in TOL.items():
                np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0, err_msg=k)
    n = jp.n_cells
    np.testing.assert_allclose(got["pos"][:n].mean(0), want["pos"][:n].mean(0), atol=1e-4)
    np.testing.assert_allclose(got["rad"][:n].mean(), want["rad"][:n].mean(), atol=1e-6)
    np.testing.assert_allclose(got["centroid_ring"], want["centroid_ring"], atol=1e-6)
    assert int(got["step"]) == int(want["step"]) == 30


# ---------------------------------------- the span path's lagged decision

def span_params(**kw):
    """128 HEX bots, the centroid every 12 steps and the noisy phase law
    every 24: gate segments of 12 steps, K=4, two spans per segment."""
    base = dict(n_cells=128, n_dead=0, seed=3, config=pt.Config.HEX,
                force_backend=pt.ForceBackend.PALLAS, light_x=-5.0, phase_std=0.5,
                centroid_int=0.12, phase_update_interval=0.24, slot_rebuild_steps=4)
    base.update(kw)
    return pt.SimParams(**base).validate()


def reference_span_chunk(p, state, n_steps, counts):
    """The span path as it was: each segment's flag read (``bool(ok_all.
    item())``) before the next segment is enqueued, a failed segment redone
    on the regular path from its entry.  Returns the final state and adds
    its redos to ``counts``."""
    step = t_et.make_table_step(p)
    step_pre, step_post = t_et.make_table_step_parts(p)
    k = max(1, p.resolved_slot_rebuild_steps())
    seg = t_et.gate_seg(p)
    bps = seg // k
    mega = t_mk.make_mega_span(p, t_state.table_geometry(p)[2])
    mega_pack, mega_unpack, incremental_packed = t_et._make_mega_glue(p)

    def regular(ts, n):
        for j in range(n):
            ts = step(ts, *t_chunk.gates(p, ts.step), j % k == k - 1)
        return ts

    def mega_seg(ts):
        entry = (dict(ts.fields), ts.origin, ts.step, ts.centroid_ring,
                 rng.snapshot(ts.generator))
        for _ in range(k - 1):
            ts = step(ts, *t_chunk.gates(p, ts.step), False)
        ts = t_et._smart_rebuild(p, step_pre(ts, *t_chunk.gates(p, ts.step)))
        tbl, strip = mega_pack(ts.fields)
        ok_all = torch.ones((), dtype=torch.bool, device=tbl.device)
        first = ts.step + 1
        for b in range(bps - 1):
            tbl, strip = mega(tbl, strip, first + b * k)
            tbl, ok = incremental_packed(tbl, ts.origin)
            ok_all = ok_all & ok.all()
        if bool(ok_all.item()):
            mid = ts.replace(fields=mega_unpack(tbl, strip), step=first + (bps - 1) * k - 1)
            return step_post(mid)
        counts["redos"] += 1
        fields, origin, step0, ring, snap = entry
        rng.restore(ts.generator, snap)
        ts = ts.replace(fields=fields, origin=origin, step=step0, centroid_ring=ring)
        return regular(ts, seg)

    ts = t_et.enter_table(p, state)
    n_segs = n_steps // seg
    for _ in range(n_segs):
        ts = mega_seg(ts)
    return t_et.exit_table(p, regular(ts, n_steps - n_segs * seg))


@pytest.fixture
def forced_spans(monkeypatch):
    """Spans that count a kernel-3 launch and remember their step, kernel-1
    calls that count a launch, and span rebuilds that fail (for the last
    scene of a batch) in the gate segments listed in ``fail``: the same
    decisions for every runner, on the CPU."""
    ctl = {"fail": set(), "seg": 12, "last": None}
    real_span, real_glue = t_mk.make_mega_span, t_et._make_mega_glue
    real_forces = t_et.stencil_forces

    def make_mega_span(params, n_pad):
        span = real_span(params, n_pad)

        def counted(tbl, strip, step):
            ctl["last"] = int(step)
            kernels.LAUNCHES["mega_span"] += 1
            return span(tbl, strip, step)

        return counted

    def make_glue(params):
        pack, unpack, inc = real_glue(params)

        def failing(tbl, origin):
            new, ok = inc(tbl, origin)
            if ctl["last"] // ctl["seg"] in ctl["fail"]:
                flat = ok.reshape(-1).clone()
                flat[-1] = False
                ok = flat.reshape(ok.shape)
            return new, ok

        return pack, unpack, failing

    def forces(params, tables):
        kernels.LAUNCHES["stencil_forces"] += 1
        return real_forces(params, tables)

    monkeypatch.setattr(t_mk, "make_mega_span", make_mega_span)
    monkeypatch.setattr(t_et, "_make_mega_glue", make_glue)
    monkeypatch.setattr(t_et, "stencil_forces", forces)
    return ctl


def counted_run(fn):
    """``fn()``'s result, launches and rebuild counts, the counters zeroed
    just before."""
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    for k in t_et.REBUILDS:
        t_et.REBUILDS[k] = 0
    out = fn()
    return out, {k: v for k, v in kernels.LAUNCHES.items() if v}, dict(t_et.REBUILDS)


@pytest.mark.parametrize("fail", [(0,), (1,), (3,), (1, 2), (0, 1, 2, 3)],
                         ids=["first", "middle", "last", "two-in-a-row", "all"])
@pytest.mark.parametrize("batched", [False, True])
def test_lagged_span_decision_equals_one_read_per_segment(batched, fail, forced_spans):
    """Four 12-step segments of the span path with the spans' rebuilds made
    to fail in the segments ``fail``: the runner, whose segment decides
    its adopt-or-redo with ``ops/cond.branch`` (on the CPU its eager form,
    through the code a captured segment runs), equals the one that reads
    each flag before the next segment, bit for bit (every generator's
    state included: a redo takes the segment's draws again), with equal
    redos, rebuild counts and launch counts."""
    p = span_params()
    seg, k = t_et.gate_seg(p), p.resolved_slot_rebuild_steps()
    assert seg == forced_spans["seg"] == 12 and k == 4
    forced_spans["fail"] = set(fail)
    n_steps = 4 * seg + 5  # four segments and a ragged regular tail
    run = (t_et.make_run_chunk_table_batched if batched else t_et.make_run_chunk_table)(p)
    assert run.path_info["use_mega"]
    a_in, b_in = fresh(p, batched, (2, 3)), fresh(p, batched, (2, 3))
    (got, launches, rebuilds), eager = eager_counts(
        lambda: counted_run(lambda: run(a_in, n_steps, True)))
    counts = {"redos": 0}
    want, w_launches, w_rebuilds = counted_run(
        lambda: reference_span_chunk(p, b_in, n_steps, counts))
    assert_states_equal(got, want)
    sources = (lambda g: g.sources) if batched else (lambda g: [g])
    for ga, gb in zip(sources(got.generator), sources(want.generator)):
        assert torch.equal(ga.get_state(), gb.get_state())
    assert run.redos == counts["redos"] == len(fail)
    assert (launches, rebuilds) == (w_launches, w_rebuilds)
    assert eager == {"card": 0, "off_card": n_steps}
    assert not np.array_equal(got.phase.numpy(), a_in.phase.numpy())


def test_lagged_span_decision_on_a_real_failure():
    """A 60 u/s kick (one bot crosses several cells per rebuild window):
    the span rebuilds refuse for real, and the runner's segment decision
    equals the one-read-per-segment runner bit for bit, redos and rebuild
    counts equal, over 36 seg-aligned steps in one chunk."""
    p = span_params()
    arrays = state_to_arrays(pt.Simulation(p, device="cpu").state)
    arrays["vel"][7, 0] += 60.0
    run = t_et.make_run_chunk_table(p)
    got, _, rebuilds = counted_run(lambda: run(state_from_arrays(p, arrays, "cpu"), 36, True))
    counts = {"redos": 0}
    want, _, w_rebuilds = counted_run(
        lambda: reference_span_chunk(p, state_from_arrays(p, arrays, "cpu"), 36, counts))
    assert_states_equal(got, want)
    assert run.redos == counts["redos"] >= 1 and rebuilds == w_rebuilds


# ------------------------------------------------- kernel 3's device step

def old_mega_span_plain(params, tbl, strip, step: int):
    """``ops.megakernel.mega_span_plain`` with its host-int step, as it
    was."""
    p = params
    k = max(1, p.resolved_slot_rebuild_steps())
    dt = p.timestep
    has_obstacles = bool(p.circle_obstacles or p.rect_obstacles)
    names = ("px", "py", "vx", "vy", "rad") + (("afac",) if p.has_payload else ())
    d = {kf: tbl[j] for j, kf in enumerate(t_state.TABLE_FIELDS)}
    s = {kf: strip[j] for j, kf in enumerate(t_state.TABLE_FIELDS)}
    zero = torch.zeros((), dtype=torch.float32, device=tbl.device)
    for j in range(k):
        fx, fy, d["aa"], d["ar"] = stencil_forces_plain(p, {n: d[n] for n in names})
        s["aa"] = torch.zeros_like(s["aa"])
        s["ar"] = torch.zeros_like(s["ar"])
        sfx = sfy = torch.zeros_like(s["px"])
        if has_obstacles:
            for e in (d, s):
                ofx, ofy, om = obstacle_forces_xy(p, e["px"], e["py"], e["vx"], e["vy"],
                                                  e["rad"])
                e["ar"] = e["ar"] + om
                if e is d:
                    fx, fy = fx + ofx, fy + ofy
                else:
                    sfx, sfy = ofx, ofy
        for e, ex, ey in ((d, fx, fy), (s, sfx, sfy)):
            nvx, nvy = friction_velocity_update_xy(p, e["vx"], e["vy"], ex, ey,
                                                   e["pay"] > 0.5, dt)
            val = e["val"] > 0.5
            e["vx"] = torch.where(val, nvx, zero)
            e["vy"] = torch.where(val, nvy, zero)
        time = float(f32(step + j) * f32(dt))
        d = radius_integrate_planes(p, d, time)
        s = radius_integrate_planes(p, s, time)
    return (torch.stack([d[kf] for kf in t_state.TABLE_FIELDS]),
            torch.stack([s[kf] for kf in t_state.TABLE_FIELDS]))


@pytest.mark.parametrize("obstacles", [False, True])
def test_twin_with_device_step_equals_host_int_twin(obstacles):
    """Kernel 3's twin with its step as a 0-dim int64 tensor equals the
    host-int twin bit for bit, single and batched, at small steps and past
    2**24 (where float32 rounds the step); ``make_mega_span`` takes either
    form."""
    kw = dict(circle_obstacles=((0.5, 0.0, 0.3),)) if obstacles else {}
    p = span_params(**kw)
    sim = pt.Simulation(p, device="cpu")
    ts = t_et.enter_table(p, sim.state)
    ts = t_et.make_table_step_parts(p)[0](ts, *t_chunk.gates(p, ts.step))
    tbl, strip = t_et._make_mega_glue(p)[0](ts.fields)
    span = t_mk.make_mega_span(p, t_state.table_geometry(p)[2])
    for first in (1, 12_345, 2**24 + 3):
        step = t_state.step_tensor(first, "cpu")
        want = old_mega_span_plain(p, tbl, strip, first)
        for got in (t_mk.mega_span_plain(p, tbl, strip, step), span(tbl, strip, first),
                    span(tbl, strip, step)):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        got_b = t_mk.mega_span_batched_plain(p, torch.stack([tbl, tbl]),
                                             torch.stack([strip, strip]), step)
        for b in range(2):
            assert torch.equal(got_b[0][b], want[0]) and torch.equal(got_b[1][b], want[1])
    assert not torch.equal(want[0], tbl)
