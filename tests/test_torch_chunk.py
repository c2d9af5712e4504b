"""PyTorch port, the chunk that reads nothing from the device, on the CPU.

The table loop's chunk runs without a host read between entry and exit:
``ops.forces._where`` hands its Python scalar to ``torch.where``, the
rebuild's incremental-or-exact choice is a select on the device
(``engine_table._smart_rebuild``), the rebuild counts are device counters
(``engine_table.REBUILDS``), and the sim time is a 0-dim float32 device
scalar (``state.sim_time``).  Each is held here bit for bit against
what it replaces.  The ungated K-step blocks (the blocks a CUDA graph
replays on the card) run eagerly on the CPU through the same step; the
place loops advance every place's chunk block by block
(``chunk.interleave``), each scene bit for bit its solo run; and
the table loop over 40 steps, gated and ungated blocks both, is held
against the JAX package's ``make_run_chunk_table`` at the slice tests'
tolerances (``tests/test_torch_slice.py``: positions 1e-5, velocities
1e-4, radii and ring 1e-6, phases 1e-4, no phase noise).  Sizes: at most
300 bots, at most 40 steps.
"""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particlerobotsimulations_torch as pt
import particlerobotsimulations_tpu as pj
from particlerobotsimulations_torch import bench as t_bench
from particlerobotsimulations_torch import chunk as t_chunk
from particlerobotsimulations_torch import engine_table as t_et
from particlerobotsimulations_torch import state as t_state
from particlerobotsimulations_torch.engine import make_run_chunk_batched
from particlerobotsimulations_torch.ops import forces as t_forces
from particlerobotsimulations_torch.ops.actuation import update_radius
from particlerobotsimulations_torch.ops.integrate import radius_integrate_planes
from particlerobotsimulations_torch.ops.table_rebuild import (
    incremental_rebuild,
    rebuild_move_planes,
)
from particlerobotsimulations_torch.parallel import sweep as t_sw
from particlerobotsimulations_torch.parallel.mesh import Mesh
from particlerobotsimulations_torch.state import (
    scene_state,
    state_from_arrays,
    state_to_arrays,
)
from particlerobotsimulations_torch.utils import trace
from particlerobotsimulations_tpu import engine_table as j_et

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
# JAX runs from one-ulp moves of the initial positions that measure the JAX
# package's own spread over the 40-step comparison
JAX_ULP_RUNS = 3


def old_where(cond, a, b):
    """``ops.forces._where`` as it was: each Python scalar made a float32
    tensor on the other branch's device (a host copy on a card)."""
    like = a if torch.is_tensor(a) else b
    if not torch.is_tensor(a):
        a = torch.tensor(a, dtype=like.dtype, device=like.device)
    if not torch.is_tensor(b):
        b = torch.tensor(b, dtype=like.dtype, device=like.device)
    return torch.where(cond, a, b)


def params(**kw):
    base = dict(n_cells=300, n_dead=0, seed=3, config=pt.Config.HEX,
                force_backend=pt.ForceBackend.PALLAS, phase_std=0.0,
                light_x=-5.0, light_y=0.0)
    base.update(kw)
    return pt.SimParams(**base).validate()


def where_case(name: str, rng: np.random.Generator):
    """One call through a ``_where`` call site on seeded inputs that take
    every branch (overlaps, the magnet ramp and tail, static holds, stops,
    circle and rectangle hits)."""
    p = params(circle_obstacles=((0.0, 0.0, 0.4),),
               rect_obstacles=((0.5, 1.5, -0.5, 0.5),))
    n = 64
    pos = rng.uniform(-1.2, 1.8, (n, 2)).astype(f32)
    vel = rng.normal(0.0, 0.02, (n, 2)).astype(f32)
    vel[::5] = 0.0
    rad = rng.uniform(p.min_radius, p.max_radius, n).astype(f32)
    pos_t, vel_t, rad_t = (torch.from_numpy(a) for a in (pos, vel, rad))
    mask = torch.from_numpy(rng.uniform(size=n) < 0.9)
    payload = torch.zeros(n, dtype=torch.bool)
    payload[-1] = True
    if name == "pair_forces":
        # pairs at gaps across the contact, ramp and inverse-square ranges
        d = rng.uniform(0.0, 4.0 * p.max_radius, (n, n, 1)).astype(f32)
        ang = rng.uniform(0, 2 * np.pi, (n, n, 1)).astype(f32)
        diff = torch.from_numpy(np.concatenate([d * np.cos(ang), d * np.sin(ang)], -1))
        rel = torch.from_numpy(rng.normal(0.0, 0.01, (n, n, 2)).astype(f32))
        attr = torch.full((n, n), f32(p.attraction))
        valid = torch.from_numpy(rng.uniform(size=(n, n)) < 0.8)
        return lambda: t_forces.pair_forces(
            p, diff, rel, rad_t[:, None], rad_t[None, :], attr, valid)
    if name == "friction_velocity_update_xy":
        fx = torch.from_numpy(rng.normal(0.0, 0.05, n).astype(f32))
        fy = torch.from_numpy(rng.normal(0.0, 0.05, n).astype(f32))
        fx[::7] = 0.0
        return lambda: t_forces.friction_velocity_update_xy(
            p, vel_t[:, 0], vel_t[:, 1], fx, fy, payload, p.timestep)
    if name == "obstacle_forces_xy":
        return lambda: t_forces.obstacle_forces_xy(
            p, pos_t[:, 0], pos_t[:, 1], vel_t[:, 0], vel_t[:, 1], rad_t)
    assert name == "dense_collide"
    return lambda: t_forces.dense_collide(p, pos_t * 0.2, vel_t, rad_t, mask, payload,
                                          p.timestep)


@pytest.mark.parametrize("site", ["pair_forces", "friction_velocity_update_xy",
                                  "obstacle_forces_xy", "dense_collide"])
def test_where_equals_old_where_at_every_call_site(site, monkeypatch):
    call = where_case(site, np.random.default_rng(11))
    got = call()
    monkeypatch.setattr(t_forces, "_where", old_where)
    want = call()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32
        assert torch.equal(g, w)


@pytest.mark.parametrize("dt", [0.01, 0.0125, 1.0 / 3.0])
def test_sim_time_scalar_equals_host_float(dt):
    """The device sim time is ``float(f32(step) * f32(dt))``, bit for bit,
    at sampled steps up to 2**24 (and just past, where float32 rounds the
    step)."""
    steps = [0, 1, 2, 3, 7, 199, 200, 12_345, 600_000, 2**20 + 7, 2**24 - 1, 2**24,
             2**24 + 1, 2**24 + 3]
    steps += np.random.default_rng(5).integers(0, 2**24, 64).tolist()
    for s in steps:
        t = t_state.sim_time(t_state.step_tensor(s, "cpu"), dt)
        assert t.dtype == torch.float32 and t.dim() == 0
        assert t.item() == float(f32(s) * f32(dt)), s
    # a block's times are made from its first step plus the step's index
    s0 = t_state.step_tensor(2**23 + 5, "cpu")
    for j in range(8):
        assert t_state.sim_time(s0 + j, dt).item() == float(f32(2**23 + 5 + j) * f32(dt))


def test_radius_and_integrate_take_the_time_tensor():
    """``update_radius`` and ``radius_integrate_planes`` give the same bits
    with the sim time as a 0-dim tensor as with the host float."""
    p = params()
    rng = np.random.default_rng(3)
    n = 256
    f = {k: torch.from_numpy(rng.normal(0.0, 0.3, n).astype(f32))
         for k in ("px", "py", "vx", "vy", "aa", "ar")}
    f["rad"] = torch.from_numpy(rng.uniform(p.min_radius, p.max_radius, n).astype(f32))
    f["phase"] = torch.from_numpy(rng.uniform(-2.0, 2.0, n).astype(f32))
    f["dead"] = torch.from_numpy((rng.uniform(size=n) < 0.1).astype(f32))
    f["val"] = torch.from_numpy((rng.uniform(size=n) < 0.9).astype(f32))
    for step in (0, 37, 1_234, 99_999):
        host = float(f32(step) * f32(p.timestep))
        dev = t_state.sim_time(t_state.step_tensor(step, "cpu"), p.timestep)
        args = (f["rad"], f["phase"], f["aa"], f["ar"], f["dead"] > 0.5, f["val"] > 0.5)
        assert torch.equal(update_radius(p, *args, dev, p.timestep),
                           update_radius(p, *args, host, p.timestep))
        a = radius_integrate_planes(p, dict(f), dev)
        b = radius_integrate_planes(p, dict(f), host)
        for k in a:
            assert torch.equal(a[k], b[k]), k


def entered(p, seed=0, steps=2):
    """A table carry of a fresh scene after ``steps`` steps without a
    rebuild, the step's integrate done (where a rebuild runs)."""
    sim = pt.Simulation(p.replace(seed=seed), device="cpu")
    ts = t_et.enter_table(sim.params, sim.state)
    step = t_et.make_table_step(sim.params)
    for _ in range(steps):
        ts = step(ts, False, False, False, False)
    pre, _ = t_et.make_table_step_parts(sim.params)
    return sim.params, pre(ts, False, False, False)


def force_fallback(p, ts, how: str):
    """The carry with one precondition of the incremental rebuild broken:
    ``far`` moves one bot two cells; ``overflow`` moves every bot of a
    cell's 8 neighbours into it (each by one cell) past the capacity."""
    f = dict(ts.fields)
    g, h, cs = p.resolved_grid_dim(), f32(p.cutoff()), p.storage_capacity()
    total = g * g * cs
    val = f["val"][:total] > 0.5
    rows = torch.nonzero(val).flatten()
    if how == "far":
        r = int(rows[len(rows) // 2])
        px = f["px"].clone()
        px[r] += f32(2.0) * h
        f["px"] = px
        return ts.replace(fields=f)
    lane = rows % (g * g)
    counts = torch.bincount(lane, minlength=g * g).reshape(g, g)
    # the fullest cell away from the wrapped edges
    inner = counts.clone()
    inner[:3], inner[-3:], inner[:, :3], inner[:, -3:] = 0, 0, 0, 0
    cy, cx = divmod(int(torch.argmax(inner)), g)
    ox, oy = ts.origin[0], ts.origin[1]
    px, py = f["px"].clone(), f["py"].clone()
    for r in rows.tolist():
        ly, lx = divmod(r % (g * g), g)
        if abs(lx - cx) <= 1 and abs(ly - cy) <= 1 and (lx, ly) != (cx, cy):
            px[r] = ox + (f32(cx) + f32(0.5)) * h
            py[r] = oy + (f32(cy) + f32(0.5)) * h
    f["px"], f["py"] = px, py
    return ts.replace(fields=f)


def why(p, ts):
    """(moved far, cell over capacity, edge) of the carry's rebuild."""
    g, cs = p.resolved_grid_dim(), p.storage_capacity()
    total = g * g * cs
    planes = torch.stack([ts.fields[k][:total] for k in t_state.MOVE_FIELDS]).reshape(
        len(t_state.MOVE_FIELDS), cs, g * g)
    _, _, far, edge = rebuild_move_planes(p, planes, t_state.MOVE_FIELDS, ts.origin)
    moved, ok = incremental_rebuild(p, ts.fields, t_state.MOVE_FIELDS, ts.origin)
    return bool(far), bool(~ok & ~far & ~edge), bool(edge)


def batched(tss):
    return t_state.TableState(
        {k: torch.stack([ts.fields[k] for ts in tss]) for k in t_state.TABLE_FIELDS},
        torch.stack([ts.origin for ts in tss]), tss[0].step, None,
        torch.stack([ts.centroid_ring for ts in tss]),
    )


def assert_carry_equal(got_fields, got_origin, want_fields, want_origin):
    for k in t_state.TABLE_FIELDS:
        assert torch.equal(got_fields[k], want_fields[k]), k
    assert torch.equal(got_origin, want_origin)


@pytest.mark.parametrize("carry", ["single", "batched"])
@pytest.mark.parametrize("case", ["clean", "far", "overflow"])
def test_rebuild_choice_on_device(case, carry):
    """A clean rebuild takes the incremental result, a forced fallback (one
    bot two cells away, or one cell over capacity) the exact rebuild, bit
    for bit, with one count each; a batch whose scene 1 fails takes the
    exact rebuild for both scenes."""
    p, ts0 = entered(params(n_cells=200), seed=0)
    ts = ts0 if case == "clean" else force_fallback(p, ts0, case)
    far, over, edge = why(p, ts)
    assert (far, over, edge) == (case == "far", case == "overflow", False)
    if carry == "batched":
        _, other = entered(p, seed=1)
        ts = batched([other, ts])
    for k in t_et.REBUILDS:
        t_et.REBUILDS[k] = 0
    got = t_et._smart_rebuild(p, ts)
    if case == "clean":
        moved, ok = incremental_rebuild(p, ts.fields, t_state.MOVE_FIELDS, ts.origin)
        assert bool(ok.all())
        want = t_et._derived_rows(p, {**ts.fields, **moved})
        assert_carry_equal(got.fields, got.origin, want, ts.origin)
    else:
        want, origin = t_et._exact_rebuild(p, ts.fields)
        assert_carry_equal(got.fields, got.origin, want, origin)
    assert dict(t_et.REBUILDS) == {"incremental": int(case == "clean"),
                                   "exact": int(case != "clean")}


def test_rebuild_counts_read_and_reset():
    """``REBUILDS`` reads its device counters on demand; setting a count
    sets it (the counters are zeroed in place)."""
    p, ts = entered(params(n_cells=128), seed=2)
    for k in t_et.REBUILDS:
        t_et.REBUILDS[k] = 0
    for _ in range(3):
        t_et._smart_rebuild(p, ts)
    t_et._smart_rebuild(p, force_fallback(p, ts, "far"))
    assert dict(t_et.REBUILDS) == {"incremental": 3, "exact": 1}
    assert sorted(t_et.REBUILDS) == ["exact", "incremental"] and len(t_et.REBUILDS) == 2
    t_et.REBUILDS["exact"] = 5
    assert t_et.REBUILDS["exact"] == 5 and t_et.REBUILDS["incremental"] == 3
    with pytest.raises(KeyError):
        t_et.REBUILDS["other"]


def test_blocks_equal_the_step_loop():
    """The runner's blocks (K-step blocks, gated or not, eagerly on the
    CPU, then the ragged tail as one block) equal a loop of
    ``make_table_step`` with the regular schedule's gates and rebuilds,
    bit for bit, with the same rebuild counts."""
    p = params(n_cells=300, phase_std=0.5, phase_update_interval=0.12,
               centroid_int=0.08, slot_rebuild_steps=4)
    sim = pt.Simulation(p, device="cpu")
    start, n = sim.state.replace(step=2), 30
    for k in t_et.REBUILDS:
        t_et.REBUILDS[k] = 0
    run = t_et.make_run_chunk_table(sim.params)
    seen = []

    def drained():
        gen = run.blocks(start, n)
        while True:
            try:
                next(gen)
                seen.append(None)
            except StopIteration as stop:
                return stop.value

    got, eager = eager_counts(drained)
    counts = dict(t_et.REBUILDS)
    # 30 steps: blocks at j = 0, 4, ..., 24 (7 blocks of 4, gated ones
    # among them) and the 2-step ragged tail, a block too: every step
    # through chunk.graphed
    gated = [j for j in range(0, 28, 4)
             if any(s % 8 == 0 or s % 12 == 0 for s in range(2 + j, 6 + j))]
    assert len(gated) >= 4 and len(seen) == 7 + 1 and eager == {"card": 0, "off_card": n}

    for k in t_et.REBUILDS:
        t_et.REBUILDS[k] = 0
    step = t_et.make_table_step(sim.params)
    ref = pt.Simulation(p, device="cpu").state.replace(step=2)
    ts = t_et.enter_table(sim.params, ref)
    for j in range(n):
        ts = step(ts, *t_chunk.gates(sim.params, ts.step), j % 4 == 3)
    want = t_et.exit_table(sim.params, ts)
    assert dict(t_et.REBUILDS) == counts and sum(counts.values()) == 7
    for k in ("pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r",
              "centroid_ring"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert got.step == want.step == 32


def jax_chunks(jp, run, pos, chunks):
    """The JAX table loop ``run`` from a fresh state at ``pos``, run in
    ``chunks``: each chunk's end state as numpy arrays."""
    st = pj.Simulation(jp).state._replace(pos=jnp.asarray(pos))
    out = []
    for n in chunks:
        st = run(st, n)
        out.append({k: np.asarray(jax.device_get(getattr(st, k))) for k in STATE_KEYS})
    return out


def test_table_loop_40_steps_matches_jax():
    """40 steps in two chunks (12 + 28), K=4, centroid every 8 and phase
    every 12 steps (gated and ungated blocks), against the JAX
    ``make_run_chunk_table``: at the slice tests' tolerances after the
    first 12 steps, and after 40 within the JAX package's own spread when
    its initial positions move by one ulp (JAX_ULP_RUNS runs; the golden
    tests' envelope, ``tests/test_torch_rng.py``): from this jittered HEX
    blob that spread reaches 1.8e-3 in position by step 12 and 0.1 by step
    40, the growth of contact-branch chaos, far past the 12-step
    tolerances."""
    base = dict(n_cells=300, n_dead=0, seed=3, config=pj.Config.HEX,
                force_backend=pj.ForceBackend.PALLAS, phase_std=0.0,
                light_x=-5.0, light_y=0.0, slot_rebuild_steps=4,
                centroid_int=0.08, phase_update_interval=0.12)
    jp = pj.SimParams(**base).validate()
    tp = pt.SimParams(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}).validate()
    n = jp.n_cells
    pos = np.asarray(pj.Simulation(jp).state.pos).copy()
    pos[:n] += (1e-4 * np.random.default_rng(99).standard_normal((n, 2))).astype(f32)
    j_run = j_et.make_run_chunk_table(jp)
    want = jax_chunks(jp, j_run, pos, (12, 28))
    run = t_et.make_run_chunk_table(tp)
    fresh = pj.Simulation(jp).state
    start = {k: np.asarray(jax.device_get(getattr(fresh, k))) for k in STATE_KEYS}
    st = state_from_arrays(tp, dict(start, pos=pos), "cpu")
    got = []
    for steps in (12, 28):
        st = run(st, steps)
        got.append(state_to_arrays(st))
    for k, tol in TOL.items():
        np.testing.assert_allclose(got[0][k], want[0][k], atol=tol, rtol=0, err_msg=k)
    spread = dict.fromkeys(TOL, 0.0)
    for seed in range(JAX_ULP_RUNS):
        towards = np.random.default_rng(seed).choice([-np.inf, np.inf], (n, 2)).astype(f32)
        moved = pos.copy()
        moved[:n] = np.nextafter(pos[:n], towards)
        other = jax_chunks(jp, j_run, moved, (12, 28))[1]
        for k in TOL:
            spread[k] = max(spread[k], float(np.abs(other[k] - want[1][k]).max()))
    for k in TOL:
        assert float(np.abs(got[1][k] - want[1][k]).max()) <= spread[k], k
    assert int(got[1]["step"]) == int(want[1]["step"]) == 40


def logged_interleave(log):
    """``chunk.interleave`` that records which place each advance
    went to, and the final states."""
    real = t_chunk.interleave

    def wrap(i, it):
        while True:
            try:
                next(it)
            except StopIteration as stop:
                return stop.value
            log["order"].append(i)
            yield

    def interleave(iterators):
        out = real([wrap(i, it) for i, it in enumerate(iterators)])
        log["states"] = out
        return out

    return interleave


def assert_alternates(order, places):
    """Each place advanced once in turn while all had blocks left."""
    counts = [order.count(i) for i in range(places)]
    head = order[: places * min(counts)]
    assert head == list(range(places)) * min(counts)


def test_bench_places_interleave_bit_for_bit_their_solo_runs(monkeypatch):
    """The bench's multi-place branch on ``Mesh(["cpu"] * 2)`` (PALLAS,
    240 bots): the two places' blocks alternate, and each scene equals its
    seed run alone through the batched loop, bit for bit."""
    log = {"order": []}
    monkeypatch.setattr(t_bench, "interleave", logged_interleave(log))
    real_params = t_bench.bench_params

    def cut(n_bots):
        return real_params(n_bots).replace(force_backend=pt.ForceBackend.PALLAS,
                                           slot_rebuild_steps=4)

    monkeypatch.setattr(t_bench, "bench_params", cut)
    t_bench.run_bench(device="cpu", n_bots=240, steps=20, mesh=Mesh(["cpu"] * 2))
    assert_alternates(log["order"], 2)
    # four chunks (one warm-up, three timed); the last one's states are kept
    params = cut(240)
    for b, got in enumerate(log["states"]):
        solo = t_sw.make_batch_state(params, [b], "cpu")
        run = make_run_chunk_batched(params, "cpu")
        for _ in range(4):
            solo = run(solo, 20)
        for k in ("pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r",
                  "centroid_ring"):
            assert torch.equal(getattr(got, k), getattr(solo, k)), (b, k)
        assert got.step == solo.step == 80


def test_run_sweep_mesh_places_interleave_bit_for_bit_their_solo_runs(monkeypatch):
    """``run_sweep(mesh=Mesh(["cpu"] * 2))`` on the batched table loop (4
    seeds, two per place, 24 steps recorded every 12): the places' blocks
    alternate, and each group equals its seeds run alone, bit for bit."""
    log = {"order": []}
    monkeypatch.setattr(t_chunk, "interleave", logged_interleave(log))
    p = params(n_cells=200, phase_std=0.5, phase_update_interval=0.08,
               slot_rebuild_steps=4)
    fin, cents = t_sw.run_sweep(p, [0, 1, 2, 3], 24, mesh=Mesh(["cpu"] * 2),
                                record_every=12, device="cpu")
    assert_alternates(log["order"], 2)
    assert cents.shape == (3, 4, 2)
    for g, seeds in enumerate(([0, 1], [2, 3])):
        solo, solo_cents = t_sw.run_sweep(p, seeds, 24, record_every=12, device="cpu",
                                          strategy="batched")
        np.testing.assert_array_equal(cents[:, 2 * g: 2 * g + 2], solo_cents)
        for b in range(2):
            got, want = scene_state(fin, 2 * g + b), scene_state(solo, b)
            for k in ("pos", "vel", "rad", "phase", "dead", "centroid_ring"):
                assert torch.equal(getattr(got, k), getattr(want, k)), (g, b, k)


def test_adaptive_runner_reads_its_probe_through_the_host_copy():
    """The adaptive runner keeps the last probe as a host copy made when the
    probe was enqueued, and reads it at the next chunk: the value equals
    the probe's."""
    p = params(n_cells=300, centroid_int=0.08, phase_update_interval=0.08)
    runner = t_et.make_adaptive_run_chunk(p)
    sim = pt.Simulation(p, device="cpu")
    st = runner(sim.state, 16, True)
    pending = runner.pending
    assert pending is not None and isinstance(pending, t_chunk.HostValue)
    value = pending.read()
    runner(st, 16, True)
    assert runner.last_probe == value


def test_blocks_refuse_a_second_chunk_at_once():
    """A runner's graphs hold one chunk's carry: a second chunk on the same
    runner while one is open raises."""
    p = params(n_cells=64)
    run = t_et.make_run_chunk_table(p)
    st = pt.Simulation(p, device="cpu").state
    first = run.blocks(st, 8)
    next(first)
    with pytest.raises(RuntimeError, match="one chunk at a time"):
        next(run.blocks(st, 8))
    first.close()
    assert t_chunk.drain(run.blocks(st, 8)).step == 8


# ------------------------------------------------------ the chunk module

def imported_modules(path, package: str) -> set:
    """Every module that ``path``'s code imports, at its top or inside a
    function, as absolute names (``package`` is the file's own)."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package.split(".")
            if node.level:
                base = base[: len(base) - node.level + 1]
            mod = ".".join(base + ([node.module] if node.module else []))
            if not node.level:
                mod = node.module
            out.add(mod)
            out.update(f"{mod}.{a.name}" for a in node.names)
    return out


def test_kernels_and_ops_import_nothing_above_them():
    """``kernels.py`` and ``ops/*.py`` import nothing of the table loop,
    the engine, the simulation or the parallel loops, function-local
    imports included: the table format and the step clock they read live
    in ``state.py``, below them."""
    root = pathlib.Path(t_chunk.__file__).parent
    files = [(root / "kernels.py", "particlerobotsimulations_torch")] + [
        (f, "particlerobotsimulations_torch.ops") for f in sorted((root / "ops").glob("*.py"))]
    above = [f"particlerobotsimulations_torch.{m}" for m in
             ("engine_table", "engine", "sim", "parallel")]
    assert len(files) > 10
    for path, package in files:
        bad = sorted(m for m in imported_modules(path, package)
                     if any(m == a or m.startswith(a + ".") for a in above))
        assert not bad, (path.name, bad)


def runner_of(shape):
    """(runner, a fresh state, steps, seg_aligned, the path its chunk span
    names) of one runner shape on a small CPU scene."""
    from particlerobotsimulations_torch.engine import make_run_chunk
    from particlerobotsimulations_torch.parallel import spatial_table as t_st
    from particlerobotsimulations_torch.parallel.mesh import Mesh as TorchMesh
    from particlerobotsimulations_torch.parallel.ring import LocalRing
    from particlerobotsimulations_torch.parallel.sweep import make_batch_state

    p = params(n_cells=64, centroid_int=0.08, phase_update_interval=0.08)
    if shape in ("table", "batched"):
        run = (t_et.make_run_chunk_table_batched if shape == "batched"
               else t_et.make_run_chunk_table)(p)
        state = make_batch_state(p, [0, 1], "cpu") if shape == "batched" else pt.Simulation(
            p, device="cpu").state
        return run, state, 8, False, shape
    if shape == "adaptive":
        return t_et.make_adaptive_run_chunk(p), pt.Simulation(p, device="cpu").state, 16, \
            True, "adaptive"
    if shape in ("dense", "dense_batched"):
        q = p.replace(force_backend=pt.ForceBackend.DENSE)
        if shape == "dense":
            return make_run_chunk(q, "cpu"), pt.Simulation(q, device="cpu").state, 16, False, \
                "DENSE"
        return make_run_chunk_batched(q, "cpu"), make_batch_state(q, [0, 1], "cpu"), 16, \
            False, "DENSE"
    q = t_st.resolve_tp_params(p, 2)
    if shape == "sharded":
        run, _ = t_st.make_sharded_table_run(q, LocalRing(2, "cpu"), with_stats=True)
        return run, pt.Simulation(q, device="cpu").state, 8, False, "sharded"
    if shape == "dp_tp":
        run, _ = t_st.make_sharded_table_run_batched(q, LocalRing(2, "cpu"))
    else:
        mesh = TorchMesh(np.array(["cpu"] * 4).reshape(2, 2), ("data", "bots"))
        run, _ = t_st.make_sharded_table_run_batched(q, mesh=mesh, with_stats=True)
    return run, make_batch_state(q, [0, 1], "cpu"), 8, False, "sharded"


RUNNER_SHAPES = ("table", "batched", "adaptive", "dense", "dense_batched", "sharded",
                 "dp_tp", "mesh")
# the attributes a runner shape keeps of its own; no other shape has them
OWN = {"table": ("segments", "redos"), "batched": ("segments", "redos"),
       "adaptive": ("live", "last_probe", "pending")}


@pytest.mark.parametrize("shape", RUNNER_SHAPES)
def test_every_runner_is_one_chunk_runner(shape):
    """Every runner shape on the CPU is a ``chunk.ChunkRunner`` with its
    ``path_info``: a call is one ``chunk`` span (no other opened under
    it), with the steps, the scenes and the path; a second chunk started
    while one is open raises; and each shape keeps its own attributes
    (the table runners' ``segments`` and ``redos``, the adaptive runner's
    ``live``, ``last_probe`` and pending probe) and no other shape's."""
    run, state, n, aligned, path = runner_of(shape)
    assert isinstance(run, t_chunk.ChunkRunner) and isinstance(run.path_info, dict)
    for name in ("segments", "redos", "live", "last_probe", "pending"):
        assert hasattr(run, name) == (name in OWN.get(shape, ())), (shape, name)
    trace.enable()
    try:
        run(state, n, aligned)
    finally:
        trace.disable()
    chunks = [s for s in trace.snapshot()["spans"] if s["name"] == "chunk"]
    assert len(chunks) == 1 and chunks[0]["parent"] is None
    scenes = state.pos.shape[0] if state.pos.dim() == 3 else 1
    assert {k: chunks[0]["attrs"][k] for k in ("steps", "scenes", "path")} == {
        "steps": n, "scenes": scenes, "path": path}
    first = run.blocks(state, n, aligned)
    next(first)
    with pytest.raises(RuntimeError, match="one chunk at a time"):
        next(run.blocks(state, n, aligned))
    first.close()
    t_chunk.drain(run.blocks(state, n, aligned))


@pytest.mark.parametrize("shape", ["table", "dense"])
def test_a_step_outside_graphed_fails_the_eager_count(shape, monkeypatch):
    """The count the runner tests hold (``chunk.EAGER``: every step of a
    CPU chunk through ``chunk.graphed``) can fail: with the runner's first
    block run outside ``graphed`` (planted through its module's
    ``_graphed``), the chunk counts that block's steps short, and the
    check that the unplanted chunk meets fails."""
    from particlerobotsimulations_torch import engine as t_engine

    run, state, n, aligned, _ = runner_of(shape)
    _, eager = eager_counts(lambda: run(state, n, aligned))
    assert eager == {"card": 0, "off_card": n}

    module = t_et if shape == "table" else t_engine
    real = module._graphed
    planted = []

    def outside(graphs, key, block, carry, step):
        if planted:
            return real(graphs, key, block, carry, step)
        planted.append(block.steps)
        return block(carry, t_state.step_tensor(step, "cpu"))

    monkeypatch.setattr(module, "_graphed", outside)
    run, state, n, aligned, _ = runner_of(shape)
    got, eager = eager_counts(lambda: run(state, n, aligned))
    assert planted and 0 < planted[0] < n and got.step == n
    assert eager == {"card": 0, "off_card": n - planted[0]}
    with pytest.raises(AssertionError):
        assert eager == {"card": 0, "off_card": n}
