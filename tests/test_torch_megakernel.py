"""PyTorch port, the megakernel band against the JAX package.

On the CPU the port's span (``ops/megakernel.make_mega_span``) takes its
plain twin and the JAX megakernel runs in interpret mode, as
``tests/test_megakernel.py`` runs it.  Inputs are made with numpy from a
seed and handed to both packages.  ``phase_std=0`` and ``n_dead=0`` wherever
bots are compared one by one (the RNG streams differ), and HEX positions
are jittered by 1e-4 (the lattice's exact tangencies flip magnet branches).

Tolerances: one span, atol = rtol = 1e-4 per field — the JAX kernel sums
Newton reactions over 5 blocks where the twin gathers all 9, and aa/ar
are sums of ~1e3-magnitude terms (JAX's own span tolerance).  Chunks over
24 steps with gates firing: positions and radii 2e-4, phases 1e-4, the
centroid ring 1e-5 (JAX's mega-vs-regular tolerances).  The glue moves
data only: elementwise equal.  The forced redo must reproduce the regular
schedule exactly, generator included: ``torch.equal``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particlerobotsimulations_torch as pt
import particlerobotsimulations_tpu as pj
from particlerobotsimulations_torch import engine_table as t_et
from particlerobotsimulations_torch.ops import megakernel as t_mk
from particlerobotsimulations_torch.state import state_from_arrays, state_to_arrays
from particlerobotsimulations_tpu import engine_table as j_et
from particlerobotsimulations_tpu.ops import megakernel as j_mk

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

STATE_KEYS = (
    "pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r",
    "centroid_ring", "step",
)
CHUNK_TOL = {"pos": 2e-4, "rad": 2e-4, "phase": 1e-4, "centroid_ring": 1e-5}
EXAMPLES = (
    "example.cfg", "example_dead_cells.cfg", "example_gap.cfg",
    "example_object_transport.cfg", "example_obstacle.cfg",
)


def to_torch_params(jp):
    return pt.SimParams(
        **{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    )


def params_pair(**kw):
    base = dict(
        n_cells=300, n_dead=0, seed=3, config=pj.Config.HEX,
        force_backend=pj.ForceBackend.PALLAS, phase_std=0.0,
        light_x=-5.0, light_y=0.0,
    )
    base.update(kw)
    jp = pj.SimParams(**base).validate()
    return jp, to_torch_params(jp).validate()


def jittered(jp, seed=99, scale=1e-4):
    st = pj.Simulation(jp).state
    rng = np.random.default_rng(seed)
    pos = np.asarray(st.pos).copy()
    pos[: jp.n_cells] += (scale * rng.standard_normal((jp.n_cells, 2))).astype(
        np.float32
    )
    return st._replace(pos=jnp.asarray(pos))


def arrays_of(st):
    return {k: np.asarray(jax.device_get(getattr(st, k))) for k in STATE_KEYS}


@pytest.fixture
def span_steps(monkeypatch):
    """The first step of every span the port's runners launch."""
    steps = []
    real = t_mk.make_mega_span

    def counting(params, n_pad):
        span = real(params, n_pad)

        def wrapped(tbl, strip, step):
            steps.append(step)
            return span(tbl, strip, step)
        return wrapped

    monkeypatch.setattr(t_mk, "make_mega_span", counting)
    return steps


@pytest.fixture
def no_mega_switch(monkeypatch):
    """The JAX span path is on unless PBOT_MEGA=0; make sure it is on."""
    monkeypatch.delenv("PBOT_MEGA", raising=False)


def test_eligibility_equals_jax(no_mega_switch):
    cases = [
        {},
        {"n_cells": 2_000},
        {"n_cells": 10_000},
        {"n_cells": 1000, "overflow_slots": 8},
        {"n_cells": 20_000, "grid_dim": 16},
        {"force_backend": pj.ForceBackend.DENSE},
        {"slot_rebuild_steps": 12},
    ]
    seen = []
    for kw in cases:
        jp, tp = params_pair(**kw)
        assert t_mk.mega_eligible(tp) == j_mk.mega_eligible(jp), kw
        seen.append(t_mk.mega_eligible(tp))
    for name in EXAMPLES:
        jp = pj.load_cfg(f"examples/{name}").replace(
            force_backend=pj.ForceBackend.PALLAS
        ).validate()
        tp = pt.load_cfg(f"examples/{name}").replace(
            force_backend=pt.ForceBackend.PALLAS
        ).validate()
        assert to_torch_params(jp) == tp
        assert t_mk.mega_eligible(tp) == j_mk.mega_eligible(jp), name
        seen.append(t_mk.mega_eligible(tp))
    assert True in seen and False in seen
    # AUTO: the card takes PALLAS from 641 bots, and G=16 holds ~1.2k
    tp = pt.load_cfg("examples/example_gap.cfg").validate()
    assert t_mk.mega_eligible(tp)
    assert not t_mk.mega_eligible(tp.replace(n_cells=640))


def test_glue_round_trip_and_incremental_equals_jax():
    jp, tp = params_pair()
    st = jittered(jp)
    ts = t_et.enter_table(tp, state_from_arrays(tp, arrays_of(st), "cpu"))
    # 3 steps of motion with a velocity push, no rebuild, then mid-step
    rng = np.random.default_rng(4)
    f = dict(ts.fields)
    kick = torch.tensor(rng.normal(0, 3.0, (2,) + f["vx"].shape).astype(np.float32))
    f["vx"] = torch.where(f["val"] > 0.5, f["vx"] + kick[0], f["vx"])
    f["vy"] = torch.where(f["val"] > 0.5, f["vy"] + kick[1], f["vy"])
    ts = ts.replace(fields=f)
    step_pre, step_post = t_et.make_table_step_parts(tp)
    for _ in range(3):
        ts = step_post(step_pre(ts, False, False, False))
    ts = step_pre(ts, False, False, False)

    pack, unpack, inc = t_et._make_mega_glue(tp)
    tbl, strip = pack(ts.fields)
    back = unpack(tbl, strip)
    for kf in t_et.TABLE_FIELDS:
        assert torch.equal(back[kf], ts.fields[kf]), kf

    got, ok_t = inc(tbl, ts.origin)
    want, ok_j = j_et._make_mega_glue(jp)[2](
        jnp.asarray(tbl.numpy()), jnp.asarray(ts.origin.numpy())
    )
    assert bool(ok_t) == bool(ok_j)
    assert bool(ok_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the push moved rows across cells: the rebuild did move data
    assert not torch.equal(got[0], tbl[0])


def span_inputs(jp):
    """(tbl, strip, first step) of a JAX mid-step state: entry, then the
    pre of step 0 with its phase gate, as a run's first step fires it.  The
    light law staggers the phases; with every phase at 0 all bots grow in
    step and sweep tangent HEX pairs through the contact threshold, where
    an ulp of summation order flips a branch."""
    ts = j_et.enter_table(jp, jittered(jp))
    step_pre, _ = j_et.make_table_step_parts(jp)
    ts_mid = jax.jit(lambda t: step_pre(t, False, False, True))(ts)
    tbl, strip = j_et._make_mega_glue(jp)[0](ts_mid.fields)
    return tbl, strip, int(ts.step) + 1


@pytest.mark.parametrize("scene", ["hex300", "payload_obstacles"])
def test_span_twin_matches_jax(scene, no_mega_switch):
    if scene == "hex300":
        jp, tp = params_pair(slot_rebuild_steps=4)
    else:
        jp, tp = params_pair(
            n_cells=64, n_dead=-1, attraction_factor=2.0,
            circle_obstacles=((0.5, 0.0, 0.3),),
            rect_obstacles=((-1.5, -1.0, -0.5, 0.5),),
        )
    assert j_mk.mega_eligible(jp) and t_mk.mega_eligible(tp)
    n_pad = j_et._geometry(jp)[2]
    tbl, strip, first = span_inputs(jp)
    want_t, want_s = jax.jit(j_mk.make_mega_span(jp, n_pad))(
        tbl, strip, jnp.int32(first)
    )
    got_t, got_s = t_mk.make_mega_span(tp, n_pad)(
        torch.tensor(np.asarray(tbl)), torch.tensor(np.asarray(strip)), first
    )
    for j, kf in enumerate(t_et.TABLE_FIELDS):
        for got, want in ((got_t, want_t), (got_s, want_s)):
            np.testing.assert_allclose(
                got[j].numpy(), np.asarray(want[j]), atol=1e-4, rtol=1e-4,
                err_msg=kf,
            )
    # the span really moved the scene
    assert not np.array_equal(got_t[0].numpy(), np.asarray(tbl[0]))


def chunk_params():
    # cog every 8 steps, phase every 16 -> seg = 8, bps = 2: each segment is
    # one gated regular block and one span
    return params_pair(n_cells=256, centroid_int=0.08, phase_update_interval=0.16)


def assert_chunk_close(got, want):
    for k, tol in CHUNK_TOL.items():
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0, err_msg=k)
    assert int(got["step"]) == int(want["step"]) == 24


@pytest.fixture(scope="module")
def chunk_start():
    jp, tp = chunk_params()
    return jp, tp, jittered(jp)


def test_chunk_matches_jax_mega_chunk(chunk_start, span_steps, no_mega_switch):
    jp, tp, st = chunk_start
    assert t_et.gate_seg(tp) == j_et.gate_seg(jp) == 8
    start = arrays_of(st)
    run_j = j_et.make_run_chunk_table(jp)
    assert run_j.path_info["use_mega"] is True
    want = arrays_of(run_j(st, 24, True))
    run_t = t_et.make_run_chunk_table(tp)
    assert run_t.path_info["use_mega"] is True
    got = state_to_arrays(run_t(state_from_arrays(tp, start, "cpu"), 24, True))
    # one span per segment, opening on the segment's second block
    assert span_steps == [4, 12, 20] and run_t.redos == 0
    assert_chunk_close(got, want)


def test_mega_schedule_matches_regular_schedule(chunk_start, span_steps):
    _, tp, st = chunk_start
    start = arrays_of(st)
    run = t_et.make_run_chunk_table(tp)
    mega = state_to_arrays(run(state_from_arrays(tp, start, "cpu"), 24, True))
    assert span_steps == [4, 12, 20]
    regular = state_to_arrays(run(state_from_arrays(tp, start, "cpu"), 24, False))
    assert span_steps == [4, 12, 20] and run.redos == 0
    assert_chunk_close(mega, regular)


def test_forced_redo_reproduces_regular_schedule(span_steps):
    """A 60 u/s kick moves one bot several cells per rebuild window, so the
    spans' incremental rebuilds refuse and every segment is redone on the
    regular path.  With phase noise on, the redo must replay the same draws
    (the generator state is restored), so the output is the regular run's
    exactly."""
    _, tp = params_pair(
        n_cells=128, centroid_int=0.08, phase_update_interval=0.16,
        phase_std=0.5,
    )
    assert t_et.gate_seg(tp) == 8
    arrays = state_to_arrays(pt.Simulation(tp, device="cpu").state)
    arrays["vel"][7, 0] += 60.0

    run = t_et.make_run_chunk_table(tp)
    a = state_from_arrays(tp, arrays, "cpu")
    b = state_from_arrays(tp, arrays, "cpu")
    for _ in range(2):  # one segment per chunk
        a = run(a, 8, True)
        b = run(b, 8, False)
    assert span_steps and run.redos >= 1
    sa, sb = state_to_arrays(a), state_to_arrays(b)
    for k in STATE_KEYS:
        assert np.array_equal(sa[k], sb[k]), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    # the noise was drawn: phases moved off their initial values
    assert not np.array_equal(sa["phase"], arrays["phase"])
