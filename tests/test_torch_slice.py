"""PyTorch port, the slice end to end against the JAX package.

The table-resident loop (enter, K-step rebuild blocks, exit) runs on the
CPU with the kernels' plain twins and is held against the JAX
``make_run_chunk_table`` (Pallas in interpret mode) from the same
numpy-jittered state.  ``phase_std=0`` and ``n_dead=0`` wherever per-bot
values are compared: the two packages draw from different RNG streams.

Tolerances (float32, 12 steps of chaotic dynamics from reassociated force
sums): positions 1e-5, velocities 1e-4, radii and centroid ring 1e-6,
phases 1e-4 (values reach ~40, where an ulp is 4e-6).
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
from particlerobotsimulations_torch.engine import make_step as t_make_step
from particlerobotsimulations_torch.state import state_from_arrays, state_to_arrays
from particlerobotsimulations_tpu import engine_table as j_et
from particlerobotsimulations_tpu.engine import make_step as j_make_step

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

STATE_KEYS = (
    "pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r",
    "centroid_ring", "step",
)
TOL = {"pos": 1e-5, "vel": 1e-4, "rad": 1e-6, "centroid_ring": 1e-6, "phase": 1e-4}


def params_pair(**kw):
    base = dict(
        n_cells=300, n_dead=0, seed=3, config=pj.Config.HEX,
        force_backend=pj.ForceBackend.PALLAS, phase_std=0.0,
        light_x=-5.0, light_y=0.0,
    )
    base.update(kw)
    jp = pj.SimParams(**base).validate()
    tp = pt.SimParams(
        **{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    ).validate()
    return jp, tp


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


def assert_states_close(got: dict, want: dict, keys=tuple(TOL)):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], atol=TOL[k], rtol=0, err_msg=k)
    assert int(got["step"]) == int(want["step"])


@pytest.fixture(scope="module")
def table_run():
    """300 bots, PALLAS, K=4, 12 steps (3 rebuilds): both packages."""
    jp, tp = params_pair(slot_rebuild_steps=4)
    st = jittered(jp)
    start = arrays_of(st)
    want = arrays_of(j_et.make_run_chunk_table(jp)(st, 12))
    got = state_to_arrays(
        t_et.make_run_chunk_table(tp)(state_from_arrays(tp, start, "cpu"), 12)
    )
    return got, want


def test_table_loop_matches_jax(table_run):
    got, want = table_run
    assert_states_close(got, want)
    assert int(got["step"]) == 12


# force magnitude sums carried to the next step: a position difference
# within TOL["pos"] moves a pair's gap by up to twice that, which the magnet
# ramp (slope ~1.07e4) and the spring (1e3) turn into these
FORCE_ATOL = {"abs_force_a": 1.07e4 * 2 * TOL["pos"], "abs_force_r": 1e3 * 2 * TOL["pos"]}


def test_table_loop_carries_force_magnitudes(table_run):
    got, want = table_run
    for k, atol in FORCE_ATOL.items():
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=atol, err_msg=k)
    np.testing.assert_array_equal(got["dead"], want["dead"])


def test_table_loop_crosses_phase_gate_with_obstacle():
    """A phase gate at step 5 (phase_update_interval 0.05) with a circle
    obstacle casting shadows (light_shadow 1) inside the gated branch."""
    jp, tp = params_pair(
        phase_update_interval=0.05, light_shadow=1,
        circle_obstacles=((-2.0, 0.0, 0.5),), slot_rebuild_steps=4,
    )
    st = jittered(jp)
    start = arrays_of(st)
    want = arrays_of(j_et.make_run_chunk_table(jp)(st, 8))
    got = state_to_arrays(
        t_et.make_run_chunk_table(tp)(state_from_arrays(tp, start, "cpu"), 8)
    )
    assert_states_close(got, want)
    assert (np.abs(got["phase"] - start["phase"]) > 0).any()


def test_certified_closing_bound_equals_jax():
    jp, tp = params_pair()
    for k in (4, 8):
        assert t_et.certified_closing_bound(tp, k) == j_et.certified_closing_bound(jp, k)
    assert t_et.certified_closing_bound(tp, 8) == pytest.approx(3.4, abs=0.05)
    assert t_et.certified_closing_bound(tp, 4) == pytest.approx(7.9, abs=0.05)
    assert t_et.gate_seg(tp) == j_et.gate_seg(jp) == 200


def test_neighbor_rel_speed_bound_equals_jax():
    jp, tp = params_pair(n_cells=128, grid_dim=16)
    st = jittered(jp)
    rng = np.random.default_rng(5)
    vel = np.zeros_like(np.asarray(st.vel))
    vel[:128] = rng.uniform(-2, 2, (128, 2)).astype(np.float32)
    st = st._replace(vel=jnp.asarray(vel))
    jfields = jax.jit(lambda s: j_et.enter_table(jp, s).fields)(st)
    want = float(j_et.neighbor_rel_speed_bound(jp, jfields))
    ts = t_et.enter_table(tp, state_from_arrays(tp, arrays_of(st), "cpu"))
    assert float(t_et.neighbor_rel_speed_bound(tp, ts.fields)) == want


def test_rebuild_schedule_chunk_relative_and_absolute(monkeypatch):
    """K <= 8: step j of a chunk rebuilds iff j % K == K-1, whatever the
    entry step; K > 8: the absolute rule step % K == K-1."""
    seen = []
    real = t_et._smart_rebuild

    def spy(params, ts):
        seen.append(ts.step)
        return real(params, ts)

    monkeypatch.setattr(t_et, "_smart_rebuild", spy)
    for k, entry, n, want in ((4, 5, 10, [8, 12]), (12, 5, 13, [11])):
        _, tp = params_pair(n_cells=64, slot_rebuild_steps=k)
        st = pt.Simulation(tp, device="cpu").state.replace(step=entry)
        seen.clear()
        out = t_et.make_run_chunk_table(tp)(st, n)
        assert seen == want and out.step == entry + n


def test_adaptive_runner_switches_k_on_stubbed_probe(monkeypatch):
    """Probe values are read one chunk late: K=8 only after a probe at or
    below bound8, back to K=4 after one above it; unaligned or ragged
    chunks take the base K=4 runner without probing."""
    _, tp = params_pair(n_cells=128, grid_dim=16, centroid_int=0.16,
                        phase_update_interval=0.24)
    assert t_et.gate_seg(tp) == 8
    values = iter([10.0, 1.0, 1.0, 10.0, 1.0, 1.0])
    probed = []

    def fake_make_probe_chunk(params, phase_fn=None):
        def probe(state):
            probed.append(params.slot_rebuild_steps)
            pm = torch.tensor(next(values))
            return state.replace(step=state.step + 8), pm
        return probe

    monkeypatch.setattr(t_et, "make_probe_chunk", fake_make_probe_chunk)
    runner = t_et.make_adaptive_run_chunk(tp)
    st = pt.Simulation(tp, device="cpu").state
    ks = []
    for _ in range(5):
        st = runner(st, 8, True)
        ks.append(runner.live["k"])
    assert probed == [4, 4, 8, 8, 4]
    assert ks == [4, 4, 8, 8, 4]
    assert runner.last_probe == 10.0
    st = runner(st, 16, True)  # probe (k=8 after the 1.0) + 8 real K=8 steps
    assert probed[-1] == 8 and st.step == 8 * 5 + 16
    n_probes = len(probed)
    st = runner(st, 12, True)  # ragged: base runner, no probe
    st = runner(st, 8, False)  # unaligned: base runner, no probe
    assert len(probed) == n_probes and st.step == 8 * 5 + 16 + 20
    assert np.isfinite(st.pos[:128].numpy()).all()


def test_dense_step_matches_jax_over_30_steps():
    """Per bot while the trajectories are still comparable (16 steps:
    reassociated 300-term force sums seed ulp differences that the stiff
    contacts amplify chaotically, and past ~20 steps a contact/magnet
    branch flips), then the macrostate at 30."""
    jp, tp = params_pair(force_backend=pj.ForceBackend.DENSE)
    st = jittered(jp)
    ts = state_from_arrays(tp, arrays_of(st), "cpu")
    step_j = jax.jit(j_make_step(jp))
    step_t = t_make_step(tp, device="cpu")
    for i in range(30):
        st, ts = step_j(st), step_t(ts)
        if i == 15:
            assert_states_close(state_to_arrays(ts), arrays_of(st))
    got, want = state_to_arrays(ts), arrays_of(st)
    n = jp.n_cells
    np.testing.assert_allclose(
        got["pos"][:n].mean(0), want["pos"][:n].mean(0), atol=1e-4
    )
    np.testing.assert_allclose(got["rad"][:n].mean(), want["rad"][:n].mean(), atol=1e-6)
    np.testing.assert_allclose(got["centroid_ring"], want["centroid_ring"], atol=1e-6)
    assert int(got["step"]) == int(want["step"]) == 30


def test_simulation_run_csv_matches_jax(tmp_path):
    cfg = "examples/example.cfg"
    over = dict(max_time=0.3, dump_interval=0.1)
    jsim = pj.Simulation.from_cfg(cfg, **over)
    tsim = pt.Simulation.from_cfg(cfg, device="cpu", **over)
    assert tsim.backend == pt.ForceBackend.DENSE
    jsim.run(csv_path=str(tmp_path / "j.csv"), echo=False)
    tsim.run(csv_path=str(tmp_path / "t.csv"), echo=False)
    j_lines = (tmp_path / "j.csv").read_text().splitlines()
    t_lines = (tmp_path / "t.csv").read_text().splitlines()
    assert len(t_lines) == len(j_lines) == 2 + 4
    assert t_lines[:2] == j_lines[:2]
    # the t = 0 row is the initial condition, identical in both packages
    assert t_lines[2] == j_lines[2]
    assert [r.split(",")[0] for r in t_lines[2:]] == [
        r.split(",")[0] for r in j_lines[2:]
    ]
    assert tsim.state.step == 30 and tsim.health()["finite"]


def test_simulation_pallas_health_and_grid_guard():
    _, tp = params_pair(n_cells=128)
    sim = pt.Simulation(tp, device="cpu")
    sim.step_chunk(4, start_step=0)
    h = sim.health()
    assert h["finite"] and h["cell_overflow"] == 0
    # G=16: a mega-eligible table, so seg-aligned chunks take the span path
    assert sim._run_chunk.path_info["use_mega"] is True
    with pytest.raises(ValueError, match="grid_dim"):
        pt.Simulation(tp.replace(n_cells=2000, grid_dim=16), device="cpu")
