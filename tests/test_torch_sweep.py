"""PyTorch port, the seed sweep against the JAX package: batched runs,
``run_sweep`` and its strategies, the canned experiments and the CLI.

Both packages run on the CPU: the port's batched kernels take their plain
twins and the JAX batched table loop runs its Pallas kernels in interpret
mode, as the JAX package's own tests run them.  Each scene of a port batch
draws the JAX package's values for its seed (``JaxDraws``, one per scene),
so phase noise and dead cells are compared draw for draw.  HEX positions
are jittered by 1e-4 (the lattice's exact tangencies flip magnet branches).

Tolerances are the slice tests' (``tests/test_torch_rng.py``): positions
1e-5, velocities 1e-4, radii and the centroid ring 1e-6, phases 1e-4, over
12-24 steps of chaotic dynamics from force sums added in another order;
the span path's chunks JAX's mega-vs-regular ones (positions and radii
2e-4, phases 1e-4, ring 1e-5).  Against the port's own sequential runs a
batched run is held bit for bit: on the CPU every batched op computes each
scene as the scene alone computes it (the per-scene twins, vmapped
reductions over the same axis).  Where a batch's rebuild falls back for
all scenes, a scene's solo run may not; those cases are held to JAX's
batched loop, which decides the same way.
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
from particlerobotsimulations_torch.engine import make_run_chunk, make_run_chunk_batched
from particlerobotsimulations_torch.ops import megakernel as t_mk
from particlerobotsimulations_torch.parallel import sweep as t_sw
from particlerobotsimulations_torch.state import (
    batch_state_from_arrays,
    batch_state_to_arrays,
    scene_state,
    stack_states,
)
from particlerobotsimulations_tpu import engine as j_engine
from particlerobotsimulations_tpu import engine_table as j_et
from particlerobotsimulations_tpu.parallel import sweep as j_sw

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

STATE_KEYS = (
    "pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r",
    "centroid_ring", "step",
)
TOL = {"pos": 1e-5, "vel": 1e-4, "rad": 1e-6, "centroid_ring": 1e-6, "phase": 1e-4}
# the batched table loop's 300-bot scenes: velocities 3e-4 and radii 5e-6.
# Against JAX, scene 3 of seeds 1-3 parts by 1.8e-6, 5.8e-6, 2.1e-4 and
# 6.5e-4 in velocity after 4, 8, 12 and 16 steps, and by 2.4e-6 in one
# radius at 12 (8e-8 at 8; positions by at most 2.4e-7 at 12): the smooth
# growth of chaos, not a batching fault, since each package's batched run
# equals its own single-scene runs bit for bit.
TABLE_TOL = dict(TOL, vel=3e-4, rad=5e-6)
CHUNK_TOL = {"pos": 2e-4, "rad": 2e-4, "phase": 1e-4, "centroid_ring": 1e-5}
# the mesh sweep's centroids against JAX's from placed (unjittered) layouts,
# 24 steps: see test_run_sweep_mesh_matches_jax_and_unsharded
MESH_JAX_ATOL = 2e-4


class JaxDraws:
    """The JAX package's draws for ``seed``, as a step-keyed provider."""

    def __init__(self, seed: int):
        self.key = jax.random.key(seed)

    def uniform(self, step, shape, device):
        k = jax.random.fold_in(self.key, step)
        return torch.tensor(np.asarray(jax.random.uniform(k, shape)), device=device)

    def normal(self, step, shape, device):
        k = jax.random.fold_in(jax.random.fold_in(self.key, step), 1)
        return torch.tensor(
            np.asarray(jax.random.normal(k, shape, jnp.float32)), device=device
        )


def to_port(jp):
    return pt.SimParams(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})


def params_pair(**kw):
    """300 HEX bots with phase noise every 4 steps and 20 bots killed at
    step 5."""
    base = dict(
        n_cells=300, n_dead=20, time_to_dead=0.05, seed=3, config=pj.Config.HEX,
        phase_std=0.6, phase_update_interval=0.04, centroid_int=0.04,
        light_x=-5.0, light_y=0.0, grid_dim=16,
    )
    base.update(kw)
    jp = pj.SimParams(**base).validate()
    return jp, to_port(jp).validate()


def jax_batch(jp, seeds, scale=1e-4, kick=None):
    """A JAX batched state of fresh scenes, positions jittered per scene;
    ``kick`` = (scene, bot, vx) adds a velocity to one bot."""
    st = j_sw.make_batch_state(jp, seeds)
    pos = np.asarray(st.pos).copy()
    vel = np.asarray(st.vel).copy()
    rng = np.random.default_rng(99)
    pos[:, : jp.n_cells] += (scale * rng.standard_normal((len(seeds), jp.n_cells, 2))).astype(
        np.float32
    )
    if kick is not None:
        b, i, vx = kick
        vel[b, i, 0] += vx
    return st._replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel))


def arrays_of(st):
    return {k: np.asarray(jax.device_get(getattr(st, k))) for k in STATE_KEYS}


def port_batch(tp, arrays, seeds):
    return batch_state_from_arrays(tp, arrays, "cpu", draws=[JaxDraws(s) for s in seeds])


def assert_close(got: dict, want: dict, tol=TOL):
    for k, t in tol.items():
        np.testing.assert_allclose(got[k], want[k], atol=t, rtol=0, err_msg=k)
    if tol is not CHUNK_TOL:
        np.testing.assert_array_equal(got["dead"], want["dead"])
    np.testing.assert_array_equal(np.asarray(got["step"]), np.asarray(want["step"]))


def assert_equal_states(a, b):
    """Two port states, bit for bit (torch.equal on every field)."""
    for k in STATE_KEYS[:-1]:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert a.step == b.step


def sequential_runs(tp, arrays, seeds, n_steps, seg_aligned=False):
    run = make_run_chunk(tp, "cpu")
    batch = port_batch(tp, arrays, seeds)
    return [run(scene_state(batch, b), n_steps, seg_aligned) for b in range(len(seeds))]


# ------------------------------------------------------------ batched runs


def test_batched_dense_matches_jax_and_sequential():
    """DENSE, B = 3 scenes of 80 bots, 12 steps with phase noise at steps
    0, 4 and 8 and 20 bots killed at step 5: against JAX's batched run on
    JAX's draws, and bit for bit against three sequential port runs."""
    seeds = [1, 2, 3]
    jp, tp = params_pair(n_cells=80, force_backend=pj.ForceBackend.DENSE)
    st = jax_batch(jp, seeds)
    start = arrays_of(st)
    want = arrays_of(j_engine.make_run_chunk_batched(jp)(st, 12))
    run = make_run_chunk_batched(tp, "cpu")
    got = run(port_batch(tp, start, seeds), 12)
    assert got.step == 12
    assert_close(batch_state_to_arrays(got), want)
    assert (want["dead"][:, : jp.n_cells].sum(axis=1) == 20).all()
    for b, solo in enumerate(sequential_runs(tp, start, seeds, 12)):
        assert_equal_states(scene_state(got, b), solo)


@pytest.mark.parametrize("backend", ["STENCIL", "CELLGRID"])
def test_batched_per_bot_backends_equal_sequential(backend):
    """STENCIL and CELLGRID through the vmapped step: each scene bit for
    bit its sequential run (the slot scatters run out of place under
    vmap)."""
    seeds = [4, 5]
    _, tp = params_pair(n_cells=60, force_backend=pj.ForceBackend[backend])
    arrays = batch_state_to_arrays(t_sw.make_batch_state(tp, seeds, "cpu"))
    got = make_run_chunk_batched(tp, "cpu")(port_batch(tp, arrays, seeds), 8)
    for b, solo in enumerate(sequential_runs(tp, arrays, seeds, 8)):
        assert_equal_states(scene_state(got, b), solo)


@pytest.fixture
def jax_exact_rebuilds(monkeypatch):
    """Records, per batched rebuild of the JAX table loop, whether every
    scene's incremental preconditions held (its exact rebuild ran for all
    scenes where one did not)."""
    from particlerobotsimulations_tpu.ops.table_rebuild import incremental_rebuild

    events = []
    real = j_et._smart_rebuild_batched

    def recording(params, ts):
        _, ok = jax.vmap(
            lambda f, o: incremental_rebuild(params, f, j_et.MOVE_FIELDS, o)
        )(ts.fields, ts.origin)
        jax.debug.callback(lambda a: events.append(bool(np.all(a))), ok)
        return real(params, ts)

    monkeypatch.setattr(j_et, "_smart_rebuild_batched", recording)
    return events


@pytest.mark.parametrize("case", ["plain", "fallback", "spill"])
def test_batched_table_loop_matches_jax(case, jax_exact_rebuilds):
    """The batched table loop (PALLAS, K = 4, 12 steps, regular schedule)
    against JAX's ``make_run_chunk_table_batched``:

    * plain: B = 3 scenes of 300 bots with phase noise and dead cells;
      each scene also bit for bit its sequential port run;
    * fallback: B = 2 scenes of 128 bots, one bot of scene 1 kicked to 60
      u/s so its incremental preconditions fail: every scene takes the
      exact rebuild in both packages, as many times in each;
    * spill: B = 2 scenes of 48 bots on 8 + 8 slots (JAX's
      ``test_overflow_spill_batched``), no noise."""
    seeds, kick, kw = [1, 2, 3], None, {}
    if case == "fallback":
        seeds, kick, kw = [1, 2], (1, 7, 60.0), {"n_cells": 128}
    elif case == "spill":
        seeds = [0, 1]
        kw = {"n_cells": 48, "overflow_slots": 8, "cell_capacity": 8,
              "phase_std": 0.0, "n_dead": 0}
    jp, tp = params_pair(force_backend=pj.ForceBackend.PALLAS, slot_rebuild_steps=4, **kw)
    st = jax_batch(jp, seeds, kick=kick)
    start = arrays_of(st)
    want = arrays_of(j_et.make_run_chunk_table_batched(jp)(st, 12))
    n0 = t_et.REBUILDS["exact"]
    run = t_et.make_run_chunk_table_batched(tp)
    got = run(port_batch(tp, start, seeds), 12)
    exact = t_et.REBUILDS["exact"] - n0
    assert_close(batch_state_to_arrays(got), want, TABLE_TOL)
    assert len(jax_exact_rebuilds) == 3  # rebuilds at steps 3, 7 and 11
    assert exact == jax_exact_rebuilds.count(False)
    if case == "fallback":
        assert exact >= 1
    else:
        assert exact == 0
        for b, solo in enumerate(sequential_runs(tp, start, seeds, 12)):
            assert_equal_states(scene_state(got, b), solo)


# ------------------------------------------------------- the batched span


def span_pair(**kw):
    # cog every 8 steps, phase every 16 -> seg = 8, bps = 2: each segment is
    # one gated regular block and one span
    base = dict(
        n_cells=256, n_dead=0, phase_std=0.0, centroid_int=0.08,
        phase_update_interval=0.16, grid_dim=0,
        force_backend=pj.ForceBackend.PALLAS,
    )
    base.update(kw)
    return params_pair(**base)


@pytest.fixture
def span_steps(monkeypatch):
    """(first step, scenes) of every span the port's runners launch."""
    steps = []
    real = t_mk.make_mega_span

    def counting(params, n_pad):
        span = real(params, n_pad)

        def wrapped(tbl, strip, step):
            steps.append((step, tbl.shape[0] if tbl.dim() == 4 else 1))
            return span(tbl, strip, step)
        return wrapped

    monkeypatch.setattr(t_mk, "make_mega_span", counting)
    return steps


def test_batched_span_matches_jax_and_regular(span_steps, monkeypatch):
    """B = 2 scenes of 256 bots, 24 seg-aligned steps: one batched span per
    segment for both scenes, against JAX's batched span loop and the port's
    regular batched loop (JAX's
    ``test_mega_batched_chunk_matches_regular_batched``)."""
    monkeypatch.delenv("PBOT_MEGA", raising=False)
    seeds = [0, 1]
    jp, tp = span_pair()
    assert t_et.gate_seg(tp) == j_et.gate_seg(jp) == 8
    st = jax_batch(jp, seeds)
    start = arrays_of(st)
    run_j = j_et.make_run_chunk_table_batched(jp)
    assert run_j.path_info["use_mega"] is True
    want = arrays_of(run_j(st, 24, True))
    run = t_et.make_run_chunk_table_batched(tp)
    assert run.path_info["use_mega"] is True
    mega = batch_state_to_arrays(run(port_batch(tp, start, seeds), 24, True))
    assert span_steps == [(4, 2), (12, 2), (20, 2)] and run.redos == 0
    assert_close(mega, want, CHUNK_TOL)
    regular = batch_state_to_arrays(run(port_batch(tp, start, seeds), 24, False))
    assert len(span_steps) == 3
    assert_close(mega, regular, CHUNK_TOL)


@pytest.mark.parametrize("source", ["generator", "jax"])
def test_batched_span_forced_redo_replays_draws(source, span_steps):
    """Scene 1's outermost bot kicked outward to 60 u/s: its span rebuilds
    refuse, so each segment is redone for both scenes on the regular
    batched path, which must replay every scene's draws (phase noise on):
    bit for bit the regular batched run, every generator state included."""
    seeds = [2, 3]
    _, tp = span_pair(phase_std=0.5)
    arrays = batch_state_to_arrays(t_sw.make_batch_state(tp, seeds, "cpu"))
    edge = int(np.argmax(arrays["pos"][1, : tp.n_cells, 0]))
    arrays["vel"][1, edge, 0] += 60.0
    run = t_et.make_run_chunk_table_batched(tp)

    def fresh():
        if source == "jax":
            return port_batch(tp, arrays, seeds)
        return batch_state_from_arrays(tp, dict(arrays, seed=np.asarray(seeds)), "cpu")

    a, b = fresh(), fresh()
    for _ in range(2):  # one segment per chunk
        a, b = run(a, 8, True), run(b, 8, False)
    assert span_steps and run.redos >= 1
    assert_equal_states(a, b)
    assert not np.array_equal(a.phase.numpy(), arrays["phase"])
    if source == "generator":
        for ga, gb in zip(a.generator.sources, b.generator.sources):
            assert torch.equal(ga.get_state(), gb.get_state())


def test_lockstep_batch_refuses_mixed_steps():
    _, tp = params_pair(n_cells=40)
    batch = t_sw.make_batch_state(tp, [0, 1], "cpu")
    one, two = scene_state(batch, 0), scene_state(batch, 1).replace(step=4)
    with pytest.raises(ValueError, match="lockstep"):
        stack_states([one, two])
    arrays = batch_state_to_arrays(batch)
    arrays["step"] = np.array([0, 4], np.int32)
    with pytest.raises(ValueError, match="lockstep"):
        batch_state_from_arrays(tp, arrays, "cpu")


# ------------------------------------------------------------- strategies


def test_choose_sweep_strategy_equals_jax(monkeypatch):
    monkeypatch.delenv("PBOT_SWEEP_STRATEGY", raising=False)
    seen = set()
    for backend in ("AUTO", "DENSE", "PALLAS", "STENCIL", "CELLGRID"):
        for n_cells in (300, 1000, 3000, 10_000):
            for n_scenes in (1, 2, 8, 64):
                for extra in ({}, {"n_dead": 3}, {"overflow_slots": 8}):
                    jp = pj.SimParams(
                        n_cells=n_cells, force_backend=pj.ForceBackend[backend], **extra
                    ).validate()
                    want = j_sw.choose_sweep_strategy(jp, n_scenes, None)
                    got = t_sw.choose_sweep_strategy(to_port(jp), n_scenes, None, "cpu")
                    assert got == want, (backend, n_cells, n_scenes, extra)
                    seen.add(got)
    assert seen == {"sequential", "batched"}
    # on the card, AUTO puts the band on PALLAS: sequential, as on a TPU
    band = pt.SimParams(n_cells=1000)
    assert t_sw.choose_sweep_strategy(band, 8, None, "cuda") == "sequential"
    assert t_sw.choose_sweep_strategy(band.replace(n_cells=10_000), 8) == "batched"


def test_run_sweep_sequential_matches_batched():
    """The two strategies agree scene by scene, bit for bit (JAX's
    ``test_sweep_sequential_matches_batched`` holds them to 1e-5)."""
    p = pt.SimParams(n_cells=24, n_dead=0, seed=1, max_time=60.0)
    fin_s, seq = t_sw.run_sweep(p, [0, 1, 2], 24, record_every=12,
                                strategy="sequential", device="cpu")
    fin_b, bat = t_sw.run_sweep(p, [0, 1, 2], 24, record_every=12,
                                strategy="batched", device="cpu")
    assert seq.shape == bat.shape == (3, 3, 2)
    np.testing.assert_array_equal(seq, bat)
    assert_equal_states(fin_s, fin_b)


@pytest.mark.parametrize("strategy", ["sequential", "batched"])
def test_run_sweep_matches_jax(strategy, monkeypatch):
    """``run_sweep`` on JAX's draws against JAX's: 3 scenes of 40 RANDOM
    bots with phase noise, 24 steps recorded every 8 (DENSE on the CPU in
    both packages), and the summary of the same centroids."""
    monkeypatch.delenv("PBOT_SWEEP_STRATEGY", raising=False)
    jp = pj.SimParams(n_cells=40, n_dead=0, seed=1, config=pj.Config.RANDOM,
                      phase_update_interval=0.04, light_x=-5.0, light_y=1.0)
    tp = to_port(jp)
    fin_j, want = j_sw.run_sweep(jp, [0, 1, 2], 24, record_every=8, strategy=strategy)
    fin_t, got = t_sw.run_sweep(tp, [0, 1, 2], 24, record_every=8, strategy=strategy,
                                device="cpu", draws=JaxDraws)
    assert got.shape == want.shape == (4, 3, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        fin_t.pos.numpy(), np.asarray(fin_j.pos), atol=1e-5, rtol=0
    )
    s_t, s_j = t_sw.sweep_summary(got, tp), j_sw.sweep_summary(np.asarray(got), jp)
    for k in ("distance_mean", "distance_std", "centroid_mean"):
        np.testing.assert_array_equal(s_t[k], s_j[k])


def test_run_sweep_refuses_unknown_strategy_and_mesh():
    """Unknown strategies, and any strategy but batched with a mesh (the
    scene batch is the mesh's parallel axis): JAX's ``ValueError`` s.  With
    a mesh AUTO picks batched, as in the JAX package."""
    from particlerobotsimulations_torch.parallel.mesh import Mesh

    p = pt.SimParams(n_cells=24, n_dead=0)
    mesh = Mesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="unknown sweep strategy"):
        t_sw.run_sweep(p, [0, 1], 10, strategy="bogus", device="cpu")
    for strategy in ("sequential", "packed"):
        with pytest.raises(ValueError, match="incompatible with a device mesh"):
            t_sw.run_sweep(p, [0, 1], 10, mesh=mesh, strategy=strategy, device="cpu")
    band = pt.SimParams(n_cells=1000, force_backend=pt.ForceBackend.PALLAS)
    assert t_sw.choose_sweep_strategy(band, 8, None, "cpu") == "sequential"
    assert t_sw.choose_sweep_strategy(band, 8, mesh) == "batched"
    assert t_sw.choose_sweep_strategy(p, 1, mesh) == "batched"


@pytest.mark.parametrize("backend", ["DENSE", "PALLAS"])
def test_run_sweep_mesh_matches_jax_and_unsharded(backend, monkeypatch):
    """``run_sweep(mesh=)`` over 4 CPU places, 8 seeds of 40 RANDOM bots (2
    per place) with phase noise, 24 steps recorded every 8: against the
    port's unsharded batched run, bit for bit where no group's rebuild fell
    back (DENSE has none; on PALLAS each group decides for its own
    scenes), and on DENSE against JAX's ``run_sweep(mesh=default_mesh())``
    on its 8 virtual devices, on JAX's draws (``test_run_sweep_matches_jax``'s
    scene).  The placed layouts are not jittered, and their exact
    tangencies flip contact branches between the two packages within the
    first steps: seed 7 parts from JAX by 5.9e-6 at step 4 and 1.18e-4 at
    step 24, with or without a mesh in either package, while seeds 0-6
    stay within 2.4e-6.  So the port is held to JAX's sharded run within
    MESH_JAX_ATOL, and its gap to it must be the gap between the two
    packages' unsharded runs, bit for bit: the mesh adds nothing in
    either."""
    from particlerobotsimulations_torch.parallel.mesh import Mesh

    monkeypatch.delenv("PBOT_SWEEP_STRATEGY", raising=False)
    jp = pj.SimParams(n_cells=40, n_dead=0, seed=1, config=pj.Config.RANDOM,
                      phase_update_interval=0.04, light_x=-5.0, light_y=1.0,
                      force_backend=pj.ForceBackend[backend])
    tp = to_port(jp)
    seeds = list(range(8))
    mesh = Mesh(["cpu"] * 4)
    n0 = t_et.REBUILDS["exact"]
    fin_m, got = t_sw.run_sweep(tp, seeds, 24, mesh=mesh, record_every=8, device="cpu",
                                draws=JaxDraws)
    exact = t_et.REBUILDS["exact"] - n0
    fin_u, local = t_sw.run_sweep(tp, seeds, 24, record_every=8, device="cpu",
                                  draws=JaxDraws)
    assert got.shape == local.shape == (4, 8, 2)
    assert fin_m.pos.shape == fin_u.pos.shape and fin_m.step == 24
    if t_et.REBUILDS["exact"] - n0 == exact == 0:
        np.testing.assert_array_equal(got, local)
        assert_equal_states(fin_m, fin_u)
    else:
        np.testing.assert_allclose(got, local, atol=1e-5, rtol=0)
    if backend == "DENSE":
        _, want = j_sw.run_sweep(jp, seeds, 24, mesh=j_sw.default_mesh(), record_every=8)
        _, want_local = j_sw.run_sweep(jp, seeds, 24, record_every=8)
        np.testing.assert_allclose(got, want, atol=MESH_JAX_ATOL, rtol=0)
        np.testing.assert_array_equal(got - want, local - want_local)


# ------------------------------------------------------------ experiments


def experiment_pair(cfg=None, **kw):
    jp = pj.load_cfg(cfg) if cfg else pj.SimParams()
    jp = jp.replace(**kw)
    return jp, to_port(jp)


@pytest.mark.parametrize("kind", ["speed", "robustness", "gap", "transport"])
def test_experiment_matches_jax(kind):
    """Each canned experiment on one tiny scene, 20 steps, both packages
    on JAX's draws (DENSE on the CPU in both)."""
    from particlerobotsimulations_torch.models import experiments as te
    from particlerobotsimulations_tpu.models import experiments as je

    seeds, secs = [0], 0.2
    if kind == "speed":
        jp, tp = experiment_pair(n_cells=32, n_dead=0, seed=1, light_x=-5.0, light_y=0.0)
        want = je.phototaxis_speed(jp, seeds, secs, record_every_steps=10)
        got = te.phototaxis_speed(tp, seeds, secs, record_every_steps=10,
                                  device="cpu", draws=JaxDraws)
        keys = ("time_s", "distance_mean", "distance_std", "centroids", "approach_speed")
    elif kind == "robustness":
        jp, tp = experiment_pair(n_cells=40, n_dead=0, seed=4, light_x=-5.0, light_y=0.0,
                                 dump_interval=0.1)
        want = je.dead_cell_robustness(jp, [0.0, 0.5], seeds, secs)
        got = te.dead_cell_robustness(tp, [0.0, 0.5], seeds, secs, device="cpu",
                                      draws=JaxDraws)
        keys = ("approach_speed",)
        assert got["fractions"] == want["fractions"]
    elif kind == "gap":
        jp, tp = experiment_pair("examples/example_gap.cfg", n_cells=24, dump_interval=0.1)
        want = je.gap_transit(jp, seeds, secs)
        got = te.gap_transit(tp, seeds, secs, device="cpu", draws=JaxDraws)
        keys = ("centroids", "frac_past_wall", "distance_mean", "wall_x")
    else:
        jp, tp = experiment_pair("examples/example_object_transport.cfg", n_cells=31,
                                 dump_interval=0.1)
        want = je.payload_transport(jp, seeds, secs)
        got = te.payload_transport(tp, seeds, secs, device="cpu", draws=JaxDraws)
        keys = ("centroids", "payload_start", "payload_final", "payload_displacement")
    for k in keys:
        np.testing.assert_allclose(
            np.asarray(got[k]), np.asarray(want[k]), atol=1e-4, rtol=0, err_msg=k
        )


def test_cli_sweep_and_experiment_print_jax_formats(capsys, tmp_path):
    """``cli sweep`` and ``cli experiment ... --device cpu`` print the JAX
    package's header and row format (values within 1e-4: the draws are each
    package's own, and example.cfg draws only phase noise, off here), and
    so does ``cli sweep --mesh``."""
    from particlerobotsimulations_torch import cli as t_cli
    from particlerobotsimulations_tpu import cli as j_cli

    cfg = tmp_path / "tiny.cfg"
    cfg.write_text(open("examples/example.cfg").read() + "\nphase_std\n0\n")
    runs = (
        ["sweep", str(cfg), "--seeds", "0:2", "--steps", "20", "--n-cells", "24"],
        ["experiment", "speed", str(cfg), "--seeds", "0:2", "--sim-seconds", "0.2",
         "--n-cells", "24"],
        # JAX shards its 8 seeds over its 8 virtual devices, the port over
        # the one CPU place of default_mesh(device="cpu")
        ["sweep", str(cfg), "--seeds", "0:8", "--steps", "20", "--n-cells", "24", "--mesh"],
    )
    for argv in runs:
        assert j_cli.main(argv) == 0
        want = capsys.readouterr().out.strip().splitlines()
        assert t_cli.main(argv + ["--device", "cpu"]) == 0
        got = capsys.readouterr().out.strip().splitlines()
        assert got[0] == want[0] and len(got) == len(want) > 1
        for g, w in zip(got[1:], want[1:]):
            if w.startswith("#"):
                assert g.split(":")[0] == w.split(":")[0]
                continue
            gv, wv = g.split(","), w.split(",")
            assert len(gv) == len(wv) and gv[0] == wv[0]
            np.testing.assert_allclose([float(x) for x in gv], [float(x) for x in wv],
                                       atol=1e-4)
