"""PyTorch port, the packed scene-tiling sweep (``parallel/packed.py``) and
the table loop's ``phase_fn`` hook, against the JAX package.

After the JAX package's ``tests/test_packed.py``: tile offsets move the
pair arithmetic by ulps, so per-bot comparisons hold over short horizons
(16 steps, 2e-5 against single-scene runs) and longer runs are held by
their macrostate (per-scene centroids within 2e-2 of sequential runs over
64 steps).  The scenes are small (16 bots) so that the plain twins run
the union's table quickly on the CPU.  Initial positions are jittered by
1e-4 (``pack_scenes(..., jitter_scale=)``).  The phase hook is compared with JAX's on the same
planes to atol 1e-4 with rtol 1e-5 in phase (phases of ~10 from light
distances rounded each package's own way, as the JAX test holds its
oracle).  The packed union against JAX's union on JAX's
draws: the slice tests' tolerances (positions 1e-5, velocities 1e-4,
radii and the ring 1e-6, phases 1e-4) over 12 steps.
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
from particlerobotsimulations_torch.models.placement import initial_state_arrays
from particlerobotsimulations_torch.ops.phase import update_phase
from particlerobotsimulations_torch.parallel import packed as t_pk
from particlerobotsimulations_torch.parallel import sweep as t_sw
from particlerobotsimulations_torch.state import make_state, state_from_arrays, state_to_arrays
from particlerobotsimulations_tpu import engine_table as j_et
from particlerobotsimulations_tpu.parallel import packed as j_pk

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

JIT = 1e-4
STATE_KEYS = (
    "pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r",
    "centroid_ring", "step",
)
TOL = {"pos": 1e-5, "vel": 1e-4, "rad": 1e-6, "centroid_ring": 1e-6, "phase": 1e-4}


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


def scene_pair(**kw):
    """Scenes of 16 RANDOM bots, light far at (-20, 0), the centroid every
    8 steps and the phase law every 16 (gate segments of 8 steps): two
    scenes pack into a G=32 union table."""
    base = dict(
        n_cells=16, n_dead=0, seed=7, config=pj.Config.RANDOM,
        light_x=-20.0, light_y=0.0, phase_std=0.0,
        centroid_int=0.08, phase_update_interval=0.16,
        force_backend=pj.ForceBackend.PALLAS,
    )
    base.update(kw)
    jp = pj.SimParams(**base)
    return jp, pt.SimParams(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})


def test_pack_scenes_equals_jax():
    """Origins, pitch, the packed params and the packed state's arrays."""
    jp, tp = scene_pair()
    for jit in (0.0, JIT):
        pj_pp, pj_st, pj_org, pj_pitch = j_pk.pack_scenes(jp, [0, 1, 2], jitter_scale=jit)
        pp, st, org, pitch = t_pk.pack_scenes(tp, [0, 1, 2], jitter_scale=jit, device="cpu")
        assert pitch == pj_pitch
        np.testing.assert_array_equal(org, pj_org)
        assert dataclasses.asdict(pp) == dataclasses.asdict(pj_pp)
        got = state_to_arrays(st)
        for k in STATE_KEYS:
            np.testing.assert_array_equal(got[k], np.asarray(getattr(pj_st, k)), err_msg=k)


def test_eligibility_equals_jax():
    jp, tp = scene_pair()
    cases = ({}, {"n_dead": 3}, {"n_dead": -1}, {"light_shadow": 1},
             {"circle_obstacles": ((0.0, 0.0, 1.0),)}, {"control": pj.Control.FIXED_PHASE})
    for kw in cases:
        tkw = dict(kw)
        if "control" in tkw:
            tkw["control"] = pt.Control.FIXED_PHASE
        assert t_pk.packed_eligible(tp.replace(**tkw)) == j_pk.packed_eligible(jp.replace(**kw))
    assert t_pk._tile_grid(5) == j_pk._tile_grid(5) == (3, 2)
    with pytest.raises(ValueError, match="packed-eligible"):
        t_sw.run_sweep(tp.replace(n_dead=3), [0, 1], 10, strategy="packed", device="cpu")
    # AUTO never picks packed on the port's devices, however many scenes
    assert t_sw.choose_sweep_strategy(tp, 256, None, "cuda") != "packed"


def test_scene_assignment_and_min_d_equal_jax():
    """The phase hook's scene decode and per-scene minimum distance, for 5
    scenes and for 17 (two column chunks of the minimum), against JAX's
    hook on the same planes and a numpy oracle.  Tolerance: phases of
    ~10 are the light distances (~20 units, ulp ~2e-6) times rise_period /
    (2 min_radius) ~6.5, each package rounding the distances its own way:
    the JAX test's atol 1e-4 with rtol 1e-5."""
    jp, tp = scene_pair()
    for seeds in ([0, 1, 2, 3, 4], list(range(17))):
        pp, st, org, pitch = t_pk.pack_scenes(tp, seeds, device="cpu")
        b, n = len(seeds), tp.n_cells
        pos = st.pos.numpy()
        rows = pos.shape[0]
        val = np.arange(rows) < b * n
        phase = np.zeros((rows,), np.float32)
        got = t_pk.make_packed_phase(pp, org, pitch)(
            {"px": torch.tensor(pos[:, 0]), "py": torch.tensor(pos[:, 1]),
             "phase": torch.tensor(phase)},
            torch.tensor(val), None, 0,
        ).numpy()
        pj_pp = j_pk.pack_scenes(jp, seeds)[0]
        want = np.asarray(j_pk.make_packed_phase(pj_pp, org, pitch)(
            {"px": jnp.asarray(pos[:, 0]), "py": jnp.asarray(pos[:, 1]),
             "phase": jnp.asarray(phase)},
            jnp.asarray(val), jax.random.key(0),
        ))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
        light = np.array([pp.light_x, pp.light_y])
        for i in range(b):
            loc = pos[i * n:(i + 1) * n] - org[i]
            dist = np.linalg.norm(loc - light, axis=-1)
            oracle = (dist.min() - dist) / (2 * pp.min_radius) * pp.rise_period
            np.testing.assert_allclose(got[i * n:(i + 1) * n], oracle, rtol=1e-5, atol=1e-4)


def jittered_single(tp, seed):
    p_eff, pos, vel, rad, phase, dead = initial_state_arrays(tp.replace(seed=seed))
    rng = np.random.default_rng(1000 + seed)
    pos = pos + JIT * rng.standard_normal((tp.n_cells, 2)).astype(np.float32)
    return p_eff, make_state(p_eff, pos, vel, rad, phase, dead, seed=seed, device="cpu")


def test_packed_matches_single_short():
    """Per-bot positions of each scene of the packed union against its
    single-scene run over 16 steps (a phase update at step 0, so the
    per-scene minimum law is exercised)."""
    _, tp = scene_pair()
    n, steps = tp.n_cells, 16
    pp, st, org, pitch = t_pk.pack_scenes(tp, [0, 1], jitter_scale=JIT, device="cpu")
    run = t_et.make_run_chunk_table(pp, phase_fn=t_pk.make_packed_phase(pp, org, pitch))
    local = t_pk.unpack_positions(run(st, steps, False), org, n)
    for i, s in enumerate([0, 1]):
        p_eff, one = jittered_single(tp, s)
        out = t_et.make_run_chunk_table(p_eff.validate())(one, steps, False)
        d = np.abs(out.pos.numpy()[:n] - local[i]).max()
        assert d < 2e-5, f"scene {i}: |dpos| {d:.2e}"


def test_packed_union_matches_jax_on_jax_draws():
    """The packed union with phase noise, 12 steps of the table loop with
    the phase hook, against JAX's on JAX's draws for the union's seed."""
    jp, tp = scene_pair(phase_std=0.6, phase_update_interval=0.04)
    pj_pp, pj_st, org, pitch = j_pk.pack_scenes(jp, [0, 1], jitter_scale=JIT)
    want = j_et.make_run_chunk_table(
        pj_pp, phase_fn=j_pk.make_packed_phase(pj_pp, org, pitch)
    )(pj_st, 12, False)
    pp, st, org_t, pitch_t = t_pk.pack_scenes(
        tp, [0, 1], jitter_scale=JIT, device="cpu", draws=JaxDraws
    )
    got = t_et.make_run_chunk_table(
        pp, phase_fn=t_pk.make_packed_phase(pp, org_t, pitch_t)
    )(st, 12, False)
    got, want = state_to_arrays(got), {k: np.asarray(getattr(want, k)) for k in STATE_KEYS}
    for k, tol in TOL.items():
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0, err_msg=k)
    assert np.abs(want["phase"][: pp.n_cells]).max() > 0


def test_phase_hook_none_equals_the_law_through_the_hook():
    """``phase_fn`` replaces the phase-gate body only: a hook that runs the
    default law (``update_phase`` on the table's planes, drawing through
    the source for the step) gives the hook-less loop bit for bit, phase
    noise and dead cells included, on the regular and the span path."""
    p = pt.SimParams(n_cells=128, n_dead=10, time_to_dead=0.04, seed=3,
                     config=pt.Config.HEX, phase_std=0.5, centroid_int=0.08,
                     phase_update_interval=0.16, light_x=-5.0,
                     force_backend=pt.ForceBackend.PALLAS).validate()

    def hook(f, val, source, step):
        pos = torch.stack([f["px"], f["py"]], dim=-1)
        return update_phase(p, pos, f["phase"], val, source, step=step)

    arrays = state_to_arrays(pt.Simulation(p, device="cpu").state)
    for aligned in (False, True):
        a = t_et.make_run_chunk_table(p)(state_from_arrays(p, arrays, "cpu"), 16, aligned)
        b = t_et.make_run_chunk_table(p, phase_fn=hook)(
            state_from_arrays(p, arrays, "cpu"), 16, aligned
        )
        for k in STATE_KEYS[:-1]:
            assert torch.equal(getattr(a, k), getattr(b, k)), (aligned, k)
        assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_packed_adaptive_runner_bitwise():
    """The packed runner on an adaptive union: its first seg-aligned chunk
    is one probe segment at the base cadence with the phase hook, bit for
    bit (JAX's ``test_packed_adaptive_runner_bitwise``)."""
    _, tp = scene_pair()
    pp, st, org, pitch = t_pk.pack_scenes(tp, [0, 1], jitter_scale=JIT, device="cpu")
    pp = pp.replace(slot_rebuild_steps=-1, n_cells=pp.n_cells)
    phase_fn = t_pk.make_packed_phase(pp, org, pitch)
    seg = t_et.gate_seg(pp)
    adaptive = t_et.make_adaptive_run_chunk(pp, phase_fn=phase_fn)
    out = adaptive(st.replace(generator=torch.Generator().manual_seed(1)), seg, True)
    want, _ = t_et.make_probe_chunk(pp.replace(slot_rebuild_steps=4), phase_fn)(
        st.replace(generator=torch.Generator().manual_seed(1))
    )
    assert torch.equal(out.pos, want.pos) and torch.equal(out.vel, want.vel)
    assert np.isfinite(out.pos.numpy()).all()


def test_run_sweep_packed_macrostate(monkeypatch):
    """``run_sweep(strategy="packed")`` runs the packed sweep, whose
    per-scene centroids track sequential runs over 64 steps, four times
    the per-bot horizon (the health checks passing at every record)."""
    _, tp = scene_pair()
    calls = []
    real = t_pk.run_sweep_packed

    def spy(*args, **kw):
        calls.append(args[1])
        return real(*args, **kw)

    monkeypatch.setattr(t_pk, "run_sweep_packed", spy)
    fin, cents = t_sw.run_sweep(tp, [0, 1], 64, record_every=32, strategy="packed",
                                device="cpu")
    assert calls == [[0, 1]] and fin.pos.shape[0] == 128
    _, seq = t_sw.run_sweep(tp, [0, 1], 64, record_every=32, strategy="sequential",
                            device="cpu")
    assert cents.shape == seq.shape == (3, 2, 2)
    assert np.abs(cents - seq).max() < 2e-2


def test_health_check_raises():
    _, tp = scene_pair()
    pp, st, org, pitch = t_pk.pack_scenes(tp, [0, 1], device="cpu")
    n = tp.n_cells

    def recs(pos):
        p = pos[: 2 * n].reshape(2, n, 2)
        return p.mean(axis=1)[None] - org[None], p.min(axis=1)[None], p.max(axis=1)[None]

    pos0 = st.pos.numpy()
    t_pk._check_health(tp, pp, org, pitch, *recs(pos0))  # a clean state passes
    bad = pos0.copy()
    bad[n:2 * n] = bad[:n]
    with pytest.raises(RuntimeError, match="isolation"):
        t_pk._check_health(tp, pp, org, pitch, *recs(bad))
    far = pos0.copy()
    far[0] = org[0] + np.array([0.0, 70.0])  # the scene box is +-64
    with pytest.raises(RuntimeError, match="wall fidelity"):
        t_pk._check_health(tp, pp, org, pitch * 100.0, *recs(far))
    near = pos0.copy()
    near[0] = org[0] + np.array([0.0, 0.6 * pitch])
    with pytest.raises(RuntimeError, match="scene-assignment margin"):
        t_pk._check_health(tp, pp, org, pitch, *recs(near))
    g = pp.resolved_grid_dim()
    wide = pos0.copy()
    wide[0] = org[0] + np.array([0.0, (g + 1) * tp.cutoff()])
    with pytest.raises(RuntimeError, match="grid fit"):
        t_pk._check_health(tp.replace(world_half=1e6), pp, org, pitch * 1e6, *recs(wide))
    # a violation only in an earlier record is still caught
    two = tuple(np.concatenate([a, b]) for a, b in zip(recs(far), recs(pos0)))
    with pytest.raises(RuntimeError, match="record 0"):
        t_pk._check_health(tp, pp, org, pitch * 100.0, *two)
