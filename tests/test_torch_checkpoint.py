"""PyTorch port, checkpoints and resume (``io/checkpoint.py``,
``Simulation.from_checkpoint`` / ``resume_from_csv`` / ``run``) against the
JAX package.

Checkpoints cross both ways: a JAX checkpoint continues in the port on
JAX's own draws (``JaxDraws``: dead scores and phase noise, draw for draw)
within the slice tests' per-bot tolerances over 12 steps (positions 1e-5,
velocities 1e-4, radii and the centroid ring 1e-6, phases 1e-4; chaotic
dynamics from force sums added in another order, ``tests/test_torch_rng.py``);
a port checkpoint loads in the JAX package with its params equal, its
arrays bit for bit and its key ``jax.random.key(seed)``.  A port
checkpoint continues in the port bit for bit, as JAX's own tests require
(``tests/test_io.py``): on DENSE, and on the PALLAS table loop (CPU twins)
resumed off a gate-segment boundary.
"""

import dataclasses
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particlerobotsimulations_torch as pt
import particlerobotsimulations_tpu as pj
from particlerobotsimulations_torch.engine_table import gate_seg
from particlerobotsimulations_torch.io import checkpoint as t_ck
from particlerobotsimulations_torch.state import state_to_arrays
from particlerobotsimulations_tpu.io import checkpoint as j_ck

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

STATE_KEYS = (
    "pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r",
    "centroid_ring",
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


def to_port(jp):
    return pt.SimParams(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})


def small_params(**kw):
    base = dict(n_cells=8, n_dead=0, seed=4, max_time=2.0, dump_interval=1.0, testing=1)
    base.update(kw)
    return pt.SimParams(**base)


def assert_states_equal(a, b):
    for k in STATE_KEYS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert a.step == b.step


# ------------------------------------------------------ across the packages


def test_jax_checkpoint_continues_in_port(tmp_path):
    """96 jittered HEX bots, phase noise every 4 steps, 8 bots killed at
    step 9: JAX runs 6 steps and saves; the port loads the file on JAX's
    draws and runs 12 more steps (through the injection and two phase
    draws) against JAX continuing from its own checkpoint."""
    jp = pj.SimParams(
        n_cells=96, n_dead=8, time_to_dead=0.09, seed=11, config=pj.Config.HEX,
        phase_std=0.6, phase_update_interval=0.04, centroid_int=0.04,
        light_x=-5.0, light_y=0.0,
    )
    jsim = pj.Simulation(jp)
    pos = np.asarray(jsim.state.pos).copy()
    pos[: jp.n_cells] += (
        1e-4 * np.random.default_rng(99).standard_normal((jp.n_cells, 2))
    ).astype(np.float32)
    jsim = pj.Simulation(jsim.params, state=jsim.state._replace(pos=jnp.asarray(pos)))
    jsim.step_chunk(6)
    path = str(tmp_path / "jax.ck")
    j_ck.save_checkpoint(path, jsim.params, jsim.state)

    jp2, jst2 = j_ck.load_checkpoint(path)
    jres = pj.Simulation(jp2, state=jst2)
    jres.step_chunk(12)

    tp, tst = t_ck.load_checkpoint(path, device="cpu", draws=JaxDraws(jp.seed))
    assert tp == to_port(jp2)
    assert tst.step == 6
    tres = pt.Simulation(tp, state=tst, device="cpu")
    assert tres.backend == pt.ForceBackend.DENSE
    tres.step_chunk(12)

    got = state_to_arrays(tres.state)
    want = jax.device_get(jres.state)
    assert int(got["step"]) == int(want.step) == 18
    np.testing.assert_array_equal(got["dead"], np.asarray(want.dead))
    assert got["dead"][: jp.n_cells].sum() == jp.n_dead
    for k, tol in TOL.items():
        np.testing.assert_allclose(got[k], np.asarray(getattr(want, k)), atol=tol, err_msg=k)


def test_jax_checkpoint_without_draws_seeds_from_its_key(tmp_path):
    """A JAX file loaded with no provider draws from a generator seeded
    with the key's seed (``state.seed_of_key_data``)."""
    jp = pj.SimParams(n_cells=12, n_dead=0, seed=2**31 + 5)
    jsim = pj.Simulation(jp)
    path = str(tmp_path / "jax.ck")
    j_ck.save_checkpoint(path, jsim.params, jsim.state)
    _, tst = t_ck.load_checkpoint(path, device="cpu")
    ref = torch.Generator().manual_seed(2**31 + 5)
    assert torch.equal(tst.generator.get_state(), ref.get_state())


def test_port_checkpoint_loads_in_jax(tmp_path):
    tp = small_params(n_cells=20, n_dead=3, time_to_dead=0.1, seed=2**31 + 7)
    sim = pt.Simulation(tp, device="cpu")
    sim.step_chunk(15)
    path = str(tmp_path / "port.ck")
    t_ck.save_checkpoint(path, sim.params, sim.state)
    jp, jst = j_ck.load_checkpoint(path)
    assert to_port(jp) == sim.params
    got = state_to_arrays(sim.state)
    for k in STATE_KEYS:
        want = np.asarray(getattr(jst, k))
        assert want.dtype == got[k].dtype, k
        np.testing.assert_array_equal(want, got[k], err_msg=k)
    assert int(jst.step) == 15
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jst.key)),
        np.asarray(jax.random.key_data(jax.random.key(tp.seed))),
    )
    # and the JAX package steps it
    pj.Simulation(jp, state=jst).step_chunk(2)


# ----------------------------------------------------------- in the port


def test_checkpoint_roundtrip_dense(tmp_path):
    """The JAX package's ``test_checkpoint_roundtrip`` in the port: the
    resumed run equals the uninterrupted one bit for bit, through the
    dead injection."""
    p = small_params(n_dead=3, time_to_dead=0.6, phase_std=0.3)
    sim = pt.Simulation(p, device="cpu")
    sim.step_chunk(50)
    path = str(tmp_path / "ck.npz")
    t_ck.save_checkpoint(path, p, sim.state)
    p2, state2 = t_ck.load_checkpoint(path, device="cpu")
    assert p2 == p
    assert_states_equal(sim.state, state2)
    resumed = pt.Simulation(p2, state=state2, device="cpu")
    sim.step_chunk(50)
    resumed.step_chunk(50)
    assert_states_equal(sim.state, resumed.state)
    assert sim.state.dead[: p.n_cells].sum() == 3


def test_checkpoint_resume_misaligned_table_run(tmp_path):
    """The PALLAS table loop resumed at step 7, off its 4-step gate
    segment, equals the uninterrupted loop bit for bit, with phase noise
    drawn from the restored generator."""
    p = small_params(
        n_cells=96, config=pt.Config.HEX, force_backend=pt.ForceBackend.PALLAS,
        phase_std=0.3, max_time=2.0, dump_interval=1.0,
        centroid_int=0.08, phase_update_interval=0.12,
    )
    assert gate_seg(p.validate()) == 4
    sim = pt.Simulation(p, device="cpu")
    sim.step_chunk(7, start_step=0)
    path = str(tmp_path / "ck.npz")
    t_ck.save_checkpoint(path, sim.params, sim.state)
    resumed = pt.Simulation.from_checkpoint(path, device="cpu")
    for s in (resumed, sim):
        s.step_chunk(5, start_step=7)
        s.step_chunk(8, start_step=12)
    assert_states_equal(sim.state, resumed.state)
    assert resumed.state.step == 20


def test_checkpoint_refusals(tmp_path):
    p = small_params()
    sim = pt.Simulation(p, device="cpu")
    path = str(tmp_path / "ck.npz")
    with pytest.raises(ValueError, match="step-keyed provider"):
        t_ck.save_checkpoint(path, p, sim.state.replace(generator=JaxDraws(0)))
    batched = sim.state.replace(pos=sim.state.pos[None])
    with pytest.raises(ValueError, match="batched"):
        t_ck.save_checkpoint(path, p, batched)
    # a card-written file (its generator state a Philox seed and offset)
    # cannot be restored on the CPU
    t_ck.save_checkpoint(path, p, sim.state)
    with np.load(path) as z:
        fields = dict(z)
    fields["rng_device"] = np.array("cuda")
    fields["rng_state"] = np.zeros(16, np.uint8)
    card = str(tmp_path / "card.npz")
    with open(card, "wb") as fh:
        np.savez_compressed(fh, **fields)
    with pytest.raises(ValueError, match="cuda generator state.*cpu device"):
        t_ck.load_checkpoint(card, device="cpu")
    # unless the caller hands in the draws
    _, st = t_ck.load_checkpoint(card, device="cpu", draws=JaxDraws(p.seed))
    assert isinstance(st.generator, JaxDraws)


# ------------------------------------------------------------ run and CSV


def test_run_checkpoints_and_appends_without_duplicate_row(tmp_path):
    """``run`` with checkpoints every dump, then a resume from the last
    checkpoint that appends to the same CSV: no second header, no second
    row at the resume time, and the rows of one uninterrupted run."""
    p = small_params(n_cells=10, n_dead=2, time_to_dead=0.5, phase_std=0.3)
    csv, ck = tmp_path / "a.csv", str(tmp_path / "run.ck")
    pt.Simulation(p, device="cpu").run(
        max_time=2.0, csv_path=str(csv), echo=False, checkpoint_path=ck,
        checkpoint_every_dumps=1,
    )
    resumed = pt.Simulation.from_checkpoint(ck, device="cpu")
    assert resumed.state.step == 200
    resumed.run(max_time=4.0, csv_path=str(csv), echo=False, append_csv=True,
                checkpoint_path=ck)
    one = tmp_path / "b.csv"
    whole = pt.Simulation(p, device="cpu").run(max_time=4.0, csv_path=str(one), echo=False)
    assert csv.read_text() == one.read_text()
    assert_states_equal(whole.state, pt.Simulation.from_checkpoint(ck, device="cpu").state)


def test_resume_from_csv_and_off_grid_realign(tmp_path):
    """The JAX package's CSV resume (``test_run_and_resume``,
    ``test_resume_past_dead_step_warns``) and realignment
    (``test_resume_off_dump_grid_realigns``) in the port."""
    p = small_params(max_time=1.3)  # ends at step 130, off the 100-step grid
    csv = tmp_path / "a.csv"
    sim = pt.Simulation(p, device="cpu").run(csv_path=str(csv), echo=False)
    assert sim.state.step == 130
    csv2 = tmp_path / "b.csv"
    sim.run(max_time=3.0, csv_path=str(csv2), echo=False)
    times = [float(r.split(",")[0]) for r in csv2.read_text().splitlines()[2:]]
    assert times == pytest.approx([2.0, 3.0])

    resumed = pt.Simulation.resume_from_csv(p, str(csv2), device="cpu")
    assert resumed.state.step == 300
    for a, b in zip(sim.host_view(), resumed.host_view()):
        np.testing.assert_allclose(a, b, atol=1e-5)  # 6 decimals in the CSV

    pd = small_params(n_dead=2, time_to_dead=1.0)
    csv3 = tmp_path / "c.csv"
    pt.Simulation(pd, device="cpu").run(csv_path=str(csv3), echo=False)
    with pytest.warns(UserWarning, match="time_to_dead"):
        again = pt.Simulation.resume_from_csv(pd, str(csv3), device="cpu")
    assert not again.state.dead[: pd.n_cells].any()


def test_frames_on_the_gcd_grid(tmp_path):
    """With a frame callback the chunks end on gcd(dump, frame): frames
    every 30 steps and rows every 100 over 200 steps; on an append resume
    the callback still fires at the resume step."""
    p = small_params()
    seen = []
    sim = pt.Simulation(p, device="cpu")
    sim.run(max_time=2.0, csv_path=str(tmp_path / "a.csv"), echo=False,
            frame_callback=lambda s: seen.append(s.state.step), frame_every_steps=30)
    assert seen == [0, 30, 60, 90, 120, 150, 180]
    seen.clear()
    sim.run(max_time=2.4, csv_path=str(tmp_path / "a.csv"), echo=False,
            frame_callback=lambda s: seen.append(s.state.step), frame_every_steps=30,
            append_csv=True)
    assert seen == [200, 210, 240]
    assert len((tmp_path / "a.csv").read_text().splitlines()) == 2 + 3


def test_cli_checkpoint_resume_video(tmp_path, capsys):
    """``cli simulate`` on a 64-bot scene on the CPU: a checkpointed,
    recorded run to 2 s, then ``--resume`` to 3 s.  The CSV continues on
    the dump grid with no duplicate row, the summary counts only the
    resumed steps, the video holds the resumed run's frames, and the end
    state equals a one-call run's bit for bit."""
    from particlerobotsimulations_torch import cli

    csv, ck, avi = tmp_path / "out.csv", str(tmp_path / "run.ck"), tmp_path / "v.avi"
    cfg = tmp_path / "t.cfg"
    cfg.write_text(
        f"nCells\n64\nnDead\n3\ntime_to_dead\n0.5\nphase_std\n0.3\nmax_time\n2\n"
        f"dump_interval\n1\ntesting\n1\ncsv_filename\n{csv}\nvideo_filename\n{avi}\n"
    )
    video = ["--video", "--video-width", "160", "--video-height", "120",
             "--frame-every", "50"]
    assert cli.main(["simulate", str(cfg), "--device", "cpu", "--quiet",
                     "--checkpoint", ck, "--checkpoint-every", "1", *video]) == 0
    assert "(200 steps, 64 bots" in capsys.readouterr().err
    assert cli.main(["simulate", str(cfg), "--device", "cpu", "--quiet", "--resume",
                     "--checkpoint", ck, "--max-time", "3", *video]) == 0
    err = capsys.readouterr().err
    assert "resumed at t = 2 s" in err and "(100 steps, 64 bots" in err

    rows = csv.read_text().splitlines()
    assert rows[0].startswith("Seed") and not any(r.startswith("Seed") for r in rows[1:])
    assert [float(r.split(",")[0]) for r in rows[2:]] == [0.0, 1.0, 2.0, 3.0]
    data = avi.read_bytes()
    assert struct.unpack("<I", data[48:52])[0] == 3  # steps 200, 250, 300

    params = pt.load_cfg(str(cfg)).replace(max_time=3.0)
    one = pt.Simulation(params, device="cpu").run(
        csv_path=str(tmp_path / "one.csv"), echo=False
    )
    assert_states_equal(one.state, pt.Simulation.from_checkpoint(ck, device="cpu").state)
