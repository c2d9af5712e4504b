"""PyTorch port, the dense bot-axis split (``parallel/spatial.py``) against
the JAX package and the port's own per-bot step.

The split steps a scene whose bot axis is cut over a ring of shards
(``LocalRing``: all shards in one process), with all-gathered kinematics
feeding each shard's dense pair rows; dp x tp runs a lockstep batch of
scenes laid out shard-major, one ring per data place of a mesh.  It runs
no kernel: the pair law is plain torch on every device.

Against JAX's ``make_sharded_step`` (8 and (4, 2) virtual CPU devices):
the JAX tests' tolerances (``tests/test_parallel.py``: positions and
velocities 1e-5, radii 1e-6, contact magnitudes 1e-3, the centroid ring
1e-5), at ``phase_std=0`` since JAX draws phase noise per shard.  Against
the port's own ``engine.make_step`` on one draw source (phase noise and dead
cells on): every per-bot field bit for bit, since each shard computes its
rows' terms and sums as the whole scene does; the centroid ring within
1e-6, since the ring-wide sum adds the shards' partial sums in another
order.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import particlerobotsimulations_torch as pt
import particlerobotsimulations_tpu as pj
from particlerobotsimulations_torch.engine import make_step, make_step_batched
from particlerobotsimulations_torch.parallel import spatial as t_sp
from particlerobotsimulations_torch.parallel.mesh import Mesh
from particlerobotsimulations_torch.parallel.ring import LocalRing
from particlerobotsimulations_torch.parallel.sweep import (
    gather_batch,
    make_batch_state,
    shard_batch,
)
from particlerobotsimulations_torch.state import (
    batch_state_from_arrays,
    state_from_arrays,
)
from particlerobotsimulations_tpu.parallel import spatial as j_sp
from particlerobotsimulations_tpu.parallel import sweep as j_sw

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

BOT_KEYS = ("pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r")


def to_port(jp):
    return pt.SimParams(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})


def arrays_of(st):
    keys = BOT_KEYS + ("centroid_ring", "step")
    return {k: np.asarray(jax.device_get(getattr(st, k))) for k in keys}


def test_dense_split_matches_jax_on_8_devices():
    """100 DENSE bots stepped to step 100 by the JAX package, then one
    split step on ``LocalRing(8)`` against JAX's split step on 8 devices
    (JAX's ``test_spatial_sharding_matches_dense``)."""
    jp = pj.SimParams(n_cells=100, n_dead=0, seed=1, max_time=60.0, phase_std=0.0,
                      force_backend=pj.ForceBackend.DENSE)
    sim = pj.Simulation(jp)
    sim.step_chunk(100)
    mesh = JaxMesh(np.array(jax.devices()[:8]), ("bots",))
    jstep, _ = j_sp.make_sharded_step(sim.params, mesh)
    want = arrays_of(jstep(j_sp.shard_state(sim.state, mesh)))
    tp = to_port(sim.params)
    ring = LocalRing(8, "cpu")
    step = t_sp.make_sharded_step(tp, ring, device="cpu")
    start = state_from_arrays(tp, arrays_of(sim.state), "cpu")
    got = t_sp.gather_state(step(t_sp.shard_state(start, ring)), ring)
    assert got.step == int(want["step"]) == 101
    for k, tol in (("pos", 1e-5), ("vel", 1e-5), ("rad", 1e-6), ("abs_force_r", 1e-3)):
        np.testing.assert_allclose(getattr(got, k).numpy(), want[k], atol=tol, rtol=0, err_msg=k)
    # and the port's unsplit step from the same state, bit for bit
    ref = make_step(tp, "cpu")(state_from_arrays(tp, arrays_of(sim.state), "cpu"))
    for k in BOT_KEYS:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k


def noisy_params(**kw):
    """DENSE bots with phase noise every 4 steps, 9 killed at step 5."""
    base = dict(n_cells=100, n_dead=9, time_to_dead=0.05, seed=1, phase_std=0.5,
                phase_update_interval=0.04, centroid_int=0.04,
                force_backend=pt.ForceBackend.DENSE)
    base.update(kw)
    return pt.SimParams(**base).validate()


def assert_split_equals(got, ref, n_cells):
    for k in BOT_KEYS:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    np.testing.assert_allclose(got.centroid_ring.numpy(), ref.centroid_ring.numpy(),
                               atol=1e-6, rtol=0)
    assert got.step == ref.step
    assert int(got.dead[..., :n_cells].sum()) == 9 * (got.pos.shape[0] if got.pos.dim() == 3 else 1)


@pytest.mark.parametrize("shards", [4, 8])
def test_dense_split_equals_make_step_with_noise_and_dead(shards):
    """12 split steps against ``engine.make_step``, each run drawing from its
    own generator seeded alike: the dead cells (step 5) and the noise of the
    phase gates at 0, 4 and 8 are the same draws."""
    p = noisy_params()
    ring = LocalRing(shards, "cpu")
    step, ref_step = t_sp.make_sharded_step(p, ring, device="cpu"), make_step(p, "cpu")
    st = t_sp.shard_state(pt.Simulation(p, device="cpu").state, ring)
    ref = pt.Simulation(p, device="cpu").state
    assert st.pos.shape == (shards, 128 // shards, 2)
    for _ in range(12):
        st, ref = step(st), ref_step(ref)
    assert_split_equals(t_sp.gather_state(st, ring), ref, p.n_cells)


def test_dense_split_batch_equals_make_step_batched():
    """dp x tp on one ring: three scenes laid out shard-major on
    ``LocalRing(4)``, 12 steps with noise and dead cells, against the
    vmapped per-scene step on the same scenes' generators."""
    p = noisy_params()
    ring = LocalRing(4, "cpu")
    step = t_sp.make_sharded_step(p, ring, batch=True, device="cpu")
    st = t_sp.shard_state(make_batch_state(p, [0, 1, 2], "cpu"), ring, batch=True)
    assert st.pos.shape == (4, 3, 32, 2) and st.centroid_ring.shape[0] == 3
    ref, ref_step = make_batch_state(p, [0, 1, 2], "cpu"), make_step_batched(p, "cpu")
    for _ in range(12):
        st, ref = step(st), ref_step(ref)
    assert_split_equals(t_sp.gather_state(st, ring, batch=True), ref, p.n_cells)


def test_dp_tp_dense_matches_jax():
    """64 DENSE bots x 5 steps, four scenes: the port on a (2, 2) mesh
    (each data place's two scenes on a ``LocalRing(2)``) against JAX's
    composed dp x tp step on a (4, 2) mesh, scene by scene (JAX's
    ``test_composed_dp_tp_matches_unsharded``).  Positions are jittered
    by 1e-4: the HEX lattice's pairs are exactly tangent, where the two
    packages' sums in another order flip contact branches."""
    jp = pj.SimParams(n_cells=64, n_dead=0, seed=1, max_time=60.0, phase_std=0.0,
                      force_backend=pj.ForceBackend.DENSE)
    seeds = [0, 1, 2, 3]
    batch = j_sw.make_batch_state(jp, seeds)
    noise = 1e-4 * np.random.default_rng(99).standard_normal(batch.pos.shape)
    batch = batch._replace(pos=batch.pos + noise.astype(np.float32))
    jmesh = JaxMesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "bots"))
    jstep, _ = j_sp.make_sharded_step(jp, jmesh, batch_axis="data")
    st = j_sp.shard_state(batch, jmesh, batch_axis="data")
    for _ in range(5):
        st = jstep(st)
    want = arrays_of(st)

    tp = to_port(jp)
    mesh = Mesh(np.array(["cpu"] * 4).reshape(2, 2), ("data", "bots"))
    groups = shard_batch(batch_state_from_arrays(tp, arrays_of(batch), "cpu"), mesh)
    assert [g.pos.shape[0] for g in groups] == [2, 2]
    outs = []
    for g, dev in zip(groups, mesh.axis_devices("data")):
        ring = LocalRing(mesh.shape["bots"], dev)
        step = t_sp.make_sharded_step(tp, ring, batch=True)
        g = t_sp.shard_state(g, ring, batch=True)
        for _ in range(5):
            g = step(g)
        outs.append(t_sp.gather_state(g, ring, batch=True))
    got = gather_batch(outs)
    assert got.step == 5 and (want["step"] == 5).all()
    for b in range(len(seeds)):
        for k in ("pos", "vel", "centroid_ring"):
            np.testing.assert_allclose(getattr(got, k)[b].numpy(), want[k][b], atol=1e-5,
                                       rtol=0, err_msg=f"scene {b} {k}")


def test_dense_split_refuses():
    p = noisy_params()
    with pytest.raises(ValueError, match="not divisible"):
        t_sp.make_sharded_step(p, LocalRing(3, "cpu"))
    step = t_sp.make_sharded_step(p, LocalRing(4, "cpu"))
    st = t_sp.shard_state(pt.Simulation(p, device="cpu").state, LocalRing(4, "cpu"))
    with pytest.raises(ValueError, match="ring on"):
        step(st.replace(pos=st.pos.to("meta")))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_sp.make_sharded_step(p)
