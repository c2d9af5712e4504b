"""PyTorch port, per-bot physics ops against the JAX ops on random inputs.

Same float32 inputs (numpy, seeded) through both packages.  Tolerance:
atol 1e-6 plus rtol 1e-6: the two frameworks may round a fused expression
an ulp apart.  Contact forces are a spring constant (1000, or 2000 against
obstacles) times a difference of nearly equal distances, which carries
such an ulp up to ~1e-6 relative, so they get rtol 1e-5 (CONTACT_RTOL).
The raw pair law also has the magnet ramp, whose slope (~1.07e4 per unit of
gap) turns one ulp of a ~0.2 distance (1.5e-8) into ~1.6e-4 of force, so
its outputs get atol 1e-4 (LAW_ATOL).  Index-valued results (cell ids, slot
ranks) must be equal.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particlerobotsimulations_torch as pt
import particlerobotsimulations_tpu as pj
from particlerobotsimulations_torch.ops import actuation as t_act
from particlerobotsimulations_torch.ops import forces as t_forces
from particlerobotsimulations_torch.ops import grid as t_grid
from particlerobotsimulations_torch.ops import integrate as t_int
from particlerobotsimulations_torch.ops import pallas_stencil as t_ps
from particlerobotsimulations_torch.ops import phase as t_phase
from particlerobotsimulations_tpu.ops import actuation as j_act
from particlerobotsimulations_tpu.ops import forces as j_forces
from particlerobotsimulations_tpu.ops import grid as j_grid
from particlerobotsimulations_tpu.ops import pallas_stencil as j_ps
from particlerobotsimulations_tpu.ops import phase as j_phase

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

# the JAX ops package re-exports the integrate FUNCTION under the module's name
j_int = importlib.import_module("particlerobotsimulations_tpu.ops.integrate")

ATOL = RTOL = 1e-6
CONTACT_RTOL = 1e-5
LAW_ATOL = 1e-4

OBSTACLES = dict(
    circle_obstacles=((0.3, 0.2, 0.5), (-1.0, -0.8, 0.3)),
    rect_obstacles=((-1.2, -1.0, -8.0, 0.1), (0.8, 1.4, 0.6, 0.9)),
)


def both(**kw):
    return pj.SimParams(**kw).validate(), pt.SimParams(**kw).validate()


def t(a):
    return torch.tensor(np.asarray(a))


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), atol=atol, rtol=rtol
    )


def cloud(n, spread, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (n, 2)).astype(np.float32)
    vel = rng.normal(0.0, 0.2, (n, 2)).astype(np.float32)
    rad = rng.uniform(0.0775, 0.1175, n).astype(np.float32)
    return rng, pos, vel, rad


def test_constants_match():
    assert t_forces.MAGNET_INT1 == j_forces.MAGNET_INT1
    assert t_forces.MAGNET_INT2 == j_forces.MAGNET_INT2
    assert t_forces.MAGNET_MIN_ATTR == j_forces.MAGNET_MIN_ATTR
    assert t_grid.OFFSETS9 == j_grid.OFFSETS9
    assert t_ps.FIELDS == j_ps.FIELDS and t_ps.OFFSETS == j_ps.OFFSETS


def test_pair_forces():
    jp, tp = both()
    rng = np.random.default_rng(1)
    n = 4000
    ang = rng.uniform(0, 2 * np.pi, n)
    dist = rng.uniform(0.05, 0.6, n)
    diff = np.stack([np.cos(ang), np.sin(ang)], -1) * dist[:, None]
    diff = diff.astype(np.float32)
    rel_vel = rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    ri = rng.uniform(0.0775, 0.1175, n).astype(np.float32)
    rj = rng.uniform(0.0775, 0.1175, n).astype(np.float32)
    attr = (jp.attraction * rng.choice([0.0, 1.0, 2.0], n)).astype(np.float32)
    valid = rng.random(n) < 0.9
    want = j_forces.pair_forces(jp, diff, rel_vel, ri, rj, attr, valid)
    got = t_forces.pair_forces(tp, t(diff), t(rel_vel), t(ri), t(rj), t(attr), t(valid))
    for a, b in zip(got, want):
        close(a, b, atol=LAW_ATOL, rtol=CONTACT_RTOL)


@pytest.mark.parametrize("payload", [False, True])
def test_dense_collide(payload):
    n = 96
    jp, tp = both(n_dead=-1 if payload else 0, n_cells=n, attraction_factor=2.0,
                  **OBSTACLES)
    _, pos, vel, rad = cloud(n, 1.0, 3)
    mask = np.arange(n) < 90
    pay = np.arange(n) == 89 if payload else np.zeros(n, bool)
    want = j_forces.dense_collide(jp, pos, vel, rad, mask, pay, 0.01)
    got = t_forces.dense_collide(tp, t(pos), t(vel), t(rad), t(mask), t(pay), 0.01)
    for a, b in zip(got, want):
        close(a, b)


def test_obstacle_forces_both_forms():
    jp, tp = both(**OBSTACLES)
    _, pos, vel, rad = cloud(3000, 1.5, 5)
    want = j_forces.obstacle_forces(jp, pos, vel, rad)
    got = t_forces.obstacle_forces(tp, t(pos), t(vel), t(rad))
    for a, b in zip(got, want):
        close(a, b, rtol=CONTACT_RTOL)
    cols = (pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], rad)
    want = j_forces.obstacle_forces_xy(jp, *cols)
    got = t_forces.obstacle_forces_xy(tp, *map(t, cols))
    for a, b in zip(got, want):
        close(a, b, rtol=CONTACT_RTOL)
    assert float(np.abs(np.asarray(want[2])).max()) > 0  # some contact hit


def test_friction_both_forms():
    jp, tp = both(friction_factor=0.5, mass_factor=3.0)
    rng = np.random.default_rng(7)
    n = 2000
    vel = rng.normal(0, 0.05, (n, 2)).astype(np.float32)
    vel[:300] = 0.0  # at rest: the static hold
    force = rng.normal(0, 3.0, (n, 2)).astype(np.float32)
    pay = rng.random(n) < 0.1
    want = j_forces.friction_velocity_update(jp, vel, force, pay, 0.01)
    got = t_forces.friction_velocity_update(tp, t(vel), t(force), t(pay), 0.01)
    close(got, want)
    want = j_forces.friction_velocity_update_xy(
        jp, vel[:, 0], vel[:, 1], force[:, 0], force[:, 1], pay, 0.01
    )
    got = t_forces.friction_velocity_update_xy(
        tp, t(vel[:, 0]), t(vel[:, 1]), t(force[:, 0]), t(force[:, 1]), t(pay), 0.01
    )
    for a, b in zip(got, want):
        close(a, b)


@pytest.mark.parametrize("cc", [0, 1])
def test_update_radius(cc):
    jp, tp = both(constrained_contraction=cc)
    rng = np.random.default_rng(11 + cc)
    n = 3000
    rad = rng.uniform(0.0775, 0.1175, n).astype(np.float32)
    phase = rng.uniform(-30, 30, n).astype(np.float32)
    phase[:10] = 2e7  # frozen sentinel
    fa = rng.uniform(0, 5, n).astype(np.float32)
    fr = rng.uniform(0, 5, n).astype(np.float32)
    dead = rng.random(n) < 0.05
    mask = rng.random(n) < 0.95
    time = np.float32(123.45)
    want = j_act.update_radius(jp, rad, phase, fa, fr, dead, mask, time, 0.01)
    got = t_act.update_radius(
        tp, t(rad), t(phase), t(fa), t(fr), t(dead), t(mask), float(time), 0.01
    )
    close(got, want)


def test_integrate_and_radius_integrate_planes():
    jp, tp = both(world_half=1.2)
    rng, pos, vel, rad = cloud(2000, 1.25, 13)
    vel = vel * 20
    want = j_int.integrate(jp, pos, vel, rad, 0.01)
    got = t_int.integrate(tp, t(pos), t(vel), t(rad), 0.01)
    for a, b in zip(got, want):
        close(a, b)

    planes = {
        "px": pos[:, 0], "py": pos[:, 1], "vx": vel[:, 0], "vy": vel[:, 1],
        "rad": rad,
        "phase": rng.uniform(-10, 10, 2000).astype(np.float32),
        "aa": rng.uniform(0, 3, 2000).astype(np.float32),
        "ar": rng.uniform(0, 3, 2000).astype(np.float32),
        "dead": (rng.random(2000) < 0.1).astype(np.float32),
        "val": (rng.random(2000) < 0.9).astype(np.float32),
    }
    time = np.float32(7.31)
    want = j_int.radius_integrate_planes(
        jp, {k: jnp.asarray(v) for k, v in planes.items()}, time
    )
    got = t_int.radius_integrate_planes(
        tp, {k: t(v) for k, v in planes.items()}, float(time)
    )
    for k in ("rad", "px", "py", "vx", "vy"):
        close(got[k], want[k])


@pytest.mark.parametrize("shadow", [0, 1, 2])
def test_update_phase_with_shadows(shadow):
    jp, tp = both(light_shadow=shadow, phase_std=0.0, light_x=-5.0,
                  light_y=0.3, **OBSTACLES)
    rng, pos, _, _ = cloud(2000, 2.5, 17)
    phase = rng.uniform(-1, 1, 2000).astype(np.float32)
    mask = rng.random(2000) < 0.9
    want = j_phase.update_phase(jp, pos, phase, mask, jax.random.key(0))
    got = t_phase.update_phase(tp, t(pos), t(phase), t(mask), None)
    close(got, want, rtol=1e-6, atol=2e-6)
    if shadow:
        shadowed = np.asarray(j_phase.in_shadow(jp, pos))
        assert shadowed.any() and not shadowed.all()
        np.testing.assert_array_equal(
            t_phase.in_shadow(tp, t(pos)).numpy(), shadowed
        )


def test_update_phase_noise_is_drawn():
    _, tp = both(phase_std=0.6)
    pos = torch.zeros((64, 2))
    mask = torch.ones(64, dtype=torch.bool)
    g = torch.Generator().manual_seed(0)
    out = t_phase.update_phase(tp, pos, torch.zeros(64), mask, g)
    assert 0.3 < float(out.std()) < 0.9


def test_grid_slots_equal():
    jp, tp = both(n_cells=600, grid_dim=16)
    rng, pos, _, _ = cloud(640, 2.0, 19)
    mask = np.arange(640) < 600
    pos[600:] = 1e6
    pos[:40] = pos[0] + rng.uniform(0, 0.05, (40, 2)).astype(np.float32)  # overflow
    origin = np.asarray(j_grid.cell_origin(jp, pos, mask))
    np.testing.assert_array_equal(t_grid.cell_origin(tp, t(pos), t(mask)).numpy(), origin)
    cid_j = np.asarray(j_grid.cell_ids(jp, pos, mask))
    cid_t = t_grid.cell_ids(tp, t(pos), t(mask))
    np.testing.assert_array_equal(cid_t.numpy(), cid_j)
    for a, b in zip(t_grid.rank_cells(cid_t, 16, 16), j_grid.rank_cells(cid_j, 16, 16)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for cap in (None, 24):
        ws, wo = j_ps.assign_slots_slotmajor(jp, pos, mask, cap=cap)
        gs, go = t_ps.assign_slots_slotmajor(tp, t(pos), t(mask), cap=cap)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        assert int(go) == int(wo) > 0


@pytest.mark.parametrize("dx,dy", [(1, 0), (-1, 0), (0, 1), (1, -1), (-1, 1)])
def test_preshift_flat(dx, dy):
    x = np.random.default_rng(23).standard_normal((3, 256)).astype(np.float32)
    want = j_ps._preshift_flat(jnp.asarray(x), 16, dx, dy)
    got = t_ps._preshift_flat(t(x), 16, dx, dy)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_params_are_plain_copies():
    a = dataclasses.asdict(pt.SimParams())
    b = dataclasses.asdict(pj.SimParams())
    assert a == b
