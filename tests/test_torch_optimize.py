"""PyTorch port, the differentiable path (``models/optimize.py``,
``engine.make_step(differentiable=True)``, ``ops/pallas_stencil.
make_diff_pallas_collide``) against the JAX package.

Rollouts of 12 steps on 24 HEX bots (the JAX package's
``tests/test_optimize.py`` scene) from random phase offsets: the value
(the final centroid x) within VALUE_ATOL of JAX's and the phase gradient
within GRAD_RTOL / GRAD_ATOL, on DENSE and on PALLAS (the port's autograd
wrapper of kernel 1's twin against JAX's custom VJP around its Pallas
kernel in interpret mode).  Measured: the values equal, the gradients
within 7e-10 of JAX's, whose largest entry is 1.36e-4; the bound leaves
room for float32 sums taken in another order over 12 steps of contact
dynamics.  Port PALLAS against port DENSE at JAX's own tolerance there
(rtol 2e-2, atol 2e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particlerobotsimulations_torch as pt
import particlerobotsimulations_tpu as pj
from particlerobotsimulations_torch.models import optimize as t_opt
from particlerobotsimulations_torch.ops import pallas_stencil as t_ps
from particlerobotsimulations_torch.state import state_from_arrays
from particlerobotsimulations_tpu.models import optimize as j_opt

torch.set_num_threads(1)

N_STEPS = 12
VALUE_ATOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-8


def setup(**kw):
    """The JAX scene and the same state in the port, with random phases."""
    base = dict(n_cells=24, n_dead=0, seed=3, config=pj.Config.HEX, light_x=-5.0,
                light_y=0.0)
    jsim = pj.Simulation(pj.SimParams(**{**base, **kw}))
    jp = jsim.params
    tp = pt.SimParams(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})
    arrays = {k: np.asarray(v) for k, v in jax.device_get(jsim.state._asdict()).items()
              if k != "key"}
    n_pad = arrays["pos"].shape[0]
    phase0 = (0.1 * np.random.default_rng(1).standard_normal(n_pad)).astype(np.float32)
    return jp, jsim.state, tp, state_from_arrays(tp, arrays, "cpu"), phase0


def port_value_and_grad(tp, st, phase0, backend, n_steps=N_STEPS, **kw):
    rollout = t_opt.make_phase_rollout(
        tp.replace(force_backend=backend), n_steps, device="cpu", **kw
    )
    ph = torch.tensor(phase0, requires_grad=True)
    v = rollout(ph, st)
    v.backward()
    return v.item(), ph.grad.numpy()[: tp.n_cells]


@pytest.mark.parametrize("backend", ["DENSE", "PALLAS"])
def test_rollout_value_and_grad_match_jax(backend, monkeypatch):
    jp, jst, tp, st, phase0 = setup()
    rollout = j_opt.make_phase_rollout(
        jp.replace(force_backend=pj.ForceBackend[backend]), N_STEPS
    )
    jv, jg = jax.value_and_grad(rollout)(jnp.asarray(phase0), jst)
    jg = np.asarray(jg)[: jp.n_cells]

    calls = []
    twin = t_ps.stencil_forces
    monkeypatch.setattr(t_ps, "stencil_forces", lambda *a: calls.append(1) or twin(*a))
    v, g = port_value_and_grad(tp, st, phase0, pt.ForceBackend[backend])
    # PALLAS: the force pass once per step forward and once per step in
    # the checkpoint's recompute; the backward itself never runs it
    assert len(calls) == (2 * N_STEPS if backend == "PALLAS" else 0)
    assert abs(v - float(jv)) <= VALUE_ATOL
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    np.testing.assert_allclose(g, jg, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_pallas_diff_grad_matches_dense_and_plain_forward():
    """The autograd wrapper's gradient against DENSE at JAX's tolerance
    (``test_pallas_custom_vjp_matches_dense_grads``, 40 steps), and its
    forward equal to the plain PALLAS step."""
    _, _, tp, st, phase0 = setup()
    vd, gd = port_value_and_grad(tp, st, phase0, pt.ForceBackend.DENSE, 40)
    vp, gp = port_value_and_grad(tp, st, phase0, pt.ForceBackend.PALLAS, 40)
    assert np.isfinite(gp).all() and np.abs(gp).max() > 0
    np.testing.assert_allclose(gp, gd, rtol=2e-2, atol=2e-4)

    pp = tp.replace(force_backend=pt.ForceBackend.PALLAS, control=pt.Control.FIXED_PHASE,
                    phase_std=0.0)
    plain = pt.make_step(pp, device="cpu")
    diff = pt.make_step(pp, device="cpu", differentiable=True)
    a = b = st.replace(phase=torch.tensor(phase0))
    for _ in range(5):
        a, b = plain(a), diff(b)
    for k in ("pos", "vel", "rad", "abs_force_a", "abs_force_r"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_rollout_draws_the_same_values_every_evaluation():
    """Dead cells injected inside the horizon: two evaluations kill the
    same bots (the rollout restores its generator), and the generator is
    where it was."""
    _, _, tp, st, phase0 = setup(n_dead=4, time_to_dead=0.05)
    before = st.generator.get_state()
    rollout = t_opt.make_phase_rollout(tp, 10, device="cpu")
    v1 = rollout(torch.tensor(phase0), st)
    v2 = rollout(torch.tensor(phase0), st)
    assert torch.equal(v1, v2)
    assert torch.equal(st.generator.get_state(), before)


def test_grad_guard_prevents_nan_and_overflow():
    """The JAX package's regression at its horizon: a 300-step guarded
    gradient is finite, nonzero and far below float32 overflow."""
    _, _, tp, st, phase0 = setup()
    _, g = port_value_and_grad(tp, st, phase0, pt.ForceBackend.DENSE, 300, ct_clip=1.0e4)
    assert np.isfinite(g).all(), "guarded gradient still NaN/inf"
    assert np.abs(g).max() > 0.0
    assert np.abs(g).max() < 1e12


def test_optimize_phases_returns_best_iterate():
    _, _, tp, st, phase0 = setup()
    ph, hist = t_opt.optimize_phases(tp, st, n_steps=30, iters=4, lr=0.5,
                                     phase0=phase0)
    assert len(hist) == 5 and np.isfinite(hist).all()
    rollout = t_opt.make_phase_rollout(tp, 30, device="cpu")
    with torch.no_grad():
        v = rollout(torch.tensor(ph), st).item()
    assert v == pytest.approx(min(hist), abs=1e-6)
    assert hist[-1] != hist[0]  # the optimizer moved the phases
