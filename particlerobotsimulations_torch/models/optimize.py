"""Differentiable simulation: gradient-based actuation optimization.

Port of ``particlerobotsimulations_tpu.models.optimize``.  The per-bot step
is differentiable end to end (``engine.make_step(differentiable=True)``:
every backend as written, PALLAS through the autograd wrapper of kernel
1), so ``torch.autograd`` can optimize the per-bot actuation *phase
offsets* directly, in place of the hand-designed light-distance phase law
(particlebot_kernel_impl.cuh:286).

Each step runs under ``torch.utils.checkpoint`` (the counterpart of
``jax.checkpoint``): its activations are recomputed in the backward pass
instead of stored, so a rollout of n steps on PALLAS launches kernel 1 2n
times, n in the forward and n in the recompute.  The step's random draws
are taken outside the checkpointed function and passed in as tensors, so
a recomputed step sees the values its forward saw; and a rollout restores
its generator when it ends, so every evaluation draws the same values, as
JAX's ``fold_in(key, step)`` draws do.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import chunk, rng
from ..config import Control, SimParams
from ..engine import _make_body
from ..state import ARRAY_FIELDS, SimState, active_mask

f32 = np.float32


class _GuardLeaf(torch.autograd.Function):
    """Identity forward; the backward zeroes NaN, bounds infinities to the
    float32 range and clamps the cotangent to +-``clip`` (None: no
    clamp)."""

    @staticmethod
    def forward(ctx, x, clip):
        ctx.clip = clip
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        ct = torch.nan_to_num(ct)
        if ctx.clip is not None:
            ct = torch.clamp(ct, -ctx.clip, ctx.clip)
        return ct, None


def _grad_guard(arrays: dict, clip: float | None) -> dict:
    """Identity forward on every float tensor of a step's arrays; the
    backward sanitizes their cotangents.

    Two pathologies of backprop through the contact dynamics:

    * NaN: the stick-slip law normalizes by |v| and its kinetic branch
      zeroes velocities exactly, so stuck bots (|v| == 0) make the
      unselected ``v / |v|`` branch NaN, and the chain rule's 0 * NaN
      poisons the backward pass.  Zeroing is the right subgradient at the
      stick kink.
    * Explosion: the DEM spring makes per-step Jacobians expansive along
      contact modes, so long-horizon cotangents overflow float32.
      ``clip`` bounds them per step (BPTT clipping; biased but usable).

    Applied once per step, so a pathology born in step k cannot
    contaminate steps k-1..0."""
    return {
        k: _GuardLeaf.apply(v, clip) if v.is_floating_point() else v
        for k, v in arrays.items()
    }


def make_phase_rollout(params: SimParams, n_steps: int, ct_clip: float | None = 1.0e4,
                       device="cuda"):
    """Returns ``rollout(phase0, state0) -> final centroid x`` (a 0-d
    tensor, differentiable in ``phase0``), for states on ``device``.

    The phase controller is frozen (``FIXED_PHASE``, no noise), so the
    offsets are the only actuation schedule.  ``ct_clip`` bounds the
    per-step cotangents of the backward pass (``_grad_guard``); None
    disables the clamp (NaN sanitization always applies).  The centroid
    is taken over the ``n_cells`` real bots."""
    frozen = params.replace(control=Control.FIXED_PHASE, phase_std=0.0).validate()
    body = _make_body(frozen, frozen.resolved_backend(device), differentiable=True)
    n = params.n_cells

    def rollout(phase0: torch.Tensor, state0: SimState) -> torch.Tensor:
        arrays = {k: getattr(state0, k) for k in ARRAY_FIELDS}
        arrays["phase"] = phase0
        source, shape, dev = state0.generator, (state0.n_pad,), state0.device
        snap = rng.snapshot(source)
        try:
            for step in range(state0.step, state0.step + n_steps):
                gates = chunk.step_gates(frozen, step)
                draws = chunk.draws(frozen, source, step, gates, shape, dev)
                arrays = checkpoint(
                    body, arrays, draws, step, gates,
                    use_reentrant=False, preserve_rng_state=False,
                )
                arrays = _grad_guard(arrays, ct_clip)
        finally:
            rng.restore(source, snap)
        mask = active_mask(params, state0.n_pad, dev)
        x = arrays["pos"][:, 0]
        return torch.sum(torch.where(mask, x, torch.zeros_like(x))) / f32(n)

    return rollout


def optimize_phases(
    params: SimParams,
    state0: SimState,
    n_steps: int = 400,
    iters: int = 20,
    lr: float = 0.5,
    minimize: bool = True,
    phase0=None,
    ct_clip: float | None = 1.0e4,
):
    """Gradient-descend per-bot phase offsets to drive the swarm centroid
    (``minimize=True`` pushes it toward -x, the usual light direction),
    with ``torch.optim.Adam(lr)`` (optax Adam's defaults), on the device of
    ``state0``.

    Returns (the best evaluated phases, per-iteration objective history),
    as numpy arrays: the objective is non-convex and late iterates can
    overshoot, so the best point, not the last, comes back.  The last
    point is evaluated once more (without a gradient) and counts."""
    dev = state0.device
    rollout = make_phase_rollout(params, n_steps, ct_clip=ct_clip, device=dev)
    sign = 1.0 if minimize else -1.0

    if phase0 is None:
        # a small random spread so that the wave has something to shape
        g = torch.Generator().manual_seed(0)
        phase0 = 0.1 * torch.randn((state0.n_pad,), generator=g)
    ph = torch.as_tensor(phase0, dtype=torch.float32).to(dev).clone().requires_grad_()
    opt = torch.optim.Adam([ph], lr=lr)

    history = []
    best_v, best_ph = float("inf"), ph.detach().clone()
    for _ in range(iters):
        opt.zero_grad()
        loss = sign * rollout(ph, state0)
        loss.backward()
        v = loss.item()
        history.append(v)
        if v < best_v:
            best_v, best_ph = v, ph.detach().clone()
        opt.step()
    with torch.no_grad():
        final_v = float(sign * rollout(ph, state0))
    history.append(final_v)
    if final_v < best_v:
        best_v, best_ph = final_v, ph.detach().clone()
    return best_ph.cpu().numpy(), np.asarray(history)
