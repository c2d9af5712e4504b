"""Learned actuation vs the hand-designed light law, on the PyTorch port.

The port's copy of ``scripts/learn_phases.py``: optimizes per-bot phase
offsets by backprop through the full contact dynamics
(``particlerobotsimulations_torch.models.optimize``) and compares the
resulting phototaxis displacement against the reference's hand-designed law
phase = (min_d - dist) / (2 min_radius) * rise_period
(particlebot_kernel_impl.cuh:286) over the same horizon, from the same
initial state, with noise off.

Optimization uses a short horizon (gradients through the stiff contact
dynamics grow exponentially with it, see ``optimize._grad_guard``); the
learned phases are then evaluated on the long horizon against the hand law.

Usage: python scripts/learn_phases_torch.py [n_bots] [eval_steps] [iters] [opt_steps] [--device cuda]
Writes the loss history to artifacts/learn_phases_torch.json.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n_bots", type=int, nargs="?", default=1000)
    ap.add_argument("eval_steps", type=int, nargs="?", default=1500)
    ap.add_argument("iters", type=int, nargs="?", default=250)
    ap.add_argument("opt_steps", type=int, nargs="?", default=400)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from particlerobotsimulations_torch import Config, SimParams, Simulation
    from particlerobotsimulations_torch.engine import make_run_chunk
    from particlerobotsimulations_torch.models.optimize import (
        make_phase_rollout,
        optimize_phases,
    )
    from particlerobotsimulations_torch.ops.phase import light_distance
    from particlerobotsimulations_torch.state import active_mask

    n, steps, iters, opt_steps = args.n_bots, args.eval_steps, args.iters, args.opt_steps
    sim = Simulation(
        SimParams(n_cells=n, n_dead=0, seed=7, config=Config.HEX,
                  light_x=-20.0, light_y=0.0, phase_std=0.0),
        device=args.device,
    )
    params, state0 = sim.params, sim.state
    mask = active_mask(params, state0.n_pad, state0.device)

    def centroid_x(pos):
        return float(pos[mask, 0].mean())

    x0 = centroid_x(state0.pos)

    # baseline 1: the hand-designed light-wave law (the reference law)
    t0 = time.perf_counter()
    hand = make_run_chunk(params, args.device)(state0.replace(), steps)
    dx_hand = centroid_x(hand.pos) - x0
    print(f"hand law:      dx = {dx_hand:+.5f} over {steps} steps "
          f"({time.perf_counter() - t0:.0f} s)")

    # baseline 2: the hand phases frozen (no re-updates): the optimizer's
    # search space is a fixed phase vector, so this is the like-for-like
    # baseline it must beat
    dists = light_distance(params, state0.pos)
    min_d = dists[mask].min()
    hand_phase = torch.where(
        mask, (min_d - dists) / (2.0 * params.min_radius) * params.rise_period,
        torch.zeros_like(dists),
    )
    rollout = make_phase_rollout(params, steps, device=args.device)
    with torch.no_grad():
        dx_frozen = float(rollout(hand_phase, state0)) - x0
    print(f"frozen hand:   dx = {dx_frozen:+.5f}")

    # learned: Adam warm-started from the hand phases, short-horizon
    # optimization, long-horizon evaluation
    t0 = time.perf_counter()
    ph, hist = optimize_phases(
        params, state0, n_steps=opt_steps, iters=iters, lr=0.05,
        minimize=True, phase0=hand_phase,
    )
    dt = time.perf_counter() - t0
    with torch.no_grad():
        dx_learn = float(rollout(torch.as_tensor(ph, device=state0.device), state0)) - x0
    print(f"learned:       dx = {dx_learn:+.5f} on the {steps}-step eval "
          f"({iters} Adam iters on a {opt_steps}-step horizon, "
          f"{dt:.0f} s, {dt / max(iters, 1):.1f} s/iter)")
    print(f"short-horizon objective: {hist[0]:+.5f} -> {hist[-1]:+.5f} "
          f"(min {min(hist):+.5f})")
    print(f"improvement vs frozen hand: {dx_frozen - dx_learn:+.5f}"
          if dx_learn < dx_frozen else
          f"no improvement vs frozen hand ({dx_learn:+.5f} vs {dx_frozen:+.5f})")

    os.makedirs("artifacts", exist_ok=True)
    out_path = "artifacts/learn_phases_torch.json"
    with open(out_path, "w") as f:
        json.dump(
            {
                "n_bots": n, "eval_steps": steps, "iters": iters,
                "opt_steps": opt_steps, "device": str(state0.device),
                "x0": x0, "dx_hand_law": dx_hand,
                "dx_frozen_hand_phases": dx_frozen,
                "dx_learned": dx_learn,
                "objective_history_centroid_x": [float(v) for v in np.asarray(hist)],
            },
            f, indent=1,
        )
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
