"""Canned paper experiments.

Port of ``particlerobotsimulations_tpu.models.experiments``: the Nature
2019 paper's headline studies as Monte-Carlo seed sweeps
(``parallel/sweep.run_sweep``; reference scenarios: examples/*.cfg).  Each
returns plain numpy results ready for plotting or CSV export.

* phototaxis_speed      — centroid approach speed toward the light
* dead_cell_robustness  — locomotion vs fraction of dead (non-actuating)
                          bots (examples/example_dead_cells.cfg)
* gap_transit           — fraction of the swarm past a wall gap
                          (examples/example_gap.cfg)
* payload_transport     — object displacement with the swarm
                          (examples/example_object_transport.cfg)

Every experiment takes the sweep's ``device`` and ``draws`` (the draw
source of each seed; the tests hand in the JAX package's draws).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..config import SimParams
from ..parallel.sweep import make_batch_state, run_sweep, sweep_summary


def phototaxis_speed(params: SimParams, seeds: Sequence[int], sim_seconds: float,
                     mesh=None, record_every_steps: int | None = None,
                     device="cuda", draws=None):
    """Mean/std distance-to-light trajectory plus approach speed (units/s)."""
    n_steps = int(round(sim_seconds / params.timestep))
    record = record_every_steps or params.dump_steps
    _, cents = run_sweep(params, seeds, n_steps, mesh=mesh, record_every=record,
                         device=device, draws=draws)
    s = sweep_summary(cents, params)
    d = s["distance_mean"]
    t = np.arange(len(d)) * record * params.timestep
    speed = (d[0] - d[-1]) / max(t[-1], 1e-9)
    return {
        "time_s": t,
        "distance_mean": d,
        "distance_std": s["distance_std"],
        "approach_speed": float(speed),
        "centroids": cents,
    }


def dead_cell_robustness(base: SimParams, dead_fractions: Sequence[float],
                         seeds: Sequence[int], sim_seconds: float, mesh=None,
                         device="cuda", draws=None):
    """Approach speed vs dead-cell fraction (the paper's robustness
    experiment): one sweep per fraction, the bots killed at t = 0."""
    results = {}
    for frac in dead_fractions:
        n_dead = int(round(frac * base.n_cells))
        params = base.replace(n_dead=n_dead, time_to_dead=0.0)
        results[frac] = phototaxis_speed(params, seeds, sim_seconds, mesh=mesh,
                                         device=device, draws=draws)
    return {
        "fractions": list(dead_fractions),
        "approach_speed": [results[f]["approach_speed"] for f in dead_fractions],
        "per_fraction": results,
    }


def gap_transit(params: SimParams, seeds: Sequence[int], sim_seconds: float,
                mesh=None, device="cuda", draws=None):
    """Wall-gap traversal (examples/example_gap.cfg): fraction of the swarm
    past the wall plane at the end, per seed, plus centroid trajectories."""
    if not params.rect_obstacles:
        raise ValueError("gap_transit expects rectangular wall obstacles")
    wall_x = min(x1 for (x1, _x2, _y1, _y2) in params.rect_obstacles)
    n_steps = int(round(sim_seconds / params.timestep))
    state, cents = run_sweep(params, seeds, n_steps, mesh=mesh,
                             record_every=params.dump_steps, device=device, draws=draws)
    pos = state.pos[:, : params.n_cells, :].cpu().numpy()
    frac_past = (pos[..., 0] < wall_x).mean(axis=1)  # (n_scenes,)
    s = sweep_summary(cents, params)
    return {
        "centroids": cents,
        "wall_x": float(wall_x),
        "frac_past_wall": frac_past,
        "frac_past_wall_mean": float(frac_past.mean()),
        "distance_mean": s["distance_mean"],
        "distance_std": s["distance_std"],
    }


def payload_transport(params: SimParams, seeds: Sequence[int], sim_seconds: float,
                      mesh=None, device="cuda", draws=None):
    """Payload x-displacement toward the light (n_dead == -1 scenarios)."""
    if not params.has_payload:
        raise ValueError("payload_transport requires n_dead == -1")
    start = make_batch_state(params, seeds, device, draws).pos[
        :, params.n_cells - 1, :
    ].cpu().numpy()
    n_steps = int(round(sim_seconds / params.timestep))
    state, cents = run_sweep(params, seeds, n_steps, mesh=mesh,
                             record_every=params.dump_steps, device=device, draws=draws)
    payload_pos = state.pos[:, params.n_cells - 1, :].cpu().numpy()  # (n_scenes, 2)
    disp = payload_pos - start
    return {
        "centroids": cents,
        "payload_start": start,
        "payload_final": payload_pos,
        "payload_displacement": disp,
        "payload_mean_dx": float(disp[:, 0].mean()),
    }
