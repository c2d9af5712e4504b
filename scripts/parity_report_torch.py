"""Quantitative paper-parity report on the PyTorch port: seed-distribution
sweeps of all five reference scenarios.

The port's copy of ``scripts/parity_report.py``: the same five scenarios
through the port's ``models/experiments.py``, summarized as distributions
(mean +/- std) and checked against the same four numeric anchors
(:func:`_anchors`, its constants unchanged), written to docs/parity_torch/
as parity.json, robustness.csv and table.md.  docs/parity/ is the JAX
package's record on a TPU.  The dead-cell robustness curve is written as
CSV points (fraction, normalized speed) instead of the JAX script's PNG:
the port draws no plots.

Usage:  python scripts/parity_report_torch.py [--seeds 8] [--quick] [--device cuda]
        (--quick shortens horizons ~10x for a smoke run)
        python scripts/parity_report_torch.py --from-json docs/parity/parity.json --out DIR
        (recompute anchors and table from saved measurements)
        python scripts/parity_report_torch.py --only robustness
        (run some of the scenarios; their results only)

Each scenario is a function of ``(seeds, sim_seconds, device)``; its
``params`` (default: the scenario's cfg) and ``draws`` (the draw source
of each seed) let tests run it shrunk on the JAX package's draws.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

EXAMPLES = os.path.join(REPO, "examples")
ROBUSTNESS_FRACTIONS = [0.0, 0.1, 0.2, 0.3, 0.4]


def cfg(name):
    from particlerobotsimulations_torch import load_cfg

    return load_cfg(os.path.join(EXAMPLES, name))


def phototaxis(seeds, sim_seconds, device="cuda", params=None, draws=None) -> dict:
    """1. phototaxis (example.cfg, 300 bots, 7200 s)."""
    from particlerobotsimulations_torch.models.experiments import phototaxis_speed

    p = params or cfg("example.cfg")
    r = phototaxis_speed(p, seeds, sim_seconds=sim_seconds, device=device, draws=draws)
    per_seed = _per_seed_speed(r, p)
    return {
        "n_cells": p.n_cells,
        "sim_seconds": sim_seconds,
        "approach_speed_mean": float(np.mean(per_seed)),
        "approach_speed_std": float(np.std(per_seed)),
        "per_seed_speed": per_seed.tolist(),
        "distance_start": float(r["distance_mean"][0]),
        "distance_end": float(r["distance_mean"][-1]),
    }


def robustness(seeds, sim_seconds, device="cuda", params=None, draws=None) -> dict:
    """2. dead-cell robustness (example_dead_cells.cfg, 100 bots, killed at
    t = 0)."""
    from particlerobotsimulations_torch.models.experiments import dead_cell_robustness

    p = params or cfg("example_dead_cells.cfg").replace(n_dead=0)
    rob = dead_cell_robustness(p, ROBUSTNESS_FRACTIONS, seeds, sim_seconds=sim_seconds,
                               device=device, draws=draws)
    speeds = np.array(rob["approach_speed"])
    norm = speeds / speeds[0] if speeds[0] else speeds
    # each seed's approach speed per fraction (their mean is the curve's
    # speed), and the standard error of the mean normalized speed over
    # the seeds (each seed's speed over the 0-dead mean)
    per_seed = np.array([_per_seed_speed(rob["per_fraction"][f], p)
                         for f in ROBUSTNESS_FRACTIONS])
    scale = speeds[0] if speeds[0] else 1.0
    sem = (per_seed / scale).std(axis=1, ddof=1) / np.sqrt(per_seed.shape[1]) \
        if per_seed.shape[1] > 1 else np.zeros(len(speeds))
    return {
        "n_cells": p.n_cells,
        "sim_seconds": sim_seconds,
        "fractions": ROBUSTNESS_FRACTIONS,
        "approach_speed": speeds.tolist(),
        "normalized_speed": norm.tolist(),
        "per_seed_speed": per_seed.tolist(),
        "normalized_speed_sem": sem.tolist(),
    }


def obstacle(seeds, sim_seconds, device="cuda", params=None, draws=None) -> dict:
    """3. obstacle field (example_obstacle.cfg, 500 bots)."""
    from particlerobotsimulations_torch.models.experiments import phototaxis_speed

    p = params or cfg("example_obstacle.cfg")
    r = phototaxis_speed(p, seeds, sim_seconds=sim_seconds, device=device, draws=draws)
    per_seed = _per_seed_speed(r, p)
    return {
        "n_cells": p.n_cells,
        "sim_seconds": sim_seconds,
        "approach_speed_mean": float(np.mean(per_seed)),
        "approach_speed_std": float(np.std(per_seed)),
        "distance_start": float(r["distance_mean"][0]),
        "distance_end": float(r["distance_mean"][-1]),
    }


def gap(seeds, sim_seconds, device="cuda", params=None, draws=None) -> dict:
    """4. gap traversal (example_gap.cfg, 1000 bots).  ``run_sweep`` has no
    grid guard (in neither package), so prints the sweep's resolved
    backend, table size, strategy and rebuilds: at AUTO on a card the
    RANDOM layout may span more cells than the table leaves usable."""
    from particlerobotsimulations_torch import engine_table
    from particlerobotsimulations_torch.models.experiments import gap_transit
    from particlerobotsimulations_torch.ops.table_rebuild import EDGE_MARGIN
    from particlerobotsimulations_torch.parallel.sweep import choose_sweep_strategy

    p = params or cfg("example_gap.cfg")
    before = dict(engine_table.REBUILDS)
    r = gap_transit(p, seeds, sim_seconds=sim_seconds, device=device, draws=draws)
    rebuilds = {k: engine_table.REBUILDS[k] - before[k] for k in before}
    g = p.resolved_grid_dim()
    print(f"gap sweep: backend {p.resolved_backend(device).name}, grid_dim {g} "
          f"({g - 2 * EDGE_MARGIN} usable cells), strategy "
          f"{choose_sweep_strategy(p, len(seeds), device=device)}, rebuilds {rebuilds}",
          flush=True)
    return {
        "n_cells": p.n_cells,
        "sim_seconds": sim_seconds,
        "frac_past_wall_mean": r["frac_past_wall_mean"],
        "frac_past_wall_per_seed": r["frac_past_wall"].tolist(),
        "distance_start": float(r["distance_mean"][0]),
        "distance_end": float(r["distance_mean"][-1]),
    }


def transport(seeds, sim_seconds, device="cuda", params=None, draws=None) -> dict:
    """5. payload transport (example_object_transport.cfg, 200+1 bots)."""
    from particlerobotsimulations_torch.models.experiments import payload_transport

    p = params or cfg("example_object_transport.cfg")
    r = payload_transport(p, seeds, sim_seconds=sim_seconds, device=device, draws=draws)
    dx = r["payload_displacement"][:, 0]
    return {
        "n_cells": p.n_cells,
        "sim_seconds": sim_seconds,
        "payload_dx_mean": float(dx.mean()),
        "payload_dx_std": float(dx.std()),
        "payload_dx_per_seed": dx.tolist(),
        "moved_toward_light_frac": float((dx < 0).mean()),
    }


SCENARIOS = ("phototaxis", "robustness", "obstacle", "gap", "transport")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=os.path.join("docs", "parity_torch"))
    ap.add_argument("--from-json", default=None, metavar="PATH",
                    help="recompute anchors and table from a saved "
                         "parity.json instead of re-running the sims")
    ap.add_argument("--only", default=None, metavar="NAMES",
                    help="run only these comma-separated scenarios of "
                         f"{','.join(SCENARIOS)} and write their results "
                         "(no anchors: they need all five)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = list(range(args.seeds))
    scale = 0.1 if args.quick else 1.0
    os.makedirs(args.out, exist_ok=True)

    if args.from_json:
        with open(args.from_json) as f:
            results = json.load(f)
        return _finish(results, cfg("example.cfg"), args)

    horizon = {
        "phototaxis": cfg("example.cfg").max_time * scale,
        "robustness": 240.0 if args.quick else 1200.0,
        "obstacle": cfg("example_obstacle.cfg").max_time * scale,
        "gap": cfg("example_gap.cfg").max_time * scale,
        "transport": cfg("example_object_transport.cfg").max_time * scale,
    }
    names = args.only.split(",") if args.only else SCENARIOS
    results = {}
    for name in names:
        results[name] = globals()[name](seeds, horizon[name], args.device)
        print(f"{name}:", results[name], flush=True)
    if args.only:
        with open(os.path.join(args.out, "parity.json"), "w") as f:
            json.dump(results, f, indent=2)
        if "robustness" in results:
            _robustness_csv(results, args.out)
        print(f"written: {args.out}/parity.json")
        return 0
    return _finish(results, cfg("example.cfg"), args)


def _finish(results, p, args) -> int:
    results["anchors"] = _anchors(results, p)
    for a in results["anchors"].values():
        print(f"anchor {a['name']}: measured {a['measured']:.3f} "
              f"{a['unit']} vs expected {a['expected']:.2f} ± {a['tol']:.2f} "
              f"-> {a['verdict']}", flush=True)

    with open(os.path.join(args.out, "parity.json"), "w") as f:
        json.dump(results, f, indent=2)

    _robustness_csv(results, args.out)
    _markdown(results, args.out)
    print(f"written: {args.out}/parity.json, robustness.csv, table.md")
    failed = [a["name"] for a in results["anchors"].values()
              if a["verdict"] != "PASS"]
    if failed and not args.quick:
        print(f"parity anchors FAILED: {failed}", file=sys.stderr)
        return 1
    return 0


def _anchors(results, p):
    """Numeric paper-unit anchors with explicit unit conversions and stated
    tolerances; copied from ``scripts/parity_report.py`` with every
    constant unchanged.

    Units: the simulation's length unit is the metre — the reference's
    radius constants (min_radius 0.0775, max_radius 0.1175) are exactly
    the Nature 2019 robot's 15.5 cm contracted / 23.5 cm expanded
    diameter, so "bot diameter" = 2*max_radius = 0.235 m (expanded, the
    paper's size reference).

    Anchor provenance (each anchor states what it is anchored to):

    * robustness_20pct_dead — the paper QUANTIFIES this one in prose: the
      swarm sustains locomotion with 20% of units failed at roughly half
      speed (Nature 2019 abstract + fig. 4 protocol).  Expected 0.5
      normalized speed, tolerance ±0.25 (the claim is "approximately
      half").
    * phototaxis_diam_per_min — the paper prints no directly comparable
      digit for the 300-bot simulated scenario, so the expected value is
      the JAX package's established measurement (5.0e-4 m/s, seed std
      2-3e-5) converted to paper units, as a ±3-sigma regression band in
      diameters/min.
    * transport_diam_per_hour — payload transport rate (paper fig. 3
      protocol: an inert, heavy, oversized disc carried toward the light)
      in diameters/hour; the band is the JAX package's measurement (payload
      dx -3.21 ± 0.50 u to -3.45 ± 0.57 u over 12000 s) in paper units,
      ±3 sigma of the seed spread; direction (toward the light) is part of
      the anchor (a positive measured value).
    * gap_transit_fraction — fraction of the 1000-bot swarm past the wall
      line at the end of example_gap.cfg (the supplementary's gap-transit
      completion observable); the band is the JAX package's measurement
      0.789-0.803 with a ±3-sigma-of-seed-spread tolerance.
    """
    diam = 2.0 * p.max_radius  # 0.235 m expanded, the paper's size unit
    ph_speed = results["phototaxis"]["approach_speed_mean"]  # m/s
    ph_dpm = ph_speed * 60.0 / diam
    rob20 = results["robustness"]["normalized_speed"][2]
    tr = results["transport"]
    tr_hours = tr["sim_seconds"] / 3600.0
    # payload moves toward the light in -x: positive rate = toward light
    tr_dph = -tr["payload_dx_mean"] / diam / tr_hours
    gap_frac = results["gap"]["frac_past_wall_mean"]

    def verdict(measured, expected, tol):
        return "PASS" if abs(measured - expected) <= tol else "FAIL"

    anchors = {
        "phototaxis_diam_per_min": {
            "name": "phototaxis_diam_per_min",
            "measured": float(ph_dpm),
            "unit": "diameters/min",
            "expected": 0.128,  # 5.02e-4 m/s * 60 / 0.235 m
            "tol": 0.02,  # ±3 sigma of the seed spread (2.7e-5 m/s)
            "conversion": "speed[m/s] * 60 / (2*max_radius = 0.235 m)",
            "anchored_to": "cross-round measurement band (regression "
                           "anchor in paper units; see docstring)",
        },
        "robustness_20pct_dead": {
            "name": "robustness_20pct_dead",
            "measured": float(rob20),
            "unit": "normalized speed",
            "expected": 0.5,
            "tol": 0.25,
            "conversion": "approach_speed(20% dead) / approach_speed(0%)",
            "anchored_to": "paper: locomotion sustained at ~half speed "
                           "with 20% of units failed (abstract + fig. 4)",
        },
        "transport_diam_per_hour": {
            "name": "transport_diam_per_hour",
            "measured": float(tr_dph),
            "unit": "diameters/hour toward light",
            # cross-round band: dx -3.21 to -3.45 u over 12000 s
            # = 4.10-4.40 diam/h; center 4.25, seed sigma ~0.70 diam/h
            "expected": 4.25,
            "tol": 2.10,  # ±3 sigma of the seed spread (0.55 u -> 0.70)
            "conversion": "-payload_dx[m] / (0.235 m) / (sim_s / 3600)",
            "anchored_to": "paper fig. 3 payload-transport protocol; "
                           "numeric band is the cross-round measurement "
                           "(see docstring) — direction included (a "
                           "negative rate = away from light FAILS)",
        },
        "gap_transit_fraction": {
            "name": "gap_transit_fraction",
            "measured": float(gap_frac),
            "unit": "fraction past wall",
            "expected": 0.79,  # cross-round: 0.789-0.803 (r2-r5)
            "tol": 0.09,  # ±3 sigma of the per-seed spread (~0.03)
            "conversion": "mean over bots of (x < wall plane) at max_time",
            "anchored_to": "paper supplementary gap-transit completion "
                           "(swarm squeezes through a 2-unit gap); "
                           "numeric band is the cross-round measurement",
        },
    }
    for a in anchors.values():
        a["verdict"] = verdict(a["measured"], a["expected"], a["tol"])
    return anchors


def _per_seed_speed(r, p):
    cents = r["centroids"]  # (n_rec, n_scenes, 2)
    light = np.array([p.light_x, p.light_y])
    d = np.linalg.norm(cents - light, axis=-1)
    t_total = r["time_s"][-1] if r["time_s"][-1] else 1.0
    return (d[0] - d[-1]) / t_total


def _robustness_csv(results, out):
    """The robustness curve's points, in place of the JAX script's PNG."""
    rob = results["robustness"]
    # a record without seeds (the JAX package's) keeps the three columns
    per_seed = rob.get("per_seed_speed")
    with open(os.path.join(out, "robustness.csv"), "w") as f:
        head = "dead_fraction,normalized_speed,approach_speed"
        if per_seed:
            head += ",normalized_speed_sem," + ",".join(
                f"speed_seed{i}" for i in range(len(per_seed[0])))
        f.write(head + "\n")
        for i, (frac, norm, speed) in enumerate(zip(rob["fractions"], rob["normalized_speed"],
                                                    rob["approach_speed"])):
            row = f"{frac:g},{norm:.6f},{speed:.6e}"
            if per_seed:
                row += f",{rob['normalized_speed_sem'][i]:.6f}," + ",".join(
                    f"{v:.6e}" for v in per_seed[i])
            f.write(row + "\n")


def _markdown(results, out):
    ph, rob = results["phototaxis"], results["robustness"]
    gap, tr, ob = results["gap"], results["transport"], results["obstacle"]
    lines = [
        "| scenario | seeds metric (this framework) | paper / reference expectation | verdict |",
        "|---|---|---|---|",
        (
            f"| phototaxis (300 bots) | approach speed "
            f"{ph['approach_speed_mean']:.2e} ± {ph['approach_speed_std']:.1e} u/s; "
            f"dist {ph['distance_start']:.2f} → {ph['distance_end']:.2f} | "
            "directed locomotion toward the light (paper's headline result) | "
            f"{'PASS' if ph['approach_speed_mean'] > 0 else 'FAIL'} |"
        ),
        (
            f"| dead cells (100 bots) | normalized speed at 0/0.1/0.2/0.3/0.4 dead: "
            f"{', '.join(f'{v:.2f}' for v in rob['normalized_speed'])} | "
            "graceful degradation; still functional at 20% dead (paper fig. 4) | "
            f"{'PASS' if rob['normalized_speed'][2] > 0.2 else 'FAIL'} |"
        ),
        (
            f"| obstacle field (500 bots) | approach speed "
            f"{ob['approach_speed_mean']:.2e} ± {ob['approach_speed_std']:.1e} u/s; "
            f"dist {ob['distance_start']:.2f} → {ob['distance_end']:.2f} | "
            "navigates between circular obstacles toward the light | "
            f"{'PASS' if ob['distance_end'] < ob['distance_start'] else 'FAIL'} |"
        ),
        (
            f"| wall gap (1000 bots) | {gap['frac_past_wall_mean']:.0%} of swarm past "
            f"the wall (per-seed: {', '.join(f'{v:.0%}' for v in gap['frac_past_wall_per_seed'])}) | "
            "swarm squeezes through a 2-unit gap (paper supplementary) | "
            f"{'PASS' if gap['frac_past_wall_mean'] > 0.5 else 'FAIL'} |"
        ),
        (
            f"| payload transport (200+1) | payload dx "
            f"{tr['payload_dx_mean']:.2f} ± {tr['payload_dx_std']:.2f} u toward light; "
            f"{tr['moved_toward_light_frac']:.0%} of seeds toward light | "
            "swarm transports an inert high-mass object (paper fig. 3) | "
            f"{'PASS' if tr['payload_dx_mean'] < 0 else 'FAIL'} |"
        ),
    ]
    for a in results.get("anchors", {}).values():
        lines.append(
            f"| ANCHOR {a['name']} | {a['measured']:.3f} {a['unit']} "
            f"({a['conversion']}) | {a['expected']:.2f} ± {a['tol']:.2f} "
            f"— {a['anchored_to']} | {a['verdict']} |"
        )
    with open(os.path.join(out, "table.md"), "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    sys.exit(main())
