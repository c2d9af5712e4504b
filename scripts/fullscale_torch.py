"""Run every shipped reference scenario at FULL scale on the PyTorch port
and write docs/fullscale_results_torch.json.

Usage:  python scripts/fullscale_torch.py [out.json] [--device cuda]

The port's copy of ``scripts/fullscale.py``: each examples/*.cfg runs
unmodified to its full max_time, and its record has that script's keys
plus the card's name and power limit.  Health (finite state, zero cell
overflow) is checked after every run.  A scene that fails (for example a
swarm wider than the slot table that AUTO gives it: ``Simulation``
refuses it, as in the JAX package) gets its error in its record; the
other scenes still run, and the script exits 1 at the end.  The CSVs go
to artifacts/fullscale_torch/ (the cfgs' csv_filename there).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def run_scene(params, device="cuda", max_time=None, csv_path=None, state=None) -> dict:
    """One scene to ``max_time`` (default ``params.max_time``) through
    ``Simulation.run``, from ``state`` when given; returns its record.
    Raises RuntimeError when the run ends unhealthy."""
    from particlerobotsimulations_torch import Simulation
    from particlerobotsimulations_torch.utils.profiling import card, sync

    sim = Simulation(params, state=state, device=device)
    p = sim.params
    light = np.array([p.light_x, p.light_y])
    horizon = p.max_time if max_time is None else max_time
    start = sim.state.step
    d0 = float(np.linalg.norm(sim.centroid() - light))
    t0 = time.perf_counter()
    sim.run(max_time=horizon, csv_path=csv_path, echo=False)
    sync(sim.state)
    wall = time.perf_counter() - t0
    health = sim.health()
    if not health["finite"]:
        raise RuntimeError("non-finite state")
    if health["cell_overflow"] != 0:
        raise RuntimeError(f"cell overflow {health['cell_overflow']}")
    d1 = float(np.linalg.norm(sim.centroid() - light))
    return {
        "bots": p.n_cells,
        "sim_seconds": horizon,
        "steps": sim.state.step - start,
        "wall_seconds": round(wall, 1),
        "dist_to_light_start": round(d0, 3),
        "dist_to_light_end": round(d1, 3),
        "backend": sim.backend.name,
        "card": card(device),
    }


def run_all(cfgs, device="cuda", max_time=None, csv_dir=REPO / "artifacts" / "fullscale_torch"):
    """Every cfg through :func:`run_scene`; a scene whose ``Simulation``
    refuses it or whose run ends unhealthy gets ``{"error": ...}`` in its
    record.  Returns ``{cfg stem: record}``."""
    from particlerobotsimulations_torch import load_cfg

    csv_dir = Path(csv_dir)
    csv_dir.mkdir(parents=True, exist_ok=True)
    results = {}
    for cfg in cfgs:
        cfg = Path(cfg)
        params = load_cfg(str(cfg))
        csv = str(csv_dir / Path(params.csv_filename).name)
        try:
            rec = run_scene(params, device, max_time, csv)
        except (ValueError, RuntimeError) as e:
            rec = {"bots": params.n_cells, "backend": params.resolved_backend(device).name,
                   "error": f"{type(e).__name__}: {e}"}
            print(f"{cfg.stem}: FAILED {rec['error']}", flush=True)
        else:
            print(f"{cfg.stem}: {rec['bots']} bots, {rec['steps']} steps, "
                  f"{rec['wall_seconds']:.0f}s wall, dist {rec['dist_to_light_start']:.2f} -> "
                  f"{rec['dist_to_light_end']:.2f} [{rec['backend']}]", flush=True)
        results[cfg.stem] = rec
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=str(REPO / "docs" / "fullscale_results_torch.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    results = run_all(sorted((REPO / "examples").glob("*.cfg")), args.device)
    out = Path(args.out)
    out.write_text(json.dumps(results, indent=2) + "\n")
    print(f"wrote {out}")
    return 1 if any("error" in r for r in results.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
