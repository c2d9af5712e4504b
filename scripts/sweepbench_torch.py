"""Measure the sweep strategies' crossover on the PyTorch port.

Times ``run_sweep`` itself (the shipped path, including per-seed host
placement and centroid recording) for each strategy at each size, so the
numbers are the ones the rule in ``choose_sweep_strategy`` encodes.  The
port's copy of ``scripts/sweepbench.py``, with its arguments and printed
lines.

Usage: python scripts/sweepbench_torch.py [sizes_csv] [n_seeds] [steps] [strategies_csv] [--device cuda]
       python scripts/sweepbench_torch.py 300,1000,4000 8 6000
       python scripts/sweepbench_torch.py 300 32 30000 batched,packed
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("sizes", nargs="?", default="300,1000,4000")
    ap.add_argument("seeds", type=int, nargs="?", default=8)
    ap.add_argument("steps", type=int, nargs="?", default=30000)
    ap.add_argument("strategies", nargs="?", default="sequential,batched")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sizes = [int(x) for x in args.sizes.split(",")]
    strategies = tuple(args.strategies.split(","))

    from particlerobotsimulations_torch import Config, SimParams
    from particlerobotsimulations_torch.parallel.sweep import run_sweep
    from particlerobotsimulations_torch.utils.profiling import card, sync

    print(f"card: {card(args.device)}")
    for n in sizes:
        params = SimParams(
            n_cells=n, n_dead=0, seed=7, config=Config.HEX,
            light_x=-20.0, light_y=0.0,
        )
        seeds = list(range(args.seeds))
        row = {}
        for strat in strategies:
            # record cadence = the scenario dump interval, as in a real
            # `cli sweep` run; the warm call builds, the second is timed (it
            # still pays per-seed host placement, as every sweep does)
            run_sweep(params, seeds, args.steps, strategy=strat, device=args.device)
            t0 = time.perf_counter()
            state, cents = run_sweep(params, seeds, args.steps, strategy=strat,
                                     device=args.device)
            sync(state)
            dt = time.perf_counter() - t0
            if not np.isfinite(cents).all():
                raise RuntimeError(f"n={n} {strat}: non-finite centroids")
            row[strat] = n * args.steps * args.seeds / dt / 1e6
            print(
                f"n={n} {strat}: {dt:.2f} s -> {row[strat]:.1f} M "
                f"particle-steps/s aggregate", flush=True,
            )
        win = max(row, key=row.get)
        print(f"n={n} winner: {win} ({row[win]:.1f} vs "
              f"{min(row.values()):.1f} M)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
