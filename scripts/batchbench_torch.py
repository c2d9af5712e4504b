"""Throughput probe for BATCHED scenes on one device, on the PyTorch port.

Usage: python scripts/batchbench_torch.py [n_bots] [batch] [steps_per_call] [n_calls] [--device cuda]

The port's copy of ``scripts/batchbench.py``, with its arguments and
printed lines: best of ``n_calls`` seg-aligned chunks over a lockstep
scene batch (seeds 3 to 3+B-1) built with ``parallel.sweep.
make_batch_state`` and run by ``engine.make_run_chunk_batched``, each call
waited for with ``utils.profiling.sync``.  The aggregate number is
B * N * steps / wall, comparable to a single scene's particle-steps/s.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_bots", type=int, nargs="?", default=10_000)
    ap.add_argument("batch", type=int, nargs="?", default=4)
    ap.add_argument("steps", type=int, nargs="?", default=6000)
    ap.add_argument("calls", type=int, nargs="?", default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n, b, steps, calls = args.n_bots, args.batch, args.steps, args.calls

    from particlerobotsimulations_torch import Config, SimParams
    from particlerobotsimulations_torch.engine import make_run_chunk_batched
    from particlerobotsimulations_torch.engine_table import gate_seg
    from particlerobotsimulations_torch.parallel.sweep import make_batch_state
    from particlerobotsimulations_torch.utils.profiling import card, sync

    params = SimParams(
        n_cells=n, n_dead=0, seed=7, config=Config.HEX,
        light_x=-20.0, light_y=0.0,
    )
    print(f"card: {card(args.device)}")
    state = make_batch_state(params, seeds=list(range(3, 3 + b)), device=args.device)
    run = make_run_chunk_batched(params, args.device)
    seg = gate_seg(params.validate())
    aligned = seg > 0 and steps % seg == 0
    print(f"B={b} x {n} bots; gate segment {seg}, aligned: {aligned}")

    t0 = time.perf_counter()
    state = run(state, steps, aligned)
    sync(state)
    print(f"warmup+compile: {time.perf_counter() - t0:.1f} s")

    best = float("inf")
    for i in range(calls):
        t0 = time.perf_counter()
        state = run(state, steps, aligned)
        sync(state)
        dt = time.perf_counter() - t0
        best = min(best, dt)
        print(
            f"call {i}: {dt * 1e3:.1f} ms -> {dt / steps / b * 1e6:.2f} "
            f"us/scene-step  ({b * n * steps / dt / 1e6:.1f}M aggregate)"
        )
    if not torch.isfinite(state.pos[:, : params.n_cells]).all():
        raise RuntimeError("a scene diverged")
    print(
        f"best: {best / steps / b * 1e6:.2f} us/scene-step = "
        f"{b * n * steps / best / 1e6:.1f}M aggregate particle-steps/s"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
