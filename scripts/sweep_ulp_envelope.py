"""One-ulp envelope of the seed sweep's scenes, on the card.

For each seed of ``chip_smoke.py`` phase 12's 10k and band sweeps, over
the same window and records: how far the bot-mean centroid moves (the
largest distance of a record from the first), and the one-ulp envelope,
the largest distance between the records of the scene's run and those of
a run whose initial coordinates were each moved one ulp in a random
direction, over RUNS such runs.  A fallback taken in one run and not in
another parts two runs of a scene as a rounding does, so a centroid bound
between a batched scene and its free sequential run is meaningful only
below both readings.

Usage: python scripts/sweep_ulp_envelope.py [runs]
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from particlerobotsimulations_torch import kernels  # noqa: E402
from particlerobotsimulations_torch.engine import make_run_chunk  # noqa: E402
from particlerobotsimulations_torch.engine_table import gate_seg  # noqa: E402
from particlerobotsimulations_torch.models.placement import resolve_params  # noqa: E402
from particlerobotsimulations_torch.parallel.sweep import make_batch_state  # noqa: E402
from particlerobotsimulations_torch.state import scene_state  # noqa: E402

RUNS = int(sys.argv[1]) if len(sys.argv) > 1 else 4


def records(params, state, n_steps, record_every) -> np.ndarray:
    """(n_records, 2) centroids of one scene's run, chunked and aligned as
    ``run_sweep`` runs it."""
    run = make_run_chunk(params, "cuda")
    n, seg = params.n_cells, cs.sweep_seg(params)
    recs, done = [state.pos[:n].mean(dim=0)], 0
    while done < n_steps:
        chunk = min(record_every, n_steps - done)
        state = run(state, chunk, seg > 0 and done % seg == 0)
        done += chunk
        recs.append(state.pos[:n].mean(dim=0))
    return torch.stack(recs).cpu().numpy()


def envelope(name, params, n_steps, record_every) -> None:
    params = resolve_params(params.validate())
    n = params.n_cells
    moves, envs = [], []
    for seed in cs.SWEEP_SEEDS:
        start = scene_state(make_batch_state(params, [seed], "cuda"), 0)
        want = records(params, start, n_steps, record_every)
        worst = 0.0
        for r in range(RUNS):
            state = scene_state(make_batch_state(params, [seed], "cuda"), 0)
            pos = state.pos.cpu().numpy()
            way = np.where(np.random.default_rng(1000 * seed + r).random(pos[:n].shape) < 0.5,
                           -np.inf, np.inf).astype(np.float32)
            pos[:n] = np.nextafter(pos[:n], way)
            got = records(params, state.replace(pos=torch.tensor(pos, device="cuda")),
                          n_steps, record_every)
            worst = max(worst, float(np.abs(got - want).max()))
        moves.append(float(np.abs(want - want[0]).max()))
        envs.append(worst)
    print(f"{name}: {len(cs.SWEEP_SEEDS)} seeds x {n_steps} steps of {n} bots, records every "
          f"{record_every}: centroid movement {min(moves):.3e}-{max(moves):.3e}, one-ulp "
          f"envelope ({RUNS} runs) {min(envs):.3e}-{max(envs):.3e}; per seed (movement, "
          f"envelope) {[(round(m, 6), round(e, 6)) for m, e in zip(moves, envs)]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_ulp_envelope: CUDA is not available", file=sys.stderr)
        return 1
    kernels.build()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    envelope("10k HEX", cs.bench_params(), 200, 100)
    pb = resolve_params(cs.band_params().validate())
    envelope("band", pb, 2 * gate_seg(pb), 2 * gate_seg(pb))
    return 0


if __name__ == "__main__":
    sys.exit(main())
