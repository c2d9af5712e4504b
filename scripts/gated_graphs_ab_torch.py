"""Wall time per step of the port's graphed loops, two checkouts in turns.

Runs each scene of each checkout's ``particlerobotsimulations_torch`` in
a process of its own (one scene's graphs do not share a process with
another's), the checkouts in turns (a, b, b, a for two roots), on the
same card, and prints one JSON line per checkout and turn with the wall
microseconds per step of:

* ``band_span``: the 1,000-bot band (bench.py's workload cut to 1,000
  bots, light (-5, 0)) through the table runner's span path,
  seg-aligned 400-step chunks;
* ``dense_b8``: eight seeds of ``examples/example.cfg`` (300 bots, DENSE)
  batched, 1,000-step chunks, per batched step;
* ``dense_500``: ``examples/example_obstacle.cfg`` (500 bots, DENSE),
  1,000-step chunks;
* ``adaptive_10k``: bench.py's 10k workload through ``make_run_chunk``
  (the adaptive runner: a probe segment, then K-step blocks), seg-aligned
  600-step chunks;
* ``sharded_10k``: the same workload on the sharded table loop over a
  ``LocalRing(4)`` of the card, 600-step chunks.

Each scene first runs 6,000 steps (every gate pattern of the default
centroid and phase intervals, 1,000 and 1,200 steps, is seen there, so
the graphs are captured), then 2,000 timed steps from step 6,000 (the
same patterns again), ended by ``torch.cuda.synchronize``, then one more
chunk under ``torch.profiler`` (the device alone traced): ``<scene>_dev``
is its device microseconds per step (kernel and copy time), and
``<scene>_acts`` its device activities per step.  The card's name and
power limit come first.  Needs CUDA; exits 1 without it.

    python scripts/gated_graphs_ab_torch.py PARENT_ROOT CHANGE_ROOT
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

WARM_STEPS, TIMED_STEPS = 6_000, 2_000


SCENES = ("band_span", "dense_b8", "dense_500", "adaptive_10k", "sharded_10k")


def measure(root: str, scene: str) -> dict:
    """One scene of one checkout, in this process: its wall, device time
    and device activities per step."""
    sys.path.insert(0, root)
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import particlerobotsimulations_torch as pt
    from particlerobotsimulations_torch import kernels
    from particlerobotsimulations_torch.engine import make_run_chunk, make_run_chunk_batched
    from particlerobotsimulations_torch.engine_table import make_run_chunk_table
    from particlerobotsimulations_torch.models.placement import resolve_params
    from particlerobotsimulations_torch.parallel.ring import LocalRing
    from particlerobotsimulations_torch.parallel.spatial_table import make_sharded_table_run
    from particlerobotsimulations_torch.parallel.sweep import make_batch_state

    kernels.build()

    def bench_params(**over):
        return pt.SimParams(n_cells=10_000, n_dead=0, seed=7, config=pt.Config.HEX,
                            light_x=-20.0, light_y=0.0).replace(**over)

    def cfg(name):
        return resolve_params(pt.load_cfg(os.path.join(root, "examples", name)).validate())

    def timed(run, state, chunk, aligned=None):
        def advance(st):
            return run(st, chunk) if aligned is None else run(st, chunk, aligned)

        for _ in range(WARM_STEPS // chunk):
            state = advance(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS // chunk):
            state = advance(state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6 / TIMED_STEPS
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state = advance(state)
            torch.cuda.synchronize()
        if not bool(torch.isfinite(state.pos).all()):
            raise RuntimeError("non-finite state")
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        return wall, sum(e.time_range.elapsed_us() for e in dev) / chunk, len(dev) / chunk

    pb = resolve_params(bench_params(n_cells=1000, light_x=-5.0).validate())
    pe, po = cfg("example.cfg"), cfg("example_obstacle.cfg")
    p10 = resolve_params(bench_params().validate())
    if scene == "sharded_10k":
        run, p4 = make_sharded_table_run(p10, LocalRing(4, "cuda"))
        args = (run, pt.Simulation(p4, device="cuda").state, 600, None)
    elif scene == "band_span":
        args = (make_run_chunk_table(pb), pt.Simulation(pb, device="cuda").state, 400, True)
    elif scene == "dense_b8":
        args = (make_run_chunk_batched(pe, "cuda"), make_batch_state(pe, list(range(8)), "cuda"),
                1000, False)
    elif scene == "dense_500":
        args = (make_run_chunk(po, "cuda"), pt.Simulation(po, device="cuda").state, 1000, False)
    else:
        args = (make_run_chunk(p10, "cuda"), pt.Simulation(p10, device="cuda").state, 600, True)
    wall, dev, acts = timed(*args)
    return {scene: wall, f"{scene}_dev": dev, f"{scene}_acts": acts}


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        print(json.dumps(measure(os.path.abspath(argv[1]), argv[2])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or not argv:
        print("gated_graphs_ab_torch: needs CUDA and at least one checkout root",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    roots = [os.path.abspath(r) for r in list(argv) + list(reversed(argv))]
    for root in roots:
        out = {"root": root}
        for scene in SCENES:
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root, scene],
                                 capture_output=True, text=True, cwd=root)
            if res.returncode:
                print(res.stdout + res.stderr, file=sys.stderr)
                return res.returncode
            out.update(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
