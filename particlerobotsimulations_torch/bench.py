"""Throughput benchmark of the port: particle-steps/s at 10k bots.

    python -m particlerobotsimulations_torch.bench [--device cuda]
    python -m particlerobotsimulations_torch.cli bench [--device cuda]

The JAX package's ``bench.py`` (at the repository root) on the port, with
its workload and protocol: 10,000 HEX bots, seed 7, light at (-20, 0);
60,000-step chunks, each entered on the 200-step gate segment; three
warm-up chunks when the scene runs the adaptive rebuild cadence (the
first probes the HEX relaxation transient and withholds K=8, the second
measures the steady state, the third runs the certified cadence), else
one; then the best of three timed chunks and a finite check on the bots'
positions.  With several visible cards it runs one scene per card (seeds
0, 1, ...) through the batched loop on its card, every card's chunk
enqueued block by block in turn (``chunk.interleave``), and counts
every scene.

Prints the card's name and power limit, a line on the warm-ups, and as its
last line ONE JSON object with bench.py's keys::

  {"metric": "particle_steps_per_sec_10k_bots_torch", "value": N,
   "unit": "particle-steps/s", "vs_baseline": null}

``vs_baseline`` is null: bench.py divides by its 1e8 target on a TPU,
which is no target for the port.  The bench measures a card: without CUDA
``--device cuda`` (the default) exits 1, and nothing runs in its place.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .config import Config, ForceBackend, SimParams
from .engine import make_run_chunk, make_run_chunk_batched
from .chunk import interleave
from .engine_table import gate_seg
from .parallel.mesh import default_mesh
from .parallel.sweep import make_batch_state, shard_batch
from .sim import Simulation
from .state import make_generator
from .utils.profiling import card, sync

METRIC = "particle_steps_per_sec_10k_bots_torch"
N_BOTS = 10_000
STEPS = 60_000  # a multiple of the 200-step gate segment
TIMED = 3


def bench_params(n_bots: int = N_BOTS) -> SimParams:
    return SimParams(
        n_cells=n_bots,
        n_dead=0,
        seed=7,
        config=Config.HEX,  # an instant, deterministic packed blob at any N
        light_x=-20.0,
        light_y=0.0,
    )


def build(device="cuda", n_bots: int = N_BOTS, mesh=None):
    """``(params, states, runs, batch)``: one state and chunk runner per
    place of ``mesh`` (default: every visible card of ``device``'s kind,
    ``parallel/mesh.default_mesh``).  One place: the workload's
    ``Simulation`` state and ``engine.make_run_chunk``.  Several: one scene
    per place, seeds 0 to B-1 (bench.py's), split by ``sweep.shard_batch``
    and run by ``engine.make_run_chunk_batched`` on its place."""
    params = bench_params(n_bots)
    if mesh is None:
        mesh = default_mesh(device=device)
    places = mesh.axis_devices("data")
    if len(places) == 1:
        sim = Simulation(params, device=places[0])
        return sim.params, [sim.state], [make_run_chunk(sim.params, places[0])], 1
    # a torch.Generator cannot change device: each scene's is made on the
    # place that shard_batch sends the scene to
    state = make_batch_state(params, list(range(len(places))), places[0],
                             draws=lambda s: make_generator(s, places[s]))
    runs = [make_run_chunk_batched(params, place) for place in places]
    return params, shard_batch(state, mesh), runs, len(places)


def run_bench(device="cuda", n_bots: int = N_BOTS, steps: int = STEPS, mesh=None) -> dict:
    """Run the bench's protocol on ``device`` (or ``mesh``) and print its
    lines; returns the JSON record.  ``n_bots`` and ``steps`` cut the
    workload for tests and smoke runs."""
    print(f"card: {card(device)}", flush=True)
    params, states, runs, batch = build(device, n_bots, mesh)
    backend = params.resolved_backend(states[0].device)
    seg = gate_seg(params) if backend == ForceBackend.PALLAS else 0
    aligned = seg > 0 and steps % seg == 0

    def chunk(states):
        # every place's chunk enqueued block by block, in turn, before any
        # place is waited for
        states = interleave([run.blocks(s, steps, aligned) for s, run in zip(states, runs)])
        for s in states:
            sync(s)
        return states

    adaptive = batch == 1 and runs[0].path_info.get("adaptive", False)
    warmups = 3 if adaptive else 1
    for _ in range(warmups):
        states = chunk(states)
    cadence = (
        f"live K {runs[0].live['k']} (last probe {runs[0].last_probe})"
        if adaptive else "fixed cadence"
    )
    print(f"warm-up: {warmups} chunks of {steps} steps, {batch} scene(s) of {n_bots} "
          f"bots on {backend.name}, {cadence}", flush=True)

    best = float("inf")
    for _ in range(TIMED):
        t0 = time.perf_counter()
        states = chunk(states)
        best = min(best, time.perf_counter() - t0)

    # the padding rows collapse onto the world corner: check the bots only
    for s in states:
        if not torch.isfinite(s.pos[..., : params.n_cells, :]).all():
            raise RuntimeError("simulation blew up during bench")
    value = n_bots * steps * batch / best
    record = {"metric": METRIC, "value": value, "unit": "particle-steps/s",
              "vs_baseline": None}
    print(json.dumps(record), flush=True)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="particlerobotsimulations_torch.bench",
                                 description="particle-steps/s at 10k bots (bench.py's protocol)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("error: the bench measures a CUDA card, and CUDA is not available",
              file=sys.stderr)
        return 1
    run_bench(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
