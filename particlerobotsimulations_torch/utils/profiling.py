"""Throughput profiling helpers.

Port of ``particlerobotsimulations_tpu.utils.profiling``: steps/s and
particle-steps/s of a scenario on one device, and a table of them over
swarm sizes.  The reference has no timing code at all (SURVEY.md §5).

Timing on a card waits for the device with ``torch.cuda.synchronize`` on
the device of the result (:func:`sync`): a host clock read without it
measures only the enqueue.  On the CPU every op has finished when it
returns.
"""

from __future__ import annotations

import subprocess
import time
from dataclasses import dataclass

import torch

from ..config import Config, SimParams
from ..engine import make_run_chunk
from ..parallel.ring import _device
from ..sim import Simulation


def sync(x) -> None:
    """Wait until the device of ``x`` (a tensor, a ``SimState``, or a
    device) has finished its queued work; a no-op on the CPU."""
    device = _device(getattr(x, "device", x))
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card(device="cuda") -> str:
    """The name and power limit of every visible card as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (one
    card per line), to stand beside a measurement; ``"cpu"`` for the
    CPU."""
    if _device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


_OVERHEAD_CACHE: dict = {}


def measure_call_overhead(reps: int = 5, device="cuda") -> float:
    """Per-call dispatch + sync latency on ``device``, measured at run
    time: a tiny elementwise op and :func:`sync`, the minimum over
    ``reps``.  Cached per device (``"cuda"`` is the current card)."""
    device = _device(device)
    if device in _OVERHEAD_CACHE:
        return _OVERHEAD_CACHE[device]
    x = torch.zeros((8,), dtype=torch.float32, device=device)
    x = x + 1.0
    sync(x)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        x = x + 1.0
        sync(x)
        best = min(best, time.perf_counter() - t0)
    _OVERHEAD_CACHE[device] = best
    return best


@dataclass
class Throughput:
    steps_per_sec: float
    particle_steps_per_sec: float
    ms_per_step: float
    n_bots: int
    backend: str


def measure_throughput(
    params: SimParams, n_steps: int = 1000, reps: int = 3, device="cuda"
) -> Throughput:
    """Warm up, then time ``n_steps`` physics steps ``reps`` times on
    ``device``; returns the best of reps."""
    overhead = measure_call_overhead(device=device)
    sim = Simulation(params, device=device)
    # sim.params carries the Nx == 0 -> config_size_x resolution; timing
    # the raw params would run a different actuation wave.  Every chunk
    # enters at a multiple of n_steps, so when that lands on the gate
    # segment the table loop takes its seg-aligned path, as the bench does.
    params = sim.params
    seg = sim._gate_seg
    run = make_run_chunk(params, device)
    done = 0

    def chunk(state):
        nonlocal done
        aligned = seg > 0 and done % seg == 0
        state = run(state, n_steps, aligned)
        done += n_steps
        return state

    state = chunk(sim.state)
    sync(state)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        state = chunk(state)
        sync(state)
        elapsed = time.perf_counter() - t0
        # subtract the measured per-call latency, keeping at least half the
        # raw time so that a noisy reading cannot go negative
        best = min(best, max(elapsed - overhead, elapsed * 0.5))
    # the padding rows collapse onto the world corner: check the bots only
    if not torch.isfinite(state.pos[: params.n_cells]).all():
        raise RuntimeError("simulation diverged during profiling")
    sps = n_steps / best
    return Throughput(
        steps_per_sec=sps,
        particle_steps_per_sec=sps * params.n_cells,
        ms_per_step=1e3 / sps,
        n_bots=params.n_cells,
        backend=params.resolved_backend(device).name,
    )


def scaling_report(ns=(1000, 4000, 10000, 20000), device="cuda", n_steps: int = 1000,
                   reps: int = 3, **param_overrides):
    """Print a throughput table over swarm sizes (HEX blobs, light at
    (-20, 0)); ``n_steps`` and ``reps`` as :func:`measure_throughput`
    takes them."""
    rows = []
    for n in ns:
        params = SimParams(
            n_cells=n, n_dead=0, config=Config.HEX, light_x=-20.0,
            **param_overrides,
        )
        t = measure_throughput(params, n_steps, reps, device)
        rows.append(t)
        print(
            f"n={t.n_bots:>7}  {t.ms_per_step:8.3f} ms/step  "
            f"{t.particle_steps_per_sec / 1e6:8.2f} M particle-steps/s  "
            f"[{t.backend}]"
        )
    return rows
