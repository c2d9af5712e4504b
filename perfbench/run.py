"""Run one cell of the benchmark once, on the card this process finds.

    python3 -m perfbench.run --workload hex10k.scene --seed 7 --seconds 20 --trace 0

from the root of a checkout (``BENCHMARK.json`` beside ``perfbench/``).
With ``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, read from a device trace of the
window's last state stepped again, with the trace's breakdown.  Either
way the last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, [``breakdown``],
``checks``), and the last lines of standard error give each number that
decided ``correct`` beside its limit.

Without a CUDA card the run exits 2 and prints no result: nothing runs in
the card's place.  It exits 3 with no result where the process has loaded
JAX or the JAX package, which the benchmark never measures.
"""

from __future__ import annotations

import time

_T_SCRIPT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from .spec import ROOT, Bench  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "particlerobotsimulations_tpu")
# caches the program or its libraries write, each at a fixed path inside
# the checkout, so that only a checkout's first run builds
CACHE_ENV = {
    "TRITON_CACHE_DIR": "triton",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "CUDA_CACHE_PATH": "cuda_compute",
    "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels",
}
CACHE_ROOT = ROOT / ".perfbench_cache"


def process_age() -> float:
    """Seconds since this process started, from ``/proc`` (0 where it
    cannot be read): the part of set-up before the first line here."""
    try:
        with open("/proc/self/stat") as f:
            started_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - started_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def card() -> str:
    """The card's name and power limit, to stand beside the run's numbers
    (``nvidia-smi``'s query, as the port's ``utils/profiling.card``)."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def loaded_banned() -> list:
    """The modules of :data:`BANNED` this process holds, compared by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def main(argv=None) -> int:
    started = _T_SCRIPT - process_age()
    ap = argparse.ArgumentParser(prog="perfbench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = Bench()
    cell = bench.cell(args.workload)
    for var, sub in CACHE_ENV.items():
        os.environ[var] = str(CACHE_ROOT / sub)
        (CACHE_ROOT / sub).mkdir(parents=True, exist_ok=True)
    os.environ["USE_FLAX"] = "0"

    marks = {"script": _T_SCRIPT - started, "args": time.perf_counter() - started}
    import torch

    marks["import_torch"] = time.perf_counter() - started
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card: the benchmark measures an H100 and runs "
              "nothing in its place", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2

    marks["cuda_check"] = time.perf_counter() - started
    from .harness import run_cell

    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", started)
    info = result.pop("_info")
    info["setup_marks"] = {**marks, **info["setup_marks"]}
    banned = loaded_banned()
    if banned:
        print(f"perfbench: the process loaded {', '.join(banned)}: the benchmark "
              "measures the PyTorch port alone", file=sys.stderr)
        return 3
    info["card"] = card()
    print(f"perfbench: {args.workload} seed {args.seed}: {json.dumps(info)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
