"""The readings that the limits on ``correct`` are set from, for one cell
over many seeds in one process:

    python3 -m perfbench.control --workload hex10k.scene --seeds 11:23 --seconds 3

For each seed it makes a short run of the cell (its set-up and chunks at
full size, a window of ``--seconds``) and prints one JSON line: the
program's widest gap of each compared number against the float32
reference (the lower reading), and the control's, the reference computed
in bfloat16 put in the program's place (the upper reading); and, as a
witness of what rounding alone does, the float32 reference's and the
program's gaps against the reference computed in float64.  The
benchmark's own runs never run the control.  Needs a card, as ``run.py``
does.
"""

from __future__ import annotations

import argparse
import json
import sys

from .spec import Bench


def seeds_of(text: str) -> list:
    if ":" in text:
        a, b = text.split(":")
        return list(range(int(a), int(b)))
    return [int(s) for s in text.split(",")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="a:b (a to b-1) or a,b,c")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=1, help="0: the program's readings alone")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA card", file=sys.stderr)
        return 2
    from .harness import run_cell

    bench = Bench()
    for seed in seeds_of(args.seeds):
        r = run_cell(bench, args.workload, seed, args.seconds, False, "cuda",
                     with_control=bool(args.control))
        info = r["_info"]
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "program": info["numbers"],
                          "pieces": info["pieces"],
                          "piece_vel_gap": [x["vel_gap"] for x in info["readings"]],
                          "piece_bots_off": [x["bots_off"] for x in info["readings"]],
                          "control": info["control"], "witness": info["witness"],
                          "live_k": info["live_k"],
                          "rebuilds": info["rebuilds"], "span_segments": info["span_segments"],
                          "redos": info["redos"], "setup_marks": info["setup_marks"],
                          "metrics": {k: m["value"] for k, m in r["metrics"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
