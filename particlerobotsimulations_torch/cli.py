"""Command-line entry point of the PyTorch port.

    python -m particlerobotsimulations_torch.cli simulate examples/example.cfg --device cuda

Only ``simulate`` is ported; the JAX package's other subcommands (sweep,
experiment, bench) print that they are not ported yet and exit 2.  Outputs
land under the cfg's csv_filename, like the reference binary
(main.cpp:913-917).
"""

from __future__ import annotations

import argparse
import sys
import time

NOT_PORTED = ("sweep", "experiment", "bench")


def _add_overrides(p: argparse.ArgumentParser):
    p.add_argument("--max-time", type=float, default=None, help="override max_time")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--n-cells", type=int, default=None)
    p.add_argument("--backend", type=str, default=None,
                   help="force backend: dense|pallas (stencil, cellgrid not ported)")
    p.add_argument("--csv", type=str, default=None, help="override csv_filename")
    p.add_argument("--testing", type=int, default=None,
                   help="1 = full per-bot CSV columns")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda)")


def _apply_overrides(params, args):
    from .config import ForceBackend

    over = {}
    if args.max_time is not None:
        over["max_time"] = args.max_time
    if args.seed is not None:
        over["seed"] = args.seed
    if args.n_cells is not None:
        over["n_cells"] = args.n_cells
    if args.backend is not None:
        try:
            over["force_backend"] = ForceBackend[args.backend.upper()]
        except KeyError:
            names = ", ".join(b.name.lower() for b in ForceBackend)
            raise SystemExit(
                f"error: unknown backend '{args.backend}' (choose from: {names})"
            )
    if args.csv is not None:
        over["csv_filename"] = args.csv
    if args.testing is not None:
        over["testing"] = args.testing
    return params.replace(**over) if over else params


def cmd_simulate(args) -> int:
    from .config import load_cfg
    from .sim import Simulation

    params = _apply_overrides(load_cfg(args.cfg), args)
    sim = Simulation(params, device=args.device)
    params = sim.params
    t0 = time.time()
    sim.run(csv_path=params.csv_filename, echo=not args.quiet)
    wall = time.time() - t0
    steps = params.n_steps()
    path = sim.backend.name
    if getattr(sim._run_chunk, "path_info", {}).get("use_mega"):
        path += " span path"
    print(
        f"simulated {steps * params.timestep:g} sim-s ({steps} steps, "
        f"{params.n_cells} bots, {path} on {sim.device}) in "
        f"{wall:.1f} s wall "
        f"({steps * params.n_cells / max(wall, 1e-9) / 1e6:.2f} M particle-steps/s)",
        file=sys.stderr,
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="particlerobotsimulations_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sim_p = sub.add_parser("simulate", help="run one scenario from a .cfg")
    sim_p.add_argument("cfg")
    sim_p.add_argument("--quiet", action="store_true")
    _add_overrides(sim_p)
    sim_p.set_defaults(fn=cmd_simulate)

    for name in NOT_PORTED:
        p = sub.add_parser(name, help="not ported yet")
        p.add_argument("rest", nargs=argparse.REMAINDER)
        p.set_defaults(fn=None)

    args = ap.parse_args(argv)
    if args.fn is None:
        print(
            f"error: '{args.cmd}' is not yet ported to PyTorch "
            "(see ROADMAP.md, queue 1)",
            file=sys.stderr,
        )
        return 2
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
