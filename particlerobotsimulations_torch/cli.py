"""Command-line entry point of the PyTorch port.

    python -m particlerobotsimulations_torch.cli simulate examples/example.cfg --device cuda
    python -m particlerobotsimulations_torch.cli simulate cfg --video --checkpoint ck.npz --checkpoint-every 1
    python -m particlerobotsimulations_torch.cli simulate cfg --resume --checkpoint ck.npz --max-time 600
    python -m particlerobotsimulations_torch.cli sweep examples/example.cfg --seeds 0:8 --steps 6000
    python -m particlerobotsimulations_torch.cli sweep examples/example.cfg --seeds 0:8 --mesh
    python -m particlerobotsimulations_torch.cli experiment robustness examples/example_dead_cells.cfg
    python -m particlerobotsimulations_torch.cli bench

``simulate`` writes under the cfg's csv_filename and video_filename, like
the reference binary (main.cpp:913-917); ``sweep`` and ``experiment`` print the JAX
package's CSV to stdout; with ``--mesh`` they shard the seeds over every
visible card (``parallel/mesh.default_mesh``).  ``bench`` runs the
package's throughput bench (``bench.py``: 10k bots, the JAX package's
bench.py protocol) and prints its JSON line.
"""

from __future__ import annotations

import argparse
import sys
import time


def _add_overrides(p: argparse.ArgumentParser):
    p.add_argument("--max-time", type=float, default=None, help="override max_time")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--n-cells", type=int, default=None)
    p.add_argument("--backend", type=str, default=None,
                   help="force backend: auto|dense|cellgrid|stencil|pallas")
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
    import os

    from .config import load_cfg
    from .sim import Simulation

    params = _apply_overrides(load_cfg(args.cfg), args)
    resumed = False
    if args.resume:
        # reference 'cont' mode (main.cpp:886, 941-956): continue from the
        # checkpoint when there is one, else from the last complete CSV row
        if args.checkpoint and os.path.exists(args.checkpoint):
            from .io.checkpoint import load_checkpoint

            ck_params, ck_state = load_checkpoint(args.checkpoint, device=args.device)
            # CLI overrides (e.g. a later --max-time) apply on top of the
            # checkpoint's params; structural mismatches raise on shapes
            sim = Simulation(_apply_overrides(ck_params, args), state=ck_state,
                             device=args.device)
        elif os.path.exists(params.csv_filename):
            sim = Simulation.resume_from_csv(params, params.csv_filename,
                                             device=args.device)
        else:
            raise SystemExit(
                "error: --resume needs an existing checkpoint or CSV "
                f"({params.csv_filename})"
            )
        resumed = True
        print(f"resumed at t = {sim.time:g} s", file=sys.stderr)
    else:
        sim = Simulation(params, device=args.device)
    # the sim's params (a checkpoint's, or auto-fitted) describe the run:
    # the recorder, the CSV target and the summary use them
    params = sim.params
    start_steps = sim.state.step

    recorder = None
    frame_cb = None
    if args.video:
        from .render.video import VideoRecorder

        recorder = VideoRecorder(params, width=args.video_width,
                                 height=args.video_height,
                                 codec=args.video_codec,
                                 quality=args.video_quality,
                                 style=args.video_style)
        frame_cb = recorder.capture
        print(f"recording video -> {recorder.path}", file=sys.stderr)

    t0 = time.time()
    try:
        sim.run(
            csv_path=params.csv_filename,
            echo=not args.quiet,
            checkpoint_path=args.checkpoint,
            checkpoint_every_dumps=args.checkpoint_every,
            frame_callback=frame_cb,
            frame_every_steps=args.frame_every or None,
            append_csv=resumed,
        )
    finally:
        if recorder is not None:
            recorder.close()
    wall = time.time() - t0
    # the steps run in this call (a resume starts mid-run)
    steps = max(0, params.n_steps() - start_steps)
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


def _seeds(text: str) -> list:
    lo, hi = (int(x) for x in text.split(":"))
    return list(range(lo, hi))


def _mesh(args):
    """The mesh of ``--mesh``: every visible card of ``--device``'s kind
    (the one CPU for ``cpu``), or None."""
    from .parallel.mesh import default_mesh

    return default_mesh(device=args.device) if args.mesh else None


def cmd_sweep(args) -> int:
    from .config import load_cfg
    from .parallel.sweep import run_sweep, sweep_summary

    params = _apply_overrides(load_cfg(args.cfg), args)
    n_steps = args.steps or params.n_steps()
    _, cents = run_sweep(params, _seeds(args.seeds), n_steps, mesh=_mesh(args),
                         device=args.device)
    summary = sweep_summary(cents, params)
    print("time_s,distance_mean,distance_std,centroid_x,centroid_y")
    dump_dt = params.dump_steps * params.timestep
    for i in range(len(summary["distance_mean"])):
        print(
            f"{i * dump_dt:g},{summary['distance_mean'][i]:f},"
            f"{summary['distance_std'][i]:f},"
            f"{summary['centroid_mean'][i, 0]:f},{summary['centroid_mean'][i, 1]:f}"
        )
    return 0


def cmd_experiment(args) -> int:
    from .config import load_cfg
    from .models.experiments import (
        dead_cell_robustness,
        gap_transit,
        payload_transport,
        phototaxis_speed,
    )

    params = _apply_overrides(load_cfg(args.cfg), args)
    seeds = _seeds(args.seeds)
    dev, mesh = args.device, _mesh(args)

    if args.kind == "robustness":
        fracs = [float(f) for f in args.fractions.split(",")]
        out = dead_cell_robustness(params, fracs, seeds, args.sim_seconds, mesh=mesh,
                                   device=dev)
        print("dead_fraction,approach_speed_units_per_s")
        for f, v in zip(out["fractions"], out["approach_speed"]):
            print(f"{f:g},{v:.6f}")
    elif args.kind == "gap":
        out = gap_transit(params, seeds, args.sim_seconds, mesh=mesh, device=dev)
        print("seed,frac_past_wall")
        for s, v in zip(seeds, out["frac_past_wall"]):
            print(f"{s},{v:.4f}")
        print(f"# mean fraction past wall x={out['wall_x']:g}: "
              f"{out['frac_past_wall_mean']:.4f}")
    elif args.kind == "transport":
        out = payload_transport(params, seeds, args.sim_seconds, mesh=mesh, device=dev)
        print("seed,payload_dx,payload_dy")
        for s, d in zip(seeds, out["payload_displacement"]):
            print(f"{s},{d[0]:.6f},{d[1]:.6f}")
        print(f"# mean payload dx: {out['payload_mean_dx']:.6f}")
    else:
        out = phototaxis_speed(params, seeds, args.sim_seconds, mesh=mesh, device=dev)
        print("time_s,distance_mean,distance_std")
        for t, m, s in zip(out["time_s"], out["distance_mean"], out["distance_std"]):
            print(f"{t:g},{m:.6f},{s:.6f}")
        print(f"# approach speed: {out['approach_speed']:.6f} units/s")
    return 0


def cmd_bench(args) -> int:
    from .bench import main as bench_main

    return bench_main(["--device", args.device])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="particlerobotsimulations_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sim_p = sub.add_parser("simulate", help="run one scenario from a .cfg")
    sim_p.add_argument("cfg")
    sim_p.add_argument("--video", action="store_true", help="record AVI video")
    # reference default geometry: 1920x1080 @ 20 FPS (main.cpp:65,
    # postprocess.cu:102)
    sim_p.add_argument("--video-width", type=int, default=1920)
    sim_p.add_argument("--video-height", type=int, default=1080)
    sim_p.add_argument("--video-codec", choices=["MJPG", "DIB "], default="MJPG",
                       help="MJPG (compressed, default) or 'DIB ' (raw)")
    sim_p.add_argument("--video-quality", type=int, default=90,
                       help="JPEG quality 1-100 for MJPG")
    sim_p.add_argument("--video-style", choices=["2d", "3d"], default="2d",
                       help="top-down ortho (2d) or the reference's "
                            "perspective presentation look (3d)")
    sim_p.add_argument("--frame-every", type=int, default=0,
                       help="physics steps between frames "
                            "(default: cfg DISPLAY_INTERVAL)")
    sim_p.add_argument("--quiet", action="store_true")
    sim_p.add_argument("--resume", action="store_true",
                       help="continue from checkpoint/CSV (reference 'cont' mode)")
    sim_p.add_argument("--checkpoint", type=str, default=None)
    sim_p.add_argument("--checkpoint-every", type=int, default=0,
                       help="checkpoint every N dumps")
    _add_overrides(sim_p)
    sim_p.set_defaults(fn=cmd_simulate)

    sw_p = sub.add_parser("sweep", help="Monte-Carlo seed sweep")
    sw_p.add_argument("cfg")
    sw_p.add_argument("--seeds", type=str, default="0:8", help="lo:hi seed range")
    sw_p.add_argument("--steps", type=int, default=0)
    sw_p.add_argument("--mesh", action="store_true",
                      help="shard the seeds over every card of --device")
    _add_overrides(sw_p)
    sw_p.set_defaults(fn=cmd_sweep)

    ex_p = sub.add_parser(
        "experiment", help="canned paper experiments (robustness, transport)"
    )
    ex_p.add_argument("kind", choices=["robustness", "transport", "speed", "gap"])
    ex_p.add_argument("cfg")
    ex_p.add_argument("--seeds", type=str, default="0:8")
    ex_p.add_argument("--sim-seconds", type=float, default=600.0)
    ex_p.add_argument("--fractions", type=str, default="0,0.1,0.2,0.3",
                      help="dead-cell fractions (robustness)")
    ex_p.add_argument("--mesh", action="store_true",
                      help="shard the seeds over every card of --device")
    _add_overrides(ex_p)
    ex_p.set_defaults(fn=cmd_experiment)

    bench_p = sub.add_parser(
        "bench", help="throughput benchmark: particle-steps/s at 10k bots"
    )
    bench_p.add_argument("--device", type=str, default="cuda",
                         help="torch device to run on (default cuda)")
    bench_p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
