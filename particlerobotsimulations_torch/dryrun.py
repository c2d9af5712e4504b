"""The multi-device dry run: every split strategy of the port checked on a mesh.

    python -m particlerobotsimulations_torch.dryrun 8            # on the card
    python -m particlerobotsimulations_torch.dryrun 4 --device cpu

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:
each strategy runs a 1,024-bot HEX scene (the flagship phototaxis scene,
light at (-5, 0)) for 10 steps with shortened gates (two slot-rebuild
windows, phase updates at steps 0 and 6, centroid gates at 0, 4 and 8) and
must match its unsplit reference to float32-reassociation tolerance
(positions 1e-5, velocities 1e-4):

1. data parallel: the scene batch over a ``("data",)`` mesh
   (``parallel/sweep.shard_batch``, the batched loop per place); scene 0
   against the single-scene run;
2. tensor parallel: the bot axis over ``LocalRing(n)`` (``parallel/
   spatial.make_sharded_step``) against ``engine.make_step`` on DENSE, the
   split's own pair law (AUTO would take kernel 1's per-bot collide on a
   card, whose pair law rounds differently);
3. dp x tp on the dense split: an ``(n/2, 2)`` mesh, each data place's
   scenes on a ``LocalRing(2)``; scene 0 against ``engine.make_step`` on
   DENSE;
4. the sharded table loop (``parallel/spatial_table``: grid rows over
   ``LocalRing(n)``, kernel 4 and kernel 2's padded form) against the
   single-table loop;
5. dp x tp on the table loop (``make_sharded_table_run_batched`` on an
   ``(n/2, 2)`` mesh); scene 0 against the single-table loop;
6. the sharded table loop with the exact global fallback forced: 64 bots at
   50 u/s, ``fallbacks >= 1`` from the run's own counter (velocities held
   to 1e-3: the bulk motion amplifies the summation-order seeds);
7. the sharded table loop with its overflow-spill rows in use: 600 bots at
   ``cell_capacity 8`` + ``overflow_slots 8``, ``spill_rows_max > 0``;
8. the megakernel span path (G=16) against the regular table path on the
   same scene, through the runner's ``seg_aligned`` flag; the span path
   must have run (``path_info["use_mega"]``, no redo).

Places repeat ``device``: a virtual mesh of ``n`` places on one card or
the CPU, as the JAX package's tests use virtual CPU devices.  On a card,
strategies 1 and 4-8 run kernels 1-4.  Phase noise is off (``phase_std
0``) as in the JAX dry run, and positions are jittered off the HEX
lattice's exact tangencies.  Strategy 8 takes centroid and phase
intervals of 0.08 and 0.16 s: the port's span path runs whole gate
segments (``engine_table.gate_seg``), and the shortened gates' segment (2
steps) is shorter than a rebuild window.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .config import Config, ForceBackend, SimParams
from .engine import make_run_chunk, make_run_chunk_batched, make_step
from .engine_table import make_run_chunk_table
from .ops.megakernel import mega_eligible
from .parallel.mesh import Mesh
from .parallel.ring import LocalRing
from .parallel.spatial import gather_state, make_sharded_step, shard_state
from .parallel.spatial_table import make_sharded_table_run, make_sharded_table_run_batched
from .parallel.sweep import gather_batch, make_batch_state, shard_batch
from .sim import Simulation
from .state import active_mask, scene_state

N_STEPS = 10


def flagship_params(n_cells: int = 1024) -> SimParams:
    """The JAX dry run's scene: HEX phototaxis toward (-5, 0), no dead
    cells, AUTO backend, with its shortened gates and no phase noise."""
    return SimParams(
        n_cells=n_cells, n_dead=0, seed=1234, config=Config.HEX,
        force_backend=ForceBackend.AUTO, light_x=-5.0, light_y=0.0,
        phase_update_interval=0.06, centroid_int=0.04, phase_std=0.0,
    )


def _jitter(state, seed: int = 99):
    """Positions moved by 1e-4 normal noise (numpy, from ``seed``)."""
    noise = 1e-4 * np.random.default_rng(seed).standard_normal(tuple(state.pos.shape))
    return state.replace(pos=state.pos + torch.tensor(noise, dtype=torch.float32,
                                                      device=state.device))


def _check(name, got, want, atol_pos=1e-5, atol_vel=1e-4) -> str:
    gp, wp = got.pos.cpu().numpy(), want.pos.cpu().numpy()
    gv, wv = got.vel.cpu().numpy(), want.vel.cpu().numpy()
    if gp.shape != wp.shape:
        raise AssertionError(f"{name}: shapes {gp.shape} and {wp.shape}")
    dp, dv = float(np.abs(gp - wp).max()), float(np.abs(gv - wv).max())
    if not (np.isfinite(gp).all() and dp <= atol_pos):
        raise AssertionError(f"{name}: split/unsplit position mismatch {dp:.2e}")
    if dv > atol_vel:
        raise AssertionError(f"{name}: split/unsplit velocity mismatch {dv:.2e}")
    return f"{name} |dpos|<={dp:.1e}"


def _steps(step, state, n):
    for _ in range(n):
        state = step(state)
    return state


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """Run the eight certifications on a mesh of ``n_devices`` places on
    ``device``; prints one summary line and returns the per-strategy
    results.  Any mismatch raises AssertionError."""
    if n_devices < 2:
        raise ValueError(f"a dry run needs at least 2 places, got {n_devices}")
    params = flagship_params()
    n = N_STEPS
    results = []

    # 1. data parallel: the scene batch over the mesh
    mesh_dp = Mesh([device] * n_devices, ("data",))
    batch = _jitter(make_batch_state(params, list(range(n_devices)), device))
    run_b = make_run_chunk_batched(params, device)
    out = gather_batch([run_b(g, n) for g in shard_batch(batch, mesh_dp)])
    ref = make_run_chunk(params, device)(scene_state(batch, 0), n)
    results.append(_check("dp", scene_state(out, 0), ref))

    # 2. tensor parallel: the bot axis over a ring
    ring = LocalRing(n_devices, device)
    st0 = _jitter(Simulation(params, device=device).state)
    st = _steps(make_sharded_step(params, ring), shard_state(st0, ring), n)
    step_ref = make_step(params.replace(force_backend=ForceBackend.DENSE), device)
    results.append(_check("tp", gather_state(st, ring), _steps(step_ref, st0, n)))

    half = n_devices // 2
    even = n_devices >= 4 and n_devices % 2 == 0
    if even:
        mesh_2d = Mesh(np.full((half, 2), device, dtype=object), ("data", "bots"))

    # 3. dp x tp on the dense split: each data place's scenes on its ring
    if even:
        batch = _jitter(make_batch_state(params, list(range(half)), device))
        outs = []
        for g, dev in zip(shard_batch(batch, mesh_2d), mesh_2d.axis_devices("data")):
            r2 = LocalRing(2, dev)
            g = _steps(make_sharded_step(params, r2, batch=True), shard_state(g, r2, batch=True), n)
            outs.append(gather_state(g, r2, batch=True))
        ref = _steps(step_ref, scene_state(batch, 0), n)
        results.append(_check(f"dp x tp dense ({half}, 2)", scene_state(gather_batch(outs), 0), ref))

    # 4. the sharded table loop: grid rows over the ring
    run_tab, p_tab = make_sharded_table_run(params, ring)
    st0 = _jitter(Simulation(p_tab, device=device).state)
    results.append(_check("sharded table", run_tab(st0, n),
                          make_run_chunk_table(p_tab)(st0, n)))

    # 5. dp x tp on the table loop
    if even:
        run_2t, p_2t = make_sharded_table_run_batched(params, mesh=mesh_2d)
        batch = _jitter(make_batch_state(p_2t, list(range(half)), device))
        out = run_2t(batch, n)
        ref = make_run_chunk_table(p_2t)(scene_state(batch, 0), n)
        results.append(_check(f"dp x tp table ({half}, 2)", scene_state(out, 0), ref))

    # 6. the sharded table loop, exact global fallback forced (50 u/s bulk
    #    motion: more than a cell per rebuild window)
    run_fb, p_fb = make_sharded_table_run(params.replace(n_cells=64), ring, with_stats=True)
    st0 = Simulation(p_fb, device=device).state
    mask = active_mask(p_fb, st0.n_pad, device)[:, None]
    st0 = st0.replace(vel=torch.where(mask, torch.tensor([50.0, 0.0], device=device),
                                      torch.zeros((), device=device)))
    out, stats = run_fb(st0, n)
    if stats["fallbacks"] < 1:
        raise AssertionError(
            "forced-fallback certification never took the exact global fallback: "
            f"the run's counter shows {stats}"
        )
    results.append(_check("sharded table exact-fallback", out,
                          make_run_chunk_table(p_fb)(st0, n), atol_vel=1e-3)
                   + f" [fallbacks fired: {stats['fallbacks']}]")

    # 7. the sharded table loop with the overflow-spill rows in use
    run_sp, p_sp = make_sharded_table_run(
        params.replace(n_cells=600, cell_capacity=8, overflow_slots=8, light_x=-10.0),
        ring, with_stats=True)
    if p_sp.storage_capacity() != 16:
        raise AssertionError(f"spill scene: storage capacity {p_sp.storage_capacity()}")
    st0 = _jitter(Simulation(p_sp, device=device).state)
    mask = active_mask(p_sp, st0.n_pad, device)[:, None]
    st0 = st0.replace(vel=torch.where(mask, torch.tensor([0.0, 2.0], device=device),
                                      torch.zeros((), device=device)))
    out, stats = run_sp(st0, n)
    if stats["spill_rows_max"] <= 0:
        raise AssertionError(
            f"overflow-spill certification ran with empty spill rows: {stats}"
        )
    results.append(_check("sharded table overflow-spill", out,
                          make_run_chunk_table(p_sp)(st0, n))
                   + f" [peak occupied spill rows: {stats['spill_rows_max']}]")

    # 8. the megakernel span path against the regular table path (G=16)
    p_mega = params.replace(force_backend=ForceBackend.PALLAS, centroid_int=0.08,
                            phase_update_interval=0.16).validate()
    if p_mega.resolved_grid_dim() != 16 or not mega_eligible(p_mega):
        raise AssertionError("the 1024-bot G=16 table must be megakernel-eligible")
    run_mega = make_run_chunk_table(p_mega)
    info = run_mega.path_info
    if not (info["use_mega"] and info["gate_seg"] <= n
            and info["gate_seg"] // info["slot_rebuild_steps"] > 1):
        raise AssertionError(f"the span path would not run: {info}")
    st0 = _jitter(Simulation(p_mega, device=device).state)
    out_mega = run_mega(st0, n, True)
    if run_mega.redos:
        raise AssertionError(f"the span path redid {run_mega.redos} segments")
    out_reg = run_mega(st0, n, False)
    results.append(_check("megakernel span vs regular table path", out_mega, out_reg)
                   + f" [use_mega True, gate segment {info['gate_seg']} steps, no redo]")

    print(
        f"dryrun_multichip OK over {n_devices} places on {device}: 1024 bots x {n} "
        "steps (2 rebuild windows, 2 phase + 3 cog gates) per strategy, plus "
        "exact-fallback (64 bots, forced every window, in-run counter), "
        "overflow-spill (600 bots, 8+8 slots, in-run occupancy counter) and "
        "megakernel-path (G=16, seg_aligned A/B) certifications — " + "; ".join(results)
    )
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="particlerobotsimulations_torch.dryrun")
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    dryrun_multichip(args.n_devices, args.device)
    print(f"dry run took {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
