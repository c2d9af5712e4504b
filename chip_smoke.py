#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's two main paths — ``Simulation`` on bench.py's workload
(10k HEX bots, light at (-20, 0), seed 7) through the adaptive
table-resident loop, and the same workload cut to 1000 bots (light at
(-5, 0)) through the megakernel span path, where AUTO puts it on the card
— and checks that they went through the hand-written kernels:

1. require CUDA and print the card's name and power limit;
2. build the kernels from ``particlerobotsimulations_torch/csrc``;
3. hold kernels 1 and 2 against their plain PyTorch twins on the card, at
   the 10k path's shapes (after 200 steps, G=48) and on a synthetic table
   whose rows move by every offset with one cell overflowing; also hold a
   short 300-bot table-loop run on the card against the same run on the
   CPU twins;
4. run the 10k path for 3 chunks of 1000 steps with the launch counters
   reset just before, and check finite state, health, the adaptive
   cadence, the counters and the particle-steps/s of the last chunk, then
   profile 200 more steps for the device busy share;
5. run the CLI on ``examples/example.cfg`` (300 bots, PALLAS: the span
   path) and check its CSV;
6. hold kernel 3 against its twin on the card, one span from a mid-step
   state of four scenes (the 1000 HEX bots, the gap scene's walls, the
   obstacle scene, the object-transport scene; each after 200 steps), and
   hold a 256-bot, 8-step-segment span schedule on the card against the
   same run on the CPU twins;
7. run the 1000-bot path for 120 sim-s (12,000 steps, 60 segments) with
   the counters reset just before, and check the span path, finite state,
   health, the CSV and the launch counts against the reported redos;
8. A/B on that scene: 6,000 steps on the span path and 6,000 on the
   regular path from one state, the span path's device busy share under
   ``torch.profiler``; DENSE against the span path on
   ``examples/example_obstacle.cfg`` (500 bots); and the gap scene on the
   regular loop at the table its layout needs.

Any failure raises and exits non-zero.  The last two lines are the
kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import particlerobotsimulations_torch as pt
from particlerobotsimulations_torch import kernels
from particlerobotsimulations_torch.engine_table import (
    MOVE_FIELDS,
    TABLE_FIELDS,
    _gates,
    _make_mega_glue,
    enter_table,
    make_run_chunk_table,
    make_table_step,
    make_table_step_parts,
)
from particlerobotsimulations_torch.ops.megakernel import mega_span_plain
from particlerobotsimulations_torch.ops.pallas_stencil import (
    pair_constants,
    stencil_forces_plain,
)
from particlerobotsimulations_torch.ops.table_rebuild import (
    compact_plain,
    rebuild_move_planes,
)
from particlerobotsimulations_torch.state import state_from_arrays, state_to_arrays

ROOT = os.path.dirname(os.path.abspath(__file__))

# kernel 1 tolerance.  Both versions sum the same pair terms in another
# order (the kernel serially per candidate, the twin per neighbour block;
# the library is built without FMA contraction).  fa and fr are sums of
# non-negative terms: relative error K1_RTOL.  fx and fy are sums of
# terms that cancel, so their rounding error scales with the magnitudes
# summed, which are exactly fa + fr: K1_SUM_RTOL * (fa + fr) on top.
K1_ATOL, K1_RTOL, K1_SUM_RTOL = 1e-4, 1e-5, 1e-5
SMALL_POS_ATOL, SMALL_VEL_ATOL = 1e-5, 1e-4
# kernel 3 tolerance, per span of K steps.  px, py and rad: K3_POS_ATOL.
# aa and ar (kernel 1's fa and fr at the span's last post) and vx, vy:
# kernel 1's form, plus what the position differences cost.  After the
# first step the two versions' positions differ by ulps (pair sums in
# another order), and a position difference dpos moves a pair's gap by up
# to 2 dpos, which the magnet ramp turns into ramp_slope * 2 dpos of force
# (~1e4 x).  A disk has at most K3_NEIGHBOURS such pairs; the velocities
# take that force slack times dt.
K3_POS_ATOL = 1e-5
K3_NEIGHBOURS = 6

# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): float32
# outside the tensor cores, and HBM3
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
# operations every occupied candidate pair needs in pair_math.cuh before
# its branch: dx, dy, d2 (4), sqrt, divide, dist, nx, ny, cd, two compares
PAIR_OPS = 14
# elementwise operations per row and step in kernel 3 without obstacles
# (friction ~25, radius law ~30, integrate ~12), and per obstacle
ROW_OPS, OBSTACLE_OPS = 67, 30


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def median_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device time of one call of ``fn`` in ms: CUDA events around
    ``launches`` back-to-back calls, divided by the count; the median of
    ``reps`` such runs, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def bench_params():
    return pt.SimParams(
        n_cells=10_000, n_dead=0, seed=7, config=pt.Config.HEX,
        light_x=-20.0, light_y=0.0,
    )


def main_path_tables(params, n_steps: int = 200):
    """(kernel-1 tables, kernel-2 planes) of the 10k scene after
    ``n_steps`` of the main path, the planes after 7 steps without a
    rebuild so that the compaction sees real movers."""
    sim = pt.Simulation(params, device="cuda")
    sim.step_chunk(n_steps, start_step=0)
    p = sim.params.validate()
    g, cap, cs = p.resolved_grid_dim(), p.cell_capacity, p.storage_capacity()
    gg = g * g
    ts = enter_table(p, sim.state)
    tables = {
        k: ts.fields[k][: cap * gg].view(cap, gg)
        for k in ("px", "py", "vx", "vy", "rad", "afac")
    }
    step = make_table_step(p)
    for _ in range(7):
        ts = step(ts, False, False, False, False)
    planes = torch.stack(
        [ts.fields[k][: cs * gg] for k in MOVE_FIELDS]
    ).reshape(len(MOVE_FIELDS), cs, gg)
    dxf, dyf, _, _ = rebuild_move_planes(p, planes, MOVE_FIELDS, ts.origin)
    stacked = torch.cat([planes, dxf[None], dyf[None]], dim=0).contiguous()
    return p, tables, stacked


def synthetic_planes():
    """A G=16 table whose rows move by every one of the 8 offsets (and
    stay), with every row around lane (8, 8) moving into it so that one
    cell overflows."""
    p = pt.SimParams(n_cells=1000, n_dead=0, grid_dim=16).validate()
    g, cs = p.resolved_grid_dim(), p.storage_capacity()
    gg = g * g
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    nf = 9
    data = torch.randn((nf, cs, gg), generator=gen, device="cuda")
    occ = torch.rand((cs, gg), generator=gen, device="cuda") < 0.6
    move = torch.randint(-1, 2, (2, cs, gg), generator=gen, device="cuda").float()
    target = 8 * g + 8
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            src = target + oy * g + ox
            occ[:, src] = True
            move[0, :, src] = -ox
            move[1, :, src] = -oy
    far = torch.full_like(move[0], 99.0)
    dx = torch.where(occ, move[0], far)
    dy = torch.where(occ, move[1], far)
    data[5] = occ.float()  # the val plane
    return p, torch.cat([data, dx[None], dy[None]], dim=0).contiguous()


def compare_stencil(p, tables):
    got = kernels.stencil_forces_cuda(p, tables)
    want = stencil_forces_plain(p, tables)
    torch.cuda.synchronize()
    summed = want[2] + want[3]  # fa + fr: the magnitudes fx, fy sum
    err = 0.0
    for i, (name, a, b) in enumerate(zip(("fx", "fy", "fa", "fr"), got, want)):
        if not torch.isfinite(a).all():
            fail(f"stencil_forces: non-finite {name}")
        d = (a - b).abs()
        err = max(err, float(d.max()))
        tol = K1_ATOL + K1_RTOL * b.abs()
        if i < 2:
            tol = tol + K1_SUM_RTOL * summed
        bad = d > tol
        if bad.any():
            j = int(torch.argmax(d / tol))
            fail(
                f"stencil_forces {name}: {int(bad.sum())} entries beyond "
                f"tolerance; worst |diff| {float(d.view(-1)[j])} at "
                f"|ref| {float(b.view(-1)[j])}, fa+fr {float(summed.view(-1)[j])}"
            )
    return err


def compare_compact(p, planes):
    """(overflow flag, max |diff|) of kernel 2 against its twin; any
    difference fails."""
    out_k, inc_k = kernels.compact_cuda(p, planes)
    out_p, inc_p = compact_plain(p, planes)
    torch.cuda.synchronize()
    err = max(float((out_k - out_p).abs().max()), float((inc_k - inc_p).abs().max()))
    if not (torch.equal(inc_k, inc_p) and bool((out_k == out_p).all())):
        fail(f"compact differs from its twin (max |diff| {err})")
    cap = p.storage_capacity()
    over_k, over_p = bool((inc_k > cap).any()), bool((inc_p > cap).any())
    if over_k != over_p:
        fail("compact: overflow flag differs from its twin")
    return over_k, err


def small_run_check():
    """300 bots, PALLAS table loop, K=4, 12 steps: the card (kernels)
    against the CPU (plain twins) from the same jittered state."""
    p = pt.SimParams(
        n_cells=300, n_dead=0, seed=3, config=pt.Config.HEX,
        force_backend=pt.ForceBackend.PALLAS, phase_std=0.0,
        light_x=-5.0, slot_rebuild_steps=4,
    )
    arrays = state_to_arrays(pt.Simulation(p, device="cpu").state)
    rng = np.random.default_rng(99)
    arrays["pos"] = arrays["pos"] + (
        1e-4 * rng.standard_normal(arrays["pos"].shape)
    ).astype(np.float32)
    run = make_run_chunk_table(p)
    out_c = state_to_arrays(run(state_from_arrays(p, arrays, "cuda"), 12))
    out_h = state_to_arrays(run(state_from_arrays(p, arrays, "cpu"), 12))
    dpos = float(np.abs(out_c["pos"] - out_h["pos"]).max())
    dvel = float(np.abs(out_c["vel"] - out_h["vel"]).max())
    if not (dpos <= SMALL_POS_ATOL and dvel <= SMALL_VEL_ATOL):
        fail(f"300-bot table loop: card vs CPU dpos={dpos} dvel={dvel}")
    return dpos, dvel


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes over the card's memory
    rate and the operations over its float32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def occupied_pairs(p, rad: torch.Tensor) -> int:
    """Ordered pairs of occupied rows in each other's 3x3 cells (exact
    2-D wrap): the candidates kernels 1 and 3 evaluate for this table."""
    g = p.resolved_grid_dim()
    n = (rad > 0).sum(dim=0).reshape(g, g).to(torch.int64)
    around = sum(
        torch.roll(n, (-dy, -dx), dims=(0, 1))
        for dy in (-1, 0, 1) for dx in (-1, 0, 1)
    )
    return int((n * around).sum() - n.sum())


def stencil_bound(p, tables) -> tuple:
    n_in = 6 if p.has_payload else 5
    rows = tables["px"].numel()
    return bound((n_in + 4) * rows * 4, PAIR_OPS * occupied_pairs(p, tables["rad"]))


def compact_bound(planes) -> tuple:
    nfp, cs, gg = planes.shape
    # read every plane once, write nf planes and the per-lane count; the
    # work is compares and copies, far below the float32 rate
    return bound((nfp + nfp - 2) * cs * gg * 4 + gg * 4, 9 * cs * gg)


def span_bound(p, tbl, strip) -> tuple:
    k = max(1, p.resolved_slot_rebuild_steps())
    rows = tbl[0].numel() + strip[0].numel()
    n_obs = len(p.rect_obstacles) + len(p.circle_obstacles)
    ops = k * (
        PAIR_OPS * occupied_pairs(p, tbl[TABLE_FIELDS.index("rad")])
        + rows * (ROW_OPS + OBSTACLE_OPS * n_obs)
    )
    return bound(2 * (tbl.numel() + strip.numel()) * 4, ops)


def span_inputs(sim):
    """(params, tbl, strip, first step) of a mid-step state of ``sim``:
    entry, then the gated pre of its current step."""
    p = sim.params.validate()
    ts = enter_table(p, sim.state)
    step_pre, _ = make_table_step_parts(p)
    ts = step_pre(ts, *_gates(p, ts.step))
    tbl, strip = _make_mega_glue(p)[0](ts.fields)
    return p, tbl, strip, ts.step + 1


def ramp_slope(p) -> float:
    """Largest slope of the magnet ramp, force per unit of gap, over the
    scene's attraction factors."""
    (_, _, _, _, attr, _, _, mina, inv_i2_sq, inv_span) = pair_constants(p)
    if p.has_payload:
        attr *= max(1.0, p.attraction_factor) ** 2
    return abs(attr * inv_i2_sq - mina) * inv_span


def compare_span(name, p, tbl, strip, first):
    """max |diff| of kernel 3 against its twin on one span; fails beyond
    the tolerance (K3_* above)."""
    got = kernels.mega_span_cuda(p, tbl, strip, first, *kernels.obstacle_buffers(p, tbl.device))
    want = mega_span_plain(p, tbl, strip, first)
    torch.cuda.synchronize()
    ix = {f: j for j, f in enumerate(TABLE_FIELDS)}
    dpos = max(
        float((a[ix[f]] - b[ix[f]]).abs().max())
        for a, b in zip(got, want) for f in ("px", "py")
    )
    slack = K3_NEIGHBOURS * ramp_slope(p) * 2 * dpos
    err = 0.0
    for a, b in zip(got, want):
        if not torch.isfinite(a).all():
            fail(f"mega_span {name}: non-finite output")
        summed = b[ix["aa"]] + b[ix["ar"]]
        for field, j in ix.items():
            d = (a[j] - b[j]).abs()
            err = max(err, float(d.max()))
            if field in ("aa", "ar"):
                tol = K1_ATOL + K1_RTOL * b[j].abs() + slack
            elif field in ("vx", "vy"):
                tol = (K1_ATOL + K1_RTOL * b[j].abs() + K1_SUM_RTOL * summed
                       + slack * p.timestep)
            elif field in ("px", "py", "rad"):
                tol = torch.full_like(d, K3_POS_ATOL)
            else:
                tol = torch.zeros_like(d)
            bad = d > tol
            if bad.any():
                i = int(torch.argmax(d - tol))
                fail(
                    f"mega_span {name} {field}: {int(bad.sum())} entries beyond "
                    f"tolerance; worst |diff| {float(d.view(-1)[i])} at |ref| "
                    f"{float(b[j].view(-1)[i])} (dpos {dpos})"
                )
    return err, dpos


def band_params():
    """The slice's main path: bench.py's workload cut to 1000 bots, with the
    examples' light at (-5, 0); AUTO takes the span path on the card (G=16,
    4096 table rows), and the swarm stays within the table's 12 usable
    cells over 120 sim-s."""
    return bench_params().replace(n_cells=1000, light_x=-5.0)


def span_scenes():
    """The four scenes of phase 6, each after 200 steps on the card: the
    main path's 1000 HEX bots; the gap scene's walls (rectangles) with a
    HEX layout, since its RANDOM layout spans 14 cells and no G=16 table
    holds it; the obstacle scene (circles) and the transport scene
    (payload) at PALLAS."""
    def cfg(name, **over):
        return pt.Simulation.from_cfg(
            os.path.join(ROOT, "examples", name), device="cuda", **over
        )

    scenes = {
        "hex1000": pt.Simulation(band_params(), device="cuda"),
        "gap_walls": cfg("example_gap.cfg", config=pt.Config.HEX),
        "obstacle": cfg("example_obstacle.cfg", force_backend=pt.ForceBackend.PALLAS),
        "transport": cfg("example_object_transport.cfg", force_backend=pt.ForceBackend.PALLAS),
    }
    for name, sim in scenes.items():
        if not sim._run_chunk.path_info.get("use_mega"):
            fail(f"scene {name} is not on the span path")
        sim.step_chunk(200, start_step=0)
    return scenes


def schedule_check():
    """256 bots, 8-step segments (one gated block and one span each), 24
    seg-aligned steps: the card (kernels) against the CPU (plain twins)
    from the same jittered state."""
    p = pt.SimParams(
        n_cells=256, n_dead=0, seed=3, config=pt.Config.HEX,
        force_backend=pt.ForceBackend.PALLAS, phase_std=0.0,
        light_x=-5.0, centroid_int=0.08, phase_update_interval=0.16,
    )
    arrays = state_to_arrays(pt.Simulation(p, device="cpu").state)
    rng = np.random.default_rng(99)
    arrays["pos"] = arrays["pos"] + (
        1e-4 * rng.standard_normal(arrays["pos"].shape)
    ).astype(np.float32)
    run = make_run_chunk_table(p)
    n0 = kernels.LAUNCHES["mega_span"]
    out_c = state_to_arrays(run(state_from_arrays(p, arrays, "cuda"), 24, True))
    spans = kernels.LAUNCHES["mega_span"] - n0
    out_h = state_to_arrays(run(state_from_arrays(p, arrays, "cpu"), 24, True))
    dpos = float(np.abs(out_c["pos"] - out_h["pos"]).max())
    dvel = float(np.abs(out_c["vel"] - out_h["vel"]).max())
    if spans != 3 or run.redos:
        fail(f"256-bot span schedule: {spans} spans, {run.redos} redos (want 3, 0)")
    # velocities take the force that the position differences cost through
    # the magnet ramp, as in kernel 3's tolerance
    vel_tol = SMALL_VEL_ATOL + p.timestep * K3_NEIGHBOURS * ramp_slope(p) * 2 * dpos
    if not (dpos <= SMALL_POS_ATOL and dvel <= vel_tol):
        fail(f"256-bot span schedule: card vs CPU dpos={dpos} dvel={dvel} (tol {vel_tol})")
    return dpos, dvel, vel_tol


def light_distance(sim) -> float:
    c = sim.centroid()
    return float(np.hypot(c[0] - sim.params.light_x, c[1] - sim.params.light_y))


def band_main_path():
    """The slice's main path: ``Simulation.run`` for 120 sim-s on 1000 HEX
    bots with AUTO, the counters reset just before."""
    sim = pt.Simulation(band_params(), device="cuda")
    runner = sim._run_chunk
    if not runner.path_info.get("use_mega"):
        fail(f"1000-bot scene: not on the span path ({runner.path_info})")
    n_steps = 12_000
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "band.csv")
        torch.cuda.synchronize()
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        sim.run(max_time=120.0, csv_path=csv, echo=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        with open(csv, encoding="utf-8") as f:
            rows = f.read().splitlines()[2:]
    health = sim.health()
    if sim.state.step != n_steps or len(rows) != 3:  # t = 0, 60, 120
        fail(f"1000-bot scene: step {sim.state.step}, {len(rows)} CSV rows")
    if not health["finite"] or health["cell_overflow"] != 0:
        fail(f"1000-bot scene: health {health}")
    seg, k = runner.path_info["gate_seg"], runner.path_info["slot_rebuild_steps"]
    n_segs, bps, r = n_steps // seg, seg // k, runner.redos
    # every segment: k-1 prefix steps and the last post through kernel 1,
    # the prefix rebuild and bps-1 span rebuilds through kernel 2, bps-1
    # spans; a redone segment drops its last post and adds seg regular
    # steps with seg/k rebuilds
    want = {
        "mega_span": n_segs * (bps - 1),
        "compact": n_segs * bps + r * bps,
        "stencil_forces": n_segs * k + r * (seg - 1),
    }
    if launches != want:
        fail(f"1000-bot scene launches {launches}, want {want} ({r} redos)")
    return sim, launches, r, wall * 1e6 / n_steps, sim.params.n_cells * n_steps / wall


def busy_share(sim, n_steps):
    """Device activity of ``n_steps`` seg-aligned steps under
    torch.profiler, as text: the busy share (kernel and copy time over wall
    time, "not measured" when the profiler saw no device activity), device
    us/step, each hand-written kernel's us/step and the device activities
    per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.state = sim._run_chunk(sim.state, n_steps, True)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return "not measured"
    dev_us = sum(e.time_range.elapsed_us() for e in dev)
    per_kernel = ", ".join(
        f"{name} %.1f" % (sum(
            e.time_range.elapsed_us() for e in dev if f"{name}_kernel" in e.name
        ) / n_steps)
        for name in kernels.LAUNCHES
    )
    return (
        f"{dev_us / wall_us:.4f} ({dev_us / n_steps:.1f} device us/step: "
        f"{per_kernel}; {len(dev) / n_steps:.2f} device activities/step)"
    )


def ab_band(sim):
    """6,000 steps on the span path and 6,000 on the regular path from one
    state of the main path's scene: ({path: (us/step, light distance)},
    then :func:`busy_share` of 1,000 more span-path steps)."""
    p, runner = sim.params, sim._run_chunk
    arrays = state_to_arrays(sim.state)
    out = {}
    for name, aligned in (("mega", True), ("regular", False)):
        s = pt.Simulation(p, state=state_from_arrays(p, arrays, "cuda"), device="cuda")
        s._run_chunk = runner
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.state = runner(s.state, 6000, aligned)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) * 1e6 / 6000
        h = s.health()
        if not h["finite"] or h["cell_overflow"] != 0:
            fail(f"A/B {name}: health {h}")
        out[name] = (us, light_distance(s))
    return out, busy_share(sim, 1000)


def timed_steps(sim, start: int, n: int) -> float:
    """us/step of ``n`` steps from ``start`` after a 200-step warm-up."""
    sim.step_chunk(200, start_step=start)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step_chunk(n, start_step=start + 200)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) * 1e6 / n
    if not sim.health()["finite"]:
        fail(f"{sim.params.n_cells}-bot {sim.backend.name} run: non-finite state")
    return us


def other_paths():
    """us/step of the paths around the band: the obstacle scene (500 bots)
    on DENSE (AUTO's choice on the card) and on the span path (PALLAS), and
    the gap scene (1000 bots, RANDOM layout) on the regular table loop at
    grid_dim 32, the smallest table its layout fits (16,384 rows)."""
    ex = os.path.join(ROOT, "examples")
    dense = pt.Simulation.from_cfg(os.path.join(ex, "example_obstacle.cfg"), device="cuda",
                                   force_backend=pt.ForceBackend.DENSE)
    span = pt.Simulation.from_cfg(os.path.join(ex, "example_obstacle.cfg"), device="cuda",
                                  force_backend=pt.ForceBackend.PALLAS)
    gap = pt.Simulation.from_cfg(os.path.join(ex, "example_gap.cfg"), device="cuda", grid_dim=32)
    if gap._run_chunk.path_info.get("use_mega"):
        fail("gap scene at grid_dim 32 should be off the span band")
    return {
        "obstacle_dense": timed_steps(dense, 0, 400),
        "obstacle_span": timed_steps(span, 0, 2000),
        "gap_regular_g32": timed_steps(gap, 0, 400),
    }


def run_cli() -> tuple:
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "out.csv")
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [
            sys.executable, "-m", "particlerobotsimulations_torch.cli",
            "simulate", os.path.join(ROOT, "examples", "example.cfg"),
            "--device", "cuda", "--backend", "pallas",
            "--max-time", "180", "--csv", csv, "--quiet",
        ]
        t0 = time.perf_counter()
        res = subprocess.run(
            cmd, cwd=tmp, env=env, capture_output=True, text=True, timeout=600
        )
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            fail(f"cli exited {res.returncode}:\n{res.stderr[-4000:]}")
        with open(csv, encoding="utf-8") as f:
            lines = f.read().splitlines()
    if lines[0] != "Seed, 5555" or lines[1] != "Time,Centroid X, Centroid Y, Distance":
        fail(f"cli CSV header: {lines[:2]}")
    rows = lines[2:]
    if len(rows) != 4:  # t = 0, 60, 120, 180
        fail(f"cli CSV has {len(rows)} rows, want 4")
    tail = res.stderr.strip().splitlines()[-1]
    if "PALLAS span path" not in tail:
        fail(f"cli did not take the span path: {tail}")
    return len(rows), wall, tail


def main() -> int:
    # 1. the card
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"phase 1 card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    regs = " ".join(
        ln.strip() for ln in kernels.BUILD_LOG.splitlines() if "registers" in ln
    )
    print(f"phase 2 build: {build_s:.2f} s {kernels.library_path().name} | {regs}")

    # 3. kernels against their twins on the card
    params = bench_params()
    p, tables, planes = main_path_tables(params)
    k1_err = compare_stencil(p, tables)
    k2_ovf, k2_err = compare_compact(p, planes)
    psyn, syn = synthetic_planes()
    syn_ovf, _ = compare_compact(psyn, syn)
    if not syn_ovf:
        fail("synthetic compaction table did not overflow")
    dx, dy = planes[-2], planes[-1]
    movers = int((((dx != 0) | (dy != 0)) & (dx != 99)).sum())
    k1_ms = median_ms(lambda: kernels.stencil_forces_cuda(p, tables))
    k1_plain_ms = median_ms(lambda: stencil_forces_plain(p, tables))
    k2_ms = median_ms(lambda: kernels.compact_cuda(p, planes))
    k2_plain_ms = median_ms(lambda: compact_plain(p, planes))
    dpos, dvel = small_run_check()
    print(
        f"phase 3 kernels vs twins: stencil_forces G={p.resolved_grid_dim()} "
        f"max|diff| {k1_err:.3e} (atol {K1_ATOL}, rtol {K1_RTOL}, "
        f"fx/fy + {K1_SUM_RTOL}*(fa+fr)) "
        f"{k1_ms * 1e3:.1f} us vs plain {k1_plain_ms * 1e3:.1f} us | compact "
        f"equal ({movers} movers, overflow {k2_ovf}; synthetic overflow "
        f"{syn_ovf}) {k2_ms * 1e3:.1f} us vs plain {k2_plain_ms * 1e3:.1f} us "
        f"| 300-bot loop card vs cpu dpos {dpos:.2e} dvel {dvel:.2e}"
    )

    # 4. the main path, counters reset just before
    sim = pt.Simulation(params, device="cuda")
    torch.cuda.synchronize()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    chunk_s = []
    for i in range(3):
        t0 = time.perf_counter()
        sim.step_chunk(1000, start_step=i * 1000)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    health = sim.health()
    pos, vel, _ = sim.host_view()
    if pos.shape != (params.n_cells, 2) or sim.state.step != 3000:
        fail(f"main path: shape {pos.shape}, step {sim.state.step}")
    if not health["finite"]:
        fail("main path: non-finite positions or velocities")
    if health["cell_overflow"] != 0:
        fail(f"main path: {health['cell_overflow']} bots over cell capacity")
    if not (launches["stencil_forces"] > 0 and launches["compact"] > 0):
        fail(f"main path did not launch every kernel: {launches}")
    if launches["mega_span"]:
        fail(f"the 10k table is not in the span band: {launches}")
    runner = sim._run_chunk
    rate = params.n_cells * 1000 / chunk_s[-1]
    print(
        f"phase 4 main path: 10k HEX 3x1000 steps, launches {launches}, "
        f"k {runner.live['k']} last_probe {runner.last_probe} "
        f"(bound8 {runner.path_info['bound8']:.3f}), health {health}, "
        f"chunk s {[round(s, 3) for s in chunk_s]}, "
        f"{rate:.4e} particle-steps/s (last chunk)"
    )
    print(f"phase 4 profile: 10k HEX 200 steps, device busy share {busy_share(sim, 200)}")

    # 5. the CLI
    n_rows, cli_s, cli_tail = run_cli()
    print(f"phase 5 cli: example.cfg pallas 180 s -> {n_rows} rows in {cli_s:.1f} s | {cli_tail}")

    # 6. kernel 3 against its twin on four scenes, and the span schedule
    k3 = {}  # scene -> (max |diff|, max |dpos|, kernel ms, inputs)
    for name, sim in span_scenes().items():
        sp, tbl, strip, first = span_inputs(sim)
        obs = kernels.obstacle_buffers(sp, tbl.device)
        err, dpos = compare_span(name, sp, tbl, strip, first)
        ms = median_ms(lambda: kernels.mega_span_cuda(sp, tbl, strip, first, *obs))
        k3[name] = (err, dpos, ms, (sp, tbl, strip, first))
    k3_err = max(v[0] for v in k3.values())
    _, _, k3_ms, (bp, btbl, bstrip, bfirst) = k3["hex1000"]
    k3_plain_ms = median_ms(lambda: mega_span_plain(bp, btbl, bstrip, bfirst))
    scenes = " ".join(
        f"{name} max|diff| {v[0]:.2e} (dpos {v[1]:.2e}) {v[2] * 1e3:.1f} us;"
        for name, v in k3.items()
    )
    print(
        f"phase 6 mega_span vs twin, one K={bp.resolved_slot_rebuild_steps()} span "
        f"(px/py/rad atol {K3_POS_ATOL}; aa/ar atol {K1_ATOL} + rtol {K1_RTOL} + "
        f"{K3_NEIGHBOURS}*ramp_slope*2*dpos; vx/vy + {K1_SUM_RTOL}*(aa+ar) + dt*that): "
        f"{scenes} hex1000 plain {k3_plain_ms * 1e3:.1f} us"
    )
    sdpos, sdvel, svtol = schedule_check()
    print(
        f"phase 6 256-bot span schedule, 24 steps, card vs cpu: dpos {sdpos:.2e} "
        f"(atol {SMALL_POS_ATOL}) dvel {sdvel:.2e} (atol {svtol:.2e})"
    )

    # 7. the slice's main path: 1000 HEX bots via AUTO, counters reset
    #    just before
    bsim, b_launches, redos, b_us, b_rate = band_main_path()
    print(
        f"phase 7 band main path: 1000 HEX bots, Simulation.run 120 sim-s "
        f"(12000 steps), launches {b_launches}, redos {redos}, {b_us:.1f} us/step, "
        f"{b_rate:.4e} particle-steps/s, light distance {light_distance(bsim):.4f}"
    )

    # 8. A/B on the main path's scene, and the paths around the band
    ab, share_s = ab_band(bsim)
    other = other_paths()
    print(
        f"phase 8 A/B 1000 HEX bots 6000 steps: span path {ab['mega'][0]:.1f} us/step "
        f"(light distance {ab['mega'][1]:.4f}), regular {ab['regular'][0]:.1f} us/step "
        f"(light distance {ab['regular'][1]:.4f}); span-path device busy share "
        f"{share_s} | obstacle 500 bots: DENSE {other['obstacle_dense']:.1f} us/step, "
        f"span path {other['obstacle_span']:.1f} us/step | gap RANDOM 1000 bots "
        f"regular loop at G=32: {other['gap_regular_g32']:.1f} us/step"
    )

    k1_bound = stencil_bound(p, tables)
    k2_bound = compact_bound(planes)
    k3_bound = span_bound(bp, btbl, bstrip)
    print(
        "bounds (ms, by): stencil_forces %s, compact %s, mega_span %s"
        % (k1_bound, k2_bound, k3_bound)
    )
    record = {"kernels": [
        {"name": "stencil_forces", "route": "cuda",
         "source": "particlerobotsimulations_torch/csrc/stencil_forces.cu",
         "replaces": "particlerobotsimulations_tpu/ops/pallas_stencil.py:458",
         "launches": launches["stencil_forces"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None},
        {"name": "compact", "route": "cuda",
         "source": "particlerobotsimulations_torch/csrc/compact.cu",
         "replaces": "particlerobotsimulations_tpu/ops/table_rebuild.py:203",
         "launches": launches["compact"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None},
        {"name": "mega_span", "route": "cuda",
         "source": "particlerobotsimulations_torch/csrc/mega_span.cu",
         "replaces": "particlerobotsimulations_tpu/ops/megakernel.py:272",
         "launches": b_launches["mega_span"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1], "library_ms": None},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
