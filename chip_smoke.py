#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's two main paths — ``Simulation`` on bench.py's workload
(10k HEX bots, light at (-20, 0), seed 7) through the adaptive
table-resident loop, and the same workload cut to 1000 bots (light at
(-5, 0)) through the megakernel span path, where AUTO puts it on the card
— and checks that they went through the hand-written kernels:

1. require CUDA and print the card's name and power limit;
2. build the kernels from ``particlerobotsimulations_torch/csrc``, print
   ptxas's registers and spills, and hold the launch plans that
   ``kernels.py`` computes (kernel 1's and kernel 4's tiles, kernel 2's
   lane blocks and slot windows on the 10k, band and sharded tables,
   kernel 3's cluster) against the library's, with
   ``cudaOccupancyMaxActiveClusters`` for the band;
3. hold kernels 1 and 2 against their plain PyTorch twins on the card, at
   the 10k path's shapes (after 200 steps, G=48), kernel 1 also on a
   synthetic table with holes in the slot order and on a payload table,
   and kernel 2 on synthetic tables whose rows move by every offset with
   one cell overflowing, at Cs=16 and at Cs=40 (32 slots + 8 spill rows,
   two 32-slot windows); also hold a short 300-bot table-loop run on the
   card against the same run on the CPU twins;
4. run the 10k path for 3 chunks of 1000 steps with the launch counters
   reset just before, and check finite state, health, the adaptive
   cadence, the counters and the particle-steps/s of the last chunk, then
   profile 200 more steps for the device busy share;
5. run the CLI on ``examples/example.cfg`` (300 bots, PALLAS: the span
   path) and check its CSV;
6. hold kernel 3 against its twin on the card (both take the span's
   first step as a 0-dim int64 tensor on the card), one span from a
   mid-step state of four scenes (the 1000 HEX bots, the gap scene's walls, the
   obstacle scene, the object-transport scene; each after 200 steps), and
   hold a 256-bot, 8-step-segment span schedule on the card against the
   same run on the CPU twins;
7. run the 1000-bot path for 120 sim-s (12,000 steps, 60 segments) with
   the counters reset just before, and check the span path, finite state,
   health, the CSV and the launch counts against the reported redos; then
   hold kernel 2 against its twin on that scene's G=16 table (after 200
   steps, 7 more without a rebuild) and time it there;
8. A/B on that scene: 6,000 steps on the span path and 6,000 on the
   regular path from one state, the span path's device busy share under
   ``torch.profiler``; DENSE against the span path on
   ``examples/example_obstacle.cfg`` (500 bots); and the gap scene on the
   regular loop at the table its layout needs;
9. the sharded table loop (``parallel/spatial_table.py``) on a
   ``LocalRing(4)`` on the card, at bench.py's workload resolved to G=64
   (4 shards of 1,024 lanes, 256-lane halos): kernel 4 and kernel 2's
   padded form against their twins after 200 steps, kernel 1 on the whole
   table against kernel 4's centre lanes (bitwise; both timed, and their
   ratio printed), and the padded form on synthetic stacks (Cs=16 and 40)
   whose rows cross both shard boundaries and overflow one lane; 10k
   sharded against the single-table loop (16 steps per bot, 112 steps
   macrostate, a 6 u/s drift across the boundaries); the forced
   global fallback (64 bots at 50 u/s) and the overflow spill rows (600
   bots, 8 + 8 slots) against the single-table loop; 1,000 steps of the
   10k sharded path (the counters reset just before) against 1,000 of the
   single-table loop, with the launch counts checked and the sharded
   path's busy share under ``torch.profiler``; 200 steps at 100,000 bots
   (G=160) under the auto config through both loops (parked bots and
   fallbacks printed) and with 8 spill rows (none may be parked); and
   ``DistRing`` over NCCL when the machine has two cards;
10. the per-bot paths at bench.py's workload (10k HEX, G=48, C=16), from
   phase 4's state (step 3,200; no draw in the next 200 steps): 200 steps
   of ``engine.make_step`` on PALLAS (the per-bot collide through kernel
   1), STENCIL and CELLGRID, each with the counters reset just before
   (PALLAS: exactly 200 kernel-1 launches, nothing else; the others none),
   finite, the centroid within PER_BOT_CENTROID_ATOL of the table loop's
   over the same 200 steps (over 200 steps the swarm may move away from the
   light: it does in the JAX package at other seeds or without phase noise,
   ``scripts/jax_drift_10k.py``), the light distance and µs/step printed;
   one step of the three from one common state against each other; kernel
   1 against its twin on the per-bot path's own tables (bare bounding-box
   anchor: column 0 occupied);
11. kernels 1 and 4 past 32 slots (two occupancy words per cell): at C=48
   and C=64 against their twins and each other (bitwise), with and without
   a payload, on synthetic tables (half of each cell's slots occupied) and
   on the 10k scene's real positions after phase 10; both timed at C=64
   in a CUDA graph, beside their bounds;
12. the seed sweep, eight seeds (``run_sweep``) batched against the same
   seeds run one after another: bench.py's 10k workload (AUTO batched, 200
   steps), ``examples/example.cfg`` (300 bots, DENSE, AUTO batched) and
   the 1,000-bot band forced ``batched`` (the batched span), each with the
   counters reset just before (kernel 1 once per batched step, kernel 2
   once per rebuild, kernel 3 once per span, whatever the number of
   scenes), each scene held bit for bit (its centroid ring within a
   reordered sum's bound) to its lockstep replay (the scene alone through
   the single-scene loop, taking the batch's rebuild and redo decisions)
   and to its sequential run where neither fell back or redid a segment,
   the centroid distance printed where one did; the timings put beside
   the sequential runs'; kernels 1, 2 and 3 on
   those sweeps' eight tables in one launch against eight single launches
   (bit for bit) and their twins, each timed in a CUDA graph beside the
   eight launches; ``cli experiment robustness`` and ``cli sweep``; and
   ``gap_transit`` on ``examples/example_gap.cfg`` at ``grid_dim 32``;
13. checkpoints, video and the gradient path: bench.py's workload through
   ``Simulation.run`` for 3,000 steps with a checkpoint every dump and a
   1920x1080 MJPG ``VideoRecorder`` as the frame callback, then
   ``Simulation.from_checkpoint`` and ``Simulation(params, state=<the
   saved state>)`` 1,000 steps each, bit for bit with equal launch
   counts, the gap to the uninterrupted run printed, the AVI parsed back,
   the native renderer checked to be the one built from source, and the
   save and load times, the file's bytes, the ms per frame and the
   particle-steps/s with and without the recorder printed; ``cli
   simulate`` on ``examples/example.cfg --backend pallas`` (the span
   path) with ``--video --checkpoint`` to 120 s, then ``--resume`` to 180
   s: the CSV on the dump grid with no duplicate row, the resumed state
   bit for bit a one-call run's; ``models/optimize.make_phase_rollout`` at
   10k on PALLAS (kernel 1 forward inside the autograd wrapper) from the
   saved state: its value bit for bit a plain ``make_step`` run's, its
   gradient within ``DIFF_REL_L2_BOUND`` of STENCIL's, kernel 1 launched
   twice per step; ``optimize_phases`` for two iterations (ms per
   iteration, peak memory); and a 24-bot blob's PALLAS gradient against
   DENSE at the JAX package's tolerance;
14. the multi-device layer: ``dryrun.dryrun_multichip(8)`` (the JAX dry
   run's eight certifications on a virtual mesh of 8 places of the card);
   the dp x tp table loop on bench.py's workload, 4 seeds x 4 shards
   (G=64), 200 steps with the counters reset just before (one kernel-4
   launch per step and one padded kernel-2 launch per rebuild for all 16
   blocks; each scene decides its rebuilds alone, as in the JAX package),
   each scene bit for bit its solo run (alone through the single-scene
   sharded loop, deciding its own rebuilds), the batch on
   ``Mesh(["cuda"] * 2)`` x 4 shards bit for bit the ring's, and, over the
   steps before the first rebuild whose scenes decided apart, within phase
   9's sharded tolerance of the unsharded batched loop, timed beside them, the card's
   name and power limit beside the time; kernels 4 and 2 (padded) at those 16 blocks in one launch
   against the 16 single-block launches (bit for bit) and their twins,
   timed in a CUDA graph beside 4 launches of 4 shards; and ``run_sweep``
   of eight seeds of ``examples/example.cfg`` over ``Mesh(["cuda"] * 4)``
   against the unsharded batched run (every scene bit for bit);
15. the measurement and paper-parity layer: ``utils.profiling``'s
   ``measure_call_overhead`` and ``measure_throughput`` on bench.py's
   workload (PALLAS: kernel 1 once per step, kernel 2 once per rebuild,
   the counters reset just before) and ``scaling_report`` at 1,000 to
   20,000 bots (the 1,000-bot row on the span path); the bench's callable
   (``particlerobotsimulations_torch/bench.py``) at 400-step chunks with
   its three warm-ups and its JSON line parsed; the five shipped scenes
   through ``scripts/fullscale_torch.py``'s per-scene function at 2 sim-s,
   as shipped, where the gap scene must carry the grid-fit refusal (its
   RANDOM swarm outgrows AUTO's G=16, as in the JAX package) and the others
   run healthy; each scenario of ``scripts/parity_report_torch.py`` at 2
   seeds x 2,000 steps with the anchors computed (the gap sweep prints its
   backend, table and rebuilds); and ``--from-json`` on
   ``docs/parity/parity.json``, whose verdicts it must reproduce.  Their
   launches are added to the kernels' counts;
16. the graphed chunk: the table runners replay every block, K steps
   gated or not (its draws taken before it and fed in, the dead step's
   scores among them) or a chunk's ragged tail, and the adaptive probe's
   segment from CUDA graphs; no step of a chunk runs eagerly but a
   runner's warm-ups, and each chunk's eager steps on the card
   (``chunk.EAGER``) are printed, those of the last chunk run again on the
   warm runner held to none.  Four scenes run graph against eager (the
   same runner with ``chunk.CapturedBlock`` swapped for the eager
   block), bit for bit with equal rebuild counts and equal launches
   apart from ``cond_set`` (each graph rebuild is a conditional node, each
   eager one a select; ``cond_set`` counts one launch per replayed
   rebuild): bench.py's 10k workload from phase 4's state through the
   adaptive runner (4 seg-aligned chunks of 600 steps, a probe segment
   then K-step blocks; a fixed K=8 run is added when the probe kept K=4),
   100,000 HEX bots from placement without spill rows (400 steps: most
   rebuilds exact, so both branches run inside the graphs), eight 10k
   seeds batched (400 steps), and the 10k table loop at K=4 with 2,000
   bots killed mid-block at step 701 in a second chunk that ends in a
   ragged tail.  Each graph run prints its captures' cost and the memory
   it left reserved beside the eager run's.  The last chunk of each graph
   runner runs again, from its start, under
   ``torch.cuda.set_sync_debug_mode("error")``.  The rebuild is
   timed per branch (its node with the incremental taken, and with the
   exact taken by a bot moved two cells) against the incremental rebuild
   alone and the select at 10k and 100k; eager against graph at 10k
   (wall, device us/step and busy share under ``torch.profiler``, in
   turns); and the bench's
   multi-place branch on ``Mesh(["cuda"] * 2)``: dispatch interleaved,
   each scene bit for bit its solo run.  The graph runs' and the bench's
   launches are added to the kernels' counts;
17. the compiled small-scene paths: the per-bot runner (DENSE, AUTO's
   choice on the card up to 640 bots) replays a block from each gate, of
   at most ``engine.BLOCK_STEPS`` steps, from CUDA graphs, and the span
   path runs each segment as one graph that decides its adopt-or-redo on
   the card (an IF node with an else branch: the closing post, or the
   regular segment redone from the segment's entry with its rebuilds'
   nodes nested in the body).  Graph against eager (the runner with
   ``chunk.CapturedBlock`` swapped for the eager block), bit for
   bit with equal counts: ``examples/example.cfg`` (300 bots) and
   ``examples/example_obstacle.cfg`` (500 bots), 2,000 steps each from
   placement (a phase gate included), ``examples/example_dead_cells.cfg``
   (100 bots) with its bots killed at step 1,203, off every gate, in a
   second chunk that ends in a short block, and eight seeds of example.cfg
   batched (400 steps); the span path against the reference kept here
   (every segment's flag read on the host before the next is enqueued),
   bit for bit with equal launches, rebuilds and redos: the 1,000-bot
   band, 2,000 seg-aligned steps, its eight seeds batched under phase
   noise, 800 steps (redos printed), the band with its span rebuilds
   failed on the card in alternate segments (a device flag set before
   each), and the band with 100 bots killed on the segment boundary at
   step 600 (800 steps); the segment graphs' nodes (nested bodies
   included) and their capture and instantiation time, and the memory
   each graph run left reserved, are printed.  No chunk runs an eager
   step.  The last chunk of each runner again, from its start, under
   ``torch.cuda.set_sync_debug_mode("error")`` (the dead segment
   included).  Eager
   against graph in turns (wall, device us/step and busy share under
   ``torch.profiler``, the card's name and power limit) for DENSE at 300
   and 500 bots and the band's span and regular paths, and the per-bot
   runner at 8 against 32 steps per block.  The graph runs' launches are
   added to the kernels' counts;
18. the sharded loop's compiled chunk: its K-step blocks, gated or not,
   replay from CUDA graphs and a chunk reads nothing from the card (the rebuild
   decision a device select, the stats device counters read at the exit).
   Graph against eager (the runner with ``chunk.CapturedBlock``
   swapped for the eager block), bit for bit with equal launches (apart
   from ``cond_set``, as in phase 16) and equal ``fallbacks`` and
   ``spill_rows_max`` per chunk: bench.py's 10k workload on
   ``LocalRing(4)`` (G=64) from placement, 1,200 steps across
   the centroid gate at 1,000; 100,000 HEX bots with 8 spill rows, 200
   steps (none parked); the forced fallback (64 bots at 50 u/s, every
   chunk falls back), and the same with 5 bots killed mid-block at step
   21 in a second chunk that ends in a ragged tail (the all-gathered
   ``topk`` captured); dp x tp, 4 seeds x 4 shards, 400 steps, on one ring
   and on two data places of 4 shards (the places interleaved).  No
   chunk runs an eager step; each graph run prints its captures' cost and
   the memory it left reserved.  The last chunk of each graph runner
   again, from its start, under
   ``torch.cuda.set_sync_debug_mode("error")``, its stats read after.
   The rebuild per branch against the incremental rebuild alone and the
   select at G=64 and at 100k, with the exact rebuild's device time by
   op; eager against graph in turns under the profiler (wall, device
   us/step, the card's name and power limit) at 10k and in dp x tp on one
   ring and on the two data places.  The
   graph runs' launches are added to the kernels' counts.  (Phase 14's
   dp x tp run records its decisions, so it runs its blocks eagerly: a
   graph replays its rebuilds without the decision hook.)
19. the rebuild's conditional node (``csrc/graph_cond.cu``, kernel
   ``cond_set``; ``ops/cond.py``): the captures of phases 16 and 18's
   graph runs on seven scenes (10k adaptive, 100k without spill rows,
   eight 10k seeds, 10k sharded, 100k sharded with spill rows, 64 bots
   at 50 u/s, dp x tp) each held one conditional node per K-step block
   with a body and no select, the 100k table took both branches inside
   its replays and the 50 u/s scene the exact one; ``cond_set`` with
   its node against the select at the 10k table (the incremental and the
   exact branch, bit for bit); its time per cond in a graph of 20 (body
   not taken and taken) against the select's ``torch.where``; and 10k
   K=8 eager against graph when phase 16's probe kept K=4;
20. the row step (``csrc/row_step.cu``, ``ops/row_step.py``: the table
   loop's step glue in one launch) against its plain twin on the 10k
   table after phase 4's 3,000 steps and on the 10k sweep's eight tables
   after phase 12's 200, in each mode (post, pre, post_pre; kernel 1's
   sums of the same table given), bit for bit on all 13 planes; each
   mode timed per launch in a CUDA graph of 20, the twin per call and in
   a CUDA graph of 20 (the ops the loop replayed before the row step), and
   bounded by the bytes it moves.  The row step's launches are checked
   wherever the table loop runs: phases 7, 12 and 17 against the blocks'
   schedules (``engine_table.glue_schedule``), phase 15 between once and
   twice a step; and phases 12 and 17 run their references through the
   twin, so the loop's glue is held against plain PyTorch bit for bit.

The four kernels and the row step are timed per launch from replays of
a CUDA graph of 20 launches, so their wrappers' host-side checks stay
out of the time (kernel 3 also per wrapper call); the plain twins are
timed per call with CUDA events.  ``cond_set`` is timed per cond (the
kernel and its node) in a graph of 20.

Any failure raises and exits non-zero.  The last two lines are the
kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import particlerobotsimulations_torch as pt
from particlerobotsimulations_torch import chunk as t_chunk
from particlerobotsimulations_torch import engine_table, kernels
from particlerobotsimulations_torch.engine_table import (
    REBUILDS,
    _make_mega_glue,
    enter_table,
    exit_table,
    gate_seg,
    glue_schedule,
    make_run_chunk_table,
    make_table_step,
    make_table_step_parts,
    table_pieces,
)
from particlerobotsimulations_torch.models.placement import resolve_params
from particlerobotsimulations_torch.ops.megakernel import (
    mega_eligible,
    mega_span_batched_plain,
    mega_span_plain,
)
from particlerobotsimulations_torch.ops.pallas_stencil import (
    FIELDS as KERNEL_FIELDS,
    assign_slots_slotmajor,
    pair_constants,
    scatter_bot_tables,
    stencil_forces,
    stencil_forces_batched_plain,
    stencil_forces_ext_plain,
    stencil_forces_plain,
)
from particlerobotsimulations_torch.ops.dense_step import dense_step_plain
from particlerobotsimulations_torch.ops.row_step import row_step_plain
from particlerobotsimulations_torch.ops.table_rebuild import (
    compact_padded_plain,
    compact_plain,
    rebuild_move_planes,
)
from particlerobotsimulations_torch.engine import make_step
from particlerobotsimulations_torch.io.checkpoint import load_checkpoint, save_checkpoint
from particlerobotsimulations_torch.models.optimize import make_phase_rollout, optimize_phases
from particlerobotsimulations_torch.render import native as render_native
from particlerobotsimulations_torch.render.video import VideoRecorder
from particlerobotsimulations_torch.parallel.ring import LocalRing
from particlerobotsimulations_torch.parallel.spatial_table import (
    HALO_ROWS,
    make_sharded_table_run,
    resolve_tp_params,
)
from particlerobotsimulations_torch.parallel.sweep import choose_sweep_strategy, run_sweep
from particlerobotsimulations_torch.rng import SceneDraws
from particlerobotsimulations_torch.utils import trace
from particlerobotsimulations_torch.state import (
    ARRAY_FIELDS,
    MOVE_FIELDS,
    TABLE_FIELDS,
    active_mask,
    payload_mask,
    scene_state,
    state_from_arrays,
    state_to_arrays,
    step_tensor,
    table_geometry,
)

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

# the sharded loop's checks (the JAX package's, tests/test_parallel.py and
# __graft_entry__.dryrun_multichip): per bot after 16 steps, positions and
# velocities (the non-Newton summation order seeds ulp differences that the
# contacts amplify, velocities ~1/dt faster); the macrostate after 112:
# centroid (absolute), mean radius and mean speed (relative)
N_SHARDS = 4
# the per-bot paths (phase 10): steps of each backend, and the ulps of
# pair distance that the magnet ramp may turn into force between kernel 1's
# pair law (1 / sqrt of d2 + eps^2) and the JAX package's (the norm and a
# division) that STENCIL and CELLGRID evaluate, as tests/test_torch_backends.py
# states it: RAMP_ULPS * ramp_slope * spacing(0.2), the ramp's distances
# being < 0.25
PER_BOT_STEPS = 200
PER_BOT_BACKENDS = ("PALLAS", "STENCIL", "CELLGRID")
RAMP_ULPS = 4
# a per-bot run's centroid against the table loop's after those 200 steps:
# twice the JAX package's own envelope there, the largest centroid change
# that one ulp of every initial position made over steps 3200-3400 of the
# same scene (4.62e-4 in four runs, scripts/jax_drift_10k.py)
PER_BOT_CENTROID_ATOL = 1e-3
# slot counts past one 32-bit occupancy word (phase 11)
WIDE_CAPS = (48, 64)
# a storage capacity past one 32-slot mask word: 32 slots + 8 spill rows
SPILL_40 = {"cell_capacity": 32, "overflow_slots": 8}
TP_POS_ATOL, TP_VEL_ATOL = 1e-5, 1e-3
TP_CENTROID_ATOL, TP_RAD_RTOL, TP_SPEED_RTOL = 2e-4, 1e-3, 2e-3

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
    """Time of one call of ``fn`` in ms as a caller sees it: CUDA events
    around ``launches`` back-to-back calls, divided by the count; the
    median of ``reps`` such runs, after a warm-up.  Where the calls' host
    work outlasts their device work, this is the host's time."""
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


def graph_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device time of one call of ``fn`` in ms: ``launches`` calls captured
    in one CUDA graph (a ``chunk.CapturedBlock``, so a rebuild's
    cond becomes its conditional node), CUDA events around each replay,
    divided by the count; the median of ``reps`` replays, after a
    warm-up.  The replay runs no Python, so a wrapper's host-side checks
    do not enter the time as they do in :func:`median_ms`."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def block(carry, step):
        for _ in range(launches):
            fn()
        return {}

    graph = t_chunk.CapturedBlock(block, {"x": torch.zeros(1, device="cuda")}).graph
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
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


def synthetic_planes(**over):
    """A G=16 table whose rows move by every one of the 8 offsets (and
    stay), with every row around lane (8, 8) moving into it so that one
    cell overflows; ``over`` sets other SimParams (the slot counts)."""
    p = pt.SimParams(n_cells=1000, n_dead=0, grid_dim=16, **over).validate()
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


def hole_tables(p, seed, fill=0.3):
    """Kernel 1's tables at ``p``'s shape with each slot occupied at random
    (``fill``), so that a cell's occupied slots have holes, bots jittered
    around their cell centres, and afac in {1, 2}."""
    g, cap = p.resolved_grid_dim(), p.cell_capacity
    gg = g * g
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rand(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand((cap, gg), generator=gen, device="cuda")

    occ = rand() < fill
    lane = torch.arange(gg, device="cuda")
    h = p.cutoff()
    t = {
        "px": ((lane % g) + rand()) * h, "py": ((lane // g) + rand()) * h,
        "vx": rand(-0.3, 0.3), "vy": rand(-0.3, 0.3),
        "rad": rand(0.0775, 0.1175), "afac": 1.0 + (rand() < 0.5).float(),
    }
    return {k: torch.where(occ, v, torch.zeros_like(v)).contiguous() for k, v in t.items()}


def holes_in_slot_order(tables) -> int:
    """Cells whose occupied slots are not a prefix 0 .. n-1."""
    occ = tables["rad"] > 0
    prefix = torch.cumprod(occ.int(), dim=0).bool()
    return int((occ & ~prefix).any(dim=0).sum())


def compare_stencil(p, tables):
    got = kernels.stencil_forces_cuda(p, tables)
    want = stencil_forces_plain(p, tables)
    torch.cuda.synchronize()
    return check_forces("stencil_forces", got, want)


def check_forces(name, got, want):
    """max |diff| of a force kernel's (fx, fy, fa, fr) against its twin's;
    fails beyond kernel 1's tolerance form (K1_* above)."""
    summed = want[2] + want[3]  # fa + fr: the magnitudes fx, fy sum
    err = 0.0
    for i, (field, a, b) in enumerate(zip(("fx", "fy", "fa", "fr"), got, want)):
        if not torch.isfinite(a).all():
            fail(f"{name}: non-finite {field}")
        d = (a - b).abs()
        err = max(err, float(d.max()))
        tol = K1_ATOL + K1_RTOL * b.abs()
        if i < 2:
            tol = tol + K1_SUM_RTOL * summed
        bad = d > tol
        if bad.any():
            j = int(torch.argmax(d / tol))
            fail(
                f"{name} {field}: {int(bad.sum())} entries beyond "
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
    entry, then the gated pre of its current step.  The first step is a
    0-dim int64 tensor on the card, as kernel 3 and its twin take it."""
    p = sim.params.validate()
    ts = enter_table(p, sim.state)
    step_pre, _ = make_table_step_parts(p)
    ts = step_pre(ts, *t_chunk.gates(p, ts.step))
    tbl, strip = _make_mega_glue(p)[0](ts.fields)
    return p, tbl, strip, step_tensor(ts.step + 1, tbl.device)


def ramp_slope(p) -> float:
    """Largest slope of the magnet ramp, force per unit of gap, over the
    scene's attraction factors."""
    (_, _, _, _, attr, _, _, mina, inv_i2_sq, inv_span) = pair_constants(p)
    if p.has_payload:
        attr *= max(1.0, p.attraction_factor) ** 2
    return abs(attr * inv_i2_sq - mina) * inv_span


def compare_span(name, p, tbl, strip, first, got=None):
    """max |diff| of kernel 3 (one launch, or ``got`` when given) against
    its twin on one span; fails beyond the tolerance (K3_* above)."""
    if got is None:
        got = kernels.mega_span_cuda(p, tbl, strip, first)
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
    check_launches(f"1000-bot scene ({r} redos)", launches, {
        "mega_span": n_segs * (bps - 1),
        "compact": n_segs * bps + r * bps,
        "stencil_forces": n_segs * k + r * (seg - 1),
        "row_step": row_step_launches(sim.params.validate(), [(0, n_steps, True)], r),
    })
    return sim, launches, r, wall * 1e6 / n_steps, sim.params.n_cells * n_steps / wall


def seg_steps(sim, n_steps):
    """A callable that runs ``n_steps`` seg-aligned steps of ``sim``."""
    def run():
        sim.state = sim._run_chunk(sim.state, n_steps, True)
    return run


# the __global__ function of each kernel, as the profiler names it (both
# forms of kernel 2 are one function)
KERNEL_SYMBOLS = {
    "stencil_forces": "stencil_forces_kernel", "compact": "compact_kernel",
    "mega_span": "mega_span_kernel", "stencil_forces_ext": "stencil_forces_ext_kernel",
    "dense_step": "dense_step_kernel",
}


def ptxas_report(log: str) -> str:
    """Registers and spills of each kernel from nvcc's ``-Xptxas -v``
    output: "name: R registers, S B spill stores, L B spill loads"."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = next((k for k, sym in KERNEL_SYMBOLS.items() if sym in ln), ln.split("'")[1])
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "registers" in ln and name:
            regs = ln.split("Used ")[1].split(" registers")[0]
            out.append(f"{name}: {regs} registers, {spill}")
            name = None
    return "; ".join(out)


def busy_share(run_steps, n_steps, host_ops: bool = True):
    """Device activity of ``run_steps()``, ``n_steps`` steps, under
    torch.profiler, as text: the busy share (kernel and copy time over wall
    time, "not measured" when the profiler saw no device activity), device
    us/step, each hand-written kernel's us/step and the device activities
    per step.  ``host_ops=False`` traces the device alone, which costs the
    host less (an eager step records hundreds of host operators)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run_steps()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return "not measured"
    dev_us = sum(e.time_range.elapsed_us() for e in dev)
    per_kernel = ", ".join(
        f"{name} %.1f" % (sum(
            e.time_range.elapsed_us() for e in dev if sym in e.name
        ) / n_steps)
        for name, sym in KERNEL_SYMBOLS.items()
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
    return out, busy_share(seg_steps(sim, 1000), 1000)


def movers_of(planes) -> int:
    """Occupied rows of a compaction stack whose move is not (0, 0)."""
    dx, dy = planes[-2], planes[-1]
    return int((((dx != 0) | (dy != 0)) & (dx != 99)).sum())


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


def shard_halo(x, shards, g):
    """(..., G*G) global lanes -> (S, ..., L0 + 2H): each shard's lane block
    between its ring neighbours' boundary grid rows and zero rows, the
    layout the sharded loop's halo exchange builds."""
    l0 = x.shape[-1] // shards
    blocks = x.reshape(x.shape[:-1] + (shards, l0)).movedim(-2, 0)
    z = torch.zeros(blocks.shape[:-1] + ((HALO_ROWS - 1) * g,), device=x.device)
    return torch.cat(
        [z, torch.roll(blocks, 1, 0)[..., -g:], blocks, torch.roll(blocks, -1, 0)[..., :g], z],
        dim=-1,
    ).contiguous()


def sharded_tables(p, state):
    """Kernel 4's and kernel 2 padded's inputs on the sharded 10k scene at
    ``state``: (halo-extended tables, kernel 1's tables of the same whole
    table, padded move-plane stack after 7 steps without a rebuild so that
    the compaction sees real movers)."""
    g, cap, cs = p.resolved_grid_dim(), p.cell_capacity, p.storage_capacity()
    gg = g * g
    ts = enter_table(p, state)
    whole = {k: ts.fields[k][: cap * gg].view(cap, gg) for k in KERNEL_FIELDS}
    ext = shard_halo(torch.stack([whole[k] for k in KERNEL_FIELDS]), N_SHARDS, g)
    tables_ext = {k: ext[:, j] for j, k in enumerate(KERNEL_FIELDS)}
    step = make_table_step(p)
    for _ in range(7):
        ts = step(ts, False, False, False, False)
    planes = torch.stack([ts.fields[k][: cs * gg] for k in MOVE_FIELDS]).reshape(-1, cs, gg)
    dxf, dyf, _, _ = rebuild_move_planes(p, planes, MOVE_FIELDS, ts.origin)
    padded = shard_halo(torch.cat([planes, dxf[None], dyf[None]]), N_SHARDS, g)
    return tables_ext, whole, padded


def crossing_rows(padded, h, l0, g) -> int:
    """Rows of a padded stack's two real halo rows that move into the
    centre: the rows that cross a shard boundary in this compaction."""
    dy = padded[:, -1]
    lanes = torch.arange(padded.shape[-1], device=padded.device)
    prev = (lanes >= h - g) & (lanes < h)
    nxt = (lanes >= h + l0) & (lanes < h + l0 + g)
    return int((((dy == 1) & prev) | ((dy == -1) & nxt)).sum())


def synthetic_padded(**over):
    """A G=32 table over 4 shards with random moves at 60 % fill and every
    row of the 3x3 lanes around a lane of shard 1's first grid row moving
    into it (it overflows, fed across the boundary), cut into shards;
    ``over`` sets other SimParams (the slot counts)."""
    p = pt.SimParams(n_cells=1000, n_dead=0, grid_dim=32, **over).validate()
    g, cs = p.resolved_grid_dim(), p.storage_capacity()
    gg = g * g
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    data = torch.randn((9, cs, gg), generator=gen, device="cuda")
    occ = torch.rand((cs, gg), generator=gen, device="cuda") < 0.6
    move = torch.randint(-1, 2, (2, cs, gg), generator=gen, device="cuda").float()
    target = gg // N_SHARDS + 8
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            src = target + oy * g + ox
            occ[:, src] = True
            move[0, :, src] = -ox
            move[1, :, src] = -oy
    far = torch.full_like(move[0], 99.0)
    data[5] = occ.float()
    stack = torch.cat([data, torch.where(occ, move[0], far)[None],
                       torch.where(occ, move[1], far)[None]])
    return p, shard_halo(stack, N_SHARDS, g)


def compare_compact_padded(p, padded, h, l0):
    """(overflow flag, max |diff|) of kernel 2's padded form against its
    twin; any difference fails."""
    out_k, inc_k = kernels.compact_padded_cuda(p, padded, h, l0)
    out_p, inc_p = compact_padded_plain(p, padded, h, l0)
    torch.cuda.synchronize()
    err = max(float((out_k - out_p).abs().max()), float((inc_k - inc_p).abs().max()))
    if not (torch.equal(inc_k, inc_p) and bool((out_k == out_p).all())):
        fail(f"compact_padded differs from its twin (max |diff| {err})")
    return bool((inc_k > p.storage_capacity()).any()), err


def stencil_ext_bound(p, whole, tables_ext, l0) -> tuple:
    """Kernel 4: the lanes it reads of each plane (px, py, vx, vy, rad,
    val, and afac with a payload), once: the centre and one grid row each
    side (the three zero halo rows beyond are never read); four outputs
    written once; the pair operations of the occupied pairs (the same pair
    set as kernel 1 on the whole table)."""
    n_in = 7 if p.has_payload else 6
    s, cap, _ = tables_ext["px"].shape
    g = p.resolved_grid_dim()
    ins, outs = s * cap * (l0 + 2 * g), s * cap * l0
    return bound((n_in * ins + 4 * outs) * 4, PAIR_OPS * occupied_pairs(p, whole["rad"]))


def compact_padded_bound(p, padded, l0) -> tuple:
    """Kernel 2's padded form: per shard, the lanes its 3x3 sources reach
    (the centre and G + 1 lanes each side) of every plane, read once; nf
    planes and the per-lane count written once."""
    s, nfp, cs, _ = padded.shape
    reach = l0 + 2 * (p.resolved_grid_dim() + 1)
    return bound(s * (nfp * cs * reach + (nfp - 2) * cs * l0 + l0) * 4, s * 9 * cs * l0)


def jittered_arrays(p, vel=(0.0, 0.0), seed=99):
    """Bot-order arrays of a fresh scene, positions jittered by 1e-4 and
    every bot given velocity ``vel``, from numpy."""
    arrays = state_to_arrays(pt.Simulation(p, device="cuda").state)
    n = p.n_cells
    rng = np.random.default_rng(seed)
    arrays["pos"][:n] += (1e-4 * rng.standard_normal((n, 2))).astype(np.float32)
    arrays["vel"][:n] = np.asarray(vel, np.float32)
    return arrays


def sharded_vs_single(base, vel, n_steps, vel_atol, label):
    """(sharded final arrays, stats, max |dpos|, max |dvel|): ``n_steps`` of
    the sharded loop on a LocalRing(4) against the single-table loop on the
    card from one jittered state; fails beyond TP_POS_ATOL and ``vel_atol``."""
    run, p = make_sharded_table_run(base, LocalRing(N_SHARDS, "cuda"), with_stats=True)
    arrays = jittered_arrays(p, vel)
    out, stats = run(state_from_arrays(p, arrays, "cuda"), n_steps)
    ref = make_run_chunk_table(p)(state_from_arrays(p, arrays, "cuda"), n_steps)
    a, b = state_to_arrays(out), state_to_arrays(ref)
    n = p.n_cells
    dpos = float(np.abs(a["pos"][:n] - b["pos"][:n]).max())
    dvel = float(np.abs(a["vel"][:n] - b["vel"][:n]).max())
    if not (np.isfinite(a["pos"]).all() and dpos <= TP_POS_ATOL and dvel <= vel_atol):
        fail(f"{label}: sharded vs single-table dpos={dpos} dvel={dvel}")
    return a, stats, dpos, dvel


def shard_of(p, pos, origin):
    """Each bot's shard under the table anchored at ``origin``."""
    g, h = p.resolved_grid_dim(), p.cutoff()
    iy = np.floor((pos[:, 1] - origin[1]) / np.float32(h)).astype(np.int64) % g
    return iy // (g // N_SHARDS)


def sharded_agreement(base):
    """10k HEX bots, no phase noise, a 6 u/s y-drift: the sharded loop on
    the card against the single-table loop per bot after 16 steps and by
    macrostate after 112 (the JAX package's production-shape test).
    Returns a line of text."""
    run, p = make_sharded_table_run(base, LocalRing(N_SHARDS, "cuda"))
    ref_run = make_run_chunk_table(p)
    arrays = jittered_arrays(p, (0.0, 6.0))
    n = p.n_cells
    st0 = state_from_arrays(p, arrays, "cuda")
    origin = enter_table(p, st0).origin.cpu().numpy()
    out = run(st0, 16)
    ref = ref_run(state_from_arrays(p, arrays, "cuda"), 16)
    a, b = state_to_arrays(out), state_to_arrays(ref)
    dpos = float(np.abs(a["pos"][:n] - b["pos"][:n]).max())
    dvel = float(np.abs(a["vel"][:n] - b["vel"][:n]).max())
    if not (dpos <= TP_POS_ATOL and dvel <= TP_VEL_ATOL):
        fail(f"10k sharded vs single-table at 16 steps: dpos={dpos} dvel={dvel}")
    out, ref = run(out, 96), ref_run(ref, 96)
    a, b = state_to_arrays(out), state_to_arrays(ref)
    pos, rpos, vel, rvel = a["pos"][:n], b["pos"][:n], a["vel"][:n], b["vel"][:n]
    if not (np.isfinite(pos).all() and np.isfinite(vel).all()) or a["step"] != 112:
        fail("10k sharded at 112 steps: non-finite state or wrong step")
    drift = float(pos[:, 1].mean() - arrays["pos"][:n, 1].mean())
    crossed = int((shard_of(p, pos, origin) != shard_of(p, arrays["pos"][:n], origin)).sum())
    dcen = float(np.abs(pos.mean(0) - rpos.mean(0)).max())
    rad, rrad = float(a["rad"][:n].mean()), float(b["rad"][:n].mean())
    speed = float(np.hypot(vel[:, 0], vel[:, 1]).mean())
    rspeed = float(np.hypot(rvel[:, 0], rvel[:, 1]).mean())
    if drift <= 3.0 or crossed == 0:
        fail(f"10k sharded: drift {drift}, {crossed} bots changed shard")
    if not (dcen <= TP_CENTROID_ATOL and abs(rad - rrad) <= TP_RAD_RTOL * abs(rrad)
            and abs(speed - rspeed) <= TP_SPEED_RTOL * abs(rspeed)):
        fail(f"10k sharded macrostate at 112: centroid {dcen}, rad {rad} vs {rrad}, "
             f"speed {speed} vs {rspeed}")
    return (
        f"16 steps dpos {dpos:.2e} (atol {TP_POS_ATOL}) dvel {dvel:.2e} (atol {TP_VEL_ATOL}); "
        f"112 steps centroid |diff| {dcen:.2e} (atol {TP_CENTROID_ATOL}), mean rad "
        f"{rad:.6f} vs {rrad:.6f} (rtol {TP_RAD_RTOL}), mean speed {speed:.5f} vs "
        f"{rspeed:.5f} (rtol {TP_SPEED_RTOL}), y-drift {drift:.3f}, {crossed} bots "
        f"changed shard"
    )


def cell_overflow(p, state, cap=None) -> int:
    """Bots beyond ``cap`` (default: the force-visible cell_capacity, as
    ``Simulation.health`` counts them) in their cell."""
    mask = active_mask(p, state.n_pad, state.device)
    return int(assign_slots_slotmajor(p, state.pos, mask, cap=cap)[1].item())


def timed_sharded(run, p, n_steps):
    """(final state, stats, us/step, launches) of ``n_steps`` of a sharded
    run on a fresh scene after an 8-step warm-up, the counters reset just
    before."""
    st = run(pt.Simulation(p, device="cuda").state, 8)[0]
    torch.cuda.synchronize()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    out, stats = run(st, n_steps)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) * 1e6 / n_steps
    return out, stats, us, dict(kernels.LAUNCHES)


def single_with_fallbacks(run, state, n_steps):
    """(final state, exact rebuilds taken) of ``n_steps`` of a single-table
    loop: since the rebuild choice became a device select (every rebuild
    runs both rebuilds), the exact choices are counted on the device
    (``engine_table.REBUILDS``), through the graphs' replays too."""
    for k in REBUILDS:
        REBUILDS[k] = 0
    out = run(state, n_steps)
    return out, REBUILDS["exact"]


def auto_100k(base) -> str:
    """200 steps of 100,000 HEX bots under the auto config in the sharded
    and the single-table loop from one state: bots parked beyond the
    storage capacity and exact global rebuilds of each, as text."""
    run, p = make_sharded_table_run(base.replace(n_cells=100_000), LocalRing(N_SHARDS, "cuda"),
                                    with_stats=True)
    arrays = state_to_arrays(pt.Simulation(p, device="cuda").state)
    sharded, stats = run(state_from_arrays(p, arrays, "cuda"), 200)
    single, single_fb = single_with_fallbacks(
        make_run_chunk_table(p), state_from_arrays(p, arrays, "cuda"), 200)
    for name, out in (("sharded", sharded), ("single-table", single)):
        if not np.isfinite(out.pos.cpu().numpy()).all():
            fail(f"100k auto config, {name} loop: non-finite state")
    cap = p.storage_capacity()
    return (
        f"G={p.resolved_grid_dim()}, C={p.cell_capacity}, Cs={cap}: sharded parked "
        f"{cell_overflow(p, sharded, cap=cap)}, {stats}; single-table parked "
        f"{cell_overflow(p, single, cap=cap)}, fallbacks {single_fb} of "
        f"{200 // max(1, p.resolved_slot_rebuild_steps())} rebuilds"
    )


DIST_WORKER = """
import pickle, sys
import numpy as np
import torch
import torch.distributed as dist
from particlerobotsimulations_torch.parallel.ring import DistRing
from particlerobotsimulations_torch.parallel.spatial_table import make_sharded_table_run
from particlerobotsimulations_torch.state import state_from_arrays, state_to_arrays
init, rank, src, dst = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.cuda.set_device(rank)
dist.init_process_group("nccl", init_method=init, rank=rank, world_size=2)
with open(src, "rb") as fh:
    params, arrays, n_steps = pickle.load(fh)
run, _ = make_sharded_table_run(params, DistRing())
out = run(state_from_arrays(params, arrays, f"cuda:{rank}"), n_steps)
np.savez(dst, **state_to_arrays(out))
dist.destroy_process_group()
"""


def dist_ring_check() -> str:
    """DistRing over NCCL, two ranks on two cards, against LocalRing(2) on
    one card from the same state (elementwise equal: a two-shard sum
    commutes exactly); with one card, NCCL cannot hold two ranks and this
    does not run."""
    import pickle

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        return f"not run ({n_cards} card; NCCL needs one card per rank)"
    base = bench_params().replace(n_cells=1000, phase_std=0.5, light_x=-5.0)
    run, p = make_sharded_table_run(base, LocalRing(2, "cuda"))
    arrays = jittered_arrays(p)
    want = state_to_arrays(run(state_from_arrays(p, arrays, "cuda"), 24))
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.pkl")
        with open(src, "wb") as fh:
            pickle.dump((p, arrays, 24), fh)
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", DIST_WORKER, f"file://{tmp}/rdv", str(r), src,
                 os.path.join(tmp, f"out{r}.npz")],
                cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for r in range(2)
        ]
        try:
            logs = [q.communicate(timeout=300)[0] for q in procs]
        finally:
            for q in procs:
                q.kill()
        if any(q.returncode != 0 for q in procs):
            fail(f"DistRing workers failed: {[log[-2000:] for log in logs]}")
        for r in range(2):
            got = np.load(os.path.join(tmp, f"out{r}.npz"))
            for k, v in want.items():
                if not np.array_equal(got[k], v):
                    fail(f"DistRing rank {r} differs from LocalRing(2) in {k}")
    return "2 NCCL ranks equal LocalRing(2) elementwise after 24 steps (1000 bots)"


def sharded_phase():
    """Phase 9; returns (record entries, text lines)."""
    lines = []
    # kernels 4 and 2 (padded) against their twins at the 10k sharded shapes
    base = bench_params()
    run, p = make_sharded_table_run(base, LocalRing(N_SHARDS, "cuda"), with_stats=True)
    g = p.resolved_grid_dim()
    h, l0 = HALO_ROWS * g, g * g // N_SHARDS
    st = run(pt.Simulation(p, device="cuda").state, 200)[0]
    tables_ext, whole, padded = sharded_tables(p, st)
    got = kernels.stencil_forces_ext_cuda(p, tables_ext, h, l0)
    want = stencil_forces_ext_plain(p, tables_ext, h, l0)
    torch.cuda.synchronize()
    k4_err = check_forces("stencil_forces_ext", got, want)
    cap = p.cell_capacity
    k1_whole = kernels.stencil_forces_cuda(p, whole)
    torch.cuda.synchronize()
    for field, a, b in zip(("fx", "fy", "fa", "fr"), k1_whole, got):
        if not torch.equal(a, b.permute(1, 0, 2).reshape(cap, g * g)):
            fail(f"kernel 1 and kernel 4's centre lanes differ in {field} on the G={g} table")
    k2p_ovf, k2p_err = compare_compact_padded(p, padded, h, l0)
    for over in ({}, SPILL_40):
        psyn, syn = synthetic_padded(**over)
        gs = psyn.resolved_grid_dim()
        syn_ovf, _ = compare_compact_padded(psyn, syn, HALO_ROWS * gs, gs * gs // N_SHARDS)
        syn_cross = crossing_rows(syn, HALO_ROWS * gs, gs * gs // N_SHARDS, gs)
        if not syn_ovf or syn_cross == 0:
            fail(f"synthetic padded stack {over}: overflow {syn_ovf}, {syn_cross} crossing rows")
    cross = crossing_rows(padded, h, l0, g)
    k4_ms = graph_ms(lambda: kernels.stencil_forces_ext_cuda(p, tables_ext, h, l0))
    k4_plain_ms = median_ms(lambda: stencil_forces_ext_plain(p, tables_ext, h, l0))
    k1_ms = graph_ms(lambda: kernels.stencil_forces_cuda(p, whole))
    k2p_ms = graph_ms(lambda: kernels.compact_padded_cuda(p, padded, h, l0))
    k2p_plain_ms = median_ms(lambda: compact_padded_plain(p, padded, h, l0))
    k4_bound = stencil_ext_bound(p, whole, tables_ext, l0)
    k2p_bound = compact_padded_bound(p, padded, l0)
    k4_call_ms = median_ms(lambda: kernels.stencil_forces_ext_cuda(p, tables_ext, h, l0))
    lines.append(
        f"phase 9 kernels vs twins, 10k HEX sharded after 200 steps (G={g}, "
        f"{N_SHARDS} shards, L0={l0}, H={h}): kernel 1 on the whole table equals kernel "
        f"4's centre lanes bitwise | stencil_forces_ext max|diff| {k4_err:.3e} "
        f"(atol {K1_ATOL}, rtol {K1_RTOL}, fx/fy + {K1_SUM_RTOL}*(fa+fr)) "
        f"{k4_ms * 1e3:.1f} us per launch in a CUDA graph ({k4_call_ms * 1e3:.1f} us "
        f"per wrapper call) vs plain {k4_plain_ms * 1e3:.1f} us (kernel 1 on the "
        f"same table {k1_ms * 1e3:.1f} us: kernel 4 / kernel 1 {k4_ms / k1_ms:.3f}) "
        f"| compact_padded equal ({cross} rows crossing a boundary, overflow "
        f"{k2p_ovf}; synthetic Cs=16 and Cs=40: each overflows, {syn_cross} "
        f"crossing at Cs=40) {k2p_ms * 1e3:.1f} us vs plain {k2p_plain_ms * 1e3:.1f} us "
        f"| bounds (ms, by) {k4_bound}, {k2p_bound}"
    )

    # sharded against the single-table loop: 10k drift, fallback, spill
    lines.append("phase 9 10k sharded vs single-table: " + sharded_agreement(
        base.replace(phase_std=0.0)))
    _, fb_stats, fb_dpos, fb_dvel = sharded_vs_single(
        base.replace(n_cells=64, phase_std=0.0, light_x=-5.0), (50.0, 0.0), 16,
        TP_VEL_ATOL, "forced fallback")
    if fb_stats["fallbacks"] < 1:
        fail(f"forced fallback: no fallback fired {fb_stats}")
    _, sp_stats, sp_dpos, sp_dvel = sharded_vs_single(
        base.replace(n_cells=600, phase_std=0.0, light_x=-10.0, cell_capacity=8,
                     overflow_slots=8),
        (0.0, 2.0), 12, SMALL_VEL_ATOL, "overflow spill")
    if sp_stats["spill_rows_max"] <= 0:
        fail(f"overflow spill: spill rows stayed empty {sp_stats}")
    lines.append(
        f"phase 9 forced fallback 64 bots 50 u/s 16 steps: {fb_stats}, dpos "
        f"{fb_dpos:.2e} dvel {fb_dvel:.2e} (atol {TP_POS_ATOL}, {TP_VEL_ATOL}) | "
        f"overflow spill 600 bots 8+8 slots 12 steps: {sp_stats}, dpos {sp_dpos:.2e} "
        f"dvel {sp_dvel:.2e} (atol {TP_POS_ATOL}, {SMALL_VEL_ATOL})"
    )

    # the main path: 1,000 steps of the 10k sharded loop, counters reset
    # just before; the single-table loop at the same G and K beside it
    n_steps = 1000
    k = max(1, p.resolved_slot_rebuild_steps())
    out, stats, us_s, launches = timed_sharded(run, p, n_steps)
    check_launches("10k sharded", launches,
                   {"stencil_forces_ext": n_steps, "compact_padded": n_steps // k})
    if not np.isfinite(out.pos.cpu().numpy()).all() or cell_overflow(p, out):
        fail("10k sharded: non-finite state or cell overflow")
    single = make_run_chunk_table(p)
    st1 = single(pt.Simulation(p, device="cuda").state, 8)
    torch.cuda.synchronize()
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    st1 = single(st1, n_steps)
    torch.cuda.synchronize()
    us_1 = (time.perf_counter() - t0) * 1e6 / n_steps
    launches_1 = dict(kernels.LAUNCHES)
    held = {"sharded": out, "single": st1}

    def more_sharded():
        held["sharded"] = run(held["sharded"], 200)[0]

    def more_single():
        held["single"] = single(held["single"], 200)

    lines.append(
        f"phase 9 main path: 10k HEX sharded {n_steps} steps K={k}: {us_s:.1f} us/step, "
        f"launches {launches}, {stats}; single-table loop at G={g}: {us_1:.1f} us/step, "
        f"launches {launches_1} | 200 more steps each, device busy share: sharded "
        f"{busy_share(more_sharded, 200)}; single-table {busy_share(more_single, 200)}"
    )

    # 100,000 bots.  The auto rule gives spill rows only from 100,001 bots,
    # and at exactly 100,000 the HEX swarm parks bots beyond the 16 slots:
    # the auto config's parked count and global rebuilds are printed for
    # both loops.  The checked run adds the 8 spill rows the rule gives
    # above 100,000: bots above cell_capacity ride them; none may be parked.
    lines.append("phase 9 100k HEX auto config (no spill rows), 200 steps: " + auto_100k(base))
    run_big, pb = make_sharded_table_run(
        base.replace(n_cells=100_000, overflow_slots=8), LocalRing(N_SHARDS, "cuda"),
        with_stats=True)
    big, big_stats, us_big, big_launches = timed_sharded(run_big, pb, 200)
    big_spill = cell_overflow(pb, big)
    big_parked = cell_overflow(pb, big, cap=pb.storage_capacity())
    kb = max(1, pb.resolved_slot_rebuild_steps())
    if (not np.isfinite(big.pos.cpu().numpy()).all() or big_parked
            or big_launches["stencil_forces_ext"] != 200
            or big_launches["compact_padded"] != 200 // kb):
        fail(f"100k sharded: {big_parked} bots parked, launches {big_launches}")
    lines.append(
        f"phase 9 100k HEX sharded (G={pb.resolved_grid_dim()}, L0="
        f"{pb.resolved_grid_dim() ** 2 // N_SHARDS}, C={pb.cell_capacity}, Cs="
        f"{pb.storage_capacity()}) 200 steps: {us_big:.1f} us/step, launches "
        f"{big_launches}, {big_stats}, bots above cell_capacity {big_spill} (in "
        f"spill rows), parked 0"
    )
    lines.append(f"phase 9 DistRing: {dist_ring_check()}")

    record = [
        {"name": "stencil_forces_ext", "route": "cuda",
         "source": "particlerobotsimulations_torch/csrc/stencil_forces.cu",
         "replaces": "particlerobotsimulations_tpu/ops/pallas_stencil.py:570",
         "launches": launches["stencil_forces_ext"], "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain_ms,
         "bound_ms": k4_bound[0], "bound_by": k4_bound[1], "library_ms": None},
        {"name": "compact_padded", "route": "cuda",
         "source": "particlerobotsimulations_torch/csrc/compact.cu",
         "replaces": "particlerobotsimulations_tpu/ops/table_rebuild.py:203",
         "launches": launches["compact_padded"], "max_abs_err": k2p_err,
         "ms": k2p_ms, "plain_ms": k2p_plain_ms,
         "bound_ms": k2p_bound[0], "bound_by": k2p_bound[1], "library_ms": None},
    ]
    return record, lines


def light_gap(p, state) -> float:
    """Distance from the swarm's centroid to the light."""
    c = state.pos[: p.n_cells].mean(dim=0).cpu().numpy()
    return float(np.hypot(c[0] - p.light_x, c[1] - p.light_y))


def bot_tables(p, state):
    """Kernel 1's (C, G*G) tables of the per-bot collide at ``state``: the
    slot assignment anchored at the bare bounding box, then the scatter."""
    mask = active_mask(p, state.n_pad, state.device)
    slot, _ = assign_slots_slotmajor(p, state.pos, mask)
    payload = payload_mask(p, state.n_pad, state.device)
    return scatter_bot_tables(p, state.pos, state.vel, state.rad, mask, payload, slot)


def check_collide(name, p, got, want, ramp: bool) -> float:
    """max |diff| of one step's (vel, abs_force_a, abs_force_r) against
    another backend's from the same state: kernel 1's tolerance form on the
    magnitude sums, and dt times it on the velocities, whose force
    components cancel terms adding up to fa + fr; ``ramp`` adds RAMP_ULPS
    ulps of the magnet ramp (kernel 1's pair law against the JAX
    package's)."""
    law = K1_ATOL + (RAMP_ULPS * ramp_slope(p) * float(np.spacing(np.float32(0.2))) if ramp else 0.0)
    fa, fr = want.abs_force_a, want.abs_force_r
    err = 0.0
    dt = float(np.float32(p.timestep))
    for field, a, b, tol in (
        ("abs_force_a", got.abs_force_a, fa, law + K1_RTOL * fa.abs()),
        ("abs_force_r", got.abs_force_r, fr, K1_ATOL + K1_RTOL * fr.abs()),
        ("vel", got.vel, want.vel,
         1e-6 + 1e-6 * want.vel.abs() + dt * (law + K1_SUM_RTOL * (fa + fr))[:, None]),
    ):
        d = (a - b).abs()
        err = max(err, float(d.max()))
        if not torch.isfinite(a).all() or bool((d > tol).any()):
            fail(f"{name} {field}: {int((d > tol).sum())} rows beyond tolerance, "
                 f"worst |diff| {float(d.max())}")
    return err


def per_bot_phase(start):
    """Phase 10 from ``start``, the main path's state after phase 4;
    returns (kernel-1 launches of the PALLAS run, the PALLAS run's
    (params, end state), text lines)."""
    base = bench_params()
    arrays = state_to_arrays(start)
    n0 = start.step
    gated = [j for j in range(n0, n0 + PER_BOT_STEPS)
             if any(t_chunk.gates(base.validate(), j))]
    if gated:
        fail(f"per-bot window steps {n0}..{n0 + PER_BOT_STEPS} draws at {gated}")
    # the main path over the same steps: the centroid the per-bot runs
    # are held to
    p_tab = base.replace(force_backend=pt.ForceBackend.PALLAS).validate()
    d0 = light_gap(p_tab, start)
    ref = make_run_chunk_table(p_tab)(state_from_arrays(p_tab, arrays, "cuda"), PER_BOT_STEPS)
    ref_c = ref.pos[: p_tab.n_cells].mean(dim=0)
    lines = [
        f"phase 10 table loop (the main path) from step {n0}, {PER_BOT_STEPS} steps: "
        f"light distance {d0:.6f} -> {light_gap(p_tab, ref):.6f}"
    ]
    runs = {}
    for name in PER_BOT_BACKENDS:
        p = base.replace(force_backend=pt.ForceBackend[name]).validate()
        state = state_from_arrays(p, arrays, "cuda")
        step = make_step(p, "cuda")
        torch.cuda.synchronize()
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        for _ in range(PER_BOT_STEPS):
            state = step(state)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / PER_BOT_STEPS * 1e6
        launches = dict(kernels.LAUNCHES)
        want = {k: 0 for k in launches}
        if name == "PALLAS":
            want["stencil_forces"] = PER_BOT_STEPS
        if launches != want:
            fail(f"per-bot {name}: launches {launches}, expected {want}")
        d1 = light_gap(p, state)
        n = p.n_cells
        if not (torch.isfinite(state.pos[:n]).all() and torch.isfinite(state.vel[:n]).all()):
            fail(f"per-bot {name}: non-finite state after {PER_BOT_STEPS} steps")
        dc = float((state.pos[:n].mean(dim=0) - ref_c).abs().max())
        if dc > PER_BOT_CENTROID_ATOL or state.step != n0 + PER_BOT_STEPS:
            fail(f"per-bot {name}: centroid {dc} from the table loop's, step {state.step}")
        runs[name] = (p, state, launches["stencil_forces"])
        lines.append(
            f"phase 10 per-bot {name}: 10k HEX {PER_BOT_STEPS} steps through make_step "
            f"(G={p.resolved_grid_dim()}, C={p.cell_capacity}), {us:.1f} us/step, "
            f"kernel-1 launches {launches['stencil_forces']}, light distance "
            f"{d0:.6f} -> {d1:.6f} ({'toward' if d1 < d0 else 'away from'} the light), "
            f"centroid {dc:.2e} from the table loop's (atol {PER_BOT_CENTROID_ATOL})"
        )
    # one step of the three backends from the PALLAS run's end state
    p_k, common, k1_launches = runs["PALLAS"]
    outs = {
        name: make_step(p_k.replace(force_backend=pt.ForceBackend[name]), "cuda")(common)
        for name in PER_BOT_BACKENDS
    }
    torch.cuda.synchronize()
    e_sc = check_collide("STENCIL vs CELLGRID", p_k, outs["STENCIL"], outs["CELLGRID"], False)
    e_ps = check_collide("PALLAS vs STENCIL", p_k, outs["PALLAS"], outs["STENCIL"], True)
    e_pc = check_collide("PALLAS vs CELLGRID", p_k, outs["PALLAS"], outs["CELLGRID"], True)
    # kernel 1 against its twin on the per-bot path's own tables
    tables = bot_tables(p_k, common)
    g = p_k.resolved_grid_dim()
    cols = (tables["rad"] > 0).view(p_k.cell_capacity, g, g).sum(dim=(0, 1))
    if int(cols[0]) == 0:
        fail("per-bot tables: the bare bounding-box anchor left column 0 empty")
    k1_err = compare_stencil(p_k, tables)
    k1_ms = graph_ms(lambda: kernels.stencil_forces_cuda(p_k, tables))
    lines.append(
        f"phase 10 one step from the PALLAS run's end state: STENCIL vs CELLGRID "
        f"max|diff| {e_sc:.3e} (kernel 1's form: atol {K1_ATOL}, rtol {K1_RTOL}, vel "
        f"dt*(atol + {K1_SUM_RTOL}*(fa+fr))), PALLAS vs STENCIL {e_ps:.3e}, PALLAS vs "
        f"CELLGRID {e_pc:.3e} (+ {RAMP_ULPS} ulps of the magnet ramp) | kernel 1 vs twin "
        f"on the per-bot tables (rows in column 0: {int(cols[0])}, column G-1: "
        f"{int(cols[g - 1])}) max|diff| {k1_err:.3e}, {k1_ms * 1e3:.1f} us per launch "
        f"in a CUDA graph"
    )
    return k1_launches, (p_k, common), lines


def wide_tables(p, whole):
    """Kernel 4's halo-extended (S, C, E) tables of a whole (C, G*G) table
    cut into N_SHARDS shards, with the val plane from rad > 0."""
    full = dict(whole)
    full["val"] = (whole["rad"] > 0).float()
    full.setdefault("afac", torch.ones_like(whole["rad"]))
    g = p.resolved_grid_dim()
    ext = shard_halo(torch.stack([full[k] for k in KERNEL_FIELDS]), N_SHARDS, g)
    return {k: ext[:, j] for j, k in enumerate(KERNEL_FIELDS)}


def compare_wide(p, whole):
    """(kernel 1 max |diff|, kernel 4 max |diff|, kernel-4 tables) of both
    kernels against their twins on ``whole`` and its shards; kernel 4's
    centre lanes must equal kernel 1 bit for bit."""
    g, cap = p.resolved_grid_dim(), p.cell_capacity
    h, l0 = HALO_ROWS * g, g * g // N_SHARDS
    e1 = compare_stencil(p, whole)
    tables_ext = wide_tables(p, whole)
    got = kernels.stencil_forces_ext_cuda(p, tables_ext, h, l0)
    want = stencil_forces_ext_plain(p, tables_ext, h, l0)
    k1 = kernels.stencil_forces_cuda(p, whole)
    torch.cuda.synchronize()
    e4 = check_forces("stencil_forces_ext", got, want)
    for field, a, b in zip(("fx", "fy", "fa", "fr"), k1, got):
        if not torch.equal(a, b.permute(1, 0, 2).reshape(cap, g * g)):
            fail(f"C={cap}: kernel 1 and kernel 4's centre lanes differ in {field}")
    return e1, e4, tables_ext


def wide_slot_phase(real_params, real_state):
    """Phase 11; returns its text lines."""
    lines = []
    for cap in WIDE_CAPS:
        for payload in (False, True):
            p = pt.SimParams(
                n_cells=10_000, n_dead=-1 if payload else 0, attraction_factor=2.0,
                grid_dim=48, cell_capacity=cap,
            ).validate()
            syn = hole_tables(p, 31 + cap, fill=0.5)
            if not bool((syn["rad"][32:] > 0).any()):
                fail(f"C={cap}: the synthetic table leaves the second mask word empty")
            e1, e4, _ = compare_wide(p, syn)
            lines.append(
                f"phase 11 C={cap} synthetic {'payload' if payload else 'no payload'} "
                f"(G=48, half the slots occupied, up to "
                f"{int((syn['rad'] > 0).sum(dim=0).max())} bots per cell): kernel 1 "
                f"max|diff| {e1:.3e}, kernel 4 ({N_SHARDS} shards) {e4:.3e}, centre "
                f"lanes equal to kernel 1 bitwise"
            )
        p = real_params.replace(cell_capacity=cap).validate()
        real = bot_tables(p, real_state)
        real = {k: real[k] for k in ("px", "py", "vx", "vy", "rad")}
        e1, e4, tables_ext = compare_wide(p, real)
        line = (
            f"phase 11 C={cap} real (10k HEX after phase 10's {PER_BOT_STEPS} PALLAS "
            f"steps, G={p.resolved_grid_dim()}): kernel 1 max|diff| {e1:.3e}, kernel 4 "
            f"{e4:.3e}, centre lanes equal bitwise"
        )
        if cap == max(WIDE_CAPS):
            g = p.resolved_grid_dim()
            h, l0 = HALO_ROWS * g, g * g // N_SHARDS
            timed = {
                "k1_ms": graph_ms(lambda: kernels.stencil_forces_cuda(p, real)),
                "k1_plain_ms": median_ms(lambda: stencil_forces_plain(p, real)),
                "k1_bound": stencil_bound(p, real),
                "k4_ms": graph_ms(lambda: kernels.stencil_forces_ext_cuda(p, tables_ext, h, l0)),
                "k4_plain_ms": median_ms(lambda: stencil_forces_ext_plain(p, tables_ext, h, l0)),
                "k4_bound": stencil_ext_bound(p, real, tables_ext, l0),
            }
            line += (
                f" | C={cap} in a CUDA graph: kernel 1 {timed['k1_ms'] * 1e3:.1f} us "
                f"(plain {timed['k1_plain_ms'] * 1e3:.1f} us, bound (ms, by) "
                f"{timed['k1_bound']}), kernel 4 {timed['k4_ms'] * 1e3:.1f} us (plain "
                f"{timed['k4_plain_ms'] * 1e3:.1f} us, bound {timed['k4_bound']})"
            )
        lines.append(line)
    return lines


# ------------------------------------------------------ phase 12: the sweep

SWEEP_SEEDS = tuple(range(8))
# a batched sweep is held bit for bit, every scene, against the lockstep
# replay: each scene run alone through the single-scene table loop's parts
# and kernels, taking the batch's decisions (see lockstep_replay).  Each
# seed's free sequential run, whose rebuilds decide on that scene alone, is
# held bit for bit where neither run fell back or redid a segment; else its
# centroid distance is printed.  A centroid bound cannot stand in for that:
# from the placed lattice a fallback in one run and not the other parts
# them by up to the one-ulp envelope, which scripts/sweep_ulp_envelope.py
# measures on the card over these windows beside the centroid's movement
SCENE_FIELDS = ("pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r")


def scene_diff(a, b, n) -> tuple:
    """(dynamics bit for bit, ring max |diff| over its reorder bound) of two
    single-scene states.  The centroid ring, a record the dynamics never
    read, is the one field a batch reduces in another order: CUDA splits a
    sum over (B, rows) across blocks by the batch's size, so a scene's
    entry may differ from its solo run's in the last bits.  Its bound is
    that of a tree sum of the n centres reordered, over n: ceil(log2 n)
    float32 epsilons of the largest |coordinate|."""
    same = a.step == b.step and all(torch.equal(getattr(a, k), getattr(b, k))
                                    for k in SCENE_FIELDS)
    atol = math.ceil(math.log2(n)) * float(np.finfo(np.float32).eps) * float(
        a.pos[:n].abs().max())
    return same, float((a.centroid_ring - b.centroid_ring).abs().max()) / atol


def reset_counts() -> None:
    torch.cuda.synchronize()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    for k in REBUILDS:
        REBUILDS[k] = 0


def sweep_seg(params) -> int:
    """The gate segment ``run_sweep`` aligns its chunks to (0 off PALLAS)."""
    return gate_seg(params) if params.resolved_backend("cuda") == pt.ForceBackend.PALLAS else 0


def centroids_of(positions, n) -> torch.Tensor:
    """(B, 2) bot-mean centroids of single scenes' (n_pad, 2) positions,
    reduced on one (B, n, 2) stack as ``run_sweep`` reduces a batched state
    (a reduction's order depends on its shape)."""
    return torch.stack(positions)[..., :n, :].mean(dim=-2)


def sequential_runs(params, seeds, n_steps, record_every):
    """Each seed alone through ``engine.make_run_chunk``, chunked and
    aligned as ``run_sweep(strategy="sequential")`` runs it: (final states,
    centroids (n_records, B, 2), wall s, exact fallbacks and redos per
    scene)."""
    from particlerobotsimulations_torch.engine import make_run_chunk
    from particlerobotsimulations_torch.parallel.sweep import make_batch_state

    params = resolve_params(params.validate())
    n, seg = params.n_cells, sweep_seg(params)
    finals, recs, wall, falls = [], [], 0.0, []  # recs: each scene's record positions
    for seed in seeds:
        reset_counts()
        t0 = time.perf_counter()
        run = make_run_chunk(params, "cuda")
        state = scene_state(make_batch_state(params, [seed], "cuda"), 0)
        r, done = [state.pos], 0
        while done < n_steps:
            chunk = min(record_every, n_steps - done)
            state = run(state, chunk, seg > 0 and done % seg == 0)
            done += chunk
            r.append(state.pos)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        finals.append(state)
        recs.append(r)
        falls.append((REBUILDS["exact"], getattr(run, "redos", 0)))
    cents = torch.stack([centroids_of(list(at), n) for at in zip(*recs)])
    return finals, cents.cpu().numpy(), wall, falls


def lockstep_replay(params, seeds, n_steps, record_every):
    """The batched table loop's decisions, replayed on single scenes: every
    scene runs alone through the single-scene step parts and kernels, in
    lockstep with the others, chunked and aligned as ``run_sweep`` runs a
    batch.  A slot rebuild takes the incremental result for every scene
    only when every scene's preconditions held, else the exact rebuild for
    every scene; a span segment is redone on the regular path for every
    scene, from its entry state and draw state, when any scene's span
    rebuild failed.  Returns (final states, centroids (n_records, B, 2),
    counts of lockstep steps, rebuilds, exact rebuilds, spans and redos),
    each count once for all scenes, as the batched kernels launch."""
    from particlerobotsimulations_torch import rng
    from particlerobotsimulations_torch.engine_table import _derived_rows, _rebuild_fields
    from particlerobotsimulations_torch.ops.megakernel import make_mega_span, mega_eligible
    from particlerobotsimulations_torch.ops.table_rebuild import incremental_rebuild
    from particlerobotsimulations_torch.parallel.sweep import make_batch_state

    params = resolve_params(params.validate())
    n, seg = params.n_cells, sweep_seg(params)
    k = max(1, params.resolved_slot_rebuild_steps())
    bps = seg // k if seg > 0 else 0
    use_mega = mega_eligible(params) and bps > 1
    step_pre, step_post = make_table_step_parts(params)
    if use_mega:
        mega = make_mega_span(params, pt.config.padded_n(params))
        pack, unpack, incremental_packed = _make_mega_glue(params)
    counts = {"steps": 0, "rebuilds": 0, "exact": 0, "spans": 0, "redos": 0}

    def rebuild(tss):
        counts["rebuilds"] += 1
        outs = [incremental_rebuild(params, ts.fields, MOVE_FIELDS, ts.origin) for ts in tss]
        if all(bool(ok) for _, ok in outs):
            return [ts.replace(fields=_derived_rows(params, {**ts.fields, **moved}))
                    for ts, (moved, _) in zip(tss, outs)]
        counts["exact"] += 1
        out = []
        for ts in tss:
            fields, origin = _rebuild_fields(params, ts.fields)
            out.append(ts.replace(fields=fields, origin=origin))
        return out

    def one_step(tss, do_rebuild, post=True):
        gates = t_chunk.gates(params, tss[0].step)
        tss = [step_pre(ts, *gates) for ts in tss]
        if do_rebuild:
            tss = rebuild(tss)
        if post:
            counts["steps"] += 1
            tss = [step_post(ts) for ts in tss]
        return tss

    def regular(tss, n_steps):
        for j in range(n_steps):
            tss = one_step(tss, tss[0].step % k == k - 1 if k > 8 else j % k == k - 1)
        return tss

    def mega_seg(tss):
        entry = [(dict(ts.fields), ts.origin, ts.step, ts.centroid_ring,
                  rng.snapshot(ts.generator)) for ts in tss]
        for _ in range(k - 1):
            tss = one_step(tss, False)
        tss = one_step(tss, True, post=False)
        packed = [pack(ts.fields) for ts in tss]
        first, ok_all = tss[0].step + 1, True
        for b in range(bps - 1):
            counts["spans"] += 1
            counts["rebuilds"] += 1
            nxt = []
            for ts, (tbl, strip) in zip(tss, packed):
                tbl, strip = mega(tbl, strip, first + b * k)
                tbl, ok = incremental_packed(tbl, ts.origin)
                ok_all = ok_all and bool(ok)
                nxt.append((tbl, strip))
            packed = nxt
        if ok_all:
            counts["steps"] += 1
            return [step_post(ts.replace(fields=unpack(*tp), step=first + (bps - 1) * k - 1))
                    for ts, tp in zip(tss, packed)]
        counts["redos"] += 1
        out = []
        for ts, (fields, origin, step0, ring, snap) in zip(tss, entry):
            rng.restore(ts.generator, snap)
            out.append(ts.replace(fields=fields, origin=origin, step=step0, centroid_ring=ring))
        return regular(out, seg)

    states = [scene_state(make_batch_state(params, [s], "cuda"), 0) for s in seeds]
    recs, done = [centroids_of([st.pos for st in states], n)], 0
    while done < n_steps:
        chunk = min(record_every, n_steps - done)
        tss = [enter_table(params, st) for st in states]
        n_segs = chunk // seg if use_mega and done % seg == 0 else 0
        for _ in range(n_segs):
            tss = mega_seg(tss)
        tss = regular(tss, chunk - n_segs * seg)
        states = [exit_table(params, ts) for ts in tss]
        done += chunk
        recs.append(centroids_of([st.pos for st in states], n))
    return states, torch.stack(recs).cpu().numpy(), counts


def sweep_vs_sequential(name, params, n_steps, record_every, strategy):
    """One sweep of SWEEP_SEEDS through ``run_sweep`` by ``strategy`` (None:
    AUTO) on the card, held per scene bit for bit against its reference:
    the lockstep replay on a PALLAS table loop (its step glue through the
    row step's plain twin, :func:`twin_glue`), else (DENSE, no rebuild
    decisions) each seed's sequential run.  Each seed's free sequential
    run is timed beside it.  Returns (batched state, launches, the
    replay's counts or None, text)."""
    reset_counts()
    t0 = time.perf_counter()
    b_state, b_cents = run_sweep(params, list(SWEEP_SEEDS), n_steps, record_every=record_every,
                                 strategy=strategy, device="cuda")
    torch.cuda.synchronize()
    b_wall, b_launch, b_exact = time.perf_counter() - t0, dict(kernels.LAUNCHES), REBUILDS["exact"]
    s_states, s_cents, s_wall, s_fall = sequential_runs(params, SWEEP_SEEDS, n_steps, record_every)
    table = params.resolved_backend("cuda") == pt.ForceBackend.PALLAS
    counts = None
    if table:
        t0 = time.perf_counter()
        with twin_glue():
            r_states, r_cents, counts = lockstep_replay(params, SWEEP_SEEDS, n_steps,
                                                        record_every)
        r_wall = time.perf_counter() - t0
        if counts["exact"] != b_exact:
            fail(f"{name}: the batch took {b_exact} exact rebuilds, its replay {counts['exact']}")
    else:
        r_states, r_cents, r_wall = s_states, s_cents, 0.0
    n = params.n_cells
    to_ref, to_seq, dcent, dring, problems = [], [], 0.0, 0.0, []
    for b in range(len(SWEEP_SEEDS)):
        scene = scene_state(b_state, b)
        if not np.isfinite(b_cents[:, b]).all():
            problems.append(f"scene {b} not finite")
        (same_r, ring_r), (same_s, ring_s) = (scene_diff(scene, ref, n)
                                              for ref in (r_states[b], s_states[b]))
        dring = max(dring, ring_r)
        to_ref.append(same_r and ring_r <= 1.0 and np.array_equal(b_cents[:, b], r_cents[:, b]))
        to_seq.append(same_s and ring_s <= 1.0 and np.array_equal(b_cents[:, b], s_cents[:, b]))
        d = float(np.abs(b_cents[:, b] - s_cents[:, b]).max())
        dcent = max(dcent, d)
        if not to_ref[-1]:
            problems.append(f"scene {b} differs from its {'replay' if table else 'sequential run'}")
        if b_exact == 0 and (counts is None or counts["redos"] == 0) and s_fall[b] == (0, 0) \
                and not to_seq[-1]:
            problems.append(f"scene {b}: neither run fell back, yet it differs from its "
                            f"sequential run (centroid {d:.3e})")
    steps = n_steps * len(SWEEP_SEEDS)
    text = (
        f"{name}: {len(SWEEP_SEEDS)} seeds x {n_steps} steps of {n} bots, "
        f"{strategy or 'AUTO'} {b_wall * 1e6 / n_steps:.1f} us per batched step "
        f"({n * steps / b_wall:.4e} particle-steps/s, exact fallbacks {b_exact}, redos "
        f"{counts['redos'] if counts else 0}) vs sequential {s_wall * 1e6 / steps:.1f} us per "
        f"scene-step ({n * steps / s_wall:.4e} particle-steps/s, (fallbacks, redos) per scene "
        f"{s_fall}); batched == {'lockstep replay' if table else 'sequential'} bit for bit "
        f"in {sum(to_ref)}/{len(to_ref)} scenes (the centroid ring at up to {dring:.3f} of "
        f"its reorder bound)"
        + (f" (replay {r_wall:.1f} s, {counts})" if table else "")
        + f"; vs the free sequential runs: bit for bit in {sum(to_seq)}/{len(to_seq)} "
        f"scenes, centroid max |diff| {dcent:.3e}"
    )
    if problems:
        print(f"phase 12 sweep {text}")
        fail(f"{name}: " + "; ".join(problems))
    return b_state, b_launch, counts, text


# the kernel-2 launches: one per rebuild, whichever path it took
COMPACTIONS = ("compact", "compact_batched", "compact_padded", "compact_padded_batched")


# the row step's launch counters, one scene and B scenes, and the parts of
# a block's glue schedule that launch it
ROW_STEP_KEYS = ("row_step", "row_step_batched")
ROW_PARTS = ("pre", "post_pre", "post")


def row_step_launches(p, chunks, redos=0) -> int:
    """The row-step launches of the table runner (one scene or a batch)
    over ``chunks``, ``(first step, steps, seg-aligned)`` each, with
    ``redos`` segments redone: a span segment launches k + 1 (its first
    block's pre and k - 1 post_pre before the rebuild, the adopt's post), a
    redone one its bps regular blocks of k + 1 in place of that post; the
    steps outside segments run ``table_pieces``' blocks, each
    ``glue_schedule``'s row-step parts."""
    k = max(1, p.resolved_slot_rebuild_steps())
    seg = gate_seg(p)
    bps = seg // k if seg > 0 else 0
    use_mega = mega_eligible(p) and bps > 1
    n = redos * (bps * (k + 1) - 1)
    for start, steps, aligned in chunks:
        n_segs = steps // seg if use_mega and aligned else 0
        n += n_segs * (k + 1)
        for pattern in table_pieces(p, k, start + n_segs * seg, steps - n_segs * seg):
            n += sum(part in ROW_PARTS for part, _ in glue_schedule(pattern))
    return n


@contextlib.contextmanager
def twin_glue():
    """The row step's plain twin, the PyTorch ops, in place of its kernel
    (``ops/row_step.row_step`` reaches the kernel through the ``kernels``
    module): a run inside holds the table loop's step glue against plain
    PyTorch, and counts no row-step launch."""
    real = kernels.row_step_cuda
    kernels.row_step_cuda = row_step_plain
    try:
        yield
    finally:
        kernels.row_step_cuda = real


def check_launches(name, launches, want) -> None:
    """``launches`` equal ``want`` (zero where not named) apart from
    ``cond_set``, which a graph launches once for each rebuild it replays
    (an eager rebuild selects): at most one per compaction."""
    full = {k: 0 for k in kernels.LAUNCHES if k != "cond_set"}
    full.update(want)
    got = {k: v for k, v in launches.items() if k != "cond_set"}
    if got != full or not 0 <= launches["cond_set"] <= sum(launches[k] for k in COMPACTIONS):
        fail(f"{name}: launches {launches}, want {full} and cond_set at most one per rebuild")


def batched_kernel_checks(p10, state10, pb, state_b):
    """Kernels 1 and 2 on the 10k sweep's eight tables and kernel 3 on the
    band sweep's eight, one launch each: bit for bit the eight single-scene
    launches, within tolerance of the twins, and timed in a CUDA graph
    beside the eight single launches."""
    out = {}
    b = len(SWEEP_SEEDS)
    g, cap, cs = p10.resolved_grid_dim(), p10.cell_capacity, p10.storage_capacity()
    gg = g * g
    ts = enter_table(p10, state10)
    tables = {k: ts.fields[k][:, : cap * gg].unflatten(-1, (cap, gg))
              for k in ("px", "py", "vx", "vy", "rad", "afac")}
    singles = [{k: v[i].contiguous() for k, v in tables.items()} for i in range(b)]
    got = kernels.stencil_forces_batched_cuda(p10, tables)
    err = 0.0
    for i in range(b):
        one = kernels.stencil_forces_cuda(p10, singles[i])
        if not all(torch.equal(x[i], y) for x, y in zip(got, one)):
            fail(f"batched stencil_forces: scene {i} differs from its single launch")
        err = max(err, check_forces(f"batched stencil_forces scene {i}",
                                    [x[i] for x in got], stencil_forces_plain(p10, singles[i])))
    n_bytes, n_ops = 0.0, 0.0
    for one in singles:
        n_bytes += (5 + 4) * one["px"].numel() * 4
        n_ops += PAIR_OPS * occupied_pairs(p10, one["rad"])
    out["stencil_forces_batched"] = {
        "err": err,
        "ms": graph_ms(lambda: kernels.stencil_forces_batched_cuda(p10, tables)),
        "singles_ms": graph_ms(lambda: [kernels.stencil_forces_cuda(p10, t) for t in singles]),
        "plain_ms": median_ms(lambda: stencil_forces_batched_plain(p10, tables), 5, 3),
        "bound": bound(n_bytes, n_ops),
    }

    step = make_table_step(p10)
    for _ in range(7):
        ts = step(ts, False, False, False, False)
    planes = torch.stack([ts.fields[k][:, : cs * gg] for k in MOVE_FIELDS], dim=1)
    planes = planes.unflatten(-1, (cs, gg))
    dxf, dyf, _, _ = torch.func.vmap(
        lambda pl, o: rebuild_move_planes(p10, pl, MOVE_FIELDS, o)
    )(planes, ts.origin)
    stacked = torch.cat([planes, dxf[:, None], dyf[:, None]], dim=1).contiguous()
    c_out, c_inc = kernels.compact_batched_cuda(p10, stacked)
    for i in range(b):
        o1, i1 = kernels.compact_cuda(p10, stacked[i].contiguous())
        op, ip = compact_plain(p10, stacked[i])
        if not (torch.equal(c_out[i], o1) and torch.equal(c_inc[i], i1)):
            fail(f"batched compact: scene {i} differs from its single launch")
        if not (torch.equal(c_inc[i], ip) and bool((c_out[i] == op).all())):
            fail(f"batched compact: scene {i} differs from the twin")
    bounds2 = [compact_bound(stacked[i]) for i in range(b)]
    out["compact_batched"] = {
        "err": 0.0,
        "ms": graph_ms(lambda: kernels.compact_batched_cuda(p10, stacked)),
        "singles_ms": graph_ms(
            lambda: [kernels.compact_cuda(p10, stacked[i]) for i in range(b)]
        ),
        "plain_ms": median_ms(lambda: compact_plain(p10, stacked), 5, 3),
        # the eight stacks' bounds add: one launch does all their work
        "bound": (sum(x[0] for x in bounds2), bounds2[0][1]),
    }

    tsb = enter_table(pb, state_b)
    tsb = make_table_step_parts(pb)[0](tsb, *t_chunk.gates(pb, tsb.step))
    tbl, strip = _make_mega_glue(pb)[0](tsb.fields)
    tbl, strip = tbl.contiguous(), strip.contiguous()
    first = step_tensor(tsb.step + 1, tbl.device)
    s_tbl = [tbl[i].contiguous() for i in range(b)]
    s_strip = [strip[i].contiguous() for i in range(b)]
    got3 = kernels.mega_span_batched_cuda(pb, tbl, strip, first)
    err3 = 0.0
    for i in range(b):
        one = kernels.mega_span_cuda(pb, s_tbl[i], s_strip[i], first)
        if not (torch.equal(got3[0][i], one[0]) and torch.equal(got3[1][i], one[1])):
            fail(f"batched mega_span: scene {i} differs from its single launch")
        e, _ = compare_span(f"batched scene {i}", pb, s_tbl[i], s_strip[i], first,
                            got=(got3[0][i], got3[1][i]))
        err3 = max(err3, e)
    spans = [span_bound(pb, s_tbl[i], s_strip[i]) for i in range(b)]
    lib = kernels.library_mega_plan(pb.storage_capacity(), pb.resolved_grid_dim(),
                                    pt.config.padded_n(pb), pb.has_payload, scenes=b)
    out["mega_span_batched"] = {
        "err": err3,
        "ms": graph_ms(lambda: kernels.mega_span_batched_cuda(pb, tbl, strip, first)),
        "singles_ms": graph_ms(lambda: [
            kernels.mega_span_cuda(pb, s_tbl[i], s_strip[i], first) for i in range(b)
        ]),
        "plain_ms": median_ms(lambda: mega_span_batched_plain(pb, tbl, strip, first), 2, 3),
        # the eight spans' bounds add: one launch does all their work
        "bound": (sum(x[0] for x in spans), spans[0][1]),
        "ctas": lib["ctas"], "resident": lib["max_active_clusters"],
    }
    return out


def run_cli_inprocess(argv) -> tuple:
    """(exit code, stdout lines, seconds) of the port's CLI in this
    process, on the card."""
    from contextlib import redirect_stdout
    from io import StringIO

    from particlerobotsimulations_torch.cli import main as cli_main

    buf = StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        rc = cli_main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    return rc, buf.getvalue().strip().splitlines(), time.perf_counter() - t0


def sweep_phase():
    """Phase 12: the seed sweep on the card.  Three sweeps of eight seeds
    against their sequential runs, with the launch counts checked (kernel 1
    once per batched step, kernel 2 once per rebuild, kernel 3 once per
    span, the row step as the blocks' schedules give it, whatever the
    number of scenes); the batched kernels against eight
    single launches and their twins; the CLI's sweep and experiment.
    Returns (the batched kernels' records, their launches, the 10k sweep's
    final state)."""
    counts = {"stencil_forces_batched": 0, "compact_batched": 0, "mega_span_batched": 0,
              "row_step_batched": 0}
    b = len(SWEEP_SEEDS)

    # the 10k sweep: bench.py's workload, AUTO batched at the K the params
    # resolve (4; the batched loop takes no adaptive cadence)
    p10 = resolve_params(bench_params().validate())
    if choose_sweep_strategy(p10, b) != "batched":
        fail("10k sweep: AUTO did not choose batched")
    n10, rec10 = 200, 100
    t0 = time.perf_counter()
    s10, launch, rep, text = sweep_vs_sequential("10k HEX", p10, n10, rec10, None)
    k = p10.resolved_slot_rebuild_steps()
    rebuilds = (n10 // rec10) * (rec10 // k)
    if (rep["steps"], rep["rebuilds"], rep["spans"]) != (n10, rebuilds, 0):
        fail(f"10k sweep: the replay took {rep}, want {n10} steps and {rebuilds} rebuilds")
    check_launches("10k sweep", launch, {
        "stencil_forces_batched": n10, "compact_batched": rebuilds,
        "row_step_batched": row_step_launches(
            p10, [(c * rec10, rec10, True) for c in range(n10 // rec10)]),
    })
    for key in counts:
        counts[key] += launch[key]
    print(f"phase 12 sweep {text}; launches {launch}; {time.perf_counter() - t0:.1f} s")

    # example.cfg: 300 bots, AUTO: DENSE, batched
    pe = resolve_params(pt.load_cfg(os.path.join(ROOT, "examples", "example.cfg")).validate())
    if choose_sweep_strategy(pe, b) != "batched" or pe.resolved_backend("cuda") != pt.ForceBackend.DENSE:
        fail("example.cfg sweep: not DENSE batched under AUTO")
    t0 = time.perf_counter()
    _, launch, _, text = sweep_vs_sequential("dense", pe, 200, 100, None)
    check_launches("example.cfg sweep", launch, {"dense_step_batched": 200})
    print(f"phase 12 sweep example.cfg {text}; {time.perf_counter() - t0:.1f} s")

    # the band scene forced batched: the batched span path
    pb = resolve_params(band_params().validate())
    if choose_sweep_strategy(pb, b) != "sequential":
        fail("band sweep: AUTO did not choose sequential")
    seg = gate_seg(pb)
    kb = pb.resolved_slot_rebuild_steps()
    nb = 2 * seg
    t0 = time.perf_counter()
    sb, launch, rep, text = sweep_vs_sequential("band", pb, nb, nb, "batched")
    # a redone segment adds its regular steps and rebuilds to the k - 1
    # steps and the rebuild before its first span
    n_segs, bps, r = nb // seg, seg // kb, rep["redos"]
    want = {
        "mega_span_batched": n_segs * (bps - 1),
        "compact_batched": n_segs * bps + r * bps,
        "stencil_forces_batched": n_segs * kb + r * (seg - 1),
    }
    if (rep["spans"], rep["rebuilds"], rep["steps"]) != tuple(want.values()):
        fail(f"band sweep: the replay took {rep}, want {want}")
    check_launches("band sweep", launch,
                   {**want, "row_step_batched": row_step_launches(pb, [(0, nb, True)], r)})
    for key in counts:
        counts[key] += launch[key]
    print(f"phase 12 sweep {text}; launches {launch}; {time.perf_counter() - t0:.1f} s")

    kc = batched_kernel_checks(p10, s10, pb, sb)
    for name, v in kc.items():
        extra = (f", {v['ctas']} CTAs, {v['resident']} clusters resident at once"
                 if "ctas" in v else "")
        print(
            f"phase 12 {name} B={b}: bit for bit {b} single launches, max|diff| vs "
            f"twin {v['err']:.3e}; {v['ms'] * 1e3:.1f} us per launch in a CUDA graph vs "
            f"{v['singles_ms'] * 1e3:.1f} us for {b} single launches, plain "
            f"{v['plain_ms'] * 1e3:.1f} us, bound (ms, by) "
            f"({v['bound'][0]:.4g}, {v['bound'][1]}){extra}"
        )

    for argv in (
        ["experiment", "robustness", os.path.join(ROOT, "examples", "example_dead_cells.cfg"),
         "--seeds", "0:4", "--sim-seconds", "10"],
        ["sweep", os.path.join(ROOT, "examples", "example.cfg"), "--seeds", "0:4",
         "--steps", "600"],
    ):
        rc, out, secs = run_cli_inprocess(argv)
        if rc != 0 or len(out) < 2 or not all(
            np.isfinite(float(x)) for ln in out[1:] if not ln.startswith("#")
            for x in ln.split(",")
        ):
            fail(f"cli {' '.join(argv[:2])}: rc {rc}, output {out}")
        what = argv[1] if argv[0] == "experiment" else os.path.basename(argv[1])
        print(f"phase 12 cli {argv[0]} {what} in {secs:.1f} s: {out[0]} | "
              + " | ".join(out[1:]))

    # the gap scene's RANDOM layout needs G=32 (ROADMAP queue 3): the
    # regular batched loop, two seeds
    from particlerobotsimulations_torch.models.experiments import gap_transit

    pg = pt.load_cfg(os.path.join(ROOT, "examples", "example_gap.cfg")).replace(grid_dim=32)
    reset_counts()
    t0 = time.perf_counter()
    gap = gap_transit(pg, [0, 1], 1.0, device="cuda")
    torch.cuda.synchronize()
    if not (np.isfinite(gap["centroids"]).all() and kernels.LAUNCHES["stencil_forces_batched"] == 100
            and kernels.LAUNCHES["mega_span_batched"] == 0):
        fail(f"gap_transit at G=32: {gap}, launches {kernels.LAUNCHES}")
    print(f"phase 12 gap_transit example_gap.cfg at grid_dim 32, 2 seeds x 100 steps "
          f"({choose_sweep_strategy(resolve_params(pg.validate()), 2)}) in "
          f"{time.perf_counter() - t0:.1f} s: fraction past the wall "
          f"{gap['frac_past_wall'].tolist()}, launches {dict(kernels.LAUNCHES)}")
    return kc, counts, s10


# ---------------------------- phase 13: checkpoints, video, the gradient path

# phase 13's shapes: the recorder at the reference's 1920x1080 MJPG; the
# 10k run's 3,000 steps through Simulation.run and the 1,000 of each
# continuation; the differentiable rollouts' horizon and optimizer steps
FRAME_W, FRAME_H = 1920, 1080
CK_STEPS, CK_MORE = 3000, 1000
DIFF_STEPS, OPT_ITERS = 20, 2
# the 10k PALLAS rollout's phase gradient against STENCIL's: the same
# backward, on forward trajectories that part by float reassociation (kernel
# 1's pair sums and pair law against STENCIL's).  Over DIFF_SHORT_STEPS
# (the phase reaches a position through the radius, then the collide's
# velocity, so the gradient is zero before 2 steps) the two must agree to
# DIFF_REL_L2_SHORT (relative L2); over DIFF_STEPS the gap grows with the
# contact dynamics' sensitivity, which is measured beside it as STENCIL's
# own gap to STENCIL from positions moved by one ulp, and must stay within
# DIFF_REL_L2_BOUND.  On an H100 (80GB HBM3, 700 W) from the 10k state at
# step 3,000: 4.9e-5 after 3 steps, 0.247 after 20, where one ulp moves
# STENCIL's own 20-step gradient by 1.02 (relative L2): at 10k the 20-step
# gradient is as sensitive as that, so its bound fails only a gradient of
# another size or direction
DIFF_SHORT_STEPS, DIFF_REL_L2_SHORT = 3, 1e-3
DIFF_REL_L2_BOUND = 0.5
# the JAX package's tolerance for its custom VJP against DENSE
# (tests/test_optimize.py, 24 bots, 40 steps)
DIFF_RTOL, DIFF_ATOL, DIFF_BLOB_STEPS = 2e-2, 2e-4, 40


def clone_state(state):
    """A copy of a single or batched state whose generators stand at the
    same point as the original's, so that a later run of the original does
    not move them."""
    def gen_copy(g):
        out = torch.Generator(device=g.device)
        out.set_state(g.get_state())
        return out

    src = state.generator
    gen = (SceneDraws([gen_copy(g) for g in src.sources]) if isinstance(src, SceneDraws)
           else gen_copy(src))
    return state.replace(generator=gen, **{k: getattr(state, k).clone() for k in ARRAY_FIELDS})


def states_equal(a, b) -> bool:
    return a.step == b.step and all(
        torch.equal(getattr(a, k), getattr(b, k)) for k in ARRAY_FIELDS
    )


def avi_frames(path) -> tuple:
    """(width, height, frame count, each frame's payload) of an AVI the
    port wrote, read back through its idx1 index."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        fail(f"{path}: not an AVI")
    if struct.unpack("<I", data[4:8])[0] != len(data) - 8:
        fail(f"{path}: RIFF size is not the file's")
    total, = struct.unpack("<I", data[48:52])
    width, height = struct.unpack("<II", data[64:72])
    movi, idx1 = data.find(b"movi"), data.rfind(b"idx1")
    payloads = []
    for i in range(struct.unpack("<I", data[idx1 + 4: idx1 + 8])[0] // 16):
        ckid, _, off, size = struct.unpack("<4sIII", data[idx1 + 8 + 16 * i: idx1 + 24 + 16 * i])
        if data[movi + off: movi + off + 4] != ckid:
            fail(f"{path}: index entry {i} does not point at its chunk")
        payloads.append(data[movi + off + 8: movi + off + 8 + size])
    return width, height, total, payloads


def timed_run(sim, max_time, csv, **kw) -> float:
    if sim.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(max_time=max_time, csv_path=csv, echo=False, **kw)
    if sim.device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def checkpoint_video_phase(tmp, params, steps=CK_STEPS, more=CK_MORE, device="cuda",
                           size=(FRAME_W, FRAME_H)) -> tuple:
    """13a: bench.py's workload through ``Simulation.run`` for ``steps``
    steps with a checkpoint every dump and a 1920x1080 MJPG recorder as
    the frame callback; then ``from_checkpoint`` and ``Simulation(params,
    state=<the saved state>)`` each ``more`` steps, bit for bit and with
    equal launch counts, and the uninterrupted run (the recorder still
    on) ``more`` steps beside them.  Returns (text, the saved state,
    params, kernel-1 and kernel-2 launches of the recorded run)."""
    dt = params.timestep
    sim = pt.Simulation(params, device=device)
    p = sim.params
    ck, avi = os.path.join(tmp, "ck10k.npz"), os.path.join(tmp, "v10k.avi")
    rec = VideoRecorder(p, path=avi, width=size[0], height=size[1], codec="MJPG")
    frame_s = []

    def capture(s):
        t0 = time.perf_counter()
        rec.capture(s)
        frame_s.append(time.perf_counter() - t0)

    reset_counts()
    run_s = timed_run(sim, steps * dt, os.path.join(tmp, "a.csv"), checkpoint_path=ck,
                      checkpoint_every_dumps=1, frame_callback=capture)
    launched = dict(kernels.LAUNCHES)
    if sim.state.step != steps:
        fail(f"13a: the recorded run ended at step {sim.state.step}")
    saved = clone_state(sim.state)
    _, loaded = load_checkpoint(ck, device=device)
    if not states_equal(loaded, saved) or not torch.equal(
            loaded.generator.get_state(), saved.generator.get_state()):
        fail("13a: the final checkpoint does not hold the run's state")
    ck_bytes = os.path.getsize(ck)
    save_ms, load_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(tmp, "again.npz"), p, saved)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        load_checkpoint(ck, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        load_ms.append((time.perf_counter() - t0) * 1e3)

    end = (steps + more) * dt
    a_s = timed_run(sim, end, os.path.join(tmp, "a2.csv"), frame_callback=capture)
    rec.close()
    reset_counts()
    b = pt.Simulation.from_checkpoint(ck, device=device)
    b_s = timed_run(b, end, os.path.join(tmp, "b.csv"))
    lb = dict(kernels.LAUNCHES)
    reset_counts()
    c = pt.Simulation(p, state=saved, device=device)
    c_s = timed_run(c, end, os.path.join(tmp, "c.csv"))
    lc = dict(kernels.LAUNCHES)
    if not states_equal(b.state, c.state):
        fail("13a: from_checkpoint and Simulation(params, state=saved) parted")
    keys = ("stencil_forces", "compact")
    if any(lb[k] != lc[k] for k in keys):
        fail(f"13a: launches differ: from_checkpoint {lb}, in memory {lc}")
    n = p.n_cells
    gap = (sim.state.pos[:n] - b.state.pos[:n]).abs().max().item()
    cgap = (sim.state.pos[:n].mean(0) - b.state.pos[:n].mean(0)).abs().max().item()

    width, height, total, payloads = avi_frames(avi)
    if (width, height) != size or total != len(frame_s) or len(payloads) != total:
        fail(f"13a: AVI {width}x{height} with {total} frames ({len(payloads)} indexed), "
             f"want {size} and {len(frame_s)}")
    if not all(f[:2] == b"\xff\xd8" and f[-2:] == b"\xff\xd9" for f in payloads):
        fail("13a: an AVI frame is not a whole JPEG")
    lib = render_native._LIB
    if lib is None or lib.path != render_native.library_path():
        fail(f"13a: the native renderer in use is not the one built from source: {lib}")
    text = (
        f"10k HEX Simulation.run {steps} steps with a checkpoint every dump and a "
        f"{size[0]}x{size[1]} MJPG recorder: {run_s:.2f} s, "
        f"{n * steps / run_s:.4e} particle-steps/s, {len(frame_s)} frames, launches "
        f"{ {k: launched[k] for k in keys} } | checkpoint {ck_bytes} bytes, save "
        f"{statistics.median(save_ms):.1f} ms, load {statistics.median(load_ms):.1f} ms | "
        f"{more} more steps: from_checkpoint == Simulation(params, state=saved) bit for "
        f"bit (every field, step, ring), launches {dict((k, lb[k]) for k in keys)} each; "
        f"{n * more / b_s:.4e} and {n * more / c_s:.4e} particle-steps/s without the "
        f"recorder vs {n * more / a_s:.4e} with it (the uninterrupted run); gap to the "
        f"uninterrupted run: max |dpos| {gap:.3e}, centroid {cgap:.3e} | AVI parsed "
        f"back: {total} frames of {width}x{height}, JPEG {min(map(len, payloads))}-"
        f"{max(map(len, payloads))} bytes, {statistics.median(frame_s) * 1e3:.1f} ms per "
        f"rendered frame (median), native {lib.path.name}"
    )
    return text, saved, p, {k: launched[k] + lb[k] + lc[k] for k in keys}


def cli_resume_phase(tmp, device="cuda", first="120", last="180",
                     cfg=os.path.join(ROOT, "examples", "example.cfg")) -> tuple:
    """13b: ``cli simulate examples/example.cfg --backend pallas`` (300
    bots, the span path) with ``--video --checkpoint --checkpoint-every
    1`` to ``first`` sim-s, then ``--resume`` to ``last``, in a
    directory of its own (the video goes to the cfg's video_filename).
    The CSV continues on the dump grid with one header and no duplicate
    row; the resumed state equals a one-call run's (the same chunks: the
    frame cadence's) bit for bit.  Returns (text, kernel-3 launches)."""
    from contextlib import redirect_stderr
    from io import StringIO

    from particlerobotsimulations_torch.cli import main as cli_main

    csv, ck = os.path.join(tmp, "cli.csv"), os.path.join(tmp, "cli.ck")
    common = ["simulate", cfg, "--backend", "pallas", "--csv", csv, "--quiet",
              "--device", device, "--video", "--checkpoint", ck, "--checkpoint-every", "1"]
    here = os.getcwd()
    os.chdir(tmp)
    try:
        reset_counts()
        errs, secs = [], []
        for extra in (["--max-time", first], ["--resume", "--max-time", last]):
            buf = StringIO()
            t0 = time.perf_counter()
            with redirect_stderr(buf):
                rc = cli_main(common + extra)
            secs.append(time.perf_counter() - t0)
            if rc != 0:
                fail(f"13b: cli {extra} exited {rc}: {buf.getvalue()[-2000:]}")
            errs.append(buf.getvalue().strip().splitlines())
        launched = dict(kernels.LAUNCHES)
        params = pt.load_cfg(cfg).replace(force_backend=pt.ForceBackend.PALLAS,
                                          max_time=float(last))
        one = pt.Simulation(params, device=device)
        one.run(csv_path=os.path.join(tmp, "one.csv"), echo=False,
                frame_callback=lambda s: None)
        _, resumed = load_checkpoint(ck, device=device)
        _, _, frames, _ = avi_frames(os.path.join(tmp, params.video_filename))
        with open(csv, encoding="utf-8") as f:
            lines = f.read().splitlines()
    finally:
        os.chdir(here)
    times = [float(r.split(",")[0]) for r in lines[2:]]
    dump = params.dump_steps
    want = [float(f"{i * dump * params.timestep:.6f}")
            for i in range(params.n_steps() // dump + 1)]
    if lines[0] != "Seed, 5555" or any(r.startswith("Seed") for r in lines[1:]) or times != want:
        fail(f"13b: CSV header {lines[:2]}, rows at {times}, want {want}")
    if f"resumed at t = {first} s" not in errs[1][0] or "span path" not in errs[1][-1]:
        fail(f"13b: cli said {errs}")
    if not states_equal(resumed, one.state):
        gap = (resumed.pos - one.state.pos).abs().max().item()
        fail(f"13b: the resumed run parted from the one-call run (max |dpos| {gap:.3e})")
    text = (
        f"cli example.cfg pallas --video --checkpoint to {first} s ({secs[0]:.1f} s), "
        f"--resume to {last} s ({secs[1]:.1f} s, {frames} frames): CSV rows at "
        f"{times} with one header; resumed == one-call run bit for bit; launches "
        f"{ {k: v for k, v in launched.items() if v} }; {errs[1][-1]}"
    )
    return text, launched["mega_span"]


def rollout_grad(params, n_steps, state, phase0, device="cuda"):
    """(value, phase gradient of the real bots, seconds) of one
    value-and-grad of ``make_phase_rollout``."""
    rollout = make_phase_rollout(params, n_steps, device=device)
    ph = phase0.clone().requires_grad_()
    t0 = time.perf_counter()
    v = rollout(ph, state)
    v.backward()
    if device == "cuda":
        torch.cuda.synchronize()
    return v.detach(), ph.grad[: params.n_cells], time.perf_counter() - t0


def ulp_moved(state, seed=0):
    """``state`` with every real bot's coordinates moved by one ulp, each
    in a random direction."""
    pos = state.pos
    gen = torch.Generator(device=pos.device).manual_seed(seed)
    up = torch.rand(pos.shape, generator=gen, device=pos.device) < 0.5
    inf = torch.full_like(pos, float("inf"))
    return state.replace(pos=torch.nextafter(pos, torch.where(up, inf, -inf)))


def diff_phase(state, p, device="cuda", steps=DIFF_STEPS) -> tuple:
    """13c: the differentiable path at 10k on PALLAS from ``state`` (the
    main path's, after the phase gate): the rollout's value against a
    plain ``make_step`` run of the frozen params (bit for bit: the same
    kernel forward), its gradient finite, nonzero and within
    DIFF_REL_L2_BOUND of STENCIL's, kernel 1 launched twice per step;
    ``optimize_phases`` for OPT_ITERS iterations; and a 24-bot blob's
    PALLAS gradient against DENSE at the JAX package's tolerance.
    Returns (text, kernel-1 launches)."""
    pp = p.replace(force_backend=pt.ForceBackend.PALLAS)
    phase0 = state.phase.detach().clone()
    n = p.n_cells
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    v, g, vg_s = rollout_grad(pp, steps, state, phase0, device)
    k1 = kernels.LAUNCHES["stencil_forces"]
    peak_vg = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if k1 != 2 * steps and device == "cuda":
        fail(f"13c: {k1} kernel-1 launches in a {steps}-step value-and-grad, want {2 * steps}")
    frozen = pp.replace(control=pt.Control.FIXED_PHASE, phase_std=0.0)
    step = make_step(frozen, device)
    s = state.replace(phase=phase0)
    for _ in range(steps):
        s = step(s)
    mask = active_mask(p, state.n_pad, state.device)
    x = s.pos[:, 0]
    plain = torch.sum(torch.where(mask, x, torch.zeros_like(x))) / np.float32(n)
    if not torch.equal(v, plain):
        fail(f"13c: rollout value {v.item()!r} != plain make_step {plain.item()!r}")
    ps = p.replace(force_backend=pt.ForceBackend.STENCIL)
    _, gs, st_s = rollout_grad(ps, steps, state, phase0, device)
    if not (torch.isfinite(g).all() and g.abs().max() > 0):
        fail("13c: the PALLAS rollout gradient is not finite or is zero")

    def rel_l2(a, b):
        return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()

    rel = rel_l2(g, gs)
    short = DIFF_SHORT_STEPS
    rel1 = rel_l2(rollout_grad(pp, short, state, phase0, device)[1],
                  rollout_grad(ps, short, state, phase0, device)[1])
    env = rel_l2(rollout_grad(ps, steps, ulp_moved(state), phase0, device)[1], gs)
    print(f"phase 13c gradient gaps: PALLAS vs STENCIL after {short} steps {rel1:.3e}, after "
          f"{steps} {rel:.3e}; STENCIL vs STENCIL from positions one ulp away after "
          f"{steps} {env:.3e}", flush=True)
    if not rel1 <= DIFF_REL_L2_SHORT:
        fail(f"13c: PALLAS gradient vs STENCIL's after {short} steps: relative L2 {rel1:.3e}")
    if not rel <= DIFF_REL_L2_BOUND:
        fail(f"13c: PALLAS gradient vs STENCIL's: relative L2 {rel:.3e} > {DIFF_REL_L2_BOUND}")

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    k0 = kernels.LAUNCHES["stencil_forces"]
    t0 = time.perf_counter()
    _, hist = optimize_phases(pp, state, n_steps=steps, iters=OPT_ITERS, lr=0.05,
                              phase0=phase0)
    opt_s = time.perf_counter() - t0
    k_opt = kernels.LAUNCHES["stencil_forces"] - k0
    peak_opt = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if device == "cuda" and k_opt != OPT_ITERS * 2 * steps + steps:
        fail(f"13c: optimize_phases launched kernel 1 {k_opt} times")
    if not np.isfinite(hist).all():
        fail(f"13c: optimize_phases history {hist}")

    blob = pt.Simulation(pt.SimParams(n_cells=24, n_dead=0, seed=3, config=pt.Config.HEX,
                                      light_x=-5.0, light_y=0.0), device=device)
    bp0 = torch.tensor((0.1 * np.random.default_rng(1).standard_normal(blob.state.n_pad))
                       .astype(np.float32), device=blob.state.device)
    grads = {
        b: rollout_grad(blob.params.replace(force_backend=b), DIFF_BLOB_STEPS, blob.state,
                        bp0, device)[1].cpu().numpy()
        for b in (pt.ForceBackend.DENSE, pt.ForceBackend.PALLAS)
    }
    gd, gp = grads[pt.ForceBackend.DENSE], grads[pt.ForceBackend.PALLAS]
    blob_err = np.abs(gp - gd).max()
    if not (np.isfinite(gp).all() and np.abs(gp).max() > 0) or not np.allclose(
            gp, gd, rtol=DIFF_RTOL, atol=DIFF_ATOL):
        fail(f"13c: 24-bot PALLAS gradient vs DENSE: max |diff| {blob_err:.3e}")
    text = (
        f"10k HEX rollout from step {state.step}, {steps} steps on PALLAS: value "
        f"{v.item():.7f} == plain make_step bit for bit; value-and-grad {vg_s:.2f} s, "
        f"kernel-1 launches {k1} (2 per step), peak {peak_vg / 2**20:.0f} MiB; |grad| max "
        f"{g.abs().max().item():.3e}, relative L2 to STENCIL's {rel:.3e} (bound "
        f"{DIFF_REL_L2_BOUND}; after {short} steps {rel1:.3e}, bound {DIFF_REL_L2_SHORT}; "
        f"STENCIL's own one-ulp gap {env:.3e}; STENCIL value-and-grad {st_s:.2f} s) | "
        f"optimize_phases "
        f"{OPT_ITERS} iterations at {steps} steps: {opt_s * 1e3 / OPT_ITERS:.0f} ms per "
        f"iteration (the final evaluation included), kernel-1 launches {k_opt}, peak "
        f"{peak_opt / 2**20:.0f} MiB, objective {[round(float(h), 6) for h in hist]} | "
        f"24-bot blob {DIFF_BLOB_STEPS} steps: PALLAS vs DENSE gradient max |diff| "
        f"{blob_err:.2e} (rtol {DIFF_RTOL}, atol {DIFF_ATOL})"
    )
    return text, k1 + k_opt


def resume_phase() -> tuple:
    """Phase 13: checkpoints and video at 10k, the CLI resume on the span
    path, the differentiable path, each printed as it ends.  Returns the
    kernel launches of the paths it drove."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        text_a, saved, p, launched = checkpoint_video_phase(tmp, bench_params())
        print(f"phase 13a {text_a} ({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        text_b, k3 = cli_resume_phase(tmp)
        print(f"phase 13b {text_b} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    text_c, k1 = diff_phase(saved, p)
    print(f"phase 13c {text_c} ({time.perf_counter() - t0:.1f} s)", flush=True)
    launched["stencil_forces"] += k1
    launched["mega_span"] = k3
    return launched


# ------------------------------------------- phase 14: the multi-device layer

# the dp x tp table loop on bench.py's workload: B seeds x N_SHARDS shards
DPTP_SEEDS = (0, 1, 2, 3)
DPTP_STEPS = 200
# the mesh sweep: eight seeds of example.cfg over four places of one card
MESH_PLACES = 4


def record_decisions():
    """(decisions, restore): wraps ``spatial_table._all_ok`` so that every
    rebuild decision the sharded loops take (a bool tensor on the card, one
    flag per scene of a batch) is appended to ``decisions``; ``restore()``
    puts the function back.  A CUDA graph replays its captured rebuilds
    without calling the function, so a run that records decisions runs its
    blocks eagerly (:func:`eager_blocks`)."""
    from particlerobotsimulations_torch.parallel import spatial_table

    inner, seen = spatial_table._all_ok, []

    def recording(ring, ok_local):
        ok = inner(ring, ok_local)
        seen.append(ok)
        return ok

    spatial_table._all_ok = recording
    return seen, lambda: setattr(spatial_table, "_all_ok", inner)


def dp_tp_inputs(p, state):
    """Kernel 4's and kernel 2 padded's inputs on the dp x tp loop's
    shard-major layout from a batched 10k state: (halo-extended tables (S,
    B, C, E) per plane, each scene's whole kernel-1 tables, padded move
    planes (S, B, nf + 2, Cs, E) after 7 steps without a rebuild)."""
    g, cap, cs = p.resolved_grid_dim(), p.cell_capacity, p.storage_capacity()
    gg = g * g
    ts = enter_table(p, state)
    whole = torch.stack([ts.fields[k][:, : cap * gg].unflatten(-1, (cap, gg))
                         for k in KERNEL_FIELDS], dim=1)          # (B, 7, C, G*G)
    ext = shard_halo(whole, N_SHARDS, g)                          # (S, B, 7, C, E)
    tables_ext = {k: ext[:, :, j] for j, k in enumerate(KERNEL_FIELDS)}
    step = make_table_step(p)
    for _ in range(7):
        ts = step(ts, False, False, False, False)
    planes = torch.stack([ts.fields[k][:, : cs * gg] for k in MOVE_FIELDS], dim=1)
    planes = planes.unflatten(-1, (cs, gg))
    dxf, dyf, _, _ = torch.func.vmap(
        lambda pl, o: rebuild_move_planes(p, pl, MOVE_FIELDS, o)
    )(planes, ts.origin)
    padded = shard_halo(torch.cat([planes, dxf[:, None], dyf[:, None]], dim=1), N_SHARDS, g)
    return tables_ext, whole, padded


def dp_tp_kernel_checks(p, state):
    """Kernel 4 and kernel 2's padded form on the S x B = 16 blocks of the
    dp x tp loop's 10k tables, one launch each: every block bit for bit
    its single-block launch, within tolerance of (kernel 2: equal to) the
    twin, timed in a CUDA graph beside B launches of S shards each."""
    g = p.resolved_grid_dim()
    h, l0 = HALO_ROWS * g, g * g // N_SHARDS
    tables_ext, whole, padded = dp_tp_inputs(p, state)
    s, b = padded.shape[:2]
    got = kernels.stencil_forces_ext_batched_cuda(p, tables_ext, h, l0)
    out_k, inc_k = kernels.compact_padded_batched_cuda(p, padded, h, l0)
    torch.cuda.synchronize()
    for i in range(s):
        for j in range(b):
            one = kernels.stencil_forces_ext_cuda(
                p, {k: v[i, j][None] for k, v in tables_ext.items()}, h, l0)
            if not all(torch.equal(x[i, j], y[0]) for x, y in zip(got, one)):
                fail(f"batched stencil_forces_ext: block ({i}, {j}) differs from its single launch")
            o1, c1 = kernels.compact_padded_cuda(p, padded[i, j][None].contiguous(), h, l0)
            if not (torch.equal(out_k[i, j], o1[0]) and torch.equal(inc_k[i, j], c1[0])):
                fail(f"batched compact_padded: block ({i}, {j}) differs from its single launch")
    k4_err = check_forces("batched stencil_forces_ext", got,
                          stencil_forces_ext_plain(p, tables_ext, h, l0))
    out_p, inc_p = compact_padded_plain(p, padded, h, l0)
    torch.cuda.synchronize()
    k2_err = max(float((out_k - out_p).abs().max()), float((inc_k - inc_p).abs().max()))
    if not (torch.equal(inc_k, inc_p) and bool((out_k == out_p).all())):
        fail(f"batched compact_padded differs from its twin (max |diff| {k2_err})")
    per_scene_ext = [{k: v[:, j] for k, v in tables_ext.items()} for j in range(b)]
    per_scene_pad = [padded[:, j].contiguous() for j in range(b)]
    n_in = 7 if p.has_payload else 6
    cap = p.cell_capacity
    k4_bound = bound(
        (n_in * s * b * cap * (l0 + 2 * g) + 4 * s * b * cap * l0) * 4,
        PAIR_OPS * sum(occupied_pairs(p, whole[j, KERNEL_FIELDS.index("rad")]) for j in range(b)),
    )
    return {
        "stencil_forces_ext_batched": {
            "err": k4_err,
            "ms": graph_ms(lambda: kernels.stencil_forces_ext_batched_cuda(p, tables_ext, h, l0)),
            "split_ms": graph_ms(lambda: [kernels.stencil_forces_ext_cuda(p, t, h, l0)
                                          for t in per_scene_ext]),
            "plain_ms": median_ms(lambda: stencil_forces_ext_plain(p, tables_ext, h, l0), 5, 3),
            "bound": k4_bound,
        },
        "compact_padded_batched": {
            "err": k2_err,
            "ms": graph_ms(lambda: kernels.compact_padded_batched_cuda(p, padded, h, l0)),
            "split_ms": graph_ms(lambda: [kernels.compact_padded_cuda(p, x, h, l0)
                                          for x in per_scene_pad]),
            "plain_ms": median_ms(lambda: compact_padded_plain(p, padded, h, l0), 5, 3),
            "bound": compact_padded_bound(p, padded.flatten(0, 1), l0),
        },
    }


def dp_tp_phase(smi):
    """The dp x tp table loop on bench.py's 10k workload, B = 4 seeds x D =
    4 shards (G=64), 200 steps with its blocks eager (so that every
    rebuild's per-scene decisions are recorded; phase 18 holds the graphed
    blocks to the eager ones), the counters reset just before: exactly one
    kernel-4 launch per step and one padded kernel-2 launch per rebuild for
    all 16 blocks, the fallbacks the recorded decisions' scene-rebuilds that
    failed; each scene bit for bit (its centroid ring within a reordered
    sum's bound) the scene alone through the single-scene sharded loop,
    deciding its own rebuilds (graphed), with its own fallbacks; the batch
    on ``Mesh(["cuda"] * 2)`` x 4 shards bit for bit the ring's; and, over
    the steps before the first rebuild whose scenes decided apart (the
    unsharded batched loop takes one decision for all scenes), each scene
    within phase 9's sharded tolerance of the unsharded batched table
    loop.  Returns (launches, kernel checks, text)."""
    from particlerobotsimulations_torch.engine_table import make_run_chunk_table_batched
    from particlerobotsimulations_torch.parallel.mesh import Mesh
    from particlerobotsimulations_torch.parallel.spatial_table import (
        make_sharded_table_run_batched,
    )
    from particlerobotsimulations_torch.parallel.sweep import make_batch_state

    base = resolve_params(bench_params().validate())
    run, p = make_sharded_table_run_batched(base, LocalRing(N_SHARDS, "cuda"), with_stats=True)
    seeds, n_steps = list(DPTP_SEEDS), DPTP_STEPS
    k = max(1, p.resolved_slot_rebuild_steps())
    batch = make_batch_state(p, seeds, "cuda")
    decisions, restore = record_decisions()
    reset_counts()
    t0 = time.perf_counter()
    try:
        with eager_blocks(True):
            out, stats = run(batch, n_steps)
        torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = {name: 0 for name in kernels.LAUNCHES}
    want.update(stencil_forces_ext_batched=n_steps, compact_padded_batched=n_steps // k)
    if launches != want:
        fail(f"dp x tp launches {launches}, want {want}")
    taken = [d.tolist() for d in decisions]
    if len(taken) != n_steps // k or any(len(t) != len(seeds) for t in taken) \
            or stats["fallbacks"] != sum(t.count(False) for t in taken):
        fail(f"dp x tp: decisions {taken}, stats {stats}")
    if not np.isfinite(out.pos.cpu().numpy()).all():
        fail("dp x tp: non-finite state")

    n = p.n_cells
    single, _ = make_sharded_table_run(p, LocalRing(N_SHARDS, "cuda"), with_stats=True)
    ring_r, solo_s, solo_fb = 0.0, 0.0, []
    for b, seed in enumerate(seeds):
        scene = scene_state(make_batch_state(p, [seed], "cuda"), 0)
        t0 = time.perf_counter()
        one, one_stats = single(scene, n_steps)
        torch.cuda.synchronize()
        solo_s += time.perf_counter() - t0
        eq, ring_b = scene_diff(scene_state(out, b), one, n)
        solo_fb.append(one_stats["fallbacks"])
        if not (eq and ring_b <= 1.0) or one_stats["fallbacks"] != [t[b] for t in taken].count(
                False):
            fail(f"dp x tp scene {b} differs from its solo run (ring {ring_b:.3f}, fallbacks "
                 f"{one_stats['fallbacks']})")
        ring_r = max(ring_r, ring_b)

    mesh = Mesh(np.array(["cuda"] * (2 * N_SHARDS), dtype=object).reshape(2, N_SHARDS),
                ("data", "bots"))
    mrun, _ = make_sharded_table_run_batched(p, mesh=mesh, with_stats=True)
    t0 = time.perf_counter()
    mout, mstats = mrun(make_batch_state(p, seeds, "cuda"), n_steps)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    mesh_r = 0.0
    for b in range(len(seeds)):
        eq, ring_b = scene_diff(scene_state(mout, b), scene_state(out, b), n)
        if not (eq and ring_b <= 1.0):
            fail(f"dp x tp on the mesh: scene {b} differs from the ring's (ring {ring_b:.3f})")
        mesh_r = max(mesh_r, ring_b)
    if mstats != stats:
        fail(f"dp x tp on the mesh: stats {mstats}, ring {stats}")

    # the unsharded batched loop takes one decision for all scenes: held to
    # it over the steps before the first rebuild whose scenes decided apart
    mixed = [i for i, t in enumerate(taken) if len(set(t)) > 1]
    same = (mixed[0] + 1) * k - 1 if mixed else n_steps
    t0 = time.perf_counter()
    ref = make_run_chunk_table_batched(p)(make_batch_state(p, seeds, "cuda"), n_steps)
    torch.cuda.synchronize()
    unsharded_s = time.perf_counter() - t0
    if mixed:
        ref = make_run_chunk_table_batched(p)(make_batch_state(p, seeds, "cuda"), same)
        cut, _ = run(make_batch_state(p, seeds, "cuda"), same)
    else:
        cut = out
    dpos = float((cut.pos[:, :n] - ref.pos[:, :n]).abs().max())
    dvel = float((cut.vel[:, :n] - ref.vel[:, :n]).abs().max())
    if not (dpos <= TP_POS_ATOL and dvel <= TP_VEL_ATOL):
        fail(f"dp x tp vs the unsharded batched loop over {same} steps: dpos {dpos} dvel {dvel}")
    ref_text = (f"held to it over the {same} steps before the first rebuild whose scenes "
                f"decided apart (of {len(mixed)} such rebuilds, from {mixed[:1]}): max |dpos| "
                f"{dpos:.2e} |dvel| {dvel:.2e} (atol {TP_POS_ATOL}, {TP_VEL_ATOL})")

    kc = dp_tp_kernel_checks(p, out)
    b = len(seeds)
    text = (
        f"dp x tp 10k HEX, {b} seeds x {N_SHARDS} shards (G={p.resolved_grid_dim()}, "
        f"K={k}), {n_steps} steps, blocks eager: {wall * 1e6 / n_steps:.1f} us per batched "
        f"step ({smi}; {n * b * n_steps / wall:.4e} particle-steps/s), launches "
        f"{ {key: v for key, v in launches.items() if v} }, {stats}, per-scene decisions "
        f"taken {sum(t.count(True) for t in taken)} incremental / "
        f"{sum(t.count(False) for t in taken)} exact; each scene alone through the "
        f"single-scene sharded loop (graphed, its own decisions, fallbacks {solo_fb}) "
        f"{solo_s * 1e6 / (b * n_steps):.1f} us per scene-step, bit for bit in {b}/{b} scenes "
        f"(ring at up to {ring_r:.3f} of its reorder bound); on Mesh(['cuda'] * 2) x "
        f"{N_SHARDS} shards (graphed) {mesh_s * 1e6 / n_steps:.1f} us per batched step, bit for "
        f"bit the ring's (ring at up to {mesh_r:.3f}), stats equal; unsharded batched loop "
        f"{unsharded_s * 1e6 / n_steps:.1f} us per batched step, {ref_text}"
    )
    return launches, kc, text


def mesh_sweep_phase() -> str:
    """``run_sweep`` of eight seeds of example.cfg (300 bots, AUTO: DENSE)
    over ``Mesh(["cuda"] * 4)``, two seeds per place, against the unsharded
    batched run: every scene's dynamics bit for bit, the centroid records
    within a reordered sum's bound."""
    from particlerobotsimulations_torch.parallel.mesh import Mesh

    pe = resolve_params(pt.load_cfg(os.path.join(ROOT, "examples", "example.cfg")).validate())
    seeds, n_steps = list(SWEEP_SEEDS), 200
    mesh = Mesh(["cuda"] * MESH_PLACES)
    if choose_sweep_strategy(pe, len(seeds), mesh) != "batched":
        fail("mesh sweep: AUTO did not choose batched")
    reset_counts()
    t0 = time.perf_counter()
    fin_m, cents_m = run_sweep(pe, seeds, n_steps, mesh=mesh, record_every=100, device="cuda")
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fin_u, cents_u = run_sweep(pe, seeds, n_steps, record_every=100, strategy="batched",
                               device="cuda")
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    n = pe.n_cells
    ring_r, rec_r = 0.0, 0.0
    for b in range(len(seeds)):
        eq, ring_b = scene_diff(scene_state(fin_m, b), scene_state(fin_u, b), n)
        if not (eq and ring_b <= 1.0):
            fail(f"mesh sweep scene {b} differs from the unsharded batch (ring {ring_b:.3f})")
        ring_r = max(ring_r, ring_b)
        atol = math.ceil(math.log2(n)) * float(np.finfo(np.float32).eps) * float(
            np.abs(cents_u[:, b]).max())
        rec_r = max(rec_r, float(np.abs(cents_m[:, b] - cents_u[:, b]).max()) / atol)
    if rec_r > 1.0 or cents_m.shape != cents_u.shape:
        fail(f"mesh sweep: centroid records at {rec_r:.3f} of their reorder bound")
    steps = len(seeds) * n_steps
    return (
        f"run_sweep example.cfg ({pe.resolved_backend('cuda').name}) 8 seeds x {n_steps} steps "
        f"over Mesh(['cuda'] * {MESH_PLACES}): {mesh_s * 1e6 / n_steps:.1f} us per step of "
        f"the sweep ({n * steps / mesh_s:.4e} particle-steps/s) vs unsharded batched "
        f"{whole_s * 1e6 / n_steps:.1f} us ({n * steps / whole_s:.4e}); every scene bit "
        f"for bit (ring at up to {ring_r:.3f}, records at up to {rec_r:.3f} of their "
        f"reorder bound)"
    )


def multi_device_phase(smi):
    """Phase 14: the dry run over 8 places of the card, the dp x tp table
    loop, the mesh sweep.  Returns (dp x tp launches, kernel checks)."""
    from particlerobotsimulations_torch.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    results = dryrun_multichip(8, "cuda")
    torch.cuda.synchronize()
    print(f"phase 14 dry run: {len(results)} certifications over 8 places of the card "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches, kc, text = dp_tp_phase(smi)
    print(f"phase 14 {text} ({time.perf_counter() - t0:.1f} s)", flush=True)
    for name, v in kc.items():
        print(
            f"phase 14 {name} S x B = {N_SHARDS} x {len(DPTP_SEEDS)}: every block bit for "
            f"bit its single launch, max|diff| vs twin {v['err']:.3e}; "
            f"{v['ms'] * 1e3:.1f} us per launch in a CUDA graph vs {v['split_ms'] * 1e3:.1f} "
            f"us for {len(DPTP_SEEDS)} launches of {N_SHARDS} shards, plain "
            f"{v['plain_ms'] * 1e3:.1f} us, bound (ms, by) ({v['bound'][0]:.4g}, {v['bound'][1]})"
        )
    t0 = time.perf_counter()
    text = mesh_sweep_phase()
    print(f"phase 14 {text} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return launches, kc


# -------------------------- phase 15: the measurement and paper-parity layer

# phase 15's cuts: measure_throughput's chunk (a multiple of the 200-step
# gate segment) and reps at 10k; scaling_report's; the bench's chunk; the
# fullscale scenes' horizon; the parity scenarios' seeds and sim-seconds
# (2,000 steps)
P15_STEPS, P15_REPS = 600, 3
P15_SCALING = (1000, 4000, 10000, 20000)
P15_SCALING_STEPS, P15_SCALING_REPS = 200, 2
P15_BENCH_STEPS = 400
P15_FULLSCALE_S = 2.0
P15_PARITY_SEEDS, P15_PARITY_S = [0, 1], 20.0
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}


def load_script(name):
    """A script of ``scripts/`` as a module (its ``main`` not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def add_counts(total: dict) -> dict:
    """Add the launch counters to ``total``; returns this part's counts."""
    torch.cuda.synchronize()
    part = dict(kernels.LAUNCHES)
    for k, v in part.items():
        total[k] = total.get(k, 0) + v
    return part


def profiling_checks(total: dict, device="cuda") -> None:
    """Phase 15a: ``measure_call_overhead`` and ``measure_throughput`` at
    10k (PALLAS, the adaptive table loop: kernel 1 once per step, kernel 2
    once per rebuild, the row step between once and twice per step), then ``scaling_report`` over four sizes."""
    from particlerobotsimulations_torch.utils import profiling

    overhead = profiling.measure_call_overhead(device=device)
    if not 0 < overhead < 0.1 or profiling.measure_call_overhead(
        device=torch.device(device)
    ) != overhead:
        fail(f"call overhead {overhead} (or not cached per device)")
    reset_counts()
    t = profiling.measure_throughput(bench_params(), P15_STEPS, P15_REPS, device)
    part = add_counts(total)
    steps = (1 + P15_REPS) * P15_STEPS
    rebuilds = REBUILDS["incremental"] + REBUILDS["exact"]
    if t.backend != "PALLAS" or t.n_bots != bench_params().n_cells or not t.particle_steps_per_sec > 0:
        fail(f"measure_throughput at 10k: {t}")
    # cond_set: one launch for each rebuild a graph replayed; the row step
    # more than once a step (a block's first pre) and at most twice
    if part["stencil_forces"] != steps or part["compact"] != rebuilds or not (
        steps // 8 <= rebuilds <= steps // 4
    ) or part["cond_set"] > rebuilds or not steps < part["row_step"] <= 2 * steps or any(
        v for k, v in part.items()
        if k not in ("stencil_forces", "compact", "cond_set", "row_step")
    ):
        fail(f"measure_throughput launches {part}, rebuilds {dict(REBUILDS)} over {steps} steps")
    print(f"phase 15a call overhead {overhead * 1e6:.1f} us; measure_throughput 10k HEX "
          f"{1 + P15_REPS} chunks of {P15_STEPS} steps: {t.ms_per_step:.3f} ms/step, "
          f"{t.particle_steps_per_sec:.4e} particle-steps/s [{t.backend}], launches "
          f"{part}, rebuilds {dict(REBUILDS)}", flush=True)
    reset_counts()
    rows = profiling.scaling_report(P15_SCALING, device=device, n_steps=P15_SCALING_STEPS,
                                     reps=P15_SCALING_REPS)
    part = add_counts(total)
    if [r.n_bots for r in rows] != list(P15_SCALING) or any(
        r.backend != "PALLAS" or not r.particle_steps_per_sec > 0 for r in rows
    ):
        fail(f"scaling_report rows {rows}")
    steps = len(P15_SCALING) * (1 + P15_SCALING_REPS) * P15_SCALING_STEPS
    if not part["mega_span"] or not part["stencil_forces"] or not part["compact"]:
        fail(f"scaling_report launches {part}: the 1000-bot row takes the span path")
    print(f"phase 15a scaling_report {P15_SCALING} ({1 + P15_SCALING_REPS} chunks of "
          f"{P15_SCALING_STEPS} steps each): launches {part} over {steps} steps", flush=True)


def bench_check(total: dict, device="cuda") -> None:
    """Phase 15b: the bench's callable at a cut chunk, with its three
    warm-ups (adaptive at 10k): the card line, one JSON line with bench.py's
    keys, kernel 1 once per step."""
    from contextlib import redirect_stdout
    from io import StringIO

    from particlerobotsimulations_torch import bench

    reset_counts()
    buf = StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        record = bench.run_bench(device, bench_params().n_cells, P15_BENCH_STEPS)
    part = add_counts(total)
    lines = buf.getvalue().strip().splitlines()
    out = json.loads(lines[-1])
    if out != record or set(out) != BENCH_KEYS or out["vs_baseline"] is not None or (
        out["metric"] != "particle_steps_per_sec_10k_bots_torch"
    ) or not (math.isfinite(out["value"]) and out["value"] > 0):
        fail(f"bench line {lines[-1]}")
    if not lines[0].startswith("card: ") or "3 chunks" not in lines[1]:
        fail(f"bench lines {lines}")
    if part["stencil_forces"] != 6 * P15_BENCH_STEPS:
        fail(f"bench launches {part}")
    print(f"phase 15b bench at {P15_BENCH_STEPS}-step chunks ({time.perf_counter() - t0:.1f} s): "
          f"{lines[1]} | {lines[-1]} | launches {part}", flush=True)


def fullscale_check(tmp, total: dict, device="cuda") -> None:
    """Phase 15c: the five shipped scenes through the fullscale script's
    per-scene function at a cut horizon, as shipped (AUTO).  The gap scene
    (1,000 RANDOM bots) resolves to PALLAS at G=16, which its swarm outgrows:
    ``Simulation`` refuses it, as in the JAX package, and the script records
    the error; every other scene must run healthy."""
    fs = load_script("fullscale_torch")
    reset_counts()
    cfgs = sorted(os.path.join(ROOT, "examples", f) for f in os.listdir(os.path.join(ROOT, "examples"))
                  if f.endswith(".cfg"))
    results = fs.run_all(cfgs, device, max_time=P15_FULLSCALE_S, csv_dir=tmp)
    part = add_counts(total)
    if len(results) != 5:
        fail(f"fullscale scenes {sorted(results)}")
    for name, rec in results.items():
        if name == "example_gap":
            if "grid cells" not in rec.get("error", ""):
                fail(f"fullscale example_gap: {rec} (expected the grid-fit refusal)")
        elif "error" in rec or rec["steps"] != round(P15_FULLSCALE_S * 100):
            fail(f"fullscale {name}: {rec}")
    print(f"phase 15c fullscale at {P15_FULLSCALE_S:g} sim-s: {json.dumps(results)} | "
          f"launches {part}", flush=True)


def parity_check(tmp, total: dict, device="cuda") -> None:
    """Phase 15d: each parity scenario at 2 seeds and 2,000 steps with the
    anchors computed (their verdicts printed: the anchors are stated at the
    scenarios' full horizons), then ``--from-json`` on the JAX package's
    record, which must reproduce its verdicts."""
    pr = load_script("parity_report_torch")
    results = {}
    for name in ("phototaxis", "robustness", "obstacle", "gap", "transport"):
        reset_counts()
        t0 = time.perf_counter()
        results[name] = getattr(pr, name)(P15_PARITY_SEEDS, P15_PARITY_S, device)
        part = add_counts(total)
        vals = [v for v in results[name].values() if isinstance(v, float)]
        if not all(math.isfinite(v) for v in vals):
            fail(f"parity {name}: {results[name]}")
        print(f"phase 15d parity {name} {len(P15_PARITY_SEEDS)} seeds x {P15_PARITY_S:g} sim-s "
              f"({time.perf_counter() - t0:.1f} s): {json.dumps(results[name])} | launches "
              f"{ {k: v for k, v in part.items() if v} }", flush=True)
    anchors = pr._anchors(results, pr.cfg("example.cfg"))
    print("phase 15d anchors at this horizon: " + "; ".join(
        f"{a['name']} {a['measured']:.4f} ({a['verdict']})" for a in anchors.values()
    ), flush=True)
    out = os.path.join(tmp, "parity_from_json")
    record_path = os.path.join(ROOT, "docs", "parity", "parity.json")
    with open(record_path) as f:
        record = json.load(f)
    from contextlib import redirect_stdout
    from io import StringIO

    with redirect_stdout(StringIO()):
        rc = pr.main(["--from-json", record_path, "--out", out])
    with open(os.path.join(out, "parity.json")) as f:
        redo = json.load(f)
    want = {k: a["verdict"] for k, a in record["anchors"].items()}
    got = {k: a["verdict"] for k, a in redo["anchors"].items()}
    if rc != 0 or got != want:
        fail(f"--from-json: rc {rc}, verdicts {got} against the record's {want}")
    print(f"phase 15d --from-json docs/parity/parity.json: verdicts {got}, as recorded",
          flush=True)


def measurement_phase(device="cuda") -> dict:
    """Phase 15: the profiling helpers, the bench, the fullscale and parity
    scripts on the card.  Returns the kernel launches of the paths they
    drove."""
    total: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in (("a", lambda: profiling_checks(total, device)),
                         ("b", lambda: bench_check(total, device)),
                         ("c", lambda: fullscale_check(tmp, total, device)),
                         ("d", lambda: parity_check(tmp, total, device))):
            t0 = time.perf_counter()
            fn()
            print(f"phase 15{name} took {time.perf_counter() - t0:.1f} s", flush=True)
    return total


# --------------------------------------------- phase 16: the graphed chunk

# the three scenes graph against eager: bench.py's 10k workload through the
# adaptive runner (seg-aligned chunks: a probe segment, then K-step blocks),
# the 100k HEX table from placement (no spill rows; most rebuilds exact),
# and eight 10k seeds batched
GRAPH_CHUNK_10K, GRAPH_CHUNKS_10K = 600, 4
GRAPH_N_100K, GRAPH_CHUNK_100K, GRAPH_CHUNKS_100K = 100_000, 200, 2
GRAPH_SEEDS, GRAPH_CHUNK_BATCH, GRAPH_CHUNKS_BATCH = tuple(range(8)), 200, 2
# the 10k table loop at K=4 with a fifth of the bots killed mid-block in
# its second chunk, which ends in a ragged tail (598 = 149 blocks + 2)
GRAPH_DEAD_10K, GRAPH_DEAD_STEP_10K, GRAPH_DEAD_CHUNKS_10K = 2000, 701, (600, 598)
# the profiled eager-vs-graph comparison at 10k, and the two-place bench
GRAPH_PROFILE_STEPS, BENCH2_STEPS = 600, 400


class EagerBlock:
    """Stands in for ``chunk.CapturedBlock`` in phases 16 and 17's
    eager runs: the same runner, its captured blocks (the table loop's
    K-step blocks, the span path's segments, the per-bot runner's
    ungated blocks) run eagerly where the graph runs replay them."""

    def __init__(self, block, carry):
        self.block = block

    def __call__(self, carry, step):
        return self.block(carry, step_tensor(step, next(iter(carry.values())).device))


class CountedBlock(t_chunk.CapturedBlock):
    """``chunk.CapturedBlock`` that keeps count, for the graph runs
    held against eager ones: its replays, the rebuild choices they took
    (summed on the device, no host read: ``REBUILDS``' device counter
    before and after each replay, and for the sharded loop, which counts
    its fallbacks in its carry, the carry's ``fallbacks`` before and after
    a replay of its one rebuild), and the selects (``torch.where`` on a
    0-dim condition) its capture made.  ``MADE`` lists the blocks
    captured."""

    MADE: list = []

    def __init__(self, block, carry):
        real = torch.where
        self.selects = 0

        def spy(cond, *args, **kw):
            if torch.is_tensor(cond) and cond.dim() == 0 and args:
                self.selects += 1
            return real(cond, *args, **kw)

        torch.where = spy
        try:
            super().__init__(block, carry)
        finally:
            torch.where = real
        self.replays = 0
        self.taken = torch.zeros(2, dtype=torch.int64, device=self.step.device)
        CountedBlock.MADE.append(self)

    def __call__(self, carry, step):
        counter = REBUILDS.counter(self.step.device)
        before = counter.clone()
        fallbacks = carry["fallbacks"].clone() if "fallbacks" in carry else None
        out = super().__call__(carry, step)
        self.taken += counter - before
        if fallbacks is not None and self.launches.get("cond_set") == 1:
            # the node's body ran where any scene fell back
            exact = (out["fallbacks"] > fallbacks).to(torch.int64)
            self.taken += torch.stack([1 - exact, exact])
        self.replays += 1
        return out


# each graph-against-eager scene's conditional nodes, for phase 19
NODE_SCENES: list = []


def node_record(name, blocks, launches) -> dict:
    """What a graph run's counted blocks captured and replayed, checked:
    each capture made no select and holds one top-level conditional node
    per top-level ``cond_set`` launch, each with a body; the run's
    ``cond_set`` launches are one per cond its replays ran (those of a
    redone span segment's rebuilds, inside its redo body, included).
    Appended to ``NODE_SCENES``."""
    rec = {"name": name, "graphs": len(blocks), "conditional": [], "body_nodes": [],
           "top_nodes": [], "replays": sum(b.replays for b in blocks),
           "capture_s": [b.capture_s for b in blocks]}
    for b in blocks:
        n = b.launches.get("cond_set", 0)
        if b.selects:
            fail(f"{name}: a capture made {b.selects} selects")
        if n and (b.nodes["conditional"] != n or b.nodes["body_nodes"] < 1):
            fail(f"{name}: {n} cond_set launches in a capture with nodes {b.nodes}")
        if b.nodes["conditional"]:
            rec["conditional"].append(b.nodes["conditional"])
            rec["body_nodes"].append(b.nodes["body_nodes"])
            rec["top_nodes"].append(b.nodes["nodes"])
    want = sum(b.replays * b.launches.get("cond_set", 0)
               + sum(c.get("cond_set", 0) * int(t) for c, t in b.counted) for b in blocks)
    if launches.get("cond_set", 0) != want:
        fail(f"{name}: cond_set launched {launches.get('cond_set')} times, its graphs "
             f"replayed {want} rebuilds")
    taken = sum((b.taken for b in blocks), torch.zeros(2, dtype=torch.int64, device="cuda"))
    rec["replayed_rebuilds"] = dict(zip(REBUILDS.KEYS, taken.tolist()))
    NODE_SCENES.append(rec)
    return rec


def node_text(rec) -> str:
    if not rec["conditional"]:
        return f"no rebuild in its {rec['graphs']} graphs, no conditional node"
    return (f"conditional nodes per graph {sorted(set(rec['conditional']))} in "
            f"{len(rec['conditional'])} of {rec['graphs']} graphs (body nodes "
            f"{sorted(set(rec['body_nodes']))}, top-level nodes {sorted(set(rec['top_nodes']))}), "
            f"rebuilds inside {rec['replays']} replays {rec['replayed_rebuilds']}")


def without_cond_set(launches) -> dict:
    """Launch counts apart from ``cond_set``, which only a graph's
    conditional node launches (an eager rebuild selects)."""
    return {k: v for k, v in launches.items() if k != "cond_set"}


def without_glue(launches) -> dict:
    """:func:`without_cond_set` apart from the row step's counts too, which
    a reference run through the twin (:func:`twin_glue`) does not make."""
    return {k: v for k, v in without_cond_set(launches).items() if k not in ROW_STEP_KEYS}


def chunks_run(make_runner, state, chunks, aligned, eager, count=True):
    """A fresh runner's ``chunks`` from a copy of ``state``, with its blocks
    eager or replayed from graphs (counted where ``count``), the counters
    reset just before: a record of the runner, its end state, launches,
    rebuilds, wall s, live K after each chunk, the counted blocks, each
    chunk's (start step, steps, steps run eagerly on the card:
    ``chunk.EAGER``), the state the last chunk
    started from (a copy) and the memory the run left reserved on the
    card (``torch.cuda.memory_reserved`` after it less before it, the
    cache emptied first: a graph run's is mostly its graphs' pools)."""
    from types import SimpleNamespace

    with eager_blocks(eager, count) as blocks:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        run = make_runner()
        state = clone_state(state)
        reset_counts()
        ks, eager_steps, last_start = [], [], None
        t0 = time.perf_counter()
        for n in chunks:
            start = state.step
            last_start = clone_state(state)
            before = t_chunk.EAGER["card"]
            state = run(state, n, aligned)
            ks.append(getattr(run, "live", {}).get("k"))
            eager_steps.append((start, n, t_chunk.EAGER["card"] - before))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return SimpleNamespace(
            run=run, state=state, launches=dict(kernels.LAUNCHES), rebuilds=dict(REBUILDS),
            wall=wall, ks=ks, blocks=blocks, eager_steps=eager_steps, last_start=last_start,
            held=torch.cuda.memory_reserved() - reserved)


def check_eager(name, eager_steps, warm=None) -> str:
    """Each chunk's steps run eagerly on the card (``chunk.EAGER``): a
    runner's warm-ups alone, the first block or span segment of each kind
    and layout, run before its capture (every piece is a block or a
    segment that a graph replays, the dead-injection step and the ragged
    tail included); ``warm``, those of the last chunk run again on the
    warm runner, must be none.  Returns the text that reports them."""
    got = [e for _, _, e in eager_steps]
    if warm:
        fail(f"{name}: {warm} eager steps in a chunk on the warm runner, by design none")
    return (f"eager steps per chunk {got} (warm-ups)"
            + ("" if warm is None else f", {warm} on the warm runner"))


def capture_text(blocks) -> str:
    """The captures' cost: how many graphs, their capture + instantiate
    seconds in all and at most."""
    secs = [b.capture_s for b in blocks]
    if not secs:
        return "no capture"
    return (f"{len(secs)} captures in {sum(secs):.3f} s (at most {max(secs):.3f} s for "
            f"one graph)")


def memory_text(graph_held, eager_held) -> str:
    """The memory a graph run left reserved beside an eager run's."""
    return (f"memory reserved after the run +{graph_held / 2**20:.1f} MiB with graphs, "
            f"+{eager_held / 2**20:.1f} MiB eager")


def sync_free_chunk(name, run, state, n, aligned):
    """The last chunk again, from a copy of the state it started from, on
    the warm runner under ``set_sync_debug_mode("error")``: nothing between
    its entry and exit may wait for the card (every gate pattern of the
    chunk, a dead step and a ragged tail included, replays a graph
    captured before).  Returns the steps it ran eagerly on the card."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    before = t_chunk.EAGER["card"]
    try:
        state = run(state, n, aligned)
    except RuntimeError as err:
        fail(f"{name}: a chunk waited for the card: {err}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not bool(torch.isfinite(state.pos).all()):
        fail(f"{name}: non-finite state after the sync-free chunk")
    return t_chunk.EAGER["card"] - before


def graph_vs_eager(name, make_runner, state, chunks, aligned, total):
    """``chunks`` through eager and graph runs of one runner kind from one
    state: bit for bit, with equal launch and rebuild counts, each chunk's
    eager steps (warm-ups), then the last chunk again on the warm graph
    runner, sync-free and with no eager step.  Adds the graph run's launches to ``total``; returns (text,
    live Ks)."""
    e = chunks_run(make_runner, state, chunks, aligned, True)
    g = chunks_run(make_runner, state, chunks, aligned, False)
    if not states_equal(e.state, g.state):
        bad = [k for k in ARRAY_FIELDS if not torch.equal(getattr(e.state, k),
                                                          getattr(g.state, k))]
        fail(f"{name}: graph run differs from the eager run in {bad}")
    if (without_cond_set(e.launches), e.rebuilds, e.ks) != (
            without_cond_set(g.launches), g.rebuilds, g.ks) or e.launches["cond_set"]:
        fail(f"{name}: eager launches {e.launches} rebuilds {e.rebuilds} K {e.ks}, "
             f"graph {g.launches} {g.rebuilds} {g.ks}")
    rec = node_record(name, g.blocks, g.launches)
    for k, v in g.launches.items():
        total[k] = total.get(k, 0) + v
    warm = sync_free_chunk(name, g.run, g.last_start, chunks[-1], aligned)
    eager_text = check_eager(name, g.eager_steps, warm)
    steps = sum(chunks)
    used = {k: v for k, v in g.launches.items() if v}
    return (f"{name}: {steps} steps in chunks {list(chunks)}, graph (node) == eager (select) "
            f"bit for bit, launches {used}, rebuilds {g.rebuilds}, live K {g.ks}; "
            f"{len(g.blocks)} graphs (gate patterns and layouts), {capture_text(g.blocks)}, "
            f"{memory_text(g.held, e.held)}; {eager_text}; {node_text(rec)}; wall "
            f"{e.wall * 1e6 / steps:.1f} us/step eager, {g.wall * 1e6 / steps:.1f} graph (first "
            f"chunk captures); sync-free chunk ok"), g.ks


def far_fields(p, fields: dict) -> dict:
    """``fields`` with one occupied table row moved two cells in x: the
    incremental rebuild's >1-cell precondition fails."""
    total = p.resolved_grid_dim() ** 2 * p.storage_capacity()
    rows = torch.nonzero(fields["val"][..., :total] > 0.5)
    px = fields["px"].clone()
    px[tuple(rows[len(rows) // 2])] += np.float32(2.0) * np.float32(p.cutoff())
    return {**fields, "px": px}


def branch_costs(inc_only, select, chosen, chosen_far) -> str:
    """A rebuild's per-rebuild device costs in us, each in a graph: the
    incremental alone, the select as the loop made it before the node
    (both rebuilds and a ``torch.where`` per plane), and the rebuild
    through its conditional node with the incremental taken and with the
    exact taken."""
    t = {k: graph_ms(fn, launches=10) * 1e3
         for k, fn in (("incremental", inc_only), ("select", select), ("node_inc", chosen),
                       ("node_exact", chosen_far))}
    return (f"incremental alone {t['incremental']:.1f} us, node with the incremental taken "
            f"{t['node_inc']:.1f} (+{t['node_inc'] - t['incremental']:.1f}), with the exact "
            f"taken {t['node_exact']:.1f} (+{t['node_exact'] - t['incremental']:.1f}), the "
            f"select {t['select']:.1f} (+{t['select'] - t['incremental']:.1f}) per rebuild")


def rebuild_cost(p, state) -> str:
    """The rebuild through its conditional node against the incremental
    rebuild alone and against the select on ``state``'s table after one
    step's integrate, the exact branch forced by a bot moved two cells:
    per-rebuild device times in a graph, and the exact rebuild's device
    time by op."""
    from particlerobotsimulations_torch.engine_table import (
        _derived_rows,
        _exact_rebuild,
        _smart_rebuild,
    )
    from particlerobotsimulations_torch.ops.table_rebuild import incremental_rebuild

    pre, _ = make_table_step_parts(p)
    ts = pre(enter_table(p, state), False, False, False)
    far = ts.replace(fields=far_fields(p, ts.fields))

    def inc_only():
        moved, ok = incremental_rebuild(p, ts.fields, MOVE_FIELDS, ts.origin)
        return _derived_rows(p, {**ts.fields, **moved}), ok

    def select():
        moved, ok = incremental_rebuild(p, ts.fields, MOVE_FIELDS, ts.origin)
        ok = ok.all()
        REBUILDS.add(ok)
        inc = _derived_rows(p, {**ts.fields, **moved})
        exact, origin = _exact_rebuild(p, ts.fields)
        return ({k: torch.where(ok, inc[k], exact[k]) for k in TABLE_FIELDS},
                torch.where(ok, ts.origin, origin))

    text = branch_costs(inc_only, select, lambda: _smart_rebuild(p, ts),
                        lambda: _smart_rebuild(p, far))
    return f"{text}; the exact rebuild's device time by op: {exact_rebuild_ops(p, ts)}"


def exact_rebuild_ops(p, ts, calls: int = 10, top: int = 6) -> str:
    """Device us per call of the exact rebuild under ``torch.profiler``:
    the total and its ``top`` operators by self device time."""
    from particlerobotsimulations_torch.engine_table import _exact_rebuild
    from torch.profiler import ProfilerActivity, profile

    _exact_rebuild(p, ts.fields)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            _exact_rebuild(p, ts.fields)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    ops = [e for e in prof.key_averages() if e.key.startswith("aten::") and dev_us(e) > 0]
    ops.sort(key=dev_us, reverse=True)
    total = sum(dev_us(e) for e in ops) / calls
    return f"{total:.1f} us in all, " + ", ".join(
        f"{e.key[6:]} {dev_us(e) / calls:.1f}" for e in ops[:top])


def profiled_modes(p, state, k) -> str:
    """Eager against graph in one call at 10k on the K-step table loop
    (unaligned chunks): a 200-step warm-up chunk from ``state``, then a
    window of GRAPH_PROFILE_STEPS from its end run once (it captures every
    gate pattern of the window), again with its wall us/step unprofiled,
    and once more under the profiler: busy share and device us/step."""
    pk = p.replace(slot_rebuild_steps=k).validate()
    out = []
    for mode in ("eager", "graph", "graph", "eager"):
        with eager_blocks(mode == "eager"):
            run = make_run_chunk_table(pk)
            start = run(clone_state(state), 200, False)
            run(clone_state(start), GRAPH_PROFILE_STEPS, False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(clone_state(start), GRAPH_PROFILE_STEPS, False)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6 / GRAPH_PROFILE_STEPS
            share = busy_share(lambda: run(clone_state(start), GRAPH_PROFILE_STEPS, False),
                               GRAPH_PROFILE_STEPS)
        # the profiler's own host work stretches the profiled wall: the
        # device time over the unprofiled wall is the share without it
        dev = re.search(r"\(([0-9.]+) device us/step", share)
        plain = f", device us over unprofiled wall {float(dev.group(1)) / wall:.4f}" if dev else ""
        out.append(f"{mode} {wall:.1f} us/step wall{plain}, profiled busy share {share}")
    return f"K={k}: " + " | ".join(out)


def two_place_bench(total) -> str:
    """The bench's multi-place branch on ``Mesh(["cuda"] * 2)`` at 10k and
    BENCH2_STEPS-step chunks: the places' blocks dispatched in turn, and
    each place's scene bit for bit its seed run alone through the batched
    loop (the bench's four chunks)."""
    from contextlib import redirect_stdout
    from io import StringIO

    from particlerobotsimulations_torch import bench
    from particlerobotsimulations_torch.engine import make_run_chunk_batched
    from particlerobotsimulations_torch.parallel.mesh import Mesh
    from particlerobotsimulations_torch.parallel.sweep import make_batch_state

    log = {"order": []}
    real = bench.interleave

    def logged(iterators):
        def wrap(i, it):
            while True:
                try:
                    next(it)
                except StopIteration as stop:
                    return stop.value
                log["order"].append(i)
                yield

        log["states"] = real([wrap(i, it) for i, it in enumerate(iterators)])
        return log["states"]

    reset_counts()
    bench.interleave = logged
    buf = StringIO()
    try:
        with redirect_stdout(buf):
            record = bench.run_bench("cuda", bench_params().n_cells, BENCH2_STEPS,
                                     mesh=Mesh(["cuda"] * 2))
    finally:
        bench.interleave = real
    part = add_counts(total)
    order = log["order"]
    first = order[:2 * min(order.count(0), order.count(1))]
    if first != [0, 1] * (len(first) // 2) or not first:
        fail(f"two-place bench: dispatch order {order[:12]}... is not interleaved")
    params = resolve_params(bench_params().validate())
    n_chunks = 4  # one warm-up, three timed
    for b, got in enumerate(log["states"]):
        solo = make_batch_state(params, [b], "cuda")
        run = make_run_chunk_batched(params, "cuda")
        for _ in range(n_chunks):
            solo = run(solo, BENCH2_STEPS, True)
        if not states_equal(got, solo):
            fail(f"two-place bench: place {b}'s scene differs from its solo run")
    return (f"two-place bench on Mesh(['cuda'] * 2), {BENCH2_STEPS}-step chunks: "
            f"{json.dumps(record)}; {len(order)} block dispatches interleaved "
            f"(first {order[:8]}), each scene bit for bit its solo run; launches "
            f"{ {k: v for k, v in part.items() if v} }")


def graph_phase(main_state) -> tuple:
    """Phase 16: the ungated K-step blocks from CUDA graphs (each rebuild
    through its conditional node), held bit for bit to the eager blocks
    (the select) on three scenes, sync-free chunks, the rebuild's cost by
    branch, eager against graph profiled at 10k, and the two-place bench.
    Returns the graph runs' launches and the adaptive runner's live K."""
    from particlerobotsimulations_torch.engine import make_run_chunk, make_run_chunk_batched
    from particlerobotsimulations_torch.parallel.sweep import make_batch_state

    total: dict = {}
    p10 = resolve_params(bench_params().validate())
    t0 = time.perf_counter()
    text, ks = graph_vs_eager("10k adaptive", lambda: make_run_chunk(p10, "cuda"), main_state,
                              [GRAPH_CHUNK_10K] * GRAPH_CHUNKS_10K, True, total)
    print(f"phase 16 {text} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if 8 not in ks:
        p8 = p10.replace(slot_rebuild_steps=8).validate()
        text, _ = graph_vs_eager("10k K=8 (the probe kept K=4)",
                                 lambda: make_run_chunk_table(p8), main_state,
                                 [GRAPH_CHUNK_10K] * 2, False, total)
        print(f"phase 16 {text}", flush=True)
    k_live = 8 if 8 in ks else 4
    print(f"phase 16 10k rebuild cost: {rebuild_cost(p10, main_state)}", flush=True)
    print(f"phase 16 10k eager against graph, {GRAPH_PROFILE_STEPS} steps each "
          f"(eager, graph, graph, eager): {profiled_modes(p10, main_state, k_live)}", flush=True)

    t0 = time.perf_counter()
    p100 = resolve_params(bench_params().replace(n_cells=GRAPH_N_100K).validate())
    if p100.resolved_overflow_slots():
        fail(f"100k scene: {p100.resolved_overflow_slots()} spill rows, want none")
    s100 = pt.Simulation(p100, device="cuda").state
    text, _ = graph_vs_eager("100k HEX", lambda: make_run_chunk_table(p100), s100,
                             [GRAPH_CHUNK_100K] * GRAPH_CHUNKS_100K, False, total)
    print(f"phase 16 {text} ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"phase 16 100k G={p100.resolved_grid_dim()} rebuild cost: {rebuild_cost(p100, s100)}",
          flush=True)

    t0 = time.perf_counter()
    batch = make_batch_state(p10, list(GRAPH_SEEDS), "cuda")
    text, _ = graph_vs_eager(f"{len(GRAPH_SEEDS)} seeds x 10k batched",
                             lambda: make_run_chunk_batched(p10, "cuda"), batch,
                             [GRAPH_CHUNK_BATCH] * GRAPH_CHUNKS_BATCH, True, total)
    print(f"phase 16 {text} ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    pd = p10.replace(slot_rebuild_steps=4, n_dead=GRAPH_DEAD_10K,
                     time_to_dead=GRAPH_DEAD_STEP_10K * p10.timestep).validate()
    if pd.dead_step != GRAPH_DEAD_STEP_10K or pd.dead_step % 4 == 0:
        fail(f"10k dead scene: dead step {pd.dead_step}")
    sd = pt.Simulation(pd, device="cuda").state
    text, _ = graph_vs_eager(
        f"10k K=4, {pd.n_dead} killed at step {pd.dead_step} (mid-block), ragged tail",
        lambda: make_run_chunk_table(pd), sd, list(GRAPH_DEAD_CHUNKS_10K), False, total)
    print(f"phase 16 {text} ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    print(f"phase 16 {two_place_bench(total)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return total, k_live


# ------------------------------- phase 17: the compiled small-scene paths

# a: the two DENSE scenes from placement, in Simulation.run's 1,000-step
# chunks; b: eight seeds of example.cfg batched; c: the band's span path,
# one scene in seg-aligned chunks and the eight-seed batch under phase
# noise (it redoes segments); e: the profiled turns
SMALL_CFGS, SMALL_CHUNKS = ("example.cfg", "example_obstacle.cfg"), (1000, 1000)
# example_dead_cells.cfg (100 bots, 20 dead) with its bots killed at step
# 1,203, off every gate, in a second chunk that ends in a short block
SMALL_DEAD_CFG, SMALL_DEAD_STEP, SMALL_DEAD_CHUNKS = "example_dead_cells.cfg", 1203, (1000, 997)
SMALL_SEEDS, SMALL_BATCH_CHUNKS = tuple(range(8)), (200, 200)
BAND_CHUNKS, BAND_BATCH_CHUNKS = (1000, 1000), (400, 400)
# the band with 100 bots killed on the segment boundary at step 600, in
# its second chunk
BAND_DEAD, BAND_DEAD_STEP, BAND_DEAD_CHUNKS = 100, 600, (400, 400)
# the forced failure: one segment per chunk, the spans' rebuilds failed
# where False (the device flag of forced_glue)
BAND_FORCED = (True, False) * 4
# (timed, traced) steps of each turn: DENSE, the band
SMALL_PROFILE_STEPS, BAND_PROFILE_STEPS = (400, 50), (400, 200)
# the per-bot runner's block lengths phase 17 times against each other,
# over this many steps (after as many from placement)
BLOCK_CHOICES, BLOCK_CHOICE_STEPS = (8, 32), 600


def eager_blocks(on: bool, count: bool = False):
    """A context in which the runners built and first run inside it take
    :class:`EagerBlock` for ``chunk.CapturedBlock`` (``on``), else
    :class:`CountedBlock` (``count``) or the CUDA graphs as they are; it
    yields the list of the counted blocks captured.  Counting, it traces
    the host (``utils/trace``), and each counted block's ``capture_s`` is
    its ``graph.capture`` span's duration (capture and instantiation)."""
    from contextlib import contextmanager

    @contextmanager
    def swap():
        captured = t_chunk.CapturedBlock
        CountedBlock.MADE = []
        counting = count and not on
        if on or count:
            t_chunk.CapturedBlock = EagerBlock if on else CountedBlock
        if counting:
            trace.enable()
        try:
            yield CountedBlock.MADE
        finally:
            t_chunk.CapturedBlock = captured
            if counting:
                trace.disable()
                spans = [s for s in trace.snapshot()["spans"] if s["name"] == "graph.capture"]
                for b, s in zip(CountedBlock.MADE, spans):
                    b.capture_s = (s["end_ns"] - s["start_ns"]) * 1e-9

    return swap()


def reference_span_chunk(p, state, n_steps, glue=None):
    """The span path with its decision on the host: every piece eager,
    each segment's flag read (``bool(ok_all.item())``) before the next
    segment is enqueued, a failed segment redone on the regular path from
    its entry (the draw source restored).  The regular steps run one at a
    time (bit for bit the runner's graphed blocks, phase 16).  ``glue``:
    ``_make_mega_glue`` or a stand-in.  Returns (state, redos)."""
    from particlerobotsimulations_torch import rng
    from particlerobotsimulations_torch.engine_table import _smart_rebuild
    from particlerobotsimulations_torch.ops.megakernel import make_mega_span

    step = make_table_step(p)
    step_pre, step_post = make_table_step_parts(p)
    k = max(1, p.resolved_slot_rebuild_steps())
    seg = gate_seg(p)
    bps = seg // k
    mega = make_mega_span(p, table_geometry(p)[2])
    mega_pack, mega_unpack, incremental_packed = (glue or _make_mega_glue)(p)
    redos = 0

    def regular(ts, n):
        for j in range(n):
            ts = step(ts, *t_chunk.gates(p, ts.step), j % k == k - 1)
        return ts

    def mega_seg(ts):
        nonlocal redos
        entry = (dict(ts.fields), ts.origin, ts.step, ts.centroid_ring,
                 rng.snapshot(ts.generator))
        for _ in range(k - 1):
            ts = step(ts, *t_chunk.gates(p, ts.step), False)
        ts = _smart_rebuild(p, step_pre(ts, *t_chunk.gates(p, ts.step)))
        tbl, strip = mega_pack(ts.fields)
        ok_all = torch.ones((), dtype=torch.bool, device=tbl.device)
        first = ts.step + 1
        for b in range(bps - 1):
            tbl, strip = mega(tbl, strip, first + b * k)
            tbl, ok = incremental_packed(tbl, ts.origin)
            ok_all = ok_all & ok.all()
        if bool(ok_all.item()):
            mid = ts.replace(fields=mega_unpack(tbl, strip), step=first + (bps - 1) * k - 1)
            return step_post(mid)
        redos += 1
        fields, origin, step0, ring, snap = entry
        rng.restore(ts.generator, snap)
        ts = ts.replace(fields=fields, origin=origin, step=step0, centroid_ring=ring)
        return regular(ts, seg)

    ts = enter_table(p, state)
    n_segs = n_steps // seg
    for _ in range(n_segs):
        ts = mega_seg(ts)
    return exit_table(p, regular(ts, n_steps - n_segs * seg)), redos


def generators_equal(a, b) -> bool:
    ga = a.generator.sources if isinstance(a.generator, SceneDraws) else [a.generator]
    gb = b.generator.sources if isinstance(b.generator, SceneDraws) else [b.generator]
    return all(torch.equal(x.get_state(), y.get_state()) for x, y in zip(ga, gb))


def gate_counts(p, start, n) -> dict:
    """How often each gate fires over steps ``start`` .. ``start + n - 1``."""
    fired = [0, 0, 0]
    for s in range(start, start + n):
        for i, g in enumerate(t_chunk.step_gates(p, s)):
            fired[i] += bool(g)
    return dict(zip(("dead", "centroid", "phase"), fired))


def forced_glue(flag):
    """A stand-in for ``_make_mega_glue`` whose span rebuilds' ``ok`` is
    ANDed with the 0-dim bool device tensor ``flag``: set from outside a
    graph before a replay, it fails the segment's spans on the card."""
    def glue(params):
        pack, unpack, inc = _make_mega_glue(params)

        def forced(tbl, origin):
            new, ok = inc(tbl, origin)
            return new, ok & flag

        return pack, unpack, forced

    return glue


def span_vs_reference(name, p, state, chunks, total, flags=None):
    """``chunks`` of the span path's runner (each segment one CUDA graph
    that decides its adopt-or-redo with a conditional node) against
    :func:`reference_span_chunk` from one state, its step glue through the
    row step's plain twin (:func:`twin_glue`): bit for bit, generators
    included, with equal launches (apart from ``cond_set`` and the row
    step, whose launches are the schedule's, :func:`row_step_launches`),
    rebuilds and redos, and each chunk's eager steps (warm-ups); then the last chunk
    again on the warm runner, sync-free and with no eager step (a segment holding the
    dead step included,
    where the last chunk holds it).  With ``flags`` (one bool per
    one-segment chunk) both runs AND the span rebuilds' ``ok`` with a
    device flag set to the chunk's before it (:func:`forced_glue`).
    Prints the segment graphs' nodes (top level, and in their bodies,
    nested ones included) and their capture + instantiate time.  Adds the
    runner's launches to ``total``."""
    from particlerobotsimulations_torch.engine_table import make_run_chunk_table_batched

    batched = state.pos.dim() == 3
    flag = torch.ones((), dtype=torch.bool, device="cuda")
    glue = forced_glue(flag) if flags is not None else None
    if flags is not None:
        chunks = [gate_seg(p)] * len(flags)
    real = engine_table._make_mega_glue
    with eager_blocks(False, True) as blocks:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        engine_table._make_mega_glue = glue or real
        try:
            run = (make_run_chunk_table_batched if batched else make_run_chunk_table)(p)
        finally:
            engine_table._make_mega_glue = real
        if not run.path_info["use_mega"]:
            fail(f"{name}: not on the span path")
        reset_counts()
        t0 = time.perf_counter()
        got, eager_steps = clone_state(state), []
        for i, n in enumerate(chunks):
            if flags is not None:
                flag.fill_(flags[i])
            start = got.step
            last_start = clone_state(got)
            before = t_chunk.EAGER["card"]
            got = run(got, n, True)
            eager_steps.append((start, n, t_chunk.EAGER["card"] - before))
        torch.cuda.synchronize()
        held = torch.cuda.memory_reserved() - reserved
    g_wall, g_launch, g_reb = time.perf_counter() - t0, dict(kernels.LAUNCHES), dict(REBUILDS)
    g_redos = run.redos
    reset_counts()
    t0 = time.perf_counter()
    want, redos = clone_state(state), 0
    with twin_glue():
        for i, n in enumerate(chunks):
            if flags is not None:
                flag.fill_(flags[i])
            want, r = reference_span_chunk(p, want, n, glue)
            redos += r
        torch.cuda.synchronize()
    r_wall, r_launch, r_reb = time.perf_counter() - t0, dict(kernels.LAUNCHES), dict(REBUILDS)
    if not (states_equal(got, want) and generators_equal(got, want)):
        bad = [k for k in ARRAY_FIELDS if not torch.equal(getattr(got, k), getattr(want, k))]
        fail(f"{name}: the span path differs from the reference in {bad}")
    # the graphs' rebuilds (and the redone segments' inside their bodies)
    # go through conditional nodes; the reference selects
    if (without_glue(g_launch), g_reb, g_redos) != (without_glue(r_launch), r_reb,
                                                    redos) or r_launch["cond_set"]:
        fail(f"{name}: launches {g_launch} rebuilds {g_reb} redos {g_redos}, "
             f"reference {r_launch} {r_reb} {redos}")
    if flags is not None and redos != flags.count(False):
        fail(f"{name}: {redos} redos under {flags.count(False)} forced failures")
    starts = [int(state.step) + sum(chunks[:i]) for i in range(len(chunks))]
    rows = {"row_step_batched" if batched else "row_step": row_step_launches(
        p, [(s0, n, True) for s0, n in zip(starts, chunks)], redos)}
    if {k: g_launch[k] for k in ROW_STEP_KEYS} != {k: rows.get(k, 0) for k in ROW_STEP_KEYS} \
            or any(r_launch[k] for k in ROW_STEP_KEYS):
        fail(f"{name}: row-step launches {g_launch}, want {rows}; the twin's {r_launch}")
    node_record(name, blocks, g_launch)
    segs = [b for b in blocks if b.counted]
    if not segs:
        fail(f"{name}: no segment graph with a counted redo body")
    seg_text = ", ".join(
        f"{b.nodes['nodes']} top-level nodes ({b.nodes['conditional']} conditional), "
        f"{b.nodes['body_nodes']} in bodies, captured and instantiated in {b.capture_s:.2f} s, "
        f"{b.replays} replays" for b in segs)
    for k, v in g_launch.items():
        total[k] = total.get(k, 0) + v
    warm = None
    if flags is None:
        warm = sync_free_chunk(name, run, last_start, chunks[-1], True)
    eager_text = check_eager(name, eager_steps, warm)
    steps = sum(chunks)
    return (f"{name}: {steps} seg-aligned steps in chunks {list(chunks)}, the in-graph "
            f"decision == reference bit for bit, launches "
            f"{({k: v for k, v in g_launch.items() if v})}, rebuilds {g_reb}, redos {redos}, "
            f"{eager_text}; {capture_text(blocks)}, memory reserved after the run "
            f"+{held / 2**20:.1f} MiB; segment graphs: {seg_text}; wall "
            f"{r_wall * 1e6 / steps:.1f} us/step reference, {g_wall * 1e6 / steps:.1f} graph "
            f"(first chunk captures)" + ("; sync-free chunk ok" if flags is None else ""))


def timed_turns(name, modes, state, steps, smi) -> str:
    """Two ways of running one scene, taken in turns (a, b, b, a), each
    from a copy of ``state``: a warm-up chunk of ``n`` steps, then the
    next ``n`` steps run once (it captures the graphs of every gate
    pattern in that window), again with their wall unprofiled, then
    :func:`busy_share` of their first ``n_traced`` steps, the device alone
    traced; an eager turn's blocks stay eager throughout.  ``steps``: (n,
    n_traced); ``modes``: {label: (eager, advance(state, n) -> state)}."""
    n, n_traced = steps
    labels = list(modes)
    out = []
    for label in (labels[0], labels[1], labels[1], labels[0]):
        eager, advance = modes[label]
        with eager_blocks(eager):
            start = advance(clone_state(state), n)
            advance(clone_state(start), n)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = advance(clone_state(start), n)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6 / n
            if not bool(torch.isfinite(st.pos).all()):
                fail(f"{name} {label}: non-finite state")
            share = busy_share(lambda: advance(clone_state(start), n_traced), n_traced,
                               host_ops=False)
        dev = re.search(r"\(([0-9.]+) device us/step", share)
        plain = f", device over unprofiled wall {float(dev.group(1)) / wall:.4f}" if dev else ""
        out.append(f"{label} {wall:.1f} us/step wall{plain}, profiled busy share {share}")
    return (f"{name} ({smi}), {n} steps timed and {n_traced} traced each: "
            + " | ".join(out))


def block_choice(p, state, smi) -> str:
    """Wall us/step of the per-bot runner at each of BLOCK_CHOICES steps
    per block, in turns (8, 32, 32, 8): BLOCK_CHOICE_STEPS from
    placement, the next BLOCK_CHOICE_STEPS once (the graphs of that
    window captured), then that window again, timed."""
    from particlerobotsimulations_torch import engine
    from particlerobotsimulations_torch.engine import make_run_chunk

    keep = engine.BLOCK_STEPS
    times = {b: [] for b in BLOCK_CHOICES}
    try:
        for b in (BLOCK_CHOICES[0], BLOCK_CHOICES[1], BLOCK_CHOICES[1], BLOCK_CHOICES[0]):
            engine.BLOCK_STEPS = b
            run = make_run_chunk(p, "cuda")
            start = run(clone_state(state), BLOCK_CHOICE_STEPS)
            run(clone_state(start), BLOCK_CHOICE_STEPS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(clone_state(start), BLOCK_CHOICE_STEPS)
            torch.cuda.synchronize()
            times[b].append((time.perf_counter() - t0) * 1e6 / BLOCK_CHOICE_STEPS)
    finally:
        engine.BLOCK_STEPS = keep
    return (f"{p.n_cells} bots DENSE, steps per block {BLOCK_CHOICES[0]} against "
            f"{BLOCK_CHOICES[1]} in turns ({smi}): wall us/step "
            + ", ".join(f"B={b} {[round(t, 1) for t in v]}" for b, v in times.items())
            + f"; the module's BLOCK_STEPS is {keep}")


def small_scene_phase(smi) -> dict:
    """Phase 17: the per-bot runner's blocks (gated ones included) from
    CUDA graphs held bit for bit to the eager blocks on example.cfg and
    example_obstacle.cfg (AUTO: DENSE) and eight example.cfg seeds
    batched; the span path, each segment one graph deciding its
    adopt-or-redo on the card, held to the reference on the 1,000-bot
    band, one scene, eight seeds batched (with redos) and a failure forced
    on the card in alternate segments; eager steps per chunk; sync-free
    chunks of each runner; eager against graph in turns under the
    profiler; the block length's choice.  Returns the launches of the
    graph runs."""
    from particlerobotsimulations_torch import engine
    from particlerobotsimulations_torch.engine import make_run_chunk, make_run_chunk_batched
    from particlerobotsimulations_torch.parallel.sweep import make_batch_state

    total: dict = {}
    states = {}
    for name, dead, chunks in [(c, False, SMALL_CHUNKS) for c in SMALL_CFGS] + [
            (SMALL_DEAD_CFG, True, SMALL_DEAD_CHUNKS)]:
        t0 = time.perf_counter()
        q = pt.load_cfg(os.path.join(ROOT, "examples", name))
        if dead:
            q = q.replace(time_to_dead=SMALL_DEAD_STEP * q.timestep)
        p = resolve_params(q.validate())
        if p.resolved_backend("cuda") != pt.ForceBackend.DENSE:
            fail(f"{name}: AUTO did not choose DENSE on the card")
        state = pt.Simulation(p, device="cuda").state
        states[name] = (p, state)
        gates = gate_counts(p, 0, sum(chunks))
        if not gates["phase"] or (p.n_dead > 0 and not gates["dead"]):
            fail(f"{name}: the run passes no phase gate ({gates})")
        if dead and (p.dead_step != SMALL_DEAD_STEP or any(t_chunk.gates(p, p.dead_step)[1:])
                     or chunks[-1] % engine.BLOCK_STEPS == 0):
            fail(f"{name}: dead step {p.dead_step} on a gate, or no short last block")
        label = f" killed at step {p.dead_step}, short last block" if dead else ""
        text, _ = graph_vs_eager(f"{name} {p.n_cells} bots DENSE{label}",
                                 lambda p=p: make_run_chunk(p, "cuda"), state,
                                 list(chunks), False, total)
        print(f"phase 17a {text}; gates {gates} ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    pe, _ = states["example.cfg"]
    batch = make_batch_state(pe, list(SMALL_SEEDS), "cuda")
    text, _ = graph_vs_eager(f"{len(SMALL_SEEDS)} seeds of example.cfg batched DENSE",
                             lambda: make_run_chunk_batched(pe, "cuda"), batch,
                             list(SMALL_BATCH_CHUNKS), False, total)
    print(f"phase 17b {text} ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    pb = resolve_params(band_params().validate())
    sb = pt.Simulation(pb, device="cuda").state
    print(f"phase 17c {span_vs_reference('band 1000 HEX', pb, sb, BAND_CHUNKS, total)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    bb = make_batch_state(pb, list(SMALL_SEEDS), "cuda")
    print(f"phase 17c {span_vs_reference('band 8 seeds batched', pb, bb, BAND_BATCH_CHUNKS, total)}"
          f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    text = span_vs_reference("band 1000 HEX, span rebuilds failed on the card in alternate "
                             "segments", pb, sb, None, total, flags=list(BAND_FORCED))
    print(f"phase 17c {text} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    pbd = pb.replace(n_dead=BAND_DEAD, time_to_dead=BAND_DEAD_STEP * pb.timestep).validate()
    if pbd.dead_step != BAND_DEAD_STEP or gate_seg(pbd) != gate_seg(pb) or \
            not BAND_DEAD_CHUNKS[0] < pbd.dead_step < sum(BAND_DEAD_CHUNKS):
        fail(f"band dead scene: dead step {pbd.dead_step}, gate segment {gate_seg(pbd)}")
    text = span_vs_reference(
        f"band 1000 HEX, {pbd.n_dead} killed at step {pbd.dead_step} (a segment boundary)",
        pbd, pt.Simulation(pbd, device="cuda").state, BAND_DEAD_CHUNKS, total)
    print(f"phase 17c {text} ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    for name in SMALL_CFGS:
        p, state = states[name]
        print("phase 17e " + timed_turns(
            f"{name} {p.n_cells} bots DENSE, eager against graph", {
                "eager": (True, make_advance(make_run_chunk(p, "cuda"), False)),
                "graph": (False, make_advance(make_run_chunk(p, "cuda"), False)),
            }, state, SMALL_PROFILE_STEPS, smi), flush=True)
    print("phase 17e " + timed_turns(
        "band 1000 HEX span path, reference (eager, one read per segment) against graph", {
            "reference": (True, lambda st, n: reference_span_chunk(pb, st, n)[0]),
            "graph": (False, make_advance(make_run_chunk_table(pb), True)),
        }, sb, BAND_PROFILE_STEPS, smi), flush=True)
    print("phase 17e " + timed_turns(
        "band 1000 HEX regular path, eager against graph", {
            "eager": (True, make_advance(make_run_chunk_table(pb), False)),
            "graph": (False, make_advance(make_run_chunk_table(pb), False)),
        }, sb, BAND_PROFILE_STEPS, smi), flush=True)
    po, so = states["example_obstacle.cfg"]
    print(f"phase 17e {block_choice(po, so, smi)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return total


# ------------------------- phase 18: the sharded loop's compiled chunk

# graph against eager, chunk lengths: the 10k sharded loop from placement
# (the gates at 0, the centroid gate at 1,000), 100,000 HEX bots with 8
# spill rows, the forced-fallback scene (64 bots at 50 u/s), dp x tp (4
# seeds x 4 shards) on one ring and on two data places of 4 shards
SHARD_CHUNKS_10K = (600, 600)
SHARD_CHUNKS_100K = (100, 100)
SHARD_CHUNKS_FALLBACK = (16, 16)
# the forced-fallback scene with 5 bots killed at step 21 (mid-block), in a
# second chunk that ends in a ragged tail
SHARD_DEAD, SHARD_DEAD_STEP, SHARD_DEAD_CHUNKS = 5, 21, (16, 15)
SHARD_CHUNKS_DPTP = (200, 200)
# (timed, traced) steps of each eager / graph turn: 10k, dp x tp
SHARD_PROFILE_STEPS, DPTP_PROFILE_STEPS = (600, 200), (400, 100)


def sharded_chunks(make_runner, state, chunks, eager):
    """A fresh sharded runner (``with_stats``) over ``chunks`` from a copy of
    ``state``, its blocks eager or replayed from graphs (counted), the
    counters reset just before: a record as :func:`chunks_run` gives it,
    with each chunk's stats."""
    from types import SimpleNamespace

    with eager_blocks(eager, True) as blocks:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        run = make_runner()
        state = clone_state(state)
        reset_counts()
        stats, eager_steps, last_start = [], [], None
        t0 = time.perf_counter()
        for n in chunks:
            start = state.step
            last_start = clone_state(state)
            before = t_chunk.EAGER["card"]
            state, st = run(state, n)
            stats.append(st)
            eager_steps.append((start, n, t_chunk.EAGER["card"] - before))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        held = torch.cuda.memory_reserved() - reserved
    return SimpleNamespace(run=run, state=state, launches=dict(kernels.LAUNCHES), stats=stats,
                           wall=wall, blocks=blocks, eager_steps=eager_steps,
                           last_start=last_start, held=held)


def sharded_graph_vs_eager(name, make_runner, state, chunks, total):
    """``chunks`` through an eager and a graph run of one sharded runner
    kind from one state: bit for bit, with equal launches and equal
    ``fallbacks`` and ``spill_rows_max`` per chunk, each chunk's eager
    steps (warm-ups); then the last chunk again on the warm graph runner
    under ``set_sync_debug_mode("error")``, its blocks drained there with
    no eager step and its stats read after.  Adds the graph run's launches to ``total``; returns
    (text, the graph run's end state, its stats per chunk)."""
    e = sharded_chunks(make_runner, state, chunks, True)
    g = sharded_chunks(make_runner, state, chunks, False)
    if not states_equal(e.state, g.state):
        bad = [k for k in ARRAY_FIELDS if not torch.equal(getattr(e.state, k),
                                                          getattr(g.state, k))]
        fail(f"{name}: graph run differs from the eager run in {bad}")
    if (without_cond_set(e.launches), e.stats) != (without_cond_set(g.launches), g.stats) \
            or e.launches["cond_set"]:
        fail(f"{name}: eager launches {e.launches} stats {e.stats}, graph {g.launches} "
             f"{g.stats}")
    rec = node_record(name, g.blocks, g.launches)
    for k, v in g.launches.items():
        total[k] = total.get(k, 0) + v
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    before = t_chunk.EAGER["card"]
    try:
        result = t_chunk.drain(g.run.blocks(g.last_start, chunks[-1]))
    except RuntimeError as err:
        fail(f"{name}: a chunk waited for the card: {err}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eager_text = check_eager(name, g.eager_steps, t_chunk.EAGER["card"] - before)
    out, free_stats = g.run.read_stats(result)
    if not bool(torch.isfinite(out.pos).all()):
        fail(f"{name}: non-finite state after the sync-free chunk")
    steps = sum(chunks)
    used = {k: v for k, v in g.launches.items() if v}
    return (f"{name}: {steps} steps in chunks {list(chunks)}, graph (node) == eager (select) "
            f"bit for bit, launches {used}, stats per chunk {g.stats}; {len(g.blocks)} graphs, "
            f"{capture_text(g.blocks)}, {memory_text(g.held, e.held)}; {eager_text}; "
            f"{node_text(rec)}; wall {e.wall * 1e6 / steps:.1f} us/step eager, "
            f"{g.wall * 1e6 / steps:.1f} graph (first chunk captures); sync-free chunk ok "
            f"({free_stats})"), g.state, g.stats


def sharded_rebuild_cost(p, state) -> str:
    """The sharded rebuild through its conditional node against the
    incremental rebuild alone and against the select, on ``state``'s table
    split over a ``LocalRing`` after one step's integrate, the exact branch
    forced by a bot moved two cells: per-rebuild device times in a graph,
    and the exact rebuild's device time by op."""
    from particlerobotsimulations_torch.engine_table import _exact_rebuild

    run, p = make_sharded_table_run(p, LocalRing(N_SHARDS, "cuda"))
    parts = run.parts
    pre, _ = make_table_step_parts(p)
    ts = pre(enter_table(p, state), False, False, False)
    f = parts["split_local"](ts.fields)
    far = parts["split_local"](far_fields(p, ts.fields))

    def select():
        inc, ok = parts["incremental"](f, ts.origin)
        gf, origin = _exact_rebuild(p, parts["join_global"](f))
        exact = parts["split_local"](gf)
        return ({k: torch.where(ok, inc[k], exact[k]) for k in TABLE_FIELDS},
                torch.where(ok, ts.origin, origin))

    text = branch_costs(lambda: parts["incremental"](f, ts.origin), select,
                        lambda: parts["rebuild"](f, ts.origin),
                        lambda: parts["rebuild"](far, ts.origin))
    return (f"G={p.resolved_grid_dim()} Cs={p.storage_capacity()}: {text}; the exact rebuild's "
            f"device time by op: {exact_rebuild_ops(p, ts)}")


def sharded_compiled_phase(smi) -> dict:
    """Phase 18: the sharded loop's ungated K-step blocks from CUDA graphs,
    held bit for bit to the eager blocks at 10k, at 100k with spill rows,
    in the forced-fallback scene, in dp x tp on one ring and on two data
    places; sync-free chunks of each; the select's cost at G=64 and at
    100k; eager against graph in turns under the profiler at 10k and in dp
    x tp on one ring and on two data places.  Returns the graph runs'
    launches."""
    from particlerobotsimulations_torch.parallel.mesh import Mesh
    from particlerobotsimulations_torch.parallel.spatial_table import (
        make_sharded_table_run_batched,
    )
    from particlerobotsimulations_torch.parallel.sweep import make_batch_state

    total: dict = {}
    base = resolve_params(bench_params().validate())
    ring = LocalRing(N_SHARDS, "cuda")
    p10 = resolve_tp_params(base, N_SHARDS)
    k = max(1, p10.resolved_slot_rebuild_steps())
    gates = gate_counts(p10, 0, sum(SHARD_CHUNKS_10K))
    if gates["centroid"] < 2:
        fail(f"phase 18 10k chunks cross no centroid gate ({gates})")
    s10 = pt.Simulation(p10, device="cuda").state
    t0 = time.perf_counter()
    text, _, _ = sharded_graph_vs_eager(
        f"10k HEX LocalRing({N_SHARDS}) G={p10.resolved_grid_dim()} K={k}, gates {gates}",
        lambda: make_sharded_table_run(p10, ring, with_stats=True)[0], s10,
        SHARD_CHUNKS_10K, total)
    print(f"phase 18 {text} ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    p100 = resolve_tp_params(
        resolve_params(bench_params().replace(n_cells=GRAPH_N_100K, overflow_slots=8).validate()),
        N_SHARDS)
    s100 = pt.Simulation(p100, device="cuda").state
    text, end100, _ = sharded_graph_vs_eager(
        f"100k HEX with 8 spill rows (G={p100.resolved_grid_dim()}, Cs={p100.storage_capacity()})",
        lambda: make_sharded_table_run(p100, ring, with_stats=True)[0], s100,
        SHARD_CHUNKS_100K, total)
    if cell_overflow(p100, end100, cap=p100.storage_capacity()):
        fail("phase 18 100k: bots parked beyond the spill rows")
    print(f"phase 18 {text} ({time.perf_counter() - t0:.1f} s)", flush=True)

    pf = resolve_tp_params(base.replace(n_cells=64, phase_std=0.0, light_x=-5.0), N_SHARDS)
    sf = state_from_arrays(pf, jittered_arrays(pf, (50.0, 0.0)), "cuda")
    text, _, fb_stats = sharded_graph_vs_eager(
        "forced fallback 64 bots 50 u/s",
        lambda: make_sharded_table_run(pf, ring, with_stats=True)[0], sf,
        SHARD_CHUNKS_FALLBACK, total)
    if not all(st["fallbacks"] for st in fb_stats):
        fail(f"phase 18 forced fallback: a chunk took no fallback: {fb_stats}")
    print(f"phase 18 {text}", flush=True)
    pfd = pf.replace(n_dead=SHARD_DEAD, time_to_dead=SHARD_DEAD_STEP * pf.timestep).validate()
    kf = max(1, pfd.resolved_slot_rebuild_steps())
    if pfd.dead_step != SHARD_DEAD_STEP or (pfd.dead_step - SHARD_DEAD_CHUNKS[0]) % kf == 0 \
            or SHARD_DEAD_CHUNKS[-1] % kf == 0:
        fail(f"phase 18 dead scene: dead step {pfd.dead_step} at K={kf}")
    sfd = state_from_arrays(pfd, jittered_arrays(pfd, (50.0, 0.0)), "cuda")
    text, end_fd, _ = sharded_graph_vs_eager(
        f"{pfd.n_dead} of 64 bots at 50 u/s killed at step {pfd.dead_step} (mid-block), "
        f"ragged tail", lambda: make_sharded_table_run(pfd, ring, with_stats=True)[0], sfd,
        SHARD_DEAD_CHUNKS, total)
    if int(end_fd.dead[: pfd.n_cells].sum()) != pfd.n_dead:
        fail(f"phase 18 dead scene: {int(end_fd.dead[: pfd.n_cells].sum())} dead")
    print(f"phase 18 {text}", flush=True)

    seeds = list(DPTP_SEEDS)
    batch = make_batch_state(p10, seeds, "cuda")
    t0 = time.perf_counter()
    text, _, _ = sharded_graph_vs_eager(
        f"dp x tp {len(seeds)} seeds x {N_SHARDS} shards",
        lambda: make_sharded_table_run_batched(p10, ring, with_stats=True)[0], batch,
        SHARD_CHUNKS_DPTP, total)
    print(f"phase 18 {text} ({time.perf_counter() - t0:.1f} s)", flush=True)
    mesh = Mesh(np.array(["cuda"] * (2 * N_SHARDS), dtype=object).reshape(2, N_SHARDS),
                ("data", "bots"))
    t0 = time.perf_counter()
    text, _, _ = sharded_graph_vs_eager(
        f"dp x tp {len(seeds)} seeds on Mesh(['cuda'] * 2) x {N_SHARDS} shards (interleaved)",
        lambda: make_sharded_table_run_batched(p10, mesh=mesh, with_stats=True)[0], batch,
        SHARD_CHUNKS_DPTP, total)
    print(f"phase 18 {text} ({time.perf_counter() - t0:.1f} s)", flush=True)

    print(f"phase 18 rebuild cost {sharded_rebuild_cost(p10, s10)}", flush=True)
    print(f"phase 18 rebuild cost {sharded_rebuild_cost(p100, s100)}", flush=True)

    t0 = time.perf_counter()
    print("phase 18 " + timed_turns(
        f"10k HEX sharded LocalRing({N_SHARDS}) K={k}, eager against graph", {
            "eager": (True, make_advance(make_sharded_table_run(p10, ring)[0])),
            "graph": (False, make_advance(make_sharded_table_run(p10, ring)[0])),
        }, s10, SHARD_PROFILE_STEPS, smi), flush=True)
    print("phase 18 " + timed_turns(
        f"dp x tp {len(seeds)} seeds x {N_SHARDS} shards, eager against graph (per batched step)", {
            "eager": (True, make_advance(make_sharded_table_run_batched(p10, ring)[0])),
            "graph": (False, make_advance(make_sharded_table_run_batched(p10, ring)[0])),
        }, batch, DPTP_PROFILE_STEPS, smi), flush=True)
    print("phase 18 " + timed_turns(
        f"dp x tp {len(seeds)} seeds on Mesh(['cuda'] * 2) x {N_SHARDS} shards, eager against "
        "graph (per batched step)", {
            "eager": (True, make_advance(make_sharded_table_run_batched(p10, mesh=mesh)[0])),
            "graph": (False, make_advance(make_sharded_table_run_batched(p10, mesh=mesh)[0])),
        }, batch, DPTP_PROFILE_STEPS, smi) + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    return total


# ------------------------------- phase 19: the rebuild's conditional node

# the scenes phases 16 and 18 hold graph (a conditional node per rebuild)
# against eager (the select), by the names those phases give them
COND_SCENES = {
    "10k adaptive": lambda n: n.startswith("10k adaptive"),
    "100k at G=160 without spill rows": lambda n: n == "100k HEX",
    "eight 10k seeds batched": lambda n: n.endswith("seeds x 10k batched"),
    "10k sharded on LocalRing(4)": lambda n: n.startswith("10k HEX LocalRing"),
    "100k sharded with 8 spill rows": lambda n: n.startswith("100k HEX with 8 spill rows"),
    "64 bots at 50 u/s": lambda n: n.startswith("forced fallback"),
    "dp x tp 4 x 4": lambda n: n.startswith("dp x tp") and "Mesh" not in n,
}
# conds per graph in the cond_set timing
COND_TIMING_CONDS = 20


def node_scenes() -> str:
    """Phases 16 and 18's node records of the COND_SCENES, checked: each
    scene's graphs hold one conditional node per K-step block (one rebuild
    each) with a body, replayed at least once; the 100k table without
    spill rows took both branches inside its replays and the 50 u/s scene
    the exact one."""
    out = []
    for label, match in COND_SCENES.items():
        recs = [r for r in NODE_SCENES if match(r["name"])]
        if not recs:
            fail(f"phase 19: no graph-against-eager record of {label}")
        rec = recs[0]
        taken = rec["replayed_rebuilds"]
        if not rec["conditional"] or set(rec["conditional"]) != {1} or min(rec["body_nodes"]) < 1 \
                or rec["replays"] < 1:
            fail(f"phase 19 {label}: node record {rec}")
        if label.startswith("100k at") and not (taken["incremental"] and taken["exact"]):
            fail(f"phase 19 {label}: both branches did not run inside the replays: {taken}")
        if label.startswith("64 bots") and not taken["exact"]:
            fail(f"phase 19 {label}: no exact rebuild inside the replays: {taken}")
        out.append(f"{label}: {node_text(rec)}")
    return " | ".join(out)


def cond_set_check(p, state) -> tuple:
    """Kernel ``cond_set`` with its node against the plain select at the
    main path's shapes: the 10k table rebuild (``_choose_rebuild``) after
    one step's integrate, captured with its node and replayed, against the
    eager select on the same carry, once with the incremental branch
    taken and once with the exact (a bot moved two cells): bit for bit.
    Returns (max |diff|, text)."""
    from particlerobotsimulations_torch.engine_table import _choose_rebuild

    pre, _ = make_table_step_parts(p)
    ts = pre(enter_table(p, state), False, False, False)
    err, seen = 0.0, []
    for want_ok, t in ((True, ts), (False, ts.replace(fields=far_fields(p, ts.fields)))):
        def block(carry, step, t=t):
            got, ok = _choose_rebuild(p, t)
            return {**{f"r_{k}": v for k, v in got.fields.items()}, "r_origin": got.origin,
                    "r_ok": ok}

        eager = block(None, None)
        graph = t_chunk.CapturedBlock(block, {"x": torch.zeros(1, device="cuda")})
        out = graph(graph.carry, 0)
        torch.cuda.synchronize()
        if bool(out["r_ok"]) != want_ok or bool(eager["r_ok"]) != want_ok:
            fail(f"cond_set check: ok {bool(out['r_ok'])} / {bool(eager['r_ok'])}, want {want_ok}")
        if graph.nodes["conditional"] != 1:
            fail(f"cond_set check: nodes {graph.nodes}")
        for k, v in eager.items():
            if k != "r_ok":
                err = max(err, float((out[k] - v).abs().max()))
                if not torch.equal(out[k], v):
                    fail(f"cond_set check: the node's {k} differs from the select's")
        seen.append(f"{'incremental' if want_ok else 'exact'} taken, graph nodes {graph.nodes}")
    return err, "; ".join(seen)


def cond_phase(p10, main_state, k_live, smi) -> tuple:
    """Phase 19: the conditional nodes of phases 16 and 18's graphs,
    kernel ``cond_set`` against the select at the main path's shapes, its
    time per cond (the kernel and the node, the body not taken, and
    taken) against the select's, and the 10k K=8 table loop eager against
    graph when phase 16's probe kept K=4.  Returns (the kernel's record
    without its launches, text lines)."""
    from particlerobotsimulations_torch.ops.cond import cond

    lines = [f"phase 19 nodes: {node_scenes()}"]
    err, text = cond_set_check(p10, main_state)
    x = torch.ones(1, device="cuda")
    y = torch.zeros(1, device="cuda")
    ok = torch.ones((), dtype=torch.bool, device="cuda")

    def one():
        cond(ok, lambda o: {"y": y}, lambda o: {"y": o["x"]}, {"x": x})

    ms = graph_ms(one, launches=COND_TIMING_CONDS)
    ok.fill_(False)
    taken_ms = graph_ms(one, launches=COND_TIMING_CONDS)
    plain_ms = graph_ms(lambda: torch.where(ok, y, x), launches=COND_TIMING_CONDS)
    # one byte read (ok) and one operation; the handle is no memory write
    b = bound(1, 1)
    lines.append(
        f"phase 19 cond_set vs the select at 10k G={p10.resolved_grid_dim()}: bit for bit "
        f"(max|diff| {err:.1e}); {text} | per cond in a graph of {COND_TIMING_CONDS}: "
        f"{ms * 1e3:.2f} us with the body not taken, {taken_ms * 1e3:.2f} with a one-copy body "
        f"taken; the select torch.where on the same inputs {plain_ms * 1e3:.2f} us; bound "
        f"(ms, by) {b}")
    if k_live != 8:
        lines.append(f"phase 19 10k K=8 eager against graph ({smi}), {GRAPH_PROFILE_STEPS} steps "
                     f"each (eager, graph, graph, eager): {profiled_modes(p10, main_state, 8)}")
    row = {"name": "cond_set", "route": "cuda",
           "source": "particlerobotsimulations_torch/csrc/graph_cond.cu",
           "replaces": "particlerobotsimulations_tpu/engine_table.py:274",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
    return row, lines


# ----------------------------------------- phase 20: the row step

# the planes each mode of the row step reads (row_step.cu's reads(); a
# post reads px, py and rad too where there are obstacles)
ROW_STEP_READS = {
    "post": ("vx", "vy", "val", "pay"),
    "pre": ("px", "py", "vx", "vy", "rad", "val", "phase", "dead", "aa", "ar"),
    "post_pre": ("px", "py", "vx", "vy", "rad", "val", "phase", "dead", "pay"),
}
# where the JAX package runs the glue the row step replaces (step_pre's
# radius and integrate, step_post's pad, obstacles, friction and validity)
ROW_STEP_REPLACES = "particlerobotsimulations_tpu/engine_table.py:539"


def row_step_bound(p, fields, mode) -> tuple:
    """The bound of one launch in ``mode`` on ``fields``: the planes it
    reads and writes, kernel 1's four sums where it posts, and kernel 3's
    per-row operations (bytes bind it)."""
    rows = fields["px"].numel()
    n_obs = len(p.rect_obstacles) + len(p.circle_obstacles)
    reads = set(ROW_STEP_READS[mode])
    if mode != "pre" and n_obs:
        reads |= {"px", "py", "rad"}
    n_bytes = (len(reads) + len(kernels.ROW_STEP_WRITES[mode])) * rows * 4
    if mode != "pre":
        scenes = rows // fields["px"].shape[-1]
        n_bytes += 4 * scenes * p.cell_capacity * p.resolved_grid_dim() ** 2 * 4
    return bound(n_bytes, rows * (ROW_OPS + OBSTACLE_OPS * n_obs))


def row_step_check(p, ts) -> dict:
    """The row step against its twin on the planes of the table state
    ``ts`` (one scene, or B scenes batched), kernel 1's sums of its table
    given to the modes that post: each mode on the card and through the
    twin on the same planes, equal to the bit on all 13 planes.  Per mode:
    the kernel's time per launch in a CUDA graph of 20 (``ms``), the
    twin's per call (``plain_ms``) and in a CUDA graph of 20
    (``library_ms``: the PyTorch ops the table loop replayed before the
    row step) and the bound.  Returns {mode: record}."""
    g, cap = p.resolved_grid_dim(), p.cell_capacity
    f = ts.fields
    names = ("px", "py", "vx", "vy", "rad") + (("afac",) if p.has_payload else ())
    forces = stencil_forces(p, {k: f[k][..., : cap * g * g].unflatten(-1, (cap, g * g))
                                for k in names})
    step = step_tensor(ts.step, f["px"].device)
    out = {}
    for mode in kernels.ROW_STEP_MODES:
        fr = None if mode == "pre" else forces
        got = kernels.row_step_cuda(p, f, mode, step, 1, fr)
        want = row_step_plain(p, f, mode, step, 1, fr)
        for k in TABLE_FIELDS:
            if not torch.equal(got[k], want[k]):
                fail(f"row step {mode} on {tuple(f['px'].shape)} planes: {k} differs from "
                     f"the twin in {int((got[k] != want[k]).sum())} rows")
        out[mode] = {
            "ms": graph_ms(lambda: kernels.row_step_cuda(p, f, mode, step, 1, fr)),
            "plain_ms": median_ms(lambda: row_step_plain(p, f, mode, step, 1, fr)),
            "library_ms": graph_ms(lambda: row_step_plain(p, f, mode, step, 1, fr)),
            "bound": row_step_bound(p, f, mode),
        }
    return out


def row_step_phase(p10, main_state, sweep_state) -> tuple:
    """Phase 20: the row step against its twin at the main path's shapes,
    the 10k table after phase 4's 3,000 steps and the 10k sweep's eight
    tables after phase 12's 200 (:func:`row_step_check`).  Returns
    ({name: {mode: record}}, text lines)."""
    out, lines = {}, []
    for name, ts in (("row_step", enter_table(p10, main_state)),
                     ("row_step_batched", enter_table(p10, sweep_state))):
        out[name] = row_step_check(p10, ts)
        lines.append(
            f"phase 20 {name} on {tuple(ts.fields['px'].shape)} planes, each mode bit for bit "
            f"its twin: " + "; ".join(
                f"{mode} {v['ms'] * 1e3:.2f} us per launch in a CUDA graph, twin "
                f"{v['plain_ms'] * 1e3:.1f} us per call and {v['library_ms'] * 1e3:.1f} us in a "
                f"CUDA graph, bound (ms, by) ({v['bound'][0]:.4g}, {v['bound'][1]})"
                for mode, v in out[name].items()))
    return out, lines


# ----------------------------------------- phase 21: the dense step

# where the JAX package runs the DENSE step the dense step replaces
DENSE_STEP_REPLACES = "particlerobotsimulations_tpu/ops/forces.py dense_collide (engine.py's step)"
# bytes a row reads (pos, vel, rad, phase, aa, ar; dead) and writes (pos,
# vel, rad, aa, ar)
DENSE_ROW_BYTES = 4 * 8 + 1 + 4 * 7
# operations of a real pair out of reach of both laws (dx, dy, two
# products, a sum, one compare against the target's squared reach) and of
# one in reach (PAIR_OPS and its branch)
DENSE_FAR_OPS, DENSE_NEAR_OPS = 6, PAIR_OPS + 24


def dense_step_bound(p, arrays, stepped) -> tuple:
    """The bound of one dense-step launch on ``arrays``: every field read
    and written once; every real pair's distance, the whole term for the
    pairs in reach after the pre (``stepped``: the step's outputs), the
    row arithmetic and obstacles of every row (operations bind it)."""
    n, n_pad = p.n_cells, arrays["pos"].shape[-2]
    pos, rad = stepped["pos"][..., :n, :], stepped["rad"][..., :n]
    rows = arrays["rad"].numel()
    reach = torch.cdist(pos, pos) < torch.clamp(rad[..., :, None] + rad[..., None, :],
                                                min=p.cutoff())
    near = int(reach.sum()) - reach.shape[-1] * (rows // n_pad)
    pairs = (rows // n_pad) * n * (n - 1)
    n_obs = len(p.rect_obstacles) + len(p.circle_obstacles)
    ops = (pairs - near) * DENSE_FAR_OPS + near * DENSE_NEAR_OPS + rows * (
        ROW_OPS + OBSTACLE_OPS * n_obs)
    return bound(rows * DENSE_ROW_BYTES, ops)


def dense_step_phase() -> tuple:
    """Phase 21: the dense step against its twin on ``example_obstacle.cfg``
    (500 RANDOM bots, 3 circles; AUTO: DENSE), one scene and 8 seeds 300
    steps in (each chunk's launches counted from 0: 300 of its key, none
    of the other): the positions and radii bit for bit, velocities and force
    magnitudes within the sum order's tolerance (rtol 1e-5, atol 1e-5 x
    max|f|).  Per shape: the kernel's time per launch in a CUDA graph of 20
    (``ms``), the twin's per call (``plain_ms``) and in a CUDA graph of 20
    (``library_ms``: the PyTorch ops the runner replayed before), the bound,
    the launch plan and the chunk's launches.  Returns ({name: record},
    text lines)."""
    from particlerobotsimulations_torch.engine import make_run_chunk, make_run_chunk_batched
    from particlerobotsimulations_torch.parallel.sweep import make_batch_state

    p = pt.load_cfg(os.path.join(ROOT, "examples", "example_obstacle.cfg"))
    if p.resolved_backend("cuda") != pt.ForceBackend.DENSE:
        fail("phase 21: example_obstacle.cfg does not run DENSE on the card")
    keys = ("dense_step", "dense_step_batched")
    runs = {}
    for name, run, state in (
            ("dense_step", make_run_chunk(p, "cuda"), pt.Simulation(p, device="cuda").state),
            ("dense_step_batched", make_run_chunk_batched(p, "cuda"),
             make_batch_state(p, list(range(8)), "cuda"))):
        # the main path's own launches: the chunk alone, counted from 0
        for k in keys:
            kernels.LAUNCHES[k] = 0
        state = run(state, 300)
        counts = {k: kernels.LAUNCHES[k] for k in keys}
        if counts != {k: 300 if k == name else 0 for k in keys}:
            fail(f"phase 21: a 300-step DENSE chunk launched {counts}, not 300 {name}")
        runs[name] = (state, counts[name])
    out, lines = {}, []
    for name, (state, n_launched) in runs.items():
        arrays = {k: getattr(state, k) for k in ARRAY_FIELDS}
        s = step_tensor(state.step, "cuda")
        got = kernels.dense_step_cuda(p, arrays, s)
        want = dense_step_plain(p, arrays, s)
        torch.cuda.synchronize()
        for k in ("pos", "rad"):
            if not torch.equal(got[k], want[k]):
                fail(f"phase 21 {name}: {k} differs from the twin")
        err = 0.0
        for k in ("vel", "abs_force_a", "abs_force_r"):
            scale = float(want[k].abs().max())
            excess = (got[k] - want[k]).abs() - (1e-5 * want[k].abs() + 1e-5 * scale)
            if not scale > 0 or float(excess.max()) > 0:
                fail(f"phase 21 {name}: {k} outside the sum order's tolerance of the twin")
            err = max(err, float((got[k] - want[k]).abs().max()))
        scenes = state.pos.shape[0] if state.pos.dim() == 3 else 1
        plan = kernels.dense_plan(scenes, state.n_pad,
                                  torch.cuda.get_device_properties(0).multi_processor_count)
        out[name] = {
            "ms": graph_ms(lambda: kernels.dense_step_cuda(p, arrays, s)),
            "plain_ms": median_ms(lambda: dense_step_plain(p, arrays, s)),
            "library_ms": graph_ms(lambda: dense_step_plain(p, arrays, s)),
            "bound": dense_step_bound(p, arrays, want), "err": err, "plan": plan,
            "launches": n_launched,
        }
        v = out[name]
        lines.append(
            f"phase 21 {name} on {tuple(state.pos.shape)}: {n_launched} launches in the "
            f"300-step chunk; pos and rad bit for bit its twin, "
            f"vel and the magnitudes within the sum order (max|diff| {err:.3g}); "
            f"{v['ms'] * 1e3:.2f} us per launch in a CUDA graph (plan {plan}), twin "
            f"{v['plain_ms'] * 1e3:.1f} us per call and {v['library_ms'] * 1e3:.1f} us in a "
            f"CUDA graph, bound (ms, by) ({v['bound'][0]:.4g}, {v['bound'][1]})")
    return out, lines


def make_advance(run, aligned=None):
    """``advance(state, n)``: one chunk of ``run`` (``aligned`` passed on
    where given: the table runners take it); a fresh runner's first call
    builds its graphs."""
    if aligned is None:
        return lambda st, n: run(st, n)
    return lambda st, n: run(st, n, aligned)


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
    print(f"phase 2 build: {build_s:.2f} s {kernels.library_path().name} | "
          f"{ptxas_report(kernels.BUILD_LOG)}")
    p10 = bench_params().validate()
    g10, c10 = p10.resolved_grid_dim(), p10.cell_capacity
    k1_plan = kernels.stencil_plan(c10, g10, p10.has_payload)
    lib1 = kernels.library_stencil_plan(c10, g10, p10.has_payload)
    if lib1 != k1_plan:
        fail(f"kernel 1 plan: library {lib1}, python {k1_plan}")
    pb = band_params().validate()
    k3_args = (pb.storage_capacity(), pb.resolved_grid_dim(), pt.config.padded_n(pb),
               pb.has_payload)
    k3_plan, lib3 = kernels.mega_plan(*k3_args), kernels.library_mega_plan(*k3_args)
    if any(lib3[k] != k3_plan[k] for k in ("cluster", "rows", "smem")):
        fail(f"kernel 3 plan: library {lib3}, python {k3_plan}")
    if k3_plan["cluster"] < 2 or lib3["max_active_clusters"] < 1:
        fail(f"kernel 3 plan: {lib3}")
    p4 = resolve_tp_params(p10, N_SHARDS)
    g4 = p4.resolved_grid_dim()
    l4 = g4 * g4 // N_SHARDS
    k4_args = (p4.cell_capacity, g4, p4.has_payload, l4 // g4, N_SHARDS)
    k4_plan = kernels.stencil_plan(*k4_args)
    lib4 = kernels.library_stencil_plan(*k4_args)
    if lib4 != k4_plan:
        fail(f"kernel 4 plan: library {lib4}, python {k4_plan}")
    blocks = N_SHARDS * len(DPTP_SEEDS)
    k4b_args = k4_args[:-1] + (blocks,)
    k4b_plan = kernels.stencil_plan(*k4b_args)
    if kernels.library_stencil_plan(*k4b_args) != k4b_plan:
        fail(f"kernel 4 plan at {blocks} blocks: library "
             f"{kernels.library_stencil_plan(*k4b_args)}, python {k4b_plan}")
    k2_plans = {}
    for name, q, lanes, shards in (("10k", p10, g10 * g10, 1),
                                   ("band", pb, pb.resolved_grid_dim() ** 2, 1),
                                   ("sharded", p4, l4, N_SHARDS),
                                   ("dp x tp", p4, l4, blocks)):
        k2_args = (q.storage_capacity(), lanes, shards)
        k2_plans[name] = kernels.compact_plan(*k2_args)
        if kernels.library_compact_plan(*k2_args) != k2_plans[name]:
            fail(f"kernel 2 plan {name}: library {kernels.library_compact_plan(*k2_args)}, "
                 f"python {k2_plans[name]}")
    print(
        f"phase 2 plans: 10k G={g10} C={c10}: stencil_forces {k1_plan} | band "
        f"G={k3_args[1]} C={k3_args[0]}: mega_span cluster of {k3_plan['cluster']} "
        f"CTAs x {kernels.MEGA_THREADS} threads, {k3_plan['grid_rows']} grid rows = "
        f"{k3_plan['rows']} table rows and {k3_plan['smem']} B of shared memory per "
        f"CTA, cudaOccupancyMaxActiveClusters {lib3['max_active_clusters']} | sharded "
        f"G={g4} ({N_SHARDS} shards of {l4 // g4} rows): stencil_forces_ext {k4_plan}, "
        f"at {blocks} dp x tp blocks {k4b_plan} | "
        f"compact ({kernels.COMPACT_LANES} lanes per block) {k2_plans}"
    )

    # 3. kernels against their twins on the card
    params = bench_params()
    p, tables, planes = main_path_tables(params)
    k1_err = compare_stencil(p, tables)
    k2_ovf, k2_err = compare_compact(p, planes)
    for over in ({}, SPILL_40):
        psyn, syn = synthetic_planes(**over)
        syn_ovf, _ = compare_compact(psyn, syn)
        if not syn_ovf:
            fail(f"synthetic compaction table {over} did not overflow")
    movers = movers_of(planes)
    k1_ms = graph_ms(lambda: kernels.stencil_forces_cuda(p, tables))
    k1_plain_ms = median_ms(lambda: stencil_forces_plain(p, tables))
    k2_ms = graph_ms(lambda: kernels.compact_cuda(p, planes))
    k2_plain_ms = median_ms(lambda: compact_plain(p, planes))
    dpos, dvel = small_run_check()
    holes = hole_tables(p, 21)
    n_holes = holes_in_slot_order(holes)
    if n_holes == 0:
        fail("synthetic kernel-1 table has no holes in its slot order")
    k1_holes_err = compare_stencil(p, holes)
    pay_p = p.replace(n_dead=-1, attraction_factor=2.0).validate()
    k1_pay_err = compare_stencil(pay_p, hole_tables(pay_p, 22))
    print(
        f"phase 3 kernels vs twins: stencil_forces G={p.resolved_grid_dim()} "
        f"max|diff| {k1_err:.3e} (atol {K1_ATOL}, rtol {K1_RTOL}, "
        f"fx/fy + {K1_SUM_RTOL}*(fa+fr)); slot holes in {n_holes} cells "
        f"{k1_holes_err:.3e}; payload {k1_pay_err:.3e}; "
        f"{k1_ms * 1e3:.1f} us vs plain {k1_plain_ms * 1e3:.1f} us | compact "
        f"equal ({movers} movers, overflow {k2_ovf}; synthetic Cs=16 and Cs=40 "
        f"overflow) {k2_ms * 1e3:.1f} us vs plain {k2_plain_ms * 1e3:.1f} us "
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
    if not (launches["stencil_forces"] > 0 and launches["compact"] > 0
            and 0 < launches["cond_set"] <= launches["compact"]):
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
    print(
        "phase 4 profile: 10k HEX 200 steps, device busy share "
        f"{busy_share(seg_steps(sim, 200), 200)}"
    )
    main_state = sim.state

    # 5. the CLI
    n_rows, cli_s, cli_tail = run_cli()
    print(f"phase 5 cli: example.cfg pallas 180 s -> {n_rows} rows in {cli_s:.1f} s | {cli_tail}")

    # 6. kernel 3 against its twin on four scenes, and the span schedule
    k3 = {}  # scene -> (max |diff|, max |dpos|, kernel ms, inputs)
    for name, sim in span_scenes().items():
        sp, tbl, strip, first = span_inputs(sim)
        err, dpos = compare_span(name, sp, tbl, strip, first)
        ms = graph_ms(lambda: kernels.mega_span_cuda(sp, tbl, strip, first))
        call_ms = median_ms(lambda: kernels.mega_span_cuda(sp, tbl, strip, first))
        k3[name] = (err, dpos, ms, (sp, tbl, strip, first), call_ms)
    k3_err = max(v[0] for v in k3.values())
    _, _, k3_ms, (bp, btbl, bstrip, bfirst), _ = k3["hex1000"]
    k3_plain_ms = median_ms(lambda: mega_span_plain(bp, btbl, bstrip, bfirst))
    scenes = " ".join(
        f"{name} max|diff| {v[0]:.2e} (dpos {v[1]:.2e}) {v[2] * 1e3:.1f} us in a "
        f"CUDA graph ({v[4] * 1e3:.1f} us per wrapper call);"
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
    p7, _, band_planes = main_path_tables(band_params())
    b2_ovf, _ = compare_compact(p7, band_planes)
    b2_ms = graph_ms(lambda: kernels.compact_cuda(p7, band_planes))
    print(
        f"phase 7 compact on the band's G={p7.resolved_grid_dim()} table after 200 "
        f"steps: equal ({movers_of(band_planes)} movers, overflow {b2_ovf}) "
        f"{b2_ms * 1e3:.1f} us in a CUDA graph, bound (ms, by) {compact_bound(band_planes)}"
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

    # 9. the sharded table loop on a LocalRing(4)
    t9 = time.perf_counter()
    record9, lines9 = sharded_phase()
    for line in lines9:
        print(line)
    print(f"phase 9 took {time.perf_counter() - t9:.1f} s")

    # 10. the per-bot paths from the main path's state, counters reset just
    #     before each
    t10 = time.perf_counter()
    per_bot_launches, (p_bot, bot_state), lines10 = per_bot_phase(main_state)
    for line in lines10:
        print(line)
    # 11. kernels 1 and 4 past 32 slots
    lines11 = wide_slot_phase(p_bot, bot_state)
    for line in lines11:
        print(line)
    print(f"phases 10-11 took {time.perf_counter() - t10:.1f} s")

    # 12. the sweep: batched runs of eight seeds against sequential ones
    t12 = time.perf_counter()
    kc, sweep_counts, sweep_state = sweep_phase()
    print(f"phase 12 took {time.perf_counter() - t12:.1f} s")

    # 13. checkpoints and video at 10k, the CLI resume on the span path,
    #     the differentiable path; counters reset just before each
    t13 = time.perf_counter()
    launches13 = resume_phase()
    print(f"phase 13 took {time.perf_counter() - t13:.1f} s")

    # 14. the multi-device layer: the dry run, the dp x tp table loop (the
    #     counters reset just before), the mesh sweep
    t14 = time.perf_counter()
    launches14, kc14 = multi_device_phase(smi)
    print(f"phase 14 took {time.perf_counter() - t14:.1f} s")

    # 15. the measurement and parity layer: the profiling helpers, the
    #     bench, the fullscale and parity scripts (counters reset before each)
    t15 = time.perf_counter()
    launches15 = measurement_phase()
    print(f"phase 15 took {time.perf_counter() - t15:.1f} s; launches {launches15}")

    # 16. the graphed chunk: graph against eager on three scenes (the
    #     counters reset just before each run), sync-free chunks, the
    #     two-place bench
    t16 = time.perf_counter()
    launches16, k_live = graph_phase(main_state)
    print(f"phase 16 took {time.perf_counter() - t16:.1f} s; launches {launches16}")

    # 17. the compiled small-scene paths: the per-bot runner's graph against
    #     eager, the lagged span path against the reference (the counters
    #     reset just before each run), sync-free chunks, the profiled turns
    t17 = time.perf_counter()
    launches17 = small_scene_phase(smi)
    print(f"phase 17 took {time.perf_counter() - t17:.1f} s; launches {launches17}")

    # 18. the sharded loop's compiled chunk: graph against eager on five
    #     scenes (the counters reset just before each run), sync-free
    #     chunks, the select's cost, the profiled turns
    t18 = time.perf_counter()
    launches18 = sharded_compiled_phase(smi)
    print(f"phase 18 took {time.perf_counter() - t18:.1f} s; launches {launches18}")

    # 19. the rebuild's conditional node: the nodes of phases 16 and 18's
    #     graphs, cond_set against the select, its time
    t19 = time.perf_counter()
    cond_row, lines19 = cond_phase(resolve_params(bench_params().validate()), main_state,
                                   k_live, smi)
    for line in lines19:
        print(line, flush=True)
    print(f"phase 19 took {time.perf_counter() - t19:.1f} s")

    # 20. the row step against its twin at the main path's shapes, timed
    t20 = time.perf_counter()
    rs, lines20 = row_step_phase(resolve_params(bench_params().validate()), main_state,
                                 sweep_state)
    for line in lines20:
        print(line, flush=True)
    print(f"phase 20 took {time.perf_counter() - t20:.1f} s")

    # 21. the dense step against its twin on the obstacle scene, timed
    t21 = time.perf_counter()
    ds, lines21 = dense_step_phase()
    for line in lines21:
        print(line, flush=True)
    print(f"phase 21 took {time.perf_counter() - t21:.1f} s")

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
         "launches": launches["stencil_forces"] + per_bot_launches
         + launches13["stencil_forces"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None},
        {"name": "compact", "route": "cuda",
         "source": "particlerobotsimulations_torch/csrc/compact.cu",
         "replaces": "particlerobotsimulations_tpu/ops/table_rebuild.py:203",
         "launches": launches["compact"] + launches13["compact"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None},
        {"name": "mega_span", "route": "cuda",
         "source": "particlerobotsimulations_torch/csrc/mega_span.cu",
         "replaces": "particlerobotsimulations_tpu/ops/megakernel.py:272",
         "launches": b_launches["mega_span"] + launches13["mega_span"],
         "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1], "library_ms": None},
        {**cond_row, "launches": launches["cond_set"] + launches13.get("cond_set", 0)},
    ] + [
        # the main path's post_pre, the part a block runs most; every mode
        # under "modes"
        {"name": name, "route": "cuda",
         "source": "particlerobotsimulations_torch/csrc/row_step.cu",
         "replaces": ROW_STEP_REPLACES, "launches": n, "max_abs_err": 0.0,
         "ms": rs[name]["post_pre"]["ms"], "plain_ms": rs[name]["post_pre"]["plain_ms"],
         "bound_ms": rs[name]["post_pre"]["bound"][0],
         "bound_by": rs[name]["post_pre"]["bound"][1],
         "library_ms": rs[name]["post_pre"]["library_ms"],
         "modes": {mode: {"ms": v["ms"], "plain_ms": v["plain_ms"],
                          "library_ms": v["library_ms"], "bound_ms": v["bound"][0]}
                   for mode, v in rs[name].items()}}
        for name, n in (("row_step", launches["row_step"] + launches13.get("row_step", 0)),
                        ("row_step_batched", sweep_counts["row_step_batched"]))
    ] + [
        {"name": name, "route": "cuda",
         "source": "particlerobotsimulations_torch/csrc/dense_step.cu",
         "replaces": DENSE_STEP_REPLACES, "launches": ds[name]["launches"],
         "max_abs_err": ds[name]["err"], "ms": ds[name]["ms"],
         "plain_ms": ds[name]["plain_ms"], "bound_ms": ds[name]["bound"][0],
         "bound_by": ds[name]["bound"][1], "library_ms": ds[name]["library_ms"]}
        for name in ("dense_step", "dense_step_batched")
    ] + record9 + [
        {"name": name, "route": "cuda", "source": src, "replaces": rep_,
         "launches": sweep_counts[name], "max_abs_err": kc[name]["err"],
         "ms": kc[name]["ms"], "plain_ms": kc[name]["plain_ms"],
         "bound_ms": kc[name]["bound"][0], "bound_by": kc[name]["bound"][1],
         "library_ms": None}
        for name, src, rep_ in (
            ("stencil_forces_batched", "particlerobotsimulations_torch/csrc/stencil_forces.cu",
             "particlerobotsimulations_tpu/ops/pallas_stencil.py:458"),
            ("compact_batched", "particlerobotsimulations_torch/csrc/compact.cu",
             "particlerobotsimulations_tpu/ops/table_rebuild.py:203"),
            ("mega_span_batched", "particlerobotsimulations_torch/csrc/mega_span.cu",
             "particlerobotsimulations_tpu/ops/megakernel.py:272"),
        )
    ] + [
        {"name": name, "route": "cuda", "source": src, "replaces": rep_,
         "launches": launches14[name], "max_abs_err": kc14[name]["err"],
         "ms": kc14[name]["ms"], "plain_ms": kc14[name]["plain_ms"],
         "bound_ms": kc14[name]["bound"][0], "bound_by": kc14[name]["bound"][1],
         "library_ms": None}
        for name, src, rep_ in (
            ("stencil_forces_ext_batched", "particlerobotsimulations_torch/csrc/stencil_forces.cu",
             "particlerobotsimulations_tpu/ops/pallas_stencil.py:570"),
            ("compact_padded_batched", "particlerobotsimulations_torch/csrc/compact.cu",
             "particlerobotsimulations_tpu/ops/table_rebuild.py:203"),
        )
    ]}
    for entry in record["kernels"]:
        entry["launches"] += (launches15.get(entry["name"], 0) + launches16.get(entry["name"], 0)
                              + launches17.get(entry["name"], 0)
                              + launches18.get(entry["name"], 0))
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
