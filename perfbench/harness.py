"""One run of one cell: set-up, the measured window, the traced stretch
and the check, as ``run.py`` drives them.

:func:`run_cell` takes the device it runs on, so that the harness's own
tests drive a run on the CPU at a small size; ``run.py`` refuses to start
without a card.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

from . import check
from .spec import Bench
from .workload import BlockEnds, SpanCalls, Workload

MIB = float(1 << 20)
# the traced stretch: steps run from the window's last state, untraced and
# then traced
TRACE_STEPS = 1200
# the warm-up ends after this many chunks in a row that capture nothing,
# or after the most it runs
WARMUP_QUIET = 2
WARMUP_MAX = 10


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reserved(torch, device) -> int:
    return torch.cuda.memory_reserved(device) if device.type == "cuda" else 0


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool,
             device="cuda", started: float | None = None, config: dict | None = None,
             traffic: dict | None = None, with_control: bool = False) -> dict:
    """One run of cell ``name``: a dict with the result line's keys and,
    under ``checks``, each compared number beside its limit.  ``started``
    is the ``time.perf_counter()`` reading of the process's start (set-up
    is counted from it); ``config`` and ``traffic`` stand in for the
    cell's files (the tests' small sizes); ``with_control`` adds to
    ``_info`` the control's readings and the float32 reference's against
    a float64 one (``check.control_readings``)."""
    import torch

    t_start = time.perf_counter() if started is None else started
    marks = {"harness": time.perf_counter() - t_start}
    cell = bench.cell(name)
    config = config or bench.config(cell["config"])
    traffic = traffic or bench.traffic(cell["traffic"])
    cfg_dir = bench.config_path(cell["config"]).parent
    wl = Workload(config, traffic, seed, cfg_dir, device)
    dev = wl.device
    chunk = int(traffic["chunk_steps"])

    state = wl.initial()
    start_state = state
    marks["inputs"] = time.perf_counter() - t_start
    if trace and dev.type == "cuda":
        torch.cuda.empty_cache()
    reserved0 = _reserved(torch, dev)
    # the warm-up captures every graph the window replays: it runs chunks
    # until two in a row add nothing to what the process reserves on the
    # card (each captured graph holds a pool of its own) and an adaptive
    # cadence runs what its probe certified (``Workload.settled``)
    warm, quiet = 0, 0
    while warm < WARMUP_MAX and (quiet < WARMUP_QUIET or not wl.settled()):
        before = _reserved(torch, dev)
        state = wl.advance(state, chunk)
        wl.read(state)
        warm += 1
        quiet = quiet + 1 if _reserved(torch, dev) == before else 0
    marks["warmup"] = time.perf_counter() - t_start
    marks["warmup_chunks"] = warm
    pool_mib = None
    if trace and dev.type == "cuda":
        torch.cuda.empty_cache()
        pool_mib = (_reserved(torch, dev) - reserved0) / MIB
    wl.zero_rebuilds()
    redos0 = wl.redos()

    # the window: whole chunks, each ended by the user's host read
    _sync(torch, dev)
    reserved1 = _reserved(torch, dev)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    attempted, failed, chunks, chunk_walls, span_segments = 0, 0, 0, [], 0
    while True:
        span_segments += wl.span_segments(state, chunk)
        state = wl.advance(state, chunk)
        ok = wl.read(state)
        chunk_walls.append(time.perf_counter() - t0)
        chunks += 1
        attempted += len(ok)
        failed += ok.count(False)
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    window_mib = (_reserved(torch, dev) - reserved1) / MIB
    steps = chunks * chunk
    rebuilds = wl.rebuild_counts() if wl.seg else None
    live_k = wl.live_k()
    # the window's redone span segments: a device count, read once the
    # window has closed
    redos = None if redos0 is None else wl.redos() - redos0

    ctx = SimpleNamespace(p=wl.p, scenes=wl.scenes, n=wl.n, rebuilds=rebuilds, live_k=live_k,
                          pool_mib=pool_mib, trace=None, trace_steps=0, untraced_wall=None,
                          scenes_pos=[wl.arrays(state, b)["pos"] for b in range(wl.scenes)],
                          span_segments=span_segments, redos=redos,
                          k=wl.params.resolved_slot_rebuild_steps())
    if trace and dev.type == "cuda":
        from .trace import traced

        # the same steps from the same state, untraced and then traced
        _sync(torch, dev)
        t1 = time.perf_counter()
        wl.advance(state, TRACE_STEPS)
        _sync(torch, dev)
        ctx.untraced_wall = time.perf_counter() - t1
        ctx.trace = traced(lambda: wl.advance(state, TRACE_STEPS))
        ctx.trace_steps = TRACE_STEPS

    peak = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0

    # the check: one more chunk of the window's own call from the window's
    # last state, with the program's state recorded at its block ends (and
    # at its first segment's end where it runs span segments); and the
    # first steps from the initial state
    entry = state.step
    on_spans = wl.span_segments(state, chunk) > 0
    rec = BlockEnds(wl, check.starts(wl.p, seed, entry, chunk, wl.seg), check.PIECE_STEPS,
                    entry + chunk, keep=[entry + wl.seg] if on_spans else [])
    rec.offer(entry, state)
    with rec:
        out = wl.advance(state, chunk)
    rec.close(entry + chunk, out)
    spans = rec.pieces()
    if any(s0 is None or s1 is None or s1 - s0 > check.PIECE_STEPS for _, s0, s1 in spans):
        # blocks longer than a piece (a span segment is one graph): the
        # pieces are the entry's own calls of a piece's length from the
        # chunk's entry and from its answer
        spans = []
        for st in (state, out):
            rec.states[st.step] = wl.snapshot(st)
            rec.states[st.step + check.PIECE_STEPS] = wl.snapshot(
                wl.advance(st, check.PIECE_STEPS))
            spans.append((st.step, st.step, st.step + check.PIECE_STEPS))
    span_pieces, replay = [], None
    if on_spans:
        span_pieces, replay = _span_check(Workload(config, traffic, seed, cfg_dir, device),
                                          state, rec.states[entry + wl.seg], seed, ctx.k)
    first = wl.snapshot(wl.advance(start_state, check.START_STEPS))
    pieces = [check.Piece(b, start_state.step, check.START_STEPS, wl.snapshot(start_state)[b],
                          first[b]) for b in range(wl.scenes)]
    for asked, s0, s1 in spans:
        for b in range(wl.scenes):
            if s0 is None:
                pieces.append(check.Piece(b, asked, check.PIECE_STEPS, {}, None))
                continue
            end = rec.states[s1][b] if s1 is not None else None
            pieces.append(check.Piece(b, s0, (s1 or s0) - s0, rec.states[s0][b], end))
    pieces += span_pieces
    piece_steps = [(pc.step, pc.steps) for pc in pieces if pc.scene == 0]
    draws = wl.draws
    del wl, state, start_state, out, rec, first
    readings = check.program_readings(ctx.p, pieces, draws)
    numbers = check.widest(readings)
    if replay is not None:
        numbers[check.REPLAY] = replay
    control = witness = None
    if with_control:
        control = check.widest(check.control_readings(ctx.p, pieces, draws))
        witness = {
            "float32": check.widest(check.control_readings(
                ctx.p, pieces, draws, torch.float32, torch.float64)),
            "program": check.widest(check.program_readings(ctx.p, pieces, draws, torch.float64))}
    limits = bench.limits(name)
    correct = check.judge(numbers, limits) and failed == 0

    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if trace:
        metrics = {}
        for m in bench.per_layer(name):
            value = bench.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        rate = ctx.n * ctx.scenes * steps / wall
        metrics = {"particle_steps_per_s": {"value": rate, "unit": "particle-steps/s"},
                   "peak_mem_mib": {"value": peak / MIB, "unit": "MiB"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    if ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s()
        result["device"]["window_s"] = ctx.trace.wall_s
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["checks"] = {k: {"value": numbers[k], "limit": limit} for k, limit in limits.items()}
    result["_info"] = {"setup_marks": marks, "numbers": numbers, "window_s": wall,
                       "chunk_ends": chunk_walls, "window_mib": window_mib, "steps": steps,
                       "live_k": live_k, "rebuilds": rebuilds, "pieces": piece_steps,
                       "span_segments": span_segments, "redos": redos,
                       "readings": readings, "control": control, "witness": witness}
    return result


def _span_check(fresh: Workload, state, replayed: list, seed: int, k: int) -> tuple:
    """(pieces, replay_gap) of kernel 3's own spans: the chunk's first
    segment run again from its entry ``state`` through ``fresh``, a new
    runner of the cell's entry, which runs its first segment eagerly
    while :class:`SpanCalls` records each span; ``replayed`` is the timed
    runner's answer for the same segment (``BlockEnds``).  The pieces
    are the spans :func:`check.span_picks` takes, each from its input to
    its answer, ``k`` steps, mid-step to mid-step; a segment that ran no
    span gives a piece with no end, which reads no agreement."""
    calls = SpanCalls()
    with calls:
        eager = fresh.advance(state, fresh.seg)
    replay = check.replay_gap(fresh.snapshot(eager), replayed)
    ring = state.centroid_ring
    if not calls.calls:
        return [check.Piece(b, state.step, k, {}, None, mid=True)
                for b in range(fresh.scenes)], replay
    pieces = []
    for i in check.span_picks(seed, state.step, len(calls.calls)):
        tbl, strip, step, tbl1, strip1 = calls.calls[i]
        s0 = int(step)
        start = fresh.span_snapshot(tbl, strip, s0, ring)
        end = fresh.span_snapshot(tbl1, strip1, s0 + k, ring)
        pieces += [check.Piece(b, s0, k, start[b], end[b], mid=True)
                   for b in range(fresh.scenes)]
    return pieces, replay
