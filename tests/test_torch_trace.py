"""PyTorch port, its spans and counters (``utils/trace.py``).

On the CPU: off, a chunk records nothing and makes no span or event; on,
the DENSE, table, adaptive and batched chunks give nested spans whose
parents enclose them, each span's self time its duration less its
children's; a capture counts once per key (a stand-in for the CUDA graph,
so that ``_graphed``'s own bookkeeping runs here); the Chrome trace
round-trips; ``snapshot`` reads ``REBUILDS`` and ``LAUNCHES`` as they
read; ``report`` reduces a hand-made snapshot to the numbers its readers
take.  On the card (``-m cuda``): tracing leaves every captured graph and
the launch counts as they are, a host span encloses its kernel on the
profiler's clock, and the device intervals of a 10k table chunk cover its
profiled activity.  Sizes on the CPU: at most 300 bots, at most 32 steps.
"""

import json

import pytest
import torch

import particlerobotsimulations_torch as pt
from particlerobotsimulations_torch import chunk as t_chunk
from particlerobotsimulations_torch import engine, engine_table, kernels
from particlerobotsimulations_torch.engine_table import REBUILDS
from particlerobotsimulations_torch.parallel.sweep import make_batch_state
from particlerobotsimulations_torch.utils import trace

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

SCENE = dict(n_cells=300, n_dead=0, seed=3, config=pt.Config.HEX, phase_std=0.5,
             light_x=-5.0, light_y=0.0, centroid_int=0.08, phase_update_interval=0.08)


def params(backend, **kw):
    return pt.SimParams(**dict(SCENE, force_backend=backend, **kw)).validate()


def chunk(path):
    """Two chunks of 16 steps on ``path``'s runner from a fresh state;
    returns the runner and its last state."""
    if path == "dense":
        p = params(pt.ForceBackend.DENSE, n_cells=64)
        run, state = engine.make_run_chunk(p, "cpu"), pt.Simulation(p, device="cpu").state
    elif path == "batched":
        p = params(pt.ForceBackend.DENSE, n_cells=64)
        run, state = engine.make_run_chunk_batched(p, "cpu"), make_batch_state(p, [0, 1], "cpu")
    elif path == "adaptive":
        p = params(pt.ForceBackend.PALLAS)
        run, state = engine_table.make_adaptive_run_chunk(p), pt.Simulation(p, device="cpu").state
    else:
        p = params(pt.ForceBackend.PALLAS, overflow_slots=8)
        run, state = engine_table.make_run_chunk_table(p), pt.Simulation(p, device="cpu").state
    for _ in range(2):
        state = run(state, 16, True)
    return run, state


def recorded(fn, device_events=False):
    """``fn()`` with tracing on; returns its value and the snapshot."""
    trace.enable(device_events)
    try:
        out = fn()
    finally:
        trace.disable()
    return out, trace.snapshot()


def test_off_records_nothing_and_makes_no_span_or_event(monkeypatch):
    trace.enable()
    trace.disable()

    def refuse(*args, **kw):
        raise AssertionError("an object of the recorder made while tracing is off")

    monkeypatch.setattr(trace, "Span", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    for path in ("dense", "batched", "adaptive", "table"):
        chunk(path)
    p = params(pt.ForceBackend.DENSE, n_cells=64)
    pt.Simulation(p, device="cpu").host_view()
    assert trace.snapshot()["spans"] == []
    assert trace.work(torch.device("cpu")) is trace._NOTHING


@pytest.mark.parametrize("path,want", [("dense", "DENSE"), ("batched", "DENSE"),
                                       ("adaptive", "adaptive"), ("table", "table")])
def test_spans_nest_and_self_time_is_duration_less_children(path, want):
    _, snap = recorded(lambda: chunk(path))
    spans = {s["id"]: s for s in snap["spans"]}
    assert [s["id"] for s in snap["spans"]] == list(range(len(spans)))
    chunks = [s for s in spans.values() if s["name"] == "chunk"]
    assert len(chunks) == 2
    for s in chunks:
        assert s["parent"] is None and s["attrs"]["path"] == want
        assert s["attrs"]["steps"] == 16
        assert s["attrs"]["scenes"] == (2 if path == "batched" else 1)
    for s in spans.values():
        kids = [c for c in spans.values() if c["parent"] == s["id"]]
        assert all(s["start_ns"] <= c["start_ns"] <= c["end_ns"] <= s["end_ns"] for c in kids)
        # children of one span run one after another
        assert s["self_ns"] == (s["end_ns"] - s["start_ns"]
                                - sum(c["end_ns"] - c["start_ns"] for c in kids))
        if s["name"] == "graph.eager":
            assert spans[s["parent"]]["name"] in ("chunk", "chunk.probe")
    for c in chunks:
        under = [s for s in spans.values() if s["name"] == "graph.eager"
                 and (s["parent"] == c["id"] or spans[s["parent"]]["parent"] == c["id"])]
        assert sum(s["attrs"]["steps"] for s in under) == 16
    if path == "adaptive":
        probes = [s for s in spans.values() if s["name"] == "chunk.probe"]
        assert [spans[s["parent"]]["name"] for s in probes] == ["chunk", "chunk"]
        assert [s["attrs"]["k"] for s in probes] == [4, chunks[1]["attrs"]["k"]]


class StandIn:
    """Stands in for ``chunk.CapturedBlock`` off the card: the
    block runs eagerly, with the graph's node counts it would report."""

    def __init__(self, block, carry):
        self.block = block
        self.nodes = {"nodes": 12, "kernels": 10, "copies": 2, "conditional": 0}

    def __call__(self, carry, step):
        return self.block(carry, torch.full((), step, dtype=torch.int64))


class OnCard:
    """A carry entry that reports a CUDA device (no card is touched)."""

    device = torch.device("cuda", 0)


@pytest.mark.parametrize("traced", [False, True])
def test_a_capture_counts_once_per_key(monkeypatch, traced):
    monkeypatch.setattr(t_chunk, "CapturedBlock", StandIn)
    monkeypatch.setattr(t_chunk, "step_tensor",
                        lambda step, device: torch.full((), step, dtype=torch.int64))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)

    def block(carry, step0):
        return carry

    block.steps = 4
    carry = {"x": OnCard()}
    dev = OnCard.device
    keys = [("piece", dev, (1,), "a")] * 3 + [("piece", dev, (1,), "b")] * 2 + [
        ("bot", dev, (1,), "a")]
    graphs: dict = {}
    before = trace.CAPTURES.count

    def run():
        for key in keys:
            t_chunk.graphed(graphs, key, block, carry, 0)

    if traced:
        _, snap = recorded(run)
        names = [s["name"] for s in snap["spans"]]
        assert names.count("graph.capture") == 3 and names.count("graph.eager") == 2
        assert snap["counters"]["graph.replays"] == {"piece": 4}
        assert snap["counters"]["graph.nodes_replayed"] == 40
        assert snap["counters"]["graph.captures"]["count"] == trace.CAPTURES.count
        assert all(s["attrs"]["nodes"] == 10 for s in snap["spans"]
                   if s["name"] in ("graph.capture", "graph.replay"))
    else:
        run()
    assert trace.CAPTURES.count == before + 3 and len(graphs) == 3


def test_write_round_trips_a_chrome_trace(tmp_path):
    _, snap = recorded(lambda: chunk("adaptive"))
    path = tmp_path / "trace.json"
    trace.write(path)
    doc = json.loads(path.read_text())
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [(e["name"], e["args"]["id"], e["args"]["parent"]) for e in spans] == [
        (s["name"], s["id"], s["parent"]) for s in snap["spans"]]
    for e, s in zip(spans, snap["spans"]):
        assert e["ts"] == pytest.approx(s["start_ns"] * 1e-3, abs=1.0)
        assert e["dur"] == pytest.approx((s["end_ns"] - s["start_ns"]) * 1e-3, abs=1.0)
        assert {k: e["args"][k] for k in s["attrs"]} == s["attrs"]
    assert doc["otherData"] == json.loads(json.dumps(trace.snapshot()["counters"]))


def test_snapshot_reads_rebuilds_and_launches_as_they_read():
    for k in REBUILDS:
        REBUILDS[k] = 0
    _, snap = recorded(lambda: chunk("table"))
    counters = snap["counters"]
    assert counters["rebuilds"] == dict(REBUILDS) and sum(REBUILDS.values()) > 0
    assert counters["launches"] == dict(kernels.LAUNCHES)


def hand_made():
    """A chunk (its own device work at 10-30 and 950-980), two replays
    (device 200-400 and 400-700) and an eager block (720-900): the card
    idles 0-10, 30-200, 700-720, 900-950 and 980-1000 of the 0-1000
    window."""
    def span(sid, name, parent, t0, t1, self_ns, device, **attrs):
        return {"id": sid, "name": name, "parent": parent, "start_ns": t0, "end_ns": t1,
                "self_ns": self_ns, "attrs": attrs, "device": device}

    return {"counters": {}, "spans": [
        span(0, "chunk", None, 0, 1000, 510, [[0, 10, 30], [900, 950, 980]], steps=20),
        span(1, "graph.replay", 0, 100, 150, 50, [[100, 200, 400]], steps=8, nodes=100),
        span(2, "graph.replay", 0, 150, 190, 40, [[150, 400, 700]], steps=8, nodes=100),
        span(3, "graph.eager", 0, 200, 600, 400, [[200, 720, 900]], steps=4),
    ]}


@pytest.mark.parametrize("window,busy,idle", [
    ((None, None), 730, [["graph.replay", 170], ["chunk", 60], ["graph.eager", 20],
                         ["outside", 20]]),
    ((300, 800), 480, [["graph.eager", 20]]),
    ((0, 2000), 730, [["outside", 1020], ["graph.replay", 170], ["chunk", 60],
                      ["graph.eager", 20]]),
])
def test_report_of_a_hand_made_snapshot(window, busy, idle):
    r = trace.report(hand_made(), *window)
    t0, t1 = (0, 1000) if window == (None, None) else window
    assert r["wall_s"] == pytest.approx((t1 - t0) * 1e-9)
    assert r["busy_s"] == pytest.approx(busy * 1e-9)
    # the device idle share the spans give stays within [0, 1], and the
    # gaps sum to the idle time
    share = 1.0 - r["busy_s"] / r["wall_s"]
    assert 0.0 <= share <= 1.0
    assert [n for n, _ in r["idle_spans"]] == [n for n, _ in idle]
    assert [v for _, v in r["idle_spans"]] == pytest.approx([v * 1e-9 for _, v in idle])
    assert sum(v for _, v in r["idle_spans"]) == pytest.approx(r["wall_s"] - r["busy_s"])
    replay = r["spans"]["graph.replay"]
    assert replay["count"] == 2 and replay["host_median_us"] == pytest.approx(0.045)
    assert replay["device_s"] == pytest.approx(500e-9)
    assert (replay["steps"], replay["nodes"]) == (16, 200)
    assert r["spans"]["chunk"]["self_s"] == pytest.approx(510e-9)
    assert r["spans"]["chunk"]["device_s"] == pytest.approx(50e-9)


# ------------------------------------------------------------ on the card

GRAPH_SCENE = dict(n_cells=2000, n_dead=0, seed=7, config=pt.Config.HEX,
                   force_backend=pt.ForceBackend.PALLAS, slot_rebuild_steps=4,
                   light_x=-20.0, phase_std=0.5, centroid_int=0.16,
                   phase_update_interval=0.24)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build()
    return torch.device("cuda")


@pytest.mark.cuda
def test_tracing_changes_no_captured_graph(card, monkeypatch):
    """The same two 46-step chunks with tracing off and on (device events
    too): every captured graph holds the same nodes by type and counts
    the same launches, and the chunks launch the same kernels."""
    from particlerobotsimulations_torch.models.placement import resolve_params

    made = []

    class Kept(t_chunk.CapturedBlock):
        def __init__(self, block, carry):
            super().__init__(block, carry)
            made.append((self.nodes, self.launches))

    monkeypatch.setattr(t_chunk, "CapturedBlock", Kept)
    p = resolve_params(pt.SimParams(**GRAPH_SCENE).validate())
    runs = []
    for traced in (False, True):
        made.clear()
        torch.cuda.synchronize()
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0

        def two_chunks():
            run, state = engine_table.make_run_chunk_table(p), pt.Simulation(p, device=card).state
            for _ in range(2):
                state = run(state, 46)
            torch.cuda.synchronize()

        if traced:
            _, snap = recorded(two_chunks, device_events=True)
            assert any(s["name"] == "graph.replay" and s["device"] for s in snap["spans"])
        else:
            two_chunks()
        runs.append((list(made), dict(kernels.LAUNCHES)))
    print(f"graphs {len(runs[0][0])}, nodes {[n for n, _ in runs[0][0]]}, "
          f"launches {runs[0][1]}")
    assert runs[0][0] and runs[0] == runs[1]


@pytest.mark.cuda
def test_a_host_span_encloses_its_kernel_on_the_profilers_clock(card):
    """One synchronised eager kernel inside a host span, under the
    benchmark's profiler: the span encloses the kernel's activity and its
    ``cudaLaunchKernel`` record, and the span's device interval the
    kernel, within 5 us."""
    from perfbench.trace import traced

    x = torch.randn(1 << 22, device=card)
    torch.cuda.synchronize()
    trace.enable(device_events=True)
    try:
        def fn():
            with trace.span("probe", card):
                x.mul_(2.0)
                torch.cuda.synchronize()

        prof = traced(fn)
    finally:
        trace.disable()
    (sp,) = [s for s in trace.snapshot()["spans"] if s["name"] == "probe"]
    (kern,) = prof.kernels()
    launches = [r for r in prof.runtime if r[0] == "cudaLaunchKernel"]
    assert len(launches) == 1
    _, l0, l1 = launches[0]
    _, _, k0, k1 = kern
    ((_, d0, d1),) = sp["device"]
    print(f"span {sp['start_ns']}-{sp['end_ns']}: launch +{l0 - sp['start_ns']} ns, kernel "
          f"+{k0 - sp['start_ns']}..{k1 - sp['start_ns']} ns, device interval "
          f"{d0 - k0:+d} / {d1 - k1:+d} ns of the kernel's")
    assert sp["start_ns"] <= l0 <= l1 <= sp["end_ns"]
    assert sp["start_ns"] <= k0 <= k1 <= sp["end_ns"]
    assert d0 <= k0 + 5000 and d1 >= k1 - 5000


@pytest.mark.cuda
def test_device_spans_cover_a_10k_chunks_profiled_activity(card):
    """A warm 10k HEX adaptive chunk of 1,200 steps under the profiler
    with device events on: the union of the program's device intervals
    covers at least 99 % of the union of the profiled device activity,
    and the chunk captures nothing."""
    from perfbench.trace import traced

    p = pt.SimParams(n_cells=10000, n_dead=0, seed=7, config=pt.Config.HEX,
                     light_x=-20.0, light_y=0.0).validate()
    run, state = engine.make_run_chunk(p, card), pt.Simulation(p, device=card).state
    # warm until a chunk at the certified K=8 captures nothing (the probe
    # lets K=8 in after a few chunks, whose first chunk captures its graphs)
    for _ in range(10):
        captures = trace.CAPTURES.count
        state = run(state, 1200, True)
        if trace.CAPTURES.count == captures and run.live["k"] == 8:
            break
    torch.cuda.synchronize()
    captures = trace.CAPTURES.count
    trace.enable(device_events=True)
    try:
        prof = traced(lambda: run(state, 1200, True))
    finally:
        trace.disable()
    snap = trace.snapshot()
    ours: list = []
    for b, e in sorted((b, e) for s in snap["spans"] for _, b, e in s["device"]):
        if ours and b <= ours[-1][1]:
            ours[-1][1] = max(ours[-1][1], e)
        else:
            ours.append([b, e])
    covered = sum(max(0, min(e, f) - max(s, b)) for s, e in prof.union() for b, f in ours)
    busy = prof.busy_s() * 1e9
    r = trace.report(snap)
    print(f"CUPTI busy {busy * 1e-6:.3f} ms, covered {covered / busy:.5f}; spans busy "
          f"{r['busy_s'] * 1e3:.3f} ms over {r['wall_s'] * 1e3:.3f} ms; "
          f"{snap['counters']['graph.replays']}; idle {r['idle_spans']}")
    assert trace.CAPTURES.count == captures
    assert covered >= 0.99 * busy
