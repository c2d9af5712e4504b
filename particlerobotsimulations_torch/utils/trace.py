"""Spans and counters of the port: where a run's host and device time go.

Off by default.  :func:`enable` starts a recording, :func:`disable` ends
it, :func:`snapshot` returns what it holds with the counters, and
:func:`write` writes that as a Chrome trace (JSON that Perfetto and
chrome://tracing read).  Off, an instrumented site costs one test of
:data:`ON` and makes no object, no CUDA event and no device op.  On or
off, nothing is added inside a captured CUDA graph: the graphs a runner
captures have the same nodes and launches either way.

A span is a stretch of host time (name, start, end, the span open around
it, a few attributes), stamped with ``time.time_ns()``, the clock
``torch.profiler``'s records carry, so a profiler trace of a traced run
lines up with the spans by timestamp.  The spans, from the entry down:

* ``chunk``: a chunk runner's call (``engine.make_run_chunk``'s runners,
  the adaptive runner and the batched ones; attributes ``steps``,
  ``scenes``, ``path``: ``table``, ``span``, ``batched``, ``adaptive`` or
  the per-bot backend, and ``k``, the rebuild cadence it ran at);
* ``chunk.probe``: the adaptive runner's probe segment (``k``, the cadence
  probed); ``chunk.probe_wait``: the wait for the previous probe's host
  copy;
* ``graph.replay``: one replay of a captured block (``kind``, ``steps``,
  ``nodes``: the kernel nodes at the graph's top level);
  ``graph.capture``: a capture (``kind``, ``nodes``, ``pool_mib``: the
  memory the process reserved more after it); ``graph.eager``: a block run
  eagerly (a layout's first, before its capture; every block off the
  card);
* ``sim.host_view``: ``Simulation.host_view``'s copy to the host
  (``bytes``).

With ``device_events``, the spans that enqueue work on the card also
carry device intervals: CUDA event pairs on the current stream, recorded
outside any graph.  ``graph.replay``, ``graph.eager`` and
``sim.host_view`` bracket themselves; ``chunk`` and ``chunk.probe``
bracket only their own device work (a chunk's table entry and exit, the
draws before a block, the probe's bound, its pinned copy: :func:`work`),
so that the device time between their children's intervals, where the
card waited for the host, stays out.  :func:`enable` synchronises the
card once and records an anchor event beside a host stamp; an event's
time is the anchor's stamp plus ``elapsed_time`` from the anchor, on the
spans' clock.  An interval counts the host's enqueue time wherever the
card ran ahead of it inside the bracket: the union of the intervals is an
upper bound of the card's busy time.

Counters: ``graph.captures`` (:data:`CAPTURES`, always on: a capture is
rare and cold) with their seconds, and what other modules register
(:func:`register`: ``engine_table.REBUILDS`` as ``rebuilds``,
``engine_table.OCCUPANCY`` as ``occupancy``, ``kernels.LAUNCHES``),
which :func:`snapshot` reads as those objects read; ``graph.replays`` by
kind and ``graph.nodes_replayed`` come from the recording's spans.
:func:`report` reduces a snapshot to time by span name and the card's
idle gaps, each put down to the span whose work ended it.
"""

from __future__ import annotations

import json
import statistics
import time

import torch

# tested at every instrumented site; set by enable() and disable()
ON = False

_COUNTERS: dict = {}
_recording = None


class CaptureCount:
    """The CUDA graphs this process captured and the seconds their
    capture and instantiation took."""

    def __init__(self):
        self.count = 0
        self.seconds = 0.0

    def add(self, seconds: float) -> None:
        self.count += 1
        self.seconds += seconds


CAPTURES = CaptureCount()


def register(name: str, counts) -> None:
    """Have :func:`snapshot` read the mapping ``counts`` under ``name``."""
    _COUNTERS[name] = counts


class Span:
    """One host span; ``device`` holds its device intervals, each ``[host
    stamp, begin event, end event]`` until :func:`snapshot` resolves them
    to ``[host stamp, begin ns, end ns]``."""

    __slots__ = ("id", "name", "parent", "start", "end", "attrs", "device")

    def __init__(self, sid, name, parent, attrs):
        self.id, self.name, self.parent, self.attrs = sid, name, parent, attrs
        self.device = []
        self.end = None
        self.start = time.time_ns()


class _Recording:
    def __init__(self, device_events: bool):
        self.spans: list = []
        self.open: list = []
        self.device = None
        if device_events:
            self.device = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.synchronize(self.device)
            self.anchor = torch.cuda.Event(enable_timing=True)
            self.anchor.record()
            self.anchor_ns = time.time_ns()

    def event(self, device):
        """A timed CUDA event recorded now on the current stream, or None
        where this recording takes none on ``device`` (no device events,
        or another device).  No span is open inside a graph capture: the
        runners open theirs around the blocks they capture and replay."""
        if (self.device is None or device is None or device.type != "cuda"
                or (device.index if device.index is not None
                    else torch.cuda.current_device()) != self.device.index):
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev


def enable(device_events: bool = False) -> None:
    """Start a new recording (the last one's spans are dropped); with
    ``device_events``, on the current CUDA device."""
    global ON, _recording
    _recording = _Recording(device_events)
    ON = True


def disable() -> None:
    """Stop recording; :func:`snapshot` and :func:`write` still read what
    was recorded."""
    global ON
    ON = False


class span:
    """``with span(name, device, **attrs) as sp``: a host span, the
    innermost open one its parent; with a ``device``, also a device
    interval around it.  Call only where :data:`ON` holds."""

    __slots__ = ("sp", "pair")

    def __init__(self, name: str, device=None, **attrs):
        rec = _recording
        parent = rec.open[-1].id if rec.open else None
        self.sp = Span(len(rec.spans), name, parent, attrs)
        rec.spans.append(self.sp)
        rec.open.append(self.sp)
        ev = rec.event(device)
        self.pair = None if ev is None else [self.sp.start, ev, None]

    def __enter__(self) -> Span:
        return self.sp

    def __exit__(self, *exc) -> bool:
        rec = _recording
        if self.pair is not None:
            self.pair[2] = rec.event(rec.device)
            self.sp.device.append(self.pair)
        self.sp.end = time.time_ns()
        rec.open.pop()
        return False


class _Work:
    __slots__ = ("sp", "pair")

    def __init__(self, device):
        rec = _recording
        self.sp = rec.open[-1]
        stamp = time.time_ns()
        ev = rec.event(device)
        self.pair = None if ev is None else [stamp, ev, None]

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        if self.pair is not None:
            self.pair[2] = _recording.event(_recording.device)
            self.sp.device.append(self.pair)
        return False


class _Nothing:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NOTHING = _Nothing()


def work(device):
    """``with work(device):`` around device work that the innermost open
    span enqueues itself: a device interval of that span.  Does nothing
    where tracing is off or no span is open."""
    if not ON or not _recording.open:
        return _NOTHING
    return _Work(device)


def _resolve(rec) -> None:
    """Every recorded device interval's events as ns on the spans' clock."""
    if rec.device is None:
        return
    torch.cuda.synchronize(rec.device)
    for sp in rec.spans:
        for pair in sp.device:
            if not isinstance(pair[1], int):
                pair[1] = rec.anchor_ns + round(rec.anchor.elapsed_time(pair[1]) * 1e6)
                pair[2] = rec.anchor_ns + round(rec.anchor.elapsed_time(pair[2]) * 1e6)


def _cover(intervals) -> int:
    """The length of the union of ``(start, end)`` intervals."""
    total, reach = 0, None
    for s, e in sorted(intervals):
        if reach is None or s > reach:
            total += e - s
            reach = e
        elif e > reach:
            total += e - reach
            reach = e
    return total


def snapshot() -> dict:
    """The counters and the last recording's spans: ``{"spans": [...],
    "counters": {...}}``, each span a dict of ``id``, ``name``,
    ``parent``, ``start_ns``, ``end_ns`` (None while open), ``self_ns``
    (its duration less the part its children cover), ``attrs`` and
    ``device`` (``[[host stamp, begin ns, end ns], ...]``).  Resolving
    the device intervals waits for the card."""
    rec = _recording
    spans = []
    if rec is not None:
        _resolve(rec)
        children: dict = {}
        for sp in rec.spans:
            if sp.parent is not None and sp.end is not None:
                children.setdefault(sp.parent, []).append((sp.start, sp.end))
        for sp in rec.spans:
            self_ns = None
            if sp.end is not None:
                inside = [(max(s, sp.start), min(e, sp.end))
                          for s, e in children.get(sp.id, ())]
                self_ns = sp.end - sp.start - _cover([iv for iv in inside if iv[0] < iv[1]])
            spans.append({"id": sp.id, "name": sp.name, "parent": sp.parent,
                          "start_ns": sp.start, "end_ns": sp.end, "self_ns": self_ns,
                          "attrs": dict(sp.attrs), "device": [list(p) for p in sp.device]})
    replays: dict = {}
    nodes = 0
    for s in spans:
        if s["name"] == "graph.replay":
            kind = s["attrs"]["kind"]
            replays[kind] = replays.get(kind, 0) + 1
            nodes += s["attrs"]["nodes"]
    counters = {"graph.captures": {"count": CAPTURES.count, "seconds": CAPTURES.seconds},
                "graph.replays": replays, "graph.nodes_replayed": nodes}
    for name, counts in _COUNTERS.items():
        counters[name] = dict(counts)
    return {"spans": spans, "counters": counters}


def report(snap: dict, start_ns: int | None = None, end_ns: int | None = None) -> dict:
    """A snapshot reduced over the window ``[start_ns, end_ns]`` (by
    default from the first span's start to the last span's or interval's
    end): ``wall_s``; ``busy_s``, the union of the device intervals in the
    window; by span name (``spans``, every closed span of the snapshot)
    the ``count``, ``host_s``, ``self_s``, ``device_s``,
    ``host_median_us`` and the sums of the ``steps`` and ``nodes``
    attributes where spans carry them; and
    ``idle_spans``, the window's device idle gaps summed by the span
    whose device interval ended each gap (the innermost host span open
    when that work was enqueued), the gap after the last interval as
    ``outside``: ``[[name, seconds], ...]``, largest first."""
    spans = [s for s in snap["spans"] if s["end_ns"] is not None]
    if not spans:
        return {"wall_s": 0.0, "busy_s": 0.0, "spans": {}, "idle_spans": []}
    ends = [s["end_ns"] for s in spans] + [p[2] for s in spans for p in s["device"]]
    t0 = min(s["start_ns"] for s in spans) if start_ns is None else start_ns
    t1 = max(ends) if end_ns is None else end_ns
    names: dict = {}
    for s in spans:
        n = names.setdefault(s["name"], {"count": 0, "host": [], "self": 0, "device": 0})
        n["count"] += 1
        n["host"].append(s["end_ns"] - s["start_ns"])
        n["self"] += s["self_ns"]
        n["device"] += sum(e - b for _, b, e in s["device"])
        for key in ("steps", "nodes"):
            if s["attrs"].get(key) is not None:
                n[key] = n.get(key, 0) + s["attrs"][key]
    by_name = {}
    for name, n in names.items():
        by_name[name] = {"count": n["count"], "host_s": sum(n["host"]) * 1e-9,
                         "self_s": n["self"] * 1e-9, "device_s": n["device"] * 1e-9,
                         "host_median_us": statistics.median(n["host"]) * 1e-3}
        by_name[name].update({k: n[k] for k in ("steps", "nodes") if k in n})
    clipped = sorted((max(b, t0), min(e, t1), s["name"]) for s in spans
                     for _, b, e in s["device"] if min(e, t1) > max(b, t0))
    idle: dict = {}
    reach = t0
    for b, e, name in clipped:
        if b > reach:
            idle[name] = idle.get(name, 0) + b - reach
        reach = max(reach, e)
    if t1 > reach:
        idle["outside"] = idle.get("outside", 0) + t1 - reach
    return {"wall_s": (t1 - t0) * 1e-9,
            "busy_s": _cover([(b, e) for b, e, _ in clipped]) * 1e-9,
            "spans": by_name,
            "idle_spans": [[n, v * 1e-9] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])]}


def write(path) -> None:
    """:func:`snapshot` as a Chrome trace: each host span a complete event
    on the host track, each device interval one on the device track,
    microseconds on the spans' clock, the counters under ``otherData``."""
    snap = snapshot()
    events = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": tid, "args": {"name": name}}
              for tid, name in ((0, "host"), (1, "device"))]
    for s in snap["spans"]:
        if s["end_ns"] is None:
            continue
        args = {"id": s["id"], "parent": s["parent"], **s["attrs"]}
        events.append({"ph": "X", "name": s["name"], "pid": 0, "tid": 0,
                       "ts": s["start_ns"] * 1e-3, "dur": (s["end_ns"] - s["start_ns"]) * 1e-3,
                       "args": args})
        for _, b, e in s["device"]:
            events.append({"ph": "X", "name": s["name"], "pid": 0, "tid": 1, "ts": b * 1e-3,
                           "dur": (e - b) * 1e-3, "args": {"id": s["id"]}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ns",
                   "otherData": snap["counters"]}, f)
