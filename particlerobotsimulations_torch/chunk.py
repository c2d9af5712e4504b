"""The compiled chunk: what every engine's chunk runner needs apart from
its physics.

A chunk runner (:class:`ChunkRunner`) advances a state ``n_steps`` steps
with nothing read from the device between the chunk's entry and its exit,
as the JAX package's jitted chunk does.  Its ``blocks`` cut the chunk into
blocks of steps whose gates the host decides from the step counter
(:func:`step_gates`), take each gated step's random draws just before its
block (:func:`draws`) and feed them in with the carry (:func:`drawn`), and
run each block through :func:`graphed`: eagerly off the card, on the card
replayed from a CUDA graph (:class:`CapturedBlock`) captured once per
runner, carry layout and gate pattern.  The sim time and the centroid
ring's row come from a device step (``state.sim_time``,
:func:`ring_write`), so that a graph serves every step it replays at.

The engines bring the blocks: ``engine_table.py`` the table loop's (its
K-step pieces and span segments) and the adaptive runner's,
``engine.py`` the per-bot block runner's, ``parallel/spatial_table.py``
the sharded loop's.  :func:`drain` runs one chunk's blocks to its end,
:func:`interleave` several places' chunks block by block in turn;
:class:`HostValue` carries a value to the host without waiting for the
work enqueued after it.

Counts: :data:`EAGER`, the steps blocks ran eagerly, on the card and off
it; :class:`DeviceCounts`, counters kept on the device that a captured
graph updates in place (``engine_table.REBUILDS`` and ``OCCUPANCY``).
"""

from __future__ import annotations

import gc
import time
from collections.abc import MutableMapping

import torch

from . import kernels, rng
from .config import Control, SimParams
from .ops.cond import GraphCapture, capturing
from .state import step_tensor
from .utils import trace

# the steps that blocks ran eagerly (:func:`graphed` off the card, and on
# the card a runner's first block of a kind, device and layout, the
# warm-up before its capture), by where they ran; set a key to 0 to count
# from there
EAGER = {"card": 0, "off_card": 0}

# every DeviceCounts made, in order: a capture makes their counters on its
# device first
_DEVICE_COUNTS: list = []


class DeviceCounts(MutableMapping):
    """Counts with fixed keys kept on the device: one int64 counter tensor
    per device, never reallocated, that the loops update in place (so a
    CUDA graph that captured an update repeats it at every replay, and the
    loop reads nothing).  Reading a count copies the counters to the host
    (it waits for the card); setting one (to 0, say) zeroes the counters
    in place.  A subclass names its ``KEYS`` and ``_combine``, which
    merges a key's host base and its per-device values.  A capture
    (:class:`CapturedBlock`) makes every instance's counter on its device
    before it begins: one made inside would live in the graph's pool."""

    KEYS: tuple = ()

    def __init__(self):
        self._base = dict.fromkeys(self.KEYS, 0)
        self._counters = {}  # device -> (len(KEYS),) int64
        _DEVICE_COUNTS.append(self)

    def counter(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._counters:
            self._counters[device] = torch.zeros(len(self.KEYS), dtype=torch.int64,
                                                 device=device)
        return self._counters[device]

    def _index(self, key) -> int:
        if key not in self.KEYS:
            raise KeyError(key)
        return self.KEYS.index(key)

    def __getitem__(self, key) -> int:
        i = self._index(key)
        return self._combine([self._base[key]] + [int(c[i]) for c in self._counters.values()])

    def __setitem__(self, key, value) -> None:
        i = self._index(key)
        self._base[key] = int(value)
        for c in self._counters.values():
            c[i].zero_()

    def __delitem__(self, key):
        raise TypeError(f"{type(self).__name__} has fixed keys")

    def __iter__(self):
        return iter(self.KEYS)

    def __len__(self) -> int:
        return len(self.KEYS)


# ------------------------------------------------------- the step schedule

NO_GATES = (False, False, False)


def gates(params: SimParams, step: int):
    """(dead, cog, phase) gate decisions for a step counter."""
    return (
        params.n_dead > 0 and step == params.dead_step,
        step % params.centroid_steps_interval == 0,
        step % params.phase_update_steps == 0,
    )


def step_gates(params: SimParams, step: int) -> tuple:
    """(dead, cog, phase) gate decisions for a step counter, the phase gate
    only under the light-wave controller (FIXED_PHASE keeps scripted
    offsets): the gates that change what a step does."""
    dead_gate, cog_gate, phase_gate = gates(params, step)
    return dead_gate, cog_gate, phase_gate and params.control == Control.LIGHT_WAVE


def draws(params: SimParams, source, step: int, gates: tuple, shape: tuple,
          device) -> dict:
    """A step's random draws of ``shape`` (a per-bot layout, or the table
    loops' ``([B,] total_ext)``), taken beforehand in the order the step
    consumes them: dead scores where the dead gate fires, then phase noise
    where the phase law draws it.  ``gates`` are :func:`step_gates`'.  Fed
    back in (``rng.Drawn``), they give the values and leave the source in
    the state of the step drawing them itself."""
    dead_gate, _, phase_gate = gates
    out = {}
    if dead_gate:
        out["scores"] = rng.uniform(source, step, shape, device)
    if phase_gate and params.phase_std:
        out["noise"] = rng.normal(source, step, shape, device)
    return out


def drawn(carry: dict, j: int):
    """The draws of a block's step ``j`` that its carry holds
    (``scores{j}``, ``noise{j}``)."""
    return rng.Drawn(carry.get(f"scores{j}"), carry.get(f"noise{j}"))


def ring_write(params: SimParams, ring: torch.Tensor, step_t: torch.Tensor,
               centroid: torch.Tensor) -> torch.Tensor:
    """``ring`` with the centroid written out of place into the row of the
    0-dim int64 step ``step_t`` (the reference's ``(int)(time /
    centroid_int) % centroid_steps``): a select on the device, so that a
    CUDA graph writes the row of whatever step it replays at."""
    idx = (step_t // params.centroid_steps_interval) % params.centroid_steps
    rows = torch.arange(ring.shape[-2], device=ring.device)
    return torch.where((rows == idx)[:, None], centroid[..., None, :], ring)


# --------------------------------------------------------- the iterators

def drain(blocks):
    """Run a block iterator (a runner's ``blocks``) to its end; returns
    its value, the chunk's final state."""
    while True:
        try:
            next(blocks)
        except StopIteration as stop:
            return stop.value


def interleaved(iterators):
    """Advance block iterators (one per place, each a runner's ``blocks``)
    one block at a time, in turn, until every one has ended, yielding
    after each block: one block iterator of them all, whose value is their
    final states in order.  Every place's chunk is enqueued block by block
    beside the others', and nothing is read back from any place before all
    are enqueued (the loops read nothing inside a chunk)."""
    its = list(iterators)
    out = [None] * len(its)
    live = list(range(len(its)))
    while live:
        for i in list(live):
            try:
                next(its[i])
            except StopIteration as stop:
                out[i] = stop.value
                live.remove(i)
            else:
                yield
    return out


def interleave(iterators) -> list:
    """:func:`interleaved` run to its end: the places' final states."""
    return drain(interleaved(iterators))


# ---------------------------------------------------------- block replay

class CapturedBlock:
    """A block of steps captured once as a CUDA graph, replayed by calling
    it on a carry of the layout it was captured for.

    ``block(carry, step) -> outputs`` takes a dict of named tensors and a
    0-dim int64 step tensor (the block's sim times and centroid rows are
    made from it) and returns a dict.  The carry lives in static buffers
    beside the step tensor; a gated block's draws, taken before each call,
    are carry entries too.  A call copies in the carry entries the caller
    holds that are not the buffers already (after a replay they are, until
    an eager step replaces some), fills the step, replays, and returns the
    carry on the buffers together with the other outputs: an output named
    as a carry entry is copied back into that entry's buffer at the end of
    the captured block, any other output (a flag, say) stays in the memory
    capture gave it, which every replay rewrites.  The kernel wrappers
    count their launches while the block is captured; those that every
    replay runs are taken back and added again at every replay, and those
    of a conditional node's body are counted per run of the body
    (``ops/cond``), so ``kernels.LAUNCHES`` counts what ran.  The caller
    has run the block eagerly on the card first: that warm-up grants each
    kernel its shared memory at these sizes, which capture may not do.
    Every :class:`DeviceCounts`' counter is made on this device before the
    capture begins.  Python's cyclic garbage collector is held off during
    the capture: a runner no longer referenced (runners hold reference
    cycles) that it freed mid-capture would destroy its graphs there, and
    that voids the capture.  A failed capture raises.

    The capture is registered for ``ops/cond``: each slot rebuild in the
    block becomes the incremental rebuild, kernel ``cond_set`` and a
    conditional IF node whose body holds the exact rebuild, and a span
    segment's adopt-or-redo an IF node with an else branch, whose redo
    body holds the rebuilds' nodes in turn.  ``nodes`` holds the captured
    graph's node counts by type with its bodies' nodes
    (``GraphCapture.node_counts``: ``kernels`` at the top level, counted
    once here, is what a replay runs but the bodies); ``counted`` the
    launches of its bodies per run, each beside the device counter the
    body increments (one of ``counters``, made outside the graph's
    pool)."""

    def __init__(self, block, carry: dict):
        dev = next(iter(carry.values())).device
        self.carry = {n: torch.empty_like(v) for n, v in carry.items()}
        self.outputs = {}
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        for counts in _DEVICE_COUNTS:
            counts.counter(dev)
        before = kernels.LAUNCHES.host_counts()
        self.graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        capture = GraphCapture(dev)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                pool = torch.cuda.graph_pool_handle()
                self.graph.capture_begin(pool=pool)
                try:
                    with capturing(capture, pool):
                        out = block(dict(self.carry), self.step)
                    for n, v in out.items():
                        if n not in self.carry:
                            self.outputs[n] = v
                        elif v is not self.carry[n]:
                            self.carry[n].copy_(v)
                    self.nodes = capture.node_counts(stream)
                except BaseException:
                    # the capture is void: end it, and raise what voided it
                    try:
                        self.graph.capture_end()
                    except RuntimeError:
                        pass
                    raise
                self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        after = kernels.LAUNCHES.host_counts()
        kernels.LAUNCHES.restore(before)
        self.launches = {n: c - before[n] for n, c in after.items() if c != before[n]}
        capture.finish()
        self.counted, self.counters = capture.counted, capture.counters
        torch.cuda.current_stream(dev).wait_stream(stream)

    def __call__(self, carry: dict, step: int) -> dict:
        for n, v in carry.items():
            if v is not self.carry[n]:
                self.carry[n].copy_(v)
        self.step.fill_(step)
        self.graph.replay()
        for n, c in self.launches.items():
            kernels.LAUNCHES.count(n, c)
        return {**self.carry, **self.outputs}


def graphed(graphs: dict, key: tuple, block, carry: dict, step: int) -> dict:
    """``block(carry, step)`` (as :class:`CapturedBlock` takes it; its
    length in ``block.steps``) at the host step ``step``: eagerly off the
    card; on the card replayed from the graph ``graphs[key]``, which the
    first call of a ``key`` captures.  ``key`` is ``(kind, device, layout,
    ...)``: the kind of block, the carry's device and layout, and what else
    tells its graphs apart (a gate pattern, say).  The first block of a
    kind, device and layout runs eagerly before its capture (the warm-up
    :class:`CapturedBlock` needs); a later key of the same three is
    captured at once and replayed, so that a new gate pattern reads
    nothing either.  Eager steps count in :data:`EAGER`.  Traced
    (``utils/trace``): spans ``graph.eager``, ``graph.capture`` and
    ``graph.replay``; every capture counts in ``trace.CAPTURES``."""
    dev = next(iter(carry.values())).device
    if dev.type != "cuda":
        return _eager(key[0], block, carry, step)
    if key not in graphs:
        if any(k[:3] == key[:3] for k in graphs):
            graphs[key] = _capture(key[0], block, carry)
        else:
            out = _eager(key[0], block, carry, step)
            graphs[key] = _capture(key[0], block, carry)
            return out
    graph = graphs[key]
    if not trace.ON:
        return graph(carry, step)
    with trace.span("graph.replay", dev, kind=key[0], steps=block.steps,
                    nodes=graph.nodes["kernels"]):
        return graph(carry, step)


def _eager(kind: str, block, carry: dict, step: int) -> dict:
    dev = next(iter(carry.values())).device
    EAGER["card" if dev.type == "cuda" else "off_card"] += block.steps
    if not trace.ON:
        return block(carry, step_tensor(step, dev))
    with trace.span("graph.eager", dev, kind=kind, steps=block.steps):
        return block(carry, step_tensor(step, dev))


def _capture(kind: str, block, carry: dict) -> CapturedBlock:
    """:class:`CapturedBlock` ``(block, carry)``, counted in
    ``trace.CAPTURES`` with the seconds its capture and instantiation
    took."""
    t0 = time.perf_counter()
    if not trace.ON:
        graph = CapturedBlock(block, carry)
    else:
        dev = next(iter(carry.values())).device
        with trace.span("graph.capture", kind=kind) as sp:
            reserved = torch.cuda.memory_reserved(dev)
            graph = CapturedBlock(block, carry)
            sp.attrs.update(nodes=graph.nodes["kernels"],
                            pool_mib=(torch.cuda.memory_reserved(dev) - reserved) / 2**20)
    trace.CAPTURES.add(time.perf_counter() - t0)
    return graph


# ----------------------------------------------------------- the runner

class ChunkRunner:
    """A chunk runner: ``runner(state, n_steps, seg_aligned=False)``
    advances ``state`` by ``n_steps`` steps and returns what its blocks
    return, passed through ``finish`` where the runner has one.

    ``runner.blocks(state, n_steps, ...)`` is the chunk as a block
    iterator: it enqueues the chunk a block at a time, yields after each,
    and returns the final state; a call drains it, and the multi-place
    loops :func:`interleave` several.  A runner advances one chunk at a
    time (its graphs hold that chunk's carry): starting a second while one
    is open raises.  Built from:

    * ``blocks``, the engine's generator function of the chunk;
    * ``path``, the name of the path its chunks take (:meth:`span_path`
      names a call's);
    * ``path_info``, the runner's schedule, for callers;
    * ``finish`` (optional), applied to the drained result (the sharded
      runners' ``read_stats``).

    ``k`` is the rebuild cadence the runner's last chunk ran at (None:
    the runner keeps no table).  A call is the one ``chunk`` span where
    tracing is on (``utils/trace``: ``steps``, ``scenes``, ``path`` and,
    where the runner has one, ``k``).  Each engine keeps what is its own
    as plain attributes."""

    def __init__(self, blocks, path, path_info: dict, finish=None, k=None):
        self._blocks = blocks
        self.path = path
        self.path_info = path_info
        self.finish = finish
        self.k = k
        self._busy = False

    def span_path(self, state, n_steps: int, seg_aligned: bool) -> str:
        """The ``path`` attribute of a call's ``chunk`` span."""
        return self.path

    def blocks(self, *args, **kw):
        if self._busy:
            raise RuntimeError("a runner advances one chunk at a time")
        self._busy = True
        try:
            return (yield from self._blocks(*args, **kw))
        finally:
            self._busy = False

    def __call__(self, state, n_steps: int, seg_aligned: bool = False):
        if not trace.ON:
            out = drain(self.blocks(state, n_steps, seg_aligned))
        else:
            with trace.span("chunk", steps=n_steps,
                            scenes=state.pos.shape[0] if state.pos.dim() == 3 else 1,
                            path=self.span_path(state, n_steps, seg_aligned)) as sp:
                out = drain(self.blocks(state, n_steps, seg_aligned))
                if self.k is not None:
                    sp.attrs["k"] = self.k
        return out if self.finish is None else self.finish(out)


class HostValue:
    """A 0-dim device value on its way to the host: the copy is enqueued
    at once (on a card into pinned memory, behind an event), and
    :meth:`read` waits for that copy alone, not for the work enqueued
    after it."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
            t = host
        self._t = t

    def read(self) -> float:
        if self._event is not None:
            if trace.ON:
                with trace.span("chunk.probe_wait"):
                    self._event.synchronize()
            else:
                self._event.synchronize()
        return float(self._t)
