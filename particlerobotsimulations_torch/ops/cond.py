"""The JAX package's ``lax.cond`` s inside the port's CUDA graphs: the
incremental-or-exact slot rebuild, and the span segment's adopt-or-redo.

``cond(pred, take_inc, take_exact, operands)`` is ``take_inc(operands)``
where the 0-dim bool ``pred`` holds and ``take_exact(operands)`` where it
does not: each branch maps the dict ``operands`` to a dict of tensors of
one layout, and ``pred`` is never read on the host.  It has two forms.

* **Inside a CUDA graph capture on the card**
  (``torch.cuda.is_current_stream_capturing()``), registered with
  :func:`capturing` (``chunk.CapturedBlock`` does so): take_inc's
  result becomes the output buffers (an entry that aliases an operand is
  cloned first, so the body never writes an operand), then kernel
  ``cond_set`` and a conditional IF node follow (``kernels.cond_node``).
  The node's body runs take_exact on the operands and copies its result
  into the same buffers.  A replay runs the body only where ``pred`` is
  False, as the JAX package's compiled ``lax.cond`` skips its untaken
  branch.  A node that cannot be made, or a body whose capture fails,
  raises: there is no fallback to the select.
* **Everywhere else** (eager steps on the card, the CPU): both branches
  run and every output is ``torch.where(pred, inc, exact)``, a select with
  the same values, so eager and graph runs stay bit for bit comparable.

``branch(pred, take_true, take_false, operands, outputs)`` is the span
segment's adopt-or-redo, where the untaken branch is a whole segment and
must not run: under a capture an IF node with an else branch, each
branch in its own body (they write the same output buffers); eagerly it
reads ``pred`` on the host and runs one branch.

``repeat(n, block, carry, step0, stride)`` runs ``block`` ``n`` times
in turn (the JAX package's ``lax.scan`` of blocks, in the span segment's
redo): under a capture a conditional WHILE node whose body, one run of
the block on loop buffers, is captured once; eagerly a Python loop.

Nodes nest: a cond, branch or repeat called while a body is being
captured makes its node inside that body's graph.  Each nesting depth captures its
bodies on its own side stream of the :class:`GraphCapture` (made before
the capture begins, :data:`MAX_DEPTH` of them); a deeper node raises.

Launches: a body's kernel launches run only on the replays that take
it.  A body that launches a kernel also increments a 0-dim int64 device
counter of its own, and its launches are counted per run of that
counter (``kernels.LAUNCHES.defer``, settled when a count is read); the
capture's own count (``kernels.LAUNCHES`` while it captures) keeps only
the launches every replay runs.  An else body's launches stay in the
capture's count, and the first body's counter carries the difference.

Memory: allocations made while a body is captured must come from the
graph's private pool, or the allocator would hand eager code blocks that
the graph's replays write.  The graph's capture routes only its own
capture's allocations there (a filter on the capture id), and the body's
capture has another id; so at its first node a capture routes every
allocation of this thread to the graph's pool for the rest of the capture
(``torch._C._cuda_beginAllocateCurrentThreadToPool``, as
``torch.cuda.use_mem_pool`` does; ``capture_end`` ends that routing).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from .. import kernels

_CAPTURE = contextvars.ContextVar("pbot_graph_capture", default=None)

# nesting depths of conditional nodes a capture takes: the span segment's
# redo body holds the rebuilds' nodes
MAX_DEPTH = 3
# bodies with launches of their own that a capture counts (the span
# segment's redo body: one)
MAX_COUNTED = 8


class GraphCapture:
    """A CUDA graph capture that conditional nodes may join: its device,
    one side stream per nesting depth that its node bodies are captured
    on, and :data:`MAX_COUNTED` device counters for the bodies that launch
    kernels (both made before the capture begins: a counter in the
    graph's pool could share memory that the replays' temporaries write),
    the graph's memory pool while it captures, the bodies made so far,
    and the counters in use with their bodies' launches."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.sides = [torch.cuda.Stream(self.device) for _ in range(MAX_DEPTH)]
        self.counters = torch.zeros(MAX_COUNTED, dtype=torch.int64, device=self.device)
        self.depth = 0
        self.pool = None
        self.bodies: list = []
        self.counted: list = []  # (launches per run, counter)
        self._routed = False

    def _route_to_pool(self) -> None:
        """From now on until the capture ends, every allocation of this
        thread comes from the graph's pool (see the module docstring)."""
        if self._routed:
            return
        index = self.device.index if self.device.index is not None else torch.cuda.current_device()
        torch._C._cuda_endAllocateToPool(index, self.pool)
        torch._C._cuda_beginAllocateCurrentThreadToPool(index, self.pool)
        # the pool's use count is the graph's alone again: the graph
        # releases it once, and capture_end ends this routing
        torch._C._cuda_releasePool(index, self.pool)
        self._routed = True

    def node_counts(self, capture_stream: torch.cuda.Stream) -> dict:
        """The captured graph's nodes by type (``kernels.graph_nodes``) so
        far, with ``body_nodes``, the nodes of every body made (nested
        bodies included, each counted once)."""
        counts = kernels.graph_nodes(kernels.capture_graph(capture_stream))
        counts["body_nodes"] = sum(kernels.graph_nodes(b)["nodes"] for b in self.bodies)
        return counts

    def finish(self) -> None:
        """After the capture ended: count the bodies' launches per run of
        their counters (``kernels.LAUNCHES.defer``)."""
        for launches, counter in self.counted:
            kernels.LAUNCHES.defer(launches, counter)

    def _body(self, body: int, fn, operands: dict, out: dict, every_replay: dict | None):
        """Capture ``fn(operands)`` into ``body`` on the next depth's side
        stream, copying its result into ``out``; returns the launches it
        made.  ``every_replay=None``: the launches stay in the capture's
        count, which every replay adds.  Else they leave it, and those
        beyond ``every_replay`` (what every replay already counts for this
        node) are counted per run of a device counter that the body
        increments (one of the capture's)."""
        if self.depth >= MAX_DEPTH:
            raise RuntimeError(f"conditional nodes nested deeper than {MAX_DEPTH}")
        side = self.sides[self.depth]
        before = kernels.LAUNCHES.host_counts()
        self.depth += 1
        kernels.begin_body(side, body)
        try:
            with torch.cuda.stream(side):
                res = fn(operands)
                for k, v in out.items():
                    v.copy_(res[k])
                del res
                now = kernels.LAUNCHES.host_counts()
                made = {n: c - before[n] for n, c in now.items() if c != before[n]}
                if every_replay is not None:
                    extra = {n: made.get(n, 0) - every_replay.get(n, 0)
                             for n in {*made, *every_replay}}
                    if any(extra.values()):
                        if len(self.counted) == MAX_COUNTED:
                            raise RuntimeError(f"more than {MAX_COUNTED} counted bodies")
                        counter = self.counters[len(self.counted)]
                        counter.add_(1)
                        self.counted.append((extra, counter))
        except BaseException:
            # the body is void: end its capture, and raise what voided it
            try:
                kernels.end_body(side, body)
            except RuntimeError:
                pass
            raise
        finally:
            self.depth -= 1
        kernels.end_body(side, body)
        self.bodies.append(body)
        if every_replay is not None:
            kernels.LAUNCHES.restore(before)
        return made


@contextlib.contextmanager
def capturing(capture: GraphCapture, pool):
    """Register ``capture`` for the conds called while a CUDA graph whose
    capture has begun with the memory pool ``pool`` (a
    ``torch.cuda.graph_pool_handle()``) captures."""
    capture.pool = pool
    token = _CAPTURE.set(capture)
    try:
        yield capture
    finally:
        _CAPTURE.reset(token)


def _captured(pred: torch.Tensor) -> bool:
    return pred.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _registered(pred: torch.Tensor) -> GraphCapture:
    capture = _CAPTURE.get()
    if capture is None or capture.device != pred.device:
        raise RuntimeError(
            "cond under a CUDA graph capture that no GraphCapture on "
            f"{pred.device} registered (chunk.CapturedBlock does)"
        )
    capture._route_to_pool()
    return capture


def cond(pred: torch.Tensor, take_inc, take_exact, operands: dict) -> dict:
    """``take_inc(operands)`` where ``pred`` holds, else
    ``take_exact(operands)``: under a registered CUDA graph capture through
    a conditional node, elsewhere by a select (see the module docstring)."""
    if _captured(pred):
        return _graph_cond(pred, take_inc, take_exact, operands)
    inc, exact = take_inc(operands), take_exact(operands)
    return {k: torch.where(pred, v, exact[k]) for k, v in inc.items()}


def _graph_cond(pred, take_inc, take_exact, operands: dict) -> dict:
    capture = _registered(pred)
    held = {v.untyped_storage().data_ptr() for v in operands.values()}
    out = {
        k: v.clone() if v.untyped_storage().data_ptr() in held else v
        for k, v in take_inc(operands).items()
    }
    (body,) = kernels.cond_node(pred)
    capture._body(body, take_exact, operands, out, every_replay={})
    return out


def branch(pred: torch.Tensor, take_true, take_false, operands: dict, outputs) -> dict:
    """``take_true(operands)`` where ``pred`` holds, else
    ``take_false(operands)``, with only the chosen branch run: under a
    registered CUDA graph capture an IF node with an else branch, each
    branch in its own body; elsewhere ``pred`` is read on the host.  Both
    branches return the entries ``outputs`` names, each in the layout of
    the operand of that name."""
    if not _captured(pred):
        return take_true(operands) if bool(pred) else take_false(operands)
    capture = _registered(pred)
    out = {k: torch.empty_like(operands[k]) for k in outputs}
    if_false, if_true = kernels.cond_node(pred, bodies=2)
    # the else body's launches are counted at every replay, and the first
    # body's counter corrects that on the replays that take it
    true_launches = capture._body(if_true, take_true, operands, out, every_replay=None)
    capture._body(if_false, take_false, operands, out, every_replay=true_launches)
    return out


def repeat(n: int, block, carry: dict, step0: torch.Tensor, stride: int) -> dict:
    """``n`` runs of ``block(carry, step) -> carry`` in turn, at the 0-dim
    int64 device steps ``step0``, ``step0 + stride``, ...; returns the
    last carry (the entries ``carry`` names).  Under a registered CUDA
    graph capture: the carry copied into loop buffers, then a conditional
    WHILE node whose body (captured once) runs the block on the buffers,
    copies its result back, advances the step and a run counter, and
    stops after ``n`` runs (kernel ``cond_set`` at its end); elsewhere a
    Python loop, the same values."""
    if not _captured(step0):
        for i in range(n):
            carry = {**carry, **{k: v for k, v in block(carry, step0 + i * stride).items()
                                 if k in carry}}
        return carry
    capture = _registered(step0)
    state = {k: v.clone() for k, v in carry.items()}
    step = step0.clone()
    runs = torch.zeros((), dtype=torch.int64, device=step0.device)
    handle, body = kernels.while_node(torch.full((), n <= 0, dtype=torch.bool,
                                                 device=step0.device))

    def one(_):
        out = block(state, step)
        for k, v in state.items():
            v.copy_(out[k])
        step.add_(stride)
        runs.add_(1)
        kernels.set_conditional(handle, runs >= n)
        return {}

    capture._body(body, one, {}, {}, every_replay={})
    return state
