"""The JAX package's incremental-or-exact ``lax.cond``, for the port's
slot rebuilds.

``cond(pred, take_inc, take_exact, operands)`` is ``take_inc(operands)``
where the 0-dim bool ``pred`` holds and ``take_exact(operands)`` where it
does not: each branch maps the dict ``operands`` to a dict of tensors of
one layout, and ``pred`` is never read on the host.  It has two forms.

* **Inside a CUDA graph capture on the card**
  (``torch.cuda.is_current_stream_capturing()``), registered with
  :func:`capturing` (``engine_table._CapturedBlock`` does so): take_inc's
  result becomes the output buffers (an entry that aliases an operand is
  cloned first, so the body never writes an operand), then kernel
  ``cond_set`` and a conditional IF node follow (``kernels.cond_node``).
  The node's body runs take_exact on the operands and copies its result
  into the same buffers; it is captured on the capture's side stream into
  the node's body graph.  A replay runs the body only where ``pred`` is
  False, as the JAX package's compiled ``lax.cond`` skips its untaken
  branch.  A node that cannot be made, or a body whose capture fails,
  raises: there is no fallback to the select.
* **Everywhere else** (eager steps on the card, the CPU): both branches
  run and every output is ``torch.where(pred, inc, exact)``, a select with
  the same values, so eager and graph runs stay bit for bit comparable.

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


class GraphCapture:
    """A CUDA graph capture that conditional nodes may join: its device,
    the side stream its node bodies are captured on (made before the
    capture begins), the graph's memory pool while it captures, and the
    bodies made so far."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.side = torch.cuda.Stream(self.device)
        self.pool = None
        self.bodies: list = []
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
        far, with ``body_nodes``, the nodes of every body made."""
        counts = kernels.graph_nodes(kernels.capture_graph(capture_stream))
        counts["body_nodes"] = sum(kernels.graph_nodes(b)["nodes"] for b in self.bodies)
        return counts


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


def cond(pred: torch.Tensor, take_inc, take_exact, operands: dict) -> dict:
    """``take_inc(operands)`` where ``pred`` holds, else
    ``take_exact(operands)``: under a registered CUDA graph capture through
    a conditional node, elsewhere by a select (see the module docstring)."""
    if pred.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        return _graph_cond(pred, take_inc, take_exact, operands)
    inc, exact = take_inc(operands), take_exact(operands)
    return {k: torch.where(pred, v, exact[k]) for k, v in inc.items()}


def _graph_cond(pred, take_inc, take_exact, operands: dict) -> dict:
    capture = _CAPTURE.get()
    if capture is None or capture.device != pred.device:
        raise RuntimeError(
            "cond under a CUDA graph capture that no GraphCapture on "
            f"{pred.device} registered (engine_table._CapturedBlock does)"
        )
    held = {v.untyped_storage().data_ptr() for v in operands.values()}
    out = {
        k: v.clone() if v.untyped_storage().data_ptr() in held else v
        for k, v in take_inc(operands).items()
    }
    capture._route_to_pool()
    body = kernels.cond_node(pred)
    kernels.begin_body(capture.side, body)
    try:
        with torch.cuda.stream(capture.side):
            exact = take_exact(operands)
            for k, v in out.items():
                v.copy_(exact[k])
            del exact
    except BaseException:
        # the body is void: end its capture, and raise what voided it
        try:
            kernels.end_body(capture.side, body)
        except RuntimeError:
            pass
        raise
    kernels.end_body(capture.side, body)
    capture.bodies.append(body)
    return out
