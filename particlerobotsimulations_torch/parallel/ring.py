"""A ring of D shards: the collectives of the sharded table loop.

The JAX package runs its sharded loop (``parallel/spatial_table.py``)
under ``shard_map`` over a device mesh, with ``ppermute`` for the ring
shifts and ``psum`` / ``pmin`` / ``all_gather`` for the reductions.  The
port writes the loop once over a stack of the shards one process holds —
every per-shard tensor has a leading shard axis of length S — and routes
everything that crosses shards through one of two rings:

* :class:`LocalRing` holds all D shards in one process on one device
  (S = D): the shifts are rolls over the shard axis and the reductions run
  over it, so each kernel launches once for all shards.  It is the
  counterpart of the JAX tests' virtual-device mesh.
* :class:`DistRing` runs one shard per rank (S = 1) over
  ``torch.distributed``: point-to-point sends to the ring neighbours and
  ``all_reduce`` / ``all_gather``.  NCCL on cards (one card per rank),
  gloo on the CPU.

Both take and return per-shard stacks ``(S, ...)``; ``psum`` and ``pmin``
return the reduction over all D shards without the shard axis (the same
value on every shard).
"""

from __future__ import annotations

import torch


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class LocalRing:
    """All ``n_shards`` shards in this process, on ``device``."""

    def __init__(self, n_shards: int, device="cuda"):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        self.device = _device(device)
        self._ids = torch.arange(n_shards, device=self.device)

    def shard_ids(self) -> torch.Tensor:
        return self._ids

    def from_prev(self, x: torch.Tensor) -> torch.Tensor:
        """Shard d receives shard d-1's ``x`` (shard 0 receives D-1's)."""
        return torch.roll(x, 1, dims=0)

    def from_next(self, x: torch.Tensor) -> torch.Tensor:
        """Shard d receives shard d+1's ``x`` (shard D-1 receives 0's)."""
        return torch.roll(x, -1, dims=0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=0)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return x.amin(dim=0)


class DistRing:
    """One shard per rank of ``group`` (the default group when None), over
    an initialised ``torch.distributed``.  Tensors live on this rank's
    current card with NCCL and on the CPU otherwise."""

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistRing needs an initialised torch.distributed")
        self._dist = dist
        self.group = group
        self.n_shards = dist.get_world_size(group)
        if self.n_shards < 2:
            raise ValueError("DistRing needs at least 2 ranks")
        self.rank = dist.get_rank(group)
        if dist.get_backend(group) == "nccl":
            self.device = _device("cuda")
        else:
            self.device = torch.device("cpu")
        self._ids = torch.tensor([self.rank], device=self.device)

    def shard_ids(self) -> torch.Tensor:
        return self._ids

    def _peer(self, r: int) -> int:
        r %= self.n_shards
        if self.group is None:
            return r
        return self._dist.get_global_rank(self.group, r)

    def _shift(self, x: torch.Tensor, to: int, frm: int) -> torch.Tensor:
        dist = self._dist
        x = x.contiguous()
        got = torch.empty_like(x)
        ops = [
            dist.P2POp(dist.isend, x, self._peer(to), self.group),
            dist.P2POp(dist.irecv, got, self._peer(frm), self.group),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got

    def from_prev(self, x: torch.Tensor) -> torch.Tensor:
        return self._shift(x, self.rank + 1, self.rank - 1)

    def from_next(self, x: torch.Tensor) -> torch.Tensor:
        return self._shift(x, self.rank - 1, self.rank + 1)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.n_shards)]
        self._dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=0)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        y = x[0].clone()
        self._dist.all_reduce(y, op=op, group=self.group)
        return y

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, self._dist.ReduceOp.SUM)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, self._dist.ReduceOp.MIN)
