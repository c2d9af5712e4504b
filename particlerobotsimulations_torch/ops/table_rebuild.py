"""Incremental slot rebuild — the slot compaction (kernel 2), no sorting.

Port of ``particlerobotsimulations_tpu.ops.table_rebuild``.  Between
rebuilds every bot moves at most one cell, so reassigning slots is a local
operation: each occupied row's true cell differs from its current lane by
dx, dy in {-1, 0, 1}, and every target lane takes the rows of its 9
neighbour lanes (LINEAR lane offsets ``dy*G + dx``) whose move lands there,
compacted into slots 0..k-1 in (OFFSETS9 order, slot) order.  The
compaction is the hand-written CUDA kernel in ``csrc/compact.cu`` on a CUDA
tensor and a plain twin on a CPU tensor, in two forms: :func:`compact`
wraps the whole table's lanes (the single-table loop), and
:func:`compact_padded` reads explicitly padded lanes (the sharded loop,
``parallel/spatial_table.py``, pads with the neighbour shards' halo rows).

Linear lane arithmetic equals the 2-D wrap for y exactly; for x it is
wrong only when a read crosses a row boundary, which can only matter if
the wrapped edge columns (ix = 0 or G-1) are occupied or receive movers.
The engine anchors the blob EDGE_MARGIN cells in, and ``ok`` turns false
— the caller then runs the exact rebuild — when that guard fails, on any
>1-cell move, or on cell-capacity overflow.  Parked bots do not veto the
incremental path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimParams
from .grid import OFFSETS9

f32 = np.float32

CHUNK = 128          # lane tile of the JAX kernel; the wrap pad is whole tiles
EDGE_MARGIN = 2      # empty wrapped-edge columns the engine maintains
_FAR = 99            # dx/dy sentinel for empty rows (never matches)


def _n_halo(g: int) -> int:
    """Pad tiles per side that cover lane offsets up to g+1."""
    return -(-(g + 1) // CHUNK)


def compact_padded_plain(params: SimParams, planes_padded: torch.Tensor,
                         pad_lanes: int, out_lanes: int):
    """Plain PyTorch twin of kernel 2's padded form: (..., nf + 2, Cs,
    pad + out + pad) planes (data fields, then dx, dy) -> (compacted (...,
    nf, Cs, out) planes, per-lane incoming count (..., out) float32) for the
    CENTER lanes.  Target lane L reads source lane ``pad + L + oy*G + ox``
    with no wrap: the pad carries the wrap or the neighbour shards' rows.
    Leading axes (the sharded loop's shard axis) are independent.  Per
    offset: slice the source lanes, rank the matching rows by an exclusive
    cumsum over slots on top of the running count, and scatter those with a
    free slot."""
    g = params.resolved_grid_dim()
    if pad_lanes < g + 1 or planes_padded.shape[-1] != 2 * pad_lanes + out_lanes:
        raise ValueError(
            f"compact_padded: need pad >= {g + 1} and {2 * pad_lanes + out_lanes} "
            f"lanes, got pad {pad_lanes} and {planes_padded.shape[-1]} lanes"
        )
    lead = planes_padded.shape[:-3]
    nfp, cs, width = planes_padded.shape[-3:]
    nf = nfp - 2
    planes = planes_padded.reshape((-1, nfp, cs, width))
    b = planes.shape[0]
    dev = planes.device
    out = torch.zeros((b, nf, cs, out_lanes), dtype=torch.float32, device=dev)
    count = torch.zeros((b, out_lanes), dtype=torch.int64, device=dev)
    for ox, oy in OFFSETS9:
        lo = pad_lanes + oy * g + ox
        cand = planes[..., lo : lo + out_lanes]
        m = (cand[:, nf] == f32(-ox)) & (cand[:, nf + 1] == f32(-oy))
        mi = m.to(torch.int64)
        rank = count[:, None, :] + torch.cumsum(mi, dim=1) - mi
        b_idx, c_idx, l_idx = torch.nonzero(m & (rank < cs), as_tuple=True)
        out[b_idx, :, rank[b_idx, c_idx, l_idx], l_idx] = cand[b_idx, :nf, c_idx, l_idx]
        count = count + mi.sum(dim=1)
    return (
        out.reshape(lead + (nf, cs, out_lanes)),
        count.to(torch.float32).reshape(lead + (out_lanes,)),
    )


def compact_plain(params: SimParams, planes: torch.Tensor):
    """Plain PyTorch twin of kernel 2's wrap form: (nf + 2, Cs, G*G) planes
    -> (compacted (nf, Cs, G*G) planes, per-lane incoming count (G*G,)
    float32).  The padded form on the table padded with its own wrapped
    lanes, as the JAX ``_compact`` builds it.  Leading axes (the batched
    loop's scenes) are independent stacks, each compacted on its own."""
    gg = planes.shape[-1]
    halo = _n_halo(params.resolved_grid_dim()) * CHUNK
    padded = torch.cat([planes[..., gg - halo :], planes, planes[..., :halo]], dim=-1)
    return compact_padded_plain(params, padded, halo, gg)


def compact(params: SimParams, planes: torch.Tensor):
    """Kernel 2's wrap form on a CUDA tensor, the plain twin on a CPU
    tensor.  ``planes`` is (nf + 2, Cs, G*G) or, with a leading scene
    axis, (B, nf + 2, Cs, G*G): one launch for all scenes."""
    kind = planes.device.type
    if kind == "cuda":
        from ..kernels import compact_batched_cuda, compact_cuda

        fn = compact_batched_cuda if planes.dim() == 4 else compact_cuda
        return fn(params, planes)
    if kind == "cpu":
        return compact_plain(params, planes)
    raise ValueError(f"compact: unsupported device {planes.device}")


def compact_padded(params: SimParams, planes_padded: torch.Tensor,
                   pad_lanes: int, out_lanes: int):
    """Kernel 2's padded form on a CUDA tensor, the plain twin
    :func:`compact_padded_plain` on a CPU tensor.  ``planes_padded`` is
    (nf + 2, Cs, pad + out + pad) or, with a leading shard axis, (S, nf + 2,
    Cs, pad + out + pad), or the dp x tp loop's (S, B, nf + 2, Cs, pad + out
    + pad): one launch for every shard and scene."""
    kind = planes_padded.device.type
    if kind == "cuda":
        from ..kernels import compact_padded_batched_cuda, compact_padded_cuda

        fn = compact_padded_batched_cuda if planes_padded.dim() == 5 else compact_padded_cuda
        return fn(params, planes_padded, pad_lanes, out_lanes)
    if kind == "cpu":
        return compact_padded_plain(params, planes_padded, pad_lanes, out_lanes)
    raise ValueError(f"compact_padded: unsupported device {planes_padded.device}")


def _wrap_center(d: torch.Tensor, g: int) -> torch.Tensor:
    return ((d + g // 2) % g) - g // 2


def rebuild_move_planes(params: SimParams, planes, field_names: tuple, origin,
                        lane_offset=0):
    """(dxf, dyf, moved_far, edge): per-row wrapped cell displacements
    (``_FAR`` on empty rows) and the incremental-compaction preconditions,
    bool tensors over the last two axes, the slots and lanes of a table:
    0-dim for one table's (nf, Cs, L) planes, one flag per block of a
    stack (nf, ..., Cs, L), such as each shard and scene of the sharded
    loop's.  ``lane_offset`` is the global lane of the planes' first lane
    — an int, or a tensor that broadcasts against ``planes.shape[1:]``
    (one offset per shard of the sharded loop's shard stack)."""
    g = params.resolved_grid_dim()
    h = f32(params.cutoff())

    val = planes[field_names.index("val")] > 0.5
    px = planes[field_names.index("px")]
    py = planes[field_names.index("py")]

    # true wrapped cell vs current lane position
    ixt = torch.floor((px - origin[0]) / h).to(torch.int32) % g
    iyt = torch.floor((py - origin[1]) / h).to(torch.int32) % g
    lane = torch.arange(planes.shape[-1], dtype=torch.int32, device=px.device)
    lane = lane.expand(planes.shape[1:]) + lane_offset
    ixc = lane % g
    dx = _wrap_center(ixt - ixc, g)
    dy = _wrap_center(iyt - torch.div(lane, g, rounding_mode="floor"), g)

    def any_(x):
        return torch.any(x.flatten(-2), dim=-1)

    moved_far = any_(val & ((dx.abs() > 1) | (dy.abs() > 1)))
    # x-edge guard: linear lane windows mis-wrap across rows, harmless only
    # while the wrapped edge columns (0 and G-1) neither hold nor receive
    # rows; margin 1 leaves a cell of drift before the exact fallback
    edge = any_(
        val & ((ixc == 0) | (ixc == g - 1) | (ixt == 0) | (ixt == g - 1))
    )
    far = torch.full_like(px, f32(_FAR))
    dxf = torch.where(val, dx.to(torch.float32), far)
    dyf = torch.where(val, dy.to(torch.float32), far)
    return dxf, dyf, moved_far, edge


def incremental_rebuild_planes(params: SimParams, planes, field_names, origin):
    """Plane-native core of :func:`incremental_rebuild`: (new_planes, ok)
    for (nf, Cs, G*G) stacked field planes; ``ok`` is a 0-dim bool tensor.
    With a leading scene axis ((B, nf, Cs, G*G) planes, (B, 2) origins)
    the preconditions are taken per scene (vmapped), kernel 2 compacts
    every scene in one launch, and ``ok`` is (B,).  Parked bots do not veto
    the incremental path: they ride through untouched and get
    reinstatement attempts at fallbacks and chunk entries."""
    cap = params.storage_capacity()
    if planes.dim() == 4:
        dxf, dyf, moved_far, edge = torch.func.vmap(
            lambda pl, o: rebuild_move_planes(params, pl, field_names, o)
        )(planes, origin)
    else:
        dxf, dyf, moved_far, edge = rebuild_move_planes(
            params, planes, field_names, origin
        )
    stacked = torch.cat([planes, dxf.unsqueeze(-3), dyf.unsqueeze(-3)], dim=-3)
    new_planes, incoming = compact(params, stacked)
    overflow = torch.any(incoming > cap, dim=-1)
    ok = ~(moved_far | overflow | edge)
    return new_planes, ok


def incremental_rebuild(params: SimParams, fields: dict, field_names: tuple, origin):
    """(new_fields, ok) on the engine's flat ``(total_ext,)`` fields, or
    the batched loop's ``(B, total_ext)`` fields with (B, 2) origins (then
    ``ok`` is per scene): only ``field_names`` are stacked, compacted and
    returned; the parking strip rows pass through.  ``ok`` False means the
    caller must run the exact rebuild instead."""
    g, cap = params.resolved_grid_dim(), params.storage_capacity()
    gg = g * g
    total = gg * cap
    nf = len(field_names)
    lead = fields[field_names[0]].shape[:-1]
    planes = torch.stack(
        [fields[k][..., :total] for k in field_names], dim=-2
    ).reshape(lead + (nf, cap, gg))
    new_planes, ok = incremental_rebuild_planes(params, planes, field_names, origin)
    new_fields = {
        k: torch.cat(
            [new_planes[..., j, :, :].reshape(lead + (total,)), fields[k][..., total:]],
            dim=-1,
        )
        for j, k in enumerate(field_names)
    }
    return new_fields, ok
