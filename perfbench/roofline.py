"""The yardstick's arithmetic: one H100's published peaks, and the bytes
and operations the pair-force pass needs for a scene's table.

A frozen copy of ``chip_smoke.py``'s ``bound``, ``occupied_pairs`` and
``stencil_bound``: the bytes are the force kernel's input planes and its
four output planes over every row of the table it reads, the operations
``PAIR_OPS`` for every ordered pair of occupied rows in each other's 3x3
cells.  The occupancy is counted from the scene's positions with the
reference's table rule (``reference.cell_counts``), each cell holding at
most the force-visible capacity, so the count is what these inputs need
and not which kernel computes it.
"""

from __future__ import annotations

import torch

from . import reference

# NVIDIA H100 SXM data sheet, 700 W: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
# operations every occupied candidate pair needs before its branch: dx, dy,
# d2 (4), sqrt, divide, dist, nx, ny, cd, two compares
PAIR_OPS = 14
# the force kernel's inputs: px, py, vx, vy, rad (and a payload's afac)
KERNEL_INPUTS = 5


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(seconds, what bounds it): the larger of the bytes over the memory
    rate and the operations over the float32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def occupied_pairs(counts: torch.Tensor, g: int) -> int:
    """Ordered pairs of occupied rows in each other's 3x3 cells, the 2-D
    wrap exact, of a ``G x G`` grid of per-cell counts."""
    n = counts.reshape(g, g).to(torch.int64)
    around = sum(torch.roll(n, (-dy, -dx), dims=(0, 1))
                 for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return int((n * around).sum() - n.sum())


def scene_pairs(p: dict, pos: torch.Tensor) -> int:
    """:func:`occupied_pairs` of the table a scene at ``pos`` (real bots,
    bot order) enters, each cell capped at the force-visible capacity."""
    _, counts = reference.cell_counts(p, pos)
    return occupied_pairs(torch.clamp(counts, max=p["cell_capacity"]), reference.grid_dim(p))


def stencil_bound(p: dict, scenes_pos: list) -> tuple:
    """(seconds, what bounds it) of one pair-force pass over the tables
    of ``scenes_pos`` (one position tensor per scene)."""
    g = reference.grid_dim(p)
    rows = g * g * p["cell_capacity"] * len(scenes_pos)
    ops = PAIR_OPS * sum(scene_pairs(p, pos) for pos in scenes_pos)
    return bound((KERNEL_INPUTS + 4) * rows * 4, ops)
