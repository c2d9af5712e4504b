"""The yardstick's arithmetic: one H100's published peaks, and the bytes
and operations the pair-force pass and a span of kernel 3 need for a
scene's table.

A frozen copy of ``chip_smoke.py``'s ``bound``, ``occupied_pairs``,
``stencil_bound`` and ``span_bound``: the force kernel's bytes are its
input planes and its four output planes over every row of the table it
reads, its operations ``PAIR_OPS`` for every ordered pair of occupied
rows in each other's 3x3 cells; a span reads and writes the table's and
the parking strip's planes once, and does K steps of those pairs' work
and ``ROW_OPS`` (with ``OBSTACLE_OPS`` per obstacle) on every row.  The
occupancy is counted from the scene's positions with the reference's
table rule (``reference.cell_counts``), each cell holding at
most the force-visible capacity, so the count is what these inputs need
and not which kernel computes it.
"""

from __future__ import annotations

import math

import torch

from . import reference

# NVIDIA H100 SXM data sheet, 700 W: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
# operations every occupied candidate pair needs before its branch: dx, dy,
# d2 (4), sqrt, divide, dist, nx, ny, cd, two compares
PAIR_OPS = 14
# the force kernel's inputs: px, py, vx, vy, rad (and a payload's afac)
KERNEL_INPUTS = 5
# elementwise operations per row and step in kernel 3 without obstacles
# (friction ~25, radius law ~30, integrate ~12), and per obstacle
ROW_OPS, OBSTACLE_OPS = 67, 30
# the planes of kernel 3's table and parking strip: the table loop's 13
# fields (px, py, vx, vy, rad, val, afac, phase, dead, aa, ar, pay, bid)
TABLE_PLANES = 13


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


def segment_steps(p: dict) -> int:
    """Steps of a gate segment: the gcd of the centroid's and the phase
    law's periods, on whose multiples every gate fires."""
    return math.gcd(reference.steps_of(p, p["centroid_int"]),
                    reference.steps_of(p, p["phase_update_interval"]))


def span_work(p: dict, pos: torch.Tensor, k: int) -> tuple:
    """(bytes, operations) of one ``k``-step span of kernel 3 over the
    table and parking strip a scene at ``pos`` enters."""
    rows = reference.grid_dim(p) ** 2 * reference.storage_capacity(p) + (
        -(-p["n_cells"] // 128) * 128)
    n_obs = len(p["rect_obstacles"]) + len(p["circle_obstacles"])
    ops = k * (PAIR_OPS * scene_pairs(p, pos) + rows * (ROW_OPS + OBSTACLE_OPS * n_obs))
    return 2 * TABLE_PLANES * rows * 4, ops


def span_bound(p: dict, scenes_pos: list, k: int) -> tuple:
    """(seconds, what bounds it) of one ``k``-step span of kernel 3 over
    the tables of ``scenes_pos`` (one position tensor per scene)."""
    work = [span_work(p, pos, k) for pos in scenes_pos]
    return bound(sum(w[0] for w in work), sum(w[1] for w in work))
