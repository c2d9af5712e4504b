"""What decides ``correct``: the plain reference follows the program.

The dynamics is chaotic: two float32 runs that add the same pair terms in
another order part by a rounding step and, with the contact spring's
stiffness, the gap grows about e-fold every ~16 steps (a 300-bot scene on
the CPU: 5e-7 units of position after 16 steps, 4e-5 after 32, 9e-3 after
64).  So the reference cannot step a whole chunk beside the program and
land on its answer; it follows the program from the program's own state,
a piece of :data:`PIECE_STEPS` steps at a time.

After the window, the cell's own entry runs one more chunk of the
traffic's length from the window's last state, at full size, on all its
scenes, and the program's state is recorded at block ends inside it
(``workload.BlockEnds``): so the pieces are the blocks the window replays
(on the adaptive table loop its probe segment and its K=8 blocks), each
from the carry the block before it left.  The pieces start at
(:func:`starts`) the chunk's entry, the middle of its first gate segment
and the first block after it, the first phase-law and centroid steps
inside the chunk, the chunk's last block (which ends in the chunk's
answer as the user reads it) and :data:`DRAWN` blocks drawn from the
seed.  Where the blocks are longer than a piece (a span segment is one
graph), the pieces are instead the entry's own calls of a piece's length
from the chunk's entry and from its answer (they run the regular path,
never kernel 3).  Where the chunk ran span segments, kernel 3 is judged
on its own answers too: the chunk's first segment is run again from
the chunk's entry, eagerly, through a fresh runner of the cell's entry
(``workload.SpanCalls`` records each span's input and answer), and
:data:`SPAN_PIECES` of its spans (:func:`span_picks`) are pieces that
start and end mid-step, a span's K steps each.  ``replay_gap``, the
widest field gap between that eager segment's answer and the timed
runner's graph-replayed answer for the same segment, ties the recorded
spans to what the window replayed (the adopt-or-redo branch included):
the two launch the same kernels on the same inputs, so its limit is 0.
One more piece of
:data:`START_STEPS` runs from the cell's initial state (the layout's
exactly touching pairs, which no window chunk starts from).  The
reference runs the same steps from the same fields on the same draws,
scene by scene; a gated step's phase noise is read at each bot's row in
the table the program drew in: the entry's rows, worked out again, or
the rows of the program's table at the piece's start.

The numbers are the widest gaps between the program's and the
reference's fields after the piece, over every bot, piece and scene;
the centroid ring's rows the pieces wrote; and ``bots_off``, how many
bots of one piece part from the reference by more than a rounding step's
worth.  A cell compares the numbers its limits file names
(``limits/<cell>.json``), each held to its limit.  A piece whose noise
the program did not draw reads :data:`NO_AGREEMENT`.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

from . import reference

NUMBERS = ("pos_gap", "vel_gap", "rad_gap", "phase_gap", "ring_gap", "bots_off")
# the number of a chunk that ran span segments, beside :data:`NUMBERS`
REPLAY = "replay_gap"
FIELD_OF = {"pos_gap": "pos", "vel_gap": "vel", "rad_gap": "rad", "phase_gap": "phase"}
# steps of a piece (a contact that flips on rounding moves a bot's
# velocity by ~0.03-0.7; shorter pieces give its effect less time to
# spread); the piece from the initial state; pieces drawn from the seed
PIECE_STEPS = 8
START_STEPS = 1
DRAWN = 2
# spans of the segment run again that are pieces: its first, its last
# and one drawn from the seed
SPAN_PIECES = 3
# a bot is off where its position or velocity part from the reference's
# by more than these
OFF_POS, OFF_VEL = 1e-5, 1e-3


@dataclass
class Piece:
    """One scene of one piece: where it started (step and fields, with
    ``rows``, the bots' table rows, or None), and the program's fields and
    centroid ring after ``steps`` steps (``end`` None: no end recorded);
    ``mid``: the piece starts and ends mid-step, as a span of kernel 3
    does (``reference.run``'s ``mid``)."""

    scene: int
    step: int
    steps: int
    start: dict
    end: dict | None
    mid: bool = False


def starts(p: dict, seed: int, entry: int, chunk: int, seg: int) -> list:
    """The steps at which the pieces of a chunk entered at step ``entry``
    start (see the module's docstring)."""
    last = chunk - PIECE_STEPS
    offsets = {0, last}
    if 0 < seg < last:
        offsets.update((seg // 2 // PIECE_STEPS * PIECE_STEPS, seg))
    for every in (reference.steps_of(p, p["phase_update_interval"]),
                  reference.steps_of(p, p["centroid_int"])):
        first = (-entry) % every or every
        if first < last:
            offsets.add(first)
    blocks = np.arange(PIECE_STEPS, last, PIECE_STEPS)
    if len(blocks):
        rng = np.random.default_rng([int(seed) & (2**63 - 1), int(entry)])
        offsets.update(int(o) for o in rng.choice(blocks, min(DRAWN, len(blocks)), replace=False))
    return sorted(entry + o for o in offsets)


def span_picks(seed: int, entry: int, n: int) -> list:
    """Which of a segment's ``n`` spans are pieces: the first, the last
    and one between them drawn from the seed (fewer where ``n`` is
    small)."""
    if n <= SPAN_PIECES - 1:
        return list(range(n))
    rng = np.random.default_rng([int(seed) & (2**63 - 1), int(entry), SPAN_PIECES])
    return [0, int(rng.integers(1, n - 1)), n - 1]


def replay_gap(eager: list, replayed: list) -> float:
    """The widest gap of any field (and the centroid ring) between two
    answers of one segment, scene by scene (``Workload.snapshot``'s
    dicts); :data:`NO_AGREEMENT` where one is not finite."""
    gap = 0.0
    for a, b in zip(eager, replayed, strict=True):
        for k in reference.FIELDS + ("centroid_ring",):
            if torch.equal(a[k], b[k]):
                continue
            d = float((a[k].float() - b[k].float()).abs().max())
            gap = max(gap, d if np.isfinite(d) else NO_AGREEMENT)
    return gap


def follow(p: dict, piece: Piece, draws, dtype=torch.float32) -> tuple:
    """The reference's fields and centroid rows after the piece's steps
    from its start, computed in ``dtype``."""
    return reference.run(p, piece.start, piece.step, piece.steps, draws, dtype,
                         rows=piece.start.get("rows"), mid=piece.mid)


def gaps(end: dict, ring_end: torch.Tensor, ref: dict, ref_ring: dict) -> dict:
    """The widest gap of each compared number between one side's fields
    (``end``, its centroid ring) and the reference's."""
    out = {name: float((end[f] - ref[f]).abs().max()) for name, f in FIELD_OF.items()}
    out["ring_gap"] = max(
        (float((ring_end[row] - v).abs().max()) for row, v in ref_ring.items()), default=0.0)
    off = ((end["pos"] - ref["pos"]).abs().amax(1) > OFF_POS) | (
        (end["vel"] - ref["vel"]).abs().amax(1) > OFF_VEL)
    out["bots_off"] = float(off.sum())
    return out


def widest(readings) -> dict:
    """Each number's widest reading over pieces and scenes."""
    out = dict.fromkeys(NUMBERS, 0.0)
    for r in readings:
        for k in NUMBERS:
            out[k] = max(out[k], r[k])
    return out


# the reading of a piece the reference cannot follow (no end recorded, or
# the program did not draw the noise of its steps): the largest finite
# float, so that the result line stays plain JSON
NO_AGREEMENT = sys.float_info.max


def program_readings(p: dict, pieces: list, draws: list, dtype=torch.float32) -> list:
    """One reading per piece and scene: the program against the
    reference computed in ``dtype``."""
    out = []
    for pc in pieces:
        try:
            if pc.end is None:
                raise reference.MissingDraw("no block end recorded")
            ref, ring = follow(p, pc, draws[pc.scene], dtype)
        except reference.MissingDraw:
            out.append(dict.fromkeys(NUMBERS, NO_AGREEMENT))
            continue
        out.append(gaps(pc.end, pc.end["centroid_ring"], ref, ring))
    return out


def control_readings(p: dict, pieces: list, draws: list, dtype=torch.bfloat16,
                     against=torch.float32) -> list:
    """The reference computed in ``dtype`` put in the program's place,
    against the reference computed in ``against``: the control (bfloat16
    against float32), or a witness of what rounding alone does (float32
    against float64)."""
    out = []
    for pc in pieces:
        if pc.end is None:
            continue
        ref, ring = follow(p, pc, draws[pc.scene], against)
        low, low_ring = follow(p, pc, draws[pc.scene], dtype)
        ring_end = pc.start["centroid_ring"].clone()
        for row, v in low_ring.items():
            ring_end[row] = v
        out.append(gaps(low, ring_end, ref, ring))
    return out


def judge(numbers: dict, limits: dict) -> bool:
    """Whether every number the cell compares (each that its limits
    name) is within its limit."""
    return all(numbers[k] <= limit for k, limit in limits.items())
