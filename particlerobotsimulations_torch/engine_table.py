"""Table-resident step loop for the PALLAS backend — the production path.

Port of ``particlerobotsimulations_tpu.engine_table``.  Between slot
rebuilds all state lives in a slot-major cell table:

* state is a dict of flat ``(total_ext,)`` float32 field tensors, where rows
  ``[0, Cs*G*G)`` are the slot-major table (``Cs`` = storage capacity:
  force-visible ``cell_capacity`` plus spill rows) and the trailing
  ``n_pad`` rows are a parking strip for bots the table dropped (capacity
  overflow / padding).  Parked and spilled bots keep integrating and
  actuating but exert and feel no pair force;
* phase / radius / integrate / friction run elementwise in table space;
* the force kernel (``ops/pallas_stencil.py``) reads the first
  ``cell_capacity * G*G`` rows as ``(C, G*G)`` views;
* every K steps the slots are rebuilt by the incremental compaction
  (``ops/table_rebuild.py``), falling back to the exact argsort rebuild
  when its preconditions fail.

Op order per step matches ``engine.make_step`` and the reference
(particlebot.cpp:170-300): dead injection, centroid (pre-integrate
positions), phase, radius (one-step-lag force feedback), integrate, then
(on rebuild steps) the slot rebuild, then collide, obstacles and friction.

A Python loop over steps, with every gate decided from the host-side step
counter, fires the same gates and rebuilds on the same steps as the JAX
loop's segment scan.  Like the JAX package's jitted chunk, a chunk waits
for nothing it has just enqueued: the rebuild's incremental-or-exact
choice is made on the device (``ops/cond.cond``, the JAX package's
``lax.cond``), the rebuild counts (:data:`REBUILDS`) and the most bots the
table held in spill rows or parked (:data:`OCCUPANCY`) are device
counters, and the sim time and the centroid ring's row come from a device
step.  On the card every block (the JAX loop's gated first block,
``plain_u`` scans and remainder scan: K-step blocks, the dead-injection
step's ``lax.cond`` among their gates, and a chunk's ragged tail) replays
from a CUDA graph captured once per runner, carry layout and gate pattern,
the gated steps' draws taken beforehand and fed in with the carry; a
conditional node runs the exact rebuild only when the incremental one's
preconditions failed.  A runner's first block of a layout runs eagerly
before its capture (as every step does on the CPU), where a rebuild runs
both branches and a select keeps one.  Small tables
(``ops/megakernel.mega_eligible``) run each gate segment through the
megakernel span path: one launch of kernel 3 per rebuild block, with the
slot rebuild between spans, the whole segment one CUDA graph, and the
segment redone on the regular path from its entry when a rebuild's
preconditions fail.  That decision (the JAX loop's ``lax.cond``) is a
conditional node too, so the host reads nothing inside a chunk.  Not
carried over from the JAX loop: its TPU schedule machinery (traced conds,
deferred fallback groups, block unrolling) and the ``PBOT_*`` switches.

:func:`make_run_chunk_table_batched` runs a batch of scenes in lockstep
(the seed sweep) with the same step on ``(B, rows)`` field planes: the
gates come from the shared step counter, kernels 1 to 3 each take every
scene in one launch, the chunk entry, exit and exact rebuild are the
single-scene functions ``torch.func.vmap`` ped over the scene axis, and a
rebuild takes the incremental result for every scene only when every
scene's preconditions held, else the exact rebuild for every scene (the
JAX package's ``_smart_rebuild_batched``).  The span path redoes a whole
segment on the regular batched path when any scene's span rebuild failed.

What every engine's runner shares lives below this module: the compiled
chunk (the step schedule, block replay, the runner type
``chunk.ChunkRunner``) in ``chunk.py``, the table format
(``TABLE_FIELDS``, ``TableState``, ``table_geometry``) and the step clock
in ``state.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import vmap

from . import chunk, rng
from .chunk import NO_GATES, ChunkRunner, DeviceCounts, HostValue, drain
from .config import Control, SimParams
from .ops.forces import attraction_scale
from .ops.pallas_stencil import FIELDS as KERNEL_FIELDS
from .ops.pallas_stencil import assign_slots_slotmajor, stencil_forces
from .ops.phase import update_phase
from .ops.row_step import row_step
from .state import (
    ARRAY_FIELDS,
    MOVE_FIELDS,
    N_TF,
    TABLE_FIELDS,
    SimState,
    TableState,
    active_mask,
    payload_mask,
    step_tensor,
    table_geometry,
)
from .utils import trace

f32 = np.float32

assert TABLE_FIELDS[: len(KERNEL_FIELDS)] == KERNEL_FIELDS

# every runner of this module replays its blocks through this name, which
# the benchmark's fault tests patch (perfbench/tests/test_perfbench_run.py)
_graphed = chunk.graphed


class RebuildCounts(DeviceCounts):
    """What the loops' rebuild schedule took, for callers that check a run:
    one count per slot rebuild (a batched rebuild counts once for all its
    scenes), ``"incremental"`` for the compaction's result, ``"exact"``
    for the argsort rebuild that failed preconditions select.  The span
    path's unconditional rebuilds between spans are not counted; their
    failures show as the runner's ``redos``.  Device counts: each rebuild
    adds its decision in place to its carry's device's counter."""

    KEYS = ("incremental", "exact")
    _combine = staticmethod(sum)

    def add(self, ok: torch.Tensor) -> None:
        """Count one rebuild: incremental where the 0-dim bool ``ok``
        holds, exact where it does not."""
        self.counter(ok.device).add_(torch.stack([ok, ~ok]).to(torch.int64))


class OccupancyCounts(DeviceCounts):
    """What the table drops, for callers that check a run: the most real
    bots (``val > 0.5``) that one scene of the table runners held in spill
    rows (``"spill_max"``: ranks ``cell_capacity`` to ``storage_capacity
    - 1`` of a cell, which kernel 1 does not see) and in the parking strip
    (``"parked_max"``: bots no cell had room for).  Neither feels or
    exerts a pair force, unlike the reference's uncapped neighbour loops.
    Each is a maximum since it was last set, over every scene (a batch
    counts its worst) and every table a runner held: those its chunks
    enter and those its slot rebuilds choose (:func:`_count_occupancy`).
    Device counts, each an in-place maximum into the carry's device's
    counter; setting a key to 0 starts a new maximum."""

    KEYS = ("spill_max", "parked_max")
    _combine = staticmethod(max)

    def record(self, key: str, n: torch.Tensor) -> None:
        """Take ``key``'s maximum with ``n``, a count per scene (0-dim for
        one scene)."""
        c = self.counter(n.device)[self._index(key)]
        torch.maximum(c, n.amax() if n.dim() else n, out=c)


REBUILDS = RebuildCounts()
trace.register("rebuilds", REBUILDS)
OCCUPANCY = OccupancyCounts()
trace.register("occupancy", OCCUPANCY)


def _extend_slot(params: SimParams, slot: torch.Tensor) -> torch.Tensor:
    """Map dropped bots (slot == total) into their parking-strip rows."""
    total, _, n_pad = table_geometry(params)
    park = total + torch.arange(n_pad, dtype=torch.int32, device=slot.device)
    return torch.where(slot < total, slot, park)


def _bot_rows(params: SimParams, a: dict) -> torch.Tensor:
    """(n_pad, N_TF) per-bot field rows from a bot-order state's arrays."""
    pos = a["pos"]
    n_pad, dev = pos.shape[0], pos.device
    mask = active_mask(params, n_pad, dev)
    payload = payload_mask(params, n_pad, dev)
    return torch.stack(
        [
            pos[:, 0], pos[:, 1],
            a["vel"][:, 0], a["vel"][:, 1],
            a["rad"],
            mask.to(torch.float32),
            attraction_scale(params, payload),
            a["phase"],
            a["dead"].to(torch.float32),
            a["abs_force_a"],
            a["abs_force_r"],
            payload.to(torch.float32),
            torch.arange(n_pad, dtype=torch.float32, device=dev),
        ],
        dim=-1,
    )


def _anchored_origin(params: SimParams, pos, mask) -> torch.Tensor:
    """Grid anchor with an EDGE_MARGIN-cell offset so the blob sits away
    from the wrapped edge columns (the incremental rebuild's linear lane
    windows need those empty)."""
    from .ops.grid import cell_origin
    from .ops.table_rebuild import EDGE_MARGIN

    return cell_origin(params, pos, mask) - f32(EDGE_MARGIN * params.cutoff())


def _scatter_rows(params: SimParams, pos, mask, rows):
    """(fields, origin): re-anchor, assign slots, scatter bot rows."""
    _, total_ext, _ = table_geometry(params)
    origin = _anchored_origin(params, pos, mask)
    slot, _ = assign_slots_slotmajor(
        params, pos, mask, origin=origin, cap=params.storage_capacity()
    )
    se = _extend_slot(params, slot).long()
    flat = torch.zeros((total_ext, N_TF), dtype=torch.float32, device=pos.device)
    flat = flat.index_put((se,), rows)
    return {k: flat[:, j].contiguous() for j, k in enumerate(TABLE_FIELDS)}, origin


def _enter_arrays(params: SimParams, a: dict):
    """(fields, origin) of one scene's bot-order arrays."""
    mask = active_mask(params, a["pos"].shape[0], a["pos"].device)
    return _scatter_rows(params, a["pos"], mask, _bot_rows(params, a))


def _arrays(state: SimState) -> dict:
    return {k: getattr(state, k) for k in ARRAY_FIELDS}


def enter_table(params: SimParams, state: SimState) -> TableState:
    """Scatter a bot-order SimState into table residency (chunk entry); a
    batched state (a leading scene axis) scatters every scene, vmapped,
    each anchored on its own."""
    if state.pos.dim() == 2:
        fields, origin = _enter_arrays(params, _arrays(state))
    else:
        fields, origin = vmap(lambda a: _enter_arrays(params, a))(_arrays(state))
    # the sharded loop writes the ring in place: never the caller's
    return TableState(fields, origin, state.step, state.generator,
                      state.centroid_ring.clone())


def _slot_of_bot(params: SimParams, fields: dict) -> torch.Tensor:
    """(n_pad,) row index per bot, reconstructed from the bid plane.
    Occupied rows map their bot id to their row; everything else (parked
    bots, padding) defaults to its parking-strip row.  Written without
    data-dependent shapes, so that the batched loop can vmap it: rows that
    map no bot write a spare entry."""
    total, _, n_pad = table_geometry(params)
    dev = fields["val"].device
    occupied = fields["val"][:total] > 0.5
    bid = fields["bid"][:total].long()
    keep = occupied & (bid < n_pad)
    target = torch.where(keep, bid, torch.full_like(bid, n_pad))
    rows = torch.arange(total, dtype=torch.int64, device=dev)
    slot = total + torch.arange(n_pad + 1, dtype=torch.int64, device=dev)
    return slot.index_put((target,), rows)[:n_pad]


def _gather_rows(params: SimParams, fields: dict) -> torch.Tensor:
    """(n_pad, N_TF) bot-order rows — one wide row gather."""
    slot = _slot_of_bot(params, fields)
    flat = torch.stack([fields[k] for k in TABLE_FIELDS], dim=-1)
    return flat[slot]


def _state_of_rows(rows: torch.Tensor, ts: TableState) -> SimState:
    """The bot-order SimState of ([B,] n_pad, N_TF) rows."""
    return SimState(
        pos=rows[..., 0:2].contiguous(),
        vel=rows[..., 2:4].contiguous(),
        rad=rows[..., 4].contiguous(),
        phase=rows[..., 7].contiguous(),
        dead=rows[..., 8] > 0.5,
        abs_force_a=rows[..., 9].contiguous(),
        abs_force_r=rows[..., 10].contiguous(),
        step=ts.step,
        generator=ts.generator,
        centroid_ring=ts.centroid_ring,
    )


def exit_table(params: SimParams, ts: TableState) -> SimState:
    """Gather table residency back to a bot-order SimState (chunk exit); a
    batched carry gathers every scene, vmapped."""
    if ts.origin.dim() == 1:
        return _state_of_rows(_gather_rows(params, ts.fields), ts)
    return _state_of_rows(vmap(lambda f: _gather_rows(params, f))(ts.fields), ts)


def _rebuild_fields(params: SimParams, fields: dict):
    """Exact full rebuild: re-anchor + argsort reassignment via bot order.
    Returns (new fields, new origin).  The fallback (and semantics anchor)
    of the incremental rebuild; it also reinstates parked bots."""
    rows = _gather_rows(params, fields)
    return _scatter_rows(params, rows[:, 0:2], rows[:, 5] > 0.5, rows)


def _exact_rebuild(params: SimParams, fields: dict):
    """:func:`_rebuild_fields` of one scene's ``(total_ext,)`` fields, or of
    every scene of a batch's ``([B,] total_ext)`` fields, vmapped."""
    if fields["val"].dim() == 1:
        return _rebuild_fields(params, fields)
    return vmap(lambda f: _rebuild_fields(params, f))(fields)


def _payload_afac(params: SimParams, nval: torch.Tensor, bid: torch.Tensor):
    """(pay, afac) planes from validity + bot id — the payload attraction
    law (reference factors at particlebot_kernel_impl.cuh:568-570)."""
    nval_f = nval.to(torch.float32)
    if params.has_payload:
        is_pay = nval & (bid.to(torch.int32) == params.n_cells - 1)
        pay = is_pay.to(torch.float32)
        one = torch.ones_like(nval_f)
        afac = torch.where(is_pay, one * f32(params.attraction_factor), one) * nval_f
    else:
        pay = torch.zeros_like(nval_f)
        afac = nval_f
    return pay, afac


def _derived_rows(params: SimParams, f: dict) -> dict:
    """Recompute the bid-derived static fields after a slot relayout."""
    f["pay"], f["afac"] = _payload_afac(params, f["val"] > 0.5, f["bid"])
    return f


def _smart_rebuild(params: SimParams, ts: TableState) -> TableState:
    """:func:`_choose_rebuild`'s carry."""
    return _choose_rebuild(params, ts)[0]


def _choose_rebuild(params: SimParams, ts: TableState):
    """Incremental compaction rebuild with exact fallback: (carry, ``ok``),
    the 0-dim bool that chose the incremental result and was counted.

    Only MOVE_FIELDS travel; afac/pay are re-derived from the moved bid
    plane.  Falls back to the argsort rebuild when a precondition fails (a
    >1-cell move, a cell over capacity, or occupied edge columns).  The
    choice is made on the device, as the JAX package's ``lax.cond`` makes
    it (``ops/cond.cond``), so the host reads nothing: in a captured CUDA
    graph a conditional node runs the exact rebuild only where ``ok`` is
    False; eagerly both rebuilds run and every field plane and the origin
    take the incremental result where ``ok`` holds, else the exact one (a
    select on the 0-dim ``ok``).  A batched carry (a leading scene axis)
    is decided once for every scene (the JAX package's
    ``_smart_rebuild_batched``): one kernel-2 launch compacts every scene,
    and its result is taken for all of them only when every scene's
    preconditions held; else every scene takes the exact rebuild,
    vmapped."""
    from .ops.cond import cond
    from .ops.table_rebuild import incremental_rebuild

    moved, ok = incremental_rebuild(params, ts.fields, MOVE_FIELDS, ts.origin)
    ok = ok.all()
    REBUILDS.add(ok)
    inc = _derived_rows(params, {**ts.fields, **moved})
    inc = {**{kf: inc[kf] for kf in TABLE_FIELDS}, "origin": ts.origin}

    def take_exact(carry: dict) -> dict:
        exact, origin = _exact_rebuild(params, {kf: carry[kf] for kf in TABLE_FIELDS})
        _count_occupancy(params, exact["val"], "parked_max", taken=~ok)
        return {**exact, "origin": origin}

    out = cond(ok, lambda carry: inc, take_exact, {**ts.fields, "origin": ts.origin})
    _count_occupancy(params, out["val"], "spill_max")
    return ts.replace(fields={kf: out[kf] for kf in TABLE_FIELDS}, origin=out["origin"]), ok


def _count_occupancy(params: SimParams, val: torch.Tensor, key: str, taken=None) -> None:
    """:data:`OCCUPANCY`'s ``key`` taken with the real bots of a ``([B,]
    total_ext)`` validity plane in its spill rows (``"spill_max"``: the
    slot-major rows ``[cell_capacity * G*G, total)``) or its parking strip
    (``"parked_max"``: rows ``[total, total_ext)``), per scene; with 0
    where the 0-dim bool ``taken`` (the plane's table was chosen) does not
    hold.  Nothing where the table has no spill rows to count.

    The strip changes only where a table is entered or the exact rebuild
    is chosen: the incremental rebuild passes it through, and its
    precondition refuses a cell over capacity.  So the strip is counted
    there alone (the exact rebuild inside its conditional node on the
    card, :func:`_enter`), the spill rows also after every rebuild, and
    each maximum is the one a count after every rebuild would take."""
    total, _, _ = table_geometry(params)
    visible = params.resolved_grid_dim() ** 2 * params.cell_capacity
    if key == "spill_max" and visible == total:
        return
    rows = val[..., visible:total] if key == "spill_max" else val[..., total:]
    n = (rows > 0.5).sum(-1)
    if taken is not None:
        # a product, not a select: a graph's body holds no select on a flag
        n = n * taken
    OCCUPANCY.record(key, n)


def _enter(params: SimParams, state: SimState) -> TableState:
    """:func:`enter_table` of a table runner's chunk, its table counted in
    :data:`OCCUPANCY`."""
    ts = enter_table(params, state)
    for key in OCCUPANCY:
        _count_occupancy(params, ts.fields["val"], key)
    return ts


def _inject_dead_table(params: SimParams, f: dict, source, step: int) -> torch.Tensor:
    """Kill n_dead occupied, not-yet-dead rows (cf. engine._inject_dead):
    one score per table and parking row, of each scene on a leading scene
    axis, drawn from ``source`` for ``step``."""
    alive = (f["val"] > 0.5) & (f["dead"] < 0.5)
    scores = rng.uniform(source, step, f["dead"].shape, f["dead"].device)
    scores = torch.where(alive, scores, torch.full_like(scores, float("inf")))
    kill = torch.topk(-scores, params.n_dead, dim=-1).indices
    return f["dead"].scatter(-1, kill, 1.0)


def gate_seg(params: SimParams) -> int:
    """The gcd of the interval-gate periods in steps, or 0.

    Every interval gate (centroid, phase, one-shot dead injection) can only
    fire on a multiple of this, and the JAX loop scans such segments.  The
    port keeps it for the adaptive runner's alignment rule and the probe's
    length.  Returns 0 when it does not apply: a dead-injection step off
    the lattice, or a rebuild period that does not tile the segment."""
    k = max(1, params.resolved_slot_rebuild_steps())
    ints = [params.centroid_steps_interval]
    if params.control == Control.LIGHT_WAVE:
        ints.append(params.phase_update_steps)
    seg = math.gcd(*ints)
    if params.n_dead > 0 and params.dead_step % seg != 0:
        return 0
    if k > 8 or seg % k != 0 or seg < k:
        return 0
    return seg


def _make_mega_glue(params: SimParams):
    """(mega_pack, mega_unpack, incremental_packed) — the glue around the
    megakernel span (``ops/megakernel.py``) for one scene, or for a batch
    of scenes on a leading axis (the batched loop's fields and tables)."""
    total, _, n_pad = table_geometry(params)
    g = params.resolved_grid_dim()
    cs = params.storage_capacity()
    s_sub = n_pad // 128

    # MOVE_FIELDS are TABLE_FIELDS rows [0:6] + [7:9] + [12], so the packed
    # rebuild slices and concatenates whole plane groups
    assert TABLE_FIELDS[:6] + TABLE_FIELDS[7:9] + TABLE_FIELDS[12:13] == MOVE_FIELDS

    def mega_pack(fields: dict):
        lead = fields["px"].shape[:-1]
        tbl = torch.stack(
            [fields[kf][..., :total].reshape(lead + (cs, g * g)) for kf in TABLE_FIELDS],
            dim=-3,
        )
        strip = torch.stack(
            [fields[kf][..., total:].reshape(lead + (s_sub, 128)) for kf in TABLE_FIELDS],
            dim=-3,
        )
        return tbl, strip

    def mega_unpack(tbl, strip) -> dict:
        lead = tbl.shape[:-3]
        return {
            kf: torch.cat(
                [tbl[..., j, :, :].reshape(lead + (total,)),
                 strip[..., j, :, :].reshape(lead + (n_pad,))],
                dim=-1,
            )
            for j, kf in enumerate(TABLE_FIELDS)
        }

    def incremental_packed(tbl, origin):
        """Unconditional incremental rebuild on the stacked ([B,] N_TF, C,
        G*G) planes: MOVE_FIELDS move through the compaction (kernel 2), pay
        and afac are re-derived from the moved bid plane, aa and ar (rows
        9:11) stay unmoved (dead values between integrate and collide).
        Returns (tbl', ok), ``ok`` per scene; where it is False the planes
        are garbage that the caller discards.  The parking strip is not
        touched."""
        from .ops.table_rebuild import incremental_rebuild_planes

        planes = torch.cat(
            [tbl[..., 0:6, :, :], tbl[..., 7:9, :, :], tbl[..., 12:13, :, :]], dim=-3
        )
        new_planes, ok = incremental_rebuild_planes(
            params, planes, MOVE_FIELDS, origin
        )
        pay, afac = _payload_afac(
            params, new_planes[..., 5, :, :] > 0.5, new_planes[..., 8, :, :]
        )
        new_tbl = torch.cat(
            [
                new_planes[..., 0:6, :, :],
                afac.unsqueeze(-3),
                new_planes[..., 6:8, :, :],
                tbl[..., 9:11, :, :],
                pay.unsqueeze(-3),
                new_planes[..., 8:9, :, :],
            ],
            dim=-3,
        )
        return new_tbl, ok

    return mega_pack, mega_unpack, incremental_packed


def _make_step_glue(params: SimParams, phase_fn=None):
    """(pre, post, post_pre): the table step's parts around the rebuild.

    ``pre(ts, gates, step0, j, source=None)`` runs step ``ts.step``'s gated
    ops where its ``gates`` (dead, cog, phase: host bools) fire (dead
    injection, centroid ring, phase), then its ungated tail, the radius
    controller and integrate, at the sim time of the 0-dim int64 device
    step ``step0 + j`` (the counter is NOT bumped); ``post(ts)`` runs
    collide (kernel 1), obstacles and friction and bumps the counter;
    ``post_pre(ts, step0, j)`` is ``post`` followed by an ungated ``pre``
    at ``step0 + j``.  Each part's elementwise glue is one
    ``ops/row_step.row_step``: on CUDA tensors one launch of the row-step
    kernel (``post_pre`` is kernel 1 and one row-step launch for both
    parts), on CPU tensors its plain twin, the PyTorch ops, which the
    kernel equals bit for bit; the gated ops stay PyTorch ops.
    ``phase_fn``, ``source``: as :func:`make_table_step_parts` takes
    them; :func:`make_table_steps` runs the parts."""
    params = params.validate()
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    gg = g * g
    # the force kernel sees only the first cell_capacity rows of each cell:
    # in the slot-major layout those are the first cap * G*G flat rows;
    # spill rows above them and the parking strip get zero force
    force_total = gg * cap
    kernel_inputs = ("px", "py", "vx", "vy", "rad") + (
        ("afac",) if params.has_payload else ()
    )

    def gated(ts: TableState, gates: tuple, step0: torch.Tensor, j: int,
              source) -> TableState:
        dead_gate, cog_gate, phase_gate = gates
        f = dict(ts.fields)
        if source is None:
            source = ts.generator

        # 1. dead-cell injection (one-shot)
        if params.n_dead > 0 and dead_gate:
            f["dead"] = _inject_dead_table(params, f, source, ts.step)

        # 2. centroid ring (pre-integrate positions), written out of place
        ring = ts.centroid_ring
        if cog_gate:
            cx = torch.sum(f["px"] * f["val"], dim=-1) / f32(params.n_cells)
            cy = torch.sum(f["py"] * f["val"], dim=-1) / f32(params.n_cells)
            ring = chunk.ring_write(params, ring, step0 + j, torch.stack([cx, cy], dim=-1))

        # 3. phase controller
        if params.control == Control.LIGHT_WAVE and phase_gate:
            val = f["val"] > 0.5
            if phase_fn is not None:
                f["phase"] = phase_fn(f, val, source, ts.step)
            else:
                pos_t = torch.stack([f["px"], f["py"]], dim=-1)
                f["phase"] = update_phase(
                    params, pos_t, f["phase"], val, source, step=ts.step
                )
        return ts.replace(fields=f, centroid_ring=ring)

    def pre(ts: TableState, gates: tuple, step0: torch.Tensor, j: int,
            source=None) -> TableState:
        if any(gates):
            ts = gated(ts, gates, step0, j, source)
        # 4+5. radius controller (previous step's force magnitudes) +
        #      integrate/boundary in component form
        return ts.replace(fields=row_step(params, ts.fields, "pre", step0, j))

    def collide(f: dict):
        # 7. collide: the kernel reads (C, G*G) views of each scene's table
        tables = {
            k: f[k][..., :force_total].unflatten(-1, (cap, gg)) for k in kernel_inputs
        }
        return stencil_forces(params, tables)

    def post(ts: TableState) -> TableState:
        # 8. obstacles, friction and validity
        f = row_step(params, ts.fields, "post", forces=collide(ts.fields))
        return ts.replace(fields=f, step=ts.step + 1)

    def post_pre(ts: TableState, step0: torch.Tensor, j: int) -> TableState:
        f = row_step(params, ts.fields, "post_pre", step0, j, collide(ts.fields))
        return ts.replace(fields=f, step=ts.step + 1)

    return pre, post, post_pre


def glue_schedule(pattern: tuple, close: bool = True, entered: bool = False) -> list:
    """The parts of a block's steps in the order they run: ``(part, j)``
    with ``part`` one of ``"pre"``, ``"post_pre"``, ``"rebuild"`` and
    ``"post"``, and ``j`` the step of the block the part belongs to (for
    ``"post_pre"``, the step whose pre it runs).  ``pattern`` is a block's
    ``((gates, rebuild), ...)`` (:func:`table_pieces`).  The post of step
    ``j`` and the pre of step ``j + 1`` run as one ``"post_pre"`` where
    step ``j + 1`` fires no gate and step ``j`` does not rebuild; so an
    ungated K-step block is a pre, K - 1 post_pre, the rebuild and a post.
    With ``close=False`` the last step stops after its pre (and rebuild):
    its post is the caller's.  With ``entered=True`` the block enters
    mid-step 0, whose pre (and rebuild: ``pattern`` gives it none) ran
    already: the schedule opens with step 0's post."""
    n = len(pattern)
    out = [] if entered else [("pre", 0)]
    for j, (_, rebuild) in enumerate(pattern):
        if rebuild:
            out.append(("rebuild", j))
        if j == n - 1:
            if close:
                out.append(("post", j))
        elif not rebuild and not any(pattern[j + 1][0]):
            out.append(("post_pre", j + 1))
        else:
            out += [("post", j), ("pre", j + 1)]
    return out


def make_table_steps(params: SimParams, phase_fn=None):
    """``steps(ts, pattern, step0, source=None, close=True, entered=False,
    on_rebuild=None) -> ts``: the table step's one entry point.  A block's
    steps in turn (``pattern`` as :func:`table_pieces` gives it), step
    ``j`` at the 0-dim int64 device step ``step0 + j`` drawing from
    ``source(j)`` (``source=None``: from ``ts.generator``), in
    :func:`glue_schedule`'s order, with a step's post and the next ungated
    step's pre one row-step launch on CUDA tensors (K + 1 row-step
    launches in an ungated K-step block; :func:`_make_step_glue`).
    ``on_rebuild(ts)`` is called after each rebuild step's post;
    ``close``, ``entered``: as :func:`glue_schedule` takes them.
    :func:`make_table_step` and :func:`make_table_step_parts` are one-step
    calls of it."""
    params = params.validate()
    pre, post, post_pre = _make_step_glue(params, phase_fn)

    def steps(ts: TableState, pattern: tuple, step0: torch.Tensor, source=None,
              close: bool = True, entered: bool = False, on_rebuild=None) -> TableState:
        for part, j in glue_schedule(pattern, close, entered):
            if part == "pre":
                ts = pre(ts, pattern[j][0], step0, j, None if source is None else source(j))
            elif part == "post_pre":
                ts = post_pre(ts, step0, j)
            elif part == "rebuild":
                ts = _smart_rebuild(params, ts)
            else:
                ts = post(ts)
                if on_rebuild is not None and pattern[j][1]:
                    on_rebuild(ts)
        return ts

    return steps


def make_table_step_parts(params: SimParams, phase_fn=None):
    """(step_pre, step_post): the physics step split around the rebuild,
    each a one-step call of :func:`make_table_steps`.

    ``step_pre(ts, dead_gate, cog_gate, phase_gate, step_t=None,
    source=None)`` runs dead injection, centroid ring, phase, radius and
    integrate (the step counter is NOT bumped); ``step_post(ts)`` runs
    collide + obstacles + friction and bumps the counter.  Gates are host
    bools; ``step_t`` is the step as a 0-dim int64 device tensor, by
    default made from ``ts.step`` (a CUDA graph's block passes its own,
    which a replay refills): the sim time (``state.sim_time``) and the
    centroid ring's row come from it.  ``source`` is the draw source, by
    default ``ts.generator``; a block passes ``rng.Drawn`` of the step's
    draws taken beforehand (``chunk.draws``).  Both take a single
    scene's carry or a batched one (a leading scene axis on every field,
    the batched loop's): every op is elementwise or reduces the last axis,
    and kernel 1 takes every scene in one launch.  On CUDA tensors the
    radius controller and integrate are one row-step launch, and so is the
    glue after kernel 1.

    ``phase_fn`` (optional) replaces the phase-gate body: called as
    ``phase_fn(fields, val_mask, source, step) -> new phase plane`` inside
    the gated branch, where the JAX package's hook takes the step's key in
    place of ``(source, step)``; it draws through ``rng.normal(source,
    step, ...)``.  The packed scene-tiling sweep (``parallel/packed.py``)
    uses it to run the phase law per scene.  ``None`` runs the same ops as
    without the hook."""
    steps = make_table_steps(params, phase_fn)

    def step_pre(ts: TableState, dead_gate: bool, cog_gate: bool, phase_gate: bool,
                 step_t: torch.Tensor | None = None, source=None) -> TableState:
        if step_t is None:
            step_t = step_tensor(ts.step, ts.fields["px"].device)
        return steps(ts, (((dead_gate, cog_gate, phase_gate), False),), step_t,
                     lambda j: source, close=False)

    def step_post(ts: TableState) -> TableState:
        return steps(ts, ((NO_GATES, False),), None, entered=True)

    return step_pre, step_post


def make_table_step(params: SimParams, phase_fn=None):
    """``step(ts, dead_gate, cog_gate, phase_gate, rebuild, step_t=None,
    source=None) -> ts``: one physics step, a one-step call of
    :func:`make_table_steps`; the slot rebuild (when ``rebuild``) sits
    after integrate and before collide, so the one-step-lag force carry is
    already consumed and collide sees the freshest assignment.  A batched
    carry's rebuild is decided for all scenes at once
    (:func:`_smart_rebuild`).  ``step_t``, ``source``: as
    :func:`make_table_step_parts`' ``step_pre`` takes them."""
    steps = make_table_steps(params, phase_fn)

    def step(ts, dead_gate, cog_gate, phase_gate, rebuild, step_t=None, source=None):
        if step_t is None:
            step_t = step_tensor(ts.step, ts.fields["px"].device)
        return steps(ts, (((dead_gate, cog_gate, phase_gate), rebuild),), step_t,
                     lambda j: source)

    return step


def make_run_chunk_table(params: SimParams, phase_fn=None):
    """``run_chunk(state, n_steps, seg_aligned=False) -> state`` with
    table-resident stepping — the PALLAS backend's chunk runner.

    Rebuild schedule (the JAX loop's): chunk-relative, step j of a chunk
    rebuilds iff ``j % K == K - 1`` (chunk entry re-anchors and reassigns
    anyway); for K > 8 the absolute rule ``step % K == K - 1``.  Every
    step's interval gates are decided from the host step counter, which
    fires the same gates as the JAX loop's segment scan.

    On a mega-eligible table (``path_info["use_mega"]``) a ``seg_aligned``
    chunk (entry step a multiple of ``gate_seg``) runs each whole gate
    segment with ``seg // K > 1`` as: the gated first block minus its last
    post, ``seg // K - 1`` megakernel spans each followed by the
    unconditional incremental rebuild, and then, where every span rebuild's
    ``ok`` held, the last post; where one failed, the segment redone on
    the regular per-step path from its entry (fields, origin, centroid
    ring, and the draws of its first step, taken once before it), which
    takes the exact fallback where it is due: the JAX loop's
    ``lax.cond(okall, adopt, regular_seg)``.  ``run_chunk.redos`` counts
    the redone segments (a device count, read when asked).  The span path
    rebuilds on the same steps as the regular schedule; unaligned chunks
    and remainder steps run the regular path, so ``seg_aligned=False`` is
    the A/B of the regular schedule."""
    return _make_table_runner(params, phase_fn)


def make_run_chunk_table_batched(params: SimParams):
    """``run_chunk(state, n_steps, seg_aligned=False) -> state`` for a batch
    of scenes in lockstep: :func:`make_run_chunk_table` on a ``SimState``
    with a leading scene axis (``state.stack_states``), at the fixed K the
    params resolve (like the JAX package, no adaptive cadence).  The gates
    come from the shared step counter; each step launches kernel 1 once for
    every scene, each rebuild kernel 2 once (:func:`_smart_rebuild`: the
    incremental result for all scenes or the exact rebuild for all);
    on a mega-eligible table each span launches kernel 3 once, one cluster
    per scene, and a segment is redone on the regular batched path, from
    its entry state and every scene's draws, when any scene's span
    rebuild failed."""
    return _make_table_runner(params, None)


def table_pieces(params: SimParams, k: int, start: int, n: int) -> list:
    """The regular schedule of ``n`` steps from step ``start`` cut into
    blocks: ``[pattern]``, each pattern a tuple of ``(gates, rebuild)`` per
    step (``gates`` as ``chunk.step_gates`` gives them, the dead injection
    among them).  A block ends with each rebuild step (chunk-relative ``j
    % k == k - 1`` for ``k <= 8``, else ``step % k == k - 1``), and the
    ragged tail (the steps after the last rebuild, fewer than ``k``) is a
    block of its own length.  Every block is one that a CUDA graph replays
    on the card, captured once per pattern (the JAX loop's gated first
    block, ``plain_u`` blocks and remainder scan)."""
    pieces, cur = [], []
    for j in range(n):
        s = start + j
        rebuild = s % k == k - 1 if k > 8 else j % k == k - 1
        cur.append((chunk.step_gates(params, s), rebuild))
        if rebuild:
            pieces.append(tuple(cur))
            cur = []
    if cur:
        pieces.append(tuple(cur))
    return pieces


def _carry_of(ts: TableState) -> dict:
    return {**ts.fields, "origin": ts.origin, "centroid_ring": ts.centroid_ring}


def _with_carry(ts: TableState, out: dict, steps: int) -> TableState:
    return ts.replace(fields={kf: out[kf] for kf in TABLE_FIELDS}, origin=out["origin"],
                      centroid_ring=out["centroid_ring"], step=ts.step + steps)


def _make_piece_runner(params: SimParams, phase_fn):
    """The regular schedule's pieces (:func:`table_pieces`) of a single or
    batched table carry: ``(piece, advance)``.

    ``piece(pattern, with_pm)`` is the block function of a pattern
    (``block(carry, step0) -> carry``, as ``chunk.CapturedBlock`` takes
    it): its steps in turn, each gated step drawing from the carry's draws
    (``chunk.drawn``); with ``with_pm``, the carry's running
    maximum ``pm`` takes :func:`neighbor_rel_speed_bound` after each
    rebuild.  ``piece.host["step"]`` is the host step the next block
    starts at, for the carry's bookkeeping (the device step decides).
    ``advance(ts, n, pm=None)`` enqueues ``n`` steps piece by piece,
    yielding after each, and returns ``(ts, pm)``: it takes each piece's
    draws from the carry's source just before the piece, in step order
    (the draw source's call order stays the eager one), then replays the
    piece's graph on the card (``_graphed``, keyed by device, layout and
    pattern; the first piece of a layout runs eagerly before its capture)
    or runs it eagerly off the card."""
    steps = make_table_steps(params, phase_fn)
    k = max(1, params.resolved_slot_rebuild_steps())
    graphs: dict = {}
    fns: dict = {}
    # the host step of the block being run or captured: bookkeeping only
    # (a replay reads its step from the device)
    host = {"step": 0}

    def piece(pattern: tuple, with_pm: bool):
        if (pattern, with_pm) in fns:
            return fns[pattern, with_pm]

        def block(carry: dict, step0: torch.Tensor) -> dict:
            ts = TableState({kf: carry[kf] for kf in TABLE_FIELDS}, carry["origin"],
                            host["step"], None, carry["centroid_ring"])
            pm = [carry.get("pm")]

            def probe(ts: TableState) -> None:
                pm[0] = torch.maximum(pm[0], neighbor_rel_speed_bound(params, ts.fields))

            ts = steps(ts, pattern, step0, lambda j: chunk.drawn(carry, j),
                       on_rebuild=probe if with_pm else None)
            out = _carry_of(ts)
            if with_pm:
                out["pm"] = pm[0]
            return out

        block.steps = len(pattern)
        fns[pattern, with_pm] = block
        return block

    def advance(ts: TableState, n: int, pm=None):
        dev = ts.origin.device
        for pattern in table_pieces(params, k, ts.step, n):
            carry = _carry_of(ts)
            if pm is not None:
                carry["pm"] = pm
            with trace.work(dev):
                for j, (gates, _) in enumerate(pattern):
                    for name, v in chunk.draws(params, ts.generator, ts.step + j, gates,
                                               ts.fields["dead"].shape, dev).items():
                        carry[f"{name}{j}"] = v
            block = piece(pattern, pm is not None)
            host["step"] = ts.step
            key = ("piece", dev, tuple(ts.origin.shape), pattern, pm is not None)
            out = _graphed(graphs, key, block, carry, ts.step)
            ts, pm = _with_carry(ts, out, len(pattern)), out.get("pm")
            yield
        return ts, pm

    piece.host = host
    return piece, advance


class _TableRunner(ChunkRunner):
    """The table loop's :class:`~.chunk.ChunkRunner`, which alone keeps a
    device count: ``redos``, how many span segments it redid (read when
    asked); ``segments(n_steps, seg_aligned)`` is how many gate segments
    of such a chunk take the span path, and a chunk's span path is
    ``span`` where any does, else ``batched`` or ``table``."""

    def __init__(self, blocks, path_info: dict, segments):
        super().__init__(blocks, "table", path_info, k=path_info["slot_rebuild_steps"])
        self.segments = segments
        self._redo_counts: dict = {}  # device -> 0-dim int64

    def span_path(self, state: SimState, n_steps: int, seg_aligned: bool) -> str:
        if self.segments(n_steps, seg_aligned):
            return "span"
        return "batched" if state.pos.dim() == 3 else "table"

    def redo_counter(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._redo_counts:
            self._redo_counts[device] = torch.zeros((), dtype=torch.int64, device=device)
        return self._redo_counts[device]

    @property
    def redos(self) -> int:
        return sum(int(c) for c in self._redo_counts.values())


def _make_table_runner(params: SimParams, phase_fn):
    """The chunk runner of a single-scene or a batched state: every piece
    dispatches on the rank of what it is given.

    ``run_chunk.blocks(state, n_steps, seg_aligned=False)`` is the chunk
    as a block iterator: it enqueues the chunk a piece at a time (a K-step
    block, gated or not, the dead-injection step among its gates, the
    ragged tail, a span segment), yields after each, and returns the final
    state; ``run_chunk`` drains it and the multi-place loops
    ``chunk.interleave`` several.  Each block (:func:`table_pieces`: the JAX
    package's gated first block, ``plain_u`` scans and remainder scan) on
    a CUDA carry runs from a CUDA graph (``chunk.CapturedBlock``, through
    ``_graphed``), captured once per carry layout and gate pattern and
    replayed after that, with the gated steps' draws (the dead step's
    scores too) taken just before and copied into the carry; so does each
    span segment, the one holding the dead step included, once per layout
    and first-step gates.  A failed capture raises.  On the CPU every
    piece runs eagerly, through the same code.  On the card what runs
    eagerly is the chunk's entry and exit and a runner's first block (and
    first span segment) of a layout, the warm-up before its capture.  A
    runner advances one chunk at a time (its graphs hold that chunk's
    carry).

    A span segment is one graph: the gated first block minus its last
    post, the spans with their rebuilds and the AND of their ``ok``, and
    then ``ops/cond.branch`` on it: an IF node with an else branch whose
    bodies are the closing post (adopt) and the regular segment from the
    segment's entry with the same draws (redo: the gated first block, then
    the ungated blocks under a WHILE node, ``ops/cond.repeat``, one block
    captured once; its rebuilds are nodes nested in the bodies), which
    also adds one to the runner's device redo counter.  So the card
    decides, and the host reads nothing; a redo replays the gated first
    block with the draws the segment was given, so it kills the same bots.
    Eagerly (the CPU, a runner's first segment on a layout, before its
    capture) the branch reads the flag and runs one body: the
    one-read-per-segment path."""
    params = params.validate()
    steps = make_table_steps(params, phase_fn)
    k = max(1, params.resolved_slot_rebuild_steps())
    seg = gate_seg(params)

    from .ops.cond import branch, repeat
    from .ops.megakernel import make_mega_span, mega_eligible

    use_mega = mega_eligible(params)
    bps = seg // k if seg > 0 else 0
    if use_mega:
        mega = make_mega_span(params, table_geometry(params)[2])
        mega_pack, mega_unpack, incremental_packed = _make_mega_glue(params)
    piece, advance = _make_piece_runner(params, phase_fn)
    graphs: dict = {}
    seg_fns: dict = {}
    outputs = (*TABLE_FIELDS, "origin", "centroid_ring")

    def span_segment(first_gates: tuple):
        """The block function of a span segment whose first step fires
        ``first_gates`` (see :func:`_make_table_runner`)."""
        if first_gates in seg_fns:
            return seg_fns[first_gates]
        gates_at = [first_gates] + [NO_GATES] * (seg - 1)
        first_block = piece(tuple((gates_at[j], j == k - 1) for j in range(k)), False)
        plain_block = piece(tuple((NO_GATES, j == k - 1) for j in range(k)), False)

        def block(carry: dict, step0: torch.Tensor) -> dict:
            src, s0 = chunk.drawn(carry, 0), piece.host["step"]
            ts = TableState({kf: carry[kf] for kf in TABLE_FIELDS}, carry["origin"], s0, None,
                            carry["centroid_ring"])
            ts = steps(ts, tuple((gates_at[j], False) for j in range(k)), step0,
                       lambda j: src, close=False)
            ts, _ = _choose_rebuild(params, ts)
            tbl, strip = mega_pack(ts.fields)
            first = step0 + k
            ok_all = None
            for b in range(bps - 1):
                tbl, strip = mega(tbl, strip, first + b * k)
                tbl, ok = incremental_packed(tbl, ts.origin)
                ok_all = ok.all() if ok_all is None else ok_all & ok.all()
            mid = ts

            def adopt(_):
                # the last span ended mid-step step0 + seg - 1, after pre +
                # rebuild: its post completes the segment
                end = steps(mid.replace(fields=mega_unpack(tbl, strip)), ((NO_GATES, False),),
                            None, entered=True)
                return _carry_of(end)

            def redo(entry: dict) -> dict:
                # the JAX loop's regular_seg: the gated first block, then
                # the ungated blocks as one loop (a WHILE node in a graph)
                runner.redo_counter(step0.device).add_(1)
                out = first_block(entry, step0)
                return repeat(bps - 1, plain_block, {n: out[n] for n in outputs},
                              step0 + k, k)

            return branch(ok_all, adopt, redo, carry, outputs)

        block.steps = seg
        seg_fns[first_gates] = block
        return block

    def span_segments(ts: TableState, n_segs: int):
        """``n_segs`` gate segments through the span path, one piece each
        (keyed by its first step's gates); yields after each, returns
        ``ts``."""
        dev = ts.origin.device
        for _ in range(n_segs):
            gates = chunk.step_gates(params, ts.step)
            carry = _carry_of(ts)
            with trace.work(dev):
                for name, v in chunk.draws(params, ts.generator, ts.step, gates,
                                           ts.fields["dead"].shape, dev).items():
                    carry[f"{name}0"] = v
            runner.redo_counter(dev)
            block = span_segment(gates)
            piece.host["step"] = ts.step
            key = ("segment", dev, tuple(ts.origin.shape), gates)
            out = _graphed(graphs, key, block, carry, ts.step)
            ts = _with_carry(ts, out, seg)
            yield
        return ts

    def segments(n_steps: int, seg_aligned: bool) -> int:
        return n_steps // seg if use_mega and seg_aligned and bps > 1 else 0

    def blocks(state: SimState, n_steps: int, seg_aligned: bool = False):
        with trace.work(state.device):
            ts = _enter(params, state)
        n_segs = segments(n_steps, seg_aligned)
        if n_segs:
            ts = yield from span_segments(ts, n_segs)
        ts, _ = yield from advance(ts, n_steps - n_segs * seg)
        with trace.work(state.device):
            return _exit(params, ts)

    runner = _TableRunner(blocks, {"use_mega": use_mega, "gate_seg": seg,
                                   "slot_rebuild_steps": k}, segments)
    return runner


def _exit(params: SimParams, ts: TableState) -> SimState:
    """:func:`exit_table` with the centroid ring off the carry's buffers
    (a graph's, which the runner's next chunk overwrites)."""
    return exit_table(params, ts.replace(centroid_ring=ts.centroid_ring.clone()))


# Missed-magnet-force budget for the speed-certified cadence: an uncovered
# closing pair may enter the magnet tail before the next rebuild; the
# certificate bounds the largest force such a pair could have been owed to
# this fraction of the plateau MAGNET_MIN_ATTR (2.5).
MISSED_MAGNET_FRACTION = 0.01


def certified_closing_bound(params: SimParams, k: int) -> float:
    """Max pair-closing speed (u/s) under which a ``k``-step slot-reuse
    window is safe, derived from the table geometry: a pair not covered by
    the 3x3 stale window has ``dist > h = cutoff()`` at assignment and
    closes at most ``c * (k-1) * dt`` within the window, so it can neither
    reach touching distance (``2 * max radius``) nor get owed more than
    ``MISSED_MAGNET_FRACTION`` of the plateau magnet force.  With reference
    defaults: bound(8) = 3.4 u/s, bound(4) = 7.9 u/s."""
    from .ops.forces import MAGNET_MIN_ATTR

    h = params.cutoff()
    r_max = params.max_radius
    if params.has_payload:
        r_max = max(r_max, params.min_radius * params.rad_factor)
    touch = params.max_radius + r_max
    attr = params.attraction
    if params.has_payload and params.attraction_factor > 1.0:
        attr = attr * params.attraction_factor ** 2
    tail = (attr / (MISSED_MAGNET_FRACTION * MAGNET_MIN_ATTR)) ** 0.5
    slack = h - touch - tail
    window = max(1, k - 1) * params.timestep
    return max(0.0, slack / window)


def neighbor_rel_speed_bound(params: SimParams, fields: dict) -> torch.Tensor:
    """0-dim float32 upper bound on the max pair-closing speed among bots in
    each other's 3x3 cell neighbourhood: per-cell [min, max] velocity
    envelopes over occupied rows (spill rows included), widened to the 3x3
    window with flat lane rolls, then the max over cells of
    ``hypot(dvx, dvy)``.  Parked bots are excluded."""
    from .ops.grid import OFFSETS9
    from .ops.pallas_stencil import _preshift_flat

    g = params.resolved_grid_dim()
    gg = g * g
    total = gg * params.storage_capacity()
    val = fields["val"][:total].reshape(-1, gg) > 0.5
    dvs = []
    for comp in ("vx", "vy"):
        v = fields[comp][:total].reshape(-1, gg)
        big = torch.full_like(v, f32(1.0e9))
        cmax = torch.max(torch.where(val, v, -big), dim=0).values[None]
        cmin = torch.min(torch.where(val, v, big), dim=0).values[None]
        wmax, wmin = cmax, cmin
        for dx, dy in OFFSETS9[1:]:
            wmax = torch.maximum(wmax, _preshift_flat(cmax, g, dx, dy))
            wmin = torch.minimum(wmin, _preshift_flat(cmin, g, dx, dy))
        # windows with < 2 bots leave +-big sentinels -> clamp at 0
        dvs.append(torch.clamp(wmax - wmin, min=0.0))
    return torch.max(torch.sqrt(dvs[0] * dvs[0] + dvs[1] * dvs[1]))


def make_probe_chunk(params: SimParams, phase_fn=None):
    """``probe_chunk(state) -> (state_after_seg, probe_max)``: advance one
    gate segment (``gate_seg(params)`` steps, the chunk runner's schedule)
    while taking the max of :func:`neighbor_rel_speed_bound` at entry and
    right after every slot rebuild.  ``probe_max`` stays on the device.
    Callers enter on a segment boundary.  The segment runs as the table
    loop's pieces (its gated first block, the dead step among its gates,
    then ungated K-step blocks, each from a CUDA graph on the card), the
    running maximum a carry entry that each block updates after its
    rebuild."""
    params = params.validate()
    k = max(1, params.resolved_slot_rebuild_steps())
    seg = gate_seg(params)
    if seg <= 0 or seg % k:
        raise ValueError(
            "probe chunk requires the gate-segment schedule (gate_seg > 0 "
            f"and k | seg; got seg={seg}, k={k})"
        )
    _, advance = _make_piece_runner(params, phase_fn)

    def probe_chunk(state: SimState):
        with trace.work(state.device):
            ts = _enter(params, state)
            pm = neighbor_rel_speed_bound(params, ts.fields)
        ts, pm = drain(advance(ts, seg, pm))
        with trace.work(state.device):
            return _exit(params, ts), pm

    return probe_chunk


def make_adaptive_run_chunk(params: SimParams, phase_fn=None):
    """Speed-certified adaptive rebuild cadence — the ``slot_rebuild_steps
    = -1`` auto mode on large tables (``SimParams.adaptive_rebuild``).

    Every seg-aligned chunk opens with one probe segment at the CURRENT
    cadence; the cadence for the NEXT chunk is K=8 iff the measured bound
    stays within :func:`certified_closing_bound` for K=8, else K=4.  The
    probe value is copied to the host as soon as the probe is enqueued and
    read at the next chunk boundary (waiting for that copy alone,
    ``runner.pending``), so detection latency is one chunk and the chunk
    reads nothing.  Chunks that cannot take the segment schedule
    (unaligned entry, short or ragged chunks) run the base K=4 path.
    ``runner.blocks`` is the chunk as a block iterator (the table
    runner's); ``runner.live["k"]`` / ``runner.last_probe`` expose the
    live cadence and the last bound read, ``runner.k`` the cadence the
    last chunk ran at.  A call is a ``chunk`` span where tracing is on,
    the probe segment a ``chunk.probe`` span inside it."""
    base = params.validate()
    p4 = base.replace(slot_rebuild_steps=4)
    p8 = base.replace(slot_rebuild_steps=8)
    seg = gate_seg(p4)
    bound8 = certified_closing_bound(base, 8)
    seg_ok = seg > 0 and gate_seg(p8) == seg and bound8 > 0.0
    runners: dict = {}
    probes: dict = {}

    def get_runner(k):
        if k not in runners:
            runners[k] = make_run_chunk_table(p4 if k == 4 else p8, phase_fn)
        return runners[k]

    get_runner(4)  # the base cadence's runner, built eagerly

    def get_probe(k):
        if k not in probes:
            probes[k] = make_probe_chunk(p4 if k == 4 else p8, phase_fn)
        return probes[k]

    def blocks(state: SimState, n_steps: int, seg_aligned: bool = False):
        if not seg_ok or not seg_aligned or n_steps < seg or n_steps % seg:
            runner.k = 4
            return (yield from get_runner(4).blocks(state, n_steps, seg_aligned))
        if runner.pending is not None:
            # the previous chunk's probe, computed long ago on the device
            pm = runner.pending.read()
            runner.last_probe = pm
            runner.live["k"] = 8 if pm <= bound8 else 4
        runner.k = runner.live["k"]
        probe = get_probe(runner.k)
        if trace.ON:
            with trace.span("chunk.probe", k=runner.k):
                state, pm = probe(state)
        else:
            state, pm = probe(state)
        with trace.work(state.device):
            runner.pending = HostValue(pm)
        yield
        rest = n_steps - seg
        if rest:
            state = yield from get_runner(runner.k).blocks(state, rest, True)
        return state

    runner = ChunkRunner(blocks, "adaptive", {"adaptive": True, "gate_seg": seg,
                                              "bound8": bound8}, k=4)
    runner.live = {"k": 4}
    runner.last_probe = None
    runner.pending = None
    return runner
