"""Single-scene spatial decomposition of the table-resident loop.

Port of ``particlerobotsimulations_tpu.parallel.spatial_table``.  The
slot-major cell table's grid ROWS are split over a ring of D shards
(``ring.py``): shard d owns the contiguous lane block ``[d*L0, (d+1)*L0)``
(``L0 = G*G/D``, whole grid rows) of every ``(Cs, G*G)`` plane, and all
per-step work is local except:

* **forces** — each shard receives its ring neighbours' boundary grid rows
  and runs the non-Newton 9-block force pass (kernel 4,
  ``ops/pallas_stencil.stencil_forces_ext``) on the halo-extended table:
  with no reactions, nothing travels back across a boundary;
* **slot rebuilds** — the incremental compaction (kernel 2's padded form,
  ``ops/table_rebuild.compact_padded``) sees the neighbour halos, so a row
  that drifts across a shard boundary is dropped by its owner and placed by
  the neighbour in the same pass.  A scene's preconditions are ANDed over
  the ring (a ring-wide min that stays on the device) and any failure takes
  the exact global rebuild (all-gather, argsort) of that scene on every
  shard — the single-table loop's fallback contract.  The choice is made
  on the device, as the JAX package's ``lax.cond`` makes it inside its
  compiled chunk (``ops/cond.cond``): in a captured CUDA graph a
  conditional node runs the all-gather, the exact rebuild and the split
  only on a fallback; eagerly both rebuilds run and a select keeps one;
* **reductions** — a ring-wide min for the phase law's light distance, a
  ring-wide sum for the centroid, an all-gathered ``topk`` for dead-cell
  injection.

The parking strip (capacity-overflow bots) is replicated: every shard
holds and integrates the same strip rows, which feel no pair force, and
the reductions count the strip once, outside the ring sum.

Layout: each field is ``(S, Cs*L0 + n_pad)`` for the S shards this process
holds (S = D on a :class:`~.ring.LocalRing`, 1 on a
:class:`~.ring.DistRing`): the shard's slot-major center rows, then the
strip.  The halo is ``HALO_ROWS`` grid rows per side — 3 zero rows and the
neighbour's boundary row — as in the JAX package, so both packages build
byte-identical extended tables; it also covers the compaction's G+1-lane
reach.  A batch of B scenes in lockstep (dp x tp,
:func:`make_sharded_table_run_batched`) is laid out shard-major, ``(S, B,
Cs*L0 + n_pad)``: the ring shifts and reduces on the leading axis as for
one scene, kernels 4 and 2 take all S x B blocks in one launch each, and a
rebuild decides each scene on its own (:func:`_all_ok`: one flag per scene,
the JAX package's vmapped ``lax.cond``, a select per scene), so a scene's
run does not depend on the batch it runs in.

Like the JAX package's jitted chunk, a chunk reads nothing from the
device between its entry and its exit: the rebuild decision stays on the
device, the sim time and the centroid ring's row come from a device step
(``state.sim_time``), and the ``with_stats`` counters are device
counters read once, at the exit.  The gates stay host decisions on the
host step.  The runner is a ``chunk.ChunkRunner`` and its chunk a block
iterator (``run_chunk.blocks``, the table loop's shape, cut by
``engine_table.table_pieces``): each block (K steps ending with their
rebuild, or the ragged tail; its gated steps' draws, the dead step's
scores included, taken just before it and fed in with the carry) on a
:class:`~.ring.LocalRing` on the card replays from a CUDA graph, captured
once per carry layout and gate pattern (``chunk.graphed``: the runner's
first block of a layout runs eagerly before its capture).  The chunk's
entry and exit run eagerly, and so does every block on the CPU, through
the same code.  A :class:`~.ring.DistRing` runs every block eagerly, not
through ``chunk.graphed`` (so its steps count in no ``chunk.EAGER`` key):
NCCL enqueues its collectives on the stream, so nothing is read there
either, but capturing them into a graph can only be tested with a card
per rank.

Random draws: phase noise and dead-injection scores are drawn for the
whole ``(total_ext,)`` table layout from the run's draw source (``rng``),
as the single-table loop draws them, and each shard takes its own rows: centre
draws differ per shard, strip draws are the same on every shard, every
rank of a :class:`~.ring.DistRing` draws the same numbers, and a sharded
run draws what the single-table run draws.  (The JAX sharded loop draws
per-shard streams instead, so it matches its single-chip loop only in
distribution; per-bot comparisons with it run at ``phase_std=0,
n_dead=0``.)
"""

from __future__ import annotations

import numpy as np
import torch

from .. import chunk, rng
from ..chunk import NO_GATES, ChunkRunner, interleaved
from ..config import SimParams
from ..engine_table import (
    _derived_rows,
    _exact_rebuild,
    enter_table,
    exit_table,
    table_pieces,
)
from ..ops.cond import cond
from ..ops.forces import friction_velocity_update_xy, obstacle_forces_xy
from ..ops.integrate import radius_integrate_planes
from ..ops.pallas_stencil import FIELDS as KERNEL_FIELDS
from ..ops.pallas_stencil import stencil_forces_ext
from ..ops.phase import light_distance, update_phase
from ..ops.table_rebuild import compact_padded, rebuild_move_planes
from ..state import (
    MOVE_FIELDS,
    TABLE_FIELDS,
    SimState,
    sim_time,
    step_tensor,
    table_geometry,
)
from .ring import LocalRing

f32 = np.float32

# halo grid rows per side: only the innermost row carries neighbour data;
# the rest are zero pad, kept so that both packages lay the extended
# tables out alike
HALO_ROWS = 4
# shards of the default ring
DEFAULT_SHARDS = 4


def resolve_tp_params(params: SimParams, n_shards: int) -> SimParams:
    """Round the grid up until the shard geometry is tile-aligned (the JAX
    package's rule, so both pick the same G)."""
    params = params.validate()
    g = params.resolved_grid_dim()
    while g % 32 or g % n_shards or (g * g // n_shards) % 128:
        g += 16
    return params.replace(grid_dim=g)


def _all_ok(ring, ok_local: torch.Tensor) -> torch.Tensor:
    """The rebuild decision on the ring's device: whether every shard's
    incremental-compaction preconditions held, the ring-wide min (the JAX
    package's ``pmin``), which stays on the device.  ``ok_local`` holds
    one flag per shard this process holds, ``(S,)``, or per shard and
    scene of a batch, ``(S, B)``: the decision is a 0-dim bool for one
    scene and one per scene, ``(B,)``, for a batch (the JAX package's dp x
    tp loop vmaps the scene's chunk, so each scene decides alone)."""
    return ring.pmin(ok_local.to(torch.int32)) > 0


def make_sharded_table_run(params: SimParams, ring=None, with_stats: bool = False,
                           device="cuda"):
    """(run_chunk, resolved_params): the table-resident loop sharded over
    ``ring`` (default ``LocalRing(DEFAULT_SHARDS, device)``).
    ``run_chunk(state, n_steps)`` takes and returns a bot-order SimState on
    the ring's device (the same state on every rank of a DistRing); the
    sharded table lives only inside.  A batched state (a leading scene
    axis: the dp x tp loop, :func:`make_sharded_table_run_batched`) runs
    its scenes in lockstep on the shard-major layout.

    ``with_stats=True`` makes ``run_chunk`` return ``(state, stats)``:
    ``fallbacks``, how many rebuilds took the exact global fallback (of a
    batch, the scenes' rebuilds that did, summed over the scenes), and
    ``spill_rows_max``, the largest number of occupied overflow-spill rows
    over all shards (and scenes) at the end of a step (0 without spill
    rows).  Both are counted on the device and read once, at the chunk's
    exit.

    ``run_chunk`` is a ``chunk.ChunkRunner`` (a call is a ``chunk``
    span, path ``sharded``, where tracing is on).
    ``run_chunk.blocks(state, n_steps)`` is the chunk as a block iterator
    (see the module docstring): ``run_chunk`` drains it, and the dp x tp
    mesh entry interleaves several (``chunk.interleaved``).  It returns
    what ``run_chunk`` returns, with the stats' counters still on the
    device; ``run_chunk.read_stats`` reads them.  A runner advances one
    chunk at a time (its graphs hold that chunk's carry)."""
    ring = ring if ring is not None else LocalRing(DEFAULT_SHARDS, device)
    D = ring.n_shards
    params = resolve_tp_params(params, D)
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    cs = params.storage_capacity()
    L0 = g * g // D                  # lanes (cells) per shard
    H = HALO_ROWS * g                # halo lanes per side
    C = cs * L0                      # local table rows (flat)
    total, _, n_pad = table_geometry(params)
    nf = len(MOVE_FIELDS)
    k_rb = max(1, params.resolved_slot_rebuild_steps())
    dt = params.timestep
    ids = ring.shard_ids()
    S = ids.numel()
    no_noise = params.replace(phase_std=0.0)

    def local(v):
        """A whole table's ([B,] total_ext) tensor -> this process's (S,
        [B,] C + n_pad) rows: its shards' lane blocks of the table, then
        the strip."""
        lead = v.shape[:-1]
        center = v[..., :total].view(lead + (cs, D, L0))[..., ids, :].movedim(-2, 0)
        strip = v[..., total:].expand((S,) + lead + (n_pad,))
        return torch.cat([center.reshape((S,) + lead + (C,)), strip], dim=-1)

    def halo_exchange(x):
        """(S, ..., L0) -> (S, ..., L0 + 2H): the ring neighbours' boundary
        grid rows between zero rows (shard 0's previous row is shard D-1's
        last: the table's wrap rides the ring)."""
        prev = ring.from_prev(x[..., -g:])
        nxt = ring.from_next(x[..., :g])
        z = torch.zeros(x.shape[:-1] + ((HALO_ROWS - 1) * g,), dtype=x.dtype,
                        device=x.device)
        return torch.cat([z, prev, x, nxt, z], dim=-1)

    def split_local(fields):
        return {k: local(fields[k]) for k in TABLE_FIELDS}

    def join_global(f):
        """All-gather the shard centers -> whole-table ([B,] total_ext)
        fields."""
        c = torch.stack([f[k][..., :C] for k in TABLE_FIELDS], dim=-2)
        lead = c.shape[1:-2]
        glob = ring.all_gather(c).view((D,) + lead + (len(TABLE_FIELDS), cs, L0))
        glob = glob.movedim(0, -2).reshape(lead + (len(TABLE_FIELDS), total))
        return {
            k: torch.cat([glob[..., j, :], f[k][0, ..., C:]], dim=-1)
            for j, k in enumerate(TABLE_FIELDS)
        }

    def incremental(f, origin):
        """(fields, ok): the incremental compaction with neighbour halos,
        and whether every shard's preconditions held (:func:`_all_ok`: one
        flag, or one per scene of a batch)."""
        lead = f["val"].shape[1:-1]
        planes = torch.stack([f[k][..., :C] for k in MOVE_FIELDS], dim=-2)
        planes = planes.view((S,) + lead + (nf, cs, L0))
        # one origin per scene, broadcast over its shards, slots and lanes
        org = origin.movedim(-1, 0).reshape((2,) + lead + (1, 1))
        offset = (ids * L0).to(torch.int32).view((S,) + (1,) * len(lead) + (1, 1))
        dxf, dyf, moved_far, edge = rebuild_move_planes(
            params, planes.movedim(-3, 0), MOVE_FIELDS, org, lane_offset=offset
        )
        padded = halo_exchange(torch.cat([planes, dxf[..., None, :, :], dyf[..., None, :, :]], dim=-3))
        new_planes, incoming = compact_padded(params, padded, H, L0)
        inc = dict(f)
        for j, k in enumerate(MOVE_FIELDS):
            inc[k] = torch.cat(
                [new_planes[..., j, :, :].reshape((S,) + lead + (C,)), f[k][..., C:]], dim=-1
            )
        # one flag per shard (and scene) this process holds
        return _derived_rows(params, inc), _all_ok(
            ring, ~(moved_far | torch.any(incoming > cs, dim=-1) | edge))

    def sharded_rebuild(f, origin):
        """(f, origin, ok): the incremental compaction where ``ok``, else
        the exact global rebuild (the all-gather, the argsort rebuild and
        the split), chosen on the device by ``ops/cond.cond``: in a
        captured CUDA graph a conditional node runs the exact branch only
        where ``ok`` is False; eagerly both run and a select on ``ok``
        keeps one (the JAX package's ``lax.cond`` of ``take_inc`` and
        ``take_exact``).  A batch's ``ok`` is per scene (the JAX package's
        vmapped ``lax.cond``): the node fires when any scene's flag is
        False, and its body rebuilds every scene exactly and keeps that
        result only for the scenes whose flag is False."""
        inc, ok = incremental(f, origin)
        inc = {**{k: inc[k] for k in TABLE_FIELDS}, "origin": origin}

        def take_exact(carry):
            gf, exact_origin = _exact_rebuild(params, join_global(carry))
            exact = {**split_local(gf), "origin": exact_origin}
            if ok.dim() == 0:
                return exact
            # (B, 1) broadcasts over (S, B, rows) planes and (B, 2) origins
            keep = ok[:, None]
            return {k: torch.where(keep, inc[k], v) for k, v in exact.items()}

        out = cond(ok.all(), lambda carry: inc, take_exact, {**f, "origin": origin})
        return {k: out[k] for k in TABLE_FIELDS}, out["origin"], ok

    def step_local(f, origin, ring_t, step_t, rebuild, gates=NO_GATES, source=None):
        """One physics step on the shard-local fields, in the single-table
        loop's op order: (f, origin, centroid ring, the rebuild's ``ok``
        or None).  ``step_t`` is the step, a 0-dim int64 device tensor
        (the sim time and the ring's row come from it); ``gates`` the
        step's (dead, cog, phase) host decisions; ``source`` (a gated
        step's) returns its draws in the single-table layout
        (``rng.Drawn``), which each shard cuts to its own rows."""
        dead_g, cog_g, phase_g = gates
        dev = f["val"].device
        lead = f["val"].shape[1:-1]
        val = f["val"] > 0.5
        time = sim_time(step_t, dt)

        # 1. dead injection: a topk over the all-gathered centre scores and
        #    the strip's
        if dead_g:
            alive = val & (f["dead"] < 0.5)
            scores = local(rng.uniform(source, None, lead + (total + n_pad,), dev))
            scores = torch.where(alive, scores, torch.full_like(scores, float("inf")))
            centres = ring.all_gather(scores[..., :C]).movedim(0, -2).flatten(-2)
            gall = torch.cat([centres, scores[0, ..., C:]], dim=-1)
            kill = torch.topk(-gall, params.n_dead, dim=-1).indices
            killed = torch.zeros(gall.shape, dtype=torch.bool, device=dev).scatter(-1, kill, True)
            mine = torch.cat([
                killed[..., : D * C].unflatten(-1, (D, C))[..., ids, :].movedim(-2, 0),
                killed[..., D * C:].expand((S,) + lead + (n_pad,)),
            ], dim=-1)
            f["dead"] = torch.where(mine, torch.ones_like(f["dead"]), f["dead"])

        # 2. centroid ring (pre-integrate positions): the ring-wide sum of
        #    the centres plus the replicated strip once
        if cog_g:
            cxy = [
                ring.psum(torch.sum(f[k][..., :C] * f["val"][..., :C], dim=-1))
                + torch.sum(f[k][0, ..., C:] * f["val"][0, ..., C:], dim=-1)
                for k in ("px", "py")
            ]
            ring_t = chunk.ring_write(params, ring_t, step_t,
                                      torch.stack(cxy, dim=-1) / f32(params.n_cells))

        # 3. phase law: the ring-wide min light distance of the centres and
        #    the strip's own min
        if phase_g:
            pos = torch.stack([f["px"], f["py"]], dim=-1)
            dist = light_distance(params, pos)
            inf = torch.full_like(dist, float("inf"))
            dmin = torch.minimum(
                ring.pmin(torch.where(val[..., :C], dist[..., :C], inf[..., :C]).amin(dim=-1)),
                torch.where(val[0, ..., C:], dist[0, ..., C:], inf[0, ..., C:]).amin(dim=-1),
            )
            phase = update_phase(no_noise, pos, f["phase"], val, None, min_d=dmin[..., None])
            if params.phase_std:
                noise = local(rng.normal(source, None, lead + (total + n_pad,), dev))
                phase = torch.where(val, phase + f32(params.phase_std) * noise, phase)
            f["phase"] = phase

        # 4+5. radius controller + integrate/boundary, elementwise
        f = radius_integrate_planes(params, f, time)

        # 6. slot rebuild (between integrate and collide)
        ok = None
        if rebuild:
            f, origin, ok = sharded_rebuild(f, origin)

        # 7. collide: halo exchange + the non-Newton extended force pass on
        #    the force-visible slots (kernel 4: one launch for every shard
        #    and scene)
        stk = torch.stack(
            [f[k][..., :C].unflatten(-1, (cs, L0))[..., :cap, :] for k in KERNEL_FIELDS],
            dim=-3,
        )
        ext = halo_exchange(stk)
        tables_ext = {k: ext[..., j, :, :] for j, k in enumerate(KERNEL_FIELDS)}
        fx, fy, fa, fr = stencil_forces_ext(params, tables_ext, H, L0)

        def expand(a):
            """(S, [B,] cap, L0) -> (S, [B,] C + n_pad): spill rows and the
            strip feel no pair force."""
            full = torch.cat([a, a.new_zeros(a.shape[:-2] + (cs - cap, L0))], dim=-2)
            return torch.cat(
                [full.flatten(-2), a.new_zeros(a.shape[:-2] + (n_pad,))], dim=-1
            )

        fxf, fyf = expand(fx), expand(fy)
        f["aa"], f["ar"] = expand(fa), expand(fr)
        if params.circle_obstacles or params.rect_obstacles:
            ofx, ofy, om = obstacle_forces_xy(
                params, f["px"], f["py"], f["vx"], f["vy"], f["rad"]
            )
            fxf, fyf = fxf + ofx, fyf + ofy
            f["ar"] = f["ar"] + om

        nvx, nvy = friction_velocity_update_xy(
            params, f["vx"], f["vy"], fxf, fyf, f["pay"] > 0.5, dt
        )
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        val_r = f["val"] > 0.5
        f["vx"] = torch.where(val_r, nvx, zero)
        f["vy"] = torch.where(val_r, nvy, zero)
        return f, origin, ring_t, ok

    def carry_step(carry, step_t, rebuild, gates=NO_GATES, source=None):
        """:func:`step_local` on a chunk's carry (the planes, ``origin``,
        ``centroid_ring`` and, with stats, the device counters
        ``fallbacks`` and ``spill_rows_max``); returns the new carry."""
        f = {k: carry[k] for k in TABLE_FIELDS}
        f, origin, ring_t, ok = step_local(f, carry["origin"], carry["centroid_ring"], step_t,
                                           rebuild, gates, source)
        out = {**f, "origin": origin, "centroid_ring": ring_t}
        if with_stats:
            fallbacks, spill = carry["fallbacks"], carry["spill_rows_max"]
            if ok is not None:
                # the JAX chunk's stats[0] + (1 - rb_ok), summed over scenes
                fallbacks = fallbacks + (~ok).to(torch.int64).sum()
            out["fallbacks"] = fallbacks
            if cs > cap:
                rows = f["val"][..., :C].unflatten(-1, (cs, L0))[..., cap:, :] > 0.5
                spill = torch.maximum(spill, ring.psum(rows.flatten(1).sum(dim=1)))
            out["spill_rows_max"] = spill
        return out

    fns: dict = {}

    def piece(pattern: tuple):
        """The block function of a piece (``engine_table.table_pieces``):
        its steps in turn from the 0-dim int64 device step ``step0``, each
        gated step drawing from the carry's draws."""
        if pattern not in fns:
            def block(carry, step0):
                for j, (gates, rebuild) in enumerate(pattern):
                    carry = {**carry, **carry_step(carry, step0 + j, rebuild, gates,
                                                   chunk.drawn(carry, j))}
                return carry

            block.steps = len(pattern)
            fns[pattern] = block
        return fns[pattern]

    graphs: dict = {}
    capture = isinstance(ring, LocalRing)

    def blocks(state: SimState, n_steps: int, seg_aligned: bool = False):
        """The chunk as a block iterator: enqueues it a block at a time (K
        steps, gated or not, the dead step among them, or the ragged
        tail), yields after each, and returns the final state, with
        ``with_stats`` as ``(state, stats)`` whose counters are still
        0-dim device tensors (``run_chunk.read_stats`` reads them).
        ``seg_aligned`` is taken for the other runners' signature, and
        changes nothing here."""
        if state.device != ring.device:
            raise ValueError(f"state on {state.device}, ring on {ring.device}")
        ts = enter_table(params, state)
        carry = {**split_local(ts.fields), "origin": ts.origin,
                 "centroid_ring": ts.centroid_ring}
        if with_stats:
            carry["fallbacks"] = torch.zeros((), dtype=torch.int64, device=ring.device)
            carry["spill_rows_max"] = torch.zeros((), dtype=torch.int64, device=ring.device)
        names = tuple(carry)
        # the single-table schedule: chunk-relative for K <= 8, absolute
        # above (engine_table.make_run_chunk_table); the ragged tail has no
        # rebuild
        for pattern in table_pieces(params, k_rb, ts.step, n_steps):
            s = ts.step
            step_in = dict(carry)
            for j, (gates, _) in enumerate(pattern):
                for name, v in chunk.draws(params, ts.generator, s + j, gates,
                                           ts.fields["dead"].shape, ring.device).items():
                    step_in[f"{name}{j}"] = v
            block = piece(pattern)
            if capture:
                key = ("piece", ring.device, tuple(carry["val"].shape), pattern)
                out = chunk.graphed(graphs, key, block, step_in, s)
            else:
                # a DistRing runs every block eagerly: NCCL enqueues its
                # collectives, nothing is read
                out = block(step_in, step_tensor(s, ring.device))
            carry = {k: out[k] for k in names}
            ts.step = s + len(pattern)
            yield
        f = {k: carry[k] for k in TABLE_FIELDS}
        out = exit_table(params, ts.replace(fields=join_global(f), origin=carry["origin"],
                                            centroid_ring=carry["centroid_ring"].clone()))
        if with_stats:
            return out, {k: carry[k] for k in ("fallbacks", "spill_rows_max")}
        return out

    def read_stats(result):
        """A chunk's result with its device counters read (the only read
        of the chunk, at its exit)."""
        if not with_stats:
            return result
        out, stats = result
        return out, {k: int(v) for k, v in stats.items()}

    run_chunk = ChunkRunner(blocks, "sharded", {"shards": D, "slot_rebuild_steps": k_rb},
                            finish=read_stats, k=k_rb)
    run_chunk.read_stats = read_stats
    # the pieces a measurement times alone: a whole table's fields to this
    # process's shards and back, the incremental rebuild, the rebuild with
    # its choice
    run_chunk.parts = {"split_local": split_local, "join_global": join_global,
                       "incremental": incremental, "rebuild": sharded_rebuild}
    return run_chunk, params


def make_sharded_table_run_batched(params: SimParams, ring=None, mesh=None,
                                   with_stats: bool = False, device="cuda"):
    """(run_chunk, resolved_params): the dp x tp table loop, a lockstep
    batch of scenes (``sweep.make_batch_state`` on the resolved params)
    whose tables each split their grid rows over a ring of shards.

    On ``ring`` (default ``LocalRing(DEFAULT_SHARDS, device)``) the batch
    runs as one: every field is laid out shard-major, ``(S, B, C +
    n_pad)``, so the ring shifts and reduces on the leading axis as for
    one scene, and kernel 4 and kernel 2's padded form each launch once per
    step / rebuild for all S x B blocks.  A rebuild decides each scene on
    its own (one ring-wide min per scene, on the device), as the JAX
    package's dp x tp loop does, whose vmapped ``lax.cond`` decays to a
    per-scene select: the incremental compaction for the scenes whose
    preconditions held, the exact global rebuild for the others (it runs,
    in a graph's conditional node, only when some scene needs it).  So each
    scene runs bit for bit as it runs alone through
    :func:`make_sharded_table_run`, whatever batch it is in.  This is not
    the unsharded batched table loop's rule (``engine_table._choose_rebuild``
    takes the incremental result for all scenes or the exact rebuild for
    all, the JAX package's ``_smart_rebuild_batched``): dp x tp follows the
    JAX package's dp x tp.

    With a ``mesh`` (``parallel/mesh.Mesh`` with axes ``("data",
    "bots")``), each place of the data axis runs its scene group
    (``sweep.shard_batch``) on a ``LocalRing`` of the bots axis' size on
    that place's device, each scene deciding its rebuilds alone, so the
    mesh entry gives the ring entry's result bit for bit; the
    places' chunks advance block by block in turn
    (``chunk.interleaved``), so every place's chunk is enqueued
    before any is read, and ``run_chunk`` returns the batch in scene order
    on the first place.  ``with_stats`` adds the stats of
    :func:`make_sharded_table_run`, summed (``fallbacks``) and maxed
    (``spill_rows_max``) over the groups.  ``run_chunk.blocks`` and
    ``run_chunk.read_stats`` are as the single-scene runner's: on a ring
    its own, with a mesh the places' blocks interleaved."""
    if mesh is None:
        ring = ring if ring is not None else LocalRing(DEFAULT_SHARDS, device)
        run, params = make_sharded_table_run(params, ring, with_stats)

        def blocks(batch_state: SimState, n_steps: int, seg_aligned: bool = False):
            if batch_state.pos.dim() != 3:
                raise ValueError("the dp x tp loop takes a batched state (B, n_pad, 2)")
            return run.blocks(batch_state, n_steps)

        run_chunk = ChunkRunner(blocks, "sharded", run.path_info, finish=run.read_stats,
                                k=run.k)
        run_chunk.read_stats = run.read_stats
        return run_chunk, params

    from .sweep import gather_batch, shard_batch

    places = mesh.axis_devices("data")
    runs = [make_sharded_table_run(params, LocalRing(mesh.shape["bots"], dev), with_stats)
            for dev in places]
    params = runs[0][1]
    runs = [run for run, _ in runs]

    def blocks(batch_state: SimState, n_steps: int, seg_aligned: bool = False):
        """The places' chunks as one block iterator (``interleaved``): it
        returns what ``run_chunk`` returns, with the stats' counters still
        on the device."""
        groups = shard_batch(batch_state, mesh)
        outs = yield from interleaved(run.blocks(gs, n_steps) for gs, run in zip(groups, runs))
        if not with_stats:
            return gather_batch(outs)
        dev = outs[0][0].device
        stats = {
            "fallbacks": sum(s["fallbacks"].to(dev) for _, s in outs),
            "spill_rows_max": torch.stack([s["spill_rows_max"].to(dev) for _, s in outs]).amax(),
        }
        return gather_batch([o for o, _ in outs]), stats

    run_mesh = ChunkRunner(blocks, "sharded", dict(runs[0].path_info, places=len(places)),
                           finish=runs[0].read_stats, k=runs[0].k)
    run_mesh.read_stats = runs[0].read_stats
    return run_mesh, params

