"""Pair-force stencil on slot-major cell tables (kernel 1) and its plumbing.

Port of ``particlerobotsimulations_tpu.ops.pallas_stencil``: the field
order, the slot assignment, the flat lane preshift, the force pass itself,
and the per-bot PALLAS collide (:func:`pallas_stencil_collide`: scatter
the bots to slot-major tables, the force pass, gather back).  The name is kept so the counterpart
is easy to find; the force pass is the hand-written CUDA kernel in
``csrc/stencil_forces.cu`` on a CUDA tensor and the plain PyTorch twin
:func:`stencil_forces_plain` on a CPU tensor (:func:`stencil_forces`).

The sharded table loop's force pass (kernel 4: kernel 1's tiled body in
``csrc/stencil_forces.cu``, twin :func:`stencil_forces_ext_plain`,
dispatch :func:`stencil_forces_ext`) is the same pair law on a
halo-extended shard table: occupancy from the ``val`` plane, the x-wrap
per row and y read linearly into the halo rows.

Tables are ``(C, G*G)``: capacity slots on the first axis, cells
(row-major ``y*G + x``, wrapped, bbox-anchored) on the second.  A row is
occupied iff its radius is positive.  Both versions compute, for every
occupied row, the sum over all occupied rows in its 3x3 cell neighbourhood
(exact 2-D wrap, itself excluded) — the full-gather form.  The JAX kernel
evaluates half the pairs and adds Newton reactions; the pair set is the
same, so the two agree to float reassociation.  Pair constants match
``collideSpheres`` (particlebot_kernel_impl.cuh:540-594).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimParams
from .forces import (
    MAGNET_INT1,
    MAGNET_INT2,
    MAGNET_MIN_ATTR,
    attraction_scale,
    friction_velocity_update,
    obstacle_forces,
)
from .grid import OFFSETS9, cell_ids, rank_cells

f32 = np.float32

# field order of the kernel's input planes (and the first 7 table fields)
FIELDS = ("px", "py", "vx", "vy", "rad", "val", "afac")
N_FIELDS = len(FIELDS)

# the JAX kernel's candidate cells: center + the Newton half-set.  The
# port's kernel gathers all of OFFSETS9 instead; kept for reference.
OFFSETS = ((0, 0), (1, 0), (0, 1), (1, 1), (1, -1))


def _lane_x(g: int, gg: int, device) -> torch.Tensor:
    """(gg,) x coordinate of each flat cell lane (cell = y*G + x)."""
    return torch.arange(gg, device=device) % g


def _preshift_flat(stacked, g: int, dx: int, dy: int):
    """out[..., y*G+x] = stacked[..., ((y+dy)%G)*G + (x+dx)%G] via flat
    lane rolls: a y-shift is a flat roll by dy*G, and a dx = +-1 x-shift is
    a flat roll by dx that is wrong only on one edge column, fixed with a
    second roll + lane select (the exact 2-D wrap)."""
    gg = stacked.shape[-1]
    if dx == 0 and dy == 0:
        return stacked
    main = torch.roll(stacked, -(dy * g + dx), dims=-1)
    if dx == 0:
        return main
    if dx == 1:
        fix = torch.roll(stacked, -(dy * g + dx - g), dims=-1)
        return torch.where(_lane_x(g, gg, stacked.device) == g - 1, fix, main)
    assert dx == -1
    fix = torch.roll(stacked, -(dy * g + dx + g), dims=-1)
    return torch.where(_lane_x(g, gg, stacked.device) == 0, fix, main)


def assign_slots_slotmajor(params: SimParams, pos, mask, origin=None, cap=None):
    """(n_pad,) flat slot per bot in the (C, G*G) slot-major layout:
    ``slot = rank * G*G + cell_id`` (rank = index within the cell).
    ``G*G*C`` marks dropped bots (padding / overflow).  ``cap`` defaults to
    the force-visible cell capacity; the table loop passes its storage
    capacity.  Returns (slot, overflow count)."""
    g = params.resolved_grid_dim()
    cap = cap if cap is not None else params.cell_capacity
    n = pos.shape[0]
    cid = cell_ids(params, pos, mask, origin=origin)
    order, scid, rank, in_range, overflow = rank_cells(cid, g, cap)
    keep = in_range & (rank < cap)
    slot_sorted = torch.where(
        keep, rank * (g * g) + scid, torch.full_like(scid, g * g * cap)
    )
    slot = torch.zeros((n,), dtype=torch.int32, device=pos.device)
    slot = slot.index_put((order,), slot_sorted)
    return slot, overflow


def pair_constants(params: SimParams) -> tuple:
    """The float32 constants of the pair law, in kernel 1's argument order
    (cutoff, spring, damping, shear, attraction, the two magnet
    breakpoints, the plateau, and the ramp's two factors as the JAX
    ``_pair_block`` folds them) — shared by the kernel and its twin."""
    return tuple(float(f32(v)) for v in (
        params.cutoff(), params.spring, params.damping, params.shear,
        params.attraction, MAGNET_INT1, MAGNET_INT2, MAGNET_MIN_ATTR,
        1.0 / (MAGNET_INT2 * MAGNET_INT2), 1.0 / (MAGNET_INT2 - MAGNET_INT1),
    ))


def _pair_terms(params: SimParams, t: dict, c: dict, self_block: bool, cap: int):
    """(fx, fy, ma, mc) of shape (C, C, L) for targets t (C, 1, L) against
    candidates c (1, C, L): the JAX ``_pair_block`` term for term (no
    magmin shortcut), with ``1 / sqrt`` in place of rsqrt."""
    (cutoff, spring, damping, shear, attraction,
     i1, i2, mina, inv_i2_sq, inv_span) = (
        f32(v) for v in pair_constants(params)
    )
    eps = f32(1.0e-12)
    dx = c["px"] - t["px"]
    dy = c["py"] - t["py"]
    d2 = dx * dx + dy * dy + eps * eps
    inv_dist = 1.0 / torch.sqrt(d2)
    dist = d2 * inv_dist
    nx = dx * inv_dist
    ny = dy * inv_dist

    cd = t["rad"] + c["rad"]
    valid = t["val"] * c["val"]
    if self_block:
        ti = torch.arange(cap, device=dx.device)[:, None, None]
        ci = torch.arange(cap, device=dx.device)[None, :, None]
        valid = valid * (ti != ci).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dx.device)
    is_overlap = dist < cd
    overlap = torch.where(is_overlap, valid, zero)
    attract = torch.where(~is_overlap & (dist < cutoff), valid, zero)

    rvx = c["vx"] - t["vx"]
    rvy = c["vy"] - t["vy"]
    vn = rvx * nx + rvy * ny
    tx = rvx - vn * nx
    ty = rvy - vn * ny
    fcx = -spring * (cd - dist) * nx + damping * rvx + shear * tx
    fcy = -spring * (cd - dist) * ny + damping * rvy + shear * ty

    gap = dist - cd
    if params.has_payload:
        attr = attraction * t["afac"] * c["afac"]
    else:
        attr = attraction
    ramp = mina + (attr * inv_i2_sq - mina) * inv_span * (gap - i1)
    inv2 = attr / (gap * gap)
    mag = torch.where(
        gap < i1, torch.full_like(gap, mina), torch.where(gap < i2, ramp, inv2)
    )
    fx = overlap * fcx + attract * (mag * nx)
    fy = overlap * fcy + attract * (mag * ny)
    mc = overlap * torch.sqrt(fcx * fcx + fcy * fcy)
    ma = attract * mag
    return fx, fy, ma, mc


# the twins' lane count is rounded up to a multiple of this many lanes: the
# CPU's vectorised sum over the candidate slots then treats each lane as the
# whole-table sum does, so the result does not depend on the lanes skipped
LANE_PAD = 64


def _occupied_lanes(occupied: torch.Tensor) -> torch.Tensor:
    """The lanes, in order, that the twins compute for (..., C, L)
    occupancy: every lane that holds an occupied row in any block, and
    unoccupied ones up to a multiple of LANE_PAD (or all L).  A lane left
    out holds no target, so its sums are zero.  The count stays a tensor
    (a mask picks the lanes), so the CPU loops convert no tensor to a
    Python value."""
    occ = occupied.reshape(-1, occupied.shape[-1]).any(dim=0)
    lanes = torch.arange(occ.numel(), device=occ.device)
    n = torch.div(occ.sum() + (LANE_PAD - 1), LANE_PAD, rounding_mode="floor") * LANE_PAD
    return torch.sort(torch.argsort(~occ, stable=True)[lanes < n]).values


def stencil_forces_plain(params: SimParams, tables: dict):
    """Plain PyTorch twin of kernel 1: the (C, 1, L) x (1, C, L) pair
    broadcast over the 9 rolled neighbour blocks (exact 2-D wrap), on the
    lanes that hold a target.  ``tables``: (C, G*G) px, py, vx, vy, rad
    (+ afac with a payload)."""
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    gg = g * g
    names = ["px", "py", "vx", "vy", "rad"] + (
        ["afac"] if params.has_payload else []
    )
    base = {k: tables[k] for k in names}
    base["val"] = (base["rad"] > 0).to(torch.float32)
    lanes = _occupied_lanes(base["rad"] > 0)
    t = {k: v[:, None, lanes] for k, v in base.items()}
    acc = [torch.zeros((cap, lanes.numel()), dtype=torch.float32, device=tables["px"].device)
           for _ in range(4)]
    for dx, dy in OFFSETS9:
        c = {
            k: torch.roll(v.reshape(cap, g, g), (-dy, -dx), dims=(1, 2))
            .reshape(1, cap, gg)[..., lanes]
            for k, v in base.items()
        }
        terms = _pair_terms(params, t, c, (dx, dy) == (0, 0), cap)
        for i in range(4):
            acc[i] = acc[i] + terms[i].sum(dim=1)
    out = []
    for a in acc:
        full = torch.zeros((cap, gg), dtype=torch.float32, device=a.device)
        full[:, lanes] = a
        out.append(full)
    return tuple(out)


def stencil_forces_batched_plain(params: SimParams, tables: dict):
    """Plain twin of kernel 1's batched form: :func:`stencil_forces_plain`
    on each scene of (B, C, G*G) tables, stacked."""
    outs = [
        stencil_forces_plain(params, {k: v[b] for k, v in tables.items()})
        for b in range(tables["px"].shape[0])
    ]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(4))


def stencil_forces(params: SimParams, tables: dict):
    """(fx, fy, fa, fr) for (C, G*G) field tables, or (B, C, G*G) tables of
    B scenes (the batched table loop), each output of the tables' shape:
    kernel 1 on CUDA tensors (one launch for all scenes), the plain twin on
    CPU tensors."""
    px = tables["px"]
    kind, batched = px.device.type, px.dim() == 3
    if kind == "cuda":
        from ..kernels import stencil_forces_batched_cuda, stencil_forces_cuda

        fn = stencil_forces_batched_cuda if batched else stencil_forces_cuda
        return fn(params, tables)
    if kind == "cpu":
        fn = stencil_forces_batched_plain if batched else stencil_forces_plain
        return fn(params, tables)
    raise ValueError(f"stencil_forces: unsupported device {px.device}")


def stencil_forces_ext_plain(params: SimParams, tables_ext: dict,
                             center_start: int, center_lanes: int):
    """Plain PyTorch twin of kernel 4 — the JAX ``_make_kernel_ext`` sum:
    the 9 OFFSETS9 blocks preshifted over the extended lanes
    (:func:`_preshift_flat`), the pair term with the center block's own
    slot excluded and ``val`` taken from the val plane, summed over
    candidate slots, for the CENTER lanes that hold a target.
    ``tables_ext``: the FIELDS planes, each (..., C, E); returns (fx, fy,
    fa, fr), each (..., C, center_lanes)."""
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    base = torch.stack([tables_ext[k] for k in FIELDS])  # (7, ..., C, E)
    center = base[FIELDS.index("val")][..., center_start:center_start + center_lanes]
    lanes = _occupied_lanes(center != 0)
    ext_lanes = lanes + center_start
    t = {k: base[j][..., :, None, ext_lanes] for j, k in enumerate(FIELDS)}
    acc = [0.0] * 4
    for dx, dy in OFFSETS9:
        blk = _preshift_flat(base, g, dx, dy)[..., ext_lanes]
        c = {k: blk[j][..., None, :, :] for j, k in enumerate(FIELDS)}
        terms = _pair_terms(params, t, c, (dx, dy) == (0, 0), cap)
        for i in range(4):
            acc[i] = acc[i] + terms[i].sum(dim=-2)
    out = []
    for a in acc:
        full = center.new_zeros(center.shape)
        if lanes.numel():
            full[..., lanes] = a
        out.append(full)
    return tuple(out)


def stencil_forces_ext(params: SimParams, tables_ext: dict,
                       center_start: int, center_lanes: int):
    """(fx, fy, fa, fr) for the CENTER lanes of halo-extended tables
    (``[H pad | center | H pad]`` lanes, optionally with a leading shard
    axis, or the dp x tp loop's (S, B) axes): kernel 4 on CUDA tensors, one
    launch for every shard and scene, the plain twin on CPU tensors."""
    kind = tables_ext["px"].device.type
    if kind == "cuda":
        from ..kernels import stencil_forces_ext_batched_cuda, stencil_forces_ext_cuda

        fn = stencil_forces_ext_batched_cuda if tables_ext["px"].dim() == 4 else stencil_forces_ext_cuda
        return fn(params, tables_ext, center_start, center_lanes)
    if kind == "cpu":
        return stencil_forces_ext_plain(params, tables_ext, center_start, center_lanes)
    raise ValueError(f"stencil_forces_ext: unsupported device {tables_ext['px'].device}")


def scatter_bot_tables(params: SimParams, pos, vel, rad, mask, payload, slot):
    """The :data:`FIELDS` tables, each a contiguous (C, G*G) plane, of bot
    rows scattered to their slot-major ``slot`` (``G*G*C`` drops a bot):
    one 7-wide row scatter."""
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    total = g * g * cap
    rows = torch.stack(
        [pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1], rad, mask.to(torch.float32),
         attraction_scale(params, payload)],
        dim=-1,
    )
    # one spare row takes the dropped bots' writes; planes come out
    # field-major so each (C, G*G) table is contiguous
    table = torch.zeros((total + 1, N_FIELDS), dtype=torch.float32, device=pos.device)
    table[slot.long()] = rows
    planes = table[:total].T.contiguous().view(N_FIELDS, cap, g * g)
    return {k: planes[j] for j, k in enumerate(FIELDS)}


def pallas_stencil_collide(params: SimParams, pos, vel, rad, mask, payload, dt,
                           slot=None):
    """The per-bot PALLAS collide: scatter the bots' rows into the
    slot-major ``(C, G*G)`` tables, the force pass (:func:`stencil_forces`:
    kernel 1 on CUDA tensors, its twin on CPU tensors), gather ``(fx, fy,
    fa, fr)`` back, add the obstacles and apply friction.  Returns (new
    velocity, attraction magnitude sums, contact magnitude sums), per bot.

    ``slot`` may carry an assignment the caller reuses for a few steps
    (``assign_slots_slotmajor``); by default it is made here, anchored at
    the bare bounding box, so the table's edge columns can hold bots and
    the force pass keeps the exact 2-D wrap.  Kernel 1 reads occupancy from
    ``rad > 0`` where the JAX kernel reads the ``val`` plane built from
    ``mask``: the two agree because the scatter drops every bot without a
    slot (padding, which ``cell_ids`` routes out of range, and a cell's
    overflow), so every written row is a masked bot with a positive
    radius, and every other row stays zero."""
    total = params.resolved_grid_dim() ** 2 * params.cell_capacity
    if slot is None:
        slot, _ = assign_slots_slotmajor(params, pos, mask)
    slot = slot.long()
    fx, fy, fa, fr = stencil_forces(
        params, scatter_bot_tables(params, pos, vel, rad, mask, payload, slot)
    )

    safe = torch.clamp(slot, max=total - 1)
    got = mask & (slot < total)
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    packed = torch.stack([fx, fy, fa, fr], dim=-1).reshape(total, 4)
    out = torch.where(got[:, None], packed[safe], zero)
    abs_a, abs_r = out[:, 2], out[:, 3]

    f_obs, m_obs = obstacle_forces(params, pos, vel, rad)
    force = out[:, :2] + f_obs
    abs_r = abs_r + m_obs
    new_vel = friction_velocity_update(params, vel, force, payload, dt)
    return torch.where(mask[..., None], new_vel, zero), abs_a, abs_r


def make_diff_pallas_collide(params: SimParams, dt: float):
    """The per-bot PALLAS collide with a gradient: ``collide(pos, vel, rad,
    mask, payload) -> (new velocity, attraction sums, contact sums)``.

    Port of the JAX package's custom-VJP wrapper as a
    ``torch.autograd.Function``.  The forward is :func:`pallas_stencil_collide`
    (kernel 1 on CUDA tensors, its twin on CPU tensors).  Kernel 1 has no
    gradient, and its pair law may not be differentiated anyway: ``inv2`` of
    its magnet term is unguarded.  So the backward runs the STENCIL collide
    (``ops/stencil.stencil_collide``: the same pair set and law, guarded) on
    the saved inputs and pulls the three outputs' cotangents back through it
    (a missing cotangent counts as zeros).  ``mask`` and ``payload`` get no
    gradient."""
    from .stencil import stencil_collide

    class DiffPallasCollide(torch.autograd.Function):
        @staticmethod
        def forward(ctx, pos, vel, rad, mask, payload):
            ctx.save_for_backward(pos, vel, rad, mask, payload)
            return pallas_stencil_collide(params, pos, vel, rad, mask, payload, dt)

        @staticmethod
        def backward(ctx, *cts):
            pos, vel, rad, mask, payload = ctx.saved_tensors
            with torch.enable_grad():
                primals = [t.detach().requires_grad_() for t in (pos, vel, rad)]
                outs = stencil_collide(params, *primals, mask, payload, dt)
                cts = [torch.zeros_like(o) if c is None else c for o, c in zip(outs, cts)]
                grads = torch.autograd.grad(outs, primals, cts, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(primals, grads)]
            return (*grads, None, None)

    return DiffPallasCollide.apply
