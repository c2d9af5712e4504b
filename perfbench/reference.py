"""The plain reference: one physics step of a particle-robot swarm in plain
PyTorch, written from the reference simulator's equations.

It imports nothing of the program.  It takes a scene's arrays (real bots
only, no padding), the step number and the run's draw source, and steps
them in the reference's op order (particlebot.cpp:170-300): centroid ring,
phase law with its noise, force-limited radius law, integration with the
box clamp, then the pair contact and magnet forces, the circular
obstacles and the stick-slip friction (particlebot_kernel_impl.cuh:53-831).
Pairs are found through a plain cell list of side ``cutoff``, so every
pair closer than the cutoff is summed, in no order the program shares.
A step is two halves, :func:`pre` (up to the integration) and
:func:`post` (the forces and the friction), so that :func:`run` can
also start and end mid-step, as a span of the program's kernel 3 does.

``dtype`` is the precision it computes in: float32 as the configurations
state it, or a lower one for the control that shows the comparison fails
where the arithmetic does.

The parameters are a dict of the port's ``SimParams`` field names
(:data:`DEFAULTS`, a frozen copy of the reference's defaults, updated by
the configuration's file).  Dead-cell injection, the payload, shadows and
rectangular obstacles are not here: no configuration of the benchmark uses
them, and :func:`check_supported` refuses one that does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the reference simulator's defaults (main.cpp:833-911) under the port's
# field names, for the keys the physics reads
DEFAULTS = {
    "n_cells": 501, "n_dead": -1, "seed": 0, "min_radius": 0.0775,
    "max_radius": 0.1175, "rise_period": 2.0, "nx": 5, "constraint": 0.5,
    "constrained_contraction": 0, "constraint_contraction": 10.0,
    "spring": 1000.0, "damping": 10.0, "shear": 40.0,
    "attraction": 3.0 * 0.000015884, "friction": 0.4, "gravity": 9.81 * 0.566,
    "boundary_damping": -1.0, "rad_factor": 2.0, "light_x": -5.0, "light_y": 0.0,
    "light_shadow": 0, "phase_std": 0.3 * 2.0, "phase_update_interval": 12.0,
    "timestep": 0.01, "time_to_dead": 0.0, "centroid_int": 10.0,
    "centroid_steps": 24000, "rect_obstacles": [], "circle_obstacles": [],
    "world_half": 64.0, "neighbor_cutoff": 0.0, "grid_dim": 0, "cell_capacity": 16,
    "overflow_slots": -1,
}

# magnet law breakpoints in the surface gap, and its plateau
# (particlebot_kernel_impl.cuh:578-580)
MAGNET_INT1, MAGNET_INT2, MAGNET_MIN_ATTR = 0.0009, 0.0019, 2.5
# the actuator's no-load speed (particlebot_kernel_impl.cuh:155)
MAX_SPEED = 0.1
PHASE_FROZEN = 1.0e7
# empty wrapped edge columns of the table layout a draw may be made in
EDGE_MARGIN = 2
_EPS = 1.0e-12

FIELDS = ("pos", "vel", "rad", "phase", "abs_force_a", "abs_force_r")


class MissingDraw(RuntimeError):
    """The program did not draw what the step it was to run draws: it did
    not run that step's phase law."""


def params_of(config: dict) -> dict:
    """The defaults updated by a configuration's ``params``."""
    p = dict(DEFAULTS)
    p.update(config.get("params", {}))
    return p


def check_supported(p: dict) -> None:
    if p["n_dead"] != 0 or p["light_shadow"] or p["rect_obstacles"]:
        raise NotImplementedError(
            "the plain reference steps scenes without dead bots, payload, "
            "shadows or rectangular obstacles")


def cutoff(p: dict) -> float:
    if p["neighbor_cutoff"] > 0:
        return p["neighbor_cutoff"]
    return 2.2 * (p["max_radius"] * 2.0)


def steps_of(p: dict, seconds: float) -> int:
    return max(1, int(round(seconds / p["timestep"])))


def gates(p: dict, step: int) -> tuple:
    """(centroid, phase) gates of ``step``: each fires on the first step of
    its interval (particlebot.cpp:207, 212)."""
    return (step % steps_of(p, p["centroid_int"]) == 0,
            step % steps_of(p, p["phase_update_interval"]) == 0)


# --------------------------------------------------------- draw layouts

def grid_dim(p: dict) -> int:
    """The side of the cell table a table-layout draw is made over: ~1.5
    packed-blob diameters in cells of ``cutoff``, a multiple of 16."""
    if p["grid_dim"]:
        return p["grid_dim"]
    diameter = 2.1 * p["min_radius"] * math.sqrt(max(p["n_cells"], 1))
    return max(16, int(math.ceil(1.5 * diameter / cutoff(p) / 16.0)) * 16)


def storage_capacity(p: dict) -> int:
    spill = p["overflow_slots"] if p["overflow_slots"] >= 0 else (
        8 if p["n_cells"] > 100_000 else 0)
    return p["cell_capacity"] + spill


def cell_counts(p: dict, pos: torch.Tensor) -> tuple:
    """(cell id per bot, bots per cell) of the wrapped ``G x G`` table
    anchored ``EDGE_MARGIN`` cells below the swarm's bounding box: the
    layout a table-resident loop enters a chunk with."""
    g = grid_dim(p)
    h = float(np.float32(cutoff(p)))
    origin = pos.min(dim=0).values - float(np.float32(EDGE_MARGIN * cutoff(p)))
    ix = torch.floor((pos[:, 0] - origin[0]) / h).to(torch.int32) % g
    iy = torch.floor((pos[:, 1] - origin[1]) / h).to(torch.int32) % g
    cid = (iy * g + ix).long()
    return cid, torch.bincount(cid, minlength=g * g)


def table_rows(p: dict, pos: torch.Tensor) -> torch.Tensor:
    """The row each bot takes in a table entered from ``pos`` (bot order):
    slot-major ``rank * G*G + cell`` with bots ranked by index within their
    cell, a bot past the storage capacity in the parking row ``G*G*Cs +
    index``."""
    g, cs = grid_dim(p), storage_capacity(p)
    cid, _ = cell_counts(p, pos)
    n = pos.shape[0]
    order = torch.argsort(cid, stable=True)
    scid = cid[order]
    idx = torch.arange(n, device=pos.device)
    start = torch.ones_like(scid, dtype=torch.bool)
    start[1:] = scid[1:] != scid[:-1]
    rank = idx - torch.cummax(torch.where(start, idx, torch.zeros_like(idx)), 0).values
    rows_sorted = torch.where(rank < cs, rank * g * g + scid, g * g * cs + order)
    return torch.empty_like(rows_sorted).index_put_((order,), rows_sorted)


def phase_noise(p: dict, draws, step: int, pos: torch.Tensor, entry: bool,
                rows: torch.Tensor | None = None) -> torch.Tensor:
    """Each bot's standard normal noise of ``step``: the draw the program
    asked for that step, in the layout it asked for (bot order, or a
    table), read at each bot's row.  A table's rows are known at a piece's
    first step (``entry``) alone: ``rows`` where the piece starts from a
    table the program carries, else those of a table entered from
    ``pos``; after a slot rebuild they are the program's own state."""
    shape = draws.asked.get(("normal", step))
    if shape is None:
        raise MissingDraw(f"the program drew no phase noise for step {step}")
    values = draws.normal(step, shape, pos.device)
    n = pos.shape[0]
    n_pad = -(-n // 128) * 128
    if shape == (n_pad,):
        return values[:n]
    if shape == (grid_dim(p) ** 2 * storage_capacity(p) + n_pad,) and entry:
        return values[table_rows(p, pos) if rows is None else rows]
    raise RuntimeError(f"a draw of shape {shape} for {n} bots is in no layout the reference knows")


# ------------------------------------------------------------- physics

def _norm2(x, y):
    return torch.sqrt(torch.clamp(x * x + y * y, min=1.0e-30))


def neighbours(p: dict, pos: torch.Tensor) -> tuple:
    """(j, valid): for each bot, the indices of every bot in its own and
    the 8 surrounding cells of side ``cutoff``, (n, m), and which of them
    are other bots."""
    n = pos.shape[0]
    h = cutoff(p)
    cx = torch.floor(pos[:, 0].float() / h).long()
    cy = torch.floor(pos[:, 1].float() / h).long()
    span = 1 << 21
    key = (cx + span // 2) * span + (cy + span // 2)
    sorted_key, order = torch.sort(key, stable=True)
    lo, cnt = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            k = key + dx * span + dy
            a = torch.searchsorted(sorted_key, k, right=False)
            b = torch.searchsorted(sorted_key, k, right=True)
            lo.append(a)
            cnt.append(b - a)
    lo, cnt = torch.stack(lo, 1), torch.stack(cnt, 1)
    width = int(cnt.max())
    k = torch.arange(width, device=pos.device)
    slot = lo[:, :, None] + k
    valid = k < cnt[:, :, None]
    j = order[torch.clamp(slot, max=n - 1)].reshape(n, -1)
    valid = valid.reshape(n, -1) & (j != torch.arange(n, device=pos.device)[:, None])
    return j, valid


def pair_forces(p: dict, pos, vel, rad, j, valid):
    """(fx, fy, attraction magnitude sum, contact magnitude sum) on each
    bot from its candidate pairs (collideSpheres,
    particlebot_kernel_impl.cuh:540-594)."""
    dx = pos[j, 0] - pos[:, None, 0]
    dy = pos[j, 1] - pos[:, None, 1]
    rvx = vel[j, 0] - vel[:, None, 0]
    rvy = vel[j, 1] - vel[:, None, 1]
    dist = _norm2(dx, dy)
    safe = torch.clamp(dist, min=_EPS)
    nx, ny = dx / safe, dy / safe
    cd = rad[:, None] + rad[j]
    overlap = valid & (dist < cd)
    attract = valid & ~(dist < cd) & (dist < cutoff(p))

    vn = rvx * nx + rvy * ny
    tx, ty = rvx - vn * nx, rvy - vn * ny
    fcx = -p["spring"] * (cd - dist) * nx + p["damping"] * rvx + p["shear"] * tx
    fcy = -p["spring"] * (cd - dist) * ny + p["damping"] * rvy + p["shear"] * ty

    gap = dist - cd
    attr = p["attraction"]
    slope = (attr / MAGNET_INT2 ** 2 - MAGNET_MIN_ATTR) / (MAGNET_INT2 - MAGNET_INT1)
    far = torch.where(gap >= MAGNET_INT2, gap, torch.ones_like(gap))
    mag = torch.where(
        gap < MAGNET_INT1, torch.full_like(gap, MAGNET_MIN_ATTR),
        torch.where(gap < MAGNET_INT2, MAGNET_MIN_ATTR + slope * (gap - MAGNET_INT1),
                    attr / (far * far)))
    fax, fay = mag * nx, mag * ny

    zero = torch.zeros_like(dist)
    fx = torch.where(overlap, fcx, zero) + torch.where(attract, fax, zero)
    fy = torch.where(overlap, fcy, zero) + torch.where(attract, fay, zero)
    mc = torch.where(overlap, _norm2(fcx, fcy), zero)
    ma = torch.where(attract, _norm2(fax, fay), zero)
    return fx.sum(1), fy.sum(1), ma.sum(1), mc.sum(1)


def obstacle_forces(p: dict, pos, vel, rad):
    """Circular obstacles: contact with twice the pair spring
    (particlebot_kernel_impl.cuh:703-740)."""
    px, py, vx, vy = pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1]
    fx, fy, mr = torch.zeros_like(px), torch.zeros_like(px), torch.zeros_like(px)
    for ox, oy, orad in p["circle_obstacles"]:
        tcx, tcy = ox - px, oy - py
        d2 = tcx * tcx + tcy * tcy
        hit = d2 < (rad + orad) ** 2
        inv = 1.0 / torch.clamp(_norm2(tcx, tcy), min=_EPS)
        dirx, diry = tcx * inv, tcy * inv
        over = rad + orad - torch.sqrt(torch.clamp(d2, min=_EPS))
        rvx, rvy = -vx, -vy
        vn = rvx * dirx + rvy * diry
        ffx = (-2.0 * p["spring"] * over * dirx + p["damping"] * rvx
               + p["shear"] * (rvx - vn * dirx))
        ffy = (-2.0 * p["spring"] * over * diry + p["damping"] * rvy
               + p["shear"] * (rvy - vn * diry))
        zero = torch.zeros_like(px)
        fx = fx + torch.where(hit, ffx, zero)
        fy = fy + torch.where(hit, ffy, zero)
        mr = mr + torch.where(hit, _norm2(ffx, ffy), zero)
    return fx, fy, mr


def friction(p: dict, vx, vy, fx, fy):
    """Stick-slip friction and the velocity update
    (particlebot_kernel_impl.cuh:801-825)."""
    fric, grav, dt = p["friction"], p["gravity"], p["timestep"]
    hold = (_norm2(vx, vy) < 1.0e-6) & (_norm2(fx, fy) < 2.0 * fric * grav)
    zero = torch.zeros_like(vx)
    fx, fy = torch.where(hold, zero, fx), torch.where(hold, zero, fy)
    vx, vy = vx + fx * dt, vy + fy * dt
    speed = _norm2(vx, vy)
    kin = fric * grav * dt
    inv = torch.clamp(speed, min=_EPS)
    stop = speed < kin
    return (torch.where(stop, zero, vx - kin * (vx / inv)),
            torch.where(stop, zero, vy - kin * (vy / inv)))


def radius_law(p: dict, rad, phase, aa, ar, time):
    """Force-limited triangle-wave radius (updateRad_light_wave,
    particlebot_kernel_impl.cuh:124-181)."""
    period = (p["nx"] + 1) * p["rise_period"]
    rise, min_r, max_r, dt = p["rise_period"], p["min_radius"], p["max_radius"], p["timestep"]
    t1 = time + phase
    t1 = torch.where(t1 < 0, t1 + 100.0 * period, t1)
    t1 = torch.where(t1 >= period, t1 - period * torch.floor(t1 / period), t1)
    window = t1 < 2.0 * rise
    target = torch.where(t1 <= rise, min_r + (max_r - min_r) / rise * t1,
                         max_r + (min_r - max_r) / rise * (t1 - rise))
    dr1 = target - rad
    torque = dr1 * p["constraint"] * rad / MAX_SPEED / max_r / dt
    torque = torch.clamp(torque, max=p["constraint"])
    surplus = torque / torch.clamp(rad, min=1.0e-9)
    expand = torch.where(surplus > ar, MAX_SPEED * max_r / p["constraint"] * (surplus - ar) * dt,
                         torch.zeros_like(rad))
    if p["constrained_contraction"]:
        cc = p["constraint_contraction"]
        contract = torch.where(-cc * dr1 > aa * rad, (cc * dr1 + aa * rad) / cc,
                               torch.zeros_like(rad))
        contract = torch.clamp(contract, min=-max_r * dt)
    else:
        contract = dr1
    new = torch.clamp(rad + torch.where(dr1 > 0, expand, contract), min=min_r, max=max_r)
    frozen = (phase > PHASE_FROZEN) | ~window
    return torch.where(frozen, rad, new)


def pre(p: dict, s: dict, step_no: int, draws, ring=None, entry: bool = True,
        rows: torch.Tensor | None = None) -> dict:
    """The first half of step ``step_no`` of the scene ``s`` (a dict of
    :data:`FIELDS`, real bots only, all of one dtype): the centroid ring
    and the phase law where their gates fire, the radius law and the
    integration with the box clamp.  It ends mid-step, after integration
    and before the pair forces; the force magnitudes it read are carried
    on.  ``ring`` is a dict of the centroid rows this stretch wrote, by
    row, updated in place; ``entry`` (the piece's first step) and
    ``rows`` as :func:`phase_noise` takes them."""
    pos, vel, rad, phase = s["pos"], s["vel"], s["rad"], s["phase"]
    dt = p["timestep"]
    cog, ph = gates(p, step_no)
    if cog and ring is not None:
        row = (step_no // steps_of(p, p["centroid_int"])) % p["centroid_steps"]
        ring[row] = pos.sum(0) / p["n_cells"]
    if ph:
        dist = torch.sqrt((pos[:, 0] - p["light_x"]) ** 2 + (pos[:, 1] - p["light_y"]) ** 2)
        phase = (dist.min() - dist) / (2.0 * p["min_radius"]) * p["rise_period"]
        if p["phase_std"]:
            noise = phase_noise(p, draws, step_no, s["pos"].float(), entry, rows)
            noise = noise.to(pos.dtype)
            phase = phase + p["phase_std"] * noise
    time = torch.tensor(float(step_no), dtype=pos.dtype, device=pos.device) * dt
    rad = radius_law(p, rad, phase, s["abs_force_a"], s["abs_force_r"], time)
    half = p["world_half"]
    new = pos + vel * dt
    hi, lo = (half - rad)[:, None], (-half + rad)[:, None]
    out = (new > hi) | (new < lo)
    pos = torch.minimum(torch.maximum(new, lo), hi)
    vel = torch.where(out, vel * p["boundary_damping"], vel)
    return {"pos": pos, "vel": vel, "rad": rad, "phase": phase,
            "abs_force_a": s["abs_force_a"], "abs_force_r": s["abs_force_r"]}


def post(p: dict, s: dict) -> dict:
    """The second half of a step, from mid-step: the pair contact and
    magnet forces, the circular obstacles and the stick-slip friction,
    which write the velocities and the force magnitudes."""
    pos, vel, rad = s["pos"], s["vel"], s["rad"]
    j, valid = neighbours(p, pos)
    fx, fy, aa, ar = pair_forces(p, pos, vel, rad, j, valid)
    ox, oy, mr = obstacle_forces(p, pos, vel, rad)
    vx, vy = friction(p, vel[:, 0], vel[:, 1], fx + ox, fy + oy)
    return {"pos": pos, "vel": torch.stack([vx, vy], 1), "rad": rad, "phase": s["phase"],
            "abs_force_a": aa, "abs_force_r": ar + mr}


def step(p: dict, s: dict, step_no: int, draws, ring=None, entry: bool = True,
         rows: torch.Tensor | None = None) -> dict:
    """One whole step of the scene ``s`` at step ``step_no``: :func:`pre`,
    then :func:`post`."""
    return post(p, pre(p, s, step_no, draws, ring, entry, rows))


def run(p: dict, s: dict, start: int, n_steps: int, draws, dtype=torch.float32,
        rows: torch.Tensor | None = None, mid: bool = False):
    """``n_steps`` steps of scene ``s`` from step ``start`` in ``dtype``:
    (the scene after them in float32, the centroid rows written, by
    row); ``rows``, where given, the bots' rows in the table the program
    carries at ``start``.  With ``mid`` the steps start and end mid-step
    (:func:`pre`'s end): ``s`` is step ``start - 1`` after integration,
    and the answer is step ``start + n_steps - 1`` after integration, the
    span of kernel 3 (its post, then ``n_steps - 1`` whole steps, then a
    pre)."""
    check_supported(p)
    s = {k: s[k].to(dtype) for k in FIELDS}
    ring: dict = {}
    if mid:
        s = post(p, s)
    for i in range(n_steps):
        s = pre(p, s, start + i, draws, ring, entry=i == 0, rows=rows)
        if not mid or i < n_steps - 1:
            s = post(p, s)
    return ({k: v.float() for k, v in s.items()},
            {r: v.float() for r, v in ring.items()})
