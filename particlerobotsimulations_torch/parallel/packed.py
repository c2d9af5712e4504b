"""Packed scene-tiling sweep: B small scenes in one table-resident run.

Port of ``particlerobotsimulations_tpu.parallel.packed``.  Each scene is
placed on its own tile of a 2-D grid whose pitch leaves at least a full
neighbour window of empty cells between blobs, so the table loop's force
kernel, untouched, computes exactly the per-scene pair sets (it pairs only
within a 3x3 cell window).  The one op with a cross-bot reduction, the
light-phase law (min distance to the light over the scene's bots,
particlebot.cpp:212-232), runs per scene through the table loop's
``phase_fn`` hook (:func:`make_packed_phase`):

* scene assignment is the closed-form tile decode: the position minus the
  union bot-mean, rounded to the regular origin grid.  Phototaxis drift is
  common-mode across scenes, so only the per-seed differential drift has
  to stay inside pitch/2, and :func:`_check_health` enforces it;
* the per-scene minimum distance is a masked min over (rows, 16) column
  chunks of scenes, broadcast back to the rows.

Eligibility (:func:`packed_eligible`): light-wave control, no obstacles,
no shadow, no payload, no dead-cell injection.  The union's world box is
fitted to the union, so per-scene walls do not exist inside it; the health
check raises where a scene's extent reaches where its own walls would
have been.  The union draws in the table layout of one run seeded with
``params.seed``, as the JAX package's packed union does, so its
trajectories match single-scene runs in distribution, and to float
tolerance without phase noise over short horizons.  ``sweep.
choose_sweep_strategy`` never picks this strategy on the port's card (the
JAX package's crossover is a TPU measurement); ``run_sweep(...,
strategy="packed")`` reaches it.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..config import Control, SimParams
from ..engine_table import gate_seg, make_adaptive_run_chunk, make_run_chunk_table
from ..models.placement import initial_state_arrays, resolve_params
from ..ops.phase import update_phase
from ..ops.table_rebuild import EDGE_MARGIN
from ..state import SimState, make_state

f32 = np.float32

# empty-cell separation between tiles: the force kernel pairs within a 3x3
# cell window (+1 cell of bbox-anchor slack), so >= 4 empty cells makes
# cross-scene pairs structurally impossible
_SEP_CELLS = 4
# extra linear blob-growth slack on top of the max/min radius ratio
# (cohesion loosening during the oscillation wave)
_GROWTH_SLACK = 1.2
# scenes per column chunk of the per-scene minimum
_CHUNK = 16


def packed_eligible(params: SimParams) -> bool:
    """Scenario families the packed tiling supports (see module docstring)."""
    p = params
    return (
        p.control == Control.LIGHT_WAVE
        and not p.circle_obstacles
        and not p.rect_obstacles
        and not p.light_shadow
        and p.n_dead == 0
        and not p.has_payload
    )


def _tile_grid(n_scenes: int) -> tuple[int, int]:
    bx = int(math.ceil(math.sqrt(n_scenes)))
    by = int(math.ceil(n_scenes / bx))
    return bx, by


def pack_scenes(params: SimParams, seeds: Sequence[int], jitter_scale: float = 0.0,
                device="cuda", draws=None):
    """Place one scene per seed and tile them into a single packed state.

    Returns ``(packed_params, packed_state, origins (B, 2) f32, pitch)``.
    Scene ``i`` owns bot ids ``[i*n, (i+1)*n)``.  ``jitter_scale`` moves
    each scene's initial positions by ``default_rng(1000 + seed)`` gaussian
    noise of that scale, for comparisons against single-scene runs (placed
    lattices hold exactly tangent pairs, which an ulp flips between the
    contact and magnet branches).  ``draws`` maps ``params.seed`` to the
    union's draw source (default a generator seeded with it)."""
    params = resolve_params(params.validate())
    if not packed_eligible(params):
        raise ValueError(
            "scenario not packed-eligible (obstacles/shadow/payload/dead "
            "injection are per-scene state the tiled union cannot share); "
            "use the sequential or batched sweep strategy"
        )
    n, b = params.n_cells, len(seeds)
    scenes = [initial_state_arrays(params.replace(seed=int(s))) for s in seeds]
    nx = scenes[0][0].nx  # seed-independent (placement.config_size_x)

    pos_all = np.stack([sc[1] for sc in scenes])  # (B, n, 2)
    if jitter_scale:
        for i, s in enumerate(seeds):
            rng = np.random.default_rng(1000 + int(s))
            pos_all[i] = pos_all[i] + jitter_scale * rng.standard_normal(
                (n, 2)
            ).astype(np.float32)
    cbar = pos_all.reshape(-1, 2).mean(axis=0)
    half = float(np.abs(pos_all - cbar).max())  # Chebyshev about common mean
    cutoff = params.cutoff()
    # placement is at min_radius; radii oscillate up to max_radius, which
    # scales the close-packed blob linearly by the radius ratio
    growth = (params.max_radius / params.min_radius) * _GROWTH_SLACK
    pitch = 2.0 * half * growth + _SEP_CELLS * cutoff
    # cell-align the pitch so tile boundaries stay crisp in the wrapped table
    pitch = math.ceil(pitch / cutoff) * cutoff

    bx, by = _tile_grid(b)
    origins = np.zeros((b, 2), dtype=np.float32)
    for i in range(b):
        ix, iy = i % bx, i // bx
        origins[i] = (
            (ix - (bx - 1) / 2.0) * pitch,
            (iy - (by - 1) / 2.0) * pitch,
        )

    packed_pos = (pos_all + origins[:, None, :]).reshape(b * n, 2)
    packed_vel = np.concatenate([sc[2] for sc in scenes])
    packed_rad = np.concatenate([sc[3] for sc in scenes])
    packed_phase = np.concatenate([sc[4] for sc in scenes])
    packed_dead = np.concatenate([sc[5] for sc in scenes])

    # grid: the union span in cells + the anchoring margin + separation +
    # growth headroom of the outermost scenes; _check_health re-verifies the
    # span against the grid at every record point
    span_cells = int(
        np.ceil((packed_pos.max(axis=0) - packed_pos.min(axis=0)).max() / cutoff)
    )
    grow_cells = int(math.ceil(2.0 * half * (growth - 1.0) / cutoff)) + 4
    g = span_cells + 2 * EDGE_MARGIN + 2 * _SEP_CELLS + grow_cells
    g = int(math.ceil(g / 16.0)) * 16

    # world box: the union with drift and expansion headroom (not physics:
    # per-scene walls are asserted unreachable by the health check)
    wh = float(np.abs(packed_pos).max()) + max(16.0, 0.25 * pitch)

    pp = params.replace(n_cells=b * n, nx=nx, grid_dim=g, world_half=wh).validate()
    state = make_state(
        pp, packed_pos, packed_vel, packed_rad, packed_phase, packed_dead,
        seed=int(params.seed), device=device,
    )
    if draws is not None:
        state = state.replace(generator=draws(int(params.seed)))
    return pp, state, origins, pitch


def make_packed_phase(pp: SimParams, origins: np.ndarray, pitch: float):
    """The per-scene phase law as the table loop's ``phase_fn(fields, val,
    source, step)``.

    Replicates the reference law (phase from the minimum light distance
    over the scene, particlebot_kernel_impl.cuh:286) per tile:

    * scene assignment is the closed-form tile decode: round the
      union-mean-centred position to the regular origin grid.  Exact
      wherever the assignment-margin health check holds (|pos - u - org_c|
      < pitch/2 per axis, checked at every record point by
      :func:`_check_health`); invalid rows decode to a clipped tile and are
      masked out downstream;
    * the per-scene minimum distance and its broadcast back to the rows run
      in 16-scene column chunks, so the peak memory is (rows, 16) whatever
      B is."""
    org = np.asarray(origins, np.float32)  # (B, 2)
    b = len(org)
    bx, by = _tile_grid(b)
    mox, moy = (float(m) for m in org.mean(axis=0))
    inv_p = f32(1.0 / pitch)

    def phase_fn(f: dict, val: torch.Tensor, source, step: int) -> torch.Tensor:
        px, py = f["px"], f["py"]
        dev = px.device
        w = val.to(torch.float32)
        wsum = torch.clamp(torch.sum(w), min=f32(1.0))
        ux = torch.sum(px * w) / wsum                 # union bot-mean:
        uy = torch.sum(py * w) / wsum                 # common-mode-drift-free
        # tile decode: pos - u compares to org_c = org - mean(org), i.e.
        # pos - u + mean(org) ~ org_i = ((ix - (bx-1)/2) pitch, ...)
        ix = torch.clamp(
            torch.round((px - ux + f32(mox)) * inv_p + f32((bx - 1) / 2.0)), 0, bx - 1
        ).to(torch.int32)
        iy = torch.clamp(
            torch.round((py - uy + f32(moy)) * inv_p + f32((by - 1) / 2.0)), 0, by - 1
        ).to(torch.int32)
        sid = torch.clamp(iy * bx + ix, max=b - 1)
        ox = (ix.to(torch.float32) - f32((bx - 1) / 2.0)) * f32(pitch)
        oy = (iy.to(torch.float32) - f32((by - 1) / 2.0)) * f32(pitch)
        lx, ly = px - ox, py - oy                     # scene-local
        dx = lx - f32(pp.light_x)
        dy = ly - f32(pp.light_y)
        dist = torch.sqrt(dx * dx + dy * dy)
        min_rows = torch.zeros_like(dist)
        iota = torch.arange(b, dtype=torch.int32, device=dev)
        inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        for c0 in range(0, b, _CHUNK):
            ids = iota[c0:c0 + _CHUNK]
            m = (sid[:, None] == ids[None, :]) & val[:, None]
            dmin = torch.amin(torch.where(m, dist[:, None], inf), dim=0)  # scene mins
            dmin = torch.where(torch.isfinite(dmin), dmin, zero)
            min_rows = min_rows + torch.sum(m.to(torch.float32) * dmin[None, :], dim=1)
        pos_local = torch.stack([lx, ly], dim=-1)
        return update_phase(pp, pos_local, f["phase"], val, source,
                            min_d=min_rows, step=step)

    return phase_fn


def _packed_runner(pp: SimParams, origins: np.ndarray, pitch: float):
    """The packed union's chunk runner with the per-scene phase hook: the
    adaptive cadence where the union is large enough for it (as a single
    scene of that size would take), else the fixed-K table loop."""
    phase_fn = make_packed_phase(pp, origins, pitch)
    if pp.adaptive_rebuild():
        return make_adaptive_run_chunk(pp, phase_fn=phase_fn)
    return make_run_chunk_table(pp, phase_fn=phase_fn)


def run_sweep_packed(params: SimParams, seeds: Sequence[int], n_steps: int,
                     record_every: int | None = None, device="cuda", draws=None):
    """Packed-strategy sweep: run_sweep's contract — returns ``(final_state,
    centroids (n_records, n_scenes, 2))`` with centroids in scene-local
    coordinates.  The final state is the packed union (per-scene final
    positions: :func:`unpack_positions`).  Raises RuntimeError when a
    packing invariant failed at a record point (:func:`_check_health`)."""
    params = resolve_params(params.validate())
    pp, state, origins, pitch = pack_scenes(params, seeds, device=device, draws=draws)
    record_every = record_every or params.dump_steps
    run = _packed_runner(pp, origins, pitch)
    seg = gate_seg(pp)
    b, n = len(seeds), params.n_cells
    org = torch.tensor(origins, dtype=torch.float32, device=state.device)

    def stats(s: SimState):
        # centroid + per-scene bounding box per record, all on the device:
        # the boxes feed the isolation and wall checks at every record point
        pos = s.pos[: b * n].reshape(b, n, 2)
        return torch.stack([
            torch.mean(pos, dim=1) - org,
            torch.amin(pos, dim=1),
            torch.amax(pos, dim=1),
        ])

    recs = [stats(state)]
    done = 0
    while done < n_steps:
        chunk = min(record_every, n_steps - done)
        state = run(state, chunk, seg > 0 and done % seg == 0)
        done += chunk
        recs.append(stats(state))
    # one host read for the whole sweep
    centroids, lo, hi = torch.stack(recs, dim=1).cpu().numpy()
    _check_health(params, pp, origins, pitch, centroids, lo, hi)
    return state, centroids


def unpack_positions(state: SimState, origins: np.ndarray, n: int) -> np.ndarray:
    """(B, n, 2) scene-local positions from a packed final state."""
    b = len(origins)
    pos = state.pos.detach().cpu().numpy()[: b * n].reshape(b, n, 2)
    return pos - np.asarray(origins)[:, None, :]


def _check_health(params: SimParams, pp: SimParams, origins: np.ndarray, pitch: float,
                  centroids: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> None:
    """Hard post-run checks of the packing invariants at every record point,
    from the (T, B, 2) per-scene centroid and bounding-box histories:

    1. isolation: every pair of scene boxes stays farther apart than the
       force kernel's pairing reach (no cross-scene pair);
    2. wall fidelity: no scene's local extent reached where its own walls
       (the scene's world_half) would have clamped it;
    3. scene-assignment margin: every scene's box stays within pitch/2 of
       its own origin in the union-mean-centred frame, so the phase hook's
       tile decode was exact;
    4. grid fit: the union span never exceeded the wrapped table's
       anchoring budget (grid_dim - 2*EDGE_MARGIN cells), past which world
       cells alias onto one table cell."""
    cutoff = params.cutoff()
    # 1. pairwise Chebyshev gap between scene boxes in packed coordinates
    gap_x = np.maximum(
        lo[:, :, None, 0] - hi[:, None, :, 0],
        lo[:, None, :, 0] - hi[:, :, None, 0],
    )
    gap_y = np.maximum(
        lo[:, :, None, 1] - hi[:, None, :, 1],
        lo[:, None, :, 1] - hi[:, :, None, 1],
    )
    gap = np.maximum(gap_x, gap_y)  # (T, B, B)
    b = lo.shape[1]
    gap[:, np.arange(b), np.arange(b)] = np.inf
    iso_limit = 2.0 * cutoff
    if (gap < iso_limit).any():
        t, i, j = np.unravel_index(int(np.argmin(gap)), gap.shape)
        raise RuntimeError(
            f"packed sweep isolation violated: scenes {i} and {j} are "
            f"{gap[t, i, j]:.2f} apart at record {t} (< {iso_limit:.2f}, "
            f"pitch {pitch:.2f}); trajectories may include cross-scene "
            f"contacts — rerun with strategy='sequential' or 'batched'"
        )
    # 2. the scene world box: the cfg's, or the >= 64 auto-fit floor a
    # single-scene run would resolve
    scene_wh = params.world_half if params.world_half > 0 else 64.0
    org = np.asarray(origins)[None, :, :]  # (1, B, 2)
    ext = np.maximum(np.abs(lo - org), np.abs(hi - org)).max(axis=-1)  # (T, B)
    wall = scene_wh - 2.0 * params.max_radius
    if (ext >= wall).any():
        t, bad = np.unravel_index(int(np.argmax(ext)), ext.shape)
        raise RuntimeError(
            f"packed sweep wall fidelity violated: scene {bad} local extent "
            f"{ext[t, bad]:.2f} at record {t} reached the scene world box "
            f"±{scene_wh:g} (packed runs have no per-scene walls) — rerun "
            f"with strategy='sequential' or 'batched'"
        )
    # 3. the phase hook's tile decode is exact iff every bot stays within
    # pitch/2 of its own origin per axis in the union-mean-centred frame
    u = (centroids + org).mean(axis=1)  # (T, 2) union bot-mean (equal n)
    org_cc = np.asarray(origins) - np.asarray(origins).mean(axis=0)
    dev = np.maximum(
        np.abs(lo - u[:, None, :] - org_cc[None]),
        np.abs(hi - u[:, None, :] - org_cc[None]),
    ).max(axis=-1)  # (T, B)
    if (dev >= 0.5 * pitch).any():
        t, bad = np.unravel_index(int(np.argmax(dev)), dev.shape)
        raise RuntimeError(
            f"packed sweep scene-assignment margin violated: scene {bad} "
            f"strays {dev[t, bad]:.2f} from its tile origin at record {t} "
            f"(>= pitch/2 = {0.5 * pitch:.2f}); the per-scene phase law may "
            f"have mis-assigned bots — rerun with strategy='sequential' or "
            f"'batched'"
        )
    # 4. the union span against the wrapped table's anchoring budget
    g = pp.resolved_grid_dim()
    span = (hi.max(axis=1) - lo.min(axis=1)).max(axis=-1)  # (T,)
    span_cells = np.ceil(span / cutoff)
    budget = g - 2 * EDGE_MARGIN
    if (span_cells > budget).any():
        t = int(np.argmax(span_cells))
        raise RuntimeError(
            f"packed sweep grid fit violated: union span {span[t]:.2f} "
            f"(= {int(span_cells[t])} cells) at record {t} exceeds the "
            f"wrapped table budget {budget} cells (grid_dim {g} - "
            f"2*EDGE_MARGIN) — world cells would alias; rerun with "
            f"strategy='sequential' or 'batched'"
        )
