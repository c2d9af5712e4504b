"""Small-table megakernel: one ungated span between two slot rebuilds in
one launch (kernel 3).

Port of ``particlerobotsimulations_tpu.ops.megakernel``.  Below ~1.2k bots
the table loop's step is a few hundred microseconds of host dispatch for
microseconds of device work; a span runs the whole rebuild-to-rebuild
stretch of k steps in one launch instead.  The span is cut around the
rebuild::

    span(b) = post(b-1), pre(b), post(b), ..., post(b+k-2), pre(b+k-1)

so the caller (``engine_table.make_run_chunk_table``) chains span, slot
rebuild, span, ..., and the rebuild between spans is the regular path's
compaction (kernel 2).  Only ungated steps run in a span: they draw no
random numbers and never touch the centroid ring, so a span's carry is the
table planes, the parking-strip planes and the step.

:func:`make_mega_span` sends a CUDA tensor to the hand-written kernel
(``csrc/mega_span.cu``) and a CPU tensor to the plain twin
:func:`mega_span_plain`, which is built from the regular path's own ops
and the plain pair stencil (never kernel 1), so it shares no CUDA code
with the kernel it checks.
"""

from __future__ import annotations

import torch

from ..config import ForceBackend, SimParams, padded_n
from ..state import TABLE_FIELDS, sim_time
from .forces import friction_velocity_update_xy, obstacle_forces_xy
from .integrate import radius_integrate_planes
from .pallas_stencil import stencil_forces_plain

# table-row budget: G=16 at capacity 16.  The JAX package's limit, set by
# the TPU's VMEM; kept until a measurement on the card moves it, so that
# the two packages take the span path on the same scenes.
MAX_ROWS = 1 << 12


def mega_eligible(params: SimParams) -> bool:
    """Whether the table-resident chunk loop may use the span path: the
    PALLAS backend (AUTO resolved for the card), a table and a parking
    strip of at most ``MAX_ROWS`` rows each, no overflow spill rows, and
    K <= 8."""
    p = params
    if p.resolved_backend() != ForceBackend.PALLAS:
        return False
    g = p.resolved_grid_dim()
    if g * g * p.storage_capacity() > MAX_ROWS:
        return False
    if padded_n(p) > MAX_ROWS:
        return False
    if p.resolved_overflow_slots() != 0:
        return False
    return max(1, p.resolved_slot_rebuild_steps()) <= 8


def mega_span_plain(params: SimParams, tbl: torch.Tensor, strip: torch.Tensor,
                    step: torch.Tensor):
    """Plain PyTorch twin of kernel 3: (tbl', strip') after one span from
    mid-step ``step - 1``.  ``tbl`` is (N_TF, C, G*G), ``strip`` (N_TF,
    n_pad//128, 128), both in TABLE_FIELDS order; ``step`` a 0-dim int64
    tensor on their device, as the kernel takes it (each step's time is
    ``state.sim_time`` of it).  Parking-strip rows get no pair
    force: their aa and ar are zeroed, then obstacles and friction run
    with zero pair force."""
    p = params.validate()
    k = max(1, p.resolved_slot_rebuild_steps())
    dt = p.timestep
    has_obstacles = bool(p.circle_obstacles or p.rect_obstacles)
    names = ("px", "py", "vx", "vy", "rad") + (("afac",) if p.has_payload else ())
    d = {kf: tbl[j] for j, kf in enumerate(TABLE_FIELDS)}
    s = {kf: strip[j] for j, kf in enumerate(TABLE_FIELDS)}
    zero = torch.zeros((), dtype=torch.float32, device=tbl.device)
    for j in range(k):
        # post(step + j - 1)
        fx, fy, d["aa"], d["ar"] = stencil_forces_plain(p, {n: d[n] for n in names})
        s["aa"] = torch.zeros_like(s["aa"])
        s["ar"] = torch.zeros_like(s["ar"])
        sfx = sfy = torch.zeros_like(s["px"])
        if has_obstacles:
            for e in (d, s):
                ofx, ofy, om = obstacle_forces_xy(
                    p, e["px"], e["py"], e["vx"], e["vy"], e["rad"]
                )
                e["ar"] = e["ar"] + om
                if e is d:
                    fx, fy = fx + ofx, fy + ofy
                else:
                    sfx, sfy = ofx, ofy
        for e, ex, ey in ((d, fx, fy), (s, sfx, sfy)):
            nvx, nvy = friction_velocity_update_xy(
                p, e["vx"], e["vy"], ex, ey, e["pay"] > 0.5, dt
            )
            val = e["val"] > 0.5
            e["vx"] = torch.where(val, nvx, zero)
            e["vy"] = torch.where(val, nvy, zero)
        # pre(step + j)
        time = sim_time(step + j, dt)
        d = radius_integrate_planes(p, d, time)
        s = radius_integrate_planes(p, s, time)
    return (
        torch.stack([d[kf] for kf in TABLE_FIELDS]),
        torch.stack([s[kf] for kf in TABLE_FIELDS]),
    )


def mega_span_batched_plain(params: SimParams, tbl: torch.Tensor,
                            strip: torch.Tensor, step: torch.Tensor):
    """Plain twin of kernel 3's batched form: :func:`mega_span_plain` on
    each scene of (B, N_TF, C, G*G) tables and (B, N_TF, n_pad//128, 128)
    strips, stacked."""
    outs = [mega_span_plain(params, tbl[b], strip[b], step) for b in range(tbl.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def make_mega_span(params: SimParams, n_pad: int):
    """Returns ``span(tbl, strip, step) -> (tbl', strip')``.

    tbl: (N_TF, C, G*G) float32 table planes; strip: (N_TF, n_pad//128,
    128) parking-strip planes; step: the first step of the k-step rebuild
    block this span belongs to, a 0-dim int64 tensor on their device (an
    int is made one), which kernel 3 reads on the card.  The input must be mid-step
    ``step - 1`` (after integrate and rebuild): the span opens with the
    carried-over ``post(step - 1)``, runs k-1 full steps, and ends mid-step
    ``step + k - 1`` after integrate.  The caller then runs the slot
    rebuild and either the next span or, at the segment end, the regular
    path's ``step_post``.  A leading scene axis on both (the batched loop's
    scenes in lockstep) runs every scene's span.  CUDA tensors launch
    kernel 3 once for all scenes (or raise), CPU tensors take
    :func:`mega_span_plain` per scene."""
    p = params.validate()
    if n_pad % 128:
        raise ValueError(f"n_pad must be a multiple of 128, got {n_pad}")

    def span(tbl: torch.Tensor, strip: torch.Tensor, step):
        if strip.shape[-2] * 128 != n_pad:
            raise ValueError(f"strip: expected {n_pad} rows, got {tuple(strip.shape)}")
        kind, batched = tbl.device.type, tbl.dim() == 4
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"mega span: unsupported device {tbl.device}")
        if not torch.is_tensor(step):
            step = torch.full((), int(step), dtype=torch.int64, device=tbl.device)
        if kind == "cuda":
            from ..kernels import mega_span_batched_cuda, mega_span_cuda

            fn = mega_span_batched_cuda if batched else mega_span_cuda
            return fn(p, tbl, strip, step)
        fn = mega_span_batched_plain if batched else mega_span_plain
        return fn(p, tbl, strip, step)

    return span
