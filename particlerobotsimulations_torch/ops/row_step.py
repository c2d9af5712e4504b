"""The table loop's per-row step glue: the row step.

Around the pair kernel the table loop runs elementwise glue on its field
planes (``engine_table``'s step parts): after kernel 1, the pair sums
padded with zeros to every row, obstacles, stick-slip friction and the
validity mask (post); before it, the radius controller and integrate with
the world-boundary clamp (pre).  :func:`row_step` runs ``"post"``,
``"pre"`` or ``"post_pre"`` (post of step s, then pre of step s + 1) on a
single scene's ``(total_ext,)`` planes or B scenes' ``(B, total_ext)``:
CUDA tensors go to the hand-written kernel (``csrc/row_step.cu``, one
launch), CPU tensors to the plain twin :func:`row_step_plain`, the PyTorch
ops the JAX package's step runs, which the kernel equals bit for bit.
"""

from __future__ import annotations

import torch

from ..config import SimParams
from ..state import sim_time, table_geometry
from .forces import friction_velocity_update_xy, obstacle_forces_xy
from .integrate import radius_integrate_planes

MODES = ("post", "pre", "post_pre")


def _post_plain(params: SimParams, f: dict, fx, fy, fa, fr) -> dict:
    """Post on the planes ``f`` (mutated and returned): kernel 1's sums of
    the first C*G*G rows padded with zeros over the spill rows and the
    parking strip, obstacles, friction, then vx = vy = 0 off valid rows."""
    _, total_ext, _ = table_geometry(params)
    force_total = params.resolved_grid_dim() ** 2 * params.cell_capacity
    lead = f["px"].shape[:-1]
    zpad = torch.zeros(
        lead + (total_ext - force_total,), dtype=torch.float32, device=fx.device
    )

    def flat(t):
        return torch.cat([t.reshape(lead + (force_total,)), zpad], dim=-1)

    fxf, fyf = flat(fx), flat(fy)
    f["aa"], f["ar"] = flat(fa), flat(fr)

    val_r = f["val"] > 0.5
    if params.circle_obstacles or params.rect_obstacles:
        ofx, ofy, m_obs = obstacle_forces_xy(
            params, f["px"], f["py"], f["vx"], f["vy"], f["rad"]
        )
        fxf = fxf + ofx
        fyf = fyf + ofy
        f["ar"] = f["ar"] + m_obs

    nvx, nvy = friction_velocity_update_xy(
        params, f["vx"], f["vy"], fxf, fyf, f["pay"] > 0.5, params.timestep
    )
    zero = torch.zeros((), dtype=torch.float32, device=nvx.device)
    f["vx"] = torch.where(val_r, nvx, zero)
    f["vy"] = torch.where(val_r, nvy, zero)
    return f


def row_step_plain(params: SimParams, fields: dict, mode: str, step=None,
                   offset: int = 0, forces=None) -> dict:
    """Plain PyTorch twin of the row step: the planes after ``mode`` as a
    new dict (``fields`` is not changed).  ``forces``: kernel 1's (fx, fy,
    fa, fr), each ``([B,] C, G*G)``, for the modes that post; ``step``: a
    0-dim int64 tensor on the planes' device, the pre at the sim time of
    ``step + offset`` (``state.sim_time``)."""
    if mode not in MODES:
        raise ValueError(f"row_step: mode {mode!r} not in {MODES}")
    f = dict(fields)
    if mode != "pre":
        f = _post_plain(params, f, *forces)
    if mode != "post":
        at = step if offset == 0 else step + offset
        f = radius_integrate_planes(params, f, sim_time(at, params.timestep))
    return f


def row_step(params: SimParams, fields: dict, mode: str, step=None, offset: int = 0,
             forces=None) -> dict:
    """:func:`row_step_plain`'s result: one launch of the row-step kernel
    on CUDA tensors (``kernels.row_step_cuda``, or raise), the twin on CPU
    tensors."""
    kind = fields["px"].device.type
    if kind == "cuda":
        from ..kernels import row_step_cuda

        return row_step_cuda(params, fields, mode, step, offset, forces)
    if kind == "cpu":
        return row_step_plain(params, fields, mode, step, offset, forces)
    raise ValueError(f"row_step: unsupported device {fields['px'].device}")
