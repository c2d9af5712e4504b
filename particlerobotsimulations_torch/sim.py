"""High-level simulation front end — the app layer.

Port of ``particlerobotsimulations_tpu.sim``: scenario setup from a
``.cfg``, the step loop in dump-interval chunks, CSV metrics, the health
checks, checkpoints, CSV resume and the frame hook that video recording
(``render.VideoRecorder``) uses.
"""

from __future__ import annotations

import os
import warnings
from math import gcd
from typing import Callable, Optional

import numpy as np
import torch

from .config import ForceBackend, SimParams, load_cfg
from .engine import make_run_chunk
from .io.checkpoint import load_checkpoint, save_checkpoint
from .io.csvio import CsvDumper, load_last_row
from .models.placement import initial_state_arrays
from .state import SimState, make_state
from .utils import trace


class Simulation:
    """Owns params + state and drives the step loop on one device.

    Typical use::

        sim = Simulation.from_cfg("examples/example.cfg", device="cuda")
        sim.run()                      # full scenario, CSV to params.csv_filename
    """

    def __init__(
        self,
        params: SimParams,
        state: Optional[SimState] = None,
        device="cuda",
    ):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        if state is None:
            params, pos, vel, rad, phase, dead = initial_state_arrays(params)
            state = make_state(params, pos, vel, rad, phase, dead, device=device)
        elif params.world_half == 0:
            # auto-fit from the restored state's active rows: padding rows
            # sit at the world corner after one step and must not widen it
            from .models.placement import autofit_world_half

            p_act = state.pos[: params.n_cells].cpu().numpy()
            params = autofit_world_half(params, p_act)
        self.params = params
        self.device = device
        self.state = state
        self.backend = params.validate().resolved_backend(device)
        self._run_chunk = make_run_chunk(params, device)
        from .engine_table import gate_seg

        self._gate_seg = (
            gate_seg(params.validate()) if self.backend == ForceBackend.PALLAS else 0
        )
        pos = state.pos[: params.n_cells].cpu().numpy()
        span = float(np.abs(pos).max()) if pos.size else 0.0
        if span >= params.world_half:
            # the integrator clamps at +-world_half exactly like the
            # reference, so bots placed outside the box pile up at the walls
            raise ValueError(
                f"initial swarm spans +-{span:.1f} but world_half="
                f"{params.world_half:g}: bots outside the box would be "
                "clamped to the walls every step — raise the world_half "
                "cfg key, or set world_half 0 to auto-fit the placement"
            )
        if self.backend == ForceBackend.PALLAS:
            # the table loop's edge-guard invariant only holds when the
            # swarm FITS the grid
            self._check_grid_fits(pos, raise_init=True)

    # ------------------------------------------------------- constructors

    @classmethod
    def from_cfg(cls, path: str, base: SimParams | None = None, device="cuda",
                 **overrides):
        params = load_cfg(path, base=base)
        if overrides:
            params = params.replace(**overrides)
        return cls(params, device=device)

    @classmethod
    def from_checkpoint(cls, path: str, device="cuda", draws=None):
        """Continue from a checkpoint (``io.checkpoint``, either package's);
        ``draws`` as ``load_checkpoint`` takes it."""
        params, state = load_checkpoint(path, device, draws)
        return cls(params, state=state, device=device)

    @classmethod
    def resume_from_csv(cls, params: SimParams, csv_path: str, device="cuda"):
        """Continue from the last complete CSV row (reference ``cont`` mode,
        main.cpp:941-956; the CSV needs ``testing=1``).  Phase and dead
        flags are not in the CSV, as in the reference: prefer
        checkpoints."""
        row = load_last_row(params, csv_path)
        if row is None:
            return cls(params, device=device)
        t, pos, vel, rad = row
        if params.n_dead > 0 and t >= params.time_to_dead:
            warnings.warn(
                f"CSV resume at t={t:g}s is at/past time_to_dead="
                f"{params.time_to_dead:g}s: the CSV stores no dead flags "
                f"(reference fidelity, particlebot.cpp:369-411) and the "
                f"one-shot injection step is already behind the resumed "
                f"counter, so the continued run has ZERO dead bots instead "
                f"of the {params.n_dead} the original run killed. Use "
                f"checkpoints (Simulation.from_checkpoint) for exact "
                f"continuation.",
                stacklevel=2,
            )
        sim = cls(params, device=device)  # placement sets dead flags / payload
        n = params.n_cells

        def put(a, rows):
            out = a.clone()
            out[:n] = torch.as_tensor(np.asarray(rows, np.float32), device=a.device)
            return out

        sim.state = sim.state.replace(
            pos=put(sim.state.pos, pos),
            vel=put(sim.state.vel, vel),
            rad=put(sim.state.rad, rad),
            step=int(round(t / params.timestep)),
        )
        return sim

    # ------------------------------------------------------------ stepping

    @property
    def time(self) -> float:
        return self.state.step * self.params.timestep

    def host_view(self):
        """(pos, vel, rad) host copies, unpadded; a ``sim.host_view`` span
        where tracing is on (``utils/trace``)."""
        n = self.params.n_cells
        parts = (self.state.pos[:n], self.state.vel[:n], self.state.rad[:n])
        if not trace.ON:
            return tuple(t.cpu().numpy() for t in parts)
        with trace.span("sim.host_view", parts[0].device,
                        bytes=sum(t.numel() * t.element_size() for t in parts)):
            return tuple(t.cpu().numpy() for t in parts)

    def centroid(self) -> np.ndarray:
        pos, _, _ = self.host_view()
        return pos.mean(axis=0)

    def step_chunk(self, n_steps: int, start_step: int | None = None):
        """Advance ``n_steps``.  A chunk entered on a gate-segment boundary
        (``start_step`` known to the caller) is passed as seg-aligned, which
        lets the adaptive runner probe its cadence."""
        aligned = (
            self._gate_seg > 0
            and start_step is not None
            and start_step % self._gate_seg == 0
        )
        self.state = self._run_chunk(self.state, n_steps, aligned)

    def health(self) -> dict:
        """Runtime diagnostics: finite state, velocity sanity and the
        cell-capacity overflow counter (dropped contacts)."""
        from .ops.pallas_stencil import assign_slots_slotmajor
        from .state import active_mask

        n = self.params.n_cells
        pos, vel, rad = self.host_view()
        out = {
            "finite": bool(np.isfinite(pos).all() and np.isfinite(vel).all()),
            "max_speed": float(np.linalg.norm(vel, axis=1).max()),
            "min_pair_distance": None,
            "cell_overflow": 0,
        }
        if n <= 4096:
            d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
            np.fill_diagonal(d, np.inf)
            out["min_pair_distance"] = float(d.min())
        if self.backend != ForceBackend.DENSE:
            mask = active_mask(self.params, self.state.n_pad, self.device)
            _, overflow = assign_slots_slotmajor(self.params, self.state.pos, mask)
            out["cell_overflow"] = int(overflow.item())
        return out

    def _check_grid_fits(
        self, pos: np.ndarray, raise_init: bool = False, step_count: int = 0
    ) -> None:
        """Raise when the swarm spans more wrapped-grid cells than the table
        can hold without aliasing (PALLAS table loop only): a swarm wider
        than grid_dim - 2*EDGE_MARGIN cells would wrap around the table and
        corrupt the candidate set."""
        from .ops.table_rebuild import EDGE_MARGIN

        if self.backend != ForceBackend.PALLAS:
            return
        ok = np.isfinite(pos).all(axis=1)
        if not ok.any():
            return
        p = pos[ok]
        cutoff = self.params.cutoff()
        spanned = (
            int((np.floor(p.max(axis=0) / cutoff) - np.floor(p.min(axis=0) / cutoff)).max())
            + 1
        )
        g = self.params.resolved_grid_dim()
        if spanned > g - 2 * EDGE_MARGIN:
            where = (
                "initial state"
                if raise_init
                else f"t={step_count * self.params.timestep:g}s"
            )
            raise ValueError(
                f"swarm spans {spanned} grid cells at {where} but grid_dim="
                f"{g} leaves only {g - 2 * EDGE_MARGIN} usable (EDGE_MARGIN="
                f"{EDGE_MARGIN} wrapped edge columns must stay empty): the "
                f"neighbor table would alias cells. Raise grid_dim (cfg key) "
                f"or leave it 0 (auto)."
            )

    def _check_cell_overflow(self, pos: np.ndarray, step_count: int) -> None:
        """Warn (once) when physical cell occupancy exceeds cell_capacity:
        the slot table drops the excess bots' contacts, unlike the
        reference's uncapped neighbor loops."""
        if self.backend == ForceBackend.DENSE:
            return
        if getattr(self, "_overflow_warned", False):
            return
        n = self.params.n_cells
        p = pos[:n]
        ok = np.isfinite(p).all(axis=1) & (np.abs(p) <= self.params.world_half).all(
            axis=1
        )
        p = p[ok]
        if p.size == 0:
            return
        bins = np.floor(p / self.params.cutoff()).astype(np.int64)
        _, counts = np.unique(bins, axis=0, return_counts=True)
        max_occ = int(counts.max())
        if max_occ > self.params.cell_capacity:
            import warnings

            self._overflow_warned = True
            warnings.warn(
                f"cell occupancy {max_occ} exceeds cell_capacity="
                f"{self.params.cell_capacity} at t="
                f"{step_count * self.params.timestep:g}s: the neighbor table "
                f"drops the excess bots' contacts. Raise cell_capacity (cfg "
                f"key) or lower the density.",
                RuntimeWarning,
                stacklevel=3,
            )

    def run(
        self,
        max_time: float | None = None,
        csv_path: str | None = None,
        echo: bool = True,
        checkpoint_path: str | None = None,
        checkpoint_every_dumps: int = 0,
        frame_callback: Optional[Callable[["Simulation"], None]] = None,
        frame_every_steps: int | None = None,
        append_csv: bool = False,
        health_check: bool = True,
    ):
        """Run to ``max_time`` (params.max_time by default), dumping CSV rows
        every ``dump_interval``.  Like the reference, the dump comes before
        the step (main.cpp:359 vs 361): row t=0 is the initial condition and
        the last row is at the final dump boundary <= max_time.

        ``checkpoint_path`` gets a checkpoint every ``checkpoint_every_dumps``
        dumps (0: none) and one at the end.  ``frame_callback(sim)`` fires
        every ``frame_every_steps`` steps (default ``params.display_interval``,
        the reference's frame cadence, main.cpp:370); the chunks then end on
        the finer grid ``gcd(dump, frame)``.  ``append_csv`` appends to
        ``csv_path``, with no header and no row at the resume step when the
        file already has content."""
        p = self.params
        total_steps = int(round(
            (p.max_time if max_time is None else max_time) / p.timestep
        ))
        dump_steps = p.dump_steps
        csv_path = csv_path or p.csv_filename
        if frame_every_steps is None:
            frame_every_steps = p.display_interval
        frame_every_steps = max(1, frame_every_steps)
        stride = (
            gcd(dump_steps, frame_every_steps) if frame_callback is not None
            else dump_steps
        )
        # on append, a target that already has content has its header and
        # the row at the resume step; a missing or empty one gets both
        has_content = (
            append_csv and os.path.exists(csv_path) and os.path.getsize(csv_path) > 0
        )

        with open(csv_path, "a" if append_csv else "w", encoding="utf-8") as out:
            dumper = CsvDumper(p, out, echo=echo)
            dumper._wrote_header = has_content
            done = start_step = self.state.step
            dumps_done = 0

            def boundary(step_count):
                nonlocal dumps_done
                resume_row = has_content and step_count == start_step
                if step_count % dump_steps == 0 and not resume_row:
                    pos, vel, rad = self.host_view()
                    if health_check:
                        self._check_grid_fits(pos, step_count=step_count)
                        self._check_cell_overflow(pos, step_count)
                        if not (np.isfinite(pos).all() and np.isfinite(vel).all()):
                            raise RuntimeError(
                                f"simulation diverged by t="
                                f"{step_count * p.timestep:g}s (non-finite "
                                f"positions/velocities); see Simulation.health()"
                            )
                    dumper.dump(step_count * p.timestep, pos, vel, rad)
                    dumps_done += 1
                    if (
                        checkpoint_path
                        and checkpoint_every_dumps
                        and dumps_done % checkpoint_every_dumps == 0
                    ):
                        save_checkpoint(checkpoint_path, p, self.state)
                if frame_callback is not None and (
                    resume_row or step_count % frame_every_steps == 0
                ):
                    frame_callback(self)

            boundary(done)
            while done < total_steps:
                # a start off the stride grid first steps up to the next
                # boundary, so dumps and frames stay on the absolute grid
                chunk = stride - done % stride if done % stride else stride
                chunk = min(chunk, total_steps - done)
                self.step_chunk(chunk, start_step=done)
                done += chunk
                boundary(done)
            if checkpoint_path:
                save_checkpoint(checkpoint_path, p, self.state)
        return self
