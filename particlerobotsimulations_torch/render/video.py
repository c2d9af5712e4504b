"""Video recording hook for Simulation runs.

Port of ``particlerobotsimulations_tpu.render.video``.  Replicates the
reference's cadence: a frame is *displayed* every ``DISPLAY_INTERVAL``
physics steps (main.cpp:370, default 600) and every ``VIDEO_INTERVAL``-th
displayed frame is written to the AVI at 20 FPS (postprocess.cu:99-116).
The recorder is a ``Simulation.run`` frame callback: one frame per
:meth:`VideoRecorder.capture`.  Colors are computed on the state's device
(``ops/color.bot_colors``); positions, radii, colors and the centroid ring
then come to the host with one copy each.
"""

from __future__ import annotations

from ..config import SimParams
from ..ops.color import bot_colors
from .avi import AviWriter
from .raster import render_frame


class VideoRecorder:
    def __init__(
        self,
        params: SimParams,
        path: str | None = None,
        # reference default geometry: 1920x1080 @ 20 FPS (main.cpp:65,
        # postprocess.cu:102)
        width: int = 1920,
        height: int = 1080,
        fps: int = 20,
        codec: str = "MJPG",
        quality: int = 90,
        style: str = "2d",
    ):
        """style: "2d" top-down orthographic (default) or "3d" — the
        reference's perspective presentation look (render/raster3d.py)."""
        if style not in ("2d", "3d"):
            raise ValueError(f"unknown style {style!r}")
        self.params = params
        self.path = path or params.video_filename
        self.writer = AviWriter(
            self.path, width, height, fps=fps, codec=codec, quality=quality
        )
        self.width = width
        self.height = height
        self.style = style
        self._frame_idx = 0

    def capture(self, sim):
        """Render + append one frame from a Simulation's current state.

        Returns the frame, or None on a thinned call: with
        VIDEO_INTERVAL > 1 (reference: postprocess.cu:113) the skipped
        frames cost neither the device fetch nor the raster pass."""
        p = self.params
        idx = self._frame_idx
        self._frame_idx += 1
        if idx % max(1, p.video_interval) != 0:
            return None
        n = p.n_cells
        state = sim.state
        pos = state.pos[:n]
        rad = state.rad[:n]
        colors = bot_colors(p, rad, pos, state.dead[:n]).cpu().numpy()
        ring = state.centroid_ring.cpu().numpy()
        trail = ring[ring[:, 0] > -4000.0]  # drop unwritten sentinel slots
        if self.style == "3d":
            from .raster3d import render_frame_3d as _render
        else:
            _render = render_frame
        frame = _render(
            p,
            pos.cpu().numpy(),
            rad.cpu().numpy(),
            colors,
            centroid_trail=trail,
            width=self.width,
            height=self.height,
        )
        self.writer.write_frame(frame)
        return frame

    def close(self):
        self.writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
