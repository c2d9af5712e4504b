"""Perspective presentation renderer — the reference's 3-D look, headless.

Port of ``particlerobotsimulations_tpu.render.raster3d`` (numpy, copied),
but for the polygon fill: the JAX package tests pixel centres with
matplotlib's ``Path.contains_points``, the port with its own even-odd
(crossing-number) test over the same pixel box (:func:`_inside_even_odd`).

Reproduces the GLUT scene of main.cpp:372-461 +
render.cpp/shaders.cpp without a GL stack:

* world mapping: sim (x, y) -> scene (-x, 0, y); camera at
  (camera_x, camera_y, 0) looking at the origin with up = +z and a 60 deg
  vertical FOV (gluLookAt main.cpp:377-379, gluPerspective main.cpp:519);
* white ground quad spanning +/-64 on the y=0 plane (main.cpp:389-395);
* flat yellow light sphere at (-light_x, ~0, light_y) of ``light_radius``
  (main.cpp:401-405) — flat because the reference never enables GL
  lighting;
* dark gray flat obstacle disks / thin boxes (main.cpp:408-460);
* bots as camera-facing circles with FLAT color sized rad/dist: the
  reference's sphere fragment shader computes diffuse lighting and then
  overwrites it with the plain color (shaders.cpp:84-85), so the faithful
  rendering is a flat disc billboard;
* centroid-trail ring entries as small red ground dots (the reference
  smuggles them through the position VBO with a +2000 z sentinel,
  particlebot_kernel_impl.cuh:345 + shaders.cpp:49-52).

Painter's algorithm: ground, then coplanar scenery, then bots sorted back
to front (reuses the native disk splatter for the billboards).
"""

from __future__ import annotations

import numpy as np

from ..config import SimParams
from . import native
from .raster import BACKGROUND, GROUND, LIGHT, OBSTACLE, TRAIL

FOVY_DEG = 60.0  # gluPerspective(60.0, ...) main.cpp:519


class _Camera:
    """Pinhole camera matching the reference's gluLookAt/gluPerspective."""

    def __init__(self, params: SimParams, width: int, height: int):
        eye = np.array([params.camera_x, params.camera_y, 0.0], np.float64)
        target = np.zeros(3)
        up = np.array([0.0, 0.0, 1.0])
        fwd = target - eye
        n = np.linalg.norm(fwd)
        if n < 1e-9:  # camera at the origin: look along -y
            fwd = np.array([0.0, -1.0, 0.0])
        else:
            fwd = fwd / n
        right = np.cross(fwd, up)
        rn = np.linalg.norm(right)
        if rn < 1e-9:  # looking straight down: pick x as right
            right = np.array([1.0, 0.0, 0.0])
        else:
            right = right / rn
        true_up = np.cross(right, fwd)
        self.eye = eye
        self.basis = np.stack([right, true_up, fwd])  # rows: cam axes
        self.w = width
        self.h = height
        self.f_px = (height / 2.0) / np.tan(np.radians(FOVY_DEG) / 2.0)

    def project(self, pts: np.ndarray):
        """(n, 3) scene points -> (px (n,), py (n,), depth (n,), visible)."""
        rel = (np.asarray(pts, np.float64) - self.eye) @ self.basis.T
        depth = rel[:, 2]
        safe = np.maximum(depth, 1e-6)
        px = self.w / 2.0 + rel[:, 0] / safe * self.f_px
        py = self.h / 2.0 - rel[:, 1] / safe * self.f_px
        return px, py, depth, depth > 0.1  # near plane (main.cpp:519)

    def pixel_radius(self, world_r, depth):
        return np.asarray(world_r) * self.f_px / np.maximum(depth, 1e-6)


def _scene_xyz(sim_xy: np.ndarray, height=0.0) -> np.ndarray:
    """Sim-plane (x, y) -> scene (-x, h, y) (shaders.cpp:46-48)."""
    sim_xy = np.asarray(sim_xy, np.float64)
    out = np.empty((len(sim_xy), 3))
    out[:, 0] = -sim_xy[:, 0]
    out[:, 1] = height
    out[:, 2] = sim_xy[:, 1]
    return out


def _inside_even_odd(poly: np.ndarray, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Boolean mask of the points (xs, ys) inside the closed polygon
    ``poly`` ((k, 2) vertices) by the even-odd rule: a horizontal ray from
    the point crosses the boundary an odd number of times.  An edge counts
    when it straddles the ray's height (half-open in y, so a vertex on the
    ray is counted once) and crosses it right of the point."""
    inside = np.zeros(xs.shape, bool)
    x0, y0 = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    for ax, ay, bx, by in zip(x0, y0, x1, y1):
        if ay == by:
            continue
        straddle = (ay > ys) != (by > ys)
        x_cross = ax + (ys - ay) * (bx - ax) / (by - ay)
        inside ^= straddle & (xs < x_cross)
    return inside


def _fill_polygon(img, cam: _Camera, pts3: np.ndarray, color) -> None:
    """Fill the projection of a planar polygon (an even-odd test of the
    pixel centres over the polygon's pixel bbox)."""
    px, py, _d, vis = cam.project(pts3)
    if not vis.any():
        return
    poly = np.stack([px, py], axis=-1)
    x0 = max(int(np.floor(poly[:, 0].min())), 0)
    x1 = min(int(np.ceil(poly[:, 0].max())) + 1, cam.w)
    y0 = max(int(np.floor(poly[:, 1].min())), 0)
    y1 = min(int(np.ceil(poly[:, 1].max())) + 1, cam.h)
    if x0 >= x1 or y0 >= y1:
        return
    xs, ys = np.meshgrid(
        np.arange(x0, x1) + 0.5, np.arange(y0, y1) + 0.5
    )
    img[y0:y1, x0:x1][_inside_even_odd(poly, xs, ys)] = color


def _ring_points(cx, cy, r, n=32):
    a = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    return np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], axis=-1)


def render_frame_3d(
    params: SimParams,
    pos: np.ndarray,          # (n, 2) sim coords
    rad: np.ndarray,          # (n,)
    colors: np.ndarray,       # (n, 4) float RGBA (ops/color.bot_colors)
    centroid_trail: np.ndarray | None = None,
    width: int = 960,
    height: int = 540,
) -> np.ndarray:
    """(h, w, 3) uint8 perspective frame of the scene."""
    cam = _Camera(params, width, height)
    img = np.empty((height, width, 3), np.uint8)
    img[:] = BACKGROUND

    # ground quad +/-world_half at y=0 (main.cpp:389-394, white)
    wh = params.world_half
    ground = np.array(
        [[-wh, 0, -wh], [-wh, 0, wh], [wh, 0, wh], [wh, 0, -wh]], np.float64
    )
    _fill_polygon(img, cam, ground, GROUND)

    # obstacle disks + thin boxes, dark gray on the ground
    for cx, cy, cr in params.circle_obstacles:
        rim = _ring_points(cx, cy, cr)
        _fill_polygon(img, cam, _scene_xyz(rim, 0.01), OBSTACLE)
    for x1, x2, y1, y2 in params.rect_obstacles:
        quad = np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]], np.float64)
        _fill_polygon(img, cam, _scene_xyz(quad, 0.02), OBSTACLE)

    # light sphere (flat yellow, radius light_radius)
    lp = _scene_xyz(np.array([[params.light_x, params.light_y]]), 0.01)
    lx, ly, ld, lvis = cam.project(lp)
    if lvis[0]:
        pr = float(cam.pixel_radius(params.light_radius, ld[0]))
        native.splat_disks(
            img,
            np.array([lx[0]], np.float32),
            np.array([ly[0]], np.float32),
            np.array([pr], np.float32),
            np.array([LIGHT], np.uint8),
        )

    # centroid trail: small red dots at ground level
    if centroid_trail is not None and len(centroid_trail):
        tp = _scene_xyz(np.asarray(centroid_trail), 0.02)
        tx, ty, td, tvis = cam.project(tp)
        # same dot size as the 2d renderer and the reference
        # (hRad[nCells+i] = centroid_radius, particlebot.cpp:778)
        pr = cam.pixel_radius(params.centroid_radius, td)
        keep = tvis & (pr > 0.3)
        if keep.any():
            cols = np.broadcast_to(
                np.asarray(TRAIL, np.uint8), (int(keep.sum()), 3)
            )
            native.splat_disks(
                img,
                tx[keep].astype(np.float32),
                ty[keep].astype(np.float32),
                np.maximum(pr[keep], 0.8).astype(np.float32),
                np.ascontiguousarray(cols),
            )

    # bots: flat-color billboards, painter-sorted back to front
    pts = _scene_xyz(pos, 0.0)
    bx, by, bd, bvis = cam.project(pts)
    pr = cam.pixel_radius(np.asarray(rad, np.float64), bd)
    keep = bvis & (pr > 0.2)
    if keep.any():
        order = np.argsort(-bd[keep])
        rgb = (np.clip(np.asarray(colors)[:, :3], 0.0, 1.0) * 255).astype(
            np.uint8
        )
        native.splat_disks(
            img,
            bx[keep][order].astype(np.float32),
            by[keep][order].astype(np.float32),
            pr[keep][order].astype(np.float32),
            np.ascontiguousarray(rgb[keep][order]),
        )
    return img
