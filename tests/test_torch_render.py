"""PyTorch port, rendering (``ops/color.py``, ``render/``) against the JAX
package.

* ``bot_colors`` on the state's device against JAX's, with and without the
  shadow dimming: float32 results within 1e-6 (an RGB channel is a few
  float32 operations on values in [0, 1]).
* The 2-D frame from the same positions, radii and colors: equal to JAX's
  frame pixel for pixel (the same numpy raster; the port's disks through
  its native splatter, which equals the numpy splat it is held against).
* The 3-D frame: the port fills polygons with its own even-odd test where
  JAX asks matplotlib.  Both test pixel centres by crossings, so only a
  centre on an edge could fall on different sides; on the scenes' real
  polygons (the ground, the obstacle disks and boxes, from three cameras,
  691,200 centres each) none does, measured, so the masks and the frames
  are held equal.
* An AVI written by the port parses back: frame count, chunk sizes, the
  index, and JPEG start and end markers (MJPG); DIB frames exactly.
"""

import dataclasses
import struct

import jax
import numpy as np
import pytest
import torch
from matplotlib.path import Path as MplPath

import particlerobotsimulations_torch as pt
import particlerobotsimulations_tpu as pj
from particlerobotsimulations_torch.ops.color import bot_colors as t_colors
from particlerobotsimulations_torch.render import native
from particlerobotsimulations_torch.render import raster3d as t_r3
from particlerobotsimulations_torch.render.avi import AviWriter
from particlerobotsimulations_torch.render.raster import _splat_disks_numpy, render_frame
from particlerobotsimulations_torch.render.video import VideoRecorder
from particlerobotsimulations_torch.state import state_from_arrays
from particlerobotsimulations_tpu.ops.color import bot_colors as j_colors
from particlerobotsimulations_tpu.render import raster3d as j_r3
from particlerobotsimulations_tpu.render.raster import render_frame as j_render
from particlerobotsimulations_tpu.render.video import VideoRecorder as JVideoRecorder

torch.set_num_threads(1)

COLOR_ATOL = 1e-6

OBSTACLES = dict(
    circle_obstacles=((1.0, 0.5, 0.6), (-2.5, -1.0, 0.4)),
    rect_obstacles=((2.0, 2.4, -1.5, 1.5), (-1.0, -0.6, 1.2, 2.2)),
)


def to_port(jp):
    return pt.SimParams(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})


def scene(**kw):
    """A JAX scene of 60 bots among obstacles after 30 steps (radii and
    phases spread), and the same state in the port."""
    base = dict(n_cells=60, n_dead=4, time_to_dead=0.1, seed=5, light_x=-6.0,
                light_y=0.5, camera_y=6.0, display_shadow=1, **OBSTACLES)
    base.update(kw)
    jsim = pj.Simulation(pj.SimParams(**base))
    jsim.step_chunk(30)
    arrays = {k: np.asarray(v) for k, v in jax.device_get(jsim.state._asdict()).items()
              if k != "key"}
    tp = to_port(jsim.params)
    return jsim, tp, state_from_arrays(tp, arrays, "cpu")


@pytest.mark.parametrize("shadow", [0, 1])
def test_bot_colors_match_jax(shadow):
    jsim, tp, st = scene(display_shadow=shadow)
    n = tp.n_cells
    want = np.asarray(j_colors(jsim.params, jsim.state.rad[:n], jsim.state.pos[:n],
                               jsim.state.dead[:n]))
    got = t_colors(tp, st.rad[:n], st.pos[:n], st.dead[:n])
    assert got.dtype == torch.float32 and got.device == st.pos.device
    np.testing.assert_allclose(got.numpy(), want, atol=COLOR_ATOL, rtol=0)
    assert (want[st.dead[:n].numpy(), :3] == 0).all()
    if shadow:  # the dimming took effect somewhere
        plain = t_colors(tp.replace(display_shadow=0), st.rad[:n], st.pos[:n], st.dead[:n])
        assert not torch.equal(plain, got)


def test_native_splat_matches_numpy_twin():
    rng = np.random.default_rng(0)
    img_a = np.zeros((64, 96, 3), np.uint8)
    img_b = np.zeros((64, 96, 3), np.uint8)
    xs = rng.uniform(-5, 101, 60).astype(np.float32)
    ys = rng.uniform(-5, 69, 60).astype(np.float32)
    rs = rng.uniform(0.3, 9, 60).astype(np.float32)
    cols = rng.integers(0, 255, (60, 3)).astype(np.uint8)
    native.splat_disks(img_a, xs, ys, rs, cols)
    _splat_disks_numpy(img_b, xs, ys, rs, cols)
    np.testing.assert_array_equal(img_a, img_b)
    assert native.load().path.parent == native.BUILD_DIR


def test_frames_match_jax(tmp_path):
    """The recorder's 2-D frame (colors on the device, the centroid trail)
    equals JAX's recorder frame, and so do the 3-D frames."""
    jsim, tp, st = scene(camera_x=0.5)
    sim = pt.Simulation(tp, state=st, device="cpu")
    jrec = JVideoRecorder(jsim.params, path=str(tmp_path / "j.avi"), width=320, height=240)
    trec = VideoRecorder(tp, path=str(tmp_path / "t.avi"), width=320, height=240)
    want, got = jrec.capture(jsim), trec.capture(sim)
    jrec.close()
    trec.close()
    np.testing.assert_array_equal(got, want)
    n = tp.n_cells
    pos, rad = st.pos[:n].numpy(), st.rad[:n].numpy()
    colors = t_colors(tp, st.rad[:n], st.pos[:n], st.dead[:n]).numpy()
    for cam in ((0.0, 9.0), (7.0, 4.0)):
        jp = jsim.params.replace(camera_x=cam[0], camera_y=cam[1])
        want = j_r3.render_frame_3d(jp, pos, rad, colors, width=320, height=184)
        got = t_r3.render_frame_3d(to_port(jp), pos, rad, colors, width=320, height=184)
        np.testing.assert_array_equal(got, want)
    # and the 2-D renderer alone
    np.testing.assert_array_equal(
        render_frame(tp, pos, rad, colors, width=160, height=120),
        j_render(jsim.params, pos, rad, colors, width=160, height=120),
    )


def test_even_odd_fill_matches_matplotlib():
    """The scene's real polygons (the ground quad, the obstacle disks'
    32-gons and the boxes) from three cameras: the even-odd mask equals
    matplotlib's on every pixel centre."""
    p = pt.SimParams(n_cells=1, n_dead=0, world_half=8.0, **OBSTACLES)
    ys, xs = np.mgrid[0:360, 0:640] + 0.5
    for cam_x, cam_y in ((0.0, 12.0), (8.0, 3.0), (-3.0, 6.0)):
        cam = t_r3._Camera(p.replace(camera_x=cam_x, camera_y=cam_y), 640, 360)
        wh = p.world_half
        polys = [np.array([[-wh, 0, -wh], [-wh, 0, wh], [wh, 0, wh], [wh, 0, -wh]])]
        polys += [t_r3._scene_xyz(t_r3._ring_points(cx, cy, cr), 0.01)
                  for cx, cy, cr in p.circle_obstacles]
        polys += [t_r3._scene_xyz(np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]]), 0.02)
                  for x1, x2, y1, y2 in p.rect_obstacles]
        for pts in polys:
            px, py, _, vis = cam.project(pts)
            assert vis.all()
            poly = np.stack([px, py], axis=-1)
            want = MplPath(poly).contains_points(
                np.stack([xs.ravel(), ys.ravel()], axis=-1)
            ).reshape(xs.shape)
            assert want.any() and not want.all()
            np.testing.assert_array_equal(t_r3._inside_even_odd(poly, xs, ys), want)


def _chunks(data):
    """(fourcc, payload) of every idx1 entry, found through the index."""
    movi = data.find(b"movi")
    idx1 = data.find(b"idx1")
    n = struct.unpack("<I", data[idx1 + 4: idx1 + 8])[0] // 16
    out = []
    for i in range(n):
        ckid, flags, off, size = struct.unpack(
            "<4sIII", data[idx1 + 8 + 16 * i: idx1 + 24 + 16 * i]
        )
        assert flags == 0x10 and data[movi + off: movi + off + 4] == ckid
        assert struct.unpack("<I", data[movi + off + 4: movi + off + 8])[0] == size
        out.append((ckid, data[movi + off + 8: movi + off + 8 + size]))
    return out


@pytest.mark.parametrize("codec", ["MJPG", "DIB "])
def test_avi_roundtrip(tmp_path, codec):
    path = str(tmp_path / "t.avi")
    rng = np.random.default_rng(3)
    frames = []
    for v in (40, 120, 220):
        f = np.full((32, 64, 3), v, np.uint8)
        f[8:16, 8:24] = rng.integers(0, 255, (8, 16, 3), dtype=np.uint8)
        frames.append(f)
    with AviWriter(path, 64, 32, fps=20, codec=codec) as w:
        for f in frames:
            w.write_frame(f)
    data = open(path, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8
    assert struct.unpack("<I", data[48:52])[0] == 3  # avih dwTotalFrames
    chunks = _chunks(data)
    assert len(chunks) == 3
    for (ckid, payload), f in zip(chunks, frames):
        if codec == "MJPG":
            assert ckid == b"00dc"
            assert payload[:2] == b"\xff\xd8" and payload[-2:] == b"\xff\xd9"
            assert len(payload) < f.nbytes
        else:
            assert ckid == b"00db"
            decoded = np.frombuffer(payload, np.uint8).reshape(32, 64, 3)[::-1, :, ::-1]
            np.testing.assert_array_equal(decoded, f)


def test_video_recorder_thins_and_writes(tmp_path):
    """VIDEO_INTERVAL 2: every other capture is skipped before any fetch."""
    p = pt.SimParams(n_cells=12, n_dead=0, seed=2, max_time=5.0, video_interval=2)
    sim = pt.Simulation(p, device="cpu")
    path = str(tmp_path / "v.avi")
    with VideoRecorder(sim.params, path=path, width=160, height=120, style="3d") as rec:
        shots = [rec.capture(sim) for _ in range(3)]
    assert [s is None for s in shots] == [False, True, False]
    data = open(path, "rb").read()
    assert struct.unpack("<I", data[48:52])[0] == 2
