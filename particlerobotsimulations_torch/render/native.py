"""The native disk rasterizer and JPEG encoder, built from source at first use.

Port of ``particlerobotsimulations_tpu.render.native``.  The port compiles
its own copy of ``native/raster.cpp`` and ``native/mjpeg.cpp`` with
``g++ -O3 -march=native -fPIC -shared`` into
``particlerobotsimulations_torch/_build/``, named by a hash of the sources,
the flags and the host (``-march=native`` code is built for the CPU it runs
on), and loads it with ``ctypes``.  Nothing is built at import.  There is no
fallback: a failed build raises with the compiler's output.  The numpy
splat (``raster._splat_disks_numpy``) is the plain twin the tests hold
:func:`splat_disks` against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCES = tuple(
    Path(__file__).resolve().parents[2] / "native" / name
    for name in ("raster.cpp", "mjpeg.cpp")
)
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared")

_LIB = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    """The library's path: a hash of the sources, flags and host."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(f"{platform.machine()} {platform.node()}".encode())
    return BUILD_DIR / f"libpbot_render_{h.hexdigest()[:16]}.so"


def build(so: Path) -> None:
    """Compile the sources into ``so`` (written under a temporary name and
    moved in place, so concurrent builds never load a partial file)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found: the native renderer cannot be built")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"building the native renderer failed ({res.returncode}): "
            f"{' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, so)


def load() -> ctypes.CDLL:
    """Build (once per hash) and load the library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = library_path()
    if not so.exists():
        build(so)
    lib = ctypes.CDLL(str(so))
    lib.splat_disks.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, _f32p, _f32p, _f32p, _u8p, ctypes.c_int,
    ]
    lib.splat_disks.restype = None
    lib.encode_jpeg.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_int,
    ]
    lib.encode_jpeg.restype = ctypes.c_int
    lib.path = so
    _LIB = lib
    return lib


def encode_jpeg(rgb: np.ndarray, quality: int = 90) -> bytes:
    """Baseline JPEG bytes of an (h, w, 3) uint8 RGB frame (row 0 = top)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"an RGB frame has 3 channels, got {c}")
    out = np.empty(w * h * 3 + 65536, np.uint8)
    n = load().encode_jpeg(
        rgb.ctypes.data_as(_u8p), w, h, int(quality), out.ctypes.data_as(_u8p), out.size
    )
    if n <= 0:
        raise RuntimeError(f"encode_jpeg failed ({n}) on a {w}x{h} frame")
    return out[:n].tobytes()


def splat_disks(img: np.ndarray, xs, ys, rs, cols) -> None:
    """Paint filled disks (pixel centres and radii) into ``img``, an
    (h, w, 3) uint8 C-contiguous frame, in place, in order."""
    if img.dtype != np.uint8 or img.ndim != 3 or not img.flags.c_contiguous:
        raise ValueError("img must be a C-contiguous (h, w, 3) uint8 array")
    h, w, _ = img.shape
    xs = np.ascontiguousarray(xs, np.float32)
    ys = np.ascontiguousarray(ys, np.float32)
    rs = np.ascontiguousarray(rs, np.float32)
    cols = np.ascontiguousarray(cols, np.uint8).reshape(-1, 3)
    n = len(xs)
    if not (len(ys) == len(rs) == len(cols) == n):
        raise ValueError(f"disk arrays differ in length: {len(xs)}, {len(ys)}, {len(rs)}, {len(cols)}")
    load().splat_disks(
        img.ctypes.data_as(_u8p), h, w,
        xs.ctypes.data_as(_f32p), ys.ctypes.data_as(_f32p), rs.ctypes.data_as(_f32p),
        cols.ctypes.data_as(_u8p), n,
    )
