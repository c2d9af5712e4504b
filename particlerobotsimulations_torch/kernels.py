"""Build, load and launch the hand-written CUDA kernels.

The sources in ``csrc/*.cu`` have a plain C interface (no PyTorch headers)
and share ``csrc/*.cuh``.  On first use each ``.cu`` is compiled by its own
``nvcc`` for Hopper (``sm_90a``), all at once, and the objects are linked
into one shared library under ``_build/``, named by a hash of the sources,
headers and flags, and loaded with ``ctypes``.  Nothing is built when this
module is imported.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream, raises
if ``cudaGetLastError`` reports a failed launch, and adds one to its entry
in :data:`LAUNCHES`.  There is no fallback: a missing ``nvcc``, a failed
build or a failed launch raises.  The plain PyTorch twins that CPU tensors
use live beside their callers (``ops/pallas_stencil.py``,
``ops/table_rebuild.py``, ``ops/megakernel.py``).  Kernels 4 and 2's
padded form take the shards one process holds in one launch; kernels 1 and
4 are one tiled body in ``csrc/stencil_forces.cu``.  Kernels 1, 2 (wrap
form) and 3 also take every scene of a batched table loop in one launch
(the ``*_batched_cuda`` wrappers, one count per launch whatever the number
of scenes); a single scene is the same entry point with one scene.  Kernels
4 and 2's padded form take the dp x tp loop's shard-major (S, B, ...)
stacks as S x B blocks in one launch (``stencil_forces_ext_batched_cuda``,
``compact_padded_batched_cuda``), each block as its own single launch.
``csrc/graph_cond.cu`` replaces no ``pallas_call``: its kernel ``cond_set``
and host entry points (:func:`cond_node`, :func:`while_node`,
:func:`set_conditional`, :func:`begin_body`, :func:`end_body`) build the
conditional IF and WHILE nodes through which ``ops/cond.py`` carries the
JAX package's ``lax.cond`` s (the incremental-or-exact rebuild, the span
segment's adopt-or-redo) and the redone segment's ``lax.scan`` into a
captured CUDA graph.  ``csrc/row_step.cu`` replaces no ``pallas_call``
either: the row step (:func:`row_step_cuda`) runs the table loop's
elementwise step glue (post: obstacles, friction and validity after kernel
1; pre: the radius controller and integrate; or the two in turn) in one
launch, with kernel 3's row arithmetic (``csrc/row_step.cuh``).  Nor does
``csrc/dense_step.cu``: the dense step (:func:`dense_step_cuda`) runs the
per-bot DENSE step's radius controller, integrate, all-pairs forces,
obstacles and friction of B scenes in one launch, with the same row
arithmetic.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections.abc import MutableMapping
from pathlib import Path

import numpy as np
import torch

from .config import SimParams, padded_n
from .utils import trace

class LaunchCounts(MutableMapping):
    """Launches per kernel: the main path's callers read these to show
    that a run went through the kernels.

    A wrapper counts its launch on the host (:meth:`count`, no read).  A
    CUDA graph replay counts the launches it always runs the same way; a
    conditional node's body runs only on the replays that take it, so its
    launches are counted per run of a 0-dim int64 device counter that the
    body increments (:meth:`defer`), and settled when a count is read:
    reading a count that a body holds copies those counters to the host
    (it waits for the card), as reading ``engine_table.REBUILDS`` does.
    Setting a count (to 0, say) sets what it reads from then on."""

    def __init__(self, names):
        self._host = dict.fromkeys(names, 0)
        self._deferred = []  # (launches per run of the counter, counter)

    def count(self, name: str, n: int = 1) -> None:
        self._host[name] += n

    def defer(self, launches: dict, counter) -> None:
        """Count ``launches`` once more each time ``counter`` grows by 1."""
        if any(launches.values()):
            self._deferred.append((dict(launches), counter))

    def host_counts(self) -> dict:
        """The counts on the host, deferred counts left out (no read)."""
        return dict(self._host)

    def restore(self, host: dict) -> None:
        """Put back counts :meth:`host_counts` took (no read)."""
        self._host.update(host)

    def _settled(self, name: str) -> int:
        return sum(c[name] * int(t) for c, t in self._deferred if c.get(name))

    def __getitem__(self, name: str) -> int:
        return self._host[name] + self._settled(name)

    def __setitem__(self, name: str, value: int) -> None:
        if name not in self._host:
            raise KeyError(name)
        self._host[name] = int(value) - self._settled(name)

    def __delitem__(self, name):
        raise TypeError("the launch counts have fixed keys")

    def __iter__(self):
        return iter(self._host)

    def __len__(self) -> int:
        return len(self._host)

    def __repr__(self) -> str:
        return repr(dict(self))


LAUNCHES = LaunchCounts((
    "stencil_forces", "compact", "mega_span",
    "stencil_forces_ext", "compact_padded",
    "stencil_forces_batched", "compact_batched", "mega_span_batched",
    "stencil_forces_ext_batched", "compact_padded_batched",
    "cond_set", "row_step", "row_step_batched", "dense_step", "dense_step_batched",
))
trace.register("launches", LAUNCHES)

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

# Launch geometry, mirrored from the sources: kernels 1 and 4
# (stencil_forces.cu) run one block per STENCIL_TILE x STENCIL_TILE tile of
# cells; kernel 3 (mega_span.cu) one cluster of up to MEGA_MAX_CLUSTER CTAs.
# All three keep occupancy in MASK_BITS-bit words: kernels 1 and 4
# ceil(C / MASK_BITS) words per cell, for any C whose shared memory fits a
# block; kernel 3 one word, so C <= MASK_BITS (its tables never pass 16).
# Kernel 2 (compact.cu) runs one block per COMPACT_LANES target lanes, one
# thread per (slot of a COMPACT_WINDOW-slot window, lane), for any Cs.
STENCIL_TILE, STENCIL_THREADS, STENCIL_TERM_CAP = 2, 256, 4096
COMPACT_LANES, COMPACT_WINDOW = 16, 32
COMPACT_THREADS = COMPACT_LANES * COMPACT_WINDOW
MEGA_THREADS, MEGA_TERM_CAP, MEGA_MAX_CLUSTER = 512, 8192, 16
MEGA_MAX_ROWS, MEGA_STATIC_SMEM = 4096, 4 * (4 * 10 + 3 * 10)
MASK_BITS = 32
# shared memory a block may opt into on Hopper: 227 KB
SMEM_PER_BLOCK = 232_448

_lib = None
# the (C, G, n_strip, payload) shapes whose kernel-3 plan has been held
# against the library's
_MEGA_CHECKED: set = set()
# nvcc's output from the build this process made or found ("" when the
# library was already on disk): ptxas register / spill report per kernel
BUILD_LOG = ""

_vp = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
_f = ctypes.c_float
_ull = ctypes.c_ulonglong


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """The library's path, named by a hash of every source and header in
    ``CSRC`` and of the flags."""
    h = hashlib.sha256()
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpbot_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list) -> str:
    """Run the commands at once; their joined output, or raise on the
    first that failed."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}\n{out}")
    return "".join(outs)


# argument types of the C entry points; each returns a cudaError_t
SIGNATURES = {
    "pbot_stencil_forces": [_vp] * 10 + [_i, _i, _i, _ll] + [_f] * 10 + [_vp],
    "pbot_compact": [_vp, _vp, _vp, _i, _i, _i, _i, _vp],
    "pbot_mega_span": [_vp] * 4 + [_i] * 5 + [_vp, _vp, _i, _vp, _i, _vp, _i, _i, _vp],
    "pbot_compact_padded": [_vp, _vp, _vp] + [_i] * 6 + [_vp],
    "pbot_stencil_forces_ext": [_vp] * 11 + [_i] * 6 + [_ll] + [_f] * 10 + [_vp],
    "pbot_stencil_forces_plan": [_i] * 5 + [_vp],
    "pbot_compact_plan": [_i] * 3 + [_vp],
    "pbot_mega_span_plan": [_i] * 5 + [_vp],
    "pbot_cond_handle": [_vp, _vp],
    "pbot_cond_set": [_ull, _vp, _vp],
    "pbot_cond_node": [_vp, _ull, _i, _i, _vp],
    "pbot_cond_body_begin": [_vp, _vp],
    "pbot_cond_body_end": [_vp, _vp],
    "pbot_row_step": [_vp] * 4 + [_i] * 4 + [_vp, _i, _vp, _i, _vp, _i, _vp, _i, _vp],
    "pbot_dense_step": [_vp, _vp] + [_i] * 5 + [_vp, _i] + [_vp, _i] * 4 + [_vp],
}


def compile_library(csrc: Path, so: Path) -> str:
    """Compile every ``.cu`` in ``csrc`` with its own ``nvcc``, all at
    once, and link the objects into ``so``; returns nvcc's output."""
    nvcc = _nvcc()
    objdir = so.parent / f"{so.stem}.{os.getpid()}.obj"
    objdir.mkdir(parents=True, exist_ok=True)
    srcs = sorted(csrc.glob("*.cu"))
    objs = [str(objdir / f"{src.stem}.o") for src in srcs]
    log = _run_all([
        [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
        for src, obj in zip(srcs, objs)
    ])
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    log += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *objs]])
    os.replace(tmp, so)
    shutil.rmtree(objdir, ignore_errors=True)
    return log


def load_library(so: Path, names=tuple(SIGNATURES)) -> ctypes.CDLL:
    """Load ``so`` and declare the entry points ``names``."""
    lib = ctypes.CDLL(str(so))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = _i
    return lib


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        BUILD_LOG = compile_library(CSRC, so)
    _lib = load_library(so)
    return _lib


def stencil_plan(cap: int, g: int, has_payload: bool, rows: int | None = None,
                 shards: int = 1) -> dict:
    """Kernel 1's or kernel 4's launch for C = ``cap`` slots, side G and
    ``rows`` grid rows of targets (default G: kernel 1's whole table) in
    each of ``shards`` shards: blocks (one per 2x2 tile of cells of every
    shard) and dynamic shared memory per block in bytes, as
    ``pbot_stencil_forces_plan`` in ``csrc/stencil_forces.cu`` computes
    them.  Raises ValueError when C, G, rows or shards is below 1, or when
    C slots need more shared memory than a block has (``SMEM_PER_BLOCK``:
    from C = 145, or 137 with a payload)."""
    rows = g if rows is None else rows
    if min(cap, g, rows, shards) < 1:
        raise ValueError(
            f"stencil_forces: cell_capacity {cap}, grid side {g}, rows {rows} "
            f"and shards {shards} must each be >= 1"
        )
    tiles = -(-g // STENCIL_TILE) * -(-rows // STENCIL_TILE)
    cells, tile_cells = (STENCIL_TILE + 2) ** 2, STENCIL_TILE ** 2
    max_t, nw = cap * tile_cells, -(-cap // MASK_BITS)
    words = ((6 if has_payload else 5) * cap * cells + 4 * max_t + (nw + 1) * cells
             + tile_cells + 1 + 2 * max_t + max_t + 1 + 9 * max_t * nw + 32)
    smem = 16 * STENCIL_TERM_CAP + 4 * words
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"stencil_forces: cell_capacity {cap} needs {smem} bytes of shared "
            f"memory per block; a block has SMEM_PER_BLOCK = {SMEM_PER_BLOCK}"
        )
    # one target's 9 * C terms fit the term buffer for every C that fits
    assert 9 * cap <= STENCIL_TERM_CAP
    return {"blocks": tiles * shards, "smem": smem}


def compact_plan(cs: int, out_lanes: int, shards: int = 1) -> dict:
    """Kernel 2's launch for Cs = ``cs`` slots, ``out_lanes`` target lanes
    and ``shards`` stacks, as ``pbot_compact_plan`` in ``csrc/compact.cu``
    computes it: blocks, threads per block and slot windows.  Any Cs >= 1;
    raises ValueError below 1 slot, lane or shard."""
    if min(cs, out_lanes, shards) < 1:
        raise ValueError(
            f"compact: storage capacity {cs}, {out_lanes} lanes and {shards} "
            "shards must each be >= 1"
        )
    return {
        "blocks": -(-out_lanes // COMPACT_LANES) * shards,
        "threads": COMPACT_THREADS,
        "windows": -(-cs // COMPACT_WINDOW),
    }


def mega_plan(cap: int, g: int, n_strip: int, has_payload: bool,
              scenes: int = 1) -> dict:
    """Kernel 3's cluster for a (C, G) table and an ``n_strip``-row strip,
    as ``mega_plan`` in ``csrc/mega_span.cu`` computes it: ``cluster`` CTAs
    (the largest divisor of G up to 16), ``grid_rows`` grid rows and
    ``rows`` table rows per CTA, ``smem`` bytes of dynamic shared memory
    per CTA, and ``ctas`` in a launch of ``scenes`` scenes (one cluster
    each).  Raises ValueError for a shape the kernel refuses: more than 32
    slots, more than 4096 table or strip rows, more shared memory than a
    CTA has, or fewer than one scene."""
    if scenes < 1:
        raise ValueError(f"mega_span: {scenes} scenes; at least one")
    if not 1 <= cap <= MASK_BITS or g < 1:
        raise ValueError(
            f"mega_span: storage capacity {cap} outside 1..{MASK_BITS} or grid side {g} < 1"
        )
    if cap * g * g > MEGA_MAX_ROWS or not 0 <= n_strip <= MEGA_MAX_ROWS:
        raise ValueError(
            f"mega_span: {cap * g * g} table rows and {n_strip} strip rows; "
            f"at most {MEGA_MAX_ROWS} each"
        )
    n = max(d for d in range(1, MEGA_MAX_CLUSTER + 1) if g % d == 0)
    th = g // n
    rows, ncell = cap * th * g, (th + 2) * (g + 2)
    words = ((6 if has_payload else 5) * cap * ncell + 2 * 5 * rows + 6 * rows
             + 4 * rows + 4 * ncell + th * g + 1 + 2 * rows + rows + 1 + 9 * rows + 32)
    smem = 16 * MEGA_TERM_CAP + 4 * words
    if smem + MEGA_STATIC_SMEM > SMEM_PER_BLOCK:
        raise ValueError(
            f"mega_span: {smem} bytes of shared memory per CTA for C={cap}, "
            f"G={g} (cluster of {n}); a CTA has {SMEM_PER_BLOCK - MEGA_STATIC_SMEM}"
        )
    return {"cluster": n, "grid_rows": th, "rows": rows, "smem": smem,
            "ctas": n * scenes}


def library_stencil_plan(cap: int, g: int, has_payload: bool, rows: int | None = None,
                         shards: int = 1) -> dict:
    """Kernel 1's or kernel 4's plan as the built library computes it:
    blocks and dynamic shared memory.  Raises if the library refuses the
    shape."""
    lib = build()
    out = (ctypes.c_int * 2)()
    rows = g if rows is None else rows
    _raise_on(lib.pbot_stencil_forces_plan(cap, g, rows, shards, int(has_payload), out),
              "stencil_forces plan")
    return {"blocks": out[0], "smem": out[1]}


def library_compact_plan(cs: int, out_lanes: int, shards: int = 1) -> dict:
    """Kernel 2's plan as the built library computes it: blocks, threads
    and slot windows.  Raises if the library refuses the shape."""
    lib = build()
    out = (ctypes.c_int * 3)()
    _raise_on(lib.pbot_compact_plan(cs, out_lanes, shards, out), "compact plan")
    return {"blocks": out[0], "threads": out[1], "windows": out[2]}


def library_mega_plan(cap: int, g: int, n_strip: int, has_payload: bool,
                      scenes: int = 1) -> dict:
    """Kernel 3's plan as the built library computes it on this card for a
    launch of ``scenes`` scenes: cluster, table rows per CTA, dynamic
    shared memory per CTA, ``cudaOccupancyMaxActiveClusters`` for that
    launch (the clusters the card holds at once; more scenes run in
    waves) and the launch's CTAs.  Raises if the library refuses the
    shape."""
    lib = build()
    out = (ctypes.c_int * 5)()
    _raise_on(lib.pbot_mega_span_plan(cap, g, n_strip, int(has_payload), scenes, out),
              "mega_span plan")
    return {"cluster": out[0], "rows": out[1], "smem": out[2],
            "max_active_clusters": out[3], "ctas": out[4]}


def _check_mega_plan(cap: int, g: int, n_strip: int, has_payload: bool,
                     scenes: int = 1) -> None:
    """Raises if :func:`mega_plan` refuses the shape, or (once per shape
    and scene count) if the library's plan differs from it or no cluster
    of the plan fits on the card."""
    key = (cap, g, n_strip, bool(has_payload), scenes)
    plan = mega_plan(*key)
    if key in _MEGA_CHECKED:
        return
    got = library_mega_plan(*key)
    if any(got[k] != plan[k] for k in ("cluster", "rows", "smem", "ctas")):
        raise RuntimeError(f"mega_span: library plan {got} differs from {plan}")
    if got["max_active_clusters"] < 1:
        raise RuntimeError(
            f"mega_span: no cluster of {plan['cluster']} CTAs with {plan['smem']} "
            "bytes of shared memory fits on this card (cudaOccupancyMaxActiveClusters 0)"
        )
    _MEGA_CHECKED.add(key)


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA call failed with error {err}")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _stencil_names(params: SimParams) -> tuple:
    names = ("px", "py", "vx", "vy", "rad")
    return names + ("afac",) if params.has_payload else names


def _launch_stencil(params: SimParams, tables: dict, scenes: int, sstride: int,
                    out: torch.Tensor, what: str) -> None:
    """Kernel 1 on ``scenes`` tables ``sstride`` floats apart into ``out``
    (4 planes of ``scenes`` contiguous (C, G*G) blocks)."""
    from .ops.pallas_stencil import pair_constants

    g, cap = params.resolved_grid_dim(), params.cell_capacity
    stencil_plan(cap, g, params.has_payload, shards=scenes)
    lib = build()
    names = _stencil_names(params)
    afac = tables["afac"].data_ptr() if params.has_payload else None
    err = lib.pbot_stencil_forces(
        *(tables[k].data_ptr() for k in names[:5]), afac,
        *(out[i].data_ptr() for i in range(4)),
        scenes, cap, g, sstride, *pair_constants(params), _stream(out),
    )
    _raise_on(err, what)
    LAUNCHES.count(what)


def stencil_forces_cuda(params: SimParams, tables: dict):
    """Kernel 1 on (C, G*G) CUDA tables -> (fx, fy, fa, fr), each (C, G*G).
    ``tables`` needs px, py, vx, vy, rad, and afac when the scene has a
    payload."""
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    shape = (cap, g * g)
    for k in _stencil_names(params):
        _check(k, tables[k], shape)
    out = torch.empty((4,) + shape, dtype=torch.float32, device=tables["px"].device)
    _launch_stencil(params, tables, 1, cap * g * g, out, "stencil_forces")
    return out[0], out[1], out[2], out[3]


def stencil_forces_batched_cuda(params: SimParams, tables: dict):
    """Kernel 1 on B scenes' CUDA tables in one launch -> (fx, fy, fa,
    fr), each (B, C, G*G).  ``tables`` holds the planes of
    :func:`stencil_forces_cuda`, each (B, C, G*G) with a contiguous (C,
    G*G) block per scene and one scene stride and one device for all (views
    of the batched table loop's (B, rows) field planes qualify).  Scene b's
    outputs equal :func:`stencil_forces_cuda` on scene b's planes bit for
    bit."""
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    px = tables["px"]
    if px.dim() != 3:
        raise ValueError(f"tables: expected (B, C, G*G) planes, got {tuple(px.shape)}")
    b = px.shape[0]
    for k in _stencil_names(params):
        t = tables[k]
        if t.device.type != "cuda":
            raise ValueError(f"{k}: expected a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{k}: expected float32, got {t.dtype}")
        if tuple(t.shape) != (b, cap, g * g):
            raise ValueError(f"{k}: expected shape {(b, cap, g * g)}, got {tuple(t.shape)}")
        if t.device != px.device or t.stride() != (px.stride(0), g * g, 1):
            raise ValueError(
                f"{k}: each scene's (C, G*G) block must be contiguous, with one "
                "scene stride and one device for all planes"
            )
    out = torch.empty((4, b, cap, g * g), dtype=torch.float32, device=px.device)
    _launch_stencil(params, tables, b, px.stride(0), out, "stencil_forces_batched")
    return out[0], out[1], out[2], out[3]


def _launch_compact(params: SimParams, planes: torch.Tensor, scenes: int, what: str):
    g, cs = params.resolved_grid_dim(), params.storage_capacity()
    nfp = planes.shape[-3]
    if nfp < 3:
        raise ValueError(f"planes: need data fields plus dx, dy; got {nfp}")
    lead = planes.shape[:-3]
    _check("planes", planes, lead + (nfp, cs, g * g))
    lib = build()
    out = torch.empty(lead + (nfp - 2, cs, g * g), dtype=torch.float32, device=planes.device)
    incoming = torch.empty(lead + (g * g,), dtype=torch.float32, device=planes.device)
    err = lib.pbot_compact(
        planes.data_ptr(), out.data_ptr(), incoming.data_ptr(),
        scenes, nfp - 2, cs, g, _stream(out),
    )
    _raise_on(err, what)
    LAUNCHES.count(what)
    return out, incoming


def compact_cuda(params: SimParams, planes: torch.Tensor):
    """Kernel 2 on a CUDA (nf + 2, Cs, G*G) plane stack -> (compacted
    (nf, Cs, G*G) planes, per-lane incoming count (G*G,) float32)."""
    if planes.dim() != 3:
        raise ValueError(f"planes: expected (nf + 2, Cs, G*G), got {tuple(planes.shape)}")
    return _launch_compact(params, planes, 1, "compact")


def compact_batched_cuda(params: SimParams, planes: torch.Tensor):
    """Kernel 2's wrap form on B scenes' CUDA (B, nf + 2, Cs, G*G) stacks in
    one launch -> (compacted (B, nf, Cs, G*G) planes, per-lane incoming
    count (B, G*G) float32).  Scene b's outputs equal :func:`compact_cuda`
    on scene b's stack."""
    if planes.dim() != 4 or planes.shape[0] < 1:
        raise ValueError(f"planes: expected (B, nf + 2, Cs, G*G), got {tuple(planes.shape)}")
    return _launch_compact(params, planes, planes.shape[0], "compact_batched")


def compact_padded_cuda(params: SimParams, planes_padded: torch.Tensor,
                        pad_lanes: int, out_lanes: int):
    """Kernel 2's padded form on a CUDA (S, nf + 2, Cs, pad + out + pad)
    stack of S shards -> (compacted (S, nf, Cs, out) planes, per-lane
    incoming count (S, out) float32)."""
    if planes_padded.dim() != 4:
        raise ValueError(f"planes_padded: expected (S, nf + 2, Cs, E), got {tuple(planes_padded.shape)}")
    return _launch_compact_padded(params, planes_padded, pad_lanes, out_lanes, "compact_padded")


def compact_padded_batched_cuda(params: SimParams, planes_padded: torch.Tensor,
                                pad_lanes: int, out_lanes: int):
    """Kernel 2's padded form on the dp x tp loop's shard-major CUDA (S, B,
    nf + 2, Cs, E) stacks in one launch of S x B blocks -> (compacted (S, B,
    nf, Cs, out) planes, per-lane incoming count (S, B, out) float32).
    Block (s, b) equals :func:`compact_padded_cuda` on its stack alone."""
    if planes_padded.dim() != 5:
        raise ValueError(f"planes_padded: expected (S, B, nf + 2, Cs, E), got {tuple(planes_padded.shape)}")
    lead = planes_padded.shape[:2]
    out, incoming = _launch_compact_padded(
        params, planes_padded.flatten(0, 1), pad_lanes, out_lanes, "compact_padded_batched"
    )
    return out.unflatten(0, lead), incoming.unflatten(0, lead)


def _launch_compact_padded(params, planes_padded, pad_lanes: int, out_lanes: int, what: str):
    g, cs = params.resolved_grid_dim(), params.storage_capacity()
    s, nfp = planes_padded.shape[:2]
    if nfp < 3:
        raise ValueError(f"planes_padded: need data fields plus dx, dy; got {nfp}")
    if pad_lanes < g + 1 or out_lanes < 1:
        raise ValueError(f"compact_padded: need pad >= {g + 1} and out >= 1, got {pad_lanes}, {out_lanes}")
    _check("planes_padded", planes_padded, (s, nfp, cs, 2 * pad_lanes + out_lanes))
    lib = build()
    dev = planes_padded.device
    out = torch.empty((s, nfp - 2, cs, out_lanes), dtype=torch.float32, device=dev)
    incoming = torch.empty((s, out_lanes), dtype=torch.float32, device=dev)
    err = lib.pbot_compact_padded(
        planes_padded.data_ptr(), out.data_ptr(), incoming.data_ptr(),
        s, nfp - 2, cs, g, pad_lanes, out_lanes, _stream(out),
    )
    _raise_on(err, what)
    LAUNCHES.count(what)
    return out, incoming


def stencil_forces_ext_cuda(params: SimParams, tables_ext: dict,
                            center_start: int, center_lanes: int):
    """Kernel 4 on CUDA halo-extended tables of S shards -> (fx, fy, fa,
    fr), each (S, C, center_lanes).  ``tables_ext`` holds the seven planes
    of ``ops.pallas_stencil.FIELDS``, each (S, C, E) with E = 2 *
    center_start + center_lanes, a contiguous (C, E) block per shard and
    one shard stride for all seven (views of one stacked tensor qualify)."""
    if tables_ext["px"].dim() != 3:
        raise ValueError(f"tables_ext: expected (S, C, E) planes, got {tuple(tables_ext['px'].shape)}")
    return _launch_stencil_ext(params, tables_ext, center_start, center_lanes,
                               "stencil_forces_ext")


def stencil_forces_ext_batched_cuda(params: SimParams, tables_ext: dict,
                                    center_start: int, center_lanes: int):
    """Kernel 4 on the dp x tp loop's shard-major CUDA tables, each plane
    (S, B, C, E), in one launch of S x B blocks -> (fx, fy, fa, fr), each
    (S, B, C, center_lanes).  The (S, B) axes must flatten to one block
    stride (views of one (S, B, 7, C, E) stack qualify); block (s, b)
    equals :func:`stencil_forces_ext_cuda` on its tables alone."""
    px = tables_ext["px"]
    if px.dim() != 4:
        raise ValueError(f"tables_ext: expected (S, B, C, E) planes, got {tuple(px.shape)}")
    lead = px.shape[:2]
    flat = {k: v.flatten(0, 1) for k, v in tables_ext.items()}
    out = _launch_stencil_ext(params, flat, center_start, center_lanes,
                              "stencil_forces_ext_batched")
    return tuple(o.unflatten(0, lead) for o in out)


def _launch_stencil_ext(params, tables_ext, center_start: int, center_lanes: int, what: str):
    from .ops.pallas_stencil import FIELDS, pair_constants

    g, cap = params.resolved_grid_dim(), params.cell_capacity
    h, center = center_start, center_lanes
    if h < g or h % g or center < 1 or center % g:
        raise ValueError(
            f"stencil_forces_ext: center_start ({h}) and center_lanes "
            f"({center}) must be positive multiples of G={g}"
        )
    px = tables_ext["px"]
    s, ext = px.shape[0], 2 * h + center
    for k in FIELDS:
        t = tables_ext[k]
        if t.device.type != "cuda":
            raise ValueError(f"{k}: expected a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{k}: expected float32, got {t.dtype}")
        if tuple(t.shape) != (s, cap, ext):
            raise ValueError(f"{k}: expected shape {(s, cap, ext)}, got {tuple(t.shape)}")
        if t.device != px.device or t.stride() != (px.stride(0), ext, 1):
            raise ValueError(
                f"{k}: each shard's (C, E) block must be contiguous, with one "
                "shard stride and one device for all planes"
            )
    stencil_plan(cap, g, params.has_payload, center // g, s)
    lib = build()
    out = torch.empty((4, s, cap, center), dtype=torch.float32, device=px.device)
    afac = tables_ext["afac"].data_ptr() if params.has_payload else None
    err = lib.pbot_stencil_forces_ext(
        *(tables_ext[k].data_ptr() for k in FIELDS[:6]), afac,
        *(out[i].data_ptr() for i in range(4)),
        s, cap, g, ext, h, center, px.stride(0),
        *pair_constants(params), _stream(out),
    )
    _raise_on(err, what)
    LAUNCHES.count(what)
    return out[0], out[1], out[2], out[3]


def mega_constants(params: SimParams) -> tuple:
    """Kernel 3's float32 parameters, in the order of ``MegaConsts`` in
    ``csrc/mega_span.cu``: the pair law, dt, the radius controller, the
    world box and the obstacle / friction constants.  The kernel folds
    them with the twin's expressions, in the twin's order."""
    from .ops.actuation import MAX_SPEED, PHASE_FROZEN
    from .ops.pallas_stencil import pair_constants

    p = params
    f = np.float32
    return pair_constants(p) + tuple(float(f(v)) for v in (
        p.timestep,
        p.wave_period(), p.rise_period, p.min_radius, p.max_radius,
        p.constraint, MAX_SPEED, PHASE_FROZEN,
        1.0 if p.constrained_contraction else 0.0, p.constraint_contraction,
        p.world_half, p.boundary_damping,
        p.spring, p.damping, p.shear, p.friction, p.friction_factor,
        p.gravity, p.mass_factor, 1.0 / p.mass_factor,
    ))


def obstacle_arrays(params: SimParams) -> tuple:
    """(rects, n_rect, circles, n_circ): the obstacles as float32 host
    arrays, (x1, x2, y1, y2) and (x, y, r) per obstacle, which kernel 3
    and the row step take by value in their launch parameters (the C
    entry points refuse more than ``SimParams.validate`` allows)."""
    def arr(rows):
        flat = [float(np.float32(v)) for row in rows for v in row]
        return (ctypes.c_float * max(1, len(flat)))(*flat)

    rects, circles = params.rect_obstacles, params.circle_obstacles
    return arr(rects), len(rects), arr(circles), len(circles)


def mega_span_cuda(params: SimParams, tbl: torch.Tensor, strip: torch.Tensor,
                   step: torch.Tensor):
    """Kernel 3 on CUDA tensors: one ungated span from mid-step ``step - 1``
    -> (tbl', strip').  ``tbl`` is (13, C, G*G), ``strip`` (13, n_pad//128,
    128); ``step`` a 0-dim int64 tensor on the same card, which the kernel
    reads (so a CUDA graph of the launch replays at whatever step the
    tensor then holds); the obstacles travel in the launch's parameters
    (:func:`obstacle_arrays`)."""
    if tbl.dim() != 3:
        raise ValueError(f"tbl: expected (13, C, G*G), got {tuple(tbl.shape)}")
    return _launch_mega(params, tbl, strip, step, 1, "mega_span")


def mega_span_batched_cuda(params: SimParams, tbl: torch.Tensor, strip: torch.Tensor,
                           step: torch.Tensor):
    """Kernel 3 on B scenes in one launch, one cluster each: ``tbl`` (B,
    13, C, G*G) and ``strip`` (B, 13, n_pad//128, 128) -> (tbl', strip'),
    the scenes in lockstep at ``step``.  Scene b's outputs equal
    :func:`mega_span_cuda` on scene b's planes bit for bit."""
    if tbl.dim() != 4 or tbl.shape[0] < 1:
        raise ValueError(f"tbl: expected (B, 13, C, G*G), got {tuple(tbl.shape)}")
    return _launch_mega(params, tbl, strip, step, tbl.shape[0], "mega_span_batched")


def _launch_mega(params, tbl, strip, step, scenes: int, what: str):
    from .engine_table import N_TF

    g, cs = params.resolved_grid_dim(), params.storage_capacity()
    n_pad = padded_n(params)
    lead = tbl.shape[:-3]
    _check("tbl", tbl, lead + (N_TF, cs, g * g))
    _check("strip", strip, lead + (N_TF, n_pad // 128, 128))
    if strip.device != tbl.device:
        raise ValueError(f"strip: on {strip.device}, tbl on {tbl.device}")
    _check_mega_plan(cs, g, n_pad, params.has_payload, scenes)
    if not (torch.is_tensor(step) and step.dtype == torch.int64 and step.dim() == 0
            and step.device == tbl.device):
        raise ValueError(f"step: expected a 0-dim int64 tensor on {tbl.device}")
    lib = build()
    consts = mega_constants(params)
    carr = (ctypes.c_float * len(consts))(*consts)
    tbl_out = torch.empty_like(tbl)
    strip_out = torch.empty_like(strip)
    k = max(1, params.resolved_slot_rebuild_steps())
    err = lib.pbot_mega_span(
        tbl.data_ptr(), strip.data_ptr(), tbl_out.data_ptr(), strip_out.data_ptr(),
        scenes, cs, g, n_pad, k, step.data_ptr(),
        ctypes.cast(carr, _vp), len(consts), *obstacle_arrays(params),
        int(params.has_payload), _stream(tbl_out),
    )
    _raise_on(err, what)
    LAUNCHES.count(what)
    return tbl_out, strip_out


def cond_node(ok: torch.Tensor, bodies: int = 1) -> list:
    """On the current stream of ``ok``'s card, which a CUDA graph capture
    is under way on (into a graph or into a conditional node's body
    graph): create a conditional handle in the graph being captured,
    enqueue kernel ``cond_set`` (the handle := ``not ok``), add a
    conditional IF node after it and make the node the capture's sole
    dependency.  Returns the node's body graphs (``cudaGraph_t`` s as
    ints): with ``bodies=1`` the one a replay runs only where ``ok`` is
    False; with ``bodies=2`` (an IF node with an else branch) that one and
    the one a replay runs only where ``ok`` holds.  ``ok`` is a 0-dim bool
    CUDA tensor that the graph's earlier nodes write.  Raises if a step
    fails (no capture under way, a CUDA installation without conditional
    nodes, or without their else branch)."""
    if bodies not in (1, 2):
        raise ValueError(f"bodies: expected 1 or 2, got {bodies}")
    return _conditional(ok, False, bodies)[1]


def while_node(stop: torch.Tensor) -> tuple:
    """As :func:`cond_node`, a conditional WHILE node: the handle :=
    ``not stop`` before it, and its body runs again while the handle is
    non-zero, which the body sets at its end (:func:`set_conditional`).
    Returns (the handle, the body graph)."""
    handle, (body,) = _conditional(stop, True, 1)
    return handle, body


def set_conditional(handle: int, stop: torch.Tensor) -> None:
    """Enqueue kernel ``cond_set`` (the handle := ``not stop``) on the
    current stream of ``stop``'s card, inside the capture of a WHILE
    node's body."""
    _check_flag(stop)
    _raise_on(build().pbot_cond_set(handle, stop.data_ptr(), _stream(stop)), "cond_set")
    LAUNCHES.count("cond_set")


def _check_flag(ok: torch.Tensor) -> None:
    if ok.device.type != "cuda" or ok.dtype != torch.bool or ok.dim() != 0:
        raise ValueError(f"expected a 0-dim bool CUDA tensor, got {ok.dtype} "
                         f"{tuple(ok.shape)} on {ok.device}")


def _conditional(ok: torch.Tensor, loop: bool, bodies: int) -> tuple:
    _check_flag(ok)
    lib = build()
    stream = _stream(ok)
    handle = _ull()
    _raise_on(lib.pbot_cond_handle(stream, ctypes.byref(handle)), "conditional handle")
    _raise_on(lib.pbot_cond_set(handle, ok.data_ptr(), stream), "cond_set")
    LAUNCHES.count("cond_set")
    out = (_vp * bodies)()
    _raise_on(lib.pbot_cond_node(stream, handle, int(loop), bodies, out), "conditional node")
    return handle.value, list(out)


def begin_body(stream: torch.cuda.Stream, body: int) -> None:
    """Begin capturing ``stream`` into the body graph of :func:`cond_node`."""
    _raise_on(build().pbot_cond_body_begin(stream.cuda_stream, body), "body capture")


def end_body(stream: torch.cuda.Stream, body: int) -> None:
    """End :func:`begin_body`'s capture; raises if it was invalidated."""
    _raise_on(build().pbot_cond_body_end(stream.cuda_stream, body), "body capture")


_cuda = None
# CUgraphNodeType values (cuda.h) and CU_STREAM_CAPTURE_STATUS_ACTIVE
_NODE_KERNEL, _NODE_MEMCPY, _NODE_MEMSET, _NODE_CONDITIONAL = 0, 1, 2, 13
_CAPTURE_ACTIVE = 1


def _driver() -> ctypes.CDLL:
    """The CUDA driver library, its graph queries declared.  The driver's
    node queries, not the runtime's: ``cudaGraphGetNodes`` and
    ``cudaGraphNodeGetType`` fail on a graph that holds a conditional
    node (CUDA 12.9 runtime).  No build: a graph of PyTorch kernels alone
    is counted too."""
    global _cuda
    if _cuda is None:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuStreamGetCaptureInfo_v2.argtypes = [
            _vp, ctypes.POINTER(_i), ctypes.POINTER(_ull), ctypes.POINTER(_vp),
            ctypes.POINTER(_vp), ctypes.POINTER(ctypes.c_size_t)]
        lib.cuGraphGetNodes.argtypes = [_vp, ctypes.POINTER(_vp), ctypes.POINTER(ctypes.c_size_t)]
        lib.cuGraphNodeGetType.argtypes = [_vp, ctypes.POINTER(_i)]
        for fn in (lib.cuStreamGetCaptureInfo_v2, lib.cuGraphGetNodes, lib.cuGraphNodeGetType):
            fn.restype = _i
        _cuda = lib
    return _cuda



def _driver_check(res: int, what: str) -> None:
    if res != 0:
        raise RuntimeError(f"{what} failed: CUresult {res}")


def capture_graph(stream: torch.cuda.Stream) -> int:
    """The ``cudaGraph_t`` (as an int) that ``stream`` is capturing into."""
    status, graph = _i(), _vp()
    _driver_check(_driver().cuStreamGetCaptureInfo_v2(
        stream.cuda_stream, ctypes.byref(status), None, ctypes.byref(graph), None, None),
        "capture graph")
    if status.value != _CAPTURE_ACTIVE:
        raise RuntimeError("capture graph failed: no capture under way on the stream")
    return graph.value


def graph_nodes(graph: int) -> dict:
    """A graph's nodes by type (its own, not its bodies'): ``nodes``,
    ``kernels``, ``copies`` (memcpy and memset) and ``conditional``."""
    lib = _driver()
    n = ctypes.c_size_t(0)
    _driver_check(lib.cuGraphGetNodes(graph, None, ctypes.byref(n)), "graph nodes")
    nodes = (_vp * n.value)()
    if n.value:
        _driver_check(lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "graph nodes")
    out = {"nodes": n.value, "kernels": 0, "copies": 0, "conditional": 0}
    kind = _i()
    for node in nodes[: n.value]:
        _driver_check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)), "graph node type")
        if kind.value == _NODE_KERNEL:
            out["kernels"] += 1
        elif kind.value in (_NODE_MEMCPY, _NODE_MEMSET):
            out["copies"] += 1
        elif kind.value == _NODE_CONDITIONAL:
            out["conditional"] += 1
    return out


# the row step's modes, their codes in row_step.cu, and the planes each
# writes (the kernel's outputs are px py vx vy rad aa ar)
ROW_STEP_MODES = {"post": 1, "pre": 2, "post_pre": 3}
ROW_STEP_OUT = ("px", "py", "vx", "vy", "rad", "aa", "ar")
ROW_STEP_WRITES = {
    "post": ("vx", "vy", "aa", "ar"),
    "pre": ("px", "py", "vx", "vy", "rad"),
    "post_pre": ROW_STEP_OUT,
}


def row_step_cuda(params: SimParams, fields: dict, mode: str, step=None,
                  offset: int = 0, forces=None) -> dict:
    """The row step on the table loop's CUDA field planes -> a new dict of
    the 13 ``TABLE_FIELDS`` planes: those ``mode`` writes
    (:data:`ROW_STEP_WRITES`) new tensors from ``torch.empty`` (one stack,
    a plane each), the others ``fields``' own.

    ``fields`` holds every plane of one scene, ``(total_ext,)``, or of B
    scenes, ``(B, total_ext)``: float32 on one card, rows contiguous (any
    scene stride).  ``mode``: ``"post"`` (``forces``, kernel 1's (fx, fy,
    fa, fr), each ``([B,] C, G*G)`` contiguous, give the pair sums of the
    first C*G*G rows; the other rows feel none), ``"pre"`` (at the sim time
    of the step ``step + offset``) or ``"post_pre"`` (post, then pre at
    ``step + offset``).  ``step`` is a 0-dim int64 tensor on the card,
    which the kernel reads.  Equals the table loop's PyTorch ops
    (``engine_table.make_table_step_parts`` on CPU tensors) bit for bit.
    One launch, counted as ``row_step``, or ``row_step_batched`` for B
    scenes."""
    from .engine_table import N_TF, TABLE_FIELDS, _geometry

    if mode not in ROW_STEP_MODES:
        raise ValueError(f"row_step: mode {mode!r} not in {tuple(ROW_STEP_MODES)}")
    _, rows, _ = _geometry(params)
    g, cap = params.resolved_grid_dim(), params.cell_capacity
    px = fields["px"]
    if px.dim() not in (1, 2):
        raise ValueError(f"fields: expected ([B,] {rows}) planes, got {tuple(px.shape)}")
    lead = tuple(px.shape[:-1])
    for k in TABLE_FIELDS:
        t = fields[k]
        if t.device.type != "cuda" or t.device != px.device:
            raise ValueError(f"{k}: expected a CUDA tensor on {px.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{k}: expected float32, got {t.dtype}")
        if tuple(t.shape) != lead + (rows,) or t.stride(-1) != 1:
            raise ValueError(f"{k}: expected shape {lead + (rows,)} with contiguous rows, "
                             f"got {tuple(t.shape)} strides {t.stride()}")
    posts = mode != "pre"
    if posts:
        if forces is None or len(forces) != 4:
            raise ValueError("row_step: post needs the forces, kernel 1's (fx, fy, fa, fr)")
        for t in forces:
            _check("forces", t, lead + (cap, g * g))
    pres = mode != "post"
    if pres and not (torch.is_tensor(step) and step.dtype == torch.int64 and step.dim() == 0
                     and step.device == px.device):
        raise ValueError(f"step: expected a 0-dim int64 tensor on {px.device}")
    scenes = lead[0] if lead else 1
    writes = ROW_STEP_WRITES[mode]
    out = torch.empty((len(writes),) + lead + (rows,), dtype=torch.float32, device=px.device)
    planes = dict(zip(writes, out))
    lib = build()
    consts = mega_constants(params)
    carr = (ctypes.c_float * len(consts))(*consts)
    err = lib.pbot_row_step(
        (_vp * N_TF)(*(fields[k].data_ptr() for k in TABLE_FIELDS)),
        (_ll * N_TF)(*(fields[k].stride(0) if lead else 0 for k in TABLE_FIELDS)),
        (_vp * len(ROW_STEP_OUT))(*(planes[k].data_ptr() if k in planes else None
                                    for k in ROW_STEP_OUT)),
        (_vp * 4)(*(t.data_ptr() for t in forces)) if posts else None,
        scenes, rows, cap * g * g, ROW_STEP_MODES[mode],
        step.data_ptr() if pres else None, int(offset),
        ctypes.cast(carr, _vp), len(consts), *obstacle_arrays(params), _stream(px),
    )
    _raise_on(err, "row_step")
    LAUNCHES.count("row_step_batched" if lead else "row_step")
    return {**fields, **planes}


# the dense step's target rows per block, largest first (csrc/dense_step.cu:
# a warp each), and the fewest blocks per SM a tile may leave: every block
# stages its whole scene, so larger tiles stage less, down to about one
# block for 8 SMs (on the H100 at 500 bots, B=1 and B=8, PERF.md)
DENSE_TILES = (32, 16, 8, 4)
DENSE_MIN_BLOCKS_PER_SM = 1 / 8


def dense_plan(scenes: int, n_pad: int, sms: int) -> dict:
    """The dense step's launch for ``scenes`` scenes of ``n_pad`` rows on a
    card of ``sms`` SMs: the largest tile of :data:`DENSE_TILES` target rows
    whose blocks (scenes x tiles) number at least
    :data:`DENSE_MIN_BLOCKS_PER_SM` of the SMs, else the smallest; blocks
    and threads per block (a warp per row).  The sums do not depend on the
    tile."""
    for rows in DENSE_TILES:
        if scenes * -(-n_pad // rows) >= sms * DENSE_MIN_BLOCKS_PER_SM:
            break
    return {"rows": rows, "blocks": scenes * -(-n_pad // rows),
            "threads": rows * 32}


def dense_constants(params: SimParams) -> tuple:
    """The dense step's pair-law constants, in the order of ``DensePair``
    in ``csrc/dense_step.cu``, folded as ``ops/forces.py pair_forces``
    folds them: the spring negated, and the magnet ramp's two divisions
    by host scalars as products by their float32 reciprocals (PyTorch's
    CUDA division by a host scalar)."""
    from .ops.forces import MAGNET_INT1, MAGNET_INT2, MAGNET_MIN_ATTR

    f, p = np.float32, params
    one = f(1.0)
    return tuple(float(v) for v in (
        f(p.cutoff()), -f(p.spring), f(p.damping), f(p.shear), f(p.attraction),
        f(p.attraction_factor), f(MAGNET_INT1), f(MAGNET_INT2), f(MAGNET_MIN_ATTR),
        one / f(MAGNET_INT2) ** 2, one / f(MAGNET_INT2 - MAGNET_INT1),
    ))


_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def dense_step_cuda(params: SimParams, arrays: dict, step: torch.Tensor,
                    offset: int = 0) -> dict:
    """Steps 4-6 of the per-bot DENSE step (``ops/dense_step.py``) in one
    launch of the dense step on CUDA tensors -> the new ``pos``, ``vel``,
    ``rad``, ``abs_force_a`` and ``abs_force_r`` (``TAIL_FIELDS``), fresh
    tensors from ``torch.empty``.

    ``arrays`` holds one scene's ``SimState`` fields (``pos`` and ``vel``
    ``(n_pad, 2)``, the others ``(n_pad,)``) or B scenes' with a leading
    scene axis, float32 (``dead`` bool), contiguous, on one card; the
    radius controller runs at the sim time of the step ``step + offset``
    (``step`` a 0-dim int64 tensor on the card, which the kernel reads).
    Equals :func:`ops.dense_step.dense_step_plain` on the same tensors but
    for the order of the pair sums, and bit for bit where a row has at most
    one neighbour in reach.  One launch, counted as ``dense_step``, or
    ``dense_step_batched`` for B scenes."""
    from .ops.dense_step import IN_FIELDS, TAIL_FIELDS

    pos = arrays["pos"]
    if pos.dim() not in (2, 3) or pos.shape[-1] != 2:
        raise ValueError(f"pos: expected ([B,] n_pad, 2), got {tuple(pos.shape)}")
    lead, n_pad = tuple(pos.shape[:-2]), pos.shape[-2]
    for k in IN_FIELDS:
        t = arrays[k]
        want = lead + ((n_pad, 2) if k in ("pos", "vel") else (n_pad,))
        dtype = torch.bool if k == "dead" else torch.float32
        if t.device.type != "cuda" or t.device != pos.device:
            raise ValueError(f"{k}: expected a CUDA tensor on {pos.device}, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{k}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != want or not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError(f"{k}: expected a contiguous, 8-byte aligned {want}, "
                             f"got {tuple(t.shape)} strides {t.stride()}")
    if n_pad < params.n_cells:
        raise ValueError(f"pos: {n_pad} rows hold fewer than n_cells = {params.n_cells}")
    if not (torch.is_tensor(step) and step.dtype == torch.int64 and step.dim() == 0
            and step.device == pos.device):
        raise ValueError(f"step: expected a 0-dim int64 tensor on {pos.device}")
    scenes = lead[0] if lead else 1
    plan = dense_plan(scenes, n_pad, _sm_count(pos.device))
    out = {k: torch.empty_like(arrays[k]) for k in TAIL_FIELDS}
    lib = build()
    consts, pair = mega_constants(params), dense_constants(params)
    carr = (ctypes.c_float * len(consts))(*consts)
    parr = (ctypes.c_float * len(pair))(*pair)
    err = lib.pbot_dense_step(
        (_vp * len(IN_FIELDS))(*(arrays[k].data_ptr() for k in IN_FIELDS)),
        (_vp * len(TAIL_FIELDS))(*(out[k].data_ptr() for k in TAIL_FIELDS)),
        scenes, n_pad, params.n_cells, params.n_cells - 1 if params.has_payload else -1,
        plan["rows"], step.data_ptr(), int(offset),
        ctypes.cast(carr, _vp), len(consts), ctypes.cast(parr, _vp), len(pair),
        *obstacle_arrays(params), _stream(pos),
    )
    _raise_on(err, "dense_step")
    LAUNCHES.count("dense_step_batched" if lead else "dense_step")
    return out
