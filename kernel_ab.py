#!/usr/bin/env python3
"""Kernels 1-4 of this checkout against another checkout's, on one card.

    python3 kernel_ab.py OTHER_CHECKOUT/particlerobotsimulations_torch/csrc

Builds the other checkout's kernel library from its ``csrc`` beside this
checkout's and calls both through this checkout's wrappers (the C entry
points keep their signatures, but for kernel 3's step: a checkout whose
``mega_span.cu`` takes it as an ``int`` gets the value the step tensor was
made from) on the same inputs, at ``chip_smoke.py``'s
shapes: kernel 1 on the 10k path's table after 200 steps (G=48), kernel 4
on the sharded 10k table after 200 steps (G=64), kernel 3 on one K=4 span
of the 1000-bot band after 200 steps, and kernel 2 on the compaction stacks
of those tables (7 steps on without a rebuild): the wrap form on the 10k
table and on the band's G=16 table, the padded form on the sharded table.
Each call's output memory is filled with NaN first.  Prints the card's
name and power limit, then per kernel whether the two libraries' outputs
are bitwise equal and each library's time per launch, measured in turns:
other, this, this, other — kernels 1, 2 and 4 in a CUDA graph
(``graph_ms``), kernel 3 per wrapper call (``median_ms``), since a library
may set kernel attributes inside its launch, which a graph capture need
not allow.  Exits 1 without a card, 3 when a pair of outputs differs.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
import particlerobotsimulations_torch as pt
from particlerobotsimulations_torch import kernels
from particlerobotsimulations_torch.parallel.ring import LocalRing
from particlerobotsimulations_torch.parallel.spatial_table import (
    HALO_ROWS,
    make_sharded_table_run,
)

# the entry points the kernels' wrappers call
ENTRY_POINTS = ("pbot_stencil_forces", "pbot_stencil_forces_ext", "pbot_mega_span",
                "pbot_compact", "pbot_compact_padded")


# kernel 3's step tensors, by address: what an int-step library is given
STEPS: dict = {}
# the position of kernel 3's step in pbot_mega_span's arguments
MEGA_STEP_ARG = 9


class IntStepLibrary:
    """A library whose ``pbot_mega_span`` takes its first step as an
    ``int`` (before it read a 0-dim int64 on the card), called as the
    current one: the step tensor's address is swapped for its value."""

    def __init__(self, lib):
        self._lib = lib
        sig = list(kernels.SIGNATURES["pbot_mega_span"])
        sig[MEGA_STEP_ARG] = ctypes.c_int
        lib.pbot_mega_span.argtypes = sig

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def pbot_mega_span(self, *args):
        args = list(args)
        args[MEGA_STEP_ARG] = STEPS[args[MEGA_STEP_ARG]]
        return self._lib.pbot_mega_span(*args)


def cases() -> dict:
    """name -> a call of that kernel's wrapper on chip_smoke.py's inputs."""
    params = cs.bench_params()
    p1, tables, planes = cs.main_path_tables(params)
    pb, _, band_planes = cs.main_path_tables(cs.band_params())
    run, p4 = make_sharded_table_run(params, LocalRing(cs.N_SHARDS, "cuda"))
    tables_ext, _, padded = cs.sharded_tables(p4, run(pt.Simulation(p4, device="cuda").state, 200))
    g = p4.resolved_grid_dim()
    h, l0 = HALO_ROWS * g, g * g // cs.N_SHARDS
    band = pt.Simulation(cs.band_params(), device="cuda")
    band.step_chunk(200, start_step=0)
    p3, tbl, strip, first = cs.span_inputs(band)
    STEPS[first.data_ptr()] = int(first)
    # the band has no obstacles: a kernel 3 built before they went by value
    # (it took device arrays) is called with the same null arrays
    assert not (p3.rect_obstacles or p3.circle_obstacles)
    return {
        "stencil_forces": lambda: kernels.stencil_forces_cuda(p1, tables),
        "stencil_forces_ext": lambda: kernels.stencil_forces_ext_cuda(p4, tables_ext, h, l0),
        "mega_span": lambda: kernels.mega_span_cuda(p3, tbl, strip, first),
        "compact": lambda: kernels.compact_cuda(p1, planes),
        "compact_padded": lambda: kernels.compact_padded_cuda(p4, padded, h, l0),
        "compact_band": lambda: kernels.compact_cuda(pb, band_planes),
    }


def poison_outputs(sizes) -> None:
    """Fill with NaN the blocks that the caching allocator hands the next
    call's outputs: blocks of these byte sizes, taken in this order and
    freed again, are the blocks the same requests get next.  Without it a
    kernel that writes nothing returns the last call's results."""
    junk = [torch.full((n // 4,), float("nan"), device="cuda") for n in sizes]
    del junk


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    libs = {"this": kernels.build()}
    so = kernels.BUILD_DIR / "ab" / "libpbot_kernels_other.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    kernels.compile_library(Path(argv[1]).resolve(), so)
    libs["other"] = kernels.load_library(so, ENTRY_POINTS)
    if "const void* step0" not in (Path(argv[1]) / "mega_span.cu").read_text():
        libs["other"] = IntStepLibrary(libs["other"])

    differ = False
    for name, fn in cases().items():
        # this library first, so that kernel 3's plan is checked against it
        sizes = list({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                      for t in fn()}.values())
        timer = cs.median_ms if name == "mega_span" else cs.graph_ms
        outs, times = {}, {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            kernels._lib = libs[side]
            poison_outputs(sizes)
            outs[side] = [t.clone() for t in fn()]
            times[side].append(timer(fn))
        kernels._lib = libs["this"]
        equal = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(outs["other"], outs["this"]))
        differ = differ or not equal
        print(
            f"{name}: bitwise equal {equal}; us per launch ({timer.__name__}) other "
            f"{[round(t * 1e3, 2) for t in times['other']]} this "
            f"{[round(t * 1e3, 2) for t in times['this']]}; median ratio this/other "
            f"{statistics.median(times['this']) / statistics.median(times['other']):.3f}"
        )
    return 3 if differ else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
