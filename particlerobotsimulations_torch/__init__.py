"""particlerobotsimulations_torch — the PyTorch/CUDA port of the simulator.

A second package beside ``particlerobotsimulations_tpu`` (the JAX
reference): the same ``.cfg`` files, parameters, physics, op order and CSV
schema.  Every entry point takes a ``device`` (default ``"cuda"``).  On a
CUDA device the table-resident PALLAS loop runs hand-written Hopper
kernels (``csrc/``: the pair-force stencil, the slot compaction, the
small-table span kernel, and the halo stencil of the sharded loop in
``parallel/``); on the CPU the same calls take their plain PyTorch twins.
Seed sweeps (``parallel/sweep.run_sweep``, ``models/experiments.py``) run
many scenes at once through the batched loops, whose kernels take every
scene in one launch.  Runs checkpoint and resume in the JAX package's
format (``io/checkpoint.py``), record video (``render/``), and take
gradients through the step (``models/optimize.py``; on PALLAS kernel 1
inside a ``torch.autograd.Function``).  The package never imports JAX.
"""

from .config import (
    Config,
    Control,
    ForceBackend,
    SimParams,
    load_cfg,
    parse_cfg_text,
)
from .engine import make_run_chunk, make_run_chunk_batched, make_step
from .sim import Simulation
from .state import SimState, active_mask, make_state, payload_mask

__version__ = "0.1.0"

__all__ = [
    "Config",
    "Control",
    "ForceBackend",
    "SimParams",
    "SimState",
    "Simulation",
    "active_mask",
    "load_cfg",
    "make_run_chunk",
    "make_run_chunk_batched",
    "make_state",
    "make_step",
    "parse_cfg_text",
    "payload_mask",
    "__version__",
]
