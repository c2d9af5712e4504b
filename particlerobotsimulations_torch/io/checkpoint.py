"""Full-fidelity checkpoint/resume.

Port of ``particlerobotsimulations_tpu.io.checkpoint``: the entire
``SimState`` (phase, dead flags, the force-magnitude carry, the centroid
ring) and the params, as one compressed ``.npz`` in the JAX package's
format, so a checkpoint written by either package loads in the other.

The file holds every key the JAX loader reads: ``format_version``,
``params_json``, the state arrays, ``step``, ``key_data`` (the threefry
data of ``jax.random.key(params.seed)``, ``(seed >> 32, seed &
0xFFFFFFFF)``: JAX's key never advances, it draws ``fold_in(key, step)``)
and ``centroid_ring``.  The port adds its generator's state
(``rng_state``, from ``rng.snapshot``) and the generator's device type
(``rng_device``): a CUDA generator's state is a Philox seed and offset, a
CPU generator's an mt19937 state, and the two are not interchangeable.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .. import rng
from ..config import Config, Control, ForceBackend, SimParams
from ..state import ARRAY_FIELDS, SimState, state_from_arrays

FORMAT_VERSION = 1


def _params_json(params: SimParams) -> str:
    d = dataclasses.asdict(params)
    for k, v in d.items():
        if isinstance(v, (Config, Control, ForceBackend)):
            d[k] = int(v)
    return json.dumps(d)


def _params_from_json(s: str) -> SimParams:
    d = json.loads(s)
    d["config"] = Config(d["config"])
    d["control"] = Control(d["control"])
    d["force_backend"] = ForceBackend(d["force_backend"])
    d["rect_obstacles"] = tuple(tuple(o) for o in d["rect_obstacles"])
    d["circle_obstacles"] = tuple(tuple(o) for o in d["circle_obstacles"])
    return SimParams(**d)


def _key_data(seed: int) -> np.ndarray:
    """The uint32 pair ``jax.random.key_data(jax.random.key(seed))``."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def save_checkpoint(path: str, params: SimParams, state: SimState) -> None:
    """Atomically snapshot ``state`` to exactly ``path``.

    Writes a temp file in the same directory and ``os.replace`` s it, so a
    crash mid-save never destroys the previous good checkpoint; the file
    object keeps ``np.savez_compressed`` from appending ``.npz``.  Raises
    ValueError for a batched state or one whose draws come from a
    step-keyed provider (it has no state to save)."""
    if state.pos.dim() == 3:
        raise ValueError("a batched state (a leading scene axis) cannot be checkpointed")
    if not isinstance(state.generator, torch.Generator):
        raise ValueError(
            "a state drawing from a step-keyed provider cannot be checkpointed: "
            "only a torch.Generator's state can be saved"
        )
    arrays = {k: getattr(state, k).detach().cpu().numpy() for k in ARRAY_FIELDS}
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(
            fh,
            format_version=FORMAT_VERSION,
            params_json=_params_json(params),
            step=np.asarray(state.step, np.int32),
            key_data=_key_data(params.seed),
            rng_state=rng.snapshot(state.generator).numpy(),
            rng_device=state.generator.device.type,
            **arrays,
        )
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cuda", draws=None):
    """Returns (params, state) on ``device``.

    The draw source is ``draws`` when given (a step-keyed provider); else
    the port generator state the file holds, restored on ``device`` (a
    file written from one device type and loaded on another raises
    ValueError); else, for a file the JAX package wrote, a generator
    seeded from its ``key_data``."""
    device = torch.device(device)
    with np.load(path, allow_pickle=False) as z:
        if int(z["format_version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {z['format_version']}")
        params = _params_from_json(str(z["params_json"]))
        arrays = {k: z[k] for k in ARRAY_FIELDS}
        arrays["step"] = z["step"]
        arrays["key"] = z["key_data"]
        if draws is None and "rng_state" in z.files:
            saved = str(z["rng_device"])
            if saved != device.type:
                raise ValueError(
                    f"checkpoint {path!r} holds a {saved} generator state, which "
                    f"cannot be restored on a {device.type} device (a CUDA "
                    "generator keeps a Philox seed and offset, a CPU one an "
                    f"mt19937 state); load it on a {saved} device, or pass draws="
                )
            draws = torch.Generator(device=device)
            rng.restore(draws, torch.from_numpy(z["rng_state"].copy()))
    return params, state_from_arrays(params, arrays, device, draws)
