"""Simulation state: a dataclass of torch tensors.

Port of ``particlerobotsimulations_tpu.state``.  Structure-of-arrays,
float32, padded to ``padded_n`` bots (a multiple of 128) exactly like the
JAX state, so arrays carry across the two packages row for row
(:func:`state_from_arrays` / :func:`state_to_arrays`).

Two things differ in kind from the JAX ``SimState``:

* ``step`` is a host ``int``.  Interval gates (phase, centroid, dead
  injection, slot rebuild) are decided in Python from it, which gives the
  same gate firings as the JAX scan's traced predicates.
* ``generator`` is the run's draw source (``rng.py``) in place of the JAX
  PRNG key: by default a ``torch.Generator`` on the state's device, seeded
  from ``params.seed``, whose stream differs from JAX's, so phase noise and
  the dead choice match the JAX package in distribution, not value.  A
  step-keyed provider handed to :func:`state_from_arrays` (``draws=``)
  takes its place; the tests hand in one that returns JAX's draws.

A batch of scenes (the seed sweep's batched runs) is one ``SimState`` with
a leading scene axis on every array field, one shared ``step`` (the scenes
run in lockstep) and a ``rng.SceneDraws`` holding each scene's source:
:func:`stack_states`, :func:`scene_state`, and the JAX bridge
:func:`batch_state_from_arrays` / :func:`batch_state_to_arrays`.

One-step-lag force feedback: ``abs_force_a`` / ``abs_force_r`` are the
attraction / repulsion magnitudes of the previous step's collide pass; the
radius controller reads them before collide overwrites them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SimParams, padded_n
from .rng import SceneDraws

ARRAY_FIELDS = (
    "pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r",
    "centroid_ring",
)


@dataclasses.dataclass
class SimState:
    """Per-scene simulation state.  All arrays padded to ``n_pad`` bots."""

    pos: torch.Tensor           # (n_pad, 2) float32
    vel: torch.Tensor           # (n_pad, 2) float32
    rad: torch.Tensor           # (n_pad,)  float32
    phase: torch.Tensor         # (n_pad,)  float32
    dead: torch.Tensor          # (n_pad,)  bool
    abs_force_a: torch.Tensor   # (n_pad,)  float32 — attraction magnitude sum
    abs_force_r: torch.Tensor   # (n_pad,)  float32 — repulsive magnitude sum
    step: int                   # sim time = step * dt
    generator: object           # draw source (rng.py): phase noise, dead choice
    centroid_ring: torch.Tensor  # (centroid_steps, 2) float32 — COG history

    @property
    def n_pad(self) -> int:
        return self.pos.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def time(self, dt: float) -> float:
        return float(np.float32(self.step) * np.float32(dt))

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)


def make_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def active_mask(params: SimParams, n_pad: int | None = None, device="cpu"):
    """Boolean (n_pad,) mask of real (non-padding) bots."""
    n_pad = n_pad or padded_n(params)
    return torch.arange(n_pad, device=device) < params.n_cells


def payload_mask(params: SimParams, n_pad: int | None = None, device="cpu"):
    """Mask of the transported payload object: the last bot when n_dead == -1
    (reference: particlebot_kernel_impl.cuh:629-649, 804-815)."""
    n_pad = n_pad or padded_n(params)
    idx = torch.arange(n_pad, device=device)
    if params.has_payload:
        return idx == (params.n_cells - 1)
    return torch.zeros((n_pad,), dtype=torch.bool, device=device)


def seed_of_key_data(key_data) -> int:
    """The seed of a threefry PRNG key from its raw data, the uint32 pair
    ``(seed >> 32, seed & 0xFFFFFFFF)`` that ``jax.random.key_data`` gives
    for ``jax.random.key(seed)``."""
    hi, lo = (int(v) for v in np.asarray(key_data, dtype=np.uint32).reshape(2))
    return (hi << 32) | lo


def state_from_arrays(params: SimParams, arrays: dict, device="cuda",
                      draws=None) -> SimState:
    """Build a state from a dict of numpy arrays that are already padded:
    the keys of :data:`ARRAY_FIELDS` plus ``step``, and optionally the
    run's ``seed`` or a JAX state's ``key`` data (:func:`seed_of_key_data`).
    This is the bridge from the JAX package: feed it a JAX ``SimState``'s
    arrays after ``jax.device_get``, its key through
    ``jax.random.key_data``.  The draw source is ``draws`` when given (a
    step-keyed provider, ``rng.StepDraws``), else a ``torch.Generator``
    seeded with that seed (``params.seed`` when neither key is there)."""
    device = torch.device(device)
    t = {
        k: torch.tensor(
            np.asarray(arrays[k], dtype=bool if k == "dead" else np.float32),
            device=device,
        )
        for k in ARRAY_FIELDS
    }
    if draws is None:
        if "key" in arrays:
            seed = seed_of_key_data(arrays["key"])
        else:
            seed = arrays.get("seed", params.seed)
        draws = make_generator(seed, device)
    return SimState(step=int(np.asarray(arrays["step"])), generator=draws, **t)


def stack_states(states) -> SimState:
    """One batched state of scenes in lockstep: every array field stacked
    on a leading scene axis, the draw sources gathered in a
    ``rng.SceneDraws``.  Raises ValueError when the scenes' steps
    differ."""
    states = list(states)
    steps = sorted({s.step for s in states})
    if len(steps) != 1:
        raise ValueError(
            f"a batch runs its scenes in lockstep; got steps {steps}"
        )
    return SimState(
        step=steps[0],
        generator=SceneDraws([s.generator for s in states]),
        **{k: torch.stack([getattr(s, k) for s in states]) for k in ARRAY_FIELDS},
    )


def scene_state(state: SimState, b: int) -> SimState:
    """Scene ``b`` of a batched state, with its own draw source."""
    return SimState(
        step=state.step,
        generator=state.generator.sources[b],
        **{k: getattr(state, k)[b] for k in ARRAY_FIELDS},
    )


def batch_state_from_arrays(params: SimParams, arrays: dict, device="cuda",
                            draws=None) -> SimState:
    """Batched twin of :func:`state_from_arrays`: every array of ``arrays``
    has a leading scene axis, as a JAX batched ``SimState`` (``
    make_batch_state``) gives them: the fields, ``step`` (one per scene,
    all equal: the batch runs in lockstep, else ValueError) and optionally
    ``seed`` or ``key`` data per scene.  ``draws`` is one step-keyed
    provider per scene, or None for a generator per scene's seed."""
    steps = np.asarray(arrays["step"]).reshape(-1)
    if len(set(steps.tolist())) != 1:
        raise ValueError(
            f"a batch runs its scenes in lockstep; got steps {sorted(set(steps.tolist()))}"
        )
    n = np.asarray(arrays["pos"]).shape[0]
    if draws is not None and len(draws) != n:
        raise ValueError(f"{len(draws)} draw providers for {n} scenes")
    scenes = []
    for b in range(n):
        one = {k: np.asarray(arrays[k])[b] for k in ARRAY_FIELDS}
        one["step"] = steps[b]
        for key in ("seed", "key"):
            if key in arrays:
                one[key] = np.asarray(arrays[key])[b]
        scenes.append(state_from_arrays(
            params, one, device, None if draws is None else draws[b]
        ))
    return stack_states(scenes)


def batch_state_to_arrays(state: SimState) -> dict:
    """numpy dict of a batched state (inverse of
    :func:`batch_state_from_arrays`, draw sources excluded): each field
    with its scene axis, ``step`` one int32 per scene as in the JAX
    package."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in ARRAY_FIELDS}
    out["step"] = np.full((state.pos.shape[0],), state.step, np.int32)
    return out


def state_to_arrays(state: SimState) -> dict:
    """numpy dict of every array field plus ``step`` (inverse of
    :func:`state_from_arrays`, generator excluded)."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in ARRAY_FIELDS}
    out["step"] = np.int32(state.step)
    return out


def make_state(
    params: SimParams,
    pos: np.ndarray,
    vel: np.ndarray | None = None,
    rad: np.ndarray | None = None,
    phase: np.ndarray | None = None,
    dead: np.ndarray | None = None,
    seed: int | None = None,
    device="cuda",
) -> SimState:
    """Build a padded device state from host (n_cells, ...) arrays.

    Initial radii / payload handling replicates particlebot.cpp:784-791:
    every bot starts at ``min_radius``; the payload (last bot, n_dead == -1)
    gets ``min_radius * rad_factor`` and is flagged dead (never modulates).
    """
    n = params.n_cells
    n_pad = padded_n(params)

    def pad2(a):
        out = np.zeros((n_pad, 2), dtype=np.float32)
        out[:n] = np.asarray(a, dtype=np.float32).reshape(n, 2)
        return out

    def pad1(a, fill=0.0, dtype=np.float32):
        out = np.full((n_pad,), fill, dtype=dtype)
        out[:n] = np.asarray(a, dtype=dtype).reshape(n)
        return out

    if vel is None:
        vel = np.zeros((n, 2), dtype=np.float32)
    if rad is None:
        rad = np.full((n,), params.min_radius, dtype=np.float32)
        if params.has_payload:
            rad[n - 1] = params.min_radius * params.rad_factor
    if phase is None:
        phase = np.zeros((n,), dtype=np.float32)
    if dead is None:
        dead = np.zeros((n,), dtype=bool)
        if params.has_payload:
            dead[n - 1] = True

    # Padding slots start far outside the world and are flagged dead.  NOTE:
    # this is NOT a standing no-interaction invariant — the integrator's
    # boundary clamp (ops/integrate.py) pulls every row to +-world_half after
    # one step, leaving all padding rows coincident at the world corner.
    # Consumers MUST mask (grid bbox, force valid masks all do); never rely
    # on padding positions staying remote.
    pos_p = pad2(pos)
    pos_p[n:] = 1.0e6 + 4.0 * np.arange(n_pad - n, dtype=np.float32)[:, None]
    # Reference parks unwritten trail slots at x=-5000 (particlebot.cpp:778)
    ring = np.zeros((params.centroid_steps, 2), np.float32)
    ring[:, 0] = -5000.0
    return state_from_arrays(
        params,
        {
            "pos": pos_p,
            "vel": pad2(vel),
            "rad": pad1(rad),
            "phase": pad1(phase),
            "dead": pad1(dead, fill=True, dtype=bool),
            "abs_force_a": np.zeros((n_pad,), np.float32),
            "abs_force_r": np.zeros((n_pad,), np.float32),
            "centroid_ring": ring,
            "step": 0,
            "seed": params.seed if seed is None else seed,
        },
        device,
    )
