"""Monte-Carlo seed sweeps: many scenes of one scenario, one per seed.

Port of ``particlerobotsimulations_tpu.parallel.sweep``.  The paper's
workflow (robustness against the dead-cell fraction, seed sweeps) runs many
seeds of one scenario; each scene is independent.  :func:`run_sweep` runs
them by one of three strategies:

* ``sequential``: the single-scene chunk runner (``engine.make_run_chunk``)
  over the seeds, one after another;
* ``batched``: every scene in one batched state (:func:`make_batch_state`)
  through ``engine.make_run_chunk_batched``, where one sequence of launches
  serves all scenes (on PALLAS, kernels 1 to 3 each take every scene in one
  launch);
* ``packed``: the scenes tiled into one union table (``packed.py``).

:func:`choose_sweep_strategy` keeps the JAX package's rule and thresholds,
which were measured on a TPU (its table at ``sweep.py:27-44``): batched
everywhere except the megakernel band (PALLAS, mega-eligible tables), which
runs sequential; packed only on a TPU, which the port never runs on, so
AUTO never picks it here and only ``strategy="packed"`` reaches it.  Not
ported: the ``PBOT_SWEEP_STRATEGY`` knob (``strategy=`` covers it).

Over a device mesh (``parallel/mesh.py``) the scene batch is the
parallel axis, as in the JAX package: the strategy is always ``batched``,
:func:`shard_batch` splits the batch into one scene group per place of
the mesh's data axis, and each group runs the batched loop on its place.
A batched table loop decides its slot rebuilds once for all scenes of
what it runs (``engine_table._smart_rebuild``), so over a mesh each group
decides for its own scenes: a scene's run can differ from its run in the
whole batch where some other scene fell back.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..config import ForceBackend, SimParams
from ..engine import make_run_chunk, make_run_chunk_batched
from ..models.placement import initial_state_arrays, resolve_params
from ..rng import SceneDraws
from ..state import ARRAY_FIELDS, SimState, make_state, stack_states
from .mesh import Mesh, default_mesh  # noqa: F401  (default_mesh: where the JAX package has it)
from .ring import _device

STRATEGIES = ("sequential", "batched", "packed")


def _scene_state(params: SimParams, seed: int, device, draws) -> SimState:
    """A fresh scene for ``seed`` (placement on the host), drawing from
    ``draws(seed)`` when given, else from a generator seeded with it."""
    p_eff, pos, vel, rad, phase, dead = initial_state_arrays(
        params.replace(seed=int(seed))
    )
    state = make_state(p_eff, pos, vel, rad, phase, dead, seed=int(seed), device=device)
    if draws is not None:
        state = state.replace(generator=draws(int(seed)))
    return state


def make_batch_state(params: SimParams, seeds: Sequence[int], device="cuda",
                     draws: Callable[[int], object] | None = None) -> SimState:
    """Stack fresh scenes (one per seed) along a leading scene axis.
    Placement runs on the host per seed; each scene keeps its own draw
    source (``draws(seed)``, a step-keyed provider, or by default a
    ``torch.Generator`` seeded with the seed), so scene b draws what its
    run alone would draw."""
    return stack_states([_scene_state(params, s, device, draws) for s in seeds])


def _group_bounds(n_scenes: int, n_groups: int) -> list:
    """(start, stop) of each non-empty scene group: the scenes cut into
    ``n_groups`` contiguous groups, the first ones a scene larger where
    they do not divide."""
    sizes = [n_scenes // n_groups + (g < n_scenes % n_groups) for g in range(n_groups)]
    starts = np.cumsum([0] + sizes)
    return [(int(a), int(b)) for a, b in zip(starts[:-1], starts[1:]) if b > a]


def shard_batch(state: SimState, mesh: Mesh, axis: str = "data") -> list:
    """A batched state split into one scene group per place along the
    mesh's ``axis``, each on its place's device (contiguous groups, in
    scene order; a place gets no group when there are fewer scenes than
    places).  Each group keeps its scenes' draw sources; a
    ``torch.Generator`` cannot change device, so one that is not on its
    group's device raises ValueError."""
    devices = mesh.axis_devices(axis)
    groups = []
    for (lo, hi), dev in zip(_group_bounds(state.pos.shape[0], len(devices)), devices):
        sources = state.generator.sources[lo:hi]
        for s in sources:
            if isinstance(s, torch.Generator) and _device(s.device) != dev:
                raise ValueError(f"a scene's generator is on {s.device}, its place on {dev}")
        groups.append(SimState(
            step=state.step, generator=SceneDraws(sources),
            **{k: getattr(state, k)[lo:hi].to(dev) for k in ARRAY_FIELDS},
        ))
    return groups


def gather_batch(groups, device=None) -> SimState:
    """The scene groups of :func:`shard_batch` joined into one batched
    state on ``device`` (default: the first group's), in group order."""
    device = groups[0].device if device is None else device
    return SimState(
        step=groups[0].step,
        generator=SceneDraws([s for g in groups for s in g.generator.sources]),
        **{k: torch.cat([getattr(g, k).to(device) for g in groups]) for k in ARRAY_FIELDS},
    )


def choose_sweep_strategy(params: SimParams, n_scenes: int, mesh=None,
                          device="cuda") -> str:
    """``"sequential"`` or ``"batched"`` for ``n_scenes`` scenes on
    ``device``: the JAX package's rule.  One scene runs sequential; the
    megakernel band (the PALLAS backend on a mega-eligible table) runs
    sequential, because there a single scene's span kernel beat the
    batched span on the TPU; everything else runs batched.  The packed
    strategy is picked by AUTO only on a TPU.  With a mesh the scene batch
    is the parallel axis: always batched."""
    if mesh is not None:
        return "batched"
    if n_scenes <= 1:
        return "sequential"
    from ..ops.megakernel import mega_eligible

    if params.resolved_backend(device) == ForceBackend.PALLAS and mega_eligible(params):
        return "sequential"
    return "batched"


def _centroid(state: SimState, n: int) -> torch.Tensor:
    """Each scene's bot-mean centroid, the padding rows masked off."""
    return torch.mean(state.pos[..., :n, :], dim=-2)


def _run_sweep_sequential(params, seeds, n_steps, record_every, seg, device, draws):
    """The single-scene chunk runner over the seeds, one after another."""
    run = make_run_chunk(params, device)
    n = params.n_cells
    finals, all_records = [], []
    for s in seeds:
        state = _scene_state(params, s, device, draws)
        # centroids stay on the device until the end: one host read for the
        # whole sweep
        recs = [_centroid(state, n)]
        done = 0
        while done < n_steps:
            chunk = min(record_every, n_steps - done)
            state = run(state, chunk, seg > 0 and done % seg == 0)
            done += chunk
            recs.append(_centroid(state, n))
        finals.append(state)
        all_records.append(torch.stack(recs))
    # (n_records, n_scenes, 2), the batched recorder's layout
    return stack_states(finals), torch.stack(all_records, dim=1).cpu().numpy()


def run_sweep(
    params: SimParams,
    seeds: Sequence[int],
    n_steps: int,
    mesh=None,
    record_every: int | None = None,
    strategy: str | None = None,
    device="cuda",
    draws: Callable[[int], object] | None = None,
):
    """Run ``len(seeds)`` scenes for ``n_steps`` on ``device``; returns
    (final_state, centroid_trajectories (n_records, n_scenes, 2)).

    ``record_every`` defaults to the scenario's dump interval.  The final
    state is batched (a leading scene axis; for ``packed``, the union).
    ``strategy`` None picks one by :func:`choose_sweep_strategy`.
    ``draws`` maps a seed to its scene's draw source (the tests hand in
    the JAX package's draws); by default each scene draws from a generator
    seeded with its seed, the same under every strategy.

    With a ``mesh`` (``parallel/mesh.Mesh``; ``device`` is then ignored)
    the seeds are cut into one group per place of its ``"data"`` axis,
    as :func:`shard_batch` cuts a batch, each group is placed and run by
    the batched loop on its place's device, every group's chunk enqueued
    block by block in turn (``chunk.interleave``) before any result
    is read, and the final state and the centroids come
    back in seed order on the first place.  Any strategy but ``batched``
    raises ValueError there, as in the JAX package."""
    from ..chunk import interleave
    from ..engine_table import gate_seg

    # Nx == 0 -> config_size_x, exactly as Simulation resolves it — the
    # actuation wave period must match single-scene runs
    params = resolve_params(params.validate())
    places = [device] if mesh is None else mesh.axis_devices("data")
    device = places[0]
    record_every = record_every or params.dump_steps
    seg = gate_seg(params) if params.resolved_backend(device) == ForceBackend.PALLAS else 0
    if strategy is None:
        strategy = choose_sweep_strategy(params, len(seeds), mesh, device)
    elif strategy not in STRATEGIES:
        raise ValueError(f"unknown sweep strategy: {strategy!r}")
    elif strategy != "batched" and mesh is not None:
        raise ValueError(
            f"strategy={strategy!r} is incompatible with a device mesh "
            "(the scene batch is the sharding axis)"
        )
    if strategy == "packed":
        from .packed import run_sweep_packed

        return run_sweep_packed(params, seeds, n_steps, record_every, device, draws)
    if strategy == "sequential":
        return _run_sweep_sequential(
            params, seeds, n_steps, record_every, seg, device, draws
        )

    groups = [
        (make_batch_state(params, seeds[lo:hi], dev, draws), make_run_chunk_batched(params, dev))
        for (lo, hi), dev in zip(_group_bounds(len(seeds), len(places)), places)
    ]
    n = params.n_cells
    records = [[_centroid(state, n) for state, _ in groups]]
    done = 0  # scenes start at step 0 and advance in lockstep
    while done < n_steps:
        chunk = min(record_every, n_steps - done)
        aligned = seg > 0 and done % seg == 0
        states = interleave([run.blocks(state, chunk, aligned) for state, run in groups])
        groups = [(state, run) for state, (_, run) in zip(states, groups)]
        done += chunk
        records.append([_centroid(state, n) for state, _ in groups])
    cents = torch.stack([torch.cat([c.to(device) for c in rec]) for rec in records])
    return gather_batch([state for state, _ in groups], device), cents.cpu().numpy()


def sweep_summary(centroids: np.ndarray, params: SimParams):
    """Aggregate a sweep into mean/std distance-to-light trajectories."""
    light = np.array([params.light_x, params.light_y], dtype=np.float64)
    d = np.linalg.norm(centroids - light, axis=-1)  # (n_records, n_scenes)
    return {
        "distance_mean": d.mean(axis=1),
        "distance_std": d.std(axis=1),
        "centroid_mean": centroids.mean(axis=1),
    }
