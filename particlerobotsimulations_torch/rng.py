"""The run's random draws: dead-cell scores and phase noise.

Every site that draws goes through :func:`uniform` and :func:`normal` with
the step it draws for and the layout it draws in: the per-bot engine's dead
injection and phase law (``(n_pad,)``), the table loops' (the
``(total_ext,)`` table and parking rows), and the sharded loop's (the same
single-table layout, cut into shards).  The source a state carries decides
what comes back:

* a ``torch.Generator`` (the default, seeded from ``params.seed``) is drawn
  from in call order: ``torch.rand`` and ``torch.randn`` of the shape, the
  step ignored.  The loops take a block's draws before the block, in the
  order its steps would draw them, and feed them in (:class:`Drawn`), so
  a CUDA graph replays gated steps and a span segment's redo takes the
  same values again; :func:`snapshot` / :func:`restore` let a caller that
  redoes steps by drawing again (a reference loop) draw the same values;
* any other object is a step-keyed provider (:class:`StepDraws`): its
  values depend only on the step and the shape, so a replay draws the same
  values with nothing to restore.  The tests hand in one that returns the
  JAX package's draws for the same seed (``uniform(fold_in(key, step))``
  and ``normal(fold_in(fold_in(key, step), 1))``), which puts the two
  packages on one stream;
* a :class:`SceneDraws` (a batch of scenes, one source each) stacks each
  scene's own draw: the shape asked for is the batch's, ``(B, *shape)``,
  and scene b gets what its source gives for ``shape`` at that step, the
  same values as a run of scene b alone.  Its snapshot is every scene's.
"""

from __future__ import annotations

from typing import Protocol

import torch


class StepDraws(Protocol):
    """A draw provider keyed by step: the same (step, shape) gives the same
    values, on ``device``, float32."""

    def uniform(self, step: int, shape: tuple, device) -> torch.Tensor:
        """U[0, 1) scores (dead-cell injection)."""

    def normal(self, step: int, shape: tuple, device) -> torch.Tensor:
        """Standard normal values (phase noise, before ``phase_std``)."""


class SceneDraws:
    """The draw sources of a batch of scenes, one per scene, in scene
    order: ``torch.Generator`` s, step-keyed providers, or both."""

    def __init__(self, sources):
        self.sources = list(sources)

    def _stack(self, draw, step: int, shape: tuple, device) -> torch.Tensor:
        shape = tuple(shape)
        if not shape or shape[0] != len(self.sources):
            raise ValueError(
                f"a draw for {len(self.sources)} scenes needs shape (B, ...), got {shape}"
            )
        return torch.stack([draw(s, step, shape[1:], device) for s in self.sources])


class Drawn:
    """A provider that returns values drawn beforehand: lets a function
    that draws through this module run under ``torch.func.vmap`` with its
    draws taken outside."""

    def __init__(self, uniform=None, normal=None):
        self._uniform, self._normal = uniform, normal

    def uniform(self, step, shape, device):
        return self._uniform

    def normal(self, step, shape, device):
        return self._normal


def uniform(source, step: int, shape: tuple, device) -> torch.Tensor:
    """U[0, 1) float32 values of ``shape`` for ``step``."""
    if isinstance(source, torch.Generator):
        return torch.rand(shape, generator=source, device=device)
    if isinstance(source, SceneDraws):
        return source._stack(uniform, step, shape, device)
    return source.uniform(step, shape, device)


def normal(source, step: int, shape: tuple, device) -> torch.Tensor:
    """Standard normal float32 values of ``shape`` for ``step``."""
    if isinstance(source, torch.Generator):
        return torch.randn(shape, generator=source, dtype=torch.float32, device=device)
    if isinstance(source, SceneDraws):
        return source._stack(normal, step, shape, device)
    return source.normal(step, shape, device)


def snapshot(source):
    """What :func:`restore` needs to draw the same values again: the
    generator's state, nothing for a step-keyed provider, and each scene's
    for a :class:`SceneDraws`."""
    if isinstance(source, SceneDraws):
        return [snapshot(s) for s in source.sources]
    return source.get_state() if isinstance(source, torch.Generator) else None


def restore(source, snap) -> None:
    if isinstance(source, SceneDraws):
        for s, sn in zip(source.sources, snap):
            restore(s, sn)
    elif isinstance(source, torch.Generator):
        source.set_state(snap)
