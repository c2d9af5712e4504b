"""The run's random draws, made by the benchmark from ``--seed``.

:class:`SeedDraws` is a step-keyed draw source in the form the port takes
through its ``draws`` seam (``rng.StepDraws``): the values of a draw depend
only on the seed, the step, the kind of draw and the shape asked for.  The
program gets it as its draw source, and the plain reference asks it for
the same (step, shape) and gets the same values, so the two sides step on
one stream of phase noise.  Each draw seeds a ``torch.Generator`` on the
device it is asked for; the stream is Philox's, so a draw on the card
differs from one on the CPU, and both sides draw on one device.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def _mix(*words: int) -> int:
    """A 63-bit seed of the words (splitmix64 steps): distinct steps and
    seeds give unrelated generator seeds."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (int(w) & _MASK64)) & _MASK64
        h = (h + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h & ((1 << 63) - 1)


class SeedDraws:
    """Step-keyed U[0, 1) and standard normal float32 draws of one scene.
    ``asked`` records the shape of each draw asked for, by step: the
    reference reads from it which layout the program drew in."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self.asked: dict = {}

    def _gen(self, kind: int, step: int, device) -> torch.Generator:
        g = torch.Generator(device=torch.device(device))
        g.manual_seed(_mix(self.seed, step, kind))
        return g

    def uniform(self, step: int, shape: tuple, device) -> torch.Tensor:
        self.asked[("uniform", int(step))] = tuple(shape)
        return torch.rand(tuple(shape), generator=self._gen(1, step, device), device=device)

    def normal(self, step: int, shape: tuple, device) -> torch.Tensor:
        self.asked[("normal", int(step))] = tuple(shape)
        return torch.randn(tuple(shape), generator=self._gen(2, step, device),
                           dtype=torch.float32, device=device)
