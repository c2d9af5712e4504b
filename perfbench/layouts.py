"""Initial swarm layouts the benchmark makes its inputs from.

A frozen copy of the reference simulator's HEX and RANDOM placement rules
(particlebot.cpp:438-481 and 612-747), as the port's
``models/placement.py`` states them.  The benchmark places the bots itself
and hands the same positions to the program and to the plain reference, so
a later change to the program's placement cannot change the yardstick.
"""

from __future__ import annotations

import math

import numpy as np

_SQRT3 = math.sqrt(3.0)


def hex_layout(n: int, min_radius: float) -> np.ndarray:
    """Concentric hexagonal rings around the origin, spacing ``2 *
    min_radius``: (n, 2) float32.  Deterministic: no seed."""
    spacing = min_radius * 2.0
    dirs = [
        (1.0, 0.0), (0.5, _SQRT3 * 0.5), (-0.5, _SQRT3 * 0.5), (-1.0, 0.0),
        (-0.5, -_SQRT3 * 0.5), (0.5, -_SQRT3 * 0.5), (1.0, 0.0),
    ]
    pos = np.zeros((n, 2), dtype=np.float32)
    i, ring = 1, 1
    while i < n:
        for k in range(6):
            for j in range(ring):
                if i >= n:
                    break
                pos[i, 0] = dirs[k][0] * (ring - j) * spacing + dirs[k + 1][0] * spacing * j
                pos[i, 1] = dirs[k][1] * (ring - j) * spacing + dirs[k + 1][1] * spacing * j
                i += 1
            if i >= n:
                break
        ring += 1
    return pos


def random_accretion(n: int, min_radius: float, cell_size: float, seed: int,
                     world_half: float = 64.0) -> np.ndarray:
    """The reference's sequential stochastic packer, seeded: bot 0 at (5,
    0), bot 2 tangent to the midpoint of the first pair, every other bot
    at a random anchor and angle, its placement ring grown after 200
    rejections (the count carried across bots, as upstream), then pivoted
    in 10-degree steps until contact.  (n, 2) float32.  No payload."""
    rng = np.random.default_rng(seed)
    gmask = 511
    origin = -world_half
    pos = np.zeros((n, 2), dtype=np.float64)
    buckets: dict[tuple, list[int]] = {}

    def bucket_of(x, y):
        return (int(math.floor((x - origin) / cell_size)) & gmask,
                int(math.floor((y - origin) / cell_size)) & gmask)

    def add(i, x, y):
        pos[i] = (x, y)
        buckets.setdefault(bucket_of(x, y), []).append(i)

    def overlaps(x, y) -> bool:
        bx, by = bucket_of(x, y)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for j in buckets.get(((bx + dx) & gmask, (by + dy) & gmask), ()):
                    if math.hypot(x - pos[j, 0], y - pos[j, 1]) < 2.0 * min_radius:
                        return True
        return False

    add(0, 5.0, 0.0)
    inc = math.radians(10.0)
    failures = 0
    for i in range(1, n):
        if i == 2:
            d = pos[1] - pos[0]
            d = d / np.linalg.norm(d)
            side = np.array([d[1], -d[0]]) if rng.integers(2) else np.array([-d[1], d[0]])
            x, y = (pos[0] + pos[1]) / 2.0 + side * min_radius
            add(i, x, y)
            continue
        r = min_radius
        while True:
            anchor = int(rng.integers(i))
            if failures == 200:
                failures = 0
                r += min_radius
            theta = 2.0 * math.pi * rng.random()
            x = pos[anchor, 0] + 2.0 * r * math.cos(theta)
            y = pos[anchor, 1] + 2.0 * r * math.sin(theta)
            if overlaps(x, y):
                failures += 1
                continue
            start = theta
            while theta - start < 2.0 * math.pi:
                theta += inc
                x = pos[anchor, 0] + 2.0 * r * math.cos(theta)
                y = pos[anchor, 1] + 2.0 * r * math.sin(theta)
                if overlaps(x, y):
                    theta -= inc
                    break
            x = pos[anchor, 0] + 2.0 * r * math.cos(theta)
            y = pos[anchor, 1] + 2.0 * r * math.sin(theta)
            break
        add(i, x, y)
    return pos.astype(np.float32)
