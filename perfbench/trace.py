"""The device trace of a stretch of steps, reduced to what the per-layer
metrics read.

:func:`traced` runs a function under ``torch.profiler`` with the CUDA
activity alone (no host operators are recorded, which keeps the
profiler's cost on the host small) and returns a :class:`Trace`: every
device activity (kernels, copies, fills) as an interval on the card's
clock, and the host's CUDA runtime calls beside them.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

@dataclass
class Trace:
    """Device activities as ``(name, kind, start_ns, end_ns)``; the host's
    runtime calls as ``(name, start_ns, end_ns)``; ``wall_s`` the host
    wall of the traced stretch."""

    activities: list = field(default_factory=list)
    runtime: list = field(default_factory=list)
    wall_s: float = 0.0

    def kernels(self) -> list:
        return [a for a in self.activities if a[1] == "kernel"]

    def union(self) -> list:
        """The union of the device activity intervals, in order: the
        stretches in which anything ran on the card (a body's side stream
        that overlaps the main one counts once)."""
        out: list = []
        for _, _, s, e in sorted(self.activities, key=lambda a: a[2]):
            if out and s <= out[-1][1]:
                if e > out[-1][1]:
                    out[-1][1] = e
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union()) * 1e-9

    def time_of(self, symbols) -> float:
        """Device seconds of the kernels whose name holds one of
        ``symbols``."""
        return sum(e - s for n, k, s, e in self.activities
                   if k == "kernel" and any(sym in n for sym in symbols)) * 1e-9

    def top_ops(self, k: int = 10) -> list:
        """The ``k`` device operations that took most time: ``[[name,
        seconds], ...]``, each name cut to 160 characters."""
        tot: dict = {}
        for n, _, s, e in self.activities:
            short = n[:160]
            tot[short] = tot.get(short, 0.0) + (e - s) * 1e-9
        return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle time between device activities, summed by what the host
        was doing: the runtime call last begun before the work that ended
        the gap (``host:<call>``), or ``host:none`` where the trace holds
        no runtime call.  ``[[label, seconds], ...]``, the ``k`` largest."""
        u = self.union()
        calls = sorted(self.runtime, key=lambda r: r[1])
        starts = [r[1] for r in calls]
        tot: dict = {}
        for (_, e0), (s1, _) in zip(u, u[1:]):
            i = bisect.bisect_right(starts, s1) - 1
            label = "host:" + (calls[i][0] if i >= 0 else "none")
            tot[label] = tot.get(label, 0.0) + (s1 - e0) * 1e-9
        return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def traced(fn) -> Trace:
    """Run ``fn()`` (which ends with the card synchronised) under the
    profiler, CUDA activity only."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = Trace(wall_s=wall)
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            out.activities.append((name, _kind(name), ev.start_ns(), ev.end_ns()))
        elif name.startswith("cu"):
            out.runtime.append((name, ev.start_ns(), ev.end_ns()))
    return out


def _kind(name: str) -> str:
    """An activity's kind from its name: the profiler names copies
    ``Memcpy ...`` and fills ``Memset ...``, and a kernel by its symbol."""
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"
