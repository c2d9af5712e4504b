"""PyTorch port, the profiling helpers (``utils/profiling.py``): the twin of
``tests/test_profiling.py`` on the CPU, the per-device overhead cache and
``scaling_report``'s rows in the JAX package's format.  Timings here are
the CPU's; the tests check the contract, not the numbers."""

import re

import torch

import particlerobotsimulations_torch as pt
from particlerobotsimulations_torch.utils import profiling

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)


def test_measure_throughput():
    p = pt.SimParams(n_cells=16, n_dead=0, config=pt.Config.HEX, light_x=-5.0)
    t = profiling.measure_throughput(p, n_steps=50, reps=1, device="cpu")
    assert t.n_bots == 16
    assert t.particle_steps_per_sec > 0
    assert t.steps_per_sec * 16 == t.particle_steps_per_sec
    assert t.ms_per_step > 0
    assert t.backend == "DENSE"


def test_call_overhead_cached_per_device(monkeypatch):
    """One measurement per device, whatever names it (a string or a
    ``torch.device``); ``sync`` takes a tensor, a state or a device."""
    monkeypatch.setattr(profiling, "_OVERHEAD_CACHE", {})
    first = profiling.measure_call_overhead(reps=2, device="cpu")
    assert first > 0
    assert profiling.measure_call_overhead(device=torch.device("cpu")) == first
    assert list(profiling._OVERHEAD_CACHE) == [torch.device("cpu")]
    state = pt.Simulation(pt.SimParams(n_cells=4, n_dead=0, config=pt.Config.HEX),
                          device="cpu").state
    for x in (state, state.pos, "cpu"):
        profiling.sync(x)
    assert profiling.card("cpu") == "cpu"


def test_scaling_report_rows(capsys):
    rows = profiling.scaling_report((8, 12), device="cpu", n_steps=20, reps=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [r.n_bots for r in rows] == [8, 12]
    # particlerobotsimulations_tpu/utils/profiling.py's row format
    row = re.compile(
        r"^n=\s*(\d+)\s+(\d+\.\d{3}) ms/step\s+(\d+\.\d{2}) M particle-steps/s\s+\[(\w+)\]$"
    )
    for line, r in zip(lines, rows):
        m = row.match(line)
        assert m, line
        assert int(m.group(1)) == r.n_bots and m.group(4) == "DENSE"
        assert float(m.group(2)) == round(r.ms_per_step, 3) > 0
    assert len(lines) == 2
