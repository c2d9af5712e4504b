"""PyTorch port, the throughput bench (``bench.py``) and ``cli bench`` on the
CPU at a cut workload: one JSON line with the JAX package's bench.py keys,
the multi-place branch on a virtual mesh, and the CLI reaching the bench
(and refusing to stand in a CPU run for a missing card)."""

import json
import math

import torch

import particlerobotsimulations_torch as pt
from particlerobotsimulations_torch import bench, cli
from particlerobotsimulations_torch.engine import make_run_chunk
from particlerobotsimulations_torch.parallel.mesh import Mesh
from particlerobotsimulations_torch.state import scene_state

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

# the keys of bench.py's JSON line (bench.py:95-104)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}


def test_bench_prints_one_json_line(capsys):
    record = bench.run_bench(device="cpu", n_bots=64, steps=200)
    lines = capsys.readouterr().out.strip().splitlines()
    parsed = []
    for line in lines:
        try:
            parsed.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    assert len(parsed) == 1 and lines[-1].startswith("{")
    out = parsed[0]
    assert out == record and set(out) == BENCH_KEYS
    assert out["metric"] == "particle_steps_per_sec_10k_bots_torch"
    assert out["unit"] == "particle-steps/s" and out["vs_baseline"] is None
    assert math.isfinite(out["value"]) and out["value"] > 0
    assert lines[0] == "card: cpu"
    assert "1 chunks of 200 steps, 1 scene(s) of 64 bots on DENSE" in lines[1]


def test_bench_multi_place_scene0_equals_solo_seed0():
    """Two places of a virtual CPU mesh: one scene each, seeds 0 and 1,
    through the batched loop; scene 0 equals a run of seed 0 alone, bit
    for bit (the CPU computes a batched scene as the scene alone)."""
    params, states, runs, batch = bench.build("cpu", n_bots=64, mesh=Mesh(["cpu"] * 2))
    assert batch == 2 and [s.pos.shape[0] for s in states] == [1, 1]
    states = [run(s, 20) for s, run in zip(states, runs)]
    solo = pt.Simulation(params.replace(seed=0), device="cpu")
    want = make_run_chunk(solo.params, "cpu")(solo.state, 20)
    got = scene_state(states[0], 0)
    for k in ("pos", "vel", "rad", "phase", "abs_force_a", "abs_force_r"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    other = pt.Simulation(params.replace(seed=1), device="cpu").state
    want = make_run_chunk(params, "cpu")(other, 20)
    assert torch.equal(scene_state(states[1], 0).pos, want.pos)


def test_cli_bench_reaches_the_bench(monkeypatch, capsys):
    """``cli bench`` runs the package's bench on its ``--device``; without
    CUDA the default device exits non-zero before any run."""
    calls = []
    monkeypatch.setattr(bench, "run_bench", lambda device: calls.append(device))
    assert cli.main(["bench", "--device", "cpu"]) == 0
    assert calls == ["cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["bench"]) == 1
    assert calls == ["cpu"]
    assert "CUDA is not available" in capsys.readouterr().err
