"""A run of the harness: without a card it refuses; on the CPU at a small
size the rest of a run judges the program against the plain reference,
and the faults a cell can have, planted underneath, come out not correct;
so does the control; and nothing the run loads is JAX."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench import check, harness
from perfbench.spec import ROOT, Bench

BENCH = Bench()
BANNED = {"jax", "jaxlib", "flax", "particlerobotsimulations_tpu"}
# small scenes on the CPU: 200-step chunks, the window one chunk; AUTO
# takes the per-bot DENSE step there at 64 bots, ``table`` runs the table
# loop's K=4 blocks (spill rows keep it off the span path) and ``span``
# the span path, whose 200-step segments are one block each
SMALL = {"scenes": 1, "chunk_steps": 200, "read": "state"}
PATHS = {"dense": {"n_cells": 64},
         "table": {"n_cells": 256, "force_backend": "PALLAS", "overflow_slots": 8},
         "span": {"n_cells": 256, "force_backend": "PALLAS"}}


def small_config(cell, path="dense"):
    from particlerobotsimulations_torch.config import ForceBackend

    config = dict(BENCH.config(BENCH.cell(cell)["config"]))
    params = {k: v for k, v in config["params"].items() if k != "max_time"}
    params.update(PATHS[path])
    if "force_backend" in params:
        params["force_backend"] = ForceBackend[params["force_backend"]]
    config.update(cfg=None, params=params)
    return config


def small_run(cell, scenes=1, seed=5, path="dense", with_control=False):
    traffic = dict(SMALL, scenes=scenes, read="state" if scenes == 1 else "centroids")
    return harness.run_cell(BENCH, cell, seed, 0.0, False, "cpu", config=small_config(cell, path),
                            traffic=traffic, with_control=with_control)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "hex10k.scene",
                        "--seed", "3", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "metrics" not in p.stdout and "particle_steps_per_s" not in p.stdout


def test_harness_sources_import_no_jax():
    for path in sorted((ROOT / "perfbench").rglob("*.py")):
        if "tests" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in BANNED, (path, name)


def test_a_run_loads_no_jax():
    code = (
        "import sys, torch; torch.set_num_threads(1)\n"
        "from perfbench import harness; from perfbench.spec import Bench\n"
        "from perfbench.tests.test_perfbench_run import small_run\n"
        "small_run('obstacle500.sweep8', seed=3)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "particlerobotsimulations_torch" in loaded
    assert not loaded & BANNED


CASES = [("hex10k.scene", 1, "dense"), ("hex10k.scene", 1, "table"),
         ("obstacle500.sweep8", 2, "dense"), ("hex10k.scene", 1, "span")]
# the cell whose limits judge the span path's small runs
SPAN_CELL = "hex10k.scene"


@pytest.mark.parametrize("cell,scenes,path", CASES)
def test_a_sound_run_is_correct(cell, scenes, path):
    r = small_run(cell, scenes, path=path)
    assert r["correct"], r["checks"]
    assert r["attempted"] == scenes and r["failed"] == 0
    assert list(r)[-2:] == ["checks", "_info"]
    assert set(r["metrics"]) == {"particle_steps_per_s", "peak_mem_mib", "setup_s"}
    # every piece but the first runs 8 steps: between two block ends of
    # the chunk, or on the span path from the chunk's entry and its answer;
    # the span path adds kernel 3's own spans, K=4 steps each, and its
    # first segment run again eagerly lands on the window's replay exactly
    pieces = r["_info"]["pieces"]
    spans = check.SPAN_PIECES if path == "span" else 0
    assert all(steps == 8 for _, steps in pieces[1:len(pieces) - spans])
    assert all(steps == 4 for _, steps in pieces[len(pieces) - spans:])
    assert len(pieces) == (3 + spans if path == "span" else 5)
    numbers = r["_info"]["numbers"]
    assert (numbers.get(check.REPLAY) == 0.0) if path == "span" else check.REPLAY not in numbers


def _unchanged(out, carry):
    return {k: carry.get(k, v) for k, v in out.items()}


def _half_left_out(out, carry):
    half = {}
    for k, v in out.items():
        if k in carry and v.dim() > 0 and v.shape[0] > 1 and v.shape == carry[k].shape:
            keep = v.shape[0] // 2
            v = torch.cat([v[:keep], carry[k][keep:]])
        half[k] = v
    return half


def _one_answer_altered(out, carry):
    out = dict(out)
    if "px" in out:
        px = out["px"].clone()
        first = (out["val"] > 0.5).long().argmax(-1)
        if px.dim() == 1:
            px[first] += 0.05
        else:
            px[torch.arange(px.shape[0]), first] += 0.05
        out["px"] = px
    else:
        pos = out["pos"].clone()
        pos[..., 0, 0] += 0.05
        out["pos"] = pos
    return out


FAULT = {"unchanged": _unchanged, "half_left_out": _half_left_out,
         "one_answer_altered": _one_answer_altered}


def plant(monkeypatch, fault):
    """Every block the runners replay (``_graphed``, the table loop's and
    the per-bot step's) returns its output broken by ``fault``."""
    from particlerobotsimulations_torch import engine, engine_table

    real = engine_table._graphed

    def broken(graphs, key, block, carry, step):
        return FAULT[fault](real(graphs, key, block, carry, step), carry)

    monkeypatch.setattr(engine_table, "_graphed", broken)
    monkeypatch.setattr(engine, "_graphed", broken)


# each fault a cell can have: a scene cell has no batch to leave half of
FAULTS = [(c, 1, p, f) for c, _, p in CASES[:2] + CASES[3:]
          for f in ("unchanged", "one_answer_altered")] + [
    ("obstacle500.sweep8", 2, "dense", f)
    for f in ("unchanged", "half_left_out", "one_answer_altered")]


@pytest.mark.parametrize("cell,scenes,path,fault", FAULTS)
def test_a_fault_underneath_is_not_correct(monkeypatch, cell, scenes, path, fault):
    plant(monkeypatch, fault)
    r = small_run(cell, scenes, path=path)
    assert not r["correct"], r["checks"]


def _span_unchanged(real, *args):
    tbl, strip = args[1], args[2]
    return tbl.clone(), strip.clone()


def _span_one_row_moved(real, *args):
    from particlerobotsimulations_torch.engine_table import TABLE_FIELDS

    tbl, strip = real(*args)
    tbl = tbl.clone()
    # the first occupied row, chosen on the device (a graph may capture it)
    occupied = tbl[TABLE_FIELDS.index("val")].reshape(-1) > 0.5
    rows = torch.arange(occupied.numel(), device=tbl.device)
    tbl[TABLE_FIELDS.index("px")].view(-1).add_(0.05 * (rows == occupied.long().argmax()))
    return tbl, strip


SPAN_FAULT = {"unchanged": _span_unchanged, "one_answer_altered": _span_one_row_moved}


def plant_in_kernel3(monkeypatch, fault):
    """Kernel 3 alone returns its answer broken by ``fault``: its plain
    twin on the CPU, the CUDA wrapper on the card.  Every other part of
    the span path (the segment's first block, the rebuilds between spans,
    the closing post, the regular blocks) is left as it is."""
    from particlerobotsimulations_torch import kernels
    from particlerobotsimulations_torch.ops import megakernel

    for module, name in ((megakernel, "mega_span_plain"), (kernels, "mega_span_cuda")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, _real=real: SPAN_FAULT[fault](_real, *a))


@pytest.mark.parametrize("fault", sorted(SPAN_FAULT))
def test_a_fault_in_kernel3_alone_is_not_correct(monkeypatch, fault):
    plant_in_kernel3(monkeypatch, fault)
    r = small_run(SPAN_CELL, path="span")
    assert not r["correct"], r["checks"]


def _kicked(monkeypatch):
    """Every scene starts with one bot kicked to 60 u/s: it crosses
    several cells between two rebuilds for the whole run, so every span
    rebuild refuses and every span segment is redone."""
    from perfbench.workload import Workload

    real = Workload.initial

    def initial(self):
        st = real(self)
        vel = st.vel.clone()
        vel[..., 7, 0] += 60.0
        return st.replace(vel=vel)

    monkeypatch.setattr(Workload, "initial", initial)


@pytest.mark.parametrize("kick,share", [(False, 0.0), (True, 1.0)])
def test_the_redo_share_counts_the_windows_redone_segments(monkeypatch, kick, share):
    from types import SimpleNamespace

    if kick:
        _kicked(monkeypatch)
    info = small_run(SPAN_CELL, path="span")["_info"]
    assert info["span_segments"] == 1
    read = BENCH.reader("span.redo_share")
    assert read(SimpleNamespace(span_segments=info["span_segments"], redos=info["redos"])) == share
    # no span segment, nothing to read
    assert read(SimpleNamespace(span_segments=0, redos=None)) is None


@pytest.mark.parametrize("cell,scenes,path", CASES)
def test_the_control_is_not_correct(cell, scenes, path):
    r = small_run(cell, scenes, seed=9, path=path, with_control=True)
    assert r["correct"]
    assert not check.judge(r["_info"]["control"], BENCH.limits(cell))


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "obstacle500.sweep8",
                        "--seed", str(2**31 + 5),
                        "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert list(r)[-1] == "checks"
    assert p.stderr.strip().splitlines()[-1].startswith("check ")


# the faults planted in the table loop that the 10k cells time, at their
# own size on the card
CARD_FAULTS = [("hex10k.scene", f) for f in ("unchanged", "one_answer_altered")] + [
    ("hex10k.sweep8", f) for f in ("unchanged", "half_left_out", "one_answer_altered")]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", CARD_FAULTS)
def test_a_fault_in_the_table_loop_at_full_size_is_not_correct(monkeypatch, cell, fault):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    plant(monkeypatch, fault)
    r = harness.run_cell(BENCH, cell, 2**31 + 17, 1.0, False, "cuda")
    print(json.dumps({"cell": cell, "fault": fault, "numbers": r["_info"]["numbers"],
                      "limits": BENCH.limits(cell)}))
    assert not r["correct"], r["checks"]


def waiting_bench():
    """The benchmark with ``band1k.scene``, the span path's cell that waits
    for the band swell (PERF.md section 7), whose configuration and limits
    are kept under ``perfbench/``."""
    bench = Bench()
    bench.data["configs"].append({"name": "band1k", "file": "perfbench/configs/band1k.json"})
    bench.data["workloads"].append(
        {"name": "band1k.scene", "config": "band1k", "traffic": "scene", "chips": 1})
    return bench


def test_the_waiting_span_cell_resolves():
    from perfbench.workload import program_params

    bench = waiting_bench()
    limits = bench.limits("band1k.scene")
    assert limits[check.REPLAY] == 0.0 and set(limits) == set(check.NUMBERS) | {check.REPLAY}
    params = program_params(bench.config("band1k"), bench.config_path("band1k").parent, 7)
    # the span path's table: AUTO's G=16 at C=16, 4,096 rows, K=4
    assert params.resolved_grid_dim() == 16 and params.resolved_slot_rebuild_steps() == 4
    assert params.storage_capacity() == 16 and params.n_cells == 1000


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["none"] + sorted(SPAN_FAULT))
def test_kernel3_at_full_size_is_judged_on_its_own_answers(monkeypatch, fault):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if fault != "none":
        plant_in_kernel3(monkeypatch, fault)
    r = harness.run_cell(waiting_bench(), "band1k.scene", 2**31 + 23, 1.0, False, "cuda")
    info = r["_info"]
    print(json.dumps({"cell": "band1k.scene", "fault": fault, "numbers": info["numbers"],
                      "pieces": info["pieces"], "span_segments": info["span_segments"],
                      "redos": info["redos"]}))
    if fault == "none":
        assert r["correct"], r["checks"]
        assert info["numbers"][check.REPLAY] == 0.0
    else:
        assert not r["correct"], r["checks"]


@pytest.mark.parametrize("live,probe,settled", [
    (None, None, True), ({"k": 4}, None, False), ({"k": 4}, 5.0, False), ({"k": 8}, 1.0, True)])
def test_the_warm_up_waits_for_a_certified_cadence(live, probe, settled):
    from types import SimpleNamespace

    from perfbench.workload import Workload

    wl = Workload.__new__(Workload)
    wl.runner = SimpleNamespace(live=live, last_probe=probe, path_info={"bound8": 3.4})
    assert wl.settled() is settled
