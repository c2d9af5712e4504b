"""The ``hex100k.scene`` cell: the paper's largest swarm on the port's
normal path.  Its configuration resolves to the adaptive table loop with
spill rows; a small run of the cell on the CPU judges the program against
the plain reference, and the bfloat16 control fails the cell's limits;
and (marked ``cuda``) the full-size cell on the card is correct, and a
fault planted in its table loop is not."""

import json

import pytest
import torch

from perfbench import check, harness
from perfbench.spec import Bench
from perfbench.tests.test_perfbench_run import one_thread, plant, small_run  # noqa: F401
from perfbench.workload import program_params

BENCH = Bench()
CELL = "hex100k.scene"


def test_the_config_resolves_to_the_adaptive_table_loop_with_spill_rows():
    from particlerobotsimulations_torch.config import ForceBackend
    from particlerobotsimulations_torch.engine import make_run_chunk

    config = BENCH.config(BENCH.cell(CELL)["config"])
    params = program_params(config, BENCH.config_path("hex100k").parent, 2**31 + 5)
    assert params.n_cells == 100_000 and params.resolved_backend("cuda") == ForceBackend.PALLAS
    # G=160, 16 slots a cell that kernel 1 sees, 8 spill rows above them
    assert params.resolved_grid_dim() == 160
    assert (params.cell_capacity, params.storage_capacity()) == (16, 24)
    # AUTO: the adaptive cadence (K 4, and 8 where the probe certifies it)
    runner = make_run_chunk(params, torch.device("cuda"))
    assert runner.path_info["adaptive"] and runner.live == {"k": 4}
    assert BENCH.traffic(BENCH.cell(CELL)["traffic"])["chunk_steps"] == params.dump_steps


def test_a_small_run_of_the_cell_is_correct():
    # 256 bots on the table loop with the cell's 8 spill rows
    r = small_run(CELL, path="table")
    assert r["correct"], r["checks"]
    assert r["attempted"] == 1 and r["failed"] == 0


def test_the_control_is_not_correct_by_the_cells_limits():
    # the reference in bfloat16 in the program's place, on the small run
    r = small_run(CELL, seed=9, path="table", with_control=True)
    assert r["correct"]
    assert not check.judge(r["_info"]["control"], BENCH.limits(CELL))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["none", "one_answer_altered"])
def test_the_cell_at_full_size_on_the_card(monkeypatch, fault):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if fault != "none":
        plant(monkeypatch, fault)
    r = harness.run_cell(BENCH, CELL, 2**31 + 29, 1.0, False, "cuda")
    print(json.dumps({"cell": CELL, "fault": fault, "numbers": r["_info"]["numbers"],
                      "live_k": r["_info"]["live_k"], "rebuilds": r["_info"]["rebuilds"]}))
    assert r["correct"] is (fault == "none"), r["checks"]
