"""PyTorch port, the device mesh (``parallel/mesh.py``), the scene groups of
a mesh (``parallel/sweep.shard_batch`` / ``gather_batch``) and the
multi-device dry run (``dryrun.py``), on the CPU.

A mesh's places may repeat one device (virtual places, as the JAX tests'
8 virtual CPU devices), so every check here runs on the CPU's one device.
Splitting a batch into groups and joining them back only moves data:
equal.  The dry run checks its eight strategies against their unsplit
references itself (positions 1e-5, velocities 1e-4; 1e-3 under the forced
fallback's 50 u/s), the JAX dry run's tolerances.
"""

import numpy as np
import pytest
import torch

import particlerobotsimulations_torch as pt
from particlerobotsimulations_torch.parallel.mesh import Mesh, default_mesh
from particlerobotsimulations_torch.parallel.sweep import (
    gather_batch,
    make_batch_state,
    shard_batch,
)
from particlerobotsimulations_torch.state import ARRAY_FIELDS

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)


def test_mesh_axes_and_places():
    m = Mesh(["cpu"] * 4)
    assert m.axis_names == ("data",) and m.shape == {"data": 4} and m.size == 4
    assert m.axis_devices("data") == [torch.device("cpu")] * 4
    m2 = Mesh(np.array(["cpu"] * 8).reshape(4, 2), ("data", "bots"))
    assert m2.shape == {"data": 4, "bots": 2}
    assert m2.axis_devices("data") == [torch.device("cpu")] * 4
    assert m2.axis_devices("bots") == [torch.device("cpu")] * 2
    mixed = Mesh([["cpu", "meta"]], ("data", "bots"))
    assert mixed.axis_devices("bots") == [torch.device("cpu"), torch.device("meta")]
    with pytest.raises(ValueError, match="span devices"):
        mixed.axis_devices("data")
    with pytest.raises(ValueError, match="axes"):
        Mesh(["cpu"] * 4, ("data", "bots"))
    with pytest.raises(ValueError, match="repeat"):
        Mesh([["cpu"]], ("data", "data"))
    assert default_mesh(device="cpu").shape == {"data": 1}
    assert default_mesh("bots", "cpu").axis_names == ("bots",)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            default_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            Mesh(["cuda"])


@pytest.mark.parametrize("n_scenes,sizes", [(8, [2, 2, 2, 2]), (5, [2, 1, 1, 1]), (2, [1, 1])])
def test_shard_batch_groups_and_gathers_back(n_scenes, sizes):
    p = pt.SimParams(n_cells=24, n_dead=0).validate()
    batch = make_batch_state(p, list(range(n_scenes)), "cpu")
    groups = shard_batch(batch, Mesh(["cpu"] * 4))
    assert [g.pos.shape[0] for g in groups] == sizes
    assert all(g.step == batch.step for g in groups)
    flat = [s for g in groups for s in g.generator.sources]
    assert flat == batch.generator.sources
    back = gather_batch(groups)
    for k in ARRAY_FIELDS:
        assert torch.equal(getattr(back, k), getattr(batch, k)), k
    assert back.generator.sources == batch.generator.sources


def test_shard_batch_refuses_a_generator_off_its_place():
    p = pt.SimParams(n_cells=24, n_dead=0).validate()
    batch = make_batch_state(p, [0, 1], "cpu")
    with pytest.raises(ValueError, match="generator"):
        shard_batch(batch, Mesh(["meta"]))


def test_dryrun_multichip_on_4_cpu_places(capsys):
    """The JAX dry run's eight certifications on a virtual mesh of 4 CPU
    places (1,024 bots x 10 steps each, the forced fallback, the spill
    rows, the span path)."""
    from particlerobotsimulations_torch.dryrun import dryrun_multichip

    results = dryrun_multichip(4, "cpu")
    assert len(results) == 8
    assert "fallbacks fired" in results[5] and "spill rows" in results[6]
    out = capsys.readouterr().out
    assert out.startswith("dryrun_multichip OK over 4 places on cpu")
    with pytest.raises(ValueError, match="at least 2"):
        dryrun_multichip(1, "cpu")
