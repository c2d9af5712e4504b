"""PyTorch port, host layer: config, placement, state bridge, import hygiene.

The port (particlerobotsimulations_torch) must parse every cfg to the same
parameters, place every swarm identically, and carry arrays across the two
packages unchanged.  It never imports JAX.
"""

import dataclasses
import glob
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import particlerobotsimulations_torch as pt
import particlerobotsimulations_tpu as pj
from particlerobotsimulations_torch.models import placement as pt_place
from particlerobotsimulations_torch.state import state_from_arrays, state_to_arrays
from particlerobotsimulations_tpu.models import placement as pj_place

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(glob.glob(os.path.join(ROOT, "examples", "*.cfg")))
STATE_KEYS = (
    "pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r",
    "centroid_ring", "step",
)


def jax_arrays(state) -> dict:
    return {k: np.asarray(jax.device_get(getattr(state, k))) for k in STATE_KEYS}


def to_port_params(p):
    """The same SimParams, rebuilt as the port's dataclass."""
    return pt.SimParams(**{f.name: getattr(p, f.name) for f in dataclasses.fields(p)})


def test_example_cfgs_found():
    assert len(CFGS) == 5


@pytest.mark.parametrize("cfg", CFGS, ids=os.path.basename)
def test_cfg_parses_to_equal_fields(cfg):
    a = dataclasses.asdict(pt.load_cfg(cfg))
    b = dataclasses.asdict(pj.load_cfg(cfg))
    assert a == b


@pytest.mark.parametrize("cfg", CFGS, ids=os.path.basename)
def test_initial_arrays_identical(cfg):
    pa, *arrs_t = pt_place.initial_state_arrays(pt.load_cfg(cfg))
    pb, *arrs_j = pj_place.initial_state_arrays(pj.load_cfg(cfg))
    assert dataclasses.asdict(pa) == dataclasses.asdict(pb)
    for x, y in zip(arrs_t, arrs_j):
        np.testing.assert_array_equal(x, y)


def test_initial_arrays_identical_hex_10k():
    kw = dict(n_cells=10_000, n_dead=0, seed=7, light_x=-20.0)
    pa, *arrs_t = pt_place.initial_state_arrays(
        pt.SimParams(config=pt.Config.HEX, **kw)
    )
    pb, *arrs_j = pj_place.initial_state_arrays(
        pj.SimParams(config=pj.Config.HEX, **kw)
    )
    assert dataclasses.asdict(pa) == dataclasses.asdict(pb)
    for x, y in zip(arrs_t, arrs_j):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n_dead", [0, -1])
def test_make_state_matches_jax(n_dead):
    p = pj.SimParams(n_cells=201, n_dead=n_dead, seed=4)
    params, pos, vel, rad, phase, dead = pj_place.initial_state_arrays(p)
    want = jax_arrays(pj.make_state(params, pos, vel, rad, phase, dead))
    got = state_to_arrays(
        pt.make_state(to_port_params(params), pos, vel, rad, phase, dead,
                      device="cpu")
    )
    for k in STATE_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_state_arrays_round_trip():
    p = pj.SimParams(n_cells=150, n_dead=0, seed=2, config=pj.Config.HEX)
    js = pj.Simulation(p).state
    rng = np.random.default_rng(0)
    arrays = jax_arrays(js._replace(step=np.int32(17)))
    arrays["vel"] = rng.standard_normal(arrays["vel"].shape).astype(np.float32)
    ts = state_from_arrays(to_port_params(p), arrays, device="cpu")
    assert ts.step == 17 and ts.pos.dtype == torch.float32
    assert ts.dead.dtype == torch.bool
    back = state_to_arrays(ts)
    for k in STATE_KEYS:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)


def test_resolved_backend_follows_jax_rule_per_device():
    B = pt.ForceBackend
    small, mid, big = (pt.SimParams(n_cells=n) for n in (640, 2048, 10_000))
    assert small.resolved_backend("cuda") == B.DENSE
    assert mid.resolved_backend(torch.device("cuda")) == B.PALLAS
    assert big.resolved_backend("cuda:0") == B.PALLAS
    assert mid.resolved_backend("cpu") == B.DENSE
    assert big.resolved_backend("cpu") == B.STENCIL
    forced = big.replace(force_backend=B.PALLAS)
    assert forced.resolved_backend("cpu") == B.PALLAS


def test_not_ported_paths_raise():
    """Every force backend builds (make_step, make_run_chunk), and so do the
    batched runs (item 11), a runner with the packed sweep's phase hook,
    the differentiable step (item 13) and checkpoint loading (item 12): a
    missing file is the only error left."""
    from particlerobotsimulations_torch.engine import (
        make_run_chunk,
        make_run_chunk_batched,
        make_step,
    )

    big = pt.SimParams(n_cells=4000)
    make_run_chunk(big, device="cpu")  # STENCIL on the CPU
    make_step(big, device="cuda")  # the per-bot PALLAS collide
    make_run_chunk(big.replace(force_backend=pt.ForceBackend.CELLGRID), "cpu")
    assert callable(make_step(big, device="cpu", differentiable=True))
    assert callable(make_step(big.replace(force_backend=pt.ForceBackend.PALLAS),
                              device="cpu", differentiable=True))
    assert callable(make_run_chunk_batched(big, device="cpu"))  # STENCIL, batched
    assert make_run_chunk_batched(big, device="cuda").path_info["use_mega"] is False
    from particlerobotsimulations_torch.engine_table import make_adaptive_run_chunk

    runner = make_adaptive_run_chunk(
        big, phase_fn=lambda f, val, source, step: f["phase"]
    )
    assert runner.path_info["adaptive"]
    with pytest.raises(FileNotFoundError):
        pt.Simulation.from_checkpoint("no-such-checkpoint.npz", device="cpu")


def test_port_imports_without_jax():
    """Every module of the port, found by walking the package, imports with
    JAX blocked and pulls in nothing of JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import particlerobotsimulations_torch as pt\n"
        "names = [m.name for m in pkgutil.walk_packages(pt.__path__, pt.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "want = {'cli', 'engine_table', 'kernels', 'ops.megakernel', "
        "'parallel.ring', 'parallel.spatial_table', 'io.csvio', "
        "'parallel.sweep', 'parallel.packed', 'models.experiments', "
        "'parallel.mesh', 'parallel.spatial', 'dryrun', 'bench', "
        "'utils.profiling'}\n"
        "missing = {pt.__name__ + '.' + w for w in want} - set(names)\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', "
        "'particlerobotsimulations_tpu')) and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "p = pt.SimParams(n_cells=20, n_dead=0, config=pt.Config.HEX)\n"
        "pt.Simulation(p, device='cpu').step_chunk(2)\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
