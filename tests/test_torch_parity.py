"""PyTorch port, the measurement and paper-parity scripts against the JAX
package's (``scripts/*_torch.py`` against ``scripts/parity_report.py`` and
``scripts/fullscale.py``).

The anchors, the per-seed speed and the markdown table are copies: on the
JAX package's TPU record (``docs/parity/parity.json``) they must give
exactly the JAX script's values and text.  A parity scenario and the
fullscale per-scene function run shrunk (24-32 bots, 20-30 steps) in both
packages on the CPU, the port on the JAX package's draws, within the sweep
tests' tolerances (``tests/test_torch_sweep.py``: 1e-4 on the experiments'
outputs; ``tests/test_torch_rng.py``: positions 1e-5, velocities 1e-4,
radii 1e-6).  The scripts themselves import with JAX blocked.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particlerobotsimulations_torch as pt
import particlerobotsimulations_tpu as pj
from particlerobotsimulations_torch.io.csvio import load_last_row
from particlerobotsimulations_torch.state import state_from_arrays
from particlerobotsimulations_tpu.models import experiments as je

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY_JSON = os.path.join(ROOT, "docs", "parity", "parity.json")
NEW_SCRIPTS = ("batchbench_torch", "fullscale_torch", "parity_report_torch",
               "sweepbench_torch")
STATE_KEYS = (
    "pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r",
    "centroid_ring", "step",
)
EXPERIMENT_ATOL = 1e-4
CSV_TOL = {"pos": 1e-5, "vel": 1e-4, "rad": 1e-6}


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jr = load_script("parity_report")
tr = load_script("parity_report_torch")
fs = load_script("fullscale_torch")


class JaxDraws:
    """The JAX package's draws for ``seed``, as a step-keyed provider."""

    def __init__(self, seed: int):
        self.key = jax.random.key(seed)

    def uniform(self, step, shape, device):
        k = jax.random.fold_in(self.key, step)
        return torch.tensor(np.asarray(jax.random.uniform(k, shape)), device=device)

    def normal(self, step, shape, device):
        k = jax.random.fold_in(jax.random.fold_in(self.key, step), 1)
        return torch.tensor(
            np.asarray(jax.random.normal(k, shape, jnp.float32)), device=device
        )


def to_port(jp):
    return pt.SimParams(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})


def cfg_pair(name, **kw):
    jp = pj.load_cfg(os.path.join(ROOT, "examples", name)).replace(**kw)
    return jp, to_port(jp)


def test_anchors_table_and_speed_equal_jax(tmp_path):
    """The copies on the JAX package's record: anchors and table exactly
    the JAX script's; ``--from-json`` reproduces the record's verdicts."""
    with open(PARITY_JSON) as f:
        record = json.load(f)
    results = {k: v for k, v in record.items() if k != "anchors"}
    want = jr._anchors(results, pj.load_cfg(os.path.join(ROOT, "examples", "example.cfg")))
    got = tr._anchors(results, pt.load_cfg(os.path.join(ROOT, "examples", "example.cfg")))
    assert got == want == record["anchors"]

    for mod, out in ((jr, tmp_path / "jax"), (tr, tmp_path / "port")):
        out.mkdir()
        mod._markdown(dict(results, anchors=want), str(out))
    table = (tmp_path / "port" / "table.md").read_text()
    assert table == (tmp_path / "jax" / "table.md").read_text()

    rng = np.random.default_rng(3)
    r = {"centroids": rng.standard_normal((6, 4, 2)), "time_s": np.arange(6) * 60.0}
    p = pt.load_cfg(os.path.join(ROOT, "examples", "example.cfg"))
    np.testing.assert_array_equal(tr._per_seed_speed(r, p), jr._per_seed_speed(r, p))

    out = tmp_path / "from_json"
    assert tr.main(["--from-json", PARITY_JSON, "--out", str(out)]) == 0
    redo = json.loads((out / "parity.json").read_text())
    assert {k: a["verdict"] for k, a in redo["anchors"].items()} == {
        k: a["verdict"] for k, a in record["anchors"].items()
    }
    assert (out / "table.md").read_text() == table
    rows = (out / "robustness.csv").read_text().strip().splitlines()
    assert rows[0] == "dead_fraction,normalized_speed,approach_speed"
    np.testing.assert_allclose(
        [float(x.split(",")[1]) for x in rows[1:]],
        record["robustness"]["normalized_speed"], atol=1e-6, rtol=0,
    )


@pytest.mark.parametrize("scenario", ["phototaxis", "transport"])
def test_scenario_matches_jax(scenario):
    """One parity scenario shrunk to 24-31 bots and 20 steps (two seeds),
    in the port on JAX's draws and in the JAX package, summarized as the
    JAX script summarizes it.  The scenes take the GRID layout, jittered
    by construction: the cfgs' RANDOM accretion places pairs exactly
    tangent (22 at 24 bots), where one ulp flips a magnet branch and parts
    the packages by ~1e-4 within 10 steps (a ROADMAP trap)."""
    seeds, secs = [0, 1], 0.2
    if scenario == "phototaxis":
        jp, tp = cfg_pair("example.cfg", n_cells=24, dump_interval=0.1, config=pj.Config.GRID)
        r = je.phototaxis_speed(jp, seeds, sim_seconds=secs)
        per_seed = jr._per_seed_speed(r, jp)
        want = {
            "approach_speed_mean": np.mean(per_seed), "per_seed_speed": per_seed,
            "distance_start": r["distance_mean"][0], "distance_end": r["distance_mean"][-1],
        }
        got = tr.phototaxis(seeds, secs, "cpu", params=tp, draws=JaxDraws)
    else:
        jp, tp = cfg_pair("example_object_transport.cfg", n_cells=31, dump_interval=0.1,
                          config=pj.Config.GRID)
        r = je.payload_transport(jp, seeds, sim_seconds=secs)
        dx = r["payload_displacement"][:, 0]
        want = {"payload_dx_mean": dx.mean(), "payload_dx_std": dx.std(),
                "payload_dx_per_seed": dx,
                "moved_toward_light_frac": (dx < 0).mean()}
        got = tr.transport(seeds, secs, "cpu", params=tp, draws=JaxDraws)
    assert got["n_cells"] == jp.n_cells and got["sim_seconds"] == secs
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v),
                                   atol=EXPERIMENT_ATOL, rtol=0, err_msg=k)


def test_fullscale_scene_matches_jax(tmp_path):
    """The fullscale per-scene function on a shrunk example_dead_cells.cfg
    (32 bots, 6 killed at step 5, 30 steps) from the JAX package's initial
    state on its draws, against JAX's ``Simulation.run`` of the same
    scene: the record's distances and the last CSV rows."""
    jp, tp = cfg_pair("example_dead_cells.cfg", n_cells=32, n_dead=6, time_to_dead=0.05,
                      max_time=0.3, dump_interval=0.1, testing=1)
    jsim = pj.Simulation(jp)
    arrays = {k: np.asarray(jax.device_get(getattr(jsim.state, k))) for k in STATE_KEYS}
    light = np.array([jp.light_x, jp.light_y])
    d0 = float(np.linalg.norm(np.asarray(jsim.centroid()) - light))
    jax_csv, port_csv = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    jsim.run(csv_path=jax_csv, echo=False)
    d1 = float(np.linalg.norm(np.asarray(jsim.centroid()) - light))
    assert int(np.asarray(jsim.state.dead)[:32].sum()) == 6

    state = state_from_arrays(tp, arrays, "cpu", draws=JaxDraws(jp.seed))
    rec = fs.run_scene(tp, "cpu", csv_path=port_csv, state=state)
    assert {k: rec[k] for k in ("bots", "sim_seconds", "steps", "backend", "card")} == {
        "bots": 32, "sim_seconds": 0.3, "steps": 30, "backend": "DENSE", "card": "cpu",
    }
    # the record rounds to 3 decimals, as the JAX script's: two distances
    # within 1e-5 round at most one unit of the last place apart
    assert abs(rec["dist_to_light_start"] - round(d0, 3)) <= 1e-3 + 1e-9
    assert abs(rec["dist_to_light_end"] - round(d1, 3)) <= 1e-3 + 1e-9
    got, want = load_last_row(tp, port_csv), load_last_row(tp, jax_csv)
    assert got[0] == want[0] == pytest.approx(0.3)
    for (name, tol), g, w in zip(CSV_TOL.items(), got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)


def test_fullscale_records_a_refused_scene(tmp_path):
    """A cfg that ``Simulation`` refuses gets its error in its record; the
    other scenes run (the JAX script's behaviour: cfgs unmodified)."""
    bad = tmp_path / "outside_box.cfg"
    bad.write_text("nCells\n40\nnDead\n0\nmax_time\n0.02\nworld_half\n0.1\n")
    good = tmp_path / "tiny.cfg"
    good.write_text("nCells\n16\nnDead\n0\nmax_time\n0.02\n")
    results = fs.run_all([bad, good], "cpu", csv_dir=tmp_path)
    assert "error" in results["outside_box"] and "error" not in results["tiny"]
    assert results["tiny"]["steps"] == 2


def test_new_scripts_import_without_jax():
    """Every new script imports with JAX blocked and pulls in nothing of
    JAX or the JAX package."""
    code = (
        "import importlib.util, sys\n"
        "sys.modules['jax'] = None\n"
        f"for name in {NEW_SCRIPTS!r}:\n"
        "    spec = importlib.util.spec_from_file_location(name, f'scripts/{name}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', "
        "'particlerobotsimulations_tpu')) and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
