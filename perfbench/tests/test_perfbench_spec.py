"""BENCHMARK.json and the files it names: every name resolves to its file,
and the file keeps to the benchmark's format."""

import json

import pytest

from perfbench import check
from perfbench.spec import NAME, ROOT, UNIT, Bench

BENCH = Bench()
DATA = BENCH.data
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_top_level_keys_and_size():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= DATA["run_seconds"] <= 51 and isinstance(DATA["run_seconds"], int)
    assert DATA["paths"] == ["perfbench"]
    assert all(isinstance(w, str) and not w.startswith("/") and ".." not in w
               for w in DATA["command"])


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_only_their_keys(section):
    for entry in DATA[section]:
        assert set(entry) <= KEYS[section], entry["name"]
        assert set(entry) >= KEYS[section] - {"workloads"}, entry["name"]


def test_names_and_units():
    names = []
    for section in KEYS:
        for entry in DATA[section]:
            names.append(entry["name"])
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
    for w in DATA["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in DATA["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", [w["name"] for w in DATA["workloads"]])
def test_cell_files_resolve(cell):
    w = BENCH.cell(cell)
    assert w["chips"] == 1
    assert BENCH.config_path(w["config"]).is_file()
    assert BENCH.traffic_path(w["traffic"]).is_file()
    limits = BENCH.limits(cell)
    assert limits and set(limits) <= set(check.NUMBERS + (check.REPLAY,))
    # the span path's eager segment and its replay run the same kernels
    # on the same inputs: an exact comparison
    assert limits.get(check.REPLAY, 0.0) == 0.0
    config = BENCH.config(w["config"])
    if config.get("cfg"):
        assert (BENCH.config_path(w["config"]).parent / config["cfg"]).is_file()
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = {m["name"] for m in BENCH.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert BENCH.per_layer(cell)


@pytest.mark.parametrize("metric", [m["name"] for m in DATA["per_layer"]])
def test_metric_readers_resolve(metric):
    assert callable(BENCH.reader(metric))
    m = next(x for x in DATA["per_layer"] if x["name"] == metric)
    e2e = {x["name"] for x in DATA["end_to_end"]}
    assert m["moves"] in e2e
    for cell in m["workloads"]:
        assert m["moves"] in {x["name"] for x in BENCH.end_to_end(cell)}


def test_configs_used_and_files_distinct():
    used = {w["config"] for w in DATA["workloads"]}
    assert used == {c["name"] for c in DATA["configs"]}
    files = [c["file"] for c in DATA["configs"]]
    assert len(files) == len(set(files)) and all(f.startswith("perfbench/") for f in files)
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds():
    for m in DATA["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in DATA["end_to_end"])


def test_frozen_cfg_is_the_shipped_one():
    frozen = ROOT / "perfbench" / "configs" / "example_obstacle.cfg"
    assert frozen.read_bytes() == (ROOT / "examples" / "example_obstacle.cfg").read_bytes()
    assert json.loads((ROOT / "perfbench" / "configs" / "obstacle500.json").read_text())["cfg"] \
        == frozen.name
