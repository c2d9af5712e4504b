"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is the file its entry names; a traffic mix is
``traffic/<mix>.json``; a per-layer metric's reader is
``metrics/<metric>.py`` (a function ``read(ctx)``); a cell's limits on
the numbers that decide ``correct`` are ``limits/<cell>.json``.  A later
cell, configuration or metric comes with files of its own, and nothing
here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Bench:
    def __init__(self, path: Path = ROOT / "BENCHMARK.json"):
        self.root = Path(path).resolve().parent
        self.data = json.loads(Path(path).read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def config_path(self, name: str) -> Path:
        return self.root / self.config_entry(name)["file"]

    def config(self, name: str) -> dict:
        return json.loads(self.config_path(name).read_text())

    def traffic_path(self, name: str) -> Path:
        return HERE / "traffic" / f"{name}.json"

    def traffic(self, name: str) -> dict:
        return json.loads(self.traffic_path(name).read_text())

    def limits_path(self, cell: str) -> Path:
        return HERE / "limits" / f"{cell}.json"

    def limits(self, cell: str) -> dict:
        return json.loads(self.limits_path(cell).read_text())["limits"]

    def reader_path(self, metric: str) -> Path:
        return HERE / "metrics" / f"{metric}.py"

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``metrics/<metric>.py``."""
        path = self.reader_path(metric)
        spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.data["per_layer"] if cell in m.get("workloads", [cell])]
