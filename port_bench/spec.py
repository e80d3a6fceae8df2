"""Find what a cell needs by the names in ``BENCHMARK.json``.

Every configuration, traffic mix, entry, input generator, metric reader,
roofline count and set of limits is a file of its own under this folder:

- ``configs/<config>.json``: the configuration's parameters;
- ``traffic/<traffic>.json``: the traffic mix (its ``entry`` and ``input``);
- ``entries/<entry>.py``: how a call drives the program and how the
  reference judges what it returned;
- ``gen/<input>.py``: the seeded input generator;
- ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``;
- ``limits/<workload>.json``: the limit of each number that ``correct``
  compares in that cell.

Adding a cell, a mix or a metric adds files; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_module(folder, name):
    """Import ``<folder>/<name>.py`` under this package (names may hold dots)."""
    path = os.path.join(HERE, folder, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {folder} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"port_bench.{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name, bench=None, overrides=None):
        bench = bench or benchmark()
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"unknown workload {name!r}; have {sorted(by_name)}")
        self.name = name
        self.workload = by_name[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        with open(os.path.join(ROOT, self.config_entry["file"])) as f:
            self.config = json.load(f)
        self.traffic = load_json("traffic", f"{self.workload['traffic']}.json")
        for group, keys in (overrides or {}).items():
            (self.traffic if group == "traffic" else self.config[group]).update(keys)
        self.limits = load_json("limits", f"{name}.json")
        self.chips = int(self.workload["chips"])
        # A metric with a ``workloads`` key is reported in those cells alone;
        # one without it in every cell.
        self.end_to_end, self.per_layer = (
            [m for m in bench[kind] if name in m.get("workloads", [name])]
            for kind in ("end_to_end", "per_layer")
        )

    def entry(self):
        return load_module("entries", self.traffic["entry"])

    def generator(self):
        return load_module("gen", self.traffic["input"])
