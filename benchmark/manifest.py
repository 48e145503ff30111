"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` at the root of the checkout lists the cells. Everything
of one configuration, traffic mix or per-layer metric lives in files of
its own under ``benchmark/``, found by name, so a cell, a configuration
or a metric is added by adding files and manifest entries:

* ``configs/<config>.json``: the configuration's sizes, source, precision
  and ``reduced``; ``configs/<config>.py``: how the cell is set up through
  the program and what one step computes (FLOPs, products);
  ``configs/<config>.reference.py``: its plain reference;
* ``traffic/<traffic>.json``: the traffic mix's parameters;
* ``limits/<cell>.json``: the correctness limits of a cell, with the
  readings each was set from;
* ``metrics/<metric>.py``: the reader of one per-layer metric;
* ``peaks.json``: the published peaks of the cards.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import the Python file ``path`` under a name of its own."""
    path = Path(path).resolve()
    name = "benchmark._files." + re.sub(r"\W", "_", str(path))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of the manifest's ``workloads`` with what it names."""

    def __init__(self, name: str, manifest: dict | None = None,
                 here: Path = HERE):
        manifest = manifest or read_json(here.parent / "BENCHMARK.json")
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.here = here
        self.entry = cells[name]
        self.name = name
        self.config_name = self.entry["config"]
        entry = {c["name"]: c for c in manifest["configs"]}[self.config_name]
        self.config = read_json(here.parent / entry["file"])
        self.traffic = read_json(here / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]
        limits = here / "limits" / f"{name}.json"
        self.limits = read_json(limits) if limits.exists() else {}
        self.peaks = read_json(here / "peaks.json")

    def module(self):
        return load_module(self.here / "configs" / f"{self.config_name}.py")

    def metric(self, name: str):
        return load_module(self.here / "metrics" / f"{name}.py")
