"""What one cell is, read from the files that name it.

``BENCHMARK.json`` at the root lists the cells (``workloads``), the
configurations and the metrics. Everything that belongs to one name sits in
a file of its own under ``plonkbench/``, found by that name:

- ``configs/<config>.json``: the circuit, the SRS, the port's switches;
- ``traffic/<mix>.json``: a traffic mix, the parameters that its
  ``generator`` reads; ``traffic/<generator>.py``: the generator;
- ``circuits/<family>.py``: the input generator of a circuit family;
- ``end_to_end/<metric>.py`` and ``layers/<metric>.py``: the reader of one
  metric, ``read(run) -> float | None``.

So a later change adds a configuration, a mix, a cell or a metric as new
files and entries, and edits no file that is here.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys

def load_module(path: str, name: str):
    """The Python file ``path`` as a module of its own, loaded once."""
    mod = sys.modules.get(name)
    if mod is not None and getattr(mod, "__file__", None) == path:
        return mod
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads`` with its configuration, its mix and the
    metrics it reports, all read from the tree at ``root``."""

    def __init__(self, root: str, name: str):
        self.root = root
        self.dir = os.path.join(root, "plonkbench")
        bench = _read_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _read_json(os.path.join(root, configs[self.entry["config"]]["file"]))
        self.mix = _read_json(self.path("traffic", self.entry["traffic"] + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]

    def path(self, *parts: str) -> str:
        return os.path.join(self.dir, *parts)

    def module(self, folder: str, name: str):
        return load_module(self.path(folder, name + ".py"), f"plonkbench_{folder}_{name}".replace("-", "_"))

    def generator(self):
        return self.module("traffic", self.mix["generator"])

    def circuit(self):
        return self.module("circuits", self.config["circuit"]["family"])

    def readers(self, trace: bool) -> list[tuple[dict, object]]:
        """(metric entry, reader module) of what this run reports: the
        end-to-end metrics untraced, the per-layer metrics traced."""
        if trace:
            return [(m, self.module("layers", m["name"])) for m in self.per_layer]
        return [(m, self.module("end_to_end", m["name"])) for m in self.end_to_end]
