"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix, and each metric. Every piece is a file of
its own, found by that name, so a later change adds a cell, a mix, a
configuration, a system, a driver or a metric by adding files and
manifest entries, never by editing one that is here:

- a configuration: ``bench/configs/<config>.json``. Its ``reference`` key
  names its plain reference, ``bench/reference/<reference>.py``, which
  draws the weights (``draw(cfg, seed, device)``) and the inputs
  (``inputs(cfg, count, seed)``), counts a request's operations
  (``flops(cfg)``) and judges the window's answers
  (``judge(weights, cfg, inputs, answers, device)``);
- a traffic mix: ``bench/traffic/<traffic>.json``, data only. Its
  ``driver`` key names the loop that offers it,
  ``bench/drivers/<driver>.py`` (``drive(system, inputs, mix, seconds,
  seed, tracer)``), and its ``system`` key the program's entry point that
  serves it, ``bench/systems/<system>.py`` (``build(cfg, mix, weights,
  device)``);
- a metric: ``bench/metrics/<name>.py``, or, for a name with a dot such
  as ``mfu.single``, ``bench/metrics/<part before the dot>.py``; its
  ``read(run)`` returns the number, or None where it finds nothing.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


class Manifest:
    """``BENCHMARK.json``, with lookups by name."""

    def __init__(self, path=None):
        path = Path(path) if path is not None else ROOT / "BENCHMARK.json"
        self.data = json.loads(path.read_text())
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.cells = {w["name"]: w for w in self.data["workloads"]}

    def cell(self, name):
        try:
            return self.cells[name]
        except KeyError:
            raise SystemExit(f"unknown workload {name!r}; the manifest has "
                             f"{sorted(self.cells)}") from None

    def config(self, cell):
        """The configuration file of ``cell``, as a dict."""
        entry = self.configs[cell["config"]]
        return json.loads((ROOT / entry["file"]).read_text())

    def metrics(self, cell, kind):
        """The ``kind`` ("end_to_end" or "per_layer") metrics ``cell``
        reports: those without ``workloads`` and those that list it."""
        return [m for m in self.data[kind]
                if "workloads" not in m or cell["name"] in m["workloads"]]


def traffic(name):
    """The traffic mix ``name`` (``bench/traffic/<name>.json``)."""
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def load(kind, name):
    """The module ``bench/<kind>/<name>.py``, imported once."""
    module = f"bench.{kind}.{name}"
    if module not in sys.modules:
        path = BENCH / kind / f"{name}.py"
        if not path.is_file():
            raise SystemExit(f"no {kind[:-1] if kind.endswith('s') else kind}"
                             f" {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(module, path)
        sys.modules[module] = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(sys.modules[module])
        except BaseException:
            del sys.modules[module]
            raise
    return sys.modules[module]


def reference(config):
    """The plain reference module that ``config`` names."""
    return load("reference", config["reference"])


def system(mix):
    """The system module that ``mix`` names."""
    return load("systems", mix["system"])


def driver(mix):
    """The driver module that ``mix`` names."""
    return load("drivers", mix["driver"])


def metric_path(name):
    """``bench/metrics/<name>.py``, else the file of the name's first
    dotted part, which reads every metric of that family."""
    whole = BENCH / "metrics" / f"{name}.py"
    if whole.exists():
        return whole
    return BENCH / "metrics" / f"{name.split('.', 1)[0]}.py"


def metric_reader(name):
    """The ``read(run)`` function of metric ``name``."""
    return load("metrics", metric_path(name).stem).read
