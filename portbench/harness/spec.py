"""The benchmark's parts, found by name.

``BENCHMARK.json`` (at the root of the checkout) names the cells, their
configurations and the metrics. A configuration is ``configs/<config>.json``
(its file as ``BENCHMARK.json`` gives it), a traffic mix
``mixes/<traffic>.json``, a cell's own parameters (its fixed rate, its
limits) ``cells/<cell>.json`` and a per-layer metric the reader
``metrics/<metric>.py``, whose ``read(trace)`` returns the value or None; a
metric ``<kind>.<qualifier>`` without a file of its own is read by
``metrics/<kind>.py``.
Adding a cell, a configuration, a mix or a metric adds files and entries;
no file here changes.
"""

import importlib.util
import json
from pathlib import Path

HOME = Path(__file__).resolve().parents[1]  # the benchmark's folder
ROOT = HOME.parent  # the checkout: BENCHMARK.json and the program


def _json(path):
    return json.loads(Path(path).read_text())


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, bench, name):
        spec = bench.spec
        work = [w for w in spec["workloads"] if w["name"] == name]
        if not work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = work[0]
        entry = [c for c in spec["configs"]
                 if c["name"] == self.workload["config"]][0]
        self.config = _json(bench.root / entry["file"])
        mix = _json(bench.home / "mixes" / f"{self.workload['traffic']}.json")
        own = _json(bench.home / "cells" / f"{name}.json")
        self.params = {**mix, **own.get("traffic", {})}
        self.limits = own["limits"]
        self.own = own
        self.end_to_end = [m for m in spec["end_to_end"] if _applies(m, name)]
        self.per_layer = [m for m in spec["per_layer"] if _applies(m, name)]


class Bench:
    """``BENCHMARK.json`` under ``root`` and the benchmark's files under
    ``home`` (both default to this checkout's)."""

    def __init__(self, root=ROOT, home=HOME):
        self.root = Path(root)
        self.home = Path(home)
        self.spec = _json(self.root / "BENCHMARK.json")

    def cell(self, name):
        return Cell(self, name)

    def reader(self, metric):
        """``read`` of ``metrics/<metric>.py``, else of
        ``metrics/<kind>.py`` for a metric named ``<kind>.<qualifier>``."""
        path = self.home / "metrics" / f"{metric}.py"
        if not path.exists():
            path = self.home / "metrics" / f"{metric.split('.')[0]}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
