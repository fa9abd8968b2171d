"""Finds what belongs to a cell by the names in ``BENCHMARK.json``.

- a configuration: the ``file`` its entry names;
- a traffic mix: ``traffic/<traffic>.json`` beside this package;
- a metric: ``metrics/<name>.py``, a module whose ``read(run)`` returns
  the metric's value, or None where the run holds nothing to read.

A cell reports, with ``--trace 0``, every end-to-end metric whose
``workloads`` list is absent or names it; with ``--trace 1``, every
per-layer metric whose ``workloads`` names it, or that has no
``workloads`` and moves an end-to-end metric the cell reports.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def bench(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(b: dict, name: str) -> dict:
    for w in b["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError("no workload %r in BENCHMARK.json" % name)


def config(b: dict, name: str, root: str = ROOT) -> dict:
    for c in b["configs"]:
        if c["name"] == name:
            return _json(os.path.join(root, c["file"]))
    raise KeyError("no configuration %r in BENCHMARK.json" % name)


def traffic(name: str, here: str = HERE) -> dict:
    return _json(os.path.join(here, "traffic", name + ".json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metrics_for(b: dict, cell: str, trace: bool) -> list[dict]:
    e2e = [m for m in b["end_to_end"] if _applies(m, cell)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in b["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in moved)]


def reader(name: str, here: str = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(here, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
