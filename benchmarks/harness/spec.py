"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``benchmarks/configs/<config>.json``), its traffic mix
(``benchmarks/traffic/<traffic>.json``), the limits of its comparison
(``benchmarks/limits/<cell>.json``), the runner a traffic mix names
(``benchmarks/harness/<runner>.py``) and each per-layer metric's reader
(``benchmarks/metrics/<metric>.py``).  Adding a cell, a mix, a
configuration, a runner or a metric adds files and entries; no code
changes.  Each function takes the checkout's ``root``, the real one by
default, so that the contract's tests can read a made-up benchmark."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load(root: str = ROOT) -> dict:
    return _json(root, "BENCHMARK.json")


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                   f"{', '.join(w['name'] for w in spec['workloads'])})")


def config(spec: dict, name: str, root: str = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return _json(root, c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, root: str = ROOT) -> dict:
    return _json(root, "benchmarks", "traffic", f"{name}.json")


def limits(cell_name: str, root: str = ROOT) -> dict:
    return _json(root, "benchmarks", "limits", f"{cell_name}.json")


def applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(spec: dict, cell_name: str) -> List[dict]:
    return [m for m in spec["end_to_end"] if applies(m, cell_name)]


def per_layer(spec: dict, cell_name: str) -> List[dict]:
    return [m for m in spec["per_layer"] if applies(m, cell_name)]


def _module(path: str, prefix: str, name: str):
    """The module of the file ``path``, loaded apart from ``sys.modules``."""
    mod_name = prefix + name.replace(".", "_").replace("-", "_")
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def reader(metric_name: str, root: str = ROOT):
    """``read(summary, facts) -> float or None`` of ``metrics/<name>.py``."""
    return _module(os.path.join(root, "benchmarks", "metrics",
                                f"{metric_name}.py"),
                   "bench_metric_", metric_name).read


def runner(name: str, root: str = ROOT):
    """The module ``benchmarks.harness.<name>`` that runs a traffic mix:
    its ``run(ctx)``, ``program_config(conf, seed)`` and
    ``control_readings(ctx)``.  Under another root, its file there."""
    if os.path.realpath(root) == os.path.realpath(ROOT):
        return importlib.import_module(f"benchmarks.harness.{name}")
    return _module(os.path.join(root, "benchmarks", "harness", f"{name}.py"),
                   "bench_runner_", name)


def all_files(spec: dict, root: str = ROOT) -> Dict[str, str]:
    """Every file the spec names by convention, for the tests."""
    bench = os.path.join(root, "benchmarks")
    out = {}
    for c in spec["configs"]:
        out[f"config {c['name']}"] = os.path.join(root, c["file"])
    for w in spec["workloads"]:
        out[f"traffic {w['traffic']}"] = os.path.join(
            bench, "traffic", f"{w['traffic']}.json")
        out[f"limits {w['name']}"] = os.path.join(
            bench, "limits", f"{w['name']}.json")
    for m in spec["per_layer"]:
        out[f"metric {m['name']}"] = os.path.join(
            bench, "metrics", f"{m['name']}.py")
    return out
