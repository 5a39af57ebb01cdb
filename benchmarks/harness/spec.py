"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``benchmarks/configs/<config>.json``), its traffic mix
(``benchmarks/traffic/<traffic>.json``), the limits of its comparison
(``benchmarks/limits/<cell>.json``) and each per-layer metric's reader
(``benchmarks/metrics/<metric>.py``).  Adding a cell, a mix, a
configuration or a metric adds files and entries; no code changes."""

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


def config(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return _json(ROOT, c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(BENCH_DIR, "traffic", f"{name}.json")


def limits(cell_name: str) -> dict:
    return _json(BENCH_DIR, "limits", f"{cell_name}.json")


def applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(spec: dict, cell_name: str) -> List[dict]:
    return [m for m in spec["end_to_end"] if applies(m, cell_name)]


def per_layer(spec: dict, cell_name: str) -> List[dict]:
    return [m for m in spec["per_layer"] if applies(m, cell_name)]


def reader(metric_name: str):
    """``read(summary, facts) -> float or None`` of ``metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric_name}.py")
    mod_name = "bench_metric_" + metric_name.replace(".", "_").replace("-", "_")
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def runner(name: str):
    """The module ``benchmarks.harness.<name>`` that runs a traffic mix."""
    return importlib.import_module(f"benchmarks.harness.{name}")


def all_files(spec: dict) -> Dict[str, str]:
    """Every file the spec names by convention, for the tests."""
    out = {}
    for c in spec["configs"]:
        out[f"config {c['name']}"] = os.path.join(ROOT, c["file"])
    for w in spec["workloads"]:
        out[f"traffic {w['traffic']}"] = os.path.join(
            BENCH_DIR, "traffic", f"{w['traffic']}.json")
        out[f"limits {w['name']}"] = os.path.join(
            BENCH_DIR, "limits", f"{w['name']}.json")
    for m in spec["per_layer"]:
        out[f"metric {m['name']}"] = os.path.join(
            BENCH_DIR, "metrics", f"{m['name']}.py")
    return out
