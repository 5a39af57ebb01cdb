"""A run of a cell at a size the CPU holds: the cell's own files, with the
image sizes, the set sizes and the steps of a call cut.  A made-up
benchmark: the real one copied, with a configuration of another family
added from ``madeup/``."""

from __future__ import annotations

import copy
import json
import os
import shutil
import time

import torch

from benchmarks.harness import spec as S
from benchmarks.harness.common import Ctx

TINY_TRAIN = {"input_shape": [64, 64], "train_images": 32, "val_images": 16,
              "steps_per_call": 2}
TINY_SERVE = {"input_shape": [64, 64], "image_hw": [96, 128],
              "pool_images": 32, "check_requests": 3, "traced_requests": 2}


def tiny_ctx(cell_name: str, seed: int = 5, seconds: float = 0.0,
             limits=None) -> Ctx:
    spec = S.load()
    cell = S.cell(spec, cell_name)
    conf = copy.deepcopy(S.config(spec, cell["config"]))
    traffic = copy.deepcopy(S.traffic(cell["traffic"]))
    tiny = TINY_TRAIN if traffic["runner"] == "train_epochs" else TINY_SERVE
    conf["model"]["input_shape"] = tiny["input_shape"]
    for k in ("train_images", "val_images"):
        if k in tiny:
            conf[k] = tiny[k]
    if "steps_per_call" in tiny:
        conf["program"]["steps_per_call"] = tiny["steps_per_call"]
    for k in ("image_hw", "pool_images", "check_requests", "traced_requests"):
        if k in tiny:
            traffic[k] = tiny[k]
    return Ctx(cell=cell, config=conf, traffic=traffic,
               limits=S.limits(cell_name) if limits is None else limits,
               seed=seed, seconds=seconds, trace=False,
               device=torch.device("cpu"), t0=time.perf_counter())


MADEUP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "madeup")


def make_madeup(tmp: str) -> str:
    """A checkout at ``tmp``: ``BENCHMARK.json`` and ``benchmarks/`` copied,
    the files under ``madeup/`` laid over ``benchmarks/``, and the entries
    of ``madeup/entries.json`` appended to the spec.  Returns its root."""
    bench = os.path.join(tmp, "benchmarks")
    shutil.copytree(os.path.join(S.ROOT, "benchmarks"), bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for sub in sorted(os.listdir(MADEUP)):
        if os.path.isdir(os.path.join(MADEUP, sub)):
            shutil.copytree(os.path.join(MADEUP, sub),
                            os.path.join(bench, sub), dirs_exist_ok=True)
    spec = S.load()
    with open(os.path.join(MADEUP, "entries.json")) as f:
        add = json.load(f)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        spec[group] += add.get(group, [])
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.get("workloads", []).extend(
            add["append_to_workloads"].get(m["name"], []))
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=2)
    return tmp
