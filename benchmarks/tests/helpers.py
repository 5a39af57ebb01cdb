"""A run of a cell at a size the CPU holds: the cell's own files, with the
image sizes, the set sizes and the steps of a call cut."""

from __future__ import annotations

import copy
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
