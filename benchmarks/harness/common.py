"""What the runners share: the run's context, its outcome, the seeds, and
the program's configuration built from a configuration file."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class Ctx:
    """One run: its cell, configuration and traffic (parsed files), the
    limits of its comparison, the seed, the window's seconds, whether it is
    traced, the device and the process's start on ``time.perf_counter``."""

    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float


@dataclasses.dataclass
class Outcome:
    setup_s: float
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0
    summary: Optional[object] = None  # trace.Summary of a traced run
    facts: Dict = dataclasses.field(default_factory=dict)
    checks: List = dataclasses.field(default_factory=list)


def cfg_seed(seed: int) -> int:
    """The program's own seed (``SegTrainConfig.seed``), within 31 bits."""
    return seed % 2_147_483_629


def seg_config(conf: dict, seed: int):
    """``SegTrainConfig`` of a configuration file's ``program`` section."""
    from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig

    prog = dict(conf["program"])
    data = dict(prog.pop("data"))
    model = conf["model"]
    data.update(input_shape=tuple(model["input_shape"]),
                num_classes=model["num_classes"])
    prog["cls_weights"] = tuple(prog["cls_weights"])
    return SegTrainConfig(data=SegDataConfig(**data),
                          backbone=model["backbone"],
                          downsample_factor=model["downsample_factor"],
                          seed=seed, **prog)
