"""Typed configuration — the port's own copy of the fields its slices read.

Mirrors ``cervical_tpu/config.py`` (``SegDataConfig``, ``SegTrainConfig``,
``load_config``, ``parse_cli_overrides``) with the same names, defaults and
override syntax (``--a.b.c value``).  Only the fields the predictor reads
are here; the trainer's fields arrive with the training slice.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

try:
    import yaml
except ImportError:  # pragma: no cover
    yaml = None


@dataclass
class SegDataConfig:
    """Input geometry and classes (train.py:131-137,396-399)."""

    input_shape: Tuple[int, int] = (512, 512)
    num_classes: int = 5


@dataclass
class SegTrainConfig:
    """Segmentation config: the model and dtype fields the predictor reads."""

    data: SegDataConfig = field(default_factory=SegDataConfig)
    backbone: str = "xception"  # train.py:94
    downsample_factor: int = 16  # train.py:129
    seed: int = 11  # train.py:283; seeds the random init when no weights
    # bf16 compute with fp32 params and BatchNorm (the reference's AMP path)
    dtype: str = "bfloat16"


def _update_dataclass(obj, data: dict):
    for k, v in data.items():
        if not hasattr(obj, k):
            raise KeyError(f"unknown config key: {k!r} for {type(obj).__name__}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _update_dataclass(cur, v)
        else:
            if isinstance(cur, tuple) and isinstance(v, (list, tuple)):
                v = tuple(v)
            setattr(obj, k, v)
    return obj


def load_config(cls, path: Optional[str] = None, overrides: Optional[dict] = None):
    """Build ``cls()`` then apply a YAML/JSON file and/or override dict."""
    cfg = cls()
    if path:
        with open(path) as f:
            if path.endswith(".json"):
                data = json.load(f)
            else:
                if yaml is None:
                    raise RuntimeError("pyyaml unavailable; use JSON config")
                data = yaml.safe_load(f)
        _update_dataclass(cfg, data or {})
    if overrides:
        _update_dataclass(cfg, overrides)
    return cfg


def parse_cli_overrides(argv):
    """``--a.b.c value`` pairs -> nested override dict (values JSON-parsed)."""
    out = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"expected --key, got {arg!r}")
        key = arg[2:]
        if "=" in key:
            key, raw = key.split("=", 1)
            i += 1
        else:
            raw = argv[i + 1]
            i += 2
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out
