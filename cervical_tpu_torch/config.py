"""Typed configuration — the port's own copy of the fields its slices read.

Mirrors ``cervical_tpu/config.py`` (``SegDataConfig``, ``SegTrainConfig``,
``load_config``, ``parse_cli_overrides``) with the same names, defaults and
override syntax (``--a.b.c value``).  The predictor's fields and those the
segmentation train and eval steps read are here.  Fields that only tune how
JAX dispatches work to the TPU are accepted, so configs written for the JAX
package load unchanged, and have no effect in the port (each says so).
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
    """VOC-layout dataset config (train.py:131-137,396-399)."""

    dataset_path: str = "VOCdevkit"
    input_shape: Tuple[int, int] = (512, 512)
    num_classes: int = 5
    # augmentation knobs (dataloader.py:55)
    jitter: float = 0.3
    hue: float = 0.1
    sat: float = 0.7
    val: float = 0.3
    scale_min: float = 0.25
    scale_max: float = 2.0
    # 2-shear rotation approximation of the einsum backend; the kernel
    # backend is always the exact Paeth 3-shear.  The einsum backend is not
    # ported yet, so this has no effect in the port.
    two_shear: bool = False
    # the train step's augmentation backend: "pallas" runs the K1-K3
    # kernels (``ops/warp.augment_batch_kernels``; the name is the JAX
    # package's); "einsum" (the JAX default) is not ported yet and the
    # trainer raises NotImplementedError for it.
    aug_backend: str = "einsum"
    # JAX scanned-step dispatch knob; no effect in the port (no scan).
    aug_pre_batch: bool = False


@dataclass
class SegTrainConfig:
    """Segmentation trainer config (reference literals: train.py:50-281)."""

    data: SegDataConfig = field(default_factory=SegDataConfig)
    backbone: str = "xception"  # train.py:94
    pretrained: str = ""  # converted backbone weights ('' = random init)
    downsample_factor: int = 16  # train.py:129
    init_epoch: int = 0
    freeze_epoch: int = 20  # train.py:176-187
    unfreeze_epoch: int = 200
    freeze_batch_size: int = 16
    unfreeze_batch_size: int = 8
    freeze_train: bool = False  # train.py:192 (reference default False)
    init_lr: float = 1e-4  # train.py:205-229 (adam)
    min_lr_ratio: float = 0.01
    optimizer_type: str = "adam"
    momentum: float = 0.9
    weight_decay: float = 0.0  # reference: 0 for adam
    lr_decay_type: str = "cos"
    focal_loss: bool = True  # train.py:259-265
    dice_loss: bool = True
    cls_weights: Tuple[float, ...] = (1.0, 1.0, 5.0, 3.0, 4.0)  # train.py:274
    # SegTrainer.fit: a periodic checkpoint every save_period epochs (and at
    # the last), plus best/last, and the callbacks' logs, under save_dir;
    # the eval step's mIoU every eval_period epochs, and with predictor_eval
    # the predictor's mIoU at the original resolution too
    save_period: int = 10
    save_dir: str = "logs"
    eval_period: int = 10
    predictor_eval: bool = False
    seed: int = 11  # train.py:283; seeds init, aug params and dropout
    # from-scratch init: "normal" replicates the reference's weights_init
    # (every conv N(0,.02), BN scale N(1,.02)); "none" keeps torch defaults
    weights_init: str = "normal"
    # bf16 compute with fp32 params and BatchNorm (the reference's AMP path)
    dtype: str = "bfloat16"
    # JAX conv-lowering knob for the head; no effect in the port (cuDNN)
    head_conv_backend: str = ""
    # run the eval step's forward with the fused middle-flow kernels (K4,
    # ``ops/middle_flow.py``; xception only); the train step never does
    fused_middle_eval: bool = False
    # JAX device-mesh size; the port runs on one card
    num_devices: Optional[int] = None
    eval_batch_size: int = 8
    # steps dispatched ahead of the host reading their metrics: the epoch
    # loop keeps this many unsynced steps in flight
    pipeline_depth: int = 8
    # JAX scan length; no effect in the port (one step per call; fit feeds
    # a BatchLoader)
    steps_per_call: int = 8
    # JAX dropout PRNG implementation; no effect in the port (the model's
    # dropouts draw from its own torch.Generator)
    dropout_rng_impl: str = "rbg"
    # JAX rematerialization knob; no effect in the port
    remat_entry: bool = False
    # JAX device-resident epoch; not ported yet, no effect in the port (fit
    # feeds a BatchLoader)
    device_resident: bool = False
    # JAX resident-epoch shuffle mode; no effect in the port
    resident_shuffle: str = "gather"


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
