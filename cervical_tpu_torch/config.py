"""Typed configuration — the port's own copy of the fields its slices read.

Mirrors ``cervical_tpu/config.py`` (``SegDataConfig``, ``SegTrainConfig``,
``FusionTrainConfig``, ``load_config``, ``parse_cli_overrides``) with the
same names, defaults and override syntax (``--a.b.c value``).  Fields that only tune how
JAX lowers work for the TPU are accepted, so configs written for the JAX
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
    # the einsum backend's rotation: False = the exact Paeth 3-shear, True =
    # the 2-shear approximation (one shear fewer, ~1.5% shape error at 10
    # degrees).  The kernel backend is always the exact 3-shear.
    two_shear: bool = False
    # the train step's augmentation backend: "einsum" (the default,
    # ``ops/warp_xla.augment_batch_einsum``: batched products, gathers and
    # elementwise passes) or "pallas" (the K1-K3 kernels,
    # ``ops/warp.augment_batch_kernels``; the name is the JAX package's)
    aug_backend: str = "einsum"
    # K-step calls only (steps_per_call > 1): augment the K sub-batches as
    # one (K*B) batch before the K steps instead of inside each.  Requires
    # aug_backend="pallas", whose per-image rotation and blur make the
    # merged batch equal the per-step path bit for bit; every train-step
    # factory raises ValueError for the einsum backend.
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
    # the data axis's size (parallel.make_mesh): None = the process group's
    # world; set, it must equal the world (1 without a process group)
    num_devices: Optional[int] = None
    eval_batch_size: int = 8
    # steps dispatched ahead of the host reading their metrics: the epoch
    # loop keeps this many unsynced steps in flight
    pipeline_depth: int = 8
    # optimizer steps per call: run_epoch groups this many batches into one
    # K-step call (on the card a replayed CUDA graph, train/graphs.py); a
    # ragged tail of fewer batches runs as single steps.  1 = one step per
    # call, eager.
    steps_per_call: int = 8
    # JAX dropout PRNG implementation; no effect in the port (the model's
    # dropouts draw from its own torch.Generator)
    dropout_rng_impl: str = "rbg"
    # JAX rematerialization knob; no effect in the port
    remat_entry: bool = False
    # fit uploads the train and val sets to the card once
    # (data/resident.py) and the epoch's K-step calls read their batches
    # there: no per-step image upload.  Off: the host BatchLoader feeds it.
    device_resident: bool = False
    # the resident train set's per-epoch shuffle: "gather" (each step
    # gathers its rows by a host-permuted index, no data motion), "images"
    # (the set permuted on the card, a transient 2x of it), "chunks" (the
    # batch order only), "none"
    resident_shuffle: str = "gather"


@dataclass
class FusionTrainConfig:
    """Multimodal fusion trainer config (my_train(full).py:648-678 + the
    per-arity deltas table, SURVEY.md §2.1)."""

    modalities: Tuple[str, ...] = ("imgN", "imgA", "imgL", "cli")
    in_features: int = 1024
    hidden: int = 512
    num_classes: int = 4
    dropout: float = 0.3
    mix: bool = True
    epochs: int = 180
    lr: float = 1e-4
    batch_size: int = 8
    # per-arity deltas (SURVEY §2.1): 4-modal (5, .25, 5e-4, 40);
    # 3-modal (10, .11, 1e-3, 30); 2-modal (5, .25, 1e-3, 20)
    kfold: int = 5
    inner_test_size: float = 0.25
    weight_decay: float = 5e-4
    lr_step: int = 40
    lr_gamma: float = 0.8  # adjust_lr_raito
    add_mse_loss_of_mae: bool = True
    mse_loss_of_mae_factor: float = 5.0
    head_weight_all: float = 1.0
    head_weight_img: float = 0.3
    head_weight_cli: float = 0.2
    epoch0_no_step: bool = True  # my_train(full).py:350-353 warmup quirk
    # evaluate the test fold every epoch like the reference (my_train(full)
    # .py:538-539); selection stays val-based
    per_epoch_test: bool = True
    start_seed: int = 0
    repeat_num: int = 1
    save_dir: str = "logs_fusion"
    # compute dtype, "float32" or "bfloat16" (flax's rule: params, Adam and
    # the loss stay f32)
    dtype: str = "float32"

    def arity_defaults(self, explicit=()):
        """Apply the reference's per-arity hyperparameter deltas in place.

        ``explicit`` names config keys the user set via file/CLI; those are
        left untouched so e.g. ``--kfold 7`` survives on a 3-modal run.
        Deltas: Three_Modal/train(NAL).py:494,510,542 (kfold 10,
        test_size .11, wd 1e-3, lr_step 30); Two_Modal/train(NC).py:418-466
        (wd 1e-3, lr_step 20); 4-modal keeps the dataclass defaults
        (my_train(full).py:648-678).
        """
        n = len(self.modalities)
        deltas = {
            3: dict(kfold=10, inner_test_size=0.11,
                    weight_decay=1e-3, lr_step=30),
            2: dict(kfold=5, inner_test_size=0.25,
                    weight_decay=1e-3, lr_step=20),
        }.get(n)
        if deltas:
            for k, v in deltas.items():
                if k not in explicit:
                    setattr(self, k, v)
        return self


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


def load_config(cls, path: Optional[str] = None, overrides: Optional[dict] = None,
                explicit_out: Optional[set] = None):
    """Build ``cls()`` then apply a YAML/JSON file and/or override dict.

    ``explicit_out``: optional set that collects the top-level keys the
    user actually set (file + overrides), so callers can tell them from
    dataclass defaults (:meth:`FusionTrainConfig.arity_defaults`).
    """
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
        if explicit_out is not None and data:
            explicit_out.update(data)
    if overrides:
        _update_dataclass(cfg, overrides)
        if explicit_out is not None:
            explicit_out.update(overrides)
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
