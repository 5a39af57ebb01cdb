"""Segmentation model construction — the part of
``cervical_tpu/train/seg_trainer.py`` the predictor needs (``_dtype``,
``build_model``) plus a seeded random init.  The trainer itself follows in
the training slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from cervical_tpu_torch.config import SegTrainConfig
from cervical_tpu_torch.models.deeplab import DeepLab


def _dtype(cfg: SegTrainConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def build_model(cfg: SegTrainConfig, fused_middle: bool = False) -> DeepLab:
    return DeepLab(num_classes=cfg.data.num_classes, backbone=cfg.backbone,
                   downsample_factor=cfg.downsample_factor, dtype=_dtype(cfg),
                   fused_middle=fused_middle)


@torch.no_grad()
def reference_weights_init(model: nn.Module, generator: torch.Generator,
                           init_gain: float = 0.02) -> nn.Module:
    """``weights_init`` (deeplabv3_training.py:58-76), as the JAX package's
    ``reference_weights_init``: every conv kernel ~ N(0, 0.02), every
    BatchNorm scale ~ N(1, 0.02), BN biases 0, running stats reset.  Conv
    biases are redrawn from torch's default U(±1/sqrt(fan_in)) with the
    same ``generator``, so the whole state is a function of its seed."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.weight.copy_(1.0 + init_gain * torch.randn(
                m.weight.shape, generator=generator))
            m.bias.zero_()
            m.reset_running_stats()
        elif hasattr(m, "weight") and isinstance(m.weight, nn.Parameter) \
                and m.weight.ndim == 4:
            m.weight.copy_(init_gain * torch.randn(m.weight.shape,
                                                   generator=generator))
            bias = getattr(m, "bias", None)
            if isinstance(bias, nn.Parameter):
                bound = 1.0 / (m.weight[0].numel() ** 0.5)
                bias.copy_((torch.rand(bias.shape, generator=generator) * 2
                            - 1) * bound)
    return model
