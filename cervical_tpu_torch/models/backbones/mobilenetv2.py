"""MobileNetV2 backbone with output-stride surgery — port of
``cervical_tpu/models/backbones/mobilenetv2.py``.

Reference: ``Segmentation/deeplabv3+/nets/mobilenetv2.py`` (the inverted-
residual stack) and the ``_nostride_dilate`` stride-to-dilation rewrite in
``nets/deeplabv3_plus.py:7-49``, which turns the os32 classifier trunk into
an os8/os16 dense-prediction backbone.  As in the JAX package, every
block's (stride, dilation) is planned statically before the modules are
built (:func:`_block_plan`): the same network, no surgery after
construction.

Modules carry the reference torch model's names: the stem is
``features.0.{0,1}``; block ``N`` is ``features.N.conv.{0,1,3,4}`` when its
expansion ``t`` is 1 and ``features.N.conv.{0,1,3,4,6,7}`` otherwise — the
scheme ``cervical_tpu/train/torch_import.convert_mobilenetv2`` reads, so a
bubbliiiing ``mobilenet_v2.pth.tar`` loads key for key under ``backbone.``.
DeepLab keeps ``features[:-1]``: blocks 0-17, without the 1280-wide block 18.
NCHW in; returns (low-level features [os4, 24 channels], high-level
features [os8/16, 320 channels]).

BatchNorm: the reference's torch momentum 0.1, eps 1e-5, with flax's
running variance in train mode (``ops.conv.BatchNorm2d``).  Depthwise convs
are grouped ``Conv2d``s, the choice ``ops/depthwise.py`` documents: the JAX
package's shift ladder is a TPU lowering of the same conv.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from cervical_tpu_torch.ops.conv import BatchNorm2d, Conv2d

# t (expand), c (channels), n (repeats), s (stride) — mobilenetv2.py:80-89
INVERTED_RESIDUAL_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

# feature indices: 0 = stem conv, 1..17 = inverted-residual blocks
DOWN_IDX = (2, 4, 7, 14)  # deeplabv3_plus.py:16
TOTAL_IDX = 18

_BN = dict(momentum=0.1, eps=1e-5)


class ReLU6(nn.Module):
    """``min(relu(x), 6)``, the JAX package's form of ``nn.ReLU6``."""

    def forward(self, x):
        return torch.clamp(torch.relu(x), max=6.0)


def conv_bn_relu6(inp: int, features: int, kernel: int = 3, stride: int = 1,
                  dilation: int = 1, groups: int = 1,
                  compute_dtype: Optional[torch.dtype] = None):
    """``ConvBNReLU6`` as the reference's Sequential entries: [conv (no
    bias), BN, ReLU6]; a 3x3 conv pads by its dilation."""
    return [Conv2d(inp, features, kernel, stride=stride,
                   padding=dilation * (kernel // 2), dilation=dilation,
                   groups=groups, bias=False, compute_dtype=compute_dtype),
            BatchNorm2d(features, **_BN), ReLU6()]


class InvertedResidual(nn.Module):
    """``InvertedResidual`` (mobilenetv2.py:24-72) with a static (stride,
    dilation): [1x1 expand, BN, ReLU6] when ``expand_ratio != 1``, then the
    3x3 depthwise, BN, ReLU6, then the 1x1 projection and BN, all in one
    ``conv`` Sequential as the reference numbers them."""

    def __init__(self, inp: int, features: int, stride: int = 1,
                 expand_ratio: int = 6, dilation: int = 1,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        hidden = round(inp * expand_ratio)
        # the planned stride, as in JAX; the reference tests its stride at
        # construction, before the surgery.  The two agree: the plan turns
        # a stride 2 into 1 only at blocks 7 (32 -> 64 channels) and 14
        # (96 -> 160), which change their width, so neither adds the
        # residual there.
        self.use_res = stride == 1 and inp == features
        layers = []
        if expand_ratio != 1:
            layers += conv_bn_relu6(inp, hidden, 1,
                                    compute_dtype=compute_dtype)
        layers += conv_bn_relu6(hidden, hidden, 3, stride, dilation,
                                groups=hidden, compute_dtype=compute_dtype)
        layers += [Conv2d(hidden, features, 1, bias=False,
                          compute_dtype=compute_dtype),
                   BatchNorm2d(features, **_BN)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.use_res else y


def _block_plan(downsample_factor: int):
    """Static [stride, dilation, t, c] per block (feature indices 1..17),
    replicating ``_nostride_dilate`` (deeplabv3_plus.py:18-44): inside a
    dilated stage a stride-2 block gets stride 1 and dilation
    ``dilate // 2``, its stride-1 blocks dilation ``dilate``."""
    plan = []
    for t, c, n, s in INVERTED_RESIDUAL_SETTING:
        for i in range(n):
            plan.append([s if i == 0 else 1, 1, t, c])

    def apply(start, end, dilate):
        for j in range(start - 1, end - 1):  # plan[j] is feature j + 1
            if plan[j][0] == 2:
                plan[j][0] = 1
                plan[j][1] = dilate // 2
            else:
                plan[j][1] = dilate

    if downsample_factor == 8:
        apply(DOWN_IDX[-2], DOWN_IDX[-1], 2)
        apply(DOWN_IDX[-1], TOTAL_IDX, 4)
    elif downsample_factor == 16:
        apply(DOWN_IDX[-1], TOTAL_IDX, 2)
    elif downsample_factor != 32:
        raise ValueError(f"unsupported downsample_factor {downsample_factor}")
    return plan


class MobileNetV2Backbone(nn.Module):
    """Low/high feature extractor (deeplabv3_plus.py:7-49): ``features``
    holds the stem and blocks 1-17; ``low`` is block 3's output."""

    def __init__(self, downsample_factor: int = 16,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dt = compute_dtype
        blocks = [nn.Sequential(*conv_bn_relu6(3, 32, 3, stride=2,
                                               compute_dtype=dt))]
        inp = 32
        for stride, dilation, t, c in _block_plan(downsample_factor):
            blocks.append(InvertedResidual(inp, c, stride, t, dilation, dt))
            inp = c
        self.features = nn.Sequential(*blocks)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        low = self.features[:4](x)
        return low, self.features[4:](low)
