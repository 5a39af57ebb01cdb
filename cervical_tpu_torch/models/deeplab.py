"""DeepLabV3+ semantic segmentation model — port of
``cervical_tpu/models/deeplab.py`` (reference:
``Segmentation/deeplabv3+/nets/deeplabv3_plus.py:116-188``).

Submodules carry the reference torch model's names (``aspp.branch1.0``,
``aspp.branch5_conv``, ``aspp.conv_cat.0``, ``shortcut_conv.0``,
``cat_conv.0/.1/.4/.5``, ``cls_conv``), which is the scheme
``cervical_tpu/train/torch_import.convert_deeplab`` reads.  NCHW in; fp32
logits out at input resolution.  Backbones: ``xception`` and
``mobilenet``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn

from cervical_tpu_torch.models.backbones.mobilenetv2 import MobileNetV2Backbone
from cervical_tpu_torch.models.backbones.xception import XceptionBackbone
from cervical_tpu_torch.models.layers import Dropout
from cervical_tpu_torch.ops.conv import BatchNorm2d, Conv2d
from cervical_tpu_torch.ops.image import resize_bilinear

_BN = dict(momentum=0.1, eps=1e-5)


def _conv_bn_relu(inp: int, features: int, kernel: int = 1, dilation: int = 1,
                  compute_dtype: Optional[torch.dtype] = None) -> nn.Sequential:
    """``_ConvBNReLU``: conv (with bias) -> BN -> ReLU, as ``Sequential``
    indices 0/1/2 of the reference."""
    return nn.Sequential(
        Conv2d(inp, features, kernel, padding=dilation * (kernel // 2),
               dilation=dilation, bias=True, compute_dtype=compute_dtype),
        BatchNorm2d(features, **_BN), nn.ReLU())


def _resize_nchw(x, out_hw, align_corners=True):
    return resize_bilinear(x.permute(0, 2, 3, 1), out_hw,
                           align_corners).permute(0, 3, 1, 2)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (deeplabv3_plus.py:56-114): 1x1, three
    3x3 at dilation (6, 12, 18) * rate, image pooling; concat; 1x1 fuse."""

    def __init__(self, inp: int, features: int = 256, rate: int = 1,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dt = compute_dtype
        self.branch1 = _conv_bn_relu(inp, features, 1, compute_dtype=dt)
        self.branch2 = _conv_bn_relu(inp, features, 3, 6 * rate, dt)
        self.branch3 = _conv_bn_relu(inp, features, 3, 12 * rate, dt)
        self.branch4 = _conv_bn_relu(inp, features, 3, 18 * rate, dt)
        self.branch5_conv = Conv2d(inp, features, 1, bias=True,
                                   compute_dtype=dt)
        self.branch5_bn = BatchNorm2d(features, **_BN)
        self.branch5_relu = nn.ReLU()
        self.conv_cat = _conv_bn_relu(features * 5, features, 1,
                                      compute_dtype=dt)

    def forward(self, x):
        b1 = self.branch1(x)
        b2 = self.branch2(x)
        b3 = self.branch3(x)
        b4 = self.branch4(x)
        g = x.mean(dim=(2, 3), keepdim=True)
        g = self.branch5_relu(self.branch5_bn(self.branch5_conv(g)))
        g = g.expand_as(b1)  # bilinear resize of a 1x1 map is a broadcast
        return self.conv_cat(torch.cat([b1, b2, b3, b4, g], dim=1))


class DeepLab(nn.Module):
    """DeepLabV3+ (deeplabv3_plus.py:116-188).

    ``dtype`` is the compute dtype (params stay fp32).  ``fused_middle``
    routes the Xception backbone's blocks 4-19 through the middle-flow
    kernels in eval mode (with ``mobilenet`` it raises, as in JAX).
    ``forward(x, resize_logits=True)``: (B, 3, H, W) -> fp32 logits (B,
    num_classes, H, W).  In train mode BatchNorm uses batch statistics and
    the two head dropouts (0.5, 0.1) draw from generators seeded with
    ``dropout_seed`` and ``dropout_seed + 1``.
    """

    def __init__(self, num_classes: int = 5, backbone: str = "xception",
                 downsample_factor: int = 16,
                 dtype: Optional[torch.dtype] = None,
                 fused_middle: bool = False, dropout_seed: int = 0):
        super().__init__()
        if downsample_factor not in (8, 16):
            raise ValueError(
                f"downsample_factor must be 8 or 16, got {downsample_factor}")
        dt = dtype
        if backbone == "xception":
            self.backbone = XceptionBackbone(
                downsample_factor, compute_dtype=dt, fused_middle=fused_middle)
            deep_ch, low_ch = 2048, 256
        elif backbone == "mobilenet":
            if fused_middle:
                raise ValueError("fused_middle is an xception-only fast path")
            self.backbone = MobileNetV2Backbone(downsample_factor,
                                                compute_dtype=dt)
            deep_ch, low_ch = 320, 24
        else:
            raise ValueError(
                f"Unsupported backbone - `{backbone}`, use mobilenet, xception.")
        self.aspp = ASPP(deep_ch, 256, rate=16 // downsample_factor,
                         compute_dtype=dt)
        self.shortcut_conv = _conv_bn_relu(low_ch, 48, 1, compute_dtype=dt)
        self.cat_conv = nn.Sequential(
            Conv2d(304, 256, 3, padding=1, bias=True, compute_dtype=dt),
            BatchNorm2d(256, **_BN), nn.ReLU(), Dropout(0.5, dropout_seed),
            Conv2d(256, 256, 3, padding=1, bias=True, compute_dtype=dt),
            BatchNorm2d(256, **_BN), nn.ReLU(),
            Dropout(0.1, dropout_seed + 1))
        self.cls_conv = Conv2d(256, num_classes, 1, bias=True,
                               compute_dtype=dt)

    def forward(self, x, resize_logits: bool = True,
                freeze_backbone: bool = False):
        """``freeze_backbone``: the reference's requires_grad=False freeze
        phase — the backbone runs without autograd, so its backward pass
        is never built, while its BatchNorm running stats still update in
        train mode (the JAX package's stop_gradient at the boundary)."""
        h, w = x.shape[2], x.shape[3]
        with torch.no_grad() if freeze_backbone else contextlib.nullcontext():
            low, deep = self.backbone(x)
        deep = self.aspp(deep)
        low = self.shortcut_conv(low)
        deep = _resize_nchw(deep, (low.shape[2], low.shape[3]))
        y = self.cat_conv(torch.cat([deep, low], dim=1))
        y = self.cls_conv(y).float()
        if not resize_logits:
            return y
        return _resize_nchw(y, (h, w))
