"""Depthwise 3x3 convolution, NHWC — port of ``cervical_tpu/ops/depthwise.py``.

The JAX package computes this outside any Pallas kernel (its default is
XLA's grouped conv), so the port uses PyTorch's grouped conv.  The JAX
module's shift-ladder backend is a TPU lowering choice with identical
semantics and is not ported.

    y[b, i, j, c] = sum_{dy,dx} w[dy, dx, c] * x[b, i*s + dy*d - p, j*s + dx*d - p, c]
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def depthwise_conv3x3(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
                      dilation: int = 1, padding: int | None = None):
    """Depthwise 3x3 conv on NHWC ``x``.

    ``kernel``: (3, 3, 1, C), the HWIO layout of the JAX package.
    ``padding`` defaults to ``dilation`` (SAME for stride 1).  Only views
    are taken around the conv: an NHWC-contiguous ``x`` is the
    ``channels_last`` layout of its NCHW permutation.
    """
    kh, kw, one, c = kernel.shape
    if (kh, kw, one) != (3, 3, 1) or x.shape[-1] != c:
        raise ValueError(f"kernel {tuple(kernel.shape)} vs input {tuple(x.shape)}")
    if padding is None:
        padding = dilation
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                 stride=stride, padding=padding, dilation=dilation, groups=c)
    return y.permute(0, 2, 3, 1)
