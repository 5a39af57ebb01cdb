"""Modified Aligned Xception backbone — port of
``cervical_tpu/models/backbones/xception.py``.

Modules are named like the reference torch model
(``Segmentation/deeplabv3+/nets/xception.py``: ``conv1``/``bn1``,
``blockN.sepconvK.depthwise/bn1/pointwise/bn2``, ``blockN.skip/skipbn``),
so a ``state_dict`` maps onto the JAX package's params through its
``train/torch_import.convert_xception``.  NCHW in, NCHW out; the predictor
runs it in ``channels_last``.

BatchNorm uses the reference's ``bn_mom = 0.0003`` (torch convention) and
eps 1e-5.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from cervical_tpu_torch.ops.conv import Conv2d
from cervical_tpu_torch.ops.depthwise import depthwise_conv3x3
from cervical_tpu_torch.ops.middle_flow import fold_middle_flow, middle_flow_eval

_BN = dict(momentum=0.0003, eps=1e-5)


class DepthwiseConv3x3(nn.Module):
    """Depthwise 3x3 via :func:`ops.depthwise.depthwise_conv3x3`; the
    ``weight`` is (C, 1, 3, 3) like the reference's grouped ``nn.Conv2d``."""

    def __init__(self, channels: int, stride: int = 1, dilation: int = 1,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, 3, 3))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self.stride, self.dilation = stride, dilation
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype or x.dtype
        y = depthwise_conv3x3(x.to(dt).permute(0, 2, 3, 1),
                              self.weight.to(dt).permute(2, 3, 1, 0),
                              self.stride, self.dilation)
        return y.permute(0, 3, 1, 2)


class SeparableConv(nn.Module):
    """``SeparableConv2d`` (xception.py:9-31): optional pre-ReLU, depthwise
    conv + BN (+ ReLU), pointwise conv + BN (+ ReLU)."""

    def __init__(self, inp: int, features: int, stride: int = 1,
                 dilation: int = 1, activate_first: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.activate_first = activate_first
        self.depthwise = DepthwiseConv3x3(inp, stride, dilation, compute_dtype)
        self.bn1 = nn.BatchNorm2d(inp, **_BN)
        self.pointwise = Conv2d(inp, features, 1, bias=False,
                                compute_dtype=compute_dtype)
        self.bn2 = nn.BatchNorm2d(features, **_BN)

    def forward(self, x):
        if self.activate_first:
            x = torch.relu(x)
        x = self.bn1(self.depthwise(x))
        if not self.activate_first:
            x = torch.relu(x)
        x = self.bn2(self.pointwise(x))
        if not self.activate_first:
            x = torch.relu(x)
        return x


class XceptionBlock(nn.Module):
    """Residual block of three separable convs (xception.py:33-73).

    ``forward`` returns (out, hook); ``hook`` is the second separable conv's
    output (block2's 256-channel low-level feature).
    """

    def __init__(self, inp: int, features: int, stride: int = 1,
                 atrous: Sequence[int] = (1, 1, 1), grow_first: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if features != inp or stride != 1:
            self.skip = Conv2d(inp, features, 1, stride=stride, bias=False,
                               compute_dtype=compute_dtype)
            self.skipbn = nn.BatchNorm2d(features, **_BN)
        else:
            self.skip = None
        filters = features if grow_first else inp
        a = atrous
        self.sepconv1 = SeparableConv(inp, filters, 1, a[0],
                                      compute_dtype=compute_dtype)
        self.sepconv2 = SeparableConv(filters, features, 1, a[1],
                                      compute_dtype=compute_dtype)
        self.sepconv3 = SeparableConv(features, features, stride, a[2],
                                      compute_dtype=compute_dtype)

    def forward(self, x):
        if self.skip is not None:
            skip = self.skipbn(self.skip(x))
        else:
            # identity-skip blocks add relu(x), NOT x: the reference's
            # in-place ReLU mutates the aliased skip (docs/PARITY.md)
            skip = torch.relu(x)
        y = self.sepconv2(self.sepconv1(x))
        hook = y
        y = self.sepconv3(y)
        return y + skip, hook


class XceptionBackbone(nn.Module):
    """Full backbone (xception.py:76-182).  Returns (low_level [os4, 256ch],
    high [os{8,16}, 2048ch]).

    ``fused_middle``: in eval mode, run blocks 4-19 through
    :func:`ops.middle_flow.middle_flow_eval` on BN-folded weights (the
    Hopper kernels on CUDA).  The folded weights are cached; the cache is
    dropped by ``train()``, ``to()``/``cuda()`` and ``load_state_dict``.
    Weights edited in place otherwise need :meth:`refold`.
    """

    def __init__(self, downsample_factor: int = 16,
                 compute_dtype: Optional[torch.dtype] = None,
                 fused_middle: bool = False):
        super().__init__()
        if downsample_factor == 8:
            stride_list = (2, 1, 1)
        elif downsample_factor == 16:
            stride_list = (2, 2, 1)
        else:
            raise ValueError(
                f"output stride {downsample_factor} is not supported")
        self.rate = rate = 16 // downsample_factor
        self.fused_middle = fused_middle
        self._folded = None
        dt = compute_dtype
        self.conv1 = Conv2d(3, 32, 3, stride=2, padding=1, bias=False,
                            compute_dtype=dt)
        self.bn1 = nn.BatchNorm2d(32, **_BN)
        self.conv2 = Conv2d(32, 64, 3, padding=1, bias=False, compute_dtype=dt)
        self.bn2 = nn.BatchNorm2d(64, **_BN)
        self.block1 = XceptionBlock(64, 128, 2, compute_dtype=dt)
        self.block2 = XceptionBlock(128, 256, stride_list[0], compute_dtype=dt)
        self.block3 = XceptionBlock(256, 728, stride_list[1], compute_dtype=dt)
        for i in range(4, 20):
            setattr(self, f"block{i}",
                    XceptionBlock(728, 728, 1, (rate,) * 3, compute_dtype=dt))
        self.block20 = XceptionBlock(728, 1024, stride_list[2], (rate,) * 3,
                                     grow_first=False, compute_dtype=dt)
        self.conv3 = SeparableConv(1024, 1536, 1, rate, activate_first=False,
                                   compute_dtype=dt)
        self.conv4 = SeparableConv(1536, 1536, 1, rate, activate_first=False,
                                   compute_dtype=dt)
        self.conv5 = SeparableConv(1536, 2048, 1, rate, activate_first=False,
                                   compute_dtype=dt)
        self.register_load_state_dict_post_hook(
            lambda module, keys: module.refold())

    def refold(self):
        """Drop the cached BN-folded middle-flow weights."""
        self._folded = None

    def train(self, mode: bool = True):
        self.refold()
        return super().train(mode)

    def _apply(self, fn, *args, **kwargs):
        self.refold()
        return super()._apply(fn, *args, **kwargs)

    def _middle_fused(self, x):
        if self._folded is None or self._folded["wdw"].dtype != x.dtype:
            self._folded = fold_middle_flow(self, first=4, count=16,
                                            compute_dtype=x.dtype)
        # NHWC for the kernels: a view when x is channels_last, else a copy
        xh = x.permute(0, 2, 3, 1).contiguous()
        return middle_flow_eval(xh, self._folded, self.rate).permute(0, 3, 1, 2)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        x, _ = self.block1(x)
        x, low = self.block2(x)
        x, _ = self.block3(x)
        if self.fused_middle and not self.training:
            x = self._middle_fused(x)
        else:
            for i in range(4, 20):
                x, _ = getattr(self, f"block{i}")(x)
        x, _ = self.block20(x)
        x = self.conv5(self.conv4(self.conv3(x)))
        return low, x
