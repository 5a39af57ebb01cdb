"""DeepLabV3+ (Xception or MobileNetV2 backbone, output stride 16) in plain
PyTorch and float32: the yardstick the benchmark holds the port's outputs
against.

It follows the reference repository, bubbliiiing ``deeplabv3-plus-pytorch``
(``nets/deeplabv3_plus.py``, ``nets/xception.py``, ``nets/mobilenetv2.py``),
with the two departures the system under test also makes and documents:

* an identity-skip Xception block adds ``relu(x)``, not ``x`` (the
  reference's in-place ReLU mutates the aliased skip);
* in train mode BatchNorm's running variance takes the biased batch
  variance (flax's rule), normalisation is torch's.

Module and parameter names are the reference's, so one ``state_dict`` made
by the benchmark loads into this model and into the program alike.  No
module of the program is imported.  ``quantized`` runs every convolution
in float8 (inputs and weights e4m3, output gradients e5m2, per-tensor
scales), the lower-precision control of the comparison, or in bfloat16, a
witness of what rounding alone does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype``: bfloat16 as it is, float8 under a
    per-tensor scale that maps its largest magnitude to the format's
    largest finite value."""
    if dtype == torch.bfloat16:
        return x.to(dtype).to(x.dtype)
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _GradRound(torch.autograd.Function):
    """Identity forward; the gradient rounded to ``dtype``."""

    @staticmethod
    def forward(ctx, y, dtype):
        ctx.dtype = dtype
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.dtype), None


class Quant:
    """A convolution in lower precision: its input and weight rounded to
    ``operand`` (straight-through), its output to ``output`` where given,
    the gradient of its output to ``grad``; products accumulate in
    float32.  ``PRECISIONS`` names the two the comparison uses."""

    def __init__(self, operand, grad, output=None):
        self.operand, self.grad_dtype, self.output = operand, grad, output

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x + (_round(x.detach(), self.operand) - x).detach()

    def out(self, y: torch.Tensor) -> torch.Tensor:
        if self.output is not None:
            y = y + (_round(y.detach(), self.output) - y).detach()
        return _GradRound.apply(y, self.grad_dtype) if y.requires_grad \
            else y


PRECISIONS = {
    # the control: the float8 recipe of training (e4m3 operands, e5m2
    # output gradients, per-tensor scales)
    "float8": lambda: Quant(torch.float8_e4m3fn, torch.float8_e5m2),
    # a witness: bfloat16 operands, outputs and gradients, as a bfloat16
    # program computes its convolutions
    "bfloat16": lambda: Quant(torch.bfloat16, torch.bfloat16,
                              torch.bfloat16),
}


class QConv2d(nn.Conv2d):
    """``nn.Conv2d`` in lower precision when ``quant`` is set
    (``quantized``)."""

    quant: Optional[Quant] = None

    def forward(self, x):
        if self.quant is None:
            return self._conv_forward(x, self.weight, self.bias)
        y = self._conv_forward(self.quant(x), self.quant(self.weight),
                               self.bias)
        return self.quant.out(y)


class BN(nn.BatchNorm2d):
    """Train mode: batch statistics, running mean by torch's rule, running
    variance lerped towards the biased batch variance."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = (0, 2, 3)
        mean = x.mean(dims)
        var = x.var(dims, unbiased=False)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.lerp_(mean, m)
            self.running_var.lerp_(var, m)
            self.num_batches_tracked.add_(1)
        shape = (1, -1, 1, 1)
        return (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps) \
            * self.weight.view(shape) + self.bias.view(shape)


# --------------------------------------------------------------------------
# Xception (nets/xception.py)
# --------------------------------------------------------------------------

_XBN = dict(momentum=0.0003, eps=1e-5)


class Depthwise(nn.Module):
    def __init__(self, c: int, stride: int, dilation: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c, 1, 3, 3))
        self.stride, self.dilation = stride, dilation

    def forward(self, x):
        q = QConv2d.quant
        if q is None:
            return F.conv2d(x, self.weight, None, self.stride, self.dilation,
                            self.dilation, groups=x.shape[1])
        return q.out(F.conv2d(q(x), q(self.weight), None, self.stride,
                               self.dilation, self.dilation,
                               groups=x.shape[1]))


class SeparableConv(nn.Module):
    def __init__(self, inp, out, stride=1, dilation=1, activate_first=True):
        super().__init__()
        self.activate_first = activate_first
        self.depthwise = Depthwise(inp, stride, dilation)
        self.bn1 = BN(inp, **_XBN)
        self.pointwise = QConv2d(inp, out, 1, bias=False)
        self.bn2 = BN(out, **_XBN)

    def forward(self, x):
        if self.activate_first:
            x = F.relu(x)
        x = self.bn1(self.depthwise(x))
        if not self.activate_first:
            x = F.relu(x)
        x = self.bn2(self.pointwise(x))
        if not self.activate_first:
            x = F.relu(x)
        return x


class Block(nn.Module):
    def __init__(self, inp, out, stride=1, atrous: Sequence[int] = (1, 1, 1),
                 grow_first=True):
        super().__init__()
        if out != inp or stride != 1:
            self.skip = QConv2d(inp, out, 1, stride=stride, bias=False)
            self.skipbn = BN(out, **_XBN)
        else:
            self.skip = None
        mid = out if grow_first else inp
        self.sepconv1 = SeparableConv(inp, mid, 1, atrous[0])
        self.sepconv2 = SeparableConv(mid, out, 1, atrous[1])
        self.sepconv3 = SeparableConv(out, out, stride, atrous[2])

    def forward(self, x):
        skip = self.skipbn(self.skip(x)) if self.skip is not None \
            else F.relu(x)
        y = self.sepconv2(self.sepconv1(x))
        return self.sepconv3(y) + skip, y


class Xception(nn.Module):
    def __init__(self, downsample_factor: int = 16):
        super().__init__()
        strides = (2, 1, 1) if downsample_factor == 8 else (2, 2, 1)
        rate = 16 // downsample_factor
        self.conv1 = QConv2d(3, 32, 3, 2, 1, bias=False)
        self.bn1 = BN(32, **_XBN)
        self.conv2 = QConv2d(32, 64, 3, 1, 1, bias=False)
        self.bn2 = BN(64, **_XBN)
        self.block1 = Block(64, 128, 2)
        self.block2 = Block(128, 256, strides[0])
        self.block3 = Block(256, 728, strides[1])
        for i in range(4, 20):
            setattr(self, f"block{i}", Block(728, 728, 1, (rate,) * 3))
        self.block20 = Block(728, 1024, strides[2], (rate,) * 3,
                             grow_first=False)
        self.conv3 = SeparableConv(1024, 1536, 1, rate, activate_first=False)
        self.conv4 = SeparableConv(1536, 1536, 1, rate, activate_first=False)
        self.conv5 = SeparableConv(1536, 2048, 1, rate, activate_first=False)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x, _ = self.block1(x)
        x, low = self.block2(x)
        for i in range(3, 21):
            x, _ = getattr(self, f"block{i}")(x)
        return low, self.conv5(self.conv4(self.conv3(x)))


# --------------------------------------------------------------------------
# MobileNetV2 (nets/mobilenetv2.py + deeplabv3_plus.py's _nostride_dilate)
# --------------------------------------------------------------------------

_MBN = dict(momentum=0.1, eps=1e-5)
# t (expansion), c (channels), n (repeats), s (stride)
_SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class ReLU6(nn.Module):
    def forward(self, x):
        return torch.clamp(F.relu(x), max=6.0)


def _cbr(inp, out, k, stride=1, dilation=1, groups=1):
    if groups > 1:
        conv = Depthwise(inp, stride, dilation)
    else:
        conv = QConv2d(inp, out, k, stride, dilation * (k // 2), dilation,
                       bias=False)
    return [conv, BN(out, **_MBN), ReLU6()]


class InvertedResidual(nn.Module):
    def __init__(self, inp, out, stride, t, dilation):
        super().__init__()
        hidden = round(inp * t)
        self.use_res = stride == 1 and inp == out
        layers = _cbr(inp, hidden, 1) if t != 1 else []
        layers += _cbr(hidden, hidden, 3, stride, dilation, groups=hidden)
        layers += [QConv2d(hidden, out, 1, bias=False), BN(out, **_MBN)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.use_res else y


def mobilenet_plan(downsample_factor: int):
    """(stride, dilation, t, c) of features 1..17 after
    ``_nostride_dilate`` (down_idx 2, 4, 7, 14; total 18)."""
    plan = []
    for t, c, n, s in _SETTING:
        for i in range(n):
            plan.append([s if i == 0 else 1, 1, t, c])

    def dilate(start, end, d):
        for j in range(start - 1, end - 1):
            if plan[j][0] == 2:
                plan[j][0], plan[j][1] = 1, d // 2
            else:
                plan[j][1] = d

    if downsample_factor == 8:
        dilate(7, 14, 2)
        dilate(14, 18, 4)
    else:
        dilate(14, 18, 2)
    return plan


class MobileNetV2(nn.Module):
    def __init__(self, downsample_factor: int = 16):
        super().__init__()
        blocks = [nn.Sequential(*_cbr(3, 32, 3, 2))]
        inp = 32
        for stride, dilation, t, c in mobilenet_plan(downsample_factor):
            blocks.append(InvertedResidual(inp, c, stride, t, dilation))
            inp = c
        self.features = nn.Sequential(*blocks)

    def forward(self, x):
        low = self.features[:4](x)
        return low, self.features[4:](low)


# --------------------------------------------------------------------------
# DeepLabV3+ head (nets/deeplabv3_plus.py)
# --------------------------------------------------------------------------

_HBN = dict(momentum=0.1, eps=1e-5)


def _head_cbr(inp, out, k=1, dilation=1):
    return nn.Sequential(QConv2d(inp, out, k, 1, dilation * (k // 2),
                                 dilation, bias=True),
                         BN(out, **_HBN), nn.ReLU())


class ASPP(nn.Module):
    def __init__(self, inp, out=256, rate=1):
        super().__init__()
        self.branch1 = _head_cbr(inp, out, 1)
        self.branch2 = _head_cbr(inp, out, 3, 6 * rate)
        self.branch3 = _head_cbr(inp, out, 3, 12 * rate)
        self.branch4 = _head_cbr(inp, out, 3, 18 * rate)
        self.branch5_conv = QConv2d(inp, out, 1, bias=True)
        self.branch5_bn = BN(out, **_HBN)
        self.branch5_relu = nn.ReLU()
        self.conv_cat = _head_cbr(out * 5, out, 1)

    def forward(self, x):
        g = x.mean(dim=(2, 3), keepdim=True)
        g = self.branch5_relu(self.branch5_bn(self.branch5_conv(g)))
        return self.conv_cat(torch.cat(
            [self.branch1(x), self.branch2(x), self.branch3(x),
             self.branch4(x), g.expand(-1, -1, x.shape[2], x.shape[3])], 1))


class Dropout(nn.Module):
    """Dropout whose keep mask the caller hands in (``keep``): the masks
    are inputs the comparison draws the way the program documents."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.keep: Optional[torch.Tensor] = None

    def forward(self, x):
        if not self.training:
            return x
        return x * self.keep.to(x.dtype) * (1.0 / (1.0 - self.p))


class DeepLab(nn.Module):
    """``forward(x)`` -> float32 logits at the low-level features'
    resolution (a quarter of the input); :func:`upsample` takes them to
    the input's."""

    def __init__(self, backbone: str = "xception", num_classes: int = 5,
                 downsample_factor: int = 16):
        super().__init__()
        if backbone == "xception":
            self.backbone = Xception(downsample_factor)
            deep, low = 2048, 256
        elif backbone == "mobilenet":
            self.backbone = MobileNetV2(downsample_factor)
            deep, low = 320, 24
        else:
            raise ValueError(f"unknown backbone {backbone!r}")
        self.aspp = ASPP(deep, 256, 16 // downsample_factor)
        self.shortcut_conv = _head_cbr(low, 48, 1)
        self.cat_conv = nn.Sequential(
            QConv2d(304, 256, 3, 1, 1, bias=True), BN(256, **_HBN), nn.ReLU(),
            Dropout(0.5),
            QConv2d(256, 256, 3, 1, 1, bias=True), BN(256, **_HBN), nn.ReLU(),
            Dropout(0.1))
        self.cls_conv = QConv2d(256, num_classes, 1, bias=True)

    def dropouts(self):
        return [self.cat_conv[3], self.cat_conv[7]]

    def forward(self, x):
        low, deep = self.backbone(x)
        deep = self.aspp(deep)
        low = self.shortcut_conv(low)
        deep = F.interpolate(deep, size=low.shape[2:], mode="bilinear",
                             align_corners=True)
        return self.cls_conv(self.cat_conv(torch.cat([deep, low], 1)))


def upsample(logits: torch.Tensor, hw) -> torch.Tensor:
    """The head's final bilinear resize (``align_corners=True``)."""
    return F.interpolate(logits, size=tuple(hw), mode="bilinear",
                         align_corners=True)


class fp32_exact:
    """Context: float32 products and convolutions without TF32, restoring
    the flags on exit (the program's own work runs at its defaults)."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False


class quantized:
    """Context: every convolution of the reference at ``precision``:
    "float32" as written, or a key of ``PRECISIONS``."""

    def __init__(self, precision: str = "float32"):
        if precision != "float32" and precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def __enter__(self):
        self._saved = QConv2d.quant
        QConv2d.quant = None if self.precision == "float32" \
            else PRECISIONS[self.precision]()
        return self

    def __exit__(self, *exc):
        QConv2d.quant = self._saved
        return False
