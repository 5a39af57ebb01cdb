"""ResNet-50/101 patch featurizer — port of
``cervical_tpu/models/backbones/resnet.py``.

Reference: the multimodal pipeline featurizes each 256x256 patch with a
torchvision ``resnet101(pretrained=True)`` whose final fc is replaced by a
1024-d projection (``MultiModal Prediction/Graph_Structure(data_augmentation)
.py:131-142``).  Modules carry torchvision's names (``conv1``, ``bn1``,
``layer{s}.{i}.conv{k}/bn{k}``, ``layer{s}.{i}.downsample.{0,1}``, ``fc``),
the scheme ``cervical_tpu/train/torch_import.convert_resnet`` reads, so a
torchvision checkpoint loads through ``train/torch_import.load_into``.
NCHW in; (B, out_features) f32 embeddings out (the JAX package's
default ``dtype=None``).

BatchNorm: flax momentum 0.9 is torch momentum 0.1, eps 1e-5, with flax's
running variance in train mode (``ops.conv.BatchNorm2d``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cervical_tpu_torch.models.layers import _TRUNC_CORRECTION
from cervical_tpu_torch.ops.conv import BatchNorm2d

_BN = dict(momentum=0.1, eps=1e-5)

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}

# torchvision ImageNet preprocessing (Graph_Structure:144-148)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1 at 4x the width, each with BN; a
    strided 1x1 + BN projection where the width or the stride changes."""

    def __init__(self, inp: int, features: int, stride: int = 1):
        super().__init__()
        out = features * 4
        self.conv1 = nn.Conv2d(inp, features, 1, bias=False)
        self.bn1 = BatchNorm2d(features, **_BN)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride,
                               padding=1, bias=False)
        self.bn2 = BatchNorm2d(features, **_BN)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out, **_BN)
        self.downsample = None
        if inp != out or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(inp, out, 1, stride=stride, bias=False),
                BatchNorm2d(out, **_BN))

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNetFeaturizer(nn.Module):
    """ResNet trunk (7x7/2 stem, 3x3/2 max-pool, four stages of
    ``STAGE_BLOCKS[depth]`` bottlenecks) + global mean + ``fc`` to
    ``out_features``."""

    def __init__(self, depth: int = 101, out_features: int = 1024):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, **_BN)
        inp = 64
        for stage, (w, n) in enumerate(zip((64, 128, 256, 512),
                                           STAGE_BLOCKS[depth])):
            blocks = []
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(Bottleneck(inp, w, stride))
                inp = w * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(inp, out_features)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for stage in range(1, 5):
            y = getattr(self, f"layer{stage}")(y)
        return self.fc(y.mean(dim=(2, 3)))


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw ``model`` as flax initialises the JAX package's featurizer:
    conv and fc kernels lecun-normal (std sqrt(1/fan_in), truncated at 2
    sigma), biases 0, BatchNorm scale 1, bias 0 and running stats reset,
    all drawn from ``generator``."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            std = (1.0 / m.weight[0].numel()) ** 0.5 / _TRUNC_CORRECTION
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
    return model


def preprocess_imagenet(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB -> torchvision-normalised f32, NHWC."""
    x = images_u8.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std
