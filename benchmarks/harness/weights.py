"""Seeded weights for a DeepLab ``state_dict``, made on the device in a few
large calls, handed alike to the program and to the reference.

Names and shapes come from the reference model built on the ``meta``
device (its names are the reference repository's, which the program
keeps).  Every conv kernel ~ N(0, 1 / fan_in), so an eval-mode forward
keeps its scale through the depth and the masks depend on the image; conv
biases ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's default), BatchNorm
scales ~ N(1, 0.02), shifts 0, running statistics (0, 1).  The
configuration file's ``weights`` sets the rest: ``"residual_bn": r``
multiplies the scale of each BatchNorm that ends a residual branch by
``r`` (the small-residual start of "zero-init residual" training): a
random network of full depth is otherwise chaotic, rounding of one part in
2^8 moving a quarter of its argmax pixels, where a trained one is not.
With ``"calibrate_bn": n`` the running statistics are then set, as a
trained network's would be, to the batch statistics of one
train-mode forward of the reference model (float32, TF32 off) over ``n``
synthetic scenes made from the same seed: every BatchNorm of an eval-mode
forward then normalises its input, and the logits keep a scale at which
the served masks depend on the image.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmarks.harness import datagen
from benchmarks.reference.model import (BN, Block, DeepLab,
                                        InvertedResidual, fp32_exact)


def _residual_ends(model) -> set:
    """Names of the BatchNorms that end a residual branch: an Xception
    block's last separable conv, an inverted residual's projection."""
    out = set()
    for name, m in model.named_modules():
        if isinstance(m, Block):
            out.add(f"{name}.sepconv3.bn2")
        elif isinstance(m, InvertedResidual) and m.use_res:
            out.add(f"{name}.conv.{len(m.conv) - 1}")
    return out


def layout(backbone: str, num_classes: int) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every ``state_dict`` entry; kind is one of
    conv, conv_bias, bn_weight, bn_weight_residual (a BatchNorm that ends
    a residual branch), bn_bias, bn_mean, bn_var, bn_count."""
    with torch.device("meta"):
        model = DeepLab(backbone, num_classes)
    bn = {n for n, m in model.named_modules() if isinstance(m, BN)}
    ends = _residual_ends(model)
    out = []
    for name, t in model.state_dict().items():
        mod, leaf = name.rsplit(".", 1)
        if mod in bn:
            kind = {"weight": "bn_weight", "bias": "bn_bias",
                    "running_mean": "bn_mean", "running_var": "bn_var",
                    "num_batches_tracked": "bn_count"}[leaf]
            if kind == "bn_weight" and mod in ends:
                kind = "bn_weight_residual"
        else:
            kind = "conv" if leaf == "weight" else "conv_bias"
        out.append((name, tuple(t.shape), kind))
    return out


def _fan_in(shape) -> int:
    n = 1
    for s in shape[1:]:
        n *= s
    return n


def make(backbone: str, num_classes: int, seed: int, scheme: Dict,
         device, hw=(512, 512)) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``scheme`` from ``seed``, float32 on ``device``;
    ``hw`` is the size of the calibration scenes."""
    sd = _draw(backbone, num_classes, seed, scheme, device)
    n = scheme.get("calibrate_bn", 0)
    return _calibrate(backbone, num_classes, sd, seed, n, device, hw) \
        if n else sd


@torch.no_grad()
def _calibrate(backbone, num_classes, sd, seed, n, device, hw):
    model = DeepLab(backbone, num_classes).to(device)
    model.load_state_dict(sd)
    model.train()
    for m in model.modules():
        if isinstance(m, BN):
            m.momentum = 1.0
    images, _ = datagen.scenes(seed, n, hw, num_classes, device,
                               labels=False)
    for d in model.dropouts():
        d.keep = torch.ones((), device=device)
    with fp32_exact():
        model(images.permute(0, 3, 1, 2).to(torch.float32) / 255.0)
    return {k: v.detach() for k, v in model.state_dict().items()}


def _draw(backbone, num_classes, seed, scheme, device):
    entries = layout(backbone, num_classes)
    g = torch.Generator(device).manual_seed(seed)
    sizes = {n: int(torch.Size(s).numel()) for n, s, _ in entries}
    fans = {n: _fan_in(s) for n, s, k in entries if k == "conv"}
    conv = [n for n, _, k in entries if k == "conv"]
    bias = [n for n, _, k in entries if k == "conv_bias"]
    bnw = [n for n, _, k in entries if k.startswith("bn_weight")]
    residual = {n for n, _, k in entries if k == "bn_weight_residual"}
    res_scale = float(scheme.get("residual_bn", 1.0))

    def draw(names, fn, scales):
        counts = torch.tensor([sizes[n] for n in names], device=device)
        flat = fn(int(counts.sum()))
        flat = flat * torch.repeat_interleave(
            torch.tensor(scales, dtype=torch.float32, device=device), counts)
        return dict(zip(names, torch.split(flat, [sizes[n] for n in names])))

    def normal(n):
        return torch.randn(n, generator=g, device=device)

    def sym_uniform(n):
        return torch.rand(n, generator=g, device=device) * 2.0 - 1.0

    parts = draw(conv, normal, [1.0 / fans[n] ** 0.5 for n in conv])
    # a conv bias follows its kernel: "<module>.bias" beside "<module>.weight"
    parts.update(draw(bias, sym_uniform,
                      [1.0 / fans[n[:-4] + "weight"] ** 0.5 for n in bias]))
    parts.update({n: (t + 1.0) * (res_scale if n in residual else 1.0)
                  for n, t in draw(bnw, normal, [0.02] * len(bnw)).items()})
    out = {}
    for name, shape, kind in entries:
        if name in parts:
            out[name] = parts[name].view(shape)
        elif kind == "bn_count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
        elif kind == "bn_var":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
