"""Floating-point operations (2 per multiply-add) of the reference
DeepLabV3+, counted from the shapes of its convolutions on the ``meta``
device: nothing is computed, and the count is the model's, not the
program's (the program's bilinear resizes, done as dense products, and the
augmentation are not counted).

The forward is what ``torch.utils.flop_counter.FlopCounterMode`` counts for
it (a test holds the two equal).  The backward is counted here and not by
``FlopCounterMode``, which counts a grouped convolution's weight gradient
as if the convolution were dense (for a depthwise one, channels times too
many): each convolution's input gradient and weight gradient cost one
forward each, and the stem takes no input gradient.
"""

from __future__ import annotations

import functools

import torch

from benchmarks.reference.model import DeepLab, Depthwise, QConv2d


def _conv_flops(model, x) -> list:
    """Forward operations of each convolution, in call order."""
    counts = []

    def hook(mod, _inp, out):
        counts.append(2 * out.numel() * mod.weight[0].numel())

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (QConv2d, Depthwise))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return counts


@functools.lru_cache(maxsize=None)
def forward(backbone: str, num_classes: int, hw: tuple) -> int:
    """One eval-mode forward of one ``hw`` image."""
    with torch.device("meta"):
        model = DeepLab(backbone, num_classes).eval()
        return sum(_conv_flops(model, torch.zeros(1, 3, *hw)))


@functools.lru_cache(maxsize=None)
def train_step(backbone: str, num_classes: int, hw: tuple) -> int:
    """Per image of a training step: forward, then the input and weight
    gradients of every convolution but the stem's input gradient."""
    with torch.device("meta"):
        model = DeepLab(backbone, num_classes).eval()
        counts = _conv_flops(model, torch.zeros(1, 3, *hw))
    return 3 * sum(counts) - counts[0]
