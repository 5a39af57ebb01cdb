"""The reference's first training steps, in float32 with TF32 off: what the
comparison holds the program's first steps against.

Each step: the reference augmentation of the step's batch, the train-mode
forward with the step's dropout masks, the loss at the input resolution,
the gradient, Adam (torch's defaults of the reference: betas (0.9, 0.999),
eps 1e-8, no weight decay); the eval-mode val pass before the first step
and after the last.  The dropout masks and the augmentation parameters are
drawn from the seed the way the program documents its draws
(``dropout_masks``, ``augment.sample_params``); the row order is the
program's documented ``gather`` shuffle.  Nothing the program made is
read.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmarks.reference import augment as A
from benchmarks.reference.losses import seg_loss
from benchmarks.reference.model import DeepLab, fp32_exact, quantized, upsample


def gather_order(cfg_seed: int, epoch: int, n: int) -> np.ndarray:
    """The ``gather`` shuffle's row order of an ``n``-row epoch."""
    return np.random.default_rng(cfg_seed * 1_000_003 + epoch).permutation(n)


def dropout_masks(dropout_seed: int, shape, device, dtype, steps: int,
                  rates=(0.5, 0.1)):
    """Per step, the head's two keep masks: each dropout draws a
    ``bernoulli_(1 - p)`` tensor of the activation's shape from its own
    device generator seeded ``dropout_seed + i``, in the compute dtype and,
    on a card, the channels-last layout."""
    fmt = torch.channels_last if torch.device(device).type == "cuda" \
        else torch.contiguous_format
    gens = [torch.Generator(device).manual_seed(dropout_seed + i)
            for i in range(len(rates))]
    out = []
    for _ in range(steps):
        out.append([torch.empty(shape, dtype=dtype, device=device,
                                memory_format=fmt).bernoulli_(1.0 - p,
                                                              generator=g)
                    .to(torch.float32).contiguous()
                    for g, p in zip(gens, rates)])
    return out


def follow(backbone: str, state_dict, batches, params, masks, val,
           class_weights, num_classes: int, hw, lr: float,
           precision: str = "float32", fault=None):
    """Run ``len(batches)`` steps from ``state_dict``, with the val pass
    before the first and after the last.

    ``batches``: per step (images (B, S, S, 3) uint8, labels (B, S, S)
    uint8) in the order the step reads its rows; ``params``: per step the
    augmentation parameters; ``masks``: per step the two keep masks;
    ``val``: (images, labels) of the val rows, read in batches of B.
    ``precision`` runs every convolution in float8 (the control) or
    bfloat16 (a witness); ``fault`` names a fault of the comparison's
    tests.  Returns per step ``losses``; ``val``, the val pass's summed
    batch losses and confusion matrix before and after; per leaf
    ``grads`` (step 1's gradient), ``mean`` and ``rms`` (Adam's
    bias-corrected first moment and the root of its second after the
    last step) and ``changes`` (the parameters' change).  A float32 run
    also returns ``val_witness``: the first val pass with the convolutions
    in bfloat16, how far rounding alone moves that seed's val pass."""
    dev = batches[0][0].device
    model = DeepLab(backbone, num_classes).to(dev)
    model.load_state_dict(state_dict)
    names = [n for n, _ in model.named_parameters()]
    leaves = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in leaves]
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    b1, b2, eps = 0.9, 0.999, 1e-8
    b = batches[0][0].shape[0]
    out = {"losses": [], "val": []}
    with fp32_exact(), quantized(precision):
        out["val"].append(eval_pass(model, val, b, class_weights,
                                    num_classes, hw))
        if precision == "float32":
            with quantized("bfloat16"):
                out["val_witness"] = eval_pass(model, val, b, class_weights,
                                               num_classes, hw)
        t = 0
        for step, ((images, labels), p, keep) in enumerate(
                zip(batches, params, masks)):
            if fault == "half_batch":
                h = images.shape[0] // 2
                images, labels = images[:h], labels[:h]
                p = {k: x[:h] for k, x in p.items()}
                keep = [k[:h] for k in keep]
            model.train()
            for d, k in zip(model.dropouts(), keep):
                d.keep = k
            x, y = A.augment(images, labels, p, hw)
            logits = upsample(model(x.permute(0, 3, 1, 2)), hw)
            loss = seg_loss(logits, y, class_weights, num_classes)
            grads = torch.autograd.grad(loss, leaves)
            if step == 0:
                out["grads"] = {n: g.detach() for n, g in zip(names, grads)}
            t = step + 1
            with torch.no_grad():
                for leaf, g, mi, vi in zip(leaves, grads, m, v):
                    mi.mul_(b1).add_(g, alpha=1 - b1)
                    vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (vi / (1 - b2 ** t)).sqrt().add_(eps)
                    leaf.addcdiv_(mi, denom, value=-lr / (1 - b1 ** t))
            out["losses"].append(float(loss.detach()))
        out["val"].append(eval_pass(model, val, b, class_weights,
                                    num_classes, hw))
    out["mean"] = {n: mi / (1 - b1 ** t) for n, mi in zip(names, m)}
    out["rms"] = {n: (vi / (1 - b2 ** t)).sqrt() for n, vi in zip(names, v)}
    out["changes"] = {n: p.detach() - s
                      for n, p, s in zip(names, leaves, start)}
    return out


@torch.no_grad()
def eval_pass(model, val, batch: int, class_weights, num_classes, hw):
    """The eval-mode pass over the val rows in batches of ``batch`` (the
    letterbox of an image already at ``hw`` is the image itself): the sum
    of the batches' losses and the confusion matrix of the argmax (rows
    the label, columns the prediction)."""
    images, labels = val
    model.eval()
    loss, hist = 0.0, torch.zeros(num_classes, num_classes,
                                  dtype=torch.int64, device=images.device)
    for i in range(0, images.shape[0], batch):
        x = images[i:i + batch].permute(0, 3, 1, 2).to(torch.float32) / 255.0
        y = labels[i:i + batch]
        logits = upsample(model(x), hw)
        loss += float(seg_loss(logits, y, class_weights, num_classes))
        lab, pred = y.reshape(-1).long(), logits.argmax(1).reshape(-1)
        keep = lab < num_classes
        hist += torch.bincount(num_classes * lab[keep] + pred[keep],
                               minlength=num_classes ** 2).view(
                                   num_classes, num_classes)
    return {"loss": loss, "hist": hist.cpu()}
