"""The reference's segmentation loss (``nets/deeplabv3_training.py:9-56``):
weighted focal loss plus soft dice, in float32.  Labels at or above
``num_classes`` are ignored; the focal mean runs over every pixel, ignored
ones included, as in the reference."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def seg_loss(logits, labels, class_weights, num_classes: int,
             alpha=0.5, gamma=2.0, smooth=1e-5, row_weights=None):
    """``logits`` (B, C, H, W) float32 at the labels' resolution, ``labels``
    (B, H, W) integers -> focal + dice.  ``row_weights`` (B,) 0/1 drops the
    padding rows of an eval batch."""
    b, c = logits.shape[:2]
    lab = labels.long()
    valid = lab < num_classes
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    logp = F.log_softmax(logits, dim=1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    w = torch.as_tensor(class_weights, dtype=torch.float32,
                        device=logits.device)
    wnll = torch.where(valid, nll * w[safe], torch.zeros_like(nll))
    focal = (1.0 - torch.exp(-wnll)) ** gamma * alpha * wnll
    probs = torch.softmax(logits, dim=1)
    onehot = F.one_hot(safe, c).permute(0, 3, 1, 2).to(torch.float32) \
        * valid[:, None].to(torch.float32)
    if row_weights is None:
        main = focal.mean()
    else:
        rw = row_weights.to(torch.float32)
        main = (focal * rw[:, None, None]).sum() / (rw.sum() * focal[0].numel())
        probs = probs * rw[:, None, None, None]
        onehot = onehot * rw[:, None, None, None]
    tp = (onehot * probs).sum(dim=(0, 2, 3))
    fp = probs.sum(dim=(0, 2, 3)) - tp
    fn = onehot.sum(dim=(0, 2, 3)) - tp
    score = (2 * tp + smooth) / (2 * tp + fn + fp + smooth)
    return main + (1.0 - score.mean())
