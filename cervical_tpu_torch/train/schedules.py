"""Learning-rate schedules — the port's own copy of
``cervical_tpu/train/schedules.py``.

The reference's two schedule families as pure functions ``epoch -> lr``
(all training in the reference steps LR per *epoch*):

* YOLOX-style warm-cos and step decay used by the segmentation trainer
  (``Segmentation/deeplabv3+/nets/deeplabv3_training.py:81-117``).
* the multimodal drivers' step decay ``lr * gamma**(epoch // step)``
  (``MultiModal Prediction/Four_Modal/util.py:79-82``).
"""

from __future__ import annotations

import math


def warm_cos_schedule(lr, min_lr, total_iters, warmup_iters_ratio=0.1,
                      warmup_lr_ratio=0.1, no_aug_iter_ratio=0.3):
    """Quadratic warmup (<=3 epochs) -> cosine -> min-lr plateau (<=15 epochs).

    Exact semantics of ``get_lr_scheduler('cos', ...)``
    (deeplabv3_training.py:82-109), including the min/max clamps on the warmup
    and plateau lengths.
    """
    warmup_total = min(max(warmup_iters_ratio * total_iters, 1), 3)
    warmup_lr_start = max(warmup_lr_ratio * lr, 1e-6)
    no_aug = min(max(no_aug_iter_ratio * total_iters, 1), 15)

    def schedule(iters):
        if iters <= warmup_total:
            return (lr - warmup_lr_start) * (iters / float(warmup_total)) ** 2 + warmup_lr_start
        if iters >= total_iters - no_aug:
            return min_lr
        return min_lr + 0.5 * (lr - min_lr) * (
            1.0 + math.cos(math.pi * (iters - warmup_total) / (total_iters - warmup_total - no_aug))
        )

    return schedule


def step_schedule(lr, min_lr, total_iters, step_num=10):
    """Geometric step decay (deeplabv3_training.py:95-100,110-115)."""
    if step_num < 2:
        raise ValueError("step_num must be >= 2")
    decay_rate = (min_lr / lr) ** (1 / (step_num - 1))
    step_size = total_iters / step_num

    def schedule(iters):
        if step_size < 1:
            raise ValueError("step_size must be above 1.")
        n = iters // step_size
        return lr * decay_rate ** int(n)

    return schedule


def get_lr_scheduler(lr_decay_type, lr, min_lr, total_iters, **kwargs):
    """Dispatcher mirroring ``get_lr_scheduler`` (deeplabv3_training.py:81-117)."""
    if lr_decay_type == "cos":
        keys = ("warmup_iters_ratio", "warmup_lr_ratio", "no_aug_iter_ratio")
        return warm_cos_schedule(lr, min_lr, total_iters,
                                 **{k: v for k, v in kwargs.items() if k in keys})
    return step_schedule(lr, min_lr, total_iters,
                         **{k: v for k, v in kwargs.items() if k == "step_num"})


def fusion_step_decay(lr, gamma=0.8, lr_step=40):
    """``lr * gamma**(epoch // lr_step)`` — ``adjust_learning_rate``
    (Four_Modal/util.py:79-82; step/gamma deltas per driver in SURVEY §2.1)."""

    def schedule(epoch):
        return lr * gamma ** (epoch // lr_step)

    return schedule


def adaptive_seg_lr(init_lr, min_lr, batch_size, nbs=16, backbone="xception",
                    optimizer_type="adam"):
    """Batch-size-scaled (init_lr_fit, min_lr_fit) with the reference's
    backbone-specific clamps.

    Reference: train.py:459-467 —
    ``Init_lr_fit = clip(batch/nbs * Init_lr, [lr_limit_min, lr_limit_max])``;
    ``Min_lr_fit  = clip(batch/nbs * Min_lr, [lr_limit_min*1e-2, lr_limit_max*1e-2])``;
    adam limits (5e-4, 3e-4) generally, (1e-4, 1e-4) for xception.
    """
    if optimizer_type == "adam":
        lr_limit_max, lr_limit_min = 5e-4, 3e-4
        if backbone == "xception":
            lr_limit_max, lr_limit_min = 1e-4, 1e-4
    else:
        lr_limit_max, lr_limit_min = 1e-1, 5e-4
    init_lr_fit = min(max(batch_size / nbs * init_lr, lr_limit_min), lr_limit_max)
    min_lr_fit = min(max(batch_size / nbs * min_lr, lr_limit_min * 1e-2), lr_limit_max * 1e-2)
    return init_lr_fit, min_lr_fit
