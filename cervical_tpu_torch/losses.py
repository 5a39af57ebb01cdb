"""Losses — port of ``cervical_tpu/losses.py``: the segmentation half
(reference: ``deeplabv3_training.py:9-56`` and the f-score monitor
``utils_metrics.py:13-35``) and the fusion half (my_train(full).py:202,
253,318-341).

Logits are NHWC ``(B, H, W, C)`` and labels ``(B, H, W)`` integers, as in
JAX; the ignore id is ``num_classes`` (the VOC white border).  Optional
``sample_weights`` (B,) make weight-0 rows (padding of a ragged eval batch)
count exactly as if absent.

Given a data axis of more than one rank (``data``, a ``parallel.mesh.
Axis``) every batch-wide sum behind a ratio — the CE or focal numerator
and denominator, dice's and the f-score's ``tp``/``fp``/``fn``, the fusion
losses' weighted means — is summed over the ranks first (``parallel.mesh.
global_sums``, with autograd), so each rank's loss is the global batch's.
Dice is a ratio of batch sums: a mean of per-rank dice would not be the
global dice.
"""

from __future__ import annotations

import torch

from cervical_tpu_torch.ops.image import _interp_tensor
from cervical_tpu_torch.parallel.mesh import global_sums


def _flat_ce_terms(logits, labels, class_weights, num_classes):
    """Per-pixel weighted NLL ``w[y] * (-log p_y)`` (0 where ignored), the
    weights and the validity mask — ``CrossEntropyLoss(weight=w,
    ignore_index=num_classes, reduction='none')``."""
    logits = logits.to(torch.float32)
    valid = labels < num_classes
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    eq = (safe[..., None] == torch.arange(num_classes, device=logits.device)
          ).to(torch.float32)
    nll = -torch.sum(logp * eq, dim=-1)
    if class_weights is None:
        wy = valid.to(torch.float32)
    else:
        w = torch.as_tensor(class_weights, dtype=torch.float32,
                            device=logits.device)
        wy = torch.where(valid, torch.sum(w * eq, dim=-1),
                         torch.zeros_like(nll))
    return nll * wy, wy, valid


def _row_weights(sample_weights, ndim, device):
    """(B,) weights broadcast over per-pixel terms of rank ``ndim``."""
    w = torch.as_tensor(sample_weights, dtype=torch.float32, device=device)
    return w.reshape(w.shape + (1,) * (ndim - 1))


def cross_entropy_loss(logits, labels, class_weights=None, num_classes=None,
                       sample_weights=None):
    """Weighted CE (``CE_Loss``, deeplabv3_training.py:9-19): the weighted
    mean divides by the summed weights of the non-ignored targets."""
    if num_classes is None:
        num_classes = logits.shape[-1]
    wnll, wy, _ = _flat_ce_terms(logits, labels, class_weights, num_classes)
    if sample_weights is not None:
        rw = _row_weights(sample_weights, wnll.ndim, wnll.device)
        wnll, wy = wnll * rw, wy * rw
    return torch.sum(wnll) / torch.clamp(torch.sum(wy), min=1e-12)


def focal_loss(logits, labels, class_weights=None, num_classes=None,
               alpha=0.5, gamma=2.0, sample_weights=None):
    """Focal loss (``Focal_Loss``, deeplabv3_training.py:21-36), reference
    quirks kept: ``pt`` comes from the *weighted* NLL, ``alpha`` scales the
    log term, and the mean runs over all pixels, ignored ones included."""
    if num_classes is None:
        num_classes = logits.shape[-1]
    wnll, _, _ = _flat_ce_terms(logits, labels, class_weights, num_classes)
    focal = (1.0 - torch.exp(-wnll)) ** gamma * alpha * wnll
    if sample_weights is None:
        return torch.mean(focal)
    rw = _row_weights(sample_weights, focal.ndim, focal.device)
    per_row = focal[0].numel()
    return torch.sum(focal * rw) / torch.clamp(torch.sum(rw) * per_row,
                                               min=1e-12)


def _dice_terms(probs, target):
    tp = torch.sum(target[..., :-1] * probs, dim=(0, 1))
    fp = torch.sum(probs, dim=(0, 1)) - tp
    fn = torch.sum(target[..., :-1], dim=(0, 1)) - tp
    return tp, fp, fn


def _score(tp, fp, fn, beta, smooth):
    return ((1 + beta ** 2) * tp + smooth) / \
        ((1 + beta ** 2) * tp + beta ** 2 * fn + fp + smooth)


def dice_loss(logits, one_hot_labels, beta=1.0, smooth=1e-5,
              sample_weights=None):
    """Soft dice (``Dice_loss``, deeplabv3_training.py:38-56) over one-hot
    targets with ``num_classes + 1`` channels; the trailing ignore channel
    is dropped from tp/fn."""
    b, c = logits.shape[0], logits.shape[-1]
    probs = torch.softmax(logits.to(torch.float32), dim=-1).reshape(b, -1, c)
    target = one_hot_labels.to(torch.float32).reshape(
        b, -1, one_hot_labels.shape[-1])
    if sample_weights is not None:
        rw = _row_weights(sample_weights, 3, probs.device)
        probs, target = probs * rw, target * rw
    return 1.0 - torch.mean(_score(*_dice_terms(probs, target), beta,
                                   smooth))


def f_score(logits, one_hot_labels, beta=1.0, smooth=1e-5, threshold=0.5,
            sample_weights=None):
    """Thresholded dice coefficient monitor (utils_metrics.py:13-35)."""
    b, c = logits.shape[0], logits.shape[-1]
    probs = torch.softmax(logits.to(torch.float32), dim=-1).reshape(b, -1, c)
    probs = (probs > threshold).to(torch.float32)
    target = one_hot_labels.to(torch.float32).reshape(
        b, -1, one_hot_labels.shape[-1])
    if sample_weights is not None:
        rw = _row_weights(sample_weights, 3, probs.device)
        probs, target = probs * rw, target * rw
    return torch.mean(_score(*_dice_terms(probs, target), beta, smooth))


def seg_loss_bundle(logits, labels, class_weights=None, num_classes=None, *,
                    focal=True, alpha=0.5, gamma=2.0, dice=True, beta=1.0,
                    smooth=1e-5, threshold=0.5, sample_weights=None,
                    resize_to=None, align_corners=True, return_preds=False,
                    data=None):
    """(focal-or-CE [+ dice], f_score) in class-major layout: the
    composition of :func:`focal_loss` / :func:`cross_entropy_loss`,
    :func:`dice_loss` and :func:`f_score` with one shared softmax and
    one-hot, every intermediate ``(C, B, HW)``.

    ``resize_to=(H, W)``: the model's final x4 bilinear upsample
    (``align_corners=True``) done here, in class-major layout, on the
    quarter-resolution logits of ``DeepLab(x, resize_logits=False)``.
    Returns ``(total, main, f_score)`` (``total = main [+ dice]``), and the
    (B, H, W) int64 argmax with ``return_preds``.  ``data``: the batch sums
    span that data axis's ranks (:func:`global_sums`).
    """
    if num_classes is None:
        num_classes = logits.shape[-1]
    nc = num_classes
    b = logits.shape[0]
    lt = logits.to(torch.float32).movedim(-1, 0)             # (C, B, h, w)
    if resize_to is not None and tuple(resize_to) != tuple(logits.shape[1:3]):
        h, w = logits.shape[1], logits.shape[2]
        oh, ow = resize_to
        wh = _interp_tensor(h, oh, align_corners, lt.device, torch.float32)
        ww = _interp_tensor(w, ow, align_corners, lt.device, torch.float32)
        lt = torch.einsum("oh,cbhw->cbow", wh, lt)
        lt = torch.einsum("pw,cbow->cbop", ww, lt)
        out_hw = (oh, ow)
    else:
        out_hw = tuple(logits.shape[1:3])
    n = out_hw[0] * out_hw[1]
    lt = lt.reshape(nc, b, n)
    lab = labels.reshape(b, n).long()
    valid = lab < nc
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    eqf = (safe[None] == torch.arange(nc, device=lt.device)[:, None, None]
           ).to(torch.float32)
    logp = torch.log_softmax(lt, dim=0)
    nll = -torch.sum(logp * eqf, dim=0)
    if class_weights is None:
        wy = valid.to(torch.float32)
    else:
        w = torch.as_tensor(class_weights, dtype=torch.float32,
                            device=lt.device)
        wy = torch.where(valid, torch.sum(w[:, None, None] * eqf, dim=0),
                         torch.zeros_like(nll))
    wnll = nll * wy

    rw = None
    if sample_weights is not None:
        rw = torch.as_tensor(sample_weights, dtype=torch.float32,
                             device=lt.device)[:, None]       # (B, 1)
    if focal:
        f = (1.0 - torch.exp(-wnll)) ** gamma * alpha * wnll
        num = torch.sum(f) if rw is None else torch.sum(f * rw)
        den = (torch.full((), float(f.numel()), device=f.device)
               if rw is None else torch.sum(rw) * n)
    elif rw is None:
        num, den = torch.sum(wnll), torch.sum(wy)
    else:
        num, den = torch.sum(wnll * rw), torch.sum(wy * rw)

    probs_raw = torch.softmax(lt, dim=0)                      # (C, B, HW)
    tgt = eqf * valid[None].to(torch.float32)   # == one_hot[..., :nc]
    probs = probs_raw
    # f_score thresholds the raw probabilities, then applies row weights
    pb = (probs_raw > threshold).to(torch.float32)
    if rw is not None:
        probs, tgt, pb = probs * rw[None], tgt * rw[None], pb * rw[None]
    tp = torch.sum(tgt * probs, dim=(1, 2)) if dice else probs.new_zeros(nc)
    sp = torch.sum(probs, dim=(1, 2)) if dice else probs.new_zeros(nc)
    num, den, tp, sp, st, tp2, spb = global_sums(
        data, num, den, tp, sp, torch.sum(tgt, dim=(1, 2)),
        torch.sum(tgt * pb, dim=(1, 2)), torch.sum(pb, dim=(1, 2)))
    main = num / torch.clamp(den, min=1e-12)
    total = main
    if dice:
        total = total + (1.0 - torch.mean(_score(tp, sp - tp, st - tp, beta,
                                                 smooth)))
    fs = torch.mean(_score(tp2, spb - tp2, st - tp2, beta, smooth))
    if return_preds:
        preds = torch.argmax(lt, dim=0).reshape((b,) + out_hw)
        return total, main, fs, preds
    return total, main, fs


# ---------------------------------------------------------------------------
# Fusion classifier (my_train(full).py:202,253,318-341)
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits, labels, weights=None, data=None):
    """Mean CE over a batch of class logits (``nn.CrossEntropyLoss()``,
    my_train(full).py:202,318-322).  ``weights``: optional (B,) per-sample
    weights, a weighted mean over nonzero-weight rows (weight-0 rows pad a
    ragged micro-batch to the full shape).  ``data``: the mean spans that
    data axis's ranks."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    eq = (labels.long()[..., None] == torch.arange(
        logp.shape[-1], device=logp.device)).to(torch.float32)
    nll = -torch.sum(logp * eq, dim=-1)
    w = (torch.ones_like(nll) if weights is None
         else weights.to(torch.float32))
    num, den = global_sums(data, torch.sum(nll * w), torch.sum(w))
    return num / torch.clamp(den, min=1.0)


def masked_mae_mse(mae_out, mae_labels, token_mask, data=None):
    """MSE between reconstructed and target modality tokens over the masked
    slots (``mes_loss_of_mae(fea_dict['mae_out'][mask[0]], ...)``,
    my_train(full).py:253): a mean over the masked ``(num_masked, D)``
    elements.  ``token_mask`` (..., T) bool; ``data``: the mean spans that
    data axis's ranks."""
    mae_out = mae_out.to(torch.float32)
    mae_labels = mae_labels.to(torch.float32)
    m = token_mask[..., None].to(torch.float32)
    se, count = global_sums(data, torch.sum((mae_out - mae_labels) ** 2 * m),
                              torch.sum(m) * mae_out.shape[-1])
    return se / torch.clamp(count, min=1.0)


def fusion_multihead_loss(logits_dict, labels, head_weights=None,
                          mae_mse=None, mse_factor=5.0, num_micro_batches=1,
                          sample_weights=None, data=None):
    """Weighted multi-head CE sum + the MAE-MSE auxiliary term
    (my_train(full).py:325-341): fused head 1.0, image heads 0.3, cli 0.2;
    ``mae_mse`` (already scaled by ``mse_loss_of_mae_factor``) divided by
    ``num_micro_batches`` and by ``mse_factor``.  Returns (total, parts).
    ``data``: the means span that data axis's ranks."""
    default_w = {"all": 1.0, "imgN": 0.3, "imgA": 0.3, "imgL": 0.3, "cli": 0.2}
    if head_weights:
        default_w.update(head_weights)
    total = 0.0
    parts = {}
    for name, logits in logits_dict.items():
        ce = softmax_cross_entropy(logits, labels, sample_weights, data)
        parts[name] = ce
        total = total + default_w[name] * ce
    if mae_mse is not None:
        aux = mae_mse / num_micro_batches / mse_factor
        parts["mae_mse"] = aux
        total = total + aux
    return total, parts
