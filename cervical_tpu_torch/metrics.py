"""Segmentation metrics — the port's own copy of the confusion-matrix half
of ``cervical_tpu/metrics.py`` (``utils_metrics.py:38-193`` of the
reference): numpy on the host, and :func:`confusion_matrix` on the device
for the eval step."""

from __future__ import annotations

import numpy as np
import torch


def fast_hist(label, pred, num_classes):
    """Confusion matrix via bincount (utils_metrics.py:38-47)."""
    label = np.asarray(label).reshape(-1)
    pred = np.asarray(pred).reshape(-1)
    k = (label >= 0) & (label < num_classes)
    return np.bincount(
        num_classes * label[k].astype(int) + pred[k], minlength=num_classes**2
    ).reshape(num_classes, num_classes)


def confusion_matrix(labels: torch.Tensor, preds: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) int64 confusion matrix on the tensors'
    device, rows ground truth, columns prediction; labels outside
    [0, num_classes) are dropped — :func:`fast_hist` semantics, the
    counterpart of ``confusion_matrix_jax``.  A scatter-add of integer
    counts into a fixed-size histogram: exact, and unlike ``torch.bincount``
    (which reads the input's maximum back to the host) it does not make the
    host wait for the card."""
    labels = labels.reshape(-1).long()
    preds = preds.reshape(-1).long()
    keep = (labels >= 0) & (labels < num_classes)
    # dropped pixels go to one extra bin past the matrix
    idx = torch.where(keep, num_classes * labels + preds,
                      torch.full_like(labels, num_classes * num_classes))
    counts = torch.zeros(num_classes * num_classes + 1, dtype=torch.int64,
                         device=idx.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    return counts[:num_classes * num_classes].reshape(num_classes, num_classes)


def per_class_iu(hist):
    """IoU per class = TP / (TP + FP + FN) (utils_metrics.py:62-63)."""
    hist = np.asarray(hist, np.float64)
    return np.diag(hist) / np.maximum(hist.sum(1) + hist.sum(0) - np.diag(hist), 1)


def per_class_pa_recall(hist):
    """Recall (pixel accuracy) per class = TP / (TP + FN) (utils_metrics.py:84-85)."""
    hist = np.asarray(hist, np.float64)
    return np.diag(hist) / np.maximum(hist.sum(1), 1)


def per_class_precision(hist):
    """Precision per class = TP / (TP + FP) (utils_metrics.py:106-107)."""
    hist = np.asarray(hist, np.float64)
    return np.diag(hist) / np.maximum(hist.sum(0), 1)


def per_accuracy(hist):
    """Overall pixel accuracy (utils_metrics.py:115-116)."""
    hist = np.asarray(hist, np.float64)
    return np.sum(np.diag(hist)) / np.maximum(np.sum(hist), 1)


DEFAULT_SEG_CLASS_NAMES = ("Background", "AW", "Puncation", "Mosaic", "Atypical")


def summarize_hist(hist, name_classes=DEFAULT_SEG_CLASS_NAMES):
    """IoU/Recall/Precision summary dict from an accumulated confusion matrix
    (the in-memory equivalent of ``compute_mIoU``, utils_metrics.py:120-193)."""
    ious = per_class_iu(hist)
    recall = per_class_pa_recall(hist)
    precision = per_class_precision(hist)
    return {
        "hist": np.asarray(hist, int),
        "iou": ious,
        "recall": recall,
        "precision": precision,
        "miou": float(np.nanmean(ious)),
        "mpa": float(np.nanmean(recall)),
        "accuracy": float(per_accuracy(hist)),
        "names": tuple(name_classes),
    }
