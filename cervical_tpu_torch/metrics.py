"""Segmentation metrics (numpy, host-side) — the port's own copy of the
confusion-matrix half of ``cervical_tpu/metrics.py``
(``utils_metrics.py:38-193`` of the reference)."""

from __future__ import annotations

import numpy as np


def fast_hist(label, pred, num_classes):
    """Confusion matrix via bincount (utils_metrics.py:38-47)."""
    label = np.asarray(label).reshape(-1)
    pred = np.asarray(pred).reshape(-1)
    k = (label >= 0) & (label < num_classes)
    return np.bincount(
        num_classes * label[k].astype(int) + pred[k], minlength=num_classes**2
    ).reshape(num_classes, num_classes)


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
