"""Metrics — the port's own copy of ``cervical_tpu/metrics.py``: the
segmentation half (``utils_metrics.py:38-193`` of the reference; numpy on
the host, and :func:`confusion_matrix` on the device for the eval step),
the fusion classifier's metric block (my_train(full).py:144-171,386-408)
and the multi-label report with its bar charts and CSV dumps."""

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


# ---------------------------------------------------------------------------
# Classification metrics (fusion model)
# ---------------------------------------------------------------------------

def classification_report(true_labels, pred_labels, num_classes=4):
    """Accuracy, per-class precision/recall/F1, confusion, FP/FN/TP/TN
    (my_train(full).py:144-171; ``average=None``: per-class arrays, 0 where
    the denominator is 0)."""
    true_labels = np.asarray(true_labels, int).reshape(-1)
    pred_labels = np.asarray(pred_labels, int).reshape(-1)
    cm = fast_hist(true_labels, pred_labels, num_classes)
    rep = report_from_confusion(cm)
    rep["accuracy"] = (float(np.mean(true_labels == pred_labels))
                       if len(true_labels) else 0.0)
    return rep


def report_from_confusion(cm):
    """The :func:`classification_report` block from a (possibly
    fold-summed) confusion matrix; accuracy is its trace ratio."""
    cm = np.asarray(cm)
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    tn = cm.sum() - (fp + fn + tp)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
        recall = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
        f1_den = precision + recall
        f1 = np.where(f1_den > 0,
                      2 * precision * recall / np.maximum(f1_den, 1e-12), 0.0)
        sensitivity = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
        specificity = np.where(tn + fp > 0, tn / np.maximum(tn + fp, 1), 0.0)
    return {
        "accuracy": float(tp.sum() / cm.sum()) if cm.sum() else 0.0,
        "confusion": cm,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "fp": fp,
        "fn": fn,
        "tp": tp,
        "tn": tn,
        "sensitivity": sensitivity,
        "specificity": specificity,
    }


def accuracy(true_labels, pred_labels):
    true_labels = np.asarray(true_labels).reshape(-1)
    pred_labels = np.asarray(pred_labels).reshape(-1)
    if len(true_labels) == 0:
        return 0.0
    return float(np.mean(true_labels == pred_labels))


def multilabel_report(true_sets, pred_sets, num_labels=4):
    """Multi-label metrics over per-image lesion-presence sets (README.md:13
    of the reference): ``true_sets``/``pred_sets`` (N, num_labels) binary.
    Subset and elementwise accuracy, micro precision/recall/F1, Hamming
    loss."""
    t = np.asarray(true_sets, bool)
    p = np.asarray(pred_sets, bool)
    if t.shape != p.shape:
        raise ValueError(f"shapes differ: {t.shape} vs {p.shape}")
    subset_acc = float(np.mean(np.all(t == p, axis=1))) if len(t) else 0.0
    elem_acc = float(np.mean(t == p)) if t.size else 0.0
    tp = float(np.sum(t & p))
    fp = float(np.sum(~t & p))
    fn = float(np.sum(t & ~p))
    precision = tp / max(tp + fp, 1.0)
    recall = tp / max(tp + fn, 1.0)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    hamming = float(np.mean(t != p)) if t.size else 0.0
    return {
        "subset_accuracy": subset_acc,
        "accuracy": elem_acc,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "hamming": hamming,
    }


def draw_bar_chart(values, names, title, xlabel, path):
    """One horizontal per-class bar chart (draw_plot_func,
    utils_metrics.py:204-224); False, with no file, where matplotlib is
    missing."""
    from cervical_tpu_torch.train.callbacks import _pyplot
    plt = _pyplot()
    if plt is None:
        return False
    plt.figure()
    plt.barh(range(len(values)), values, color="royalblue")
    plt.title(title)
    plt.xlabel(xlabel)
    plt.yticks(range(len(values)), names)
    for i, val in enumerate(values):
        plt.text(val, i, f" {val:.2f}", va="center", fontweight="bold",
                 color="royalblue")
    plt.tight_layout()
    plt.savefig(path)
    plt.close()
    return True


def write_classification_report(report, out_dir, class_names=None):
    """``confusion_matrix.csv``, ``classification_report.csv`` and
    per-class Precision/Recall/F1 bar charts of a
    :func:`classification_report` / :func:`report_from_confusion` dict
    (the classification analog of ``show_results``,
    utils_metrics.py:226-250)."""
    import csv
    import os

    os.makedirs(out_dir, exist_ok=True)
    cm = np.asarray(report["confusion"])
    n = cm.shape[0]
    names = list(class_names or [f"class{i}" for i in range(n)])

    with open(os.path.join(out_dir, "confusion_matrix.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow([" "] + [str(c) for c in names])
        for i in range(n):
            w.writerow([names[i]] + [str(int(x)) for x in cm[i]])

    with open(os.path.join(out_dir, "classification_report.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(["class", "precision", "recall", "f1", "sensitivity",
                    "specificity", "tp", "fp", "fn", "tn"])
        for i in range(n):
            w.writerow([names[i]] + [
                f"{report[k][i]:.6f}" for k in
                ("precision", "recall", "f1", "sensitivity", "specificity")]
                + [str(int(report[k][i])) for k in ("tp", "fp", "fn", "tn")])
        w.writerow(["accuracy", f"{report['accuracy']:.6f}"])

    for key, fname, xlabel in (("precision", "Precision.png", "Precision"),
                               ("recall", "Recall.png", "Recall"),
                               ("f1", "F1.png", "F1 score")):
        vals = np.asarray(report[key], np.float64)
        draw_bar_chart(vals, names,
                       f"m{xlabel} = {np.nanmean(vals) * 100:.2f}%",
                       xlabel, os.path.join(out_dir, fname))
