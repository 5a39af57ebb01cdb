"""Dataset-level segmentation evaluation: mIoU and the multi-label view —
port of ``cervical_tpu/inference/evaluator.py``.

Combines the confusion-matrix evaluation of ``get_miou.py`` /
``compute_mIoU`` with the README.md:13 *multi-label* view of the
segmentation output (per-image presence of each lesion class: subset
accuracy, accuracy, precision, recall, F1, Hamming loss).  Host-side numpy
on the port's own ``metrics`` copy.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from cervical_tpu_torch import metrics as M


def presence_sets(mask: np.ndarray, num_classes: int,
                  min_pixels: int = 1) -> np.ndarray:
    """(num_classes - 1,) bool: which foreground classes appear in a mask."""
    counts = np.bincount(np.asarray(mask).reshape(-1), minlength=num_classes)
    return counts[1:num_classes] >= min_pixels


def print_summary(s: Dict, log=print):
    """The reference's per-class and mean lines (``get_miou.py``) of a
    ``summarize_hist`` dict."""
    for i, name in enumerate(s["names"]):
        log(f"===> {name}:\tIou-{s['iou'][i] * 100:.2f}; "
            f"Recall (equal to the PA)-{s['recall'][i] * 100:.2f}; "
            f"Precision-{s['precision'][i] * 100:.2f}")
    log(f"===> mIoU: {s['miou'] * 100:.2f}; mPA: {s['mpa'] * 100:.2f}; "
        f"Accuracy: {s['accuracy'] * 100:.2f}")


class SegEvaluator:
    """Accumulate per-image predictions into pixel and multi-label
    metrics."""

    def __init__(self, num_classes: int = 5,
                 name_classes: Optional[Sequence[str]] = None,
                 min_pixels: int = 1):
        self.num_classes = num_classes
        self.names = tuple(name_classes or
                           M.DEFAULT_SEG_CLASS_NAMES[:num_classes])
        self.min_pixels = min_pixels
        self.hist = np.zeros((num_classes, num_classes), np.int64)
        self.true_sets = []
        self.pred_sets = []

    def add(self, gt_mask: np.ndarray, pred_mask: np.ndarray):
        self.hist += M.fast_hist(gt_mask, pred_mask, self.num_classes)
        self.true_sets.append(presence_sets(gt_mask, self.num_classes,
                                            self.min_pixels))
        self.pred_sets.append(presence_sets(pred_mask, self.num_classes,
                                            self.min_pixels))

    def add_batch(self, gt_masks, pred_masks):
        for g, p in zip(gt_masks, pred_masks):
            self.add(np.asarray(g), np.asarray(p))

    def summary(self) -> Dict:
        out = M.summarize_hist(self.hist, self.names)
        if self.true_sets:
            out["multilabel"] = M.multilabel_report(
                np.stack(self.true_sets), np.stack(self.pred_sets),
                self.num_classes - 1)
        return out

    def report(self, log=print):
        s = self.summary()
        print_summary(s, log)
        if "multilabel" in s:
            ml = s["multilabel"]
            log("multi-label: subset-acc {:.3f} acc {:.3f} precision {:.3f} "
                "recall {:.3f} f1 {:.3f} hamming {:.3f}".format(
                    ml["subset_accuracy"], ml["accuracy"], ml["precision"],
                    ml["recall"], ml["f1"], ml["hamming"]))
        return s
