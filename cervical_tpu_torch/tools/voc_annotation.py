"""VOC split generation and label audit — the port's copy of
``cervical_tpu/tools/voc_annotation.py``.

Reference: ``Segmentation/deeplabv3+/voc_annotation.py`` — writes
trainval/train/val(/test) txts from the SegmentationClass folder (9:1 by
default, :14-63) and audits the label PNGs' pixel-value histogram to catch
0/255 binary-mask mistakes (:65-98).
"""

from __future__ import annotations

import os
import random
from typing import Tuple

import numpy as np
from PIL import Image


def generate_splits(voc_root: str, trainval_percent=1.0, train_percent=0.9,
                    seed: int = 0):
    """Write ImageSets/Segmentation/{trainval,train,val,test}.txt
    (voc_annotation.py:14-63)."""
    seg_dir = os.path.join(voc_root, "VOC2007", "SegmentationClass")
    sets_dir = os.path.join(voc_root, "VOC2007", "ImageSets", "Segmentation")
    os.makedirs(sets_dir, exist_ok=True)
    ids = [f[:-4] for f in sorted(os.listdir(seg_dir)) if f.endswith(".png")]
    rng = random.Random(seed)
    n = len(ids)
    tv = rng.sample(range(n), int(n * trainval_percent))
    tr = set(rng.sample(tv, int(len(tv) * train_percent)))
    tv_set = set(tv)
    files = {
        "trainval": [ids[i] for i in sorted(tv)],
        "train": [ids[i] for i in sorted(tr)],
        "val": [ids[i] for i in sorted(tv_set - tr)],
        "test": [ids[i] for i in range(n) if i not in tv_set],
    }
    for name, id_list in files.items():
        with open(os.path.join(sets_dir, name + ".txt"), "w") as f:
            f.write("\n".join(id_list) + ("\n" if id_list else ""))
    return files


def audit_labels(voc_root: str, num_classes: int = 5) -> Tuple[np.ndarray, list]:
    """Pixel-value histogram over all label PNGs + format warnings
    (voc_annotation.py:65-98)."""
    seg_dir = os.path.join(voc_root, "VOC2007", "SegmentationClass")
    counts = np.zeros(256, np.int64)
    warnings = []
    for fn in sorted(os.listdir(seg_dir)):
        if not fn.endswith(".png"):
            continue
        arr = np.array(Image.open(os.path.join(seg_dir, fn)))
        if arr.ndim > 2:
            warnings.append(f"{fn}: label is not single-channel")
            arr = arr[..., 0]
        counts += np.bincount(arr.reshape(-1), minlength=256)
    occupied = np.nonzero(counts)[0]
    if set(occupied.tolist()) <= {0, 255}:
        warnings.append(
            "labels contain only 0 and 255 — looks like a binary mask; "
            "convert to class ids (0..num_classes-1) before training")
    if occupied.size and occupied.max() >= num_classes and occupied.max() != 255:
        warnings.append(
            f"label values above num_classes-1 found: {occupied.tolist()}")
    return counts, warnings
