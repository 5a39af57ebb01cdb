"""VOC-layout segmentation data: split files, decode-and-stage datasets,
the shuffled batch loader, a synthetic dataset writer — the port's own copy
of ``cervical_tpu/data/voc.py`` (reference:
``Segmentation/deeplabv3+/utils/dataloader.py`` and ``train.py:396-399``).

The host only decodes and stages fixed-shape uint8 arrays; all
augmentation runs batched on the card (``ops/warp.py``).  A batch is
decoded by the native threaded loader (``cervical_tpu_torch.native``)
where its library builds, else image by image with PIL, imported where a
file is read.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
import warnings
from typing import List, Sequence, Tuple

import numpy as np


def read_split(dataset_path: str, split: str) -> List[str]:
    """Read image ids from ``VOC2007/ImageSets/Segmentation/{split}.txt``."""
    p = os.path.join(dataset_path, "VOC2007", "ImageSets", "Segmentation",
                     f"{split}.txt")
    with open(p) as f:
        return [line.strip().split()[0] for line in f if line.strip()]


def cvt_rgb(img):
    """Coerce a PIL image to 3-channel RGB (``cvtColor``,
    utils/utils.py:11-16)."""
    if img.mode == "RGB":
        return img
    return img.convert("RGB")


class VOCSegDataset:
    """Decode-and-stage dataset over a VOC2007 layout, every image staged
    at ``stage_hw`` (a plain resize: exact for this dataset's native 512x512
    images) so each batch has one shape.

    ``use_native``: :meth:`load_batch` decodes with the native loader when
    its library is available and falls back to PIL, as the JAX package
    does, when it is not (``native.unavailable_reason()`` says why) or when
    a batch reports failures.  ``batches`` counts the batches each decoder
    delivered (``{"native": n, "pil": m}``), so a caller can tell which
    ran."""

    def __init__(self, dataset_path: str, ids: Sequence[str],
                 stage_hw: Tuple[int, int] = (512, 512),
                 use_native: bool = True):
        self.dataset_path = dataset_path
        self.ids = list(ids)
        self.stage_hw = stage_hw
        self.use_native = use_native
        self.batches = {"native": 0, "pil": 0}
        self._count_lock = threading.Lock()
        self._check_stage_aspect()

    def _check_stage_aspect(self):
        """Warn once if the first image's aspect differs from ``stage_hw``:
        staging would stretch where the reference letterboxes at eval."""
        if not self.ids:
            return
        from PIL import Image
        try:
            with Image.open(self.paths(0)[0]) as im:
                sw, sh = im.size
        except OSError:
            return
        h, w = self.stage_hw
        if sh * w != sw * h:
            warnings.warn(
                f"VOCSegDataset: source aspect {sw}x{sh} != stage {w}x{h}; "
                "staging stretches (the reference letterboxes only at "
                "eval/predict).", stacklevel=3)

    def __len__(self):
        return len(self.ids)

    def paths(self, idx: int) -> Tuple[str, str]:
        name = self.ids[idx]
        return (os.path.join(self.dataset_path, "VOC2007", "JPEGImages",
                             name + ".jpg"),
                os.path.join(self.dataset_path, "VOC2007",
                             "SegmentationClass", name + ".png"))

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        from PIL import Image
        jpg_path, png_path = self.paths(idx)
        with Image.open(jpg_path) as jpg, Image.open(png_path) as png:
            jpg = cvt_rgb(jpg)
            h, w = self.stage_hw
            if jpg.size != (w, h):
                jpg = jpg.resize((w, h), Image.BILINEAR)
            if png.size != (w, h):
                png = png.resize((w, h), Image.NEAREST)
            return np.asarray(jpg, np.uint8), np.asarray(png, np.uint8)

    def load_batch(self, idxs) -> Tuple[np.ndarray, np.ndarray]:
        """Decode a whole batch: (N, H, W, 3) and (N, H, W) uint8."""
        if self.use_native:
            from cervical_tpu_torch import native
            if native.available():
                jpgs, pngs = zip(*(self.paths(int(i)) for i in idxs))
                imgs, lbls, failures = native.load_batch(
                    list(jpgs), list(pngs), self.stage_hw)
                if failures == 0:
                    self._count("native")
                    return imgs, lbls
        h, w = self.stage_hw
        imgs = np.empty((len(idxs), h, w, 3), np.uint8)
        lbls = np.empty((len(idxs), h, w), np.uint8)
        for j, i in enumerate(idxs):
            imgs[j], lbls[j] = self.load(int(i))
        self._count("pil")
        return imgs, lbls

    def _count(self, decoder: str):
        with self._count_lock:  # BatchLoader's workers decode in threads
            self.batches[decoder] += 1


class ArraySegDataset:
    """In-memory dataset over (N, H, W, 3) / (N, H, W) uint8 arrays with
    the loader surface (``__len__``/``load``/``load_batch``)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        if len(images) != len(labels):
            raise ValueError("images/labels length mismatch")
        self.images = np.asarray(images, np.uint8)
        self.labels = np.asarray(labels, np.uint8)

    def __len__(self):
        return len(self.images)

    def load(self, idx: int):
        return self.images[idx], self.labels[idx]

    def load_batch(self, idxs):
        idxs = np.asarray(idxs)
        return self.images[idxs], self.labels[idxs]

    def paths(self, idx: int):
        raise NotImplementedError(
            "ArraySegDataset has no backing files (file-path consumers "
            "like PredictorMiouCallback need a disk dataset)")


class BatchLoader:
    """Shuffled batch iterator with background decode threads
    (``DataLoader(num_workers=4, drop_last=...)``, train.py:507-512).

    Worker ``w`` produces batches ``w, w+W, ...`` into per-batch slots, so
    batches arrive in order; each worker runs at most 2 batches ahead of
    what was consumed of its own, and a worker's exception is re-raised in
    the consumer.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 11, num_workers: int = 4, drop_last: bool = True):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> List[np.ndarray]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(order)
        return [order[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(self))]

    def __iter__(self):
        batches = self._batches()
        load_batch = self.ds.load_batch
        if self.num_workers <= 1:
            for idxs in batches:
                yield load_batch(idxs)
            return
        stop = threading.Event()
        slots = [queue_mod.Queue(maxsize=1) for _ in batches]
        budgets = [threading.Semaphore(2) for _ in range(self.num_workers)]

        def worker(wid):
            for bi in range(wid, len(batches), self.num_workers):
                budgets[wid].acquire()
                if stop.is_set():
                    return
                try:
                    slots[bi].put(load_batch(batches[bi]))
                except Exception as e:  # delivered to the consumer
                    slots[bi].put(e)
                    return

        for wid in range(self.num_workers):
            threading.Thread(target=worker, args=(wid,), daemon=True).start()
        try:
            for bi in range(len(batches)):
                item = slots[bi].get()
                budgets[bi % self.num_workers].release()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            for b in budgets:  # unblock workers parked on their budget
                b.release()


def make_synthetic_voc(root: str, num_images: int = 16, size: int = 64,
                       num_classes: int = 5, seed: int = 0,
                       splits=(0.8, 0.1, 0.1)):
    """Write a synthetic VOC2007-layout dataset of colored blobs whose mask
    is recoverable from the image.  Returns the dataset root."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    jdir = os.path.join(root, "VOC2007", "JPEGImages")
    sdir = os.path.join(root, "VOC2007", "SegmentationClass")
    idir = os.path.join(root, "VOC2007", "ImageSets", "Segmentation")
    for d in (jdir, sdir, idir):
        os.makedirs(d, exist_ok=True)
    palette = np.array([[0, 0, 0], [255, 255, 0], [255, 0, 0],
                        [0, 255, 0], [0, 0, 255]], np.uint8)[:num_classes]
    ids = []
    for i in range(num_images):
        mask = np.zeros((size, size), np.uint8)
        for c in range(1, num_classes):
            if rng.random() < 0.7:
                cy, cx = rng.integers(8, size - 8, 2)
                r = int(rng.integers(4, size // 4))
                yy, xx = np.ogrid[:size, :size]
                mask[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = c
        img = palette[mask] + rng.integers(-20, 20, (size, size, 3))
        img = np.clip(img, 0, 255).astype(np.uint8)
        name = f"{i:06d}"
        Image.fromarray(img).save(os.path.join(jdir, name + ".jpg"), quality=95)
        Image.fromarray(mask).save(os.path.join(sdir, name + ".png"))
        ids.append(name)
    n_train = int(num_images * splits[0])
    n_val = max(1, int(num_images * splits[1]))
    parts = {
        "train": ids[:n_train],
        "val": ids[n_train:n_train + n_val],
        "test": ids[n_train + n_val:] or ids[-1:],
        "trainval": ids[:n_train + n_val],
    }
    for split, split_ids in parts.items():
        with open(os.path.join(idir, split + ".txt"), "w") as f:
            f.write("\n".join(split_ids) + "\n")
    return root
