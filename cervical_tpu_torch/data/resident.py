"""Device-resident dataset: the whole train or val set on the card — port of
``cervical_tpu/data/resident.py``.

The reference set is small for an 80 GB card (6,720 x 512² x 3 uint8 is 5.3
GB), so the resident epoch uploads it once and the trainer's K-step calls
read their batches from device memory: a flat (N, H, W, 3) uint8 image
tensor and (N, H, W) labels.  A call reads batch i as the rows ``[i*B,
(i+1)*B)`` or, in the "gather" shuffle mode, as B rows named by a
host-permuted index.  The batch size is metadata, so the freeze -> unfreeze
rechunk costs nothing.  Eval sets are repeat-padded to whole batches and
carry (N,) 0/1 weights, the contract of ``pipeline.host_local_batches``.

Under a data-parallel mesh every rank holds the whole set on its device,
shuffles it with the shared seeded streams, and its K-step calls read only
its rows of each global batch (``SegTrainer._resident_train``): the rows
the JAX package's ``_flat_sharding`` gives each device of the data axis.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class ResidentSegData:
    """Flat segmentation data on one device.

    ``images`` (N, H, W, 3) uint8, ``labels`` (N, H, W) uint8, ``weights``
    (N,) float32 validity for eval sets (None for train); ``batch_size``,
    how the trainer reads it; ``n``, the real images (after the train
    tail is dropped, before the eval padding)."""

    images: torch.Tensor
    labels: torch.Tensor
    weights: Optional[torch.Tensor]
    batch_size: int
    n: int

    @property
    def num_chunks(self) -> int:
        return self.images.shape[0] // self.batch_size

    def __len__(self):  # loader-compatible: the number of batches
        return self.num_chunks

    @classmethod
    def from_arrays(cls, images: np.ndarray, labels: np.ndarray,
                    batch_size: int, device, train: bool = True
                    ) -> "ResidentSegData":
        """Upload (N, H, W, 3) / (N, H, W) uint8 host arrays to ``device``.
        ``train=True`` drops the ragged tail (``BatchLoader(drop_last=
        True)``); ``train=False`` repeat-pads it to a whole batch and sets
        the padded rows' weights to 0."""
        images = np.asarray(images)
        labels = np.asarray(labels)
        if images.dtype != np.uint8 or labels.dtype != np.uint8:
            raise ValueError("resident data must be uint8")
        n = len(images)
        if train:
            c = n // batch_size
            if c == 0:
                raise ValueError(f"dataset smaller than one batch "
                                 f"({n} < {batch_size})")
            n = c * batch_size
            images, labels, weights = images[:n], labels[:n], None
        else:
            pad = (-n) % batch_size
            if pad:
                images = np.concatenate(
                    [images, np.repeat(images[-1:], pad, axis=0)])
                labels = np.concatenate(
                    [labels, np.repeat(labels[-1:], pad, axis=0)])
            weights = np.ones(n + pad, np.float32)
            weights[n:] = 0.0

        def put(x):  # a copy also on the CPU: shuffle_ writes in place
            return torch.from_numpy(np.ascontiguousarray(x)).to(device,
                                                                copy=True)

        return cls(put(images), put(labels),
                   put(weights) if weights is not None else None,
                   batch_size, n)

    @classmethod
    def from_dataset(cls, dataset, batch_size: int, device,
                     train: bool = True, log=None) -> "ResidentSegData":
        """Upload a ``VOCSegDataset``-like object whole.  An
        ``ArraySegDataset``'s arrays go up as they are; any other dataset
        is first loaded image by image into one host copy.  ``log`` gets
        the set's size and the upload's seconds."""
        from cervical_tpu_torch.data.voc import ArraySegDataset
        if isinstance(dataset, ArraySegDataset):
            images, labels = dataset.images, dataset.labels
        else:
            n = len(dataset)
            im0, lb0 = dataset.load(0)
            images = np.empty((n,) + im0.shape, np.uint8)
            labels = np.empty((n,) + lb0.shape, np.uint8)
            images[0], labels[0] = im0, lb0
            for i in range(1, n):
                images[i], labels[i] = dataset.load(i)
        t0 = time.perf_counter()
        out = cls.from_arrays(images, labels, batch_size, device, train=train)
        if out.images.device.type == "cuda":
            torch.cuda.synchronize(out.images.device)
        if log:
            log(f"resident upload: {len(images)} images, "
                f"{(images.nbytes + labels.nbytes) / 1e9:.2f} GB in "
                f"{time.perf_counter() - t0:.2f} s")
        return out

    def rechunk(self, batch_size: int) -> "ResidentSegData":
        """The same data read at another batch size (the freeze -> unfreeze
        switch): metadata only.  The stored count must divide, so the
        dropped train tail or padded eval tail does not move."""
        total = len(self.images)
        if total % batch_size:
            raise ValueError(f"cannot rechunk {total} resident images "
                             f"to batch {batch_size}")
        return dataclasses.replace(self, batch_size=batch_size)

    @torch.no_grad()
    def shuffle_(self, generator: torch.Generator) -> "ResidentSegData":
        """Permute the train set's images in place (the ``"images"``
        shuffle mode): ``torch.randperm`` from the host ``generator``, one
        index select, the permuted copy written back and freed.  The peak
        is twice the set, as in the JAX package; the buffers keep their
        addresses, which the trainer's captured K-step calls read."""
        if self.weights is not None:
            raise ValueError("shuffle is for train sets (weights=None)")
        perm = torch.randperm(len(self.images), generator=generator)
        perm = perm.to(self.images.device)
        for t in (self.images, self.labels):
            t.copy_(t.index_select(0, perm))
        return self
