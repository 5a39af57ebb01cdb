"""Host-to-device feed: weight-0 padding of ragged batches, each rank's
share of a global batch, and uploads from pinned memory ahead of use —
port of ``cervical_tpu/data/pipeline.py`` (reference: ``DataLoader(
pin_memory=True)`` + the per-rank ``DistributedSampler``, train.py:
496-512).  Under a mesh every rank runs the same seeded loader over the
global batches and keeps its rows of each.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from cervical_tpu_torch.parallel import mesh as P


def host_local_batches(loader: Iterable, divisor: int = 1,
                       with_weights: bool = False, mesh=None) -> Iterator:
    """Pad each batch by repeating its last row up to a multiple of
    ``divisor`` times the data axis's ranks, then yield this rank's rows
    (:func:`~cervical_tpu_torch.parallel.mesh.local_batch_slice`).  With
    ``with_weights`` append a (B,) float32 vector that is 0 on the padded
    rows: the eval steps pass it as ``sample_weights``, so padded rows
    count in no loss and no confusion cell, and no row is dropped."""
    ranks = 1 if mesh is None else P.axis(mesh, "data").size
    div = divisor * ranks
    for batch in loader:
        batch = tuple(batch)
        n = len(batch[0])
        pad = (-n) % div
        weights = np.ones(n + pad, np.float32)
        if pad:
            batch = tuple(np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
                          for x in batch)
            weights[n:] = 0.0
        if with_weights:
            batch = batch + (weights,)
        if mesh is not None:
            sl = P.local_batch_slice(n + pad, mesh)
            batch = tuple(x[sl] for x in batch)
        yield batch


def device_prefetch(loader: Iterable, device, depth: int = 2,
                    with_weights: bool = False, divisor: int = 1,
                    group: int = 1, mesh=None) -> Iterator:
    """Batches of ``loader`` as tensors on ``device``: a thread reads (and,
    for a CUDA device, pins) up to ``depth`` host batches ahead, the caller's
    thread enqueues each upload just before it is used.  Padding, weights
    and, under ``mesh``, this rank's rows as :func:`host_local_batches`.
    A loader's exception is raised here.

    ``group`` > 1 stacks that many consecutive batches into (K, B, ...)
    arrays, uploaded with one pinned copy each, for the trainer's K-step
    calls; a ragged tail of fewer than ``group`` batches arrives as plain
    (B, ...) batches (tell them apart by ``ndim``)."""
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()
    err: list = []

    def pin(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if device.type == "cuda" else t

    def producer():
        try:
            pending = []
            for batch in host_local_batches(loader, divisor, with_weights,
                                            mesh):
                if stop.is_set():
                    return
                if group <= 1:
                    q.put(tuple(pin(a) for a in batch))
                    continue
                pending.append(batch)
                if len(pending) == group:
                    q.put(tuple(pin(np.stack(xs)) for xs in zip(*pending)))
                    pending = []
            for batch in pending:  # the ragged tail: single batches
                q.put(tuple(pin(a) for a in batch))
        except Exception as e:  # delivered to the consumer below
            err.append(e)
        finally:
            q.put(done)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            yield tuple(t.to(device, non_blocking=True) for t in item)
    finally:
        stop.set()
        while thread.is_alive():  # unblock a producer parked on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                thread.join(timeout=0.01)
