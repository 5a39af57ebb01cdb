"""Profiling and throughput instrumentation — port of
``cervical_tpu/utils/profiling.py``.

The reference's only perf tooling is the wall-clock FPS loop in
``deeplab.py:211-264``.  Here: a ``torch.profiler`` trace around any code
block, written as a Chrome trace (``chrome://tracing`` or Perfetto read it;
no TensorBoard needed), plus steps/s and images/s-per-card counters for
training loops.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Optional


@dataclass
class Trace:
    """What :func:`trace` yields: the running profiler, and the path of the
    Chrome trace once the block has exited (None while it runs, and
    always when tracing is disabled)."""
    profile: object = None
    path: Optional[str] = None


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, enabled: bool = True):
    """Profile the block with ``torch.profiler`` and write
    ``<log_dir>/trace_<pid>_<ns>.json``.  Records CPU activity, and CUDA
    activity (kernels, copies) where a card is present.  ``log_dir``
    defaults to ``$TMPDIR/torch-trace``."""
    handle = Trace()
    if not enabled:
        yield handle
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        handle.profile = prof
        yield handle
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    handle.path = path


def _device_count() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


class ThroughputMeter:
    """Images/sec (total and per card) + steps/sec over a sliding window."""

    def __init__(self, window: int = 50, num_chips: Optional[int] = None):
        self.window = window
        self.num_chips = num_chips or _device_count()
        self.reset()

    def reset(self):
        self._events = []  # (t, n_images)

    def step(self, n_images: int):
        now = time.perf_counter()
        self._events.append((now, n_images))
        if len(self._events) > self.window:
            self._events.pop(0)

    @property
    def images_per_sec(self) -> float:
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        n = sum(x for _, x in self._events[1:])
        return n / max(dt, 1e-9)

    @property
    def images_per_sec_per_chip(self) -> float:
        return self.images_per_sec / max(self.num_chips, 1)

    @property
    def steps_per_sec(self) -> float:
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        return (len(self._events) - 1) / max(dt, 1e-9)

    def summary(self) -> dict:
        return {
            "images_per_sec": round(self.images_per_sec, 2),
            "images_per_sec_per_chip": round(self.images_per_sec_per_chip, 2),
            "steps_per_sec": round(self.steps_per_sec, 3),
            "num_chips": self.num_chips,
        }
