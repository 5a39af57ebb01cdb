"""One traced window of a run: ``torch.profiler`` on the CPU and the card,
read from the profiler's raw events (no table is built, so a window of a
few hundred thousand kernels reads in seconds).

The window is the ``bench.window`` span that the runners open around the
traced work.  From it come the device's busy time (the union of kernel,
copy and set intervals, so overlapping streams count once), the top
device operations, the idle gaps named by the innermost host operation
open when each began, the copies by direction, and per named span the
device time of every operation launched inside it.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Tuple

from benchmarks.harness import stats

WINDOW = "bench.window"


def _is_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def _is_annotation(ev) -> bool:
    """A ``record_function`` span (the profiler mirrors each onto the
    card's timeline, over the work launched inside it)."""
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if flag is not None else ev.name().startswith("bench.")


def _device_kind(ev) -> str:
    """memcpy, memset or kernel, by the record's name (CUPTI names copies
    "Memcpy ..." and sets "Memset ...")."""
    name = ev.name().lower()
    for k in ("memcpy", "memset"):
        if name.startswith(k):
            return k
    return "kernel"


class Tracer:
    """``with Tracer(torch) as t: ...`` profiles the block; ``t.window()``
    opens the window span inside it.  :meth:`summary` reads the events."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None

    def __enter__(self):
        tp = self.torch.profiler
        self.prof = tp.profile(activities=[tp.ProfilerActivity.CPU,
                                           tp.ProfilerActivity.CUDA],
                               record_shapes=False, with_stack=False,
                               acc_events=False)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def window(self):
        return self.torch.profiler.record_function(WINDOW)

    def summary(self, spans=()) -> "Summary":
        return Summary(self.prof.profiler.kineto_results.events(), spans)


class Summary:
    """What one traced window shows; times in seconds."""

    def __init__(self, events, spans=()):
        host, device = [], []
        for ev in events:
            (device if _is_device(ev) else host).append(ev)
        windows = [e for e in host if e.name() == WINDOW]
        if not windows:
            raise RuntimeError("the trace holds no bench.window span")
        w = windows[0]
        lo, hi = w.start_ns(), w.end_ns()
        self.window_s = (hi - lo) * 1e-9
        names = {e.name() for e in host if _is_annotation(e)} | {WINDOW}
        marks = collections.defaultdict(list)  # span name -> card intervals
        dev = []
        for ev in device:
            if ev.name() in names:
                marks[ev.name()].append((ev.start_ns(), ev.end_ns()))
            else:
                dev.append((ev, _device_kind(ev), ev.start_ns(), ev.end_ns()))
        inside = [(ev, kind, max(a, lo), min(b, hi)) for ev, kind, a, b in dev
                  if min(b, hi) > max(a, lo)]
        busy = stats.union((a, b) for _, _, a, b in inside)
        self.busy_s = sum(b - a for a, b in busy) * 1e-9
        self.device_events = len(inside)

        by_name: Dict[str, float] = collections.Counter()
        copies: Dict[str, float] = collections.Counter()
        for ev, kind, a, b in inside:
            by_name[ev.name()] += (b - a) * 1e-9
            if kind == "memcpy":
                copies[_copy_direction(ev.name())] += (b - a) * 1e-9
        self.device_ops = _top(by_name)
        self.copy_s = dict(copies)

        # idle gaps, named by the innermost host event open when each began
        opened = sorted((e.start_ns(), e.end_ns(), e.name()) for e in host
                        if e.name() != WINDOW)
        starts = [a for a, _, _ in opened]
        idle: Dict[str, float] = collections.Counter()
        for a, b in stats.gaps(busy, lo, hi):
            idle[_innermost(opened, starts, a)] += (b - a) * 1e-9
        self.idle_gaps = _top(idle)

        # per span name: the card's busy time inside the span's mirror on
        # the card's timeline, which runs from the first to the last
        # operation launched inside the span
        self.span_device_s: Dict[str, float] = {}
        self.span_count: Dict[str, int] = {}
        for name in spans:
            self.span_count[name] = sum(1 for e in host if e.name() == name
                                        and lo <= e.start_ns() <= hi)
            on_card = [(max(a, lo), min(b, hi)) for a, b in marks[name]
                       if min(b, hi) > max(a, lo)]
            if self.span_count[name] and on_card:
                self.span_device_s[name] = sum(
                    stats.covered(stats.clip(busy, a, b))
                    for a, b in stats.union(on_card)) * 1e-9

    def breakdown(self):
        return {"device_ops": self.device_ops, "idle_gaps": self.idle_gaps}


def _copy_direction(name: str) -> str:
    n = name.replace(" ", "").lower()
    for d in ("htod", "dtoh", "dtod"):
        if d in n:
            return d
    return "other"


def _innermost(opened: List[Tuple[int, int, str]], starts: List[int],
               t: int) -> str:
    """The latest-starting host event open at ``t``: host events nest, so
    it is the innermost."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if opened[i][1] >= t:
            return opened[i][2]
    return "no host event"


def _top(counter, n: int = 10):
    return [[k, v] for k, v in sorted(counter.items(),
                                      key=lambda kv: -kv[1])[:n]]
