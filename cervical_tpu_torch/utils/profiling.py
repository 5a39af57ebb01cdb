"""Profiling: a ``torch.profiler`` trace around any code block, and the
program's own spans inside it — port of ``cervical_tpu/utils/profiling.py``
(whose ``ThroughputMeter`` the port does not carry: nothing reads it).

The reference's only perf tooling is the wall-clock FPS loop in
``deeplab.py:211-264``.  Here :func:`trace` writes a Chrome trace
(``chrome://tracing`` or Perfetto read it; no TensorBoard needed), and
:func:`span` marks the program's layer boundaries in it.

A span is off unless a ``torch.profiler`` session is active in the thread,
the flag ``record_function`` itself consults; off, it costs that check and
nothing else.  On, it records a host event named by the span through the
profiler's fast ``RecordFunction`` (so the span lies in the profiler's
trace on the clock of the card's records), reads the host clock at entry
and exit, and with ``device`` records a timing event pair on the card's
current stream (not while that stream captures a CUDA graph).  The host
event is a plain op, not a ``record_function`` annotation: the profiler
mirrors only annotations onto the card's timeline, each kernel under the
innermost one, so a span leaves an annotation around it (a benchmark's)
its mirror.  Each record keeps the span that opened it and the root span
it runs under (one request, one epoch); :func:`span_totals` resolves
them.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled


class _Off:
    """What :func:`span` returns while no profiler runs: a shared no-op."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Record:
    __slots__ = ("name", "parent", "root", "t0", "t1", "events", "device_s")

    def __init__(self, name, parent):
        self.name, self.parent = name, parent
        self.root = self if parent is None else parent.root
        self.t0 = self.t1 = 0.0
        self.events = None
        self.device_s = None


class _Spans:
    """The records of the spans closed since :func:`trace` last began, and
    each thread's stack of open spans."""

    def __init__(self):
        self.records: List[_Record] = []
        self.local = threading.local()

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_SPANS = _Spans()


def _timing_stream(device):
    """The stream whose events time a span on ``device``: its current one,
    unless ``device`` is no card or that stream captures a graph."""
    if not isinstance(device, torch.device) or device.type != "cuda" \
            or torch.cuda.is_current_stream_capturing():
        return None
    return torch.cuda.current_stream(device)


class _Span:
    __slots__ = ("name", "device", "rec", "rf", "stream")

    def __init__(self, name, device):
        self.name, self.device = name, device

    def __enter__(self):
        stack = _SPANS.stack()
        self.rec = rec = _Record(self.name, stack[-1] if stack else None)
        stack.append(rec)
        self.rf = torch._C._profiler._RecordFunctionFast(rec.name)
        self.rf.__enter__()
        self.stream = _timing_stream(self.device)
        if self.stream is not None:
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(self.stream)
        rec.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        rec = self.rec
        rec.t1 = time.perf_counter()
        if self.stream is not None:
            rec.events[1].record(self.stream)
        self.rf.__exit__(*exc)
        stack = _SPANS.stack()
        if stack and stack[-1] is rec:
            stack.pop()
        _SPANS.records.append(rec)
        return False


def span(name: str, device=False):
    """``with span("layer.part"): ...`` marks a layer boundary (see the
    module docstring).  ``device``: the ``torch.device`` the span's work
    runs on; on a card the span is also timed on its current stream.  The
    end event is recorded as the block exits, so a block that ends in
    a host wait puts the wait inside the span."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, device)


class SpanRecord(NamedTuple):
    """One closed span: ``parent`` and ``root`` are indices into the list
    :func:`span_records` returns (``root`` is the span's own index for a
    root; either is None where that span opened before the records were
    emptied); ``device_s`` is None for a host-only span."""

    name: str
    parent: Optional[int]
    root: Optional[int]
    host_s: float
    device_s: Optional[float]


class SpanTotal(NamedTuple):
    """The spans of one name: how many closed, their host and card
    seconds (card None where none was timed there), and the name of the
    span that opened the first of them (None for a root)."""

    count: int
    host_s: float
    device_s: Optional[float]
    parent: Optional[str]


def _resolve(records: List[_Record]) -> None:
    """Each timed record's card seconds, after one synchronize."""
    pending = [r for r in records if r.events is not None]
    if not pending:
        return
    torch.cuda.synchronize()
    for r in pending:
        start, end = r.events
        r.device_s = start.elapsed_time(end) * 1e-3
        r.events = None


def span_records() -> List[SpanRecord]:
    """The spans closed since :func:`trace` last began, in closing order."""
    records = list(_SPANS.records)
    _resolve(records)
    index = {id(r): i for i, r in enumerate(records)}
    return [SpanRecord(r.name,
                       None if r.parent is None else index.get(id(r.parent)),
                       index.get(id(r.root)), r.t1 - r.t0, r.device_s)
            for r in records]


def span_totals() -> Dict[str, SpanTotal]:
    """Per span name, the :class:`SpanTotal` of its closed spans."""
    records = list(_SPANS.records)
    _resolve(records)
    out: Dict[str, SpanTotal] = {}
    for r in records:
        t = out.get(r.name)
        if t is None:
            out[r.name] = SpanTotal(
                1, r.t1 - r.t0, r.device_s,
                None if r.parent is None else r.parent.name)
            continue
        dev = t.device_s if r.device_s is None else \
            (t.device_s or 0.0) + r.device_s
        out[r.name] = t._replace(count=t.count + 1,
                                 host_s=t.host_s + r.t1 - r.t0, device_s=dev)
    return out


@dataclass
class Trace:
    """What :func:`trace` yields: the running profiler; once the block has
    exited, the path of the Chrome trace and the program's spans
    (:func:`span_totals` of the block).  Disabled, all stay empty."""
    profile: object = None
    path: Optional[str] = None
    spans: Dict[str, SpanTotal] = field(default_factory=dict)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, enabled: bool = True):
    """Profile the block with ``torch.profiler`` and write
    ``<log_dir>/trace_<pid>_<ns>.json``.  Records CPU activity, and CUDA
    activity (kernels, copies) where a card is present, and the program's
    spans by name.  ``log_dir`` defaults to ``$TMPDIR/torch-trace``."""
    handle = Trace()
    if not enabled:
        yield handle
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    _SPANS.records = []
    with profile(activities=activities) as prof:
        handle.profile = prof
        yield handle
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    handle.path = path
    handle.spans = span_totals()
