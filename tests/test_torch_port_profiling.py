"""The port's ``utils/profiling.py``: ``trace`` writing a Chrome trace of a
``torch.profiler`` run (on the CPU here) or nothing when disabled, and the
``span`` mechanism: off without a profiler (no profiler record, no event,
no clock read, no record of its own), and under ``trace`` the records'
parents, roots, counts and seconds, their names in the Chrome trace as
plain host ops (no annotation that would take a caller's off the card's
timeline), and no event while a stream captures."""

import json
import os

import pytest
import torch

from cervical_tpu_torch.utils import profiling as P
from cervical_tpu_torch.utils import span, span_totals, trace


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with trace(str(tmp_path / "t")) as tr:
        assert tr.path is None and tr.profile is not None
        torch.mm(a, a).sum()
    assert os.path.dirname(tr.path) == str(tmp_path / "t")
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_disabled_trace_writes_nothing(tmp_path):
    with trace(str(tmp_path / "t"), enabled=False) as tr:
        with span("off.root"):
            torch.ones(3).sum()
    assert tr.path is None and tr.profile is None and tr.spans == {}
    assert not (tmp_path / "t").exists()


class _Counter:
    """Counts the calls of what it replaces."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.fixture
def counted(monkeypatch):
    """The profiler's records (``record_function`` and the fast
    ``RecordFunction``), ``torch.cuda.Event`` and the module's clock, each
    replaced by a counter of its calls."""
    fast = torch._C._profiler._RecordFunctionFast
    out = {"record_function": _Counter(torch.profiler.record_function),
           "record_fast": _Counter(fast),
           "Event": _Counter(lambda **kw: None),
           "perf_counter": _Counter(P.time.perf_counter)}
    monkeypatch.setattr(torch.profiler, "record_function",
                        out["record_function"])
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        out["record_fast"])
    monkeypatch.setattr(torch.cuda, "Event", out["Event"])
    monkeypatch.setattr(P.time, "perf_counter", out["perf_counter"])
    return out


def test_span_off_is_the_profiler_check_alone(tmp_path, counted):
    """With no profiler a span makes no profiler record, no event, reads
    no clock and leaves the records empty; every call returns the same
    shared object."""
    with trace(str(tmp_path)):  # empties the records
        pass
    counted["perf_counter"].calls = 0
    for device in (False, torch.device("cpu"), torch.device("cuda", 0)):
        with span("off.root", device):
            with span("off.child", device):
                torch.ones(2).sum()
    assert span("a") is span("b", torch.device("cuda", 0))
    assert {k: c.calls for k, c in counted.items()} == {
        "record_function": 0, "record_fast": 0, "Event": 0,
        "perf_counter": 0}
    assert span_totals() == {} and P.span_records() == []


def test_spans_nest_under_trace(tmp_path):
    """Two roots with children: each record's parent and root, the counts,
    host seconds that nest, no card seconds on the CPU, and every name in
    the Chrome trace (as a host op, not an annotation) and in
    ``Trace.spans``."""
    with trace(str(tmp_path)) as tr:
        for _ in range(2):
            with span("t.root", torch.device("cpu")):
                with span("t.mid", torch.device("cpu")):
                    with span("t.leaf"):
                        torch.ones(8).sum()
                    with span("t.leaf"):
                        pass
                with span("t.side"):
                    pass
    recs = P.span_records()
    assert [r.name for r in recs] == ["t.leaf", "t.leaf", "t.mid", "t.side",
                                      "t.root"] * 2
    for half in (0, 5):
        leaf0, leaf1, mid, side, root = range(half, half + 5)
        assert [recs[i].parent for i in (leaf0, leaf1, mid, side, root)] == \
            [mid, mid, root, root, None]
        assert {recs[i].root for i in range(half, half + 5)} == {root}
        assert recs[root].host_s >= recs[mid].host_s + recs[side].host_s
    assert all(r.device_s is None for r in recs)
    totals = span_totals()
    assert {k: (t.count, t.parent, t.device_s) for k, t in totals.items()} \
        == {"t.root": (2, None, None), "t.mid": (2, "t.root", None),
            "t.leaf": (4, "t.mid", None), "t.side": (2, "t.root", None)}
    assert totals["t.root"].host_s == pytest.approx(
        recs[4].host_s + recs[9].host_s)
    assert tr.spans == totals
    with open(tr.path) as f:
        cats = {e.get("name"): e.get("cat")
                for e in json.load(f)["traceEvents"]}
    assert {cats.get(k) for k in totals} == {"cpu_op"}


def test_trace_empties_the_records(tmp_path):
    with trace(str(tmp_path)):
        with span("first.root"):
            pass
    with trace(str(tmp_path)) as tr:
        with span("second.root"):
            pass
    assert set(tr.spans) == set(span_totals()) == {"second.root"}


def test_no_event_while_the_stream_captures(tmp_path, counted, monkeypatch):
    """A span timed on a card whose current stream captures a CUDA graph
    records no event: its card seconds stay None."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with trace(str(tmp_path)):
        for _ in range(2):
            with span("cap.root", torch.device("cuda", 0)):
                pass
    assert counted["Event"].calls == 0
    assert counted["record_fast"].calls == 2
    total = span_totals()["cap.root"]
    assert total.count == 2 and total.device_s is None
