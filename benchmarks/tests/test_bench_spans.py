"""The readers of the program's spans (``metrics/*`` with ``source:
program_span``) on made-up span totals: ``None`` where the records are
empty or the program has no spans, and each value by hand."""

import collections

import pytest

from benchmarks.harness import spec as S
from cervical_tpu_torch.utils import profiling

# the fields of the program's ``profiling.SpanTotal``
SpanTotal = collections.namedtuple("SpanTotal", "count host_s device_s parent")

SPEC = S.load()
SPAN_METRICS = sorted(m["name"] for m in SPEC["per_layer"]
                      if m["source"] == "program_span")

# 4 requests of 2 batches; 2 epochs of 21 train calls
TOTALS = {
    "predict.request": SpanTotal(4, 0.100, 0.098, None),
    "predict.stage": SpanTotal(8, 0.030, 0.024, "predict.request"),
    "predict.forward": SpanTotal(8, 0.020, 0.048, "predict.request"),
    "predict.unletterbox": SpanTotal(8, 0.001, 0.010, "predict.request"),
    "predict.argmax": SpanTotal(8, 0.001, 0.002, "predict.request"),
    "predict.download": SpanTotal(4, 0.012, 0.012, "predict.request"),
    "mf.eval": SpanTotal(8, 0.024, None, "predict.forward"),
    "seg.epoch": SpanTotal(2, 16.2, 16.0, None),
    "seg.epoch.train": SpanTotal(2, 14.0, 14.4, "seg.epoch"),
    "seg.epoch.val": SpanTotal(2, 1.0, 1.2, "seg.epoch"),
    "seg.call.train": SpanTotal(42, 0.21, None, "seg.epoch.train"),
}
WANT = {
    "stage_ms.serve": 1e3 * 0.024 / 4,
    "forward_ms.serve": 1e3 * 0.048 / 4,
    "finish_ms.serve": 1e3 * (0.010 + 0.002 + 0.012) / 4,
    "k4_host_ms.serve": 1e3 * 0.024 / 8,
    "dispatch_ms.train": 1e3 * 0.21 / 42,
    "val_share.train": 100.0 * 1.2 / 16.0,
    "epoch_gap_ms.train": 1e3 * (16.0 - 14.4 - 1.2) / 2,
}


def test_every_span_metric_has_a_case():
    assert SPAN_METRICS == sorted(WANT)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_values(monkeypatch, name):
    monkeypatch.setattr(profiling, "span_totals", lambda: dict(TOTALS),
                        raising=False)
    assert S.reader(name)(None, {}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_none_without_records(monkeypatch, name):
    monkeypatch.setattr(profiling, "span_totals", lambda: {}, raising=False)
    assert S.reader(name)(None, {}) is None
    # a program with no spans at all, as the commit before them
    monkeypatch.delattr(profiling, "span_totals")
    assert S.reader(name)(None, {}) is None


@pytest.mark.parametrize("name", ["stage_ms.serve", "val_share.train",
                                  "epoch_gap_ms.train"])
def test_reader_none_without_card_times(monkeypatch, name):
    """Spans timed on the host alone (a CPU run) give no card reading."""
    host_only = {k: t._replace(device_s=None) for k, t in TOTALS.items()}
    monkeypatch.setattr(profiling, "span_totals", lambda: host_only,
                        raising=False)
    assert S.reader(name)(None, {}) is None
