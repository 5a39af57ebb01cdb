"""The port's ``utils/profiling.py``: ``ThroughputMeter`` against the JAX
package's under one clock, and ``trace`` writing a Chrome trace of a
``torch.profiler`` run (on the CPU here) or nothing when disabled."""

import json
import os

import pytest
import torch

from cervical_tpu.utils import profiling as JP
from cervical_tpu_torch.utils import ThroughputMeter, trace
from cervical_tpu_torch.utils import profiling as P


def _clock(monkeypatch, module, times):
    it = iter(times)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(it))


@pytest.mark.parametrize("window,chips", [(50, 4), (3, 1)])
def test_throughput_meter_equals_jax(monkeypatch, window, chips):
    """The same ``perf_counter`` sequence and image counts give the same
    readings and ``summary()``, the sliding window included."""
    times = [0.0, 0.11, 0.25, 0.31, 0.52, 0.61, 0.93]
    counts = [0, 8, 8, 16, 8, 8, 4]
    meters = []
    for module, cls in ((P, ThroughputMeter), (JP, JP.ThroughputMeter)):
        _clock(monkeypatch, module, times)
        m = cls(window=window, num_chips=chips)
        for n in counts:
            m.step(n)
        meters.append(m)
    got, want = meters
    assert got.summary() == want.summary()
    assert got.images_per_sec == want.images_per_sec
    assert got.steps_per_sec == want.steps_per_sec
    assert ThroughputMeter(num_chips=chips).summary() == {
        "images_per_sec": 0.0, "images_per_sec_per_chip": 0.0,
        "steps_per_sec": 0.0, "num_chips": chips}


def test_throughput_meter_counts_cards():
    want = torch.cuda.device_count() if torch.cuda.is_available() else 1
    assert ThroughputMeter().num_chips == want


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
        torch.ones(3).sum()
    assert tr.path is None and tr.profile is None
    assert not (tmp_path / "t").exists()
