"""The arithmetic of the metrics on made-up numbers and made-up traces:
percentiles, rates, interval unions, and a trace summary."""

import numpy as np
import pytest

from benchmarks.harness import stats
from benchmarks.harness.trace import Summary


def test_percentile_matches_numpy():
    rng = np.random.default_rng(0)
    xs = rng.exponential(size=257).tolist()
    for q in (0, 50, 95, 99, 100):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    assert stats.percentile([3.0], 95) == 3.0


def test_rate_counts_all_work_over_the_window():
    # 3 epochs of 1,344 samples in 25 s: the rate is 4,032 / 25
    assert 3 * 1344 / 25.0 == pytest.approx(161.28)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 8)]
    assert stats.union(iv) == [(0, 3), (5, 6)]
    assert stats.covered(iv) == 4
    assert stats.gaps(stats.union(iv), -1, 7) == [(-1, 0), (3, 5), (6, 7)]
    assert stats.clip([(0, 3), (5, 6)], 1, 5.5) == [(1, 3), (5, 5.5)]


class Ev:
    """A made-up profiler record."""

    def __init__(self, name, start, end, device=False, kind="cpu_op",
                 corr=0, link=0, thread=1):
        self._n, self._s, self._e = name, start, end
        self._d, self._k = device, kind
        self._c, self._l, self._t = corr, link, thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def activity_type(self):
        return self._k

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def start_thread_id(self):
        return self._t


def test_summary_of_a_made_up_trace():
    ev = [Ev("bench.window", 0, 1000, corr=1),
          Ev("bench.k4", 100, 300, corr=2),
          Ev("cudaLaunchKernel", 110, 120, kind="cuda_runtime", corr=3),
          Ev("aten::mm", 150, 200, corr=4),
          Ev("cudaStreamSynchronize", 600, 900, kind="cuda_runtime", corr=5),
          # device: the spans' mirrors, two overlapping kernels, one copy,
          # one kernel outside the window
          Ev("bench.window", 0, 1000, True),
          Ev("bench.k4", 200, 400, True),
          Ev("mf_pw_gemm", 200, 400, True, "kernel", link=3),
          Ev("gemm_other", 350, 450, True, "kernel", link=4),
          Ev("Memcpy HtoD (Pageable -> Device)", 500, 600, True,
             "gpu_memcpy", link=9),
          Ev("late", 1100, 1200, True, "kernel", link=9)]
    s = Summary(ev, spans=("bench.k4",))
    assert s.window_s == pytest.approx(1000e-9)
    assert s.busy_s == pytest.approx(350e-9)       # [200,450] + [500,600]
    assert s.span_count == {"bench.k4": 1}
    # the card's busy time inside the span's mirror
    assert s.span_device_s["bench.k4"] == pytest.approx(200e-9)
    assert s.copy_s == {"htod": pytest.approx(100e-9)}
    gaps = dict(s.idle_gaps)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(400e-9)
    assert sum(gaps.values()) == pytest.approx(650e-9)
    assert s.device_ops[0][0] == "mf_pw_gemm"
