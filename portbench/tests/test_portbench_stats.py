"""The benchmark's arithmetic: percentiles, spreads, interval unions and
the reduction of a profiler trace."""
from __future__ import annotations

import math
import statistics

import pytest

from portbench import stats
from portbench.devtrace import parse


def test_percentile_is_nearest_rank_and_failures_miss_every_limit():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 50) == 50
    assert stats.percentile(xs, 99) == 99
    assert stats.percentile(xs + [math.inf], 99) == 100
    assert stats.percentile([3.0, math.inf], 50) == 3.0
    assert stats.percentile([3.0, math.inf], 99) == math.inf
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_spread_is_the_quartiles_over_the_median():
    xs = [10.0, 11.0, 9.5, 10.4, 12.0, 9.9]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)


def test_union_counts_overlap_once_and_gaps_fill_the_rest():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 45)]
    assert stats.union_length(iv) == 15 + 10 + 5
    assert stats.gaps(iv, 0, 50).tolist() == [[15, 20], [30, 40], [45, 50]]
    assert stats.gaps(iv, 22, 42).tolist() == [[30, 40]]
    assert stats.union_length([]) == 0.0


def test_trace_slice_reduction():
    """A synthetic chrome trace: the slice's span bounds it, kernels on two
    streams overlap once, copies count as busy and not as kernels, the host
    calls are counted, and an idle gap is named by the benchmark's thread's
    innermost op under its span, with another thread's after a ``+``."""
    ev = [("user_annotation", "portbench.slice", 0, 100, 1),
          ("user_annotation", "portbench.run", 0, 50, 1),
          ("cpu_op", "aten::copy_", 10, 20, 1),
          ("cpu_op", "aten::zeros", 60, 30, 1),
          ("cuda_runtime", "cudaGraphLaunch", 65, 10, 2),
          ("cuda_runtime", "cudaMemcpyAsync", 200, 5, 1),
          ("kernel", "k", 30, 10, 7), ("kernel", "k", 35, 10, 8),
          ("gpu_memcpy", "Memcpy HtoD", 90, 5, 7),
          ("kernel", "late", 150, 10, 7)]
    sl = parse({"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": t, "dur": d, "tid": tid}
        for c, n, t, d, tid in ev]})
    assert sl.window_s == pytest.approx(100e-6)
    assert sl.busy_s == pytest.approx(20e-6)
    assert sl.kernel_s == pytest.approx(20e-6)
    assert sl.host_calls() == 1
    assert sl.device_ops()[0] == ["k", pytest.approx(20e-6)]
    gaps = dict(sl.idle_gaps())
    assert gaps["portbench.run > aten::copy_"] == pytest.approx(30e-6)
    assert gaps["aten::zeros + cudaGraphLaunch"] == pytest.approx(45e-6)
    assert gaps["no recorded op"] == pytest.approx(5e-6)
