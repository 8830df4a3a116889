"""The benchmark's arithmetic: percentiles, spreads and interval unions."""
from __future__ import annotations

import math
import statistics

import numpy as np

__all__ = ["percentile", "spread", "union_length", "gaps"]


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of ``values``:
    the smallest value that at least ``q`` percent of them do not exceed.
    A failed request enters as ``inf``, so it misses every limit."""
    xs = np.sort(np.asarray(values, float))
    if xs.size == 0:
        raise ValueError("no values")
    rank = max(math.ceil(q / 100.0 * xs.size), 1)
    return float(xs[rank - 1])


def spread(values) -> float:
    """The distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / q2


def _merged(intervals) -> np.ndarray:
    """``[start, end]`` rows sorted and merged where they overlap."""
    iv = np.asarray(intervals, float).reshape(-1, 2)
    if iv.size == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def union_length(intervals) -> float:
    """The length of the union of ``[start, end]`` intervals: time covered
    at least once, however many streams overlap."""
    m = _merged(intervals)
    return float((m[:, 1] - m[:, 0]).sum()) if m.size else 0.0


def gaps(intervals, lo: float, hi: float) -> np.ndarray:
    """The ``[start, end]`` stretches of ``[lo, hi]`` that no interval
    covers."""
    m = _merged(intervals)
    edges = [lo]
    for s, e in np.clip(m, lo, hi):
        if e > s:
            edges += [s, e]
    edges.append(hi)
    g = np.asarray(edges, float).reshape(-1, 2)
    return g[g[:, 1] > g[:, 0]]
