"""A bounded slice of the run under ``torch.profiler``, reduced to numbers.

``Tracer`` starts the profiler (host ops and the card's activity) for a few
seconds near the end of the window; ``Slice`` holds what the per-layer
readers need: the card's activity intervals, the CUDA runtime calls the
host made, the host's own ops and the benchmark's spans, and the count of
classifies the harness finished inside the slice.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import json
import os
import tempfile
import time

import numpy as np

from portbench import stats
from portbench.workcount import Work

__all__ = ["Slice", "Tracer", "span", "HOST_CALLS"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# the host's calls that put work on the card
HOST_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaMemcpyAsync")
SPAN_PREFIX = "portbench."
# host events longer than this are searched apart when naming a gap
_LONG_US = 50_000.0


@dataclasses.dataclass
class Slice:
    """One traced stretch of the window; times in microseconds on the
    profiler's clock."""

    lo: float
    hi: float
    device: list            # (name, cat, start, end)
    host: list              # (name, start, end, thread)
    runtime_calls: dict     # CUDA runtime call name -> count
    thread: object = None   # the benchmark's thread (the slice's span)
    classifies: int = 0     # whole classifies the harness finished inside
    work: Work | None = None   # their least work

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        """Seconds in which anything ran on the card: the union of its
        activity intervals, so overlapping streams count once."""
        return stats.union_length([(s, e) for _, _, s, e in self.device]) / 1e6

    @property
    def kernel_s(self) -> float:
        """The summed device time of every kernel (not copies)."""
        return sum(e - s for _, c, s, e in self.device if c == "kernel") / 1e6

    def host_calls(self) -> int:
        return sum(n for k, n in self.runtime_calls.items()
                   if k.startswith(HOST_CALLS))

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time: [name, seconds]."""
        by = collections.Counter()
        for name, _, s, e in self.device:
            by[name] += (e - s) / 1e6
        return [[n, t] for n, t in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle time on the card by what the host was doing meanwhile:
        [host activity, seconds], the largest first.  A gap is named by
        the innermost op covering its middle on the benchmark's thread,
        under the benchmark's span around it where there is one, and by
        the innermost op of any other thread after a ``+``."""
        gaps = stats.gaps([(s, e) for _, _, s, e in self.device],
                          self.lo, self.hi)
        host = sorted(self.host, key=lambda h: h[1])
        short = [h for h in host if h[2] - h[1] <= _LONG_US]
        long_ = [h for h in host if h[2] - h[1] > _LONG_US]
        starts = [h[1] for h in short]
        by = collections.Counter()
        for a, b in gaps:
            m = (a + b) / 2
            i = bisect.bisect_right(starts, m)
            j = bisect.bisect_left(starts, m - _LONG_US)
            cover = [h for h in short[j:i] if h[2] >= m]
            cover += [h for h in long_ if h[1] <= m <= h[2]]
            main = [h for h in cover if h[3] == self.thread]
            rest = [h for h in cover if h[3] != self.thread]
            name = _gap_name(main)
            if rest:
                name += " + " + min(rest, key=lambda h: h[2] - h[1])[0]
            by[name] += float(b - a) / 1e6
        return [[n, t] for n, t in by.most_common(top)]


def _gap_name(cover: list) -> str:
    if not cover:
        return "no recorded op"
    inner = min(cover, key=lambda h: h[2] - h[1])[0]
    spans = [h for h in cover if h[0].startswith(SPAN_PREFIX)]
    if spans:
        outer = max(spans, key=lambda h: h[2] - h[1])[0]
        if outer != inner:
            return f"{outer} > {inner}"
    return inner


def parse(trace: dict) -> Slice:
    """A chrome trace exported by ``torch.profiler`` -> ``Slice``."""
    device, host = [], []
    calls = collections.Counter()
    lo, hi = np.inf, -np.inf
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "ts" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        s = float(e["ts"])
        end = s + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((name, cat, s, end))
        elif cat in HOST_CATS:
            host.append((name, s, end, e.get("tid")))
            if cat in ("cuda_runtime", "cuda_driver"):
                calls[name] += 1
        else:
            continue
        lo, hi = min(lo, s), max(hi, end)
    marks = [h for h in host if h[0] == SPAN_PREFIX + "slice"]
    thread = None
    if marks:
        _, lo, hi, thread = marks[0]
        device = [(n, c, max(s, lo), min(e, hi)) for n, c, s, e in device
                  if e > lo and s < hi]
        host = [h for h in host if h[2] > lo and h[1] < hi
                and h[0] != SPAN_PREFIX + "slice"]
        calls = collections.Counter(h[0] for h in host if h[0] in calls)
    if not np.isfinite(lo):
        lo = hi = 0.0
    return Slice(lo=lo, hi=hi, device=device, host=host,
                 runtime_calls=dict(calls), thread=thread)


@contextlib.contextmanager
def span(name: str, on: bool):
    """The benchmark's own span around a call into a layer (traced runs
    only)."""
    if not on:
        yield
        return
    import torch
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


class Tracer:
    """Profiles ``seconds`` near the end of a window of ``window_s``
    seconds, so that the front's own counters, read as the slice opens,
    cover most of the window undisturbed.  The caller asks ``due(elapsed)``
    between units of work, and calls ``start`` / ``stop`` when it says
    so."""

    def __init__(self, window_s: float, seconds: float = 2.0) -> None:
        self.seconds = min(seconds, window_s / 3)
        self.begin = window_s - self.seconds - min(1.0, window_s / 10)
        self._prof = None
        self._span = None
        self._t0 = 0.0
        self.slice: Slice | None = None

    def due(self, elapsed: float) -> str | None:
        """``"start"``, ``"stop"`` or None at ``elapsed`` seconds into the
        window."""
        if self.slice is None and self._prof is None and elapsed >= self.begin:
            return "start"
        if self._prof is not None and \
                time.perf_counter() - self._t0 >= self.seconds:
            return "stop"
        return None

    def warm(self) -> None:
        """Start and stop the profiler once, before the window: its first
        start loads and initialises the tracing libraries, which takes
        seconds."""
        self.start()
        self._span.__exit__(None, None, None)
        self._prof.stop()
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        cuda = torch.cuda.is_available()
        self._prof = profile(activities=[ProfilerActivity.CPU]
                             + ([ProfilerActivity.CUDA] if cuda else []))
        self._prof.start()
        if cuda:
            # the tracer's own start-up cost lands on the first device
            # activity it sees: pay it here, before the slice opens
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        self._span = record_function(SPAN_PREFIX + "slice")
        self._span.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> Slice:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        prof, self._prof = self._prof, None
        prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.slice = parse(json.load(f))
        finally:
            os.unlink(path)
        return self.slice
