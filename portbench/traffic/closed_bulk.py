"""Traffic kind ``closed_bulk``: one client calls the zoo's public entry,
``ZooServer.classify``, back to back; each call a batch of ``batch``
REQUEST packets drawn in turn from a pool of ``pool`` batches made at
set-up; each call's ``rslt`` lands on the host, as ``classify`` returns it.

``classify`` builds REQUEST packets only, so passthrough is the open
loop's to check, through ``submit_batch``.
"""
from __future__ import annotations

import time

import numpy as np

from portbench import devtrace, drivers
from portbench.drivers import Outcome


class Driver:
    def __init__(self, dep, mix: dict, seed: int) -> None:
        self.dep, self.mix = dep, mix
        rng = np.random.default_rng([seed, 1])
        self.pool = [drivers.make_packets(dep, rng, mix["batch"], 0.0)
                     for _ in range(mix["pool"])]

    def _call(self, p, traced: bool) -> np.ndarray:
        with devtrace.span("classify", traced):
            return self.dep.zoo.classify(p.X, mid=p.mid, vid=p.vid)

    def warm(self) -> None:
        """Every batch of the pool once: the bucket's graph is captured and
        the kernels loaded before the window."""
        for p in self.pool:
            self._call(p, False)

    def window(self, seconds: float, tracer) -> Outcome:
        pool, n_pool = self.pool, len(self.pool)
        keep = max(drivers.KEEP_PACKETS // self.mix["batch"], 8)
        stride, kept = 1, []
        slice_lo = slice_hi = 0
        traced = tracer is not None
        failed = 0
        marks, next_mark = [], 1.0
        with drivers.GcPauses() as pauses:
            t0 = time.perf_counter()
            i = 0
            while True:
                now = time.perf_counter() - t0
                if now >= next_mark:
                    marks.append((now, i))
                    next_mark += 1.0
                if now >= seconds and (tracer is None or tracer.slice is not None):
                    break
                if tracer is not None:
                    due = tracer.due(now)
                    if due == "start":
                        tracer.start()
                        slice_lo = i
                    elif due == "stop":
                        tracer.stop()
                        slice_hi = i
                j = i % n_pool
                try:
                    rslt = self._call(pool[j], traced)
                except Exception:
                    failed += 1
                    i += 1
                    continue
                if i % stride == 0:
                    # classify returns a host array of its own: keeping it
                    # costs the window no copy
                    kept.append((i, j, rslt, None, None))
                    if len(kept) >= 2 * keep:
                        stride *= 2
                        kept = [k for k in kept if k[0] % stride == 0]
                i += 1
            t1 = time.perf_counter()
        calls = np.zeros(n_pool, np.int64)
        for k in range(slice_lo, slice_hi):
            calls[k % n_pool] += 1
        return Outcome(
            t_start=t0, seconds=t1 - t0, attempted=i, failed=failed,
            packets=(i - failed) * self.mix["batch"],
            answers=[k[1:] for k in kept],
            slice=tracer.slice if tracer else None, slice_calls=calls,
            gc_pauses=pauses.pauses, marks=marks)
