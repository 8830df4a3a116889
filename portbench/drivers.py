"""What every traffic driver shares: the packets, a window's outcome, the
collector's pauses, and the end-to-end numbers a window gives.

A traffic mix's data file (``portbench/traffic/<mix>.json``) names its
driver's ``kind``; the driver is ``portbench/traffic/<kind>.py``, found by
that name (``spec.driver``), whose ``Driver(dep, mix, seed)`` makes the
mix's requests from the seed at set-up.

Packets draw their slot uniformly over the zoo's slots, their features from
the slot's test rows (uniform random levels for an empty slot), and a share
of them are FORWARD packets carrying nonzero intermediates and results,
which must come back untouched.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np

from portbench import devtrace, stats
from portbench.deploy import Deployment, rows_for
from portbench.reference import FORWARD, REQUEST

__all__ = ["Packets", "Outcome", "GcPauses", "make_packets", "summary",
           "CHECK_SHARE", "KEEP_PACKETS", "GRACE_S"]

# the share of an open loop's requests whose answers are kept and compared
CHECK_SHARE = 0.25
# the answers a closed loop keeps, in packets, spread evenly over the window
KEEP_PACKETS = 1 << 19
# how long after the window's close an open loop waits for its answers
GRACE_S = 60.0


@dataclasses.dataclass
class Packets:
    """One request batch as numpy arrays (codes as int32 bits)."""

    X: np.ndarray
    mid: np.ndarray
    vid: np.ndarray
    ptype: np.ndarray
    codes: np.ndarray
    acc: np.ndarray
    rslt: np.ndarray
    _fields: dict | None = None

    @property
    def n(self) -> int:
        return self.X.shape[0]

    def request(self, zoo):
        """The program's request batch for these packets: built by the
        zoo's request path, with the packet types and carried fields set."""
        import torch

        if self._fields is None:
            self._fields = dict(
                ptype=torch.from_numpy(self.ptype), codes=torch.from_numpy(
                    self.codes), svm_acc=torch.from_numpy(self.acc),
                rslt=torch.from_numpy(self.rslt))
        pb = zoo.make_request(self.X, mid=self.mid, vid=self.vid)
        return dataclasses.replace(pb, **self._fields)


def make_packets(dep: Deployment, rng, n: int, forward_share: float) -> Packets:
    prof = dep.profile
    vid = rng.integers(0, prof.max_versions, n).astype(np.int32)
    X = rows_for(dep, rng, vid)
    mid = np.asarray([dep.mids[v] for v in vid], np.int32)
    fwd = rng.random(n) < forward_share
    ptype = np.where(fwd, FORWARD, REQUEST).astype(np.int32)
    codes = np.where(fwd[:, None], rng.integers(
        1, 1 << 20, (n, prof.max_trees)), 0).astype(np.int32)
    acc = np.where(fwd[:, None], rng.integers(
        -99, 99, (n, prof.max_hyperplanes)), 0).astype(np.int32)
    rslt = np.where(fwd, rng.integers(0, 9, n), -1).astype(np.int32)
    return Packets(X, mid, vid, ptype, codes, acc, rslt)


class GcPauses:
    """Python's collector's pauses during a window: (generation, ms)."""

    def __init__(self) -> None:
        self.pauses: list = []
        self._t = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses.append((info["generation"],
                                (time.perf_counter() - self._t) * 1e3))

    def __enter__(self) -> "GcPauses":
        gc.collect()
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)


@dataclasses.dataclass
class Outcome:
    """What a window did."""

    t_start: float                  # host clock at the first timed request
    seconds: float                  # the window's length
    attempted: int                  # calls or requests made in the window
    failed: int                     # of those, raised or never answered
    packets: int                    # packets classified in the window
    answers: list                   # (pool index, rslt, codes, svm_acc);
                                    # codes and svm_acc None where the
                                    # entry returns rslt alone
    latencies_ms: np.ndarray | None = None   # open loop, inf where failed
    late_ms: np.ndarray | None = None        # how late each arrival fired
    stats: dict | None = None                # the front's latency_stats()
    slice: devtrace.Slice | None = None
    slice_calls: np.ndarray | None = None    # pool index -> calls in slice
    gc_pauses: list = dataclasses.field(default_factory=list)
    marks: list = dataclasses.field(default_factory=list)  # (s, calls so far)


def summary(out: Outcome) -> dict:
    """The end-to-end numbers a window gives (host clock)."""
    if out.latencies_ms is None:
        return {"packets_per_s": out.packets / out.seconds}
    return {"p50_ms": stats.percentile(out.latencies_ms, 50),
            "p99_ms": stats.percentile(out.latencies_ms, 99)}
