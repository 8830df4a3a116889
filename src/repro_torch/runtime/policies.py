"""Pluggable batching policies for the async serving front-end.

Port of ``src/repro/runtime/policies.py`` (numpy only; the port keeps its
own copy, ``bucket_size`` from ``repro_torch.runtime.admission``).  In the
port every admission bucket is a captured CUDA graph (``graphs.py``), so
"compiled shapes" below are captured graphs.

A serving front that accepts per-client ``submit()`` calls has to decide,
every time traffic is queued, *when* to cut a batch and *how much* of the
queue to take.  That decision is the whole latency/throughput trade-off of
online serving — so it is a policy object, not a hard-coded loop:

* ``ImmediatePolicy``        — cut a batch the instant anything is queued.
  Lowest queueing delay per request at low load; at high load every request
  pays one full dispatch (trace lookup + kernel launch + host demux), so the
  service rate caps out near ``1 / t_dispatch`` and the queue — and p99 —
  grow without bound.
* ``SizeOrDeadlinePolicy``   — classic size-or-timeout coalescing: flush
  when ``max_batch`` packets are queued *or* the oldest request has waited
  ``max_wait_us``.  Bounded added latency, amortized dispatch.
* ``AdaptiveBucketPolicy``   — widens its target batch to the next
  power-of-two **admission bucket** under sustained load and snaps back
  down when a deadline flush shows the load dropped.  Because targets are
  the same ``granularity * 2^k`` buckets admission pads to
  (``admission.bucket_size``), a widening target never mints new compiled
  shapes — the O(log B) trace bound is preserved by construction.

The protocol is synchronous and pure-by-inputs so policies are unit-testable
without an event loop; ``AsyncZooServer`` (``repro_torch.serving.async_server``)
owns the clock and calls:

* ``wait_us(queued_packets, oldest_age_us)`` — ``<= 0`` means "cut a batch
  now"; a positive value is the longest the server may sleep waiting for
  more arrivals before asking again.
* ``drain(queued_packets)``  — how many packets the cut batch may take
  (whole requests are never split across batches).
* ``note_dispatch(packets, waited_us)`` — feedback after each dispatch;
  adaptive policies update their load estimate here.
"""
from __future__ import annotations

import collections
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.runtime.admission import bucket_size

__all__ = [
    "BatchingPolicy",
    "ImmediatePolicy",
    "SizeOrDeadlinePolicy",
    "AdaptiveBucketPolicy",
    "SloAutoscaler",
]


@runtime_checkable
class BatchingPolicy(Protocol):
    """What the async serving loop needs from a coalescing strategy."""

    def wait_us(self, queued_packets: int, oldest_age_us: float) -> float:
        """<= 0: dispatch now; > 0: wait at most this long for more traffic."""
        ...

    def drain(self, queued_packets: int) -> int:
        """Max packets the next batch may take (>= 1 request regardless)."""
        ...

    def note_dispatch(self, packets: int, waited_us: float) -> None:
        """Feedback after a dispatch of ``packets`` that waited ``waited_us``."""
        ...


class ImmediatePolicy:
    """No coalescing at all: one request per dispatch, immediately.

    ``drain`` returns 1 — the serving loop always takes at least one whole
    request, so each dispatch carries exactly the oldest queued request.
    This is the per-request baseline every batching policy is measured
    against; under overload its queue (and p99) grow without bound while
    coalescing policies amortize the dispatch cost away.
    """

    def wait_us(self, queued_packets: int, oldest_age_us: float) -> float:
        return 0.0

    def drain(self, queued_packets: int) -> int:
        return 1

    def note_dispatch(self, packets: int, waited_us: float) -> None:
        pass


class SizeOrDeadlinePolicy:
    """Flush at ``max_batch`` packets or when the oldest request has waited
    ``max_wait_us`` — whichever comes first."""

    def __init__(self, max_batch: int = 64, max_wait_us: float = 2_000.0) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_us < 0:
            raise ValueError(f"max_wait_us must be >= 0, got {max_wait_us}")
        self.max_batch = int(max_batch)
        self.max_wait_us = float(max_wait_us)

    def wait_us(self, queued_packets: int, oldest_age_us: float) -> float:
        if queued_packets >= self.max_batch:
            return 0.0
        return self.max_wait_us - oldest_age_us

    def drain(self, queued_packets: int) -> int:
        return min(queued_packets, self.max_batch)

    def note_dispatch(self, packets: int, waited_us: float) -> None:
        pass


class AdaptiveBucketPolicy:
    """Size-or-deadline whose size target tracks offered load, snapped to
    admission buckets.

    An EWMA of per-dispatch batch size estimates demand; the flush target is
    that estimate rounded **up** to its power-of-two admission bucket
    (``bucket_size``, in units of the executor's ``granularity``), clamped
    to ``[min_batch, max_batch]``.  Sustained load therefore widens the
    admission bucket the server fills before cutting a batch — bigger
    batches, same compiled shapes.

    When load drops, the estimate must not bleed down one EWMA step per
    sparse request (each paying the full deadline meanwhile): a **deadline
    flush below target** — the batch waited out ``max_wait_us`` and still
    didn't fill — is direct evidence the demand estimate overshot, so
    ``note_dispatch`` snaps the estimate down to the observed arrivals.  At
    most one sparse dispatch after a burst pays the full deadline.
    """

    def __init__(self, *, min_batch: int = 1, max_batch: int = 256,
                 max_wait_us: float = 2_000.0, alpha: float = 0.3,
                 granularity: int = 1) -> None:
        if not (1 <= min_batch <= max_batch):
            raise ValueError(
                f"need 1 <= min_batch <= max_batch, got {min_batch}, {max_batch}")
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.min_batch = int(min_batch)
        self.max_batch = int(max_batch)
        self.max_wait_us = float(max_wait_us)
        self.alpha = float(alpha)
        self.granularity = int(granularity)
        self._demand = float(min_batch)

    @property
    def target_batch(self) -> int:
        """Current flush target: the demand estimate's admission bucket,
        never above ``max_batch`` — ``drain`` can't cut more than
        ``max_batch``, so a larger target would wait out the deadline on
        every dispatch without ever being reachable."""
        demand = min(max(self._demand, self.min_batch), self.max_batch)
        return min(bucket_size(int(round(demand)), self.granularity),
                   self.max_batch)

    def wait_us(self, queued_packets: int, oldest_age_us: float) -> float:
        if queued_packets >= self.target_batch:
            return 0.0
        return self.max_wait_us - oldest_age_us

    def drain(self, queued_packets: int) -> int:
        return min(queued_packets, self.max_batch)

    def note_dispatch(self, packets: int, waited_us: float) -> None:
        if waited_us >= self.max_wait_us and packets < self.target_batch:
            # waited the whole deadline and the target bucket still didn't
            # fill: load dropped — snap to what a full window actually held
            self._demand = float(packets)
        else:
            self._demand = ((1 - self.alpha) * self._demand
                            + self.alpha * packets)


class SloAutoscaler:
    """p99-vs-SLO lane controller for the continuous serving engine.

    Decides when the ``("switch", "port")`` mesh should widen or narrow its
    port lanes: sustained p99 latency **above** ``slo_p99_ms`` (``patience``
    consecutive over-SLO observations on a full evidence window) widens to
    the next lane count in ``lanes``; sustained p99 **below**
    ``narrow_margin * slo_p99_ms`` narrows back, releasing devices.  A
    ``cooldown`` of observations after each change — and a cleared evidence
    window — keeps the controller from flapping on the transient while the
    freshly-swapped executor settles.

    Pure-by-inputs like the batching policies: ``observe`` takes one
    request latency and returns the new lane count when (and only when) a
    scale decision fires, else ``None``.  The engine owns the actual
    executor swap — quiesce, pre-warm the incoming lane's buckets, swap —
    so this class stays unit-testable without an event loop or a mesh.
    """

    def __init__(self, *, slo_p99_ms: float, lanes: tuple[int, ...] = (1, 2, 4),
                 window: int = 64, patience: int = 4,
                 narrow_margin: float = 0.5, cooldown: int = 32) -> None:
        if slo_p99_ms <= 0:
            raise ValueError(f"slo_p99_ms must be > 0, got {slo_p99_ms}")
        if len(lanes) < 1 or list(lanes) != sorted(set(lanes)):
            raise ValueError(
                f"lanes must be distinct and ascending, got {lanes}")
        if not (0.0 < narrow_margin < 1.0):
            raise ValueError(
                f"narrow_margin must be in (0, 1), got {narrow_margin}")
        if patience < 1 or window < 2 or cooldown < 0:
            raise ValueError("need patience >= 1, window >= 2, cooldown >= 0")
        self.slo_p99_ms = float(slo_p99_ms)
        self.lanes = tuple(int(l) for l in lanes)
        self.patience = int(patience)
        self.narrow_margin = float(narrow_margin)
        self.cooldown = int(cooldown)
        self.lane = self.lanes[0]
        self._lat = collections.deque(maxlen=int(window))
        self._hot = 0
        self._cold = 0
        self._since_change = self.cooldown   # first decision needs no wait

    @property
    def p99_ms(self) -> float:
        """Current-window p99 estimate (NaN until the window has evidence)."""
        if len(self._lat) < 2:
            return float("nan")
        return float(np.percentile(np.asarray(self._lat, float), 99))

    def observe(self, latency_ms: float) -> int | None:
        """Feed one completed request's end-to-end latency.  Returns the
        new lane count when a widen/narrow decision fires, else ``None``."""
        self._lat.append(float(latency_ms))
        self._since_change += 1
        if (len(self._lat) < self._lat.maxlen
                or self._since_change < self.cooldown):
            return None          # not enough post-change evidence yet
        p99 = self.p99_ms
        if p99 > self.slo_p99_ms:
            self._hot += 1
            self._cold = 0
        elif p99 < self.narrow_margin * self.slo_p99_ms:
            self._cold += 1
            self._hot = 0
        else:
            self._hot = self._cold = 0
        i = self.lanes.index(self.lane)
        if self._hot >= self.patience and i + 1 < len(self.lanes):
            return self._decide(self.lanes[i + 1])
        if self._cold >= self.patience and i > 0:
            return self._decide(self.lanes[i - 1])
        return None

    def _decide(self, lane: int) -> int:
        self.lane = lane
        self._hot = self._cold = 0
        self._since_change = 0
        self._lat.clear()        # old-lane latencies are not evidence now
        return lane
