"""``ContinuousZooServer`` — persistent continuous-batching dispatch engine.

Port of ``src/repro/serving/engine.py``.  In the port the "warmed
executable" of each admission bucket is a captured CUDA graph
(``runtime/graphs.py``): ``_warm_one`` captures every bucket of the
incoming executor's ladder before it takes traffic.  The slot workers'
dispatches overlap up to the executor's lock, which serialises the stage,
replay and copy-out of one executor.  The lane pool holds executors
programmed with the same zoo: single-switch executors, or
``ShardedExecutor``s at widening port counts, as in the reference.

``AsyncZooServer`` dispatches one cut at a time: the loop cuts a
batch, awaits the executor call, demuxes, and only then looks at the queue
again — so while a result demuxes, arrivals sit queued and the executor
idles.  This engine makes serving *continuous*, the MLPerf-offline shape
the ROADMAP names:

* **slot pool** — a fixed pool of ``n_slots`` in-flight dispatch slots fed
  by a bounded ``asyncio.Queue``.  The cutter coroutine keeps cutting (the
  same ``BatchingPolicy`` wait/cut/coalesce seam as the base class) while
  slot workers run the blocking executor calls on a dedicated thread pool
  and demux — a new batch cuts while the previous result is still
  demuxing, and on a multi-core host ``n_slots`` dispatches overlap.
* **warmed-executable cache keyed by admission bucket** — before taking
  traffic the engine drives every ``granularity * 2^k`` bucket the policy
  can dispatch into through ``DataplaneRuntime.warm`` (zero-filled FORWARD
  passthrough batches — semantically invisible, the same shapes), so no
  live dispatch ever pays a capture or a kernel build.
* **SLO-driven lane autoscaling** — a ``SloAutoscaler``
  (``repro_torch.runtime.policies``) watches request p99 against a target; when
  sustained load blows the SLO the engine widens to the next executor in
  ``lane_pool`` (and narrows back when load drops).  The swap is safe by sequencing: pre-warm the incoming lane's
  buckets off-loop, quiesce (wait for every in-flight slot), swap the
  runtime's executor, resume — no dispatch ever straddles two lane widths,
  so answers stay bit-identical through scale events (pinned in
  ``tests/test_torch_engine.py``; every ``lane_pool`` executor must be
  programmed with the same zoo).

Everything the base class guarantees still holds — bit-identity, whole
requests, O(log B) graphs, the hold/drain/release quiesce seam (``drain``
waits for *all* slots), deterministic fail-or-flush on ``stop()`` — and the
204-draw conformance lane runs this engine alongside the base server.
Shape glue stays on the host and nothing blocks inside ``async def``:
executor calls and warmup ride the slot thread pool.

Engine stats merge into ``latency_stats()`` under ``"engine"``: slot
count, current lanes, scale events, warmed buckets, and the peak number of
concurrently *executing* dispatches (the overlap the slot pool buys).
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses

import numpy as np
import torch

from repro_torch.core.packets import PacketBatch
from repro_torch.runtime import DataplaneRuntime
from repro_torch.runtime.executors import Executor
from repro_torch.runtime.policies import BatchingPolicy, SloAutoscaler
from repro_torch.serving.async_server import (
    AsyncZooServer,
    Dispatch,
    _Pending,
)
from repro_torch.serving.serve import ZooServer

__all__ = ["ContinuousZooServer"]


class _Work:
    """One cut batch in flight between the cutter and a slot worker, and
    its dispatch record."""

    __slots__ = ("reqs", "flat", "offsets", "rec")

    def __init__(self, reqs: list[_Pending], flat: PacketBatch,
                 offsets: tuple[int, ...], rec: Dispatch) -> None:
        self.reqs = reqs
        self.flat = flat
        self.offsets = offsets
        self.rec = rec


class ContinuousZooServer(AsyncZooServer):
    """Continuous-batching front: cutter + slot pool over one runtime.

    ``warm_max_batch`` bounds the pre-captured bucket ladder; it defaults to
    the policy's ``max_batch`` when it has one (``SizeOrDeadlinePolicy`` /
    ``AdaptiveBucketPolicy``), else warming is skipped.  ``lane_pool`` maps
    lane count -> ``Executor`` (all programmed identically); with an
    ``autoscaler`` the engine starts on ``autoscaler.lane`` and swaps
    between them under quiesce.
    """

    def __init__(self, zoo: ZooServer, *,
                 policy: BatchingPolicy | None = None,
                 n_slots: int = 2,
                 warm: bool = True,
                 warm_max_batch: int | None = None,
                 lane_pool: dict[int, Executor] | None = None,
                 autoscaler: SloAutoscaler | None = None,
                 stats_window: int = 100_000) -> None:
        super().__init__(zoo, policy=policy, stats_window=stats_window)
        if n_slots < 1:
            raise ValueError(f"need n_slots >= 1, got {n_slots}")
        self.n_slots = int(n_slots)
        self.lane_pool = dict(lane_pool) if lane_pool else None
        self.autoscaler = autoscaler
        if autoscaler is not None:
            if not self.lane_pool:
                raise ValueError("an autoscaler needs a lane_pool to scale")
            missing = sorted(set(autoscaler.lanes) - set(self.lane_pool))
            if missing:
                raise ValueError(
                    f"autoscaler lanes {missing} missing from lane_pool")
        if warm_max_batch is None and warm:
            warm_max_batch = getattr(self.policy, "max_batch", None)
        self._warm_to = int(warm_max_batch) if warm and warm_max_batch else None
        self._warmed: dict[int, tuple[int, ...]] = {}   # id(executor) -> ladder
        self._slots_q: asyncio.Queue | None = None
        self._slot_tasks: list[asyncio.Task] = []
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._pending_lanes: int | None = None
        self._lanes = autoscaler.lane if autoscaler is not None else \
            (min(self.lane_pool) if self.lane_pool else 1)
        self._executing = 0
        self._peak_executing = 0
        self._scale_ups = 0
        self._scale_downs = 0
        self.add_stats_source("engine", self._engine_stats)

    # ----------------------------------------------------------- lifecycle
    async def start(self) -> "ContinuousZooServer":
        await super().start()       # events + the cutter task (_dispatch_loop)
        loop = asyncio.get_running_loop()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.n_slots, thread_name_prefix="dispatch-slot")
        # bounded: the cutter may run at most n_slots cuts ahead of the
        # slowest slot — backpressure instead of unbounded coalesced
        # batches piling up behind a stalled executor
        self._slots_q = asyncio.Queue(maxsize=self.n_slots)
        self._slot_tasks = [
            loop.create_task(self._slot_worker(), name=f"dispatch-slot-{i}")
            for i in range(self.n_slots)]
        if self.lane_pool is not None:
            self.runtime.executor = self.lane_pool[self._lanes]
        # warm the active executor's bucket ladder off-loop: every capture
        # happens before the first live dispatch, not under it
        await loop.run_in_executor(
            self._pool, self._warm_one, self.runtime.executor)
        return self

    # -------------------------------------------------- warmed-bucket cache
    def _passthrough(self, b: int) -> PacketBatch:
        """A zero-filled FORWARD batch of ``b`` packets: the plane forwards
        it untouched (admission's padding invariant), so warming classifies
        nothing — it only captures the bucket's graph."""
        pb = self.zoo.make_request(
            np.zeros((b, self.zoo.profile.max_features), np.int32))
        return dataclasses.replace(pb, ptype=torch.zeros((b,),
                                                         dtype=torch.int32))

    def _warm_one(self, executor: Executor) -> tuple[int, ...]:
        """Capture ``executor``'s bucket ladder (blocking; pool thread).
        Keyed per executor so each lane in the pool warms exactly once."""
        if self._warm_to is None:
            return ()
        key = id(executor)
        if key not in self._warmed:
            # a throwaway facade over the target executor: the graph cache
            # lives in the executor itself, so warming through it warms the
            # lane
            self._warmed[key] = DataplaneRuntime(executor).warm(
                self._passthrough, self._warm_to)
        return self._warmed[key]

    @property
    def warmed_buckets(self) -> tuple[int, ...]:
        """Bucket ladder warmed for the currently active executor."""
        return self._warmed.get(id(self.runtime.executor), ())

    # --------------------------------------------------------- autoscaling
    @property
    def lanes(self) -> int:
        """Current port-lane width (1 when no lane_pool is configured)."""
        return self._lanes

    async def _apply_scale(self, loop) -> None:
        lanes = self._pending_lanes
        self._pending_lanes = None
        if lanes is None or lanes == self._lanes:
            return
        incoming = self.lane_pool[lanes]
        # pre-warm the incoming lane first (off-loop, overlapping live
        # traffic), then quiesce: no dispatch may straddle the swap
        await loop.run_in_executor(self._pool, self._warm_one, incoming)
        await self._idle.wait()
        if lanes > self._lanes:
            self._scale_ups += 1
        else:
            self._scale_downs += 1
        self.runtime.executor = incoming
        self._lanes = lanes

    def _observe(self, t_done: float, reqs: list[_Pending]) -> None:
        if self.autoscaler is None:
            return
        decision = None
        for p in reqs:
            d = self.autoscaler.observe((t_done - p.t_submit) * 1e3)
            if d is not None:
                decision = d
        if decision is not None:
            self._pending_lanes = decision
            self._arrival.set()      # wake an idle cutter to apply it

    # ------------------------------------------------------------ dispatch
    async def _dispatch_loop(self) -> None:
        """The cutter: policy wait -> cut -> coalesce -> hand to a slot.
        Never blocks on the executor — that is the slot workers' job."""
        loop = asyncio.get_running_loop()
        while True:
            if self._pending_lanes is not None and self._hold_gate.is_set():
                await self._apply_scale(loop)
                continue
            if not self._queue:
                if self._closing:
                    break
                self._arrival.clear()
                await self._arrival.wait()
                continue
            if not self._hold_gate.is_set():
                # held by the control plane's drain/reinstall barrier;
                # stop() sets the gate, so a closing server still flushes
                await self._hold_gate.wait()
                continue
            cut = await self._next_cut(loop)
            if cut is None:
                continue
            reqs, flat, offsets = cut
            # in-flight from the moment it leaves the queue: drain() must
            # wait for slot-queued work too, or a reinstall could race a
            # batch that was cut but not yet picked up
            self._inflight += 1
            self._idle.clear()
            await self._slots_q.put(_Work(reqs, flat, offsets,
                                          self._dispatch(flat, loop.time())))
        # closing: stop the slot workers after the queued work lands
        for _ in self._slot_tasks:
            await self._slots_q.put(None)
        await asyncio.gather(*self._slot_tasks)
        self._slot_tasks = []
        self._pool.shutdown(wait=False)

    async def _slot_worker(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            work = await self._slots_q.get()
            if work is None:
                return
            reqs, rec = work.reqs, work.rec
            rec.t_pickup = loop.time()
            self._executing += 1
            self._peak_executing = max(self._peak_executing, self._executing)
            try:
                rslt, codes, acc = await loop.run_in_executor(
                    self._pool, self._classify_flat, work.flat, rec)
            except Exception as e:   # executor died: fail this batch only
                self._fail(reqs, e)
                continue
            finally:
                self._executing -= 1
                self._inflight -= 1
                if self._inflight == 0:
                    self._idle.set()
            rec.t_resume = loop.time()
            self._finish_dispatch(reqs, work.offsets, rslt, codes, acc, rec)
            self._observe(rec.t_resume, reqs)

    # --------------------------------------------------------------- stats
    def _engine_stats(self) -> dict:
        return {
            "slots": self.n_slots,
            "lanes": self._lanes,
            "scale_ups": self._scale_ups,
            "scale_downs": self._scale_downs,
            "warmed_buckets": list(self.warmed_buckets),
            "peak_concurrent_dispatches": self._peak_executing,
        }
