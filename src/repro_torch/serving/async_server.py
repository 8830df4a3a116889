"""``AsyncZooServer`` — the live request-stream front over a model zoo.

Port of ``src/repro/serving/async_server.py``.  What differs: requests are
host ``PacketBatch``es of torch tensors, coalesced on the host; a dispatch
classifies through ``DataplaneRuntime.run_host``, which pads straight into a
pinned buffer, replays the bucket's captured CUDA graph and lands the
result in pinned memory (``runtime/facade.py``); results are numpy arrays,
``codes`` as uint32 as in the reference.  The executor's lock serialises
replays of one executor (``runtime/graphs.py``), so the worker threads of
``run_in_executor`` never share a graph's static buffers.

The paper's serving story is end-to-end: models deploy once, then traffic
arrives *continuously* and is classified at line rate (§1, §6).  The batch
entry points (``ZooServer.classify``, the examples) model one tenant handing
the plane a ready-made batch; this module models the plane's actual ingress
side — many concurrent clients each submitting small ragged batches on an
asyncio event loop, a ``BatchingPolicy`` (``repro_torch.runtime.policies``)
deciding when to cut a batch, and the runtime's coalesce seam
(``DataplaneRuntime.coalesce`` / ``run``) turning the cut into exactly one
admitted bucket dispatch.

Data path of one dispatch::

    submit(feats) --+                            +--> future.set_result
    submit(feats) --+-> queue -> policy decides -+--> future.set_result
    submit(feats) --+   (cut)    coalesce->run   +--> future.set_result
                                 demux rslt/codes/svm_acc by offsets

Invariants (pinned for the port in ``tests/test_torch_async_serving.py``
and ``tests/test_torch_fronts_conformance.py``):

* **bit-identity** — every request's ``rslt``/``codes``/``svm_acc`` equal a
  synchronous ``DataplaneRuntime`` classify of the same packets, whatever
  the policy coalesced them with;
* **whole requests** — a client's batch is never split across dispatches;
* **O(log B) graphs** — dispatch sizes hit the executor only through
  admission bucketing, so a traffic storm captures no new graphs;
* the blocking executor call runs in a worker thread
  (``loop.run_in_executor``), so the event loop keeps accepting submits
  while a batch classifies — that concurrency is where size-or-deadline
  coalescing beats per-request dispatch at high offered load;
* **no future is left pending** — ``stop()`` flushes the queue through a
  final dispatch, and any straggler that slipped in around the final drain
  cut (or survived an externally-cancelled dispatch loop) is
  fail-or-flushed deterministically before ``stop()`` returns.

Hold ownership: ``drain()``/``hold()`` give the control plane an exclusive
dispatch barrier.  ``stop()`` on a held server must still flush (a dying
server cannot wait on a holder that may never come back), so it *breaks*
the hold — and the owner is told: its next ``release()`` raises
``RuntimeError`` instead of silently resuming a server that already
flushed through whatever half-installed state the holder was protecting.

``ContinuousZooServer`` (``repro_torch.serving.engine``) extends this class with
a persistent slot-pool dispatch engine; the cut/complete helpers below
(``_next_cut`` / ``_finish_dispatch`` / ``_fail``) are the shared seam.

Latency accounting: each request carries ``t_submit`` / ``t_dispatch`` /
``t_done`` (event-loop monotonic clock); ``latency_stats()`` aggregates
p50/p99/p99.9 end-to-end latency, queue wait, and mean coalesced batch
size.  Empty submits (B = 0) resolve without a dispatch but are counted —
rates and percentiles cover every accepted request, not just the queued
ones.  Each dispatch keeps a ``Dispatch`` record: its stamps on the same
clock from the cut to the dispatching coroutine resuming, and the spans
(``runtime/trace.py``) its worker thread ran, which ``latency_stats()``
turns into the dispatch's split by cause.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import time

import numpy as np

from repro_torch.core.packets import PacketBatch, u32_from_bits
from repro_torch.runtime import DataplaneRuntime, trace
from repro_torch.runtime.policies import BatchingPolicy, ImmediatePolicy
from repro_torch.serving.serve import ZooServer

__all__ = ["AsyncResult", "AsyncZooServer", "Dispatch"]


@dataclasses.dataclass
class AsyncResult:
    """One request's demuxed classification + its latency accounting.

    ``t_dispatch`` is its dispatch's pickup by a worker (``Dispatch``'s
    ``t_pickup``) and ``t_done`` the dispatching coroutine resuming with
    the results (``t_resume``).  ``latency_stats()``'s ``mean_dispatch_ms``
    is the mean of ``t_done - t_dispatch`` over the dispatches, and
    ``mean_to_thread_ms + mean_on_thread_ms + mean_to_loop_ms`` splits it;
    ``queue_wait_s`` includes the cut's wait for a free slot
    (``mean_slot_wait_ms``)."""

    rslt: np.ndarray      # int32 [B]
    codes: np.ndarray     # uint32 [B, T]
    svm_acc: np.ndarray   # int32 [B, H]
    t_submit: float       # event-loop clock (s)
    t_dispatch: float
    t_done: float

    @property
    def latency_s(self) -> float:
        """End-to-end: submit -> result available."""
        return self.t_done - self.t_submit

    @property
    def queue_wait_s(self) -> float:
        """Coalescing delay the batching policy charged this request."""
        return self.t_dispatch - self.t_submit


class Dispatch:
    """One dispatch's accounting.  Stamps on the event loop's clock
    (``time.monotonic``, s): ``t_cut``, the cut handed to a worker (to the
    slot queue of ``ContinuousZooServer``); ``t_pickup``, a worker taking it
    up (the base class's cut and pickup are one moment); ``t_start`` /
    ``t_end``, ``_classify_flat`` starting and returning on its thread;
    ``t_resume``, the dispatching coroutine resuming with the results.
    ``spans``: the seconds of each span the thread ran inside
    ``_classify_flat`` (``lock``, ``admit``, ``executor``, ``copy_out``,
    ...; ``runtime/trace.py``).  ``packets`` / ``bucket``: the batch's
    packets and its admission bucket's."""

    __slots__ = ("packets", "bucket", "t_cut", "t_pickup", "t_start",
                 "t_end", "t_resume", "spans")

    def __init__(self, packets: int, bucket: int, t_cut: float) -> None:
        self.packets = packets
        self.bucket = bucket
        self.t_cut = self.t_pickup = t_cut
        self.t_start = self.t_end = self.t_resume = t_cut
        self.spans: dict[str, float] = {}


class _Pending:
    __slots__ = ("pb", "future", "t_submit")

    def __init__(self, pb: PacketBatch, future: asyncio.Future,
                 t_submit: float) -> None:
        self.pb = pb
        self.future = future
        self.t_submit = t_submit


class AsyncZooServer:
    """Asyncio serving front over one ``ZooServer`` / ``DataplaneRuntime``.

    Construction does not start serving; use ``async with`` (or ``start()``
    / ``stop()``).  ``stop()`` drains: queued requests are flushed through a
    final dispatch before the loop exits, so no future is left pending.

    Control-plane writes (``install`` / ``evict``) pass through to the
    wrapped ``ZooServer`` — an install between dispatches is exactly the
    paper's runtime reprogrammability, now under live traffic.
    """

    def __init__(self, zoo: ZooServer, *,
                 policy: BatchingPolicy | None = None,
                 stats_window: int = 100_000) -> None:
        self.zoo = zoo
        self.policy = policy if policy is not None else ImmediatePolicy()
        self._queue: collections.deque[_Pending] = collections.deque()
        self._queued_packets = 0
        self._arrival: asyncio.Event | None = None
        self._hold_gate: asyncio.Event | None = None   # cleared = held
        self._idle: asyncio.Event | None = None        # set = no dispatch in flight
        self._inflight = 0
        self._task: asyncio.Task | None = None
        self._closing = False
        self._held = False            # a drain()/hold() owner is active
        self._hold_broken = False     # stop() force-released an owned hold
        self._stats_sources: dict[str, object] = {}
        # bounded: a long-lived front at line rate must not grow its
        # accounting without limit (stats_window = most recent requests /
        # dispatches retained; counters below keep lifetime totals)
        self._dispatch_log: collections.deque[Dispatch] = \
            collections.deque(maxlen=stats_window)
        self._latencies: collections.deque[float] = \
            collections.deque(maxlen=stats_window)
        self._queue_waits: collections.deque[float] = \
            collections.deque(maxlen=stats_window)
        self._total_requests = 0
        self._total_dispatches = 0

    @property
    def runtime(self) -> DataplaneRuntime:
        return self.zoo.runtime

    # ----------------------------------------------------------- lifecycle
    async def start(self) -> "AsyncZooServer":
        if self._task is not None:
            raise RuntimeError("server already started")
        self._closing = False
        self._held = False
        self._hold_broken = False
        self._arrival = asyncio.Event()
        self._hold_gate = asyncio.Event()
        self._hold_gate.set()
        self._idle = asyncio.Event()
        self._idle.set()
        self._task = asyncio.get_running_loop().create_task(
            self._dispatch_loop(), name="async-zoo-dispatch")
        return self

    async def stop(self) -> None:
        """Flush queued requests, then stop the dispatch loop.

        An owned ``hold()``/``drain()`` barrier is *broken* so the final
        drain can flush; the owner's next ``release()`` raises.  Requests
        that raced past the final drain cut — or were stranded by an
        externally-cancelled dispatch loop — are fail-or-flushed before
        this returns: no future is ever left pending.
        """
        if self._task is None:
            return
        self._closing = True
        if self._held:
            # a control-plane drain still owns the barrier; break it and
            # remember — the owner's release() must raise, not silently
            # resume a server that flushed through its half-done reinstall
            self._held = False
            self._hold_broken = True
        self._hold_gate.set()
        self._arrival.set()
        task, self._task = self._task, None
        try:
            await task
        except asyncio.CancelledError:
            if not task.cancelled():
                raise           # stop() itself was cancelled
            # the dispatch loop was killed out from under us (external
            # cancel / loop teardown): its queue is flushed below
        await self._flush_stragglers()

    async def __aenter__(self) -> "AsyncZooServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -------------------------------------------------------- control plane
    def install(self, model_or_program, *, vid: int, tag: str = "") -> int:
        return self.zoo.install(model_or_program, vid=vid, tag=tag)

    def evict(self, *, vid: int, kind: str = "all") -> None:
        self.zoo.evict(vid=vid, kind=kind)

    # ------------------------------------------------------ quiesce seam
    # The control plane's drain/reinstall barrier (``ControlLoop`` of
    # repro_torch.runtime.control, driven by serving/fleet.py):
    # hold() pauses cutting new dispatches (submits keep queuing), drain()
    # additionally waits for every in-flight dispatch to land, release()
    # resumes.  Nothing is dropped — held requests dispatch after release.
    def hold(self) -> None:
        """Pause new dispatches; queued and new submits wait for release()."""
        if self._hold_gate is None:
            raise RuntimeError("AsyncZooServer is not serving")
        if self._closing:
            # a hold taken now would stall the final flush forever
            raise RuntimeError("AsyncZooServer is stopping — hold unavailable")
        self._held = True
        self._hold_gate.clear()

    def release(self) -> None:
        """Resume dispatching after a hold().  Raises if ``stop()`` broke
        the hold meanwhile — the barrier the caller thought it owned did
        not survive shutdown, and whatever it was protecting (a reinstall,
        a swap) may have raced the final flush."""
        if self._hold_gate is None:
            raise RuntimeError("AsyncZooServer is not serving")
        if self._hold_broken:
            self._hold_broken = False
            raise RuntimeError(
                "hold was broken by stop(): the server flushed and shut "
                "down while the control plane still owned the drain barrier")
        self._held = False
        self._hold_gate.set()

    async def drain(self) -> None:
        """Quiesce for a control-plane write: hold new dispatches and wait
        until every in-flight dispatch completes.  The caller owns the
        hold and must release() when its reinstall is done.  Raises
        ``RuntimeError`` on a stopping server — a drain barrier cannot be
        granted while the final flush is running."""
        if self._hold_gate is None:
            raise RuntimeError("AsyncZooServer is not serving")
        if self._closing or self._task is None or self._task.done():
            raise RuntimeError(
                "AsyncZooServer is stopping — drain unavailable")
        self.hold()
        await self._idle.wait()

    def add_stats_source(self, name: str, fn) -> None:
        """Register a named zero-arg stats provider whose dict is merged
        into ``latency_stats()`` under ``name`` — the control plane's
        failure/replan/drain counters ride this path."""
        if name in self._stats_sources:
            raise ValueError(f"stats source {name!r} already registered")
        self._stats_sources[name] = fn

    # -------------------------------------------------------------- submit
    async def submit(self, features, *, mid: int = 0, vid=0) -> AsyncResult:
        """Classify one client's ragged feature batch; resolves when the
        batching policy's dispatch completes."""
        return await self.submit_batch(
            self.zoo.make_request(features, mid=mid, vid=vid))

    async def submit_batch(self, pb: PacketBatch) -> AsyncResult:
        """Classify one pre-built ``PacketBatch`` (arbitrary ptype/vid mixes
        — the conformance harness's entry point)."""
        if self._task is None or self._task.done() or self._closing:
            # _task.done() covers a dispatch loop that died out from under
            # us (external cancel): enqueueing now would strand the future
            # until stop() — fail fast instead
            raise RuntimeError("AsyncZooServer is not serving — use "
                               "'async with AsyncZooServer(zoo) as srv'")
        loop = asyncio.get_running_loop()
        now = loop.time()
        if pb.batch == 0:
            # empty submit: nothing to classify, resolve immediately — but
            # it is still an accepted request; rates and percentiles must
            # not silently exclude it
            self._total_requests += 1
            self._latencies.append(0.0)
            self._queue_waits.append(0.0)
            return AsyncResult(
                rslt=np.empty((0,), np.int32),
                codes=u32_from_bits(pb.codes),
                svm_acc=pb.svm_acc.cpu().numpy(),
                t_submit=now, t_dispatch=now, t_done=now)
        pending = _Pending(pb, loop.create_future(), now)
        self._queue.append(pending)
        self._queued_packets += pb.batch
        self._arrival.set()
        return await pending.future

    # ------------------------------------------------------------ dispatch
    def _dispatch(self, flat: PacketBatch, t_cut: float) -> Dispatch:
        return Dispatch(flat.batch, self.runtime.bucket(flat.batch), t_cut)

    def _classify_flat(self, flat: PacketBatch, rec: Dispatch):
        """The blocking half of a dispatch, on a worker thread: its spans
        are added to ``rec``."""
        rec.t_start = time.monotonic()
        with trace.recording(rec.spans):
            # run_host: one padded-result transfer, host-side trim
            out = self.runtime.run_host(flat)
            res = (out.rslt.numpy(), u32_from_bits(out.codes),
                   out.svm_acc.numpy())
        rec.t_end = time.monotonic()
        return res

    def _cut_batch(self) -> list[_Pending]:
        """Pop whole requests up to the policy's drain limit (>= 1 request)."""
        limit = max(int(self.policy.drain(self._queued_packets)), 1)
        reqs: list[_Pending] = []
        taken = 0
        while self._queue and (
                not reqs or taken + self._queue[0].pb.batch <= limit):
            p = self._queue.popleft()
            reqs.append(p)
            taken += p.pb.batch
        self._queued_packets -= taken
        return reqs

    @staticmethod
    def _fail(reqs: list[_Pending], exc: BaseException) -> None:
        for p in reqs:
            if not p.future.done():
                p.future.set_exception(exc)

    async def _next_cut(self, loop):
        """Policy wait phase + cut + coalesce: the front half of one
        dispatch.  Returns ``(reqs, flat, offsets)``, or ``None`` when the
        queue emptied under the wait.  A broken ``BatchingPolicy`` (it is a
        user-implementable protocol) or coalesce failure fails the affected
        futures loudly and returns ``None`` — the caller keeps serving.
        (CancelledError is a BaseException and still propagates.)"""
        reqs: list[_Pending] = []
        try:
            # hold for more traffic until the policy says cut (or the
            # server is draining on stop())
            while self._queue and not self._closing:
                age_us = (loop.time() - self._queue[0].t_submit) * 1e6
                w = self.policy.wait_us(self._queued_packets, age_us)
                if w <= 0:
                    break
                self._arrival.clear()
                try:
                    await asyncio.wait_for(self._arrival.wait(), w / 1e6)
                except (asyncio.TimeoutError, TimeoutError):
                    break   # deadline: cut what we have
            if not self._queue:
                return None
            with trace.span("cut"):
                reqs = self._cut_batch()
                flat, offsets = self.runtime.coalesce([p.pb for p in reqs])
        except Exception as e:
            if not reqs:        # failed before the cut: fail the queue
                reqs = list(self._queue)
                self._queue.clear()
                self._queued_packets = 0
            self._fail(reqs, e)
            return None
        return reqs, flat, offsets

    def _finish_dispatch(self, reqs: list[_Pending], offsets, rslt, codes,
                         acc, rec: Dispatch) -> None:
        """Back half of one dispatch: policy feedback, accounting, demux.
        A broken ``note_dispatch`` hook fails the batch's futures (the
        results are already computed, but the policy contract was violated
        — surface it) and leaves the server serving."""
        t_dispatch, t_done = rec.t_pickup, rec.t_resume
        with trace.span("demux"):
            try:
                self.policy.note_dispatch(
                    rec.packets, (t_dispatch - reqs[0].t_submit) * 1e6)
            except Exception as e:   # broken feedback hook: surface it
                self._fail(reqs, e)
                return
            self._dispatch_log.append(rec)
            self._total_dispatches += 1
            for p, lo, hi in zip(reqs, offsets, offsets[1:]):
                self._total_requests += 1
                self._latencies.append(t_done - p.t_submit)
                self._queue_waits.append(t_dispatch - p.t_submit)
                if not p.future.done():   # client may have been cancelled
                    p.future.set_result(AsyncResult(
                        rslt=rslt[lo:hi], codes=codes[lo:hi],
                        svm_acc=acc[lo:hi], t_submit=p.t_submit,
                        t_dispatch=t_dispatch, t_done=t_done))

    async def _dispatch_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            if not self._queue:
                if self._closing:
                    return
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
            rec = self._dispatch(flat, loop.time())
            self._inflight += 1
            self._idle.clear()
            try:
                rslt, codes, acc = await loop.run_in_executor(
                    None, self._classify_flat, flat, rec)
            except Exception as e:  # executor died: fail this batch's futures
                self._fail(reqs, e)
                continue
            finally:
                self._inflight -= 1
                if self._inflight == 0:
                    self._idle.set()
            rec.t_resume = loop.time()
            self._finish_dispatch(reqs, offsets, rslt, codes, acc, rec)

    async def _flush_stragglers(self) -> None:
        """Deterministic fail-or-flush of requests still queued after the
        dispatch loop exited — the shutdown-race backstop.  Each round is
        classified through the same ``run_host`` path (flush), and any
        failure fails that round's futures (fail); either way every future
        resolves before ``stop()`` returns."""
        loop = asyncio.get_running_loop()
        while self._queue:
            reqs = list(self._queue)
            self._queue.clear()
            self._queued_packets = 0
            try:
                flat, offsets = self.runtime.coalesce([p.pb for p in reqs])
                rec = self._dispatch(flat, loop.time())
                rslt, codes, acc = await loop.run_in_executor(
                    None, self._classify_flat, flat, rec)
            except Exception as e:
                self._fail(reqs, e)
                continue
            rec.t_resume = loop.time()
            self._finish_dispatch(reqs, offsets, rslt, codes, acc, rec)

    # --------------------------------------------------------------- stats
    def latency_stats(self) -> dict:
        """Aggregate latency accounting: p50/p99/p99.9 end-to-end, queue
        wait, dispatch count, mean coalesced batch size and (the port's
        additions) a dispatch's mean time and its split by cause, from its
        ``Dispatch`` records (ms): ``mean_dispatch_ms``, from a worker's
        pickup to the dispatching coroutine resuming, is
        ``mean_to_thread_ms`` (the pickup to ``_classify_flat`` starting on
        its thread) + ``mean_on_thread_ms`` (``_classify_flat`` on its
        thread, of it ``mean_lock_wait_ms`` waiting for the executor's
        lock) + ``mean_to_loop_ms`` (its return to the coroutine
        resuming); ``mean_slot_wait_ms``, the cut to the pickup;
        ``pad_share``, the admission buckets' padding over their packets.
        ``requests`` / ``dispatches`` are lifetime totals; the distribution
        numbers cover the most recent ``stats_window`` of each.  Registered
        stats sources (``add_stats_source``) are merged in as nested dicts
        — the control plane's counters appear under ``"control"``, the
        continuous engine's under ``"engine"``."""
        lat = np.asarray(self._latencies, float)
        if lat.size == 0:
            out = {"requests": self._total_requests,
                   "dispatches": self._total_dispatches}
        else:
            waits = np.asarray(self._queue_waits, float)
            d = np.asarray([(r.packets, r.bucket, r.t_cut, r.t_pickup,
                             r.t_start, r.t_end, r.t_resume,
                             r.spans.get("lock", 0.0))
                            for r in self._dispatch_log], float).reshape(-1, 8)
            packets, bucket, cut, pickup, start, end, resume, lock = d.T

            def mean_ms(x) -> float:
                return float(x.mean() * 1e3) if x.size else 0.0
            out = {
                "requests": self._total_requests,
                "dispatches": self._total_dispatches,
                "p50_ms": float(np.percentile(lat, 50) * 1e3),
                "p99_ms": float(np.percentile(lat, 99) * 1e3),
                "p999_ms": float(np.percentile(lat, 99.9) * 1e3),
                "mean_ms": float(lat.mean() * 1e3),
                "p50_wait_ms": float(np.percentile(waits, 50) * 1e3),
                "mean_batch_packets": float(packets.mean())
                if packets.size else 0.0,
                "mean_dispatch_ms": mean_ms(resume - pickup),
                "mean_slot_wait_ms": mean_ms(pickup - cut),
                "mean_to_thread_ms": mean_ms(start - pickup),
                "mean_on_thread_ms": mean_ms(end - start),
                "mean_lock_wait_ms": mean_ms(lock),
                "mean_to_loop_ms": mean_ms(resume - end),
                "pad_share": float((bucket - packets).sum() / bucket.sum())
                if packets.size else 0.0,
            }
        for name, fn in self._stats_sources.items():
            out[name] = fn()
        return out
