"""Traffic kind ``open_loop``: requests of ``min_packets`` to
``max_packets`` packets arrive on a Poisson schedule at ``rate_rps``, fixed
from the seed, fired by ``clients`` coroutines whether or not earlier ones
were answered, into the program's continuous-batching front
(``ContinuousZooServer.submit_batch``, its slots and policy as ``front``
says).  A share ``forward_share`` of the packets are FORWARD packets, which
must come back untouched.  Each request's latency runs from its scheduled
arrival to its answer in the client's hands; requests in flight at the
window's close are waited for, ``GRACE_S`` at most.
"""
from __future__ import annotations

import asyncio
import time

import numpy as np

from portbench import devtrace, drivers
from portbench.drivers import Outcome


class Driver:
    def __init__(self, dep, mix: dict, seed: int) -> None:
        self.dep, self.mix, self.seed = dep, mix, seed
        rng = np.random.default_rng([seed, 2])
        sizes = rng.integers(mix["min_packets"], mix["max_packets"] + 1,
                             mix["pool"])
        self.pool = [drivers.make_packets(dep, rng, int(s),
                                          mix["forward_share"])
                     for s in sizes]

    def warm(self) -> None:
        """Nothing beyond the front's own warm-up (every bucket of its
        ladder, captured as it starts)."""

    def window(self, seconds: float, tracer: devtrace.Tracer | None) -> Outcome:
        return asyncio.run(self._serve(seconds, tracer))

    def _schedule(self, seconds: float):
        """Arrival offsets in [0, seconds) and each arrival's pool entry."""
        rng = np.random.default_rng([self.seed, 3])
        rate = self.mix["rate_rps"]
        t = rng.exponential(1.0 / rate, int(rate * seconds * 1.2) + 64).cumsum()
        while t[-1] < seconds:
            t = np.concatenate([t, t[-1] + rng.exponential(
                1.0 / rate, int(rate) + 64).cumsum()])
        t = t[t < seconds]
        which = rng.integers(0, len(self.pool), t.size)
        check = rng.random(t.size) < drivers.CHECK_SHARE
        return t, which, check

    async def _serve(self, seconds: float, tracer) -> Outcome:
        from repro_torch.runtime import SizeOrDeadlinePolicy
        from repro_torch.serving import ContinuousZooServer

        mix, zoo = self.mix, self.dep.zoo
        arrivals, which, check = self._schedule(seconds)
        n = arrivals.size
        front = mix["front"]
        srv = ContinuousZooServer(
            zoo, policy=SizeOrDeadlinePolicy(
                max_batch=front["max_batch"], max_wait_us=front["max_wait_us"]),
            n_slots=front["n_slots"], stats_window=2 * n + 1024)
        await srv.start()
        loop = asyncio.get_running_loop()
        lat = np.full(n, np.inf)
        late = np.zeros(n)
        answers = []
        traced = tracer is not None
        t0 = 0.0

        async def fire(i: int) -> None:
            late[i] = (loop.time() - t0 - arrivals[i]) * 1e3
            p = self.pool[which[i]]
            with devtrace.span("make_request", traced):
                pb = p.request(zoo)
            r = await srv.submit_batch(pb)
            lat[i] = (loop.time() - t0 - arrivals[i]) * 1e3
            if check[i]:
                answers.append((int(which[i]), r.rslt.copy(),
                                r.codes.view(np.int32).copy(),
                                r.svm_acc.copy()))

        # only the requests in flight are held, as a client would hold them
        inflight: set[asyncio.Task] = set()
        failed = 0

        def landed(task: asyncio.Task) -> None:
            nonlocal failed
            inflight.discard(task)
            if task.cancelled() or task.exception() is not None:
                failed += 1

        async def client(idxs: range) -> None:
            for i in idxs:
                delay = t0 + arrivals[i] - loop.time()
                if delay > 0:
                    await asyncio.sleep(delay)
                task = loop.create_task(fire(i))
                inflight.add(task)
                task.add_done_callback(landed)

        snap = {}

        async def trace() -> None:
            await asyncio.sleep(tracer.begin)
            # the front's counters up to here, before the profiler slows it
            snap.update(srv.latency_stats())
            tracer.start()
            await asyncio.sleep(tracer.seconds)
            tracer.stop()

        k = mix["clients"]
        with drivers.GcPauses() as pauses:
            t_start = time.perf_counter()
            t0 = loop.time()
            side = [loop.create_task(trace())] if traced else []
            await asyncio.gather(*[client(range(c, n, k)) for c in range(k)])
            t_end = time.perf_counter()
            if inflight:
                _, unanswered = await asyncio.wait(set(inflight),
                                                   timeout=drivers.GRACE_S)
                for t in unanswered:
                    t.cancel()      # counted failed as it lands
                if unanswered:
                    await asyncio.wait(unanswered)
            await asyncio.gather(*side)
            await srv.stop()
        return Outcome(
            t_start=t_start, seconds=t_end - t_start, attempted=n,
            failed=failed, packets=sum(self.pool[w].n for w in which),
            answers=answers, latencies_ms=lat, late_ms=late,
            stats=snap or srv.latency_stats(),
            slice=tracer.slice if tracer else None, gc_pauses=pauses.pauses)
