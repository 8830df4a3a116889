"""Open-loop load generation for the async serving fronts.

Port of ``src/repro/serving/loadgen.py`` (numpy and asyncio only; the port
keeps its own copy).

Wire traffic does not wait for the switch: packets arrive on the arrival
process's schedule whether or not earlier ones were answered.  A
*closed-loop* client (fire, await, fire again) silently throttles itself
when the server slows down — the coordinated-omission trap that makes a
saturated server look fast.  This generator is **open-loop**: request
``i``'s arrival time is fixed up front from the process, ``n_clients``
client coroutines fire their assigned arrivals on schedule, and latency is
measured from the *scheduled arrival* to completion — queueing delay the
server (or a lagging event loop) causes is charged to the request, never
silently dropped from the distribution.

Arrival processes:

* ``"poisson"`` — i.i.d. exponential inter-arrivals at ``rate_rps``
  (memoryless line-rate traffic, the ACORN serving model);
* ``"burst"``   — ``burst``-sized arrival clumps whose gaps keep the same
  mean rate (exponential between clumps): the bursty edge traffic that a
  coalescing policy amortizes and a per-request policy drowns under.

The ``submit`` callable is anything awaitable per request (typically
``lambda i: srv.submit(...)``) — the generator is server-agnostic so
benchmarks can drive ``AsyncZooServer``, ``ContinuousZooServer``, or a
stub.  Percentiles cover successful requests; failures are counted, not
hidden (``chip_smoke.py`` phase 11 prints the full report row).
"""
from __future__ import annotations

import asyncio
import dataclasses

import numpy as np

__all__ = ["LoadReport", "arrival_times", "open_loop"]


@dataclasses.dataclass
class LoadReport:
    """One open-loop trial's outcome, coordinated-omission-free."""

    offered_rps: float
    achieved_rps: float       # completed requests / wall span
    requests: int
    errors: int
    duration_s: float
    p50_ms: float
    p99_ms: float
    p999_ms: float
    mean_ms: float

    def row(self) -> dict:
        """The report as a JSON row."""
        return {k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in dataclasses.asdict(self).items()}


def arrival_times(n: int, rate_rps: float, *, process: str = "poisson",
                  burst: int = 8, rng=None) -> np.ndarray:
    """Scheduled arrival offsets (seconds from t0) for ``n`` requests at a
    mean of ``rate_rps``, under the given arrival process."""
    if n < 1:
        raise ValueError(f"need n >= 1 requests, got {n}")
    if rate_rps <= 0:
        raise ValueError(f"need rate_rps > 0, got {rate_rps}")
    rng = np.random.default_rng(0) if rng is None else rng
    if process == "poisson":
        return rng.exponential(1.0 / rate_rps, n).cumsum()
    if process == "burst":
        if burst < 1:
            raise ValueError(f"need burst >= 1, got {burst}")
        n_bursts = -(-n // burst)
        gaps = rng.exponential(burst / rate_rps, n_bursts).cumsum()
        return np.repeat(gaps, burst)[:n]
    raise ValueError(f"unknown arrival process {process!r}")


async def open_loop(submit, *, rate_rps: float, n_requests: int,
                    n_clients: int = 8, process: str = "poisson",
                    burst: int = 8, seed: int = 0) -> LoadReport:
    """Drive ``await submit(i)`` open-loop and report the latency
    distribution.

    Arrivals are split round-robin across ``n_clients`` client coroutines
    (each client's schedule stays sorted, so it only ever sleeps forward);
    every request is fired as its own task at its scheduled time and never
    awaited before the next fires — offered load is what the schedule
    says, not what the server sustains.
    """
    if n_clients < 1:
        raise ValueError(f"need n_clients >= 1, got {n_clients}")
    rng = np.random.default_rng(seed)
    arrivals = arrival_times(n_requests, rate_rps, process=process,
                             burst=burst, rng=rng)
    loop = asyncio.get_running_loop()
    latencies: list[float | None] = [None] * n_requests
    errors = 0
    tasks: list[asyncio.Task] = []
    t0 = loop.time()

    async def fire(i: int) -> None:
        nonlocal errors
        try:
            await submit(i)
        except Exception:
            errors += 1
            return
        # from the *scheduled* arrival: a late fire or a slow server both
        # count as latency (no coordinated omission)
        latencies[i] = loop.time() - (t0 + arrivals[i])

    async def client(idxs: range) -> None:
        for i in idxs:
            delay = t0 + arrivals[i] - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            tasks.append(loop.create_task(fire(i)))

    await asyncio.gather(*[client(range(c, n_requests, n_clients))
                           for c in range(n_clients)])
    if tasks:
        await asyncio.gather(*tasks)
    span = loop.time() - t0
    ok = np.asarray([l for l in latencies if l is not None], float)
    if ok.size:
        p50, p99, p999 = (float(np.percentile(ok, q) * 1e3)
                          for q in (50, 99, 99.9))
        mean = float(ok.mean() * 1e3)
    else:
        p50 = p99 = p999 = mean = float("nan")
    return LoadReport(
        offered_rps=float(rate_rps),
        achieved_rps=ok.size / span if span > 0 else float("nan"),
        requests=n_requests, errors=errors, duration_s=span,
        p50_ms=p50, p99_ms=p99, p999_ms=p999, mean_ms=mean)
