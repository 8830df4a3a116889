"""The port's continuous-batching engine and open-loop load generator
against the JAX package's (``tests/test_engine.py``, ported).

Every coroutine runs through ``asyncio.run(..., debug=True)``.  The
engine's mechanics are the reference's tests run on the port, over a zoo
that holds the JAX zoo's tables, each answer held to the JAX ``ZooServer``:
dispatches overlap (a thread barrier only two concurrent executor calls
release: it sits outside the executor's lock), one slot never overlaps,
every admission bucket is captured before traffic and live dispatches add
no entry, lane scale events are quiesced and answer-preserving (the lane
pool holds single-switch executors programmed with the same zoo), and the
load generator charges latency from the scheduled arrival.  The port's
``arrival_times`` must give the reference's arrays for the same seed.
"""
import asyncio
import threading

import numpy as np
import pytest

from repro.core.mlmodels import DecisionTree
from repro.core.plane import PlaneProfile as JaxProfile
from repro.serving import ZooServer as JaxZooServer
from repro.serving import loadgen as jloadgen
from repro_torch.runtime import (
    ImmediatePolicy,
    SingleSwitchExecutor,
    SizeOrDeadlinePolicy,
    SloAutoscaler,
    bucket_ladder,
)
from repro_torch.serving import (
    ContinuousZooServer,
    LoadReport,
    ZooServer,
    arrival_times,
    open_loop,
)
from test_torch_plane import port_packed, port_profile


def run_async(coro):
    """All async tests run under asyncio debug (strict) mode."""
    return asyncio.run(coro, debug=True)


def _profile(V=2):
    return JaxProfile(max_features=36, max_trees=4, max_layers=6,
                      max_entries_per_layer=64, max_leaves=64,
                      max_classes=8, max_hyperplanes=8, max_versions=V)


@pytest.fixture(scope="module")
def jzoo(satdap):
    """The reference's zoo, in the JAX package: the answers."""
    Xtr, ytr, _, _ = satdap
    z = JaxZooServer(_profile())
    z.install(DecisionTree(max_depth=4, max_leaf_nodes=16).fit(Xtr, ytr),
              vid=0)
    return z


def _mk_zoo(jzoo):
    """A port zoo on the CPU holding the JAX zoo's tables."""
    jprof = jzoo.profile
    return ZooServer(port_profile(jprof), executor=SingleSwitchExecutor(
        port_profile(jprof), device="cpu",
        packed=port_packed(jzoo.packed, jprof)))


@pytest.fixture(scope="module")
def zoo(jzoo):
    return _mk_zoo(jzoo)


# ----------------------------------------------------------- slot pool
def test_continuous_results_bit_identical_and_demuxed(zoo, jzoo, satdap):
    """Concurrent ragged submits through the slot pool demux to exactly the
    synchronous per-batch results — same invariant as the base server."""
    _, _, Xte, _ = satdap
    chunks = [(0, 7), (7, 8), (8, 29), (29, 61), (61, 64)]

    async def main():
        async with ContinuousZooServer(
                zoo, policy=SizeOrDeadlinePolicy(max_batch=64,
                                                 max_wait_us=2_000),
                n_slots=2) as srv:
            outs = await asyncio.gather(
                *[srv.submit(Xte[lo:hi], mid=0, vid=0)
                  for lo, hi in chunks])
            return outs, srv.latency_stats()

    outs, stats = run_async(main())
    for out, (lo, hi) in zip(outs, chunks):
        np.testing.assert_array_equal(
            out.rslt, jzoo.classify(Xte[lo:hi], mid=0, vid=0))
        assert out.t_submit <= out.t_dispatch <= out.t_done
    assert stats["requests"] == len(chunks)
    assert stats["engine"]["slots"] == 2


def test_slot_pool_overlaps_dispatches(zoo, jzoo, satdap):
    """The overlap the engine exists for, proven with a thread barrier that
    only releases when TWO executor calls are in flight at once: under the
    base one-at-a-time loop this would deadlock (and time out the
    barrier); under the slot pool both submits classify concurrently."""
    _, _, Xte, _ = satdap
    barrier = threading.Barrier(2, timeout=10)

    async def main():
        async with ContinuousZooServer(zoo, policy=ImmediatePolicy(),
                                       n_slots=2, warm=False) as srv:
            orig = srv.runtime.executor.classify

            def gated(pb):
                barrier.wait()      # released only by a concurrent peer
                return orig(pb)

            srv.runtime.executor.classify = gated
            try:
                outs = await asyncio.gather(
                    srv.submit(Xte[:2], mid=0, vid=0),
                    srv.submit(Xte[2:4], mid=0, vid=0))
            finally:
                srv.runtime.executor.classify = orig
            return outs, srv.latency_stats()

    outs, stats = run_async(asyncio.wait_for(main(), timeout=30))
    np.testing.assert_array_equal(outs[0].rslt,
                                  jzoo.classify(Xte[:2], mid=0, vid=0))
    np.testing.assert_array_equal(outs[1].rslt,
                                  jzoo.classify(Xte[2:4], mid=0, vid=0))
    assert stats["engine"]["peak_concurrent_dispatches"] == 2


def test_single_slot_never_overlaps(zoo, satdap):
    """n_slots bounds executor concurrency: with one slot the engine is
    continuous (cutting overlaps demux) but never runs two classifies."""
    _, _, Xte, _ = satdap

    async def main():
        async with ContinuousZooServer(zoo, policy=ImmediatePolicy(),
                                       n_slots=1, warm=False) as srv:
            await asyncio.gather(
                *[srv.submit(Xte[i:i + 2], mid=0, vid=0) for i in range(6)])
            return srv.latency_stats()

    stats = run_async(main())
    assert stats["engine"]["peak_concurrent_dispatches"] == 1
    assert stats["requests"] == 6


def test_continuous_stop_flushes_and_drain_quiesces(zoo, jzoo, satdap):
    """The base server's guarantees survive the slot pool: stop() flushes a
    deadline-parked queue, and drain() waits for slot-queued work too."""
    _, _, Xte, _ = satdap

    async def main():
        srv = ContinuousZooServer(zoo, policy=SizeOrDeadlinePolicy(
            max_batch=4096, max_wait_us=60_000_000), n_slots=2, warm=False)
        await srv.start()
        tasks = [asyncio.create_task(srv.submit(Xte[i:i + 3], mid=0, vid=0))
                 for i in range(5)]
        await asyncio.sleep(0.01)
        await srv.drain()                   # all slots idle under the barrier
        inflight = srv._inflight
        srv.release()
        await srv.stop()                    # flushes through the closing cutter
        return inflight, await asyncio.gather(*tasks)

    inflight, outs = run_async(asyncio.wait_for(main(), timeout=30))
    assert inflight == 0
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(
            out.rslt, jzoo.classify(Xte[i:i + 3], mid=0, vid=0))


def test_engine_validation(zoo):
    with pytest.raises(ValueError, match="n_slots"):
        ContinuousZooServer(zoo, n_slots=0)
    with pytest.raises(ValueError, match="lane_pool"):
        ContinuousZooServer(zoo, autoscaler=SloAutoscaler(slo_p99_ms=1.0))
    with pytest.raises(ValueError, match="missing from lane_pool"):
        ContinuousZooServer(
            zoo, lane_pool={1: zoo.runtime.executor},
            autoscaler=SloAutoscaler(slo_p99_ms=1.0, lanes=(1, 2)))


# ------------------------------------------------- warmed-bucket cache
def test_warm_captures_every_bucket_before_traffic(jzoo, satdap):
    """Before the first live submit the engine has driven every
    ``granularity * 2^k`` bucket up to the policy's max_batch through the
    run_host seam — live dispatches then capture no new graph, and the
    zero-filled FORWARD warm traffic is semantically invisible."""
    _, _, Xte, _ = satdap
    z = _mk_zoo(jzoo)

    async def main():
        async with ContinuousZooServer(
                z, policy=SizeOrDeadlinePolicy(max_batch=16,
                                               max_wait_us=500.0)) as srv:
            ladder = srv.warmed_buckets
            entries_after_warm = z.cache_size()
            outs = await asyncio.gather(
                *[srv.submit(Xte[i:i + 3], mid=0, vid=0) for i in range(5)])
            return ladder, entries_after_warm, z.cache_size(), outs

    ladder, warmed, after, outs = run_async(main())
    assert ladder == bucket_ladder(16, 1) == (1, 2, 4, 8, 16)
    assert warmed == len(ladder)            # one entry per bucket
    assert after == warmed, "a live dispatch captured a new bucket"
    for i, out in enumerate(outs):          # warm passthroughs changed nothing
        np.testing.assert_array_equal(
            out.rslt, jzoo.classify(Xte[i:i + 3], mid=0, vid=0))


def test_warm_skipped_without_a_bounded_policy(zoo, jzoo, satdap):
    """ImmediatePolicy has no max_batch: nothing to warm against, and the
    engine must not guess — warmed_buckets stays empty."""
    _, _, Xte, _ = satdap

    async def main():
        async with ContinuousZooServer(zoo, policy=ImmediatePolicy()) as srv:
            out = await srv.submit(Xte[:2], mid=0, vid=0)
            return srv.warmed_buckets, out

    ladder, out = run_async(main())
    assert ladder == ()
    np.testing.assert_array_equal(out.rslt, jzoo.classify(Xte[:2], mid=0,
                                                         vid=0))


# --------------------------------------------------------- autoscaling
def test_slo_autoscaler_widens_and_narrows():
    a = SloAutoscaler(slo_p99_ms=10.0, lanes=(1, 2), window=4, patience=2,
                      narrow_margin=0.5, cooldown=0)
    assert a.lane == 1
    assert np.isnan(a.p99_ms)               # no evidence yet
    hot = [a.observe(50.0) for _ in range(10)]
    assert 2 in hot and a.lane == 2         # sustained over-SLO: widen
    assert all(d is None for d in [a.observe(50.0) for _ in range(10)]), \
        "already at the widest lane — no further decision"
    cold = [a.observe(1.0) for _ in range(10)]
    assert 1 in cold and a.lane == 1        # sustained under margin: narrow
    # mid-band traffic (between margin and SLO) holds the current lane
    assert all(d is None for d in [a.observe(7.0) for _ in range(20)])
    assert a.lane == 1


def test_slo_autoscaler_cooldown_blocks_flapping():
    a = SloAutoscaler(slo_p99_ms=10.0, lanes=(1, 2, 4), window=2,
                      patience=1, cooldown=50)
    assert any(a.observe(99.0) is not None for _ in range(4))
    assert a.lane == 2
    # still hot, but the next decision must wait out the cooldown — the
    # freshly-swapped lane gets time to settle before being judged
    assert all(a.observe(99.0) is None for _ in range(40))
    assert 4 in [a.observe(99.0) for _ in range(60)]
    assert a.lane == 4


def test_slo_autoscaler_validation():
    with pytest.raises(ValueError):
        SloAutoscaler(slo_p99_ms=0.0)
    with pytest.raises(ValueError):
        SloAutoscaler(slo_p99_ms=1.0, lanes=(2, 1))
    with pytest.raises(ValueError):
        SloAutoscaler(slo_p99_ms=1.0, lanes=(1, 1, 2))
    with pytest.raises(ValueError):
        SloAutoscaler(slo_p99_ms=1.0, narrow_margin=1.5)
    with pytest.raises(ValueError):
        SloAutoscaler(slo_p99_ms=1.0, patience=0)


def test_autoscaler_scales_lanes_bit_identically(jzoo, satdap):
    """End-to-end scale event: an impossible SLO forces a widen, the engine
    pre-warms the incoming lane, quiesces, swaps — and every answer before,
    across, and after the swap equals the reference classify."""
    _, _, Xte, _ = satdap
    serving = _mk_zoo(jzoo)         # lane 1: the serving zoo's executor
    lane2 = _mk_zoo(jzoo)           # lane 2: identically programmed
    pool = {1: serving.runtime.executor, 2: lane2.runtime.executor}
    scaler = SloAutoscaler(slo_p99_ms=1e-6, lanes=(1, 2), window=4,
                           patience=1, cooldown=0)

    async def main():
        async with ContinuousZooServer(
                serving, policy=SizeOrDeadlinePolicy(max_batch=8,
                                                     max_wait_us=200.0),
                n_slots=2, lane_pool=pool, autoscaler=scaler) as srv:
            outs = []
            for i in range(12):             # sequential: decisions apply between
                outs.append(await srv.submit(Xte[i:i + 2], mid=0, vid=0))
            return outs, srv.lanes, srv.latency_stats()

    outs, lanes, stats = run_async(asyncio.wait_for(main(), timeout=60))
    assert lanes == 2, "an impossible SLO must have widened the mesh"
    assert stats["engine"]["lanes"] == 2
    assert stats["engine"]["scale_ups"] >= 1
    for i, out in enumerate(outs):          # bit-identical across the swap
        np.testing.assert_array_equal(
            out.rslt, jzoo.classify(Xte[i:i + 2], mid=0, vid=0))
    # the incoming lane was pre-warmed before the swap: its executor holds
    # the full bucket ladder even though it served only post-swap traffic
    assert lane2.cache_size() == len(bucket_ladder(8, 1))


def test_autoscaler_narrows_back_when_load_drops(jzoo, satdap):
    """The reverse transition: a generous SLO over cheap traffic narrows the
    engine back to lane 1, releasing the wide mesh."""
    _, _, Xte, _ = satdap
    serving = _mk_zoo(jzoo)
    lane2 = _mk_zoo(jzoo)
    pool = {1: serving.runtime.executor, 2: lane2.runtime.executor}
    scaler = SloAutoscaler(slo_p99_ms=1e-6, lanes=(1, 2), window=4,
                           patience=1, cooldown=0)

    async def main():
        async with ContinuousZooServer(
                serving, policy=SizeOrDeadlinePolicy(max_batch=8,
                                                     max_wait_us=200.0),
                lane_pool=pool, autoscaler=scaler) as srv:
            for i in range(8):              # impossible SLO: widen to lane 2
                await srv.submit(Xte[i:i + 2], mid=0, vid=0)
            assert srv.lanes == 2
            scaler.slo_p99_ms = 1e9         # load "drops": everything is cheap
            for i in range(8):
                await srv.submit(Xte[i:i + 2], mid=0, vid=0)
            return srv.lanes, srv.latency_stats()

    lanes, stats = run_async(asyncio.wait_for(main(), timeout=60))
    assert lanes == 1
    assert stats["engine"]["scale_downs"] >= 1


# ------------------------------------------------------------- loadgen
def test_arrival_times_processes():
    rng = np.random.default_rng(0)
    t = arrival_times(1000, 100.0, rng=rng)
    assert t.shape == (1000,) and (np.diff(t) >= 0).all()
    assert t[-1] == pytest.approx(10.0, rel=0.25)     # mean rate respected
    b = arrival_times(1000, 100.0, process="burst", burst=8,
                      rng=np.random.default_rng(0))
    assert (np.diff(b) >= 0).all()
    # clumped: arrivals inside a burst share one timestamp
    assert np.unique(b).size <= -(-1000 // 8)
    assert b[-1] == pytest.approx(10.0, rel=0.35)     # same mean rate
    with pytest.raises(ValueError):
        arrival_times(0, 1.0)
    with pytest.raises(ValueError):
        arrival_times(1, 0.0)
    with pytest.raises(ValueError):
        arrival_times(1, 1.0, process="pareto")
    with pytest.raises(ValueError):
        arrival_times(1, 1.0, process="burst", burst=0)


def test_open_loop_counts_errors_and_orders_percentiles():
    async def main():
        calls = []

        async def submit(i):
            calls.append(i)
            if i % 5 == 0:
                raise RuntimeError("refused")
            await asyncio.sleep(0)

        report = await open_loop(submit, rate_rps=10_000.0, n_requests=50,
                                 n_clients=4, seed=3)
        with pytest.raises(ValueError):
            await open_loop(submit, rate_rps=1.0, n_requests=1, n_clients=0)
        return report, calls

    report, calls = run_async(main())
    assert isinstance(report, LoadReport)
    assert sorted(calls)[:50] == list(range(50))      # every arrival fired
    assert report.requests == 50
    assert report.errors == 10                        # failures counted...
    assert report.p50_ms <= report.p99_ms <= report.p999_ms  # ...not hidden
    assert report.offered_rps == 10_000.0
    assert report.achieved_rps > 0
    row = report.row()
    assert row["errors"] == 10 and isinstance(row["p99_ms"], float)


def test_open_loop_charges_latency_from_scheduled_arrival():
    """Coordinated omission: a server that stalls must see the stall in its
    tail, even though the generator fired on schedule.  A 50 ms stall on
    one request puts >= 50 ms in the max latency."""

    async def main():
        async def submit(i):
            await asyncio.sleep(0.05 if i == 7 else 0)

        return await open_loop(submit, rate_rps=1_000.0, n_requests=16,
                               n_clients=2, seed=0)

    report = run_async(main())
    assert report.errors == 0
    assert report.p999_ms >= 50.0, \
        "the stalled request's latency was omitted from the distribution"


def test_open_loop_drives_the_continuous_engine(zoo, satdap):
    """Integration: the generator drives a live ContinuousZooServer and the
    loadgen-side report agrees with the server's own accounting."""
    _, _, Xte, _ = satdap

    async def main():
        async with ContinuousZooServer(
                zoo, policy=SizeOrDeadlinePolicy(max_batch=16,
                                                 max_wait_us=500.0),
                n_slots=2, warm=False) as srv:
            async def submit(i):
                lo = (i * 3) % (Xte.shape[0] - 2)
                await srv.submit(Xte[lo:lo + 2], mid=0, vid=0)

            report = await open_loop(submit, rate_rps=2_000.0,
                                     n_requests=40, seed=11)
            return report, srv.latency_stats()

    report, stats = run_async(asyncio.wait_for(main(), timeout=60))
    assert report.errors == 0
    assert stats["requests"] == report.requests == 40
    assert stats["dispatches"] >= 1
    # loadgen latency includes the schedule; the server's own latency is a
    # lower bound on it
    assert report.p50_ms >= 0.0 and stats["p50_ms"] >= 0.0


@pytest.mark.parametrize("process", ["poisson", "burst"])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_arrival_times_equal_the_reference(process, seed):
    """The port's schedule is the reference's, number for number, for the
    same generator state."""
    for n, rate in ((1, 10.0), (999, 2_500.0)):
        got = arrival_times(n, rate, process=process, burst=5,
                            rng=np.random.default_rng(seed))
        want = jloadgen.arrival_times(n, rate, process=process, burst=5,
                                      rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
