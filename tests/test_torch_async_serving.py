"""The port's async serving front and batching policies against the JAX
package's (``tests/test_async_serving.py``, ported).

Every coroutine runs through ``asyncio.run(..., debug=True)``, asyncio's
debug mode, as in the reference's tests.  The port's policies must make the
reference's decisions (``wait_us``, ``drain``, ``target_batch``, the
autoscaler's lanes) on the same sequences, and the port's
``AsyncZooServer``, over a zoo holding the JAX zoo's tables, must answer
every request bit-identically to the JAX ``ZooServer``: whole requests,
demuxed.  The serving mechanics (empty submit, submit before start,
stop-flush, hold/drain/release, executor and policy failures, install under
live traffic, the latency accounting) are the reference's tests run on the
port.  The 204-draw lane is ``tests/test_torch_fronts_conformance_v*.py``.
"""
import asyncio

import numpy as np
import pytest

from repro.core.mlmodels import DecisionTree, LinearSVM
from repro.core.plane import PlaneProfile as JaxProfile
from repro.core.translator import MID_SVM
from repro.runtime import policies as jpol
from repro.serving import ZooServer as JaxZooServer
from repro_torch.core import mlmodels as tml
from repro_torch.core.packets import PacketBatch
from repro_torch.runtime import (
    AdaptiveBucketPolicy,
    BatchingPolicy,
    ImmediatePolicy,
    SingleSwitchExecutor,
    SizeOrDeadlinePolicy,
    SloAutoscaler,
    coalesce,
    split,
)
from repro_torch.runtime import policies as tpol
from repro_torch.serving import AsyncZooServer, ZooServer
from test_torch_plane import port_packed, port_profile


def run_async(coro):
    """All async tests run under asyncio debug (strict) mode."""
    return asyncio.run(coro, debug=True)


def _profile(V=2):
    return JaxProfile(max_features=36, max_trees=4, max_layers=6,
                      max_entries_per_layer=64, max_leaves=64,
                      max_classes=8, max_hyperplanes=8, max_versions=V)


def _port_zoo(jzoo):
    """A port zoo on the CPU holding the JAX zoo's tables."""
    jprof = jzoo.profile
    return ZooServer(port_profile(jprof), executor=SingleSwitchExecutor(
        port_profile(jprof), device="cpu",
        packed=port_packed(jzoo.packed, jprof)))


@pytest.fixture(scope="module")
def jzoo(satdap):
    Xtr, ytr, _, _ = satdap
    z = JaxZooServer(_profile())
    z.install(DecisionTree(max_depth=4, max_leaf_nodes=16).fit(Xtr, ytr),
              vid=0)
    z.install(LinearSVM(epochs=30).fit(Xtr, ytr), vid=0)
    return z


@pytest.fixture(scope="module")
def zoo(jzoo):
    return _port_zoo(jzoo)


def _want(jzoo, X, mid, vid):
    """The JAX zoo's answer (rslt) for one request."""
    return np.asarray(jzoo.classify(X, mid=mid, vid=vid))


# ------------------------------------------------ policies vs the reference
@pytest.mark.parametrize("make", [
    lambda pol: pol.ImmediatePolicy(),
    lambda pol: pol.SizeOrDeadlinePolicy(max_batch=16, max_wait_us=2_000),
    lambda pol: pol.AdaptiveBucketPolicy(min_batch=1, max_batch=128,
                                         max_wait_us=1_000, alpha=0.3),
    lambda pol: pol.AdaptiveBucketPolicy(min_batch=2, max_batch=100,
                                         max_wait_us=500, alpha=0.7,
                                         granularity=4),
], ids=["immediate", "size-or-deadline", "adaptive", "adaptive-gran4"])
def test_policies_decide_as_the_reference(make):
    """The same random sequence of queue states and dispatch feedback
    through the port's policy and the reference's: every ``wait_us``,
    ``drain`` and ``target_batch`` decision is equal."""
    rng = np.random.default_rng(0)
    t, j = make(tpol), make(jpol)
    assert isinstance(t, BatchingPolicy)
    for _ in range(400):
        queued = int(rng.integers(0, 300))
        age = float(rng.uniform(0, 3_000))
        assert t.wait_us(queued, age) == j.wait_us(queued, age)
        assert t.drain(queued) == j.drain(queued)
        packets = int(rng.integers(1, 200))
        waited = float(rng.choice([rng.uniform(0, 3_000), 1_000.0]))
        t.note_dispatch(packets, waited)
        j.note_dispatch(packets, waited)
        assert getattr(t, "target_batch", None) == \
            getattr(j, "target_batch", None)


def test_autoscaler_decides_as_the_reference():
    """The same latency stream through both ``SloAutoscaler``s: the same
    decisions, lanes and p99 estimates."""
    rng = np.random.default_rng(1)
    kw = dict(slo_p99_ms=10.0, lanes=(1, 2, 4), window=8, patience=2,
              narrow_margin=0.5, cooldown=5)
    t, j = tpol.SloAutoscaler(**kw), jpol.SloAutoscaler(**kw)
    decisions = 0
    for phase in (40.0, 1.0, 7.0, 60.0, 0.5):
        for _ in range(60):
            lat = float(rng.exponential(phase))
            d = t.observe(lat)
            assert d == j.observe(lat)
            decisions += d is not None
            assert t.lane == j.lane
            assert (np.isnan(t.p99_ms) and np.isnan(j.p99_ms)) \
                or t.p99_ms == j.p99_ms
    assert decisions >= 2


# ------------------------------------------------------------- policies
def test_immediate_policy_never_waits_never_coalesces():
    p = ImmediatePolicy()
    assert p.wait_us(1, 0.0) <= 0
    assert p.wait_us(1000, 1e6) <= 0
    assert p.drain(37) == 1      # one whole request per dispatch
    assert isinstance(p, BatchingPolicy)


def test_size_or_deadline_policy_semantics():
    p = SizeOrDeadlinePolicy(max_batch=16, max_wait_us=2_000)
    assert p.wait_us(16, 0.0) <= 0          # size trigger
    assert p.wait_us(40, 0.0) <= 0
    assert p.wait_us(3, 2_500.0) <= 0       # deadline trigger
    assert p.wait_us(3, 500.0) == pytest.approx(1_500.0)   # remaining budget
    assert p.drain(40) == 16                # batches cap at max_batch
    assert p.drain(3) == 3
    assert isinstance(p, BatchingPolicy)
    with pytest.raises(ValueError):
        SizeOrDeadlinePolicy(max_batch=0)
    with pytest.raises(ValueError):
        SizeOrDeadlinePolicy(max_wait_us=-1)


def test_adaptive_policy_widens_bucket_under_sustained_load():
    p = AdaptiveBucketPolicy(min_batch=1, max_batch=128, max_wait_us=1_000,
                             alpha=0.3)
    assert p.target_batch == 1              # idle: immediate-like
    assert p.wait_us(1, 0.0) <= 0
    for _ in range(12):                     # sustained ~50-packet dispatches
        p.note_dispatch(50, 500.0)
    assert p.target_batch == 64             # next power-of-two bucket up
    assert p.wait_us(10, 0.0) > 0           # now holds for a fuller bucket
    assert p.wait_us(64, 0.0) <= 0
    # load drops: one deadline flush below target snaps the estimate down —
    # a lone request after a burst must not keep paying the deadline
    p.note_dispatch(1, 1_000.0)
    assert p.target_batch == 1
    assert p.wait_us(1, 0.0) <= 0
    for _ in range(12):                     # EWMA path still decays too
        p.note_dispatch(50, 500.0)
    assert p.target_batch == 64
    for _ in range(40):
        p.note_dispatch(1, 0.0)             # below-deadline trickle
    assert p.target_batch == 1
    assert isinstance(p, BatchingPolicy)


def test_adaptive_policy_targets_are_admission_buckets():
    p = AdaptiveBucketPolicy(min_batch=1, max_batch=100, granularity=4,
                             alpha=1.0)
    p.note_dispatch(13, 0.0)
    assert p.target_batch == 16             # bucket_size(13, 4)
    p.note_dispatch(100, 0.0)
    # never above max_batch: drain() can't cut more, so a bucket-rounded
    # 128 target would be unreachable and every dispatch would wait out
    # the full deadline
    assert p.target_batch == 100
    assert p.wait_us(100, 0.0) <= 0
    with pytest.raises(ValueError):
        AdaptiveBucketPolicy(min_batch=8, max_batch=4)


# ------------------------------------------------------- coalesce seam
def test_coalesce_split_round_trip(satdap):
    _, _, Xte, _ = satdap
    prof = _profile()
    pbs = [PacketBatch.make_request(Xte[lo:hi], mid=0,
                                    max_features=prof.max_features,
                                    n_trees=prof.max_trees,
                                    n_hyperplanes=prof.max_hyperplanes)
           for lo, hi in ((0, 5), (5, 5), (5, 17))]   # middle one is empty
    flat, offsets = coalesce(pbs)
    assert offsets == (0, 5, 5, 17)
    assert flat.batch == 17
    parts = split(flat, offsets)
    assert [p.batch for p in parts] == [5, 0, 12]
    for part, pb in zip(parts, pbs):
        np.testing.assert_array_equal(np.asarray(part.features),
                                      np.asarray(pb.features))
    with pytest.raises(ValueError):
        coalesce([])
    with pytest.raises(ValueError):
        split(flat, (0, 3))


def test_classify_coalesced_matches_per_batch(zoo, jzoo, satdap):
    """The sync twin of one async dispatch: coalesced results equal one
    classify call per client batch."""
    _, _, Xte, _ = satdap
    reqs = [(Xte[:9], 0, 0), (Xte[9:10], MID_SVM, 0), (Xte[10:31], 0, 0)]
    outs = zoo.classify_coalesced(reqs)
    for got, (f, m, v) in zip(outs, reqs):
        np.testing.assert_array_equal(got, _want(jzoo, f, m, v))


# ------------------------------------------------------------ serving
def test_async_results_bit_identical_and_demuxed(zoo, jzoo, satdap):
    """Concurrent ragged submits (tree + SVM traffic interleaved) demux to
    exactly the synchronous per-batch results."""
    _, _, Xte, _ = satdap
    chunks = [(Xte[0:7], 0, 0), (Xte[7:8], MID_SVM, 0), (Xte[8:29], 0, 0),
              (Xte[29:61], MID_SVM, 0), (Xte[61:64], 0, 0)]

    async def main():
        async with AsyncZooServer(
                zoo, policy=SizeOrDeadlinePolicy(max_batch=64,
                                                 max_wait_us=2_000)) as srv:
            return await asyncio.gather(
                *[srv.submit(f, mid=m, vid=v) for f, m, v in chunks])

    outs = run_async(main())
    for out, (f, m, v) in zip(outs, chunks):
        want = jzoo.classify(f, mid=m, vid=v, device_out=True)   # JAX
        np.testing.assert_array_equal(out.rslt, np.asarray(want.rslt))
        np.testing.assert_array_equal(out.codes, np.asarray(want.codes))
        np.testing.assert_array_equal(out.svm_acc, np.asarray(want.svm_acc))
        assert out.t_submit <= out.t_dispatch <= out.t_done
        assert out.latency_s >= out.queue_wait_s >= 0


def test_size_policy_coalesces_concurrent_submits(zoo, jzoo, satdap):
    """Many small concurrent submits under a size-or-deadline policy land in
    far fewer dispatches; whole requests are never split."""
    _, _, Xte, _ = satdap

    async def main():
        async with AsyncZooServer(
                zoo, policy=SizeOrDeadlinePolicy(max_batch=32,
                                                 max_wait_us=50_000)) as srv:
            outs = await asyncio.gather(
                *[srv.submit(Xte[i:i + 2], mid=0, vid=0) for i in range(24)])
            return outs, srv.latency_stats()

    outs, stats = run_async(main())
    assert stats["requests"] == 24
    assert stats["dispatches"] <= 4, \
        f"48 packets under max_batch=32 should coalesce, got {stats}"
    assert stats["mean_batch_packets"] >= 12
    for i, out in enumerate(outs):
        assert out.rslt.shape == (2,)       # whole request, one future
        np.testing.assert_array_equal(
            out.rslt, jzoo.classify(Xte[i:i + 2], mid=0, vid=0))


def test_empty_submit_resolves_immediately(zoo):
    async def main():
        async with AsyncZooServer(zoo) as srv:
            out = await srv.submit(np.zeros((0, 36), np.int32), mid=0, vid=0)
            return out, srv.latency_stats()

    out, stats = run_async(main())
    assert out.rslt.shape == (0,)
    assert out.codes.shape[0] == 0 and out.svm_acc.shape[0] == 0
    assert out.latency_s == 0.0
    # the short-circuit must not bypass accounting: an empty submit is an
    # accepted request (zero latency, zero wait) with no dispatch — rates
    # and percentiles cover every request the server answered
    assert stats["requests"] == 1
    assert stats["dispatches"] == 0
    assert stats["p50_ms"] == 0.0 and stats["p50_wait_ms"] == 0.0
    assert stats["mean_batch_packets"] == 0.0   # no dispatch log yet, no NaN


def test_stop_drains_pending_requests(zoo, jzoo, satdap):
    """stop() flushes the queue through a final dispatch — no future is left
    pending, even with a deadline policy mid-wait."""
    _, _, Xte, _ = satdap

    async def main():
        srv = AsyncZooServer(zoo, policy=SizeOrDeadlinePolicy(
            max_batch=4096, max_wait_us=60_000_000))   # would wait a minute
        await srv.start()
        tasks = [asyncio.create_task(srv.submit(Xte[i:i + 3], mid=0, vid=0))
                 for i in range(5)]
        await asyncio.sleep(0.01)           # let submits enqueue
        await srv.stop()                    # drain overrides the deadline
        return await asyncio.gather(*tasks)

    outs = run_async(main())
    assert len(outs) == 5
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(
            out.rslt, jzoo.classify(Xte[i:i + 3], mid=0, vid=0))


def test_submit_without_start_raises(zoo, satdap):
    _, _, Xte, _ = satdap
    srv = AsyncZooServer(zoo)

    async def main():
        with pytest.raises(RuntimeError, match="not serving"):
            await srv.submit(Xte[:2], mid=0, vid=0)

    run_async(main())


def test_executor_failure_propagates_to_futures(satdap):
    """A dispatch that blows up inside the executor must fail that batch's
    futures with the original exception — and leave the loop serving."""
    _, _, Xte, _ = satdap
    z = ZooServer(port_profile(_profile()), device="cpu")

    class Boom(RuntimeError):
        pass

    async def main():
        async with AsyncZooServer(z) as srv:
            orig = srv.runtime.executor.classify
            srv.runtime.executor.classify = lambda pb: (_ for _ in ()).throw(
                Boom("kernel died"))
            with pytest.raises(Boom):
                await srv.submit(Xte[:4], mid=0, vid=0)
            srv.runtime.executor.classify = orig    # loop survived the error
            out = await srv.submit(Xte[:4], mid=0, vid=0)
            return out

    out = run_async(main())
    assert out.rslt.shape == (4,)


def test_broken_policy_fails_futures_not_the_loop(zoo, jzoo, satdap):
    """BatchingPolicy is a user-implementable protocol: a policy that raises
    must fail the affected futures loudly and leave the dispatch loop
    serving — never kill the loop and hang every later submit."""
    _, _, Xte, _ = satdap

    class BrokenWait(ImmediatePolicy):
        def wait_us(self, queued_packets, oldest_age_us):
            raise ZeroDivisionError("bad policy math")

    class BrokenFeedback(ImmediatePolicy):
        def note_dispatch(self, packets, waited_us):
            raise KeyError("bad feedback hook")

    async def main():
        async with AsyncZooServer(zoo, policy=BrokenWait()) as srv:
            with pytest.raises(ZeroDivisionError):
                await srv.submit(Xte[:3], mid=0, vid=0)
            srv.policy = BrokenFeedback()
            with pytest.raises(KeyError):
                await srv.submit(Xte[:3], mid=0, vid=0)
            srv.policy = ImmediatePolicy()   # loop survived both failures
            return await srv.submit(Xte[:3], mid=0, vid=0)

    out = run_async(main())
    np.testing.assert_array_equal(out.rslt, jzoo.classify(Xte[:3], mid=0,
                                                         vid=0))


def test_install_between_dispatches_under_live_traffic(satdap):
    """Runtime reprogrammability through the async front: an install between
    dispatches changes subsequent answers (equal to the JAX zoo given the
    same installs), and the bucket's cache entry serves both."""
    Xtr, ytr, Xte, _ = satdap
    jz = JaxZooServer(_profile())
    z = ZooServer(port_profile(_profile()), device="cpu")
    small, canary = (dict(max_depth=4, max_leaf_nodes=16),
                     dict(max_depth=6, max_leaf_nodes=40))
    jz.install(DecisionTree(**small).fit(Xtr, ytr), vid=0)
    z.install(tml.DecisionTree(**small).fit(Xtr, ytr), vid=0)

    async def main():
        async with AsyncZooServer(z) as srv:
            before = await srv.submit(Xte[:16], mid=0, vid=1)
            srv.install(tml.DecisionTree(**canary).fit(Xtr, ytr), vid=1,
                        tag="canary")
            after = await srv.submit(Xte[:16], mid=0, vid=1)
            return before, after

    before, after = run_async(main())
    jz.install(DecisionTree(**canary).fit(Xtr, ytr), vid=1, tag="canary")
    assert (before.rslt == -1).all()        # slot was empty
    np.testing.assert_array_equal(after.rslt,
                                  jz.classify(Xte[:16], mid=0, vid=1))
    assert z.versions == jz.versions
    assert z.cache_size() == 1              # one bucket's entry, no recapture


def test_latency_stats_surface(zoo, satdap):
    _, _, Xte, _ = satdap

    async def main():
        async with AsyncZooServer(zoo) as srv:
            await asyncio.gather(
                *[srv.submit(Xte[i:i + 4], mid=0, vid=0) for i in range(6)])
            return srv.latency_stats()

    stats = run_async(main())
    assert stats["requests"] == 6
    assert stats["dispatches"] >= 1
    for key in ("p50_ms", "p99_ms", "p999_ms", "mean_ms", "p50_wait_ms",
                "mean_batch_packets"):
        assert stats[key] >= 0.0
    assert stats["p50_ms"] <= stats["p99_ms"] <= stats["p999_ms"]


# ------------------------------------------------- quiesce seam (control plane)
def test_drain_holds_dispatches_until_release(zoo, jzoo, satdap):
    """The control plane's barrier: after drain(), submits queue but never
    dispatch; release() flushes them.  Nothing is dropped either side."""
    _, _, Xte, _ = satdap

    async def main():
        async with AsyncZooServer(zoo) as srv:
            await srv.drain()                      # idle server: returns fast
            task = asyncio.create_task(srv.submit(Xte[:4], mid=0, vid=0))
            await asyncio.sleep(0.05)
            held_pending = not task.done()         # held: future must wait
            held_dispatches = srv.latency_stats()["dispatches"]
            srv.release()
            out = await task
            return held_pending, held_dispatches, out

    held_pending, held_dispatches, out = run_async(main())
    assert held_pending, "request dispatched through an active hold"
    assert held_dispatches == 0
    np.testing.assert_array_equal(out.rslt, jzoo.classify(Xte[:4], mid=0,
                                                         vid=0))


def test_drain_waits_for_inflight_dispatch(zoo, satdap):
    """drain() returns only after the in-flight executor call lands — the
    reinstall step never races a live classify."""
    _, _, Xte, _ = satdap

    async def main():
        async with AsyncZooServer(zoo) as srv:
            task = asyncio.create_task(srv.submit(Xte[:8], mid=0, vid=0))
            await asyncio.sleep(0)                 # let it reach the queue
            await srv.drain()
            # after drain, whatever was cut must be fully done
            inflight = srv._inflight
            srv.release()
            await task
            return inflight

    assert run_async(main()) == 0


def test_stop_releases_an_active_hold(zoo, jzoo, satdap):
    """stop() must not deadlock on a held server: the final drain flushes
    queued requests even when the control plane never called release()."""
    _, _, Xte, _ = satdap

    async def main():
        srv = AsyncZooServer(zoo)
        await srv.start()
        srv.hold()
        task = asyncio.create_task(srv.submit(Xte[:4], mid=0, vid=0))
        await asyncio.sleep(0.01)
        await srv.stop()                           # releases + flushes
        return await task

    out = run_async(main())
    np.testing.assert_array_equal(out.rslt, jzoo.classify(Xte[:4], mid=0,
                                                         vid=0))


def test_cancelled_dispatch_loop_fails_fast_and_stop_flushes(zoo, jzoo, satdap):
    """Shutdown-race regression: the dispatch task dying out from under the
    queue (external cancel / loop teardown) used to let later submits
    enqueue onto a loop nobody runs — futures hung until the test timed
    out.  Now: submits after the death fail fast, and ``stop()``
    fail-or-flushes the stranded straggler so no future is left pending."""
    _, _, Xte, _ = satdap

    async def main():
        srv = AsyncZooServer(zoo, policy=SizeOrDeadlinePolicy(
            max_batch=4096, max_wait_us=60_000_000))   # straggler waits forever
        await srv.start()
        straggler = asyncio.create_task(srv.submit(Xte[:3], mid=0, vid=0))
        await asyncio.sleep(0.01)          # enqueued, parked on the deadline
        srv._task.cancel()                 # the loop dies under the queue
        await asyncio.sleep(0.01)
        with pytest.raises(RuntimeError, match="not serving"):
            await srv.submit(Xte[:3], mid=0, vid=0)    # used to hang here
        await srv.stop()                   # flushes the straggler
        return await asyncio.wait_for(straggler, timeout=5)

    out = run_async(asyncio.wait_for(main(), timeout=30))
    np.testing.assert_array_equal(out.rslt, jzoo.classify(Xte[:3], mid=0,
                                                         vid=0))


def test_submit_stop_interleave_leaves_no_future_pending(zoo, jzoo, satdap):
    """Submits racing ``stop()``: every future either resolves bit-identical
    or fails fast with the not-serving error — none hang (the whole
    interleave runs under a hard timeout and asyncio debug mode)."""
    _, _, Xte, _ = satdap

    async def main():
        srv = AsyncZooServer(zoo, policy=SizeOrDeadlinePolicy(
            max_batch=4096, max_wait_us=60_000_000))
        await srv.start()
        tasks = [asyncio.create_task(srv.submit(Xte[i:i + 2], mid=0, vid=0))
                 for i in range(6)]
        await asyncio.sleep(0)             # some enqueue before the stop
        stopper = asyncio.create_task(srv.stop())
        tasks += [asyncio.create_task(srv.submit(Xte[i:i + 2], mid=0, vid=0))
                  for i in range(6, 12)]   # these race the closing flag
        await stopper
        return await asyncio.gather(*tasks, return_exceptions=True)

    results = run_async(asyncio.wait_for(main(), timeout=30))
    assert len(results) == 12
    resolved = 0
    for i, r in enumerate(results):
        if isinstance(r, BaseException):
            assert isinstance(r, RuntimeError) and "not serving" in str(r)
        else:
            resolved += 1
            np.testing.assert_array_equal(
                r.rslt, jzoo.classify(Xte[i:i + 2], mid=0, vid=0))
    assert resolved >= 6                   # the pre-stop submits all land


def test_stop_breaks_owned_hold_and_release_raises(zoo, jzoo, satdap):
    """A control-plane drain owner whose server is stopped mid-hold must
    find out: stop() breaks the barrier so the final flush can run, and the
    owner's release() raises instead of silently resuming a server that
    already flushed through its half-done reinstall."""
    _, _, Xte, _ = satdap

    async def main():
        srv = AsyncZooServer(zoo)
        await srv.start()
        await srv.drain()                  # the control plane owns the barrier
        task = asyncio.create_task(srv.submit(Xte[:4], mid=0, vid=0))
        await asyncio.sleep(0.01)
        await srv.stop()                   # breaks the hold, flushes the queue
        out = await task
        with pytest.raises(RuntimeError, match="broken by stop"):
            srv.release()                  # the owner must be told
        # once surfaced, the broken flag is consumed — and a stopped server
        # refuses new barriers outright
        with pytest.raises(RuntimeError, match="drain unavailable"):
            await srv.drain()
        with pytest.raises(RuntimeError, match="hold unavailable"):
            srv.hold()
        return out

    out = run_async(main())
    np.testing.assert_array_equal(out.rslt, jzoo.classify(Xte[:4], mid=0,
                                                         vid=0))


def test_hold_before_start_raises(zoo):
    srv = AsyncZooServer(zoo)
    with pytest.raises(RuntimeError):
        srv.hold()
    with pytest.raises(RuntimeError):
        srv.release()


def test_stats_sources_merge_into_latency_stats(zoo, satdap):
    """add_stats_source: named provider dicts ride latency_stats() — the
    control plane's counter path — and names must be unique."""
    _, _, Xte, _ = satdap
    srv = AsyncZooServer(zoo)
    srv.add_stats_source("control", lambda: {"replans": 3})
    with pytest.raises(ValueError):
        srv.add_stats_source("control", lambda: {})

    async def main():
        async with srv:
            empty = srv.latency_stats()            # merged before any traffic
            await srv.submit(Xte[:4], mid=0, vid=0)
            return empty, srv.latency_stats()

    empty, stats = run_async(main())
    assert empty["control"] == {"replans": 3}
    assert stats["control"] == {"replans": 3}
    assert stats["requests"] >= 1
