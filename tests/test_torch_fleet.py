"""The port's fleet, control loop and network model against the JAX package.

One case per test of ``tests/test_fleet.py`` (fleet mechanics and the heal
cycle) and of ``tests/test_netsim.py``, on the same inputs: the same DT and
RF trained by each package on the satdap stand-in, planned over
``fat_tree(4)`` by each package's planner, the port's answers held to the
JAX ``SwitchEngine(mode="ref")`` bit for bit, its plans (wire path and
hosting devices) to the JAX ``FleetRuntime``'s before and after each heal,
and ``simulate_serving`` to the reference's arrays for the same seed and
windows.  The port's counterpart of the reference's one-trace test is the
hop pool: ``cache_size()`` stays within (buckets) x (distinct hosting
counts), a retarget to a count already captured adds no entry, and no
resident ``data_ptr`` moves.  Everything runs on the CPU (the graph cache
runs its entries eagerly on their static buffers).
"""
import asyncio
import threading

import numpy as np
import pytest
import torch

from repro.core import mlmodels as jml
from repro.core import netsim as jns
from repro.core import packets as jpk
from repro.core import planner as jpl
from repro.core.plane import PlaneProfile as JaxProfile
from repro.core.plane import SwitchEngine as JaxEngine
from repro.core.plane import empty_program as jax_empty
from repro.core.plane import install_program as jax_install
from repro.core.topology import fat_tree as jax_fat_tree
from repro.core.translator import translate as jax_translate
from repro.runtime.control import ControlCounters as JaxCounters
from repro.serving import FleetRuntime as JaxFleet
from repro_torch.core import mlmodels as tml
from repro_torch.core import netsim as tns
from repro_torch.core import packets as tpk
from repro_torch.core import planner as tpl
from repro_torch.core.plane import empty_program, program_tensors
from repro_torch.core.topology import fat_tree
from repro_torch.core.translator import translate
from repro_torch.runtime import (
    ControlCounters,
    ControlLoop,
    DeviceFailure,
    Executor,
    SequentialPathExecutor,
)
from repro_torch.serving import FleetRuntime
from repro_torch.serving.fleet import FleetExecutor
from test_torch_plane import port_profile

JPROF = JaxProfile(max_features=36, max_trees=4, max_layers=8,
                   max_entries_per_layer=64, max_leaves=64, max_classes=8,
                   max_hyperplanes=8, max_versions=2)
PROF = port_profile(JPROF)
SRC, DST = "h0_0_0", "h2_0_0"


def run_async(coro):
    return asyncio.run(coro, debug=True)


@pytest.fixture(scope="module")
def setup(satdap):
    """The same two programs from each package, the JAX oracle's monolithic
    install, 16 test rows, and the JAX fleets' deployments to compare."""
    Xtr, ytr, Xte, _ = satdap
    kw = ({"max_depth": 4, "max_leaf_nodes": 16},
          {"n_estimators": 3, "max_depth": 3, "max_leaf_nodes": 8})
    jprogs = [jax_translate(jml.DecisionTree(**kw[0]).fit(Xtr, ytr), vid=0),
              jax_translate(jml.RandomForest(**kw[1]).fit(Xtr, ytr), vid=1)]
    tprogs = [translate(tml.DecisionTree(**kw[0]).fit(Xtr, ytr), vid=0),
              translate(tml.RandomForest(**kw[1]).fit(Xtr, ytr), vid=1)]
    oracle_packed = jax_empty(JPROF)
    for p in jprogs:
        oracle_packed = jax_install(oracle_packed, p, JPROF, vid=p.vid)
    return dict(jprogs=jprogs, tprogs=tprogs, packed=oracle_packed,
                oracle=JaxEngine(JPROF, mode="ref"), template=JaxEngine(JPROF),
                Xq=Xte[:16])


def _fleet(setup, *, n_stages=4, **kw):
    return FleetRuntime(fat_tree(4), PROF, setup["tprogs"], src=SRC, dst=DST,
                        default_device=tpl.DeviceModel(n_stages=n_stages),
                        device="cpu", **kw)


def _jax_fleet(setup, *, n_stages=4):
    return JaxFleet(jax_fat_tree(4), JPROF, setup["jprogs"], src=SRC,
                    dst=DST, default_device=jpl.DeviceModel(n_stages=n_stages),
                    engine=setup["template"])


def _jax_deployment(setup, *, down=(), n_stages=4):
    """The JAX fleet's (path, hosting devices), replanned around ``down``."""
    jf = _jax_fleet(setup, n_stages=n_stages)
    if not down:
        return list(jf.path), list(jf.executor.devices)
    for d in down:
        jf.kill(d)
    plans, devices, _ = jf.replan_sync()
    return list(plans[0].path), list(devices)


def _deployment(fleet):
    return list(fleet.path), list(fleet.executor.devices)


def _want(setup, vid):
    """The JAX oracle's rslt for the 16 rows at ``vid``."""
    pb = jpk.PacketBatch.make_request(
        setup["Xq"], mid=0, vid=vid, max_features=JPROF.max_features,
        n_trees=JPROF.max_trees, n_hyperplanes=JPROF.max_hyperplanes,
        max_versions=JPROF.max_versions)
    return np.asarray(setup["oracle"].classify(setup["packed"], pb).rslt)


def _ptrs(executor):
    return [[t.data_ptr() for t in program_tensors(p)] for p in executor.pool]


# ------------------------------------------------------ fleet mechanics
def test_fleet_plan_spreads_and_matches_oracle(setup):
    """Small switches force a multi-hop deployment, the same one the JAX
    fleet plans; classify through it equals the single-switch oracle for
    both zoo versions."""
    fleet = _fleet(setup)
    assert len(fleet.executor.devices) >= 2
    assert set(fleet.executor.devices) <= set(fleet.path)
    assert _deployment(fleet) == _jax_deployment(setup)
    for vid in (0, 1):
        np.testing.assert_array_equal(
            fleet.classify(setup["Xq"], mid=0, vid=vid), _want(setup, vid))


def test_fleet_hop_pool_bounds_the_graph_cache(setup):
    """The counterpart of the reference's one-trace test: one executor
    retargeted between a wide deployment (several hosting switches) and a
    tall one (one switch) keeps one entry per (bucket, hosting count) —
    here 2, the reference's bound too — and a retarget to a count already
    captured adds none.  No resident ``data_ptr`` ever moves."""
    wide, tall = _fleet(setup, n_stages=4), _fleet(setup, n_stages=20)
    n_wide, n_tall = len(wide.executor.devices), len(tall.executor.devices)
    assert n_wide > n_tall == 1
    assert _deployment(tall) == _jax_deployment(setup, n_stages=20)
    ex = wide.executor
    Xq, want = setup["Xq"], _want(setup, 0)
    ptrs, wide_devs = _ptrs(ex), list(ex.devices)
    np.testing.assert_array_equal(wide.classify(Xq, mid=0, vid=0), want)
    assert ex.cache_size() == 1
    tall_progs = [tall.executor.programs[d] for d in tall.executor.devices]
    wide_progs = list(wide.replan_sync()[2])
    ex.retarget(tall.path, tall.executor.devices, tall_progs)
    np.testing.assert_array_equal(wide.classify(Xq, mid=0, vid=0), want)
    assert ex.cache_size() == 2                # a new hosting count
    ex.retarget(wide.path, wide_devs, wide_progs)
    np.testing.assert_array_equal(wide.classify(Xq, mid=0, vid=0), want)
    np.testing.assert_array_equal(wide.classify(Xq, mid=0, vid=1),
                                  _want(setup, 1))
    assert ex.cache_size() == 2                # revisited: no entry added
    assert _ptrs(ex) == ptrs and len(ex.pool) == n_wide
    assert ex.cache_size() <= 1 * len({n_wide, n_tall})


def test_fleet_same_hosting_count_is_written_in_place(setup):
    """A retarget to the same hosting count with other programs shows in
    the next run through the same entry: the pool is written in place."""
    fleet = _fleet(setup)
    ex = fleet.executor
    progs = list(fleet.replan_sync()[2])
    fleet.classify(setup["Xq"], mid=0, vid=0)
    ptrs, size = _ptrs(ex), ex.cache_size()
    blanked = [empty_program(PROF, "cpu")] + progs[1:]
    ex.retarget(fleet.path, list(ex.devices), blanked)
    want = SequentialPathExecutor(blanked, n_classes=PROF.max_classes,
                                  mode="ref", graphs=False)
    pb = fleet.make_request(setup["Xq"], mid=0, vid=0)
    np.testing.assert_array_equal(ex.classify(pb).rslt,
                                  want.classify(pb).rslt)
    assert ex.cache_size() == size and _ptrs(ex) == ptrs
    ex.retarget(fleet.path, list(ex.devices), progs)
    np.testing.assert_array_equal(fleet.classify(setup["Xq"], mid=0, vid=0),
                                  _want(setup, 0))


def test_fleet_pool_grows_without_moving_its_programs(setup):
    """From one hosting switch to several: the pool grows by new resident
    programs; the first keeps its tensors."""
    tall, wide = _fleet(setup, n_stages=20), _fleet(setup, n_stages=4)
    ex = tall.executor
    first = _ptrs(ex)[0]
    wide_progs = list(wide.replan_sync()[2])
    ex.retarget(wide.path, list(wide.executor.devices), wide_progs)
    assert len(ex.pool) == len(wide_progs) and _ptrs(ex)[0] == first
    np.testing.assert_array_equal(tall.classify(setup["Xq"], mid=0, vid=1),
                                  _want(setup, 1))


def test_fleet_retargets_under_concurrent_classifies_never_tear(setup):
    """Nine threads classifying through one fleet while a writer retargets
    it between the wide and the tall deployment of the same zoo: every
    answer is the oracle's (a half-written pool, or a hop count read apart
    from the programs it counts, would not be)."""
    import sys

    wide, tall = _fleet(setup, n_stages=4), _fleet(setup, n_stages=20)
    targets = [(list(f.path), list(f.executor.devices), f.replan_sync()[2])
               for f in (wide, tall)]
    want = _want(setup, 1)
    errors, stop = [], threading.Event()

    def reader():
        try:
            for _ in range(15):
                got = wide.classify(setup["Xq"], mid=0, vid=1)
                if not np.array_equal(got, want):
                    errors.append(got)
        except Exception as e:      # reported below
            errors.append(e)

    def writer():
        i = 0
        while not stop.is_set():
            wide.executor.retarget(*targets[i % 2])
            i += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        w = threading.Thread(target=writer)
        readers = [threading.Thread(target=reader) for _ in range(9)]
        w.start()
        for t in readers:
            t.start()
        for t in readers:
            t.join(timeout=120)
        stop.set()
        w.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not w.is_alive() and not any(t.is_alive() for t in readers)
    assert errors == []
    assert wide.executor.cache_size() <= 2


def test_fleet_kill_raises_device_failure(setup):
    """A dead device anywhere on the wire path (hosting or not) fails the
    dispatch with DeviceFailure naming a dead hop."""
    fleet = _fleet(setup)
    non_hosting = [d for d in fleet.path[1:-1]
                   if d not in fleet.executor.devices]
    victim = (non_hosting or fleet.executor.devices)[0]
    fleet.kill(victim)
    with pytest.raises(DeviceFailure) as ei:
        fleet.classify(setup["Xq"], mid=0, vid=0)
    assert ei.value.device in fleet.down
    assert ei.value.path == fleet.path
    fleet.revive(victim)
    fleet.classify(setup["Xq"], mid=0, vid=0)       # healthy again


def test_fleet_kill_mid_chain_drops_the_answer(setup):
    """A kill that lands while the chain runs: the answer is computed and
    dropped (DeviceFailure after the copy-out), and the executor's lock is
    free again."""
    fleet = _fleet(setup)
    ex = fleet.executor
    victim = ex.devices[-1]
    chain = ex._chain

    def killing_chain(pb, n):
        out = chain(pb, n)
        fleet.kill(victim)
        return out
    ex._chain = killing_chain
    with pytest.raises(DeviceFailure) as ei:
        fleet.classify(setup["Xq"], mid=0, vid=0)
    assert ei.value.device == victim
    ex._chain = chain
    fleet.revive(victim)
    done = []
    t = threading.Thread(target=lambda: done.append(
        fleet.classify(setup["Xq"], mid=0, vid=0)))
    t.start()
    t.join(timeout=30)
    assert done, "the executor's lock was left held"
    np.testing.assert_array_equal(done[0], _want(setup, 0))


def test_fleet_kill_validates_device(setup):
    fleet = _fleet(setup)
    with pytest.raises(ValueError):
        fleet.kill("h0_0_0")
    with pytest.raises(ValueError):
        fleet.kill("no_such_switch")


def test_fleet_executor_swap_vs_retarget(setup):
    """Protocol swap() keeps the device set; a changed count must be
    rejected (that's a control-plane retarget, not a swap)."""
    fleet = _fleet(setup)
    ex = fleet.executor
    n = len(ex.devices)
    ex.swap([ex.programs[d] for d in ex.devices])
    with pytest.raises(ValueError):
        ex.swap([empty_program(PROF, "cpu")] * (n + 1))
    with pytest.raises(ValueError):
        ex.retarget(fleet.path, ["not_on_path"], [empty_program(PROF, "cpu")])
    with pytest.raises(ValueError):
        ex.retarget(fleet.path, ex.devices,
                    [empty_program(PROF, "cpu")] * (n + 1))
    np.testing.assert_array_equal(fleet.classify(setup["Xq"], mid=0, vid=0),
                                  _want(setup, 0))


def test_fleet_executor_is_runtime_executor(setup):
    fleet = _fleet(setup)
    assert isinstance(fleet.executor, Executor)
    assert isinstance(fleet.executor, FleetExecutor)
    assert fleet.executor.granularity == 1
    assert fleet.executor.device == torch.device("cpu")


def test_fleet_runtime_defaults_to_the_card(setup):
    """No ``device``: the fleet's engine is on ``cuda``; on a machine
    without a card, building it fails rather than falling back."""
    if torch.cuda.is_available():
        assert _fleet_on_default(setup).executor.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            _fleet_on_default(setup)


def _fleet_on_default(setup):
    return FleetRuntime(fat_tree(4), PROF, setup["tprogs"], src=SRC, dst=DST,
                        default_device=tpl.DeviceModel(n_stages=4))


# ------------------------------------------------------ heal cycle (async)
def test_fleet_heal_cycle_end_to_end(setup):
    """Kill a hosting interior switch under live traffic: the retried answer
    is identical, the new deployment is the JAX fleet's replan, and every
    control counter reflects exactly one detect->replan->drain->reinstall
    cycle."""
    fleet = _fleet(setup)
    want = _want(setup, 1)
    victim = fleet.path[2]
    Xq = setup["Xq"]

    async def main():
        async with fleet.serving(probe_interval_s=30.0):
            before = await fleet.submit(Xq, mid=0, vid=1)
            fleet.kill(victim)
            during = await fleet.submit(Xq, mid=0, vid=1)
            after = await fleet.submit(Xq, mid=0, vid=1)
            return before, during, after, fleet.latency_stats()

    before, during, after, stats = run_async(main())
    for out in (before, during, after):
        np.testing.assert_array_equal(out.rslt, want)
    assert victim not in fleet.path and victim in fleet.down
    assert _deployment(fleet) == _jax_deployment(setup, down=[victim])
    ctl = stats["control"]
    assert ctl["failures_detected"] == 1
    assert ctl["replans"] == ctl["drains"] == ctl["reinstalls"] == 1
    assert ctl["retries"] >= 1
    assert ctl["heal_failures"] == 0
    assert ctl["last_heal_ms"] > 0
    assert len(ctl["downtime_windows"]) == 1
    t0, t1 = ctl["downtime_windows"][0]
    assert 0 <= t0 < t1
    assert ctl["total_downtime_s"] == pytest.approx(t1 - t0)
    assert set(ctl) == set(JaxCounters().as_dict())
    lat = fleet.modeled_latencies(n=200, arrival_rate_rps=1000.0)
    assert lat.shape == (200,) and (lat > 0).all()
    assert fleet.serving_time() == \
        _jax_fleet_after(setup, victim).serving_time()


def _jax_fleet_after(setup, victim):
    jf = _jax_fleet(setup)
    jf.kill(victim)
    jf.reinstall(*jf.replan_sync())
    return jf


def test_fleet_heartbeat_detects_without_traffic(setup):
    """The probe task alone (no submits after the kill) runs the heal."""
    fleet = _fleet(setup)
    victim = fleet.path[2]

    async def main():
        async with fleet.serving(probe_interval_s=0.01):
            fleet.kill(victim)
            for _ in range(200):
                await asyncio.sleep(0.01)
                if fleet.counters.reinstalls:
                    break
            return fleet.latency_stats()

    stats = run_async(main())
    assert stats["control"]["reinstalls"] >= 1
    assert victim not in fleet.path
    assert _deployment(fleet) == _jax_deployment(setup, down=[victim])


def test_fleet_concurrent_heals_collapse(setup):
    """Many submitters racing one failure: one replan, one reinstall."""
    fleet = _fleet(setup)
    want = _want(setup, 0)

    async def main():
        async with fleet.serving(probe_interval_s=30.0):
            fleet.kill(fleet.path[2])
            outs = await asyncio.gather(
                *[fleet.submit(setup["Xq"], mid=0, vid=0) for _ in range(6)])
            return outs, fleet.latency_stats()

    outs, stats = run_async(main())
    for out in outs:
        np.testing.assert_array_equal(out.rslt, want)
    assert stats["control"]["replans"] == 1
    assert stats["control"]["reinstalls"] == 1


def test_fleet_cut_vertex_death_is_honest(setup):
    """Killing the src host's only edge switch leaves no surviving path: the
    submit surfaces RuntimeError, as the JAX planner does."""
    fleet = _fleet(setup)
    edge = fleet.path[1]
    with pytest.raises(RuntimeError, match="no surviving path"):
        _jax_deployment(setup, down=[edge])

    async def main():
        async with fleet.serving(probe_interval_s=30.0):
            fleet.kill(edge)
            with pytest.raises(RuntimeError, match="no surviving path"):
                await fleet.submit(setup["Xq"], mid=0, vid=0)
            return fleet.latency_stats()

    stats = run_async(main())
    assert stats["control"]["heal_failures"] >= 1
    assert stats["control"]["reinstalls"] == 0


def test_fleet_serving_session_is_exclusive(setup):
    fleet = _fleet(setup)
    assert fleet.control is None
    assert fleet.runtime is fleet.zoo.runtime

    async def main():
        async with fleet.serving(probe_interval_s=30.0):
            assert fleet.control is not None
            with pytest.raises(RuntimeError, match="already serving"):
                async with fleet.serving():
                    pass
    run_async(main())
    assert fleet.control is None


def test_fleet_not_serving_raises(setup):
    fleet = _fleet(setup)
    with pytest.raises(RuntimeError, match="not serving"):
        run_async(fleet.submit(setup["Xq"], mid=0, vid=0))
    with pytest.raises(RuntimeError, match="not serving"):
        fleet.latency_stats()


# --------------------------------------------- heal vs shutdown ownership
def test_fleet_heal_interrupted_by_shutdown_is_counted(setup):
    """A heal that loses its server to shutdown mid-replan raises and
    counts as an interrupted heal, never a reinstall."""
    fleet = _fleet(setup)
    gate = threading.Event()
    orig_replan = fleet.replan_sync

    def slow_replan():
        gate.wait(timeout=10.0)
        return orig_replan()

    fleet.replan_sync = slow_replan

    async def main():
        async with fleet.serving(probe_interval_s=30.0):
            control = fleet.control
            fleet.kill(fleet.path[2])
            heal = asyncio.create_task(control.heal())
            await asyncio.sleep(0.05)
        gate.set()
        with pytest.raises(RuntimeError, match="drain unavailable"):
            await asyncio.wait_for(heal, timeout=15)
        return control.counters

    counters = run_async(asyncio.wait_for(main(), timeout=30))
    assert counters.interrupted_heals == 1
    assert counters.replans == 1
    assert counters.drains == 0
    assert counters.reinstalls == 0


def test_fleet_heal_broken_barrier_during_reinstall_is_counted(setup):
    """drain succeeds, then stop() breaks the barrier while the reinstall
    runs: an interrupted heal, never a completed reinstall."""
    fleet = _fleet(setup)
    fleet.kill(fleet.path[2])

    class _StoppedUnderneath:
        async def drain(self):
            pass

        def release(self):
            raise RuntimeError(
                "hold was broken by stop(): the server flushed and shut "
                "down while the control plane still owned the drain barrier")

        def add_stats_source(self, name, fn):
            pass

    async def main():
        control = ControlLoop(fleet, _StoppedUnderneath(),
                              probe_interval_s=30.0)
        await control.start()
        try:
            with pytest.raises(RuntimeError,
                               match="broken by stop.*while the reinstall"):
                await control.heal()
        finally:
            await control.stop()
        return control.counters

    counters = run_async(asyncio.wait_for(main(), timeout=30))
    assert isinstance(counters, ControlCounters)
    assert counters.interrupted_heals == 1
    assert counters.replans == 1 and counters.drains == 1
    assert counters.reinstalls == 0


# ------------------------------------------------------------ netsim
def test_acorn_faster_than_server(satdap):
    Xtr, ytr, Xte, _ = satdap
    kw = dict(max_depth=8, max_leaf_nodes=80)
    tdt = tml.DecisionTree(**kw).fit(Xtr, ytr)
    tprog = translate(tdt)
    jprog = jax_translate(jml.DecisionTree(**kw).fit(Xtr, ytr))
    h = fat_tree(4).hosts()
    plan = tpl.plan_program(tprog, fat_tree(4), h[0], h[-1], solver="dp")
    jplan = jpl.plan_program(jprog, jax_fat_tree(4), h[0], h[-1], solver="dp")
    t_acorn = tns.acorn_serving_time(plan)
    assert t_acorn == jns.acorn_serving_time(jplan)
    t_pred = tns.measure_inference_time(tdt, Xte, n_requests=50)
    nbytes = tpk.request_bytes(tprog.n_features, n_trees=1)
    assert nbytes == jpk.request_bytes(jprog.n_features, n_trees=1)
    t_server = tns.server_serving_time(t_pred, nbytes)
    assert t_server == jns.server_serving_time(t_pred, nbytes)
    assert t_acorn < t_server
    assert t_acorn < 0.3e-3


def test_request_response_size_asymmetry():
    rq, rs = tpk.request_bytes(46, n_trees=5), tpk.response_bytes()
    assert (rq, rs) == (jpk.request_bytes(46, n_trees=5),
                        jpk.response_bytes())
    assert rq > rs


@pytest.mark.parametrize("kw", [
    dict(n=500, seed=1),
    dict(n=500, seed=1, downtime_windows=(), arrival_rate_rps=None),
    dict(n=800, seed=7, arrival_rate_rps=2000.0),
    dict(n=800, seed=7, arrival_rate_rps=2000.0,
         downtime_windows=((0.05, 0.15),), return_arrivals=True),
    dict(n=300, seed=3, downtime_windows=((0.001, 0.002), (0.01, 0.02))),
], ids=["static", "static-explicit", "poisson", "window", "uniform-windows"])
def test_simulate_serving_equals_jax(kw):
    got = tns.simulate_serving(1e-4, **kw)
    want = jns.simulate_serving(1e-4, **kw)
    if not kw.get("return_arrivals"):
        got, want = (got,), (want,)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


def test_simulation_is_stable():
    s = tns.simulate_serving(1e-4, n=500, seed=1)
    assert abs(np.median(s) - 1e-4) / 1e-4 < 0.05
    assert (s > 0).all()


def test_forwarding_overhead_bounds():
    r = tns.forwarding_overhead()
    assert r == jns.forwarding_overhead()
    assert 0 < r["latency_overhead_frac"] <= 0.033
    assert 0.9 < r["goodput_frac"] < 1.0


def test_simulate_serving_fault_window_holds_requests():
    base, rate, window = 1e-4, 2000.0, (0.05, 0.15)
    s, t = tns.simulate_serving(base, n=800, seed=7, arrival_rate_rps=rate,
                                downtime_windows=(window,),
                                return_arrivals=True)
    s0 = tns.simulate_serving(base, n=800, seed=7, arrival_rate_rps=rate)
    inside = (t >= window[0]) & (t < window[1])
    assert inside.any() and (~inside).any()
    np.testing.assert_allclose(s[inside], s0[inside] + (window[1] - t[inside]))
    np.testing.assert_array_equal(s[~inside], s0[~inside])
    assert s[inside].max() > 0.5 * (window[1] - window[0])


def test_serving_availability_reflects_downtime():
    base, rate, slo = 1e-4, 2000.0, 1e-3
    up = tns.simulate_serving(base, n=1000, seed=3, arrival_rate_rps=rate)
    down = tns.simulate_serving(base, n=1000, seed=3, arrival_rate_rps=rate,
                                downtime_windows=((0.1, 0.2),))
    assert tns.serving_availability(up, slo) == \
        jns.serving_availability(up, slo) > 0.99
    assert tns.serving_availability(down, slo) < \
        tns.serving_availability(up, slo)
    assert tns.serving_availability(np.array([]), slo) == 1.0
    ts, js = tns.ServerModel(), jns.ServerModel()
    assert (ts.hops, ts.host_stack_s) == (js.hops, js.host_stack_s)
    assert (ts.latency.l_e, ts.latency.l_p, ts.latency.rate_bps) == \
        (js.latency.l_e, js.latency.l_p, js.latency.rate_bps)
