"""The port's spans (``repro_torch.runtime.trace``) and the async fronts'
dispatch records.

Off, a span is one shared no-op and records nothing.  Under torch's
profiler on the calling thread, a ``ZooServer`` classify exports
``acorn.classify`` over the request build, admission, the executor (over
its lock) and the copy out, nested as the code nests; the collector's
pauses are ``acorn.gc``; no graph is captured after warm-up.  On a path
of switches each hop's classify is an ``acorn.hop`` inside
``acorn.executor``, and ``path_stats()`` gives the plan's hops, what each
holds and the bytes a packet carries between them.  Inside a
dispatch record (``trace.recording``), spans add their durations to the
record on their own thread.  The fronts' ``latency_stats()`` split a
dispatch: to the thread + on the thread + back to the loop is the whole
dispatch, the lock's wait lies inside the thread's time, and
``pad_share`` is admission's padding by hand count.

No JAX here: the zoo is the port's own models, so the card's case runs on
a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_trace.py
"""
import asyncio
import gc
import json
import os
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.distributed_plane import build_zoo_device_programs
from repro_torch.core.mlmodels import DecisionTree, LinearSVM
from repro_torch.core.plane import PlaneProfile
from repro_torch.core.planner import DeviceModel, plan_zoo
from repro_torch.core.topology import fat_tree
from repro_torch.core.translator import translate
from repro_torch.runtime import (
    ImmediatePolicy,
    SequentialPathExecutor,
    SizeOrDeadlinePolicy,
    trace,
)
from repro_torch.serving import AsyncZooServer, ContinuousZooServer, ZooServer

PROFILE = PlaneProfile(max_features=8, max_trees=2, max_layers=6,
                       max_entries_per_layer=32, max_leaves=32, max_classes=4,
                       max_hyperplanes=2, max_versions=2)
SPLIT = ("mean_to_thread_ms", "mean_on_thread_ms", "mean_to_loop_ms")


def _zoo(device="cpu") -> ZooServer:
    rng = np.random.default_rng(0)
    X = rng.integers(0, 256, (200, 8))
    y = (X[:, 0] > 128).astype(int) + (X[:, 1] > 100)
    zoo = ZooServer(PROFILE, device=device)
    zoo.install(DecisionTree(max_depth=4).fit(X, y), vid=0)
    return zoo


def _features(n: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 8))


def _events(run) -> list:
    """``run()`` under torch's profiler on this thread: the exported
    ``acorn.*`` events as (name, start, end, thread)."""
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as p:
        run()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        p.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"])
            for e in events if e.get("ph") == "X"
            and e.get("name", "").startswith(trace.PREFIX)]


def _inside(child, parents) -> bool:
    _, s, e, tid = child
    return any(p[3] == tid and p[1] <= s and e <= p[2] for p in parents)


# ------------------------------------------------------------ the primitive
@pytest.mark.parametrize("name", ["classify", "lock", "gc", "anything"])
def test_span_off_is_the_shared_noop_and_records_nothing(name):
    assert not torch._C._autograd._profiler_enabled()
    s = trace.span(name)
    assert s is trace.span("other")
    with s:
        pass
    spans = {}
    with trace.recording(spans):
        pass
    with trace.span(name):
        pass
    assert spans == {}


@pytest.mark.parametrize("nested", [False, True])
def test_recording_adds_durations_by_name_on_its_thread(nested):
    spans, outer = {}, {}
    with trace.recording(outer):
        with trace.recording(spans) if nested else trace.recording(outer):
            s = trace.span("a")
            assert s is not trace.span("a")
            with s:
                with trace.span("b"):
                    pass
            with trace.span("a"):
                pass
        with trace.span("c"):
            pass
    got = spans if nested else outer
    assert {"a", "b"} <= set(got)
    assert got["a"] >= got["b"] >= 0.0
    assert "c" in outer and "c" not in spans
    assert trace.span("a") is trace.span("b")     # closed again


def test_recording_is_per_thread():
    """Threads recording at once, more than the cores, with a short switch
    interval: each record holds its own thread's spans and no other's.
    The collector is off meanwhile: a pause it takes on a thread is that
    thread's own ``gc`` span (``test_collector_pause_is_a_gc_span``), and
    whether one falls inside depends on what earlier tests allocated."""
    n, rounds = 3 * (os.cpu_count() or 1) + 1, 200
    got = [None] * n
    start = threading.Barrier(n)

    def work(i):
        spans = {}
        start.wait()
        with trace.recording(spans):
            for _ in range(rounds):
                with trace.span(f"t{i}"):
                    pass
        got[i] = spans

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    collecting = gc.isenabled()
    gc.disable()
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
        if collecting:
            gc.enable()
    assert not any(t.is_alive() for t in threads)
    for i, spans in enumerate(got):
        assert set(spans) == {f"t{i}"}


@pytest.mark.parametrize("reader", ["profiler", "record"])
def test_collector_pause_is_a_gc_span(reader):
    if reader == "profiler":
        def run():
            with trace.span("outer"):
                gc.collect()
        ev = _events(run)
        outer = [e for e in ev if e[0] == "acorn.outer"]
        pauses = [e for e in ev if e[0] == "acorn.gc"]
        assert len(outer) == 1 and pauses
        assert all(_inside(p, outer) for p in pauses)
    else:
        spans = {}
        with trace.recording(spans):
            gc.collect()
        assert spans["gc"] > 0.0
        spans = {}
        gc.collect()                    # no record open: nothing kept
        assert spans == {}


# ------------------------------------------------- spans on the classify path
@pytest.fixture(scope="module")
def zoo():
    return _zoo()


@pytest.fixture(scope="module")
def classify_events(zoo):
    """Three ``ZooServer.classify`` calls and one ``run_host`` under the
    profiler."""
    def run():
        for n in (5, 64, 100):
            zoo.classify(_features(n), mid=0, vid=0)
        with trace.span("host"):
            zoo.runtime.run_host(zoo.make_request(_features(7), mid=0,
                                                  vid=0))
    return _events(run)


@pytest.mark.parametrize("child,parent", [
    ("request", "classify"), ("admit", "classify"), ("executor", "classify"),
    ("lock", "executor"), ("copy_out", "classify"),
    ("admit", "host"), ("executor", "host"), ("copy_out", "host")])
def test_classify_spans_nest_as_the_code_nests(classify_events, child,
                                               parent):
    ev = classify_events
    parents = [e for e in ev if e[0] == trace.PREFIX + parent]
    children = [e for e in ev if e[0] == trace.PREFIX + child
                and _inside(e, parents)]
    # three classifies and one run_host: four executor calls
    assert len(children) == len(parents) == {"classify": 3, "host": 1,
                                             "executor": 4}[parent]
    assert len({e[3] for e in ev}) == 1


def test_classify_spans_cover_the_call_in_order(classify_events):
    """One classify's spans come in the code's order: admit (the staging
    buffer checked out), request (written in place into it), executor,
    copy out, and none overlaps the next."""
    ev = sorted(classify_events, key=lambda e: e[1])
    first = [e for e in ev if e[0] == "acorn.classify"][0]
    inner = [e for e in ev if _inside(e, [first]) and e[0] in (
        "acorn.request", "acorn.admit", "acorn.executor", "acorn.copy_out")]
    assert [e[0] for e in inner] == ["acorn.admit", "acorn.request",
                                     "acorn.executor", "acorn.copy_out"]
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_no_capture_after_warm(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs are captured only there")
    z = _zoo(device)

    def passthrough(b):
        return z.make_request(np.zeros((b, 8), np.int64), mid=0, vid=0)
    spans = {}
    with trace.recording(spans):
        z.runtime.warm(passthrough, 64)
        z.runtime.warm_requests(64, z.row_widths)
    assert ("capture" in spans) == (device == "cuda")
    after = _events(lambda: [z.classify(_features(n), mid=0, vid=0)
                             for n in (1, 3, 33, 64)])
    assert sum(e[0] == "acorn.classify" for e in after) == 4
    assert not [e for e in after if e[0] == "acorn.capture"]


# ------------------------------------------------------ a path of switches
def _path(device, graphs):
    """A tree (vid 0) and a one-hyperplane SVM (vid 1) planned over
    ``fat_tree(4)`` at 2 stages a switch, served hop by hop; the plans'
    stages by switch."""
    rng = np.random.default_rng(0)
    X = rng.integers(0, 256, (200, 8))
    y = (X[:, 0] > 128).astype(int) + (X[:, 1] > 100)
    progs = [translate(DecisionTree(max_depth=4).fit(X, y), vid=0),
             translate(LinearSVM(multi_class="ovr", epochs=20)
                       .fit(X, (X[:, 2] > 90).astype(int)), vid=1)]
    net = fat_tree(4)
    hosts = net.hosts()
    plans = plan_zoo(progs, net, hosts[0], hosts[-1],
                     default_device=DeviceModel(n_stages=2))
    switches, dps = build_zoo_device_programs(progs, plans, PROFILE, device)
    ex = SequentialPathExecutor(dps, n_classes=PROFILE.max_classes,
                                graphs=graphs)
    held = {d: {p.vid: sorted(plan.device_stages()[d])
                for p, plan in zip(progs, plans) if d in plan.device_stages()}
            for d in switches}
    return ZooServer(PROFILE, executor=ex), ex, held


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_path_hops_are_spans_and_path_stats_the_plan(device):
    """``path_stats()`` is the plan: each hop's switch, vids and stages, and
    (T + H + 1) int32 a packet between hops.  Eagerly each classify records
    one ``acorn.hop`` a hop inside its ``acorn.executor``; a captured
    graph's replays record none."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: graphs are captured only there")
    z, ex, held = _path(device, graphs=device == "cuda")
    stats = ex.path_stats()
    assert stats["hops"] == len(held) >= 3
    assert [h["switch"] for h in stats["per_hop"]] == list(held)
    assert [h["stages"] for h in stats["per_hop"]] == list(held.values())
    assert [h["vids"] for h in stats["per_hop"]] == \
        [sorted(v) for v in held.values()]
    assert {v for h in stats["per_hop"] for v in h["vids"]} == {0, 1}
    T, H = PROFILE.max_trees, PROFILE.max_hyperplanes
    assert stats["handoff_bytes"] == (T + H + 1) * 4

    vid = np.arange(40) % 2
    if device == "cuda":
        z.classify(_features(40), mid=0, vid=vid)      # captured here
    ev = _events(lambda: [z.classify(_features(40), mid=0, vid=vid)
                          for _ in range(2)])
    execs = [e for e in ev if e[0] == "acorn.executor"]
    hops = [e for e in ev if e[0] == "acorn.hop"]
    assert len(execs) == 2
    assert not [e for e in ev if e[0] == "acorn.capture"]
    if device == "cuda":
        assert hops == []
    else:
        assert len(hops) == 2 * stats["hops"]
        assert all(_inside(h, execs) for h in hops)


# ------------------------------------------------- the fronts' dispatch split
def _serve(cls, zoo, sizes, *, policy, sequential, **kw):
    async def main():
        async with cls(zoo, policy=policy, **kw) as srv:
            if sequential:
                for i, n in enumerate(sizes):
                    await srv.submit(_features(n, i), mid=0, vid=0)
            else:
                await asyncio.gather(*[srv.submit(_features(n, i), mid=0,
                                                  vid=0)
                                       for i, n in enumerate(sizes)])
            return srv.latency_stats(), list(srv._dispatch_log)
    return asyncio.run(main(), debug=True)


@pytest.mark.parametrize("cls,kw", [
    (AsyncZooServer, {}), (ContinuousZooServer, {"n_slots": 1}),
    (ContinuousZooServer, {"n_slots": 2})],
    ids=["async", "continuous-1", "continuous-2"])
def test_dispatch_split_adds_up(zoo, cls, kw):
    sizes = [int(n) for n in np.random.default_rng(3).integers(1, 40, 60)]
    stats, log = _serve(cls, zoo, sizes,
                        policy=SizeOrDeadlinePolicy(max_batch=64,
                                                    max_wait_us=200.0),
                        sequential=False, **kw)
    assert stats["dispatches"] == len(log) >= 1
    split = sum(stats[k] for k in SPLIT)
    assert split == pytest.approx(stats["mean_dispatch_ms"], rel=1e-9)
    assert 0.0 <= stats["mean_lock_wait_ms"] <= stats["mean_on_thread_ms"]
    assert min(stats[k] for k in SPLIT + ("mean_slot_wait_ms",)) >= 0.0
    for rec in log:
        assert rec.t_cut <= rec.t_pickup <= rec.t_start <= rec.t_end \
            <= rec.t_resume
        assert {"lock", "admit", "executor", "copy_out"} <= set(rec.spans)
        assert rec.spans["lock"] <= rec.spans["executor"] \
            <= rec.t_end - rec.t_start
    assert sum(r.packets for r in log) == sum(sizes)
    if cls is AsyncZooServer:           # the cut is the pickup
        assert stats["mean_slot_wait_ms"] == 0.0


@pytest.mark.parametrize("size,share", [(1, 0.0), (3, 0.25), (4, 0.0),
                                        (5, 0.375), (6, 0.25), (9, 7 / 16)])
def test_pad_share_is_the_hand_count(zoo, size, share):
    """Requests of one size, each dispatched alone: the bucket is the next
    power of two."""
    stats, log = _serve(AsyncZooServer, zoo, [size] * 5,
                        policy=ImmediatePolicy(), sequential=True)
    assert [(r.packets, r.bucket) for r in log] == \
        [(size, 1 << (size - 1).bit_length())] * 5
    assert stats["pad_share"] == pytest.approx(share, abs=1e-12)
