"""The port's graph cache (``runtime/graphs.py``) against the JAX package's
jit cache, on the CPU.

On the CPU a cache entry runs its classify eagerly on the same static
buffers a CUDA graph would read, so what runs here is the bucketing, the
staging, the in-place slot writes and the bookkeeping; the capture itself
is the card's (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 10).
The port's ``cache_size`` must count what the JAX runtime's counts on the
same ragged sizes, stay put on replays and across ``swap``, install and
evict, and every answer must equal the JAX ``SwitchEngine(mode="ref")``
bit for bit.
"""
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from repro.core import mlmodels as jml
from repro.core.plane import PlaneProfile as JaxProfile
from repro.core.plane import SwitchEngine as JaxEngine
from repro.runtime import DataplaneRuntime as JaxRuntime
from repro.serving import ZooServer as JaxZooServer
from repro_torch.core import mlmodels as tml
from repro_torch.core import plane as tp
from repro_torch.core.packets import (
    PacketBatch,
    PacketType,
    flat_of,
    flat_size,
    flat_views,
    layout,
    pack_flat,
)
from repro_torch.core.translator import translate
from repro_torch.runtime import (
    DataplaneRuntime,
    SequentialPathExecutor,
    ShardedExecutor,
    SingleSwitchExecutor,
    bucket_ladder,
)
from repro_torch.runtime.staging import StagingPool
from repro_torch.serving import ZooServer
from repro_torch.serving.fleet import FleetExecutor
from test_torch_plane import assert_batches_equal, port_packed, port_profile

SIZES = (1, 7, 63, 64, 65)
FIELDS = ("packet_id", "ptype", "mid", "vid", "rslt", "rid", "features",
          "codes", "svm_acc")


def _models(ml, Xtr, ytr):
    return {0: ml.DecisionTree(max_depth=6, max_leaf_nodes=40).fit(Xtr, ytr),
            1: ml.RandomForest(n_estimators=3, max_depth=5,
                               max_leaf_nodes=24).fit(Xtr, ytr),
            2: ml.LinearSVM(epochs=40).fit(Xtr, ytr)}


MIDS = {0: 0, 1: 1, 2: 2, 3: 0}


# narrow enough that a classify on the CPU is cheap, wide enough for the
# satdap models below (36 features, depth 6, 40 leaves, 6 hyperplanes)
PROFILE = JaxProfile(max_features=36, max_trees=4, max_layers=8,
                     max_entries_per_layer=64, max_leaves=64, max_classes=8,
                     max_hyperplanes=8, max_versions=4)


@pytest.fixture(scope="module")
def zoos(satdap):
    """The zoo (DT, RF, SVM; slot 3 empty) in the JAX ``ZooServer``; the
    port's zoos carry its tables (``_port_zoo``)."""
    Xtr, ytr, Xte, _ = satdap
    jzoo = JaxZooServer(PROFILE)
    for vid, m in _models(jml, Xtr, ytr).items():
        jzoo.install(m, vid=vid)
    return jzoo, Xte


@pytest.fixture(scope="module")
def cases(zoos):
    """Ragged traffic and the JAX ``SwitchEngine(mode="ref")``'s answer to
    it, by batch size."""
    jzoo, X = zoos
    oracle = JaxEngine(jzoo.profile, mode="ref")
    tzoo = _port_zoo(jzoo, graphs=False)
    out = {}
    for B in SIZES + (130,):
        jpb, tpb = _batches(jzoo, tzoo, _traffic(X, B, 100 + B))
        out[B] = tpb, oracle.classify(jzoo.packed, jpb)
    return out


def _port_zoo(jzoo, mode=None, **kw):
    """A port ``ZooServer`` holding the JAX zoo's tables (resident)."""
    jprof = jzoo.profile
    ex = SingleSwitchExecutor(port_profile(jprof), mode=mode, device="cpu",
                              packed=port_packed(jzoo.packed, jprof), **kw)
    return ZooServer(port_profile(jprof), executor=ex)


def _traffic(X, B, seed):
    """B requests over the four slots, a fifth FORWARD passthrough packets
    with intermediates; the same batch for both packages (numpy)."""
    rng = np.random.default_rng(seed)
    vid = rng.integers(0, 4, B).astype(np.int32)
    mid = np.asarray([MIDS[v] for v in vid], np.int32)
    feats = X[np.arange(B) % X.shape[0]]
    fwd = rng.random(B) < 0.2
    return dict(features=feats, mid=mid, vid=vid, fwd=fwd,
                codes=rng.integers(1, 2**20, B).astype(np.uint32),
                acc=rng.integers(-99, 99, B).astype(np.int32),
                rslt=rng.integers(0, 9, B).astype(np.int32))


def _batches(jzoo, tzoo, t):
    """The traffic as a JAX batch and as the port's."""
    jpb = jzoo.make_request(t["features"], mid=t["mid"], vid=t["vid"])
    tpb = tzoo.make_request(t["features"], mid=t["mid"], vid=t["vid"])
    fwd = t["fwd"]
    ptype = np.where(fwd, PacketType.FORWARD, PacketType.REQUEST)
    T, H = jpb.codes.shape[1], jpb.svm_acc.shape[1]
    codes = np.where(fwd[:, None], t["codes"][:, None], 0).astype(np.uint32)
    codes = np.broadcast_to(codes, (len(fwd), T))
    acc = np.broadcast_to(np.where(fwd[:, None], t["acc"][:, None], 0),
                          (len(fwd), H)).astype(np.int32)
    rslt = np.where(fwd, t["rslt"], -1).astype(np.int32)
    jpb = dataclasses.replace(jpb, ptype=ptype.astype(np.int32),
                              codes=codes, svm_acc=acc, rslt=rslt)
    tpb = dataclasses.replace(
        tpb, ptype=torch.from_numpy(ptype.astype(np.int32)),
        codes=torch.from_numpy(codes.view(np.int32).copy()),
        svm_acc=torch.from_numpy(acc.copy()), rslt=torch.from_numpy(rslt))
    return jpb, tpb


def test_cache_size_counts_the_buckets_as_the_jax_runtime(zoos):
    """Sizes 1, 7, 63, 64, 65 land in buckets {1, 8, 64, 128}: the port's
    cache holds one entry per bucket, as many as the JAX runtime's jit
    cache holds traces on the same sizes."""
    jzoo, X = zoos
    jrt = JaxRuntime.for_profile(jzoo.profile)
    tzoo = _port_zoo(jzoo)
    for B in SIZES:
        t = _traffic(X, B, B)
        jpb, tpb = _batches(jzoo, tzoo, t)
        jrt.run(jpb)
        tzoo.runtime.run(tpb)
    keys = tzoo.executor._cache.keys()
    assert sorted(k[0] for k in keys) == [1, 8, 64, 128]
    assert tzoo.cache_size() == jrt.cache_size() == 4


def test_replaying_every_size_adds_nothing(zoos):
    """Every size within the warmed buckets replays an entry; warming the
    ladder adds exactly the buckets not yet seen."""
    jzoo, X = zoos
    tzoo = _port_zoo(jzoo)
    for B in SIZES:
        tzoo.classify(X[:B], mid=0, vid=0)
    for B in (1, 5, 6, 8, 33, 50, 63, 64, 65, 100, 127, 128):
        tzoo.classify(X[np.arange(B) % len(X)], mid=0, vid=0)
    assert tzoo.cache_size() == 4

    def make(b):
        return tzoo.make_request(np.zeros((b, 4), np.int32))
    ladder = tzoo.runtime.warm(make, 128)
    assert ladder == bucket_ladder(128)
    assert tzoo.cache_size() == len(ladder) == 8
    tzoo.runtime.warm(make, 128)
    assert tzoo.cache_size() == 8


@pytest.mark.parametrize("mode", [None, "cuda", "unfused", "unfused-cuda",
                                  "layerwise", "layerwise-cuda"])
def test_graph_cache_path_equals_jax_ref(zoos, cases, mode):
    """``run`` and ``run_host`` through the cache, at ragged sizes, in every
    mode (twins, and the kernels' plain versions on the exec image), equal
    the JAX ``SwitchEngine(mode="ref")`` on rslt, codes and svm_acc;
    passthrough packets come out whole."""
    jzoo, _X = zoos
    tzoo = _port_zoo(jzoo, mode=mode)
    for B, (tpb, want) in cases.items():
        for out in (tzoo.runtime.run(tpb), tzoo.runtime.run_host(tpb)):
            assert out.batch == B
            assert_batches_equal(out, want, what=f"mode={mode} B={B}")
            fwd = tpb.ptype == PacketType.FORWARD
            for f in FIELDS:
                assert torch.equal(getattr(out, f)[fwd], getattr(tpb, f)[fwd])
    assert tzoo.cache_size() == 5          # buckets 1, 8, 64, 128, 256


def test_install_and_evict_show_in_the_next_run_in_place(zoos, satdap):
    """An install into the empty slot and an evict, each between two runs
    of the same bucket: the next run answers with the new tables (equal to
    the JAX zoo given the same writes), no resident tensor moves, and the
    cache keeps its one entry."""
    jzoo0, X = zoos
    Xtr, ytr, _, _ = satdap
    jzoo = JaxZooServer(PROFILE)
    tzoo = _port_zoo(jzoo0)
    for vid, m in _models(jml, Xtr, ytr).items():
        jzoo.install(m, vid=vid)
    oracle = JaxEngine(jzoo.profile, mode="ref")
    ptrs = [x.data_ptr() for x in tp.program_tensors(tzoo.packed)]
    jpb, tpb = _batches(jzoo, tzoo, _traffic(X, 64, 3))
    on3 = (tpb.vid == 3) & (tpb.ptype == PacketType.REQUEST)
    first = tzoo.runtime.run(tpb)
    assert (first.rslt[on3] == -1).all()
    dt = dict(max_depth=5, max_leaf_nodes=30)
    writes = [
        (lambda: jzoo.install(jml.DecisionTree(**dt).fit(Xtr, ytr), vid=3),
         lambda: tzoo.install(tml.DecisionTree(**dt).fit(Xtr, ytr), vid=3)),
        (lambda: jzoo.evict(vid=0), lambda: tzoo.evict(vid=0)),
        (lambda: jzoo.evict(vid=3, kind="tree"),
         lambda: tzoo.evict(vid=3, kind="tree"))]
    outs = []
    for jwrite, twrite in writes:
        jwrite()
        twrite()
        outs.append(tzoo.runtime.run(tpb))
        assert_batches_equal(outs[-1], oracle.classify(jzoo.packed, jpb))
    assert (outs[0].rslt[on3] >= 0).all()
    assert (outs[1].rslt[(tpb.vid == 0) & (tpb.ptype == 1)] == -1).all()
    assert torch.equal(outs[2].rslt[on3], first.rslt[on3])
    assert [x.data_ptr() for x in tp.program_tensors(tzoo.packed)] == ptrs
    assert tzoo.cache_size() == 1


def test_run_n_is_not_overwritten_by_run_n_plus_1(zoos):
    """Two runs at one bucket: the first result is a copy of its own, on
    the device path and the host path alike."""
    jzoo, X = zoos
    tzoo = _port_zoo(jzoo)
    rt = tzoo.runtime
    _, a = _batches(jzoo, tzoo, _traffic(X, 60, 1))
    _, b = _batches(jzoo, tzoo, _traffic(X, 61, 2))
    for run in (rt.run, rt.run_host):
        first = run(a)
        kept = first.map(lambda x: x.clone())
        second = run(b)
        for f in FIELDS:
            assert torch.equal(getattr(first, f), getattr(kept, f)), f
        assert not torch.equal(first.rslt[:60], second.rslt[:60])
    assert tzoo.cache_size() == 1


def test_swap_keeps_the_cache_and_the_addresses(zoos, satdap):
    """``swap`` copies a program into the resident one: the cache keeps its
    entries, no data_ptr moves, and the next run answers with the new
    program; a program of another profile is refused with nothing
    written."""
    jzoo, X = zoos
    Xtr, ytr, _, _ = satdap
    tzoo = _port_zoo(jzoo)
    for B in SIZES:
        tzoo.classify(X[:B], mid=0, vid=0)
    ptrs = [x.data_ptr() for x in tp.program_tensors(tzoo.packed)]
    eng = tp.SwitchEngine(tzoo.profile, device="cpu")
    other = eng.install(eng.empty(), translate(
        tml.DecisionTree(max_depth=3).fit(Xtr, ytr), vid=0))
    tzoo.runtime.swap(other)
    assert tzoo.cache_size() == 4
    assert [x.data_ptr() for x in tp.program_tensors(tzoo.packed)] == ptrs
    pb = tzoo.make_request(X[:63], mid=0, vid=0)
    want = tp.SwitchEngine(tzoo.profile, device="cpu", mode="ref").classify(
        other, pb)
    assert torch.equal(tzoo.runtime.run(pb).rslt, want.rslt)
    small = tp.empty_program(dataclasses.replace(tzoo.profile,
                                                 max_versions=2), "cpu")
    before = [x.clone() for x in tp.program_tensors(tzoo.packed)]
    with pytest.raises(ValueError, match="other shapes"):
        tzoo.runtime.swap(small)
    assert all(torch.equal(x, y) for x, y in
               zip(tp.program_tensors(tzoo.packed), before))


def test_executor_holds_a_program_of_its_own(zoos, satdap):
    """The executor copies the program it is given: its in-place writes
    leave the caller's program as it was."""
    jzoo, _X = zoos
    Xtr, ytr, _, _ = satdap
    given = port_packed(jzoo.packed, jzoo.profile)
    kept = [x.clone() for x in tp.program_tensors(given)]
    ex = SingleSwitchExecutor(port_profile(jzoo.profile), device="cpu",
                              packed=given)
    ex.install(translate(tml.DecisionTree(max_depth=3).fit(Xtr, ytr),
                         vid=3))
    ex.evict(vid=0)
    assert all(torch.equal(x, y)
               for x, y in zip(tp.program_tensors(given), kept))
    assert not torch.equal(ex.packed.pred_enable, given.pred_enable)


def _runtime(kind, jzoo, graphs):
    """The zoo's tables through executor ``kind``: the single switch
    behind a ``ZooServer``, or a 2-hop path (the zoo, then a hop of no
    entries) as the path executor in a mode, as the fleet, or as 2 x 2
    lanes."""
    zoo = _port_zoo(jzoo, graphs=graphs)
    if kind == "single":
        return zoo.runtime
    hops = [zoo.packed, tp.empty_program(zoo.profile, "cpu")]
    if kind == "fleet":
        ex = FleetExecutor(zoo.engine, ["s0", "s1"], ["s0", "s1"], hops,
                           down=set(), graphs=graphs)
    elif kind == "lanes-2x2":
        ex = ShardedExecutor(hops, n_classes=8, n_ports=2, n_micro=2,
                             graphs=graphs)
    else:
        ex = SequentialPathExecutor(
            hops, n_classes=8, mode=None if kind == "path" else "layerwise",
            graphs=graphs)
    return DataplaneRuntime(ex)


@pytest.mark.parametrize("kind", ["single", "path", "path-layerwise",
                                  "fleet", "lanes-2x2"])
def test_eager_executors_equal_the_graph_path(zoos, kind):
    """``graphs=False`` classifies eagerly, with the same answers as the
    graph path on every size and a ``cache_size`` of 0 where the graph
    path keeps one entry per bucket (the reference's ``jit=False``)."""
    jzoo, X = zoos
    graph, eager = _runtime(kind, jzoo, True), _runtime(kind, jzoo, False)
    zoo = _port_zoo(jzoo)
    for B in SIZES:
        _, pb = _batches(jzoo, zoo, _traffic(X, B, B))
        a, b = graph.run(pb), eager.run(pb)
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert graph.cache_size() == 4 and eager.cache_size() == 0


def test_sequential_path_through_the_cache(zoos):
    """The path executor caches one entry per (bucket, mode, hops): a hop
    chain through the cache equals the eager chain, and ``swap`` keeps the
    entries."""
    jzoo, X = zoos
    tzoo = _port_zoo(jzoo)
    hops = [tzoo.packed, tp.empty_program(tzoo.profile, "cpu")]
    for mode in (None, "layerwise"):
        rt = DataplaneRuntime(SequentialPathExecutor(hops, n_classes=8,
                                                     mode=mode))
        eager = DataplaneRuntime(SequentialPathExecutor(
            hops, n_classes=8, mode=mode, graphs=False))
        for B in SIZES:
            _, pb = _batches(jzoo, tzoo, _traffic(X, B, B))
            a, b = rt.run(pb), eager.run(pb)
            for f in FIELDS:
                assert torch.equal(getattr(a, f), getattr(b, f))
        keys = rt.executor._cache.keys()
        assert len(keys) == 4 and {k[-2:] for k in keys} == {
            (rt.executor.mode, 2)}
        rt.swap(list(reversed(hops)))
        assert rt.cache_size() == 4


def test_flat_layout_round_trips():
    """``pack_flat`` pads into one buffer whose views are the batch;
    ``flat_of`` finds that buffer under exactly such a batch."""
    rng = np.random.default_rng(0)
    pb = PacketBatch.make_request(rng.integers(0, 256, (5, 7)), mid=1,
                                  vid=rng.integers(0, 3, 5), n_trees=3,
                                  n_hyperplanes=2)
    flat = torch.full((flat_size(8, 7, 3, 2),), 99, dtype=torch.int32)
    pack_flat(pb, 8, flat)
    padded = flat_views(flat, 8, 7, 3, 2)
    assert flat_of(padded) is flat
    for f in FIELDS:
        got = getattr(padded, f)
        assert torch.equal(got[:5], getattr(pb, f))
        assert not got[5:].any()
    assert flat_of(pb) is None
    assert flat_of(padded.map(lambda x: x[:5])) is None
    assert flat_of(padded.map(lambda x: x.clone())) is None


def _derived_layout(B, F, T, H):
    """(field, offset, shape) of each field, derived field by field: the
    flat layout as it was before it was cached, the tests' reference."""
    off = 0
    for name in FIELDS:
        shape = {"features": (B, F), "codes": (B, T),
                 "svm_acc": (B, H)}.get(name, (B,))
        yield name, off, shape
        off += int(np.prod(shape))


def _derived_pack(pb, bucket, flat):
    """``pack_flat`` by the derived layout."""
    B, F, T, H = (pb.batch, pb.features.shape[1], pb.codes.shape[1],
                  pb.svm_acc.shape[1])
    out = flat.numpy()
    for name, off, shape in _derived_layout(bucket, F, T, H):
        n = B * int(np.prod(shape[1:]))
        out[off:off + n] = getattr(pb, name).numpy().reshape(-1)
        out[off + n:off + int(np.prod(shape))] = 0


@pytest.mark.parametrize("widths", [(60, 8, 12), (7, 3, 2), (0, 0, 0),
                                    (4, 0, 1)])
@pytest.mark.parametrize("B", [1, 5, 64, 4095, 4096])
def test_cached_layout_gives_the_derived_offsets_and_bytes(B, widths):
    """The layout computed once per shape puts every field where the
    field-by-field derivation puts it: ``flat_views``' offsets and shapes,
    ``flat_size``, and ``pack_flat``'s bytes (a batch of B - 1 packets,
    padded) are the same; ``flat_of`` finds the buffer under the views and
    none under the three batches that are not exactly its views."""
    F, T, H = widths
    rng = np.random.default_rng(B + F)
    want = list(_derived_layout(B, F, T, H))
    size = sum(int(np.prod(shape)) for _, _, shape in want)
    lay = layout(B, F, T, H)
    assert flat_size(B, F, T, H) == size == lay.offsets[-1] + lay.sizes[-1]
    flat = torch.arange(size, dtype=torch.int32)
    views = flat_views(flat, B, F, T, H)
    for name, off, shape in want:
        x = getattr(views, name)
        assert x.storage_offset() == off and tuple(x.shape) == shape, name
        assert x.is_contiguous() and x._base is flat, name
    assert flat_of(views) is flat
    pb = PacketBatch.make_request(
        rng.integers(0, 256, (B - 1, F)), mid=rng.integers(0, 3, B - 1),
        vid=2, n_trees=T, n_hyperplanes=H)
    pb.codes.random_(-2**31, 2**31)
    got, ref = (torch.full((size,), 99, dtype=torch.int32) for _ in range(2))
    pack_flat(pb, B, got)
    _derived_pack(pb, B, ref)
    assert torch.equal(got, ref)
    assert flat_of(pb) is None
    assert flat_of(views.map(lambda x: x[:B - 1])) is None
    assert flat_of(views.map(lambda x: x.clone())) is None


def _request_args(B, per_packet, seed):
    rng = np.random.default_rng(seed)
    if per_packet:
        vid = rng.integers(0, 4, B).astype(np.int32)
        mid = np.asarray([MIDS[v] for v in vid], np.int32)
    else:
        mid, vid = 1, 1
    return dict(features=rng.integers(0, 256, (B, 30)), mid=mid, vid=vid)


def _staged_by(zoo, monkeypatch):
    """Record, on every executor call handed a flat batch, its buffer and
    a copy of its bits taken as it arrives."""
    seen = []
    classify = zoo.executor.classify

    def recording(batch):
        flat = flat_of(batch)
        if flat is not None:
            seen.append((flat, flat.clone()))
        return classify(batch)
    monkeypatch.setattr(zoo.executor, "classify", recording)
    return seen


@pytest.mark.parametrize("per_packet", [False, True])
@pytest.mark.parametrize("B", [33, 63, 64])
def test_request_written_in_place_is_make_requests_padded_batch(
        zoos, monkeypatch, B, per_packet):
    """``classify`` writes its request straight into a staging buffer at
    its bucket (64 for B below, one under and at it, scalar and per-packet
    MID / VID, 30 of the plane's 36 features): the executor is handed the
    batch ``pack_flat(make_request(...), bucket, .)`` writes, element for
    element, and answers as ``run`` of ``make_request`` does."""
    jzoo, _ = zoos
    zoo = _port_zoo(jzoo)
    seen = _staged_by(zoo, monkeypatch)
    args = _request_args(B, per_packet, B)
    prof = zoo.profile
    want = torch.full((flat_size(64, prof.max_features, prof.max_trees,
                                 prof.max_hyperplanes),), 99,
                      dtype=torch.int32)
    pb = zoo.make_request(args["features"], mid=args["mid"], vid=args["vid"])
    pack_flat(pb, 64, want)
    for _ in range(2):      # a new buffer, then the same one reused
        got = zoo.classify(args["features"], mid=args["mid"],
                           vid=args["vid"], device_out=True)
        assert torch.equal(seen[-1][1], want)
        seen[-1][0].fill_(99)      # whatever a reused buffer held
        ref = zoo.runtime.run(pb)
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert len(seen) == 2 and seen[0][0] is seen[1][0]
    assert zoo.runtime.staging_stats() == {"reused": 1, "made": 1}


@pytest.mark.parametrize("bad", ["vid", "features"])
def test_request_written_in_place_is_checked_as_make_request(zoos, bad):
    """An out-of-range VID and more features than the plane's raise the
    ``ValueError`` ``make_request`` raises, and the staging buffer goes
    back to the pool."""
    jzoo, X = zoos
    zoo = _port_zoo(jzoo)
    kw = dict(features=X[:9], mid=0, vid=0)
    if bad == "vid":
        kw["vid"] = np.asarray([0] * 8 + [4], np.int32)
    else:
        kw["features"] = np.zeros((9, 37), np.int32)
    with pytest.raises(ValueError) as built:
        zoo.make_request(**kw)
    with pytest.raises(ValueError) as written:
        zoo.classify(**kw)
    assert str(written.value) == str(built.value)
    zoo.classify(X[:9], mid=0, vid=0)
    assert zoo.runtime.staging_stats() == {"reused": 1, "made": 1}


def test_empty_request_is_answered_without_a_buffer(zoos):
    """A request of no packets comes back at once as the empty batch
    ``make_request`` builds at the zoo's row widths, field for field, and
    touches neither the staging pool nor the executor."""
    jzoo, _ = zoos
    zoo = _port_zoo(jzoo)
    X = np.zeros((0, 30), np.int32)
    got = zoo.classify(X, mid=0, vid=0, device_out=True)
    want = zoo.make_request(X, mid=0, vid=0)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
    assert zoo.classify(X, mid=0, vid=0).shape == (0,)
    assert zoo.runtime.staging_stats() == {"reused": 0, "made": 0}
    assert zoo.runtime.cache_size() == 0


class _Echo(SingleSwitchExecutor):
    """Answers with the batch it is handed: views of the staging buffer."""

    def classify(self, batch):
        return batch


def _two_runs_at_one_bucket(zoo):
    """Two classifies at bucket 64 through the staging pool; the first
    answer must come out as it was after the second."""
    first = zoo.classify(**_request_args(60, True, 1), device_out=True)
    kept = first.map(lambda x: x.clone())
    second = zoo.classify(**_request_args(61, True, 2), device_out=True)
    for f in FIELDS:
        assert torch.equal(getattr(first, f), getattr(kept, f)), f
    assert not torch.equal(first.features, second.features[:60])


@pytest.mark.parametrize("graphs", [True, False])
def test_run_n_is_not_overwritten_through_a_reused_buffer(zoos, graphs):
    """Two classifies at one bucket through the staging pool: the first
    answer is a copy of its own.  The graph cache copies its static buffer
    out, and its eager path runs on a copy of the batch, so either way the
    second call reuses the buffer."""
    jzoo, _ = zoos
    zoo = _port_zoo(jzoo, graphs=graphs)
    _two_runs_at_one_bucket(zoo)
    assert zoo.runtime.staging_stats() == {"reused": 1, "made": 1}


def test_an_answer_holding_the_buffer_takes_it_out_of_the_pool(zoos):
    """On the host, an executor whose answer holds views of the staging
    buffer keeps that buffer: it leaves the pool with the answer, and the
    second call makes a new one."""
    jzoo, _ = zoos
    jprof = jzoo.profile
    zoo = ZooServer(port_profile(jprof), executor=_Echo(
        port_profile(jprof), device="cpu",
        packed=port_packed(jzoo.packed, jprof)))
    _two_runs_at_one_bucket(zoo)
    assert zoo.runtime.staging_stats() == {"reused": 0, "made": 2}


class _Pending:
    """A stand-in CUDA event, pending until told otherwise."""

    def __init__(self) -> None:
        self.done = False

    def record(self, stream) -> None:
        self.done = False

    def query(self) -> bool:
        return self.done


def test_staging_pool_counts_and_never_hands_out_a_busy_buffer(monkeypatch):
    """Checkouts count as reused or made; a buffer whose event is pending
    is not handed out (a new one is made, no wait), and is again once the
    event completes; shapes keep pools of their own."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    pool = StagingPool("cpu")
    a = pool.checkout(8, 3, 2, 1)
    a.event = _Pending()
    b = pool.checkout(8, 3, 2, 1)
    assert b is not a
    pool.release(a)
    c = pool.checkout(8, 3, 2, 1)
    assert c is not a and c is not b
    a.event.done = True
    assert pool.checkout(8, 3, 2, 1) is a
    pool.release(c)
    assert pool.checkout(8, 3, 2, 1) is c
    assert pool.checkout(16, 3, 2, 1).shape == (16, 3, 2, 1)
    assert pool.stats() == {"reused": 2, "made": 4}


def test_concurrent_runs_and_writes_never_tear(zoos, satdap):
    """Eight threads run the same bucket while a ninth installs and evicts
    slot 3 in place, with the interpreter switching threads every 10 us:
    every answer is the zoo's with the slot either empty or installed,
    never a mix."""
    jzoo, X = zoos
    Xtr, ytr, _, _ = satdap
    tzoo = _port_zoo(jzoo)
    prog = translate(tml.DecisionTree(max_depth=4).fit(Xtr, ytr), vid=3)
    _, pb = _batches(jzoo, tzoo, _traffic(X, 50, 9))
    empty = tzoo.runtime.run_host(pb).rslt.clone()
    tzoo.install(prog, vid=3)
    full = tzoo.runtime.run_host(pb).rslt.clone()
    assert not torch.equal(empty, full)
    errors, stop = [], threading.Event()

    def reader():
        try:
            for _ in range(15):
                got = tzoo.runtime.run_host(pb).rslt
                if not (torch.equal(got, empty) or torch.equal(got, full)):
                    errors.append("torn")
        except Exception as e:   # reported below
            errors.append(e)

    def writer():
        while not stop.is_set():
            tzoo.evict(vid=3)
            tzoo.install(prog, vid=3)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        w = threading.Thread(target=writer)
        readers = [threading.Thread(target=reader) for _ in range(8)]
        w.start()
        for th in readers:
            th.start()
        for th in readers:
            th.join(timeout=120)
        stop.set()
        w.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not w.is_alive() and not any(th.is_alive() for th in readers)
    assert errors == []
    assert tzoo.cache_size() == 1
