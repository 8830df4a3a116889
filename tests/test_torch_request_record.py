"""The request record (``kernels/request_record.py``) on the CPU.

A REQUEST batch whose features all fit a byte is staged for the card as a
record (packet count, VIDs, MIDs, features as bytes) and expanded there by
``expand_request`` ahead of the classify.  Here: the host write's numpy
twin and the kernel's plain twin together give, bit for bit, the flat
batch ``pack_flat(make_request(...))`` stages today, whatever the record
held before; the twin refuses every feature that does not fit a byte and
raises ``make_request``'s errors; the staging pool keeps records apart from
flat buffers; the graph cache's record entry answers as its flat entry;
off the card every ``run_request`` takes the flat path, counted in
``request_stats()``; and a CPU runtime given a record entry (the host write
its numpy twin) takes the record path as a runtime on the card does, falls
back for features off a byte, and warms its record graphs
(``warm_requests``).  The fleet's classify takes the record path and a
kill mid-chain hands the record back, here with the numpy write and, in
its ``cuda`` case (marked ``gpu``), on a card.  The kernel and the native
write are held to these twins on a card (``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import mlmodels as tml
from repro_torch.core.packets import (
    FIELDS,
    PacketBatch,
    flat_size,
    flat_views,
    pack_flat,
)
from repro_torch.core.plane import PlaneProfile
from repro_torch.kernels.request_record import (
    expand_request,
    expand_request_plain,
    record_layout,
    write_record_plain,
)
from repro_torch.runtime import SequentialPathExecutor, SingleSwitchExecutor
from repro_torch.runtime.staging import Record, StagingPool
from repro_torch.serving import ZooServer

BUCKET, FMAX, T, H = 64, 36, 4, 8
PROFILE = PlaneProfile(max_features=FMAX, max_trees=T, max_layers=8,
                       max_entries_per_layer=64, max_leaves=64, max_classes=8,
                       max_hyperplanes=H, max_versions=4)
MIDS = (0, 1, 2, 0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _request(rng, B, F, per_packet):
    X = rng.integers(0, 256, (B, F)).astype(np.int32)
    if per_packet:
        vid = rng.integers(0, 4, B).astype(np.int32)
        return X, np.asarray([MIDS[v] for v in vid], np.int32), vid
    return X, 2, 1


def _staged_today(X, mid, vid, B=BUCKET):
    """The flat batch the flat path stages for this request."""
    pb = PacketBatch.make_request(X, mid=mid, vid=vid, max_features=FMAX,
                                  n_trees=T, n_hyperplanes=H,
                                  max_versions=4)
    flat = torch.full((flat_size(B, FMAX, T, H),), 99, dtype=torch.int32)
    pack_flat(pb, B, flat)
    return flat


def _garbage_record(rng, B=BUCKET):
    rec = Record(B, FMAX, pin=False)
    rec.buf.copy_(torch.from_numpy(
        rng.integers(0, 256, rec.buf.numel()).astype(np.uint8)))
    return rec


@pytest.mark.parametrize("per_packet", [False, True])
@pytest.mark.parametrize("F", [30, FMAX])
@pytest.mark.parametrize("B", [1, 9, 63, 64])
def test_twins_give_the_batch_staged_today(B, F, per_packet):
    """The narrow twin and the expansion's twin, from a record that held
    garbage and then a bigger request: the flat batch ``pack_flat``
    stages, bit for bit."""
    rng = np.random.default_rng(B * 100 + F + per_packet)
    rec = _garbage_record(rng)
    X0, m0, v0 = _request(rng, BUCKET, FMAX, True)
    assert write_record_plain(rec, X0, mid=m0, vid=v0, max_versions=4)
    X, mid, vid = _request(rng, B, F, per_packet)
    assert write_record_plain(rec, X, mid=mid, vid=vid, max_versions=4)
    got = expand_request_plain(rec.buf, BUCKET, FMAX, T, H)
    assert torch.equal(got, _staged_today(X, mid, vid))
    out = torch.full_like(got, 7)
    expand_request(rec.buf, out, BUCKET, FMAX, T, H)      # the CPU wrapper
    assert torch.equal(out, got)


def test_record_layout_aligns_every_part():
    for B, F in ((1, 1), (9, 30), (64, 36), (4096, 60)):
        lay = record_layout(B, F)
        assert lay.vid == 16 and lay.mid >= lay.vid + 4 * B
        assert lay.feats >= lay.mid + 4 * B and lay.nbytes >= lay.feats + B * F
        assert all(x % 16 == 0 for x in lay)
    lay = record_layout(4096, 60)
    assert lay.nbytes == 16 + 2 * 4 * 4096 + 4096 * 60       # ~0.28 MB
    assert 4 * flat_size(4096, 60, 8, 12) / lay.nbytes > 5


@pytest.mark.parametrize("bad", [-1, 256, -2**31, 2**31 - 1])
def test_narrow_twin_refuses_what_does_not_fit_a_byte(bad):
    rng = np.random.default_rng(5)
    X, mid, vid = _request(rng, 9, FMAX, True)
    X[4, 7] = bad
    assert not write_record_plain(_garbage_record(rng), X, mid=mid, vid=vid,
                                  max_versions=4)
    X[4, 7] = 255
    assert write_record_plain(_garbage_record(rng), X, mid=mid, vid=vid,
                              max_versions=4)


@pytest.mark.parametrize("bad", ["vid", "vid_scalar", "features", "mid"])
def test_narrow_twin_raises_what_make_request_raises(bad):
    rng = np.random.default_rng(6)
    kw = dict(features=rng.integers(0, 256, (9, 30)), mid=0, vid=0)
    if bad == "vid":
        kw["vid"] = np.asarray([0] * 8 + [4], np.int32)
    elif bad == "vid_scalar":
        kw["vid"] = -1
    elif bad == "features":
        kw["features"] = np.zeros((9, FMAX + 1), np.int32)
    else:
        kw["mid"] = np.zeros(8, np.int32)          # not one a packet
    with pytest.raises(ValueError) as built:
        PacketBatch.make_request(max_features=FMAX, max_versions=4, **kw)
    with pytest.raises(ValueError) as written:
        write_record_plain(_garbage_record(rng), max_versions=4, **kw)
    assert str(written.value) == str(built.value)


def test_strided_mids_and_vids_are_read_as_make_request_reads_them():
    rng = np.random.default_rng(7)
    X = rng.integers(0, 256, (9, FMAX)).astype(np.int32)
    vid = rng.integers(0, 4, 18).astype(np.int32)[::2]
    mid = np.asarray([MIDS[v] for v in vid], np.int64)       # cast, as there
    rec = _garbage_record(rng)
    assert write_record_plain(rec, X, mid=mid, vid=vid, max_versions=4)
    assert torch.equal(expand_request_plain(rec.buf, BUCKET, FMAX, T, H),
                       _staged_today(X, mid, vid))


def test_staging_pool_keeps_records_apart_and_counts_them(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    pool = StagingPool("cpu")
    rec = pool.checkout_record(64, FMAX)
    flat = pool.checkout(64, FMAX, T, H)
    assert rec.key == ("record", 64, FMAX) and flat.key == (64, FMAX, T, H)
    pool.release(rec)
    pool.release(flat)
    assert pool.checkout_record(64, FMAX) is rec
    assert pool.checkout(64, FMAX, T, H) is flat
    assert pool.checkout_record(128, FMAX) is not rec
    assert pool.stats() == {"reused": 2, "made": 3}


@pytest.fixture(scope="module")
def programs():
    """A DT, an RF and an SVM on byte features, slot 3 empty."""
    rng = np.random.default_rng(8)
    X = rng.integers(0, 256, (300, 30)).astype(np.int32)
    y = ((X[:, 0] > 128).astype(int) + (X[:, 3] > 64)
         + (X[:, 7] > 200)).astype(np.int32)
    models = {0: tml.DecisionTree(max_depth=6, max_leaf_nodes=40).fit(X, y),
              1: tml.RandomForest(n_estimators=3, max_depth=5,
                                  max_leaf_nodes=24).fit(X, y),
              2: tml.LinearSVM(epochs=40).fit(X, y)}
    zoo = ZooServer(PROFILE, device="cpu")
    for v, m in models.items():
        zoo.install(m, vid=v)
    return zoo


def _chains(zoo, graphs):
    packed = zoo.packed
    return (SingleSwitchExecutor(PROFILE, device="cpu", packed=packed,
                                 graphs=graphs),
            SequentialPathExecutor([packed, packed], n_classes=8,
                                   graphs=graphs))


@pytest.mark.parametrize("graphs", [True, False])
def test_record_entry_answers_as_the_flat_entry(programs, graphs):
    """``classify_record`` of a record (the single switch and a two-hop
    path, with and without the cache) equals ``classify`` of the batch
    staged today; with the cache the record entry is an entry of its own,
    and a replay of either adds none."""
    rng = np.random.default_rng(9)
    for ex in _chains(programs, graphs):
        rec = _garbage_record(rng)
        for B in (9, 63):
            X, mid, vid = _request(rng, B, 30, True)
            assert write_record_plain(rec, X, mid=mid, vid=vid,
                                      max_versions=4)
            got = ex.classify_record(rec.buf, (BUCKET, FMAX, T, H))
            want = ex.classify(flat_views(_staged_today(X, mid, vid),
                                          BUCKET, FMAX, T, H))
            for f in FIELDS:
                assert torch.equal(getattr(got, f), getattr(want, f)), f
            assert (got.rslt[:B] >= 0).any()
        assert ex.cache_size() == (2 if graphs else 0)
        if graphs:
            assert sum(k[-1] == "record" for k in ex._cache.keys()) == 1


def test_off_the_card_every_request_takes_the_flat_path(programs):
    """On the CPU there is no bus to save: each ``run_request`` call,
    bytes or not, is staged flat and counted as ``flat``; an empty request
    and a refused one count as neither."""
    zoo = ZooServer(PROFILE, executor=SingleSwitchExecutor(
        PROFILE, device="cpu", packed=programs.packed))
    rng = np.random.default_rng(10)
    X, mid, vid = _request(rng, 40, 30, True)
    a = zoo.classify(X, mid=mid, vid=vid)
    X2 = X.copy()
    X2[0, 0] = 300
    zoo.classify(X2, mid=mid, vid=vid)
    zoo.classify(X[:0], mid=0, vid=0)
    with pytest.raises(ValueError):
        zoo.classify(X, mid=0, vid=7)
    assert zoo.runtime.request_stats() == {"record": 0, "flat": 2}
    assert zoo.runtime.staging_stats() == {"reused": 2, "made": 1}
    assert np.array_equal(a, programs.classify(X, mid=mid, vid=vid))


@pytest.fixture
def record_zoo(programs, monkeypatch):
    """A CPU zoo whose runtime takes the record path as one on the card
    does: records on, the host write the numpy twin (the native write is
    built only where there is a card)."""
    from repro_torch.runtime import facade

    monkeypatch.setattr(facade, "write_record", write_record_plain)
    zoo = ZooServer(PROFILE, executor=SingleSwitchExecutor(
        PROFILE, device="cpu", packed=programs.packed))
    zoo.runtime._records = True
    return zoo


def test_the_record_path_answers_as_the_flat_path(programs, record_zoo):
    """Byte features by the record path, features off a byte by the flat
    path, both equal to the flat path's answers, each counted; a VID out
    of range raises ``make_request``'s error and the record goes back to
    the pool; a bucket that saw both kinds holds two entries."""
    rng = np.random.default_rng(11)
    X, mid, vid = _request(rng, 40, 30, True)
    for m, v in ((mid, vid), (1, 2)):
        got = record_zoo.classify(X, mid=m, vid=v, device_out=True)
        want = programs.runtime.run(programs.make_request(X, mid=m, vid=v))
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    Xb = X.copy()
    Xb[3, 3] = -1
    assert np.array_equal(record_zoo.classify(Xb, mid=mid, vid=vid),
                          programs.classify(Xb, mid=mid, vid=vid))
    assert record_zoo.runtime.request_stats() == {"record": 2, "flat": 1}
    with pytest.raises(ValueError) as built:
        record_zoo.make_request(X, mid=0, vid=4)
    with pytest.raises(ValueError) as written:
        record_zoo.classify(X, mid=0, vid=4)
    assert str(written.value) == str(built.value)
    before = record_zoo.runtime.staging_stats()
    record_zoo.classify(X, mid=mid, vid=vid)
    after = record_zoo.runtime.staging_stats()
    assert (after["reused"] - before["reused"], after["made"]) == \
        (1, before["made"])
    assert record_zoo.cache_size() == 2          # bucket 64: record, flat


@pytest.mark.parametrize("requests", [True, False])
def test_warm_captures_the_record_ladder_too(record_zoo, requests):
    """Where requests go as records, ``warm_requests`` after ``warm``
    drives each bucket through ``run_request`` too, so a later ``classify``
    adds no entry; ``warm`` alone (the async fronts, which never call
    ``run_request``) warms the flat entries alone."""
    def passthrough(b):
        return record_zoo.make_request(np.zeros((b, 30), np.int32))
    ladder = record_zoo.runtime.warm(passthrough, 64)
    if requests:
        assert record_zoo.runtime.warm_requests(
            64, record_zoo.row_widths) == ladder
    warmed = record_zoo.cache_size()
    assert warmed == len(ladder) * (2 if requests else 1)
    rng = np.random.default_rng(12)
    sizes = (1, 3, 33, 64)
    for B in sizes:
        X, mid, vid = _request(rng, B, 30, True)
        record_zoo.classify(X, mid=mid, vid=vid)
    captured = {record_zoo.runtime.bucket(B) for B in sizes}
    assert record_zoo.cache_size() == warmed + (
        0 if requests else len(captured))
    assert record_zoo.runtime.request_stats() == {
        "record": len(sizes) + (len(ladder) if requests else 0), "flat": 0}


def test_the_record_entry_follows_a_swapped_executor(programs, record_zoo):
    """The async engine swaps the runtime's executor (its lanes): a request
    then goes to the new executor's record entry, or flat where it has
    none (``ShardedExecutor``), with the same answers."""
    from repro_torch.runtime import ShardedExecutor

    rng = np.random.default_rng(13)
    X, mid, vid = _request(rng, 20, 30, True)
    want = programs.classify(X, mid=mid, vid=vid)
    incoming = SingleSwitchExecutor(PROFILE, device="cpu",
                                    packed=programs.packed)
    record_zoo.runtime.executor = incoming
    assert np.array_equal(record_zoo.classify(X, mid=mid, vid=vid), want)
    assert incoming.cache_size() == 1
    record_zoo.runtime.executor = ShardedExecutor([programs.packed],
                                                  n_classes=8)
    assert np.array_equal(record_zoo.classify(X, mid=mid, vid=vid), want)
    assert record_zoo.runtime.request_stats() == {"record": 1, "flat": 1}


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_fleet_classify_takes_the_record_path(monkeypatch, device):
    """``FleetRuntime.classify`` stages byte features as a request record
    and runs them through ``FleetExecutor.classify_record`` (on the CPU
    with records forced on and the numpy write), equal to mode ref on the
    monolithic install; a kill that lands mid-chain on the record entry
    raises ``DeviceFailure``, the record goes back to the pool, and after
    the revive the next call reuses it."""
    from repro_torch.core.plane import SwitchEngine
    from repro_torch.data import conformance as draws
    from repro_torch.runtime import DeviceFailure, facade
    from repro_torch.serving import FleetRuntime

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    prof = draws.profile(draws.FLEET_V)
    twin = SwitchEngine(prof, mode="ref", device=device)
    d = draws.draw_fleet_case(1, SwitchEngine(prof, device=device))
    fleet = FleetRuntime(d.network, prof, d.programs, src=d.src, dst=d.dst,
                         default_device=d.device_model, device=device)
    rt = fleet.runtime
    if device == "cpu":
        monkeypatch.setattr(facade, "write_record", write_record_plain)
        rt._records = True
    rng = np.random.default_rng(16)
    for B in (300, 64, 5):
        X = rng.integers(0, 256, (B, prof.max_features)).astype(np.int32)
        vid = rng.integers(0, prof.max_versions, B).astype(np.int32)
        want = twin.classify(d.packed, fleet.make_request(X, mid=0, vid=vid))
        assert np.array_equal(fleet.classify(X, mid=0, vid=vid),
                              want.rslt.cpu().numpy())
    assert rt.request_stats() == {"record": 3, "flat": 0}
    cache, dead = fleet.executor._cache, fleet.executor.devices[0]
    replay = cache.run_record

    def replay_then_kill(*args):
        out = replay(*args)
        fleet.kill(dead)
        return out
    before = rt.staging_stats()
    cache.run_record = replay_then_kill
    with pytest.raises(DeviceFailure) as failed:
        fleet.classify(X, mid=0, vid=vid)
    cache.run_record = replay
    assert failed.value.device == dead
    fleet.revive(dead)
    assert np.array_equal(fleet.classify(X, mid=0, vid=vid),
                          want.rslt.cpu().numpy())
    after = rt.staging_stats()
    assert (after["reused"] - before["reused"], after["made"]) == \
        (2, before["made"])
    assert rt.request_stats() == {"record": 5, "flat": 0}
