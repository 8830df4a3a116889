"""The port's ``ZooServer`` and ``DataplaneRuntime`` against the JAX package's.

On the shared plane profile of ``tests/conftest.py`` and the ``satdap``
stand-in, one zoo (DT, RF and SVM in distinct version slots) is installed
into the JAX ``ZooServer`` and into the port's ``ZooServer(device="cpu")``;
every serving call must give the same answers, and admission padding must be
invisible: a ragged batch classified through the runtime is bit-identical
to the same batch classified unpadded.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import mlmodels as jml
from repro.serving import ZooServer as JaxZooServer
from repro_torch.core import mlmodels as tml
from repro_torch.core.packets import PacketBatch
from repro_torch.core.plane import PlaneProfile
from repro_torch.runtime import DataplaneRuntime, bucket_ladder, coalesce, split
from repro_torch.serving import ZooServer

FIELDS = ("packet_id", "ptype", "mid", "vid", "rslt", "rid", "features",
          "codes", "svm_acc")


def _models(ml, Xtr, ytr):
    return {0: ml.DecisionTree(max_depth=8, max_leaf_nodes=80).fit(Xtr, ytr),
            1: ml.RandomForest(n_estimators=4, max_depth=6,
                               max_leaf_nodes=40).fit(Xtr, ytr),
            2: ml.LinearSVM(epochs=60).fit(Xtr, ytr)}


MIDS = {0: 0, 1: 1, 2: 2}        # vid -> mid of the model installed there


@pytest.fixture(scope="module")
def servers(satdap, plane_profile):
    Xtr, ytr, Xte, _ = satdap
    jzoo = JaxZooServer(plane_profile)
    tzoo = ZooServer(PlaneProfile(**dataclasses.asdict(plane_profile)),
                     device="cpu")
    for vid, m in _models(jml, Xtr, ytr).items():
        jzoo.install(m, vid=vid)
    for vid, m in _models(tml, Xtr, ytr).items():
        tzoo.install(m, vid=vid)
    return jzoo, tzoo, Xte


@pytest.mark.parametrize("vid", [0, 1, 2, 3])
def test_classify_matches_jax(servers, vid):
    jzoo, tzoo, X = servers
    mid = MIDS.get(vid, 0)
    want = np.asarray(jzoo.classify(X, mid=mid, vid=vid))
    got = tzoo.classify(X, mid=mid, vid=vid)
    np.testing.assert_array_equal(got, want)
    if vid == 3:
        assert (got == -1).all()


def test_classify_coalesced_matches_jax(servers):
    jzoo, tzoo, X = servers
    rng = np.random.default_rng(5)
    reqs = []
    for n in (3, 0, 17, 1, 40):
        vid = int(rng.integers(0, 3))
        reqs.append((X[:n] if n else X[:0], MIDS[vid],
                     rng.integers(0, 3, n).astype(np.int32) if n > 1 else vid))
    want = jzoo.classify_coalesced(reqs)
    got = tzoo.classify_coalesced(reqs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_classify_split_matches_jax(servers):
    jzoo, tzoo, X = servers
    split_ = {0: 0.25, 1: 0.5, 2: 0.25}
    (jr, jv), (tr, tv) = (z.classify_split(X, mid=1, split=split_)
                          for z in (jzoo, tzoo))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tr, np.asarray(jr))
    with pytest.raises(ValueError):
        tzoo.classify_split(X, mid=1, split={0: 0.5})


def test_evict_matches_jax(satdap, plane_profile):
    Xtr, ytr, Xte, _ = satdap
    jzoo = JaxZooServer(plane_profile)
    tzoo = ZooServer(PlaneProfile(**dataclasses.asdict(plane_profile)),
                     device="cpu")
    jm = jml.DecisionTree(max_depth=5, max_leaf_nodes=20).fit(Xtr, ytr)
    tm = tml.DecisionTree(max_depth=5, max_leaf_nodes=20).fit(Xtr, ytr)
    jzoo.install(jm, vid=1, tag="a")
    tzoo.install(tm, vid=1, tag="a")
    assert tzoo.versions == jzoo.versions
    for z in (jzoo, tzoo):
        z.evict(vid=1)
    assert tzoo.versions == jzoo.versions == {}
    got = tzoo.classify(Xte, mid=0, vid=1)
    np.testing.assert_array_equal(got, np.asarray(
        jzoo.classify(Xte, mid=0, vid=1)))
    assert (got == -1).all()


@pytest.mark.parametrize("B", [1, 7, 33, 300])
def test_ragged_admission_is_bit_identical_to_unpadded(servers, B):
    """Padding to the power-of-two bucket and trimming back, on the device
    path (``run``) and the host path (``run_host``), changes no field of
    any packet — passthrough packets with intermediates included."""
    _jzoo, tzoo, X = servers
    rng = np.random.default_rng(B)
    Xb = X[np.arange(B) % X.shape[0]]
    pb = tzoo.make_request(Xb, mid=rng.integers(0, 3, B).astype(np.int32),
                           vid=rng.integers(0, 4, B).astype(np.int32))
    fwd = torch.from_numpy(rng.random(B) < 0.2)
    pb = dataclasses.replace(
        pb, ptype=torch.where(fwd, 0, 1).to(torch.int32),
        codes=torch.where(fwd[:, None], 5, pb.codes).to(torch.int32))
    want = tzoo.engine.classify(tzoo.packed, pb)
    rt = tzoo.runtime
    assert rt.bucket(B) >= B and rt.bucket(B) & (rt.bucket(B) - 1) == 0
    for out in (rt.run(pb), rt.run_host(pb)):
        assert out.batch == B
        for f in FIELDS:
            assert torch.equal(getattr(out, f), getattr(want, f)), f


def test_coalesce_split_round_trip(servers):
    _jzoo, tzoo, X = servers
    pbs = [tzoo.make_request(X[:n], mid=0, vid=0) for n in (2, 0, 5)]
    flat, offsets = coalesce(pbs)
    assert offsets == (0, 2, 2, 7) and flat.batch == 7
    for a, b in zip(split(flat, offsets), pbs):
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f))
    with pytest.raises(ValueError):
        split(flat, (0, 3))


def test_warm_drives_every_bucket(plane_profile):
    prof = PlaneProfile(**dataclasses.asdict(plane_profile))
    rt = DataplaneRuntime.for_profile(prof, device="cpu")
    seen = []
    real = rt.executor.classify
    rt.executor.classify = lambda b: seen.append(b.batch) or real(b)

    def make(b):
        return PacketBatch.make_request(
            np.zeros((b, 4), np.int32), max_features=prof.max_features,
            n_trees=prof.max_trees, n_hyperplanes=prof.max_hyperplanes)
    assert rt.warm(make, 20) == bucket_ladder(20) == (1, 2, 4, 8, 16, 32)
    assert seen == list(bucket_ladder(20))
    assert rt.run(make(0)).batch == 0


def test_install_rejects_program_for_another_slot(servers):
    _jzoo, tzoo, _X = servers
    from repro_torch.core.translator import translate
    prog = translate(tml.DecisionTree(max_depth=2).fit(
        np.zeros((8, 3), np.int32), np.arange(8) % 2), vid=1)
    with pytest.raises(ValueError, match="targets vid 1"):
        tzoo.install(prog, vid=2)
    with pytest.raises(ValueError, match="outside the plane"):
        tzoo.make_request(np.zeros((2, 3), np.int32), vid=4)
