"""The port's plane against the JAX package's, on the 204 conformance draws.

Each drawn case of ``tests/test_conformance.py`` (a random DT/RF/SVM zoo
installed by the JAX package, and a ragged batch with passthrough and
invalid-VID packets) is carried into the port with ``packed_from_arrays``
and ``batch_from_arrays``; the port's ``SwitchEngine(device="cpu")`` must
then equal the JAX ``SwitchEngine(mode="ref")`` on ``rslt``, ``codes`` and
``svm_acc`` exactly.  Further pins: the port's own translator and install
give the same tables, incremental install equals a full rebuild, an old
program stays valid, evicted slots answer -1, passthrough is untouched, and
one classify is one kernel call.
"""
import dataclasses

import numpy as np
import pytest
import torch

import test_conformance as conf
from repro.core.plane import SwitchEngine as JaxEngine
from repro_torch.core import mlmodels as tml
from repro_torch.core import plane as tp
from repro_torch.core import translator as ttr
from repro_torch.core.packets import (
    PacketType,
    batch_from_arrays,
    batch_to_arrays,
)
from repro_torch.kernels import classify_fused as cf_module
from repro_torch.kernels import ops

FIELDS = ("rslt", "codes", "svm_acc")


def port_profile(jprof):
    return tp.PlaneProfile(**dataclasses.asdict(jprof))


def port_packed(jpacked, jprof):
    arrays = {f.name: np.asarray(getattr(jpacked, f.name))
              for f in dataclasses.fields(jpacked) if f.name != "image"}
    return tp.packed_from_arrays(arrays, port_profile(jprof), "cpu")


def port_batch(jpb):
    return batch_from_arrays({f.name: np.asarray(getattr(jpb, f.name))
                              for f in dataclasses.fields(jpb)})


def assert_batches_equal(port_out, jax_out, fields=FIELDS, what=""):
    got = batch_to_arrays(port_out)
    for f in fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jax_out, f)),
                                      err_msg=f"{what} field={f}")


def assert_images_equal(a, b):
    for x, y in zip(a.fused, b.fused):
        assert torch.equal(x, y)


@pytest.mark.parametrize("V", sorted(conf.N_CASES))
def test_conformance_draws_match_jax_ref(V):
    """All 204 draws (72 + 72 + 60): the port's default CPU engine (the
    twin) and its kernel-wrapper engine (the plain version on the exec
    image) both equal the JAX oracle bit for bit."""
    jprof = conf._profile(V)
    oracle = JaxEngine(jprof, mode="ref")
    engines = [tp.SwitchEngine(port_profile(jprof), device="cpu"),
               tp.SwitchEngine(port_profile(jprof), device="cpu",
                               mode="cuda")]
    for case in range(conf.N_CASES[V]):
        _seed, _progs, jpacked, jpb = conf._draw_case(V, case, jprof)
        want = oracle.classify(jpacked, jpb)
        packed, pb = port_packed(jpacked, jprof), port_batch(jpb)
        for eng in engines:
            assert_batches_equal(eng.classify(packed, pb), want,
                                 what=f"V={V} case={case} mode={eng.mode}")


@pytest.fixture
def port_draws(monkeypatch):
    """``conf._draw_zoo`` rerun with the port's models, translator and
    install: the same rng stream, so the same zoo built by the port."""
    for name in ("DecisionTree", "RandomForest", "LinearSVM"):
        monkeypatch.setattr(conf, name, getattr(tml, name))
    monkeypatch.setattr(conf, "translate", ttr.translate)
    monkeypatch.setattr(conf, "empty_program",
                        lambda prof: tp.empty_program(prof, "cpu"))
    monkeypatch.setattr(conf, "install_program", tp.install_program)

    def draw(V, case):
        rng = np.random.default_rng(conf._seed(V, case))
        return conf._draw_zoo(rng, V, conf._seed(V, case),
                              port_profile(conf._profile(V)))
    return draw


@pytest.mark.parametrize("V,case", [(1, 0), (1, 5), (4, 3), (4, 17),
                                    (8, 8), (8, 41)])
def test_port_translator_and_install_give_the_same_tables(port_draws, V,
                                                          case):
    _seed, _progs, jpacked, _pb = conf._draw_case(V, case, conf._profile(V))
    want = port_packed(jpacked, conf._profile(V))
    _progs_t, got = port_draws(V, case)
    for f in dataclasses.fields(got):
        if f.name != "image":
            assert torch.equal(getattr(got, f.name), getattr(want, f.name)), \
                f.name
    assert_images_equal(got.image, want.image)


@pytest.fixture(scope="module")
def zoo(satdap):
    """A DT, an RF and an SVM trained by the port on ``satdap``."""
    Xtr, ytr, Xte, _ = satdap
    dt = tml.DecisionTree(max_depth=8, max_leaf_nodes=100).fit(Xtr, ytr)
    rf = tml.RandomForest(n_estimators=5, max_depth=6,
                          max_leaf_nodes=50).fit(Xtr, ytr)
    svm = tml.LinearSVM(epochs=100).fit(Xtr, ytr)
    return Xte, dt, rf, svm


def _req(X, prog, prof):
    return tp.PacketBatch.make_request(
        X, mid=prog.mid, vid=prog.vid, max_features=prof.max_features,
        n_trees=prof.max_trees, n_hyperplanes=prof.max_hyperplanes,
        max_versions=prof.max_versions)


def test_plane_equals_models(zoo, plane_profile):
    """Each model installed into its own slot classifies like its
    ``predict`` (the SVM within the fixed-point slack the JAX plane pins,
    ``tests/test_plane.py``)."""
    Xte, dt, rf, svm = zoo
    prof = port_profile(plane_profile)
    eng = tp.SwitchEngine(prof, device="cpu")
    packed = eng.empty()
    for vid, model in enumerate((dt, rf, svm)):
        prog = ttr.translate(model, vid=vid)
        packed = eng.install(packed, prog)
        out = eng.classify(packed, _req(Xte, prog, prof))
        agree = (out.rslt.numpy() == model.predict(Xte)).mean()
        assert agree > 0.97 if model is svm else agree == 1.0


def test_incremental_install_equals_full_rebuild(zoo, plane_profile):
    """Every install / evict re-preps one slot; the spliced image equals a
    from-scratch build of the same source tables, and the program before
    each write stays as it was."""
    Xte, dt, rf, svm = zoo
    prof = port_profile(plane_profile)
    packed = tp.empty_program(prof, "cpu")
    steps = [("install", ttr.translate(dt, vid=0)),
             ("install", ttr.translate(svm, vid=0)),
             ("install", ttr.translate(rf, vid=2)),
             ("evict", (0, "tree")),
             ("install", ttr.translate(svm, vid=3)),
             ("evict", (2, "all")),
             ("evict", (3, "svm"))]
    for op, arg in steps:
        before = {f.name: getattr(packed, f.name).clone()
                  for f in dataclasses.fields(packed) if f.name != "image"}
        before_img = [x.clone() for x in packed.image.fused]
        old = packed
        if op == "install":
            packed = tp.install_program(packed, arg, prof)
        else:
            packed = tp.evict_program(packed, prof, vid=arg[0], kind=arg[1])
        assert_images_equal(packed.image, tp.build_exec_image(packed))
        for name, t in before.items():
            assert torch.equal(getattr(old, name), t), name
        for x, y in zip(old.image.fused, before_img):
            assert torch.equal(x, y)


def test_evicted_and_empty_slots_answer_minus_one(zoo, plane_profile):
    Xte, dt, _rf, svm = zoo
    prof = port_profile(plane_profile)
    eng = tp.SwitchEngine(prof, device="cpu")
    p_dt, p_svm = ttr.translate(dt, vid=1), ttr.translate(svm, vid=1)
    packed = eng.install(eng.install(eng.empty(), p_dt), p_svm)
    assert (eng.classify(packed, _req(Xte, p_dt, prof)).rslt.numpy()
            == dt.predict(Xte)).all()
    packed = eng.evict(packed, vid=1, kind="tree")
    assert (eng.classify(packed, _req(Xte, p_dt, prof)).rslt == -1).all()
    assert (eng.classify(packed, _req(Xte, p_svm, prof)).rslt >= 0).all()
    packed = eng.evict(packed, vid=1)
    assert (eng.classify(packed, _req(Xte, p_svm, prof)).rslt == -1).all()
    empty_slot = dataclasses.replace(p_dt, vid=2)
    assert (eng.classify(packed, _req(Xte, empty_slot, prof)).rslt
            == -1).all()


@pytest.mark.parametrize("mode", [None, "cuda"])
def test_passthrough_packets_untouched(zoo, plane_profile, mode):
    """FORWARD / RESPONSE packets with nonzero intermediates keep rslt,
    codes and svm_acc bit for bit, beside classified REQUEST packets."""
    Xte, dt, _rf, _svm = zoo
    prof = port_profile(plane_profile)
    eng = tp.SwitchEngine(prof, device="cpu", mode=mode)
    prog = ttr.translate(dt)
    packed = eng.install(eng.empty(), prog)
    B = 64
    pb = _req(Xte[:B], prog, prof)
    rng = np.random.default_rng(7)
    fwd = torch.from_numpy(rng.random(B) < 0.5)
    pb = dataclasses.replace(
        pb,
        ptype=torch.where(fwd, PacketType.FORWARD, PacketType.REQUEST)
        .to(torch.int32),
        codes=torch.where(fwd[:, None], torch.from_numpy(rng.integers(
            -2**31, 2**31, pb.codes.shape).astype(np.int32)), pb.codes),
        svm_acc=torch.where(fwd[:, None], torch.from_numpy(rng.integers(
            -99, 99, pb.svm_acc.shape).astype(np.int32)), pb.svm_acc),
        rslt=torch.where(fwd, torch.from_numpy(
            rng.integers(-1, 5, B).astype(np.int32)), pb.rslt))
    out = eng.classify(packed, pb)
    for f in FIELDS:
        assert torch.equal(getattr(out, f)[fwd], getattr(pb, f)[fwd]), f
    assert (out.rslt[~fwd].numpy() == dt.predict(Xte[:B])[~fwd.numpy()]).all()


def test_one_kernel_call_per_classify(zoo, plane_profile, monkeypatch):
    """Classify reaches the kernel wrapper exactly once, with the exec
    image bound (no per-call operand prep)."""
    Xte, dt, _rf, _svm = zoo
    prof = port_profile(plane_profile)
    eng = tp.SwitchEngine(prof, device="cpu", mode="cuda")
    prog = ttr.translate(dt)
    packed = eng.install(eng.empty(), prog)
    calls = []
    real = ops.classify_fused

    def counting(*args):
        calls.append(args[4])
        return real(*args)
    monkeypatch.setattr(ops, "classify_fused", counting)
    monkeypatch.setattr(ops.tiling, "prep_classify_fused", None)
    for B in (1, 7, 33):
        eng.classify(packed, _req(Xte[:B], prog, prof))
    assert len(calls) == 3
    assert all(c is packed.image.fused for c in calls)
    assert cf_module.classify_fused.launches == 0    # no card: no launch
