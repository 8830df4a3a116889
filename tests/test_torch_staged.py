"""The port's staged classify against the JAX package's.

Each plain version the four staged kernels are held to (``tree_walk``,
``tcam_match``, ``forest_vote``, ``svm_lookup``; the CUDA kernels themselves
are held to them on a card by ``tests/test_torch_gpu.py``), and the V=1
twins, must equal the JAX oracle (``repro.kernels.ref``) and the Pallas
kernel run in interpret mode, on the same numpy draws: the shape sweeps of
``tests/test_kernels.py``.  The port's ``SwitchEngine`` in the ``unfused``
and ``layerwise`` modes must equal the JAX engine's ``-ref`` modes on all 204
conformance draws, with 3 and L + 2 kernel calls per classify.  Every output
is an integer and the f32 vote scores are sums of the same weights in tree
order, so the tolerance is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_conformance as conf
from repro.core.plane import SwitchEngine as JaxEngine
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.classify_fused import classify_fused_pallas_v
from repro.kernels.svm_lookup import svm_lookup_pallas_v
from repro_torch.core import mlmodels as tml
from repro_torch.core import plane as tp
from repro_torch.core import translator as ttr
from repro_torch.core.packets import u32_bits, u32_from_bits
from repro_torch.kernels import forest_vote as fv_module
from repro_torch.kernels import ops, ref, tiling
from repro_torch.kernels import svm_lookup as svm_module
from repro_torch.kernels import tcam_match as tcam_module
from repro_torch.kernels import tree_walk as walk_module
from repro_torch.kernels.classify_fused import classify_fused_plain
from repro_torch.kernels.forest_vote import forest_vote_plain
from repro_torch.kernels.svm_lookup import svm_lookup_plain
from repro_torch.kernels.tcam_match import tcam_match_plain
from repro_torch.kernels.tree_walk import tree_walk_plain
from test_fused import _rand_fused
from test_kernels import _rand_tcam, _rand_tcam_v
from test_torch_kernels import SWEEP, to_torch
from test_torch_plane import (
    assert_batches_equal,
    port_batch,
    port_packed,
    port_profile,
)


def t(a):
    """A JAX or numpy array -> a CPU tensor (uint32 as int32 bits)."""
    a = np.asarray(a)
    return u32_bits(a) if a.dtype == np.uint32 else torch.from_numpy(
        np.array(a))


def assert_codes(port, want):
    np.testing.assert_array_equal(u32_from_bits(port), np.asarray(want))


def assert_ints(port, want):
    np.testing.assert_array_equal(port.numpy(), np.asarray(want))


# ------------------------------------------------------ per-kernel sweeps
@pytest.mark.parametrize("B,T,E,F", [(7, 1, 3, 4), (64, 4, 17, 13),
                                     (257, 8, 64, 60), (33, 2, 128, 46)])
def test_tcam_match_v1(B, T, E, F):
    """V=1: the twin and the kernel path (per-call prep, the plain version)
    equal the JAX oracle and the Pallas kernel (test_kernels.py:23)."""
    rng = np.random.default_rng(B + 100 * T)
    args = _rand_tcam(rng, B, T, E, F)
    shift = jnp.int32(rng.integers(0, 20))
    want = jref.tcam_match(*args, shift)
    assert_codes(t(jops.tcam_match(*args, shift, mode="interpret")), want)
    targs = [t(a) for a in args]
    assert_codes(ref.tcam_match(*targs, int(shift)), want)
    assert_codes(ops.tcam_match(*targs, int(shift), mode="cuda"), want)


@pytest.mark.parametrize("B,T,E,F,V", [(300, 2, 130, 20, 2),
                                       (257, 3, 150, 13, 3)])
def test_tcam_match_v_edge_shapes(B, T, E, F, V):
    """Versioned, with an empty slot 0 (test_kernels.py:128)."""
    rng = np.random.default_rng(B + V)
    codes = jnp.asarray(rng.integers(0, 2**12, (B, T)), jnp.uint32)
    feats = jnp.asarray(rng.integers(0, 256, (B, F)), jnp.int32)
    vid = jnp.asarray(rng.integers(0, V, (B,)), jnp.int32)
    tables = _rand_tcam_v(rng, B, T, E, F, V, empty_slots=(0,))
    shift = jnp.int32(rng.integers(0, 20))
    args = (codes, feats, vid, *tables, shift)
    want = jref.tcam_match_v(*args)
    assert_codes(t(jops.tcam_match_v(*args, mode="interpret")), want)
    targs = [t(a) for a in args]
    assert_codes(ref.tcam_match_v(*targs), want)
    assert_codes(ops.tcam_match_v(*targs, mode="cuda"), want)


@pytest.mark.parametrize("B,T,E,F,V,L,empty", [
    (7, 1, 3, 4, 1, 1, ()),
    (64, 4, 17, 13, 3, 5, ()),
    (300, 2, 130, 20, 2, 3, ()),
    (257, 3, 33, 46, 4, 8, (1, 3)),
    (33, 5, 64, 60, 1, 32, ()),
])
def test_tree_walk_and_its_layers(B, T, E, F, V, L, empty):
    """The walk kernel's plain version, and ``tcam_match``'s at every layer
    of the same records, equal the JAX oracle, the Pallas walk and the
    Pallas layerwise scan (test_kernels.py:84)."""
    rng = np.random.default_rng(B * 7 + L)
    codes = jnp.asarray(rng.integers(0, 2**12, (B, T)), jnp.uint32)
    feats = jnp.asarray(rng.integers(0, 256, (B, F)), jnp.int32)
    vid = jnp.asarray(rng.integers(0, V, (B,)), jnp.int32)
    tables = _rand_tcam_v(rng, B, T, E, F, V, L=L, empty_slots=empty)
    shift = jnp.asarray(rng.permutation(L), jnp.int32)
    args = (codes, feats, vid, *tables, shift)
    want = jref.tree_walk_v(*args)
    assert_codes(t(jops.tree_walk_v(*args, mode="interpret")), want)
    targs = [t(a) for a in args]
    assert_codes(ref.tree_walk_v(*targs), want)
    for mode in ("cuda", "layerwise-cuda", "layerwise-ref", "layerwise"):
        assert_codes(ops.tree_walk_v(*targs, mode=mode), want)
    walk = tiling.prep_walk(*targs[3:10], F)
    tcodes, tfeats, tvid, tshift = targs[0], targs[1], targs[2], targs[10]
    assert_codes(tree_walk_plain(tcodes, tfeats, tvid, tshift, walk), want)
    # layer by layer: each tcam_match step equals one Pallas tcam_match
    jc, pc = codes, tcodes
    for layer in range(L):
        per_layer = [a[:, layer] for a in tables]
        jc = jops.tcam_match_v(jc, feats, vid, *per_layer, shift[layer],
                               mode="interpret")
        pc = tcam_match_plain(pc, tfeats, tvid, tshift, walk, layer)
        assert_codes(pc, jc)
    assert_codes(pc, want)


@pytest.mark.parametrize("B,T,P,C", [(9, 1, 4, 2), (70, 4, 32, 5),
                                     (300, 8, 256, 25)])
def test_forest_vote_v1(B, T, P, C):
    """V=1 leaf lookup + vote, with misses and an invalid leaf column
    (test_kernels.py:44)."""
    rng = np.random.default_rng(B + P)
    pc = np.sort(rng.choice(2**16, size=(T, P), replace=False)
                 .astype(np.uint32), axis=1)
    plab = rng.integers(0, C, (T, P)).astype(np.int32)
    pv = np.ones((T, P), bool)
    pv[:, -1] = False
    codes = pc[np.arange(T)[None, :], rng.integers(0, P - 1, (B, T))]
    codes[: B // 4] = 0xFFFFFFFE
    w = rng.random(T).astype(np.float32)
    args = (codes, pc, plab, pv, w)
    want = jref.forest_predict_vote(*(jnp.asarray(a) for a in args), C)
    pallas = jops.forest_predict_vote(*(jnp.asarray(a) for a in args), C,
                                      mode="interpret")
    targs = [t(a) for a in args]
    for got in (pallas, ref.forest_predict_vote(*targs, C),
                ops.forest_predict_vote(*targs, C, mode="cuda")):
        assert_ints(t(got[0]), want[0])
        assert_ints(t(got[1]), want[1])


@pytest.mark.parametrize("B,T,P,C,V,empty", [(70, 3, 32, 5, 3, (1,)),
                                             (257, 8, 256, 25, 4, (0, 3)),
                                             (5, 1, 4, 2, 1, ())])
def test_forest_vote_v(B, T, P, C, V, empty):
    """Versioned, with evicted leaf slots (test_kernels.py:144): the plain
    version on the folded leaves equals the JAX oracle and Pallas."""
    rng = np.random.default_rng(B + V)
    pc = np.sort(rng.choice(2**16, size=(V * T * P,), replace=False)
                 .astype(np.uint32).reshape(V, T, P), axis=2)
    plab = rng.integers(0, C, (V, T, P)).astype(np.int32)
    pv = rng.random((V, T, P)) < 0.9
    for v in empty:
        pv[v] = False
    vid = rng.integers(0, V, (B,)).astype(np.int32)
    codes = pc[vid[:, None], np.arange(T)[None, :],
               rng.integers(0, P, (B, T))]
    codes[::5] = 0xFFFFFFFE
    w = rng.random((V, T)).astype(np.float32)
    args = (codes, vid, pc, plab, pv, w)
    jargs = [jnp.asarray(a) for a in args]
    want = jref.forest_predict_vote_v(*jargs, C)
    pallas = jops.forest_predict_vote_v(*jargs, C, mode="interpret")
    targs = [t(a) for a in args]
    leaves = tiling.prep_leaves(*targs[2:])
    for got in (pallas, ref.forest_predict_vote_v(*targs, C),
                ops.forest_predict_vote_v(*targs, C, mode="cuda"),
                forest_vote_plain(targs[0], targs[1], leaves, C)):
        assert_ints(t(got[0]), want[0])
        assert_ints(t(got[1]), want[1])


@pytest.mark.parametrize("B,H,F,L", [(5, 1, 3, 16), (64, 3, 14, 64),
                                     (130, 8, 46, 256), (16, 12, 8, 256)])
def test_svm_lookup_v1(B, H, F, L):
    """V=1 LUT sums (test_kernels.py:33)."""
    rng = np.random.default_rng(B + H)
    feats = rng.integers(0, L, (B, F)).astype(np.int32)
    lut = rng.integers(-60_000, 60_000, (H, F, L)).astype(np.int32)
    bias = rng.integers(-10_000, 10_000, (H,)).astype(np.int32)
    args = (feats, lut, bias)
    want = jref.svm_lookup(*(jnp.asarray(a) for a in args))
    assert_ints(t(jops.svm_lookup(*(jnp.asarray(a) for a in args),
                                  mode="interpret")), want)
    targs = [t(a) for a in args]
    assert_ints(ref.svm_lookup(*targs), want)
    assert_ints(ops.svm_lookup(*targs, mode="cuda"), want)


@pytest.mark.parametrize("B,T,E,F,V,L,P,C,H,levels,empty", SWEEP)
def test_svm_lookup_v(B, T, E, F, V, L, P, C, H, levels, empty):
    """Versioned LUT sums with a nonzero bias on the fused sweep's tables
    (empty slots included)."""
    rng = np.random.default_rng(B * 31 + V)
    args = _rand_fused(rng, B, T, E, F, V, L, P, C, H, levels,
                       empty_slots=empty)
    feats, vid, lut = args[1], args[2], args[15]
    bias = jnp.asarray(rng.integers(-10_000, 10_000, (V, H)), jnp.int32)
    want = jref.svm_lookup_v(feats, vid, lut, bias)
    assert_ints(t(svm_lookup_pallas_v(feats, vid, lut, bias,
                                      interpret=True)), want)
    tf, tv, tl, tb = (t(a) for a in (feats, vid, lut, bias))
    assert_ints(ref.svm_lookup_v(tf, tv, tl, tb), want)
    assert_ints(ops.svm_lookup_v(tf, tv, tl, tb, mode="cuda"), want)
    assert_ints(svm_lookup_plain(tf, tv, tiling.prep_lut(tl, tb)), want)


@pytest.mark.parametrize("B,T,E,F,V,L,P,C,H,levels,empty", SWEEP)
def test_staged_classify_equals_fused(B, T, E, F, V, L, P, C, H, levels,
                                      empty):
    """Both staged modes on the one operand image equal the JAX oracle's
    whole classify and its Pallas three-launch classify."""
    rng = np.random.default_rng(B * 31 + V)
    args = _rand_fused(rng, B, T, E, F, V, L, P, C, H, levels,
                       empty_slots=empty)
    want = jref.classify_fused_v(*args, C)
    unfused = jops.classify_fused_v(*args, C, mode="unfused-interpret")
    for w, u in zip(want, unfused):
        np.testing.assert_array_equal(np.asarray(w), np.asarray(u))
    targs = to_torch(args)
    prep = tiling.prep_classify_fused(*targs[3:10], *targs[11:17])
    for mode in ("unfused-cuda", "layerwise-cuda", "unfused-ref",
                 "layerwise-ref"):
        for p in (prep, None):
            codes, label, sums = ops.classify_fused_v(*targs, C, mode=mode,
                                                      prep=p)
            assert_codes(codes, want[0])
            assert_ints(label, want[1])
            assert_ints(sums, want[2])


def test_prep_classify_fused_composes_its_parts():
    rng = np.random.default_rng(21)
    targs = to_torch(_rand_fused(rng, 20, 3, 9, 7, 3, 4, 16, 4, 2, 32))
    fused = tiling.prep_classify_fused(*targs[3:10], *targs[11:17])
    walk = tiling.prep_walk(*targs[3:10], 7)
    leaves = tiling.prep_leaves(*targs[11:15])
    svm = tiling.prep_lut(*targs[15:17])
    for got, want in ((fused.walk, walk), (fused.leaves, leaves),
                      (fused.svm, svm)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_walk_prep_rejects_feature_ids_outside_the_rows():
    rng = np.random.default_rng(22)
    targs = to_torch(_rand_fused(rng, 8, 2, 4, 5, 1, 2, 8, 3, 2, 16))
    with pytest.raises(ValueError, match="feature id"):
        tiling.prep_walk(*targs[3:10], 3)


def test_tcam_match_rejects_a_layer_outside_the_records():
    rng = np.random.default_rng(23)
    targs = to_torch(_rand_fused(rng, 8, 2, 4, 5, 1, 2, 8, 3, 2, 16))
    walk = tiling.prep_walk(*targs[3:10], 5)
    with pytest.raises(ValueError, match="layer 2"):
        tcam_module.tcam_match(targs[0], targs[1], targs[2], targs[10], walk,
                               2)


def test_vid_outside_the_zoo_passes_through_every_stage():
    """The TPU kernels' version merge: a packet matching no version keeps
    its codes and gets label 0, per-tree labels 0 and sums 0."""
    rng = np.random.default_rng(24)
    B, T, E, F, V, L, P, C, H, levels = 30, 3, 8, 6, 2, 3, 16, 4, 3, 32
    targs = to_torch(_rand_fused(rng, B, T, E, F, V, L, P, C, H, levels))
    vid = torch.from_numpy(rng.choice([-1, V, V + 5], B).astype(np.int32))
    targs[2] = vid
    prep = tiling.prep_classify_fused(*targs[3:10], *targs[11:17])
    codes, feats = targs[0], targs[1]
    assert torch.equal(tree_walk_plain(codes, feats, vid, targs[10],
                                       prep.walk), codes)
    assert torch.equal(tcam_match_plain(codes, feats, vid, targs[10],
                                        prep.walk, 1), codes)
    label, per_tree = forest_vote_plain(codes, vid, prep.leaves, C)
    assert not label.any() and not per_tree.any()
    assert not svm_lookup_plain(feats, vid, prep.svm).any()


# ---------------------------------------- satellite: out-of-range features
def test_svm_features_outside_levels_add_zero():
    """A feature of -1 or >= levels adds 0 to every SVM sum, in the port's
    twin, the kernel's plain version and the fused twin, exactly as the TPU
    kernels do (``svm_lookup_pallas_v`` and ``classify_fused_pallas_v``,
    interpret mode); the JAX oracle ``ref.svm_lookup_v`` differs there."""
    rng = np.random.default_rng(25)
    B, T, E, F, V, L, P, C, H, levels = 64, 2, 8, 12, 3, 3, 16, 4, 5, 32
    args = list(_rand_fused(rng, B, T, E, F, V, L, P, C, H, levels))
    feats = rng.integers(0, levels, (B, F)).astype(np.int32)
    out = rng.random((B, F)) < 0.3
    feats[out] = rng.choice(np.asarray([-1, levels, levels + 7, 300],
                                       np.int32), int(out.sum()))
    args[1] = jnp.asarray(feats)
    bias = jnp.asarray(rng.integers(-10_000, 10_000, (V, H)), jnp.int32)
    args[16] = bias
    vid, lut = args[2], args[15]
    pallas = svm_lookup_pallas_v(args[1], vid, lut, bias, interpret=True)
    fused = classify_fused_pallas_v(*args, C, interpret=True)[2]
    np.testing.assert_array_equal(np.asarray(pallas), np.asarray(fused))
    # the reference: in-range cells only, summed on the host
    lut_np, vid_np = np.asarray(lut), np.asarray(vid)
    want = np.asarray(bias)[vid_np].astype(np.int64)
    for f in range(F):
        x = feats[:, f]
        ok = (x >= 0) & (x < levels)
        cell = lut_np[vid_np[:, None], np.arange(H)[None, :], f,
                      np.clip(x, 0, levels - 1)[:, None]]
        want += np.where(ok[:, None], cell, 0)
    np.testing.assert_array_equal(np.asarray(pallas), want)
    targs = to_torch(args)
    tf, tv = targs[1], targs[2]
    assert_ints(ref.svm_lookup_v(tf, tv, targs[15], targs[16]), pallas)
    assert_ints(svm_lookup_plain(tf, tv, tiling.prep_lut(targs[15],
                                                         targs[16])), pallas)
    assert_ints(ref.classify_fused_v(*targs, C)[2], pallas)
    prep = tiling.prep_classify_fused(*targs[3:10], *targs[11:17])
    assert_ints(classify_fused_plain(targs[0], tf, tv, targs[10], prep, C)[2],
                pallas)
    oracle = jref.svm_lookup_v(args[1], vid, lut, bias)
    assert not np.array_equal(np.asarray(oracle), np.asarray(pallas)), \
        "the JAX oracle now agrees on out-of-range features"


# --------------------------------------------- the staged engine, 204 draws
STAGED = (("unfused", "unfused-ref"), ("unfused-cuda", "unfused-ref"),
          ("layerwise", "layerwise-ref"), ("layerwise-cuda", "layerwise-ref"))


@pytest.mark.parametrize("V", sorted(conf.N_CASES))
def test_conformance_draws_staged_modes(V):
    """All 204 draws: the port's engine in each staged mode, on the twins
    (``unfused``, ``layerwise`` on the CPU) and on the kernels' plain
    versions over the exec image (``-cuda``), equals the JAX engine's
    matching ``-ref`` mode and its ``ref`` mode on rslt, codes and svm_acc."""
    jprof = conf._profile(V)
    prof = port_profile(jprof)
    oracles = {m: JaxEngine(jprof, mode=m)
               for m in ("ref", "unfused-ref", "layerwise-ref")}
    engines = {m: tp.SwitchEngine(prof, device="cpu", mode=m)
               for m, _ in STAGED}
    assert [e.mode for e in engines.values()] == [
        "unfused-ref", "unfused-cuda", "layerwise-ref", "layerwise-cuda"]
    for case in range(conf.N_CASES[V]):
        _seed, _progs, jpacked, jpb = conf._draw_case(V, case, jprof)
        want = {m: o.classify(jpacked, jpb) for m, o in oracles.items()}
        packed, pb = port_packed(jpacked, jprof), port_batch(jpb)
        for mode, jmode in STAGED:
            got = engines[mode].classify(packed, pb)
            for w in (want[jmode], want["ref"]):
                assert_batches_equal(got, w, what=f"V={V} case={case} "
                                     f"mode={mode}")


@pytest.fixture(scope="module")
def dt_zoo(satdap):
    Xtr, ytr, Xte, _ = satdap
    dt = tml.DecisionTree(max_depth=8, max_leaf_nodes=100).fit(Xtr, ytr)
    svm = tml.LinearSVM(epochs=60).fit(Xtr, ytr)
    return Xte, dt, svm


@pytest.mark.parametrize("mode,walk_calls,walk_fn", [
    ("unfused-cuda", 1, "tree_walk"), ("layerwise-cuda", None, "tcam_match")])
def test_kernel_calls_per_staged_classify(dt_zoo, plane_profile,
                                          monkeypatch, mode, walk_calls,
                                          walk_fn):
    """One classify reaches the walk once (``unfused``) or L times
    (``layerwise``), the vote once and the SVM sums once: 3 and L + 2
    kernel calls, each bound to the exec image (no per-call prep); on the
    CPU no kernel launches (mirrors tests/test_plane.py:159-160)."""
    Xte, dt, svm = dt_zoo
    prof = port_profile(plane_profile)
    eng = tp.SwitchEngine(prof, device="cpu", mode=mode)
    p_dt, p_svm = ttr.translate(dt, vid=0), ttr.translate(svm, vid=1)
    packed = eng.install(eng.install(eng.empty(), p_dt), p_svm)
    img = packed.image.fused
    calls, reals = {}, {}
    for module, name, bound in ((walk_module, "tree_walk", img.walk),
                                (tcam_module, "tcam_match", img.walk),
                                (fv_module, "forest_vote", img.leaves),
                                (svm_module, "svm_lookup", img.svm)):
        calls[name], reals[name] = [], getattr(module, name)

        def counting(*args, _real=reals[name], _name=name, _bound=bound):
            ops_ = next(a for a in args if isinstance(a, tuple))
            calls[_name].append(all(x is y for x, y in zip(ops_, _bound)))
            return _real(*args)
        monkeypatch.setattr(module, name, counting)
    for name in ("prep_classify_fused", "prep_walk", "prep_leaves",
                 "prep_lut"):
        monkeypatch.setattr(ops.tiling, name, None)
    want_walk = walk_calls or prof.max_layers
    for B in (1, 7, 33):
        before = {k: len(v) for k, v in calls.items()}
        odd = np.arange(B) % 2 == 1
        pb = tp.PacketBatch.make_request(
            Xte[:B], mid=np.where(odd, p_svm.mid, p_dt.mid).astype(np.int32),
            vid=odd.astype(np.int32), max_features=prof.max_features,
            n_trees=prof.max_trees, n_hyperplanes=prof.max_hyperplanes,
            max_versions=prof.max_versions)
        out = eng.classify(packed, pb)
        got = {k: len(v) - before[k] for k, v in calls.items()}
        assert got[walk_fn] == want_walk
        assert got["forest_vote"] == got["svm_lookup"] == 1
        assert sum(got.values()) == want_walk + 2
        assert (out.rslt.numpy()[~odd] == dt.predict(Xte[:B])[~odd]).all()
    assert all(all(v) for v in calls.values())
    assert all(fn.launches == 0 for fn in reals.values())  # no card here


@pytest.mark.parametrize("mode", ["unfused", "layerwise"])
def test_resolve_staged_modes(mode):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert ops.resolve_mode(mode, cpu) == f"{mode}-ref"
    assert ops.resolve_mode(mode, cuda) == f"{mode}-cuda"
    assert ops.resolve_mode(f"{mode}-ref", cuda) == f"{mode}-ref"
    assert ops.base_mode(f"{mode}-cuda") == "cuda"
    assert ops.base_mode(mode) is None
    with pytest.raises(ValueError, match="unknown classify mode"):
        ops.resolve_mode(f"{mode}-interpret", cpu)
