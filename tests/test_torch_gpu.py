"""The CUDA kernels on the card, held to their plain torch versions.

Every test here needs a CUDA card and skips without one; they import only
``torch``, ``numpy`` and the port, so they run on a machine with no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest``: the shared ``conftest.py`` imports the JAX package.)
Inputs are numpy draws from a seed.  The classify kernels' outputs are
integers and the vote sums the same f32 weights in the same order, so their
tolerance is exact; ``decode_attn`` differs from its plain version in
summation order only, held to the JAX package's tolerances (bf16 atol 2e-2,
f32 atol 2e-5, rtol 1e-2; at full width bf16 to one unit in the last
place), and the LM on the card to the CPU run within f32 atol/rtol 1e-4.
The redesigned kernels are also held at their geometry's edges:
``decode_attn`` at kv_len on and beside its tile and span edges for G 1-48
and D 16-256, at the LM families' decode shapes (D 256, G 16, G 6, G 1
over whisper's 1500-row encoder cache), and under each family's decode
step (kernel against twin and CPU, exact launches), ``classify_fused`` on the conformance draws (drawn with the
port's own models) and on blocks of one, all, an empty and an out-of-range
version, the four staged kernels at B 1, B just past a block's packets,
T 1, 3 and 33, H 1 and 16, L 13, P 1 and 9, C 33, and ``tcam_match`` on
rows of length 0, 1, 8, 9 and E (hit at the last valid entry, no hit,
shift 31 and 32).  ``decode_attn`` also runs on two streams at once, its
launches of both in flight together.  The graph cache (one captured CUDA
graph per admission bucket): replay against eager and the twin on the 204
draws in three modes, with exact launches per replay; install, evict and
swap between replays in place; two threads replaying at once; a capture
that fails raises and keeps no entry.  The fleet (``FleetRuntime`` on its
hop pool): the 8 fault-lane deployments replayed against eager and the
twin with exact launches, a retarget to another hosting count between
replays with no resident ``data_ptr`` moved, and a ``DeviceFailure`` raised
on a replaying slot thread that reaches the submitter as itself.  The
pipelined and sharded lanes (``ShardedExecutor`` on one card, a stream a
lane, one graph per bucket): three layouts in two modes replayed against
eager and the twin with exact launches, a swap in place, a failing capture,
and lanes on distinct cards where the host has more than one.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import distributed_plane as tdp
from repro_torch.core import mlmodels as tml
from repro_torch.core import planner as tpl
from repro_torch.core.packets import PacketBatch, PacketType
from repro_torch.core.plane import PlaneProfile, SwitchEngine, program_tensors
from repro_torch.core.topology import fat_tree
from repro_torch.core.translator import translate
from repro_torch.data import conformance as draws
from repro_torch.data import load_dataset
from repro_torch.data.conformance import N_CASES
from repro_torch.kernels import ref, tiling
from repro_torch.configs import smoke_config
from repro_torch.kernels.classify_fused import classify_fused
from repro_torch.kernels.decode_attn import decode_attn, decode_attn_plain
from repro_torch.kernels.forest_vote import forest_vote, forest_vote_plain
from repro_torch.kernels.svm_lookup import svm_lookup, svm_lookup_plain
from repro_torch.kernels.tcam_match import tcam_match, tcam_match_plain
from repro_torch.kernels.tree_walk import tree_walk, tree_walk_plain
from repro_torch.models import transformer
from repro_torch.runtime import (
    DataplaneRuntime,
    SequentialPathExecutor,
    SingleSwitchExecutor,
)
from repro_torch.serving import ZooServer

pytestmark = pytest.mark.gpu

# (B, T, E, F, V, L, P, C, H, levels, empty zoo slots): the sweep of
# tests/test_fused.py, plus the paper's full profile at a large batch
SWEEP = [
    (7, 1, 3, 4, 1, 1, 4, 2, 1, 16, ()),
    (64, 4, 17, 13, 4, 5, 32, 5, 3, 64, ()),
    (300, 2, 130, 20, 2, 3, 16, 3, 2, 32, ()),
    (257, 3, 33, 21, 8, 8, 64, 6, 4, 64, (1, 5)),
    (33, 5, 64, 40, 1, 32, 128, 8, 8, 128, ()),
    (4097, 8, 128, 60, 4, 32, 256, 32, 12, 256, (3,)),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def random_case(seed, B, T, E, F, V, L, P, C, H, levels, empty, device):
    """The distributions of ``_rand_fused`` in tests/test_fused.py."""
    rng = np.random.default_rng(seed)
    shape = (V, L, T, E)
    flo = rng.integers(0, levels - 1, shape)
    valid = rng.random(shape) < 0.9
    pv = rng.random((V, T, P)) < 0.9
    lut = rng.integers(-60_000, 60_000, (V, H, F, levels))
    for v in empty:
        valid[v], pv[v], lut[v] = False, False, 0
    pc = np.sort(rng.choice(2**16, size=V * T * P, replace=False)
                 .reshape(V, T, P), axis=2)
    arrays = [rng.integers(0, 2**12, (B, T)), rng.integers(0, levels, (B, F)),
              rng.integers(0, V, B), rng.integers(0, 2**6, shape),
              rng.integers(0, 2**6, shape), rng.integers(0, F, shape), flo,
              flo + rng.integers(0, levels // 2, shape),
              rng.integers(0, 2, shape), valid, rng.permutation(L), pc,
              rng.integers(0, C, (V, T, P)), pv,
              rng.random((V, T)).astype(np.float32), lut,
              np.zeros((V, H))]
    return [torch.from_numpy(a if a.dtype in (bool, np.float32)
                             else a.astype(np.int32)).to(device)
            for a in arrays]


@pytest.mark.parametrize("B,T,E,F,V,L,P,C,H,levels,empty", SWEEP)
def test_kernel_matches_twin(cuda, B, T, E, F, V, L, P, C, H, levels, empty):
    args = random_case(B * 31 + V, B, T, E, F, V, L, P, C, H, levels, empty,
                       cuda)
    want = ref.classify_fused_v(*args, C)
    ops_ = tiling.prep_classify_fused(*args[3:10], *args[11:17])
    before = classify_fused.launches
    got = classify_fused(args[0], args[1], args[2], args[10], ops_, C)
    torch.cuda.synchronize()
    assert classify_fused.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = random_case(1, 8, 2, 4, 5, 1, 2, 8, 3, 2, 16, (), cuda)
    ops_ = tiling.prep_classify_fused(*args[3:10], *args[11:17])
    with pytest.raises(TypeError):
        classify_fused(args[0].long(), args[1], args[2], args[10], ops_, 3)
    with pytest.raises(ValueError):
        classify_fused(args[0][:, :1], args[1], args[2], args[10], ops_, 3)
    with pytest.raises(ValueError):
        classify_fused(args[0].cpu(), args[1], args[2], args[10], ops_, 3)
    with pytest.raises(ValueError):
        classify_fused(args[0].t().contiguous().t(), args[1], args[2],
                       args[10], ops_, 3)


@pytest.fixture(scope="module")
def satdap_zoo():
    Xtr, ytr, Xte, _ = load_dataset("satdap", scale=0.25)
    q = tml.Quantizer(8).fit(Xtr)
    Xtr, Xte = q.transform(Xtr), q.transform(Xte)
    models = {0: tml.DecisionTree(max_depth=8, max_leaf_nodes=80).fit(Xtr, ytr),
              1: tml.RandomForest(n_estimators=4, max_depth=6,
                                  max_leaf_nodes=40).fit(Xtr, ytr),
              2: tml.LinearSVM(epochs=60).fit(Xtr, ytr)}
    return models, Xte


PROFILE = PlaneProfile(max_features=36, max_trees=5, max_layers=10,
                       max_entries_per_layer=256, max_leaves=256,
                       max_classes=8, max_hyperplanes=8, max_versions=4)


def test_engine_and_server_on_the_card(cuda, satdap_zoo):
    """The zoo on the card: one launch per classify, equal to the twin
    engine on the card and to the server on the CPU."""
    models, X = satdap_zoo
    gzoo, czoo = ZooServer(PROFILE), ZooServer(PROFILE, device="cpu")
    for vid, m in models.items():
        gzoo.install(m, vid=vid)
        czoo.install(m, vid=vid)
    twin = SwitchEngine(PROFILE, mode="ref", device=cuda)
    rng = np.random.default_rng(3)
    for B in (1, 7, 300, X.shape[0]):
        Xb = X[rng.integers(0, X.shape[0], B)]
        vid = rng.integers(0, 4, B).astype(np.int32)
        mid = np.asarray([(0, 1, 2, 0)[v] for v in vid], np.int32)
        before = classify_fused.launches
        got = gzoo.classify(Xb, mid=mid, vid=vid)
        assert classify_fused.launches == before + 1
        np.testing.assert_array_equal(got, czoo.classify(Xb, mid=mid, vid=vid))
        pb = PacketBatch.make_request(
            Xb, mid=mid, vid=vid, max_features=PROFILE.max_features,
            n_trees=PROFILE.max_trees, n_hyperplanes=PROFILE.max_hyperplanes)
        out = gzoo.engine.classify(gzoo.packed, pb)
        want = twin.classify(gzoo.packed, pb)
        for f in ("rslt", "codes", "svm_acc"):
            assert torch.equal(getattr(out, f), getattr(want, f)), f


def _launched(fn, call):
    """Run ``call`` and return (its result, how many launches of ``fn``)."""
    before = fn.launches
    out = call()
    torch.cuda.synchronize()
    return out, fn.launches - before


# the staged kernels' geometry edges: B 1; B just past a block's packets
# (tcam_match: 4 at 8 trees, 10 at 3; svm_lookup: 8; tree_walk and
# forest_vote: 2 at 8 trees from B 528 on, 6 at 3 from B 1584, 16 at 1 from
# B 4224); T 1, 3 and T 33 (a group walks more than one tree); H 1 and H at
# svm_lookup.MAX_H (16); L 13 (two chunks of the walk's 8 layers, the last
# part-filled); P 9 and P 1 (the leaf search's rounds); C 33 (two chunks of
# the vote's classes)
STAGE_EDGES = [
    (1, 8, 128, 60, 4, 32, 256, 32, 12, 256, (3,)),
    (5, 8, 128, 60, 4, 32, 256, 32, 16, 256, ()),
    (11, 3, 20, 10, 2, 4, 16, 4, 1, 16, ()),
    (9, 8, 9, 60, 2, 3, 16, 4, 16, 256, (1,)),
    (40, 33, 17, 13, 2, 3, 16, 4, 5, 32, ()),
    (529, 8, 128, 60, 4, 13, 256, 32, 12, 256, (3,)),
    (1585, 3, 20, 10, 2, 4, 9, 33, 1, 16, ()),
    (4225, 1, 20, 10, 2, 13, 1, 4, 4, 16, ()),
]


@pytest.mark.parametrize("B,T,E,F,V,L,P,C,H,levels,empty",
                         SWEEP + STAGE_EDGES)
def test_stage_kernels_match_plain(cuda, B, T, E, F, V, L, P, C, H, levels,
                                   empty):
    """Each staged kernel equals its plain version on the same operands,
    one launch per call; tcam_match at the first, a middle and the last
    layer; the vote on codes that hit leaves, with misses; the SVM with a
    bias and features outside [0, levels), above and below."""
    args = random_case(B * 31 + V, B, T, E, F, V, L, P, C, H, levels, empty,
                       cuda)
    codes, feats, vid, shift = args[0], args[1], args[2], args[10]
    prep = tiling.prep_classify_fused(*args[3:10], *args[11:17])
    got, n = _launched(tree_walk, lambda: tree_walk(codes, feats, vid, shift,
                                                    prep.walk))
    assert n == 1
    assert torch.equal(got, tree_walk_plain(codes, feats, vid, shift,
                                            prep.walk))
    for layer in sorted({0, L // 2, L - 1}):
        got, n = _launched(tcam_match, lambda: tcam_match(
            codes, feats, vid, shift, prep.walk, layer))
        assert n == 1
        assert torch.equal(got, tcam_match_plain(codes, feats, vid, shift,
                                                 prep.walk, layer))
    rng = np.random.default_rng(B)
    pick = torch.from_numpy(rng.integers(0, P, (B, T))).to(cuda)
    v = vid.long().clamp(0, V - 1)
    hits = prep.pred_codes[v[:, None], torch.arange(T, device=cuda)[None, :],
                           pick]
    leaf_codes = torch.where(torch.from_numpy(rng.random((B, T)) < 0.8)
                             .to(cuda), hits, codes)
    got, n = _launched(forest_vote, lambda: forest_vote(
        leaf_codes, vid, prep.leaves, C))
    assert n == 1
    for g, w in zip(got, forest_vote_plain(leaf_codes, vid, prep.leaves, C)):
        assert torch.equal(g, w)
    bias = torch.from_numpy(rng.integers(-10_000, 10_000, (V, H))
                            .astype(np.int32)).to(cuda)
    lut = tiling.prep_lut(prep.lut, bias)
    wide = torch.where(torch.from_numpy(rng.random((B, F)) < 0.1).to(cuda),
                       torch.full_like(feats, levels), feats)
    wide[::7, 0] = -1
    got, n = _launched(svm_lookup, lambda: svm_lookup(wide, vid, lut))
    assert n == 1
    assert torch.equal(got, svm_lookup_plain(wide, vid, lut))


def tcam_edge_rows(E, device):
    """One version, one layer, a tree per row: lengths 0, 1, 8, 9 (one
    lane group's round and one past it) and E, each with a hit at its last
    valid entry and with none; two hits in one round, the first with
    set_bit 0; a hit in a later round; every record past a row's length
    would match.  Packets: code 0b101, features 5; vids 0, -1 and 1."""
    lengths, hits = [], []
    for n in (1, 8, 9, E):
        lengths += [n, n]
        hits += [[n - 1], []]
    lengths += [0, 8, E]
    hits += [[], [2, 5], [11, 17]]
    T = len(lengths)
    rec = torch.zeros((1, 1, T, E, 4), dtype=torch.int32)
    rec[..., 0], rec[..., 1] = 0b010, 0b111
    rec[..., 2], rec[..., 3] = 5 << 16, 5 | (1 << 16)
    for t, (n, hit) in enumerate(zip(lengths, hits)):
        rec[0, 0, t, n:, 0] = 0b101
        for e in hit:
            rec[0, 0, t, e, 0] = 0b101
        if hit == [2, 5]:
            rec[0, 0, t, 2, 3] = 5
    ops_ = tiling.WalkOperands(rec.to(device), torch.tensor(
        lengths, dtype=torch.int32, device=device).reshape(1, 1, T))
    codes = torch.full((3, T), 0b101, dtype=torch.int32, device=device)
    feats = torch.full((3, 4), 5, dtype=torch.int32, device=device)
    vid = torch.tensor([0, -1, 1], dtype=torch.int32, device=device)
    return codes, feats, vid, ops_


@pytest.mark.parametrize("shift", [3, 31, 32])
def test_tcam_match_edge_rows(cuda, shift):
    """The lane-group walk on rows of length 0, 1, 8, 9 and E with a hit at
    the last valid entry or none, records past a row that would match,
    shift 31 and 32: equal to the plain version, one launch."""
    codes, feats, vid, ops_ = tcam_edge_rows(20, cuda)
    sh = torch.tensor([shift], dtype=torch.int32, device=cuda)
    got, n = _launched(tcam_match, lambda: tcam_match(codes, feats, vid, sh,
                                                      ops_, 0))
    assert n == 1
    assert torch.equal(got, tcam_match_plain(codes, feats, vid, sh, ops_, 0))
    assert torch.equal(got[1:], codes[1:])


def test_svm_lookup_refuses_an_h_beyond_the_kernel(cuda):
    """H above the kernel's register budget (svm_lookup.MAX_H) raises; the
    plain version still answers on the CPU."""
    from repro_torch.kernels.svm_lookup import MAX_H

    V, H, F, lv = 2, MAX_H + 1, 6, 8
    lut = torch.ones((V, H, F, lv), dtype=torch.int32)
    ops_ = tiling.prep_lut(lut, torch.zeros((V, H), dtype=torch.int32))
    feats = torch.zeros((4, F), dtype=torch.int32)
    vid = torch.zeros((4,), dtype=torch.int32)
    on_card = tiling.LutOperands(*(x.to(cuda) for x in ops_))
    before = svm_lookup.launches
    with pytest.raises(ValueError, match="hyperplanes"):
        svm_lookup(feats.to(cuda), vid.to(cuda), on_card)
    assert svm_lookup.launches == before
    assert torch.equal(svm_lookup(feats, vid, ops_),
                       torch.full((4, H), F, dtype=torch.int32))


@pytest.mark.parametrize("mode,per_classify", [
    ("unfused", {"tree_walk": 1, "tcam_match": 0}),
    ("layerwise", {"tree_walk": 0, "tcam_match": PROFILE.max_layers})])
def test_staged_server_on_the_card(cuda, satdap_zoo, mode, per_classify):
    """The zoo through ZooServer in a staged mode: 3 or L + 2 launches per
    classify, equal to the twin engine on the card."""
    models, X = satdap_zoo
    gzoo = ZooServer(PROFILE, mode=mode)
    for vid, m in models.items():
        gzoo.install(m, vid=vid)
    twin = SwitchEngine(PROFILE, mode="ref", device=cuda)
    kernels = {"tree_walk": tree_walk, "tcam_match": tcam_match,
               "forest_vote": forest_vote, "svm_lookup": svm_lookup,
               "classify_fused": classify_fused}
    want_n = {**per_classify, "forest_vote": 1, "svm_lookup": 1,
              "classify_fused": 0}
    rng = np.random.default_rng(4)
    for B in (1, 7, 300, X.shape[0]):
        Xb = X[rng.integers(0, X.shape[0], B)]
        vid = rng.integers(0, 4, B).astype(np.int32)
        mid = np.asarray([(0, 1, 2, 0)[v] for v in vid], np.int32)
        pb = PacketBatch.make_request(
            Xb, mid=mid, vid=vid, max_features=PROFILE.max_features,
            n_trees=PROFILE.max_trees, n_hyperplanes=PROFILE.max_hyperplanes)
        before = {k: f.launches for k, f in kernels.items()}
        out = gzoo.runtime.run(pb)
        torch.cuda.synchronize()
        assert {k: f.launches - before[k] for k, f in kernels.items()} == \
            want_n
        want = twin.classify(gzoo.packed, pb)
        for f in ("rslt", "codes", "svm_acc"):
            assert torch.equal(getattr(out, f), getattr(want, f)), f


def test_sequential_path_on_the_card(cuda, satdap_zoo):
    """A plan_zoo deployment over fat_tree(4), hop programs on the card:
    the sequential path in the fused and layerwise modes equals the single
    switch in mode ref, with hops x 1 and hops x (L + 2) launches."""
    models, X = satdap_zoo
    progs = [translate(models[v], vid=v) for v in sorted(models)]
    net = fat_tree(4)
    h = net.hosts()
    plans = tpl.plan_zoo(progs, net, h[0], h[-1],
                         default_device=tpl.DeviceModel(n_stages=12))
    devs, dps = tdp.build_zoo_device_programs(progs, plans, PROFILE)
    assert len(devs) >= 3 and all(p.device.type == "cuda" for p in dps)
    twin = SwitchEngine(PROFILE, mode="ref", device=cuda)
    single = twin.empty()
    for p in progs:
        single = twin.install(single, p)
    rng = np.random.default_rng(5)
    B = X.shape[0]
    vid = rng.integers(0, 4, B).astype(np.int32)
    mid = np.asarray([(0, 1, 2, 0)[v] for v in vid], np.int32)
    pb = PacketBatch.make_request(
        X, mid=mid, vid=vid, max_features=PROFILE.max_features,
        n_trees=PROFILE.max_trees, n_hyperplanes=PROFILE.max_hyperplanes)
    want = twin.classify(single, pb).rslt
    hops, L = len(dps), PROFILE.max_layers
    for mode, fn, n in ((None, classify_fused, hops),
                        ("layerwise", tcam_match, hops * L)):
        rt = DataplaneRuntime(SequentialPathExecutor(
            dps, n_classes=PROFILE.max_classes, mode=mode))
        out, launched = _launched(fn, lambda: rt.run(pb))
        assert launched == n
        assert torch.equal(out.rslt, want)


# (B, Hq, Hkv, D, S): the sweep of tests/test_kernels.py:166, MQA with a
# group of 12 (two query chunks), and internlm2-1.8b's full width
ATTN_SWEEP = [(2, 4, 4, 16, 33), (3, 8, 2, 32, 128), (1, 16, 8, 64, 700),
              (3, 12, 1, 64, 257), (16, 16, 8, 128, 4096)]
# the JAX package's tolerances (tests/test_kernels.py:178); at full width,
# where rows of long kv_len give outputs of ~0.03, bf16 is held to one unit in the last place of
# the plain version's output (both sum in f32 and round once), as
# chip_smoke.py holds it
ATTN_TOL = {torch.bfloat16: dict(atol=2e-2, rtol=1e-2),
            torch.float32: dict(atol=2e-5, rtol=1e-2)}
ATTN_TOL_FULL = {torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7),
                 torch.float32: ATTN_TOL[torch.float32]}


def attn_case(device, B, Hq, Hkv, D, S, dtype, seed=0):
    rng = np.random.default_rng(seed + B * S)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(device=device, dtype=dtype)
    kv_len = rng.integers(1, S + 1, B).astype(np.int32)
    kv_len[0], kv_len[-1] = 1, S
    return (t(B, Hq, D), t(B, S, Hkv, D), t(B, S, Hkv, D),
            torch.from_numpy(kv_len).to(device))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=str)
@pytest.mark.parametrize("B,Hq,Hkv,D,S", ATTN_SWEEP)
def test_decode_attn_kernel_matches_plain(cuda, B, Hq, Hkv, D, S, dtype):
    ins = attn_case(cuda, B, Hq, Hkv, D, S, dtype)
    got, n = _launched(decode_attn, lambda: decode_attn(*ins))
    assert n == 1 and got.dtype == dtype and got.shape == (B, Hq, D)
    full = (B, Hq, Hkv, D, S) == ATTN_SWEEP[-1]
    torch.testing.assert_close(got.float(), decode_attn_plain(*ins).float(),
                               **(ATTN_TOL_FULL if full else ATTN_TOL)[dtype])


def test_decode_attn_kv_len_zero_gives_zeros(cuda):
    q, k, v, _ = attn_case(cuda, 3, 4, 2, 16, 40, torch.float32)
    kv_len = torch.tensor([0, 17, 0], dtype=torch.int32, device=cuda)
    got = decode_attn(q, k, v, kv_len)
    assert torch.equal(got[0::2], torch.zeros_like(got[0::2]))
    torch.testing.assert_close(got, decode_attn_plain(q, k, v, kv_len),
                               **ATTN_TOL[torch.float32])


def test_decode_attn_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v, kv_len = attn_case(cuda, 2, 4, 2, 32, 9, torch.float32)
    with pytest.raises(TypeError):          # dtype
        decode_attn(q.half(), k.half(), v.half(), kv_len)
    with pytest.raises(TypeError):          # k's dtype differs from q's
        decode_attn(q, k.bfloat16(), v, kv_len)
    with pytest.raises(TypeError):          # kv_len not int32
        decode_attn(q, k, v, kv_len.long())
    with pytest.raises(ValueError):         # head dim
        decode_attn(*attn_case(cuda, 2, 4, 2, 96, 9, torch.float32))
    with pytest.raises(ValueError):         # head dim past the largest
        decode_attn(*attn_case(cuda, 2, 4, 2, 512, 9, torch.float32))
    with pytest.raises(ValueError):         # Hq % Hkv
        decode_attn(*attn_case(cuda, 2, 6, 4, 32, 9, torch.float32))
    with pytest.raises(ValueError):         # layout
        decode_attn(q, k.transpose(1, 2).contiguous().transpose(1, 2), v,
                    kv_len)
    with pytest.raises(ValueError):         # devices
        decode_attn(q, k.cpu(), v, kv_len)
    with pytest.raises(ValueError):         # not 16-byte aligned
        buf = torch.empty(k.numel() + 1, device=cuda)
        decode_attn(q, buf[1:].view(k.shape), v, kv_len)


def test_smoke_lm_on_the_card_equals_the_cpu(cuda):
    """The smoke config's decode steps and forward in f32: the card (the
    kernel, 2 launches a step) against the CPU (the plain version)."""
    cfg = smoke_config("internlm2-1.8b").scaled(dtype="float32")
    cpu = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    card = transformer.DenseLM(cfg, device=cuda)
    with torch.no_grad():
        for p, w in zip(card.parameters(), cpu.parameters()):
            p.copy_(w)
    B, S = 3, 10
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)))
    states = {d: transformer.init_decode_state(cfg, B, S, device=d)
              for d in ("cpu", cuda)}
    for t in range(S):
        want, _ = transformer.decode_step(cpu, states["cpu"],
                                          toks[:, t:t + 1], t, cfg)
        (got, _), n = _launched(decode_attn, lambda: transformer.decode_step(
            card, states[cuda], toks[:, t:t + 1].to(cuda), t, cfg))
        assert n == cfg.n_layers
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(states[cuda]["k"].cpu(), states["cpu"]["k"],
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(
        transformer.forward(card, toks.to(cuda), cfg).cpu(),
        transformer.forward(cpu, toks, cfg), atol=1e-4, rtol=1e-4)


# ------------------------------------------- the kernels' geometry at edges
from repro_torch.kernels import decode_attn as attn_module  # noqa: E402
from repro_torch.kernels.classify_fused import packets_per_block  # noqa: E402


def edge_lengths(p, S):
    """kv_len at, beside and between the plan's tile and span edges, 0 and
    S."""
    edges = {0, 1, p.tile - 1, p.tile, p.tile + 1, p.split_len - 1,
             p.split_len, p.split_len + 1, 2 * p.split_len, S - 1, S}
    return sorted(x for x in edges if 0 <= x <= S)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 6, 12, 48])
def test_decode_attn_at_split_and_tile_edges(cuda, G, D, dtype):
    """The split-KV kernel against its plain version with kv_len at and
    beside the tile and span edges, 0 and the cache length; one launch,
    and the same answer again (the arrival counters reset themselves)."""
    Hkv, S = 2, 700
    edges = edge_lengths(attn_module.plan(11, G * Hkv, Hkv, D, S, dtype), S)
    p = attn_module.plan(len(edges), G * Hkv, Hkv, D, S, dtype)
    assert p.n_split > 1
    q, k, v, _ = attn_case(cuda, len(edges), G * Hkv, Hkv, D, S, dtype,
                           seed=G * D)
    kv_len = torch.tensor(edge_lengths(p, S), dtype=torch.int32, device=cuda)
    assert kv_len.numel() == q.shape[0]
    got, n = _launched(decode_attn, lambda: decode_attn(q, k, v, kv_len))
    assert n == 1
    want = decode_attn_plain(q, k, v, kv_len)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
    assert torch.equal(got[kv_len == 0], torch.zeros_like(got[kv_len == 0]))
    assert torch.equal(decode_attn(q, k, v, kv_len), got)


@pytest.mark.parametrize("B,Hq,Hkv,D,S", [(16, 48, 1, 128, 4096),
                                          (4, 16, 8, 128, 32768)])
def test_decode_attn_full_width_shapes(cuda, B, Hq, Hkv, D, S):
    """granite-20b's heads at B 16 and internlm2-1.8b's at B 4 over a 32768
    cache: one bf16 ulp of the plain version's output."""
    ins = attn_case(cuda, B, Hq, Hkv, D, S, torch.bfloat16)
    got, n = _launched(decode_attn, lambda: decode_attn(*ins))
    assert n == 1
    torch.testing.assert_close(got.float(), decode_attn_plain(*ins).float(),
                               **ATTN_TOL_FULL[torch.bfloat16])


# the families' decode shapes (B, Hq, Hkv, D, S): recurrentgemma-2b (D 256,
# its window of 2048, and the 96 positions a served request reaches: one
# span shorter than a tile's multiple), qwen3-moe (G 16; at 4096 and at the
# served 96), grok-1 (G 6), whisper-tiny's self attention and its cross
# attention over the 1500-row encoder cache (G 1)
FAMILY_SHAPES = [(16, 10, 1, 256, 2048), (4, 10, 1, 256, 2048),
                 (16, 10, 1, 256, 96), (16, 64, 4, 128, 4096),
                 (16, 64, 4, 128, 96), (16, 48, 8, 128, 4096),
                 (16, 6, 6, 64, 96), (16, 6, 6, 64, 1500)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,Hq,Hkv,D,S", FAMILY_SHAPES)
def test_decode_attn_at_the_families_shapes(cuda, B, Hq, Hkv, D, S, dtype):
    """One launch against the plain version at the full-width bound, rows
    of kv_len 1 and S among them."""
    ins = attn_case(cuda, B, Hq, Hkv, D, S, dtype, seed=D)
    got, n = _launched(decode_attn, lambda: decode_attn(*ins))
    assert n == 1
    torch.testing.assert_close(got.float(), decode_attn_plain(*ins).float(),
                               **ATTN_TOL_FULL[dtype])


# decode_attn launches a step of each family's smoke config
FAMILY_LAUNCHES = {"internlm2-1.8b": lambda c: c.n_layers,
                   "qwen3-moe-235b-a22b": lambda c: c.n_layers,
                   "recurrentgemma-2b": lambda c: c.n_layers // 3,
                   "rwkv6-7b": lambda c: 0,
                   "whisper-tiny": lambda c: 2 * c.n_layers}


@pytest.mark.parametrize("arch", sorted(FAMILY_LAUNCHES))
def test_family_decode_on_the_card_equals_the_twin(cuda, arch):
    """Each family's smoke config in f32, ten decode steps on the card
    through the kernel (exact launches a step) against the same steps
    through the twin (``mode="ref"``) and against the CPU, within f32
    atol/rtol 1e-4; the hybrid's ring of 8 slots wraps."""
    cfg = smoke_config(arch).scaled(dtype="float32")
    cpu = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    card = transformer.new_model(cfg, device=cuda)
    with torch.no_grad():
        for p, w in zip(card.parameters(), cpu.parameters()):
            p.copy_(w)
    B, S = 3, 10
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)))
    enc = torch.randn(B, max(cfg.enc_seq, 1), cfg.d_model,
                      generator=torch.Generator().manual_seed(2))

    def state(device, model):
        st = transformer.init_decode_state(cfg, B, S, device=device)
        if cfg.family == "encdec":
            ks, vs = transformer.encode_kv(model, enc.to(device), cfg)
            st["ek"].copy_(ks)
            st["ev"].copy_(vs)
        return st

    runs = {"kernel": (card, state(cuda, card), None),
            "twin": (card, state(cuda, card), "ref"),
            "cpu": (cpu, state("cpu", cpu), None)}
    for t in range(S):
        out = {}
        for name, (model, st, mode) in runs.items():
            dev = "cpu" if name == "cpu" else cuda
            (lg, _), n = _launched(decode_attn, lambda: transformer.decode_step(
                model, st, toks[:, t:t + 1].to(dev), t, cfg, mode=mode))
            assert n == (FAMILY_LAUNCHES[arch](cfg) if name == "kernel" else 0)
            out[name] = lg.cpu()
        torch.testing.assert_close(out["kernel"], out["twin"], atol=1e-4,
                                   rtol=1e-4)
        torch.testing.assert_close(out["kernel"], out["cpu"], atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("B,Hq,Hkv,D,S", [(16, 48, 1, 128, 4096),
                                          (4, 16, 8, 128, 32768)])
def test_decode_attn_on_two_streams_at_once(cuda, B, Hq, Hkv, D, S):
    """Launches that split the cache, in flight together on two streams:
    both streams sleep on the card while the host enqueues eight launches
    on each, alternating, in a loop.  Each stream counts its span blocks'
    arrivals on its own counters, so every output equals the plain version
    within one bf16 ulp."""
    assert attn_module.plan(B, Hq, Hkv, D, S, torch.bfloat16).n_split > 1
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    ins = [attn_case(cuda, B, Hq, Hkv, D, S, torch.bfloat16, seed=seed)
           for seed in (0, 1)]
    want = [decode_attn_plain(*x) for x in ins]
    torch.cuda.synchronize()
    for _ in range(4):
        outs = [[], []]
        for s in streams:
            with torch.cuda.stream(s):
                torch.cuda._sleep(20_000_000)   # ~10 ms: the host enqueues
        for _ in range(8):
            for i, s in enumerate(streams):
                with torch.cuda.stream(s):
                    outs[i].append(decode_attn(*ins[i]))
        torch.cuda.synchronize()
        for got, w in zip(outs, want):
            for o in got:
                torch.testing.assert_close(o.float(), w.float(),
                                           **ATTN_TOL_FULL[torch.bfloat16])


def _classify_one(ops_, codes, feats, vid, shift, C):
    got, n = _launched(classify_fused, lambda: classify_fused(
        codes, feats, vid, shift, ops_, C))
    assert n == 1
    return got


@pytest.mark.parametrize("blocks", ["one version", "all versions",
                                    "empty slot", "vid out of range"])
@pytest.mark.parametrize("B,T", [(1, 8), (601, 3), (4099, 8)])
def test_classify_fused_block_mixes(cuda, blocks, B, T):
    """Blocks of one version, of all four, of an empty slot and of vids
    outside the zoo, at B 1, at B not a multiple of a block's packets (601
    at 3 trees: 2 or 3 packets a block) and at the full profile: bit for
    bit the twin, one launch."""
    E, F, V, L, P, C, H, lv = 128, 60, 4, 32, 256, 32, 12, 256
    if B == 601:
        assert B % packets_per_block(T, F, B, L=L) != 0
    args = random_case(B + len(blocks), B, T, E, F, V, L, P, C, H, lv, (2,),
                       cuda)
    vid = {"one version": torch.full((B,), 1),
           "all versions": torch.arange(B) % V,
           "empty slot": torch.full((B,), 2),
           "vid out of range": torch.tensor([-1, V, V + 3] * B)[:B]}[blocks]
    args[2] = vid.to(torch.int32).to(cuda)
    want = ref.classify_fused_v(*args, C)
    ops_ = tiling.prep_classify_fused(*args[3:10], *args[11:17])
    got = _classify_one(ops_, args[0], args[1], args[2], args[10], C)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if blocks == "vid out of range":
        assert torch.equal(got[0], args[0])
        assert not got[1].any() and not got[2].any()


@pytest.mark.parametrize("V", sorted(N_CASES))
def test_classify_fused_on_the_conformance_draws(cuda, V):
    """All 204 draws: the engine on the card (one classify_fused launch a
    classify) equals the twin engine bit for bit."""
    engine = SwitchEngine(draws.profile(V), device=cuda)
    twin = SwitchEngine(draws.profile(V), mode="ref", device=cuda)
    for case in range(N_CASES[V]):
        packed, pb = draws.draw_case(V, case, engine)
        out, n = _launched(classify_fused, lambda: engine.classify(packed, pb))
        assert n == 1
        want = twin.classify(packed, pb)
        for f in ("rslt", "codes", "svm_acc"):
            assert torch.equal(getattr(out, f), getattr(want, f)), (case, f)


# ------------------------------------------------- the graph cache (slice 7)
GRAPH_MODES = {None: {"classify_fused": 1},
               "unfused": {"tree_walk": 1, "forest_vote": 1, "svm_lookup": 1},
               "layerwise": {"tcam_match": 6, "forest_vote": 1,
                             "svm_lookup": 1}}


def _launch_counts():
    return {f.__name__: f.launches for f in (
        classify_fused, tree_walk, tcam_match, forest_vote, svm_lookup)}


@pytest.mark.parametrize("mode", list(GRAPH_MODES), ids=str)
@pytest.mark.parametrize("V", sorted(N_CASES))
def test_graph_replay_equals_eager_on_the_draws(cuda, V, mode):
    """All 204 draws: a replay of the bucket's captured graph equals the
    eager classify and the twin engine bit for bit, with exactly the mode's
    launches per replay, and no draw adds a cache entry."""
    prof = draws.profile(V)
    maker = SwitchEngine(prof, device=cuda)
    twin = SwitchEngine(prof, mode="ref", device=cuda)
    graph = DataplaneRuntime(SingleSwitchExecutor(prof, mode=mode))
    eager = DataplaneRuntime(SingleSwitchExecutor(prof, mode=mode,
                                                  graphs=False))

    def make(b):
        return PacketBatch.make_request(
            np.zeros((b, prof.max_features), np.int32),
            max_features=prof.max_features, n_trees=prof.max_trees,
            n_hyperplanes=prof.max_hyperplanes)
    ladder = graph.warm(make, max(draws.SIZES))
    want_n = {k: GRAPH_MODES[mode].get(k, 0) for k in _launch_counts()}
    for case in range(N_CASES[V]):
        packed, pb = draws.draw_case(V, case, maker)
        graph.swap(packed)
        eager.swap(packed)
        before = _launch_counts()
        out = graph.run(pb)
        torch.cuda.synchronize()
        assert {k: n - before[k] for k, n in _launch_counts().items()} == \
            want_n
        want, ref_out = eager.run(pb), twin.classify(packed, pb)
        for f in ("rslt", "codes", "svm_acc"):
            assert torch.equal(getattr(out, f), getattr(want, f)), (case, f)
            assert torch.equal(getattr(out, f), getattr(ref_out, f))
    assert graph.cache_size() == len(ladder)


def test_install_evict_swap_between_replays_in_place(cuda, satdap_zoo):
    """Install, evict and swap between replays of one bucket: the next
    replay answers with the new tables, no resident tensor moves, and the
    cache keeps its entry."""
    models, X = satdap_zoo
    zoo = ZooServer(PROFILE)
    for vid, m in models.items():
        zoo.install(m, vid=vid)
    twin = SwitchEngine(PROFILE, mode="ref", device=cuda)
    ptrs = [x.data_ptr() for x in program_tensors(zoo.packed)]
    vid = np.arange(256, dtype=np.int32) % 4
    mid = np.asarray([(0, 1, 2, 0)[v] for v in vid], np.int32)
    pb = zoo.make_request(X[np.arange(256) % len(X)], mid=mid, vid=vid)
    first = zoo.runtime.run(pb)
    writes = (lambda: zoo.install(translate(models[0], vid=3), vid=3),
              lambda: zoo.evict(vid=3),
              lambda: zoo.evict(vid=1),
              lambda: zoo.runtime.swap(zoo.engine.empty()))
    for write in writes:
        write()
        out = zoo.runtime.run(pb)
        want = twin.classify(zoo.packed, pb)
        for f in ("rslt", "codes", "svm_acc"):
            assert torch.equal(getattr(out, f), getattr(want, f)), f
    assert (out.rslt[pb.ptype.to(cuda) == 1] == -1).all()
    assert not torch.equal(first.rslt, out.rslt)
    assert [x.data_ptr() for x in program_tensors(zoo.packed)] == ptrs
    assert zoo.cache_size() == 1


def test_concurrent_replays_from_two_threads(cuda, satdap_zoo):
    """Two threads replaying the same graphs at once through ``run_host``:
    every answer is the twin's."""
    import threading

    models, X = satdap_zoo
    zoo = ZooServer(PROFILE)
    for vid, m in models.items():
        zoo.install(m, vid=vid)
    twin = SwitchEngine(PROFILE, mode="ref", device=cuda)
    rng = np.random.default_rng(9)
    cases = []
    for B in (7, 64, 300, 1000):
        vid = rng.integers(0, 4, B).astype(np.int32)
        mid = np.asarray([(0, 1, 2, 0)[v] for v in vid], np.int32)
        pb = zoo.make_request(X[rng.integers(0, len(X), B)], mid=mid, vid=vid)
        cases.append((pb, twin.classify(zoo.packed, pb).rslt.cpu()))
    errors = []

    def worker(order):
        try:
            for _ in range(20):
                for pb, want in order:
                    if not torch.equal(zoo.runtime.run_host(pb).rslt, want):
                        errors.append(pb.batch)
        except Exception as e:   # reported below
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(o,))
               for o in (cases, cases[::-1])]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert zoo.cache_size() == 4


def test_failing_capture_raises_and_keeps_no_entry(cuda, monkeypatch):
    """A classify that reads the host while its graph is captured: the
    capture raises, the cache keeps no entry, and the next call raises
    again (nothing gives way to eager)."""
    from repro_torch.runtime import executors

    real = executors._classify_impl

    def syncing(packed, pb, **kw):
        int(pb.vid.sum())
        return real(packed, pb, **kw)
    zoo = ZooServer(draws.profile(1))
    monkeypatch.setattr(executors, "_classify_impl", syncing)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            zoo.classify(np.zeros((3, draws.N_FEATURES), np.int32), mid=0,
                         vid=0)
        assert zoo.cache_size() == 0
    monkeypatch.setattr(executors, "_classify_impl", real)
    torch.cuda.synchronize()
    assert (zoo.classify(np.zeros((3, draws.N_FEATURES), np.int32), mid=0,
                         vid=0) == -1).all()
    assert zoo.cache_size() == 1


# ------------------------------------------------------ the fleet (slice 8)
def _fleet_pool_ptrs(ex):
    return [[t.data_ptr() for t in program_tensors(p)] for p in ex.pool]


@pytest.mark.parametrize("mode", [None, "layerwise"], ids=str)
def test_fleet_replays_equal_eager_and_ref_on_the_fault_lane(cuda, mode):
    """The 8 fault-lane deployments (the conformance profile): each
    phase's replay through the fleet's hop pool equals the same chain run
    eagerly and the twin on the monolithic install, with hops x the mode's
    launches a replay."""
    from repro_torch.serving import FleetRuntime
    from repro_torch.serving.fleet import FleetExecutor

    prof = draws.profile(draws.FLEET_V)
    maker = SwitchEngine(prof, device=cuda)
    twin = SwitchEngine(prof, mode="ref", device=cuda)
    for case in range(draws.N_FAULT_CASES):
        d = draws.draw_fleet_case(case, maker)
        fleet = FleetRuntime(d.network, prof, d.programs, src=d.src,
                             dst=d.dst, default_device=d.device_model,
                             mode=mode)
        assert fleet.executor.device.type == cuda.type
        assert fleet.path == d.path
        n = len(fleet.executor.devices)
        eager = DataplaneRuntime(FleetExecutor(
            fleet.engine, fleet.path, fleet.executor.devices,
            fleet.replan_sync()[2], down=set(), graphs=False))
        want_n = {k: n * GRAPH_MODES[mode].get(k, 0)
                  for k in _launch_counts()}
        for pb in d.phases:
            fleet.runtime.run(pb)                  # capture (or replay)
            before = _launch_counts()
            out = fleet.runtime.run(pb)            # a replay
            torch.cuda.synchronize()
            assert {k: c - before[k] for k, c in _launch_counts().items()} \
                == want_n, (case, pb.batch)
            want, ref_out = eager.run(pb), twin.classify(d.packed, pb)
            for f in ("rslt", "codes", "svm_acc"):
                assert torch.equal(getattr(out, f), getattr(want, f)), \
                    (case, f)
                assert torch.equal(getattr(out, f), getattr(ref_out, f)), \
                    (case, f)
        assert eager.cache_size() == 0


def test_fleet_retarget_between_replays_moves_no_data_ptr(cuda):
    """A 5-hop deployment retargeted to the same zoo on bigger switches
    (fewer hops) and back between replays: every replay equals the twin,
    the revisit adds no entry, and no resident tensor moves."""
    from repro_torch.core.planner import DeviceModel, plan_zoo
    from repro_torch.serving import FleetRuntime

    prof = draws.profile(draws.FLEET_V)
    maker = SwitchEngine(prof, device=cuda)
    twin = SwitchEngine(prof, mode="ref", device=cuda)
    d = draws.draw_fleet_case(6, maker)
    fleet = FleetRuntime(d.network, prof, d.programs, src=d.src, dst=d.dst,
                         default_device=d.device_model)
    ex = fleet.executor
    home = (list(fleet.path), list(ex.devices), fleet.replan_sync()[2])
    alt = plan_zoo(d.programs, d.network, d.src, d.dst,
                   default_device=DeviceModel())
    alt_devs, alt_progs = tdp.build_zoo_device_programs(d.programs, alt,
                                                        prof, "cpu")
    assert len(home[1]) == 5 and len(alt_devs) < 5
    pb = d.phases[0]
    want = twin.classify(d.packed, pb)
    ptrs = _fleet_pool_ptrs(ex)
    sizes = []
    for target in (home, (alt[0].path, alt_devs, alt_progs), home,
                   (alt[0].path, alt_devs, alt_progs)):
        ex.retarget(*target)
        for _ in range(2):
            out = fleet.runtime.run(pb)
            for f in ("rslt", "codes", "svm_acc"):
                assert torch.equal(getattr(out, f), getattr(want, f)), f
        sizes.append(ex.cache_size())
    assert sizes == [1, 2, 2, 2]
    assert _fleet_pool_ptrs(ex) == ptrs


def test_device_failure_from_a_replaying_slot_thread_reaches_the_submitter(
        cuda):
    """A kill that lands while a slot thread replays the chain: the server
    fails the dispatch with the ``DeviceFailure`` itself (no wrapper), the
    executor's lock is free, and ``submit_batch`` heals and retries to the
    twin's answer."""
    import asyncio
    import threading

    from repro_torch.runtime import DeviceFailure
    from repro_torch.serving import FleetRuntime

    prof = draws.profile(draws.FLEET_V)
    maker = SwitchEngine(prof, device=cuda)
    twin = SwitchEngine(prof, mode="ref", device=cuda)
    d = draws.draw_fleet_case(1, maker)
    fleet = FleetRuntime(d.network, prof, d.programs, src=d.src, dst=d.dst,
                         default_device=d.device_model)
    ex = fleet.executor
    pb = d.phases[0]
    fleet.runtime.run(pb)                          # capture
    cache = ex._cache(len(ex.devices))
    replay = cache.run
    threads = []

    def replay_then_kill(batch):
        out = replay(batch)
        threads.append(threading.current_thread())
        for k in d.kills:
            fleet.kill(k)
        return out

    async def main():
        async with fleet.serving(probe_interval_s=30.0):
            cache.run = replay_then_kill
            try:
                await fleet.control.server.submit_batch(pb)
            except Exception as e:         # checked below
                raised = e
            else:
                raised = None
            cache.run = replay
            out = await fleet.submit_batch(pb)
            return raised, out, fleet.latency_stats()["control"]

    raised, out, ctl = asyncio.run(main())
    assert type(raised) is DeviceFailure and raised.device in d.kills
    assert threads and threads[0] is not threading.main_thread()
    want = twin.classify(d.packed, pb)
    np.testing.assert_array_equal(out.rslt, want.rslt.cpu().numpy())
    np.testing.assert_array_equal(out.svm_acc, want.svm_acc.cpu().numpy())
    assert ctl["retries"] == 1 and ctl["reinstalls"] == 1
    assert not set(d.kills) & set(fleet.path)


# ----------------------------------- the pipelined and sharded lanes (slice 9)
LANE_LAYOUTS = {"pipe4x1": (4, 1, 4), "shard2x2": (2, 2, 2),
                "shard1x4": (1, 4, 1)}    # (switches, n_ports, n_micro)


def _lane_zoo(satdap_zoo, device, n_switch):
    """The satdap zoo split stage by stage over ``n_switch`` hops (each
    program's stages in contiguous blocks, path order), the full install,
    and 1000 packets of mixed traffic with a FORWARD fifth."""
    from repro_torch.core.plane import empty_program, install_program

    models, X = satdap_zoo
    progs = [translate(models[v], vid=v) for v in sorted(models)]
    dps = []
    for d in range(n_switch):
        packed = empty_program(PROFILE, device)
        for prog in progs:
            st = set(np.array_split(np.arange(len(prog.stages())),
                                    n_switch)[d].tolist())
            if st:
                packed = install_program(packed, prog, PROFILE, stages=st,
                                         vid=prog.vid)
        dps.append(packed)
    full = empty_program(PROFILE, device)
    for prog in progs:
        full = install_program(full, prog, PROFILE)
    rng = np.random.default_rng(11)
    B = 1000
    vid = rng.integers(0, 4, B).astype(np.int32)
    mid = np.asarray([(0, 1, 2, 0)[v] for v in vid], np.int32)
    pb = PacketBatch.make_request(
        X[rng.integers(0, len(X), B)], mid=mid, vid=vid,
        max_features=PROFILE.max_features, n_trees=PROFILE.max_trees,
        n_hyperplanes=PROFILE.max_hyperplanes)
    pb = dataclasses.replace(pb, ptype=torch.from_numpy(np.where(
        rng.random(B) < 0.2, PacketType.FORWARD,
        PacketType.REQUEST).astype(np.int32)))
    return dps, full, pb


@pytest.mark.parametrize("mode", [None, "layerwise"], ids=str)
@pytest.mark.parametrize("layout", sorted(LANE_LAYOUTS))
def test_lane_layouts_replay_on_the_card(cuda, satdap_zoo, layout, mode):
    """Each lane layout on one card, its lanes on streams of their own and
    the schedule captured as one graph per bucket: replays at B 1000, 7 and
    1 equal the same schedule run eagerly and the twin on the full install,
    with n_micro x switches x ports x the mode's launches a replay; the
    ragged sizes add one entry each, their replays none."""
    from repro_torch.runtime import ShardedExecutor

    n_switch, n_ports, n_micro = LANE_LAYOUTS[layout]
    dps, full, pb = _lane_zoo(satdap_zoo, cuda, n_switch)
    twin = SwitchEngine(PROFILE, mode="ref", device=cuda)
    rts = {g: DataplaneRuntime(ShardedExecutor(
        dps, n_classes=PROFILE.max_classes, mode=mode, n_ports=n_ports,
        n_micro=n_micro, devices=[cuda] * (n_switch * n_ports), graphs=g))
        for g in (True, False)}
    hops = n_micro * n_switch * n_ports
    per = {None: {"classify_fused": 1},
           "layerwise": {"tcam_match": PROFILE.max_layers, "forest_vote": 1,
                         "svm_lookup": 1}}[mode]
    want_n = {k: hops * per.get(k, 0) for k in _launch_counts()}
    for rep in range(2):
        for B in (1000, 7, 1):
            part = pb.map(lambda x: x[:B])
            before = _launch_counts()
            out = rts[True].run(part)
            torch.cuda.synchronize()
            assert {k: n - before[k] for k, n in _launch_counts().items()} \
                == want_n
            eager, ref_out = rts[False].run(part), twin.classify(full, part)
            for f in ("rslt", "codes", "svm_acc"):
                assert torch.equal(getattr(out, f), getattr(eager, f)), \
                    (B, f)
                assert torch.equal(getattr(out, f), getattr(ref_out, f)), \
                    (B, f)
        assert rts[True].cache_size() == 3 and rts[False].cache_size() == 0


def test_lane_swap_between_replays_in_place(cuda, satdap_zoo):
    """A swap to emptied programs between replays of a 2 x 2 layout: the
    next replay answers -1 for every request, no resident tensor moves, and
    swapping back restores the answers."""
    from repro_torch.runtime import ShardedExecutor

    dps, full, pb = _lane_zoo(satdap_zoo, cuda, 2)
    ex = ShardedExecutor(dps, n_classes=PROFILE.max_classes, n_ports=2,
                         n_micro=2, devices=[cuda] * 4)
    rt = DataplaneRuntime(ex)
    ptrs = [[t.data_ptr() for t in program_tensors(p)] for p in ex.programs]
    first = rt.run(pb).rslt.clone()
    empty = SwitchEngine(PROFILE, device=cuda).empty()
    rt.swap([empty, empty])
    req = pb.ptype.to(cuda) == PacketType.REQUEST
    assert (rt.run(pb).rslt[req] == -1).all()
    rt.swap(dps)
    assert torch.equal(rt.run(pb).rslt, first)
    assert [[t.data_ptr() for t in program_tensors(p)]
            for p in ex.programs] == ptrs
    assert rt.cache_size() == 1


def test_lane_capture_that_fails_raises_and_keeps_no_entry(cuda, satdap_zoo,
                                                           monkeypatch):
    """A hop that reads the host while the lanes are captured: the capture
    raises, no entry is kept, the next call raises again (nothing gives
    way to eager), and once the hop is sound the layout captures and
    answers as the twin."""
    from repro_torch.runtime import ShardedExecutor, executors

    dps, full, pb = _lane_zoo(satdap_zoo, cuda, 2)
    ex = ShardedExecutor(dps, n_classes=PROFILE.max_classes, n_ports=2,
                         n_micro=2, devices=[cuda] * 4)
    rt = DataplaneRuntime(ex)
    real = executors._classify_impl

    def syncing(packed, batch, **kw):
        int(batch.vid.sum())
        return real(packed, batch, **kw)
    monkeypatch.setattr(executors, "_classify_impl", syncing)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            rt.run(pb)
        assert rt.cache_size() == 0
    monkeypatch.setattr(executors, "_classify_impl", real)
    torch.cuda.synchronize()
    want = SwitchEngine(PROFILE, mode="ref", device=cuda).classify(full, pb)
    assert torch.equal(rt.run(pb).rslt, want.rslt)
    assert rt.cache_size() == 1


def test_lanes_on_distinct_cards(cuda, satdap_zoo):
    """With more than one card, a 2 x 2 layout over distinct cards (run
    eagerly with events) equals the twin; no graph is kept."""
    from repro_torch.runtime import ShardedExecutor

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two cards, this host has {n}")
    dps, full, pb = _lane_zoo(satdap_zoo, cuda, 2)
    lanes = [torch.device("cuda", i % n) for i in range(4)]
    ex = ShardedExecutor(dps, n_classes=PROFILE.max_classes, n_ports=2,
                         n_micro=2, devices=lanes)
    rt = DataplaneRuntime(ex)
    want = SwitchEngine(PROFILE, mode="ref", device=cuda).classify(full, pb)
    for _ in range(2):
        out = rt.run(pb)
        for f in ("rslt", "codes", "svm_acc"):
            assert torch.equal(getattr(out, f), getattr(want, f)), f
    assert rt.cache_size() == 0


# ------------------------------------------------------- the training stack
TRAIN_FAMILIES = ["internlm2-1.8b", "qwen3-moe-235b-a22b", "recurrentgemma-2b",
                  "rwkv6-7b", "whisper-tiny"]


def _train_step_on(model, cfg, batch):
    """Gradients of ``loss_fn`` over the whole batch, then one train step
    (n_micro 2); everything returned on the CPU."""
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import loss_fn, make_train_step

    dev = model.embed.device
    x = {k: v.to(dev) for k, v in batch.items()}
    enc = x.get("enc_inputs")
    model.trainable_()
    loss = loss_fn(model, x["tokens"].reshape(4, -1),
                   x["labels"].reshape(4, -1), cfg,
                   enc_inputs=None if enc is None else enc.reshape(
                       4, *enc.shape[2:]))
    grads = [g.cpu() for g in torch.autograd.grad(loss,
                                                  list(model.parameters()))]
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=40)
    _, _, m = make_train_step(cfg, ocfg, n_micro=2, has_enc=enc is not None)(
        model, adamw_init(model, ocfg), x)
    return (float(loss.detach()), grads, float(m["grad_norm"]),
            [p.detach().cpu() for p in model.parameters()])


@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_train_step_on_the_card_equals_the_cpu(cuda, arch):
    """One f32 train step of the family's smoke config on the card against
    the same step on the CPU: loss, gradients (each scaled by its largest
    |g|) and grad_norm at 1e-4, the updated weights at 1e-4 where |g| is
    above 1e-3 x its leaf's largest or 0; no kernel launched."""
    from repro_torch.data import TokenPipeline

    cfg = smoke_config(arch).scaled(dtype="float32")
    cpu = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    card = transformer.new_model(cfg, device=cuda)
    with torch.no_grad():
        for p, w in zip(card.parameters(), cpu.parameters()):
            p.copy_(w)
    b = TokenPipeline(vocab_size=cfg.vocab, seq_len=16,
                      global_batch=4).next_batch()
    batch = {k: torch.from_numpy(b[k]).reshape(2, 2, 16)
             for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        batch["enc_inputs"] = torch.from_numpy(np.random.default_rng(
            1).normal(size=(2, 2, cfg.enc_seq, cfg.d_model)).astype(
            np.float32))
    want = _train_step_on(cpu, cfg, batch)
    before = {k: f.launches for k, f in _KERNELS.items()}
    got = _train_step_on(card, cfg, batch)
    assert {k: f.launches for k, f in _KERNELS.items()} == before
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got[2], want[2], atol=1e-4, rtol=1e-4)
    left = total = 0
    for g, w, p, q in zip(got[1], want[1], got[3], want[3]):
        s = float(w.abs().max()) or 1.0
        torch.testing.assert_close(g / s, w / s, atol=1e-4, rtol=1e-4)
        keep = (w == 0) | (w.abs() > 1e-3 * w.abs().max())
        torch.testing.assert_close(p[keep], q[keep], atol=1e-4, rtol=1e-4)
        left, total = left + int((~keep).sum()), total + keep.numel()
    assert left <= 0.05 * total


_KERNELS = {"classify_fused": classify_fused, "tree_walk": tree_walk,
            "tcam_match": tcam_match, "forest_vote": forest_vote,
            "svm_lookup": svm_lookup, "decode_attn": decode_attn}

_RESUME_CHILD = """
import json, shutil, sys, tempfile
import torch
sys.path.insert(0, {src!r})
from repro_torch.configs import get_config
from repro_torch.launch.train import next_batch, opt_config, setup
from repro_torch.train.checkpoint import Checkpointer

torch.use_deterministic_algorithms(True)
cfg = get_config("internlm2-1.8b").scaled(n_layers=1, d_model=256,
                                          n_heads=4, n_kv=2, d_ff=512)
ocfg = opt_config(cfg, smoke=False, steps=4)

def run(seed):
    return setup(cfg, seq=256, global_batch=8, n_micro=2, ocfg=ocfg,
                 device="cuda", seed=seed)

def steps(r, n):
    for _ in range(n):
        r.step(r.model, r.opt, next_batch(r))

def tensors(r):
    return ([p for p in r.model.parameters()] + list(r.opt["m"].values())
            + list(r.opt["v"].values()) + [r.opt["step"]])

a = run(0)
steps(a, 4)
b = run(0)
steps(b, 2)
d = tempfile.mkdtemp()
try:
    ck = Checkpointer(d, keep=1)
    ck.save(2, b.model, b.opt, extra={{"data": b.pipe.state_dict()}})
    ck.wait()
    c = run(1)
    ptrs = [t.data_ptr() for t in tensors(c)]
    ck.restore(c.model, c.opt)
    c.pipe.load_state_dict(b.pipe.state_dict())
finally:
    shutil.rmtree(d)
steps(c, 2)
print(json.dumps({{
    "differ": sum(not torch.equal(x, y) for x, y in zip(tensors(a),
                                                         tensors(c))),
    "moved": [t.data_ptr() for t in tensors(c)] != ptrs,
    "cursors": [a.pipe.cursor, c.pipe.cursor]}}))
"""


def test_train_resume_is_bit_exact_in_a_deterministic_child(cuda):
    """In a child with deterministic algorithms (``CUBLAS_WORKSPACE_CONFIG``
    set): 4 steps straight, against 2, a checkpoint restored into weights
    from another seed, and 2 more; every weight and moment bit-equal, the
    step and the data cursor too, no ``data_ptr`` moved."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    src = str(pathlib.Path(__file__).resolve().parent.parent / "src")
    res = subprocess.run(
        [sys.executable, "-c", _RESUME_CHILD.format(src=src)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"differ": 0, "moved": False, "cursors": [4, 4]}
