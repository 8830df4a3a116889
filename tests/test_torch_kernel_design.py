"""The redesigned kernels' arithmetic and geometry, held on the CPU.

``decode_attn`` on the card splits the cache range into spans, one block
each, and the last block of a (sequence, KV head, query chunk) merges the
spans' partial softmaxes in span order.  ``split_model`` below is that
algorithm in torch: each span's (m, l, acc) in f32, merged in order, with
empty spans contributing m = -inf, l = 0.  It is held to the twin
``ref.decode_attn`` and to the Pallas kernel in interpret mode on the
``tests/test_kernels.py`` sweep (the JAX package's tolerances: f32 atol
2e-5, bf16 atol 2e-2, rtol 1e-2; the two differ in summation order only),
at the kernel's own span lengths and at spans of 8 rows (many spans, some
empty), with kv_len 0, below one span, on a span edge and equal to S.

``tcam_match`` on the card walks a (packet, tree) with a group of lanes:
rounds of GL consecutive records, the first hit picked by ballot over the
round's bits.  ``group_walk_model`` is that walk in torch, held to both
twins and to the Pallas kernel in interpret mode on the
``tests/test_kernels.py`` sweep, and on rows of length 0, 1, GL, GL + 1 and
E with a hit at the last valid entry, no hit, matching records past the
row's end and shifts 31 and 32.  ``svm_lookup`` splits a packet's features
into slices over the lanes of a group and merges their uint32 sums;
``split_svm_model`` does the same at any slice count and in any merge
order, held bit for bit to the twins with sums that wrap past 2^31.

``tree_walk`` and ``classify_fused`` walk with ``acorn::walk_pair``: a warp
of four (packet, tree) pairs, 8 lanes each, takes the layers in chunks of
8, skips the layers its ballot finds empty for all its pairs, loads the
next layer's first records ahead, and takes further rounds for rows longer
than 8.  ``layer_chunk_walk_model`` is that walk in torch, held to both
twins and to the Pallas kernel in interpret mode on the
``tests/test_kernels.py`` sweep (warps mixing versions and empty slots),
and on edge rows: L 13, T 33, rows of length 0, 1, GL, GL + 1 and E with
the hit at the last valid entry, shifts 31 and 32.  ``forest_vote`` and
``classify_fused`` search a tree's leaves with ``acorn::leaf_label_group``
(a GL-ary lower bound: ``group_leaf_model``, held to searchsorted's left
position in unsigned order) and vote with ``acorn::vote_warp`` (a lane a
class, the trees' weights passed by shuffle, a butterfly argmax:
``lane_vote_model``, held bit for bit to the twins with T and C past 32
and exact ties).  ``classify_fused``'s hop entry does the plane's
epilogue in those warps: ``hop_epilogue_model`` is its sign-code ballot
over the SVM warp's hyperplane lanes and its select in the vote warp, held
bit for bit to ``ref.classify_epilogue`` for H 1-16.  All of these are
integer results or f32 sums in the twins' order, so every comparison is
exact.

The geometry functions (``decode_attn.plan``,
``classify_fused.packets_per_block``, ``tcam_match.geometry``,
``svm_lookup.geometry``, ``tree_walk.geometry``,
``forest_vote.geometry``) are plain Python: at the timed shapes the grid
holds at least two blocks (or waves) on each of 132 SMs, the last round of
blocks fills at least half the SMs, no span starts past the cache, shared
memory stays within what a block may take (227 KB, 48 KB for the classify
kernels' static limit, the hop entry's three ints a packet counted;
tcam_match and svm_lookup take none), every lane
group of tree_walk and forest_vote has a pair where the batch allows it,
and an H above the SVM kernel's maximum is refused.  ``decode_attn``'s
arrival counters are kept per (device, stream).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.packets import PacketType, u32_bits, u32_from_bits
from repro_torch.core.translator import MID_DT, MID_RF, MID_SVM
from repro_torch.kernels import decode_attn as attn_module
from repro_torch.kernels import forest_vote as vote_module
from repro_torch.kernels import ref as tref
from repro_torch.kernels import svm_lookup as svm_module
from repro_torch.kernels import tcam_match as tcam_module
from repro_torch.kernels import tiling
from repro_torch.kernels import tree_walk as walk_module
from repro_torch.kernels import classify_fused as cf_module
from repro_torch.kernels.classify_fused import packets_per_block
from repro_torch.kernels.decode_attn import (
    SMEM_PER_BLOCK,
    SMS,
    decode_attn,
    plan,
)
from test_kernels import _rand_tcam_v

SWEEP = [(2, 4, 4, 16, 33, "float32"), (3, 8, 2, 32, 128, "float32"),
         (1, 16, 8, 64, 700, "bfloat16")]   # tests/test_kernels.py:166
TOL = {"float32": dict(atol=2e-5, rtol=1e-2),
       "bfloat16": dict(atol=2e-2, rtol=1e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def split_model(q, k, v, kv_len, n_split, split_len):
    """The kernel's split-KV algorithm in torch: span s covers rows
    [s * split_len, min((s + 1) * split_len, kv_len)); its partial is the
    running max m, the denominator l and the unnormalised f32 sum acc; the
    spans merge in order s = 0..n_split-1, and a row with no rows gives
    zeros."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * D ** -0.5
    n = kv_len.to(torch.int64).clamp(0, S)
    parts = []
    for s in range(n_split):
        lo = s * split_len
        pos = torch.arange(S)
        inside = (pos[None, :] >= lo) & (pos[None, :] < torch.minimum(
            n[:, None], torch.tensor(lo + split_len)))
        x = logits.masked_fill(~inside[:, None, None, :], float("-inf"))
        m = x.amax(dim=-1)
        p = torch.exp(x - torch.where(torch.isinf(m), 0.0, m)[..., None])
        parts.append((m, p.sum(-1), torch.einsum("bhgs,bshd->bhgd", p,
                                                  v.float())))
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(M)
    acc = torch.zeros_like(parts[0][2])
    for m, ls, a in parts:          # span order
        w = torch.where(torch.isinf(m), 0.0, torch.exp(m - M))
        l = l + ls * w
        acc = acc + a * w[..., None]
    out = torch.where(l[..., None] > 0, acc / l.clamp_min(1e-30)[..., None],
                      0.0)
    return out.reshape(B, Hq, D).to(q.dtype)


def _case(i):
    B, Hq, Hkv, D, S, dtype = SWEEP[i]
    rng = np.random.default_rng(200 + i)
    q, k, v = (rng.normal(size=s) for s in ((B, Hq, D), (B, S, Hkv, D),
                                            (B, S, Hkv, D)))
    kvl = rng.integers(1, S + 1, B)
    j = [jnp.asarray(x, JDT[dtype]) for x in (q, k, v)]
    t = [torch.from_numpy(np.array(x, np.float32)).to(TDT[dtype])
         for x in j]
    kvl = kvl.astype(np.int32)
    return j + [jnp.asarray(kvl)], t + [torch.from_numpy(kvl)]


def _spans(i, kind):
    """(n_split, split_len): the kernel's plan, or spans of 8 rows."""
    B, Hq, Hkv, D, S, dtype = SWEEP[i]
    if kind == "plan":
        p = plan(B, Hq, Hkv, D, S, TDT[dtype])
        return p.n_split, p.split_len
    return -(-S // 8), 8


@pytest.mark.parametrize("spans", ["plan", "rows of 8"])
@pytest.mark.parametrize("case", range(len(SWEEP)))
def test_split_model_matches_twin_and_pallas(case, spans):
    jin, tin = _case(case)
    dtype = SWEEP[case][-1]
    got = split_model(*tin, *_spans(case, spans))
    want_interp = np.asarray(jops.decode_attn(*jin, mode="interpret"),
                             np.float32)
    np.testing.assert_allclose(got.float().numpy(), want_interp, **TOL[dtype])
    torch.testing.assert_close(got.float(), tref.decode_attn(*tin).float(),
                               **TOL[dtype])


def _edge_lengths(S, split_len):
    """kv_len 0, 1, below one span, on and beside a span edge, S - 1 and
    S."""
    return [0, 1, split_len - 1, split_len, split_len + 1, S - 1, S]


@pytest.mark.parametrize("case", range(len(SWEEP)))
def test_split_model_at_span_edges(case):
    """kv_len 0 (every span empty: zeros), below one span (later spans
    empty), on and beside a span edge, and S, at spans of 8 rows; the same
    rows through the wrapper's plain version."""
    _, Hq, Hkv, D, S, dtype = SWEEP[case]
    n_split, split_len = _spans(case, "rows of 8")
    lens = _edge_lengths(S, split_len)
    rng = np.random.default_rng(300 + case)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(TDT[dtype]) for s in ((len(lens), Hq, D),
                                         (len(lens), S, Hkv, D),
                                         (len(lens), S, Hkv, D)))
    kv_len = torch.tensor(lens, dtype=torch.int32)
    got = split_model(q, k, v, kv_len, n_split, split_len)
    assert torch.equal(got[kv_len == 0], torch.zeros_like(got[kv_len == 0]))
    want = tref.decode_attn(q, k, v, kv_len)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(decode_attn(q, k, v, kv_len).float(),
                               want.float(), rtol=0, atol=0)
    jax_in = [jnp.asarray(x.float().numpy(), JDT[dtype]) for x in (q, k, v)]
    interp = np.asarray(jops.decode_attn(*jax_in, jnp.asarray(lens, jnp.int32),
                                         mode="interpret"), np.float32)
    np.testing.assert_allclose(got.float().numpy(), interp, **TOL[dtype])


# the timed shapes (B, Hq, Hkv, D, S): internlm2-1.8b at B 16 over 4096,
# granite-20b's heads at B 16 over 4096, internlm2-1.8b at B 4 over 32768
TIMED = [(16, 16, 8, 128, 4096), (16, 48, 1, 128, 4096),
         (4, 16, 8, 128, 32768)]


@pytest.mark.parametrize("shape", TIMED)
def test_plan_fills_two_waves_at_the_timed_shapes(shape):
    p = plan(*shape, torch.bfloat16)
    assert p.blocks >= 2 * SMS
    assert p.n_split > 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("S", [0, 1, 33, 700, 4096, 32768])
@pytest.mark.parametrize("G", [1, 2, 6, 12, 48])
@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
def test_plan_spans_cover_the_cache_and_fit(D, G, S, dtype):
    """Spans cover [0, S) with none starting past it, each a whole number
    of tiles; the query chunks cover G; shared memory fits a block."""
    p = plan(3, G * 2, 2, D, S, dtype)
    assert p.n_split >= 1 and p.split_len % p.tile == 0
    assert p.n_split * p.split_len >= S
    assert S == 0 or (p.n_split - 1) * p.split_len < S
    assert p.n_chunks * p.qc >= G and (p.n_chunks - 1) * p.qc < G
    assert p.ws_rows == min(G, p.qc)
    assert p.smem <= SMEM_PER_BLOCK and p.resident >= 1
    assert p.blocks == 3 * 2 * p.n_chunks * p.n_split
    assert (2 * p.n_split + 1) * p.ws_rows * 4 <= p.smem
    if dtype == torch.bfloat16:
        assert p.qc == 16
    else:
        assert p.qc in (1, 2, 4, 8)


@pytest.mark.parametrize("B,T,F,L", [(4096, 8, 60, 32), (4097, 8, 60, 32),
                                     (1, 8, 60, 32), (37, 3, 10, 6),
                                     (100_000, 8, 60, 32),
                                     (100_000, 1, 732, 32)])
def test_classify_packets_per_block(B, T, F, L):
    """The classify kernel's blocks: feature rows, labels, row lengths and
    a packet's slot, hop flags and SVM result within 48 KB, no more
    packets than give each warp its (packet, tree) walks, and at the zoo's
    B 4096 a grid of at least two blocks on each of 132 SMs.  At T 1, F
    732, L 32 the three ints a packet bind: 15 packets a block, where one
    int a packet would have fit 16."""
    pb = packets_per_block(T, F, B, L=L)
    assert 1 <= pb <= packets_per_block(T, F, L=L)
    assert cf_module.smem_ints(T, F, L) == F + T + 3 + L * T
    assert (pb * (F + T + 3 + L * T) + L) * 4 <= 48 * 1024
    if (T, F) == (1, 732):
        assert pb == 15 and (16 * (F + T + 1 + L * T) + L) * 4 <= 48 * 1024
    assert (pb - 1) * T < cf_module.WALK_WARPS * cf_module.WALKS_PER_WARP
    if B >= 4096:
        assert -(-B // pb) >= 2 * SMS


# recurrentgemma-2b's heads (10 query, 1 KV, D 256) at B 16 and B 4 over its
# window of 2048: (dtype, the K/V ring, the staged query rows)
D256 = {torch.bfloat16: (3 * 2 * 64 * (512 + 16), 16 * (512 + 16)),
        torch.float32: (3 * 2 * 32 * (1024 + 16), 0)}


@pytest.mark.parametrize("B", [16, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_plan_at_head_dim_256(dtype, B):
    """D 256 fits one block an SM: bf16 202,752 bytes of ring and 8,448 of
    query rows (the 16 rows' A fragments would take 64 registers a
    thread), f32 199,680 of ring; both under the 232,448 a block may
    take, with the card's 1,024 reserved a block beside them."""
    p = plan(B, 10, 1, 256, 2048, dtype)
    ring, rows = D256[dtype]
    assert p.smem == ring + rows <= SMEM_PER_BLOCK
    assert p.smem + attn_module.BLOCK_RESERVED <= attn_module.SMEM_PER_SM
    assert 2 * (p.smem + attn_module.BLOCK_RESERVED) > attn_module.SMEM_PER_SM
    assert p.resident == 1
    assert p.n_split * p.split_len >= 2048 and p.n_split > 1
    assert p.blocks == B * p.n_chunks * p.n_split
    assert p.n_chunks == (1 if dtype == torch.bfloat16 else 2)
    assert 256 in attn_module.HEAD_DIMS


def test_lut_fh_is_the_lut_with_hyperplanes_innermost():
    """The fused kernel's LUT copy holds the same products as the staged
    kernels' LUT, [V, F, levels, H] for [V, H, F, levels]."""
    rng = np.random.default_rng(21)
    V, L, T, E, P, H, F, lv = 2, 3, 2, 5, 4, 3, 6, 8
    i32 = np.int32
    ops_ = tiling.prep_classify_fused(
        *(torch.from_numpy(rng.integers(0, 4, (V, L, T, E)).astype(i32))
          for _ in range(2)),
        torch.from_numpy(rng.integers(0, F, (V, L, T, E)).astype(i32)),
        torch.zeros((V, L, T, E), dtype=torch.int32),
        torch.full((V, L, T, E), 3, dtype=torch.int32),
        torch.ones((V, L, T, E), dtype=torch.int32),
        torch.ones((V, L, T, E), dtype=torch.bool),
        torch.from_numpy(np.sort(rng.integers(0, 99, (V, T, P)), -1)
                         .astype(i32)),
        torch.zeros((V, T, P), dtype=torch.int32),
        torch.ones((V, T, P), dtype=torch.bool), torch.ones((V, T)),
        torch.from_numpy(rng.integers(-9, 9, (V, H, F, lv)).astype(i32)),
        torch.zeros((V, H), dtype=torch.int32))
    assert ops_.lut_fh.shape == (V, F, lv, H) and ops_.lut_fh.is_contiguous()
    assert torch.equal(ops_.lut_fh, ops_.lut.permute(0, 2, 3, 1))



# ------------------------------------------- tcam_match: the lane-group walk
GL = tcam_module.LANES


def group_walk_model(codes, features, vid, layer_shift, ops, layer, lanes):
    """The kernel's walk of layer ``layer`` in torch: for each (packet,
    tree) of a version in [0, V), rounds of ``lanes`` consecutive records
    from entry 0 while no hit is found and entries remain (e0 < n); a
    round's hits are the records below n that match; the first hit is the
    round's lowest set bit and sets the layer's bit if its set_bit is 1.
    Records at or past n are never hits, whatever they hold."""
    V, _, T, E, _ = ops.entries.shape
    B = codes.shape[0]
    ok = (vid >= 0) & (vid < V)
    v = torch.where(ok, vid, 0).long()
    cv, cm, w2, w3 = ops.entries[v, layer].unbind(-1)         # [B, T, E]
    n = ops.n_entries[v, layer]                               # [B, T]
    fid = (w2 << 16) >> 16
    x = torch.gather(features.long(), 1, fid.reshape(B, T * E).long()) \
        .reshape(B, T, E)
    test = (((codes[..., None] & cm) == cv) & (x >= (w2 >> 16))
            & (x <= ((w3 << 16) >> 16)))
    set_bit = ((w3 >> 16) & 1) == 1
    shift = int(layer_shift[layer])
    bit = int(np.array(1 << shift if 0 <= shift < 32 else 0, np.uint32)
              .view(np.int32))
    out = codes.clone()
    done = torch.zeros((B, T), dtype=torch.bool)
    for e0 in range(0, E, lanes):
        e = torch.arange(e0, min(e0 + lanes, E))
        active = ~done & (e0 < n)
        hits = test[..., e] & (e < n[..., None])              # the ballot
        found = active & hits.any(-1)
        first = hits.int().argmax(-1, keepdim=True)           # lowest lane
        sets = torch.gather(set_bit[..., e], -1, first)[..., 0]
        out = torch.where(found & sets, out | bit, out)
        done |= found
    return torch.where(ok[:, None], out, codes)


def _sweep_case(B, T, E, F, V, seed):
    """The tcam_match sweeps of tests/test_kernels.py (:23 at V = 1, :128
    with an empty slot 0), drawn with that file's generator."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**12, (B, T)).astype(np.uint32)
    feats = rng.integers(0, 256, (B, F)).astype(np.int32)
    vid = rng.integers(0, V, B).astype(np.int32)
    tables = _rand_tcam_v(rng, B, T, E, F, V,
                          empty_slots=(0,) if V > 1 else ())
    shift = int(rng.integers(0, 20))
    return codes, feats, vid, [np.asarray(a) for a in tables], shift


def _walk_ops(tables, F):
    """[V, T, E] source tables -> one layer of walk records."""
    tt = [u32_bits(a) if a.dtype == np.uint32 else torch.from_numpy(a.copy())
          for a in tables]
    return tiling.prep_walk(*(a[:, None] for a in tt), F)


TCAM_SWEEP = [(7, 1, 3, 4, 1), (64, 4, 17, 13, 1), (257, 8, 64, 60, 1),
              (33, 2, 128, 46, 1), (300, 2, 130, 20, 2), (257, 3, 150, 13, 3)]


@pytest.mark.parametrize("lanes", [GL, 1, 3, 32])
@pytest.mark.parametrize("case", TCAM_SWEEP)
def test_group_walk_model_matches_twins_and_pallas(case, lanes):
    """The lane-group walk at the kernel's GL (and at 1, 3 and 32 lanes:
    the round width cannot change the first match) equals the port's twin,
    the JAX oracle and the Pallas kernel in interpret mode."""
    B, T, E, F, V = case
    codes, feats, vid, tables, shift = _sweep_case(*case, seed=B * 7 + E)
    ops_ = _walk_ops(tables, F)
    tc, tf, tv = u32_bits(codes), torch.from_numpy(feats), \
        torch.from_numpy(vid)
    shift_t = torch.tensor([shift], dtype=torch.int32)
    got = group_walk_model(tc, tf, tv, shift_t, ops_, 0, lanes)
    jargs = (jnp.asarray(codes), jnp.asarray(feats), jnp.asarray(vid),
             *(jnp.asarray(a) for a in tables), jnp.int32(shift))
    want = np.asarray(jref.tcam_match_v(*jargs))
    np.testing.assert_array_equal(u32_from_bits(got), want)
    np.testing.assert_array_equal(
        np.asarray(jops.tcam_match_v(*jargs, mode="interpret")), want)
    np.testing.assert_array_equal(
        u32_from_bits(tref.tcam_match_v(
            tc, tf, tv, *(u32_bits(a) if a.dtype == np.uint32
                          else torch.from_numpy(a.copy()) for a in tables),
            shift)),
        want)


def edge_rows(E=20, F=4):
    """One version, one layer, a tree per row case: lengths 0, 1, GL,
    GL + 1 and E, each with a hit at its last valid entry (set_bit 1) and
    with no hit; two hits in one round (the first with set_bit 0); a hit in
    a later round.  Every record past a row's length matches (the kernel's
    first round loads them).  The packet's code is 0b101, its features
    all 5; a matching record is value 0b101 under mask 0b111 and range
    [5, 5], a missing one value 0b010."""
    lengths, hit_at = [], []
    for n in (1, GL, GL + 1, E):
        lengths += [n, n]
        hit_at += [[n - 1], []]
    lengths += [0, GL, E]
    hit_at += [[], [2, 5], [GL + 3, 2 * GL + 1]]
    T = len(lengths)
    rec = torch.zeros((1, 1, T, E, 4), dtype=torch.int32)
    rec[..., 0] = 0b010                                  # value: no match
    rec[..., 1] = 0b111                                  # mask
    rec[..., 2] = 0 | (5 << 16)                          # fid 0, f_lo 5
    rec[..., 3] = 5 | (1 << 16)                          # f_hi 5, set_bit 1
    for t, (n, hits) in enumerate(zip(lengths, hit_at)):
        rec[0, 0, t, n:, 0] = 0b101                      # past n: would match
        for k, e in enumerate(hits):
            rec[0, 0, t, e, 0] = 0b101
            if len(hits) == 2 and k == 0 and e < GL:     # first of a round
                rec[0, 0, t, e, 3] = 5                   # set_bit 0
    n_entries = torch.tensor(lengths, dtype=torch.int32).reshape(1, 1, T)
    ops_ = tiling.WalkOperands(rec.contiguous(), n_entries)
    codes = torch.full((3, T), 0b101, dtype=torch.int32)
    feats = torch.full((3, F), 5, dtype=torch.int32)
    vid = torch.tensor([0, -1, 1], dtype=torch.int32)    # in, below, above
    return codes, feats, vid, ops_, lengths, hit_at


@pytest.mark.parametrize("shift", [3, 31, 32])
def test_group_walk_model_on_edge_rows(shift):
    """Rows of length 0, 1, GL, GL + 1 and E, hit at the last valid entry
    or none, two hits in a round, a hit in a later round, matching records
    past the row; shift 31 (the sign bit of the int32 codes) and 32 (sets
    nothing); a vid outside [0, V) passes its codes through.  The model,
    the kernel's plain version, the port's twin and the JAX oracle (and
    Pallas in interpret mode) agree, and give the expected bits."""
    codes, feats, vid, ops_, lengths, hit_at = edge_rows()
    shift_t = torch.tensor([shift], dtype=torch.int32)
    got = group_walk_model(codes, feats, vid, shift_t, ops_, 0, GL)
    plain = tcam_module.tcam_match_plain(codes, feats, vid, shift_t, ops_, 0)
    assert torch.equal(got, plain)
    assert torch.equal(tcam_module.tcam_match(codes, feats, vid, shift_t,
                                              ops_, 0), plain)
    cv, cm, fid, flo, fhi, bit, valid = (a[:, 0] for a in
                                         tiling.unpack_walk(ops_))
    # the JAX oracle clamps a vid outside [0, V): it is held on row 0 only
    jargs = (jnp.asarray(u32_from_bits(codes[:1])),
             jnp.asarray(feats[:1].numpy()),
             jnp.asarray(vid[:1].numpy()), jnp.asarray(u32_from_bits(cv)),
             jnp.asarray(u32_from_bits(cm)), jnp.asarray(fid.numpy()),
             jnp.asarray(flo.numpy()), jnp.asarray(fhi.numpy()),
             jnp.asarray(bit.numpy().astype(np.uint32)),
             jnp.asarray(valid.numpy()), jnp.int32(shift))
    want = np.asarray(jref.tcam_match_v(*jargs))
    np.testing.assert_array_equal(u32_from_bits(got[:1]), want)
    np.testing.assert_array_equal(
        np.asarray(jops.tcam_match_v(*jargs, mode="interpret")), want)
    bit_v = np.uint32(1 << shift) if shift < 32 else np.uint32(0)
    expect = [np.uint32(0b101) | (bit_v if h and not (len(h) == 2
                                                    and h[0] < GL) else 0)
              for h in hit_at]
    np.testing.assert_array_equal(want[0], expect)
    assert torch.equal(got[1:], codes[1:])


# ------------------------------------------ svm_lookup: features over lanes
def split_svm_model(features, vid, lut_fh, bias, lanes, rng):
    """The kernel's sums in torch: slice j of the features (the kernel's
    lanes of slice j, one a quad of hyperplanes) sums the products of
    features j, j + lanes, ... (a feature outside [0, levels) adds 0) from
    ``lut_fh`` [V, F, levels, H] mod 2^32; the slices' sums are then merged
    two at a time in an order drawn from ``rng``, and the bias added last.
    A vid outside [0, V) gives 0."""
    V, F, lv, H = lut_fh.shape
    ok = (vid >= 0) & (vid < V)
    v = torch.where(ok, vid, 0).long()
    x = features.long()
    use = (x >= 0) & (x < lv)
    cells = lut_fh[v[:, None], torch.arange(F)[None, :], x.clamp(0, lv - 1)]
    cells = torch.where(use[..., None], cells.long(), 0)       # [B, F, H]
    parts = [cells[:, j::lanes].sum(1) & 0xFFFFFFFF for j in range(lanes)]
    while len(parts) > 1:                          # any merge order
        i, j = sorted(rng.choice(len(parts), 2, replace=False))
        parts.append((parts.pop(j) + parts.pop(i)) & 0xFFFFFFFF)
    acc = (parts[0] + bias[v].long()) & 0xFFFFFFFF
    sums = torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32)
    return torch.where(ok[:, None], sums, 0)


# (B, H, F, levels, V): tests/test_kernels.py:33's SVM sweep, and V > 1
SVM_SWEEP = [(5, 1, 3, 16, 1), (64, 3, 14, 64, 1), (130, 8, 46, 256, 1),
             (16, 12, 8, 256, 1), (70, 12, 60, 256, 4), (33, 16, 17, 32, 3)]


@pytest.mark.parametrize("lanes", [svm_module.geometry(1, 12).slices, 1, 5,
                                   32])
@pytest.mark.parametrize("case", SVM_SWEEP)
def test_split_svm_model_matches_twins_and_pallas(case, lanes):
    """At the sweep's values (|LUT| < 60,000, where the TPU kernel's f32
    contraction is exact): the feature-split sums equal the port's twin,
    the JAX oracle and the Pallas kernel in interpret mode."""
    B, H, F, lv, V = case
    rng = np.random.default_rng(B + 10 * H + lanes)
    feats = rng.integers(0, lv, (B, F)).astype(np.int32)
    vid = rng.integers(0, V, B).astype(np.int32)
    lut = rng.integers(-60_000, 60_000, (V, H, F, lv)).astype(np.int32)
    bias = rng.integers(-10_000, 10_000, (V, H)).astype(np.int32)
    ops_ = tiling.prep_lut(torch.from_numpy(lut), torch.from_numpy(bias))
    got = split_svm_model(torch.from_numpy(feats), torch.from_numpy(vid),
                          ops_.lut_fh, ops_.bias, lanes, rng)
    jargs = [jnp.asarray(a) for a in (feats, vid, lut, bias)]
    want = np.asarray(jref.svm_lookup_v(*jargs))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jops.svm_lookup_v(*jargs, mode="interpret")), want)
    np.testing.assert_array_equal(
        tref.svm_lookup_v(*(torch.from_numpy(a) for a in
                            (feats, vid, lut, bias))).numpy(), want)


@pytest.mark.parametrize("lanes", [svm_module.geometry(1, 12).slices, 2, 7,
                                   16, 60])
def test_split_svm_model_wraps_like_the_twin(lanes):
    """Products up to 2^30 over 60 features: sums wrap past 2^31 (and past
    2^32) in every lane and merge; features outside [0, levels) add 0; a
    vid outside [0, V) gives 0.  Every merge order gives the twin's bits,
    and the JAX oracle's where features and vids are in range."""
    B, H, F, lv, V = 96, 12, 60, 32, 3
    rng = np.random.default_rng(lanes)
    feats = rng.integers(0, lv, (B, F)).astype(np.int32)
    lut = rng.integers(2**29, 2**30, (V, H, F, lv)).astype(np.int32)
    lut[1] *= -1
    bias = rng.integers(-2**31, 2**31 - 1, (V, H)).astype(np.int32)
    vid = rng.integers(0, V, B).astype(np.int32)
    ops_ = tiling.prep_lut(torch.from_numpy(lut), torch.from_numpy(bias))
    tf, tv = torch.from_numpy(feats), torch.from_numpy(vid)
    twin = tref.svm_lookup_v(tf, tv, ops_.lut, ops_.bias)
    for _ in range(3):
        assert torch.equal(split_svm_model(tf, tv, ops_.lut_fh, ops_.bias,
                                           lanes, rng), twin)
    want = np.asarray(jref.svm_lookup_v(*(jnp.asarray(a) for a in
                                          (feats, vid, lut, bias))))
    np.testing.assert_array_equal(twin.numpy(), want)
    wide = np.where(rng.random((B, F)) < 0.2, rng.integers(lv, 3 * lv,
                                                           (B, F)), feats)
    wide[::5, 0] = -1
    wide_vid = np.where(rng.random(B) < 0.2, V + 1, vid)
    tf, tv = (torch.from_numpy(a.astype(np.int32)) for a in (wide, wide_vid))
    twin = tref.svm_lookup_v(tf, tv, ops_.lut, ops_.bias)
    assert torch.equal(split_svm_model(tf, tv, ops_.lut_fh, ops_.bias, lanes,
                                       rng), twin)
    assert torch.equal(svm_module.svm_lookup(tf, tv, ops_), twin)
    assert not twin[torch.from_numpy(wide_vid) > V].any()


# ---------------------------------- classify_fused's hop entry: the epilogue
U32 = 0xFFFFFFFF


def hop_epilogue_model(codes_in, svm_acc_in, rslt_in, ptype, mid, vid, V,
                       walked, label, sums, pred_enable, svm_bias,
                       svm_hvalid, svm_pred_table, svm_pred_enable, mid_svm,
                       request):
    """The hop entry's epilogue as its warps compute it, packet by packet:
    in the SVM warp, lane h of slice 0 (lane = slice * hp + h, hp the power
    of two at or above H) hands on acc + sums mod 2^32 and tests its sign
    with the source bias; one ballot over the warp's 32 lanes is the sign
    code (lane h is bit h), and lane 0 looks up the SVM result.  In the
    vote warp, lane 0 then selects the result and writes rslt; the walk
    writes each code or passes it through.  ``walked``, ``label`` and
    ``sums`` are the kernel's on the clamped slot (a vid outside [0, V) is
    walked and summed against slot 0)."""
    B, H = svm_acc_in.shape
    hp = 1
    while hp < H:
        hp *= 2
    out_codes, out_acc = codes_in.clone(), svm_acc_in.clone()
    out_rslt = rslt_in.clone()
    for b in range(B):
        ok = 0 <= int(vid[b]) < V
        v = int(vid[b]) if ok else 0
        req = int(ptype[b]) == request
        ballot = 0
        for lane in range(32):
            h, sl = lane % hp, lane // hp
            if sl != 0 or h >= H:
                continue
            acc_in = int(svm_acc_in[b, h]) & U32
            handed = (acc_in + (int(sums[b, h]) & U32)) & U32
            total = (handed + (int(svm_bias[v, h]) & U32)) & U32
            sign = total < 2**31 and bool(svm_hvalid[v, h])
            ballot |= int(sign) << lane
            if req:
                out_acc[b, h] = handed - 2**32 if handed >= 2**31 else handed
        svm = int(svm_pred_table[v, ballot]) if svm_pred_enable[v] else -1
        tree = int(label[b]) if pred_enable[v] else -1
        result = (-1 if not ok else svm if int(mid[b]) == mid_svm
                  else tree)
        if req:
            out_codes[b] = walked[b]
            if result >= 0:
                out_rslt[b] = result
    return out_codes, out_acc, out_rslt


@pytest.mark.parametrize("H", range(1, cf_module.MAX_HOP_H + 1))
def test_hop_epilogue_model_matches_the_twin(H):
    """H 1-16 (one round of hp = 1-16 hyperplane lanes, the rest of the
    warp out of the ballot): the lane model of the sign-code ballot and of
    the vote warp's select equals ``ref.classify_epilogue`` bit for bit, on
    vids outside the zoo, every packet type, both pipelines, disabled
    predicts, masked hyperplanes, sums past 2^31 and sums at 0 and -1."""
    rng = np.random.default_rng(H)
    B, V, T, C = 48, 3, 2, 5

    def i32(a):
        return torch.from_numpy(np.asarray(a).astype(np.int32))
    full = (-2**31, 2**31 - 1)
    vid = i32(rng.integers(-1, V + 1, B))
    ptype = i32(rng.choice([PacketType.FORWARD, PacketType.REQUEST,
                            PacketType.RESPONSE], B, p=[0.2, 0.6, 0.2]))
    mid = i32(rng.choice([MID_DT, MID_RF, MID_SVM], B))
    codes_in = i32(rng.integers(*full, (B, T)))
    acc_in = i32(rng.integers(*full, (B, H)))
    rslt_in = i32(rng.integers(-1, C, B))
    walked = i32(rng.integers(*full, (B, T)))
    label = i32(rng.integers(0, C, B))
    sums = i32(rng.integers(*full, (B, H)))
    tables = (torch.from_numpy(rng.random(V) < 0.7),
              i32(rng.integers(*full, (V, H))),
              torch.from_numpy(rng.random((V, H)) < 0.8),
              i32(rng.integers(0, C, (V, 2**H))),
              torch.from_numpy(rng.random(V) < 0.7))
    ok, slot = tref.zoo_slot(vid, V)
    # a few sums at exactly 0 and -1 with the bias: the sign test's edge
    edge = torch.arange(0, B, 5)
    total = (acc_in[edge].long() + tables[1][slot[edge].long()].long())
    sums[edge] = tref._wrap32(-total - (edge % 2)[:, None])
    want = tref.classify_epilogue(codes_in, acc_in, rslt_in, ptype, mid, ok,
                                  slot, walked, label, sums, *tables,
                                  MID_SVM, PacketType.REQUEST)
    got = hop_epilogue_model(codes_in, acc_in, rslt_in, ptype, mid, vid, V,
                             walked, label, sums, *tables, MID_SVM,
                             PacketType.REQUEST)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (want[2] != rslt_in).any() and (~ok).any()


# ------------------------------------------------- the staged geometries
def _last_round_fill(blocks):
    """The share of the 132 SMs the grid's last round of blocks (one an SM)
    occupies."""
    return (blocks % SMS or SMS) / SMS


@pytest.mark.parametrize("B,T", [(4096, 8), (4097, 8), (1, 8), (601, 3),
                                 (300, 1), (64, 33), (16, 100), (5, 32)])
def test_tcam_geometry(B, T):
    """A group of GL lanes for each (packet, tree) of a block (a group
    walks more than one tree when T > 32), no shared memory; at the zoo's
    B 4096 (8 trees) 4 packets a block, more than two blocks an SM, a last
    round at least half full, and ~62 of an SM's 64 warps."""
    g = tcam_module.geometry(B, T)
    groups = g.threads // GL
    assert g.packets >= 1 and g.blocks * g.packets >= B
    assert (g.blocks - 1) * g.packets < B
    assert g.packets * T <= groups or g.packets == 1
    assert (g.packets + 1) * T > groups
    if B == 4096 and T == 8:
        assert g.packets == 4 and g.blocks == 1024
        assert g.blocks >= 2 * SMS and _last_round_fill(g.blocks) >= 0.5
        assert 60 <= g.blocks * g.threads / 32 / SMS <= 64


def test_tcam_geometry_refuses_no_trees():
    with pytest.raises(ValueError, match="tree"):
        tcam_module.geometry(4, 0)


@pytest.mark.parametrize("B,H", [(4096, 12), (4097, 12), (1, 1), (300, 16),
                                 (4096, 4), (4096, 8), (9, 5)])
def test_svm_geometry(B, H):
    """LANES lanes a packet, a lane for each quad of hyperplanes of a cell
    (1, 2 or 4: the kernel's instances) times slices of the features; no
    shared memory; at the zoo's B 4096 at least two blocks on each of 132
    SMs and a last round at least half full."""
    g = svm_module.geometry(B, H)
    assert g.packets * svm_module.LANES == g.threads
    assert g.blocks * g.packets >= B and (g.blocks - 1) * g.packets < B
    assert g.cell_lanes in (1, 2, 4) and H <= 4 * g.cell_lanes < H + 8
    assert g.cell_lanes * g.slices == svm_module.LANES
    if B == 4096:
        assert g.blocks >= 2 * SMS and _last_round_fill(g.blocks) >= 0.5
    if H == 12:
        assert (g.cell_lanes, g.slices) == (4, 4)


@pytest.mark.parametrize("H", [0, svm_module.MAX_H + 1, 64])
def test_svm_geometry_refuses_an_h_beyond_the_kernel(H):
    with pytest.raises(ValueError, match="hyperplanes"):
        svm_module.geometry(4096, H)


def test_lut_operands_carry_lut_fh():
    """``prep_lut`` builds ``lut_fh`` for callers without an image; the
    image's ``.svm`` passes its own copy (no second copy a slot)."""
    rng = np.random.default_rng(5)
    lut = torch.from_numpy(rng.integers(-9, 9, (2, 3, 5, 7)).astype(np.int32))
    bias = torch.zeros((2, 3), dtype=torch.int32)
    ops_ = tiling.prep_lut(lut, bias)
    assert ops_.lut_fh.shape == (2, 5, 7, 3) and ops_.lut_fh.is_contiguous()
    assert torch.equal(ops_.lut_fh, lut.permute(0, 2, 3, 1))
    img = tiling.ClassifyFusedOperands(*([None] * 5), ops_.lut, ops_.bias,
                                       ops_.lut_fh)
    assert all(a is b for a, b in zip(img.svm, ops_))


# ------------------------------- tree_walk: lane groups over all the layers
WGL = walk_module.LANES
NO_MATCH_REC = (0, -1, 1 << 16, 0)   # acorn::no_match(): range [1, 0]


def _u32(x):
    """int32 bit patterns -> their uint32 values, as int64."""
    return x.long() & 0xFFFFFFFF


def _matches(rec, code, feats):
    """acorn::record_matches for records [N, k, 4] of packets with codes
    [N] (uint32 values) and feature rows [N, F]."""
    x, y, z, w = rec.long().unbind(-1)
    fid = ((z << 48) >> 48).clamp(min=0)
    f = torch.gather(feats.long(), 1, fid)
    in_range = (f >= (z >> 16)) & (f <= ((w << 48) >> 48))
    return in_range & ((code[:, None] & _u32(y)) == _u32(x))


def layer_chunk_walk_model(codes, features, vid, layer_shift, ops,
                           lanes=WGL, packets=None):
    """``acorn::walk_pair`` in torch, over every (packet, tree) pair: the
    row lengths staged per packet (0 off the zoo, so such a packet's codes
    pass through); a warp of 32 / lanes consecutive pairs of a block of
    ``packets`` packets (all B by default); per chunk of ``lanes`` layers,
    the layers the warp's ballot finds non-empty for any of its pairs, in
    order, each pair's first GL records of the next such layer loaded
    ahead (before this layer is compared); a round's first hit is its
    lowest lane, further rounds of GL records while the pair has none and
    entries remain; the first hit's set bit sets the layer's bit (none for
    a shift outside [0, 32))."""
    V, L, T, E, _ = ops.entries.shape
    B = codes.shape[0]
    ok = (vid >= 0) & (vid < V)
    v = torch.where(ok, vid, 0).long()
    n = torch.where(ok[:, None, None], ops.n_entries[v], 0)   # s_n [B, L, T]
    n = n.permute(0, 2, 1).reshape(B * T, L).long()           # per pair
    rec = ops.entries[v].permute(0, 2, 1, 3, 4).reshape(B * T, L, E, 4)
    feats = features.repeat_interleave(T, dim=0)              # per pair
    code = _u32(codes.reshape(-1))
    bits = [1 << s if 0 <= s < 32 else 0 for s in layer_shift.tolist()]
    gpw = 32 // lanes
    pb = packets or B
    pair = torch.arange(B * T)
    block = pair // (pb * T)
    warp = block * (-(-pb * T // gpw)) + (pair - block * pb * T) // gpw
    none = torch.tensor(NO_MATCH_REC, dtype=torch.int32)

    def first_round(l):
        e = torch.arange(lanes)
        got = rec[:, l, :lanes] if E >= lanes else torch.cat(
            [rec[:, l], none.expand(B * T, lanes - E, 4)], 1)
        return torch.where((e < n[:, l, None])[..., None], got, none)

    for l0 in range(0, L, lanes):
        chunk = range(l0, min(l0 + lanes, L))
        has = torch.zeros((int(warp.max()) + 1, L), dtype=torch.bool)
        has.index_put_((warp,), n > 0, accumulate=True)       # the ballot
        todo = [l for l in chunk if bool(has[:, l].any())]
        ahead = first_round(todo[0]) if todo else None
        for i, l in enumerate(todo):
            take = has[warp, l]            # the pair's warp walks layer l
            cur = ahead
            if i + 1 < len(todo):
                ahead = first_round(todo[i + 1])
            hit = _matches(cur, code, feats)
            mine = hit.any(-1)
            first = hit.int().argmax(-1, keepdim=True)
            sets = (torch.gather(cur[..., 3].long(), 1, first)[:, 0] >> 16) & 1
            for e0 in range(lanes, E, lanes):
                e = torch.arange(e0, min(e0 + lanes, E))
                r = torch.where((~mine[:, None] & (e < n[:, l, None]))[..., None],
                                rec[:, l, e], none)
                more = _matches(r, code, feats)
                new = ~mine & more.any(-1)
                at = more.int().argmax(-1, keepdim=True)
                more_set = (torch.gather(r[..., 3].long(), 1, at)[:, 0]
                            >> 16) & 1
                sets = torch.where(new, more_set, sets)
                mine |= new
            code = torch.where(take & mine & (sets == 1), code | bits[l],
                               code)
    out = torch.where(code >= 2**31, code - 2**32, code).to(torch.int32)
    return out.reshape(B, T)


# (B, T, E, F, V, L, empty): tests/test_kernels.py:84's tree-walk sweep
WALK_SWEEP = [(7, 1, 3, 4, 1, 1, ()), (64, 4, 17, 13, 3, 5, ()),
              (300, 2, 130, 20, 2, 3, ()), (257, 3, 33, 46, 4, 8, (1, 3)),
              (33, 5, 64, 60, 1, 32, ())]


def _walk_args(case, seed):
    B, T, E, F, V, L, empty = case
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**12, (B, T)).astype(np.uint32)
    feats = rng.integers(0, 256, (B, F)).astype(np.int32)
    vid = rng.integers(0, V, B).astype(np.int32)
    tables = [np.asarray(a) for a in _rand_tcam_v(rng, B, T, E, F, V, L=L,
                                                  empty_slots=empty)]
    shift = rng.permutation(L).astype(np.int32)
    return codes, feats, vid, tables, shift


def _walk_tables(tables):
    return [u32_bits(a) if a.dtype == np.uint32 else torch.from_numpy(a.copy())
            for a in tables]


@pytest.mark.parametrize("lanes,packets", [(WGL, None), (WGL, 2), (WGL, 3),
                                           (4, 1), (32, 5)])
@pytest.mark.parametrize("case", WALK_SWEEP)
def test_layer_chunk_walk_model_matches_twins_and_pallas(case, lanes,
                                                         packets):
    """The chunked lane-group walk (at the kernel's GL and blocks of 2
    packets, and at other widths and blocks: neither can change a first
    match) equals the port's twin, the JAX oracle and the Pallas kernel in
    interpret mode; warps mix pairs of different versions and empty
    slots."""
    codes, feats, vid, tables, shift = _walk_args(case, sum(case[:6]))
    F = feats.shape[1]
    tt = _walk_tables(tables)
    ops_ = tiling.prep_walk(*tt, F)
    tc, tf, tv = u32_bits(codes), torch.from_numpy(feats), \
        torch.from_numpy(vid)
    ts = torch.from_numpy(shift)
    got = layer_chunk_walk_model(tc, tf, tv, ts, ops_, lanes, packets)
    jargs = (jnp.asarray(codes), jnp.asarray(feats), jnp.asarray(vid),
             *(jnp.asarray(a) for a in tables), jnp.asarray(shift))
    want = np.asarray(jref.tree_walk_v(*jargs))
    np.testing.assert_array_equal(u32_from_bits(got), want)
    np.testing.assert_array_equal(u32_from_bits(
        tref.tree_walk_v(tc, tf, tv, *tt, ts)), want)
    if (lanes, packets) == (WGL, None):
        np.testing.assert_array_equal(
            np.asarray(jops.tree_walk_v(*jargs, mode="interpret")), want)
        assert torch.equal(walk_module.tree_walk(tc, tf, tv, ts, ops_), got)


def walk_edge_rows(V=2, L=13, T=33, E=20, F=4):
    """Edge rows over every layer: rows of length 0, 1, GL, GL + 1 and E,
    each with a hit at its last valid entry or with none (every record
    past a row's length would match), cycling over (version, layer, tree);
    layer 4 empty for every tree of version 0 (the warps skip it), layer 9
    empty for trees 0-3 only.  Records test the code's low 3 bits and the
    layers set bits 3 and up, so every layer sees the same matches.  Bit
    shifts include 31 (the sign bit of the int32 codes) and 32 (sets
    nothing).  Packets: code 0b101, features 5, vids 0, 1, -1 and V."""
    lengths = (0, 1, WGL, WGL + 1, E)
    rec = torch.zeros((V, L, T, E, 4), dtype=torch.int32)
    rec[..., 0] = 0b010                                  # value: no match
    rec[..., 1] = 0b111                                  # mask
    rec[..., 2] = 5 << 16                                # fid 0, f_lo 5
    rec[..., 3] = 5 | (1 << 16)                          # f_hi 5, set_bit 1
    n = torch.zeros((V, L, T), dtype=torch.int32)
    k = 0
    for v in range(V):
        for l in range(L):
            for t in range(T):
                k += 1
                if (v == 0 and l == 4) or (l == 9 and t < 4):
                    continue
                length = lengths[k % len(lengths)]
                n[v, l, t] = length
                rec[v, l, t, length:, 0] = 0b101         # past n: would match
                if length and k % 3:
                    rec[v, l, t, length - 1, 0] = 0b101  # hit at the last
                    rec[v, l, t, length - 1, 3] = 5 | ((k % 2) << 16)
    ops_ = tiling.WalkOperands(rec.contiguous(), n)
    shift = torch.tensor([3, 31, 7, 32, 4, 30, 5, 6, 8, 9, 29, 10, 11][:L],
                         dtype=torch.int32)
    codes = torch.full((4, T), 0b101, dtype=torch.int32)
    feats = torch.full((4, F), 5, dtype=torch.int32)
    vid = torch.tensor([0, 1, -1, V], dtype=torch.int32)
    return codes, feats, vid, shift, ops_


@pytest.mark.parametrize("T", [33, 5])
def test_layer_chunk_walk_model_on_edge_rows(T):
    """L 13 (a second chunk part-filled), T 33 and 5, rows of length 0, 1,
    GL, GL + 1 and E with the hit at the last valid entry, a layer empty
    for a whole version and one for some trees, shifts 31 and 32: the model
    equals the port's twin, the JAX oracle and Pallas in interpret mode (on
    the in-zoo packets: the oracle clamps a vid outside [0, V)), and a vid
    outside [0, V) passes its codes through."""
    codes, feats, vid, shift, ops_ = walk_edge_rows(T=T)
    got = layer_chunk_walk_model(codes, feats, vid, shift, ops_)
    tables = tiling.unpack_walk(ops_)
    assert torch.equal(tref.tree_walk_v(codes, feats, vid, *tables, shift),
                       got)
    assert torch.equal(walk_module.tree_walk(codes, feats, vid, shift, ops_),
                       got)
    assert torch.equal(got[2:], codes[2:])
    assert (got[:2] != codes[:2]).any()
    jt = [jnp.asarray(u32_from_bits(a)) if i in (0, 1) else
          jnp.asarray(a.numpy().astype(np.uint32)) if i == 5 else
          jnp.asarray(a.numpy()) for i, a in enumerate(tables)]
    jargs = (jnp.asarray(u32_from_bits(codes[:2])),
             jnp.asarray(feats[:2].numpy()), jnp.asarray(vid[:2].numpy()),
             *jt, jnp.asarray(shift.numpy()))
    want = np.asarray(jref.tree_walk_v(*jargs))
    np.testing.assert_array_equal(u32_from_bits(got[:2]), want)
    np.testing.assert_array_equal(
        np.asarray(jops.tree_walk_v(*jargs, mode="interpret")), want)


# -------------------------- forest_vote: the group leaf search and the vote
def group_leaf_model(pc, codes, lanes=WGL):
    """``acorn::leaf_label_group``'s search in torch: the lower bound of
    each code (uint32 values, [N]) over its sorted leaf codes ([N, P],
    uint32 values), by rounds of ``lanes`` probes at a stride of
    ceil(P / lanes), then ceil(stride / lanes), ... down to 1; a round's
    count of probes below the code (a popcount of the ballot) moves the
    low end, the first probe not below it bounds the high end.  Returns
    the positions [N]."""
    N, P = pc.shape
    lo = torch.zeros(N, dtype=torch.long)
    hi = torch.full((N,), P, dtype=torch.long)
    step = -(-P // lanes)
    while True:
        idx = lo[:, None] + torch.arange(1, lanes + 1) * step - 1
        below = (idx < hi[:, None]) & (torch.gather(
            pc, 1, idx.clamp(max=P - 1)) < codes[:, None])
        lo = lo + below.sum(-1) * step
        hi = torch.minimum(hi, lo + step - 1)
        if step == 1:
            return lo
        step = -(-step // lanes)


def lane_vote_model(lab, w, n_classes):
    """``acorn::vote_warp`` in numpy float32, for packets' per-tree labels
    [N, T] and weights [N, T]: lane i takes classes i, 32 + i, ...; each
    score summed in tree order, tree t's weight passed from the lane that
    loaded it (lane t % 32 of chunk t // 32); the lane keeps its first best
    class; then the xor butterfly over 16, 8, 4, 2, 1, where the higher
    score wins and a tie goes to the smaller class.  Returns every lane's
    class [N, 32] (all equal)."""
    N, T = lab.shape
    lane = np.arange(32)
    best = np.full((N, 32), -np.inf, np.float32)
    best_c = np.zeros((N, 32), np.int64)
    for c0 in range(0, n_classes, 32):
        c = c0 + lane
        score = np.zeros((N, 32), np.float32)
        for t0 in range(0, T, 32):
            wl = np.where(t0 + lane < T, w[:, np.minimum(t0 + lane, T - 1)],
                          np.float32(0))
            for t in range(min(32, T - t0)):
                wt = wl[:, t:t + 1]                        # the shuffle
                score = np.where(lab[:, t0 + t, None] == c, score + wt,
                                 score).astype(np.float32)
        upd = (c < n_classes) & (score > best)
        best = np.where(upd, score, best)
        best_c = np.where(upd, c, best_c)
    for off in (16, 8, 4, 2, 1):
        ob, oc = best[:, lane ^ off], best_c[:, lane ^ off]
        take = (ob > best) | ((ob == best) & (oc < best_c))
        best, best_c = np.where(take, ob, best), np.where(take, oc, best_c)
    return best_c


def forest_vote_model(codes, vid, ops, n_classes, lanes=WGL):
    """The kernel in torch: ``group_leaf_model`` per (packet, tree), the
    label at an exact match, ``lane_vote_model`` per packet; label 0 and
    per-tree 0 for a vid outside [0, V)."""
    V, T, P = ops.pred_codes.shape
    B = codes.shape[0]
    ok = (vid >= 0) & (vid < V)
    v = torch.where(ok, vid, 0).long()
    pc = _u32(ops.pred_codes[v].reshape(B * T, P))
    c = _u32(codes.reshape(-1))
    pos = group_leaf_model(pc, c, lanes).clamp(max=P - 1)
    hit = torch.gather(pc, 1, pos[:, None])[:, 0] == c
    label = torch.where(hit, torch.gather(
        ops.pred_labels[v].reshape(B * T, P), 1, pos[:, None])[:, 0], 0)
    per_tree = torch.where(ok[:, None], label.reshape(B, T), 0)
    lanes_c = lane_vote_model(per_tree.numpy(), ops.weights[v].numpy(),
                              n_classes)
    assert (lanes_c == lanes_c[:, :1]).all()
    vote = torch.from_numpy(lanes_c[:, 0]).to(torch.int32)
    return torch.where(ok, vote, 0), per_tree.to(torch.int32)


def _sorted_leaves(rng, P, n, top=2**32):
    """n rows of P distinct sorted uint32 leaf codes below ``top``, as
    int64 values."""
    return torch.from_numpy(np.sort(np.stack([
        rng.choice(top, size=P, replace=False) for _ in range(n)]), axis=1)
        .astype(np.int64))


@pytest.mark.parametrize("P", [1, 2, 7, 8, 9, 63, 64, 65, 256])
def test_group_leaf_model_finds_searchsorted_left(P):
    """For leaves spread over all of uint32 (at and above 2^31 too): codes
    below the first leaf, above the last, equal to the first, the last and
    each leaf, one past and one before each leaf, and 0, 2^31 - 1, 2^31
    and 2^32 - 1; the GL-ary search finds torch.searchsorted's left
    position in unsigned order, at the kernel's GL and at 2 and 32 lanes."""
    rng = np.random.default_rng(P)
    pc = _sorted_leaves(rng, P, 6)
    pc[0] = torch.arange(2**31 - P // 2, 2**31 - P // 2 + P)  # around 2^31
    rows, codes = [], []
    for i in range(pc.shape[0]):
        row = pc[i]
        want = [row[0] - 1, row[-1] + 1, 0, 2**31 - 1, 2**31, 2**32 - 1]
        want += row.tolist() + (row + 1).tolist() + (row - 1).tolist()
        want = [x for x in want if 0 <= x < 2**32]
        rows += [i] * len(want)
        codes += want
    rows = torch.tensor(rows)
    codes = torch.tensor(codes, dtype=torch.int64)
    want = torch.searchsorted(pc[rows], codes[:, None])[:, 0]
    for lanes in (WGL, 2, 32):
        assert torch.equal(group_leaf_model(pc[rows], codes, lanes), want)
    np.testing.assert_array_equal(
        want.numpy(), [np.searchsorted(pc[r].numpy().astype(np.uint32),
                                       np.uint32(c)) for r, c in
                       zip(rows.tolist(), codes.tolist())])


def _vote_ops(rng, V, T, P, C, top=2**16):
    pc = np.sort(rng.choice(top, size=V * T * P, replace=False)
                 .reshape(V, T, P), axis=2).astype(np.uint32)
    plab = rng.integers(0, C, (V, T, P)).astype(np.int32)
    pv = rng.random((V, T, P)) < 0.9
    w = rng.random((V, T)).astype(np.float32)
    return pc, plab, pv, w


def _leaf_hits(rng, pc, vid, miss=0.25):
    """Codes [B, T] that hit a leaf of their packet's version, a quarter
    of them missing (a code past every leaf or between two)."""
    V, T, P = pc.shape
    B = vid.shape[0]
    v = np.clip(vid, 0, V - 1)
    codes = pc[v[:, None], np.arange(T)[None, :], rng.integers(0, P, (B, T))]
    gone = rng.random((B, T)) < miss
    return np.where(gone, codes + np.uint32(1), codes).astype(np.uint32)


# (B, T, P, C, V): tests/test_kernels.py:46's V=1 sweep and :144's V=3 case
VOTE_SWEEP = [(9, 1, 4, 2, 1), (70, 4, 32, 5, 1), (300, 8, 256, 25, 1),
              (70, 3, 32, 5, 3)]


@pytest.mark.parametrize("case", VOTE_SWEEP)
def test_forest_vote_model_matches_twins_and_pallas(case):
    """The group search and the lane vote equal the port's twin, the JAX
    oracle and the Pallas kernel in interpret mode."""
    B, T, P, C, V = case
    rng = np.random.default_rng(B + P)
    pc, plab, pv, w = _vote_ops(rng, V, T, P, C)
    vid = rng.integers(0, V, B).astype(np.int32)
    codes = _leaf_hits(rng, pc, vid)
    jargs = (jnp.asarray(codes), jnp.asarray(vid), jnp.asarray(pc),
             jnp.asarray(plab), jnp.asarray(pv), jnp.asarray(w))
    want = jref.forest_predict_vote_v(*jargs, C)
    pallas = jops.forest_predict_vote_v(*jargs, C, mode="interpret")
    targs = (u32_bits(codes), torch.from_numpy(vid), u32_bits(pc),
             torch.from_numpy(plab), torch.from_numpy(pv),
             torch.from_numpy(w))
    ops_ = tiling.prep_leaves(*targs[2:])
    got = forest_vote_model(targs[0], targs[1], ops_, C)
    twin = tref.forest_predict_vote_v(*targs, C)
    for g, tw_, wa, pa in zip(got, twin, want, pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wa))
        np.testing.assert_array_equal(tw_.numpy(), np.asarray(wa))
        np.testing.assert_array_equal(np.asarray(pa), np.asarray(wa))
    for g, p in zip(got, vote_module.forest_vote(targs[0], targs[1], ops_,
                                                 C)):
        assert torch.equal(g, p)


@pytest.mark.parametrize("T,C", [(40, 40), (33, 70), (8, 33), (64, 3)])
def test_lane_vote_model_with_ties_past_a_warp(T, C):
    """T and C past 32 (a second chunk of trees and of classes) and exact
    ties: weights in quarters, so many scores tie exactly; held bit for bit
    to the port's twin and the JAX oracle, and to Pallas in interpret mode;
    a vid outside [0, V) gives label 0 and per-tree 0 (port twin)."""
    rng = np.random.default_rng(T * C)
    V, P, B = 2, 16, 96
    pc, plab, pv, _ = _vote_ops(rng, V, T, P, C)
    pv[:] = True
    w = (rng.integers(1, 4, (V, T)) / 4).astype(np.float32)
    vid = rng.integers(0, V, B).astype(np.int32)
    codes = _leaf_hits(rng, pc, vid, miss=0.1)
    jargs = (jnp.asarray(codes), jnp.asarray(vid), jnp.asarray(pc),
             jnp.asarray(plab), jnp.asarray(pv), jnp.asarray(w))
    want = jref.forest_predict_vote_v(*jargs, C)
    targs = (u32_bits(codes), torch.from_numpy(vid), u32_bits(pc),
             torch.from_numpy(plab), torch.from_numpy(pv),
             torch.from_numpy(w))
    ops_ = tiling.prep_leaves(*targs[2:])
    got = forest_vote_model(targs[0], targs[1], ops_, C)
    for g, wa in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wa))
    for g, p in zip(got, jops.forest_predict_vote_v(*jargs, C,
                                                    mode="interpret")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
    # the ties really happen, and go to the smaller class
    lab = got[1].numpy()
    wv = w[vid]
    scores = np.stack([(np.where(lab == c, wv, 0)).sum(1) for c in range(C)],
                      1)
    tied = (scores == scores.max(1, keepdims=True)).sum(1) > 1
    assert tied.any()
    np.testing.assert_array_equal(got[0].numpy()[tied],
                                  scores[tied].argmax(1))
    bad = torch.tensor([-1, V, V + 7] * 4, dtype=torch.int32)
    out = forest_vote_model(targs[0][:12], bad, ops_, C)
    twin = tref.forest_predict_vote_v(targs[0][:12], bad, *targs[2:], C)
    for g, tw_ in zip(out, twin):
        assert torch.equal(g, tw_) and not g.any()


# --------------------------------------------- the two new geometries
@pytest.mark.parametrize("B,T,F,L", [(4096, 8, 60, 32), (4097, 8, 60, 32),
                                     (1, 8, 60, 32), (529, 8, 60, 13),
                                     (1585, 3, 10, 4), (4225, 1, 60, 13),
                                     (40, 33, 13, 3), (100_000, 8, 60, 32)])
def test_tree_walk_geometry(B, T, F, L):
    """Every lane group has a pair where the batch allows it, the grid
    holds at least two blocks on each of 132 SMs (one packet a block below
    that), shared memory within 48 KB; at the zoo's B 4096, 2 packets a
    block, 2048 blocks of 128 threads, 1268 bytes a packet."""
    g = walk_module.geometry(B, T, F, L)
    groups = g.threads // WGL
    assert g.packets >= 1 and g.blocks == -(-B // g.packets)
    assert g.smem == (g.packets * (F + 1 + L * T) + L) * 4 <= 48 * 1024
    assert (g.packets - 1) * T < groups
    if B >= 2 * SMS * -(-groups // T):
        assert g.packets * T >= groups
    if g.packets > 1:
        assert g.blocks >= 2 * SMS
    if (B, T, F, L) == (4096, 8, 60, 32):
        assert (g.packets, g.blocks, g.threads) == (2, 2048, 128)
        assert g.smem - L * 4 == 2 * 1268


def test_tree_walk_geometry_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="tree"):
        walk_module.geometry(4, 0, 60, 32)
    with pytest.raises(ValueError, match="shared memory"):
        walk_module.geometry(4, 400, 60, 32)


@pytest.mark.parametrize("B,T", [(4096, 8), (4097, 8), (1, 8), (529, 8),
                                 (1585, 3), (4225, 1), (40, 33), (7, 100)])
def test_forest_vote_geometry(B, T):
    """Every lane group has a pair where the batch allows it, at least two
    blocks on each of 132 SMs, the labels within 48 KB; at the zoo's B
    4096, 2 packets a block, 2048 blocks of 128 threads."""
    g = vote_module.geometry(B, T)
    groups = g.threads // vote_module.LANES
    assert g.packets >= 1 and g.blocks == -(-B // g.packets)
    assert g.smem == g.packets * T * 4 <= 48 * 1024
    assert (g.packets - 1) * T < groups
    if B >= 2 * SMS * -(-groups // T):
        assert g.packets * T >= groups
    if g.packets > 1:
        assert g.blocks >= 2 * SMS
    if (B, T) == (4096, 8):
        assert (g.packets, g.blocks, g.threads) == (2, 2048, 128)


def test_forest_vote_geometry_refuses_no_trees():
    with pytest.raises(ValueError, match="tree"):
        vote_module.geometry(4, 0)


# ------------------------------- decode_attn: arrival counters per stream
def test_decode_attn_counters_are_kept_per_device_and_stream(monkeypatch):
    """Distinct (device, stream) keys get distinct zeroed counters, the
    same key the same tensor; growing one key's counters leaves the other
    keys' tensors as they were."""
    monkeypatch.setattr(attn_module, "_COUNTERS", {})
    cpu = torch.device("cpu")
    a = attn_module._counters(cpu, 11, 5)
    b = attn_module._counters(cpu, 22, 5)
    assert a is not b and a.data_ptr() != b.data_ptr()
    for c in (a, b):
        assert c.dtype == torch.int32 and c.numel() >= 5 and not c.any()
    assert attn_module._counters(cpu, 11, 7) is a
    assert attn_module._counters(torch.device("meta"), 11, 5) is not a
    big = attn_module._counters(cpu, 22, a.numel() + 1)
    assert big is not b and big.numel() > a.numel() and not big.any()
    assert attn_module._counters(cpu, 22, 3) is big
    assert attn_module._counters(cpu, 11, 3) is a
    assert set(attn_module._COUNTERS) == {(cpu, 11), (cpu, 22),
                                          (torch.device("meta"), 11)}
