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
order, held bit for bit to the twins with sums that wrap past 2^31.  All
of these are integer results, so every comparison is exact.

The geometry functions (``decode_attn.plan``,
``classify_fused.packets_per_block``, ``tcam_match.geometry``,
``svm_lookup.geometry``) are plain Python: at the timed shapes the grid
holds at least two blocks (or waves) on each of 132 SMs, the last round of
blocks fills at least half the SMs, no span starts past the cache, shared
memory stays within what a block may take (227 KB, 48 KB for the fused
classify kernel's static limit; the two staged kernels take none), and an
H above the SVM kernel's maximum is refused.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.packets import u32_bits, u32_from_bits
from repro_torch.kernels import ref as tref
from repro_torch.kernels import svm_lookup as svm_module
from repro_torch.kernels import tcam_match as tcam_module
from repro_torch.kernels import tiling
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
@pytest.mark.parametrize("D", [16, 32, 64, 128])
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
                                     (100_000, 8, 60, 32)])
def test_classify_packets_per_block(B, T, F, L):
    """The classify kernel's blocks: feature rows, labels, vid and row
    lengths within 48 KB, no more packets than give each warp its (packet,
    tree) walks, and at the zoo's B 4096 a grid of at least two blocks on
    each of 132 SMs."""
    pb = packets_per_block(T, F, B, L=L)
    assert 1 <= pb <= packets_per_block(T, F, L=L)
    assert (pb * (F + T + 1 + L * T) + L) * 4 <= 48 * 1024
    assert (pb - 1) * T < cf_module.WALK_WARPS * cf_module.WALKS_PER_WARP
    if B >= 4096:
        assert -(-B // pb) >= 2 * SMS


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
