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

The geometry functions (``decode_attn.plan``,
``classify_fused.packets_per_block``) are plain Python: at the timed shapes
the grid holds at least two waves of 132 SMs, no span starts past the
cache, and shared memory stays within what a block may take (227 KB, 48 KB
for the classify kernel's static limit).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tiling
from repro_torch.kernels import classify_fused as cf_module
from repro_torch.kernels.classify_fused import packets_per_block
from repro_torch.kernels.decode_attn import (
    SMEM_PER_BLOCK,
    SMS,
    decode_attn,
    plan,
)

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

