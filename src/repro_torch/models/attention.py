"""GQA attention: over a sequence (causal or not, with an optional sliding
window; single-shot, q-chunked, or key-chunked with an online softmax), and
single-token decode against a KV cache.

Port of ``src/repro/models/attention.py`` (``gqa_attention`` :19-110,
``decode_attention`` :113-149).  ``gqa_attention`` takes q [B, S, Hq, D],
k/v [B, T, Hkv, D] and folds the GQA group into the head axis with a
reshape (no materialized repeat); the chunk loops that JAX runs with
``lax.scan`` are Python loops.  Its options are the reference's:
``causal=False`` (whisper's encoder and cross attention), ``window`` (the
hybrid family's local attention: a query at position p sees keys in
(p - window, p]) in both the single-shot and the online block, and
``q_offset`` (the queries' first position).

``decode_attention`` goes through ``kernels.ops.decode_attn``: the CUDA
kernel for CUDA tensors (one launch per call), the twin for CPU ones.  Its
``window`` is accepted and has no effect, as in the reference (which never
reads it): the local attention's ring buffer lives in the caller's cache,
``T = min(window, cache_len)`` slots written at ``pos % T``
(``transformer._decode_attn_layer``), so once warm every slot is valid and
``kv_len = min(pos + 1, T)`` covers them.  Where JAX's jnp
``decode_attention`` returns the mean of V for a row with ``kv_len = 0``
(a softmax over all ``-1e30``), the port returns zeros, as the TPU kernel
does; the decode step always has ``kv_len >= 1``.  ``mxu_native`` (bf16
operands into the matmuls) is not ported: its one user is the dry run's
overrides, which come with the dry run (Queue 1 item 9c).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

__all__ = ["gqa_attention", "decode_attention"]

_NEG = -1e30


def _causal(S: int, T: int, q_start: int, k_start: int, window: int,
            device) -> torch.Tensor:
    """Causal (+ optional sliding window) mask [S, T]: query i sits at
    position q_start + i, key j at k_start + j."""
    qpos = q_start + torch.arange(S, device=device)[:, None]
    kpos = k_start + torch.arange(T, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


def gqa_attention(
    q: torch.Tensor,         # [B, S, Hq, D]
    k: torch.Tensor,         # [B, T, Hkv, D]
    v: torch.Tensor,         # [B, T, Hkv, D]
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    q_chunk: int = 0,        # 0 = single-shot; >0 = loop over query chunks
    k_chunk: int = 0,        # >0 = online softmax over key chunks ("flash")
) -> torch.Tensor:
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    qg = q.reshape(B, S, Hkv, G, D)
    kf, vf = k.float(), v.float()

    def block(q_blk, start):
        # q_blk [B, s, Hkv, G, D] -> out [B, s, Hkv, G, D]
        logits = torch.einsum("bshgd,bthd->bhgst", q_blk.float(), kf) * scale
        if causal:
            m = _causal(q_blk.shape[1], T, start, 0, window, q.device)
            logits = torch.where(m, logits, _NEG)
        p = torch.softmax(logits, dim=-1)
        return torch.einsum("bhgst,bthd->bshgd", p, vf)

    def block_online(q_blk, start):
        """Running (max, denominator, accumulator) over key chunks: the
        [s, T] logits never exist as one tensor."""
        s = q_blk.shape[1]
        qf = q_blk.float()
        m = torch.full((B, Hkv, G, s), _NEG, device=q.device)
        den = torch.zeros((B, Hkv, G, s), device=q.device)
        acc = torch.zeros((B, s, Hkv, G, D), device=q.device)
        for j in range(T // k_chunk):
            k_b = kf[:, j * k_chunk:(j + 1) * k_chunk]
            v_b = vf[:, j * k_chunk:(j + 1) * k_chunk]
            logits = torch.einsum("bshgd,bthd->bhgst", qf, k_b) * scale
            if causal:
                msk = _causal(s, k_chunk, start, j * k_chunk, window,
                              q.device)
                logits = torch.where(msk, logits, _NEG)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            den = den * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhgst,bthd->bshgd", p, v_b)
            acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        return acc / den.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]

    blk = block_online if (k_chunk and T % k_chunk == 0) else block
    if q_chunk and S > q_chunk and S % q_chunk == 0:
        out = torch.cat([blk(qg[:, i:i + q_chunk], q_offset + i)
                         for i in range(0, S, q_chunk)], dim=1)
    else:
        out = blk(qg, q_offset)
    return out.reshape(B, S, Hq, D).to(q.dtype)


def decode_attention(
    q: torch.Tensor,        # [B, 1, Hq, D]
    k_cache: torch.Tensor,  # [B, T, Hkv, D]
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,   # int32 [B] — valid entries (new token written)
    *,
    window: int = 0,
    mxu_native: bool = False,
    mode: str | None = None,
) -> torch.Tensor:
    """One-token GQA decode through ``ops.decode_attn`` (``mode``: None
    follows the device, ``"cuda"`` the kernel, ``"ref"`` the twin).
    ``window`` has no effect, as in the reference: a ring-buffer cache is
    the caller's (see the module's docstring)."""
    if mxu_native:
        raise NotImplementedError("attn_mxu_native is not ported yet "
                                  "(ROADMAP.md Queue 1 item 9c, with the "
                                  "dry run)")
    B, _, Hq, D = q.shape
    out = ops.decode_attn(q.reshape(B, Hq, D), k_cache, v_cache, kv_len,
                          mode=mode)
    return out.reshape(B, 1, Hq, D)
