"""GQA decode attention (one new token against a ``kv_len``-masked KV
cache) in one launch: the LM decode step's attention, once per layer.

Replaces the Pallas TPU kernel ``decode_attn_pallas``
(``src/repro/kernels/decode_attn.py:82``).  The kernel is CUDA C++ in
``csrc/decode_attn.cu``; the note at its top says what bounds it on an H100
and what its design does about that.  This module holds:

* ``decode_attn`` — the wrapper.  On CUDA tensors it launches the kernel or
  raises; on CPU tensors it runs ``decode_attn_plain``.
  ``decode_attn.launches`` counts launches.
* ``decode_attn_plain`` — the kernel's plain torch version on the same
  operands, the twin ``ref.decode_attn``.

The scale ``D ** -0.5`` goes to the kernel as a C ``float`` argument.  Like
the TPU kernel, a row with ``kv_len <= 0`` gives zeros; ``kv_len`` past the
cache length reads the whole cache.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.launch import check, launch, on_card

__all__ = ["decode_attn", "decode_attn_plain", "HEAD_DIMS", "SOURCE"]

SOURCE = "decode_attn"           # csrc/decode_attn.cu
HEAD_DIMS = (16, 32, 64, 128)    # the kernel's instantiations
_DTYPES = {torch.bfloat16: 1, torch.float32: 0}
_ALIGN = 16                      # bytes: the kernel's widest vector load


def decode_attn_plain(q, k, v, kv_len):
    """The kernel's function in plain torch, on the kernel's operands."""
    return ref.decode_attn(q, k, v, kv_len)


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_len: torch.Tensor) -> torch.Tensor:
    """Attention of q [B, Hq, D] over the cache k/v [B, S, Hkv, D] (all
    bfloat16 or all float32, contiguous), row b over its first
    ``kv_len[b]`` positions (int32 [B]); query head h reads KV head
    ``h // (Hq // Hkv)``.  Returns [B, Hq, D] in q's dtype."""
    if not on_card("decode_attn", q=q, k=k, v=v, kv_len=kv_len):
        return decode_attn_plain(q, k, v, kv_len)
    if q.dtype not in _DTYPES:
        raise TypeError(f"q: dtype {q.dtype}, kernel takes bfloat16 or "
                        "float32")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be [B, Hq, D] and k "
                         f"{tuple(k.shape)} [B, S, Hkv, D]")
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernel takes {HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv} KV "
                         "heads")
    for name, x, dtype, shape in (
            ("q", q, q.dtype, (B, Hq, D)),
            ("k", k, q.dtype, (B, S, Hkv, D)),
            ("v", v, q.dtype, (B, S, Hkv, D)),
            ("kv_len", kv_len, torch.int32, (B,))):
        check(name, x, dtype, shape)
    out = torch.empty_like(q)
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.data_ptr() % _ALIGN:
            raise ValueError(f"{name} is not {_ALIGN}-byte aligned")
    if B == 0:
        return out
    launch(SOURCE, "acorn_decode_attn", q.device, q, k, v, kv_len, out, B, S,
           Hq, Hkv, D, _DTYPES[q.dtype], D ** -0.5)
    decode_attn.launches += 1
    return out


decode_attn.launches = 0
