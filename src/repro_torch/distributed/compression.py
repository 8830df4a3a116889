"""Int8 gradient compression with error feedback for the cross-pod axis.

Port of ``src/repro/distributed/compression.py``.  Quantizing a slow
link's gradient reduction to int8 cuts its wire traffic 2x against bf16 and
4x against f32; *error feedback* (Seide et al. 2014; Karimireddy et al.
2019) keeps the quantization residual locally and adds it back the next
step, so the long-run average of what is sent is the true gradient.

Chunks of 256 elements each carry a float32 max-abs scale beside the int8
payload (~1.016 bytes an element on the wire).  ``torch.round`` rounds
half to even, as ``jnp.round`` does.  Trees are dicts of tensors (nested
dicts allowed), mapped leaf by leaf.

Usage (train loop, cross-pod axis only):
    g_pod, ef = compress_decompress(g_local, ef)   # local error feedback
    # then the all-reduce of g_pod over the slow axis
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["quantize_int8", "dequantize_int8", "compress_decompress",
           "init_error_feedback"]

_CHUNK = 256


def _pad_flat(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1).float()
    return F.pad(flat, (0, (-flat.shape[0]) % _CHUNK)), flat.shape[0]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [...] -> (q int8 [n_pad / CHUNK, CHUNK], scale f32 [n_pad / CHUNK])
    with per-chunk max-abs scaling."""
    flat, _ = _pad_flat(x)
    chunks = flat.reshape(-1, _CHUNK)
    scale = chunks.abs().amax(dim=1) / 127.0
    q = torch.round(chunks / torch.clamp(scale, min=1e-30)[:, None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    n: int) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)[:n]
    return flat.reshape(shape)


def init_error_feedback(tree):
    if isinstance(tree, dict):
        return {k: init_error_feedback(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def compress_decompress(grads, error_feedback):
    """Per leaf: q(g + ef), with the residual carried to the next step.

    Returns (int8-fidelity grads, new error feedback).  Apply *before* the
    cross-pod reduction; the compressed values are what the slow link
    carries."""
    if isinstance(grads, dict):
        pairs = {k: compress_decompress(g, error_feedback[k])
                 for k, g in grads.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    g32 = grads.float() + error_feedback
    q, s = quantize_int8(g32)
    deq = dequantize_int8(q, s, grads.shape, grads.numel())
    return deq.to(grads.dtype), g32 - deq
