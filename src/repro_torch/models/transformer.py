"""The decoder-only LM of the dense family (GQA + SwiGLU): internlm2-1.8b,
internlm2-20b, starcoder2-15b, granite-20b and chameleon-34b's backbone.

Port of the dense branches of ``src/repro/models/transformer.py``:
``init_params`` (:108, dense :117), ``init_decode_state`` (:359),
``_attn_block`` (:197), ``_mlp_block`` (:212), ``_dense_layer`` (:217),
``forward`` (:269, dense :285), ``_decode_attn_layer`` (:408) and
``decode_step`` (:426, dense :440).

The weights are an ``nn.Module`` (``DenseLM``: ``embed``, ``head``,
``ln_f`` and a ``ModuleList`` of ``DenseBlock``), each weight in the JAX
package's layout and dtype (``x @ w``; norms in float32).  The steps are
plain functions on it, with the JAX package's signatures; the layer loop
that JAX scans is a Python loop.  Serving only: every parameter has
``requires_grad=False`` (the train step is a later slice).

Two differences from JAX, both in place of a copy:

* ``decode_step`` writes the new token's K/V into the cache tensors of
  ``state`` in place and returns the same dict;
* a tenant swap writes new weights into the same parameter tensors
  (``DenseLM.init_``, ``DenseLM.load_``).

The other families (moe, hybrid, rwkv, encdec) raise
``NotImplementedError`` (ROADMAP.md Queue 1 item 9).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.attention import decode_attention, gqa_attention
from repro_torch.models.common import (
    ArchConfig,
    apply_rope,
    dense_init,
    rms_norm,
    rope,
)

__all__ = [
    "DenseBlock",
    "DenseLM",
    "init_params",
    "init_params_shape",
    "params_from_numpy",
    "forward",
    "decode_step",
    "init_decode_state",
    "DEFAULT_DEVICE",
]

# Entry points run on the card unless the caller asks for the CPU.
DEFAULT_DEVICE = torch.device("cuda")


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; the "
            "port runs the dense family (ROADMAP.md Queue 1 item 9)")


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class DenseBlock(nn.Module):
    """One dense layer's weights: the two norms and the attention and MLP
    projections."""

    def __init__(self, cfg: ArchConfig, device) -> None:
        super().__init__()
        D, hd, F_, dt = cfg.d_model, cfg.hd, cfg.d_ff, cfg.tdtype
        self.ln1 = _weight((D,), torch.float32, device)
        self.ln2 = _weight((D,), torch.float32, device)
        self.wq = _weight((D, cfg.n_heads * hd), dt, device)
        self.wk = _weight((D, cfg.n_kv * hd), dt, device)
        self.wv = _weight((D, cfg.n_kv * hd), dt, device)
        self.wo = _weight((cfg.n_heads * hd, D), dt, device)
        self.wg = _weight((D, F_), dt, device)
        self.wu = _weight((D, F_), dt, device)
        self.wd = _weight((F_, D), dt, device)


class DenseLM(nn.Module):
    """The weights of one dense LM, allocated (not initialised) on
    ``device``; fill them with ``init_`` or ``load_``."""

    def __init__(self, cfg: ArchConfig, *, device=None) -> None:
        super().__init__()
        _dense_only(cfg)
        device = DEFAULT_DEVICE if device is None else torch.device(device)
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab
        self.embed = _weight((V, D), cfg.tdtype, device)
        self.head = _weight((D, V), cfg.tdtype, device)
        self.ln_f = _weight((D,), torch.float32, device)
        self.layers = nn.ModuleList(DenseBlock(cfg, device)
                                    for _ in range(cfg.n_layers))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "DenseLM":
        """Random weights from ``generator``, written in place: norms 0,
        the embedding N(0, 0.02^2), every projection N(0, 1 / fan_in)."""
        for name, p in self.named_parameters():
            if name.rsplit(".", 1)[-1].startswith("ln"):
                p.zero_()
            else:
                p.copy_(dense_init(generator, p.shape, p.dtype,
                                   scale=0.02 if name == "embed" else None))
        return self

    @torch.no_grad()
    def load_(self, tree: dict) -> "DenseLM":
        """Copy a JAX param tree (``init_params``'s dict, as numpy arrays;
        ``layers`` stacked ``[L, ...]``) into the weights in place.
        bfloat16 arrays (``ml_dtypes``) cross as float32, losslessly."""
        for name, p in self.named_parameters():
            parts = name.split(".")
            a = (tree[name] if len(parts) == 1
                 else tree["layers"][parts[2]][int(parts[1])])
            a = np.asarray(a)
            if a.shape != tuple(p.shape):
                raise ValueError(f"{name}: array {a.shape}, weight "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(a.astype(np.float32)))
        return self


def init_params(cfg: ArchConfig, generator: torch.Generator, *,
                device=None) -> DenseLM:
    """A ``DenseLM`` on ``device`` (``cuda`` by default) with random
    weights drawn on ``generator``'s device."""
    return DenseLM(cfg, device=device).init_(generator)


def init_params_shape(cfg: ArchConfig) -> DenseLM:
    """The weights' shapes and dtypes with no memory (``meta`` tensors)."""
    return DenseLM(cfg, device="meta")


def params_from_numpy(tree: dict, cfg: ArchConfig, *, device=None) -> DenseLM:
    """A ``DenseLM`` holding the JAX package's weights ``tree`` (numpy)."""
    return DenseLM(cfg, device=device).load_(tree)


# --------------------------------------------------------------------------
# Blocks (sequence forward)
# --------------------------------------------------------------------------
def _attn_block(x, lp: DenseBlock, cfg: ArchConfig, sin, cos, *, q_chunk=0):
    B, S, _ = x.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv
    q = (x @ lp.wq).reshape(B, S, Hq, hd)
    k = (x @ lp.wk).reshape(B, S, Hkv, hd)
    v = (x @ lp.wv).reshape(B, S, Hkv, hd)
    q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    o = gqa_attention(q, k, v, q_chunk=q_chunk,
                      k_chunk=cfg.attn_k_chunk)
    return o.reshape(B, S, Hq * hd) @ lp.wo


def _mlp_block(x, lp: DenseBlock):
    return (F.silu(x @ lp.wg) * (x @ lp.wu)) @ lp.wd


def _dense_layer(x, lp: DenseBlock, cfg: ArchConfig, sin, cos, q_chunk):
    h = x + _attn_block(rms_norm(x, lp.ln1), lp, cfg, sin, cos,
                        q_chunk=q_chunk)
    return h + _mlp_block(rms_norm(h, lp.ln2), lp)


def forward(params: DenseLM, tokens: torch.Tensor, cfg: ArchConfig, *,
            q_chunk: int = 0) -> torch.Tensor:
    """Logits [B, S, V] of tokens int [B, S] under causal attention."""
    _dense_only(cfg)
    S = tokens.shape[1]
    x = params.embed[tokens.long()]
    sin, cos = rope(torch.arange(S, device=x.device), cfg.hd, cfg.rope_theta)
    sin, cos = sin[None], cos[None]
    for lp in params.layers:
        x = _dense_layer(x, lp, cfg, sin, cos, q_chunk)
    return rms_norm(x, params.ln_f) @ params.head


# --------------------------------------------------------------------------
# Decode (one token against the KV cache)
# --------------------------------------------------------------------------
def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int, *,
                      device=None) -> dict:
    """Zero K/V caches ``{"k", "v"}`` of [L, batch, cache_len, Hkv, hd] in
    the config's dtype on ``device`` (``cuda`` by default); layer l's
    cache ``state["k"][l]`` is contiguous."""
    _dense_only(cfg)
    device = DEFAULT_DEVICE if device is None else torch.device(device)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.tdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.tdtype, device=device)}


def _decode_attn_layer(x, lp: DenseBlock, cache_k, cache_v, slot: int,
                       kv_len, cfg: ArchConfig, sin, cos, *, mode=None):
    B = x.shape[0]
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv
    q = (x @ lp.wq).reshape(B, 1, Hq, hd)
    k = (x @ lp.wk).reshape(B, 1, Hkv, hd)
    v = (x @ lp.wv).reshape(B, 1, Hkv, hd)
    q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    o = decode_attention(q, cache_k, cache_v, kv_len,
                         mxu_native=cfg.attn_mxu_native, mode=mode)
    return o.reshape(B, 1, Hq * hd) @ lp.wo


def decode_step(params: DenseLM, state: dict, tokens: torch.Tensor, pos: int,
                cfg: ArchConfig, *, mode: str | None = None):
    """One token per sequence, tokens int [B, 1] at position ``pos``:
    returns (logits [B, 1, V], state), the caches of ``state`` written in
    place at slot ``min(pos, T - 1)``.  ``mode`` picks the attention:
    None follows the device, ``"cuda"`` the kernel, ``"ref"`` the twin."""
    _dense_only(cfg)
    x = params.embed[tokens.long()]
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    sin, cos = rope(positions, cfg.hd, cfg.rope_theta)
    sin, cos = sin[None], cos[None]
    T = state["k"].shape[2]
    kv_len = torch.full((x.shape[0],), min(pos + 1, T), dtype=torch.int32,
                        device=x.device)
    for lp, ck, cv in zip(params.layers, state["k"], state["v"]):
        h = x + _decode_attn_layer(rms_norm(x, lp.ln1), lp, ck, cv,
                                   min(pos, T - 1), kv_len, cfg, sin, cos,
                                   mode=mode)
        x = h + _mlp_block(rms_norm(h, lp.ln2), lp)
    return rms_norm(x, params.ln_f) @ params.head, state
