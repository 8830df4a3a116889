"""The LM of the five block families, one ``nn.Module`` tree each:

  dense   — GQA + SwiGLU (internlm2*, starcoder2, granite, chameleon's
            backbone): ``DenseLM``
  moe     — GQA + capacity-dispatch MoE (grok-1, qwen3-moe): ``MoELM``
  hybrid  — RecurrentGemma: (RG-LRU, RG-LRU, local attention) superblocks
            and a tail of RG-LRU layers: ``HybridLM``
  rwkv    — RWKV-6 time mix + channel mix: ``RWKVLM``
  encdec  — whisper's backbone: an encoder over stub frame embeddings and
            a decoder with self and cross attention: ``EncDecLM``

Port of ``src/repro/models/transformer.py``: ``init_params`` (:108-186),
``init_params_shape`` (:189), the blocks (:197-264), ``forward``
(:269-325), ``_encode`` (:328), ``encode_kv`` (:341), ``init_decode_state``
(:359-404), ``_decode_attn_layer`` (:408) and ``decode_step`` (:426-531).

Each weight lies in the JAX package's layout and dtype (``x @ w``; norms,
the router, the RG-LRU gates and RWKV's decay and mixes in float32); where
JAX stacks a family's layers on a leading axis, the port holds a
``ModuleList`` of blocks, and the layer loop that JAX scans is a Python
loop.  Every module reads its weights by ``lp["name"]`` as well as by
attribute, so the family functions (``moe``, ``rglru``, ``rwkv``) take a
block or a dict of tensors alike.  The weights are made with
``requires_grad=False`` for serving; ``LM.trainable_()`` turns it on for
the train step (``repro_torch.train.step``), and ``init_`` and ``load_``
write them under ``no_grad`` either way.  ``forward(..., remat=True)`` runs
each layer (superblock, tail layer, encoder layer) under
``torch.utils.checkpoint``, as the reference's ``_scan`` wraps each
scanned body in ``jax.checkpoint`` (:259-265): backward recomputes one
layer at a time.  ``LM.tree()`` gives the weights back as the JAX package's
tree (``tree_of``: layers stacked on a leading axis), the inverse of
``load_``.

Differences from JAX, each in place of a copy:

* ``decode_step`` writes the new token's K/V and every recurrent state of
  ``state`` in place and returns the same dict;
* a tenant swap writes new weights into the same parameter tensors
  (``LM.init_``, ``LM.load_``).

The hybrid family's local attention decodes over a ring buffer of ``T =
min(window, cache_len)`` slots, the new token written at ``pos % T``, as
the reference does (``transformer.py:371``, ``:418``).

On DTensors (the dry run's sharded step, ``launch/dryrun.py``) the
embedding lookup, the heads' split and merge, the residual stream's
layout and the cache writes go through ``distributed.dtensor``; on plain
tensors each of those hooks is the plain op.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import dtensor as _dt
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.attention import decode_attention, gqa_attention
from repro_torch.models.common import (
    ArchConfig,
    apply_rope,
    dense_init,
    rms_norm,
    rope,
)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.rglru import recurrent_block, recurrent_block_step

__all__ = [
    "LM",
    "DenseLM",
    "MoELM",
    "HybridLM",
    "RWKVLM",
    "EncDecLM",
    "new_model",
    "init_params",
    "init_params_shape",
    "params_from_numpy",
    "forward",
    "encode_kv",
    "decode_step",
    "init_decode_state",
    "state_items",
    "leaf_of",
    "tree_of",
    "tree_path",
    "DEFAULT_DEVICE",
]

# Entry points run on the card unless the caller asks for the CPU.
DEFAULT_DEVICE = torch.device("cuda")


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Params(nn.Module):
    """A module of weights whose entries also read as ``p["name"]``."""

    def __getitem__(self, name: str):
        return getattr(self, name)

    def add(self, **weights) -> "Params":
        for name, w in weights.items():
            if isinstance(w, nn.Module):
                self.add_module(name, w)
            else:
                self.register_parameter(name, w)
        return self


def _attn(cfg: ArchConfig, device, prefix: str = "w") -> dict:
    D, hd, dt = cfg.d_model, cfg.hd, cfg.tdtype
    return {prefix + "q": _weight((D, cfg.n_heads * hd), dt, device),
            prefix + "k": _weight((D, cfg.n_kv * hd), dt, device),
            prefix + "v": _weight((D, cfg.n_kv * hd), dt, device),
            prefix + "o": _weight((cfg.n_heads * hd, D), dt, device)}


def _mlp(cfg: ArchConfig, device) -> dict:
    D, F_, dt = cfg.d_model, cfg.d_ff, cfg.tdtype
    return {"wg": _weight((D, F_), dt, device),
            "wu": _weight((D, F_), dt, device),
            "wd": _weight((F_, D), dt, device)}


def _norms(cfg: ArchConfig, device, *names) -> dict:
    return {n: _weight((cfg.d_model,), torch.float32, device) for n in names}


def _rec(cfg: ArchConfig, device) -> Params:
    """One RG-LRU block (``_rec_params``, transformer.py:64)."""
    D, R, W, dt = cfg.d_model, cfg.lru_dim, cfg.conv_width, cfg.tdtype
    f32 = torch.float32
    lru = Params().add(wa=_weight((R, R), f32, device),
                       ba=_weight((R,), f32, device),
                       wi=_weight((R, R), f32, device),
                       bi=_weight((R,), f32, device),
                       lam=_weight((R,), f32, device))
    return Params().add(w_gate=_weight((D, R), dt, device),
                        w_in=_weight((D, R), dt, device),
                        w_out=_weight((R, D), dt, device),
                        conv_w=_weight((W, R), f32, device), lru=lru)


def _rwkv(cfg: ArchConfig, device) -> dict:
    """One RWKV-6 layer's time and channel mix (``_rwkv_params``,
    transformer.py:82)."""
    D, F_, dt, f32 = cfg.d_model, cfg.d_ff, cfg.tdtype, torch.float32
    H = _rwkv_heads(cfg)
    K = D // H
    lora = max(D // 16, 32)
    p = {n: _weight((D, D), dt, device)
         for n in ("wr", "wk", "wv", "wg", "wo", "cr")}
    p.update(w_lora_a=_weight((D, lora), dt, device),
             w_lora_b=_weight((lora, D), dt, device),
             w_base=_weight((D,), f32, device), u=_weight((D,), f32, device),
             ln_x_w=_weight((H, K), f32, device),
             ln_x_b=_weight((H, K), f32, device),
             ck=_weight((D, F_), dt, device), cv=_weight((F_, D), dt, device))
    for name in ("r", "k", "v", "g", "w", "cr", "ck"):
        p[f"mu_{name}"] = _weight((D,), f32, device)
    return p


def _rwkv_heads(cfg: ArchConfig) -> int:
    return cfg.n_heads if cfg.n_heads else cfg.d_model // 64


# how ``init_params`` fills a weight, by its own name: a constant, the
# RG-LRU's lam ramp, or normal draws at a scale (None: fan_in ** -0.5)
_CONST = {"ba": 0.0, "bi": 0.0, "w_base": 0.5, "ln_x_w": 1.0, "ln_x_b": 0.0}
_SCALE = {"embed": 0.02, "enc_pos": 0.02, "conv_w": 0.3, "w_lora_b": 0.01,
          "u": 0.5}


def tree_path(name: str) -> tuple[tuple[str, ...], int | None]:
    """A parameter's name in the port (``layers.3.wq``, ``super.0.mlp1.wg``)
    -> (its leaf's path in the JAX package's tree, ``("layers", "wq")``;
    its index on that leaf's stacked layer axis, or None)."""
    path, layer = [], None
    for part in name.split("."):
        if part.isdigit():
            layer = int(part)
        else:
            path.append(part)
    return tuple(path), layer


def tree_of(named) -> dict:
    """(name, tensor) pairs of the port's parameters (or of tensors keyed
    like them: the optimizer's moments) -> the JAX package's nested dict of
    numpy arrays, each family's layers stacked on a leading axis as
    ``init_params`` lays them out.  Every array is a copy on the host;
    bfloat16 goes out as float32, losslessly (numpy has no bfloat16)."""
    leaves: dict[tuple, dict] = {}
    for name, t in named:
        path, layer = tree_path(name)
        a = t.detach().to("cpu", copy=True)
        leaves.setdefault(path, {})[layer] = (
            a.float() if a.dtype == torch.bfloat16 else a).numpy()
    tree: dict = {}
    for path, by_layer in leaves.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = (by_layer[None] if None in by_layer else
                          np.stack([by_layer[i] for i in sorted(by_layer)]))
    return tree


def leaf_of(tree: dict, name: str) -> np.ndarray:
    """The JAX tree's array for the port's parameter ``name`` (its layer's
    slice of a stacked leaf)."""
    path, layer = tree_path(name)
    node = tree
    for k in path:
        node = node[k]
    return np.asarray(node if layer is None else node[layer])


class LM(Params):
    """The weights of one LM, allocated (not initialised) on ``device``;
    fill them with ``init_`` or ``load_``.  Each family's subclass adds its
    tree in ``build(cfg, device)``."""

    family = ""

    def __init__(self, cfg: ArchConfig, *, device=None) -> None:
        super().__init__()
        if cfg.family != self.family:
            raise ValueError(f"{cfg.name} is of the {cfg.family} family, not "
                             f"{self.family}: use new_model(cfg)")
        device = DEFAULT_DEVICE if device is None else torch.device(device)
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab
        self.add(embed=_weight((V, D), cfg.tdtype, device),
                 head=_weight((D, V), cfg.tdtype, device),
                 ln_f=_weight((D,), torch.float32, device))
        self.build(cfg, device)

    @staticmethod
    def _stack(n: int, make) -> nn.ModuleList:
        return nn.ModuleList(make() for _ in range(n))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "LM":
        """Random weights from ``generator``, written in place, with the
        reference's distributions: norms 0, the embedding (and the
        encoder's positions) N(0, 0.02^2), every projection N(0, 1 /
        fan_in), and the family's constants (the RG-LRU's biases 0 and
        ``lam`` from 0.5 to 4, RWKV's mixes and decay base 0.5, its group
        norm 1 and 0)."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _CONST:
                p.fill_(_CONST[leaf])
            elif leaf.startswith("mu_"):
                p.fill_(0.5)
            elif leaf == "lam":
                p.copy_(torch.linspace(0.5, 4.0, p.shape[0]))
            elif leaf.startswith("ln"):
                p.zero_()
            else:
                p.copy_(dense_init(generator, p.shape, p.dtype,
                                   scale=_SCALE.get(leaf)))
        return self

    @torch.no_grad()
    def load_(self, tree: dict) -> "LM":
        """Copy a JAX param tree (``init_params``'s dict, as numpy arrays;
        stacked layers ``[L, ...]``) into the weights in place.  bfloat16
        arrays (``ml_dtypes``) cross as float32, losslessly."""
        for name, p in self.named_parameters():
            a = leaf_of(tree, name)
            if a.shape != tuple(p.shape):
                raise ValueError(f"{name}: array {a.shape}, weight "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(a.astype(np.float32)))
        return self

    def tree(self) -> dict:
        """The weights as the JAX package's parameter tree (numpy, on the
        host; bfloat16 as float32): the inverse of ``load_``."""
        return tree_of(self.named_parameters())

    def trainable_(self, flag: bool = True) -> "LM":
        """Turn ``requires_grad`` on (the train step) or off (serving) for
        every weight, in place."""
        for p in self.parameters():
            p.requires_grad_(flag)
        return self


class DenseLM(LM):
    """``embed``, ``head``, ``ln_f`` and ``layers``: norms, attention and
    MLP per layer."""

    family = "dense"

    def build(self, cfg, device):
        self.layers = self._stack(cfg.n_layers, lambda: Params().add(
            **_norms(cfg, device, "ln1", "ln2"), **_attn(cfg, device),
            **_mlp(cfg, device)))


class MoELM(LM):
    """``layers``: norms, attention, the router [D, E] (f32) and the
    experts wg/wu [E, D, F], wd [E, F, D]."""

    family = "moe"

    def build(self, cfg, device):
        D, E, F_, dt = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.tdtype

        def layer():
            return Params().add(
                **_norms(cfg, device, "ln1", "ln2"), **_attn(cfg, device),
                router=_weight((D, E), torch.float32, device),
                wg=_weight((E, D, F_), dt, device),
                wu=_weight((E, D, F_), dt, device),
                wd=_weight((E, F_, D), dt, device))

        self.layers = self._stack(cfg.n_layers, layer)


class HybridLM(LM):
    """``super``: ``n_layers // 3`` (RG-LRU, RG-LRU, local attention)
    superblocks, each with an MLP after every block; ``tail``: the last
    ``n_layers % 3`` RG-LRU layers (absent when there are none)."""

    family = "hybrid"

    def build(self, cfg, device):
        n_super, n_tail = cfg.n_layers // 3, cfg.n_layers % 3
        self.super = self._stack(n_super, lambda: Params().add(
            **_norms(cfg, device, "ln_r1", "ln_r2", "ln_a", "ln_m1",
                     "ln_m2", "ln_m3"),
            rec1=_rec(cfg, device), rec2=_rec(cfg, device),
            **_attn(cfg, device),
            mlp1=Params().add(**_mlp(cfg, device)),
            mlp2=Params().add(**_mlp(cfg, device)),
            mlp3=Params().add(**_mlp(cfg, device))))
        if n_tail:
            self.tail = self._stack(n_tail, lambda: Params().add(
                **_norms(cfg, device, "ln_r", "ln_m"), rec=_rec(cfg, device),
                mlp=Params().add(**_mlp(cfg, device))))


class RWKVLM(LM):
    """``layers``: two norms and RWKV-6's time and channel mix."""

    family = "rwkv"

    def build(self, cfg, device):
        self.layers = self._stack(cfg.n_layers, lambda: Params().add(
            **_norms(cfg, device, "ln1", "ln2"), **_rwkv(cfg, device)))


class EncDecLM(LM):
    """``enc_pos`` [enc_seq, D], ``enc_layers`` (dense layers without
    RoPE), ``ln_enc``; ``layers``: self attention, cross attention
    (``xq``, ``xk``, ``xv``, ``xo`` after the norm ``ln_x``) and MLP."""

    family = "encdec"

    def build(self, cfg, device):
        self.add(enc_pos=_weight((cfg.enc_seq, cfg.d_model), cfg.tdtype,
                                 device))
        self.enc_layers = self._stack(cfg.n_enc_layers, lambda: Params().add(
            **_norms(cfg, device, "ln1", "ln2"), **_attn(cfg, device),
            **_mlp(cfg, device)))
        self.add(ln_enc=_weight((cfg.d_model,), torch.float32, device))
        self.layers = self._stack(cfg.n_layers, lambda: Params().add(
            **_norms(cfg, device, "ln1", "ln_x", "ln2"), **_attn(cfg, device),
            **_attn(cfg, device, prefix="x"), **_mlp(cfg, device)))


_FAMILIES = {c.family: c for c in (DenseLM, MoELM, HybridLM, RWKVLM,
                                   EncDecLM)}


def new_model(cfg: ArchConfig, *, device=None) -> LM:
    """The family's ``LM`` for ``cfg``, allocated on ``device`` (``cuda``
    by default), not initialised."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _FAMILIES[cfg.family](cfg, device=device)


def init_params(cfg: ArchConfig, generator: torch.Generator, *,
                device=None) -> LM:
    """The family's ``LM`` on ``device`` (``cuda`` by default) with random
    weights drawn on ``generator``'s device."""
    return new_model(cfg, device=device).init_(generator)


def init_params_shape(cfg: ArchConfig) -> LM:
    """The weights' shapes and dtypes with no memory (``meta`` tensors)."""
    return new_model(cfg, device="meta")


def params_from_numpy(tree: dict, cfg: ArchConfig, *, device=None) -> LM:
    """The family's ``LM`` holding the JAX package's weights ``tree``
    (numpy)."""
    return new_model(cfg, device=device).load_(tree)


# --------------------------------------------------------------------------
# Blocks (sequence forward)
# --------------------------------------------------------------------------
def _heads(t, B: int, S: int, H: int, hd: int):
    """A projection [B, S, H * hd] as heads [B, S, H, hd]; a DTensor is
    first split along whole heads, or made whole (``dtensor.heads``)."""
    return _dt.heads(t, H).reshape(B, S, H, hd)


def _attn_block(x, lp, cfg: ArchConfig, sin, cos, *, window=0, q_chunk=0,
                causal=True):
    B, S, _ = x.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv
    q = _heads(x @ lp["wq"], B, S, Hq, hd)
    k = _heads(x @ lp["wk"], B, S, Hkv, hd)
    v = _heads(x @ lp["wv"], B, S, Hkv, hd)
    if sin is not None:
        q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    o = gqa_attention(q, k, v, causal=causal, window=window, q_chunk=q_chunk,
                      k_chunk=cfg.attn_k_chunk)
    return _dt.residual(_dt.merge_heads(o) @ lp["wo"])


def _mlp_block(x, lp):
    return _dt.residual((F.silu(x @ lp["wg"]) * (x @ lp["wu"])) @ lp["wd"])


def _moe(x, lp, cfg: ArchConfig):
    y, _aux = moe_ffn(x, lp, top_k=cfg.top_k,
                      capacity_factor=cfg.capacity_factor, impl=cfg.moe_impl)
    return _dt.residual(y)


def _rec_block(x, rec):
    """One RG-LRU block over a sequence, from zero state."""
    return _dt.residual(recurrent_block(x, rec, None)[0])


def _hybrid_super(x, lp, cfg, sin, cos, q_chunk):
    x = x + _rec_block(rms_norm(x, lp["ln_r1"]), lp["rec1"])
    x = x + _mlp_block(rms_norm(x, lp["ln_m1"]), lp["mlp1"])
    x = x + _rec_block(rms_norm(x, lp["ln_r2"]), lp["rec2"])
    x = x + _mlp_block(rms_norm(x, lp["ln_m2"]), lp["mlp2"])
    x = x + _attn_block(rms_norm(x, lp["ln_a"]), lp, cfg, sin, cos,
                        window=cfg.window, q_chunk=q_chunk)
    return x + _mlp_block(rms_norm(x, lp["ln_m3"]), lp["mlp3"])


def _hybrid_tail(x, lp):
    x = x + _rec_block(rms_norm(x, lp["ln_r"]), lp["rec"])
    return x + _mlp_block(rms_norm(x, lp["ln_m"]), lp["mlp"])


def _rwkv_layer(x, lp, cfg):
    H = _rwkv_heads(cfg)
    x = x + _dt.residual(rwkv_mod.time_mix(rms_norm(x, lp["ln1"]), lp, None,
                                           n_heads=H)[0])
    return x + _dt.residual(
        rwkv_mod.channel_mix(rms_norm(x, lp["ln2"]), lp, None)[0])


def _cross(h, lp, cfg: ArchConfig, k, v, attend):
    """Cross attention of the decoder's h [B, S, D] over encoder K/V."""
    B, S, _ = h.shape
    q = _heads(rms_norm(h, lp["ln_x"]) @ lp["xq"], B, S, cfg.n_heads, cfg.hd)
    return _dt.residual(_dt.merge_heads(attend(q, k, v)) @ lp["xo"])


def _layer(fn, x, remat: bool):
    """``fn(x)``: one layer's body, under ``torch.utils.checkpoint`` when
    ``remat`` is on and autograd records (its activations recomputed in
    backward, the reference's ``jax.checkpoint`` of a scanned body)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


def _encode(params: LM, enc_inputs: torch.Tensor, cfg: ArchConfig, *,
            remat: bool = False):
    """Whisper's encoder over stub frame embeddings (the frontend is a
    stub): bidirectional attention, no RoPE."""
    def enc_layer(e, lp):
        e = e + _attn_block(rms_norm(e, lp["ln1"]), lp, cfg, None, None,
                            causal=False)
        return e + _mlp_block(rms_norm(e, lp["ln2"]), lp)

    e = enc_inputs + params["enc_pos"][None]
    for lp in params["enc_layers"]:
        e = _layer(lambda h, lp=lp: enc_layer(h, lp), e, remat)
    return rms_norm(e, params["ln_enc"])


def _decoder_layer(x, lp, cfg: ArchConfig, sin, cos, q_chunk, e):
    """One layer of the dense, moe and encdec families (``e`` the encoder's
    output for the encdec family's cross attention)."""
    B, S, _ = x.shape
    h = x + _attn_block(rms_norm(x, lp["ln1"]), lp, cfg, sin, cos,
                        q_chunk=q_chunk)
    if cfg.family == "encdec":
        Se = e.shape[1]
        k = _heads(e @ lp["xk"], B, Se, cfg.n_kv, cfg.hd)
        v = _heads(e @ lp["xv"], B, Se, cfg.n_kv, cfg.hd)
        h = h + _cross(h, lp, cfg, k, v, lambda q, k, v:
                       gqa_attention(q, k, v, causal=False))
    if cfg.family == "moe":
        return h + _moe(rms_norm(h, lp["ln2"]), lp, cfg)
    return h + _mlp_block(rms_norm(h, lp["ln2"]), lp)


def forward(params: LM, tokens: torch.Tensor, cfg: ArchConfig, *,
            enc_inputs: torch.Tensor | None = None, q_chunk: int = 0,
            remat: bool = True) -> torch.Tensor:
    """Logits [B, S, V] of tokens int [B, S]; the encdec family needs
    ``enc_inputs`` [B, enc_seq, D] (the stub frontend's output).  With
    ``remat`` each layer's activations are recomputed in backward instead
    of kept; the logits are the same either way."""
    B, S = tokens.shape
    x = _dt.residual(_dt.embed(params.embed, tokens))
    sin, cos = rope(torch.arange(S, device=x.device), cfg.hd, cfg.rope_theta)
    sin, cos = sin[None], cos[None]

    if cfg.family in ("dense", "moe", "encdec"):
        e = None
        if cfg.family == "encdec":
            if enc_inputs is None:
                raise ValueError("encdec needs enc_inputs (frontend stub "
                                 "output)")
            e = _encode(params, enc_inputs, cfg, remat=remat)
        for lp in params.layers:
            x = _layer(lambda h, lp=lp: _decoder_layer(
                h, lp, cfg, sin, cos, q_chunk, e), x, remat)
    elif cfg.family == "hybrid":
        for lp in params.super:
            x = _layer(lambda h, lp=lp: _hybrid_super(
                h, lp, cfg, sin, cos, q_chunk), x, remat)
        for lp in getattr(params, "tail", ()):
            x = _layer(lambda h, lp=lp: _hybrid_tail(h, lp), x, remat)
    elif cfg.family == "rwkv":
        for lp in params.layers:
            x = _layer(lambda h, lp=lp: _rwkv_layer(h, lp, cfg), x, remat)
    else:
        raise ValueError(cfg.family)
    return rms_norm(x, params.ln_f) @ params.head


def encode_kv(params: LM, enc_inputs: torch.Tensor, cfg: ArchConfig):
    """Every decoder layer's cross-attention K/V, [L, B, enc_seq, Hkv, hd]
    each (the decode-time state of the encdec family)."""
    e = _encode(params, enc_inputs, cfg)
    B, Se, _ = e.shape
    ks = torch.stack([(e @ lp["xk"]).reshape(B, Se, cfg.n_kv, cfg.hd)
                      for lp in params.layers])
    vs = torch.stack([(e @ lp["xv"]).reshape(B, Se, cfg.n_kv, cfg.hd)
                      for lp in params.layers])
    return ks, vs


# --------------------------------------------------------------------------
# Decode (one token against caches / recurrent state)
# --------------------------------------------------------------------------
def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int, *,
                      device=None) -> dict:
    """The family's zero decode state on ``device`` (``cuda`` by default),
    the reference's dict: K/V caches [L, batch, cache_len, Hkv, hd] in the
    config's dtype (dense, moe; encdec also ``ek``/``ev`` of enc_seq rows
    for ``encode_kv``), the hybrid's per-superblock RG-LRU states and ring
    caches of ``min(window, cache_len)`` slots, RWKV's [L, batch, H, K, K]
    states and token-shift carries.  Layer l's slice of each is
    contiguous."""
    device = DEFAULT_DEVICE if device is None else torch.device(device)
    dt, f32 = cfg.tdtype, torch.float32
    hd, Hkv, D = cfg.hd, cfg.n_kv, cfg.d_model

    def z(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.family in ("dense", "moe", "encdec"):
        L = cfg.n_layers
        st = {"k": z((L, batch, cache_len, Hkv, hd)),
              "v": z((L, batch, cache_len, Hkv, hd))}
        if cfg.family == "encdec":
            st["ek"] = z((L, batch, cfg.enc_seq, Hkv, hd))
            st["ev"] = z((L, batch, cfg.enc_seq, Hkv, hd))
        return st
    if cfg.family == "hybrid":
        n_super, n_tail = cfg.n_layers // 3, cfg.n_layers % 3
        R, W = cfg.lru_dim, cfg.conv_width
        win = min(cfg.window, cache_len)
        st = {"super": {
            "h1": z((n_super, batch, R), f32),
            "c1": z((n_super, batch, W - 1, R)),
            "h2": z((n_super, batch, R), f32),
            "c2": z((n_super, batch, W - 1, R)),
            "k": z((n_super, batch, win, Hkv, hd)),
            "v": z((n_super, batch, win, Hkv, hd))}}
        if n_tail:
            st["tail"] = {"h": z((n_tail, batch, R), f32),
                          "c": z((n_tail, batch, W - 1, R))}
        return st
    if cfg.family == "rwkv":
        H = _rwkv_heads(cfg)
        K, L = D // H, cfg.n_layers
        return {"S": z((L, batch, H, K, K), f32),
                "last": z((L, batch, D), f32),
                "last_c": z((L, batch, D), f32)}
    raise ValueError(cfg.family)


def state_items(state: dict, prefix: tuple = ()):
    """(key path, tensor) of every tensor of a decode state, nested dicts
    walked in order."""
    for k, v in state.items():
        if isinstance(v, dict):
            yield from state_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _cache_rows(cache: torch.Tensor, pos: int, *, ring: bool = False):
    """(slot, kv_len) of position ``pos`` in the caches [L, B, T, ...]:
    the new token goes to slot ``pos % T`` (ring) or ``min(pos, T - 1)``
    and attention reads ``min(pos + 1, T)`` rows, int32 [B]."""
    B, T = cache.shape[1], cache.shape[2]
    slot = pos % T if ring else min(pos, T - 1)
    return slot, torch.full((B,), min(pos + 1, T), dtype=torch.int32,
                            device=cache.device)


def _decode_attn_layer(x, lp, cache_k, cache_v, slot: int, kv_len,
                       cfg: ArchConfig, sin, cos, *, mode=None):
    """Self attention of one token: its K/V written into the cache in place
    at ``slot``, then one ``decode_attention`` over ``kv_len`` rows."""
    B = x.shape[0]
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv
    q = _heads(x @ lp["wq"], B, 1, Hq, hd)
    k = _heads(x @ lp["wk"], B, 1, Hkv, hd)
    v = _heads(x @ lp["wv"], B, 1, Hkv, hd)
    q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    if _dt.is_dtensor(cache_k):
        _dt.write_row(cache_k, slot, k[:, 0])
        _dt.write_row(cache_v, slot, v[:, 0])
    else:
        cache_k[:, slot] = k[:, 0]
        cache_v[:, slot] = v[:, 0]
    o = decode_attention(q, cache_k, cache_v, kv_len,
                         mxu_native=cfg.attn_mxu_native, mode=mode)
    return _dt.residual(_dt.merge_heads(o) @ lp["wo"])


def _rec_step(x, rec, h, c):
    """One RG-LRU block's step, its state (h, c) written in place."""
    y, s = recurrent_block_step(x, rec, {"h": h, "conv": c})
    h.copy_(s["h"])
    c.copy_(s["conv"])
    return _dt.residual(y)


def decode_step(params: LM, state: dict, tokens: torch.Tensor, pos: int,
                cfg: ArchConfig, *, mode: str | None = None):
    """One token per sequence, tokens int [B, 1] at position ``pos``:
    returns (logits [B, 1, V], state), every cache and recurrent state of
    ``state`` written in place.  ``mode`` picks the attention: None follows
    the device, ``"cuda"`` the kernel, ``"ref"`` the twin."""
    x = _dt.residual(_dt.embed(params.embed, tokens))
    B = x.shape[0]
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    sin, cos = rope(positions, cfg.hd, cfg.rope_theta)
    sin, cos = sin[None], cos[None]

    if cfg.family in ("dense", "moe", "encdec"):
        slot, kv_len = _cache_rows(state["k"], pos)
        if cfg.family == "encdec":
            enc_len = torch.full((B,), state["ek"].shape[2],
                                 dtype=torch.int32, device=x.device)

            def cross(q, k, v):
                return decode_attention(q, k, v, enc_len, mode=mode)
        for i, lp in enumerate(params.layers):
            h = x + _decode_attn_layer(rms_norm(x, lp["ln1"]), lp,
                                       state["k"][i], state["v"][i], slot,
                                       kv_len, cfg, sin, cos, mode=mode)
            if cfg.family == "encdec":
                h = h + _cross(h, lp, cfg, state["ek"][i], state["ev"][i],
                               cross)
            if cfg.family == "moe":
                x = h + _moe(rms_norm(h, lp["ln2"]), lp, cfg)
            else:
                x = h + _mlp_block(rms_norm(h, lp["ln2"]), lp)
    elif cfg.family == "hybrid":
        st = state["super"]
        slot, kv_len = _cache_rows(st["k"], pos, ring=True)
        for i, lp in enumerate(params.super):
            x = x + _rec_step(rms_norm(x, lp["ln_r1"]), lp["rec1"],
                              st["h1"][i], st["c1"][i])
            x = x + _mlp_block(rms_norm(x, lp["ln_m1"]), lp["mlp1"])
            x = x + _rec_step(rms_norm(x, lp["ln_r2"]), lp["rec2"],
                              st["h2"][i], st["c2"][i])
            x = x + _mlp_block(rms_norm(x, lp["ln_m2"]), lp["mlp2"])
            x = x + _decode_attn_layer(rms_norm(x, lp["ln_a"]), lp,
                                       st["k"][i], st["v"][i], slot, kv_len,
                                       cfg, sin, cos, mode=mode)
            x = x + _mlp_block(rms_norm(x, lp["ln_m3"]), lp["mlp3"])
        for i, lp in enumerate(getattr(params, "tail", ())):
            x = x + _rec_step(rms_norm(x, lp["ln_r"]), lp["rec"],
                              state["tail"]["h"][i], state["tail"]["c"][i])
            x = x + _mlp_block(rms_norm(x, lp["ln_m"]), lp["mlp"])
    elif cfg.family == "rwkv":
        H = _rwkv_heads(cfg)
        for i, lp in enumerate(params.layers):
            y, ts = rwkv_mod.time_mix_step(
                rms_norm(x, lp["ln1"]), lp,
                {"S": state["S"][i], "last": state["last"][i]}, n_heads=H)
            state["S"][i].copy_(ts["S"])
            state["last"][i].copy_(ts["last"])
            x = x + _dt.residual(y)
            y, cs = rwkv_mod.channel_mix_step(
                rms_norm(x, lp["ln2"]), lp, {"last_c": state["last_c"][i]})
            state["last_c"][i].copy_(cs["last_c"])
            x = x + _dt.residual(y)
    else:
        raise ValueError(cfg.family)
    return rms_norm(x, params.ln_f) @ params.head, state
