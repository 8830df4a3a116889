"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427): the
hybrid family's recurrent layers.

Port of ``src/repro/models/rglru.py``: ``_gates`` (:26), ``rglru_scan``
(:36), ``rglru_step`` (:50), ``_conv_scan`` (:58), ``recurrent_block``
(:66) and ``recurrent_block_step`` (:80).  The gated diagonal recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(lam) * sigmoid(W_a x_t))

is associative.  The prefill runs it as a log-depth (Hillis-Steele) scan
with the reference's ``combine`` (``rglru.py:40-43``): (a1, b1) then
(a2, b2) -> (a1 + a2, exp(a2) b1 + b2), on log-decays that are all <= 0,
so no exponent overflows; it is not factored into ``exp(cumsum)``, which
would (the note at ``rwkv.py:94-97`` for the same algebra).  Decode is the
O(1) step.  State = (h [B, R] f32, conv tail [B, W - 1, R]); the functions
return new state, and the decode step of ``transformer`` writes it into the
caller's tensors in place.

``jax.nn.gelu`` is the tanh approximation by default (``rglru.py:70``,
``:83``); ``F.gelu`` is exact unless asked, so the gate passes
``approximate="tanh"``.  ``params`` is a dict or a module with ``[]``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rglru_scan", "rglru_step", "recurrent_block",
           "recurrent_block_step"]

_C = 8.0


def _gates(x, params):
    """x [..., R] f32 -> (log_a [..., R] (<= 0), gated input [..., R])."""
    a_gate = torch.sigmoid(x @ params["wa"] + params["ba"])
    i_gate = torch.sigmoid(x @ params["wi"] + params["bi"])
    log_a = -_C * F.softplus(params["lam"]) * a_gate
    gx = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) * \
        (i_gate * x)
    return log_a, gx


def rglru_scan(x: torch.Tensor, params,
               h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, R], h0 [B, R] -> (h_seq [B, S, R] in x's dtype, h_last
    [B, R] f32)."""
    la, b = _gates(x.float(), params)
    S = x.shape[1]
    off = 1
    while off < S:
        # element t takes (t - off) as its earlier part
        la, b = (torch.cat([la[:, :off], la[:, :-off] + la[:, off:]], dim=1),
                 torch.cat([b[:, :off],
                            torch.exp(la[:, off:]) * b[:, :-off] + b[:, off:]],
                           dim=1))
        off *= 2
    h = torch.exp(la) * h0[:, None, :] + b
    return h.to(x.dtype), h[:, -1, :]


def rglru_step(x: torch.Tensor, params,
               h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step: x [B, R], h [B, R] -> (out, new h)."""
    log_a, gx = _gates(x.float(), params)
    h_new = torch.exp(log_a) * h + gx
    return h_new.to(x.dtype), h_new


def _conv_scan(x: torch.Tensor, w: torch.Tensor,
               tail: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width W. x [B, S, R], tail [B, W-1, R]."""
    W = w.shape[0]
    xx = torch.cat([tail.to(x.dtype), x], dim=1)
    out = sum(xx[:, i:i + x.shape[1], :] * w[i] for i in range(W))
    return out, xx[:, -(W - 1):, :]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def recurrent_block(x: torch.Tensor, params, state: dict | None):
    """Griffin recurrent block over a sequence. x [B, S, D]."""
    B = x.shape[0]
    R = params["w_in"].shape[1]
    W = params["conv_w"].shape[0]
    gate = _gelu(x @ params["w_gate"])
    u = x @ params["w_in"]
    tail = (state["conv"] if state else
            torch.zeros((B, W - 1, R), dtype=x.dtype, device=x.device))
    h0 = (state["h"] if state else
          torch.zeros((B, R), dtype=torch.float32, device=x.device))
    u, new_tail = _conv_scan(u, params["conv_w"], tail)
    h_seq, h_last = rglru_scan(u, params["lru"], h0)
    y = (h_seq.to(x.dtype) * gate) @ params["w_out"]
    return y.to(x.dtype), {"h": h_last, "conv": new_tail.to(x.dtype)}


def recurrent_block_step(x: torch.Tensor, params, state: dict):
    """One-token decode. x [B, 1, D]."""
    xt = x[:, 0, :]
    gate = _gelu(xt @ params["w_gate"])
    u = xt @ params["w_in"]
    tail = state["conv"]                                  # [B, W-1, R]
    W = params["conv_w"].shape[0]
    window = torch.cat([tail, u[:, None, :].to(tail.dtype)], dim=1)
    u_conv = sum(window[:, i, :] * params["conv_w"][i] for i in range(W))
    out, h_new = rglru_step(u_conv, params["lru"], state["h"])
    y = (out.to(x.dtype) * gate) @ params["w_out"]
    return y[:, None, :].to(x.dtype), {"h": h_new, "conv": window[:, 1:, :]}
