"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free time mixing with
data-dependent per-channel decay, the rwkv family's layers.

Port of ``src/repro/models/rwkv.py``: ``_token_shift`` (:26), ``_mix_inputs``
(:33), ``_decay`` (:42), ``_project`` (:48), ``time_mix`` (:60, chunkwise
parallel, ``chunk=64``), ``_group_norm`` (:123), ``time_mix_step`` (:130),
``channel_mix`` (:151) and ``channel_mix_step`` (:161).  Per head (K = V =
head size):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = (r_t . S_{t-1}) + (r_t . (u * k_t)) v_t

Within a chunk the decay products are cumulative log-sums and the
token-token interaction a masked product; across chunks the [K, V] state is
carried by a Python loop (JAX's ``lax.scan``).  The intra-chunk exponent
stays joint in (t, s, k), ``min((cum - w)[t] - cum[s], 0)``
(``rwkv.py:98-100``): factored into exp(cum_t) * exp(-cum_s) it overflows
float32 once a chunk holds ~90 nats of decay.  Decode is the O(1)
recurrence; the functions return new state and the decode step of
``transformer`` writes it into the caller's tensors in place.

Two conventions kept by hand: ``jnp.var`` is the population variance
(``rwkv.py:126``), so ``torch.var(..., correction=0)``; and JAX promotes a
matmul of float32 activations by bfloat16 weights to float32 (the token-shift
mixes are float32, their ``mu`` being float32), where torch's ``@`` refuses
mixed dtypes, so ``_mm`` promotes first.  ``params`` is a dict or a module
with ``[]``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.distributed import dtensor as _dt

__all__ = ["time_mix", "time_mix_step", "channel_mix", "channel_mix_step"]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype of the two, as ``jnp.matmul`` does."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _token_shift(x: torch.Tensor, last: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} stream: shift right; slot 0 takes ``last`` (decode carry)."""
    first = (torch.zeros_like(x[:, :1]) if last is None
             else last[:, None, :].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _mix_inputs(x, xprev, params):
    """RWKV6 token-shift mixing for each projection stream."""
    return {name: x + (xprev - x) * params[f"mu_{name}"]
            for name in ("r", "k", "v", "g", "w")}


def _decay(xw, params):
    """Data-dependent per-channel log-decay (<= 0), via a low-rank mlp."""
    lora = _mm(torch.tanh(_mm(xw, params["w_lora_a"])), params["w_lora_b"])
    return -torch.exp(params["w_base"].float() + lora.float())


def _project(x, xprev, params, n_heads):
    m = _mix_inputs(x, xprev, params)
    B, S, D = x.shape
    K = D // n_heads
    def heads(t):
        return _dt.heads(t, n_heads).reshape(B, S, n_heads, K)

    r = heads(_mm(m["r"], params["wr"]))
    k = heads(_mm(m["k"], params["wk"]))
    v = heads(_mm(m["v"], params["wv"]))
    g = F.silu(_mm(m["g"], params["wg"]))
    logw = heads(_decay(m["w"], params))
    return r, k, v, g, logw


def _group_norm(o, params):
    """Per-head layer norm (RWKV's ln_x), population variance."""
    mu = o.mean(-1, keepdim=True)
    var = o.var(-1, keepdim=True, correction=0)
    return (o - mu) * torch.rsqrt(var + 64e-5) * params["ln_x_w"] + \
        params["ln_x_b"]


def time_mix(
    x: torch.Tensor,       # [B, S, D]
    params,
    state: dict | None,    # {"S": [B, H, K, K] f32, "last": [B, D]}
    *,
    n_heads: int,
    chunk: int = 64,
) -> tuple[torch.Tensor, dict]:
    B, S, D = x.shape
    K = D // n_heads
    last = state["last"] if state else None
    xprev = _token_shift(x, last)
    r, k, v, g, logw = _project(x, xprev, params, n_heads)
    u = params["u"].reshape(n_heads, K)
    wkv = _wkv
    if _dt.is_dtensor(r):
        wkv = functools.partial(_dt.wkv, _wkv)
    o, Sst = wkv(r, k, v, logw, u, state["S"] if state else None, chunk)
    o = _group_norm(o, params).reshape(B, S, D)
    y = _mm(o * g, params["wo"])
    return y.to(x.dtype), {"S": Sst, "last": x[:, -1, :].float()}


def _wkv(r, k, v, logw, u, Sst, chunk: int):
    """The chunkwise recurrence of ``time_mix``: r, k, v, logw [B, S, H,
    K], u [H, K], the state Sst [B, H, K, K] float32 (None: zeros) ->
    (o [B, S, H, K] float32, the last state)."""
    B, S, n_heads, K = r.shape
    if Sst is None:
        Sst = torch.zeros((B, n_heads, K, K), dtype=torch.float32,
                          device=r.device)
    pad = (-S) % chunk
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in
                         (r, k, v, logw))
    T = r.shape[1]
    n_chunks = T // chunk

    def resh(a):   # [n_chunks, B, H, C, K]
        return a.reshape(B, n_chunks, chunk, n_heads, K).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(logw)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), -1)
    outs = []
    for i in range(n_chunks):
        rr, kk, vv, ww = rc[i].float(), kc[i].float(), vc[i].float(), wc[i]
        cum = torch.cumsum(ww, dim=2)         # inclusive log-decay products
        # inter-chunk: r_t decayed by prod_{<t} w = exp(cum - w_t) (<= 0)
        o = torch.einsum("bhck,bhkv->bhcv", rr * torch.exp(cum - ww), Sst)
        # intra-chunk (s < t), the exponent joint in (t, s, k)
        dec = torch.exp(torch.clamp(
            (cum - ww)[:, :, :, None, :] - cum[:, :, None, :, :], max=0.0))
        att = (rr[:, :, :, None, :] * dec * kk[:, :, None, :, :]).sum(-1)
        att = torch.where(mask, att, 0.0)
        o = o + torch.einsum("bhcs,bhsv->bhcv", att, vv)
        # current-token bonus
        bonus = torch.einsum("bhck,bhck->bhc", rr, u[None, :, None, :] * kk)
        outs.append(o + bonus[..., None] * vv)
        # state to the next chunk
        total = cum[:, :, -1:, :]                # [B, H, 1, K]
        kdec = kk * torch.exp(total - cum)
        Sst = torch.exp(total[:, :, 0, :])[..., None] * Sst + torch.einsum(
            "bhsk,bhsv->bhkv", kdec, vv)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, T, n_heads, K)
    return o[:, :S], Sst


def time_mix_step(x: torch.Tensor, params, state: dict, *, n_heads: int):
    """One-token decode. x [B, 1, D]."""
    B, _, D = x.shape
    K = D // n_heads
    xprev = state["last"][:, None, :].to(x.dtype)
    r, k, v, g, logw = _project(x, xprev, params, n_heads)
    u = params["u"].reshape(n_heads, K)
    step = _wkv_step
    if _dt.is_dtensor(r):
        step = functools.partial(_dt.wkv, _wkv_step)
    o, Snew = step(r, k, v, logw, u, state["S"], 1)
    o = _group_norm(o, params).reshape(B, 1, D)
    y = _mm(o * g, params["wo"])
    return y.to(x.dtype), {"S": Snew, "last": x[:, -1, :].float()}


def _wkv_step(r, k, v, logw, u, Sst, chunk: int = 1):
    """The recurrence of ``time_mix_step`` for one token: r, k, v, logw
    [B, 1, H, K], u [H, K], the state Sst [B, H, K, K] float32 -> (o [B, 1,
    H, K] float32, the new state); ``chunk`` is ``_wkv``'s, unused."""
    B, _, n_heads, K = r.shape
    rr, kk, vv = r[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    ww = torch.exp(logw[:, 0])                     # decay in (0, 1)
    o = torch.einsum("bhk,bhkv->bhv", rr, Sst)
    o = o + torch.einsum("bhk,bhk->bh", rr, u[None] * kk)[..., None] * vv
    Snew = ww[..., None] * Sst + torch.einsum("bhk,bhv->bhkv", kk, vv)
    return o.reshape(B, 1, n_heads, K), Snew


def _channel(x, xprev, params):
    xr = x + (xprev - x) * params["mu_cr"]
    xk = x + (xprev - x) * params["mu_ck"]
    r = torch.sigmoid(_mm(xr, params["cr"]))
    kk = torch.square(torch.relu(_mm(xk, params["ck"])))
    return (r * _mm(kk, params["cv"])).to(x.dtype)


def channel_mix(x: torch.Tensor, params, state: dict | None):
    """RWKV FFN: r-gated squared-relu. x [B, S, D]."""
    last = state["last_c"] if state else None
    return (_channel(x, _token_shift(x, last), params),
            {"last_c": x[:, -1, :].float()})


def channel_mix_step(x: torch.Tensor, params, state: dict):
    xprev = state["last_c"][:, None, :].to(x.dtype)
    return _channel(x, xprev, params), {"last_c": x[:, -1, :].float()}
