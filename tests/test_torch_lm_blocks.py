"""The blocks of the four LM families the port added, held to the JAX
package on the CPU on the same numpy inputs from a seed.

* ``gqa_attention``'s options (``causal=False``, ``window`` in the
  single-shot and the online block, ``q_offset``, with ``q_chunk``) and
  the hybrid's ring-buffer decode (smoke window 8 over 20 positions) against
  JAX's decode and the window mask of the port's own ``forward``;
* RG-LRU: the log-depth scan against JAX's ``associative_scan`` and the
  port's own step loop, at 1, 33 and 300 steps of strong decay (no
  overflow);
* RWKV-6: ``time_mix`` (chunked) against JAX's and the port's own stepwise
  recurrence, ``time_mix_step`` and ``channel_mix`` against JAX's;
* whisper's ``encode_kv`` against JAX's;
* the two conventions copied by hand: ``jax.nn.gelu`` is the tanh
  approximation and ``jnp.var`` the population variance; the other choice
  must fail each parity check.

Tolerances: f32 atol/rtol 1e-4 (summation order); the chunked RWKV
against the stepwise one 1e-3 (its chunked exponentials sum decays in
another order), as the JAX package's own check of the same pair allows
5e-2 (``tests/test_models_lm.py:121``).
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.models import attention as jattention
from repro.models import decode_step as j_decode_step
from repro.models import init_decode_state as j_init_decode_state
from repro.models import init_params as j_init_params
from repro.models import rglru as jrglru
from repro.models import rwkv as jrwkv
from repro.models.transformer import encode_kv as j_encode_kv
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattention
from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as T

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The smoke config in f32, the JAX package's weights (key 0) and the
    port's copy of them."""
    jc = jconfigs.smoke_config(arch).scaled(dtype="float32")
    tc = tconfigs.smoke_config(arch).scaled(dtype="float32")
    params = j_init_params(jc, jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    return jc, tc, params, T.params_from_numpy(tree, tc, device=CPU)


def _layer0(params, stack="layers"):
    return jax.tree.map(lambda a: a[0], params[stack])


# -------------------------------------------------------------- attention
ATTN = [dict(causal=False), dict(causal=False, q_chunk=8),
        dict(window=5), dict(window=5, k_chunk=8), dict(window=5, q_chunk=8),
        dict(window=12, q_chunk=8, k_chunk=4), dict(q_offset=7),
        dict(q_offset=4, window=3, q_chunk=4)]


@pytest.mark.parametrize("kw", ATTN, ids=str)
def test_gqa_attention_options_match_jax(kw):
    rng = np.random.default_rng(3)
    B, S, Hq, Hkv, D = 2, 16, 4, 2, 8
    T_ = S + kw.get("q_offset", 0)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((B, S, Hq, D), (B, T_, Hkv, D), (B, T_, Hkv, D)))
    want = jattention.gqa_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                    **kw)
    got = tattention.gqa_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                   **kw)
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-5, rtol=1e-5)


def test_window_binds_only_past_its_width():
    """tests/test_models_lm.py's window check on the port: early positions
    equal full causal attention, the last differs."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 12, 2, 8))
                                .astype(np.float32)) for _ in range(3))
    full = tattention.gqa_attention(q, k, v, window=0)
    win = tattention.gqa_attention(q, k, v, window=4)
    torch.testing.assert_close(win[:, :4], full[:, :4])
    assert not torch.allclose(win[:, -1], full[:, -1])


def test_hybrid_ring_wraps():
    """recurrentgemma's smoke config (window 8) decodes 20 positions over a
    ring of 8 slots: each step's logits and the ring equal JAX's, and equal
    the port's ``forward``, whose local attention is the window mask."""
    jc, tc, params, model = _weights("recurrentgemma-2b")
    n, B = 20, 2
    toks = np.random.default_rng(12).integers(0, jc.vocab, (B, n)).astype(
        np.int32)
    jstate = j_init_decode_state(jc, B, n)
    state = T.init_decode_state(tc, B, n, device=CPU)
    assert state["super"]["k"].shape[2] == tc.window == 8
    step = jax.jit(lambda p, s, t, pos: j_decode_step(p, s, t, pos, jc))
    full = T.forward(model, torch.from_numpy(toks), tc)
    for t in range(n):
        lg, jstate = step(params, jstate, jnp.asarray(toks[:, t:t + 1]),
                          jnp.int32(t))
        got, state = T.decode_step(model, state,
                                   torch.from_numpy(toks[:, t:t + 1]), t, tc)
        np.testing.assert_allclose(f32(got), f32(lg), **TOL)
        np.testing.assert_allclose(f32(state["super"]["k"]),
                                   f32(jstate["super"]["k"]), **TOL)
        np.testing.assert_allclose(f32(got[:, 0]), f32(full[:, t]), **TOL)


# ----------------------------------------------------------------- RG-LRU
def _lru_case(S, seed, scale=1.0):
    jc, tc, params, model = _weights("recurrentgemma-2b")
    lp = _layer0(params, "super")["rec1"]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, S, jc.lru_dim)).astype(np.float32) * scale
    h0 = rng.normal(size=(2, jc.lru_dim)).astype(np.float32)
    return lp, model.super[0]["rec1"], x, h0


@pytest.mark.parametrize("S", [1, 33, 300])
def test_rglru_scan_matches_jax_and_the_step_loop(S):
    lp, tp, x, h0 = _lru_case(S, seed=S, scale=3.0)
    want, want_last = jax.jit(jrglru.rglru_scan)(jnp.asarray(x), lp["lru"],
                                                 jnp.asarray(h0))
    got, last = trglru.rglru_scan(torch.from_numpy(x), tp["lru"],
                                  torch.from_numpy(h0))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    np.testing.assert_allclose(f32(last), f32(want_last), **TOL)
    h, outs = torch.from_numpy(h0), []
    for t in range(S):
        o, h = trglru.rglru_step(torch.from_numpy(x[:, t]), tp["lru"], h)
        outs.append(o)
    torch.testing.assert_close(torch.stack(outs, 1), got, **TOL)
    torch.testing.assert_close(h, last, **TOL)


def test_recurrent_block_and_step_match_jax():
    jc, tc, params, model = _weights("recurrentgemma-2b")
    lp, tp = _layer0(params, "super")["rec1"], model.super[0]["rec1"]
    x = np.random.default_rng(5).normal(size=(2, 9, jc.d_model)).astype(
        np.float32)
    want, wst = jrglru.recurrent_block(jnp.asarray(x), lp, None)
    got, st = trglru.recurrent_block(torch.from_numpy(x), tp, None)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    np.testing.assert_allclose(f32(st["conv"]), f32(wst["conv"]), **TOL)
    ws = jrglru.recurrent_block_step(jnp.asarray(x[:, :1]), lp, wst)
    ts = trglru.recurrent_block_step(torch.from_numpy(x[:, :1]), tp, st)
    np.testing.assert_allclose(f32(ts[0]), f32(ws[0]), **TOL)
    np.testing.assert_allclose(f32(ts[1]["h"]), f32(ws[1]["h"]), **TOL)


@contextlib.contextmanager
def _patched(module, name, fn):
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, real)


@pytest.mark.parametrize("approximate", ["tanh", "none"])
def test_gelu_is_the_tanh_approximation(approximate):
    """``jax.nn.gelu`` defaults to the tanh form: the port's block matches
    JAX's with it and misses by more than the tolerance with the exact
    form."""
    jc, tc, params, model = _weights("recurrentgemma-2b")
    lp, tp = _layer0(params, "super")["rec1"], model.super[0]["rec1"]
    x = np.random.default_rng(6).normal(size=(2, 9, jc.d_model)).astype(
        np.float32) * 3
    want, _ = jrglru.recurrent_block(jnp.asarray(x), lp, None)
    with _patched(trglru, "_gelu",
                  lambda a: F.gelu(a, approximate=approximate)):
        got, _ = trglru.recurrent_block(torch.from_numpy(x), tp, None)
    ok = np.allclose(f32(got), f32(want), **TOL)
    assert ok == (approximate == "tanh")


# ----------------------------------------------------------------- RWKV-6
def _rwkv_case(S, seed):
    jc, tc, params, model = _weights("rwkv6-7b")
    x = np.random.default_rng(seed).normal(size=(2, S, jc.d_model)).astype(
        np.float32) * 0.5
    return jc, _layer0(params), model.layers[0], x


@pytest.mark.parametrize("S,chunk", [(19, 8), (64, 64), (70, 64), (5, 8)])
def test_time_mix_matches_jax(S, chunk):
    jc, lp, tp, x = _rwkv_case(S, seed=S)
    H = jc.n_heads
    want, wst = jax.jit(functools.partial(jrwkv.time_mix, n_heads=H,
                                          chunk=chunk))(jnp.asarray(x), lp,
                                                        None)
    got, st = trwkv.time_mix(torch.from_numpy(x), tp, None, n_heads=H,
                             chunk=chunk)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    np.testing.assert_allclose(f32(st["S"]), f32(wst["S"]), **TOL)
    np.testing.assert_allclose(f32(st["last"]), f32(wst["last"]), **TOL)


def test_time_mix_chunked_equals_stepwise():
    """tests/test_models_lm.py's check on the port: the chunkwise-parallel
    wkv equals the decode recurrence, output and state."""
    jc, lp, tp, x = _rwkv_case(19, seed=3)
    H, K = jc.n_heads, jc.d_model // jc.n_heads
    y, st = trwkv.time_mix(torch.from_numpy(x), tp, None, n_heads=H, chunk=8)
    st2 = {"S": torch.zeros(2, H, K, K), "last": torch.zeros(2, jc.d_model)}
    outs = []
    for t in range(x.shape[1]):
        o, st2 = trwkv.time_mix_step(torch.from_numpy(x[:, t:t + 1]), tp, st2,
                                     n_heads=H)
        outs.append(o[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), y, atol=1e-3,
                               rtol=1e-3)
    torch.testing.assert_close(st2["S"], st["S"], atol=1e-3, rtol=1e-3)


def test_time_mix_step_and_channel_mix_match_jax():
    jc, lp, tp, x = _rwkv_case(6, seed=8)
    H, K = jc.n_heads, jc.d_model // jc.n_heads
    rng = np.random.default_rng(9)
    S0 = rng.normal(size=(2, H, K, K)).astype(np.float32)
    last = rng.normal(size=(2, jc.d_model)).astype(np.float32)
    want, wst = jrwkv.time_mix_step(
        jnp.asarray(x[:, :1]), lp, {"S": jnp.asarray(S0),
                                     "last": jnp.asarray(last)}, n_heads=H)
    got, st = trwkv.time_mix_step(
        torch.from_numpy(x[:, :1]), tp, {"S": torch.from_numpy(S0),
                                         "last": torch.from_numpy(last)},
        n_heads=H)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    np.testing.assert_allclose(f32(st["S"]), f32(wst["S"]), **TOL)
    for state in (None, {"last_c": last}):
        want, _ = jrwkv.channel_mix(
            jnp.asarray(x), lp, None if state is None else
            {"last_c": jnp.asarray(last)})
        got, _ = trwkv.channel_mix(
            torch.from_numpy(x), tp, None if state is None else
            {"last_c": torch.from_numpy(last)})
        np.testing.assert_allclose(f32(got), f32(want), **TOL)
    want, _ = jrwkv.channel_mix_step(jnp.asarray(x[:, :1]), lp,
                                     {"last_c": jnp.asarray(last)})
    got, _ = trwkv.channel_mix_step(torch.from_numpy(x[:, :1]), tp,
                                    {"last_c": torch.from_numpy(last)})
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


@pytest.mark.parametrize("correction", [0, 1])
def test_group_norm_is_the_population_variance(correction):
    """``jnp.var`` divides by K: the port's ``time_mix`` matches JAX's with
    ``correction=0`` and misses by more than the tolerance with torch's
    default ``correction=1``."""
    jc, lp, tp, x = _rwkv_case(9, seed=10)
    want, _ = jax.jit(functools.partial(jrwkv.time_mix, n_heads=jc.n_heads))(
        jnp.asarray(x), lp, None)

    def group_norm(o, params):
        mu = o.mean(-1, keepdim=True)
        var = o.var(-1, keepdim=True, correction=correction)
        return (o - mu) * torch.rsqrt(var + 64e-5) * params["ln_x_w"] + \
            params["ln_x_b"]

    with _patched(trwkv, "_group_norm", group_norm):
        got, _ = trwkv.time_mix(torch.from_numpy(x), tp, None,
                                n_heads=jc.n_heads)
    ok = np.allclose(f32(got), f32(want), **TOL)
    assert ok == (correction == 0)


# ---------------------------------------------------------------- encdec
def test_encode_kv_matches_jax():
    jc, tc, params, model = _weights("whisper-tiny")
    enc = np.random.default_rng(13).normal(
        size=(2, jc.enc_seq, jc.d_model)).astype(np.float32)
    wk, wv = j_encode_kv(params, jnp.asarray(enc), jc)
    ks, vs = T.encode_kv(model, torch.from_numpy(enc), tc)
    assert ks.shape == (jc.n_layers, 2, jc.enc_seq, jc.n_kv, jc.hd)
    np.testing.assert_allclose(f32(ks), f32(wk), **TOL)
    np.testing.assert_allclose(f32(vs), f32(wv), **TOL)


def test_encdec_forward_needs_enc_inputs():
    _, tc, _, model = _weights("whisper-tiny")
    with pytest.raises(ValueError, match="enc_inputs"):
        T.forward(model, torch.zeros(1, 3, dtype=torch.int32), tc)
