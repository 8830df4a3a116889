"""The port's LM decode slice held to the JAX package on the CPU.

Every comparison feeds the same numpy inputs, made from a seed, to the JAX
function and its port: ``decode_attn`` (the kernel's plain version, the
twin, the wrapper and the dispatcher) against the Pallas kernel in
interpret mode and the JAX oracle on the ``tests/test_kernels.py`` sweep;
the norms and RoPE; the dense LM's ``decode_step``, ``forward`` and
``greedy_decode`` at the smoke configs with the JAX weights carried across
by ``params_from_numpy``; the configs; the launcher.  Tolerances: the
sweep's own (bf16 atol 2e-2, f32 atol 2e-5, rtol 1e-2); the LM in f32
atol/rtol 1e-4 (summation order only) and in bf16 atol 0.12 / rtol 0.05
(the JAX package's own decode bound, ``tests/test_models_lm.py``).
"""
import ctypes
import dataclasses
import functools
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattention
from repro.models import common as jcommon
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_decode_state as j_init_decode_state
from repro.models import init_params as j_init_params
from repro.serving.serve import greedy_decode as j_greedy_decode
from repro_torch import configs as tconfigs
from repro_torch.kernels import launch as tlaunch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attn import (
    decode_attn,
    decode_attn_plain,
    mxu_bound,
)
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattention
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttransformer
from repro_torch.serving import greedy_decode as t_greedy_decode
from repro_torch.serving import make_decode_step, make_prefill_step

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATTN_TOL = {"float32": dict(atol=2e-5, rtol=1e-2),
            "bfloat16": dict(atol=2e-2, rtol=1e-2)}
LM_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
          "bfloat16": dict(atol=0.12, rtol=0.05)}


def to_torch(x, dtype=None) -> torch.Tensor:
    """A JAX array as a CPU tensor with the same values (bf16 crosses as
    f32, losslessly)."""
    a = np.asarray(x)
    if dtype is None:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.astype(np.float32)).to(dtype)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


# ----------------------------------------------------------- decode_attn
SWEEP = [(2, 4, 4, 16, 33, "float32"), (3, 8, 2, 32, 128, "float32"),
         (1, 16, 8, 64, 700, "bfloat16")]   # tests/test_kernels.py:166


@functools.lru_cache(maxsize=None)
def _sweep_case(i):
    B, Hq, Hkv, D, S, dtype = SWEEP[i]
    rng = np.random.default_rng(100 + i)
    q = jnp.asarray(rng.normal(size=(B, Hq, D)), JDT[dtype])
    k = jnp.asarray(rng.normal(size=(B, S, Hkv, D)), JDT[dtype])
    v = jnp.asarray(rng.normal(size=(B, S, Hkv, D)), JDT[dtype])
    kvl = jnp.asarray(rng.integers(1, S + 1, (B,)), jnp.int32)
    want_interp = f32(jops.decode_attn(q, k, v, kvl, mode="interpret"))
    want_ref = f32(jref.decode_attn(q, k, v, kvl))
    ins = tuple(to_torch(x, TDT[dtype]) for x in (q, k, v)) + (to_torch(kvl),)
    return ins, want_interp, want_ref


PORT_ATTN = {
    "plain": decode_attn_plain,
    "twin": tref.decode_attn,
    "wrapper": decode_attn,
    "ops_none": tops.decode_attn,
    "ops_cuda": functools.partial(tops.decode_attn, mode="cuda"),
    "ops_ref": functools.partial(tops.decode_attn, mode="ref"),
}


@pytest.mark.parametrize("fn", sorted(PORT_ATTN))
@pytest.mark.parametrize("case", range(len(SWEEP)))
def test_decode_attn_matches_pallas_and_oracle(case, fn):
    (q, k, v, kvl), want_interp, want_ref = _sweep_case(case)
    before = decode_attn.launches
    got = PORT_ATTN[fn](q, k, v, kvl)
    assert decode_attn.launches == before   # nothing launches on the CPU
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = ATTN_TOL[SWEEP[case][-1]]
    np.testing.assert_allclose(f32(got), want_interp, **tol)
    np.testing.assert_allclose(f32(got), want_ref, **tol)


def test_decode_attn_kv_len_zero_follows_the_tpu_kernel():
    """A row with kv_len = 0: the Pallas kernel gives zeros, the JAX oracle
    NaN, the jnp model function the mean of V (ROADMAP.md Queue 3 item 2).
    The port's kernel, plain version, twin and model function all follow
    the Pallas kernel."""
    B, Hq, Hkv, D, S = 3, 4, 2, 16, 40
    rng = np.random.default_rng(7)
    q = jnp.asarray(rng.normal(size=(B, Hq, D)), jnp.float32)
    k = jnp.asarray(rng.normal(size=(B, S, Hkv, D)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(B, S, Hkv, D)), jnp.float32)
    kvl = jnp.asarray([0, 17, 0], jnp.int32)
    pallas = f32(jops.decode_attn(q, k, v, kvl, mode="interpret"))
    oracle = f32(jref.decode_attn(q, k, v, kvl))
    model = f32(jattention.decode_attention(q[:, None], k, v, kvl))[:, 0]
    empty = np.asarray(kvl) == 0
    assert (pallas[empty] == 0).all()
    assert np.isnan(oracle[empty]).all()
    G = Hq // Hkv
    mean_v = np.repeat(f32(v).mean(axis=1), G, axis=1)        # [B, Hq, D]
    np.testing.assert_allclose(model[empty], mean_v[empty], atol=1e-5)
    np.testing.assert_allclose(oracle[~empty], pallas[~empty], atol=2e-5)

    tq, tk, tv, tkvl = (to_torch(x) for x in (q, k, v, kvl))
    ports = [fn(tq, tk, tv, tkvl) for fn in PORT_ATTN.values()]
    ports.append(tattention.decode_attention(tq[:, None], tk, tv, tkvl)[:, 0])
    for got in ports:
        np.testing.assert_array_equal(f32(got)[empty], 0.0)
        np.testing.assert_allclose(f32(got)[~empty], pallas[~empty],
                                   atol=2e-5, rtol=1e-2)


def test_decode_attn_kv_len_past_the_cache_reads_all_of_it():
    B, Hq, Hkv, D, S = 2, 2, 1, 32, 9
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    full = decode_attn(q, k, v, torch.full((B,), S, dtype=torch.int32))
    past = decode_attn(q, k, v, torch.full((B,), S + 5, dtype=torch.int32))
    torch.testing.assert_close(past, full, rtol=0, atol=0)


def test_decode_attn_dispatch_rejects_classify_modes():
    (q, k, v, kvl), _, _ = _sweep_case(0)
    for mode in ("unfused", "layerwise-ref", "pallas"):
        with pytest.raises(ValueError):
            tops.decode_attn(q, k, v, kvl, mode=mode)


@pytest.mark.parametrize("arg,ctype", [
    (torch.zeros(1), ctypes.c_void_p), (3, ctypes.c_int),
    (True, ctypes.c_int), (0.5, ctypes.c_float)])
def test_launch_passes_floats_as_c_float(arg, ctype):
    assert tlaunch._c_type(arg) is ctype


def test_launch_refuses_an_argument_with_no_c_type():
    with pytest.raises(TypeError):
        tlaunch._c_type(np.float32(0.5))


# --------------------------------------------------------- norms and RoPE
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 5, 64)) * 3, JDT[dtype])
    scale = jnp.asarray(rng.normal(size=(64,)) * 0.1, jnp.float32)
    want = jcommon.rms_norm(x, scale)
    got = tcommon.rms_norm(to_torch(x, TDT[dtype]), to_torch(scale))
    assert got.dtype == TDT[dtype]
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else \
        dict(atol=0, rtol=2**-7)
    np.testing.assert_allclose(f32(got), f32(want), **tol)


@pytest.mark.parametrize("head_dim,theta", [(16, 10_000.0), (128, 1e6)])
def test_rope_matches_jax(head_dim, theta):
    """Positions up to 32767: a float64 product would drift from JAX's
    float32 one by ~1e-4 in the angle there."""
    pos = np.asarray([0, 1, 7, 1000, 4095, 32767], np.int32)
    ws, wc = jcommon.rope(jnp.asarray(pos), head_dim, theta)
    gs, gc = tcommon.rope(torch.from_numpy(pos), head_dim, theta)
    assert gs.dtype == torch.float32 and gs.shape == (len(pos), head_dim // 2)
    np.testing.assert_allclose(f32(gs), f32(ws), atol=2e-6, rtol=0)
    np.testing.assert_allclose(f32(gc), f32(wc), atol=2e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(2, 6, 3, 16)), JDT[dtype])
    sin, cos = jcommon.rope(jnp.arange(6), 16, 10_000.0)
    want = jcommon.apply_rope(x, sin[None], cos[None])
    got = tcommon.apply_rope(to_torch(x, TDT[dtype]), to_torch(sin)[None],
                             to_torch(cos)[None])
    assert got.dtype == TDT[dtype]
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else \
        dict(atol=0, rtol=2**-7)
    np.testing.assert_allclose(f32(got), f32(want), **tol)


def test_apply_rope_rotates_halves():
    """(x1, x2) -> (x1 c - x2 s, x2 c + x1 s) over the two halves of D."""
    x = torch.arange(8, dtype=torch.float32).reshape(1, 1, 1, 8)
    s = torch.ones(1, 1, 4)
    c = torch.zeros(1, 1, 4)
    got = tcommon.apply_rope(x, s, c)
    torch.testing.assert_close(got.flatten(), torch.tensor(
        [-4.0, -5, -6, -7, 0, 1, 2, 3]))


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("kw", [
    dict(), dict(q_chunk=8), dict(k_chunk=8), dict(q_chunk=4),
    dict(k_chunk=4), dict(q_chunk=8, k_chunk=16), dict(q_chunk=16, k_chunk=8)],
    ids=str)
def test_gqa_attention_matches_jax(kw):
    rng = np.random.default_rng(3)
    B, S, Hq, Hkv, D = 2, 32, 4, 2, 8
    T = S
    q = jnp.asarray(rng.normal(size=(B, S, Hq, D)), jnp.float32)
    k = jnp.asarray(rng.normal(size=(B, T, Hkv, D)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(B, T, Hkv, D)), jnp.float32)
    want = jattention.gqa_attention(q, k, v, **kw)
    got = tattention.gqa_attention(to_torch(q), to_torch(k), to_torch(v),
                                   **kw)
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-5, rtol=1e-5)


# ------------------------------------------------- attn_mxu_native decode
# bf16 shapes (B, Hq, Hkv, D, S): the sweep's, whisper's G 1 and
# recurrentgemma's D 256
MXU_SWEEP = [(2, 4, 4, 16, 33), (3, 8, 2, 32, 128), (1, 16, 8, 64, 700),
             (4, 6, 6, 64, 96), (2, 10, 1, 256, 300)]
EXACT = {"xla_allow_excess_precision": False}


@functools.lru_cache(maxsize=None)
def _mxu_case(i):
    """bf16 inputs and the reference's ``decode_attention(...,
    mxu_native=True)``, compiled with XLA's excess precision off: with it
    on, XLA keeps P in f32 across the cast and the reference's bf16
    rounding of P vanishes."""
    B, Hq, Hkv, D, S = MXU_SWEEP[i]
    rng = np.random.default_rng(300 + i)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, 1, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    kvl = rng.integers(1, S + 1, (B,)).astype(np.int32)
    kvl[0], kvl[-1] = 1, S
    jin = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)] + [
        jnp.asarray(kvl)]
    want = jax.jit(lambda *a: jattention.decode_attention(
        *a, mxu_native=True)).lower(*jin).compile(
            compiler_options=EXACT)(*jin)
    ins = tuple(to_torch(x, torch.bfloat16) for x in (q, k, v)) + (
        torch.from_numpy(kvl),)
    return ins, f32(want)


def _mxu_gap(got, want, ins):
    """(max |got - want| over ``mxu_bound``, the share of elements that
    differ at all)."""
    q, k, v, n = ins
    w = torch.from_numpy(np.asarray(want, np.float32))
    bound = mxu_bound(q[:, 0], k, v, n, w)
    err = (got.float() - w).abs()
    return float((err / bound).max()), float((err > 0).float().mean())


# Bound (twin against the reference, bf16): ``mxu_bound`` (one bf16 ulp
# of the reference's output plus 2^-7 sum_t P_t |V_t|) everywhere, and at
# most 1% of the elements differing at all.  Both normalise the f32
# softmax, round P to bf16 and accumulate P.V in f32; they differ only in
# the order of f32 sums, which moves an element across a bf16 rounding
# boundary now and then (0-0.7% of the elements here).  The default
# attention (P kept in f32) differs in 19-41% of the elements and must fail
# it.
MXU_SHARE = 0.01
MXU_PORTS = {
    "attention": lambda q, k, v, n: tattention.decode_attention(
        q, k, v, n, mxu_native=True)[:, 0],
    "twin": lambda q, k, v, n: tref.decode_attn(q[:, 0], k, v, n,
                                                mxu_native=True),
    "wrapper": lambda q, k, v, n: decode_attn(q[:, 0], k, v, n,
                                              mxu_native=True),
    "ops_ref": lambda q, k, v, n: tops.decode_attn(
        q[:, 0], k, v, n, mxu_native=True, mode="ref"),
}


@pytest.mark.parametrize("fn", sorted(MXU_PORTS))
@pytest.mark.parametrize("case", range(len(MXU_SWEEP)))
def test_decode_attention_mxu_native_matches_jax(case, fn):
    ins, want = _mxu_case(case)
    before = decode_attn.launches
    got = MXU_PORTS[fn](*ins)
    assert decode_attn.launches == before
    assert got.dtype == torch.bfloat16
    over, share = _mxu_gap(got, want[:, 0], ins)
    assert over <= 1.0 and share <= MXU_SHARE, (over, share)


@pytest.mark.parametrize("case", range(len(MXU_SWEEP)))
def test_the_mxu_native_bound_refuses_the_default_attention(case):
    """The control: the same inputs through the default attention (P in
    f32) fail the bound the mxu_native twin meets."""
    ins, want = _mxu_case(case)
    over, share = _mxu_gap(tattention.decode_attention(*ins)[:, 0],
                           want[:, 0], ins)
    assert share > MXU_SHARE, (over, share)


@pytest.mark.parametrize("fn", ["attention", "twin", "wrapper"])
def test_mxu_native_is_the_default_in_f32(fn):
    """In f32 the reference's ``preferred_element_type`` and
    ``astype(v.dtype)`` are no-ops: the port's mxu_native path is its
    default path, bit for bit, and matches the reference's."""
    (q, k, v, n), _ = _mxu_case(2)
    q, k, v = q.float(), k.float(), v.float()
    default = {"attention": lambda **kw: tattention.decode_attention(
        q, k, v, n, **kw)[:, 0],
        "twin": lambda **kw: tref.decode_attn(q[:, 0], k, v, n, **kw),
        "wrapper": lambda **kw: decode_attn(q[:, 0], k, v, n, **kw)}[fn]
    got = default(mxu_native=True)
    assert torch.equal(got, default(mxu_native=False))
    jin = [jnp.asarray(x.numpy()) for x in (q, k, v, n)]
    want = f32(jattention.decode_attention(*jin, mxu_native=True))[:, 0]
    np.testing.assert_allclose(f32(got), want, **ATTN_TOL["float32"])


def test_decode_step_routes_attn_mxu_native(monkeypatch):
    """``cfg.attn_mxu_native`` reaches every self-attention launch of
    ``decode_step``; ten teacher-forced bf16 steps match the reference's
    mxu_native decode (compiled with excess precision off) at the LM's bf16
    bound."""
    tree, toks, _, _ = _jax_lm("internlm2-1.8b", "bfloat16")
    jc, tc = (c.scaled(attn_mxu_native=True)
              for c in _cfgs("internlm2-1.8b", "bfloat16"))
    params = jax.tree.map(jnp.asarray, tree)
    jstep = jax.jit(lambda p, s, t, pos: j_decode_step(p, s, t, pos, jc))
    jstate = j_init_decode_state(jc, B_LM, S_LM)
    model = ttransformer.params_from_numpy(tree, tc, device=CPU)
    state = ttransformer.init_decode_state(tc, B_LM, S_LM, device=CPU)
    seen = []
    real = tops.decode_attn

    def spy(*a, mxu_native=False, **kw):
        seen.append(mxu_native)
        return real(*a, mxu_native=mxu_native, **kw)

    monkeypatch.setattr(tops, "decode_attn", spy)
    for t in range(S_LM):
        tt = toks[:, t:t + 1]
        args = (params, jstate, jnp.asarray(tt), jnp.int32(t))
        want, jstate = jstep.lower(*args).compile(
            compiler_options=EXACT)(*args)
        got, state = ttransformer.decode_step(
            model, state, torch.from_numpy(tt), t, tc)
        np.testing.assert_allclose(f32(got), f32(want), **LM_TOL["bfloat16"])
    assert seen == [True] * (S_LM * tc.n_layers)


@pytest.mark.parametrize("window", [1, 4, 33])
def test_decode_attention_window_is_the_references_no_op(window):
    """``decode_attention(window=w)`` equals the reference's, which never
    reads ``window``, and equals the call without it: the ring lives in
    the caller's cache."""
    (q, k, v, kvl), _, _ = _sweep_case(0)
    q4 = q[:, None]
    got = tattention.decode_attention(q4, k, v, kvl, window=window)
    torch.testing.assert_close(
        got, tattention.decode_attention(q4, k, v, kvl), rtol=0, atol=0)
    jin = [jnp.asarray(x.numpy()) for x in (q4, k, v, kvl)]
    want = jattention.decode_attention(*jin, window=window)
    np.testing.assert_allclose(f32(got), f32(want), **ATTN_TOL["float32"])


# ---------------------------------------------------------------- the LM
B_LM, S_LM = 2, 10


def _cfgs(arch, dtype):
    jc, tc = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    if dtype == "float32":
        jc, tc = jc.scaled(dtype="float32"), tc.scaled(dtype="float32")
    return jc, tc


@functools.lru_cache(maxsize=None)
def _jax_lm(arch, dtype):
    """The JAX package's weights (numpy), tokens, forward logits and ten
    teacher-forced decode steps (logits and caches after each)."""
    jc, _ = _cfgs(arch, dtype)
    params = j_init_params(jc, jax.random.key(0))
    toks = np.random.default_rng(11).integers(
        0, jc.vocab, (B_LM, S_LM)).astype(np.int32)
    full = f32(j_forward(params, jnp.asarray(toks), jc, remat=False))
    step = jax.jit(lambda p, s, t, pos: j_decode_step(p, s, t, pos, jc))
    state = j_init_decode_state(jc, B_LM, S_LM)
    steps = []
    for t in range(S_LM):
        lg, state = step(params, state, jnp.asarray(toks[:, t:t + 1]),
                         jnp.int32(t))
        steps.append((f32(lg), f32(state["k"]), f32(state["v"])))
    return jax.tree.map(np.asarray, params), toks, full, steps


def _port_lm(arch, dtype):
    tree, toks, _, _ = _jax_lm(arch, dtype)
    _, tc = _cfgs(arch, dtype)
    return ttransformer.params_from_numpy(tree, tc, device=CPU), tc, toks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-20b"])
def test_decode_steps_match_jax(arch, dtype):
    model, tc, toks = _port_lm(arch, dtype)
    _, _, _, steps = _jax_lm(arch, dtype)
    state = ttransformer.init_decode_state(tc, B_LM, S_LM, device=CPU)
    for t, (lg, ck, cv) in enumerate(steps):
        got, state = ttransformer.decode_step(
            model, state, torch.from_numpy(toks[:, t:t + 1]), t, tc)
        assert got.dtype == tc.tdtype and got.shape == (B_LM, 1, tc.vocab)
        np.testing.assert_allclose(f32(got), lg, **LM_TOL[dtype])
        np.testing.assert_allclose(f32(state["k"]), ck, **LM_TOL[dtype])
        np.testing.assert_allclose(f32(state["v"]), cv, **LM_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-20b"])
def test_forward_matches_jax(arch, dtype):
    model, tc, toks = _port_lm(arch, dtype)
    _, _, full, _ = _jax_lm(arch, dtype)
    got = ttransformer.forward(model, torch.from_numpy(toks), tc)
    assert got.dtype == tc.tdtype
    np.testing.assert_allclose(f32(got), full, **LM_TOL[dtype])
    prefill = make_prefill_step(tc, q_chunk=5)
    np.testing.assert_allclose(f32(prefill(model, torch.from_numpy(toks))),
                               full, **LM_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_decode_matches_port_forward(dtype):
    """The KV-cache oracle of tests/test_models_lm.py on the port alone."""
    model, tc, toks = _port_lm("internlm2-1.8b", dtype)
    full = ttransformer.forward(model, torch.from_numpy(toks), tc)
    step = make_decode_step(tc)
    state = ttransformer.init_decode_state(tc, B_LM, S_LM, device=CPU)
    outs = []
    for t in range(S_LM):
        lg, state = step(model, state, torch.from_numpy(toks[:, t:t + 1]), t)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(f32(torch.stack(outs, 1)), f32(full),
                               **LM_TOL[dtype])


def test_greedy_decode_matches_jax_in_f32():
    tree, toks, _, _ = _jax_lm("internlm2-1.8b", "float32")
    jc, tc = _cfgs("internlm2-1.8b", "float32")
    P, n = 4, 12
    params = jax.tree.map(jnp.asarray, tree)
    jstate = j_init_decode_state(jc, B_LM, P + n)
    for t in range(P):
        lg, jstate = j_decode_step(params, jstate, jnp.asarray(toks[:, t:t + 1]),
                                   jnp.int32(t), jc)
    first = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
    want = np.asarray(j_greedy_decode(params, jstate, first, jnp.int32(P), jc,
                                      n))

    model, _, _ = _port_lm("internlm2-1.8b", "float32")
    state = ttransformer.init_decode_state(tc, B_LM, P + n, device=CPU)
    for t in range(P):
        lg, state = ttransformer.decode_step(
            model, state, torch.from_numpy(toks[:, t:t + 1]), t, tc)
    tfirst = torch.argmax(lg[:, -1], -1)[:, None].int()
    assert np.array_equal(tfirst.numpy(), np.asarray(first))
    got = t_greedy_decode(model, state, tfirst, P, tc, n)
    assert got.shape == (B_LM, n) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_position_past_the_cache_writes_the_last_slot():
    """pos >= T writes slot T - 1 and attends to all T slots, as
    ``jnp.minimum(pos, T - 1)`` does (src/repro/models/transformer.py:418)."""
    tree, toks, _, _ = _jax_lm("internlm2-1.8b", "float32")
    jc, tc = _cfgs("internlm2-1.8b", "float32")
    T = 4
    params = jax.tree.map(jnp.asarray, tree)
    jstate = j_init_decode_state(jc, B_LM, T)
    model, _, _ = _port_lm("internlm2-1.8b", "float32")
    state = ttransformer.init_decode_state(tc, B_LM, T, device=CPU)
    for t in range(T + 3):
        before = state["k"].clone()
        tok = toks[:, t:t + 1]
        want, jstate = j_decode_step(params, jstate, jnp.asarray(tok),
                                     jnp.int32(t), jc)
        got, state = ttransformer.decode_step(model, state,
                                              torch.from_numpy(tok), t, tc)
        np.testing.assert_allclose(f32(got), f32(want), **LM_TOL["float32"])
        np.testing.assert_allclose(f32(state["k"]), f32(jstate["k"]),
                                   **LM_TOL["float32"])
        changed = (state["k"] != before).any(dim=(0, 1, 3, 4))
        assert changed.tolist() == [s == min(t, T - 1) for s in range(T)]


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("which", ["get_config", "smoke_config"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_copy_equals_jax(arch, which):
    want = getattr(jconfigs, which)(arch)
    got = getattr(tconfigs, which)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hd == want.hd
    assert got.param_count() == want.param_count()
    assert got.tdtype == TDT[want.dtype]


def test_registry_copy_equals_jax():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.get_config("internlm2-1.8b").param_count() == 1_889_107_968


def test_init_params_shape_allocates_nothing():
    cfg = tconfigs.get_config("internlm2-1.8b")
    model = ttransformer.init_params_shape(cfg)
    assert all(p.device.type == "meta" for p in model.parameters())
    # param_count leaves out the final norm
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + cfg.d_model


def test_params_from_numpy_refuses_a_wrong_shape():
    tree, _, _, _ = _jax_lm("internlm2-1.8b", "float32")
    _, tc = _cfgs("internlm2-1.8b", "float32")
    bad = dict(tree, ln_f=np.zeros((tc.d_model + 1,), np.float32))
    with pytest.raises(ValueError, match="ln_f"):
        ttransformer.params_from_numpy(bad, tc, device=CPU)


# ---------------------------------------------------------------- launcher
def test_launcher_runs_and_swaps_in_place():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--batch", "2", "--prompt-len", "4", "--gen",
         "6"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert "tenant 1: 2x(4 prefill + 6 decode)" in res.stdout
    assert "served 2 tenants through ONE set of weight and cache tensors" \
        in res.stdout


def test_serve_keeps_its_buffers_and_follows_greedy():
    """The last tenant's weights are its seed's; every generated token is
    the argmax of a teacher-forced step over the tokens fed before it."""
    cfg = tconfigs.smoke_config("internlm2-1.8b").scaled(dtype="float32")
    model, state, runs = tserve.serve(cfg, batch=2, prompt_len=3, gen=5,
                                      swaps=2, seed=4, device=CPU)
    assert [r.tokens.shape for r in runs] == [(2, 3 + 1 + 5)] * 2
    assert not torch.equal(runs[0].tokens, runs[1].tokens)
    want = ttransformer.init_params(
        cfg, tserve.tenant_generator(4, 1, CPU), device=CPU)
    for p, w in zip(model.parameters(), want.parameters()):
        assert torch.equal(p, w)
    fed = runs[1].fed
    state = ttransformer.init_decode_state(cfg, 2, fed.shape[1], device=CPU)
    for t in range(fed.shape[1]):
        lg, state = ttransformer.decode_step(model, state, fed[:, t:t + 1], t,
                                             cfg)
        if t >= runs[1].prompt_len - 1:
            assert torch.equal(lg[:, 0].argmax(-1), runs[1].tokens[:, t + 1])
