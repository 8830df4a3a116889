"""The four LM families the port added (moe, hybrid, rwkv, encdec) held to
the JAX package on the CPU, at the smoke configs: the shared body of
``test_torch_lm_families.py`` (grok-1, qwen3-moe, whisper-tiny) and
``test_torch_lm_families_recurrent.py`` (recurrentgemma-2b, rwkv6-7b), so
the archs spread over the test workers.

The JAX package's weights (``init_params``, key 0) cross to the port by
``params_from_numpy``; the tokens (and whisper's encoder frames) are numpy
draws from a seed.  Per arch and dtype: ``forward`` equals JAX's, and ten
teacher-forced ``decode_step``s equal JAX's, logits and every cache and
recurrent state after each step (the hybrid's ring of 8 slots wraps within
the ten); the port's decode equals the port's own ``forward`` (the KV-cache
and recurrence oracle of ``tests/test_models_lm.py``, the moe archs with
``capacity_factor = n_experts`` as there: capacity depends on how many
tokens route at once, so prefill and decode drop differently otherwise).
The parity runs keep the default capacity factor, drops included: JAX and
the port route the same tokens at once.

The JAX side is compiled with XLA's ``xla_allow_excess_precision`` off:
by default XLA may keep a bfloat16 intermediate in float32 across a fused
convert (the residual adds, a block's output), where the program and the
port round it; with it off, the rwkv smoke model's bf16 forward equals the
port's bit for bit, and the others come closer (recurrentgemma 0.078 of
0.141 at most, grok-1 0.027 of 0.031).

Tolerances: f32 atol/rtol 1e-4 (summation order; the states 1e-3: rwkv's
chunked exponentials); bf16 atol 0.12 / rtol 0.05, the JAX package's own
decode bound (``tests/test_models_lm.py:71-73``).  bf16 rounds the two
packages' activations apart by an ulp here and there, so a token whose
router puts its k-th and (k+1)-th experts within about 1e-4 of each other
can switch experts between them (seen at a margin of 4e-5); each bf16 moe
case asserts first that every routing decision of its run has a margin of
at least 5e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_decode_state as j_init_decode_state
from repro.models import init_params as j_init_params
from repro.models.transformer import encode_kv as j_encode_kv
from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as T

CPU = torch.device("cpu")
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=0.12, rtol=0.05)}
STATE_TOL = {"float32": dict(atol=1e-3, rtol=1e-3),
             "bfloat16": dict(atol=0.12, rtol=0.05)}
MARGIN = 5e-4
B, S = 2, 10
EXACT = {"xla_allow_excess_precision": False}


def _compiled(fn, *args):
    """``fn`` jitted and compiled for ``args`` with bf16 rounded where the
    program says."""
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _cfgs(arch, dtype, no_drops=False):
    jc, tc = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    kw = {"dtype": dtype}
    if no_drops:
        kw["capacity_factor"] = float(jc.n_experts)
    return jc.scaled(**kw), tc.scaled(**kw)


def _enc(cfg):
    if cfg.family != "encdec":
        return None
    return np.random.default_rng(2).normal(
        size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@functools.lru_cache(maxsize=None)
def _jax_run(arch, dtype):
    """The JAX package's weights (numpy), tokens, encoder frames, forward
    logits and ten teacher-forced decode steps (logits and state after
    each)."""
    jc, _ = _cfgs(arch, dtype)
    params = j_init_params(jc, jax.random.key(0))
    toks = np.random.default_rng(11).integers(
        0, jc.vocab, (B, S)).astype(np.int32)
    enc = _enc(jc)
    jenc = None if enc is None else jnp.asarray(enc, jc.jdtype)
    jtoks = jnp.asarray(toks)
    full = f32(_compiled(lambda p, t, e: j_forward(
        p, t, jc, enc_inputs=e, remat=False), params, jtoks, jenc)(
            params, jtoks, jenc))
    state = j_init_decode_state(jc, B, S)
    if jc.family == "encdec":
        state["ek"], state["ev"] = _compiled(
            lambda p, e: j_encode_kv(p, e, jc), params, jenc)(params, jenc)
    step = _compiled(lambda p, s, t, pos: j_decode_step(p, s, t, pos, jc),
                     params, state, jtoks[:, :1], jnp.int32(0))
    steps = []
    for t in range(S):
        lg, state = step(params, state, jnp.asarray(toks[:, t:t + 1]),
                         jnp.int32(t))
        steps.append((f32(lg), jax.tree.map(f32, state)))
    return jax.tree.map(np.asarray, params), toks, enc, full, steps


def _port(arch, dtype, no_drops=False):
    tree, toks, enc, _, _ = _jax_run(arch, dtype)
    _, tc = _cfgs(arch, dtype, no_drops)
    model = T.params_from_numpy(tree, tc, device=CPU)
    tenc = None if enc is None else torch.from_numpy(enc).to(tc.tdtype)
    return model, tc, toks, tenc


def _port_state(model, tc, enc, n):
    state = T.init_decode_state(tc, B, n, device=CPU)
    if tc.family == "encdec":
        ks, vs = T.encode_kv(model, enc, tc)
        state["ek"].copy_(ks)
        state["ev"].copy_(vs)
    return state


class Margins:
    """Within the block, the smallest gap between the k-th and (k+1)-th
    router probability of every token the port routes."""

    def __enter__(self):
        self.min = float("inf")
        self._route = tmoe._route

        def spy(logits, top_k):
            p = torch.softmax(logits.float(), -1).sort(-1, descending=True)
            gap = float((p.values[:, top_k - 1] - p.values[:, top_k]).min())
            self.min = min(self.min, gap)
            return self._route(logits, top_k)

        tmoe._route = spy
        return self

    def __exit__(self, *exc):
        tmoe._route = self._route


def _check_margin(tc, margins, dtype):
    if tc.family == "moe" and dtype == "bfloat16":
        assert margins.min >= MARGIN, (
            f"a routing decision {margins.min:.2g} from a tie: bf16 parity "
            "with JAX does not hold there")


def check_forward_matches_jax(arch, dtype):
    model, tc, toks, enc = _port(arch, dtype)
    _, _, _, full, _ = _jax_run(arch, dtype)
    with Margins() as margins:
        got = T.forward(model, torch.from_numpy(toks), tc, enc_inputs=enc)
    _check_margin(tc, margins, dtype)
    assert got.dtype == tc.tdtype and got.shape == (B, S, tc.vocab)
    np.testing.assert_allclose(f32(got), full, **TOL[dtype])


def check_decode_steps_match_jax(arch, dtype):
    """Teacher-forced steps: logits and every cache and recurrent state
    after each step, the state tensors written in place."""
    model, tc, toks, enc = _port(arch, dtype)
    _, _, _, _, steps = _jax_run(arch, dtype)
    state = _port_state(model, tc, enc, S)
    ptrs = [t.data_ptr() for _, t in T.state_items(state)]
    with Margins() as margins:
        for t, (lg, jstate) in enumerate(steps):
            got, out = T.decode_step(model, state, torch.from_numpy(
                toks[:, t:t + 1]), t, tc)
            assert out is state
            np.testing.assert_allclose(f32(got), lg, **TOL[dtype])
            for path, x in T.state_items(state):
                np.testing.assert_allclose(f32(x), _at(jstate, path),
                                           err_msg=str(path),
                                           **STATE_TOL[dtype])
    _check_margin(tc, margins, dtype)
    assert [t.data_ptr() for _, t in T.state_items(state)] == ptrs


def check_port_decode_matches_port_forward(arch, dtype):
    model, tc, toks, enc = _port(arch, dtype, no_drops=True)
    full = T.forward(model, torch.from_numpy(toks), tc, enc_inputs=enc)
    state = _port_state(model, tc, enc, S)
    outs = []
    for t in range(S):
        lg, state = T.decode_step(model, state,
                                  torch.from_numpy(toks[:, t:t + 1]), t, tc)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(f32(torch.stack(outs, 1)), f32(full),
                               **TOL[dtype])


def check_params_cover_the_jax_tree(arch):
    """The port's module tree holds every leaf of the JAX package's tree,
    each with its shape and dtype, and nothing else; ``init_params_shape``
    allocates nothing."""
    jc, tc = _cfgs(arch, "bfloat16")
    leaves = jax.tree_util.tree_leaves_with_path(
        jax.eval_shape(lambda: j_init_params(jc, jax.random.key(0))))
    want = {}
    for path, leaf in leaves:
        keys = [p.key for p in path]
        for layer in range(leaf.shape[0] if _stacked(keys) else 1):
            name = _port_name(keys, layer if _stacked(keys) else None)
            shape = leaf.shape[1:] if _stacked(keys) else leaf.shape
            want[name] = (tuple(shape), str(leaf.dtype))
    model = T.init_params_shape(tc)
    got = {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
           for n, p in model.named_parameters()}
    assert got == want
    assert all(p.device.type == "meta" for p in model.parameters())


def _stacked(keys) -> bool:
    return keys[0] in ("layers", "enc_layers", "super", "tail")


def _port_name(keys, layer) -> str:
    if layer is None:
        return ".".join(keys)
    return ".".join([keys[0], str(layer)] + keys[1:])


def check_init_follows_the_references_distributions(arch):
    """Norms 0, the family's constants exact, projections at 1 / fan_in
    (and the embedding at 0.02^2) in variance."""
    tc = tconfigs.smoke_config(arch).scaled(dtype="float32")
    model = T.init_params(tc, torch.Generator().manual_seed(3), device=CPU)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "lam":
            torch.testing.assert_close(
                p, torch.linspace(0.5, 4.0, p.shape[0]))
        elif leaf in T._CONST or leaf.startswith("mu_"):
            want = 0.5 if leaf.startswith("mu_") else T._CONST[leaf]
            assert torch.all(p == want), name
        elif leaf.startswith("ln"):
            assert torch.all(p == 0), name
        elif p.numel() >= 4096:
            scale = T._SCALE.get(leaf, p.shape[-2] ** -0.5)
            assert abs(float(p.std()) / scale - 1) < 0.1, name


def check_new_model_refuses_a_config_of_another_family():
    with pytest.raises(ValueError, match="new_model"):
        T.MoELM(tconfigs.smoke_config("rwkv6-7b"), device=CPU)
    assert isinstance(T.new_model(tconfigs.smoke_config("rwkv6-7b"),
                                  device="meta"), T.RWKVLM)


def check_launcher_serves_and_swaps_in_place(arch):
    """``launch.serve.serve`` on the family: two tenants through one set
    of weight and state tensors, zeroed in place between them (the serve
    function itself raises if a ``data_ptr`` moved); every generated token
    is the argmax of a teacher-forced step over the tokens before it."""
    from repro_torch.launch import serve as tserve

    cfg = tconfigs.smoke_config(arch).scaled(dtype="float32")
    model, state, runs = tserve.serve(cfg, batch=2, prompt_len=3, gen=4,
                                      swaps=2, seed=5, device=CPU)
    assert not torch.equal(runs[0].tokens, runs[1].tokens)
    run = runs[1]
    st = _port_state(model, cfg, run.enc_inputs, run.fed.shape[1])
    for t in range(run.fed.shape[1]):
        lg, st = T.decode_step(model, st, run.fed[:, t:t + 1], t, cfg)
        if t >= run.prompt_len - 1:
            assert torch.equal(lg[:, 0].argmax(-1), run.tokens[:, t + 1])


def check_config_fields_name_the_family(arch):
    cfg = tconfigs.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jconfigs.get_config(arch))
    assert cfg.family in ("moe", "hybrid", "rwkv", "encdec")
