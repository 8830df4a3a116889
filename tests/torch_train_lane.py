"""The port's training stack held to the JAX package on the CPU, at the
smoke configs: the shared body of ``test_torch_train.py`` (the dense
archs), ``test_torch_train_moe.py``, ``test_torch_train_encdec.py``,
``test_torch_train_recurrent.py`` (the hybrid arch) and
``test_torch_train_rwkv.py``, so the archs spread over the test workers.

The JAX package's weights (``init_params``, key 0) cross to the port by
``params_from_numpy``; tokens, labels and whisper's encoder frames are
numpy draws from a seed.  Three holds, kept apart (an AdamW step is fragile
to compare across packages: at step 1, m_hat / sqrt(v_hat) = g / |g|, so an
element whose gradient sits at the noise of summation order can flip sign
between the packages and then moves by 2 lr on a correct port):

1. ``loss_fn`` and its gradients against ``jax.value_and_grad(loss_fn)``
   in f32 at atol 1e-4 / rtol 1e-4, each leaf scaled by its largest |g|;
2. ``adamw_update`` on identical (numpy) gradients to 1e-6;
3. the whole ``make_train_step`` (n_micro 2): loss and ``grad_norm`` at
   1e-4, the parameters at 1e-4 wherever |g| is above 1e-3 x the leaf's
   largest |g| or exactly 0 (weight decay alone moves those); the elements
   left out are counted, printed and bounded (at most 5%; 0.9-2.5% seen).

Beside them, the port against itself: gradients with ``remat`` on equal
those with it off, bit for bit; ``n_micro`` 4 equals 1
(``tests/test_train.py:24``); the loss falls over 15 steps (``:46``); and
``LM.tree()`` gives back ``init_params``'s tree key for key.  One bf16
step per family is held at the LM lane's bound, 0.12 / 0.05
(``torch_lm_families_lane.py``), its JAX side compiled with
``xla_allow_excess_precision`` off.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_params as j_init_params
from repro.optim import adamw as jadamw
from repro.train.step import loss_fn as j_loss_fn
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import configs as tconfigs
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as tadamw
from repro_torch.train.step import loss_fn, make_train_step

CPU = torch.device("cpu")
B, S = 4, 16
N_MICRO = 2
TOL = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=0.12, rtol=0.05)
ADAM_TOL = dict(atol=1e-6, rtol=1e-6)
# hold 3: parameters compared where |g| > MASK x the leaf's largest |g| or
# g == 0; at most LEFT_OUT of all elements may be left out
MASK = 1e-3
LEFT_OUT = 0.05
EXACT = {"xla_allow_excess_precision": False}
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=40)
# JAX's update, compiled once a tree structure and config (the dense archs'
# smoke trees are alike)
J_UPDATE = jax.jit(jadamw.adamw_update, static_argnums=3)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test's torch work on one intra-op thread: the suite runs six
    workers on the machine's cores, and torch's thread pool in each of them
    (a thread a core) makes a train step on the smoke configs 100x slower
    than alone (678 s against 5 s for the launcher's test, six at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32", moe_impl=None, no_drops=False):
    kw = {"dtype": dtype}
    if moe_impl:
        kw["moe_impl"] = moe_impl
    if no_drops:
        kw["capacity_factor"] = float(jconfigs.smoke_config(arch).n_experts)
    return (jconfigs.smoke_config(arch).scaled(**kw),
            tconfigs.smoke_config(arch).scaled(**kw))


def _leaves(tree):
    """('a/b', leaf) of a nested dict, in ``jax.tree.leaves``' order."""
    return [("/".join(str(k.key) for k in path), leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree)]


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _inputs(arch, dtype="float32"):
    """The JAX weights (numpy), tokens and labels [N_MICRO, B / N_MICRO, S]
    and encoder frames."""
    jc, _ = _cfgs(arch, dtype)
    tree = jax.tree.map(np.asarray, j_init_params(jc, jax.random.key(0)))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jc.vocab, (N_MICRO, B // N_MICRO, S)).astype(
        np.int32)
    labs = rng.integers(0, jc.vocab, (N_MICRO, B // N_MICRO, S)).astype(
        np.int32)
    enc = None
    if jc.family == "encdec":
        enc = rng.normal(size=(N_MICRO, B // N_MICRO, jc.enc_seq,
                               jc.d_model)).astype(np.float32)
    return tree, toks, labs, enc


def _flat(x):
    return None if x is None else x.reshape(-1, *x.shape[2:])


@functools.lru_cache(maxsize=None)
def _jax_grads(arch, moe_impl=None):
    """JAX's loss and gradients (numpy, by path) over the whole batch."""
    jc, _ = _cfgs(arch, moe_impl=moe_impl)
    tree, toks, labs, enc = _inputs(arch)
    e = _flat(enc)
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, t, l, e: j_loss_fn(p, t, l, jc, enc_inputs=e,
                                     remat=False)))(
        tree, _flat(toks), _flat(labs), e)
    return float(loss), dict(_leaves(jax.tree.map(np.asarray, g)))


def _port(arch, dtype="float32", moe_impl=None, no_drops=False):
    _, tc = _cfgs(arch, dtype, moe_impl, no_drops)
    tree, toks, labs, enc = _inputs(arch, dtype)
    model = T.params_from_numpy(tree, tc, device=CPU)
    tenc = None if enc is None else torch.from_numpy(enc).to(tc.tdtype)
    return model, tc, torch.from_numpy(toks), torch.from_numpy(labs), tenc


def _port_grads(arch, remat, moe_impl=None):
    model, tc, toks, labs, enc = _port(arch, moe_impl=moe_impl)
    model.trainable_()
    loss = loss_fn(model, toks.reshape(B, S), labs.reshape(B, S), tc,
                   enc_inputs=None if enc is None else enc.reshape(
                       B, *enc.shape[2:]), remat=remat)
    names, weights = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, weights)
    tree = T.tree_of(zip(names, grads))
    return float(loss.detach()), dict(_leaves(tree)), grads


def check_loss_and_grads_match_jax(arch, moe_impl=None):
    want_loss, want = _jax_grads(arch, moe_impl)
    got_loss, got, _ = _port_grads(arch, remat=True, moe_impl=moe_impl)
    np.testing.assert_allclose(got_loss, want_loss, **TOL)
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k] / scale, w / scale, err_msg=k,
                                   **TOL)


def check_remat_on_equals_off(arch):
    on_loss, _, on = _port_grads(arch, remat=True)
    off_loss, _, off = _port_grads(arch, remat=False)
    assert on_loss == off_loss
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def check_adamw_on_identical_grads(arch, state_dtype="float32"):
    """Two updates of each package from the same weights, state and
    gradients (JAX's), the port's weights and moments set to JAX's between
    them.  The weights and the f32 moments at 1e-6; bf16 moments within
    one bf16 unit in the last place (each package rounds its f32 moment,
    which may differ in the last f32 bit, to bf16)."""
    tree, *_ = _inputs(arch)
    _, grads = _jax_grads(arch)
    _, tc = _cfgs(arch)
    jcfg = jadamw.AdamWConfig(state_dtype=state_dtype, clip_norm=0.5, **OPT)
    tcfg = tadamw.AdamWConfig(state_dtype=state_dtype, clip_norm=0.5, **OPT)
    model = T.params_from_numpy(tree, tc, device=CPU)
    gtree = _nest(grads)
    tgrads = {n: torch.tensor(T.leaf_of(gtree, n))
              for n, _ in model.named_parameters()}
    jgrads = jax.tree.map(jnp.asarray, gtree)
    jp, jo = tree, jadamw.adamw_init(tree, jcfg)
    to = tadamw.adamw_init(model, tcfg)
    moment_tol = ADAM_TOL if state_dtype == "float32" else dict(
        atol=1e-6, rtol=2 ** -8)
    for _ in range(2):
        jp, jo, jm = J_UPDATE(jgrads, jo, jp, jcfg)
        _, to, tm = tadamw.adamw_update(tgrads, to, model, tcfg)
        np.testing.assert_allclose(f32(tm["grad_norm"]), f32(jm["grad_norm"]),
                                   rtol=1e-6)
        assert float(jm["grad_norm"]) > 0.5       # clipping active
        np.testing.assert_allclose(f32(tm["lr"]), f32(jm["lr"]), rtol=1e-6)
        got = model.tree()
        for k, w in _leaves(jp):
            np.testing.assert_allclose(_get(got, k), f32(w), err_msg=k,
                                       **ADAM_TOL)
        for part in ("m", "v"):
            assert {str(t.dtype) for t in to[part].values()} == {
                f"torch.{state_dtype}"}
            got = T.tree_of(to[part].items())
            for k, w in _leaves(jo[part]):
                np.testing.assert_allclose(_get(got, k), f32(w),
                                           err_msg=f"{part}/{k}",
                                           **moment_tol)
        assert int(to["step"]) == int(jo["step"])
        # the next update from identical inputs
        model.load_(jax.tree.map(np.asarray, jp))
        with torch.no_grad():
            for part in ("m", "v"):
                mt = jax.tree.map(f32, jo[part])
                for n, t in to[part].items():
                    t.copy_(torch.as_tensor(T.leaf_of(mt, n)))


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, a in flat.items():
        *path, last = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = a
    return tree


def _get(tree, key):
    for k in key.split("/"):
        tree = tree[k]
    return tree


def _batch(toks, labs, enc):
    b = {"tokens": toks, "labels": labs}
    if enc is not None:
        b["enc_inputs"] = enc
    return b


def _jax_step(arch, dtype):
    jc, _ = _cfgs(arch, dtype)
    tree, toks, labs, enc = _inputs(arch, dtype)
    ocfg = jadamw.AdamWConfig(**OPT)
    params = jax.tree.map(jnp.asarray, tree)
    opt = jadamw.adamw_init(params, ocfg)
    batch = _batch(toks, labs, None if enc is None
                   else jnp.asarray(enc, jc.jdtype))
    step = j_make_train_step(jc, ocfg, n_micro=N_MICRO,
                             has_enc=jc.family == "encdec")
    fn = jax.jit(step).lower(params, opt, batch).compile(
        compiler_options=EXACT)
    return fn(params, opt, batch)


def _port_step(arch, dtype, n_micro=N_MICRO, no_drops=False):
    model, tc, toks, labs, enc = _port(arch, dtype, no_drops=no_drops)
    ocfg = tadamw.AdamWConfig(**OPT)
    opt = tadamw.adamw_init(model, ocfg)
    shape = (n_micro, B // n_micro)
    batch = _batch(toks.reshape(*shape, S), labs.reshape(*shape, S),
                   None if enc is None else enc.reshape(*shape,
                                                        *enc.shape[2:]))
    step = make_train_step(tc, ocfg, n_micro=n_micro,
                           has_enc=tc.family == "encdec")
    ptrs = [p.data_ptr() for p in model.parameters()]
    model, opt, m = step(model, opt, batch)
    assert [p.data_ptr() for p in model.parameters()] == ptrs
    return model, opt, m


def check_train_step_matches_jax(arch):
    jp, jo, jm = _jax_step(arch, "float32")
    model, opt, m = _port_step(arch, "float32")
    np.testing.assert_allclose(f32(m["loss"]), f32(jm["loss"]), **TOL)
    np.testing.assert_allclose(f32(m["grad_norm"]), f32(jm["grad_norm"]),
                               **TOL)
    _, grads = _jax_grads(arch)
    got = model.tree()
    left, total = 0, 0
    for k, w in _leaves(jp):
        g = np.abs(grads[k])
        keep = (g == 0) | (g > MASK * g.max())   # g == 0: decay only
        np.testing.assert_allclose(_get(got, k)[keep], f32(w)[keep],
                                   err_msg=k, **TOL)
        left += int((~keep).sum())
        total += keep.size
    print(f"{arch}: {left} of {total} elements left out (|g| <= {MASK} x "
          "the leaf's largest)")
    assert left <= LEFT_OUT * total
    assert int(opt["step"]) == int(jo["step"]) == 1


def check_bf16_step_matches_jax(arch):
    jp, _, jm = _jax_step(arch, "bfloat16")
    model, _, m = _port_step(arch, "bfloat16")
    np.testing.assert_allclose(f32(m["loss"]), f32(jm["loss"]), **BF16)
    np.testing.assert_allclose(f32(m["grad_norm"]), f32(jm["grad_norm"]),
                               **BF16)
    got = model.tree()
    for k, w in _leaves(jp):
        assert _get(got, k).shape == w.shape
        np.testing.assert_allclose(_get(got, k), f32(w), err_msg=k, **BF16)


def check_grad_accum_equals_single_batch(arch):
    """n_micro 4 microbatches give the update of one batch (the bf16
    smoke config, the reference's bound).  A moe config routes without
    drops here: an expert's capacity follows the tokens routed at once, so
    4 microbatches drop other tokens than one batch does."""
    m1, _, a = _port_step(arch, "bfloat16", n_micro=1, no_drops=True)
    m4, _, b = _port_step(arch, "bfloat16", n_micro=4, no_drops=True)
    np.testing.assert_allclose(f32(a["loss"]), f32(b["loss"]), rtol=1e-5)
    d = max(float((p.detach().float() - q.detach().float()).abs().max())
            for p, q in zip(m1.parameters(), m4.parameters()))
    assert d < 3e-2          # bf16 weights: one ulp at their scale


def check_loss_decreases(arch):
    from repro_torch.data import TokenPipeline

    _, tc = _cfgs(arch, "bfloat16")
    model = T.init_params(tc, torch.Generator().manual_seed(0), device=CPU)
    ocfg = tadamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=40)
    opt = tadamw.adamw_init(model, ocfg)
    step = make_train_step(tc, ocfg, n_micro=1,
                           has_enc=tc.family == "encdec")
    tp = TokenPipeline(vocab_size=tc.vocab, seq_len=16, global_batch=8)
    enc = None
    if tc.family == "encdec":
        enc = torch.from_numpy(np.random.default_rng(3).normal(size=(
            1, 8, tc.enc_seq, tc.d_model)).astype(np.float32)).to(tc.tdtype)
    losses = []
    for _ in range(15):
        b = tp.next_batch()
        _, opt, m = step(model, opt, _batch(
            torch.from_numpy(b["tokens"])[None],
            torch.from_numpy(b["labels"])[None], enc))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1, losses


def check_tree_equals_init_params(arch):
    """``LM.tree()`` is ``init_params``'s tree, key for key, shape for
    shape and value for value (bfloat16 as float32)."""
    jc, tc = _cfgs(arch, "bfloat16")
    want = j_init_params(jc, jax.random.key(0))
    got = T.params_from_numpy(jax.tree.map(np.asarray, want), tc,
                              device=CPU).tree()
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    for k, w in _leaves(want):
        g = _get(got, k)
        assert g.shape == w.shape, k
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, f32(w), err_msg=k)
