"""The port's MoE routing and FFN against the JAX package's.

``router_dispatch`` and ``moe_ffn`` (``impl="onehot"`` and ``"sort"``) get
the same numpy inputs, made from a seed, as ``repro.models.moe``, at
capacity factors 1.0, 1.25 and 2.0 with tokens dropped (each case asserts
that some are), and at the capacity of one slot an expert that qwen3-moe's
decode runs at B 16 (``int(16 * 8 / 128 * 1.25) = 1``).  The router's
probabilities are distinct in every case (asserted): ``jax.lax.top_k``
breaks ties toward the lower index and ``torch.topk`` promises no order, so
only distinct probabilities pin one routing.  Tolerances: f32 atol/rtol
1e-4 (summation order), bf16 0.12 / 0.05 (the JAX package's LM bound);
dispatch is exact, combine and aux within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=0.12, rtol=0.05)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _distinct(logits: np.ndarray, k: int) -> None:
    """The k-th and (k+1)-th router probabilities differ in every row."""
    p = np.sort(np.exp(logits - logits.max(-1, keepdims=True)), -1)[:, ::-1]
    assert (p[:, k - 1] - p[:, k] > 1e-6 * p[:, 0]).all()


def _case(T, E, D, F, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, T, D)).astype(np.float32)
    params = {"router": rng.normal(size=(D, E)).astype(np.float32) * D ** -0.5,
              "wg": rng.normal(size=(E, D, F)).astype(np.float32) * D ** -0.5,
              "wu": rng.normal(size=(E, D, F)).astype(np.float32) * D ** -0.5,
              "wd": rng.normal(size=(E, F, D)).astype(np.float32) * F ** -0.5}
    jx = jnp.asarray(x, JDT[dtype])
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else JDT[dtype])
          for k, v in params.items()}
    tx = torch.from_numpy(f32(jx)).to(TDT[dtype])
    tp = {k: torch.from_numpy(f32(v)).to(torch.float32 if k == "router"
                                         else TDT[dtype])
          for k, v in jp.items()}
    return jx, jp, tx, tp


CFS = [1.0, 1.25, 2.0]


@pytest.mark.parametrize("cf", CFS)
def test_router_dispatch_equals_jax(cf):
    T, E, k = 48, 8, 2
    logits = np.random.default_rng(5).normal(size=(T, E)).astype(np.float32)
    _distinct(logits, k)
    C = max(int(T * k / E * cf), 1)
    jd, jc, ja = jmoe.router_dispatch(jnp.asarray(logits), k, C)
    td, tc, ta = tmoe.router_dispatch(torch.from_numpy(logits), k, C)
    np.testing.assert_array_equal(f32(td), f32(jd))
    np.testing.assert_allclose(f32(tc), f32(jc), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    if cf < 2.0:
        assert f32(td).sum() < T * k       # tokens were dropped
    assert f32(td).sum(axis=0).max() <= 1  # one token a slot


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["onehot", "sort"])
@pytest.mark.parametrize("cf", CFS)
def test_moe_ffn_equals_jax(cf, impl, dtype):
    T, E, D, F, k = 40, 8, 32, 64, 2
    jx, jp, tx, tp = _case(T, E, D, F, seed=1, dtype=dtype)
    _distinct(f32(jx)[0] @ f32(jp["router"]), k)
    want, wa = jmoe.moe_ffn(jx, jp, top_k=k, capacity_factor=cf, impl=impl)
    got, ga = tmoe.moe_ffn(tx, tp, top_k=k, capacity_factor=cf, impl=impl)
    assert got.dtype == TDT[dtype] and got.shape == tx.shape
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])
    np.testing.assert_allclose(float(ga), float(wa), rtol=1e-5)


@pytest.mark.parametrize("cf", CFS)
def test_port_sort_equals_port_onehot(cf):
    """tests/test_moe_impl.py's equivalence on the port alone."""
    _, _, tx, tp = _case(32, 8, 32, 64, seed=2)
    y1, a1 = tmoe.moe_ffn(tx, tp, top_k=2, capacity_factor=cf, impl="onehot")
    y2, a2 = tmoe.moe_ffn(tx, tp, top_k=2, capacity_factor=cf, impl="sort")
    torch.testing.assert_close(y2, y1, atol=3e-5, rtol=0)
    torch.testing.assert_close(a2, a1, rtol=1e-5, atol=0)


@pytest.mark.parametrize("impl", ["onehot", "sort"])
def test_capacity_one_at_qwen3_decode(impl):
    """qwen3-moe's decode at B 16: 128 experts, top 8, one slot an expert.
    Most of the routing is drops, and arrival order (token-major) decides
    who keeps a slot: each kept (token, expert) is the expert's first
    arrival."""
    T, E, D, F, k, cf = 16, 128, 32, 16, 8, 1.25
    assert max(int(T * k / E * cf), 1) == 1
    jx, jp, tx, tp = _case(T, E, D, F, seed=3)
    logits = f32(jx)[0] @ f32(jp["router"])
    _distinct(logits, k)
    disp, _, _ = tmoe.router_dispatch(torch.from_numpy(logits), k, 1)
    jdisp, _, _ = jmoe.router_dispatch(jnp.asarray(logits), k, 1)
    np.testing.assert_array_equal(f32(disp), f32(jdisp))
    chosen = np.argsort(-logits, axis=-1, kind="stable")[:, :k]
    first = {}
    for t in range(T):
        for e in chosen[t]:
            first.setdefault(int(e), t)
    kept = {(t, e) for e, t in first.items()}
    assert {tuple(x) for x in np.argwhere(f32(disp)[:, :, 0] > 0)} == kept
    assert len(kept) < T * k
    want, _ = jmoe.moe_ffn(jx, jp, top_k=k, capacity_factor=cf, impl=impl)
    got, _ = tmoe.moe_ffn(tx, tp, top_k=k, capacity_factor=cf, impl=impl)
    np.testing.assert_allclose(f32(got), f32(want), **TOL["float32"])


def test_sort_sharded_needs_a_mesh():
    _, _, tx, tp = _case(8, 4, 16, 32, seed=4)
    with pytest.raises(ValueError, match="mesh"):
        tmoe.moe_ffn(tx, tp, top_k=2, capacity_factor=1.0,
                     impl="sort_sharded")
