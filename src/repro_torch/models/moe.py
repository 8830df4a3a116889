"""Mixture-of-Experts FFN with capacity-buffer dispatch (GShard/Switch
style): grok-1 (8 experts, top 2) and qwen3-moe (128 experts, top 8).

Port of ``src/repro/models/moe.py``: ``router_dispatch`` (:18),
``moe_ffn`` (:52) with ``impl="onehot"`` (dense dispatch/combine einsums)
and ``impl="sort"`` (``_moe_ffn_sort`` :86: argsort by expert, scatter into
per-expert buffers, gather-combine).  ``impl="sort_sharded"`` constrains
the buffers' sharding over a JAX mesh and has no meaning here: it raises
``ValueError``.  The expert contractions are ``torch.einsum``, as the JAX
package computes them outside any Pallas kernel.

Tokens over an expert's capacity are dropped, in arrival order: token-major,
then the token's k slots (``moe.py:30-33``).  Two conventions kept by hand:

* ``jax.nn.one_hot`` of an index at or past ``capacity`` gives a zero row
  (that is how a dropped token vanishes); ``torch.nn.functional.one_hot``
  raises there, so the position is clamped and the row masked by ``keep``;
* ``jax.lax.top_k`` breaks ties toward the lower index, and ``torch.topk``
  promises no order among ties: the two agree only where the router's
  probabilities are distinct, which the parity tests' inputs are.

On DTensors ``moe_ffn`` hands each device's tokens and experts to
``distributed.dtensor.moe_ffn``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import dtensor as _dt

__all__ = ["moe_ffn", "router_dispatch", "dispatch_slots", "check_impl"]


def _route(logits: torch.Tensor, top_k: int):
    """logits [T, E] -> (probs [T, E], normalised gates [T, k], experts
    [T, k]), all float32 but the experts (int64)."""
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, expert_idx


def _aux(probs: torch.Tensor, expert_idx: torch.Tensor) -> torch.Tensor:
    """Switch's load-balance loss: E * sum_e f_e * p_e."""
    E = probs.shape[-1]
    onehot = F.one_hot(expert_idx, E).float()
    f = onehot.sum(dim=(0, 1)) / expert_idx.numel()
    return E * torch.sum(f * probs.mean(dim=0))


def router_dispatch(logits: torch.Tensor, top_k: int, capacity: int):
    """logits [T, E] -> (dispatch [T, E, C], combine [T, E, C] f32, aux).

    Position-in-expert via cumsum over (token, k) arrival order; tokens
    whose slot >= capacity are dropped."""
    T, E = logits.shape
    probs, gate_vals, expert_idx = _route(logits, top_k)
    dispatch, combine = dispatch_slots(expert_idx, gate_vals, E, capacity)
    return dispatch, combine, _aux(probs, expert_idx)


def dispatch_slots(expert_idx: torch.Tensor, gate_vals: torch.Tensor,
                   E: int, capacity: int, first: int | None = None):
    """Every token's experts int [T, k] -> (dispatch, combine) [T', E, C]
    of the tokens whose gates ``gate_vals`` [T', k] are: all T (``first``
    None), or the T' from row ``first`` on.  A token's slot in an expert
    counts the tokens before it in the whole batch either way."""
    T, top_k = expert_idx.shape
    onehot = F.one_hot(expert_idx, E).float()                 # [T, k, E]
    flat = onehot.reshape(T * top_k, E)
    pos_in_expert = (torch.cumsum(flat, dim=0) - flat).reshape(T, top_k, E)
    pos = (pos_in_expert * onehot).sum(-1)                    # [T, k]
    if first is not None:
        rows = slice(first, first + gate_vals.shape[0])
        onehot, pos = onehot[rows], pos[rows]
    keep = (pos < capacity).float()
    pos_oh = F.one_hot(pos.long().clamp_max(capacity - 1),
                       capacity).float() * keep[..., None]
    disp_k = onehot[..., None] * pos_oh[:, :, None, :]
    dispatch = disp_k.sum(dim=1)                              # [T', E, C]
    combine = (disp_k * gate_vals[..., None, None]).sum(dim=1)
    return dispatch, combine


def _experts(xe: torch.Tensor, params) -> torch.Tensor:
    """SwiGLU of every expert on its buffer: xe [E, C, D] -> [E, C, D]."""
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, params["wg"])) * \
        torch.einsum("ecd,edf->ecf", xe, params["wu"])
    return torch.einsum("ecf,efd->ecd", h, params["wd"])


def check_impl(impl: str) -> None:
    """Raise unless the port runs the dispatch ``impl``."""
    if impl not in ("onehot", "sort"):
        raise ValueError(f"moe impl {impl!r}: the port runs 'onehot' and "
                         "'sort' ('sort_sharded' needs a JAX mesh)")


def moe_ffn(x: torch.Tensor, params, *, top_k: int, capacity_factor: float,
            impl: str = "onehot"):
    """x [B, S, D]; params (a dict or a module with ``[]``): router
    [D, E] f32, wg/wu [E, D, F], wd [E, F, D].  Returns (y [B, S, D],
    aux)."""
    check_impl(impl)
    if _dt.is_dtensor(x):
        return _dt.moe_ffn(x, params, top_k=top_k,
                           capacity_factor=capacity_factor, impl=impl)
    if impl == "sort":
        return _moe_ffn_sort(x, params, top_k=top_k,
                             capacity_factor=capacity_factor)
    B, S, D = x.shape
    E = params["router"].shape[1]
    T = B * S
    xt = x.reshape(T, D)
    logits = xt.float() @ params["router"].float()
    capacity = max(int(T * top_k / E * capacity_factor), 1)
    dispatch, combine, aux = router_dispatch(logits, top_k, capacity)
    xe = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), xt)
    ye = _experts(xe, params)
    y = torch.einsum("tec,ecd->td", combine.to(x.dtype), ye)
    return y.reshape(B, S, D), aux


def _moe_ffn_sort(x: torch.Tensor, params, *, top_k: int,
                  capacity_factor: float):
    """Sort-based dispatch: the same capacity and drops as onehot, routed by
    a stable argsort by expert, a scatter into [E * C + 1, D] buffers (the
    last row takes the drops) and a gather-combine."""
    B, S, D = x.shape
    E = params["router"].shape[1]
    T = B * S
    xt = x.reshape(T, D)
    logits = xt.float() @ params["router"].float()
    probs, gate_vals, expert_idx = _route(logits, top_k)
    C = max(int(T * top_k / E * capacity_factor), 1)

    N = T * top_k
    flat_e = expert_idx.reshape(N)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(top_k)
    flat_g = gate_vals.reshape(N)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    start = torch.searchsorted(se, torch.arange(E, device=x.device))
    pos = torch.arange(N, device=x.device) - start[se]
    slot = torch.where(pos < C, se * C + pos, E * C)            # drop row

    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf[slot] = xt[st]
    ye = _experts(buf[:E * C].reshape(E, C, D), params).reshape(E * C, D)
    ye = torch.cat([ye, ye.new_zeros((1, D))], dim=0)
    contrib = ye[slot] * sg[:, None].to(ye.dtype)               # [N, D]
    y = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    y.index_add_(0, st, contrib.to(x.dtype))
    return y.reshape(B, S, D), _aux(probs, expert_idx)
