"""AdamW with configurable state dtype + global-norm clipping.

Port of ``src/repro/optim/adamw.py``.  ``state_dtype="bfloat16"`` halves
optimizer memory: the moments are stored in the chosen dtype, and the
update math runs in float32 (``adamw.py:63-74``).

The parameters are a module (its ``named_parameters()``) or a dict of
tensors, name -> tensor; the state is ``{"m": {name: tensor}, "v": {name:
tensor}, "step": int32 tensor}`` keyed like them.  Where JAX returns new
trees, ``adamw_update`` writes the parameters and the moments in place
(their ``data_ptr`` does not move) and returns the same objects.

The schedule and the bias corrections are float32 tensors computed from the
int32 ``step`` on its device, as the reference computes them (``:32-37``,
``:60-61``), never Python doubles.  The global norm sums the leaves in the
JAX tree's order: a port parameter ``layers.3.wq`` is layer 3 of the
reference's stacked leaf ``layers/wq`` (``models.transformer.tree_path``),
and the leaves go by their sorted paths, as ``jax.tree.leaves`` flattens a
dict.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.transformer import tree_path

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "lr_schedule",
           "named_tensors"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"     # "bfloat16" halves optimizer memory
    warmup_steps: int = 100
    total_steps: int = 10_000


def _state_dtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def named_tensors(params) -> dict[str, torch.Tensor]:
    """name -> tensor of a module's parameters, or of a dict as it is."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine from lr to 0.1 lr; ``step`` an int32
    tensor, the result float32 on its device."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    dt = _state_dtype(cfg)
    named = named_tensors(params)
    device = next(iter(named.values())).device
    return {"m": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for n, p in named.items()},
            "v": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for n, p in named.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _leaf_order(names) -> list[list[str]]:
    """The names grouped by the JAX leaf they belong to, the groups in
    ``jax.tree.leaves``' order and each group in layer order."""
    groups: dict[tuple, list] = {}
    for n in names:
        path, layer = tree_path(n)
        groups.setdefault(path, []).append((-1 if layer is None else layer, n))
    return [[n for _, n in sorted(groups[p])] for p in sorted(groups)]


def _global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    sums = [torch.stack([torch.sum(torch.square(grads[n].float()))
                         for n in group]).sum()
            for group in _leaf_order(grads)]
    return torch.sqrt(torch.stack(sums).sum())


@torch.no_grad()
def adamw_update(grads: dict[str, torch.Tensor], opt_state: dict, params,
                 cfg: AdamWConfig):
    """One AdamW step with global-norm clipping at ``cfg.clip_norm``.
    Writes the parameters, ``m``, ``v`` and ``step`` in place; returns
    (params, opt_state, {"grad_norm", "lr"}), the metrics float32 tensors
    on the parameters' device."""
    named = named_tensors(params)
    step = opt_state["step"] + 1
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for name, p in named.items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        g = grads[name].float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        p32 = p.float()
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    opt_state["step"].copy_(step)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
