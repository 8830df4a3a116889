"""Training step: CE loss, gradient accumulation, AdamW.

Port of ``src/repro/train/step.py``: ``loss_fn`` (:24), ``microbatch_plan``
(:35) and ``make_train_step`` (:46).  The reference's ``lax.scan`` over the
microbatch axis is a Python loop: activation memory is one microbatch's,
and ``remat=True`` recomputes each layer in backward
(``models.transformer.forward``).

Each microbatch's gradient is taken with ``torch.autograd.grad`` in the
parameters' dtype (bfloat16 for the real configs) and added into float32
accumulators, then scaled by ``1 / n_micro``, as the reference adds each
microbatch's gradient into f32 zeros inside its scan (:70-83); summing the
microbatches in ``.grad`` would add them in bfloat16.  The AdamW update then
writes the weights and the moments in place (``optim.adamw``).

Left out of ``make_train_step``'s signature: ``grad_specs`` (a GSPMD
sharding constraint on the accumulator, with the sharding specs of Queue 1
item 9c) and ``unroll`` (a ``lax.scan`` detail; the port's loops are
Python's).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import LM, forward
from repro_torch.optim.adamw import AdamWConfig, adamw_update

__all__ = ["loss_fn", "make_train_step", "microbatch_plan"]


def loss_fn(params: LM, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: ArchConfig, *, enc_inputs: torch.Tensor | None = None,
            q_chunk: int = 0, remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy of ``labels`` under the logits of
    ``tokens`` (both int [B, S]), computed in float32."""
    logits = forward(params, tokens, cfg, enc_inputs=enc_inputs,
                     q_chunk=q_chunk, remat=remat).float()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())
    return -ll.mean()


def microbatch_plan(cfg: ArchConfig, seq_len: int, global_batch: int,
                    dp_total: int, *, tokens_per_device: int = 8192) -> int:
    """n_micro so each device sees <= tokens_per_device tokens per
    microstep."""
    per_dev_seqs = max(global_batch // dp_total, 1)
    seqs_per_micro = max(tokens_per_device // seq_len, 1)
    n_micro = max(per_dev_seqs // seqs_per_micro, 1)
    while global_batch % (n_micro) != 0:  # keep the reshape exact
        n_micro -= 1
    return max(n_micro, 1)


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *, n_micro: int,
                    q_chunk: int = 0, remat: bool = True,
                    has_enc: bool = False):
    """Returns step(model, opt_state, batch) -> (model, opt_state, metrics).

    ``batch["tokens"]`` / ``["labels"]``: int [n_micro, B_mb, S]; with
    ``has_enc``, ``batch["enc_inputs"]``: [n_micro, B_mb, enc_seq, D] (the
    whisper stub).  The step turns the model's weights trainable and
    updates them and ``opt_state`` in place; ``metrics`` holds ``loss``,
    ``grad_norm`` and ``lr``, float32 tensors on the model's device (no
    host sync in the step).
    """

    def step(model: LM, opt_state: dict, batch: dict):
        model.trainable_(True)
        names, weights = zip(*model.named_parameters())
        grads = None
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=weights[0].device)
        for i in range(n_micro):
            enc = batch["enc_inputs"][i] if has_enc else None
            loss = loss_fn(model, batch["tokens"][i], batch["labels"][i], cfg,
                           enc_inputs=enc, q_chunk=q_chunk, remat=remat)
            g = torch.autograd.grad(loss, weights)
            if grads is None:          # 0 + g: the reference's f32 zeros
                grads = [x.float() if x.dtype != torch.float32 else x
                         for x in g]
            else:
                for acc, x in zip(grads, g):
                    acc.add_(x)
            del g
            loss_sum += loss.detach()
        inv = 1.0 / n_micro
        for acc in grads:
            acc.mul_(inv)
        loss = loss_sum * inv
        _, opt_state, om = adamw_update(dict(zip(names, grads)), opt_state,
                                        model, opt_cfg)
        return model, opt_state, {"loss": loss, **om}

    return step
