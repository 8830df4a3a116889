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

``grad_specs`` is the reference's sharding constraint on the gradient
accumulator, a spec tree of ``distributed.sharding`` (``param_specs``) for
``mesh`` (by default the one card's): the first step holds each spec to its
stacked leaf on the mesh (``ValueError`` naming the leaf) and refuses a mesh
of more than one real card (``NotImplementedError``); on one card the
constraint is the identity, as ``with_sharding_constraint`` is on one
device.  On a ``DeviceMesh`` over a fake process group (the dry run, the
weights DTensors laid out by ``distribute_model``) each microbatch's
gradient is redistributed to its spec's placements before it is added, as
the reference constrains each one (:61-63, :75); AdamW then runs on the
DTensors as it is.  Left out of the signature: ``unroll`` (a ``lax.scan``
detail; the port's loops are Python's).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import (
    check_specs,
    one_card_mesh,
    placements,
    require_one_card,
    stacked_shapes,
    tree_leaves,
)
from repro_torch.models.transformer import tree_path
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
                    has_enc: bool = False, grad_specs=None, mesh=None):
    """Returns step(model, opt_state, batch) -> (model, opt_state, metrics).

    ``batch["tokens"]`` / ``["labels"]``: int [n_micro, B_mb, S]; with
    ``has_enc``, ``batch["enc_inputs"]``: [n_micro, B_mb, enc_seq, D] (the
    whisper stub).  The step turns the model's weights trainable and
    updates them and ``opt_state`` in place; ``metrics`` holds ``loss``,
    ``grad_norm`` and ``lr``, float32 tensors on the model's device (no
    host sync in the step).  ``grad_specs`` / ``mesh``: see the module's
    docstring.
    """
    unchecked = [grad_specs is not None]
    sharded = grad_specs is not None and hasattr(mesh, "mesh_dim_names")

    def step(model: LM, opt_state: dict, batch: dict):
        if unchecked[0]:
            on = one_card_mesh() if mesh is None else mesh
            check_specs(stacked_shapes(model.named_parameters()), grad_specs,
                        on, "grad_specs")
            require_one_card(on, "grad_specs")
            unchecked[0] = False
        model.trainable_(True)
        names, weights = zip(*model.named_parameters())
        layout = _grad_layout(names, grad_specs, mesh) if sharded else None
        grads = loss_sum = None
        for i in range(n_micro):
            enc = batch["enc_inputs"][i] if has_enc else None
            loss = loss_fn(model, batch["tokens"][i], batch["labels"][i], cfg,
                           enc_inputs=enc, q_chunk=q_chunk, remat=remat)
            g = torch.autograd.grad(loss, weights)
            if layout is not None:
                g = [x.redistribute(mesh, pl) for x, pl in zip(g, layout)]
            if grads is None:          # 0 + g: the reference's f32 zeros
                grads = [x.float() if x.dtype != torch.float32 else x
                         for x in g]
            else:
                for acc, x in zip(grads, g):
                    acc.add_(x)
            del g
            # 0 + loss is loss: the first microbatch's loss starts the sum
            loss_sum = (loss.detach() if loss_sum is None
                        else loss_sum + loss.detach())
        inv = 1.0 / n_micro
        for acc in grads:
            acc.mul_(inv)
        loss = loss_sum * inv
        _, opt_state, om = adamw_update(dict(zip(names, grads)), opt_state,
                                        model, opt_cfg)
        return model, opt_state, {"loss": loss, **om}

    return step


def _grad_layout(names, grad_specs, mesh) -> list:
    """Each parameter's placements on ``mesh`` by its stacked leaf's spec
    in ``grad_specs`` (the leading layer axis dropped)."""
    spec_of = dict(tree_leaves(grad_specs))
    out = []
    for n in names:
        path, layer = tree_path(n)
        spec = spec_of[path]
        out.append(placements(spec if layer is None else spec[1:], mesh))
    return out
