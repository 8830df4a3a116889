"""dt_predict + multitree_voting in one launch (stage 2 of the staged
classify modes).

Replaces the Pallas TPU kernel ``forest_predict_vote_pallas_v``
(``src/repro/kernels/forest_vote.py:69``).  The kernel is CUDA C++ in
``csrc/forest_vote.cu``; the note at its top says what bounds it on an H100
and what its design does about that: the fused kernel's leaf search (eight
lanes a (packet, tree)) and vote (a warp a packet, a lane a class).  This
module holds:

* ``forest_vote`` — the wrapper.  On CUDA tensors it launches the kernel or
  raises; on CPU tensors it runs ``forest_vote_plain``.
  ``forest_vote.launches`` counts launches.
* ``forest_vote_plain`` — the kernel's plain torch version on the same
  operands, through the twin ``ref.forest_predict_vote_v`` (leaf validity
  is folded into the labels, so every leaf counts as valid there).
* ``geometry`` — the launch's shape, plain Python; the C entry refuses any
  other.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.launch import check, launch, on_card
from repro_torch.kernels.tiling import LeafOperands

__all__ = ["forest_vote", "forest_vote_plain", "geometry", "Geometry",
           "SOURCE"]

SOURCE = "forest_vote"           # csrc/forest_vote.cu

# csrc/forest_vote.cu's constants
LANES = 8                        # lanes that search one (packet, tree)
THREADS = 128                    # threads a block, 4 warps
GROUPS = THREADS // LANES        # lane groups a block
SMS = 132                        # H100 SXM
WAVES = 2                        # the grid: at least two blocks an SM
SMEM_BYTES = 48 * 1024           # static limit, no opt-in attribute needed


class Geometry(NamedTuple):
    """One launch's shape (see ``geometry``)."""

    packets: int       # packets a block
    blocks: int        # the grid
    threads: int       # threads a block
    smem: int          # shared memory a block, bytes: the per-tree labels


def geometry(B: int, T: int) -> Geometry:
    """The kernel's launch for B packets of T trees: a group of ``LANES``
    lanes per (packet, tree) and a warp per packet's vote; as many packets
    a block as give every group a pair, but no more than keep the grid at
    ``WAVES`` blocks on each of ``SMS`` SMs, nor than fit their T labels in
    48 KB.  At least one packet."""
    if T < 1:
        raise ValueError(f"need a tree, got T {T}")
    cap = SMEM_BYTES // 4 // T
    if cap < 1:
        raise ValueError(f"{T} labels per packet do not fit one block's "
                         "shared memory")
    pb = max(1, min(cap, -(-GROUPS // T), B // (WAVES * SMS)))
    return Geometry(pb, -(-B // pb), THREADS, pb * T * 4)


def forest_vote_plain(codes, vid, ops: LeafOperands, n_classes: int):
    """The kernel's function in plain torch, on the kernel's operands."""
    pred_valid = torch.ones_like(ops.pred_labels, dtype=torch.bool)
    return ref.forest_predict_vote_v(codes, vid, ops.pred_codes,
                                     ops.pred_labels, pred_valid, ops.weights,
                                     n_classes)


def forest_vote(codes: torch.Tensor, vid: torch.Tensor, ops: LeafOperands,
                n_classes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Leaf lookup of every tree and the weighted vote, in one launch.

    codes int32 [B, T] (uint32 bits), vid int32 [B], ``ops`` from
    ``tiling.prep_leaves`` (or ``ExecImage.fused.leaves``).  Returns (label
    int32 [B], per-tree labels int32 [B, T]).
    """
    if not on_card("forest_vote", codes=codes, vid=vid, **ops._asdict()):
        return forest_vote_plain(codes, vid, ops, n_classes)
    B, T = codes.shape
    V, _, P = ops.pred_codes.shape
    i32 = torch.int32
    for name, x, dtype, shape in (
            ("codes", codes, i32, (B, T)),
            ("vid", vid, i32, (B,)),
            ("pred_codes", ops.pred_codes, i32, (V, T, P)),
            ("pred_labels", ops.pred_labels, i32, (V, T, P)),
            ("weights", ops.weights, torch.float32, (V, T))):
        check(name, x, dtype, shape)
    if P < 1:
        raise ValueError("need at least one leaf slot per tree")
    label = torch.empty((B,), dtype=i32, device=codes.device)
    per_tree = torch.empty((B, T), dtype=i32, device=codes.device)
    if B == 0:
        return label, per_tree
    launch(SOURCE, "acorn_forest_vote", codes.device, codes, vid,
           ops.pred_codes, ops.pred_labels, ops.weights, label, per_tree, B,
           V, T, P, n_classes, geometry(B, T).packets)
    forest_vote.launches += 1
    return label, per_tree


forest_vote.launches = 0
