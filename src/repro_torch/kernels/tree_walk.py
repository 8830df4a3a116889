"""The multi-layer tree walk in one launch (stage 1 of ``mode="unfused"``).

Replaces the Pallas TPU kernel ``tree_walk_pallas_v``
(``src/repro/kernels/tree_walk.py:94``).  The kernel is CUDA C++ in
``csrc/tree_walk.cu``; the note at its top says what bounds it on an H100
and what its design does about that.  This module holds:

* ``tree_walk`` — the wrapper.  On CUDA tensors it launches the kernel or
  raises; on CPU tensors it runs ``tree_walk_plain``.
  ``tree_walk.launches`` counts launches.
* ``tree_walk_plain`` — the kernel's plain torch version on the same
  operands: the walk records decoded back to source tables
  (``tiling.unpack_walk``) through the twin ``ref.tree_walk_v``.
* ``check_walk`` — the operand checks this kernel shares with
  ``tcam_match``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.launch import (
    check,
    launch,
    on_card,
    packets_per_block,
)
from repro_torch.kernels.tiling import WalkOperands, unpack_walk

__all__ = ["tree_walk", "tree_walk_plain", "check_walk", "SOURCE"]

SOURCE = "tree_walk"             # csrc/tree_walk.cu


def tree_walk_plain(codes, features, vid, layer_shift, ops: WalkOperands):
    """The kernel's function in plain torch, on the kernel's operands."""
    return ref.tree_walk_v(codes, features, vid, *unpack_walk(ops),
                           layer_shift)


def check_walk(codes, features, vid, layer_shift, ops: WalkOperands):
    """Raise unless the walk kernels can read these operands; returns
    (B, F, V, L, T, E)."""
    B, T = codes.shape
    F = features.shape[1]
    V, L, _, E, _ = ops.entries.shape
    i32 = torch.int32
    for name, x, dtype, shape in (
            ("codes", codes, i32, (B, T)),
            ("features", features, i32, (B, F)),
            ("vid", vid, i32, (B,)),
            ("layer_shift", layer_shift, i32, (L,)),
            ("entries", ops.entries, i32, (V, L, T, E, 4)),
            ("n_entries", ops.n_entries, i32, (V, L, T))):
        check(name, x, dtype, shape)
    if ops.entries.data_ptr() % 16:
        raise ValueError("entries must be 16-byte aligned (one record a load)")
    return B, F, V, L, T, E


def tree_walk(codes: torch.Tensor, features: torch.Tensor, vid: torch.Tensor,
              layer_shift: torch.Tensor, ops: WalkOperands) -> torch.Tensor:
    """All L layers of every tree in one launch.

    codes int32 [B, T] (uint32 bits), features int32 [B, F], vid int32 [B],
    layer_shift int32 [L], ``ops`` from ``tiling.prep_walk`` (or
    ``ExecImage.fused.walk``).  Returns the walked codes int32 [B, T].
    """
    if not on_card("tree_walk", codes=codes, features=features, vid=vid,
                   layer_shift=layer_shift, **ops._asdict()):
        return tree_walk_plain(codes, features, vid, layer_shift, ops)
    B, F, V, L, T, E = check_walk(codes, features, vid, layer_shift, ops)
    out = torch.empty((B, T), dtype=torch.int32, device=codes.device)
    if B == 0:
        return out
    launch(SOURCE, "acorn_tree_walk", codes.device, codes, features, vid,
           layer_shift, ops.entries, ops.n_entries, out, B, F, V, L, T, E,
           packets_per_block(T, F))
    tree_walk.launches += 1
    return out


tree_walk.launches = 0
