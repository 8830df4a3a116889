"""The multi-layer tree walk in one launch (stage 1 of ``mode="unfused"``).

Replaces the Pallas TPU kernel ``tree_walk_pallas_v``
(``src/repro/kernels/tree_walk.py:94``).  The kernel is CUDA C++ in
``csrc/tree_walk.cu``; the note at its top says what bounds it on an H100
and what its design does about that: the fused kernel's walk alone, eight
lanes a (packet, tree) over all layers, layers empty for a whole warp
skipped.  This module holds:

* ``tree_walk`` — the wrapper.  On CUDA tensors it launches the kernel or
  raises; on CPU tensors it runs ``tree_walk_plain``.
  ``tree_walk.launches`` counts launches.
* ``tree_walk_plain`` — the kernel's plain torch version on the same
  operands: the walk records decoded back to source tables
  (``tiling.unpack_walk``) through the twin ``ref.tree_walk_v``.
* ``check_walk`` — the operand checks this kernel shares with
  ``tcam_match``.
* ``geometry`` — the launch's shape, plain Python; the C entry refuses any
  other.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.launch import check, launch, on_card
from repro_torch.kernels.tiling import WalkOperands, unpack_walk

__all__ = ["tree_walk", "tree_walk_plain", "check_walk", "geometry",
           "Geometry", "SOURCE"]

SOURCE = "tree_walk"             # csrc/tree_walk.cu

# csrc/tree_walk.cu's constants
LANES = 8                        # lanes that walk one (packet, tree)
THREADS = 128                    # threads a block, 4 warps, all walking
GROUPS = THREADS // LANES        # lane groups a block
SMS = 132                        # H100 SXM
WAVES = 2                        # the grid: at least two blocks an SM
SMEM_BYTES = 48 * 1024           # static limit, no opt-in attribute needed


class Geometry(NamedTuple):
    """One launch's shape (see ``geometry``)."""

    packets: int       # packets a block
    blocks: int        # the grid
    threads: int       # threads a block
    smem: int          # shared memory a block, bytes


def geometry(B: int, T: int, F: int, L: int) -> Geometry:
    """The kernel's launch for B packets of T trees, F features and L
    layers: a group of ``LANES`` lanes per (packet, tree); as many packets
    a block as give every group a pair, but no more than keep the grid at
    ``WAVES`` blocks on each of ``SMS`` SMs, nor than fit the staged
    feature rows, vid and row lengths (F + 1 + L * T ints a packet, beside
    L layer bits) in 48 KB.  At least one packet.  Raises where one packet
    does not fit."""
    if T < 1:
        raise ValueError(f"need a tree, got T {T}")
    per_packet = F + 1 + L * T
    cap = (SMEM_BYTES // 4 - L) // per_packet
    if cap < 1:
        raise ValueError(f"{per_packet} ints per packet do not fit one "
                         "block's shared memory")
    pb = max(1, min(cap, -(-GROUPS // T), B // (WAVES * SMS)))
    return Geometry(pb, -(-B // pb), THREADS, (pb * per_packet + L) * 4)


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
           geometry(B, T, F, L).packets)
    tree_walk.launches += 1
    return out


tree_walk.launches = 0
