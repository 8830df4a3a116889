"""The whole-classify kernel (walk -> vote -> svm) in one launch, for Hopper.

Replaces the Pallas TPU kernel ``classify_fused_pallas_v``
(``src/repro/kernels/classify_fused.py:166``).  The kernel is CUDA C++ in
``csrc/classify_fused.cu``; the note at its top says what bounds it on an
H100 and what its design does about that.  This module holds:

* ``classify_fused`` — the wrapper.  On CUDA tensors it launches the kernel
  or raises; it never falls back.  On CPU tensors it runs
  ``classify_fused_plain``.  ``classify_fused.launches`` counts launches.
* ``classify_fused_plain`` — the kernel's plain torch version on the same
  operands: the operands decoded back to source tables
  (``tiling.unpack_classify_fused``) through the twin
  ``ref.classify_fused_v``.
* ``classify_hop`` — the plane's whole classify step on one switch (the
  kernel with the plane's SVM predict and result select folded in: the
  same kernel, its hop entry), one launch, counted in
  ``classify_fused.launches`` too; on CPU tensors ``classify_hop_plain``,
  the twin followed by ``ref.classify_epilogue``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.launch import check, launch, on_card
from repro_torch.kernels.tiling import (
    ClassifyFusedOperands,
    unpack_classify_fused,
)

__all__ = ["classify_fused", "classify_fused_plain", "classify_hop",
           "classify_hop_plain", "packets_per_block", "SOURCE"]

SOURCE = "classify_fused"        # csrc/classify_fused.cu


WALK_WARPS = 4                   # warps a block that walk (packet, tree) pairs
WALKS_PER_WARP = 4               # (packet, tree) walks a warp, 8 lanes each
SMEM_BYTES = 48 * 1024           # static limit, no opt-in attribute needed
MAX_PACKETS = 32                 # packets a block at most
SMS = 132                        # H100 SXM
WAVES = 2                        # the grid: at least two blocks an SM
PACKET_INTS = 3                  # a packet's slot, flags and SVM result
MAX_HOP_H = 16                   # the hop's sign code indexes 2^H entries


def smem_ints(T: int, F: int, L: int) -> int:
    """Shared-memory ints a packet takes in a block: its feature row,
    per-tree labels, row lengths and ``PACKET_INTS`` (the slot, the hop's
    flags and its SVM result; the plain entry stages the same)."""
    return F + T + PACKET_INTS + L * T


def packets_per_block(T: int, F: int, B: int | None = None, *,
                      L: int = 0) -> int:
    """Packets a block: ``smem_ints`` a packet, beside L layer bits,
    within 48 KB, and at most ``MAX_PACKETS``.  Given the batch ``B``:
    enough that every warp walks (packet, tree) pairs, but no more than
    keep the grid at ``WAVES`` blocks an SM."""
    per = smem_ints(T, F, L)
    cap = min(MAX_PACKETS, (SMEM_BYTES // 4 - L) // per)
    if cap < 1:
        raise ValueError(f"{per} ints per packet do not fit one block's "
                         "shared memory")
    if B is None:
        return cap
    fill = -(-WALK_WARPS * WALKS_PER_WARP // max(T, 1))
    return max(1, min(cap, fill, B // (WAVES * SMS)))


def classify_fused_plain(codes, features, vid, layer_shift,
                         ops: ClassifyFusedOperands, n_classes: int):
    """The kernel's function in plain torch, on the kernel's operands."""
    (cv, cm, fid, f_lo, f_hi, set_bit, valid, pred_codes, pred_labels,
     pred_valid, weights, lut, bias) = unpack_classify_fused(ops)
    return ref.classify_fused_v(
        codes, features, vid, cv, cm, fid, f_lo, f_hi, set_bit, valid,
        layer_shift, pred_codes, pred_labels, pred_valid, weights, lut, bias,
        n_classes)


def _check_operands(codes, features, vid, layer_shift,
                    ops: ClassifyFusedOperands) -> tuple:
    """Raise unless the kernel's common operands are what it reads; return
    (B, F, V, L, T, E, P, H, levels)."""
    B, T = codes.shape
    V, L, _, E, _ = ops.entries.shape
    P = ops.pred_codes.shape[2]
    H, F, levels = ops.lut.shape[1:]
    i32 = torch.int32
    for name, x, dtype, shape in (
            ("codes", codes, i32, (B, T)),
            ("features", features, i32, (B, F)),
            ("vid", vid, i32, (B,)),
            ("layer_shift", layer_shift, i32, (L,)),
            ("entries", ops.entries, i32, (V, L, T, E, 4)),
            ("n_entries", ops.n_entries, i32, (V, L, T)),
            ("pred_codes", ops.pred_codes, i32, (V, T, P)),
            ("pred_labels", ops.pred_labels, i32, (V, T, P)),
            ("weights", ops.weights, torch.float32, (V, T)),
            ("lut_fh", ops.lut_fh, i32, (V, F, levels, H)),
            ("bias", ops.bias, i32, (V, H))):
        check(name, x, dtype, shape)
    if ops.entries.data_ptr() % 16:
        raise ValueError("entries must be 16-byte aligned (one record a load)")
    if P < 1:
        raise ValueError("need at least one leaf slot per tree")
    return B, F, V, L, T, E, P, H, levels


def classify_fused(codes: torch.Tensor, features: torch.Tensor,
                   vid: torch.Tensor, layer_shift: torch.Tensor,
                   ops: ClassifyFusedOperands, n_classes: int):
    """One launch for the whole classify.

    codes int32 [B, T] (uint32 bits), features int32 [B, F], vid int32 [B],
    layer_shift int32 [L], ``ops`` from ``tiling.prep_classify_fused``.
    Returns (codes int32 [B, T], label int32 [B], svm sums int32 [B, H]).
    """
    if not on_card("classify_fused", codes=codes, features=features,
                   vid=vid, layer_shift=layer_shift, **ops._asdict()):
        return classify_fused_plain(codes, features, vid, layer_shift, ops,
                                    n_classes)
    B, F, V, L, T, E, P, H, levels = _check_operands(codes, features, vid,
                                                      layer_shift, ops)
    i32 = torch.int32
    dev = codes.device
    out_codes = torch.empty((B, T), dtype=i32, device=dev)
    out_label = torch.empty((B,), dtype=i32, device=dev)
    out_sums = torch.empty((B, H), dtype=i32, device=dev)
    if B == 0:
        return out_codes, out_label, out_sums
    launch(SOURCE, "acorn_classify_fused", dev, codes, features, vid,
           layer_shift, ops.entries, ops.n_entries, ops.pred_codes,
           ops.pred_labels, ops.weights, ops.lut_fh, ops.bias, out_codes,
           out_label, out_sums, B, F, V, L, T, E, P, H, levels, n_classes,
           packets_per_block(T, F, B, L=L))
    classify_fused.launches += 1
    return out_codes, out_label, out_sums


classify_fused.launches = 0


def classify_hop_plain(codes, features, vid, ptype, mid, rslt, svm_acc,
                       layer_shift, ops: ClassifyFusedOperands, pred_enable,
                       svm_bias, svm_hvalid, svm_pred_table, svm_pred_enable,
                       n_classes: int, *, mid_svm: int, request: int):
    """The hop entry's function in plain torch: a vid outside the zoo sent
    to slot 0, the kernel's plain version, then the plane's epilogue."""
    vid_ok, slot = ref.zoo_slot(vid, ops.entries.shape[0])
    out_codes, label, sums = classify_fused_plain(
        codes, features, slot, layer_shift, ops, n_classes)
    return ref.classify_epilogue(
        codes, svm_acc, rslt, ptype, mid, vid_ok, slot, out_codes, label,
        sums, pred_enable, svm_bias, svm_hvalid, svm_pred_table,
        svm_pred_enable, mid_svm, request)


def classify_hop(codes: torch.Tensor, features: torch.Tensor,
                 vid: torch.Tensor, ptype: torch.Tensor, mid: torch.Tensor,
                 rslt: torch.Tensor, svm_acc: torch.Tensor,
                 layer_shift: torch.Tensor, ops: ClassifyFusedOperands,
                 pred_enable: torch.Tensor, svm_bias: torch.Tensor,
                 svm_hvalid: torch.Tensor, svm_pred_table: torch.Tensor,
                 svm_pred_enable: torch.Tensor, n_classes: int, *,
                 mid_svm: int, request: int):
    """One launch for the plane's classify step on one switch: the walk,
    the vote and the SVM sums of ``classify_fused``, then the SVM predict
    and the result select of ``ref.classify_epilogue``, bit for bit.

    The packet fields are int32: codes [B, T], features [B, F], vid, ptype,
    mid, rslt [B], svm_acc [B, H]; ``ops`` the exec image
    (``tiling.prep_classify_fused``, its bias added to the handed-on sums);
    the plane's source tables pred_enable bool [V], svm_bias int32 [V, H],
    svm_hvalid bool [V, H], svm_pred_table int32 [V, 2^H], svm_pred_enable
    bool [V], read in place.  ``mid_svm`` picks the SVM's result, ``request``
    the packet type that is classified.  Returns (codes int32 [B, T],
    svm_acc int32 [B, H], rslt int32 [B]).  Counted in
    ``classify_fused.launches``.
    """
    if not on_card("classify_fused", codes=codes, features=features,
                   vid=vid, ptype=ptype, mid=mid, rslt=rslt, svm_acc=svm_acc,
                   layer_shift=layer_shift, pred_enable=pred_enable,
                   svm_bias=svm_bias, svm_hvalid=svm_hvalid,
                   svm_pred_table=svm_pred_table,
                   svm_pred_enable=svm_pred_enable, **ops._asdict()):
        return classify_hop_plain(
            codes, features, vid, ptype, mid, rslt, svm_acc, layer_shift,
            ops, pred_enable, svm_bias, svm_hvalid, svm_pred_table,
            svm_pred_enable, n_classes, mid_svm=mid_svm, request=request)
    dims = _check_operands(codes, features, vid, layer_shift, ops)
    B, F, V, L, T, E, P, H, levels = dims
    if H > MAX_HOP_H:
        raise ValueError(f"H {H} above the hop entry's {MAX_HOP_H}")
    i32, bool_ = torch.int32, torch.bool
    for name, x, dtype, shape in (
            ("ptype", ptype, i32, (B,)),
            ("mid", mid, i32, (B,)),
            ("rslt", rslt, i32, (B,)),
            ("svm_acc", svm_acc, i32, (B, H)),
            ("pred_enable", pred_enable, bool_, (V,)),
            ("svm_bias", svm_bias, i32, (V, H)),
            ("svm_hvalid", svm_hvalid, bool_, (V, H)),
            ("svm_pred_table", svm_pred_table, i32, (V, 1 << H)),
            ("svm_pred_enable", svm_pred_enable, bool_, (V,))):
        check(name, x, dtype, shape)
    dev = codes.device
    out_codes = torch.empty((B, T), dtype=i32, device=dev)
    out_acc = torch.empty((B, H), dtype=i32, device=dev)
    out_rslt = torch.empty((B,), dtype=i32, device=dev)
    if B == 0:
        return out_codes, out_acc, out_rslt
    launch(SOURCE, "acorn_classify_hop", dev, codes, features, vid, ptype,
           mid, rslt, svm_acc, layer_shift, ops.entries, ops.n_entries,
           ops.pred_codes, ops.pred_labels, ops.weights, ops.lut_fh,
           ops.bias, pred_enable, svm_bias, svm_hvalid, svm_pred_table,
           svm_pred_enable, out_codes, out_acc, out_rslt, B, F, V, L, T, E,
           P, H, levels, n_classes, packets_per_block(T, F, B, L=L), mid_svm,
           request)
    classify_fused.launches += 1
    return out_codes, out_acc, out_rslt
