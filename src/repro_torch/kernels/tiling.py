"""Install-time operand prep for the Hopper classify kernels.

Port of ``prep_classify_fused`` (``src/repro/kernels/tiling.py:233``) for the
layout the CUDA kernels read.  One operand image serves every classify mode:
the fused kernel reads all of it, and the staged kernels each read their
part — ``tree_walk`` and ``tcam_match`` the walk records, ``forest_vote``
the leaves, ``svm_lookup`` the LUT — so install and evict prep one layout
whatever the mode.  The JAX package's per-stage TPU layouts (a one-hot
``fsel`` stream, a chunked f32 LUT, int32 validity planes) have no
counterpart here.  What carries over is semantics:

* the **no-match padding convention** (``tiling.py:73-84``): an entry that
  must never match masks all code bits against value 0 and carries the empty
  feature range [1, 0].  Here it also stands in for the ``valid`` table:
  every invalid entry is written as a no-match entry, so the kernel needs no
  validity bits at all;
* **int16 feature ids and range bounds**, lossless because the profile
  keeps ``feature_width <= 15``.

What stays behind is TPU layout: the 128-lane entry padding, the sublane
padding of the hyperplane axis, the SVM feature chunking, the f32 LUT and
the bit-packed words.  Instead each walk entry is one 16-byte record, so a
thread reads an entry with a single vector load:

    word 0  code value (uint32 bits)
    word 1  code mask  (uint32 bits)
    word 2  fid (int16, low half)  | f_lo (int16, high half)
    word 3  f_hi (int16, low half) | set_bit << 16

``n_entries[v, l, t]`` is one past the last valid entry of each row, the
walk's loop bound.  Leaf validity folds into the labels (an invalid leaf
reads label 0, which is what a miss yields), and the LUT stays int32
``[V, H, F, levels]``, beside a copy with the hyperplanes innermost,
``lut_fh`` ``[V, F, levels, H]``, that the fused and SVM kernels gather.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["WalkOperands", "LeafOperands", "LutOperands",
           "ClassifyFusedOperands", "prep_walk", "prep_leaves", "prep_lut",
           "prep_classify_fused", "unpack_walk", "unpack_classify_fused",
           "NO_MATCH"]

# (code value, code mask, f_lo, f_hi) of an entry that matches no packet.
NO_MATCH = (0, -1, 1, 0)          # mask 0xFFFFFFFF as int32 bits
_I16 = (-(2**15), 2**15 - 1)


class WalkOperands(NamedTuple):
    """The walk's records: what ``tree_walk`` and ``tcam_match`` read."""

    entries: torch.Tensor      # int32 [V, L, T, E, 4] walk entry records
    n_entries: torch.Tensor    # int32 [V, L, T] loop bound per (layer, tree)


class LeafOperands(NamedTuple):
    """The leaves and vote weights: what ``forest_vote`` reads."""

    pred_codes: torch.Tensor   # int32 [V, T, P] sorted leaf codes (uint32 bits)
    pred_labels: torch.Tensor  # int32 [V, T, P] leaf labels, 0 where invalid
    weights: torch.Tensor      # f32   [V, T] vote weights


class LutOperands(NamedTuple):
    """The SVM products: ``svm_lookup`` reads ``lut_fh`` and ``bias``, its
    plain version ``lut`` and ``bias``."""

    lut: torch.Tensor          # int32 [V, H, F, levels] svm products
    bias: torch.Tensor         # int32 [V, H]
    # the same products with the hyperplanes innermost, [V, F, levels, H]:
    # a packet's H products of one feature are one contiguous gather
    lut_fh: torch.Tensor


class ClassifyFusedOperands(NamedTuple):
    """Kernel-ready operands of every classify mode (one exec-image group):
    the fused kernel reads the walk, the leaves, ``lut_fh`` and ``bias``;
    each staged kernel its part (``walk``, ``leaves``, ``svm``)."""

    entries: torch.Tensor      # int32 [V, L, T, E, 4] walk entry records
    n_entries: torch.Tensor    # int32 [V, L, T] loop bound per (layer, tree)
    pred_codes: torch.Tensor   # int32 [V, T, P] sorted leaf codes (uint32 bits)
    pred_labels: torch.Tensor  # int32 [V, T, P] leaf labels, 0 where invalid
    weights: torch.Tensor      # f32   [V, T] vote weights
    lut: torch.Tensor          # int32 [V, H, F, levels] svm products
    bias: torch.Tensor         # int32 [V, H]
    # the same products with the hyperplanes innermost, [V, F, levels, H]:
    # a packet's H products of one feature are one contiguous gather
    lut_fh: torch.Tensor

    @property
    def walk(self) -> WalkOperands:
        return WalkOperands(self.entries, self.n_entries)

    @property
    def leaves(self) -> LeafOperands:
        return LeafOperands(self.pred_codes, self.pred_labels, self.weights)

    @property
    def svm(self) -> LutOperands:
        return LutOperands(self.lut, self.bias, self.lut_fh)


def _check_i16(name: str, x: torch.Tensor) -> None:
    if x.numel() and (int(x.min()) < _I16[0] or int(x.max()) > _I16[1]):
        raise ValueError(
            f"{name} outside int16 on a valid entry: the fused operand "
            "layout needs feature_width <= 15")


def prep_walk(code_value, code_mask, fid, f_lo, f_hi, set_bit, valid,
              n_features: int) -> WalkOperands:
    """``[V, L, T, E]`` dt_layer tables (uint32 fields as int32 bits) -> the
    walk records, on the tables' device.  ``n_features`` is the width of the
    feature rows the records index."""
    valid = valid.to(torch.bool)
    fid_v, lo_v, hi_v = fid[valid], f_lo[valid], f_hi[valid]
    if fid_v.numel() and (int(fid_v.min()) < 0
                          or int(fid_v.max()) >= n_features):
        raise ValueError(
            f"feature id outside [0, {n_features}) on a valid entry")
    _check_i16("f_lo", lo_v)
    _check_i16("f_hi", hi_v)
    cv_f, cm_f, lo_f, hi_f = NO_MATCH
    i32 = torch.int32
    cv = torch.where(valid, code_value.to(i32), cv_f)
    cm = torch.where(valid, code_mask.to(i32), cm_f)
    fd = torch.where(valid, fid.to(i32), 0)
    lo = torch.where(valid, f_lo.to(i32), lo_f)
    hi = torch.where(valid, f_hi.to(i32), hi_f)
    bit = torch.where(valid, (set_bit != 0).to(i32), 0)
    w2 = (fd & 0xFFFF) | (lo << 16)
    w3 = (hi & 0xFFFF) | (bit << 16)
    entries = torch.stack([cv, cm, w2, w3], dim=-1).contiguous()
    E = valid.shape[-1]
    pos = torch.arange(1, E + 1, dtype=i32, device=valid.device)
    n_entries = torch.where(valid, pos, 0).amax(dim=-1).to(i32).contiguous()
    return WalkOperands(entries, n_entries)


def prep_leaves(pred_codes, pred_labels, pred_valid,
                weights) -> LeafOperands:
    """``[V, T, P]`` leaf tables + ``[V, T]`` weights -> the vote's
    operands; validity folds into the labels."""
    i32 = torch.int32
    labels = torch.where(pred_valid.to(torch.bool), pred_labels.to(i32), 0)
    return LeafOperands(pred_codes.to(i32).contiguous(), labels.contiguous(),
                        weights.to(torch.float32).contiguous())


def prep_lut(lut, bias) -> LutOperands:
    """``[V, H, F, levels]`` products + ``[V, H]`` bias, as int32, and the
    products again with the hyperplanes innermost (``lut_fh``)."""
    lut = lut.to(torch.int32).contiguous()
    return LutOperands(lut, bias.to(torch.int32).contiguous(),
                       lut.permute(0, 2, 3, 1).contiguous())


def prep_classify_fused(code_value, code_mask, fid, f_lo, f_hi, set_bit,
                        valid, pred_codes, pred_labels, pred_valid, weights,
                        lut, bias) -> ClassifyFusedOperands:
    """Source tables -> the kernels' operands, on the tables' device: the
    walk records, the leaves and the LUT (``prep_walk``, ``prep_leaves``,
    ``prep_lut``), with the walk indexing the LUT's ``F`` features."""
    return ClassifyFusedOperands(
        *prep_walk(code_value, code_mask, fid, f_lo, f_hi, set_bit, valid,
                   lut.shape[2]),
        *prep_leaves(pred_codes, pred_labels, pred_valid, weights),
        *prep_lut(lut, bias))


def unpack_walk(ops: WalkOperands) -> tuple:
    """Walk records -> source-shaped tables (code_value, code_mask, fid,
    f_lo, f_hi, set_bit, valid) that walk exactly as the tables they were
    prepped from."""
    r = ops.entries
    cv, cm, w2, w3 = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    fid = (w2 << 16) >> 16                 # sign-extend the low int16
    f_lo = w2 >> 16                        # arithmetic shift: high int16
    f_hi = (w3 << 16) >> 16
    set_bit = (w3 >> 16) & 1
    E = r.shape[3]
    valid = (torch.arange(E, device=r.device)
             < ops.n_entries[..., None].to(torch.int64))
    return cv, cm, fid, f_lo, f_hi, set_bit, valid


def unpack_classify_fused(ops: ClassifyFusedOperands) -> tuple:
    """Operands -> source-shaped tables (code_value, code_mask, fid, f_lo,
    f_hi, set_bit, valid, pred_codes, pred_labels, pred_valid, weights, lut,
    bias) that classify exactly as the tables they were prepped from: what
    the kernel's plain version runs on."""
    pred_valid = torch.ones_like(ops.pred_labels, dtype=torch.bool)
    return (*unpack_walk(ops.walk), ops.pred_codes, ops.pred_labels,
            pred_valid, ops.weights, ops.lut, ops.bias)
