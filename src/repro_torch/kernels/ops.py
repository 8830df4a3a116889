"""Public kernel API: dispatch between the CUDA kernels and the torch twins.

Port of ``src/repro/kernels/ops.py``: the classify paths and
``decode_attn``.  Modes:

* ``"cuda"`` — the kernel wrappers (``classify_fused``, ``tree_walk``,
  ``tcam_match``, ``forest_vote``, ``svm_lookup``), which launch their CUDA
  kernels on CUDA tensors and run their plain versions on CPU tensors;
* ``"ref"``  — the twins on the source tables (``ref.py``), on whatever
  device the tensors are;
* ``"unfused[-cuda|-ref]"`` — the three-launch classify: the walk, the vote
  and the SVM sums as separate stages;
* ``"layerwise[-cuda|-ref]"`` — as ``unfused``, with the walk as L
  one-layer launches (L + 2 launches per classify).

A mode with no suffix (``None``, ``"unfused"``, ``"layerwise"``) resolves to
the kernels for CUDA tensors and to the twins for CPU ones, so a CUDA
tensor reaches a twin only when ``"ref"`` is asked for.  Every stage of the
staged modes reads the same install-time operand image as the fused kernel
(``tiling.ClassifyFusedOperands``: ``.walk``, ``.leaves``, ``.svm``).
``decode_attn`` takes ``None``, ``"cuda"`` or ``"ref"`` alone.  Launches
are counted on each wrapper (``<wrapper>.launches``); the JAX package's
jaxpr counters have no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.analysis import cost
from repro_torch.kernels import decode_attn as _attn
from repro_torch.kernels import forest_vote as _vote
from repro_torch.kernels import ref, tiling
from repro_torch.kernels import svm_lookup as _svm
from repro_torch.kernels import tcam_match as _tcam
from repro_torch.kernels import tree_walk as _walk
from repro_torch.kernels.classify_fused import classify_fused

__all__ = ["MODES", "resolve_mode", "base_mode", "tcam_match",
           "tcam_match_v", "tree_walk_v", "svm_lookup", "svm_lookup_v",
           "forest_predict_vote", "forest_predict_vote_v",
           "classify_fused_v", "decode_attn"]

_KERNEL_MODES = ("cuda", "ref")
_STAGED = ("unfused", "layerwise")
MODES = (*_KERNEL_MODES, *_STAGED,
         *(f"{s}-{k}" for s in _STAGED for k in _KERNEL_MODES))


def resolve_mode(mode: str | None, device) -> str:
    """The mode with its kernel suffix made explicit for ``device``:
    ``None`` -> ``"cuda"`` or ``"ref"``, ``"unfused"`` -> ``"unfused-cuda"``
    or ``"unfused-ref"``, and so on."""
    if mode is not None and mode not in MODES:
        raise ValueError(f"unknown classify mode {mode!r}: one of {MODES}")
    default = "cuda" if device.type == "cuda" else "ref"
    if mode is None:
        return default
    return f"{mode}-{default}" if mode in _STAGED else mode


def base_mode(mode: str | None) -> str | None:
    """Strip a ``layerwise``/``unfused`` prefix down to the kernel mode of
    the stages beneath (``"layerwise-ref"`` -> ``"ref"``, ``"unfused"`` ->
    ``None``)."""
    if mode is None:
        return mode
    for prefix in _STAGED:
        if mode.startswith(prefix):
            return mode[len(prefix):].lstrip("-") or None
    return mode


def _shift_tensor(shift, like):
    """A scalar shift as the int32 ``[1]`` tensor the kernel reads."""
    return torch.as_tensor(shift, dtype=torch.int32,
                           device=like.device).reshape(1)


def tcam_match_v(codes, features, vid, code_value, code_mask, fid, f_lo, f_hi,
                 set_bit, valid, shift, *, mode: str | None = None):
    """Version-indexed one-layer lookup over ``[V, T, E]`` tables; the
    kernel path preps the records per call."""
    if base_mode(resolve_mode(mode, codes.device)) == "ref":
        return ref.tcam_match_v(codes, features, vid, code_value, code_mask,
                                fid, f_lo, f_hi, set_bit, valid, shift)
    walk = tiling.prep_walk(
        *(x[:, None] for x in (code_value, code_mask, fid, f_lo, f_hi,
                               set_bit, valid)), features.shape[1])
    return _tcam.tcam_match(codes, features, vid, _shift_tensor(shift, codes),
                            walk, 0)


def tcam_match(codes, features, code_value, code_mask, fid, f_lo, f_hi,
               set_bit, valid, shift, *, mode: str | None = None):
    """Single-version ``tcam_match_v`` (``[T, E]`` tables)."""
    vid = torch.zeros((codes.shape[0],), dtype=torch.int32,
                      device=codes.device)
    return tcam_match_v(codes, features, vid, code_value[None],
                        code_mask[None], fid[None], f_lo[None], f_hi[None],
                        set_bit[None], valid[None], shift, mode=mode)


def tree_walk_v(codes, features, vid, code_value, code_mask, fid, f_lo, f_hi,
                set_bit, valid, layer_shift, *, mode: str | None = None,
                prep: tiling.WalkOperands | None = None):
    """All L layers over ``[V, L, T, E]`` tables.

    ``prep`` binds the install-time walk records (``ExecImage.fused.walk``);
    without it the kernel paths prep them per call.  The twins work from
    the source tables and ignore ``prep``.  ``mode="layerwise[-*]"`` walks
    as L one-layer steps — L ``tcam_match`` launches on the kernel path.
    """
    m = resolve_mode(mode, codes.device)
    sub = base_mode(m)
    if sub == "ref":
        if not m.startswith("layerwise"):
            return ref.tree_walk_v(codes, features, vid, code_value,
                                   code_mask, fid, f_lo, f_hi, set_bit,
                                   valid, layer_shift)
        for l in range(code_value.shape[1]):
            codes = ref.tcam_match_v(
                codes, features, vid, code_value[:, l], code_mask[:, l],
                fid[:, l], f_lo[:, l], f_hi[:, l], set_bit[:, l],
                valid[:, l], layer_shift[l])
        return codes
    if prep is None:
        prep = tiling.prep_walk(code_value, code_mask, fid, f_lo, f_hi,
                                set_bit, valid, features.shape[1])
    if not m.startswith("layerwise"):
        return _walk.tree_walk(codes, features, vid, layer_shift, prep)
    for l in range(prep.entries.shape[1]):
        codes = _tcam.tcam_match(codes, features, vid, layer_shift, prep, l)
    return codes


def svm_lookup_v(features, vid, lut, bias, *, mode: str | None = None,
                 prep: tiling.LutOperands | None = None):
    """Version-indexed LUT sums over a ``[V, H, F, levels]`` LUT.  ``prep``
    binds the install-time LUT (``ExecImage.fused.svm``, whose bias is the
    one the kernel adds); the twin ignores it."""
    if base_mode(resolve_mode(mode, features.device)) == "ref":
        return ref.svm_lookup_v(features, vid, lut, bias)
    if prep is None:
        prep = tiling.prep_lut(lut, bias)
    return _svm.svm_lookup(features, vid, prep)


def svm_lookup(features, lut, bias, *, mode: str | None = None):
    """Single-version ``svm_lookup_v`` (``[H, F, levels]`` LUT)."""
    vid = torch.zeros((features.shape[0],), dtype=torch.int32,
                      device=features.device)
    return svm_lookup_v(features, vid, lut[None], bias[None], mode=mode)


def forest_predict_vote_v(codes, vid, pred_codes, pred_labels, pred_valid,
                          weights, n_classes, *, mode: str | None = None,
                          prep: tiling.LeafOperands | None = None):
    """Version-indexed dt_predict + voting over ``[V, T, P]`` leaves;
    returns (label [B], per-tree labels [B, T]).  ``prep`` binds the
    install-time leaves (``ExecImage.fused.leaves``); the twin ignores it."""
    if base_mode(resolve_mode(mode, codes.device)) == "ref":
        return ref.forest_predict_vote_v(codes, vid, pred_codes, pred_labels,
                                         pred_valid, weights, n_classes)
    if prep is None:
        prep = tiling.prep_leaves(pred_codes, pred_labels, pred_valid,
                                  weights)
    return _vote.forest_vote(codes, vid, prep, n_classes)


def forest_predict_vote(codes, pred_codes, pred_labels, pred_valid, weights,
                        n_classes, *, mode: str | None = None):
    """Single-version ``forest_predict_vote_v`` (``[T, P]`` leaves)."""
    vid = torch.zeros((codes.shape[0],), dtype=torch.int32,
                      device=codes.device)
    return forest_predict_vote_v(codes, vid, pred_codes[None],
                                 pred_labels[None], pred_valid[None],
                                 weights[None], n_classes, mode=mode)


def classify_fused_v(codes, features, vid, code_value, code_mask, fid, f_lo,
                     f_hi, set_bit, valid, layer_shift, pred_codes,
                     pred_labels, pred_valid, weights, lut, bias, n_classes,
                     *, mode: str | None = None,
                     prep: tiling.ClassifyFusedOperands | None = None):
    """Whole classify: walk -> vote -> svm, returning (final codes [B, T],
    vote label [B], svm sums [B, H]).

    ``prep`` binds the install-time operands (``tiling.prep_classify_fused``,
    the plane's ``ExecImage.fused``); without it the kernel paths prep them
    per call.  The twins work from the source tables and ignore ``prep``.
    ``"cuda"`` is one launch; ``"unfused"`` runs the three stage dispatchers
    above (3 launches) and ``"layerwise"`` walks layer by layer (L + 2).
    """
    m = resolve_mode(mode, codes.device)
    if m == "ref":
        return ref.classify_fused_v(
            codes, features, vid, code_value, code_mask, fid, f_lo, f_hi,
            set_bit, valid, layer_shift, pred_codes, pred_labels, pred_valid,
            weights, lut, bias, n_classes)
    if m == "cuda" or base_mode(m) == "cuda":
        if prep is None:
            prep = tiling.prep_classify_fused(
                code_value, code_mask, fid, f_lo, f_hi, set_bit, valid,
                pred_codes, pred_labels, pred_valid, weights, lut, bias)
        if m == "cuda":
            return classify_fused(codes, features, vid, layer_shift, prep,
                                  n_classes)
    walked = tree_walk_v(codes, features, vid, code_value, code_mask, fid,
                         f_lo, f_hi, set_bit, valid, layer_shift, mode=m,
                         prep=None if prep is None else prep.walk)
    label, _per_tree = forest_predict_vote_v(
        walked, vid, pred_codes, pred_labels, pred_valid, weights, n_classes,
        mode=m, prep=None if prep is None else prep.leaves)
    sums = svm_lookup_v(features, vid, lut, bias, mode=m,
                        prep=None if prep is None else prep.svm)
    return walked, label, sums


def decode_attn(q, k, v, kv_len, *, mxu_native: bool = False,
                mode: str | None = None):
    """GQA decode attention, q [B, Hq, D] over the cache k/v
    [B, S, Hkv, D] masked to ``kv_len`` int32 [B]: ``"cuda"`` is the
    kernel wrapper (one launch on CUDA tensors), ``"ref"`` the twin;
    ``None`` follows the device.  ``mxu_native``: P in bf16 for P.V.
    Under an ``analysis.cost.CostCounter`` the call is one op of its own
    work (``kernels.decode_attn.work``), whichever runs."""
    m = resolve_mode(mode, q.device)
    if m not in _KERNEL_MODES:
        raise ValueError(f"decode_attn mode {mode!r}: one of None, "
                         f"{_KERNEL_MODES}")
    fn = ref.decode_attn if m == "ref" else _attn.decode_attn
    if not cost.ACTIVE:
        return fn(q, k, v, kv_len, mxu_native=mxu_native)
    with cost.op("decode_attn", lambda: _attn.work(q, k, kv_len)):
        return fn(q, k, v, kv_len, mxu_native=mxu_native)
