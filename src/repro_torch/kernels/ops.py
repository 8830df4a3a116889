"""Public kernel API: dispatch between the CUDA kernel and the torch twin.

Port of ``src/repro/kernels/ops.py`` for the classify the main path runs.
Modes:

* ``"cuda"`` — the kernel wrapper (``classify_fused.classify_fused``), which
  launches the CUDA kernel on CUDA tensors and runs its plain version on CPU
  tensors;
* ``"ref"``  — the twin on the source tables (``ref.classify_fused_v``), on
  whatever device the tensors are.

``mode=None`` picks ``"cuda"`` for CUDA tensors and ``"ref"`` for CPU ones,
so a CUDA tensor reaches the twin only when ``"ref"`` is asked for.  The
JAX package's ``"unfused"`` and ``"layerwise"`` fallbacks wait for their own
kernels.  Launches are counted on the wrapper
(``classify_fused.classify_fused.launches``); the JAX package's jaxpr
counters have no counterpart here.
"""
from __future__ import annotations

from repro_torch.kernels import ref, tiling
from repro_torch.kernels.classify_fused import classify_fused

__all__ = ["MODES", "resolve_mode", "classify_fused_v"]

MODES = ("cuda", "ref")


def resolve_mode(mode: str | None, device) -> str:
    if mode is None:
        return "cuda" if device.type == "cuda" else "ref"
    if mode not in MODES:
        raise ValueError(f"unknown classify mode {mode!r}: one of {MODES}")
    return mode


def classify_fused_v(codes, features, vid, code_value, code_mask, fid, f_lo,
                     f_hi, set_bit, valid, layer_shift, pred_codes,
                     pred_labels, pred_valid, weights, lut, bias, n_classes,
                     *, mode: str | None = None, prep=None):
    """Whole classify: walk -> vote -> svm, returning (final codes [B, T],
    vote label [B], svm sums [B, H]).

    ``prep`` binds the install-time operands (``tiling.prep_classify_fused``,
    the plane's ``ExecImage.fused``); without it the kernel path preps them
    per call.  The twin works from the source tables and ignores ``prep``.
    """
    if resolve_mode(mode, codes.device) == "ref":
        return ref.classify_fused_v(
            codes, features, vid, code_value, code_mask, fid, f_lo, f_hi,
            set_bit, valid, layer_shift, pred_codes, pred_labels, pred_valid,
            weights, lut, bias, n_classes)
    if prep is None:
        prep = tiling.prep_classify_fused(
            code_value, code_mask, fid, f_lo, f_hi, set_bit, valid,
            pred_codes, pred_labels, pred_valid, weights, lut, bias)
    return classify_fused(codes, features, vid, layer_shift, prep, n_classes)
