"""svm_mul LUT lookups + hyperplane sums in one launch (stage 3 of the
staged classify modes).

Replaces the Pallas TPU kernel ``svm_lookup_pallas_v``
(``src/repro/kernels/svm_lookup.py:71``).  The kernel is CUDA C++ in
``csrc/svm_lookup.cu``; the note at its top says what bounds it on an H100
and what its design does about that.  This module holds:

* ``svm_lookup`` — the wrapper.  On CUDA tensors it launches the kernel or
  raises; on CPU tensors it runs ``svm_lookup_plain``.
  ``svm_lookup.launches`` counts launches.
* ``svm_lookup_plain`` — the kernel's plain torch version on the same
  operands, the twin ``ref.svm_lookup_v``.

Like the TPU kernel, a feature outside ``[0, levels)`` adds 0.
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
from repro_torch.kernels.tiling import LutOperands

__all__ = ["svm_lookup", "svm_lookup_plain", "SOURCE"]

SOURCE = "svm_lookup"            # csrc/svm_lookup.cu


def svm_lookup_plain(features, vid, ops: LutOperands):
    """The kernel's function in plain torch, on the kernel's operands."""
    return ref.svm_lookup_v(features, vid, ops.lut, ops.bias)


def svm_lookup(features: torch.Tensor, vid: torch.Tensor,
               ops: LutOperands) -> torch.Tensor:
    """Every hyperplane sum of every packet, in one launch.

    features int32 [B, F], vid int32 [B], ``ops`` from ``tiling.prep_lut``
    (or ``ExecImage.fused.svm``).  Returns the sums int32 [B, H].
    """
    if not on_card("svm_lookup", features=features, vid=vid,
                   **ops._asdict()):
        return svm_lookup_plain(features, vid, ops)
    B, F = features.shape
    V, H, _, levels = ops.lut.shape
    i32 = torch.int32
    for name, x, dtype, shape in (
            ("features", features, i32, (B, F)),
            ("vid", vid, i32, (B,)),
            ("lut", ops.lut, i32, (V, H, F, levels)),
            ("bias", ops.bias, i32, (V, H))):
        check(name, x, dtype, shape)
    out = torch.empty((B, H), dtype=i32, device=features.device)
    if B == 0:
        return out
    launch(SOURCE, "acorn_svm_lookup", features.device, features, vid,
           ops.lut, ops.bias, out, B, F, V, H, levels,
           packets_per_block(H, F))
    svm_lookup.launches += 1
    return out


svm_lookup.launches = 0
