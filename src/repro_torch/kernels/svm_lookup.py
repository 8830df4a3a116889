"""svm_mul LUT lookups + hyperplane sums in one launch (stage 3 of the
staged classify modes).

Replaces the Pallas TPU kernel ``svm_lookup_pallas_v``
(``src/repro/kernels/svm_lookup.py:71``).  The kernel is CUDA C++ in
``csrc/svm_lookup.cu``; the note at its top says what bounds it on an H100
and what its design does about that: it gathers from ``lut_fh``, the LUT
with the hyperplanes innermost, a packet's features split across the lanes
of a group (a lane a quad of hyperplanes of a slice of the features).
This module holds:

* ``svm_lookup`` — the wrapper.  On CUDA tensors it launches the kernel or
  raises; on CPU tensors it runs ``svm_lookup_plain``.
  ``svm_lookup.launches`` counts launches.
* ``svm_lookup_plain`` — the kernel's plain torch version on the same
  operands, the twin ``ref.svm_lookup_v`` on ``lut`` (not on the kernel's
  ``lut_fh``, so it does not depend on the kernel's layout).
* ``geometry`` — the launch's shape, plain Python; the C entry refuses any
  other, and any H above ``MAX_H``.

Like the TPU kernel, a feature outside ``[0, levels)`` adds 0.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.launch import check, launch, on_card
from repro_torch.kernels.tiling import LutOperands

__all__ = ["svm_lookup", "svm_lookup_plain", "geometry", "Geometry",
           "SOURCE", "MAX_H"]

SOURCE = "svm_lookup"            # csrc/svm_lookup.cu

# csrc/svm_lookup.cu's constants
LANES = 16                       # lanes that sum one packet
THREADS = 128                    # threads a block
MAX_H = 16                       # 4 quads of hyperplanes at most


class Geometry(NamedTuple):
    """One launch's shape (see ``geometry``)."""

    packets: int       # packets a block
    blocks: int        # the grid
    threads: int       # threads a block
    cell_lanes: int    # lanes a (packet, feature) cell: a quad of H each
    slices: int        # slices of a packet's features, one a cell's lanes


def geometry(B: int, H: int) -> Geometry:
    """The kernel's launch for B packets of H hyperplanes: ``LANES`` lanes
    a packet, a lane for each quad of 4 hyperplanes (1, 2 or 4 lanes a
    cell: the kernel's template instances) times slices of the features,
    ``THREADS // LANES`` packets a block, no shared memory.  Raises for an
    H the kernel does not keep in registers."""
    if not 1 <= H <= MAX_H:
        raise ValueError(f"H = {H} hyperplanes: the svm_lookup kernel keeps "
                         f"1 to {MAX_H} sums a packet in registers")
    quads = -(-H // 4)
    cell_lanes = 1 if quads == 1 else 2 if quads == 2 else 4
    pb = THREADS // LANES
    return Geometry(pb, -(-B // pb), THREADS, cell_lanes,
                    LANES // cell_lanes)


def svm_lookup_plain(features, vid, ops: LutOperands):
    """The kernel's function in plain torch, on the kernel's operands."""
    return ref.svm_lookup_v(features, vid, ops.lut, ops.bias)


def svm_lookup(features: torch.Tensor, vid: torch.Tensor,
               ops: LutOperands) -> torch.Tensor:
    """Every hyperplane sum of every packet, in one launch.

    features int32 [B, F], vid int32 [B], ``ops`` from ``tiling.prep_lut``
    (or ``ExecImage.fused.svm``).  Returns the sums int32 [B, H].  The
    kernel reads ``ops.lut_fh``; an H above ``MAX_H`` raises.
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
            ("lut_fh", ops.lut_fh, i32, (V, F, levels, H)),
            ("bias", ops.bias, i32, (V, H))):
        check(name, x, dtype, shape)
    if H % 4 == 0 and ops.lut_fh.data_ptr() % 16:
        raise ValueError("lut_fh must be 16-byte aligned (4 sums a load)")
    out = torch.empty((B, H), dtype=i32, device=features.device)
    if B == 0 or H == 0:
        return out
    launch(SOURCE, "acorn_svm_lookup", features.device, features, vid,
           ops.lut_fh, ops.bias, out, B, F, V, H, levels,
           geometry(B, H).packets)
    svm_lookup.launches += 1
    return out


svm_lookup.launches = 0
