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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import build
from repro_torch.kernels.tiling import (
    ClassifyFusedOperands,
    unpack_classify_fused,
)

__all__ = ["classify_fused", "classify_fused_plain", "packets_per_block",
           "SOURCE"]

SOURCE = "classify_fused"        # csrc/classify_fused.cu
_THREADS = 256                   # the kernel's block size
_SMEM_BYTES = 48 * 1024          # static limit, no opt-in attribute needed


def packets_per_block(T: int, F: int) -> int:
    """Packets per block: a thread per (packet, tree) within 256 threads,
    and the staged feature rows plus per-tree labels within 48 KB."""
    if T > _THREADS:
        raise ValueError(f"{T} trees > {_THREADS} threads of one block")
    pb = min(_THREADS // max(T, 1), _SMEM_BYTES // (4 * (F + T)))
    if pb < 1:
        raise ValueError(f"{F} features do not fit one block's shared memory")
    return pb


def _kernel_fn():
    fn = build(SOURCE)[SOURCE].lib.acorn_classify_fused
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 11 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, x, dtype, shape):
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, kernel takes {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def classify_fused_plain(codes, features, vid, layer_shift,
                         ops: ClassifyFusedOperands, n_classes: int):
    """The kernel's function in plain torch, on the kernel's operands."""
    (cv, cm, fid, f_lo, f_hi, set_bit, valid, pred_codes, pred_labels,
     pred_valid, weights, lut, bias) = unpack_classify_fused(ops)
    return ref.classify_fused_v(
        codes, features, vid, cv, cm, fid, f_lo, f_hi, set_bit, valid,
        layer_shift, pred_codes, pred_labels, pred_valid, weights, lut, bias,
        n_classes)


def classify_fused(codes: torch.Tensor, features: torch.Tensor,
                   vid: torch.Tensor, layer_shift: torch.Tensor,
                   ops: ClassifyFusedOperands, n_classes: int):
    """One launch for the whole classify.

    codes int32 [B, T] (uint32 bits), features int32 [B, F], vid int32 [B],
    layer_shift int32 [L], ``ops`` from ``tiling.prep_classify_fused``.
    Returns (codes int32 [B, T], label int32 [B], svm sums int32 [B, H]).
    """
    dev = codes.device
    for name, x in (("features", features), ("vid", vid),
                    ("layer_shift", layer_shift), *ops._asdict().items()):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, codes on {dev}")
    if dev.type == "cpu":
        return classify_fused_plain(codes, features, vid, layer_shift, ops,
                                    n_classes)
    if dev.type != "cuda":
        raise ValueError(f"no classify_fused kernel for {dev}")
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
            ("lut", ops.lut, i32, (V, H, F, levels)),
            ("bias", ops.bias, i32, (V, H))):
        _check(name, x, dtype, shape)
    if ops.entries.data_ptr() % 16:
        raise ValueError("entries must be 16-byte aligned (one record a load)")
    if P < 1:
        raise ValueError("need at least one leaf slot per tree")
    out_codes = torch.empty((B, T), dtype=i32, device=dev)
    out_label = torch.empty((B,), dtype=i32, device=dev)
    out_sums = torch.empty((B, H), dtype=i32, device=dev)
    if B == 0:
        return out_codes, out_label, out_sums
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(codes.data_ptr(), features.data_ptr(), vid.data_ptr(),
                 layer_shift.data_ptr(), ops.entries.data_ptr(),
                 ops.n_entries.data_ptr(), ops.pred_codes.data_ptr(),
                 ops.pred_labels.data_ptr(), ops.weights.data_ptr(),
                 ops.lut.data_ptr(), ops.bias.data_ptr(),
                 out_codes.data_ptr(), out_label.data_ptr(),
                 out_sums.data_ptr(), B, F, V, L, T, E, P, H, levels,
                 n_classes, packets_per_block(T, F), stream)
    if err != 0:
        raise RuntimeError(f"classify_fused launch failed: CUDA error {err}")
    classify_fused.launches += 1
    return out_codes, out_label, out_sums


classify_fused.launches = 0
