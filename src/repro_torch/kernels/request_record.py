"""A classify's request staged as a byte record, and expanded on the card.

Replaces no TPU kernel: the note at the top of ``csrc/request_record.cu``
says why it was added, what bounds it and what its design does about that.
A REQUEST batch whose features all fit a byte crosses to the card as a
record, the packet count, the VIDs and MIDs and the features as bytes
(0.28 MB at B 4096, F 60, against the flat batch's 1.41 MB), and the
classify's captured graph rebuilds the flat batch from it
(``runtime/graphs.py``).  This module holds:

* ``record_layout`` — where each part of a record of a bucket lies, cached
  per shape;
* ``write_record`` — the host's write of a request into a record
  (``runtime/staging.py`` ``Record``): the C function
  ``acorn_write_record``, one pass that narrows the features to bytes and
  checks that they fit; ``write_record_plain`` is its numpy twin;
* ``expand_request`` — the wrapper of the kernel: on CUDA tensors it
  launches ``acorn_expand_request`` or raises; on CPU tensors it runs
  ``expand_request_plain``.  ``expand_request.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.packets import (
    PacketType,
    _request_fields,
    flat_size,
    flat_views,
)
from repro_torch.kernels.build import build
from repro_torch.kernels.launch import check, launch, on_card

__all__ = ["RecordLayout", "record_layout", "write_record",
           "write_record_plain", "expand_request", "expand_request_plain",
           "SOURCE"]

SOURCE = "request_record"        # csrc/request_record.cu
HEADER = 16                      # bytes before the VIDs: n, then padding
BAD_VID = 2                      # acorn_write_record's refusal of a VID


def _up16(n: int) -> int:
    return -(-n // 16) * 16


class RecordLayout(NamedTuple):
    """Byte offsets of a record's parts (each on a 16-byte boundary) and
    its size: int32 n at 0, int32 VIDs ``[B]``, int32 MIDs ``[B]``, uint8
    features ``[B, F]``."""

    vid: int
    mid: int
    feats: int
    nbytes: int


@functools.lru_cache(maxsize=256)
def record_layout(B: int, F: int) -> RecordLayout:
    """The layout of a record of B packets of F features."""
    mid = HEADER + _up16(4 * B)
    feats = mid + _up16(4 * B)
    return RecordLayout(HEADER, mid, feats, feats + _up16(B * F))


def _arrays(features, mid, vid, Fmax: int):
    """The request's features (int32 ``[B, F]``, C-contiguous) and its
    MIDs and VIDs as int32 ``[B]`` views whose stride is 0 or one element;
    a malformed request raises what ``make_request`` raises."""
    features = np.ascontiguousarray(features, dtype=np.int32)
    if features.ndim != 2 or features.shape[1] > Fmax:
        _request_fields(features, max_features=Fmax)   # raises
    B = features.shape[0]
    out = []
    for x in (mid, vid):
        if not (type(x) is np.ndarray and x.dtype == np.int32
                and x.shape == (B,)):      # else as it is, a few us saved
            x = np.broadcast_to(np.asarray(x, np.int32), (B,))
        out.append(x if x.strides[0] in (0, 4) else np.ascontiguousarray(x))
    return features, out[0], out[1]


def _refuse_vids(features, mid, vid, Fmax: int, max_versions) -> None:
    """Raise the ``ValueError`` ``make_request`` raises for these VIDs."""
    _request_fields(features, mid=mid, vid=vid, max_features=Fmax,
                    max_versions=max_versions)


@functools.lru_cache(maxsize=None)
def _writer():
    """``acorn_write_record``, built and loaded once."""
    fn = build(SOURCE)[SOURCE].lib.acorn_write_record
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, i, p, i, p, i, i, p, i, i, i]
    fn.restype = ctypes.c_int
    return fn


def write_record(record, features, *, mid=0, vid=0,
                 max_versions: int | None = None) -> bool:
    """Write a REQUEST of ``features`` (int32 ``[B, F]``, B up to the
    record's bucket, F up to its width) into ``record`` in one native pass:
    B, the VIDs and MIDs (each a scalar or per packet), the features
    narrowed to bytes and zero-extended.  Returns False, the record unfit
    for use, when a feature lies outside [0, 255]; a VID outside
    ``[0, max_versions)``, or too many features, raise the ``ValueError``
    of ``make_request``."""
    F_max, lay = record.F, record.layout
    feats, mids, vids = _arrays(features, mid, vid, F_max)
    B, F = feats.shape
    status = _writer()(
        feats.ctypes.data, B, F, F_max, mids.ctypes.data, mids.strides[0] // 4,
        vids.ctypes.data, vids.strides[0] // 4,
        -1 if max_versions is None else max_versions, record.ptr, lay.vid,
        lay.mid, lay.feats)
    if status == BAD_VID:
        _refuse_vids(feats, mid, vid, F_max, max_versions)
    return status == 0


def write_record_plain(record, features, *, mid=0, vid=0,
                       max_versions: int | None = None) -> bool:
    """``write_record`` in numpy, on the record's numpy views: the same
    bytes where it returns True, the same answer and the same errors."""
    feats, mids, vids = _arrays(features, mid, vid, record.F)
    B, F = feats.shape
    record.n[0] = B
    record.vid[:B] = vids
    record.mid[:B] = mids
    if max_versions is not None and (
            (vids < 0) | (vids >= max_versions)).any():
        _refuse_vids(feats, mid, vid, record.F, max_versions)
    record.feats[:B, :F] = feats.astype(np.uint8)
    record.feats[:B, F:] = 0
    return bool(((feats >= 0) & (feats <= 255)).all())


def expand_request_plain(record: torch.Tensor, B: int, F: int, T: int,
                         H: int) -> torch.Tensor:
    """The kernel's function in plain torch: the flat batch (int32
    ``[flat_size(B, F, T, H)]``, on the record's device) of the request in
    ``record`` (uint8 ``[record_layout(B, F).nbytes]``)."""
    lay = record_layout(B, F)
    n = int(record[:4].view(torch.int32)[0])
    flat = torch.zeros(flat_size(B, F, T, H), dtype=torch.int32,
                       device=record.device)
    pb = flat_views(flat, B, F, T, H)
    pb.packet_id[:n] = torch.arange(n, dtype=torch.int32,
                                    device=record.device)
    pb.ptype[:n] = PacketType.REQUEST
    pb.mid[:n] = record[lay.mid:lay.mid + 4 * n].view(torch.int32)
    pb.vid[:n] = record[lay.vid:lay.vid + 4 * n].view(torch.int32)
    pb.rslt[:n] = -1
    pb.features[:n] = record[lay.feats:lay.feats + n * F].view(n, F).to(
        torch.int32)
    return flat


def expand_request(record: torch.Tensor, flat: torch.Tensor, B: int, F: int,
                   T: int, H: int) -> None:
    """Write the flat batch of the request in ``record`` (uint8, at
    ``record_layout(B, F)``) into ``flat`` (int32 ``[flat_size(B, F, T,
    H)]``): the batch ``write_request`` and ``Staging.zero_tail`` write on
    the host, bit for bit, its packet count read on the device.  One
    launch, counted in ``expand_request.launches``."""
    if not on_card("expand_request", record=record, flat=flat):
        flat.copy_(expand_request_plain(record, B, F, T, H))
        return
    lay = record_layout(B, F)
    check("record", record, torch.uint8, (lay.nbytes,))
    check("flat", flat, torch.int32, (flat_size(B, F, T, H),))
    if record.data_ptr() % 16 or flat.data_ptr() % 16:
        raise ValueError("record and flat must be 16-byte aligned (16-byte "
                         "loads and stores)")
    launch(SOURCE, "acorn_expand_request", flat.device, record, flat, B, F,
           T, H, lay.vid, lay.mid, lay.feats)
    expand_request.launches += 1


expand_request.launches = 0
