"""Admission control: ragged traffic -> a small set of batch shapes.

Port of ``src/repro/runtime/admission.py``.  Admission rounds each batch up
to a **power-of-two bucket** (in units of the executor's ``granularity``)
and fills the tail with zeroed packets.  A zero-filled packet has
``ptype == PacketType.FORWARD`` (= 0): the plane's passthrough gate leaves
its ``rslt``/``codes``/``svm_acc`` untouched (paper §6.1), so padding is
semantically invisible and ``trim`` slices it back off.  With no jit there
is no trace to save here; the buckets keep the launch shapes few, which is
what a later CUDA graph per bucket needs.

``coalesce``/``split`` are the multi-client seam on the same invariant:
several per-client request batches run as one flat batch and are split back
per client; classification is per-packet, so each client's slice is
bit-identical to classifying its batch alone.

The glue runs on the host: requests arrive as CPU tensors
(``PacketBatch.make_request``) and the executor moves the padded batch to
the device once.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.packets import PacketBatch

__all__ = ["bucket_size", "bucket_ladder", "pad_to_bucket", "trim",
           "coalesce", "split"]


def bucket_size(batch: int, granularity: int = 1) -> int:
    """Smallest power-of-two multiple of ``granularity`` holding ``batch``."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1 packet, got {batch}")
    if granularity < 1:
        raise ValueError(f"granularity must be >= 1, got {granularity}")
    units = -(-batch // granularity)          # ceil(batch / granularity)
    return granularity * (1 << max(units - 1, 0).bit_length())


def bucket_ladder(max_batch: int, granularity: int = 1) -> tuple[int, ...]:
    """Every admission bucket a batch of up to ``max_batch`` can land in:
    ``granularity * 2^k`` for ``k = 0 .. log2(bucket(max_batch))``."""
    top = bucket_size(max_batch, granularity)
    ladder = []
    b = granularity
    while b <= top:
        ladder.append(b)
        b *= 2
    return tuple(ladder)


def pad_to_bucket(pb: PacketBatch, bucket: int) -> PacketBatch:
    """Pad a request batch to ``bucket`` packets with a passthrough tail
    (``ptype = FORWARD`` (0), zero features and intermediates), on the
    batch's own device."""
    B = pb.batch
    if bucket < B:
        raise ValueError(f"bucket {bucket} smaller than batch {B}")
    if bucket == B:
        return pb
    return pb.map(lambda x: torch.cat(
        [x, x.new_zeros((bucket - B,) + tuple(x.shape[1:]))]))


def trim(pb: PacketBatch, batch: int) -> PacketBatch:
    """Slice the admission padding back off (a view, no copy)."""
    if pb.batch == batch:
        return pb
    return pb.map(lambda x: x[:batch])


def coalesce(batches: Sequence[PacketBatch]) -> tuple[PacketBatch, tuple[int, ...]]:
    """Concatenate per-client request batches into one flat batch.

    Returns ``(flat, offsets)`` where ``offsets`` has ``len(batches) + 1``
    entries and client ``i``'s packets occupy ``flat[offsets[i]:offsets[i+1]]``.
    Empty member batches are legal and occupy an empty slice.
    """
    batches = list(batches)
    if not batches:
        raise ValueError("coalesce needs at least one batch")
    offsets = [0]
    for b in batches:
        offsets.append(offsets[-1] + b.batch)
    if len(batches) == 1:
        return batches[0], tuple(offsets)
    flat = PacketBatch(**{f.name: torch.cat([getattr(b, f.name) for b in batches])
                          for f in dataclasses.fields(PacketBatch)})
    return flat, tuple(offsets)


def split(pb: PacketBatch, offsets: Sequence[int]) -> list[PacketBatch]:
    """Invert ``coalesce``: slice the flat batch back per client."""
    if not offsets or offsets[0] != 0 or offsets[-1] != pb.batch:
        raise ValueError(
            f"offsets {tuple(offsets)} do not tile a batch of {pb.batch}")
    return [pb.map(lambda x, lo=lo, hi=hi: x[lo:hi])
            for lo, hi in zip(offsets, offsets[1:])]
