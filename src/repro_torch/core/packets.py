"""ACORN packet header (paper Appendix A) as a struct of tensors.

Port of ``src/repro/core/packets.py``.  Basic header: Packet ID | Type | MID |
VID | RSLT | RID.  Data part: raw input features (size set by the max
supported feature count — an operator knob).  Intermediate part: per-tree
status codes / SVM partial sums that must travel between devices (paper §4).
When classification finishes, the data + intermediate parts are dropped
(``strip_payload``) to shrink response packets.

uint32 convention: the header's unsigned fields (``packet_id``, ``codes``)
are carried as **int32 bit patterns**.  Torch on the CPU has no uint32
shifts, gathers, ``searchsorted`` or ``max``; bitwise and equality ops on
the int32 patterns give the uint32 answers bit for bit, and code that needs
the unsigned order widens to int64 first (``kernels/ref.py``).  Convert at
the numpy boundary with ``u32_bits`` / ``u32_from_bits``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["PacketType", "PacketBatch", "header_bytes", "request_bytes",
           "response_bytes", "u32_bits", "u32_from_bits", "batch_from_arrays",
           "batch_to_arrays", "FIELDS", "widths", "flat_size", "flat_views",
           "flat_of", "pack_flat", "Layout", "layout", "write_request"]

# PacketBatch fields that hold uint32 values as int32 bit patterns.
U32_FIELDS = ("packet_id", "codes")
# Every PacketBatch field, in declaration order (the flat layout's order).
FIELDS = ("packet_id", "ptype", "mid", "vid", "rslt", "rid", "features",
          "codes", "svm_acc")


def u32_bits(x) -> torch.Tensor:
    """uint32 array-like -> int32 tensor with the same bits (CPU)."""
    a = np.ascontiguousarray(np.asarray(x, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy())


def u32_from_bits(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> host uint32 array."""
    return t.detach().cpu().numpy().astype(np.int32, copy=False).view(np.uint32)


class PacketType:
    FORWARD = 0   # ordinary traffic: data plane only forwards
    REQUEST = 1   # inference request (carries features)
    RESPONSE = 2  # inference response (carries RSLT only)


@dataclasses.dataclass
class PacketBatch:
    """A batch of ACORN packets (one pipeline's PHV state, vectorized)."""

    packet_id: torch.Tensor   # int32 [B] (uint32 bits)
    ptype: torch.Tensor       # int32 [B]
    mid: torch.Tensor         # int32 [B]  model type id (0=DT, 1=RF, 2=SVM)
    vid: torch.Tensor         # int32 [B]  model version
    rslt: torch.Tensor        # int32 [B]  prediction result (-1 = not yet)
    rid: torch.Tensor         # int32 [B]  routing code (next hop)
    features: torch.Tensor    # int32 [B, F]
    codes: torch.Tensor       # int32 [B, T]  per-tree status codes (uint32 bits)
    svm_acc: torch.Tensor     # int32 [B, H]   partial hyperplane sums

    @property
    def batch(self) -> int:
        return self.packet_id.shape[0]

    @property
    def device(self) -> torch.device:
        return self.packet_id.device

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "PacketBatch":
        """Apply ``fn`` to every field (the pytree map of the JAX package)."""
        return PacketBatch(**{f.name: fn(getattr(self, f.name))
                              for f in dataclasses.fields(self)})

    def to(self, device) -> "PacketBatch":
        device = torch.device(device)
        if self.device == device:
            return self
        return self.map(lambda x: x.to(device))

    @classmethod
    def make_request(
        cls,
        features: np.ndarray,
        *,
        mid: int | np.ndarray = 0,
        vid: int | np.ndarray = 0,
        max_features: int | None = None,
        n_trees: int = 1,
        n_hyperplanes: int = 1,
        max_versions: int | None = None,
    ) -> "PacketBatch":
        """Build a REQUEST batch.  ``mid`` and ``vid`` may each be a scalar
        or a per-packet array — together the model-zoo dispatch key; pass
        ``max_versions`` to validate VIDs at the request boundary instead of
        shipping packets that can only ever yield ``rslt == -1``.

        Fields are **CPU tensors**: requests model packets arriving from the
        wire, and the executor moves a batch to the device once.  Admission
        glue (pad, coalesce) therefore stays on the host."""
        features, mids, vids = _request_fields(
            features, mid=mid, vid=vid, max_features=max_features,
            max_versions=max_versions)
        B, F = features.shape
        feats = np.zeros((B, max_features or F), dtype=np.int32)
        feats[:, :F] = features
        return cls(
            packet_id=torch.arange(B, dtype=torch.int32),
            ptype=torch.full((B,), PacketType.REQUEST, dtype=torch.int32),
            mid=torch.from_numpy(np.array(mids)),
            vid=torch.from_numpy(np.array(vids)),
            rslt=torch.full((B,), -1, dtype=torch.int32),
            rid=torch.zeros((B,), dtype=torch.int32),
            features=torch.from_numpy(feats),
            codes=torch.zeros((B, n_trees), dtype=torch.int32),
            svm_acc=torch.zeros((B, n_hyperplanes), dtype=torch.int32),
        )

    def strip_payload(self) -> "PacketBatch":
        """Drop data + intermediates after classification (response packet)."""
        B, dev = self.batch, self.device
        empty = torch.zeros((B, 0), dtype=torch.int32, device=dev)
        return dataclasses.replace(
            self,
            ptype=torch.full((B,), PacketType.RESPONSE, dtype=torch.int32,
                             device=dev),
            features=empty, codes=empty, svm_acc=empty,
        )


def batch_from_arrays(arrays: dict) -> PacketBatch:
    """Numpy field dict (uint32 where the JAX batch is uint32) -> CPU batch."""
    fields = {}
    for f in dataclasses.fields(PacketBatch):
        a = np.asarray(arrays[f.name])
        fields[f.name] = (u32_bits(a) if f.name in U32_FIELDS else
                          torch.from_numpy(np.array(a, np.int32)))
    return PacketBatch(**fields)


def batch_to_arrays(pb: PacketBatch) -> dict:
    """Batch -> numpy field dict, uint32 fields restored from their bits."""
    return {f.name: (u32_from_bits(getattr(pb, f.name))
                     if f.name in U32_FIELDS
                     else getattr(pb, f.name).detach().cpu().numpy())
            for f in dataclasses.fields(pb)}


# --------------------------------------------------------------------------
# The flat layout: a whole batch in one int32 buffer, one copy to move it
# --------------------------------------------------------------------------
def widths(pb: PacketBatch) -> tuple[int, int, int]:
    """(F, T, H): the widths of the features, codes and svm_acc rows."""
    return (pb.features.shape[1], pb.codes.shape[1], pb.svm_acc.shape[1])


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where each field of a B-packet batch lies in the flat buffer, as
    plain ints, in ``FIELDS`` order: the six header fields of B each, then
    features, codes and svm_acc row-major."""

    offsets: tuple[int, ...]
    sizes: tuple[int, ...]
    shapes: tuple[tuple[int, ...], ...]
    row_sizes: tuple[int, ...]     # elements a packet


@functools.lru_cache(maxsize=256)
def layout(B: int, F: int, T: int, H: int) -> Layout:
    """The flat layout of a (B, F, T, H) batch, computed once per shape
    (bounded: an executor outside admission may see any B)."""
    row_sizes = (1, 1, 1, 1, 1, 1, F, T, H)
    shapes = ((B,),) * 6 + ((B, F), (B, T), (B, H))
    sizes = tuple(B * w for w in row_sizes)
    offsets = tuple(sum(sizes[:i]) for i in range(len(sizes)))
    return Layout(offsets, sizes, shapes, row_sizes)


def flat_size(B: int, F: int, T: int, H: int) -> int:
    """int32 elements of a B-packet batch in the flat layout."""
    return B * (6 + F + T + H)


def flat_views(flat: torch.Tensor, B: int, F: int, T: int,
               H: int) -> PacketBatch:
    """The batch whose fields are contiguous views of ``flat`` (int32
    ``[flat_size(B, F, T, H)]``), in the flat layout."""
    p = flat.split_with_sizes(layout(B, F, T, H).sizes)
    return PacketBatch(p[0], p[1], p[2], p[3], p[4], p[5], p[6].view(B, F),
                       p[7].view(B, T), p[8].view(B, H))


def pack_flat(pb: PacketBatch, bucket: int, flat: torch.Tensor) -> None:
    """Write the host batch ``pb``, padded with zero packets to ``bucket``,
    into ``flat`` (host int32 ``[flat_size(bucket, F, T, H)]``) in the flat
    layout; numpy copies, a few microseconds a field."""
    B, lay = pb.batch, layout(bucket, *widths(pb))
    out = flat.numpy()
    for name, off, size, row in zip(FIELDS, lay.offsets, lay.sizes,
                                    lay.row_sizes):
        n = B * row
        out[off:off + n] = getattr(pb, name).numpy().reshape(-1)
        out[off + n:off + size] = 0


def flat_of(pb: PacketBatch) -> torch.Tensor | None:
    """The one flat buffer under ``pb`` when its fields are exactly
    ``flat_views`` of it, else None."""
    base = pb.packet_id._base
    if base is None or base.dtype != torch.int32 or base.dim() != 1:
        return None
    B, (F, T, H) = pb.batch, widths(pb)
    if base.numel() != flat_size(B, F, T, H):
        return None
    lay = layout(B, F, T, H)
    start = base.storage_offset()
    for name, off, shape in zip(FIELDS, lay.offsets, lay.shapes):
        x = getattr(pb, name)
        if (x._base is not base or x.storage_offset() != start + off
                or x.shape != shape or not x.is_contiguous()):
            return None
    return base


# --------------------------------------------------------------------------
# The request builder: REQUEST packets written in place into the flat layout
# --------------------------------------------------------------------------
def _request_fields(features, *, mid=0, vid=0,
                    max_features: int | None = None,
                    max_versions: int | None = None
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A request's features (int32 ``[B, F]``) and its per-packet MIDs and
    VIDs (int32 ``[B]``, broadcast views), checked at the request boundary:
    more features than ``max_features``, or a VID outside
    ``[0, max_versions)``, raise ``ValueError``."""
    features = np.asarray(features, dtype=np.int32)
    B, F = features.shape
    Fmax = max_features or F
    if F > Fmax:
        raise ValueError(f"{F} features > plane max {Fmax}")
    mids = np.broadcast_to(np.asarray(mid, np.int32), (B,))
    vids = np.broadcast_to(np.asarray(vid, np.int32), (B,))
    if max_versions is not None and vids.size and (
        vids.min() < 0 or vids.max() >= max_versions
    ):
        raise ValueError(
            f"vid range [{vids.min()}, {vids.max()}] outside the plane's "
            f"{max_versions} model-zoo versions"
        )
    return features, mids, vids


def write_request(rows: Sequence[np.ndarray], features, *, mid=0, vid=0,
                  max_versions: int | None = None) -> None:
    """Write a REQUEST batch into the first B rows of a flat buffer, whose
    fields ``rows`` holds as numpy views in ``FIELDS`` order (features
    ``[bucket, Fmax]``): packet ids 0..B-1, ``ptype`` REQUEST, ``mid`` and
    ``vid``, ``rslt`` -1, ``rid``, codes and partial sums 0, the features
    zero-extended to Fmax: the rows ``PacketBatch.make_request`` builds,
    checked as it checks them.  The rows past B are the caller's."""
    pid, ptype, mids, vids, rslt, rid, feats, codes, acc = rows
    features, m, v = _request_fields(features, mid=mid, vid=vid,
                                     max_features=feats.shape[1],
                                     max_versions=max_versions)
    B, F = features.shape
    pid[:B] = np.arange(B, dtype=np.int32)
    ptype[:B] = PacketType.REQUEST
    mids[:B] = m
    vids[:B] = v
    rslt[:B] = -1
    rid[:B] = 0
    feats[:B, :F] = features
    feats[:B, F:] = 0
    codes[:B] = 0
    acc[:B] = 0


# --------------------------------------------------------------------------
# Wire-size model (bytes) — drives the planner's J_O and netsim.
# --------------------------------------------------------------------------
BASIC_HEADER_BYTES = 12  # packet_id(4) type(1) mid(1) vid(1) rslt(4) rid(1)
ETH_IP_BYTES = 34        # enclosing L2/L3 headers


def header_bytes(n_features: int, feat_bytes: int = 1, n_trees: int = 0,
                 code_bytes: int = 4, n_hyperplanes: int = 0, acc_bytes: int = 4) -> int:
    """ACORN header size with data + intermediate parts."""
    return (
        BASIC_HEADER_BYTES
        + n_features * feat_bytes
        + n_trees * code_bytes
        + n_hyperplanes * acc_bytes
    )


def request_bytes(n_features: int, feat_bytes: int = 1, n_trees: int = 0,
                  n_hyperplanes: int = 0) -> int:
    return ETH_IP_BYTES + header_bytes(n_features, feat_bytes, n_trees, 4, n_hyperplanes, 4)


def response_bytes() -> int:
    """After the last stage the data/intermediate parts are dropped."""
    return ETH_IP_BYTES + BASIC_HEADER_BYTES
