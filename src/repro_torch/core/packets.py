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
from typing import Callable

import numpy as np
import torch

__all__ = ["PacketType", "PacketBatch", "header_bytes", "request_bytes",
           "response_bytes", "u32_bits", "u32_from_bits", "batch_from_arrays",
           "batch_to_arrays"]

# PacketBatch fields that hold uint32 values as int32 bit patterns.
U32_FIELDS = ("packet_id", "codes")


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
        feats = np.zeros((B, Fmax), dtype=np.int32)
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
