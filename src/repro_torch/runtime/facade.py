"""``DataplaneRuntime`` — the facade every serving surface classifies through.

Port of ``src/repro/runtime/facade.py``.  Two responsibilities:

* **admission** — pad each ragged request batch into its power-of-two bucket
  of passthrough packets (``admission.py``), run the executor on the bucket
  shape, slice the padding back off;
* **delegation** — execution goes to the pluggable ``Executor``
  (``executors.py``).

Control-plane writes (``install``/``evict``) pass through to executors that
own a plane (``SingleSwitchExecutor``).  The executors classify through a
captured CUDA graph per bucket (``graphs.py``), so ``warm`` captures the
ladder and ``cache_size`` counts the captures, as the reference counts its
compiled traces.  For an executor on the card a host batch is padded
straight into one pinned buffer, moved in one copy, and ``run_host`` lands
the result in pinned memory the same way.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.packets import PacketBatch
from repro_torch.core.plane import PlaneProfile
from repro_torch.runtime.admission import (
    bucket_ladder,
    bucket_size,
    coalesce,
    land_on_host,
    pad_to_bucket,
    split,
    trim,
)
from repro_torch.runtime.executors import Executor, SingleSwitchExecutor

__all__ = ["DataplaneRuntime"]


class DataplaneRuntime:
    """Admission-controlled front over one pluggable executor."""

    def __init__(self, executor: Executor) -> None:
        self.executor = executor

    @classmethod
    def for_profile(cls, profile: PlaneProfile, *, mode: str | None = None,
                    device=None) -> "DataplaneRuntime":
        """Single-switch runtime over a fresh engine (on ``cuda`` unless
        ``device`` says otherwise) — the quickstart path."""
        return cls(SingleSwitchExecutor(profile, mode=mode, device=device))

    # ---------------------------------------------------------- admission
    def bucket(self, batch: int) -> int:
        """The padded shape a batch of ``batch`` packets executes at."""
        return bucket_size(batch, self.executor.granularity)

    def admit(self, batch: PacketBatch) -> PacketBatch:
        """``batch`` at its bucket shape, as the executor takes it: pinned
        and flat for a host batch bound for the card."""
        dev = getattr(self.executor, "device", None)
        pin = (dev is not None and torch.device(dev).type == "cuda"
               and batch.device.type == "cpu")
        return pad_to_bucket(batch, self.bucket(batch.batch), pin=pin)

    def run(self, batch: PacketBatch) -> PacketBatch:
        """Classify a flat request batch of any size.

        Pads to the bucket shape on the host (passthrough tail), executes,
        trims — the result stays on the device, in tensors of its own.  An
        empty batch short-circuits: nothing to classify, nothing launched.
        """
        B = batch.batch
        if B == 0:
            return batch
        return trim(self.executor.classify(self.admit(batch)), B)

    def run_host(self, batch: PacketBatch) -> PacketBatch:
        """``run`` variant that lands the result on the host (CPU tensors):
        the padded result is copied once and the tail sliced off there."""
        B = batch.batch
        if B == 0:
            return batch
        out = self.executor.classify(self.admit(batch))
        return trim(land_on_host(out), B)

    def warm(self, make_batch, max_batch: int) -> tuple[int, ...]:
        """Drive every admission bucket up to ``bucket(max_batch)`` once
        through ``run_host`` — each bucket's graph is captured here (and the
        kernels built and loaded), not mid-stream.  ``make_batch(b)``
        builds a ``PacketBatch`` of exactly ``b`` packets.  Returns the
        warmed bucket ladder."""
        ladder = bucket_ladder(max_batch, self.executor.granularity)
        for b in ladder:
            self.run_host(make_batch(b))
        return ladder

    # ------------------------------------------------------------ coalesce
    @staticmethod
    def coalesce(batches: Sequence[PacketBatch]
                 ) -> tuple[PacketBatch, tuple[int, ...]]:
        """Concatenate per-client batches; returns (flat batch, demux
        offsets)."""
        return coalesce(batches)

    def run_coalesced(self, batches: Sequence[PacketBatch]) -> list[PacketBatch]:
        """Classify several per-client batches as one admitted batch —
        packet for packet the same as ``[self.run(b) for b in batches]``,
        for one executor dispatch."""
        flat, offsets = coalesce(batches)
        return split(self.run(flat), offsets)

    # ------------------------------------------------------ control plane
    def install(self, program, *, vid: int | None = None,
                stages: set[int] | None = None) -> None:
        ex = self.executor
        if not hasattr(ex, "install"):
            raise NotImplementedError(
                f"{type(ex).__name__} is built from pre-installed device "
                "programs — reprogram it wholesale via swap()")
        ex.install(program, vid=vid, stages=stages)

    def evict(self, *, vid: int, kind: str = "all") -> None:
        ex = self.executor
        if not hasattr(ex, "evict"):
            raise NotImplementedError(
                f"{type(ex).__name__} is built from pre-installed device "
                "programs — reprogram it wholesale via swap()")
        ex.evict(vid=vid, kind=kind)

    def swap(self, device_programs) -> None:
        self.executor.swap(device_programs)

    def cache_size(self) -> int:
        """Captured classifies across the executor — with admission on, one
        per bucket (and mode)."""
        return self.executor.cache_size()
