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
the result in pinned memory the same way.  The staging buffers are the
runtime's own (``staging.py``), reused per bucket; ``run_request`` writes
a REQUEST batch straight into one, with no other host copy of it.  For an
executor on the card with a record entry (``classify_record``: the single
switch, the path, the fleet), a request whose features all fit a byte is
written instead as a request record (``kernels/request_record.py``, one
native pass), a fifth of the flat batch's bytes, which the executor's graph
expands on the card; any other request takes the flat buffer.
``request_stats()`` counts the calls each way.
"""
from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.packets import (
    PacketBatch,
    flat_views,
    widths,
    write_request,
)
from repro_torch.core.plane import PlaneProfile
from repro_torch.kernels.request_record import write_record
from repro_torch.runtime import trace
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
from repro_torch.runtime.staging import Record, Staging, StagingPool

__all__ = ["DataplaneRuntime"]


class DataplaneRuntime:
    """Admission-controlled front over one pluggable executor."""

    def __init__(self, executor: Executor) -> None:
        self.executor = executor
        dev = getattr(executor, "device", None)
        self._staging = StagingPool("cpu" if dev is None else dev)
        # requests go as records where there is a bus to save: on the card
        self._records = self._staging.device.type == "cuda"
        self._requests = {"record": 0, "flat": 0}
        self._count_lock = threading.Lock()

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

    def admit(self, batch: PacketBatch) -> tuple[PacketBatch,
                                                 Staging | None]:
        """``batch`` at its bucket shape, as the executor takes it, and the
        staging buffer that holds it: a host batch bound for the card is
        written, flat, into a pinned buffer of the runtime's pool (else
        None).  ``_execute`` hands the buffer back."""
        with trace.span("admit"):
            bucket, staged = self.bucket(batch.batch), None
            if self._staging.device.type == "cuda" and \
                    batch.device.type == "cpu":
                staged = self._staging.checkout(bucket, *widths(batch))
            return pad_to_bucket(batch, bucket, into=staged), staged

    def _record_entry(self):
        """The executor's ``classify_record`` where requests go as records
        (on the card), else None; read per call, as the executor may be
        swapped (the async engine's lanes)."""
        if not self._records:
            return None
        return getattr(self.executor, "classify_record", None)

    def _execute(self, padded: PacketBatch,
                 staged: Staging | Record | None, entry=None,
                 shape: tuple | None = None) -> PacketBatch:
        """The executor's classify of an admitted batch, or with ``entry``
        (its ``classify_record``) and ``shape`` (the bucket's (B, F, T,
        H)) of the request record ``padded``; its staging buffer goes back
        to the pool once the executor has taken it."""
        out = None
        try:
            with trace.span("executor"):
                out = (self.executor.classify(padded) if entry is None
                       else entry(padded, shape))
        finally:
            if staged is not None:
                self._staging.release(staged, out)
        return out

    def run(self, batch: PacketBatch) -> PacketBatch:
        """Classify a flat request batch of any size.

        Pads to the bucket shape on the host (passthrough tail), executes,
        trims — the result stays on the device, in tensors of its own.  An
        empty batch short-circuits: nothing to classify, nothing launched.
        """
        B = batch.batch
        if B == 0:
            return batch
        return trim(self._execute(*self.admit(batch)), B)

    def run_host(self, batch: PacketBatch) -> PacketBatch:
        """``run`` variant that lands the result on the host (CPU tensors):
        the padded result is copied once and the tail sliced off there."""
        B = batch.batch
        if B == 0:
            return batch
        out = self._execute(*self.admit(batch))
        with trace.span("copy_out"):
            return trim(land_on_host(out), B)

    def run_request(self, features, *, mid=0, vid=0,
                    row_widths: tuple[int, int, int],
                    max_versions: int | None = None) -> PacketBatch:
        """``run`` of a REQUEST batch written once, in place, into a staging
        buffer of the runtime's pool at its bucket: the same batch, bit for
        bit, and the same answer as ``run(PacketBatch.make_request(features,
        mid=mid, vid=vid, max_features=F, n_trees=T, n_hyperplanes=H,
        max_versions=max_versions))`` for ``row_widths`` (F, T, H), with its
        checks.  The buffer is pinned for an executor on the card, plain
        host memory otherwise.  An empty request is answered at once, with
        an empty batch at ``row_widths``.

        For an executor on the card with a record entry, a request whose
        features all lie in [0, 255] is written as a request record and
        expanded on the card, bit for bit the same batch; any other takes
        the flat buffer (``request_stats()``)."""
        features = np.asarray(features, dtype=np.int32)
        if not len(features):
            return flat_views(torch.zeros(0, dtype=torch.int32), 0,
                              *row_widths)
        B = len(features)
        shape = (self.bucket(B), *row_widths)
        entry = self._record_entry()
        if entry is not None:
            with trace.span("admit"):
                record = self._staging.checkout_record(*shape[:2])
            try:
                with trace.span("request"):
                    fits = write_record(record, features, mid=mid, vid=vid,
                                        max_versions=max_versions)
            except BaseException:
                self._staging.release(record)
                raise
            if fits:
                self._count("record")
                return trim(self._execute(record.buf, record, entry, shape),
                            B)
            self._staging.release(record)
        with trace.span("admit"):
            staged = self._staging.checkout(*shape)
            staged.zero_tail(B)
        try:
            with trace.span("request"):
                write_request(staged.rows, features, mid=mid, vid=vid,
                              max_versions=max_versions)
        except BaseException:
            self._staging.release(staged)
            raise
        self._count("flat")
        return trim(self._execute(staged.batch, staged), B)

    def _count(self, path: str) -> None:
        with self._count_lock:
            self._requests[path] += 1

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

    def warm_requests(self, max_batch: int,
                      row_widths: tuple[int, int, int]) -> tuple[int, ...]:
        """``warm`` for ``run_request``: drive every admission bucket up to
        ``bucket(max_batch)`` once with a request of zero features at
        ``row_widths`` (F, T, H), which captures the bucket's record graph
        where requests go as records (an executor on the card with a
        record entry), its flat one otherwise.  Returns the warmed bucket
        ladder."""
        ladder = bucket_ladder(max_batch, self.executor.granularity)
        for b in ladder:
            self.run_request(np.zeros((b, row_widths[0]), np.int32),
                             row_widths=row_widths)
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

    def staging_stats(self) -> dict[str, int]:
        """The staging pool's checkouts, flat buffers and request records
        alike: ``reused`` a buffer, ``made`` a new one (a warmed steady
        load reuses nearly every time)."""
        return self._staging.stats()

    def request_stats(self) -> dict[str, int]:
        """The ``run_request`` calls that reached the executor by each
        path: ``record`` (written as a request record, expanded on the
        card) and ``flat`` (written into a flat staging buffer)."""
        with self._count_lock:
            return dict(self._requests)
