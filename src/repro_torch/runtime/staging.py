"""Host staging buffers, reused per batch shape: flat batches and request
records.

A host batch bound for an executor is written into one int32 buffer in the
flat layout (``core/packets.py``), which the executor's graph cache stages
with one copy (``runtime/graphs.py``).  A REQUEST whose features all fit a
byte, bound for an executor on the card, is written instead into a
``Record`` (``kernels/request_record.py``: the packet count, VIDs, MIDs and
the features as bytes), which the graph cache stages with one copy and
expands on the card.  ``StagingPool`` keeps those buffers per (bucket, F, T,
H), and the records per (bucket, F) under keys of their own, so that a call
writes into memory made once: pinned for an executor on ``cuda`` (the copy
is asynchronous), plain host memory on any other device.  Each buffer's
views, as a ``PacketBatch`` and as numpy arrays, are built once, when the
buffer is made.

Reuse is guarded.  On ``cuda`` a buffer goes back to its pool with an event
recorded on the caller's stream after the executor has taken it (the
stage's copy is on that stream), and is handed out again only once that
event has completed.  On the host the executor's copy is done when it
returns, unless its answer is a view of the buffer: that buffer leaves the
pool with the answer.  When every buffer of a shape is busy a checkout
makes a new one and never waits.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.core.packets import FIELDS, PacketBatch, flat_size, flat_views
from repro_torch.kernels.request_record import record_layout

__all__ = ["Staging", "Record", "StagingPool"]


class Staging:
    """One flat host buffer of a (B, F, T, H) batch and its views."""

    __slots__ = ("shape", "key", "flat", "batch", "rows", "event")

    def __init__(self, shape: tuple[int, int, int, int], pin: bool) -> None:
        self.shape = self.key = shape
        self.flat = torch.zeros(flat_size(*shape), dtype=torch.int32,
                                pin_memory=pin)
        self.batch = flat_views(self.flat, *shape)
        # the same fields as numpy views, for the builder's writes
        self.rows: tuple[np.ndarray, ...] = tuple(
            getattr(self.batch, f).numpy() for f in FIELDS)
        self.event = torch.cuda.Event() if pin else None

    def zero_tail(self, B: int) -> None:
        """Zero packets B.. of every field: FORWARD passthrough packets."""
        for a in self.rows:
            a[B:] = 0

    def held_by(self, answer: PacketBatch) -> bool:
        """Whether a field of ``answer`` is a view of this buffer."""
        return _holds(answer, self.flat)


class Record:
    """One host request record of a bucket of B packets, F features a
    packet (``kernels/request_record.py``), and its numpy views: ``n``, the
    ``vid`` and ``mid`` rows and the ``feats`` bytes ``[B, F]``."""

    __slots__ = ("key", "F", "layout", "buf", "ptr", "n", "vid", "mid",
                 "feats", "event")

    def __init__(self, B: int, F: int, pin: bool) -> None:
        self.key = ("record", B, F)
        self.F = F
        self.layout = lay = record_layout(B, F)
        self.buf = torch.zeros(lay.nbytes, dtype=torch.uint8, pin_memory=pin)
        self.ptr = self.buf.data_ptr()
        a = self.buf.numpy()
        self.n = a[:4].view(np.int32)
        self.vid = a[lay.vid:lay.vid + 4 * B].view(np.int32)
        self.mid = a[lay.mid:lay.mid + 4 * B].view(np.int32)
        self.feats = a[lay.feats:lay.feats + B * F].reshape(B, F)
        self.event = torch.cuda.Event() if pin else None

    def held_by(self, answer: PacketBatch) -> bool:
        """A classified batch never views a record (it is expanded)."""
        return False


def _holds(answer: PacketBatch, flat: torch.Tensor) -> bool:
    """Whether a field of ``answer`` is a view of ``flat``'s memory."""
    ptr = flat.untyped_storage().data_ptr()
    return any(getattr(answer, f).untyped_storage().data_ptr() == ptr
               for f in FIELDS)


class StagingPool:
    """Staging buffers for batches bound for ``device``, kept per shape.

    ``stats()`` counts the checkouts that reused a buffer and those that
    made one."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self._pin = self.device.type == "cuda"
        self._free: dict[tuple[int, ...], list[Staging]] = {}
        self._lock = threading.Lock()
        self._reused = 0
        self._made = 0

    def checkout(self, B: int, F: int, T: int, H: int) -> Staging:
        """A buffer of shape (B, F, T, H) that no pending copy reads: a
        free one whose event has completed, else a new one."""
        shape = (B, F, T, H)
        return self._take(shape) or Staging(shape, self._pin)

    def checkout_record(self, B: int, F: int) -> Record:
        """A request record of a bucket of B packets, F features a packet,
        that no pending copy reads, as ``checkout``."""
        return self._take(("record", B, F)) or Record(B, F, self._pin)

    def _take(self, key: tuple) -> Staging | Record | None:
        """A free buffer under ``key`` whose event has completed (counted
        as reused), else None (counted as made: the caller makes one)."""
        with self._lock:
            free = self._free.get(key, ())
            for i, s in enumerate(free):
                if s.event is None or s.event.query():
                    self._reused += 1
                    return free.pop(i)
            self._made += 1
        return None

    def release(self, staged: Staging | Record,
                answer: PacketBatch | None = None) -> None:
        """Hand ``staged`` back once the executor has taken it, on the
        calling thread, ``answer`` being what the executor returned (None
        if it raised)."""
        if staged.event is not None:
            staged.event.record(torch.cuda.current_stream(self.device))
        elif answer is not None and staged.held_by(answer):
            return
        with self._lock:
            self._free.setdefault(staged.key, []).append(staged)

    def stats(self) -> dict[str, int]:
        """``reused``: checkouts that took a buffer back; ``made``: those
        that made a new one."""
        with self._lock:
            return {"reused": self._reused, "made": self._made}
