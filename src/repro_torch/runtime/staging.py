"""Host staging buffers in the flat layout, reused per batch shape.

A host batch bound for an executor is written into one int32 buffer in the
flat layout (``core/packets.py``), which the executor's graph cache stages
with one copy (``runtime/graphs.py``).  ``StagingPool`` keeps those buffers
per (bucket, F, T, H) so that a call writes into memory made once: pinned
for an executor on ``cuda`` (the copy is asynchronous), plain host memory
on any other device.  Each buffer's field views, as a ``PacketBatch`` and as
numpy arrays, are built once, when the buffer is made.

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

__all__ = ["Staging", "StagingPool"]


class Staging:
    """One flat host buffer of a (B, F, T, H) batch and its views."""

    __slots__ = ("shape", "flat", "batch", "rows", "event")

    def __init__(self, shape: tuple[int, int, int, int], pin: bool) -> None:
        self.shape = shape
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
        with self._lock:
            free = self._free.get(shape, ())
            for i, s in enumerate(free):
                if s.event is None or s.event.query():
                    self._reused += 1
                    return free.pop(i)
            self._made += 1
        return Staging(shape, self._pin)

    def release(self, staged: Staging, answer: PacketBatch | None = None
                ) -> None:
        """Hand ``staged`` back once the executor has taken it, on the
        calling thread, ``answer`` being what the executor returned (None
        if it raised)."""
        if staged.event is not None:
            staged.event.record(torch.cuda.current_stream(self.device))
        elif answer is not None and _holds(answer, staged.flat):
            return
        with self._lock:
            self._free.setdefault(staged.shape, []).append(staged)

    def stats(self) -> dict[str, int]:
        """``reused``: checkouts that took a buffer back; ``made``: those
        that made a new one."""
        with self._lock:
            return {"reused": self._reused, "made": self._made}
