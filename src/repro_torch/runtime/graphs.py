"""A captured CUDA graph per admission bucket: the port's executable cache.

The JAX package jits the classify step and keeps one compiled executable
per batch shape; admission keeps those shapes to the O(log B) buckets, and
``cache_size`` counts them (``src/repro/core/plane.py:590``,
``src/repro/runtime/executors.py:133``).  PyTorch runs eagerly: a fused
classify is one kernel launch among 36-69 small torch launches and ten
pageable copies, which set its pace on the card.  This module's counterpart
of the jit cache is ``GraphCache``: one entry per (bucket, widths, mode[,
hops]), each holding

* a static device buffer, the whole batch in the flat layout
  (``core/packets.py``), written by ONE copy from a pinned host buffer
  that admission padded straight into (``admission.pad_to_bucket(...,
  pin=True)``), or field by field from any other batch;
* the captured classify (``torch.cuda.graph``), which reads that buffer
  and the executor's resident program (``core/plane.py``,
  ``resident_program``: written in place, so the graph keeps reading the
  live tables), and writes the fields it rewrites (rslt, codes, svm_acc)
  back over the buffer's own; every call copies the buffer out, one device
  copy, before the executor's lock is released: run N's answer is never
  run N + 1's.

On ``cuda`` an entry is captured on the first call at its key, after an
eager warm-up run on a side stream that builds and loads the kernels (and
whose answer is that call's); the buckets of one cache share one memory
pool.  A capture that fails raises, and the cache keeps no entry: nothing
gives way to eager.  On the CPU an entry runs the same classify eagerly on
the same static buffers, so the staging, the static addresses and the
bookkeeping run in the CPU tests; only the capture is the card's.

Launch counts stay exact: the kernel wrappers count their launches only
while the graph is captured, so an entry takes back the counts its capture
made and adds them again on every replay.

``Serial`` is the executor's lock: stage-in, replay and copy-out of one
call, and every in-place write of the resident program (install, evict,
swap), hold it, and each waits on the card for the one before, whatever
stream its caller is on.
"""
from __future__ import annotations

import contextlib
import gc
import threading
from typing import Callable

import torch

from repro_torch.core.packets import (
    FIELDS,
    PacketBatch,
    flat_of,
    flat_size,
    flat_views,
    widths,
)
from repro_torch.runtime import trace

__all__ = ["GraphCache", "Serial"]

# One capture at a time in the process: the launch counts read around a
# capture must hold only that capture's launches.
_CAPTURE = threading.Lock()
_COUNT = threading.Lock()


@contextlib.contextmanager
def _collector_paused():
    """Python's cyclic collector off while a graph is captured.  A
    collection inside the capture may free another, unreachable
    ``CUDAGraph`` (a dropped executor's cache), and destroying a graph is
    an operation CUDA forbids on a capturing thread: the capture would end
    invalidated (``cudaErrorStreamCaptureInvalidated``)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _wrappers() -> dict:
    """Every kernel wrapper of the port, by name (each counts its launches
    in ``.launches``)."""
    from repro_torch.kernels.classify_fused import classify_fused
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.forest_vote import forest_vote
    from repro_torch.kernels.svm_lookup import svm_lookup
    from repro_torch.kernels.tcam_match import tcam_match
    from repro_torch.kernels.tree_walk import tree_walk

    return {f.__name__: f for f in (classify_fused, tree_walk, tcam_match,
                                    forest_vote, svm_lookup, decode_attn)}


def _counted() -> dict[str, int]:
    """Each kernel wrapper's launch count, by name."""
    return {k: f.launches for k, f in _wrappers().items()}


def _add_launches(counts: dict[str, int]) -> None:
    wrappers = _wrappers()
    with _COUNT:
        for k, n in counts.items():
            wrappers[k].launches += n


class _Entry:
    """One key's classify on one static buffer, and its graph."""

    def __init__(self, body, B: int, F: int, T: int, H: int, device) -> None:
        self.shape = (B, F, T, H)
        self.buf = torch.zeros(flat_size(*self.shape), dtype=torch.int32,
                               device=device)
        self._batch = flat_views(self.buf, *self.shape)
        self._body = body
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict[str, int] = {}

    def stage(self, batch: PacketBatch) -> None:
        """Copy ``batch`` into the static buffer: one copy when it is in the
        flat layout (pinned, from admission), else one per field."""
        flat = flat_of(batch)
        if flat is not None:
            self.buf.copy_(flat, non_blocking=True)
            return
        for f in FIELDS:
            getattr(self._batch, f).copy_(getattr(batch, f),
                                          non_blocking=True)

    def compute(self) -> None:
        """The classify, in place: the fields it rewrites (rslt, codes,
        svm_acc) are copied back over the static buffer's, which then holds
        the whole classified batch."""
        res = self._body(self._batch)
        for f in FIELDS:
            src, dst = getattr(res, f), getattr(self._batch, f)
            if src is not dst:
                dst.copy_(src)


class GraphCache:
    """One captured classify per key (see the module docstring).

    ``body(batch) -> batch`` is the classify; ``tag`` joins every key (the
    mode, and the hop count of a path).  The caller holds the executor's
    lock (``Serial``) around ``run``.
    """

    def __init__(self, body: Callable[[PacketBatch], PacketBatch], device,
                 tag: tuple = ()) -> None:
        self._body = body
        self.device = torch.device(device)
        self.tag = tuple(tag)
        self._entries: dict[tuple, _Entry] = {}
        self._pool = None

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> list[tuple]:
        """(bucket, F, T, H, *tag) of every entry."""
        return list(self._entries)

    def run(self, batch: PacketBatch) -> PacketBatch:
        """Classify ``batch`` at its own size through its key's entry,
        capturing the entry on first use.  Returns a fresh device batch in
        the flat layout."""
        shape = (batch.batch, *widths(batch))
        key = shape + self.tag
        entry = self._entries.get(key)
        fresh = entry is None
        if fresh:
            entry = _Entry(self._body, *shape, self.device)
        entry.stage(batch)
        if self.device.type != "cuda":
            entry.compute()
        elif fresh:
            with trace.span("capture"):
                self._capture(entry)
        else:
            entry.graph.replay()
            _add_launches(entry.launches)
        self._entries[key] = entry
        return flat_views(entry.buf.clone(), *shape)

    def _capture(self, entry: _Entry) -> None:
        """Warm up on a side stream (this call's answer), then capture."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            entry.compute()
        cur.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE, _collector_paused():
            before = _counted()
            try:
                # thread_local: serving threads may replay other graphs and
                # synchronise while this one captures
                with torch.cuda.graph(graph, pool=self._pool,
                                      capture_error_mode="thread_local"):
                    entry.compute()
            except BaseException:
                # a capture that ends in a CUDA error leaves the caching
                # allocator recording into its pool: later captures take a
                # pool of their own
                self._pool = None
                raise
            finally:
                made = {k: n - before[k]
                        for k, n in _counted().items()}
                _add_launches({k: -n for k, n in made.items() if n})
        entry.graph = graph
        entry.launches = {k: n for k, n in made.items() if n}


class Serial:
    """An executor's lock, its holders kept in one order on the card: each
    holder's work on its current stream waits for the previous holder's."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._done: torch.cuda.Event | None = None

    def __enter__(self) -> "Serial":
        with trace.span("lock"):
            self._lock.acquire()
        if self.device.type == "cuda" and self._done is not None:
            torch.cuda.current_stream(self.device).wait_event(self._done)
        return self

    def __exit__(self, *exc) -> None:
        try:
            if self.device.type == "cuda":
                if self._done is None:
                    self._done = torch.cuda.Event()
                self._done.record(torch.cuda.current_stream(self.device))
        finally:
            self._lock.release()
