"""Named spans of the classify and serving path's host work.

``span(name)`` marks a stretch of host work.  Two readers see it:

* torch's profiler, when it records on the calling thread: the span opens
  a record-function range ``acorn.<name>`` (torch's C++ one,
  ``_RecordFunctionFast``, ~10x cheaper than ``torch.profiler.
  record_function``'s dispatcher ops) and so lands in the profiler's trace,
  on the profiler's own clock, as a host op;
* a dispatch record opened on the calling thread (``recording``): the span
  adds its duration, on ``time.monotonic`` (the event loop's clock, so a
  thread's spans and the front's stamps share one clock), to the record's
  dict under ``name``.  The profiler records no host op on a thread it did
  not start, so the async front's slot threads reach a reader only this
  way, through ``AsyncZooServer.latency_stats()``.

With neither, ``span`` returns one shared no-op context: a profiler check
and a thread-local read a span, nothing allocated.  No span object is
shared between threads.  Spans nest as the code nests.  Python's
collector's pauses are ``gc`` spans under the same rules (a
``gc.callbacks`` hook).

The spans: ``classify`` (``ZooServer.classify``, whole), ``request`` (the
request build: ``make_request``, or ``classify``'s write in place: into a
request record on the card's path, ``kernels/request_record.py``
``write_record``, else into a flat staging buffer), ``admit``
(admission's pad into the bucket, or ``classify``'s checkout of a record
or of a staging buffer and its zero tail), ``executor`` (the executor's
classify: its lock, stage, replay and clone), ``lock`` (the
wait for the executor's lock), ``capture`` (a graph captured), ``hop``
(one hop's classify in an executor's chain, ``HopChain``, where the chain
runs from Python: eagerly, or in a graph's warm-up and capture; a replay
runs no span), ``copy_out`` (the result to the host, which waits for the
card), ``cut`` (the async front's cut and coalesce), ``demux`` (its
accounting and demux), ``gc``.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time

import torch

__all__ = ["PREFIX", "span", "recording"]

PREFIX = "acorn."

# whether torch's profiler records on the calling thread
_profiled = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast


class _Off:
    """The shared no-op span."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NOOP = _Off()


class _Local(threading.local):
    spans: dict | None = None       # the open dispatch record's durations
    pause: _Span | None = None      # the collector's pause in progress


_local = _Local()


class _Span:
    """One span on one thread: the profiler's range and/or its duration
    added to the thread's record."""

    __slots__ = ("_name", "_range", "_spans", "_t0")

    def __init__(self, name: str, profiled: bool, spans: dict | None) -> None:
        self._name = name
        self._range = _range(PREFIX + name) if profiled else None
        self._spans = spans
        self._t0 = 0.0

    def __enter__(self) -> _Span:
        if self._range is not None:
            self._range.__enter__()
        if self._spans is not None:
            self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        if self._spans is not None:
            dt = time.monotonic() - self._t0
            self._spans[self._name] = self._spans.get(self._name, 0.0) + dt
        if self._range is not None:
            self._range.__exit__(*exc)


def span(name: str):
    """A context over a stretch of host work named ``name`` (see the
    module docstring); the shared no-op when nothing reads it."""
    spans = _local.spans
    profiled = _profiled()
    if spans is None and not profiled:
        return _NOOP
    return _Span(name, profiled, spans)


@contextlib.contextmanager
def recording(spans: dict):
    """Add the duration of every span this thread runs inside the block to
    ``spans`` (seconds by name, summed)."""
    outer, _local.spans = _local.spans, spans
    try:
        yield
    finally:
        _local.spans = outer


def _collector(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: each of the collector's pauses a ``gc``
    span."""
    if phase == "start":
        s = span("gc")
        if s is not _NOOP:
            s.__enter__()
            _local.pause = s
    elif _local.pause is not None:
        s, _local.pause = _local.pause, None
        s.__exit__(None, None, None)


if _collector not in gc.callbacks:
    gc.callbacks.append(_collector)
