"""Pluggable classify executors behind one ``Executor`` protocol.

Port of ``src/repro/runtime/executors.py``: the protocol and its four
executors, all bit-identical on the same zoo and traffic:

* ``SingleSwitchExecutor``   — one ``SwitchEngine``: the paper's single
  programmable switch;
* ``SequentialPathExecutor`` — partial programs applied in path order on one
  device: the functional reference every distributed layout must match;
* ``ShardedExecutor``        — the ``(switch, port)`` layout: the path
  pipelined microbatch by microbatch along the switches, the traffic
  data-parallel across port lanes;
* ``PipelinedExecutor``      — a ``ShardedExecutor`` with one port lane.

Where the reference jits its classify and keeps an executable per batch
shape, these executors classify through a ``GraphCache``
(``runtime/graphs.py``): a captured CUDA graph per (bucket, mode[, hops])
on the card, the same static buffers run eagerly on the CPU.  Each holds
its programs **resident** (``core/plane.py``, ``resident_program``):
``install``, ``evict`` and ``swap`` write them in place, so the graphs stay
valid across reprogramming as the reference's executables do across
``swap``.  One lock per executor (``graphs.Serial``) orders every classify
and every write.  ``graphs=False`` classifies eagerly instead (the
reference's ``jit=False``): the timing phase's yardstick and the tests'
direct path; its ``cache_size()`` is 0.
"""
from __future__ import annotations

import contextlib
from typing import Protocol, runtime_checkable

import torch

from repro_torch.core.packets import PacketBatch
from repro_torch.core.plane import (
    PackedProgram,
    PlaneProfile,
    SwitchEngine,
    _classify_impl,
    copy_program_,
    evict_program_,
    install_program_,
    resident_program,
)
from repro_torch.core.translator import TableProgram
from repro_torch.kernels import ops
from repro_torch.runtime.graphs import GraphCache, Serial

__all__ = ["Executor", "SingleSwitchExecutor", "SequentialPathExecutor",
           "ShardedExecutor", "PipelinedExecutor"]


@runtime_checkable
class Executor(Protocol):
    """What ``DataplaneRuntime`` needs from an execution substrate.

    ``granularity`` is the batch divisibility the executor's layout requires
    (admission rounds buckets up to a multiple of it); ``classify`` maps a
    flat ``[B]`` batch to the classified flat batch in the same packet order,
    on the executor's ``device``; ``swap`` reprograms the plane(s);
    ``cache_size`` counts the captured classifies (one per admission bucket
    and mode).
    """

    @property
    def granularity(self) -> int: ...

    @property
    def device(self): ...

    def classify(self, batch: PacketBatch) -> PacketBatch: ...

    def swap(self, device_programs: list[PackedProgram]) -> None: ...

    def cache_size(self) -> int: ...


class SingleSwitchExecutor:
    """One programmable switch — wraps a ``SwitchEngine`` and the program it
    serves, resident (a copy of ``packed`` of its own, or a fresh empty
    program).  Also carries the control-plane write interface
    (``install``/``evict``) so a serving front can treat the executor as the
    owning plane."""

    granularity = 1

    def __init__(self, profile: PlaneProfile | None = None, *,
                 engine: SwitchEngine | None = None,
                 packed: PackedProgram | None = None,
                 mode: str | None = None, device=None,
                 graphs: bool = True) -> None:
        if engine is None:
            if profile is None:
                raise ValueError("need a PlaneProfile or an existing engine")
            engine = SwitchEngine(profile, mode=mode, device=device)
        self.engine = engine
        self.packed = (engine.empty() if packed is None
                       else resident_program(packed))
        self._serial = Serial(engine.device)
        self._cache = GraphCache(
            lambda pb: _classify_impl(self.packed, pb,
                                      n_classes=engine.profile.max_classes,
                                      mode=engine.mode),
            engine.device, (engine.mode,)) if graphs else None

    @property
    def profile(self) -> PlaneProfile:
        return self.engine.profile

    @property
    def device(self):
        return self.engine.device

    def classify(self, batch: PacketBatch) -> PacketBatch:
        with self._serial:
            if self._cache is None:
                return self.engine.classify(self.packed, batch)
            return self._cache.run(batch)

    def install(self, program: TableProgram, *, vid: int | None = None,
                stages: set[int] | None = None) -> "SingleSwitchExecutor":
        with self._serial:
            install_program_(self.packed, program, self.profile,
                             stages=stages, vid=vid)
        return self

    def evict(self, *, vid: int, kind: str = "all") -> "SingleSwitchExecutor":
        with self._serial:
            evict_program_(self.packed, self.profile, vid=vid, kind=kind)
        return self

    def swap(self, device_programs) -> None:
        """Copy the given program into the resident one (same profile)."""
        if isinstance(device_programs, PackedProgram):
            device_programs = [device_programs]
        (packed,) = device_programs
        with self._serial:
            copy_program_([self.packed], [packed])

    def cache_size(self) -> int:
        return 0 if self._cache is None else len(self._cache)


class SequentialPathExecutor:
    """Apply each hop's partial program in path order on one device.

    The functional reference for every distributed decomposition: status
    codes and SVM partial sums ride the batch between hops exactly as they
    ride the wire.  Each hop is one ``_classify_impl`` in the executor's
    ``mode`` (``kernels/ops.py``), so a hop costs what one switch's classify
    costs: one launch by default, three in ``"unfused"``, L + 2 in
    ``"layerwise"``; the whole chain is one captured graph per bucket.  The
    device is the programs' own (``cuda`` unless they were built on the
    CPU); the executor holds resident copies of them.
    """

    granularity = 1

    def __init__(self, device_programs: list[PackedProgram], *,
                 n_classes: int, mode: str | None = None,
                 graphs: bool = True) -> None:
        if not device_programs:
            raise ValueError("need at least one device program")
        self.device = device_programs[0].device
        if any(p.device != self.device for p in device_programs):
            raise ValueError("every hop's program must be on one device")
        self.programs = tuple(resident_program(p) for p in device_programs)
        self.n_classes = n_classes
        self.mode = ops.resolve_mode(mode, self.device)
        self._serial = Serial(self.device)
        self._cache = GraphCache(self._chain, self.device,
                                 (self.mode, len(self.programs))
                                 ) if graphs else None

    def _chain(self, batch: PacketBatch) -> PacketBatch:
        for packed in self.programs:
            batch = _classify_impl(packed, batch, n_classes=self.n_classes,
                                   mode=self.mode)
        return batch

    def classify(self, batch: PacketBatch) -> PacketBatch:
        with self._serial:
            if self._cache is None:
                return self._chain(batch.to(self.device))
            return self._cache.run(batch)

    def swap(self, device_programs: list[PackedProgram]) -> None:
        """Copy each hop's program into its resident one (same count,
        device and profile)."""
        if len(device_programs) != len(self.programs):
            raise ValueError("device count changed — replan instead")
        if any(p.device != self.device for p in device_programs):
            raise ValueError("every hop's program must be on one device")
        with self._serial:
            copy_program_(self.programs, device_programs)

    def cache_size(self) -> int:
        return 0 if self._cache is None else len(self._cache)


# the fields a classify rewrites: what a lane writes back into its rows
_REWRITTEN = ("rslt", "codes", "svm_acc")


def _device(d) -> torch.device:
    """``d`` as a device with its index (``cuda`` -> the current card), so
    lanes given as ``"cuda"`` and ``"cuda:0"`` count as one device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _to(pb: PacketBatch, device: torch.device) -> PacketBatch:
    if pb.device == device:
        return pb
    return pb.map(lambda x: x.to(device, non_blocking=True))


class ShardedExecutor:
    """The ``(switch, port)`` layout: pipeline the path, shard the traffic.

    A **lane** is one (switch, port) cell of the reference's 2D mesh; lane
    (s, p) sits on ``devices[s * n_ports + p]``.  ``devices`` may repeat a
    device, as a one-card host or the CPU holds a 4 x 1 or 2 x 2 layout
    (the reference emulates devices for that); with ``devices=None`` every
    lane sits on the programs' own device.  Each switch's program is held
    resident once per distinct device of its lanes; the port lanes of one
    switch on one device share that copy read-only.

    The batch ``[n_micro * B_mb]`` splits into ``n_micro`` microbatches,
    each into ``n_ports`` shards of ``B_mb / n_ports`` packets; each shard
    runs down its port's lanes switch by switch, one ``_classify_impl`` in
    the executor's ``mode`` a hop, codes and SVM partial sums riding the
    batch between hops as in ``SequentialPathExecutor``.  The reference
    steps a ring ``n_micro + n_switch - 1`` times and computes its bubbles
    on zeros; the answers are the same without them, so the port skips
    them: a classify makes ``n_micro * n_switch * n_ports`` hops' launches.
    Every shard's answer lands in its own rows, so the result keeps the
    input's packet order (microbatch-major, port shard by port shard).

    On a card each lane runs on a CUDA stream of its own; a hop waits for
    the hop before it (on the lane of the switch before), so lane (s, p)
    works on microbatch m while lane (s + 1, p) works on m - 1.  With every
    lane on one card the whole schedule is captured as one graph per
    (admission bucket, ``n_micro``): the lane streams fork from the
    capturing stream and join back into it.  Lanes on more than one card
    run the same schedule eagerly, each hop's batch moved to the next card
    after the hop before it, and keep no graph (``cache_size()`` 0).  On
    the CPU the schedule runs in order.  Lanes on the CPU and on a card at
    once are refused: no lane gives way to the plain version.
    """

    def __init__(self, device_programs: list[PackedProgram], *,
                 n_classes: int, mode: str | None = None, n_ports: int = 1,
                 n_micro: int | None = None, devices=None,
                 graphs: bool = True) -> None:
        device_programs = list(device_programs)
        self.n_switch = len(device_programs)
        if self.n_switch < 1:
            raise ValueError("need at least one device program")
        self.n_ports = int(n_ports)
        if self.n_ports < 1:
            raise ValueError("need at least one port lane")
        self.n_micro = int(n_micro) if n_micro is not None else self.n_switch
        if self.n_micro < 1:
            raise ValueError("need at least one microbatch")
        need = self.n_switch * self.n_ports
        if devices is None:
            devices = [device_programs[0].device] * need
        if len(devices) < need:
            raise ValueError(
                f"need {need} devices ({self.n_switch} switches x "
                f"{self.n_ports} ports), have {len(devices)}")
        devices = [_device(d) for d in devices[:need]]
        if len({d.type for d in devices}) > 1:
            raise ValueError("lanes on the CPU and on a card at once: put "
                             "every lane on one kind of device")
        self.lanes = tuple(tuple(devices[s * self.n_ports:
                                         (s + 1) * self.n_ports])
                           for s in range(self.n_switch))
        self.device = devices[0]
        self.n_classes = n_classes
        self.mode = ops.resolve_mode(mode, self.device)
        # switch s's resident copy on each distinct device of its lanes
        self._programs = [{d: resident_program(p, d)
                           for d in dict.fromkeys(row)}
                          for p, row in zip(device_programs, self.lanes)]
        self._serial = Serial(self.device)
        self._graphs = graphs and len(set(devices)) == 1
        self._caches: dict[int, GraphCache] = {}
        self._streams: dict[tuple[int, int], torch.cuda.Stream] = {}

    @property
    def granularity(self) -> int:
        # a bucket splits into n_micro microbatches, each into n_ports shards
        return self.n_micro * self.n_ports

    @property
    def programs(self) -> tuple[PackedProgram, ...]:
        """Every resident program, switch by switch: each switch's copy on
        each distinct device of its lanes."""
        return tuple(p for copies in self._programs for p in copies.values())

    def _stream(self, s: int, p: int) -> torch.cuda.Stream:
        stream = self._streams.get((s, p))
        if stream is None:
            stream = self._streams[s, p] = torch.cuda.Stream(self.lanes[s][p])
        return stream

    def _pipeline(self, batch: PacketBatch, n_micro: int) -> PacketBatch:
        """Classify ``batch`` (on ``self.device``) in place, shard by shard
        down the lanes; returns ``batch``.  On a card each lane's stream
        waits for the one whose output it takes (the current stream for the
        first switch), and the current stream joins every lane at the end;
        each hop's batch is held until then, so no lane's memory is freed
        while a later lane may still read it."""
        shard = batch.batch // (n_micro * self.n_ports)
        cuda = self.device.type == "cuda"
        origin = torch.cuda.current_stream(self.device) if cuda else None
        held = []
        for m in range(n_micro):
            for p in range(self.n_ports):
                lo = (m * self.n_ports + p) * shard
                rows = slice(lo, lo + shard)
                x = batch.map(lambda t: t[rows])
                for s, resident in enumerate(self._programs):
                    dev = self.lanes[s][p]
                    lane = contextlib.nullcontext()
                    if cuda:
                        stream = self._stream(s, p)
                        stream.wait_stream(origin if s == 0
                                           else self._stream(s - 1, p))
                        lane = torch.cuda.stream(stream)
                    with lane:
                        x = _classify_impl(resident[dev], _to(x, dev),
                                           n_classes=self.n_classes,
                                           mode=self.mode)
                        held.append(x)
                        if s == self.n_switch - 1:
                            for f in _REWRITTEN:
                                getattr(batch, f)[rows].copy_(
                                    getattr(x, f), non_blocking=True)
        if cuda:
            for stream in self._streams.values():
                origin.wait_stream(stream)
        return batch

    def _cache(self, n_micro: int) -> GraphCache:
        cache = self._caches.get(n_micro)
        if cache is None:
            cache = self._caches[n_micro] = GraphCache(
                lambda pb: self._pipeline(pb, n_micro), self.device,
                (self.mode, self.n_switch, self.n_ports, n_micro))
        return cache

    def _classify(self, batch: PacketBatch, n_micro: int) -> PacketBatch:
        with self._serial:
            if self._graphs:
                return self._cache(n_micro).run(batch)
            return self._pipeline(batch.map(
                lambda x: x.to(self.device, copy=True, non_blocking=True)),
                n_micro)

    def run(self, microbatches: PacketBatch) -> PacketBatch:
        """Pipeline pre-split microbatches ``[n_micro, B_mb, ...]``; returns
        the classified packets as one flat ``[n_micro * B_mb]`` batch in the
        input packet order."""
        n_micro, B_mb = microbatches.packet_id.shape[:2]
        if B_mb % self.n_ports:
            raise ValueError(
                f"microbatch size {B_mb} not divisible by {self.n_ports} "
                "port lanes — admit through DataplaneRuntime")
        flat = microbatches.map(
            lambda x: x.reshape((-1,) + tuple(x.shape[2:])))
        return self._classify(flat, int(n_micro))

    def classify(self, batch: PacketBatch) -> PacketBatch:
        B = batch.batch
        if B % self.granularity:
            raise ValueError(
                f"batch {B} not a multiple of granularity "
                f"{self.granularity} — admit through DataplaneRuntime")
        return self._classify(batch, self.n_micro)

    def _sync(self) -> None:
        """Wait for every card of the lanes, when there is more than one
        (a write there runs on that card's own stream)."""
        cards = {d for row in self.lanes for d in row if d.type == "cuda"}
        if len(cards) > 1:
            for d in cards:
                torch.cuda.synchronize(d)

    def swap(self, device_programs: list[PackedProgram]) -> None:
        """Runtime reprogram: copy each switch's program into every resident
        copy of it, in place; every captured graph is reused."""
        device_programs = list(device_programs)
        if len(device_programs) != self.n_switch:
            raise ValueError("device count changed — replan instead")
        dsts = [p for copies in self._programs for p in copies.values()]
        srcs = [p for p, copies in zip(device_programs, self._programs)
                for _ in copies]
        with self._serial:
            self._sync()
            copy_program_(dsts, srcs)
            self._sync()

    def cache_size(self) -> int:
        """Captured classifies: one per (admission bucket, ``n_micro``)."""
        return sum(len(c) for c in self._caches.values())


class PipelinedExecutor(ShardedExecutor):
    """The 1D pipeline: a ``ShardedExecutor`` with the port axis pinned to
    1.  Its graphs are kept per ``n_micro``, so alternating microbatch
    counts never rebuilds one."""

    def __init__(self, device_programs: list[PackedProgram], *,
                 n_classes: int, mode: str | None = None,
                 n_micro: int | None = None, devices=None,
                 graphs: bool = True) -> None:
        super().__init__(device_programs, n_classes=n_classes, mode=mode,
                         n_ports=1, n_micro=n_micro, devices=devices,
                         graphs=graphs)
