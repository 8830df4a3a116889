"""Pluggable classify executors behind one ``Executor`` protocol.

Port of ``src/repro/runtime/executors.py``: the protocol,
``SingleSwitchExecutor`` and ``SequentialPathExecutor``.  The multi-card
executors of the JAX package (pipelined ring, 2D switch x port mesh) wait
for a later slice.

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

from typing import Protocol, runtime_checkable

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

__all__ = ["Executor", "SingleSwitchExecutor", "SequentialPathExecutor"]


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
