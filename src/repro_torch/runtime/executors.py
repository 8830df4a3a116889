"""Pluggable classify executors behind one ``Executor`` protocol.

Port of ``src/repro/runtime/executors.py``: the protocol,
``SingleSwitchExecutor`` and ``SequentialPathExecutor``.  The multi-card
executors of the JAX package (pipelined ring, 2D switch x port mesh) wait
for a later slice.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

from repro_torch.core.packets import PacketBatch
from repro_torch.core.plane import (
    PackedProgram,
    PlaneProfile,
    SwitchEngine,
    _classify_impl,
)
from repro_torch.core.translator import TableProgram
from repro_torch.kernels import ops

__all__ = ["Executor", "SingleSwitchExecutor", "SequentialPathExecutor"]


@runtime_checkable
class Executor(Protocol):
    """What ``DataplaneRuntime`` needs from an execution substrate.

    ``granularity`` is the batch divisibility the executor's layout requires
    (admission rounds buckets up to a multiple of it); ``classify`` maps a
    flat ``[B]`` batch to the classified flat batch in the same packet order;
    ``swap`` reprograms the plane(s).
    """

    @property
    def granularity(self) -> int: ...

    def classify(self, batch: PacketBatch) -> PacketBatch: ...

    def swap(self, device_programs: list[PackedProgram]) -> None: ...


class SingleSwitchExecutor:
    """One programmable switch — wraps a ``SwitchEngine`` and the program it
    serves.  Also carries the control-plane write interface
    (``install``/``evict``) so a serving front can treat the executor as the
    owning plane."""

    granularity = 1

    def __init__(self, profile: PlaneProfile | None = None, *,
                 engine: SwitchEngine | None = None,
                 packed: PackedProgram | None = None,
                 mode: str | None = None, device=None) -> None:
        if engine is None:
            if profile is None:
                raise ValueError("need a PlaneProfile or an existing engine")
            engine = SwitchEngine(profile, mode=mode, device=device)
        self.engine = engine
        self.packed = packed if packed is not None else engine.empty()

    @property
    def profile(self) -> PlaneProfile:
        return self.engine.profile

    def classify(self, batch: PacketBatch) -> PacketBatch:
        return self.engine.classify(self.packed, batch)

    def install(self, program: TableProgram, *, vid: int | None = None,
                stages: set[int] | None = None) -> "SingleSwitchExecutor":
        self.packed = self.engine.install(self.packed, program, stages,
                                          vid=vid)
        return self

    def evict(self, *, vid: int, kind: str = "all") -> "SingleSwitchExecutor":
        self.packed = self.engine.evict(self.packed, vid=vid, kind=kind)
        return self

    def swap(self, device_programs) -> None:
        if isinstance(device_programs, PackedProgram):
            device_programs = [device_programs]
        (packed,) = device_programs
        self.packed = packed


class SequentialPathExecutor:
    """Apply each hop's partial program in path order on one device.

    The functional reference for every distributed decomposition: status
    codes and SVM partial sums ride the batch between hops exactly as they
    ride the wire.  Each hop is one ``_classify_impl`` in the executor's
    ``mode`` (``kernels/ops.py``), so a hop costs what one switch's classify
    costs: one launch by default, three in ``"unfused"``, L + 2 in
    ``"layerwise"``.  The device is the programs' own (``cuda`` unless they
    were built on the CPU).
    """

    granularity = 1

    def __init__(self, device_programs: list[PackedProgram], *,
                 n_classes: int, mode: str | None = None) -> None:
        self.programs = tuple(device_programs)
        if not self.programs:
            raise ValueError("need at least one device program")
        self.device = self.programs[0].device
        if any(p.device != self.device for p in self.programs):
            raise ValueError("every hop's program must be on one device")
        self.n_classes = n_classes
        self.mode = ops.resolve_mode(mode, self.device)

    def classify(self, batch: PacketBatch) -> PacketBatch:
        batch = batch.to(self.device)
        for packed in self.programs:
            batch = _classify_impl(packed, batch, n_classes=self.n_classes,
                                   mode=self.mode)
        return batch

    def swap(self, device_programs: list[PackedProgram]) -> None:
        if len(device_programs) != len(self.programs):
            raise ValueError("device count changed — replan instead")
        if any(p.device != self.device for p in device_programs):
            raise ValueError("every hop's program must be on one device")
        self.programs = tuple(device_programs)
