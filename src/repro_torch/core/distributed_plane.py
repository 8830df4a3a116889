"""Distributed ACORN plane: per-switch program slicing (paper Fig. 2).

Port of ``build_device_programs`` and ``build_zoo_device_programs`` of
``src/repro/core/distributed_plane.py``.  The deployment plan
(``core/planner.py``) assigns program stages to the switches of a path;
each switch holds only *its* table entries, a partial ``PackedProgram`` at
the full profile, and a packet's intermediates (status codes, SVM partial
sums) ride along between hops — the paper's in-packet intermediate
transport.  This module is the install side; the execution side is
``runtime.executors.SequentialPathExecutor``.  The hop programs come back
as a ``PathPrograms``, a list that also records which switch each hop is
and which program stages of which version it holds, for the executor's
``path_stats()``.  The JAX package's deprecated ``run_sequential`` and
``PipelinedPlane`` shims have no counterpart.
"""
from __future__ import annotations

from repro_torch.core.plane import (
    PlaneProfile,
    empty_program,
    install_program,
)
from repro_torch.core.planner import DeploymentPlan
from repro_torch.core.translator import TableProgram

__all__ = ["PathPrograms", "build_device_programs",
           "build_zoo_device_programs"]


class PathPrograms(list):
    """A path's partial programs in path order (a list of
    ``PackedProgram``), with where each sits: ``switches[i]`` is hop i's
    switch and ``stages[i]`` maps each version it hosts to the program
    stages of that version it holds, in order (the plans'
    ``device_stages()``)."""

    def __init__(self, programs, switches, stages) -> None:
        super().__init__(programs)
        self.switches = tuple(switches)
        self.stages = tuple(stages)


def build_device_programs(
    program: TableProgram,
    plan: DeploymentPlan,
    profile: PlaneProfile,
    device=None,
) -> tuple[list[str], PathPrograms]:
    """One partial PackedProgram per programmable switch on the plan's
    path, in path order, on ``device`` (``cuda`` unless the caller asks for
    the CPU).  Each carries its own exec image, built at this install step
    from exactly the entries the switch owns."""
    per_dev = plan.device_stages()
    devices = [d for d in plan.path if d in per_dev]
    progs = [install_program(empty_program(profile, device), program, profile,
                             stages=per_dev[d])
             for d in devices]
    return devices, PathPrograms(
        progs, devices, [{program.vid: sorted(per_dev[d])} for d in devices])


def build_zoo_device_programs(
    programs: list[TableProgram],
    plans: list[DeploymentPlan],
    profile: PlaneProfile,
    device=None,
) -> tuple[list[str], PathPrograms]:
    """Merge per-version deployment plans into per-switch *partial zoos*.

    Each version's plan may place its stages on different switches of the
    path (``plan_zoo`` carries capacity over between versions), so a switch
    hosts only the slots of the versions whose stages landed on it.  All
    plans must share one path: the packet visits the switches in one wire
    order whichever versions each hop serves.
    """
    if len(programs) != len(plans):
        raise ValueError("one plan per program version required")
    if not plans:
        return [], PathPrograms([], [], [])
    path = plans[0].path
    for p in plans[1:]:
        if p.path != path:
            raise ValueError(
                "zoo plans must share a path (plan them with plan_zoo, which "
                "pins later versions to the first version's path)"
            )
    devices = [d for d in path
               if any(d in p.device_stages() for p in plans)]
    progs, held = [], []
    for d in devices:
        packed, own = empty_program(profile, device), {}
        for program, plan in zip(programs, plans):
            stages = plan.device_stages().get(d)
            if stages:
                packed = install_program(packed, program, profile,
                                         stages=stages, vid=program.vid)
                own[program.vid] = sorted(stages)
        progs.append(packed)
        held.append(own)
    return devices, PathPrograms(progs, devices, held)
