"""Self-healing control plane for whole-topology serving (beyond paper §9).

Port of ``src/repro/runtime/control.py``: asyncio only, the same cycle and
the same counters.  The port keeps its own copy because the reference's
reaches JAX through ``repro.runtime.__init__``.  In the port the fleet's
reinstall writes the replanned hop programs into its executor's resident
hop pool (``repro_torch.serving.fleet``), so the captured graphs stay
valid across a heal.

The paper's planner replans around dead devices offline (``planner.replan``);
this module makes that loop *live*.  ``ControlLoop`` sits next to an
``AsyncZooServer`` and runs the availability cycle against a fleet:

    detect -> replan -> drain -> reinstall

* **detect** — a heartbeat probe (and the data path itself, via
  ``DeviceFailure`` raised when a dispatch's wire path crosses a dead
  device) notices that a serving-path device is down;
* **replan** — the zoo is re-solved on the surviving topology with the
  per-version capacity carry-over intact (``planner.replan_zoo``); the
  solve runs on a worker thread so the event loop keeps accepting submits;
* **drain** — the server holds new dispatches and waits for the in-flight
  one to land, so no batch is ever classified half-old half-new;
* **reinstall** — the fleet retargets its executor to the new path and
  per-device ``ExecImage`` programs, then the server releases the hold.

Ordering is what makes the answers stay bit-identical: a request either
completes on the old deployment, or fails with ``DeviceFailure`` and is
retried after ``heal()`` — never a mix.  ``ControlCounters`` records the
cycle (failures/replans/drains/reinstalls, heal latency, downtime windows)
and is surfaced through ``AsyncZooServer.latency_stats()`` via
``add_stats_source`` — one stats path for data plane and control plane.

Layering: this module must not import ``repro_torch.serving`` — the fleet and
server come in through the ``HealableFleet`` / ``DrainableServer``
protocols below (same inversion as the ``Executor`` seam).
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import Protocol, runtime_checkable

__all__ = [
    "DeviceFailure",
    "ControlCounters",
    "ControlLoop",
    "HealableFleet",
    "DrainableServer",
]


class DeviceFailure(RuntimeError):
    """A wire path crosses a dead device — the data-path failure signal.

    Raised by the fleet executor instead of classifying through dead
    hardware; the serving layer catches it, runs ``ControlLoop.heal()``,
    and retries the request on the post-replan deployment."""

    def __init__(self, device: str, *, path: list[str] | None = None) -> None:
        self.device = device
        self.path = list(path) if path is not None else None
        msg = f"device {device!r} is down"
        if self.path is not None:
            msg += f" on serving path {self.path}"
        super().__init__(msg)


@dataclasses.dataclass
class ControlCounters:
    """Lifetime control-plane accounting, merged into ``latency_stats()``."""

    failures_detected: int = 0
    replans: int = 0
    drains: int = 0
    reinstalls: int = 0
    retries: int = 0
    heal_failures: int = 0          # replan infeasible: no surviving deployment
    interrupted_heals: int = 0      # server shut down mid-heal (drain refused
                                    # or the owned hold was broken by stop())
    last_heal_ms: float = 0.0
    total_downtime_s: float = 0.0
    # (t0, t1) heal windows on the serving clock (seconds since loop start)
    # — netsim.simulate_serving takes these as its downtime_windows.
    downtime_windows: list[tuple[float, float]] = \
        dataclasses.field(default_factory=list)

    def as_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["downtime_windows"] = [tuple(w) for w in self.downtime_windows]
        return out


@runtime_checkable
class HealableFleet(Protocol):
    """What the control loop needs from a fleet (``serving/fleet.py``)."""

    def failed_on_path(self) -> set[str]:
        """Dead devices on the current serving wire path."""
        ...

    def replan_sync(self):
        """Re-solve the deployment on the surviving topology (blocking CPU
        work).  Returns ``(plans, devices, programs)``; raises
        ``RuntimeError`` when no feasible deployment survives."""
        ...

    def reinstall(self, plans, devices, programs) -> None:
        """Retarget the executor to the post-replan deployment."""
        ...


@runtime_checkable
class DrainableServer(Protocol):
    """What the control loop needs from the async server."""

    async def drain(self) -> None: ...
    def release(self) -> None: ...
    def add_stats_source(self, name: str, fn) -> None: ...


class ControlLoop:
    """Failure detection + heal cycle over one fleet/server pair.

    ``start()`` launches the heartbeat probe task; ``heal()`` runs one
    serialized detect->replan->drain->reinstall cycle (idempotent — a raced
    call that finds the path already healthy returns ``False``).  A replan
    with no surviving deployment raises ``RuntimeError`` out of ``heal()``;
    the probe task counts it and keeps probing, submitters see it on retry.
    """

    def __init__(self, fleet: HealableFleet, server: DrainableServer, *,
                 probe_interval_s: float = 0.02) -> None:
        self.fleet = fleet
        self.server = server
        self.probe_interval_s = float(probe_interval_s)
        self.counters = ControlCounters()
        self._lock: asyncio.Lock | None = None
        self._task: asyncio.Task | None = None
        self._t0 = 0.0
        server.add_stats_source("control", self.counters.as_dict)

    async def start(self) -> "ControlLoop":
        if self._task is not None:
            raise RuntimeError("control loop already started")
        loop = asyncio.get_running_loop()
        self._lock = asyncio.Lock()
        self._t0 = loop.time()
        self._task = loop.create_task(self._probe_loop(),
                                      name="fleet-control-probe")
        return self

    async def stop(self) -> None:
        if self._task is None:
            return
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass
        self._task = None

    async def _probe_loop(self) -> None:
        """Heartbeat detection: poll serving-path device health.  An
        infeasible heal is counted, not fatal — the probe keeps running and
        the failure surfaces on the next submit's retry."""
        while True:
            await asyncio.sleep(self.probe_interval_s)
            if self.fleet.failed_on_path():
                try:
                    await self.heal()
                except RuntimeError:
                    pass        # counted in heal(); submitters surface it

    async def heal(self) -> bool:
        """One detect->replan->drain->reinstall cycle.

        Serialized on a lock so the probe task and concurrent retrying
        submitters collapse into a single replan.  Returns ``True`` if a
        reinstall happened, ``False`` if the path was already healthy."""
        loop = asyncio.get_running_loop()
        async with self._lock:
            failed = self.fleet.failed_on_path()
            if not failed:
                return False          # raced: an earlier heal already fixed it
            t_detect = loop.time()
            self.counters.failures_detected += len(failed)
            try:
                # the ILP/DP solve is blocking CPU work — run it off-loop so
                # the server keeps accepting submits mid-replan
                plans, devices, programs = await loop.run_in_executor(
                    None, self.fleet.replan_sync)
            except RuntimeError:
                self.counters.heal_failures += 1
                raise
            self.counters.replans += 1
            # drain BEFORE reinstall: the in-flight dispatch completes (or
            # fails with DeviceFailure and retries) on the old deployment —
            # no batch sees a half-swapped program set.  A server that is
            # shutting down refuses the drain barrier (RuntimeError): the
            # heal cannot proceed against a flushing server, so it is
            # counted as interrupted and surfaced, never applied half-way.
            try:
                await self.server.drain()
            except RuntimeError:
                self.counters.interrupted_heals += 1
                raise
            self.counters.drains += 1
            broken = None
            try:
                self.fleet.reinstall(plans, devices, programs)
            finally:
                try:
                    self.server.release()
                except RuntimeError as e:
                    # stop() broke our hold mid-reinstall: the server
                    # already flushed and shut down underneath the barrier.
                    # Capture rather than raise here so a reinstall
                    # exception (if any) is not masked by the finally.
                    broken = e
            if broken is not None:
                self.counters.interrupted_heals += 1
                raise RuntimeError(
                    "server stopped during heal: the drain barrier was "
                    "broken by stop() while the reinstall ran") from broken
            self.counters.reinstalls += 1
            t_done = loop.time()
            self.counters.last_heal_ms = (t_done - t_detect) * 1e3
            self.counters.total_downtime_s += t_done - t_detect
            self.counters.downtime_windows.append(
                (t_detect - self._t0, t_done - self._t0))
            return True

    def note_retry(self) -> None:
        """A submitter retried a request after ``DeviceFailure``."""
        self.counters.retries += 1
