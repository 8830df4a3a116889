"""Whole-topology fleet serving: the planner's network as a live data plane.

Port of ``src/repro/serving/fleet.py``.  ``FleetRuntime`` plans a model zoo
onto a topology with ``planner.plan_zoo``, slices per-switch partial zoos
with ``distributed_plane.build_zoo_device_programs``, and serves requests
hop by hop along the plan's wire path — each hosting switch applying its
own ``PackedProgram`` (tables + exec image), intermediates riding in the
packet between hops, the paper's in-packet transport (§5, §7.5).

One compiled template serves the whole fleet.  The reference passes each
hop's program to one jitted ``SwitchEngine.classify`` as an argument, so
its cache holds at most two executables however many devices a plan uses.
A captured CUDA graph reads fixed addresses instead, so the port's
``FleetExecutor`` keeps a **hop pool**: resident programs, one per hop
position (``core/plane.py``, ``resident_program``), chained by
``HopChain`` (``runtime/executors.py``) through one ``GraphCache``
(``runtime/graphs.py``) keyed by the number *n* of hosting hops; an
entry's chain reads the first *n* programs of the pool.  A deployment is
written into positions 0..n-1 in place (``copy_program_``), under the
executor's lock, so no captured graph ever reads a freed or stale tensor
and no resident ``data_ptr`` moves; the pool grows only when a deployment
has more hosting switches than it holds.  ``cache_size()`` is therefore at most (admission
buckets used) x (distinct hosting counts seen), and a retarget to a
hosting count already captured adds no entry.

Failure story (the self-healing loop, ``repro_torch.runtime.control``):
``kill()`` marks a switch dead; a dispatch whose wire path crosses a dead
switch raises ``DeviceFailure`` instead of classifying through it; the
``ControlLoop`` detects, replans the zoo on the surviving topology
(capacity carry-over intact), drains the async server, and ``reinstall``s
the new per-switch programs.  The replan builds the hop programs on the
CPU (the blocking solve runs on a worker thread and never touches the
card); the reinstall copies them into the pool.  Submits retried through
``submit_batch`` return answers bit-identical to the single-switch oracle.

``FleetExecutor`` implements the runtime's ``Executor`` protocol, so the
fleet sits behind the same ``DataplaneRuntime`` admission seam and
``ZooServer`` / ``AsyncZooServer`` fronts as every other substrate.
"""
from __future__ import annotations

import contextlib

import numpy as np

from repro_torch.core.distributed_plane import build_zoo_device_programs
from repro_torch.core.netsim import acorn_serving_time, simulate_serving
from repro_torch.core.packets import PacketBatch
from repro_torch.core.plane import PackedProgram, PlaneProfile, SwitchEngine
from repro_torch.core.planner import (
    DeploymentPlan,
    DeviceModel,
    plan_zoo,
    replan_zoo,
)
from repro_torch.core.topology import Network
from repro_torch.core.translator import TableProgram
from repro_torch.runtime import SizeOrDeadlinePolicy
from repro_torch.runtime.control import ControlLoop, DeviceFailure
from repro_torch.runtime.executors import HopChain
from repro_torch.runtime.policies import BatchingPolicy
from repro_torch.serving.async_server import AsyncResult, AsyncZooServer
from repro_torch.serving.serve import ZooServer

__all__ = ["FleetExecutor", "FleetRuntime"]


class FleetExecutor(HopChain):
    """``Executor`` over a deployment plan's wire path, on a hop pool.

    Holds the template ``SwitchEngine`` (its profile, mode and device), the
    hop pool, and a live ``down`` set shared with the owning
    ``FleetRuntime``.  ``classify`` (and ``classify_record``) runs the
    chain over the hosting hops in path order, keyed by their count, after
    checking that every switch on
    the wire path (hosting or not) is alive, and checks again once the
    answer is copied out; a dead one raises ``DeviceFailure`` for the
    control loop.  ``graphs=False`` classifies eagerly (``cache_size()``
    0).
    """

    def __init__(self, engine: SwitchEngine, wire_path: list[str],
                 devices: list[str], programs: list[PackedProgram], *,
                 down: set[str], graphs: bool = True) -> None:
        self.engine = engine
        self._down = down             # shared with FleetRuntime.kill()
        super().__init__([], n_classes=engine.profile.max_classes,
                         mode=engine.mode, device=engine.device,
                         graphs=graphs)
        self.retarget(wire_path, devices, programs)

    @property
    def pool(self) -> tuple[PackedProgram, ...]:
        """The resident hop programs, by hop position (positions at and
        past ``len(devices)`` are not read by the current deployment)."""
        return tuple(self._hops)

    def retarget(self, wire_path: list[str], devices: list[str],
                 programs: list[PackedProgram]) -> None:
        """Point the executor at a (possibly different-length) deployment —
        the control loop's reinstall step.  Unlike ``swap``, the device set
        may change: that is exactly what a post-fault replan produces.  The
        programs (on any device) are copied into the pool's first
        ``len(devices)`` positions."""
        if len(devices) != len(programs):
            raise ValueError("one program per hosting device required")
        missing = [d for d in devices if d not in wire_path]
        if missing:
            raise ValueError(f"hosting device(s) {missing} not on wire path")
        with self._serial:
            self._write(programs)
            self.wire_path = list(wire_path)
            self.devices = list(devices)

    def _write(self, programs: list[PackedProgram]) -> None:
        """Copy ``programs`` into the pool's first positions, growing the
        pool by empty resident programs first.  The caller holds the lock."""
        while len(self._hops) < len(programs):
            self._hops.append(self.engine.empty())
        super()._write(programs)

    @property
    def programs(self) -> dict[str, PackedProgram]:
        """Each hosting device's resident program."""
        return dict(zip(self.devices, self._hops))

    def _key(self) -> tuple:
        return (len(self.devices),)

    def _check(self) -> None:
        dead = [d for d in self.wire_path if d in self._down]
        if dead:
            raise DeviceFailure(dead[0], path=self.wire_path)

    def classify(self, batch: PacketBatch) -> PacketBatch:
        return self._checked(super().classify, batch)

    def classify_record(self, record, shape) -> PacketBatch:
        return self._checked(super().classify_record, record, shape)

    def _checked(self, classify, *args) -> PacketBatch:
        self._check()
        out = classify(*args)
        # a kill that lands mid-chain: the answer is correct (the tables
        # were intact), but real hardware would have dropped the packet at
        # the dead hop — drop it so the retry path runs
        self._check()
        return out

    def swap(self, device_programs: list[PackedProgram]) -> None:
        """Same-device-set reprogram (the ``Executor`` protocol's swap).
        A changed device count means the deployment changed — that is a
        control-plane ``retarget``, not a swap."""
        if len(device_programs) != len(self.devices):
            raise ValueError("device count changed — retarget (replan) instead")
        with self._serial:
            self._write(list(device_programs))


class FleetRuntime:
    """Plan, serve, and heal a model zoo on a whole topology.

    Construction plans ``programs`` from ``src`` to ``dst`` with
    ``plan_zoo`` and builds the fleet executor behind a ``ZooServer``, on
    ``device`` (``cuda`` unless the caller asks for the CPU, or the
    ``engine``'s).  Synchronous ``classify`` works immediately; ``async
    with fleet.serving():`` adds the ``AsyncZooServer`` front plus the
    ``ControlLoop`` heal cycle, and ``submit``/``submit_batch`` retry
    through heals on ``DeviceFailure``.
    """

    def __init__(self, network: Network, profile: PlaneProfile,
                 programs: list[TableProgram], *, src: str, dst: str,
                 mode: str | None = None, solver: str = "dp",
                 default_device: DeviceModel = DeviceModel(),
                 n_candidate_paths: int = 4,
                 engine: SwitchEngine | None = None, device=None) -> None:
        if not programs:
            raise ValueError("need at least one program to deploy")
        self.network = network
        self.profile = profile
        self.programs = list(programs)
        self.src, self.dst = src, dst
        self.solver = solver
        self.default_device = default_device
        self.n_candidate_paths = n_candidate_paths
        self.down: set[str] = set()
        # one template for the entire fleet (see the module docstring)
        self.engine = engine if engine is not None \
            else SwitchEngine(profile, mode=mode, device=device)
        plans, devices, progs = self._plan()
        self.plans: list[DeploymentPlan] = plans
        self.executor = FleetExecutor(self.engine, plans[0].path, devices,
                                      progs, down=self.down)
        self.zoo = ZooServer(profile, executor=self.executor)
        self.counters = None          # last serving session's ControlCounters
        self._server: AsyncZooServer | None = None
        self._control: ControlLoop | None = None

    # ------------------------------------------------------------- planning
    def _plan(self):
        """Solve, and build the hop programs on the CPU (host work only:
        the executor copies them into its resident pool)."""
        kw = dict(solver=self.solver, default_device=self.default_device,
                  n_candidate_paths=self.n_candidate_paths)
        if self.down:
            plans = replan_zoo(self.programs, self.network, self.src,
                               self.dst, set(self.down), **kw)
        else:
            plans = plan_zoo(self.programs, self.network, self.src,
                             self.dst, **kw)
        devices, progs = build_zoo_device_programs(
            self.programs, plans, self.profile, "cpu")
        return plans, devices, progs

    @property
    def path(self) -> list[str]:
        """The current serving wire path (all plans share it)."""
        return self.plans[0].path

    @property
    def runtime(self):
        return self.zoo.runtime

    # ------------------------------------------------------ fault injection
    def kill(self, device: str) -> None:
        """Mark a switch dead (scripted fault injection / chaos schedule)."""
        if self.network.kind.get(device) != "switch":
            raise ValueError(f"{device!r} is not a switch of this network")
        self.down.add(device)

    def revive(self, device: str) -> None:
        self.down.discard(device)

    # ------------------------------------- control-plane seam (HealableFleet)
    def failed_on_path(self) -> set[str]:
        return self.down & set(self.executor.wire_path)

    def replan_sync(self):
        """Re-solve the zoo on the surviving topology (blocking CPU work —
        the control loop runs this on a worker thread).  Raises
        ``RuntimeError`` when no feasible deployment survives."""
        return self._plan()

    def reinstall(self, plans, devices, programs) -> None:
        """Retarget the executor to a post-replan deployment (called by the
        control loop between drain and release — never under traffic)."""
        self.plans = list(plans)
        self.executor.retarget(plans[0].path, devices, programs)

    # -------------------------------------------------------------- serving
    def classify(self, features, *, mid: int = 0, vid=0) -> np.ndarray:
        """Synchronous classify through the fleet (admission-bucketed)."""
        return self.zoo.classify(features, mid=mid, vid=vid)

    def make_request(self, features, *, mid: int = 0, vid=0) -> PacketBatch:
        return self.zoo.make_request(features, mid=mid, vid=vid)

    @contextlib.asynccontextmanager
    async def serving(self, *, policy: BatchingPolicy | None = None,
                      probe_interval_s: float = 0.02):
        """Live-traffic session: ``AsyncZooServer`` front + ``ControlLoop``
        heal cycle.  Control counters flow through ``latency_stats()``."""
        if self._server is not None:
            raise RuntimeError("fleet is already serving")
        if policy is None:
            policy = SizeOrDeadlinePolicy(max_batch=64, max_wait_us=500.0)
        server = AsyncZooServer(self.zoo, policy=policy)
        control = ControlLoop(self, server,
                              probe_interval_s=probe_interval_s)
        self.counters = control.counters
        async with server:
            await control.start()
            self._server, self._control = server, control
            try:
                yield self
            finally:
                self._server = self._control = None
                await control.stop()

    @property
    def control(self) -> ControlLoop | None:
        return self._control

    async def submit(self, features, *, mid: int = 0, vid=0) -> AsyncResult:
        if self._server is None:
            raise RuntimeError(
                "fleet is not serving — use 'async with fleet.serving()'")
        return await self.submit_batch(
            self.make_request(features, mid=mid, vid=vid))

    async def submit_batch(self, pb: PacketBatch) -> AsyncResult:
        """Submit with self-healing: a dispatch that hits a dead device
        fails with ``DeviceFailure``; we heal (replan + drain + reinstall)
        and retry — the answer the caller finally sees is computed entirely
        on one consistent deployment, so it stays oracle-identical."""
        if self._server is None:
            raise RuntimeError(
                "fleet is not serving — use 'async with fleet.serving()'")
        # every retry heals at least one dead device off the path, so the
        # switch count bounds the retries a hostile schedule can force
        retries = self.network.n_switches + 1
        while True:
            try:
                return await self._server.submit_batch(pb)
            except DeviceFailure:
                if retries <= 0:
                    raise
                retries -= 1
                self._control.note_retry()
                await self._control.heal()

    def latency_stats(self) -> dict:
        if self._server is None:
            raise RuntimeError(
                "fleet is not serving — use 'async with fleet.serving()'")
        return self._server.latency_stats()

    # ----------------------------------------------------- netsim integration
    def serving_time(self) -> float:
        """Modeled per-request J_L of the current deployment (s)."""
        return acorn_serving_time(self.plans[0])

    def modeled_latencies(self, *, n: int = 1000,
                          arrival_rate_rps: float | None = None,
                          seed: int = 0) -> np.ndarray:
        """``netsim.simulate_serving`` samples for the current deployment,
        with the last serving session's heal windows applied as downtime."""
        windows = tuple(self.counters.downtime_windows) \
            if self.counters is not None else ()
        return simulate_serving(
            self.serving_time(), n=n, seed=seed,
            arrival_rate_rps=arrival_rate_rps, downtime_windows=windows)
