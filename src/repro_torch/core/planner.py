"""ACORN's deployment plan optimizer (paper §5 + Appendix B).

Multi-objective placement of program stages onto programmable devices along a
path:  J = w_L*J_latency + w_D*J_devices + w_O*J_overhead.

Two solvers, cross-validated in tests:

* ``milp``  — the paper's formulation (scipy ``milp``/HiGHS, same as the
  paper's implementation §7.1) with decision variables x_{ijk} (program stage
  i → slot j of device k), y_k (device used), c_k (last stage on k), per-path.
* ``dp``    — beyond-paper exact dynamic program over (stage, path position):
  for homogeneous per-device slots the placement problem is a monotone
  sequence-partition problem, solvable in O(T_s^2 · |P|) — provably the same
  optimum, ~100x faster (benchmarked in benchmarks/fig8_planner.py).

The paper's *parallel decomposition* is reproduced: the outer loop enumerates
candidate paths (Yen k-shortest) and solves each path's subproblem
independently; "for random forests and SVMs with multiple hyperplanes, we run
the optimizer multiple times, each time for one tree or one hyperplane"
(App. B) — ``plan_program`` plans unit-by-unit with capacity carry-over, and
enforces the SVM colocation integrity constraint (all ``svm_mul`` tables of a
hyperplane on one device).

Faithfulness notes (deviations documented in DESIGN.md §2):
* App. B writes ``sum_i y_i = 1`` and ``sum_j x_{ijk} = y_k ∀i,k`` — taken
  literally these force one device hosting every stage; we implement the
  evidently intended guarantee constraints (x ≤ y, y = OR_i x).
* The stage-dependency family is encoded compactly as a strictly increasing
  rank ``pos(k)*D_s + j`` over consecutive stages — equivalent to the paper's
  prefix constraints for totally ordered stages (ours are).

Fault handling (beyond paper §9): ``replan`` re-solves with failed devices
excluded — the runtime swap path for a dead switch.

Copied from ``src/repro/core/planner.py`` of the JAX package; only the import
paths differ (the port imports nothing from ``repro``).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import scipy.sparse as sp
from scipy.optimize import Bounds, LinearConstraint, milp

from repro_torch.core import packets
from repro_torch.core.topology import Network
from repro_torch.core.translator import StageSpec, TableProgram

__all__ = [
    "DeviceModel",
    "LatencyModel",
    "PathProblem",
    "Plan",
    "DeploymentPlan",
    "solve_path",
    "plan_program",
    "plan_zoo",
    "replan",
    "replan_zoo",
]


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Per-device resource profile (paper §2.1: O(10)MB memory, <2 dozen stages)."""

    n_stages: int = 20
    tcam_per_stage: int = 4096
    sram_per_stage: int = 16384
    max_tables_per_stage: int = 16  # Tofino: 16 logical tables per stage
    programmable: bool = True


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    l_e: float = 1.0e-6          # per-switch pipeline execution (s)
    l_p: float = 2.0e-6          # per-hop propagation (s)
    rate_bps: float = 10e9       # link rate for transmission delay

    def t_bytes(self, nbytes: int) -> float:
        return nbytes * 8.0 / self.rate_bps


def _stage_fits(stage: StageSpec, dev: DeviceModel) -> bool:
    return (
        stage.tcam_entries <= dev.tcam_per_stage
        and stage.sram_entries <= dev.sram_per_stage
        and len(stage.tables) <= dev.max_tables_per_stage
    )


@dataclasses.dataclass
class PathProblem:
    """One path's placement subproblem."""

    stages: list[StageSpec]
    path: list[str]                       # src host ... dst host
    devices: dict[str, DeviceModel]
    free_slots: dict[str, int]            # remaining stage slots per device
    weights: tuple[float, float, float] = (1 / 3, 1 / 3, 1 / 3)
    latency: LatencyModel = LatencyModel()
    request_bytes: int = 128
    response_bytes: int = packets.response_bytes()
    colocate: dict[int, int] | None = None  # stage idx -> group id
    min_position: int = 0  # cross-unit dependency: earliest allowed path position


@dataclasses.dataclass
class Plan:
    path: list[str]
    assignment: dict[int, str]            # program-stage index -> device
    objective: float
    breakdown: dict
    solver: str
    solve_time: float

    def device_stages(self) -> dict[str, set[int]]:
        out: dict[str, set[int]] = {}
        for i, d in self.assignment.items():
            out.setdefault(d, set()).add(i)
        return out


def _objective_terms(prob: PathProblem, assignment: dict[int, str]) -> tuple[float, dict]:
    w_L, w_D, w_O = prob.weights
    lat = prob.latency
    hops = len(prob.path) - 1
    used = sorted(set(assignment.values()), key=prob.path.index)
    n_used = len(used)
    last_dev = assignment[max(assignment)]
    q = prob.path.index(last_dev)          # edges traversed with request size
    t_rq = lat.t_bytes(prob.request_bytes)
    t_rs = lat.t_bytes(prob.response_bytes)
    J_exe = lat.l_e * n_used
    J_prop = lat.l_p * hops
    J_trs = t_rq * q + t_rs * (hops - q)
    J_L = J_exe + J_prop + J_trs
    J_D = float(n_used)
    J_O = prob.request_bytes * q + prob.response_bytes * (hops - q)
    J = w_L * J_L + w_D * J_D + w_O * J_O
    return J, {
        "J": J, "J_L": J_L, "J_D": J_D, "J_O": J_O,
        "J_exe": J_exe, "J_prop": J_prop, "J_trsmt": J_trs,
        "hops": hops, "last_pos": q, "devices_used": used,
    }


# --------------------------------------------------------------------------
# MILP solver (the paper's)
# --------------------------------------------------------------------------
def _solve_milp(prob: PathProblem) -> Plan | None:
    t0 = time.perf_counter()
    stages = prob.stages
    T_s = len(stages)
    devs = [
        d for d in prob.path
        if d in prob.devices and prob.devices[d].programmable
        and prob.free_slots.get(d, 0) > 0
        and prob.path.index(d) >= prob.min_position
    ]
    if not devs:
        return None
    pos = {d: prob.path.index(d) for d in devs}
    slots = {d: prob.free_slots[d] for d in devs}
    Dmax = max(slots.values())
    K = len(devs)

    # variable layout: x[i, j, k] then y[k] then c[k] then g[grp, k]
    def xi(i, j, k):
        return (i * Dmax + j) * K + k

    nx = T_s * Dmax * K
    ny = K
    groups = sorted(set((prob.colocate or {}).values()))
    gidx = {g: gi for gi, g in enumerate(groups)}
    ng = len(groups) * K
    n_var = nx + ny + K + ng
    yk = lambda k: nx + k
    ck = lambda k: nx + ny + k
    gk = lambda g, k: nx + ny + K + gidx[g] * K + k

    w_L, w_D, w_O = prob.weights
    lat = prob.latency
    hops = len(prob.path) - 1
    t_rq = lat.t_bytes(prob.request_bytes)
    t_rs = lat.t_bytes(prob.response_bytes)
    c_obj = np.zeros(n_var)
    for k, d in enumerate(devs):
        c_obj[yk(k)] = w_L * lat.l_e + w_D
        c_obj[ck(k)] = (
            w_L * (t_rq * pos[d] + t_rs * (hops - pos[d]))
            + w_O * (prob.request_bytes * pos[d] + prob.response_bytes * (hops - pos[d]))
        )

    rows, cols, vals, lbs, ubs = [], [], [], [], []
    r = 0

    def add_row(entries, lb, ub):
        nonlocal r
        for c_, v in entries:
            rows.append(r)
            cols.append(c_)
            vals.append(v)
        lbs.append(lb)
        ubs.append(ub)
        r += 1

    fits = {
        (i, k): _stage_fits(stages[i], prob.devices[d])
        for i in range(T_s)
        for k, d in enumerate(devs)
    }
    # 1. each program stage placed exactly once (on a feasible slot)
    for i in range(T_s):
        ent = [
            (xi(i, j, k), 1.0)
            for k, d in enumerate(devs)
            for j in range(slots[d])
            if fits[(i, k)]
        ]
        if not ent:
            return None  # stage fits nowhere on this path
        add_row(ent, 1, 1)
    # 1b. infeasible placements forced to 0
    for i in range(T_s):
        for k, d in enumerate(devs):
            for j in range(Dmax):
                if j >= slots[d] or not fits[(i, k)]:
                    add_row([(xi(i, j, k), 1.0)], 0, 0)
    # 2. one program stage per device slot
    for k, d in enumerate(devs):
        for j in range(slots[d]):
            add_row([(xi(i, j, k), 1.0) for i in range(T_s)], 0, 1)
    # 3. guarantee: x <= y
    for i in range(T_s):
        for k in range(K):
            for j in range(slots[devs[k]]):
                add_row([(xi(i, j, k), 1.0), (yk(k), -1.0)], -1, 0)
    # 4. dependency: strictly increasing (position, slot) rank
    rank = {
        (j, k): float(pos[devs[k]] * (Dmax + 1) + j)
        for k in range(K)
        for j in range(Dmax)
    }
    for i in range(T_s - 1):
        ent = [(xi(i + 1, j, k), rank[(j, k)]) for k in range(K) for j in range(Dmax)]
        ent += [(xi(i, j, k), -rank[(j, k)]) for k in range(K) for j in range(Dmax)]
        add_row(ent, 1, np.inf)
    # 5. last-stage indicator: c_k = sum_j x[T_s-1, j, k]
    for k in range(K):
        ent = [(xi(T_s - 1, j, k), 1.0) for j in range(Dmax)] + [(ck(k), -1.0)]
        add_row(ent, 0, 0)
    # 6. colocation groups (SVM integrity constraint)
    if prob.colocate:
        for i, g in prob.colocate.items():
            for k in range(K):
                ent = [(xi(i, j, k), 1.0) for j in range(Dmax)] + [(gk(g, k), -1.0)]
                add_row(ent, 0, 0)
        for g in groups:
            add_row([(gk(g, k), 1.0) for k in range(K)], 1, 1)

    A = sp.csr_matrix((vals, (rows, cols)), shape=(r, n_var))
    res = milp(
        c=c_obj,
        constraints=LinearConstraint(A, np.asarray(lbs), np.asarray(ubs)),
        integrality=np.ones(n_var),
        bounds=Bounds(0, 1),
    )
    if not res.success:
        return None
    x = np.round(res.x).astype(int)
    assignment: dict[int, str] = {}
    for i in range(T_s):
        for k, d in enumerate(devs):
            for j in range(slots[d]):
                if x[xi(i, j, k)]:
                    assignment[i] = d
    obj, breakdown = _objective_terms(prob, assignment)
    return Plan(prob.path, assignment, obj, breakdown, "milp", time.perf_counter() - t0)


# --------------------------------------------------------------------------
# DP solver (beyond-paper exact, homogeneous slots)
# --------------------------------------------------------------------------
def _solve_dp(prob: PathProblem) -> Plan | None:
    t0 = time.perf_counter()
    stages = prob.stages
    T_s = len(stages)
    devs = [
        d for d in prob.path
        if d in prob.devices and prob.devices[d].programmable
        and prob.free_slots.get(d, 0) > 0
        and prob.path.index(d) >= prob.min_position
    ]
    if not devs:
        return None
    P = len(devs)
    w_L, w_D, w_O = prob.weights
    lat = prob.latency
    dev_cost = w_L * lat.l_e + w_D

    fits = np.array(
        [[_stage_fits(stages[i], prob.devices[d]) for d in devs] for i in range(T_s)]
    )
    cap = np.array([prob.free_slots[d] for d in devs])

    # Colocation: a group's stages must land on one device. Because groups are
    # contiguous runs of stages in our programs, it suffices to forbid cutting
    # inside a group.
    coloc = prob.colocate or {}
    same_group_as_prev = np.zeros(T_s, bool)
    for i in range(1, T_s):
        same_group_as_prev[i] = (
            i in coloc and (i - 1) in coloc and coloc[i] == coloc[i - 1]
        )

    INF = float("inf")
    # f[i][p]: min cost placing stages [0, i) with stage i-1 on device p.
    f = np.full((T_s + 1, P), INF)
    back = np.full((T_s + 1, P), -1, dtype=np.int64)  # run start stage
    backp = np.full((T_s + 1, P), -1, dtype=np.int64)  # previous device index

    for p in range(P):
        # first run [0, r) on device p
        for r in range(1, min(cap[p], T_s) + 1):
            if not fits[:r, p].all():
                break
            if r < T_s and same_group_as_prev[r]:
                continue
            if f[r, p] > dev_cost:
                f[r, p] = dev_cost
                back[r, p] = 0
                backp[r, p] = -1
    for i in range(1, T_s):
        for p in range(P):
            if f[i, p] == INF:
                continue
            for p2 in range(p + 1, P):
                for r in range(1, min(cap[p2], T_s - i) + 1):
                    if not fits[i : i + r, p2].all():
                        break
                    if i + r < T_s and same_group_as_prev[i + r]:
                        continue
                    if same_group_as_prev[i]:
                        continue  # can't cut inside a group
                    cost = f[i, p] + dev_cost
                    if cost < f[i + r, p2]:
                        f[i + r, p2] = cost
                        back[i + r, p2] = i
                        backp[i + r, p2] = p

    hops = len(prob.path) - 1
    t_rq = lat.t_bytes(prob.request_bytes)
    t_rs = lat.t_bytes(prob.response_bytes)
    best, best_p = INF, -1
    for p in range(P):
        if f[T_s, p] == INF:
            continue
        q = prob.path.index(devs[p])
        tail = (
            w_L * (lat.l_p * hops + t_rq * q + t_rs * (hops - q))
            + w_O * (prob.request_bytes * q + prob.response_bytes * (hops - q))
        )
        tot = f[T_s, p] + tail
        if tot < best:
            best, best_p = tot, p
    if best_p < 0:
        return None
    # reconstruct
    assignment: dict[int, str] = {}
    i, p = T_s, best_p
    while i > 0:
        start = int(back[i, p])
        for s in range(start, i):
            assignment[s] = devs[p]
        i, p = start, int(backp[i, p])
    obj, breakdown = _objective_terms(prob, assignment)
    return Plan(prob.path, assignment, obj, breakdown, "dp", time.perf_counter() - t0)


def _left_pack(prob: PathProblem, plan: Plan) -> Plan:
    """Canonicalize an optimal assignment: re-pack stages greedily onto the
    *same* device set in path order.  The combined objective depends only on
    (devices used, last-stage position), so this is objective-preserving —
    and it makes DP and MILP tie-break identically while leaving maximal free
    slots on downstream devices for later planner units.
    """
    used = sorted(set(plan.assignment.values()), key=prob.path.index)
    coloc = prob.colocate or {}
    stages = prob.stages
    new: dict[int, str] = {}
    di = 0
    cap = prob.free_slots.get(used[0], 0)
    i = 0
    while i < len(stages):
        # atomic block: a colocation group moves as one
        j = i + 1
        while j < len(stages) and j in coloc and (j - 1) in coloc \
                and coloc[j] == coloc[j - 1]:
            j += 1
        blk = list(range(i, j))
        placed = False
        while di < len(used):
            d = used[di]
            ok = (cap >= len(blk)
                  and all(_stage_fits(stages[b], prob.devices[d]) for b in blk))
            if ok:
                for b in blk:
                    new[b] = d
                cap -= len(blk)
                placed = True
                break
            di += 1
            cap = prob.free_slots.get(used[di], 0) if di < len(used) else 0
        if not placed:
            return plan  # cannot left-pack (shouldn't happen); keep original
        i = j
    # every used device must still host >= 1 stage, else the solver missed a
    # cheaper plan — keep the original in that (theoretical) case
    if set(new.values()) != set(used):
        return plan
    obj, breakdown = _objective_terms(prob, new)
    if obj > plan.objective + 1e-9:
        return plan
    return Plan(plan.path, new, obj, breakdown, plan.solver, plan.solve_time)


def solve_path(prob: PathProblem, solver: str = "dp") -> Plan | None:
    if solver == "milp":
        plan = _solve_milp(prob)
    elif solver == "dp":
        plan = _solve_dp(prob)
    else:
        raise ValueError(f"unknown solver {solver}")
    return _left_pack(prob, plan) if plan is not None else None


# --------------------------------------------------------------------------
# Whole-program planning (per-tree / per-hyperplane decomposition + paths)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class DeploymentPlan:
    path: list[str]
    assignment: dict[int, str]            # global stage idx -> device
    objective: float
    breakdown: dict
    solver: str
    solve_time: float
    unit_plans: list[Plan] = dataclasses.field(default_factory=list)

    def device_stages(self) -> dict[str, set[int]]:
        out: dict[str, set[int]] = {}
        for i, d in self.assignment.items():
            out.setdefault(d, set()).add(i)
        return out


def _program_units(program: TableProgram) -> list[tuple[list[int], dict[int, int] | None]]:
    """Split a program into planner units (paper App. B): per tree-block for
    forests, per hyperplane for SVMs; predict/voting stages form the final
    unit.  Returns [(global stage indices, colocate map per unit)]."""
    specs = program.stages()
    units: list[tuple[list[int], dict[int, int] | None]] = []
    if program.kind in ("dt", "rf"):
        blocks: dict[int, list[int]] = {}
        final: list[int] = []
        for s in specs:
            kinds = {t.kind for t in s.tables}
            if kinds <= {"dt_layer"}:
                blk = min(t.tree for t in s.tables) // program.trees_per_block
                blocks.setdefault(blk, []).append(s.index)
            else:
                final.append(s.index)
        for blk in sorted(blocks):
            units.append((blocks[blk], None))
        units.append((final, None))
    else:  # svm
        by_h: dict[int, list[int]] = {}
        final = []
        for s in specs:
            hs = s.hyperplanes
            if hs:
                by_h.setdefault(hs[0], []).append(s.index)
            else:
                final.append(s.index)
        for h in sorted(by_h):
            colocate = {i: h for i in range(len(by_h[h]))}  # unit-local indices
            units.append((by_h[h], colocate))
        units.append((final, None))
    return [u for u in units if u[0]]


def plan_program(
    program: TableProgram,
    network: Network,
    src: str,
    dst: str,
    *,
    devices: dict[str, DeviceModel] | None = None,
    default_device: DeviceModel = DeviceModel(),
    weights: tuple[float, float, float] = (1 / 3, 1 / 3, 1 / 3),
    latency: LatencyModel = LatencyModel(),
    solver: str = "dp",
    n_candidate_paths: int = 4,
    exclude: set[str] | None = None,
    reserved_slots: dict[str, int] | None = None,
    candidate_paths: list[list[str]] | None = None,
) -> DeploymentPlan:
    """Full ACORN planning: candidate paths × per-unit placement.

    ``reserved_slots`` carries capacity already consumed by previously planned
    programs (the model-zoo per-version assignment: versions planned earlier
    shrink the slots available to later ones, pushing them onto other devices
    of the path).  ``candidate_paths`` overrides path enumeration — used by
    ``plan_zoo`` to pin every version to one wire path.
    """
    t0 = time.perf_counter()
    specs = program.stages()
    devices = devices or {}
    exclude = exclude or set()
    reserved_slots = reserved_slots or {}
    req_bytes = packets.request_bytes(
        program.n_features,
        n_trees=program.n_trees,
        n_hyperplanes=program.n_hyperplanes,
    )
    paths = candidate_paths
    if paths is None:
        if exclude & {src, dst}:
            raise RuntimeError(f"endpoint failed: {sorted(exclude & {src, dst})}")
        # Enumerate on the surviving topology: the full network's k-shortest
        # list can have every candidate crossing the dead device even when an
        # alternate route exists one rank further down.
        search = network.without(exclude) if exclude else network
        paths = search.k_shortest_paths(src, dst, n_candidate_paths)
        if not paths and exclude:
            raise RuntimeError(
                f"no surviving path {src} -> {dst} with failed "
                f"device(s) {sorted(exclude)}"
            )
    if not paths:
        raise ValueError(f"no path {src} -> {dst}")
    units = _program_units(program)
    best: DeploymentPlan | None = None
    for path in paths:
        if any(d in exclude for d in path):
            continue
        devmap = {
            d: devices.get(d, default_device)
            for d in path
            if network.kind.get(d) == "switch" and network.programmable.get(d, False)
        }
        free = {
            d: max(0, devmap[d].n_stages - reserved_slots.get(d, 0))
            for d in devmap
        }
        assignment: dict[int, str] = {}
        unit_plans: list[Plan] = []
        ok = True
        for ui, (stage_ids, colocate) in enumerate(units):
            # The final unit (predict/voting) depends on every other unit:
            # it may not land upstream of any already-placed stage.
            min_pos = 0
            if ui == len(units) - 1 and assignment:
                min_pos = max(path.index(d) for d in assignment.values())
            sub = [specs[i] for i in stage_ids]
            prob = PathProblem(
                stages=sub,
                path=path,
                devices=devmap,
                free_slots=dict(free),
                weights=weights,
                latency=latency,
                request_bytes=req_bytes,
                colocate=colocate,
                min_position=min_pos,
            )
            p = solve_path(prob, solver)
            if p is None:
                ok = False
                break
            unit_plans.append(p)
            for local_i, dev in p.assignment.items():
                assignment[stage_ids[local_i]] = dev
                free[dev] -= 1
        if not ok:
            continue
        # combined objective over the union deployment
        comb = PathProblem(
            stages=specs, path=path, devices=devmap,
            free_slots={d: devmap[d].n_stages for d in devmap},
            weights=weights, latency=latency, request_bytes=req_bytes,
        )
        obj, breakdown = _objective_terms(comb, assignment)
        cand = DeploymentPlan(
            path, assignment, obj, breakdown, solver,
            time.perf_counter() - t0, unit_plans,
        )
        if best is None or cand.objective < best.objective:
            best = cand
    if best is None:
        raise RuntimeError(
            "no feasible deployment (model too large for path resources — "
            "paper's answer: add devices or features via RFE)"
        )
    best.solve_time = time.perf_counter() - t0
    return best


def plan_zoo(
    programs: list[TableProgram],
    network: Network,
    src: str,
    dst: str,
    **kw,
) -> list[DeploymentPlan]:
    """Per-version stage assignment for a model zoo (paper App. B extended
    along the VID axis): plan each version's program in order with capacity
    carry-over, so versions planned later are pushed onto devices of the path
    that still have free slots — different versions of a model can live on
    different devices, all serving the same wire path simultaneously.

    The first version picks the path; later versions are pinned to it so the
    merged deployment has one consistent hop order
    (see ``distributed_plane.build_zoo_device_programs``).
    """
    reserved: dict[str, int] = {}
    plans: list[DeploymentPlan] = []
    pinned: list[list[str]] | None = None
    for program in programs:
        plan = plan_program(
            program, network, src, dst,
            reserved_slots=dict(reserved),
            candidate_paths=pinned,
            **kw,
        )
        pinned = [plan.path]
        for dev in plan.assignment.values():
            reserved[dev] = reserved.get(dev, 0) + 1
        plans.append(plan)
    return plans


def replan(
    program: TableProgram,
    network: Network,
    src: str,
    dst: str,
    failed: set[str],
    **kw,
) -> DeploymentPlan:
    """Failure-aware replanning (beyond paper §9): exclude dead devices."""
    return plan_program(program, network, src, dst, exclude=failed, **kw)


def replan_zoo(
    programs: list[TableProgram],
    network: Network,
    src: str,
    dst: str,
    failed: set[str],
    **kw,
) -> list[DeploymentPlan]:
    """Zoo-wide failure-aware replanning — the control loop's replan step.

    Re-runs ``plan_zoo`` on the surviving topology, so the per-version
    capacity carry-over and the single-pinned-path invariant both hold on
    the post-fault deployment exactly as they did on the original one."""
    return plan_zoo(programs, network, src, dst, exclude=set(failed), **kw)
