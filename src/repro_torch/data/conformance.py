"""The conformance draws, made with the port's own models.

The draws of ``tests/test_conformance.py`` (``N_CASES``, ``_profile``,
``_fit_random_model``, ``_draw_zoo``, ``_draw_traffic``), drawn with the
port's models, translator and install from the same rng stream, so the same
tables and traffic: a check on a machine with no JAX (``chip_smoke.py``,
``tests/test_torch_gpu.py``) holds the port to the draws the reference's
harness uses.  Two lanes:

* ``draw_case``: the 204 executor-lane draws (``N_CASES``);
* ``draw_fleet_case``: the 8 seeded fault schedules of the topology lane
  (``N_FAULT_CASES``, ``FLEET_V``; ``_fleet_seed`` and
  ``_draw_fault_schedule`` there): a zoo, endpoints in two pods of
  ``fat_tree(4)``, a ``DeviceModel(n_stages in {4, 6, 20})`` with its
  fallback, 1-2 survivable interior kills and three traffic phases.

``tests/test_torch_plane.py`` and ``tests/test_torch_fleet_conformance.py``
hold these draws to the reference's.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from repro_torch.core import mlmodels
from repro_torch.core.packets import PacketBatch, PacketType
from repro_torch.core.plane import PackedProgram, PlaneProfile, SwitchEngine
from repro_torch.core.planner import DeviceModel, plan_zoo, replan_zoo
from repro_torch.core.topology import Network, fat_tree
from repro_torch.core.translator import TableProgram, translate

__all__ = ["N_CASES", "N_FAULT_CASES", "FLEET_V", "SIZES", "N_FEATURES",
           "FleetCase", "profile", "draw_case", "draw_fleet_case"]

N_CASES = {1: 72, 4: 72, 8: 60}          # 204 drawn cases in all
N_FAULT_CASES = 8                        # topology-lane fault schedules
FLEET_V = 4                              # the fault lane's zoo width
SIZES = (1, 2, 3, 5, 7, 12, 17, 24, 33, 48)   # ragged batch menu
N_FEATURES = 10


def profile(V: int) -> PlaneProfile:
    return PlaneProfile(max_features=N_FEATURES, max_trees=3, max_layers=6,
                        max_entries_per_layer=32, max_leaves=32,
                        max_classes=8, max_hyperplanes=8, max_versions=V)


def _model(kind: str, rng, seed: int):
    """A random tiny model on random data."""
    n_classes = int(rng.integers(2, 5))
    X = rng.integers(0, 256, (60, N_FEATURES)).astype(np.int32)
    y = rng.integers(0, n_classes, 60).astype(np.int64)
    y[:n_classes] = np.arange(n_classes)
    if kind == "dt":
        return mlmodels.DecisionTree(
            max_depth=int(rng.integers(2, 5)),
            max_leaf_nodes=int(rng.integers(6, 20))).fit(X, y)
    if kind == "rf":
        return mlmodels.RandomForest(
            n_estimators=int(rng.integers(2, 4)),
            max_depth=int(rng.integers(2, 4)), max_leaf_nodes=10,
            random_state=seed).fit(X, y)
    return mlmodels.LinearSVM(epochs=8, random_state=seed).fit(X, y)


def _draw_zoo(rng, V: int, seed: int, engine: SwitchEngine
              ) -> tuple[list[TableProgram], PackedProgram]:
    """1..min(V, 3) random programs in distinct version slots, and their
    monolithic install by ``engine`` (the oracle's program)."""
    progs = []
    for v in rng.choice(V, size=int(rng.integers(1, min(V, 3) + 1)),
                        replace=False):
        kind = str(rng.choice(["dt", "rf", "svm"]))
        progs.append(translate(_model(kind, rng, seed), vid=int(v)))
    packed = engine.empty()
    for prog in progs:
        packed = engine.install(packed, prog)
    return progs, packed


def _draw_traffic(rng, progs: list[TableProgram], V: int,
                  prof: PlaneProfile) -> PacketBatch:
    """One ragged host batch aimed at the installed (MID, VID) pairs, with
    invalid-VID and passthrough packets."""
    B = int(SIZES[rng.integers(len(SIZES))])
    X = rng.integers(0, 256, (B, N_FEATURES)).astype(np.int32)
    pick = rng.integers(0, len(progs), B)
    mids = np.asarray([progs[c].mid for c in pick], np.int32)
    pvids = np.asarray([progs[c].vid for c in pick], np.int32)
    bad = rng.random(B) < 0.2
    bad_vids = rng.choice(np.asarray([-1, V, V + 3], np.int32), B)
    if len(progs) < V:
        empty = np.setdiff1d(np.arange(V, dtype=np.int32),
                             np.asarray([p.vid for p in progs], np.int32))
        bad_vids = np.where(rng.random(B) < 0.5, rng.choice(empty, B),
                            bad_vids)
    pb = PacketBatch.make_request(
        X, mid=mids, vid=np.where(bad, bad_vids, pvids),
        max_features=prof.max_features, n_trees=prof.max_trees,
        n_hyperplanes=prof.max_hyperplanes)
    # passthrough mix: FORWARD / RESPONSE packets with intermediates
    ptype = np.where(rng.random(B) < 0.2, PacketType.FORWARD,
                     PacketType.REQUEST)
    ptype = np.where(rng.random(B) < 0.1, PacketType.RESPONSE, ptype)
    thru = ptype != PacketType.REQUEST
    T, H = prof.max_trees, prof.max_hyperplanes
    return dataclasses.replace(
        pb, ptype=torch.from_numpy(ptype.astype(np.int32)),
        codes=torch.from_numpy(np.where(
            thru[:, None], rng.integers(0, 2**10, (B, T)), 0).astype(np.int32)),
        svm_acc=torch.from_numpy(np.where(
            thru[:, None], rng.integers(-50, 50, (B, H)), 0).astype(np.int32)),
        rslt=torch.from_numpy(np.where(
            thru, rng.integers(0, 8, B), -1).astype(np.int32)))


def draw_case(V: int, case: int, engine: SwitchEngine
              ) -> tuple[PackedProgram, PacketBatch]:
    """Draw ``case`` of zoo width ``V``: its programs installed by
    ``engine`` (at ``profile(V)``) and its ragged host batch, with
    invalid-VID and passthrough packets."""
    seed = 7919 * V + case
    rng = np.random.default_rng(seed)
    progs, packed = _draw_zoo(rng, V, seed, engine)
    return packed, _draw_traffic(rng, progs, V, engine.profile)


@dataclasses.dataclass
class FleetCase:
    """One fault schedule of the topology lane."""

    seed: int
    programs: list[TableProgram]
    packed: PackedProgram          # the monolithic install (the oracle's)
    network: Network
    src: str
    dst: str
    device_model: DeviceModel
    path: list[str]                # the planned wire path before the kills
    kills: list[str]
    phases: list[PacketBatch]      # before, during, after


def _fleet_seed(case: int) -> int:
    return 104_729 + 13 * case


def _draw_fault_schedule(rng, progs, net, src, dst, dev, path) -> list[str]:
    """1-2 killable on-path switches, pre-validated survivable: the edge
    switches next to the hosts are cut vertices, so the schedule draws from
    the interior and keeps only combos the planner can replan around
    (capacity included, not just connectivity)."""
    interior = [d for d in path[2:-2] if net.kind[d] == "switch"]
    n_kill = int(rng.integers(1, 3))
    combos = list(itertools.combinations(interior, n_kill))
    if n_kill == 2:
        combos += list(itertools.combinations(interior, 1))
    rng.shuffle(combos)
    for combo in combos:
        try:
            replan_zoo(progs, net, src, dst, set(combo),
                       solver="dp", default_device=dev)
        except (RuntimeError, ValueError):
            continue
        return list(combo)
    raise AssertionError(f"no survivable fault schedule on path {path}")


def draw_fleet_case(case: int, engine: SwitchEngine) -> FleetCase:
    """Draw fault schedule ``case`` (at ``profile(FLEET_V)``; ``engine``
    installs the oracle's program).  The fleet's path is what
    ``FleetRuntime`` plans for these arguments: ``plan_zoo`` with the DP
    solver, falling back to ``DeviceModel()`` where the small switches
    cannot hold the zoo."""
    seed = _fleet_seed(case)
    rng = np.random.default_rng(seed)
    progs, packed = _draw_zoo(rng, FLEET_V, seed, engine)
    net = fat_tree(4)
    # endpoints in different pods, so the path crosses the core layer
    pods = rng.choice(4, size=2, replace=False)
    src, dst = f"h{pods[0]}_0_0", f"h{pods[1]}_0_0"
    dev = DeviceModel(n_stages=int(rng.choice([4, 6, 20])))
    try:
        plans = plan_zoo(progs, net, src, dst, solver="dp",
                         default_device=dev)
    except RuntimeError:
        dev = DeviceModel()
        plans = plan_zoo(progs, net, src, dst, solver="dp",
                         default_device=dev)
    path = plans[0].path
    kills = _draw_fault_schedule(rng, progs, net, src, dst, dev, path)
    phases = [_draw_traffic(rng, progs, FLEET_V, engine.profile)
              for _ in range(3)]
    return FleetCase(seed, progs, packed, net, src, dst, dev, path, kills,
                     phases)
