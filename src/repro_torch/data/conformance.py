"""The 204 conformance draws, made with the port's own models.

The draws of ``tests/test_conformance.py`` (``N_CASES``, ``_profile``,
``_fit_random_model``, ``_draw_zoo``, ``_draw_traffic``), drawn with the
port's models, translator and install from the same rng stream, so the same
tables and traffic: a check on a machine with no JAX (``chip_smoke.py``,
``tests/test_torch_gpu.py``) holds the port to the draws the reference's
harness uses.  ``tests/test_torch_fronts_conformance.py`` holds these draws
to the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import mlmodels
from repro_torch.core.packets import PacketBatch, PacketType
from repro_torch.core.plane import PackedProgram, PlaneProfile, SwitchEngine
from repro_torch.core.translator import translate

__all__ = ["N_CASES", "SIZES", "N_FEATURES", "profile", "draw_case"]

N_CASES = {1: 72, 4: 72, 8: 60}          # 204 drawn cases in all
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


def draw_case(V: int, case: int, engine: SwitchEngine
              ) -> tuple[PackedProgram, PacketBatch]:
    """Draw ``case`` of zoo width ``V``: its programs installed by
    ``engine`` (at ``profile(V)``) and its ragged host batch, with
    invalid-VID and passthrough packets."""
    seed = 7919 * V + case
    rng = np.random.default_rng(seed)
    progs = []
    for v in rng.choice(V, size=int(rng.integers(1, min(V, 3) + 1)),
                        replace=False):
        kind = str(rng.choice(["dt", "rf", "svm"]))
        progs.append(translate(_model(kind, rng, seed), vid=int(v)))
    packed = engine.empty()
    for prog in progs:
        packed = engine.install(packed, prog)
    prof = engine.profile
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
    pb = dataclasses.replace(
        pb, ptype=torch.from_numpy(ptype.astype(np.int32)),
        codes=torch.from_numpy(np.where(
            thru[:, None], rng.integers(0, 2**10, (B, T)), 0).astype(np.int32)),
        svm_acc=torch.from_numpy(np.where(
            thru[:, None], rng.integers(-50, 50, (B, H)), 0).astype(np.int32)),
        rslt=torch.from_numpy(np.where(
            thru, rng.integers(0, 8, B), -1).astype(np.int32)))
    return packed, pb
