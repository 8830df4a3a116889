"""DINC (Zheng et al. 2023) = Planter/IIsy encoding + ILP distribution.

Representation (paper §7.3 analysis): per-feature *range→code* TCAM tables
(one code per threshold-bounded segment of the feature axis) feeding one
exact-match **decision table** that enumerates all code combinations that map
to a leaf.  TCAM is small ("DINC produces the fewest TCAM entries", Fig. 9)
but the decision table's entry count is the product of per-feature segment
counts — "factorial-like growth" that is exactly what blocks >40-feature
models (the paper's 3*10^11-entry Digits example).

Decision-table accounting: IIsy/Planter enumerate the *cells of the threshold
grid* (product of segments) rather than one entry per leaf, because one leaf
region is an axis-aligned box that may span many code combinations on
features it never tested.  We count ``min(prod_f segments_f, cap)`` and mark
infeasibility beyond the cap; ``dinc_shrink_to_fit`` reproduces the paper's
observed behaviour — DINC "forces models to underfit" (§7.3) — by capping
tree leaves until the decision table fits.

Copied from ``src/repro/core/baselines/dinc.py``; only the import paths
differ.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.baselines.common import BaselineReport, trees_of
from repro_torch.core.mlmodels.cart import DecisionTree
from repro_torch.core.mlmodels.forest import RandomForest
from repro_torch.core.tables import range_to_prefixes

__all__ = ["dinc_resources", "dinc_shrink_to_fit"]

DEFAULT_ENTRY_CAP = 1 << 22  # ~4M entries: beyond any real switch's SRAM


def _per_feature_segments(trees, n_features: int) -> list[np.ndarray]:
    """Distinct thresholds per feature across the model's trees."""
    thr: list[set[int]] = [set() for _ in range(n_features)]
    for t in trees:
        ta = t.tree_
        for n in range(ta.n_nodes):
            f = int(ta.feature[n])
            if f >= 0:
                thr[f].add(int(ta.threshold[n]))
    return [np.sort(np.asarray(sorted(s), dtype=np.int64)) for s in thr]


def dinc_resources(model, *, feature_width: int = 8,
                   entry_cap: int = DEFAULT_ENTRY_CAP) -> BaselineReport:
    trees = trees_of(model)
    n_features = trees[0].n_features_
    segments = _per_feature_segments(trees, n_features)
    full = (1 << feature_width) - 1

    # Per-feature range->code TCAM tables.
    tcam = 0
    seg_counts = []
    for ths in segments:
        bounds = [-1, *ths.tolist(), full]
        n_seg = len(bounds) - 1
        seg_counts.append(max(n_seg, 1))
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            tcam += len(range_to_prefixes(lo + 1, hi, feature_width))

    # Exact-match decision table: product of segment counts (capped).
    log_entries = float(np.sum(np.log(np.asarray(seg_counts, dtype=np.float64))))
    overflow = log_entries > np.log(entry_cap)
    decision_entries = int(entry_cap) if overflow else int(np.prod(seg_counts))
    # Forests: one decision table per tree + voting — approximated as per-tree
    # products (DINC plans per tree, like ACORN).
    stages = n_features // 8 + len(trees) + 1  # code tables (8/stage) + decisions + vote
    return BaselineReport(
        system="dinc",
        tcam_entries=tcam,
        sram_entries=decision_entries,
        stages=stages,
        feasible=not overflow,
        notes=(f"decision table ~e^{log_entries:.1f} entries > cap {entry_cap}"
               if overflow else ""),
    )


def dinc_shrink_to_fit(
    model_factory,
    Xq: np.ndarray,
    y: np.ndarray,
    *,
    feature_width: int = 8,
    entry_cap: int = DEFAULT_ENTRY_CAP,
    start_leaves: int = 256,
    min_leaves: int = 4,
):
    """Reproduce the paper's DINC underfitting: halve ``max_leaf_nodes`` until
    the Planter decision table fits, then return the (weakened) model.

    ``model_factory(max_leaf_nodes)`` must return an unfit DT/RF.
    """
    leaves = start_leaves
    while leaves >= min_leaves:
        model = model_factory(leaves)
        model.fit(Xq, y)
        rep = dinc_resources(model, feature_width=feature_width, entry_cap=entry_cap)
        if rep.feasible:
            return model, rep, leaves
        leaves //= 2
    model = model_factory(min_leaves)
    model.fit(Xq, y)
    return model, dinc_resources(model, feature_width=feature_width,
                                 entry_cap=entry_cap), min_leaves
