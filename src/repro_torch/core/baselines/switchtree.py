"""SwitchTree (Lee & Singh 2020) representation model.

SwitchTree embeds each tree level as if/else match logic over per-node
comparisons realized with SRAM direct lookups: every node's threshold test is
a range lookup on the feature value, so its SRAM usage "is related to the
precision of the inputs and the total number of nodes" (paper §7.6).

Model used here (documented assumption): each internal node costs
``feature_width`` SRAM entries (a bit-serial range-decomposition lookup) plus
one result entry per leaf; one pipeline stage per tree level.  Max 16
features (paper Table 3), decision trees / per-tree forests only.

Copied from ``src/repro/core/baselines/switchtree.py``; only the import
paths differ.
"""
from __future__ import annotations

from repro_torch.core.baselines.common import BaselineReport, trees_of

__all__ = ["switchtree_resources"]


def switchtree_resources(model, *, feature_width: int = 8,
                         max_stages: int = 20) -> BaselineReport:
    trees = trees_of(model)
    sram = 0
    stages = 0
    for t in trees:
        ta = t.tree_
        n_internal = int((ta.feature >= 0).sum())
        sram += n_internal * feature_width + ta.n_leaves
        stages += ta.max_depth
    n_feat = trees[0].n_features_
    feasible = n_feat <= 16 and stages <= max_stages and len(trees) == 1
    notes = []
    if n_feat > 16:
        notes.append(f"{n_feat} features > SwitchTree max 16")
    if len(trees) > 1:
        notes.append("general multi-tree voting unsupported (Table 3: RF N/A)")
    if stages > max_stages:
        notes.append(f"needs {stages} stages > {max_stages}")
    return BaselineReport(
        system="switchtree",
        tcam_entries=0,                # SwitchTree is SRAM-lookup based
        sram_entries=sram,
        stages=stages,
        feasible=feasible,
        notes="; ".join(notes),
    )
