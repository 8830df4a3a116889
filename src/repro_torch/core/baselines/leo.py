"""LEO (Jafri et al., NSDI'24) representation model: sub-tree multiplexing.

LEO splits a decision tree into sub-trees of ``subtree_size`` internal nodes
and multiplexes the sub-trees of one level through shared tables, saving
stages.  The cost: one sub-tree table matches on the values of *all* features
tested inside the sub-tree, so its ternary entries are the **product** of the
per-node range expansions ("each table matches three inputs, and the
combination of inputs increases the entry usage and offsets the benefits",
paper Fig. 9d).  Feature support is capped at 10 (paper Table 3).

Copied from ``src/repro/core/baselines/leo.py``; only the import paths
differ.
"""
from __future__ import annotations

from repro_torch.core.baselines.common import BaselineReport, trees_of
from repro_torch.core.tables import range_to_prefixes

__all__ = ["leo_resources"]


def _branch_expansion(tree, n, width: int, right: bool) -> int:
    """Prefixes to express one branch condition of node n."""
    t = int(tree.threshold[n])
    full = (1 << width) - 1
    if right:
        return len(range_to_prefixes(t + 1, full, width))
    return len(range_to_prefixes(0, t, width))


def _subtree_entries(tree, group: set[int], root: int, width: int) -> int:
    """One LEO sub-tree table: one ternary entry per leaf-path through the
    sub-tree, each a *combination* of the branch conditions along the path —
    entries = sum over paths of the product of per-branch expansions (the
    Fig. 9d combination blow-up)."""

    def rec(n: int) -> int:
        if n < 0 or n not in group or tree.feature[n] < 0:
            return 1  # exit point of the sub-tree: one entry tail
        left = _branch_expansion(tree, n, width, False) * rec(int(tree.left[n]))
        right = _branch_expansion(tree, n, width, True) * rec(int(tree.right[n]))
        return left + right

    return rec(root)


def leo_resources(model, *, feature_width: int = 8, subtree_size: int = 3,
                  max_stages: int = 20) -> BaselineReport:
    trees = trees_of(model)
    if len(trees) > 1:
        return BaselineReport("leo", 0, 0, 0, False,
                              "LEO is single-tree (Table 3: RF N/A)")
    ta = trees[0].tree_
    # Greedy BFS partition into sub-trees of <= subtree_size internal nodes.
    tcam = 0
    n_subtrees = 0
    visited = set()
    frontier = [0]
    while frontier:
        root = frontier.pop(0)
        if root in visited or ta.feature[root] < 0:
            continue
        group = []
        q = [root]
        while q and len(group) < subtree_size:
            n = q.pop(0)
            if n in visited or ta.feature[n] < 0:
                continue
            visited.add(n)
            group.append(n)
            q.extend([int(ta.left[n]), int(ta.right[n])])
        # children not absorbed become new sub-tree roots
        for n in group:
            for ch in (int(ta.left[n]), int(ta.right[n])):
                if ch >= 0 and ch not in visited and ta.feature[ch] >= 0:
                    frontier.append(ch)
        if group:
            n_subtrees += 1
            tcam += _subtree_entries(ta, set(group), root, feature_width)
    # Multiplexed stages: ceil(depth / subtree depth) with subtrees of one
    # level sharing a stage.
    import math

    sub_depth = max(1, int(math.ceil(math.log2(subtree_size + 1))))
    stages = math.ceil(ta.max_depth / sub_depth)
    n_feat = trees[0].n_features_
    feasible = n_feat <= 10 and stages <= max_stages
    notes = "" if n_feat <= 10 else f"{n_feat} features > LEO max 10"
    return BaselineReport(
        system="leo",
        tcam_entries=tcam,
        sram_entries=ta.n_leaves,
        stages=stages,
        feasible=feasible,
        notes=notes,
    )
