"""Bagging random forest over histogram-CART trees (paper §4.2).

ACORN decomposes a forest into independent per-tree ``dt_layer`` pipelines plus
one ``multitree_voting`` exact-match table.  The trainer here mirrors sklearn's
``RandomForestClassifier`` defaults closely enough for the paper's workloads:
bootstrap sampling + sqrt-feature subsetting per split, majority vote at
inference.  Weighted voting (paper: "majority voting and weighted summation
can all be represented as voting") is supported through ``tree_weights``.

Copied from ``src/repro/core/mlmodels/forest.py`` of the JAX package; only the import
paths differ (the port imports nothing from ``repro``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.mlmodels.cart import DecisionTree

__all__ = ["RandomForest"]


class RandomForest:
    def __init__(
        self,
        n_estimators: int = 5,
        max_depth: int = 8,
        *,
        levels: int = 256,
        min_samples_split: int = 2,
        min_samples_leaf: int = 1,
        max_leaf_nodes: int | None = None,
        max_features: int | float | str | None = "sqrt",
        bootstrap: bool = True,
        tree_weights: np.ndarray | None = None,
        random_state: int = 0,
    ) -> None:
        self.n_estimators = int(n_estimators)
        self.max_depth = int(max_depth)
        self.levels = int(levels)
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.max_leaf_nodes = max_leaf_nodes
        self.max_features = max_features
        self.bootstrap = bootstrap
        self.tree_weights = tree_weights
        self.random_state = int(random_state)
        self.trees_: list[DecisionTree] = []
        self.n_classes_: int | None = None
        self.n_features_: int | None = None

    def fit(self, Xq: np.ndarray, y: np.ndarray) -> "RandomForest":
        Xq = np.asarray(Xq)
        y = np.asarray(y, dtype=np.int64)
        n = Xq.shape[0]
        self.n_features_ = Xq.shape[1]
        self.n_classes_ = int(y.max()) + 1
        rng = np.random.default_rng(self.random_state)
        self.trees_ = []
        for _ in range(self.n_estimators):
            idx = rng.integers(0, n, size=n) if self.bootstrap else np.arange(n)
            tree = DecisionTree(
                max_depth=self.max_depth,
                levels=self.levels,
                min_samples_split=self.min_samples_split,
                min_samples_leaf=self.min_samples_leaf,
                max_leaf_nodes=self.max_leaf_nodes,
                max_features=self.max_features,
                random_state=np.random.default_rng(rng.integers(0, 2**63)),
            )
            tree.fit(Xq[idx], y[idx])
            # Forest trees must share the class space even if a bootstrap
            # sample misses a class.
            tree.n_classes_ = self.n_classes_
            self.trees_.append(tree)
        return self

    # -------------------------------------------------------------- predict
    def tree_votes(self, Xq: np.ndarray) -> np.ndarray:
        """Per-tree labels, shape [n_samples, n_estimators] — the inputs to
        ACORN's ``multitree_voting`` table."""
        return np.stack([t.predict(Xq) for t in self.trees_], axis=1)

    def vote(self, votes: np.ndarray) -> np.ndarray:
        """Combine per-tree labels (the ``multitree_voting`` semantics)."""
        C = self.n_classes_
        w = (
            np.ones(len(self.trees_))
            if self.tree_weights is None
            else np.asarray(self.tree_weights, dtype=np.float64)
        )
        onehot = np.eye(C)[votes]                      # [n, trees, C]
        scores = np.tensordot(onehot, w, axes=([1], [0]))  # [n, C]
        # Ties break toward the smaller class id (argmax convention) — the
        # voting table must enumerate the same convention.
        return np.argmax(scores, axis=1).astype(np.int64)

    def predict(self, Xq: np.ndarray) -> np.ndarray:
        return self.vote(self.tree_votes(Xq))

    def feature_importances_(self) -> np.ndarray:
        imps = np.stack([t.feature_importances_() for t in self.trees_])
        return imps.mean(axis=0)

    @property
    def n_layers(self) -> int:
        return max(t.n_layers for t in self.trees_)
