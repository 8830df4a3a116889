"""CART decision tree on quantized integer features (no sklearn).

ACORN's data plane tests ``x[f] <= t`` with integer thresholds, so the tree is
trained *directly on quantized features* (see ``preprocess.Quantizer``): every
learned threshold is an exact integer the switch can ternary-match, which is
what keeps the in-network model and the trained model identical (Cohen's
kappa = 1 against itself by construction).

The trainer is histogram-CART: features live in ``[0, levels)`` so per-node
split search is a ``bincount`` over (level, class) followed by a vectorized
Gini sweep over all thresholds — O(levels * classes) per (node, feature),
orders faster than sort-based CART and exact for integer features.

Trees grow *best-first* (largest impurity decrease first, like sklearn with
``max_leaf_nodes``), bounded by ``max_depth`` / ``max_leaf_nodes`` /
``min_samples_*``.  Every node carries its ``path`` code — bit ``d`` of the
code is the left(0)/right(1) decision taken at depth ``d`` — which is exactly
the status code ACORN's ``dt_layer`` tables accumulate in the packet header
(paper §4.1, Figure 3).

Copied from ``src/repro/core/mlmodels/cart.py`` of the JAX package; only the import
paths differ (the port imports nothing from ``repro``).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Iterator

import numpy as np

__all__ = ["DecisionTree", "TreeArrays"]


@dataclasses.dataclass
class TreeArrays:
    """Struct-of-arrays tree; index 0 is the root.

    ``feature[i] == -1`` marks a leaf.  Internal nodes test
    ``x[feature[i]] <= threshold[i]`` → go left, else right.
    ``path[i]`` packs the root→node decisions: bit ``d`` is the branch taken
    at depth ``d`` (0 = left).  ``label[i]`` is the majority class of the
    training samples that reached the node (defined for internal nodes too —
    used for early-exit/truncated inference).
    """

    feature: np.ndarray    # int32 [n]
    threshold: np.ndarray  # int32 [n]
    left: np.ndarray       # int32 [n], -1 at leaves
    right: np.ndarray      # int32 [n]
    label: np.ndarray      # int32 [n]
    depth: np.ndarray      # int32 [n]
    path: np.ndarray       # uint64 [n]
    n_node_samples: np.ndarray  # int64 [n]
    value: np.ndarray      # float64 [n, n_classes] class distribution

    @property
    def n_nodes(self) -> int:
        return int(self.feature.shape[0])

    @property
    def n_leaves(self) -> int:
        return int(np.sum(self.feature < 0))

    @property
    def max_depth(self) -> int:
        return int(self.depth.max(initial=0))

    def leaves(self) -> np.ndarray:
        return np.flatnonzero(self.feature < 0)

    def internal_by_depth(self) -> Iterator[tuple[int, np.ndarray]]:
        """Yield (depth, node_indices) for internal nodes, shallow→deep."""
        internal = np.flatnonzero(self.feature >= 0)
        if internal.size == 0:
            return
        for d in range(int(self.depth[internal].max()) + 1):
            sel = internal[self.depth[internal] == d]
            if sel.size:
                yield d, sel


class _Node:
    __slots__ = ("idx", "sample_idx", "depth", "path", "hist")

    def __init__(self, idx, sample_idx, depth, path, hist):
        self.idx = idx
        self.sample_idx = sample_idx
        self.depth = depth
        self.path = path
        self.hist = hist  # class histogram, int64 [n_classes]


def _gini(counts: np.ndarray) -> float:
    n = counts.sum()
    if n == 0:
        return 0.0
    p = counts / n
    return float(1.0 - np.sum(p * p))


class DecisionTree:
    """Histogram-CART over integer features in ``[0, levels)``."""

    def __init__(
        self,
        max_depth: int = 8,
        *,
        levels: int = 256,
        min_samples_split: int = 2,
        min_samples_leaf: int = 1,
        max_leaf_nodes: int | None = None,
        max_features: int | float | str | None = None,
        min_impurity_decrease: float = 0.0,
        random_state: int | np.random.Generator | None = 0,
    ) -> None:
        if max_depth < 1 or max_depth > 64:
            raise ValueError("max_depth must be in [1, 64] (path codes are 64-bit)")
        self.max_depth = int(max_depth)
        self.levels = int(levels)
        self.min_samples_split = int(min_samples_split)
        self.min_samples_leaf = int(min_samples_leaf)
        self.max_leaf_nodes = max_leaf_nodes
        self.max_features = max_features
        self.min_impurity_decrease = float(min_impurity_decrease)
        self._rng = (
            random_state
            if isinstance(random_state, np.random.Generator)
            else np.random.default_rng(random_state)
        )
        self.tree_: TreeArrays | None = None
        self.n_classes_: int | None = None
        self.n_features_: int | None = None

    # ------------------------------------------------------------------ fit
    def fit(self, Xq: np.ndarray, y: np.ndarray) -> "DecisionTree":
        Xq = np.asarray(Xq)
        y = np.asarray(y, dtype=np.int64)
        if Xq.ndim != 2:
            raise ValueError("Xq must be 2-D")
        if Xq.min(initial=0) < 0 or Xq.max(initial=0) >= self.levels:
            raise ValueError(f"features must be quantized ints in [0, {self.levels})")
        Xq = Xq.astype(np.int64, copy=False)
        n, F = Xq.shape
        self.n_features_ = F
        C = int(y.max()) + 1 if y.size else 1
        self.n_classes_ = C

        feature = [0]
        threshold = [0]
        left = [-1]
        right = [-1]
        label = [0]
        depth_a = [0]
        path_a = [np.uint64(0)]
        nsamp = [n]
        value = [np.zeros(C)]

        def node_hist(sample_idx):
            return np.bincount(y[sample_idx], minlength=C)

        root = _Node(0, np.arange(n), 0, np.uint64(0), node_hist(np.arange(n)))
        feature[0] = -1
        label[0] = int(np.argmax(root.hist))
        value[0] = root.hist.astype(np.float64)

        # Best-first frontier: (-gain, tiebreak, node, split)
        heap: list = []
        tiebreak = 0

        def push(node: _Node) -> None:
            nonlocal tiebreak
            split = self._best_split(Xq, y, node)
            if split is not None:
                gain, f, t = split
                heapq.heappush(heap, (-gain, tiebreak, node, f, t))
                tiebreak += 1

        push(root)
        n_leaves = 1
        max_leaves = self.max_leaf_nodes if self.max_leaf_nodes is not None else 1 << 62

        while heap and n_leaves < max_leaves:
            neg_gain, _, node, f, t = heapq.heappop(heap)
            if -neg_gain < self.min_impurity_decrease:
                break
            mask = Xq[node.sample_idx, f] <= t
            li, ri = node.sample_idx[mask], node.sample_idx[~mask]
            # Turn `node` into an internal node, create two leaf children.
            feature[node.idx] = f
            threshold[node.idx] = t
            kids = []
            for branch, sidx in ((0, li), (1, ri)):
                cidx = len(feature)
                h = node_hist(sidx)
                cpath = np.uint64(node.path) | (np.uint64(branch) << np.uint64(node.depth))
                feature.append(-1)
                threshold.append(0)
                left.append(-1)
                right.append(-1)
                label.append(int(np.argmax(h)))
                depth_a.append(node.depth + 1)
                path_a.append(cpath)
                nsamp.append(len(sidx))
                value.append(h.astype(np.float64))
                kids.append(_Node(cidx, sidx, node.depth + 1, cpath, h))
            left[node.idx], right[node.idx] = kids[0].idx, kids[1].idx
            n_leaves += 1
            for kid in kids:
                push(kid)

        self.tree_ = TreeArrays(
            feature=np.asarray(feature, np.int32),
            threshold=np.asarray(threshold, np.int32),
            left=np.asarray(left, np.int32),
            right=np.asarray(right, np.int32),
            label=np.asarray(label, np.int32),
            depth=np.asarray(depth_a, np.int32),
            path=np.asarray(path_a, np.uint64),
            n_node_samples=np.asarray(nsamp, np.int64),
            value=np.asarray(value, np.float64),
        )
        return self

    def _feature_subset(self, F: int) -> np.ndarray:
        mf = self.max_features
        if mf is None:
            return np.arange(F)
        if mf == "sqrt":
            k = max(1, int(np.sqrt(F)))
        elif mf == "log2":
            k = max(1, int(np.log2(F)))
        elif isinstance(mf, float):
            k = max(1, int(mf * F))
        else:
            k = min(int(mf), F)
        return self._rng.choice(F, size=k, replace=False)

    def _best_split(self, Xq, y, node: _Node):
        """Return (gain, feature, threshold) or None."""
        sidx = node.sample_idx
        n = sidx.size
        if (
            n < self.min_samples_split
            or node.depth >= self.max_depth
            or _gini(node.hist) == 0.0
        ):
            return None
        C = self.n_classes_
        L = self.levels
        parent_gini = _gini(node.hist)
        ysub = y[sidx]
        best = None  # (gain, f, t)
        for f in self._feature_subset(Xq.shape[1]):
            col = Xq[sidx, f]
            hist = np.bincount(col * C + ysub, minlength=L * C).reshape(L, C)
            cum = np.cumsum(hist, axis=0)          # [L, C]; cum[t] = counts with x<=t
            nl = cum.sum(axis=1)                   # [L]
            nr = n - nl
            valid = (nl >= self.min_samples_leaf) & (nr >= self.min_samples_leaf)
            valid[-1] = False                      # t == L-1 sends all left
            if not valid.any():
                continue
            with np.errstate(divide="ignore", invalid="ignore"):
                pl = cum / np.maximum(nl, 1)[:, None]
                pr = (node.hist[None, :] - cum) / np.maximum(nr, 1)[:, None]
                gl = 1.0 - np.sum(pl * pl, axis=1)
                gr = 1.0 - np.sum(pr * pr, axis=1)
            w = (nl * gl + nr * gr) / n
            w = np.where(valid, w, np.inf)
            t = int(np.argmin(w))
            gain = parent_gini - w[t]
            if gain > 0 and (best is None or gain > best[0]):
                best = (float(gain), int(f), t)
        return best

    # -------------------------------------------------------------- predict
    def decision_path_codes(self, Xq: np.ndarray, *, max_layers: int | None = None):
        """Vectorized tree walk.

        Returns ``(leaf_idx, codes)`` where ``codes`` is the accumulated
        status code per sample (bit d = branch at depth d) — the oracle for
        ACORN's data-plane status codes.
        """
        t = self._require_tree()
        Xq = np.asarray(Xq, dtype=np.int64)
        n = Xq.shape[0]
        cur = np.zeros(n, dtype=np.int64)
        codes = np.zeros(n, dtype=np.uint64)
        layers = t.max_depth if max_layers is None else min(max_layers, t.max_depth)
        for d in range(layers):
            f = t.feature[cur]
            active = f >= 0
            if not active.any():
                break
            fx = Xq[np.arange(n), np.where(active, f, 0)]
            go_right = active & (fx > t.threshold[cur])
            go_left = active & ~go_right
            codes |= (go_right.astype(np.uint64) << np.uint64(d))
            nxt = np.where(go_left, t.left[cur], np.where(go_right, t.right[cur], cur))
            cur = nxt
        return cur, codes

    def predict(self, Xq: np.ndarray) -> np.ndarray:
        t = self._require_tree()
        leaf, _ = self.decision_path_codes(Xq)
        return t.label[leaf].astype(np.int64)

    def predict_proba(self, Xq: np.ndarray) -> np.ndarray:
        t = self._require_tree()
        leaf, _ = self.decision_path_codes(Xq)
        v = t.value[leaf]
        return v / np.maximum(v.sum(axis=1, keepdims=True), 1)

    def _require_tree(self) -> TreeArrays:
        if self.tree_ is None:
            raise RuntimeError("fit() before predict()")
        return self.tree_

    # ------------------------------------------------------------- metadata
    @property
    def n_layers(self) -> int:
        """Pipeline stages a switch needs for this tree (one per layer)."""
        return self._require_tree().max_depth

    def feature_importances_(self) -> np.ndarray:
        """Impurity-decrease importances (for RFE, paper §7.2)."""
        t = self._require_tree()
        imp = np.zeros(self.n_features_, dtype=np.float64)
        total = t.n_node_samples[0]
        for i in range(t.n_nodes):
            f = t.feature[i]
            if f < 0:
                continue
            l, r = t.left[i], t.right[i]
            gi = _gini(t.value[i])
            gl = _gini(t.value[l])
            gr = _gini(t.value[r])
            nl, nr, nn = t.n_node_samples[l], t.n_node_samples[r], t.n_node_samples[i]
            imp[f] += (nn * gi - nl * gl - nr * gr) / total
        s = imp.sum()
        return imp / s if s > 0 else imp
