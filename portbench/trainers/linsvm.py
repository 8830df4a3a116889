"""Linear SVM (one-vs-one / one-vs-rest) trained on quantized features.

ACORN's SVM data plane (paper §4.3) holds *precomputed products* ``w_hi * x_i``
in ``svm_mul`` exact-match tables, sums them with the native signed adder and
keeps only the sign bit of each hyperplane.  To make the trained model and the
data-plane model the same object, we train on the quantizer's *bin centers*
(floats in [0,1)).  The switch keeps each hyperplane's sign bit and takes a
majority vote over them (paper §C.2); ``portbench.reference`` computes that.

Training is full-batch L2-regularized hinge subgradient descent with a
decaying step — deterministic, no sklearn.
"""
from __future__ import annotations

import itertools

import numpy as np

__all__ = ["LinearSVM"]


def _fit_binary(X, y_pm, C, epochs, lr):
    """Full-batch hinge subgradient descent with tail Polyak averaging."""
    n, F = X.shape
    w = np.zeros(F)
    b = 0.0
    Cn = C / n
    w_avg = np.zeros(F)
    b_avg = 0.0
    n_avg = 0
    tail = epochs // 2
    for e in range(epochs):
        margins = y_pm * (X @ w + b)
        viol = margins < 1.0
        # subgradient of 0.5||w||^2 + Cn * sum hinge
        gw = w - Cn * (y_pm[viol, None] * X[viol]).sum(axis=0)
        gb = -Cn * y_pm[viol].sum()
        step = lr / (1.0 + 0.02 * e)
        w -= step * gw
        b -= step * gb
        if e >= tail:
            w_avg += w
            b_avg += b
            n_avg += 1
    return w_avg / max(n_avg, 1), b_avg / max(n_avg, 1)


class LinearSVM:
    """Multi-class linear SVM with voting-compatible decision structure."""

    def __init__(
        self,
        C: float = 100.0,
        *,
        multi_class: str = "ovo",
        levels: int = 256,
        epochs: int = 800,
        lr: float = 0.1,
        random_state: int = 0,
    ) -> None:
        if multi_class not in ("ovo", "ovr"):
            raise ValueError("multi_class must be 'ovo' or 'ovr'")
        self.C = float(C)
        self.multi_class = multi_class
        self.levels = int(levels)
        self.epochs = int(epochs)
        self.lr = float(lr)
        self.random_state = random_state
        self.W_: np.ndarray | None = None      # [H, F]
        self.b_: np.ndarray | None = None      # [H]
        self.pairs_: list[tuple[int, int]] = []  # ovo: hyperplane h separates (i, j)
        self.n_classes_: int | None = None
        self.n_features_: int | None = None

    # ----------------------------------------------------------------- util
    def _unit(self, Xq: np.ndarray) -> np.ndarray:
        """Quantized ints → bin centers in [0, 1) (matches Quantizer)."""
        return (np.asarray(Xq, dtype=np.float64) + 0.5) / self.levels

    # ------------------------------------------------------------------ fit
    def fit(self, Xq: np.ndarray, y: np.ndarray) -> "LinearSVM":
        X = self._unit(Xq)
        y = np.asarray(y, dtype=np.int64)
        C_ = int(y.max()) + 1
        self.n_classes_ = C_
        self.n_features_ = X.shape[1]
        Ws, bs, pairs = [], [], []
        if self.multi_class == "ovo":
            for i, j in itertools.combinations(range(C_), 2):
                m = (y == i) | (y == j)
                y_pm = np.where(y[m] == i, 1.0, -1.0)
                w, b = _fit_binary(X[m], y_pm, self.C, self.epochs, self.lr)
                Ws.append(w)
                bs.append(b)
                pairs.append((i, j))
        else:  # ovr
            if C_ == 2:
                y_pm = np.where(y == 1, 1.0, -1.0)
                w, b = _fit_binary(X, y_pm, self.C, self.epochs, self.lr)
                Ws, bs, pairs = [w], [b], [(1, 0)]
            else:
                for i in range(C_):
                    y_pm = np.where(y == i, 1.0, -1.0)
                    w, b = _fit_binary(X, y_pm, self.C, self.epochs, self.lr)
                    Ws.append(w)
                    bs.append(b)
                    pairs.append((i, -1))
        self.W_ = np.stack(Ws)
        self.b_ = np.asarray(bs)
        self.pairs_ = pairs
        return self

