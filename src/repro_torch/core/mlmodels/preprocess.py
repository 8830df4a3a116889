"""Preprocessing used by ACORN's translator (paper §C.2).

The paper min-max scales every dataset into [0, 1) and the data plane operates
on fixed-point integers.  ``Quantizer`` folds both: fit on training data, then
map raw features to ``precision_bits``-wide unsigned integers.  All downstream
components (tree training, SVM product LUTs, TCAM range expansion) operate on
these integers, so the "model the switch runs" and "the model we score" are the
same object — this is what keeps Cohen's kappa ≈ 1 in the paper's Tables 4/5.

Copied from ``src/repro/core/mlmodels/preprocess.py`` of the JAX package; only the import
paths differ (the port imports nothing from ``repro``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


@dataclasses.dataclass
class Quantizer:
    """Min-max scale to [0, 1) then quantize to ``precision_bits`` fixed point."""

    precision_bits: int = 8

    lo_: np.ndarray | None = None
    hi_: np.ndarray | None = None

    @property
    def levels(self) -> int:
        return 1 << self.precision_bits

    def fit(self, X: np.ndarray) -> "Quantizer":
        X = np.asarray(X, dtype=np.float64)
        self.lo_ = X.min(axis=0)
        self.hi_ = X.max(axis=0)
        # Guard constant columns (paper drops them, e.g. num_outbound_cmds).
        span = self.hi_ - self.lo_
        self.hi_ = np.where(span == 0, self.lo_ + 1.0, self.hi_)
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        if self.lo_ is None:
            raise RuntimeError("Quantizer.fit must run before transform")
        X = np.asarray(X, dtype=np.float64)
        unit = (X - self.lo_) / (self.hi_ - self.lo_)
        unit = np.clip(unit, 0.0, np.nextafter(1.0, 0.0))
        q = np.floor(unit * self.levels).astype(np.int64)
        return np.clip(q, 0, self.levels - 1)

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        return self.fit(X).transform(X)

    def inverse_center(self, q: np.ndarray) -> np.ndarray:
        """Bin centers in original feature units (used by the SVM LUT builder)."""
        if self.lo_ is None:
            raise RuntimeError("Quantizer.fit must run before inverse_center")
        unit = (np.asarray(q, dtype=np.float64) + 0.5) / self.levels
        return unit * (self.hi_ - self.lo_) + self.lo_


def rfe_select(
    X: np.ndarray,
    y: np.ndarray,
    n_features: int,
    importance_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    *,
    step_frac: float = 0.5,
) -> np.ndarray:
    """Recursive feature elimination (paper §7.2 uses RFE [31]).

    Repeatedly fits via ``importance_fn`` (returns one non-negative importance
    per column) and drops the weakest ``step_frac`` of remaining columns until
    ``n_features`` survive.  Returns the selected column indices, sorted.
    """
    keep = np.arange(X.shape[1])
    while keep.size > n_features:
        imp = np.asarray(importance_fn(X[:, keep], y), dtype=np.float64)
        if imp.shape != (keep.size,):
            raise ValueError("importance_fn must return one value per column")
        n_drop = min(
            max(1, int(np.ceil(keep.size * step_frac)) - n_features // 2),
            keep.size - n_features,
        )
        order = np.argsort(imp, kind="stable")  # weakest first
        keep = np.delete(keep, order[:n_drop])
    return np.sort(keep)
