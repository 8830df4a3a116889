"""Min-max scaling to ``precision_bits`` fixed-point integers, the
features every model here trains on and every packet carries."""
from __future__ import annotations

import dataclasses

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
