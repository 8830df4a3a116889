"""Classification metrics used throughout the paper's tables (no sklearn).

The paper reports accuracy, macro-F1 and Cohen's kappa; kappa is used to
measure agreement between the in-network prediction and the server-side
(float) model (Tables 4/5).

Copied from ``src/repro/core/mlmodels/metrics.py`` of the JAX package; only the import
paths differ (the port imports nothing from ``repro``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["accuracy", "macro_f1", "cohen_kappa", "confusion_matrix"]


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray, n_classes: int | None = None) -> np.ndarray:
    y_true = np.asarray(y_true, dtype=np.int64)
    y_pred = np.asarray(y_pred, dtype=np.int64)
    if y_true.shape != y_pred.shape:
        raise ValueError("shape mismatch")
    C = n_classes or int(max(y_true.max(initial=0), y_pred.max(initial=0))) + 1
    cm = np.bincount(y_true * C + y_pred, minlength=C * C).reshape(C, C)
    return cm


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    return float(np.mean(y_true == y_pred)) if y_true.size else 0.0


def macro_f1(y_true: np.ndarray, y_pred: np.ndarray, n_classes: int | None = None) -> float:
    cm = confusion_matrix(y_true, y_pred, n_classes)
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    denom = 2 * tp + fp + fn
    f1 = np.where(denom > 0, 2 * tp / np.maximum(denom, 1e-300), 0.0)
    # Match sklearn: classes absent from both y_true and y_pred contribute 0.
    return float(f1.mean()) if f1.size else 0.0


def cohen_kappa(a: np.ndarray, b: np.ndarray, n_classes: int | None = None) -> float:
    """Cohen's kappa between two raters (paper metric K, [20])."""
    cm = confusion_matrix(a, b, n_classes).astype(np.float64)
    n = cm.sum()
    if n == 0:
        return 0.0
    po = np.trace(cm) / n
    pe = float((cm.sum(axis=1) / n) @ (cm.sum(axis=0) / n))
    if pe == 1.0:
        return 1.0
    return float((po - pe) / (1.0 - pe))
