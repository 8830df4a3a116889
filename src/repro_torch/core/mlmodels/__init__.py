"""Classical-ML substrate for ACORN (paper §4): the model classes the data
plane can host.

No sklearn in this container — CART decision trees, bagging random forests and
linear SVMs are implemented from scratch on numpy, with the *quantization-first*
twist that makes them data-plane-translatable: features are min-max scaled and
quantized to ``precision_bits`` fixed-point integers **before** training, so
every learned threshold is an integer the switch can ternary-match.

Copied from ``src/repro/core/mlmodels/__init__.py`` of the JAX package; only the import
paths differ (the port imports nothing from ``repro``).
"""
from repro_torch.core.mlmodels.cart import DecisionTree, TreeArrays
from repro_torch.core.mlmodels.forest import RandomForest
from repro_torch.core.mlmodels.linsvm import LinearSVM
from repro_torch.core.mlmodels.metrics import accuracy, cohen_kappa, confusion_matrix, macro_f1
from repro_torch.core.mlmodels.preprocess import Quantizer, rfe_select

__all__ = [
    "DecisionTree",
    "TreeArrays",
    "RandomForest",
    "LinearSVM",
    "Quantizer",
    "rfe_select",
    "accuracy",
    "macro_f1",
    "cohen_kappa",
    "confusion_matrix",
]
