"""Shared reporting types + ACORN's own resource model for comparisons.

Copied from ``src/repro/core/baselines/common.py``; ``acorn_resources``
goes through the port's own translator copy (``repro_torch.core.translator``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.mlmodels.cart import DecisionTree
from repro_torch.core.mlmodels.forest import RandomForest

__all__ = ["BaselineReport", "MAX_FEATURES", "acorn_resources", "trees_of"]


# Paper Table 3: maximum supported features per model type per system.
MAX_FEATURES: dict[str, dict[str, int | None]] = {
    "switchtree": {"dt": 16, "rf": None, "svm": None},
    "leo": {"dt": 10, "rf": None, "svm": None},
    "dinc": {"dt": 40, "rf": 20, "svm": 8},
    "acorn": {"dt": 46, "rf": 46, "svm": 8},          # hardware run (compiler bug caps SVM)
    "acorn-simulator": {"dt": 46, "rf": 46, "svm": 46},  # paper's simulator path; native here
}


@dataclasses.dataclass
class BaselineReport:
    system: str
    tcam_entries: int
    sram_entries: int
    stages: int
    feasible: bool = True
    notes: str = ""


def trees_of(model) -> list[DecisionTree]:
    if isinstance(model, RandomForest):
        return model.trees_
    if isinstance(model, DecisionTree):
        return [model]
    raise TypeError(type(model).__name__)


def acorn_resources(model, *, feature_width: int = 8) -> BaselineReport:
    """ACORN's own footprint, from the real translator (used in Fig. 9)."""
    from repro_torch.core.translator import translate

    prog = translate(model, feature_width=feature_width)
    return BaselineReport(
        system="acorn",
        tcam_entries=prog.total_tcam_entries(),
        sram_entries=prog.total_sram_entries(),
        stages=prog.n_stages,
    )
