"""Benchmark systems the paper compares against (§7.2).

Each module implements the system's *table representation* — the entry-count
and feasibility model that drives paper Table 3 (max features), Fig. 9
(TCAM/SRAM scaling) and the accuracy Tables 4/5 (feature limits + DINC's
feasibility-driven model shrinking).

* ``switchtree``  — per-node direct lookups (Lee & Singh 2020)
* ``leo``         — sub-tree multiplexing, <=10 features (Jafri et al. NSDI'24)
* ``dinc``        — Planter/IIsy encoding: per-feature range->code + exact
                    decision table with factorial entry growth (Zheng et al.)

Copied from ``src/repro/core/baselines/__init__.py`` of the JAX package;
only the import paths differ (the port imports nothing from ``repro``).
"""
from repro_torch.core.baselines.dinc import dinc_resources, dinc_shrink_to_fit
from repro_torch.core.baselines.leo import leo_resources
from repro_torch.core.baselines.switchtree import switchtree_resources
from repro_torch.core.baselines.common import MAX_FEATURES, BaselineReport, acorn_resources

__all__ = [
    "BaselineReport",
    "MAX_FEATURES",
    "acorn_resources",
    "switchtree_resources",
    "leo_resources",
    "dinc_resources",
    "dinc_shrink_to_fit",
]
