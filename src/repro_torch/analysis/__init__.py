"""Analysis tools of the port: the roofline model with the H100's peaks and
the cost counter that feeds it.

Port of ``src/repro/analysis/__init__.py``'s roofline re-exports and of
``analysis/hlocost.py``: ``analysis.cost.CostCounter`` counts a step's
flops, traffic, collectives and live bytes op by op, where the reference
parses XLA's HLO (``parse_hlo_cost``), and ``collective_bytes`` turns the
collectives into wire bytes, where the reference has
``collective_bytes_from_hlo``.  Not ported: ``analysis/lint/`` (it checks
the JAX package's sources).
"""
from repro_torch.analysis.roofline import (
    HW,
    collective_bytes,
    model_flops,
    roofline_terms,
)

__all__ = ["HW", "collective_bytes", "roofline_terms", "model_flops"]
