"""Analysis tools of the port: the roofline model with the H100's peaks.

Port of ``src/repro/analysis/__init__.py``'s roofline re-exports.  Not
ported: ``analysis/hlocost.py`` and ``collective_bytes_from_hlo`` (they
parse XLA's HLO text) and ``analysis/lint/`` (it checks the JAX package's
sources).
"""
from repro_torch.analysis.roofline import HW, model_flops, roofline_terms

__all__ = ["HW", "roofline_terms", "model_flops"]
