"""Three-term roofline model: the least time a step could take on the card.

    compute    = flops       / (peak bf16 tensor-core FLOP/s)
    memory     = bytes       / (HBM B/s)
    collective = wire_bytes  / (chips * link B/s)

Port of ``src/repro/analysis/roofline.py``: ``HW``, ``roofline_terms`` and
``model_flops`` keep the JAX package's signatures and arithmetic, and
``HW``'s defaults are one NVIDIA H100 SXM5's (the card every chip run of
the port used: ``NVIDIA H100 80GB HBM3, 700.00 W`` by ``nvidia-smi
--query-gpu=name,power.limit``).  The field names stay the reference's so
that one ``HW`` serves both packages' arithmetic: ``ici_gbps`` holds the
NVLink rate, the link between cards in place of the TPU's ICI link, and
``dcn_gbps`` the host's network port.

``collective_bytes`` is the counterpart of ``collective_bytes_from_hlo``
(:69): it takes the collectives a cost counter saw
(``analysis.cost.CostCounter.collectives``: kind, result bytes, group
size) where the reference parses them from XLA's HLO text, and applies the
reference's ring factors over the group (:80-92):

    all-reduce      2 (n-1)/n        all-gather     (n-1)/n
    reduce-scatter  (n-1)/n          all-to-all     (n-1)/n
    collective-permute  1
"""
from __future__ import annotations

import dataclasses

__all__ = ["HW", "collective_bytes", "roofline_terms", "model_flops"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One card's peaks.  Defaults: NVIDIA H100 SXM5 data sheet."""

    # bf16 tensor cores, dense: the data sheet's 1,979 TFLOPS is with 2:4
    # sparsity, half of it without
    peak_flops: float = 989.5e12
    # HBM3, 80 GB at 3.35 TB/s
    hbm_gbps: float = 3.35e12
    # NVLink 4: 900 GB/s a card, both directions together; one way
    ici_gbps: float = 450e9
    # the host's network: one ConnectX-7 port a card, 400 Gb/s (DGX H100
    # data sheet)
    dcn_gbps: float = 50e9
    # HBM3 capacity
    hbm_bytes: float = 80e9


def collective_bytes(records) -> dict:
    """Wire bytes per collective kind of (kind, result bytes, group size)
    records, the dict ``collective_bytes_from_hlo`` returns: the five kinds,
    ``n_ops`` and ``total``.  A record of 0 bytes is skipped, as there, and
    so is one over a group of one card (the reference reads its groups from
    the HLO and takes 2 where it finds none; here every group is known)."""
    out = {"all-reduce": 0.0, "all-gather": 0.0, "reduce-scatter": 0.0,
           "all-to-all": 0.0, "collective-permute": 0.0, "n_ops": 0}
    for kind, size, n in records:
        if size == 0 or n == 1:      # a group of one moves nothing
            continue
        if kind == "all-reduce":
            wire = 2.0 * size * (n - 1) / n
        elif kind in ("all-gather", "reduce-scatter", "all-to-all"):
            wire = size * (n - 1) / n
        elif kind == "collective-permute":
            wire = float(size)
        else:
            raise ValueError(f"unknown collective kind {kind!r}")
        out[kind] += wire
        out["n_ops"] += 1
    out["total"] = sum(v for k, v in out.items() if k not in ("n_ops", "total"))
    return out


def model_flops(cfg, seq_len: int, global_batch: int, kind: str) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); decode counts one token/seq."""
    n = cfg.active_param_count()
    if kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * n * tokens
    # decode: one new token per sequence
    return 2.0 * n * global_batch


def roofline_terms(
    *,
    hlo_flops: float,            # flops a card does
    hlo_bytes: float,            # bytes a card moves to and from HBM
    collective_wire_bytes: float,  # aggregate across cards
    chips: int,
    hw: HW = HW(),
) -> dict:
    compute_s = hlo_flops / hw.peak_flops
    memory_s = hlo_bytes / hw.hbm_gbps
    coll_s = collective_wire_bytes / chips / hw.ici_gbps
    dominant = max(
        (("compute", compute_s), ("memory", memory_s), ("collective", coll_s)),
        key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "step_s_lower_bound": max(compute_s, memory_s, coll_s),
    }
