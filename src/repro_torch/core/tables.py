"""ACORN's five pre-defined match-action table types (paper §6, Table 1).

| table            | match   | keys                                  | action                |
|------------------|---------|---------------------------------------|-----------------------|
| dt_layer         | ternary | (feature value, prev status code)     | set decision bit      |
| dt_predict       | exact   | final status code                     | per-tree label        |
| multitree_voting | exact   | all per-tree labels                   | final label           |
| svm_mul          | exact   | feature value                         | precomputed product   |
| svm_predict      | exact   | hyperplane sign code                  | final label           |

Semantics notes (these make the layer representation *collision-free*, which
the paper asserts but does not prove):

* The status code accumulates one bit per layer (bit ``d`` = branch taken at
  depth ``d``), initialized to 0 and frozen once a leaf is reached.  Leaf
  paths form a prefix-free set (a leaf has no descendants), therefore
  (a) a frozen code can never match any deeper ``dt_layer`` entry — early
  leaves fall through with **no explicit entries**, exactly the paper's
  "passes through the remaining tables without triggering any actions"; and
  (b) zero-padded leaf codes are pairwise distinct, so ``dt_predict`` can use
  plain *exact* matching (paper Table 1) without ambiguity.

* Each internal node costs 2 logical entries: a high-priority ``x[f] <= t``
  range entry (branch bit 0) and a low-priority feature-wildcard catch-all
  (branch bit 1) — the paper's "entry priority is used to reduce the number
  of table entries" (Fig. 3).  Physical TCAM cost expands the range into
  ``<= width`` prefixes (``range_to_prefixes``); the catch-all costs 1.

Tables are plain numpy structs here; ``plane.py`` packs them into fixed-shape
JAX arrays (entries are *inputs* to the jitted engine — that is the runtime
programmability mechanism).

Copied from ``src/repro/core/tables.py`` of the JAX package; only the import
paths differ (the port imports nothing from ``repro``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "range_to_prefixes",
    "tcam_entries_for_le_range",
    "DtLayerTable",
    "DtPredictTable",
    "VotingTable",
    "SvmMulTable",
    "SvmPredictTable",
]


# --------------------------------------------------------------------------
# TCAM range -> prefix expansion
# --------------------------------------------------------------------------
def range_to_prefixes(lo: int, hi: int, width: int) -> list[tuple[int, int]]:
    """Expand integer range [lo, hi] into ternary (value, mask) prefixes.

    Standard TCAM range expansion: worst case ``2*width - 2`` prefixes for an
    arbitrary range, ``<= width`` for a ``[0, t]`` range.  ``mask`` has 1-bits
    where the entry cares; match is ``(x & mask) == value``.
    """
    if lo > hi:
        return []
    full = (1 << width) - 1
    if lo < 0 or hi > full:
        raise ValueError(f"range [{lo},{hi}] out of [0,{full}]")
    out: list[tuple[int, int]] = []

    def rec(lo: int, hi: int, value: int, mask_bits: int) -> None:
        """Cover [lo,hi] within the aligned block (value, mask_bits top bits set)."""
        blk_lo = value
        blk_hi = value | (full >> mask_bits if mask_bits < width else 0)
        if lo <= blk_lo and blk_hi <= hi:
            mask = (full << (width - mask_bits)) & full if mask_bits else 0
            out.append((value, mask))
            return
        if blk_hi < lo or blk_lo > hi or mask_bits == width:
            return
        half = (blk_hi - blk_lo + 1) // 2
        rec(lo, hi, value, mask_bits + 1)               # left half (next bit 0)
        rec(lo, hi, value | half, mask_bits + 1)        # right half (next bit 1)

    rec(lo, hi, 0, 0)
    return out


def tcam_entries_for_le_range(t: int, width: int) -> int:
    """Physical TCAM entries to express ``x <= t`` on a ``width``-bit field."""
    return len(range_to_prefixes(0, t, width))


# --------------------------------------------------------------------------
# Table structs
# --------------------------------------------------------------------------
@dataclasses.dataclass
class DtLayerTable:
    """One tree layer's ternary table (paper Fig. 3).

    Logical entries (arrays of equal length E):
      match  = ((code & code_mask) == code_value)
               and (f_lo <= features[fid] <= f_hi)
      action = set status-code bit ``layer`` to ``set_bit``
    Highest ``priority`` wins; rows are kept sorted priority-descending so
    "first match" == "highest priority" in the engine and the kernel.
    """

    layer: int
    tree: int
    code_value: np.ndarray  # uint32 [E]
    code_mask: np.ndarray   # uint32 [E]
    fid: np.ndarray         # int32 [E]
    f_lo: np.ndarray        # int32 [E]
    f_hi: np.ndarray        # int32 [E]
    priority: np.ndarray    # int32 [E]
    set_bit: np.ndarray     # uint8 [E]
    feature_width: int = 8  # quantization bits (for TCAM expansion counting)

    def __post_init__(self) -> None:
        order = np.argsort(-self.priority, kind="stable")
        for f in ("code_value", "code_mask", "fid", "f_lo", "f_hi", "priority", "set_bit"):
            setattr(self, f, np.asarray(getattr(self, f))[order])

    @property
    def n_entries(self) -> int:
        return int(self.code_value.shape[0])

    @property
    def n_tcam_entries(self) -> int:
        """Physical TCAM entries after range->prefix expansion."""
        total = 0
        full = (1 << self.feature_width) - 1
        for lo, hi in zip(self.f_lo, self.f_hi):
            if lo == 0 and hi == full:
                total += 1  # wildcard catch-all
            else:
                total += len(range_to_prefixes(int(lo), int(hi), self.feature_width))
        return total

    def lookup(self, codes: np.ndarray, features: np.ndarray) -> np.ndarray:
        """Numpy oracle for one layer (B packets). Returns updated codes."""
        codes = codes.astype(np.uint32)
        code_ok = (codes[:, None] & self.code_mask[None, :]) == self.code_value[None, :]
        f = features[:, self.fid.astype(np.int64)]  # [B, E]
        f_ok = (f >= self.f_lo[None, :]) & (f <= self.f_hi[None, :])
        ok = code_ok & f_ok
        hit = ok.any(axis=1)
        first = np.argmax(ok, axis=1)  # rows sorted by priority desc
        bit = self.set_bit[first].astype(np.uint32)
        new = codes | (bit << np.uint32(self.layer))
        return np.where(hit, new, codes).astype(np.uint32)


@dataclasses.dataclass
class DtPredictTable:
    """Exact match: zero-padded leaf path code -> per-tree label."""

    tree: int
    codes: np.ndarray   # uint32 [E], unique
    labels: np.ndarray  # int32 [E]

    def __post_init__(self) -> None:
        order = np.argsort(self.codes, kind="stable")
        self.codes = np.asarray(self.codes, dtype=np.uint32)[order]
        self.labels = np.asarray(self.labels, dtype=np.int32)[order]
        if np.unique(self.codes).size != self.codes.size:
            raise ValueError("dt_predict codes must be unique (prefix-free property violated)")

    @property
    def n_entries(self) -> int:
        return int(self.codes.shape[0])

    def lookup(self, codes: np.ndarray) -> np.ndarray:
        pos = np.searchsorted(self.codes, codes.astype(np.uint32))
        pos = np.clip(pos, 0, self.codes.size - 1)
        found = self.codes[pos] == codes
        return np.where(found, self.labels[pos], -1).astype(np.int32)


@dataclasses.dataclass
class VotingTable:
    """Exact match on the tuple of per-tree labels -> final label.

    Realized as a *direct-indexed* SRAM table over the perfect hash
    ``sum_t label_t * C**t`` when ``C**T`` fits ``max_materialized`` (this is
    exactly what an exact-match SRAM table does); larger models fall back to
    computed weighted voting with identical semantics (``weights`` are still
    runtime-swappable inputs).
    """

    n_trees: int
    n_classes: int
    weights: np.ndarray                 # float64 [T]
    table: np.ndarray | None = None     # int32 [C**T] or None (computed fallback)
    max_materialized: int = 1 << 20

    @classmethod
    def build(cls, n_trees: int, n_classes: int, weights: np.ndarray | None = None,
              max_materialized: int = 1 << 20) -> "VotingTable":
        w = np.ones(n_trees) if weights is None else np.asarray(weights, np.float64)
        table = None
        if n_classes**n_trees <= max_materialized:
            combos = np.indices((n_classes,) * n_trees).reshape(n_trees, -1).T  # [C^T, T]
            onehot = np.eye(n_classes)[combos]          # [C^T, T, C]
            scores = np.tensordot(onehot, w, axes=([1], [0]))
            table = np.argmax(scores, axis=1).astype(np.int32)
        return cls(n_trees, n_classes, w, table, max_materialized)

    @property
    def n_entries(self) -> int:
        return int(self.n_classes**self.n_trees) if self.table is not None else 0

    def lookup(self, votes: np.ndarray) -> np.ndarray:
        """votes [B, T] -> final labels [B]."""
        if self.table is not None:
            idx = np.zeros(votes.shape[0], dtype=np.int64)
            for t in range(self.n_trees):
                idx += votes[:, t].astype(np.int64) * (self.n_classes**t)
            return self.table[idx]
        onehot = np.eye(self.n_classes)[votes]
        scores = np.tensordot(onehot, self.weights, axes=([1], [0]))
        return np.argmax(scores, axis=1).astype(np.int32)


@dataclasses.dataclass
class SvmMulTable:
    """One (hyperplane, feature) multiplication LUT (paper §4.3).

    ``lut[v] = round(w[h, f] * center(v) * 2**frac_bits)`` — the precomputed
    quantized product for feature value ``v``.  Exact-match SRAM; the engine
    direct-indexes it.
    """

    hyperplane: int
    feature: int
    lut: np.ndarray  # int32 [levels]

    @property
    def n_entries(self) -> int:
        return int(self.lut.shape[0])

    def lookup(self, values: np.ndarray) -> np.ndarray:
        return self.lut[values.astype(np.int64)]


@dataclasses.dataclass
class SvmPredictTable:
    """Exact match: H-bit hyperplane sign code -> label.

    Direct-indexed over the sign-code integer when ``2**H`` fits; fallback is
    computed pairwise voting (identical semantics, pairs are inputs).
    """

    n_hyperplanes: int
    n_classes: int
    pairs: np.ndarray                  # int32 [H, 2]; (i, j) ovo or (i, -1) ovr
    table: np.ndarray | None = None    # int32 [2**H]
    max_materialized: int = 1 << 16

    @classmethod
    def build(cls, pairs: np.ndarray, n_classes: int, vote_fn,
              max_materialized: int = 1 << 16) -> "SvmPredictTable":
        """``vote_fn(signs [N, H]) -> labels [N]`` (LinearSVM.votes_from_signs)."""
        pairs = np.asarray(pairs, dtype=np.int32)
        H = pairs.shape[0]
        table = None
        if 2**H <= max_materialized:
            codes = np.arange(2**H, dtype=np.int64)
            signs = ((codes[:, None] >> np.arange(H)[None, :]) & 1).astype(np.int64)
            table = vote_fn(signs).astype(np.int32)
        return cls(H, n_classes, pairs, table, max_materialized)

    @property
    def n_entries(self) -> int:
        return int(2**self.n_hyperplanes) if self.table is not None else 0

    def lookup(self, signs: np.ndarray) -> np.ndarray:
        code = (signs.astype(np.int64) << np.arange(self.n_hyperplanes)[None, :]).sum(axis=1)
        if self.table is not None:
            return self.table[code]
        # computed fallback: pairwise votes
        n = signs.shape[0]
        scores = np.zeros((n, self.n_classes))
        for h in range(self.n_hyperplanes):
            i, j = self.pairs[h]
            pos = signs[:, h] == 1
            if j >= 0:
                scores[pos, i] += 1
                scores[~pos, j] += 1
            else:
                scores[pos, i] += 1
        return np.argmax(scores, axis=1).astype(np.int32)
