"""The least work a classify of one batch needs, and the card's peaks.

The count follows from the models and the packets alone, so it stays the
same whatever kernels and table layouts implement the classify.  Each input
byte is counted once and each output byte once, at the widths of the
paper's header and tables:

* every packet's type (1 byte); a REQUEST's MID and VID (1 byte each) and
  its features (1 byte each at the 8-bit width), and its result (4 bytes,
  the header's RSLT);
* each tree entry any walk of the batch reaches, once, at 12 bytes: the
  status code's value and mask (4 + 4), the feature id, the range's two
  ends and the branch bit (1 each);
* each leaf found, once, at 8 bytes: its code and its label (4 + 4);
* each SVM (feature, level) cell the packets select, once, at 4 bytes a
  hyperplane (the fixed-point product).

Operations are the compares and adds: a compare for each tree node a walk
passes; for a forest a vote's add a tree and the ``C - 1`` compares of its
argmax; for an SVM ``F`` adds (the products and the bias) and a sign
compare a hyperplane, then a vote's add a hyperplane and the ``C - 1``
compares of its argmax.  No implementation can do less, so a time derived
from this count is a floor.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference import MID_SVM, REQUEST, walk

__all__ = ["PEAK_OPS_S", "PEAK_BYTES_S", "Work", "count"]

# One NVIDIA H100 SXM, NVIDIA's data sheet: the dense bf16 tensor rate (no
# compare or add on the card runs faster) and the HBM3 bandwidth.
PEAK_OPS_S = 989.5e12
PEAK_BYTES_S = 3.35e12

ENTRY_BYTES = 12
LEAF_BYTES = 8
PRODUCT_BYTES = 4
RESULT_BYTES = 4


@dataclasses.dataclass(frozen=True)
class Work:
    ops: int
    nbytes: int

    def __add__(self, other: "Work") -> "Work":
        return Work(self.ops + other.ops, self.nbytes + other.nbytes)

    @property
    def least_s(self) -> float:
        """The larger of the compute and the memory floor, in seconds."""
        return max(self.ops / PEAK_OPS_S, self.nbytes / PEAK_BYTES_S)

    @property
    def bound(self) -> str:
        """Which floor sets ``least_s``."""
        return ("memory" if self.nbytes / PEAK_BYTES_S >= self.ops / PEAK_OPS_S
                else "compute")


def count(models: dict, ptype, mid, vid, features) -> Work:
    """The least work of classifying one batch (see the module docstring).
    ``models`` maps a slot to its fitted model, or None."""
    ptype, mid, vid = (np.asarray(a) for a in (ptype, mid, vid))
    X = np.asarray(features, np.int64)
    request = ptype == REQUEST
    n_req = int(request.sum())
    nbytes = ptype.size + n_req * (2 + X.shape[1] + RESULT_BYTES)
    ops = 0
    for v, model in models.items():
        if model is None:
            continue
        is_svm = hasattr(model, "W_")
        sel = request & (vid == v) & ((mid == MID_SVM) == is_svm)
        n = int(sel.sum())
        if not n:
            continue
        Xs = X[sel]
        C = model.n_classes_
        if is_svm:
            H, F = model.W_.shape
            cells = np.unique(Xs[:, :F] + model.levels * np.arange(F))
            nbytes += cells.size * H * PRODUCT_BYTES
            ops += n * (H * (F + 1) + H + C - 1)
            continue
        trees = list(model.trees_) if hasattr(model, "trees_") else [model]
        for tree in trees:
            leaf, compares, reached = walk(tree.tree_, Xs)
            internal = tree.tree_.feature >= 0
            nbytes += (int((reached & internal).sum()) * ENTRY_BYTES
                       + np.unique(leaf).size * LEAF_BYTES)
            ops += int(compares.sum())
        if len(trees) > 1:
            ops += n * (len(trees) + C - 1)
    return Work(ops, nbytes)
