"""What an ACORN switch answers for each packet, in plain NumPy.

The semantics are the paper's (§4, Appendix A), written out from the models
and not from any table the program builds:

* a packet whose type is not REQUEST passes through: it comes out as it
  came in;
* a REQUEST picks its model by (MID, VID): MID 2 is the SVM pipeline, any
  other MID the tree pipeline of slot VID;
* a tree walks from the root, left where ``x[feature] <= threshold``, and
  answers its leaf's label; a forest takes a vote of its trees' labels,
  weighted by the forest's tree weights (ones by default), ties to the
  smaller class;
* an SVM holds, for each hyperplane ``h`` and feature ``f``, the product of
  ``W[h, f]`` and the centre of each quantisation level in fixed point with
  ``frac_bits`` fraction bits (rounded half to even); a packet sums its
  features' products and the bias in a 32-bit signed adder, keeps the sign
  bit of each hyperplane (set where the sum is >= 0) and takes the vote of
  those bits (one-vs-one: a pair's winner; one-vs-rest: the classes whose
  bit is set), ties to the smaller class;
* a slot with no model in the packet's pipeline answers nothing: the packet
  keeps the result it carried in.
"""
from __future__ import annotations

import numpy as np

__all__ = ["FORWARD", "REQUEST", "MID_SVM", "walk", "svm_luts", "classify",
           "coarsen"]

FORWARD, REQUEST = 0, 1
MID_SVM = 2


def walk(tree, X: np.ndarray):
    """Walk ``tree`` (arrays ``feature``, ``threshold``, ``left``, ``right``;
    ``feature < 0`` at a leaf) for each row of ``X``.  Returns the leaf each
    row ends at, the compares each row made, and which nodes any row
    reached."""
    n = X.shape[0]
    rows = np.arange(n)
    node = np.zeros(n, np.int64)
    compares = np.zeros(n, np.int64)
    reached = np.zeros(tree.feature.shape[0], bool)
    while True:
        reached[node] = True
        f = tree.feature[node]
        active = f >= 0
        if not active.any():
            return node, compares, reached
        x = X[rows, np.where(active, f, 0)]
        left = x <= tree.threshold[node]
        node = np.where(active, np.where(left, tree.left[node],
                                         tree.right[node]), node)
        compares += active


def _trees(model) -> list:
    return list(model.trees_) if hasattr(model, "trees_") else [model]


def _tree_labels(model, X: np.ndarray) -> np.ndarray:
    trees = _trees(model)
    weights = getattr(model, "tree_weights", None)
    w = np.ones(len(trees)) if weights is None else np.asarray(weights, float)
    scores = np.zeros((X.shape[0], model.n_classes_))
    rows = np.arange(X.shape[0])
    for tree, wt in zip(trees, w):
        leaf, _, _ = walk(tree.tree_, X)
        np.add.at(scores, (rows, tree.tree_.label[leaf]), wt)
    return scores.argmax(axis=1)


def svm_luts(svm, frac_bits: int) -> tuple[np.ndarray, np.ndarray]:
    """The fixed-point products ``[H, F, levels]`` and biases ``[H]``."""
    scale = float(1 << frac_bits)
    centers = (np.arange(svm.levels) + 0.5) / svm.levels
    lut = np.round(svm.W_[:, :, None] * centers * scale).astype(np.int64)
    bias = np.round(svm.b_ * scale).astype(np.int64)
    return lut, bias


def _wrap32(x: np.ndarray) -> np.ndarray:
    return (x + 2**31) % 2**32 - 2**31


def _svm_labels(svm, X: np.ndarray, frac_bits: int) -> np.ndarray:
    lut, bias = svm_luts(svm, frac_bits)
    H, F, _ = lut.shape
    sums = np.zeros((X.shape[0], H), np.int64)
    for f in range(F):
        sums = _wrap32(sums + lut[:, f, X[:, f]].T)
    signs = _wrap32(sums + bias) >= 0
    if svm.multi_class == "ovr" and svm.n_classes_ == 2:
        return signs[:, 0].astype(np.int64)
    votes = np.zeros((X.shape[0], svm.n_classes_), np.int64)
    for h, (i, j) in enumerate(svm.pairs_):
        votes[:, i] += signs[:, h]
        if j >= 0:
            votes[:, j] += ~signs[:, h]
    return votes.argmax(axis=1)


def classify(models: dict, ptype: np.ndarray, mid: np.ndarray,
             vid: np.ndarray, features: np.ndarray, rslt_in: np.ndarray,
             *, frac_bits: int) -> np.ndarray:
    """Each packet's ``rslt`` as the switch answers it.  ``models`` maps a
    slot (VID) to its fitted model, or to None for an empty slot."""
    out = np.asarray(rslt_in, np.int64).copy()
    X = np.asarray(features, np.int64)
    request = np.asarray(ptype) == REQUEST
    svm_pipe = np.asarray(mid) == MID_SVM
    for v, model in models.items():
        if model is None:
            continue
        is_svm = hasattr(model, "W_")
        sel = request & (np.asarray(vid) == v) & (svm_pipe == is_svm)
        if not sel.any():
            continue
        out[sel] = (_svm_labels(model, X[sel], frac_bits) if is_svm
                    else _tree_labels(model, X[sel]))
    return out


def coarsen(features: np.ndarray, width: int, bits: int) -> np.ndarray:
    """``features`` of ``width`` bits as a ``bits``-bit quantiser would have
    given them, at the same scale: the low ``width - bits`` bits dropped.
    The precision below the configuration's, for the control."""
    drop = width - bits
    return (np.asarray(features) >> drop) << drop
