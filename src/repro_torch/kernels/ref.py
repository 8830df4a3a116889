"""Plain-torch twins of the classify oracles (the correctness contract).

Port of ``src/repro/kernels/ref.py`` (``tcam_match_v``, ``tree_walk_v``,
``svm_lookup_v``, ``forest_predict_vote_v``, ``classify_fused_v``).  Each
function is the semantic ground truth the CUDA kernel is held to bit for bit,
and the engine's CPU execution path.  They run on any device.

Conventions (see ``core/packets.py``): uint32 tables and codes arrive as
int32 bit patterns; bitwise and equality ops work on the patterns directly,
and the leaf search widens to int64 to get the unsigned order.  Three traps
of torch against jnp, each handled where it bites:

* an int32 ``sum`` promotes to int64 — ``_wrap32`` restores JAX's int32
  wraparound;
* ``argmax`` takes no bool — the first-match search casts to int32 first;
* vote scores sum in tree order t = 0..T-1 in float32, so near-ties break
  the same way as the oracle.

Two places where the port pins behaviour the JAX oracle leaves to its
gather's out-of-bounds mode, following the TPU kernel instead:

* a feature outside ``[0, levels)`` adds 0 to the SVM sums;
* a packet whose ``vid`` is outside ``[0, V)`` keeps its codes and gets
  label 0 and sums 0 (the plane sanitises ``vid`` before classify anyway).
"""
from __future__ import annotations

import torch

__all__ = ["tcam_match_v", "tree_walk_v", "svm_lookup_v",
           "forest_predict_vote_v", "classify_fused_v"]

_U32 = 0xFFFFFFFF


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (JAX's int32 sum)."""
    x = x & _U32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _u32_order(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 holding the uint32 value (for ordering)."""
    return x.to(torch.int64) & _U32


def _shift_bit(bit: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``bit << shift`` as uint32 bits in int32; shifts outside [0, 32)
    give 0, as XLA's uint32 shift does."""
    s = shift.to(torch.int64)
    ok = (s >= 0) & (s < 32)
    return _wrap32(torch.where(ok, bit.to(torch.int64) << s.clamp(0, 31), 0))


def tcam_match_v(codes, features, vid, code_value, code_mask, fid, f_lo, f_hi,
                 set_bit, valid, shift):
    """One ``dt_layer`` ternary lookup, version-indexed: packet b matches
    against the ``[V, T, E]`` entry tables of version ``vid[b]``; the first
    (highest-priority) matching entry sets bit ``shift``; no match leaves the
    code unchanged."""
    B, T = codes.shape
    E = code_value.shape[-1]
    fidv = fid[vid].to(torch.int64)                               # [B, T, E]
    f = torch.gather(features, 1, fidv.reshape(B, T * E)).reshape(B, T, E)
    code_ok = (codes[:, :, None] & code_mask[vid]) == code_value[vid]
    ok = (code_ok & (f >= f_lo[vid]) & (f <= f_hi[vid])
          & valid[vid].to(torch.bool))
    hit = ok.any(dim=-1)
    first = ok.to(torch.int32).argmax(dim=-1, keepdim=True)       # [B, T, 1]
    bit = torch.gather(set_bit[vid], 2, first)[..., 0]
    new = codes | _shift_bit(bit, shift)
    return torch.where(hit, new, codes)


def tree_walk_v(codes, features, vid, code_value, code_mask, fid, f_lo, f_hi,
                set_bit, valid, layer_shift):
    """All L ``dt_layer`` lookups in sequence over ``[V, L, T, E]`` tables;
    layer l writes status-code bit ``layer_shift[l]``."""
    for l in range(code_value.shape[1]):
        codes = tcam_match_v(
            codes, features, vid, code_value[:, l], code_mask[:, l],
            fid[:, l], f_lo[:, l], f_hi[:, l], set_bit[:, l], valid[:, l],
            layer_shift[l])
    return codes


def svm_lookup_v(features, vid, lut, bias):
    """``sums[b, h] = bias[v, h] + Σ_f lut[v, h, f, features[b, f]]`` with
    ``v = vid[b]``, int32 wraparound; a feature outside ``[0, levels)``
    adds 0."""
    V, H, F, levels = lut.shape
    B = features.shape[0]
    x = features[:, :F].to(torch.int64)
    in_range = (x >= 0) & (x < levels)                            # [B, F]
    v = vid.to(torch.int64)[:, None, None]
    h = torch.arange(H, device=lut.device)[None, :, None]
    f = torch.arange(F, device=lut.device)[None, None, :]
    idx = ((v * H + h) * F + f) * levels + x.clamp(0, levels - 1)[:, None, :]
    per_f = lut.reshape(-1)[idx.reshape(-1)].reshape(B, H, F).to(torch.int64)
    per_f = torch.where(in_range[:, None, :], per_f, 0)
    return _wrap32(per_f.sum(dim=2) + bias[vid].to(torch.int64))


def forest_predict_vote_v(codes, vid, pred_codes, pred_labels, pred_valid,
                          weights, n_classes):
    """``dt_predict`` (exact match via binary search over the sorted leaf
    codes of version ``vid[b]``) + ``multitree_voting``.  Returns (label
    int32 [B], per-tree labels int32 [B, T]); ties go to the smaller class."""
    P = pred_codes.shape[2]
    pc = _u32_order(pred_codes[vid])                              # [B, T, P]
    c = _u32_order(codes)[..., None]                              # [B, T, 1]
    pos = torch.searchsorted(pc, c).clamp(0, P - 1)
    found = ((torch.gather(pc, 2, pos) == c)
             & torch.gather(pred_valid[vid].to(torch.bool), 2, pos))
    per_tree = torch.where(found, torch.gather(pred_labels[vid], 2, pos),
                           0)[..., 0].to(torch.int32)             # [B, T]
    w = weights[vid].to(torch.float32)                            # [B, T]
    classes = torch.arange(n_classes, device=codes.device)
    scores = torch.zeros((codes.shape[0], n_classes), dtype=torch.float32,
                         device=codes.device)
    for t in range(codes.shape[1]):                 # tree order, in float32
        scores = scores + (per_tree[:, t, None] == classes) * w[:, t, None]
    return scores.argmax(dim=1).to(torch.int32), per_tree


def classify_fused_v(codes, features, vid, code_value, code_mask, fid, f_lo,
                     f_hi, set_bit, valid, layer_shift, pred_codes,
                     pred_labels, pred_valid, weights, lut, bias, n_classes):
    """Whole-classify twin: tree walk -> forest vote, plus the svm LUT sums.
    Returns (final codes int32 [B, T], vote label int32 [B], svm sums int32
    [B, H])."""
    V = code_value.shape[0]
    vid_ok = (vid >= 0) & (vid < V)
    v = torch.where(vid_ok, vid, 0).to(torch.int64)
    walked = tree_walk_v(codes, features, v, code_value, code_mask, fid,
                         f_lo, f_hi, set_bit, valid, layer_shift)
    label, _per_tree = forest_predict_vote_v(
        walked, v, pred_codes, pred_labels, pred_valid, weights, n_classes)
    sums = svm_lookup_v(features, v, lut, bias)
    return (torch.where(vid_ok[:, None], walked, codes),
            torch.where(vid_ok, label, 0),
            torch.where(vid_ok[:, None], sums, 0))
