"""Plain-torch twins of the kernel oracles (the correctness contract).

Port of ``src/repro/kernels/ref.py`` (``tcam_match_v``, ``tree_walk_v``,
``svm_lookup_v``, ``forest_predict_vote_v``, ``classify_fused_v``, the
single-version ``tcam_match``, ``svm_lookup``, ``forest_predict_vote``, and
``decode_attn``), and ``classify_epilogue``: the plane's SVM predict and
result select after ``classify_fused_v`` (the glue of the JAX package's
``_classify_impl``, ``src/repro/core/plane.py``), with ``zoo_slot``, its
vid clamp.
Each function is the semantic ground truth the CUDA kernels are held to bit
for bit, and the engine's CPU execution path.  They run on any device.

Conventions (see ``core/packets.py``): uint32 tables and codes arrive as
int32 bit patterns; bitwise and equality ops work on the patterns directly,
and the leaf search widens to int64 to get the unsigned order.  Three traps
of torch against jnp, each handled where it bites:

* an int32 ``sum`` promotes to int64 — ``_wrap32`` restores JAX's int32
  wraparound;
* ``argmax`` takes no bool — the first-match search casts to int32 first;
* vote scores sum in tree order t = 0..T-1 in float32, so near-ties break
  the same way as the oracle.

Three places where the port pins behaviour the JAX oracle leaves to its
gather's out-of-bounds mode or to a softmax of nothing, following the TPU
kernel instead:

* a feature outside ``[0, levels)`` adds 0 to the SVM sums;
* a packet whose ``vid`` is outside ``[0, V)`` keeps its codes and gets
  label 0, per-tree labels 0 and sums 0, in every stage (the plane
  sanitises ``vid`` before classify anyway);
* a decode row with ``kv_len <= 0`` attends to nothing and gives zeros,
  where the JAX oracle gives NaN (the decode path always has
  ``kv_len >= 1``).
"""
from __future__ import annotations

import torch

__all__ = ["tcam_match", "svm_lookup", "forest_predict_vote",
           "tcam_match_v", "tree_walk_v", "svm_lookup_v",
           "forest_predict_vote_v", "classify_fused_v", "zoo_slot",
           "classify_epilogue", "decode_attn"]

_U32 = 0xFFFFFFFF


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (JAX's int32 sum)."""
    x = x & _U32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _u32_order(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 holding the uint32 value (for ordering)."""
    return x.to(torch.int64) & _U32


def _shift_bit(bit: torch.Tensor, shift) -> torch.Tensor:
    """``bit << shift`` as uint32 bits in int32; shifts outside [0, 32)
    give 0, as XLA's uint32 shift does."""
    s = torch.as_tensor(shift).to(torch.int64)
    ok = (s >= 0) & (s < 32)
    return _wrap32(torch.where(ok, bit.to(torch.int64) << s.clamp(0, 31), 0))


def _in_zoo(vid: torch.Tensor, V: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(vid in [0, V), vid with the others sent to slot 0 as int64)."""
    ok, slot = zoo_slot(vid, V)
    return ok, slot.to(torch.int64)


def _tcam_match(codes, features, v, code_value, code_mask, fid, f_lo, f_hi,
                set_bit, valid, shift):
    """``tcam_match_v`` for versions ``v`` already inside the zoo."""
    B, T = codes.shape
    E = code_value.shape[-1]
    fidv = fid[v].to(torch.int64)                                 # [B, T, E]
    f = torch.gather(features, 1, fidv.reshape(B, T * E)).reshape(B, T, E)
    code_ok = (codes[:, :, None] & code_mask[v]) == code_value[v]
    ok = (code_ok & (f >= f_lo[v]) & (f <= f_hi[v])
          & valid[v].to(torch.bool))
    hit = ok.any(dim=-1)
    first = ok.to(torch.int32).argmax(dim=-1, keepdim=True)       # [B, T, 1]
    bit = torch.gather(set_bit[v], 2, first)[..., 0]
    new = codes | _shift_bit(bit, shift)
    return torch.where(hit, new, codes)


def tcam_match_v(codes, features, vid, code_value, code_mask, fid, f_lo, f_hi,
                 set_bit, valid, shift):
    """One ``dt_layer`` ternary lookup, version-indexed: packet b matches
    against the ``[V, T, E]`` entry tables of version ``vid[b]``; the first
    (highest-priority) matching entry sets bit ``shift``; no match, or a
    ``vid`` outside ``[0, V)``, leaves the code unchanged."""
    ok, v = _in_zoo(vid, code_value.shape[0])
    new = _tcam_match(codes, features, v, code_value, code_mask, fid, f_lo,
                      f_hi, set_bit, valid, shift)
    return torch.where(ok[:, None], new, codes)


def tree_walk_v(codes, features, vid, code_value, code_mask, fid, f_lo, f_hi,
                set_bit, valid, layer_shift):
    """All L ``dt_layer`` lookups in sequence over ``[V, L, T, E]`` tables;
    layer l writes status-code bit ``layer_shift[l]``.  A ``vid`` outside
    ``[0, V)`` leaves the codes unchanged."""
    ok, v = _in_zoo(vid, code_value.shape[0])
    out = codes
    for l in range(code_value.shape[1]):
        out = _tcam_match(
            out, features, v, code_value[:, l], code_mask[:, l], fid[:, l],
            f_lo[:, l], f_hi[:, l], set_bit[:, l], valid[:, l],
            layer_shift[l])
    return torch.where(ok[:, None], out, codes)


def svm_lookup_v(features, vid, lut, bias):
    """``sums[b, h] = bias[v, h] + Σ_f lut[v, h, f, features[b, f]]`` with
    ``v = vid[b]``, int32 wraparound; a feature outside ``[0, levels)``
    adds 0, and a ``vid`` outside ``[0, V)`` gives sums of 0."""
    V, H, F, levels = lut.shape
    B = features.shape[0]
    ok, v = _in_zoo(vid, V)
    x = features[:, :F].to(torch.int64)
    in_range = (x >= 0) & (x < levels)                            # [B, F]
    h = torch.arange(H, device=lut.device)[None, :, None]
    f = torch.arange(F, device=lut.device)[None, None, :]
    idx = ((v[:, None, None] * H + h) * F + f) * levels \
        + x.clamp(0, levels - 1)[:, None, :]
    per_f = lut.reshape(-1)[idx.reshape(-1)].reshape(B, H, F).to(torch.int64)
    per_f = torch.where(in_range[:, None, :], per_f, 0)
    sums = _wrap32(per_f.sum(dim=2) + bias[v].to(torch.int64))
    return torch.where(ok[:, None], sums, 0)


def forest_predict_vote_v(codes, vid, pred_codes, pred_labels, pred_valid,
                          weights, n_classes):
    """``dt_predict`` (exact match via binary search over the sorted leaf
    codes of version ``vid[b]``) + ``multitree_voting``.  Returns (label
    int32 [B], per-tree labels int32 [B, T]); ties go to the smaller class.
    A ``vid`` outside ``[0, V)`` gives label 0 and per-tree labels 0."""
    P = pred_codes.shape[2]
    ok, v = _in_zoo(vid, pred_codes.shape[0])
    pc = _u32_order(pred_codes[v])                                # [B, T, P]
    c = _u32_order(codes)[..., None]                              # [B, T, 1]
    pos = torch.searchsorted(pc, c).clamp(0, P - 1)
    found = ((torch.gather(pc, 2, pos) == c)
             & torch.gather(pred_valid[v].to(torch.bool), 2, pos))
    per_tree = torch.where(found, torch.gather(pred_labels[v], 2, pos),
                           0)[..., 0].to(torch.int32)             # [B, T]
    w = weights[v].to(torch.float32)                              # [B, T]
    classes = torch.arange(n_classes, device=codes.device)
    scores = torch.zeros((codes.shape[0], n_classes), dtype=torch.float32,
                         device=codes.device)
    for t in range(codes.shape[1]):                 # tree order, in float32
        scores = scores + (per_tree[:, t, None] == classes) * w[:, t, None]
    label = scores.argmax(dim=1).to(torch.int32)
    return (torch.where(ok, label, 0),
            torch.where(ok[:, None], per_tree, 0))


def _one_version(B: int, device) -> torch.Tensor:
    return torch.zeros((B,), dtype=torch.int32, device=device)


def tcam_match(codes, features, code_value, code_mask, fid, f_lo, f_hi,
               set_bit, valid, shift):
    """Single-version ``tcam_match_v``: ``[T, E]`` tables, every packet on
    them."""
    vid = _one_version(codes.shape[0], codes.device)
    return tcam_match_v(codes, features, vid, code_value[None],
                        code_mask[None], fid[None], f_lo[None], f_hi[None],
                        set_bit[None], valid[None], shift)


def svm_lookup(features, lut, bias):
    """Single-version ``svm_lookup_v``: ``[H, F, levels]`` LUT, ``[H]``
    bias."""
    vid = _one_version(features.shape[0], features.device)
    return svm_lookup_v(features, vid, lut[None], bias[None])


def forest_predict_vote(codes, pred_codes, pred_labels, pred_valid, weights,
                        n_classes):
    """Single-version ``forest_predict_vote_v``: ``[T, P]`` leaves, ``[T]``
    weights."""
    vid = _one_version(codes.shape[0], codes.device)
    return forest_predict_vote_v(codes, vid, pred_codes[None],
                                 pred_labels[None], pred_valid[None],
                                 weights[None], n_classes)


def classify_fused_v(codes, features, vid, code_value, code_mask, fid, f_lo,
                     f_hi, set_bit, valid, layer_shift, pred_codes,
                     pred_labels, pred_valid, weights, lut, bias, n_classes):
    """Whole-classify twin: tree walk -> forest vote, plus the svm LUT sums.
    Returns (final codes int32 [B, T], vote label int32 [B], svm sums int32
    [B, H])."""
    walked = tree_walk_v(codes, features, vid, code_value, code_mask, fid,
                         f_lo, f_hi, set_bit, valid, layer_shift)
    label, _per_tree = forest_predict_vote_v(
        walked, vid, pred_codes, pred_labels, pred_valid, weights, n_classes)
    sums = svm_lookup_v(features, vid, lut, bias)
    return walked, label, sums


def zoo_slot(vid, V: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plane's vid clamp: (vid in [0, V), vid with the others sent to
    slot 0, in vid's dtype).  A packet outside the zoo is classified
    against slot 0 and its result forced to -1 (``classify_epilogue``)."""
    ok = (vid >= 0) & (vid < V)
    return ok, torch.where(ok, vid, 0)


def classify_epilogue(codes_in, svm_acc_in, rslt_in, ptype, mid, vid_ok, vid,
                      codes, tree_label, partial, pred_enable, svm_bias,
                      svm_hvalid, svm_pred_table, svm_pred_enable, mid_svm,
                      request):
    """The plane's classify step after ``classify_fused_v``: the SVM
    predict on the partial sums and the result select, with the passthrough
    of every packet that is not ``request``.

    ``codes_in``, ``svm_acc_in``, ``rslt_in``, ``ptype``, ``mid`` are the
    packets' fields as they came; ``vid_ok`` and ``vid`` the clamp of
    ``zoo_slot``; ``codes``, ``tree_label`` and ``partial`` the classify's
    outputs on the clamped vids (sums without ``svm_bias``, so partial sums
    compose across devices); the tables are the plane's source tables.
    Returns (codes, svm_acc, rslt).  Each run is counted in
    ``classify_epilogue.launches``, as the kernel wrappers count theirs.
    """
    classify_epilogue.launches += 1
    vid_l = vid.to(torch.int64)
    tree_result = torch.where(pred_enable[vid_l], tree_label, -1)

    # ---- svm predict: native adds on the kernel's LUT partials ----
    acc = svm_acc_in + partial
    sums = acc + svm_bias[vid_l]
    signs = ((sums >= 0) & svm_hvalid[vid_l]).to(torch.int64)
    weights = 1 << torch.arange(signs.shape[1], device=signs.device)
    sign_code = (signs * weights).sum(dim=1)
    svm_label = svm_pred_table[vid_l, sign_code]
    svm_result = torch.where(svm_pred_enable[vid_l], svm_label, -1)

    # ---- result select + forwarding passthrough ----
    # Non-REQUEST packets come out bit-identical: their codes / svm_acc
    # intermediates and rslt are never overwritten (paper §6.1).
    is_req = ptype == request
    codes = torch.where(is_req[:, None], codes, codes_in)
    acc = torch.where(is_req[:, None], acc, svm_acc_in)
    result = torch.where(mid == mid_svm, svm_result, tree_result)
    result = torch.where(vid_ok, result, -1)
    rslt = torch.where(is_req & (result >= 0), result, rslt_in)
    return codes, acc, rslt


classify_epilogue.launches = 0


def decode_attn(q, k, v, kv_len, *, mxu_native=False):
    """GQA decode attention: one new token's query q [B, Hq, D] against a
    KV cache k/v [B, S, Hkv, D], row b masked to its first ``kv_len[b]``
    positions; a float32 softmax, the output [B, Hq, D] in q's dtype.
    Query head h reads KV head ``h // (Hq // Hkv)``.  A row with
    ``kv_len <= 0`` gives zeros, as the TPU kernel does.

    ``mxu_native`` (bfloat16): the reference's ``decode_attention(...,
    mxu_native=True)`` (``src/repro/models/attention.py:134-147``): the
    normalised softmax P rounded to bfloat16, then P.V accumulated in
    float32.  In float32 the reference's casts are no-ops, and so is the
    flag."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * D ** -0.5
    mask = (torch.arange(S, device=q.device)[None, :]
            < kv_len.to(torch.int64)[:, None])[:, None, None, :]
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - torch.where(torch.isinf(m), 0.0, m))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if mxu_native and q.dtype == torch.bfloat16:
        p = (p / den).to(torch.bfloat16).float()
        out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    else:
        out = torch.einsum("bhgs,bshd->bhgd", p, v.float()) / den
    return out.reshape(B, Hq, D).to(q.dtype)
