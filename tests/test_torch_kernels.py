"""The port's classify kernel against the JAX package's.

The twin ``repro_torch.kernels.ref.classify_fused_v`` is held bit for bit to
the JAX oracle ``repro.kernels.ref.classify_fused_v`` and to the Pallas
kernel ``classify_fused_pallas_v`` run in interpret mode, on the same numpy
draws (the parameter sets of ``tests/test_fused.py``).  The kernel wrapper's
plain version (the install-time operands decoded back through the twin) is
held to the same answers (the CUDA kernel itself is held to the twin on a
card by ``tests/test_torch_gpu.py``).
Every output is an integer, and the f32 vote scores are sums of the same
weights in the same order, so the tolerance is exact.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.classify_fused import classify_fused_pallas_v
from repro_torch.core.packets import u32_bits, u32_from_bits
from repro_torch.kernels import ops, ref, tiling
from repro_torch.kernels.classify_fused import (
    classify_fused,
    classify_fused_plain,
    packets_per_block,
)
from test_fused import _rand_fused

# (B, T, E, F, V, L, P, C, H, levels, empty zoo slots) — test_fused.py:59-65
SWEEP = [
    (7, 1, 3, 4, 1, 1, 4, 2, 1, 16, ()),
    (64, 4, 17, 13, 4, 5, 32, 5, 3, 64, ()),
    (300, 2, 130, 20, 2, 3, 16, 3, 2, 32, ()),
    (257, 3, 33, 21, 8, 8, 64, 6, 4, 64, (1, 5)),
    (33, 5, 64, 40, 1, 32, 128, 8, 8, 128, ()),
]
# argument positions of _rand_fused's tuple that hold uint32 values
_U32_ARGS = (0, 3, 4, 11)


def to_torch(args, device="cpu"):
    """The JAX argument tuple -> torch tensors (uint32 as int32 bits)."""
    out = []
    for i, a in enumerate(args):
        a = np.asarray(a)
        if i in _U32_ARGS:
            t = u32_bits(a)
        elif a.dtype == np.uint32:          # set_bit {0, 1}
            t = torch.from_numpy(a.astype(np.int32))
        else:
            t = torch.from_numpy(np.array(a))
        out.append(t.to(device))
    return out


def assert_same(port, jax_out):
    codes, label, sums = port
    np.testing.assert_array_equal(u32_from_bits(codes), np.asarray(jax_out[0]))
    np.testing.assert_array_equal(label.cpu().numpy(), np.asarray(jax_out[1]))
    np.testing.assert_array_equal(sums.cpu().numpy(), np.asarray(jax_out[2]))


def _prep(targs):
    return tiling.prep_classify_fused(*targs[3:10], *targs[11:17])


@pytest.mark.parametrize("B,T,E,F,V,L,P,C,H,levels,empty", SWEEP)
def test_twin_matches_jax_oracle_and_pallas(B, T, E, F, V, L, P, C, H,
                                            levels, empty):
    rng = np.random.default_rng(B * 31 + V)
    args = _rand_fused(rng, B, T, E, F, V, L, P, C, H, levels,
                       empty_slots=empty)
    want = jref.classify_fused_v(*args, C)
    pallas = classify_fused_pallas_v(*args, C, interpret=True)
    for j, p in zip(want, pallas):
        np.testing.assert_array_equal(np.asarray(j), np.asarray(p))
    targs = to_torch(args)
    assert_same(ref.classify_fused_v(*targs, C), want)
    # the wrapper on CPU tensors = the plain version on the prepped operands
    ops_ = _prep(targs)
    assert_same(classify_fused(targs[0], targs[1], targs[2], targs[10], ops_,
                               C), want)
    assert_same(ops.classify_fused_v(*targs, C, mode="cuda"), want)


def test_int16_boundary_features():
    """Feature values and range bounds at the int16 ceiling (2^15 - 1, the
    feature_width = 15 limit) compare exactly through the int16 records."""
    rng = np.random.default_rng(11)
    B, T, E, F, V, L, P, C, H, levels = 40, 2, 8, 6, 2, 3, 16, 3, 2, 32
    args = list(_rand_fused(rng, B, T, E, F, V, L, P, C, H, levels))
    top = 2**15 - 1
    feats = np.asarray(rng.integers(0, levels, (B, F)), np.int32)
    feats[::3] = top
    args[1] = feats
    flo = np.asarray(rng.integers(0, top, (V, L, T, E)), np.int32)
    flo[..., ::2] = top
    fhi = np.minimum(flo + np.asarray(
        rng.integers(0, 100, (V, L, T, E)), np.int32), top)
    args[6], args[7] = flo, fhi
    want = jref.classify_fused_v(*args, C)
    targs = to_torch(args)
    assert_same(ref.classify_fused_v(*targs, C), want)
    assert_same(classify_fused_plain(targs[0], targs[1], targs[2], targs[10],
                                     _prep(targs), C), want)
    # the walk against the Pallas kernel (its svm stage reads features >=
    # levels through an int16 one-hot, a layout the port does not share)
    pallas = classify_fused_pallas_v(*args, C, interpret=True)
    np.testing.assert_array_equal(u32_from_bits(ref.classify_fused_v(
        *targs, C)[0]), np.asarray(pallas[0]))


def test_all_masked_and_wildcard_rows():
    """Rows carrying the no-match convention (mask all bits against value 0)
    and fully wildcarded rows (mask 0) decode exactly."""
    rng = np.random.default_rng(12)
    B, T, E, F, V, L, P, C, H, levels = 50, 2, 8, 6, 2, 3, 16, 3, 2, 32
    args = list(_rand_fused(rng, B, T, E, F, V, L, P, C, H, levels))
    cm = np.full((V, L, T, E), 0xFFFFFFFF, np.uint32)
    cm[..., ::2] = 0
    args[3], args[4] = np.zeros((V, L, T, E), np.uint32), cm
    want = jref.classify_fused_v(*args, C)
    pallas = classify_fused_pallas_v(*args, C, interpret=True)
    targs = to_torch(args)
    for port in (ref.classify_fused_v(*targs, C),
                 classify_fused_plain(targs[0], targs[1], targs[2], targs[10],
                                      _prep(targs), C)):
        assert_same(port, want)
        assert_same(port, pallas)


def test_prep_records_hold_the_source_tables():
    """Each 16-byte record decodes to its entry's fields; invalid entries
    become no-match entries; the loop bound is one past the last valid
    entry; invalid leaves read label 0."""
    rng = np.random.default_rng(13)
    B, T, E, F, V, L, P, C, H, levels = 20, 3, 9, 7, 3, 4, 16, 4, 2, 32
    args = _rand_fused(rng, B, T, E, F, V, L, P, C, H, levels,
                       empty_slots=(2,))
    targs = to_torch(args)
    cv, cm, fid, flo, fhi, bit, valid = targs[3:10]
    prep = _prep(targs)
    assert prep.entries.shape == (V, L, T, E, 4)
    assert prep.entries.dtype == torch.int32
    (ucv, ucm, ufid, uflo, ufhi, ubit, uvalid, upc, ulab, upv, uw, ulut,
     ubias) = tiling.unpack_classify_fused(prep)
    for got, src in ((ucv, cv), (ucm, cm), (ufid, fid), (uflo, flo),
                     (ufhi, fhi), (ubit, bit)):
        assert torch.equal(got[valid], src[valid].to(got.dtype))
    inv = ~valid & uvalid          # invalid entries inside the loop bound
    nm_cv, nm_cm, nm_lo, nm_hi = tiling.NO_MATCH
    assert (ucv[inv] == nm_cv).all() and (ucm[inv] == nm_cm).all()
    assert (uflo[inv] == nm_lo).all() and (ufhi[inv] == nm_hi).all()
    pos = torch.arange(1, E + 1)
    want_n = torch.where(valid, pos, 0).amax(dim=-1)
    assert torch.equal(prep.n_entries, want_n.to(torch.int32))
    assert (prep.n_entries[2] == 0).all()          # the empty slot
    assert torch.equal(ulab, torch.where(targs[13], targs[12], 0))
    assert torch.equal(upc, targs[11]) and torch.equal(ulut, targs[15])


def test_prep_rejects_bounds_outside_int16():
    rng = np.random.default_rng(14)
    args = list(_rand_fused(rng, 8, 2, 4, 5, 1, 2, 8, 3, 2, 16))
    targs = to_torch(args)
    targs[7] = targs[7].clone()
    targs[7][0, 0, 0, 0] = 2**15
    targs[9] = torch.ones_like(targs[9])
    with pytest.raises(ValueError, match="int16"):
        _prep(targs)


@pytest.mark.parametrize("T,F,want", [(8, 60, 32), (1, 4, 256), (3, 10, 85),
                                      (8, 6000, 2)])
def test_packets_per_block_fits_threads_and_shared_memory(T, F, want):
    pb = packets_per_block(T, F)
    assert pb == want
    assert pb * T <= 256 and pb * (F + T) * 4 <= 48 * 1024


def test_wrapper_rejects_other_devices():
    rng = np.random.default_rng(15)
    targs = to_torch(_rand_fused(rng, 4, 1, 3, 4, 1, 1, 4, 2, 1, 16))
    ops_ = _prep(targs)
    with pytest.raises(ValueError, match="codes on meta"):
        classify_fused(targs[0].to("meta"), targs[1], targs[2], targs[10],
                       ops_, 2)
    meta = [t.to("meta") for t in (targs[0], targs[1], targs[2], targs[10])]
    with pytest.raises(ValueError, match="no classify_fused kernel"):
        classify_fused(*meta, tiling.ClassifyFusedOperands(
            *(x.to("meta") for x in ops_)), 2)
