// Device functions shared by the staged classify kernels (tree_walk,
// tcam_match, forest_vote, svm_lookup): one walk row, one leaf lookup, the
// weighted vote and one SVM hyperplane sum.  Each is the per-(packet, tree)
// or per-(packet, hyperplane) step of the plain torch version in
// src/repro_torch/kernels/ref.py, so the staged kernels compute the same
// bits by construction.  The fused kernel (classify_fused.cu) does the same
// steps with lanes working together on one pair, held to the same plain
// version by the tests.
//
// Walk records are the 16-byte entries of kernels/tiling.py:
//   x  code value (uint32 bits)
//   y  code mask  (uint32 bits)
//   z  fid (int16, low half)  | f_lo (int16, high half)
//   w  f_hi (int16, low half) | set_bit << 16
// Invalid entries are written as no-match entries, and each row's loop
// bound `n` is one past its last valid entry.
#pragma once

#include <math.h>
#include <stdint.h>

namespace acorn {

// One dt_layer lookup for one (packet, tree): the FIRST entry of `rec[0, n)`
// with (code & mask) == value and f_lo <= feat[fid] <= f_hi sets bit `shift`
// to its set_bit; no match leaves the code unchanged.  A shift outside
// [0, 32) sets nothing, as XLA's uint32 shift does.
__device__ __forceinline__ unsigned walk_row(unsigned code, const int* feat,
                                             const int4* rec, int n,
                                             int shift) {
  for (int e = 0; e < n; ++e) {
    const int4 r = __ldg(rec + e);
    if ((code & (unsigned)r.y) != (unsigned)r.x) continue;
    const int x = feat[(short)(r.z & 0xFFFF)];
    if (x < (r.z >> 16) || x > (int)(short)(r.w & 0xFFFF)) continue;
    if (((r.w >> 16) & 1) && shift >= 0 && shift < 32) code |= 1u << shift;
    break;
  }
  return code;
}

// dt_predict for one (packet, tree): lower-bound binary search of `code`
// over the P >= 1 leaf codes `pc`, sorted in unsigned order; the label at an
// exact match, else 0.  Invalid leaves carry label 0 already.
__device__ __forceinline__ int leaf_label(const unsigned* pc,
                                          const int* labels, int P,
                                          unsigned code) {
  int lo = 0, hi = P;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(pc + mid) < code) lo = mid + 1; else hi = mid;
  }
  const int pos = min(lo, P - 1);
  return __ldg(pc + pos) == code ? __ldg(labels + pos) : 0;
}

// multitree_voting for one packet: class scores summed in f32 in tree order
// t = 0..T-1; the first class with the highest score wins (ties go to the
// smaller class).
__device__ __forceinline__ int vote(const int* lab, const float* w, int T,
                                    int n_classes) {
  float best = -INFINITY;
  int best_c = 0;
  for (int c = 0; c < n_classes; ++c) {
    float score = 0.f;
    for (int t = 0; t < T; ++t)
      if (lab[t] == c) score += __ldg(w + t);
    if (score > best) { best = score; best_c = c; }
  }
  return best_c;
}

// svm_mul + native adds for one (packet, hyperplane):
// bias + sum_f lut_h[f, feat[f]] in int32, wrapping mod 2^32; a feature
// outside [0, levels) adds 0.
__device__ __forceinline__ int svm_sum(const int* feat, const int* lut_h,
                                       int F, int levels, int bias) {
  unsigned acc = (unsigned)bias;
  for (int j = 0; j < F; ++j) {
    const int x = feat[j];
    if (x >= 0 && x < levels)
      acc += (unsigned)__ldg(lut_h + (size_t)j * levels + x);
  }
  return (int)acc;
}

}  // namespace acorn
