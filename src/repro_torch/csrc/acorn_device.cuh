// Device functions shared by the staged classify kernels (tree_walk,
// tcam_match, forest_vote): one walk row (by one thread, or by a group of
// lanes), one leaf lookup and the weighted vote.  Each is the
// per-(packet, tree) step of the plain torch version in
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

// Does record `r` match `code` and the feature row `feat`?  The test of
// walk_row, computed without a branch.
__device__ __forceinline__ bool record_matches(const int4& r, unsigned code,
                                               const int* feat) {
  const int x = feat[(short)(r.z & 0xFFFF)];
  const bool in_range = x >= (r.z >> 16) && x <= (int)(short)(r.w & 0xFFFF);
  return in_range && (code & (unsigned)r.y) == (unsigned)r.x;
}

// walk_row for one (packet, tree) by the GL lanes of a group: the same
// first match, found GL records a round.  Each round the group's lanes load
// GL consecutive records of the row at once (one coalesced load), each lane
// tests its own, and one ballot finds the round's first hit (the lowest
// lane: the lowest entry); a second ballot reads that hit's set bit.
// Rounds go on while no hit is found and entries remain.  The row length
// `n_row[0]` is read once by the group's first lane and shuffled to the
// others, and the first round's records are loaded beside it (every one of
// the row's E records may be read: the hit test masks those at or past
// n); each later round's records are loaded before the current round's are
// tested.  `glane` is the lane's index in its group, `gmask` the group's
// lanes in the warp; every lane of the group passes the same code, row and
// shift and gets the same code back.
template <int GL>
__device__ __forceinline__ unsigned walk_row_group(
    unsigned code, const int* feat, const int4* rec, const int* n_row, int E,
    int shift, int glane, unsigned gmask) {
  const int4 none = make_int4(0, -1, 1 << 16, 0);  // fid 0, range [1, 0]
  int4 r = glane < E ? __ldg(rec + glane) : none;
  int n = glane == 0 ? __ldg(n_row) : 0;
  n = __shfl_sync(gmask, n, 0, GL);
  const unsigned bit = shift >= 0 && shift < 32 ? 1u << shift : 0u;
  for (int e0 = 0; e0 < n; e0 += GL) {
    const int e = e0 + glane;
    const int4 nxt = e + GL < n ? __ldg(rec + e + GL) : none;
    const bool hit = e < n && record_matches(r, code, feat);
    const unsigned hits = __ballot_sync(gmask, hit);
    if (hits) {
      const unsigned set = __ballot_sync(gmask, hit && (r.w & 0x10000));
      if (set & hits & (0u - hits)) code |= bit;
      break;
    }
    r = nxt;
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

}  // namespace acorn
