// Device functions shared by the classify kernels: the walk of one row by a
// group of lanes (tcam_match), the walk of all layers of a warp's (packet,
// tree) pairs (tree_walk, classify_fused), the leaf lookup by a group of
// lanes and the weighted vote by a warp (forest_vote, classify_fused).
// Each computes the per-(packet, tree) or per-packet step of the plain
// torch version in src/repro_torch/kernels/ref.py, and the kernels that
// share a step run the same function, so they compute the same bits by
// construction.
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

constexpr unsigned FULL = 0xffffffffu;

// A record that matches nothing (fid 0, range [1, 0]): what a lane holds
// for an entry at or past its row's length.
__device__ __forceinline__ int4 no_match() {
  return make_int4(0, -1, 1 << 16, 0);
}

// Does record `r` match `code` and the feature row `feat`: (code & mask)
// == value and f_lo <= feat[fid] <= f_hi?  Computed without a branch, so
// the feature read waits on the record only, not on the code.
__device__ __forceinline__ bool record_matches(const int4& r, unsigned code,
                                               const int* feat) {
  const int x = feat[(short)(r.z & 0xFFFF)];
  const bool in_range = x >= (r.z >> 16) && x <= (int)(short)(r.w & 0xFFFF);
  return in_range && (code & (unsigned)r.y) == (unsigned)r.x;
}

// One dt_layer lookup for one (packet, tree) by the GL lanes of a group:
// the FIRST entry of `rec[0, n)` that matches sets bit `shift` to its
// set_bit (a shift outside [0, 32) sets nothing, as XLA's uint32 shift
// does); no match leaves the code unchanged.  Each round the group's lanes
// load GL consecutive records of the row at once (one coalesced load), each
// lane tests its own, and one ballot finds the round's first hit (the
// lowest lane: the lowest entry); a second ballot reads that hit's set bit.
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
  int4 r = glane < E ? __ldg(rec + glane) : no_match();
  int n = glane == 0 ? __ldg(n_row) : 0;
  n = __shfl_sync(gmask, n, 0, GL);
  const unsigned bit = shift >= 0 && shift < 32 ? 1u << shift : 0u;
  for (int e0 = 0; e0 < n; e0 += GL) {
    const int e = e0 + glane;
    const int4 nxt = e + GL < n ? __ldg(rec + e + GL) : no_match();
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

// The walk of 32 / GL (packet, tree) pairs by one warp, GL lanes each: every
// layer of the pairs' rows, in order, each layer's first match found GL
// records at a time with one ballot (and a second for the set bits).
// Layers are taken in chunks of GL: a lane per layer of the chunk reads the
// pair's row length and a ballot over the whole warp skips the layers that
// are empty for every pair of the warp.  The first GL records of the next
// layer a pair needs are loaded before this layer is compared, since a
// row's place does not depend on the code; rows longer than GL take further
// rounds while a pair of the warp has no match.  `rows` is the pair's row
// at layer 0 (layer l at l * T rows on), `sn` its row lengths in shared
// memory (stride T; zeros off the zoo), `s_bit` each layer's bit (0 for a
// shift outside [0, 32)), `gbase` the group's first lane in the warp.
// Every lane of the warp must call it; returns the pair's final code (the
// same in the group's lanes).
template <int GL>
__device__ __forceinline__ unsigned walk_pair(unsigned code, const int* feat,
                                              const int4* rows, const int* sn,
                                              const unsigned* s_bit, int L,
                                              int T, int E, int glane,
                                              int gbase) {
  constexpr int GPW = 32 / GL;
  constexpr unsigned GMASK = GL == 32 ? FULL : (1u << GL) - 1;
  for (int l0 = 0; l0 < L; l0 += GL) {
    // a lane per layer of this chunk: which layers any pair of the warp has
    const int l = l0 + glane;
    const unsigned has = __ballot_sync(FULL, l < L && sn[l * T] > 0);
    unsigned todo = 0;
#pragma unroll
    for (int g = 0; g < GPW; ++g) todo |= (has >> (g * GL)) & GMASK;
    if (!todo) continue;
    int j = __ffs(todo) - 1;
    int n = sn[(l0 + j) * T];
    const int4* row = rows + (l0 + j) * T * E;
    int4 cur = glane < n ? __ldg(row + glane) : no_match();
    while (true) {
      todo &= todo - 1;
      // the next layer's first records, before this layer's compares
      const int jn = __ffs(todo) - 1;
      const int nn = todo ? sn[(l0 + jn) * T] : 0;
      const int4* row_n = rows + (l0 + jn) * T * E;
      const int4 nxt = glane < nn ? __ldg(row_n + glane) : no_match();
      bool hit = record_matches(cur, code, feat);
      unsigned mine = (__ballot_sync(FULL, hit) >> gbase) & GMASK;
      unsigned set =
          (__ballot_sync(FULL, hit && (cur.w & 0x10000)) >> gbase) & GMASK;
      // rows longer than GL: further rounds while a pair has no match
      if (__any_sync(FULL, !mine && n > GL)) {
        for (int e0 = GL; __any_sync(FULL, !mine && e0 < n); e0 += GL) {
          const int4 r = !mine && e0 + glane < n ? __ldg(row + e0 + glane)
                                                 : no_match();
          hit = record_matches(r, code, feat);
          const unsigned more = (__ballot_sync(FULL, hit) >> gbase) & GMASK;
          const unsigned more_set =
              (__ballot_sync(FULL, hit && (r.w & 0x10000)) >> gbase) & GMASK;
          if (!mine) {
            mine = more;
            set = more_set;
          }
        }
      }
      // the first match's set bit: the lowest bit of `mine`
      if (set & mine & (0u - mine)) code |= s_bit[l0 + j];
      if (!todo) break;
      j = jn;
      n = nn;
      row = row_n;
      cur = nxt;
    }
  }
  return code;
}

// dt_predict for one (packet, tree) by the GL lanes of a group: the lower
// bound of `code` over the P >= 1 leaf codes `pc`, sorted in unsigned
// order, found by a GL-ary search (ceil(log_GL P) rounds of one load a
// lane, 3 at P 256, where a binary search chains log2 P loads); the label
// at an exact match, else 0.  Invalid leaves carry label 0 already.  Every
// lane of the warp must call it.
template <int GL>
__device__ __forceinline__ int leaf_label_group(const unsigned* pc,
                                                const int* labels, int P,
                                                unsigned code, int glane,
                                                int gbase) {
  constexpr unsigned GMASK = GL == 32 ? FULL : (1u << GL) - 1;
  // invariant: pc[i] < code for i < lo, and hi == P or pc[hi] >= code
  int lo = 0, hi = P;
  for (int step = (P + GL - 1) / GL;; step = (step + GL - 1) / GL) {
    const int idx = lo + (glane + 1) * step - 1;
    const bool below = idx < hi && __ldg(pc + idx) < code;
    const int count = __popc((__ballot_sync(FULL, below) >> gbase) & GMASK);
    lo += count * step;
    hi = min(hi, lo + step - 1);
    if (step == 1) break;
  }
  const int pos = min(lo, P - 1);
  return __ldg(pc + pos) == code ? __ldg(labels + pos) : 0;
}

// multitree_voting for one packet by one warp, a lane per class (classes
// c0 + lane, c0 = 0, 32, ...): each score summed in f32 in tree order
// t = 0..T-1, as the twin sums it, with the trees' weights passed by
// shuffle from the lane that loaded them; then a shuffle argmax (the higher
// score wins, ties go to the smaller class).  `lab` is the packet's T
// per-tree labels in shared memory, `w` its version's T weights, `w_first`
// the lane's weight of trees 0..31 (w[lane], 0 past T), which the caller
// may load early.  Every lane of the warp must call it; returns the winning
// class in every lane.
__device__ __forceinline__ int vote_warp(const int* lab, const float* w,
                                         float w_first, int T, int n_classes,
                                         int lane) {
  float best = -INFINITY;
  int best_c = 0;
  for (int c0 = 0; c0 < n_classes; c0 += 32) {
    const int c = c0 + lane;
    float score = 0.f;
    for (int t0 = 0; t0 < T; t0 += 32) {
      const float wl = t0 == 0 ? w_first
                               : t0 + lane < T ? __ldg(w + t0 + lane) : 0.f;
      for (int t = 0; t < min(32, T - t0); ++t) {
        const float wt = __shfl_sync(FULL, wl, t);
        if (lab[t0 + t] == c) score += wt;
      }
    }
    if (c < n_classes && score > best) {
      best = score;
      best_c = c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, off);
    const int oc = __shfl_xor_sync(FULL, best_c, off);
    if (ob > best || (ob == best && oc < best_c)) {
      best = ob;
      best_c = oc;
    }
  }
  return best_c;
}

}  // namespace acorn
