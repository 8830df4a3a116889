// Whole-classify kernel for Hopper (sm_90a): tree walk -> forest vote ->
// SVM LUT sums, one launch per classify.
//
// Replaces the Pallas TPU kernel `classify_fused_pallas_v`
// (src/repro/kernels/classify_fused.py:166, body `_kernel` :73).  Held bit
// for bit to the plain torch version (src/repro_torch/kernels/ref.py,
// `classify_fused_v`).
//
// Per packet b with version v = vid[b] (v outside [0, V): codes pass
// through, label 0, sums 0):
//   walk  for each tree t and layer l, the FIRST entry of row (v, l, t) with
//         (code & mask) == value and f_lo <= feat[b, fid] <= f_hi sets bit
//         layer_shift[l] to its set_bit; no match leaves the code unchanged.
//   vote  leaf label by exact match of the final code among the sorted leaf
//         codes of (v, t) (lower-bound binary search), then class scores
//         summed in tree order in f32; argmax, ties to the smaller class.
//   svm   bias[v, h] + sum_f lut[v, h, f, feat[b, f]] in int32 (mod 2^32);
//         a feature outside [0, levels) adds 0.
//
// What bounds it on this card: bytes.  The arithmetic is a few integer
// compares per entry; the work is reading the entry records a walk visits
// (16 B each), the touched leaf and LUT entries, and the per-packet I/O.
// One version's tables at the paper's profile are about 0.5 MB of entries
// and 0.74 MB of LUT, so a zoo of four versions stays resident in the 50 MB
// L2 and the card's HBM sees each table once per classify.
//
// What the design does about it:
//   * a block takes PB packets and stages their feature rows in shared
//     memory once; the walk, the vote and the SVM all read them there
//     (the TPU kernel's one-hot MXU select becomes a direct index);
//   * a thread per (packet, tree) walks with one 16-byte read-only load per
//     entry and stops at the first hit, and at the row's last valid entry
//     (`n_entries`), so sparse and empty rows cost nothing;
//   * each packet indexes its own version's tables: no version grid and no
//     masked merge;
//   * a thread per (packet, hyperplane) accumulates the SVM sum in int32
//     with a direct gather, with no f32 one-hot contraction and no rounding.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256) classify_fused_kernel(
    const int* __restrict__ codes,        // [B, T] uint32 bits
    const int* __restrict__ feats,        // [B, F]
    const int* __restrict__ vid,          // [B]
    const int* __restrict__ layer_shift,  // [L]
    const int4* __restrict__ entries,     // [V, L, T, E] records
    const int* __restrict__ n_entries,    // [V, L, T]
    const unsigned* __restrict__ pred_codes,  // [V, T, P] sorted
    const int* __restrict__ pred_labels,  // [V, T, P]
    const float* __restrict__ weights,    // [V, T]
    const int* __restrict__ lut,          // [V, H, F, levels]
    const int* __restrict__ bias,         // [V, H]
    int* __restrict__ out_codes,          // [B, T]
    int* __restrict__ out_label,          // [B]
    int* __restrict__ out_sums,           // [B, H]
    int B, int F, int V, int L, int T, int E, int P, int H, int levels,
    int n_classes, int PB) {
  extern __shared__ int smem[];
  int* s_feat = smem;            // [PB, F]
  int* s_label = smem + PB * F;  // [PB, T] per-tree leaf labels
  const int b0 = blockIdx.x * PB;
  const int n_here = min(PB, B - b0);

  for (int i = threadIdx.x; i < n_here * F; i += blockDim.x)
    s_feat[i] = feats[(size_t)b0 * F + i];
  __syncthreads();

  // ---- walk + leaf lookup: one thread per (packet, tree) ----
  if (threadIdx.x < n_here * T) {
    const int p = threadIdx.x / T, t = threadIdx.x % T;
    const int b = b0 + p;
    unsigned code = (unsigned)codes[(size_t)b * T + t];
    const int v = vid[b];
    int label = 0;
    if (v >= 0 && v < V) {
      const int* f = s_feat + p * F;
      for (int l = 0; l < L; ++l) {
        const size_t row = ((size_t)v * L + l) * T + t;
        const int n = __ldg(n_entries + row);
        const int4* rec = entries + row * E;
        for (int e = 0; e < n; ++e) {
          const int4 r = __ldg(rec + e);
          if ((code & (unsigned)r.y) != (unsigned)r.x) continue;
          const int x = f[(short)(r.z & 0xFFFF)];
          if (x < (r.z >> 16) || x > (int)(short)(r.w & 0xFFFF)) continue;
          const int s = __ldg(layer_shift + l);
          if (((r.w >> 16) & 1) && s >= 0 && s < 32) code |= 1u << s;
          break;
        }
      }
      const size_t leaf = ((size_t)v * T + t) * P;
      const unsigned* pc = pred_codes + leaf;
      int lo = 0, hi = P;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(pc + mid) < code) lo = mid + 1; else hi = mid;
      }
      const int pos = min(lo, P - 1);
      if (__ldg(pc + pos) == code) label = __ldg(pred_labels + leaf + pos);
    }
    out_codes[(size_t)b * T + t] = (int)code;
    s_label[p * T + t] = label;
  }
  __syncthreads();

  // ---- vote: one thread per packet ----
  if (threadIdx.x < n_here) {
    const int b = b0 + threadIdx.x;
    const int v = vid[b];
    int best_c = 0;
    if (v >= 0 && v < V) {
      const int* lab = s_label + threadIdx.x * T;
      const float* w = weights + (size_t)v * T;
      float best = -INFINITY;
      for (int c = 0; c < n_classes; ++c) {
        float score = 0.f;
        for (int t = 0; t < T; ++t)
          if (lab[t] == c) score += __ldg(w + t);
        if (score > best) { best = score; best_c = c; }
      }
    }
    out_label[b] = best_c;
  }

  // ---- svm sums: one thread per (packet, hyperplane) ----
  for (int i = threadIdx.x; i < n_here * H; i += blockDim.x) {
    const int p = i / H, h = i % H;
    const int b = b0 + p;
    const int v = vid[b];
    unsigned acc = 0;
    if (v >= 0 && v < V) {
      acc = (unsigned)__ldg(bias + (size_t)v * H + h);
      const int* lut_h = lut + ((size_t)v * H + h) * F * levels;
      const int* f = s_feat + p * F;
      for (int j = 0; j < F; ++j) {
        const int x = f[j];
        if (x >= 0 && x < levels)
          acc += (unsigned)__ldg(lut_h + (size_t)j * levels + x);
      }
    }
    out_sums[(size_t)b * H + h] = (int)acc;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  The caller sizes PB so that the block
// (PB * T threads, at most 256) and its shared memory (PB * (F + T) ints,
// at most 48 KB) fit.
extern "C" int acorn_classify_fused(
    const void* codes, const void* feats, const void* vid,
    const void* layer_shift, const void* entries, const void* n_entries,
    const void* pred_codes, const void* pred_labels, const void* weights,
    const void* lut, const void* bias, void* out_codes, void* out_label,
    void* out_sums, int B, int F, int V, int L, int T, int E, int P, int H,
    int levels, int n_classes, int PB, void* stream) {
  const int grid = (B + PB - 1) / PB;
  const size_t smem = (size_t)PB * (F + T) * sizeof(int);
  classify_fused_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const int*)codes, (const int*)feats, (const int*)vid,
      (const int*)layer_shift, (const int4*)entries, (const int*)n_entries,
      (const unsigned*)pred_codes, (const int*)pred_labels,
      (const float*)weights, (const int*)lut, (const int*)bias,
      (int*)out_codes, (int*)out_label, (int*)out_sums, B, F, V, L, T, E, P,
      H, levels, n_classes, PB);
  return (int)cudaGetLastError();
}
