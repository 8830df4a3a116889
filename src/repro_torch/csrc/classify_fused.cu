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
//   svm   bias[v, h] + sum_f lut[v, f, feat[b, f], h] in int32 (mod 2^32);
//         a feature outside [0, levels) adds 0.
//
// What bounds it on this card: latency (chains of dependent steps), not
// bytes.  The bytes a classify needs (the walk records the packets visit,
// the leaves and LUT cells they touch, the per-packet I/O: ~3.5 MB at the
// zoo's B 4096) take ~1 us at 3.35 TB/s, and a zoo's tables stay in the
// 50 MB L2 (the walk's rows and the leaves mostly in L1).  The walk is a
// chain: layer l + 1 needs layer l's code, and a row's first match needs
// its records in order.
//
// What the design does about it:
//   * GL = 8 lanes walk one (packet, tree), 4 pairs a warp: per layer they
//     load GL records of the row at once, test them in parallel and take
//     the first match with __ballot_sync (one ballot for the hits, one for
//     their set bits), so a layer costs one round of loads, not one per
//     record; the next layer's first records are loaded before this layer
//     is compared (a row's place does not depend on the code);
//   * each packet's feature row, its version's row lengths and the
//     layers' bits are staged in shared memory once, so an empty layer
//     costs a shared-memory read and a ballot;
//   * a block is 4 walking warps and one SVM warp: the SVM sums do not
//     need the walk, so that warp gathers the LUT while the others walk.
//     The LUT is read from an install-time copy with the hyperplanes
//     innermost (tiling.py, `lut_fh`), so a feature's H products are one
//     contiguous gather, 8 of them in flight a lane, past L1 (__ldcg) so
//     the walk's rows stay there; lanes over (feature slice, hyperplane),
//     slices added with shuffles (int32 adds wrap: any order, same bits);
//   * the leaf lookup is a GL-ary lower-bound search (3 rounds of one
//     load a lane at 256 leaves, where a binary search chains 8 loads); it
//     finds the position the twin's searchsorted finds on the sorted leaves;
//   * the vote is a warp per packet, a lane per class, each score summed
//     in tree order t = 0..T-1 as the twin sums it with the weights passed
//     by shuffle, then a shuffle argmax (ties to the smaller class);
//   * the walk, the leaf lookup and the vote are the device functions of
//     acorn_device.cuh (walk_pair, leaf_label_group, vote_warp), which the
//     staged tree_walk and forest_vote kernels run too;
//   * PB packets a block (2 at the zoo's 8 trees), chosen by the wrapper
//     (kernels/classify_fused.py, `packets_per_block`) so every walking
//     lane has a pair and the grid holds at least two blocks an SM.
// Measured on an H100 (PERF.md): 0.034 ms at the zoo's B 4096, down from
// 0.075.  Per-block timestamps (tools/classify_fused_phases.py) show a
// block living ~11 us with ~5.5 resident per SM: the deepest tree's walk
// at ~0.44 us a layer, and staging the row lengths one L2 round trip.
// Rows are shared through L1 rather than staged in shared memory: one
// version's layer is up to 16 KB and a block's packets may span every
// version, so double-buffered staging would hold ~128 KB a block and one
// block an SM.

#include <cuda_runtime.h>
#include <math.h>

#include "acorn_device.cuh"

namespace {

constexpr int WALK_WARPS = 4;     // warps that walk (packet, tree) pairs
constexpr int WARPS = WALK_WARPS + 1;   // and one that sums the SVM LUTs
constexpr int THREADS = 32 * WARPS;
constexpr int GL = 8;             // lanes that walk one (packet, tree)
constexpr int GPW = 32 / GL;      // (packet, tree) walks a warp
constexpr unsigned FULL = acorn::FULL;
constexpr int SVM_BATCH = 8;      // LUT gathers a lane has in flight

__global__ void __launch_bounds__(THREADS) classify_fused_kernel(
    const int* __restrict__ codes,        // [B, T] uint32 bits
    const int* __restrict__ feats,        // [B, F]
    const int* __restrict__ vid,          // [B]
    const int* __restrict__ layer_shift,  // [L]
    const int4* __restrict__ entries,     // [V, L, T, E] records
    const int* __restrict__ n_entries,    // [V, L, T]
    const unsigned* __restrict__ pred_codes,  // [V, T, P] sorted
    const int* __restrict__ pred_labels,  // [V, T, P]
    const float* __restrict__ weights,    // [V, T]
    const int* __restrict__ lut_fh,       // [V, F, levels, H]
    const int* __restrict__ bias,         // [V, H]
    int* __restrict__ out_codes,          // [B, T]
    int* __restrict__ out_label,          // [B]
    int* __restrict__ out_sums,           // [B, H]
    int B, int F, int V, int L, int T, int E, int P, int H, int levels,
    int n_classes, int PB) {
  extern __shared__ int smem[];
  int* s_feat = smem;                // [PB, F]
  int* s_label = s_feat + PB * F;    // [PB, T] per-tree leaf labels
  int* s_vid = s_label + PB * T;     // [PB]
  int* s_n = s_vid + PB;             // [PB, L, T] row lengths, 0 off the zoo
  unsigned* s_bit = (unsigned*)(s_n + PB * L * T);  // [L] each layer's bit
  const int b0 = blockIdx.x * PB;
  const int n_here = min(PB, B - b0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int glane = lane % GL, gbase = lane - glane;

  for (int i = threadIdx.x; i < n_here * F; i += THREADS)
    s_feat[i] = feats[(size_t)b0 * F + i];
  for (int i = threadIdx.x; i < n_here; i += THREADS) s_vid[i] = vid[b0 + i];
  for (int i = threadIdx.x; i < n_here * L * T; i += THREADS) {
    const int v = vid[b0 + i / (L * T)];
    s_n[i] = v >= 0 && v < V
        ? __ldg(n_entries + (size_t)v * L * T + i % (L * T)) : 0;
  }
  for (int i = threadIdx.x; i < L; i += THREADS) {
    const int sh = __ldg(layer_shift + i);
    s_bit[i] = sh >= 0 && sh < 32 ? 1u << sh : 0u;
  }
  __syncthreads();

  // ---- svm sums, beside the walk: the last warp, packet by packet, lanes
  // over (slice of the features, hyperplane), so a feature's H products are
  // one contiguous gather; the
  // slices' sums added with shuffles (int32 adds wrap: any order gives the
  // same bits).  The gathers skip L1 (__ldcg), which keeps the walk's rows
  // and the leaves there ----
  const int hp = H > 16 ? 32 : H > 8 ? 16 : H > 4 ? 8 : H > 2 ? 4
                                                    : H > 1 ? 2 : 1;
  const int slices = 32 / hp;
  for (int p = 0; warp == WALK_WARPS && p < n_here; ++p) {
    const int v = s_vid[p];
    const bool in = v >= 0 && v < V;
    const int* f = s_feat + p * F;
    for (int h0 = 0; h0 < H; h0 += hp) {
      const int h = h0 + lane % hp, sl = lane / hp;
      unsigned acc = 0;
      if (in && h < H) {
        const int* lut_h = lut_fh + (size_t)v * F * levels * H + h;
        // SVM_BATCH gathers issued before any is added: each load reads a
        // clamped, valid cell and a mask drops what the twin adds as 0
        for (int j0 = sl; j0 < F; j0 += SVM_BATCH * slices) {
          unsigned got[SVM_BATCH];
          bool use[SVM_BATCH];
#pragma unroll
          for (int k = 0; k < SVM_BATCH; ++k) {
            const int j = j0 + k * slices;
            const int x = j < F ? f[j] : -1;
            use[k] = x >= 0 && x < levels;
            got[k] = (unsigned)__ldcg(
                lut_h + (min(j, F - 1) * levels + min(max(x, 0), levels - 1)) *
                            H);
          }
#pragma unroll
          for (int k = 0; k < SVM_BATCH; ++k) acc += use[k] ? got[k] : 0u;
        }
      }
      for (int off = hp; off < 32; off <<= 1)
        acc += __shfl_xor_sync(FULL, acc, off);
      if (sl == 0 && h < H)
        out_sums[(size_t)(b0 + p) * H + h] =
            in ? (int)(acc + (unsigned)__ldg(bias + (size_t)v * H + h)) : 0;
    }
  }

  // ---- walk + leaf lookup: GL lanes per (packet, tree) ----
  for (int base = warp * GPW; warp < WALK_WARPS && base < n_here * T;
       base += WALK_WARPS * GPW) {
    const int pt = base + gbase / GL;
    const bool pair = pt < n_here * T;
    const int p = pair ? pt / T : 0, t = pair ? pt % T : 0;
    const int b = b0 + p;
    unsigned code = pair ? (unsigned)codes[(size_t)b * T + t] : 0u;
    const int v = pair ? s_vid[p] : -1;
    const bool in = v >= 0 && v < V;
    code = acorn::walk_pair<GL>(
        code, s_feat + p * F, entries + ((size_t)(in ? v : 0) * L * T + t) * E,
        s_n + p * L * T + t, s_bit, L, T, E, glane, gbase);
    const size_t leaf = ((size_t)(in ? v : 0) * T + t) * P;
    const int label = acorn::leaf_label_group<GL>(
        pred_codes + leaf, pred_labels + leaf, P, code, glane, gbase);
    if (pair && glane == 0) {
      out_codes[(size_t)b * T + t] = (int)code;
      s_label[p * T + t] = in ? label : 0;
    }
  }

  __syncthreads();

  // ---- vote: a warp per packet, a lane per class, each score summed in
  // tree order as the twin sums it, the trees' weights passed by shuffle;
  // then a shuffle argmax (the higher score, ties to the smaller class) ----
  for (int p = warp; p < n_here; p += WARPS) {
    const int v = s_vid[p];
    const bool in = v >= 0 && v < V;
    const float* w = weights + (size_t)(in ? v : 0) * T;
    const int best_c = acorn::vote_warp(s_label + p * T, w,
                                        lane < T ? __ldg(w + lane) : 0.f, T,
                                        n_classes, lane);
    if (lane == 0) out_label[b0 + p] = in ? best_c : 0;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  The caller sizes PB (packets a block,
// kernels/classify_fused.py `packets_per_block`); the block's shared memory,
// PB * (F + T + 1 + L * T) + L ints, must stay within 48 KB.
extern "C" int acorn_classify_fused(
    const void* codes, const void* feats, const void* vid,
    const void* layer_shift, const void* entries, const void* n_entries,
    const void* pred_codes, const void* pred_labels, const void* weights,
    const void* lut_fh, const void* bias, void* out_codes, void* out_label,
    void* out_sums, int B, int F, int V, int L, int T, int E, int P, int H,
    int levels, int n_classes, int PB, void* stream) {
  const size_t smem =
      ((size_t)PB * (F + T + 1 + (size_t)L * T) + L) * sizeof(int);
  if (PB < 1 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int grid = (B + PB - 1) / PB;
  classify_fused_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)codes, (const int*)feats, (const int*)vid,
      (const int*)layer_shift, (const int4*)entries, (const int*)n_entries,
      (const unsigned*)pred_codes, (const int*)pred_labels,
      (const float*)weights, (const int*)lut_fh, (const int*)bias,
      (int*)out_codes, (int*)out_label, (int*)out_sums, B, F, V, L, T, E, P,
      H, levels, n_classes, PB);
  return (int)cudaGetLastError();
}
