// Whole-classify kernel for Hopper (sm_90a): tree walk -> forest vote ->
// SVM LUT sums, one launch per classify; in its hop entry also the plane's
// epilogue (SVM predict and the result select), so one switch's classify
// step is one launch.
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
// The hop entry (acorn_classify_hop) is the plane's whole classify step
// (src/repro_torch/core/plane.py `_classify_impl`; its plain torch twin is
// ref.py `classify_epilogue` after `classify_fused_v`), bit for bit:
//   clamp  vid_ok = 0 <= vid < V; a packet outside is walked, voted and
//          summed against slot 0 (the out-of-range rule above never runs),
//          and its result is -1;
//   svm    acc = svm_acc + sums (handed to the next hop: the exec image's
//          bias is zero, so partial sums compose across hops); sign bit h =
//          (acc + svm_bias[v, h] >= 0) && svm_hvalid[v, h];
//          svm_result = svm_pred_enable[v] ? svm_pred_table[v, code] : -1;
//   select result = !vid_ok ? -1 : mid == mid_svm ? svm_result
//          : pred_enable[v] ? label : -1; rslt = REQUEST && result >= 0 ?
//          result : rslt; codes and svm_acc as computed for REQUEST packets
//          and as they came for every other type.
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
//   * the epilogue (hop entry, the template's HOP) rides on the warps that
//     already hold its inputs: the clamp where vids are staged; the SVM
//     warp, which holds a packet's H sums in its hyperplane lanes, adds the
//     handed-in acc and the source bias there, collects the sign code with
//     one ballot (lane h is bit h) and looks up the packet's SVM result
//     into shared memory; the vote warp, after the block's barrier, selects
//     between that and its own label and writes rslt; the walk writes each
//     code or passes it through.  A packet costs a handful of loads more and
//     the ~30 small torch launches of the select and predict are gone.
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
constexpr int MAX_HOP_H = 16;     // the hop's sign code indexes 2^H entries
constexpr int VID_OK = 1, IS_REQ = 2;   // a packet's flags in the hop entry

// The hop entry's further operands: the packets' other fields, read once,
// and the plane's source tables of the predict and the select, read in
// place (so slot writes between graph replays are what a replay reads).
struct Hop {
  const int* ptype;                       // [B]
  const int* mid;                         // [B]
  const int* rslt;                        // [B]
  const int* svm_acc;                     // [B, H] partial sums handed in
  const unsigned char* pred_enable;       // [V] bool
  const int* svm_bias;                    // [V, H] the source bias
  const unsigned char* svm_hvalid;        // [V, H] bool
  const int* svm_pred_table;              // [V, 2^H]
  const unsigned char* svm_pred_enable;   // [V] bool
  int* out_rslt;                          // [B]
  int mid_svm, request;                   // MID_SVM, PacketType.REQUEST
};

// The slot a packet's tables come from: the hop entry sends a vid outside
// the zoo to slot 0 (its result is forced to -1 later); the plain entry
// keeps it, and its out-of-range rule applies.
template <bool HOP>
__device__ __forceinline__ int slot_of(int v, int V) {
  return HOP && (v < 0 || v >= V) ? 0 : v;
}

// Shared memory a block takes: per packet its feature row, per-tree labels,
// slot, flags, SVM result and row lengths, beside each layer's bit.
size_t smem_bytes(int PB, int F, int T, int L) {
  return ((size_t)PB * (F + T + 3 + (size_t)L * T) + L) * sizeof(int);
}

template <bool HOP>
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
    int* __restrict__ out_label,          // [B] (not HOP)
    int* __restrict__ out_sums,           // [B, H]: sums; HOP the acc handed on
    int B, int F, int V, int L, int T, int E, int P, int H, int levels,
    int n_classes, int PB, Hop hop) {
  extern __shared__ int smem[];
  int* s_feat = smem;                // [PB, F]
  int* s_label = s_feat + PB * F;    // [PB, T] per-tree leaf labels
  int* s_vid = s_label + PB * T;     // [PB] the slot (slot_of)
  int* s_flag = s_vid + PB;          // [PB] HOP: VID_OK | IS_REQ
  int* s_svm = s_flag + PB;          // [PB] HOP: the packet's SVM result
  int* s_n = s_svm + PB;             // [PB, L, T] row lengths, 0 off the zoo
  unsigned* s_bit = (unsigned*)(s_n + PB * L * T);  // [L] each layer's bit
  const int b0 = blockIdx.x * PB;
  const int n_here = min(PB, B - b0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int glane = lane % GL, gbase = lane - glane;

  for (int i = threadIdx.x; i < n_here * F; i += THREADS)
    s_feat[i] = feats[(size_t)b0 * F + i];
  for (int i = threadIdx.x; i < n_here; i += THREADS) {
    const int v = vid[b0 + i];
    s_vid[i] = slot_of<HOP>(v, V);
    if constexpr (HOP)
      s_flag[i] = (v >= 0 && v < V ? VID_OK : 0) |
                  (hop.ptype[b0 + i] == hop.request ? IS_REQ : 0);
  }
  for (int i = threadIdx.x; i < n_here * L * T; i += THREADS) {
    const int v = slot_of<HOP>(vid[b0 + i / (L * T)], V);
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
  // and the leaves there.  In the hop entry lane h of slice 0 then hands on
  // acc + sums, tests its sign with the source bias, and one ballot makes
  // the sign code (H <= 16: one round of hyperplanes) ----
  const int hp = H > 16 ? 32 : H > 8 ? 16 : H > 4 ? 8 : H > 2 ? 4
                                                    : H > 1 ? 2 : 1;
  const int slices = 32 / hp;
  for (int p = 0; warp == WALK_WARPS && p < n_here; ++p) {
    const int v = s_vid[p];
    const bool in = v >= 0 && v < V;
    const int* f = s_feat + p * F;
    const size_t row = (size_t)(b0 + p) * H;
    unsigned sign_code = 0;
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
      const bool mine = sl == 0 && h < H;
      const unsigned sums =
          mine && in ? acc + (unsigned)__ldg(bias + (size_t)v * H + h) : 0u;
      if constexpr (!HOP) {
        if (mine) out_sums[row + h] = (int)sums;
      } else {
        bool sign = false;
        if (mine) {
          const unsigned acc_in = (unsigned)hop.svm_acc[row + h];
          const unsigned handed = acc_in + sums;
          const size_t vh = (size_t)v * H + h;
          sign = (int)(handed + (unsigned)__ldg(hop.svm_bias + vh)) >= 0 &&
                 __ldg(hop.svm_hvalid + vh);
          out_sums[row + h] = (int)((s_flag[p] & IS_REQ) ? handed : acc_in);
        }
        sign_code |= __ballot_sync(FULL, sign) << h0;   // lane h: bit h
      }
    }
    if (HOP && lane == 0)
      s_svm[p] = __ldg(hop.svm_pred_enable + v)
          ? __ldg(hop.svm_pred_table + ((size_t)v << H) + sign_code) : -1;
  }

  // ---- walk + leaf lookup: GL lanes per (packet, tree) ----
  for (int base = warp * GPW; warp < WALK_WARPS && base < n_here * T;
       base += WALK_WARPS * GPW) {
    const int pt = base + gbase / GL;
    const bool pair = pt < n_here * T;
    const int p = pair ? pt / T : 0, t = pair ? pt % T : 0;
    const int b = b0 + p;
    const unsigned code_in = pair ? (unsigned)codes[(size_t)b * T + t] : 0u;
    const int v = pair ? s_vid[p] : -1;
    const bool in = v >= 0 && v < V;
    const unsigned code = acorn::walk_pair<GL>(
        code_in, s_feat + p * F,
        entries + ((size_t)(in ? v : 0) * L * T + t) * E,
        s_n + p * L * T + t, s_bit, L, T, E, glane, gbase);
    const size_t leaf = ((size_t)(in ? v : 0) * T + t) * P;
    const int label = acorn::leaf_label_group<GL>(
        pred_codes + leaf, pred_labels + leaf, P, code, glane, gbase);
    if (pair && glane == 0) {
      out_codes[(size_t)b * T + t] =
          (int)(HOP && !(s_flag[p] & IS_REQ) ? code_in : code);
      s_label[p * T + t] = in ? label : 0;
    }
  }

  __syncthreads();

  // ---- vote: a warp per packet, a lane per class, each score summed in
  // tree order as the twin sums it, the trees' weights passed by shuffle;
  // then a shuffle argmax (the higher score, ties to the smaller class).
  // In the hop entry lane 0 then selects the packet's result and writes
  // rslt ----
  for (int p = warp; p < n_here; p += WARPS) {
    const int v = s_vid[p];
    const bool in = v >= 0 && v < V;
    const float* w = weights + (size_t)(in ? v : 0) * T;
    const int best_c = acorn::vote_warp(s_label + p * T, w,
                                        lane < T ? __ldg(w + lane) : 0.f, T,
                                        n_classes, lane);
    if (lane == 0) {
      const int b = b0 + p;
      if constexpr (!HOP) {
        out_label[b] = in ? best_c : 0;
      } else {
        const int flag = s_flag[p];
        const int result = !(flag & VID_OK)             ? -1
                           : hop.mid[b] == hop.mid_svm  ? s_svm[p]
                           : __ldg(hop.pred_enable + v) ? best_c
                                                        : -1;
        hop.out_rslt[b] =
            (flag & IS_REQ) && result >= 0 ? result : hop.rslt[b];
      }
    }
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each launches on `stream` and
// returns cudaGetLastError() (0 = launched).  The caller sizes PB (packets
// a block, kernels/classify_fused.py `packets_per_block`); the block's
// shared memory, PB * (F + T + 3 + L * T) + L ints, must stay within 48 KB.

// The kernel alone: codes, label and sums (the out-of-range rule above).
extern "C" int acorn_classify_fused(
    const void* codes, const void* feats, const void* vid,
    const void* layer_shift, const void* entries, const void* n_entries,
    const void* pred_codes, const void* pred_labels, const void* weights,
    const void* lut_fh, const void* bias, void* out_codes, void* out_label,
    void* out_sums, int B, int F, int V, int L, int T, int E, int P, int H,
    int levels, int n_classes, int PB, void* stream) {
  const size_t smem = smem_bytes(PB, F, T, L);
  if (PB < 1 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int grid = (B + PB - 1) / PB;
  classify_fused_kernel<false><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)codes, (const int*)feats, (const int*)vid,
      (const int*)layer_shift, (const int4*)entries, (const int*)n_entries,
      (const unsigned*)pred_codes, (const int*)pred_labels,
      (const float*)weights, (const int*)lut_fh, (const int*)bias,
      (int*)out_codes, (int*)out_label, (int*)out_sums, B, F, V, L, T, E, P,
      H, levels, n_classes, PB, Hop{});
  return (int)cudaGetLastError();
}

// One hop of the plane's classify step: the kernel and its epilogue,
// writing the hop's codes, svm_acc and rslt.  Refuses H above 16.
extern "C" int acorn_classify_hop(
    const void* codes, const void* feats, const void* vid, const void* ptype,
    const void* mid, const void* rslt, const void* svm_acc,
    const void* layer_shift, const void* entries, const void* n_entries,
    const void* pred_codes, const void* pred_labels, const void* weights,
    const void* lut_fh, const void* bias, const void* pred_enable,
    const void* svm_bias, const void* svm_hvalid, const void* svm_pred_table,
    const void* svm_pred_enable, void* out_codes, void* out_acc,
    void* out_rslt, int B, int F, int V, int L, int T, int E, int P, int H,
    int levels, int n_classes, int PB, int mid_svm, int request,
    void* stream) {
  const size_t smem = smem_bytes(PB, F, T, L);
  if (PB < 1 || smem > 48 * 1024 || H > MAX_HOP_H)
    return (int)cudaErrorInvalidValue;
  const Hop hop{(const int*)ptype, (const int*)mid, (const int*)rslt,
                (const int*)svm_acc, (const unsigned char*)pred_enable,
                (const int*)svm_bias, (const unsigned char*)svm_hvalid,
                (const int*)svm_pred_table,
                (const unsigned char*)svm_pred_enable, (int*)out_rslt,
                mid_svm, request};
  const int grid = (B + PB - 1) / PB;
  classify_fused_kernel<true><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)codes, (const int*)feats, (const int*)vid,
      (const int*)layer_shift, (const int4*)entries, (const int*)n_entries,
      (const unsigned*)pred_codes, (const int*)pred_labels,
      (const float*)weights, (const int*)lut_fh, (const int*)bias,
      (int*)out_codes, nullptr, (int*)out_acc, B, F, V, L, T, E, P, H,
      levels, n_classes, PB, hop);
  return (int)cudaGetLastError();
}
