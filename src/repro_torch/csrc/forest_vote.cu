// dt_predict + multitree_voting kernel for Hopper (sm_90a): the leaf lookup
// of every tree and the weighted vote (stage 2 of the staged classify).
//
// Replaces the Pallas TPU kernel `forest_predict_vote_pallas_v`
// (src/repro/kernels/forest_vote.py:69, body `_kernel` :37).  Held bit for
// bit to the plain torch version (src/repro_torch/kernels/ref.py,
// `forest_predict_vote_v`).
//
// Per packet b with version v = vid[b]:
//   leaf  per tree t, the label of the leaf whose code equals codes[b, t]
//         among the sorted leaf codes of (v, t) (the lower bound in
//         unsigned order); a miss, or an invalid leaf, gives 0;
//   vote  class scores summed in f32 in tree order, argmax with ties to the
//         smaller class.
// v outside [0, V): label 0 and per-tree labels 0.
//
// What bounds it on this card: latency, and the card's floor per launch;
// not bytes.  The bytes it needs (the codes in, the labels out, the leaves
// found: ~0.3 MB at the zoo's B 4096) take ~0.1 us at 3.35 TB/s, below
// what any launch takes.  A (packet, tree)'s lookup is a chain: the
// version, then the search's rounds over the leaves (all in L2: 8 KB a
// tree at the paper's profile), then the label, then the vote.
//
// What the design does about it: the fused kernel's leaf lookup and vote,
// alone, with the fused kernel's own device functions.
//   * GL = 8 lanes search one (packet, tree) (acorn::leaf_label_group): a
//     GL-ary lower bound, 3 rounds of one load a lane at P 256, where a
//     binary search chains 8 loads;
//   * a warp votes for a packet, a lane per class (acorn::vote_warp): each
//     score summed in tree order with the weights passed by shuffle, then a
//     shuffle argmax.  A warp loads its first packet's weights before the
//     search, since they do not depend on the codes;
//   * PB packets a block of 4 warps, planned in kernels/forest_vote.py
//     (`geometry`) so that every lane group has a pair and the grid holds
//     at least two blocks an SM on 132 SMs; the C entry refuses any other
//     PB.  At the zoo's B 4096: 2 packets a block, 2048 blocks of 128
//     threads, one wave.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 9, PERF.md):
// 0.0065 ms at the zoo's B 4096, down from 0.0126 for a binary search a
// thread and a thread a packet's vote; ~2.2x the card's floor for an empty
// launch of the same grid.  8-warp and 2-warp blocks were no faster.

#include <cuda_runtime.h>

#include "acorn_device.cuh"

namespace {

constexpr int WARPS = 4;          // warps a block
constexpr int THREADS = 32 * WARPS;
constexpr int GL = 8;             // lanes that search one (packet, tree)
constexpr int GPW = 32 / GL;      // (packet, tree) searches a warp
constexpr int GROUPS = WARPS * GPW;
constexpr int SMS = 132;          // H100 SXM
constexpr int WAVES = 2;          // the grid: at least two blocks an SM
constexpr int SMEM_INTS = 48 * 1024 / 4;   // static limit, no opt-in

__global__ void __launch_bounds__(THREADS) forest_vote_kernel(
    const int* __restrict__ codes,            // [B, T] uint32 bits
    const int* __restrict__ vid,              // [B]
    const unsigned* __restrict__ pred_codes,  // [V, T, P] sorted
    const int* __restrict__ pred_labels,      // [V, T, P], 0 where invalid
    const float* __restrict__ weights,        // [V, T]
    int* __restrict__ out_label,              // [B]
    int* __restrict__ out_per_tree,           // [B, T]
    int B, int V, int T, int P, int n_classes, int PB) {
  extern __shared__ int s_label[];            // [PB, T]
  const int b0 = blockIdx.x * PB;
  const int n_here = min(PB, B - b0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int glane = lane % GL, gbase = lane - glane;

  // the warp's first packet's weights, before the search's rounds
  const int v0 = warp < n_here ? __ldg(vid + b0 + warp) : -1;
  const bool in0 = v0 >= 0 && v0 < V;
  const float w0 = in0 && lane < T ? __ldg(weights + (size_t)v0 * T + lane)
                                   : 0.f;

  // a group per (packet, tree) pair; more than GROUPS pairs loop.  A group
  // past the block's pairs searches its warp's first pair again
  for (int base = warp * GPW; base < n_here * T; base += GROUPS) {
    const int pt = base + gbase / GL;
    const bool pair = pt < n_here * T;
    const int p = (pair ? pt : base) / T, t = (pair ? pt : base) % T;
    const int b = b0 + p;
    const int v = __ldg(vid + b);
    const bool in = v >= 0 && v < V;
    const size_t leaf = ((size_t)(in ? v : 0) * T + t) * P;
    int label = acorn::leaf_label_group<GL>(
        pred_codes + leaf, pred_labels + leaf, P,
        (unsigned)__ldg(codes + (size_t)b * T + t), glane, gbase);
    if (pair && glane == 0) {
      label = in ? label : 0;
      out_per_tree[(size_t)b * T + t] = label;
      s_label[p * T + t] = label;
    }
  }
  __syncthreads();

  for (int p = warp; p < n_here; p += WARPS) {
    const int v = p == warp ? v0 : __ldg(vid + b0 + p);
    const bool in = v >= 0 && v < V;
    const float* w = weights + (size_t)(in ? v : 0) * T;
    const float w_first = p == warp ? w0 : lane < T ? __ldg(w + lane) : 0.f;
    const int best_c = acorn::vote_warp(s_label + p * T, w, w_first, T,
                                        n_classes, lane);
    if (lane == 0) out_label[b0 + p] = in ? best_c : 0;
  }
}

// Packets a block, as kernels/forest_vote.py `geometry` plans them; 0 if
// one packet's labels do not fit.
int packets(int B, int T) {
  const int cap = SMEM_INTS / T;
  if (cap < 1) return 0;
  const int fill = (GROUPS + T - 1) / T;
  const int waves = B / (WAVES * SMS);
  const int pb = cap < fill ? cap : fill;
  return pb < waves ? pb : waves > 1 ? waves : 1;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  The caller checks P >= 1; PB must be
// the packets a block that kernels/forest_vote.py `geometry` plans, else
// cudaErrorInvalidValue and nothing launches.
extern "C" int acorn_forest_vote(
    const void* codes, const void* vid, const void* pred_codes,
    const void* pred_labels, const void* weights, void* out_label,
    void* out_per_tree, int B, int V, int T, int P, int n_classes, int PB,
    void* stream) {
  if (B < 1 || T < 1 || P < 1 || PB != packets(B, T))
    return (int)cudaErrorInvalidValue;
  const int grid = (B + PB - 1) / PB;
  const size_t smem = (size_t)PB * T * sizeof(int);
  forest_vote_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)codes, (const int*)vid, (const unsigned*)pred_codes,
      (const int*)pred_labels, (const float*)weights, (int*)out_label,
      (int*)out_per_tree, B, V, T, P, n_classes, PB);
  return (int)cudaGetLastError();
}
