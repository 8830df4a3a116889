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
//         among the sorted leaf codes of (v, t) (lower-bound binary search
//         in unsigned order); a miss, or an invalid leaf, gives 0;
//   vote  class scores summed in f32 in tree order, argmax with ties to the
//         smaller class.
// v outside [0, V): label 0 and per-tree labels 0.
//
// What bounds it on this card: bytes, the codes in and the labels out.  The
// search touches log2(P) leaf codes per (packet, tree), all in L2 (a
// version's leaves are 8 KB per tree at the paper's profile); the vote is
// T x n_classes compares per packet.
//
// What the design does about it: the TPU kernel's [B, T, P] compare-reduce
// becomes a binary search per (packet, tree) thread, the per-tree labels
// stay in shared memory, and one thread per packet votes from there.

#include <cuda_runtime.h>

#include "acorn_device.cuh"

namespace {

__global__ void __launch_bounds__(256) forest_vote_kernel(
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

  if (threadIdx.x < n_here * T) {
    const int p = threadIdx.x / T, t = threadIdx.x % T;
    const int b = b0 + p;
    const int v = vid[b];
    int label = 0;
    if (v >= 0 && v < V) {
      const size_t leaf = ((size_t)v * T + t) * P;
      label = acorn::leaf_label(pred_codes + leaf, pred_labels + leaf, P,
                                (unsigned)codes[(size_t)b * T + t]);
    }
    out_per_tree[(size_t)b * T + t] = label;
    s_label[p * T + t] = label;
  }
  __syncthreads();

  if (threadIdx.x < n_here) {
    const int b = b0 + threadIdx.x;
    const int v = vid[b];
    out_label[b] = (v >= 0 && v < V)
        ? acorn::vote(s_label + threadIdx.x * T, weights + (size_t)v * T, T,
                      n_classes)
        : 0;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  The caller checks P >= 1 and sizes PB
// so that the block (PB * T threads) fits in 256.
extern "C" int acorn_forest_vote(
    const void* codes, const void* vid, const void* pred_codes,
    const void* pred_labels, const void* weights, void* out_label,
    void* out_per_tree, int B, int V, int T, int P, int n_classes, int PB,
    void* stream) {
  const int grid = (B + PB - 1) / PB;
  const size_t smem = (size_t)PB * T * sizeof(int);
  forest_vote_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const int*)codes, (const int*)vid, (const unsigned*)pred_codes,
      (const int*)pred_labels, (const float*)weights, (int*)out_label,
      (int*)out_per_tree, B, V, T, P, n_classes, PB);
  return (int)cudaGetLastError();
}
