// svm_mul LUT lookup + hyperplane sums kernel for Hopper (sm_90a) (stage 3
// of the staged classify).
//
// Replaces the Pallas TPU kernel `svm_lookup_pallas_v`
// (src/repro/kernels/svm_lookup.py:71, body `_kernel` :44).  Held bit for
// bit to the plain torch version (src/repro_torch/kernels/ref.py,
// `svm_lookup_v`).
//
// sums[b, h] = bias[v, h] + sum_f lut[v, h, f, feat[b, f]] with v = vid[b],
// in int32 wrapping mod 2^32.  A feature outside [0, levels) adds 0, as the
// TPU kernel's one-hot does; v outside [0, V) gives sums of 0.
//
// What bounds it on this card: bytes.  Each (packet, hyperplane) gathers F
// int32 LUT cells; the distinct cells a batch selects are at most
// V x H x F x levels x 4 B (2.9 MB for four versions at the paper's
// profile), which stay in L2, so HBM sees the feature rows, the sums and
// each selected cell about once.
//
// What the design does about it: the TPU kernel's f32 one-hot MXU
// contraction (exact only below 2^24 per chunk, then rounded) becomes a
// direct int32 gather with no rounding; a block stages PB feature rows in
// shared memory, and a thread per (packet, hyperplane) sums its row.

#include <cuda_runtime.h>

#include "acorn_device.cuh"

namespace {

__global__ void __launch_bounds__(256) svm_lookup_kernel(
    const int* __restrict__ feats,  // [B, F]
    const int* __restrict__ vid,    // [B]
    const int* __restrict__ lut,    // [V, H, F, levels]
    const int* __restrict__ bias,   // [V, H]
    int* __restrict__ out_sums,     // [B, H]
    int B, int F, int V, int H, int levels, int PB) {
  extern __shared__ int s_feat[];   // [PB, F]
  const int b0 = blockIdx.x * PB;
  const int n_here = min(PB, B - b0);

  for (int i = threadIdx.x; i < n_here * F; i += blockDim.x)
    s_feat[i] = feats[(size_t)b0 * F + i];
  __syncthreads();

  for (int i = threadIdx.x; i < n_here * H; i += blockDim.x) {
    const int p = i / H, h = i % H;
    const int b = b0 + p;
    const int v = vid[b];
    out_sums[(size_t)b * H + h] = (v >= 0 && v < V)
        ? acorn::svm_sum(s_feat + p * F, lut + ((size_t)v * H + h) * F * levels,
                         F, levels, __ldg(bias + (size_t)v * H + h))
        : 0;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  The caller sizes PB so that the block's
// shared memory (PB * F ints) fits in 48 KB.
extern "C" int acorn_svm_lookup(
    const void* feats, const void* vid, const void* lut, const void* bias,
    void* out_sums, int B, int F, int V, int H, int levels, int PB,
    void* stream) {
  const int grid = (B + PB - 1) / PB;
  const size_t smem = (size_t)PB * F * sizeof(int);
  svm_lookup_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const int*)feats, (const int*)vid, (const int*)lut, (const int*)bias,
      (int*)out_sums, B, F, V, H, levels, PB);
  return (int)cudaGetLastError();
}
