// Multi-layer tree-walk kernel for Hopper (sm_90a): all L dt_layer lookups
// of every tree in one launch (stage 1 of the `unfused` classify).
//
// Replaces the Pallas TPU kernel `tree_walk_pallas_v`
// (src/repro/kernels/tree_walk.py:94, body `_kernel` :54).  Held bit for bit
// to the plain torch version (src/repro_torch/kernels/ref.py, `tree_walk_v`).
//
// Per packet b with version v = vid[b] and tree t: for l = 0..L-1 the FIRST
// entry of row (v, l, t) with (code & mask) == value and
// f_lo <= feat[b, fid] <= f_hi sets bit layer_shift[l] to its set_bit; no
// match leaves the code unchanged.  v outside [0, V): the codes pass through.
//
// What bounds it on this card: bytes.  Per (packet, tree) the walk reads the
// 16-byte records up to the first hit of each of the L rows; the compares
// are a few integer operations per record.  One version's walk records at
// the paper's profile are 32 x 8 x 128 x 16 B = 0.5 MB, so a zoo stays in
// the 50 MB L2 and HBM sees each touched record about once per launch.
//
// What the design does about it: the fused kernel's walk, alone.  A block
// takes PB packets and stages their feature rows in shared memory once (the
// TPU kernel's one-hot MXU feature select becomes a direct index); a thread
// per (packet, tree) walks with one read-only 16-byte load per record, stops
// at the first hit and at the row's last valid entry (`n_entries`), and
// indexes its own version's rows (no version grid, no masked merge).

#include <cuda_runtime.h>

#include "acorn_device.cuh"

namespace {

__global__ void __launch_bounds__(256) tree_walk_kernel(
    const int* __restrict__ codes,        // [B, T] uint32 bits
    const int* __restrict__ feats,        // [B, F]
    const int* __restrict__ vid,          // [B]
    const int* __restrict__ layer_shift,  // [L]
    const int4* __restrict__ entries,     // [V, L, T, E] records
    const int* __restrict__ n_entries,    // [V, L, T]
    int* __restrict__ out_codes,          // [B, T]
    int B, int F, int V, int L, int T, int E, int PB) {
  extern __shared__ int s_feat[];         // [PB, F]
  const int b0 = blockIdx.x * PB;
  const int n_here = min(PB, B - b0);

  for (int i = threadIdx.x; i < n_here * F; i += blockDim.x)
    s_feat[i] = feats[(size_t)b0 * F + i];
  __syncthreads();

  if (threadIdx.x < n_here * T) {
    const int p = threadIdx.x / T, t = threadIdx.x % T;
    const int b = b0 + p;
    unsigned code = (unsigned)codes[(size_t)b * T + t];
    const int v = vid[b];
    if (v >= 0 && v < V) {
      const int* f = s_feat + p * F;
      for (int l = 0; l < L; ++l) {
        const size_t row = ((size_t)v * L + l) * T + t;
        code = acorn::walk_row(code, f, entries + row * E,
                               __ldg(n_entries + row),
                               __ldg(layer_shift + l));
      }
    }
    out_codes[(size_t)b * T + t] = (int)code;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  The caller sizes PB so that the block
// (PB * T threads, at most 256) and its shared memory (PB * F ints, at most
// 48 KB) fit.
extern "C" int acorn_tree_walk(
    const void* codes, const void* feats, const void* vid,
    const void* layer_shift, const void* entries, const void* n_entries,
    void* out_codes, int B, int F, int V, int L, int T, int E, int PB,
    void* stream) {
  const int grid = (B + PB - 1) / PB;
  const size_t smem = (size_t)PB * F * sizeof(int);
  tree_walk_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const int*)codes, (const int*)feats, (const int*)vid,
      (const int*)layer_shift, (const int4*)entries, (const int*)n_entries,
      (int*)out_codes, B, F, V, L, T, E, PB);
  return (int)cudaGetLastError();
}
