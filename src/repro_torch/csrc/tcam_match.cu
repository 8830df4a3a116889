// One-layer ternary (TCAM) match kernel for Hopper (sm_90a): one dt_layer
// lookup of every tree; the `layerwise` classify launches it once per layer.
//
// Replaces the Pallas TPU kernel `tcam_match_pallas_v`
// (src/repro/kernels/tcam_match.py:81, body `_kernel` :52).  Held bit for
// bit to the plain torch version (src/repro_torch/kernels/ref.py,
// `tcam_match_v`).
//
// Per packet b with version v = vid[b] and tree t: the FIRST entry of row
// (v, layer, t) with (code & mask) == value and f_lo <= feat[b, fid] <= f_hi
// sets bit layer_shift[layer] to its set_bit; no match leaves the code
// unchanged.  v outside [0, V): the codes pass through.
//
// It reads layer `layer` of the whole [V, L, T, E] record tensor the plane
// installs, so the layerwise walk makes no per-layer copy, and it reads the
// shift from `layer_shift` on the device, so the host never waits for it.
//
// What bounds it on this card: bytes, and at B = 4096 launch latency as
// much: one layer's rows are 1/L of the walk's records, about 16 KB per
// version at the paper's profile, against B x (8 T + 4 F) bytes of packet
// I/O that every one of the L launches moves again.
//
// What the design does about it: the tree walk's layout, one layer deep.  A
// block stages PB feature rows in shared memory; a thread per (packet,
// tree) reads its row's 16-byte records up to the first hit and the row's
// last valid entry (`n_entries`).

#include <cuda_runtime.h>

#include "acorn_device.cuh"

namespace {

__global__ void __launch_bounds__(256) tcam_match_kernel(
    const int* __restrict__ codes,        // [B, T] uint32 bits
    const int* __restrict__ feats,        // [B, F]
    const int* __restrict__ vid,          // [B]
    const int* __restrict__ layer_shift,  // [L]
    const int4* __restrict__ entries,     // [V, L, T, E] records
    const int* __restrict__ n_entries,    // [V, L, T]
    int* __restrict__ out_codes,          // [B, T]
    int B, int F, int V, int L, int T, int E, int layer, int PB) {
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
      const size_t row = ((size_t)v * L + layer) * T + t;
      code = acorn::walk_row(code, s_feat + p * F, entries + row * E,
                             __ldg(n_entries + row),
                             __ldg(layer_shift + layer));
    }
    out_codes[(size_t)b * T + t] = (int)code;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  The caller checks 0 <= layer < L and
// sizes PB so that the block (PB * T threads, at most 256) and its shared
// memory (PB * F ints, at most 48 KB) fit.
extern "C" int acorn_tcam_match(
    const void* codes, const void* feats, const void* vid,
    const void* layer_shift, const void* entries, const void* n_entries,
    void* out_codes, int B, int F, int V, int L, int T, int E, int layer,
    int PB, void* stream) {
  const int grid = (B + PB - 1) / PB;
  const size_t smem = (size_t)PB * F * sizeof(int);
  tcam_match_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const int*)codes, (const int*)feats, (const int*)vid,
      (const int*)layer_shift, (const int4*)entries, (const int*)n_entries,
      (int*)out_codes, B, F, V, L, T, E, layer, PB);
  return (int)cudaGetLastError();
}
