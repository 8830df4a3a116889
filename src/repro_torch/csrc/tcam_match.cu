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
// What bounds it on this card: latency, and the card's floor per launch;
// not bytes.  One layer's rows are ~16 KB a version at the paper's
// profile and the packet I/O B x (8 T + 4 F) bytes, ~0.4 us at 3.35 TB/s
// at the zoo's B 4096, below what any launch takes (`acorn_noop` below
// measures that floor).  A row's first match is a chain: a thread that
// reads one record at a time, and stops at the first hit, waits one L1/L2
// round trip per record.
//
// What the design does about it: GL = 8 lanes walk one (packet, tree)
// (acorn::walk_row_group): a round loads GL consecutive records with one
// coalesced load and finds the first hit by ballot, so a row costs one
// round trip per GL records; the first round is loaded beside the row
// length (read by one lane of the group) and each next round before the
// current one is tested.  The grid fills the card: PB = 32 / T packets a
// block of 256 threads (4 at the zoo's 8 trees), 1024 blocks at B 4096,
// ~62 of an SM's 64 warp slots (31 registers a thread).  Nothing is staged
// in shared memory: a packet's version, code and first records are loaded
// at once when its group starts, and the features a record names are read
// through L1 (the row is 240 bytes, shared by the packet's groups).
// Staging the feature rows first, as the first design did, put a block-wide
// barrier and a round trip before the walk: 0.0046 against 0.0038 ms at the
// zoo's B 4096 on an H100 (chip_smoke.py phase 9; PERF.md).  The geometry
// is planned in kernels/tcam_match.py (`geometry`); the C entry refuses
// any other.

#include <cuda_runtime.h>

#include "acorn_device.cuh"

namespace {

constexpr int GL = 8;             // lanes that walk one (packet, tree)
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / GL;
constexpr unsigned GMASK = (1u << GL) - 1;

__global__ void __launch_bounds__(THREADS, 8) tcam_match_kernel(
    const int* __restrict__ codes,        // [B, T] uint32 bits
    const int* __restrict__ feats,        // [B, F]
    const int* __restrict__ vid,          // [B]
    const int* __restrict__ layer_shift,  // [L]
    const int4* __restrict__ entries,     // [V, L, T, E] records
    const int* __restrict__ n_entries,    // [V, L, T]
    int* __restrict__ out_codes,          // [B, T]
    int B, int F, int V, int L, int T, int E, int layer, int PB) {
  const int b0 = blockIdx.x * PB;
  const int n_here = min(PB, B - b0);
  const int shift = __ldg(layer_shift + layer);
  const int lane = threadIdx.x % 32, glane = lane % GL;
  const unsigned gmask = GMASK << (lane - glane);
  // a group per (packet, tree) pair; more than GROUPS pairs (T > 32) loop
  for (int pt = threadIdx.x / GL; pt < n_here * T; pt += GROUPS) {
    const int p = pt / T, t = pt % T;
    const int b = b0 + p;
    unsigned code = (unsigned)__ldg(codes + (size_t)b * T + t);
    const int v = __ldg(vid + b);
    if (v >= 0 && v < V) {
      const size_t row = ((size_t)v * L + layer) * T + t;
      code = acorn::walk_row_group<GL>(code, feats + (size_t)b * F,
                                       entries + row * E, n_entries + row, E,
                                       shift, glane, gmask);
    }
    if (glane == 0) out_codes[(size_t)b * T + t] = (int)code;
  }
}

__global__ void acorn_noop_kernel() {}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  The caller checks 0 <= layer < L;
// PB must be the packets a block that kernels/tcam_match.py `geometry`
// plans (a group for each tree: GROUPS / T, at least 1), else
// cudaErrorInvalidValue and nothing launches.
extern "C" int acorn_tcam_match(
    const void* codes, const void* feats, const void* vid,
    const void* layer_shift, const void* entries, const void* n_entries,
    void* out_codes, int B, int F, int V, int L, int T, int E, int layer,
    int PB, void* stream) {
  if (T < 1 || PB != (T >= GROUPS ? 1 : GROUPS / T))
    return (int)cudaErrorInvalidValue;
  const int grid = (B + PB - 1) / PB;
  tcam_match_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)codes, (const int*)feats, (const int*)vid,
      (const int*)layer_shift, (const int4*)entries, (const int*)n_entries,
      (int*)out_codes, B, F, V, L, T, E, layer, PB);
  return (int)cudaGetLastError();
}

// An empty kernel of `blocks` blocks of `threads` threads: the card's floor
// for one launch of that shape, timed beside the kernels.
extern "C" int acorn_noop(int blocks, int threads, void* stream) {
  acorn_noop_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
