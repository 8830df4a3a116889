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
// What bounds it on this card: latency, not bytes.  The bytes a walk needs
// (the records the packets visit up to each row's first hit, the row
// lengths, the packet I/O: ~1.3 MB at the zoo's B 4096) take ~0.4 us at
// 3.35 TB/s, and a zoo's records stay in the 50 MB L2.  The walk is a
// chain: layer l + 1 needs layer l's code, and a row's first match needs
// its records in order, so a (packet, tree) walked by one thread a record
// at a time waits one L1/L2 round trip per record.
//
// What the design does about it: the fused kernel's walk, alone.
//   * GL = 8 lanes walk one (packet, tree), 4 pairs a warp, with the
//     fused kernel's own device function (acorn::walk_pair): a round of GL
//     records a load, the first hit by ballot, the next layer's first
//     records loaded before this layer is compared, and layers empty for
//     every pair of the warp skipped by one ballot over the staged row
//     lengths (a decision tree's packet has most of its T x L rows empty);
//   * a block is 4 walking warps and stages its packets' feature rows, row
//     lengths (L x T ints a packet, 0 off the zoo) and the layers' bits in
//     shared memory once: (F + 1 + L T) ints a packet, 1268 bytes at the
//     paper's profile;
//   * PB packets a block, planned in kernels/tree_walk.py (`geometry`) so
//     that every lane group has a pair, the grid holds at least two blocks
//     an SM on 132 SMs and shared memory stays within 48 KB; the C entry
//     refuses any other PB.  At the zoo's B 4096: 2 packets a block, 2048
//     blocks of 128 threads.  The time is waves x block life, so the
//     registers a thread (chip_smoke.py prints them) set how many blocks
//     an SM holds.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 9, PERF.md):
// 0.021 ms at the zoo's B 4096, down from 0.048 for a thread a (packet,
// tree) walking a record at a time; 47 registers, so 10 blocks an SM and
// ~1.55 waves.  Capping the registers for 12 or 16 blocks an SM spilled
// and was slower, as were 8-warp and 2-warp blocks.

#include <cuda_runtime.h>

#include "acorn_device.cuh"

namespace {

constexpr int WARPS = 4;          // warps a block, all walking
constexpr int THREADS = 32 * WARPS;
constexpr int GL = 8;             // lanes that walk one (packet, tree)
constexpr int GPW = 32 / GL;      // (packet, tree) walks a warp
constexpr int GROUPS = WARPS * GPW;
constexpr int SMS = 132;          // H100 SXM
constexpr int WAVES = 2;          // the grid: at least two blocks an SM
constexpr int SMEM_INTS = 48 * 1024 / 4;   // static limit, no opt-in

__global__ void __launch_bounds__(THREADS) tree_walk_kernel(
    const int* __restrict__ codes,        // [B, T] uint32 bits
    const int* __restrict__ feats,        // [B, F]
    const int* __restrict__ vid,          // [B]
    const int* __restrict__ layer_shift,  // [L]
    const int4* __restrict__ entries,     // [V, L, T, E] records
    const int* __restrict__ n_entries,    // [V, L, T]
    int* __restrict__ out_codes,          // [B, T]
    int B, int F, int V, int L, int T, int E, int PB) {
  extern __shared__ int smem[];
  int* s_feat = smem;                // [PB, F]
  int* s_vid = s_feat + PB * F;      // [PB]
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

  // a group per (packet, tree) pair; more than GROUPS pairs loop.  A group
  // past the block's pairs walks its warp's first pair again, which adds
  // no layer and no round to the warp's walk
  for (int base = warp * GPW; base < n_here * T; base += GROUPS) {
    const int pt = base + gbase / GL;
    const bool pair = pt < n_here * T;
    const int p = (pair ? pt : base) / T, t = (pair ? pt : base) % T;
    const int b = b0 + p;
    unsigned code = (unsigned)codes[(size_t)b * T + t];
    const int v = s_vid[p];
    const bool in = v >= 0 && v < V;
    code = acorn::walk_pair<GL>(
        code, s_feat + p * F, entries + ((size_t)(in ? v : 0) * L * T + t) * E,
        s_n + p * L * T + t, s_bit, L, T, E, glane, gbase);
    if (pair && glane == 0) out_codes[(size_t)b * T + t] = (int)code;
  }
}

// Packets a block, as kernels/tree_walk.py `geometry` plans them; 0 if one
// packet's staged rows do not fit.
int packets(int B, int F, int L, int T) {
  const int cap = (SMEM_INTS - L) / (F + 1 + L * T);
  if (cap < 1) return 0;
  const int fill = (GROUPS + T - 1) / T;
  const int waves = B / (WAVES * SMS);
  const int pb = cap < fill ? cap : fill;
  return pb < waves ? pb : waves > 1 ? waves : 1;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  PB must be the packets a block that
// kernels/tree_walk.py `geometry` plans, else cudaErrorInvalidValue and
// nothing launches.
extern "C" int acorn_tree_walk(
    const void* codes, const void* feats, const void* vid,
    const void* layer_shift, const void* entries, const void* n_entries,
    void* out_codes, int B, int F, int V, int L, int T, int E, int PB,
    void* stream) {
  if (B < 1 || T < 1 || PB != packets(B, F, L, T))
    return (int)cudaErrorInvalidValue;
  const int grid = (B + PB - 1) / PB;
  const size_t smem = ((size_t)PB * (F + 1 + (size_t)L * T) + L) * sizeof(int);
  tree_walk_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)codes, (const int*)feats, (const int*)vid,
      (const int*)layer_shift, (const int4*)entries, (const int*)n_entries,
      (int*)out_codes, B, F, V, L, T, E, PB);
  return (int)cudaGetLastError();
}
