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
// What bounds it on this card: the gathers' sectors and their latency.  The
// bytes the sums need (each selected cell once, the features and the sums:
// ~3.3 MB at the zoo's B 4096) take ~1 us at 3.35 TB/s; the LUT (V x F x
// levels x H x 4 B, 2.9 MB for four versions at the paper's profile) stays
// in L2.  Read hyperplane by hyperplane from [V, H, F, levels], a packet's
// H products of one feature lie 61 KB apart: one 32-byte sector each, 720
// sectors a packet.
//
// What the design does about it:
//   * it gathers from the install-time copy with the hyperplanes innermost,
//     `lut_fh` [V, F, levels, H] (kernels/tiling.py), where a packet's H
//     products of one feature are H contiguous ints (48 bytes at H 12, two
//     sectors): ~6x fewer sectors;
//   * SG = 16 lanes sum one packet: QL lanes a cell, each gathering a quad
//     of 4 contiguous products (one 16-byte load when H % 4 == 0), and
//     SG / QL slices of the features (QL = 4 and 4 slices of 15 features
//     at H 12).  A lane keeps its quad's 4 running sums in registers, loads
//     its features and issues BATCH = 8 gathers (clamped to a valid cell; a
//     mask drops what the twin adds as 0) before adding any.  QL is a
//     template instance (1, 2, 4: H up to 4, 8, 16); the C entry refuses a
//     larger H.  A lane per quad, not per cell, puts ~8 cells in a warp's
//     load (8 cache lines) where a lane per cell put 32, and keeps 64
//     registers a thread where H sums a lane took 117: 0.0059 against
//     0.0094 ms at the zoo's B 4096 on an H100 (chip_smoke.py phase 9;
//     PERF.md);
//   * the slices' sums are merged with __shfl_xor_sync.  They are uint32
//     adds that wrap mod 2^32, associative and commutative, so the order of
//     the merge cannot change a bit: this is why the work may be split over
//     features (the vote's float sums could not be);
//   * 8 packets a block of 128 threads, 512 blocks at B 4096 over 132 SMs,
//     all resident at once; no shared memory.  The geometry is planned in
//     kernels/svm_lookup.py (`geometry`); the C entry refuses any other.

#include <cuda_runtime.h>

namespace {

constexpr int SG = 16;            // lanes that sum one packet
constexpr int THREADS = 128;
constexpr int PACKETS = THREADS / SG;
constexpr int MAX_H = 16;         // 4 quads of hyperplanes at most
constexpr int BATCH = 8;          // gathers a lane issues before adding
constexpr unsigned GMASK = (1u << SG) - 1;

// QL lanes a cell, each summing a quad of hyperplanes over a slice of the
// features.
template <int QL>
__global__ void __launch_bounds__(THREADS) svm_lookup_kernel(
    const int* __restrict__ feats,   // [B, F]
    const int* __restrict__ vid,     // [B]
    const int* __restrict__ lut_fh,  // [V, F, levels, H]
    const int* __restrict__ bias,    // [V, H]
    int* __restrict__ out_sums,      // [B, H]
    int B, int F, int V, int H, int levels) {
  constexpr int SLICES = SG / QL;
  const int lane = threadIdx.x % 32, glane = lane % SG;
  const unsigned gmask = GMASK << (lane - glane);
  const int q = glane % QL, sl = glane / QL;  // quad, feature slice
  const int b = blockIdx.x * PACKETS + threadIdx.x / SG;
  if (b >= B) return;               // the whole group: b is the group's
  const int v = __ldg(vid + b);
  const bool in = v >= 0 && v < V;
  const bool mine = 4 * q < H;      // a quad with hyperplanes in it
  unsigned acc[4] = {0u, 0u, 0u, 0u};
  if (in && mine) {
    const int* lut_q = lut_fh + (size_t)v * F * levels * H + 4 * q;
    const int* feat = feats + (size_t)b * F;
    for (int j0 = sl; j0 < F; j0 += BATCH * SLICES) {
      int x[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int j = j0 + k * SLICES;
        x[k] = j < F ? __ldg(feat + j) : -1;
      }
      unsigned got[BATCH][4];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int j = min(j0 + k * SLICES, F - 1);
        const int xc = min(max(x[k], 0), levels - 1);
        const int* cell = lut_q + ((size_t)j * levels + xc) * H;
        if (H % 4 == 0) {
          const int4 w = __ldg(reinterpret_cast<const int4*>(cell));
          got[k][0] = w.x;
          got[k][1] = w.y;
          got[k][2] = w.z;
          got[k][3] = w.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            got[k][i] = 4 * q + i < H ? (unsigned)__ldg(cell + i) : 0u;
        }
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const bool use = x[k] >= 0 && x[k] < levels;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += use ? got[k][i] : 0u;
      }
    }
  }
  // the slices' sums merged: uint32 adds, the same bits in any order
#pragma unroll
  for (int off = QL; off < SG; off <<= 1)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += __shfl_xor_sync(gmask, acc[i], off);
  if (sl == 0 && mine) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = 4 * q + i;
      if (h < H)
        out_sums[(size_t)b * H + h] =
            in ? (int)(acc[i] + (unsigned)__ldg(bias + (size_t)v * H + h))
               : 0;
    }
  }
}

template <int QL>
void launch(const void* feats, const void* vid, const void* lut_fh,
            const void* bias, void* out_sums, int B, int F, int V, int H,
            int levels, cudaStream_t stream) {
  svm_lookup_kernel<QL><<<(B + PACKETS - 1) / PACKETS, THREADS, 0, stream>>>(
      (const int*)feats, (const int*)vid, (const int*)lut_fh,
      (const int*)bias, (int*)out_sums, B, F, V, H, levels);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  PB must be the packets a block that
// kernels/svm_lookup.py `geometry` plans (PACKETS), 1 <= H <= MAX_H and
// levels >= 1, else cudaErrorInvalidValue and nothing launches.  With
// H % 4 == 0 the caller passes a 16-byte aligned `lut_fh`.
extern "C" int acorn_svm_lookup(
    const void* feats, const void* vid, const void* lut_fh, const void* bias,
    void* out_sums, int B, int F, int V, int H, int levels, int PB,
    void* stream) {
  if (PB != PACKETS || H < 1 || H > MAX_H || levels < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (H <= 4)
    launch<1>(feats, vid, lut_fh, bias, out_sums, B, F, V, H, levels, s);
  else if (H <= 8)
    launch<2>(feats, vid, lut_fh, bias, out_sums, B, F, V, H, levels, s);
  else
    launch<4>(feats, vid, lut_fh, bias, out_sums, B, F, V, H, levels, s);
  return (int)cudaGetLastError();
}
