// GQA decode attention for Hopper (sm_90a): one new token's query against a
// kv_len-masked KV cache (the LM decode step, once per layer).
//
// Replaces the Pallas TPU kernel `decode_attn_pallas`
// (src/repro/kernels/decode_attn.py:82, body `_kernel` :27).  Held to the
// plain torch version (src/repro_torch/kernels/ref.py, `decode_attn`) within
// float tolerance: the two differ only in summation order.
//
// out[b, h] = sum_s softmax_s(scale * q[b, h] . k[b, s, h / G]) v[b, s, h / G]
// over s < kv_len[b] (clamped to [0, S]), G = Hq / Hkv, softmax in float32,
// out in q's dtype.  A row with kv_len <= 0 gives zeros, as the TPU kernel
// does.
//
// What bounds it on this card: bytes.  Each K and V row up to kv_len is read
// once (268 MB for a step of internlm2-1.8b at B 16 and kv_len 4096)
// against 4 * G flops per element: below the H100's ~295 flops per byte
// even at granite-20b's G = 48 once the products run on tensor cores.
//
// What the design does about it:
//   * split-KV in one launch (flash-decoding).  A group is (sequence, KV
//     head, chunk of query rows); the cache range [0, S) is cut into
//     `n_split` spans of `split_len` rows, one block per (group, span), so
//     the grid fills the card even at B * Hkv = 32.  The wrapper chooses the
//     split (kernels/decode_attn.py, `plan`).  Each block writes its
//     partial softmax (m, l, acc) in f32 to a workspace; the last block of
//     a group to finish (an atomic counter behind __threadfence) merges the
//     partials in span order, writes the output and resets the counter, so
//     no memset and no second kernel run.  A span past kv_len contributes
//     m = -inf, l = 0.
//   * K/V tiles staged in shared memory by cp.async in a ring of 3 stages
//     (up to ~70 KB in flight per block, two blocks per SM at D 128), rows
//     past the span zero-filled, so the loads run ahead of the math.
//   * bf16: tensor cores (mma.sync m16n8k16, f32 accumulate).  A block
//     takes 16 query rows (a KV head's G rows padded with zeros; G above 16
//     in chunks of 16, whose blocks read the same K/V tiles, mostly from
//     L2), held by each warp as A fragments; the 4 warps split a tile's
//     keys, 16 at a time: S = Q K^T, the online softmax on the accumulator
//     fragments, then P V with P split into bf16 hi + lo parts (P = hi + lo
//     to ~2^-17), so the product keeps f32-like precision: bf16 P alone
//     misses one bf16 ulp of the output on short rows.
//   * mxu_native (the reference's `attn_mxu_native` decode lever,
//     src/repro/models/attention.py:134-147: bf16 operands, f32
//     accumulation, P cast to bf16): the same kernel with the lo part and
//     its second mma dropped (template flag MXU).  The reference rounds the
//     normalised softmax to bf16; this kernel rounds the online softmax's
//     unnormalised exp(s - m) and divides by the f32 row sum at the end, so
//     the two differ by bf16 rounding of P (2^-8 relative a term, either
//     way: kernels/decode_attn.py, `mxu_bound`).  In f32
//     the reference's casts are no-ops and the wrapper runs the f32 kernel
//     unchanged.
//   * f32: CUDA cores, a warp (half a warp at D 16) per key row, lanes over
//     D, up to 8 query rows a block, online softmax in registers.
//   * D 256 (recurrentgemma's heads), bf16: a warp's query fragments
//     (D / 16 x 4 registers) and accumulator (D / 8 x 4) would take 192
//     registers before anything else, so at D above 128 the block's 16 query
//     rows sit in shared memory after the ring (16 rows of D * 2 + PAD bytes,
//     rows 132 words apart: no bank conflicts) and each k-step loads its A
//     fragment from there; the accumulator stays in registers.
// The warps' partials, then the spans', merge in a fixed order, so a run is
// deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 3;      // cp.async ring depth
constexpr int PAD = 16;        // bytes after each staged row: no bank conflicts
constexpr int TILE_BF16 = 64;  // keys per stage
constexpr int TILE_F32 = 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = fill ? 16 : 0;   // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Where a block works: group (b, KV head h, query chunk c), its span
// [lo, hi) of cache rows (hi <= kv_len), and its query rows.
struct Work {
  int b, h, c, split, lo, hi, g0, rows;
};

__device__ __forceinline__ Work locate(const int* kv_len, int S, int Hkv,
                                       int G, int n_chunks, int qc,
                                       int split_len) {
  Work w;
  const int group = blockIdx.x;
  w.c = group % n_chunks;
  w.h = (group / n_chunks) % Hkv;
  w.b = group / (n_chunks * Hkv);
  w.split = blockIdx.y;
  const int n = min(max(kv_len[w.b], 0), S);
  w.lo = w.split * split_len;
  w.hi = min(w.lo + split_len, n);
  w.g0 = w.c * qc;
  w.rows = min(qc, G - w.g0);
  return w;
}

// Stage rows [base, base + TILE) of K and V (KV head h of sequence b) into
// one ring slot: [TILE][D] of K then [TILE][D] of V, each row followed by
// PAD bytes; rows at or past `hi` are zero-filled.
template <typename T, int D, int TILE>
__device__ __forceinline__ void load_tile(char* slot, const T* k, const T* v,
                                          const Work& w, int S, int Hkv,
                                          int base) {
  constexpr int ROW = D * sizeof(T);
  constexpr int CHUNKS = ROW / 16;
  constexpr int STRIDE = ROW + PAD;
  for (int i = threadIdx.x; i < 2 * TILE * CHUNKS; i += THREADS) {
    const int which = i / (TILE * CHUNKS);
    const int r = (i / CHUNKS) % TILE, ch = i % CHUNKS;
    const int s = base + r;
    const bool in = s < w.hi;
    const T* src = (which ? v : k) +
                   (((size_t)w.b * S + (in ? s : 0)) * Hkv + w.h) * D;
    cp_async16(slot + (which * TILE + r) * STRIDE + ch * 16,
               reinterpret_cast<const char*>(src) + ch * 16, in);
  }
}

// The block's partials -> its span's partial, and the output once every
// span of the group is in.  `pm`, `pl` [np][qc] and `pacc` [np][qc][D] (f32,
// shared memory) hold the warps' partials for the block's query rows; they
// merge in order k = 0..np-1.  With one span the block writes the output;
// else it writes its span's partial (m, l, acc) to `ws`, and the last block
// of the group to arrive merges the spans in order 0..n_split-1, writes the
// output and resets the group's counter for the next launch.  `scratch`
// (shared memory, 2 * n_split * rows + rows floats) may alias the partials.
template <typename T, int D>
__device__ void finish(const float* pm, const float* pl, const float* pacc,
                       int np, int qc, const Work& w, int Hq, int G,
                       int n_split, int ws_rows, float* ws, int* counters,
                       T* out, int* s_last, float* scratch) {
  const int group = blockIdx.x;
  T* o = out + ((size_t)w.b * Hq + (size_t)w.h * G + w.g0) * D;
  const size_t span = (size_t)ws_rows * (D + 4);   // acc, m, l, 16B rows
  float* mine = ws + ((size_t)group * n_split + w.split) * span;
  for (int i = threadIdx.x; i < w.rows * D; i += THREADS) {
    const int r = i / D, d = i % D;
    float M = -INFINITY;
    for (int k = 0; k < np; ++k) M = fmaxf(M, pm[k * qc + r]);
    float l = 0.f, a = 0.f;
    if (M != -INFINITY) {
      for (int k = 0; k < np; ++k) {
        const float mk = pm[k * qc + r];
        const float e = mk == -INFINITY ? 0.f : expf(mk - M);
        l += pl[k * qc + r] * e;
        a += pacc[((size_t)k * qc + r) * D + d] * e;
      }
    }
    if (n_split == 1) {
      o[(size_t)r * D + d] = from_float<T>(l > 0.f ? a / l : 0.f);
    } else {
      if (d == 0) {
        mine[(size_t)ws_rows * D + r] = M;
        mine[(size_t)ws_rows * (D + 1) + r] = l;
      }
      mine[(size_t)r * D + d] = a;
    }
  }
  if (n_split == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *s_last = atomicAdd(counters + group, 1) == n_split - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  // The spans' (m, l) per row into shared memory (the partials above are
  // spent), a warp per row with lanes over spans; then per row in span
  // order each span's weight exp(m_s - M) and the denominator; then the
  // outputs, each a sum over spans in order whose loads do not wait on one
  // another.
  const float* all = ws + (size_t)group * n_split * span;
  float* s_w = scratch;                   // [n_split][rows]: m, then weight
  float* s_l = scratch + n_split * w.rows;  // [n_split][rows]
  float* s_den = s_l + n_split * w.rows;    // [rows]
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < w.rows; r += WARPS) {
    float M = -INFINITY;
    for (int s = lane; s < n_split; s += 32) {
      const float* ps = all + s * span + (size_t)ws_rows * D;
      const float ms = __ldcg(ps + r);
      s_w[s * w.rows + r] = ms;
      s_l[s * w.rows + r] = __ldcg(ps + ws_rows + r);
      M = fmaxf(M, ms);
    }
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    __syncwarp();
    if (lane == 0) {
      float l = 0.f;
      for (int s = 0; s < n_split; ++s) {
        const float ms = s_w[s * w.rows + r];
        const float e = ms == -INFINITY ? 0.f : expf(ms - M);
        s_w[s * w.rows + r] = e;
        l += s_l[s * w.rows + r] * e;
      }
      s_den[r] = l;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < w.rows * (D / 4); i += THREADS) {
    const int r = i / (D / 4), d = i % (D / 4) * 4;
    const float* p = all + (size_t)r * D + d;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) {
      const float e = s_w[s * w.rows + r];
      const float4 x = __ldcg(reinterpret_cast<const float4*>(p + s * span));
      a[0] += e * x.x;
      a[1] += e * x.y;
      a[2] += e * x.z;
      a[3] += e * x.w;
    }
    const float l = s_den[r];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      o[(size_t)r * D + d + c] = from_float<T>(l > 0.f ? a[c] / l : 0.f);
  }
  if (threadIdx.x == 0) counters[group] = 0;
}

// The A fragment of k-step kk (columns kk * 16 ..) of the 16 query rows
// staged in shared memory at `qs`, rows `qstride` bytes apart.
__device__ __forceinline__ void q_frag(unsigned (&a)[4], const char* qs,
                                       int qstride, int kk, int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int col = kk * 16 + half * 8 + 2 * t;
    a[2 * half] = *reinterpret_cast<const unsigned*>(qs + g * qstride + col * 2);
    a[2 * half + 1] =
        *reinterpret_cast<const unsigned*>(qs + (g + 8) * qstride + col * 2);
  }
}

// bf16 on tensor cores: every warp holds the block's 16 query rows (in
// registers, or at D above 128 in shared memory); warp kg takes the 16-key
// chunks kg, kg + WARPS, ... of every tile.  MXU: P in bf16 alone (no lo
// part).
template <int D, bool MXU>
__global__ void __launch_bounds__(THREADS) attn_bf16(
    const __nv_bfloat16* __restrict__ q,  // [B, Hq, D]
    const __nv_bfloat16* __restrict__ k,  // [B, S, Hkv, D]
    const __nv_bfloat16* __restrict__ v,  // [B, S, Hkv, D]
    const int* __restrict__ kv_len,       // [B]
    __nv_bfloat16* __restrict__ out,      // [B, Hq, D]
    float* __restrict__ ws, int* __restrict__ counters, int S, int Hq,
    int Hkv, int n_chunks, int split_len, int n_split, int ws_rows,
    float scale) {
  constexpr int WK = WARPS, QC = 16, TILE = TILE_BF16;
  constexpr int STRIDE = D * 2 + PAD, SLOT = 2 * TILE * STRIDE;
  constexpr bool Q_SMEM = D > 128;
  extern __shared__ __align__(16) char smem[];
  __shared__ int s_last;
  const int G = Hq / Hkv;
  const Work w = locate(kv_len, S, Hkv, G, n_chunks, QC, split_len);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int kg = warp, g = lane / 4, t = lane % 4;
  const int r0 = g, r1 = g + 8;

  // A fragments of the warp's 16 query rows (rows past G are zeros): in
  // registers, or staged once in shared memory after the ring (read after
  // the tile loop's first barrier)
  unsigned qa[Q_SMEM ? 1 : D / 16][4];
  char* qs = smem + STAGES * SLOT;
  const __nv_bfloat16* qb = q + ((size_t)w.b * Hq + (size_t)w.h * G + w.g0) * D;
  if constexpr (Q_SMEM) {
    for (int i = threadIdx.x; i < QC * (D / 8); i += THREADS) {
      const int r = i / (D / 8), ch = i % (D / 8);
      const uint4 x = r < w.rows
                          ? *reinterpret_cast<const uint4*>(qb + r * D + ch * 8)
                          : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(qs + r * STRIDE + ch * 16) = x;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = kk * 16 + half * 8 + 2 * t;
        qa[kk][2 * half] =
            r0 < w.rows ? *reinterpret_cast<const unsigned*>(qb + r0 * D + col) : 0u;
        qa[kk][2 * half + 1] =
            r1 < w.rows ? *reinterpret_cast<const unsigned*>(qb + r1 * D + col) : 0u;
      }
    }
  }
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int n_tiles = w.hi > w.lo ? (w.hi - w.lo + TILE - 1) / TILE : 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles)
      load_tile<__nv_bfloat16, D, TILE>(smem + s * SLOT, k, v, w, S, Hkv,
                                        w.lo + s * TILE);
    cp_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();   // tile `it` landed; slot (it - 1) % STAGES is free
    const int nx = it + STAGES - 1;
    if (nx < n_tiles)
      load_tile<__nv_bfloat16, D, TILE>(smem + (nx % STAGES) * SLOT, k, v, w,
                                        S, Hkv, w.lo + nx * TILE);
    cp_commit();
    const char* ks = smem + (it % STAGES) * SLOT;
    const char* vs = ks + TILE * STRIDE;
    const int base = w.lo + it * TILE;
    for (int ch = kg; ch < TILE / 16; ch += WK) {
      const int key0 = ch * 16;
      // S = Q K^T for keys key0..key0+15: two n8 tiles
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned a[4];
        if constexpr (Q_SMEM) {
          q_frag(a, qs, STRIDE, kk, g, t);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const char* row = ks + (key0 + 8 * j + g) * STRIDE + (kk * 16 + 2 * t) * 2;
          mma_bf16(s[j], a, *reinterpret_cast<const unsigned*>(row),
                   *reinterpret_cast<const unsigned*>(row + 16));
        }
      }
      // online softmax; s[j][e] is row g (e < 2) or g + 8, key 8j + 2t + e % 2
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = base + key0 + 8 * j + 2 * t + (e & 1);
          const float x = key < w.hi ? s[j][e] * scale : -INFINITY;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        alpha[hr] = m[hr] == -INFINITY ? 0.f : expf(m[hr] - mx[hr]);
        m[hr] = mx[hr];
        l[hr] *= alpha[hr];
      }
      unsigned hi[4];
      [[maybe_unused]] unsigned lo[4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {   // pr: row g or g + 8
          float p[2], ph[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = s[j][2 * pr + e];
            p[e] = x == -INFINITY ? 0.f : expf(x - m[pr]);
            l[pr] += p[e];
            ph[e] = __bfloat162float(__float2bfloat16_rn(p[e]));
          }
          hi[2 * j + pr] = pack_bf16(ph[0], ph[1]);
          if constexpr (!MXU)
            lo[2 * j + pr] = pack_bf16(p[0] - ph[0], p[1] - ph[1]);
        }
      // acc = acc * alpha + P V over d tiles of 8
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        acc[nt][0] *= alpha[0];
        acc[nt][1] *= alpha[0];
        acc[nt][2] *= alpha[1];
        acc[nt][3] *= alpha[1];
        const char* col = vs + (nt * 8 + g) * 2;
        const unsigned short* u0 = reinterpret_cast<const unsigned short*>(
            col + (key0 + 2 * t) * STRIDE);
        const unsigned short* u1 = reinterpret_cast<const unsigned short*>(
            col + (key0 + 2 * t + 1) * STRIDE);
        const unsigned short* u2 = reinterpret_cast<const unsigned short*>(
            col + (key0 + 2 * t + 8) * STRIDE);
        const unsigned short* u3 = reinterpret_cast<const unsigned short*>(
            col + (key0 + 2 * t + 9) * STRIDE);
        const unsigned b0 = (unsigned)*u0 | ((unsigned)*u1 << 16);
        const unsigned b1 = (unsigned)*u2 | ((unsigned)*u3 << 16);
        mma_bf16(acc[nt], hi, b0, b1);
        if constexpr (!MXU) mma_bf16(acc[nt], lo, b0, b1);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();   // the ring's memory now holds the warps' partials

  float* pm = reinterpret_cast<float*>(smem);
  float* pl = pm + WK * QC;
  float* pacc = pl + WK * QC;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  {
    const int i0 = kg * QC + r0, i1 = kg * QC + r1;
    if (t == 0) {
      pm[i0] = m[0];
      pl[i0] = l[0];
      pm[i1] = m[1];
      pl[i1] = l[1];
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int d = nt * 8 + 2 * t;
      pacc[(size_t)i0 * D + d] = acc[nt][0];
      pacc[(size_t)i0 * D + d + 1] = acc[nt][1];
      pacc[(size_t)i1 * D + d] = acc[nt][2];
      pacc[(size_t)i1 * D + d + 1] = acc[nt][3];
    }
  }
  __syncthreads();
  finish<__nv_bfloat16, D>(pm, pl, pacc, WK, QC, w, Hq, G, n_split, ws_rows,
                           ws, counters, out, &s_last,
                           reinterpret_cast<float*>(smem));
}

// EPL consecutive elements as aligned vector loads (16 bytes at most each:
// a staged row of D 256 floats is 1040 bytes, 16- but not 32-byte aligned).
template <typename T, int EPL>
struct alignas(sizeof(T) * EPL < 16 ? sizeof(T) * EPL : 16) Pack {
  T x[EPL];
};

// f32 on CUDA cores: row group `grp` (a warp, or half a warp at D 16) takes
// keys grp, grp + GROUPS, ... of every tile, lanes over D; GC query rows.
template <int D, int GC>
__global__ void __launch_bounds__(THREADS) attn_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ kv_len,
    float* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ counters, int S, int Hq, int Hkv, int n_chunks,
    int split_len, int n_split, int ws_rows, float scale) {
  constexpr int EPL = D >= 32 ? D / 32 : 1;  // elements per lane
  constexpr int LPR = D / EPL;               // lanes per key row: 32 or 16
  constexpr int RPW = 32 / LPR;              // key rows a warp reads at once
  constexpr int GROUPS = WARPS * RPW;
  constexpr int TILE = TILE_F32;
  constexpr int STRIDE = D * 4 + PAD, SLOT = 2 * TILE * STRIDE;
  extern __shared__ __align__(16) char smem[];
  __shared__ int s_last;
  const int G = Hq / Hkv;
  const Work w = locate(kv_len, S, Hkv, G, n_chunks, GC, split_len);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = (lane % LPR) * EPL, grp = warp * RPW + lane / LPR;

  // this lane's slice of each query row, pre-scaled; rows past G are 0
  float qr[GC][EPL];
  const float* qb = q + ((size_t)w.b * Hq + (size_t)w.h * G + w.g0) * D;
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const Pack<float, EPL> pk =
        g < w.rows ? *reinterpret_cast<const Pack<float, EPL>*>(qb + g * D + col)
                   : Pack<float, EPL>{};
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = pk.x[e] * scale;
  }
  float m[GC], l[GC], acc[GC][EPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const int n_tiles = w.hi > w.lo ? (w.hi - w.lo + TILE - 1) / TILE : 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles)
      load_tile<float, D, TILE>(smem + s * SLOT, k, v, w, S, Hkv,
                                w.lo + s * TILE);
    cp_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int nx = it + STAGES - 1;
    if (nx < n_tiles)
      load_tile<float, D, TILE>(smem + (nx % STAGES) * SLOT, k, v, w, S, Hkv,
                                w.lo + nx * TILE);
    cp_commit();
    const char* ks = smem + (it % STAGES) * SLOT;
    const char* vs = ks + TILE * STRIDE;
    const int base = w.lo + it * TILE;
    // the trip count is uniform across the warp, so the shuffles see every
    // lane
    for (int r = grp; r < TILE; r += GROUPS) {
      const bool ok = base + r < w.hi;
      const Pack<float, EPL> kr =
          *reinterpret_cast<const Pack<float, EPL>*>(ks + r * STRIDE + col * 4);
      const Pack<float, EPL> vr =
          *reinterpret_cast<const Pack<float, EPL>*>(vs + r * STRIDE + col * 4);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) x += qr[g][e] * kr.x[e];
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        if (!ok) continue;
        if (x > m[g]) {  // a new max: rescale what came before
          const float a = expf(m[g] - x);
          l[g] = l[g] * a + 1.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * a + vr.x[e];
          m[g] = x;
        } else {
          const float p = expf(x - m[g]);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] += p * vr.x[e];
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  float* pm = reinterpret_cast<float*>(smem);
  float* pl = pm + GROUPS * GC;
  float* pacc = pl + GROUPS * GC;
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const int i = grp * GC + g;
    if (col == 0) {
      pm[i] = m[g];
      pl[i] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) pacc[(size_t)i * D + col + e] = acc[g][e];
  }
  __syncthreads();
  finish<float, D>(pm, pl, pacc, GROUPS, GC, w, Hq, G, n_split, ws_rows, ws,
                   counters, out, &s_last, reinterpret_cast<float*>(smem));
}

// Shared memory of a block: the K/V ring, reused for the warps' partials;
// in bf16 at D above 128 the query rows after it.
int smem_bytes(int D, int esize, int qc, int tile) {
  const int ring = STAGES * 2 * tile * (D * esize + PAD);
  const int parts = esize == 2 ? WARPS
                               : WARPS * (32 / (D / (D >= 32 ? D / 32 : 1)));
  const int q = esize == 2 && D > 128 ? qc * (D * esize + PAD) : 0;
  return (ring > parts * qc * (D + 2) * 4 ? ring : parts * qc * (D + 2) * 4) + q;
}

template <typename... P, typename... A>
cudaError_t go(void (*kern)(P...), int smem, dim3 grid, cudaStream_t st,
               A... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, THREADS, smem, st>>>(args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* kv_len, void* out, float* ws, int* counters,
                     int S, int Hq, int Hkv, int n_chunks, int split_len,
                     int n_split, int ws_rows, int bf16, int mxu, int qc,
                     int smem, dim3 grid, float scale, cudaStream_t st) {
  using B16 = __nv_bfloat16;
  if (bf16) {
    const B16 *q_ = (const B16*)q, *k_ = (const B16*)k, *v_ = (const B16*)v;
    B16* o_ = (B16*)out;
    if (qc != 16) return cudaErrorInvalidValue;
    return go(mxu ? attn_bf16<D, true> : attn_bf16<D, false>, smem, grid, st,
              q_, k_, v_, kv_len, o_, ws, counters, S, Hq, Hkv, n_chunks,
              split_len, n_split, ws_rows, scale);
  }
  const float *q_ = (const float*)q, *k_ = (const float*)k, *v_ = (const float*)v;
  float* o_ = (float*)out;
#define ATTN_F32(GC)                                                       \
  go(attn_f32<D, GC>, smem, grid, st, q_, k_, v_, kv_len, o_, ws, counters, \
     S, Hq, Hkv, n_chunks, split_len, n_split, ws_rows, scale)
  switch (qc) {
    case 1: return ATTN_F32(1);
    case 2: return ATTN_F32(2);
    case 4: return ATTN_F32(4);
    case 8: return ATTN_F32(8);
    default: return cudaErrorInvalidValue;
  }
#undef ATTN_F32
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q, k, v and out are bfloat16
// (bf16 = 1) or float32 (bf16 = 0), contiguous, 16-byte aligned; kv_len is
// int32 [B].  mxu_native = 1 (bf16 only) keeps P in bf16 alone.  The
// geometry comes from the wrapper (kernels/decode_attn.py, `plan`): `qc`
// query rows a block (16 in bf16; 1, 2, 4 or 8 in f32), `tile` keys a ring
// stage, `n_split` spans of `split_len` rows covering
// [0, S), `ws_rows` rows a span's partial holds in `ws` (f32,
// B * Hkv * ceil(G / qc) * n_split * ws_rows * (D + 4)), and `smem` bytes of
// dynamic shared memory; a geometry this file would not choose is refused.
// `counters` (int32, one per group) must be zero before the first launch;
// the kernel leaves them zero.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched); cudaErrorInvalidValue for a head dim
// other than 16, 32, 64, 128 or 256, Hq not a multiple of Hkv or a geometry
// mismatch.
extern "C" int acorn_decode_attn(const void* q, const void* k, const void* v,
                                 const void* kv_len, void* out, void* ws,
                                 void* counters, int B, int S, int Hq,
                                 int Hkv, int D, int bf16, int mxu_native,
                                 int qc, int tile,
                                 int n_split, int split_len, int ws_rows,
                                 int smem, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || qc <= 0 || n_split <= 0 ||
      (mxu_native && !bf16))
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const int n_chunks = (G + qc - 1) / qc;
  if (tile != (bf16 ? TILE_BF16 : TILE_F32) || split_len % tile != 0 ||
      (long long)n_split * split_len < S || ws_rows != (G < qc ? G : qc) ||
      smem != smem_bytes(D, bf16 ? 2 : 4, qc, tile) ||
      (2LL * n_split + 1) * ws_rows * 4 > smem)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B * Hkv * n_chunks, n_split);
  const cudaStream_t st = (cudaStream_t)stream;
  const int* n_ = (const int*)kv_len;
  float* ws_ = (float*)ws;
  int* c_ = (int*)counters;
  switch (D) {
    case 16: return (int)launch_d<16>(q, k, v, n_, out, ws_, c_, S, Hq, Hkv, n_chunks, split_len, n_split, ws_rows, bf16, mxu_native, qc, smem, grid, scale, st);
    case 32: return (int)launch_d<32>(q, k, v, n_, out, ws_, c_, S, Hq, Hkv, n_chunks, split_len, n_split, ws_rows, bf16, mxu_native, qc, smem, grid, scale, st);
    case 64: return (int)launch_d<64>(q, k, v, n_, out, ws_, c_, S, Hq, Hkv, n_chunks, split_len, n_split, ws_rows, bf16, mxu_native, qc, smem, grid, scale, st);
    case 128: return (int)launch_d<128>(q, k, v, n_, out, ws_, c_, S, Hq, Hkv, n_chunks, split_len, n_split, ws_rows, bf16, mxu_native, qc, smem, grid, scale, st);
    case 256: return (int)launch_d<256>(q, k, v, n_, out, ws_, c_, S, Hq, Hkv, n_chunks, split_len, n_split, ws_rows, bf16, mxu_native, qc, smem, grid, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
