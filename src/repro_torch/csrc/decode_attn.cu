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
// once (2 * kv_len * Hkv * D elements per sequence, 268 MB for a step of
// internlm2-1.8b at B 16 and kv_len 4096) against 4 * G flops per element,
// far below the H100's ~295 flops per byte of balance.
//
// What the design does about it: one block per (sequence, KV head, chunk of
// up to 8 of the G query rows), so each KV row is read by one block only
// (twice or more only when G > 8).  A warp reads a row with 8- or 16-byte
// loads per lane (D / 32 elements each, or half a warp per row when
// D = 16), keeps 4 rows of K and V in flight, and runs an online softmax
// (running max, denominator and float32 accumulator per query row) in
// registers; rows past kv_len are never read and the cache is never padded.
// The block's row groups merge their partial softmaxes in shared memory at
// the end.  Not done here (later work): splitting S across blocks when
// B * Hkv is below the SM count (flash-decoding's second pass), and
// tensor-core mma for large G.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;   // KV rows in flight per row group

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// EPL consecutive elements as one aligned vector load.
template <typename T, int EPL>
struct alignas(sizeof(T) * EPL) Pack {
  T x[EPL];
};

template <typename T, int EPL>
__device__ __forceinline__ void load(const T* __restrict__ p,
                                     float (&out)[EPL]) {
  const Pack<T, EPL> pk = *reinterpret_cast<const Pack<T, EPL>*>(p);
#pragma unroll
  for (int e = 0; e < EPL; ++e) out[e] = to_float(pk.x[e]);
}

template <typename T, int D, int GC>
__global__ void __launch_bounds__(THREADS) decode_attn_kernel(
    const T* __restrict__ q,         // [B, Hq, D]
    const T* __restrict__ k,         // [B, S, Hkv, D]
    const T* __restrict__ v,         // [B, S, Hkv, D]
    const int* __restrict__ kv_len,  // [B]
    T* __restrict__ out,             // [B, Hq, D]
    int S, int Hq, int Hkv, float scale) {
  constexpr int EPL = D >= 32 ? D / 32 : 1;  // elements per lane
  constexpr int LPR = D / EPL;               // lanes per KV row: 32 or 16
  constexpr int RPW = 32 / LPR;              // rows a warp reads at once
  constexpr int GROUPS = WARPS * RPW;        // row groups of the block

  __shared__ float s_m[GROUPS][GC];
  __shared__ float s_l[GROUPS][GC];
  __shared__ float s_acc[GROUPS][GC][D];

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const int g0 = blockIdx.y * GC;
  const int ng = min(GC, G - g0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sub = lane / LPR, col = (lane % LPR) * EPL;
  const int group = warp * RPW + sub;
  const int n = min(max(kv_len[b], 0), S);

  // this lane's slice of each query row, pre-scaled; rows past G are 0
  float qr[GC][EPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g < ng) {
      load<T, EPL>(q + ((size_t)b * Hq + (size_t)h * G + g0 + g) * D + col,
                   qr[g]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] = 0.f;
    }
  }
  float m[GC], l[GC], acc[GC][EPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const size_t row = (size_t)Hkv * D;
  const T* kb = k + ((size_t)b * S * Hkv + h) * D + col;
  const T* vb = v + ((size_t)b * S * Hkv + h) * D + col;
  // row group `group` takes rows group, group + GROUPS, ...; the loop bound
  // is uniform across the warp, so the shuffles below see every lane
  for (int base = warp * RPW; base < n; base += GROUPS * UNROLL) {
    float kr[UNROLL][EPL], vr[UNROLL][EPL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = base + u * GROUPS + sub;
      ok[u] = s < n;
      if (ok[u]) {
        load<T, EPL>(kb + s * row, kr[u]);
        load<T, EPL>(vb + s * row, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) x += qr[g][e] * kr[u][e];
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        if (ok[u]) {
          if (x > m[g]) {  // a new max: rescale what came before
            const float a = expf(m[g] - x);
            l[g] = l[g] * a + 1.f;
#pragma unroll
            for (int e = 0; e < EPL; ++e)
              acc[g][e] = acc[g][e] * a + vr[u][e];
            m[g] = x;
          } else {
            const float p = expf(x - m[g]);
            l[g] += p;
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[g][e] += p * vr[u][e];
          }
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (col == 0) {
      s_m[group][g] = m[g];
      s_l[group][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) s_acc[group][g][col + e] = acc[g][e];
  }
  __syncthreads();

  // merge the row groups' partial softmaxes
  for (int i = threadIdx.x; i < ng * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
    for (int r = 0; r < GROUPS; ++r) mx = fmaxf(mx, s_m[r][g]);
    float o = 0.f;
    if (mx != -INFINITY) {
      float den = 0.f, num = 0.f;
      for (int r = 0; r < GROUPS; ++r) {
        const float w = expf(s_m[r][g] - mx);
        den += s_l[r][g] * w;
        num += s_acc[r][g][d] * w;
      }
      o = num / den;
    }
    out[((size_t)b * Hq + (size_t)h * G + g0 + g) * D + d] = from_float<T>(o);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* kv_len, void* out, int S, int Hq, int Hkv,
                     int gc, dim3 grid, float scale, cudaStream_t stream) {
  const T* q_ = (const T*)q;
  const T* k_ = (const T*)k;
  const T* v_ = (const T*)v;
  const int* n_ = (const int*)kv_len;
  T* o_ = (T*)out;
  switch (gc) {
    case 1:
      decode_attn_kernel<T, D, 1><<<grid, THREADS, 0, stream>>>(
          q_, k_, v_, n_, o_, S, Hq, Hkv, scale);
      break;
    case 2:
      decode_attn_kernel<T, D, 2><<<grid, THREADS, 0, stream>>>(
          q_, k_, v_, n_, o_, S, Hq, Hkv, scale);
      break;
    case 4:
      decode_attn_kernel<T, D, 4><<<grid, THREADS, 0, stream>>>(
          q_, k_, v_, n_, o_, S, Hq, Hkv, scale);
      break;
    case 8:
      decode_attn_kernel<T, D, 8><<<grid, THREADS, 0, stream>>>(
          q_, k_, v_, n_, o_, S, Hq, Hkv, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const void* kv_len, void* out, int S, int Hq, int Hkv,
                     int D, int gc, dim3 grid, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k, v, kv_len, out, S, Hq, Hkv, gc, grid,
                             scale, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, kv_len, out, S, Hq, Hkv, gc, grid,
                             scale, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, kv_len, out, S, Hq, Hkv, gc, grid,
                             scale, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, kv_len, out, S, Hq, Hkv, gc, grid,
                              scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q, k, v and out are bfloat16
// (bf16 = 1) or float32 (bf16 = 0), contiguous, 16-byte aligned; kv_len is
// int32 [B].  Launches on `stream` and returns cudaGetLastError() (0 =
// launched); cudaErrorInvalidValue for a head dim other than 16, 32, 64 or
// 128 or Hq not a multiple of Hkv.
extern "C" int acorn_decode_attn(const void* q, const void* k, const void* v,
                                 const void* kv_len, void* out, int B, int S,
                                 int Hq, int Hkv, int D, int bf16,
                                 float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const int gc = G > 4 ? 8 : G > 2 ? 4 : G;  // query rows per block
  const dim3 grid(B * Hkv, (G + gc - 1) / gc);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(bf16 ? launch_t<__nv_bfloat16>(q, k, v, kv_len, out, S, Hq,
                                               Hkv, D, gc, grid, scale, st)
                    : launch_t<float>(q, k, v, kv_len, out, S, Hq, Hkv, D,
                                      gc, grid, scale, st));
}
