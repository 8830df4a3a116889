// A classify's request as a byte record: written on the host in one native
// pass, copied to the card, and expanded there into the flat batch the
// classify reads.
//
// Replaces no TPU kernel.  The JAX package hands its executable an int32
// batch; the port's bulk path used to write that batch on the host (every
// field, features widened to 4 bytes, codes and partial sums all zeros) and
// copy it whole: B * (6 + F + T + H) int32, 1.41 MB at B 4096, F 60, T 8,
// H 12.  The record carries what the caller gave and nothing else: the
// packet count, the per-packet VID and MID (int32) and the features as
// bytes, 0.28 MB at the same shape.  The kernel is the first node of the
// captured classify, so the batch the classify reads is built on the card.
//
// The record (kernels/request_record.py `record_layout`; every part starts
// on a 16-byte boundary):
//   [0, 4)            n, the packets of the request (n <= B)
//   [vid, vid + 4B)   int32 VID a packet
//   [mid, mid + 4B)   int32 MID a packet
//   [feats, + B*F)    uint8 features [B, F], zero past the caller's columns
// Rows n.. hold whatever an earlier call left: nothing reads them.
//
// expand_request writes the flat batch (core/packets.py `layout`: six header
// fields of B int32, then features [B, F], codes [B, T], svm_acc [B, H]),
// bit for bit what `write_request` and `Staging.zero_tail` write on the
// host: row b < n is packet id b, ptype REQUEST, its MID and VID, rslt -1,
// rid 0, its features widened, codes and sums 0; row b >= n is a zero
// (FORWARD) packet.  n is read from the record on the card, so one captured
// graph serves every request size of its bucket.  Its plain torch twin is
// kernels/request_record.py `expand_request_plain`.
//
// What bounds it on this card: bytes.  It writes the flat batch (1.41 MB at
// the shape above) and reads the record (0.28 MB): ~0.5 us at 3.35 TB/s,
// below a launch's own cost.  What the design does about it: a thread
// writes 16 consecutive elements of the flat batch as four 16-byte stores;
// with B a multiple of 16 (every bucket from 16 up) such a chunk lies in one
// field, so a VID or MID chunk is four 16-byte loads of the record and a
// feature chunk one 16-byte load of its bytes.  Smaller buckets take a
// scalar path, element by element.
//
// acorn_write_record is the host's half, plain C in the same library
// (ctypes releases the interpreter's lock around the call): it narrows the
// caller's int32 features into the record's bytes while it ORs them
// together, so one pass both copies and checks that every value lies in
// [0, 255]; it copies VIDs (checked against [0, max_versions)) and MIDs,
// each a scalar (step 0) or an array.  Its numpy twin is
// kernels/request_record.py `write_record_plain`.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int REQUEST = 1;      // core/packets.py PacketType.REQUEST
constexpr int CHUNK = 16;       // flat elements a thread
constexpr int THREADS = 128;

struct Record {
  const unsigned char* base;
  int vid, mid, feats;          // byte offsets of the parts
};

// Element g of the flat batch of B packets, F features a packet.
__device__ __forceinline__ int element(const Record& r, int n, long g, int B,
                                       int F) {
  if (g < 6L * B) {
    const int field = (int)(g / B), row = (int)(g - (long)field * B);
    if (row >= n) return 0;
    switch (field) {
      case 0: return row;
      case 1: return REQUEST;
      case 2: return reinterpret_cast<const int*>(r.base + r.mid)[row];
      case 3: return reinterpret_cast<const int*>(r.base + r.vid)[row];
      case 4: return -1;
      default: return 0;
    }
  }
  g -= 6L * B;
  if (g < (long)B * F)
    return g / F < n ? (int)r.base[r.feats + g] : 0;
  return 0;
}

__global__ void __launch_bounds__(THREADS)
expand_request_kernel(Record r, int* __restrict__ flat, int B, int F,
                      long total) {
  const int n = *reinterpret_cast<const int*>(r.base);
  const long g0 = ((long)blockIdx.x * THREADS + threadIdx.x) * CHUNK;
  if (g0 >= total) return;
  if (B % CHUNK) {              // a bucket below 16: one element at a time
    for (int j = 0; j < CHUNK && g0 + j < total; ++j)
      flat[g0 + j] = element(r, n, g0 + j, B, F);
    return;
  }
  int v[CHUNK];
  if (g0 < 6L * B) {            // a header field, rows row0 .. row0 + 15
    const int field = (int)(g0 / B), row0 = (int)(g0 - (long)field * B);
    if (field == 2 || field == 3) {
      const int4* src = reinterpret_cast<const int4*>(
                            r.base + (field == 2 ? r.mid : r.vid)) + row0 / 4;
#pragma unroll
      for (int q = 0; q < CHUNK / 4; ++q) {
        const int4 x = src[q];
        v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z;
        v[4 * q + 3] = x.w;
      }
    } else {
      const int c = field == 1 ? REQUEST : field == 4 ? -1 : 0;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) v[j] = field == 0 ? row0 + j : c;
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      if (row0 + j >= n) v[j] = 0;
  } else if (g0 < (6L + F) * B) {   // 16 feature bytes, widened
    const long i0 = g0 - 6L * B;
    const uint4 x = *reinterpret_cast<const uint4*>(r.base + r.feats + i0);
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
    int row = (int)(i0 / F), f = (int)(i0 - (long)row * F);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      v[j] = row < n ? (int)((w[j / 4] >> (8 * (j % 4))) & 0xFFu) : 0;
      if (++f == F) { f = 0; ++row; }
    }
  } else {                          // codes and svm_acc
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) v[j] = 0;
  }
  int4* dst = reinterpret_cast<int4*>(flat + g0);
#pragma unroll
  for (int q = 0; q < CHUNK / 4; ++q)
    dst[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

}  // namespace

// Plain C entry points, loaded with ctypes.

// Expand the record at `record` (on the card) into the flat batch at `flat`
// of B packets at widths (F, T, H), on `stream`; returns cudaGetLastError()
// (0 = launched).  Both pointers 16-byte aligned (the wrapper checks).
extern "C" int acorn_expand_request(const void* record, void* flat, int B,
                                    int F, int T, int H, int off_vid,
                                    int off_mid, int off_feats,
                                    void* stream) {
  const long total = (long)B * (6 + F + T + H);
  if (total == 0) return 0;
  const long chunks = (total + CHUNK - 1) / CHUNK;
  const int grid = (int)((chunks + THREADS - 1) / THREADS);
  const Record r{(const unsigned char*)record, off_vid, off_mid, off_feats};
  expand_request_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      r, (int*)flat, B, F, total);
  return (int)cudaGetLastError();
}

// Write a request of n packets, F of the record's Fmax features a packet,
// into the host record at `record`: n, VIDs and MIDs (element `i * step` of
// their arrays: step 0 repeats a scalar), the features narrowed to bytes
// and zero-extended to Fmax.  Returns 2 when a VID lies outside
// [0, max_versions) (max_versions < 0: no check), else 1 when a feature
// lies outside [0, 255] (the record is then not to be used), else 0.
extern "C" int acorn_write_record(const int32_t* feats, int n, int F,
                                  int Fmax, const int32_t* mid, int mid_step,
                                  const int32_t* vid, int vid_step,
                                  int max_versions, unsigned char* record,
                                  int off_vid, int off_mid, int off_feats) {
  std::memcpy(record, &n, sizeof n);
  int32_t* rv = reinterpret_cast<int32_t*>(record + off_vid);
  int32_t* rm = reinterpret_cast<int32_t*>(record + off_mid);
  uint32_t out_of_range = 0;
  for (long i = 0; i < n; ++i) {
    const int32_t v = vid[i * vid_step];
    rv[i] = v;
    rm[i] = mid[i * mid_step];
    out_of_range |= (uint32_t)v >= (uint32_t)max_versions;
  }
  if (max_versions >= 0 && out_of_range) return 2;
  unsigned char* rf = record + off_feats;
  uint32_t bits = 0;
  if (F == Fmax) {
    const long m = (long)n * F;
    for (long i = 0; i < m; ++i) {
      const uint32_t x = (uint32_t)feats[i];
      bits |= x;
      rf[i] = (unsigned char)x;
    }
  } else {
    for (long b = 0; b < n; ++b) {
      const int32_t* src = feats + b * F;
      unsigned char* dst = rf + b * Fmax;
      for (int f = 0; f < F; ++f) {
        const uint32_t x = (uint32_t)src[f];
        bits |= x;
        dst[f] = (unsigned char)x;
      }
      std::memset(dst + F, 0, Fmax - F);
    }
  }
  return (bits & ~0xFFu) ? 1 : 0;
}
