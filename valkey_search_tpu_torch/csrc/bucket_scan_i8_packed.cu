// K1: packed int8 coarse scan for Hopper (sm_90a): exact int8 dot products
// with the bucketed-min selection fused into the epilogue.
//
// Replaces the TPU kernel valkey_search_tpu/ops/pallas_scan.py
// bucket_min_scan_i8_packed, both of its bodies: _kernel_i8_packed_fused
// (pre_shift == 0) and _kernel_i8_packed (pre_shift > 0). The output is
// bit-identical to theirs. For corpus row r of survivor group
// g (span * 16384 rows), chunk m = (r - g * span * 16384) / 128 and lane
// l = r % 128:
//     key(r) = (((bias[r] - <q, c_r>) >> pre_shift) << chunk_bits) | m
// and out[q, g * 128 + l] = min over m of key(r). The bias carries +DOTMAX,
// so every score is >= 0 and keys order as plain ints; excluded rows carry
// SENTINEL. Rows at or past n_rows (the caller's padding up to n) score as
// zero vectors, exactly as the zero-padded corpus of the JAX package does.
// The fused TPU body computes bias_c - (dot << chunk_bits) with the chunk
// pre-folded into the bias; for pre_shift == 0 that is the same number, so
// one template (kShift) serves both.
//
// What bounds it on the card: integer issue. At the main path's 1M x 128
// corpus and B = 1024 queries the scan is 134 G int8 multiply-adds, i.e.
// 34 G dp4a instructions; the corpus is 128 MiB and every byte loaded feeds
// kTileQ = 32 queries, so device-memory traffic (~4 GB per 1024 queries) is
// far below the card's bandwidth and the dp4a issue rate is the limit. The
// design keeps a 32-query tile in shared memory (read as broadcasts, one
// 16-byte load per four dp4a), one corpus row per thread in 16-byte loads,
// and the running min keys in registers. A block folds a 64-chunk slice of
// one group; slices of the same group merge with atomicMin on the int32
// keys (order-free, so still exact), which spreads even span 8's eight
// groups per million rows over every SM. The tensor cores (s8 wgmma) and
// TMA staging are later work and leave this output contract unchanged.
//
// K3, the second entry point (bucket_scan_i8), replaces the TPU kernel
// valkey_search_tpu/ops/pallas_scan.py bucket_min_scan_i8 (body
// _kernel_i8). It runs the same
// scan at span 1 and chunk_bits 7, but its bias carries no +DOTMAX, so
// scores range over [-DOTMAX, SENTINEL + DOTMAX]. The same template serves:
// its min is a signed int32 min from INT32_MAX, `>> pre_shift` an arithmetic
// shift (floor), and the shift into the key is done on uint32, which gives
// the two's-complement bits of the TPU kernel without C++'s undefined shift
// of a negative int. A decode pass then writes, per survivor column c of
// group g and lane l, vals = ((best >> 7) << pre_shift) as f32 and
// idx = g * 16384 + (best & 127) * 128 + l, as K2's does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBucket = 128;          // lanes = survivor columns per group
constexpr int kChunksPerUnit = 128;   // 16384 rows = 128 chunks of 128 rows
constexpr int kTileQ = 32;            // queries per block
constexpr int kChunksPerBlock = 64;   // chunk slice folded by one block
constexpr int kMaxSmem = 232448;      // per-block shared memory on sm_90

__global__ void fill_int32_max(int32_t* __restrict__ p, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    p[i] = INT32_MAX;
  }
}

template <bool kShift>
__global__ void __launch_bounds__(kBucket)
scan_i8_packed(const int8_t* __restrict__ q, const int8_t* __restrict__ c,
               const int32_t* __restrict__ bias, int32_t* __restrict__ out,
               int b, int d, long long n_rows, int span, int pre_shift,
               int chunk_bits, long long n_out) {
  extern __shared__ int4 q_tile[];  // [kTileQ][d / 16]
  const int lane = threadIdx.x;
  const int dv = d >> 4;
  const int q0 = blockIdx.y * kTileQ;
  const int splits = span * kChunksPerUnit / kChunksPerBlock;
  const long long g = blockIdx.x / splits;
  const int m0 = (blockIdx.x % splits) * kChunksPerBlock;

  for (int i = lane; i < kTileQ * dv; i += kBucket) {
    const int t = i / dv;
    int4 v = make_int4(0, 0, 0, 0);
    if (q0 + t < b) {
      v = reinterpret_cast<const int4*>(q + (long long)(q0 + t) * d)[i - t * dv];
    }
    q_tile[i] = v;
  }
  __syncthreads();

  int32_t best[kTileQ];
#pragma unroll
  for (int t = 0; t < kTileQ; ++t) best[t] = INT32_MAX;

  const long long row0 = g * span * kChunksPerUnit * kBucket + lane;
  for (int m = m0; m < m0 + kChunksPerBlock; ++m) {
    const long long row = row0 + (long long)m * kBucket;
    int32_t acc[kTileQ];
#pragma unroll
    for (int t = 0; t < kTileQ; ++t) acc[t] = 0;
    if (row < n_rows) {
      const int4* crow = reinterpret_cast<const int4*>(c + row * d);
      for (int k = 0; k < dv; ++k) {
        const int4 cv = __ldg(crow + k);
#pragma unroll
        for (int t = 0; t < kTileQ; ++t) {
          const int4 qv = q_tile[t * dv + k];
          int a = acc[t];
          a = __dp4a(cv.x, qv.x, a);
          a = __dp4a(cv.y, qv.y, a);
          a = __dp4a(cv.z, qv.z, a);
          a = __dp4a(cv.w, qv.w, a);
          acc[t] = a;
        }
      }
    }
    const int32_t bv = __ldg(bias + row);
#pragma unroll
    for (int t = 0; t < kTileQ; ++t) {
      // K1: >= 0, its bias carries +DOTMAX; K3: may be negative
      int32_t score = bv - acc[t];
      if (kShift) score >>= pre_shift;  // arithmetic: floor
      const int32_t key =
          (int32_t)(((uint32_t)score << chunk_bits) | (uint32_t)m);
      best[t] = min(best[t], key);
    }
  }

  const long long col = g * kBucket + lane;
#pragma unroll
  for (int t = 0; t < kTileQ; ++t) {
    if (q0 + t < b) atomicMin(out + (long long)(q0 + t) * n_out + col, best[t]);
  }
}

template <bool kShift>
cudaError_t launch(const int8_t* q, const int8_t* c, const int32_t* bias,
                   int32_t* out, int b, int d, long long n_rows, long long n,
                   int span, int pre_shift, int chunk_bits,
                   cudaStream_t stream) {
  const long long unit = (long long)span * kChunksPerUnit * kBucket;
  const long long groups = n / unit;
  const int splits = span * kChunksPerUnit / kChunksPerBlock;
  const long long n_out = n / ((long long)kBucket * span);
  const size_t smem = (size_t)kTileQ * d;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        scan_i8_packed<kShift>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  fill_int32_max<<<1024, 256, 0, stream>>>(out, (long long)b * n_out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)(groups * splits), (unsigned)((b + kTileQ - 1) / kTileQ));
  scan_i8_packed<kShift><<<grid, kBucket, smem, stream>>>(
      q, c, bias, out, b, d, n_rows, span, pre_shift, chunk_bits, n_out);
  return cudaGetLastError();
}

// K3: packed keys (held in idx) -> vals and absolute rows, in place
__global__ void decode_i8(float* __restrict__ vals, int32_t* __restrict__ idx,
                          long long total, long long n_out, int pre_shift) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int32_t best = idx[i];
    const int32_t score = (int32_t)((uint32_t)(best >> 7) << pre_shift);
    const long long col = i % n_out;
    vals[i] = (float)score;  // round to nearest, as XLA's int32 -> f32
    idx[i] = (int32_t)((col / kBucket) * (kChunksPerUnit * kBucket) +
                       (best & 127) * kBucket + col % kBucket);
  }
}

}  // namespace

// q [b, d] int8, c [n_rows, d] int8 (row-major, 16-byte aligned, d % 16 == 0),
// bias [n] int32 with n % (span * 16384) == 0 and n_rows <= n,
// out [b, n / (128 * span)] int32 (written in full).
// Launches on `stream` and returns the CUDA error code (0 = launched).
extern "C" int bucket_scan_i8_packed(const void* q, const void* c,
                                     const void* bias, void* out, int b, int d,
                                     long long n_rows, long long n, int span,
                                     int pre_shift, int chunk_bits,
                                     void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (d <= 0 || d % 16 || span <= 0 || n_rows < 0 || n_rows > n ||
      n % ((long long)span * 16384) ||
      (span * kChunksPerUnit) % kChunksPerBlock) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const int8_t*>(q);
  auto cp = static_cast<const int8_t*>(c);
  auto bp = static_cast<const int32_t*>(bias);
  auto op = static_cast<int32_t*>(out);
  cudaError_t e = pre_shift == 0
      ? launch<false>(qp, cp, bp, op, b, d, n_rows, n, span, 0, chunk_bits, s)
      : launch<true>(qp, cp, bp, op, b, d, n_rows, n, span, pre_shift,
                     chunk_bits, s);
  return (int)e;
}

extern "C" const char* bucket_scan_i8_packed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K3: q [b, d] int8, c [n_rows, d] int8 (as above), bias [n] int32 without
// the +DOTMAX offset (SENTINEL = excluded) with n % 16384 == 0 and
// n_rows <= n; vals [b, n / 128] f32 and idx [b, n / 128] int32 are written
// in full. Launches on `stream` and returns the CUDA error code.
extern "C" int bucket_scan_i8(const void* q, const void* c, const void* bias,
                              void* vals, void* idx, int b, int d,
                              long long n_rows, long long n, int pre_shift,
                              void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (d <= 0 || d % 16 || n_rows < 0 || n_rows > n ||
      n % ((long long)kChunksPerUnit * kBucket)) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const int8_t*>(q);
  auto cp = static_cast<const int8_t*>(c);
  auto bp = static_cast<const int32_t*>(bias);
  auto ip = static_cast<int32_t*>(idx);
  cudaError_t e = pre_shift == 0
      ? launch<false>(qp, cp, bp, ip, b, d, n_rows, n, 1, 0, 7, s)
      : launch<true>(qp, cp, bp, ip, b, d, n_rows, n, 1, pre_shift, 7, s);
  if (e != cudaSuccess) return (int)e;
  const long long n_out = n / kBucket;
  decode_i8<<<1024, 256, 0, s>>>(static_cast<float*>(vals), ip,
                                 (long long)b * n_out, n_out, pre_shift);
  return (int)cudaGetLastError();
}
