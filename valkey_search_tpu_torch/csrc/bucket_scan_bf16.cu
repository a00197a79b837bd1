// K2: bf16 coarse scan for Hopper (sm_90a): f32-accumulated bf16 dot
// products on the tensor cores (wgmma) over corpus tiles staged by TMA, with
// the bucketed min/argmin selection fused into the epilogue in registers.
//
// Replaces the TPU kernel valkey_search_tpu/ops/pallas_scan.py
// bucket_min_scan (kernel body _kernel). For corpus row r of 16384-row
// group g, chunk m = (r % 16384) / 128 and lane l = r % 128:
//     s(r)   = <q, c_r> + bias[r]  (+ qsq[q] when positive)
//     key(r) = bits(s) (positive) or bits ^ ((bits >> 31) & 0x7fffffff),
//              with its low 7 bits replaced by m
// and, over the 128 chunks of the bucket, best = min key(r) (signed int32).
// Outputs: vals = best with its low 7 bits cleared and the flip undone,
// idx = g * 16384 + (best & 127) * 128 + l. As in the JAX kernel, a score
// that rounds to just below 0 under `positive` has negative raw bits and so
// sorts first; that is kept. Each product of two bf16 values is exact in
// f32, so the kernel differs from the plain version only in the order of
// the f32 sums.
//
// What bounds it on the card, and what the design does about it:
// - Small B (one hybrid request is B = 1): device-memory bytes. The bf16
//   corpus (256 MiB at 1M x 128) is read once per query tile, so the scan
//   is a stream of the corpus, whose floor is ~0.08 ms at 3.35 TB/s. The
//   earlier FMA body read it with one thread per row (16-byte loads 256
//   bytes apart) in 128 blocks of 4 warps, ~0.24 TB/s. Here one producer
//   warp keeps a ring of kStages TMA boxes in flight (128 rows x 64 bf16,
//   16 KB, 128-byte swizzle: d/64 boxes per 128-row chunk, any d % 8 == 0),
//   the query tile is only BQ = 8 wide at B <= 8 (wgmma's smallest N), and
//   each group's 128 chunks split into slices until the grid has >= 264
//   blocks (two per SM at small BQ), so every SM streams.
// - Large B: multiply-adds, then the epilogue. The FMA body did 32 queries
//   per row on the CUDA cores (~22 TFLOP/s). Here corpus rows are wgmma's M
//   side (two consumer warpgroups of 64 lanes each), the query tile (BQ up
//   to 128, resident in shared memory for the whole block) its N side, both
//   K-major, so the products run on the tensor cores. The epilogue (bias,
//   ||q||^2, key, chunk, min: ~4 operations a score) runs on the
//   accumulator fragment in registers: each thread owns the same (lane,
//   query) pairs in every chunk, so its running min keys never leave
//   registers. The two warpgroups wait on the ring independently, so one's
//   epilogue overlaps the other's wgmma.
// TMA fills rows past n_rows and columns past d with zeros, which gives the
// zero-vector tail and the k-pad with no copy. Slices of a group merge with
// atomicMin into the INT32_MAX-filled packed keys (order-free, so the
// result does not depend on block order), which a second pass decodes in
// place into vals and idx.

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace {

using namespace hopper;

constexpr int kBucket = 128;          // lanes = survivor columns per group
constexpr int kChunks = 128;          // chunks of 128 rows per group
constexpr int kGroup = kChunks * kBucket;
constexpr int kBoxCols = 64;          // bf16 columns per box: 128 bytes
constexpr int kBoxBytes = kBucket * kBoxCols * 2;
constexpr int kStages = 4;            // corpus boxes in flight per block
constexpr int kThreads = 384;         // 2 consumer warpgroups + producer

// Shared memory of one block, in this order: the corpus ring, the query
// tile (d/64 boxes of BQ rows), the ring's biases, the query norms, the
// barriers; plus 1024 bytes to align the swizzled tiles. The wrapper's
// k2_smem_bytes computes the same.
__host__ __device__ constexpr int smem_bytes(int bq, int kb) {
  return 1024 + kStages * kBoxBytes + kb * bq * 128 +
         kStages * kBucket * 4 + 128 * 4 + (2 * kStages + 1) * 8;
}

// D[64 x N] (+)= A[64 x 16] * B[16 x N], f32 += bf16 * bf16, A and B
// K-major in shared memory; scale_d == 0 overwrites D
template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t a, uint64_t b,
                                      int scale_d);

template <>
__device__ __forceinline__ void wgmma<8>(float* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<16>(float* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<32>(float* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<64>(float* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<128>(float* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// A query tile of BQ columns (a multiple of 8) as wgmma's of N = 128, 64,
// 32, 16, 8. Piece n0 starts n0 rows into the B tile (n0 * 128 bytes, a
// multiple of 1024) and writes acc[n0 / 2 ...]: the concatenated fragments
// lay out exactly as one m64nBQk16's.
template <int Rest, int N0 = 0>
__device__ __forceinline__ void mma_tile(float* acc, uint64_t a, uint64_t b,
                                         int scale_d) {
  if constexpr (Rest > 0) {
    constexpr int P = Rest >= 128 ? 128 : Rest >= 64 ? 64
                    : Rest >= 32 ? 32 : Rest >= 16 ? 16 : 8;
    wgmma<P>(acc + N0 / 2, a, b + (uint64_t)(N0 * 128 >> 4), scale_d);
    mma_tile<Rest - P, N0 + P>(acc, a, b, scale_d);
  }
}

// Fold one chunk's scores into the running keys. Fragment register r of
// thread (warp w, lane t) in its warpgroup holds row 16w + t/4 (+8 when
// r & 2) and query column 8 (r / 4) + 2 (t % 4) + (r & 1).
template <int BQ, bool kPositive>
__device__ __forceinline__ void fold_chunk(const float* acc, int32_t* best,
                                           float b0, float b1,
                                           const float* q_sq, int cq, int m) {
#pragma unroll
  for (int r = 0; r < BQ / 2; ++r) {
    float s = acc[r] + ((r & 2) ? b1 : b0);
    if (kPositive) s += q_sq[8 * (r >> 2) + cq + (r & 1)];
    int32_t key = __float_as_int(s);
    if (!kPositive) key ^= (key >> 31) & 0x7fffffff;
    best[r] = min(best[r], (key & ~127) | m);
  }
}

// One block: query tile qt (BQ queries from q0), group g, chunks
// [m0, m0 + chunks). Threads 0-255 are two consumer warpgroups (lanes
// 0-63 and 64-127 of every chunk); thread 256 issues the TMA loads.
template <int BQ>
__global__ void __launch_bounds__(kThreads, BQ <= 32 ? 2 : 1)
scan_bf16(const __grid_constant__ CUtensorMap qmap,
          const __grid_constant__ CUtensorMap cmap,
          const float* __restrict__ qsq, const float* __restrict__ bias,
          int32_t* __restrict__ packed, int b, int d, long long n_rows,
          long long n_out, int chunks, int slices, int qtiles,
          int positive) {
  constexpr bool kBigTile = BQ > 32;  // one block per SM: move registers
  extern __shared__ uint8_t smem_raw[];
  const int kb_n = (d + kBoxCols - 1) / kBoxCols;
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t ring = base;
  const uint32_t qtile = ring + kStages * kBoxBytes;
  float* const bias_s = reinterpret_cast<float*>(
      sbase + kStages * kBoxBytes + kb_n * BQ * 128);
  float* const q_sq = bias_s + kStages * kBucket;
  const uint32_t bars = smem_addr(q_sq + 128);
  const uint32_t qbar = bars + 2 * kStages * 8;
  auto full = [&](int s) { return bars + s * 8; };
  auto empty = [&](int s) { return bars + (kStages + s) * 8; };

  const int qt = blockIdx.x % qtiles;
  const long long unit = blockIdx.x / qtiles;
  const long long g = unit / slices;
  const int m0 = (int)(unit % slices) * chunks;
  const int q0 = qt * BQ;
  const long long group_row = g * kGroup;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);  // every consumer thread releases
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // --- producer warpgroup: one thread issues every load ---
    if constexpr (kBigTile) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    }
    if (threadIdx.x == 256) {
      mbar_expect_tx(qbar, kb_n * BQ * 128);
      for (int kb = 0; kb < kb_n; ++kb) {
        tma_load(qtile + kb * BQ * 128, &qmap, kb * kBoxCols, q0, qbar);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int m = m0; m < m0 + chunks; ++m) {
        const long long row0 = group_row + (long long)m * kBucket;
        if (row0 >= n_rows) break;  // the rest is the zero-vector tail
        for (int kb = 0; kb < kb_n; ++kb) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), kBoxBytes + (kb == 0 ? kBucket * 4 : 0));
          tma_load(ring + stage * kBoxBytes, &cmap, kb * kBoxCols, (int)row0,
                   full(stage));
          if (kb == 0) {
            bulk_load(smem_addr(bias_s + stage * kBucket), bias + row0,
                      kBucket * 4, full(stage));
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // --- consumer warpgroups ---
    if constexpr (kBigTile) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    }
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int row_a = 64 * wg + 16 * warp + (lane >> 2);  // +8: row_b
    const int cq = 2 * (lane & 3);
    if (threadIdx.x < BQ) {
      q_sq[threadIdx.x] =
          positive && q0 + (int)threadIdx.x < b ? qsq[q0 + threadIdx.x] : 0.0f;
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");

    float acc[BQ / 2];
    int32_t best[BQ / 2];
#pragma unroll
    for (int r = 0; r < BQ / 2; ++r) best[r] = INT32_MAX;
    mbar_wait(qbar, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int m = m0; m < m0 + chunks; ++m) {
      const long long row0 = group_row + (long long)m * kBucket;
      float b0 = 0.0f, b1 = 0.0f;
      if (row0 < n_rows) {
        for (int kb = 0; kb < kb_n; ++kb) {
          mbar_wait(full(stage), phase);
          if (kb == 0) {
            b0 = bias_s[stage * kBucket + row_a];
            b1 = bias_s[stage * kBucket + row_a + 8];
          }
          const uint64_t da = smem_desc(ring + stage * kBoxBytes + wg * 8192);
          const uint64_t db = smem_desc(qtile + kb * BQ * 128);
          // all four k-steps: columns past d are zeros in both tiles, and
          // a wgmma skipped on a branch would serialize the others
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            mma_tile<BQ>(acc, da + 2 * kk, db + 2 * kk, kb | kk);
          }
          wgmma_commit();
          wgmma_wait_all();
          mbar_arrive(empty(stage));
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      } else {  // past the corpus: zero vectors
#pragma unroll
        for (int r = 0; r < BQ / 2; ++r) acc[r] = 0.0f;
        b0 = __ldg(bias + row0 + row_a);
        b1 = __ldg(bias + row0 + row_a + 8);
      }
      if (positive) {
        fold_chunk<BQ, true>(acc, best, b0, b1, q_sq, cq, m);
      } else {
        fold_chunk<BQ, false>(acc, best, b0, b1, q_sq, cq, m);
      }
    }

    const long long col = g * kBucket + row_a;
#pragma unroll
    for (int r = 0; r < BQ / 2; ++r) {
      const int q = q0 + 8 * (r >> 2) + cq + (r & 1);
      if (q < b) {
        atomicMin(packed + (long long)q * n_out + col + ((r & 2) ? 8 : 0),
                  best[r]);
      }
    }
  }
}

// packed keys (held in idx) -> vals and absolute rows, in place
template <bool kPositive>
__global__ void decode(float* __restrict__ vals, int32_t* __restrict__ idx,
                       long long total, long long n_out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int32_t best = idx[i];
    int32_t vbits = best & ~127;
    if (!kPositive) vbits ^= (vbits >> 31) & 0x7fffffff;
    const long long col = i % n_out;
    vals[i] = __int_as_float(vbits);
    idx[i] = (int32_t)((col / kBucket) * kGroup + (best & 127) * kBucket +
                       col % kBucket);
  }
}

// --- host side --------------------------------------------------------------

// [rows, d] bf16 in boxes of box_rows x 64
cudaError_t bf16_map(CUtensorMap* map, const void* ptr, long long rows,
                     int d, int box_rows) {
  return hopper::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr,
                            rows, d, kBoxCols, box_rows);
}

template <int BQ>
cudaError_t launch_scan(const CUtensorMap& qmap, const CUtensorMap& cmap,
                        const float* qsq, const float* bias, int32_t* packed,
                        int b, int d, long long n_rows, long long n,
                        int positive, cudaStream_t stream) {
  const int smem = smem_bytes(BQ, (d + kBoxCols - 1) / kBoxCols);
  static bool ready = false;  // attributes checked once per tile width
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        scan_bf16<BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    if (BQ > 32) {
      // setmaxnreg moves 128 x (168 - 40) registers to the consumers; it
      // would wait forever for registers the launch did not allocate
      cudaFuncAttributes attr;
      e = cudaFuncGetAttributes(&attr, scan_bf16<BQ>);
      if (e != cudaSuccess) return e;
      if (attr.numRegs * kThreads < 40 * 128 + 232 * 256) {
        return cudaErrorInvalidConfiguration;
      }
    }
    ready = true;
  }
  const long long groups = n / kGroup;
  const int qtiles = (b + BQ - 1) / BQ;
  const int slices = slices_for(groups, qtiles, kChunks);
  const long long blocks = groups * qtiles * slices;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  scan_bf16<BQ><<<(unsigned)blocks, kThreads, smem, stream>>>(
      qmap, cmap, qsq, bias, packed, b, d, n_rows, n / kBucket,
      kChunks / slices, slices, qtiles, positive);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const CUtensorMap&, const CUtensorMap&,
                                 const float*, const float*, int32_t*, int,
                                 int, long long, long long, int,
                                 cudaStream_t);

constexpr LaunchFn kLaunch[] = {
    launch_scan<8>,  launch_scan<16>, launch_scan<24>,  launch_scan<32>,
    launch_scan<40>, launch_scan<48>, launch_scan<56>,  launch_scan<64>,
    launch_scan<72>, launch_scan<80>, launch_scan<88>,  launch_scan<96>,
    launch_scan<104>, launch_scan<112>, launch_scan<120>, launch_scan<128>,
};

}  // namespace

// q [b, d] bf16 (alpha folded in), qsq [b] f32, c [n_rows, d] bf16 and
// bias [n] f32 (row-major, 16-byte aligned, d % 8 == 0, n % 16384 == 0,
// n_rows <= n); vals [b, n / 128] f32 and idx [b, n / 128] int32 are
// written in full. bq is the query tile (a multiple of 8 in [8, 128] whose
// shared memory fits: the wrapper's k2_query_tile). Launches on `stream`
// and returns the CUDA error code.
extern "C" int bucket_scan_bf16(const void* q, const void* qsq, const void* c,
                                const void* bias, void* vals, void* idx, int b,
                                int d, long long n_rows, long long n,
                                int positive, int bq, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (d <= 0 || d % 8 || n_rows < 0 || n_rows > n || n % kGroup ||
      bq < 8 || bq > 128 || bq % 8 ||
      smem_bytes(bq, (d + kBoxCols - 1) / kBoxCols) > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto ip = static_cast<int32_t*>(idx);
  const long long n_out = n / kBucket;
  const long long total = (long long)b * n_out;
  CUtensorMap qmap, cmap;
  cudaError_t e = bf16_map(&qmap, q, b, d, bq);
  // an empty corpus is all tail: its map is never read, any valid one does
  if (e == cudaSuccess) {
    e = n_rows > 0 ? bf16_map(&cmap, c, n_rows, d, kBucket)
                   : bf16_map(&cmap, q, b, d, kBucket);
  }
  if (e != cudaSuccess) return (int)e;
  fill_int32_max<<<1024, 256, 0, s>>>(ip, total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = kLaunch[bq / 8 - 1](qmap, cmap, static_cast<const float*>(qsq),
                          static_cast<const float*>(bias), ip, b, d, n_rows,
                          n, positive, s);
  if (e != cudaSuccess) return (int)e;
  if (positive) {
    decode<true><<<1024, 256, 0, s>>>(static_cast<float*>(vals), ip, total,
                                      n_out);
  } else {
    decode<false><<<1024, 256, 0, s>>>(static_cast<float*>(vals), ip, total,
                                       n_out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bucket_scan_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
