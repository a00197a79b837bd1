// K1 and K3: int8 coarse scans for Hopper (sm_90a): exact s32-accumulated
// int8 dot products on the tensor cores (wgmma) over corpus tiles staged by
// TMA, with the bucketed-min selection fused into the epilogue in registers.
//
// K1 (bucket_scan_i8_packed) replaces the TPU kernel
// valkey_search_tpu/ops/pallas_scan.py:383 bucket_min_scan_i8_packed, both
// of its bodies: _kernel_i8_packed_fused (:300, pre_shift == 0) and
// _kernel_i8_packed (:341, pre_shift > 0). The output is bit-identical to
// theirs. For corpus row r of survivor group g (span * 16384 rows), chunk
// m = (r - g * span * 16384) / 128 and lane l = r % 128:
//     key(r) = (((bias[r] - <q, c_r>) >> pre_shift) << chunk_bits) | m
// and out[q, g * 128 + l] = min over m of key(r). The bias carries +DOTMAX,
// so every score is >= 0 and keys order as plain ints; excluded rows carry
// SENTINEL. Rows at or past n_rows (the caller's padding up to n) score as
// zero vectors, exactly as the zero-padded corpus of the JAX package does:
// key = ((bias - 0) >> pre_shift) << chunk_bits | m, whatever the bias. The
// fused TPU body computes bias_c - (dot << chunk_bits) with the chunk
// pre-folded into the bias; for pre_shift == 0 that is the same number, so
// one body serves both.
//
// K3 (bucket_scan_i8) replaces valkey_search_tpu/ops/pallas_scan.py:562
// bucket_min_scan_i8 (body _kernel_i8, :522). It runs the same scan at
// span 1 and chunk_bits 7, but its bias carries no +DOTMAX, so scores range
// over [-DOTMAX, SENTINEL + DOTMAX]: the min is a signed int32 min from
// INT32_MAX, `>> pre_shift` an arithmetic shift (floor), and the shift into
// the key is done on uint32, which gives the two's-complement bits of the
// TPU kernel without C++'s undefined shift of a negative int. A decode pass
// then writes, per survivor column c of group g and lane l,
// vals = ((best >> 7) << pre_shift) as f32 and
// idx = g * 16384 + (best & 127) * 128 + l, as K2's does.
//
// What bounds it on the card (N = 1,048,576, d 128), and what the design
// does about it:
// - Small B (a hybrid request is B = 1): device-memory bytes. The corpus is
//   128 MiB and the bias 4 MiB, a floor of ~0.04 ms at 3.35 TB/s. The
//   earlier dp4a body read one row per thread with __ldg, computed a fixed
//   32-query tile whatever B was (31/32 of the work multiplied zero rows at
//   B = 1) and launched 128 blocks at span 8: 16% of the floor. Here one
//   producer warp keeps a ring of kStages TMA boxes in flight (128 rows x
//   128 int8, 16 KiB, 128-byte swizzle: d/128 boxes per 128-row chunk, any
//   d % 16 == 0), the query tile is only BQ = 8 wide at B <= 8 (wgmma's
//   smallest N), and each group's chunks split into slices until the grid
//   has >= 264 blocks, so every SM streams.
// - Large B: int8 multiply-adds (B = 1,024: 275 G operations, a floor of
//   0.139 ms at 1,979 TOP/s), then the epilogue. The dp4a body issued 34 G
//   dp4a on the CUDA cores, each four fed by a shared-memory read of the
//   query tile. Here corpus rows are wgmma's M side (two consumer
//   warpgroups of 64 lanes each), the query tile (BQ up to 128, resident
//   in shared memory for the whole block) its N side, both K-major as the
//   corpus [n_rows, d] and the queries [B, d] already lie, so the products
//   run on the tensor cores in s32, exactly. At d 128 a chunk is one box,
//   so the epilogue (bias, shift, chunk, min for every score) costs as much
//   as the products. It runs on the accumulator fragment in registers:
//   each thread owns the same (lane, query) pairs in every chunk, so its
//   running min keys never leave registers; the key takes one multiply-add
//   and two integer operations a score (Epilogue, below), not four integer
//   operations; and each warpgroup keeps two accumulators and folds chunk
//   m while the tensor cores run chunk m + 1 (one commit group per box).
// TMA fills rows past n_rows and columns past d with zeros, which gives the
// zero-vector tail and the k-pad with no copy; chunks wholly past n_rows are
// not loaded and fold a dot of 0. Slices of a group merge with atomicMin
// into the INT32_MAX-filled keys (order-free, so the result does not depend
// on block order).

#include <stdint.h>

#include "hopper_ptx.cuh"

namespace {

using namespace hopper;

constexpr int kBucket = 128;          // lanes = survivor columns per group
constexpr int kChunksPerUnit = 128;   // 16384 rows = 128 chunks of 128 rows
constexpr int kBoxCols = 128;         // int8 columns per box: 128 bytes
constexpr int kBoxBytes = kBucket * kBoxCols;
constexpr int kStages = 4;            // corpus boxes in flight per block
constexpr int kThreads = 384;         // 2 consumer warpgroups + producer

// Shared memory of one block, in this order: the corpus ring, the query
// tile (d/128 boxes of BQ rows), the ring's biases, the barriers; plus 1024
// bytes to align the swizzled tiles. The wrapper's k1_smem_bytes computes
// the same.
__host__ __device__ constexpr int smem_bytes(int bq, int kb) {
  return 1024 + kStages * kBoxBytes + kb * bq * 128 + kStages * kBucket * 4 +
         (2 * kStages + 1) * 8;
}

// D[64 x N] (+)= A[64 x 32] * B[32 x N], s32 += s8 * s8, A and B K-major in
// shared memory; scale_d == 0 overwrites D
template <int N>
__device__ __forceinline__ void wgmma(int32_t* d, uint64_t a, uint64_t b,
                                      int scale_d);

template <>
__device__ __forceinline__ void wgmma<8>(int32_t* d, uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3}, "
      "%4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<16>(int32_t* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<32>(int32_t* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<64>(int32_t* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<128>(int32_t* d, uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// A query tile of BQ columns (a multiple of 8) as wgmma's of N = 128, 64,
// 32, 16, 8. Piece n0 starts n0 rows into the B tile (n0 * 128 bytes, a
// multiple of 1024) and writes acc[n0 / 2 ...]: the concatenated fragments
// lay out exactly as one m64nBQk32's.
template <int Rest, int N0 = 0>
__device__ __forceinline__ void mma_tile(int32_t* acc, uint64_t a, uint64_t b,
                                         int scale_d) {
  if constexpr (Rest > 0) {
    constexpr int P = Rest >= 128 ? 128 : Rest >= 64 ? 64
                    : Rest >= 32 ? 32 : Rest >= 16 ? 16 : 8;
    wgmma<P>(acc + N0 / 2, a, b + (uint64_t)(N0 * 128 >> 4), scale_d);
    mma_tile<Rest - P, N0 + P>(acc, a, b, scale_d);
  }
}

// The key arithmetic, in three integer operations a score. For a score
// s = bias - dot and 0 <= pre_shift <= chunk_bits, in two's complement
// (mod 2^32), ((s >> pre_shift) << chunk_bits) is s << (chunk_bits -
// pre_shift) with its low chunk_bits bits cleared, and a left shift by k is
// a product by 2^k, which distributes over the difference. So with
// mult = 2^(chunk_bits - pre_shift) and each row's bias pre-multiplied,
//     key = ((bias * mult - dot * mult) & high) | m,   high = ~(2^chunk_bits - 1)
// is K1's key bit for bit (and K3's, whose scores may be negative): one
// multiply-add on the FMA pipe and two integer-pipe operations (and-or,
// min) a score, against four integer-pipe operations for the shifts.
struct Epilogue {
  uint32_t mult, neg_mult, high;
  __device__ Epilogue(int pre_shift, int chunk_bits)
      : mult(1u << (chunk_bits - pre_shift)),
        neg_mult(0u - (1u << (chunk_bits - pre_shift))),
        high(~((1u << chunk_bits) - 1u)) {}
};

// Fold one chunk's dots into the running keys; b0 and b1 are the biases of
// the thread's two rows times ep.mult. Fragment register r of thread (warp
// w, lane t) in its warpgroup holds row 16w + t/4 (+8 when r & 2) and query
// column 8 (r / 4) + 2 (t % 4) + (r & 1). kZero folds a chunk past the
// corpus: zero-vector rows, dot 0.
template <int BQ, bool kZero = false>
__device__ __forceinline__ void fold_chunk(const int32_t* acc, int32_t* best,
                                           uint32_t b0, uint32_t b1,
                                           const Epilogue& ep, int m) {
#pragma unroll
  for (int r = 0; r < BQ / 2; ++r) {
    const uint32_t bias = (r & 2) ? b1 : b0;
    const uint32_t t = kZero ? bias : (uint32_t)acc[r] * ep.neg_mult + bias;
    best[r] = min(best[r], (int32_t)((t & ep.high) | (uint32_t)m));
  }
}

// A consumer warpgroup's pass over the ring. Each box is one commit group;
// after issuing box k the thread waits for every group but box k's, so the
// tensor cores run box k while the thread releases box k - 1's stage and,
// at the first box of a chunk, folds the previous chunk, whose dots sit in
// the other accumulator. Only two stages are ever held, whatever d is.
template <int BQ>
struct Consumer {
  int32_t acc[2][BQ / 2];
  int32_t best[BQ / 2];
  int stage = 0;
  uint32_t phase = 0;
  int held = -1;     // stage of the last issued box, not yet released
  int pending = -1;  // chunk whose fold waits for its last box, or -1
  uint32_t pb0 = 0, pb1 = 0;  // its biases, times ep.mult

  template <int W>
  __device__ __forceinline__ void fold_pending(const Epilogue& ep) {
    if (pending >= 0) {
      fold_chunk<BQ>(acc[W], best, pb0, pb1, ep, pending);
      pending = -1;
    }
  }

  // chunk m into acc[A]; the pending chunk (if any) is in acc[A ^ 1]
  template <int A>
  __device__ __forceinline__ void chunk(
      int m, long long row0, long long n_rows, int kb_n, uint32_t ring,
      uint32_t qtile, const int32_t* bias_s, const int32_t* bias,
      uint32_t bars, int wg, int row_a, const Epilogue& ep) {
    auto full = [&](int s) { return bars + s * 8; };
    auto empty = [&](int s) { return bars + (kStages + s) * 8; };
    if (row0 >= n_rows) {  // past the corpus: zero vectors
      wgmma_wait_all();
      if (held >= 0) mbar_arrive(empty(held));
      held = -1;
      this->template fold_pending<A ^ 1>(ep);
      fold_chunk<BQ, true>(acc[A], best,
                           (uint32_t)__ldg(bias + row0 + row_a) * ep.mult,
                           (uint32_t)__ldg(bias + row0 + row_a + 8) * ep.mult,
                           ep, m);
      return;
    }
    uint32_t b0 = 0, b1 = 0;
    for (int kb = 0; kb < kb_n; ++kb) {
      mbar_wait(full(stage), phase);
      if (kb == 0) {
        b0 = (uint32_t)bias_s[stage * kBucket + row_a] * ep.mult;
        b1 = (uint32_t)bias_s[stage * kBucket + row_a + 8] * ep.mult;
      }
      const uint64_t da = smem_desc(ring + stage * kBoxBytes + wg * 8192);
      const uint64_t db = smem_desc(qtile + kb * BQ * 128);
      // all four k-steps: columns past d are zeros in both tiles, and a
      // wgmma skipped on a branch would serialize the others
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_tile<BQ>(acc[A], da + 2 * kk, db + 2 * kk, kb | kk);
      }
      wgmma_commit();
      wgmma_wait_all_but_one();
      if (held >= 0) mbar_arrive(empty(held));
      held = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      if (kb == 0) this->template fold_pending<A ^ 1>(ep);
    }
    pending = m;
    pb0 = b0;
    pb1 = b1;
  }
};

// One block: query tile qt (BQ queries from q0), group g (span * 128
// chunks), chunks [m0, m0 + chunks). Threads 0-255 are two consumer
// warpgroups (lanes 0-63 and 64-127 of every chunk); thread 256 issues the
// TMA loads.
template <int BQ>
__global__ void __launch_bounds__(kThreads, BQ <= 32 ? 2 : 1)
scan_i8(const __grid_constant__ CUtensorMap qmap,
        const __grid_constant__ CUtensorMap cmap,
        const int32_t* __restrict__ bias, int32_t* __restrict__ out, int b,
        int d, long long n_rows, long long n_out, int span, int pre_shift,
        int chunk_bits, int chunks, int slices, int qtiles) {
  constexpr bool kBigTile = BQ > 32;  // one block per SM: move registers
  extern __shared__ uint8_t smem_raw[];
  const int kb_n = (d + kBoxCols - 1) / kBoxCols;
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t ring = base;
  const uint32_t qtile = ring + kStages * kBoxBytes;
  int32_t* const bias_s = reinterpret_cast<int32_t*>(
      sbase + kStages * kBoxBytes + kb_n * BQ * 128);
  const uint32_t bars = smem_addr(bias_s + kStages * kBucket);
  const uint32_t qbar = bars + 2 * kStages * 8;
  auto full = [&](int s) { return bars + s * 8; };
  auto empty = [&](int s) { return bars + (kStages + s) * 8; };

  const int qt = blockIdx.x % qtiles;
  const long long unit = blockIdx.x / qtiles;
  const long long g = unit / slices;
  const int m0 = (int)(unit % slices) * chunks;
  const int q0 = qt * BQ;
  const long long group_row = g * span * kChunksPerUnit * kBucket;

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

    const Epilogue ep(pre_shift, chunk_bits);
    Consumer<BQ> c;
#pragma unroll
    for (int r = 0; r < BQ / 2; ++r) c.best[r] = INT32_MAX;
    mbar_wait(qbar, 0);

    // chunks alternate between the two accumulators: even ones in acc[0]
    for (int m = m0; m < m0 + chunks; m += 2) {
      c.template chunk<0>(m, group_row + (long long)m * kBucket, n_rows, kb_n,
                          ring, qtile, bias_s, bias, bars, wg, row_a, ep);
      if (m + 1 < m0 + chunks) {
        c.template chunk<1>(m + 1, group_row + (long long)(m + 1) * kBucket,
                            n_rows, kb_n, ring, qtile, bias_s, bias, bars, wg,
                            row_a, ep);
      }
    }
    wgmma_wait_all();
    if (c.held >= 0) mbar_arrive(empty(c.held));
    if ((c.pending - m0) & 1) {
      c.template fold_pending<1>(ep);
    } else {
      c.template fold_pending<0>(ep);
    }

    const long long col = g * kBucket + row_a;
#pragma unroll
    for (int r = 0; r < BQ / 2; ++r) {
      const int q = q0 + 8 * (r >> 2) + cq + (r & 1);
      if (q < b) {
        atomicMin(out + (long long)q * n_out + col + ((r & 2) ? 8 : 0),
                  c.best[r]);
      }
    }
  }
}

// [rows, d] int8 in boxes of box_rows x 128
cudaError_t i8_map(CUtensorMap* map, const void* ptr, long long rows, int d,
                   int box_rows) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ptr, rows, d,
                    kBoxCols, box_rows);
}

template <int BQ>
cudaError_t launch_scan(const CUtensorMap& qmap, const CUtensorMap& cmap,
                        const int32_t* bias, int32_t* out, int b, int d,
                        long long n_rows, long long n, int span, int pre_shift,
                        int chunk_bits, cudaStream_t stream) {
  const int smem = smem_bytes(BQ, (d + kBoxCols - 1) / kBoxCols);
  static bool ready = false;  // attributes checked once per tile width
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        scan_i8<BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    if (BQ > 32) {
      // setmaxnreg moves 128 x (168 - 40) registers to the consumers; it
      // would wait forever for registers the launch did not allocate
      cudaFuncAttributes attr;
      e = cudaFuncGetAttributes(&attr, scan_i8<BQ>);
      if (e != cudaSuccess) return e;
      if (attr.numRegs * kThreads < 40 * 128 + 232 * 256) {
        return cudaErrorInvalidConfiguration;
      }
    }
    ready = true;
  }
  const int chunks = span * kChunksPerUnit;
  const long long groups = n / ((long long)chunks * kBucket);
  const int qtiles = (b + BQ - 1) / BQ;
  const int slices = slices_for(groups, qtiles, chunks);
  const long long blocks = groups * qtiles * slices;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  scan_i8<BQ><<<(unsigned)blocks, kThreads, smem, stream>>>(
      qmap, cmap, bias, out, b, d, n_rows, n / ((long long)kBucket * span),
      span, pre_shift, chunk_bits, chunks / slices, slices, qtiles);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const CUtensorMap&, const CUtensorMap&,
                                 const int32_t*, int32_t*, int, int,
                                 long long, long long, int, int, int,
                                 cudaStream_t);

constexpr LaunchFn kLaunch[] = {
    launch_scan<8>,  launch_scan<16>, launch_scan<24>,  launch_scan<32>,
    launch_scan<40>, launch_scan<48>, launch_scan<56>,  launch_scan<64>,
    launch_scan<72>, launch_scan<80>, launch_scan<88>,  launch_scan<96>,
    launch_scan<104>, launch_scan<112>, launch_scan<120>, launch_scan<128>,
};

// Fill `out` [b, n / (128 * span)] with INT32_MAX, then scan into it.
cudaError_t scan(const void* q, const void* c, const void* bias, int32_t* out,
                 int b, int d, long long n_rows, long long n, int span,
                 int pre_shift, int chunk_bits, int bq, cudaStream_t s) {
  CUtensorMap qmap, cmap;
  cudaError_t e = i8_map(&qmap, q, b, d, bq);
  // an empty corpus is all tail: its map is never read, any valid one does
  if (e == cudaSuccess) {
    e = n_rows > 0 ? i8_map(&cmap, c, n_rows, d, kBucket)
                   : i8_map(&cmap, q, b, d, kBucket);
  }
  if (e != cudaSuccess) return e;
  fill_int32_max<<<1024, 256, 0, s>>>(out,
                                      (long long)b * (n / (kBucket * span)));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return kLaunch[bq / 8 - 1](qmap, cmap, static_cast<const int32_t*>(bias),
                             out, b, d, n_rows, n, span, pre_shift,
                             chunk_bits, s);
}

bool bad_args(int d, long long n_rows, long long n, int span, int pre_shift,
              int chunk_bits, int bq) {
  return d <= 0 || d % 16 || span <= 0 || n_rows < 0 || n_rows > n ||
         pre_shift < 0 || chunk_bits > 30 || pre_shift > chunk_bits ||
         n % ((long long)span * kChunksPerUnit * kBucket) || bq < 8 ||
         bq > 128 || bq % 8 ||
         smem_bytes(bq, (d + kBoxCols - 1) / kBoxCols) > kMaxSmem;
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
// out [b, n / (128 * span)] int32 (written in full). bq is the query tile
// (a multiple of 8 in [8, 128] whose shared memory fits: the wrapper's
// k1_query_tile). Launches on `stream` and returns the CUDA error code
// (0 = launched).
extern "C" int bucket_scan_i8_packed(const void* q, const void* c,
                                     const void* bias, void* out, int b, int d,
                                     long long n_rows, long long n, int span,
                                     int pre_shift, int chunk_bits, int bq,
                                     void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (bad_args(d, n_rows, n, span, pre_shift, chunk_bits, bq)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)scan(q, c, bias, static_cast<int32_t*>(out), b, d, n_rows, n,
                   span, pre_shift, chunk_bits, bq,
                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* bucket_scan_i8_packed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K3: q [b, d] int8, c [n_rows, d] int8 (as above), bias [n] int32 without
// the +DOTMAX offset (SENTINEL = excluded) with n % 16384 == 0 and
// n_rows <= n; vals [b, n / 128] f32 and idx [b, n / 128] int32 are written
// in full; bq as for K1. Launches on `stream` and returns the CUDA error
// code.
extern "C" int bucket_scan_i8(const void* q, const void* c, const void* bias,
                              void* vals, void* idx, int b, int d,
                              long long n_rows, long long n, int pre_shift,
                              int bq, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (bad_args(d, n_rows, n, 1, pre_shift, 7, bq)) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto ip = static_cast<int32_t*>(idx);
  cudaError_t e =
      scan(q, c, bias, ip, b, d, n_rows, n, 1, pre_shift, 7, bq, s);
  if (e != cudaSuccess) return (int)e;
  const long long n_out = n / kBucket;
  decode_i8<<<1024, 256, 0, s>>>(static_cast<float*>(vals), ip,
                                 (long long)b * n_out, n_out, pre_shift);
  return (int)cudaGetLastError();
}
