// Hopper (sm_90a) building blocks shared by the TMA + wgmma scans
// (bucket_scan_bf16.cu, bucket_scan_i8_packed.cu): mbarriers, TMA loads,
// wgmma shared-memory descriptors and fences, and the host-side tensor-map
// encoder. Header-only; the kernel and the host functions have internal
// linkage, so each source's library keeps its own copy.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kMaxSmem = 232448;              // per-block shared memory
constexpr long long kWaitCycles = 1LL << 32;  // ~2 s: trap, never hang

static __global__ void fill_int32_max(int32_t* __restrict__ p, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    p[i] = INT32_MAX;
  }
}

// --- PTX: mbarriers, TMA, wgmma --------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed. A barrier that
// never completes (a fault in the kernel) traps after ~2 s instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > kWaitCycles) {
      asm volatile("trap;\n");
    }
  }
}

// one box of a 2-D tensor map (col, row) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
         "r"(bar)
      : "memory");
}

// contiguous bytes (a multiple of 16, 16-byte aligned) into shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzle,
// 8-row atoms 1024 bytes apart; the tile starts 1024-byte aligned and a
// k-step of 32 bytes (16 bf16 or 32 int8) adds 32 bytes to the start
// address, i.e. 2 to the descriptor
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// every committed group but the most recent one has completed
__device__ __forceinline__ void wgmma_wait_all_but_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// --- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the CUDA runtime so that
// the library needs no link against libcuda
static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// [rows, cols] row-major of `elem_bytes`-byte elements, in boxes of
// box_rows x box_cols (box_cols * elem_bytes == 128) with 128-byte swizzle;
// reads past the edges fill zeros
static cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                              int elem_bytes, const void* ptr,
                              long long rows, int cols, int box_cols,
                              int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides,
                      box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The grid of a scan: query tiles x groups x chunk slices. Each group's
// `chunks` split in halves until the grid has at least min_grid blocks
// (two per SM of 132), so every SM streams even at one query tile.
static int slices_for(long long groups, int qtiles, int chunks,
                      int min_grid = 264) {
  int slices = 1;
  while (slices < chunks && groups * qtiles * slices < min_grid) slices *= 2;
  return slices;
}

}  // namespace hopper
