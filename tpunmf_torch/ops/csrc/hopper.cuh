// Hopper's asynchronous copies and warpgroup products, for the stages of
// wave.cuh's TmaStages: the Tensor Memory Accelerator (TMA) copies a tile
// of a 2-D array described by a tensor map from device memory into shared
// memory and reports the bytes to an mbarrier; wgmma multiplies a 64-row
// tile of A (here from registers) by a tile of B read from shared memory,
// asynchronously, into accumulator registers of a warpgroup (4 warps).
//
// Shared tiles are written by TMA with the 128-byte swizzle: a tile row of
// 128 bytes holds eight 16-byte chunks, and chunk c of row r sits at chunk
// c ^ (r % 8), so the eight rows of a fragment load hit distinct banks.  B
// tiles are K-major (a row of B's tile is 128 bytes of depth), which is the
// only layout wgmma takes for TF32 operands in shared memory; each tile
// starts on 1024 bytes (the swizzle's period).
//
// The tensor maps are encoded on the host for each call
// (cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint: the
// library is linked without libcuda) and passed to the kernels as
// __grid_constant__ parameters.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no libcuda link

#include "common.cuh"

namespace tpunmf {
namespace hop {

// ------------------------------------------------------------------ host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A map of the row-major (rows, cols) array at p, row stride ld elements of
// T (float or bf16), copied in boxes of box_rows x box_cols with the
// 128-byte swizzle (box_cols * sizeof(T) == 128).  Reads past the array's
// edges give zeros.  cudaErrorInvalidValue where TMA cannot describe the
// array (a base or row stride off 16 bytes).
template <typename T>
cudaError_t make_map(CUtensorMap* map, const T* p, long long rows, long long cols, long long ld,
                     int box_rows, int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0 || (ld * (long long)sizeof(T)) % 16 != 0)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * (long long)sizeof(T))};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType type = std::is_same_v<T, float> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(map, type, 2, const_cast<T*>(p), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- device
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// One arrival, and `bytes` more to come from TMA copies in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// The box of `map` at (c0 (column), c1 (row)) into dst, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// 4 bytes from src (4-byte aligned) to dst, of which the first `bytes` (0,
// 2 or 4) are read and the rest zero-filled: an asynchronous copy that
// spends no registers.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
// One arrival on bar once this thread's earlier cp.async copies have landed
// (counted in the barrier's expected arrivals: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// The descriptor of a K-major B tile at p (1024-byte aligned) with the
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO 64 x 16 bytes).  The
// depth advances inside the swizzle's 128 bytes by adding (bytes >> 4).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3ffff) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
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
// Register budgets of a warpgroup (all its warps execute it): the
// producer gives registers back, the consumers take them.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Keeps the compiler from moving accesses of d across a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TPUNMF_D8(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define TPUNMF_D64                                                                         \
  TPUNMF_D8(0), TPUNMF_D8(8), TPUNMF_D8(16), TPUNMF_D8(24), TPUNMF_D8(32), TPUNMF_D8(40), \
      TPUNMF_D8(48), TPUNMF_D8(56)
#define TPUNMF_R64                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "     \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "     \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
  "{%64, %65, %66, %67}, %69, p, 1, 1"

// d (+)= A B, m64n128k8: A (64 x 8 TF32) from registers in the fragment
// layout of mma.m16n8k8 (warp w of the warpgroup holds rows 16w..16w+15),
// B from a K-major shared tile; scale_d = 0 ignores d's old values.  d is
// the m64n128 accumulator: d[i] at row 16w + g + 8((i >> 1) & 1), column
// 8(i >> 2) + 2t + (i & 1), lane = 4g + t.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " TPUNMF_R64 ";\n}\n"
      : TPUNMF_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
}

// The same with bf16 operands, m64n128k16 (A in mma.m16n8k16's layout:
// four registers of two bf16, the lower depth in the low half).
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TPUNMF_R64 ", 0;\n}\n"
      : TPUNMF_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
}

#undef TPUNMF_R64
#undef TPUNMF_D64
#undef TPUNMF_D8

}  // namespace hop
}  // namespace tpunmf
