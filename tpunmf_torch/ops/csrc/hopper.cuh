// Hopper's asynchronous copies and warpgroup products, for the stages of
// wave.cuh's TmaStages and topk_select.cu's scoring kernel: the Tensor
// Memory Accelerator (TMA) copies a tile of a 2-D array described by a
// tensor map from device memory into shared memory and reports the bytes
// to an mbarrier; wgmma multiplies a 64-row tile of A (here from
// registers) by a tile of B read from shared memory,
// asynchronously, into accumulator registers of a warpgroup (4 warps).
//
// Shared tiles are written by TMA with the 128-byte swizzle: a tile row of
// 128 bytes holds eight 16-byte chunks, and chunk c of row r sits at chunk
// c ^ (r % 8), so the eight rows of a fragment load hit distinct banks
// (int8 X's 64-byte rows: the 64-byte swizzle, chunk c of row r at c ^ ((r
// / 2) % 4)).  B tiles are K-major (a row of B's tile is 128 bytes of
// depth), which is the only layout wgmma takes for TF32 operands in shared
// memory; each tile starts on 1024 bytes (the swizzle's period).
//
// The tensor maps are encoded on the host for each call
// (cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint: the
// library is linked without libcuda) and passed to the kernels as
// __grid_constant__ parameters.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no libcuda link
#include <cuda_fp16.h>

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
// T (float, bf16, f16 or a byte), copied in boxes of box_rows x box_cols
// with the swizzle of the box's row (box_cols * sizeof(T): 128 or 64
// bytes).  Reads past the array's edges give zeros.  cudaErrorInvalidValue
// where TMA cannot describe the array (a base or row stride off 16 bytes).
template <typename T>
cudaError_t make_map(CUtensorMap* map, const T* p, long long rows, long long cols, long long ld,
                     int box_rows, int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int row_bytes = box_cols * (int)sizeof(T);
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0 || (ld * (long long)sizeof(T)) % 16 != 0 ||
      (row_bytes != 128 && row_bytes != 64))
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * (long long)sizeof(T))};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  static_assert(sizeof(T) == 4 || sizeof(T) == 2 || sizeof(T) == 1, "a 4-, 2- or 1-byte type");
  const CUtensorMapDataType type =
      std::is_same_v<T, float>           ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : std::is_same_v<T, __nv_bfloat16> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
      : std::is_same_v<T, __half>        ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUresult r = encode(map, type, 2, const_cast<T*>(p), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B,
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

// 16 bytes from src (16-byte aligned) to dst (16-byte aligned), of which
// the first `bytes` (0-16) are read and the rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
// One arrival on bar once this thread's earlier cp.async copies have landed
// (counted in the barrier's expected arrivals: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// ------------------------------------------------------- tiles in shared memory
// The byte offset of byte b (< ROW) of row r in a tile of ROW-byte rows
// (128 or 64) that TMA writes with the ROW-byte swizzle: the 16-byte chunk
// b / 16 XORed with the 128-byte line's index, 3 bits at 128 (r % 8), 2 at
// 64 ((r / 2) % 4).
// (Written out for each width: the TF32 consumers issue it for every
// fragment value, and a general form of it cost the f32 EU pass 5-11% on
// an H100 80GB HBM3 at 700 W.)
template <int ROW>
__device__ __forceinline__ int swizzled(int r, int b) {
  static_assert(ROW == 128 || ROW == 64, "the 128- or 64-byte swizzle");
  if constexpr (ROW == 128)
    return r * 128 + (((b >> 4) ^ (r & 7)) << 4) + (b & 15);
  else
    return r * 64 + (((b >> 4) ^ ((r >> 1) & 3)) << 4) + (b & 15);
}

// A tile of depth rows by 128 columns of a row-major array whose rows run
// along the columns (wave.cuh's stage (B) X, the scoring kernel's H), as
// TMA writes it in boxes of KC rows by 128 bytes of columns: the byte
// offset of element (d, j), ES bytes an element.
template <int ES, int KC>
__device__ __forceinline__ int cols_at(int d, int j) {
  constexpr int XC = 128 / ES;  // columns of a box
  return j / XC * (KC * 128) + swizzled<128>(d, (j % XC) * ES);
}

// The producer warpgroup's copy of a tile of an array that TMA cannot
// describe (rows that do not start on 16 bytes): tile rows [r0, r0 + R) of
// the row-major array x (ld elements of ES bytes a row), each as the NCH
// 16-byte chunks that cover its elements from c0 on, chunk c of tile row ra
// at st + ra * RB + 16 c, so that the row's first element lies
// shifted_at's delta bytes into the row.  Bytes at or past the row's
// element c_end, and rows at or past r_end, are zeros (src-size); a first
// chunk may start up to 15 bytes before x (inside its allocation, whose
// start is aligned).  The thread's copies are counted on bar as they land.
// Whole 16-byte copies (cp.async), where 4-byte copies of the elements ran
// at about a third of TMA's rate on an H100 80GB HBM3 at 700 W.
template <int ES, int R, int NCH, int RB>
__device__ __forceinline__ void copy_rows(uint8_t* st, const void* x, long long ld, int r0,
                                          int r_end, long long c0, long long c_end, int p,
                                          uint64_t* bar) {
  const char* base = static_cast<const char*>(x);
  const char* any = reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(base) &
                                                  ~static_cast<uintptr_t>(15));
  for (int l = p; l < R * NCH; l += 128) {
    const int ra = l / NCH, c = l % NCH, gr = r0 + ra;
    const char* row = base + (long long)gr * ld * ES;
    const char* src = reinterpret_cast<const char*>(
                          reinterpret_cast<uintptr_t>(row + c0 * ES) & ~static_cast<uintptr_t>(15)) +
                      16 * c;
    const long long left = gr < r_end ? row + c_end * ES - src : 0;
    const int bytes = left <= 0 ? 0 : left < 16 ? (int)left : 16;
    cp_async16(st + ra * RB + 16 * c, bytes > 0 ? src : any, bytes);
  }
  cp_async_arrive(bar);
}

// The byte offset of element e of tile row ra in a copy_rows tile, the
// row's first element at address `first` (mod 16 is all that counts, so
// 32-bit sums of addresses do).
template <int ES, int RB>
__device__ __forceinline__ int shifted_at(int ra, uint32_t first, int e) {
  return ra * RB + (int)(first & 15u) + e * ES;
}

// Two int8 values (the low two bytes of v, the first in the low byte) as a
// bf16 pair, exactly (|x| <= 128 has at most 8 significant bits): x + 128
// as an unsigned byte is put under the exponent of 2^23 and 2^23 + 128 is
// taken away in f32; the bf16 is the f32's upper half.  Integer and f32
// work only, none on the conversion pipe.
__device__ __forceinline__ uint32_t bf16x2_of_s8x2(uint32_t v) {
  const uint32_t y = v ^ 0x8080u;
  const float lo = __uint_as_float(__byte_perm(y, 0x4B000000u, 0x7650)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(y, 0x4B000000u, 0x7651)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The `threads` threads that reach barrier `id` (1-15; 0 is __syncthreads)
// wait for each other.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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

// The same at m64n64 (d: 32 accumulators, d[i] at row 16w + g + 8((i >>
// 1) & 1), column 8(i >> 2) + 2t + (i & 1)): TF32 (k8) and 16-bit (k16,
// bf16 or, with F16, f16) operands.
#define TPUNMF_D32 TPUNMF_D8(0), TPUNMF_D8(8), TPUNMF_D8(16), TPUNMF_D8(24)
#define TPUNMF_R32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "    \
  "{%32, %33, %34, %35}, %37, p, 1, 1"

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " TPUNMF_R32 ";\n}\n"
      : TPUNMF_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
}

template <bool F16>
__device__ __forceinline__ void wgmma_16_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
  if constexpr (F16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " TPUNMF_R32 ", 0;\n}\n"
        : TPUNMF_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TPUNMF_R32 ", 0;\n}\n"
        : TPUNMF_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
}

#undef TPUNMF_R32
#undef TPUNMF_D32
#undef TPUNMF_R64
#undef TPUNMF_D64
#undef TPUNMF_D8

}  // namespace hop
}  // namespace tpunmf
