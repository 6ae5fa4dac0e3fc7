// Block maxima + relayout for the verified-exact serving top-k, alone and
// fused behind the scoring product.
//
// Replaces the Pallas kernels of tpunmf/ops/topk_select.py: _bmax_kernel
// (body :71, pallas_call :97, entry blockmax_relayout :77) and
// _score_bmax_kernel (body :118, pallas_call :188, entry
// score_blockmax_relayout :156).  Both give, for scores S (b x n):
//   s3   (b, nbp, sel): S row by row, padded with the dtype's lowest finite
//        value (finfo.min, not -inf: tpunmf/ops/topk_select.py:17-19) up to
//        nbp * sel columns, nbp = ceil(n / (128 * sel)) * 128;
//   bmax (b, nbp)     : the maximum of each sel-wide block of s3, NaN if the
//        block holds a NaN (tpunmf/serve/topk.py:160-163), so fmaxf is not
//        used.
//
// blockmax_relayout is bound by bytes.  On the TPU the relayout was a real
// data movement (lanes to sublanes); on the card a row-major (b, n) array and
// its (b, nbp, sel) view are the same bytes whenever nbp * sel == n (n = 2^20
// at the serving shape).  There the wrapper returns s3 as a view of S and the
// kernel reads S once and writes only bmax: its bound is the read.  Where the
// blocks overhang n, s3 is a fresh padded copy that the same kernel writes as
// it reads (one read plus one write).  Design (blockmax_kernel): a group of
// 32 / E lanes owns a 128-column piece of a block, E the values of a 16-byte
// load (4 f32, 8 bf16, 2 f64), so a lane starts 4 independent 16-byte loads
// a piece before its first comparison; a warp takes E blocks a step and
// walks a run of 32 consecutive blocks, one run a warp (2048 blocks of 8
// warps at the serving shape).  The group reduces with shuffles, the 32
// maxima of a run are gathered one to a lane and the warp writes them with
// one coalesced store.  Scores whose base or row length is not on 16 bytes
// take the same schedule with scalar loads; s3's stores are always 16 bytes.
//
// score_blockmax_relayout computes S = W H (W b x r float32, H r x n float32,
// bfloat16 or float16, f32 FMA accumulation and output: products of two
// 16-bit values are exact in f32) and applies the same epilogue, so the b x n
// scores never reach device memory: it reads H once per 64-row tile of W and
// writes s3.  At b = 64 it does 2 * 64 = 128 flops per element of H, above
// the card's f32 FMA ridge, so the FMA work bounds it.  Design: the
// shared-memory FMA tiling of common.cuh (a 64 x 128 tile per block step,
// 4 x 8 per thread, W and H staged kChunk deep), one block per (row tile,
// sel block), the block max kept per thread across the sel block's
// 128-column steps and reduced over the 16 threads of a row with shuffles.
// Steps that lie wholly in the padding skip the product.  Tensor cores are
// later work.
#include <cuda_fp16.h>

#include <cfloat>

#include "common.cuh"

namespace tpunmf {
namespace {

constexpr int kRowTile = 64;   // rows of W per block (16 * kSTM)
constexpr int kColStep = 128;  // columns of H per step (16 * kSTN)
constexpr int kSTM = 4, kSTN = 8;
constexpr int kWarps = kThreads / 32;

// the comparison type of a score type (bf16 compares exactly as float)
template <typename T> struct Cmp { using type = float; };
template <> struct Cmp<double> { using type = double; };

__device__ __forceinline__ float to_cmp(float v) { return v; }
__device__ __forceinline__ double to_cmp(double v) { return v; }
__device__ __forceinline__ float to_cmp(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_cmp(typename Cmp<T>::type v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_cmp<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // exact: v is a bf16 value
}

template <typename T> __device__ __forceinline__ T lowest();
template <> __device__ __forceinline__ float lowest<float>() { return -FLT_MAX; }
template <> __device__ __forceinline__ double lowest<double>() { return -DBL_MAX; }
template <> __device__ __forceinline__ __nv_bfloat16 lowest<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0xFF7Fu);  // torch.finfo(torch.bfloat16).min
}

// max that propagates NaN from either side
template <typename C>
__device__ __forceinline__ C nan_max(C a, C b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f32(const __half* p) { return __half2float(*p); }

// 16 bytes of scores: kE values of T
template <typename T>
struct alignas(16) Pack {
  static constexpr int kE = 16 / sizeof(T);
  T e[kE];
};

// the pack at p, of which the first `valid` values exist (at or past them:
// lowest<T>(), the padding of s3).  kVec: p is on 16 bytes and n % kE == 0,
// so a pack lies wholly inside the row or wholly past its end.
template <typename T, bool kVec>
__device__ __forceinline__ Pack<T> load_pack(const T* p, long long valid) {
  Pack<T> out;
  if (kVec && valid > 0) {
    *reinterpret_cast<uint4*>(&out) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int i = 0; i < Pack<T>::kE; ++i) out.e[i] = (!kVec && i < valid) ? p[i] : lowest<T>();
  }
  return out;
}

constexpr int kRun = 32;  // consecutive blocks a warp walks: one maximum a lane

// bmax[blk] = the maximum of sel-wide block blk of the scores, blk < blocks
// (= b * nbp).  kCopy: also s3[blk] = the block, padded past n; else s3 is
// the scores themselves (nbp * sel == n) and is not written.
template <typename T, bool kVec, bool kCopy>
__global__ void __launch_bounds__(kThreads)
    blockmax_kernel(const T* __restrict__ scores, int n, int nbp, int sel, long long blocks,
                    T* __restrict__ bmax, T* __restrict__ s3) {
  using C = typename Cmp<T>::type;
  constexpr int kE = Pack<T>::kE;
  constexpr int kGroup = 32 / kE;       // lanes of a block: 128 columns, 4 packs a lane
  constexpr int kPerStep = 32 / kGroup;  // blocks of a warp step
  constexpr int kU = 128 / (kGroup * kE);
  const int lane = threadIdx.x % 32, group = lane / kGroup, sub = lane % kGroup;
  const int packs = sel / (kGroup * kE);  // of a lane in a block: a multiple of kU
  // the warp's run; a warp past the last run leaves whole
  const long long run = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (run * kRun >= blocks) return;
  C mine = -INFINITY;  // the maximum of block run * kRun + lane
  for (int step = 0; step < kRun / kPerStep; ++step) {
    const long long blk = run * kRun + step * kPerStep + group;
    C m = -INFINITY;
    if (blk < blocks) {
      const long long row = kCopy ? blk / nbp : 0;
      const long long col0 = kCopy ? (blk - row * nbp) * sel : 0;
      const T* src = kCopy ? scores + row * n + col0 : scores + blk * sel;
      const long long valid = kCopy ? n - col0 : sel;
      for (int j0 = 0; j0 < packs; j0 += kU) {
        Pack<T> v[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int off = ((j0 + u) * kGroup + sub) * kE;
          v[u] = load_pack<T, kVec>(src + off, valid - off);
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (kCopy)  // s3 is fresh and sel % 128 == 0: every pack is on 16 bytes
            *reinterpret_cast<uint4*>(s3 + blk * sel + ((j0 + u) * kGroup + sub) * kE) =
                *reinterpret_cast<const uint4*>(&v[u]);
#pragma unroll
          for (int i = 0; i < kE; ++i) m = nan_max(m, to_cmp(v[u].e[i]));
        }
      }
    }
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    const C got = __shfl_sync(0xffffffffu, m, (lane % kPerStep) * kGroup);
    if (lane / kPerStep == step) mine = got;
  }
  const long long blk = run * kRun + lane;
  if (blk < blocks) bmax[blk] = from_cmp<T>(mine);
}

template <typename HT>
__global__ void __launch_bounds__(kThreads)
    score_blockmax_kernel(const float* __restrict__ w, const HT* __restrict__ h, int b, int r,
                          int n, int nbp, int sel, float* __restrict__ bmax,
                          float* __restrict__ s3) {
  constexpr int LDA = kRowTile + 1, LDB = kColStep + 1;
  __shared__ float as[kChunk * LDA];
  __shared__ float bs[kChunk * LDB];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.y * kRowTile;
  const long long blk = blockIdx.x, width = (long long)nbp * sel;

  float run_max[kSTM];
#pragma unroll
  for (int a = 0; a < kSTM; ++a) run_max[a] = -INFINITY;

  for (int sub = 0; sub < sel; sub += kColStep) {
    const long long col0 = blk * sel + sub;
    float acc[kSTM][kSTN];
    zero(acc);
    if (col0 < n) {  // the same for every thread of the block
      for (int k0 = 0; k0 < r; k0 += kChunk) {
        for (int l = tid; l < kChunk * kRowTile; l += kThreads) {
          const int rr = l / kChunk, kk = l % kChunk, gr = row0 + rr, gk = k0 + kk;
          as[kk * LDA + rr] = (gr < b && gk < r) ? w[(long long)gr * r + gk] : 0.f;
        }
        for (int l = tid; l < kChunk * kColStep; l += kThreads) {
          const int kk = l / kColStep, c = l % kColStep, gk = k0 + kk;
          const long long gc = col0 + c;
          bs[kk * LDB + c] = (gk < r && gc < n) ? load_f32(h + (long long)gk * n + gc) : 0.f;
        }
        __syncthreads();
        micro_gemm<kSTM, kSTN>(acc, as, LDA, bs, LDB, kChunk, ty, tx);
        __syncthreads();
      }
    }
#pragma unroll
    for (int a = 0; a < kSTM; ++a) {
      const int gr = row0 + ty + 16 * a;
#pragma unroll
      for (int j = 0; j < kSTN; ++j) {
        const long long gc = col0 + tx + 16 * j;
        const float v = gc < n ? acc[a][j] : -FLT_MAX;
        run_max[a] = nan_max(run_max[a], v);
        if (gr < b) s3[(long long)gr * width + gc] = v;
      }
    }
  }
  // the 16 threads of a row (tx) are 16 neighbouring lanes of one warp
#pragma unroll
  for (int a = 0; a < kSTM; ++a) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      run_max[a] = nan_max(run_max[a], __shfl_xor_sync(0xffffffffu, run_max[a], off));
    const int gr = row0 + ty + 16 * a;
    if (tx == 0 && gr < b) bmax[(long long)gr * nbp + blk] = run_max[a];
  }
}

template <typename T, bool kVec, bool kCopy>
cudaError_t launch_blockmax_as(const void* scores, int b, int n, int nbp, int sel, void* bmax,
                               void* s3, cudaStream_t stream) {
  const long long blocks = (long long)b * nbp;
  const long long runs = (blocks + kRun - 1) / kRun;  // one a warp
  const long long grid = (runs + kWarps - 1) / kWarps;
  blockmax_kernel<T, kVec, kCopy><<<(unsigned)grid, kThreads, 0, stream>>>(
      static_cast<const T*>(scores), n, nbp, sel, blocks, static_cast<T*>(bmax),
      static_cast<T*>(s3));
  return cudaGetLastError();
}

// s3 == nullptr: nbp * sel == n, s3 is the scores themselves, only bmax is
// written
template <typename T>
cudaError_t launch_blockmax(const void* scores, int b, int n, int nbp, int sel, void* bmax,
                            void* s3, cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(scores) % 16 == 0 && n % Pack<T>::kE == 0;
  if (s3 == nullptr)
    return vec ? launch_blockmax_as<T, true, false>(scores, b, n, nbp, sel, bmax, s3, stream)
               : launch_blockmax_as<T, false, false>(scores, b, n, nbp, sel, bmax, s3, stream);
  return vec ? launch_blockmax_as<T, true, true>(scores, b, n, nbp, sel, bmax, s3, stream)
             : launch_blockmax_as<T, false, true>(scores, b, n, nbp, sel, bmax, s3, stream);
}

template <typename HT>
cudaError_t launch_score(const float* w, const void* h, int b, int r, int n, int nbp, int sel,
                         float* bmax, float* s3, cudaStream_t stream) {
  const dim3 grid(nbp, ceil_div(b, kRowTile));
  score_blockmax_kernel<HT><<<grid, kThreads, 0, stream>>>(
      w, static_cast<const HT*>(h), b, r, n, nbp, sel, bmax, s3);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tpunmf

extern "C" {

// scores (b x n) -> bmax (b x nbp), s3 (b x nbp x sel), all of one dtype:
// 0 float32, 1 bfloat16, 2 float64.  sel is a multiple of 128.  s3 NULL:
// nbp * sel == n and s3 is a view of the scores; only bmax is written.
int tpunmf_blockmax_relayout(const void* scores, int dtype, int b, int n, int nbp, int sel,
                             void* bmax, void* s3, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = tpunmf::launch_blockmax<__nv_bfloat16>(scores, b, n, nbp, sel, bmax, s3, s);
  else if (dtype == 2)
    err = tpunmf::launch_blockmax<double>(scores, b, n, nbp, sel, bmax, s3, s);
  else
    err = tpunmf::launch_blockmax<float>(scores, b, n, nbp, sel, bmax, s3, s);
  return static_cast<int>(err);
}

// w (b x r float32) @ h (r x n; h_dtype 0 float32, 1 bfloat16, 2 float16)
// -> bmax (b x nbp) and s3 (b x nbp x sel), float32.
int tpunmf_score_blockmax(const void* w, const void* h, int h_dtype, int b, int r, int n,
                          int nbp, int sel, void* bmax, void* s3, void* stream) {
  const float* wf = static_cast<const float*>(w);
  float* bm = static_cast<float*>(bmax);
  float* out = static_cast<float*>(s3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (h_dtype == 1)
    err = tpunmf::launch_score<__nv_bfloat16>(wf, h, b, r, n, nbp, sel, bm, out, s);
  else if (h_dtype == 2)
    err = tpunmf::launch_score<__half>(wf, h, b, r, n, nbp, sel, bm, out, s);
  else
    err = tpunmf::launch_score<float>(wf, h, b, r, n, nbp, sel, bm, out, s);
  return static_cast<int>(err);
}

}  // extern "C"
