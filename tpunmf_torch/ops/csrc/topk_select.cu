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
// score_blockmax_relayout computes S = W H (W b x r, H r x n, each float32,
// bfloat16 or float16; f32 accumulation and output) and applies the same
// epilogue, so the b x n scores never reach device memory: it reads H once
// and writes s3.  At (64, 128) x (128, 2^20) f32 the bytes bind it on the
// H100 (H read, 537 MB, and s3 written, 268 MB: 0.24 ms at 3.35 TB/s; the
// 3xTF32 products 0.10 ms at 495 TFLOP/s).  Design (score_tma_kernel), the
// stage (B) of wave.cuh's TmaStages with H in X's place: each tile is S^T
// = H^T W^T for 128 columns of H (the M of wgmma, two consumer warpgroups
// of 64) by 64 users (its N), depth r.  H's tile, KC depth rows by 128
// columns, arrives by TMA in 128-byte swizzled boxes and is wgmma's A
// operand from registers.  Where H's rows do not start on 16 bytes (n not a
// multiple of 4 at f32, of 8 at 16 bits: any catalog size can come), TMA
// cannot describe H; the producer warpgroup then copies each depth row of
// the tile as the 16-byte chunks that cover it (hop::copy_rows: cp.async,
// 33 or 17 a row, the row's first element some 0-15 bytes into its first
// chunk) and the consumers read there (hop::shifted_at).  H is never padded
// or copied by the wrapper: at the serving shape it is the stored 512 MB
// item matrix.  On an H100 80GB HBM3 at 700 W those rows took 1.7x TMA's
// time at f32 (2.6-3.6x as the 4-byte element copies that TmaStages had)
// and about TMA's at bf16.  W (b, r) is
// row-major, so it is already the K-major B operand, staged by TMA beside
// it.  Products: where W and H are both bf16 or both f16 (serving's
// quantized first stage), one 16-bit wgmma, exact in f32; else TF32: the
// wrapper splits W into its TF32 big and small parts (tf32x3.cuh's rule),
// f32 H is split in registers (3xTF32: small*big, big*small, big*big),
// 16-bit H is exact in TF32 (H*small, H*big).  Each stage's products go
// into a temporary added to the running sum in f32 with round to nearest
// (wave.cuh's rounded steps).  The depth is short (r 128 is 4 stages of
// f32), so the kernel is persistent: one block an SM walks the (sel
// block, user tile) items, and its producer runs ahead into the next
// item's stages while the consumers store the last one.  Epilogue: each
// score goes from the registers to s3 (finfo.min past n) and into its
// user's running block maximum (nan_max: within a thread, over the 8
// lanes of a fragment column by shuffles, then across the 8 warps in
// shared memory), so bmax is exactly the maximum of the stored block.
#include <cuda_fp16.h>

#include <cfloat>
#include <cstring>

#include "common.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace tpunmf {
namespace {

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

// ------------------------------------------------------ the scoring kernel
constexpr int kScoreThreads = 3 * 128;  // two consumer warpgroups, one producer warpgroup

// The tiles of score_tma_kernel.  K16: W and H both 16-bit of one type (one
// 16-bit wgmma); else TF32 products against W's big and small parts.
// TMA = false: H's tiles by hop::copy_rows, in a larger H tile.
template <typename HT, bool K16, bool TMA>
struct ScoreTile {
  static constexpr bool kSplitH = std::is_same_v<HT, float>;  // H split in registers
  static constexpr int ES = sizeof(HT);
  static constexpr int BM = 128, BN = 64;      // scores (H's columns) and users of a tile
  static constexpr int KC = K16 ? 64 : 32;      // depth of a stage: one 128-byte W row
  static constexpr int XC = 128 / ES;           // H's columns in a 128-byte box row
  static constexpr int STEPS = 4;               // wgmmas of 32 bytes of W's depth a stage
  // H's rows off 16 bytes: a row's covering chunks, and the bytes a row
  // takes (f32: 544, so that the 4 rows of a fragment load sit 8 banks
  // apart; 16 bits: 17 chunks, 4 banks apart, and K16 reads rows 2 apart)
  static constexpr int NCH = BM * ES / 16 + 1;
  static constexpr int RB = kSplitH ? 544 : NCH * 16;
  static constexpr int HBOXES = KC * BM * ES;  // bytes of TMA's boxes of H's tile
  // bytes of H's tile (TMA's boxes, or the shifted rows on 1024 bytes)
  static constexpr int HTILE = TMA ? HBOXES : (KC * RB + 1023) / 1024 * 1024;
  static constexpr int WTILE = BN * 128;        // bytes of a W tile
  static constexpr int WTILES = K16 ? 1 : 2;    // W, or its big and small parts
  static constexpr int STAGE = HTILE + WTILES * WTILE;
  static constexpr int STAGES = (200 << 10) / STAGE;
  static constexpr int RED = 2 * 8 * BN * 4;    // the maxima of the 8 warps, two buffers
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + RED + 1024;
};

// bmax (b, nbp) and s3 (b, nbp, sel) of S = W H (module comment).  hmap:
// H (r, n) in KC x XC boxes (tma; else the producer copies the rows'
// covering chunks from h); w0, w1: W (b, r) in BN x KC boxes, K16: in H's
// type (w1 unused), else W's TF32 big and small parts.  Items (blk, user
// tile) are walked with a stride of gridDim.x.  TMA and the row copies are
// kernels of their own, as wave.cuh's eu_tma_kernel.
template <typename HT, bool K16, bool TMA>
__global__ void __launch_bounds__(kScoreThreads, 1)
    score_tma_kernel(const __grid_constant__ CUtensorMap hmap,
                     const __grid_constant__ CUtensorMap w0,
                     const __grid_constant__ CUtensorMap w1, const HT* __restrict__ h, int b,
                     int r, int n, int nbp, int sel, float* __restrict__ bmax,
                     float* __restrict__ s3) {
  using T = ScoreTile<HT, K16, TMA>;
  extern __shared__ float4 smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;
  float* red = reinterpret_cast<float*>(empty + T::STAGES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int utiles = (b + T::BN - 1) / T::BN, items = nbp * utiles, subs = sel / T::BM;
  const int nst = (r + T::KC - 1) / T::KC;
  // H's rows off 16 bytes: element (d, c) lies at hb + (d n + c) ES
  const uint32_t hb = (uint32_t)reinterpret_cast<uintptr_t>(h), row_bytes = (uint32_t)n * T::ES;
  constexpr bool tma = TMA;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      hop::mbar_init(&full[s], tma ? 1 : 129);  // else: and each producer thread
      hop::mbar_init(&empty[s], 256);              // every consumer thread
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // ------------------------------------------- producer
    hop::setmaxnreg_dec<56>();
    const int p = threadIdx.x - 256;
    int s = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int blk = item / utiles, u0 = item % utiles * T::BN;
      for (int sub = 0; sub < subs; ++sub) {
        const long long col0 = (long long)blk * sel + sub * T::BM;
        if (col0 >= n) break;  // the rest of the block is padding: no products
        for (int kk = 0; kk < nst; ++kk, ++s) {
          const int slot = s % T::STAGES, d = kk * T::KC;
          uint8_t* st = smem + slot * T::STAGE;
          if (p == 0 || !tma) hop::mbar_wait(&empty[slot], ((s / T::STAGES) & 1) ^ 1);
          if (p == 0) {
            hop::mbar_arrive_expect_tx(&full[slot],
                                       T::WTILES * T::WTILE + (tma ? T::HBOXES : 0));
            hop::tma_load(st + T::HTILE, &w0, &full[slot], d, u0);
            if constexpr (!K16) hop::tma_load(st + T::HTILE + T::WTILE, &w1, &full[slot], d, u0);
            if (tma) {
#pragma unroll
              for (int q = 0; q < T::BM / T::XC; ++q)
                hop::tma_load(st + q * T::KC * 128, &hmap, &full[slot], (int)col0 + q * T::XC,
                              d);
            }
          }
          if (!tma)  // depth rows past r: zeros; columns past n are not read
            hop::copy_rows<T::ES, T::KC, T::NCH, T::RB>(st, h, n, d, r, col0, n, p,
                                                        &full[slot]);
        }
      }
    }
  } else {  // ---------------------------------------------------- consumers
    hop::setmaxnreg_inc<224>();
    const int g = lane >> 2, t = lane & 3, ct = threadIdx.x;
    const int row = 64 * (warp >> 2) + 16 * (warp & 3) + g;  // the thread's first score column
    const long long width = (long long)nbp * sel;
    int s = 0, buf = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int blk = item / utiles, u0 = item % utiles * T::BN;
      float run = -INFINITY;  // thread ct < 64: user u0 + ct's maximum of the block so far
      for (int sub = 0; sub < subs; ++sub) {
        const long long col0 = (long long)blk * sel + sub * T::BM;
        float acc[32], tmp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        const uint32_t first0 = hb + (uint32_t)col0 * T::ES;
        for (int kk = 0; col0 < n && kk < nst; ++kk, ++s) {
          const int slot = s % T::STAGES;
          hop::mbar_wait(&full[slot], (s / T::STAGES) & 1);
          const uint8_t* st = smem + slot * T::STAGE;
          // byte offset of element (d, j) of the stage's H tile
          auto at = [&](int d, int j) {
            if constexpr (TMA)
              return hop::cols_at<T::ES, T::KC>(d, j);
            else
              return hop::shifted_at<T::ES, T::RB>(
                  d, first0 + (uint32_t)(kk * T::KC + d) * row_bytes, j);
          };
          const uint64_t wb = hop::desc_sw128(st + T::HTILE);
          if constexpr (K16) {
            uint32_t a[T::STEPS][4];
#pragma unroll
            for (int q = 0; q < T::STEPS; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e) {  // pairs (g, 2t), (g+8, 2t), (g, 2t+8), (g+8, 2t+8)
                const int j = row + 8 * (e & 1), d = 16 * q + 2 * t + 8 * (e >> 1);
                const uint32_t lo = *reinterpret_cast<const uint16_t*>(st + at(d, j));
                const uint32_t hi = *reinterpret_cast<const uint16_t*>(st + at(d + 1, j));
                a[q][e] = lo | hi << 16;
              }
            hop::wgmma_fence();
#pragma unroll
            for (int q = 0; q < T::STEPS; ++q)
              hop::wgmma_16_n64<std::is_same_v<HT, __half>>(tmp, a[q], wb + 2 * q, q > 0);
          } else {
            const uint64_t ws = hop::desc_sw128(st + T::HTILE + T::WTILE);
            uint32_t ab[T::STEPS][4], as[T::STEPS][4];
#pragma unroll
            for (int q = 0; q < T::STEPS; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e) {  // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
                const int j = row + 8 * (e & 1), d = 8 * q + t + 4 * (e >> 1);
                const float v = load_f32(reinterpret_cast<const HT*>(st + at(d, j)));
                if constexpr (T::kSplitH)
                  tc::split(v, ab[q][e], as[q][e]);
                else
                  ab[q][e] = __float_as_uint(v);  // exact in TF32
              }
            hop::wgmma_fence();
#pragma unroll
            for (int q = 0; q < T::STEPS; ++q) {
              if constexpr (T::kSplitH) {
                hop::wgmma_tf32_n64(tmp, as[q], wb + 2 * q, q > 0);
                hop::wgmma_tf32_n64(tmp, ab[q], ws + 2 * q, 1);
              } else {
                hop::wgmma_tf32_n64(tmp, ab[q], ws + 2 * q, q > 0);
              }
              hop::wgmma_tf32_n64(tmp, ab[q], wb + 2 * q, 1);
            }
          }
          hop::wgmma_commit();
          hop::wgmma_wait_all();
          hop::pin(tmp);
          hop::mbar_arrive(&empty[slot]);
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] += tmp[i];
        }

        // s3 from the registers, and each user's maximum over the tile:
        // d[i] is score column row + 8((i >> 1) & 1), user 8(i >> 2) + 2t + (i & 1)
        float um[16];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const long long gj = col0 + row + 8 * ((i >> 1) & 1);
          const int gu = u0 + 8 * (i >> 2) + 2 * t + (i & 1), slot = (i >> 2) * 2 + (i & 1);
          const float v = gj < n ? acc[i] : -FLT_MAX;
          if (gu < b) s3[gu * width + gj] = v;
          um[slot] = (i >> 1) & 1 ? nan_max(um[slot], v) : v;
        }
        float* rb = red + buf * 8 * T::BN;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)  // the 8 lanes g of a fragment column
            um[j] = nan_max(um[j], __shfl_xor_sync(0xffffffffu, um[j], off));
          if (g == 0) rb[warp * T::BN + 8 * (j >> 1) + 2 * t + (j & 1)] = um[j];
        }
        hop::named_sync(1, 256);
        if (ct < T::BN) {
#pragma unroll
          for (int w = 0; w < 8; ++w) run = nan_max(run, rb[w * T::BN + ct]);
        }
        buf ^= 1;
      }
      if (ct < T::BN && u0 + ct < b) bmax[(long long)(u0 + ct) * nbp + blk] = run;
    }
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

// One launch of score_tma_kernel<HT, K16>: W's operands w0, w1 (b, ldw),
// ldw * sizeof a multiple of 16 bytes; one block an SM, at most one an item.
template <typename HT, bool K16>
cudaError_t launch_score(const void* w0, const void* w1, int ldw, const void* h, int b, int r,
                         int n, int nbp, int sel, float* bmax, float* s3, cudaStream_t stream) {
  using T = ScoreTile<HT, K16, true>;
  using WT = std::conditional_t<K16, HT, float>;
  const HT* hh = static_cast<const HT*>(h);
  const long long row = (long long)n * sizeof(HT);
  const bool tma = aligned16(hh) && row % 16 == 0;
  CUtensorMap hmap, wm0, wm1;
  std::memset(&hmap, 0, sizeof(hmap));
  cudaError_t err = hop::make_map(&wm0, static_cast<const WT*>(w0), b, r, ldw, T::BN, T::KC);
  if (err == cudaSuccess)
    err = hop::make_map(&wm1, static_cast<const WT*>(K16 ? w0 : w1), b, r, ldw, T::BN, T::KC);
  if (err == cudaSuccess && tma)
    err = hop::make_map(&hmap, hh, r, n, n, T::KC, T::XC);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kernel = tma ? score_tma_kernel<HT, K16, true> : score_tma_kernel<HT, K16, false>;
  const int smem = tma ? T::SMEM : ScoreTile<HT, K16, false>::SMEM;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int items = nbp * ceil_div(b, T::BN);
  kernel<<<items < sms ? items : sms, kScoreThreads, smem, stream>>>(
      hmap, wm0, wm1, hh, b, r, n, nbp, sel, bmax, s3);
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

// w @ h (h (r x n): h_dtype 0 float32, 1 bfloat16, 2 float16) -> bmax (b x
// nbp) and s3 (b x nbp x sel), float32.  W (b x r) comes as its operands,
// rows of ldw elements on 16 bytes: w16 = 1, W in H's 16-bit type (w0; w1
// unused); w16 = 0, W's TF32 big (w0) and small (w1) parts, float32.
int tpunmf_score_blockmax(const void* w0, const void* w1, int ldw, const void* h, int h_dtype,
                          int w16, int b, int r, int n, int nbp, int sel, void* bmax, void* s3,
                          void* stream) {
  using namespace tpunmf;
  float* bm = static_cast<float*>(bmax);
  float* out = static_cast<float*>(s3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (h_dtype == 1)
    err = w16 ? launch_score<__nv_bfloat16, true>(w0, w1, ldw, h, b, r, n, nbp, sel, bm, out, s)
              : launch_score<__nv_bfloat16, false>(w0, w1, ldw, h, b, r, n, nbp, sel, bm, out, s);
  else if (h_dtype == 2)
    err = w16 ? launch_score<__half, true>(w0, w1, ldw, h, b, r, n, nbp, sel, bm, out, s)
              : launch_score<__half, false>(w0, w1, ldw, h, b, r, n, nbp, sel, bm, out, s);
  else
    err = w16 ? cudaErrorInvalidValue
              : launch_score<float, false>(w0, w1, ldw, h, b, r, n, nbp, sel, bm, out, s);
  return static_cast<int>(err);
}

}  // extern "C"
