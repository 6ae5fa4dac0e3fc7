// Fused objective passes: 0.5 * ||X - WH||_F^2, the masked KL sum, the
// masked KL sum together with the ratio X / (WH + eps), and the ratio alone.
//
// Replaces the Pallas kernels of tpunmf/ops/fused.py: _eu_obj_kernel (body
// :76, pallas_call :136, entry eu_residual_obj :233), _kl_obj_kernel (body
// :93, pallas_call :204, entry kl_obj :220), _kl_ratio_obj_kernel (body
// :106, pallas_call :175, entry kl_ratio_and_obj :253) and _kl_ratio_kernel
// (body :88, pallas_call :156, entry kl_ratio :243).
//
// All four passes run one body, pass_kernel: S = W H on the tensor cores
// (tf32x3.cuh's S tile in 3xTF32, two-stage cp.async copies of W and H) on
// 128 x 128 output tiles, which halve the bytes of W and H each tile reads
// from the L2 against 64 x 64; S is staged through shared memory so that X
// is read with 16-byte loads, all of a thread's in flight at once, and the
// ratio written with 16-byte coalesced stores, both marked streaming (evict
// first) so that W and H stay in the L2.  The objectives (Pass::kEu,
// Pass::kKl) store no ratio and sum their terms; the ratio passes
// (Pass::kKlRatio, Pass::kRatio) also write one f32 per cell.  One body
// means kl_ratio's ratio is kl_ratio_and_obj's bit for bit, and kl_obj's
// sum is kl_ratio_and_obj's bit for bit: the same tiles, the same order of
// terms in each thread (four cells of a row, then the thread's next four),
// the same partials and fixed-order sum.  A zero x takes neither the
// division's slow path nor the log (div_zero_first, kl_term_sparse: the
// same bits).
//
// Bound on the H100, with the products counted at 3xTF32 (165 TFLOP/s of
// f32 work) and 3.35 TB/s: an objective reads X (m*n elements) against
// 2*m*n*k flops of W H, so the products bind at k 128 (8192 x 8192: 0.104
// ms against 0.080 of reading X; config[3]'s 50000 x 20000: 1.552 ms) and
// bytes at config[1]'s k 50 (20000 x 11000: 0.265 ms); the ratio passes
// also write the ratio, so at config[3] the read of X and the write, 8.04
// GB, take 2.399 ms against 1.552 ms of products, and at MUR's high rank
// (8192 x 4096, k 1536) the products bind, 0.625 ms.
//
// Sums: the TPU added into one SMEM scalar across its sequential grid; here
// each block writes one partial and a second kernel adds the partials in a
// fixed order (in double), so the result does not depend on block
// scheduling.  No float atomics.  The ratio alone sums nothing.
//
// KL masking follows tpunmf/core/losses.py:20-25 exactly: the log has no eps,
// +inf is zeroed before NaN, and -x + wh is summed for every cell.  This file
// must not be built with --use_fast_math (logf, division and denormals must
// stay IEEE for that masking, and the ratio's division must be IEEE too).
#include "common.cuh"
#include "tf32x3.cuh"

namespace tpunmf {
namespace {

// What a pass computes per cell: the EU or KL term summed into a partial,
// the KL term and the ratio, or the ratio alone.
enum class Pass { kEu, kKl, kKlRatio, kRatio };

// A block's f32 partial (one value per thread) summed in a fixed order into
// partials[block]; every thread of the block must call it.
__device__ __forceinline__ void write_partial(float v, float* __restrict__ partials) {
  __shared__ float red[kThreads];
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride /= 2) {
    if (tid < stride) red[tid] += red[tid + stride];
    __syncthreads();
  }
  if (tid == 0) partials[(long long)blockIdx.y * gridDim.x + blockIdx.x] = red[0];
}

// -------------------------------------------------------------- the passes
constexpr int kPassTile = 128;  // the block's output tile, both ways
using PassS = tc::STile<kPassTile, kPassTile, 2, 4>;  // warps 2 x 4, 64 x 32 each
constexpr int kPassLd = kPassTile + 8;                 // S staged: row stride

// Dynamic shared memory of a block: the S tile's staging, then (reused) S
// itself for the epilogue.
union PassSmem {
  PassS::Stage stage;
  alignas(16) float s[kPassTile * kPassLd];
};

// Four cells of X from global memory (read once: streaming loads).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(q.x << 16);  // a bf16 is the high half of its float
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// The term a summing pass adds for one cell: (x - wh)^2, or the masked KL
// term of the raw wh (tpunmf/ops/fused.py:76-80, 88-90, 113-119).
template <Pass P>
__device__ __forceinline__ float cell_term(float xv, float wh) {
  if constexpr (P == Pass::kEu) {
    const float d = xv - wh;
    return d * d;
  } else {
    return kl_term_sparse(xv, wh);
  }
}

// One 128 x 128 tile of pass P: ratio[cell] = x / (wh + eps) where it
// stores, and its cells' terms summed into partials[block] where it sums,
// four cells at a time as ((t0 + t1) + t2) + t3 (cells past n add 0).
// `vec`: n % 4 == 0 and X (and the ratio) start on 16 bytes, so that a
// tile inside X goes by 16-byte loads and stores; `w_aligned` /
// `h_aligned` as tc::s_tile takes them.
template <typename XT, Pass P>
__global__ void __launch_bounds__(kThreads, 2)
    pass_kernel(const XT* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ h, int m, int n, int k, float eps, bool vec,
                bool w_aligned, bool h_aligned, float* __restrict__ ratio,
                float* __restrict__ partials) {
  constexpr bool kStore = P == Pass::kKlRatio || P == Pass::kRatio, kSums = P != Pass::kRatio;
  extern __shared__ float4 smem_raw[];
  PassSmem& sm = *reinterpret_cast<PassSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.y * kPassTile, col0 = blockIdx.x * kPassTile;

  // EU's S rounded at every step: 0.5 ||X - W H||^2 cancels near
  // convergence, where the tensor cores' own accumulation would cost it
  // digits
  tc::Acc<PassS::MT, PassS::NT> s;
  tc::s_tile<kPassTile, kPassTile, 2, 4, P == Pass::kEu>(s, w, h, m, n, k, row0, col0,
                                                        w_aligned, h_aligned,
                                                        sm.stage);  // ends with a barrier
  tc::for_pairs<PassS::MT, PassS::NT>(
      s, PassS::warp_row(warp), PassS::warp_col(warp), lane,
      [&](int r, int c, float v0, float v1) {
        *reinterpret_cast<float2*>(sm.s + r * kPassLd + c) = make_float2(v0, v1);
      });
  __syncthreads();

  float sum = 0.f;
  constexpr int PIECES = kPassTile * kPassTile / 4, PER = PIECES / kThreads;
  if (vec && row0 + kPassTile <= m && col0 + kPassTile <= n) {
    // a whole tile: every load of X in flight at once (S is in shared
    // memory, so the accumulators' registers are free), then the epilogue
    float xv[PER][4];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int p = tid + j * kThreads, r = p / (kPassTile / 4), c = p % (kPassTile / 4) * 4;
      load4(x + (long long)(row0 + r) * n + col0 + c, xv[j]);
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int p = tid + j * kThreads, r = p / (kPassTile / 4), c = p % (kPassTile / 4) * 4;
      const float4 sv = *reinterpret_cast<const float4*>(sm.s + r * kPassLd + c);
      if constexpr (kStore)
        __stcs(reinterpret_cast<float4*>(ratio + (long long)(row0 + r) * n + col0 + c),
               make_float4(div_zero_first(xv[j][0], sv.x + eps),
                           div_zero_first(xv[j][1], sv.y + eps),
                           div_zero_first(xv[j][2], sv.z + eps),
                           div_zero_first(xv[j][3], sv.w + eps)));
      if constexpr (kSums)
        sum += ((cell_term<P>(xv[j][0], sv.x) + cell_term<P>(xv[j][1], sv.y)) +
                cell_term<P>(xv[j][2], sv.z)) +
               cell_term<P>(xv[j][3], sv.w);
    }
  } else {
    // a tile on the edge of X, or rows off 16 bytes: cell by cell
    for (int p = tid; p < PIECES; p += kThreads) {
      const int r = p / (kPassTile / 4), c = p % (kPassTile / 4) * 4;
      const int gr = row0 + r, gc = col0 + c;
      if (gr >= m || gc >= n) continue;
      const float* sv = sm.s + r * kPassLd + c;
      const long long cell = (long long)gr * n + gc;
      float tv[4] = {0.f, 0.f, 0.f, 0.f};
      for (int v = 0; v < 4 && gc + v < n; ++v) {
        const float xs = to_f32(x[cell + v]);
        if constexpr (kStore) ratio[cell + v] = div_zero_first(xs, sv[v] + eps);
        if constexpr (kSums) tv[v] = cell_term<P>(xs, sv[v]);
      }
      if constexpr (kSums) sum += ((tv[0] + tv[1]) + tv[2]) + tv[3];
    }
  }
  if constexpr (kSums) write_partial(sum, partials);
}

// out[0] = scale * sum(partials), summed in double in a fixed order.
__global__ void __launch_bounds__(kThreads)
    reduce_partials(const float* __restrict__ partials, int count, float scale,
                    float* __restrict__ out) {
  __shared__ double red[kThreads];
  const int tid = threadIdx.x;
  double s = 0.0;
  for (int i = tid; i < count; i += kThreads) s += partials[i];
  red[tid] = s;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride /= 2) {
    if (tid < stride) red[tid] += red[tid + stride];
    __syncthreads();
  }
  if (tid == 0) out[0] = (float)(scale * red[0]);
}

template <typename XT, Pass P>
cudaError_t launch_pass(const void* xv, const float* w, const float* h, int m, int n, int k,
                        float eps, float* ratio, float* partials, float* out,
                        cudaStream_t stream) {
  constexpr bool kStore = P == Pass::kKlRatio || P == Pass::kRatio;
  const XT* x = static_cast<const XT*>(xv);
  const dim3 grid(ceil_div(n, kPassTile), ceil_div(m, kPassTile));
  const bool vec = n % 4 == 0 && aligned16(x) && (!kStore || aligned16(ratio));
  const cudaError_t err =
      launch(pass_kernel<XT, P>, grid, sizeof(PassSmem), stream, x, w, h, m, n, k, eps, vec,
             k % 4 == 0 && aligned16(w), n % 4 == 0 && aligned16(h), ratio, partials);
  if (err != cudaSuccess || P == Pass::kRatio) return err;
  return reduce_partials_into(partials, grid.x * grid.y, P == Pass::kEu ? 0.5f : 1.f, out,
                              stream);
}

// The pass on X of either storage type; the C entries below call this.
template <Pass P>
int run_pass(const void* x, int x_is_bf16, const void* w, const void* h, int m, int n, int k,
             float eps, void* ratio, void* partials, void* out, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* hf = static_cast<const float*>(h);
  float* r = static_cast<float*>(ratio);
  float* p = static_cast<float*>(partials);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = x_is_bf16
                        ? launch_pass<__nv_bfloat16, P>(x, wf, hf, m, n, k, eps, r, p, o, s)
                        : launch_pass<float, P>(x, wf, hf, m, n, k, eps, r, p, o, s);
  return static_cast<int>(err);
}

}  // namespace

cudaError_t reduce_partials_into(const float* partials, int count, float scale, float* out,
                                 cudaStream_t stream) {
  reduce_partials<<<1, kThreads, 0, stream>>>(partials, count, scale, out);
  return cudaGetLastError();
}

}  // namespace tpunmf

extern "C" {

// m, n -> length of the partials buffer tpunmf_kl_ratio_obj needs: one a
// 128 x 128 tile.
int tpunmf_ratio_blocks(int m, int n) {
  using tpunmf::kPassTile;
  return ((m + kPassTile - 1) / kPassTile) * ((n + kPassTile - 1) / kPassTile);
}

// m, n -> length of the partials buffer tpunmf_objective needs: the same
// tiles.
int tpunmf_objective_blocks(int m, int n) { return tpunmf_ratio_blocks(m, n); }

// 0.5*||X - WH||^2 (is_kl = 0) or the masked KL sum (is_kl = 1) into out[0].
// partials holds tpunmf_objective_blocks(m, n) floats of scratch.
int tpunmf_objective(const void* x, int x_is_bf16, const void* w, const void* h, int m,
                     int n, int k, int is_kl, void* partials, void* out, void* stream) {
  using tpunmf::Pass;
  return is_kl ? tpunmf::run_pass<Pass::kKl>(x, x_is_bf16, w, h, m, n, k, 0.f, nullptr,
                                             partials, out, stream)
               : tpunmf::run_pass<Pass::kEu>(x, x_is_bf16, w, h, m, n, k, 0.f, nullptr,
                                             partials, out, stream);
}

// ratio (m x n f32) = X / (WH + eps) and the masked KL sum into out[0], from
// one pass; partials holds tpunmf_ratio_blocks(m, n) floats of scratch.
int tpunmf_kl_ratio_obj(const void* x, int x_is_bf16, const void* w, const void* h, int m,
                        int n, int k, float eps, void* ratio, void* partials, void* out,
                        void* stream) {
  return tpunmf::run_pass<tpunmf::Pass::kKlRatio>(x, x_is_bf16, w, h, m, n, k, eps, ratio,
                                                  partials, out, stream);
}

// ratio (m x n f32) = X / (WH + eps) alone: one kernel, no scratch.
int tpunmf_kl_ratio(const void* x, int x_is_bf16, const void* w, const void* h, int m, int n,
                    int k, float eps, void* ratio, void* stream) {
  return tpunmf::run_pass<tpunmf::Pass::kRatio>(x, x_is_bf16, w, h, m, n, k, eps, ratio,
                                                nullptr, nullptr, stream);
}

}  // extern "C"
