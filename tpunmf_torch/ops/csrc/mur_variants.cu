// The sweep scripts' single-pass EU variants: the MUR EU iteration at
// lam_w = 0 with three operand layouts or types.
//
// Replaces the Pallas kernels of benchmarks/:
//   v1_iter (sweep_iter2.py:38, pallas_call :43): _v1_kernel (:19), with
//       H^T pre-cast to X's type and handed in as an (n, k) array
//   v2_iter (sweep_iter2.py:92, pallas_call :98): _v2_kernel (:66), v1 with
//       the H update H' = H wtx / (gw H + eps) folded into its last grid step
//   iter_eu_int8 (sweep_int8.py:49, pallas_call :54): _iter_eu_int8_kernel
//       (:27), v1 on int8 X widened to bf16 (exactly), H and W' rounded to
//       bf16, the numerator and wtx scaled by the per-matrix s
//
//   W' = W * numer / (W Gh + eps), numer = X round(H)^T (int8: times s),
//   wtx = round(W')^T X (int8: times s), gram = W'^T W'   (round: to X's
//   type, bf16 for int8)
//
// What bounds them on the H100: the 4*m*n*k flops of products of
// mur_iteration_eu on one read of X (k to 2k flops per X byte at f32, 2k
// at bf16, 4k at int8).  All three run mur_iteration_eu's "dma" variant's
// stages (wave.cuh's TmaStages: TMA copies feeding wgmma, 3xTF32 at f32 X,
// bf16 products at bf16 and int8 X; kWaveEuTc's plan at their fill, all of
// X in one wave), where f32 X is bound by its products (165 TFLOP/s of f32
// work) and bf16 and int8 X by their bytes, X read twice (at 8192^2 r128,
// 134 and 67 MB a read).  The wrappers prepare H^T (v1, v2) or H (int8)
// into the same (k, n) factor operands as the dma variant's from H, so v1
// is that variant at lam_w = 0 bit for bit; int8 X widens to bf16 in
// registers (exact for |x| <= 127), so at s = 1 int8 is v1 on
// xq.to(bfloat16) bit for bit.
//
// On the card no block is "last": v2's H update is one more launch after the
// Gram, in stream order (a 64 x 64 FMA tile of gw H per block, k deep, with
// the elementwise epilogue), and int8's wtx is scaled by one elementwise
// launch at the end, as the JAX wrapper scales it outside its kernel
// (sweep_int8.py:75).  s is read from device memory: no call reads the
// host.  Every cross-block sum is per-block partials added in a fixed
// order.  Ragged edges load zeros; any (m, n) and k <= 1024 work.
#include "wave.cuh"

namespace tpunmf {
namespace {

// H' = H * wtx / (gw H + eps); grid (ceil(n / 64), ceil(k / 64)).
__global__ void __launch_bounds__(kThreads)
    h_update_kernel(const float* __restrict__ gw, const float* __restrict__ h,
                    const float* __restrict__ wtx, int n, int k, float* __restrict__ h_out) {
  __shared__ WhStage<4, 4> st;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int col0 = blockIdx.x * kTile, row0 = blockIdx.y * kTile;
  float hd[4][4];
  wh_tile<4, 4>(hd, gw, h, k, n, k, row0, col0, st);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int gr = row0 + ty + 16 * a, gc = col0 + tx + 16 * b;
      if (gr < k && gc < n) {
        const long long o = (long long)gr * n + gc;
        h_out[o] = h[o] * wtx[o] / (hd[a][b] + kEps);
      }
    }
}

// v[i] *= *s
__global__ void __launch_bounds__(kThreads)
    scale_kernel(float* __restrict__ v, const float* __restrict__ s, long long len) {
  const float sv = *s;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < len;
       i += (long long)gridDim.x * kThreads)
    v[i] *= sv;
}

// v1 and, where h_out is not null, v2's H update after it.
template <typename XT>
cudaError_t v_iter(const void* x, const void* f0, const void* f1, int ldh, const float* h,
                   const float* w, const float* gh, int m, int n, int k, float* w_out,
                   float* h_out, float* wtx, float* gram, float* scratch, long long scratch_len,
                   cudaStream_t s) {
  cudaError_t err = mur_eu_tma<XT>(x, f0, f1, ldh, w, gh, 0.f, nullptr, m, n, k, w_out, wtx,
                                   gram, scratch, scratch_len, s);
  if (err != cudaSuccess || h_out == nullptr) return err;
  return launch(h_update_kernel, dim3(ceil_div(n, kTile), ceil_div(k, kTile)), 0, s,
                static_cast<const float*>(gram), h, static_cast<const float*>(wtx), n, k, h_out);
}

int v_iter_any(const void* x, int x_is_bf16, const void* f0, const void* f1, int ldh,
               const void* h, const void* w, const void* gh, int m, int n, int k, void* w_out,
               void* h_out, void* wtx, void* gram, void* scratch, long long scratch_len,
               void* stream) {
  const float* hf = static_cast<const float*>(h);
  const float* wf = static_cast<const float*>(w);
  const float* gf = static_cast<const float*>(gh);
  float* wo = static_cast<float*>(w_out);
  float* ho = static_cast<float*>(h_out);
  float* tx = static_cast<float*>(wtx);
  float* gr = static_cast<float*>(gram);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      x_is_bf16 ? v_iter<__nv_bfloat16>(x, f0, f1, ldh, hf, wf, gf, m, n, k, wo, ho, tx, gr, sc,
                                        scratch_len, s)
                : v_iter<float>(x, f0, f1, ldh, hf, wf, gf, m, n, k, wo, ho, tx, gr, sc,
                                scratch_len, s));
}

}  // namespace
}  // namespace tpunmf

extern "C" {

// v1_iter.  f0, f1 and ldh: H's factor operands as
// tpunmf_mur_iteration_eu_dma takes them (the wrapper makes them from the
// pre-cast H^T); gh = H H^T (k, k); writes W' (m, k), wtx = round(W')^T X
// (k, n) and gram = W'^T W' (k, k).  scratch: scratch_len floats, at least
// tpunmf_eu_tma_scratch's (fewer: cudaErrorInvalidValue).
int tpunmf_v1_iter(const void* x, int x_is_bf16, const void* f0, const void* f1, int ldh,
                   const void* w, const void* gh, int m, int n, int k, void* w_out, void* wtx,
                   void* gram, void* scratch, long long scratch_len, void* stream) {
  return tpunmf::v_iter_any(x, x_is_bf16, f0, f1, ldh, nullptr, w, gh, m, n, k, w_out, nullptr,
                            wtx, gram, scratch, scratch_len, stream);
}

// v2_iter: v1_iter, then H' = H * wtx / (gram H + eps) (k, n) from H (k, n) f32.
int tpunmf_v2_iter(const void* x, int x_is_bf16, const void* f0, const void* f1, int ldh,
                   const void* h, const void* w, const void* gh, int m, int n, int k,
                   void* w_out, void* h_out, void* wtx, void* gram, void* scratch,
                   long long scratch_len, void* stream) {
  return tpunmf::v_iter_any(x, x_is_bf16, f0, f1, ldh, h, w, gh, m, n, k, w_out, h_out, wtx,
                            gram, scratch, scratch_len, stream);
}

// iter_eu_int8.  xq int8 (m, n); hb H rounded to bf16, (k, n) at row
// stride ldh (a multiple of 8: the factor operand of the bf16 dma variant);
// gh = H H^T; scale a device float.  Writes W' (m, k), wtx = s * bf16(W')^T
// xq (k, n) and gram = W'^T W'.  scratch holds scratch_len floats, at least
// tpunmf_eu_tma_scratch's at 1-byte X (fewer: cudaErrorInvalidValue).
int tpunmf_iter_eu_int8(const void* xq, const void* hb, int ldh, const void* w, const void* gh,
                        const void* scale, int m, int n, int k, void* w_out, void* wtx,
                        void* gram, void* scratch, long long scratch_len, void* stream) {
  using namespace tpunmf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sv = static_cast<const float*>(scale);
  float* tx = static_cast<float*>(wtx);
  cudaError_t err = mur_eu_tma<int8_t>(
      xq, hb, hb, ldh, static_cast<const float*>(w), static_cast<const float*>(gh), 0.f, sv, m,
      n, k, static_cast<float*>(w_out), tx, static_cast<float*>(gram),
      static_cast<float*>(scratch), scratch_len, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long len = (long long)k * n;
  return static_cast<int>(launch(scale_kernel, elementwise_grid(len), 0, s, tx, sv, len));
}

}  // extern "C"
