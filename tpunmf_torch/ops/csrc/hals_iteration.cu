// The single-pass HALS iteration: HALS's whole W half and the H numerator
// of one iteration from one read of X in device memory.
//
// Replaces the Pallas kernel of tpunmf/ops/hals_sweep.py: hals_iteration_eu
// (:186, pallas_call :203), body _hals_iter_kernel (:123).
//
//   xht = X round(H)^T, then nsweeps Gauss-Seidel sweeps over the k columns
//   of W against G = H H^T (eps 1e-16, tpunmf/solvers/hals.py:54-69),
//   wtx = round(W')^T X, gram = W'^T W'                 (round: to X's type)
//
// What bounds it on the H100: the two products against X, 4*m*n*k flops on
// one read of X, as mur_iteration.cu's EU iteration (0.208 ms at 8192 x
// 8192 r128 f32 with the products at 3xTF32); the sweeps add 2*nsweeps*m*k^2
// flops, a serial chain of k steps a row whose steps are bound by their
// latency, so the rows' chains have to run side by side to fill the card.
//
// Design: mur_iteration_eu's stages on the tensor cores (wave.cuh's
// TcStages: 128 x 128 tiles of 3xTF32 mma.sync, one TF32 product a step at
// bf16 X, every step's sum rounded to nearest), all of X in one wave (plan
// kind kWaveHals), with the elementwise W update replaced by a sweep
// epilogue: after (A) has written X round(H)^T in column-chunk partials,
// the launch after it in stream order (so every partial is written before
// a sweep reads it) runs gs_sweep's body (gs_panel.cuh: a block owns 64
// rows of W up to k 256, the k^2 work of each panel of 16 steps one
// tensor-core product against G, then a short chain of corrections, one
// thread a row) with A the rows' partials, added in a fixed order into the
// block's rows of W' before the sweeps, which overwrite them.  (B) then
// reads W'.  The Gram W'^T W' stays on FMA tiles.  No W Gh denominator is
// formed.  Not the TPU kernel's running p = W G with a rank-1 update a
// step: that one was slower on an H100 (1.014 against 0.954 ms a pass at
// 8192 x 8192 r128) and its p drifted past the card test's 1e-4 (6.4e-4
// at 4096 x 3000 k 264; PERF.md).
// Built without --use_fast_math: the division stays IEEE.
#include "gs_panel.cuh"
#include "wave.cuh"

namespace tpunmf {
namespace {

// (A2) W' for the rows [r0, r1) of each wave: nsweeps sweeps of W's rows
// against g = H H^T (k, k) from the wave's partials of X round(H)^T.
template <typename XT>
cudaError_t iteration_hals(const Plan& p, const void* xv, const void* hv, const float* w,
                           const float* g, float lam, int m, int n, int k, int nsweeps,
                           float* w_out, float* wtx, float* gram, float* scratch,
                           cudaStream_t s) {
  auto sweeps = [&](int r0, int r1) {
    const RowsFrame f{w, scratch + p.a_part, (long long)p.rows * k, p.nsplit, k, r0, w_out};
    return gs_sweeps(f, g, lam, k, r1 - r0, nsweeps, s);
  };
  const TcStages<XT> stages{static_cast<const XT*>(xv), static_cast<const XT*>(hv), n, k};
  return eu_waves(p, stages, m, n, k, sweeps, w_out, wtx, gram, scratch, s);
}

}  // namespace
}  // namespace tpunmf

extern "C" {

// HALS iteration.  hc is H (k, n) in X's type, hht = H H^T (k, k); writes
// W' (m, k) after nsweeps sweeps, wtx = round(W')^T X (k, n) and gram =
// W'^T W' (k, k).  k <= 1024; scratch holds scratch_len floats, at least
// tpunmf_iteration_scratch's of kind 2 (fewer: cudaErrorInvalidValue).
int tpunmf_hals_iteration_eu(const void* x, int x_is_bf16, const void* w, const void* hc,
                             const void* hht, float lam, int m, int n, int k, int nsweeps,
                             void* w_out, void* wtx, void* gram, void* scratch,
                             long long scratch_len, void* stream) {
  using namespace tpunmf;
  const Plan p = make_plan(m, n, k, x_is_bf16 ? 2 : 4, kWaveHals);
  if (scratch_len < p.scratch) return static_cast<int>(cudaErrorInvalidValue);
  const float* wf = static_cast<const float*>(w);
  const float* gf = static_cast<const float*>(hht);
  float* wo = static_cast<float*>(w_out);
  float* tx = static_cast<float*>(wtx);
  float* gr = static_cast<float*>(gram);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      x_is_bf16 ? iteration_hals<__nv_bfloat16>(p, x, hc, wf, gf, lam, m, n, k, nsweeps, wo, tx,
                                                gr, sc, s)
                : iteration_hals<float>(p, x, hc, wf, gf, lam, m, n, k, nsweeps, wo, tx, gr, sc,
                                        s));
}

}  // extern "C"
