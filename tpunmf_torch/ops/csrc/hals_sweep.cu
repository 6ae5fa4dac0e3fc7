// HALS Gauss-Seidel sweeps: nsweeps passes of the k-step rank-1 closed-form
// chain over the rows of V, in tpunmf's transposed frame.
//
// Replaces the Pallas kernels of tpunmf/ops/hals_sweep.py: gs_sweep (:232,
// pallas_call :266), bodies _gs_sweep_kernel (:41) and _gs_sweep_fori_kernel
// (:64).
//
//   for l in 0..k-1:
//     numer  = A[l, c] - G[l, :] . V[:, c] + G[l, l] V[l, c]
//     V[l, c] = max(numer / (G[l, l] + lam + eps), 0)       eps = 1e-16
//
// (the fori form of the TPU kernel and tpunmf/solvers/hals.py:54-81; the
// unrolled TPU form keeps P = G V as a running sum instead, the same k^2
// work per column).  W frame: A = (X H^T)^T, G = H H^T, V = W^T; H frame:
// A = W^T X, G = W^T W, V = H.
//
// The sweep body is gs_panel.cuh's blocked Gauss-Seidel (shared with the
// single-pass HALS iteration): a block owns a tile of columns of V in
// shared memory, each panel of rows is one product against G on the
// tensor cores and then a short chain of corrections, one thread a column.
// A, V and the output take the strides of both axes, so the W frame's
// transposed views of row-major (m, k) tensors go in without a copy; the
// tiles are loaded and stored down the columns there and along the rows in
// the H frame, coalesced in both.
#include "gs_panel.cuh"

extern "C" {

// out = nsweeps Gauss-Seidel sweeps over the k rows of v (k, cols), given
// a (k, cols) and the row-major Gram g (k, k).  a, v and out are addressed
// as base + row * s0 + col * s1 (element strides).  k <= 1024.
int tpunmf_gs_sweep(const void* a, int a_s0, int a_s1, const void* g, const void* v,
                    int v_s0, int v_s1, float lam, int k, int cols, int nsweeps, void* out,
                    int o_s0, int o_s1, void* stream) {
  using namespace tpunmf;
  const StridedFrame f{static_cast<const float*>(a), a_s0, a_s1, static_cast<const float*>(v),
                       v_s0, v_s1, static_cast<float*>(out), o_s0, o_s1};
  return static_cast<int>(gs_sweeps(f, static_cast<const float*>(g), lam, k, cols, nsweeps,
                                    static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
