// The functional corrector and final evaluation of one Adams PECE attempt,
// for one lane.  Shared by csrc/pece_step.cu and csrc/adams_attempt.cu, so
// both kernels run the corrector of the JAX main path
// (sunode_tpu/ops/adams_batched.py:456-502) with the same code.
//
// Include after pece_rhs.h (PECE_N, PECE_NZ, PECE_NP, pece_fz()).  Every
// array is indexed with compile-time indices once the loops unroll, so after
// inlining they all stay in registers.  Every f64 operation of the
// corrector is rounded on its own (__dadd_rn, __dmul_rn, ...), in the order
// of the plain version (ops/pece_step.py), so nvcc contracts none of them
// into an FMA; the emitted pece_fz() is the only code left to nvcc.
#pragma once

#include <math.h>

// zp:  predicted state z_prev + h sum_{i<p} gamma_i DF[i] (PECE_NZ rows);
// fex: the extrapolated f, sum_{i<p} DF[i] (PECE_NZ rows);
// c_A: h gamma_{p-1};  w: error weights of the first PECE_N rows;
// pred_ok: every row of zp is finite.
// Runs at most `maxiter` sweeps over the first PECE_N rows with the per-lane
// WRMS rate / convergence / divergence tests (all off when newton_tol <= 0:
// every sweep runs), then evaluates f once more at the corrected state.
// Writes the iterate y (PECE_N rows), f(t, y) (PECE_NZ rows) and the sweeps
// taken; returns conv (converged, f finite, predictor finite).
__device__ __forceinline__ bool pece_correct(double t, const double* par,
                                             const double* zp, const double* fex,
                                             double c_A, const double* w,
                                             bool active, bool pred_ok,
                                             double newton_tol, int maxiter,
                                             double* y, double* f, int* niter_out) {
#pragma unroll
  for (int r = 0; r < PECE_N; ++r) y[r] = zp[r];

  // the quadrature rows do not feed back and are not iterated
  const bool fixed = !(newton_tol > 0.0);
  bool conv = !active, div = false, bad = false;
  double dy_old = INFINITY;
  int niter = 0;
  for (int k = 0; k < maxiter; ++k) {
    if (conv || div || bad) break;  // a lane that is not live never changes again
    pece_fz(t, y, par, f);
    bool bad_f = false;
#pragma unroll
    for (int r = 0; r < PECE_NZ; ++r) bad_f = bad_f || !isfinite(f[r]);
    double ss = 0.0;
#pragma unroll
    for (int r = 0; r < PECE_N; ++r) {
      const double zn = __dadd_rn(zp[r], __dmul_rn(c_A, __dsub_rn(f[r], fex[r])));
      const double e = __dmul_rn(__dsub_rn(zn, y[r]), w[r]);
      ss = __dadd_rn(ss, __dmul_rn(e, e));
      y[r] = zn;
    }
    const double dy = __dsqrt_rn(__ddiv_rn(ss, (double)PECE_N));
    const double rate = __ddiv_rn(dy, dy_old);
    const bool conv_new =
        !fixed &&
        ((dy == 0.0) ||
         (k > 0 && rate < 1.0 &&
          __dmul_rn(__ddiv_rn(rate, __dsub_rn(1.0, rate)), dy) < newton_tol) ||
         (dy < __dmul_rn(0.1, newton_tol)));
    const bool div_new = !fixed && k > 0 && rate >= 2.0;
    bad = bad_f;
    conv = conv_new && !bad;
    div = div_new && !conv_new;
    niter += 1;
    dy_old = dy;
  }
  if (fixed) conv = conv || !bad;
  conv = conv && !bad && pred_ok;

  // final evaluation at the corrected y
  pece_fz(t, y, par, f);
  *niter_out = niter;
  return conv;
}
