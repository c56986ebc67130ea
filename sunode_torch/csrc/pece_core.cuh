// The functional corrector and final evaluation of one Adams PECE attempt,
// for one lane.  Shared by csrc/pece_step.cu and csrc/adams_attempt.cu, so
// both kernels run the corrector of the JAX main path
// (sunode_tpu/ops/adams_batched.py:456-502) with the same code.
//
// Include after pece_rhs.h (PECE_N, PECE_NZ, PECE_NP, pece_fz()).  Every
// array is indexed with compile-time indices once the loops unroll, so after
// inlining they all stay in registers.  The corrector runs at the build's
// type `real` (real.cuh: double, or float with -DSUNODE_REAL=float), and
// every operation of it is rounded on its own (r_add, r_mul, ...: __dadd_rn
// or __fadd_rn, ...), in the order of the plain version (ops/pece_step.py),
// so nvcc contracts none of them into an FMA; the emitted pece_fz() is the
// only code left to nvcc.
#pragma once

#include <math.h>

#include "real.cuh"  // real, r_add, r_mul, ...

// zp:  predicted state z_prev + h sum_{i<p} gamma_i DF[i] (PECE_NZ rows);
// fex: the extrapolated f, sum_{i<p} DF[i] (PECE_NZ rows);
// c_A: h gamma_{p-1};  w: error weights of the first PECE_N rows;
// pred_ok: every row of zp is finite.
// Runs at most `maxiter` sweeps over the first PECE_N rows with the per-lane
// WRMS rate / convergence / divergence tests (all off when newton_tol <= 0:
// every sweep runs), then evaluates f once more at the corrected state.
// newton_tol stays a double, as the plain version's Python number: its
// bounds enter the tests rounded to `real` from 0.1 newton_tol and
// newton_tol in double, as torch rounds a Python number it compares with.
// Writes the iterate y (PECE_N rows), f(t, y) (PECE_NZ rows) and the sweeps
// taken; returns conv (converged, f finite, predictor finite).
__device__ __forceinline__ bool pece_correct(real t, const real* par,
                                             const real* zp, const real* fex,
                                             real c_A, const real* w,
                                             bool active, bool pred_ok,
                                             double newton_tol, int maxiter,
                                             real* y, real* f, int* niter_out) {
#pragma unroll
  for (int r = 0; r < PECE_N; ++r) y[r] = zp[r];

  // the quadrature rows do not feed back and are not iterated
  const bool fixed = !(newton_tol > 0.0);
  bool conv = !active, div = false, bad = false;
  real dy_old = INFINITY;
  int niter = 0;
  for (int k = 0; k < maxiter; ++k) {
    if (conv || div || bad) break;  // a lane that is not live never changes again
    pece_fz(t, y, par, f);
    bool bad_f = false;
#pragma unroll
    for (int r = 0; r < PECE_NZ; ++r) bad_f = bad_f || !isfinite(f[r]);
    real ss = 0;
#pragma unroll
    for (int r = 0; r < PECE_N; ++r) {
      const real zn = r_add(zp[r], r_mul(c_A, r_sub(f[r], fex[r])));
      const real e = r_mul(r_sub(zn, y[r]), w[r]);
      ss = r_add(ss, r_mul(e, e));
      y[r] = zn;
    }
    const real dy = r_sqrt(r_div(ss, (real)PECE_N));
    const real rate = r_div(dy, dy_old);
    const bool conv_new =
        !fixed &&
        ((dy == 0) ||
         (k > 0 && rate < 1 &&
          r_mul(r_div(rate, r_sub((real)1, rate)), dy) < (real)newton_tol) ||
         (dy < (real)__dmul_rn(0.1, newton_tol)));
    const bool div_new = !fixed && k > 0 && rate >= 2;
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
