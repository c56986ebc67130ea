// The quotient by a small integer of the rescale's R(fac) tables, shared by
// the history-attempt kernel (adams_attempt.cu) and the split attempt's
// predict (adams_split.cu).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "real.cuh"  // real, r_div

// t / j for a small integer j, rounded as __ddiv_rn(t, j) is.  A power of
// two divides exactly as the product by its reciprocal.  Otherwise, with
// y = RN(1/j): q = RN(t y) lies within 1.5 ulp of t / j, so the remainder
// t - q j is a small multiple of ulp(q) and the FMA gives it exactly, and
// RN(q + r y) differs from t / j by under 2^-52 ulp(q), while t / j lies at
// least ulp(q) / 2j from every rounding midpoint (j's odd factor cannot
// divide a 53-bit significand into a half-integer): it rounds as t / j does.
// A second step repeats it from the rounded quotient.  Zero and non-finite
// t, whose remainder is not a number or loses zero's sign, take q itself,
// which is then RN(t / j) too.
__device__ __forceinline__ double div_small(double t, int j) {
  if ((j & (j - 1)) == 0) return __dmul_rn(t, 1.0 / j);
  const double y = 1.0 / j, d = (double)j;
  const double q0 = __dmul_rn(t, y);
  double q = __fma_rn(__fma_rn(-q0, d, t), y, q0);
  q = __fma_rn(__fma_rn(-q, d, t), y, q);
  return (q0 == 0.0 || !isfinite(q0)) ? q0 : q;
}

// At float32 the quotient is the correctly rounded division itself, as the
// plain version divides by a tensor (correctly rounded on the card and the
// CPU): the argument above is written for a 53-bit significand.
__device__ __forceinline__ float div_small(float t, int j) { return r_div(t, (float)j); }
