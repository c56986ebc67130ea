// One Adams-Bashforth-Moulton PECE attempt for every lane of a lockstep batch.
//
// Replaces the TPU kernel sunode_tpu/ops/pallas_step.py::adams_pece_attempt_pallas
// (a pallas_call over double-float f32 pairs with a static order and three
// fixed corrector sweeps) and runs the corrector of the JAX main path,
// sunode_tpu/ops/adams_batched.py:427-502 and 602, in native float64:
//   predictor   z_pred = z_prev + h * sum_{i<p} gamma_i DF[i]
//   extrapolate f_ex   = sum_{i<p} DF[i]
//   corrector   y <- z_pred + c_A (f(t, y) - f_ex),  c_A = h gamma_{p-1},
//               at most `maxiter` sweeps over the first PECE_N rows, with
//               the per-lane WRMS rate / convergence / divergence tests
//   final       d_fz  = f(t, y) - f_ex,  z_new = z_pred + c_A d_fz
//   error       err   = |gamma*_p| h d_fz
// With newton_tol <= 0 the tests are off and every sweep runs: that mode
// reproduces the TPU kernel's fixed sweeps (maxiter 3) for the tests.
//
// Layout: one thread per lane.  The history DF is (KAB, PECE_NZ, B) and the
// states (rows, B) with the lane axis contiguous, so every load and store of
// a warp is one coalesced 256-byte transaction.  The right-hand side
// pece_fz() is generated from sympy (sunode_torch/symode/cuda_codegen.py)
// into pece_rhs.h and inlined, so y, f and the history sums stay in
// registers; nothing but the inputs and outputs touches device memory.
//
// What bounds it on an H100: not bandwidth and not arithmetic.  At the main
// path's B = 10,000 an attempt reads about 7.2 MB of history backward
// (9 x 10 x 10k x 8 B) and 1.4 MB forward, a few microseconds at 3.35 TB/s;
// the right-hand side is a few dozen flops per sweep.  The launch and the
// host's per-attempt synchronisation bound it.  The design answers with
// small blocks (64 threads: 157 blocks for 10k lanes, more than the 132
// SMs, where 128-thread blocks would leave half of them idle) and by doing
// the whole predictor-corrector-error core in one launch.  The corrector
// and final evaluation live in pece_core.cuh, shared with
// csrc/adams_attempt.cu, which runs them inside the history half of the
// attempt (rescale, difference update, error rows) on the main path; this
// kernel serves the fixed-sweep A/B and its own checks.
//
// Rows i >= p of DF are never read.  The plain version multiplies them by
// 0.0, which differs only where such a row holds inf or NaN.

#include <cuda_runtime.h>
#include <math.h>

#include "pece_tables.h"  // PECE_TABLE_LEN, PECE_GAMMA[], PECE_GAMMA_STAR_ABS[]
#include "pece_rhs.h"     // PECE_N, PECE_NZ, PECE_NP, pece_fz()
#include "pece_core.cuh"  // pece_correct(): corrector and final evaluation

#define PECE_THREADS 64
#define PECE_NP_ALLOC (PECE_NP > 0 ? PECE_NP : 1)

__global__ void __launch_bounds__(PECE_THREADS)
pece_attempt_kernel(const double* __restrict__ t_new,
                    const double* __restrict__ h_use,
                    const int* __restrict__ order,
                    const unsigned char* __restrict__ active,
                    const double* __restrict__ DF,
                    const double* __restrict__ z_prev,
                    const double* __restrict__ params,
                    const double* __restrict__ atol_z,
                    const double* __restrict__ rtol_z,
                    double newton_tol, int maxiter, int kab, int B,
                    double* __restrict__ y_it_out,
                    double* __restrict__ d_fz_out,
                    double* __restrict__ err_out,
                    double* __restrict__ z_pred_out,
                    double* __restrict__ z_new_out,
                    unsigned char* __restrict__ conv_out,
                    int* __restrict__ niter_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  const int p = order[b];
  const double h = h_use[b];
  const double t = t_new[b];

  if (p < 1 || p > kab - 2) {  // outside the history: poison the lane
#pragma unroll
    for (int r = 0; r < PECE_NZ; ++r) {
      if (r < PECE_N) y_it_out[r * sB + b] = NAN;
      d_fz_out[r * sB + b] = NAN;
      err_out[r * sB + b] = NAN;
      z_pred_out[r * sB + b] = NAN;
      z_new_out[r * sB + b] = NAN;
    }
    conv_out[b] = 0;
    niter_out[b] = 0;
    return;
  }

  double par[PECE_NP_ALLOC];
#pragma unroll
  for (int j = 0; j < PECE_NP; ++j) par[j] = params[j * sB + b];

  // predictor sums and f extrapolation over the leading p rows
  double zp[PECE_NZ], fex[PECE_NZ];
#pragma unroll
  for (int r = 0; r < PECE_NZ; ++r) {
    zp[r] = 0.0;
    fex[r] = 0.0;
  }
  for (int i = 0; i < p; ++i) {
    const double g = PECE_GAMMA[i];
    const double* row = DF + (size_t)i * PECE_NZ * sB + b;
#pragma unroll
    for (int r = 0; r < PECE_NZ; ++r) {
      const double d = row[r * sB];
      zp[r] = zp[r] + g * d;
      fex[r] = fex[r] + d;
    }
  }
  bool pred_ok = true;
#pragma unroll
  for (int r = 0; r < PECE_NZ; ++r) {
    zp[r] = z_prev[r * sB + b] + h * zp[r];
    pred_ok = pred_ok && isfinite(zp[r]);
  }
  const double c_A = h * PECE_GAMMA[p - 1];

  double w[PECE_N];
#pragma unroll
  for (int r = 0; r < PECE_N; ++r) w[r] = 1.0 / (atol_z[r] + rtol_z[r] * fabs(zp[r]));

  double y[PECE_N], f[PECE_NZ];
  int niter;
  const bool conv = pece_correct(t, par, zp, fex, c_A, w, active[b], pred_ok,
                                 newton_tol, maxiter, y, f, &niter);
  const double gsp_h = PECE_GAMMA_STAR_ABS[p] * h;
#pragma unroll
  for (int r = 0; r < PECE_NZ; ++r) {
    const double d = f[r] - fex[r];
    if (r < PECE_N) y_it_out[r * sB + b] = y[r];
    d_fz_out[r * sB + b] = d;
    err_out[r * sB + b] = gsp_h * d;
    z_pred_out[r * sB + b] = zp[r];
    z_new_out[r * sB + b] = zp[r] + c_A * d;
  }
  conv_out[b] = conv ? 1 : 0;
  niter_out[b] = niter;
}

extern "C" {

// Launch on `stream` without synchronising.  Returns 0, -1 when the shapes
// do not match the compiled system, -2 when the history is deeper than the
// coefficient tables, or the cudaError_t of the launch.
int pece_attempt_launch(const double* t_new, const double* h_use, const int* order,
                        const unsigned char* active, const double* DF,
                        const double* z_prev, const double* params,
                        const double* atol_z, const double* rtol_z,
                        double newton_tol, int maxiter, int n_iter, int nz,
                        int kab, int n_p, int B, double* y_it, double* d_fz,
                        double* err, double* z_pred, double* z_new,
                        unsigned char* conv, int* niter, void* stream) {
  if (n_iter != PECE_N || nz != PECE_NZ || n_p != PECE_NP) return -1;
  if (kab - 2 > PECE_TABLE_LEN - 1) return -2;
  if (B <= 0) return 0;
  const int blocks = (B + PECE_THREADS - 1) / PECE_THREADS;
  pece_attempt_kernel<<<blocks, PECE_THREADS, 0, (cudaStream_t)stream>>>(
      t_new, h_use, order, active, DF, z_prev, params, atol_z, rtol_z,
      newton_tol, maxiter, kab, B, y_it, d_fz, err, z_pred, z_new, conv, niter);
  return (int)cudaGetLastError();
}

const char* pece_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
