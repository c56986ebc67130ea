// The history half of one Adams attempt for every lane of a lockstep batch:
// rescale, PECE, difference update and error rows in one launch.
//
// Replaces, on the main path, the TPU kernel
// sunode_tpu/ops/pallas_step.py::adams_pece_attempt_pallas (predictor,
// corrector, final evaluation and error estimate) together with the history
// arithmetic the JAX main path left to XLA fusion around it
// (sunode_tpu/ops/adams_batched.py: _rescale :376-399, the error rows
// :617-632, _update :989-1007).  Per lane, in float64, with the lane's own
// order p and step ratio fac = h / h_D:
//   pass 1  for each state row r: load the history column DF[0..KAB-1][r]
//           into registers, apply R(fac) and then U = R(1) to its leading
//           p rows (identity elsewhere), write DF_resc[:, r], and sum the
//           predictor z_pred[r] = z_prev[r] + h sum_{i<p} gamma_i DF_resc[i][r]
//           and the extrapolation f_ex[r] = sum_{i<p} DF_resc[i][r];
//   PECE    the main path's functional corrector and final evaluation,
//           pece_correct() of pece_core.cuh, the code kernel 1 runs;
//   pass 2  for each r: reload DF_resc[:, r] (this thread's own write, from
//           L1 or L2), d = f - f_ex, the accepted-step difference update
//           into DF_upd[:, r], z_new = z_pred + h gamma_{p-1} d, the error
//           row err0 = |gamma*_p| h d;
//   pass 3  for each r: the weighted squares of the three error-test rows
//           (orders p, p-1, p+1) summed into err3.
// Pass 1 writes z_pred and parks f_ex in err0's rows, and reads both back
// into registers for the corrector, so its row loop need not unroll; pass 3
// reads err0, z_pred and two DF_upd rows back, so pass 2 holds no sums.
// R and U are never stored: R[j][i] = R[j-1][i] ((j-1) - fac i) / j is a
// running product over j for each output index i.  Each product,
// difference and quotient of the rescale is rounded on its own (no FMA
// contraction), in the order of the plain version, so a finite history
// rescales as the plain version on the CPU does, bit for bit.
//
// What bounds it on an H100: bytes.  The history is read from device memory
// once and written twice (DF_resc, DF_upd); the plain version streams the
// whole (KAB, nz, B) history through device memory in about 30 separate
// torch operations an attempt.  At B = 10,000 the transition system's
// history is 9 x 10 x 10k x 8 B = 7.2 MB, about 2 us at 3.35 TB/s for each
// pass.  The arithmetic is a few thousand float64 operations a lane.
//
// Why no tensor cores, TMA or shared-memory tiles: every lane has its own
// K x K factors R(fac) and U restricted to its own order, so there is no
// shared operand for a matrix unit to reuse, and with one thread per lane
// and the lane axis contiguous each warp's load or store of one history
// element is already one coalesced 256-byte transaction.  Those tools
// belong to a later change, if a profile asks for them.
//
// Layout: one thread per lane, 64-thread blocks (157 blocks for 10k lanes,
// more than the 132 SMs).  The history depth KAB is a compile-time define,
// so one history column and the running sums stay in registers.  Lanes
// with p outside the history (p < 1 or p > KAB - 2) are poisoned with NaN,
// as kernel 1 (csrc/pece_step.cu) poisons them.

#include <cuda_runtime.h>
#include <math.h>

#include "pece_tables.h"  // PECE_TABLE_LEN, PECE_GAMMA[], PECE_GAMMA_STAR_ABS[]
#include "pece_rhs.h"     // PECE_N, PECE_NZ, PECE_NP, pece_fz()
#include "pece_core.cuh"  // pece_correct(): corrector and final evaluation

#ifndef ADAMS_KAB
#error "build with -DADAMS_KAB=<history rows>, that is P_MAX + 3"
#endif
#define ADAMS_K (ADAMS_KAB - 2)  // rows 0..P_MAX of the R(fac)U block
#define ADAMS_THREADS 64
#define ADAMS_NP_ALLOC (PECE_NP > 0 ? PECE_NP : 1)

// col[i] <- sum_{j<p} M[j][i] col[j] for i < p, col[i] unchanged for i >= p,
// with M[0][i] = 1 and M[j][i] = (M[j-1][i] ((j-1) - fac i)) / j: R(fac), or
// U at fac = 1.  The sum runs over j in order from 0, as the plain version's.
__device__ __forceinline__ void rescale_column(double* col, double fac, int p) {
  double out[ADAMS_K];
#pragma unroll
  for (int i = 0; i < ADAMS_K; ++i) {
    out[i] = col[i];
    if (i < p) {
      const double fi = __dmul_rn(fac, (double)i);
      double c = 1.0, acc = 0.0;
#pragma unroll
      for (int j = 0; j < ADAMS_K; ++j) {
        if (j < p) {
          if (j > 0) c = __ddiv_rn(__dmul_rn(c, __dsub_rn((double)(j - 1), fi)), (double)j);
          acc = __dadd_rn(acc, __dmul_rn(c, col[j]));
        }
      }
      out[i] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < ADAMS_K; ++i) col[i] = out[i];
}

__global__ void __launch_bounds__(ADAMS_THREADS)
adams_attempt_kernel(const double* __restrict__ t_new,
                     const double* __restrict__ h_use,
                     const double* __restrict__ pre_factor,
                     const int* __restrict__ order,
                     const unsigned char* __restrict__ active,
                     const double* __restrict__ DF,
                     const double* __restrict__ z_prev,
                     const double* __restrict__ params,
                     const double* __restrict__ atol_z,
                     const double* __restrict__ rtol_z,
                     const double* __restrict__ gamma_star_abs,
                     const double* __restrict__ v_err,
                     double newton_tol, int maxiter, int B,
                     double* __restrict__ DF_resc,
                     double* __restrict__ DF_upd,
                     double* __restrict__ z_pred_out,
                     double* __restrict__ z_new_out,
                     double* __restrict__ err0_out,
                     double* __restrict__ err3_out,
                     unsigned char* __restrict__ conv_out,
                     int* __restrict__ niter_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  const int p = order[b];
  const double h = h_use[b];
  const double t = t_new[b];
  // element (i, r) of a (KAB, PECE_NZ, B) history, this lane
#define HIST(i, r) ((size_t)((i) * PECE_NZ + (r)) * sB + b)

  if (p < 1 || p > ADAMS_KAB - 2) {  // outside the history: poison the lane
#pragma unroll
    for (int r = 0; r < PECE_NZ; ++r) {
#pragma unroll
      for (int i = 0; i < ADAMS_KAB; ++i) {
        DF_resc[HIST(i, r)] = NAN;
        DF_upd[HIST(i, r)] = NAN;
      }
      z_pred_out[r * sB + b] = NAN;
      z_new_out[r * sB + b] = NAN;
      err0_out[r * sB + b] = NAN;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) err3_out[k * sB + b] = NAN;
    conv_out[b] = 0;
    niter_out[b] = 0;
    return;
  }

  double par[ADAMS_NP_ALLOC];
#pragma unroll
  for (int j = 0; j < PECE_NP; ++j) par[j] = params[j * sB + b];

  // pass 1: rescale each history column, write it, sum predictor and f_ex.
  // The row loop stays rolled: unrolled over every row, with the rescale's
  // division chains copied into each row, the kernel was slower on the card
  // (PERF.md).
  const double fac = pre_factor[b];
#pragma unroll 1
  for (int r = 0; r < PECE_NZ; ++r) {
    double col[ADAMS_KAB];
#pragma unroll
    for (int i = 0; i < ADAMS_KAB; ++i) col[i] = DF[HIST(i, r)];
    rescale_column(col, fac, p);  // R(fac)
    rescale_column(col, 1.0, p);  // U
#pragma unroll
    for (int i = 0; i < ADAMS_KAB; ++i) DF_resc[HIST(i, r)] = col[i];
    double acc_z = 0.0, acc_f = 0.0;
#pragma unroll
    for (int i = 0; i < ADAMS_K; ++i) {
      if (i < p) {
        acc_z = acc_z + PECE_GAMMA[i] * col[i];
        acc_f = acc_f + col[i];
      }
    }
    z_pred_out[r * sB + b] = z_prev[r * sB + b] + h * acc_z;
    err0_out[r * sB + b] = acc_f;  // f_ex, until pass 2 writes the error row
  }
  // the predictor and f_ex back into registers: this thread's own writes
  double zp[PECE_NZ], fex[PECE_NZ];
  bool pred_ok = true;
#pragma unroll
  for (int r = 0; r < PECE_NZ; ++r) {
    zp[r] = z_pred_out[r * sB + b];
    fex[r] = err0_out[r * sB + b];
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

  // pass 2: difference update and new state
  const double g0_h = PECE_GAMMA_STAR_ABS[p] * h;  // the error row at order p
#pragma unroll
  for (int r = 0; r < PECE_NZ; ++r) {
    double col[ADAMS_KAB];
#pragma unroll
    for (int i = 0; i < ADAMS_KAB; ++i) col[i] = DF_resc[HIST(i, r)];
    const double d = f[r] - fex[r];
    // suffix sums S[i] = sum_{j >= i} col[j], from the last row down
    double S[ADAMS_KAB + 1];
    S[ADAMS_KAB] = 0.0;
#pragma unroll
    for (int i = ADAMS_KAB - 1; i >= 0; --i) S[i] = S[i + 1] + col[i];
    double Sp = 0.0, col_p = 0.0;
#pragma unroll
    for (int i = 0; i < ADAMS_KAB; ++i) {
      if (i == p) {
        Sp = S[i];
        col_p = col[i];
      }
    }
    // i <= p-1: sum_{j=i..p-1} DF[j] + d;  i == p: d;  i == p+1: d - DF[p]
#pragma unroll
    for (int i = 0; i < ADAMS_KAB; ++i) {
      DF_upd[HIST(i, r)] = i <= p - 1 ? (S[i] - Sp) + d
                           : i == p   ? d
                           : i == p + 1 ? d - col_p
                                        : col[i];
    }
    z_new_out[r * sB + b] = zp[r] + c_A * d;
    err0_out[r * sB + b] = g0_h * d;
  }

  // pass 3: the error-test rows at orders p, p-1 and p+1, weighted, squared
  // and summed over the rows; it reads back this thread's own writes, which
  // keeps pass 2's registers for the update
  const double g1_h = gamma_star_abs[p - 1] * h;
  const double g2_h = gamma_star_abs[min(p + 1, ADAMS_K)] * h;  // at most P_MAX + 1
  double ss0 = 0.0, ss1 = 0.0, ss2 = 0.0;
#pragma unroll 1
  for (int r = 0; r < PECE_NZ; ++r) {
    const double wz = 1.0 / (atol_z[r] + rtol_z[r] * fabs(z_pred_out[r * sB + b]));
    const double v = v_err[r];
    const double a0 = err0_out[r * sB + b] * wz;
    const double a1 = (g1_h * DF_upd[HIST(p - 1, r)]) * wz;
    const double a2 = (g2_h * DF_upd[HIST(p + 1, r)]) * wz;
    ss0 = ss0 + a0 * a0 * v;
    ss1 = ss1 + a1 * a1 * v;
    ss2 = ss2 + a2 * a2 * v;
  }
#undef HIST
  err3_out[b] = sqrt(ss0);
  err3_out[sB + b] = sqrt(ss1);
  err3_out[2 * sB + b] = sqrt(ss2);
  conv_out[b] = conv ? 1 : 0;
  niter_out[b] = niter;
}

extern "C" {

// Launch on `stream` without synchronising.  Returns 0, -1 when the shapes
// do not match the compiled system and history depth, -2 when the history
// is deeper than the coefficient tables, or the cudaError_t of the launch.
int adams_attempt_launch(const double* t_new, const double* h_use, const double* pre_factor,
                         const int* order, const unsigned char* active, const double* DF,
                         const double* z_prev, const double* params, const double* atol_z,
                         const double* rtol_z, const double* gamma_star_abs,
                         const double* v_err, double newton_tol, int maxiter, int n_iter,
                         int nz, int kab, int n_p, int n_gamma, int B, double* DF_resc,
                         double* DF_upd, double* z_pred, double* z_new, double* err0,
                         double* err3, unsigned char* conv, int* niter, void* stream) {
  if (n_iter != PECE_N || nz != PECE_NZ || n_p != PECE_NP || kab != ADAMS_KAB) return -1;
  if (kab - 2 > PECE_TABLE_LEN - 1 || n_gamma < kab - 1) return -2;
  if (B <= 0) return 0;
  const int blocks = (B + ADAMS_THREADS - 1) / ADAMS_THREADS;
  adams_attempt_kernel<<<blocks, ADAMS_THREADS, 0, (cudaStream_t)stream>>>(
      t_new, h_use, pre_factor, order, active, DF, z_prev, params, atol_z, rtol_z,
      gamma_star_abs, v_err, newton_tol, maxiter, B, DF_resc, DF_upd, z_pred, z_new,
      err0, err3, conv, niter);
  return (int)cudaGetLastError();
}

const char* adams_attempt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
