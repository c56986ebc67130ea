// The history half of one Adams attempt for every lane of a lockstep batch:
// rescale, PECE, difference update and error rows in one launch.
//
// Replaces, on the main path, the TPU kernel
// sunode_tpu/ops/pallas_step.py::adams_pece_attempt_pallas (predictor,
// corrector, final evaluation and error estimate) together with the history
// arithmetic the JAX main path left to XLA fusion around it
// (sunode_tpu/ops/adams_batched.py: _rescale :376-399, the error rows
// :617-632, _update :989-1007).  Per lane, at the build's type `real`
// (real.cuh: float64, or float32 with -DSUNODE_REAL=float, each build
// keyed on it by ops/adams_attempt.py), with the lane's own order p and
// step ratio fac = h / h_D:
//   tables   R(fac)[j][i] = R[j-1][i] ((j-1) - fac i) / j for j < p and every
//            column i < K, once per lane into shared memory, the lane's
//            threads sharing its columns; U = R(1) is the same for every
//            lane, exact signed binomials, emitted as the constant table
//            PECE_U;
//   rows     each (lane, row) thread applies R and then U to the leading p
//            rows of its history column DF[0..KAB-1][r] (identity
//            elsewhere), held in registers, writes DF_resc[:, r], and puts
//            the predictor z_pred[r] = z_prev[r] + h sum_{i<p} gamma_i
//            DF_resc[i][r], the extrapolation f_ex[r] = sum_{i<p}
//            DF_resc[i][r] and the error weight 1 / (atol + rtol |z_pred|)
//            into shared memory;
//   PECE     one warp per lane tile runs the main path's functional
//            corrector and final evaluation, pece_correct() of
//            pece_core.cuh, the code kernel 1 runs, on those rows in shared
//            memory, and writes f there;
//   update   each (lane, row) thread, from the column it still holds:
//            d = f - f_ex, the accepted-step difference update DF_upd[:, r],
//            z_new = z_pred + h gamma_{p-1} d, the error row
//            err0 = |gamma*_p| h d, and its row's three weighted error terms
//            (orders p, p-1, p+1);
//   norms    the lane's first thread sums the weighted squares over the
//            rows, in row order, into err3.
// Every product, sum, difference and quotient the kernel writes out
// (rescale, predictor, error weights, update, error rows and norms, and the
// corrector of pece_core.cuh) is rounded on its own (r_mul, r_add, ...:
// __dmul_rn or __fmul_rn, ...; no FMA contraction; the quotients by small
// integers of div_small() are those of __ddiv_rn or __fdiv_rn), in the
// order of the plain version at the build's type.  So a finite
// history gives DF_resc and z_pred bit for bit the plain version's, and the
// rest too in every lane where the emitted right-hand side's f rounds as
// the plain one's; only the emitted right-hand side is left to nvcc.
//
// What bounds it on an H100: bytes, in principle.  The history is read from
// device memory once and written twice (DF_resc, DF_upd), at B = 10,000 for
// the transition system 9 x 10 x 10k x 8 B = 7.2 MB each time, 25.7 MB in
// all with the other rows: 7.7 us at 3.35 TB/s; a float32 build moves half
// the bytes.  The arithmetic is ~4p^2
// operations a row and p^2 quotients a lane, far under the float64 rate.
// In practice one wave of blocks holds every lane at that width, and each
// block's chain of phases (device memory, R, rows, the corrector's sweeps,
// update) bounds the time: the design shortens that chain.  A block is a
// tile of 32 lanes (threadIdx.x: one coalesced 256-byte transaction per
// history element and warp) by ADAMS_ROWS threads (threadIdx.y), four, so
// a lane's rows and R's columns are spread over four threads while three
// blocks still fit an SM; threads past PECE_NZ only build R.  Every load of
// the launch is issued at once, before the R table is built; the quotients
// by 3, 5, 6 and 7 take five FMA-latency steps instead of a division each;
// nothing written is read back from device memory.
//
// Why no tensor cores (wgmma) or TMA: every lane has its own K x K factor
// R(fac) restricted to its own order, so a matrix unit has no operand shared
// across lanes to reuse, and a lane's product is at most 8 x 8; the
// history's lane axis is contiguous, so plain coalesced loads already read
// whole 256-byte lines at full width, and a TMA tile would only stage in
// shared memory what each thread reads once into its registers.
//
// Lanes with p outside the history (p < 1 or p > KAB - 2) are poisoned with
// NaN, as kernel 1 (csrc/pece_step.cu) poisons them; lanes past B in the last
// tile do nothing.  The shared memory and the columns a thread holds are
// sized at compile time from ADAMS_KAB, PECE_NZ and the tile; a build that
// cannot hold them stops with #error.

#include <cuda_runtime.h>
#include <math.h>

#include "pece_tables.h"  // PECE_TABLE_LEN, PECE_GAMMA[], PECE_GAMMA_STAR_ABS[], PECE_U[][]
#include "pece_rhs.h"     // PECE_N, PECE_NZ, PECE_NP, pece_fz()
#include "real.cuh"       // real (SUNODE_REAL), r_add, r_mul, ...
#include "pece_core.cuh"  // pece_correct(): corrector and final evaluation
#include "div_small.cuh"  // div_small(): t / j rounded as r_div

#ifndef ADAMS_KAB
#error "build with -DADAMS_KAB=<history rows>, that is P_MAX + 3"
#endif
#define ADAMS_K (ADAMS_KAB - 2)  // rows 0..P_MAX of the R(fac)U block
#define ADAMS_TILE 32            // lanes of a block: one warp per row thread index
// Threads of a lane; those past PECE_NZ only build R.  Four measured fastest
// in all five builds on an H100: one, two and eight lose in each (PERF.md).
#define ADAMS_ROWS 4
#define ADAMS_THREADS (ADAMS_TILE * ADAMS_ROWS)
#define ADAMS_RPT ((PECE_NZ + ADAMS_ROWS - 1) / ADAMS_ROWS)   // history rows a thread holds
#define ADAMS_CPT ((ADAMS_K + ADAMS_ROWS - 1) / ADAMS_ROWS)   // R columns a thread builds
#define ADAMS_NZ_PAD (PECE_NZ | 1)  // odd stride: a warp's accesses miss no bank twice
#define ADAMS_NP_ALLOC (PECE_NP > 0 ? PECE_NP : 1)

#if ADAMS_K > PECE_TABLE_LEN - 1
#error "history deeper than the Adams tables"
#endif
#if ADAMS_RPT * ADAMS_KAB > 64
#error "the history columns a thread holds do not fit in its registers"
#endif
static_assert(sizeof(real) * (ADAMS_K * ADAMS_K * ADAMS_TILE + 4 * ADAMS_TILE * ADAMS_NZ_PAD +
                                 PECE_NZ) <= 48 * 1024,
              "the R tables and row vectors exceed a block's static shared memory");

#ifdef ADAMS_PHASE_CLOCKS
// A trace of the kernel by phase: the cycles from each barrier to the next
// on thread (0, 0) of a block (loads and R, rows, PECE, update, norms),
// summed over the blocks of every launch since the last read, and the
// blocks counted (history_ab.py --phase-clocks).
__device__ unsigned long long adams_phase_cycles[6];
#define ADAMS_MARK(k)                                                        \
  if (tx == 0 && ty == 0) {                                                  \
    const long long now = clock64();                                         \
    atomicAdd(&adams_phase_cycles[k], (unsigned long long)(now - mark));     \
    mark = now;                                                              \
  }
#else
#define ADAMS_MARK(k)
#endif

__global__ void __launch_bounds__(ADAMS_THREADS)
adams_attempt_kernel(const real* __restrict__ t_new,
                     const real* __restrict__ h_use,
                     const real* __restrict__ pre_factor,
                     const int* __restrict__ order,
                     const unsigned char* __restrict__ active,
                     const real* __restrict__ DF,
                     const real* __restrict__ z_prev,
                     const real* __restrict__ params,
                     const real* __restrict__ atol_z,
                     const real* __restrict__ rtol_z,
                     const real* __restrict__ gamma_star_abs,
                     const real* __restrict__ v_err,
                     double newton_tol, int maxiter, int B,
                     real* __restrict__ DF_resc,
                     real* __restrict__ DF_upd,
                     real* __restrict__ z_pred_out,
                     real* __restrict__ z_new_out,
                     real* __restrict__ err0_out,
                     real* __restrict__ err3_out,
                     unsigned char* __restrict__ conv_out,
                     int* __restrict__ niter_out) {
  __shared__ real Rs[ADAMS_K][ADAMS_K][ADAMS_TILE];  // R(fac)[j][i], per lane
  // Per lane, lane-major so the corrector reads its lane's rows as arrays:
  // z_pred, f_ex, f and the error weights w; in the update each row thread
  // then overwrites its own row's first three with its weighted error terms
  // for the norms.
  __shared__ real rows_s[4][ADAMS_TILE][ADAMS_NZ_PAD];
  __shared__ real v_s[PECE_NZ];  // the error norm's weights
  const int tx = threadIdx.x, ty = threadIdx.y;
#ifdef ADAMS_PHASE_CLOCKS
  long long mark = clock64();
#endif
  const int b = blockIdx.x * ADAMS_TILE + tx;
  const bool lane = b < B;
  const size_t sB = (size_t)B;
  real* zp_s = rows_s[0][tx];
  real* fex_s = rows_s[1][tx];
  real* f_s = rows_s[2][tx];
  real* w_s = rows_s[3][tx];
  // element (i, r) of a (KAB, PECE_NZ, B) history, this lane
#define HIST(i, r) ((size_t)((i) * PECE_NZ + (r)) * sB + b)

  // Every load of the launch is issued here, before any of them is used:
  // a lane's chain of phases then waits on device memory once.  This
  // thread's history columns and rows first, then the lane's scalars, the
  // corrector's inputs in its warp, and the norm's weights.
  real col[ADAMS_RPT][ADAMS_KAB], zprev[ADAMS_RPT], atol_r[ADAMS_RPT], rtol_r[ADAMS_RPT];
#pragma unroll
  for (int k = 0; k < ADAMS_RPT; ++k) {
    const int r = ty + k * ADAMS_ROWS;
    const bool row = lane && r < PECE_NZ;
#pragma unroll
    for (int i = 0; i < ADAMS_KAB; ++i) col[k][i] = row ? DF[HIST(i, r)] : (real)0;
    zprev[k] = row ? z_prev[r * sB + b] : (real)0;
    atol_r[k] = row ? atol_z[r] : (real)0;
    rtol_r[k] = row ? rtol_z[r] : (real)0;
  }
  const int p = lane ? order[b] : 0;
  const real fac = lane ? pre_factor[b] : (real)0;
  const real h = lane ? h_use[b] : (real)0;
  real par[ADAMS_NP_ALLOC], t = 0;
  bool act = false;
  if (ty == 0 && lane) {
#pragma unroll
    for (int j = 0; j < PECE_NP; ++j) par[j] = params[j * sB + b];
    t = t_new[b];
    act = active[b];
  }
  for (int r = ty * ADAMS_TILE + tx; r < PECE_NZ; r += ADAMS_THREADS) v_s[r] = v_err[r];
  const bool valid = lane && p >= 1 && p <= ADAMS_K;
  const real g1 = valid ? gamma_star_abs[p - 1] : (real)0;               // order p - 1
  const real g2 = valid ? gamma_star_abs[min(p + 1, ADAMS_K)] : (real)0;  // order p + 1, at most P_MAX + 1
  const real g0 = valid ? PECE_GAMMA_STAR_ABS[p] : (real)0;              // order p
  const real c_A = valid ? r_mul(h, PECE_GAMMA[p - 1]) : (real)0;    // h gamma_{p-1}

  // R(fac): column i's running product over j < p, for every column i < K,
  // the chains of a thread's columns interleaved
  if (valid) {
    real c[ADAMS_CPT], fi[ADAMS_CPT];
#pragma unroll
    for (int m = 0; m < ADAMS_CPT; ++m) {
      const int i = ty + m * ADAMS_ROWS;
      fi[m] = r_mul(fac, (real)i);
      c[m] = 1;
      if (i < ADAMS_K) Rs[0][i][tx] = 1;
    }
#pragma unroll
    for (int j = 1; j < ADAMS_K; ++j) {
      if (j >= p) break;
#pragma unroll
      for (int m = 0; m < ADAMS_CPT; ++m) {
        const int i = ty + m * ADAMS_ROWS;
        const real prod = r_mul(c[m], r_sub((real)(j - 1), fi[m]));
        c[m] = div_small(prod, j);
        if (i < ADAMS_K) Rs[j][i][tx] = c[m];
      }
    }
  }
  __syncthreads();
  ADAMS_MARK(0);

  // rows: rescale, write DF_resc, predictor, f_ex and the row's error weight
  real wz[ADAMS_RPT];
#pragma unroll
  for (int k = 0; k < ADAMS_RPT; ++k) {
    const int r = ty + k * ADAMS_ROWS;
    if (!lane || r >= PECE_NZ) continue;
    if (!valid) {  // outside the history: poison the lane
#pragma unroll
      for (int i = 0; i < ADAMS_KAB; ++i) DF_resc[HIST(i, r)] = NAN;
      z_pred_out[r * sB + b] = NAN;
      continue;
    }
    // t1[i] = sum_{j<p} R[j][i] col[j], then col[i] = sum_{j<p} U[j][i] t1[j]
    // for i < p; each sum runs over j in order from 0, as the plain
    // version's, and the K columns step together (those from p on are
    // dropped), so a step's products are independent
    real t1[ADAMS_K], t2[ADAMS_K];
#pragma unroll
    for (int i = 0; i < ADAMS_K; ++i) t1[i] = t2[i] = 0;
#pragma unroll
    for (int j = 0; j < ADAMS_K; ++j) {
      if (j >= p) break;
#pragma unroll
      for (int i = 0; i < ADAMS_K; ++i)
        t1[i] = r_add(t1[i], r_mul(Rs[j][i][tx], col[k][j]));
    }
#pragma unroll
    for (int j = 0; j < ADAMS_K; ++j) {
      if (j >= p) break;
#pragma unroll
      for (int i = 0; i < ADAMS_K; ++i) t2[i] = r_add(t2[i], r_mul(PECE_U[j][i], t1[j]));
    }
#pragma unroll
    for (int i = 0; i < ADAMS_K; ++i)
      if (i < p) col[k][i] = t2[i];
#pragma unroll
    for (int i = 0; i < ADAMS_KAB; ++i) DF_resc[HIST(i, r)] = col[k][i];
    real acc_z = 0, acc_f = 0;
#pragma unroll
    for (int i = 0; i < ADAMS_K; ++i) {
      if (i < p) {
        acc_z = r_add(acc_z, r_mul(PECE_GAMMA[i], col[k][i]));
        acc_f = r_add(acc_f, col[k][i]);
      }
    }
    const real zp = r_add(zprev[k], r_mul(h, acc_z));
    z_pred_out[r * sB + b] = zp;
    zp_s[r] = zp;
    fex_s[r] = acc_f;
    wz[k] = r_div((real)1, r_add(atol_r[k], r_mul(rtol_r[k], r_abs(zp))));
    w_s[r] = wz[k];
  }
  __syncthreads();
  ADAMS_MARK(1);

  // PECE: one warp per tile, the other row threads wait at the next barrier
  if (ty == 0 && lane) {
    if (valid) {
      bool pred_ok = true;
#pragma unroll
      for (int r = 0; r < PECE_NZ; ++r) pred_ok = pred_ok && isfinite(zp_s[r]);
      real y[PECE_N];
      int niter;
      const bool conv = pece_correct(t, par, zp_s, fex_s, c_A, w_s, act,
                                     pred_ok, newton_tol, maxiter, y, f_s, &niter);
      conv_out[b] = conv ? 1 : 0;
      niter_out[b] = niter;
    } else {
      conv_out[b] = 0;
      niter_out[b] = 0;
    }
  }
  __syncthreads();
  ADAMS_MARK(2);

  // update: difference update, new state, error row and weighted error terms
  if (valid) {
    const real g0_h = r_mul(g0, h), g1_h = r_mul(g1, h), g2_h = r_mul(g2, h);
#pragma unroll
    for (int k = 0; k < ADAMS_RPT; ++k) {
      const int r = ty + k * ADAMS_ROWS;
      if (r >= PECE_NZ) continue;
      const real zp = zp_s[r];
      const real d = r_sub(f_s[r], fex_s[r]);
      // suffix sums S[i] = sum_{j >= i} col[j], from the last row down
      real S[ADAMS_KAB + 1];
      S[ADAMS_KAB] = 0;
#pragma unroll
      for (int i = ADAMS_KAB - 1; i >= 0; --i) S[i] = r_add(S[i + 1], col[k][i]);
      real Sp = 0, col_p = 0;
#pragma unroll
      for (int i = 0; i < ADAMS_KAB; ++i) {
        if (i == p) {
          Sp = S[i];
          col_p = col[k][i];
        }
      }
      // i <= p-1: sum_{j=i..p-1} DF[j] + d;  i == p: d;  i == p+1: d - DF[p]
      real u_lo = 0, u_hi = 0;  // the updated rows p - 1 and p + 1
#pragma unroll
      for (int i = 0; i < ADAMS_KAB; ++i) {
        const real u = i <= p - 1 ? r_add(r_sub(S[i], Sp), d)
                         : i == p   ? d
                         : i == p + 1 ? r_sub(d, col_p)
                                      : col[k][i];
        DF_upd[HIST(i, r)] = u;
        if (i == p - 1) u_lo = u;
        if (i == p + 1) u_hi = u;
      }
      const real e0 = r_mul(g0_h, d);
      z_new_out[r * sB + b] = r_add(zp, r_mul(c_A, d));
      err0_out[r * sB + b] = e0;
      zp_s[r] = r_mul(e0, wz[k]);
      fex_s[r] = r_mul(r_mul(g1_h, u_lo), wz[k]);
      f_s[r] = r_mul(r_mul(g2_h, u_hi), wz[k]);
    }
  } else if (lane) {
#pragma unroll
    for (int k = 0; k < ADAMS_RPT; ++k) {
      const int r = ty + k * ADAMS_ROWS;
      if (r >= PECE_NZ) continue;
#pragma unroll
      for (int i = 0; i < ADAMS_KAB; ++i) DF_upd[HIST(i, r)] = NAN;
      z_new_out[r * sB + b] = NAN;
      err0_out[r * sB + b] = NAN;
    }
  }
#undef HIST
  __syncthreads();
  ADAMS_MARK(3);

  // norms: the weighted squares summed over the rows in row order
  if (ty == 0 && lane) {
    real ss0 = NAN, ss1 = NAN, ss2 = NAN;
    if (valid) {
      ss0 = ss1 = ss2 = 0;
#pragma unroll
      for (int r = 0; r < PECE_NZ; ++r) {
        const real v = v_s[r];
        const real a0 = zp_s[r], a1 = fex_s[r], a2 = f_s[r];
        ss0 = r_add(ss0, r_mul(r_mul(a0, a0), v));
        ss1 = r_add(ss1, r_mul(r_mul(a1, a1), v));
        ss2 = r_add(ss2, r_mul(r_mul(a2, a2), v));
      }
    }
    err3_out[b] = r_sqrt(ss0);
    err3_out[sB + b] = r_sqrt(ss1);
    err3_out[2 * sB + b] = r_sqrt(ss2);
  }
  ADAMS_MARK(4);
#ifdef ADAMS_PHASE_CLOCKS
  if (tx == 0 && ty == 0) atomicAdd(&adams_phase_cycles[5], 1ull);
#endif
}

extern "C" {

// Launch on `stream` without synchronising.  Returns 0, -1 when the shapes
// do not match the compiled system and history depth, -2 when the history
// is deeper than the coefficient tables, or the cudaError_t of the launch.
int adams_attempt_launch(const real* t_new, const real* h_use, const real* pre_factor,
                         const int* order, const unsigned char* active, const real* DF,
                         const real* z_prev, const real* params, const real* atol_z,
                         const real* rtol_z, const real* gamma_star_abs,
                         const real* v_err, double newton_tol, int maxiter, int n_iter,
                         int nz, int kab, int n_p, int n_gamma, int B, real* DF_resc,
                         real* DF_upd, real* z_pred, real* z_new, real* err0,
                         real* err3, unsigned char* conv, int* niter, void* stream) {
  if (n_iter != PECE_N || nz != PECE_NZ || n_p != PECE_NP || kab != ADAMS_KAB) return -1;
  if (kab - 2 > PECE_TABLE_LEN - 1 || n_gamma < kab - 1) return -2;
  if (B <= 0) return 0;
  const dim3 threads(ADAMS_TILE, ADAMS_ROWS);
  const int blocks = (B + ADAMS_TILE - 1) / ADAMS_TILE;
  adams_attempt_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      t_new, h_use, pre_factor, order, active, DF, z_prev, params, atol_z, rtol_z,
      gamma_star_abs, v_err, newton_tol, maxiter, B, DF_resc, DF_upd, z_pred, z_new,
      err0, err3, conv, niter);
  return (int)cudaGetLastError();
}

const char* adams_attempt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#ifdef ADAMS_PHASE_CLOCKS
// Copies the phase cycles and block count into out[6] and zeroes them.
int adams_attempt_phase_cycles(unsigned long long* out) {
  static const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
  cudaError_t e = cudaMemcpyFromSymbol(out, adams_phase_cycles, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(adams_phase_cycles, zero, sizeof(zero));
  return (int)e;
}
#endif

}  // extern "C"
