// One Adams PECE attempt at a compile-time order, on a flat history.
//
// Replaces the TPU kernel scripts/exp_pallas2d.py::pece_2d_pallas: the
// attempt of sunode_tpu/ops/pallas_step.py at a static order P and a fixed
// sweep count, on a flattened (K*N, B) history, with the Lotka-Volterra
// right-hand side built in.  The TPU kernel worked in double-float f32
// pairs because Mosaic has no float64; this one works in native float64:
//   predictor   acc = sum_{i<P} gamma_i blk_i,  fex = sum_{i<P} blk_i,
//               y_pred = y_prev + h acc,  c_A = h gamma_{P-1}
//               (blk_i = rows [i*N, (i+1)*N) of the history)
//   corrector   PECE2D_SWEEPS sweeps of y <- y_pred + c_A (f(t, y) - fex),
//               with no rate, convergence or divergence test
//   final       d_f = f(t, y) - fex,  err = |gamma*_P| h d_f
//
// What sets it apart from csrc/pece_step.cu (kernel 1) is the
// specialisation: the order PECE2D_P and the sweep count PECE2D_SWEEPS are
// -D defines, so the predictor and the sweeps are fully unrolled, the
// coefficients are compile-time indices into the constant tables, and no
// lane reads an order, an activity flag or a tolerance, or runs a test.
// The parameters are one (PECE_NP,) vector shared by every lane, as the
// TPU kernel's were constants.
//
// Layout: one thread per lane, the lane axis contiguous in every operand,
// so every load and store of a warp is one coalesced transaction.  The
// right-hand side pece_fz() is the forward system that
// sunode_torch/symode/cuda_codegen.py emits into pece_rhs.h; it is inlined,
// so y, f and the history sums stay in registers.
//
// What bounds it on an H100: not arithmetic (a few dozen flops a sweep).
// At B = 10,240 it reads 6 x 2 history rows, y_prev, h and t (1.31 MB) and
// writes 3 x 2 rows (0.49 MB): 0.54 us at 3.35 TB/s, below the time a
// launch takes.  The design answers with the least per-lane work and
// traffic that the attempt allows, in one launch; 64-thread blocks give
// 160 blocks for 10,240 lanes, more than the 132 SMs.

#include <cuda_runtime.h>
#include <math.h>

#include "pece_tables.h"  // PECE_TABLE_LEN, PECE_GAMMA[], PECE_GAMMA_STAR_ABS[]
#include "pece_rhs.h"     // PECE_N, PECE_NZ, PECE_NP, pece_fz()

#ifndef PECE2D_P
#error "build with -DPECE2D_P=<order>"
#endif
#ifndef PECE2D_SWEEPS
#error "build with -DPECE2D_SWEEPS=<corrector sweeps>"
#endif
static_assert(PECE2D_P >= 1 && PECE2D_P + 1 <= PECE_TABLE_LEN,
              "order outside the Adams tables");
static_assert(PECE2D_SWEEPS >= 0, "negative sweep count");
static_assert(PECE_N == PECE_NZ, "the flat-history attempt has no quadrature rows");

#define PECE2D_THREADS 64
#define PECE2D_NP_ALLOC (PECE_NP > 0 ? PECE_NP : 1)

__global__ void __launch_bounds__(PECE2D_THREADS)
pece_2d_kernel(const double* __restrict__ DF,      // (K*N, B)
               const double* __restrict__ y_prev,  // (N, B)
               const double* __restrict__ h_row,   // (1, B)
               const double* __restrict__ t_row,   // (1, B)
               const double* __restrict__ params,  // (NP,), shared by all lanes
               int B,
               double* __restrict__ y_out,    // (N, B)
               double* __restrict__ d_out,    // (N, B)
               double* __restrict__ err_out)  // (N, B)
{
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  const double h = h_row[b];
  const double t = t_row[b];

  double par[PECE2D_NP_ALLOC];
#pragma unroll
  for (int j = 0; j < PECE_NP; ++j) par[j] = params[j];

  double acc[PECE_N], fex[PECE_N];
#pragma unroll
  for (int r = 0; r < PECE_N; ++r) {
    acc[r] = 0.0;
    fex[r] = 0.0;
  }
#pragma unroll
  for (int i = 0; i < PECE2D_P; ++i) {
    const double g = PECE_GAMMA[i];
#pragma unroll
    for (int r = 0; r < PECE_N; ++r) {
      const double d = DF[(size_t)(i * PECE_N + r) * sB + b];
      acc[r] = acc[r] + g * d;
      fex[r] = fex[r] + d;
    }
  }

  double yp[PECE_N], y[PECE_N];
#pragma unroll
  for (int r = 0; r < PECE_N; ++r) {
    yp[r] = y_prev[r * sB + b] + h * acc[r];
    y[r] = yp[r];
  }
  const double c_A = h * PECE_GAMMA[PECE2D_P - 1];

  double f[PECE_NZ];
#pragma unroll
  for (int k = 0; k < PECE2D_SWEEPS; ++k) {
    pece_fz(t, y, par, f);
#pragma unroll
    for (int r = 0; r < PECE_N; ++r) y[r] = yp[r] + c_A * (f[r] - fex[r]);
  }

  pece_fz(t, y, par, f);
  const double gsp_h = PECE_GAMMA_STAR_ABS[PECE2D_P] * h;
#pragma unroll
  for (int r = 0; r < PECE_N; ++r) {
    const double d = f[r] - fex[r];
    y_out[r * sB + b] = y[r];
    d_out[r * sB + b] = d;
    err_out[r * sB + b] = gsp_h * d;
  }
}

extern "C" {

// Launch on `stream` without synchronising.  Returns 0, -1 when the shapes
// do not match the compiled system, -2 when the history holds fewer than
// PECE2D_P blocks, or the cudaError_t of the launch.
int pece_2d_launch(const double* DF, const double* y_prev, const double* h,
                   const double* t_new, const double* params, int k, int n,
                   int n_p, int B, double* y_out, double* d_out,
                   double* err_out, void* stream) {
  if (n != PECE_N || n_p != PECE_NP) return -1;
  if (k < PECE2D_P) return -2;
  if (B <= 0) return 0;
  const int blocks = (B + PECE2D_THREADS - 1) / PECE2D_THREADS;
  pece_2d_kernel<<<blocks, PECE2D_THREADS, 0, (cudaStream_t)stream>>>(
      DF, y_prev, h, t_new, params, B, y_out, d_out, err_out);
  return (int)cudaGetLastError();
}

const char* pece_2d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
