// Batched banded LU with partial pivoting, and its solve, one thread a lane.
//
// Replaces no TPU kernel.  The JAX package factors a banded Newton matrix
// with one lax.fori_loop over the columns (sunode_tpu/ops/banded.py:
// banded_factor :63, banded_solve :135), vmapped over the lanes, which XLA
// compiles into one device loop.  Written as a torch column loop on the
// host, the same factorization would launch some 12 kernels a column and
// the solve some 5 a row, thousands a Newton attempt at n = 128; this file
// is that device loop, one launch a factorization and one a solve
// (ops/banded.py).
//
// Storage, trailing batch (lane index fastest, so every load and store of a
// warp is one coalesced transaction):
//   ab   (L+U+1, n, B)        ab[U + i - j][j] = A[i][j]
//   lu   (2L+U+1, n+L+U, B)   the reference's expanded working storage: A
//                             from row L down, L fill rows on top, the
//                             right-padding columns' diagonal set to 1; on
//                             return U's rows above row L+U, the
//                             multipliers below it
//   piv  (n, B) int32         the pivot's offset below the diagonal, 0..L
//   sing (B,) bool            a pivot was not above _TINY in magnitude
//   b, x (m, n, B)            m right-hand sides a lane
//
// The factor holds the active block of the elimination, rows k..k+L and
// columns k..k+L+U of A, in registers (L and U are compile-time, -DBAND_L,
// -DBAND_U; one build a bandwidth pair and type): at each column it picks
// the pivot (the first row of largest magnitude among the rows inside the
// matrix, rows past n at -1, NaN counting as largest, as torch.argmax and
// the reference's jnp.argmax pick it), swaps, eliminates, writes U's row k
// and column k's multipliers, and slides the block one row and column on,
// loading the one new row and column, which no earlier column touched.  So
// the column loop carries no load behind a store: the next loads are
// independent of the arithmetic and are issued ahead of it.  The solve
// slides a window of L+1 values forward through the rows (swap, then
// subtract the multipliers) and one of L+U values backward (U's row times
// the solved values, summed in order, over the diagonal).
//
// Every operation rounds on its own (real.cuh's r_mul, r_sub, r_div; the
// build takes -fmad=false too), in the plain version's order, so the
// kernels give the plain PyTorch version's lu, piv, sing and solutions bit
// for bit, singular lanes (NaN) included.
//
// What bounds it on an H100: neither bytes nor operations.  At n = 128,
// L = U = 1, B = 1,024 the factor moves 8.3 MB (2.5 us at 3.35 TB/s) and
// does ~2.6 M flops; but each lane's columns are a chain of dependent
// steps (compare, divide, multiply, subtract), n steps long, and the 1,024
// lanes are 32 warps, a quarter of the SMs.  The design keeps each step
// short (no memory round trip inside the chain) and spreads the lanes over
// as many SMs as there are warps (32 threads a block).
#include "real.cuh"

#ifndef BAND_L
#define BAND_L 1
#endif
#ifndef BAND_U
#define BAND_U 1
#endif
#define BAND_W (BAND_L + BAND_U)   // U's width above the diagonal after pivoting
#define BAND_R (2 * BAND_L + BAND_U + 1)  // rows of the working storage

static constexpr int kThreads = 32;

// The reference's 1e-300 at the build's type: 0 at float.
__device__ __forceinline__ real band_tiny() { return (real)1e-300; }

// The initial working storage at (row r, column j): A's banded rows from
// row L on, zero fill rows above, the padding columns' diagonal 1.
__device__ __forceinline__ real band_init(const real* ab, int r, int j, int n, int B, int lane) {
  if (j >= n) return r == BAND_W ? (real)1 : (real)0;
  if (r < BAND_L) return (real)0;
  return ab[((size_t)(r - BAND_L) * n + j) * B + lane];
}

__global__ void __launch_bounds__(kThreads)
banded_factor_kernel(const real* __restrict__ ab, int n, int B, real* __restrict__ lu,
                     int* __restrict__ piv, unsigned char* __restrict__ sing) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int nw = n + BAND_W;
  // the untouched slots keep their initial values
  for (int r = 0; r < BAND_R; ++r)
    for (int j = 0; j < nw; ++j)
      lu[((size_t)r * nw + j) * B + lane] = band_init(ab, r, j, n, B, lane);

  // a[d][c] = A[k + d][k + c], stored at working row W + d - c, column k + c
  real a[BAND_L + 1][BAND_W + 1];
#pragma unroll
  for (int d = 0; d <= BAND_L; ++d)
#pragma unroll
    for (int c = 0; c <= BAND_W; ++c) a[d][c] = band_init(ab, BAND_W + d - c, c, n, B, lane);

  const real tiny = band_tiny();
  bool singular = false;
  for (int k = 0; k < n; ++k) {
    // pivot: the first row of largest |entry| among rows k..k+L inside A
    real best = r_abs(a[0][0]);
    int p = 0;
#pragma unroll
    for (int d = 1; d <= BAND_L; ++d) {
      const real s = (k + d < n) ? r_abs(a[d][0]) : (real)-1;
      if (!isnan(best) && (isnan(s) || s > best)) {
        best = s;
        p = d;
      }
    }
    // swap rows k and k + p across the block's columns
#pragma unroll
    for (int d = 1; d <= BAND_L; ++d) {
      if (p == d) {
#pragma unroll
        for (int c = 0; c <= BAND_W; ++c) {
          const real t = a[0][c];
          a[0][c] = a[d][c];
          a[d][c] = t;
        }
      }
    }
    real pivot = a[0][0];
    singular = singular || (r_abs(pivot) <= tiny);
    pivot = (r_abs(pivot) > tiny) ? pivot : tiny;
#pragma unroll
    for (int d = 1; d <= BAND_L; ++d) {
      const real m = r_div(a[d][0], pivot);
#pragma unroll
      for (int c = 1; c <= BAND_W; ++c) a[d][c] = r_sub(a[d][c], r_mul(m, a[0][c]));
      a[d][0] = m;
    }
    // U's row k and column k's multipliers are final
#pragma unroll
    for (int c = 0; c <= BAND_W; ++c) lu[((size_t)(BAND_W - c) * nw + k + c) * B + lane] = a[0][c];
#pragma unroll
    for (int d = 1; d <= BAND_L; ++d) lu[((size_t)(BAND_W + d) * nw + k) * B + lane] = a[d][0];
    piv[(size_t)k * B + lane] = p;
    if (k == n - 1) {
      // the rows below the last pivot keep their eliminated values
#pragma unroll
      for (int d = 1; d <= BAND_L; ++d)
#pragma unroll
        for (int c = 1; c <= BAND_W; ++c)
          lu[((size_t)(BAND_W + d - c) * nw + k + c) * B + lane] = a[d][c];
      break;
    }
    // slide: rows k+1..k+1+L, columns k+1..k+1+W; the new row and column
    // hold initial values (no earlier column reached them)
#pragma unroll
    for (int d = 0; d < BAND_L; ++d) {
#pragma unroll
      for (int c = 0; c < BAND_W; ++c) a[d][c] = a[d + 1][c + 1];
      a[d][BAND_W] = band_init(ab, d, k + 1 + BAND_W, n, B, lane);
    }
#pragma unroll
    for (int c = 0; c <= BAND_W; ++c)
      a[BAND_L][c] = band_init(ab, BAND_W + BAND_L - c, k + 1 + c, n, B, lane);
  }
  sing[lane] = singular ? 1 : 0;
}

// One thread a (lane, right-hand side): forward with the row swaps and the
// multipliers, backward with U; NaN where `sing` is given and set.
__global__ void __launch_bounds__(kThreads)
banded_solve_kernel(const real* __restrict__ lu, const int* __restrict__ piv,
                    const unsigned char* __restrict__ sing, const real* __restrict__ b, int n,
                    int B, real* __restrict__ x) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t rhs = (size_t)blockIdx.y * n;  // this right-hand side's first row
  const int nw = n + BAND_W;
  // forward: w[d] = the padded right-hand side at row k + d
  real w[BAND_L + 1];
#pragma unroll
  for (int d = 0; d <= BAND_L; ++d) w[d] = (d < n) ? b[(rhs + d) * B + lane] : (real)0;
  for (int k = 0; k < n; ++k) {
    const int p = piv[(size_t)k * B + lane];
    real bk = w[0];
#pragma unroll
    for (int d = 1; d <= BAND_L; ++d) bk = (p == d) ? w[d] : bk;
#pragma unroll
    for (int d = 1; d <= BAND_L; ++d) w[d] = (p == d) ? w[0] : w[d];
    w[0] = bk;
#pragma unroll
    for (int d = 1; d <= BAND_L; ++d)
      w[d] = r_sub(w[d], r_mul(lu[((size_t)(BAND_W + d) * nw + k) * B + lane], bk));
    x[(rhs + k) * B + lane] = w[0];
#pragma unroll
    for (int d = 0; d < BAND_L; ++d) w[d] = w[d + 1];
    w[BAND_L] = (k + 1 + BAND_L < n) ? b[(rhs + k + 1 + BAND_L) * B + lane] : (real)0;
  }
  // backward: v[c - 1] = x[k + c], zero past n
  const real tiny = band_tiny();
  real v[BAND_W + 1];
#pragma unroll
  for (int c = 0; c <= BAND_W; ++c) v[c] = (real)0;
  for (int k = n - 1; k >= 0; --k) {
    real s = x[(rhs + k) * B + lane];
    if (BAND_W > 0) {
      real acc = r_mul(lu[((size_t)(BAND_W - 1) * nw + k + 1) * B + lane], v[0]);
#pragma unroll
      for (int c = 2; c <= BAND_W; ++c)
        acc = r_add(acc, r_mul(lu[((size_t)(BAND_W - c) * nw + k + c) * B + lane], v[c - 1]));
      s = r_sub(s, acc);
    }
    real diag = lu[((size_t)BAND_W * nw + k) * B + lane];
    diag = (r_abs(diag) > tiny) ? diag : tiny;
    const real xk = r_div(s, diag);
    x[(rhs + k) * B + lane] = xk;
#pragma unroll
    for (int c = BAND_W; c > 0; --c) v[c] = v[c - 1];
    v[0] = xk;
  }
  if (sing != nullptr && sing[lane]) {
    for (int k = 0; k < n; ++k) x[(rhs + k) * B + lane] = (real)NAN;
  }
}

extern "C" {

// Each launches on `stream` without synchronising and returns -1 for
// bandwidths other than the build's, else the cudaError_t of the launch.
int banded_factor_launch(const real* ab, int lower, int upper, int n, int B, real* lu, int* piv,
                         unsigned char* sing, void* stream) {
  if (lower != BAND_L || upper != BAND_U) return -1;
  if (B <= 0 || n <= 0) return 0;
  banded_factor_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      ab, n, B, lu, piv, sing);
  return (int)cudaGetLastError();
}

int banded_solve_launch(const real* lu, const int* piv, const unsigned char* sing, const real* b,
                        int lower, int upper, int n, int m, int B, real* x, void* stream) {
  if (lower != BAND_L || upper != BAND_U) return -1;
  if (B <= 0 || n <= 0 || m <= 0) return 0;
  const dim3 blocks((B + kThreads - 1) / kThreads, m);
  banded_solve_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(lu, piv, sing, b, n, B, x);
  return (int)cudaGetLastError();
}

const char* banded_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
