// The Adams attempt with its right-hand side outside the kernel: three
// kernels, with the caller's torch right-hand side between them.
//
// Replaces, for problems whose right-hand side is torch code (no system
// emitted from sympy, so the fused csrc/adams_attempt.cu cannot hold it),
// the TPU kernel sunode_tpu/ops/pallas_step.py::adams_pece_attempt_pallas
// (predictor, corrector sweeps, final evaluation, error estimate) and the
// history arithmetic the JAX main path left to XLA around it
// (sunode_tpu/ops/adams_batched.py: _rescale :376-399, the corrector
// :456-520, _update :989-1007, the error rows :617-632).  The plain PyTorch
// versions are split_predict, split_sweep and split_finish in
// sunode_torch/ops/adams_split.py; per element every product, difference
// and quotient is rounded on its own (r_mul, r_div, ...: __dmul_rn or
// __fmul_rn, ...), in their order, so only the sums over the rows (dy_norm,
// err3) add in another order.  A build computes at one type `real`
// (real.cuh: float64, or float32 with -DSUNODE_REAL=float, each keyed on it
// by the wrapper), the plain stages' type.
//
//   split_predict  R(fac) then U = R(1) on each history column's leading p
//                  rows (identity elsewhere), DF_resc, z_pred = z_prev +
//                  h sum_{i<p} gamma_i DF_resc[i], f_ex = sum_{i<p}
//                  DF_resc[i], w_z = 1 / (atol + rtol |z_pred|); per lane
//                  c_A = h gamma_{p-1} and pred_ok (z_pred finite);
//   split_sweep    one corrector sweep on fz_k = f(t, y_it): z_next = z_pred
//                  + c_A (fz_k - f_ex), y_next, and per lane dy_norm = the
//                  weighted RMS of z_next - y_it over the n state rows, then
//                  the conv/div/bad/niter/dy_old update (the rate tests);
//   split_finish   d = fz - f_ex, z_new, err0 = |gamma*_p| h d, the
//                  accepted-step difference update DF_upd, and per lane the
//                  three weighted error norms err3 (orders p, p-1, p+1) and
//                  the attempt's conv.
//
// A state split over devices (ops/adams_split.py::adams_split_attempt_rows)
// cuts the sweep and the finish at their sums over the rows, so that each
// device's block of rows is summed on its own:
//
//   split_sweep_rows     a kernel of its own: a block's y_next, and per lane
//                        and cluster rank of the unsplit sweep's row
//                        partition its partial sum of squares and non-finite
//                        flag; before its rows it decides the previous
//                        sweep from every block's partials (sweep_decide, the
//                        sweep's own tail), so the decision has no launch;
//   split_finish_rows    the finish kernel with ROWS: a block's rows and per
//                        lane its three sums of squares, without the roots;
//   split_finish_lanes   a warp a lane: the last sweep's decision, then
//                        err3's roots and conv (finish_lane, the finish's own
//                        tail).
//
// The partials add in the unsplit sweep's order: each rank's in rank order
// into a block's sum, the blocks' in block order.  At one block the rows
// are summed as the unsplit kernels sum them and one root is taken of the
// same sum: the composition is the unsplit attempt bit for bit.  The lanes'
// kernel moves a few bytes a lane: its launch and one round trip to device
// memory bound it, not the card's rates.
//
// What bounds them on an H100: bytes.  At SIR over 1,000 regions (nz =
// 3,000) and B = 1,024 the history is 11 x 3,000 x 1,024 x 8 B = 270 MB;
// predict and finish each read it once and write it once (predict 639 MB
// in all, 0.19 ms at 3.35 TB/s; finish ~0.21 ms), a sweep moves six (n, B)
// rows (~0.04 ms).  The rescale's arithmetic is 4 K^2 f64 products and sums
// a row (K = KAB - 2), under half the time of its bytes.  A float32 build
// moves half the bytes, and its f32 operations have twice the f64 rate.
//
// Layout: the history is (KAB, nz, B), lane-contiguous.
//
// Predict's and the sweep's geometry follows (nz, B), chosen by
// ops/adams_split.py (predict_geometry, sweep_geometry) and passed in: a
// block is SWEEP_THREADS threads, a tile of L lanes (threadIdx.x) by 256 / L
// row threads (threadIdx.y), and covers `rows` consecutive rows; the C
// blocks of a lane tile (gridDim.x, 16 at most) form one thread-block
// cluster along the rows, gridDim.y walks the tiles.  Predict takes 32
// lanes (16 only where half the SMs would get no block) and the largest C
// up to 16 that gives each block a step of rows: the card holds 14 of its
// clusters of 16 at once and 30 of 8, no multiple of the 32 tiles at
// B = 1,024, so many short blocks fill it more evenly than one wave of 8s.
// The sweep takes 32 lanes (16 where the card would not fill, more where
// nz is small) and the smallest C that gives two blocks an SM.  Thread
// (x, y) of cluster rank c reads rows c rows + y + j (256 / L), j = 0, 1,
// ..., below min((c + 1) rows, nz): predict one row a step, the sweep
// SWEEP_UNROLL rows a step whose loads are all issued before any of them is
// used.  Per lane, each block sums its rows per lane (the sweep's squares in
// row order, in shared memory over its row threads in order; predict's
// non-finite flags), and after a cluster barrier the rank-0 block adds the
// blocks' sums in rank order through distributed shared memory, then a
// second barrier keeps every block's shared memory alive until rank 0 has
// read it: a fixed order, no global scratch, no counter, no fill.
//
// Predict: R'(fac) of each of the block's lanes is built once into shared
// memory (K x K x L values; R(fac) inside the lane's leading p block, the
// identity outside, as the plain version masks it), the K columns' running
// products spread over the row threads and each quotient by a small integer
// the exact div_small() of div_small.cuh; at (3,000, 1,024) a block's
// tables serve 188 rows, not 64.  A thread walks
// its rows one a step and holds two: the one it computes, and the next,
// whose loads it issues before the arithmetic, so that they are in flight
// while it runs.  U = R(1)
// is the constant table PECE_U of pece_tables.h, its entries read as the
// products' operands; it is lower-triangular (U[j][i] = +-0 for j > i), so
// the plain version's masked sum over all K rows j comes to U's over
// j <= i inside the block, and to the identity's outside, each NaN where
// the plain sum meets 0 x inf.  Every other sum runs over all K rows in
// the plain version's order, so a non-finite history element spreads to
// the same outputs as there.  At one row a step the kernel takes 114-122
// registers, so two blocks (16 warps) share an SM; measured on an H100,
// that beat two rows a step, whose every R'[j][i] read serves both rows,
// with the next step in flight (188 registers, one block an SM) and
// without it (the loads exposed), at every path shape.
//
// Why no tensor cores (wgmma) or TMA in predict: every lane has its own
// K x K factor R(fac) restricted to its own order, so a matrix unit has no
// operand shared across lanes to reuse, and a lane's product is at most
// 9 x 9 (order 8); the history's lane axis is contiguous, so coalesced
// loads of a warp's 32 lanes already read whole 256-byte lines at full
// width, and a TMA tile would only stage in shared memory what each thread
// reads once into its registers.
//
// The sweep reads f as the right-hand side returns it: row-major, or
// lane-major (a torch right-hand side mapped over the lanes with vmap), then
// through a shared-memory tile per step, so that no transposing copy
// precedes the launch.
//
// Finish: a block is a tile of 32 lanes (threadIdx.x) by 8
// row threads (threadIdx.y) and covers a chunk of 64 rows (blockIdx.y);
// blockIdx.x walks the lane tiles.  Per-lane sums over the rows: each block
// sums its rows per lane through shared memory (in row-thread order) into
// a partial per (chunk, lane); the last block of a lane tile to finish (a
// counter per tile, zeroed by a memset at each launch, and a fence) adds
// the partials in chunk order, so the result does not depend on the
// blocks' schedule, and writes the lane's outputs.  Rows that fit one chunk
// (a small TorchProblem, the sensitivity block of a staggered solve) take a
// form of their own with none of that: a dense tile of lanes by min(nz, 8)
// row threads whose sums go straight to the lane's tail (ONE_CHUNK below).
//
// Lanes with p outside the history (p < 1 or p > KAB - 2) are poisoned with
// NaN, as the fused kernel poisons them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "pece_tables.h"  // PECE_TABLE_LEN, PECE_GAMMA[], PECE_GAMMA_STAR_ABS[], PECE_U[][]
#include "div_small.cuh"  // div_small(): t / j rounded as r_div
#include "real.cuh"       // real (SUNODE_REAL), r_add, r_mul, ...

#ifndef ADAMS_KAB
#error "build with -DADAMS_KAB=<history rows>, that is P_MAX + 3"
#endif
#define ADAMS_K (ADAMS_KAB - 2)  // rows 0..P_MAX + 1 of the R(fac)U block
// the constants ops/adams_split.py mirrors under the same names
#define SPLIT_TILE 32            // lanes of a finish block
#define SPLIT_ROWS 8             // row threads of a finish block
#define SPLIT_CHUNK 64           // rows of a finish block
#define SWEEP_THREADS 256        // threads of a predict or sweep block (SWEEP_THREADS)
#define SWEEP_UNROLL 4           // rows a sweep thread loads at once (SWEEP_UNROLL)
#define SWEEP_CLUSTER_MAX 16     // blocks of a cluster, with the non-portable size allowed
#define PREDICT_LANES_MAX 32     // lanes of a predict tile at most (PREDICT_LANES_MAX)
#define ROWS_WAVE 2              // rows a thread of the rows' sweep loads at once (ROWS_WAVE)
#define ROWS_BLOCKS_MAX 16       // blocks of a state split whose partials one sweep reads
#define ROWS_SEGMENTS_MAX 4      // row segments of a block read in place (ROWS_SEGMENTS_MAX)
#define ROWS_PEND_SLOTS (4 * SWEEP_THREADS)  // pending partials a block stages (rank, lane)
#define ROWS_FOLD_BATCH 8        // pending partials a decision reads before it adds them
#define LANES_WARPS 4            // lanes of a lanes' finish block, a warp each
#define LANES_PARTIALS_MAX (ROWS_BLOCKS_MAX * SWEEP_CLUSTER_MAX)  // a lane's pending partials

#if ADAMS_K > PECE_TABLE_LEN - 1
#error "history deeper than the Adams tables"
#endif
static_assert(sizeof(real) * ADAMS_K * ADAMS_K * PREDICT_LANES_MAX +
                      sizeof(int) * SWEEP_THREADS <= 48 * 1024,
              "predict's R tables exceed a block's static shared memory");

// element (i, r) of a (KAB, nz, B) history, lane b
#define HIST(i, r) (((size_t)(i) * nz + (r)) * sB + b)

#ifdef SPLIT_PHASE_CLOCKS
// A trace of predict and the sweep by phase: the cycles from each mark to
// the next on thread (0, 0) of a block, summed over the blocks of every
// launch since the last read, and the blocks counted in the last slot
// (split_ab.py --phase-clocks).  Predict: R(fac) and U built, the rows, the
// block's flag sum, the lane tail.  Sweep: the rows, the block's sum, the
// first cluster barrier, rank 0's reads and the second barrier, rank 0's
// tail.  The rows' sweep: its first wave's loads issued, the decision, the
// rows (the loads' wait with them), the block's sum, its partials written.
__device__ unsigned long long split_phase_cycles[6];
#define SPLIT_MARK(k)                                                        \
  if (tx == 0 && ty == 0) {                                                  \
    const long long now = clock64();                                         \
    atomicAdd(&split_phase_cycles[k], (unsigned long long)(now - mark));     \
    mark = now;                                                              \
  }
#define SPLIT_COUNT_BLOCK() \
  if (tx == 0 && ty == 0) atomicAdd(&split_phase_cycles[5], 1ull);
#else
#define SPLIT_MARK(k)
#define SPLIT_COUNT_BLOCK()
#endif

// True in every thread of the block that finished its lane tile last; its
// partials, and those of every other block of the tile, are then visible.
__device__ bool last_block_of_tile(unsigned int* done, int n_chunks) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0)
    last = atomicAdd(done + blockIdx.x, 1u) == (unsigned int)(n_chunks - 1);
  __syncthreads();
  return last;
}

// Sum of v over the row threads of lane threadIdx.x, in row-thread order;
// valid in the threads with threadIdx.y == 0.
__device__ __forceinline__ real sum_rows(real v, real (*s)[SPLIT_TILE]) {
  s[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  real acc = 0;
  if (threadIdx.y == 0) {
#pragma unroll
    for (int k = 0; k < SPLIT_ROWS; ++k) acc = r_add(acc, s[k][threadIdx.x]);
  }
  __syncthreads();
  return acc;
}

__device__ __forceinline__ bool order_ok(int p) { return p >= 1 && p <= ADAMS_K; }

// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(SWEEP_THREADS, 2)  // two blocks an SM
split_predict_kernel(const real* __restrict__ DF, const int* __restrict__ order,
                     const real* __restrict__ pre_factor, const real* __restrict__ h_use,
                     const real* __restrict__ z_prev, const real* __restrict__ atol_z,
                     const real* __restrict__ rtol_z, int nz, int B, int rows,
                     real* __restrict__ DF_resc, real* __restrict__ z_pred,
                     real* __restrict__ f_ex, real* __restrict__ w_z,
                     real* __restrict__ c_A, unsigned char* __restrict__ pred_ok) {
  // R'[j][i] of the tile's lanes: R(fac) inside the lane's leading p block,
  // the identity outside, as the plain version masks it
  __shared__ real Rs[ADAMS_K][ADAMS_K][PREDICT_LANES_MAX];
  __shared__ int bad_s[SWEEP_THREADS];  // (row thread, lane), then the block's flag per lane
  const int tx = threadIdx.x, ty = threadIdx.y, L = blockDim.x, T = blockDim.y;
#ifdef SPLIT_PHASE_CLOCKS
  long long mark = clock64();
#endif
  const int b = blockIdx.y * L + tx;
  const bool lane = b < B;
  const size_t sB = (size_t)B;
  const int p = lane ? order[b] : 1;
  const bool valid = lane && order_ok(p);
  const real fac = valid ? pre_factor[b] : (real)0;
  const real h = valid ? h_use[b] : (real)0;
  const int r_begin = blockIdx.x * rows, r_end = min(r_begin + rows, nz);  // the block's rows

  // R(fac)[j][i] = R[j-1][i] ((j-1) - fac i) / j: column i's running product
  // over j < p, the K columns over the row threads
  if (valid) {
    for (int i = ty; i < ADAMS_K; i += T) {
      const real fi = r_mul(fac, (real)i);
      real c = 1;
      Rs[0][i][tx] = i < p ? 1 : 0;
#pragma unroll
      for (int j = 1; j < ADAMS_K; ++j) {
        const bool in = j < p && i < p;
        if (in) c = div_small(r_mul(c, r_sub((real)(j - 1), fi)), j);
        Rs[j][i][tx] = in ? c : (real)(i == j ? 1 : 0);
      }
    }
  }
  __syncthreads();
  SPLIT_MARK(0);

  int nonfinite = 0;
  if (!valid) {  // outside the history: poison the lane
    if (lane) {
      for (int r = r_begin + ty; r < r_end; r += T) {
#pragma unroll
        for (int i = 0; i < ADAMS_KAB; ++i) DF_resc[HIST(i, r)] = NAN;
        z_pred[r * sB + b] = f_ex[r * sB + b] = w_z[r * sB + b] = NAN;
      }
    }
  } else {
    // one row a step, r = ty, ty + T, ...; the next row's loads are issued
    // before this row's arithmetic, so that they are in flight while it runs
    real col[ADAMS_KAB], nx_col[ADAMS_KAB], nx_zprev, nx_atol, nx_rtol;
    // the loads of row r (none past the block's rows) into the next row's registers
    auto load_next = [&](int r) {
      const bool row = r < r_end;
#pragma unroll
      for (int i = 0; i < ADAMS_KAB; ++i) nx_col[i] = row ? DF[HIST(i, r)] : (real)0;
      nx_zprev = row ? z_prev[r * sB + b] : (real)0;
      nx_atol = row ? atol_z[r] : (real)0;
      nx_rtol = row ? rtol_z[r] : (real)0;
    };
    load_next(r_begin + ty);
    for (int r = r_begin + ty; r < r_end; r += T) {
      // the tables are read anew each step: held in registers across the
      // steps (the compiler's choice without this), R' alone would take 162
      asm volatile("" ::: "memory");
#pragma unroll
      for (int i = 0; i < ADAMS_KAB; ++i) col[i] = nx_col[i];
      const real zprev = nx_zprev, atol_r = nx_atol, rtol_r = nx_rtol;
      load_next(r + T);
#pragma unroll
      for (int i = ADAMS_K; i < ADAMS_KAB; ++i) DF_resc[HIST(i, r)] = col[i];  // copied as they are
      // t1[i] = sum_j R'[j][i] col[j] over all K rows j in order from 0, as
      // the plain version's sum, the masked entries multiplying as 0.0 or 1.0
      real t1[ADAMS_K];
      unsigned int bad = 0u;  // bit j: t1[j] not finite
#pragma unroll
      for (int i = 0; i < ADAMS_K; ++i) {
        real acc = 0;
#pragma unroll
        for (int j = 0; j < ADAMS_K; ++j) acc = r_add(acc, r_mul(Rs[j][i][tx], col[j]));
        t1[i] = acc;
        bad |= isfinite(acc) ? 0u : 1u << i;
      }
      // DF_resc[i] = sum_j U'[j][i] t1[j] in the plain version's order, U'
      // = U inside the lane's leading p block and the identity outside.
      // U[j][i] is 0 (signed) for j > i, as is U'[j][i] wherever it is not
      // U's, and x + (+-0) = x for every sum here (none starts at -0): so
      // inside the block the sum is U's over j <= i, NaN if a later t1[j]
      // is not finite (0 x inf); outside it is 0 + t1[i], NaN if another
      // t1[j] is not finite.  U's entries are the constant table's, read
      // as operands.  With each DF_resc[i], the predictor's and the
      // extrapolation's sums over all K rows, those from p on multiplied
      // by 0.0.
      real acc_z = 0, acc_f = 0;
#pragma unroll
      for (int i = 0; i < ADAMS_K; ++i) {
        real v;
        if (i < p) {
          v = 0;
#pragma unroll
          for (int j = 0; j <= i; ++j) v = r_add(v, r_mul(PECE_U[j][i], t1[j]));
          if (bad >> (i + 1)) v = NAN;
        } else {
          v = (bad & ~(1u << i)) ? NAN : r_add((real)0, t1[i]);
        }
        DF_resc[HIST(i, r)] = v;
        acc_z = r_add(acc_z, i < p ? r_mul(PECE_GAMMA[i], v) : r_mul((real)0, v));
        acc_f = r_add(acc_f, i < p ? v : r_mul((real)0, v));
      }
      const real zp = r_add(zprev, r_mul(h, acc_z));
      z_pred[r * sB + b] = zp;
      f_ex[r * sB + b] = acc_f;
      w_z[r * sB + b] = r_div((real)1, r_add(atol_r, r_mul(rtol_r, r_abs(zp))));
      if (!isfinite(zp)) nonfinite = 1;
    }
  }
  SPLIT_MARK(1);
  // the block's flag per lane, over its row threads, into slot tx
  bad_s[ty * L + tx] = nonfinite;
  __syncthreads();
  if (ty == 0) {
    for (int y = 1; y < T; ++y) nonfinite |= bad_s[y * L + tx];
    bad_s[tx] = nonfinite;
  }
  SPLIT_MARK(2);
  // the cluster's flag per lane, over its blocks in rank order, in rank 0
  const int C = gridDim.x;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  if (C > 1) cluster.sync();
  const bool tail = blockIdx.x == 0 && ty == 0 && lane;
  if (tail)
    for (int c = 1; c < C; ++c) nonfinite |= cluster.map_shared_rank(&bad_s[0], c)[tx];
  // no block leaves while rank 0 may still read its shared memory
  if (C > 1) cluster.sync();
  if (tail) {
    pred_ok[b] = valid && !nonfinite;
    c_A[b] = valid ? r_mul(h, PECE_GAMMA[p - 1]) : NAN;
  }
  SPLIT_MARK(3);
  SPLIT_COUNT_BLOCK();
}

// The sweep's decision for lane b from its sum of squares ss over the n
// state rows: dy_norm, the rate tests and the masked state update.
__device__ __forceinline__ void sweep_decide(
    int b, int k, real ss, int nonfinite, bool live, const unsigned char* __restrict__ conv,
    const unsigned char* __restrict__ div, const unsigned char* __restrict__ bad,
    const real* __restrict__ dy_old, const int* __restrict__ niter, double newton_tol,
    double tol_lo, int fixed, int n, unsigned char* __restrict__ conv_o,
    unsigned char* __restrict__ div_o, unsigned char* __restrict__ bad_o,
    real* __restrict__ dy_old_o, int* __restrict__ niter_o) {
  const real dy_norm = r_sqrt(r_div(ss, (real)n));
  const real rate = r_div(dy_norm, dy_old[b]);
  bool conv_new = false, div_new = false;
  if (!fixed) {
    conv_new = dy_norm == 0 ||
               (k > 0 && rate < 1 &&
                r_mul(r_div(rate, r_sub((real)1, rate)), dy_norm) < (real)newton_tol) ||
               dy_norm < (real)tol_lo;
    div_new = rate >= 2 && k > 0;
  }
  const bool bad_n = bad[b] || (live && nonfinite);
  conv_o[b] = conv[b] || (live && conv_new && !bad_n);
  div_o[b] = div[b] || (live && div_new && !conv_new);
  bad_o[b] = bad_n;
  niter_o[b] = niter[b] + (live ? 1 : 0);
  dy_old_o[b] = live ? dy_norm : dy_old[b];
}

// ---------------------------------------------------------------------------
// FZ_LANE_MAJOR: fz arrives lane-major (element (r, b) at b nz + r), as a
// right-hand side mapped over the lanes with vmap returns it.  Each step's
// (SWEEP_UNROLL row threads' rows) x (lanes) tile of it is then read along
// the rows, 256 bytes a warp, into shared memory and read back by lane, in
// place of a transposing copy before the launch.
template <bool FZ_LANE_MAJOR>
__global__ void __launch_bounds__(SWEEP_THREADS)
split_sweep_kernel(int k, const real* __restrict__ fz, const real* __restrict__ y_it,
                   const real* __restrict__ z_pred, const real* __restrict__ f_ex,
                   const real* __restrict__ w_z, const real* __restrict__ c_A,
                   const unsigned char* __restrict__ conv, const unsigned char* __restrict__ div,
                   const unsigned char* __restrict__ bad, const real* __restrict__ dy_old,
                   const int* __restrict__ niter, double newton_tol, double tol_lo, int fixed,
                   int n, int nz, int B, int rows, real* __restrict__ y_next,
                   unsigned char* __restrict__ conv_o, unsigned char* __restrict__ div_o,
                   unsigned char* __restrict__ bad_o, real* __restrict__ dy_old_o,
                   int* __restrict__ niter_o) {
  __shared__ real ss_s[SWEEP_THREADS];  // (row thread, lane), then the block's sum per lane
  __shared__ int bad_s[SWEEP_THREADS];
  // a step's fz tile, (rows) x (lanes + 1): the odd stride keeps a warp's
  // reads of one row and its writes of one lane's rows off each other's banks
  __shared__ real fz_s[FZ_LANE_MAJOR ? SWEEP_THREADS * SWEEP_UNROLL + 64 : 1];
  const int tx = threadIdx.x, ty = threadIdx.y, L = blockDim.x, T = blockDim.y;
#ifdef SPLIT_PHASE_CLOCKS
  long long mark = clock64();
#endif
  const int b = blockIdx.y * L + tx;
  const bool lane = b < B;
  const size_t sB = (size_t)B;
  const bool live = lane && !(conv[b] || div[b] || bad[b]);
  const real cA = lane ? c_A[b] : (real)0;
  const int r_begin = blockIdx.x * rows, r_end = min(r_begin + rows, nz);  // the block's rows
  const int step = T * SWEEP_UNROLL;
  real ss = 0;
  int nonfinite = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += step) {  // the same steps in every thread
    real f[SWEEP_UNROLL], fe[SWEEP_UNROLL], zp[SWEEP_UNROLL], yi[SWEEP_UNROLL],
        w[SWEEP_UNROLL];
    if (FZ_LANE_MAJOR) {
      // the tile's element e = (row e % step, lane e / step): a warp reads
      // consecutive rows of one lane, contiguous in fz
      const int tid = ty * L + tx;
#pragma unroll
      for (int u = 0; u < SWEEP_UNROLL; ++u) {
        const int e = tid + u * SWEEP_THREADS, row = e % step, lane_t = e / step;
        const int r = r0 + row, bb = blockIdx.y * L + lane_t;
        fz_s[row * (L + 1) + lane_t] =
            (r < r_end && bb < B) ? fz[(size_t)bb * nz + r] : (real)0;
      }
    }
#pragma unroll
    for (int u = 0; u < SWEEP_UNROLL; ++u) {  // every load of the step first
      const int r = r0 + ty + u * T;
      const bool row = lane && r < r_end, state = row && r < n;
      if (!FZ_LANE_MAJOR) f[u] = row ? fz[r * sB + b] : (real)0;
      fe[u] = state ? f_ex[r * sB + b] : (real)0;
      zp[u] = state ? z_pred[r * sB + b] : (real)0;
      yi[u] = state ? y_it[r * sB + b] : (real)0;
      w[u] = state ? w_z[r * sB + b] : (real)0;
    }
    if (FZ_LANE_MAJOR) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < SWEEP_UNROLL; ++u) f[u] = fz_s[(ty + u * T) * (L + 1) + tx];
      __syncthreads();  // the tile is read before the next step writes it
    }
#pragma unroll
    for (int u = 0; u < SWEEP_UNROLL; ++u) {
      const int r = r0 + ty + u * T;
      if (!lane || r >= r_end) break;
      if (!isfinite(f[u])) nonfinite = 1;  // the quadrature rows too
      if (r < n) {
        const real zn = r_add(zp[u], r_mul(cA, r_sub(f[u], fe[u])));
        const real q = r_mul(r_sub(zn, yi[u]), w[u]);
        ss = r_add(ss, r_mul(q, q));
        y_next[r * sB + b] = live ? zn : yi[u];
      }
    }
  }
  SPLIT_MARK(0);
  // the block's sum per lane, over its row threads in order, into slot tx
  ss_s[ty * L + tx] = ss;
  bad_s[ty * L + tx] = nonfinite;
  __syncthreads();
  if (ty == 0) {  // every load first, then the sums in order (T <= SWEEP_THREADS / 16)
    real v[SWEEP_THREADS / 16];
#pragma unroll
    for (int y = 1; y < SWEEP_THREADS / 16; ++y) {
      v[y] = y < T ? ss_s[y * L + tx] : (real)0;
      nonfinite |= y < T ? bad_s[y * L + tx] : 0;
    }
#pragma unroll
    for (int y = 1; y < SWEEP_THREADS / 16; ++y)
      if (y < T) ss = r_add(ss, v[y]);
    ss_s[tx] = ss;
    bad_s[tx] = nonfinite;
  }
  // the cluster's sum per lane, over its blocks in rank order, in rank 0
  const int C = gridDim.x;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  SPLIT_MARK(1);
  if (C > 1) cluster.sync();
  SPLIT_MARK(2);
  const bool tail = blockIdx.x == 0 && ty == 0 && lane;
  if (tail && C > 1) {
    ss = 0;
    nonfinite = 0;
    for (int c = 0; c < C; ++c) {
      ss = r_add(ss, cluster.map_shared_rank(&ss_s[0], c)[tx]);
      nonfinite |= cluster.map_shared_rank(&bad_s[0], c)[tx];
    }
  }
  // no block leaves while rank 0 may still read its shared memory
  if (C > 1) cluster.sync();
  SPLIT_MARK(3);
  SPLIT_COUNT_BLOCK();
  if (!tail) return;
  sweep_decide(b, k, ss, nonfinite, live, conv, div, bad, dy_old, niter, newton_tol, tol_lo,
               fixed, n, conv_o, div_o, bad_o, dy_old_o, niter_o);
  SPLIT_MARK(4);
}

// ---------------------------------------------------------------------------
// The state split's sweep (split_sweep_rows), a kernel of its own.
//
// Unlike the unsplit sweep, whose blocks of a lane tile meet in a cluster, a
// block of the rows' sweep answers to no other block: it writes its own
// partial per lane and cluster rank of sweep_geometry(nz, B) (a (C, B)
// output each block fills once: no fill, no counter, no cluster barrier),
// and the next kernel adds them.  The launch is sweep_geometry's grid
// without its cluster, so the row partition, and with it every sum, is the
// unsplit sweep's: thread (x, y) of rank c sums its rows c rows + y + j T in
// row order, the block its row threads in order.
//
// A thread loads ROWS_WAVE rows at once (every load of the wave issued
// before any is used), the five fields of a row in registers.  Measured on
// an H100 at (1,502, 256), six rows a thread, with builds at other wave
// sizes (PERF.md, section 6): all six at once took 18.4 µs from HBM, 2 or
// 3 a wave 14.0, 1 a wave 15.4.  With every row in flight the SM's load
// queue fills, a thread cannot even issue its loads for ~6,800 cycles, and
// the shared-memory reads of the decision queue behind them; two rows a
// wave keep the queue moving and the grid's 256 blocks still hold ~5 MB in
// flight.  What a thread reads it reads once, so staging it in shared
// memory (TMA or cp.async) would add a copy and a barrier for no reuse.
// Only a lane-major f goes through shared memory, as a tile copied along
// the rows with cp.async (each warp 256 contiguous bytes), because read by
// lane it would not coalesce.
//
// The decision of the sweep before (pend.blocks > 0): each lane's ss is its
// partials added in rank order into each block's sum, then the blocks' sums
// in block order (parallel/rows.py::lane_sum's order), its flags ORed; then
// sweep_decide, in every row thread of the lane, after its loads are
// issued and before it stores a row: no thread waits on another to store.
// The lane's state and the partials are loaded first, the partials copied
// into shared memory by all the block's threads (read by one thread alone,
// one load after another behind the grid's 18 MB, they cost ~10,000 cycles
// a block on an H100).  Rank 0 of each tile writes the decided state where
// the caller asks for it (one launch a device).
//
// f is read in place: its element (r, b) of the block's local row r at
// global row map(r) of the whole right-hand side, map(r) - map.global[s] =
// r - map.local[s] for the last segment s with map.local[s] <= r, at
// map(r) fz_row + b fz_lane.  Rows below n are the block's state rows, the
// rest quadrature rows (flagged when not finite, not summed).
struct RowMap {
  int segs;
  int local[ROWS_SEGMENTS_MAX];
  int global[ROWS_SEGMENTS_MAX];
};

struct Pending {
  int blocks;  // 0: no sweep before this one
  int k;       // the sweep that left them
  const real* ss[ROWS_BLOCKS_MAX];  // (ranks, B) each
  const unsigned char* nf[ROWS_BLOCKS_MAX];
  int start[ROWS_BLOCKS_MAX + 1];  // block d's partials are rows start[d] .. start[d + 1] - 1
};

// The block whose partials hold pending row j.
__device__ __forceinline__ int pending_block(const Pending& pend, int j) {
  int d = 0;
#pragma unroll
  for (int e = 1; e < ROWS_BLOCKS_MAX; ++e)
    if (e < pend.blocks && j >= pend.start[e]) d = e;
  return d;
}

__device__ __forceinline__ long long map_row(const RowMap& map, int r) {
  int g = map.global[0] + r - map.local[0];
#pragma unroll
  for (int s = 1; s < ROWS_SEGMENTS_MAX; ++s)
    if (s < map.segs && r >= map.local[s]) g = map.global[s] + r - map.local[s];
  return g;
}

// A lane's decision of the pending sweep from its state *conv, *div, *bad,
// *dy_old and *niter (registers where the caller passes locals): the new
// state into *_o; returns it live.  get(d, j, v, f) reads pending row j (of
// block d) of the lane: its sum and flag.  ROWS_FOLD_BATCH rows are read
// before any is added, so their loads are in flight together; the adds keep
// rank order, then block order.
template <class Get>
__device__ __forceinline__ bool decide_pending(
    const Pending& pend, Get get, const unsigned char* __restrict__ conv,
    const unsigned char* __restrict__ div, const unsigned char* __restrict__ bad,
    const real* __restrict__ dy_old, const int* __restrict__ niter, double newton_tol,
    double tol_lo, int fixed, int n_all, unsigned char* c_o, unsigned char* d_o,
    unsigned char* b_o, real* dy_o, int* ni_o) {
  const bool live = !(*conv || *div || *bad);
  real ss = 0;
  int nonfinite = 0;
  for (int d = 0; d < pend.blocks; ++d) {
    const int j_begin = pend.start[d], j_end = pend.start[d + 1];
    real t = 0;
    for (int j0 = j_begin; j0 < j_end; j0 += ROWS_FOLD_BATCH) {
      real v[ROWS_FOLD_BATCH];
      int f[ROWS_FOLD_BATCH];
#pragma unroll
      for (int u = 0; u < ROWS_FOLD_BATCH; ++u) {
        v[u] = 0;
        f[u] = 0;
        if (j0 + u < j_end) get(d, j0 + u, v[u], f[u]);
      }
#pragma unroll
      for (int u = 0; u < ROWS_FOLD_BATCH; ++u) {
        if (j0 + u >= j_end) break;
        t = j0 + u == j_begin ? v[u] : r_add(t, v[u]);
        nonfinite |= f[u];
      }
    }
    ss = d == 0 ? t : r_add(ss, t);
  }
  sweep_decide(0, pend.k, ss, nonfinite, live, conv, div, bad, dy_old, niter, newton_tol, tol_lo,
               fixed, n_all, c_o, d_o, b_o, dy_o, ni_o);
  return !(*c_o || *d_o || *b_o);
}

__device__ __forceinline__ void copy_async(real* dst, const real* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(sizeof(real)), "r"(in ? (int)sizeof(real) : 0)
               : "memory");
}

template <bool FZ_LANE_MAJOR>
__global__ void __launch_bounds__(SWEEP_THREADS, 2)  // two blocks an SM at least
split_sweep_rows_kernel(const real* __restrict__ fz, long long fz_row, long long fz_lane,
                        RowMap map, const real* __restrict__ y_it,
                        const real* __restrict__ z_pred, const real* __restrict__ f_ex,
                        const real* __restrict__ w_z, const real* __restrict__ c_A,
                        const unsigned char* __restrict__ conv,
                        const unsigned char* __restrict__ div,
                        const unsigned char* __restrict__ bad, const real* __restrict__ dy_old,
                        const int* __restrict__ niter, Pending pend, double newton_tol,
                        double tol_lo, int fixed, int n_all, int n, int nz, int B, int rows,
                        real* __restrict__ y_next, real* __restrict__ part_ss,
                        unsigned char* __restrict__ part_nf, unsigned char* __restrict__ conv_o,
                        unsigned char* __restrict__ div_o, unsigned char* __restrict__ bad_o,
                        real* __restrict__ dy_old_o, int* __restrict__ niter_o) {
  __shared__ real ss_s[SWEEP_THREADS];  // (row thread, lane), then the block's sum per lane
  __shared__ int bad_s[SWEEP_THREADS];
  // a wave's f tile, (rows) x (lanes + 1), T ROWS_WAVE (L + 1) <= ROWS_WAVE
  // (SWEEP_THREADS + 16) values: the odd stride keeps a warp's copies of
  // one lane's rows and its reads of one row off each other's banks
  __shared__ real fz_s[FZ_LANE_MAJOR ? ROWS_WAVE * (SWEEP_THREADS + 16) : 1];
  // the pending partials of the tile's lanes, (partial row) x (lane)
  __shared__ real pend_s[ROWS_PEND_SLOTS];
  __shared__ unsigned char pendf_s[ROWS_PEND_SLOTS];
  const int tx = threadIdx.x, ty = threadIdx.y, L = blockDim.x, T = blockDim.y;
#ifdef SPLIT_PHASE_CLOCKS
  long long mark = clock64();
#endif
  const int b = blockIdx.y * L + tx;
  const bool lane = b < B;
  const size_t sB = (size_t)B;
  const int tid = ty * L + tx;
  // the lane's state, before anything else: every row thread decides its
  // lane, so that none waits on another before it stores its rows
  unsigned char conv_r = 0, div_r = 0, bad_r = 0;
  real dy_old_r = 0;
  int niter_r = 0;
  if (lane) {
    conv_r = conv[b];
    div_r = div[b];
    bad_r = bad[b];
    if (pend.blocks > 0) {
      dy_old_r = dy_old[b];
      niter_r = niter[b];
    }
  }
  // The pending partials next, so that they arrive ahead of the rows: the
  // block's threads copy (cp.async) the first ROWS_PEND_SLOTS / L partial
  // rows of the tile's lanes, a warp 32 lanes of a row, and load their
  // flags; a lane's decision then adds them from shared memory (any row
  // past those from device memory).
  const int staged = pend.blocks > 0 ? min(pend.start[pend.blocks], ROWS_PEND_SLOTS / L) : 0;
  int flags_in[ROWS_PEND_SLOTS / SWEEP_THREADS];
  if (pend.blocks > 0) {
#pragma unroll
    for (int u = 0; u < ROWS_PEND_SLOTS / SWEEP_THREADS; ++u) {
      const int i = tid + u * SWEEP_THREADS, j = i / L, bb = blockIdx.y * L + i % L;
      const bool in = j < staged && bb < B;
      const int d = in ? pending_block(pend, j) : 0;
      const size_t at = (size_t)(j - pend.start[d]) * sB + bb;
      copy_async(&pend_s[i], in ? pend.ss[d] + at : fz, in);
      flags_in[u] = in ? pend.nf[d][at] : 0;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const real cA = lane ? c_A[b] : (real)0;
  const int r_begin = blockIdx.x * rows, r_end = min(r_begin + rows, nz);  // the block's rows
  const int wave = T * ROWS_WAVE;
  bool live = lane && !(conv_r || div_r || bad_r);
  real ss = 0;
  int nonfinite = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += wave) {  // the same waves in every thread
    real f[ROWS_WAVE], fe[ROWS_WAVE], zp[ROWS_WAVE], yi[ROWS_WAVE], w[ROWS_WAVE];
    if (FZ_LANE_MAJOR) {
      // the tile's element e = (row e % wave, lane e / wave): a warp copies
      // consecutive rows of one lane, contiguous in f within a segment
#pragma unroll
      for (int u = 0; u < ROWS_WAVE; ++u) {
        const int e = tid + u * SWEEP_THREADS, row = e % wave, lane_t = e / wave;
        const int r = r0 + row, bb = blockIdx.y * L + lane_t;
        const bool in = r < r_end && bb < B;
        copy_async(&fz_s[row * (L + 1) + lane_t],
                   in ? fz + map_row(map, r) * fz_row + (long long)bb * fz_lane : fz, in);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
#pragma unroll
    for (int u = 0; u < ROWS_WAVE; ++u) {  // every load of the wave first
      const int r = r0 + ty + u * T;
      const bool row = lane && r < r_end, state = row && r < n;
      if (!FZ_LANE_MAJOR)
        f[u] = row ? fz[map_row(map, r) * fz_row + (long long)b * fz_lane] : (real)0;
      fe[u] = state ? f_ex[r * sB + b] : (real)0;
      zp[u] = state ? z_pred[r * sB + b] : (real)0;
      yi[u] = state ? y_it[r * sB + b] : (real)0;
      w[u] = state ? w_z[r * sB + b] : (real)0;
    }
    if (r0 == r_begin) {  // the pending decision, while the rows' loads are in flight
      SPLIT_MARK(0);
      if (pend.blocks > 0) {
#pragma unroll
        for (int u = 0; u < ROWS_PEND_SLOTS / SWEEP_THREADS; ++u)
          pendf_s[tid + u * SWEEP_THREADS] = (unsigned char)flags_in[u];
        // the partials' group, not a lane-major f's tile committed after it
        if (FZ_LANE_MAJOR)
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        else
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();
        if (lane) {
          auto get = [&](int d, int j, real& v, int& f) {
            if (j < staged) {
              v = pend_s[j * L + tx];
              f = pendf_s[j * L + tx];
            } else {
              const size_t at = (size_t)(j - pend.start[d]) * sB + b;
              v = pend.ss[d][at];
              f = pend.nf[d][at];
            }
          };
          unsigned char c_o, d_o, b_o;
          real dy_o;
          int ni_o;
          live = decide_pending(pend, get, &conv_r, &div_r, &bad_r, &dy_old_r, &niter_r,
                                newton_tol, tol_lo, fixed, n_all, &c_o, &d_o, &b_o, &dy_o, &ni_o);
          if (ty == 0 && blockIdx.x == 0 && conv_o != nullptr) {
            conv_o[b] = c_o;
            div_o[b] = d_o;
            bad_o[b] = b_o;
            dy_old_o[b] = dy_o;
            niter_o[b] = ni_o;
          }
        }
      }
      SPLIT_MARK(1);
    }
    if (FZ_LANE_MAJOR) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();  // the tile
#pragma unroll
      for (int u = 0; u < ROWS_WAVE; ++u) f[u] = fz_s[(ty + u * T) * (L + 1) + tx];
      __syncthreads();  // the tile is read before the next wave copies into it
    }
#pragma unroll
    for (int u = 0; u < ROWS_WAVE; ++u) {
      const int r = r0 + ty + u * T;
      if (!lane || r >= r_end) break;
      if (!isfinite(f[u])) nonfinite = 1;  // the quadrature rows too
      if (r < n) {
        const real zn = r_add(zp[u], r_mul(cA, r_sub(f[u], fe[u])));
        const real q = r_mul(r_sub(zn, yi[u]), w[u]);
        ss = r_add(ss, r_mul(q, q));
        y_next[r * sB + b] = live ? zn : yi[u];
      }
    }
  }
  SPLIT_MARK(2);
  // the block's sum per lane, over its row threads in order
  ss_s[ty * L + tx] = ss;
  bad_s[ty * L + tx] = nonfinite;
  __syncthreads();
  if (ty == 0) {  // every load first, then the sums in order (T <= SWEEP_THREADS / 16)
    real v[SWEEP_THREADS / 16];
#pragma unroll
    for (int y = 1; y < SWEEP_THREADS / 16; ++y) {
      v[y] = y < T ? ss_s[y * L + tx] : (real)0;
      nonfinite |= y < T ? bad_s[y * L + tx] : 0;
    }
#pragma unroll
    for (int y = 1; y < SWEEP_THREADS / 16; ++y)
      if (y < T) ss = r_add(ss, v[y]);
    SPLIT_MARK(3);
    if (lane) {  // this rank's partial, (C, B)
      part_ss[blockIdx.x * sB + b] = ss;
      part_nf[blockIdx.x * sB + b] = nonfinite;
    }
  }
  SPLIT_MARK(4);
  SPLIT_COUNT_BLOCK();
}

// Lane b's error norms from its three sums of squares, and the attempt's conv.
__device__ __forceinline__ void finish_lane(int b, size_t sB, real t0, real t1, real t2,
                                            const unsigned char* __restrict__ conv,
                                            const unsigned char* __restrict__ bad,
                                            const unsigned char* __restrict__ pred_ok, int fixed,
                                            real* __restrict__ err3,
                                            unsigned char* __restrict__ conv_o) {
  err3[b] = r_sqrt(t0);
  err3[sB + b] = r_sqrt(t1);
  err3[2 * sB + b] = r_sqrt(t2);
  const bool c0 = fixed ? (conv[b] || !bad[b]) : conv[b];
  conv_o[b] = c0 && !bad[b] && pred_ok[b];
}

// ---------------------------------------------------------------------------
// ROWS: one block of a state split over devices (split_finish_rows): err3
// receives each lane's three sums of squares over the block's rows, without
// the roots, and conv_o, conv, bad and pred_ok are not touched (the lanes'
// form, split_finish_lanes_kernel, takes the roots of the summed rows).
//
// ONE_CHUNK: the rows fit one chunk (nz <= SPLIT_CHUNK; finish_tile).  A
// block is then a dense tile of blockDim.x lanes by blockDim.y = min(nz,
// SPLIT_ROWS) row threads, none of them without a row, and each lane's three
// sums go from its row threads through shared memory (one barrier), added in
// row-thread order, straight to finish_lane: no partials, no counter, no
// fill.  The sums are the multi-chunk form's bit for bit: there every row
// thread past nz adds +0, and the one chunk's partial is added to +0, to a
// sum that is never -0 (it starts at +0).  A row's loads need not wait for
// the lane's order: a lane outside the history computes its rows and then
// poisons them; the tail's conv, bad and pred_ok are loaded with the lane's
// order, h and c_A.
template <bool ROWS, bool ONE_CHUNK>
__global__ void __launch_bounds__(SPLIT_TILE * SPLIT_ROWS)
split_finish_kernel(const real* __restrict__ fz, const real* __restrict__ DF_resc,
                    const real* __restrict__ z_pred, const real* __restrict__ f_ex,
                    const real* __restrict__ w_z, const real* __restrict__ c_A,
                    const unsigned char* __restrict__ pred_ok, const int* __restrict__ order,
                    const real* __restrict__ h_use, const real* __restrict__ gamma_star_abs,
                    const real* __restrict__ v_err, const unsigned char* __restrict__ conv,
                    const unsigned char* __restrict__ bad, int fixed, int nz, int B,
                    real* __restrict__ DF_upd, real* __restrict__ z_new,
                    real* __restrict__ err0, real* __restrict__ err3,
                    unsigned char* __restrict__ conv_o, real* part, unsigned int* done) {
  // the row threads' sums of a lane; the one-chunk form's three of them
  __shared__ real red[ONE_CHUNK ? 3 * SPLIT_ROWS : SPLIT_ROWS][SPLIT_TILE];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int L = ONE_CHUNK ? (int)blockDim.x : SPLIT_TILE;  // lanes of the tile
  const int T = ONE_CHUNK ? (int)blockDim.y : SPLIT_ROWS;  // its row threads
#ifdef SPLIT_PHASE_CLOCKS
  long long mark = clock64();
#endif
  const int b = blockIdx.x * L + tx;
  const bool lane = b < B;
  const size_t sB = (size_t)B;
  const int p = lane ? order[b] : 1;
  const bool valid = lane && order_ok(p);
  const real h = lane ? h_use[b] : (real)0;
  const real cA = lane ? c_A[b] : (real)0;
  unsigned char conv_r = 0, bad_r = 0, ok_r = 0;  // the one-chunk form's tail, loaded first
  if (ONE_CHUNK && ty == 0 && lane) {
    conv_r = conv[b];
    bad_r = bad[b];
    ok_r = pred_ok[b];
  }
  // the error rows' coefficients at orders p, p - 1 and p + 1 (at most P_MAX + 1)
  const real g0 = valid ? r_mul(PECE_GAMMA_STAR_ABS[p], h) : NAN;
  const real g1 = valid ? r_mul(gamma_star_abs[p - 1], h) : NAN;
  const real g2 = valid ? r_mul(gamma_star_abs[min(p + 1, ADAMS_K)], h) : NAN;
  const int r_end = min((int)(blockIdx.y + 1) * SPLIT_CHUNK, nz);
  real ss0 = 0, ss1 = 0, ss2 = 0;
  if (lane) {
    for (int r = blockIdx.y * SPLIT_CHUNK + ty; r < r_end; r += T) {
      if (!ONE_CHUNK && !valid) {
#pragma unroll
        for (int i = 0; i < ADAMS_KAB; ++i) DF_upd[HIST(i, r)] = NAN;
        z_new[r * sB + b] = err0[r * sB + b] = NAN;
        ss0 = ss1 = ss2 = NAN;
        continue;
      }
      const real d = r_sub(fz[r * sB + b], f_ex[r * sB + b]);
      z_new[r * sB + b] = r_add(z_pred[r * sB + b], r_mul(cA, d));
      const real e0 = r_mul(g0, d);
      err0[r * sB + b] = e0;
      real col[ADAMS_KAB];
#pragma unroll
      for (int i = 0; i < ADAMS_KAB; ++i) col[i] = DF_resc[HIST(i, r)];
      // suffix sums S[i] = sum_{j >= i} col[j], from the last row down
      real S[ADAMS_KAB + 1];
      S[ADAMS_KAB] = 0;
#pragma unroll
      for (int i = ADAMS_KAB - 1; i >= 0; --i) S[i] = r_add(S[i + 1], col[i]);
      real Sp = 0, col_p = 0, upd_m = 0, upd_p = 0;
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
        const real u = i <= p - 1 ? r_add(r_sub(S[i], Sp), d)
                         : i == p   ? d
                         : i == p + 1 ? r_sub(d, col_p)
                                      : col[i];
        DF_upd[HIST(i, r)] = u;
        if (i == p - 1) upd_m = u;
        if (i == p + 1) upd_p = u;
      }
      const real wz = w_z[r * sB + b], v = v_err[r];
      const real a0 = r_mul(e0, wz);
      const real a1 = r_mul(r_mul(g1, upd_m), wz);
      const real a2 = r_mul(r_mul(g2, upd_p), wz);
      ss0 = r_add(ss0, r_mul(r_mul(a0, a0), v));
      ss1 = r_add(ss1, r_mul(r_mul(a1, a1), v));
      ss2 = r_add(ss2, r_mul(r_mul(a2, a2), v));
      if (ONE_CHUNK && !valid) {  // outside the history: poison the row, as above
#pragma unroll
        for (int i = 0; i < ADAMS_KAB; ++i) DF_upd[HIST(i, r)] = NAN;
        z_new[r * sB + b] = err0[r * sB + b] = NAN;
        ss0 = ss1 = ss2 = NAN;
      }
    }
  }
  SPLIT_MARK(0);
  if (ONE_CHUNK) {
    real* s = &red[0][0];  // (sum, row thread, lane)
    const int n = L * T, i = ty * L + tx;
    s[i] = ss0;
    s[n + i] = ss1;
    s[2 * n + i] = ss2;
    __syncthreads();
    SPLIT_MARK(1);
    SPLIT_COUNT_BLOCK();
    if (ty != 0 || !lane) return;
    real t0 = 0, t1 = 0, t2 = 0;
    for (int k = 0; k < T; ++k) {  // the row threads in order, as sum_rows adds them
      t0 = r_add(t0, s[k * L + tx]);
      t1 = r_add(t1, s[n + k * L + tx]);
      t2 = r_add(t2, s[2 * n + k * L + tx]);
    }
    finish_lane(0, sB, t0, t1, t2, &conv_r, &bad_r, &ok_r, fixed, err3 + b, conv_o + b);
    SPLIT_MARK(3);
    return;
  }
  const real s0 = sum_rows(ss0, red);
  const real s1 = sum_rows(ss1, red);
  const real s2 = sum_rows(ss2, red);
  SPLIT_MARK(1);
  const size_t sP = (size_t)gridDim.y * sB;  // one (chunks, B) block per error row
  if (ty == 0 && lane) {
    part[blockIdx.y * sB + b] = s0;
    part[sP + blockIdx.y * sB + b] = s1;
    part[2 * sP + blockIdx.y * sB + b] = s2;
  }
  const bool last = last_block_of_tile(done, gridDim.y);
  SPLIT_MARK(2);
  SPLIT_COUNT_BLOCK();
  if (!last || ty != 0 || !lane) return;
  real t0 = 0, t1 = 0, t2 = 0;
  for (int c = 0; c < (int)gridDim.y; ++c) {
    t0 = r_add(t0, *((volatile const real*)part + c * sB + b));
    t1 = r_add(t1, *((volatile const real*)part + sP + c * sB + b));
    t2 = r_add(t2, *((volatile const real*)part + 2 * sP + c * sB + b));
  }
  if (ROWS) {
    err3[b] = t0;
    err3[sB + b] = t1;
    err3[2 * sB + b] = t2;
    return;
  }
  finish_lane(b, sB, t0, t1, t2, conv, bad, pred_ok, fixed, err3, conv_o);
  SPLIT_MARK(3);
}

// A load issued where it stands: the compiler may sink a read-only load down
// to its first use, past other loads' waits (asm volatile keeps its place).
__device__ __forceinline__ double load_now(const double* p) {
  double v;
  asm volatile("ld.global.nc.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float load_now(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int load_now(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned char load_now(const unsigned char* p) {
  unsigned int v;
  asm volatile("ld.global.nc.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return (unsigned char)v;
}

// The lanes' finish after the rows' finishes of a state split over devices:
// first the last sweep's decision (sweep_decide on each lane's ss over every
// block's partials, where pend.blocks > 0), then err3's roots of ss3 (3, B),
// each lane's three sums over every block added in block order
// (parallel/rows.py::lane_sum), and the attempt's conv (finish_lane) on the
// decided conv and bad; niter_o the decided sweeps' count.
//
// A warp a lane, LANES_WARPS lanes a block, so that the state split's B = 256
// lanes spread over 64 SMs.  Every thread of a lane's warp loads the lane's
// state, ss3 and pred_ok (one request a warp), and thread k its partials j =
// k, k + 32, ... (every block's ranks, LANES_PARTIALS_MAX at most) and their
// flags, all before any is used: one round trip to device memory, where one
// thread a lane read its partials ROWS_FOLD_BATCH at a time, four rounds at
// 32 partials.  A partial's block comes from selects over the blocks' starts,
// not an indexed read of the kernel's parameters.  The partials go into
// shared memory, the flags into one vote, and the warp's first thread adds
// the partials in decide_pending's order (a left fold: within a block in rank
// order, then the blocks' sums in block order; a tree would round otherwise,
// and only this order gives the plain stage's bits), a block's reads all
// issued before its adds, decides and writes the lane.
__global__ void __launch_bounds__(32 * LANES_WARPS)
split_finish_lanes_kernel(const real* __restrict__ ss3, const unsigned char* __restrict__ conv,
                          const unsigned char* __restrict__ div,
                          const unsigned char* __restrict__ bad, const real* __restrict__ dy_old,
                          const int* __restrict__ niter, const unsigned char* __restrict__ pred_ok,
                          Pending pend, double newton_tol, double tol_lo, int fixed, int n_all,
                          int B, real* __restrict__ err3, unsigned char* __restrict__ conv_o,
                          int* __restrict__ niter_o) {
  __shared__ real part_s[LANES_WARPS][LANES_PARTIALS_MAX];  // (lane, partial)
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;  // a lane's thread, the lane
#ifdef SPLIT_PHASE_CLOCKS
  long long mark = clock64();
#endif
  const int b = blockIdx.x * LANES_WARPS + ty;
  if (b >= B) return;  // the whole warp
  const size_t sB = (size_t)B;
  unsigned char conv_r = load_now(conv + b), div_r = load_now(div + b);
  unsigned char bad_r = load_now(bad + b), ok_r = load_now(pred_ok + b);
  real dy_old_r = load_now(dy_old + b);
  int niter_r = load_now(niter + b);
  const real t0 = load_now(ss3 + b), t1 = load_now(ss3 + sB + b),
             t2 = load_now(ss3 + 2 * sB + b);
  const int P = pend.start[pend.blocks];  // the lane's partials, 0 without a sweep pending
  real v[LANES_PARTIALS_MAX / 32];
  int nonfinite = 0;
#pragma unroll
  for (int c = 0; c < LANES_PARTIALS_MAX / 32; ++c) {
    if (32 * c >= P) break;  // the same in the whole warp
    const int j = tx + 32 * c;
    const real* ss = pend.ss[0];
    const unsigned char* nf = pend.nf[0];
    int row = j;  // j's row of its block's partials
#pragma unroll
    for (int d = 1; d < ROWS_BLOCKS_MAX; ++d) {
      if (d < pend.blocks && j >= pend.start[d]) {
        ss = pend.ss[d];
        nf = pend.nf[d];
        row = j - pend.start[d];
      }
    }
    v[c] = j < P ? ss[(size_t)row * sB + b] : (real)0;
    nonfinite |= j < P ? nf[(size_t)row * sB + b] : 0;
  }
#pragma unroll
  for (int c = 0; c < LANES_PARTIALS_MAX / 32; ++c)
    if (tx + 32 * c < P) part_s[ty][tx + 32 * c] = v[c];
  nonfinite = __any_sync(0xffffffffu, nonfinite);
  __syncwarp();
  SPLIT_MARK(0);
  if (tx != 0) return;
  unsigned char c_o = conv_r, d_o = div_r, b_o = bad_r;
  real dy_o = dy_old_r;
  int ni_o = niter_r;
  if (pend.blocks > 0) {
    const real* s = part_s[ty];
    real ss = 0;
#pragma unroll
    for (int d = 0; d < ROWS_BLOCKS_MAX; ++d) {
      if (d >= pend.blocks) break;
      const int j0 = pend.start[d], ranks = pend.start[d + 1] - j0;
      real u[SWEEP_CLUSTER_MAX];  // the block's partials, every read before the adds
#pragma unroll
      for (int r = 0; r < SWEEP_CLUSTER_MAX; ++r) u[r] = r < ranks ? s[j0 + r] : (real)0;
      real t = u[0];
#pragma unroll
      for (int r = 1; r < SWEEP_CLUSTER_MAX; ++r)
        if (r < ranks) t = r_add(t, u[r]);
      ss = d == 0 ? t : r_add(ss, t);
    }
    sweep_decide(0, pend.k, ss, nonfinite, !(conv_r || div_r || bad_r), &conv_r, &div_r, &bad_r,
                 &dy_old_r, &niter_r, newton_tol, tol_lo, fixed, n_all, &c_o, &d_o, &b_o, &dy_o,
                 &ni_o);
  }
  SPLIT_MARK(1);
  finish_lane(0, sB, t0, t1, t2, &c_o, &b_o, &ok_r, fixed, err3 + b, conv_o + b);
  niter_o[b] = ni_o;
  SPLIT_MARK(2);
  SPLIT_COUNT_BLOCK();
}

#undef HIST

// ---------------------------------------------------------------------------
static int grid_for(int nz, int B, dim3* grid) {
  const int chunks = (nz + SPLIT_CHUNK - 1) / SPLIT_CHUNK;
  if (chunks > 65535) return -3;
  *grid = dim3((B + SPLIT_TILE - 1) / SPLIT_TILE, chunks);
  return 0;
}

// The finish's tile at nz rows, as split_finish_launch takes it: one chunk
// of rows takes the one-chunk form on a dense tile of min(nz, SPLIT_ROWS) row
// threads by as many lanes as fill SPLIT_TILE x SPLIT_ROWS threads, more
// chunks the multi-chunk form's SPLIT_TILE x SPLIT_ROWS (ops/adams_split.py::
// finish_geometry mirrors it).
static dim3 finish_tile(int nz) {
  if (nz > SPLIT_CHUNK) return dim3(SPLIT_TILE, SPLIT_ROWS);
  const int rows = nz < 1 ? 1 : nz < SPLIT_ROWS ? nz : SPLIT_ROWS;
  return dim3(SPLIT_TILE * SPLIT_ROWS / rows, rows);
}

// Whether tiles of `lanes` lanes by SWEEP_THREADS / lanes row threads,
// `rows` rows a block and `cluster` blocks a tile cover (nz, B) exactly
// once with no empty block, on a grid and a cluster the card takes.
static bool covers(int nz, int B, int lanes, int rows, int cluster) {
  return lanes >= 16 && SWEEP_THREADS % lanes == 0 && rows >= 1 && cluster >= 1 &&
         cluster <= SWEEP_CLUSTER_MAX && (long long)cluster * rows >= nz &&
         (long long)(cluster - 1) * rows < nz && (B + lanes - 1) / lanes <= 65535;
}

// Whether predict's, the row-major and the lane-major sweep's kernel (and
// the rows' sweep's two, which take no cluster) allow the non-portable
// cluster size yet.
static bool non_portable[5] = {false, false, false, false, false};

// The launch of a kernel on that geometry: the tile's blocks one cluster
// along gridDim.x.  A cluster above the portable 8 needs the kernel's
// non-portable attribute, set at its first such launch (outside any graph
// capture) and remembered in *allowed.
static cudaError_t cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                                  const void* kernel, bool* allowed, int B, int lanes,
                                  int cluster, void* stream) {
  *cfg = {};
  cfg->gridDim = dim3(cluster, (B + lanes - 1) / lanes);
  cfg->blockDim = dim3(lanes, SWEEP_THREADS / lanes);
  cfg->stream = (cudaStream_t)stream;
  if (cluster == 1) return cudaSuccess;
  if (cluster > 8 && !*allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    *allowed = true;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

extern "C" {

// Each launch goes on `stream` without synchronising and returns 0, -1
// when the history depth is not the build's (or, for the sweep, n > nz),
// -3 when the geometry does not cover (nz, B) exactly once (or, for the
// finish, nz needs more row chunks than a grid has), or a cudaError_t.
// Finish's `part` and `done` are scratch of (3, chunks, B) and (lane
// tiles,), its counters zeroed by a fill before the launch; predict and
// the sweep take none.

// Predict on the geometry of ops/adams_split.py::predict_geometry: lane
// tiles of `lanes` lanes (at most PREDICT_LANES_MAX), `rows` rows a block,
// `cluster` blocks a tile along the rows.
int split_predict_launch(const real* DF, const int* order, const real* pre_factor,
                         const real* h_use, const real* z_prev, const real* atol_z,
                         const real* rtol_z, int kab, int nz, int B, int lanes, int rows,
                         int cluster, real* DF_resc, real* z_pred, real* f_ex, real* w_z,
                         real* c_A, unsigned char* pred_ok, void* stream) {
  if (kab != ADAMS_KAB) return -1;
  if (B <= 0 || nz <= 0) return 0;
  if (lanes > PREDICT_LANES_MAX || !covers(nz, B, lanes, rows, cluster)) return -3;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config(&cfg, attr, (const void*)split_predict_kernel,
                                   &non_portable[0], B, lanes, cluster, stream);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, split_predict_kernel, DF, order, pre_factor, h_use, z_prev,
                             atol_z, rtol_z, nz, B, rows, DF_resc, z_pred, f_ex, w_z, c_A,
                             pred_ok);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The sweep on the geometry of ops/adams_split.py::sweep_geometry: lane
// tiles of `lanes` lanes, `rows` rows a block, `cluster` blocks a tile along
// the rows; fz row-major (nz, B) or, with `fz_lane_major`, lane-major.
int split_sweep_launch(int k, const real* fz, const real* y_it, const real* z_pred,
                       const real* f_ex, const real* w_z, const real* c_A,
                       const unsigned char* conv, const unsigned char* div,
                       const unsigned char* bad, const real* dy_old, const int* niter,
                       double newton_tol, double tol_lo, int fixed, int n, int nz, int B,
                       int fz_lane_major, int lanes, int rows, int cluster, real* y_next,
                       unsigned char* conv_o, unsigned char* div_o, unsigned char* bad_o,
                       real* dy_old_o, int* niter_o, void* stream) {
  if (n > nz) return -1;
  if (B <= 0 || nz <= 0) return 0;
  if (!covers(nz, B, lanes, rows, cluster)) return -3;
  auto kernel = fz_lane_major ? split_sweep_kernel<true> : split_sweep_kernel<false>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config(&cfg, attr, (const void*)kernel,
                                   &non_portable[fz_lane_major ? 2 : 1], B, lanes, cluster,
                                   stream);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, kernel, k, fz, y_it, z_pred, f_ex, w_z, c_A, conv, div, bad,
                             dy_old, niter, newton_tol, tol_lo, fixed, n, nz, B, rows, y_next,
                             conv_o, div_o, bad_o, dy_old_o, niter_o);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The pending decision's partials from host arrays of `blocks` pointers and
// rank counts; -1 for more blocks than a launch takes.
static int pending_from(int blocks, int k, const real* const* ss, const unsigned char* const* nf,
                        const int* ranks, Pending* pend) {
  if (blocks < 0 || blocks > ROWS_BLOCKS_MAX) return -1;
  *pend = {};
  pend->blocks = blocks;
  pend->k = k;
  for (int d = 0; d < blocks; ++d) {
    if (ranks[d] < 1) return -1;
    pend->ss[d] = ss[d];
    pend->nf[d] = nf[d];
    pend->start[d + 1] = pend->start[d] + ranks[d];
  }
  return 0;
}

// One block of a state split over devices: the rows' sweep on the sweep's
// geometry (`lanes`, `rows`; `ranks` blocks a tile, no cluster).  f's
// element (r, b) of local row r is fz[map(r) fz_row + b fz_lane] (f row-
// major with fz_lane 1, lane-major with fz_row 1, either in place), map
// from `segs` segments (seg_local[s], seg_global[s]) of host arrays.  The
// pending partials of `pend_blocks` blocks (host arrays of pointers and
// rank counts; 0 at the first sweep) are decided first, with newton_tol,
// fixed and n_all the whole state's rows; with conv_o non-null, rank 0
// writes the decided state.  Writes y_next and part_ss / part_nf (ranks,
// B).  -1 for n > nz or too many blocks or segments.
int split_sweep_rows_launch(const real* fz, long long fz_row, long long fz_lane, int segs,
                            const int* seg_local, const int* seg_global, const real* y_it,
                            const real* z_pred, const real* f_ex, const real* w_z,
                            const real* c_A, const unsigned char* conv, const unsigned char* div,
                            const unsigned char* bad, const real* dy_old, const int* niter,
                            int pend_blocks, int pend_k, const real* const* pend_ss,
                            const unsigned char* const* pend_nf, const int* pend_ranks,
                            double newton_tol, double tol_lo, int fixed, int n_all, int n, int nz,
                            int B, int lanes, int rows, int ranks, real* y_next, real* part_ss,
                            unsigned char* part_nf, unsigned char* conv_o, unsigned char* div_o,
                            unsigned char* bad_o, real* dy_old_o, int* niter_o, void* stream) {
  if (n > nz || segs < 1 || segs > ROWS_SEGMENTS_MAX || seg_local[0] != 0) return -1;
  Pending pend;
  if (pending_from(pend_blocks, pend_k, pend_ss, pend_nf, pend_ranks, &pend)) return -1;
  if (B <= 0 || nz <= 0) return 0;
  if (!covers(nz, B, lanes, rows, ranks)) return -3;
  RowMap map = {};
  map.segs = segs;
  for (int i = 0; i < segs; ++i) {
    map.local[i] = seg_local[i];
    map.global[i] = seg_global[i];
  }
  const bool lane_major = fz_row == 1 && fz_lane != 1;
  const dim3 grid(ranks, (B + lanes - 1) / lanes), block(lanes, SWEEP_THREADS / lanes);
  cudaStream_t s = (cudaStream_t)stream;
  if (lane_major)
    split_sweep_rows_kernel<true><<<grid, block, 0, s>>>(
        fz, fz_row, fz_lane, map, y_it, z_pred, f_ex, w_z, c_A, conv, div, bad, dy_old, niter,
        pend, newton_tol, tol_lo, fixed, n_all, n, nz, B, rows, y_next, part_ss, part_nf, conv_o,
        div_o, bad_o, dy_old_o, niter_o);
  else
    split_sweep_rows_kernel<false><<<grid, block, 0, s>>>(
        fz, fz_row, fz_lane, map, y_it, z_pred, f_ex, w_z, c_A, conv, div, bad, dy_old, niter,
        pend, newton_tol, tol_lo, fixed, n_all, n, nz, B, rows, y_next, part_ss, part_nf, conv_o,
        div_o, bad_o, dy_old_o, niter_o);
  return (int)cudaGetLastError();
}

int split_finish_launch(const real* fz, const real* DF_resc, const real* z_pred,
                        const real* f_ex, const real* w_z, const real* c_A,
                        const unsigned char* pred_ok, const int* order, const real* h_use,
                        const real* gamma_star_abs, const real* v_err,
                        const unsigned char* conv, const unsigned char* bad, int fixed, int kab,
                        int nz, int B, int n_gamma, real* DF_upd, real* z_new, real* err0,
                        real* err3, unsigned char* conv_o, real* part, unsigned int* done,
                        void* stream) {
  if (kab != ADAMS_KAB || n_gamma < ADAMS_K + 1) return -1;
  if (B <= 0 || nz <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (nz <= SPLIT_CHUNK) {  // one chunk: part and done are not read (nullptr will do)
    const dim3 tile = finish_tile(nz);
    split_finish_kernel<false, true><<<(B + tile.x - 1) / tile.x, tile, 0, s>>>(
        fz, DF_resc, z_pred, f_ex, w_z, c_A, pred_ok, order, h_use, gamma_star_abs, v_err, conv,
        bad, fixed, nz, B, DF_upd, z_new, err0, err3, conv_o, nullptr, nullptr);
    return (int)cudaGetLastError();
  }
  dim3 grid;
  if (grid_for(nz, B, &grid)) return -3;
  cudaError_t err = cudaMemsetAsync(done, 0, grid.x * sizeof(unsigned int), s);
  if (err != cudaSuccess) return (int)err;
  split_finish_kernel<false, false><<<grid, dim3(SPLIT_TILE, SPLIT_ROWS), 0, s>>>(
      fz, DF_resc, z_pred, f_ex, w_z, c_A, pred_ok, order, h_use, gamma_star_abs, v_err, conv,
      bad, fixed, nz, B, DF_upd, z_new, err0, err3, conv_o, part, done);
  return (int)cudaGetLastError();
}

// The finish's tile at nz rows into out[3]: its lanes, row threads and row
// chunks (1: the one-chunk form, which takes no scratch).
void split_finish_geometry(int nz, int* out) {
  const dim3 tile = finish_tile(nz);
  out[0] = (int)tile.x;
  out[1] = (int)tile.y;
  out[2] = (nz + SPLIT_CHUNK - 1) / SPLIT_CHUNK;
}

// One block of a state split over devices: the finish's rows, and each
// lane's three sums of squares over them into ss3 (3, B), without the roots
// or conv (split_finish_lanes_launch's, on the blocks' sums).  Scratch as
// the finish's.
int split_finish_rows_launch(const real* fz, const real* DF_resc, const real* z_pred,
                             const real* f_ex, const real* w_z, const real* c_A, const int* order,
                             const real* h_use, const real* gamma_star_abs, const real* v_err,
                             int kab, int nz, int B, int n_gamma, real* DF_upd, real* z_new,
                             real* err0, real* ss3, real* part, unsigned int* done,
                             void* stream) {
  if (kab != ADAMS_KAB || n_gamma < ADAMS_K + 1) return -1;
  if (B <= 0 || nz <= 0) return 0;
  dim3 grid;
  if (grid_for(nz, B, &grid)) return -3;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(done, 0, grid.x * sizeof(unsigned int), s);
  if (err != cudaSuccess) return (int)err;
  split_finish_kernel<true, false><<<grid, dim3(SPLIT_TILE, SPLIT_ROWS), 0, s>>>(
      fz, DF_resc, z_pred, f_ex, w_z, c_A, nullptr, order, h_use, gamma_star_abs, v_err,
      nullptr, nullptr, 0, nz, B, DF_upd, z_new, err0, ss3, nullptr, part, done);
  return (int)cudaGetLastError();
}

// The finish's lanes on each lane's summed ss3 (3, B): the last sweep's
// pending decision (as split_sweep_rows_launch takes it, at most
// SWEEP_CLUSTER_MAX ranks a block), then err3's roots, conv and niter; a
// warp a lane.
int split_finish_lanes_launch(const real* ss3, const unsigned char* conv, const unsigned char* div,
                              const unsigned char* bad, const real* dy_old, const int* niter,
                              const unsigned char* pred_ok, int pend_blocks, int pend_k,
                              const real* const* pend_ss, const unsigned char* const* pend_nf,
                              const int* pend_ranks, double newton_tol, double tol_lo, int fixed,
                              int n_all, int B, real* err3, unsigned char* conv_o, int* niter_o,
                              void* stream) {
  Pending pend;
  if (pending_from(pend_blocks, pend_k, pend_ss, pend_nf, pend_ranks, &pend)) return -1;
  for (int d = 0; d < pend.blocks; ++d)
    if (pend_ranks[d] > SWEEP_CLUSTER_MAX) return -1;
  if (B <= 0) return 0;
  split_finish_lanes_kernel<<<(B + LANES_WARPS - 1) / LANES_WARPS, 32 * LANES_WARPS, 0,
                              (cudaStream_t)stream>>>(ss3, conv, div, bad, dy_old, niter, pred_ok,
                                                      pend, newton_tol, tol_lo, fixed, n_all, B,
                                                      err3, conv_o, niter_o);
  return (int)cudaGetLastError();
}

// The clusters of `cluster` blocks of predict's kernel (kernel 0), the
// sweep's (1: f row-major, 2: lane-major) or the rows' sweep's (3, 4; a
// cluster of one block: its blocks) that the card holds at once, at tiles of
// `lanes` lanes, into *out (cudaOccupancyMaxActiveClusters): the experiments
// print it beside a geometry's clusters.
int split_max_active_clusters(int kernel, int lanes, int cluster, int* out) {
  const void* fns[5] = {(const void*)split_predict_kernel, (const void*)split_sweep_kernel<false>,
                        (const void*)split_sweep_kernel<true>,
                        (const void*)split_sweep_rows_kernel<false>,
                        (const void*)split_sweep_rows_kernel<true>};
  if (kernel < 0 || kernel > 4 || (kernel > 2 && cluster != 1)) return -1;
  const void* fn = fns[kernel];
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err =
      cluster_config(&cfg, attr, fn, &non_portable[kernel], lanes, lanes, cluster, nullptr);
  if (err != cudaSuccess) return (int)err;
  attr[0].id = cudaLaunchAttributeClusterDimension;  // a cluster of one block too
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}

const char* split_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

#ifdef SPLIT_PHASE_CLOCKS
// Copies the phase cycles and block count into out[6] and zeroes them.
int split_phase_cycles_read(unsigned long long* out) {
  static const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
  cudaError_t e = cudaMemcpyFromSymbol(out, split_phase_cycles, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(split_phase_cycles, zero, sizeof(zero));
  return (int)e;
}
#endif

}  // extern "C"
