// Batched banded LU with partial pivoting, and its solve: one thread a lane,
// each lane's factors streamed through a ring in shared memory by a second
// warp.
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
// Every operation rounds on its own (real.cuh's r_mul, r_sub, r_div; the
// build takes -fmad=false too), in the plain version's order, so the
// kernels give the plain PyTorch version's lu, piv, sing and solutions bit
// for bit, singular lanes (NaN) included.  L and U are compile-time
// (-DBAND_L, -DBAND_U; one build a bandwidth pair and type, real.cuh's
// -DSUNODE_REAL=float for float32).
//
// What bounds it on an H100: a chain of dependent steps, neither bytes nor
// operations.  At n = 128, L = U = 1, B = 1,024 the factor moves 7.9 MB
// (2.4 us at 3.35 TB/s) and the solve 6.9 MB; but a lane's columns are a
// chain, n steps long, that no other lane can shorten.  A factor column's
// dependent instructions are the pivot's |a|, compare and select, the
// _TINY guard's compare and select, the IEEE divide (a reciprocal and
// eight DFMA/DMUL, ~112 cycles when its input is on the chain), then the
// multiply and subtract that the next column's pivot reads: ~157 cycles at
// float64, ~10 us at n = 128 (chip_smoke.banded_chain, from the latencies
// that experiments/banded_ab.py --latencies measures).  A solve row's are
// the select, multiply and subtract forward and the multiply, add,
// subtract and divide backward: ~153 cycles, ~10 us.  The 1,024 lanes are
// 32 tiles; each has an SM to itself, and within a tile nothing hides a
// stall of its one computing warp.  The first design (one warp a tile)
// loaded each step's inputs inside the chain: one memory round trip a
// step, ~96 us at n = 128.
//
// So this design takes the memory out of the chain, and the copying out
// of the computing warp.  Each kernel walks a stream of records, one a
// step, that depend on the step's index and the lane alone: the factor's
// record t is row t of A at columns t-L .. t+U (the row that enters the
// active block after column t-L-1); the solve's forward record is the
// step's pivot, its L multipliers and the b value entering the window,
// its backward record U's W values of the row and the diagonal.  A block
// is one lane tile and two warps: the producer warp copies the records
// with cp.async (LDGSTS, 4 or 8 bytes a thread, coalesced across the warp;
// values outside the matrix as plain stores) into a ring of kStages chunks
// of `rows` records in shared memory, and the consumer warp, one thread a
// lane, computes.  Each stage has two mbarriers: `full`, which the
// producer's copies (cp.async.mbarrier.arrive.noinc) and stores complete,
// and `empty`, which the consumer's reads release; so the producer runs
// up to kStages chunks ahead, and the consumer's instruction stream holds
// only the chain, its shared-memory reads (the solve reads each record one
// step ahead, two register sets in turn) and its stores.  The first L+1
// records only fill the active block (rows 0..L enter as later rows do).
// The factor writes each slot of the working storage once: the column
// loop the slots it finalises, then the slots no column reaches their
// initial values (the top-left corner above row 0, the padding columns'
// tail); it does not write the whole storage first.  The solve keeps the
// forward pass's results in shared memory for the backward pass (the last
// `keep` rows; rows below leave through x and come back through the
// backward ring, only when n exceeds what the block holds) and writes x
// once.  ops/banded.py::banded_geometry sizes the rings and `keep` from n,
// B, L, U and the type.
//
// A lane whose pivot is zero or tiny (a singular lane: pivot _TINY) sends
// every divide of its column loop down the IEEE divide's slow path, and
// its tile waits for it; the Newton matrices of the path take the fast
// path throughout.
//
// BANDED_PHASE_CLOCKS adds a trace by phase (banded_ab.py --phase-clocks):
// the cycles the consumer's thread 0 of each block spends in the factor's
// staging (until the first chunk has landed), column loop and stores, and
// in the solve's forward and backward passes, summed over every block of
// every launch since the last read, with each block's nanoseconds
// (%globaltimer) and the last launch's start and end of each block.
#include "real.cuh"

#ifndef BAND_L
#define BAND_L 1
#endif
#ifndef BAND_U
#define BAND_U 1
#endif
#define BAND_W (BAND_L + BAND_U)          // U's width above the diagonal after pivoting
#define BAND_R (2 * BAND_L + BAND_U + 1)  // rows of the working storage

static constexpr int kLanes = 32;   // lanes a tile; a block is a tile's two warps
static constexpr int kStages = 4;   // chunks a ring (ops/banded.py's STAGES)
static constexpr int kFactorFields = BAND_W + 1;   // a factor record: row t's W+1 values
static constexpr int kForwardFields = BAND_L + 1;  // the L multipliers, then b (+ piv, an int)
static constexpr int kBackwardFields = BAND_W + 2; // U's W values, the diagonal, the forward x

#ifdef BANDED_PHASE_CLOCKS
// the factor: staging, column loop, stores, then blocks and their
// nanoseconds, then the cycles the column loop waited on the ring
__device__ unsigned long long banded_factor_cycles[6];
// the solve: forward, backward, then blocks and their nanoseconds, then the
// cycles each pass waited on its ring
__device__ unsigned long long banded_solve_cycles[6];
__device__ __forceinline__ unsigned long long band_ns() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}
#define BAND_CLOCK_START                  \
  long long band_mark = clock64();        \
  long long band_waited[2] = {0, 0};      \
  const unsigned long long band_t0 = band_ns();
// bar_wait, its cycles added to band_waited[i]
#define BAND_WAIT(bar, parity, i)                \
  {                                              \
    const long long band_w0 = clock64();         \
    bar_wait(bar, parity);                       \
    band_waited[i] += clock64() - band_w0;       \
  }
#define BAND_ADD_WAITS(cycles, k, count)                                   \
  if (threadIdx.x == 0)                                                    \
    for (int i = 0; i < count; ++i)                                        \
      atomicAdd(&cycles[k + i], (unsigned long long)band_waited[i]);
#define BAND_MARK(cycles, k)                                                   \
  if (threadIdx.x == 0) {                                                      \
    const long long now = clock64();                                           \
    atomicAdd(&cycles[k], (unsigned long long)(now - band_mark));              \
    band_mark = now;                                                           \
  }
// each block's start and end (ns) in the last launch: [2 * block], [2 * block + 1]
__device__ unsigned long long banded_block_ns[2 * 8192];
#define BAND_COUNT_BLOCK(cycles, k)                                   \
  if (threadIdx.x == 0) {                                             \
    const unsigned long long band_t1 = band_ns();                     \
    atomicAdd(&cycles[k], 1ull);                                      \
    atomicAdd(&cycles[k + 1], band_t1 - band_t0);                     \
    const unsigned block = blockIdx.x + gridDim.x * blockIdx.y;       \
    if (block < 8192) {                                               \
      banded_block_ns[2 * block] = band_t0;                           \
      banded_block_ns[2 * block + 1] = band_t1;                       \
    }                                                                 \
  }
#else
#define BAND_CLOCK_START
#define BAND_MARK(cycles, k)
#define BAND_COUNT_BLOCK(cycles, k)
#define BAND_WAIT(bar, parity, i) bar_wait(bar, parity);
#define BAND_ADD_WAITS(cycles, k, count)
#endif

// The reference's 1e-300 at the build's type: 0 at float.
__device__ __forceinline__ real band_tiny() { return (real)1e-300; }

// One asynchronous copy of a thread's value from device to shared memory
// (cp.async, cached at every level: 4 and 8 bytes take no bypass).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void stage_copy(real* dst, const real* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(sizeof(real))
               : "memory");
}
__device__ __forceinline__ void stage_copy(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// `count` values of one field, `sstride` apart in shared and `gstride`
// apart in device memory, eight copies at a time from eight address
// registers (a copy reads its address late, so a bumped pointer would wait
// on each copy).  Not inlined: the producer warp calls it, and its trip
// count stays the `count` it is given (inlined into the callers' range
// arithmetic, the unrolled copies have run past their range).
template <typename T>
__device__ __noinline__ void stage_run(T* d, const T* g, int count, int sstride,
                                       ptrdiff_t gstride) {
  int i = 0;
  for (; i + 8 <= count; i += 8, d += 8 * sstride, g += 8 * gstride) {
#pragma unroll
    for (int j = 0; j < 8; ++j) stage_copy(d + j * sstride, g + j * gstride);
  }
#pragma unroll 1
  for (; i < count; ++i, d += sstride, g += gstride) stage_copy(d, g);
}

// The ring's barriers (mbarrier, one phase a use of a chunk's stage).
__device__ __forceinline__ void bar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Arrive once this thread's copies so far have landed (the producer).
__device__ __forceinline__ void bar_arrive_on_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
// Arrive now, releasing this thread's reads and writes so far (the consumer).
__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}
// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void bar_wait(unsigned long long* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void copies_drain() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A block is one lane tile: warp 0 computes (the consumer), warp 1 copies
// each chunk of records into the ring (the producer), kStages chunks ahead
// at most.  Each stage s has a barrier `full[s]` that the producer's copies
// complete, and its stores where it makes any (then two arrivals a lane),
// and one `empty[s]` that the consumer's reads release (one a lane); a
// ragged tile's idle threads leave after the barriers are set up.
__device__ __forceinline__ int tile_lanes(int B) {
  return min(kLanes, B - (int)blockIdx.x * kLanes);
}

__global__ void __launch_bounds__(2 * kLanes)
banded_factor_kernel(const real* __restrict__ ab, int n, int B, int rows, real* __restrict__ lu,
                     int* __restrict__ piv, unsigned char* __restrict__ sing) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(band_smem);
  unsigned long long* empty = full + kStages;
  real* ring = reinterpret_cast<real*>(empty + kStages);  // [kStages][rows][kFactorFields][kLanes]
  const int tx = threadIdx.x % kLanes;
  const int lane = blockIdx.x * kLanes + tx;
  const int active = tile_lanes(B);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 2 * active);  // each producer thread: its copies, its stores
      bar_init(&empty[s], active);
    }
  }
  __syncthreads();
  if (tx >= active) return;
  BAND_CLOCK_START
  const int records = n + BAND_L + 1;  // t = 0..n+L; the last only ends column n-1
  const int chunks = (records + rows - 1) / rows;
  constexpr int kRecord = kFactorFields * kLanes;  // values between two records of a lane

  if (threadIdx.x >= kLanes) {
    // Record t: A[t][t - L + c] at c = 0..W, that is ab[W - c][t - L + c],
    // field by field; columns before 0 take 0 (they slide out unread),
    // columns past n the padding's values (1 on its diagonal, c = L).
    for (int q = 0; q < chunks; ++q) {
      const int s = q % kStages;
      if (q >= kStages) bar_wait(&empty[s], (q / kStages - 1) & 1);
      const int t0 = q * rows, t1 = min(records, t0 + rows);
      real* dst = ring + (size_t)s * rows * kRecord + tx;
#pragma unroll
      for (int c = 0; c <= BAND_W; ++c) {
        const int a = min(max(t0, BAND_L - c), t1), e = max(min(t1, n + BAND_L - c), a);
        real* d = dst + c * kLanes;
#pragma unroll 1
        for (int t = t0; t < a; ++t) d[(t - t0) * kRecord] = (real)0;
        if (a < e)
          stage_run(d + (a - t0) * kRecord,
                    ab + ((size_t)(BAND_W - c) * n + (a - BAND_L + c)) * B + lane, e - a,
                    kRecord, B);
#pragma unroll 1
        for (int t = e; t < t1; ++t) d[(t - t0) * kRecord] = (c == BAND_L) ? (real)1 : (real)0;
      }
      bar_arrive_on_copies(&full[s]);
      bar_arrive(&full[s]);
    }
    copies_drain();
    return;
  }

  const int nw = n + BAND_W;
  const size_t rs = (size_t)nw * B;  // between rows of the working storage
#define LU(r, j) lu[(size_t)(r) * rs + (size_t)(j) * B + lane]
  // The top-left corner no column reaches: rows L..W-1 above A's row 0,
  // columns 0..W-1-r, keep ab's values (the reference copies them in).
  constexpr int kCorner = BAND_U * (BAND_U + 1) / 2 + 1;
  real corner[kCorner];
  {
    int i = 0;
#pragma unroll
    for (int r = BAND_L; r < BAND_W; ++r)
#pragma unroll
      for (int j = 0; j < BAND_W - r; ++j)
        corner[i++] = (j < n) ? ab[((size_t)(r - BAND_L) * n + j) * B + lane] : (real)0;
  }

  // a[d][c] = A[k + d][k + c], stored at working row W + d - c, column k + c
  real a[BAND_L + 1][BAND_W + 1];
#pragma unroll
  for (int d = 0; d <= BAND_L; ++d)
#pragma unroll
    for (int c = 0; c <= BAND_W; ++c) a[d][c] = (real)0;

  const real tiny = band_tiny();
  bool singular = false;
  real* lu_k = lu + lane;  // column k of row 0 (this lane)
  int* piv_k = piv + lane;
  // Column k: pick the pivot (the first row of largest |entry| among rows
  // k..k+L inside A), swap, eliminate, and write U's row k, column k's
  // multipliers and the pivot.
  auto column = [&](int k) {
    real best = r_abs(a[0][0]);
    int p = 0;
#pragma unroll
    for (int d = 1; d <= BAND_L; ++d) {
      const real sd = (k + d < n) ? r_abs(a[d][0]) : (real)-1;
      if (!isnan(best) && (isnan(sd) || sd > best)) {
        best = sd;
        p = d;
      }
    }
#pragma unroll
    for (int d = 1; d <= BAND_L; ++d) {
      if (p == d) {
#pragma unroll
        for (int c = 0; c <= BAND_W; ++c) {
          const real tmp = a[0][c];
          a[0][c] = a[d][c];
          a[d][c] = tmp;
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
#pragma unroll
    for (int c = 0; c <= BAND_W; ++c) lu_k[(size_t)(BAND_W - c) * rs + (size_t)c * B] = a[0][c];
#pragma unroll
    for (int d = 1; d <= BAND_L; ++d) lu_k[(size_t)(BAND_W + d) * rs] = a[d][0];
    *piv_k = p;
  };
  // Slide: rows k+1..k+1+L, columns k+1..k+1+W; the new column's rows above
  // k+1+L are fill (0), the new row is the record.
  auto slide = [&](const real* row) {
#pragma unroll
    for (int d = 0; d < BAND_L; ++d) {
#pragma unroll
      for (int c = 0; c < BAND_W; ++c) a[d][c] = a[d + 1][c + 1];
      a[d][BAND_W] = (real)0;
    }
#pragma unroll
    for (int c = 0; c <= BAND_W; ++c) a[BAND_L][c] = row[c];
  };
  int t = 0;
  for (int q = 0; q < chunks; ++q) {
    const int s = q % kStages;
    BAND_WAIT(&full[s], (q / kStages) & 1, 0)
    if (q == 0) {
      BAND_MARK(banded_factor_cycles, 0)
    }
    const real* rec = ring + (size_t)s * rows * kRecord + tx;
    const int t_end = min(records, t + rows);
    real row[BAND_W + 1];
    // records 0..L fill the block
    for (; t < min(t_end, BAND_L + 1); ++t, rec += kRecord) {
#pragma unroll
      for (int c = 0; c <= BAND_W; ++c) row[c] = rec[c * kLanes];
      slide(row);
    }
    // record t ends column t-L-1 (0..n-2), then enters
    const int regular_end = min(t_end, n + BAND_L);
#pragma unroll 2
    for (; t < regular_end; ++t, rec += kRecord) {
#pragma unroll
      for (int c = 0; c <= BAND_W; ++c) row[c] = rec[c * kLanes];
      column(t - BAND_L - 1);
      lu_k += B;
      piv_k += B;
      slide(row);
    }
    if (t == records - 1) {
      // the last column; the rows below its pivot keep their eliminated values
      column(n - 1);
#pragma unroll
      for (int d = 1; d <= BAND_L; ++d)
#pragma unroll
        for (int c = 1; c <= BAND_W; ++c)
          lu_k[(size_t)(BAND_W + d - c) * rs + (size_t)c * B] = a[d][c];
      break;
    }
    bar_arrive(&empty[s]);
  }
  BAND_MARK(banded_factor_cycles, 1)

  // The slots no column reaches keep their initial values: the corner (ab's
  // values below the fill rows, 0 in them) and, in rows below L, the
  // padding columns past the last column's reach (1 on row W, else 0).
  {
    int i = 0;
#pragma unroll
    for (int r = 0; r < BAND_W; ++r)
#pragma unroll
      for (int j = 0; j < BAND_W - r; ++j) LU(r, j) = (r < BAND_L) ? (real)0 : corner[i++];
  }
#pragma unroll
  for (int r = BAND_L + 1; r < BAND_R; ++r) {
    const int corner_end = r < BAND_W ? BAND_W - r : 0;
    for (int j = max(n + 2 * BAND_L + BAND_U - r, corner_end); j < nw; ++j)
      LU(r, j) = (r == BAND_W) ? (real)1 : (real)0;
  }
  sing[lane] = singular ? 1 : 0;
#undef LU
  BAND_MARK(banded_factor_cycles, 2)
  BAND_COUNT_BLOCK(banded_factor_cycles, 3)
  BAND_ADD_WAITS(banded_factor_cycles, 5, 1)
}

// One block a (lane tile, right-hand side): forward with the row swaps and
// the multipliers, backward with U; NaN where `sing` is given and set.  The
// forward results stay in `kept`, row k in slot k mod keep; rows below `lo`
// = n - keep (none when keep >= n), whose slots a later row takes, also
// leave through x and return through the backward ring (banded_geometry
// keeps the rows of the backward ring's first kStages chunks, so the
// producer reads x only after the consumer has released a backward chunk,
// that is after the forward pass).
__global__ void __launch_bounds__(2 * kLanes)
banded_solve_kernel(const real* __restrict__ lu, const int* __restrict__ piv,
                    const unsigned char* __restrict__ sing, const real* __restrict__ b, int n,
                    int B, int rows, int keep, real* __restrict__ x) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  constexpr int kFwd = kForwardFields * kLanes, kBwd = kBackwardFields * kLanes;
  unsigned long long* ffull = reinterpret_cast<unsigned long long*>(band_smem);
  unsigned long long* fempty = ffull + kStages;
  unsigned long long* bfull = fempty + kStages;
  unsigned long long* bempty = bfull + kStages;
  const size_t ring_len = (size_t)kStages * rows;
  real* fwd = reinterpret_cast<real*>(bempty + kStages);  // [kStages][rows][kForwardFields][kLanes]
  real* bwd = fwd + ring_len * kFwd;  // [kStages][rows][kBackwardFields][kLanes]
  real* kept = bwd + ring_len * kBwd;                     // [keep][kLanes]
  int* fpiv = reinterpret_cast<int*>(kept + (size_t)keep * kLanes);  // [kStages][rows][kLanes]
  const int tx = threadIdx.x % kLanes;
  const int lane = blockIdx.x * kLanes + tx;
  const int active = tile_lanes(B);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&ffull[s], 2 * active);  // each producer thread: its copies, its stores
      bar_init(&fempty[s], active);
      bar_init(&bfull[s], active);
      bar_init(&bempty[s], active);
    }
  }
  __syncthreads();
  if (tx >= active) return;
  BAND_CLOCK_START
  const int nw = n + BAND_W;
  const size_t rs = (size_t)nw * B;  // between rows of the working storage
  real* x_lane = x + (size_t)blockIdx.y * n * B + lane;  // this right-hand side, row 0
  const int lo = n > keep ? n - keep : 0;
  const int f_records = n + BAND_L + 1;  // t = 0..n+L: step t-L-1, then b[t] enters
  const int f_chunks = (f_records + rows - 1) / rows;
  const int b_chunks = (n + rows - 1) / rows;  // backward record u: row n-1-u

  if (threadIdx.x >= kLanes) {
    const real* b_lane = b + (size_t)blockIdx.y * n * B + lane;
    // Forward record t: piv[k] and L[k + f][k] (f = 1..L) for k = t-L-1 >=
    // 0, b[t] (0 past n).
    auto stage_forward = [&](int q) {
      const int s = q % kStages;
      if (q >= kStages) bar_wait(&fempty[s], (q / kStages - 1) & 1);
      const int t0 = q * rows, t1 = min(f_records, t0 + rows);
      const size_t base = (size_t)s * rows;
      const int a = max(t0, BAND_L + 1);  // records before are virtual
      if (a < t1) {
        const size_t k0 = (size_t)(a - BAND_L - 1) * B + lane;
        stage_run(fpiv + (base + a - t0) * kLanes + tx, piv + k0, t1 - a, kLanes, B);
#pragma unroll
        for (int f = 1; f <= BAND_L; ++f)
          stage_run(fwd + (base + a - t0) * kFwd + (f - 1) * kLanes + tx,
                    lu + (size_t)(BAND_W + f) * rs + k0, t1 - a, kFwd, B);
      }
      const int e = max(min(n, t1), t0);
      real* db = fwd + base * kFwd + BAND_L * kLanes + tx;
      if (t0 < e) stage_run(db, b_lane + (size_t)t0 * B, e - t0, kFwd, B);
#pragma unroll 1
      for (int t = e; t < t1; ++t) db[(t - t0) * kFwd] = (real)0;
      bar_arrive_on_copies(&ffull[s]);
      bar_arrive(&ffull[s]);
    };
    // Backward record u, row k = n-1-u: U[k][k + c] = lu[W - c][k + c] (c =
    // 1..W), the diagonal lu[W][k], and for k < lo the forward x[k].
    const ptrdiff_t up = (ptrdiff_t)B - (ptrdiff_t)rs;  // from (r, j) to (r - 1, j + 1)
    auto stage_backward = [&](int q) {
      const int s = q % kStages;
      if (q >= kStages) bar_wait(&bempty[s], (q / kStages - 1) & 1);
      const int u0 = q * rows, u1 = min(n, u0 + rows);
      real* d = bwd + (size_t)s * rows * kBwd + tx;
      const real* g = lu + (size_t)BAND_W * rs + (size_t)(n - 1 - u0) * B + lane;
#pragma unroll
      for (int c = 1; c <= BAND_W; ++c)
        stage_run(d + (c - 1) * kLanes, g + c * up, u1 - u0, kBwd, -(ptrdiff_t)B);
      stage_run(d + BAND_W * kLanes, g, u1 - u0, kBwd, -(ptrdiff_t)B);
      // the rows below lo (u >= n - lo) left the forward pass through x
      const int ux = max(u0, n - lo);
      if (ux < u1)
        stage_run(d + (ux - u0) * kBwd + (BAND_W + 1) * kLanes,
                  x_lane + (size_t)(n - 1 - ux) * B, u1 - ux, kBwd, -(ptrdiff_t)B);
      bar_arrive_on_copies(&bfull[s]);
    };
    // the forward ring's first chunks, the backward ring's, then the rest
    // of each as the consumer frees stages
    int qf = 0, qb = 0;
    for (; qf < min(kStages, f_chunks); ++qf) stage_forward(qf);
    for (; qb < min(kStages, b_chunks); ++qb) stage_backward(qb);
    for (; qf < f_chunks; ++qf) stage_forward(qf);
    for (; qb < b_chunks; ++qb) stage_backward(qb);
    copies_drain();
    return;
  }

  // forward: w[d] = the padded right-hand side at row k + d
  real w[BAND_L + 1];
#pragma unroll
  for (int d = 0; d <= BAND_L; ++d) w[d] = (real)0;
  int t = 0, slot = 0;
  real* x_k = x_lane;
  real* kept_tx = kept + tx;
  // A forward record: the pivot P, the multipliers M[1..L] and b (BT), read
  // from record I of the stage; then step k = t-L-1 (t > L) with it, and
  // b[t] enters the window.  Two register sets take turns, so each record
  // is read one step ahead of its use.
#define FORWARD_LOAD(I, P, M, BT)                                                  \
  {                                                                                \
    P = prec[(I) * kLanes];                                                        \
    _Pragma("unroll") for (int d = 1; d <= BAND_L; ++d) M[d] =                     \
        rec[(I) * kFwd + (d - 1) * kLanes];                                        \
    BT = rec[(I) * kFwd + BAND_L * kLanes];                                        \
  }
#define FORWARD_STEP(P, M, BT)                                                     \
  {                                                                                \
    real bk = w[0];                                                                \
    _Pragma("unroll") for (int d = 1; d <= BAND_L; ++d) bk = (P == d) ? w[d] : bk; \
    _Pragma("unroll") for (int d = 1; d <= BAND_L; ++d) w[d] = (P == d) ? w[0] : w[d]; \
    w[0] = bk;                                                                     \
    _Pragma("unroll") for (int d = 1; d <= BAND_L; ++d) w[d] =                     \
        r_sub(w[d], r_mul(M[d], bk));                                              \
    kept_tx[(size_t)slot * kLanes] = w[0];                                         \
    if (t - BAND_L - 1 < lo) *x_k = w[0];                                          \
    x_k += B;                                                                      \
    slot = slot + 1 == keep ? 0 : slot + 1;                                        \
    _Pragma("unroll") for (int d = 0; d < BAND_L; ++d) w[d] = w[d + 1];            \
    w[BAND_L] = BT;                                                                \
    ++t;                                                                           \
  }
  for (int q = 0; q < f_chunks; ++q) {
    const int s = q % kStages;
    BAND_WAIT(&ffull[s], (q / kStages) & 1, 0)
    const real* rec = fwd + (size_t)s * rows * kFwd + tx;
    const int* prec = fpiv + (size_t)s * rows * kLanes + tx;
    const int t0 = t, t_end = min(f_records, t + rows);
    // records 0..L fill the window
    for (; t < min(t_end, BAND_L + 1); ++t) {
#pragma unroll
      for (int d = 0; d < BAND_L; ++d) w[d] = w[d + 1];
      w[BAND_L] = rec[(t - t0) * kFwd + BAND_L * kLanes];
    }
    int pa = 0, pb = 0;
    real ma[BAND_L + 1], mb[BAND_L + 1], ba = 0, bb = 0;
    if (t < t_end) FORWARD_LOAD(t - t0, pa, ma, ba)
    while (t + 1 < t_end) {
      FORWARD_LOAD(t + 1 - t0, pb, mb, bb)
      FORWARD_STEP(pa, ma, ba)
      if (t + 1 < t_end) FORWARD_LOAD(t + 1 - t0, pa, ma, ba)
      FORWARD_STEP(pb, mb, bb)
    }
    if (t < t_end) FORWARD_STEP(pa, ma, ba)
    bar_arrive(&fempty[s]);
  }
#undef FORWARD_LOAD
#undef FORWARD_STEP
  BAND_MARK(banded_solve_cycles, 0)

  // backward: v[c - 1] = x[k + c], zero past n
  const real tiny = band_tiny();
  real v[BAND_W + 1];
#pragma unroll
  for (int c = 0; c <= BAND_W; ++c) v[c] = (real)0;
  const bool poison = sing != nullptr && sing[lane];
  int u = 0, slot_load = (n - 1) % keep;
  x_k = x_lane + (size_t)(n - 1) * B;
  // A backward record F: U's row (0..W-1), the diagonal (W), the forward x
  // below lo (W+1); KV the kept forward x of its row; read one row ahead.
#define BACKWARD_LOAD(I, F, KV)                                                    \
  {                                                                                \
    _Pragma("unroll") for (int f = 0; f < kBackwardFields; ++f) F[f] =             \
        rec[(I) * kBwd + f * kLanes];                                              \
    KV = kept_tx[(size_t)slot_load * kLanes];                                      \
    slot_load = slot_load == 0 ? keep - 1 : slot_load - 1;                         \
  }
#define BACKWARD_STEP(F, KV)                                                       \
  {                                                                                \
    real s_k = (n - 1 - u >= lo) ? KV : F[BAND_W + 1];                             \
    if (BAND_W > 0) {                                                              \
      real acc = r_mul(F[0], v[0]);                                                \
      _Pragma("unroll") for (int c = 2; c <= BAND_W; ++c) acc =                    \
          r_add(acc, r_mul(F[c - 1], v[c - 1]));                                   \
      s_k = r_sub(s_k, acc);                                                       \
    }                                                                              \
    real diag = F[BAND_W];                                                         \
    diag = (r_abs(diag) > tiny) ? diag : tiny;                                     \
    const real xk = r_div(s_k, diag);                                              \
    *x_k = poison ? (real)NAN : xk;                                                \
    x_k -= B;                                                                      \
    _Pragma("unroll") for (int c = BAND_W; c > 0; --c) v[c] = v[c - 1];            \
    v[0] = xk;                                                                     \
    ++u;                                                                           \
  }
  for (int q = 0; q < b_chunks; ++q) {
    const int s = q % kStages;
    BAND_WAIT(&bfull[s], (q / kStages) & 1, 1)
    const real* rec = bwd + (size_t)s * rows * kBwd + tx;
    const int u0 = u, u_end = min(n, u + rows);
    real fa[kBackwardFields], fb[kBackwardFields], ka = 0, kb = 0;
    if (u < u_end) BACKWARD_LOAD(u - u0, fa, ka)
    while (u + 1 < u_end) {
      BACKWARD_LOAD(u + 1 - u0, fb, kb)
      BACKWARD_STEP(fa, ka)
      if (u + 1 < u_end) BACKWARD_LOAD(u + 1 - u0, fa, ka)
      BACKWARD_STEP(fb, kb)
    }
    if (u < u_end) BACKWARD_STEP(fa, ka)
    bar_arrive(&bempty[s]);
  }
#undef BACKWARD_LOAD
#undef BACKWARD_STEP
  BAND_MARK(banded_solve_cycles, 1)
  BAND_COUNT_BLOCK(banded_solve_cycles, 2)
  BAND_ADD_WAITS(banded_solve_cycles, 4, 2)
}

// Dynamic shared memory of a block (ops/banded.py::banded_geometry computes
// the same): the barriers, then the rings.
static size_t factor_smem(int rows) {
  return 2 * kStages * sizeof(unsigned long long) +
         (size_t)kStages * rows * kFactorFields * kLanes * sizeof(real);
}
static size_t solve_smem(int rows, int keep) {
  return 4 * kStages * sizeof(unsigned long long) +
         ((size_t)kStages * rows * (kForwardFields + kBackwardFields) + keep) * kLanes *
             sizeof(real) +
         (size_t)kStages * rows * kLanes * sizeof(int);
}

// Above 48 KB a kernel's dynamic shared memory must be allowed first.
static cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

extern "C" {

int banded_stages() { return kStages; }
long long banded_factor_smem(int rows) { return (long long)factor_smem(rows); }
long long banded_solve_smem(int rows, int keep) { return (long long)solve_smem(rows, keep); }

// Each launches on `stream` without synchronising and returns -1 for
// bandwidths other than the build's, -2 for a geometry it does not take
// (stages other than kStages, rows < 1, keep < 1), else the cudaError_t of
// the launch.
int banded_factor_launch(const real* ab, int lower, int upper, int n, int B, int rows,
                         int stages, real* lu, int* piv, unsigned char* sing, void* stream) {
  if (lower != BAND_L || upper != BAND_U) return -1;
  if (stages != kStages || rows < 1) return -2;
  if (B <= 0 || n <= 0) return 0;
  const size_t smem = factor_smem(rows);
  cudaError_t e = allow_smem((const void*)banded_factor_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  banded_factor_kernel<<<(B + kLanes - 1) / kLanes, 2 * kLanes, smem, (cudaStream_t)stream>>>(
      ab, n, B, rows, lu, piv, sing);
  return (int)cudaGetLastError();
}

int banded_solve_launch(const real* lu, const int* piv, const unsigned char* sing, const real* b,
                        int lower, int upper, int n, int m, int B, int rows, int stages, int keep,
                        real* x, void* stream) {
  if (lower != BAND_L || upper != BAND_U) return -1;
  if (stages != kStages || rows < 1 || keep < 1) return -2;
  if (B <= 0 || n <= 0 || m <= 0) return 0;
  const size_t smem = solve_smem(rows, keep);
  cudaError_t e = allow_smem((const void*)banded_solve_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 blocks((B + kLanes - 1) / kLanes, m);
  banded_solve_kernel<<<blocks, 2 * kLanes, smem, (cudaStream_t)stream>>>(lu, piv, sing, b, n, B,
                                                                      rows, keep, x);
  return (int)cudaGetLastError();
}

const char* banded_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

#ifdef BANDED_PHASE_CLOCKS
// Copies the factor's counters into out[0..5], the solve's into out[6..11],
// and zeroes both.
int banded_phase_cycles_read(unsigned long long* out) {
  static const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
  cudaError_t e = cudaMemcpyFromSymbol(out, banded_factor_cycles, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out + 6, banded_solve_cycles, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(banded_factor_cycles, zero, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(banded_solve_cycles, zero, sizeof(zero));
  return (int)e;
}

// Copies the start and end (ns) of the last launch's first `blocks` blocks.
int banded_block_ns_read(unsigned long long* out, int blocks) {
  if (blocks > 8192) blocks = 8192;
  return (int)cudaMemcpyFromSymbol(out, banded_block_ns, 2 * blocks * sizeof(unsigned long long));
}
#endif

}  // extern "C"
