#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sunode_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

  1. device: the card's name and power limit (no CUDA device -> exit 1);
  2. build: nvcc builds, all at once (phase 10's float32 builds of the
     history-attempt kernel and the split kernels among them), the PECE
     kernel and the history-attempt
     kernel for both emitted systems (forward LV, and the transition-adjoint
     backward system) and the flat-history PECE kernel at order 6, and the
     history-attempt kernel at phase 7's depth (adams_max_order 8) for the
     forward, the backsolve ('resolve') and the staged checkpointed
     ('staged_adjoint') systems, and the split attempt's three kernels
     (csrc/adams_split.cu) at that depth, which do not depend on the problem,
     and at the main path's depth (adams_max_order 6) the split kernels and
     the history-attempt kernel for phase 9's forward-sensitivity systems
     ('sensitivity' and 'staged_sensitivity');
  3. kernel vs plain: each PECE build against the plain PyTorch version on
     the card at B=10,000, seeded random history, per-lane order 1..6, the
     main path's corrector; normwise relative error <= 1e-12 on y_it, z_new,
     d_fz and err, conv and niter equal in every lane, and per-call times
     (graph-replayed, on the stream, device-busy);
  3b. flat-history kernel: against its plain version and against the PECE
     kernel in fixed-sweep mode at B=10,240 (the inputs of
     scripts/exp_pallas2d.py), normwise relative error <= 1e-12 on y, d_f
     and err; then the A/B of sunode_torch.experiments.exp_pece2d at
     B=10,240 and 102,400 (graph-replayed, on the stream, device-busy),
     one line per arm and width, with the kernel's launches counted;
  3c. history-attempt kernel: each build against its plain version on the
     card at B=10,000, on phase 3's inputs plus a seeded step ratio
     log-uniform in [0.2, 2] and the main path's error weights; normwise
     relative error <= 1e-12 on DF_resc, DF_upd, z_pred, z_new, err0 and
     err3, conv and niter equal in every lane, and ROADMAP C6's checks:
     DF_resc and z_pred bit for bit, z_new, err0 and DF_upd bit for bit in
     the lanes where the build's emitted right-hand side gives the plain f
     bit for bit at every point the plain attempt evaluates it (their count
     printed); at the seeded orders and with every lane at p = 1 and at p =
     P_MAX, per-call times as in phase 3 and the device time at each of the
     two orders; phase 7's three builds at its history depth (order 1..8)
     and tolerances (1e-8 on every row), the staged build with seeded y(t)
     rows after the parameters;
  3d. split kernels: the attempt with its right-hand side in torch between
     three kernels (predict, sweep, finish) for SIR over 1,000 regions at
     each shape phase 8 gives them: its forward attempts (nz = n = 3,000,
     B=1,024), the backward ones of 'resolve' ([y | lam] and two
     quadratures: nz = 6,002, n = 6,000, B=1,024) and of 'hermite' (lam and
     the quadratures, y(t) staged in the parameter rows: nz = 3,002, n =
     3,000, B=256);
     orders 1..8, seeded history and step ratio as in phase 3c: the
     composed attempt against the plain stages composed on the card, then
     each kernel against its plain stage on the same inputs; relative error
     <= 1e-12, normwise on the (rows, B) fields (DF_resc, DF_upd, z_new and
     the rest) and lane by lane on err3, c_A and dy_old; conv, div, bad and
     niter equal in every lane; per-call times as in phase 3 at the forward
     shape, the kernels' device times at the backward ones; the sweep's
     geometry at each shape (cluster, rows a block, lanes a tile, blocks);
  4. main path: batched LV adjoint gradients at B=10,000, 21 observation
     times, rtol 1e-8 (bench.py's lv_adjoint workload), three steps through
     ``torch.autograd``: the history-attempt launches equal to the attempts
     the solves report and no PECE-kernel launch; then one more step under
     the profiler, over the first quarter of the horizon (t <= 2.35), for
     the device kernels per attempt (counted from the profiler's raw
     records and from its public event list, which must agree) and the
     device-busy share; every lane finite, lanes 0-15 inside the golden gate
     (tests/golden/lv_adjoint.npz, rtol 2e-3, atol 1e-3), and the same lanes
     against the plain path on the CPU within 1e-6 (in a worker);
  5. stiff BDF: bench.py's Robertson workload at B=10,000 (8 observation
     times to 4e6, rtol 1e-8, atol [1e-10, 1e-12, 1e-10]) through
     ``make_batched_solve_fn(method='BDF', derivatives=None)``: one solve
     to t = 40 (the first 3 times) under the profiler for the device kernels
     per attempt and the device-busy share, then one timed solve, warm;
     status 0 in every lane
     (finite ys after the wrapper's NaN poisoning), lanes 0-15 inside the
     golden gate (tests/golden/robertson.npz, rtol 2e-5, atol 1e-10) and
     against the plain path on the CPU within 1e-6 relative (floored at the
     solver's atol); no kernel of the package launches on this path;
  5b. BDF forward sensitivities: the Lotka-Volterra problem of
     tests/golden/lv_sens.npz (sensitivities to alpha and beta, S0 = 0, rtol
     and atol 1e-9) at B=10,000, lanes 0-15 the fixture's and the rest a
     seeded 5% spread around them, through ``bdf_solve_batched``; status 0
     in every lane, lanes 0-15 inside the fixture's gate (ys rtol 1e-6 /
     atol 1e-8, sens rtol 2e-4 / atol 5e-4) and, ys and sens, against the
     plain path on the CPU within 1e-6 relative (floored at atol 1e-9);
  6. the reference's default call: make_batched_solve_fn(problem) (BDF,
     the checkpointed adjoint over 1024 recorded steps with quintic Hermite
     rows, backward tolerances 1e-10) on phase 4's Lotka-Volterra inputs at
     B=10,000, 21 observation times, rtol = atol = 1e-8, through
     ``entry.build_lv_checkpointed``: one timed gradient step (no profiled
     one: the script's time went to phases 10 and 11), with the attempts of
     each solve and host ms per attempt; status 0 and finite
     gradients in every lane, lanes 0-15 inside the golden gate and against
     the plain path on the CPU within 1e-6; then 'polynomial' on lanes 0-15
     over the first 4 observation times (t <= 2.35, ``POLY_TIMES``), the card
     against the CPU within 1e-6; no kernel of the package launches on this
     path;
  7. the ADAMS adjoints that read no transition matrix, 'resolve',
     'hermite' and 'polynomial', through ``entry.build_lv_adams`` on phase
     4's inputs at B=10,000, 21 observation times, rtol = atol = 1e-8 forward
     and backward, 384 checkpoints (the JAX package's golden test of these
     modes): per mode one timed gradient step with every kernel count set to
     0 before it, the history-attempt launches equal to the forward plus the
     backward attempts, split by system, and no launch of the PECE, the
     flat-history or a split kernel (no profiled step: the script's time went
     to phases 10 and 11), the table's bytes and the peak memory; status 0
     and finite gradients in every lane, lanes 0-15
     inside the golden gate and against the same call on the CPU within
     1e-6;
  8. SIR over 1,000 regions, a TorchProblem (scripts/bench_sir_scale.py's
     configuration: 12 observation times, rtol 1e-8 / atol 1e-10 both ways,
     1,024 checkpoints) through ``entry.build_sir``: 'resolve' at B=1,024 and
     'hermite' at B=256 (an 18.9 GB table), per mode one step over the
     first 2 observation times (t <= 10) under the profiler, which is also
     the warm-up, and one timed gradient step with every kernel count set
     to 0 before it; split launches equal to 1 / 4 / 1 x the forward plus
     backward attempts (predict / sweep / finish), no launch of any other
     kernel and no plain-stage call; in the profile, no fill right before a
     predict or a sweep (one before each finish, its tile counter's reset);
     status 0 and finite in every
     lane, lane 0 (set to the golden case's inputs, as the script sets it)
     inside tests/golden/sir_1000.npz's gate (ys rtol 1e-5 /
     atol 1e-7, gradient rtol 1e-3) and lanes 0-3 against the CPU within
     1e-8 relative;
  9. forward sensitivities and rootfinding on Lotka-Volterra at B=10,000:
     (a) the 'sensitivity' (the augmented state [y | vec S]) and
     'staged_sensitivity' (vec S, y staged after the parameters) builds
     against their plain versions as in phase 3c (the plain f read from the
     builds' emitted C, and that f within 1e-14 normwise of the f the Adams
     core composes from ``make_sensitivity_rhs``, at every point each
     attempt evaluates it), and the split kernels as
     in phase 3d, timed as at its first shape, on the sensitivity block (4
     rows, B=10,000, history depth 9) of one attempt of (b)'s Adams
     staggered solve, its inputs taken where the solve calls the history
     attempt (its rows fit one chunk: the finish's one-chunk form, with no
     fill before it in a profile of one call, where phase 3d's SIR shapes
     see their tile counters' fill); the 'staged_sensitivity' build on that
     attempt too, with
     phase 3c's C6 checks and the same 1e-14 against the core's f, its
     error rows held against themselves lane by lane and against the terms
     they are the difference of; (b)
     ``entry.build_lv_sens``: BDF and
     Adams staggered at rtol = atol = 1e-9 and Adams simultaneous at rtol
     1e-8 (bench.py's lv_sens), one timed solve each with every kernel count
     set to 0 before it (the Adams state block's and the sensitivity block's
     launches each equal to the attempts; none for BDF) and, for the Adams
     modes, one profiled over the first tenth of the horizon; status 0 in
     every lane, lanes
     0-15 inside tests/golden/lv_sens.npz's gate (ys rtol 5e-6 at rtol
     1e-8) and lanes 0-3 against the CPU within 1e-8; (c)
     ``entry.build_lv_roots`` (the event hares = 9) on both cores: terminal,
     non-terminal both ways and falling only (over t <= 5,
     ``ROOT_FALLING_TIMES``), each timed with the counts set to 0 before it;
     lanes 0-15 with the CPU's n_roots, directions and root times (1e-8),
     |g| at every recorded root <= 9e-6, every terminal lane with a root
     stopped at its first root with status 5 (a lane whose hares stay above
     9 on [0, 10] succeeds); the CPU references of (b) and (c), as of phase
     11, from the worker processes;
  10. float32 end to end: (a) the float32 builds of the history-attempt
     kernel for lv_adjoint_f32's systems (forward and transition) against
     their plain versions at float32 on phase 3c's draws at B=10,000 with
     that workload's tolerances (rtol = atol = 1e-6 forward, 1e-5 backward),
     normwise within 1e-5 and C6's bit-for-bit checks, conv and niter
     equal, and the float32 split kernels at phase 3d's forward shape
     (3,000, 1,024) with SIR's float32 tolerances, within 1e-5 and DF_resc
     and z_pred bit for bit, each timed as in phase 3 with its bound at 4
     bytes an element; (b) bench.py's lv_adjoint_f32 through
     ``entry.build_lv_adjoint_f32`` at B=10,000: one warm and one gated step
     (float32 gradients, every lane finite, lanes 0-15 within 1e-2 worst
     lane of lv_adjoint.npz, the float32 builds' launches equal to the
     attempts and no other kernel); (c) SIR-1000 'resolve' at float32 and
     B=1,024 through ``entry.build_sir(dtype=torch.float32)`` (rtol 1e-6 /
     atol 1e-8 forward, 1e-5 / 1e-7 backward), one gated step: status 0 and
     finite in every lane, lane 0's gradient within 1e-2 of sir_1000.npz,
     the float32 split build's launches 1 / 4 / 1 x the attempts;
  11. per-lane observation grids: ``entry.build_lv_per_lane`` at B=10,000
     (6 to 21 seeded times a lane on [0.5, 10], padded with copies of the
     last) on the Adams core (the forward build's launches equal to the
     attempts) and on BDF (no kernel): status 0 everywhere, every padded
     slot its lane's last value bit for bit, lanes 0-15 within 1e-8 of the
     CPU's plain path;
  12. structured Newton and splines (phase 2 builds the banded kernels,
     ``csrc/banded.cu``, at bandwidths (1, 1) at both types, and the spline
     LV's forward and transition history builds at both types): (a) the
     banded factor and solve kernels against their plain versions at
     float64 and float32 on the Fisher-KPP chain's Newton matrices I - c J
     at y0 (``entry.kpp_inputs``, c log-uniform in [1e-4, 1e-2], eight lanes
     of random band entries, one lane zero) at (n, B) = (128, 1,024) and
     (256, 1,024): lu, piv, sing and the solutions (1 and 3 right-hand
     sides, poisoned and not) bit for bit, the singular lane NaN in both;
     timed as in phase 3 with the bytes bound and the chain bound (n
     dependent steps of measured latencies, ``banded_chain``),
     ``torch.linalg.lu_factor_ex`` / ``lu_solve`` on the dense matrices as
     the yardstick, and device-timed once more on the Newton matrices alone
     (no test lane, whose tile takes the IEEE divide's slow path); (b)
     ``entry.build_kpp(128, 1024, 'band')`` (``scripts/bench_batched_
     structured.py``'s inputs, rtol 1e-8 / atol 1e-10, 1,024 checkpoints):
     a profiled forward solve (status 0 everywhere, lanes 0-2 within 5e-6 of
     scipy's LSODA at rtol 1e-11, lanes 0-3 within 1e-6 of the CPU's plain
     path) and a timed adjoint-gradient step over the first 2 observation
     times (t <= 0.19, ``STRUCT_LEADING_TIMES``: finite everywhere, lanes
     0-15 within rtol 1e-4 / atol 1e-8 of the dense solver's over the same
     times, run on the CPU in a worker); (c) the same chain at n = 256, forward only, timed and not
     profiled; (d)
     ``entry.build_hub(128, 1024, 'sparse')`` (129 states, the plan's border
     takes the hub): a forward, not profiled (status 0, lanes 0-3 within 1e-6 of the CPU,
     lanes 0-15 within 1e-6 / 1e-10 of the dense solve) and a gradient step
     (as (b), t <= 0.24); (e) (b)'s chain with spgmr, forward over its first
     2 observation times, timed and not profiled (status 0, LSODA there); each
     with the banded launches equal to the Newton solver's lockstep
     factorizations and solves (and one solve more a factorization with the
     BBD border) and no other kernel; (f) the spline LV's four builds
     against their plain versions as in phases 3c and 10(a), then
     ``entry.build_lv_spline`` at B=10,000, one timed ADAMS forward +
     transition-adjoint step: the float64 builds' launches equal to the
     attempts, every lane finite, lanes 0-3 within 1e-8 of the CPU;
  13. the single-chain surface (``make_solve_fn``, ``solve_ivp``): (0) the
     banded kernels at B=1 (one lane tile) bit for bit their plain versions
     at n = 1, 37 and 128, timed at 128; (a) ``entry.build_lv_single`` (BDF,
     the checkpointed 'hermite' adjoint, backward 1e-10) on lanes 0-1 of
     lv_adjoint.npz: status 0, the golden gate and the CPU within 1e-6; (b)
     ``entry.build_kpp_single(128, 'band')``'s gradient within rtol 1e-4 /
     atol 1e-8 of the dense solver's (on the CPU), its banded launches equal
     to the Newton solver's calls; (c) the README's torch quickstart,
     ``solve_ivp`` on the sympy LV with a ``torch.autograd`` gradient, the
     CPU within 1e-6; (d) per-lane grids with gradients through
     ``solve_lanes`` on two lanes, the CPU within 1e-6; each part with every
     count set to 0 before it, its attempts, host ms an attempt and wall
     seconds;
  14. the class API and events (``Solver``, ``AdjointSolver``,
     ``make_event_fn``, ``make_hybrid_solve_fn``): (a)
     ``entry.build_lv_forward(10_000)``, bench.py's lv_forward through
     ``Solver(solver='ADAMS', reltol=1e-10, abstol=1e-10)`` with per-lane
     params, one timed solve: status 0 everywhere, lanes 0-15 within rtol
     2e-7 / atol 2e-9 of lv_forward.npz, lanes 0-3 within 1e-8 of the CPU,
     the KAB=11 forward build's launches equal to the attempts and no other
     kernel; (b) ``AdjointSolver`` on the README's chain (hermite, unit
     cotangents) as BDF/BDF and ADAMS/ADAMS: each within 1e-6 of the CPU,
     ADAMS against BDF at ys rtol 1e-6 / atol 1e-8 and gradient and lambda
     rtol 1e-3 / atol 1e-6, the ADAMS backward's KAB=11 staged_adjoint
     launches equal to its attempts, the BDF pair none; (c) the ball's
     event time through ``entry.build_ball_event`` ('forward' and
     'adjoint') and ``entry.build_ball_hybrid``'s three impacts with the
     final state's gradient, each within 1e-6 of the closed forms (exact
     derivatives of the closed-form trajectory), then a restitution sweep
     over 4 lanes through ``map_lanes`` (values only, ``derivatives=None``;
     impact times against the closed forms), no kernel launched; each part
     with every count set to 0 before it, its attempts (the functions'
     ``last_stats``), host ms an attempt and wall seconds;
  15. the sampler path (``sunode_torch.sample``, the PyTensor wrapper):
     (a) BASELINE config 4 at full width, ``entry.build_lv_nuts(512)``
     (scripts/exp_nuts_f32.py's chains, float64): the start's gradient
     under the profiler, then one NUTS transition from log(1.0, 0.3) +
     0.01 N(0, 1) at a fixed step size, unit mass and max_treedepth 3 (the
     script's 6, cut), its draws from a seeded CPU source, against chains
     0-15 through the plain path on the CPU with those chains' rows of the
     same draws (in a worker): depth, divergence and the proposal's leaf
     equal, q, logp, grad and the accept statistic within 1e-8; (b)
     ``nuts_sample`` over the 512 chains from the same start, 2 warmup
     draws (the mass swap at the second) and 2 kept, max_treedepth 2: every
     draw finite, every chain moved, under 5% divergent, accept statistics
     in [0, 1], the adapted step size finite and positive; wall seconds,
     leapfrogs (batched gradients), chain-gradients and draws per second;
     in (a) and (b) the main path's history builds' launches equal to the
     attempts the solves report, by build, and no other kernel; (c)
     ``tests/test_pytensor.py``'s graph through the port's PyTensor wrapper
     (its own Op-protocol shim) with ``derivatives='adjoint'`` and
     ``'forward'`` (simultaneous), the loss and its gradients compiled with
     ``pytensor.function`` and evaluated with the Ops' solvers on the card
     and on the CPU: within 1e-10, no kernel launched (BDF);
  16. the native host route and the chain split: (a) ``entry.build_lv_forward_single``
     (bench.py's ``lv_forward --batch 1``) on ``device="cpu"``, which takes
     the native route (C++ Adams): within rtol 1e-6 / atol 1e-8 of the
     1e-13 native BDF oracle, the minimum µs over 50 solves; then on the
     card (the single Adams core): the same gate, seconds a solve over 2
     solves, attempts and ms an attempt, no kernel launched; (b)
     ``entry.build_lv_adjoint_single`` (bench.py's ``lv_adjoint --batch 1``,
     ADAMS/ADAMS) on the CPU, the native augmented backward: gy and gp
     within rtol 2e-3 / atol 1e-3 of lv_adjoint.npz lane 0, the minimum µs
     a pair over 50; then on the card: the same gate, seconds a pair, the
     largest relative difference from the native pair, the KAB=11
     staged_adjoint launches equal to the backward attempts; (c)
     ``entry.build_lv_adjoint_sharded`` at B=10,000 on ``make_mesh()`` (the
     one card) and on ``Mesh((cuda:0, cuda:0))``, a thread a chunk:
     each gradient bit for bit phase 4's lane by lane (else within 1e-12,
     the lanes printed, and the quadrature contraction split the same way
     on seeded inputs, ROADMAP C10), the main path's history builds' launches equal to
     the chunks' summed attempts, seconds a step; (d) the two g++ builds'
     seconds (the core library and LV's problem library), made in a worker
     at the pool's start; the host's CPU model and threads beside the
     card's name and power limit, as (a) and (b) time the host;
  17. the state axis (``make_mesh_2d``, ``shard_batch_state``): (a) the
     split attempt's partial-norm entries (the rows' sweep, which decides
     the sweep before, the rows' finish, and the lanes' finish, which
     decides the last sweep, then takes the roots; ``csrc/adams_split.cu``)
     against their plain versions at phase 8's 'hermite' backward shape
     (nz = 3,002, n = 3,000, B=256) cut in two row blocks of the card (1,502
     rows on the home block: 1,500 state rows and the 2 quadratures; 1,500
     on the other), one attempt's four sweeps and finish on phase 3d's
     seeded inputs: the rows' outputs and the decided state bit for bit,
     each lane's sums over a block's rows within 1e-12 (the kernel's
     order), the roots, conv and niter bit for bit on the same sums; each
     timed on the home block as in phase 3 with its bytes bound; (b)
     SIR-1000 'hermite' at B=256 with each chain's state rows
     split over ``Mesh(((cuda:0, cuda:0),), ("chains", "state"))``, a 1x2
     mesh of the one card (``entry.build_sir_state_split``), one gradient
     step with every count set to 0 before it, held to phase 8's step (no
     second unsplit run): ys and the gradient within rtol 1e-10 / atol 1e-12
     in every lane whose accepted forward and backward steps equal phase
     8's, within 1e-8 (phase 8's card-against-CPU bound) in a lane whose
     steps parted on a norm's last bit (their count printed), lane 0 inside
     sir_1000.npz's gate, status 0 and finite everywhere; predict's and the
     rows' launches 2 x and the lanes' 1 x the attempts (4 a sweep), no
     unsplit sweep or finish, no other kernel and no plain stage; wall
     seconds, attempts, each block's bytes, the bytes gathered and scattered
     an attempt and the peak memory; (c) a 1x1 mesh over the first 2
     observation times on lanes 0-63, ys and gradient bit for bit the
     unsplit solve's;
  18. the kernel table and the result line.  Each kernel's bound is the
     larger of its bytes (each input read once, each output written once,
     for the rows these inputs read, at 8 bytes a value, 4 in the float32
     builds) over 3.35 TB/s and its operations over 34 TFLOP/s at float64,
     67 at float32 (H100 SXM, NVIDIA's data sheet).  No single PyTorch
     call computes a PECE attempt, a history attempt or a split stage, so
     their library_ms is null; the banded kernels' is the dense
     ``torch.linalg`` call's time, which the port never makes.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

B_MAIN = 10_000
B_2D = (10_240, 102_400)  # the script's width, and ten times it
REL_BOUND = 1e-12  # kernel vs plain: FMA contraction and RHS rounding only
HERE = os.path.dirname(os.path.abspath(__file__))
TPU_KERNEL = "sunode_tpu/ops/pallas_step.py:110"
KERNEL_SOURCE = "sunode_torch/csrc/pece_step.cu"
TPU_KERNEL_2D = "scripts/exp_pallas2d.py:59"
KERNEL_SOURCE_2D = "sunode_torch/csrc/pece_2d.cu"
KERNEL_SOURCE_ATTEMPT = "sunode_torch/csrc/adams_attempt.cu"
P_MAX = 6  # adams_max_order of the main path: history depth KAB = P_MAX + 3 = 9
P_MAX_ADAMS = 8  # phase 7's adams_max_order (the default): KAB = 11
SENS_KINDS = ("sensitivity", "staged_sensitivity")  # phase 9's builds, at KAB = P_MAX + 3
ADAMS_MODES = ("resolve", "hermite", "polynomial")
ADAMS_RTOL = 1e-8  # phase 7's tolerances, forward and backward, every row
F64_FLOPS = 34e12  # H100 SXM, float64 outside the tensor cores (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores (NVIDIA data sheet)
F32_REL_BOUND = 1e-5  # float32 kernel vs plain, where the emitted f is not the plain f's
F32_FWD_TOL, F32_BWD_TOL = 1e-6, 1e-5  # bench.py's lv_adjoint_f32 tolerances


def log(msg: str) -> None:
    print(msg, flush=True)


T_START = time.perf_counter()


def log_elapsed(phase: str) -> None:
    """The script's wall time so far, after each phase."""
    log(f"[elapsed] after phase {phase}: {time.perf_counter() - T_START:.1f} s")


# ---- the CPU references, in worker processes while the card works -------------
CPU_REF_WORKERS = 4  # processes, one torch thread each, beside the script's own


def _ref_worker_init() -> None:
    import torch

    torch.set_num_threads(1)


class CpuRefs:
    """The plain path's references on the CPU that phases 4 to 15 read
    (the CPU's lanes of each gate), computed in worker processes from the
    same seeded inputs while the card runs the phases before them: main
    submits every one before phase 2, each phase reads its own.  A phase
    whose reference was not submitted computes it inline (:func:`cpu_ref`).
    ``close`` stops every worker."""

    def __init__(self):
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        self.pool = ProcessPoolExecutor(CPU_REF_WORKERS, mp_context=mp.get_context("spawn"),
                                        initializer=_ref_worker_init)
        self.futures: dict = {}

    def submit(self, fn, *args) -> None:
        self.futures[(fn.__name__, args)] = self.pool.submit(fn, *args)

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)


CPU_REFS: CpuRefs | None = None


def cpu_ref(fn, *args):
    """``fn(*args)``'s result: from the worker that computed it, when main
    submitted it, else computed here."""
    future = CPU_REFS.futures.pop((fn.__name__, args), None) if CPU_REFS else None
    return future.result() if future is not None else fn(*args)


POLY_TIMES = 4  # phase 6's 'polynomial' check: the first 4 of the 21 times, t <= 2.35


def ref_main_path() -> dict:
    """Phase 4's CPU reference: lanes 0-15 of the main path's chains."""
    import torch

    from sunode_torch.entry import build_lv_adjoint

    t0 = time.perf_counter()
    y0s, p_subs = lv_main_inputs()
    step, _ = build_lv_adjoint(16, 21, 1e-8, device="cpu")
    gy, gp = step(torch.as_tensor(y0s[:16], dtype=torch.float64),
                  torch.as_tensor(p_subs[:16], dtype=torch.float64))
    return dict(gy=gy.numpy(), gp=gp.numpy(), wall=time.perf_counter() - t0)


def ref_checkpointed(interpolation: str) -> dict:
    """Phase 6's CPU reference: the default call's gradients of lanes 0-15,
    over the first :data:`POLY_TIMES` observation times for 'polynomial'."""
    import torch

    from sunode_torch.entry import build_lv_checkpointed

    y0s, p_subs = lv_main_inputs()
    t0 = time.perf_counter()
    step, _ = build_lv_checkpointed(16, 21, 1e-8, interpolation, device="cpu")
    tvals = step.tvals[:POLY_TIMES] if interpolation == "polynomial" else step.tvals
    grads = step(torch.as_tensor(y0s[:16]), torch.as_tensor(p_subs[:16]), tvals)
    st = step.solve.last_stats
    return dict(grads=[g.numpy() for g in grads], wall=time.perf_counter() - t0,
                fwd=st["forward"]["n_attempts"], bwd=st["backward"]["n_attempts"])


def ref_robertson() -> dict:
    """Phase 5's CPU reference: the 16 golden lanes' ys."""
    from sunode_torch.entry import build_robertson

    t0 = time.perf_counter()
    cpu_solve, cpu_inputs = build_robertson(16, device="cpu")
    return dict(ys=cpu_solve(0.0, *cpu_inputs).numpy(), wall=time.perf_counter() - t0)


def ref_adams(mode: str) -> dict:
    """Phase 7's CPU reference: one ADAMS mode's gradients of lanes 0-15."""
    import torch

    from sunode_torch.entry import build_lv_adams

    y0s, p_subs = lv_main_inputs()
    t0 = time.perf_counter()
    cpu_step, _ = build_lv_adams(16, 21, ADAMS_RTOL, mode, device="cpu")
    grads = cpu_step(torch.as_tensor(y0s[:16]), torch.as_tensor(p_subs[:16]))
    return dict(grads=[a.numpy() for a in grads], wall=time.perf_counter() - t0)


def sir_lane_inputs(mode: str, B: int):
    """Phase 8's inputs: ``entry.sir_inputs`` with lane 0 the golden case's."""
    from sunode_torch.entry import sir_inputs

    golden = np.load(os.path.join(HERE, "tests", "golden", "sir_1000.npz"))
    y0s, p_subs = sir_inputs(SIR_R, B)
    y0s[0], p_subs[0] = golden["y0"], golden["p0"][:2]
    return y0s, p_subs


def ref_sir(mode: str, B: int) -> dict:
    """Phase 8's CPU reference: lanes 0-3's ys and gradient."""
    import torch

    from sunode_torch.entry import build_sir

    y0s, p_subs = sir_lane_inputs(mode, B)
    t0 = time.perf_counter()
    step, _ = build_sir(SIR_R, 1, mode, device="cpu")
    cy, cg = step(torch.as_tensor(y0s[:4]), torch.as_tensor(p_subs[:4]))
    st = step.solve.last_stats
    return dict(ys=cy.numpy(), gp=cg.numpy(), wall=time.perf_counter() - t0,
                fwd=st["forward"]["n_attempts"], bwd=st["backward"]["n_attempts"])


def ref_structured(workload: str, n: int, solver: str) -> dict:
    """Phase 12's CPU reference: lanes 0-3's forward ys of ``entry.build_kpp``
    or ``build_hub`` (``workload`` 'kpp' or 'hub') on the B=1,024 draw's
    inputs."""
    import torch

    from sunode_torch import entry

    build = getattr(entry, f"build_{workload}")
    y0, p, _ = getattr(entry, f"{workload}_inputs")(n, B_STRUCT)
    t0 = time.perf_counter()
    forward, _, _ = build(n, 4, solver, device="cpu")
    ys = forward(torch.as_tensor(y0[:4]), torch.as_tensor(p[:4])).numpy()
    return dict(ys=ys, wall=time.perf_counter() - t0)


def leading_tvals(tvals, device):
    """Phase 12's numpy observation times cut to the first
    STRUCT_LEADING_TIMES, as a float64 tensor on ``device``."""
    import torch

    return torch.as_tensor(tvals[:STRUCT_LEADING_TIMES], dtype=torch.float64, device=device)


def ref_kpp_dense() -> dict:
    """Phase 12(b)'s dense reference on the CPU: lanes 0-15's gradients of
    ``entry.build_kpp`` at n = 128 with dense Newton, on the B=1,024 draw's
    inputs, over the first STRUCT_LEADING_TIMES observation times."""
    import torch

    from sunode_torch.entry import build_kpp, kpp_inputs

    y0, p, tvals = kpp_inputs(128, B_STRUCT)
    t0 = time.perf_counter()
    _, grad_step, _ = build_kpp(128, 16, "dense", device="cpu")
    grads = [g.numpy() for g in grad_step(torch.as_tensor(y0[:16]), torch.as_tensor(p[:16]),
                                          leading_tvals(tvals, "cpu"))]
    return dict(grads=grads, wall=time.perf_counter() - t0)


def ref_hub_dense() -> dict:
    """Phase 12(d)'s dense reference on the CPU: lanes 0-15's forward ys and
    gradients of ``entry.build_hub`` with dense Newton, on the B=1,024
    draw's inputs (the gradients over the first STRUCT_LEADING_TIMES
    observation times)."""
    import torch

    from sunode_torch.entry import build_hub, hub_inputs

    y0, p, tvals = hub_inputs(128, B_STRUCT)
    y0, p = torch.as_tensor(y0[:16]), torch.as_tensor(p[:16])
    t0 = time.perf_counter()
    forward, grad_step, _ = build_hub(128, 16, "dense", device="cpu")
    ys = forward(y0, p).numpy()
    grads = [g.numpy() for g in grad_step(y0, p, leading_tvals(tvals, "cpu"))]
    return dict(ys=ys, grads=grads, wall=time.perf_counter() - t0)


def ref_lv_spline() -> dict:
    """Phase 12(f)'s CPU reference: lanes 0-3's gradients (a draw of 4 lanes
    is lanes 0-3 of the 10,000-lane one)."""
    from sunode_torch.entry import build_lv_spline

    t0 = time.perf_counter()
    step, (y0s, p_subs) = build_lv_spline(4, device="cpu")
    return dict(grads=[g.numpy() for g in step(y0s, p_subs)], wall=time.perf_counter() - t0)


def ref_sens(method: str, mode: str) -> dict:
    """Phase 9(b)'s CPU reference: lanes 0-3 of one sensitivity mode (the
    B=10,000 draw's lanes, which every width shares)."""
    from sunode_torch.entry import build_lv_sens

    _, (y0s, ps, tvals) = build_lv_sens(B_MAIN, method, mode, device="cpu")
    t0 = time.perf_counter()
    solve, _ = build_lv_sens(4, method, mode, device="cpu")
    res = solve(y0s[:4], ps[:4], tvals)
    return dict(ys=res.ys.numpy(), sens=res.sens.numpy(), status=res.status.numpy(),
                wall=time.perf_counter() - t0)


def ref_roots(method: str, terminal: bool, directions) -> dict:
    """Phase 9(c)'s CPU reference: lanes 0-15 of one root run, on the
    B=10,000 draw's lanes."""
    from sunode_torch.entry import build_lv_roots

    _, (y0s, ps, tvals) = build_lv_roots(B_MAIN, method, terminal, device="cpu")
    t0 = time.perf_counter()
    solve, _ = build_lv_roots(16, method, terminal, device="cpu")
    res = solve(y0s[:16], ps[:16], root_horizon(tvals, directions),
                root_directions=None if directions is None else list(directions))
    out = {k: res.stats[k].numpy() for k in ("n_roots", "roots_t", "roots_found")}
    return dict(out, status=res.status.numpy(), attempts=res.stats["n_attempts"],
                wall=time.perf_counter() - t0)


def ref_per_lane(method: str) -> dict:
    """Phase 11's CPU reference: lanes 0-15 of the B=10,000 draw's per-lane
    grids."""
    from sunode_torch.entry import build_lv_per_lane

    _, (y0s, ps, tvals) = build_lv_per_lane(B_MAIN, method, device="cpu")
    t0 = time.perf_counter()
    solve, _ = build_lv_per_lane(16, method, device="cpu")
    res = solve(y0s[:16], ps[:16], tvals[:16])
    return dict(ys=res.ys.numpy(), status=res.status.numpy(), wall=time.perf_counter() - t0)


def submit_cpu_refs() -> CpuRefs:
    """Start every CPU reference of phases 4 to 15 in the workers."""
    refs = CpuRefs()
    refs.submit(ref_native_build)  # phase 16's g++ builds, while the card works
    refs.submit(ref_main_path)  # in the order the phases read them
    refs.submit(ref_robertson)
    refs.submit(ref_bdf_sens)
    for interpolation in ("hermite", "polynomial"):
        refs.submit(ref_checkpointed, interpolation)
    for mode in ADAMS_MODES:
        refs.submit(ref_adams, mode)
    for mode, B in SIR_MODES:
        refs.submit(ref_sir, mode, B)
    for args in (("kpp", 128, "band"), ("kpp", 256, "band"), ("hub", 128, "sparse")):
        refs.submit(ref_structured, *args)
    refs.submit(ref_kpp_dense)
    refs.submit(ref_hub_dense)
    for method, mode in (("BDF", "staggered"), ("ADAMS", "staggered"),
                         ("ADAMS", "simultaneous")):
        refs.submit(ref_sens, method, mode)
    for method in ("BDF", "ADAMS"):
        for terminal, directions in ROOT_RUNS:
            refs.submit(ref_roots, method, terminal,
                        None if directions is None else tuple(directions))
    for method in ("ADAMS", "BDF"):
        refs.submit(ref_per_lane, method)
    refs.submit(ref_lv_spline)
    refs.submit(ref_single)
    refs.submit(ref_kpp_single_dense)
    refs.submit(ref_lv_forward)
    refs.submit(ref_class_adjoint)
    refs.submit(ref_nuts_transition)
    refs.submit(ref_pytensor)
    return refs


def check_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    return name, smi


def sass_instructions(lib_path):
    """SASS instructions in a built library (``cuobjdump -sass``), or None
    where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    return sum(1 for ln in sass.splitlines() if re.match(r"\s+/\*[0-9a-f]{4,}\*/", ln))


def pece_inputs(system, B, seed, device, p_max=P_MAX, tol=None, dtype=None):
    """Seeded inputs of one PECE attempt for ``system``: history depth KAB =
    p_max + 3, order 1..p_max per lane, 90% of lanes active, steps
    log-uniform in [1e-6, 1e-2]; the main path's tolerances, or, with
    ``tol``, rtol = atol = tol on every row (phases 7 and 10).  A system with
    more parameter rows than the problem's reads a staged y(t) there: seeded
    rows uniform in [0.5, 12] (the range of the LV states).  The tensors and
    the corrector tolerance are float64's, or ``dtype``'s (phase 10: the
    same draws rounded to float32)."""
    import torch

    from sunode_torch.entry import lv_options
    from sunode_torch.ops.bdf import BDFOptions, newton_tol_for

    rng = np.random.default_rng(seed)
    KAB, n, nz = p_max + 3, system.n, system.nz
    DF = rng.standard_normal((KAB, nz, B)) * (0.5 ** np.arange(KAB))[:, None, None]
    z_prev = 1.0 + rng.uniform(0.2, 1.0, (nz, B))
    params = np.array([1.0, 0.3, 1.0, 0.4])[:, None] * (
        1 + 0.1 * rng.standard_normal((4, B))
    )
    params = np.concatenate([params, rng.uniform(0.5, 12.0, (system.n_p - 4, B))])
    h = 10.0 ** rng.uniform(-6, -2, B)
    t_new = rng.uniform(0.0, 10.0, B)
    p = rng.integers(1, p_max + 1, B).astype(np.int32)
    active = rng.uniform(size=B) < 0.9
    fwd, adj = lv_options(1e-8)
    if tol is not None:
        rtol = atol = np.full(nz, tol)
        opts = BDFOptions(rtol=tol, atol=tol)
    elif nz == n:  # forward
        rtol = np.full(n, fwd.rtol)
        atol = np.full(n, fwd.atol)
        opts = fwd
    else:
        rtol = np.concatenate([adj.rtol, np.full(nz - n, adj.quad_rtol)])
        atol = np.concatenate([np.full(n, adj.atol), np.full(nz - n, adj.quad_atol)])
        opts = adj
    dtype = torch.float64 if dtype is None else dtype
    tol = newton_tol_for(opts, float(np.min(rtol[:n])), dtype)
    f_kw = dict(dtype=dtype, device=device)
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), **f_kw)  # noqa: E731
    return dict(
        t_new=T(t_new), h=T(h),
        p=torch.as_tensor(p, device=device),
        active=torch.as_tensor(active, device=device),
        DF=T(DF), z_prev=T(z_prev), params=T(params),
        atol_z=T(atol), rtol_z=T(rtol), newton_tol=tol,
    )


def lv_plain_fz(problem, kind):
    """The plain right-hand side of one of the emitted Lotka-Volterra systems
    'forward', 'transition', 'resolve' and 'staged_adjoint', composed as the
    Adams core composes it (the staged one reads ``[params | y(t)]`` from its
    parameter rows)."""
    import torch

    from sunode_torch.adjoint import resolve_fz, staged_adjoint_fz, transition_fz

    rhs = problem.make_rhs()
    if kind == "forward":
        return rhs
    if kind == "transition":
        rhs_c, quad_c = transition_fz(
            rhs, problem.make_adjoint_jac_dense(), problem.make_dfdp(), problem.n_states)
        return lambda t, y, p: torch.cat([rhs_c(t, y, p), quad_c(t, y, p)])
    aj, qr = problem.make_adjoint_rhs(), problem.make_adjoint_quad_rhs()
    if kind == "resolve":
        res_c, res_q = resolve_fz(rhs, aj, qr, problem.n_states)
        return lambda t, y, p: torch.cat([res_c(t, y, p), res_q(t, y, p)])
    if kind != "staged_adjoint":
        raise ValueError(f"no plain right-hand side for the system {kind!r}")
    stg_c, stg_q = staged_adjoint_fz(aj, qr)
    n_p = problem.n_all_params
    return lambda t, y, p: torch.cat(
        [stg_c(t, y, p[:n_p], p[n_p:]), stg_q(t, y, p[:n_p], p[n_p:])])


def rhs_flops(system) -> int:
    """Arithmetic operators in the emitted right-hand side's assignments: the
    operations of one evaluation at the system's type, counted from the
    source."""
    body = system.source.split("pece_fz(", 1)[1]
    lines = [ln.split("=", 1)[1] for ln in body.splitlines()
             if ln.strip().startswith(("out[", f"const {system.real} x_"))]
    return sum(ln.count(c) for ln in lines for c in "+-*/")


def bound(nbytes: float, flops: float, dtype=None) -> dict:
    """Kernel-table fields: the least time on the card and what sets it, the
    operations at the float64 rate, or at ``dtype``'s (float32: 67 TFLOP/s)."""
    import torch

    from sunode_torch.experiments.exp_pece2d import HBM_BYTES_PER_S

    rate = F32_FLOPS if dtype == torch.float32 else F64_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return dict(
        bound_ms=1e3 * max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None,  # no single PyTorch call computes either attempt
    )


def per_call_times(call, z, kernel=None, reps=None) -> dict:
    """Per-call times of ``call(z_prev) -> (z_new, ...)`` at ``z``:
    graph-replayed (20 chained calls in one CUDA graph), on the stream (CUDA
    events, host cost included) and device-busy (profiler, its sessions held
    to ``kernel``'s records: :func:`exp_pece2d.device_us`), microseconds.
    ``kernel`` names the hand-written kernel ``call`` launches; without it
    ``call`` is a plain version, which copies its coefficient tables from
    the host on every call, which a graph cannot capture (graph None)."""
    from sunode_torch.experiments.exp_pece2d import cuda_ms, device_us, graph_us

    kw = {} if reps is None else dict(reps=reps)  # fewer calls for a slow plain version
    return dict(
        graph=graph_us(call, z) if kernel else None,
        stream=1e3 * cuda_ms(lambda: call(z), **kw),
        device=device_us(lambda: call(z), kernel=kernel, **kw),
    )


def fmt_us(us) -> str:
    return "not measured" if us is None else f"{us:.2f}"


def fmt_times(name, t) -> str:
    times = "/".join(fmt_us(t[k]) for k in ("graph", "stream", "device"))
    return f" {name}_us_per_call graph/stream/device={times}"


def rel_errors(pairs):
    """({name: max|a - b| / max|b|}, worst max|a - b|) over ``{name: (a, b)}``."""
    rel, abs_err = {}, 0.0
    for name, (a, b) in pairs.items():
        diff = float((a - b).abs().max())
        rel[name] = diff / float(b.abs().max())
        abs_err = max(abs_err, diff)
    return rel, abs_err


def normwise(got, ref, names):
    """:func:`rel_errors` over the fields ``names`` of two results."""
    return rel_errors({name: (getattr(got, name), getattr(ref, name)) for name in names})


def compare_kernel(kind, device_system, fz, seed):
    """Phase 3 for one build: returns the kernel-table entry fields."""
    import torch

    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER
    from sunode_torch.ops.pece_step import (
        PeceSystem,
        adams_pece_attempt,
        adams_pece_attempt_reference,
    )

    system = PeceSystem(fz=fz, n=device_system.n, nz=device_system.nz, device=device_system)
    x = pece_inputs(device_system, B_MAIN, seed, "cuda")

    def args(z):
        return (x["t_new"], x["h"], x["p"], x["active"], x["DF"], z, x["params"],
                x["atol_z"], x["rtol_z"], x["newton_tol"], FUNCTIONAL_MAXITER)

    run_k = lambda z: adams_pece_attempt(system, *args(z))  # noqa: E731
    run_p = lambda z: adams_pece_attempt_reference(fz, *args(z), system.n)  # noqa: E731
    got, ref = run_k(x["z_prev"]), run_p(x["z_prev"])
    torch.cuda.synchronize()
    rel, abs_err = normwise(got, ref, ("y_it", "z_new", "d_fz", "err", "z_pred"))
    conv_same = bool(torch.equal(got.conv, ref.conv))
    niter_same = bool(torch.equal(got.niter, ref.niter))
    call_k = lambda z: (run_k(z).z_new,)  # noqa: E731
    call_p = lambda z: (run_p(z).z_new,)  # noqa: E731
    t_k = per_call_times(call_k, x["z_prev"], "pece_attempt_kernel")
    t_p = per_call_times(call_p, x["z_prev"])
    log(
        f"[kernel-vs-plain {kind}] B={B_MAIN} n={system.n} nz={system.nz} "
        + " ".join(f"rel_{k}={v:.3e}" for k, v in rel.items())
        + f" conv_equal={conv_same} niter_equal={niter_same}"
        f" converged={int(got.conv.sum())}/{B_MAIN}"
        f" niter_hist={torch.bincount(got.niter.long(), minlength=5).tolist()}"
        + fmt_times("kernel", t_k) + fmt_times("plain", t_p)
    )
    if not (max(rel.values()) <= REL_BOUND and conv_same and niter_same):
        raise SystemExit(f"chip_smoke: {kind} kernel disagrees with the plain version")
    # bytes: the history rows each lane reads (i < p), the other inputs once,
    # the outputs once; operations: predictor, sweeps taken, final evaluation
    n, nz, n_p = system.n, system.nz, device_system.n_p
    p_sum, sweeps = int(x["p"].sum()), int(got.niter.sum())
    nbytes = 8 * (p_sum * nz + B_MAIN * (nz + n_p + 2) + 2 * nz) + 5 * B_MAIN
    nbytes += 8 * B_MAIN * (n + 4 * nz) + 5 * B_MAIN
    f = rhs_flops(device_system)
    flops = 3 * p_sum * nz + B_MAIN * (2 * nz + 3 * n + 1) + sweeps * (f + 6 * n)
    flops += B_MAIN * (f + 5 * nz)
    return dict(max_abs_err=abs_err, ms=t_k["stream"] / 1e3, plain_ms=t_p["stream"] / 1e3,
                **bound(nbytes, flops))


def history_inputs(system, B, seed, device, p_max=P_MAX, tol=None, dtype=None):
    """Phase 3's inputs plus what the history attempt also reads, as the main
    path builds it: the step ratio h / h_D (seeded, log-uniform in [0.2, 2]),
    |gamma*| and the error norm's weights (1/n on the state rows; with the
    quadrature under error control, as every backward solve has it, half of
    each block's share); at float64 or ``dtype``."""
    import torch

    from sunode_torch.ops.adams import _GAMMA_STAR

    x = pece_inputs(system, B, seed, device, p_max, tol, dtype)
    rng = np.random.default_rng(1000 + seed)
    n, nz = system.n, system.nz
    if nz == n:
        v_err = np.full(n, 1.0 / n)
    else:
        v_err = np.concatenate([np.full(n, 0.5 / n), np.full(nz - n, 0.5 / (nz - n))])
    f64 = dict(dtype=x["DF"].dtype, device=device)
    x.update(
        pre_factor=torch.as_tensor(np.exp(rng.uniform(np.log(0.2), np.log(2.0), B)), **f64),
        gamma_star_abs=torch.as_tensor(np.abs(_GAMMA_STAR), **f64),
        v_err=torch.as_tensor(v_err, **f64),
    )
    return x


HISTORY_FIELDS = ("DF_resc", "DF_upd", "z_new", "err3", "z_pred", "err0")
HISTORY_KERNEL = "adams_attempt_kernel"  # the history attempt's kernel, as the profiler names it
C6_BITWISE = ("z_new", "err0", "DF_upd")  # bit for bit in the lanes where f rounds alike


def rhs_agreement(launch, fz, n, x, p_max):
    """(B,) bool: the lanes in which the emitted right-hand side of the
    build behind ``launch`` gives the plain ``fz`` bit for bit at every point
    the plain attempt evaluates it, its corrector's iterates (the plain
    stages of ``ops/adams_split.py``, bit for bit the plain attempt's) and
    the final one.  The build's own f at a point y: an attempt at order 1
    on a zero history from z_prev = y with no sweep evaluates f once, at y,
    and its DF_upd[0] = (f - 0) exactly.  ``launch(p, DF, z_prev, maxiter)``
    runs the build on ``x`` with those four replaced."""
    import torch

    ones, zeros = torch.ones_like(x["p"]), torch.zeros_like(x["DF"])
    agree = torch.ones_like(x["active"])
    for y, f in attempt_points(fz, n, x, p_max):
        emitted = launch(ones, zeros, torch.cat([y, x["z_prev"][n:]]), 0).DF_upd[0]
        agree &= (emitted == f).all(dim=0)
    return agree


def attempt_points(fz, n, x, p_max) -> list:
    """[(y, fz(y))] at every point the plain attempt on ``x`` evaluates f:
    its corrector's iterates and the final one (:func:`rhs_agreement`)."""
    from sunode_torch.ops import adams_split as sp
    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER

    t, par = x["t_new"], x["params"]
    pred = sp.split_predict(x["DF"], x["p"], x["pre_factor"], x["h"], x["z_prev"], x["atol_z"],
                            x["rtol_z"], p_max)
    y, state = pred.z_pred[:n], sp.sweep_start(x["active"], x["DF"].dtype)
    points = []
    for k in range(FUNCTIONAL_MAXITER):
        f = fz(t, y, par)
        points.append((y, f))
        y, state = sp.split_sweep(k, f, y, pred, state, x["newton_tol"], n)
    points.append((y, fz(t, y, par)))
    return points


def core_agreement(fz, core_fz, n, x, p_max) -> float:
    """The worst normwise relative difference, over the points the plain
    attempt on ``x`` evaluates f (:func:`attempt_points`), between ``fz``
    (a build's emitted f, which :func:`rhs_agreement` holds bit for bit to
    the kernel's) and ``core_fz``, the f the Adams core composes on its own
    (:func:`lv_sens_core_fz`): a wrong emitted row shows here."""
    t, par = x["t_new"], x["params"]
    return max(float((f - core_fz(t, y, par)).norm() / f.norm())
               for y, f in attempt_points(fz, n, x, p_max))


def c6_check(got, ref, agree) -> dict:
    """ROADMAP C6's checks of a history build against its plain version:
    DF_resc and z_pred bit for bit in every lane (neither reads f), z_new,
    err0 and DF_upd in the lanes ``agree`` (:func:`rhs_agreement`)."""
    import torch

    out = {f"{k}_bitwise": bool(torch.equal(getattr(got, k), getattr(ref, k)))
           for k in ("DF_resc", "z_pred")}
    for k in C6_BITWISE:
        out[f"{k}_bitwise_where_f_agrees"] = bool(
            torch.equal(getattr(got, k)[..., agree], getattr(ref, k)[..., agree]))
    return out


def fmt_c6(checks: dict, agree) -> str:
    return (f" f_agrees_in={int(agree.sum())}/{agree.shape[0]} lanes "
            + " ".join(f"{k}={v}" for k, v in checks.items()))


def history_cost(device_system, x, niter) -> tuple[int, int]:
    """(bytes, f64 operations) of one history attempt on the inputs ``x``:
    the history read once and written twice, the other inputs read once and
    the outputs written once; rescale, predictor, the sweeps taken, final
    evaluation, difference update and error rows, counted per lane from its
    order.  The rescale's factor R(fac) is built once a lane (p(p - 1)
    running-product steps of a difference, a product and a quotient, and p
    products fac i) and U = R(1) not at all (a constant table); each row
    applies both, p^2 products and p^2 sums each.  Floating values take the
    inputs' size, 8 bytes at float64 and 4 at float32."""
    n, nz, n_p = device_system.n, device_system.nz, device_system.n_p
    KAB, _, B = x["DF"].shape
    p = x["p"].long()
    w = x["DF"].element_size()
    nbytes = w * 3 * KAB * nz * B  # DF in; DF_resc, DF_upd out
    nbytes += w * B * (nz + n_p + 3) + 4 * B + B  # z_prev, params, t, h, ratio; p; active
    nbytes += w * (3 * nz + x["gamma_star_abs"].numel())  # atol_z, rtol_z, v_err, |gamma*|
    nbytes += w * B * (3 * nz + 3) + B + 4 * B  # z_pred, z_new, err0, err3; conv; niter
    f = rhs_flops(device_system)
    # per lane: R(fac); per row: R and U applied (p outputs of p products
    # and sums each), predictor and f_ex; suffix sums, update, new state,
    # error rows and their weighted squares
    per_lane = 3 * p * (p - 1) + p
    per_row = 4 * p * p + 3 * p + 2 + KAB + 2 * p + 21
    flops = (int((nz * per_row + per_lane).sum()) + int(niter.sum()) * (f + 6 * n)
             + B * (f + 3 * n + 10))
    return nbytes, flops


def compare_history_kernel(kind, device_system, fz, seed, p_max=P_MAX, tol=None, dtype=None,
                           plain_reps=None, core_fz=None):
    """Phase 3c (and 10(a) at ``dtype`` float32) for one build: returns the
    kernel-table entry fields.  At float32 the normwise bound is
    F32_REL_BOUND, C6's bit-for-bit checks stay.  ``plain_reps`` times the
    plain version over fewer calls (12(f): its spline is hundreds of torch
    operations a right-hand side).  Given ``core_fz`` (phase 9's builds,
    whose plain ``fz`` is read from their emitted C), ``fz`` is held to it
    within SENS_CORE_REL at every point each attempt evaluates f."""
    import torch

    from sunode_torch.experiments.exp_pece2d import device_us
    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER
    from sunode_torch.ops.adams_attempt import (
        adams_history_attempt,
        adams_history_attempt_reference,
    )
    from sunode_torch.ops.pece_step import PeceSystem

    system = PeceSystem(fz=fz, n=device_system.n, nz=device_system.nz, device=device_system)
    x = history_inputs(device_system, B_MAIN, seed, "cuda", p_max, tol, dtype)
    rel_bound = F32_REL_BOUND if x["DF"].dtype == torch.float32 else REL_BOUND

    def args(z, p=x["p"]):
        return (x["t_new"], x["h"], x["pre_factor"], p, x["active"], x["DF"], z,
                x["params"], x["atol_z"], x["rtol_z"], x["gamma_star_abs"], x["v_err"],
                x["newton_tol"], FUNCTIONAL_MAXITER, p_max)

    run_k = lambda z: adams_history_attempt(system, *args(z))  # noqa: E731
    run_p = lambda z: adams_history_attempt_reference(system, *args(z))  # noqa: E731
    got, ref = run_k(x["z_prev"]), run_p(x["z_prev"])
    torch.cuda.synchronize()
    rel, abs_err = normwise(got, ref, HISTORY_FIELDS)
    conv_same = bool(torch.equal(got.conv, ref.conv))
    niter_same = bool(torch.equal(got.niter, ref.niter))

    def agreement(x_q):
        def launch(p, DF, z, maxiter):
            a = list(args(z, p))
            a[5], a[13] = DF, maxiter
            return adams_history_attempt(system, *a)

        return rhs_agreement(launch, fz, system.n, x_q, p_max)

    agree = agreement(x)
    c6 = {"seeded": (c6_check(got, ref, agree), agree)}
    core = {} if core_fz is None else {"seeded": core_agreement(fz, core_fz, system.n, x, p_max)}
    # one order in every lane: p = 1 (no rescale) and p = P_MAX (the whole
    # tables), against the plain version and timed
    at_p, ok_p = {}, {}
    for q in (1, p_max):
        p_q = torch.full_like(x["p"], q)
        got_q = adams_history_attempt(system, *args(x["z_prev"], p_q))
        ref_q = adams_history_attempt_reference(system, *args(x["z_prev"], p_q))
        torch.cuda.synchronize()
        rel_q, err_q = normwise(got_q, ref_q, HISTORY_FIELDS)
        abs_err = max(abs_err, err_q)
        ok_p[q] = (max(rel_q.values()), bool(torch.equal(got_q.conv, ref_q.conv)
                                              and torch.equal(got_q.niter, ref_q.niter)))
        agree_q = agreement({**x, "p": p_q})
        c6[f"p{q}"] = (c6_check(got_q, ref_q, agree_q), agree_q)
        if core_fz is not None:
            core[f"p{q}"] = core_agreement(fz, core_fz, system.n, {**x, "p": p_q}, p_max)
        at_p[q] = device_us(lambda: adams_history_attempt(system, *args(x["z_prev"], p_q)),
                            kernel=HISTORY_KERNEL)
    call_k = lambda z: (run_k(z).z_new,)  # noqa: E731
    call_p = lambda z: (run_p(z).z_new,)  # noqa: E731
    t_k = per_call_times(call_k, x["z_prev"], HISTORY_KERNEL)
    t_p = per_call_times(call_p, x["z_prev"], reps=plain_reps)
    nbytes, flops = history_cost(device_system, x, got.niter)
    entry = dict(max_abs_err=abs_err, ms=t_k["stream"] / 1e3, plain_ms=t_p["stream"] / 1e3,
                 **bound(nbytes, flops, x["DF"].dtype))
    log(
        f"[history-kernel-vs-plain {kind}] B={B_MAIN} n={system.n} nz={system.nz} "
        f"n_p={device_system.n_p} KAB={p_max + 3} dtype={x['DF'].dtype} "
        f"newton_tol={x['newton_tol']:.3e} bound={rel_bound:.0e} "
        + " ".join(f"rel_{k}={v:.3e}" for k, v in rel.items())
        + f" conv_equal={conv_same} niter_equal={niter_same}"
        f" converged={int(got.conv.sum())}/{B_MAIN}"
        f" niter_hist={torch.bincount(got.niter.long(), minlength=5).tolist()}"
        + fmt_times("kernel", t_k) + fmt_times("plain", t_p)
        + "".join(f" kernel_device_us_all_p{q}={fmt_us(v)}" for q, v in at_p.items())
        + "".join(f" all_p{q}: max_rel={r:.3e} flags_equal={same}"
                  for q, (r, same) in ok_p.items())
        + "".join(f" | C6 {o}:" + fmt_c6(checks, a) for o, (checks, a) in c6.items())
        + "".join(f" | emitted f vs the core's {o}: normwise {r:.3e} (bound {SENS_CORE_REL:.0e})"
                  for o, r in core.items())
        + f" | bytes={nbytes} flops={flops} bound_us={1e3 * entry['bound_ms']:.3f}"
        f" ({entry['bound_by']})"
    )
    if not (max(rel.values()) <= rel_bound and conv_same and niter_same
            and all(r <= rel_bound and same for r, same in ok_p.values())
            and all(all(checks.values()) for checks, _ in c6.values())
            and all(r <= SENS_CORE_REL for r in core.values())):
        raise SystemExit(f"chip_smoke: {kind} history kernel disagrees with the plain version")
    return entry


SIR_R = 1000  # scripts/bench_sir_scale.py's regions: 3,000 states
SIR_DERIVS = 2  # the gradient's parameters, beta and gamma
B_SPLIT = 1024  # phase 3d's lanes: the script's largest width
SIR_MODES = (("resolve", 1024), ("hermite", 256))  # phase 8: mode, lanes
SIR_PROFILED_TIMES = 2  # phase 8's profiled step: the first 2 observation times, t <= 10 (4, t <= 20, before phase 17)
# phase 3d's shapes: phase 8's forward attempts, and the backward attempts
# of each of its modes at that mode's lanes ('hermite' stages y(t))
SPLIT_CASES = (("forward", B_SPLIT), ("resolve", 1024), ("staged_adjoint", 256))
KERNEL_SOURCE_SPLIT = "sunode_torch/csrc/adams_split.cu"
SPLIT_STAGES = ("predict", "sweep", "finish")


def split_system(kind, R=SIR_R):
    """``(fz, n, nz)`` of one of phase 8's Adams solves of SIR over ``R``
    regions, composed as the Adams core composes it: 'forward' (the 3R
    states), 'resolve' (``[y | lam]``, 6R corrected rows, then the two
    gradient quadratures) or 'staged_adjoint' (lam, 3R rows, then the
    quadratures; y(t) rides in the parameter rows after the problem's
    three)."""
    import torch

    from sunode_torch.adjoint import resolve_fz, staged_adjoint_fz
    from sunode_torch.entry import sir_problem

    if kind == "staged_sensitivity":  # phase 9: Lotka-Volterra's sensitivity block
        return lv_sens_fz(kind), 4, 4
    problem, n = sir_problem(R), 3 * R
    if kind == "forward":
        return problem.make_rhs(), n, n
    adjoint, quad = problem.make_adjoint_rhs(), problem.make_adjoint_quad_rhs()
    if kind == "resolve":
        rhs_c, quad_c = resolve_fz(problem.make_rhs(), adjoint, quad, n)
        return (lambda t, z, par: torch.cat([rhs_c(t, z, par), quad_c(t, z, par)]),
                2 * n, 2 * n + SIR_DERIVS)
    if kind == "staged_adjoint":
        rhs_s, quad_s = staged_adjoint_fz(adjoint, quad)

        def fz(t, lam, par):
            p, y = par[:3], par[3:]
            return torch.cat([rhs_s(t, lam, p, y), quad_s(t, lam, p, y)])

        return fz, n, n + SIR_DERIVS
    raise ValueError(f"unknown split case {kind!r}")


def split_inputs(B, seed, device, R=SIR_R, kind="forward", dtype=None):
    """Phase 3d's inputs: one attempt of the SIR model over ``R`` regions
    in the solve ``kind`` (:func:`split_system`) at history depth KAB = 11
    (orders 1..8), seeded history, a step ratio log-uniform in [0.2, 2] as
    in phase 3c, 90% of lanes active, steps log-uniform in [1e-3, 1] around
    t in [0, 60] (tau in [-60, 0] backward), states around
    ``scripts/bench_sir_scale.py``'s (S ~ 0.99, I ~ 0.01, R ~ 0.01),
    adjoints and quadratures ~ 0.1, (beta, gamma, mix) with a 5% spread,
    the workload's tolerances (rtol 1e-8, atol 1e-10 on every row, the
    quadratures under error control) and corrector tolerance.  With
    ``dtype`` float32 (phase 10(a)): the same draws at float32, with the
    workload's float32 forward tolerances (``entry.sir_options``: rtol 1e-6,
    atol 1e-8) and their corrector tolerance."""
    import torch

    from sunode_torch.ops.adams import _GAMMA_STAR
    from sunode_torch.ops.bdf import BDFOptions, newton_tol_for

    if kind == "staged_sensitivity":
        return lv_sens_split_inputs(B, device)
    _, n, nz = split_system(kind, R)
    rng = np.random.default_rng(seed)
    KAB = P_MAX_ADAMS + 3
    DF = 1e-2 * rng.standard_normal((KAB, nz, B)) * (0.5 ** np.arange(KAB))[:, None, None]
    level = np.repeat([0.99, 0.01, 0.01], R)[:, None]
    y = level * (1 + 0.05 * rng.uniform(size=(3 * R, B)))
    params = np.array([0.4, 0.15, 0.05])[:, None] * (1 + 0.05 * rng.standard_normal((3, B)))
    v_err = np.full(nz, 1.0 / nz)
    if kind == "forward":
        z_prev, sign = y, 1.0
    else:
        lam_q = 0.1 * rng.standard_normal((3 * R + SIR_DERIVS, B))
        z_prev = np.concatenate([y, lam_q]) if kind == "resolve" else lam_q
        if kind == "staged_adjoint":
            params = np.concatenate([params, y])
        # the error norm's two blocks: the corrected rows and the quadratures
        v_err = np.concatenate([np.full(n, 0.5 / n), np.full(SIR_DERIVS, 0.5 / SIR_DERIVS)])
        sign = -1.0
    dtype = torch.float64 if dtype is None else dtype
    rtol, atol = (1e-8, 1e-10) if dtype == torch.float64 else (1e-6, 1e-8)
    f64 = dict(dtype=dtype, device=device)
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), **f64)  # noqa: E731
    return dict(
        t_new=T(sign * rng.uniform(0.0, 60.0, B)), h=T(10.0 ** rng.uniform(-3, 0, B)),
        pre_factor=T(np.exp(rng.uniform(np.log(0.2), np.log(2.0), B))),
        p=torch.as_tensor(rng.integers(1, P_MAX_ADAMS + 1, B).astype(np.int32), device=device),
        active=torch.as_tensor(rng.uniform(size=B) < 0.9, device=device),
        DF=T(DF), z_prev=T(z_prev), params=T(params),
        atol_z=T(np.full(nz, atol)), rtol_z=T(np.full(nz, rtol)),
        gamma_star_abs=T(np.abs(_GAMMA_STAR)), v_err=T(v_err),
        newton_tol=newton_tol_for(BDFOptions(rtol=rtol, atol=atol), rtol, dtype),
    )


def emitted_fz(system):
    """The plain right-hand side of an emitted system, read from its own
    source: ``pece_fz``'s straight-line C (``const double x_k = ...;`` and
    ``out[i] = ...;``) evaluated statement by statement on the rows of
    ``y`` and ``p`` with torch's elementwise operations, each rounded as
    the kernel's C rounds it (the builds take ``-fmad=false``: C6).  C and
    Python read ``+``, ``-``, ``*``, ``/``, unary minus and parentheses
    alike; the emitted calls map to torch's."""
    import torch

    body = system.source.split("pece_fz(", 1)[1]
    body = body[body.index("{") + 1: body.rindex("}")]
    stmts = []
    for line in body.split(";"):
        line = line.strip()
        if line:
            lhs, rhs = line.split("=", 1)
            stmts.append((lhs.split()[-1], rhs.strip()))
    funcs = {"exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt, "fabs": torch.abs,
             "sin": torch.sin, "cos": torch.cos, "pow": torch.pow, "log1p": torch.log1p,
             "tanh": torch.tanh, "fmax": torch.maximum, "fmin": torch.minimum}

    def fz(t, y, p):
        env = {"t": t, "y": y, "p": p, **funcs}
        out = [None] * system.nz
        for lhs, rhs in stmts:
            value = eval(rhs, {"__builtins__": {}}, env)  # the build's own statement
            if lhs.startswith("out["):
                out[int(lhs[4:-1])] = torch.broadcast_to(torch.as_tensor(value, dtype=y.dtype,
                                                                          device=y.device),
                                                         y.shape[1:])
            else:
                env[lhs] = value
        return torch.stack(out)

    return fz


def lv_sens_fz(kind):
    """The plain right-hand side of one of phase 9's emitted systems:
    'sensitivity' over ``[y | vec S]``, 'staged_sensitivity' over ``vec S``
    with y in the parameter rows after the four parameters.  It is lowered
    from the rows the build emits (:func:`emitted_fz` of
    ``cuda_codegen.<kind>_system``), so f rounds as the kernel's does
    (ROADMAP C6): the Adams core's own ``make_sensitivity_rhs`` sums ``S
    J^T`` by einsum and the emitted rows sum their CSE'd products in
    sympy's order, an ulp apart in most lanes."""
    from sunode_torch.entry import lv_problem
    from sunode_torch.symode import cuda_codegen

    return emitted_fz(getattr(cuda_codegen, f"{kind}_system")(lv_problem()))


def lv_sens_core_fz(kind):
    """The f of one of phase 9's emitted systems as the Adams core
    composes it from Lotka-Volterra's ``make_rhs`` and
    ``make_sensitivity_rhs`` (torch's einsum of ``S J^T``), independent of
    the emitted rows: :func:`core_agreement` holds the emitted f to it."""
    import torch

    from sunode_torch.entry import lv_problem

    problem = lv_problem()
    rhs, sens = problem.make_rhs(), problem.make_sensitivity_rhs()
    n, k, n_p = 2, 2, 4
    if kind == "sensitivity":
        return lambda t, z, p: torch.cat(
            [rhs(t, z[:n], p), sens(t, z[:n], z[n:].reshape(k, n, -1), p).reshape(k * n, -1)])
    return lambda t, S, par: sens(t, par[n_p:], S.reshape(k, n, -1), par[:n_p]).reshape(k * n, -1)


SENS_CORE_REL = 1e-14  # the emitted sensitivity f against the core's, normwise (ulps apart)
SENS_SPLIT_ATTEMPT = 300  # phase 9(a)'s split inputs: this attempt of the Adams staggered solve


class _Captured(Exception):
    """Carries one attempt's inputs out of the solve that made them."""


def lv_sens_split_inputs(B, device):
    """Phase 9(a)'s split-stage inputs: those of the sensitivity block in
    attempt :data:`SENS_SPLIT_ATTEMPT` of ``entry.build_lv_sens(B, 'ADAMS',
    'staggered')`` (4 rows ``vec S``, y_new staged after the 4 parameters,
    history depth KAB = P_MAX + 3 = 9), taken where the Adams core calls the
    history attempt on its 'staged_sensitivity' system, and the solve
    stopped there: the history, orders, steps, step ratios, gate,
    tolerances and error weights of a real solve of the chains."""
    from sunode_torch.entry import build_lv_sens
    from sunode_torch.ops import adams_batched

    names = ("t_new", "h", "pre_factor", "p", "active", "DF", "z_prev", "params", "atol_z",
             "rtol_z", "gamma_star_abs", "v_err", "newton_tol")
    attempt = adams_batched.adams_history_attempt
    seen = [0]

    def spy(system, *args):
        if system.nz == 4:  # the sensitivity block's call; the state's has 2 rows
            seen[0] += 1
            if seen[0] == SENS_SPLIT_ATTEMPT:
                raise _Captured(dict(zip(names, args)))
        return attempt(system, *args)

    solve, inputs = build_lv_sens(B, "ADAMS", "staggered", device=device)
    adams_batched.adams_history_attempt = spy
    try:
        solve(*inputs)
    except _Captured as captured:
        return captured.args[0]
    finally:
        adams_batched.adams_history_attempt = attempt
    raise RuntimeError(f"the solve ended before its attempt {SENS_SPLIT_ATTEMPT}")


def history_on_attempt(device_system, x) -> float:
    """Phase 9(a): the 'staged_sensitivity' history build against its plain
    version on the attempt of :func:`lv_sens_split_inputs`, inputs it meets
    in phase 9(b); returns the worst max|a - b|.  DF_resc, DF_upd, z_pred and
    z_new are held normwise to REL_BOUND, conv and niter equal, and ROADMAP
    C6's checks (:func:`c6_check`): DF_resc and z_pred bit for bit, z_new,
    err0 and DF_upd bit for bit where the emitted f rounds as the plain one
    (:func:`rhs_agreement`).  The error row err0 = |gamma*_p| h (f - f_ex)
    is, where the corrector converged, a difference far under f: an f an
    ulp apart moves it by far more than 1e-12 of itself.  So err0 and err3
    are held against themselves lane by lane (to REL_BOUND, per element)
    where the emitted f rounds as the plain one (the plain f is read from
    the build's emitted C, :func:`lv_sens_fz`, so that is every lane where
    the kernel's f is its C's), and in every lane against the terms they
    are the difference of (err0 normwise against |gamma*_p| h f_ex, err3
    lane by lane against those terms' weighted norm); their errors against
    themselves in every lane are logged.  The emitted f itself is held to
    the core's own composition (:func:`core_agreement`) within
    SENS_CORE_REL."""
    import torch

    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER
    from sunode_torch.ops.adams_attempt import (
        adams_history_attempt,
        adams_history_attempt_reference,
    )
    from sunode_torch.ops.pece_step import PeceSystem

    system = PeceSystem(fz=lv_sens_fz("staged_sensitivity"), n=device_system.n,
                        nz=device_system.nz, device=device_system)
    p_max = x["DF"].shape[0] - 3
    args = (x["t_new"], x["h"], x["pre_factor"], x["p"], x["active"], x["DF"], x["z_prev"],
            x["params"], x["atol_z"], x["rtol_z"], x["gamma_star_abs"], x["v_err"],
            x["newton_tol"], FUNCTIONAL_MAXITER, p_max)
    got = adams_history_attempt(system, *args)
    ref = adams_history_attempt_reference(system, *args)
    torch.cuda.synchronize()

    def launch(p, DF, z, maxiter):
        a = list(args)
        a[3], a[5], a[6], a[13] = p, DF, z, maxiter
        return adams_history_attempt(system, *a)

    agree = rhs_agreement(launch, system.fz, system.n, x, p_max)
    c6 = c6_check(got, ref, agree)
    core = core_agreement(system.fz, lv_sens_core_fz("staged_sensitivity"), system.n, x, p_max)
    rel, abs_err = normwise(got, ref, ("DF_resc", "DF_upd", "z_pred", "z_new"))
    own = {"err0/lane": lane_rel(got.err0, ref.err0), "err3/lane": lane_rel(got.err3, ref.err3)}
    own_agree = {k: lane_rel(getattr(got, f)[:, agree], getattr(ref, f)[:, agree])
                 if bool(agree.any()) else 0.0
                 for k, f in (("err0/lane", "err0"), ("err3/lane", "err3"))}
    p = x["p"].long()
    below_p = torch.arange(ref.DF_resc.shape[0], device=p.device)[:, None, None] < p
    f_ex = (ref.DF_resc * below_p).sum(dim=0)
    terms = x["gamma_star_abs"][p] * x["h"] * f_ex.abs()
    w = 1.0 / (x["atol_z"][:, None] + x["rtol_z"][:, None] * ref.z_pred.abs())
    terms_norm = torch.sqrt(((terms * w) ** 2 * x["v_err"][:, None]).sum(dim=0))
    rel["err0/terms"] = float((got.err0 - ref.err0).abs().max() / terms.max())
    rel["err3/terms"] = float(((got.err3 - ref.err3).abs() / terms_norm).max())
    flags = bool(torch.equal(got.conv, ref.conv) and torch.equal(got.niter, ref.niter))
    log(f"[history-kernel-vs-plain staged_sensitivity on the attempt] B={x['p'].shape[0]} "
        + " ".join(f"rel_{k}={v:.3e}" for k, v in rel.items())
        + " against themselves: " + " ".join(f"rel_{k}={v:.3e}" for k, v in own.items())
        + " (where f agrees: " + " ".join(f"rel_{k}={v:.3e}" for k, v in own_agree.items())
        + f") flags_equal={flags} converged={int(got.conv.sum())}/{x['p'].shape[0]} |"
        + fmt_c6(c6, agree)
        + f" | emitted f vs the core's: normwise {core:.3e} (bound {SENS_CORE_REL:.0e})")
    if not (max(rel.values()) <= REL_BOUND and max(own_agree.values()) <= REL_BOUND and flags
            and all(c6.values()) and core <= SENS_CORE_REL):
        raise SystemExit("chip_smoke: the staged_sensitivity history kernel disagrees with the "
                         "plain version on the solve's attempt")
    return max(abs_err, float((got.err0 - ref.err0).abs().max()),
               float((got.err3 - ref.err3).abs().max()))


def split_costs(x, n) -> dict:
    """{stage: (bytes, operations)} of the three kernels on the inputs
    ``x``: each input read once and each output written once (the history
    whole, as DF_resc and DF_upd are), and the operations each row's lane
    needs at its own order p: the rescale's two p x p products, predictor,
    extrapolation and weight; a sweep's update and square; the finish's
    suffix sums, update, new state and three weighted error squares.
    Floating values take the inputs' size (8 or 4 bytes)."""
    KAB, nz, B = x["DF"].shape
    p = x["p"].long()
    w = x["DF"].element_size()
    hist = w * KAB * nz * B
    lanes_in = w + 1 + 1 + 1 + w + 4  # c_A, conv, div, bad, dy_old, niter
    costs = {
        "predict": (2 * hist + w * nz * B * 4 + B * (w + w + 4 + w + 1) + w * 2 * nz,
                    int((nz * (4 * p * p + 3 * p + 6)).sum())),
        "sweep": (w * nz * B + w * 4 * n * B + w * n * B + 2 * B * lanes_in, 9 * n * B + 8 * B),
        "finish": (2 * hist + w * nz * B * 4 + w * nz * B * 2 + B * (w + 1 + 4 + w + 2)
                   + w * nz + w * x["gamma_star_abs"].numel() + B * (3 * w + 1),
                   nz * B * (3 * KAB + 22) + 8 * B),
    }
    return costs


def lane_rel(a, b) -> float:
    """max |a - b| / |b| element by element, each lane against its own
    value (a zero ``b`` needs an equal ``a``): for the per-lane outputs
    (err3, c_A, dy_old), whose lanes span orders of magnitude."""
    import torch

    diff = (a - b).abs()
    rel = torch.where(b != 0, diff / b.abs(), torch.where(diff == 0, 0.0, float("inf")))
    return float(rel.max())


def split_errors(normwise_pairs, lane_pairs):
    """({name: error}, worst max|a - b|): normwise (:func:`rel_errors`) on
    the (rows, B) fields, per lane (:func:`lane_rel`, named ``*/lane``) on
    the per-lane ones."""
    rel, abs_err = rel_errors(normwise_pairs)
    for name, (a, b) in lane_pairs.items():
        rel[f"{name}/lane"] = lane_rel(a, b)
        abs_err = max(abs_err, float((a - b).abs().max()))
    return rel, abs_err


def fmt_sweep(nz, B) -> str:
    """The sweep kernel's geometry at (nz, B), as ``ops/adams_split.py``
    chooses it."""
    from sunode_torch.ops.adams_split import sweep_geometry

    g = sweep_geometry(nz, B)
    return (f"sweep: cluster={g.cluster} rows_per_block={g.rows} lanes_per_tile={g.lanes} "
            f"row_threads={g.row_threads} blocks={g.blocks}")


def fmt_predict(nz, B) -> str:
    """The predict kernel's geometry at (nz, B), as ``ops/adams_split.py``
    chooses it."""
    from sunode_torch.ops.adams_split import predict_geometry

    g = predict_geometry(nz, B)
    return (f"predict: cluster={g.cluster} rows_per_block={g.rows} lanes_per_tile={g.lanes} "
            f"row_threads={g.row_threads} blocks={g.blocks}")


def compare_split(kind, B, seed, kernels, R=SIR_R, dtype=None) -> dict:
    """Phase 3d at one shape: the composed attempt on the kernels against
    the plain stages composed on the card, then each kernel against its
    plain stage on the same inputs (the plain stages' outputs feed the next
    stage of both).  Exits on any disagreement; returns the inputs, the
    plain stages' results and the errors by stage.  At ``dtype`` float32
    (phase 10(a), the kernels a float32 build) the bound is F32_REL_BOUND
    and DF_resc and z_pred are held bit for bit."""
    import torch

    from sunode_torch.ops import adams_split as sp
    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER
    from sunode_torch.ops.pece_step import PeceSystem

    x = split_inputs(B, seed, "cuda", R, kind, dtype)
    f32 = x["DF"].dtype == torch.float32
    rel_bound = F32_REL_BOUND if f32 else REL_BOUND
    p_max = x["DF"].shape[0] - 3
    fz, n, nz = split_system(kind, R)
    system = PeceSystem(fz=fz, n=n, nz=nz)
    args = (x["t_new"], x["h"], x["pre_factor"], x["p"], x["active"], x["DF"], x["z_prev"],
            x["params"], x["atol_z"], x["rtol_z"], x["gamma_star_abs"], x["v_err"],
            x["newton_tol"], FUNCTIONAL_MAXITER, p_max)
    got = sp.adams_split_attempt(system, *args)
    ref = sp.adams_split_attempt_reference(system, *args)
    torch.cuda.synchronize()
    rel, _ = split_errors(
        {k: (getattr(got, k), getattr(ref, k))
         for k in ("DF_resc", "DF_upd", "z_new", "z_pred", "err0")},
        {"err3": (got.err3, ref.err3)},
    )
    conv_same = bool(torch.equal(got.conv, ref.conv))
    niter_same = bool(torch.equal(got.niter, ref.niter))
    # predict's outputs round as the plain stage's (held bit for bit at float32)
    bitwise = all(bool(torch.equal(getattr(got, k), getattr(ref, k)))
                  for k in ("DF_resc", "z_pred"))
    shape = f"{kind} nz={nz} n={n} B={B}" + (" float32" if f32 else "")
    log(
        f"[split-kernels-vs-plain attempt {shape}] "
        f"{'LV sensitivity block' if kind == 'staged_sensitivity' else f'SIR R={R}'} "
        f"KAB={p_max + 3} "
        f"{fmt_predict(nz, B)} {fmt_sweep(nz, B)} finish: {sp.finish_geometry(nz, B)} "
        + " ".join(f"rel_{k}={v:.3e}" for k, v in rel.items())
        + f" conv_equal={conv_same} niter_equal={niter_same} DF_resc_z_pred_bitwise={bitwise}"
        f" converged={int(got.conv.sum())}/{B}"
        f" niter_hist={torch.bincount(got.niter.long(), minlength=5).tolist()}"
    )
    if not (max(rel.values()) <= rel_bound and conv_same and niter_same
            and (bitwise or not f32)):
        raise SystemExit(f"chip_smoke: the split attempt's kernels disagree with the plain "
                         f"stages ({shape})")

    stage_in = (x["DF"], x["p"], x["pre_factor"], x["h"], x["z_prev"], x["atol_z"], x["rtol_z"])
    pred_k, pred = kernels.predict(*stage_in), sp.split_predict(*stage_in, p_max)
    errs = {"predict": split_errors(
        {k: (getattr(pred_k, k), getattr(pred, k)) for k in ("DF_resc", "z_pred", "f_ex", "w_z")},
        {"c_A": (pred_k.c_A, pred.c_A)},
    )}
    same = {"predict": bool(torch.equal(pred_k.pred_ok, pred.pred_ok))}
    y, state = pred.z_pred[:n], sp.sweep_start(x["active"], x["DF"].dtype)
    sweep_rel, sweep_abs, same["sweep"] = {}, 0.0, True
    for k in range(FUNCTIONAL_MAXITER):
        fz_k = fz(x["t_new"], y, x["params"])
        y_k, st_k = kernels.sweep(k, fz_k, y, pred, state, x["newton_tol"], n)
        y, state = sp.split_sweep(k, fz_k, y, pred, state, x["newton_tol"], n)
        # dy_old stays inf in lanes that never swept (inactive ones)
        swept = torch.isfinite(state.dy_old)
        r, a = split_errors({f"y_next@{k}": (y_k, y)},
                            {f"dy_old@{k}": (st_k.dy_old[swept], state.dy_old[swept])})
        sweep_rel.update(r)
        sweep_abs = max(sweep_abs, a)
        same["sweep"] &= all(bool(torch.equal(getattr(st_k, f), getattr(state, f)))
                             for f in ("conv", "div", "bad", "niter"))
    errs["sweep"] = (sweep_rel, sweep_abs)
    fz_f = fz(x["t_new"], y, x["params"])
    fin_in = (fz_f, pred, state, x["p"], x["h"], x["gamma_star_abs"], x["v_err"], x["newton_tol"])
    fin_k, fin = kernels.finish(*fin_in), sp.split_finish(*fin_in, p_max)
    errs["finish"] = split_errors(
        {k: (getattr(fin_k, k), getattr(fin, k)) for k in ("DF_upd", "z_new", "err0")},
        {"err3": (fin_k.err3, fin.err3)},
    )
    same["finish"] = bool(torch.equal(fin_k.conv, fin.conv))
    torch.cuda.synchronize()
    for stage in SPLIT_STAGES:
        rel_s = errs[stage][0]
        log(f"[split-kernel-vs-plain {stage} {shape}] "
            + " ".join(f"rel_{k}={v:.3e}" for k, v in rel_s.items())
            + f" flags_equal={same[stage]}")
        if not (max(rel_s.values()) <= rel_bound and same[stage]):
            raise SystemExit(f"chip_smoke: the split {stage} kernel disagrees with its plain "
                             f"stage ({shape})")
    return dict(x=x, fz=fz, n=n, p_max=p_max, pred=pred, state=state, fin_in=fin_in, errs=errs,
                shape=shape)


def split_phase(smi, kernels, cases=SPLIT_CASES, dtype=None) -> dict:
    """Phase 3d: the three split kernels against their plain stages on the
    card at each of phase 8's shapes (:data:`SPLIT_CASES`, or ``cases``; at
    ``dtype`` float32 a float32 build, phase 10(a)); returns the
    kernel-table fields by stage, timed at the first shape, with the worst
    error over the shapes."""
    import torch

    from sunode_torch.experiments.exp_pece2d import device_us
    from sunode_torch.ops import adams_split as sp

    table, worst = {}, dict.fromkeys(SPLIT_STAGES, 0.0)
    for seed, (kind, B) in enumerate(cases, start=11):
        c = compare_split(kind, B, seed, kernels, dtype=dtype)
        for stage in SPLIT_STAGES:
            worst[stage] = max(worst[stage], c["errs"][stage][1])
        x, fz, n, p_max, pred, state, fin_in = (
            c[k] for k in ("x", "fz", "n", "p_max", "pred", "state", "fin_in"))
        # the finish's form: rows that fit one chunk (9(a)'s sensitivity
        # block) take no fill, more rows (SIR) their counters' fill
        one_chunk = sp.finish_geometry(*pred.z_pred.shape).one_chunk
        fills = finish_fills(kernels, fin_in)
        log(f"[split-finish form {c['shape']}] one_chunk={one_chunk} (finish records, records "
            f"right after a fill)={fills}")
        if fills != (1, 0 if one_chunk else 1):
            raise SystemExit(f"chip_smoke: the split finish's fill does not match its form "
                             f"({c['shape']}: {fills})")
        # per-call times on these inputs: kernel (graph, stream, device) and
        # plain at the first shape, the kernel's device time at the others
        timed = kind == cases[0][0]
        fz_1 = fz(x["t_new"], pred.z_pred[:n], x["params"])
        calls = {
            "predict": (lambda z: (kernels.predict(x["DF"], x["p"], x["pre_factor"], x["h"], z,
                                                   x["atol_z"], x["rtol_z"]).z_pred,),
                        lambda z: (sp.split_predict(x["DF"], x["p"], x["pre_factor"], x["h"], z,
                                                    x["atol_z"], x["rtol_z"],
                                                    p_max).z_pred,),
                        x["z_prev"]),
            "sweep": (lambda yy: (kernels.sweep(1, fz_1, yy, pred, state, x["newton_tol"], n)[0],),
                      lambda yy: (sp.split_sweep(1, fz_1, yy, pred, state, x["newton_tol"],
                                                 n)[0],),
                      pred.z_pred[:n].clone()),
            "finish": (lambda f: (kernels.finish(f, *fin_in[1:]).z_new,),
                       lambda f: (sp.split_finish(f, *fin_in[1:], p_max).z_new,),
                       fin_in[0]),
        }
        costs = split_costs(x, n)
        for stage, (call_k, call_p, z) in calls.items():
            nbytes, flops = costs[stage]
            b = bound(nbytes, flops, x["DF"].dtype)
            if timed:
                t_k = per_call_times(call_k, z, f"split_{stage}_kernel")
                t_p = per_call_times(call_p, z)
                table[stage] = dict(ms=t_k["stream"] / 1e3, plain_ms=t_p["stream"] / 1e3, **b)
                times = fmt_times("kernel", t_k) + fmt_times("plain", t_p)
                over = t_k["graph"] / (1e3 * b["bound_ms"])
            else:
                dev = device_us(lambda: call_k(z), kernel=f"split_{stage}_kernel")
                times = f" kernel_device_us_per_call={fmt_us(dev)}"
                over = None if dev is None else dev / (1e3 * b["bound_ms"])
            log(
                f"[split-kernel-times {stage} {c['shape']}]" + times
                + f" bytes={nbytes} flops={flops} bound_us={1e3 * b['bound_ms']:.3f}"
                f" ({b['bound_by']}) {'graph' if timed else 'device'}_over_bound="
                + ("not measured" if over is None else f"{over:.2f}") + f" | {smi}"
            )
        del c, x, pred, state, fin_in, calls, fz_1
        torch.cuda.empty_cache()
    for stage in SPLIT_STAGES:
        table.setdefault(stage, {})["max_abs_err"] = worst[stage]
    return table


class SplitLaunches:
    """The split kernels' launches, counted by stage in
    ``adams_split_attempt.launches`` (every build's), or in one build's
    ``.launches`` (``build``), as one count: read as their sum, set to a
    value in every stage (the phases' ``k.launches = 0``)."""

    def __init__(self, build=None):
        self.build = build

    def _counts(self) -> dict:
        from sunode_torch.ops.adams_split import adams_split_attempt

        return adams_split_attempt.launches if self.build is None else self.build.launches

    @property
    def launches(self) -> int:
        return sum(self._counts().values())

    @launches.setter
    def launches(self, value: int) -> None:
        self._counts().update(dict.fromkeys(SPLIT_STAGES, value))


def split_expected_launches(attempts: int) -> dict:
    """Split-kernel launches of ``attempts`` attempts: one predict, one
    sweep per corrector iteration (FUNCTIONAL_MAXITER = 4, all of them
    always) and one finish each."""
    return {"predict": attempts, "sweep": 4 * attempts, "finish": attempts}


def sir_table_bytes(mode, B) -> int:
    """Bytes of the forward recording 'hermite' keeps (1,024 slots and the
    rolling tail, quintic rows (t, y, f, fdot) of 3,000 states); 'resolve'
    keeps none."""
    return 0 if mode == "resolve" else 8 * 1025 * (1 + 3 * 3 * SIR_R) * B


def sir_phase(smi, counted) -> tuple[dict, dict]:
    """Phase 8: SIR-1000 ADAMS gradients through ``entry.build_sir``, the
    attempts on the split kernels; returns their launches by stage, and
    the 'hermite' step's outputs, inputs and each lane's accepted forward
    and backward steps (phase 17's reference)."""
    import torch

    from sunode_torch.entry import build_sir
    from sunode_torch.ops import adams_split as sp
    from sunode_torch.ops.adams_attempt import adams_history_attempt

    golden = np.load(os.path.join(HERE, "tests", "golden", "sir_1000.npz"))
    R = SIR_R
    total = dict.fromkeys(SPLIT_STAGES, 0)
    for mode, B in SIR_MODES:
        grad_step, (y0s, p_subs) = build_sir(R, B, mode, device="cuda")
        # lane 0 is the golden case's, as scripts/bench_sir_scale.py pins it
        y0s[0] = torch.as_tensor(golden["y0"], dtype=y0s.dtype)
        p_subs[0] = torch.as_tensor(golden["p0"][:2], dtype=p_subs.dtype)
        np.testing.assert_allclose(float(grad_step.p_fix[0]), golden["p0"][2], rtol=1e-6)
        stats = grad_step.solve.last_stats

        def attempts():
            return stats["forward"]["n_attempts"] + stats["backward"]["n_attempts"]

        # one step under the profiler, which is also the warm-up (as phase
        # 5's profiled solve is), over the first observation times only
        # (processing a whole step's profile takes about as long as the
        # step): device kernels per attempt, busy share and the fills right
        # before each split kernel, forward and backward
        short = grad_step.tvals[:SIR_PROFILED_TIMES]

        def profiled_step():
            p = p_subs.detach().requires_grad_(True)
            ys = grad_step.solve(0.0, y0s, p, grad_step.p_fix, short)
            torch.autograd.grad(torch.sum(ys[:, :, R:2 * R] ** 2), (p,))

        prof = device_kernels_per_attempt(profiled_step, attempts)
        for k in (*counted, SplitLaunches()):
            k.launches = 0
        sp.split_predict.calls = sp.split_sweep.calls = sp.split_finish.calls = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ys, gp = grad_step(y0s, p_subs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd, bwd = stats["forward"]["n_attempts"], stats["backward"]["n_attempts"]
        launches = dict(sp.adams_split_attempt.launches)
        plain = [sp.split_predict.calls, sp.split_sweep.calls, sp.split_finish.calls]
        fused = [k.launches for k in counted]
        expected = split_expected_launches(fwd + bwd)
        log(f"[sir {mode} launches] split {launches} expected={expected}; plain-stage calls "
            f"{plain}; fused and other kernels {fused} (history-attempt total "
            f"{adams_history_attempt.launches})")
        if launches != expected:
            raise SystemExit(f"chip_smoke: sir {mode}: split launches do not match the attempts")
        if any(plain) or any(fused):
            raise SystemExit(f"chip_smoke: sir {mode}: the path ran a plain stage or another kernel")
        for stage in SPLIT_STAGES:
            total[stage] += launches[stage]
        peak = torch.cuda.max_memory_allocated()
        log(
            f"[sir {mode} step] R={R} B={B} wall_s={wall:.4f} grads_per_s={B / wall:.1f} "
            f"attempts fwd={fwd} bwd={bwd} "
            f"host_ms_per_attempt={1e3 * wall / (fwd + bwd):.3f} "
            f"table_MB={sir_table_bytes(mode, B) / 1e6:.1f} peak_MB={peak / 1e6:.1f} | {smi}"
        )
        log(
            f"[sir {mode} device kernels per attempt] {prof['per_attempt']:.1f} "
            f"({prof['kernels']} kernels, {prof['copies']} copies and fills, "
            f"{prof['attempts']} attempts in one step to t = {float(short[-1]):g}) "
            f"device_busy_s={prof['busy_s']:.4f} "
            f"wall_s_under_profiler={prof['wall_s']:.4f} host_ms_per_attempt_under_profiler="
            f"{1e3 * prof['wall_s'] / prof['attempts']:.3f} "
            f"device_busy_share={prof['busy_s'] / prof['wall_s']:.4f} (of the profiled step, "
            f"the warm-up) | {smi}"
        )
        log(f"[sir {mode} device kernels by kind] (kind: per attempt, device ms in the step) "
            + "; ".join(f"{c}: {per:.1f}, {ms:.1f}" for c, (per, ms) in prof["by_class"].items()))
        fills = fills_before(prof["events"], [f"split_{s}_kernel" for s in SPLIT_STAGES])
        n_att = prof["attempts"]
        log(f"[sir {mode} fills] (kernel: records, records right after a memset) "
            + "; ".join(f"{k}: {n}, {f}" for k, (n, f) in fills.items())
            + f"; attempts {n_att}")
        if not split_fills_ok(fills):
            raise SystemExit(f"chip_smoke: sir {mode}: a fill ran right before a predict or a "
                             f"sweep (or the profile shows neither, or no finish's fill)")

        ys_np, gp_np = ys.cpu().numpy(), gp.cpu().numpy()
        status = stats["backward"]["status"].cpu().numpy()
        finite = int((np.isfinite(ys_np).all(axis=(1, 2)) & np.isfinite(gp_np).all(axis=1)).sum())
        if not (ys_np.shape == (B, 12, 3 * R) and gp_np.shape == (B, 2) and finite == B
                and (status == 0).all()):
            raise SystemExit(f"chip_smoke: sir {mode} failed ({finite} finite, "
                             f"{int((status == 0).sum())} with status 0, of {B})")
        np.testing.assert_allclose(ys_np[0], golden["ys"], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(gp_np[0], golden["gp"], rtol=1e-3)
        gold_rel = float(np.max(np.abs(gp_np[0] - golden["gp"]) / np.abs(golden["gp"])))
        ref = cpu_ref(ref_sir, mode, B)
        if not (np.array_equal(sir_lane_inputs(mode, B)[0][:4], y0s[:4].cpu().numpy())
                and np.array_equal(sir_lane_inputs(mode, B)[1][:4], p_subs[:4].cpu().numpy())):
            raise SystemExit(f"chip_smoke: sir {mode}: the CPU reference has other inputs")
        plain_rel = max(floored_rel(ys_np[:4], ref["ys"], 1e-10),
                        float(np.max(np.abs(gp_np[:4] - ref["gp"]) / np.abs(ref["gp"]))))
        log(
            f"[sir {mode} check] status 0 and finite in {finite}/{B} lanes; lane 0 golden "
            f"gp_rel={gold_rel:.3e} (gate 1e-3; ys rtol 1e-5 / atol 1e-7 passed) "
            f"cuda_vs_cpu_lanes_0_3_max_rel={plain_rel:.3e} (bound 1e-8, ys floored at atol "
            f"1e-10; the CPU took {ref['wall']:.2f} s for {ref['fwd']} + {ref['bwd']} attempts "
            f"in a worker process)"
        )
        if not plain_rel <= 1e-8:
            raise SystemExit(f"chip_smoke: the CUDA sir {mode} gradients disagree with the CPU")
        if mode == STATE_SPLIT_MODE:
            reference = dict(ys=ys_np, gp=gp_np, y0s=y0s, p_subs=p_subs,
                             fwd_steps=stats["forward"]["n_steps"].cpu().numpy(),
                             bwd_steps=stats["backward"]["n_backward_steps"].cpu().numpy())
        log_elapsed(f"8, {mode}")
    return total, reference


# ---- phase 17: the state axis: SIR's state rows split over devices ----------------
STATE_SPLIT_MODE, STATE_SPLIT_B = "hermite", 256  # phase 8's 'hermite' cell
STATE_SPLIT_EXACT_TIMES = 2  # 17(c): the 1x1 mesh over the first 2 observation times
STATE_SPLIT_EXACT_LANES = 64  # 17(c): on lanes 0-63 (each 'hermite' table 4.7 GB, not 18.9)
STATE_SPLIT_RTOL, STATE_SPLIT_ATOL = 1e-10, 1e-12  # 17(b): lanes whose steps equal phase 8's
STATE_SPLIT_PARTED = 1e-8  # 17(b): a lane whose steps parted: phase 8's card-against-CPU bound
ROWS_KERNELS = {"sweep_rows": "split_sweep_rows_kernel", "finish_rows": "split_finish_kernel",
                "finish_lanes": "split_finish_lanes_kernel"}


class RowsLaunches:
    """The state split's partial-norm entries' launches, counted by entry in
    ``adams_split_attempt_rows.launches``, as one count (the phases'
    ``k.launches = 0`` sets every entry)."""

    @staticmethod
    def _counts() -> dict:
        from sunode_torch.ops.adams_split import adams_split_attempt_rows

        return adams_split_attempt_rows.launches

    @property
    def launches(self) -> int:
        return sum(self._counts().values())

    @launches.setter
    def launches(self, value: int) -> None:
        self._counts().update(dict.fromkeys(self._counts(), value))


def rows_expected_launches(attempts: int, blocks: int) -> tuple[dict, dict]:
    """(split, rows) launches of ``attempts`` state-split attempts over
    ``blocks`` blocks: predict and the rows' sweeps (4 an attempt, each
    deciding the sweep before) and finish on every block, the lanes' finish
    (the last decision with it) once an attempt, the unsplit sweep and
    finish never."""
    return ({"predict": attempts * blocks, "sweep": 0, "finish": 0},
            {"sweep_rows": 4 * attempts * blocks, "finish_rows": attempts * blocks,
             "finish_lanes": attempts})


def rows_costs(KAB: int, nz: int, n: int, B: int, n_gamma: int, w: int = 8,
               blocks: int = 2) -> dict:
    """{entry: (bytes, operations)} of the three entries on one block of
    ``nz`` rows (``n`` state rows) of a split into ``blocks`` blocks of
    ``sweep_geometry(nz, B)``'s ranks each, ``split_costs``' rule: each
    input read once and each output written once, ``w`` bytes a floating
    value.  The rows' sweep and the lanes' finish read every block's
    partials of the sweep before (a value and a flag a rank and lane) and
    the state (conv, div, bad, dy_old, niter), and decide: the rows' sweep
    writes its ranks' partials and the decided state."""
    from sunode_torch.ops.adams_split import sweep_geometry

    hist = w * KAB * nz * B
    ranks = sweep_geometry(nz, B, w).cluster
    state = B * (3 + w + 4)
    pending = (w + 1) * B * ranks * blocks
    decide = B * (ranks * blocks + 12)  # the partials' adds, the rate tests
    return {
        "sweep_rows": (w * nz * B + w * 4 * n * B + w * n * B + B * w + state + pending
                       + (w + 1) * B * ranks + state, 9 * n * B + nz * B + decide),
        "finish_rows": (2 * hist + w * nz * B * 4 + w * nz * B * 2 + B * (w + 4 + w) + w * nz
                        + w * n_gamma + 3 * w * B, nz * B * (3 * KAB + 20)),
        "finish_lanes": (3 * w * B + state + B + pending + B * (3 * w + 1 + 4),
                         6 * B + decide),
    }


def state_split_kernels(smi, kernels) -> dict:
    """17(a): the three partial-norm entries against their plain versions at
    phase 8's 'hermite' backward shape (nz = 3,002, n = 3,000, B=256) cut in
    two blocks on the card (1,502 rows on the home block: 1,500 state rows
    and the 2 quadratures; 1,500 on the other), one attempt's four rows'
    sweeps (the home block's f read in place) and finish on phase 3d's
    seeded inputs, the plain outputs feeding the next stage of both.  Each
    rows' sweep decides the sweep before on the plain partials, and the
    home block's again on the kernel's own; the lanes' finish decides the
    last on both.  Then each is timed on the home block on the kernel's own
    partials (its ranks of every block), as the path gives them.  Returns
    the kernel-table fields by entry."""
    import torch

    from sunode_torch.ops import adams_split as sp
    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER
    from sunode_torch.parallel.rows import RowBlocks, RowLayout, lane_all, lane_sum, scatter

    x = split_inputs(STATE_SPLIT_B, 31, "cuda", SIR_R, "staged_adjoint")
    fz, n, nz = split_system("staged_adjoint")
    p_max, B, tol = x["DF"].shape[0] - 3, STATE_SPLIT_B, x["newton_tol"]
    dev = torch.device("cuda", 0)
    L = RowLayout.contiguous((dev, dev), (n // 2, n - n // 2)).with_rows(nz - n)
    n_d = L.state_rows(n)
    col = {k: scatter(L, x[k][:, None]).blocks for k in ("atol_z", "rtol_z", "v_err")}
    DF, z_prev = scatter(L, x["DF"]).blocks, scatter(L, x["z_prev"]).blocks
    preds = [sp.split_predict(D, x["p"], x["pre_factor"], x["h"], z, a[:, 0], r[:, 0], p_max)
             for D, z, a, r in zip(DF, z_prev, col["atol_z"], col["rtol_z"])]
    pred_ok = lane_all([pr.pred_ok for pr in preds], dev)
    y = [pr.z_pred[:m] for pr, m in zip(preds, n_d)]
    state = sp.sweep_start(x["active"], x["DF"].dtype)
    worst = dict.fromkeys(ROWS_KERNELS, 0.0)
    exact = dict.fromkeys(ROWS_KERNELS, True)
    ss_rel, pending, own, timed = 0.0, None, None, None

    def bits(a, b):
        return bool(torch.equal(a, b))

    def decided(a, b):
        return all(bits(u, v) for u, v in zip(a, b))

    home = {"rows": L.segments[0]}
    for k in range(FUNCTIONAL_MAXITER):
        f_all = fz(x["t_new"], RowBlocks(L, y).gather(), x["params"])
        f_b = scatter(L, f_all).blocks
        if k == 1:  # sweep 1's inputs, the kernel's own partials of sweep 0 pending
            timed = (f_all, state, own)
        outs, mine = [], []
        for d, (yy, pr, m) in enumerate(zip(y, preds, n_d)):
            f, where = (f_all, home) if d == 0 else (f_b[d], {})
            got, st = kernels.sweep_rows(f, yy, pr, state, m, pending, decide=d == 0, **where)
            ref, st_p = sp.split_sweep_rows(f, yy, pr, state, m, pending, **where)
            exact["sweep_rows"] &= (bits(got.y_next, ref.y_next)
                                    and bits(got.nonfinite.any(dim=0), ref.nonfinite[0])
                                    and (d != 0 or decided(st, st_p)))
            if d == 0 and own is not None:  # the kernel's own partials, decided by both
                exact["sweep_rows"] &= decided(
                    kernels.sweep_rows(f, yy, pr, state, m, own, **where)[1],
                    sp.split_sweep_rows(f, yy, pr, state, m, own, **where)[1])
            # each lane's sum over the block's rows adds in the kernel's order (as the sweep's)
            ss = sp.pending_sums(sp.Pending(k, (got.ss,), (got.nonfinite,), tol, n), dev)[0]
            ss_rel = max(ss_rel, lane_rel(ss, ref.ss[0]))
            worst["sweep_rows"] = max(worst["sweep_rows"], float((ss - ref.ss[0]).abs().max()))
            outs.append((ref, st_p))
            mine.append(got)
        state = outs[0][1]
        pending = sp.Pending(k, tuple(o.ss for o, _ in outs),
                             tuple(o.nonfinite for o, _ in outs), tol, n)
        own = sp.Pending(k, tuple(o.ss for o in mine), tuple(o.nonfinite for o in mine), tol, n)
        y = [o.y_next for o, _ in outs]
    f_b = scatter(L, fz(x["t_new"], RowBlocks(L, y).gather(), x["params"])).blocks
    g = x["gamma_star_abs"]
    fins, ss3_rel = [], 0.0
    for f, pr, v in zip(f_b, preds, col["v_err"]):
        got = kernels.finish_rows(f, pr, x["p"], x["h"], g, v[:, 0])
        ref = sp.split_finish_rows(f, pr, x["p"], x["h"], g, v[:, 0], p_max)
        exact["finish_rows"] &= all(bits(getattr(got, k), getattr(ref, k))
                                    for k in ("DF_upd", "z_new", "err0"))
        ss3_rel = max(ss3_rel, lane_rel(got.ss3, ref.ss3))
        worst["finish_rows"] = max(worst["finish_rows"], float((got.ss3 - ref.ss3).abs().max()))
        fins.append(ref)
    ss3 = lane_sum([f.ss3 for f in fins], dev)
    for pend in (pending, own):
        got = kernels.finish_lanes(ss3, pred_ok, state, tol, pend)
        ref = sp.split_finish_lanes(ss3, pred_ok, state, tol, pend)
        exact["finish_lanes"] &= all(bits(a, b) for a, b in zip(got, ref))
    torch.cuda.synchronize()
    shape = f"staged_adjoint nz={nz} n={n} B={B} blocks={L.sizes} state_rows={n_d}"
    log(f"[17(a) partial-norm entries vs plain {shape}] bit for bit (the rows' y_next and "
        f"flags, the decided state on the plain and on the kernel's partials, DF_upd, z_new, "
        f"err0; the roots, conv and niter on the same sums): {exact}; each lane's sums over a "
        f"block's rows in the kernel's order: ss max_rel={ss_rel:.3e}, ss3 max_rel="
        f"{ss3_rel:.3e} (bound {REL_BOUND:g}); converged={int(ref[1].sum())}/{B} "
        f"niter_hist={torch.bincount(ref[2].long(), minlength=5).tolist()}")
    if not (all(exact.values()) and max(ss_rel, ss3_rel) <= REL_BOUND):
        raise SystemExit(f"chip_smoke: 17(a): a partial-norm entry disagrees with its plain "
                         f"version ({shape})")

    # times on the home block on the kernel's own partials, as the path gives
    # them (sweep 1's inputs; the lanes' finish on the last sweep's), each
    # call's output feeding the next (graph)
    pr, f0, v0 = preds[0], f_b[0], col["v_err"][0][:, 0]
    f_t, st_t, pend_t = timed
    calls = {
        "sweep_rows": (lambda yy: (kernels.sweep_rows(f_t, yy, pr, st_t, n_d[0], pend_t,
                                                      **home)[0].y_next,),
                       lambda yy: (sp.split_sweep_rows(f_t, yy, pr, st_t, n_d[0], pend_t,
                                                       **home)[0].y_next,),
                       y[0].clone()),
        "finish_rows": (lambda f: (kernels.finish_rows(f, pr, x["p"], x["h"], g, v0).z_new,),
                        lambda f: (sp.split_finish_rows(f, pr, x["p"], x["h"], g, v0,
                                                        p_max).z_new,),
                        f0),
        "finish_lanes": (lambda s: (kernels.finish_lanes(s, pred_ok, state, tol, own)[0],),
                         lambda s: (sp.split_finish_lanes(s, pred_ok, state, tol, own)[0],),
                         ss3.clone()),
    }
    costs = rows_costs(p_max + 3, L.sizes[0], n_d[0], B, g.numel(), blocks=len(n_d))
    table = {}
    for entry, (call_k, call_p, z) in calls.items():
        nbytes, flops = costs[entry]
        b = bound(nbytes, flops)
        t_k = per_call_times(call_k, z, ROWS_KERNELS[entry])
        t_p = per_call_times(call_p, z)
        table[entry] = dict(ms=t_k["stream"] / 1e3, plain_ms=t_p["stream"] / 1e3,
                            max_abs_err=worst[entry], **b)
        over = None if t_k["device"] is None else t_k["device"] / (1e3 * b["bound_ms"])
        log(f"[17(a) times {entry} home block ({L.sizes[0]} rows, {n_d[0]} state rows, B={B})]"
            + fmt_times("kernel", t_k) + fmt_times("plain", t_p)
            + f" bytes={nbytes} flops={flops} bound_us={1e3 * b['bound_ms']:.3f} ({b['bound_by']})"
            f" device_over_bound=" + ("not measured" if over is None else f"{over:.2f}")
            + f" | {smi}")
    del x, preds, DF, z_prev, f_b, fins, calls
    torch.cuda.empty_cache()
    return table


def state_split_phase(smi, counted, reference) -> dict:
    """17(b), (c): SIR-1000 'hermite' at B=256 with each chain's 3,000 state
    rows split over a 1x2 mesh of the one card (``entry.build_sir_state_split``)
    against phase 8's outputs (``reference``: ys, gp, y0s, p_subs and the
    lanes' accepted forward and backward steps), then a 1x1 mesh bit for bit
    the unsplit solve over the first 2 observation times.  ``counted`` are
    every other kernel's counts.  Returns the launches of the three entries
    and of predict."""
    import torch

    from sunode_torch.entry import build_sir, build_sir_state_split
    from sunode_torch.ops import adams_split as sp
    from sunode_torch.parallel import rows
    from sunode_torch.parallel.mesh import Mesh, shard_batch_state

    R, B, mode = SIR_R, STATE_SPLIT_B, STATE_SPLIT_MODE
    golden = np.load(os.path.join(HERE, "tests", "golden", "sir_1000.npz"))
    dev = torch.device("cuda", 0)
    mesh = Mesh(((dev, dev),), ("chains", "state"))
    grad_step, _ = build_sir_state_split(R, B, mode, mesh)
    y0s, p_subs = reference["y0s"], reference["p_subs"]
    stats = grad_step.solve.last_stats
    split_count, rows_count = SplitLaunches(), RowsLaunches()
    for k in (*counted, split_count, rows_count):
        k.launches = 0
    for k in rows.traffic:
        rows.traffic[k] = 0
    plain_before = [f.calls for f in (sp.split_predict, sp.split_sweep, sp.split_finish,
                                      sp.split_sweep_rows, sp.split_sweep_decide,
                                      sp.split_finish_rows, sp.split_finish_lanes)]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ys, gp = grad_step(y0s, p_subs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = stats["forward"]["n_attempts"], stats["backward"]["n_attempts"]
    peak = torch.cuda.max_memory_allocated()
    traffic = dict(rows.traffic)
    plain = [f.calls - c for f, c in zip((sp.split_predict, sp.split_sweep, sp.split_finish,
                                          sp.split_sweep_rows, sp.split_sweep_decide,
                                          sp.split_finish_rows, sp.split_finish_lanes),
                                         plain_before)]
    split_l = dict(sp.adams_split_attempt.launches)
    rows_l = dict(sp.adams_split_attempt_rows.launches)
    others = [k.launches for k in counted]
    exp_split, exp_rows = rows_expected_launches(fwd + bwd, 2)
    log(f"[17(b) launches] split {split_l} expected {exp_split}; partial-norm entries {rows_l} "
        f"expected {exp_rows}; plain-stage calls {plain}; other kernels {others}")
    if split_l != exp_split or rows_l != exp_rows:
        raise SystemExit("chip_smoke: 17(b): the state split's launches do not match its attempts")
    if any(plain) or any(others):
        raise SystemExit("chip_smoke: 17(b): the state split ran a plain stage or another kernel")

    nz_b = (R * 3 // 2 + SIR_DERIVS, R * 3 // 2)  # the backward's blocks (the forward's: 1,500 each)
    hist_b = [8 * (P_MAX_ADAMS + 3) * m * B for m in nz_b]
    table_b = [8 * 1025 * (1 + 3 * (3 * R // 2)) * B] * 2
    att = fwd + bwd
    log(f"[17(b) step] R={R} B={B} mesh=1x2 (one card twice) wall_s={wall:.4f} attempts "
        f"fwd={fwd} bwd={bwd} host_ms_per_attempt={1e3 * wall / att:.3f} "
        f"block_bytes: backward history {hist_b}, recording table {table_b} "
        f"(phase 8's whole table {sir_table_bytes(mode, B)}); peak_MB={peak / 1e6:.1f}; "
        f"off-home bytes a step {traffic} = gather {traffic['gather'] / att:.0f}, scatter "
        f"{traffic['scatter'] / att:.0f}, lanes {traffic['lanes'] / att:.0f} an attempt | {smi}")

    ys_np, gp_np = ys.cpu().numpy(), gp.cpu().numpy()
    status = stats["backward"]["status"].cpu().numpy()
    finite = int((np.isfinite(ys_np).all(axis=(1, 2)) & np.isfinite(gp_np).all(axis=1)).sum())
    if not (ys_np.shape == (B, 12, 3 * R) and finite == B and (status == 0).all()):
        raise SystemExit(f"chip_smoke: 17(b) failed ({finite} finite, "
                         f"{int((status == 0).sum())} with status 0, of {B})")
    np.testing.assert_allclose(ys_np[0], golden["ys"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gp_np[0], golden["gp"], rtol=1e-3)
    same = ((stats["forward"]["n_steps"].cpu().numpy() == reference["fwd_steps"])
            & (stats["backward"]["n_backward_steps"].cpu().numpy() == reference["bwd_steps"]))
    ys_ref, gp_ref = reference["ys"], reference["gp"]

    def lane_err(sel, rtol, atol):
        """max over the lanes ``sel`` of |a - b| / (atol + rtol |b|), ys and gp."""
        if not sel.any():
            return 0.0
        return max(float(np.max(np.abs(a[sel] - b[sel]) / (atol + rtol * np.abs(b[sel]))))
                   for a, b in ((ys_np, ys_ref), (gp_np, gp_ref)))

    err_same = lane_err(same, STATE_SPLIT_RTOL, STATE_SPLIT_ATOL)
    rel_parted = max([floored_rel(ys_np[~same], ys_ref[~same], 1e-10),
                      float(np.max(np.abs(gp_np[~same] - gp_ref[~same]) / np.abs(gp_ref[~same])))]
                     if (~same).any() else [0.0])
    bit_lanes = int(((ys_np == ys_ref).all(axis=(1, 2)) & (gp_np == gp_ref).all(axis=1)).sum())
    log(f"[17(b) check] status 0 and finite in {finite}/{B}; lane 0 inside sir_1000.npz's gate; "
        f"{int(same.sum())}/{B} lanes with phase 8's accepted steps, there the worst "
        f"|a - b| / ({STATE_SPLIT_ATOL:g} + {STATE_SPLIT_RTOL:g} |b|) = {err_same:.3e} (gate 1); "
        f"{int((~same).sum())} lanes parted on a norm's last bit, max_rel={rel_parted:.3e} "
        f"(bound {STATE_SPLIT_PARTED:g}, ys floored at atol 1e-10); {bit_lanes} lanes bit for bit")
    if not (err_same <= 1.0 and rel_parted <= STATE_SPLIT_PARTED):
        raise SystemExit("chip_smoke: 17(b): the state split disagrees with phase 8's solve")
    launches = {**{k: v for k, v in split_l.items() if k == "predict"}, **rows_l}
    log_elapsed("17b")

    # (c) one block: bit for bit the unsplit solve, the same kernels' rows
    # summed in the same order and one root of the same sum
    del ys, gp
    torch.cuda.empty_cache()
    tv = grad_step.tvals[:STATE_SPLIT_EXACT_TIMES]
    lanes = slice(0, STATE_SPLIT_EXACT_LANES)
    unsplit, _ = build_sir(R, STATE_SPLIT_EXACT_LANES, mode, device="cuda")
    one = Mesh(((dev,),), ("chains", "state"))
    outs = []
    for solve, y0 in ((unsplit.solve, y0s[lanes]),
                      (grad_step.solve, shard_batch_state(one, y0s[lanes]))):
        p = p_subs[lanes].detach().requires_grad_(True)
        y_c = solve(0.0, y0, p, grad_step.p_fix, tv)
        (g_c,) = torch.autograd.grad(torch.sum(y_c[:, :, R:2 * R] ** 2), (p,))
        outs.append((y_c.detach(), g_c, solve.last_stats["backward"]["n_attempts"]))
    exact = bool(torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1]))
    log(f"[17(c) one block] 1x1 mesh over t <= {float(tv[-1]):g} on lanes 0-"
        f"{STATE_SPLIT_EXACT_LANES - 1}: ys and gradient bit for bit "
        f"the unsplit solve: {exact} (backward attempts {outs[0][2]} / {outs[1][2]})")
    if not exact:
        raise SystemExit("chip_smoke: 17(c): one block is not bit for bit the unsplit solve")
    log_elapsed("17")
    return launches


def pece_2d_phase(smi):
    """Phase 3b: the flat-history kernel against its plain version and the
    PECE kernel, then the A/B; returns the kernel-table entry."""
    import torch

    from sunode_torch.experiments import exp_pece2d
    from sunode_torch.ops.pece_2d import P_ORDER, lv_system, build_pece_2d, pece_2d_attempt
    from sunode_torch.ops.pece_step import FUNCTIONAL_ITERS

    B = B_2D[0]
    x = exp_pece2d.make_inputs(B, "cuda")
    fns = exp_pece2d.arms(x)
    outs = {arm: fn(x["y_prev"]) for arm, fn in fns.items()}
    torch.cuda.synchronize()
    rel_p, abs_p = exp_pece2d.parity(outs["kernel2"], outs["plain"])
    rel_1, abs_1 = exp_pece2d.parity(outs["kernel2"], outs["kernel1"])
    log(f"[pece2d-vs-plain] B={B} p={P_ORDER} rel_vs_plain={rel_p:.3e} abs={abs_p:.3e} "
        f"rel_vs_kernel1={rel_1:.3e} abs={abs_1:.3e}")
    if not (rel_p <= REL_BOUND and rel_1 <= REL_BOUND):
        raise SystemExit("chip_smoke: the flat-history kernel disagrees")

    pece_2d_attempt.launches = 0
    build_pece_2d(P_ORDER).launches = 0
    rows = exp_pece2d.run(B_2D, "cuda", log=lambda m: log(f"{m} | {smi}"))
    launches = pece_2d_attempt.launches
    log(f"[pece2d A/B launches] {launches}")
    if not (launches > 0 and launches == build_pece_2d(P_ORDER).launches):
        raise SystemExit("chip_smoke: the A/B did not launch the flat-history kernel")

    at = {r["arm"]: r for r in rows if r["B"] == B}
    _, system, n, n_p = lv_system()
    nbytes = exp_pece2d.bytes_moved("kernel2", B, n, n_p)
    flops = B * (3 * P_ORDER * n + 2 * n + 1
                 + (FUNCTIONAL_ITERS + 1) * rhs_flops(system) + FUNCTIONAL_ITERS * 3 * n
                 + 2 * n + 1)
    return dict(
        launches=launches, max_abs_err=abs_p,
        ms=at["kernel2"]["stream_us"] / 1e3, plain_ms=at["plain"]["stream_us"] / 1e3,
        **bound(nbytes, flops),
    )


def kernel_class(name: str) -> str:
    """A device kernel's kind, from its name: copy, matmul, LU (the batched
    factorisation and triangular solves), reduction, element-wise, other."""
    low = name.lower()
    for cls, keys in (("copy", ("memcpy", "memset")), ("matmul", ("gemm",)),
                      ("LU", ("getrf", "getrs", "trsm", "lu_", "pivot", "laswp")),
                      ("reduction", ("reduce",)), ("element-wise", ("elementwise",))):
        if any(k in low for k in keys):
            return cls
    return "other"


def _raw_device_events(prof):
    """(name, µs) of every device record of a finished profile, in the order
    they started, read from the profiler's raw records (``kineto_results``,
    not a public API): building its Python event tree takes minutes for the
    millions of kernels of a checkpointed gradient step.  Raises if this
    torch lacks them."""
    from torch.autograd import DeviceType

    results = getattr(prof.profiler, "kineto_results", None)
    if results is None or not hasattr(results, "events"):
        raise SystemExit("chip_smoke: this torch's profiler has no kineto_results.events()")
    records = sorted((e.start_ns(), e.name(), e.duration_ns() / 1e3) for e in results.events()
                     if e.device_type() == DeviceType.CUDA)
    return [(name, us) for _, name, us in records]


def fills_before(events, kernels) -> dict:
    """{kernel: (records, records right after a fill)}: for each name in
    ``kernels`` (a part of a kernel's name, as the profiler spells it: a
    template's begins with its return type), its device records in
    ``events`` (:func:`_raw_device_events`) and how many of them follow a
    memset directly, as a launcher's fill of its scratch does (the split
    finish zeroes a counter per lane tile before each launch)."""
    out = {k: [0, 0] for k in kernels}
    for prev, (name, _) in zip([("", 0.0)] + events, events):
        for k in kernels:
            if k in name:
                out[k][0] += 1
                out[k][1] += prev[0].startswith("Memset")
    return {k: tuple(v) for k, v in out.items()}


def finish_fills(kernels, fin_in, tries: int = 3) -> tuple[int, int]:
    """(records, records right after a fill) of the split finish kernel in a
    profile of one ``kernels.finish(*fin_in)`` (:func:`fills_before`): the
    multi-chunk form's launcher zeroes its tile counters first, the one-chunk
    form takes no fill.  Each session opens with ``exp_pece2d.LEAD_FILLS``
    one-element fills (kernels, not memsets), as the profiler may drop a
    session's first records, and is taken again, up to ``tries`` times, until
    it holds the finish's record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sunode_torch.experiments.exp_pece2d import LEAD_FILLS

    lead = torch.zeros(1, dtype=torch.int16, device="cuda")
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_FILLS):
                lead.fill_(1)
            kernels.finish(*fin_in)
            torch.cuda.synchronize()
        fills = fills_before(_raw_device_events(prof), ["split_finish_kernel"])
        if fills["split_finish_kernel"][0]:
            break
    return fills["split_finish_kernel"]


def split_fills_ok(fills) -> bool:
    """Phase 8's check of :func:`fills_before`'s counts of the split
    kernels: predict and the sweep ran and no fill ran right before either
    (their sums over the rows go through the cluster, with no scratch),
    while the finish's fills are seen (its launcher still zeroes a counter
    per lane tile)."""
    predict, sweep, finish = (fills[f"split_{s}_kernel"] for s in SPLIT_STAGES)
    return predict[0] > 0 and sweep[0] > 0 and predict[1] == 0 and sweep[1] == 0 and finish[1] > 0


def _count(names) -> tuple[int, int]:
    """(kernels, copies and fills) among device record names."""
    copies = sum(1 for n in names if n.startswith(("Memcpy", "Memset")))
    return len(names) - copies, copies


def device_kernels_per_attempt(run, attempts, cross_check=False) -> dict:
    """``run()`` once under the profiler: the device kernels it ran (and its
    copies and fills, counted apart) per attempt, ``attempts()`` read after
    the run, and its device-busy time against its wall time under the
    profiler.  With ``cross_check`` the public ``prof.events()`` counts the
    same run too, and the two counts must agree."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t_read = time.perf_counter()
    attempts = attempts()
    events = _raw_device_events(prof)
    kernels, copies = _count([name for name, _ in events])
    public = None
    if cross_check:
        public = _count([e.name for e in prof.events() if e.device_type == DeviceType.CUDA])
        if public != (kernels, copies):
            raise SystemExit(f"chip_smoke: the profiler's raw records count {(kernels, copies)} "
                             f"device kernels and copies, prof.events() {public}")
    log(f"[profile] {len(events)} device records read in {time.perf_counter() - t_read:.1f} s "
        f"after a run of {wall:.1f} s{' (and prof.events())' if cross_check else ''}")
    busy_us = 0.0
    by_class: dict[str, list] = {}
    for name, us in events:
        busy_us += us
        entry = by_class.setdefault(kernel_class(name), [0, 0.0])
        entry[0] += 1
        entry[1] += us
    return dict(attempts=attempts, kernels=kernels, copies=copies, public=public, events=events,
                per_attempt=kernels / attempts, busy_s=busy_us / 1e6, wall_s=wall,
                by_class={c: (n / attempts, us / 1e3) for c, (n, us) in
                          sorted(by_class.items(), key=lambda kv: -kv[1][1])})


def floored_rel(got, ref, atol) -> float:
    """max |got - ref| / (|ref| + atol), floored at the solver's atol."""
    return float(np.max(np.abs(got - ref) / (np.abs(ref) + atol)))


def lv_main_inputs():
    """Phases 4 and 6's inputs: bench.py's lv_adjoint spread (5%,
    ``default_rng(42)``); lanes 0-15 are tests/golden/lv_adjoint.npz's."""
    rng = np.random.default_rng(42)
    y0s = np.array([10.0, 2.0]) * (1 + 0.05 * rng.standard_normal((B_MAIN, 2)))
    p_subs = np.array([1.0, 0.3]) * (1 + 0.05 * rng.standard_normal((B_MAIN, 2)))
    return y0s, p_subs


def max_rel(got, ref) -> float:
    return max(float(np.max(np.abs(a - b) / np.abs(b))) for a, b in zip(got, ref))


PROFILED_HORIZON = 0.1  # phase 9(b)'s profiled solves: this share of the horizon, t <= 1 of [0, 10]
MAIN_PROFILED_SHARE = 0.25  # phase 4's profiled step: t <= 2.35 of [1, 10], 4 of its 21 times


def leading_times(tvals, share):
    """The observation times up to ``share`` of the last one: the same
    spacing over a shorter horizon."""
    return tvals[tvals <= share * float(tvals[-1])]


def checkpointed_phase(smi) -> None:
    """Phase 6: the reference's default call (BDF, checkpointed adjoint)."""
    import torch

    from sunode_torch.entry import build_lv_checkpointed

    y0s, p_subs = lv_main_inputs()
    f64 = dict(dtype=torch.float64, device="cuda")
    y0s_t, p_subs_t = torch.as_tensor(y0s, **f64), torch.as_tensor(p_subs, **f64)
    golden = np.load(os.path.join(HERE, "tests", "golden", "lv_adjoint.npz"))
    grad_step, _ = build_lv_checkpointed(B_MAIN, 21, 1e-8, device="cuda")
    stats = grad_step.solve.last_stats
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gy, gp = grad_step(y0s_t, p_subs_t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = stats["forward"]["n_attempts"], stats["backward"]["n_attempts"]
    status = stats["backward"]["status"].cpu().numpy()
    bwd_steps = stats["backward"]["n_backward_steps"].cpu().numpy()
    n_state, W = 2, 2 + 3 * 2  # quintic rows: t, y, f, fdot, L
    log(
        f"[checkpointed step] B={B_MAIN} wall_s={wall:.4f} grads_per_s={B_MAIN / wall:.1f} "
        f"attempts fwd={fwd} bwd={bwd} host_ms_per_attempt={1e3 * wall / (fwd + bwd):.3f} "
        f"thinning_levels={stats['forward']['checkpoint_thinning_levels']} "
        f"n_backward_steps min/median/max={bwd_steps.min()}/{int(np.median(bwd_steps))}/"
        f"{bwd_steps.max()} table_MB={1025 * W * B_MAIN * 8 / 1e6:.1f} "
        f"peak_MB={torch.cuda.max_memory_allocated() / 1e6:.1f} | {smi}"
    )
    # no profiled step: phases 10 and 11 took its time (PERF.md §4)
    log_elapsed("6, the timed step")

    gy_np, gp_np = gy.cpu().numpy(), gp.cpu().numpy()
    finite = int((np.isfinite(gy_np).all(axis=1) & np.isfinite(gp_np).all(axis=1)).sum())
    if not (gy_np.shape == gp_np.shape == (B_MAIN, n_state) and finite == B_MAIN
            and (status == 0).all()):
        raise SystemExit(f"chip_smoke: checkpointed gradients failed ({finite} finite, "
                         f"{int((status == 0).sum())} with status 0, of {B_MAIN})")
    np.testing.assert_allclose(gy_np[:16], golden["gy"], rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(gp_np[:16], golden["gp"], rtol=2e-3, atol=1e-3)
    gold_rel = max_rel((gy_np[:16], gp_np[:16]), (golden["gy"], golden["gp"]))
    rels = {}
    for interpolation in ("hermite", "polynomial"):
        # hermite: the full-width step's lanes 0-15 against the CPU and the
        # golden file; 'polynomial': 16 lanes on the card over the first
        # POLY_TIMES observation times against the CPU
        out = {"cuda": [gy_np[:16], gp_np[:16]]} if interpolation == "hermite" else {}
        if "cuda" not in out:
            t0 = time.perf_counter()
            step, _ = build_lv_checkpointed(16, 21, 1e-8, interpolation, device="cuda")
            f64 = dict(dtype=torch.float64, device="cuda")
            grads = step(torch.as_tensor(y0s[:16], **f64), torch.as_tensor(p_subs[:16], **f64),
                         step.tvals[:POLY_TIMES])
            out["cuda"] = [a.cpu().numpy() for a in grads]
            log(f"[checkpointed {interpolation} 16 lanes on cuda, t <= "
                f"{float(step.tvals[POLY_TIMES - 1])}] "
                f"wall_s={time.perf_counter() - t0:.2f} attempts fwd="
                f"{step.solve.last_stats['forward']['n_attempts']} "
                f"bwd={step.solve.last_stats['backward']['n_attempts']}")
        ref = cpu_ref(ref_checkpointed, interpolation)
        out["cpu"] = ref["grads"]
        log(f"[checkpointed {interpolation} 16 lanes on cpu] wall_s={ref['wall']:.2f} "
            f"attempts fwd={ref['fwd']} bwd={ref['bwd']} (a worker process)")
        if interpolation == "hermite":
            np.testing.assert_allclose(out["cuda"][0], golden["gy"], rtol=2e-3, atol=1e-3)
            np.testing.assert_allclose(out["cuda"][1], golden["gp"], rtol=2e-3, atol=1e-3)
        rels[interpolation] = max_rel(out["cuda"], out["cpu"])
    log(
        f"[checkpointed check] status 0 and finite in {finite}/{B_MAIN} lanes; "
        f"golden_max_rel={gold_rel:.3e} (gate 2e-3) cuda_vs_cpu_plain_max_rel "
        f"hermite={rels['hermite']:.3e} polynomial={rels['polynomial']:.3e} (bound 1e-6)"
    )
    if not max(rels.values()) <= 1e-6:
        raise SystemExit("chip_smoke: the CUDA checkpointed adjoint disagrees with the plain path")


def adams_table_bytes(mode, B) -> int:
    """Bytes of the forward recording a mode keeps for its backward: 384
    slots and the rolling tail, rows (t, y, f, fdot) for 'hermite', (t, y,
    f) for 'polynomial' (hermite_order 3), none for 'resolve'."""
    from sunode_torch.entry import LV_ADAMS_CHECKPOINTS

    n = 2
    W = {"resolve": 0, "hermite": 1 + 3 * n, "polynomial": 1 + 2 * n}[mode]
    return 8 * (LV_ADAMS_CHECKPOINTS + 1) * W * B


def adams_expected_launches(mode, fwd, bwd) -> dict:
    """History-attempt launches per system that one gradient step of
    ``mode`` must make: each forward attempt on the forward build, each
    backward attempt on the mode's backward build."""
    back = "resolve" if mode == "resolve" else "staged_adjoint"
    return {"forward": fwd, back: bwd}


def adams_modes_phase(smi, counted, history_kernels) -> dict:
    """Phase 7: LV gradients through 'resolve', 'hermite' and 'polynomial'.
    ``history_kernels`` are the history-attempt builds at this phase's depth
    by system; returns their launches over the three timed steps."""
    import torch

    from sunode_torch.ops.adams_attempt import adams_history_attempt

    y0s, p_subs = lv_main_inputs()
    f64 = dict(dtype=torch.float64, device="cuda")
    y0s_t, p_subs_t = torch.as_tensor(y0s, **f64), torch.as_tensor(p_subs, **f64)
    golden = np.load(os.path.join(HERE, "tests", "golden", "lv_adjoint.npz"))
    total = {kind: 0 for kind in history_kernels}
    for mode in ADAMS_MODES:
        from sunode_torch.entry import build_lv_adams

        grad_step, _ = build_lv_adams(B_MAIN, 21, ADAMS_RTOL, mode, device="cuda")
        stats = grad_step.solve.last_stats
        for k in counted:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gy, gp = grad_step(y0s_t, p_subs_t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd, bwd = stats["forward"]["n_attempts"], stats["backward"]["n_attempts"]
        launches = check_launches(f"adams {mode}", counted, history_kernels,
                                  adams_expected_launches(mode, fwd, bwd))
        for kind, count in launches.items():
            total[kind] += count
        status = stats["backward"]["status"].cpu().numpy()
        bwd_steps = stats["backward"]["n_backward_steps"].cpu().numpy()
        levels = stats["forward"].get("checkpoint_thinning_levels", "none")
        log(
            f"[adams {mode} step] B={B_MAIN} wall_s={wall:.4f} grads_per_s={B_MAIN / wall:.1f} "
            f"attempts fwd={fwd} bwd={bwd} host_ms_per_attempt={1e3 * wall / (fwd + bwd):.3f} "
            f"thinning_levels={levels} n_backward_steps min/median/max={bwd_steps.min()}/"
            f"{int(np.median(bwd_steps))}/{bwd_steps.max()} "
            f"table_MB={adams_table_bytes(mode, B_MAIN) / 1e6:.1f} "
            f"peak_MB={torch.cuda.max_memory_allocated() / 1e6:.1f} | {smi}"
        )

        # no profiled step: phases 10 and 11 took its time (PERF.md §4)
        gy_np, gp_np = gy.cpu().numpy(), gp.cpu().numpy()
        finite = int((np.isfinite(gy_np).all(axis=1) & np.isfinite(gp_np).all(axis=1)).sum())
        if not (gy_np.shape == gp_np.shape == (B_MAIN, 2) and finite == B_MAIN
                and (status == 0).all()):
            raise SystemExit(f"chip_smoke: {mode} gradients failed ({finite} finite, "
                             f"{int((status == 0).sum())} with status 0, of {B_MAIN})")
        np.testing.assert_allclose(gy_np[:16], golden["gy"], rtol=2e-3, atol=1e-3)
        np.testing.assert_allclose(gp_np[:16], golden["gp"], rtol=2e-3, atol=1e-3)
        gold_rel = max_rel((gy_np[:16], gp_np[:16]), (golden["gy"], golden["gp"]))
        ref = cpu_ref(ref_adams, mode)
        plain_rel = max_rel((gy_np[:16], gp_np[:16]), ref["grads"])
        log(
            f"[adams {mode} check] status 0 and finite in {finite}/{B_MAIN} lanes; "
            f"golden_max_rel={gold_rel:.3e} (gate 2e-3) cuda_vs_cpu_plain_max_rel={plain_rel:.3e} "
            f"(bound 1e-6; the CPU's 16 lanes took {ref['wall']:.2f} s in a worker process)"
        )
        if not plain_rel <= 1e-6:
            raise SystemExit(f"chip_smoke: the CUDA {mode} adjoint disagrees with the plain path")
        log_elapsed(f"7, {mode}")
    return total


ROBERTSON_PROFILED_TIMES = 3  # phase 5's profiled solve: to t = 40 of [0.4, 4e6]


def bdf_robertson_phase(smi) -> None:
    """Phase 5: bench.py's Robertson workload through the BDF wrapper."""
    import torch

    from sunode_torch.entry import build_robertson

    solve, inputs = build_robertson(B_MAIN, device="cuda")
    golden = np.load(os.path.join(HERE, "tests", "golden", "robertson.npz"))
    atol = np.asarray(solve.options.atol)

    def run(tvals=inputs[3]):
        return solve(0.0, *inputs[:3], tvals)

    # the profiled solve comes first and is the timed solve's warm-up; it
    # covers the first observation times only (processing a whole solve's
    # profile takes longer than the solve)
    short = inputs[3][:ROBERTSON_PROFILED_TIMES]
    prof = device_kernels_per_attempt(lambda: run(short),
                                      lambda: solve.last_stats["forward"]["n_attempts"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ys = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = solve.last_stats["forward"]
    attempts = stats["n_attempts"]
    steps = stats["n_steps"].cpu().numpy()
    log(
        f"[bdf robertson solve, warm] B={B_MAIN} wall_s={wall:.4f} "
        f"us_per_solve={1e6 * wall / B_MAIN:.2f} host_ms_per_attempt={1e3 * wall / attempts:.3f} "
        f"| {smi}"
    )
    log(
        f"[bdf robertson stats] n_attempts={attempts} n_steps min/median/max="
        f"{steps.min()}/{int(np.median(steps))}/{steps.max()} "
        f"n_jac_evals max={int(stats['n_jac_evals'].max())} "
        f"n_factorizations max={int(stats['n_factorizations'].max())}"
    )
    log(
        f"[bdf robertson device kernels per attempt] {prof['per_attempt']:.1f} "
        f"({prof['kernels']} kernels, {prof['copies']} copies and fills, "
        f"{prof['attempts']} attempts in one solve to t = {float(short[-1]):g}) device_busy_s="
        f"{prof['busy_s']:.4f} wall_s_under_profiler={prof['wall_s']:.4f} "
        f"device_busy_share={prof['busy_s'] / prof['wall_s']:.4f} (of the profiled solve) | {smi}"
    )
    log("[bdf robertson device kernels by kind] (kind: per attempt, device ms in the solve) "
        + "; ".join(f"{c}: {per:.1f}, {ms:.1f}" for c, (per, ms) in prof["by_class"].items()))

    ys_np = ys.cpu().numpy()
    finite = int(np.isfinite(ys_np).all(axis=(1, 2)).sum())
    never_fatal = int((stats["error_order"] == -1).sum())
    if not (ys_np.shape == (B_MAIN, 8, 3) and finite == B_MAIN and never_fatal == B_MAIN):
        raise SystemExit(
            f"chip_smoke: Robertson lanes failed ({finite} finite, {never_fatal} never fatal, "
            f"of {B_MAIN})"
        )
    np.testing.assert_allclose(ys_np[:16], golden["ys"], rtol=2e-5, atol=1e-10)
    gold_rel = floored_rel(ys_np[:16], golden["ys"], atol)
    plain_rel = floored_rel(ys_np[:16], cpu_ref(ref_robertson)["ys"], atol)
    log(
        f"[bdf robertson check] status 0 in {finite}/{B_MAIN} lanes; golden_max_rel={gold_rel:.3e} "
        f"(gate 2e-5, atol 1e-10) cuda_vs_cpu_plain_max_rel={plain_rel:.3e} (bound 1e-6)"
    )
    if not plain_rel <= 1e-6:
        raise SystemExit("chip_smoke: the CUDA BDF solve disagrees with the plain path")


def lv_sens_solve(problem, y0s, ps, tvals, device):
    """Phase 5b's solve: BDF with forward sensitivities to alpha and beta,
    S0 = 0, rtol and atol 1e-9, as tests/golden/lv_sens.npz was made."""
    import torch

    from sunode_torch.ops.bdf import BDFOptions
    from sunode_torch.ops.bdf_batched import bdf_solve_batched

    f64 = dict(dtype=torch.float64, device=device)
    return bdf_solve_batched(
        problem.make_rhs(), problem.make_jac_dense(), 0.0, torch.as_tensor(y0s, **f64),
        torch.as_tensor(ps, **f64), torch.as_tensor(tvals, **f64),
        BDFOptions(rtol=1e-9, atol=1e-9), sens_rhs=problem.make_sensitivity_rhs(),
        S0=torch.zeros((len(y0s), 2, 2), **f64), batched_fns=True,
    )


def ref_bdf_sens() -> dict:
    """Phase 5b's CPU reference: lanes 0-15, tests/golden/lv_sens.npz's."""
    from sunode_torch.entry import lv_problem

    t0 = time.perf_counter()
    g = np.load(os.path.join(HERE, "tests", "golden", "lv_sens.npz"))
    res = lv_sens_solve(lv_problem(), g["y0s"], g["ps"], g["tvals"], "cpu")
    return dict(ys=res.ys.numpy(), sens=res.sens.numpy(), status=res.status.numpy(),
                wall=time.perf_counter() - t0)


def bdf_sens_phase(smi) -> None:
    """Phase 5b: BDF forward sensitivities of Lotka-Volterra at full width."""
    import torch

    from sunode_torch.entry import lv_problem

    g = np.load(os.path.join(HERE, "tests", "golden", "lv_sens.npz"))
    rng = np.random.default_rng(5)
    around = rng.integers(0, 16, B_MAIN - 16)
    spread = lambda a: a[around] * (1 + 0.05 * rng.standard_normal((B_MAIN - 16, a.shape[1])))  # noqa: E731
    y0s = np.concatenate([g["y0s"], spread(g["y0s"])])
    ps = np.concatenate([g["ps"], spread(g["ps"])])
    problem = lv_problem()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = lv_sens_solve(problem, y0s, ps, g["tvals"], "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ok = int((res.status == 0).sum())
    ys, sens = res.ys.cpu().numpy(), res.sens.cpu().numpy()
    cpu = cpu_ref(ref_bdf_sens)
    plain_rel = max(floored_rel(ys[:16], cpu["ys"], 1e-9),
                    floored_rel(sens[:16], cpu["sens"], 1e-9))
    log(
        f"[bdf sens] B={B_MAIN} k=2 wall_s={wall:.4f} us_per_solve={1e6 * wall / B_MAIN:.2f} "
        f"n_attempts={res.stats['n_attempts']} status 0 in {ok}/{B_MAIN} lanes "
        f"finite={int(np.isfinite(sens).all(axis=(1, 2, 3)).sum())} "
        f"golden_max_abs ys={np.abs(ys[:16] - g['ys']).max():.3e} "
        f"sens={np.abs(sens[:16] - g['sens']).max():.3e} "
        f"cuda_vs_cpu_plain_max_rel={plain_rel:.3e} (ys and sens, atol 1e-9, bound 1e-6; the "
        f"CPU took {cpu['wall']:.2f} s in a worker) | {smi}"
    )
    if ok != B_MAIN:
        raise SystemExit(f"chip_smoke: BDF sensitivities failed in {B_MAIN - ok} lanes")
    np.testing.assert_allclose(ys[:16], g["ys"], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(sens[:16], g["sens"], rtol=2e-4, atol=5e-4)
    if not (cpu["status"] == 0).all() or not plain_rel <= 1e-6:
        raise SystemExit("chip_smoke: the CUDA BDF sensitivities disagree with the plain path")


def sens_expected_launches(method, mode, attempts) -> dict:
    """History-attempt launches by system of one phase 9 sensitivity solve:
    none on the BDF core; on the Adams core one on the forward and one on the
    'staged_sensitivity' build an attempt staggered, one on the
    'sensitivity' build simultaneous."""
    if method == "BDF":
        return {}
    if mode == "staggered":
        return {"forward": attempts, "staged_sensitivity": attempts}
    return {"sensitivity": attempts}


def check_launches(label, counted, by_system, expected) -> dict:
    """The launches by system since the counts were set to 0, required to
    equal ``expected``, with the history attempt's total equal to their sum
    and no other kernel launched; returns them."""
    from sunode_torch.ops.adams_attempt import adams_history_attempt

    launches = {kind: k.launches for kind, k in by_system.items() if k.launches}
    others = [k.launches for k in counted if k not in by_system.values()
              and k is not adams_history_attempt]
    log(f"[{label} launches] history-attempt {launches} total={adams_history_attempt.launches} "
        f"expected={expected}; other kernels {others}")
    if not (launches == expected and adams_history_attempt.launches == sum(expected.values())):
        raise SystemExit(f"chip_smoke: {label}: history-attempt launches do not match the attempts")
    if any(others):
        raise SystemExit(f"chip_smoke: {label}: the path launched another kernel")
    return launches


def lv_sens_phase(smi, counted, by_system) -> dict:
    """Phase 9(b): forward sensitivities of Lotka-Volterra at B=10,000 in
    every mode of ``entry.build_lv_sens``; returns the history-attempt
    launches by system."""
    import torch

    from sunode_torch.entry import LV_SENS_MODES, build_lv_sens

    g = np.load(os.path.join(HERE, "tests", "golden", "lv_sens.npz"))
    total = {}
    for method, mode in LV_SENS_MODES:
        label = f"sens {method} {mode}"
        solve, (y0s, ps, tvals) = build_lv_sens(B_MAIN, method, mode, device="cuda")
        for k in counted:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(y0s, ps, tvals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        attempts = res.stats["n_attempts"]
        launches = check_launches(label, counted, by_system,
                                  sens_expected_launches(method, mode, attempts))
        for kind, count in launches.items():
            total[kind] = total.get(kind, 0) + count
        msg = (f"[{label} solve] B={B_MAIN} rtol={solve.options.rtol} wall_s={wall:.4f} "
               f"attempts={attempts} host_ms_per_attempt={1e3 * wall / attempts:.3f} "
               f"n_rhs_evals max={int(res.stats['n_rhs_evals'].max())}")
        if method == "ADAMS":
            # kernels per attempt and the busy share over the first tenth of
            # the horizon (its attempts are a quarter of the solve's); the
            # BDF solve is not profiled (processing its profile took longer
            # than the solve)
            short = leading_times(tvals, PROFILED_HORIZON)
            held = []
            prof = device_kernels_per_attempt(lambda: held.append(solve(y0s, ps, short)),
                                              lambda: held[0].stats["n_attempts"])
            msg += (f" | profiled over t <= {float(short[-1])}: {prof['per_attempt']:.1f} device "
                    f"kernels per attempt ({prof['kernels']} kernels, {prof['copies']} copies and "
                    f"fills, {prof['attempts']} attempts) host_ms_per_attempt_under_profiler="
                    f"{1e3 * prof['wall_s'] / prof['attempts']:.3f} device_busy_s="
                    f"{prof['busy_s']:.4f} device_busy_share={prof['busy_s'] / prof['wall_s']:.4f}")
        log(f"{msg} | {smi}")
        ys, sens = res.ys.cpu().numpy(), res.sens.cpu().numpy()
        ok = int((res.status == 0).sum())
        finite = int((np.isfinite(ys).all(axis=(1, 2))
                      & np.isfinite(sens).all(axis=(1, 2, 3))).sum())
        if not (ok == finite == B_MAIN):
            raise SystemExit(f"chip_smoke: {label} failed ({ok} with status 0, {finite} finite, "
                             f"of {B_MAIN})")
        np.testing.assert_allclose(ys[:16], g["ys"], rtol=5e-6 if mode == "simultaneous" else 1e-6,
                                   atol=1e-8)
        np.testing.assert_allclose(sens[:16], g["sens"], rtol=2e-4, atol=5e-4)
        cpu = cpu_ref(ref_sens, method, mode)
        plain_rel = max(floored_rel(ys[:4], cpu["ys"], 1e-9),
                        floored_rel(sens[:4], cpu["sens"], 1e-9))
        log(
            f"[{label} check] status 0 and finite in {ok}/{B_MAIN} lanes; golden_max_abs "
            f"ys={np.abs(ys[:16] - g['ys']).max():.3e} "
            f"sens={np.abs(sens[:16] - g['sens']).max():.3e}"
            f" (gates passed) cuda_vs_cpu_lanes_0_3_max_rel={plain_rel:.3e} (bound 1e-8, floored "
            f"at 1e-9; the CPU took {cpu['wall']:.2f} s in a worker process)"
        )
        if not ((cpu["status"] == 0).all() and plain_rel <= 1e-8):
            raise SystemExit(f"chip_smoke: {label} on the card disagrees with the CPU")
        log_elapsed(f"9b, {method} {mode}")
    return total


ROOT_RUNS = ((True, None), (False, None), (False, [-1]))  # phase 9(c): terminal, directions
ROOT_FALLING_TIMES = 11  # 9(c)'s falling-only runs: the first 11 of 21 times, t <= 5


def root_horizon(tvals, directions):
    """9(c)'s observation times: all 21, or for a run filtered by direction
    the first :data:`ROOT_FALLING_TIMES` (every lane's first falling root
    is before t = 0.5; a lane's second and third roots come after t = 8,
    so the runs of both directions keep the whole horizon)."""
    return tvals if directions is None else tvals[:ROOT_FALLING_TIMES]


def lv_roots_phase(smi, counted, by_system) -> dict:
    """Phase 9(c): the event hares = 9 at B=10,000 on both cores, terminal
    and not; returns the history-attempt launches by system."""
    import torch

    from sunode_torch.entry import build_lv_roots

    total = {}
    for method in ("BDF", "ADAMS"):
        for terminal, directions in ROOT_RUNS:
            label = (f"roots {method} " + ("terminal" if terminal else
                                           f"non-terminal directions={directions or [0]}"))
            solve, (y0s, ps, tvals) = build_lv_roots(B_MAIN, method, terminal, device="cuda")
            tvals = root_horizon(tvals, directions)
            for k in counted:
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve(y0s, ps, tvals, root_directions=directions)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            attempts = res.stats["n_attempts"]
            expected = {"forward": attempts} if method == "ADAMS" else {}
            for kind, count in check_launches(label, counted, by_system, expected).items():
                total[kind] = total.get(kind, 0) + count
            st = {k: res.stats[k].cpu().numpy() for k in ("n_roots", "roots_t", "roots_y",
                                                          "roots_found")}
            status, ys = res.status.cpu().numpy(), res.ys.cpu().numpy()
            hit = np.isfinite(st["roots_t"])
            g_max = float(np.abs(st["roots_y"][..., 0][hit] - 9.0).max())
            log(f"[{label} solve] B={B_MAIN} wall_s={wall:.4f} attempts={attempts} "
                f"host_ms_per_attempt={1e3 * wall / attempts:.3f} n_roots min/max="
                f"{st['n_roots'].min()}/{st['n_roots'].max()} "
                f"lanes_with_a_root={int(hit[:, 0].sum())}"
                f" max_abs_g_at_roots={g_max:.3e} (bound 9e-6) | {smi}")
            if not g_max <= 1e-6 * 9.0:
                raise SystemExit(f"chip_smoke: {label}: a recorded root is off the threshold")
            if terminal:
                # each lane with a root stopped there: status 5, one root,
                # nothing emitted past it and everything before it; a lane
                # whose hares stay above 9 on the horizon succeeds (status 0)
                t_obs = tvals.cpu().numpy()
                after = t_obs[None, :] > st["roots_t"][:, :1]  # none where no root
                emitted = np.isfinite(ys).all(axis=2)
                if not ((status == np.where(hit[:, 0], 5, 0)).all()
                        and (st["n_roots"] == hit[:, 0]).all() and (emitted == ~after).all()):
                    raise SystemExit(f"chip_smoke: {label}: a lane did not stop at its first root")
            elif not (status == 0).all():
                raise SystemExit(f"chip_smoke: {label}: {int((status != 0).sum())} lanes failed")
            c_st = cpu_ref(ref_roots, method, terminal, None if directions is None
                           else tuple(directions))
            c_hit = np.isfinite(c_st["roots_t"])
            same = (np.array_equal(st["n_roots"][:16], c_st["n_roots"])
                    and np.array_equal(st["roots_found"][:16], c_st["roots_found"])
                    and np.array_equal(hit[:16], c_hit)
                    and np.array_equal(status[:16], c_st["status"]))
            t_rel = float(np.max(np.abs(st["roots_t"][:16][c_hit] - c_st["roots_t"][c_hit])
                                 / np.abs(c_st["roots_t"][c_hit])))
            log(f"[{label} check] lanes 0-15 against the CPU: n_roots, directions and statuses "
                f"equal={same} root_t_max_rel={t_rel:.3e} (bound 1e-8; the CPU took "
                f"{c_st['wall']:.2f} s for {c_st['attempts']} attempts in a worker process)")
            if not (same and t_rel <= 1e-8):
                raise SystemExit(f"chip_smoke: {label} on the card disagrees with the CPU")
        log_elapsed(f"9c, {method}")
    return total


F32_KINDS = ("forward", "transition")  # phase 10's history builds: lv_adjoint_f32's systems


def f32_history_phase(problem, f32_systems) -> dict:
    """Phase 10(a), history: the float32 forward and transition builds
    against their plain versions at float32 on phase 3c's draws at
    B=10,000, with lv_adjoint_f32's tolerances (rtol = atol = 1e-6 forward,
    1e-5 backward) and their float32 corrector tolerance; returns the
    kernel-table fields by kind."""
    import torch

    table = {}
    for seed, kind in enumerate(F32_KINDS):
        tol = F32_FWD_TOL if kind == "forward" else F32_BWD_TOL
        table[kind] = compare_history_kernel(f"{kind} float32", f32_systems[kind],
                                             lv_plain_fz(problem, kind), seed, P_MAX, tol,
                                             torch.float32)
    return table


def lv_adjoint_f32_phase(smi, counted, f32_kernels) -> dict:
    """Phase 10(b): ``entry.build_lv_adjoint_f32`` at B=10,000 (bench.py's
    lv_adjoint_f32): one warm step, then one gated step with every count
    set to 0 before it, the float32 forward and transition builds' launches
    equal to the forward and backward attempts and no other kernel
    launched; float32 and finite gradients in every lane, lanes 0-15 within
    bench.py's 1e-2 worst lane of lv_adjoint.npz.  Returns the launches by
    kind."""
    import torch

    from sunode_torch.entry import build_lv_adjoint_f32

    golden = np.load(os.path.join(HERE, "tests", "golden", "lv_adjoint.npz"))
    grad_step, (y0s, p_subs) = build_lv_adjoint_f32(B_MAIN, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grad_step(y0s, p_subs)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    all_counted = (*counted, *f32_kernels.values())
    for k in all_counted:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gy, gp = grad_step(y0s, p_subs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = grad_step.solve.last_stats
    fwd, bwd = stats["forward"]["n_attempts"], stats["backward"]["n_attempts"]
    launches = check_launches("lv_adjoint_f32", all_counted, f32_kernels,
                              {"forward": fwd, "transition": bwd})
    log(f"[lv_adjoint_f32 step] B={B_MAIN} wall_s={wall:.4f} grads_per_s={B_MAIN / wall:.1f} "
        f"(warm-up step {warm:.4f} s) attempts fwd={fwd} bwd={bwd} "
        f"host_ms_per_attempt={1e3 * wall / (fwd + bwd):.3f} | {smi}")
    gy_np = gy.cpu().numpy().astype(np.float64)
    gp_np = gp.cpu().numpy().astype(np.float64)
    finite = int((np.isfinite(gy_np).all(axis=1) & np.isfinite(gp_np).all(axis=1)).sum())
    err = float(np.max(np.abs(gy_np[:16] - golden["gy"]) / (np.abs(golden["gy"]) + 1e-3)))
    err_p = float(np.max(np.abs(gp_np[:16] - golden["gp"]) / (np.abs(golden["gp"]) + 1e-3)))
    log(f"[lv_adjoint_f32 check] dtype={gy.dtype}/{gp.dtype} finite={finite}/{B_MAIN} "
        f"golden worst-lane gy err={err:.3e} (bench.py's gate 1e-2) gp err={err_p:.3e}")
    if not (gy.dtype == gp.dtype == torch.float32 and finite == B_MAIN and err < 1e-2):
        raise SystemExit("chip_smoke: lv_adjoint_f32 failed its gate")
    return launches


def sir_f32_phase(smi, counted, f32_split) -> dict:
    """Phase 10(c): SIR-1000 'resolve' at float32 and B=1,024 through
    ``entry.build_sir(dtype=torch.float32)`` (``entry.sir_options``), one
    gated step with every count set to 0 before it: the float32 split
    build's launches 1 / 4 / 1 x the attempts, no other kernel and no plain
    stage; status 0 and finite in every lane, lane 0 (the golden case's
    inputs) within 1e-2 of sir_1000.npz's gradient.  Returns the float32
    build's launches by stage."""
    import torch

    from sunode_torch.entry import build_sir
    from sunode_torch.ops import adams_split as sp

    golden = np.load(os.path.join(HERE, "tests", "golden", "sir_1000.npz"))
    R, B = SIR_R, B_SPLIT
    grad_step, (y0s, p_subs) = build_sir(R, B, "resolve", device="cuda", dtype=torch.float32)
    y0s[0] = torch.as_tensor(golden["y0"], dtype=y0s.dtype)
    p_subs[0] = torch.as_tensor(golden["p0"][:2], dtype=p_subs.dtype)
    for k in (*counted, SplitLaunches(f32_split), SplitLaunches()):
        k.launches = 0
    sp.split_predict.calls = sp.split_sweep.calls = sp.split_finish.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ys, gp = grad_step(y0s, p_subs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = grad_step.solve.last_stats
    fwd, bwd = stats["forward"]["n_attempts"], stats["backward"]["n_attempts"]
    launches = dict(f32_split.launches)
    expected = split_expected_launches(fwd + bwd)
    plain = [sp.split_predict.calls, sp.split_sweep.calls, sp.split_finish.calls]
    others = [k.launches for k in counted]
    log(f"[sir float32 launches] float32 split build {launches} expected={expected}; every "
        f"split build {dict(sp.adams_split_attempt.launches)}; plain-stage calls {plain}; "
        f"other kernels {others}")
    if not (launches == expected and dict(sp.adams_split_attempt.launches) == expected):
        raise SystemExit("chip_smoke: sir float32: split launches do not match the attempts")
    if any(plain) or any(others):
        raise SystemExit("chip_smoke: sir float32: the path ran a plain stage or another kernel")
    ys_np, gp_np = ys.cpu().numpy().astype(np.float64), gp.cpu().numpy().astype(np.float64)
    status = stats["backward"]["status"].cpu().numpy()
    finite = int((np.isfinite(ys_np).all(axis=(1, 2)) & np.isfinite(gp_np).all(axis=1)).sum())
    gold_rel = float(np.max(np.abs(gp_np[0] - golden["gp"]) / np.abs(golden["gp"])))
    ys_rel = floored_rel(ys_np[0], golden["ys"], 1e-8)
    log(f"[sir float32 step] R={R} B={B} rtol fwd/bwd={F32_FWD_TOL}/{F32_BWD_TOL} "
        f"wall_s={wall:.4f} grads_per_s={B / wall:.1f} attempts fwd={fwd} bwd={bwd} "
        f"host_ms_per_attempt={1e3 * wall / (fwd + bwd):.3f} | {smi}")
    log(f"[sir float32 check] dtype={ys.dtype}/{gp.dtype} status 0 and finite in "
        f"{min(finite, int((status == 0).sum()))}/{B} lanes; lane 0 golden gp_rel={gold_rel:.3e} "
        f"(gate 1e-2) ys_rel={ys_rel:.3e} (floored at 1e-8)")
    if not (ys.dtype == gp.dtype == torch.float32 and ys_np.shape == (B, 12, 3 * R)
            and finite == B and (status == 0).all() and gold_rel <= 1e-2):
        raise SystemExit("chip_smoke: sir float32 failed its gate")
    return launches


def per_lane_phase(smi, counted, forward_build) -> int:
    """Phase 11: ``entry.build_lv_per_lane`` at B=10,000 on the Adams core
    (through the float64 forward build: its launches equal to the attempts)
    and on BDF (no kernel), each solve with the counts set to 0 before it:
    status 0 in every lane, each padded slot its lane's last emitted value
    bit for bit, lanes 0-15 within 1e-8 of the CPU's plain path (floored at
    atol 1e-8).  Returns the forward build's launches."""
    import torch

    from sunode_torch.entry import build_lv_per_lane

    total = 0
    for method in ("ADAMS", "BDF"):
        label = f"per-lane {method}"
        solve, (y0s, ps, tvals) = build_lv_per_lane(B_MAIN, method, device="cuda")
        for k in counted:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(y0s, ps, tvals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        attempts = res.stats["n_attempts"]
        expected = {"forward": attempts} if method == "ADAMS" else {}
        total += check_launches(label, counted, {"forward": forward_build}, expected).get(
            "forward", 0)
        ys, tv = res.ys.cpu(), tvals.cpu()
        ok = int((res.status == 0).sum())
        finite = int(torch.isfinite(ys).all(dim=(1, 2)).sum())
        # the first slot at each lane's last time, and every slot after it
        last = (tv == tv[:, -1:]).int().argmax(dim=1)
        pad = torch.arange(tv.shape[1])[None, :] >= last[:, None]
        padded_same = bool((~pad[:, :, None] | (ys == ys[torch.arange(B_MAIN), last][:, None])
                            ).all())
        cpu = cpu_ref(ref_per_lane, method)
        plain_rel = floored_rel(ys[:16].numpy(), cpu["ys"], 1e-8)
        log(f"[{label} solve] B={B_MAIN} observation times a lane {int(last.min()) + 1}-"
            f"{int(last.max()) + 1} wall_s={wall:.4f} attempts={attempts} "
            f"host_ms_per_attempt={1e3 * wall / attempts:.3f} | {smi}")
        log(f"[{label} check] status 0 in {ok}/{B_MAIN} lanes, finite {finite}; padded slots "
            f"equal to the lane's last value bit for bit: {padded_same}; "
            f"cuda_vs_cpu_lanes_0_15_max_rel={plain_rel:.3e} (bound 1e-8, floored at 1e-8; the "
            f"CPU took {cpu['wall']:.2f} s in a worker process)")
        if not (ok == finite == B_MAIN and padded_same and (cpu["status"] == 0).all()
                and plain_rel <= 1e-8):
            raise SystemExit(f"chip_smoke: {label} failed")
        log_elapsed(f"11, {method}")
    return total


# ---- phase 12: structured Newton on the batched BDF core, and splines -------------
B_STRUCT = 1024  # phase 12's lanes: scripts/bench_batched_structured.py's B
STRUCT_N = (128, 256)  # its n, and twice it
STRUCT_GOLD_LANES = 3  # lanes held against scipy's LSODA at rtol 1e-11 (the script's N_GOLD)
# 12(b) and (d)'s gradient steps and 12(e)'s forward: the first 2 observation
# times (t <= 0.19 of KPP's [0.05, 1], t <= 0.24 of the hub's); the cut that
# made room for phase 16 (PERF.md section 4)
STRUCT_LEADING_TIMES = 2
BANDED_SOURCE = "sunode_torch/csrc/banded.cu"
SINGULAR_LANE = 5  # 12(a): this lane's Newton matrix is zero
PIVOT_LANES = slice(16, 24)  # 12(a): seeded random band entries, so rows swap
SPLINE_KINDS = ("forward", "transition")  # 12(f)'s history builds, at both types


def bits_equal(a, b) -> bool:
    """Bit for bit: the same NaN pattern, and every other element the same
    bits (so -0.0 is not +0.0)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    ints = torch.int64 if a.dtype == torch.float64 else torch.int32
    return bool(torch.equal(a[~na].view(ints), b[~nb].view(ints)))


def newton_band_inputs(n, B, dtype, test_lanes=True):
    """12(a)'s inputs on the card: the Newton matrices ``M = I - c J`` of the
    Fisher-KPP chain at its initial states (``entry.kpp_inputs``), J in
    banded storage from ``make_banded_jac(1, 1)``, c log-uniform in [1e-4,
    1e-2] a lane (``default_rng(12)``), and with ``test_lanes`` lanes 16-23
    random band entries (rows swap there) and lane 5 zero (singular); three
    right-hand sides.  Without the test lanes every lane is a Newton matrix
    of the path, whose divisions all take the fast path of the IEEE divide
    (a zero or tiny pivot, as in lane 5, takes its slow path every column,
    and its lane tile with it)."""
    import torch

    from sunode_torch.entry import kpp_inputs, kpp_problem

    y0, params, _ = kpp_inputs(n, B)
    f64 = dict(dtype=torch.float64, device="cuda")
    J = kpp_problem(n).make_banded_jac(1, 1)(
        torch.zeros(B, **f64), torch.as_tensor(y0.T, **f64), torch.as_tensor(params.T, **f64))
    rng = np.random.default_rng(12)
    c = torch.as_tensor(10.0 ** rng.uniform(-4, -2, B), **f64)
    M = (-c) * J
    M[1] += 1.0
    pivots = torch.as_tensor(rng.standard_normal((3, n, 8)), **f64)
    if test_lanes:
        M[:, :, PIVOT_LANES] = pivots
        M[:, :, SINGULAR_LANE] = 0.0
    b = torch.as_tensor(rng.standard_normal((3, n, B)), **f64)
    return M.to(dtype).contiguous(), b.to(dtype).contiguous()


def banded_cost(n, B, m, l, u, itemsize) -> dict:
    """(bytes, operations) of one factor and one solve of m right-hand
    sides: each input read once and each output written once (the factor:
    ab in, the working storage, pivots and flags out; the solve: the working
    storage, pivots, flags and b in, x out); the factor's l (2 (l+u) + 1)
    and the solve's 2 l + 2 (l+u) + 1 operations a row and lane."""
    w = l + u
    ab = (l + u + 1) * n * B * itemsize
    lu = (2 * l + u + 1) * (n + w) * B * itemsize
    factor = (ab + lu + 4 * n * B + B, n * B * l * (2 * w + 1))
    solve = (lu + 4 * n * B + B + 2 * m * n * B * itemsize, m * n * B * (2 * l + 2 * w + 1))
    return {"factor": factor, "solve": solve}


# Cycles of one dependent operation on an H100 SXM, one thread's chain of
# 2,048 (sunode_torch/experiments/banded_ab.py --latencies): add or multiply,
# the IEEE divide (__ddiv_rn / __fdiv_rn, its fast path; the same with the
# dividend or the divisor on the chain), |a| compared and selected.
CHAIN_LATENCY = {
    "double": dict(add=8.2, mul=8.2, div=111.8, compare_select=14.3),
    "float": dict(add=4.2, mul=4.2, div=44.4, compare_select=8.4),
}
SM_CLOCK_HZ = 1.98e9  # an H100 SXM's SM clock, as %globaltimer read it under the kernels


def banded_chain(n, l, u, real) -> dict:
    """The chain bound of one factor and one solve: a lane's n steps are
    dependent, and each step's dependent instructions in the SASS
    (csrc/banded.cu) cost at least their latencies (:data:`CHAIN_LATENCY`).
    Factor column: l compare-selects for the pivot, one for the _TINY guard,
    the divide (the pivot on the chain), then the multiply and subtract that
    the next column's pivot reads.  Solve row: forward, the multiply and
    subtract (the pivot's select left out: no latency measured for it);
    backward, U's first product, l+u-1 adds, the subtract and the divide.
    Returns {kind: (cycles, seconds)}."""
    lat = CHAIN_LATENCY[real]
    factor = (l + 1) * lat["compare_select"] + lat["div"] + lat["mul"] + lat["add"]
    forward = lat["mul"] + lat["add"] if l else 0.0
    backward = lat["div"] + ((l + u - 1) * lat["add"] + lat["mul"] + lat["add"] if l + u else 0.0)
    out = {"factor": n * factor, "solve": n * (forward + backward)}
    return {k: (c, c / SM_CLOCK_HZ) for k, c in out.items()}


def compare_banded(n, dtype) -> dict:
    """12(a) at one (n, type): the factor and solve kernels against their
    plain versions on :func:`newton_band_inputs` at B=1,024 (lu, piv, sing
    and the solutions bit for bit, with ``sing`` and without; the singular
    lane NaN in both), each timed as in phase 3 with its bounds, and
    ``torch.linalg.lu_factor_ex`` / ``lu_solve`` on the dense matrices at
    the same shapes as the yardstick, each beside its bytes bound and its
    chain bound (:func:`banded_chain`), and each kernel's device time on the
    Newton matrices alone (no test lane, whose tile takes the divide's slow
    path).  Returns {'factor', 'solve'}: the kernel-table fields."""
    import torch

    from sunode_torch.experiments.exp_pece2d import cuda_ms, device_us
    from sunode_torch.ops import banded as bd

    l = u = 1
    M, b = newton_band_inputs(n, B_STRUCT, dtype)
    f_k = bd.banded_factor(M, l, u)
    f_p = bd.banded_factor_reference(M, l, u)
    checks = {f"{name}_bitwise": bits_equal(x, y) for name, x, y in zip(("lu", "piv", "sing"),
                                                                       f_k, f_p)}
    abs_err = 0.0
    for m in (1, 3):
        for label, sing in (("", True), ("_unpoisoned", False)):
            fk = f_k if sing else (f_k[0], f_k[1], None)
            fp = f_p if sing else (f_p[0], f_p[1], None)
            x_k = bd.banded_solve(fk, b[:m].contiguous(), l, u)
            x_p = bd.banded_solve_reference(fp, b[:m].contiguous(), l, u)
            checks[f"x_m{m}{label}_bitwise"] = bits_equal(x_k, x_p)
            fin = torch.isfinite(x_p)
            abs_err = max(abs_err, float((x_k - x_p)[fin].abs().max()))
            if sing:
                checks[f"singular_lane_nan_m{m}"] = bool(
                    torch.isnan(x_k[:, :, SINGULAR_LANE]).all()
                    and torch.isnan(x_p[:, :, SINGULAR_LANE]).all())
    torch.cuda.synchronize()
    swapped = int((f_k[1] != 0).any(dim=0).sum())
    itemsize = torch.finfo(dtype).bits // 8
    cost = banded_cost(n, B_STRUCT, 1, l, u, itemsize)
    w = l + u
    b1 = b[:1].contiguous()

    def factor_k(z):
        return (bd.banded_factor(z, l, u)[0][l : l + w + 1, :n],)

    def factor_p(z):
        return (bd.banded_factor_reference(z, l, u)[0][l : l + w + 1, :n],)

    def plain_times(call, z):
        # the plain versions launch ~18 kernels a column: a few calls, and at
        # the path's n only
        if n != STRUCT_N[0]:
            return dict(graph=None, stream=float("nan"), device=None)
        return dict(graph=None, stream=1e3 * cuda_ms(lambda: call(z), reps=5),
                    device=device_us(lambda: call(z), reps=5))

    times = {
        "factor": (per_call_times(factor_k, M, "banded_factor_kernel"), plain_times(factor_p, M)),
        "solve": (per_call_times(lambda z: (bd.banded_solve(f_k, z, l, u),), b1,
                                 "banded_solve_kernel"),
                  plain_times(lambda z: (bd.banded_solve_reference(f_p, z, l, u),), b1)),
    }
    Mn, _ = newton_band_inputs(n, B_STRUCT, dtype, test_lanes=False)
    f_n = bd.banded_factor(Mn, l, u)
    newton_us = {
        "factor": device_us(lambda: bd.banded_factor(Mn, l, u), kernel="banded_factor_kernel"),
        "solve": device_us(lambda: bd.banded_solve(f_n, b1, l, u), kernel="banded_solve_kernel"),
    }
    chain = banded_chain(n, l, u, "double" if dtype == torch.float64 else "float")
    # the yardstick: the same matrices dense, one torch.linalg call each
    A = bd.banded_to_dense(M, l, u).permute(2, 0, 1).contiguous()
    LU, piv, _ = torch.linalg.lu_factor_ex(A)
    rhs = b1[0].T.contiguous()[:, :, None]
    library = {
        "factor": cuda_ms(lambda: torch.linalg.lu_factor_ex(A), reps=20),
        "solve": cuda_ms(lambda: torch.linalg.lu_solve(LU, piv, rhs), reps=20),
    }
    out = {}
    for kind in ("factor", "solve"):
        t_k, t_p = times[kind]
        nbytes, flops = cost[kind]
        out[kind] = dict(max_abs_err=abs_err if kind == "solve" else 0.0,
                         ms=t_k["stream"] / 1e3, plain_ms=t_p["stream"] / 1e3,
                         **bound(nbytes, flops, dtype))
        out[kind]["library_ms"] = library[kind]
        chain_us = 1e6 * chain[kind][1]
        log(f"[banded-{kind}-vs-plain n={n} B={B_STRUCT} l=u=1 dtype={dtype}] "
            + fmt_times("kernel", t_k) + fmt_times("plain", t_p)
            + f" library(torch.linalg.{'lu_factor_ex' if kind == 'factor' else 'lu_solve'}, "
            f"dense)_ms={library[kind]:.4f} bytes={nbytes} flops={flops} "
            f"bound_us={1e3 * out[kind]['bound_ms']:.3f} ({out[kind]['bound_by']}) "
            f"device_over_bound="
            f"{fmt_us(t_k['device'] and t_k['device'] / (1e3 * out[kind]['bound_ms']))} "
            f"chain_cycles={chain[kind][0]:.0f} chain_bound_us={chain_us:.3f} "
            f"device_over_chain={fmt_us(t_k['device'] and t_k['device'] / chain_us)} "
            f"newton_only_device_us={fmt_us(newton_us[kind])} "
            f"newton_only_over_chain={fmt_us(newton_us[kind] and newton_us[kind] / chain_us)}")
    log(f"[banded-kernels-vs-plain n={n} B={B_STRUCT} dtype={dtype}] lanes with a row swap "
        f"{swapped}; singular lanes {int(f_k[2].sum())}; max_abs_err (finite solutions)="
        f"{abs_err:.3e} "
        + " ".join(f"{k}={v}" for k, v in checks.items()))
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke: the banded kernels disagree with their plain versions "
                         f"(n={n}, {dtype})")
    return out


def kpp_lsoda(y0, params, tvals, lanes=STRUCT_GOLD_LANES) -> list:
    """scipy's LSODA at rtol 1e-11 / atol 1e-13 on the first ``lanes``
    lanes of the Fisher-KPP chain, as ``scripts/bench_batched_structured.py
    ::_golden_gate`` solves it: the oracle of 12(b), (c) and (e)."""
    from scipy.integrate import solve_ivp

    def f_np(t, u, D, r):
        lap = np.empty_like(u)
        lap[0] = u[1] - u[0]
        lap[-1] = u[-2] - u[-1]
        lap[1:-1] = u[2:] - 2 * u[1:-1] + u[:-2]
        return D * lap + r * u * (1 - u)

    out = []
    for i in range(lanes):
        sol = solve_ivp(f_np, (0.0, tvals[-1]), y0[i], t_eval=tvals, method="LSODA",
                        rtol=1e-11, atol=1e-13, args=(params[i, 0], params[i, 1]))
        out.append(sol.y.T)
    return out


class BandedCounts:
    """Every banded build's and wrapper's launches, set to 0 and read as
    one: ``launches`` is the wrappers' total (factor + solve)."""

    def __init__(self, builds):
        from sunode_torch.ops.banded import banded_factor, banded_solve

        self.builds = builds
        self.wrappers = (banded_factor, banded_solve)

    @property
    def launches(self):
        return sum(w.launches for w in self.wrappers)

    @launches.setter
    def launches(self, value):
        for w in self.wrappers:
            w.launches = value
        for k in self.builds:
            k.factor_launches = k.solve_launches = value

    def by_kind(self):
        return {"factor": self.wrappers[0].launches, "solve": self.wrappers[1].launches}


def expected_banded(stats, bbd: bool) -> dict:
    """Banded launches of a solve (or of a forward and backward, summed
    stats): one factor a lockstep factorization, one solve a lockstep Newton
    solve, and with a BBD border one more solve a factorization (X = Bb^-1 F)."""
    f, s = stats["n_linear_factors"], stats["n_linear_solves"]
    return {"factor": f, "solve": s + (f if bbd else 0)}


def structured_counts(label, counted, banded, expected) -> None:
    """The banded launches since the counts were set to 0 against
    ``expected``, every other kernel's none."""
    got = banded.by_kind()
    others = [k.launches for k in counted if k is not banded]
    log(f"[{label} launches] banded {got} expected={expected}; other kernels {others}")
    if got != expected or any(others):
        raise SystemExit(f"chip_smoke: {label}: the banded launches do not match the Newton solver")


def drive(label, run, attempts, counted, smi) -> dict:
    """One sub-phase's run under the profiler, with every count set to 0 just
    before it: attempts, device kernels an attempt, host ms an attempt and
    the device-busy share, logged; returns the profile with ``out``, the
    run's result."""
    for k in counted:
        k.launches = 0
    box = {}
    prof = device_kernels_per_attempt(lambda: box.setdefault("out", run()), attempts)
    prof["out"] = box["out"]
    log(f"[{label} profiled] attempts={prof['attempts']} "
        f"wall_s_under_profiler={prof['wall_s']:.4f} "
        f"host_ms_per_attempt_under_profiler={1e3 * prof['wall_s'] / prof['attempts']:.3f} "
        f"device kernels per attempt {prof['per_attempt']:.1f} ({prof['kernels']} kernels, "
        f"{prof['copies']} copies and fills) device_busy_s={prof['busy_s']:.4f} "
        f"device_busy_share={prof['busy_s'] / prof['wall_s']:.4f} | {smi}")
    log(f"[{label} device kernels by kind] (kind: per attempt, device ms) "
        + "; ".join(f"{c}: {per:.1f}, {ms:.1f}" for c, (per, ms) in prof["by_class"].items()))
    return prof


def lsoda_gate(label, ys, y0, params, tvals) -> float:
    worst = 0.0
    for i, ref in enumerate(kpp_lsoda(y0, params, tvals)):
        worst = max(worst, float(np.max(np.abs(ys[i] - ref))))
    log(f"[{label} LSODA] lanes 0-{STRUCT_GOLD_LANES - 1} max_abs_err={worst:.3e} (gate 5e-6, "
        f"scipy LSODA rtol 1e-11)")
    if not worst < 5e-6:
        raise SystemExit(f"chip_smoke: {label} failed the LSODA gate")
    return worst


def structured_forward(label, make, n, solver, counted, banded, smi, cpu=True, lsoda=True,
                       profile=True, leading=False):
    """12(b)-(e)'s forward solve at B=1,024 through ``make`` (``entry
    .build_kpp`` or ``build_hub``), profiled (or, without ``profile``, timed
    alone), with the banded launches equal to the Newton solver's calls:
    status 0 everywhere, LSODA on lanes 0-2 (the chain), lanes 0-3 within
    1e-6 of the CPU's plain path (floored at atol 1e-10).  With ``leading``
    (no CPU reference) it solves over the first STRUCT_LEADING_TIMES
    observation times, and LSODA's gate holds there.  Returns (forward,
    grad_step, inputs, ys), the inputs with all the times."""
    import torch

    forward, grad_step, (y0, p, tvals) = make(n, B_STRUCT, solver, device="cuda")
    if leading and cpu:
        raise ValueError("the CPU references solve over every observation time")
    t_obs = tvals[:STRUCT_LEADING_TIMES] if leading else tvals
    t_dev = torch.as_tensor(t_obs, dtype=torch.float64, device="cuda")
    if profile:
        prof = drive(f"{label} forward", lambda: forward(y0, p, t_dev),
                     lambda: forward.last_stats["n_attempts"], counted, smi)
    else:
        for k in counted:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof = {"out": forward(y0, p, t_dev)}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        attempts = forward.last_stats["n_attempts"]
        log(f"[{label} forward] attempts={attempts} wall_s={wall:.4f} host_ms_per_attempt="
            f"{1e3 * wall / attempts:.3f} (not profiled) t <= {float(t_obs[-1]):.4g} | {smi}")
    stats = forward.last_stats
    if solver == "spgmr":
        structured_counts(f"{label} forward", counted, banded, {"factor": 0, "solve": 0})
    else:
        structured_counts(f"{label} forward", counted, banded,
                          expected_banded(stats, make.__name__ == "build_hub"))
    ys = prof["out"].cpu().numpy()  # a failed lane's ys are NaN
    ok = int(np.isfinite(ys).all(axis=(1, 2)).sum())
    msg = f"[{label} forward check] n={n} B={B_STRUCT} finite (status 0) in {ok}/{B_STRUCT} lanes"
    if lsoda:
        lsoda_gate(label, ys, y0.cpu().numpy(), p.cpu().numpy(), t_obs)
    if cpu:
        ref = cpu_ref(ref_structured, make.__name__[len("build_"):], n, solver)
        rel = floored_rel(ys[:4], ref["ys"], 1e-10)
        msg += (f"; cuda_vs_cpu_plain lanes 0-3 max_rel={rel:.3e} (bound 1e-6, floored at 1e-10; "
                f"the CPU took {ref['wall']:.2f} s in a worker process)")
        if not rel <= 1e-6:
            raise SystemExit(f"chip_smoke: {label} disagrees with the plain path")
    log(msg)
    if ok != B_STRUCT:
        raise SystemExit(f"chip_smoke: {label}: failed lanes")
    return forward, grad_step, (y0, p, tvals), ys


def structured_grad(label, make, n, grad_step, inputs, counted, banded, smi, bbd=False,
                    dense=None):
    """One timed gradient step at B=1,024 over the first
    STRUCT_LEADING_TIMES observation times, with the counts set to 0 before
    it (banded launches = the forward's and backward's Newton calls):
    finite everywhere, and lanes 0-3 within rtol 1e-4 / atol 1e-8 of the
    dense solver's gradient over the same times
    (``tests/test_batched_structured.py:200``'s tolerances): on the card,
    run on lanes 0-15, or, given ``dense``, those gradients (lanes 0-15, the
    CPU's, from a worker)."""
    import torch

    y0, p, tvals = inputs
    t_dev = leading_tvals(tvals, "cuda")
    for k in counted:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gy, gp = grad_step(y0, p, t_dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = grad_step.solve.last_stats
    fwd, bwd = st["forward"], st["backward"]
    summed = {k: fwd[k] + bwd[k] for k in ("n_linear_factors", "n_linear_solves")}
    structured_counts(f"{label} gradient", counted, banded, expected_banded(summed, bbd))
    attempts = fwd["n_attempts"] + bwd["n_attempts"]
    log(f"[{label} gradient step] n={n} B={B_STRUCT} wall_s={wall:.4f} grads_per_s="
        f"{B_STRUCT / wall:.1f} attempts fwd={fwd['n_attempts']} bwd={bwd['n_attempts']} "
        f"host_ms_per_attempt={1e3 * wall / attempts:.3f} t <= {float(t_dev[-1]):.4g} | {smi}")
    gy, gp = gy.cpu().numpy(), gp.cpu().numpy()
    finite = int((np.isfinite(gy).all(axis=1) & np.isfinite(gp).all(axis=1)).sum())
    if dense is None:
        _, dense_grad, _ = make(n, 16, "dense", device="cuda")
        dy, dp = (g.cpu().numpy() for g in dense_grad(y0[:16], p[:16], t_dev))
        lanes, where = 4, "on the card (16 lanes)"
    else:
        (dy, dp), lanes, where = dense, 16, "on the CPU"
    rel = max(float(np.max(np.abs(gp[:lanes] - dp[:lanes]) / (np.abs(dp[:lanes]) + 1e-4))),
              float(np.max(np.abs(gy[:lanes] - dy[:lanes]) / (np.abs(dy[:lanes]) + 1e-4))))
    close = (np.allclose(gp[:lanes], dp[:lanes], rtol=1e-4, atol=1e-8)
             and np.allclose(gy[:lanes], dy[:lanes], rtol=1e-4, atol=1e-8))
    log(f"[{label} gradient check] finite in {finite}/{B_STRUCT} lanes; lanes 0-{lanes - 1} "
        f"against the dense solver's gradient {where}: max |diff| / (|dense| + 1e-4) = "
        f"{rel:.3e} within rtol 1e-4 / atol 1e-8: {close}")
    if not (finite == B_STRUCT and close):
        raise SystemExit(f"chip_smoke: {label}: the gradient failed its gate")


def hub_dense_check(label, ys, dense) -> None:
    """12(d): lanes 0-15 of the sparse forward within rtol 1e-6 / atol 1e-10
    of the dense solver's (the CPU's, from a worker)."""
    ref = dense["ys"]
    close = np.allclose(ys[:16], ref, rtol=1e-6, atol=1e-10)
    log(f"[{label} vs dense] lanes 0-15 max_rel={floored_rel(ys[:16], ref, 1e-10):.3e} "
        f"within rtol 1e-6 / atol 1e-10: {close} (the dense solve on the CPU took "
        f"{dense['wall']:.2f} s with its gradient, in a worker process)")
    if not close:
        raise SystemExit(f"chip_smoke: {label} disagrees with the dense solve")


def structured_phase(smi, counted, banded_builds) -> dict:
    """Phase 12(a)-(e); returns the banded kernel-table fields by
    (kind, dtype) and the launches by build."""
    import torch

    from sunode_torch.entry import build_hub, build_kpp

    table = {}
    for dtype in (torch.float64, torch.float32):
        per_n = {n: compare_banded(n, dtype) for n in STRUCT_N}
        for kind in ("factor", "solve"):
            table[(kind, dtype)] = per_n[STRUCT_N[0]][kind]
    log_elapsed("12a")
    banded = BandedCounts(banded_builds)
    counted = (*counted, banded)
    launches = {id(k): [0, 0] for k in banded_builds}

    def tally():
        for k in banded_builds:
            launches[id(k)][0] += k.factor_launches
            launches[id(k)][1] += k.solve_launches

    forward, grad_step, inputs, _ = structured_forward("12(b) kpp band", build_kpp, 128, "band",
                                                      counted, banded, smi)
    tally()
    structured_grad("12(b) kpp band", build_kpp, 128, grad_step, inputs, counted, banded, smi,
                    dense=cpu_ref(ref_kpp_dense)["grads"])
    tally()
    log_elapsed("12b")
    structured_forward("12(c) kpp band", build_kpp, 256, "band", counted, banded, smi,
                       profile=False)
    tally()
    log_elapsed("12c")
    _, hub_grad, hub_in, hub_ys = structured_forward("12(d) hub sparse", build_hub, 128, "sparse",
                                                     counted, banded, smi, lsoda=False,
                                                     profile=False)
    tally()
    dense = cpu_ref(ref_hub_dense)
    hub_dense_check("12(d) hub sparse", hub_ys, dense)
    structured_grad("12(d) hub sparse", build_hub, 128, hub_grad, hub_in, counted, banded, smi,
                    bbd=True, dense=dense["grads"])
    tally()
    log_elapsed("12d")
    structured_forward("12(e) kpp spgmr", build_kpp, 128, "spgmr", counted, banded, smi,
                       cpu=False, profile=False, leading=True)
    log_elapsed("12e")
    return {"table": table, "launches": launches}


def spline_phase(smi, counted, spline_systems, spline_kernels) -> dict:
    """Phase 12(f): the spline LV's forward and transition builds at both
    types against their plain versions as in phase 3c (C6's checks; 10(a)'s
    bound at float32), then one gated ADAMS forward + transition-adjoint
    step at B=10,000 through ``entry.build_lv_spline``, timed, with the
    counts set to 0 before it: the float64 builds' launches equal to the
    attempts, every lane finite, lanes 0-3 within 1e-8 of the CPU's plain
    path.  Returns the kernel-table fields and launches by (kind, dtype)."""
    import torch

    from sunode_torch.entry import build_lv_spline, lv_spline_problem

    problem = lv_spline_problem()
    table = {}
    for seed, kind in enumerate(SPLINE_KINDS, start=40):
        fz = lv_plain_fz(problem, kind)
        table[(kind, torch.float64)] = compare_history_kernel(
            f"spline {kind}", spline_systems[(kind, torch.float64)], fz, seed, plain_reps=5)
        tol = F32_FWD_TOL if kind == "forward" else F32_BWD_TOL
        table[(kind, torch.float32)] = compare_history_kernel(
            f"spline {kind} float32", spline_systems[(kind, torch.float32)], fz, seed, P_MAX, tol,
            torch.float32, plain_reps=5)
    log_elapsed("12f, the builds")
    grad_step, (y0s, p_subs) = build_lv_spline(B_MAIN, device="cuda")
    by_system = {kind: spline_kernels[(kind, torch.float64)] for kind in SPLINE_KINDS}
    all_counted = (*counted, *spline_kernels.values())

    def attempts():
        st = grad_step.solve.last_stats
        return st["forward"]["n_attempts"] + st["backward"]["n_attempts"]

    for k in all_counted:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = grad_step(y0s, p_subs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"[12(f) lv spline gradient] attempts={attempts()} wall_s={wall:.4f} "
        f"host_ms_per_attempt={1e3 * wall / attempts():.3f} (not profiled) | {smi}")
    st = grad_step.solve.last_stats
    fwd, bwd = st["forward"]["n_attempts"], st["backward"]["n_attempts"]
    launches = check_launches("12(f) lv spline", all_counted, by_system,
                              {"forward": fwd, "transition": bwd})
    gy, gp = (g.cpu().numpy() for g in out)
    finite = int((np.isfinite(gy).all(axis=1) & np.isfinite(gp).all(axis=1)).sum())
    ref = cpu_ref(ref_lv_spline)
    cy, cp = ref["grads"]
    rel = max(float(np.max(np.abs(gy[:4] - cy) / np.abs(cy))),
              float(np.max(np.abs(gp[:4] - cp) / np.abs(cp))))
    log(f"[12(f) lv spline check] B={B_MAIN} attempts fwd={fwd} bwd={bwd} finite={finite}/"
        f"{B_MAIN} cuda_vs_cpu_plain lanes 0-3 max_rel={rel:.3e} (bound 1e-8; the CPU took "
        f"{ref['wall']:.2f} s in a worker process)")
    if not (finite == B_MAIN and rel <= 1e-8):
        raise SystemExit("chip_smoke: the spline LV gradient failed its gate")
    log_elapsed("12f")
    return {"table": table, "launches": {(k, torch.float64): v for k, v in launches.items()}}


# ---- phase 13: the single-chain surface (make_solve_fn, solve_ivp) -----------------
SINGLE_LANES = 2  # 13(a) and (d): lanes 0-1 of lv_adjoint.npz's chains
SINGLE_KPP_N = 128  # 13(b): one Fisher-KPP chain, band against dense
SINGLE_B1_N = (1, 37, 128)  # 13(0): the banded kernels at one lane, bit for bit


def single_ivp_kwargs(alpha) -> dict:
    """13(c)'s call: the README's torch quickstart, the sympy Lotka-Volterra
    through ``solve_ivp`` with alpha the tensor to differentiate."""
    from sunode_torch.entry import _lv

    return dict(t0=0.0, y0={"hares": (10.0, ()), "lynx": (2.0, ())},
                params={"alpha": alpha, "beta": (0.3, ()), "gamma": np.array(1.0),
                        "delta": np.array(0.4)},
                tvals=np.linspace(1.0, 10.0, 21), rhs=_lv)


def single_lane_grids():
    """13(d)'s per-lane grids: ``entry.lv_per_lane_tvals`` for two lanes."""
    from sunode_torch.entry import lv_per_lane_tvals

    return lv_per_lane_tvals(SINGLE_LANES)


def single_lanes_solve():
    """13(d)'s solve: ``make_solve_fn`` of the LV at rtol 1e-6 both ways, its
    (lane loop) gradient taken through ``solve_lanes``."""
    from sunode_torch.entry import lv_problem
    from sunode_torch.ops.bdf import BDFOptions
    from sunode_torch.wrappers.as_torch import make_solve_fn

    opts = BDFOptions(rtol=1e-6, atol=1e-6)
    return make_solve_fn(lv_problem(), options=opts, adjoint_options=opts)


def single_lanes_grads(solve, y0s, p_subs, tvals, p_fix):
    import torch

    from sunode_torch.wrappers.as_torch import solve_lanes

    y0s = y0s.detach().requires_grad_(True)
    p_subs = p_subs.detach().requires_grad_(True)
    ys = solve_lanes(solve, 0.0, y0s, p_subs, p_fix, tvals)
    return torch.autograd.grad(torch.sum(ys**2), (y0s, p_subs))


def ref_single() -> dict:
    """Phase 13's CPU references: (a) the single LV gradient of lanes 0-1,
    (c) the quickstart's solve_ivp gradient, (d) the per-lane route's."""
    import torch

    from sunode_torch.entry import LV_P_FIX, build_lv_single
    from sunode_torch.wrappers.as_torch import solve_ivp

    t0 = time.perf_counter()
    step, (y0s, p_subs) = build_lv_single(SINGLE_LANES, device="cpu")
    lanes = [[g.numpy() for g in step(y0s[i], p_subs[i])] for i in range(SINGLE_LANES)]
    wall_a = time.perf_counter() - t0
    alpha = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    res = solve_ivp(**single_ivp_kwargs(alpha), device="cpu")
    (g_ivp,) = torch.autograd.grad(torch.sum(res.solution["hares"] ** 2), alpha)
    f64 = dict(dtype=torch.float64)
    grads_d = single_lanes_grads(single_lanes_solve(), y0s, p_subs,
                                 torch.as_tensor(single_lane_grids(), **f64),
                                 torch.as_tensor(LV_P_FIX, **f64))
    return dict(lanes=lanes, ivp=float(g_ivp), per_lane=[g.numpy() for g in grads_d],
                wall_a=wall_a, wall=time.perf_counter() - t0)


def ref_kpp_single_dense() -> dict:
    """13(b)'s dense reference on the CPU: the KPP chain's gradient through
    ``entry.build_kpp_single`` with dense Newton."""
    from sunode_torch.entry import build_kpp_single

    t0 = time.perf_counter()
    _, grad_step, (y0, p, _) = build_kpp_single(SINGLE_KPP_N, "dense", device="cpu")
    grads = [g.numpy() for g in grad_step(y0, p)]
    return dict(grads=grads, wall=time.perf_counter() - t0,
                attempts=single_attempts(grad_step.solve))


def banded_single_lane(smi) -> dict:
    """13(0): the banded kernels at B=1 (one lane tile, 31 idle lanes) on
    one lane of :func:`newton_band_inputs` at each n of
    :data:`SINGLE_B1_N`: lu, piv, sing and the solution bit for bit their
    plain versions'; at n = 128 each kernel's device time from HBM and its
    bound.  Returns {kind: device us} at n = 128."""
    import torch

    from sunode_torch.experiments.exp_pece2d import device_us
    from sunode_torch.ops import banded as bd

    out = {}
    for n in SINGLE_B1_N:
        M, b = newton_band_inputs(max(n, 2), 1, torch.float64, test_lanes=False)
        M, b = M[:, :n].contiguous(), b[:1, :n].contiguous()
        f_k, f_p = bd.banded_factor(M, 1, 1), bd.banded_factor_reference(M, 1, 1)
        x_k, x_p = bd.banded_solve(f_k, b, 1, 1), bd.banded_solve_reference(f_p, b, 1, 1)
        same = all(bits_equal(x, y) for x, y in zip((*f_k, x_k), (*f_p, x_p)))
        msg = f"[13(0) banded B=1 n={n}] lu, piv, sing and x bit for bit: {same}"
        if n == SINGLE_B1_N[-1]:
            cost = banded_cost(n, 1, 1, 1, 1, 8)
            out = {"factor": device_us(lambda: bd.banded_factor(M, 1, 1),
                                       kernel="banded_factor_kernel"),
                   "solve": device_us(lambda: bd.banded_solve(f_k, b, 1, 1),
                                      kernel="banded_solve_kernel")}
            chain = banded_chain(n, 1, 1, "double")
            for kind in ("factor", "solve"):
                msg += (f" {kind}_device_us={fmt_us(out[kind])} bytes_bound_us="
                        f"{1e3 * bound(*cost[kind])['bound_ms']:.4f} chain_bound_us="
                        f"{1e6 * chain[kind][1]:.3f}")
            msg += f" | {smi}"
        log(msg)
        if not same:
            raise SystemExit(f"chip_smoke: the banded kernels at B=1 (n={n}) disagree with their "
                             f"plain versions")
    return out


def single_part(label, run, attempts_of, counted, banded, expected, smi):
    """One part of phase 13 with every count set to 0 just before it and
    read just after (the banded launches ``expected``, every other kernel
    none): attempts, host ms an attempt and wall seconds, logged."""
    import torch

    for k in counted:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    attempts = attempts_of()
    log(f"[13{label}] attempts={attempts} host_ms_per_attempt={1e3 * wall / attempts:.3f} "
        f"wall_s={wall:.4f} | {smi}")
    structured_counts(f"13{label}", counted, banded, expected)
    return out


def single_attempts(solve) -> int:
    st = solve.last_stats
    return st["forward"]["n_attempts"] + st.get("backward", {}).get("n_attempts", 0)


def single_phase(smi, counted, banded_builds) -> dict:
    """Phase 13: the single-chain surface on the card.  (0) the banded
    kernels at B=1; (a) ``entry.build_lv_single`` on lanes 0-1 of
    lv_adjoint.npz: status 0, the golden gate (rtol 2e-3, atol 1e-3) and
    within 1e-6 of the CPU's run in a worker; (b)
    ``entry.build_kpp_single(128, 'band')``'s gradient within rtol 1e-4 /
    atol 1e-8 of the dense solver's, the banded launches equal to the
    Newton solver's factor and solve calls; (c) ``solve_ivp`` with a
    ``torch.autograd`` gradient on the sympy LV (the README's quickstart),
    within 1e-6 of the CPU; (d) per-lane grids through ``solve_lanes`` on
    lanes 0-1, within 1e-6 of the CPU.  Returns the phase's banded launches
    by build and the B=1 device times."""
    import torch

    from sunode_torch.entry import LV_P_FIX, build_kpp_single, build_lv_single
    from sunode_torch.wrappers.as_torch import solve_ivp

    b1 = banded_single_lane(smi)
    banded = BandedCounts(banded_builds)
    counted = (*counted, banded)
    none = {"factor": 0, "solve": 0}
    golden = np.load(os.path.join(HERE, "tests", "golden", "lv_adjoint.npz"))
    f64 = dict(dtype=torch.float64, device="cuda")

    # (a) one LV chain at a time through the default single-chain call
    step, (y0s, p_subs) = build_lv_single(SINGLE_LANES, device="cuda")
    grads = []
    for lane in range(SINGLE_LANES):
        gy, gp = single_part(f"(a) lv single lane {lane}", lambda: step(y0s[lane], p_subs[lane]),
                             lambda: single_attempts(step.solve), counted, banded, none, smi)
        grads.append((gy.cpu().numpy(), gp.cpu().numpy()))
        st = step.solve.last_stats
        np.testing.assert_allclose(grads[-1][0], golden["gy"][lane], rtol=2e-3, atol=1e-3)
        np.testing.assert_allclose(grads[-1][1], golden["gp"][lane], rtol=2e-3, atol=1e-3)
        if not (st["forward"]["status"] == 0 and st["backward"]["status"] == 0):
            raise SystemExit("chip_smoke: 13(a): a solve failed")
    ref = cpu_ref(ref_single)
    worst = max(max_rel(g, r) for g, r in zip(grads, ref["lanes"]))
    log(f"[13(a) check] lanes 0-{SINGLE_LANES - 1} status 0, golden gate passed, cuda_vs_cpu "
        f"max_rel={worst:.3e} (bound 1e-6; the CPU took {ref['wall_a']:.2f} s in a worker)")
    if not worst <= 1e-6:
        raise SystemExit("chip_smoke: 13(a) disagrees with the CPU")
    log_elapsed("13a")

    # (b) the banded Newton at one lane, against the dense solver's gradient
    _, kpp_grad, (y0, p, _) = build_kpp_single(SINGLE_KPP_N, "band", device="cuda")
    launches = {id(k): [0, 0] for k in banded_builds}

    def kpp_run():
        out = kpp_grad(y0, p)
        for k in banded_builds:
            launches[id(k)][0] += k.factor_launches
            launches[id(k)][1] += k.solve_launches
        return out

    def kpp_expected():
        st = kpp_grad.solve.last_stats
        return expected_banded({k: st["forward"][k] + st["backward"][k]
                                for k in ("n_linear_factors", "n_linear_solves")}, False)

    for k in counted:  # the expected counts read the solve's stats after it
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_band = kpp_run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    attempts = single_attempts(kpp_grad.solve)
    log(f"[13(b) kpp single band] n={SINGLE_KPP_N} attempts={attempts} host_ms_per_attempt="
        f"{1e3 * wall / attempts:.3f} wall_s={wall:.4f} | {smi}")
    structured_counts("13(b) kpp single band", counted, banded, kpp_expected())
    dense = cpu_ref(ref_kpp_single_dense)
    g_band = [g.cpu().numpy() for g in g_band]
    close = all(np.allclose(a, d, rtol=1e-4, atol=1e-8) for a, d in zip(g_band, dense["grads"]))
    rel = max(float(np.max(np.abs(a - d) / (np.abs(d) + 1e-4)))
              for a, d in zip(g_band, dense["grads"]))
    log(f"[13(b) check] band against dense: max |diff| / (|dense| + 1e-4) = {rel:.3e} within "
        f"rtol 1e-4 / atol 1e-8: {close} (the dense solver's gradient on the CPU took "
        f"{dense['wall']:.2f} s for {dense['attempts']} attempts in a worker process)")
    if not close:
        raise SystemExit("chip_smoke: 13(b): the banded gradient disagrees with the dense one")
    log_elapsed("13b")

    # (c) the quickstart: solve_ivp with a torch.autograd gradient
    box = {}

    def ivp_run():
        alpha = torch.tensor(1.0, **f64, requires_grad=True)
        res = solve_ivp(**single_ivp_kwargs(alpha), device="cuda")
        box["res"] = res
        return torch.autograd.grad(torch.sum(res.solution["hares"] ** 2), alpha)[0]

    g_ivp = float(single_part("(c) solve_ivp", ivp_run,
                              lambda: single_attempts(box["res"].solve_fn), counted, banded,
                              none, smi))
    rel = abs(g_ivp - ref["ivp"]) / abs(ref["ivp"])
    log(f"[13(c) check] d/dalpha={g_ivp:.10e} cuda_vs_cpu rel={rel:.3e} (bound 1e-6)")
    if not rel <= 1e-6:
        raise SystemExit("chip_smoke: 13(c) disagrees with the CPU")
    log_elapsed("13c")

    # (d) per-lane grids with gradients: the lane loop
    lanes_solve = single_lanes_solve()
    tvals_b = torch.as_tensor(single_lane_grids(), **f64)
    p_fix = torch.as_tensor(LV_P_FIX, **f64)
    attempts_d = []

    def lanes_run():
        gy, gp = single_lanes_grads(_CountingSolve(lanes_solve, attempts_d), y0s, p_subs,
                                    tvals_b, p_fix)
        return gy, gp

    gy, gp = single_part("(d) per-lane route", lanes_run, lambda: sum(attempts_d), counted,
                         banded, none, smi)
    rel = max_rel((gy.cpu().numpy(), gp.cpu().numpy()), ref["per_lane"])
    log(f"[13(d) check] {SINGLE_LANES} lanes on their own grids, cuda_vs_cpu max_rel={rel:.3e} "
        f"(bound 1e-6; the CPU's references of 13(a), (c) and (d) took {ref['wall']:.2f} s "
        f"in a worker)")
    if not rel <= 1e-6:
        raise SystemExit("chip_smoke: 13(d) disagrees with the CPU")
    log_elapsed("13")
    return {"launches": launches, "b1": b1}


class _CountingSolve:
    """A single-chain solve that adds each call's forward attempts to
    ``attempts``, and its backward's once the backward has run (a hook on
    the gradient node, which runs after it)."""

    def __init__(self, solve, attempts):
        self.solve, self.attempts = solve, attempts

    def __call__(self, *args):
        ys = self.solve(*args)
        self.attempts.append(self.solve.last_stats["forward"]["n_attempts"])
        ys.grad_fn.register_hook(lambda *_: self.attempts.append(
            self.solve.last_stats["backward"]["n_attempts"]))
        return ys


# ---- phase 14: the class API and events ----------------------------------------------
LV_FORWARD_GATE = (2e-7, 2e-9)  # tests/test_golden.py:54's rtol, atol on lv_forward.npz
LV_FORWARD_CPU_LANES = 4  # 14(a): lanes 0-3 on the CPU, within 1e-8
CLASS_TVALS = np.linspace(0.5, 8.0, 7)  # 14(b): tests/test_solver_modes.py's README chain
CLASS_PARAMS = {"alpha": 1.0, "beta": 0.3, "gamma": 1.0, "delta": 0.4}
CLASS_Y0 = (10.0, 2.0)
CLASS_KINDS = (("BDF", "BDF"), ("ADAMS", "ADAMS"))  # 14(b): solver, adjoint_solver
SWEEP_LANES = 4  # 14(c): the restitution sweep's lanes
SWEEP_E = (0.5, 0.9)  # its restitutions, evenly spaced
PHASE14_BUDGET_S = 45.0  # the phase's wall time on a host like PERF.md's run 1


def ref_lv_forward() -> dict:
    """14(a)'s CPU reference: lanes 0-3 of ``entry.build_lv_forward``."""
    from sunode_torch.entry import build_lv_forward

    t0 = time.perf_counter()
    solve, (y0s, ps, tvals) = build_lv_forward(LV_FORWARD_CPU_LANES, device="cpu")
    return dict(ys=solve(y0s, ps, tvals), wall=time.perf_counter() - t0)


def class_adjoint(kinds, device) -> dict:
    """14(b)'s case on ``device``: ``AdjointSolver(interpolation='hermite',
    solver, adjoint_solver)`` forward and backward with unit cotangents;
    ``ys``, ``grad``, ``lam`` and the attempts of both passes."""
    from sunode_torch.entry import lv_problem
    from sunode_torch.solver import AdjointSolver

    solver, adjoint_solver = kinds
    # the torch cores on the CPU too (native_single=False), as on the card
    s = AdjointSolver(lv_problem(), interpolation="hermite", solver=solver,
                      adjoint_solver=adjoint_solver, device=device, native_single=False)
    s.set_params_dict(CLASS_PARAMS)
    ys = s.solve_forward(0.0, CLASS_TVALS, np.array(CLASS_Y0))
    fwd = int(s.last_stats["n_attempts"])
    grad, lam = s.solve_backward(CLASS_TVALS[-1], 0.0, CLASS_TVALS,
                                 np.ones((len(CLASS_TVALS), 2)))
    return dict(ys=ys, grad=grad, lam=lam, fwd=fwd, bwd=int(s.last_stats["n_attempts"]))


def ref_class_adjoint() -> dict:
    """14(b)'s CPU references, both cases."""
    t0 = time.perf_counter()
    out = {kinds: class_adjoint(kinds, "cpu") for kinds in CLASS_KINDS}
    return dict(cases=out, wall=time.perf_counter() - t0)


def ball_event_closed_forms():
    """The ball dropped from h0 at rest (``entry.BALL_H``, ``BALL_G``): t* =
    sqrt(2 h0 / g), dt*/dg = -t*/(2 g), dt*/dh0 = 1/(g t*)."""
    from sunode_torch.entry import BALL_G, BALL_H

    t_star = np.sqrt(2 * BALL_H / BALL_G)
    return t_star, -t_star / (2 * BALL_G), 1.0 / (BALL_G * t_star)


def hybrid_closed_form(h0, g, e, t, K=3):
    """The bouncing ball's impact times t_1..t_K and its state at ``t``
    after the K-th impact (before the next), as torch expressions of
    ``(h0, g, e)``, so that ``torch.autograd`` takes their exact
    derivatives: t_1 = sqrt(2 h0 / g), t_{k+1} = t_k + 2 e^k t_1, and
    after t_K the ball rises at e^K g t_1."""
    import torch

    t1 = torch.sqrt(2 * h0 / g)
    ts = [t1]
    for k in range(1, K):
        ts.append(ts[-1] + 2 * e**k * t1)
    vK = e**K * g * t1
    s = t - ts[-1]
    return torch.stack(ts), torch.stack([vK * s - 0.5 * g * s**2, vK - g * s])


def timed_part(label, run, attempts_of, counted, smi):
    """One part of phase 14 with every count set to 0 just before it:
    its output, attempts and wall seconds, logged."""
    import torch

    for k in counted:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    attempts = attempts_of(out)
    log(f"[14{label}] attempts={attempts} host_ms_per_attempt={1e3 * wall / attempts:.3f} "
        f"wall_s={wall:.4f} | {smi}")
    return out, attempts, wall


def class_api_phase(smi, counted, kab11) -> dict:
    """Phase 14: the class API and events on the card (the module
    docstring's list).  ``kab11`` are phase 7's history builds (forward,
    resolve, staged_adjoint), which the Solver's and AdjointSolver's
    emitted systems reuse.  Returns the phase's launches by build."""
    import torch

    from sunode_torch.entry import build_ball_event, build_ball_hybrid, build_lv_forward
    from sunode_torch.events import map_lanes

    t_phase = time.perf_counter()
    launches = {kind: 0 for kind in kab11}
    golden = np.load(os.path.join(HERE, "tests", "golden", "lv_forward.npz"))

    # (a) lv_forward through the Solver at B=10,000
    solve, (y0s, ps, tvals) = build_lv_forward(B_MAIN, device="cuda")
    ys, attempts, wall = timed_part(
        "(a) lv_forward Solver", lambda: solve(y0s, ps, tvals),
        lambda _: int(solve.solver.last_stats["n_attempts"]), counted, smi)
    got = check_launches("14(a)", counted, {"forward": kab11["forward"]}, {"forward": attempts})
    launches["forward"] += got["forward"]
    if not (ys.shape == (B_MAIN, len(tvals), 2) and np.isfinite(ys).all()):
        raise SystemExit("chip_smoke: 14(a): non-finite or misshapen outputs")
    rtol, atol = LV_FORWARD_GATE
    np.testing.assert_allclose(ys[:16], golden["ys"], rtol=rtol, atol=atol)
    gold = floored_rel(ys[:16], golden["ys"], atol)
    ref = cpu_ref(ref_lv_forward)
    cpu = max_rel([ys[:LV_FORWARD_CPU_LANES]], [ref["ys"]])
    log(f"[14(a) check] B={B_MAIN} status 0 everywhere (the Solver raises otherwise); "
        f"golden max |diff|/(|ref|+atol)={gold:.3e} within rtol {rtol:g} / atol {atol:g}; "
        f"cuda_vs_cpu lanes 0-{LV_FORWARD_CPU_LANES - 1} max_rel={cpu:.3e} (bound 1e-8; the "
        f"CPU took {ref['wall']:.2f} s in a worker); us_per_chain={1e6 * wall / B_MAIN:.3f}")
    if not cpu <= 1e-8:
        raise SystemExit("chip_smoke: 14(a) disagrees with the CPU")
    log_elapsed("14a")

    # (b) AdjointSolver at B=1, BDF/BDF and ADAMS/ADAMS
    refs = cpu_ref(ref_class_adjoint)
    out = {}
    for kinds in CLASS_KINDS:
        res, attempts, _ = timed_part(f"(b) AdjointSolver {kinds[0]}/{kinds[1]}",
                                      lambda: class_adjoint(kinds, "cuda"),
                                      lambda r: r["fwd"] + r["bwd"], counted, smi)
        expected = {"staged_adjoint": res["bwd"]} if kinds[1] == "ADAMS" else {}
        got = check_launches(f"14(b) {kinds[1]} backward", counted,
                             {"staged_adjoint": kab11["staged_adjoint"]}, expected)
        launches["staged_adjoint"] += got.get("staged_adjoint", 0)
        cref = refs["cases"][kinds]
        rel = max_rel([res[k] for k in ("ys", "grad", "lam")],
                      [cref[k] for k in ("ys", "grad", "lam")])
        log(f"[14(b) check] {kinds[0]}/{kinds[1]} fwd_attempts={res['fwd']} "
            f"bwd_attempts={res['bwd']} grad={res['grad']} lamda={res['lam']} cuda_vs_cpu "
            f"max_rel={rel:.3e} (bound 1e-6)")
        if not rel <= 1e-6:
            raise SystemExit(f"chip_smoke: 14(b) {kinds} disagrees with the CPU")
        out[kinds] = res
    bdf, adams = out[CLASS_KINDS[0]], out[CLASS_KINDS[1]]
    np.testing.assert_allclose(adams["ys"], bdf["ys"], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(adams["grad"], bdf["grad"], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(adams["lam"], bdf["lam"], rtol=1e-3, atol=1e-6)
    log(f"[14(b) check] ADAMS against BDF within the test's tolerances (the CPU's two cases "
        f"took {refs['wall']:.2f} s in a worker)")
    log_elapsed("14b")

    # (c) events: the ball's event time, the hybrid's impacts, the sweep
    t_star, dt_dg, dt_dh = ball_event_closed_forms()
    for derivatives in ("forward", "adjoint"):
        event, (y0, p_sub, p_fix, t_max) = build_ball_event(derivatives, device="cuda")

        def event_run():
            y, p = y0.clone().requires_grad_(True), p_sub.clone().requires_grad_(True)
            t_ev, _ = event(0.0, y, p, p_fix, t_max)
            return (float(t_ev.detach()), *torch.autograd.grad(t_ev, (p, y)))

        (t_ev, g_p, g_y), _, _ = timed_part(f"(c) event {derivatives}", event_run,
                                            lambda _: event.last_stats["n_attempts"], counted,
                                            smi)
        check_launches(f"14(c) event {derivatives}", counted, {}, {})
        errs = (abs(t_ev - t_star), abs(float(g_p[0]) - dt_dg), abs(float(g_y[0]) - dt_dh))
        log(f"[14(c) check] event {derivatives}: t*={t_ev:.15f} |t*-closed|={errs[0]:.3e} "
            f"|dt/dg-closed|={errs[1]:.3e} |dt/dh0-closed|={errs[2]:.3e} (bound 1e-6)")
        if not max(errs) <= 1e-6:
            raise SystemExit(f"chip_smoke: 14(c) event {derivatives} is off the closed forms")

    hybrid, (y0, p_sub, p_fix, tv) = build_ball_hybrid(3, device="cuda")
    cpu64 = dict(dtype=torch.float64)

    def hybrid_run():
        theta = torch.tensor([float(y0[0]), float(p_sub[1])], device="cuda",
                             **cpu64).requires_grad_(True)
        y = torch.stack([theta[0], torch.zeros((), device="cuda", **cpu64)])
        p = torch.stack([p_sub[0], theta[1]])
        res = hybrid(0.0, y, p, p_fix, tv)
        return res, torch.autograd.grad(torch.sum(res.ys[-1] ** 2), theta)[0]

    (res, g_theta), _, _ = timed_part("(c) hybrid 3 impacts", hybrid_run,
                                      lambda _: hybrid.last_stats["n_attempts"], counted, smi)
    check_launches("14(c) hybrid", counted, {}, {})
    theta = torch.tensor([float(y0[0]), float(p_sub[1])], **cpu64).requires_grad_(True)
    ts_cf, yK = hybrid_closed_form(theta[0], torch.tensor(float(p_sub[0]), **cpu64), theta[1],
                                   float(tv[-1]))
    g_cf = torch.autograd.grad(torch.sum(yK**2), theta)[0].numpy()
    errs = (float(np.max(np.abs(res.event_ts.detach().cpu().numpy() - ts_cf.detach().numpy()))),
            float(np.max(np.abs(g_theta.cpu().numpy() - g_cf))))
    log(f"[14(c) check] hybrid n_events={int(res.n_events)} impact times "
        f"{res.event_ts.detach().cpu().numpy()} max |t-closed|={errs[0]:.3e}; d sum(y(2.2)^2) / "
        f"d(h0, e)={g_theta.cpu().numpy()} max |g-closed|={errs[1]:.3e} (bound 1e-6)")
    if not (int(res.n_events) == 3 and max(errs) <= 1e-6):
        raise SystemExit("chip_smoke: 14(c): the hybrid solve is off the closed forms")

    # the sweep takes values only: its solves carry no sensitivities
    values, _ = build_ball_hybrid(3, derivatives=None, device="cuda")
    es = torch.linspace(*SWEEP_E, SWEEP_LANES, device="cuda", **cpu64)

    lane_attempts = []

    def lane(e):
        res = values(0.0, y0, torch.stack([p_sub[0], e]), p_fix, tv)
        lane_attempts.append(values.last_stats["n_attempts"])
        return res

    sweep, _, wall = timed_part(f"(c) restitution sweep B={SWEEP_LANES}",
                                lambda: map_lanes(lane, es, in_dims=(0,)),
                                lambda _: sum(lane_attempts), counted, smi)
    check_launches("14(c) sweep", counted, {}, {})
    worst = 0.0
    for b, e in enumerate(es.cpu().tolist()):
        ts_b, _ = hybrid_closed_form(torch.tensor(float(y0[0]), **cpu64),
                                     torch.tensor(float(p_sub[0]), **cpu64),
                                     torch.tensor(e, **cpu64), float(tv[-1]))
        worst = max(worst, float(np.max(np.abs(sweep.event_ts[b].cpu().numpy() - ts_b.numpy()))))
    log(f"[14(c) check] sweep n_events={sweep.n_events.cpu().tolist()} max |t-closed|="
        f"{worst:.3e} (bound 1e-6) ms_per_lane={1e3 * wall / SWEEP_LANES:.1f}")
    if not (bool((sweep.n_events == 3).all()) and worst <= 1e-6):
        raise SystemExit("chip_smoke: 14(c): the restitution sweep is off the closed forms")
    wall = time.perf_counter() - t_phase
    log(f"[14] phase wall_s={wall:.1f} (budget {PHASE14_BUDGET_S:.0f} s on a host like run 1's) "
        f"| {smi}")
    log_elapsed("14")
    return launches


# ---- phase 15: the sampler path (NUTS) and the PyTensor wrapper ------------------
NUTS_CHAINS = 512  # scripts/exp_nuts_f32.py's --chains: BASELINE config 4 at full width
NUTS_CPU_CHAINS = 16  # 15(a): chains 0-15 on the CPU, with those chains' rows of the draws
NUTS_START = (0.01, 1)  # 15(a), (b): log(1.0, 0.3) + 0.01 N(0, 1), default_rng(1)
NUTS_EPS = 0.004  # 15(a)'s fixed step size (unit mass): trees of depth 1 to 4 uncapped, accept 0.88-1
NUTS_TREEDEPTH = 3  # 15(a): cut from the script's 6 (to 4, then to 3 to make room for phase 17)
NUTS_SEED = 15  # 15(a)'s draw source; (b) takes NUTS_SEED + 1
NUTS_REL = 1e-8  # 15(a): the card against the CPU
# 15(b): the mass swap at warmup draw 1; depth cut to 2 (the script's 6)
NUTS_RUN = dict(num_warmup=2, num_samples=2, max_treedepth=2, initial_step_size=NUTS_EPS)
NUTS_MAX_DIVERGENT = 0.05  # 15(b): the share of divergent kept draws
PYTENSOR_TVALS = np.linspace(0.5, 8.0, 7)  # 15(c): tests/test_pytensor.py's graph
PYTENSOR_POINT = (1.0, 0.3, 10.0)  # alpha, beta, y0 of the hares
PYTENSOR_REL = 1e-10  # 15(c): the card against the CPU
PYTENSOR_CASES = (("adjoint", None), ("forward", "simultaneous"))


class CountingLogp:
    """A log density that counts its batched gradient evaluations and the
    attempts of their solves: each call adds the previous call's forward
    and backward attempts (its backward has run by then, as the sampler
    takes a gradient of every call), ``totals()`` the last call's."""

    def __init__(self, logp):
        self.logp, self.calls, self.fwd, self.bwd = logp, 0, 0, 0
        self._pending = False
        self._stale = None  # the backward stats before the pending call's gradient

    def _harvest(self):
        if self._pending:
            stats = self.logp.solve.last_stats
            if stats.get("backward") is None or stats["backward"] is self._stale:
                raise SystemExit("chip_smoke: a log density call had no gradient")
            self.fwd += int(stats["forward"]["n_attempts"])
            self.bwd += int(stats["backward"]["n_attempts"])
            self._pending = False

    def __call__(self, theta):
        self._harvest()
        self.calls += 1
        out = self.logp(theta)
        self._pending, self._stale = True, self.logp.solve.last_stats.get("backward")
        return out

    def totals(self) -> dict:
        self._harvest()
        return {"forward": self.fwd, "transition": self.bwd}


def nuts_transition(device, chains, profile=None) -> dict:
    """15(a)'s case on ``device`` over chains ``0 .. chains - 1`` of the
    NUTS_CHAINS chains (their rows of the draws): the start's gradient and
    one transition at NUTS_EPS, unit mass, max_treedepth NUTS_TREEDEPTH;
    the outputs as numpy, with the gradients and attempts counted.
    ``profile(run, attempts)``, where given, runs the start's gradient (the
    card's: under the profiler, with the counts set to 0) and returns it;
    ``res['start_attempts']`` are its attempts by build."""
    import torch

    from sunode_torch.entry import build_lv_nuts, lv_nuts_init
    from sunode_torch.sample.nuts import ChainRows, TorchDraws, _transition, _value_and_grad_batched

    t0 = time.perf_counter()
    logp, _ = build_lv_nuts(chains, device=device)
    counting = CountingLogp(logp)
    f_kw = dict(dtype=torch.float64, device=device)
    q0 = torch.as_tensor(lv_nuts_init(NUTS_CHAINS, *NUTS_START)[:chains], **f_kw)
    draws = ChainRows(TorchDraws(NUTS_SEED), NUTS_CHAINS, slice(0, chains))
    start = lambda: _value_and_grad_batched(counting, q0)  # noqa: E731
    lp0, g0 = start() if profile is None else profile(start, lambda: sum(counting.totals().values()))
    start_attempts = counting.totals()
    t1 = time.perf_counter()
    out = _transition(counting, q0, lp0, g0, NUTS_EPS, torch.ones(2, **f_kw), draws.transition(),
                      NUTS_TREEDEPTH, return_leaf=True)
    totals = counting.totals()
    names = ("q", "logp", "grad", "accept", "diverged", "depth", "leaf")
    res = {k: v.cpu().numpy() for k, v in zip(names, out)}
    res.update(q0=q0.cpu().numpy(), logp0=lp0.cpu().numpy(), grad0=g0.cpu().numpy(),
               calls=counting.calls, start_attempts=start_attempts,
               attempts={k: totals[k] - start_attempts[k] for k in totals},
               wall=time.perf_counter() - t0, transition_wall=time.perf_counter() - t1)
    return res


def ref_nuts_transition() -> dict:
    """15(a)'s CPU reference: chains 0-15 (NUTS_CPU_CHAINS)."""
    return nuts_transition("cpu", NUTS_CPU_CHAINS)


def pytensor_case(derivatives, sens_mode, device) -> dict:
    """15(c)'s case on ``device``: tests/test_pytensor.py's graph (LV, 7
    times on [0.5, 8]) through the port's PyTensor wrapper (its Op-protocol
    shim where pytensor is not installed), the loss sum(ys**2) and its
    gradients to alpha, beta and y0 compiled with ``pytensor.function`` and
    evaluated at PYTENSOR_POINT; the outputs, the seconds and the solver's
    attempts."""
    from sunode_torch._compat.pt_shim import install

    install()
    import pytensor
    import pytensor.tensor as pt

    from sunode_torch.entry import _lv
    from sunode_torch.wrappers.as_pytensor import solve_ivp

    t0 = time.perf_counter()
    alpha, beta, y0_h = pt.dscalar("alpha"), pt.dscalar("beta"), pt.dscalar("y0_h")
    # the torch cores on the CPU too (native_single=False), as on the card
    kwargs = {"device": device, "native_single": False}
    if sens_mode is not None:
        kwargs["sens_mode"] = sens_mode
    solved = solve_ivp(
        t0=0.0, y0={"hares": (y0_h, ()), "lynx": (np.float64(2.0), ())},
        params={"alpha": (alpha, ()), "beta": (beta, ()), "gamma": np.float64(1.0),
                "delta": np.float64(0.4), "extra": np.zeros(1)},
        tvals=PYTENSOR_TVALS, rhs=_lv, derivatives=derivatives, solver_kwargs=kwargs,
    )
    flat = solved[1]
    loss = (flat**2).sum()
    grads = pytensor.grad(loss, [alpha, beta, y0_h])
    f = pytensor.function([alpha, beta, y0_h], [loss, flat, *grads])
    t1 = time.perf_counter()
    out = [np.asarray(x) for x in f(*PYTENSOR_POINT)]
    return dict(out=out, compile_s=t1 - t0, eval_s=time.perf_counter() - t1,
                attempts=int(solved[3].last_stats["n_attempts"]))


def ref_pytensor() -> dict:
    """15(c)'s CPU references, both cases."""
    return {case: pytensor_case(*case, "cpu") for case in PYTENSOR_CASES}


def sampler_phase(smi, counted, history_kernels) -> dict:
    """Phase 15: the sampler path on the card (the module docstring's
    list).  ``history_kernels`` are the main path's builds (forward,
    transition), which ``entry.build_lv_nuts``'s solves launch.  Returns the
    phase's launches by build."""
    import torch

    from sunode_torch.entry import build_lv_nuts, lv_nuts_init
    from sunode_torch.sample import nuts_sample

    t_phase = time.perf_counter()
    launches = {kind: 0 for kind in history_kernels}

    # (a) one transition at 512 chains against chains 0-15 on the CPU; its
    # start's gradient under the profiler, which is also the warm-up, with
    # the counts set to 0 just before it and read just after, then again
    # for the transition
    def profiled(run, attempts):
        box = {}
        drive("15(a) start gradient", lambda: box.setdefault("out", run()), attempts, counted,
              smi)
        return box["out"]

    torch.cuda.synchronize()
    res = nuts_transition("cuda", NUTS_CHAINS, profile=profiled)
    torch.cuda.synchronize()
    log(f"[15(a) launches] the start's and the transition's, one count; the start's attempts "
        f"{res['start_attempts']}")
    expected = {k: res["attempts"][k] + res["start_attempts"][k] for k in res["attempts"]}
    got = check_launches("15(a)", counted, history_kernels, expected)
    for kind, n in got.items():
        launches[kind] += n
    attempts = sum(res["attempts"].values())
    log(f"[15(a) transition] C={NUTS_CHAINS} eps={NUTS_EPS} max_treedepth={NUTS_TREEDEPTH} "
        f"gradients={res['calls'] - 1} (and the start's) attempts fwd={res['attempts']['forward']} "
        f"bwd={res['attempts']['transition']} wall_s={res['transition_wall']:.3f} "
        f"host_ms_per_attempt={1e3 * res['transition_wall'] / attempts:.3f} "
        f"s_per_gradient={res['transition_wall'] / (res['calls'] - 1):.3f} "
        f"depth={np.bincount(res['depth']).tolist()} diverged={int(res['diverged'].sum())} "
        f"accept_mean={float(res['accept'].mean()):.4f} | {smi}")
    ref = cpu_ref(ref_nuts_transition)
    n = NUTS_CPU_CHAINS
    exact = all(np.array_equal(res[k][:n], ref[k]) for k in ("depth", "diverged", "leaf"))
    rel = max(float(np.max(np.abs(res[k][:n] - ref[k]) / np.maximum(np.abs(ref[k]), 1e-300)))
              for k in ("q", "logp", "grad", "accept", "logp0", "grad0"))
    log(f"[15(a) check] chains 0-{n - 1}: depth, divergence and the proposal's leaf equal: "
        f"{exact} (leaves {res['leaf'][:n].tolist()}); q, logp, grad, accept, logp0, grad0 "
        f"max_rel={rel:.3e} (bound {NUTS_REL:g}); the CPU took {ref['wall']:.2f} s "
        f"({ref['calls']} gradients) in a worker")
    if not (exact and rel <= NUTS_REL):
        raise SystemExit("chip_smoke: 15(a): the card's transition disagrees with the CPU")
    log_elapsed("15a")

    # (b) a short sampling run over the 512 chains through nuts_sample
    logp, _ = build_lv_nuts(NUTS_CHAINS, device="cuda")
    q_start = torch.as_tensor(lv_nuts_init(NUTS_CHAINS, *NUTS_START), dtype=torch.float64,
                              device="cuda")
    counting = CountingLogp(logp)
    for k in counted:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = nuts_sample(counting, NUTS_SEED + 1, q_start, **NUTS_RUN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = counting.totals()
    got = check_launches("15(b) nuts_sample", counted, history_kernels, totals)
    for kind, n in got.items():
        launches[kind] += n
    samples = run.samples.cpu().numpy()
    n_draws = NUTS_RUN["num_warmup"] + NUTS_RUN["num_samples"]
    moved = int(np.any(samples != q_start.cpu().numpy()[:, None, :], axis=(1, 2)).sum())
    div_share = float(run.diverging.float().mean())
    acc = run.accept_prob.cpu().numpy()
    attempts = sum(totals.values())
    log(f"[15(b) nuts_sample] C={NUTS_CHAINS} warmup={NUTS_RUN['num_warmup']} "
        f"kept={NUTS_RUN['num_samples']} max_treedepth={NUTS_RUN['max_treedepth']} wall_s={wall:.3f} "
        f"leapfrogs={counting.calls} (batched gradients, the step-size search's included) "
        f"chain_gradients_per_s={NUTS_CHAINS * counting.calls / wall:.1f} "
        f"draws_per_s={NUTS_CHAINS * n_draws / wall:.2f} attempts fwd={totals['forward']} "
        f"bwd={totals['transition']} host_ms_per_attempt={1e3 * wall / attempts:.3f} "
        f"step_size={run.step_size:.6g} inv_mass={run.inv_mass.cpu().numpy().tolist()} "
        f"depths={np.bincount(run.tree_depth.cpu().numpy().ravel()).tolist()} | {smi}")
    ok = (np.isfinite(samples).all() and bool(torch.isfinite(run.logp).all())
          and moved == NUTS_CHAINS and div_share < NUTS_MAX_DIVERGENT
          and bool(((acc >= 0) & (acc <= 1)).all())
          and np.isfinite(run.step_size) and run.step_size > 0)
    log(f"[15(b) check] every draw finite: {bool(np.isfinite(samples).all())}; chains moved "
        f"{moved}/{NUTS_CHAINS}; divergent share {div_share:.4f} (bound {NUTS_MAX_DIVERGENT}); "
        f"accept in [{acc.min():.4f}, {acc.max():.4f}]; step size {run.step_size:.6g}")
    if not ok:
        raise SystemExit("chip_smoke: 15(b): the sampling run failed its gates")
    log_elapsed("15b")

    # (c) the PyTensor wrapper's Ops on the card (BDF: no kernel)
    refs = cpu_ref(ref_pytensor)
    for case in PYTENSOR_CASES:
        for k in counted:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pytensor_case(*case, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_launches(f"15(c) {case[0]}", counted, {}, {})
        want = refs[case]["out"]
        rel = max(float(np.max(np.abs(a - b) / np.abs(b))) for a, b in zip(res["out"], want))
        log(f"[15(c) pytensor {case[0]}{'' if case[1] is None else ' ' + case[1]}] "
            f"loss={float(res['out'][0]):.12g} d/d(alpha, beta, y0)="
            f"{[float(g) for g in res['out'][2:]]} wall_s={wall:.3f} (graph and compile "
            f"{res['compile_s']:.3f}, evaluation {res['eval_s']:.3f}; the last solve's attempts "
            f"{res['attempts']}) cuda_vs_cpu max_rel={rel:.3e} (bound {PYTENSOR_REL:g}) | {smi}")
        if not (all(np.isfinite(x).all() for x in res["out"]) and rel <= PYTENSOR_REL):
            raise SystemExit(f"chip_smoke: 15(c) {case}: the card disagrees with the CPU")
    log(f"[15] phase wall_s={time.perf_counter() - t_phase:.1f} | {smi}")
    log_elapsed("15")
    return launches


# ---- phase 16: the native host route and the chain split ---------------------------
NATIVE_REPS = 50  # (a), (b): the minimum over this many native solves or pairs, as bench.py's
CARD_REPS = 2  # (a), (b): solves or pairs on the card
LV_FORWARD_SINGLE_GATE = (1e-6, 1e-8)  # bench.py:266: rtol, atol against the 1e-13 BDF oracle
LV_ADJOINT_SINGLE_GATE = (2e-3, 1e-3)  # bench.py:142-143: rtol, atol against lv_adjoint.npz lane 0
SPLIT_REL = 1e-12  # (c): the bound for a lane that is not bit for bit phase 4's


def ref_native_build() -> dict:
    """Phase 16(d), the first job of the workers: g++ of the core library
    (``native/cvbdf.cpp``) and of LV's problem library into the build
    cache, which (a) and (b) then load; their seconds."""
    from sunode_torch.entry import lv_problem
    from sunode_torch.native import codegen

    t0 = time.perf_counter()
    codegen.native_lib_path()
    t1 = time.perf_counter()
    codegen.compile_problem_c(lv_problem())
    return dict(core_s=t1 - t0, problem_s=time.perf_counter() - t1)


def host_cpu() -> str:
    """The host's CPU model (``/proc/cpuinfo``, else ``lscpu``) and hardware
    threads."""
    import platform

    model = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith(("model name", "hardware")):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if model in ("", "unknown") and shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
        names = [ln.split(":", 1)[1].strip() for ln in out.splitlines()
                 if ln.startswith(("Model name", "Vendor ID"))]
        model = " ".join(n for n in names if n != "unknown") or model
    return f"{model or platform.machine()}, {os.cpu_count()} threads"


def min_us(run, reps) -> float:
    """The least wall µs of ``reps`` calls of ``run``."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return 1e6 * best


def card_reps(label, run, counted, smi) -> tuple:
    """``run()`` :data:`CARD_REPS` times on the card with every count set to
    0 before the first: the last output and the seconds of each."""
    import torch

    for k in counted:
        k.launches = 0
    walls = []
    for _ in range(CARD_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"[16{label} card] wall_s per call {[round(w, 4) for w in walls]} | {smi}")
    return out, walls


def quadrature_split(chunks) -> str:
    """The transition composition's quadrature contraction
    (``adjoint.py``'s ``einsum("bki,bkij->bj")``, 20 intervals, 2 x 2) on
    seeded inputs at B=10,000, whole against ``chunks`` contiguous chunks
    of the card: the lanes bit for bit and the largest difference (ROADMAP
    C10: its batched GEMM sums in an order that depends on the batch)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    f64 = dict(dtype=torch.float64, device="cuda")
    x = torch.randn(B_MAIN, 20, 2, generator=gen, **f64)
    W = torch.randn(B_MAIN, 20, 2, 2, generator=gen, **f64)
    whole = torch.einsum("bki,bkij->bj", x, W)
    split = torch.cat([torch.einsum("bki,bkij->bj", a, b)
                       for a, b in zip(x.chunk(chunks), W.chunk(chunks))])
    same = int((whole == split).all(dim=1).sum())
    return (f"the quadrature einsum bki,bkij->bj split the same way: bit for bit in "
            f"{same}/{B_MAIN} lanes, max |diff| {float((whole - split).abs().max()):.3e}")


def native_phase(smi, counted, kab9, kab11, main_inputs, main_grads) -> dict:
    """Phase 16 (the module docstring's list); ``kab9`` are the main path's
    history builds (forward, transition), ``kab11`` phase 7's (the card's
    B=1 backward reads staged_adjoint), ``main_inputs`` and ``main_grads``
    phase 4's inputs and gradients on the card.  Returns the phase's
    launches by build."""
    import torch

    from sunode_torch.entry import (build_lv_adjoint_sharded, build_lv_adjoint_single,
                                    build_lv_forward_single)
    from sunode_torch.parallel.mesh import Mesh, make_mesh

    t_phase = time.perf_counter()
    log(f"[16] host {host_cpu()} | {smi}")
    built = cpu_ref(ref_native_build)
    log(f"[16(d)] g++ in a worker: core library {built['core_s']:.2f} s, LV's problem library "
        f"{built['problem_s']:.2f} s (build/sunode_torch_native/)")

    # (a) lv_forward --batch 1: native on the CPU, the single Adams core on the card
    solve, _ = build_lv_forward_single(device="cpu")
    ys = solve()
    if not (solve.solver._native_eligible() and solve.solver._native_solver is not None):
        raise SystemExit("chip_smoke: 16(a) on the CPU did not take the native route")
    oracle = solve.oracle()
    rtol, atol = LV_FORWARD_SINGLE_GATE
    np.testing.assert_allclose(ys, oracle, rtol=rtol, atol=atol)
    us = min_us(solve, NATIVE_REPS)
    log(f"[16(a) native] lv_forward B=1 ADAMS rtol 1e-10: max_rel vs the 1e-13 BDF oracle "
        f"{max_rel([ys], [oracle]):.3e} (gate rtol {rtol:g} / atol {atol:g}) steps="
        f"{solve.solver.last_stats['n_steps']} min_us={us:.2f} over {NATIVE_REPS} | "
        f"{host_cpu()}")
    card, _ = build_lv_forward_single(device="cuda")
    cys, walls = card_reps("(a)", card, counted, smi)
    check_launches("16(a) card", counted, {}, {})
    attempts = int(card.solver.last_stats["n_attempts"])
    np.testing.assert_allclose(cys, oracle, rtol=rtol, atol=atol)
    log(f"[16(a) card check] max_rel vs the oracle {max_rel([cys], [oracle]):.3e}, vs native "
        f"{max_rel([cys], [ys]):.3e}; s_per_solve={min(walls):.4f} attempts={attempts} "
        f"ms_per_attempt={1e3 * min(walls) / attempts:.3f} | {smi}")
    log_elapsed("16a")

    # (b) lv_adjoint --batch 1: the native pair on the CPU, the card's pair at B=1
    golden = np.load(os.path.join(HERE, "tests", "golden", "lv_adjoint.npz"))
    rtol, atol = LV_ADJOINT_SINGLE_GATE
    pair, _ = build_lv_adjoint_single(device="cpu")
    _, gy, gp = pair()
    if "native_ys" not in pair.solver._last_forward:
        raise SystemExit("chip_smoke: 16(b) on the CPU did not take the native route")
    for got, key in ((gy, "gy"), (gp, "gp")):
        np.testing.assert_allclose(got, golden[key][0], rtol=rtol, atol=atol)
    us = min_us(pair, NATIVE_REPS)
    log(f"[16(b) native] lv_adjoint B=1 ADAMS/ADAMS: gy={gy} gp={gp} golden max_rel "
        f"{max_rel([gy, gp], [golden['gy'][0], golden['gp'][0]]):.3e} (gate rtol {rtol:g} / "
        f"atol {atol:g}) min_us_per_pair={us:.2f} over {NATIVE_REPS} | {host_cpu()}")
    cpair, _ = build_lv_adjoint_single(device="cuda")
    bwd = []

    def card_pair():
        out = cpair()
        bwd.append(int(cpair.solver.last_stats["n_attempts"]))
        return out

    (_, cgy, cgp), walls = card_reps("(b)", card_pair, counted, smi)
    got = check_launches("16(b) card", counted, {"staged_adjoint": kab11["staged_adjoint"]},
                         {"staged_adjoint": sum(bwd)})
    for g, key in ((cgy, "gy"), (cgp, "gp")):
        np.testing.assert_allclose(g, golden[key][0], rtol=rtol, atol=atol)
    log(f"[16(b) card check] gy={cgy} gp={cgp} max_rel vs the native pair "
        f"{max_rel([cgy, cgp], [gy, gp]):.3e}; s_per_pair={min(walls):.4f} backward attempts "
        f"{bwd[-1]} | {smi}")
    launches = {"staged_adjoint": got.get("staged_adjoint", 0), "forward": 0, "transition": 0}
    log_elapsed("16b")

    # (c) the main path's step split over a mesh: the one card, then two chunks on it
    y0s_t, p_subs_t = main_inputs
    gy4, gp4 = main_grads
    by_system = {"forward": kab9["forward"], "transition": kab9["transition"]}
    for label, mesh in (("make_mesh()", make_mesh()),
                        ("Mesh((cuda:0, cuda:0))", Mesh(("cuda:0", "cuda:0")))):
        step, _ = build_lv_adjoint_sharded(B_MAIN, mesh, 21, 1e-8)
        for k in counted:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gy, gp = step(y0s_t, p_subs_t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd = [int(s.last_stats["forward"]["n_attempts"]) for s in step.solves]
        bwd = [int(s.last_stats["backward"]["n_attempts"]) for s in step.solves]
        got = check_launches(f"16(c) {label}", counted, by_system,
                             {"forward": sum(fwd), "transition": sum(bwd)})
        for kind in ("forward", "transition"):
            launches[kind] += got.get(kind, 0)
        same = (gy == gy4).all(dim=1) & (gp == gp4).all(dim=1)
        worst = max_rel([gy.cpu().numpy(), gp.cpu().numpy()],
                        [gy4.cpu().numpy(), gp4.cpu().numpy()])
        log(f"[16(c) {label}] B={B_MAIN} over {mesh.size} chunk(s): wall_s={wall:.4f} "
            f"attempts fwd={fwd} bwd={bwd}; lanes bit for bit phase 4's: "
            f"{int(same.sum())}/{B_MAIN}, max_rel={worst:.3e} | {smi}")
        if not bool(same.all()):
            lanes = torch.nonzero(~same).flatten()[:16].tolist()
            log(f"[16(c) {label}] lanes not bit for bit (first 16): {lanes}; "
                f"{quadrature_split(mesh.size)}")
            if not worst <= SPLIT_REL:
                raise SystemExit(f"chip_smoke: 16(c) {label}: the split gradient is off phase 4's")
    log(f"[16] phase wall_s={time.perf_counter() - t_phase:.1f} | {smi}")
    log_elapsed("16")
    return launches


def main() -> None:
    card, smi = check_device()
    try:
        run(card, smi)
    finally:
        if CPU_REFS is not None:
            CPU_REFS.close()


def run(card, smi) -> None:
    global CPU_REFS
    import torch

    # the plain-path references run 16 lanes on the CPU, where torch's
    # batched LU of tiny matrices is far slower on many threads than on one
    torch.set_num_threads(1)

    from sunode_torch.entry import LV_P_FIX, build_lv_adjoint, lv_problem
    from sunode_torch.ops.adams_attempt import adams_history_attempt, build_attempt_kernel, c_real
    from sunode_torch.ops.adams_split import build_split_kernels
    from sunode_torch.ops.pece_2d import P_ORDER, build_pece_2d, lv_system, pece_2d_attempt
    from sunode_torch.entry import lv_spline_problem
    from sunode_torch.ops.banded import build_banded_kernels
    from sunode_torch.ops.pece_step import adams_pece_attempt, build_kernel
    from sunode_torch.symode import cuda_codegen

    # phase 2: build, one nvcc per kernel, all started together
    problem = lv_problem()
    systems = {
        "forward": cuda_codegen.forward_system(problem),
        "transition": cuda_codegen.transition_system(problem),
    }
    # phase 9's systems, at the main path's history depth
    sens_systems = {kind: getattr(cuda_codegen, f"{kind}_system")(problem) for kind in SENS_KINDS}
    # phase 7's systems, at its history depth
    adams_systems = {
        "forward": systems["forward"],
        "resolve": cuda_codegen.resolve_system(problem),
        "staged_adjoint": cuda_codegen.staged_adjoint_system(problem),
    }
    # phase 10's float32 builds: lv_adjoint_f32's systems, and the split kernels
    f32_systems = {kind: getattr(cuda_codegen, f"{kind}_system")(problem, "float")
                   for kind in F32_KINDS}
    # phase 12's: the banded kernels at the structured paths' bandwidths (1, 1)
    # and both types, the spline LV's forward and transition systems at both
    spline_problem = lv_spline_problem()
    spline_systems = {(kind, dt): getattr(cuda_codegen, f"{kind}_system")(spline_problem,
                                                                          c_real(dt))
                      for kind in SPLINE_KINDS for dt in (torch.float64, torch.float32)}
    banded_dtypes = (torch.float64, torch.float32)
    lv_system()  # emit the flat-history kernel's system before the threads need it
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2 * len(systems) + 3 + len(adams_systems) + len(sens_systems)
                            + len(f32_systems) + 1 + len(spline_systems)
                            + len(banded_dtypes)) as pool:
        futures = {kind: pool.submit(build_kernel, ds) for kind, ds in systems.items()}
        futures.update({
            f"history_{kind}": pool.submit(build_attempt_kernel, ds, P_MAX + 3)
            for kind, ds in {**systems, **sens_systems}.items()
        })
        futures["pece_2d"] = pool.submit(build_pece_2d, P_ORDER)
        futures.update({
            f"history_{kind}_kab{P_MAX_ADAMS + 3}": pool.submit(
                build_attempt_kernel, ds, P_MAX_ADAMS + 3)
            for kind, ds in adams_systems.items()
        })
        # the split kernels: one build per history depth and type, for any problem
        for kab in (P_MAX_ADAMS + 3, P_MAX + 3):
            futures[f"split_kab{kab}"] = pool.submit(build_split_kernels, kab)
        futures.update({f"history_{kind}_f32": pool.submit(build_attempt_kernel, ds, P_MAX + 3)
                        for kind, ds in f32_systems.items()})
        futures[f"split_kab{P_MAX_ADAMS + 3}_f32"] = pool.submit(
            build_split_kernels, P_MAX_ADAMS + 3, torch.float32)
        futures.update({f"banded_{dt}": pool.submit(build_banded_kernels, 1, 1, dt)
                        for dt in banded_dtypes})
        futures.update({f"history_spline_{kind}_{dt}": pool.submit(build_attempt_kernel, ds,
                                                                   P_MAX + 3)
                        for (kind, dt), ds in spline_systems.items()})
        built = {kind: f.result() for kind, f in futures.items()}
    for kind, k in built.items():
        regs = [ln.strip() for ln in k.build_log.splitlines() if "registers" in ln or "spill" in ln]
        log(f"[build {kind}] {k.build_seconds:.2f} s -> {k.lib_path.name}; "
            f"sass_instructions={sass_instructions(k.lib_path)}; ptxas: {'; '.join(regs)}")
    log(f"[build] all in {time.perf_counter() - t0:.2f} s")
    # the CPU references of phases 4-15, in worker processes from here
    CPU_REFS = submit_cpu_refs()
    log_elapsed("2")
    kernels = {kind: built[kind] for kind in systems}
    history_kernels = {kind: built[f"history_{kind}"] for kind in systems}
    sens_kernels = {kind: built[f"history_{kind}"] for kind in SENS_KINDS}
    adams_kernels = {kind: built[f"history_{kind}_kab{P_MAX_ADAMS + 3}"] for kind in adams_systems}
    f32_kernels = {kind: built[f"history_{kind}_f32"] for kind in F32_KINDS}
    f32_split = built[f"split_kab{P_MAX_ADAMS + 3}_f32"]
    banded_builds = {dt: built[f"banded_{dt}"] for dt in banded_dtypes}
    spline_kernels = {(kind, dt): built[f"history_spline_{kind}_{dt}"]
                      for kind, dt in spline_systems}

    # phase 3: kernel vs plain on the card
    fz = {kind: lv_plain_fz(problem, kind)
          for kind in ("forward", "transition", "resolve", "staged_adjoint")}
    table = {
        kind: compare_kernel(kind, systems[kind], fz[kind], seed)
        for seed, kind in enumerate(systems)
    }

    log_elapsed("3")

    # phase 3b: the flat-history kernel and its A/B
    entry_2d = pece_2d_phase(smi)
    log_elapsed("3b")

    # phase 3c: the history-attempt kernel vs its plain version
    history_table = {
        kind: compare_history_kernel(kind, systems[kind], fz[kind], seed)
        for seed, kind in enumerate(systems)
    }
    adams_table = {
        kind: compare_history_kernel(f"{kind} KAB={P_MAX_ADAMS + 3}", adams_systems[kind],
                                     fz[kind], seed, P_MAX_ADAMS, ADAMS_RTOL)
        for seed, kind in enumerate(adams_systems, start=len(systems))
    }

    log_elapsed("3c")

    # phase 3d: the split attempt's three kernels vs their plain stages
    split_table = split_phase(smi, built[f"split_kab{P_MAX_ADAMS + 3}"])
    log_elapsed("3d")

    # phase 4: the main path
    grad_step, _ = build_lv_adjoint(B_MAIN, 21, 1e-8, device="cuda")
    y0s, p_subs = lv_main_inputs()
    y0s_t = torch.as_tensor(y0s, dtype=torch.float64, device="cuda")
    p_subs_t = torch.as_tensor(p_subs, dtype=torch.float64, device="cuda")
    golden = np.load(os.path.join(HERE, "tests", "golden", "lv_adjoint.npz"))

    adams_pece_attempt.launches = adams_history_attempt.launches = 0
    split_count = SplitLaunches()
    for k in (*kernels.values(), *history_kernels.values(), split_count):
        k.launches = 0
    expected = {"forward": 0, "transition": 0}
    for step in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gy, gp = grad_step(y0s_t, p_subs_t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = grad_step.solve.last_stats
        expected["forward"] += stats["forward"]["n_attempts"]
        expected["transition"] += stats["backward"]["n_attempts"]
        log(
            f"[main-path step {step}] B={B_MAIN} wall_s={wall:.4f} "
            f"grads_per_s={B_MAIN / wall:.1f} attempts fwd={stats['forward']['n_attempts']} "
            f"bwd={stats['backward']['n_attempts']} | {smi}"
        )
    main_grads = (gy, gp)  # phase 16(c) holds its split steps to these
    log_elapsed("4, the timed steps")
    launches = {kind: k.launches for kind, k in history_kernels.items()}
    total = adams_history_attempt.launches
    pece_launches = {kind: k.launches for kind, k in kernels.items()}
    log(f"[main-path launches] history-attempt {launches} total={total} expected={expected}; "
        f"PECE kernel {pece_launches} total={adams_pece_attempt.launches}")
    if not (total > 0 and launches == expected and total == sum(expected.values())):
        raise SystemExit("chip_smoke: history-attempt launches do not match the attempts run")
    if adams_pece_attempt.launches != 0 or any(pece_launches.values()):
        raise SystemExit("chip_smoke: the main path launched the PECE kernel")
    if split_count.launches or RowsLaunches().launches:
        raise SystemExit("chip_smoke: the main path launched a split kernel")

    def step_attempts():
        stats = grad_step.solve.last_stats
        return stats["forward"]["n_attempts"] + stats["backward"]["n_attempts"]

    # the profiler's public event list counts the step's kernels too, as a
    # check of the raw-record count every phase uses; the profiled step
    # covers the first quarter of the horizon (building that list for a
    # whole step took 20.5 s after a 2.9 s step, on an H100 machine's host)
    short = leading_times(grad_step.tvals, MAIN_PROFILED_SHARE)
    prof = device_kernels_per_attempt(lambda: grad_step(y0s_t, p_subs_t, tvals=short),
                                      step_attempts, cross_check=True)
    log(
        f"[main-path device kernels per attempt] {prof['per_attempt']:.1f} "
        f"({prof['kernels']} kernels, {prof['copies']} copies and fills, "
        f"{prof['attempts']} attempts in one step to t = {float(short[-1]):g}; prof.events() "
        f"counts {prof['public'][0]} "
        f"and {prof['public'][1]}) device_busy_s={prof['busy_s']:.4f} "
        f"wall_s_under_profiler={prof['wall_s']:.4f} | {smi}"
    )

    log_elapsed("4, the profiled step")
    gy_np, gp_np = gy.cpu().numpy(), gp.cpu().numpy()
    finite = int(np.isfinite(gy_np).all(axis=1).sum() + 0)
    finite_p = int(np.isfinite(gp_np).all(axis=1).sum() + 0)
    if not (gy_np.shape == (B_MAIN, 2) and gp_np.shape == (B_MAIN, 2)
            and finite == B_MAIN and finite_p == B_MAIN):
        raise SystemExit(f"chip_smoke: non-finite gradients ({finite}, {finite_p} of {B_MAIN})")
    np.testing.assert_allclose(gy_np[:16], golden["gy"], rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(gp_np[:16], golden["gp"], rtol=2e-3, atol=1e-3)
    gold_rel = max(
        float(np.max(np.abs(gy_np[:16] - golden["gy"]) / np.abs(golden["gy"]))),
        float(np.max(np.abs(gp_np[:16] - golden["gp"]) / np.abs(golden["gp"]))),
    )

    # the same 16 lanes through the plain path on the CPU, in a worker
    cref = cpu_ref(ref_main_path)
    cy, cp = cref["gy"], cref["gp"]
    plain_rel = max(
        float(np.max(np.abs(gy_np[:16] - cy) / np.abs(cy))),
        float(np.max(np.abs(gp_np[:16] - cp) / np.abs(cp))),
    )
    log(
        f"[main-path check] finite={finite}/{B_MAIN} golden_max_rel={gold_rel:.3e} "
        f"(gate 2e-3) cuda_vs_cpu_plain_max_rel={plain_rel:.3e} (bound 1e-6; the CPU took "
        f"{cref['wall']:.2f} s in a worker) p_fix={LV_P_FIX}"
    )
    if not plain_rel <= 1e-6:
        raise SystemExit("chip_smoke: the CUDA main path disagrees with the plain path")
    log_elapsed("4")

    # phases 5, 5b and 6: the BDF paths, which launch none of the kernels;
    # each path's counts are set to 0 just before it and read just after
    counted = (adams_pece_attempt, adams_history_attempt, *kernels.values(),
               *history_kernels.values(), *adams_kernels.values(), *sens_kernels.values(),
               pece_2d_attempt, build_pece_2d(P_ORDER), *spline_kernels.values(),
               BandedCounts(tuple(banded_builds.values())), RowsLaunches(), split_count)
    for label, name, phase in (("5", "robertson", bdf_robertson_phase),
                               ("5b", "sens", bdf_sens_phase),
                               ("6", "checkpointed", checkpointed_phase)):
        for k in counted:
            k.launches = 0
        phase(smi)
        bdf_launches = [k.launches for k in counted]
        log(f"[bdf {name} launches of the package's kernels] {bdf_launches}")
        if any(bdf_launches):
            raise SystemExit(f"chip_smoke: the BDF {name} phase launched an Adams kernel")
        log_elapsed(label)

    # phase 7: the ADAMS adjoints through the history-attempt kernel; each
    # mode's counts are set to 0 just before its step and read just after
    adams_launches = adams_modes_phase(smi, counted, adams_kernels)

    # phase 8: SIR-1000, a TorchProblem, through the split kernels; every
    # other kernel's count must stay 0
    split_launches, sir_hermite = sir_phase(smi, counted[:-1])

    # phase 9(a): the forward-sensitivity builds, and the split kernels on
    # one attempt's sensitivity block of phase 9(b)'s Adams staggered solve,
    # against their plain versions
    sens_table = {
        kind: compare_history_kernel(kind, sens_systems[kind], lv_sens_fz(kind), seed,
                                     core_fz=lv_sens_core_fz(kind))
        for seed, kind in enumerate(SENS_KINDS, start=20)
    }
    split_sens = split_phase(smi, built[f"split_kab{P_MAX + 3}"],
                             (("staged_sensitivity", B_MAIN),))
    sens_table["staged_sensitivity"]["max_abs_err"] = max(
        sens_table["staged_sensitivity"]["max_abs_err"],
        history_on_attempt(sens_systems["staged_sensitivity"],
                           lv_sens_split_inputs(B_MAIN, "cuda")))
    log_elapsed("9a")
    # phases 9(b) and 9(c): every solve's counts are set to 0 just before it
    # and read just after; the main path's forward build and the new ones
    by_system = {"forward": history_kernels["forward"], **sens_kernels}
    phase9 = lv_sens_phase(smi, counted, by_system)
    for kind, count in lv_roots_phase(smi, counted, by_system).items():
        phase9[kind] = phase9.get(kind, 0) + count

    # phase 10: float32 end to end.  (a) the float32 builds against their
    # plain versions; (b) lv_adjoint_f32 and (c) SIR-1000 'resolve' at
    # float32, each gated step with every count set to 0 just before it
    # (the float64 builds and the float32 ones) and read just after
    f32_table = f32_history_phase(problem, f32_systems)
    f32_split_table = split_phase(smi, f32_split, (("forward", B_SPLIT),), torch.float32)
    log_elapsed("10a")
    f32_split_count = SplitLaunches(f32_split)
    f32_launches = lv_adjoint_f32_phase(smi, (*counted, f32_split_count), f32_kernels)
    log_elapsed("10b")
    # every split build's count (split_count) is read inside, beside the float32 build's
    f32_split_launches = sir_f32_phase(smi, (*counted[:-1], *f32_kernels.values()), f32_split)
    log_elapsed("10c")

    # phase 11: per-lane observation grids on both cores; the float64
    # forward build on the Adams core, every other count 0
    phase11 = per_lane_phase(smi, (*counted, *f32_kernels.values(), f32_split_count),
                             history_kernels["forward"])

    # phase 12: structured Newton on the batched BDF core through the banded
    # kernels, and the spline LV on the history kernel; every path's counts
    # set to 0 just before it and read just after
    others12 = tuple(k for k in (*counted, *f32_kernels.values(), f32_split_count)
                     if not isinstance(k, BandedCounts) and k not in spline_kernels.values())
    struct = structured_phase(smi, others12, tuple(banded_builds.values()))
    spline = spline_phase(smi, (*others12, BandedCounts(tuple(banded_builds.values()))),
                          spline_systems, spline_kernels)

    # phase 13: the single-chain surface; every part's counts set to 0 just
    # before it and read just after, the banded kernels at one lane
    single = single_phase(smi, (*others12, *spline_kernels.values()),
                          tuple(banded_builds.values()))
    for key, (f, sv) in single["launches"].items():
        struct["launches"][key][0] += f
        struct["launches"][key][1] += sv

    # phase 14: the class API and events; every part's counts set to 0 just
    # before it and read just after, phase 7's KAB=11 builds reused
    phase14 = class_api_phase(smi, (*others12, *spline_kernels.values(),
                                    BandedCounts(tuple(banded_builds.values()))), adams_kernels)

    # phase 15: the sampler path (NUTS at 512 chains, the PyTensor wrapper);
    # every part's counts set to 0 just before it and read just after, the
    # main path's history builds (forward, transition)
    phase15 = sampler_phase(smi, (*others12, *spline_kernels.values(),
                                  BandedCounts(tuple(banded_builds.values()))), history_kernels)

    # phase 16: the native host route and the chain split; every part's counts
    # set to 0 just before it and read just after
    phase16 = native_phase(smi, (*others12, *spline_kernels.values(),
                                 BandedCounts(tuple(banded_builds.values()))), history_kernels,
                           adams_kernels, (y0s_t, p_subs_t), main_grads)

    # phase 17: the state axis; (a) the partial-norm entries against their
    # plain versions, (b) SIR-1000 'hermite' with its state rows split over a
    # 1x2 mesh of the card, every count set to 0 just before it and read just
    # after, against phase 8's step, (c) one block bit for bit
    table17 = state_split_kernels(smi, built[f"split_kab{P_MAX_ADAMS + 3}"])
    log_elapsed("17a")
    phase17 = state_split_phase(
        smi, tuple(k for k in (*others12, *spline_kernels.values(),
                               BandedCounts(tuple(banded_builds.values())))
                   if k is not split_count and not isinstance(k, RowsLaunches)), sir_hermite)

    entries = [
        dict(
            name=f"adams_pece_attempt[{kind}]",
            route="cuda",
            source=KERNEL_SOURCE,
            replaces=TPU_KERNEL,
            launches=pece_launches[kind],
            **table[kind],
        )
        for kind in systems
    ]
    entries.append(dict(
        name="pece_2d_attempt", route="cuda", source=KERNEL_SOURCE_2D,
        replaces=TPU_KERNEL_2D, **entry_2d,
    ))
    entries += [
        dict(
            name=f"adams_history_attempt[{kind}]",
            route="cuda",
            source=KERNEL_SOURCE_ATTEMPT,
            replaces=TPU_KERNEL,
            launches=(launches[kind] + phase9.get(kind, 0)
                      + (phase11 if kind == "forward" else 0) + phase15[kind] + phase16[kind]),
            **history_table[kind],
        )
        for kind in systems
    ]
    entries += [
        dict(
            name=f"adams_history_attempt[{kind}, float32]",
            route="cuda",
            source=KERNEL_SOURCE_ATTEMPT,
            replaces=TPU_KERNEL,
            launches=f32_launches[kind],
            **f32_table[kind],
        )
        for kind in F32_KINDS
    ]
    entries += [
        dict(
            name=f"adams_history_attempt[{kind}]",
            route="cuda",
            source=KERNEL_SOURCE_ATTEMPT,
            replaces=TPU_KERNEL,
            launches=phase9.get(kind, 0),
            **sens_table[kind],
        )
        for kind in SENS_KINDS
    ]
    entries += [
        dict(
            name=f"adams_history_attempt[{kind}, KAB={P_MAX_ADAMS + 3}]",
            route="cuda",
            source=KERNEL_SOURCE_ATTEMPT,
            replaces=TPU_KERNEL,
            launches=(adams_launches[kind] + phase14.get(kind, 0)
                      + (phase16["staged_adjoint"] if kind == "staged_adjoint" else 0)),
            **adams_table[kind],
        )
        for kind in adams_systems
    ]
    entries += [
        dict(
            name=f"adams_split_{stage}[KAB={P_MAX_ADAMS + 3}]",
            route="cuda",
            source=KERNEL_SOURCE_SPLIT,
            replaces=TPU_KERNEL,
            launches=split_launches[stage] + phase17.get(stage, 0),
            **split_table[stage],
        )
        for stage in SPLIT_STAGES
    ]
    # the state split's partial-norm entries (phase 17)
    entries += [
        dict(
            name=f"adams_split_{entry}[KAB={P_MAX_ADAMS + 3}]",
            route="cuda",
            source=KERNEL_SOURCE_SPLIT,
            replaces=TPU_KERNEL,
            launches=phase17[entry],
            **table17[entry],
        )
        for entry in ROWS_KERNELS
    ]
    # a TorchProblem's sensitivity block: phase 9's solves, a SympyProblem's,
    # launch none (check_launches held every other kernel at 0)
    entries += [
        dict(
            name=f"adams_split_{stage}[KAB={P_MAX + 3}]",
            route="cuda",
            source=KERNEL_SOURCE_SPLIT,
            replaces=TPU_KERNEL,
            launches=0,
            **split_sens[stage],
        )
        for stage in SPLIT_STAGES
    ]
    entries += [
        dict(
            name=f"adams_split_{stage}[KAB={P_MAX_ADAMS + 3}, float32]",
            route="cuda",
            source=KERNEL_SOURCE_SPLIT,
            replaces=TPU_KERNEL,
            launches=f32_split_launches[stage],
            **f32_split_table[stage],
        )
        for stage in SPLIT_STAGES
    ]
    replaces = {"factor": "none (the XLA column loop sunode_tpu/ops/banded.py:63)",
                "solve": "none (the XLA column loop sunode_tpu/ops/banded.py:135)"}
    for (kind, dt), fields in struct["table"].items():
        launches = struct["launches"][id(banded_builds[dt])][0 if kind == "factor" else 1]
        entries.append(dict(
            name=f"banded_{kind}[{str(dt).split('.')[1]}, l=1, u=1]", route="cuda",
            source=BANDED_SOURCE, replaces=replaces[kind], launches=launches, **fields,
        ))
    for (kind, dt), fields in spline["table"].items():
        entries.append(dict(
            name=f"adams_history_attempt[spline {kind}, {str(dt).split('.')[1]}]", route="cuda",
            source=KERNEL_SOURCE_ATTEMPT, replaces=TPU_KERNEL,
            launches=spline["launches"].get((kind, dt), 0), **fields,
        ))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
