#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sunode_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

  1. device: the card's name and power limit (no CUDA device -> exit 1);
  2. build: nvcc builds, all at once, the PECE kernel and the history-attempt
     kernel for both emitted systems (forward LV, and the transition-adjoint
     backward system) and the flat-history PECE kernel at order 6, and the
     history-attempt kernel at phase 7's depth (adams_max_order 8) for the
     forward, the backsolve ('resolve') and the staged checkpointed
     ('staged_adjoint') systems;
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
     relative error <= 1e-12 on DF_resc, DF_upd, z_new and err3, conv and
     niter equal in every lane, and per-call times as in phase 3; phase 7's
     three builds at its history depth (order 1..8) and tolerances (1e-8 on
     every row), the staged build with seeded y(t) rows after the
     parameters;
  4. main path: batched LV adjoint gradients at B=10,000, 21 observation
     times, rtol 1e-8 (bench.py's lv_adjoint workload), three steps through
     ``torch.autograd``: the history-attempt launches equal to the attempts
     the solves report and no PECE-kernel launch; then one more step under
     the profiler for the device kernels per attempt and the device-busy
     share; every lane finite, lanes 0-15 inside the golden gate
     (tests/golden/lv_adjoint.npz, rtol 2e-3, atol 1e-3), and the same lanes
     against the plain path on the CPU within 1e-6;
  5. stiff BDF: bench.py's Robertson workload at B=10,000 (8 observation
     times to 4e6, rtol 1e-8, atol [1e-10, 1e-12, 1e-10]) through
     ``make_batched_solve_fn(method='BDF', derivatives=None)``: one solve
     under the profiler for the device kernels per attempt (counted from the
     profiler's raw records and from its public event list, which must
     agree) and the device-busy share, then one timed solve, warm; status 0 in every lane
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
     ``entry.build_lv_checkpointed``: one timed gradient step and one under
     the profiler, with the attempts of each solve, the device kernels and
     host ms per attempt and the device-busy share; status 0 and finite
     gradients in every lane, lanes 0-15 inside the golden gate and against
     the plain path on the CPU within 1e-6; then 'polynomial' on lanes 0-15,
     the card against the CPU within 1e-6 and the golden gate; no kernel of
     the package launches on this path;
  7. the ADAMS adjoints that read no transition matrix, 'resolve',
     'hermite' and 'polynomial', through ``entry.build_lv_adams`` on phase
     4's inputs at B=10,000, 21 observation times, rtol = atol = 1e-8 forward
     and backward, 384 checkpoints (the JAX package's golden test of these
     modes): per mode one timed gradient step with every kernel count set to
     0 before it, the history-attempt launches equal to the forward plus the
     backward attempts, split by system, and no launch of the PECE or the
     flat-history kernel; then one step under the profiler (device kernels
     and host ms per attempt, device-busy share), the table's bytes and the
     peak memory; status 0 and finite gradients in every lane, lanes 0-15
     inside the golden gate and against the same call on the CPU within
     1e-6;
  8. the kernel table and the result line.  Each kernel's bound is the
     larger of its bytes (each input read once, each output written once,
     for the rows these inputs read) over 3.35 TB/s and its f64 operations
     over 34 TFLOP/s (H100 SXM, NVIDIA's data sheet).  No single PyTorch
     call computes a PECE attempt or a history attempt, so library_ms is
     null.
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
ADAMS_MODES = ("resolve", "hermite", "polynomial")
ADAMS_RTOL = 1e-8  # phase 7's tolerances, forward and backward, every row
F64_FLOPS = 34e12  # H100 SXM, float64 outside the tensor cores (NVIDIA data sheet)


def log(msg: str) -> None:
    print(msg, flush=True)


T_START = time.perf_counter()


def log_elapsed(phase: str) -> None:
    """The script's wall time so far, after each phase."""
    log(f"[elapsed] after phase {phase}: {time.perf_counter() - T_START:.1f} s")


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


def pece_inputs(system, B, seed, device, p_max=P_MAX, tol=None):
    """Seeded inputs of one PECE attempt for ``system``: history depth KAB =
    p_max + 3, order 1..p_max per lane, 90% of lanes active, steps
    log-uniform in [1e-6, 1e-2]; the main path's tolerances, or, with
    ``tol``, rtol = atol = tol on every row (phase 7).  A system with more
    parameter rows than the problem's reads a staged y(t) there: seeded rows
    uniform in [0.5, 12] (the range of the LV states)."""
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
    tol = newton_tol_for(opts, float(np.min(rtol[:n])), torch.float64)
    f64 = dict(dtype=torch.float64, device=device)
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), **f64)  # noqa: E731
    return dict(
        t_new=T(t_new), h=T(h),
        p=torch.as_tensor(p, device=device),
        active=torch.as_tensor(active, device=device),
        DF=T(DF), z_prev=T(z_prev), params=T(params),
        atol_z=T(atol), rtol_z=T(rtol), newton_tol=tol,
    )


def rhs_flops(system) -> int:
    """Arithmetic operators in the emitted right-hand side's assignments: the
    float64 operations of one evaluation, counted from the source."""
    body = system.source.split("pece_fz(", 1)[1]
    lines = [ln.split("=", 1)[1] for ln in body.splitlines()
             if ln.strip().startswith(("out[", "const double x_"))]
    return sum(ln.count(c) for ln in lines for c in "+-*/")


def bound(nbytes: float, flops: float) -> dict:
    """Kernel-table fields: the least time on the card and what sets it."""
    from sunode_torch.experiments.exp_pece2d import HBM_BYTES_PER_S

    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F64_FLOPS
    return dict(
        bound_ms=1e3 * max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None,  # no single PyTorch call computes either attempt
    )


def per_call_times(call, z, graph=True) -> dict:
    """Per-call times of ``call(z_prev) -> (z_new, ...)`` at ``z``:
    graph-replayed (20 chained calls in one CUDA graph; None with
    ``graph=False``), on the stream (CUDA events, host cost included) and
    device-busy (profiler), microseconds.  The plain versions copy their
    coefficient tables from the host on every call, which a graph cannot
    capture."""
    from sunode_torch.experiments.exp_pece2d import cuda_ms, device_us, graph_us

    return dict(
        graph=graph_us(call, z) if graph else None,
        stream=1e3 * cuda_ms(lambda: call(z)), device=device_us(lambda: call(z)),
    )


def fmt_us(us) -> str:
    return "not measured" if us is None else f"{us:.2f}"


def fmt_times(name, t) -> str:
    times = "/".join(fmt_us(t[k]) for k in ("graph", "stream", "device"))
    return f" {name}_us_per_call graph/stream/device={times}"


def normwise(got, ref, names):
    """({name: max|a - b| / max|b|}, worst max|a - b|) over the fields ``names``."""
    rel, abs_err = {}, 0.0
    for name in names:
        a, b = getattr(got, name), getattr(ref, name)
        diff = float((a - b).abs().max())
        rel[name] = diff / float(b.abs().max())
        abs_err = max(abs_err, diff)
    return rel, abs_err


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
    t_k, t_p = per_call_times(call_k, x["z_prev"]), per_call_times(call_p, x["z_prev"], False)
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


def history_inputs(system, B, seed, device, p_max=P_MAX, tol=None):
    """Phase 3's inputs plus what the history attempt also reads, as the main
    path builds it: the step ratio h / h_D (seeded, log-uniform in [0.2, 2]),
    |gamma*| and the error norm's weights (1/n on the state rows; with the
    quadrature under error control, as every backward solve has it, half of
    each block's share)."""
    import torch

    from sunode_torch.ops.adams import _GAMMA_STAR

    x = pece_inputs(system, B, seed, device, p_max, tol)
    rng = np.random.default_rng(1000 + seed)
    n, nz = system.n, system.nz
    if nz == n:
        v_err = np.full(n, 1.0 / n)
    else:
        v_err = np.concatenate([np.full(n, 0.5 / n), np.full(nz - n, 0.5 / (nz - n))])
    f64 = dict(dtype=torch.float64, device=device)
    x.update(
        pre_factor=torch.as_tensor(np.exp(rng.uniform(np.log(0.2), np.log(2.0), B)), **f64),
        gamma_star_abs=torch.as_tensor(np.abs(_GAMMA_STAR), **f64),
        v_err=torch.as_tensor(v_err, **f64),
    )
    return x


def history_cost(device_system, x, niter) -> tuple[int, int]:
    """(bytes, f64 operations) of one history attempt on the inputs ``x``:
    the history read once and written twice, the other inputs read once and
    the outputs written once; rescale, predictor, the sweeps taken, final
    evaluation, difference update and error rows, counted per lane from its
    order."""
    n, nz, n_p = device_system.n, device_system.nz, device_system.n_p
    KAB, _, B = x["DF"].shape
    p = x["p"].long()
    nbytes = 8 * 3 * KAB * nz * B  # DF in; DF_resc, DF_upd out
    nbytes += 8 * B * (nz + n_p + 3) + 4 * B + B  # z_prev, params, t, h, ratio; p; active
    nbytes += 8 * (3 * nz + x["gamma_star_abs"].numel())  # atol_z, rtol_z, v_err, |gamma*|
    nbytes += 8 * B * (3 * nz + 3) + B + 4 * B  # z_pred, z_new, err0, err3; conv; niter
    f = rhs_flops(device_system)
    # per row: R and U, p outputs of p terms each (difference, product,
    # quotient, product, sum); predictor and f_ex; suffix sums, update, new
    # state, error rows and their weighted squares
    per_row = 2 * p * (5 * p - 2) + 3 * p + 2 + KAB + 2 * p + 21
    flops = int((nz * per_row).sum()) + int(niter.sum()) * (f + 6 * n) + B * (f + 3 * n + 10)
    return nbytes, flops


def compare_history_kernel(kind, device_system, fz, seed, p_max=P_MAX, tol=None):
    """Phase 3c for one build: returns the kernel-table entry fields."""
    import torch

    from sunode_torch.experiments.exp_pece2d import device_us
    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER
    from sunode_torch.ops.adams_attempt import (
        adams_history_attempt,
        adams_history_attempt_reference,
    )
    from sunode_torch.ops.pece_step import PeceSystem

    system = PeceSystem(fz=fz, n=device_system.n, nz=device_system.nz, device=device_system)
    x = history_inputs(device_system, B_MAIN, seed, "cuda", p_max, tol)

    def args(z, p=x["p"]):
        return (x["t_new"], x["h"], x["pre_factor"], p, x["active"], x["DF"], z,
                x["params"], x["atol_z"], x["rtol_z"], x["gamma_star_abs"], x["v_err"],
                x["newton_tol"], FUNCTIONAL_MAXITER, p_max)

    run_k = lambda z: adams_history_attempt(system, *args(z))  # noqa: E731
    run_p = lambda z: adams_history_attempt_reference(system, *args(z))  # noqa: E731
    got, ref = run_k(x["z_prev"]), run_p(x["z_prev"])
    torch.cuda.synchronize()
    rel, abs_err = normwise(got, ref, ("DF_resc", "DF_upd", "z_new", "err3", "z_pred", "err0"))
    conv_same = bool(torch.equal(got.conv, ref.conv))
    niter_same = bool(torch.equal(got.niter, ref.niter))
    call_k = lambda z: (run_k(z).z_new,)  # noqa: E731
    call_p = lambda z: (run_p(z).z_new,)  # noqa: E731
    t_k, t_p = per_call_times(call_k, x["z_prev"]), per_call_times(call_p, x["z_prev"], False)
    # the rescale's work grows with p^2: device time at one order in every lane
    at_p = {
        q: device_us(lambda: adams_history_attempt(
            system, *args(x["z_prev"], torch.full_like(x["p"], q))))
        for q in (1, p_max)
    }
    nbytes, flops = history_cost(device_system, x, got.niter)
    entry = dict(max_abs_err=abs_err, ms=t_k["stream"] / 1e3, plain_ms=t_p["stream"] / 1e3,
                 **bound(nbytes, flops))
    log(
        f"[history-kernel-vs-plain {kind}] B={B_MAIN} n={system.n} nz={system.nz} "
        f"n_p={device_system.n_p} KAB={p_max + 3} "
        + " ".join(f"rel_{k}={v:.3e}" for k, v in rel.items())
        + f" conv_equal={conv_same} niter_equal={niter_same}"
        f" converged={int(got.conv.sum())}/{B_MAIN}"
        f" niter_hist={torch.bincount(got.niter.long(), minlength=5).tolist()}"
        + fmt_times("kernel", t_k) + fmt_times("plain", t_p)
        + "".join(f" kernel_device_us_all_p{q}={fmt_us(v)}" for q, v in at_p.items())
        + f" bytes={nbytes} flops={flops} bound_us={1e3 * entry['bound_ms']:.3f}"
        f" ({entry['bound_by']})"
    )
    if not (max(rel.values()) <= REL_BOUND and conv_same and niter_same):
        raise SystemExit(f"chip_smoke: {kind} history kernel disagrees with the plain version")
    return entry


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
    """(name, µs) of every device record of a finished profile, read from
    the profiler's raw records (``kineto_results``, not a public API):
    building its Python event tree takes minutes for the millions of kernels
    of a checkpointed gradient step.  Raises if this torch lacks them."""
    from torch.autograd import DeviceType

    results = getattr(prof.profiler, "kineto_results", None)
    if results is None or not hasattr(results, "events"):
        raise SystemExit("chip_smoke: this torch's profiler has no kineto_results.events()")
    return [(e.name(), e.duration_ns() / 1e3) for e in results.events()
            if e.device_type() == DeviceType.CUDA]


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
    attempts = attempts()
    events = _raw_device_events(prof)
    kernels, copies = _count([name for name, _ in events])
    public = None
    if cross_check:
        public = _count([e.name for e in prof.events() if e.device_type == DeviceType.CUDA])
        if public != (kernels, copies):
            raise SystemExit(f"chip_smoke: the profiler's raw records count {(kernels, copies)} "
                             f"device kernels and copies, prof.events() {public}")
    busy_us = 0.0
    by_class: dict[str, list] = {}
    for name, us in events:
        busy_us += us
        entry = by_class.setdefault(kernel_class(name), [0, 0.0])
        entry[0] += 1
        entry[1] += us
    return dict(attempts=attempts, kernels=kernels, copies=copies, public=public,
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

    def attempts():
        return stats["forward"]["n_attempts"] + stats["backward"]["n_attempts"]

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
    prof = device_kernels_per_attempt(lambda: grad_step(y0s_t, p_subs_t), attempts)
    log(
        f"[checkpointed device kernels per attempt] {prof['per_attempt']:.1f} "
        f"({prof['kernels']} kernels, {prof['copies']} copies and fills, "
        f"{prof['attempts']} attempts in one step) device_busy_s={prof['busy_s']:.4f} "
        f"wall_s_under_profiler={prof['wall_s']:.4f} "
        f"device_busy_share={prof['busy_s'] / prof['wall_s']:.4f} (of the profiled step) | {smi}"
    )
    log("[checkpointed device kernels by kind] (kind: per attempt, device ms in the step) "
        + "; ".join(f"{c}: {per:.1f}, {ms:.1f}" for c, (per, ms) in prof["by_class"].items()))
    log_elapsed("6, the profiled step")

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
        # hermite: the full-width step's lanes 0-15 against the CPU
        out = {"cuda": [gy_np[:16], gp_np[:16]]} if interpolation == "hermite" else {}
        for device in ("cuda", "cpu"):
            if device in out:
                continue
            t0 = time.perf_counter()
            step, _ = build_lv_checkpointed(16, 21, 1e-8, interpolation, device=device)
            f64 = dict(dtype=torch.float64, device=device)
            grads = step(torch.as_tensor(y0s[:16], **f64), torch.as_tensor(p_subs[:16], **f64))
            out[device] = [a.cpu().numpy() for a in grads]
            log(f"[checkpointed {interpolation} 16 lanes on {device}] "
                f"wall_s={time.perf_counter() - t0:.2f} attempts fwd="
                f"{step.solve.last_stats['forward']['n_attempts']} "
                f"bwd={step.solve.last_stats['backward']['n_attempts']}")
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
        launches = {kind: k.launches for kind, k in history_kernels.items() if k.launches}
        others = [k.launches for k in counted if k not in history_kernels.values()
                  and k is not adams_history_attempt]
        expected = adams_expected_launches(mode, fwd, bwd)
        log(f"[adams {mode} launches] history-attempt {launches} "
            f"total={adams_history_attempt.launches} expected={expected}; "
            f"other kernels {others}")
        if not (launches == expected and adams_history_attempt.launches == fwd + bwd):
            raise SystemExit(f"chip_smoke: {mode}: history-attempt launches do not match "
                             "the attempts run")
        if any(others):
            raise SystemExit(f"chip_smoke: {mode}: the path launched the PECE or flat kernel")
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

        def attempts():
            return stats["forward"]["n_attempts"] + stats["backward"]["n_attempts"]

        prof = device_kernels_per_attempt(lambda: grad_step(y0s_t, p_subs_t), attempts)
        log(
            f"[adams {mode} device kernels per attempt] {prof['per_attempt']:.1f} "
            f"({prof['kernels']} kernels, {prof['copies']} copies and fills, "
            f"{prof['attempts']} attempts in one step) device_busy_s={prof['busy_s']:.4f} "
            f"wall_s_under_profiler={prof['wall_s']:.4f} host_ms_per_attempt_under_profiler="
            f"{1e3 * prof['wall_s'] / prof['attempts']:.3f} "
            f"device_busy_share={prof['busy_s'] / prof['wall_s']:.4f} (of the profiled step) | {smi}"
        )
        log(f"[adams {mode} device kernels by kind] (kind: per attempt, device ms in the step) "
            + "; ".join(f"{c}: {per:.1f}, {ms:.1f}" for c, (per, ms) in prof["by_class"].items()))

        gy_np, gp_np = gy.cpu().numpy(), gp.cpu().numpy()
        finite = int((np.isfinite(gy_np).all(axis=1) & np.isfinite(gp_np).all(axis=1)).sum())
        if not (gy_np.shape == gp_np.shape == (B_MAIN, 2) and finite == B_MAIN
                and (status == 0).all()):
            raise SystemExit(f"chip_smoke: {mode} gradients failed ({finite} finite, "
                             f"{int((status == 0).sum())} with status 0, of {B_MAIN})")
        np.testing.assert_allclose(gy_np[:16], golden["gy"], rtol=2e-3, atol=1e-3)
        np.testing.assert_allclose(gp_np[:16], golden["gp"], rtol=2e-3, atol=1e-3)
        gold_rel = max_rel((gy_np[:16], gp_np[:16]), (golden["gy"], golden["gp"]))
        t0 = time.perf_counter()
        cpu_step, _ = build_lv_adams(16, 21, ADAMS_RTOL, mode, device="cpu")
        cpu = [a.numpy() for a in cpu_step(torch.as_tensor(y0s[:16]), torch.as_tensor(p_subs[:16]))]
        plain_rel = max_rel((gy_np[:16], gp_np[:16]), cpu)
        log(
            f"[adams {mode} check] status 0 and finite in {finite}/{B_MAIN} lanes; "
            f"golden_max_rel={gold_rel:.3e} (gate 2e-3) cuda_vs_cpu_plain_max_rel={plain_rel:.3e} "
            f"(bound 1e-6; the CPU's 16 lanes took {time.perf_counter() - t0:.2f} s)"
        )
        if not plain_rel <= 1e-6:
            raise SystemExit(f"chip_smoke: the CUDA {mode} adjoint disagrees with the plain path")
        log_elapsed(f"7, {mode}")
    return total


def bdf_robertson_phase(smi) -> None:
    """Phase 5: bench.py's Robertson workload through the BDF wrapper."""
    import torch

    from sunode_torch.entry import build_robertson

    solve, inputs = build_robertson(B_MAIN, device="cuda")
    golden = np.load(os.path.join(HERE, "tests", "golden", "robertson.npz"))
    atol = np.asarray(solve.options.atol)

    def run():
        return solve(0.0, *inputs)

    # the profiled solve comes first and is the timed solve's warm-up; the
    # profiler's public event list counts its kernels too (a few seconds at
    # this size), as a check of the raw-record count every phase uses
    prof = device_kernels_per_attempt(run, lambda: solve.last_stats["forward"]["n_attempts"],
                                      cross_check=True)
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
        f"{prof['attempts']} attempts in one solve; prof.events() counts "
        f"{prof['public'][0]} and {prof['public'][1]}) device_busy_s={prof['busy_s']:.4f} "
        f"wall_s_under_profiler={prof['wall_s']:.4f} "
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
    cpu_solve, cpu_inputs = build_robertson(16, device="cpu")
    plain_rel = floored_rel(ys_np[:16], cpu_solve(0.0, *cpu_inputs).numpy(), atol)
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
    cpu = lv_sens_solve(problem, y0s[:16], ps[:16], g["tvals"], "cpu")
    plain_rel = max(floored_rel(ys[:16], cpu.ys.numpy(), 1e-9),
                    floored_rel(sens[:16], cpu.sens.numpy(), 1e-9))
    log(
        f"[bdf sens] B={B_MAIN} k=2 wall_s={wall:.4f} us_per_solve={1e6 * wall / B_MAIN:.2f} "
        f"n_attempts={res.stats['n_attempts']} status 0 in {ok}/{B_MAIN} lanes "
        f"finite={int(np.isfinite(sens).all(axis=(1, 2, 3)).sum())} "
        f"golden_max_abs ys={np.abs(ys[:16] - g['ys']).max():.3e} "
        f"sens={np.abs(sens[:16] - g['sens']).max():.3e} "
        f"cuda_vs_cpu_plain_max_rel={plain_rel:.3e} (ys and sens, atol 1e-9, bound 1e-6) | {smi}"
    )
    if ok != B_MAIN:
        raise SystemExit(f"chip_smoke: BDF sensitivities failed in {B_MAIN - ok} lanes")
    np.testing.assert_allclose(ys[:16], g["ys"], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(sens[:16], g["sens"], rtol=2e-4, atol=5e-4)
    if not (cpu.status == 0).all() or not plain_rel <= 1e-6:
        raise SystemExit("chip_smoke: the CUDA BDF sensitivities disagree with the plain path")


def main() -> None:
    card, smi = check_device()

    import torch

    # the plain-path references run 16 lanes on the CPU, where torch's
    # batched LU of tiny matrices is far slower on many threads than on one
    torch.set_num_threads(1)

    from sunode_torch.adjoint import resolve_fz, staged_adjoint_fz, transition_fz
    from sunode_torch.entry import LV_P_FIX, build_lv_adjoint, lv_problem
    from sunode_torch.ops.adams_attempt import adams_history_attempt, build_attempt_kernel
    from sunode_torch.ops.pece_2d import P_ORDER, build_pece_2d, lv_system, pece_2d_attempt
    from sunode_torch.ops.pece_step import adams_pece_attempt, build_kernel
    from sunode_torch.symode import cuda_codegen

    # phase 2: build, one nvcc per kernel, all started together
    problem = lv_problem()
    systems = {
        "forward": cuda_codegen.forward_system(problem),
        "transition": cuda_codegen.transition_system(problem),
    }
    # phase 7's systems, at its history depth
    adams_systems = {
        "forward": systems["forward"],
        "resolve": cuda_codegen.resolve_system(problem),
        "staged_adjoint": cuda_codegen.staged_adjoint_system(problem),
    }
    lv_system()  # emit the flat-history kernel's system before the threads need it
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2 * len(systems) + 1 + len(adams_systems)) as pool:
        futures = {kind: pool.submit(build_kernel, ds) for kind, ds in systems.items()}
        futures.update({
            f"history_{kind}": pool.submit(build_attempt_kernel, ds, P_MAX + 3)
            for kind, ds in systems.items()
        })
        futures["pece_2d"] = pool.submit(build_pece_2d, P_ORDER)
        futures.update({
            f"history_{kind}_kab{P_MAX_ADAMS + 3}": pool.submit(
                build_attempt_kernel, ds, P_MAX_ADAMS + 3)
            for kind, ds in adams_systems.items()
        })
        built = {kind: f.result() for kind, f in futures.items()}
    for kind, k in built.items():
        regs = [ln.strip() for ln in k.build_log.splitlines() if "registers" in ln or "spill" in ln]
        log(f"[build {kind}] {k.build_seconds:.2f} s -> {k.lib_path.name}; "
            f"sass_instructions={sass_instructions(k.lib_path)}; ptxas: {'; '.join(regs)}")
    log(f"[build] all in {time.perf_counter() - t0:.2f} s")
    log_elapsed("2")
    kernels = {kind: built[kind] for kind in systems}
    history_kernels = {kind: built[f"history_{kind}"] for kind in systems}
    adams_kernels = {kind: built[f"history_{kind}_kab{P_MAX_ADAMS + 3}"] for kind in adams_systems}

    # phase 3: kernel vs plain on the card
    rhs = problem.make_rhs()
    rhs_c, quad_c = transition_fz(
        rhs, problem.make_adjoint_jac_dense(), problem.make_dfdp(), problem.n_states
    )
    aj, qr = problem.make_adjoint_rhs(), problem.make_adjoint_quad_rhs()
    res_c, res_q = resolve_fz(rhs, aj, qr, problem.n_states)
    stg_c, stg_q = staged_adjoint_fz(aj, qr)
    n_p = problem.n_all_params
    fz = {
        "forward": rhs,
        "transition": lambda t, y, p: torch.cat([rhs_c(t, y, p), quad_c(t, y, p)]),
        "resolve": lambda t, y, p: torch.cat([res_c(t, y, p), res_q(t, y, p)]),
        # the parameter rows are [params | y(t)], as the Adams core passes them
        "staged_adjoint": lambda t, y, p: torch.cat(
            [stg_c(t, y, p[:n_p], p[n_p:]), stg_q(t, y, p[:n_p], p[n_p:])]),
    }
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

    # phase 4: the main path
    grad_step, _ = build_lv_adjoint(B_MAIN, 21, 1e-8, device="cuda")
    y0s, p_subs = lv_main_inputs()
    y0s_t = torch.as_tensor(y0s, dtype=torch.float64, device="cuda")
    p_subs_t = torch.as_tensor(p_subs, dtype=torch.float64, device="cuda")
    golden = np.load(os.path.join(HERE, "tests", "golden", "lv_adjoint.npz"))

    adams_pece_attempt.launches = adams_history_attempt.launches = 0
    for k in (*kernels.values(), *history_kernels.values()):
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
    launches = {kind: k.launches for kind, k in history_kernels.items()}
    total = adams_history_attempt.launches
    pece_launches = {kind: k.launches for kind, k in kernels.items()}
    log(f"[main-path launches] history-attempt {launches} total={total} expected={expected}; "
        f"PECE kernel {pece_launches} total={adams_pece_attempt.launches}")
    if not (total > 0 and launches == expected and total == sum(expected.values())):
        raise SystemExit("chip_smoke: history-attempt launches do not match the attempts run")
    if adams_pece_attempt.launches != 0 or any(pece_launches.values()):
        raise SystemExit("chip_smoke: the main path launched the PECE kernel")

    def step_attempts():
        stats = grad_step.solve.last_stats
        return stats["forward"]["n_attempts"] + stats["backward"]["n_attempts"]

    prof = device_kernels_per_attempt(lambda: grad_step(y0s_t, p_subs_t), step_attempts)
    log(
        f"[main-path device kernels per attempt] {prof['per_attempt']:.1f} "
        f"({prof['kernels']} kernels, {prof['copies']} copies and fills, "
        f"{prof['attempts']} attempts in one step) device_busy_s={prof['busy_s']:.4f} "
        f"wall_s_under_profiler={prof['wall_s']:.4f} | {smi}"
    )

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

    # the same 16 lanes through the plain path on the CPU
    cpu_step, _ = build_lv_adjoint(16, 21, 1e-8, device="cpu")
    cy, cp = cpu_step(
        torch.as_tensor(y0s[:16], dtype=torch.float64),
        torch.as_tensor(p_subs[:16], dtype=torch.float64),
    )
    plain_rel = max(
        float(np.max(np.abs(gy_np[:16] - cy.numpy()) / np.abs(cy.numpy()))),
        float(np.max(np.abs(gp_np[:16] - cp.numpy()) / np.abs(cp.numpy()))),
    )
    log(
        f"[main-path check] finite={finite}/{B_MAIN} golden_max_rel={gold_rel:.3e} "
        f"(gate 2e-3) cuda_vs_cpu_plain_max_rel={plain_rel:.3e} (bound 1e-6) p_fix={LV_P_FIX}"
    )
    if not plain_rel <= 1e-6:
        raise SystemExit("chip_smoke: the CUDA main path disagrees with the plain path")
    log_elapsed("4")

    # phases 5, 5b and 6: the BDF paths, which launch none of the kernels;
    # each path's counts are set to 0 just before it and read just after
    counted = (adams_pece_attempt, adams_history_attempt, *kernels.values(),
               *history_kernels.values(), *adams_kernels.values(), pece_2d_attempt,
               build_pece_2d(P_ORDER))
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
            launches=launches[kind],
            **history_table[kind],
        )
        for kind in systems
    ]
    entries += [
        dict(
            name=f"adams_history_attempt[{kind}, KAB={P_MAX_ADAMS + 3}]",
            route="cuda",
            source=KERNEL_SOURCE_ATTEMPT,
            replaces=TPU_KERNEL,
            launches=adams_launches[kind],
            **adams_table[kind],
        )
        for kind in adams_systems
    ]
    log(json.dumps({"kernels": entries}))
    log(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
