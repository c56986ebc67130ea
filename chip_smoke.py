#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sunode_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

  1. device: the card's name and power limit (no CUDA device -> exit 1);
  2. build: nvcc builds, all at once, the PECE kernel for both emitted
     systems (forward LV, and the transition-adjoint backward system) and
     the flat-history PECE kernel at order 6;
  3. kernel vs plain: each PECE build against the plain PyTorch version on
     the card at B=10,000, seeded random history, per-lane order 1..6, the
     main path's corrector; normwise relative error <= 1e-12 on y_it, z_new,
     d_fz and err, conv and niter equal in every lane, and per-call times;
  3b. flat-history kernel: against its plain version and against the PECE
     kernel in fixed-sweep mode at B=10,240 (the inputs of
     scripts/exp_pallas2d.py), normwise relative error <= 1e-12 on y, d_f
     and err; then the A/B of sunode_torch.experiments.exp_pece2d at
     B=10,240 and 102,400 (graph-replayed, on the stream, device-busy),
     one line per arm and width, with the kernel's launches counted;
  4. main path: batched LV adjoint gradients at B=10,000, 21 observation
     times, rtol 1e-8 (bench.py's lv_adjoint workload), three steps through
     ``torch.autograd``: every lane finite, lanes 0-15 inside the golden
     gate (tests/golden/lv_adjoint.npz, rtol 2e-3, atol 1e-3), the same
     lanes against the plain path on the CPU, and the PECE launch count
     equal to the attempts the solves report;
  5. the kernel table and the result line.  Each kernel's bound is the
     larger of its bytes (each input read once, each output written once,
     for the rows these inputs read) over 3.35 TB/s and its f64 operations
     over 34 TFLOP/s (H100 SXM, NVIDIA's data sheet).  No single PyTorch
     call computes a PECE attempt, so library_ms is null.
"""

from __future__ import annotations

import json
import os
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
F64_FLOPS = 34e12  # H100 SXM, float64 outside the tensor cores (NVIDIA data sheet)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def pece_inputs(system, B, seed, device):
    """Seeded inputs of one PECE attempt for ``system`` at the main path's
    tolerances: history depth KAB = 9 (adams_max_order 6), order 1..6 per
    lane, 90% of lanes active, steps log-uniform in [1e-6, 1e-2]."""
    import torch

    from sunode_torch.entry import lv_options
    from sunode_torch.ops.adams_batched import newton_tol_for

    rng = np.random.default_rng(seed)
    KAB, n, nz = 9, system.n, system.nz
    DF = rng.standard_normal((KAB, nz, B)) * (0.5 ** np.arange(KAB))[:, None, None]
    z_prev = 1.0 + rng.uniform(0.2, 1.0, (nz, B))
    params = np.array([1.0, 0.3, 1.0, 0.4])[:, None] * (
        1 + 0.1 * rng.standard_normal((4, B))
    )
    h = 10.0 ** rng.uniform(-6, -2, B)
    t_new = rng.uniform(0.0, 10.0, B)
    p = rng.integers(1, 7, B).astype(np.int32)
    active = rng.uniform(size=B) < 0.9
    fwd, adj = lv_options(1e-8)
    if nz == n:  # forward
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
        library_ms=None,  # no single PyTorch call computes a PECE attempt
    )


def compare_kernel(kind, device_system, fz, seed):
    """Phase 3 for one build: returns the kernel-table entry fields."""
    import torch

    from sunode_torch.experiments.exp_pece2d import cuda_ms, device_us
    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER
    from sunode_torch.ops.pece_step import (
        PeceSystem,
        adams_pece_attempt,
        adams_pece_attempt_reference,
    )

    system = PeceSystem(fz=fz, n=device_system.n, nz=device_system.nz, device=device_system)
    x = pece_inputs(device_system, B_MAIN, seed, "cuda")
    args = (x["t_new"], x["h"], x["p"], x["active"], x["DF"], x["z_prev"],
            x["params"], x["atol_z"], x["rtol_z"], x["newton_tol"], FUNCTIONAL_MAXITER)
    run_k = lambda: adams_pece_attempt(system, *args)  # noqa: E731
    run_p = lambda: adams_pece_attempt_reference(fz, *args, system.n)  # noqa: E731
    got, ref = run_k(), run_p()
    torch.cuda.synchronize()
    rel, abs_err = {}, 0.0
    for name in ("y_it", "z_new", "d_fz", "err", "z_pred"):
        a, b = getattr(got, name), getattr(ref, name)
        diff = float((a - b).abs().max())
        rel[name] = diff / float(b.abs().max())
        abs_err = max(abs_err, diff)
    conv_same = bool(torch.equal(got.conv, ref.conv))
    niter_same = bool(torch.equal(got.niter, ref.niter))
    ms, plain_ms = cuda_ms(run_k), cuda_ms(run_p)
    dev_k, dev_p = device_us(run_k), device_us(run_p)
    fmt = lambda us: "not measured" if us is None else f"{us:.2f}"  # noqa: E731
    log(
        f"[kernel-vs-plain {kind}] B={B_MAIN} n={system.n} nz={system.nz} "
        + " ".join(f"rel_{k}={v:.3e}" for k, v in rel.items())
        + f" conv_equal={conv_same} niter_equal={niter_same}"
        f" converged={int(got.conv.sum())}/{B_MAIN}"
        f" niter_hist={torch.bincount(got.niter.long(), minlength=5).tolist()}"
        f" per_call_ms kernel={ms:.4f} plain={plain_ms:.4f}"
        f" device_us_per_call kernel={fmt(dev_k)} plain={fmt(dev_p)}"
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
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **bound(nbytes, flops))


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


def main() -> None:
    card, smi = check_device()

    import torch

    from sunode_torch.adjoint import transition_fz
    from sunode_torch.entry import LV_P_FIX, build_lv_adjoint, lv_problem
    from sunode_torch.ops.pece_2d import P_ORDER, lv_system, build_pece_2d
    from sunode_torch.ops.pece_step import adams_pece_attempt, build_kernel
    from sunode_torch.symode import cuda_codegen

    # phase 2: build, one nvcc per kernel, all started together
    problem = lv_problem()
    systems = {
        "forward": cuda_codegen.forward_system(problem),
        "transition": cuda_codegen.transition_system(problem),
    }
    lv_system()  # emit the flat-history kernel's system before the threads need it
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(systems) + 1) as pool:
        futures = {kind: pool.submit(build_kernel, ds) for kind, ds in systems.items()}
        futures["pece_2d"] = pool.submit(build_pece_2d, P_ORDER)
        built = {kind: f.result() for kind, f in futures.items()}
    for kind, k in built.items():
        regs = [ln.strip() for ln in k.build_log.splitlines() if "registers" in ln]
        log(f"[build {kind}] {k.build_seconds:.2f} s -> {k.lib_path.name}; ptxas: {'; '.join(regs)}")
    log(f"[build] all in {time.perf_counter() - t0:.2f} s")
    kernels = {kind: built[kind] for kind in systems}

    # phase 3: kernel vs plain on the card
    rhs = problem.make_rhs()
    rhs_c, quad_c = transition_fz(
        rhs, problem.make_adjoint_jac_dense(), problem.make_dfdp(), problem.n_states
    )
    fz = {
        "forward": rhs,
        "transition": lambda t, y, p: torch.cat([rhs_c(t, y, p), quad_c(t, y, p)]),
    }
    table = {
        kind: compare_kernel(kind, systems[kind], fz[kind], seed)
        for seed, kind in enumerate(systems)
    }

    # phase 3b: the flat-history kernel and its A/B
    entry_2d = pece_2d_phase(smi)

    # phase 4: the main path
    grad_step, _ = build_lv_adjoint(B_MAIN, 21, 1e-8, device="cuda")
    rng = np.random.default_rng(42)
    y0s = np.array([10.0, 2.0]) * (1 + 0.05 * rng.standard_normal((B_MAIN, 2)))
    p_subs = np.array([1.0, 0.3]) * (1 + 0.05 * rng.standard_normal((B_MAIN, 2)))
    y0s_t = torch.as_tensor(y0s, dtype=torch.float64, device="cuda")
    p_subs_t = torch.as_tensor(p_subs, dtype=torch.float64, device="cuda")
    golden = np.load(os.path.join(HERE, "tests", "golden", "lv_adjoint.npz"))

    adams_pece_attempt.launches = 0
    for k in kernels.values():
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
    launches = {kind: k.launches for kind, k in kernels.items()}
    total = adams_pece_attempt.launches
    log(f"[main-path launches] {launches} total={total} expected={expected}")
    if not (total > 0 and launches == expected and total == sum(expected.values())):
        raise SystemExit("chip_smoke: PECE launches do not match the attempts run")

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

    entries = [
        dict(
            name=f"adams_pece_attempt[{kind}]",
            route="cuda",
            source=KERNEL_SOURCE,
            replaces=TPU_KERNEL,
            launches=launches[kind],
            **table[kind],
        )
        for kind in systems
    ]
    entries.append(dict(
        name="pece_2d_attempt", route="cuda", source=KERNEL_SOURCE_2D,
        replaces=TPU_KERNEL_2D, **entry_2d,
    ))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
