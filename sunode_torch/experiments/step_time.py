"""Wall time of the main-path gradient step on the card, from any checkout.

    python3 sunode_torch/experiments/step_time.py [--root DIR] [--steps 4] [--profile]
        [--sir-state-split]

Times ``--steps`` batched Lotka-Volterra adjoint gradient steps at B=10,000
(21 observation times, rtol 1e-8; ``chip_smoke.py`` phase 4's workload and
inputs) after one warm-up step, with ``sunode_torch`` imported from
``--root`` (default: the checkout holding this script).  Running it once
with an older checkout's root and once with this one, in turns within one
call, compares the two on the same card.  Prints one line per step (wall
seconds, grads/s, attempts) and, with ``--profile``, one more step under
the profiler: device kernels per attempt, device-busy seconds, and the
host's time in the torch operations that took the most of it.

``--sir-state-split`` times ``chip_smoke.py`` phase 17(b)'s step instead:
SIR over 1,000 regions, 'hermite', B=256, each chain's 3,000 state rows
split over a 1x2 mesh of the one card (``entry.build_sir_state_split``),
with host ms an attempt; its profile counts the device records alone (the
profiler's raw records: a step launches ~170,000 kernels).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

B_MAIN = 10_000


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sir-state-split", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    from sunode_torch.entry import build_lv_adjoint

    if not torch.cuda.is_available():
        raise SystemExit("step_time: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    tag = f"root={args.root} | {smi}"
    if args.sir_state_split:
        from sunode_torch.entry import build_sir_state_split
        from sunode_torch.parallel.mesh import Mesh

        dev = torch.device("cuda", 0)
        grad_step, (y0s_t, p_subs_t) = build_sir_state_split(
            1000, 256, "hermite", Mesh(((dev, dev),), ("chains", "state")))
        batch = 256
    else:
        grad_step, _ = build_lv_adjoint(B_MAIN, 21, 1e-8, device="cuda")
        rng = np.random.default_rng(42)
        y0s = np.array([10.0, 2.0]) * (1 + 0.05 * rng.standard_normal((B_MAIN, 2)))
        p_subs = np.array([1.0, 0.3]) * (1 + 0.05 * rng.standard_normal((B_MAIN, 2)))
        y0s_t = torch.as_tensor(y0s, dtype=torch.float64, device="cuda")
        p_subs_t = torch.as_tensor(p_subs, dtype=torch.float64, device="cuda")
        batch = B_MAIN

    grad_step(y0s_t, p_subs_t)  # warm-up: kernel builds, first-call costs
    for step in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grad_step(y0s_t, p_subs_t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = grad_step.solve.last_stats
        att = st["forward"]["n_attempts"] + st["backward"]["n_attempts"]
        print(f"[step {step}] B={batch} wall_s={wall:.4f} grads_per_s={batch / wall:.1f} "
              f"attempts fwd={st['forward']['n_attempts']} bwd={st['backward']['n_attempts']} "
              f"host_ms_per_attempt={1e3 * wall / att:.3f} | {tag}", flush=True)

    if args.profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        acts = [ProfilerActivity.CUDA] + ([] if args.sir_state_split else [ProfilerActivity.CPU])
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            grad_step(y0s_t, p_subs_t)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        st = grad_step.solve.last_stats
        attempts = st["forward"]["n_attempts"] + st["backward"]["n_attempts"]
        if args.sir_state_split:  # the raw records: an event tree of them takes minutes
            dev = [(e.name(), e.duration_ns() / 1e3)
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA]
        else:
            dev = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        kernels = sum(not name.startswith(("Memcpy", "Memset")) for name, _ in dev)
        busy = sum(us for _, us in dev) / 1e6
        print(f"[profile] wall_s_under_profiler={wall:.4f} device_busy_s={busy:.4f} "
              f"device_kernels={kernels} attempts={attempts} "
              f"kernels_per_attempt={kernels / attempts:.1f} | {tag}", flush=True)
        rows = sorted(
            (e for e in prof.key_averages() if e.self_cpu_time_total > 0),
            key=lambda e: -e.self_cpu_time_total,
        )[:15]
        for e in rows:
            print(f"[profile host] {e.key} calls={e.count} "
                  f"self_cpu_ms={e.self_cpu_time_total / 1e3:.1f}", flush=True)


if __name__ == "__main__":
    main()
