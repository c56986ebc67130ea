"""A/B of one Adams PECE attempt in three implementations, on the card.

Counterpart of ``scripts/exp_pallas2d.py::main``.  The script's seeded inputs
(``default_rng(0)``: a 7-row difference history of the 2 LV states, scale
0.1, ``y_prev = |N(0,1)| + 1``, ``h = |N(0,1)|/100 + 0.01``, ``t = 0``,
``(alpha, beta, gamma, delta) = (1, 0.3, 1, 0.4)``) go through three arms:

  * ``plain``   -- the plain float64 version, ``ops/pece_2d.pece_2d_reference``;
  * ``kernel1`` -- ``csrc/pece_step.cu`` through
    ``ops/pece_step.adams_pece_attempt`` in its fixed-sweep mode
    (``newton_tol=0``, ``FUNCTIONAL_ITERS`` sweeps, order 6 and active in
    every lane) on the ``(K, N, B)`` history padded with one zero row: that
    kernel poisons lanes with ``p > KAB - 2``, and rows ``>= p`` are never
    read, so the padding changes nothing;
  * ``kernel2`` -- ``csrc/pece_2d.cu`` through ``ops/pece_2d.pece_2d_attempt``
    on the flat ``(K*N, B)`` view.

``kernel2`` is held against ``plain`` and against ``kernel1``: normwise
relative error (max |a - b| / max |b|) at most 1e-12 on y, d_f and err,
room for FMA contraction and the right-hand side's rounding only.

Times (on the card only): ``graph_us``, 20 data-dependent chained calls
(``y_prev <- y_prev + 0 * y``, as the script chains them inside one jit)
captured into one CUDA graph, the least of 5 replays over 20;
``stream_us``, CUDA events over 50 unchained calls, host cost included;
``device_us``, device-busy time per call from the profiler, each call after
a 128 MB write that leaves none of its inputs in the L2; ``bound_us``,
a kernel's bytes (:func:`bytes_moved`) over the card's memory rate.  The
chaining add is a kernel of its own: the ``chain`` row replays the adds
alone.

    python -m sunode_torch.experiments.exp_pece2d [--device cpu] [--batch 10240 102400]

On ``--device cpu`` the kernel arms run their plain versions: the parity
check runs and no time is taken.
"""

from __future__ import annotations

import argparse
from typing import Callable

import numpy as np
import torch

from sunode_torch.convert import device_or_raise
from sunode_torch.ops.pece_2d import P_ORDER, lv_system, pece_2d_attempt, pece_2d_reference
from sunode_torch.ops.pece_step import FUNCTIONAL_ITERS, PeceSystem, adams_pece_attempt

__all__ = [
    "make_inputs", "arms", "bytes_moved", "parity", "run", "cuda_ms", "device_us", "graph_us",
]

K, N = 7, 2  # the script's history rows and LV states
B_SCRIPT = 10_240
REPS = 20  # chained calls per graph, as the script's chain inside one jit
REL_BOUND = 1e-12
LV_PARAMS = (1.0, 0.3, 1.0, 0.4)  # alpha, beta, gamma, delta
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)


def make_inputs(B: int, device, seed: int = 0) -> dict:
    """The script's inputs at width ``B``, as float64 tensors on ``device``."""
    rng = np.random.default_rng(seed)
    DF64 = rng.standard_normal((K, N, B)) * 0.1
    y64 = np.abs(rng.standard_normal((N, B))) + 1.0
    h64 = np.abs(rng.standard_normal(B)) * 0.01 + 0.01
    f64 = dict(dtype=torch.float64, device=device)
    DF = torch.as_tensor(DF64, **f64)
    return dict(
        DF2=DF.reshape(K * N, B),
        DF_padded=torch.cat([DF, torch.zeros((1, N, B), **f64)]),
        y_prev=torch.as_tensor(y64, **f64),
        h=torch.as_tensor(h64, **f64)[None, :],
        t=torch.zeros((1, B), **f64),
        params=torch.as_tensor(LV_PARAMS, **f64),
    )


def arms(x: dict) -> dict[str, Callable]:
    """{arm: fn(y_prev) -> (y, d_f, err)} on the inputs ``x``."""
    rhs, system, n, n_p = lv_system()
    B = x["y_prev"].shape[1]
    dev = x["y_prev"].device
    lanes = dict(
        t_new=x["t"][0].contiguous(),
        h=x["h"][0].contiguous(),
        p=torch.full((B,), P_ORDER, dtype=torch.int32, device=dev),
        active=torch.ones(B, dtype=torch.bool, device=dev),
        params=x["params"][:, None].expand(n_p, B).contiguous(),
        tol=torch.full((n,), 1e-8, dtype=torch.float64, device=dev),
    )
    pece1 = PeceSystem(fz=rhs, n=n, nz=n, device=system)

    def plain(y_prev):
        return pece_2d_reference(x["DF2"], y_prev, x["h"], x["t"], x["params"])

    def kernel1(y_prev):
        out = adams_pece_attempt(
            pece1, lanes["t_new"], lanes["h"], lanes["p"], lanes["active"],
            x["DF_padded"], y_prev, lanes["params"], lanes["tol"], lanes["tol"],
            0.0, FUNCTIONAL_ITERS,
        )
        return out.y_it, out.d_fz, out.err

    def kernel2(y_prev):
        return pece_2d_attempt(x["DF2"], y_prev, x["h"], x["t"], x["params"])

    return {"plain": plain, "kernel1": kernel1, "kernel2": kernel2}


def bytes_moved(arm: str, B: int, n: int = N, n_p: int = len(LV_PARAMS)) -> int:
    """The bytes a kernel arm must move at width ``B``: each input row it
    reads once (history rows i < P only), each output row written once."""
    if arm == "kernel2":  # history, y_prev, h, t, params -> y, d_f, err
        return 8 * (B * (P_ORDER * n + n + 2) + n_p) + 8 * 3 * n * B
    if arm == "kernel1":  # history, z_prev, per-lane params, t, h, tolerances, p
        # and active -> y_it, d_fz, err, z_pred, z_new, conv, niter
        return 8 * (B * (P_ORDER * n + n + n_p + 2) + 2 * n) + 5 * B + 8 * 5 * n * B + 5 * B
    raise ValueError(f"no byte count for arm {arm!r}")


def parity(got, ref) -> tuple[float, float]:
    """(worst normwise relative error, worst absolute error) over y, d_f, err."""
    rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, ref))
    return rel, max(float((a - b).abs().max()) for a, b in zip(got, ref))


def cuda_ms(fn, reps: int = 50) -> float:
    """Milliseconds per call on the stream (CUDA events, host cost included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


FLUSH_BYTES = 128 << 20  # written before each device-timed call: over the H100's 50 MB L2
LEAD_FILLS = 64  # one-element fills that open each timed session


def device_us(fn, reps: int = 20, tries: int = 3, kernel: str | None = None):
    """Device-busy microseconds per call, from the profiler's kernel times,
    each call made right after a 128 MB buffer is written, so that it reads
    its inputs from device memory and not from the 50 MB L2 (the write's
    kernel, a fill of bytes, is left out).  The profiler can drop records,
    or deliver an earlier session's late: a session is kept only when it
    holds all ``reps`` writes, one between every two calls, and, with
    ``kernel`` (a part of a hand-written kernel's name), that kernel's
    records a multiple of ``reps`` times, else it is taken again, up to
    ``tries`` times; None when no session was whole.  The other kernels of
    ``fn`` (a plain version launches hundreds a call) are held to nothing
    more than the writes around them.  Once a process has profiled a large
    session (a solve's), the profiler loses the first few records of every
    later session that opens with the timed calls, and none of one that
    opens with other work: each session opens with :data:`LEAD_FILLS` fills
    of a one-element int16 tensor, left out of the sum."""
    from torch.profiler import ProfilerActivity, profile

    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    lead = torch.empty(1, dtype=torch.int16, device="cuda")
    fn()
    scratch.fill_(1)
    torch.cuda.synchronize()
    for _ in range(tries):
        # a session of its own takes any record of earlier work that the
        # profiler delivers late, which would otherwise land in the timed one
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_FILLS):
                lead.fill_(1)
            for _ in range(reps):
                scratch.fill_(1)
                fn()
            torch.cuda.synchronize()
        timed = [e for e in prof.key_averages()
                 if e.self_device_time_total > 0 and "FillFunctor<short>" not in e.key]
        writes = sum(e.count for e in timed if "FillFunctor<unsigned char>" in e.key)
        own = [e for e in timed if "FillFunctor<unsigned char>" not in e.key]
        mine = sum(e.count for e in own if kernel is not None and kernel in e.key)
        if writes == reps and own and (kernel is None or (mine and mine % reps == 0)):
            return sum(e.self_device_time_total for e in own) / reps
    return None


def _chain(fn, y_prev):
    out = fn(y_prev)
    for _ in range(REPS - 1):
        y_prev = torch.add(y_prev, out[0], alpha=0.0)  # a data dependence, no change
        out = fn(y_prev)
    return out


def graph_us(fn, y_prev, replays: int = 5) -> float:
    """Microseconds per call: REPS chained calls in one CUDA graph, the
    least of ``replays`` replays over REPS."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up (and build) outside the capture
        _chain(fn, y_prev)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _chain(fn, y_prev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return min(times) * 1e3 / REPS


# the kernel each arm launches, by the name the profiler gives it
ARM_KERNELS = {"plain": None, "kernel1": "pece_attempt_kernel", "kernel2": "pece_2d_kernel"}


def _times(fn, y0, kernel) -> dict:
    return dict(
        graph_us=graph_us(fn, y0),
        stream_us=1e3 * cuda_ms(lambda: fn(y0)),
        device_us=device_us(lambda: fn(y0), kernel=kernel),
    )


def _fmt(v) -> str:
    if v is None:
        return "not measured"
    return f"{v:.4g}" if isinstance(v, float) else str(v)


def run(batches=(B_SCRIPT, 10 * B_SCRIPT), device="cuda", log=print) -> list[dict]:
    """The A/B at each width in ``batches``: one dict per arm and width.
    Raises if ``kernel2`` disagrees with ``plain`` or ``kernel1``."""
    dev = device_or_raise(device)
    rows = []
    for B in batches:
        x = make_inputs(B, dev)
        y0 = x["y_prev"]
        fns = arms(x)
        outs = {arm: fn(y0) for arm, fn in fns.items()}
        checks = {ref: parity(outs["kernel2"], outs[ref]) for ref in ("plain", "kernel1")}
        if not all(rel <= REL_BOUND for rel, _ in checks.values()):
            raise RuntimeError(f"pece_2d A/B at B={B}: kernel2 disagrees: {checks}")
        new = {arm: dict(B=B, arm=arm) for arm in fns}
        new["kernel2"].update(
            rel_vs_plain=checks["plain"][0], rel_vs_kernel1=checks["kernel1"][0],
            abs_vs_plain=checks["plain"][1],
        )
        if dev.type == "cuda":
            for arm, fn in fns.items():
                new[arm].update(_times(fn, y0, ARM_KERNELS[arm]))
                if arm != "plain":
                    new[arm]["bound_us"] = 1e6 * bytes_moved(arm, B) / HBM_BYTES_PER_S
            # the chaining adds alone: 19 per 20 calls, as in every arm's graph
            new["chain"] = dict(B=B, arm="chain", graph_us=graph_us(lambda y: (y,), y0))
        for row in new.values():
            log("[pece2d A/B] " + " ".join(f"{k}={_fmt(v)}" for k, v in row.items()))
        rows += new.values()
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, nargs="+", default=[B_SCRIPT, 10 * B_SCRIPT])
    args = ap.parse_args(argv)
    if device_or_raise(args.device).type == "cuda":
        import subprocess

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip())
    run(args.batch, args.device)


if __name__ == "__main__":
    main()
