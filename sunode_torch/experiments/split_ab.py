"""The split attempt's sweep kernel against another version of itself, on the card.

    python -m sunode_torch.experiments.split_ab [--old-root DIR] [--phase-clocks]
        [--geometry LANES,CLUSTER ...]

Run from the repository root (it reads ``chip_smoke.py``'s inputs).  Builds
``sunode_torch/csrc/adams_split.cu`` (history depth 11; the sweep does not
depend on it) and beside it:

  * ``--old-root DIR``: the same file of another checkout (unpack the parent
    with ``git archive`` into a directory ``.gitignore`` lists), its sweep
    launched as that checkout's wrapper launched it (``split_sweep_launch``
    with a scratch of partial sums and a tile counter, zeroed by a fill);
  * ``--geometry LANES,CLUSTER``: this tree's sweep at another geometry, a
    tile of LANES lanes and CLUSTER blocks a tile (each ``ceil(nz /
    CLUSTER)`` rows) in place of ``sweep_geometry``'s;
  * ``--phase-clocks``: this tree's source built with ``SPLIT_PHASE_CLOCKS``,
    which also traces the sweep by phase (rows, the block's sum, the first
    cluster barrier, rank 0's reads and the second barrier, rank 0's tail):
    the mean cycles a block spends in each over 20 launches.

At the five shapes the card's paths give the sweep (SIR over 1,000 regions:
its forward attempts at B=1,024 and 256, the 'resolve' backward at 1,024
and the staged 'hermite' backward at 256, on ``chip_smoke.split_inputs``;
the sensitivity block of Lotka-Volterra's staggered solve at B=10,000, on
its 300th attempt's inputs), the four sweeps of one attempt run on the plain
stages' iterates, and every version is held against the plain
``split_sweep``: ``y_next`` bit for bit, ``dy_old`` within 1e-12 lane by
lane, conv, div, bad and niter equal; this tree's two launches on the same
inputs bit for bit.  Then each version's device time (profiler, 20
launches, each after a 128 MB write) on the second sweep, in turns (this
tree's first and last), beside the sweep's bytes bound: with f as the
right-hand side returns it (lane-major from a ``vmap`` over the lanes, as
at the forward and sensitivity-block shapes, where the parent's wrapper
copies it to row-major first and this tree's kernel reads it so), and
with f row-major (the kernel alone).  Prints one line
per shape and version and writes every number to
``chiprun_out/split_ab.json``; exits non-zero on a mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SHAPES = (("forward", 1024), ("resolve", 1024), ("staged_adjoint", 256), ("forward", 256),
          ("staged_sensitivity", 10_000))
KAB = 11
SWEEP_KERNEL = "split_sweep_kernel"
PHASES = ("rows", "block_sum", "cluster_barrier", "rank0_reads", "tail")


class _OldSweep:
    """Another checkout's sweep, launched as its wrapper launched it."""

    def __init__(self, built):
        import torch

        self.built, self.torch = built, torch
        fn = built.lib.split_sweep_launch
        vp, c_int, c_double = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        fn.argtypes = [c_int] + [vp] * 11 + [c_double] * 2 + [c_int] * 4 + [vp] * 9 + [vp]
        fn.restype = c_int
        self.fn = fn

    def __call__(self, k, fz_k, y_it, pred, state, newton_tol, n):
        torch = self.torch
        from sunode_torch.ops.adams_split import SweepState

        fz_k, y_it = fz_k.contiguous(), y_it.contiguous()
        nz, B = pred.z_pred.shape
        dev = fz_k.device
        chunks, tiles = -(-nz // 64), -(-B // 32)
        y_next = torch.empty((n, B), dtype=torch.float64, device=dev)
        new = SweepState(*(torch.empty_like(x) for x in state))
        part = torch.empty((chunks, B), dtype=torch.float64, device=dev)
        part_bad = torch.empty((chunks, B), dtype=torch.uint8, device=dev)
        done = torch.empty((tiles,), dtype=torch.int32, device=dev)
        code = self.fn(
            int(k), fz_k.data_ptr(), y_it.data_ptr(), pred.z_pred.data_ptr(),
            pred.f_ex.data_ptr(), pred.w_z.data_ptr(), pred.c_A.data_ptr(),
            *(x.data_ptr() for x in state), float(newton_tol), 0.1 * float(newton_tol),
            int(not newton_tol > 0), n, nz, B, y_next.data_ptr(), *(x.data_ptr() for x in new),
            part.data_ptr(), part_bad.data_ptr(), done.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if code != 0:
            raise RuntimeError(f"split_ab: the old sweep's launch failed ({code})")
        return y_next, new


def _checks(cs, got, ref, swept) -> dict:
    """One version's sweep against the plain one."""
    import torch

    y, st = got
    y_p, st_p = ref
    return dict(
        y_next_bitwise=bool(torch.equal(y, y_p)),
        dy_old_lane_rel=cs.lane_rel(st.dy_old[swept], st_p.dy_old[swept]),
        flags_equal=all(bool(torch.equal(getattr(st, f), getattr(st_p, f)))
                        for f in ("conv", "div", "bad", "niter")),
    )


def _phase_cycles(lib, launch, reps=20) -> dict:
    """Mean cycles a block spends in each phase over ``reps`` launches, from
    a build with ``SPLIT_PHASE_CLOCKS``."""
    import torch

    read = lib.split_phase_cycles_read
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_ulonglong * 6)()
    torch.cuda.synchronize()
    if read(ctypes.addressof(out)):  # zero the counters
        raise RuntimeError("split_ab: reading the phase cycles failed")
    for _ in range(reps):
        launch()
    torch.cuda.synchronize()
    if read(ctypes.addressof(out)):
        raise RuntimeError("split_ab: reading the phase cycles failed")
    return {name: out[k] / out[5] for k, name in enumerate(PHASES)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-root", default=None)
    ap.add_argument("--phase-clocks", action="store_true")
    ap.add_argument("--geometry", action="append", default=[],
                    help="LANES,CLUSTER: this tree's sweep at another geometry")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from sunode_torch.experiments.exp_pece2d import HBM_BYTES_PER_S, device_us
    from sunode_torch.ops import adams_split as sp
    from sunode_torch.ops._nvcc_build import build_library
    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER
    from sunode_torch.ops.pece_step import _tables_header

    if not torch.cuda.is_available():
        raise SystemExit("split_ab: no CUDA device")
    _, smi = cs.check_device()

    kernels = sp.build_split_kernels(KAB)
    builds = {"default": (kernels.build_log, kernels.build_seconds)}
    old = None
    if args.old_root:
        old = _OldSweep(build_library(
            f"adams_split_kab{KAB}_old",
            Path(args.old_root).resolve() / "sunode_torch/csrc/adams_split.cu",
            headers={"pece_tables.h": _tables_header()}, defines=(f"ADAMS_KAB={KAB}",)))
        builds["old"] = (old.built.log, old.built.seconds)
    clocks = None
    if args.phase_clocks:
        clocks = sp._SplitKernels(KAB, defines=("SPLIT_PHASE_CLOCKS",))
        builds["SPLIT_PHASE_CLOCKS"] = (clocks.build_log, clocks.build_seconds)
    for name, (log, seconds) in builds.items():
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "split_sweep" in ln or "registers" in ln or "spill" in ln]
        cs.log(f"[build {name}] {seconds:.2f} s; ptxas: {'; '.join(ptxas)}")

    results, ok = [], True
    for seed, (kind, B) in enumerate(SHAPES, start=30):
        x = cs.split_inputs(B, seed, "cuda", kind=kind)
        fz, n, nz = cs.split_system(kind)
        p_max = x["DF"].shape[0] - 3
        pred = sp.split_predict(x["DF"], x["p"], x["pre_factor"], x["h"], x["z_prev"],
                                x["atol_z"], x["rtol_z"], p_max)
        tol = x["newton_tol"]
        versions = {"default": lambda *a: kernels.sweep(*a)}
        for spec in args.geometry:
            lanes, cluster = (int(v) for v in spec.split(","))
            g = sp.SweepGeometry(lanes, -(-nz // cluster), cluster, -(-B // lanes))
            if (cluster - 1) * g.rows >= nz:  # more blocks than rows: not a geometry here
                continue
            versions[f"lanes={lanes} cluster={cluster}"] = (
                lambda *a, g=g: kernels.sweep(*a, geometry=g))
        if old is not None:
            versions["old"] = old
        if clocks is not None:
            versions["SPLIT_PHASE_CLOCKS"] = lambda *a: clocks.sweep(*a)
        g = sp.sweep_geometry(nz, B)
        shape = f"{kind} nz={nz} n={n} B={B}"
        row = {"shape": shape, "smi": smi, "geometry": g._asdict(), "blocks": g.blocks,
               "versions": {name: {"checks": [], "device_us": []} for name in versions}}
        # the four sweeps of one attempt on the plain iterates
        y, state = pred.z_pred[:n], sp.sweep_start(x["active"])
        timed = None
        for k in range(FUNCTIONAL_MAXITER):
            fz_k = fz(x["t_new"], y, x["params"])
            ref = sp.split_sweep(k, fz_k, y, pred, state, tol, n)
            swept = torch.isfinite(ref[1].dy_old)  # lanes that never swept keep inf
            for name, run in versions.items():
                got = run(k, fz_k, y, pred, state, tol, n)
                check = _checks(cs, got, ref, swept)
                if name == "default":
                    again = run(k, fz_k, y, pred, state, tol, n)
                    check["two_launches_bitwise"] = bool(
                        torch.equal(got[0], again[0])
                        and all(torch.equal(a, b) for a, b in zip(got[1], again[1])))
                row["versions"][name]["checks"].append(check)
                ok &= (check["y_next_bitwise"] and check["flags_equal"]
                       and check["dy_old_lane_rel"] <= cs.REL_BOUND
                       and check.get("two_launches_bitwise", True))
            if k == 1:
                timed = (fz_k, y.clone(), state)
                row["fz_lane_major"] = not fz_k.is_contiguous()
            y, state = ref
        torch.cuda.synchronize()
        # device times on the second sweep, in turns: default first and last;
        # f as the right-hand side gives it, then row-major
        fz_k, y_k, st_k = timed
        fz_rows = fz_k.contiguous()
        names = list(versions)
        for name in names + names[::-1]:
            run = versions[name]
            times = row["versions"][name]["device_us"]
            times.append(device_us(lambda: run(1, fz_k, y_k, pred, st_k, tol, n),
                                   kernel=SWEEP_KERNEL))
            row["versions"][name].setdefault("device_us_row_major", []).append(device_us(
                lambda: run(1, fz_rows, y_k, pred, st_k, tol, n), kernel=SWEEP_KERNEL))
        if clocks is not None:
            row["phase_cycles"] = _phase_cycles(
                clocks._lib, lambda: clocks.sweep(1, fz_k, y_k, pred, st_k, tol, n))
        nbytes = cs.split_costs(x, n)["sweep"][0]
        row["bytes"], row["bound_us"] = nbytes, 1e6 * nbytes / HBM_BYTES_PER_S
        cs.log(f"[split-ab {shape}] {cs.fmt_sweep(nz, B)} bytes={nbytes} "
               f"bound_us={row['bound_us']:.3f} fz_lane_major={row['fz_lane_major']} | {smi}")
        for name, v in row["versions"].items():
            worst = max(c["dy_old_lane_rel"] for c in v["checks"])
            bitwise = all(c["y_next_bitwise"] for c in v["checks"])
            flags = all(c["flags_equal"] for c in v["checks"])
            again = all(c.get("two_launches_bitwise", True) for c in v["checks"])
            times = "/".join(cs.fmt_us(t) for t in v["device_us"])
            rows_t = "/".join(cs.fmt_us(t) for t in v["device_us_row_major"])
            cs.log(f"[split-ab {shape} | {name}] device_us={times} "
                   f"device_us_fz_row_major={rows_t} y_next_bitwise={bitwise} "
                   f"dy_old_lane_rel={worst:.2e} flags_equal={flags}"
                   + (f" two_launches_bitwise={again}" if name == "default" else ""))
        if "phase_cycles" in row:
            cs.log(f"[split-ab {shape} | SPLIT_PHASE_CLOCKS] mean cycles a block by phase "
                   + " ".join(f"{k}={c:.0f}" for k, c in row["phase_cycles"].items()))
        results.append(row)
        del x, pred, fz_k, fz_rows, y_k, st_k, timed, y, state
        torch.cuda.empty_cache()

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "split_ab.json").write_text(json.dumps(results, indent=1))
    if not ok:
        raise SystemExit("split_ab: a sweep disagrees with the plain stage")
    cs.log("[split-ab] every version agrees with the plain sweep")


if __name__ == "__main__":
    main()
