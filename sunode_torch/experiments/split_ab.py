"""The split attempt's predict and sweep kernels against other versions of themselves, on the card.

    python -m sunode_torch.experiments.split_ab [--old-root DIR] [--phase-clocks]
        [--geometry LANES,CLUSTER ...]

Run from the repository root (it reads ``chip_smoke.py``'s inputs).  Builds
``sunode_torch/csrc/adams_split.cu`` at history depths 11 (SIR) and 9 (the
sensitivity block), every build at once, and beside it:

  * ``--old-root DIR``: the parent's ``adams_split.cu`` (unpack the parent
    with ``git archive`` into a directory ``.gitignore`` lists), its predict
    (32 lanes by 64 rows a block, with a scratch of per-chunk flags and a
    tile counter that its launcher zeroes with a fill) and its sweep
    launched as the parent's wrapper launched them;
  * ``--geometry LANES,CLUSTER``: this tree's predict and sweep at another
    geometry, a tile of LANES lanes and CLUSTER blocks a tile (each
    ``ceil(nz / CLUSTER)`` rows) in place of ``predict_geometry``'s and
    ``sweep_geometry``'s (predict takes at most 32 lanes);
  * ``--phase-clocks``: this tree's source built with ``SPLIT_PHASE_CLOCKS``,
    which also traces predict (R(fac) built, the rows, the block's flag
    sum, the lane tail) and the sweep (rows, the block's sum, the first
    cluster barrier, rank 0's reads and the second barrier, rank 0's tail)
    by phase: the mean cycles a block spends in each over 20 launches.

At the five shapes the card's paths give the split kernels (SIR over 1,000
regions: its forward attempts at B=1,024 and 256, the 'resolve' backward at
1,024 and the staged 'hermite' backward at 256, on
``chip_smoke.split_inputs``; the sensitivity block of Lotka-Volterra's
staggered solve at B=10,000, on its 300th attempt's inputs):

  * predict: every version is held bit for bit to the plain
    ``split_predict`` on all six outputs, and this tree's two launches on
    the same inputs to each other; then each version's device time
    (profiler, 20 launches, each after a 128 MB write; a version's fill
    counted with it) in turns, this tree's first and last, beside the
    bytes bound of ``chip_smoke.split_costs``;
  * sweep: the four sweeps of one attempt run on the plain stages'
    iterates, and every version is held against the plain ``split_sweep``:
    ``y_next`` bit for bit, ``dy_old`` within 1e-12 lane by lane, conv, div,
    bad and niter equal; this tree's two launches on the same inputs bit
    for bit.  Then each version's device time on the second sweep, in
    turns, beside the sweep's bytes bound: with f as the right-hand side
    returns it (lane-major from a ``vmap`` over the lanes, as at the
    forward and sensitivity-block shapes) and with f row-major (the kernel
    alone).

Prints ptxas's registers and spills of every build, one line per shape,
kernel and version, and writes every number to ``split_ab.json`` in the
output directory at the repository root (one that ``.gitignore`` lists); exits
non-zero on a mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SHAPES = (("forward", 1024), ("resolve", 1024), ("staged_adjoint", 256), ("forward", 256),
          ("staged_sensitivity", 10_000))
KAB = 11  # SIR's history depth; the sensitivity block's is 9
SWEEP_KERNEL = "split_sweep_kernel"
PREDICT_KERNEL = "split_predict_kernel"
PHASES = ("rows", "block_sum", "cluster_barrier", "rank0_reads", "tail")
PREDICT_PHASES = ("tables", "rows", "block_flags", "lane_tail")


def _same(a, b) -> bool:
    """Bit for bit, a NaN equal to a NaN."""
    import torch

    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    return bool(torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num()))


class _OldPredict:
    """The parent's predict (32 lanes by 64 rows a block), launched as its
    wrapper launched it: a scratch of per-chunk flags and a counter per lane
    tile, which its launcher zeroes with a fill.  ``lib_path`` is the
    parent's build; this handle's argument types are its own."""

    def __init__(self, lib_path):
        fn = ctypes.CDLL(str(lib_path)).split_predict_launch
        vp, c_int = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 7 + [c_int] * 3 + [vp] * 8 + [vp]
        fn.restype = c_int
        self.fn = fn

    def __call__(self, DF, p, pre_factor, h_use, z_prev, atol_z, rtol_z):
        import torch

        from sunode_torch.ops.adams_split import Predicted

        KAB, nz, B = DF.shape
        dev = DF.device
        f64 = dict(dtype=torch.float64, device=dev)
        out = Predicted(torch.empty((KAB, nz, B), **f64), *(torch.empty((nz, B), **f64)
                                                              for _ in range(3)),
                        torch.empty((B,), **f64), torch.empty((B,), dtype=torch.bool, device=dev))
        part = torch.empty((-(-nz // 64), B), dtype=torch.uint8, device=dev)
        done = torch.empty((-(-B // 32),), dtype=torch.int32, device=dev)
        code = self.fn(
            DF.data_ptr(), p.data_ptr(), pre_factor.data_ptr(), h_use.data_ptr(),
            z_prev.data_ptr(), atol_z.data_ptr(), rtol_z.data_ptr(), KAB, nz, B,
            *(o.data_ptr() for o in out), part.data_ptr(), done.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if code != 0:
            raise RuntimeError(f"split_ab: the old predict's launch failed ({code})")
        return out


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


def _phase_cycles(lib, launch, phases, reps=20) -> dict:
    """Mean cycles a block spends in each of ``phases`` over ``reps``
    launches, from a build with ``SPLIT_PHASE_CLOCKS``."""
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
    return {name: out[k] / out[5] for k, name in enumerate(phases)}


def _clusters_at_once(lib, kernel: int, g) -> int:
    """The clusters of geometry ``g`` that the card holds at once for
    predict's kernel (0) or the sweep's (1 row-major, 2 lane-major)."""
    fn = lib.split_max_active_clusters
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    code = fn(kernel, g.lanes, g.cluster, ctypes.addressof(out))
    if code != 0:
        raise RuntimeError(f"split_ab: the cluster occupancy query failed ({code})")
    return out.value


def _in_turns(versions, time_one) -> None:
    """``time_one(name)`` for every version, then again in reverse order:
    the first version first and last."""
    names = list(versions)
    for name in names + names[::-1]:
        time_one(name)


def _predict_row(cs, sp, x, n, nz, versions, clocks, smi, lib,
                 geometries) -> tuple[dict, bool]:
    """Predict at one shape: every version bit for bit against the plain
    ``split_predict``, this tree's two launches against each other, device
    µs in turns beside the bytes bound, the trace by phase, and the clusters
    the card holds at once at each geometry (``lib``, this tree's build)."""
    import torch

    from sunode_torch.experiments.exp_pece2d import HBM_BYTES_PER_S, device_us

    B = x["DF"].shape[2]
    stage_in = (x["DF"], x["p"], x["pre_factor"], x["h"], x["z_prev"], x["atol_z"], x["rtol_z"])
    ref = sp.split_predict(*stage_in, x["DF"].shape[0] - 3)
    g = sp.predict_geometry(nz, B)
    row = {"geometry": g._asdict(), "clusters_at_once": _clusters_at_once(lib, 0, g),
           "versions": {}}
    ok = True
    for name, run in versions.items():
        got = run(*stage_in)
        check = {f: _same(getattr(got, f), getattr(ref, f)) for f in sp.Predicted._fields}
        if name == "default":
            again = run(*stage_in)
            check["two_launches_bitwise"] = all(_same(a, b) for a, b in zip(got, again))
        torch.cuda.synchronize()
        ok &= all(check.values())
        row["versions"][name] = {"checks": check, "device_us": []}
        del got
    _in_turns(versions, lambda name: row["versions"][name]["device_us"].append(
        device_us(lambda: versions[name](*stage_in), kernel=PREDICT_KERNEL)))
    if clocks is not None:
        row["phase_cycles"] = _phase_cycles(clocks._lib, lambda: clocks.predict(*stage_in),
                                            PREDICT_PHASES)
    nbytes = cs.split_costs(x, n)["predict"][0]
    row["bytes"], row["bound_us"] = nbytes, 1e6 * nbytes / HBM_BYTES_PER_S
    shape = f"{x['kind']} nz={nz} n={n} B={B}"
    cs.log(f"[split-ab predict {shape}] predict: lanes_per_tile={g.lanes} "
           f"rows_per_block={g.rows} cluster={g.cluster} tiles={g.tiles} "
           f"clusters_at_once={row['clusters_at_once']} bytes={nbytes} "
           f"bound_us={row['bound_us']:.3f} | {smi}")
    for label, gg in geometries:
        if gg.lanes <= sp.PREDICT_LANES_MAX:
            cs.log(f"[split-ab predict {shape} | {label}] rows_per_block={gg.rows} "
                   f"tiles={gg.tiles} clusters_at_once={_clusters_at_once(lib, 0, gg)}")
    for name, v in row["versions"].items():
        times = "/".join(cs.fmt_us(t) for t in v["device_us"])
        share = "/".join("not measured" if t is None else f"{row['bound_us'] / t:.3f}"
                         for t in v["device_us"])
        cs.log(f"[split-ab predict {shape} | {name}] device_us={times} share_of_bound={share} "
               + " ".join(f"{k}={c}" for k, c in v["checks"].items()))
    if "phase_cycles" in row:
        cs.log(f"[split-ab predict {shape} | SPLIT_PHASE_CLOCKS] mean cycles a block by phase "
               + " ".join(f"{k}={c:.0f}" for k, c in row["phase_cycles"].items()))
    del ref
    return row, ok


def _sweep_row(cs, sp, x, fz, n, nz, pred, versions, clocks, smi, lib) -> tuple[dict, bool]:
    """The sweep at one shape: the four sweeps of one attempt on the plain
    iterates, every version against the plain ``split_sweep``, device µs on
    the second sweep in turns (f as the right-hand side gives it, then
    row-major) beside the bytes bound, and the trace by phase."""
    import torch

    from sunode_torch.experiments.exp_pece2d import HBM_BYTES_PER_S, device_us
    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER

    B = x["DF"].shape[2]
    tol = x["newton_tol"]
    g = sp.sweep_geometry(nz, B)
    row = {"geometry": g._asdict(), "blocks": g.blocks,
           "versions": {name: {"checks": [], "device_us": []} for name in versions}}
    ok = True
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
    fz_k, y_k, st_k = timed
    fz_rows = fz_k.contiguous()

    def time_one(name):
        run, v = versions[name], row["versions"][name]
        v["device_us"].append(device_us(lambda: run(1, fz_k, y_k, pred, st_k, tol, n),
                                        kernel=SWEEP_KERNEL))
        v.setdefault("device_us_row_major", []).append(device_us(
            lambda: run(1, fz_rows, y_k, pred, st_k, tol, n), kernel=SWEEP_KERNEL))

    _in_turns(versions, time_one)
    if clocks is not None:
        row["phase_cycles"] = _phase_cycles(
            clocks._lib, lambda: clocks.sweep(1, fz_k, y_k, pred, st_k, tol, n), PHASES)
    nbytes = cs.split_costs(x, n)["sweep"][0]
    row["bytes"], row["bound_us"] = nbytes, 1e6 * nbytes / HBM_BYTES_PER_S
    shape = f"{x['kind']} nz={nz} n={n} B={B}"
    row["clusters_at_once"] = _clusters_at_once(lib, 2 if row["fz_lane_major"] else 1, g)
    cs.log(f"[split-ab sweep {shape}] {cs.fmt_sweep(nz, B)} "
           f"clusters_at_once={row['clusters_at_once']} bytes={nbytes} "
           f"bound_us={row['bound_us']:.3f} fz_lane_major={row['fz_lane_major']} | {smi}")
    for name, v in row["versions"].items():
        worst = max(c["dy_old_lane_rel"] for c in v["checks"])
        bitwise = all(c["y_next_bitwise"] for c in v["checks"])
        flags = all(c["flags_equal"] for c in v["checks"])
        again = all(c.get("two_launches_bitwise", True) for c in v["checks"])
        times = "/".join(cs.fmt_us(t) for t in v["device_us"])
        rows_t = "/".join(cs.fmt_us(t) for t in v["device_us_row_major"])
        cs.log(f"[split-ab sweep {shape} | {name}] device_us={times} "
               f"device_us_fz_row_major={rows_t} y_next_bitwise={bitwise} "
               f"dy_old_lane_rel={worst:.2e} flags_equal={flags}"
               + (f" two_launches_bitwise={again}" if name == "default" else ""))
    if "phase_cycles" in row:
        cs.log(f"[split-ab sweep {shape} | SPLIT_PHASE_CLOCKS] mean cycles a block by phase "
               + " ".join(f"{k}={c:.0f}" for k, c in row["phase_cycles"].items()))
    return row, ok


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-root", default=None)
    ap.add_argument("--phase-clocks", action="store_true")
    ap.add_argument("--geometry", action="append", default=[],
                    help="LANES,CLUSTER: this tree's predict and sweep at another geometry")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from sunode_torch.ops import adams_split as sp

    if not torch.cuda.is_available():
        raise SystemExit("split_ab: no CUDA device")
    _, smi = cs.check_device()

    # predict's builds at each shape's history depth (9 for the sensitivity
    # block, 11 for SIR), the sweep's at 11 (it does not read the history)
    kabs = sorted({KAB, 9})
    old_root = Path(args.old_root).resolve() if args.old_root else None
    jobs = {}
    for kab in kabs:
        jobs[("default", kab)] = lambda kab=kab: sp.build_split_kernels(kab)
        if old_root is not None:
            jobs[("old", kab)] = lambda kab=kab: sp._SplitKernels(
                kab, source=old_root / "sunode_torch/csrc/adams_split.cu")
        if args.phase_clocks:
            jobs[("SPLIT_PHASE_CLOCKS", kab)] = lambda kab=kab: sp._SplitKernels(
                kab, defines=("SPLIT_PHASE_CLOCKS",))
    with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc for each build, all at once
        built = dict(zip(jobs, pool.map(lambda job: job(), jobs.values())))
    for (name, kab), b in built.items():
        ptxas = [ln.strip() for ln in b.build_log.splitlines()
                 if "split_" in ln or "registers" in ln or "spill" in ln]
        cs.log(f"[build {name} KAB={kab}] {b.build_seconds:.2f} s; ptxas: {'; '.join(ptxas)}")

    results, ok = [], True
    for seed, (kind, B) in enumerate(SHAPES, start=30):
        x = cs.split_inputs(B, seed, "cuda", kind=kind)
        x["kind"] = kind
        fz, n, nz = cs.split_system(kind)
        geometries = []
        for spec in args.geometry:
            lanes, cluster = (int(v) for v in spec.split(","))
            g = sp.SweepGeometry(lanes, -(-nz // cluster), cluster, -(-B // lanes))
            if (cluster - 1) * g.rows < nz:  # else more blocks than rows: not a geometry here
                geometries.append((f"lanes={lanes} cluster={cluster}", g))
        kab = x["DF"].shape[0]
        kernels = built[("default", kab)]
        predicts = {"default": kernels.predict}
        for label, g in geometries:
            if g.lanes <= sp.PREDICT_LANES_MAX:
                predicts[label] = lambda *a, g=g: kernels.predict(*a, geometry=g)
        sweeps = {"default": built[("default", KAB)].sweep}
        for label, g in geometries:
            sweeps[label] = lambda *a, g=g: built[("default", KAB)].sweep(*a, geometry=g)
        if old_root is not None:  # the parent's sweep takes this tree's arguments
            predicts["old"] = _OldPredict(built[("old", kab)].lib_path)
            sweeps["old"] = built[("old", KAB)].sweep
        clocks = built.get(("SPLIT_PHASE_CLOCKS", kab))
        if clocks is not None:
            predicts["SPLIT_PHASE_CLOCKS"] = clocks.predict
            sweeps["SPLIT_PHASE_CLOCKS"] = built[("SPLIT_PHASE_CLOCKS", KAB)].sweep
        row = {"shape": f"{kind} nz={nz} n={n} B={B}", "smi": smi}
        row["predict"], ok_p = _predict_row(cs, sp, x, n, nz, predicts, clocks, smi,
                                            kernels._lib, geometries)
        torch.cuda.empty_cache()
        pred = sp.split_predict(x["DF"], x["p"], x["pre_factor"], x["h"], x["z_prev"],
                                x["atol_z"], x["rtol_z"], x["DF"].shape[0] - 3)
        row["sweep"], ok_s = _sweep_row(cs, sp, x, fz, n, nz, pred, sweeps,
                                        built.get(("SPLIT_PHASE_CLOCKS", KAB)), smi,
                                        built[("default", KAB)]._lib)
        ok &= ok_p and ok_s
        results.append(row)
        del x, pred
        torch.cuda.empty_cache()

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "split_ab.json").write_text(json.dumps(results, indent=1))
    if not ok:
        raise SystemExit("split_ab: a predict or a sweep disagrees with the plain stage")
    cs.log("[split-ab] every version agrees with the plain predict and sweep")


if __name__ == "__main__":
    main()
