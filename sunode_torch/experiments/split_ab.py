"""The split attempt's three kernels against other versions of themselves, on the card.

    python -m sunode_torch.experiments.split_ab [--old-root DIR] [--phase-clocks]
        [--geometry LANES,CLUSTER ...] [--dtype float64|float32] [--rows]

Run from the repository root (it reads ``chip_smoke.py``'s inputs).  Builds
``sunode_torch/csrc/adams_split.cu`` at history depths 11 (SIR) and 9 (the
sensitivity block), every build at once, and beside it:

  * ``--old-root DIR``: the parent's ``adams_split.cu`` (unpack the parent
    with ``git archive`` into a directory ``.gitignore`` lists), whose three
    kernels take this tree's arguments and geometries, launched through
    this tree's wrapper (so its finish must have the one-chunk form,
    ``split_finish_geometry``, which takes no scratch);
  * ``--geometry LANES,CLUSTER``: this tree's predict and sweep at another
    geometry, a tile of LANES lanes and CLUSTER blocks a tile (each
    ``ceil(nz / CLUSTER)`` rows) in place of ``predict_geometry``'s and
    ``sweep_geometry``'s (predict takes at most 32 lanes);
  * ``--phase-clocks``: this tree's source built with ``SPLIT_PHASE_CLOCKS``,
    which also traces predict (R(fac) built, the rows, the block's flag
    sum, the lane tail), the sweep (rows, the block's sum, the first
    cluster barrier, rank 0's reads and the second barrier, rank 0's tail)
    and the finish (rows, the block's sums, the partials and the tile
    counter, the last block's tail; the one-chunk form has no counter) by
    phase: the mean cycles a block spends in each over 20 launches;
  * ``--dtype float32``: every build at float32 (``-DSUNODE_REAL=float``)
    on the same draws at float32 with SIR's float32 tolerances
    (``chip_smoke.split_inputs``; the sensitivity block's attempt rounded
    to float32), the per-lane sums' bound float32's
    (``chip_smoke.F32_REL_BOUND``); an old root must have the float32
    build too.  The default is float64.

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
    for bit, and every other version's outputs bit for bit this tree's.
    Then each version's device time on the second sweep, in turns, beside
    the sweep's bytes bound: with f as the right-hand side returns it
    (lane-major from a ``vmap`` over the lanes, as at the forward and
    sensitivity-block shapes) and with f row-major (the kernel alone);
  * finish: on the plain stages' last iterate, every version against the
    plain ``split_finish`` (DF_upd, z_new and err0 bit for bit, err3 within
    1e-12 lane by lane, conv equal) and bit for bit this tree's; device
    time in turns, the launcher's fill of its tile counters counted with
    it, beside its bytes bound.  Then the same finish checks and times for
    Lotka-Volterra's forward as a ``TorchProblem`` (nz = 2, B = 10,000) at
    history depths 9 and 11, whose rows fit the finish's one chunk.

With ``--rows`` (float64), in place of the five shapes, the state split's
rows entries at :data:`ROWS_LAYOUTS` (two and three blocks of the staged
'hermite' backward, two of the forward, B=256, every block on the card):
one attempt's four sweeps, every version's ``split_sweep_rows`` (the sweep
before decided inside it, the home block's f read in place) and
``split_finish_lanes`` against the plain stages on the same inputs (y_next,
the flags, the decided state, err3, conv and niter bit for bit; each
block's ss within ``REL_BOUND``, and bit for bit this tree's), then device
µs in turns beside ``chip_smoke.rows_costs``' bound: the rows' sweep on
sweep 1's inputs with the kernel's own partials of sweep 0 pending (at the
home block also on a copied block of f), the lanes' finish on the last
sweep's partials, the blocks the card holds at once, and with
``--phase-clocks`` the rows' sweep's and the lanes' finish's cycles a block
by phase; then two floors for the lanes' finish, timed as the kernels are
(``latency_probe.cu``): an empty kernel, and one thread's chain of
dependent loads through device memory at 1 and 9 hops, whose slope is one
round trip.  An old root there must have rows entries that take this
tree's arguments.

Prints ptxas's registers and spills of every build, one line per shape,
kernel and version, and writes every number to ``split_ab.json``
(``split_ab_float32.json`` at float32) in the output directory at the
repository root (one that ``.gitignore`` lists); exits non-zero on a
mismatch.
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


def _rel_bound(cs, x) -> float:
    """The per-lane sums' bound at the inputs' type."""
    import torch

    return cs.F32_REL_BOUND if x["DF"].dtype == torch.float32 else cs.REL_BOUND


def _sweep_row(cs, sp, x, fz, n, nz, pred, versions, clocks, smi, lib) -> tuple[dict, bool]:
    """The sweep at one shape: the four sweeps of one attempt on the plain
    iterates, every version against the plain ``split_sweep`` and bit for
    bit this tree's, device µs on the second sweep in turns (f as the
    right-hand side gives it, then row-major) beside the bytes bound, and
    the trace by phase; returns the row, whether it passed and the plain
    stages' last iterate and state."""
    import torch

    from sunode_torch.experiments.exp_pece2d import HBM_BYTES_PER_S, device_us
    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER

    B = x["DF"].shape[2]
    tol = x["newton_tol"]
    g = sp.sweep_geometry(nz, B)
    row = {"geometry": g._asdict(), "blocks": g.blocks,
           "versions": {name: {"checks": [], "device_us": []} for name in versions}}
    ok = True
    y, state = pred.z_pred[:n], sp.sweep_start(x["active"], x["DF"].dtype)
    timed = None
    for k in range(FUNCTIONAL_MAXITER):
        fz_k = fz(x["t_new"], y, x["params"])
        ref = sp.split_sweep(k, fz_k, y, pred, state, tol, n)
        swept = torch.isfinite(ref[1].dy_old)  # lanes that never swept keep inf
        default = versions["default"](k, fz_k, y, pred, state, tol, n)
        for name, run in versions.items():
            got = run(k, fz_k, y, pred, state, tol, n)
            check = _checks(cs, got, ref, swept)
            # a second launch of this tree's, every other version's against it
            check["two_launches_bitwise" if name == "default" else "same_as_default"] = (
                _same(got[0], default[0]) and all(_same(a, b) for a, b in zip(got[1], default[1])))
            row["versions"][name]["checks"].append(check)
            ok &= (check["y_next_bitwise"] and check["flags_equal"]
                   and check["dy_old_lane_rel"] <= _rel_bound(cs, x)
                   and check.get("two_launches_bitwise", True)
                   and (check.get("same_as_default", True) or name != "old"))
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
        key = "two_launches_bitwise" if name == "default" else "same_as_default"
        again = all(c[key] for c in v["checks"])
        times = "/".join(cs.fmt_us(t) for t in v["device_us"])
        rows_t = "/".join(cs.fmt_us(t) for t in v["device_us_row_major"])
        cs.log(f"[split-ab sweep {shape} | {name}] device_us={times} "
               f"device_us_fz_row_major={rows_t} y_next_bitwise={bitwise} "
               f"dy_old_lane_rel={worst:.2e} flags_equal={flags} {key}={again}")
    if "phase_cycles" in row:
        cs.log(f"[split-ab sweep {shape} | SPLIT_PHASE_CLOCKS] mean cycles a block by phase "
               + " ".join(f"{k}={c:.0f}" for k, c in row["phase_cycles"].items()))
    return row, ok, (y, state)


FINISH_KERNEL = "split_finish_kernel"
FINISH_PHASES = ("rows", "block_sums", "partials_counter", "tail")


def _finish_row(cs, sp, x, fz, n, nz, pred, last, versions, clocks,
                smi) -> tuple[dict, bool]:
    """The finish at one shape, on the plain stages' last iterate and state:
    every version against the plain ``split_finish`` (DF_upd, z_new and err0
    bit for bit, err3 lane by lane, conv equal) and bit for bit this
    tree's, device µs in turns (the launcher's fill with it) beside the
    bytes bound, and the trace by phase."""
    from sunode_torch.experiments.exp_pece2d import HBM_BYTES_PER_S, device_us

    y, state = last
    fin_in = (fz(x["t_new"], y, x["params"]), pred, state, x["p"], x["h"], x["gamma_star_abs"],
              x["v_err"], x["newton_tol"])
    ref = sp.split_finish(*fin_in, x["DF"].shape[0] - 3)
    default = versions["default"](*fin_in)
    row, ok = {"versions": {}}, True
    for name, run in versions.items():
        got = run(*fin_in)
        check = {f: _same(getattr(got, f), getattr(ref, f)) for f in ("DF_upd", "z_new", "err0",
                                                                       "conv")}
        check["err3_lane_rel"] = cs.lane_rel(got.err3, ref.err3)
        key = "two_launches_bitwise" if name == "default" else "same_as_default"
        check[key] = all(_same(a, b) for a, b in zip(got, default))
        ok &= (all(v for k, v in check.items() if k != "err3_lane_rel")
               and check["err3_lane_rel"] <= _rel_bound(cs, x))
        row["versions"][name] = {"checks": check, "device_us": []}
    _in_turns(versions, lambda name: row["versions"][name]["device_us"].append(
        device_us(lambda: versions[name](*fin_in), kernel=FINISH_KERNEL)))
    if clocks is not None:
        row["phase_cycles"] = _phase_cycles(clocks._lib, lambda: clocks.finish(*fin_in),
                                            FINISH_PHASES)
    nbytes = cs.split_costs(x, n)["finish"][0]
    row["bytes"], row["bound_us"] = nbytes, 1e6 * nbytes / HBM_BYTES_PER_S
    shape = f"{x['kind']} nz={nz} n={n} B={x['DF'].shape[2]}"
    cs.log(f"[split-ab finish {shape}] bytes={nbytes} bound_us={row['bound_us']:.3f} | {smi}")
    for name, v in row["versions"].items():
        times = "/".join(cs.fmt_us(t) for t in v["device_us"])
        cs.log(f"[split-ab finish {shape} | {name}] device_us={times} "
               + " ".join(f"{k}={c:.2e}" if isinstance(c, float) else f"{k}={c}"
                          for k, c in v["checks"].items()))
    if "phase_cycles" in row:
        cs.log(f"[split-ab finish {shape} | SPLIT_PHASE_CLOCKS] mean cycles a block by phase "
               + " ".join(f"{k}={c:.0f}" for k, c in row["phase_cycles"].items()))
    return row, ok


LV_B = 10_000  # Lotka-Volterra's forward as a TorchProblem: nz = 2 rows, B lanes


def _lv_forward_inputs(B, kab, seed):
    """One attempt's inputs of Lotka-Volterra's forward solve as a
    ``TorchProblem`` takes it to the split kernels at history depth ``kab``
    (orders 1..kab - 3, 90% of lanes active, the parameters with a 10%
    spread, rtol 1e-8 / atol 1e-10), its right-hand side, n and nz."""
    import numpy as np
    import torch

    from sunode_torch.entry import lv_problem
    from sunode_torch.ops.adams import _GAMMA_STAR
    from sunode_torch.ops.bdf import BDFOptions, newton_tol_for

    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device="cuda")
    T = lambda a: torch.as_tensor(a, **f64)  # noqa: E731
    DF = 1e-2 * rng.standard_normal((kab, 2, B)) * (0.5 ** np.arange(kab))[:, None, None]
    params = np.array([1.0, 0.3, 1.0, 0.4])[:, None] * (1 + 0.1 * rng.standard_normal((4, B)))
    x = dict(
        kind=f"lv_forward KAB={kab}", t_new=T(rng.uniform(0.0, 10.0, B)),
        h=T(10.0 ** rng.uniform(-4, -1, B)),
        pre_factor=T(np.exp(rng.uniform(np.log(0.2), np.log(2.0), B))),
        p=torch.as_tensor(rng.integers(1, kab - 2, B).astype(np.int32), device="cuda"),
        active=torch.as_tensor(rng.uniform(size=B) < 0.9, device="cuda"),
        DF=T(DF), z_prev=T(rng.uniform(0.5, 12.0, (2, B))), params=T(params),
        atol_z=T(np.full(2, 1e-10)), rtol_z=T(np.full(2, 1e-8)),
        gamma_star_abs=T(np.abs(_GAMMA_STAR)), v_err=T(np.full(2, 0.5)),
        newton_tol=newton_tol_for(BDFOptions(rtol=1e-8, atol=1e-10), 1e-8, torch.float64),
    )
    return x, lv_problem().make_rhs(), 2, 2


def _lv_forward_section(cs, sp, built, smi) -> tuple[list, bool]:
    """The finish of Lotka-Volterra's forward as a TorchProblem (nz = 2,
    B = 10,000) at history depths 9 and 11, on the plain stages' last
    iterate: :func:`_finish_row`'s checks, times and trace."""
    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER

    rows, ok = [], True
    for seed, kab in enumerate((9, 11), start=40):
        x, fz, n, nz = _lv_forward_inputs(LV_B, kab, seed)
        pred = sp.split_predict(x["DF"], x["p"], x["pre_factor"], x["h"], x["z_prev"],
                                x["atol_z"], x["rtol_z"], kab - 3)
        y, state = pred.z_pred, sp.sweep_start(x["active"])
        for k in range(FUNCTIONAL_MAXITER):
            y, state = sp.split_sweep(k, fz(x["t_new"], y, x["params"]), y, pred, state,
                                      x["newton_tol"], n)
        versions = {name: b.finish for (name, k), b in built.items()
                    if k == kab and name != "SPLIT_PHASE_CLOCKS"}
        row, ok_f = _finish_row(cs, sp, x, fz, n, nz, pred, (y, state), versions,
                                built.get(("SPLIT_PHASE_CLOCKS", kab)), smi)
        rows.append({"shape": f"{x['kind']} nz={nz} B={LV_B}", "finish": row})
        ok &= ok_f
    return rows, ok


ROWS_KERNEL = "split_sweep_rows_kernel"  # the state split's rows' sweep
LANES_KERNEL = "split_finish_lanes_kernel"
ROWS_PHASES = ("loads_issued", "decision", "rows", "block_sum", "partials")
LANES_PHASES = ("loads", "decision", "tail")
# (solve, blocks): the staged 'hermite' backward's 3,000 state rows and 2
# quadratures cut in 2 blocks (1,502 rows at home, 1,500) and in 3 (1,002
# at home, 1,000, 1,000), and the forward's 3,000 in 2 (its f lane-major)
ROWS_LAYOUTS = (("staged_adjoint", 2), ("staged_adjoint", 3), ("forward", 2))
ROWS_B = 256


PROBE = Path(__file__).resolve().parent / "latency_probe.cu"
PROBE_HOPS = (1, 9)  # dependent loads of the chain probe: the slope is one round trip
PROBE_STRIDE = 1 << 16  # int64 elements between two hops' lines (512 kB)


def _floors(cs, smi) -> dict:
    """Two floors beside the lanes' finish's device µs, timed as the kernels
    are (``latency_probe.cu``): an empty kernel, and one thread's chain of
    dependent loads through device memory at each of :data:`PROBE_HOPS`,
    whose slope is one dependent round trip."""
    import torch

    from sunode_torch.experiments.exp_pece2d import device_us
    from sunode_torch.ops._nvcc_build import build_library

    lib = build_library("latency_probe", PROBE).lib
    vp = ctypes.c_void_p
    lib.probe_empty_launch.argtypes = [vp]
    lib.probe_chain_launch.argtypes = [vp, ctypes.c_int, vp, vp]
    lib.probe_empty_launch.restype = lib.probe_chain_launch.restype = ctypes.c_int

    def check(code):
        if code != 0:
            raise RuntimeError(f"split_ab: a probe launch failed ({code})")

    hops = max(PROBE_HOPS)
    at = torch.arange(hops + 1, dtype=torch.int64, device="cuda") * PROBE_STRIDE
    nxt = torch.zeros(PROBE_STRIDE * (hops + 1), dtype=torch.int64, device="cuda")
    nxt[at[:-1]] = at[1:]  # hop h reads the line of hop h + 1's address
    out = torch.empty(1, dtype=torch.int64, device="cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    floors = {"empty_us": device_us(lambda: check(lib.probe_empty_launch(stream())),
                                    kernel="probe_empty_kernel")}
    for h in PROBE_HOPS:
        floors[f"chain_{h}_us"] = device_us(
            lambda h=h: check(lib.probe_chain_launch(nxt.data_ptr(), h, out.data_ptr(),
                                                     stream())),
            kernel="probe_chain_kernel")
        if int(out) != h * PROBE_STRIDE:
            raise RuntimeError("split_ab: the chain probe did not follow its chain")
    lo, hi = (floors[f"chain_{h}_us"] for h in (min(PROBE_HOPS), hops))
    floors["round_trip_us"] = (None if lo is None or hi is None
                               else (hi - lo) / (hops - min(PROBE_HOPS)))
    cs.log("[split-ab floors] device_us " + " ".join(f"{k}={cs.fmt_us(v)}"
                                                     for k, v in floors.items()) + f" | {smi}")
    return floors


def _rows_section(cs, sp, versions, clocks, smi) -> tuple[list, bool]:
    """The state split's rows entries at :data:`ROWS_LAYOUTS`, every block
    on the card: one attempt's four sweeps driven by this tree's
    ``split_sweep_rows`` (the sweep before decided inside it from every
    block's partials, the home block's f read in place), each version and
    the plain stage on the same inputs; y_next, the flags and the decided
    state bit for bit the plain stage's, each block's ss (its ranks added in
    rank order) within ``REL_BOUND`` of the plain sum and bit for bit this
    tree's; then ``split_finish_lanes`` on the last sweep's partials, err3,
    conv and niter bit for bit.  Then device µs in turns, beside
    ``chip_smoke.rows_costs``' bound: the rows' sweep at the timed blocks on
    sweep 1's inputs (the kernel's own partials of sweep 0 pending; at the
    home block also on a copied block of f), the lanes' finish on the last
    partials; the blocks the card holds at once, and the rows' sweep's
    cycles a block by phase from the ``SPLIT_PHASE_CLOCKS`` build."""
    import torch

    from sunode_torch.experiments.exp_pece2d import HBM_BYTES_PER_S, device_us
    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER
    from sunode_torch.parallel.rows import RowBlocks, RowLayout, lane_all, lane_sum, scatter

    new = versions["default"]
    dev = torch.device("cuda", 0)
    results, ok = [], True
    for kind, blocks in ROWS_LAYOUTS:
        x = cs.split_inputs(ROWS_B, 31, "cuda", kind=kind)
        fz, n, nz = cs.split_system(kind)
        tol, B = x["newton_tol"], ROWS_B
        sizes = [n // blocks] * (blocks - 1) + [n - n // blocks * (blocks - 1)]
        L = RowLayout.contiguous((dev,) * blocks, sizes).with_rows(nz - n)
        n_d = L.state_rows(n)
        home = {"rows": L.segments[0]}
        DF, z_prev = scatter(L, x["DF"]).blocks, scatter(L, x["z_prev"]).blocks
        col = {k: scatter(L, x[k][:, None]).blocks for k in ("atol_z", "rtol_z", "v_err")}
        preds = [sp.split_predict(D, x["p"], x["pre_factor"], x["h"], z, a[:, 0], r[:, 0],
                                  KAB - 3)
                 for D, z, a, r in zip(DF, z_prev, col["atol_z"], col["rtol_z"])]
        y = [pr.z_pred[:m] for pr, m in zip(preds, n_d)]
        state = sp.sweep_start(x["active"], x["DF"].dtype)
        pending, timed = None, None
        checks = {"y_next": True, "flags": True, "state": True, "ss_in_bound": True,
                  "ss_this_tree": True, "finish_lanes": True}
        for k in range(FUNCTIONAL_MAXITER):
            f_all = fz(x["t_new"], RowBlocks(L, y).gather(), x["params"])
            f_b = scatter(L, f_all).blocks
            if k == 1:  # sweep 1's inputs: the kernel's own partials of sweep 0 pending
                timed = (f_all, f_b, [yy.clone() for yy in y], state, pending)
            outs = []
            for d, (f, yy, pr, m) in enumerate(zip(f_b, y, preds, n_d)):
                where = home if d == 0 else {}
                f = f_all if d == 0 else f
                ref, st_p = sp.split_sweep_rows(f, yy, pr, state, m, pending, **where)
                for name, run in versions.items():
                    got, st = run.sweep_rows(f, yy, pr, state, m, pending, **where)
                    s_blk = sp.pending_sums(sp.Pending(k, (got.ss,), (got.nonfinite,), tol, n),
                                            dev)[0]
                    checks["y_next"] &= _same(got.y_next, ref.y_next)
                    checks["flags"] &= _same(got.nonfinite.any(dim=0), ref.nonfinite[0])
                    checks["state"] &= all(_same(a, b) for a, b in zip(st, st_p))
                    checks["ss_in_bound"] &= cs.lane_rel(s_blk, ref.ss[0]) <= cs.REL_BOUND
                    if name == "default":
                        outs.append(got)
                        s_new = s_blk
                    else:
                        checks["ss_this_tree"] &= _same(s_blk, s_new)
            state = st_p
            pending = sp.Pending(k, tuple(o.ss for o in outs), tuple(o.nonfinite for o in outs),
                                 tol, n)
            y = [o.y_next for o in outs]
        f_b = scatter(L, fz(x["t_new"], RowBlocks(L, y).gather(), x["params"])).blocks
        g = x["gamma_star_abs"]
        ss3 = lane_sum([sp.split_finish_rows(f, pr, x["p"], x["h"], g, v[:, 0], KAB - 3).ss3
                        for f, pr, v in zip(f_b, preds, col["v_err"])], dev)
        pred_ok = lane_all([pr.pred_ok for pr in preds], dev)
        ref = sp.split_finish_lanes(ss3, pred_ok, state, tol, pending)
        for run in versions.values():
            got = run.finish_lanes(ss3, pred_ok, state, tol, pending)
            checks["finish_lanes"] &= all(_same(a, b) for a, b in zip(got, ref))
        torch.cuda.synchronize()
        ok &= all(checks.values())
        shape = f"{kind} nz={nz} n={n} B={B} blocks={L.sizes}"
        row = {"shape": shape, "checks": checks, "smi": smi, "blocks": []}
        cs.log(f"[split-ab rows {shape}] four sweeps and the lanes' finish, every version "
               f"against the plain stages: {checks} | {smi}")
        costs = [cs.rows_costs(KAB, L.sizes[d], n_d[d], B, g.numel(), blocks=blocks)
                 for d in range(blocks)]
        for d in (0, 1) if (kind, blocks) == ("staged_adjoint", 2) else (0,):
            nz_d, m, pr = L.sizes[d], n_d[d], preds[d]
            geo = sp.sweep_geometry(nz_d, B)
            nbytes = costs[d]["sweep_rows"][0]
            f_all, f_tb, ys, st, pend = timed
            f, yy, where = (f_all, ys[d], home) if d == 0 else (f_tb[d], ys[d], {})
            brow = {"block": d, "rows": nz_d, "state_rows": m, "geometry": geo._asdict(),
                    "bytes": nbytes, "bound_us": 1e6 * nbytes / HBM_BYTES_PER_S,
                    "device_us": {}}
            timing = {name: lambda run=run: run.sweep_rows(f, yy, pr, st, m, pend, **where)
                      for name, run in versions.items()}
            if d == 0:  # the home block's f copied out, as scatter copies the others'
                timing["default_copied_f"] = lambda: new.sweep_rows(f_tb[0], yy, pr, st, m, pend)
            for name in timing:
                brow["device_us"][name] = []
            _in_turns(timing, lambda name: brow["device_us"][name].append(
                device_us(timing[name], kernel=ROWS_KERNEL)))
            if clocks is not None:
                brow["phase_cycles"] = _phase_cycles(
                    clocks._lib, lambda: clocks.sweep_rows(f, yy, pr, st, m, pend, **where),
                    ROWS_PHASES)
            brow["blocks_at_once"] = _clusters_at_once(
                new._lib, 4 if (d == 0 and not f_all.is_contiguous()) else 3,
                sp.SweepGeometry(geo.lanes, geo.rows, 1, geo.tiles))
            times = " ".join(f"{name}=" + "/".join(cs.fmt_us(t) for t in ts)
                             for name, ts in brow["device_us"].items())
            cs.log(f"[split-ab rows {shape} | sweep_rows block {d}: {nz_d} rows, {m} state "
                   f"rows] {cs.fmt_sweep(nz_d, B)} blocks_at_once={brow['blocks_at_once']} "
                   f"bytes={nbytes} bound_us={brow['bound_us']:.3f} device_us {times} | {smi}")
            if "phase_cycles" in brow:
                cs.log(f"[split-ab rows {shape} | sweep_rows block {d} | SPLIT_PHASE_CLOCKS] "
                       "mean cycles a block by phase "
                       + " ".join(f"{k}={c:.0f}" for k, c in brow["phase_cycles"].items()))
            row["blocks"].append(brow)
        nbytes = costs[0]["finish_lanes"][0]
        lanes = {"bytes": nbytes, "bound_us": 1e6 * nbytes / HBM_BYTES_PER_S,
                 "device_us": {name: [] for name in versions}}
        _in_turns(versions, lambda name: lanes["device_us"][name].append(device_us(
            lambda: versions[name].finish_lanes(ss3, pred_ok, state, tol, pending),
            kernel=LANES_KERNEL)))
        if clocks is not None:
            lanes["phase_cycles"] = _phase_cycles(
                clocks._lib, lambda: clocks.finish_lanes(ss3, pred_ok, state, tol, pending),
                LANES_PHASES)
        times = " ".join(f"{name}=" + "/".join(cs.fmt_us(t) for t in ts)
                         for name, ts in lanes["device_us"].items())
        cs.log(f"[split-ab rows {shape} | finish_lanes, {sum(p.shape[0] for p in pending.ss)} "
               f"partials a lane] bytes={nbytes} bound_us={lanes['bound_us']:.3f} "
               f"device_us {times} | {smi}")
        if "phase_cycles" in lanes:
            cs.log(f"[split-ab rows {shape} | finish_lanes | SPLIT_PHASE_CLOCKS] mean cycles a "
                   "block by phase "
                   + " ".join(f"{k}={c:.0f}" for k, c in lanes["phase_cycles"].items()))
        row["finish_lanes"] = lanes
        results.append(row)
        del x, preds, DF, z_prev, timed
        torch.cuda.empty_cache()
    return results, ok


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-root", default=None)
    ap.add_argument("--phase-clocks", action="store_true")
    ap.add_argument("--geometry", action="append", default=[],
                    help="LANES,CLUSTER: this tree's predict and sweep at another geometry")
    ap.add_argument("--dtype", choices=("float64", "float32"), default="float64")
    ap.add_argument("--rows", action="store_true",
                    help="the state split's rows entries in place of the five path shapes")
    args = ap.parse_args(argv)
    old_root = Path(args.old_root).resolve() if args.old_root else None
    old_source = None if old_root is None else old_root / "sunode_torch/csrc/adams_split.cu"
    if args.rows and (args.dtype != "float64" or args.geometry):
        ap.error("--rows runs at float64 on the rows' own geometry")
    if old_source is not None and "split_finish_geometry" not in old_source.read_text():
        ap.error("--old-root: the parent's finish must have its one-chunk form "
                 "(split_finish_geometry), whose launch takes no scratch at nz <= 64")
    if args.rows and old_source is not None and (
            "split_sweep_decide_launch" in old_source.read_text()):
        ap.error("--rows: the parent's rows entries must take this tree's arguments (the "
                 "sweep before decided inside the rows' sweep)")

    import torch

    import chip_smoke as cs
    from sunode_torch.ops import adams_split as sp

    if not torch.cuda.is_available():
        raise SystemExit("split_ab: no CUDA device")
    _, smi = cs.check_device()
    dtype = getattr(torch, args.dtype)
    real = sp.c_real(dtype)

    # predict's and the finish's builds at each shape's history depth (9 for
    # the sensitivity block, 11 for SIR), the sweep's at 11 (it does not
    # read the history)
    kabs = [KAB] if args.rows else sorted({KAB, 9})
    jobs = {}
    for kab in kabs:
        jobs[("default", kab)] = lambda kab=kab: sp.build_split_kernels(kab, dtype)
        if old_source is not None:
            jobs[("old", kab)] = lambda kab=kab: sp._SplitKernels(kab, source=old_source,
                                                                  real=real)
        if args.phase_clocks:
            jobs[("SPLIT_PHASE_CLOCKS", kab)] = lambda kab=kab: sp._SplitKernels(
                kab, defines=("SPLIT_PHASE_CLOCKS",), real=real)
    with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc for each build, all at once
        built = dict(zip(jobs, pool.map(lambda job: job(), jobs.values())))
    for (name, kab), b in built.items():
        ptxas = [ln.strip() for ln in b.build_log.splitlines()
                 if "split_" in ln or "registers" in ln or "spill" in ln]
        cs.log(f"[build {name} KAB={kab}] {b.build_seconds:.2f} s; ptxas: {'; '.join(ptxas)}")

    results, ok = [], True
    if args.rows:
        versions = {name: built[(name, KAB)] for name in ("default", "old")
                    if (name, KAB) in built}
        rows, ok = _rows_section(cs, sp, versions, built.get(("SPLIT_PHASE_CLOCKS", KAB)), smi)
        results.append({"rows": rows, "floors": _floors(cs, smi)})
    for seed, (kind, B) in enumerate(() if args.rows else SHAPES, start=30):
        x = cs.split_inputs(B, seed, "cuda", kind=kind, dtype=dtype)
        # the sensitivity block's attempt is a float64 solve's: rounded to the type
        x = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v
             for k, v in x.items()}
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
        finishes = {"default": kernels.finish}
        if old_source is not None:  # the parent's kernels take this tree's arguments
            predicts["old"] = built[("old", kab)].predict
            sweeps["old"] = built[("old", KAB)].sweep
            finishes["old"] = built[("old", kab)].finish
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
        row["sweep"], ok_s, last = _sweep_row(cs, sp, x, fz, n, nz, pred, sweeps,
                                              built.get(("SPLIT_PHASE_CLOCKS", KAB)), smi,
                                              built[("default", KAB)]._lib)
        row["finish"], ok_f = _finish_row(cs, sp, x, fz, n, nz, pred, last, finishes, clocks,
                                          smi)
        ok &= ok_p and ok_s and ok_f
        results.append(row)
        del x, pred, last
        torch.cuda.empty_cache()

    if not args.rows and args.dtype == "float64":
        lv_rows, ok_lv = _lv_forward_section(cs, sp, built, smi)
        results.append({"lv_forward": lv_rows})
        ok &= ok_lv

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    fname = "split_ab.json" if real == "double" else "split_ab_float32.json"
    (out / fname).write_text(json.dumps(results, indent=1))
    if not ok:
        raise SystemExit("split_ab: a kernel disagrees with its plain stage or with this tree's")
    cs.log("[split-ab] every version agrees with the plain stages and with this tree's build")


if __name__ == "__main__":
    main()
