"""The history-attempt kernel against another version of itself, on the card.

    python3 history_ab.py [--old-root DIR] [--fmad-true] [--phase-clocks]
                          [--dtype float64|float32]

Builds ``sunode_torch/csrc/adams_attempt.cu`` for the seven systems
``chip_smoke.py`` phases 3c and 9(a) hold against the plain version (the LV
forward, transition, sensitivity and staged-sensitivity systems at history
depth 9; the forward, 'resolve' and staged-adjoint systems at depth 11),
and beside each build:

  * ``--old-root DIR``: the same file of another checkout (unpack the parent
    with ``git archive`` into a directory ``.gitignore`` lists), whose
    ``adams_attempt_launch`` takes the same arguments, built with this
    tree's flags (``-fmad=false``, as the wrapper builds it since C6);
  * ``--fmad-true``: this tree's source built without the default build's
    ``-fmad=false`` (``adams_attempt.FMAD_FLAGS``), so that nvcc contracts
    the emitted right-hand side's products and sums into FMAs (the kernel's
    own arithmetic is rounded op by op in every build);
  * ``--phase-clocks``: this tree's source built with ``ADAMS_PHASE_CLOCKS``,
    which also traces the kernel by phase (loads and R, rows, PECE, update,
    norms): the mean cycles a block spends in each over 20 launches, at each
    of the three order settings;
  * ``--dtype float32``: every build, this tree's and the others, at
    float32 (``-DSUNODE_REAL=float``, the systems emitted at float), on the
    same draws at float32 with lv_adjoint_f32's tolerances (rtol = atol =
    1e-6 on a forward system, 1e-5 on a backward one), its bounds
    float32's (``chip_smoke.F32_REL_BOUND``); an old root must have the
    float32 build too.  The default is float64.

On phase 3c's inputs (``chip_smoke.history_inputs``, the seeds of phases
3c and 9(a), and
the same inputs with every lane at p = 1 and at p = P_MAX) every other
version is held against this tree's default build: ``DF_resc`` bit for bit,
``DF_upd``, ``z_pred``, ``z_new`` and ``err0`` normwise, ``err3`` lane by
lane, ``conv`` and ``niter`` equal; the old root's build bit for bit on
every output (``all_bitwise``).  This tree's builds are also held to
ROADMAP C6's checks against the plain version (``chip_smoke.c6_check``):
``DF_resc`` and ``z_pred`` bit for bit, ``z_new``, ``err0`` and ``DF_upd``
bit for bit in the lanes where the build's emitted right-hand side rounds
as the plain one (``chip_smoke.rhs_agreement``, whose count is printed).
Then each version's device time (profiler, 20 launches) at the three order
settings, in turns (the default first and last).  Prints ptxas's registers
and spills and one line per build and version, and writes every number to
``history_ab.json`` (``history_ab_float32.json`` at float32) in the output
directory at the repository root (one that ``.gitignore`` lists).  Exits
non-zero if a comparison fails.
"""

from __future__ import annotations

import argparse
import copy
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SAME_BOUND = 1e-12  # the emitted right-hand side's FMA contraction (with and without
# -fmad=false) moves err3 by up to ~2.5e-13 of a lane's own; the rest rounds op by op


def _builds(cs, real="double"):
    """(label, device system, P_MAX, tol, seed) of the seven builds of
    phases 3c and 9(a), the systems emitted at the C type ``real``; the
    device system's name is its plain right-hand side's
    (``chip_smoke.lv_plain_fz``, ``chip_smoke.lv_sens_fz``).  At float the
    tolerances are lv_adjoint_f32's: 1e-6 on a forward system (its rows all
    state), 1e-5 on a backward one."""
    from sunode_torch.entry import lv_problem
    from sunode_torch.symode import cuda_codegen

    problem = lv_problem()

    def emit(kind):
        return getattr(cuda_codegen, f"{kind}_system")(problem, real)

    def tol(ds, f64_tol):
        if real == "double":
            return f64_tol
        return cs.F32_FWD_TOL if ds.nz == ds.n else cs.F32_BWD_TOL

    builds = [
        ("forward", emit("forward"), cs.P_MAX, None, 0),
        ("transition", emit("transition"), cs.P_MAX, None, 1),
        (f"forward KAB={cs.P_MAX_ADAMS + 3}", emit("forward"), cs.P_MAX_ADAMS, cs.ADAMS_RTOL, 2),
        (f"resolve KAB={cs.P_MAX_ADAMS + 3}", emit("resolve"), cs.P_MAX_ADAMS, cs.ADAMS_RTOL, 3),
        (f"staged_adjoint KAB={cs.P_MAX_ADAMS + 3}", emit("staged_adjoint"), cs.P_MAX_ADAMS,
         cs.ADAMS_RTOL, 4),
        ("sensitivity", emit("sensitivity"), cs.P_MAX, None, 20),
        ("staged_sensitivity", emit("staged_sensitivity"), cs.P_MAX, None, 21),
    ]
    return [(label, ds, p_max, tol(ds, t), seed) for label, ds, p_max, t, seed in builds]


def _compare(cs, got, ref) -> dict:
    import torch

    rel, _ = cs.normwise(got, ref, ("DF_upd", "z_pred", "z_new", "err0"))
    rel["err3/lane"] = cs.lane_rel(got.err3, ref.err3)
    # every output bit for bit, a NaN equal to a NaN
    same = [torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())
            if a.is_floating_point() else torch.equal(a, b) for a, b in zip(got, ref)]
    return dict(
        DF_resc_bitwise=bool(torch.equal(got.DF_resc, ref.DF_resc)),
        rel=rel,
        flags_equal=bool(torch.equal(got.conv, ref.conv) and torch.equal(got.niter, ref.niter)),
        all_bitwise=all(same),
    )


PHASES = ("loads_and_R", "rows", "pece", "update", "norms")


def _phase_cycles(kernel, launch, reps=20) -> dict:
    """Mean cycles a block spends in each phase over ``reps`` launches, from
    a build with ``ADAMS_PHASE_CLOCKS``."""
    import ctypes

    import torch

    read = kernel._lib.adams_attempt_phase_cycles
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_ulonglong * 6)()
    torch.cuda.synchronize()
    if read(ctypes.addressof(out)):  # zero the counters
        raise RuntimeError("history_ab: reading the phase cycles failed")
    for _ in range(reps):
        launch()
    torch.cuda.synchronize()
    if read(ctypes.addressof(out)):
        raise RuntimeError("history_ab: reading the phase cycles failed")
    blocks = out[5]
    return {name: out[k] / blocks for k, name in enumerate(PHASES)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-root", default=None)
    ap.add_argument("--fmad-true", action="store_true")
    ap.add_argument("--phase-clocks", action="store_true")
    ap.add_argument("--dtype", choices=("float64", "float32"), default="float64")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from sunode_torch.experiments.exp_pece2d import device_us
    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER
    from sunode_torch.ops._nvcc_build import build_library
    from sunode_torch.entry import lv_problem
    from sunode_torch.ops.adams_attempt import (
        _CSRC,
        FMAD_FLAGS,
        _AttemptKernel,
        adams_history_attempt_reference,
        real_build,
    )
    from sunode_torch.ops.pece_step import PeceSystem, _tables_header

    if not torch.cuda.is_available():
        raise SystemExit("history_ab: no CUDA device")
    _, smi = cs.check_device()
    dtype = getattr(torch, args.dtype)
    real = "float" if dtype == torch.float32 else "double"
    same_bound = cs.F32_REL_BOUND if real == "float" else SAME_BOUND

    def other_build(tag, source, flags=()):
        def build(ds, kab):
            suffix, defines, _ = real_build(ds.real)
            return build_library(
                f"adams_attempt_{ds.name}_kab{kab}{suffix}_{tag}", source,
                headers={"pece_rhs.h": ds.source, "pece_tables.h": _tables_header(ds.real)},
                defines=(f"ADAMS_KAB={kab}", *defines), extra_flags=flags)

        return build

    def bound_as(kernel, built):
        """``kernel``'s wrapper on another build of the same C entry point."""
        k = copy.copy(kernel)
        for fn in ("adams_attempt_launch", "adams_attempt_error_string"):
            ours, theirs = getattr(kernel._lib, fn), getattr(built.lib, fn)
            theirs.argtypes, theirs.restype = ours.argtypes, ours.restype
        k._lib, k.build_log, k.build_seconds, k.lib_path = (
            built.lib, built.log, built.seconds, built.path)
        return k

    versions = {"default": _AttemptKernel}
    if args.old_root:  # built as the other checkout's wrapper builds it
        versions["old"] = other_build(
            "old", Path(args.old_root).resolve() / "sunode_torch/csrc/adams_attempt.cu",
            FMAD_FLAGS)
    if args.fmad_true:
        versions["fmad=true"] = other_build("fmad_true", _CSRC)
    if args.phase_clocks:
        versions["ADAMS_PHASE_CLOCKS"] = lambda ds, kab: _AttemptKernel(
            ds, kab, defines=("ADAMS_PHASE_CLOCKS",))

    builds = _builds(cs, real)
    with ThreadPoolExecutor(len(builds) * len(versions)) as pool:
        futures = {
            (label, name): pool.submit(make, ds, p_max + 3)
            for label, ds, p_max, _, _ in builds for name, make in versions.items()
        }
        kernels = {key: f.result() for key, f in futures.items()}
    for (label, name), k in kernels.items():
        if name in ("old", "fmad=true"):
            kernels[(label, name)] = k = bound_as(kernels[(label, "default")], k)
        ptxas = [ln.strip() for ln in k.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        cs.log(f"[build {label} | {name}] {k.build_seconds:.2f} s; "
               f"sass_instructions={cs.sass_instructions(k.lib_path)}; ptxas: {'; '.join(ptxas)}")

    results, ok = [], True
    problem = lv_problem()
    for label, ds, p_max, tol, seed in builds:
        x = cs.history_inputs(ds, cs.B_MAIN, seed, "cuda", p_max, tol, dtype)
        orders = {"seeded": x["p"], "p1": torch.full_like(x["p"], 1),
                  f"p{p_max}": torch.full_like(x["p"], p_max)}
        fz = (cs.lv_sens_fz(ds.name) if ds.name in cs.SENS_KINDS
              else cs.lv_plain_fz(problem, ds.name))
        plain = PeceSystem(fz=fz, n=ds.n, nz=ds.nz, device=ds)

        def run(name, p, DF=x["DF"], z=x["z_prev"], maxiter=FUNCTIONAL_MAXITER):
            return kernels[(label, name)].launch(
                x["t_new"], x["h"], x["pre_factor"], p, x["active"], DF, z,
                x["params"], x["atol_z"], x["rtol_z"], x["gamma_star_abs"], x["v_err"],
                x["newton_tol"], maxiter)

        row = {"build": label, "smi": smi, "versions": {}}
        names = list(versions)
        for name in names:
            row["versions"][name] = {"checks": {}, "c6": {}, "device_us": {}}
            for o, p in orders.items():
                got, ref = run(name, p), run("default", p)
                torch.cuda.synchronize()
                if name in ("default", "fmad=true"):  # this tree's source: C6's checks
                    agree = cs.rhs_agreement(lambda *a: run(name, *a), fz, ds.n,
                                             {**x, "p": p}, p_max)
                    c6 = cs.c6_check(got, adams_history_attempt_reference(
                        plain, x["t_new"], x["h"], x["pre_factor"], p, x["active"], x["DF"],
                        x["z_prev"], x["params"], x["atol_z"], x["rtol_z"],
                        x["gamma_star_abs"], x["v_err"], x["newton_tol"], FUNCTIONAL_MAXITER,
                        p_max), agree)
                    row["versions"][name]["c6"][o] = dict(c6, f_agrees_in=int(agree.sum()))
                    ok &= all(c6.values())
                if name == "default":
                    continue
                check = _compare(cs, got, ref)
                row["versions"][name]["checks"][o] = check
                ok &= (check["DF_resc_bitwise"] and check["flags_equal"]
                       and max(check["rel"].values()) <= same_bound
                       and (check["all_bitwise"] or name != "old"))
        # device times in turns: default, the others, the others reversed, default
        for name in names + names[::-1]:
            for o, p in orders.items():
                us = device_us(lambda: run(name, p), kernel=cs.HISTORY_KERNEL)
                row["versions"][name]["device_us"].setdefault(o, []).append(us)
        for name in names:
            if "ADAMS_PHASE_CLOCKS" in name:
                row["versions"][name]["phase_cycles"] = {
                    o: _phase_cycles(kernels[(label, name)], lambda: run(name, p))
                    for o, p in orders.items()}
        for name, v in row["versions"].items():
            for o, cycles in v.get("phase_cycles", {}).items():
                cs.log(f"[history-ab {label} | {name}] {o}: mean cycles a block by phase "
                       + " ".join(f"{k}={c:.0f}" for k, c in cycles.items()))
            checks = "; ".join(
                f"{o}: DF_resc_bitwise={c['DF_resc_bitwise']} all_bitwise={c['all_bitwise']} "
                f"flags_equal={c['flags_equal']} "
                + " ".join(f"{k}={e:.2e}" for k, e in c["rel"].items())
                for o, c in v["checks"].items())
            times = " ".join(f"{o}=" + "/".join(cs.fmt_us(t) for t in ts)
                             for o, ts in v["device_us"].items())
            c6 = "; ".join(f"{o}: " + " ".join(f"{k}={c}" for k, c in checks_o.items())
                           for o, checks_o in v["c6"].items())
            cs.log(f"[history-ab {label} | {name}] device_us {times}"
                   + (f" | {checks}" if checks else "") + (f" | C6 {c6}" if c6 else "")
                   + f" | {smi}")
        results.append(row)

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    fname = "history_ab.json" if real == "double" else "history_ab_float32.json"
    (out / fname).write_text(json.dumps(results, indent=1))
    if not ok:
        raise SystemExit("history_ab: a version differs from the default build beyond its "
                         "bounds, or a build of this tree fails C6's checks")
    cs.log("[history-ab] every version agrees with the default build")


if __name__ == "__main__":
    main()
