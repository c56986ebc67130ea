"""The history-attempt kernel against another version of itself, on the card.

    python3 history_ab.py [--old-root DIR] [--fmad-true] [--phase-clocks]

Builds ``sunode_torch/csrc/adams_attempt.cu`` for the seven systems
``chip_smoke.py`` phases 3c and 9(a) hold against the plain version (the LV
forward, transition, sensitivity and staged-sensitivity systems at history
depth 9; the forward, 'resolve' and staged-adjoint systems at depth 11),
and beside each build:

  * ``--old-root DIR``: the same file of another checkout (unpack the parent
    with ``git archive`` into a directory ``.gitignore`` lists), whose
    ``adams_attempt_launch`` takes the same arguments;
  * ``--fmad-true``: this tree's source built without the default build's
    ``-fmad=false`` (``adams_attempt.FMAD_FLAGS``), so that nvcc contracts
    the emitted right-hand side's products and sums into FMAs (the kernel's
    own arithmetic is rounded op by op in every build);
  * ``--phase-clocks``: this tree's source built with ``ADAMS_PHASE_CLOCKS``,
    which also traces the kernel by phase (loads and R, rows, PECE, update,
    norms): the mean cycles a block spends in each over 20 launches, at each
    of the three order settings.

On phase 3c's inputs (``chip_smoke.history_inputs``, the seeds of phases
3c and 9(a), and
the same inputs with every lane at p = 1 and at p = P_MAX) every other
version is held against this tree's default build: ``DF_resc`` bit for bit,
``DF_upd``, ``z_pred``, ``z_new`` and ``err0`` normwise, ``err3`` lane by
lane, ``conv`` and ``niter`` equal.  This tree's builds are also held to
ROADMAP C6's checks against the plain version (``chip_smoke.c6_check``):
``DF_resc`` and ``z_pred`` bit for bit, ``z_new``, ``err0`` and ``DF_upd``
bit for bit in the lanes where the build's emitted right-hand side rounds
as the plain one (``chip_smoke.rhs_agreement``, whose count is printed).
Then each version's device time (profiler, 20 launches) at the three order
settings, in turns (the default first and last).  Prints ptxas's registers
and spills and one line per build and version, and writes every number to
``chiprun_out/history_ab.json``.  Exits non-zero if a comparison fails.
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


def _builds(cs):
    """(label, device system, P_MAX, tol, seed) of the seven builds of
    phases 3c and 9(a); the device system's name is its plain right-hand
    side's (``chip_smoke.lv_plain_fz``, ``chip_smoke.lv_sens_fz``)."""
    from sunode_torch.entry import lv_problem
    from sunode_torch.symode import cuda_codegen

    problem = lv_problem()
    fwd = cuda_codegen.forward_system(problem)
    return [
        ("forward", fwd, cs.P_MAX, None, 0),
        ("transition", cuda_codegen.transition_system(problem), cs.P_MAX, None, 1),
        (f"forward KAB={cs.P_MAX_ADAMS + 3}", fwd, cs.P_MAX_ADAMS, cs.ADAMS_RTOL, 2),
        (f"resolve KAB={cs.P_MAX_ADAMS + 3}", cuda_codegen.resolve_system(problem),
         cs.P_MAX_ADAMS, cs.ADAMS_RTOL, 3),
        (f"staged_adjoint KAB={cs.P_MAX_ADAMS + 3}", cuda_codegen.staged_adjoint_system(problem),
         cs.P_MAX_ADAMS, cs.ADAMS_RTOL, 4),
        ("sensitivity", cuda_codegen.sensitivity_system(problem), cs.P_MAX, None, 20),
        ("staged_sensitivity", cuda_codegen.staged_sensitivity_system(problem), cs.P_MAX, None,
         21),
    ]


def _compare(cs, got, ref) -> dict:
    import torch

    rel, _ = cs.normwise(got, ref, ("DF_upd", "z_pred", "z_new", "err0"))
    rel["err3/lane"] = cs.lane_rel(got.err3, ref.err3)
    return dict(
        DF_resc_bitwise=bool(torch.equal(got.DF_resc, ref.DF_resc)),
        rel=rel,
        flags_equal=bool(torch.equal(got.conv, ref.conv) and torch.equal(got.niter, ref.niter)),
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
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from sunode_torch.experiments.exp_pece2d import device_us
    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER
    from sunode_torch.ops._nvcc_build import build_library
    from sunode_torch.entry import lv_problem
    from sunode_torch.ops.adams_attempt import (
        _CSRC,
        _AttemptKernel,
        adams_history_attempt_reference,
    )
    from sunode_torch.ops.pece_step import PeceSystem, _tables_header

    if not torch.cuda.is_available():
        raise SystemExit("history_ab: no CUDA device")
    _, smi = cs.check_device()

    def other_build(tag, source, flags=()):
        def build(ds, kab):
            return build_library(
                f"adams_attempt_{ds.name}_kab{kab}_{tag}", source,
                headers={"pece_rhs.h": ds.source, "pece_tables.h": _tables_header()},
                defines=(f"ADAMS_KAB={kab}",), extra_flags=flags)

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
    if args.old_root:
        versions["old"] = other_build(
            "old", Path(args.old_root).resolve() / "sunode_torch/csrc/adams_attempt.cu")
    if args.fmad_true:
        versions["fmad=true"] = other_build("fmad_true", _CSRC)
    if args.phase_clocks:
        versions["ADAMS_PHASE_CLOCKS"] = lambda ds, kab: _AttemptKernel(
            ds, kab, defines=("ADAMS_PHASE_CLOCKS",))

    builds = _builds(cs)
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
        x = cs.history_inputs(ds, cs.B_MAIN, seed, "cuda", p_max, tol)
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
                       and max(check["rel"].values()) <= SAME_BOUND)
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
                f"{o}: DF_resc_bitwise={c['DF_resc_bitwise']} flags_equal={c['flags_equal']} "
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
    (out / "history_ab.json").write_text(json.dumps(results, indent=1))
    if not ok:
        raise SystemExit("history_ab: a version differs from the default build beyond its "
                         "bounds, or a build of this tree fails C6's checks")
    cs.log("[history-ab] every version agrees with the default build")


if __name__ == "__main__":
    main()
