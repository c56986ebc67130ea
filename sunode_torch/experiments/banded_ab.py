"""The batched banded LU's factor and solve kernels against the parent's, on the card.

    python -m sunode_torch.experiments.banded_ab [--old-root DIR] [--phase-clocks]
        [--sass] [--latencies]

Run from the repository root (it reads ``chip_smoke.py``'s inputs).  Builds
``sunode_torch/csrc/banded.cu`` at bandwidths (1, 1), float64 and float32,
every build at once, and beside it:

  * ``--old-root DIR``: the parent's ``banded.cu`` (unpack the parent with
    ``git archive`` into a directory ``.gitignore`` lists), launched
    through its own C interface, which takes no geometry;
  * ``--phase-clocks``: this tree's source built with
    ``BANDED_PHASE_CLOCKS``, and with ``--old-root`` the parent's source
    with the same marks put in at its phase boundaries (written beside it
    as ``banded_phase_clocks.cu``): the mean cycles a block spends in the
    factor's staging (this tree: until the first chunk has landed; the
    parent: its first pass over the working storage), column loop and
    stores, and in the solve's forward and backward passes, over 20
    launches, and the cycles a nanosecond of the block's wall time
    (``%globaltimer``), the clock the SM ran at;
  * ``--sass``: every build's machine code (``cuobjdump -sass``) into
    ``banded_sass/`` in the output directory, for counting a step's chain;
  * ``--latencies``: the cycles of one dependent operation of each kind
    the kernels' chains hold (add, multiply, divide with the dividend or
    the divisor on the chain, |a| compared and selected), at both types,
    from one thread's chain of 2,048 of them (``clock64``).

On ``chip_smoke.newton_band_inputs`` (the Fisher-KPP chain's Newton
matrices, random band entries in lanes 16-23 so rows swap, lane 5
singular) at n = 128 and 256, B = 1,024, both types: every version's lu,
piv and sing bit for bit the plain ``banded_factor_reference``'s, and its
solutions at m = 1 and 3, poisoned and not, bit for bit the plain
``banded_solve_reference``'s (and so each other's); then each version's
device µs from HBM (``exp_pece2d.device_us``, 20 launches each after a
128 MB write) and warm (20 launches back to back, :func:`warm_us`) in
turns, this tree's first and last, beside the bytes bound of
``chip_smoke.banded_cost``; and device µs from HBM on the Newton matrices
alone (``newton_band_inputs(test_lanes=False)``), the path's data, where no
lane tile waits on the divide's slow path.  Writes every number to ``banded_ab.json``
in the output directory at the repository root (one that ``.gitignore``
lists); exits non-zero on a mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NS = (128, 256)
B = 1024
MS = (1, 3)
FACTOR_KERNEL = "banded_factor_kernel"
SOLVE_KERNEL = "banded_solve_kernel"
FACTOR_PHASES = ("staging", "column_loop", "stores")
SOLVE_PHASES = ("forward", "backward")
CLOCK_REPS = 20

# Where the parent's source takes the phase marks: (anchor, text put in
# before it), each anchor found exactly once.
PARENT_MARKS = (
    ("  const int nw = n + BAND_W;\n  // the untouched slots", "  BAND_CLOCK_START\n"),
    ("  // a[d][c] = A[k + d][k + c]", "  BAND_MARK(banded_factor_cycles, 0)\n"),
    ("  sing[lane] = singular ? 1 : 0;\n", "  BAND_MARK(banded_factor_cycles, 1)\n"),
    ("}\n\n// One thread a (lane, right-hand side)",
     "  BAND_MARK(banded_factor_cycles, 2)\n  BAND_COUNT_BLOCK(banded_factor_cycles, 3)\n"),
    ("  const size_t rhs = (size_t)blockIdx.y * n;", "  BAND_CLOCK_START\n"),
    ("  // backward: v[c - 1] = x[k + c]", "  BAND_MARK(banded_solve_cycles, 0)\n"),
    ("}\n\nextern \"C\" {",
     "  BAND_MARK(banded_solve_cycles, 1)\n  BAND_COUNT_BLOCK(banded_solve_cycles, 2)\n"),
    ("}  // extern \"C\"", None),  # the reader, taken from this tree's source
)

LATENCY_PROBE = r"""
// One thread's chain of dependent operations of one kind, timed with clock64.
#include "real.cuh"

template <int OP>
__global__ void latency_probe(real* io, long long* cycles, int iters) {
  real a = io[0];
  const real b = io[1], c = io[2];
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (OP == 0) a = r_add(a, b);
      if (OP == 1) a = r_mul(a, b);
      if (OP == 2) a = r_div(a, b);  // the dividend on the chain
      if (OP == 3) a = r_div(c, a);  // the divisor on the chain
      if (OP == 4) a = (r_abs(a) > b) ? c : a;  // |a| compared and selected
    }
  }
  const long long t1 = clock64();
  io[3 + OP] = a;
  cycles[OP] = t1 - t0;
}

extern "C" int latency_probe_run(real* io, long long* cycles, int iters) {
  latency_probe<0><<<1, 1>>>(io, cycles, iters);
  latency_probe<1><<<1, 1>>>(io, cycles, iters);
  latency_probe<2><<<1, 1>>>(io, cycles, iters);
  latency_probe<3><<<1, 1>>>(io, cycles, iters);
  latency_probe<4><<<1, 1>>>(io, cycles, iters);
  return (int)cudaDeviceSynchronize();
}
"""
LATENCY_OPS = ("add", "mul", "div_dividend_chained", "div_divisor_chained", "abs_compare_select")
LATENCY_ITERS = 64  # x 32 operations


class _Parent:
    """The parent's ``csrc/banded.cu`` at (1, 1), launched through its own C
    interface (one thread a lane, no geometry)."""

    def __init__(self, source: Path, dtype, defines=()):
        from sunode_torch.ops._nvcc_build import build_library
        from sunode_torch.ops.adams_attempt import FMAD_FLAGS, c_real, real_build

        suffix, real_defines, self.dtype = real_build(c_real(dtype))
        built = build_library(f"banded_parent_l1_u1{suffix}", source,
                              defines=("BAND_L=1", "BAND_U=1", *real_defines, *defines),
                              extra_flags=FMAD_FLAGS)
        self.build_log, self.build_seconds, self.lib_path = built.log, built.seconds, built.path
        lib = built.lib
        vp, c_int = ctypes.c_void_p, ctypes.c_int
        lib.banded_factor_launch.argtypes = [vp] + [c_int] * 4 + [vp] * 4
        lib.banded_solve_launch.argtypes = [vp] * 4 + [c_int] * 5 + [vp] * 2
        lib.banded_factor_launch.restype = lib.banded_solve_launch.restype = c_int
        self._lib = lib

    def factor(self, ab):
        import torch

        _, n, nb = ab.shape
        lu = torch.empty((4, n + 2, nb), dtype=ab.dtype, device=ab.device)
        piv = torch.empty((n, nb), dtype=torch.int32, device=ab.device)
        sing = torch.empty((nb,), dtype=torch.bool, device=ab.device)
        code = self._lib.banded_factor_launch(ab.data_ptr(), 1, 1, n, nb, lu.data_ptr(),
                                              piv.data_ptr(), sing.data_ptr(),
                                              torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"banded_ab: the parent's factor launch failed ({code})")
        return lu, piv, sing

    def solve(self, lu, piv, sing, b):
        import torch

        m, n, nb = b.shape
        x = torch.empty_like(b)
        code = self._lib.banded_solve_launch(
            lu.data_ptr(), piv.data_ptr(), None if sing is None else sing.data_ptr(),
            b.data_ptr(), 1, 1, n, m, nb, x.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"banded_ab: the parent's solve launch failed ({code})")
        return x


def _clocks_block(text: str) -> tuple[str, str]:
    """This tree's phase-clock definitions and reader, to put in the
    parent's source."""
    head = text.split("#ifdef BANDED_PHASE_CLOCKS\n", 1)[1].split("#else\n", 1)[0]
    reader = text.rsplit("#ifdef BANDED_PHASE_CLOCKS\n", 1)[1].split("#endif\n", 1)[0]
    return head, reader


def parent_with_marks(old_source: Path) -> Path:
    """The parent's source with this tree's phase marks at its phase
    boundaries, written beside it; raises if an anchor is not found once."""
    head, reader = _clocks_block((ROOT / "sunode_torch/csrc/banded.cu").read_text())
    text = old_source.read_text()
    include = '#include "real.cuh"\n'
    if text.count(include) != 1:
        raise RuntimeError("banded_ab: the parent's source has no single real.cuh include")
    text = text.replace(include, include + head)
    for anchor, mark in PARENT_MARKS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"banded_ab: anchor {anchor!r} is not in the parent's source once")
        text = text.replace(anchor, (reader if mark is None else mark) + anchor)
    out = old_source.with_name("banded_phase_clocks.cu")
    out.write_text(text)
    return out


def _block_spans(lib, launch, blocks) -> dict:
    """One launch's blocks: the spread of their starts, the shortest and
    longest block, and the launch's span from the first start to the last
    end, microseconds (``%globaltimer``)."""
    import torch

    read = lib.banded_block_ns_read
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    out = (ctypes.c_ulonglong * (2 * blocks))()
    launch()
    torch.cuda.synchronize()
    if read(ctypes.addressof(out), blocks):
        raise RuntimeError("banded_ab: reading the block times failed")
    start, end = list(out[0::2]), list(out[1::2])
    took = [b - a for a, b in zip(start, end)]
    return {"start_spread_us": (max(start) - min(start)) / 1e3, "block_min_us": min(took) / 1e3,
            "block_max_us": max(took) / 1e3, "span_us": (max(end) - min(start)) / 1e3}


def _phase_cycles(lib, launch) -> dict:
    """Mean cycles a block spends in each phase over CLOCK_REPS launches of
    ``launch`` (the factor's or the solve's, whose blocks are counted)."""
    import torch

    read = lib.banded_phase_cycles_read
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_ulonglong * 12)()
    torch.cuda.synchronize()
    if read(ctypes.addressof(out)):  # zero the counters
        raise RuntimeError("banded_ab: reading the phase cycles failed")
    for _ in range(CLOCK_REPS):
        launch()
    torch.cuda.synchronize()
    if read(ctypes.addressof(out)):
        raise RuntimeError("banded_ab: reading the phase cycles failed")
    cycles = {}
    if out[3]:
        cycles.update({name: out[k] / out[3] for k, name in enumerate(FACTOR_PHASES)})
        cycles["column_loop_waiting"] = out[5] / out[3]
        cycles["factor_cycles_per_ns"] = sum(out[:3]) / out[4]
    if out[8]:
        cycles.update({name: out[6 + k] / out[8] for k, name in enumerate(SOLVE_PHASES)})
        cycles["forward_waiting"] = out[10] / out[8]
        cycles["backward_waiting"] = out[11] / out[8]
        cycles["solve_cycles_per_ns"] = sum(out[6:8]) / out[9]
    return cycles


def latencies(dtype) -> dict:
    """Cycles of one dependent operation of each kind, at ``dtype``."""
    import torch

    from sunode_torch.ops._nvcc_build import BUILD_ROOT, build_library
    from sunode_torch.ops.adams_attempt import FMAD_FLAGS, c_real, real_build

    suffix, real_defines, _ = real_build(c_real(dtype))
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    src = BUILD_ROOT / "banded_latency_probe.cu"
    src.write_text(LATENCY_PROBE)
    csrc = ROOT / "sunode_torch" / "csrc"
    lib = build_library(f"banded_latency_probe{suffix}", src, defines=real_defines,
                        extra_flags=(*FMAD_FLAGS, "-I", str(csrc))).lib
    lib.latency_probe_run.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.latency_probe_run.restype = ctypes.c_int
    # a: 0.5; b: near 1, so a chain of 2,048 stays normal; c: 1.5
    io = torch.tensor([0.5, 1.0000001, 1.5] + [0.0] * len(LATENCY_OPS), dtype=dtype,
                      device="cuda")
    cycles = torch.zeros(len(LATENCY_OPS), dtype=torch.int64, device="cuda")
    for _ in range(2):  # the first run loads the module
        if lib.latency_probe_run(io.data_ptr(), cycles.data_ptr(), LATENCY_ITERS):
            raise RuntimeError("banded_ab: the latency probe failed")
    per = cycles.cpu().tolist()
    return {op: c / (32 * LATENCY_ITERS) for op, c in zip(LATENCY_OPS, per)}


def dump_sass(builds: dict, out: Path) -> dict:
    """Every build's ``cuobjdump -sass`` into ``out``; the instructions of
    each kernel by build."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise SystemExit("banded_ab: --sass needs cuobjdump")
    out.mkdir(parents=True, exist_ok=True)
    counts = {}
    for name, b in builds.items():
        sass = subprocess.run([tool, "-sass", str(b.lib_path)], capture_output=True, text=True,
                              check=True).stdout
        (out / f"{name}.sass").write_text(sass)
        per, current = {}, None
        for ln in sass.splitlines():
            if "Function :" in ln:
                current = ln.split("Function :")[1].strip()
                per[current] = 0
            elif current and ln.strip().startswith("/*") and "*/" in ln and ";" in ln:
                per[current] += 1
        counts[name] = per
    return counts


def warm_us(fn, kernel, reps=20, tries=3):
    """Device microseconds a call of ``kernel`` over ``reps`` calls back to
    back, with nothing between them (inputs in the 50 MB L2, the code in
    the caches): the kernel's own time, against ``device_us``'s from HBM."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        mine = [e for e in prof.key_averages() if kernel in e.key]
        if mine and sum(e.count for e in mine) == reps:
            return sum(e.self_device_time_total for e in mine) / reps
    return None


def _bits(cs, got, ref) -> bool:
    return all(cs.bits_equal(a, b) for a, b in zip(got, ref))


def compare_shape(cs, bd, dtype, n, versions, clocks, smi) -> tuple[dict, bool]:
    """Every version at one (type, n): bit for bit against the plain
    versions, device µs in turns, the phase cycles."""
    import torch

    from sunode_torch.experiments.exp_pece2d import HBM_BYTES_PER_S, device_us

    M, b = cs.newton_band_inputs(n, B, dtype)
    ref_f = bd.banded_factor_reference(M, 1, 1)
    row = {"n": n, "dtype": str(dtype), "smi": smi, "versions": {}}
    ok = True
    factors = {}
    for name, v in versions.items():
        f = v.factor(M)
        checks = {"factor_bitwise": _bits(cs, f, ref_f)}
        for m in MS:
            for poisoned in (True, False):
                fk = f if poisoned else (f[0], f[1], None)
                fp = ref_f if poisoned else (ref_f[0], ref_f[1], None)
                x = v.solve(*fk, b[:m].contiguous())
                x_p = bd.banded_solve_reference(fp, b[:m].contiguous(), 1, 1)
                checks[f"x_m{m}{'' if poisoned else '_unpoisoned'}_bitwise"] = cs.bits_equal(x, x_p)
        torch.cuda.synchronize()
        ok &= all(checks.values())
        factors[name] = f
        row["versions"][name] = {"checks": checks, "factor_us": [], "factor_warm_us": [],
                                 "factor_newton_us": [],
                                 **{f"solve_m{m}_us": [] for m in MS},
                                 **{f"solve_m{m}_warm_us": [] for m in MS},
                                 **{f"solve_m{m}_newton_us": [] for m in MS}}

    # the path's lanes alone: no singular or random test lane, whose tile
    # takes the divide's slow path
    Mn, _ = cs.newton_band_inputs(n, B, dtype, test_lanes=False)
    newton = {name: v.factor(Mn) for name, v in versions.items()}

    def time_one(name):
        v, r = versions[name], row["versions"][name]
        r["factor_newton_us"].append(device_us(lambda: v.factor(Mn), kernel=FACTOR_KERNEL))
        for m in MS:
            bm = b[:m].contiguous()
            r[f"solve_m{m}_newton_us"].append(
                device_us(lambda: v.solve(*newton[name], bm), kernel=SOLVE_KERNEL))
        r["factor_us"].append(device_us(lambda: v.factor(M), kernel=FACTOR_KERNEL))
        r["factor_warm_us"].append(warm_us(lambda: v.factor(M), FACTOR_KERNEL))
        for m in MS:
            bm = b[:m].contiguous()
            r[f"solve_m{m}_us"].append(
                device_us(lambda: v.solve(*factors[name], bm), kernel=SOLVE_KERNEL))
            r[f"solve_m{m}_warm_us"].append(
                warm_us(lambda: v.solve(*factors[name], bm), SOLVE_KERNEL))

    names = list(versions)
    for name in names + names[::-1]:
        time_one(name)
    itemsize = torch.finfo(dtype).bits // 8
    for kind, m in (("factor", 1), ("solve", 1), ("solve", 3)):
        nbytes, _ = cs.banded_cost(n, B, m, 1, 1, itemsize)[kind]
        row[f"{kind}_m{m}_bound_us"] = 1e6 * nbytes / HBM_BYTES_PER_S
    for name, v in clocks.items():
        f, fn = v.factor(M), v.factor(Mn)
        b1 = b[:1].contiguous()
        tiles = -(-B // 32)
        r = row["versions"].setdefault(name, {})
        r["phase_cycles"] = {
            **_phase_cycles(v._lib, lambda: v.factor(M)),
            **_phase_cycles(v._lib, lambda: v.solve(*f, b1)),
        }
        r["block_spans"] = {"factor": _block_spans(v._lib, lambda: v.factor(M), tiles),
                            "solve": _block_spans(v._lib, lambda: v.solve(*f, b1), tiles),
                            "factor_newton": _block_spans(v._lib, lambda: v.factor(Mn), tiles),
                            "solve_newton": _block_spans(v._lib, lambda: v.solve(*fn, b1), tiles)}
        r["warm_us"] = {"factor": warm_us(lambda: v.factor(M), FACTOR_KERNEL),
                        "solve_m1": warm_us(lambda: v.solve(*f, b1), SOLVE_KERNEL)}
    shape = f"n={n} B={B} l=u=1 {str(dtype).split('.')[1]}"
    cs.log(f"[banded-ab {shape}] bytes bound us: factor {row['factor_m1_bound_us']:.3f}, "
           f"solve m=1 {row['solve_m1_bound_us']:.3f}, m=3 {row['solve_m3_bound_us']:.3f} | {smi}")
    for name, r in row["versions"].items():
        if "checks" in r:
            times = " ".join(f"{k}={'/'.join(cs.fmt_us(t) for t in r[k])}"
                             for k in ("factor_us", *(f"solve_m{m}_us" for m in MS),
                                       "factor_warm_us", *(f"solve_m{m}_warm_us" for m in MS),
                                       "factor_newton_us",
                                       *(f"solve_m{m}_newton_us" for m in MS)))
            cs.log(f"[banded-ab {shape} | {name}] device {times} "
                   + " ".join(f"{k}={c}" for k, c in r["checks"].items()))
        if "block_spans" in r:
            cs.log(f"[banded-ab {shape} | {name}] blocks of one launch (us) "
                   + " ".join(f"{kind}: " + " ".join(f"{k}={c:.2f}" for k, c in sp.items())
                              for kind, sp in r["block_spans"].items())
                   + " warm_us " + " ".join(f"{k}={cs.fmt_us(t)}" for k, t in r["warm_us"].items()))
        if "phase_cycles" in r:
            cs.log(f"[banded-ab {shape} | {name}] mean cycles a block by phase "
                   + " ".join(f"{k}={c:.3f}" if "per_ns" in k else f"{k}={c:.0f}"
                              for k, c in r["phase_cycles"].items()))
    return row, ok


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-root", default=None)
    ap.add_argument("--phase-clocks", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--latencies", action="store_true")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from sunode_torch.ops import banded as bd

    if not torch.cuda.is_available():
        raise SystemExit("banded_ab: no CUDA device")
    _, smi = cs.check_device()
    old_root = Path(args.old_root).resolve() if args.old_root else None
    old_source = old_root / "sunode_torch/csrc/banded.cu" if old_root else None
    dtypes = (torch.float64, torch.float32)
    jobs = {}
    for dt in dtypes:
        t = str(dt).split(".")[1]
        jobs[("this", t)] = lambda dt=dt: bd.build_banded_kernels(1, 1, dt)
        if old_root is not None:
            jobs[("parent", t)] = lambda dt=dt: _Parent(old_source, dt)
        if args.phase_clocks:
            jobs[("this_clocks", t)] = lambda dt=dt: bd._BandedKernels(
                1, 1, dt, defines=("BANDED_PHASE_CLOCKS",))
            if old_root is not None:
                marked = parent_with_marks(old_source)
                jobs[("parent_clocks", t)] = lambda dt=dt, src=marked: _Parent(
                    src, dt, defines=("BANDED_PHASE_CLOCKS",))
    with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc for each build, all at once
        built = dict(zip(jobs, pool.map(lambda job: job(), jobs.values())))
    for (name, t), b in built.items():
        ptxas = [ln.strip() for ln in b.build_log.splitlines()
                 if "banded_" in ln or "registers" in ln or "spill" in ln]
        cs.log(f"[build {name} {t}] {b.build_seconds:.2f} s; ptxas: {'; '.join(ptxas)}")

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    report = {"smi": smi, "shapes": []}
    if args.sass:
        report["sass_instructions"] = dump_sass(
            {f"{name}_{t}": b for (name, t), b in built.items()}, out / "banded_sass")
        for name, per in report["sass_instructions"].items():
            cs.log(f"[banded-ab sass {name}] " + " ".join(f"{k}={v}" for k, v in per.items()))
    if args.latencies:
        report["latency_cycles"] = {}
        for dt in dtypes:
            t = str(dt).split(".")[1]
            lat = report["latency_cycles"][t] = latencies(dt)
            cs.log(f"[banded-ab latencies {t}] cycles a dependent operation: "
                   + " ".join(f"{k}={c:.1f}" for k, c in lat.items()) + f" | {smi}")
    ok = True
    for dt in dtypes:
        t = str(dt).split(".")[1]
        versions = {name: built[(name, t)] for name in ("this", "parent") if (name, t) in built}
        clocks = {name: built[(name, t)] for name in ("this_clocks", "parent_clocks")
                  if (name, t) in built}
        for n in NS:
            row, ok_row = compare_shape(cs, bd, dt, n, versions, clocks, smi)
            report["shapes"].append(row)
            ok &= ok_row
    (out / "banded_ab.json").write_text(json.dumps(report, indent=1))
    if not ok:
        raise SystemExit("banded_ab: a kernel disagrees with its plain version")
    cs.log("[banded-ab] every version bit for bit the plain versions")


if __name__ == "__main__":
    main()
