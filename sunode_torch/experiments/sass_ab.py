"""The float64 kernel builds of this tree against another checkout's, as machine code.

    python -m sunode_torch.experiments.sass_ab --old-root DIR

Run from the repository root on a machine with the CUDA toolkit (``nvcc``
and ``cuobjdump``; no card is needed).  Builds each float64 kernel source of
both trees with the same generated headers, defines and flags as its
wrapper builds it: ``csrc/adams_attempt.cu`` for the six Lotka-Volterra
systems at history depths 9 and 11 (``-fmad=false``), ``csrc/pece_step.cu``
for the forward and transition systems, and ``csrc/adams_split.cu`` at
depths 9 and 11.  Then compares ``cuobjdump -sass``'s instructions, with
their addresses and encodings dropped, one by one, kernel by kernel: each of
the other tree's kernels against this tree's of the same name, or, where its
name changed with a template's parameters (``csrc/adams_split.cu``'s sweep
and finish), against this tree's instantiation of it (:data:`RENAMED`).
The other tree's state-split kernels that this tree redesigned or folded
into another (:data:`REDESIGNED`) are listed, not compared; kernels only
this tree has are listed as new.  Identical machine code means the float64
builds compute and take the same as the other tree's, whatever a timing's
noise says.  Prints one line per build and exits non-zero if any of the
other tree's kernels differs, or if the toolkit is missing.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
KINDS = ("forward", "transition", "resolve", "staged_adjoint", "sensitivity",
         "staged_sensitivity")


def _jobs():
    """(label, source file name, generated headers, defines, flags) of every
    float64 build compared."""
    from sunode_torch.entry import lv_problem
    from sunode_torch.ops.adams_attempt import FMAD_FLAGS
    from sunode_torch.ops.pece_step import _tables_header
    from sunode_torch.symode import cuda_codegen

    problem, tables = lv_problem(), _tables_header()
    jobs = []
    for kind in KINDS:
        ds = getattr(cuda_codegen, f"{kind}_system")(problem)
        headers = {"pece_rhs.h": ds.source, "pece_tables.h": tables}
        jobs += [(f"adams_attempt {kind} KAB={kab}", "adams_attempt.cu", headers,
                  (f"ADAMS_KAB={kab}",), FMAD_FLAGS) for kab in (9, 11)]
        if kind in ("forward", "transition"):
            jobs.append((f"pece_step {kind}", "pece_step.cu", headers, (), ()))
    jobs += [(f"adams_split KAB={kab}", "adams_split.cu", {"pece_tables.h": tables},
              (f"ADAMS_KAB={kab}",), ()) for kab in (9, 11)]
    return jobs


# mangled-name prefixes of the other tree's kernels and of this tree's
# instantiation of each: the unsplit sweep took a second template argument
# (the state split's PARTIAL, false for it) for one tree and dropped it
# again; the finish took ROWS (false for the unsplit finish), then ONE_CHUNK
# (false for the multi-chunk form, which older trees' finish is)
RENAMED = {
    "_Z18split_sweep_kernelILb0ELb0EE": "_Z18split_sweep_kernelILb0EE",
    "_Z18split_sweep_kernelILb1ELb0EE": "_Z18split_sweep_kernelILb1EE",
    "_Z19split_finish_kernelPK": "_Z19split_finish_kernelILb0ELb0EE",
    "_Z19split_finish_kernelILb0EE": "_Z19split_finish_kernelILb0ELb0EE",
    "_Z19split_finish_kernelILb1EE": "_Z19split_finish_kernelILb1ELb0EE",
}
# the other tree's state-split kernels this tree replaced: the rows' sweep
# (the sweep template's PARTIAL instantiation, now split_sweep_rows_kernel),
# the decision (folded into it and into the lanes' finish) and the lanes'
# finish (which decides the last sweep first, a warp a lane)
REDESIGNED = ("_Z18split_sweep_kernelILb0ELb1EE", "_Z25split_sweep_decide_kernel",
              "_Z25split_finish_lanes_kernel")


def _sass(tool: str, lib: Path) -> dict[str, list[str]]:
    """{kernel's mangled name: its instructions} of a built library, without
    addresses or encodings."""
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    kernels: dict[str, list[str]] = {}
    current: list[str] = []
    for line in out.splitlines():
        if m := re.match(r"\s*Function : (\S+)", line):
            current = kernels.setdefault(m.group(1), [])
        elif m := re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line):
            current.append(m.group(1))
    return kernels


def _counterpart(name: str, ours: dict) -> str | None:
    """This tree's kernel for the other tree's ``name``."""
    if name in ours:
        return name
    for old, new in RENAMED.items():
        if name.startswith(old):
            return next((k for k in ours if k.startswith(new)), None)
    return None


def _first_difference(old: list, ours) -> str:
    """Where a kernel's instructions first differ from the other tree's."""
    if ours is None:
        return "no counterpart in this tree"
    i = next((i for i, (a, b) in enumerate(zip(old, ours)) if a != b), min(len(old), len(ours)))
    return (f"{len(old)} / {len(ours)} instructions, first at {i}: "
            f"{old[i] if i < len(old) else '-'} / {ours[i] if i < len(ours) else '-'}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-root", required=True)
    args = ap.parse_args(argv)

    from sunode_torch.ops._nvcc_build import _nvcc, build_library

    try:
        tool = shutil.which("cuobjdump") or str(Path(_nvcc()).parent / "cuobjdump")
    except RuntimeError as err:  # no toolkit on this machine
        raise SystemExit(f"sass_ab: no CUDA toolkit ({err})") from None
    if not Path(tool).exists():
        raise SystemExit("sass_ab: no cuobjdump (the CUDA toolkit is needed)")
    old = Path(args.old_root).resolve() / "sunode_torch" / "csrc"
    jobs = _jobs()

    def build(job, root, tag):
        label, source, headers, defines, flags = job
        name = re.sub(r"\W+", "_", label) + "_" + tag
        return build_library(name, root / source, headers=headers, defines=defines,
                             extra_flags=flags).path

    with ThreadPoolExecutor(16) as pool:  # one nvcc for each build, all at once
        new_libs = list(pool.map(lambda j: build(j, CSRC, "this"), jobs))
        old_libs = list(pool.map(lambda j: build(j, old, "old"), jobs))
    same_all = True
    for job, a, b in zip(jobs, new_libs, old_libs):
        ours, theirs = _sass(tool, a), _sass(tool, b)
        gone = sorted(name for name in theirs if name.startswith(REDESIGNED))
        matched = {name: _counterpart(name, ours) for name in theirs if name not in gone}
        differ = {name: _first_difference(theirs[name], ours.get(k))
                  for name, k in matched.items() if k is None or ours[k] != theirs[name]}
        new = sorted(set(ours) - set(matched.values()))
        same_all &= not differ
        print(f"[sass-ab {job[0]}] instructions this tree / old "
              f"{sum(map(len, ours.values()))} / {sum(map(len, theirs.values()))}, the old "
              f"kernels' identical={not differ}" + (f"; differing {differ}" if differ else "")
              + (f"; redesigned {gone}" if gone else "")
              + (f"; new kernels {new}" if new else ""), flush=True)
    if not same_all:
        raise SystemExit("sass_ab: a float64 build's machine code differs from the old tree's")
    print("[sass-ab] every float64 build's machine code is the old tree's")


if __name__ == "__main__":
    main()
