"""The float64 kernel builds of this tree against another checkout's, as machine code.

    python -m sunode_torch.experiments.sass_ab --old-root DIR

Run from the repository root on a machine with the CUDA toolkit (``nvcc``
and ``cuobjdump``; no card is needed).  Builds each float64 kernel source of
both trees with the same generated headers, defines and flags as its
wrapper builds it: ``csrc/adams_attempt.cu`` for the six Lotka-Volterra
systems at history depths 9 and 11 (``-fmad=false``), ``csrc/pece_step.cu``
for the forward and transition systems, and ``csrc/adams_split.cu`` at
depths 9 and 11.  Then compares ``cuobjdump -sass``'s instructions, with
their addresses and encodings dropped, one by one.  Identical machine code
means the float64 builds compute and take the same as the other tree's,
whatever a timing's noise says.  Prints one line per build and exits
non-zero if any differs, or if the toolkit is missing.
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


def _sass(tool: str, lib: Path) -> list[str]:
    """The instructions of a built library, without addresses or encodings."""
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    return [m.group(1) for line in out.splitlines()
            if (m := re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line))]


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
        same_all &= ours == theirs
        print(f"[sass-ab {job[0]}] instructions this tree / old {len(ours)} / {len(theirs)} "
              f"identical={ours == theirs}", flush=True)
    if not same_all:
        raise SystemExit("sass_ab: a float64 build's machine code differs from the old tree's")
    print("[sass-ab] every float64 build's machine code is the old tree's")


if __name__ == "__main__":
    main()
