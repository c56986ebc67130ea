"""sympy -> C code generation and runtime compilation for the native solver.

The numba-@cfunc analog of the reference (sunode compiles sympy-generated
right-hand sides and Jacobians with numba into C-callable pointers): here the
same CSE'd expressions are printed as C (``sympy.ccode``), compiled with the
system g++ into a shared library and loaded with ctypes, so no Python runs in
the native solver's loop.

Builds go into ``build/sunode_torch_native/`` beside the package, named by a
hash of the source, the compiler and its flags: the core library
``native/cvbdf.cpp`` once, and one library a problem.  Each build compiles to
a name unique to its process and is renamed into place, under a lock file,
so processes that build the same library at once never load a half-written
file.  A failed compile raises with the compiler's output; there is no
fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import sympy as sy

__all__ = ["compile_problem_c", "native_lib_path", "build_native_lib", "BUILD_ROOT"]

BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "sunode_torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

def _cc() -> str:
    return os.environ.get("CXX", "g++")


def _build_cached(stem: str, text: str, rebuild: bool = False) -> Path:
    """The library of C++ source ``text``, built once under
    ``BUILD_ROOT/<stem>_<hash>.so`` (again with ``rebuild``)."""
    key = hashlib.sha256("\0".join([text, _cc(), *CXX_FLAGS]).encode()).hexdigest()[:16]
    out = BUILD_ROOT / f"{stem}_{key}.so"
    if rebuild or not out.exists():
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        with open(BUILD_ROOT / f".{stem}_{key}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if rebuild or not out.exists():
                tag = f"{os.getpid()}_{time.monotonic_ns()}"
                src = BUILD_ROOT / f"{stem}_{key}.{tag}.cpp"
                tmp = BUILD_ROOT / f"{stem}_{key}.{tag}.so"
                src.write_text(text)
                try:
                    build_native_lib(src, tmp)
                    os.replace(tmp, out)
                finally:
                    src.unlink(missing_ok=True)
                    tmp.unlink(missing_ok=True)
    return out


def native_lib_path() -> Path:
    """Build (once) and return the path of the core libcvbdf shared library."""
    return _build_cached("libcvbdf", (Path(__file__).parent / "cvbdf.cpp").read_text())


def build_native_lib(src: Path, out: Path, extra: list[str] | None = None) -> None:
    """``g++ -O3`` of ``src`` into the shared library ``out``; raises
    ``RuntimeError`` with the compiler's output when it fails."""
    cmd = [_cc(), *CXX_FLAGS, "-o", str(out), str(src), "-lpthread"] + (extra or [])
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"native build failed: {' '.join(cmd)}: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(
            f"native build failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )


def _emit_c_function(name: str, exprs, varmap: dict, args_sig: str) -> str:
    """One C function assigning CSE'd expressions into out[].

    Structural zeros are handled with one ``memset`` followed by only the
    nonzero assignments — Jacobians are mostly zeros, so this keeps both
    the generated source and the CSE pass proportional to nnz rather than
    to the full buffer size.
    """
    exprs = np.asarray(exprs, dtype=object).reshape(-1)
    if exprs.size == 0:
        return f"void {name}({args_sig}) {{ (void)out; }}"
    sympified = [sy.sympify(e) for e in exprs]
    nz = [(i, e) for i, e in enumerate(sympified) if e != 0]
    lines = [
        f"void {name}({args_sig}) {{",
        f"  memset(out, 0, {exprs.size} * sizeof(double));",
    ]
    if nz:
        repl, reduced = sy.cse([e for _, e in nz], sy.numbered_symbols("x_"))
        subs = {
            sy.Symbol(k, real=True): sy.Symbol(v, real=True)
            for k, v in varmap.items()
        }

        def pr(e):
            return sy.ccode(e.xreplace(subs))

        for sym, sub in repl:
            lines.append(f"  const double {sym.name} = {pr(sub)};")
        for (i, _), e in zip(nz, reduced):
            lines.append(f"  out[{i}] = {pr(e)};")
    lines.append("}")
    return "\n".join(lines)


def compile_problem_c(
    problem, *, cache: bool = True, band=None, band_perm=None, sparse=None,
    roots=None
):
    """Generate + compile C functions for a SympyProblem; return a ctypes lib
    exposing (all row-major):

    - ``sunode_rhs(t, y, p, out)``      — dydt
    - ``sunode_jac(t, y, p, out)``      — dense Jacobian
    - ``sunode_adj_rhs(t, y, lam, p, out)``  — dlambda/dt = -J^T lambda
    - ``sunode_quad_rhs(t, y, lam, p, out)`` — lambda^T df/dp (derivative
      params subset, reference CVQuadRhsFnB analog)

    With ``band=(lower, upper)`` additionally emits
    ``sunode_jac_banded(t, y, p, out)`` filling scipy-style banded storage
    ``out[(u+i-j)*n + j] = J(i, j)`` of shape (l+u+1, n) — consumed by the
    native banded-Newton path (``cvbdf_solve_banded``); raises ``ValueError``
    if the symbolic Jacobian has a structurally nonzero entry outside the
    declared band (the reference's sunmatrix_band would silently drop it).

    ``band_perm`` (with ``band``): a permutation array (permuted index ->
    original index, e.g. an RCM ordering from ``ops/sparsity.py``); the
    banded storage then holds the PERMUTED matrix J_p = P J P^T with
    ``out[(u + ip - jp)*n + jp] = J(perm[ip], perm[jp])`` — the native
    sparse-direct analog (the reference's KLU role): the exact symbolic
    pattern is concentrated into a band and factored at the permuted
    bandwidth.

    ``sparse``: a CSC ``(indptr, indices)`` pattern (diagonal included,
    ``ops/sparsity.csc_pattern``); emits ``sunode_jac_sparse(t, y, p, out)``
    filling the nnz Jacobian VALUES in pattern order — consumed by the
    native sparse-direct (Gilbert-Peierls, KLU-analog) entries
    (``cvbdf_solve_sparse`` family); raises ``ValueError`` if the symbolic
    Jacobian has a structurally nonzero entry outside the pattern.

    ``roots``: an object array of symbolic event functions
    (``SympyProblem.symbolic_roots``); emits ``sunode_roots(t, y, p, out)``
    filling ``out[nrt]`` — consumed by the native rootfinding entries
    (``cvbdf_solve_roots`` / ``cvadams_solve_roots``, the CVodeRootInit
    analog).
    """
    n = problem.n_states
    # C-identifier varmap: __y_0 -> y[0] etc.  ccode can't print indexing via
    # Symbol, so use IndexedBase-free trick: print to placeholder identifiers
    # then textual replace (identifiers are unambiguous: __y_3 etc.)
    varmap = {}
    for i in range(n):
        varmap[f"__y_{i}"] = f"Y_{i}"
        varmap[f"__lam_{i}"] = f"L_{i}"
    for j in range(problem.n_all_params):
        varmap[f"__p_{j}"] = f"P_{j}"
    varmap["__t"] = "t"

    header = [
        "#include <math.h>\n#include <string.h>",
        'extern "C" {',
    ]
    rhs_src = _emit_c_function(
        "sunode_rhs",
        problem._sym_dydt,
        varmap,
        "double t, const double* y, const double* p, double* out",
    )
    jac_src = _emit_c_function(
        "sunode_jac",
        problem._sym_dydt_jac,
        varmap,
        "double t, const double* y, const double* p, double* out",
    )
    adj_sig = "double t, const double* y, const double* lam, const double* p, double* out"
    adj_src = _emit_c_function(
        "sunode_adj_rhs", problem._sym_dlamdadt, varmap, adj_sig
    )
    quad_src = _emit_c_function(
        "sunode_quad_rhs", problem._sym_quad_rhs, varmap, adj_sig
    )
    # df/dp over the derivative-params subset, (n, n_params) row-major
    dfdp_src = _emit_c_function(
        "sunode_dfdp",
        problem._sym_dydp,
        varmap,
        "double t, const double* y, const double* p, double* out",
    )
    # explicit time derivative df/dt (zero for autonomous systems) — the
    # quintic-Hermite recording needs fdot = J f + df/dt
    dfdt = np.array(
        [sy.diff(sy.sympify(e), sy.Symbol("__t", real=True)) for e in
         np.asarray(problem._sym_dydt, dtype=object).reshape(-1)],
        dtype=object,
    )
    dfdt_src = _emit_c_function(
        "sunode_dfdt",
        dfdt,
        varmap,
        "double t, const double* y, const double* p, double* out",
    )
    band_src = []
    if band is not None:
        lo, up = int(band[0]), int(band[1])
        if band_perm is not None:
            inv = np.argsort(np.asarray(band_perm, np.int64))
        jac = np.asarray(problem._sym_dydt_jac, dtype=object).reshape(n, n)
        ab = np.full((lo + up + 1, n), sy.Integer(0), dtype=object)
        for i in range(n):
            for j in range(n):
                e = sy.sympify(jac[i, j])
                if e == 0:
                    continue
                ip, jp = (
                    (int(inv[i]), int(inv[j])) if band_perm is not None else (i, j)
                )
                if jp - ip > up or ip - jp > lo:
                    raise ValueError(
                        f"Jacobian entry ({i},{j}) is structurally nonzero "
                        f"outside the declared band (lower={lo}, upper={up})"
                    )
                ab[up + ip - jp, jp] = e
        band_src = [
            _emit_c_function(
                "sunode_jac_banded",
                ab,
                varmap,
                "double t, const double* y, const double* p, double* out",
            )
        ]
    sparse_src = []
    if sparse is not None:
        indptr, indices = (np.asarray(a, np.int64) for a in sparse)
        jac = np.asarray(problem._sym_dydt_jac, dtype=object).reshape(n, n)
        in_pattern = set()
        vals = np.full(int(indptr[-1]), sy.Integer(0), dtype=object)
        for j in range(n):
            for k in range(int(indptr[j]), int(indptr[j + 1])):
                i = int(indices[k])
                in_pattern.add((i, j))
                vals[k] = sy.sympify(jac[i, j])
        for i in range(n):
            for j in range(n):
                if sy.sympify(jac[i, j]) != 0 and (i, j) not in in_pattern:
                    raise ValueError(
                        f"Jacobian entry ({i},{j}) is structurally nonzero "
                        "outside the declared sparse pattern"
                    )
        sparse_src = [
            _emit_c_function(
                "sunode_jac_sparse",
                vals,
                varmap,
                "double t, const double* y, const double* p, double* out",
            )
        ]
    roots_src = []
    if roots is not None:
        roots_src = [
            _emit_c_function(
                "sunode_roots",
                np.asarray(roots, dtype=object).reshape(-1),
                varmap,
                "double t, const double* y, const double* p, double* out",
            )
        ]
    # prologue mapping placeholders to array loads
    defines = []
    for i in range(n):
        defines.append(f"#define Y_{i} (y[{i}])")
        defines.append(f"#define L_{i} (lam[{i}])")
    for j in range(problem.n_all_params):
        defines.append(f"#define P_{j} (p[{j}])")
    src = (
        "\n".join(
            header[:1]
            + defines
            + header[1:]
            + [rhs_src, jac_src, adj_src, quad_src, dfdp_src, dfdt_src]
            + band_src
            + sparse_src
            + roots_src
            + ["}"]
        )
        + "\n"
    )

    lib = ctypes.CDLL(str(_build_cached("problem", src, rebuild=not cache)))
    lib._generated_source = src  # type: ignore[attr-defined]
    return lib
