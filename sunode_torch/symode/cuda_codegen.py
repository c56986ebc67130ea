"""sympy -> CUDA ``__device__`` functions for the PECE kernel.

Port of ``sunode_tpu/native/codegen.py::_emit_c_function``: the same CSE'd
expressions are printed as C, here as ``__device__ __forceinline__``
functions that ``csrc/pece_step.cu`` includes, so the problem's right-hand
side is compiled into the kernel and evaluated in registers, one thread per
lane.

Two systems are emitted from a :class:`~sunode_torch.symode.SympyProblem`:

  * :func:`forward_system` -- ``out = f(t, y, p)`` (n inputs, n outputs);
  * :func:`transition_system` -- the transition-adjoint backward system in
    tau = -t over ``z = [y | vec M]`` with the ``vec W`` quadrature rows:
    ``dy = -f``, ``dM = J^T M``, ``dW = M^T df/dp`` (n + n^2 inputs,
    n + n^2 + n * n_deriv outputs), the symbolic form of
    ``sunode_tpu/adjoint.py:434-450``.

A function the printer cannot emit raises ``ValueError`` here, at codegen
time; there is no fallback to the plain path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import sympy as sy
from sympy.printing.c import C99CodePrinter
from sympy.printing.codeprinter import PrintMethodNotImplementedError

__all__ = [
    "DeviceSystem",
    "emit_device_function",
    "forward_system",
    "transition_system",
]

# helpers for the custom sympy functions of symode.lambdify
_PROLOGUE = r"""#include <math.h>
static __device__ __forceinline__ double sunode_expit(double x) {
  return 1.0 / (1.0 + exp(-x));
}
static __device__ __forceinline__ double sunode_dexpit(double x) {
  const double s = sunode_expit(x);
  return s * (1.0 - s);
}
static __device__ __forceinline__ double sunode_logaddexp(double a, double b) {
  const double m = fmax(a, b);
  if (isinf(m)) return m;
  return m + log1p(exp(-fabs(a - b)));
}
"""

_USER_FUNCTIONS = {
    "expit": "sunode_expit",
    "dexpit": "sunode_dexpit",
    "logaddexp": "sunode_logaddexp",
}


class _CudaPrinter(C99CodePrinter):
    """C99 printer that spells small integer powers as products, the way the
    torch and XLA paths evaluate them, instead of calling ``pow``."""

    def __init__(self):
        super().__init__({"user_functions": dict(_USER_FUNCTIONS), "strict": True})

    def _print_Pow(self, expr):
        b, e = expr.args
        if e.is_Integer and 2 <= abs(int(e)) <= 8:
            base = self.parenthesize(b, 1000)
            prod = "(" + "*".join([base] * abs(int(e))) + ")"
            return prod if e > 0 else f"(1.0/{prod})"
        return super()._print_Pow(expr)


def _expand_for_c(e):
    e = sy.sympify(e)
    return e.doit() if e.has(sy.Derivative) else e


def emit_device_function(name: str, exprs, varmap: dict, args_sig: str) -> str:
    """One ``__device__`` function assigning CSE'd expressions into out[].

    ``varmap`` maps sympy symbol names to C access expressions (``y[0]``).
    Structural zeros are written as explicit zeros so ``out`` can stay in
    registers."""
    exprs = np.asarray(exprs, dtype=object).reshape(-1)
    sympified = [_expand_for_c(e) for e in exprs]
    nz = [(i, e) for i, e in enumerate(sympified) if e != 0]
    lines = [f"__device__ __forceinline__ void {name}({args_sig}) {{"]
    for i, e in enumerate(sympified):
        if e == 0:
            lines.append(f"  out[{i}] = 0.0;")
    if nz:
        repl, reduced = sy.cse([e for _, e in nz], sy.numbered_symbols("x_"))
        subs = {}
        for expr in [e for _, e in nz]:
            for s in expr.free_symbols:
                if s.name in varmap:
                    subs[s] = sy.Symbol(varmap[s.name], real=True)
        printer = _CudaPrinter()

        def pr(e):
            try:
                return printer.doprint(e.xreplace(subs))
            except PrintMethodNotImplementedError as err:
                raise ValueError(
                    f"{name}: no CUDA spelling for {e}: {err}"
                ) from None

        for sym, sub in repl:
            lines.append(f"  const double {sym.name} = {pr(sub)};")
        for (i, _), e in zip(nz, reduced):
            lines.append(f"  out[{i}] = {pr(e)};")
    lines.append("}")
    return "\n".join(lines)


@dataclass(frozen=True)
class DeviceSystem:
    """A right-hand side emitted for the PECE kernel.

    ``source`` is a header defining ``PECE_N`` (state rows the function
    reads), ``PECE_NZ`` (rows it writes), ``PECE_NP`` (params per lane) and
    ``pece_fz(double t, const double* y, const double* p, double* out)``."""

    name: str
    n: int
    nz: int
    n_p: int
    source: str


_SIG = "double t, const double* y, const double* p, double* out"


def _header(name: str, n: int, nz: int, n_p: int, body: str) -> str:
    return "\n".join(
        [
            f"// generated by sunode_torch.symode.cuda_codegen: {name}",
            "#pragma once",
            f"#define PECE_N {n}",
            f"#define PECE_NZ {nz}",
            f"#define PECE_NP {n_p}",
            _PROLOGUE,
            body,
            "",
        ]
    )


def _base_varmap(problem) -> dict:
    varmap = {f"__y_{i}": f"y[{i}]" for i in range(problem.n_states)}
    varmap.update({f"__p_{j}": f"p[{j}]" for j in range(problem.n_all_params)})
    return varmap


def forward_system(problem) -> DeviceSystem:
    """``out = f(t, y, p)`` for the forward solve."""
    n = problem.n_states
    varmap = _base_varmap(problem)
    varmap[problem.sym_time.name] = "t"
    body = emit_device_function("pece_fz", problem.sym_rhs, varmap, _SIG)
    return DeviceSystem(
        "forward", n, n, problem.n_all_params,
        _header("forward", n, n, problem.n_all_params, body),
    )


def transition_system(problem) -> DeviceSystem:
    """The transition-adjoint backward system, in tau = -t.

    State ``z = [y | vec M]`` (row-major ``M[i, j] = z[n + i*n + j]``);
    outputs ``[-f | vec(J^T M) | vec(M^T df/dp)]``."""
    n = problem.n_states
    nd = problem.n_params
    tau = sy.Symbol("__tau", real=True)
    to_t = {problem.sym_time: -tau}
    f = [sy.sympify(e).xreplace(to_t) for e in problem.sym_rhs]
    J = np.asarray(problem.sym_jac, dtype=object).reshape(n, n)
    Bm = np.asarray(problem.sym_dfdp, dtype=object).reshape(n, nd)
    J = np.vectorize(lambda e: sy.sympify(e).xreplace(to_t), otypes=[object])(J)
    Bm = (
        np.vectorize(lambda e: sy.sympify(e).xreplace(to_t), otypes=[object])(Bm)
        if nd
        else Bm
    )
    M = [[sy.Symbol(f"__m_{i}_{j}", real=True) for j in range(n)] for i in range(n)]
    dy = [-e for e in f]
    dM = [sum(J[k, i] * M[k][j] for k in range(n)) for i in range(n) for j in range(n)]
    dW = [sum(M[k][i] * Bm[k, j] for k in range(n)) for i in range(n) for j in range(nd)]
    varmap = _base_varmap(problem)
    varmap.update(
        {f"__m_{i}_{j}": f"y[{n + i * n + j}]" for i in range(n) for j in range(n)}
    )
    varmap["__tau"] = "t"
    n_state = n + n * n
    nz = n_state + n * nd
    body = emit_device_function(
        "pece_fz", np.array(dy + dM + dW, dtype=object), varmap, _SIG
    )
    return DeviceSystem(
        "transition", n_state, nz, problem.n_all_params,
        _header("transition", n_state, nz, problem.n_all_params, body),
    )
