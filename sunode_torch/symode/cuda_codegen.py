"""sympy -> CUDA ``__device__`` functions for the PECE kernel.

Port of ``sunode_tpu/native/codegen.py::_emit_c_function``: the same CSE'd
expressions are printed as C, here as ``__device__ __forceinline__``
functions that ``csrc/pece_step.cu`` includes, so the problem's right-hand
side is compiled into the kernel and evaluated in registers, one thread per
lane.

Six systems are emitted from a :class:`~sunode_torch.symode.SympyProblem`:

  * :func:`forward_system` -- ``out = f(t, y, p)`` (n inputs, n outputs);
  * :func:`transition_system` -- the transition-adjoint backward system in
    tau = -t over ``z = [y | vec M]`` with the ``vec W`` quadrature rows:
    ``dy = -f``, ``dM = J^T M``, ``dW = M^T df/dp`` (n + n^2 inputs,
    n + n^2 + n * n_deriv outputs), the symbolic form of
    ``sunode_tpu/adjoint.py:434-450``;
  * :func:`resolve_system` -- the backsolve adjoint in tau = -t over
    ``z = [y | lam]``: ``dy = -f``, ``dlam = J^T lam`` and the quadrature
    ``lam^T df/dp`` (2n inputs, 2n + n_deriv outputs), the symbolic form of
    ``sunode_tpu/adjoint.py:756-764``;
  * :func:`staged_adjoint_system` -- the checkpointed adjoint in tau = -t
    over ``lam``, with y(t) staged once per attempt in the parameter rows
    after the problem's (``p[n_p + i]``): ``dlam = J^T lam`` and ``lam^T
    df/dp`` (n inputs, n + n_deriv outputs, n_p + n parameters), the form of
    ``sunode_tpu/adjoint.py:861-865``;
  * :func:`sensitivity_system` -- simultaneous forward sensitivities, the
    augmented state ``z = [y | vec S]``: ``[f | vec(J S + df/dp)]``
    (n + k n inputs and outputs, k = n_deriv), the row layout of
    ``bench.py``'s ``rhs_aug`` and ``Solver._adams_sens_setup``;
  * :func:`staged_sensitivity_system` -- the sensitivity block of a
    staggered attempt: state ``vec S``, y read from the parameter rows after
    the problem's, ``vec(J S + df/dp)`` (k n inputs and outputs, n_p + n
    parameters).

Each system is emitted at a C type, ``real='double'`` (the default) or
``'float'``: at float every literal carries an ``F`` suffix and every
function is its ``float`` form (``expf``, ``fmaxf``; sympy's C printer with
``type_aliases={real: float32}``), so that nothing in the emitted code
promotes an expression to double and the kernel's f rounds as the plain
float32 version's.

A :class:`~sunode_torch.symode.lambdify.CardinalBSpline` (an
``interpolate_spline`` term) is emitted as its horner-form Piecewise, C
ternaries at either type, as the plain path prints it as ``torch.where``
chains.  A function the printer cannot emit raises ``ValueError`` here, at
codegen time; there is no fallback to the plain path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import sympy as sy
from sympy.codegen.ast import float32
from sympy.codegen.ast import real as real_type
from sympy.printing.c import C99CodePrinter
from sympy.printing.codeprinter import PrintMethodNotImplementedError
from sympy.printing.numpy import NumPyPrinter

__all__ = [
    "DeviceSystem",
    "emit_device_function",
    "forward_system",
    "transition_system",
    "resolve_system",
    "staged_adjoint_system",
    "sensitivity_system",
    "staged_sensitivity_system",
]

# helpers for the custom sympy functions of symode.lambdify, by C type
_PROLOGUE = {
    "double": r"""#include <math.h>
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
""",
    "float": r"""#include <math.h>
static __device__ __forceinline__ float sunode_expit(float x) {
  return 1.0F / (1.0F + expf(-x));
}
static __device__ __forceinline__ float sunode_dexpit(float x) {
  const float s = sunode_expit(x);
  return s * (1.0F - s);
}
static __device__ __forceinline__ float sunode_logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  if (isinf(m)) return m;
  return m + log1pf(expf(-fabsf(a - b)));
}
""",
}
REALS = tuple(_PROLOGUE)  # the C types a system is emitted at

_USER_FUNCTIONS = {
    "expit": "sunode_expit",
    "dexpit": "sunode_dexpit",
    "logaddexp": "sunode_logaddexp",
}


class _CudaPrinter(C99CodePrinter):
    """C99 printer that spells small integer powers as products, the way the
    torch and XLA paths evaluate them, instead of calling ``pow``; at
    ``real='float'`` with float literals and functions."""

    def __init__(self, real: str = "double"):
        settings = {"user_functions": dict(_USER_FUNCTIONS), "strict": True}
        if real == "float":
            settings["type_aliases"] = {real_type: float32}
        super().__init__(settings)
        self._real = real
        self._one = "1.0F" if real == "float" else "1.0"
        self._python = NumPyPrinter()

    def _print_Float(self, expr):
        # at double, the decimal digits the plain path's printer writes
        # (``symode/lambdify.py``: 15 significant digits), so the emitted
        # constant is the double the plain f multiplies by; C's own 17-digit
        # spelling of a sum of Floats (the spline's 0.1 * 3) is another double
        if self._real == "double":
            return self._python._print_Float(expr)
        return super()._print_Float(expr)

    def _print_CardinalBSpline(self, expr):
        return self._print(expr.as_piecewise())

    def _print_Pow(self, expr):
        b, e = expr.args
        if e.is_Integer and 2 <= abs(int(e)) <= 8:
            base = self.parenthesize(b, 1000)
            prod = "(" + "*".join([base] * abs(int(e))) + ")"
            return prod if e > 0 else f"({self._one}/{prod})"
        return super()._print_Pow(expr)


def _expand_for_c(e):
    e = sy.sympify(e)
    return e.doit() if e.has(sy.Derivative) else e


def emit_device_function(name: str, exprs, varmap: dict, args_sig: str,
                         real: str = "double") -> str:
    """One ``__device__`` function assigning CSE'd expressions into out[],
    computed at the C type ``real`` ('double' or 'float').

    ``varmap`` maps sympy symbol names to C access expressions (``y[0]``).
    Structural zeros are written as explicit zeros so ``out`` can stay in
    registers.  At 'float' the number symbols (pi, E) become float
    literals, where C's macros would be double."""
    if real not in REALS:
        raise ValueError(f"{name}: real must be one of {REALS}, got {real!r}")
    exprs = np.asarray(exprs, dtype=object).reshape(-1)
    sympified = [_expand_for_c(e) for e in exprs]
    if real == "float":
        sympified = [e.xreplace({c: sy.Float(float(c), 17) for c in e.atoms(sy.NumberSymbol)})
                     for e in sympified]
    nz = [(i, e) for i, e in enumerate(sympified) if e != 0]
    zero = "0.0F" if real == "float" else "0.0"
    lines = [f"__device__ __forceinline__ void {name}({args_sig}) {{"]
    for i, e in enumerate(sympified):
        if e == 0:
            lines.append(f"  out[{i}] = {zero};")
    if nz:
        repl, reduced = sy.cse([e for _, e in nz], sy.numbered_symbols("x_"))
        subs = {}
        for expr in [e for _, e in nz]:
            for s in expr.free_symbols:
                if s.name in varmap:
                    subs[s] = sy.Symbol(varmap[s.name], real=True)
        printer = _CudaPrinter(real)

        def pr(e):
            try:
                return printer.doprint(e.xreplace(subs))
            except PrintMethodNotImplementedError as err:
                raise ValueError(
                    f"{name}: no CUDA spelling for {e}: {err}"
                ) from None

        for sym, sub in repl:
            lines.append(f"  const {real} {sym.name} = {pr(sub)};")
        for (i, _), e in zip(nz, reduced):
            lines.append(f"  out[{i}] = {pr(e)};")
    lines.append("}")
    return "\n".join(lines)


@dataclass(frozen=True)
class DeviceSystem:
    """A right-hand side emitted for the PECE kernel.

    ``source`` is a header defining ``PECE_N`` (state rows the function
    reads), ``PECE_NZ`` (rows it writes), ``PECE_NP`` (params per lane) and
    ``pece_fz(real t, const real* y, const real* p, real* out)`` with
    ``real`` the C type ``real`` ('double' or 'float') it was emitted at,
    the type of the kernel build that includes it."""

    name: str
    n: int
    nz: int
    n_p: int
    source: str
    real: str = "double"


def _sig(real: str) -> str:
    return f"{real} t, const {real}* y, const {real}* p, {real}* out"


def _header(name: str, n: int, nz: int, n_p: int, body: str, real: str) -> str:
    return "\n".join(
        [
            f"// generated by sunode_torch.symode.cuda_codegen: {name}"
            + ("" if real == "double" else f" at {real}"),
            "#pragma once",
            f"#define PECE_N {n}",
            f"#define PECE_NZ {nz}",
            f"#define PECE_NP {n_p}",
            _PROLOGUE[real],
            body,
            "",
        ]
    )


def _system(name: str, n: int, nz: int, n_p: int, exprs, varmap: dict,
            real: str) -> DeviceSystem:
    body = emit_device_function("pece_fz", exprs, varmap, _sig(real), real)
    return DeviceSystem(name, n, nz, n_p, _header(name, n, nz, n_p, body, real), real)


def _base_varmap(problem) -> dict:
    varmap = {f"__y_{i}": f"y[{i}]" for i in range(problem.n_states)}
    varmap.update({f"__p_{j}": f"p[{j}]" for j in range(problem.n_all_params)})
    return varmap


def forward_system(problem, real: str = "double") -> DeviceSystem:
    """``out = f(t, y, p)`` for the forward solve."""
    n = problem.n_states
    varmap = _base_varmap(problem)
    varmap[problem.sym_time.name] = "t"
    return _system("forward", n, n, problem.n_all_params, problem.sym_rhs, varmap, real)


def transition_system(problem, real: str = "double") -> DeviceSystem:
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
    return _system("transition", n_state, nz, problem.n_all_params,
                   np.array(dy + dM + dW, dtype=object), varmap, real)


def _adjoint_rows(problem, to_t: dict):
    """``(J^T lam, lam^T df/dp)`` with the time substituted, over the
    problem's own ``__lam_i`` symbols: the negated adjoint right-hand side
    and the adjoint quadrature, as ``make_adjoint_rhs`` and
    ``make_adjoint_quad_rhs`` compute them."""
    n, nd = problem.n_states, problem.n_params
    sub = lambda e: sy.sympify(e).xreplace(to_t)  # noqa: E731
    J = np.asarray(problem.sym_jac, dtype=object).reshape(n, n)
    Bm = np.asarray(problem.sym_dfdp, dtype=object).reshape(n, nd)
    lam = [sy.Symbol(f"__lam_{i}", real=True) for i in range(n)]
    dlam = [sub(sum(lam[j] * J[j, i] for j in range(n))) for i in range(n)]
    quad = [sub(sum(lam[j] * Bm[j, k] for j in range(n))) for k in range(nd)]
    return dlam, quad


def resolve_system(problem, real: str = "double") -> DeviceSystem:
    """The backsolve adjoint, in tau = -t: state ``z = [y | lam]``, outputs
    ``[-f | J^T lam | lam^T df/dp]``."""
    n, nd = problem.n_states, problem.n_params
    tau = sy.Symbol("__tau", real=True)
    to_t = {problem.sym_time: -tau}
    dy = [-sy.sympify(e).xreplace(to_t) for e in problem.sym_rhs]
    dlam, quad = _adjoint_rows(problem, to_t)
    varmap = _base_varmap(problem)
    varmap.update({f"__lam_{i}": f"y[{n + i}]" for i in range(n)})
    varmap["__tau"] = "t"
    nz = 2 * n + nd
    return _system("resolve", 2 * n, nz, problem.n_all_params,
                   np.array(dy + dlam + quad, dtype=object), varmap, real)


def staged_adjoint_system(problem, real: str = "double") -> DeviceSystem:
    """The checkpointed adjoint, in tau = -t: state ``lam``, y(t) read from
    the parameter rows ``n_p..n_p + n - 1``; outputs ``[J^T lam | lam^T
    df/dp]``."""
    n, nd, n_p = problem.n_states, problem.n_params, problem.n_all_params
    tau = sy.Symbol("__tau", real=True)
    dlam, quad = _adjoint_rows(problem, {problem.sym_time: -tau})
    varmap = _base_varmap(problem)
    varmap.update({f"__y_{i}": f"p[{n_p + i}]" for i in range(n)})
    varmap.update({f"__lam_{i}": f"y[{i}]" for i in range(n)})
    varmap["__tau"] = "t"
    nz = n + nd
    return _system("staged_adjoint", n, nz, n_p + n, np.array(dlam + quad, dtype=object),
                   varmap, real)


def _sensitivity_rows(problem) -> list:
    """``vec(J S + df/dp)`` over the problem's ``__s_k_i`` symbols, row
    ``k n + i`` being ``sum_j J[i, j] S[k, j] + df_i/dp_k``, as
    ``make_sensitivity_rhs`` computes ``S J^T + (df/dp)^T``."""
    n, nd = problem.n_states, problem.n_params
    J = np.asarray(problem.sym_jac, dtype=object).reshape(n, n)
    Bm = np.asarray(problem.sym_dfdp, dtype=object).reshape(n, nd)
    S = problem.sym_sens
    return [sum(J[i, j] * S[k, j] for j in range(n)) + Bm[i, k]
            for k in range(nd) for i in range(n)]


def sensitivity_system(problem, real: str = "double") -> DeviceSystem:
    """Simultaneous forward sensitivities: state ``z = [y | vec S]``
    (``S[k, i] = z[n + k n + i]``), outputs ``[f | vec(J S + df/dp)]``."""
    n, nd, n_p = problem.n_states, problem.n_params, problem.n_all_params
    varmap = _base_varmap(problem)
    varmap.update({f"__s_{k}_{i}": f"y[{n + k * n + i}]" for k in range(nd) for i in range(n)})
    varmap[problem.sym_time.name] = "t"
    exprs = np.array(list(problem.sym_rhs) + _sensitivity_rows(problem), dtype=object)
    nz = n + nd * n
    return _system("sensitivity", nz, nz, n_p, exprs, varmap, real)


def staged_sensitivity_system(problem, real: str = "double") -> DeviceSystem:
    """The sensitivity block of a staggered attempt: state ``vec S``
    (``S[k, i] = z[k n + i]``), y read from the parameter rows ``n_p..n_p
    + n - 1``; outputs ``vec(J S + df/dp)``."""
    n, nd, n_p = problem.n_states, problem.n_params, problem.n_all_params
    varmap = _base_varmap(problem)
    varmap.update({f"__y_{i}": f"p[{n_p + i}]" for i in range(n)})
    varmap.update({f"__s_{k}_{i}": f"y[{k * n + i}]" for k in range(nd) for i in range(n)})
    varmap[problem.sym_time.name] = "t"
    nS = nd * n
    return _system("staged_sensitivity", nS, nS, n_p + n,
                   np.array(_sensitivity_rows(problem), dtype=object), varmap, real)
