"""Lower sympy expression arrays to torch functions with CSE preserved.

PyTorch counterpart of ``sunode_tpu/symode/lambdify.py``: the expressions
go through the same rewrites (log1p, two-term logsumexp), the same
Piecewise safe-where guards and the same ``sympy.cse`` pass, and are printed
as Python source whose body is one let-binding per common subexpression,
evaluating to torch tensors.  Every element may carry trailing batch
dimensions, so one call evaluates a whole ``(n, B)`` batch.

The output dtype follows the floating tensor arguments (float64 when there
are none); torch's global default dtype is never read.
"""

from __future__ import annotations

import functools
import itertools
import linecache
import math
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import sympy as sy
import sympy.codegen.rewriting
import torch
from sympy.printing.numpy import NumPyPrinter

__all__ = [
    "lambdify_torch",
    "logaddexp",
    "expit",
    "dexpit",
    "logsumexp_2terms_opt",
    "DEFAULT_OPTIMS",
]


class logaddexp(sy.Function):
    """log(exp(a) + exp(b)) computed stably; lowers to torch.logaddexp."""

    nargs = (2,)

    def fdiff(self, argindex=1):
        if argindex in (1, 2):
            a, b = self.args
            other = b if argindex == 1 else a
            # d/da log(e^a + e^b) = sigmoid(a - b)
            return expit(self.args[argindex - 1] - other)
        raise sy.function.ArgumentIndexError(self, argindex)

    def _eval_is_real(self):
        return self.args[0].is_real and self.args[1].is_real


class expit(sy.Function):
    """Logistic sigmoid 1/(1+exp(-x)); lowers to torch.sigmoid."""

    nargs = (1,)

    def fdiff(self, argindex=1):
        if argindex == 1:
            return dexpit(self.args[0])
        raise sy.function.ArgumentIndexError(self, argindex)

    def _eval_is_real(self):
        return self.args[0].is_real


class dexpit(sy.Function):
    """Derivative of expit: expit(x) * (1 - expit(x))."""

    nargs = (1,)

    def fdiff(self, argindex=1):
        if argindex == 1:
            x = self.args[0]
            return dexpit(x) * (1 - 2 * expit(x))
        raise sy.function.ArgumentIndexError(self, argindex)

    def _eval_is_real(self):
        return self.args[0].is_real


# Rewrite: log(exp(a) + exp(b)) -> logaddexp(a, b)
logsumexp_2terms_opt = sympy.codegen.rewriting.ReplaceOptim(
    lambda l: (
        isinstance(l, sy.log)
        and l.args[0].is_Add
        and len(l.args[0].args) == 2
        and all(isinstance(t, sy.exp) for t in l.args[0].args)
    ),
    lambda l: logaddexp(l.args[0].args[0].args[0], l.args[0].args[1].args[0]),
)

DEFAULT_OPTIMS = (sympy.codegen.rewriting.log1p_opt, logsumexp_2terms_opt)

# numpy names that torch spells differently, and constants taken from math
_TORCH_RENAMES = {
    "mod": "remainder", "equal": "eq", "not_equal": "ne",
    "arctan2": "atan2", "arcsin": "asin", "arccos": "acos", "arctan": "atan",
    "arcsinh": "asinh", "arccosh": "acosh", "arctanh": "atanh",
}
_MATH_CONSTANTS = ("pi", "e", "inf", "nan")


class _TorchExprPrinter(NumPyPrinter):
    """Print sympy scalars as torch expressions, mapping problem symbols
    through a varmap of symbol-name -> access expression (e.g. '_y[3]').

    Wherever torch needs a tensor operand (``where``, ``maximum``), operands
    go through ``_tt``, which the generated function defines to turn a Python
    number into a tensor of the call's dtype and device."""

    def __init__(self, varmap: Mapping[str, str]):
        super().__init__()
        self._varmap = dict(varmap)

    def _print_Symbol(self, expr):
        return self._varmap.get(expr.name, expr.name)

    def _module_format(self, fqn, register=True):
        out = super()._module_format(fqn, register)
        for prefix in ("numpy.", "np."):
            if out.startswith(prefix):
                name = out[len(prefix):]
                if name in _MATH_CONSTANTS:
                    return "math." + name
                return "torch." + _TORCH_RENAMES.get(name, name)
        return out

    def _print_And(self, expr):
        parts = [self._print(a) for a in expr.args]
        out = parts[0]
        for p in parts[1:]:
            out = f"torch.logical_and({out}, {p})"
        return out

    def _print_Or(self, expr):
        parts = [self._print(a) for a in expr.args]
        out = parts[0]
        for p in parts[1:]:
            out = f"torch.logical_or({out}, {p})"
        return out

    def _print_Not(self, expr):
        return f"torch.logical_not({self._print(expr.args[0])})"

    def _fold(self, fn, expr):
        parts = [self._print(a) for a in expr.args]
        out = f"_tt({parts[0]})"
        for p in parts[1:]:
            out = f"{fn}({out}, _tt({p}))"
        return out

    def _print_Max(self, expr):
        return self._fold("torch.maximum", expr)

    def _print_Min(self, expr):
        return self._fold("torch.minimum", expr)

    def _print_logaddexp(self, expr):
        a, b = (self._print(x) for x in expr.args)
        return f"torch.logaddexp(_tt({a}), _tt({b}))"

    def _print_expit(self, expr):
        return f"torch.sigmoid(_tt({self._print(expr.args[0])}))"

    def _print_dexpit(self, expr):
        return f"_dexpit(_tt({self._print(expr.args[0])}))"

    def _print__safe_where(self, expr):
        cond, val, safe = (self._print(a) for a in expr.args)
        return f"torch.where({cond}, _tt({val}), _tt({safe}))"

    def _print_Piecewise(self, expr):
        # Chain of torch.where; the final condition may be True.  Singular
        # operands inside pieces were already clamped by
        # _apply_piecewise_guards before CSE.
        result = None
        for e, c in reversed(expr.args):
            body = self._print(e)
            if c == sy.true or result is None:
                result = body
            else:
                result = f"torch.where({self._print(c)}, _tt({body}), _tt({result}))"
        return result


class _safe_where(sy.Function):
    """Opaque clamp ``_safe_where(cond, val, safe)`` -> where(cond, val, safe);
    an undefined Function passes through CSE untouched."""

    nargs = (3,)


def _apply_piecewise_guards(expr):
    """Safe-where pass over every Piecewise in ``expr`` (run before CSE so a
    hoisted common subexpression can't escape its guard).  Both branches of
    a ``torch.where`` always evaluate, so each piece's singular operands are
    clamped under the condition that selects the piece."""
    if not expr.has(sy.Piecewise):
        return expr

    def xform(pw):
        args = list(pw.args)
        conds = [c for _, c in args]
        new_args = []
        for i, (e, c) in enumerate(args):
            if c == sy.true:
                earlier = [cc for cc in conds[:i] if cc != sy.true]
                guard = sy.Not(sy.Or(*earlier)) if earlier else None
            else:
                guard = c
            new_args.append((_guard_singular(e, guard), c))
        return sy.Piecewise(*new_args, evaluate=False)

    return expr.replace(lambda e: isinstance(e, sy.Piecewise), xform)


def _guard_singular(expr, guard):
    """Clamp operands of singular functions (log, x**negative,
    x**fractional, asin/acos/atanh) to an in-domain constant where ``guard``
    is false; those lanes are discarded by the surrounding where."""
    if guard is None or expr.is_Atom:
        return expr

    def rec(e):
        if e.is_Atom:
            return e
        args = tuple(rec(a) for a in e.args)
        if isinstance(e, sy.log):
            return sy.log(_safe_where(guard, args[0], sy.S.One), evaluate=False)
        if isinstance(e, sy.Pow):
            b, ex = args
            if ex.is_number and (ex.is_negative or ex.is_integer is False):
                return sy.Pow(_safe_where(guard, b, sy.S.One), ex, evaluate=False)
        if isinstance(e, (sy.asin, sy.acos, sy.atanh)):
            return e.func(_safe_where(guard, args[0], sy.S.Zero), evaluate=False)
        return e.func(*args)

    return rec(expr)


def _fold_numbers(expr):
    """Evaluate numeric subexpressions such as ``sqrt(2)`` or ``exp(3)`` to
    floats: torch functions take tensors, not Python numbers."""

    def is_foldable(e):
        return (
            not e.is_Atom
            and not isinstance(e, (sy.Rational, sy.Float))
            and e.is_number
            and e.evalf(20).is_Float
        )

    return expr.replace(is_foldable, lambda e: sy.Float(e.evalf(20), 20))


def _expand_special(expr):
    if expr.has(sy.Derivative):
        expr = expr.doit()
    return expr


_module_counter = itertools.count()


def _dexpit(x):
    s = torch.sigmoid(x)
    return s * (1 - s)


def lambdify_torch(
    argnames: Sequence[str],
    exprs: Any,
    varmap: Mapping[str, str],
    *,
    name: str = "compute",
) -> Callable:
    """Compile a sympy expression array into a torch function.

    Same contract as ``sunode_tpu.symode.lambdify.lambdify_jax``: ``argnames``
    are the positional arguments as they appear in the ``varmap`` access
    expressions (e.g. ``["_t", "_y", "_p"]``); the function returns a tensor
    of shape ``exprs.shape + batch``, where ``batch`` is the broadcast shape
    of the elements.  The generated source is attached as ``f.__source__``.
    """
    exprs = np.asarray(exprs, dtype=object)
    shape = exprs.shape
    flat = [sy.sympify(e) for e in exprs.reshape(-1)]
    flat = [sympy.codegen.rewriting.optimize(e, DEFAULT_OPTIMS) for e in flat]
    flat = [_expand_special(e) for e in flat]
    flat = [_apply_piecewise_guards(e) for e in flat]
    flat = [_fold_numbers(e) for e in flat]

    replacements, reduced = sy.cse(
        flat, symbols=sy.numbered_symbols("_x"), order="none"
    )
    printer = _TorchExprPrinter(varmap)

    args_tuple = ", ".join(argnames) + ("," if len(argnames) == 1 else "")
    lines = [f"def {name}({', '.join(argnames)}):"]
    lines.append(
        f"    _c = [_a for _a in ({args_tuple}) if torch.is_tensor(_a)]"
    )
    lines.append(
        "    _f = [_a.dtype for _a in _c if _a.is_floating_point()]"
    )
    lines.append(
        "    _dt = functools.reduce(torch.promote_types, _f) if _f else torch.float64"
    )
    lines.append("    _dev = _c[0].device if _c else None")
    lines.append(
        "    _tt = lambda _v: _v if torch.is_tensor(_v) else "
        "torch.as_tensor(_v, dtype=_dt, device=_dev)"
    )
    for sym, sub in replacements:
        lines.append(f"    {sym.name} = {printer.doprint(sub)}")
    elems = ", ".join(f"_tt({printer.doprint(e)})" for e in reduced)
    lines.append(f"    _out = torch.stack(torch.broadcast_tensors({elems})).to(_dt)")
    if shape == ():
        lines.append("    return _out[0]")
    else:
        lines.append(f"    return _out.reshape({shape!r} + tuple(_out.shape[1:]))")
    source = "\n".join(lines) + "\n"

    modname = f"<sunode_torch.lambdify.{name}.{next(_module_counter)}>"
    namespace: dict[str, Any] = {
        "torch": torch,
        "math": math,
        "functools": functools,
        "_dexpit": _dexpit,
    }
    code = compile(source, modname, "exec")
    linecache.cache[modname] = (
        len(source),
        None,
        source.splitlines(keepends=True),
        modname,
    )
    exec(code, namespace)
    fn = namespace[name]
    fn.__source__ = source
    return fn
