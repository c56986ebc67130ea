"""Lower sympy expression arrays to torch functions with CSE preserved.

PyTorch counterpart of ``sunode_tpu/symode/lambdify.py``: the expressions
go through the same rewrites (log1p, two-term logsumexp), the same
Piecewise safe-where guards and the same ``sympy.cse`` pass, and are printed
as Python source whose body is one let-binding per common subexpression,
evaluating to torch tensors.  Every element may carry trailing batch
dimensions, so one call evaluates a whole ``(n, B)`` batch.

The output dtype follows the floating tensor arguments (float64 when there
are none); torch's global default dtype is never read.

The opt-in parts of the reference come along: :class:`CardinalBSpline` and
:func:`interpolate_spline` (time-varying inputs as cubic or any-degree
splines, printed as their horner Piecewise), :func:`stabilize_exp_products`
and the ``explog_opt`` rewrite (sign-definite exp-sum products through log
space), and ``lambdify_torch``'s ``optims``, ``simplify`` and ``debug``.
"""

from __future__ import annotations

import functools
import itertools
from functools import partial
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
    "CardinalBSpline",
    "interpolate_spline",
    "logsumexp_2terms_opt",
    "explog_opt",
    "stabilize_exp_products",
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


class CardinalBSpline(sy.Function):
    """Cardinal B-spline basis of a degree at x: ``CardinalBSpline(degree, x)``
    on the integer knots ``0..degree+1``, lowered as its horner-form
    Piecewise (``sunode_tpu/symode/lambdify.py::CardinalBSpline``)."""

    nargs = (2,)

    def fdiff(self, argindex=1):
        if argindex == 2:
            degree, x = self.args
            d = int(degree)
            if d == 0:
                return sy.Integer(0)
            # on cardinal knots B'_d(x) = B_{d-1}(x) - B_{d-1}(x - 1)
            return CardinalBSpline(d - 1, x) - CardinalBSpline(d - 1, x - 1)
        raise sy.function.ArgumentIndexError(self, argindex)

    def as_piecewise(self):
        degree, x = self.args
        d = int(degree)
        knots = tuple(sy.Integer(i) for i in range(d + 2))
        basis = sy.functions.special.bsplines.bspline_basis(d, knots, 0, x)
        pieces = [(sy.horner(e) if not e.is_Atom else e, c) for e, c in basis.args]
        return sy.Piecewise(*pieces)


def interpolate_spline(x, vals, lower, upper, degree, as_pure: bool = False):
    """Spline through ``vals`` on ``[lower, upper]`` from cardinal B-splines
    of ``degree`` (``sunode_tpu/symode/lambdify.py::interpolate_spline``);
    ``as_pure`` expands each basis function to its Piecewise now."""
    n_vals = len(vals)
    n_knots = degree + n_vals + 1
    basis = partial(CardinalBSpline, degree)
    x = (x - lower) / (upper - lower)
    x = degree + x * (n_knots - 2 * degree - 1)
    basis_vecs = [basis(x - i) for i in range(n_vals)]
    if as_pure:
        basis_vecs = [b.as_piecewise() for b in basis_vecs]
    return sum(val * b for val, b in zip(vals, basis_vecs))


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


def _is_exp_sum(e):
    """exp(a) or a two-term sum of exps (the logaddexp-rewritable shape)."""
    if isinstance(e, sy.exp):
        return True
    return isinstance(e, sy.Add) and len(e.args) == 2 and all(
        isinstance(a, sy.exp) for a in e.args
    )


def _is_exp_like_factor(e):
    if _is_exp_sum(e):
        return True
    if isinstance(e, sy.Pow) and _is_exp_sum(e.args[0]):
        return True
    if isinstance(e, sy.Mul):
        return any(_is_exp_like_factor(a) for a in e.args)
    return False


def _has_multiple_exp_factors(e):
    return isinstance(e, sy.Mul) and sum(bool(_is_exp_like_factor(a)) for a in e.args) > 1


def stabilize_exp_products(expr, optims=None):
    """Rewrite sign-definite products and quotients of exp-sums through log
    space: ``exp(c2)/(exp(c1)+exp(c2))`` becomes ``exp(c2 - logaddexp(c1,
    c2))``, which cannot overflow
    (``sunode_tpu/symode/lambdify.py::stabilize_exp_products``)."""
    from sympy.assumptions import Q, ask

    if optims is None:
        optims = DEFAULT_OPTIMS
    pos = ask(Q.positive(expr))
    neg = False if pos else ask(Q.negative(expr))
    if not (pos or neg):
        if expr.args:
            return expr.func(*[stabilize_exp_products(a, optims) for a in expr.args])
        return expr
    sign = sy.S.One if pos else sy.S.NegativeOne
    log_expr = sy.expand_log(sy.log(sign * expr), force=True)
    log_expr = sympy.codegen.rewriting.optimize(log_expr, optims)
    return sign * sy.exp(log_expr, evaluate=False)


def _explog_filter(l):
    from sympy.assumptions import Q, ask

    return (ask(Q.positive(l)) or ask(Q.negative(l))) and _has_multiple_exp_factors(l)


# opt-in: ``lambdify_torch(optims=DEFAULT_OPTIMS + (explog_opt,))``, as the
# reference defines it without enabling it
explog_opt = sympy.codegen.rewriting.ReplaceOptim(_explog_filter, stabilize_exp_products)

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

    def _print_CardinalBSpline(self, expr):
        return self._print(expr.as_piecewise())

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
    optims: Sequence[Any] | None = None,
    simplify: bool = False,
    debug: bool = False,
) -> Callable:
    """Compile a sympy expression array into a torch function.

    Same contract as ``sunode_tpu.symode.lambdify.lambdify_jax``: ``argnames``
    are the positional arguments as they appear in the ``varmap`` access
    expressions (e.g. ``["_t", "_y", "_p"]``); the function returns a tensor
    of shape ``exprs.shape + batch``, where ``batch`` is the broadcast shape
    of the elements.  ``optims`` are the ``sympy.codegen.rewriting``
    rewrites applied to each element before CSE (default log1p and the
    two-term logsumexp; ``()`` none), ``simplify`` runs ``sympy.simplify``
    on each element first, ``debug`` prints the source.  The generated
    source is attached as ``f.__source__``.
    """
    exprs = np.asarray(exprs, dtype=object)
    shape = exprs.shape
    flat = [sy.sympify(e) for e in exprs.reshape(-1)]
    if simplify:
        flat = [sy.simplify(e) for e in flat]
    if optims is None:
        optims = DEFAULT_OPTIMS
    if optims:
        flat = [sympy.codegen.rewriting.optimize(e, optims) for e in flat]
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
    if debug:
        print(source)
    return fn
