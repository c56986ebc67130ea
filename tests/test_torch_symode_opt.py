"""The symbolic layer's opt-in parts in sunode_torch against sunode_tpu's.

``tests/test_symode.py:261-340``'s cases on the port's ``lambdify_torch``:
cardinal B-splines and ``interpolate_spline`` (printed as their horner
Piecewise), the ``explog_opt`` rewrite, ``lambdify_torch(optims=,
simplify=)``; ``SympyProblem(simplify=...)``, whose every lowered function
and whose public symbolic pieces (which the CUDA emitter reads) are the
simplified ones; the spline Lotka-Volterra problem of ``entry.
build_lv_spline`` solved and differentiated on the Adams core against the
JAX package's; and the CUDA spelling of the spline at both types (the
build itself needs a card: ``tests/test_torch_cuda.py``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sympy as sy
import sympy.codegen.rewriting as rw
import torch

from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_tpu.symode import SympyProblem as JaxSympyProblem
from sunode_tpu.symode import interpolate_spline as jax_interpolate_spline
from sunode_tpu.symode.lambdify import CardinalBSpline as JaxBSpline
from sunode_tpu.symode.lambdify import DEFAULT_OPTIMS as JAX_OPTIMS
from sunode_tpu.symode.lambdify import explog_opt as jax_explog_opt
from sunode_tpu.symode.lambdify import lambdify_jax
from sunode_tpu.wrappers.as_jax import make_batched_solve_fn as jax_make_solve_fn
from sunode_torch.entry import LV_SPLINE_HORIZON, LV_SPLINE_K, lv_options, lv_spline_problem
from sunode_torch.ops.bdf import BDFOptions
from sunode_torch.symode import (
    CardinalBSpline,
    SympyProblem,
    cuda_codegen,
    explog_opt,
    interpolate_spline,
    lambdify_torch,
    stabilize_exp_products,
)
from sunode_torch.symode.lambdify import DEFAULT_OPTIMS
from sunode_torch.wrappers.as_torch import make_batched_solve_fn

jax.config.update("jax_enable_x64", True)

X = sy.Symbol("__y_0", real=True)
VARMAP = {"__y_0": "_y[0]"}


def _both(expr, **kw):
    """``expr`` of x lowered by both packages, each a function of a float64
    numpy array of x values."""
    exprs = np.array([expr], dtype=object)
    tf = lambdify_torch(["_y"], exprs, VARMAP, **kw)
    jf = lambdify_jax(["_y"], exprs, VARMAP, **kw)
    return (lambda x: tf(torch.as_tensor(x)[None]).numpy()[0],
            lambda x: np.asarray(jf(jnp.asarray(x)[None]))[0])


def test_cardinal_bspline_partition_of_unity():
    expr = sum(CardinalBSpline(3, X - i) for i in range(-4, 5))
    tf, _ = _both(expr)
    np.testing.assert_allclose(tf(np.array([2.0, 2.5, 3.7])), 1.0, atol=1e-12)
    jexpr = sum(JaxBSpline(3, X - i) for i in range(-4, 5))
    xs = np.linspace(-1.0, 6.0, 29)
    np.testing.assert_allclose(tf(xs), _both(jexpr)[1](xs), rtol=1e-15, atol=1e-15)


def test_interpolate_spline_endpoints():
    vals = [1.0, 2.0, 4.0, 3.0, 5.0]
    tf, _ = _both(interpolate_spline(X, vals, 0.0, 1.0, 1))
    for i, v in enumerate(vals):
        np.testing.assert_allclose(tf(np.array([i / (len(vals) - 1)])), [v], atol=1e-12)


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_interpolate_spline_matches_jax(degree):
    """Every degree, the pure (already Piecewise) form too, and the first
    derivative through ``CardinalBSpline.fdiff``."""
    vals = [0.5, 1.5, -0.25, 2.0, 1.0, 0.75]
    xs = np.linspace(-0.5, 10.5, 45)
    for pure in (False, True):
        t_expr = interpolate_spline(X, vals, 0.0, 10.0, degree, as_pure=pure)
        j_expr = jax_interpolate_spline(X, vals, 0.0, 10.0, degree, as_pure=pure)
        for tt, jj in ((t_expr, j_expr), (sy.diff(t_expr, X), sy.diff(j_expr, X))):
            np.testing.assert_allclose(_both(tt)[0](xs), _both(jj)[1](xs), rtol=1e-14,
                                       atol=1e-14)


def test_explog_opt_stabilizes_softmax():
    c1, c2 = sy.symbols("c1 c2", real=True)
    e = sy.exp(c2) / (sy.exp(c1) + sy.exp(c2))
    opt = rw.optimize(e, DEFAULT_OPTIMS + (explog_opt,))
    assert "logaddexp" in str(opt)
    assert str(opt) == str(rw.optimize(e, JAX_OPTIMS + (jax_explog_opt,)))
    assert stabilize_exp_products(e) == opt
    f = lambdify_torch(["_a", "_b"], np.array(opt, dtype=object), {"c1": "_a", "c2": "_b"},
                       optims=())
    out = float(f(torch.tensor(1000.0, dtype=torch.float64),
                  torch.tensor(1001.0, dtype=torch.float64)))
    assert np.isclose(out, 1 / (1 + np.exp(-1.0)))


@pytest.mark.parametrize(
    "expr, kw",
    [
        (sy.log(sy.exp(X) + sy.exp(2 * X)), {}),
        (sy.log(1 + X**2), dict(optims=())),
        (sy.exp(X) / (sy.exp(X) + sy.exp(2 * X)), dict(optims=DEFAULT_OPTIMS + (explog_opt,))),
        ((X**2 - 1) / (X - 1) + sy.sin(X) ** 2 + sy.cos(X) ** 2, dict(simplify=True)),
    ],
    ids=["default", "none", "explog", "simplify"],
)
def test_lambdify_options_match_jax(expr, kw):
    jkw = dict(kw)
    if "optims" in kw and kw["optims"]:
        jkw["optims"] = JAX_OPTIMS + (jax_explog_opt,)
    tf = lambdify_torch(["_y"], np.array([expr], dtype=object), VARMAP, **kw)
    jf = lambdify_jax(["_y"], np.array([expr], dtype=object), VARMAP, **jkw)
    xs = np.linspace(0.1, 3.0, 11)
    np.testing.assert_allclose(tf(torch.as_tensor(xs)[None]).numpy()[0],
                               np.asarray(jf(jnp.asarray(xs)[None]))[0], rtol=1e-14)
    if kw.get("simplify"):
        assert "sin" not in tf.__source__ and "cos" not in tf.__source__


def test_lambdify_debug_prints_the_source(capsys):
    f = lambdify_torch(["_y"], np.array([X + 1], dtype=object), VARMAP, debug=True)
    assert f.__source__ in capsys.readouterr().out


# ---- SympyProblem(simplify=...) ------------------------------------------------------
def _lv_trig(t, y, p):
    one = sy.sin(p.alpha) ** 2 + sy.cos(p.alpha) ** 2  # 1, until simplified
    return {
        "hares": p.alpha * y.hares * one - p.beta * y.lynx * y.hares,
        "lynx": p.delta * y.hares * y.lynx - p.gamma * y.lynx,
    }


def _trig_pair():
    spec = dict(params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
                states={"hares": (), "lynx": ()}, rhs_sympy=_lv_trig,
                derivative_params=[("alpha",), ("beta",)], simplify=sy.simplify)
    return SympyProblem(**spec), JaxSympyProblem(**spec)


def test_sympy_problem_simplify_matches_jax():
    """Every lowered function of the port's problem against the reference's
    (1e-14), and the simplified pieces are what the CUDA emitter prints."""
    tp, jp = _trig_pair()
    rng = np.random.default_rng(0)
    y, lam = rng.uniform(1, 3, (2, 5)), rng.uniform(-1, 1, (2, 5))
    p = rng.uniform(0.2, 1.5, (4, 5))
    t = rng.uniform(0, 1, 5)
    for name, args in (("make_rhs", (t, y, p)), ("make_jac_dense", (t, y, p)),
                       ("make_dfdp", (t, y, p)), ("make_adjoint_rhs", (t, y, lam, p)),
                       ("make_adjoint_quad_rhs", (t, y, lam, p))):
        got = getattr(tp, name)()(*(torch.as_tensor(a) for a in args)).numpy()
        jfn = getattr(jp, name)()
        for lane in range(5):
            want = jfn(*(a[lane] if a.ndim == 1 else jnp.asarray(a[:, lane]) for a in args))
            np.testing.assert_allclose(got[..., lane], np.asarray(want), rtol=1e-14, atol=1e-15)
    assert not any(e.has(sy.sin) for e in tp.sym_rhs)
    assert not any(e.has(sy.sin) for e in np.ravel(tp.sym_jac))
    assert any(e.has(sy.sin) for e in tp._sym_dydt)
    for real in ("double", "float"):
        body = cuda_codegen.forward_system(tp, real).source.split("pece_fz(", 1)[1]
        assert "sin" not in body and "cos" not in body
    assert tp.symbolic_roots(lambda t, y, p: y.hares * (sy.sin(t) ** 2 + sy.cos(t) ** 2))[0] \
        == sy.Symbol("__y_0", real=True)


# ---- the spline Lotka-Volterra problem -------------------------------------------------
def _jax_spline_problem():
    def rhs(t, y, p):
        alpha = jax_interpolate_spline(t, list(p.alpha), *LV_SPLINE_HORIZON, 3)
        return {"hares": alpha * y.hares - p.beta * y.lynx * y.hares,
                "lynx": p.delta * y.hares * y.lynx - p.gamma * y.lynx}

    return JaxSympyProblem(
        params={"alpha": (LV_SPLINE_K,), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()}, rhs_sympy=rhs,
        derivative_params=[("alpha",), ("beta",)],
    )


def _spline_inputs(B):
    rng = np.random.default_rng(3)
    y0 = np.array([10.0, 2.0]) * (1 + 0.05 * rng.standard_normal((B, 2)))
    p_sub = np.concatenate([1.0 + 0.05 * rng.standard_normal((B, LV_SPLINE_K)),
                            0.3 * (1 + 0.05 * rng.standard_normal((B, 1)))], axis=1)
    return y0, p_sub, np.array([1.0, 0.4]), np.linspace(1.0, 10.0, 6)


def test_lv_spline_gradients_match_jax():
    """``entry.lv_spline_problem`` through the Adams core and the transition
    adjoint (``build_lv_spline``'s call, on the CPU) against the same
    problem in the JAX package: ys and both gradients within 1e-8."""
    y0, p_sub, p_fix, tvals = _spline_inputs(3)
    fwd, adj = lv_options(1e-8)
    tsolve = make_batched_solve_fn(lv_spline_problem(), options=fwd, adjoint_options=adj,
                                   method="ADAMS", adjoint_interpolation="transition")
    yt = torch.as_tensor(y0).requires_grad_(True)
    pt = torch.as_tensor(p_sub).requires_grad_(True)
    ys = tsolve(0.0, yt, pt, torch.as_tensor(p_fix), torch.as_tensor(tvals))
    got = torch.autograd.grad(torch.sum(ys**2), (yt, pt))

    jfwd = JaxOptions(rtol=1e-8, atol=1e-8, adams_max_order=6)
    jadj = JaxOptions(rtol=jnp.asarray(np.asarray(adj.rtol)), atol=adj.atol, adams_max_order=6,
                      quad_rtol=1e-3, quad_atol=1e-3)
    jsolve = jax_make_solve_fn(_jax_spline_problem(), options=jfwd, adjoint_options=jadj,
                               method="ADAMS", adjoint_interpolation="transition")
    def loss(y, p):
        jys = jsolve(0.0, y, p, jnp.asarray(p_fix), jnp.asarray(tvals))
        return jnp.sum(jys**2), jys

    # one jitted call gives the reference's ys and gradients together
    (_, jys), want = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(y0), jnp.asarray(p_sub))
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(jys), rtol=1e-8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8)


@pytest.mark.parametrize("kind", ["forward", "transition"])
def test_spline_systems_emit_at_both_types(kind):
    """The spline as C ternaries in both builds' sources: the float system is
    float code (no double, every literal with its F)."""
    problem = lv_spline_problem()
    for real in ("double", "float"):
        ds = getattr(cuda_codegen, f"{kind}_system")(problem, real)
        body = ds.source.split("pece_fz(", 1)[1]
        assert "?" in body and ":" in body
        assert ds.n_p == LV_SPLINE_K + 3
        if real == "float":
            assert "double" not in body
            literals = re.findall(r"\d+\.\d*(?:[eE][-+]?\d+)?F?", body)
            assert literals and all(tok.endswith("F") for tok in literals)


def test_emitted_constants_are_the_plain_paths():
    """A Float in a float64 emitted system is spelt with the digits the plain
    path's printer writes, so both multiply by the same double: the spline's
    time scale 3 / 10, whose nearest double C's 17-digit spelling would miss."""
    problem = lv_spline_problem()
    c_src = cuda_codegen.forward_system(problem, "double").source
    py_src = problem.make_rhs().__source__
    c_scale = re.search(r"x_0 = ([0-9.eE+-]+)\*t;", c_src).group(1)
    py_scale = re.search(r"_x0 = ([0-9.eE+-]+)\*_t", py_src).group(1)
    assert float(c_scale) == float(py_scale) == 0.3
