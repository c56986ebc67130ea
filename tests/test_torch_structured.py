"""Structured Newton on sunode_torch's batched BDF core against sunode_tpu's.

The batched cases of ``tests/test_batched_structured.py`` and
``tests/test_bbd.py``: the stiff Fisher-KPP chain (tridiagonal Jacobian)
with band, band plus forward sensitivities and spgmr Newton; a scrambled
SIR chain with sparse (RCM-banded) Newton; the hub problem (an arrowhead
Jacobian) with sparse Newton through the bordered-block-diagonal Schur
solve; and the adjoint gradients of ``make_batched_solve_fn(linear_solver=
'band' | 'sparse')``, whose backward matrix takes the transposed structure.
Each case runs the same numpy-seeded inputs through the JAX package and
the port (the plain banded LU on the CPU), each computing only its own
reference.

Tolerances: the ys within rtol 1e-6 / atol 1e-11 of the reference's and the
step statistics within 2 a lane (``tests/test_torch_bdf_batched.py:91,
:104``: the reference's FMA contraction and torch's ``pow`` move a marginal
step); the gradients within 1e-6 / 1e-10 of the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_tpu.ops.bdf_batched import bdf_solve_batched as jax_solve
from sunode_tpu.ops.sparsity import SparsePlan as JaxPlan
from sunode_tpu.ops.sparsity import make_colored_banded_jac as jax_colored
from sunode_tpu.problem import JaxProblem
from sunode_tpu.wrappers.as_jax import make_batched_solve_fn as jax_make_solve_fn
from sunode_torch.ops.bdf import BDFOptions
from sunode_torch.ops.bdf_batched import bdf_solve_batched
from sunode_torch.ops.sparsity import SparsePlan, make_colored_banded_jac
from sunode_torch.problem import TorchProblem
from sunode_torch.wrappers.as_torch import make_batched_solve_fn

jax.config.update("jax_enable_x64", True)

STEP_STATS = ("n_steps", "n_error_test_fails", "n_conv_fails", "n_newton_iters")
OPTS = dict(rtol=1e-8, atol=1e-10)


# ---- problems, written once in jnp and once in torch --------------------------
def _kpp(xp, cat):
    def rhs(t, y, p):
        u = y.u
        zero = xp.zeros(1, dtype=u.dtype)
        lap = cat([u[1:2] - u[0:1], u[2:] - u[1:-1], u[-2:-1] - u[-1:]])
        lap2 = cat([zero, u[:-2] - u[1:-1], zero])
        return {"u": p.D * (lap + lap2) + p.r * u * (1.0 - u)}

    return rhs


def _hub(xp, cat):
    def rhs(t, y, p):
        u = y.u
        zero = xp.zeros(1, dtype=u.dtype)
        lap = cat([u[1:2] - u[0:1], u[2:] - u[1:-1], u[-2:-1] - u[-1:]])
        lap2 = cat([zero, u[:-2] - u[1:-1], zero])
        return {"u": p.D * (lap + lap2) - u * (u - 1.0) + p.c * y.h,
                "h": -p.a * y.h + p.b * xp.mean(u)}

    return rhs


def _sir(xp, roll):
    def rhs(t, y, p):
        I_eff = y.I + p.mix * (roll(y.I, 1) + roll(y.I, -1))
        inf = p.beta * y.S * I_eff
        return {"S": -inf, "I": inf - p.gamma * y.I, "R": p.gamma * y.I}

    return rhs


def _pair(kind, n):
    """(port TorchProblem, reference JaxProblem) of one problem."""
    if kind == "kpp":
        spec = dict(params={"D": (), "r": ()}, states={"u": (n,)},
                    derivative_params=[("D",), ("r",)])
        rhs = _kpp
    elif kind == "hub":
        spec = dict(params={"D": (), "a": (), "b": (), "c": ()}, states={"u": (n,), "h": ()},
                    derivative_params=[("D",), ("b",)])
        rhs = _hub
    else:
        spec = dict(params={"beta": (), "gamma": (), "mix": ()},
                    states={"S": (n,), "I": (n,), "R": (n,)},
                    derivative_params=[("beta",), ("gamma",)])
        return (TorchProblem(rhs=_sir(torch, lambda a, s: torch.roll(a, s)), **spec),
                JaxProblem(rhs=_sir(jnp, jnp.roll), **spec))
    return (TorchProblem(rhs=rhs(torch, torch.cat), **spec),
            JaxProblem(rhs=rhs(jnp, jnp.concatenate), **spec))


def _kpp_inputs(n, b, seed):
    """``tests/test_batched_structured.py::_rd_inputs``."""
    rng = np.random.default_rng(seed)
    y0 = 0.5 + 0.3 * rng.random((b, n))
    params = np.stack([50.0 * (1 + 0.2 * rng.random(b)), 1.0 + 0.1 * rng.random(b)], axis=1)
    return y0, params, np.linspace(0.05, 1.0, 6)


def _hub_inputs(n, b, seed):
    """``tests/test_bbd.py::_hub_inputs``."""
    rng = np.random.default_rng(seed)
    y0 = np.concatenate([0.4 + 0.3 * rng.random((b, n)), 0.1 * rng.random((b, 1))], axis=1)
    params = np.stack([40.0 * (1 + 0.2 * rng.random(b)), 30.0 * (1 + 0.1 * rng.random(b)),
                       2.0 + 0.2 * rng.random(b), 0.5 + 0.1 * rng.random(b)], axis=1)
    return y0, params, np.linspace(0.05, 1.0, 6)


def _sir_inputs(regions, b, seed):
    """``tests/test_batched_structured.py``'s scrambled-structure SIR chains."""
    rng = np.random.default_rng(seed)
    y0 = np.stack([np.concatenate([0.99 + 0.005 * rng.standard_normal(regions),
                                   0.01 * np.abs(1 + 0.1 * rng.standard_normal(regions)),
                                   np.zeros(regions)]) for _ in range(b)])
    params = np.stack([0.4 + 0.02 * rng.random(b), 0.15 + 0.01 * rng.random(b),
                       np.full(b, 0.05)], axis=1)
    return y0, params, np.linspace(5.0, 40.0, 5)


def _compare(tres, jres, sens_rtol=None):
    np.testing.assert_array_equal(tres.status.numpy(), np.asarray(jres.status))
    assert (tres.status == 0).all()
    np.testing.assert_allclose(tres.ys.numpy(), np.asarray(jres.ys), rtol=1e-6, atol=1e-11)
    for stat in STEP_STATS:
        np.testing.assert_allclose(tres.stats[stat].numpy(), np.asarray(jres.stats[stat]),
                                   rtol=0, atol=2, err_msg=stat)
    # the structured path really factored (not a dense fallback)
    assert (tres.stats["n_factorizations"] > 0).all()
    if sens_rtol is not None:
        np.testing.assert_allclose(tres.sens.numpy(), np.asarray(jres.sens), rtol=sens_rtol,
                                   atol=1e-9)


def _both(tp, jp, tjac, jjac, y0, params, tvals, opts, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    jres = jax_solve(jp.make_rhs(), jjac, 0.0, jnp.asarray(y0), jnp.asarray(params),
                     jnp.asarray(tvals), JaxOptions(**opts), **jkw)
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tres = bdf_solve_batched(tp.make_rhs(), tjac, 0.0, torch.as_tensor(y0),
                             torch.as_tensor(params), torch.as_tensor(tvals), BDFOptions(**opts),
                             batched_fns=True, **tkw)
    return tres, jres


def test_batched_band_matches_jax():
    tp, jp = _pair("kpp", 12)
    y0, params, tvals = _kpp_inputs(12, 3, 0)
    opts = dict(OPTS, linear_solver="band", band_lower=1, band_upper=1)
    tres, jres = _both(tp, jp, tp.make_banded_jac(1, 1), jp.make_banded_jac(1, 1), y0, params,
                       tvals, opts)
    _compare(tres, jres)
    # the lockstep calls of the banded LU the stats report: the first
    # identity factorization and one solve a lockstep Newton iteration
    assert tres.stats["n_linear_factors"] >= 2
    assert tres.stats["n_linear_solves"] >= tres.stats["n_attempts"]


def test_batched_band_with_sensitivities_matches_jax():
    """``test_batched_band_with_sensitivities``: the sensitivity corrector's
    right-hand sides go through the banded solve in one call each."""
    tp, jp = _pair("kpp", 10)
    y0, params, tvals = _kpp_inputs(10, 3, 1)
    S0 = np.zeros((3, 2, 10))
    opts = dict(rtol=1e-7, atol=1e-9, linear_solver="band", band_lower=1, band_upper=1)
    jsens = jp.make_sensitivity_rhs()
    jres = jax_solve(jp.make_rhs(), jp.make_banded_jac(1, 1), 0.0, jnp.asarray(y0),
                     jnp.asarray(params), jnp.asarray(tvals), JaxOptions(**opts),
                     sens_rhs=jsens, S0=jnp.asarray(S0))
    tres = bdf_solve_batched(tp.make_rhs(), tp.make_banded_jac(1, 1), 0.0, torch.as_tensor(y0),
                             torch.as_tensor(params), torch.as_tensor(tvals), BDFOptions(**opts),
                             sens_rhs=tp.make_sensitivity_rhs(), S0=torch.as_tensor(S0),
                             batched_fns=True)
    _compare(tres, jres, sens_rtol=1e-6)


def test_batched_sparse_rcm_matches_jax():
    """The scrambled SIR chain through 'sparse' with no border (``border=0``;
    'auto' borders six vertices here): colored jvps into RCM-banded storage,
    residuals permuted around the banded LU."""
    tp, jp = _pair("sir", 6)
    pattern = tp.jac_sparsity()
    np.testing.assert_array_equal(pattern, jp.jac_sparsity())
    plan, jplan = SparsePlan(pattern, border=0), JaxPlan(pattern, border=0)
    assert plan.k_border == 0 and plan.lower + plan.upper < 17
    y0, params, tvals = _sir_inputs(6, 3, 3)
    opts = dict(OPTS, linear_solver="sparse", band_lower=plan.lower, band_upper=plan.upper,
                sparse_perm=plan.perm)
    tres, jres = _both(tp, jp, make_colored_banded_jac(tp.make_rhs(), plan),
                       jax_colored(jp.make_rhs(), jplan), y0, params, tvals, opts)
    _compare(tres, jres)


def test_batched_sparse_bbd_matches_jax():
    """``test_batched_sparse_bbd_matches_vmap_dense``: the hub's border
    through the Schur complement, against the reference's batched BBD."""
    tp, jp = _pair("hub", 12)
    plan = SparsePlan(tp.jac_sparsity())
    assert plan.k_border >= 1
    y0, params, tvals = _hub_inputs(12, 3, 2)
    opts = dict(OPTS, linear_solver="sparse", band_lower=plan.lower, band_upper=plan.upper,
                sparse_perm=plan.perm, sparse_border=plan.k_border)
    tres, jres = _both(tp, jp, make_colored_banded_jac(tp.make_rhs(), plan),
                       jax_colored(jp.make_rhs(), JaxPlan(jp.jac_sparsity())), y0, params, tvals,
                       opts)
    _compare(tres, jres)


def test_batched_spgmr_matches_jax():
    """``test_batched_spgmr_matches_vmap``: matrix-free Newton, GMRES(5) on
    jvps of the right-hand side; an explicit ``jac_prod`` gives the same
    solve as the default jvp."""
    tp, jp = _pair("kpp", 12)
    y0, params, tvals = _kpp_inputs(12, 3, 0)
    opts = dict(OPTS, linear_solver="spgmr")
    tres, jres = _both(tp, jp, None, jp.make_jac_dense(), y0, params, tvals, opts)
    np.testing.assert_array_equal(tres.status.numpy(), np.asarray(jres.status))
    np.testing.assert_allclose(tres.ys.numpy(), np.asarray(jres.ys), rtol=1e-6, atol=1e-11)
    for stat in STEP_STATS:
        np.testing.assert_allclose(tres.stats[stat].numpy(), np.asarray(jres.stats[stat]),
                                   rtol=0, atol=2, err_msg=stat)
    assert tres.stats["n_linear_factors"] == 0 and (tres.stats["n_factorizations"] == 0).all()
    explicit = bdf_solve_batched(
        tp.make_rhs(), None, 0.0, torch.as_tensor(y0), torch.as_tensor(params),
        torch.as_tensor(tvals), BDFOptions(**opts), batched_fns=True,
        jac_prod=tp.make_rhs_jac_prod(),
    )
    np.testing.assert_allclose(explicit.ys.numpy(), tres.ys.numpy(), rtol=1e-12, atol=1e-14)


# ---- adjoint gradients through make_batched_solve_fn ----------------------------
def _grads(solve, y0, p_sub, p_fix, tvals):
    y0 = torch.as_tensor(y0).requires_grad_(True)
    p_sub = torch.as_tensor(p_sub).requires_grad_(True)
    ys = solve(0.0, y0, p_sub, torch.as_tensor(p_fix), torch.as_tensor(tvals))
    return [g.numpy() for g in torch.autograd.grad(torch.sum(ys**2), (y0, p_sub))]


def _jax_grads(jp, y0, p_sub, p_fix, tvals, **kw):
    solve = jax_make_solve_fn(jp, options=JaxOptions(**OPTS), checkpoint_n=4096, **kw)
    loss = lambda y, ps: jnp.sum(  # noqa: E731
        solve(0.0, y, ps, jnp.asarray(p_fix), jnp.asarray(tvals)) ** 2)
    return [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(y0), jnp.asarray(p_sub))]


@pytest.mark.parametrize("case", ["band", "sparse_rcm", "sparse_bbd"])
def test_batched_adjoint_structured_matches(case):
    """``test_batched_adjoint_band_matches_dense_gradients``,
    ``test_batched_adjoint_sparse_matches_dense_gradients`` and
    ``test_batched_adjoint_sparse_bbd_gradients`` on both packages: the
    port's gradients through structured Newton forward and backward (the
    backward at the transposed structure) within 1e-6 / 1e-10 of the
    reference's, tighter than those tests' 1e-4 / 1e-8 to the dense ones."""
    if case == "band":
        tp, jp = _pair("kpp", 10)
        y0, p_sub, tvals = _kpp_inputs(10, 3, 4)
        p_fix = np.zeros((0,))
        kw = dict(linear_solver="band",
                  linear_solver_kwargs=dict(lower_bandwidth=1, upper_bandwidth=1))
    elif case == "sparse_rcm":
        tp, jp = _pair("sir", 5)
        y0, params, tvals = _sir_inputs(5, 3, 5)
        p_sub, p_fix = params[:, :2], params[0, 2:]
        kw = dict(linear_solver="sparse", linear_solver_kwargs=dict(border=0))
    else:
        tp, jp = _pair("hub", 10)
        y0, params, tvals = _hub_inputs(10, 3, 4)
        p_sub, p_fix = params[:, [0, 2]], params[0, [1, 3]]
        kw = dict(linear_solver="sparse")
    solve = make_batched_solve_fn(tp, options=BDFOptions(**OPTS), checkpoint_n=4096, **kw)
    got = _grads(solve, y0, p_sub, p_fix, tvals)
    fwd, bwd = solve.last_stats["forward"], solve.last_stats["backward"]
    assert fwd["n_linear_factors"] > 0 and bwd["n_linear_factors"] > 0
    for g, r in zip(got, _jax_grads(jp, y0, p_sub, p_fix, tvals, **kw)):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize(
    "kwargs, match",
    [
        (dict(method="ADAMS", linear_solver="band",
              linear_solver_kwargs=dict(lower_bandwidth=1, upper_bandwidth=1)),
         "requires method='BDF'"),
        (dict(linear_solver="band"), "lower_bandwidth"),
        (dict(linear_solver="klu"), "must be 'dense', 'band' or 'sparse'"),
    ],
    ids=["adams", "bandwidths", "unknown"],
)
def test_structured_refusals(kwargs, match):
    """The reference's refusals stay refusals
    (``tests/test_batched_structured.py:284``)."""
    with pytest.raises(ValueError, match=match):
        make_batched_solve_fn(_pair("kpp", 8)[0], **kwargs)
