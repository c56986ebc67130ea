"""sunode_torch batched BDF integrator against sunode_tpu's, lane by lane.

Both packages run the same float64 inputs from numpy.  The port's small
contractions (rescale, predictor, difference update, interpolation) round
in the reference's order, but its Newton solve is ``torch.linalg``'s LU
where the reference uses closed forms for n <= 3, and torch's ``pow``,
``sqrt`` and ``tanh`` differ from XLA's in the last ulp; so the port agrees
with the reference to rounding.  Each tolerance below is stated with the
worst deviation measured on the CPU beside it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_tpu.ops.bdf_batched import bdf_solve_batched as jax_solve
from sunode_tpu.ops.linalg import factor_newton_b as jax_factor
from sunode_tpu.ops.linalg import solve_factored_b as jax_solve_factored
from sunode_tpu.symode import SympyProblem as JaxSympyProblem
from sunode_tpu.wrappers.as_jax import make_batched_solve_fn as jax_make_batched_solve_fn
from sunode_torch.entry import (
    _lv,
    _robertson,
    build_robertson,
    lv_problem,
    robertson_options,
    robertson_problem,
)
from sunode_torch.ops.adams_batched import adams_solve_batched
from sunode_torch.ops.bdf import BDFOptions
from sunode_torch.ops.bdf_batched import bdf_solve_batched
from sunode_torch.ops.linalg import factor_newton_b, solve_factored_b
from sunode_torch.symode.problem import SympyProblem
from sunode_torch.wrappers.as_torch import make_batched_solve_fn

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
ROB_ATOL = np.array([1e-10, 1e-12, 1e-10])


def _golden(name):
    return np.load(os.path.join(GOLDEN, name))


def _jax_lv_problem():
    return JaxSympyProblem(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()},
        rhs_sympy=_lv,
        derivative_params=[("alpha",), ("beta",)],
    )


# ---- Robertson on the 16 golden lanes ---------------------------------------
@pytest.fixture(scope="module")
def robertson_pair():
    g = _golden("robertson.npz")
    B = g["ps"].shape[0]
    y0s = np.tile(g["y0"], (B, 1))
    jp = JaxSympyProblem(
        params={"k1": (), "k2": (), "k3": ()},
        states={"a": (), "b": (), "c": ()},
        rhs_sympy=_robertson,
        derivative_params=[("k1",)],
    )
    jres = jax.jit(
        lambda y, p: jax_solve(
            jp.make_rhs(), jp.make_jac_dense(), 0.0, y, p, jnp.asarray(g["tvals"]),
            JaxOptions(rtol=1e-8, atol=jnp.asarray(ROB_ATOL)),
        )
    )(jnp.asarray(y0s), jnp.asarray(g["ps"]))
    tp = robertson_problem()
    tres = bdf_solve_batched(
        tp.make_rhs(), tp.make_jac_dense(), 0.0, torch.as_tensor(y0s),
        torch.as_tensor(g["ps"]), torch.as_tensor(g["tvals"]), robertson_options(),
        batched_fns=True,
    )
    return g, jres, tres


def test_robertson_matches_jax(robertson_pair):
    g, jres, tres = robertson_pair
    np.testing.assert_array_equal(tres.status.numpy(), np.asarray(jres.status))
    assert (tres.status == 0).all()
    assert tres.stats["n_attempts"] == int(jres.stats["n_attempts"])  # 810 both
    # measured: 1.1e-11 relative, 3.9e-14 absolute (the solver's atol on b is 1e-12)
    np.testing.assert_allclose(tres.ys.numpy(), np.asarray(jres.ys), rtol=1e-6, atol=1e-11)


@pytest.mark.parametrize(
    "stat",
    ["n_steps", "n_error_test_fails", "n_conv_fails", "n_jac_evals", "n_factorizations",
     "n_newton_iters"],
)
def test_robertson_step_stats_match_jax(robertson_pair, stat):
    _, jres, tres = robertson_pair
    # measured: equal in every lane; the pow ulp drift (ROADMAP C) may move
    # a marginal step, so +-2 per lane
    np.testing.assert_allclose(
        tres.stats[stat].numpy(), np.asarray(jres.stats[stat]), rtol=0, atol=2
    )


def test_robertson_golden(robertson_pair):
    g, _, tres = robertson_pair
    # the gate of tests/test_golden.py::test_robertson_golden
    np.testing.assert_allclose(tres.ys.numpy(), g["ys"], rtol=2e-5, atol=1e-10)


def test_build_robertson_inputs_are_the_golden_lanes():
    g = _golden("robertson.npz")
    solve, (y0s, ps, p_fix, tvals) = build_robertson(20, device="cpu")
    assert ps.shape == (20, 3) and p_fix.shape == (0,)
    np.testing.assert_array_equal(ps.numpy()[:16], g["ps"])
    np.testing.assert_array_equal(tvals.numpy(), g["tvals"])
    np.testing.assert_array_equal(y0s.numpy(), np.tile(g["y0"], (20, 1)))
    assert solve.method == "BDF" and solve.derivatives is None


def test_build_robertson_defaults_to_the_card():
    """Without a card the default device raises: nothing quietly runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_robertson(2)


# ---- Lotka-Volterra: tests/test_bdf_batched.py's inputs ---------------------
SUBSET = [0, 1]
TVALS = np.linspace(0.5, 8.0, 7)
B_LV = 12


def _lv_inputs():
    rng = np.random.default_rng(0)
    y0s = np.array([10.0, 2.0]) * (1 + 0.1 * rng.standard_normal((B_LV, 2)))
    ps = np.array([1.0, 0.3, 1.0, 0.4]) * (1 + 0.1 * rng.standard_normal((B_LV, 4)))
    return y0s, ps


def jax_lv_rhs(t, y, p):
    a, b, g, d = p[0], p[1], p[2], p[3]
    return jnp.array([a * y[0] - b * y[0] * y[1], d * y[0] * y[1] - g * y[1]])


def jax_lv_jac(t, y, p):
    return jax.jacfwd(jax_lv_rhs, argnums=1)(t, y, p)


def jax_lv_sens_rhs(t, y, S, p):
    dfdp = jax.jacfwd(jax_lv_rhs, argnums=2)(t, y, p)[:, np.array(SUBSET)]
    return S @ jax_lv_jac(t, y, p).T + dfdp.T


def jax_lv_quad_rhs(t, y, p):
    return jnp.array([y[0] + y[1]])


# the same functions on one lane in torch; the solver vmaps them
def lv_rhs(t, y, p):
    a, b, g, d = p[0], p[1], p[2], p[3]
    return torch.stack([a * y[0] - b * y[0] * y[1], d * y[0] * y[1] - g * y[1]])


def lv_jac(t, y, p):
    a, b, g, d = p[0], p[1], p[2], p[3]
    return torch.stack([
        torch.stack([a - b * y[1], -b * y[0]]),
        torch.stack([d * y[1], d * y[0] - g]),
    ])


def lv_sens_rhs(t, y, S, p):
    dfdp = torch.stack([
        torch.stack([y[0], -y[0] * y[1]]),
        torch.stack([torch.zeros_like(y[0]), torch.zeros_like(y[0])]),
    ])  # (n, k): d f / d (alpha, beta)
    return S @ lv_jac(t, y, p).T + dfdp.T


def lv_quad_rhs(t, y, p):
    return torch.stack([y[0] + y[1]])


def _lv_pair(opts_kw, sens_quad=False, y0s=None, ps=None):
    if y0s is None:
        y0s, ps = _lv_inputs()
    B = y0s.shape[0]
    jkw, tkw = {}, {}
    if sens_quad:
        jkw = dict(sens_rhs=jax_lv_sens_rhs, S0=jnp.zeros((B, 2, 2)),
                   quad_rhs=jax_lv_quad_rhs, quad0=jnp.zeros((B, 1)))
        tkw = dict(sens_rhs=lv_sens_rhs, S0=torch.zeros((B, 2, 2), dtype=torch.float64),
                   quad_rhs=lv_quad_rhs, quad0=torch.zeros((B, 1), dtype=torch.float64))
    jres = jax.jit(
        lambda y, p: jax_solve(
            jax_lv_rhs, jax_lv_jac, 0.0, y, p, jnp.asarray(TVALS), JaxOptions(**opts_kw), **jkw
        )
    )(jnp.asarray(y0s), jnp.asarray(ps))
    tres = bdf_solve_batched(
        lv_rhs, lv_jac, 0.0, torch.as_tensor(y0s), torch.as_tensor(ps),
        torch.as_tensor(TVALS), BDFOptions(**opts_kw), **tkw,
    )
    return jres, tres


def _assert_step_stats_close(jres, tres):
    for stat in ("n_steps", "n_error_test_fails", "n_conv_fails"):
        np.testing.assert_allclose(
            tres.stats[stat].numpy(), np.asarray(jres.stats[stat]), rtol=0, atol=2,
            err_msg=stat,
        )


def test_lv_forward_matches_jax():
    jres, tres = _lv_pair(dict(rtol=1e-8, atol=1e-8))
    np.testing.assert_array_equal(tres.status.numpy(), np.asarray(jres.status))
    assert (tres.status == 0).all()
    _assert_step_stats_close(jres, tres)  # measured: equal
    # measured: 2.5e-12 relative, 1.9e-11 absolute (ys up to ~20)
    np.testing.assert_allclose(tres.ys.numpy(), np.asarray(jres.ys), rtol=1e-6, atol=1e-11)


def test_lv_sens_quad_matches_jax():
    jres, tres = _lv_pair(dict(rtol=1e-8, atol=1e-8, quad_err_con=True), sens_quad=True)
    np.testing.assert_array_equal(tres.status.numpy(), np.asarray(jres.status))
    assert (tres.status == 0).all()
    _assert_step_stats_close(jres, tres)  # measured: equal
    np.testing.assert_array_equal(
        tres.stats["n_sens_rhs_evals"].numpy(), np.asarray(jres.stats["n_sens_rhs_evals"])
    )
    # measured: ys 4.5e-13, sens 6.6e-11, quad 2.7e-14 relative
    np.testing.assert_allclose(tres.ys.numpy(), np.asarray(jres.ys), rtol=1e-6, atol=1e-11)
    np.testing.assert_allclose(tres.sens.numpy(), np.asarray(jres.sens), rtol=1e-6, atol=1e-11)
    np.testing.assert_allclose(tres.quad.numpy(), np.asarray(jres.quad), rtol=1e-6, atol=1e-11)
    assert tres.sens.shape == (B_LV, len(TVALS), 2, 2) and tres.quad.shape == (B_LV, len(TVALS), 1)


def test_lv_sens_golden():
    """The port's generated functions against the fixture, with the gate of
    tests/test_golden.py::test_lv_sens_golden."""
    g = _golden("lv_sens.npz")
    tp = lv_problem()
    B = g["y0s"].shape[0]
    res = bdf_solve_batched(
        tp.make_rhs(), tp.make_jac_dense(), 0.0, torch.as_tensor(g["y0s"]),
        torch.as_tensor(g["ps"]), torch.as_tensor(g["tvals"]),
        BDFOptions(rtol=1e-9, atol=1e-9), sens_rhs=tp.make_sensitivity_rhs(),
        S0=torch.zeros((B, 2, 2), dtype=torch.float64), batched_fns=True,
    )
    assert (res.status == 0).all()
    np.testing.assert_allclose(res.ys.numpy(), g["ys"], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(res.sens.numpy(), g["sens"], rtol=2e-4, atol=5e-4)


@pytest.mark.parametrize("case", ["bad_init", "max_steps"])
def test_failure_lanes_match_jax(case):
    """A NaN parameter is BAD_INIT and leaves the other lanes as they are
    alone; a step budget ends every lane with MAX_STEPS and the same per-lane
    post-mortem (where, with which step and order, the worst state)."""
    y0s, ps = _lv_inputs()
    y0s, ps = y0s[:6], ps[:6].copy()
    opts = dict(rtol=1e-8, atol=1e-8)
    if case == "bad_init":
        ps[2, 0] = np.nan
    else:
        opts["max_steps"] = 30
    jres, tres = _lv_pair(opts, y0s=y0s, ps=ps)
    status = tres.status.numpy()
    np.testing.assert_array_equal(status, np.asarray(jres.status))
    if case == "bad_init":
        assert status[2] == 3 and (np.delete(status, 2) == 0).all()
        healthy = np.delete(np.arange(6), 2)
        alone = bdf_solve_batched(
            lv_rhs, lv_jac, 0.0, torch.as_tensor(y0s[healthy]), torch.as_tensor(ps[healthy]),
            torch.as_tensor(TVALS), BDFOptions(**opts),
        )
        np.testing.assert_allclose(tres.ys.numpy()[healthy], alone.ys.numpy(), rtol=1e-13)
    else:
        assert (status == 1).all()
    # measured: error_time 8.8e-7 and error_step_size 3.5e-7 relative after
    # 30 steps at order 5, with the rescale, predictor and difference update
    # rounded in the reference's order: the order-selection estimates (high
    # differences, far below y) amplify the last-ulp differences of the two
    # libraries' pow and sqrt into the proposed step (ROADMAP C1, C2)
    for key in ("error_time", "error_step_size"):
        np.testing.assert_allclose(
            tres.stats[key].numpy(), np.asarray(jres.stats[key]), rtol=2e-6
        )
    for key in ("error_order", "error_worst_state"):
        np.testing.assert_array_equal(tres.stats[key].numpy(), np.asarray(jres.stats[key]))
    # the raw solver emits what it reached (NaN elsewhere); wrappers poison.
    # measured: 2.4e-12 relative (bad_init)
    np.testing.assert_allclose(tres.ys.numpy(), np.asarray(jres.ys), rtol=1e-6, atol=1e-11)


# ---- the Newton factorisation ------------------------------------------------
@pytest.mark.parametrize("n", [2, 3, 5])
def test_factor_solve_matches_jax(n):
    """Healthy lanes agree with the reference's closed forms / LU; a singular
    lane and a NaN lane come back non-finite there and only there."""
    rng = np.random.default_rng(n)
    B, k = 7, 3
    J = rng.standard_normal((n, n, B))
    c = rng.uniform(0.01, 1.0, B)
    M = np.eye(n)[:, :, None] - c * J
    M[1, :, 5] = M[0, :, 5]  # two equal rows: exactly singular
    M[0, 1, 6] = np.nan
    b = rng.standard_normal((n, B))
    bs = rng.standard_normal((k, n, B))
    jf = jax_factor(jnp.asarray(M))
    jx = np.asarray(jax_solve_factored(jf, jnp.asarray(b)))
    jxs = np.asarray(jax.vmap(jax_solve_factored, in_axes=(None, 0))(jf, jnp.asarray(bs)))
    tf = factor_newton_b(torch.as_tensor(M))
    tx = solve_factored_b(tf, torch.as_tensor(b)).numpy()
    txs = solve_factored_b(tf, torch.as_tensor(bs)).numpy()
    healthy = np.arange(5)
    # measured: 4.2e-16 (n=2), 1.2e-14 (n=3), 5.9e-14 (n=5) relative
    np.testing.assert_allclose(tx[:, healthy], jx[:, healthy], rtol=1e-12)
    np.testing.assert_allclose(txs[..., healthy], jxs[..., healthy], rtol=1e-12)
    for lane in (5, 6):
        assert not np.isfinite(tx[:, lane]).any() and not np.isfinite(txs[..., lane]).any()
    # the reference's NaN lane is NaN too; its singular lane is non-finite or,
    # where Cramer's determinant rounds away from 0 (n=3), of order 1e17: in
    # either case Newton rejects the lane
    assert not np.isfinite(jx[:, 6]).all()
    assert not np.isfinite(jx[:, 5]).all() or np.abs(jx[:, 5]).max() > 1e12
    assert tf.ok.tolist() == [True] * 5 + [False, False]


def test_solve_factored_nan_rhs_spoils_only_its_lane():
    M = torch.eye(3, dtype=torch.float64)[:, :, None].repeat(1, 1, 4) * 2.0
    b = torch.ones((3, 4), dtype=torch.float64)
    b[1, 2] = float("inf")
    x = solve_factored_b(factor_newton_b(M), b)
    assert torch.isnan(x[:, 2]).all()
    assert torch.equal(x[:, [0, 1, 3]], torch.full((3, 3), 0.5, dtype=torch.float64))


# ---- generated sensitivity right-hand side ----------------------------------
def test_make_sensitivity_rhs_matches_jax():
    rng = np.random.default_rng(7)
    B, n, k = 9, 2, 2
    t = rng.uniform(0, 5, B)
    y = rng.uniform(0.5, 10, (n, B))
    S = rng.standard_normal((k, n, B))
    p = np.array([1.0, 0.3, 1.0, 0.4])[:, None] * (1 + 0.1 * rng.standard_normal((4, B)))
    jax_fn = jax.vmap(_jax_lv_problem().make_sensitivity_rhs(), in_axes=(0, 1, 2, 1), out_axes=2)
    want = np.asarray(jax_fn(jnp.asarray(t), jnp.asarray(y), jnp.asarray(S), jnp.asarray(p)))
    got = lv_problem().make_sensitivity_rhs()(*(torch.as_tensor(a) for a in (t, y, S, p)))
    assert got.shape == (k, n, B)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-14)


# ---- what is not ported yet --------------------------------------------------
def lv_band_jac(t, y, p):
    """lv_jac in banded storage at bandwidths (1, 1)."""
    from sunode_torch.ops.banded import dense_to_banded

    return dense_to_banded(lv_jac(t, y, p), 1, 1)


@pytest.mark.parametrize(
    "kwargs, opts, match",
    [
        # rootfinding, staggered sensitivities, per-lane grids, jac_prod and
        # the band and spgmr linear solvers are ported, with each other too
        # (match None: the call solves, as the dense solve does)
        (dict(root_fn=lambda t, y, p: y[0], tvals=torch.ones((2, 3), dtype=torch.float64)), {},
         None),
        (dict(jac_prod=lambda t, y, v, p: v), {}, None),
        (dict(sens_rhs=lv_sens_rhs, S0=torch.zeros((2, 2, 2), dtype=torch.float64)),
         dict(sens_staggered=True, linear_solver="spgmr"), None),
        (dict(core="adams", tvals=torch.ones((2, 3), dtype=torch.float64)),
         dict(save_steps=16), None),
        (dict(jac=lv_band_jac), dict(linear_solver="band", band_lower=1, band_upper=1), None),
        ({}, dict(linear_solver="spgmr"), None),
        (dict(tvals=torch.ones((2, 3), dtype=torch.float64)), {}, None),
        ({}, dict(linear_solver="klu"), "linear_solver"),
    ],
    ids=["roots", "jac_prod", "staggered", "save_steps", "band", "spgmr", "per_lane_tvals",
         "unknown_solver"],
)
def test_unported_options_raise(kwargs, opts, match):
    """An unknown linear solver raises, as the reference's.  Every other
    option is ported, and with each other too: those cases (match None)
    solve, every lane on a (2, 3) grid emitting its own grid (here three
    copies of t = 1, so three equal slots), every other case as the dense
    solve without the option (within 1e-6)."""
    kwargs = dict(kwargs)
    tvals = kwargs.pop("tvals", torch.tensor([1.0], dtype=torch.float64))
    jac = kwargs.pop("jac", lv_jac)
    y0, p = torch.ones((2, 2), dtype=torch.float64), torch.ones((2, 4), dtype=torch.float64)

    def solve(opts=opts, kwargs=kwargs, jac=jac):
        kwargs = dict(kwargs)
        if kwargs.pop("core", "bdf") == "adams":
            return adams_solve_batched(lv_rhs, 0.0, y0, p, tvals, BDFOptions(**opts), **kwargs)
        return bdf_solve_batched(lv_rhs, jac, 0.0, y0, p, tvals, BDFOptions(**opts), **kwargs)

    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            solve()
        return
    res = solve()
    assert (res.status == 0).all()
    if tvals.ndim == 2:
        assert res.ys.shape == (2, 3, 2)
        assert torch.equal(res.ys[:, 1:], res.ys[:, :1].expand(2, 2, 2))
        return
    plain = solve({}, {k: v for k, v in kwargs.items() if k in ("sens_rhs", "S0")}, lv_jac)
    np.testing.assert_allclose(res.ys.numpy(), plain.ys.numpy(), rtol=1e-6)


# ---- the wrapper ---------------------------------------------------------------
def test_make_batched_solve_fn_bdf_matches_jax():
    """Forward ys of ``method='BDF', derivatives=None``, a NaN lane and a lane
    that runs out of steps poisoned as the reference poisons them."""
    y0s, ps = _lv_inputs()
    y0s, p_subs = y0s[:5].copy(), ps[:5, :2].copy()
    p_subs[1, 0] = np.nan
    y0s[3] *= 40.0  # a much sharper orbit: runs out of its 400 steps
    p_fix = np.array([1.0, 0.4])
    opts = dict(rtol=1e-8, atol=1e-8, max_steps=400)
    jsolve = jax_make_batched_solve_fn(
        _jax_lv_problem(), derivatives=None, options=JaxOptions(**opts), method="BDF"
    )
    jys = np.asarray(jax.jit(lambda y, p: jsolve(0.0, y, p, jnp.asarray(p_fix), jnp.asarray(TVALS)))(
        jnp.asarray(y0s), jnp.asarray(p_subs)
    ))
    tsolve = make_batched_solve_fn(
        lv_problem(), derivatives=None, options=BDFOptions(**opts), method="BDF"
    )
    tys = tsolve(
        0.0, torch.as_tensor(y0s), torch.as_tensor(p_subs), torch.as_tensor(p_fix),
        torch.as_tensor(TVALS),
    ).numpy()
    poisoned = ~np.isfinite(jys).all(axis=(1, 2))
    assert poisoned.tolist() == [False, True, False, True, False]
    assert np.isnan(tys[poisoned]).all()
    # measured: 1.2e-12 relative
    np.testing.assert_allclose(tys, jys, rtol=1e-6, atol=1e-11)
    stats = tsolve.last_stats["forward"]
    assert stats["n_attempts"] > 0 and stats["n_steps"].shape == (5,)


def test_bdf_adjoint_is_not_ported():
    """The transition adjoint needs ADAMS, as in the reference; the
    checkpointed adjoints are ported for both methods, and ADAMS records
    its forward for 'hermite' and 'polynomial' only, as the reference."""
    with pytest.raises(ValueError, match="requires method='ADAMS'"):
        make_batched_solve_fn(
            lv_problem(), derivatives="adjoint", method="BDF", adjoint_interpolation="transition"
        )
    for mode in ("hermite", "polynomial", "resolve"):
        solve = make_batched_solve_fn(
            lv_problem(), derivatives="adjoint", method="ADAMS", adjoint_interpolation=mode
        )
        assert solve.fwd_options.save_steps == (0 if mode == "resolve" else 1024)


# ---- options, and systems above the reference's size thresholds --------------
@pytest.mark.parametrize(
    "opts, sens_quad, first_step",
    [
        (dict(rtol=1e-7, atol=1e-9, use_ndf=True, max_order=3, max_step=0.5), False, 1e-4),
        (dict(rtol=np.array([1e-7, 1e-8]), atol=1e-9, constraints=np.array([2, 2]),
              sens_pbar=np.array([1.0, 0.3]), sens_err_con=False, quad_rtol=1e-6,
              quad_atol=1e-7, quad_err_con=True), True, None),
    ],
    ids=["ndf_order3_first_step", "vector_rtol_constraints_pbar_quad_tols"],
)
def test_lv_options_match_jax(opts, sens_quad, first_step):
    y0s, ps = _lv_inputs()
    B = y0s.shape[0]
    jkw, tkw = dict(first_step=first_step), dict(first_step=first_step)
    if sens_quad:
        jkw.update(sens_rhs=jax_lv_sens_rhs, S0=jnp.zeros((B, 2, 2)),
                   quad_rhs=jax_lv_quad_rhs, quad0=jnp.zeros((B, 1)))
        tkw.update(sens_rhs=lv_sens_rhs, S0=torch.zeros((B, 2, 2), dtype=torch.float64),
                   quad_rhs=lv_quad_rhs, quad0=torch.zeros((B, 1), dtype=torch.float64))
    jopts = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in opts.items()}
    jres = jax.jit(
        lambda y, p: jax_solve(
            jax_lv_rhs, jax_lv_jac, 0.0, y, p, jnp.asarray(TVALS), JaxOptions(**jopts), **jkw
        )
    )(jnp.asarray(y0s), jnp.asarray(ps))
    tres = bdf_solve_batched(
        lv_rhs, lv_jac, 0.0, torch.as_tensor(y0s), torch.as_tensor(ps),
        torch.as_tensor(TVALS), BDFOptions(**opts), **tkw,
    )
    np.testing.assert_array_equal(tres.status.numpy(), np.asarray(jres.status))
    assert (tres.status == 0).all()
    _assert_step_stats_close(jres, tres)
    assert int(tres.stats["final_order"].max()) <= opts.get("max_order", 5)
    # measured: ys 1.5e-12 / 2.4e-12, sens 1.5e-9, quad 2.6e-13 relative
    np.testing.assert_allclose(tres.ys.numpy(), np.asarray(jres.ys), rtol=1e-6, atol=1e-11)
    if sens_quad:
        np.testing.assert_allclose(tres.sens.numpy(), np.asarray(jres.sens), rtol=1e-6, atol=1e-11)
        np.testing.assert_allclose(tres.quad.numpy(), np.asarray(jres.quad), rtol=1e-6, atol=1e-11)


def _chain(n):
    """A reaction-diffusion chain of n cells, stiff through the diffusion:
    dx_i/dt = D (x_{i-1} - 2 x_i + x_{i+1}) - r x_i^2, fed x = 1 at the left."""

    def rhs(t, y, p):
        x = [1.0] + [y.x[i] for i in range(n)] + [0.0]
        return {"x": [p.D * (x[i] - 2 * x[i + 1] + x[i + 2]) - p.r * x[i + 1] ** 2
                      for i in range(n)]}

    kw = dict(params={"D": (), "r": ()}, states={"x": (n,)}, rhs_sympy=rhs,
              derivative_params=[("D",)])
    return JaxSympyProblem(**kw), SympyProblem(**kw)


@pytest.mark.parametrize("n", [6, 20])
def test_larger_systems_match_jax(n):
    """n > 4 refactors and refreshes the Jacobian only behind a host check,
    n > 16 also stops the Newton and sensitivity loops once every lane is
    done (the reference's size rules); with sensitivities to D."""
    jp, tp = _chain(n)
    B = 4
    rng = np.random.default_rng(n)
    y0s = rng.uniform(0.0, 0.5, (B, n))
    ps = np.array([40.0, 50.0]) * (1 + 0.1 * rng.standard_normal((B, 2)))
    tvals = np.array([0.1, 0.5, 2.0])
    opts = dict(rtol=1e-6, atol=1e-9)
    jres = jax.jit(
        lambda y, p: jax_solve(
            jp.make_rhs(), jp.make_jac_dense(), 0.0, y, p, jnp.asarray(tvals),
            JaxOptions(**opts), sens_rhs=jp.make_sensitivity_rhs(), S0=jnp.zeros((B, 1, n)),
        )
    )(jnp.asarray(y0s), jnp.asarray(ps))
    tres = bdf_solve_batched(
        tp.make_rhs(), tp.make_jac_dense(), 0.0, torch.as_tensor(y0s), torch.as_tensor(ps),
        torch.as_tensor(tvals), BDFOptions(**opts), sens_rhs=tp.make_sensitivity_rhs(),
        S0=torch.zeros((B, 1, n), dtype=torch.float64), batched_fns=True,
    )
    np.testing.assert_array_equal(tres.status.numpy(), np.asarray(jres.status))
    assert (tres.status == 0).all()
    _assert_step_stats_close(jres, tres)
    for stat in ("n_jac_evals", "n_factorizations", "n_newton_iters", "n_sens_rhs_evals"):
        np.testing.assert_allclose(
            tres.stats[stat].numpy(), np.asarray(jres.stats[stat]), rtol=0, atol=2, err_msg=stat
        )
    # measured: ys 7.5e-15 / 1.8e-14, sens 1.1e-13 / 8.2e-13 relative (n = 6 / 20);
    # every step statistic equal, one Jacobian refresh in every lane
    np.testing.assert_allclose(tres.ys.numpy(), np.asarray(jres.ys), rtol=1e-6, atol=1e-11)
    np.testing.assert_allclose(tres.sens.numpy(), np.asarray(jres.sens), rtol=1e-6, atol=1e-11)


def _reset_case(switch_rate):
    """A steep switch at t = 1 (an arithmetic sigmoid, so that both packages
    evaluate the right-hand side to the same bits) on 6 lanes."""

    def jax_rhs(t, y, p):
        x = p[1] * (t - 1.0)
        return jnp.array([-p[0] * (y[0] - x / (1.0 + jnp.abs(x))), y[0] - p[2] * y[1]])

    def rhs(t, y, p):
        x = p[1] * (t - 1.0)
        return torch.stack([-p[0] * (y[0] - x / (1.0 + torch.abs(x))), y[0] - p[2] * y[1]])

    def jac(t, y, p):
        zero = torch.zeros_like(p[0])
        return torch.stack([torch.stack([-p[0], zero]), torch.stack([zero + 1.0, -p[2]])])

    B = 6
    rng = np.random.default_rng(1)
    y0s = np.tile([-1.0, 0.0], (B, 1))
    ps = np.array([5.0, 3e3, 1.0]) * (1 + 0.2 * rng.uniform(size=(B, 3)))
    ps[:, 1] = switch_rate if switch_rate is not None else ps[:, 1]
    return jax_rhs, rhs, jac, y0s, ps


def _count_resets(monkeypatch):
    """Wrap the breakdown detector to count the lanes it resets."""
    import sunode_torch.ops.bdf_batched as core

    counted = []
    detect = core._breakdown_reset

    def counting(*args):
        reset = detect(*args)
        counted.append(int(reset.sum()))
        return reset

    monkeypatch.setattr(core, "_breakdown_reset", counting)
    return counted


def test_breakdown_reset_matches_jax(monkeypatch):
    """A steep switch at t = 1 makes lanes fail their error test four times
    running, which resets their history to order 1 (the breakdown detector),
    counted lane by lane; the same lanes with a flat switch never reset.  The
    right-hand side is arithmetic only: with ``tanh`` the two packages' own
    ``tanh`` differ in the last ulp (ROADMAP C2) and the switch magnifies it
    into different step sequences."""
    tvals = np.array([0.5, 1.5, 3.0])
    opts = dict(rtol=1e-8, atol=1e-10)
    jax_rhs, rhs, jac, y0s, ps = _reset_case(None)
    jres = jax.jit(
        lambda y, p: jax_solve(
            jax_rhs, jax.jacfwd(jax_rhs, argnums=1), 0.0, y, p, jnp.asarray(tvals),
            JaxOptions(**opts),
        )
    )(jnp.asarray(y0s), jnp.asarray(ps))
    resets = _count_resets(monkeypatch)
    tres = bdf_solve_batched(
        rhs, jac, 0.0, torch.as_tensor(y0s), torch.as_tensor(ps), torch.as_tensor(tvals),
        BDFOptions(**opts),
    )
    assert len(resets) == tres.stats["n_attempts"]
    assert sum(resets) > 0
    np.testing.assert_array_equal(tres.status.numpy(), np.asarray(jres.status))
    assert (tres.status == 0).all()
    # measured: every step statistic equal in every lane, ys 3.9e-10 relative
    for stat in ("n_steps", "n_error_test_fails", "n_conv_fails"):
        np.testing.assert_array_equal(tres.stats[stat].numpy(), np.asarray(jres.stats[stat]))
    np.testing.assert_allclose(tres.ys.numpy(), np.asarray(jres.ys), rtol=1e-9, atol=1e-11)

    # the same lanes with a flat switch fail their error test too, but never
    # four times running: the count above would fail here
    _, rhs, jac, y0s, ps = _reset_case(1e-3)
    resets.clear()
    flat = bdf_solve_batched(
        rhs, jac, 0.0, torch.as_tensor(y0s), torch.as_tensor(ps), torch.as_tensor(tvals),
        BDFOptions(**opts),
    )
    assert (flat.status == 0).all() and int(flat.stats["n_error_test_fails"].sum()) > 0
    assert len(resets) == flat.stats["n_attempts"] and sum(resets) == 0
