"""sunode_torch's single-chain functional surface against sunode_tpu's.

``make_solve_fn`` (the checkpointed adjoint with 'hermite' and
'polynomial' interpolation, and forward sensitivities), ``solve_ivp`` and
the per-lane route (a loop over lanes of ``make_solve_fn``, the port's
counterpart of the reference's ``vmap``) give the gradients of
``jax.grad`` of the reference's within rtol 1e-6; the evaluators over a
recorded trajectory are exact on their polynomial classes
(``tests/test_interpolants.py``) and equal the port's batched ones at one
lane.  Each test builds only the references it reads (cached in the
process), so a test worker compiles no reference twice and none it does
not need.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_tpu.symode import SympyProblem as JaxSympyProblem
from sunode_tpu.wrappers.as_jax import make_solve_fn as jax_make_solve_fn
from sunode_tpu.wrappers.as_jax import solve_ivp as jax_solve_ivp
from sunode_torch import make_solve_fn, solve_ivp, solve_lanes
from sunode_torch.adjoint import (
    _quintic_basis,
    adjoint_backward,
    make_hermite_eval,
    make_hermite_eval_batched,
    make_polynomial_eval,
    make_polynomial_eval_batched,
)
from sunode_torch.entry import _lv, build_kpp_single, build_lv_single, hub_problem, lv_problem
from sunode_torch.ops.bdf import BDFOptions
from sunode_torch.wrappers.as_torch import make_batched_solve_fn

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The single cores' tensors are a few values each: one CPU thread is
    faster than many; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

Y0 = np.array([10.0, 2.0])
P_SUB = np.array([1.0, 0.3])  # alpha, beta
P_FIX = np.array([1.0, 0.4])  # gamma, delta
TVALS = np.linspace(1.0, 8.0, 6)
F64 = dict(dtype=torch.float64)


def _jax_lv():
    return JaxSympyProblem(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()}, rhs_sympy=_lv,
        derivative_params=[("alpha",), ("beta",)],
    )


def _loss_np(ys, xp):
    """``tests/test_adjoint.py``'s loss: every state and time counts."""
    return xp.sum(ys**2) + xp.sum(ys[:, 0] * 0.5)


# ---- the evaluators (tests/test_interpolants.py) ---------------------------------
def _poly_traj(ts, coeffs):
    poly = np.polynomial.Polynomial(coeffs)
    return poly(ts), poly.deriv(1)(ts), poly.deriv(2)(ts)


def _saved(ts, y, f, fd=None, n_pad=4):
    S = len(ts) + n_pad
    t_buf = np.full(S, np.inf)
    t_buf[: len(ts)] = ts
    pad = lambda a: torch.as_tensor(np.pad(a[:, None], ((0, n_pad), (0, 0))))  # noqa: E731
    out = {"t": torch.as_tensor(t_buf), "y": pad(y), "f": pad(f), "n_saved": len(ts),
           "overflow": False}
    if fd is not None:
        out["fd"] = pad(fd)
    return out


def _both_paths(y_at, t):
    """The host-time and the device-time evaluations of one time, checked
    equal; returns the value."""
    host = float(y_at(float(t))[0])
    dev = float(y_at(torch.tensor(t, **F64))[0])
    np.testing.assert_allclose(host, dev, rtol=1e-13, atol=1e-13)
    return host


def test_quintic_basis_degree5_exact():
    rng = np.random.default_rng(0)
    poly = np.polynomial.Polynomial(rng.standard_normal(6))
    d1, d2 = poly.deriv(1), poly.deriv(2)
    t0, t1 = 0.3, 1.1
    h = t1 - t0
    for t in np.linspace(t0, t1, 9):
        H = _quintic_basis(torch.tensor((t - t0) / h, **F64))
        val = (H[0] * poly(t0) + H[1] * h * d1(t0) + H[2] * h * h * d2(t0)
               + H[3] * poly(t1) + H[4] * h * d1(t1) + H[5] * h * h * d2(t1))
        assert abs(float(val) - poly(t)) < 1e-12


@pytest.mark.parametrize("case", ["quintic", "cubic", "polynomial", "polynomial_few_rows"])
def test_evaluators_exact(case):
    rng = np.random.default_rng({"quintic": 1, "cubic": 2, "polynomial": 3,
                                 "polynomial_few_rows": 4}[case])
    deg, rows, pad = {"quintic": (6, 7, 4), "cubic": (4, 6, 4), "polynomial": (6, 9, 4),
                      "polynomial_few_rows": (3, 4, 6)}[case]
    c = rng.standard_normal(deg)
    ts = np.sort(rng.uniform(0, 3, rows))
    y, f, fd = _poly_traj(ts, c)
    saved = _saved(ts, y, f, fd if case == "quintic" else None, n_pad=pad)
    y_at = (make_hermite_eval if case in ("quintic", "cubic") else make_polynomial_eval)(saved)
    poly = np.polynomial.Polynomial(c)
    bound = {"quintic": 1e-10, "cubic": 1e-11, "polynomial": 1e-9,
             "polynomial_few_rows": 1e-10}[case]
    for t in np.linspace(ts[0], ts[-1], 25):
        assert abs(_both_paths(y_at, t) - poly(t)) < bound * (1 + abs(poly(t))), t
    if case == "polynomial":
        for k in range(len(ts)):  # exact node hits return the stored samples
            assert abs(_both_paths(y_at, ts[k]) - y[k]) < 1e-12
    # a vector of times evaluates every one at once
    tq = np.linspace(ts[0], ts[-1], 5)
    np.testing.assert_allclose(y_at(torch.as_tensor(tq))[:, 0].numpy(), poly(tq),
                               rtol=bound * 10, atol=bound * 10)


def test_quintic_stiffness_gate_switches():
    rng = np.random.default_rng(7)
    c = rng.standard_normal(6)
    ts = np.sort(rng.uniform(0, 3, 8))
    y, f, fd = _poly_traj(ts, c)
    poly = np.polynomial.Polynomial(c)

    def with_L(L_val, fd_rows):
        saved = _saved(ts, y, f, fd_rows)
        Ls = np.zeros(len(saved["t"]))
        Ls[: len(ts)] = L_val
        saved["L"] = torch.as_tensor(Ls)
        return make_hermite_eval(saved)

    cubic = make_hermite_eval(_saved(ts, y, f))
    for t in np.linspace(ts[0] + 1e-6, ts[-1] - 1e-6, 9):
        assert abs(_both_paths(with_L(1e-9, fd), t) - poly(t)) < 1e-10 * (1 + abs(poly(t)))
        np.testing.assert_allclose(_both_paths(with_L(1e12, fd + 1e6), t),
                                   _both_paths(cubic, t), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", ["hermite", "polynomial"])
def test_single_evaluators_match_batched(mode):
    rng = np.random.default_rng(5)
    ts = np.sort(rng.uniform(0, 3, 8))
    y, f, fd = _poly_traj(ts, rng.standard_normal(6))
    saved = _saved(ts, y, f, fd)
    saved_b = {"t": saved["t"][:, None], "n_saved": torch.tensor([len(ts)]),
               "yf": torch.cat([saved["y"], saved["f"], saved["fd"]], dim=1)[:, :, None],
               "fd": saved["fd"][:, :, None]}
    single, batched = ((make_hermite_eval(saved), make_hermite_eval_batched(saved_b))
                       if mode == "hermite" else
                       (make_polynomial_eval(saved), make_polynomial_eval_batched(saved_b)))
    for t in np.linspace(ts[0], ts[-1], 13):
        b = batched(torch.tensor([t], **F64))[0, 0].item()
        np.testing.assert_allclose(_both_paths(single, t), b, rtol=1e-12, atol=1e-12)


# ---- make_solve_fn against jax.grad -------------------------------------------------
MODES = [("adjoint", "hermite"), ("adjoint", "polynomial"), ("forward", "hermite")]


@functools.cache
def _reference(mode):
    """``jax.value_and_grad`` of the reference's make_solve_fn in ``mode``,
    with respect to (t0, y0, p_sub, tvals): each mode built once a process
    (a worker builds only the modes of the tests it runs)."""
    derivatives, interp = mode
    solve = jax_make_solve_fn(_jax_lv(), derivatives=derivatives,
                              options=JaxOptions(rtol=1e-10, atol=1e-10),
                              adjoint_options=JaxOptions(rtol=1e-8, atol=1e-8),
                              adjoint_interpolation=interp)

    def loss(t0, y0, p, tv):
        return _loss_np(solve(t0, y0, p, jnp.asarray(P_FIX), tv), jnp)

    val, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3)))(
        0.0, jnp.asarray(Y0), jnp.asarray(P_SUB), jnp.asarray(TVALS))
    return float(val), [np.asarray(g) for g in grads]


@functools.cache
def _port(mode):
    """The port's loss and gradients with respect to (t0, y0, p_sub, tvals,
    p_fix), and the solve's stats."""
    derivatives, interp = mode
    solve = make_solve_fn(lv_problem(), derivatives=derivatives,
                          options=BDFOptions(rtol=1e-10, atol=1e-10),
                          adjoint_options=BDFOptions(rtol=1e-8, atol=1e-8),
                          adjoint_interpolation=interp)
    args = [torch.tensor(0.0, **F64, requires_grad=True)] + [
        torch.tensor(a, requires_grad=True) for a in (Y0, P_SUB, TVALS, P_FIX)]
    loss = _loss_np(solve(args[0], args[1], args[2], args[4], args[3]), torch)
    grads = torch.autograd.grad(loss, args)
    return float(loss), [g.numpy() for g in grads], solve.last_stats


@pytest.mark.parametrize("mode", MODES, ids=["hermite", "polynomial", "forward"])
def test_make_solve_fn_gradients_match_jax(mode):
    """d/dt0, d/dy0, d/dp and d/dtvals within 1e-6 of jax.grad; p_fix's
    cotangent is zero."""
    ref_val, ref = _reference(mode)
    val, got, stats = _port(mode)
    np.testing.assert_allclose(val, ref_val, rtol=1e-9)
    for name, g, r in zip(("t0", "y0", "p_sub", "tvals"), got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-10, err_msg=name)
    np.testing.assert_array_equal(got[4], np.zeros(2))
    if mode[0] == "adjoint":
        assert stats["backward"]["status"] == 0 and stats["backward"]["n_attempts"] > 0


def test_forward_against_adjoint():
    """d/dy0 and d/dp by forward sensitivities and by the adjoint agree to
    1e-5 (``tests/test_adjoint.py:107``)."""
    _, fwd, _ = _port(("forward", "hermite"))
    _, adj, _ = _port(("adjoint", "hermite"))
    for g, r in zip(fwd[1:3], adj[1:3]):
        np.testing.assert_allclose(g, r, rtol=1e-5)


@pytest.mark.parametrize("derivatives", ["adjoint", "forward"])
def test_failure_poisons_gradient(derivatives):
    solve = make_solve_fn(lv_problem(), derivatives=derivatives,
                          options=BDFOptions(rtol=1e-10, atol=1e-10, max_steps=5))
    p = torch.tensor(P_SUB, requires_grad=True)
    ys = solve(0.0, torch.tensor(Y0), p, torch.tensor(P_FIX), torch.tensor(TVALS))
    assert torch.isnan(ys[-1]).all()
    (g,) = torch.autograd.grad(torch.sum(ys), p)
    assert torch.isnan(g).all()


def test_primal_without_gradients_records_nothing():
    solve = make_solve_fn(lv_problem(), options=BDFOptions(rtol=1e-8, atol=1e-8))
    ys = solve(0.0, torch.tensor(Y0), torch.tensor(P_SUB), torch.tensor(P_FIX),
               torch.tensor(TVALS))
    assert ys.shape == (6, 2) and not ys.requires_grad
    assert "checkpoint_thinning_levels" not in solve.last_stats["forward"]


def test_overflowed_recording_poisons():
    """``adjoint_backward`` on a recording that overflowed: lambda and q NaN,
    status 99, as the reference's contract."""
    from sunode_torch.ops.bdf import bdf_solve

    tp = lv_problem()
    p_full = torch.as_tensor(np.concatenate([P_SUB, P_FIX]))
    fwd = bdf_solve(tp.make_rhs(), tp.make_jac_dense(), 0.0, torch.as_tensor(Y0), p_full,
                    torch.as_tensor(TVALS),
                    BDFOptions(rtol=1e-6, atol=1e-6, save_steps=8, checkpoint_thinning=False))
    assert fwd.saved["overflow"]
    bad = adjoint_backward(tp.make_adjoint_rhs(), tp.make_adjoint_jac_dense(),
                           tp.make_adjoint_quad_rhs(), fwd.saved, 0.0, torch.as_tensor(TVALS),
                           torch.ones((6, 2), **F64), p_full, 2,
                           BDFOptions(rtol=1e-6, atol=1e-6))
    assert bad.status == 99 and torch.isnan(bad.lamda).all() and torch.isnan(bad.quad).all()


def test_sparse_bbd_gradient_matches_dense():
    """``tests/test_bbd.py:290``: the hub problem through make_solve_fn with
    sparse (bordered) Newton in both directions gives the dense gradients."""
    from sunode_torch.entry import hub_inputs

    y0, p_sub, tvals = hub_inputs(12, 1)
    tvals = tvals[:2]
    grads = {}
    for ls in ("dense", "sparse"):
        solve = make_solve_fn(hub_problem(12), options=BDFOptions(rtol=1e-8, atol=1e-10),
                              adjoint_options=BDFOptions(rtol=1e-8, atol=1e-10),
                              linear_solver=ls)
        p = torch.tensor(p_sub[0], requires_grad=True)
        ys = solve(0.0, torch.as_tensor(y0[0]), p, torch.tensor([30.0, 0.5]),
                   torch.as_tensor(tvals))
        (grads[ls],) = torch.autograd.grad(torch.sum(ys**2), p)
        if ls == "sparse":
            st = solve.last_stats
            assert st["forward"]["n_linear_factors"] > 0 and st["backward"]["n_linear_solves"] > 0
    assert torch.isfinite(grads["sparse"]).all()
    np.testing.assert_allclose(grads["sparse"].numpy(), grads["dense"].numpy(), rtol=1e-4,
                               atol=1e-8)


def test_entry_builders_on_the_cpu():
    """``build_lv_single``'s chains are lv_adjoint.npz's lanes and its
    gradient is ``make_solve_fn``'s (here at rtol 1e-6 both ways, the card's
    phase gates its defaults at the golden file's tolerance), and
    ``build_kpp_single``'s banded forward runs, with device='cpu'."""
    import os

    golden = np.load(os.path.join(os.path.dirname(__file__), "golden", "lv_adjoint.npz"))
    step, (y0s, p_subs) = build_lv_single(2, device="cpu")
    np.testing.assert_array_equal(y0s.numpy(), golden["y0s"][:2])
    np.testing.assert_array_equal(p_subs.numpy(), golden["p_subs"][:2])
    assert step.tvals.shape == (21,) and step.solve.options.rtol == 1e-8
    opts = BDFOptions(rtol=1e-6, atol=1e-6)
    solve = make_solve_fn(lv_problem(), options=opts, adjoint_options=opts)
    y0, p = y0s[0].clone().requires_grad_(True), p_subs[0].clone().requires_grad_(True)
    ys = solve(0.0, y0, p, step.p_fix, step.tvals[:3])
    gy, gp = torch.autograd.grad(torch.sum(ys**2), (y0, p))
    assert torch.isfinite(gy).all() and torch.isfinite(gp).all()
    forward, _, (y0, p, tvals) = build_kpp_single(4, "band", device="cpu")
    ys = forward(y0, p)
    assert ys.shape == (len(tvals), 4) and torch.isfinite(ys).all()
    assert forward.solve.last_stats["forward"]["n_linear_factors"] > 0


# ---- solve_ivp ------------------------------------------------------------------------
def _ivp_kwargs(alpha, opts=BDFOptions):
    """``tests/test_adjoint.py:149``'s call at rtol 1e-7 both ways; ``opts``
    the options class of the package called."""
    return dict(t0=0.0, y0={"hares": (10.0, ()), "lynx": (2.0, ())},
                params={"alpha": alpha, "beta": (0.3, ()), "gamma": np.array(1.0),
                        "delta": np.array(0.4)},
                tvals=np.linspace(1.0, 8.0, 5), rhs=_lv,
                solver_kwargs=dict(rtol=1e-7, atol=1e-7, adjoint_options=opts(rtol=1e-7, atol=1e-7)))


def test_solve_ivp_matches_reference():
    """The README's one-call API with ``torch.autograd``, against ``jax.grad``
    of the reference's: alpha given as a tensor that requires a gradient is
    detected as the derivative parameter; with ``use_sympy=False`` the same
    right-hand side runs as a TorchProblem."""
    def run(alpha):
        res = jax_solve_ivp(**_ivp_kwargs((alpha, ()), JaxOptions),
                            derivative_params=[("alpha",)])
        return jnp.sum(res.solution["hares"] ** 2)

    ref = float(jax.jit(jax.grad(run))(jnp.asarray(1.0)))
    for use_sympy in (True, False):
        alpha = torch.tensor(1.0, **F64, requires_grad=True)
        res = solve_ivp(**_ivp_kwargs(alpha), use_sympy=use_sympy, device="cpu")
        assert res.problem.params.subset_paths == [("alpha",)]
        assert res.ys.shape == (5, 2) and res.solution["hares"].shape == (5,)
        (g,) = torch.autograd.grad(torch.sum(res.solution["hares"] ** 2), alpha)
        np.testing.assert_allclose(float(g), ref, rtol=1e-6, err_msg=f"use_sympy={use_sympy}")


def test_solve_ivp_checks():
    with pytest.raises(TypeError, match="Unknown solver_kwargs"):
        solve_ivp(**dict(_ivp_kwargs((1.0, ())), solver_kwargs=dict(foo=1)), device="cpu")
    leaf = torch.tensor(1.0, **F64)
    with pytest.raises(ValueError, match="tensor leaf"):
        solve_ivp(**_ivp_kwargs(leaf), device="meta")


# ---- per-lane grids with gradients: a loop over lanes ---------------------------------
def _lane_inputs():
    rng = np.random.default_rng(1)
    y0 = Y0 * (1 + 0.05 * rng.standard_normal((3, 2)))
    p = P_SUB * (1 + 0.05 * rng.standard_normal((3, 2)))
    tv = np.sort(rng.uniform(0.5, 8.0, (3, 5)), axis=1)
    return y0, p, tv


def test_per_lane_route_matches_reference_vmap():
    """Per-lane (B, n_t) grids with gradients at B=3: ``solve_lanes`` over
    ``make_solve_fn`` against the reference's ``jax.vmap(make_solve_fn)``
    gradients (d/dy0, d/dp, d/dtvals)."""
    y0, p, tv = _lane_inputs()
    jsolve = jax_make_solve_fn(_jax_lv(), options=JaxOptions(rtol=1e-6, atol=1e-6),
                               adjoint_options=JaxOptions(rtol=1e-6, atol=1e-6))

    def jloss(y, pp, tt):
        ys = jax.vmap(lambda a, b, c: jsolve(0.0, a, b, jnp.asarray(P_FIX), c))(y, pp, tt)
        return jnp.sum(ys**2)

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jnp.asarray(y0), jnp.asarray(p),
                                                      jnp.asarray(tv))
    solve = make_solve_fn(lv_problem(), options=BDFOptions(rtol=1e-6, atol=1e-6),
                          adjoint_options=BDFOptions(rtol=1e-6, atol=1e-6))
    args = [torch.tensor(a, requires_grad=True) for a in (y0, p, tv)]
    ys = solve_lanes(solve, 0.0, args[0], args[1], torch.tensor(P_FIX), args[2])
    assert ys.shape == (3, 5, 2)
    got = torch.autograd.grad(torch.sum(ys**2), args)
    for name, g, r in zip(("y0", "p", "tvals"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-10,
                                   err_msg=name)


def test_batched_refusal_names_the_lane_loop():
    y0, p, tv = _lane_inputs()
    solve = make_batched_solve_fn(lv_problem())
    with pytest.raises(NotImplementedError, match="solve_lanes"):
        solve(0.0, torch.tensor(y0), torch.tensor(p, requires_grad=True), torch.tensor(P_FIX),
              torch.tensor(tv))
