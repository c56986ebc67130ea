"""sunode_torch's single-instance BDF core against sunode_tpu's ``bdf_solve``.

Each case runs the same numpy inputs through the JAX package's
``bdf_solve`` (jitted) and the port's, and holds the port to the
reference: ys, sensitivities and quadratures within rtol 1e-6 / atol 1e-11
(``tests/test_torch_bdf_batched.py:91``), the step statistics within 2
(the reference's closed-form 2x2 and 3x3 solves and XLA's ``pow`` against
torch's LU and ``pow``, ROADMAP C1/C2, may move a marginal step).  The
difference-array helpers are checked on polynomials, as
``tests/test_bdf.py`` checks the reference's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_tpu.ops.bdf import bdf_solve as jax_bdf
from sunode_tpu.ops.sparsity import SparsePlan as JaxPlan
from sunode_tpu.ops.sparsity import make_colored_banded_jac as jax_colored
from sunode_tpu.problem import JaxProblem
from sunode_tpu.symode import SympyProblem as JaxSympyProblem
from sunode_torch.entry import _lv, _robertson, lv_problem, robertson_problem
from sunode_torch.ops import bdf as bdf_mod
from sunode_torch.ops.bdf import STATUS, BDFOptions, bdf_solve
from sunode_torch.ops.sparsity import SparsePlan, make_colored_banded_jac
from sunode_torch.problem import TorchProblem

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The single cores' tensors are a few values each: one CPU thread is
    faster than many; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
STEP_STATS = ("n_steps", "n_error_test_fails", "n_conv_fails", "n_newton_iters",
              "n_jac_evals", "n_factorizations")
LV_Y0 = np.array([10.0, 2.0])
LV_P = np.array([1.0, 0.3, 1.0, 0.4])
LV_TVALS = np.linspace(0.1, 10.0, 25)


def _jax_lv():
    return JaxSympyProblem(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()}, rhs_sympy=_lv,
        derivative_params=[("alpha",), ("beta",)],
    )


def _opts(cls, **kw):
    """Options of either package; array fields as jnp arrays for the
    reference, but for its static RCM permutation."""
    return cls(**{k: (jnp.asarray(v) if cls is JaxOptions and isinstance(v, np.ndarray)
                      and k != "sparse_perm" else v) for k, v in kw.items()})


def _run(jfns, tfns, y0, p, tvals, opts, **kw):
    """(reference result, port result) of one solve: ``jfns``/``tfns`` are
    ``(rhs, jac)`` of each package, ``kw`` the keyword arguments of both
    (arrays as numpy; functions as ``(jax_fn, torch_fn)`` pairs)."""
    jkw = {k: (v[0] if isinstance(v, tuple) else (jnp.asarray(v) if isinstance(v, np.ndarray)
                                                  else v)) for k, v in kw.items()}
    tkw = {k: (v[1] if isinstance(v, tuple) else (torch.as_tensor(v) if isinstance(v, np.ndarray)
                                                  else v)) for k, v in kw.items()}
    jres = jax.jit(lambda y, pp: jax_bdf(jfns[0], jfns[1], 0.0, y, pp, jnp.asarray(tvals),
                                         _opts(JaxOptions, **opts), **jkw))(
        jnp.asarray(y0), jnp.asarray(p))
    tres = bdf_solve(tfns[0], tfns[1], 0.0, torch.as_tensor(y0), torch.as_tensor(p),
                     torch.as_tensor(tvals), _opts(BDFOptions, **opts), **tkw)
    return jres, tres


def _check(jres, tres, stats=STEP_STATS, sens=False, quad=False):
    assert tres.status == int(jres.status)
    for name in ("ys",) + (("sens",) if sens else ()) + (("quad",) if quad else ()):
        np.testing.assert_allclose(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)),
                                   rtol=1e-6, atol=1e-11, err_msg=name)
    for k in stats:
        assert abs(tres.stats[k] - int(jres.stats[k])) <= 2, (k, tres.stats[k],
                                                                int(jres.stats[k]))


# ---- the difference-array helpers, on polynomials (tests/test_bdf.py) --------
def _differences(ts, poly):
    vals = [np.atleast_1d(poly(t)) for t in ts]
    D, rows = [vals[0]], vals
    for _ in range(1, len(ts)):
        rows = [rows[i] - rows[i + 1] for i in range(len(rows) - 1)]
        D.append(rows[0])
    return np.array(D)


def _full(D):
    out = torch.zeros((bdf_mod.KD, 1), dtype=torch.float64)
    out[: D.shape[0]] = torch.as_tensor(D)
    return out


def test_rescale_D_polynomial_exactness():
    q, h, r, t_n = 3, 0.1, 0.37, 1.0
    poly = lambda t: np.array([t**3 - 2 * t + 1.0])  # noqa: E731
    D_old = _differences([t_n - i * h for i in range(q + 1)], poly)
    expected = _differences([t_n - i * r * h for i in range(q + 1)], poly)
    out = bdf_mod._rescale_D(_full(D_old), q, r)
    np.testing.assert_allclose(out[: q + 1].numpy(), expected, rtol=1e-10, atol=1e-12)


def test_interpolate_polynomial_exactness():
    q, h, t_n = 4, 0.2, 2.0
    poly = lambda t: np.array([0.5 * t**4 - t**2 + 3.0])  # noqa: E731
    D = _full(_differences([t_n - i * h for i in range(q + 1)], poly))
    for te in [t_n, t_n - 0.5 * h, t_n - 1.7 * h, t_n - 3.2 * h]:
        np.testing.assert_allclose(bdf_mod._interpolate(D, q, t_n, h, te).numpy(), poly(te),
                                   rtol=1e-12)
        # the device-weights form the root scan uses
        got = bdf_mod._interpolate(D, q, t_n, h, torch.tensor([te], dtype=torch.float64))
        np.testing.assert_allclose(got[:, 0].numpy(), poly(te), rtol=1e-12)


def test_update_D_consistency():
    q, h, t_n = 2, 0.1, 1.0
    poly = lambda t: np.array([np.sin(t)])  # noqa: E731
    D_full = _full(_differences([t_n - h - i * h for i in range(q + 2)], poly))
    d = torch.as_tensor(poly(t_n)) - D_full[: q + 1].sum(0)
    D_new = bdf_mod._update_D(D_full, q, d)
    expected = _differences([t_n - i * h for i in range(q + 3)], poly)
    np.testing.assert_allclose(D_new[: q + 3].numpy(), expected, rtol=1e-9, atol=1e-12)


# ---- Lotka-Volterra and Robertson ------------------------------------------------
@pytest.fixture(scope="module")
def lv_fns():
    jp, tp = _jax_lv(), lv_problem()
    return (jp.make_rhs(), jp.make_jac_dense()), (tp.make_rhs(), tp.make_jac_dense())


@pytest.mark.parametrize("rtol", [1e-8, 1e-10])
def test_lv_matches_reference(lv_fns, rtol):
    jres, tres = _run(*lv_fns, LV_Y0, LV_P, LV_TVALS, dict(rtol=rtol, atol=rtol))
    _check(jres, tres, STEP_STATS + ("n_rhs_evals", "final_order"))
    assert tres.status == STATUS["SUCCESS"]


def test_robertson_matches_reference():
    jp = JaxSympyProblem(params={"k1": (), "k2": (), "k3": ()},
                         states={"a": (), "b": (), "c": ()}, rhs_sympy=_robertson,
                         derivative_params=[("k1",)])
    tp = robertson_problem()
    tvals = np.array([4.0 * 10.0**k for k in range(-1, 6)])
    jres, tres = _run((jp.make_rhs(), jp.make_jac_dense()), (tp.make_rhs(), tp.make_jac_dense()),
                      np.array([1.0, 0.0, 0.0]), np.array([0.04, 3e7, 1e4]), tvals,
                      dict(rtol=1e-8, atol=np.array([1e-10, 1e-12, 1e-10])))
    _check(jres, tres)
    np.testing.assert_allclose(tres.ys.numpy().sum(1), 1.0, rtol=1e-7)


def test_lv_forward_golden():
    """``tests/golden/lv_forward.npz``'s gate (``tests/test_golden.py:41``)
    on its lane 0 through the single BDF core at rtol 1e-10."""
    g = np.load(os.path.join(GOLDEN, "lv_forward.npz"))
    tp = lv_problem()
    for lane in (0,):
        res = bdf_solve(tp.make_rhs(), tp.make_jac_dense(), 0.0, torch.as_tensor(g["y0s"][lane]),
                        torch.as_tensor(g["ps"][lane]), torch.as_tensor(g["tvals"]),
                        BDFOptions(rtol=1e-10, atol=1e-10))
        assert res.status == 0
        np.testing.assert_allclose(res.ys.numpy(), g["ys"][lane], rtol=2e-7, atol=2e-9)


# ---- the recording ----------------------------------------------------------------
@pytest.mark.parametrize("save_steps,hermite_order,thinning", [(16, 5, True), (64, 3, False)])
def test_save_steps_recording_row_for_row(lv_fns, save_steps, hermite_order, thinning):
    """The ``saved`` dict row for row: t, y, f (and fd, L) up to n_saved, the
    row count, the overflow flag and the thinning levels; 16 slots of
    quintic rows compact the buffer several times, 64 cubic rows without
    thinning clamp and overflow."""
    opts = dict(rtol=1e-8, atol=1e-8, save_steps=save_steps, hermite_order=hermite_order,
                checkpoint_thinning=thinning)
    jres, tres = _run(*lv_fns, LV_Y0, LV_P, LV_TVALS, opts)
    _check(jres, tres)
    js, ts = jres.saved, tres.saved
    ns = int(js["n_saved"])
    assert ts["n_saved"] == ns and bool(ts["overflow"]) == bool(js["overflow"])
    assert tres.stats["checkpoint_thinning_levels"] == int(
        jres.stats["checkpoint_thinning_levels"])
    assert set(ts) == set(js)
    for k in ("t", "y"):
        np.testing.assert_allclose(ts[k].numpy()[:ns], np.asarray(js[k])[:ns], rtol=1e-6,
                                   atol=1e-11, err_msg=k)
    # f, fd and L are functions of the rows' y: a 1e-6 relative difference in
    # y moves f by up to 1e-6 of its own scale where f crosses zero, so these
    # rows are held to 1e-6 of their largest entry
    for k in ("f",) + (("fd", "L") if hermite_order == 5 else ()):
        ref = np.asarray(js[k])[:ns]
        np.testing.assert_allclose(ts[k].numpy()[:ns], ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max(), err_msg=k)
    f_own = lv_fns[1][0](ts["t"][:ns], ts["y"][:ns].T, torch.as_tensor(LV_P)[:, None]).T
    np.testing.assert_allclose(ts["f"][:ns].numpy(), f_own.numpy(), rtol=1e-14, atol=1e-14)
    if thinning:
        assert tres.stats["checkpoint_thinning_levels"] >= (1 if save_steps == 16 else 0)
        assert np.all(np.diff(ts["t"].numpy()[:ns]) > 0)
    else:
        assert ts["overflow"]


# ---- sensitivities, quadrature, constraints, first_step ---------------------------
def _quad_pair():
    def jq(t, y, p):
        return jnp.stack([y[0] * y[1], p[0] * y[0] ** 2])

    def tq(t, y, p):
        return torch.stack([y[0] * y[1], p[0] * y[0] ** 2])

    return jq, tq


@pytest.mark.parametrize("staggered", [False, True])
def test_sensitivities_and_quadrature(lv_fns, staggered):
    jp, tp = _jax_lv(), lv_problem()
    jq, tq = _quad_pair()
    opts = dict(rtol=1e-8, atol=1e-8, sens_staggered=staggered, quad_err_con=True)
    jres, tres = _run(*lv_fns, LV_Y0, LV_P, LV_TVALS, opts,
                      sens_rhs=(jp.make_sensitivity_rhs(), tp.make_sensitivity_rhs()),
                      S0=np.zeros((2, 2)), quad_rhs=(jq, tq), quad0=np.zeros(2))
    _check(jres, tres, STEP_STATS + ("n_sens_rhs_evals",), sens=True, quad=True)


def test_constraints_and_first_step(lv_fns):
    """LV with positivity constraints on both states and a first step (the
    options' is overridden by the argument, as in the reference)."""
    opts = dict(rtol=1e-8, atol=1e-8, constraints=np.array([2.0, 1.0]), first_step=1e-4)
    _check(*_run(*lv_fns, LV_Y0, LV_P, LV_TVALS, opts, first_step=np.float64(3e-3)))


def test_constraint_violation_fails_as_reference():
    """y' = -1 with y > 0 required: past t = 1 every step violates the
    constraint, and the solve fails with the reference's status and
    post-mortem."""
    jf = (lambda t, y, p: -jnp.ones_like(y), lambda t, y, p: jnp.zeros((1, 1)))
    tf = (lambda t, y, p: -torch.ones_like(y), lambda t, y, p: torch.zeros((1, 1),
                                                                            dtype=y.dtype))
    jres, tres = _run(jf, tf, np.array([1.0]), np.zeros(0), np.array([0.5, 2.0]),
                      dict(rtol=1e-6, atol=1e-8, constraints=np.array([2.0])))
    _check(jres, tres)
    assert tres.status != 0 and np.isnan(tres.ys.numpy()[1]).all()
    np.testing.assert_allclose(tres.stats["error_time"], float(jres.stats["error_time"]),
                               rtol=1e-9)
    assert tres.stats["error_worst_state"] == int(jres.stats["error_worst_state"])


# ---- failures --------------------------------------------------------------------
def test_blow_up_poisons_with_nan():
    """y' = y^2 from 1 blows up at t = 1: the outputs past it are NaN, with
    the reference's status and post-mortem."""
    jf = (lambda t, y, p: y * y, lambda t, y, p: (2 * y)[None, :])
    tf = (lambda t, y, p: y * y, lambda t, y, p: (2 * y)[None, :])
    jres, tres = _run(jf, tf, np.array([1.0]), np.zeros(0), np.array([0.5, 0.9, 2.0]),
                      dict(rtol=1e-8, atol=1e-8, max_steps=3000))
    _check(jres, tres)
    assert tres.status != 0 and np.isnan(tres.ys.numpy()[2, 0])
    np.testing.assert_allclose(tres.ys.numpy()[0, 0], 2.0, rtol=1e-6)
    for k in ("error_time", "error_step_size"):
        np.testing.assert_allclose(tres.stats[k], float(jres.stats[k]), rtol=1e-6)
    assert tres.stats["error_order"] == int(jres.stats["error_order"])


def test_max_steps_status(lv_fns):
    jres, tres = _run(*lv_fns, LV_Y0, LV_P, LV_TVALS, dict(max_steps=5))
    _check(jres, tres)
    assert tres.status == STATUS["MAX_STEPS"]
    assert np.isnan(tres.ys.numpy()[-1]).all()
    np.testing.assert_allclose(tres.stats["final_state"].numpy()[:2],
                               np.asarray(jres.stats["final_state"])[:2], rtol=1e-10)


# ---- rootfinding ------------------------------------------------------------------
@pytest.mark.parametrize("terminal", [True, False])
def test_roots(lv_fns, terminal):
    def jg(t, y, p):
        return jnp.stack([y[0] - 9.0, y[1] - 3.0])

    def tg(t, y, p):
        return torch.stack([y[0] - 9.0, y[1] - 3.0])

    jres, tres = _run(*lv_fns, LV_Y0, LV_P, LV_TVALS, dict(rtol=1e-8, atol=1e-8),
                      root_fn=(jg, tg), root_cap=4, root_terminal=terminal)
    _check(jres, tres)
    assert tres.stats["n_roots"] == int(jres.stats["n_roots"]) >= 1
    np.testing.assert_allclose(tres.stats["roots_t"].numpy(), np.asarray(jres.stats["roots_t"]),
                               rtol=1e-10)
    np.testing.assert_array_equal(tres.stats["roots_found"].numpy(),
                                  np.asarray(jres.stats["roots_found"]))
    np.testing.assert_allclose(tres.stats["roots_y"].numpy(), np.asarray(jres.stats["roots_y"]),
                               rtol=1e-8, atol=1e-10)
    if terminal:
        assert tres.status == STATUS["ROOT_RETURN"]


# ---- structured Newton: the hub (BBD) and the Fisher-KPP chain ---------------------
def _hub_rhs(xp, cat):
    def rhs(t, y, p):
        u = y.u
        zero = xp.zeros(1, dtype=u.dtype)
        lap = cat([u[1:2] - u[0:1], u[2:] - u[1:-1], u[-2:-1] - u[-1:]])
        lap2 = cat([zero, u[:-2] - u[1:-1], zero])
        return {"u": p.D * (lap + lap2) - u * (u - 1.0) + p.c * y.h,
                "h": -p.a * y.h + p.b * xp.mean(u)}

    return rhs


def _kpp_rhs(xp, cat):
    def rhs(t, y, p):
        u = y.u
        zero = xp.zeros(1, dtype=u.dtype)
        lap = cat([u[1:2] - u[0:1], u[2:] - u[1:-1], u[-2:-1] - u[-1:]])
        lap2 = cat([zero, u[:-2] - u[1:-1], zero])
        return {"u": p.D * (lap + lap2) + p.r * u * (1.0 - u)}

    return rhs


def _structured(kind, n):
    """(reference problem, port problem, y0, p, tvals): ``tests/test_bbd.py``'s
    hub at n (seed 2), or the Fisher-KPP chain (``tests/
    test_batched_structured.py``'s inputs, seed 0)."""
    rng = np.random.default_rng(2 if kind == "hub" else 0)
    if kind == "hub":
        spec = dict(params={"D": (), "a": (), "b": (), "c": ()}, states={"u": (n,), "h": ()},
                    derivative_params=[("D",), ("b",)])
        y0 = np.concatenate([0.4 + 0.3 * rng.random(n), 0.1 * rng.random(1)])
        p = np.array([40.0 * (1 + 0.2 * rng.random()), 30.0 * (1 + 0.1 * rng.random()),
                      2.0 + 0.2 * rng.random(), 0.5 + 0.1 * rng.random()])
        rhs = _hub_rhs
    else:
        spec = dict(params={"D": (), "r": ()}, states={"u": (n,)},
                    derivative_params=[("D",), ("r",)])
        y0 = 0.5 + 0.3 * rng.random(n)
        p = np.array([50.0 * (1 + 0.2 * rng.random()), 1.0 + 0.1 * rng.random()])
        rhs = _kpp_rhs
    return (JaxProblem(rhs=rhs(jnp, jnp.concatenate), **spec),
            TorchProblem(rhs=rhs(torch, torch.cat), **spec), y0, p, np.linspace(0.05, 1.0, 6))


@pytest.mark.parametrize("kind,n,solver", [
    ("hub", 12, "sparse"), ("hub", 12, "spgmr"), ("kpp", 10, "band"),
])
def test_structured_newton(kind, n, solver):
    """Band on the KPP chain, sparse with the BBD border and spgmr on the
    hub, over its first three observation times (the plain banded LU loops
    over columns on the CPU; spgmr at rtol 1e-6: every Krylov vector is a
    jvp of the torch right-hand side)."""
    jp, tp, y0, p, tvals = _structured(kind, n)
    opts = dict(rtol=1e-8, atol=1e-10, linear_solver=solver)
    if kind == "hub":
        tvals = tvals[:3]
    if solver == "spgmr":
        opts.update(rtol=1e-6, atol=1e-8)
    jfns, tfns = (jp.make_rhs(), None), (tp.make_rhs(), None)
    if solver == "band":
        opts.update(band_lower=1, band_upper=1)
        jfns, tfns = (jp.make_rhs(), jp.make_banded_jac(1, 1)), (tp.make_rhs(),
                                                                 tp.make_banded_jac(1, 1))
    elif solver == "sparse":
        jplan, tplan = JaxPlan(jp.jac_sparsity()), SparsePlan(tp.jac_sparsity())
        np.testing.assert_array_equal(tplan.perm, jplan.perm)
        assert (tplan.k_border >= 1) == (kind == "hub")
        opts.update(band_lower=tplan.lower, band_upper=tplan.upper, sparse_perm=tplan.perm,
                    sparse_border=tplan.k_border)
        jfns = (jp.make_rhs(), jax_colored(jp.make_rhs(), jplan))
        tfns = (tp.make_rhs(), make_colored_banded_jac(tp.make_rhs(), tplan))
    jres, tres = _run(jfns, tfns, y0, p, tvals, opts)
    _check(jres, tres)
    assert tres.status == 0
    if solver != "spgmr":
        # every factorization and solve of the Newton matrix is one call
        assert tres.stats["n_linear_factors"] == tres.stats["n_factorizations"] + 1
        assert tres.stats["n_linear_solves"] >= tres.stats["n_newton_iters"]


def test_unknown_linear_solver_raises():
    tp = lv_problem()
    with pytest.raises(ValueError, match="linear_solver"):
        bdf_solve(tp.make_rhs(), tp.make_jac_dense(), 0.0, torch.as_tensor(LV_Y0),
                  torch.as_tensor(LV_P), torch.as_tensor(LV_TVALS),
                  BDFOptions(linear_solver="klu"))
