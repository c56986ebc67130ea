"""sunode_torch's single-instance Adams core against sunode_tpu's ``adams_solve``.

The cases of ``tests/test_adams.py`` with a reference to compare: the same
numpy inputs through the JAX package's ``adams_solve`` (jitted) and the
port's, ys within rtol 1e-6 / atol 1e-11 and the step statistics within 2
(the libraries' ``pow``, ROADMAP C1, may move a marginal step).  The
quadrature branch runs both packages' batched cores at one lane, as the
reference routes it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunode_tpu.ops.adams import adams_solve as jax_adams
from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_tpu.symode import SympyProblem as JaxSympyProblem
from sunode_torch.entry import _lv, lv_problem
from sunode_torch.ops import adams as adams_mod
from sunode_torch.ops.adams import ADAMS_MAX_ORDER, KA, adams_options, adams_solve
from sunode_torch.ops.bdf import STATUS, BDFOptions

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The single cores' tensors are a few values each: one CPU thread is
    faster than many; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

STEP_STATS = ("n_steps", "n_error_test_fails", "n_conv_fails", "n_newton_iters", "n_rhs_evals")
LV_Y0 = np.array([10.0, 2.0])
LV_P = np.array([1.0, 0.3, 1.0, 0.4])


@pytest.fixture(scope="module")
def lv_rhs():
    jp = JaxSympyProblem(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()}, rhs_sympy=_lv,
        derivative_params=[("alpha",), ("beta",)],
    )
    return jp.make_rhs(), lv_problem().make_rhs()


def _run(rhs_pair, y0, p, tvals, opts, **kw):
    jkw = {k: (v[0] if isinstance(v, tuple) else (jnp.asarray(v) if isinstance(v, np.ndarray)
                                                  else v)) for k, v in kw.items()}
    tkw = {k: (v[1] if isinstance(v, tuple) else (torch.as_tensor(v) if isinstance(v, np.ndarray)
                                                  else v)) for k, v in kw.items()}
    jres = jax.jit(lambda y, pp: jax_adams(rhs_pair[0], 0.0, y, pp, jnp.asarray(tvals),
                                           JaxOptions(**opts), **jkw))(
        jnp.asarray(y0), jnp.asarray(p))
    tres = adams_solve(rhs_pair[1], 0.0, torch.as_tensor(y0), torch.as_tensor(p),
                       torch.as_tensor(tvals), BDFOptions(**opts), **tkw)
    return jres, tres


def _check(jres, tres, stats=STEP_STATS, quad=False):
    assert tres.status == int(jres.status)
    np.testing.assert_allclose(tres.ys.numpy(), np.asarray(jres.ys), rtol=1e-6, atol=1e-11)
    if quad:
        np.testing.assert_allclose(tres.quad.numpy(), np.asarray(jres.quad), rtol=1e-6,
                                   atol=1e-11)
    for k in stats:
        assert abs(int(tres.stats[k]) - int(jres.stats[k])) <= 2, (k, tres.stats[k],
                                                                     int(jres.stats[k]))


def test_tables():
    np.testing.assert_allclose(adams_mod._GAMMA[:5], [1, 1 / 2, 5 / 12, 3 / 8, 251 / 720],
                               rtol=1e-14)
    assert KA == ADAMS_MAX_ORDER + 3
    opts = BDFOptions(adams_max_order=10)
    assert adams_options(opts) is opts


@pytest.mark.parametrize("max_order", [12])
def test_lv_orders(lv_rhs, max_order):
    """LV at rtol 1e-10 with the order cap at 12, the highest; the order
    climbs as in the reference."""
    tvals = np.linspace(1.0, 25.0, 5)
    jres, tres = _run(lv_rhs, LV_Y0, LV_P, tvals,
                      dict(rtol=1e-10, atol=1e-10, adams_max_order=max_order))
    _check(jres, tres, STEP_STATS + ("final_order",))
    assert tres.status == 0 and tres.stats["final_order"] >= 4


def test_exponential_decay_and_step_history():
    """y' = -1.3 y at rtol 1e-10: the exact decay, and the reference's
    step statistics."""
    pair = (lambda t, y, p: -p[0] * y, lambda t, y, p: -p[0] * y)
    tvals = np.linspace(0.5, 5.0, 10)
    jres, tres = _run(pair, np.array([1.0]), np.array([1.3]), tvals,
                      dict(rtol=1e-10, atol=1e-12))
    _check(jres, tres)
    np.testing.assert_allclose(tres.ys.numpy()[:, 0], np.exp(-1.3 * tvals), rtol=1e-8)


def test_interp_exact_for_low_order_poly():
    """f(t) = 3 t^2: the dense output integrates the f-interpolant exactly,
    y = t^3 (tests/test_adams.py), and ``_interp_y`` itself is exact on a
    history of a quadratic f at every order that holds it."""
    pair = (lambda t, y, p: jnp.stack([3 * t * t]), lambda t, y, p: torch.stack([3 * t * t]))
    jres, tres = _run(pair, np.array([0.0]), np.zeros(0), np.array([0.77, 1.9]),
                      dict(rtol=1e-10, atol=1e-12))
    _check(jres, tres)
    np.testing.assert_allclose(tres.ys.numpy()[:, 0], np.array([0.77, 1.9]) ** 3, rtol=1e-9)

    # backward differences of f = 3 t^2 at t_n, t_n - h, ...: y(t_n + s h)
    # from y(t_n) = t_n^3 is (t_n + s h)^3, from the host and device weights
    t_n, h = 1.3, 0.1
    f = [3 * (t_n - i * h) ** 2 for i in range(4)]
    DF = torch.zeros((KA, 1), dtype=torch.float64)
    DF[0, 0], DF[1, 0], DF[2, 0] = f[0], f[0] - f[1], f[0] - 2 * f[1] + f[2]
    y_n = torch.tensor([t_n**3], dtype=torch.float64)
    for p in (2, 3, 5):
        for s in (-1.0, -0.4, 0.0):
            want = (t_n + s * h) ** 3
            got = adams_mod._interp_y(y_n, DF, p, h, np.float64(s))
            np.testing.assert_allclose(got.numpy(), [want], rtol=1e-12)
            got = adams_mod._interp_y(y_n, DF, p, h, torch.tensor([s], dtype=torch.float64))
            np.testing.assert_allclose(got[:, 0].numpy(), [want], rtol=1e-12)


def test_update_DF_matches_reference():
    """The post-acceptance difference update, on random histories at every
    order, against the reference's loop."""
    from sunode_tpu.ops.adams import _update_DF as jax_update

    rng = np.random.default_rng(0)
    DF = rng.standard_normal((KA, 3))
    d_f = rng.standard_normal(3)
    for p in range(1, ADAMS_MAX_ORDER + 1):
        got = adams_mod._update_DF(torch.as_tensor(DF), p, torch.as_tensor(d_f))
        ref = jax_update(jnp.asarray(DF), jnp.asarray(p), jnp.asarray(d_f))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_quadrature_branch(lv_rhs):
    """``quad_rhs`` runs the batched core at one lane in both packages."""
    def jq(t, y, p):
        return jnp.stack([y[0] * y[1]])

    def tq(t, y, p):
        return torch.stack([y[0] * y[1]])

    jres, tres = _run(lv_rhs, LV_Y0, LV_P, np.linspace(0.5, 10.0, 8),
                      dict(rtol=1e-8, atol=1e-8, quad_err_con=True),
                      quad_rhs=(jq, tq), quad0=np.zeros(1))
    _check(jres, tres, ("n_steps",), quad=True)
    assert tres.status == 0 and tres.saved is None


@pytest.mark.parametrize("terminal", [True])
def test_roots(lv_rhs, terminal):
    def jg(t, y, p):
        return jnp.stack([y[0] - 9.0])

    def tg(t, y, p):
        return torch.stack([y[0] - 9.0])

    jres, tres = _run(lv_rhs, LV_Y0, LV_P, np.linspace(0.5, 10.0, 8),
                      dict(rtol=1e-8, atol=1e-8), root_fn=(jg, tg), root_cap=4,
                      root_terminal=terminal)
    _check(jres, tres)
    assert tres.stats["n_roots"] == int(jres.stats["n_roots"]) >= 1
    np.testing.assert_allclose(tres.stats["roots_t"].numpy(), np.asarray(jres.stats["roots_t"]),
                               rtol=1e-10)
    np.testing.assert_array_equal(tres.stats["roots_found"].numpy(),
                                  np.asarray(jres.stats["roots_found"]))
    if terminal:
        assert tres.status == STATUS["ROOT_RETURN"]


def test_failure_poisoning_and_recording(lv_rhs):
    """max_steps = 5: status MAX_STEPS and NaN past the last emission, as the
    reference; and the Adams recording (quintic rows) row for row."""
    tvals = np.linspace(0.5, 10.0, 8)
    jres, tres = _run(lv_rhs, LV_Y0, LV_P, tvals, dict(max_steps=5))
    _check(jres, tres)
    assert tres.status == STATUS["MAX_STEPS"] and np.isnan(tres.ys.numpy()[-1]).all()
    jres, tres = _run(lv_rhs, LV_Y0, LV_P, tvals, dict(rtol=1e-8, atol=1e-8, save_steps=32))
    _check(jres, tres)
    ns = int(jres.saved["n_saved"])
    assert tres.saved["n_saved"] == ns and set(tres.saved) == set(jres.saved)
    for k in ("t", "y"):
        np.testing.assert_allclose(tres.saved[k].numpy()[:ns], np.asarray(jres.saved[k])[:ns],
                                   rtol=1e-6, atol=1e-11)
    assert tres.stats["checkpoint_thinning_levels"] == int(
        jres.stats["checkpoint_thinning_levels"]) >= 1
