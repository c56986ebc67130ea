"""sunode_torch batched Adams integrator against sunode_tpu's, lane by lane.

On the CPU every attempt runs the plain PECE version, which keeps the JAX
main path's operations, so step counts agree exactly and trajectories to
rounding."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunode_tpu.ops.adams_batched import adams_solve_batched as jax_solve
from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_tpu.symode import SympyProblem as JaxSympyProblem
from sunode_torch.adjoint import transition_fz
from sunode_torch.entry import _lv, lv_problem
from sunode_torch.ops.adams_batched import adams_solve_batched
from sunode_torch.ops.bdf import BDFOptions

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def problems():
    jp = JaxSympyProblem(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()},
        rhs_sympy=_lv,
        derivative_params=[("alpha",), ("beta",)],
    )
    return jp, lv_problem()


@pytest.fixture(scope="module")
def forward_pair(problems):
    jp, tp = problems
    g = np.load(os.path.join(GOLDEN, "lv_forward.npz"))
    jres = jax.jit(
        lambda y, p: jax_solve(
            jp.make_rhs(), 0.0, y, p, jnp.asarray(g["tvals"]),
            JaxOptions(rtol=1e-10, atol=1e-10),
        )
    )(jnp.asarray(g["y0s"]), jnp.asarray(g["ps"]))
    tres = adams_solve_batched(
        tp.make_rhs(), 0.0, torch.as_tensor(g["y0s"]), torch.as_tensor(g["ps"]),
        torch.as_tensor(g["tvals"]), BDFOptions(rtol=1e-10, atol=1e-10),
    )
    return g, jres, tres


def test_forward_matches_jax(forward_pair):
    g, jres, tres = forward_pair
    assert (tres.status == 0).all()
    np.testing.assert_array_equal(tres.stats["n_steps"].numpy(), np.asarray(jres.stats["n_steps"]))
    assert tres.stats["n_attempts"] == int(jres.stats["n_attempts"])
    np.testing.assert_allclose(tres.ys.numpy(), np.asarray(jres.ys), rtol=1e-8)


@pytest.mark.parametrize(
    "stat",
    ["n_steps", "n_error_test_fails", "n_conv_fails", "final_order", "final_time"],
)
def test_forward_stats_match_jax(forward_pair, stat):
    g, jres, tres = forward_pair
    np.testing.assert_allclose(
        tres.stats[stat].numpy(), np.asarray(jres.stats[stat]), rtol=1e-12
    )


# XLA's and torch's pow and sqrt differ in the last ulp; the order-selection
# estimates (high differences of f, far below f itself) amplify that to ~1e-6
# in the proposed step once orders >= 6 are reached, and a marginal corrector
# test can take one sweep more (ROADMAP C).
@pytest.mark.parametrize(
    "stat, rtol, atol",
    [("n_rhs_evals", 0, 1), ("n_newton_iters", 0, 1), ("final_step_size", 1e-4, 0)],
)
def test_forward_marginal_stats_match_jax(forward_pair, stat, rtol, atol):
    g, jres, tres = forward_pair
    np.testing.assert_allclose(
        tres.stats[stat].numpy(), np.asarray(jres.stats[stat]), rtol=rtol, atol=atol
    )


def test_forward_golden(forward_pair):
    g, _, tres = forward_pair
    # rtol=1e-10 solve vs the rtol=1e-12 scipy oracle (test_golden.py:54)
    np.testing.assert_allclose(tres.ys.numpy(), g["ys"], rtol=2e-7, atol=2e-9)


def test_per_lane_rhs_matches_batched(problems):
    _, tp = problems
    g = np.load(os.path.join(GOLDEN, "lv_forward.npz"))
    args = (0.0, torch.as_tensor(g["y0s"][:4]), torch.as_tensor(g["ps"][:4]),
            torch.as_tensor(g["tvals"][:6]), BDFOptions(rtol=1e-8, atol=1e-8))
    rhs = tp.make_rhs()
    per_lane = adams_solve_batched(lambda t, y, p: rhs(t, y, p), *args)
    batched = adams_solve_batched(rhs, *args, batched_fns=True)
    assert torch.equal(per_lane.ys, batched.ys)


def _jax_transition(jp, n):
    """The reference's backward system (sunode_tpu/adjoint.py:429-450)."""
    rhs_b = jax.vmap(jp.make_rhs(), in_axes=(0, 1, 1), out_axes=1)
    aj_b = jax.vmap(jp.make_adjoint_jac_dense(), in_axes=(0, 1, 1, 1), out_axes=2)
    dfdp_b = jax.vmap(jp.make_dfdp(), in_axes=(0, 1, 1), out_axes=2)

    def rhs_c(tau, z, p):
        t = -tau
        y, M = z[:n], z[n:].reshape(n, n, -1)
        matJT = -aj_b(t, y, jnp.zeros_like(y), p)
        dM = jnp.sum(matJT[:, :, None, :] * M[None, :, :, :], axis=1)
        return jnp.concatenate([-rhs_b(t, y, p), dM.reshape(n * n, -1)])

    def quad_c(tau, z, p):
        y, M = z[:n], z[n:].reshape(n, n, -1)
        Bm = dfdp_b(-tau, y, p)
        return jnp.sum(M[:, :, None, :] * Bm[:, None, :, :], axis=0).reshape(-1, z.shape[-1])

    return rhs_c, quad_c


def test_backward_shaped_solve_matches_jax(problems):
    """Quad block with error control, vector rtol, batched functions: the
    transition adjoint's backward solve, started from the golden y(10)."""
    jp, tp = problems
    g = np.load(os.path.join(GOLDEN, "lv_adjoint.npz"))
    B, n = 8, 2
    y_end = g["ys"][:B, -1, :]
    z0 = np.concatenate([y_end, np.tile(np.eye(n).reshape(1, -1), (B, 1))], axis=1)
    params = np.concatenate(
        [g["p_subs"][:B], np.broadcast_to(g["p_fix"], (B, 2))], axis=1
    )
    tvals = g["tvals"]
    tv_solver = np.concatenate([(-tvals[:-1])[::-1], [0.0]])
    rtol = np.concatenate([np.full(n, 1e-7), np.full(n * n, 1e-3)])
    kw = dict(rtol=rtol, atol=1e-7, adams_max_order=6, quad_rtol=1e-3,
              quad_atol=1e-3, quad_err_con=True)
    rhs_j, quad_j = _jax_transition(jp, n)
    jres = jax.jit(
        lambda z, p: jax_solve(
            rhs_j, -tvals[-1], z, p, jnp.asarray(tv_solver), JaxOptions(**kw),
            quad_rhs=quad_j, quad0=jnp.zeros((B, n * n)), batched_fns=True,
        )
    )(jnp.asarray(z0), jnp.asarray(params))
    rhs_t, quad_t = transition_fz(
        tp.make_rhs(), tp.make_adjoint_jac_dense(), tp.make_dfdp(), n
    )
    tres = adams_solve_batched(
        rhs_t, -tvals[-1], torch.as_tensor(z0), torch.as_tensor(params),
        torch.as_tensor(tv_solver), BDFOptions(**kw),
        quad_rhs=quad_t, quad0=torch.zeros((B, n * n), dtype=torch.float64),
        batched_fns=True,
    )
    assert (tres.status == 0).all()
    np.testing.assert_array_equal(tres.stats["n_steps"].numpy(), np.asarray(jres.stats["n_steps"]))
    np.testing.assert_allclose(tres.ys.numpy(), np.asarray(jres.ys), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(tres.quad.numpy(), np.asarray(jres.quad), rtol=1e-8, atol=1e-12)


def test_failure_statuses_and_post_mortem_match_jax(problems):
    """A NaN lane is BAD_INIT; a step budget ends the rest with MAX_STEPS and
    the same per-lane post-mortem (where, with which h and order)."""
    jp, tp = problems
    g = np.load(os.path.join(GOLDEN, "lv_forward.npz"))
    y0s = g["y0s"][:6].copy()
    y0s[2, 1] = np.nan
    kw = dict(rtol=1e-10, atol=1e-10, max_steps=40)
    jres = jax.jit(
        lambda y, p: jax_solve(jp.make_rhs(), 0.0, y, p, jnp.asarray(g["tvals"]), JaxOptions(**kw))
    )(jnp.asarray(y0s), jnp.asarray(g["ps"][:6]))
    tres = adams_solve_batched(
        tp.make_rhs(), 0.0, torch.as_tensor(y0s), torch.as_tensor(g["ps"][:6]),
        torch.as_tensor(g["tvals"]), BDFOptions(**kw),
    )
    status = tres.status.numpy()
    np.testing.assert_array_equal(status, np.asarray(jres.status))
    assert status[2] == 3 and (np.delete(status, 2) == 1).all()
    # last-ulp pow/sqrt differences grow to ~1e-6 in h by step 40 (ROADMAP C)
    for key in ("error_time", "error_step_size"):
        np.testing.assert_allclose(
            tres.stats[key].numpy(), np.asarray(jres.stats[key]), rtol=1e-4
        )
    for key in ("error_order", "error_worst_state"):
        np.testing.assert_array_equal(tres.stats[key].numpy(), np.asarray(jres.stats[key]))
    # the raw solver emits what it reached (NaN elsewhere); wrappers poison
    np.testing.assert_allclose(tres.ys.numpy(), np.asarray(jres.ys), rtol=1e-8)


@pytest.mark.parametrize(
    "kwargs",
    [
        # rootfinding, staggered sensitivities and the adjoint machinery are
        # ported, but not what the reference refuses to combine: either of
        # the first two with injections or a stage
        dict(root_fn=lambda t, y, p: y[0], stage_fn=lambda t: t[None]),
        dict(sens_rhs=lambda t, y, S, p: S, sens0=np.zeros((2, 2, 2)),
             inject_times=np.array([1.0]), inject_deltas=np.zeros((1, 2, 2))),
        dict(inject_times=np.array([1.0]), inject_deltas=np.zeros((1, 2, 2)),
             root_fn=lambda t, y, p: y[0]),
        dict(stage_fn=lambda t: t[None], sens_rhs=lambda t, y, S, p: S),
    ],
    ids=["roots", "sens", "inject", "stage_fn"],
)
def test_unported_features_raise(problems, kwargs):
    _, tp = problems
    with pytest.raises(NotImplementedError):
        adams_solve_batched(
            tp.make_rhs(), 0.0, torch.ones((2, 2), dtype=torch.float64),
            torch.ones((2, 4), dtype=torch.float64),
            torch.tensor([1.0], dtype=torch.float64), BDFOptions(), **kwargs,
        )


def test_unported_save_steps_and_per_lane_tvals_raise(problems):
    """Recording is ported (tests/test_torch_adams_checkpoint.py), and so are
    per-lane observation grids (tests/test_torch_per_lane_tvals.py), with
    recording and without: both solve, each lane on its own grid (here three
    copies of t = 1, so three equal slots).  What still raises is a per-lane
    grid with the adjoint's machinery, a stage or injections, as in the
    reference."""
    _, tp = problems
    y0 = torch.ones((2, 2), dtype=torch.float64)
    p = torch.ones((2, 4), dtype=torch.float64)
    grid = torch.ones((2, 3), dtype=torch.float64)
    for opts in (BDFOptions(save_steps=16), BDFOptions()):
        res = adams_solve_batched(tp.make_rhs(), 0.0, y0, p, grid, opts)
        assert (res.status == 0).all() and res.ys.shape == (2, 3, 2)
        assert torch.equal(res.ys[:, 1:], res.ys[:, :1].expand(2, 2, 2))
    with pytest.raises(NotImplementedError, match="per-lane"):
        adams_solve_batched(tp.make_rhs(), 0.0, y0, p, grid, BDFOptions(save_steps=16),
                            stage_fn=lambda t: t[None])
