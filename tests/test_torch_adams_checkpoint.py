"""The ADAMS adjoints that read no transition matrix: sunode_torch's Adams
injections, stage and recording, the fused ADAMS backward ('hermite',
'polynomial') and the backsolve ('resolve'), and
``make_batched_solve_fn(method='ADAMS', adjoint_interpolation=m)`` against
sunode_tpu's on the same float64 inputs.

On the CPU every attempt runs the history attempt's plain version, which
keeps the JAX main path's operations: step counts agree exactly, values to
rounding.  Each tolerance is stated with the worst deviation measured on
the CPU beside it.  The backward solves of the smaller cases run at rtol
1e-6; the end-to-end cases use the options of the JAX package's golden test
of these modes (rtol 1e-8 forward and backward, 384 checkpoints).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunode_tpu.adjoint import adjoint_backward_batched as jax_backward
from sunode_tpu.ops.adams_batched import adams_solve_batched as jax_solve
from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_tpu.symode import SympyProblem as JaxSympyProblem
from sunode_tpu.wrappers.as_jax import make_batched_solve_fn as jax_make
from sunode_torch.adjoint import adjoint_backward_batched
from sunode_torch.entry import LV_ADAMS_CHECKPOINTS, _lv, build_lv_adams, lv_problem
from sunode_torch.ops.adams_batched import adams_solve_batched
from sunode_torch.ops.bdf import BDFOptions
from sunode_torch.wrappers.as_torch import make_batched_solve_fn

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
RTOL = 1e-8
TVALS = np.linspace(1.0, 8.0, 6)
SHORT_ADJ = dict(rtol=1e-6, atol=1e-6)  # backward tolerances of the smaller cases
MODES = ["resolve", "hermite", "polynomial"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: torch is faster on one CPU thread; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_lv():
    return JaxSympyProblem(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()},
        rhs_sympy=_lv,
        derivative_params=[("alpha",), ("beta",)],
    )


def _lv6():
    rng = np.random.default_rng(3)
    y0s = np.array([10.0, 2.0]) * (1 + 0.1 * rng.standard_normal((6, 2)))
    ps = np.array([1.0, 0.3, 1.0, 0.4]) * (1 + 0.1 * rng.standard_normal((6, 4)))
    return y0s, ps


def _stats_match(tres, jres):
    """Step statistics as test_torch_adams_batched.py holds them: the exact
    ones equal, ROADMAP C1's three (ulp differences of pow and sqrt that the
    order selection magnifies) within one sweep, and the final step size
    within 1e-3 here (measured worst 1.34e-4, after four injections; 1e-4
    there, without)."""
    for stat in ("n_steps", "n_error_test_fails", "n_conv_fails", "final_order"):
        np.testing.assert_array_equal(tres.stats[stat].numpy(), np.asarray(jres.stats[stat]),
                                      err_msg=stat)
    assert tres.stats["n_attempts"] == int(jres.stats["n_attempts"])
    np.testing.assert_allclose(tres.stats["final_time"].numpy(),
                               np.asarray(jres.stats["final_time"]), rtol=1e-12)
    for stat, rtol, atol in (("n_rhs_evals", 0, 1), ("n_newton_iters", 0, 1),
                             ("final_step_size", 1e-3, 0)):
        np.testing.assert_allclose(tres.stats[stat].numpy(), np.asarray(jres.stats[stat]),
                                   rtol=rtol, atol=atol, err_msg=stat)


# ---- the initial step's rounding -------------------------------------------------
def test_initial_step_divides_once():
    """``0.01 / dmn`` on a tensor is ``reciprocal(dmn) * 0.01`` in torch, two
    roundings; the reference's ``jnp.sqrt(0.01 / dmn)`` divides once.  The
    core's ``torch.full_like(dmn, 0.01) / dmn`` gives the reference's
    quotient in every lane (measured: the old one differs in 1,092 of
    4,096).  The square roots then differ only where torch's CPU ``sqrt``
    misses the correctly rounded one, by one ulp (ROADMAP C1; measured: 32
    of 4,096)."""
    dmn = 10.0 ** np.random.default_rng(7).uniform(-8, 8, 4096)
    want = np.asarray(jax.jit(lambda d: 0.01 / d)(jnp.asarray(dmn)))
    t = torch.as_tensor(dmn)
    old = (0.01 / t).numpy()
    new = torch.full_like(t, 0.01) / t
    assert (old != want).any()
    np.testing.assert_array_equal(new.numpy(), want)
    np.testing.assert_allclose(torch.sqrt(new).numpy(), np.sqrt(want), rtol=2.3e-16, atol=0)


# ---- injections and the stage -------------------------------------------------
INJECT_TIMES = np.array([1.5, 3.0, 3.0, 5.5])  # a repeated time: a zero-length event step
DISTINCT_TIMES = np.array([1.5, 3.0, 4.5, 5.5])


@functools.lru_cache(maxsize=None)
def _injected(keep, times=tuple(INJECT_TIMES)):
    """Both packages' LV solve with four injections of seeded deltas at
    ``times`` and the quadrature block, ``inject_keep_order=keep``."""
    y0s, ps = _lv6()
    times = np.array(times)
    deltas = 0.3 * np.random.default_rng(5).standard_normal((len(times), 2, 6))
    q0 = np.zeros((6, 1))
    opts = dict(rtol=RTOL, atol=RTOL, inject_keep_order=keep)
    jp, tp = _jax_lv(), lv_problem()
    jrhs = jp.make_rhs()

    def jquad(t, y, p):
        return jnp.stack([y[0] * y[1]])

    jres = jax.jit(
        lambda y, p: jax_solve(
            jrhs, 0.0, y, p, jnp.asarray(TVALS), JaxOptions(**opts), quad_rhs=jquad,
            quad0=jnp.asarray(q0), inject_times=jnp.asarray(times),
            inject_deltas=jnp.asarray(deltas),
        )
    )(jnp.asarray(y0s), jnp.asarray(ps))
    tres = adams_solve_batched(
        tp.make_rhs(), 0.0, torch.as_tensor(y0s), torch.as_tensor(ps), torch.as_tensor(TVALS),
        BDFOptions(**opts), quad_rhs=lambda t, y, p: (y[0] * y[1])[None], quad0=torch.as_tensor(q0),
        batched_fns=True, inject_times=torch.as_tensor(times),
        inject_deltas=torch.as_tensor(deltas),
    )
    return jres, tres


@pytest.mark.parametrize(
    "keep, times", [(1, tuple(INJECT_TIMES)), (3, tuple(DISTINCT_TIMES))],
    ids=["keep1-repeated-time", "keep3"],
)
def test_injections_match_jax(keep, times):
    jres, tres = _injected(keep, times)
    assert (tres.status == 0).all()
    np.testing.assert_array_equal(tres.status.numpy(), np.asarray(jres.status))
    _stats_match(tres, jres)
    # measured (keep 1 / 3): ys 5.7e-12 / 4.6e-13, quad 5.3e-15 / 1.4e-14,
    # final_state 5.7e-12 / 4.6e-13 relative
    np.testing.assert_allclose(tres.ys.numpy(), np.asarray(jres.ys), rtol=1e-10)
    np.testing.assert_allclose(tres.quad.numpy(), np.asarray(jres.quad), rtol=1e-10)
    np.testing.assert_allclose(tres.stats["final_state"].numpy(),
                               np.asarray(jres.stats["final_state"]), rtol=1e-10)


def test_keep_order_repeated_time_underflows_as_the_reference():
    """Reproduced, not repaired: with ``inject_keep_order > 1`` the
    zero-length step of a repeated injection time rescales the kept
    differences by h / h_D = 0, and every lane dies of step underflow
    (status 2) at t = 3 in both packages, with the same step counts."""
    jres, tres = _injected(3)
    assert tres.status.tolist() == np.asarray(jres.status).tolist() == [2] * 6
    np.testing.assert_array_equal(tres.stats["n_steps"].numpy(), np.asarray(jres.stats["n_steps"]))
    np.testing.assert_array_equal(tres.stats["final_time"].numpy(), 3.0)


def test_stage_fn_matches_jax():
    """A stage that the right-hand side reads (a forcing ``0.1 * [sin t,
    cos t]``), computed once per attempt, with injections and a quadrature,
    as the fused backward uses it."""
    y0s, ps = _lv6()
    deltas = 0.3 * np.random.default_rng(6).standard_normal((len(INJECT_TIMES), 2, 6))
    jrhs_b = jax.vmap(_jax_lv().make_rhs(), in_axes=(0, 1, 1), out_axes=1)
    trhs_b = lv_problem().make_rhs()

    def j_stage(t):
        return jnp.stack([jnp.sin(t), jnp.cos(t)])

    def t_stage(t):
        return torch.stack([torch.sin(t), torch.cos(t)])

    opts = dict(rtol=RTOL, atol=RTOL)
    jres = jax.jit(
        lambda y, p: jax_solve(
            lambda t, y, p, s: jrhs_b(t, y, p) + 0.1 * s, 0.0, y, p, jnp.asarray(TVALS),
            JaxOptions(**opts), quad_rhs=lambda t, y, p, s: (s[0] * y[1])[None],
            quad0=jnp.zeros((6, 1)), batched_fns=True, inject_times=jnp.asarray(INJECT_TIMES),
            inject_deltas=jnp.asarray(deltas), stage_fn=j_stage,
        )
    )(jnp.asarray(y0s), jnp.asarray(ps))
    tres = adams_solve_batched(
        lambda t, y, p, s: trhs_b(t, y, p) + 0.1 * s, 0.0, torch.as_tensor(y0s),
        torch.as_tensor(ps), torch.as_tensor(TVALS), BDFOptions(**opts),
        quad_rhs=lambda t, y, p, s: (s[0] * y[1])[None], quad0=torch.zeros((6, 1), dtype=torch.float64),
        batched_fns=True, inject_times=torch.as_tensor(INJECT_TIMES),
        inject_deltas=torch.as_tensor(deltas), stage_fn=t_stage,
    )
    assert (tres.status == 0).all()
    _stats_match(tres, jres)
    # measured: ys 6.9e-12, quad 1.6e-14 relative
    np.testing.assert_allclose(tres.ys.numpy(), np.asarray(jres.ys), rtol=1e-10)
    np.testing.assert_allclose(tres.quad.numpy(), np.asarray(jres.quad), rtol=1e-10)


# ---- recording ---------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _recorded(save_steps, hermite_order, thinning):
    """Both packages' ADAMS forward solve of 6 LV lanes with recording."""
    y0s, ps = _lv6()
    opts = dict(rtol=RTOL, atol=RTOL, save_steps=save_steps, hermite_order=hermite_order,
                checkpoint_thinning=thinning)
    jp = _jax_lv()
    jres = jax.jit(
        lambda y, p: jax_solve(jp.make_rhs(), 0.0, y, p, jnp.asarray(TVALS), JaxOptions(**opts))
    )(jnp.asarray(y0s), jnp.asarray(ps))
    tres = adams_solve_batched(
        lv_problem().make_rhs(), 0.0, torch.as_tensor(y0s), torch.as_tensor(ps),
        torch.as_tensor(TVALS), BDFOptions(**opts), batched_fns=True,
    )
    return jres, tres


def _np_saved(saved):
    return {k: np.array(v) for k, v in saved.items()}


@pytest.mark.parametrize(
    "save_steps, order, thinning",
    [(16, 5, True), (384, 3, True), (16, 3, False)],
    ids=["16-quintic", "384-cubic", "16-legacy"],
)
def test_recording_matches_jax(save_steps, order, thinning):
    jres, tres = _recorded(save_steps, order, thinning)
    js, ts = _np_saved(jres.saved), {k: v.numpy() for k, v in tres.saved.items()}
    assert sorted(ts) == sorted(js)
    assert ("fd" in ts) == (order == 5) and "L" not in ts  # Adams rows carry no L
    np.testing.assert_array_equal(tres.status.numpy(), np.asarray(jres.status))
    np.testing.assert_array_equal(ts["n_saved"], js["n_saved"])
    np.testing.assert_array_equal(ts["overflow"], js["overflow"])
    levels = tres.stats["checkpoint_thinning_levels"]
    assert levels == int(jres.stats["checkpoint_thinning_levels"])
    if save_steps == 16 and thinning:
        assert levels >= 2 and not ts["overflow"].any()
    if not thinning:
        assert ts["overflow"].all()  # the legacy buffer clamps, every lane overflows
    _stats_match(tres, jres)
    # the same rows hold data and pads; the data agree normwise (max |a - b|
    # over max |b| per key): the step counts are equal, but the step sizes
    # drift by ~2e-8 relative (ROADMAP C1), as in the BDF recording.  f is
    # the history's updated row 0 here, the reference's f(t_new, y_it), equal
    # up to the sums' rounding.  Measured worst over the three cases: t
    # 1.9e-8, y 2.1e-8, f 3.8e-8, fd 4.4e-8 (legacy, 16 rows: 1.2e-13).
    for key in ("t", "y", "f", "yf", "fd"):
        if key in js:
            finite = np.isfinite(js[key])
            np.testing.assert_array_equal(np.isfinite(ts[key]), finite, err_msg=key)
            a, b = ts[key][finite], js[key][finite]
            err = np.max(np.abs(a - b)) / np.max(np.abs(b))
            assert err <= 1e-6, (key, err)


def test_recording_skips_the_quadrature_block():
    """ROADMAP C4, reproduced: with a quadrature the rows hold y and f only."""
    y0s, ps = _lv6()
    tres = adams_solve_batched(
        lv_problem().make_rhs(), 0.0, torch.as_tensor(y0s), torch.as_tensor(ps),
        torch.as_tensor(TVALS), BDFOptions(rtol=RTOL, atol=RTOL, save_steps=64, hermite_order=3),
        quad_rhs=lambda t, y, p: y[:1], quad0=torch.zeros((6, 1), dtype=torch.float64),
        batched_fns=True,
    )
    assert tres.saved["yf"].shape[1] == 4 and tres.saved["y"].shape[1] == 2


# ---- the backward solve alone --------------------------------------------------
def _jax_adjoint_fns():
    jp = _jax_lv()
    return jp.make_adjoint_rhs(), jp.make_adjoint_jac_dense(), jp.make_adjoint_quad_rhs()


def _torch_adjoint_fns():
    tp = lv_problem()
    return tp.make_adjoint_rhs(), tp.make_adjoint_jac_dense(), tp.make_adjoint_quad_rhs()


@pytest.mark.parametrize("interpolation", MODES)
def test_backward_matches_jax(interpolation):
    """The JAX package's forward (its table, its y at the last time) into
    both packages' ADAMS backward solves."""
    jres, _ = _recorded(LV_ADAMS_CHECKPOINTS, 3 if interpolation == "polynomial" else 5, True)
    _, ps = _lv6()
    grads = np.random.default_rng(11).standard_normal((6, len(TVALS), 2))
    y_end = np.asarray(jres.ys)[:, -1, :]
    resolve = interpolation == "resolve"
    jp = _jax_lv()
    jadj = jax.jit(
        lambda g, p: jax_backward(
            *_jax_adjoint_fns(), jres.saved, 0.0, jnp.asarray(TVALS), g, p, 2,
            JaxOptions(**SHORT_ADJ), method="ADAMS", interpolation=interpolation,
            rhs=jp.make_rhs() if resolve else None, y_end=jnp.asarray(y_end) if resolve else None,
        )
    )(jnp.asarray(grads), jnp.asarray(ps))
    tadj = adjoint_backward_batched(
        *_torch_adjoint_fns(), {k: torch.as_tensor(v) for k, v in _np_saved(jres.saved).items()},
        0.0, torch.as_tensor(TVALS), torch.as_tensor(grads), torch.as_tensor(ps), 2,
        BDFOptions(**SHORT_ADJ), method="ADAMS", interpolation=interpolation,
        rhs=lv_problem().make_rhs() if resolve else None,
        y_end=torch.as_tensor(y_end) if resolve else None,
    )
    np.testing.assert_array_equal(tadj.status.numpy(), np.asarray(jadj.status))
    assert (tadj.status == 0).all() and tadj.stats["n_attempts"] > 0
    np.testing.assert_array_equal(
        tadj.stats["n_backward_steps"].numpy(), np.asarray(jadj.stats["n_backward_steps"])
    )
    # measured (resolve / hermite / polynomial): lam 1.4e-12 / 9.0e-13 /
    # 1.6e-12, quad 3.9e-13 / 1.6e-13 / 2.4e-14, y0_resolved 1.1e-13 relative
    np.testing.assert_allclose(tadj.lamda.numpy(), np.asarray(jadj.lamda), rtol=1e-10)
    np.testing.assert_allclose(tadj.quad.numpy(), np.asarray(jadj.quad), rtol=1e-10)
    if resolve:
        np.testing.assert_allclose(tadj.stats["y0_resolved"].numpy(),
                                   np.asarray(jadj.stats["y0_resolved"]), rtol=1e-10)


def test_backward_refuses_what_resolve_needs():
    args = (*_torch_adjoint_fns(), None, 0.0, torch.as_tensor(TVALS),
            torch.zeros((6, 6, 2), dtype=torch.float64), torch.ones((6, 4), dtype=torch.float64), 2)
    with pytest.raises(NotImplementedError, match="requires method='ADAMS'"):
        adjoint_backward_batched(*args, interpolation="resolve")
    with pytest.raises(ValueError, match="requires rhs and y_end"):
        adjoint_backward_batched(*args, method="ADAMS", interpolation="resolve")


def test_legacy_overflow_gives_status_99_and_nan():
    """A 16-slot recording without thinning overflows in every lane: the
    fused ADAMS backward flags it 99 and every gradient is NaN, as in the
    reference."""
    _, tres = _recorded(16, 3, False)
    assert tres.saved["overflow"].all()
    _, ps = _lv6()
    adj = adjoint_backward_batched(
        *_torch_adjoint_fns(), tres.saved, 0.0, torch.as_tensor(TVALS),
        torch.ones((6, len(TVALS), 2), dtype=torch.float64), torch.as_tensor(ps), 2,
        BDFOptions(**SHORT_ADJ), method="ADAMS", interpolation="polynomial",
    )
    assert (adj.status == 99).all()
    assert torch.isnan(adj.lamda).all() and torch.isnan(adj.quad).all()


# ---- the wrapper end to end -----------------------------------------------------
def _golden():
    return np.load(os.path.join(GOLDEN, "lv_adjoint.npz"))


GOLDEN_LANES = slice(0, 4)


def _solvers(mode):
    g = _golden()
    common = dict(checkpoint_n=LV_ADAMS_CHECKPOINTS, method="ADAMS", adjoint_interpolation=mode)
    jsolve = jax_make(_jax_lv(), options=JaxOptions(rtol=RTOL, atol=RTOL),
                      adjoint_options=JaxOptions(rtol=RTOL, atol=RTOL), **common)
    tsolve = make_batched_solve_fn(lv_problem(), options=BDFOptions(rtol=RTOL, atol=RTOL),
                                   adjoint_options=BDFOptions(rtol=RTOL, atol=RTOL), **common)
    return g, jsolve, tsolve


@pytest.mark.parametrize("mode", MODES)
def test_wrapper_matches_jax_and_golden(mode):
    """The JAX package's golden test of these modes on four of its lanes:
    ``jax.grad`` of ``sum(ys**2)`` against ``torch.autograd``, every input's
    gradient, and the golden gate (rtol 2e-3, atol 1e-3)."""
    g, jsolve, tsolve = _solvers(mode)
    y0s, p_subs = g["y0s"][GOLDEN_LANES], g["p_subs"][GOLDEN_LANES]

    def loss(t0, y0s, p_subs, tvals):
        return jnp.sum(jsolve(t0, y0s, p_subs, jnp.asarray(g["p_fix"]), tvals) ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        0.0, jnp.asarray(y0s), jnp.asarray(p_subs), jnp.asarray(g["tvals"])
    )
    leaves = [torch.tensor(0.0, dtype=torch.float64, requires_grad=True),
              torch.as_tensor(y0s).requires_grad_(), torch.as_tensor(p_subs).requires_grad_(),
              torch.as_tensor(g["tvals"]).requires_grad_()]
    ys = tsolve(leaves[0], leaves[1], leaves[2], torch.as_tensor(g["p_fix"]), leaves[3])
    got = torch.autograd.grad(torch.sum(ys**2), leaves)
    stats = tsolve.last_stats
    assert (stats["backward"]["status"] == 0).all() and stats["backward"]["n_attempts"] > 0
    assert ("checkpoint_thinning_levels" in stats["forward"]) == (mode != "resolve")
    # measured (golden, worst of the modes): gy 2.2e-5, gp 4.1e-6 relative
    np.testing.assert_allclose(got[1].numpy(), g["gy"][GOLDEN_LANES], rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(got[2].numpy(), g["gp"][GOLDEN_LANES], rtol=2e-3, atol=1e-3)
    # measured worst over the modes: d_t0 1.4e-13, gy 1.8e-12, gp 1.7e-12,
    # d_tvals 1.1e-12 relative
    for name, a, b in zip(("d_t0", "gy", "gp", "d_tvals"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9, err_msg=name)


def test_resolve_failure_lane_poisons_only_its_grad():
    """tests/test_batched_adjoint.py's inputs: lane 2's p_sub = [1e8, -1e8]
    fails (max_steps 2000).  Its gradient is NaN; the other lanes' are
    finite and bit for bit those of a solve without it."""
    rng = np.random.default_rng(3)
    y0s = np.array([10.0, 2.0]) * (1 + 0.08 * rng.standard_normal((8, 2)))
    psub = np.array([1.0, 0.3]) * (1 + 0.08 * rng.standard_normal((8, 2)))
    psub[2] = [1e8, -1e8]
    solve = make_batched_solve_fn(
        lv_problem(), options=BDFOptions(rtol=1e-9, atol=1e-9, max_steps=2000),
        adjoint_options=BDFOptions(**SHORT_ADJ), method="ADAMS", adjoint_interpolation="resolve",
    )
    p_fix, tvals = torch.tensor([1.0, 0.4], dtype=torch.float64), torch.as_tensor(TVALS)

    def grads(lanes):
        y0 = torch.as_tensor(y0s[lanes]).requires_grad_()
        p = torch.as_tensor(psub[lanes]).requires_grad_()
        ys = solve(0.0, y0, p, p_fix, tvals)
        loss = torch.sum(torch.where(torch.isfinite(ys), ys, 0.0) ** 2)
        return [a.numpy() for a in torch.autograd.grad(loss, (y0, p))]

    gy, gp = grads(np.arange(8))
    assert np.isnan(gy[2]).all() and np.isnan(gp[2]).all()
    others = np.array([0, 1, 3, 4, 5, 6, 7])
    alone = grads(others)
    for a, b in zip((gy, gp), alone):
        assert np.isfinite(b).all()
        np.testing.assert_array_equal(a[others], b)


def test_build_lv_adams_options():
    for mode in MODES:
        step, (y0s, p_subs) = build_lv_adams(3, 4, 1e-6, mode, device="cpu")
        solve = step.solve
        assert (solve.method, solve.interpolation) == ("ADAMS", mode)
        assert solve.adjoint_options.rtol == solve.options.rtol == 1e-6
        recorded = mode != "resolve"
        assert solve.fwd_options.save_steps == (LV_ADAMS_CHECKPOINTS if recorded else 0)
        assert solve.fwd_options.hermite_order == (3 if mode == "polynomial" else 5)
        assert y0s.shape == p_subs.shape == (3, 2) and step.tvals.shape == (4,)
    with pytest.raises(ValueError, match="interpolation"):
        build_lv_adams(3, 4, 1e-6, "transition", device="cpu")
