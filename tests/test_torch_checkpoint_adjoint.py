"""The checkpointed adjoint, the reference's default call: sunode_torch's
recording, evaluators, backward solve and ``make_batched_solve_fn(problem)``
against sunode_tpu's on the same float64 inputs.

The BDF step counts are equal in every lane here, so recorded rows
correspond one to one; the step sizes drift by ~1e-7 relative (the Newton
solve, pow and sqrt round otherwise, ROADMAP C2).  Each tolerance is stated
with the worst deviation measured on the CPU beside it.  The backward solves
of the smaller cases run at rtol 1e-6 instead of the default 1e-10 to keep
the file short; the end-to-end cases use every default.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunode_tpu.adjoint import _searchsorted_b as jax_searchsorted
from sunode_tpu.adjoint import adjoint_backward_batched as jax_backward
from sunode_tpu.adjoint import make_hermite_eval_batched as jax_hermite
from sunode_tpu.adjoint import make_polynomial_eval_batched as jax_polynomial
from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_tpu.ops.bdf_batched import bdf_solve_batched as jax_solve
from sunode_tpu.symode import SympyProblem as JaxSympyProblem
from sunode_tpu.wrappers.as_jax import make_batched_solve_fn as jax_make
from sunode_torch.adjoint import (
    _searchsorted_b,
    adjoint_backward_batched,
    make_hermite_eval_batched,
    make_polynomial_eval_batched,
)
from sunode_torch.entry import (
    _lv,
    _robertson,
    build_lv_checkpointed,
    lv_problem,
    robertson_options,
    robertson_problem,
)
from sunode_torch.ops.bdf import BDFOptions
from sunode_torch.ops.bdf_batched import bdf_solve_batched
from sunode_torch.wrappers.as_torch import make_batched_solve_fn

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
RTOL = 1e-8
TVALS = np.linspace(1.0, 8.0, 6)
SHORT_ADJ = dict(rtol=1e-6, atol=1e-6)  # backward tolerances of the smaller cases


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The batched LU of a few 2x2 matrices is slower on many CPU threads
    than on one; restored afterwards."""
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


@functools.lru_cache(maxsize=None)
def _recorded(save_steps, hermite_order, thinning):
    """Both packages' forward solve of 6 LV lanes with recording."""
    y0s, ps = _lv6()
    opts = dict(rtol=RTOL, atol=RTOL, save_steps=save_steps, hermite_order=hermite_order,
                checkpoint_thinning=thinning)
    jp = _jax_lv()
    jres = jax.jit(
        lambda y, p: jax_solve(
            jp.make_rhs(), jp.make_jac_dense(), 0.0, y, p, jnp.asarray(TVALS), JaxOptions(**opts)
        )
    )(jnp.asarray(y0s), jnp.asarray(ps))
    tp = lv_problem()
    tres = bdf_solve_batched(
        tp.make_rhs(), tp.make_jac_dense(), 0.0, torch.as_tensor(y0s), torch.as_tensor(ps),
        torch.as_tensor(TVALS), BDFOptions(**opts), batched_fns=True,
    )
    return jres, tres


def _np_saved(saved):
    return {k: np.array(v) for k, v in saved.items()}


# ---- recording ---------------------------------------------------------------
@pytest.mark.parametrize(
    "save_steps, order, thinning",
    [(16, 5, True), (1024, 3, True), (16, 3, False)],
    ids=["16-quintic", "1024-cubic", "16-legacy"],
)
def test_recording_matches_jax(save_steps, order, thinning):
    jres, tres = _recorded(save_steps, order, thinning)
    js, ts = _np_saved(jres.saved), {k: v.numpy() for k, v in tres.saved.items()}
    assert sorted(ts) == sorted(js)
    assert ("fd" in ts) == ("L" in ts) == (order == 5)
    np.testing.assert_array_equal(tres.status.numpy(), np.asarray(jres.status))
    np.testing.assert_array_equal(ts["n_saved"], js["n_saved"])
    np.testing.assert_array_equal(ts["overflow"], js["overflow"])
    levels = tres.stats["checkpoint_thinning_levels"]
    assert levels == int(jres.stats["checkpoint_thinning_levels"])
    if save_steps == 16 and thinning:
        assert levels >= 2 and not ts["overflow"].any()
    if not thinning:
        assert ts["overflow"].all()  # the legacy buffer clamps, every lane overflows
    np.testing.assert_array_equal(tres.stats["n_rhs_evals"].numpy(), np.asarray(jres.stats["n_rhs_evals"]))
    # the same rows hold data and pads, and the data agree normwise (max
    # |a - b| over max |b| per key): the step counts are equal, but the step
    # sizes drift by ~1e-7 relative, the ulp differences of ROADMAP C2
    # magnified by the order selection.  Measured worst over the three cases:
    # t 2.2e-7, y 1.7e-7, f 2.0e-7, fd 1.7e-7, L 6.1e-8.
    for key in ("t", "y", "f", "yf", "fd", "L"):
        if key in js:
            finite = np.isfinite(js[key])
            np.testing.assert_array_equal(np.isfinite(ts[key]), finite, err_msg=key)
            a, b = ts[key][finite], js[key][finite]
            err = np.max(np.abs(a - b)) / np.max(np.abs(b))
            assert err <= 1e-6, (key, err)


# ---- evaluators ----------------------------------------------------------------
# the recorded tables the evaluators and the backward read: quintic rows
# thinned to 16 slots, cubic rows in 1024
TABLES = {5: (16, 5, True), 3: (1024, 3, True)}


def _query_times(ts, n_saved, rng):
    """Per lane: the first and last recorded rows, a quarter of the last
    interval past the last row, interior nodes, points between nodes and
    seeded uniform times, as (m, B) query sets."""
    lanes = np.arange(ts.shape[1])
    last, before = ts[n_saved - 1, lanes], ts[n_saved - 2, lanes]
    sets = [ts[0], last, last + 0.25 * (last - before)]
    for _ in range(3):
        k = rng.integers(1, n_saved - 1)
        sets.append(ts[k, lanes])
        sets.append(ts[k, lanes] + rng.uniform(0, 1, len(lanes)) * (ts[k + 1, lanes] - ts[k, lanes]))
    sets.append(rng.uniform(ts[0], last))
    return np.stack(sets)


@pytest.mark.parametrize(
    "kind, order",
    [("hermite", 5), ("hermite", 3), ("polynomial", 5), ("polynomial", 3)],
    ids=["hermite-quintic", "hermite-cubic", "polynomial-quintic-rows", "polynomial-cubic-rows"],
)
def test_evaluators_match_jax(kind, order):
    """The JAX package's recorded table, through numpy, into both packages'
    evaluators.  Every fourth row's L is raised so that h L > 1 on its two
    intervals: the quintic gate is exercised on both sides."""
    jres, _ = _recorded(*TABLES[order])
    saved = _np_saved(jres.saved)
    if "L" in saved:
        saved["L"] = saved["L"].copy()
        saved["L"][2::4] = 1e6
        h = np.diff(saved["t"], axis=0)
        gated = h * np.maximum(saved["L"][:-1], saved["L"][1:]) <= 1.0
        assert gated.any() and (~gated & np.isfinite(h)).any()
    make_jax, make_torch = {
        "hermite": (jax_hermite, make_hermite_eval_batched),
        "polynomial": (jax_polynomial, make_polynomial_eval_batched),
    }[kind]
    j_at = make_jax({k: jnp.asarray(v) for k, v in saved.items()})
    t_at = make_torch({k: torch.as_tensor(v) for k, v in saved.items()})
    queries = _query_times(saved["t"], saved["n_saved"], np.random.default_rng(order))
    for t in queries:
        want = np.asarray(j_at(jnp.asarray(t)))
        got = t_at(torch.as_tensor(t)).numpy()
        assert got.shape == want.shape == (2, t.shape[0])
        # measured: hermite bit for bit, polynomial 4.8e-16 relative
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


@pytest.mark.parametrize("S", [1024, 16384])
def test_searchsorted_matches_jax(S):
    """Equal integers: below the first row, on and between rows, at and past
    the last finite row, at +inf pads and at NaN; the reference sums a
    comparison at S <= 8192 and bisects above."""
    rng = np.random.default_rng(S)
    B = 6
    ts = np.full((S, B), np.inf)
    queries = []
    for b in range(B):
        m = int(rng.integers(1, S + 1)) if b else S  # lane 0 has no pad
        ts[:m, b] = np.sort(rng.uniform(0.0, 10.0, m))
    finite = np.where(np.isfinite(ts), ts, -np.inf).max(axis=0)
    queries = [ts[0] - 1.0, ts[0], finite, finite + 1.0, np.full(B, np.inf),
               np.full(B, np.nan), ts[S // 3], rng.uniform(0.0, 10.0, B)]
    ts_rows = torch.as_tensor(ts).T.contiguous()
    for t in queries:
        want = np.asarray(jax_searchsorted(jnp.asarray(ts), jnp.asarray(t)))
        got = _searchsorted_b(ts_rows, torch.as_tensor(t)).numpy()
        np.testing.assert_array_equal(got, want)


# ---- the backward solve alone ------------------------------------------------------
@pytest.mark.parametrize("interpolation", ["hermite", "polynomial"])
def test_backward_matches_jax(interpolation):
    """The JAX package's table into both packages' backward solves."""
    jres, _ = _recorded(*TABLES[5 if interpolation == "hermite" else 3])
    _, ps = _lv6()
    grads = np.random.default_rng(11).standard_normal((6, len(TVALS), 2))
    jp, tp = _jax_lv(), lv_problem()
    jadj = jax.jit(
        lambda g, p: jax_backward(
            jp.make_adjoint_rhs(), jp.make_adjoint_jac_dense(), jp.make_adjoint_quad_rhs(),
            jres.saved, 0.0, jnp.asarray(TVALS), g, p, 2, JaxOptions(**SHORT_ADJ),
            interpolation=interpolation,
        )
    )(jnp.asarray(grads), jnp.asarray(ps))
    tadj = adjoint_backward_batched(
        tp.make_adjoint_rhs(), tp.make_adjoint_jac_dense(), tp.make_adjoint_quad_rhs(),
        {k: torch.as_tensor(v) for k, v in _np_saved(jres.saved).items()}, 0.0,
        torch.as_tensor(TVALS), torch.as_tensor(grads), torch.as_tensor(ps), 2,
        BDFOptions(**SHORT_ADJ), interpolation=interpolation,
    )
    np.testing.assert_array_equal(tadj.status.numpy(), np.asarray(jadj.status))
    assert (tadj.status == 0).all()
    # measured: n_backward_steps equal (396 and 323 attempts); lam 2.8e-11,
    # quad 1.1e-12 relative
    np.testing.assert_allclose(
        tadj.stats["n_backward_steps"].numpy(), np.asarray(jadj.stats["n_backward_steps"]),
        rtol=0, atol=2,
    )
    np.testing.assert_allclose(tadj.lamda.numpy(), np.asarray(jadj.lamda), rtol=1e-9)
    np.testing.assert_allclose(tadj.quad.numpy(), np.asarray(jadj.quad), rtol=1e-9)


def test_backward_raises_on_what_is_not_ported():
    jres, _ = _recorded(*TABLES[5])
    saved = {k: torch.as_tensor(v) for k, v in _np_saved(jres.saved).items()}
    tp = lv_problem()
    args = (tp.make_adjoint_rhs(), tp.make_adjoint_jac_dense(), tp.make_adjoint_quad_rhs(),
            saved, 0.0, torch.as_tensor(TVALS), torch.zeros((6, 6, 2), dtype=torch.float64),
            torch.ones((6, 4), dtype=torch.float64), 2)
    # ADAMS is ported (tests/test_torch_adams_checkpoint.py); 'resolve'
    # needs it, and the forward's rhs and y_end, as in the reference
    with pytest.raises(NotImplementedError, match="requires method='ADAMS'"):
        adjoint_backward_batched(*args, interpolation="resolve")
    with pytest.raises(ValueError, match="requires rhs and y_end"):
        adjoint_backward_batched(*args, method="ADAMS", interpolation="resolve")
    with pytest.raises(ValueError, match="interpolation"):
        adjoint_backward_batched(*args, interpolation="linear")


# ---- the default call end to end -----------------------------------------------------
def _golden():
    return np.load(os.path.join(GOLDEN, "lv_adjoint.npz"))


def _jax_grads(solve, g, y0s, p_subs, tvals):
    def loss(t0, y0s, p_subs, tvals):
        return jnp.sum(solve(t0, y0s, p_subs, jnp.asarray(g["p_fix"]), tvals) ** 2)

    out = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        0.0, jnp.asarray(y0s), jnp.asarray(p_subs), jnp.asarray(tvals)
    )
    return [np.asarray(a) for a in out]


def _torch_grads(solve, g, y0s, p_subs, tvals):
    """(d_t0, gy, gp, d_tvals) of sum(ys**2), and ys."""
    leaves = [torch.tensor(0.0, dtype=torch.float64, requires_grad=True),
              torch.as_tensor(y0s).requires_grad_(), torch.as_tensor(p_subs).requires_grad_(),
              torch.as_tensor(tvals).requires_grad_()]
    ys = solve(leaves[0], leaves[1], leaves[2], torch.as_tensor(g["p_fix"]), leaves[3])
    return [a.numpy() for a in torch.autograd.grad(torch.sum(ys**2), leaves)], ys.detach().numpy()


@pytest.mark.parametrize("interpolation", ["hermite", "polynomial"])
def test_default_call_matches_jax_and_golden(interpolation):
    """``make_batched_solve_fn(problem)`` with rtol = atol = 1e-8 on the 16
    lanes of lv_adjoint.npz: every other argument at its default (BDF,
    checkpoint_n 1024, backward tolerances 1e-10), 'polynomial' the one
    change for that case."""
    g = _golden()
    kw = {} if interpolation == "hermite" else dict(adjoint_interpolation=interpolation)
    jsolve = jax_make(_jax_lv(), options=JaxOptions(rtol=RTOL, atol=RTOL), **kw)
    want = _jax_grads(jsolve, g, g["y0s"], g["p_subs"], g["tvals"])
    tsolve = make_batched_solve_fn(lv_problem(), options=BDFOptions(rtol=RTOL, atol=RTOL), **kw)
    got, _ = _torch_grads(tsolve, g, g["y0s"], g["p_subs"], g["tvals"])
    stats = tsolve.last_stats
    assert stats["forward"]["checkpoint_thinning_levels"] == 0
    assert (stats["backward"]["status"] == 0).all() and stats["backward"]["n_attempts"] > 0
    # the golden gate of tests/test_golden.py::test_lv_adjoint_gradients_golden;
    # measured: 3.6e-5 (gy) and 4.5e-6 (gp) relative in both modes
    np.testing.assert_allclose(got[1], g["gy"], rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(got[2], g["gp"], rtol=2e-3, atol=1e-3)
    # measured (hermite / polynomial): d_t0 1.7e-10 / 2.5e-11, gy 3.6e-9 /
    # 4.4e-10, gp 2.3e-9 / 3.4e-10, d_tvals 9.2e-13 / 9.2e-13 relative
    for name, a, b in zip(("d_t0", "gy", "gp", "d_tvals"), got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=name)


# ---- failures -------------------------------------------------------------------
def test_failure_lane_poisons_only_itself():
    """p_sub = [1e8, -1e8] blows lane 1 up (step underflow after ~770
    steps); its ys and gradients are NaN, the shared d_tvals and d_t0 too,
    and the other lanes' ys and gradients are bit for bit those of a solve
    without it (each lane's arithmetic is its own; the lockstep loop only
    runs longer).  Polynomial interpolation: no fdot rows to record over
    the blown-up lane's ~800 attempts."""
    g = _golden()
    y0s, p_subs = g["y0s"][:3], g["p_subs"][:3].copy()
    p_subs[1] = [1e8, -1e8]
    tvals = g["tvals"][:3]
    solve = make_batched_solve_fn(lv_problem(), options=BDFOptions(rtol=RTOL, atol=RTOL, max_steps=2000),
                                  adjoint_options=BDFOptions(**SHORT_ADJ),
                                  adjoint_interpolation="polynomial")
    got, ys = _torch_grads(solve, g, y0s, p_subs, tvals)
    fatal = solve.last_stats["forward"]["error_order"] >= 0
    assert fatal.tolist() == [False, True, False]
    assert solve.last_stats["backward"]["status"].tolist() == [0, 3, 0]
    alone, ys_alone = _torch_grads(solve, g, y0s[[0, 2]], p_subs[[0, 2]], tvals)
    assert np.isnan(ys[1]).all()
    np.testing.assert_array_equal(ys[[0, 2]], ys_alone)
    for a, b in zip(got[1:3], alone[1:3]):
        assert np.isnan(a[1]).all() and np.isfinite(b).all()
        np.testing.assert_array_equal(a[[0, 2]], b)
    for shared in (0, 3):  # d_t0 and d_tvals sum over every lane
        assert np.isnan(got[shared]).all() and np.isfinite(alone[shared]).all()


def test_legacy_overflow_gives_status_99_and_nan():
    """Without thinning a 16-slot recording overflows in every lane: the
    backward flags it 99 and every gradient is NaN, as in the reference."""
    y0s, ps = _lv6()
    _, tres = _recorded(16, 3, False)
    assert tres.saved["overflow"].all()
    tp = lv_problem()
    adj = adjoint_backward_batched(
        tp.make_adjoint_rhs(), tp.make_adjoint_jac_dense(), tp.make_adjoint_quad_rhs(),
        tres.saved, 0.0, torch.as_tensor(TVALS), torch.ones((6, len(TVALS), 2), dtype=torch.float64),
        torch.as_tensor(ps), 2, BDFOptions(rtol=1e-6, atol=1e-6),
    )
    assert (adj.status == 99).all()
    assert torch.isnan(adj.lamda).all() and torch.isnan(adj.quad).all()


def test_robertson_reproduces_the_reference_status_3():
    """The default call on Robertson (robertson.npz lanes 0-1, the bench's
    options, cotangents on species a): the reference records the forward
    without overflow, and its backward ends BAD_INIT (status 3) after one
    step of the first interval in every lane, so every gradient is NaN.  The
    port's backward on the same table does the same."""
    r = np.load(os.path.join(GOLDEN, "robertson.npz"))
    y0s, ps = np.tile(r["y0"], (2, 1)), r["ps"][:2]
    grads = np.zeros((2, len(r["tvals"]), 3))
    grads[:, :, 0] = 1.0
    jp = JaxSympyProblem(
        params={"k1": (), "k2": (), "k3": ()}, states={"a": (), "b": (), "c": ()},
        rhs_sympy=_robertson, derivative_params=[("k1",), ("k2",), ("k3",)],
    )
    jopts = JaxOptions(rtol=1e-8, atol=jnp.asarray(robertson_options().atol), save_steps=1024)

    @jax.jit
    def jax_run(y, p):
        res = jax_solve(jp.make_rhs(), jp.make_jac_dense(), 0.0, y, p, jnp.asarray(r["tvals"]), jopts)
        adj = jax_backward(
            jp.make_adjoint_rhs(), jp.make_adjoint_jac_dense(), jp.make_adjoint_quad_rhs(),
            res.saved, 0.0, jnp.asarray(r["tvals"]), jnp.asarray(grads), p, 3,
        )
        return res.status, res.saved, adj

    jstatus, saved, jadj = jax_run(jnp.asarray(y0s), jnp.asarray(ps))
    assert np.asarray(jstatus).tolist() == [0, 0] and not np.asarray(saved["overflow"]).any()
    assert np.asarray(jadj.status).tolist() == [3, 3]
    assert np.asarray(jadj.stats["n_backward_steps"]).tolist() == [1, 1]
    assert np.isnan(np.asarray(jadj.lamda)).all() and np.isnan(np.asarray(jadj.quad)).all()
    tp = robertson_problem()
    tadj = adjoint_backward_batched(
        tp.make_adjoint_rhs(), tp.make_adjoint_jac_dense(), tp.make_adjoint_quad_rhs(),
        {k: torch.as_tensor(v) for k, v in _np_saved(saved).items()}, 0.0,
        torch.as_tensor(r["tvals"]), torch.as_tensor(grads), torch.as_tensor(ps), 3,
    )
    np.testing.assert_array_equal(tadj.status.numpy(), np.asarray(jadj.status))
    np.testing.assert_array_equal(
        tadj.stats["n_backward_steps"].numpy(), np.asarray(jadj.stats["n_backward_steps"])
    )
    assert torch.isnan(tadj.lamda).all() and torch.isnan(tadj.quad).all()


# ---- the primal, and the entry point ------------------------------------------------
def test_primal_without_gradients_records_nothing():
    """Under ``torch.no_grad()``, or with no input that requires grad, the
    adjoint-mode solve is the primal: the same ys as ``derivatives=None``,
    and the forward records no checkpoints."""
    g = _golden()
    args = (0.0, torch.as_tensor(g["y0s"][:4]), torch.as_tensor(g["p_subs"][:4]),
            torch.as_tensor(g["p_fix"]), torch.as_tensor(g["tvals"][:2]))
    opts = BDFOptions(rtol=RTOL, atol=RTOL)
    plain = make_batched_solve_fn(lv_problem(), derivatives=None, options=opts)(*args)
    solve = make_batched_solve_fn(lv_problem(), options=opts)
    with torch.no_grad():
        y0 = args[1].clone().requires_grad_()
        ys = solve(args[0], y0, *args[2:])
    assert torch.equal(ys, plain)
    assert "checkpoint_thinning_levels" not in solve.last_stats["forward"]
    ys = solve(*args)  # nothing requires grad
    assert torch.equal(ys, plain) and not ys.requires_grad
    assert "checkpoint_thinning_levels" not in solve.last_stats["forward"]


def test_build_lv_checkpointed_is_the_default_call():
    step, (y0s, p_subs) = build_lv_checkpointed(3, 4, 1e-6, device="cpu")
    solve = step.solve
    assert (solve.method, solve.derivatives, solve.interpolation) == ("BDF", "adjoint", "hermite")
    assert solve.options.save_steps == 0 and solve.fwd_options.save_steps == 1024
    assert solve.fwd_options.hermite_order == 5 and solve.adjoint_options.rtol == 1e-10
    poly = build_lv_checkpointed(3, 4, 1e-6, interpolation="polynomial", device="cpu")[0].solve
    assert poly.interpolation == "polynomial" and poly.fwd_options.hermite_order == 3
    assert y0s.shape == p_subs.shape == (3, 2) and step.tvals.shape == (4,)
