"""sunode_torch's differentiable events against sunode_tpu's.

The cases of ``tests/test_event_grads.py`` and ``tests/test_hybrid_events.py``
through ``sunode_torch.events``: the bouncing ball's impact times, states and
their gradients against the closed forms at the reference tests'
tolerances; event times within 1e-9 relative of the reference's and
gradients within 1e-6 of ``jax.grad`` of the reference's (one JAX reference
for the event function, its ``vmap`` over four heights, and one for the
hybrid solve under ``vmap`` over four (h0, e), each built once in the
module); ``AdjointSolver(roots=...)`` against the reference's; the lane
loop ``map_lanes`` held to the reference's ``vmap`` lane by lane;
structured ('band' and 'sparse') events, the localization sharing its
differentiable solve's sparse plans, bit for bit plans of its own.
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunode_tpu.events import make_event_fn as jax_make_event_fn
from sunode_tpu.events import make_hybrid_solve_fn as jax_make_hybrid_solve_fn
from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_tpu.problem import JaxProblem
from sunode_tpu.symode import SympyProblem as JaxSympyProblem
from sunode_torch import SympyProblem, TorchProblem
from sunode_torch.entry import ball_hybrid_problem, build_ball_hybrid
from sunode_torch.events import make_event_fn, make_hybrid_solve_fn, map_lanes
from sunode_torch.ops.bdf import BDFOptions
from sunode_torch.solver import AdjointSolver
from sunode_torch.wrappers import as_torch
from sunode_torch.wrappers.as_torch import make_solve_fn

jax.config.update("jax_enable_x64", True)

OPTS = BDFOptions(rtol=1e-10, atol=1e-12)
JOPTS = JaxOptions(rtol=1e-10, atol=1e-12)
H, G = 2.0, 9.81
HS = (0.5, 1.0, 2.0, 4.0)  # the reference's vmap heights
F64 = dict(dtype=torch.float64)
P_FIX = torch.zeros(0, **F64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The single cores' tensors are a few values each: one CPU thread is
    faster than many; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fall(t, y, p):
    return {"x": y.v, "v": -p.g}


def _drag_rhs(t, y, p):
    return {"x": y.v, "v": -p.g - p.c * y.v}


def _roots(t, y, p):
    return [y.x]


def _ball(cls=SympyProblem):
    return cls(params={"g": ()}, states={"x": (), "v": ()}, rhs_sympy=_fall,
               derivative_params=[("g",)])


@pytest.fixture(scope="module")
def ball():
    return _ball()


def _closed_forms():
    t_star = np.sqrt(2 * H / G)
    return dict(t_star=t_star, dt_dg=-t_star / (2 * G), dt_dh=1.0 / (G * t_star),
                v_star=-G * t_star, dv_dg=-t_star / 2, dv_dh=-1.0 / t_star)


def _t(*v):
    return torch.tensor(v, **F64)


def _event_grads(event, y0, p_sub, t_max=3.0, out=lambda r: r[0]):
    """The event output ``out`` and its gradients to p_sub and y0."""
    y = y0.clone().requires_grad_(True)
    p = p_sub.clone().requires_grad_(True)
    val = out(event(0.0, y, p, P_FIX, t_max))
    return val.detach(), *torch.autograd.grad(val, (p, y))


@functools.cache
def _jax_event_lanes():
    """The reference's event function (forward derivatives) under ``vmap``
    over the heights HS: t* and its gradients to g and y0, a lane each."""
    event = jax_make_event_fn(_ball(JaxSympyProblem), _roots, options=JOPTS)

    def t_of(p_sub, y0):
        return event(0.0, y0, p_sub, jnp.zeros((0,)), 3.0)[0]

    y0s = jnp.stack([jnp.asarray(HS), jnp.zeros(len(HS))], axis=1)
    f = jax.jit(jax.vmap(jax.value_and_grad(t_of, argnums=(0, 1)), in_axes=(None, 0)))
    t, (gp, gy) = f(jnp.array([G]), y0s)
    return np.asarray(t), np.asarray(gp), np.asarray(gy)


# ---- tests/test_event_grads.py ------------------------------------------------------
@pytest.mark.parametrize("derivatives", ["forward", "adjoint"])
def test_impact_time_gradients_closed_form(ball, derivatives):
    event = make_event_fn(ball, _roots, options=OPTS, derivatives=derivatives, device="cpu")
    cf = _closed_forms()
    t_ev, dg, dy0 = _event_grads(event, _t(H, 0.0), _t(G))
    assert abs(float(t_ev) - cf["t_star"]) < 1e-8
    assert abs(float(dg[0]) - cf["dt_dg"]) < 1e-6
    assert abs(float(dy0[0]) - cf["dt_dh"]) < 1e-6
    assert abs(float(dy0[1]) - 1.0 / G) < 1e-6
    # against the reference's lane at h0 = H
    jt, jgp, jgy = _jax_event_lanes()
    lane = HS.index(H)
    assert abs(float(t_ev) - jt[lane]) <= 1e-9 * abs(jt[lane])
    np.testing.assert_allclose(dg.numpy(), jgp[lane], rtol=1e-6, atol=0)
    np.testing.assert_allclose(dy0.numpy(), jgy[lane], rtol=1e-6, atol=1e-12)


def test_impact_state_gradients_closed_form(ball):
    event = make_event_fn(ball, _roots, options=OPTS, device="cpu")
    cf = _closed_forms()
    v, dg, dy0 = _event_grads(event, _t(H, 0.0), _t(G), out=lambda r: r[1][1])
    assert abs(float(v) - cf["v_star"]) < 1e-7
    assert abs(float(dg[0]) - cf["dv_dg"]) < 1e-6
    assert abs(float(dy0[0]) - cf["dv_dh"]) < 1e-6
    # the impact position is identically 0: zero gradient
    _, dx, _ = _event_grads(event, _t(H, 0.0), _t(G), out=lambda r: r[1][0])
    assert abs(float(dx[0])) < 1e-6


def test_impact_time_matches_central_fd_nonlinear():
    """Drag makes the closed form disappear; central FD is the oracle."""
    prob = SympyProblem(params={"g": (), "c": ()}, states={"x": (), "v": ()},
                        rhs_sympy=_drag_rhs, derivative_params=[("g",), ("c",)])
    event = make_event_fn(prob, _roots, options=OPTS, device="cpu")
    y0, p0 = _t(H, 0.0), _t(G, 0.3)
    _, grad, _ = _event_grads(event, y0, p0)
    eps = 1e-6
    for k in range(2):
        dp = torch.zeros(2, **F64)
        dp[k] = eps
        fd = (float(event(0.0, y0, p0 + dp, P_FIX, 3.0)[0])
              - float(event(0.0, y0, p0 - dp, P_FIX, 3.0)[0])) / (2 * eps)
        assert abs(float(grad[k]) - fd) < 1e-5 * max(1.0, abs(fd)), (k, grad[k], fd)


def test_event_lanes_match_the_reference_vmap(ball):
    """The lane loop over four heights, with each lane's gradients, against
    the reference's ``vmap`` of ``jax.value_and_grad`` lane by lane, and the
    closed form sqrt(2 h / g)."""
    event = make_event_fn(ball, _roots, options=OPTS, device="cpu")
    y0s = torch.stack([_t(*HS), torch.zeros(len(HS), **F64)], dim=1).requires_grad_(True)
    p = _t(G).requires_grad_(True)
    ts = map_lanes(lambda y0: event(0.0, y0, p, P_FIX, 3.0)[0], y0s, in_dims=(0,))
    assert ts.shape == (len(HS),)
    np.testing.assert_allclose(ts.detach().numpy(), np.sqrt(2 * np.asarray(HS) / G), atol=1e-8)
    jt, jgp, jgy = _jax_event_lanes()
    np.testing.assert_allclose(ts.detach().numpy(), jt, rtol=1e-9, atol=0)
    for lane in range(len(HS)):
        gp, gy = torch.autograd.grad(ts[lane], (p, y0s), retain_graph=True)
        np.testing.assert_allclose(gp.numpy(), jgp[lane], rtol=1e-6, atol=0)
        np.testing.assert_allclose(gy[lane].numpy(), jgy[lane], rtol=1e-6, atol=1e-12)
        assert not gy[np.arange(len(HS)) != lane].any()  # each lane's own solve


def test_event_fn_validation_and_no_root(ball):
    with pytest.raises(ValueError, match="root_terminal=False"):
        make_event_fn(ball, _roots, which=1)
    with pytest.raises(ValueError, match="root_cap"):
        make_event_fn(ball, _roots, which=9, root_terminal=False)
    with pytest.raises(ValueError, match="solver must be"):
        make_event_fn(ball, _roots, solver="RK", device="cpu")
    # no root in [0, t_max]: inf time, NaN state, zero gradient (the
    # reference's masked placeholders), not a crash
    event = make_event_fn(ball, _roots, options=OPTS, device="cpu")
    p = _t(0.01).requires_grad_(True)
    t_ev, y_ev = event(0.0, _t(H, 0.0), p, P_FIX, 0.5)
    assert np.isinf(float(t_ev.detach())) and torch.isnan(y_ev).all()
    (g,) = torch.autograd.grad(t_ev, p)
    assert float(g[0]) == 0.0


@pytest.mark.parametrize("kinds", [("BDF", "BDF"), ("ADAMS", "ADAMS")])
def _terminal_event_run(kinds, side):
    """tests/test_event_grads.py:152's case on ``side`` ('port', or 'jax'
    with ``native_single=False``): the drag ball's ``AdjointSolver(roots=
    ...)`` forward to the terminal impact and the backward of the
    pre-impact sum of x(t_i)^2, ``(solver, ys, stats, quad, lamda)``."""
    from sunode_tpu.solver import AdjointSolver as JaxAdjointSolver

    spec = dict(params={"g": (), "c": ()}, states={"x": (), "v": ()}, rhs_sympy=_drag_rhs,
                derivative_params=[("g",), ("c",)])
    cls, problem, extra = ((AdjointSolver, SympyProblem, dict(device="cpu")) if side == "port"
                           else (JaxAdjointSolver, JaxSympyProblem, dict(native_single=False)))
    solver, adjoint_solver = kinds
    s = cls(problem(**spec), abstol=1e-10, reltol=1e-10, roots=_roots, solver=solver,
            adjoint_solver=adjoint_solver, **extra)
    s.set_params_dict({"g": G, "c": 0.3})
    ys = np.asarray(s.solve_forward(0.0, TERMINAL_TVALS, np.array([H, 0.0])))
    stats = {k: np.asarray(v) for k, v in s.last_stats.items()}
    grads = 2.0 * ys
    grads[:, 1] = 0.0  # the loss reads x only; the NaN rows past the impact stay
    quad, lam = s.solve_backward(TERMINAL_TVALS[-1], 0.0, TERMINAL_TVALS, grads)
    return s, ys, stats, np.asarray(quad), np.asarray(lam)


TERMINAL_TVALS = np.array([0.2, 0.4, 0.8, 1.0])  # the drag ball's impact at ~0.65 s


@pytest.mark.parametrize("kinds", [("BDF", "BDF"), ("ADAMS", "ADAMS")])
def test_adjoint_solver_with_terminal_event(kinds):
    """AdjointSolver(roots=...) stops the recording at the terminal root;
    solve_backward zeroes the post-impact cotangent rows and returns the
    gradient of the pre-impact observable: ys, the root record, quad and
    lambda against the reference's ``AdjointSolver(roots=...,
    native_single=False)`` on the same inputs (ys/quad/lambda 1e-6, the
    root time 1e-9 relative); pickling keeps the event."""
    s, ys, st, quad, lam = _terminal_event_run(kinds, "port")
    _, jys, jst, jquad, jlam = _terminal_event_run(kinds, "jax")
    assert int(st["n_roots"]) == 1 == int(jst["n_roots"])
    t_root = float(st["roots_t"][0])
    assert 0.4 < t_root < 0.8
    assert abs(t_root - float(jst["roots_t"][0])) <= 1e-9 * t_root
    assert np.isfinite(ys[:2]).all() and np.isnan(ys[2:]).all()
    np.testing.assert_allclose(ys, jys, rtol=1e-6, atol=1e-11)  # NaN where the reference's is
    assert np.isfinite(quad).all() and np.isfinite(lam).all()
    np.testing.assert_allclose(quad, jquad, rtol=1e-6, atol=0)
    np.testing.assert_allclose(lam, jlam, rtol=1e-6, atol=0)

    s2 = pickle.loads(pickle.dumps(s))
    s2.solve_forward(0.0, TERMINAL_TVALS, np.array([H, 0.0]))
    assert abs(float(s2.last_stats["roots_t"][0]) - t_root) < 1e-12


def test_second_root_nonterminal():
    """which=1 on a recording solve: the oscillator's second zero of x."""
    prob = SympyProblem(params={"w": ()}, states={"x": (), "v": ()},
                        rhs_sympy=lambda t, y, p: {"x": y.v, "v": -p.w * p.w * y.x},
                        derivative_params=[("w",)])
    event = make_event_fn(prob, _roots, which=1, root_terminal=False, options=OPTS,
                          device="cpu")
    w = 1.3
    t2, dw, _ = _event_grads(event, _t(1.0, 0.0), _t(w), t_max=6.0)
    t_expect = 3 * np.pi / (2 * w)  # x = cos(w t): zeros at (k + 1/2) pi / w
    assert abs(float(t2) - t_expect) < 1e-8
    assert abs(float(dw[0]) - (-t_expect / w)) < 1e-6


# ---- structured events, and the sparse plans shared ----------------------------------
STRUCTURED = [("band", dict(lower_bandwidth=1, upper_bandwidth=1)), ("sparse", None)]


class _OwnPlans:
    """The event core's differentiable solve with the localization's Newton
    structure from a setup of its own: ``jac`` and ``options`` from a
    second :func:`make_solve_fn` (its own sparse plans), the calls and
    stats the first's."""

    def __init__(self, problem, **kw):
        self.inner = make_solve_fn(problem, **kw)
        own = make_solve_fn(problem, **kw)
        self.jac, self.options, self.last_stats = own.jac, own.options, self.inner.last_stats

    def __call__(self, *args):
        return self.inner(*args)


@pytest.mark.parametrize("linear_solver,kwargs", STRUCTURED)
def test_structured_events_and_shared_plans(linear_solver, kwargs, monkeypatch):
    """'band' and 'sparse' give the event the dense solver's value and
    gradients (and the closed forms); an event or hybrid function builds
    the sparse plans once (two plans, the pattern's and its transpose's),
    the localization sharing its differentiable solve's, and every result
    is bit for bit that of a localization on plans of its own."""
    from sunode_torch import events
    from sunode_torch.ops import sparsity

    def run(problem):
        event = make_event_fn(problem, _roots, options=OPTS, linear_solver=linear_solver,
                              linear_solver_kwargs=kwargs, device="cpu")
        return [v.numpy() for v in _event_grads(event, _t(H, 0.0), _t(G))]

    dense = run(_ball())
    cf = _closed_forms()
    built = []
    real_plan = sparsity.SparsePlan

    def counting_plan(*args, **kw):
        built.append(1)
        return real_plan(*args, **kw)

    monkeypatch.setattr(sparsity, "SparsePlan", counting_plan)
    plans = 2 if linear_solver == "sparse" else 0
    problem = _ball()
    shared = run(problem)
    assert len(built) == plans
    make_hybrid_solve_fn(problem, _roots, lambda t, y, p: {"x": y.x, "v": -y.v}, max_events=1,
                         linear_solver=linear_solver, linear_solver_kwargs=kwargs, device="cpu")
    assert len(built) == 2 * plans
    for a, b in zip(shared, dense):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)
    assert abs(float(shared[0]) - cf["t_star"]) < 1e-8
    assert abs(float(shared[1][0]) - cf["dt_dg"]) < 1e-6

    monkeypatch.setattr(events, "make_solve_fn", _OwnPlans)
    own = run(_ball())
    assert len(built) == 4 * plans
    for a, b in zip(own, shared):
        assert a.tobytes() == b.tobytes()


# ---- tests/test_hybrid_events.py ----------------------------------------------------
def _ball_hybrid(max_events=3, **kw):
    kw.setdefault("options", OPTS)
    return make_hybrid_solve_fn(
        ball_hybrid_problem(), roots=lambda t, y, p: torch.stack([y.h]),
        jump_fn=lambda t, y, p: {"h": y.h, "v": -p.e * y.v}, max_events=max_events,
        root_directions=[-1], device="cpu", **kw,
    )


def _closed_form(h0, g, e, K):
    """Impact times t_1..t_K and a trajectory evaluator (the reference
    test's)."""
    t1 = np.sqrt(2.0 * h0 / g)
    v1 = g * t1
    ts = [t1]
    for k in range(1, K):
        ts.append(ts[-1] + 2.0 * (e**k) * v1 / g)
    ts = np.array(ts)

    def traj(t):
        t = np.asarray(t, float)
        h = np.where(t <= t1, h0 - 0.5 * g * t**2, np.nan)
        v = np.where(t <= t1, -g * t, np.nan)
        for k in range(1, K + 1):
            tk = ts[k - 1]
            vk = (e**k) * v1
            dur = 2.0 * vk / g if k < K else np.inf
            m = (t > tk) & (t <= tk + dur)
            h = np.where(m, vk * (t - tk) - 0.5 * g * (t - tk) ** 2, h)
            v = np.where(m, vk - g * (t - tk), v)
        return h, v

    return ts, traj


def _final_state_closed_form(theta, t, K, g=G):
    """sum(y(t)**2) after the K-th impact, a torch expression of theta =
    (h0, e): its autograd gradient is the closed form's exact one."""
    h0, e = theta[0], theta[1]
    t1 = torch.sqrt(2 * h0 / g)
    tK = t1 * (1 + sum(2 * e**k for k in range(1, K)))
    vK = e**K * g * t1
    s = t - tK
    return (vK * s - 0.5 * g * s**2) ** 2 + (vK - g * s) ** 2


def _hybrid_loss(hybrid, theta, tvals):
    res = hybrid(0.0, torch.stack([theta[0], torch.zeros((), **F64)]),
                 torch.stack([torch.tensor(G, **F64), theta[1]]), P_FIX, tvals)
    return torch.sum(res.ys[-1] ** 2), res


SWEEP_E = (0.5, 0.7, 0.9)  # the reference's vmap sweep's restitutions
HYBRID_THETAS = ((1.0, 0.8),) + tuple((1.0, e) for e in SWEEP_E)  # (h0, e) a lane


@functools.cache
def _jax_hybrid():
    """The reference's hybrid solve (max_events=3, tvals linspace(0, 2.2,
    4)) under ``vmap`` over HYBRID_THETAS, in one compile: lane 0 the
    final-state case, lanes 1-3 the restitution sweep.  A lane each: the
    loss sum(y(2.2)**2), its gradient to (h0, e), and the result's fields."""
    problem = JaxProblem(params={"g": (), "e": ()}, states={"h": (), "v": ()},
                         rhs=lambda t, y, p: {"h": y.v, "v": -p.g},
                         derivative_params=[("g",), ("e",)])
    hybrid = jax_make_hybrid_solve_fn(
        problem, roots=lambda t, y, p: jnp.stack([y.h]),
        jump_fn=lambda t, y, p: {"h": y.h, "v": -p.e * y.v}, max_events=3,
        root_directions=[-1], options=JOPTS,
    )

    def loss(theta):
        res = hybrid(0.0, jnp.array([theta[0], 0.0]), jnp.array([G, theta[1]]), jnp.zeros(0),
                     jnp.linspace(0.0, 2.2, 4))
        return jnp.sum(res.ys[-1] ** 2), res

    f = jax.jit(jax.vmap(jax.value_and_grad(loss, has_aux=True)))
    (val, res), grad = f(jnp.array(HYBRID_THETAS))
    return np.asarray(val), np.asarray(grad), {k: np.asarray(v) for k, v in res._asdict().items()}


def test_bouncing_ball_three_impacts_match_closed_form():
    hybrid = _ball_hybrid(max_events=3)
    h0, g, e = 1.0, 9.81, 0.8
    ts_exact, traj = _closed_form(h0, g, e, 3)
    t_end = ts_exact[-1] + 0.3 * (ts_exact[-1] - ts_exact[-2])
    tvals = torch.linspace(0.0, float(t_end), 25, **F64)
    res = hybrid(0.0, _t(h0, 0.0), _t(g, e), P_FIX, tvals)
    assert int(res.n_events) == 3 and res.n_events.dtype == torch.int32
    np.testing.assert_allclose(res.event_ts.numpy(), ts_exact, atol=1e-8)
    v1 = g * ts_exact[0]
    v_minus = -(e ** np.arange(3)) * v1
    np.testing.assert_allclose(res.event_ys.numpy()[:, 0], 0.0, atol=1e-8)
    np.testing.assert_allclose(res.event_ys.numpy()[:, 1], v_minus, atol=1e-7)
    np.testing.assert_allclose(res.event_ys_post.numpy()[:, 1], -e * v_minus, atol=1e-7)
    h_exact, v_exact = traj(tvals.numpy())
    np.testing.assert_allclose(res.ys.numpy()[:, 0], h_exact, atol=1e-7)
    np.testing.assert_allclose(res.ys.numpy()[:, 1], v_exact, atol=1e-7)


def test_impact_time_gradients_match_closed_form_and_fd():
    hybrid = _ball_hybrid(max_events=3)
    h0, g, e = 1.0, 9.81, 0.8
    ts_exact, _ = _closed_form(h0, g, e, 3)
    tvals = torch.linspace(0.0, float(ts_exact[-1] + 0.2), 5, **F64)

    def t3(params):
        return hybrid(0.0, _t(h0, 0.0), params, P_FIX, tvals).event_ts[2]

    params = _t(g, e).requires_grad_(True)
    (grad,) = torch.autograd.grad(t3(params), params)
    s = 1.0 + 2 * e + 2 * e * e  # t3 = sqrt(2 h0 / g) (1 + 2e + 2e^2)
    np.testing.assert_allclose(grad.numpy(), [-0.5 * np.sqrt(2 * h0 / g) / g * s,
                                              np.sqrt(2 * h0 / g) * (2.0 + 4.0 * e)], rtol=1e-6)
    with torch.no_grad():
        for i, eps in [(0, 1e-5), (1, 1e-6)]:
            dp = torch.zeros(2, **F64)
            dp[i] = eps
            fd = (float(t3(_t(g, e) + dp)) - float(t3(_t(g, e) - dp))) / (2 * eps)
            assert np.isclose(float(grad[i]), fd, rtol=1e-5)


def test_final_state_gradient_through_three_impacts():
    """The final state's gradient through three impacts, to y0 and the
    jump map: jax.grad of the reference's within 1e-6 and the closed
    form's exact gradient within 1e-6 (the reference test's central FD at
    rtol 2e-4 is looser than either); the loss and ys the reference's,
    the event times within 1e-9 relative of its."""
    hybrid, (_, _, _, tvals) = build_ball_hybrid(3, device="cpu")
    theta = _t(*HYBRID_THETAS[0]).requires_grad_(True)
    loss, res = _hybrid_loss(hybrid, theta, tvals)
    (grad,) = torch.autograd.grad(loss, theta)
    assert torch.isfinite(grad).all() and int(res.n_events) == 3
    j_val, j_grad, j_res = _jax_hybrid()
    np.testing.assert_allclose(res.event_ts.detach().numpy(), j_res["event_ts"][0], rtol=1e-9,
                               atol=0)
    np.testing.assert_allclose(res.ys.detach().numpy(), j_res["ys"][0], rtol=1e-6, atol=1e-11)
    np.testing.assert_allclose(float(loss.detach()), j_val[0], rtol=1e-6, atol=0)
    np.testing.assert_allclose(grad.numpy(), j_grad[0], rtol=1e-6, atol=0)
    th = _t(*HYBRID_THETAS[0]).requires_grad_(True)
    (g_cf,) = torch.autograd.grad(_final_state_closed_form(th, 2.2, 3), th)
    np.testing.assert_allclose(grad.numpy(), g_cf.numpy(), rtol=1e-6, atol=0)


def test_lane_loop_restitution_sweep():
    """``map_lanes`` over three restitutions against the reference's
    ``vmap`` of its hybrid function over the same restitutions, lane by
    lane (ys 1e-6 / 1e-11, the event times 1e-9 relative, the event
    states 1e-6, the counts exactly; max_events=3 to 2.2, the final-state
    test's compile); the impact times of the closed forms, as the
    reference's sweep test holds them; each lane bit for bit its own
    call."""
    hybrid = _ball_hybrid(max_events=3)
    h0, g = 1.0, 9.81
    tvals = torch.linspace(0.0, 2.2, 4, **F64)
    es = _t(*SWEEP_E)

    def one(e):
        return hybrid(0.0, _t(h0, 0.0), torch.stack([torch.tensor(g, **F64), e]), P_FIX, tvals)

    res = map_lanes(one, es, in_dims=(0,))
    assert res.event_ts.shape == (3, 3) and res.ys.shape == (3, 4, 2)
    _, _, j_res = _jax_hybrid()
    for i, e in enumerate(SWEEP_E):
        lane = 1 + i  # HYBRID_THETAS' lane of this restitution
        assert int(res.n_events[i]) == int(j_res["n_events"][lane]) == 3
        np.testing.assert_allclose(res.event_ts[i].numpy(), j_res["event_ts"][lane], rtol=1e-9,
                                   atol=0)
        np.testing.assert_allclose(res.ys[i].numpy(), j_res["ys"][lane], rtol=1e-6, atol=1e-11)
        for k in ("event_ys", "event_ys_post"):
            np.testing.assert_allclose(getattr(res, k)[i].numpy(), j_res[k][lane], rtol=1e-6,
                                       atol=1e-11)
        ts_exact, _ = _closed_form(h0, g, e, 3)
        np.testing.assert_allclose(res.event_ts[i].numpy(), ts_exact, atol=1e-7)
    lone = one(es[1])
    for a, b in zip(res, lone):
        assert a[1].numpy().tobytes() == b.numpy().tobytes()


def test_no_event_reduces_to_plain_solve():
    hybrid = _ball_hybrid(max_events=2)
    h0, g, e = 50.0, 9.81, 0.8
    tvals = torch.linspace(0.0, 0.5, 6, **F64)
    p = _t(g, e).requires_grad_(True)
    res = hybrid(0.0, _t(h0, 0.0), p, P_FIX, tvals)
    assert int(res.n_events) == 0
    assert torch.isinf(res.event_ts).all()
    t = tvals.numpy()
    np.testing.assert_allclose(res.ys.detach().numpy()[:, 0], h0 - 0.5 * g * t**2, atol=1e-8)
    (grad,) = torch.autograd.grad(torch.sum(res.ys**2), p)
    assert torch.isfinite(grad).all()
    assert float(grad[1]) == 0.0  # e never enters without an impact


def test_max_events_truncation_flag():
    hybrid = _ball_hybrid(max_events=2)
    res = hybrid(0.0, _t(1.0, 0.0), _t(9.81, 0.9), P_FIX, torch.linspace(0.0, 6.0, 7, **F64))
    assert int(res.n_events) == 2


def test_adams_primal_localization():
    hybrid = _ball_hybrid(max_events=2, solver="ADAMS")
    h0, g, e = 1.0, 9.81, 0.8
    ts_exact, _ = _closed_form(h0, g, e, 2)
    tvals = torch.linspace(0.0, float(ts_exact[-1] + 0.1), 5, **F64)
    res = hybrid(0.0, _t(h0, 0.0), _t(g, e), P_FIX, tvals)
    assert int(res.n_events) == 2
    np.testing.assert_allclose(res.event_ts.numpy(), ts_exact, atol=1e-7)


def test_event_fn_adams_solver_option():
    ev = make_event_fn(ball_hybrid_problem(), roots=lambda t, y, p: torch.stack([y.h]),
                       options=OPTS, root_directions=[-1], solver="ADAMS", device="cpu")
    t_e, y_e = ev(0.0, _t(1.0, 0.0), _t(9.81, 0.8), P_FIX, 1.0)
    assert np.isclose(float(t_e), np.sqrt(2 / 9.81), atol=1e-8)
    assert np.isclose(float(y_e[0]), 0.0, atol=1e-8)


def test_hybrid_adjoint_derivatives_mode():
    """derivatives='adjoint': the gradient through two impacts at the
    closed form's exact gradient (1e-6; the reference test's FD oracle at
    rtol 5e-4 is looser)."""
    hybrid = _ball_hybrid(max_events=2, derivatives="adjoint")
    theta = _t(1.0, 0.8).requires_grad_(True)
    loss, _ = _hybrid_loss(hybrid, theta, torch.linspace(0.0, 1.6, 4, **F64))
    (grad,) = torch.autograd.grad(loss, theta)
    th = _t(1.0, 0.8).requires_grad_(True)
    (g_cf,) = torch.autograd.grad(_final_state_closed_form(th, 1.6, 2), th)
    np.testing.assert_allclose(grad.numpy(), g_cf.numpy(), rtol=1e-6, atol=0)


def test_hybrid_f32_pipeline():
    hybrid = _ball_hybrid(max_events=2, options=BDFOptions(rtol=1e-5, atol=1e-6))
    h0, g, e = 1.0, 9.81, 0.8
    ts_exact, _ = _closed_form(h0, g, e, 2)
    f32 = dict(dtype=torch.float32)
    res = hybrid(torch.tensor(0.0, **f32), torch.tensor([h0, 0.0], **f32),
                 torch.tensor([g, e], **f32), torch.zeros(0, **f32),
                 torch.linspace(0.0, float(ts_exact[-1] + 0.1), 5, **f32))
    assert res.ys.dtype == torch.float32 and res.event_ts.dtype == torch.float32
    assert int(res.n_events) == 2
    np.testing.assert_allclose(res.event_ts.numpy(), ts_exact, atol=5e-4)


def test_event_on_a_torch_problem_and_the_default_device():
    """A ``TorchProblem``'s event function is torch code on its records; the
    entry builders default to the card and raise without one."""
    problem = TorchProblem(params={"g": ()}, states={"x": (), "v": ()},
                           rhs=lambda t, y, p: {"x": y.v, "v": -p.g}, derivative_params=[("g",)])
    event = make_event_fn(problem, lambda t, y, p: torch.stack([y.x]), options=OPTS,
                          device="cpu")
    t_ev, _, _ = _event_grads(event, _t(H, 0.0), _t(G))
    assert abs(float(t_ev) - _closed_forms()["t_star"]) < 1e-8
    if not torch.cuda.is_available():
        for make in (lambda: build_ball_hybrid(3), lambda: make_event_fn(problem, _roots),
                     lambda: make_hybrid_solve_fn(problem, _roots, lambda t, y, p: y)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    with pytest.raises(ValueError, match="tensor leaf is on meta"):
        event(0.0, _t(H, 0.0).to("meta"), _t(G), P_FIX, 3.0)
