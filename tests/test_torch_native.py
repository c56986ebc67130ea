"""The native host route: ``sunode_torch.native`` (the C++ integrators of
``cvbdf.cpp``, their codegen and ``CpuSolver``) against the JAX package's
``sunode_tpu.native`` on the same inputs, and the class API's routes to it.

``cvbdf.cpp`` is the reference's byte for byte, and both packages compile it
and each problem's generated C with the same flags, so every case of
``tests/test_native.py`` is driven through both packages by one function
(``_CASES``) and held bit for bit: outputs, statistics, statuses, the
messages of the errors raised, and every generated source as text.  The
routing tests hold ``Solver`` and ``AdjointSolver`` on ``device="cpu"`` at
B=1 against the reference's default route (its native one) bit for bit,
and check which route each configuration takes: ``native_single=False``, a
``TorchProblem``, a batch and a solver on the card take the torch cores; a
failed build raises.  The batch cases run the thread pool on two threads.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import sympy as sy
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = 2  # the batch cases' thread pool, beside the test workers
PARAMS = {"alpha": 1.0, "beta": 0.3, "gamma": 1.0, "delta": 0.4}
TVALS = np.linspace(0.5, 8, 7)
Y0 = np.array([10.0, 2.0])
N_RD = 16


class _Side:
    """One package's surface, recording every ``CpuSolver`` it builds."""

    def __init__(self, side):
        if side == "port":
            from sunode_torch.native.cpu_solver import CpuSolver
            from sunode_torch.solver import AdjointSolver, Solver, SolverError
            from sunode_torch.symode.problem import SympyProblem

            self.Solver = lambda *a, **k: Solver(*a, device="cpu", **k)
            self.AdjointSolver = lambda *a, **k: AdjointSolver(*a, device="cpu", **k)
        else:
            from sunode_tpu.native.cpu_solver import CpuSolver
            from sunode_tpu.solver import AdjointSolver, Solver, SolverError
            from sunode_tpu.symode import SympyProblem

            self.Solver, self.AdjointSolver = Solver, AdjointSolver
        self.SympyProblem, self.SolverError, self.sources = SympyProblem, SolverError, []
        self._cls = CpuSolver

    def CpuSolver(self, *a, **k):
        s = self._cls(*a, **k)
        self.sources.append(s.generated_source)
        return s

    def raises(self, exc, fn):
        """The message of ``exc`` raised by ``fn()``."""
        with pytest.raises(exc) as info:
            fn()
        return str(info.value)


def _assert_same(got, want, path="out"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, str):
        assert got == want, path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert np.array_equal(g, w, equal_nan=g.dtype.kind == "f"), path


# ---- the problems of tests/test_native.py, built by either package ------------------
def lv_rhs(t, y, p):  # module level: a pickled problem names it
    return {"hares": p.alpha * y.hares - p.beta * y.lynx * y.hares,
            "lynx": p.delta * y.hares * y.lynx - p.gamma * y.lynx}


def _lv(S, derivs=(("alpha",),)):
    return S.SympyProblem(params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
                          states={"hares": (), "lynx": ()}, rhs_sympy=lv_rhs,
                          derivative_params=list(derivs))


def _robertson(S, derivs):
    def rob(t, y, p):
        r1, r2, r3 = p.k1 * y.a, p.k2 * y.b * y.b, p.k3 * y.b * y.c
        return {"a": -r1 + r3, "b": r1 - r2 - r3, "c": r2}

    return S.SympyProblem(params={"k1": (), "k2": (), "k3": ()},
                          states={"a": (), "b": (), "c": ()}, rhs_sympy=rob,
                          derivative_params=[(d,) for d in derivs])


ROB_P = {"k1": 0.04, "k2": 3e7, "k3": 1e4}


def _rd(S):
    def rhs(t, y, p):
        u, out = y.u, []
        for i in range(N_RD):
            left = u[i - 1] if i > 0 else 0
            right = u[i + 1] if i < N_RD - 1 else 0
            out.append(p.k * (left - 2 * u[i] + right) + p.r * u[i] * (1 - u[i]))
        return {"u": np.array(out, dtype=object)}

    return S.SympyProblem(params={"k": (), "r": ()}, states={"u": (N_RD,)}, rhs_sympy=rhs,
                          derivative_params=[("k",)])


RD_Y0 = 0.5 + 0.4 * np.sin(np.pi * np.arange(N_RD) / (N_RD - 1))
RD_P = {"k": 80.0, "r": 1.5}
BAND = dict(linear_solver="band", linear_solver_kwargs=dict(lower_bandwidth=1,
                                                             upper_bandwidth=1))


def _chain(S, n=24, seed=42):
    sigma = np.random.default_rng(seed).permutation(n)

    def rhs(t, y, p):
        u, out = y.u, [None] * n
        for j in range(n):
            v = sigma[j]
            left = u[sigma[j - 1]] if j > 0 else 0
            right = u[sigma[j + 1]] if j < n - 1 else 0
            out[v] = p.k * (left - 2 * u[v] + right) + p.r * u[v] * (1 - u[v])
        return {"u": np.array(out, dtype=object)}

    return S.SympyProblem(params={"k": (), "r": ()}, states={"u": (n,)}, rhs_sympy=rhs,
                          derivative_params=[("k",), ("r",)])


def _arrowhead(S, n=40):
    def rhs(t, y, p):
        u = y.u
        out = [-p.k * u[0] + p.c * sum(u[j] for j in range(1, n)) / n]
        out += [-p.k * u[j] + p.c * u[0] * (1 - u[j]) for j in range(1, n)]
        return {"u": np.array(out, dtype=object)}

    return S.SympyProblem(params={"k": (), "c": ()}, states={"u": (n,)}, rhs_sympy=rhs,
                          derivative_params=[("k",), ("c",)])


def _lv2(S):
    def lv2(t, y, p):
        return {"hares": p.a * y.hares - 0.3 * y.lynx * y.hares,
                "lynx": 0.4 * y.hares * y.lynx - y.lynx}

    return S.SympyProblem(params={"a": ()}, states={"hares": (), "lynx": ()}, rhs_sympy=lv2,
                          derivative_params=[("a",)])


def _solver(S, problem, params, **kw):
    s = S.CpuSolver(problem, **kw)
    s.set_params_dict(params)
    return s


def _stats(s):
    return {k: np.asarray(v) for k, v in s.last_stats.items()}


def _grads(seed, n_t, n):
    return np.random.default_rng(seed).standard_normal((n_t, n))


# ---- the cases: each drives one package and returns what it computed ---------------
def case_dense_bdf(S):
    s = _solver(S, _lv(S), PARAMS, abstol=1e-10, reltol=1e-10)
    src = s.generated_source
    assert "sunode_rhs" in src and "sunode_jac" in src and "out[0] =" in src
    return s.solve(0.0, TVALS, Y0), _stats(s)


def _batch_y0(B=16):
    return np.tile(Y0, (B, 1)) * np.linspace(0.9, 1.1, B)[:, None]


def case_batch_threaded(S):
    s = _solver(S, _lv(S), PARAMS, abstol=1e-10, reltol=1e-10, n_threads=THREADS)
    out = s.solve(0.0, TVALS, _batch_y0())
    return out, s.last_status, s.solve(0.0, TVALS, _batch_y0()[7])


def case_failure_raises(S):
    s = _solver(S, _lv(S), PARAMS, abstol=1e-10, reltol=1e-10, max_steps=3)
    return S.raises(S.SolverError, lambda: s.solve(0.0, TVALS, Y0))


def case_nested_vector_params(S):
    prob = S.SympyProblem(params={"rates": {"k": (2,)}}, states={"x": ()},
                          rhs_sympy=lambda t, y, p: {"x": -p.rates.k[0] * y.x + p.rates.k[1]},
                          derivative_params=[])
    s = _solver(S, prob, {"rates": {"k": [2.0, 1.0]}}, abstol=1e-12, reltol=1e-10)
    out = s.solve(0.0, np.array([1.0, 2.0]), np.array([3.0]))
    np.testing.assert_allclose(out[:, 0], 0.5 + 2.5 * np.exp(-2.0 * np.array([1.0, 2.0])),
                               rtol=1e-7)
    return out, _stats(s)


def case_adams(S):
    s = _solver(S, _lv(S), PARAMS, abstol=1e-10, reltol=1e-10, method="ADAMS")
    out = s.solve(0.0, TVALS, Y0)
    assert s.last_stats["n_factorizations"] == 0 and s.last_stats["final_order"] >= 5
    return out, _stats(s)


def case_adams_batch_threaded(S):
    s = _solver(S, _lv(S), PARAMS, abstol=1e-10, reltol=1e-10, method="ADAMS",
                n_threads=THREADS)
    return s.solve(0.0, TVALS, _batch_y0()), s.solve(0.0, TVALS, _batch_y0()[7])


def case_adams_order_cap(S):
    out = []
    for order in (2, 8):
        s = _solver(S, _lv(S), PARAMS, abstol=1e-10, reltol=1e-10, method="ADAMS",
                    adams_max_order=order)
        out.append((s.solve(0.0, TVALS, Y0), _stats(s)))
    assert out[0][1]["final_order"] <= 2 and out[1][1]["n_steps"] < out[0][1]["n_steps"]
    return out


def case_adams_extreme_params(S):
    s = _solver(S, _lv(S), {"alpha": 7e300, "beta": 0.7, "gamma": 1.0, "delta": 0.4},
                abstol=1e-10, reltol=1e-10, method="ADAMS", max_steps=2000)
    return S.raises(S.SolverError, lambda: s.solve(1.0, TVALS, Y0))


def case_adams_adjoint(S):
    s = _solver(S, _lv(S), PARAMS, abstol=1e-10, reltol=1e-10, method="ADAMS")
    return s.solve_adjoint(0.0, TVALS, Y0, _grads(0, len(TVALS), 2)), _stats(s)


def case_adams_sens(S):
    s = _solver(S, _lv(S), PARAMS, abstol=1e-10, reltol=1e-10, method="ADAMS")
    return (s.solve_sens(0.0, TVALS, Y0),
            s.solve_sens(0.0, TVALS, Y0, sens0=np.array([[1.0, 0.0]])), _stats(s))


def case_bdf_adjoint(S):
    s = _solver(S, _lv(S), PARAMS, abstol=1e-12, reltol=1e-10, method="BDF")
    return s.solve_adjoint(0.0, TVALS, Y0, _grads(0, len(TVALS), 2)), _stats(s)


def case_bdf_adjoint_robertson(S):
    prob, tv = _robertson(S, ("k1", "k2", "k3")), np.logspace(-3, 5, 18)
    out = []
    for ho in (3, 5):
        s = _solver(S, prob, ROB_P, abstol=1e-14, reltol=1e-10, max_steps=10_000_000,
                    hermite_order=ho)
        out.append(s.solve_adjoint(0.0, tv, np.array([1.0, 0.0, 0.0]), _grads(1, 18, 3),
                                   adjoint_reltol=1e-8, adjoint_abstol=1e-12))
    np.testing.assert_allclose(out[0][2], out[1][2], rtol=1e-6)
    return out


def case_bdf_adjoint_nonautonomous(S):
    prob = S.SympyProblem(params={"k": (), "A": ()}, states={"x": ()},
                          rhs_sympy=lambda t, y, p: {"x": -p.k * y.x + p.A * sy.sin(1.7 * t)},
                          derivative_params=[("k",), ("A",)])
    s = _solver(S, prob, {"k": 0.8, "A": 1.3}, abstol=1e-12, reltol=1e-10)
    assert "sunode_dfdt" in s.generated_source
    return s.solve_adjoint(0.0, np.linspace(0, 8, 15), np.array([2.0]), _grads(2, 15, 1))


def _adjoint_batch(S, method):
    B, rng = 6, np.random.default_rng(3)
    y0b = np.abs(Y0 + 0.1 * rng.normal(size=(B, 2)))
    gb = rng.standard_normal((B, len(TVALS), 2))
    s = _solver(S, _lv(S), PARAMS, method=method, reltol=1e-8, abstol=1e-10, n_threads=THREADS)
    pb = np.broadcast_to(s._params, (B, s._params.size)).copy()
    pb[:, 0] *= 1 + 0.01 * rng.normal(size=B)
    ok = (s.solve_adjoint(0.0, TVALS, y0b, gb, params=pb), s.last_status.copy())
    y0bad = y0b.copy()
    y0bad[2] = [1e300, 1e300]
    bad = (s.solve_adjoint(0.0, TVALS, y0bad, gb, params=pb), s.last_status.copy())
    assert bad[1][2] != 0 and np.isnan(bad[0][2][2]).all()
    s._params = np.ascontiguousarray(pb[0])
    return ok, bad, s.solve_adjoint(0.0, TVALS, y0b[0], gb[0])


def case_adjoint_batch_bdf(S):
    return _adjoint_batch(S, "BDF")


def case_adjoint_batch_adams(S):
    return _adjoint_batch(S, "ADAMS")


def case_robertson(S):
    s = _solver(S, _robertson(S, ()), ROB_P, abstol=1e-12, reltol=1e-9)
    return s.solve(0.0, 4.0 * 10.0 ** np.arange(-1, 6), np.array([1.0, 0.0, 0.0])), _stats(s)


def case_band(S):
    prob, tv = _rd(S), np.array([0.05, 0.2, 0.5, 1.0])
    band = _solver(S, prob, RD_P, abstol=1e-10, reltol=1e-10, n_threads=THREADS, **BAND)
    assert "sunode_jac_banded" in band.generated_source
    y0b = np.stack([RD_Y0, 0.8 * RD_Y0, 1.2 * RD_Y0])
    return band.solve(0.0, tv, RD_Y0), _stats(band), band.solve(0.0, tv, y0b), band.last_status


def case_band_rejections(S):
    lv = _lv(S)
    out_of_band = S.raises(ValueError, lambda: S.CpuSolver(
        lv, linear_solver="band", linear_solver_kwargs=dict(lower_bandwidth=0,
                                                            upper_bandwidth=0)))
    adams = S.raises(ValueError, lambda: S.CpuSolver(lv, method="ADAMS", **BAND))
    assert "outside the declared band" in out_of_band and "requires method='BDF'" in adams
    return out_of_band, adams


def case_band_adjoint(S):
    prob, tv = _rd(S), np.array([0.05, 0.2, 0.5, 1.0])
    g = _grads(0, len(tv), N_RD)
    band = _solver(S, prob, RD_P, abstol=1e-10, reltol=1e-10, n_threads=THREADS, **BAND)
    adj = band.solve_adjoint(0.0, tv, RD_Y0, g)
    rec = (band.solve_forward_recorded(0.0, tv, RD_Y0), band.solve_backward_recorded(0.0, tv, g))
    batch = band.solve_adjoint(0.0, tv, np.stack([RD_Y0, 0.9 * RD_Y0]), np.stack([g, g]))
    return adj, rec, batch, band.checkpoint_times()


def case_bdf_sens_robertson(S):
    s = _solver(S, _robertson(S, ("k1", "k3")), ROB_P, abstol=1e-12, reltol=1e-9, method="BDF")
    tv, y0 = 4.0 * 10.0 ** np.arange(-1, 5), np.array([1.0, 0.0, 0.0])
    return (s.solve_sens(0.0, tv, y0), _stats(s),
            s.solve_sens(0.0, tv, y0, sens_mode="staggered"), _stats(s))


def case_bdf_sens_band(S):
    band = _solver(S, _rd(S), RD_P, abstol=1e-10, reltol=1e-10, method="BDF", **BAND)
    return band.solve_sens(0.0, np.array([0.05, 0.2, 0.5]), RD_Y0), _stats(band)


def case_constraints(S):
    c = _solver(S, _robertson(S, ()), ROB_P, abstol=1e-12, reltol=1e-6,
                constraints=[1.0, 1.0, 1.0])
    ys = c.solve(0.0, 4.0 * 10.0 ** np.arange(-1, 6), np.array([1.0, 0.0, 0.0]))
    assert (ys >= 0).all()
    dec = S.SympyProblem(params={"r": ()}, states={"x": ()},
                         rhs_sympy=lambda t, y, p: {"x": -p.r + 0 * y.x}, derivative_params=[])
    c2 = _solver(S, dec, {"r": 1.0}, abstol=1e-10, reltol=1e-8, method="ADAMS",
                 constraints=[1.0])
    return ys, _stats(c), S.raises(S.SolverError,
                                   lambda: c2.solve(0.0, np.array([2.0]), np.array([0.5])))


def case_sparse(S):
    n, tv = 24, np.array([0.05, 0.2, 0.5, 1.0])
    y0 = 0.5 + 0.4 * np.sin(np.pi * np.arange(n) / (n - 1))
    g = _grads(0, len(tv), n)
    s = _solver(S, _chain(S, n), RD_P, abstol=1e-10, reltol=1e-10, linear_solver="sparse",
                n_threads=THREADS)
    assert s._band is None and int(s._sp_ap[-1]) == 3 * n - 2
    return ((s._sp_ap, s._sp_ai, s._sp_q), s.solve(0.0, tv, y0), _stats(s),
            s.solve_adjoint(0.0, tv, y0, g), s.solve_sens(0.0, tv, y0),
            s.solve_forward_recorded(0.0, tv, y0), s.solve_backward_recorded(0.0, tv, g),
            s.solve_adjoint(0.0, tv, np.stack([y0, 0.9 * y0]), np.stack([g, g])))


def _fill_in(ap, ai, order, n):
    """The structural fill of eliminating in ``order`` (the minimum-degree
    order must leave the arrowhead fill-free)."""
    adj = np.zeros((n, n), bool)
    for j in range(n):
        adj[ai[ap[j]:ap[j + 1]], j] = True
    adj |= adj.T
    np.fill_diagonal(adj, False)
    alive, fill = np.ones(n, bool), 0
    for v in order:
        alive[v] = False
        nb = np.flatnonzero(adj[v] & alive)
        for a in nb:
            for b in nb:
                if a < b and not adj[a, b]:
                    fill += 1
                    adj[a, b] = adj[b, a] = True
    return fill


def case_sparse_arrowhead(S):
    n, tv = 40, np.array([0.1, 0.4, 1.0])
    y0 = 0.3 + 0.4 * np.cos(np.arange(n) / n)
    s = _solver(S, _arrowhead(S, n), {"k": 30.0, "c": 8.0}, abstol=1e-10, reltol=1e-10,
                linear_solver="sparse")
    assert int(s._sp_ap[-1]) == 3 * n - 2 and _fill_in(s._sp_ap, s._sp_ai, s._sp_q, n) == 0
    return ((s._sp_ap, s._sp_ai, s._sp_q), s.solve(0.0, tv, y0), _stats(s),
            s.solve_adjoint(0.0, tv, y0, _grads(3, len(tv), n)),
            s.solve_sens(0.0, tv, y0, sens_mode="staggered"))


def case_adams_constraints(S):
    c = _solver(S, _lv2(S), {"a": 1.0}, abstol=1e-10, reltol=1e-10, method="ADAMS",
                constraints=[1.0, 1.0])
    ys = c.solve(0.0, TVALS, Y0)
    assert (ys > 0).all()
    return ys, _stats(c)


def case_spgmr(S):
    tv = np.array([0.05, 0.2, 0.5, 1.0])
    g = _solver(S, _rd(S), RD_P, abstol=1e-10, reltol=1e-8, linear_solver="spgmr",
                n_threads=THREADS)
    ys = g.solve(0.0, tv, RD_Y0)
    assert g.last_stats["n_rhs_evals"] > g.last_stats["n_newton_iters"]
    return ys, _stats(g), g.solve(0.0, tv, np.stack([RD_Y0, 0.8 * RD_Y0])), g.last_status


def case_staggered_sens_adams(S):
    c = _solver(S, _lv2(S), {"a": 1.0}, abstol=1e-10, reltol=1e-10, method="ADAMS")
    return (c.solve_sens(0.0, TVALS, Y0), c.solve_sens(0.0, TVALS, Y0, sens_mode="staggered"),
            _stats(c))


def case_polynomial_adjoint(S):
    out = []
    for interp in ("hermite", "polynomial"):
        s = _solver(S, _lv(S), PARAMS, abstol=1e-10, reltol=1e-8, interpolation=interp)
        out.append(s.solve_adjoint(0.0, TVALS, Y0, np.ones((len(TVALS), 2))))
    return out


def case_spgmr_adjoint(S):
    tv = np.array([0.05, 0.2, 0.5, 1.0])
    grads = _grads(0, len(tv), N_RD)
    out = []
    for interp in ("hermite", "polynomial"):
        g = _solver(S, _rd(S), RD_P, abstol=1e-10, reltol=1e-8, linear_solver="spgmr",
                    interpolation=interp, n_threads=THREADS)
        out.append((g.solve_adjoint(0.0, tv, RD_Y0, grads),
                    g.solve_adjoint(0.0, tv, np.stack([RD_Y0, 0.9 * RD_Y0]),
                                    np.stack([grads, grads])), g.last_status))
    g.solve_forward_recorded(0.0, tv, RD_Y0)
    return out, g.solve_backward_recorded(0.0, tv, grads)


def case_spgmr_sens(S):
    tv = np.array([0.05, 0.2, 0.5, 1.0])
    g = _solver(S, _rd(S), RD_P, abstol=1e-10, reltol=1e-8, linear_solver="spgmr")
    return (g.solve_sens(0.0, tv, RD_Y0), _stats(g),
            g.solve_sens(0.0, tv, RD_Y0, sens_mode="staggered"))


def case_clamped_step(S):
    prob = S.SympyProblem(params={"mu": ()}, states={"x": (), "v": ()},
                          rhs_sympy=lambda t, y, p: {"x": y.v,
                                                     "v": p.mu * (1 - y.x * y.x) * y.v - y.x},
                          derivative_params=[])
    s = _solver(S, prob, {"mu": 50.0}, abstol=1e-10, reltol=1e-7)
    return s.solve(0.0, np.array([22.735294117647058]), np.array([2.0, 0.0])), _stats(s)


def case_pickle_and_xarray(S):
    tv = np.linspace(0.5, 8, 5)
    s = _solver(S, _lv(S), PARAMS, abstol=1e-10, reltol=1e-10)
    ys1 = s.solve(0.0, tv, Y0)
    s2 = pickle.loads(pickle.dumps(s))
    ys2 = s2.solve(0.0, tv, Y0)
    assert np.array_equal(ys1, ys2)
    hares = np.asarray(s2.as_xarray(tv, ys2).solution_hares)
    return ys2, hares, s2.solve_adjoint(0.0, tv, Y0, np.ones((5, 2))), s2.generated_source


def _linear_band(S, n, l, u):
    rng = np.random.default_rng(n * 100 + l * 10 + u)
    A = np.zeros((n, n))
    for i in range(n):
        for j in range(max(0, i - l), min(n, i + u + 1)):
            A[i, j] = rng.standard_normal() * 0.5
    A -= np.eye(n) * (0.2 + np.abs(A).sum(axis=1).max())

    def rhs(t, y, p):
        uv = y.u
        return {"u": np.array([sum(A[i, j] * uv[j] for j in range(n) if A[i, j] != 0.0)
                               for i in range(n)], dtype=object)}

    prob = S.SympyProblem(params={"dummy": ()}, states={"u": (n,)}, rhs_sympy=rhs,
                          derivative_params=[])
    y0, g = rng.standard_normal(n), rng.standard_normal(n)
    out = []
    for kw in ({}, dict(linear_solver="band", linear_solver_kwargs=dict(lower_bandwidth=l,
                                                                         upper_bandwidth=u)),
               dict(linear_solver="sparse")):
        s = _solver(S, prob, {"dummy": 0.0}, abstol=1e-12, reltol=1e-10, **kw)
        out.append(s.solve_adjoint(0.0, np.array([1.3]), y0, g[None, :]))
    from scipy.linalg import expm

    np.testing.assert_allclose(out[1][0][0], expm(A * 1.3) @ y0, rtol=1e-6, atol=1e-10)
    return out


# the class API: the port's Solver/AdjointSolver on device="cpu" at B=1 against the
# reference's default route, which is its native one
def case_class_adams(S):
    s = S.Solver(_lv(S), abstol=1e-10, reltol=1e-10, solver="ADAMS")
    s.set_params_dict(PARAMS)
    out = s.solve(0.0, TVALS, Y0)
    assert s.last_stats["n_factorizations"] == 0 and s._native_eligible()
    return out, _stats(s)


def case_class_sens(S):
    out = []
    for solver, mode in (("ADAMS", "simultaneous"), ("BDF", "simultaneous"), ("BDF", "staggered"),
                         ("ADAMS", "staggered")):
        s = S.Solver(_lv(S, (("alpha",), ("beta",))), abstol=1e-8, reltol=1e-8, sens_mode=mode,
                     solver=solver)
        s.set_params_dict(PARAMS)
        assert s._native_sens_eligible()
        out.append((s.solve(0.0, TVALS, Y0), _stats(s)))
    return out


def _adjoint_class(S, prob, params, y0, tv, **kw):
    s = S.AdjointSolver(prob, **kw)
    s.set_params_dict(params)
    assert s._native_adj_eligible()
    ys = s.solve_forward(0.0, tv, y0)
    info = s.checkpoint_info()
    g = np.ones((len(tv), len(y0)))
    first = s.solve_backward(tv[-1], 0.0, tv, g)
    second = s.solve_backward(tv[-1], 0.0, tv, 2.0 * g)  # the same record again
    return ys, info, first, second, _stats(s)


def case_class_adjoint(S):
    return [_adjoint_class(S, _lv(S), PARAMS, Y0, TVALS, reltol=1e-8, abstol=1e-8, **kw)
            for kw in (dict(solver="ADAMS", adjoint_solver="ADAMS"), {},
                       dict(interpolation="polynomial"))]


def case_class_band_sparse(S):
    tv = np.array([0.05, 0.2, 0.5])
    out = []
    for kw in (BAND, dict(linear_solver="sparse")):
        s = S.Solver(_rd(S), abstol=1e-10, reltol=1e-10, **kw)
        s.set_params_dict(RD_P)
        assert s._native_eligible()
        out.append((s.solve(0.0, tv, RD_Y0), _stats(s),
                    _adjoint_class(S, _rd(S), RD_P, RD_Y0, tv, reltol=1e-8, abstol=1e-8, **kw)))
    return out


def case_class_constraints_spgmr(S):
    s = S.Solver(_robertson(S, ()), abstol=1e-12, reltol=1e-6,
                 constraints=np.array([1.0, 1.0, 1.0]))
    s.set_params_dict(ROB_P)
    out = [s.solve(0.0, 4.0 * 10.0 ** np.arange(-1, 6), np.array([1.0, 0.0, 0.0]))]
    s = S.Solver(_lv2(S), abstol=1e-10, reltol=1e-10, solver="ADAMS",
                 constraints=np.array([1.0, 1.0]))
    s.set_params_dict({"a": 1.0})
    out.append(s.solve(0.0, TVALS, Y0))
    for ls in ("spgmr", "spgmr_finitediff"):
        s = S.Solver(_rd(S), abstol=1e-10, reltol=1e-8, linear_solver=ls)
        s.set_params_dict(RD_P)
        assert s._native_eligible()
        out.append((s.solve(0.0, np.array([0.05, 0.2, 0.5, 1.0]), RD_Y0), _stats(s)))
    return out


def case_class_roots(S):
    n = 24
    mid = int(np.random.default_rng(42).permutation(n)[n // 2])
    y0 = 0.5 + 0.4 * np.sin(np.pi * np.arange(n) / (n - 1))
    out = []
    for kw in (dict(linear_solver="sparse"), {}):
        s = S.Solver(_chain(S, n), abstol=1e-10, reltol=1e-10, root_terminal=True,
                     roots=lambda t, y, p: [y.u[mid] - 0.75], **kw)
        s.set_params_dict({"k": 40.0, "r": 1.5})
        assert s._native_eligible()
        out.append((s.solve(0.0, np.array([0.05, 0.2, 0.5, 2.0]), y0), _stats(s)))
    assert int(out[0][1]["n_roots"]) == 1
    return out


_CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}
_CASES.update({f"linear_band_{n}_{l}_{u}": (lambda S, n=n, l=l, u=u: _linear_band(S, n, l, u))
               for n, l, u in ((8, 1, 1), (7, 2, 0), (9, 1, 2))})


@pytest.mark.parametrize("name", sorted(_CASES))
def test_native_case_bit_for_bit(name):
    """One case of tests/test_native.py through both packages: every output
    and every generated C source equal."""
    torch.set_num_threads(1)
    port, ref = _Side("port"), _Side("jax")
    got, want = _CASES[name](port), _CASES[name](ref)
    _assert_same(got, want)
    assert port.sources == ref.sources


def test_cvbdf_source_is_the_reference():
    from pathlib import Path

    port = Path(ROOT, "sunode_torch", "native", "cvbdf.cpp").read_bytes()
    assert port == Path(ROOT, "sunode_tpu", "native", "cvbdf.cpp").read_bytes()


# ---- routing -----------------------------------------------------------------------
def test_route_predicates():
    """Which configurations the native routes take, decided by type and
    options before any build."""
    from sunode_torch.entry import lv_problem
    from sunode_torch.problem import TorchProblem
    from sunode_torch.solver import AdjointSolver, Solver

    lv = lv_problem()
    on = Solver(lv, device="cpu")
    assert on._native_eligible() and not hasattr(on, "_native_solver")
    assert not Solver(lv, device="cpu", native_single=False)._native_eligible()
    assert not Solver(lv, device="cpu", dtype=np.float32, reltol=1e-5)._native_eligible()
    assert not Solver(lv, device="cpu", linear_solver="dense_finitediff")._native_eligible()
    assert Solver(lv, device="cpu", sens_mode="staggered")._native_sens_eligible()
    assert AdjointSolver(lv, device="cpu")._native_adj_eligible()
    assert not AdjointSolver(lv, device="cpu", native_single=False)._native_adj_eligible()

    def rhs(t, y, p):
        return {"x": -p.k * y.x}

    tp = TorchProblem({"k": ()}, {"x": ()}, rhs, [("k",)])
    assert not Solver(tp, device="cpu")._native_eligible()
    assert not AdjointSolver(tp, device="cpu")._native_adj_eligible()


def test_cuda_solver_never_routes_native(monkeypatch):
    """A solver on the card: every route predicate is false, whatever
    ``native_single`` says (the device check needs no card)."""
    import sunode_torch.solver as solver_mod
    from sunode_torch.entry import lv_problem

    monkeypatch.setattr(solver_mod, "device_or_raise", lambda d: torch.device(d))
    lv = lv_problem()
    s = solver_mod.Solver(lv, device="cuda", native_single=True)
    sens = solver_mod.Solver(lv, device="cuda", sens_mode="simultaneous")
    adj = solver_mod.AdjointSolver(lv, device="cuda", solver="ADAMS", adjoint_solver="ADAMS")
    assert not (s._native_eligible() or sens._native_sens_eligible()
                or adj._native_adj_eligible())


def test_native_single_false_takes_the_torch_cores():
    """``native_single=False`` and a batch run the torch cores; a
    ``TorchProblem`` too, through the predicate; the native route's stats
    carry the reference's keys."""
    from sunode_torch.entry import lv_problem
    from sunode_torch.problem import TorchProblem
    from sunode_torch.solver import Solver

    torch.set_num_threads(1)
    lv = lv_problem()
    native = Solver(lv, device="cpu", solver="ADAMS", reltol=1e-8, abstol=1e-8)
    cores = Solver(lv, device="cpu", solver="ADAMS", reltol=1e-8, abstol=1e-8,
                   native_single=False)
    for s in (native, cores):
        s.set_params_dict(PARAMS)
    ys_n, ys_c = native.solve(0.0, TVALS, Y0), cores.solve(0.0, TVALS, Y0)
    assert native._native_solver is not None and not hasattr(cores, "_native_solver")
    np.testing.assert_allclose(ys_n, ys_c, rtol=1e-5, atol=1e-8)
    assert set(native.last_stats) == {"n_steps", "n_rhs_evals", "n_jac_evals",
                                      "n_factorizations", "n_newton_iters",
                                      "n_error_test_fails", "n_conv_fails", "final_order",
                                      "n_resumes", "n_steps_total"}
    batched = native.solve(0.0, TVALS, np.tile(Y0, (2, 1)))
    assert batched.shape == (2, len(TVALS), 2) and "final_time" in native.last_stats
    np.testing.assert_allclose(batched[1], ys_c, rtol=1e-5, atol=1e-8)

    tp = TorchProblem({"k": ()}, {"x": ()}, lambda t, y, p: {"x": -p.k * y.x}, [("k",)])
    s = Solver(tp, device="cpu", reltol=1e-8, abstol=1e-10)
    s.set_params_dict({"k": 0.5})
    out = s.solve(0.0, np.array([1.0, 2.0]), np.array([1.0]))
    assert not hasattr(s, "_native_solver") and "final_time" in s.last_stats
    np.testing.assert_allclose(out[:, 0], np.exp(-0.5 * np.array([1.0, 2.0])), rtol=1e-6)


def test_pickled_solver_rebuilds_its_native_route():
    from sunode_torch.entry import lv_problem
    from sunode_torch.solver import AdjointSolver, Solver

    s = Solver(lv_problem(), device="cpu")
    s.set_params_dict(PARAMS)
    ys = s.solve(0.0, TVALS, Y0)
    s2 = pickle.loads(pickle.dumps(s))
    assert not hasattr(s2, "_native_solver")
    assert np.array_equal(s2.solve(0.0, TVALS, Y0), ys)
    a = AdjointSolver(lv_problem(), device="cpu")
    a.set_params_dict(PARAMS)
    a.solve_forward(0.0, TVALS, Y0)
    assert "_native_adj_solver" not in a.__getstate__()


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails makes an eligible solve raise (the build key
    names the compiler, so nothing cached is loaded); nothing falls back."""
    from sunode_torch.entry import lv_problem
    from sunode_torch.native import codegen
    from sunode_torch.solver import Solver

    monkeypatch.setenv("CXX", "false")
    s = Solver(lv_problem(), device="cpu")
    s.set_params_dict(PARAMS)
    with pytest.raises(RuntimeError, match="native build failed"):
        s.solve(0.0, TVALS, Y0)
    monkeypatch.setattr(codegen, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="native build failed"):
        s.solve(0.0, TVALS, Y0)


_BUILD = r"""
import sys
from pathlib import Path
from sunode_torch.native import codegen
from sunode_torch.entry import lv_problem
codegen.BUILD_ROOT = Path(sys.argv[1])
lib = codegen.compile_problem_c(lv_problem())
print(lib._name)
"""


def test_two_processes_build_at_once(tmp_path):
    """Two processes building the same problem library into an empty
    directory at once both load one complete library, and leave no
    temporary file behind."""
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    libs = sorted(f.name for f in tmp_path.iterdir() if not f.name.startswith("."))
    assert len(paths) == 1 and libs == [os.path.basename(paths.pop())]
