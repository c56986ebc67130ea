"""sunode_torch's class API (``Solver``, ``AdjointSolver``) against sunode_tpu's.

The cases of ``tests/test_solver.py``, ``tests/test_solver_modes.py`` and the
float32 cases of ``tests/test_f32_class_api.py`` that are not about the
reference's native host route, each run through both packages (the
reference with ``native_single=False``, so that both run the same
algorithm): ys, sens and lambda within rtol 1e-6 / atol 1e-11, step
statistics within 2, gradients within 1e-6; statuses, ``SolverError``,
``n_resumes``, root records, the stats' keys (the reference's, and the
port's counters ``n_attempts``, ``n_linear_factors``, ``n_linear_solves``),
pickling round trips and the params getters and setters exactly.  Each JAX
reference is computed once in the module and shared by the tests that read
it.
"""

import functools
import pickle
import sys
import types
import warnings

import jax
import numpy as np
import pytest
import torch

from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_tpu.solver import AdjointSolver as JaxAdjointSolver
from sunode_tpu.solver import Solver as JaxSolver
from sunode_tpu.solver import SolverError as JaxSolverError
from sunode_tpu.symode import SympyProblem as JaxSympyProblem
from sunode_torch import AdjointSolver, Solver, SolverError, SympyProblem
from sunode_torch.entry import _lv, build_lv_forward
from sunode_torch.ops.bdf import BDFOptions

jax.config.update("jax_enable_x64", True)

PARAMS = {"alpha": 1.0, "beta": 0.3, "gamma": 1.0, "delta": 0.4}
TVALS = np.linspace(0.5, 8.0, 7)
Y0 = np.array([10.0, 2.0])
STEP_STATS = ("n_steps", "n_error_test_fails", "n_conv_fails", "n_newton_iters")
PORT_COUNTERS = {"n_attempts", "n_linear_factors", "n_linear_solves"}
LV_SPEC = dict(params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
               states={"hares": (), "lynx": ()}, rhs_sympy=_lv,
               derivative_params=[("alpha",), ("beta",)])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solves' tensors are a few values each: one CPU thread is faster
    than many; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _problems():
    return SympyProblem(**LV_SPEC), JaxSympyProblem(**LV_SPEC)


@pytest.fixture(scope="module")
def problem():
    return _problems()[0]


def _port(**kw):
    s = Solver(_problems()[0], device="cpu", native_single=False, **kw)
    s.set_params_dict(PARAMS)
    return s


def _jax(**kw):
    s = JaxSolver(_problems()[1], native_single=False, **kw)
    s.set_params_dict(PARAMS)
    return s


@functools.cache
def _solved(side: str, config: tuple, y0: tuple, tvals: tuple = tuple(TVALS)):
    """One solve of ``Solver(**dict(config))`` on ``side`` ('port' or
    'jax'): ``(outputs, last_stats)``, cached for the module."""
    s = (_port if side == "port" else _jax)(**dict(config))
    out = s.solve(0.0, np.asarray(tvals), np.asarray(y0))
    out = tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)
    return out, {k: np.asarray(v) for k, v in s.last_stats.items()}


def _pair(config=(), y0=tuple(Y0), tvals=tuple(TVALS)):
    return _solved("port", tuple(config), y0, tvals), _solved("jax", tuple(config), y0, tvals)


def _close(got, want, rtol=1e-6, atol=1e-11):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _stats_close(got, want, keys=STEP_STATS):
    for k in keys:
        assert np.max(np.abs(np.asarray(got[k], np.int64) - np.asarray(want[k], np.int64))) <= 2, k
    assert set(want) <= set(got) and set(got) - set(want) <= PORT_COUNTERS
    for k in want:
        assert np.shape(got[k]) == np.shape(want[k]), k
    assert int(got["n_resumes"]) == int(want["n_resumes"])


def _check_pair(config=(), y0=tuple(Y0), tvals=tuple(TVALS), keys=STEP_STATS):
    (out, st), (jout, jst) = _pair(config, y0, tvals)
    _close(out, jout)
    _stats_close(st, jst, keys)
    return out, st


# ---- tests/test_solver.py -----------------------------------------------------------
def test_readme_flow(problem, monkeypatch):
    """The README's usage: a ``state_dtype`` y0, params as a dict, output
    buffers, record views and ``as_xarray`` (the fallback Dataset, and real
    xarray's branch through a strict stand-in); the reference's solve."""
    solver = Solver(problem, sens_mode=None, solver="BDF", device="cpu", native_single=False)
    y0 = np.zeros((), dtype=problem.state_dtype)
    y0["hares"] = 10.0
    y0["lynx"] = 2.0
    solver.set_params_dict(PARAMS)
    output = solver.make_output_buffers(TVALS)
    assert solver.solve(t0=0, tvals=TVALS, y0=y0, y_out=output) is output
    (jout, jst) = _solved("jax", (), tuple(Y0))
    _close(output, jout)
    _stats_close(solver.last_stats, jst)
    rec = output.view(problem.state_dtype)
    assert rec["hares"].shape in ((len(TVALS), 1), (len(TVALS),))
    ds = solver.as_xarray(TVALS, output)
    assert "solution_hares" in ds.keys() and ds.solution_hares.values.shape == (len(TVALS),)
    assert ds["parameter_alpha"].values == 1.0

    class Strict:
        def __init__(self, data_vars, coords=None):
            for name, (dims, data) in data_vars.items():
                assert len(dims) == np.ndim(data), name
            self.data_vars, self.coords = data_vars, coords

    monkeypatch.setitem(sys.modules, "xarray", types.SimpleNamespace(Dataset=Strict))
    ds = solver.as_xarray(TVALS, output)
    assert isinstance(ds, Strict) and ds.data_vars["solution_lynx"][1].shape == (len(TVALS),)
    assert problem.flat_solution_as_dict(output)["hares"].shape == (len(TVALS),)


def test_solve_flat_and_dict_y0():
    out1 = _solved("port", (), tuple(Y0))[0]
    out2 = _port().solve(0.0, TVALS, {"hares": 10.0, "lynx": 2.0})
    np.testing.assert_array_equal(out1, out2)


def test_params_roundtrip():
    """The getters and setters, the dtypes and the flat params, exactly the
    reference's."""
    ports, jaxs = _port(), _jax()
    for s in (ports, jaxs):
        s.set_derivative_params(np.array([2.0, 0.5]))
        s.set_remaining_params({"gamma": 3.0, "delta": 0.7})
    np.testing.assert_array_equal(ports.get_params(), jaxs.get_params())
    d = ports.get_params_dict()
    assert d["alpha"] == 2.0 and d["beta"] == 0.5 and d["gamma"] == 3.0 and d["delta"] == 0.7
    for s in (ports, jaxs):
        s.set_derivative_params({"alpha": 1.5, "beta": 0.25})
        s.set_remaining_params(np.array([0.9, 0.45]))
        s.set_params(np.array([1.0, 0.3, 1.0, 0.4]) * 1.1)
    np.testing.assert_array_equal(ports.get_params(), jaxs.get_params())
    assert ports.params_dtype == jaxs.params_dtype
    assert ports.derivative_params_dtype == jaxs.derivative_params_dtype
    assert ports.remainder_params_dtype == jaxs.remainder_params_dtype


@pytest.mark.parametrize("mode", ["simultaneous", "staggered"])
def test_forward_sensitivities(mode):
    (ys, sens), _ = _check_pair((("sens_mode", mode),))
    assert sens.shape == (len(TVALS), 2, 2) and np.abs(sens).max() > 0
    s = _port(sens_mode=mode)
    y_out, sens_out = s.make_output_buffers(TVALS)
    assert s.solve(0.0, TVALS, Y0, y_out, sens_out=sens_out) is y_out
    np.testing.assert_array_equal(sens_out, sens)


def test_linear_solver_kinds():
    """'dense_finitediff' against the reference's; 'dense' is every other
    test's."""
    _check_pair((("linear_solver", "dense_finitediff"),))


def test_invalid_args(problem):
    for kw, match in ((dict(solver="RK"), "solver must be"),
                      (dict(sens_mode="staggered1"), "staggered1"),
                      (dict(sens_mode="bogus"), "sens_mode must be"),
                      (dict(linear_solver="magic"), "linear_solver must be"),
                      (dict(linear_solver="band"), "lower_bandwidth"),
                      (dict(options=BDFOptions(), reltol=1e-8), "inside options")):
        with pytest.raises(ValueError, match=match):
            Solver(problem, device="cpu", **kw)
    with pytest.raises(ValueError, match="per-lane tvals"):
        _port().solve(0.0, np.tile(TVALS, (2, 1)), Y0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Solver(problem)  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AdjointSolver(problem)


def test_adams_sens_constructs(problem):
    Solver(problem, solver="ADAMS", sens_mode="simultaneous", device="cpu")


def _lanes(B, lo=0.9, hi=1.1):
    return tuple(map(tuple, np.tile(Y0, (B, 1)) * np.linspace(lo, hi, B)[:, None]))


def test_batched_solve():
    y0 = _lanes(3)
    out, st = _check_pair((), y0)
    assert out.shape == (3, len(TVALS), 2) and st["n_steps"].shape == (3,)
    np.testing.assert_allclose(out[1], _solved("port", (), y0[1])[0], rtol=1e-8)


def test_solver_error_raised():
    msgs = []
    for make, err in ((_port, SolverError), (_jax, JaxSolverError)):
        with pytest.raises(err, match="too many steps") as info:
            make(max_steps=3).solve(0.0, TVALS, Y0)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_stats():
    out, st = _solved("port", (), tuple(Y0))
    assert st["n_steps"] > 10 and st["n_rhs_evals"] > st["n_steps"]
    s = _port()
    s.solve(0.0, TVALS, Y0)
    assert s.current_stats is s.last_stats and int(s.current_stats["n_resumes"]) == 0


def test_pickling():
    s2 = pickle.loads(pickle.dumps(_port()))
    np.testing.assert_array_equal(s2.solve(0.0, TVALS, Y0), _solved("port", (), tuple(Y0))[0])


def test_batched_solve_adams():
    y0 = _lanes(3, 0.95, 1.05)
    out, _ = _check_pair((("solver", "ADAMS"), ("abstol", 1e-9), ("reltol", 1e-9)), y0)
    solo = _port(solver="ADAMS", abstol=1e-9, reltol=1e-9).solve(0.0, TVALS, np.asarray(y0[2]))
    np.testing.assert_allclose(out[2], solo, rtol=1e-6, atol=1e-9)


def test_empty_and_nested_params():
    def rhs(t, y, p):
        return {"x": -y.x * p.rates.k + p.off}

    spec = dict(params={"rates": {"k": ()}, "off": (), "unused": (3,)}, states={"x": ()},
                rhs_sympy=rhs, derivative_params=[("rates", "k")])
    solver = Solver(SympyProblem(**spec), device="cpu", native_single=False)
    solver.set_params_dict({"rates": {"k": 1.0}, "off": 0.5, "unused": np.zeros(3)})
    out = solver.solve(0.0, np.array([1.0, 2.0]), np.array([3.0]))
    np.testing.assert_allclose(out[:, 0], 0.5 + 2.5 * np.exp(-np.array([1.0, 2.0])), rtol=1e-7)


# ---- AdjointSolver ---------------------------------------------------------------
# 'hermite' (the default, spelled out as tests/test_solver_modes.py:132 does)
# over 8,192 recorded rows, which hold the LV solve unthinned: one case for
# tests/test_solver.py's forward-backward and test_solver_modes.py's BDF side
ADJ_BASE = (("checkpoint_n", 8192), ("interpolation", "hermite"))
def _adjoint(side, **kw):
    cls = AdjointSolver if side == "port" else JaxAdjointSolver
    extra = dict(device="cpu") if side == "port" else {}
    extra["native_single"] = False
    s = cls(_problems()[0 if side == "port" else 1], **kw, **extra)
    s.set_params_dict(PARAMS)
    return s


@functools.cache
def _adjoint_run(side: str, config: tuple):
    """Forward and backward of ``AdjointSolver(**dict(config))`` with unit
    cotangents: ``(ys, grad, lamda, forward stats, stats)``."""
    s = _adjoint(side, **dict(config))
    y_out, grad_out, lamda_out = s.make_output_buffers(TVALS)
    s.solve_forward(0.0, TVALS, Y0, y_out)
    fwd = dict(s.last_stats)
    s.solve_backward(TVALS[-1], 0.0, TVALS, np.ones((len(TVALS), 2)), grad_out, lamda_out)
    return y_out, grad_out, lamda_out, fwd, dict(s.last_stats)


def _adjoint_pair(config):
    got, want = _adjoint_run("port", config), _adjoint_run("jax", config)
    _close(got[0], want[0])
    _close(got[1:3], want[1:3], rtol=1e-6, atol=0)
    _stats_close(got[3] | {"n_resumes": 0}, want[3] | {"n_resumes": 0})
    return got


def test_adjoint_solver_forward_backward():
    ys, grad, lam, _, _ = _adjoint_pair(ADJ_BASE)
    assert np.isfinite(grad).all() and np.isfinite(lam).all()
    # dL/dp = sum_i g_i . S(t_i) from the forward sensitivities
    (_, sens), _ = _solved("port", (("sens_mode", "simultaneous"),), tuple(Y0))
    np.testing.assert_allclose(grad, np.einsum("ij,ikj->k", np.ones((len(TVALS), 2)), sens),
                               rtol=1e-4, atol=1e-7)


def test_adjoint_backward_before_forward_raises():
    s = _adjoint("port")
    with pytest.raises(SolverError, match="before solve_forward"):
        s.solve_backward(8.0, 0.0, TVALS, np.ones((len(TVALS), 2)))
    with pytest.raises(SolverError, match="before solve_forward"):
        s.checkpoint_info()


def _info(side, n):
    s = _adjoint(side, checkpoint_n=n)
    # torch's first forward-mode product in a process loads its jvp
    # decompositions, which warn that torch.jit.script is deprecated; load
    # them before recording, so the solve's own warnings are all that is seen
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.func.jvp(torch.sin, (torch.zeros(1),), (torch.ones(1),))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        s.solve_forward(0.0, TVALS, Y0)
    return s.checkpoint_info(), [str(w.message) for w in caught]


def test_checkpoint_info_and_thinning():
    """``checkpoint_info`` on the recorded table, the reference's exactly
    (rows, capacity, thinning level, the times within 1e-6), and a buffer too
    small for the solve thins it with the reference's warning."""
    infos = {}
    for size in ("big", "small"):
        n = 8192 if size == "big" else max(16, infos["big"]["n_recorded"] // 4)
        info, warned = _info("port", n)
        jinfo, jwarned = _info("jax", n)
        for k in ("n_recorded", "capacity", "thinning_level", "overflow"):
            assert info[k] == jinfo[k], k
        # the recorded step times drift from the reference's at ~3e-5
        # relative, with the step counts equal (ROADMAP C2: BDF step sizes
        # follow the libraries' math and the Newton solve)
        np.testing.assert_allclose(info["times"], jinfo["times"], rtol=1e-4, atol=1e-11)
        assert np.all(np.diff(info["times"]) > 0) and info["t_first"] <= TVALS[0]
        assert info["t_last"] >= TVALS[-1] - 1e-9
        assert warned == [w for w in jwarned if "thinned" in w]
        assert bool(warned) == (size == "small")
        infos[size] = info
    assert infos["big"]["thinning_level"] == 0
    assert infos["small"]["overflow"] and infos["small"]["thinning_level"] >= 1
    assert infos["small"]["dt_mean"] > infos["big"]["dt_mean"] * 1.5


def test_adjoint_solver_pickling():
    s2 = pickle.loads(pickle.dumps(_adjoint("port", checkpoint_n=4096)))
    y_out, _, _ = s2.make_output_buffers(TVALS)
    s2.solve_forward(0.0, TVALS, Y0, y_out)
    _close(y_out, _adjoint_run("jax", ADJ_BASE)[0])


def test_adjoint_solver_pickles_after_solve():
    s = _adjoint("port", abstol=1e-8, reltol=1e-8)
    ys = s.solve_forward(0.0, TVALS, Y0)
    s2 = pickle.loads(pickle.dumps(s))
    np.testing.assert_array_equal(s2.solve_forward(0.0, TVALS, Y0), ys)
    fs = _port(abstol=1e-8, reltol=1e-8)
    out = fs.solve(0.0, TVALS, Y0)
    fs2 = pickle.loads(pickle.dumps(fs))
    np.testing.assert_array_equal(fs2.solve(0.0, TVALS, Y0), out)


# ---- tests/test_solver_modes.py -----------------------------------------------------
@functools.cache
def _sens_fd(eps=1e-6):
    """The port's central-FD d y / d (alpha, beta) (the reference test's)."""
    out = np.zeros((len(TVALS), 2, 2))
    for j, name in enumerate(("alpha", "beta")):
        for sgn in (1, -1):
            s = _port()
            p = dict(PARAMS)
            p[name] += sgn * eps
            s.set_params_dict(p)
            out[:, j, :] += sgn * s.solve(0.0, TVALS, Y0) / (2 * eps)
    return out


def test_staggered_matches_fd_on_lv():
    (_, sens), _ = _solved("port", (("sens_mode", "staggered"),), tuple(Y0))
    np.testing.assert_allclose(sens, _sens_fd(), rtol=1e-3, atol=1e-4)


def test_staggered_distinct_from_simultaneous_on_robertson():
    """CV_STAGGERED sequences genuinely: on Robertson (error-test rejections
    in its transient) the profile differs from CV_SIMULTANEOUS while the
    sensitivities agree; each mode the reference's."""
    spec = dict(params={"k1": (), "k2": (), "k3": ()}, states={"a": (), "b": (), "c": ()},
                rhs_sympy=lambda t, y, p: {"a": -p.k1 * y.a + p.k3 * y.b * y.c,
                                           "b": p.k1 * y.a - p.k2 * y.b**2 - p.k3 * y.b * y.c,
                                           "c": p.k2 * y.b**2},
                derivative_params=[("k1",)])
    tvals = np.logspace(-3, 4, 8)
    out = {}
    for mode in ("simultaneous", "staggered"):
        res = []
        for s in (Solver(SympyProblem(**spec), sens_mode=mode, reltol=1e-8, abstol=1e-10,
                         device="cpu", native_single=False),
                  JaxSolver(JaxSympyProblem(**spec), sens_mode=mode, reltol=1e-8, abstol=1e-10,
                            native_single=False)):
            s.set_params_dict({"k1": 0.04, "k2": 3e7, "k3": 1e4})
            y_out, sens_out = s.make_output_buffers(tvals)
            s.solve(0.0, tvals, np.array([1.0, 0.0, 0.0]), y_out, sens_out=sens_out)
            res.append((y_out, sens_out, {k: np.asarray(v) for k, v in s.last_stats.items()}))
        (y, sens, st), (jy, jsens, jst) = res
        _close((y, sens), (jy, jsens))
        _stats_close(st, jst, STEP_STATS + ("n_sens_rhs_evals",))
        out[mode] = (sens, st)
    sens_sim, st_sim = out["simultaneous"]
    sens_stg, st_stg = out["staggered"]
    assert int(st_sim["n_error_test_fails"]) > 0
    assert (int(st_stg["n_sens_rhs_evals"]) != int(st_sim["n_sens_rhs_evals"])
            or int(st_stg["n_steps"]) != int(st_sim["n_steps"]))
    np.testing.assert_allclose(sens_stg, sens_sim, rtol=1e-4, atol=1e-10)


def test_adams_forward_sensitivities():
    config = (("sens_mode", "simultaneous"), ("solver", "ADAMS"))
    (_, sens), _ = _check_pair(config)
    np.testing.assert_allclose(sens[:, :2, :], _sens_fd(), rtol=1e-3, atol=1e-4)
    # the batched path at B=3 against the single chain just held to the
    # reference, at the reference test's tolerances
    _, sens_b = _port(**dict(config)).solve(0.0, TVALS, np.tile(Y0, (3, 1)))
    np.testing.assert_allclose(sens_b[0], sens, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("config", [(("solver", "ADAMS"), ("sens_mode", "staggered"))])
def test_adams_staggered_sensitivities(config):
    """ADAMS with CV_STAGGERED: one chain through the batched core at B=1,
    as the reference."""
    (_, sens), _ = _check_pair(config, keys=STEP_STATS + ("n_sens_rhs_evals",))
    np.testing.assert_allclose(sens, _sens_fd(), rtol=1e-3, atol=1e-4)


def test_adjoint_solver_adams_class_api():
    """AdjointSolver with ADAMS both ways against BDF both ways (hermite,
    unit cotangents), each the reference's."""
    bdf = _adjoint_pair(ADJ_BASE)
    adams = _adjoint_pair(ADJ_BASE + (("solver", "ADAMS"), ("adjoint_solver", "ADAMS")))
    np.testing.assert_allclose(adams[0], bdf[0], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(adams[1], bdf[1], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(adams[2], bdf[2], rtol=1e-3, atol=1e-6)


def test_polynomial_interpolation_real_mode():
    """'polynomial' (CV_POLYNOMIAL) runs silently, the reference's, and
    agrees with 'hermite' to gradient tolerance."""
    base = (("reltol", 1e-8), ("abstol", 1e-8))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        poly = _adjoint_pair(base + (("interpolation", "polynomial"),))
        herm = _adjoint_run("port", base + (("interpolation", "hermite"),))
    np.testing.assert_allclose(poly[1], herm[1], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(poly[2], herm[2], rtol=1e-3, atol=1e-6)


def test_max_steps_retry_recovers():
    """A budget too small for one pass resumes each failed lane from its
    final time, state and step size with a doubled budget: the reference's
    ys, statistics and n_resumes; without retries, SolverError."""
    config = (("reltol", 1e-10), ("abstol", 1e-10), ("max_steps", 40))
    out, st = _check_pair(config, keys=STEP_STATS + ("n_steps_total",))
    assert int(st["n_resumes"]) > 0
    # the reference's own jitted route resumes to 1.33e-8 of the
    # uninterrupted solve here, as the port does (ROADMAP C4; the reference
    # test's 1e-8 is its native route's)
    np.testing.assert_allclose(out, _solved("port", (), tuple(Y0))[0], rtol=2e-8)
    with pytest.raises(SolverError, match="max_steps"):
        _port(reltol=1e-10, abstol=1e-10, max_steps=40, max_retries=0).solve(0.0, TVALS, Y0)


def _hares_at_9(t, y, p):
    return [y.hares - 9.0]


def test_roots_merged_across_resumes():
    """Non-terminal roots of a batch whose lanes resume: the records of
    each segment merged as the reference merges them, exactly (times within
    1e-9), the counts, the statuses and the resumes; a terminal root is a
    success with NaN past it."""
    y0 = _lanes(2, 0.95, 1.05)
    for kw in (dict(roots=_hares_at_9, root_terminal=False, max_steps=60, reltol=1e-8,
                    abstol=1e-8),
               dict(roots=_hares_at_9, reltol=1e-8, abstol=1e-8)):
        res = []
        for make in (_port, _jax):
            s = make(**kw)
            res.append((s.solve(0.0, TVALS, np.asarray(y0)),
                        {k: np.asarray(v) for k, v in s.last_stats.items()}))
        (out, st), (jout, jst) = res
        _close(out, jout)
        _stats_close(st, jst)
        np.testing.assert_array_equal(st["n_roots"], jst["n_roots"])
        np.testing.assert_array_equal(st["roots_found"], jst["roots_found"])
        np.testing.assert_allclose(st["roots_t"], jst["roots_t"], rtol=1e-9, atol=0)
        _close(st["roots_y"], jst["roots_y"])
        if kw.get("root_terminal", True):
            assert (st["n_roots"] == 1).all() and np.isnan(out[:, -1]).all()
        else:
            # lane 0's second root lies in a resumed segment: merged
            assert int(st["n_resumes"]) > 0 and int(st["n_roots"].max()) >= 2


def test_batched_staggered_matches_single():
    """The batched staggered solve, each lane the reference's; lane 0 (Y0)
    against the single staggered chain of ``test_forward_sensitivities`` at
    the reference test's tolerances."""
    y0b = _lanes(2, 1.0, 1.05)
    (ys_b, sens_b), st = _check_pair((("sens_mode", "staggered"),), y0b)
    assert "n_attempts" in st
    (ys_1, sens_1), _ = _solved("port", (("sens_mode", "staggered"),), y0b[0])
    np.testing.assert_allclose(ys_b[0], ys_1, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(sens_b[0], sens_1, rtol=1e-3, atol=1e-5)


def test_adams_sens_err_con_off_does_not_dilute():
    steps_plain = int(_solved("port", (("solver", "ADAMS"), ("reltol", 1e-8), ("abstol", 1e-8)),
                              tuple(Y0))[1]["n_steps"])
    res = []
    for make, opts in ((_port, BDFOptions), (_jax, JaxOptions)):
        s = make(solver="ADAMS", sens_mode="simultaneous",
                 options=opts(rtol=1e-8, atol=1e-8, sens_err_con=False))
        res.append((s.solve(0.0, TVALS, Y0), dict(s.last_stats)))
    (out, st), (jout, jst) = res
    _close(out, jout)
    _stats_close(st, jst)
    assert int(st["n_steps"]) >= steps_plain * 0.9
    np.testing.assert_allclose(out[1][:, :2, :], _sens_fd(), rtol=1e-3, atol=1e-4)


def test_per_lane_grids_and_params():
    """Per-lane grids ``(B, n_t)`` and per-lane params ``(B, n_all)`` on the
    batched cores, the reference's; ``entry.build_lv_forward`` (bench.py's
    lv_forward through the Solver) inside ``lv_forward.npz``'s gate."""
    grids = np.stack([TVALS, np.linspace(0.2, 6.0, 7)])
    res = []
    for make in (_port, _jax):
        s = make(solver="ADAMS", reltol=1e-9, abstol=1e-9)
        s.set_params(np.array([[1.0, 0.3, 1.0, 0.4], [1.1, 0.28, 0.9, 0.42]]))
        res.append((s.solve(0.0, grids, np.tile(Y0, (2, 1))), dict(s.last_stats)))
    _close(res[0][0], res[1][0])
    _stats_close(res[0][1], res[1][1])
    solve, (y0s, ps, tvals) = build_lv_forward(3, device="cpu")
    golden = np.load("tests/golden/lv_forward.npz")
    np.testing.assert_allclose(solve(y0s, ps, tvals), golden["ys"][:3], rtol=2e-7, atol=2e-9)
    np.testing.assert_array_equal(ps, golden["ps"][:3])


# ---- tests/test_f32_class_api.py ----------------------------------------------------
F32 = (("abstol", 1e-5), ("reltol", 1e-5), ("dtype", np.float32))
# the port's float32 against the reference's float32 run of the same call,
# elementwise relative: both round float32 arithmetic in other orders, and
# their step sequences part (ROADMAP C8: at most 8.1e-4, the adjoint's
# lambda; the bound of tests/test_torch_f32.py)
F32_REL = 1e-3


def test_solver_f32_forward_and_batched():
    ref = _solved("port", (), tuple(Y0))[0]
    s32 = _port(**dict(F32))
    assert s32._params.dtype == np.float32 and s32.make_output_buffers(TVALS).dtype == np.float32
    ys = s32.solve(0.0, TVALS, {"hares": 10.0, "lynx": 2.0})
    assert ys.dtype == np.float32
    assert np.max(np.abs(ys - ref)) < 2e-3 * np.max(np.abs(ref))
    (jys, _) = _solved("jax", F32, tuple(Y0))
    np.testing.assert_allclose(ys, jys, rtol=1e-3, atol=1e-4)
    ysb = s32.solve(0.0, TVALS, np.array([[10.0, 2.0], [8.0, 3.0]], np.float32))
    assert ysb.dtype == np.float32 and np.max(np.abs(ysb[0] - ref)) < 2e-3 * np.max(np.abs(ref))


def test_solver_f32_forward_sens():
    config = (("sens_mode", "simultaneous"),) + F32
    (ys, sens), _ = _solved("port", config, tuple(Y0))
    assert ys.dtype == np.float32 and sens.dtype == np.float32
    (jys, jsens), _ = _solved("jax", config, tuple(Y0))
    assert jsens.dtype == np.float32
    np.testing.assert_allclose(ys, jys, rtol=F32_REL, atol=0)
    np.testing.assert_allclose(sens, jsens, rtol=F32_REL, atol=0)
    _, sens64 = _solved("port", (("sens_mode", "simultaneous"),), tuple(Y0))[0]
    assert np.max(np.abs(sens - sens64)) < 5e-3 * np.max(np.abs(sens64))


def _f32_gradient(side):
    """tests/test_f32_class_api.py:99's float32 AdjointSolver: the
    gradient of y_hares(t_end), ``(ys, quad, lamda)``."""
    a32 = _adjoint(side, abstol=1e-5, reltol=1e-5, adjoint_abstol=1e-5, adjoint_reltol=1e-5,
                   checkpoint_n=4096, dtype=np.float32)
    ys = np.asarray(a32.solve_forward(0.0, TVALS, Y0))
    grads = np.zeros((len(TVALS), 2), np.float32)
    grads[-1, 0] = 1.0
    quad, lam = a32.solve_backward(TVALS[-1], 0.0, TVALS, grads)
    return ys, np.asarray(quad), np.asarray(lam)


def test_adjoint_solver_f32_gradient():
    ys32, quad32, lam32 = _f32_gradient("port")
    assert ys32.dtype == np.float32 and quad32.dtype == np.float32
    grads = np.zeros((len(TVALS), 2))
    grads[-1, 0] = 1.0
    for got, want in zip((ys32, quad32, lam32), _f32_gradient("jax")):
        assert want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=F32_REL, atol=0)
    a64 = _adjoint("port", checkpoint_n=4096)
    a64.solve_forward(0.0, TVALS, Y0)
    quad64, lam64 = a64.solve_backward(TVALS[-1], 0.0, TVALS, grads)
    assert np.max(np.abs(quad32 - quad64)) < 5e-3 * max(np.max(np.abs(quad64)), 1.0)
    assert np.max(np.abs(lam32 - lam64)) < 5e-3 * max(np.max(np.abs(lam64)), 1.0)


def test_f32_requires_representable_tolerances(problem):
    with pytest.raises(ValueError, match="float32 precision"):
        Solver(problem, dtype=np.float32, device="cpu")
    with pytest.raises(ValueError, match="float32 precision"):
        AdjointSolver(problem, dtype=np.float32, device="cpu")
    with pytest.raises(ValueError, match="float32 or float64"):
        Solver(problem, dtype=np.int32, device="cpu")


def test_f32_solver_pickles():
    s2 = pickle.loads(pickle.dumps(_port(**dict(F32))))
    assert s2._dtype == np.float32
    assert s2.solve(0.0, TVALS, Y0).dtype == np.float32
