"""sunode_torch's PyTensor wrapper against sunode_tpu's, on the cases of
``tests/test_pytensor.py``.

Each case builds the same graph through both wrappers, compiles it with
``pytensor.function`` and holds the port's outputs on ``device="cpu"`` to
the reference's at ``tests/test_torch_solver.py``'s tolerance for
``AdjointSolver`` against the reference (values and gradients within 1e-6
relative); shapes, named access, the NaN-poisoning of a failed solve, the
``ValueError`` without ``sens_mode`` and the ``NotImplementedError`` for
``derivatives=None`` as the reference's.

One ``pytensor`` serves a process: here the reference's shim, installed
first, so that ``tests/test_pytensor.py`` runs on its own shim whatever
order a worker takes the files in (the port's ``install()`` is then a
no-op).  ``tests/test_torch_no_jax.py`` runs the port's wrapper on the
port's shim, with jax blocked.
"""

import numpy as np
import pytest
import torch

from sunode_tpu._compat.pt_shim import install as _install_reference_shim
from sunode_torch._compat.pt_shim import install as _install_port_shim

_install_reference_shim()
_install_port_shim()

import pytensor  # noqa: E402
import pytensor.tensor as pt  # noqa: E402

from sunode_tpu.wrappers import as_pytensor as ref_wrapper  # noqa: E402
from sunode_torch.wrappers import as_pytensor as port_wrapper  # noqa: E402

REL = 1e-6  # tests/test_torch_solver.py's AdjointSolver gradients against the reference's
CPU = {"device": "cpu", "native_single": False}  # the torch cores, as the reference
TVALS = np.linspace(0.5, 8, 7)
POINT = (1.0, 0.3, 10.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def lv(t, y, p):
    return {
        "hares": p.alpha * y.hares - p.beta * y.lynx * y.hares,
        "lynx": p.delta * y.hares * y.lynx - p.gamma * y.lynx,
    }


def _model(wrapper, derivatives, **solver_kwargs):
    """tests/test_pytensor.py:27-47 through ``wrapper``."""
    alpha = pt.dscalar("alpha")
    beta = pt.dscalar("beta")
    y0_h = pt.dscalar("y0_h")
    solved = wrapper.solve_ivp(
        t0=0.0,
        y0={"hares": (y0_h, ()), "lynx": (np.float64(2.0), ())},
        params={
            "alpha": (alpha, ()),
            "beta": (beta, ()),
            "gamma": np.float64(1.0),
            "delta": np.float64(0.4),
            "extra": np.zeros(1),
        },
        tvals=TVALS,
        rhs=lv,
        derivatives=derivatives,
        solver_kwargs=solver_kwargs,
    )
    return (alpha, beta, y0_h), solved


def _outputs(wrapper, derivatives, wrt, **solver_kwargs):
    """The loss sum(flat**2) and its gradients to ``wrt`` (names among
    alpha, beta, y0_h) at POINT, with the flat solution."""
    variables, solved = _model(wrapper, derivatives, **solver_kwargs)
    flat = solved[1]
    loss = (flat**2).sum()
    named = dict(zip(("alpha", "beta", "y0_h"), variables))
    grads = pytensor.grad(loss, [named[w] for w in wrt])
    f = pytensor.function(list(variables), [loss, flat, *grads])
    return [np.asarray(x) for x in f(*POINT)], solved


def _close(got, want, rel=REL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rel, atol=0)


def test_adjoint_shapes_and_grad():
    """derivatives='adjoint' (AdjointSolver): the loss, the solution and the
    gradients to alpha, beta and y0 (through -lambda) as the reference's."""
    wrt = ("alpha", "beta", "y0_h")
    got, solved = _outputs(port_wrapper, "adjoint", wrt, **CPU)
    want, _ = _outputs(ref_wrapper, "adjoint", wrt)
    assert got[1].shape == (len(TVALS), 2) and np.isfinite(got[0])
    assert len(solved) == 6 and solved[3]._device.type == "cpu"
    _close(got, want)


@pytest.mark.parametrize("sens_mode", ["simultaneous", "staggered"])
def test_forward_shapes_and_grad(sens_mode):
    """derivatives='forward' (Solver with sensitivities): the loss and the
    gradients to alpha, beta and y0 (the '__initial_values' rows), and the
    sensitivities as the reference's."""
    wrt = ("alpha", "beta", "y0_h")
    got, solved = _outputs(port_wrapper, "forward", wrt, sens_mode=sens_mode, **CPU)
    want, ref_solved = _outputs(ref_wrapper, "forward", wrt, sens_mode=sens_mode)
    assert len(solved) == 8
    _close(got, want)
    assert solved[2].params.subset_paths == ref_solved[2].params.subset_paths


def test_forward_sensitivities_as_the_reference():
    """The forward Op's second output, the sensitivities (n_t, n_params,
    n_states), evaluated at the point: the reference's."""
    outs = {}
    for name, wrapper, kw in (("port", port_wrapper, CPU), ("ref", ref_wrapper, {})):
        (alpha, beta, y0_h), solved = _model(wrapper, "forward", sens_mode="simultaneous", **kw)
        f = pytensor.function([alpha, beta, y0_h], [solved[1], solved[6]])
        outs[name] = [np.asarray(x) for x in f(*POINT)]
    assert outs["port"][1].shape == (len(TVALS), 3, 2)
    _close(outs["port"], outs["ref"])


def test_solution_named_access():
    (_, _, _), solved = _model(port_wrapper, "adjoint", **CPU)
    solution = solved[0]
    assert "hares" in solution and "lynx" in solution


def _tvals_grad(wrapper, **solver_kwargs):
    """tests/test_pytensor.py:97-118: the gradient to symbolic tvals, via
    EvalRhs."""
    pt_tvals = pt.dvector("tv")
    alpha = pt.dscalar("alpha")
    solved = wrapper.solve_ivp(
        t0=0.0,
        y0={"hares": (np.float64(10.0), ()), "lynx": (np.float64(2.0), ())},
        params={"alpha": (alpha, ()), "beta": np.float64(0.3), "gamma": np.float64(1.0),
                "delta": np.float64(0.4)},
        tvals=pt_tvals, rhs=lv, derivatives="adjoint", solver_kwargs=solver_kwargs,
    )
    loss = (solved[1] ** 2).sum()
    f = pytensor.function([alpha, pt_tvals], pytensor.grad(loss, pt_tvals))
    return np.asarray(f(1.0, TVALS)), solved[3]


def test_grad_wrt_tvals():
    """d loss / d tvals through EvalRhs (the right-hand side at the
    solution's rows on the solver's device): the reference's, and the rows
    the plain right-hand side gives."""
    got, solver = _tvals_grad(port_wrapper, **CPU)
    want, _ = _tvals_grad(ref_wrapper)
    assert got.shape == TVALS.shape and np.isfinite(got).all()
    _close([got], [want])
    y = np.array([[10.0, 2.0], [3.0, 4.0]])
    rows = port_wrapper.eval_rhs(solver, np.array([1.0]), np.array([0.3, 1.0, 0.4]), y,
                                 np.array([0.0, 1.0]))
    expect = np.stack([y[:, 0] - 0.3 * y[:, 1] * y[:, 0], 0.4 * y[:, 0] * y[:, 1] - y[:, 1]], 1)
    np.testing.assert_allclose(rows, expect, rtol=1e-15)


def test_nan_poisoning_through_op():
    """A failed solve (alpha NaN, as a diverged proposal) gives a NaN loss
    and gradient, as the reference's, and a sound point does not."""
    outs = {}
    for name, wrapper, kw in (("port", port_wrapper, CPU), ("ref", ref_wrapper, {})):
        alpha = pt.dscalar("alpha")
        solved = wrapper.solve_ivp(
            t0=0.0,
            y0={"hares": (np.float64(10.0), ()), "lynx": (np.float64(2.0), ())},
            params={"alpha": (alpha, ()), "beta": np.float64(0.3), "gamma": np.float64(1.0),
                    "delta": np.float64(0.4)},
            tvals=TVALS, rhs=lv, derivatives="adjoint", solver_kwargs=kw,
        )
        loss = (solved[1] ** 2).sum()
        f = pytensor.function([alpha], [loss, pytensor.grad(loss, alpha)])
        outs[name] = [np.asarray(x) for x in (*f(1.0), *f(np.nan))]
    got, want = outs["port"], outs["ref"]
    _close(got[:2], want[:2])
    assert np.isnan(got[2]) and np.isnan(got[3])
    assert np.isnan(want[2]) and np.isnan(want[3])


def test_forward_requires_sens_mode():
    with pytest.raises(ValueError, match="sens_mode"):
        _model(port_wrapper, "forward", **CPU)
    with pytest.raises(ValueError, match="sens_mode"):
        _model(ref_wrapper, "forward")


@pytest.mark.parametrize("derivatives", [None, False])
def test_derivatives_none_is_not_wired(derivatives):
    with pytest.raises(NotImplementedError):
        _model(port_wrapper, derivatives, **CPU)
    with pytest.raises(NotImplementedError):
        _model(ref_wrapper, derivatives)
    with pytest.raises(ValueError, match="Unknown derivatives"):
        _model(port_wrapper, "backward", **CPU)


def test_ops_run_on_the_card_by_default():
    """Without solver_kwargs the wrapper's solver is on the card: without
    one it raises, and no Op falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _model(port_wrapper, "adjoint")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _model(port_wrapper, "forward", sens_mode="simultaneous")
