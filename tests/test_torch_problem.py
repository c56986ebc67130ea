"""``TorchProblem`` and the base class's autodiff defaults against the JAX
package's ``JaxProblem``.

The same models (SIR over 4 regions on a ring, Lotka-Volterra) are written
once in ``jnp`` and once in ``torch``; every factory gets the same seeded
float64 inputs.  The port's factories take trailing batch dims, the
reference's one lane: the reference runs lane by lane through ``jax.vmap``
over the flattened batch.  Both sides differentiate the same elementary
operations, so the tolerance, 1e-13 relative, is a few ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sympy as sy
import torch

from sunode_tpu.problem import JaxProblem
from sunode_torch import TorchProblem
from sunode_torch.ops.bdf import BDFOptions
from sunode_torch.problem import over_lanes
from sunode_torch.symode.problem import SympyProblem
from sunode_torch.wrappers.as_torch import make_batched_solve_fn

R = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: torch is faster on one CPU thread (a batched LU of tiny
    matrices is far slower on many); restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SIR_SPEC = dict(
    params={"beta": (), "gamma": (), "mix": ()},
    states={"S": (R,), "I": (R,), "R": (R,)},
    derivative_params=[("beta",), ("gamma",)],
)
LV_SPEC = dict(
    params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
    states={"hares": (), "lynx": ()},
    derivative_params=[("alpha",), ("delta",)],
)


def _sir(roll):
    def rhs(t, y, p):
        i_eff = y.I + p.mix * (roll(y.I, 1) + roll(y.I, -1))
        inf = p.beta * y.S * i_eff
        rec = p.gamma * y.I
        return {"S": -inf, "I": inf - rec, "R": rec}

    return rhs


def _lv(t, y, p):
    return {
        "hares": p.alpha * y.hares - p.beta * y.lynx * y.hares,
        "lynx": p.delta * y.hares * y.lynx - p.gamma * y.lynx,
    }


MODELS = {
    "sir": (SIR_SPEC, _sir(jnp.roll), _sir(lambda x, k: torch.roll(x, k, 0))),
    "lv": (LV_SPEC, _lv, _lv),
}


def _pair(model):
    spec, rhs_j, rhs_t = MODELS[model]
    return JaxProblem(rhs=rhs_j, **spec), TorchProblem(rhs=rhs_t, **spec)


# factory: the inputs it takes after t
FACTORIES = {
    "make_rhs": "y p",
    "make_jac_dense": "y p",
    "make_dfdp": "y p",
    "make_adjoint_rhs": "y lam p",
    "make_adjoint_quad_rhs": "y lam p",
    "make_sensitivity_rhs": "y S p",
    "make_rhs_jac_prod": "y lam p",
}


def _inputs(problem, batch, seed):
    """Seeded lanes, leading batch (the reference's): t, y, lam, S, p."""
    rng = np.random.default_rng(seed)
    n, n_p, k = problem.n_states, problem.n_all_params, problem.n_params
    return dict(
        t=rng.uniform(0.0, 2.0, batch),
        y=rng.uniform(0.1, 1.0, batch + (n,)),
        lam=rng.standard_normal(batch + (n,)),
        S=rng.standard_normal(batch + (k, n)),
        p=rng.uniform(0.1, 1.0, batch + (n_p,)),
    )


def _reference(jp, factory, x, names, batch):
    fn = getattr(jp, factory)()
    flat = [jnp.asarray(x[k].reshape((-1,) + x[k].shape[len(batch):])) for k in ["t", *names]]
    out = np.asarray(jax.vmap(fn)(*flat))
    return out.reshape(batch + out.shape[1:])


def _trailing(a, batch):
    """Leading batch dims moved behind the item dims (the port's layout)."""
    nb = len(batch)
    return torch.as_tensor(np.moveaxis(a, tuple(range(nb)), tuple(range(a.ndim - nb, a.ndim))))


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("factory", sorted(FACTORIES))
@pytest.mark.parametrize("batch", [(), (5,), (3, 5)], ids=["lane", "B", "n_t-B"])
def test_factories_match_jax(model, factory, batch):
    jp, tp = _pair(model)
    names = FACTORIES[factory].split()
    x = _inputs(jp, batch, seed=len(batch) + 10 * len(factory))
    want = _reference(jp, factory, x, names, batch)
    args = [_trailing(x[k], batch) for k in ["t", *names]]
    got = getattr(tp, factory)()(*args)
    nb = len(batch)
    got = np.moveaxis(got.numpy(), tuple(range(got.ndim - nb, got.ndim)), tuple(range(nb)))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-13


@pytest.mark.parametrize("factory", ["make_rhs", "make_adjoint_rhs", "make_dfdp"])
def test_parameters_broadcast_as_the_wrapper_passes_them(factory):
    """``as_torch`` evaluates the right-hand side at every observation with
    ``t (n_t, B)``, ``y (n, n_t, B)`` and ``p (n_p, 1, B)``; a shared float
    ``t`` broadcasts too."""
    jp, tp = _pair("sir")
    names = FACTORIES[factory].split()
    n_t, B = 3, 4
    x = _inputs(jp, (n_t, B), seed=4)
    x["p"] = np.broadcast_to(x["p"][:1], x["p"].shape).copy()  # one p per lane
    want = _reference(jp, factory, x, names, (n_t, B))
    args = [_trailing(x[k], (n_t, B)) for k in ["t", *names]]
    args[-1] = args[-1][:, :1, :]  # (n_p, 1, B)
    got = getattr(tp, factory)()(*args).numpy()
    assert _rel(np.moveaxis(got, (-2, -1), (0, 1)), want) <= 1e-13
    x["t"][:] = 0.5
    want = _reference(jp, factory, x, names, (n_t, B))
    got = getattr(tp, factory)()(0.5, *args[1:]).numpy()
    assert _rel(np.moveaxis(got, (-2, -1), (0, 1)), want) <= 1e-13


def test_adjoint_jac_dense_is_minus_the_transpose():
    jp, tp = _pair("sir")
    x = _inputs(jp, (5,), seed=2)
    t, y, lam, p = (_trailing(x[k], (5,)) for k in ("t", "y", "lam", "p"))
    J = tp.make_jac_dense()(t, y, p)
    assert torch.equal(tp.make_adjoint_jac_dense()(t, y, lam, p), -J.transpose(0, 1))


def test_non_dict_rhs_raises_as_the_reference():
    spec = LV_SPEC
    jp = JaxProblem(rhs=lambda t, y, p: [y.hares, y.lynx], **spec)
    tp = TorchProblem(rhs=lambda t, y, p: [y.hares, y.lynx], **spec)
    with pytest.raises(TypeError) as want:
        jp.make_rhs()(0.0, jnp.ones(2), jnp.ones(4))
    with pytest.raises(TypeError) as got:
        tp.make_rhs()(torch.zeros(3, dtype=torch.float64), torch.ones(2, 3, dtype=torch.float64),
                      torch.ones(4, 3, dtype=torch.float64))
    assert str(got.value) == str(want.value).replace("JaxProblem", "TorchProblem")


def test_over_lanes_shapes():
    """Item dims lead, batch dims trail and broadcast from the right; a
    float argument takes the first tensor's dtype."""
    f = over_lanes(lambda t, y, M: M @ y + t, (0, 1, 2))
    y = torch.ones(3, 4, 5, dtype=torch.float64)  # (n, 4, 5)
    M = torch.eye(3, dtype=torch.float64)[:, :, None]  # (n, n, 1)
    out = f(2.0, y, M)
    assert out.shape == (3, 4, 5) and out.dtype == torch.float64
    assert torch.equal(out, torch.full((3, 4, 5), 3.0, dtype=torch.float64))


def _sir_sympy(R_):
    def rhs(t, y, p):
        I = np.asarray(y.I, dtype=object)  # noqa: E741
        i_eff = I + p.mix * (np.roll(I, 1) + np.roll(I, -1))
        inf = p.beta * np.asarray(y.S, dtype=object) * i_eff
        rec = p.gamma * I
        return {"S": -inf, "I": inf - rec, "R": rec}

    return SympyProblem(rhs_sympy=rhs, **SIR_SPEC)


def test_default_call_matches_the_sympy_form():
    """``make_batched_solve_fn``'s default call (BDF, checkpointed 'hermite'
    adjoint) on the SIR model as a TorchProblem and as a SympyProblem of the
    port: the same ys and gradients within 1e-10 (the two forms round the
    right-hand side and its derivatives otherwise)."""
    rng = np.random.default_rng(8)
    B = 3
    y0 = np.concatenate([0.99 + 0.005 * rng.standard_normal((B, R)),
                         0.01 * np.abs(1 + 0.1 * rng.standard_normal((B, R))),
                         np.zeros((B, R))], axis=1)
    psub = np.stack([0.4 * (1 + 0.05 * rng.standard_normal(B)),
                     0.15 * (1 + 0.05 * rng.standard_normal(B))], axis=1)
    tvals = torch.as_tensor(np.linspace(5.0, 30.0, 4))
    opts = BDFOptions(rtol=1e-9, atol=1e-11)
    out = []
    for problem in (TorchProblem(rhs=MODELS["sir"][2], **SIR_SPEC), _sir_sympy(R)):
        solve = make_batched_solve_fn(problem, options=opts,
                                      adjoint_options=BDFOptions(rtol=1e-9, atol=1e-11))
        y0_t = torch.as_tensor(y0).requires_grad_(True)
        p_t = torch.as_tensor(psub).requires_grad_(True)
        ys = solve(0.0, y0_t, p_t, torch.as_tensor([0.05]), tvals)
        grads = torch.autograd.grad(torch.sum(ys[:, :, R : 2 * R] ** 2), (y0_t, p_t))
        assert (solve.last_stats["backward"]["status"] == 0).all()
        out.append([ys.detach().numpy(), *(g.numpy() for g in grads)])
    for got, want in zip(*out):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)


def test_sympy_form_is_the_same_model():
    """The sympy form's right-hand side is the torch form's, to rounding."""
    tp, sp = TorchProblem(rhs=MODELS["sir"][2], **SIR_SPEC), _sir_sympy(R)
    x = _inputs(tp, (6,), seed=5)
    args = [_trailing(x[k], (6,)) for k in ("t", "y", "p")]
    assert isinstance(sp.sym_rhs[0], sy.Expr)
    np.testing.assert_allclose(tp.make_rhs()(*args).numpy(), sp.make_rhs()(*args).numpy(),
                               rtol=1e-14)
