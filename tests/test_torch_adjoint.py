"""The whole slice: sunode_torch's differentiable batched solve against
sunode_tpu's on the golden Lotka-Volterra lanes, with the main-path
workload's options (``__graft_entry__._build``, method ADAMS)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_tpu.symode import SympyProblem as JaxSympyProblem
from sunode_tpu.wrappers.as_jax import make_batched_solve_fn as jax_make
from sunode_torch.convert import df_pairs_to_f64, inputs_from_numpy, options_from_fields
from sunode_torch.experiments import exp_pece2d
from sunode_torch.entry import _lv, build_lv_adjoint, build_lv_checkpointed, lv_options, lv_problem
from sunode_torch.ops.bdf import BDFOptions
from sunode_torch.wrappers.as_torch import make_batched_solve_fn

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
RTOL = 1e-8


def _jax_options():
    bwd = RTOL * 10.0
    adj_rtol = np.concatenate([np.full(2, bwd), np.full(4, 1e-3)])
    return (
        JaxOptions(rtol=RTOL, atol=RTOL, adams_max_order=6),
        JaxOptions(rtol=adj_rtol, atol=bwd, adams_max_order=6,
                   quad_rtol=1e-3, quad_atol=1e-3),
    )


def _as_numpy_fields(opts):
    return {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in opts._asdict().items()}


@pytest.fixture(scope="module")
def setup():
    g = np.load(os.path.join(GOLDEN, "lv_adjoint.npz"))
    jp = JaxSympyProblem(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()},
        rhs_sympy=_lv,
        derivative_params=[("alpha",), ("beta",)],
    )
    jfwd, jadj = _jax_options()
    jsolve = jax_make(jp, derivatives="adjoint", options=jfwd, adjoint_options=jadj,
                      checkpoint_n=384, method="ADAMS", adjoint_interpolation="transition")
    tsolve = make_batched_solve_fn(
        lv_problem(), derivatives="adjoint",
        options=options_from_fields(_as_numpy_fields(jfwd)),
        adjoint_options=options_from_fields(_as_numpy_fields(jadj)),
        method="ADAMS", adjoint_interpolation="transition",
    )
    return g, jsolve, tsolve


def _jax_grads(jsolve, g, y0s, p_subs, t0=0.0):
    def loss(t0, y0s, p_subs, tvals):
        return jnp.sum(jsolve(t0, y0s, p_subs, jnp.asarray(g["p_fix"]), tvals) ** 2)

    out = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        t0, jnp.asarray(y0s), jnp.asarray(p_subs), jnp.asarray(g["tvals"])
    )
    return [np.asarray(a) for a in out]


def _torch_grads(tsolve, g, y0s, p_subs, t0=None):
    y, p, pf, tv = inputs_from_numpy(y0s, p_subs, g["p_fix"], g["tvals"], device="cpu")
    leaves = [y.requires_grad_(), p.requires_grad_(), tv.requires_grad_()]
    if t0 is not None:
        t0 = torch.tensor(t0, dtype=torch.float64, requires_grad=True)
        leaves.append(t0)
    ys = tsolve(0.0 if t0 is None else t0, y, p, pf, tv)
    return [a.numpy() for a in torch.autograd.grad(torch.sum(ys**2), leaves)]


@pytest.fixture(scope="module")
def golden_grads(setup):
    g, jsolve, tsolve = setup
    return _jax_grads(jsolve, g, g["y0s"], g["p_subs"]), _torch_grads(
        tsolve, g, g["y0s"], g["p_subs"], t0=0.0
    )


@pytest.mark.parametrize("which", ["y0s", "p_subs", "tvals", "t0"])
def test_gradients_match_jax(golden_grads, which):
    (jt0, jy, jp, jtv), (ty, tp, ttv, tt0) = golden_grads
    got, want = {"y0s": (ty, jy), "p_subs": (tp, jp), "tvals": (ttv, jtv), "t0": (tt0, jt0)}[which]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_gradients_match_golden(setup, golden_grads):
    g = setup[0]
    _, (ty, tp, _, _) = golden_grads
    np.testing.assert_allclose(ty, g["gy"], rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(tp, g["gp"], rtol=2e-3, atol=1e-3)


def test_nan_lane_poisons_only_itself(setup):
    g, jsolve, tsolve = setup
    y0s, p_subs = g["y0s"][:6].copy(), g["p_subs"][:6]
    y0s[3, 0] = np.nan
    _, jy, jp, jtv = _jax_grads(jsolve, g, y0s, p_subs)
    ty, tp, ttv = _torch_grads(tsolve, g, y0s, p_subs)
    for got, want in ((ty, jy), (tp, jp)):
        assert np.isnan(got[3]).all() and np.isnan(want[3]).all()
        assert np.isfinite(np.delete(got, 3, axis=0)).all()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    # shared tvals collect every lane: one bad lane poisons them, as in JAX
    assert np.isnan(ttv).all() and np.isnan(jtv).all()


def test_forward_only_matches_jax(setup):
    g, _, _ = setup
    jfwd, _ = _jax_options()
    jp = JaxSympyProblem(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()},
        rhs_sympy=_lv,
        derivative_params=[("alpha",), ("beta",)],
    )
    jsolve = jax_make(jp, derivatives=None, options=jfwd, method="ADAMS")
    want = jax.jit(lambda y, p: jsolve(0.0, y, p, jnp.asarray(g["p_fix"]), jnp.asarray(g["tvals"])))(
        jnp.asarray(g["y0s"]), jnp.asarray(g["p_subs"])
    )
    tsolve = make_batched_solve_fn(
        lv_problem(), derivatives=None, options=BDFOptions(rtol=RTOL, atol=RTOL, adams_max_order=6),
        method="ADAMS",
    )
    got = tsolve(0.0, *inputs_from_numpy(g["y0s"], g["p_subs"], g["p_fix"], g["tvals"], device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8)
    np.testing.assert_allclose(got.numpy(), g["ys"], rtol=3e-6, atol=1e-7)


def test_entry_matches_graft_entry():
    """build_lv_adjoint is __graft_entry__._build ported: same inputs, same
    options, same gradients."""
    import __graft_entry__ as ge

    jstep, (jy0, jp0) = ge._build(batch=4, tvals_n=5, rtol=1e-6, checkpoint_n=64)
    tstep, (ty0, tp0) = build_lv_adjoint(batch=4, tvals_n=5, rtol=1e-6, device="cpu")
    np.testing.assert_array_equal(ty0.numpy(), np.asarray(jy0))
    np.testing.assert_array_equal(tp0.numpy(), np.asarray(jp0))
    jgy, jgp = jax.jit(jstep)(jy0, jp0)
    tgy, tgp = tstep(ty0, tp0)
    np.testing.assert_allclose(tgy.numpy(), np.asarray(jgy), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tgp.numpy(), np.asarray(jgp), rtol=1e-6, atol=1e-9)
    stats = tstep.solve.last_stats
    assert stats["forward"]["n_attempts"] > 0 and stats["backward"]["n_attempts"] > 0



def test_grad_step_over_other_observation_times():
    """grad_step(y0s, p_subs, tvals=...) is the same step over other times
    (chip_smoke.py's phase 6 profiles the checkpointed step, which shares
    this body, over the leading quarter)."""
    step, (y0s, p_subs) = build_lv_adjoint(batch=2, tvals_n=9, rtol=1e-6, device="cpu")
    short = step.tvals[:3]
    y = y0s.detach().requires_grad_(True)
    p = p_subs.detach().requires_grad_(True)
    want = torch.autograd.grad(torch.sum(step.solve(0.0, y, p, step.p_fix, short) ** 2), (y, p))
    got = step(y0s, p_subs, tvals=short)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert step.solve.last_stats["forward"]["n_attempts"] > 0
    full = step(y0s, p_subs)
    assert not torch.equal(full[0], got[0])

def test_options_carry_over_field_for_field():
    jfwd, jadj = _jax_options()
    fwd, adj = lv_options(RTOL)
    for jo, to in ((jfwd, fwd), (jadj, adj)):
        carried = options_from_fields(_as_numpy_fields(jo))
        assert carried._fields == jo._fields
        for name in jo._fields:
            np.testing.assert_array_equal(np.asarray(getattr(carried, name)), np.asarray(getattr(to, name)))
    with pytest.raises(ValueError):
        options_from_fields({"not_an_option": 1})


@pytest.mark.parametrize(
    "entry",
    [
        lambda: build_lv_adjoint(batch=2, tvals_n=3, rtol=1e-6),
        lambda: build_lv_checkpointed(batch=2, tvals_n=3, rtol=1e-6),
        lambda: inputs_from_numpy(np.ones((2, 2)), np.ones((2, 2)), np.ones(2), np.ones(3)),
        lambda: df_pairs_to_f64(np.ones(3, np.float32), np.zeros(3, np.float32)),
        lambda: exp_pece2d.run([8]),
    ],
    ids=["build_lv_adjoint", "build_lv_checkpointed", "inputs_from_numpy", "df_pairs_to_f64",
         "exp_pece2d"],
)
def test_entry_points_default_to_the_card(entry):
    """Without a card the default device raises: nothing quietly runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


@pytest.mark.parametrize(
    "kwargs, error",
    [(dict(method="BDF", derivatives="forward"), NotImplementedError),
     (dict(method="ADAMS", adjoint_interpolation="hermite", linear_solver="banded"), ValueError),
     (dict(method="ADAMS", adjoint_interpolation="polynomial", linear_solver="krylov"),
      ValueError),
     (dict(method="ADAMS", adjoint_interpolation="resolve", linear_solver="band",
           linear_solver_kwargs=dict(lower_bandwidth=1, upper_bandwidth=1)), ValueError),
     (dict(method="ADAMS", derivatives="forward"), NotImplementedError)],
    ids=["bdf", "hermite", "polynomial", "resolve", "forward-sens"],
)
def test_unported_modes_raise(kwargs, error):
    """Batched forward sensitivities are not in the reference either; the
    ADAMS checkpointed and resolve adjoints are ported
    (tests/test_torch_adams_checkpoint.py), and the structured linear
    solvers ('band', 'sparse'; tests/test_torch_structured.py), which the
    reference refuses with ADAMS, as it refuses an unknown solver's name
    (ValueError)."""
    with pytest.raises(error):
        make_batched_solve_fn(lv_problem(), **kwargs)
