"""Rootfinding in both batched cores of sunode_torch against the JAX package
(the batch-native and Adams cases of ``tests/test_rootfinding.py``).

The harmonic oscillator y'' = -y from ``(cos phi, -sin phi)`` has ``y0(t) =
cos(t + phi)``: every root, its direction and the state there have closed
forms, and each lane localizes its own root in the shared bisection.  Then
``entry.build_lv_roots``'s Lotka-Volterra event ``hares - 9``.  Both
packages bisect 64 times on their core's dense output, whose steps agree to
the ulps of ``pow`` (ROADMAP C1): root times agree within 1e-10 relative,
and ``n_roots``, the directions and the statuses are equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunode_tpu.ops.adams_batched import adams_solve_batched as jax_adams
from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_tpu.ops.bdf_batched import bdf_solve_batched as jax_bdf
from sunode_tpu.symode import SympyProblem as JaxSympyProblem
from sunode_torch.entry import (
    LV_P_FIX,
    LV_ROOT_CAP,
    _hares_at_9,
    _lv,
    build_lv_roots,
    lv_root_inputs,
)
from sunode_torch.ops.adams_batched import adams_solve_batched
from sunode_torch.ops.bdf import STATUS, BDFOptions
from sunode_torch.ops.bdf_batched import bdf_solve_batched

OPTS = dict(rtol=1e-10, atol=1e-10)
PHASES = np.array([0.0, 0.4, 0.9, 1.4])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: torch is faster on one CPU thread; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _torch_rhs(t, y, p):
    return torch.stack([y[1], -y[0]])


def _torch_jac(t, y, p):
    zero = torch.zeros_like(y[0])
    return torch.stack([torch.stack([zero, zero + 1.0]), torch.stack([zero - 1.0, zero])])


def _jax_rhs(t, y, p):
    return jnp.array([y[1], -y[0]])


def _jax_jac(t, y, p):
    return jnp.array([[0.0, 1.0], [-1.0, 0.0]])


def _first(t, y, p):
    return y[:1]


def _oscillator(method, tvals, **kw):
    """(port result, JAX result) of the oscillator from PHASES."""
    y0 = np.stack([np.cos(PHASES), -np.sin(PHASES)], axis=1)
    p = np.zeros((len(PHASES), 1))
    T = torch.as_tensor
    if method == "BDF":
        got = bdf_solve_batched(_torch_rhs, _torch_jac, 0.0, T(y0), T(p), T(tvals),
                                BDFOptions(**OPTS), root_fn=_first, **kw)
        run = lambda y: jax_bdf(_jax_rhs, _jax_jac, 0.0, y, jnp.asarray(p),  # noqa: E731
                                jnp.asarray(tvals), JaxOptions(**OPTS), root_fn=_first, **kw)
    else:
        got = adams_solve_batched(_torch_rhs, 0.0, T(y0), T(p), T(tvals), BDFOptions(**OPTS),
                                  root_fn=_first, **kw)
        run = lambda y: jax_adams(_jax_rhs, 0.0, y, jnp.asarray(p),  # noqa: E731
                                  jnp.asarray(tvals), JaxOptions(**OPTS), root_fn=_first, **kw)
    return got, jax.jit(run)(jnp.asarray(y0))


def _roots_equal(got, ref):
    """n_roots, directions and statuses equal; recorded root times within
    1e-10 relative, the states there within 1e-9; unrecorded slots inf and
    zero in both."""
    st, rs = got.stats, {k: np.asarray(v) for k, v in ref.stats.items()}
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(st["n_roots"].numpy(), rs["n_roots"])
    np.testing.assert_array_equal(st["roots_found"].numpy(), rs["roots_found"])
    t_got, t_ref = st["roots_t"].numpy(), rs["roots_t"]
    hit = np.isfinite(t_ref)
    np.testing.assert_array_equal(np.isfinite(t_got), hit)
    np.testing.assert_allclose(t_got[hit], t_ref[hit], rtol=1e-10)
    np.testing.assert_allclose(st["roots_y"].numpy()[hit], rs["roots_y"][hit], rtol=1e-9, atol=1e-9)
    ys_got, ys_ref = got.ys.numpy(), np.asarray(ref.ys)
    np.testing.assert_array_equal(np.isnan(ys_got), np.isnan(ys_ref))
    ok = ~np.isnan(ys_ref)
    np.testing.assert_allclose(ys_got[ok], ys_ref[ok], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("method", ["BDF", "ADAMS"])
def test_terminal_roots_per_lane_closed_form(method):
    """Each lane stops at its own first root pi/2 - phi, falling, at the
    state (0, -1), with status ROOT_RETURN; observations past it stay NaN;
    and everything as the JAX package's core."""
    tv = np.linspace(0.0, 3.0, 6)
    got, ref = _oscillator(method, tv)
    assert (got.status.numpy() == STATUS["ROOT_RETURN"]).all()
    assert (got.stats["n_roots"].numpy() == 1).all()
    expect = np.pi / 2 - PHASES
    np.testing.assert_allclose(got.stats["roots_t"].numpy()[:, 0], expect, atol=1e-8)
    np.testing.assert_allclose(got.stats["roots_y"].numpy()[:, 0], np.tile([0.0, -1.0], (4, 1)),
                               atol=1e-8)
    assert (got.stats["roots_found"].numpy()[:, 0, 0] == -1).all()
    ys = got.ys.numpy()[:, :, 0]
    for i, phi in enumerate(PHASES):
        before = tv <= expect[i]
        np.testing.assert_allclose(ys[i, before], np.cos(tv[before] + phi), atol=1e-8)
        assert np.isnan(ys[i, ~before]).all()
    _roots_equal(got, ref)


@pytest.mark.parametrize("method, directions", [("BDF", None), ("ADAMS", None), ("BDF", [1]),
                                                ("ADAMS", [1])],
                         ids=["BDF-both", "ADAMS-both", "BDF-rising", "ADAMS-rising"])
def test_nonterminal_roots_match_jax(method, directions):
    """Non-terminal over [0, 10] with a cap of 2: the first two roots of
    each lane recorded and ``n_roots`` counting past the cap (3 or 4 roots
    both ways); rising only keeps 3 pi/2 - phi (and the next); every lane
    succeeds; as the JAX package's core."""
    got, ref = _oscillator(method, np.linspace(0.0, 10.0, 6), root_terminal=False, root_cap=2,
                           root_directions=directions)
    assert (got.status.numpy() == STATUS["SUCCESS"]).all()
    n_roots = got.stats["n_roots"].numpy()
    if directions is None:
        assert (n_roots > 2).all()
        assert (got.stats["roots_found"].numpy()[:, :, 0] == [-1, 1]).all()
    else:
        np.testing.assert_allclose(got.stats["roots_t"].numpy()[:, 0], 3 * np.pi / 2 - PHASES,
                                   atol=1e-8)
        hit = np.isfinite(got.stats["roots_t"].numpy())
        assert (got.stats["roots_found"].numpy()[:, :, 0][hit] == 1).all()
    _roots_equal(got, ref)


@pytest.mark.parametrize("method, terminal", [("BDF", True), ("BDF", False), ("ADAMS", True),
                                              ("ADAMS", False)],
                         ids=["BDF-terminal", "BDF-falling", "ADAMS-terminal", "ADAMS-falling"])
def test_lv_roots_match_jax(method, terminal):
    """``entry.build_lv_roots`` (hares = 9 on Lotka-Volterra) on 4 of its
    chains and 6 observation times over its horizon: terminal, or non-terminal
    with falling crossings only, against the JAX package's core with the
    event lowered from the same sympy expression; the state at each root on
    the threshold within 1e-6 x 9."""
    solve, (y0s, ps, tvals) = build_lv_roots(4, method, terminal, device="cpu")
    tv = tvals[::4]
    directions = None if terminal else [-1]
    got = solve(y0s, ps, tv, root_directions=directions)
    problem = JaxSympyProblem(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()}, rhs_sympy=_lv,
        derivative_params=[("alpha",), ("beta",)],
    )
    kw = dict(root_fn=problem.make_root_fn(_hares_at_9), root_cap=LV_ROOT_CAP,
              root_terminal=terminal, root_directions=directions)
    opts = JaxOptions(**solve.options._asdict())
    rhs, tv_j = problem.make_rhs(), jnp.asarray(tv.numpy())
    if method == "BDF":
        jac = problem.make_jac_dense()
        run = lambda y, p: jax_bdf(rhs, jac, 0.0, y, p, tv_j, opts, **kw)  # noqa: E731
    else:
        run = lambda y, p: jax_adams(rhs, 0.0, y, p, tv_j, opts, **kw)  # noqa: E731
    ref = jax.jit(run)(jnp.asarray(y0s.numpy()), jnp.asarray(ps.numpy()))
    _roots_equal(got, ref)
    hit = np.isfinite(got.stats["roots_t"].numpy())
    assert hit[:, 0].all()
    assert np.abs(got.stats["roots_y"].numpy()[..., 0][hit] - 9.0).max() <= 1e-6 * 9.0
    if terminal:
        assert (got.status.numpy() == STATUS["ROOT_RETURN"]).all()
    else:
        assert (got.stats["roots_found"].numpy()[..., 0][hit] == -1).all()


@pytest.mark.parametrize("batch", [4, 16, 40])
def test_lv_root_inputs_lead_with_the_golden_chains(batch):
    """Lanes 0-15 of ``build_lv_roots``'s chains are
    ``tests/golden/lv_adjoint.npz``'s at every batch, as its docstring says."""
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden", "lv_adjoint.npz"))
    y0s, ps = lv_root_inputs(batch)
    m = min(batch, 16)
    assert y0s.shape == (batch, 2) and ps.shape == (batch, 4)
    np.testing.assert_array_equal(y0s[:m], golden["y0s"][:m])
    np.testing.assert_array_equal(ps[:m, :2], golden["p_subs"][:m])
    np.testing.assert_array_equal(ps[:, 2:], np.tile(LV_P_FIX, (batch, 1)))
    assert len(np.unique(ps[:, 0])) == batch  # no lane repeats another


@pytest.mark.parametrize("directions, match", [([1, 0], "one entry per"), ([2], "-1")])
def test_root_directions_are_checked(directions, match):
    """``root_directions`` needs one entry in {-1, 0, +1} per event function,
    as the reference's ``_validate_rdir`` checks."""
    y0 = torch.tensor([[1.0, 0.0]], dtype=torch.float64)
    with pytest.raises(ValueError, match=match):
        adams_solve_batched(_torch_rhs, 0.0, y0, torch.zeros((1, 1), dtype=torch.float64),
                            torch.tensor([1.0], dtype=torch.float64), BDFOptions(**OPTS),
                            root_fn=_first, root_directions=directions)
