"""sunode_torch's sparsity plan and structured Jacobians against sunode_tpu's.

``sunode_torch/ops/sparsity.py`` copies the reference's host numpy plan (the
port imports nothing of the JAX package), so every field of a
``SparsePlan`` must be the reference's exactly: the permutation, the border,
the bandwidths, the colors, the seeds and the packed gather maps.  The
structured Jacobians (striped jvps for 'band', colored jvps for 'sparse')
and the sparsity patterns are held against the reference's on the same
numpy-seeded points (``tests/test_sparse.py``, ``tests/test_bbd.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sympy as sy
import torch

from sunode_tpu.ops import sparsity as jsp
from sunode_tpu.problem import JaxProblem
from sunode_tpu.symode import SympyProblem as JaxSympyProblem
from sunode_torch.ops import sparsity as tsp
from sunode_torch.problem import TorchProblem
from sunode_torch.symode import SympyProblem

jax.config.update("jax_enable_x64", True)

PLAN_FIELDS = ("perm", "inv_perm", "k_border", "lower", "upper", "colors", "n_colors", "seeds",
               "row_gather", "col_gather", "mask")


def _arrowhead(n):
    pat = np.eye(n, dtype=bool) | np.eye(n, k=1, dtype=bool) | np.eye(n, k=-1, dtype=bool)
    pat[n - 1, :] = pat[:, n - 1] = True
    return pat


def _scrambled_band(n, w, seed):
    i = np.arange(n)
    band = np.abs(i[:, None] - i[None, :]) <= w
    perm = np.random.default_rng(seed).permutation(n)
    return band[perm][:, perm]


def _random_pattern(n, density, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, n)) < density) | np.eye(n, dtype=bool)


def _two_hubs(n):
    pat = _arrowhead(n)
    pat[3, :] = True  # a second dense row
    return pat


PATTERNS = {
    "arrowhead": _arrowhead(32),
    "arrowhead_transposed": _arrowhead(20).T,
    "tridiagonal": np.abs(np.arange(24)[:, None] - np.arange(24)[None, :]) <= 1,
    "scrambled_band": _scrambled_band(30, 2, 3),
    "random": _random_pattern(18, 0.15, 4),
    "two_hubs": _two_hubs(26),
}


@pytest.mark.parametrize("border", ["auto", 0])
@pytest.mark.parametrize("name", list(PATTERNS))
def test_plan_identical(name, border):
    pat = PATTERNS[name]
    got, want = tsp.SparsePlan(pat, border=border), jsp.SparsePlan(pat, border=border)
    for field in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert got.density_summary() == want.density_summary()


@pytest.mark.parametrize("name", list(PATTERNS))
def test_host_helpers_identical(name):
    pat = PATTERNS[name]
    for fn in ("color_columns", "rcm_permutation", "min_degree_order", "bandwidths"):
        np.testing.assert_array_equal(getattr(tsp, fn)(pat), getattr(jsp, fn)(pat), err_msg=fn)
    for a, b in zip(tsp.csc_pattern(pat), jsp.csc_pattern(pat)):
        np.testing.assert_array_equal(a, b)
    assert tsp.plan_sparse_jacobian(pat, permute=False).lower == jsp.plan_sparse_jacobian(
        pat, permute=False).lower


# ---- problems ---------------------------------------------------------------------
def _kpp_torch(t, y, p):
    u = y.u
    zero = torch.zeros(1, dtype=u.dtype)
    lap = torch.cat([u[1:2] - u[0:1], u[2:] - u[1:-1], u[-2:-1] - u[-1:]])
    lap2 = torch.cat([zero, u[:-2] - u[1:-1], zero])
    return {"u": p.D * (lap + lap2) + p.r * u * (1.0 - u)}


def _kpp_jax(t, y, p):
    u = y.u
    lap = jnp.concatenate([u[1:2] - u[0:1], u[2:] - u[1:-1], u[-2:-1] - u[-1:]])
    lap2 = jnp.concatenate([jnp.zeros(1, u.dtype), u[:-2] - u[1:-1], jnp.zeros(1, u.dtype)])
    return {"u": p.D * (lap + lap2) + p.r * u * (1.0 - u)}


def _hub_torch(t, y, p):
    u = y.u
    zero = torch.zeros(1, dtype=u.dtype)
    lap = torch.cat([u[1:2] - u[0:1], u[2:] - u[1:-1], u[-2:-1] - u[-1:]])
    lap2 = torch.cat([zero, u[:-2] - u[1:-1], zero])
    return {"u": p.D * (lap + lap2) - u * (u - 1.0) + p.c * y.h,
            "h": -p.a * y.h + p.b * torch.mean(u)}


def _hub_jax(t, y, p):
    u = y.u
    lap = jnp.concatenate([u[1:2] - u[0:1], u[2:] - u[1:-1], u[-2:-1] - u[-1:]])
    lap2 = jnp.concatenate([jnp.zeros(1, u.dtype), u[:-2] - u[1:-1], jnp.zeros(1, u.dtype)])
    return {"u": p.D * (lap + lap2) - u * (u - 1.0) + p.c * y.h,
            "h": -p.a * y.h + p.b * jnp.mean(u)}


def _pair(kind, n):
    if kind == "kpp":
        spec = dict(params={"D": (), "r": ()}, states={"u": (n,)},
                    derivative_params=[("D",), ("r",)])
        return TorchProblem(rhs=_kpp_torch, **spec), JaxProblem(rhs=_kpp_jax, **spec)
    spec = dict(params={"D": (), "a": (), "b": (), "c": ()}, states={"u": (n,), "h": ()},
                derivative_params=[("D",), ("b",)])
    return TorchProblem(rhs=_hub_torch, **spec), JaxProblem(rhs=_hub_jax, **spec)


def _points(tp, B, seed):
    rng = np.random.default_rng(seed)
    y = rng.uniform(0.2, 0.9, (tp.n_states, B))
    p = rng.uniform(0.5, 8.0, (tp.n_all_params, B))
    t = rng.uniform(0.0, 1.0, B)
    return t, y, p


@pytest.mark.parametrize("lower, upper", [(1, 1), (2, 1), (0, 2)])
def test_banded_jacobians_match_jax(lower, upper):
    """``make_banded_jac`` and ``make_banded_jac_dense`` on every lane at
    once against the reference's on each lane (1e-13)."""
    tp, jp = _pair("kpp", 12)
    t, y, p = _points(tp, 4, lower + 3 * upper)
    ab = tp.make_banded_jac(lower, upper)(torch.as_tensor(t), torch.as_tensor(y),
                                          torch.as_tensor(p)).numpy()
    dense = tp.make_banded_jac_dense(lower, upper)(torch.as_tensor(t), torch.as_tensor(y),
                                                   torch.as_tensor(p)).numpy()
    jab, jdense = jp.make_banded_jac(lower, upper), jp.make_banded_jac_dense(lower, upper)
    for lane in range(4):
        args = (t[lane], jnp.asarray(y[:, lane]), jnp.asarray(p[:, lane]))
        np.testing.assert_allclose(ab[..., lane], np.asarray(jab(*args)), rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(dense[..., lane], np.asarray(jdense(*args)), rtol=1e-13,
                                   atol=1e-13)


@pytest.mark.parametrize("kind, n", [("kpp", 10), ("hub", 9)])
def test_probe_sparsity_matches_jax(kind, n):
    tp, jp = _pair(kind, n)
    np.testing.assert_array_equal(tp.jac_sparsity(), jp.jac_sparsity())


def test_sympy_exact_sparsity_matches_jax():
    """``tests/test_sparse.py::test_sympy_exact_sparsity``: a chain whose
    Jacobian has structural zeros sympy proves, on both packages."""

    def rhs(t, y, p):
        x = y.x
        return {"x": [-p.k * x[0] + x[1] ** 2, p.k * x[0] - x[2], sy.sin(x[1]) * x[3], -x[3]]}

    spec = dict(params={"k": ()}, states={"x": (4,)}, rhs_sympy=rhs)
    got = SympyProblem(**spec).jac_sparsity()
    np.testing.assert_array_equal(got, JaxSympyProblem(**spec).jac_sparsity())
    assert got.sum() == 7


def test_colored_packed_jac_matches_jax():
    """``tests/test_bbd.py::test_colored_packed_jac_matches_autodiff``: the
    hub's bordered plan, its packed Jacobian from colored jvps over four
    lanes against the reference's lane by lane (1e-13)."""
    tp, jp = _pair("hub", 16)
    plan = tsp.SparsePlan(tp.jac_sparsity())
    assert plan.k_border >= 1
    jplan = jsp.SparsePlan(jp.jac_sparsity())
    t, y, p = _points(tp, 4, 1)
    got = tsp.make_colored_banded_jac(tp.make_rhs(), plan)(
        torch.as_tensor(t), torch.as_tensor(y), torch.as_tensor(p)).numpy()
    jac = jsp.make_colored_banded_jac(jp.make_rhs(), jplan)
    for lane in range(4):
        want = jac(t[lane], jnp.asarray(y[:, lane]), jnp.asarray(p[:, lane]))
        np.testing.assert_allclose(got[..., lane], np.asarray(want), rtol=1e-13, atol=1e-13)
