"""sunode_torch's banded LU, BBD Schur solve and GMRES against sunode_tpu's.

The same numpy-seeded matrices go through ``sunode_tpu/ops/banded.py``,
``bbd.py`` and ``krylov.py`` (vmapped over the lanes, float64) and through
the port's plain versions (the lane axis last).  The port rounds every
operation of the factor and the solve on its own, as its CUDA kernels do;
XLA on the CPU contracts a product and a difference into one FMA, so the
factors agree with the reference's to an ulp (normwise 1e-13), the pivots
and the singular flags exactly.  The kernels themselves need a card
(``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunode_tpu.ops import banded as jb
from sunode_tpu.ops import bbd as jbbd
from sunode_tpu.ops.krylov import gmres_solve as jax_gmres
from sunode_tpu.ops.krylov import gmres_solve_batched as jax_gmres_b
from sunode_tpu.ops.sparsity import SparsePlan as JaxPlan
from sunode_torch.ops import banded as tb
from sunode_torch.ops import bbd as tbbd
from sunode_torch.ops.krylov import gmres_solve, gmres_solve_batched
from sunode_torch.ops.sparsity import SparsePlan

jax.config.update("jax_enable_x64", True)

SHAPES = [(7, 1, 1), (9, 2, 1), (6, 0, 2), (5, 3, 0), (12, 2, 3)]
NORMWISE = 1e-13  # the reference's FMA contraction: an ulp an element


def _normwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    fin = np.isfinite(b)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    return float(np.max(np.abs(a[fin] - b[fin])) / max(np.max(np.abs(b[fin])), 1e-300))


def _banded_lanes(n, l, u, B, seed, dtype=np.float64):
    """(B, n, n) random matrices inside the band, lane 1 singular (zero),
    lane 2 with a NaN in its first pivot; and their banded storage."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    band = ((i[:, None] - i[None, :]) <= l) & ((i[None, :] - i[:, None]) <= u)
    A = rng.standard_normal((B, n, n)) * band
    A[1] = 0.0
    A[2, 0, 0] = np.nan
    ab = np.stack([np.asarray(jb.dense_to_banded(jnp.asarray(a), l, u)) for a in A])
    return A.astype(dtype), ab.astype(dtype)


@pytest.mark.parametrize("n, l, u", SHAPES)
def test_dense_banded_roundtrip(n, l, u):
    A, ab = _banded_lanes(n, l, u, 3, seed=n)
    A, ab = np.nan_to_num(A), np.nan_to_num(ab)
    got = tb.dense_to_banded(torch.as_tensor(A.transpose(1, 2, 0)), l, u).numpy()
    np.testing.assert_array_equal(got, ab.transpose(1, 2, 0))
    back = tb.banded_to_dense(torch.as_tensor(got), l, u).numpy().transpose(2, 0, 1)
    want = np.stack([np.asarray(jb.banded_to_dense(jnp.asarray(a), l, u)) for a in ab])
    np.testing.assert_array_equal(back, want)


@pytest.mark.parametrize("n, l, u", SHAPES)
def test_factor_solve_matches_jax(n, l, u):
    """lu within an ulp, piv and sing equal, singular lanes NaN, the
    solutions within 1e-13 normwise of the reference's."""
    B = 5
    A, ab = _banded_lanes(n, l, u, B, seed=10 + n)
    lu, piv, sing = tb.banded_factor(torch.as_tensor(ab.transpose(1, 2, 0).copy()), l, u)
    jf = jax.vmap(lambda a: jb.banded_factor(a, l, u))(jnp.asarray(ab))
    assert _normwise(lu.numpy(), np.asarray(jf[0]).transpose(1, 2, 0)) <= NORMWISE
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jf[1]).T)
    np.testing.assert_array_equal(sing.numpy(), np.asarray(jf[2]))
    assert sing[1] and not sing[0]

    b = np.random.default_rng(n).standard_normal((B, n))
    x = tb.banded_solve((lu, piv, sing), torch.as_tensor(b.T.copy())[None], l, u)[0].numpy()
    xj = np.asarray(jax.vmap(lambda f0, f1, f2, bb: jb.banded_solve((f0, f1, f2), bb, l, u))(
        jf[0], jf[1], jf[2], jnp.asarray(b))).T
    # lane 2's NaN pivot was replaced by _TINY: its solution is garbage of
    # magnitude ~1e300 whose digits follow the reference's FMAs, so only its
    # pattern of finite entries is compared
    rest = [0, 1, 3, 4]
    assert _normwise(x[:, rest], xj[:, rest]) <= NORMWISE
    np.testing.assert_array_equal(np.isfinite(x[:, 2]), np.isfinite(xj[:, 2]))
    assert np.isnan(x[:, 1]).all()
    for k in (0, 3, 4):
        np.testing.assert_allclose(x[:, k], np.linalg.solve(A[k], b[k]), rtol=1e-9, atol=1e-12)


def test_solve_many_right_hand_sides():
    """``b (m, n, B)`` in one call is, bit for bit, m calls of one right-hand
    side; ``sing`` None leaves a singular lane unpoisoned."""
    n, l, u, B, m = 10, 2, 1, 4, 3
    _, ab = _banded_lanes(n, l, u, B, seed=3)
    f = tb.banded_factor(torch.as_tensor(np.nan_to_num(ab).transpose(1, 2, 0).copy()), l, u)
    b = torch.as_tensor(np.random.default_rng(4).standard_normal((m, n, B)))
    x = tb.banded_solve(f, b, l, u)
    for j in range(m):
        assert torch.equal(torch.nan_to_num(x[j : j + 1], nan=7.0),
                           torch.nan_to_num(tb.banded_solve(f, b[j : j + 1], l, u), nan=7.0))
    assert torch.isnan(x[:, :, 1]).all()
    raw = tb.banded_solve((f[0], f[1], None), b, l, u)
    assert torch.equal(raw[:, :, [0, 2, 3]], x[:, :, [0, 2, 3]])
    assert not torch.isnan(raw[:, :, 1]).all()


def test_float32_tiny_is_zero():
    """At float32 the reference's 1e-300 rounds to 0: a zero pivot is
    singular, and the pivots and flags follow the reference's float32 run."""
    n, l, u, B = 8, 1, 2, 4
    _, ab = _banded_lanes(n, l, u, B, seed=5, dtype=np.float32)
    ab = np.nan_to_num(ab)
    lu, piv, sing = tb.banded_factor(torch.as_tensor(ab.transpose(1, 2, 0).copy()), l, u)
    jf = jax.vmap(lambda a: jb.banded_factor(a, l, u))(jnp.asarray(ab, jnp.float32))
    assert lu.dtype == torch.float32
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jf[1]).T)
    np.testing.assert_array_equal(sing.numpy(), np.asarray(jf[2]))
    assert sing.tolist() == [False, True, False, False]
    assert _normwise(lu.numpy(), np.asarray(jf[0]).transpose(1, 2, 0)) <= 1e-6


@pytest.mark.parametrize("l, u", [(1, 1), (2, 1), (0, 2), (3, 0), (4, 3)])
def test_geometry_fits_a_block(l, u):
    """The kernels' rings and kept rows fit a block's 227 KB at every tested
    pair, n, type, B and m; the solve keeps at least the rows its backward
    ring's first chunks cover, and at the structured paths' shapes (B =
    1,024, n = 128 and 256, l = u = 1) every row in chunks of 16."""
    for n in (1, 2, 37, 128, 200, 256, 1100, 10_000):
        for itemsize in (8, 4):
            for B, m in ((45, 1), (77, 3), (1024, 1), (1024, 3), (10_000, 1), (10_000, 3)):
                g = tb.banded_geometry(n, B, l, u, itemsize, m)
                assert g.stages == tb.STAGES
                assert 1 <= g.factor_rows <= tb.ROWS_MAX and 1 <= g.solve_rows <= tb.ROWS_MAX
                assert g.factor_smem <= tb.SMEM_BLOCK and g.solve_smem <= tb.SMEM_BLOCK
                assert min(n, g.stages * g.solve_rows) <= g.keep <= n
                if (l, u) == (1, 1) and B == 1024 and n in (128, 256):
                    assert g.keep == n and g.factor_rows == g.solve_rows == tb.ROWS_MAX
    with pytest.raises(ValueError, match="shared memory"):
        tb.banded_geometry(128, 1024, 100, 100, 8)


@pytest.mark.parametrize(
    "call, match",
    [
        (lambda: tb.banded_factor(torch.zeros((2, 5, 3), dtype=torch.float64), 1, 1), "l\\+u\\+1"),
        (lambda: tb.banded_factor(torch.zeros((3, 5, 3), dtype=torch.float64, device="meta"), 1, 1),
         "unsupported device"),
        (lambda: tb.banded_solve((None, None, None), torch.zeros((5, 3), dtype=torch.float64),
                                 1, 1),
         "\\(m, n, B\\)"),
    ],
    ids=["shape", "device", "rhs_shape"],
)
def test_wrappers_refuse(call, match):
    with pytest.raises(ValueError, match=match):
        call()


# ---- the bordered-block-diagonal Schur solve (tests/test_bbd.py) ----------------
def _arrowhead_pattern(n):
    pat = np.zeros((n, n), bool)
    for i in range(n - 1):
        pat[i, i] = True
        if i > 0:
            pat[i, i - 1] = True
        if i < n - 2:
            pat[i, i + 1] = True
    pat[n - 1, :] = True
    pat[:, n - 1] = True
    return pat


def test_bbd_factor_solve_matches_jax():
    """``tests/test_bbd.py::test_bbd_factor_solve_matches_dense`` on both
    packages, lane by lane: the packing, M = I - c J, and the solution."""
    n, B = 24, 3
    rng = np.random.default_rng(0)
    pat = _arrowhead_pattern(n)
    plan, jplan = SparsePlan(pat), JaxPlan(pat)
    assert plan.k_border >= 1
    A = np.where(pat, rng.standard_normal((B, n, n)), 0.0)
    c = np.array([0.37, 0.2, 0.05])
    r = rng.standard_normal((B, n))
    l, u, k = plan.lower, plan.upper, plan.k_border
    Jp = tbbd.dense_to_packed(torch.as_tensor(A.transpose(1, 2, 0).copy()), plan)
    Mp = tbbd.bbd_form_newton(Jp, torch.as_tensor(c), l, u, k)
    z = tbbd.bbd_solve(tbbd.bbd_factor(Mp, l, u, k),
                       torch.as_tensor(r[:, plan.perm].T.copy())[None], l, u, k)[0].numpy()
    for lane in range(B):
        Jj = jbbd.dense_to_packed(jnp.asarray(A[lane]), jplan)
        np.testing.assert_array_equal(Jp[..., lane].numpy(), np.asarray(Jj))
        Mj = jbbd.bbd_form_newton(Jj, c[lane], l, u, k)
        np.testing.assert_array_equal(Mp[..., lane].numpy(), np.asarray(Mj))
        np.testing.assert_array_equal(
            tbbd.packed_to_dense(Mp, l, u, k)[..., lane].numpy(),
            np.asarray(jbbd.packed_to_dense(Mj, l, u, k)))
        zj = jbbd.bbd_solve(jbbd.bbd_factor(Mj, l, u, k), jnp.asarray(r[lane, plan.perm]), l, u, k)
        assert _normwise(z[:, lane], np.asarray(zj)) <= 1e-12
        x = z[:, lane][plan.inv_perm]
        np.testing.assert_allclose(x, np.linalg.solve(np.eye(n) - c[lane] * A[lane], r[lane]),
                                   rtol=1e-10)


def test_bbd_singular_poisons_with_nan():
    n = 12
    plan = SparsePlan(_arrowhead_pattern(n))
    l, u, k = plan.lower, plan.upper, plan.k_border
    # A = I / c makes M = I - c A exactly singular in lane 0; lane 1 is fine
    A = np.stack([np.eye(n) / 0.5, 0.1 * np.eye(n)]).transpose(1, 2, 0)
    Mp = tbbd.bbd_form_newton(tbbd.dense_to_packed(torch.as_tensor(A.copy()), plan),
                              torch.tensor([0.5, 0.5], dtype=torch.float64), l, u, k)
    factors = tbbd.bbd_factor(Mp, l, u, k)
    z = tbbd.bbd_solve(factors, torch.ones((1, n, 2), dtype=torch.float64), l, u, k)
    assert factors.sing.tolist() == [True, False]
    assert torch.isnan(z[..., 0]).all() and torch.isfinite(z[..., 1]).all()


# ---- GMRES (tests/test_linsolvers.py:16-30) --------------------------------------
def test_gmres_exact_small():
    rng = np.random.default_rng(0)
    A = np.eye(4) + 0.3 * rng.standard_normal((4, 4))
    b = rng.standard_normal(4)
    x = gmres_solve(lambda v: torch.as_tensor(A) @ v, torch.as_tensor(b), maxl=4)
    xj = jax_gmres(lambda v: jnp.array(A) @ v, jnp.array(b), maxl=4)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b), rtol=1e-8)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-12)


def test_gmres_zero_rhs():
    x = gmres_solve(lambda v: 2 * v, torch.zeros(3, dtype=torch.float64), maxl=3)
    np.testing.assert_array_equal(x.numpy(), 0.0)


def test_gmres_batched_matches_jax():
    """Lockstep GMRES(3) on four lanes' own operators, one with a zero
    right-hand side, against the reference's lane by lane."""
    rng = np.random.default_rng(1)
    n, B = 6, 4
    A = np.eye(n)[None] + 0.2 * rng.standard_normal((B, n, n))
    b = rng.standard_normal((n, B))
    b[:, 2] = 0.0
    At = torch.as_tensor(A)
    x = gmres_solve_batched(lambda v: torch.einsum("bij,jb->ib", At, v), torch.as_tensor(b), 3)
    xj = jax_gmres_b(lambda v: jnp.einsum("bij,jb->ib", jnp.asarray(A), v), jnp.asarray(b), 3)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(x[:, 2].numpy(), 0.0)
