"""The Newton matrix's linear solvers of the batched BDF core.

``BDFOptions.linear_solver`` picks one (``sunode_tpu/ops/bdf_batched.py``
:203-317, :519-542, :643-690):

  * ``'dense'`` -- J ``(n, n, B)``, ``M = I - c J`` factored by
    ``torch.linalg`` (:mod:`sunode_torch.ops.linalg`);
  * ``'band'`` -- J in banded storage ``(l+u+1, n, B)``, M formed there and
    factored by the batched banded LU (:mod:`sunode_torch.ops.banded`, its
    kernels on CUDA tensors);
  * ``'sparse'`` -- J in a :class:`~sunode_torch.ops.sparsity.SparsePlan`'s
    packed storage in the permuted coordinates: the residual is permuted
    by ``sparse_perm`` around the banded solve and the solution permuted
    back; with ``sparse_border = k > 0`` the solve is the bordered-block-
    diagonal Schur complement of :mod:`sunode_torch.ops.bbd`;
  * ``'spgmr'`` -- no matrix: GMRES on Jacobian-vector products, linearised
    at each attempt's predictor (:mod:`sunode_torch.ops.krylov`).

Each solver counts its host-side calls (``n_factors``, the initial identity's
included, and ``n_solves``), which
the core reports in its stats: on the card every banded factorization and
solve is a kernel launch, so a run can hold the launch counts against them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from sunode_torch.ops.banded import banded_factor, banded_solve
from sunode_torch.ops.bbd import bbd_factor, bbd_form_newton, bbd_solve
from sunode_torch.ops.krylov import gmres_solve_batched
from sunode_torch.ops.linalg import factor_newton_b, solve_factored_b

__all__ = ["BandFactors", "newton_linear_solver"]


class BandFactors(NamedTuple):
    """:func:`~sunode_torch.ops.banded.banded_factor`'s outputs, every one
    with the lane axis last."""

    lu: torch.Tensor
    piv: torch.Tensor
    sing: torch.Tensor

    def where(self, mask: torch.Tensor, other: "BandFactors") -> "BandFactors":
        """Per lane: these factors where ``mask (B,)``, ``other``'s elsewhere."""
        return BandFactors(*(torch.where(mask, a, b) for a, b in zip(self, other)))


class _Dense:
    def __init__(self, n: int):
        self.n = n
        # for n <= 4 the core factors and refreshes J every attempt: cheaper
        # than a host sync
        self.always = n <= 4
        self.n_factors = self.n_solves = 0

    def jac_shape(self):
        return (self.n, self.n)

    def factor(self, J, c_coef):
        self.n_factors += 1
        eye = torch.eye(self.n, dtype=J.dtype, device=J.device)[:, :, None]
        return factor_newton_b(eye - c_coef[None, None, :] * J)

    def identity(self, J0):
        self.n_factors += 1
        eye = torch.eye(self.n, dtype=J0.dtype, device=J0.device)[:, :, None]
        return factor_newton_b(eye.expand(J0.shape))

    def solve(self, factors, res):
        self.n_solves += 1
        return solve_factored_b(factors, res)

    def lip_norm(self, J):
        """``||J||_inf`` a lane (row sums), the quintic recording's L row."""
        return torch.abs(J).sum(dim=1).amax(dim=0)


class _Band:
    """Banded storage, optionally in a permuted ('sparse') order."""

    always = False

    def __init__(self, n, lower, upper, perm=None):
        self.n, self.lower, self.upper = n, lower, upper
        self.perm = None if perm is None else np.asarray(perm, np.int64)
        self._perm_t: dict = {}
        self.n_factors = self.n_solves = 0

    def jac_shape(self):
        return (self.lower + self.upper + 1, self.n)

    def _perms(self, device):
        if device not in self._perm_t:
            self._perm_t[device] = (
                torch.as_tensor(self.perm, device=device),
                torch.as_tensor(np.argsort(self.perm), device=device),
            )
        return self._perm_t[device]

    def form(self, J, c_coef):
        # M = I - c J directly in banded storage: the diagonal is row u
        M = (-c_coef)[None, None, :] * J
        M[self.upper] += 1.0
        return M

    def factor_matrix(self, M):
        return BandFactors(*banded_factor(M, self.lower, self.upper))

    def factor(self, J, c_coef):
        self.n_factors += 1
        return self.factor_matrix(self.form(J, c_coef))

    def identity(self, J0):
        B = J0.shape[-1]
        self.n_factors += 1
        return self.factor_matrix(self.form(torch.zeros_like(J0), J0.new_zeros((B,))))

    def solve_permuted(self, factors, rhs):
        return banded_solve(tuple(factors), rhs, self.lower, self.upper)

    def solve(self, factors, res):
        """``res (n, B)`` or ``(m, n, B)``: one call, every right-hand side."""
        self.n_solves += 1
        rhs = res[None] if res.ndim == 2 else res
        if self.perm is not None:
            perm, inv = self._perms(res.device)
            rhs = rhs.index_select(1, perm)
        z = self.solve_permuted(factors, rhs.contiguous())
        if self.perm is not None:
            z = z.index_select(1, inv)
        return z[0] if res.ndim == 2 else z

    def lip_norm(self, J):
        """``||J||_1`` a lane (column sums over the stored rows, an equally
        valid scale; over the BBD packing's border rows too, which counts
        some entries twice -- the reference's estimate, kept)."""
        return torch.abs(J).sum(dim=0).amax(dim=0)


class _BBD(_Band):
    """'sparse' with a border of ``k`` vertices: packed storage."""

    def __init__(self, n, lower, upper, perm, k):
        super().__init__(n, lower, upper, perm)
        self.k = k

    def jac_shape(self):
        return (self.lower + self.upper + 1 + 2 * self.k, self.n)

    def form(self, J, c_coef):
        return bbd_form_newton(J, c_coef, self.lower, self.upper, self.k)

    def factor_matrix(self, M):
        return bbd_factor(M, self.lower, self.upper, self.k)

    def solve_permuted(self, factors, rhs):
        return bbd_solve(factors, rhs, self.lower, self.upper, self.k)


class _Spgmr:
    """Matrix-free: nothing to factor; each attempt's solve is GMRES on the
    operator ``v -> v - c J(t_new, y_pred) v``."""

    always = False

    def __init__(self, n, maxl, jac_prod_b: Callable):
        self.n, self.maxl, self.jac_prod_b = n, maxl, jac_prod_b
        self.n_factors = self.n_solves = 0

    def jac_shape(self):
        return (1, 1)

    def linearized(self, t_new, y_pred, c_coef, params) -> Callable:
        def solve(res):
            self.n_solves += 1

            def one(r):
                return gmres_solve_batched(
                    lambda v: v - c_coef[None, :] * self.jac_prod_b(t_new, y_pred, v, params),
                    r, maxl=self.maxl,
                )

            if res.ndim == 2:
                return one(res)
            return torch.stack([one(r) for r in res])

        return solve

    def lip_norm(self, J):
        """+inf: no J, so the quintic evaluator falls back to its cubic."""
        return torch.full(J.shape[-1:], float("inf"), dtype=J.dtype, device=J.device)


def newton_linear_solver(options, n: int, jac_prod_b: Callable = None):
    """The solver ``options.linear_solver`` names, for n states; raises
    ``NotImplementedError`` for another name, as the reference does."""
    kind = options.linear_solver
    if kind == "dense":
        return _Dense(n)
    if kind == "spgmr":
        return _Spgmr(n, int(options.krylov_dim), jac_prod_b)
    if kind in ("band", "sparse"):
        lower, upper = int(options.band_lower), int(options.band_upper)
        perm = options.sparse_perm if kind == "sparse" else None
        k = int(options.sparse_border) if kind == "sparse" else 0
        if k:
            return _BBD(n, lower, upper, perm, k)
        return _Band(n, lower, upper, perm)
    raise NotImplementedError(
        "bdf_solve_batched supports linear_solver 'dense', 'band', 'sparse' or 'spgmr'"
    )
