"""Bordered-block-diagonal (Schur complement) Newton solves, batched.

Port of ``sunode_tpu/ops/bbd.py`` in the trailing-batch layout: for
patterns with a few dense rows and columns (arrowheads, hubs), where any
bandwidth-minimizing ordering degrades to w = O(n), the plan
(:class:`sunode_torch.ops.sparsity.SparsePlan`, ``border='auto'``) orders
those k vertices last, and the permuted Newton matrix is

      M_p = [[Bb, F ],        Bb (n_i, n_i) banded (l, u),  n_i = n - k
             [E,  C ]]        E (k, n_i), F (n_i, k), C (k, k) dense

  factor:  Bb = LU (the banded kernel);  X = Bb^-1 F (one banded solve of
           k right-hand sides);  S = C - E X (k x k) = LU (torch.linalg)
  solve:   u = Bb^-1 r_i;  z_b = S^-1 (r_b - E u);  z_i = u - X z_b.

The interior goes through :mod:`sunode_torch.ops.banded` (its kernels on
CUDA tensors); the k x k Schur complement is small batched dense algebra
(``torch.linalg.lu_factor_ex``/``lu_solve``).

Packed storage (plan-permuted coordinates, border last), ``(w+1+2k, n,
B)`` with w = l + u: rows 0..w the banded interior (``ab[r, j] = Bb[r - u
+ j, j]``, j < n_i), rows w+1..w+k the border rows ``[E | C]``, rows
w+k+1..w+2k the border columns ``F^T`` (columns 0..n_i-1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sunode_torch.ops.banded import (
    _tiny,
    banded_factor,
    banded_solve,
    banded_to_dense,
    dense_to_banded,
)

__all__ = [
    "BBDFactors",
    "bbd_form_newton",
    "bbd_factor",
    "bbd_solve",
    "dense_to_packed",
    "packed_to_dense",
]


class BBDFactors(NamedTuple):
    """The factors of B packed Newton matrices: the interior's banded LU
    (``lu``, ``piv``, trailing batch), ``XT = (Bb^-1 F)^T (k, n_i, B)``,
    ``E (k, n_i, B)``, the Schur complement's LU ``S_LU (B, k, k)`` and
    ``S_piv (B, k)`` (``torch.linalg``'s, batch leading) and ``sing (B,)``."""

    lu: torch.Tensor
    piv: torch.Tensor
    XT: torch.Tensor
    E: torch.Tensor
    S_LU: torch.Tensor
    S_piv: torch.Tensor
    sing: torch.Tensor

    def where(self, mask: torch.Tensor, other: "BBDFactors") -> "BBDFactors":
        """Per lane: these factors where ``mask (B,)``, ``other``'s elsewhere."""
        lead = mask[:, None, None]
        return BBDFactors(
            torch.where(mask, self.lu, other.lu),
            torch.where(mask, self.piv, other.piv),
            torch.where(mask, self.XT, other.XT),
            torch.where(mask, self.E, other.E),
            torch.where(lead, self.S_LU, other.S_LU),
            torch.where(mask[:, None], self.S_piv, other.S_piv),
            torch.where(mask, self.sing, other.sing),
        )


def bbd_form_newton(J_packed: torch.Tensor, c: torch.Tensor, lower: int, upper: int, k: int):
    """``M = I - c J`` in packed storage; ``c (B,)`` a lane."""
    w = lower + upper
    n = J_packed.shape[1]
    n_i = n - k
    M = (-c) * J_packed
    M[upper, :n_i] += 1.0
    if k:
        ar = torch.arange(k, device=M.device)
        M[w + 1 + ar, n_i + ar] += 1.0
    return M


def bbd_factor(M_packed: torch.Tensor, lower: int, upper: int, k: int) -> BBDFactors:
    """Factor packed ``M (w+1+2k, n, B)``.  A singular lane (a pivot of the
    interior or of the Schur complement not above ``_TINY``) sets ``sing``,
    and :func:`bbd_solve` poisons its solution with NaN."""
    w = lower + upper
    n, B = M_packed.shape[1:]
    n_i = n - k
    lu, piv, sing = banded_factor(M_packed[: w + 1, :n_i].contiguous(), lower, upper)
    EC = M_packed[w + 1 : w + 1 + k]  # (k, n, B)
    E = EC[:, :n_i].contiguous()
    C = EC[:, n_i:]  # (k, k, B)
    FT = M_packed[w + 1 + k :, :n_i].contiguous()  # (k, n_i, B)
    XT = banded_solve((lu, piv, None), FT, lower, upper)  # rows of X^T, k solves at once
    S = C - torch.einsum("aib,cib->acb", E, XT)  # (k, k, B)
    S_LU, S_piv, _ = torch.linalg.lu_factor_ex(S.permute(2, 0, 1))
    tiny = _tiny(S.dtype, S.device)
    sing = sing | (torch.diagonal(S_LU, dim1=1, dim2=2).abs() <= tiny).any(dim=1)
    return BBDFactors(lu, piv, XT, E, S_LU, S_piv, sing)


def bbd_solve(factors: BBDFactors, r: torch.Tensor, lower: int, upper: int, k: int):
    """Solve ``M z = r`` for ``r (m, n, B)`` in plan-permuted coordinates;
    NaN in singular lanes."""
    lu, piv, XT, E, S_LU, S_piv, sing = factors
    n = r.shape[1]
    n_i = n - k
    u = banded_solve((lu, piv, None), r[:, :n_i].contiguous(), lower, upper)  # (m, n_i, B)
    rb = r[:, n_i:] - torch.einsum("aib,mib->mab", E, u)  # (m, k, B)
    z_b = torch.linalg.lu_solve(S_LU, S_piv, rb.permute(2, 1, 0)).permute(2, 1, 0)  # (m, k, B)
    z_i = u - torch.einsum("cib,mcb->mib", XT, z_b)
    z = torch.cat([z_i, z_b], dim=1)
    return torch.where(sing[None, None, :], float("nan"), z)


def dense_to_packed(A: torch.Tensor, plan) -> torch.Tensor:
    """Dense ``A (n, n, ...)`` in the original coordinates -> ``plan``'s packed
    storage (its permutation, bandwidths and border)."""
    perm = torch.as_tensor(np.asarray(plan.perm), device=A.device)
    k = plan.k_border
    n = A.shape[0]
    n_i = n - k
    A_p = A[perm][:, perm]
    ab = dense_to_banded(A_p[:n_i, :n_i], plan.lower, plan.upper)
    if k == 0:
        return ab
    tail = A.shape[2:]
    pad = A.new_zeros((plan.lower + plan.upper + 1, k) + tail)
    ft_rows = torch.cat([A_p[:n_i, n_i:].transpose(0, 1), A.new_zeros((k, k) + tail)], dim=1)
    return torch.cat([torch.cat([ab, pad], dim=1), A_p[n_i:, :], ft_rows], dim=0)


def packed_to_dense(M_packed: torch.Tensor, lower: int, upper: int, k: int) -> torch.Tensor:
    """The dense matrix, in plan-permuted coordinates, of packed storage."""
    w = lower + upper
    n = M_packed.shape[1]
    n_i = n - k
    Bb = banded_to_dense(M_packed[: w + 1, :n_i], lower, upper)
    if k == 0:
        return Bb
    top = torch.cat([Bb, M_packed[w + 1 + k :, :n_i].transpose(0, 1)], dim=1)
    return torch.cat([top, M_packed[w + 1 : w + 1 + k]], dim=0)
