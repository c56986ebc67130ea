"""Small dense linear algebra (port of ``sunode_tpu/ops/linalg.py``).

The reference hand-writes f64 LU and closed-form tiny solves because f64 LU
does not compile on the TPU; here float64 ``torch.linalg`` covers it.  The
contract is the reference's: a lane whose matrix or right-hand side is not
finite, or whose matrix is singular, comes back non-finite instead of
raising, and never spoils another lane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["solve_dense", "NewtonFactors", "factor_newton_b", "solve_factored_b"]


def solve_dense(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` over any leading batch: A (..., n, n), b (..., n).

    Lanes whose A or b holds a non-finite entry get NaN (the reference's
    closed forms propagate NaN the same way) and never reach the LU, and
    singular lanes come back non-finite instead of raising, so one bad lane
    cannot fail the batch."""
    n = A.shape[-1]
    finite = torch.isfinite(A).flatten(-2).all(-1) & torch.isfinite(b).all(-1)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    A_safe = torch.where(finite[..., None, None], A, eye)
    b_safe = torch.where(finite[..., None], b, 0.0)
    x, _ = torch.linalg.solve_ex(A_safe, b_safe[..., None])
    return torch.where(finite[..., None], x[..., 0], float("nan"))


class NewtonFactors(NamedTuple):
    """LU factors of B Newton matrices, batch axis leading: ``lu (B, n, n)``
    and ``pivots (B, n)`` from ``torch.linalg.lu_factor_ex``, and ``ok (B,)``,
    false where the matrix was not finite or is exactly singular."""

    lu: torch.Tensor
    pivots: torch.Tensor
    ok: torch.Tensor

    def where(self, mask: torch.Tensor, other: "NewtonFactors") -> "NewtonFactors":
        """Per lane: these factors where ``mask (B,)``, ``other``'s elsewhere."""
        return NewtonFactors(*(
            torch.where(mask.view((-1,) + (1,) * (a.ndim - 1)), a, b)
            for a, b in zip(self, other)
        ))


def factor_newton_b(M: torch.Tensor) -> NewtonFactors:
    """Factor the Newton matrices ``M (n, n, B)`` (trailing batch, as
    ``sunode_tpu.ops.linalg.factor_newton_b`` takes them) once per (J, c)."""
    n = M.shape[0]
    Mb = M.permute(2, 0, 1)
    finite = torch.isfinite(Mb).flatten(1).all(1)
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    lu, pivots, info = torch.linalg.lu_factor_ex(torch.where(finite[:, None, None], Mb, eye))
    return NewtonFactors(lu, pivots, finite & (info == 0))


def solve_factored_b(factors: NewtonFactors, b: torch.Tensor) -> torch.Tensor:
    """Solve with :func:`factor_newton_b`'s factors: ``b (..., n, B)`` holds
    any number of right-hand sides per lane (the state's ``(n, B)``, the
    sensitivities' ``(k, n, B)``), all solved in one call.  A right-hand side
    that is not finite, or a lane whose factors are not ``ok``, gives NaN."""
    lead, (n, B) = b.shape[:-2], b.shape[-2:]
    rhs = b.reshape(-1, n, B).permute(2, 1, 0)  # (B, n, cols)
    b_ok = torch.isfinite(rhs).all(1, keepdim=True)  # (B, 1, cols)
    x = torch.linalg.lu_solve(factors.lu, factors.pivots, torch.where(b_ok, rhs, 0.0))
    x = torch.where(b_ok & factors.ok[:, None, None], x, float("nan"))
    return x.permute(2, 1, 0).reshape(lead + (n, B))
