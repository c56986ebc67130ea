"""Small dense linear algebra (port of ``sunode_tpu/ops/linalg.py::solve_dense``).

The reference hand-writes f64 LU and closed-form tiny solves because f64 LU
does not compile on the TPU; here float64 ``torch.linalg`` covers it.
"""

from __future__ import annotations

import torch

__all__ = ["solve_dense"]


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
