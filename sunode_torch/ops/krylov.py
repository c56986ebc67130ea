"""Matrix-free GMRES for the Newton systems (the SPGMR analog), batched.

Port of ``sunode_tpu/ops/krylov.py``: ``(I - c J) x = b`` from Jacobian-
vector products alone, restart-free GMRES(maxl) from x0 = 0 with CVODES's
default Krylov depth, maxl = 5.  The Arnoldi process (modified
Gram-Schmidt), the Givens rotations and the back substitution are a static
unroll over the Krylov dimension in torch, their scalars ``(B,)`` tensors,
so B lanes solve in lockstep; a zero residual or a lucky breakdown gives
the exact solution so far.  There is nothing to factor and no kernel.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["gmres_solve", "gmres_solve_batched", "DEFAULT_MAXL"]

DEFAULT_MAXL = 5


def gmres_solve_batched(matvec: Callable, b: torch.Tensor, maxl: int = DEFAULT_MAXL):
    """Solve ``A_l x_l = b_l`` for B lanes in lockstep: ``b (n, B)``,
    ``matvec`` maps ``(n, B) -> (n, B)`` applying each lane's operator to
    its own column; inner products are sums over the rows."""
    n, B = b.shape
    m = min(maxl, n)
    zero = b.new_zeros((B,))

    def dot(u, v):
        return torch.sum(u * v, dim=0)

    def safe(x):
        return torch.where(x == 0, 1.0, x)

    beta = torch.sqrt(dot(b, b))
    V = [b / safe(beta)[None, :]]
    H = [[zero] * m for _ in range(m + 1)]
    for j in range(m):
        w = matvec(V[j])
        for i in range(j + 1):
            hij = dot(w, V[i])
            H[i][j] = hij
            w = w - hij[None, :] * V[i]
        hnext = torch.sqrt(dot(w, w))
        H[j + 1][j] = hnext
        V.append(w / safe(hnext)[None, :])

    g = [beta] + [zero] * m
    R = [row[:] for row in H]
    rots = []
    for j in range(m):
        for i in range(j):
            c_i, s_i = rots[i]
            tmp = c_i * R[i][j] + s_i * R[i + 1][j]
            R[i + 1][j] = -s_i * R[i][j] + c_i * R[i + 1][j]
            R[i][j] = tmp
        a, bb = R[j][j], R[j + 1][j]
        r = torch.sqrt(a * a + bb * bb)
        c_j = torch.where(r == 0, 1.0, a / safe(r))
        s_j = torch.where(r == 0, 0.0, bb / safe(r))
        rots.append((c_j, s_j))
        R[j][j] = c_j * a + s_j * bb
        R[j + 1][j] = zero
        tmp = c_j * g[j] + s_j * g[j + 1]
        g[j + 1] = -s_j * g[j] + c_j * g[j + 1]
        g[j] = tmp

    y = [zero] * m
    for i in range(m - 1, -1, -1):
        acc = g[i]
        for j in range(i + 1, m):
            acc = acc - R[i][j] * y[j]
        y[i] = torch.where(R[i][i] == 0, 0.0, acc / safe(R[i][i]))

    x = torch.zeros_like(b)
    for j in range(m):
        x = x + y[j][None, :] * V[j]
    return x


def gmres_solve(matvec: Callable, b: torch.Tensor, maxl: int = DEFAULT_MAXL):
    """One system: ``b (n,)``, ``matvec (n,) -> (n,)``; the batched solve
    with one lane."""
    return gmres_solve_batched(lambda v: matvec(v[:, 0])[:, None], b[:, None], maxl)[:, 0]
