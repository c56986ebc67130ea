"""Transition-matrix adjoint gradients for the batched Adams solve.

Port of ``sunode_tpu/adjoint.py::adjoint_backward_transition_batched``.
Conventions (for L = sum_i g_i^T y(t_i)):

  dL/dy0       = lambda(t0)
  dL/dp_subset = quad(t0)
  dL/dt_i      = g_i^T f(t_i, y(t_i))
  dL/dt0       = -lambda(t0)^T f(t0, y0)
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from sunode_torch.ops.adams_batched import adams_solve_batched
from sunode_torch.ops.bdf import BDFOptions
from sunode_torch.ops.linalg import solve_dense
from sunode_torch.symode.cuda_codegen import DeviceSystem

__all__ = [
    "AdjointResult",
    "adjoint_backward_transition_batched",
    "transition_fz",
]


class AdjointResult(NamedTuple):
    lamda: torch.Tensor  # (B, n)  = dL/dy0
    quad: torch.Tensor  # (B, k)  = dL/dp_subset
    status: torch.Tensor  # (B,) 0 on success
    stats: dict


def transition_fz(rhs: Callable, adjoint_jac: Callable, dfdp: Callable, n: int):
    """The backward system in tau = -t, batched over lanes.

    Returns ``(rhs_c, quad_c)``: ``rhs_c(tau, z, p)`` for ``z = [y | vec M]``
    gives ``[-f | vec(J^T M)]`` and ``quad_c`` gives ``vec(M^T df/dp)``, with
    ``z (n + n^2, B)`` and ``p (n_p, B)``; the torch form of
    ``sunode_tpu/adjoint.py:429-450``.  ``rhs``, ``adjoint_jac`` and ``dfdp``
    take batched arguments and put the lane axis last."""

    def split(z):
        return z[:n], z[n:].reshape(n, n, -1)

    def rhs_c(tau, z, p):
        t = -tau
        y, M = split(z)
        matJT = -adjoint_jac(t, y, torch.zeros_like(y), p)  # J^T, (n, n, B)
        # dM/dtau[i, j] = sum_k J^T[i, k] M[k, j]
        dM = torch.sum(matJT[:, :, None, :] * M[None, :, :, :], dim=1)
        dy = -rhs(t, y, p)
        return torch.cat([dy, dM.reshape(n * n, -1)])

    def quad_c(tau, z, p):
        t = -tau
        _, M = split(z)
        Bm = dfdp(t, z[:n], p)  # (n, n_deriv, B)
        # dW/dtau[i, j] = sum_k M[k, i] B[k, j]
        dW = torch.sum(M[:, :, None, :] * Bm[:, None, :, :], dim=0)
        return dW.reshape(-1, dW.shape[-1])

    return rhs_c, quad_c


def adjoint_backward_transition_batched(
    rhs: Callable,  # batched forward f(t (B,), y (n, B), p (n_p, B)) -> (n, B)
    adjoint_jac: Callable,  # batched (t, y, lam, p) -> -J^T, (n, n, B)
    dfdp: Callable,  # batched (t, y, p) -> (n, n_deriv, B)
    t0,
    tvals: torch.Tensor,  # (n_t,) shared, ascending, > t0
    grads: torch.Tensor,  # (B, n_t, n) observation cotangents
    params: torch.Tensor,  # (B, n_p)
    n_deriv: int,
    y_end: torch.Tensor,  # (B, n) = y(tvals[-1]) from the forward emissions
    options: BDFOptions = BDFOptions(rtol=1e-10, atol=1e-10),
    device_system: Optional[DeviceSystem] = None,
) -> AdjointResult:
    """Fundamental-matrix ("transition") adjoint: ONE smooth backward solve
    of ``dM/dtau = J^T M`` with y alongside and the quadrature
    ``W = int M^T df/dp``; the cotangents then compose algebraically:

        x_k      = M(tau_k)^{-1} g_k
        lambda   = M(tau1) sum_k x_k                      (= dL/dy0)
        dL/dp    = sum_k x_k^T (W(tau1) - W(tau_k))

    ``device_system`` is :func:`~sunode_torch.symode.cuda_codegen.transition_system`
    of the problem; a solve on CUDA tensors requires it."""
    dtype = grads.dtype
    device = grads.device
    B, n_t, n = grads.shape
    tvals = torch.as_tensor(tvals, dtype=dtype, device=device)
    t0 = torch.as_tensor(t0, dtype=dtype, device=device)

    n_state = n + n * n
    m_quad = n * n_deriv
    rhs_c, quad_c = transition_fz(rhs, adjoint_jac, dfdp, n)
    quad_opts = options._replace(quad_err_con=True, save_steps=0)

    eyeM = torch.eye(n, dtype=dtype, device=device).reshape(1, n * n).expand(B, n * n)
    z0 = torch.cat([torch.as_tensor(y_end, dtype=dtype, device=device), eyeM], dim=1)
    q0 = torch.zeros((B, m_quad), dtype=dtype, device=device)

    # emission times: every observation except the last (M=I, W=0 there),
    # plus the backward terminal -t0
    tv_solver = torch.cat([torch.flip(-tvals[:-1], dims=[0]), (-t0)[None]])

    res = adams_solve_batched(
        rhs_c,
        -tvals[-1],
        z0,
        params,
        tv_solver,
        quad_opts,
        quad_rhs=quad_c,
        quad0=q0,
        batched_fns=True,
        device_system=device_system,
    )
    ok = res.status == 0
    W_e = res.quad.reshape(B, n_t, n, n_deriv)
    M_e = res.ys[:, :, n:].reshape(B, n_t, n, n)
    M_end = M_e[:, -1]  # (B, n, n) at tau1 = -t0
    W_end = W_e[:, -1]

    # x_k = M(tau_k)^{-1} g_k; solver emission j is observation n_t-2-j
    g_rev = torch.flip(grads[:, :-1, :], dims=[1])  # (B, n_t-1, n)
    M_obs = M_e[:, : n_t - 1]
    W_obs = W_e[:, : n_t - 1]
    x = solve_dense(M_obs, g_rev)  # (B, n_t-1, n)
    x_last = grads[:, -1, :]  # M = I at the start
    x_sum = torch.sum(x, dim=1) + x_last

    # Conditioning monitor: relative residual and growth factor, flagged as
    # status 97 (NaN poison downstream) past dtype-aware gates; the division
    # floor is the dtype's own tiny so an all-zero cotangent row cannot turn
    # into 0/0.
    if torch.finfo(dtype).eps < 1e-10:
        resid_gate, growth_gate = 1e-6, 1e10
    else:
        resid_gate, growth_gate = 1e-3, 3e4
    div_floor = torch.finfo(dtype).tiny
    if n_t > 1:
        resid = torch.einsum("bkij,bkj->bki", M_obs, x) - g_rev
        g_mag = torch.amax(torch.abs(g_rev), dim=2)
        rel_resid = torch.amax(
            torch.amax(torch.abs(resid), dim=2) / (g_mag + div_floor), dim=1
        )
        growth = torch.amax(
            torch.amax(torch.abs(M_obs), dim=(2, 3))
            * torch.amax(torch.abs(x), dim=2)
            / (g_mag + div_floor),
            dim=1,
        )
    else:
        rel_resid = torch.zeros((B,), dtype=dtype, device=device)
        growth = torch.ones((B,), dtype=dtype, device=device)
    growth = torch.maximum(
        growth,
        torch.amax(torch.abs(M_end), dim=(1, 2))
        * torch.amax(torch.abs(x_sum), dim=1)
        / (torch.amax(torch.abs(grads), dim=(1, 2)) + div_floor),
    )
    ill = (rel_resid > resid_gate) | (growth > growth_gate)

    lam = torch.einsum("bij,bj->bi", M_end, x_sum)
    dW = W_end[:, None] - W_obs  # (B, n_t-1, n, n_deriv)
    q = torch.einsum("bki,bkij->bj", x, dW) + torch.einsum("bi,bij->bj", x_last, W_end)

    ok = ok & ~ill
    status = torch.where(ill & (res.status == 0), 97, res.status).to(torch.int32)
    lam = torch.where(ok[:, None], lam, float("nan"))
    q = torch.where(ok[:, None], q, float("nan"))
    return AdjointResult(
        lamda=lam,
        quad=q,
        status=status,
        stats=dict(
            n_backward_steps=res.stats["n_steps"],
            n_attempts=res.stats["n_attempts"],
            transition_rel_residual=rel_resid,
            transition_growth=growth,
        ),
    )
