"""The main-path workload: batched Lotka-Volterra adjoint gradients.

Port of ``__graft_entry__._build`` (method ADAMS): a Lotka-Volterra
``SympyProblem`` (2 states, 4 params, derivatives w.r.t. alpha and beta),
the batched Adams forward solve and transition-adjoint gradients of
``sum(ys**2)``, with the same options as the reference workload:

  * forward: rtol = atol = ``rtol``, ``adams_max_order=6``;
  * backward: the seminorm layout, rtol ``10*rtol`` on the y rows and 1e-3
    on the M rows, quadrature rtol/atol 1e-3, ``adams_max_order=6``.
"""

from __future__ import annotations

import numpy as np
import torch

from sunode_torch.convert import device_or_raise
from sunode_torch.ops.bdf import BDFOptions
from sunode_torch.symode.problem import SympyProblem
from sunode_torch.wrappers.as_torch import make_batched_solve_fn

__all__ = ["lv_problem", "lv_options", "build_lv_adjoint", "LV_P_FIX"]

LV_P_FIX = (1.0, 0.4)  # gamma, delta


def _lv(t, y, p):
    return {
        "hares": p.alpha * y.hares - p.beta * y.lynx * y.hares,
        "lynx": p.delta * y.hares * y.lynx - p.gamma * y.lynx,
    }


def lv_problem() -> SympyProblem:
    return SympyProblem(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()},
        rhs_sympy=_lv,
        derivative_params=[("alpha",), ("beta",)],
    )


def lv_options(rtol: float) -> tuple[BDFOptions, BDFOptions]:
    """(forward, backward) options of the main-path workload."""
    bwd_rtol = max(rtol * 10.0, 1e-12)
    n_state = 2
    adj_rtol = np.concatenate(
        [np.full(n_state, bwd_rtol), np.full(n_state * n_state, 1e-3)]
    )
    adj_opts = BDFOptions(
        rtol=adj_rtol, atol=bwd_rtol, adams_max_order=6,
        quad_rtol=1e-3, quad_atol=1e-3,
    )
    fwd_opts = BDFOptions(rtol=rtol, atol=rtol, adams_max_order=6)
    return fwd_opts, adj_opts


def build_lv_adjoint(batch: int, tvals_n: int, rtol: float, device="cuda"):
    """``(grad_step, (y0s, p_subs))``: ``grad_step(y0s, p_subs) -> (gy, gp)``
    is one batched gradient of ``sum(ys**2)`` (what NUTS runs per leapfrog,
    across all chains at once); ``grad_step.solve`` is the solver, whose
    ``last_stats`` report the attempts of the latest step.  It runs on the
    card unless ``device="cpu"``; without a card the default raises."""
    device = device_or_raise(device)
    fwd_opts, adj_opts = lv_options(rtol)
    solve = make_batched_solve_fn(
        lv_problem(),
        derivatives="adjoint",
        options=fwd_opts,
        adjoint_options=adj_opts,
        method="ADAMS",
        adjoint_interpolation="transition",
    )
    f64 = dict(dtype=torch.float64, device=device)
    tvals = torch.as_tensor(np.linspace(1.0, 10.0, tvals_n), **f64)
    p_fix = torch.as_tensor(LV_P_FIX, **f64)

    def grad_step(y0s, p_subs):
        y0s = y0s.detach().requires_grad_(True)
        p_subs = p_subs.detach().requires_grad_(True)
        ys = solve(0.0, y0s, p_subs, p_fix, tvals)
        return torch.autograd.grad(torch.sum(ys**2), (y0s, p_subs))

    grad_step.solve = solve
    grad_step.tvals = tvals
    grad_step.p_fix = p_fix

    rng = np.random.default_rng(0)
    y0s = np.array([10.0, 2.0]) * (1 + 0.1 * rng.standard_normal((batch, 2)))
    p_subs = np.array([1.0, 0.3]) * (1 + 0.1 * rng.standard_normal((batch, 2)))
    return grad_step, (torch.as_tensor(y0s, **f64), torch.as_tensor(p_subs, **f64))
