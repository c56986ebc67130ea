"""Adjoint gradients of the single-instance and the batched solves.

Port of ``sunode_tpu/adjoint.py``.  Its single half: the Hermite and the
polynomial evaluators over one recorded trajectory
(:func:`make_hermite_eval`, :func:`make_polynomial_eval`) and
:func:`adjoint_backward`, one time-reversed
:func:`~sunode_torch.ops.bdf.bdf_solve` an observation interval.  Its
batched half: the transition-matrix
adjoint of the Adams solve (``adjoint_backward_transition_batched``), and
``adjoint_backward_batched``: with ``method='BDF'`` one backward BDF solve
per observation interval, with ``method='ADAMS'`` one fused backward Adams
solve over the whole span with the cotangents injected at their times, over
a Hermite or polynomial reconstruction of the forward trajectory recorded
by the forward solve (``save_steps > 0``), or, with
``interpolation='resolve'``, over y(t) integrated backward beside lambda.
Conventions (for L = sum_i g_i^T y(t_i)):

  dL/dy0       = lambda(t0)
  dL/dp_subset = quad(t0)
  dL/dt_i      = g_i^T f(t_i, y(t_i))
  dL/dt0       = -lambda(t0)^T f(t0, y0)
"""

from __future__ import annotations

import bisect
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from sunode_torch.ops.adams_batched import adams_solve_batched
from sunode_torch.ops.bdf import BDFOptions, _np_dtype, _upload, bdf_solve, host_time, host_value
from sunode_torch.ops.bdf_batched import bdf_solve_batched
from sunode_torch.ops.linalg import solve_dense
from sunode_torch.parallel.rows import RowBlocks, RowLayout
from sunode_torch.symode.cuda_codegen import DeviceSystem

__all__ = [
    "AdjointResult",
    "adjoint_backward_transition_batched",
    "transition_fz",
    "resolve_fz",
    "staged_adjoint_fz",
    "POLY_K",
    "make_hermite_eval",
    "make_polynomial_eval",
    "adjoint_backward",
    "make_hermite_eval_batched",
    "make_polynomial_eval_batched",
    "adjoint_backward_batched",
]

POLY_K = 6  # polynomial interpolation window (degree POLY_K - 1)


class AdjointResult(NamedTuple):
    lamda: torch.Tensor  # (B, n) = dL/dy0; (n,) from adjoint_backward
    quad: torch.Tensor  # (B, k) = dL/dp_subset; (k,) from adjoint_backward
    status: torch.Tensor  # (B,) 0 on success; an int from adjoint_backward
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


# ---------------------------------------------------------------------------
# The checkpointed adjoint: evaluators over the recorded trajectory
# ---------------------------------------------------------------------------
def _quintic_basis(tau):
    """Two-point quintic Hermite basis at tau in [0, 1]: weights for
    (y0, h f0, h^2 fd0, y1, h f1, h^2 fd1)."""
    t2 = tau * tau
    t3 = t2 * tau
    t4 = t3 * tau
    t5 = t4 * tau
    H0 = 1 - 10 * t3 + 15 * t4 - 6 * t5
    H1 = tau - 6 * t3 + 8 * t4 - 3 * t5
    H2 = 0.5 * t2 - 1.5 * t3 + 1.5 * t4 - 0.5 * t5
    H3 = 10 * t3 - 15 * t4 + 6 * t5
    H4 = -4 * t3 + 7 * t4 - 3 * t5
    H5 = 0.5 * t3 - t4 + 0.5 * t5
    return H0, H1, H2, H3, H4, H5


def _searchsorted_b(ts_rows: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rightmost ``i`` with ``ts[i] <= t`` per lane (-1 where none, and at a
    NaN ``t``), ``ts`` ascending with ``+inf`` pads.  ``ts_rows`` is the
    table as a contiguous ``(B, S)`` copy, made once per backward: one binary
    search per lane instead of the reference's compare-and-sum over the
    whole ``(S, B)`` table (``sunode_tpu/adjoint.py::_searchsorted_b``)."""
    idx = torch.searchsorted(ts_rows, t[:, None], right=True)[:, 0] - 1
    return torch.where(torch.isnan(t), -1, idx)


def _rows(table: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i[b]`` of lane b: ``table (S, ..., B)`` -> ``(..., B)``."""
    return table.gather(0, i.view((1,) + (1,) * (table.ndim - 2) + (-1,)).expand(
        (1,) + tuple(table.shape[1:]))
    )[0]


def _left_row(ts_rows, n_saved, t):
    """The bracketing interval's left row per lane, clipped to
    ``[0, n_saved - 2]`` as the reference clips it (-1 for a lane with one
    recorded row)."""
    return torch.minimum(torch.clamp(_searchsorted_b(ts_rows, t), min=0), n_saved - 2)


def _bracket(ts, ts_rows, n_saved, t):
    """The bracketing interval's two rows per lane, as the reference reads
    them: a lane with one row reads its last slot and its first, as a
    negative index does there, and a row past the table (an overflowed
    legacy recording) reads the last slot, as an out-of-range gather does
    there."""
    S = ts.shape[0]
    i = _left_row(ts_rows, n_saved, t)
    return torch.remainder(i, S), torch.clamp(i + 1, max=S - 1)


def _single_bracket(ts: torch.Tensor, n_saved: int, t: torch.Tensor):
    """The bracketing interval's rows ``(i0, i1)`` of ``t (m,)`` in one
    recording: the rightmost row at or before t, clipped to ``[0, n_saved -
    2]`` as the reference clips it, a negative row read from the end and a
    row past the table from its last slot, as the reference's indexing
    reads them."""
    S = ts.shape[0]
    idx = torch.searchsorted(ts, t, right=True) - 1
    idx = torch.where(torch.isnan(t), -1, idx)
    i = torch.minimum(torch.clamp(idx, min=0), torch.full_like(idx, int(n_saved) - 2))
    return torch.remainder(i, S), torch.clamp(i + 1, max=S - 1)


def _host_rows(table: torch.Tensor, rows: list, weights) -> torch.Tensor:
    """``sum_k weights[k] table[rows[k]]`` for host weights: one product, the
    rows a view of the table where they are consecutive."""
    w = _upload(np.asarray(weights, _np_dtype(table.dtype)), table.device)
    if rows == list(range(rows[0], rows[0] + len(rows))):
        picked = table[rows[0] : rows[0] + len(rows)]
    else:
        picked = table[torch.as_tensor(rows, device=table.device)]
    return w @ picked.reshape(len(weights), -1)


def make_hermite_eval(saved: dict) -> Callable:
    """Hermite evaluator over one recorded forward trajectory:
    ``y_at(t) -> (n,)`` for a scalar ``t`` (``(m, n)`` for a tensor ``t
    (m,)``).  ``saved`` is :func:`~sunode_torch.ops.bdf.bdf_solve`'s
    recording: ``t (S,)`` padded with +inf, ``y``, ``f (S, n)``,
    ``n_saved``, and ``fd (S, n)`` where the rows are quintic (then quintic
    Hermite, gated to ``h L <= 1`` where the rows carry ``L``, cubic
    beyond); without ``fd`` CVODES's cubic CV_HERMITE.  A time held on the
    host (a number, or a time the single cores pass) finds its interval and
    weights on the host and costs one product on the device; a tensor of
    times is evaluated on the device.  Port of ``sunode_tpu/adjoint.py::
    make_hermite_eval``."""
    ts, ys, fs = saved["t"].contiguous(), saved["y"], saved["f"]
    n_saved = int(saved["n_saved"])
    fds, Ls = saved.get("fd"), saved.get("L")
    S, n = ys.shape
    host = {}

    def host_eval(t):
        if not host:  # the table's times on the host, read once
            host["ts"] = ts.tolist()
            host["L"] = None if Ls is None else Ls.tolist()
            host["yf"] = torch.cat([ys, fs] + ([fds] if fds is not None else []), dim=1)
        sc = _np_dtype(ys.dtype)
        idx = -1 if t != t else bisect.bisect_right(host["ts"], t) - 1
        i = min(max(idx, 0), n_saved - 2)
        i0, i1 = i % S, min(i + 1, S - 1)
        with np.errstate(all="ignore"):
            t0, t1 = sc(host["ts"][i0]), sc(host["ts"][i1])
            h = t1 - t0
            tau = np.clip((sc(t) - t0) / h, sc(0.0), sc(1.0))
            cubic = [(1 + 2 * tau) * (1 - tau) ** 2, tau * (1 - tau) ** 2 * h,
                     tau**2 * (3 - 2 * tau), tau**2 * (tau - 1) * h]
            if fds is None:
                return _host_rows(host["yf"], [i0, i1], cubic[:2] + cubic[2:])
            quintic = True
            if host["L"] is not None:
                quintic = bool(h * np.maximum(sc(host["L"][i0]), sc(host["L"][i1])) <= 1.0)
            if quintic:
                H0, H1, H2, H3, H4, H5 = _quintic_basis(tau)
                w = [H0, H1 * h, H2 * (h * h), H3, H4 * h, H5 * (h * h)]
            else:
                w = cubic[:2] + [sc(0)] + cubic[2:] + [sc(0)]
        return _host_rows(host["yf"], [i0, i1], w)

    def y_at(t):
        th = host_value(t)
        if th is not None:
            return host_eval(th)
        t = torch.as_tensor(t, dtype=ts.dtype, device=ts.device)
        scalar = t.ndim == 0
        t = t.reshape(-1)
        i0, i1 = _single_bracket(ts, n_saved, t)
        t0, t1 = ts[i0], ts[i1]
        h = t1 - t0
        tau = torch.clamp((t - t0) / h, 0.0, 1.0)[:, None]
        hc = h[:, None]
        y0, y1, f0, f1 = ys[i0], ys[i1], fs[i0], fs[i1]
        h00 = (1 + 2 * tau) * (1 - tau) ** 2
        h10 = tau * (1 - tau) ** 2
        h01 = tau**2 * (3 - 2 * tau)
        h11 = tau**2 * (tau - 1)
        out = h00 * y0 + h10 * hc * f0 + h01 * y1 + h11 * hc * f1
        if fds is not None:
            H0, H1, H2, H3, H4, H5 = _quintic_basis(tau)
            h2 = hc * hc
            quintic = (H0 * y0 + H1 * hc * f0 + H2 * h2 * fds[i0] + H3 * y1 + H4 * hc * f1
                       + H5 * h2 * fds[i1])
            if Ls is None:
                out = quintic
            else:
                ok = (h * torch.maximum(Ls[i0], Ls[i1]) <= 1.0)[:, None]
                out = torch.where(ok, quintic, out)
        return out[0] if scalar else out

    return y_at


def make_polynomial_eval(saved: dict) -> Callable:
    """The CV_POLYNOMIAL analog over one recorded trajectory: barycentric
    Lagrange through the ``POLY_K`` recorded y rows around the bracketing
    interval (window clamped at the ends, degree lower with fewer rows), the
    nearest node itself within 1e-14 relative.  ``y_at(t) -> (n,)`` (``(m,
    n)`` for a tensor ``t (m,)``); a time held on the host is evaluated with
    host weights, as in :func:`make_hermite_eval`.  Port of
    ``sunode_tpu/adjoint.py::make_polynomial_eval``."""
    ts, ys = saved["t"].contiguous(), saved["y"]
    n_saved = int(saved["n_saved"])
    S = ts.shape[0]
    K = min(POLY_K, S)
    off = torch.arange(K, device=ts.device)
    offd = off[:, None] != off[None, :]
    host = {}

    def host_eval(t):
        if not host:
            host["ts"] = ts.tolist()
        sc = _np_dtype(ys.dtype)
        idx = -1 if t != t else bisect.bisect_right(host["ts"], t) - 1
        i = min(max(idx, 0), n_saved - 2)
        s0 = min(max(i - (K // 2 - 1), 0), max(n_saved - K, 0))
        jdx = [min(max(s0 + o, 0), S - 1) for o in range(K)]
        valid = [s0 + o < n_saved for o in range(K)]
        tj = [sc(host["ts"][j]) for j in jdx]
        t = sc(t)
        with np.errstate(all="ignore"):
            absd = [abs(t - v) for v in tj]
            exact = [valid[k] and absd[k] <= 1e-14 * (1.0 + abs(t)) for k in range(K)]
            if any(exact):
                # the nearest exact node only: two rows may lie within the tolerance
                near = min((k for k in range(K) if valid[k]), key=lambda k: absd[k])
                return ys[jdx[near]]
            w = []
            for k in range(K):
                prod = sc(1.0)
                for m in range(K):
                    if m != k and valid[m]:
                        prod = prod * (tj[k] - tj[m])
                w.append(sc(1.0) / prod / (t - tj[k]) if valid[k] else sc(0.0))
            den = sc(0.0)
            for v in w:
                den = den + v
            w = [v / den for v in w]
        return _host_rows(ys, jdx, w)

    def y_at(t):
        th = host_value(t)
        if th is not None:
            return host_eval(th)
        t = torch.as_tensor(t, dtype=ts.dtype, device=ts.device)
        scalar = t.ndim == 0
        t = t.reshape(-1)
        idx = torch.searchsorted(ts, t, right=True) - 1
        idx = torch.where(torch.isnan(t), -1, idx)
        i = torch.minimum(torch.clamp(idx, min=0), torch.full_like(idx, n_saved - 2))
        s = torch.clamp(i - (K // 2 - 1), min=0, max=max(n_saved - K, 0))
        j = s[:, None] + off[None, :]  # (m, K)
        jdx = torch.clamp(j, 0, S - 1)
        valid = j < n_saved
        tj = ts[jdx]  # (m, K)
        yj = ys[jdx]  # (m, K, n)
        diff = tj[:, :, None] - tj[:, None, :]
        prods = torch.prod(torch.where(offd & valid[:, None, :], diff, 1.0), dim=2)
        w = torch.where(valid, 1.0 / prods, 0.0)
        d = t[:, None] - tj
        absd = torch.abs(d)
        exact = (absd <= 1e-14 * (1.0 + torch.abs(t))[:, None]) & valid
        c = torch.where(exact, 0.0, w / torch.where(exact, 1.0, d))
        y_interp = torch.sum(c[:, :, None] * yj, dim=1) / torch.sum(c, dim=1)[:, None]
        # the nearest exact node only: two rows may lie within the tolerance
        nearest = torch.argmin(torch.where(valid, absd, float("inf")), dim=1)
        y_exact = yj[torch.arange(t.shape[0], device=t.device), nearest]
        out = torch.where(exact.any(dim=1)[:, None], y_exact, y_interp)
        return out[0] if scalar else out

    return y_at


def adjoint_backward(
    adjoint_rhs: Callable,  # (t, y, lam, p) -> -J^T lam
    adjoint_jac: Callable,  # (t, y, lam, p) -> -J^T (the options' storage)
    quad_rhs: Callable,  # (t, y, lam, p) -> lam^T df/dp_subset
    saved: dict,
    t0,
    tvals: torch.Tensor,
    grads: torch.Tensor,  # (n_t, n) observation cotangents g_i
    params: torch.Tensor,
    n_deriv: int,
    options: BDFOptions = BDFOptions(rtol=1e-10, atol=1e-10),
    lamda_end: Optional[torch.Tensor] = None,
    interpolation: str = "hermite",
) -> AdjointResult:
    """Backward adjoint solve of one trajectory over its observation
    intervals (the reference's ``AdjointSolver.solve_backward`` semantics):
    walk the observation times in reverse, add each cotangent to lambda at
    its time, and integrate ``dlam/dtau = J^T lam`` with the quadrature
    ``dq/dtau = lam^T df/dp`` (under error control) in ``tau = -t`` down to
    the next time and finally to ``t0``: one :func:`bdf_solve` an interval,
    warm-started from the previous interval's last step, the first from the
    automatic one.  y(t) from the recording, ``interpolation`` 'hermite' or
    'polynomial'.  A failed interval poisons lambda and q with NaN and
    raises the status; an overflowed recording gives status 99 and NaN.
    Port of ``sunode_tpu/adjoint.py::adjoint_backward``; ``stats`` adds the
    attempts and the Newton solver's calls to ``n_backward_steps``."""
    if interpolation == "polynomial":
        y_at = make_polynomial_eval(saved)
    elif interpolation == "hermite":
        y_at = make_hermite_eval(saved)
    else:
        raise ValueError(
            f"interpolation must be 'hermite' or 'polynomial', got {interpolation!r}"
        )
    y = saved["y"]
    f_kw = dict(dtype=y.dtype, device=y.device)
    n = y.shape[-1]
    tvals_h = torch.as_tensor(tvals).detach().to(y.dtype).reshape(-1).tolist()
    grads = torch.as_tensor(grads).detach().to(**f_kw)
    params = torch.as_tensor(params).detach().to(**f_kw)
    t0_h = float(t0)
    n_t = len(tvals_h)

    # every function of one attempt evaluates at the same tau tensor, so
    # y(t) is computed once per tau and reused
    last = [None, None]

    def y_of(tau):
        if last[0] is not tau:
            last[0], last[1] = tau, y_at(-host_time(tau))
        return last[1]

    def rhs_b(tau, lam, p):
        return -adjoint_rhs(-tau, y_of(tau), lam, p)  # dlam/dtau = +J^T lam

    def jac_b(tau, lam, p):
        return -adjoint_jac(-tau, y_of(tau), lam, p)

    def quad_b(tau, lam, p):
        return quad_rhs(-tau, y_of(tau), lam, p)  # dq/dtau = +lam^T df/dp

    quad_opts = options._replace(quad_err_con=True, save_steps=0)
    lam = (torch.zeros((n,), **f_kw) if lamda_end is None
           else torch.as_tensor(lamda_end).detach().to(**f_kw))
    q = torch.zeros((n_deriv,), **f_kw)
    status, nsteps, attempts, factors, solves = 0, 0, 0, 0, 0
    h_prev = -1.0  # the first interval starts automatically
    lower = tvals_h[::-1][1:] + [t0_h]
    for k, (t_hi, t_lo) in enumerate(zip(tvals_h[::-1], lower)):
        lam = lam + grads[n_t - 1 - k]  # inject the observation's cotangent
        if not (t_hi - t_lo) > 1e-14 * (1.0 + abs(t_hi)):
            continue
        res = bdf_solve(
            rhs_b, jac_b, -t_hi, lam, params, torch.tensor([-t_lo], **f_kw), quad_opts,
            quad_rhs=quad_b, quad0=q, first_step=h_prev,
        )
        ok = res.status == 0
        lam = res.ys[0] if ok else torch.full_like(lam, float("nan"))
        q = res.quad[0] if ok else torch.full_like(q, float("nan"))
        status = max(status, res.status)
        nsteps += res.stats["n_steps"]
        h_prev = res.stats["final_step_size"]
        attempts += res.stats["n_attempts"]
        factors += res.stats["n_linear_factors"]
        solves += res.stats["n_linear_solves"]

    # an overflowed recording is incomplete: poison instead of interpolating
    if bool(saved.get("overflow", int(saved["n_saved"]) >= saved["t"].shape[0])):
        lam = torch.full_like(lam, float("nan"))
        q = torch.full_like(q, float("nan"))
        status = 99
    return AdjointResult(
        lamda=lam, quad=q, status=status,
        stats=dict(n_backward_steps=nsteps, n_attempts=attempts, n_linear_factors=factors,
                   n_linear_solves=solves),
    )


def make_hermite_eval_batched(saved: dict) -> Callable:
    """Trailing-batch Hermite evaluator over the packed ``yf (S, 2n|3n, B)``
    table: ``y_at(t (B,)) -> (n, B)``.  Cubic over ``(y, f)`` rows; quintic
    where the rows carry ``fd``, gated per lane to ``h L <= 1`` where they
    carry ``L`` (cubic beyond: the h^2 (J f) term magnifies node error by
    (h L)^2 in stiff regions).  Port of
    ``sunode_tpu/adjoint.py::make_hermite_eval_batched``, packed branch.

    A state-split recording (``yf`` a :class:`~sunode_torch.parallel.rows.
    RowBlocks`) is read where it lies: each lane's bracket and weights are
    found once on the home device and sent to the blocks, each block
    evaluates its rows, and y(t) is gathered on the home device."""
    ts, n_saved, yf = saved["t"], saved["n_saved"], saved["yf"]
    quintic = "fd" in saved
    Ls = saved.get("L")
    ts_rows = ts.T.contiguous()

    def weights(t):
        """Each lane's bracket ``(i0, i1)``, its node weights for ``(y0, h
        f0, y1, h f1)`` (the cubic) and for ``(y0, h f0, h^2 fd0, y1, h f1,
        h^2 fd1)`` (the quintic, or None), and the quintic's gate (or None)."""
        i0, i1 = _bracket(ts, ts_rows, n_saved, t)
        t0, t1 = _rows(ts, i0), _rows(ts, i1)
        h = t1 - t0
        tau = torch.clamp((t - t0) / h, 0.0, 1.0)
        om = 1 - tau
        h00 = (1 + 2 * tau) * (om * om)
        h10 = tau * (om * om)
        h01 = (tau * tau) * (3 - 2 * tau)
        h11 = (tau * tau) * (tau - 1)
        cubic = (h00, h10 * h, h01, h11 * h)
        if not quintic:
            return i0, i1, cubic, None, None
        H0, H1, H2, H3, H4, H5 = _quintic_basis(tau)
        h2 = h * h
        quin = (H0, H1 * h, H2 * h2, H3, H4 * h, H5 * h2)
        ok = None if Ls is None else h * torch.maximum(_rows(Ls, i0), _rows(Ls, i1)) <= 1.0
        return i0, i1, cubic, quin, ok

    def rows_at(table, i0, i1, cubic_w, quin_w, ok):
        """The rows of ``table (S, 2m|3m, B)`` at the weights: ``(m, B)``."""
        m = table.shape[1] // (3 if quintic else 2)
        r0, r1 = _rows(table, i0), _rows(table, i1)
        y0, f0, y1, f1 = r0[:m], r0[m : 2 * m], r1[:m], r1[m : 2 * m]
        w00, w10, w01, w11 = cubic_w
        cubic = w00[None] * y0 + w10[None] * f0 + w01[None] * y1 + w11[None] * f1
        if quin_w is None:
            return cubic
        fd0, fd1 = r0[2 * m :], r1[2 * m :]
        q0, q1, q2, q3, q4, q5 = quin_w
        quin = (
            q0[None] * y0
            + q1[None] * f0
            + q2[None] * fd0
            + q3[None] * y1
            + q4[None] * f1
            + q5[None] * fd1
        )
        return quin if ok is None else torch.where(ok[None], quin, cubic)

    return _table_eval(saved, yf, weights, rows_at)


def _table_eval(saved: dict, table, weights, rows_at) -> Callable:
    """``y_at(t)``: ``rows_at(table, *weights(t))``, or on a state-split
    recording (``table`` a :class:`RowBlocks`) each block's rows at the
    weights, sent to its device, gathered on the home device in the layout
    of ``saved['y']``."""
    if not isinstance(table, RowBlocks):
        return lambda t: rows_at(table, *weights(t))
    layout = saved["y"].layout

    def on_blocks(w):  # a weight (or a tuple of them) on every block's device
        if w is None:
            return [None] * len(layout.devices)
        if isinstance(w, tuple):
            return list(zip(*(layout.lanes(x) for x in w)))
        return layout.lanes(w)

    def y_at(t):
        per_block = zip(*(on_blocks(w) for w in weights(t)))
        return RowBlocks(layout, [rows_at(x, *w) for x, w in zip(table.blocks, per_block)]
                         ).gather()

    return y_at


def make_polynomial_eval_batched(saved: dict) -> Callable:
    """Trailing-batch polynomial evaluator (the CV_POLYNOMIAL analog):
    barycentric Lagrange through the ``POLY_K`` recorded y rows around the
    bracketing interval (window clamped at the ends, degree lower where a
    lane has fewer rows), the nearest node itself within 1e-14 relative:
    ``y_at(t (B,)) -> (n, B)``.  Port of
    ``sunode_tpu/adjoint.py::make_polynomial_eval_batched``; a
    state-split recording is read as :func:`make_hermite_eval_batched`
    reads it."""
    ts, n_saved = saved["t"], saved["n_saved"]
    S, B = ts.shape
    K = min(POLY_K, S)
    ts_rows = ts.T.contiguous()
    off = torch.arange(K, device=ts.device)[:, None]  # (K, 1)
    offd = (off != off.T)[:, :, None]  # (K, K, 1)

    def weights(t):
        """Each lane's window ``jdx (K, B)``, barycentric weights ``c`` and
        their sum, and the nearest exact node."""
        i = _left_row(ts_rows, n_saved, t)
        s = torch.minimum(torch.clamp(i - (K // 2 - 1), min=0),
                          torch.clamp(n_saved - K, min=0))
        j = s[None, :] + off  # (K, B)
        jdx = torch.clamp(j, 0, S - 1)
        valid = j < n_saved[None, :]
        tj = ts.gather(0, jdx)  # (K, B)
        diff = tj[:, None, :] - tj[None, :, :]  # (K, K, B)
        prods = torch.prod(torch.where(offd & valid[None], diff, 1.0), dim=1)
        w = torch.where(valid, 1.0 / prods, 0.0)
        d = t[None, :] - tj
        absd = torch.abs(d)
        exact = (absd <= 1e-14 * (1.0 + torch.abs(t))[None, :]) & valid
        c = torch.where(exact, 0.0, w / torch.where(exact, 1.0, d))
        # the nearest exact node only: two rows may lie within the tolerance
        nearest = torch.argmin(torch.where(valid, absd, float("inf")), dim=0)
        return jdx, c, torch.sum(c, dim=0), nearest, exact.any(dim=0)

    def rows_at(y, jdx, c, c_sum, nearest, any_exact):
        """The rows of the ``(S, m, B)`` y table at the weights: ``(m, B)``."""
        yj = y.gather(0, jdx[:, None, :].expand(K, y.shape[1], B))  # (K, m, B)
        y_interp = torch.sum(c[:, None, :] * yj, dim=0) / c_sum[None, :]
        return torch.where(any_exact[None, :], _rows(yj, nearest), y_interp)

    yf = saved["yf"]
    if isinstance(yf, RowBlocks):  # a state-split recording: its y blocks
        y = saved["y"]
    else:  # the packed table's leading rows
        y = yf[:, : yf.shape[1] // (3 if "fd" in saved else 2)]
    return _table_eval(saved, y, weights, rows_at)


def adjoint_backward_batched(
    adjoint_rhs: Callable,  # batched (t, y, lam, p) -> -J^T lam, (n, B)
    adjoint_jac: Callable,  # batched (t, y, lam, p) -> -J^T, (n, n, B)
    quad_rhs: Callable,  # batched (t, y, lam, p) -> lam^T df/dp_subset, (n_deriv, B)
    saved: dict,  # trailing-batch, from bdf_solve_batched
    t0,
    tvals: torch.Tensor,  # (n_t,) shared
    grads: torch.Tensor,  # (B, n_t, n)
    params: torch.Tensor,  # (B, n_p)
    n_deriv: int,
    options: BDFOptions = BDFOptions(rtol=1e-10, atol=1e-10),
    method: str = "BDF",
    interpolation: str = "hermite",
    rhs: Optional[Callable] = None,  # batched forward f(t, y, p); for 'resolve'
    y_end: Optional[torch.Tensor] = None,  # (B, n) y(tvals[-1]); for 'resolve'
    device_system: Optional[DeviceSystem] = None,  # ADAMS on CUDA tensors
    rows: Optional[RowLayout] = None,  # ADAMS: the state rows over devices
) -> AdjointResult:
    """Backward solve of the checkpointed adjoint (CVODES's ``CVodeB``
    analog): from the last observation time down to ``t0``, add each
    observation's cotangent to lambda at its time and solve
    ``dlam/dtau = J^T lam`` with the quadrature ``dq/dtau = lam^T df/dp``
    in ``tau = -t``, y(t) from the recorded trajectory ('hermite' or
    'polynomial').  A lane whose solve fails turns NaN; a lane whose
    recording overflowed gets status 99 and NaN.

    ``method='BDF'`` solves one interval at a time with
    ``bdf_solve_batched`` (warm-started from the previous interval's step,
    the first from the automatic one).  ``method='ADAMS'`` makes one
    ``adams_solve_batched`` over the whole span, the cotangents injected at
    their times, y(t) staged once per attempt; with ``interpolation=
    'resolve'`` it integrates ``z = [y | lam]`` from ``y_end`` instead (the
    backsolve adjoint: no table, for non-stiff problems; needs ``rhs`` and
    ``y_end``, ignores ``saved``, and reports ``stats['y0_resolved']``).
    ``device_system`` is the emitted backward system of that solve
    (``staged_adjoint`` or ``resolve``, ``symode/cuda_codegen.py``), which
    a solve on CUDA tensors requires.

    ``rows`` (``method='ADAMS'``) takes the state-split route of
    ``adams_solve_batched``: lambda's rows over the layout of the forward
    solve's state (for 'resolve', y and lambda of the same state rows on one
    device: ``rows.repeated(2)``), the quadrature on the home device; the
    recording's rows are read where they lie."""
    if rows is not None and method != "ADAMS":
        raise ValueError("adjoint_backward_batched: the state split (rows=...) takes "
                         "method='ADAMS'; ROADMAP A queues BDF")
    if interpolation == "resolve":
        if method != "ADAMS":
            raise NotImplementedError("interpolation='resolve' requires method='ADAMS'")
        if rhs is None or y_end is None:
            raise ValueError("interpolation='resolve' requires rhs and y_end")
        return _resolve_backward(adjoint_rhs, quad_rhs, rhs, y_end, t0, tvals, grads, params,
                                 n_deriv, options, device_system, rows)
    if interpolation == "polynomial":
        y_at = make_polynomial_eval_batched(saved)
    elif interpolation == "hermite":
        y_at = make_hermite_eval_batched(saved)
    else:
        raise ValueError(
            f"interpolation must be 'hermite', 'polynomial' or 'resolve', got {interpolation!r}"
        )
    if method == "ADAMS":
        return _fused_adams_backward(adjoint_rhs, quad_rhs, y_at, saved, t0, tvals, grads,
                                     params, n_deriv, options, device_system, rows)
    y = saved["y"]
    dtype, device = y.dtype, y.device
    S, n, B = y.shape
    tvals_h = torch.as_tensor(tvals, dtype=dtype).tolist()  # one read per backward
    t0_h = float(t0)
    n_t = len(tvals_h)
    grads = torch.as_tensor(grads, dtype=dtype, device=device)
    params = torch.as_tensor(params, dtype=dtype, device=device)

    # Every right-hand side of one attempt evaluates at the same tau tensor
    # (the Newton iterations, the quadrature and the Jacobian at t_new), so
    # y(t) is computed once per tau and reused: the same values, fewer calls.
    last = [None, None]

    def y_of(tau):
        if last[0] is not tau:
            last[0], last[1] = tau, y_at(-tau)
        return last[1]

    def rhs_b(tau, lam, p):
        return -adjoint_rhs(-tau, y_of(tau), lam, p)  # dlam/dtau = +J^T lam

    def jac_b(tau, lam, p):
        return -adjoint_jac(-tau, y_of(tau), lam, p)

    def quad_b(tau, lam, p):
        return quad_rhs(-tau, y_of(tau), lam, p)  # dq/dtau = +lam^T df/dp

    quad_opts = options._replace(quad_err_con=True, save_steps=0)
    f_kw = dict(dtype=dtype, device=device)
    lam = torch.zeros((B, n), **f_kw)
    q = torch.zeros((B, n_deriv), **f_kw)
    status = torch.zeros((B,), dtype=torch.int32, device=device)
    nsteps = torch.zeros((B,), dtype=torch.int32, device=device)
    h_prev = torch.full((B,), -1.0, **f_kw)  # the first interval starts automatically
    attempts = factors = solves = 0
    lower = tvals_h[::-1][1:] + [t0_h]
    for k, (t_hi, t_lo) in enumerate(zip(tvals_h[::-1], lower)):
        lam = lam + grads[:, n_t - 1 - k, :]
        if not (t_hi - t_lo) > 1e-14 * (1.0 + abs(t_hi)):
            continue
        res = bdf_solve_batched(
            rhs_b, jac_b, -t_hi, lam, params, torch.tensor([-t_lo], **f_kw), quad_opts,
            quad_rhs=quad_b, quad0=q, first_step=h_prev, batched_fns=True,
        )
        ok = (res.status == 0)[:, None]
        lam = torch.where(ok, res.ys[:, 0, :], float("nan"))
        q = torch.where(ok, res.quad[:, 0, :], float("nan"))
        status = torch.maximum(status, res.status)
        nsteps = nsteps + res.stats["n_steps"]
        h_prev = res.stats["final_step_size"]
        attempts += res.stats["n_attempts"]
        factors += res.stats["n_linear_factors"]
        solves += res.stats["n_linear_solves"]

    # an overflowed recording is incomplete: poison instead of interpolating
    overflow = saved["overflow"]
    lam = torch.where(overflow[:, None], float("nan"), lam)
    q = torch.where(overflow[:, None], float("nan"), q)
    status = torch.where(overflow, 99, status).to(torch.int32)
    return AdjointResult(
        lamda=lam, quad=q, status=status,
        stats=dict(n_backward_steps=nsteps, n_attempts=attempts, n_linear_factors=factors,
                   n_linear_solves=solves),
    )


def resolve_fz(rhs: Callable, adjoint_rhs: Callable, quad_rhs: Callable, n: int):
    """The backsolve adjoint's system in tau = -t, batched over lanes:
    ``(rhs_c, quad_c)``, ``rhs_c(tau, z, p)`` for ``z = [y | lam]`` gives
    ``[-f | J^T lam]`` and ``quad_c`` gives ``lam^T df/dp``; the torch form
    of ``sunode_tpu/adjoint.py:756-764``."""

    def rhs_c(tau, z, p):
        t = -tau
        y, lam = z[:n], z[n:]
        # dy/dtau = -f(t, y);  dlam/dtau = +J^T lam = -adjoint_rhs
        return torch.cat([-rhs(t, y, p), -adjoint_rhs(t, y, lam, p)])

    def quad_c(tau, z, p):
        return quad_rhs(-tau, z[:n], z[n:], p)

    return rhs_c, quad_c


def staged_adjoint_fz(adjoint_rhs: Callable, quad_rhs: Callable):
    """The checkpointed adjoint's system in tau = -t with y(t) staged:
    ``(rhs_s, quad_s)``, ``rhs_s(tau, lam, p, y)`` gives ``J^T lam`` and
    ``quad_s`` gives ``lam^T df/dp``; the torch form of
    ``sunode_tpu/adjoint.py:861-865``."""

    def rhs_s(tau, lam, p, y):
        return -adjoint_rhs(-tau, y, lam, p)  # dlam/dtau = +J^T lam

    def quad_s(tau, lam, p, y):
        return quad_rhs(-tau, y, lam, p)  # dq/dtau = +lam^T df/dp

    return rhs_s, quad_s


def _fused_solve(rhs_c, quad_c, z0, cotangent_rows, t0, tvals, grads, params, n_deriv,
                 options, device_system, stage_fn=None, rows=None):
    """The one backward Adams solve of the fused backwards, in tau = -t from
    ``-tvals[-1]`` to ``-t0``: the observation times before the last are
    injection times, ascending in tau, where the rows ``cotangent_rows`` of
    ``z`` jump by their cotangents; quadrature under error control."""
    f_kw = dict(dtype=grads.dtype, device=grads.device)
    deltas = torch.flip(grads[:, :-1, :], (1,)).permute(1, 2, 0)  # (n_e, n, B)
    ev_deltas = torch.zeros((deltas.shape[0], z0.shape[1], z0.shape[0]), **f_kw)
    ev_deltas[:, cotangent_rows] = deltas
    return adams_solve_batched(
        rhs_c, -tvals[-1], z0, torch.as_tensor(params, **f_kw),
        torch.stack([-torch.as_tensor(t0, **f_kw)]),
        options._replace(quad_err_con=True, save_steps=0),
        quad_rhs=quad_c, quad0=torch.zeros((z0.shape[0], n_deriv), **f_kw), batched_fns=True,
        device_system=device_system, inject_times=torch.flip(-tvals[:-1], (0,)),
        inject_deltas=ev_deltas, stage_fn=stage_fn, rows=rows,
    )


def _fused_adams_backward(adjoint_rhs, quad_rhs, y_at, saved, t0, tvals, grads, params,
                          n_deriv, options, device_system, rows=None) -> AdjointResult:
    """The ADAMS branch of :func:`adjoint_backward_batched` (the reference's
    fused backward, ``sunode_tpu/adjoint.py:844-894``): the last cotangent
    is the initial lambda, the others are injected (history restart, warm
    step), y(t) from the recording is staged once per attempt, and lambda
    and q are read from the final carried state."""
    f_kw = dict(dtype=saved["t"].dtype, device=saved["t"].device)
    tvals = torch.as_tensor(tvals, **f_kw)
    grads = torch.as_tensor(grads, **f_kw)
    n = grads.shape[2]
    res = _fused_solve(
        *staged_adjoint_fz(adjoint_rhs, quad_rhs), grads[:, -1, :], slice(0, n), t0, tvals,
        grads, params, n_deriv, options, device_system, stage_fn=lambda tau: y_at(-tau),
        rows=rows,
    )
    zfin = res.stats["final_state"]  # (B, n + n_deriv)
    # a failed solve, or an overflowed (incomplete) recording, poisons the lane
    bad = ((res.status != 0) | saved["overflow"])[:, None]
    return AdjointResult(
        lamda=torch.where(bad, float("nan"), zfin[:, :n]),
        quad=torch.where(bad, float("nan"), zfin[:, n:]),
        status=torch.where(saved["overflow"], 99, res.status).to(torch.int32),
        stats=dict(n_backward_steps=res.stats["n_steps"], n_attempts=res.stats["n_attempts"]),
    )


def _resolve_backward(adjoint_rhs, quad_rhs, rhs, y_end, t0, tvals, grads, params, n_deriv,
                      options, device_system, rows=None) -> AdjointResult:
    """``interpolation='resolve'`` (``sunode_tpu/adjoint.py:738-808``): the
    fused backward solve of ``z = [y | lam]`` from ``[y_end | g_last]``, the
    y rows continuous, the lambda rows jumping by the cotangents."""
    grads = torch.as_tensor(grads)
    f_kw = dict(dtype=grads.dtype, device=grads.device)
    tvals = torch.as_tensor(tvals, **f_kw)
    B, n_t, n = grads.shape
    if n_t != tvals.shape[0]:
        raise ValueError(
            f"grads has {n_t} observation rows but tvals has {tvals.shape[0]} times"
        )
    z0 = torch.cat([torch.as_tensor(y_end, **f_kw), grads[:, -1, :]], dim=1)
    res = _fused_solve(
        *resolve_fz(rhs, adjoint_rhs, quad_rhs, n), z0, slice(n, 2 * n), t0, tvals, grads,
        params, n_deriv, options, device_system, rows=None if rows is None else rows.repeated(2),
    )
    zfin = res.stats["final_state"]  # (B, 2n + n_deriv)
    bad = (res.status != 0)[:, None]
    return AdjointResult(
        lamda=torch.where(bad, float("nan"), zfin[:, n : 2 * n]),
        quad=torch.where(bad, float("nan"), zfin[:, 2 * n :]),
        status=res.status.to(torch.int32),
        stats=dict(
            n_backward_steps=res.stats["n_steps"],
            n_attempts=res.stats["n_attempts"],
            # an independent re-computation of y(t0): the reconstruction's quality
            y0_resolved=zfin[:, :n],
        ),
    )
