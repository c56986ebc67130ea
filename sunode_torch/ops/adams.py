"""Variable-order Adams-Moulton integrator (CVODES CV_ADAMS analog) for one
instance, and the coefficient tables every Adams core reads.

Port of ``sunode_tpu/ops/adams.py``.  Backward-difference form: the
predictor is ``y_pred = y_prev + h * sum_{i<p} gamma_i DF[i]``, the
corrector ``y_n = y_pred + h * gamma_{p-1} * d_f`` solved by functional
iteration, the local error ``h * gamma*_p * d_f``, orders 1..12 (capped by
``adams_max_order``), and dense output that integrates the f-interpolant
exactly.  The tables are computed by the same numpy code as the reference,
so the numbers are identical bit for bit.

:func:`adams_solve` is a host loop as :func:`sunode_torch.ops.bdf.bdf_solve`
is: step size, order and every decision on the host in the solve's type,
the state and the f-differences as torch tensors on ``y0``'s device.  With
a quadrature it runs the batched core at one lane, as the reference does.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from sunode_torch.ops.bdf import (
    MAX_CONSECUTIVE_FAILS,
    MAX_FACTOR,
    MIN_FACTOR,
    STATUS,
    THRESH,
    BDFOptions,
    BDFResult,
    RootRecord,
    _fetch,
    _host_vec,
    _initial_step,
    _np_dtype,
    _root_scan,
    _root_setup,
    _scalar,
    _single_roots,
    _upload,
    _wrms,
)

__all__ = [
    "ADAMS_MAX_ORDER",
    "FUNCTIONAL_MAXITER",
    "KA",
    "adams_solve",
    "adams_options",
    "_GAMMA",
    "_GAMMA_STAR",
    "_C_INT",
]

ADAMS_MAX_ORDER = 12
KA = ADAMS_MAX_ORDER + 3  # DF rows 0..p+2
FUNCTIONAL_MAXITER = 4


def _adams_gammas():
    """Adams-Bashforth gammas (backward-difference form) and Moulton gammas.

    gamma_m: 1, 1/2, 5/12, 3/8, ...   via gamma_m = 1 - sum_{k<m} gamma_k/(m+1-k)
    gamma*_m = gamma_m - gamma_{m-1}  (error constants)."""
    K = ADAMS_MAX_ORDER + 2
    g = np.zeros(K)
    for m in range(K):
        g[m] = 1.0 - sum(g[k] / (m + 1 - k) for k in range(m))
    gs = np.empty(K)
    gs[0] = 1.0
    gs[1:] = g[1:] - g[:-1]
    return g, gs


_GAMMA, _GAMMA_STAR = _adams_gammas()


def _integral_basis_coeffs():
    """Coefficients of c_i(s) = integral_0^s prod_{m<i}(u+m)/(m+1) du.

    c_i is a degree-(i+1) polynomial; returns a (K, K+2) nested tuple of
    monomial coefficients (ascending powers) for i = 0..K-1."""
    K = ADAMS_MAX_ORDER + 1
    out = np.zeros((K, K + 2))
    for i in range(K):
        poly = np.polynomial.Polynomial([1.0])
        for m in range(i):
            poly = poly * np.polynomial.Polynomial([m, 1.0]) / (m + 1)
        coefs = poly.integ().coef
        out[i, : len(coefs)] = coefs
    return tuple(tuple(float(c) for c in row) for row in out)


_C_INT = _integral_basis_coeffs()

_C_INT_NP = np.asarray(_C_INT)  # (13, 15) ascending powers


def _rescale_matrices(p: int, factor, np_dtype) -> np.ndarray:
    """``(R(factor), U = R(1))`` stacked ``(2, 13, 13)``: the BDF core's
    Shampine/Reichelt matrices at the Adams orders, the identity outside the
    leading p block (differences 0..p-1 are current)."""
    K = ADAMS_MAX_ORDER + 1
    j = np.arange(K, dtype=np_dtype)
    ar = np.arange(K)
    inblock = (ar[:, None] <= p - 1) & (ar[None, :] <= p - 1)
    out = []
    for fac in (np_dtype(factor), np_dtype(1.0)):
        rows = [np.ones(K, np_dtype)]
        for i in range(1, K):
            rows.append(rows[-1] * (i - 1 - fac * j) / i)
        out.append(np.where(inblock, np.stack(rows), np.eye(K, dtype=np_dtype)))
    return np.stack(out)


def _rescale_DF(DF: torch.Tensor, p: int, factor) -> torch.Tensor:
    """Rescale the f-differences ``(KA, ...)`` for h -> factor h."""
    K = ADAMS_MAX_ORDER + 1
    RU = _upload(_rescale_matrices(p, factor, _np_dtype(DF.dtype)), DF.device)
    head = DF[:K].reshape(K, -1)
    head = RU[1].T @ (RU[0].T @ head)
    return torch.cat([head.reshape(DF[:K].shape), DF[K:]])


def _update_DF(DF: torch.Tensor, p: int, d_f: torch.Tensor) -> torch.Tensor:
    """Post-acceptance difference update (q = p - 1):
      i <= q   : DF_new[i] = sum_{j=i..q} DF[j] + d_f
      i == p   : d_f
      i == p+1 : d_f - DF[p]
      i >  p+1 : unchanged;
    the sums accumulated from d_f upward, as the reference's loop."""
    q = p - 1
    suffix = torch.cat([DF[: q + 1], d_f[None]]).flip(0).cumsum(0).flip(0)[: q + 1]
    return torch.cat([suffix, d_f[None], (d_f - DF[q + 1])[None], DF[q + 3 :]])


def _interp_weights(p: int, s) -> np.ndarray:
    """``c_i(s)`` for i = 0..p on the host, Horner in s over the static
    integral-basis table (the reference's order)."""
    out = np.zeros(p + 1, type(s))
    for i in range(p + 1):
        ci = type(s)(0.0)
        for a in _C_INT[i][::-1]:
            ci = ci * s + a
        out[i] = ci
    return out


def _interp_y(y_n: torch.Tensor, DF_new: torch.Tensor, p: int, h, s) -> torch.Tensor:
    """``y(t_n + s h) = y_n + h sum_{i<=p} c_i(s) nabla^i f_n`` (``DF_new``
    based at f_n, after the update).  A host ``s`` takes host weights; a
    tensor ``s (m,)`` (the root scan's brackets) device weights, Horner over
    the table's rows at once, and gives ``(n, m)``."""
    if torch.is_tensor(s):
        C = torch.as_tensor(_C_INT_NP[: p + 1], dtype=s.dtype, device=s.device)
        ci = torch.zeros((p + 1,) + tuple(s.shape), dtype=s.dtype, device=s.device)
        for col in range(C.shape[1] - 1, -1, -1):
            ci = ci * s + C[:, col].reshape((-1,) + (1,) * s.ndim)
        out = torch.einsum("i...,in->n...", ci, DF_new[: p + 1])
        return y_n.reshape(y_n.shape + (1,) * s.ndim) + float(h) * out
    w = _upload(_interp_weights(p, s), DF_new.device)
    return y_n + float(h) * (w @ DF_new[: p + 1])


def adams_solve(
    rhs: Callable,
    t0,
    y0: torch.Tensor,
    params: torch.Tensor,
    tvals: torch.Tensor,
    options: BDFOptions = BDFOptions(),
    *,
    first_step: Optional[Any] = None,
    root_fn: Optional[Callable] = None,
    root_cap: int = 8,
    root_terminal: bool = True,
    root_directions: Optional[Any] = None,
    quad_rhs: Optional[Callable] = None,  # (t, y, p) -> (m,)
    quad0: Optional[torch.Tensor] = None,  # (m,)
) -> BDFResult:
    """Integrate a non-stiff ODE with adaptive-order Adams-Moulton: the port
    of ``sunode_tpu/ops/adams.py::adams_solve``, the contract of
    :func:`~sunode_torch.ops.bdf.bdf_solve` without the Jacobian and the
    sensitivity block.  ``root_fn`` and its options as there (the shared
    root scan on the Adams dense output).  ``quad_rhs``/``quad0`` run the
    batched core at one lane (no ``save_steps`` then), as the reference
    does; on CUDA tensors that core chooses its kernels as it does for any
    problem without an emitted system.  ``status`` and the scalar stats are
    Python numbers; ``stats['n_attempts']`` counts the attempts."""
    if quad_rhs is not None:
        if quad0 is None:
            raise ValueError("quad_rhs requires quad0")
        if int(options.save_steps) > 0:
            raise ValueError(
                "quad_rhs with save_steps > 0 is not supported on the Adams core (the "
                "adjoint paths carry their own quadrature)"
            )
        from sunode_torch.ops.adams_batched import adams_solve_batched

        y0 = torch.as_tensor(y0)
        if first_step is not None:
            # the override as the batched core's option: > 0 clipped to the
            # span, else the automatic step
            fs = float(first_step)
            t_end = float(torch.as_tensor(tvals).reshape(-1)[-1])
            options = options._replace(first_step=min(fs, t_end - float(t0)) if fs > 0 else None)
        res = adams_solve_batched(
            rhs, t0, y0[None], torch.as_tensor(params, device=y0.device)[None], tvals, options,
            quad_rhs=quad_rhs, quad0=torch.as_tensor(quad0, device=y0.device)[None],
            root_fn=root_fn, root_cap=root_cap, root_terminal=root_terminal,
            root_directions=root_directions,
        )
        stats = {}
        for k, v in res.stats.items():
            if torch.is_tensor(v):
                v = v[0] if v.ndim > 0 else v
                v = v.item() if v.ndim == 0 and k != "final_state" else v
            stats[k] = v
        return BDFResult(ys=res.ys[0], status=int(res.status[0]), stats=stats, saved=None,
                         quad=res.quad[0])

    from sunode_torch.ops._recording import (
        fill_fdot_single,
        finalize_saved_single,
        init_saved_single,
        record_step_single,
    )

    y0 = torch.as_tensor(y0)
    device = y0.device
    dtype = torch.promote_types(y0.dtype, torch.float32)
    sc = _np_dtype(dtype)
    f_kw = dict(dtype=dtype, device=device)
    y0 = y0.detach().to(dtype)
    params = torch.as_tensor(params).detach().to(**f_kw)
    tv = [sc(v) for v in torch.as_tensor(tvals).detach().reshape(-1).tolist()]
    t0 = sc(float(t0))
    n, n_t = y0.shape[0], len(tv)
    t_end = tv[-1]
    max_order = min(options.adams_max_order, ADAMS_MAX_ORDER)

    rtol = _host_vec(options.rtol, n, sc)
    rtol_s = rtol.min()
    atol = _host_vec(options.atol, n, sc)
    tol = _upload(np.stack([atol, rtol]), device)
    gamma = np.asarray(_GAMMA, sc)
    gamma_star = np.asarray(np.abs(_GAMMA_STAR), sc)
    newton_tol = sc(options.newton_tol_factor) * np.maximum(
        sc(10) * sc(torch.finfo(dtype).eps) / rtol_s, np.minimum(sc(0.03), np.sqrt(rtol_s))
    )
    eps = sc(torch.finfo(dtype).eps)
    constraints = None
    if options.constraints is not None:
        constraints = _upload(_host_vec(options.constraints, n, sc), device)

    t0_t = _scalar(t0, y0)
    f0 = rhs(t0_t, y0, params)
    bad_init = not bool(torch.isfinite(y0).all() & torch.isfinite(f0).all())
    h_auto = _initial_step(rhs, t0, y0, f0, params, t_end, rtol, atol, options.max_step, sc)
    if first_step is not None and sc(float(first_step)) > 0:
        h0 = np.minimum(sc(float(first_step)), t_end - t0)
    elif first_step is None and options.first_step is not None:
        h0 = sc(options.first_step)
    else:
        h0 = h_auto
    h0 = np.maximum(h0, sc(1e-12))

    DF = torch.zeros((KA, n), **f_kw)
    DF[0] = f0

    save_steps = int(options.save_steps)
    thinning = bool(options.checkpoint_thinning)
    rec_fd = save_steps > 0 and options.hermite_order == 5

    def record_row(t_t, y, f):
        # quintic rows: f' is filled for every row after the solve
        parts = [t_t[None], y, f]
        if rec_fd:
            parts.append(torch.zeros_like(f))
        return torch.cat(parts)

    saved = init_saved_single(record_row(t0_t, y0, f0), save_steps, thinning) \
        if save_steps > 0 else None

    ys = torch.full((n_t, n), float("nan"), **f_kw)
    i_out = sum(1 for v in tv if v <= t0)
    ys[:i_out] = y0

    with_roots = root_fn is not None
    if with_roots:
        root_b = _single_roots(root_fn, dtype)
        p_col = params[:, None]
        g_init, rdir, root_cap = _root_setup(root_b, t0_t[None], y0[:, None], p_col, root_cap,
                                             root_directions)
        roots = RootRecord(g_init, n, root_cap)

    # per-order predictor rows [gamma_i | 1] over i < p, made once an order
    pred_w: dict = {}

    t, y_prev, h, h_D, p = t0, y0, h0, h0, 1
    n_equal = 0
    status = STATUS["BAD_INIT"] if bad_init else -1
    cfails = 0
    nsteps, nfev, nniters, n_err_fails, n_conv_fails = 0, 2, 0, 0, 0
    pm_t, pm_h, pm_q, pm_worst = float("nan"), float("nan"), -1, -1
    it = 0

    while status == -1 and i_out < n_t:
        it += 1
        h_min_loc = sc(10) * eps * np.maximum(np.abs(t), np.abs(t_end))
        underflow = not (h >= np.maximum(h_min_loc, sc(options.min_step)))
        h_use = np.minimum(h, t_end - t)
        t_new = t + h_use
        t_new_t = _scalar(t_new, y0)

        DF = _rescale_DF(DF, p, h_use / np.maximum(h_D, sc(1e-300)))
        if p not in pred_w:
            K = ADAMS_MAX_ORDER + 1
            m = (np.arange(K) <= p - 1).astype(sc)
            pred_w[p] = _upload(np.stack([m * gamma[:K], m]), device)
        acc_fex = pred_w[p] @ DF[: ADAMS_MAX_ORDER + 1]
        y_pred = y_prev + float(h_use) * acc_fex[0]
        f_extrap = acc_fex[1]
        c_A = float(h_use * gamma[p - 1])
        scale_w = 1.0 / (tol[0] + tol[1] * torch.abs(y_pred))

        # functional (fixed-point) corrector iteration
        y, dy_old, k = y_pred, sc(np.inf), 0
        conv = div = bad = False
        while k < FUNCTIONAL_MAXITER and not (conv or div or bad):
            f = rhs(t_new_t, y, params)
            y_next = y_pred + c_A * (f - f_extrap)
            dy_norm, fin = _fetch(_wrms(y_next - y, scale_w), torch.isfinite(f).all())
            dy_norm = sc(dy_norm)
            with np.errstate(all="ignore"):
                rate = dy_norm / dy_old
                diverged = k > 0 and rate >= 2.0
                converged = (dy_norm == 0.0) or (
                    k > 0 and rate < 1.0 and rate / (1 - rate) * dy_norm < newton_tol
                ) or (dy_norm < 0.1 * newton_tol)
            bad = not fin
            conv = converged and not bad
            div = diverged and not converged
            y, dy_old = y_next, dy_norm
            k += 1
        y_new = y

        f_new = rhs(t_new_t, y_new, params)
        d_f = f_new - f_extrap
        DF_upd = _update_DF(DF, p, d_f)
        err = float(gamma_star[p] * h_use) * d_f
        err_m_t = _wrms(float(gamma_star[max(p - 1, 0)] * h_use) * DF_upd[p - 1], scale_w)
        err_p_t = _wrms(float(gamma_star[min(p + 1, ADAMS_MAX_ORDER + 1)] * h_use)
                        * DF_upd[p + 1], scale_w)
        pred_ok_t = torch.isfinite(y_pred).all()
        viol_t = ~pred_ok_t
        if constraints is not None:
            c_ = constraints
            viol_t = (((c_ == 1) & (y_new < 0)) | ((c_ == -1) & (y_new > 0))
                      | ((c_ == 2) & (y_new <= 0)) | ((c_ == -2) & (y_new >= 0))).any()
        vals = _fetch(_wrms(err, scale_w), err_m_t, err_p_t, pred_ok_t, viol_t)
        err_norm, err_m_raw, err_p_raw = (sc(v) for v in vals[:3])
        conv = conv and bool(vals[3])
        constraint_fail = bool(vals[4]) if constraints is not None else False

        err_ok = err_norm <= 1.0
        accept = conv and err_ok and not constraint_fail
        err_reject = conv and (not err_ok or constraint_fail)
        n_equal = n_equal + 1 if accept else 0

        t_stop = None
        root_hit = False
        if with_roots and accept:
            hit, t_root, dirs, y_root, g_new = _root_scan(
                root_b, p_col, rdir, roots.g_prev, t0_t.new_full((1,), float(t)),
                t_new_t[None], t0_t.new_full((1,), float(h_use)), y_new[:, None],
                lambda tt: _interp_y(y_new, DF_upd, p, h_use, (tt - float(t_new)) / float(h_use)),
                torch.ones((1,), dtype=torch.bool, device=device),
            )
            roots.update(torch.ones((1,), dtype=torch.bool, device=device), hit, t_root, dirs,
                         y_root, g_new)
            root_hit = bool(hit[0])
            if root_terminal and root_hit:
                t_stop = sc(t_root[0].item())

        if accept:
            while i_out < n_t and tv[i_out] <= t_new + sc(1e-14) * np.abs(t_new) and (
                    t_stop is None or tv[i_out] <= t_stop):
                ys[i_out] = _interp_y(y_new, DF_upd, p, h_use, (tv[i_out] - t_new) / h_use)
                i_out += 1

        if save_steps > 0:
            saved = record_step_single(saved, accept,
                                       lambda: record_row(t_new_t, y_new, f_new),
                                       save_steps, thinning)

        # ---- order and step adaptation -----------------------------------
        err_m = err_m_raw if p > 1 else sc(np.inf)
        err_p = err_p_raw if p < max_order else sc(np.inf)

        def fac(e, qq):
            if not np.isfinite(e):
                return sc(0)
            return sc(0.9) * np.clip(e, sc(1e-30), sc(1e30)) ** (sc(-1.0) / (sc(qq) + sc(1.0)))

        with np.errstate(all="ignore"):
            facs = [fac(err_m, p - 1), fac(err_norm, p), fac(err_p, p + 1)]
            factor_rej = np.clip(
                sc(0.9) * np.clip(err_norm, sc(1e-30), sc(1e30)) ** (sc(-1.0) / (p + sc(1.0))),
                sc(MIN_FACTOR), sc(0.9))
        best = int(np.argmax(facs))
        dq = best - 1
        factor_best = np.clip(facs[best], sc(MIN_FACTOR), sc(MAX_FACTOR))
        do_change = n_equal >= p + 1 and (
            (factor_best >= THRESH) or (factor_best < 1.0) or (dq != 0))
        p_acc = int(np.clip(p + dq, 1, max_order)) if do_change else p
        factor_acc = factor_best if do_change else sc(1)
        factor_acc = np.minimum(factor_acc, sc(options.max_step) / np.maximum(h_use, sc(1e-300)))
        if do_change and accept:
            n_equal = 0
        if constraint_fail and err_ok:
            factor_rej = sc(0.25)
        factor_fail = factor_rej if conv else sc(0.25)  # a convergence failure: h/4

        # breakdown detector: 4 accumulated failures keep only nabla^0 f and
        # restart at order 1
        reset = not accept and cfails + 1 >= 4
        if accept:
            cfails = max(cfails - 1, 0) if err_norm <= 0.9 else cfails
        else:
            cfails = 0 if reset else cfails + 1
        factor_next = factor_acc if accept else (sc(0.25) if reset else factor_fail)
        if accept:
            DF = DF_upd
        elif reset:
            DF = torch.cat([DF[:1], torch.zeros_like(DF[1:])])
        too_many = cfails >= MAX_CONSECUTIVE_FAILS

        status_old = status
        if status == -1 and too_many and not accept:
            status = STATUS["REPEATED_FAILURES"]
        if status == -1 and nsteps + int(accept) >= options.max_steps:
            status = STATUS["MAX_STEPS"]
        if status == -1 and underflow:
            status = STATUS["STEP_UNDERFLOW"]
        root_ret_now = False
        if with_roots and root_terminal and status == -1 and root_hit:
            root_ret_now, status = True, STATUS["ROOT_RETURN"]
        if status_old == -1 and status != -1 and not root_ret_now:
            e = torch.abs(err) * scale_w if conv else torch.abs(y_new - y_pred) * scale_w
            pm_worst = int(torch.argmax(e))
            pm_t, pm_h, pm_q = float(t), float(h_use), p

        nsteps += int(accept)
        nfev += k + 1
        nniters += k
        n_err_fails += int(err_reject)
        n_conv_fails += int(not conv)
        if accept:
            t, y_prev = t_new, y_new
        h = h_use * factor_next
        h_D = h_use
        p = p_acc if accept else (1 if reset else p)

    status = STATUS["SUCCESS"] if status == -1 else status
    stats = dict(
        n_steps=nsteps,
        n_rhs_evals=nfev,
        n_jac_evals=0,
        n_factorizations=0,
        n_newton_iters=nniters,
        n_error_test_fails=n_err_fails,
        n_conv_fails=n_conv_fails,
        final_order=p,
        final_step_size=float(h),
        final_time=float(t),
        final_state=y_prev,
        n_attempts=it,
        error_time=pm_t,
        error_step_size=pm_h,
        error_order=pm_q,
        error_worst_state=pm_worst,
    )
    if with_roots:
        stats.update({k: v[0] for k, v in roots.stats().items()})
    saved_out = None
    if save_steps > 0:
        stats["checkpoint_thinning_levels"] = saved["shift"] if thinning else 0
        buf, n_saved, overflow = finalize_saved_single(saved, thinning)
        if rec_fd:
            buf = fill_fdot_single(buf, min(n_saved, buf.shape[0]), n, rhs, params)
        saved_out = {"t": buf[:, 0], "y": buf[:, 1 : n + 1], "f": buf[:, n + 1 : 2 * n + 1],
                     "n_saved": n_saved, "overflow": overflow}
        if rec_fd:
            saved_out["fd"] = buf[:, 2 * n + 1 :]
    return BDFResult(ys=ys, status=status, stats=stats, saved=saved_out)


def adams_options(options: BDFOptions) -> BDFOptions:
    """The ``Solver('ADAMS')`` configuration hook: the options as given (the
    Adams order cap is ``adams_max_order``, default 8)."""
    return options
