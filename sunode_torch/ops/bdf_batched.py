"""Batch-native BDF integrator (stiff problems, forward sensitivities), in PyTorch.

Port of ``sunode_tpu/ops/bdf_batched.py::bdf_solve_batched``: shared
``(n_t,)`` or per-lane ``(B, n_t)`` observation times (each lane emits on
its own ascending grid and ends at its own last time; a ragged grid is
padded with copies of its last time), scalar or per-state vector ``rtol``,
BDF or NDF formulas of orders 1..5, lazy Jacobian refresh and refactoring
only when the step coefficient changes, forward sensitivities,
simultaneous or staggered (``sens_rhs``/``S0``, ``sens_err_con``,
``sens_pbar``, ``sens_staggered``), rootfinding (``root_fn``, ``root_cap``,
``root_terminal``, ``root_directions``), the quadrature block
(``quad_rhs``/``quad0``, ``quad_err_con``), constraints, the breakdown
reset, NaN-poison statuses, the per-lane post-mortem stats and checkpoint
recording for the adjoint (``save_steps``, ``checkpoint_thinning``,
``hermite_order``; :mod:`sunode_torch.ops._recording`).

Layout: states are ``(rows, B)`` with the lane axis last, the difference
array ``D`` is ``(KD, nt, B)`` over the combined state ``z = [y | vec S | q]``
and Newton matrices are ``(n, n, B)``, or structured (``linear_solver``
'band', 'sparse' or 'spgmr'; :mod:`sunode_torch.ops.linsolve`: the banded
and the bordered-block-diagonal storage, factored by the banded LU's
kernels on CUDA tensors, or no matrix at all).  The lockstep loop is a host
loop, as in :mod:`sunode_torch.ops.adams_batched`: one device sync per
attempt to see whether any lane is active and one per emission sweep.
Every per-lane scalar stays a tensor on the device.  Dense Newton matrices are factored
by ``torch.linalg`` (see :mod:`sunode_torch.ops.linalg`).  The small
fixed-size contractions that the reference unrolls element by element (the
rescale, the predictor, the difference update, the dense output) are
products and sequential ``cumsum``s over the leading axis of ``(K, nt, B)``
tensors, which round in the reference's order; the LU and the libraries'
``pow`` and ``sqrt`` do not, so results agree with the reference to
rounding, not bit for bit.

The reference's size rule decides what runs only when a lane needs it: for
``n <= 4`` with dense algebra the refactorization and the Jacobian refresh
run unconditionally (cheaper than a sync), above that and with any
structured solver behind a host check, as the breakdown reset for
``n > 4``; the Newton and sensitivity iterations are unrolled for ``n <=
16`` and stop early once every lane is done above that.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from sunode_torch import forward_ad
from sunode_torch.ops.bdf import (
    KD,
    MAX_CONSECUTIVE_FAILS,
    MAX_FACTOR,
    MAX_ORDER,
    MIN_FACTOR,
    NEWTON_MAXITER,
    SENS_MAXITER,
    STATUS,
    THRESH,
    BDFOptions,
    BDFResult,
    RootRecord,
    _batched_roots,
    _grid_columns,
    _order_constants,
    _root_scan,
    _root_setup,
    newton_tol_for,
)
from sunode_torch.ops._recording import (
    fdot,
    finalize_saved_batched,
    init_saved_batched,
    pad_column,
    record_step_batched,
)
from sunode_torch.ops.linsolve import newton_linear_solver

__all__ = ["bdf_solve_batched"]

K = MAX_ORDER + 1  # rows the rescale acts on


class _Grid:
    """Index and coefficient tensors of one solve, made once on its device."""

    def __init__(self, dtype, device):
        f_kw = dict(dtype=dtype, device=device)
        self.ar_KD = torch.arange(KD, device=device)[:, None]  # (KD, 1)
        self.j_K = torch.arange(K, **f_kw)[:, None]  # (K, 1)
        self.eye_K = torch.eye(K, **f_kw)[:, :, None]
        self.U = self.rescale(torch.ones((1,), **f_kw))  # (K, K, 1)

    def rescale(self, factor: torch.Tensor) -> torch.Tensor:
        """``R[i, j] = prod_{m=1..i} (m - 1 - factor j) / m`` as ``(K, K, B)``,
        the running product ``R[i] = R[i-1] (i - 1 - factor j) / i`` rounded
        as ``sunode_tpu/ops/bdf_batched.py::_build_R_elems`` rounds it."""
        fj = factor[None, :] * self.j_K  # (K, B)
        rows = [torch.ones_like(fj)]
        for i in range(1, K):
            rows.append(rows[-1] * ((i - 1) - fj) / i)
        return torch.stack(rows)


def _seq_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis accumulated in order, as the reference's
    unrolled sums: ``cumsum`` over an outer axis is a sequential loop per
    element on either device."""
    return terms.cumsum(0)[-1]


def _contract(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum_j M[j, i] X[j]`` for ``M (K, K, B)``, ``X (K, nt, B)``,
    accumulated ``j = 0..K-1`` in sequence."""
    return _seq_sum(M[:, :, None, :] * X[:, None])


def _apply_RU(grid: _Grid, in_q, factor, D):
    """The lazy rescale: the leading K rows become ``U^T (R^T D[:K])``, with R
    and U the identity outside each lane's leading (q+1) block."""
    in_block = in_q[:K, None, :] & in_q[None, :K, :]
    R = torch.where(in_block, grid.rescale(factor), grid.eye_K)
    U = torch.where(in_block, grid.U, grid.eye_K)
    return torch.cat([_contract(U, _contract(R, D[:K])), D[K:]])


def _gather_rows(D: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane rows: ``D (R, nt, B)``, ``idx (m, B)`` -> ``(m, nt, B)``."""
    return D.gather(0, idx[:, None, :].expand(-1, D.shape[1], -1))


def _suffix_sums(D):
    """``S[i] = sum_{j >= i} D[j]`` as ``(KD + 1, nt, B)`` with ``S[KD] = 0``,
    summed from the last row down (a sequential ``cumsum``)."""
    return torch.cat([D.flip(0).cumsum(0).flip(0), torch.zeros_like(D[:1])])


def _predict(D, S, Sq1, in_q, gamma_kd, inv_alpha):
    """``(pred, psi)``, each ``(nt, B)``: ``pred = S[0] - S[q+1]`` and
    ``psi = sum_{1<=i<=q} gamma[i] D[i] / alpha[q]``, summed in row order."""
    w = torch.where(in_q[1:K], gamma_kd[1:K], 0.0)  # (K-1, B)
    return S[0] - Sq1[0], _seq_sum(w[:, None, :] * D[1:K]) * inv_alpha


def _update_D(D, S, Sq1, in_q, ar_KD, q, d):
    """Accepted-step difference update:
      i <= q   : D_new[i] = sum_{j=i..q} D[j] + d = S[i] - S[q+1] + d
      i == q+1 : d
      i == q+2 : d - D[q+1]
      i >  q+2 : unchanged
    """
    Dq1 = _gather_rows(D, (q + 1)[None])
    ar, qb = ar_KD[:, :, None], q[None, None, :]
    return torch.where(
        in_q[:, None, :],
        S[:KD] - Sq1 + d,
        torch.where(ar == qb + 1, d, torch.where(ar == qb + 2, d - Dq1, D)),
    )


def _interpolate(D, in_q, t_n, h, t_eval):
    """Dense output at per-lane ``t_eval (B,)``: ``(nt, B)``, the weights'
    running product and the sum in the reference's order."""
    s = (t_eval - t_n) / h
    ws = [torch.ones_like(s)]
    for i in range(1, MAX_ORDER + 1):
        ws.append(ws[-1] * (s + i - 1) / i)
    w = torch.where(in_q[1 : MAX_ORDER + 1], torch.stack(ws[1:]), 0.0)  # (5, B)
    return _seq_sum(torch.cat([D[:1], w[:, None, :] * D[1 : MAX_ORDER + 1]]))


def _breakdown_reset(active, accept, err_reject, consec_err_fails):
    """Lanes whose history resets this attempt: an error-test failure that
    makes four in a row (the breakdown detector)."""
    return active & ~accept & err_reject & (consec_err_fails + 1 >= 4)


def bdf_solve_batched(
    rhs: Callable,
    jac: Callable,
    t0,
    y0: torch.Tensor,  # (B, n)
    params: torch.Tensor,  # (B, n_p)
    tvals: torch.Tensor,  # (n_t,) shared or (B, n_t) per-lane grids
    options: BDFOptions = BDFOptions(),
    *,
    sens_rhs: Optional[Callable] = None,
    S0: Optional[torch.Tensor] = None,  # (B, k, n)
    quad_rhs: Optional[Callable] = None,
    quad0: Optional[torch.Tensor] = None,  # (B, m)
    first_step: Optional[Any] = None,  # (B,) or scalar; <= 0 -> automatic
    batched_fns: bool = False,
    jac_prod: Optional[Callable] = None,
    root_fn: Optional[Callable] = None,
    root_cap: int = 8,
    root_terminal: bool = True,
    root_directions: Optional[Any] = None,
) -> BDFResult:
    """Batched BDF solve; outputs leading-batch: ``ys (B, n_t, n)``,
    ``sens (B, n_t, k, n)``, ``quad (B, n_t, m)``.  With
    ``options.save_steps > 0``, ``saved`` is the recorded trajectory,
    trailing-batch (see :func:`~sunode_torch.ops._recording.finalize_saved_batched`)
    and ``stats['checkpoint_thinning_levels']`` its thinning; else None.

    ``rhs(t, y, p)``, ``jac`` (``-> (n, n)``), ``sens_rhs(t, y, S, p)``
    (``S (k, n)``) and ``quad_rhs`` take one lane unless ``batched_fns``,
    where they take ``t (B,)``, ``y (n, B)``, ``S (k, n, B)``, ``p (n_p, B)``
    and return the lane axis last.

    ``options.sens_staggered`` runs the sensitivities as CVODES's
    ``CV_STAGGERED``: a lane's sensitivity corrector runs only after its
    state has converged and passed its own error test, with the state's
    factored Newton matrix.  ``root_fn(t, y, p) -> (nrt,)`` (one lane, or
    batched with ``batched_fns``) turns on rootfinding on the dense output:
    with ``root_terminal`` a lane stops at its first root with status
    ROOT_RETURN; else up to ``root_cap`` roots a lane are recorded and
    ``stats['n_roots']`` counts on past the cap.  ``root_directions`` (0
    both, +1 rising, -1 falling, per component) filters the crossings.  The
    roots are ``stats['roots_t']`` (B, cap), ``['roots_y']`` (B, cap, n) and
    ``['roots_found']`` (B, cap, nrt), as in the reference.  ``tvals (B,
    n_t)`` gives each lane its own ascending grid (a ragged one padded with
    copies of its last time), ending the lane at its own last time.

    ``options.linear_solver`` 'band' (``jac`` returns banded storage ``(l+u+1,
    n)``, ``band_lower``/``band_upper``), 'sparse' (``jac`` returns a
    ``SparsePlan``'s packed storage in its permuted coordinates,
    ``sparse_perm``, ``sparse_border``) or 'spgmr' (no ``jac``: GMRES of
    depth ``krylov_dim`` on ``jac_prod(t, y, v, p) -> J v``, by default a
    ``torch.func.jvp`` of ``rhs``) replace the dense Newton solve
    (:mod:`sunode_torch.ops.linsolve`); ``stats['n_linear_factors']`` and
    ``['n_linear_solves']`` count the lockstep factorizations and solves;
    another ``linear_solver`` raises ``NotImplementedError``."""
    use_spgmr = options.linear_solver == "spgmr"
    with_sens = sens_rhs is not None
    with_quad = quad_rhs is not None
    staggered = with_sens and bool(options.sens_staggered)
    y0 = torch.as_tensor(y0)
    device = y0.device
    dtype = torch.promote_types(y0.dtype, torch.float32)
    f_kw = dict(dtype=dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    y0 = y0.to(dtype).T.contiguous()  # (n, B)
    n, B = y0.shape
    # t0 may be per-lane (B,): lanes resuming an interrupted solve
    t0 = torch.broadcast_to(torch.as_tensor(t0, **f_kw), (B,)).contiguous()
    tvals = torch.as_tensor(tvals, **f_kw)
    # the grid as (n_t, B) columns, one a lane, and each lane's last time
    tvals_tb = _grid_columns("bdf_solve_batched", tvals, B)
    n_t = tvals_tb.shape[0]
    t_end = tvals_tb[-1]
    params = torch.as_tensor(params, **f_kw).T.contiguous()  # (n_p, B)

    k_sens = S0.shape[1] if with_sens else 0
    m_quad = quad0.shape[1] if with_quad else 0
    n_S = k_sens * n
    sl_S = slice(n, n + n_S)
    sl_Q = slice(n + n_S, n + n_S + m_quad)

    jac_prod_b = None
    if batched_fns:
        rhs_b, jac_b, sens_rhs_b, quad_rhs_b = rhs, jac, sens_rhs, quad_rhs
        jac_prod_b = jac_prod
    else:
        vmap = torch.func.vmap
        rhs_b = vmap(rhs, in_dims=(0, 1, 1), out_dims=1)
        if not use_spgmr:
            jac_b = vmap(jac, in_dims=(0, 1, 1), out_dims=2)
        if with_sens:
            sens_rhs_b = vmap(sens_rhs, in_dims=(0, 1, 2, 1), out_dims=2)
        if with_quad:
            quad_rhs_b = vmap(quad_rhs, in_dims=(0, 1, 1), out_dims=1)
        if jac_prod is not None:
            jac_prod_b = vmap(jac_prod, in_dims=(0, 1, 1, 1), out_dims=1)
    if use_spgmr and jac_prod_b is None:
        # each lane's tangent is its own column: one jvp of the batched rhs
        def jac_prod_b(t, y, v, p):
            return forward_ad.jvp(lambda y_: rhs_b(t, y_, p), (y,), (v,))[1]

    lin = newton_linear_solver(options, n, jac_prod_b)

    def jac_full(t, y, p):  # generated Jacobians may leave constant entries unbatched
        return torch.broadcast_to(jac_b(t, y, p), lin.jac_shape() + (B,))

    def fz_at(t, y, S, p):
        """Combined derivative ``[f | vec dS/dt | g]`` at the state ``y``."""
        parts = [rhs_b(t, y, p)]
        if with_sens:
            parts.append(sens_rhs_b(t, y, S, p).reshape(n_S, B))
        if with_quad:
            parts.append(quad_rhs_b(t, y, p))
        return torch.cat(parts)

    # scalar or per-state (n,) vector rtol; heuristics use the tightest
    rtol = torch.broadcast_to(torch.as_tensor(options.rtol, **f_kw), (n,))
    rtol_s = rtol.min()
    atol = torch.broadcast_to(torch.as_tensor(options.atol, **f_kw), (n,))
    gamma, alpha, error_const = _order_constants(options.use_ndf, dtype, device)
    max_order = min(options.max_order, MAX_ORDER)

    # combined tolerance and error-weight vectors over z
    n_blocks = 1 + (k_sens if (with_sens and options.sens_err_con) else 0) + (
        1 if (with_quad and options.quad_err_con) else 0
    )
    atol_parts, rtol_parts = [atol], [rtol]
    v_parts = [torch.full((n,), 1.0 / (n * n_blocks), **f_kw)]
    if with_sens:
        pbar = (
            torch.broadcast_to(torch.as_tensor(options.sens_pbar, **f_kw), (k_sens,))
            if options.sens_pbar is not None
            else torch.ones((k_sens,), **f_kw)
        )
        atol_parts.append((atol[None, :] / pbar[:, None]).reshape(-1))
        rtol_parts.append(rtol.repeat(k_sens))
        v_parts.append(torch.full(
            (n_S,), (1.0 / (n * n_blocks)) if options.sens_err_con else 0.0, **f_kw
        ))
    if with_quad:
        quad_rtol = (
            torch.as_tensor(options.quad_rtol, **f_kw)
            if options.quad_rtol is not None
            else rtol_s
        )
        atol_parts.append(torch.broadcast_to(
            torch.as_tensor(
                options.quad_atol if options.quad_atol is not None else options.atol, **f_kw
            ),
            (m_quad,),
        ))
        rtol_parts.append(torch.broadcast_to(quad_rtol, (m_quad,)))
        v_parts.append(torch.full(
            (m_quad,), (1.0 / (m_quad * n_blocks)) if options.quad_err_con else 0.0, **f_kw
        ))
    atol_z = torch.cat(atol_parts)[:, None]
    rtol_z = torch.cat(rtol_parts)[:, None]
    v_err = torch.cat(v_parts)[:, None]

    if options.constraints is not None:
        constraints = torch.broadcast_to(
            torch.as_tensor(options.constraints, **f_kw), (n,)
        )[:, None]
    else:
        constraints = None

    newton_tol = newton_tol_for(options, float(rtol_s), dtype)
    eps = torch.finfo(dtype).eps

    with_roots = root_fn is not None
    if with_roots:
        root_b = _batched_roots(root_fn, batched_fns, dtype)
        g_init, rdir, root_cap = _root_setup(root_b, t0, y0, params, root_cap, root_directions)
        roots = RootRecord(g_init, n, root_cap)

    f0 = rhs_b(t0, y0, params)
    bad_init = ~(torch.isfinite(y0).all(dim=0) & torch.isfinite(f0).all(dim=0))

    # Hairer-Wanner initial step per lane
    w0 = 1.0 / (atol[:, None] + rtol[:, None] * torch.abs(y0))
    d0n = torch.sqrt(torch.mean((y0 * w0) ** 2, dim=0))
    d1n = torch.sqrt(torch.mean((f0 * w0) ** 2, dim=0))
    h0a = torch.where((d0n < 1e-5) | (d1n < 1e-5), 1e-6, 0.01 * d0n / d1n)
    h0a = torch.minimum(h0a, 0.5 * (t_end - t0))
    f1 = rhs_b(t0 + h0a, y0 + h0a[None, :] * f0, params)
    d2n = torch.sqrt(torch.mean(((f1 - f0) * w0) ** 2, dim=0)) / h0a
    dmn = torch.maximum(d1n, d2n)
    # a true division: torch computes ``0.01 / dmn`` as ``reciprocal(dmn) * 0.01``
    h1a = torch.where(
        dmn <= 1e-15, torch.clamp(h0a * 1e-3, min=1e-6),
        torch.sqrt(torch.full_like(dmn, 0.01) / dmn),
    )
    h_auto = torch.minimum(torch.minimum(100 * h0a, h1a), t_end - t0)
    h_auto = torch.clamp(h_auto, max=options.max_step)
    if first_step is not None:
        fs = torch.broadcast_to(torch.as_tensor(first_step, **f_kw), (B,))
        h0 = torch.where(fs > 0, torch.minimum(fs, t_end - t0), h_auto)
    elif options.first_step is not None:
        h0 = torch.full((B,), options.first_step, **f_kw)
    else:
        h0 = h_auto
    h0 = torch.clamp(h0, min=1e-12)
    # extreme params overflow the WRMS norms (inf/inf -> NaN h0); a NaN h
    # defeats every `h < h_min` guard -- fall back to a small finite h so the
    # lane dies through underflow instead
    h0 = torch.where(torch.isfinite(h0), h0, 1e-6)

    z_parts = [y0]
    if with_sens:
        S0_t = torch.as_tensor(S0, **f_kw).permute(1, 2, 0)  # (k, n, B)
        z_parts.append(S0_t.reshape(n_S, B))
    if with_quad:
        z_parts.append(torch.as_tensor(quad0, **f_kw).T)
    z0 = torch.cat(z_parts)
    nt_tot = z0.shape[0]
    D0 = torch.zeros((KD, nt_tot, B), **f_kw)
    D0[0] = z0
    D0[1] = h0[None, :] * fz_at(t0, y0, S0_t if with_sens else None, params)

    zs = torch.full((n_t, nt_tot, B), float("nan"), **f_kw)
    emit_mask0 = tvals_tb <= t0[None, :]  # (n_t, B), each lane on its own grid
    zs = torch.where(emit_mask0[:, None, :], z0[None], zs)

    grid = _Grid(dtype, device)
    # matrix-free spgmr: no Jacobian, no factors
    J0 = torch.zeros((1, 1, B), **f_kw) if use_spgmr else jac_full(t0, y0, params)

    save_steps = int(options.save_steps)
    thinning = bool(options.checkpoint_thinning)
    rec_fd = save_steps > 0 and options.hermite_order == 5

    def record_row(t, y, f, J):
        """``(t, y, f[, fdot, L])`` as ``(W, B)``: quintic rows add the total
        derivative of f and a Lipschitz scale of the Newton's current J
        (``lin.lip_norm``) for the evaluator's stiffness gate."""
        parts = [t[None, :], y, f]
        if rec_fd:
            parts += [fdot(rhs_b, t, y, f, params), lin.lip_norm(J)[None]]
        return torch.cat(parts)

    if save_steps > 0:
        row0 = record_row(t0, y0, f0, J0)
        saved = init_saved_batched(row0, save_steps, thinning)
        pad_row = pad_column(row0.shape[0], row0)
    gamma_kd = torch.cat([gamma, gamma.new_zeros(KD - K)])[:, None]
    zeros_i = torch.zeros((B,), **i32)
    false_b = torch.zeros((B,), dtype=torch.bool, device=device)
    inf_b = torch.full((B,), float("inf"), **f_kw)

    c = dict(
        t=t0,
        h=h0,
        h_D=h0,
        q=torch.ones((B,), dtype=torch.long, device=device),
        D=D0,
        n_equal=zeros_i,
        J=J0,
        J_current=torch.ones((B,), dtype=torch.bool, device=device),
        factors=None if use_spgmr else lin.identity(J0),
        c_factored=torch.zeros((B,), **f_kw),
        need_factor=torch.ones((B,), dtype=torch.bool, device=device),
        i_out=emit_mask0.sum(dim=0),
        status=torch.where(bad_init, STATUS["BAD_INIT"], -1).to(torch.int32),
        consec_err_fails=zeros_i,
        consec_conv_fails=zeros_i,
        nsteps=zeros_i,
        nfev=torch.full((B,), 2, **i32),
        njev=torch.ones((B,), **i32),
        nfactor=zeros_i,
        nniters=zeros_i,
        nfevS=torch.full((B,), 1 if with_sens else 0, **i32),
        n_err_fails=zeros_i,
        n_conv_fails=zeros_i,
        # per-lane post-mortem snapshot of the fatal attempt
        pm_t=torch.full((B,), float("nan"), **f_kw),
        pm_h=torch.full((B,), float("nan"), **f_kw),
        pm_q=torch.full((B,), -1, **i32),
        pm_worst=torch.full((B,), -1, **i32),
    )
    it = 0

    while True:
        active = (c["status"] == -1) & (c["i_out"] < n_t)
        if not bool(active.any()):
            break
        t, q = c["t"], c["q"]
        qf = q.to(dtype)

        h_min_loc = 10 * eps * torch.maximum(torch.abs(t), torch.abs(t_end))
        # NaN-robust form: non-finite h terminates the lane
        underflow = active & ~(c["h"] >= torch.clamp(h_min_loc, min=options.min_step))
        h_use = torch.where(active, torch.minimum(c["h"], t_end - t), c["h"])
        t_new = t + h_use

        # single lazy rescale to the desired spacing
        in_q = grid.ar_KD <= q[None, :]  # (KD, B): rows 0..q of each lane
        D = _apply_RU(grid, in_q, h_use / torch.clamp(c["h_D"], min=1e-300), c["D"])

        alpha_q = alpha[q]
        c_coef = h_use / alpha_q
        c_changed = (
            torch.abs(c_coef / torch.where(c["c_factored"] == 0, 1.0, c["c_factored"]) - 1.0)
            > 1e-12
        )
        need = active & (c["need_factor"] | c_changed)
        factors, c_factored, nfactor = c["factors"], c["c_factored"], c["nfactor"]
        if use_spgmr:
            # matrix-free: nothing to factor (linearised per attempt below)
            c_factored = c_coef
        # tiny dense systems: refactoring every lane is cheaper than a sync
        elif lin.always or bool(need.any()):
            factors = lin.factor(c["J"], c_coef).where(need, factors)
            c_factored = torch.where(need, c_coef, c_factored)
            nfactor = nfactor + need.to(torch.int32)

        S_D = _suffix_sums(D)
        Sq1 = _gather_rows(S_D, (q + 1)[None])  # (1, nt, B)
        z_pred, psi_z = _predict(D, S_D, Sq1, in_q, gamma_kd, 1.0 / alpha_q)
        w_z = 1.0 / (atol_z + rtol_z * torch.abs(z_pred))
        y_pred, w_y, psi_y = z_pred[:n], w_z[:n], psi_z[:n]
        pred_ok = torch.isfinite(z_pred).all(dim=0)
        if use_spgmr:
            # (I - c J) x = b linearised at the predictor, as CVODES's
            # difference-quotient jtimes freezes ycur
            lin_solve = lin.linearized(t_new, y_pred, c_coef, params)
        else:
            lin_solve = lambda res: lin.solve(factors, res)  # noqa: E731

        # ---- Newton on the y block (per-lane masked; shared loop) ---------
        y, d_corr, dy_old = y_pred, torch.zeros_like(y_pred), inf_b
        n_conv, n_div, n_bad, n_iters = ~active, false_b, false_b, zeros_i
        for k in range(NEWTON_MAXITER):
            live = ~(n_conv | n_div | n_bad)  # lanes still iterating
            # large n: stop once every lane is done (each iteration is a solve)
            if n > 16 and not bool(live.any()):
                break
            f = rhs_b(t_new, y, params)
            bad_f = ~torch.isfinite(f).all(dim=0)
            delta = lin_solve(c_coef[None, :] * f - psi_y - d_corr)
            bad_d = ~torch.isfinite(delta).all(dim=0)
            dy_norm = torch.sqrt(torch.mean((delta * w_y) ** 2, dim=0))
            rate = dy_norm / dy_old
            d_corr = torch.where(live[None, :], d_corr + delta, d_corr)
            y = torch.where(live[None, :], y + delta, y)
            conv_new = dy_norm == 0.0
            if k > 0:
                div_new = (rate >= 2.0) | (
                    (rate < 1.0)
                    & (rate ** (NEWTON_MAXITER - k) / (1 - rate) * dy_norm > newton_tol)
                )
                conv_new = conv_new | ((rate < 1.0) & (rate / (1 - rate) * dy_norm < newton_tol))
            n_bad = n_bad | (live & (bad_f | bad_d))
            n_conv = n_conv | (live & conv_new & ~n_bad)
            if k > 0:
                n_div = n_div | (live & div_new & ~conv_new)
            n_iters = n_iters + live.to(torch.int32)
            dy_old = torch.where(live, dy_norm, dy_old)
        y_new = y
        conv = n_conv & ~n_bad & pred_ok

        d_parts = [d_corr]
        nfevS_n = zeros_i
        if with_sens:
            if staggered:
                # CV_STAGGERED: a lane's state must converge and pass its own
                # error test before any sensitivity work; the corrector below
                # holds the other lanes converged (for n > 16 its first sync
                # skips it when no lane is gated in, as the reference's cond)
                err_y_only = torch.sqrt(
                    torch.mean(((error_const[q][None, :] * d_corr) * w_y) ** 2, dim=0)
                )
                state_err_ok = conv & (err_y_only <= 1.0)
                sens_gate = active & state_err_ok
            else:
                # simultaneous corrector: every active lane, after the state's
                sens_gate = active
            S = z_pred[sl_S].reshape(k_sens, n, B)
            psi_S = psi_z[sl_S].reshape(k_sens, n, B)
            wS = w_z[sl_S].reshape(k_sens, n, B)
            dS, old = torch.zeros_like(S), inf_b
            s_conv, s_bad = ~sens_gate, false_b
            for it_s in range(SENS_MAXITER):
                live = ~(s_conv | s_bad)
                if n > 16 and not bool(live.any()):
                    break
                FS = sens_rhs_b(t_new, y_new, S, params)
                deltaS = lin_solve(c_coef[None, None, :] * FS - psi_S - dS)
                bad_new = ~torch.isfinite(deltaS).all(dim=1).all(dim=0)
                norm = torch.sqrt(torch.mean((deltaS * wS) ** 2, dim=(0, 1)))
                rate = norm / old
                S = torch.where(live[None, None, :], S + deltaS, S)
                dS = torch.where(live[None, None, :], dS + deltaS, dS)
                conv_new = (norm == 0.0) | (norm < 0.1 * newton_tol)
                if it_s > 0:
                    conv_new = conv_new | (
                        (rate < 1.0) & (rate / (1 - rate) * norm < newton_tol)
                    )
                s_bad = s_bad | (live & bad_new)
                s_conv = s_conv | (live & conv_new & ~s_bad)
                nfevS_n = nfevS_n + live.to(torch.int32)
                old = torch.where(live, norm, old)
            if staggered:
                # a gated-off corrector must not mask the state's rejection
                conv = conv & ((s_conv & ~s_bad) | ~state_err_ok)
                dS = torch.where(state_err_ok[None, None, :], dS, 0.0)
            else:
                conv = conv & s_conv & ~s_bad
            d_parts.append(dS.reshape(n_S, B))
        if with_quad:
            dQ_corr = c_coef[None, :] * quad_rhs_b(t_new, y_new, params) - psi_z[sl_Q]
            conv = conv & torch.isfinite(dQ_corr).all(dim=0)
            d_parts.append(dQ_corr)
        d_z = torch.cat(d_parts)

        if constraints is not None:
            cns = constraints
            viol = (
                ((cns == 1) & (y_new < 0))
                | ((cns == -1) & (y_new > 0))
                | ((cns == 2) & (y_new <= 0))
                | ((cns == -2) & (y_new >= 0))
            )
            constraint_fail = viol.any(dim=0)
        else:
            constraint_fail = false_b

        newton_failed = active & ~conv
        # spgmr's linearisation is always fresh: a Newton failure goes
        # straight to a step reduction
        refresh_J = false_b if use_spgmr else newton_failed & ~c["J_current"]
        halve = newton_failed & (c["J_current"] | use_spgmr)
        J_new = c["J"]
        # cheap for tiny dense systems; no sync
        if not use_spgmr and (lin.always or bool(refresh_J.any())):
            J_new = torch.where(refresh_J[None, None, :], jac_full(t_new, y_pred, params), J_new)
        njev = c["njev"] + refresh_J.to(torch.int32)

        D_upd = _update_D(D, S_D, Sq1, in_q, grid.ar_KD, q, d_z)

        # the error test and the order-selection errors in one reduction
        rows = _gather_rows(D_upd, torch.stack([q, q + 2]))  # (2, nt, B)
        ec = error_const[
            torch.stack([q, torch.clamp(q - 1, min=0), torch.clamp(q + 1, max=MAX_ORDER)])
        ]  # (3, B)
        err_rows = ec[:, None, :] * torch.cat([d_z[None], rows])  # (3, nt, B)
        err3 = torch.sqrt(torch.sum((err_rows * w_z[None]) ** 2 * v_err[None], dim=1))
        err_norm_tot = err3[0]
        if staggered:
            # the state's own error test gates acceptance, and the step
            # reduction sees the state's failure too (a gated-off corrector
            # left the sensitivity rows of d_z zero)
            err_norm_tot = torch.maximum(err_norm_tot, err_y_only)
            err_ok = (err_norm_tot <= 1.0) & state_err_ok
        else:
            err_ok = err_norm_tot <= 1.0
        accept = active & conv & err_ok & ~constraint_fail
        err_reject = active & conv & (~err_ok | constraint_fail)
        n_equal = torch.where(accept, c["n_equal"] + 1, 0)
        t_next = torch.where(accept, t_new, t)

        # ---- rootfinding on the dense output of the accepted step ----------
        t_stop = None
        if with_roots:
            D_y = D_upd[:, :n]
            root_hit, t_root, dirs, y_root, g_new = _root_scan(
                root_b, params, rdir, roots.g_prev, t, t_new, h_use, y_new,
                lambda tt: _interpolate(D_y, in_q, t_new, h_use, tt), accept,
            )
            roots.update(accept, root_hit, t_root, dirs, y_root, g_new)
            if root_terminal:
                t_stop = t_root  # inf where no root was hit

        # ---- emission (shared loop; per-lane masks) -----------------------
        i_out = c["i_out"]
        while True:
            idx = torch.clamp(i_out, max=n_t - 1)
            te = tvals_tb.gather(0, idx[None, :].long())[0]  # each lane's next time
            pend = accept & (i_out < n_t) & (te <= t_new + 1e-14 * torch.abs(t_new))
            if t_stop is not None:
                pend = pend & (te <= t_stop)
            if not bool(pend.any()):
                break
            zi = _interpolate(D_upd, in_q, t_new, h_use, te)  # (nt, B)
            gidx = idx[None, None, :].expand(1, nt_tot, B)
            row = zs.gather(0, gidx)
            zs.scatter_(0, gidx, torch.where(pend[None, None, :], zi[None], row))
            i_out = i_out + pend.to(i_out.dtype)

        # ---- checkpoint recording (see ops/_recording.py) -----------------
        if save_steps > 0:
            f_acc = rhs_b(t_new, y_new, params)
            row = torch.where(accept[None, :], record_row(t_new, y_new, f_acc, c["J"]), pad_row)
            saved = record_step_batched(saved, it, accept, row, save_steps, thinning)

        # ---- order & step adaptation --------------------------------------
        can_adapt = n_equal >= q + 1
        err_m = torch.where(q > 1, err3[1], float("inf"))
        err_p = torch.where(q < max_order, err3[2], float("inf"))

        def fac(e, qq):
            unavailable = ~torch.isfinite(e)
            e_safe = torch.clamp(e, 1e-30, 1e30)
            return torch.where(unavailable, 0.0, 0.9 * e_safe ** (-1.0 / (qq + 1.0)))

        facs = torch.stack([fac(err_m, qf - 1), fac(err_norm_tot, qf), fac(err_p, qf + 1)])
        best = torch.argmax(facs, dim=0)
        dq = best - 1
        factor_best = torch.clamp(facs.gather(0, best[None, :])[0], MIN_FACTOR, MAX_FACTOR)
        do_change = can_adapt & ((factor_best >= THRESH) | (factor_best < 1.0) | (dq != 0))
        q_acc = torch.where(do_change, torch.clamp(q + dq, 1, max_order), q)
        factor_acc = torch.where(do_change, factor_best, 1.0)
        factor_acc = torch.minimum(
            factor_acc, options.max_step / torch.clamp(h_use, min=1e-300)
        )
        n_equal = torch.where(do_change & accept, 0, n_equal)

        factor_rej = torch.clamp(
            0.9 * torch.clamp(err_norm_tot, 1e-30, 1e30) ** (-1.0 / (qf + 1.0)),
            MIN_FACTOR,
            0.9,
        )
        factor_rej = torch.where(constraint_fail & err_ok, 0.25, factor_rej)
        factor_fail = torch.where(refresh_J, 1.0, torch.where(halve, 0.5, factor_rej))

        # breakdown detector: marginal accepts keep the failure counter; 4
        # accumulated failures reset the lane's history (y and the first
        # difference only) and restart it at order 1
        reset = _breakdown_reset(active, accept, err_reject, c["consec_err_fails"])
        factor_next = torch.where(accept, factor_acc, torch.where(reset, 0.25, factor_fail))
        h_next = torch.where(active, h_use * factor_next, c["h"])
        q_next = torch.where(accept, q_acc, torch.where(reset, 1, q))
        D_next = torch.where(accept[None, None, :], D_upd, D)
        if n <= 4 or bool(reset.any()):  # cheap for tiny systems; no sync
            # D[1] = h * dz/dt at the last accepted point (keeping a possibly
            # corrupted D[1] leaves an h-independent error estimate)
            z_last = D[0]
            fz_last = fz_at(
                t, z_last[:n],
                z_last[sl_S].reshape(k_sens, n, B) if with_sens else None, params,
            )
            D_reset = D * (grid.ar_KD == 0).to(dtype)[:, :, None]
            D_reset[1] = h_use[None, :] * fz_last
            D_next = torch.where(reset[None, None, :], D_reset, D_next)
        D_next = torch.where(active[None, None, :], D_next, c["D"])

        cef = torch.where(
            accept,
            torch.where(
                err_norm_tot <= 0.9,
                torch.clamp(c["consec_err_fails"] - 1, min=0),
                c["consec_err_fails"],
            ),
            torch.where(reset, 0, c["consec_err_fails"] + err_reject.to(torch.int32)),
        )
        conv_fail = newton_failed & ~refresh_J
        ccf = torch.where(accept, 0, c["consec_conv_fails"] + conv_fail.to(torch.int32))
        too_many = (cef >= MAX_CONSECUTIVE_FAILS) | (ccf >= MAX_CONSECUTIVE_FAILS)

        status = c["status"]
        status = torch.where(
            (status == -1) & active & too_many & ~accept, STATUS["REPEATED_FAILURES"], status
        )
        nsteps = c["nsteps"] + accept.to(torch.int32)
        status = torch.where(
            (status == -1) & active & (nsteps >= options.max_steps), STATUS["MAX_STEPS"], status
        )
        status = torch.where((status == -1) & underflow, STATUS["STEP_UNDERFLOW"], status)
        root_ret_now = false_b
        if with_roots and root_terminal:
            root_ret_now = (status == -1) & root_hit
            status = torch.where(root_ret_now, STATUS["ROOT_RETURN"], status)

        # per-lane post-mortem: snapshot (t, attempted h, order, worst state)
        # on the attempt where a lane's status turns fatal
        fatal_now = (c["status"] == -1) & (status != -1) & ~root_ret_now
        e_err = torch.abs(ec[0][None, :] * d_z[:n]) * w_y
        e_newt = torch.abs(d_corr) * w_y
        worst = torch.argmax(torch.where(n_conv[None, :], e_err, e_newt), dim=0)

        c = dict(
            t=t_next,
            h=h_next,
            h_D=torch.where(active, h_use, c["h_D"]),
            q=q_next,
            D=D_next,
            n_equal=n_equal.to(torch.int32),
            J=J_new,
            J_current=torch.where(accept, False, c["J_current"] | refresh_J),
            factors=factors,
            c_factored=c_factored,
            need_factor=torch.where(accept, False, refresh_J),
            i_out=i_out,
            status=status.to(torch.int32),
            consec_err_fails=cef.to(torch.int32),
            consec_conv_fails=ccf.to(torch.int32),
            nsteps=nsteps,
            nfev=c["nfev"] + n_iters + (accept.to(torch.int32) if save_steps > 0 else 0),
            njev=njev,
            nfactor=nfactor,
            nniters=c["nniters"] + n_iters,
            nfevS=c["nfevS"] + nfevS_n,
            n_err_fails=c["n_err_fails"] + err_reject.to(torch.int32),
            n_conv_fails=c["n_conv_fails"] + conv_fail.to(torch.int32),
            pm_t=torch.where(fatal_now, t, c["pm_t"]),
            pm_h=torch.where(fatal_now, h_use, c["pm_h"]),
            pm_q=torch.where(fatal_now, q.to(torch.int32), c["pm_q"]),
            pm_worst=torch.where(fatal_now, worst.to(torch.int32), c["pm_worst"]),
        )
        it += 1

    status = torch.where(c["status"] == -1, STATUS["SUCCESS"], c["status"]).to(torch.int32)
    stats = dict(
        n_steps=c["nsteps"],
        n_rhs_evals=c["nfev"],
        n_jac_evals=c["njev"],
        n_factorizations=c["nfactor"],
        n_newton_iters=c["nniters"],
        n_error_test_fails=c["n_err_fails"],
        n_conv_fails=c["n_conv_fails"],
        final_order=c["q"].to(torch.int32),
        final_step_size=c["h"],
        final_time=c["t"],
        # (B, n + k n + m) combined state at final_time
        final_state=c["D"][0].T,
        n_attempts=it,
        # lockstep calls of the Newton solver (host ints)
        n_linear_factors=lin.n_factors,
        n_linear_solves=lin.n_solves,
        # where each fatal lane died (NaN / -1 on success)
        error_time=c["pm_t"],
        error_step_size=c["pm_h"],
        error_order=c["pm_q"],
        error_worst_state=c["pm_worst"],
    )
    if with_sens:
        stats["n_sens_rhs_evals"] = c["nfevS"]
    if with_roots:
        stats.update(roots.stats())
    saved_out = None
    if save_steps > 0:
        # shared across lanes: the stride follows the shared attempt counter
        stats["checkpoint_thinning_levels"] = saved["shift"] if thinning else 0
        saved_out = finalize_saved_batched(saved, n, thinning)

    ys = zs[:, :n, :].permute(2, 0, 1)  # (B, n_t, n)
    sens = zs[:, sl_S, :].permute(2, 0, 1).reshape(B, n_t, k_sens, n) if with_sens else None
    quad = zs[:, sl_Q, :].permute(2, 0, 1) if with_quad else None
    return BDFResult(ys=ys, status=status, stats=stats, saved=saved_out, sens=sens, quad=quad)
