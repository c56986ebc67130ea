"""Batch-native Adams-Moulton integrator (non-stiff fast path), in PyTorch.

Port of ``sunode_tpu/ops/adams_batched.py::adams_solve_batched``: shared
``(n_t,)`` or per-lane ``(B, n_t)`` observation times (each lane emits on its
own ascending grid and ends at its own last time; a ragged grid is padded
with copies of its last time), scalar or per-state vector ``rtol``, the quadrature block
(``quad_rhs``/``quad0``, ``quad_err_con``), batched or per-lane right-hand
sides, step-size and order adaptation, the breakdown reset, NaN-poison
statuses, the per-lane post-mortem stats, and what the adjoint backward
passes need: state injections (``inject_times``/``inject_deltas``,
``options.inject_keep_order``), a per-attempt stage (``stage_fn``) and the
checkpoint recording (``save_steps``, see :mod:`sunode_torch.ops._recording`),
staggered forward sensitivities (``sens_rhs``/``sens0``, CVODES's
``CV_STAGGERED``) and rootfinding (``root_fn``, ``root_cap``,
``root_terminal``, ``root_directions``).

Layout: states are ``(rows, B)`` with the lane axis last, the history
``DF`` is ``(KAB, nz, B)``.  The lockstep loop is a host loop that ends when
no lane is active (one device sync per attempt, one more per emission
sweep).  Each attempt's history half -- the ``R(h/h_D)U`` rescale, the
predictor, corrector, final evaluation, difference update and the three
error-test rows -- runs in
:func:`sunode_torch.ops.adams_attempt.adams_history_attempt`: one CUDA
kernel launch on a GPU, its plain version on CPU tensors.  The scalar tail
of the attempt (acceptance, emission, order and step adaptation, status) is
torch tensor code written to round exactly like the JAX reference.

The stage enters the attempt as extra parameter rows, ``[params | stage]``,
so that the kernel, which loads each lane's parameter rows once, reads the
staged values there (``symode/cuda_codegen.py::staged_adjoint_system``).

With staggered sensitivities an attempt is two history attempts: the state
rows ``[y | q]`` first, then the sensitivity rows ``vec S`` on a history of
their own, ``DF_S (KAB, k n, B)``, with the state's converged ``y_new``
staged in the parameter rows after the problem's
(``cuda_codegen.staged_sensitivity_system``) and only the lanes whose state
converged and passed its own error test active.  The two error norms are
joined per lane as ``sqrt(a^2 + b^2)`` where the reference sums once over
``[y | q | S]``: the same value up to the last ulps of the norm.
(Simultaneous sensitivities are the augmented state ``[y | vec S]`` with
its own right-hand side, ``cuda_codegen.sensitivity_system``.)

The solve runs at the type of its inputs, float64 or float32 (at least
float32): every tensor of the loop, the history attempt's kernel build
included, has that type.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from sunode_torch.ops._recording import (
    fdot,
    finalize_saved_batched,
    init_saved_batched,
    pad_column,
    record_step_batched,
)
from sunode_torch.ops.adams import _C_INT, _GAMMA_STAR, FUNCTIONAL_MAXITER
from sunode_torch.ops.bdf import (
    MAX_CONSECUTIVE_FAILS,
    MAX_FACTOR,
    MIN_FACTOR,
    STATUS,
    THRESH,
    BDFOptions,
    BDFResult,
    RootRecord,
    _batched_roots,
    _grid_columns,
    _root_scan,
    _root_setup,
    newton_tol_for,
)
from sunode_torch.ops import adams_attempt
from sunode_torch.ops.adams_attempt import adams_history_attempt
from sunode_torch.ops.adams_split import adams_split_attempt_rows
from sunode_torch.convert import canonical_device
from sunode_torch.parallel.rows import RowBlocks, RowLayout, scatter
from sunode_torch.ops.pece_step import PeceSystem
from sunode_torch.symode.cuda_codegen import DeviceSystem

__all__ = ["adams_solve_batched"]


def adams_solve_batched(
    rhs: Callable,
    t0,
    y0: torch.Tensor,  # (B, n)
    params: torch.Tensor,  # (B, n_p)
    tvals: torch.Tensor,  # (n_t,) shared or (B, n_t) per-lane grids
    options: BDFOptions = BDFOptions(),
    *,
    quad_rhs: Optional[Callable] = None,
    quad0: Optional[torch.Tensor] = None,  # (B, m)
    batched_fns: bool = False,
    device_system: Optional[DeviceSystem] = None,
    sens_rhs: Optional[Callable] = None,  # (t, y, S (k, n), p) -> (k, n), staggered
    sens0: Optional[torch.Tensor] = None,  # (B, k, n)
    sens_device_system: Optional[DeviceSystem] = None,
    root_fn: Optional[Callable] = None,  # (t, y, p) -> (nrt,) event functions
    root_cap: int = 8,
    root_terminal: bool = True,
    root_directions: Optional[Any] = None,
    first_step: Optional[Any] = None,  # (B,) or scalar; <= 0 -> automatic
    inject_times: Optional[Any] = None,  # (n_e,) ascending, shared
    inject_deltas: Optional[torch.Tensor] = None,  # (n_e, n, B) added to y
    stage_fn: Optional[Callable] = None,  # t (B,) -> (n_s, B), once per attempt
    rows: Optional[RowLayout] = None,  # the state rows over devices: the state-split route
) -> BDFResult:
    """Batched Adams solve; outputs leading-batch: ``ys (B, n_t, n)``.

    ``rhs(t, y, p)`` and ``quad_rhs`` take one lane (``t`` scalar, ``y (n,)``)
    unless ``batched_fns``, where they take ``t (B,)``, ``y (n, B)`` and
    ``p (n_p, B)``; with ``stage_fn`` they take the stage as a fourth
    argument.  ``device_system`` is the combined ``[f | g]`` system emitted
    for the CUDA kernel (``symode/cuda_codegen.py``), whose parameter rows
    are ``[params | stage]`` with ``stage_fn``; a solve on CUDA tensors
    requires it.  ``first_step`` (scalar or ``(B,)``, a lane's ``t0`` may be
    its own too) overrides the first step where positive, clipped to the
    lane's span; elsewhere the automatic step (or ``options.first_step``
    when no override is given) as in the reference.

    At ``inject_times[k]`` each lane's step ends, ``inject_deltas[k]`` is
    added to its state and its history restarts (order 1 with
    ``f(z_injected)``, or, with ``options.inject_keep_order > 1``, the
    differences below it kept) at its working step size.  With
    ``options.save_steps > 0`` the accepted steps are recorded into
    ``result.saved`` and ``stats['checkpoint_thinning_levels']``.

    ``sens_rhs(t, y, S, p)`` (``S (k, n)``, or batched ``(k, n, B)``) with
    ``sens0 (B, k, n)`` runs staggered forward sensitivities to
    ``result.sens (B, n_t, k, n)``; ``sens_device_system`` is their emitted
    system (``cuda_codegen.staged_sensitivity_system``), required on CUDA
    tensors exactly when ``device_system`` is given.  ``root_fn`` turns on
    rootfinding as in :func:`sunode_torch.ops.bdf_batched.bdf_solve_batched`.
    Neither combines with injections or a stage, as in the reference.

    ``tvals (B, n_t)`` gives each lane its own ascending observation grid
    (pad a ragged one with copies of its last time): the lane ends at its
    own last time and emits where its own grid says.  It composes with
    sensitivities and roots, not with injections or a stage (the adjoint's
    machinery, whose observation times are shared).

    ``rows`` (a :class:`~sunode_torch.parallel.rows.RowLayout` of the ``n``
    state rows, its home device ``y0``'s) takes the state-split route:
    every array with a state-row axis (the history, the state, the
    tolerances and weights, the recording's rows, the observations) is kept
    as blocks of rows on the layout's devices, the quadrature rows on the
    home device after its block, and every attempt runs
    :func:`~sunode_torch.ops.adams_split.adams_split_attempt_rows`: the
    right-hand side on the home device on the gathered iterate, each lane's
    norms summed over the blocks in block order.  The lanes' quantities and
    every decision stay on the home device; ``ys`` and the final state are
    gathered there, and ``result.saved``'s row tables are
    :class:`~sunode_torch.parallel.rows.RowBlocks`.  It takes float64, a
    problem with no emitted system, shared observation times, injections, a
    stage and the recording; sensitivities, roots and constraints raise
    ``ValueError`` (ROADMAP A)."""
    with_sens, with_roots = sens_rhs is not None, root_fn is not None
    if (with_sens or with_roots) and (inject_times is not None or stage_fn is not None):
        raise NotImplementedError(
            "adams_solve_batched: sensitivities and rootfinding do not combine with "
            "injections or a stage (the adjoint's machinery), in the reference either"
        )
    if with_sens and sens0 is None:
        raise ValueError("adams_solve_batched: sens_rhs needs sens0 (B, k, n)")
    if rows is not None:
        _check_state_split(y0, tvals, options, device_system, with_sens, with_roots, rows)
    y0 = torch.as_tensor(y0)
    device = y0.device
    dtype = torch.promote_types(y0.dtype, torch.float32)
    f_kw = dict(dtype=dtype, device=device)
    y0 = y0.to(dtype).T.contiguous()  # (n, B)
    n, B = y0.shape
    t0 = torch.broadcast_to(torch.as_tensor(t0, **f_kw), (B,)).contiguous()
    tvals = torch.as_tensor(tvals, **f_kw)
    # the grid as (n_t, B) columns, one a lane, and each lane's last time
    tvals_tb = _grid_columns("adams_solve_batched", tvals, B)
    if tvals.ndim == 2 and (inject_times is not None or stage_fn is not None):
        raise NotImplementedError(
            "adams_solve_batched: per-lane observation grids do not combine with injections "
            "or a stage (the adjoint's machinery reads shared observation times)"
        )
    n_t = tvals_tb.shape[0]
    t_end = tvals_tb[-1]
    params = torch.as_tensor(params, **f_kw).T.contiguous()  # (n_p, B)
    n_p = params.shape[0]

    with_inject = inject_times is not None
    if with_inject:
        if inject_deltas is None:
            raise ValueError("adams_solve_batched: inject_times needs inject_deltas")
        inject_times = torch.as_tensor(inject_times, **f_kw)
        inject_deltas = torch.as_tensor(inject_deltas, **f_kw)
        n_ev = inject_times.shape[0]
        with_inject = n_ev > 0  # no event: the plain solve
        if tuple(inject_deltas.shape) != (n_ev, n, B):
            raise ValueError(
                f"adams_solve_batched: inject_deltas must be (n_e, n, B) = ({n_ev}, {n}, {B}), "
                f"got {tuple(inject_deltas.shape)}"
            )
    with_stage = stage_fn is not None

    with_quad = quad_rhs is not None
    m_quad = quad0.shape[1] if with_quad else 0
    # the sensitivity rows follow the quadrature's: z = [y | q | vec S]
    k_sens = sens0.shape[1] if with_sens else 0
    n_S = k_sens * n
    n_yq = n + m_quad
    nz = n_yq + n_S

    P_MAX = min(options.adams_max_order, 12)
    KAB = P_MAX + 3  # DF rows 0..p+2
    K = P_MAX + 1

    if batched_fns:
        rhs_b, quad_rhs_b = rhs, quad_rhs
    else:
        dims = (0, 1, 1, 1) if with_stage else (0, 1, 1)
        rhs_b = torch.func.vmap(rhs, in_dims=dims, out_dims=1)
        if with_quad:
            quad_rhs_b = torch.func.vmap(quad_rhs, in_dims=dims, out_dims=1)
        if with_sens:
            sens_rhs_b = torch.func.vmap(sens_rhs, in_dims=(0, 1, 2, 1), out_dims=2)
    if with_sens and batched_fns:
        sens_rhs_b = sens_rhs
    if with_quad:
        quad0_t = torch.as_tensor(quad0, **f_kw).T
    if with_roots:
        root_b = _batched_roots(root_fn, batched_fns, dtype)

    # the attempt's parameter rows: [params | stage(t)] with a stage, which
    # the right-hand sides read back apart
    def par_at(t):
        return torch.cat([params, stage_fn(t)]) if with_stage else params

    def split(par):
        return (par[:n_p], par[n_p:]) if with_stage else (par,)

    def f_of(t, y, par):
        return rhs_b(t, y, *split(par))

    def fz(t, y, par):
        """Combined derivative [f(y) | g(y)] -> (nz, B)."""
        f = f_of(t, y, par)
        if with_quad:
            return torch.cat([f, quad_rhs_b(t, y, *split(par))])
        return f

    par0 = par_at(t0)

    def check_system(ds, shape):
        if ds is not None and (ds.n, ds.nz, ds.n_p) != shape:
            raise ValueError(
                f"device system {ds.name} has (n, nz, n_p) = ({ds.n}, {ds.nz}, {ds.n_p}), "
                f"the solve {shape}"
            )

    check_system(device_system, (n, n_yq, par0.shape[0]))
    system = PeceSystem(fz=fz, n=n, nz=n_yq, device=device_system)
    if with_sens:
        # the sensitivity block's attempt: S rows, y_new staged in the
        # parameter rows after the problem's
        check_system(sens_device_system, (n_S, n_S, n_p + n))
        if adams_attempt.on_card(y0) and (sens_device_system is None) != (device_system is None):
            raise ValueError(
                "adams_solve_batched: on CUDA tensors the state and the sensitivity block "
                "both need an emitted system (the history-attempt kernel) or neither (the "
                "split kernels)"
            )

        def fz_S(t, S, par):
            return sens_rhs_b(t, par[n_p:], S.reshape(k_sens, n, -1), par[:n_p]).reshape(n_S, -1)

        system_S = PeceSystem(fz=fz_S, n=n_S, nz=n_S, device=sens_device_system)

    # scalar or per-state (n,) vector rtol; heuristics use the tightest
    rtol = torch.broadcast_to(torch.as_tensor(options.rtol, **f_kw), (n,))
    rtol_s = rtol.min()
    atol = torch.broadcast_to(torch.as_tensor(options.atol, **f_kw), (n,))
    gamma_star_abs = torch.as_tensor(np.abs(_GAMMA_STAR), **f_kw)

    # combined error weights over z
    n_blocks = (1 + (1 if (with_quad and options.quad_err_con) else 0)
                + (k_sens if (with_sens and options.sens_err_con) else 0))
    v_parts = [torch.full((n,), 1.0 / (n * n_blocks), **f_kw)]
    atol_parts = [atol]
    rtol_parts = [rtol]
    if with_quad:
        quad_rtol = (
            torch.as_tensor(options.quad_rtol, **f_kw)
            if options.quad_rtol is not None
            else rtol_s
        )
        quad_atol = torch.broadcast_to(
            torch.as_tensor(
                options.quad_atol if options.quad_atol is not None else options.atol,
                **f_kw,
            ),
            (m_quad,),
        )
        atol_parts.append(quad_atol)
        rtol_parts.append(torch.full((m_quad,), float(quad_rtol), **f_kw))
        v_parts.append(
            torch.full(
                (m_quad,),
                (1.0 / (m_quad * n_blocks)) if options.quad_err_con else 0.0,
                **f_kw,
            )
        )
    atol_z = torch.cat(atol_parts).contiguous()
    rtol_z = torch.cat(rtol_parts).contiguous()
    v_err = torch.cat(v_parts)
    if with_sens:
        # CVodeSensEEtolerances: atol_S[k] = atol / pbar_k
        pbar = (
            torch.broadcast_to(torch.as_tensor(options.sens_pbar, **f_kw), (k_sens,))
            if options.sens_pbar is not None
            else torch.ones((k_sens,), **f_kw)
        )
        atol_S = (atol[None, :] / pbar[:, None]).reshape(-1).contiguous()
        rtol_S = rtol.repeat(k_sens).contiguous()
        v_S = torch.full((n_S,), (1.0 / (n * n_blocks)) if options.sens_err_con else 0.0, **f_kw)

    if options.constraints is not None:
        constraints = torch.broadcast_to(
            torch.as_tensor(options.constraints, **f_kw), (n,)
        )
    else:
        constraints = None

    newton_tol = newton_tol_for(options, float(rtol_s), dtype)

    f0 = f_of(t0, y0, par0)
    fz0 = fz(t0, y0, par0)
    bad_init = ~(torch.isfinite(y0).all(dim=0) & torch.isfinite(f0).all(dim=0))

    # initial step (Hairer-Wanner, order-1 estimate)
    scale0 = atol[:, None] + rtol[:, None] * torch.abs(y0)
    w0 = 1.0 / scale0
    d0n = torch.sqrt(torch.mean((y0 * w0) ** 2, dim=0))
    d1n = torch.sqrt(torch.mean((f0 * w0) ** 2, dim=0))
    h0a = torch.where((d0n < 1e-5) | (d1n < 1e-5), 1e-6, 0.01 * d0n / d1n)
    h0a = torch.minimum(h0a, 0.5 * (t_end - t0))
    y1 = y0 + h0a[None, :] * f0
    f1 = f_of(t0 + h0a, y1, par_at(t0 + h0a))
    d2n = torch.sqrt(torch.mean(((f1 - f0) * w0) ** 2, dim=0)) / h0a
    dmn = torch.maximum(d1n, d2n)
    h1a = torch.where(
        dmn <= 1e-15,
        torch.clamp(h0a * 1e-3, min=1e-6),
        # one rounded division, as the reference: torch turns `0.01 / dmn`
        # into `reciprocal(dmn) * 0.01`, two roundings
        torch.sqrt(torch.full_like(dmn, 0.01) / dmn),
    )
    h_auto = torch.minimum(torch.minimum(100 * h0a, h1a), t_end - t0)
    h_auto = torch.minimum(h_auto, torch.as_tensor(options.max_step, **f_kw))
    if first_step is not None:
        # a lane's own first step (the class API resumes a lane with its
        # last step size): > 0 clipped to the span, else the automatic step
        fs = torch.broadcast_to(torch.as_tensor(first_step, **f_kw), (B,))
        h0 = torch.where(fs > 0, torch.minimum(fs, t_end - t0), h_auto)
    elif options.first_step is not None:
        h0 = torch.full((B,), options.first_step, **f_kw)
    else:
        h0 = h_auto
    h0 = torch.clamp(h0, min=1e-12)
    # extreme params overflow the WRMS norms (inf/inf -> NaN h0); a NaN h
    # defeats every `h < h_min` guard — fall back to a small finite h so the
    # lane dies through underflow instead
    h0 = torch.where(torch.isfinite(h0), h0, 1e-6)

    z0 = torch.cat([y0, quad0_t]) if with_quad else y0
    DF0 = torch.zeros((KAB, n_yq, B), **f_kw)
    DF0[0] = fz0
    if with_sens:
        S0_t = torch.as_tensor(sens0, **f_kw).permute(1, 2, 0).reshape(n_S, B)
        z0 = torch.cat([z0, S0_t])
        DF0_S = torch.zeros((KAB, n_S, B), **f_kw)
        DF0_S[0] = fz_S(t0, S0_t, torch.cat([params, y0]))
    if with_roots:
        g_init, rdir, root_cap = _root_setup(root_b, t0, y0, params, root_cap, root_directions)
        roots = RootRecord(g_init, n, root_cap)

    # checkpoint recording: rows (t, y, f[, fdot]); the fdot rows need a
    # stage-free right-hand side, and only forward solves record
    save_steps = int(options.save_steps)
    thinning = bool(options.checkpoint_thinning)
    rec_fd = save_steps > 0 and options.hermite_order == 5 and not with_stage

    def record_row(t, y, f):
        parts = [t[None, :], y, f]
        if rec_fd:
            parts.append(fdot(rhs_b, t, y, f, params))
        return torch.cat(parts)

    if save_steps > 0 and rows is None:  # the state-split route records by block
        row0 = record_row(t0, y0, f0)
        saved = init_saved_batched(row0, save_steps, thinning)
        pad_row = pad_column(row0.shape[0], row0)

    zs = torch.full((n_t, nz, B), float("nan"), **f_kw)
    emit_mask0 = tvals_tb <= t0[None, :]  # (n_t, B), each lane on its own grid
    zs = torch.where(emit_mask0[:, None, :], z0[None], zs)
    i_out = emit_mask0.sum(dim=0).to(torch.int32)

    i32 = dict(dtype=torch.int32, device=device)
    zeros_i = torch.zeros((B,), **i32)
    c = dict(
        t=t0,
        z=z0.contiguous(),
        h=h0,
        h_D=h0,
        p=torch.ones((B,), **i32),
        DF=DF0,
        n_equal=zeros_i,
        status=torch.where(bad_init, STATUS["BAD_INIT"], -1).to(torch.int32),
        consec_fails=zeros_i,
        nsteps=zeros_i,
        nfev=torch.full((B,), 2, **i32),
        nfevS=torch.full((B,), 1 if with_sens else 0, **i32),
        nniters=zeros_i,
        n_err_fails=zeros_i,
        n_conv_fails=zeros_i,
        pm_t=torch.full((B,), float("nan"), **f_kw),
        pm_h=torch.full((B,), float("nan"), **f_kw),
        pm_q=torch.full((B,), -1, **i32),
        pm_worst=torch.full((B,), -1, **i32),
        i_ev=zeros_i,
    )
    if with_sens:
        c["DF_S"] = DF0_S
    it = 0
    # lanes whose last accepted step ended at an injection: their history's
    # row 0 becomes f(z_injected) at the top of the next attempt, where the
    # active-lanes sync reads this flag too (no sync of its own)
    ev_pending = torch.zeros((B,), dtype=torch.bool, device=device)

    ar_K = torch.arange(K, device=device)
    ar_KAB = torch.arange(KAB, device=device)
    row0 = (ar_KAB == 0).to(dtype)[:, None, None]
    C_int = torch.as_tensor(np.asarray(_C_INT[:K]), **f_kw)  # (K, K_max + 2)
    # the dense output's Horner steps start at the last column with a
    # nonzero coefficient: the zero columns above it leave ci at +0 exactly
    n_cols = int(np.flatnonzero(np.any(np.asarray(_C_INT[:K]) != 0, axis=0)).max()) + 1
    eps = torch.finfo(dtype).eps

    def active_lanes(i_out, ev_pending):
        """The lanes still running, whether any does, and whether a lane's
        history restarts at an injection (one sync for both)."""
        active = (c["status"] == -1) & (i_out < n_t)
        if with_inject:
            any_active, any_pending = torch.stack([active.any(), ev_pending.any()]).tolist()
        else:
            any_active, any_pending = bool(active.any()), False
        return active, any_active, any_pending

    def step_window(active):
        """This attempt's step: ``(h_min_loc, underflow, t_lim, h_use, t_new,
        pre_factor)``, each lane's step clipped at its next injection or end."""
        t = c["t"]
        h_min_loc = 10 * eps * torch.maximum(torch.abs(t), torch.abs(t_end))
        # NaN-robust form: non-finite h terminates the lane
        underflow = active & ~(c["h"] >= torch.clamp(h_min_loc, min=options.min_step))
        if with_inject:
            i_ev = c["i_ev"]
            t_lim = torch.where(
                i_ev < n_ev, inject_times[torch.clamp(i_ev, max=n_ev - 1).long()], t_end
            )
            t_lim = torch.minimum(t_lim, t_end)
        else:
            t_lim = t_end
        h_use = torch.where(
            active, torch.clamp(torch.minimum(c["h"], t_lim - t), min=0.0), c["h"]
        )
        pre_factor = h_use / torch.clamp(c["h_D"], min=1e-300)
        return h_min_loc, underflow, t_lim, h_use, t + h_use, pre_factor

    def interp_weights(tt, t_new, h_use, p):
        """(K, B): each history row's weight in the integral-basis dense
        output at tt (B,) of the step from t_new - h_use, zero from order p
        on."""
        s = (tt - t_new) / h_use
        ci = torch.zeros((K, B), **f_kw)
        for col in range(n_cols - 1, -1, -1):
            ci = ci * s[None, :] + C_int[:, col][:, None]
        return torch.where(ar_K[:, None] <= p[None, :], ci, 0.0)

    def _solve_rows():
        """The state-split route: the loop below on row blocks of ``rows``
        (the quadrature rows on the home block), the lanes on the home
        device."""
        L = rows.with_rows(m_quad)  # z's rows: [y | q]
        lanes, n_d = L.lanes, L.state_rows(n)
        g_rows = [rows.global_rows(d) for d in range(len(n_d))]

        def state_of(zb):  # z's state rows as blocks of ``rows``
            return RowBlocks(rows, [z[:m] for z, m in zip(zb.blocks, n_d)])

        def where_lanes(mask, a, b):  # where(mask[lane], a, b) on every block
            return a.map(lambda x, y, m: torch.where(m.view((1,) * (x.ndim - 1) + (-1,)), x, y),
                         b, lanes(mask))

        atol_b, rtol_b, v_b = (scatter(L, x[:, None]) for x in (atol_z, rtol_z, v_err))
        zs_b, ar_KAB_d, row0_d = scatter(L, zs), lanes(ar_KAB), lanes(row0)
        deltas_b = scatter(rows, inject_deltas) if with_inject else None
        c["DF"], c["z"] = scatter(L, c["DF"]), scatter(L, c["z"])

        def block_rows(t, yb, fb):
            """The recording's rows (t, y, f[, fdot]) of each block."""
            fd = (scatter(rows, fdot(rhs_b, t, yb.gather(), fb.gather(), params)).blocks
                  if rec_fd else [None] * len(n_d))
            return [torch.cat([x for x in (tt[None, :], y, f, d) if x is not None])
                    for tt, y, f, d in zip(lanes(t), yb.blocks, fb.blocks, fd)]

        if save_steps > 0:
            rows0 = block_rows(t0, scatter(rows, y0), scatter(rows, f0))
            saved_b = [init_saved_batched(r, save_steps, thinning) for r in rows0]
            pads = [pad_column(r.shape[0], r) for r in rows0]
        i_out_ = i_out
        it = 0
        ev_pending = torch.zeros((B,), dtype=torch.bool, device=device)
        while True:
            active, any_active, any_pending = active_lanes(i_out_, ev_pending)
            if not any_active:
                break
            if any_pending:
                fz_inj = scatter(L, fz(c["t"], state_of(c["z"]).gather(), par_at(c["t"])))
                c["DF"] = c["DF"].map(
                    lambda DF, f, e: torch.cat([torch.where(e[None, :], f, DF[0])[None], DF[1:]]),
                    fz_inj, lanes(ev_pending))
            t, p, i_ev = c["t"], c["p"], c["i_ev"]
            h_min_loc, underflow, t_lim, h_use, t_new, pre_factor = step_window(active)
            hist = adams_split_attempt_rows(
                system, t_new, h_use, pre_factor, p, active, c["DF"], c["z"], par_at(t_new),
                atol_b, rtol_b, gamma_star_abs, v_b, newton_tol, FUNCTIONAL_MAXITER, P_MAX,
            )
            conv, niter, err3 = hist.conv, hist.niter, hist.err3
            err_norm = err3[0]
            err_ok = err_norm <= 1.0
            constraint_fail = torch.zeros((B,), dtype=torch.bool, device=device)
            accept = active & conv & err_ok
            err_reject = active & conv & ~err_ok
            n_equal = torch.where(accept, c["n_equal"] + 1, 0)
            t_next = torch.where(accept, t_new, t)
            z_next = where_lanes(accept, hist.z_new, c["z"])
            if with_inject:
                tiny_ev = 1e-12 * (1.0 + torch.abs(t_lim))
                at_event = accept & (i_ev < n_ev) & (t_new >= t_lim - tiny_ev)
                i_evc = torch.clamp(i_ev, max=n_ev - 1).long()

                def inject(z_n, z_x, dl, e, i, m):
                    delta_ev = dl.gather(0, i[None, None, :].expand(1, m, B))[0]
                    y_inj = z_n[:m] + torch.where(e[None, :], delta_ev, 0.0)
                    return torch.where(e[None, :], torch.cat([y_inj, z_n[m:]]), z_x)

                z_next = RowBlocks(L, [inject(*a) for a in zip(
                    hist.z_new.blocks, z_next.blocks, deltas_b.blocks, lanes(at_event),
                    lanes(i_evc), n_d)])

            # emission: each block interpolates its rows
            while True:
                idx = torch.clamp(i_out_, max=n_t - 1)
                te = tvals_tb.gather(0, idx.long()[None, :])[0]
                pend = accept & (i_out_ < n_t) & (te <= t_new + 1e-14 * torch.abs(t_new))
                if not bool(pend.any()):
                    break
                wgt = interp_weights(te, t_new, h_use, p)

                def emit(zs_d, DF_u, z_n, w, hu, ix, pe):
                    gidx = ix.long()[None, None, :].expand(1, zs_d.shape[1], B)
                    zi = _interp_rows(w, hu, DF_u, z_n)
                    return zs_d.scatter(0, gidx, torch.where(pe[None, None, :], zi[None],
                                                             zs_d.gather(0, gidx)))

                zs_b = zs_b.map(emit, hist.DF_upd, hist.z_new, lanes(wgt), lanes(h_use),
                                lanes(idx), lanes(pend))
                i_out_ = i_out_ + pend.to(torch.int32)

            if save_steps > 0:
                rec = block_rows(t_new, state_of(hist.z_new), RowBlocks(
                    rows, [du[0, :m] for du, m in zip(hist.DF_upd.blocks, n_d)]))
                saved_b = [record_step_batched(sv, it, a, torch.where(a[None, :], r, pad),
                                               save_steps, thinning)
                           for sv, a, r, pad in zip(saved_b, lanes(accept), rec, pads)]

            p_next, h_next, n_equal, cfails, reset = _step_control(
                c, n_equal, p, h_use, active, accept, conv, err_ok, constraint_fail, err_norm,
                err3, P_MAX, options, dtype)
            DF_kept = where_lanes(reset, hist.DF_resc.map(lambda x, r0: x * r0, row0_d),
                                  hist.DF_resc)
            DF_next = where_lanes(accept, hist.DF_upd, DF_kept)
            if with_inject:
                keep = max(1, int(options.inject_keep_order))
                DF_event = hist.DF_upd.map(lambda x, ar: torch.where(ar[:, None, None] < keep,
                                                                     x, 0.0), ar_KAB_d)
                DF_next = where_lanes(at_event, DF_event, DF_next)
                p_next = torch.where(at_event, torch.clamp(p_next, max=keep), p_next)
                n_equal = torch.where(at_event, 0, n_equal)
                h_next = torch.where(at_event, torch.maximum(c["h"], h_min_loc * 4), h_next)
                ev_pending = at_event
            DF_next = where_lanes(active, DF_next, c["DF"])

            status, nsteps = _lane_status(c, active, accept, cfails, underflow, options)
            fatal_now = (c["status"] == -1) & (status != -1)
            worst = _worst_row([
                torch.where(cv[None, :], torch.abs(e0[:m]) * w, torch.abs((zn - zp)[:m]) * w)
                for e0, zn, zp, cv, w, m in zip(
                    hist.err0.blocks, hist.z_new.blocks, hist.z_pred.blocks, lanes(conv),
                    (1.0 / (a[:m] + r[:m] * torch.abs(zp[:m]))
                     for a, r, zp, m in zip(atol_b.blocks, rtol_b.blocks, hist.z_pred.blocks,
                                            n_d)), n_d)], g_rows, device)
            c.update(
                t=t_next, z=z_next, h=h_next, h_D=torch.where(active, h_use, c["h_D"]),
                p=p_next.to(torch.int32), DF=DF_next, n_equal=n_equal.to(torch.int32),
                status=status.to(torch.int32), consec_fails=cfails.to(torch.int32),
                nsteps=nsteps, nfev=c["nfev"] + niter + 1, nniters=c["nniters"] + niter,
                n_err_fails=c["n_err_fails"] + err_reject.to(torch.int32),
                n_conv_fails=c["n_conv_fails"] + (active & ~conv).to(torch.int32),
                pm_t=torch.where(fatal_now, c["t"], c["pm_t"]),
                pm_h=torch.where(fatal_now, h_use, c["pm_h"]),
                pm_q=torch.where(fatal_now, p, c["pm_q"]).to(torch.int32),
                pm_worst=torch.where(fatal_now, worst.to(torch.int32), c["pm_worst"]),
                i_ev=c["i_ev"] + at_event.to(torch.int32) if with_inject else c["i_ev"],
            )
            it += 1

        status = torch.where(c["status"] == -1, STATUS["SUCCESS"], c["status"]).to(torch.int32)
        stats = _final_stats(c, it)
        stats["final_state"] = c["z"].gather().T
        saved_out = None
        if save_steps > 0:
            stats["checkpoint_thinning_levels"] = saved_b[0]["shift"] if thinning else 0
            fins = [finalize_saved_batched(sv, m, thinning) for sv, m in zip(saved_b, n_d)]
            saved_out = {k: fins[0][k] for k in ("t", "n_saved", "overflow")}
            for k in ("y", "f", "fd"):
                if k in fins[0]:
                    saved_out[k] = RowBlocks(rows, [f[k] for f in fins])
            saved_out["yf"] = RowBlocks(rows.repeated(3 if "fd" in fins[0] else 2),
                                        [f["yf"] for f in fins])
        zs_all = zs_b.gather()
        ys = zs_all[:, :n, :].permute(2, 0, 1)
        quad = zs_all[:, n:n_yq, :].permute(2, 0, 1) if with_quad else None
        return BDFResult(ys=ys, status=status, stats=stats, saved=saved_out, sens=None,
                         quad=quad)

    if rows is not None:
        return _solve_rows()

    while True:
        active, any_active, any_pending = active_lanes(i_out, ev_pending)
        if not any_active:
            break
        if any_pending:
            fz_inj = fz(c["t"], c["z"][:n], par_at(c["t"]))
            row_0 = torch.where(ev_pending[None, :], fz_inj, c["DF"][0])
            c["DF"] = torch.cat([row_0[None], c["DF"][1:]])
        t, p, z_prev, i_ev = c["t"], c["p"], c["z"], c["i_ev"]
        h_min_loc, underflow, t_lim, h_use, t_new, pre_factor = step_window(active)
        hist = adams_history_attempt(
            system, t_new, h_use, pre_factor, p, active, c["DF"], z_prev[:n_yq], par_at(t_new),
            atol_z, rtol_z, gamma_star_abs, v_err, newton_tol, FUNCTIONAL_MAXITER, P_MAX,
        )
        DF, DF_upd, conv, niter, z_pred, z_new, err3 = (
            hist.DF_resc, hist.DF_upd, hist.conv, hist.niter, hist.z_pred, hist.z_new,
            hist.err3,
        )
        y_new = z_new[:n]
        w_y = 1.0 / (atol_z[:n, None] + rtol_z[:n, None] * torch.abs(z_pred[:n]))

        if with_sens:
            # CV_STAGGERED: the state's own error test, then the sensitivity
            # block's attempt on the lanes that passed it, y_new staged
            err_y_only = torch.sqrt(torch.mean((hist.err0[:n] * w_y) ** 2, dim=0))
            ok_y = conv & (err_y_only <= 1.0)
            hist_S = adams_history_attempt(
                system_S, t_new, h_use, pre_factor, p, active & ok_y, c["DF_S"],
                z_prev[n_yq:], torch.cat([params, y_new]), atol_S, rtol_S, gamma_star_abs,
                v_S, newton_tol, FUNCTIONAL_MAXITER, P_MAX,
            )
            # the reference's predictor check covers the sensitivity rows
            conv = conv & torch.isfinite(hist_S.z_pred).all(dim=0)
            state_err_ok = conv & (err_y_only <= 1.0)
            sens_gate = active & state_err_ok
            # a gated-off corrector must not mask the state's rejection; a
            # lane that failed its state test counts its sensitivity rows' error
            # as zero, as the reference zeroes their difference
            conv = conv & (hist_S.conv | ~sens_gate)
            err3 = torch.where(state_err_ok[None, :],
                               torch.sqrt(err3 * err3 + hist_S.err3 * hist_S.err3), err3)
            nfevS_n = torch.where(sens_gate, hist_S.niter + 1, 0)

        if constraints is not None:
            cns = constraints[:, None]
            viol = (
                ((cns == 1) & (y_new < 0))
                | ((cns == -1) & (y_new > 0))
                | ((cns == 2) & (y_new <= 0))
                | ((cns == -2) & (y_new >= 0))
            )
            constraint_fail = viol.any(dim=0)
        else:
            constraint_fail = torch.zeros((B,), dtype=torch.bool, device=device)

        err_norm = err3[0]
        if with_sens:
            # the state's own error test gates acceptance and the step
            # reduction sees it too
            err_norm = torch.maximum(err_norm, err_y_only)
            err_ok = (err_norm <= 1.0) & state_err_ok
            z_new_all = torch.cat([z_new, hist_S.z_new])
        else:
            err_ok = err_norm <= 1.0
            z_new_all = z_new
        accept = active & conv & err_ok & ~constraint_fail
        err_reject = active & conv & (~err_ok | constraint_fail)

        n_equal = torch.where(accept, c["n_equal"] + 1, 0)
        t_next = torch.where(accept, t_new, t)
        z_next = torch.where(accept[None, :], z_new_all, z_prev)

        if with_inject:
            tiny_ev = 1e-12 * (1.0 + torch.abs(t_lim))
            at_event = accept & (i_ev < n_ev) & (t_new >= t_lim - tiny_ev)
            i_evc = torch.clamp(i_ev, max=n_ev - 1).long()
            delta_ev = inject_deltas.gather(0, i_evc[None, None, :].expand(1, n, B))[0]
            y_inj = z_new[:n] + torch.where(at_event[None, :], delta_ev, 0.0)
            z_inj = torch.cat([y_inj, z_new[n:]]) if with_quad else y_inj
            z_next = torch.where(at_event[None, :], z_inj, z_next)

        def _z_interp(tt, DF_u, z_n):
            """tt (B,) -> (rows, B): the integral-basis dense output of the
            rows of the updated history ``DF_u`` and new state ``z_n``."""
            return _interp_rows(interp_weights(tt, t_new, h_use, p), h_use, DF_u, z_n)

        def z_at(tt):  # every row of z
            zi = _z_interp(tt, DF_upd, z_new)
            return torch.cat([zi, _z_interp(tt, hist_S.DF_upd, hist_S.z_new)]) if with_sens else zi

        # rootfinding on the dense output of the accepted step (y rows only)
        t_stop = None
        if with_roots:
            DF_y, z_y = DF_upd[:, :n], z_new[:n]
            root_hit, t_root, dirs, y_root, g_new = _root_scan(
                root_b, params, rdir, roots.g_prev, t, t_new, h_use, y_new,
                lambda tt: _z_interp(tt, DF_y, z_y), accept,
            )
            roots.update(accept, root_hit, t_root, dirs, y_root, g_new)
            if root_terminal:
                t_stop = t_root  # inf where no root was hit

        # emission (exact integral-basis interpolation)
        while True:
            idx = torch.clamp(i_out, max=n_t - 1)
            te = tvals_tb.gather(0, idx.long()[None, :])[0]  # each lane's next time
            pend = accept & (i_out < n_t) & (te <= t_new + 1e-14 * torch.abs(t_new))
            if t_stop is not None:
                pend = pend & (te <= t_stop)
            if not bool(pend.any()):
                break
            zi = z_at(te)
            gidx = idx.long()[None, None, :].expand(1, nz, B)
            row = zs.gather(0, gidx)
            zs.scatter_(0, gidx, torch.where(pend[None, None, :], zi[None], row))
            i_out = i_out + pend.to(torch.int32)

        # checkpoint recording (see ops/_recording.py); DF_upd[0] is the
        # derivative at the converged iterate, the reference's fz_new
        if save_steps > 0:
            row = torch.where(accept[None, :], record_row(t_new, y_new, DF_upd[0, :n]), pad_row)
            saved = record_step_batched(saved, it, accept, row, save_steps, thinning)

        p_next, h_next, n_equal, cfails, reset = _step_control(
            c, n_equal, p, h_use, active, accept, conv, err_ok, constraint_fail, err_norm,
            err3, P_MAX, options, dtype)
        DF_next = torch.where(
            accept[None, None, :],
            DF_upd,
            torch.where(reset[None, None, :], DF * row0, DF),
        )
        if with_inject:
            # the state jumped: restart the history at order 1, or keep the
            # differences below inject_keep_order; row 0 is f(z_injected),
            # set at the top of the next attempt (ev_pending).  The warm h
            # is kept, never 0 (repeated observation times make legal
            # zero-length event steps)
            keep = max(1, int(options.inject_keep_order))
            DF_event = torch.where(ar_KAB[:, None, None] < keep, DF_upd, 0.0)
            DF_next = torch.where(at_event[None, None, :], DF_event, DF_next)
            p_next = torch.where(at_event, torch.clamp(p_next, max=keep), p_next)
            n_equal = torch.where(at_event, 0, n_equal)
            h_next = torch.where(at_event, torch.maximum(c["h"], h_min_loc * 4), h_next)
            ev_pending = at_event
        DF_next = torch.where(active[None, None, :], DF_next, c["DF"])
        if with_sens:
            DF_S, DF_S_upd = hist_S.DF_resc, hist_S.DF_upd
            DF_S_next = torch.where(
                accept[None, None, :],
                DF_S_upd,
                torch.where(reset[None, None, :], DF_S * row0, DF_S),
            )
            DF_S_next = torch.where(active[None, None, :], DF_S_next, c["DF_S"])

        status, nsteps = _lane_status(c, active, accept, cfails, underflow, options)
        root_ret_now = torch.zeros((B,), dtype=torch.bool, device=device)
        if with_roots and root_terminal:
            root_ret_now = (status == -1) & root_hit
            status = torch.where(root_ret_now, STATUS["ROOT_RETURN"], status)

        # per-lane post-mortem of the attempt where a lane's status turns fatal
        fatal_now = (c["status"] == -1) & (status != -1) & ~root_ret_now
        e_err = torch.abs(hist.err0[:n]) * w_y
        e_newt = torch.abs((z_new - z_pred)[:n]) * w_y
        worst = torch.argmax(torch.where(conv[None, :], e_err, e_newt), dim=0)

        c = dict(
            t=t_next,
            z=z_next,
            h=h_next,
            h_D=torch.where(active, h_use, c["h_D"]),
            p=p_next.to(torch.int32),
            DF=DF_next,
            n_equal=n_equal.to(torch.int32),
            status=status.to(torch.int32),
            consec_fails=cfails.to(torch.int32),
            nsteps=nsteps,
            nfev=c["nfev"] + niter + 1,
            nfevS=c["nfevS"] + nfevS_n if with_sens else c["nfevS"],
            nniters=c["nniters"] + niter,
            n_err_fails=c["n_err_fails"] + err_reject.to(torch.int32),
            n_conv_fails=c["n_conv_fails"] + (active & ~conv).to(torch.int32),
            pm_t=torch.where(fatal_now, c["t"], c["pm_t"]),
            pm_h=torch.where(fatal_now, h_use, c["pm_h"]),
            pm_q=torch.where(fatal_now, p, c["pm_q"]).to(torch.int32),
            pm_worst=torch.where(fatal_now, worst.to(torch.int32), c["pm_worst"]),
            i_ev=c["i_ev"] + at_event.to(torch.int32) if with_inject else c["i_ev"],
        )
        if with_sens:
            c["DF_S"] = DF_S_next
        it += 1

    status = torch.where(c["status"] == -1, STATUS["SUCCESS"], c["status"]).to(
        torch.int32
    )
    stats = _final_stats(c, it)
    stats["final_state"] = c["z"].T  # after the last injection: the adjoint reads it
    if with_sens:
        stats["n_sens_rhs_evals"] = c["nfevS"]
    if with_roots:
        stats.update(roots.stats())
    saved_out = None
    if save_steps > 0:
        # shared across lanes: the stride follows the shared attempt counter
        stats["checkpoint_thinning_levels"] = saved["shift"] if thinning else 0
        saved_out = finalize_saved_batched(saved, n, thinning)
    ys = zs[:, :n, :].permute(2, 0, 1)
    quad = zs[:, n:n_yq, :].permute(2, 0, 1) if with_quad else None
    sens = zs[:, n_yq:, :].permute(2, 0, 1).reshape(B, n_t, k_sens, n) if with_sens else None
    return BDFResult(ys=ys, status=status, stats=stats, saved=saved_out, sens=sens, quad=quad)


def _step_control(c, n_equal, p, h_use, active, accept, conv, err_ok, constraint_fail, err_norm,
                  err3, P_MAX, options, dtype):
    """Order and step adaptation and the breakdown detector of one attempt,
    per lane: ``(p_next, h_next, n_equal, cfails, reset)``."""
    # order & step adaptation
    pf = p.to(dtype)
    can_adapt = n_equal >= p + 1
    err_m = torch.where(p > 1, err3[1], float("inf"))
    err_p_ = torch.where(p < P_MAX, err3[2], float("inf"))

    def fac(e, qq):
        unavailable = ~torch.isfinite(e)
        e_safe = torch.clamp(e, 1e-30, 1e30)
        f = 0.9 * e_safe ** (-1.0 / (qq + 1.0))
        return torch.where(unavailable, 0.0, f)

    facs = torch.stack([fac(err_m, pf - 1), fac(err_norm, pf), fac(err_p_, pf + 1)])
    best = torch.argmax(facs, dim=0)
    dq = best.to(torch.int32) - 1
    factor_best = torch.clamp(
        facs.gather(0, best[None, :])[0], MIN_FACTOR, MAX_FACTOR
    )
    do_change = can_adapt & (
        (factor_best >= THRESH) | (factor_best < 1.0) | (dq != 0)
    )
    p_acc = torch.where(do_change, torch.clamp(p + dq, 1, P_MAX), p)
    factor_acc = torch.where(do_change, factor_best, 1.0)
    factor_acc = torch.minimum(
        factor_acc, options.max_step / torch.clamp(h_use, min=1e-300)
    )
    n_equal = torch.where(do_change & accept, 0, n_equal)

    factor_rej = torch.clamp(
        0.9 * torch.clamp(err_norm, 1e-30, 1e30) ** (-1.0 / (pf + 1.0)),
        MIN_FACTOR,
        0.9,
    )
    factor_rej = torch.where(constraint_fail & err_ok, 0.25, factor_rej)
    factor_fail = torch.where(active & ~conv, 0.25, factor_rej)

    # breakdown detector: 4 accumulated failures reset the lane's history
    # (keep nabla^0 f only) and restart at order 1
    failed_lane = active & ~accept
    cfails_fail = c["consec_fails"] + 1
    reset = failed_lane & (cfails_fail >= 4)
    cfails = torch.where(
        accept,
        torch.where(
            err_norm <= 0.9,
            torch.clamp(c["consec_fails"] - 1, min=0),
            c["consec_fails"],
        ),
        torch.where(
            reset, 0, torch.where(failed_lane, cfails_fail, c["consec_fails"])
        ),
    )
    factor_next = torch.where(
        accept, factor_acc, torch.where(reset, 0.25, factor_fail)
    )
    h_next = torch.where(active, h_use * factor_next, c["h"])
    p_next = torch.where(accept, p_acc, torch.where(reset, 1, p))
    return p_next, h_next, n_equal, cfails, reset


def _lane_status(c, active, accept, cfails, underflow, options):
    """The lanes' status after one attempt, and their accepted steps."""
    too_many = cfails >= MAX_CONSECUTIVE_FAILS
    status = c["status"]
    status = torch.where(
        (status == -1) & active & too_many & ~accept,
        STATUS["REPEATED_FAILURES"],
        status,
    )
    nsteps = c["nsteps"] + accept.to(torch.int32)
    status = torch.where(
        (status == -1) & active & (nsteps >= options.max_steps),
        STATUS["MAX_STEPS"],
        status,
    )
    status = torch.where(
        (status == -1) & underflow, STATUS["STEP_UNDERFLOW"], status
    )
    return status, nsteps


def _interp_rows(wgt, h_use, DF_u, z_n):
    """The dense output's rows: ``z_n + h_use sum_i wgt[i] DF_u[i]`` over the
    K = ``wgt.shape[0]`` history rows."""
    acc = torch.zeros_like(z_n)
    for i in range(wgt.shape[0]):
        acc = acc + wgt[i][None, :] * DF_u[i]
    return z_n + h_use[None, :] * acc


def _final_stats(c, it: int) -> dict:
    """The solve's per-lane stats from the final carry ``c`` after ``it``
    attempts (no Jacobian or factorization: zeros)."""
    zeros = torch.zeros_like(c["nsteps"])
    return dict(
        n_steps=c["nsteps"],
        n_rhs_evals=c["nfev"],
        n_jac_evals=zeros,
        n_factorizations=zeros,
        n_newton_iters=c["nniters"],
        n_error_test_fails=c["n_err_fails"],
        n_conv_fails=c["n_conv_fails"],
        final_order=c["p"],
        final_step_size=c["h"],
        final_time=c["t"],
        n_attempts=it,
        error_time=c["pm_t"],
        error_step_size=c["pm_h"],
        error_order=c["pm_q"],
        error_worst_state=c["pm_worst"],
    )


def _worst_row(values, g_rows, home):
    """The post-mortem's worst state row per lane: the first row, in global
    order, of the largest (or first NaN) value over the blocks' ``values``
    ``(n_d, B)``, ``g_rows[d]`` block d's global row indices -- the row
    ``torch.argmax`` finds over the whole state."""
    best_v = best_i = None
    for v, g in zip(values, g_rows):
        i = torch.argmax(v, dim=0)
        m, gi = v.gather(0, i[None, :])[0].to(home), g[i].to(home)
        if best_v is None:
            best_v, best_i = m, gi
            continue
        take = ((m > best_v) | ((m == best_v) & (gi < best_i))
                | (torch.isnan(m) & (~torch.isnan(best_v) | (gi < best_i))))
        best_v, best_i = torch.where(take, m, best_v), torch.where(take, gi, best_i)
    return best_i


def _check_state_split(y0, tvals, options, device_system, with_sens, with_roots, rows):
    """Refuse, before any solve, what the state-split route does not take."""
    def refuse(what):
        raise ValueError(f"adams_solve_batched: the state split (rows=...) does not take {what}; "
                         f"ROADMAP A queues it")

    if torch.as_tensor(y0).dtype != torch.float64:
        refuse("float32 (it runs at float64)")
    if device_system is not None:
        refuse("an emitted system (a SympyProblem's history kernel holds the whole state)")
    if with_sens or with_roots:
        refuse("sensitivities or roots")
    if options.constraints is not None:
        refuse("constraints")
    if torch.as_tensor(tvals).ndim != 1:
        refuse("per-lane observation grids")
    if canonical_device(torch.as_tensor(y0).device) != rows.home:
        raise ValueError(f"adams_solve_batched: y0 on {torch.as_tensor(y0).device}, the row "
                         f"layout's home device is {rows.home}")
