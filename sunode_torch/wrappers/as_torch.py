"""Differentiable batched solve as a ``torch.autograd.Function``.

Port of ``sunode_tpu/wrappers/as_jax.py::make_batched_solve_fn``:

* ``method='BDF'`` (the default) with ``derivatives=None`` or ``'adjoint'``
  and ``adjoint_interpolation`` 'hermite' (the default) or 'polynomial':
  the forward pass is the batched BDF solve (``ops/bdf_batched.py``), which
  records checkpoints when gradients are wanted, and the backward pass the
  checkpointed adjoint (``adjoint.py::adjoint_backward_batched``); torch
  code with a ``torch.linalg`` Newton solve on either device.
* ``method='ADAMS'`` with ``derivatives=None`` or ``'adjoint'`` and every
  ``adjoint_interpolation``: 'transition' (the transition-matrix adjoint),
  'resolve' (the backsolve adjoint, y integrated backward beside lambda),
  'hermite' or 'polynomial' (the forward solve records checkpoints and the
  fused backward Adams solve reads y(t) from them, staged once per
  attempt).  On CUDA tensors every forward and backward attempt of a
  ``SympyProblem`` runs through the history-attempt kernel, built at first
  use from the problem's right-hand side and the backward system of the
  mode (``symode/cuda_codegen.py``); those of any other problem (a
  ``TorchProblem``) run through the split attempt's three kernels with the
  right-hand side in torch between them (``ops/adams_split.py``).

The solve runs at its inputs' type, float64 or float32 (the kernels have a
build of each).  Per-lane observation grids, ``tvals (B, n_t)``, go through
the undifferentiated solve, as in the reference; a gradient through them
raises ``NotImplementedError``.

``linear_solver`` 'band' or 'sparse' (``method='BDF'`` only, as in the
reference) gives both BDF solves a structured Newton solve
(:func:`_structured_setup`): the forward solve's Jacobian in banded storage
from striped jvps, or in a :class:`~sunode_torch.ops.sparsity.SparsePlan`'s
packed storage from colored jvps, and the backward solve's matrix, -J^T,
the transposed structure (the bandwidths swapped; the plan of the
transposed pattern).  On CUDA tensors both factor and solve through the
banded LU's kernels (``csrc/banded.cu``).

Not ported (``NotImplementedError``): ``derivatives='forward'``, which the
reference's batched solver refuses too.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sunode_torch.adjoint import adjoint_backward_batched, adjoint_backward_transition_batched
from sunode_torch.ops.adams_attempt import c_real
from sunode_torch.ops.adams_batched import adams_solve_batched
from sunode_torch.ops.bdf import BDFOptions
from sunode_torch.ops.bdf_batched import bdf_solve_batched
from sunode_torch.problem import Problem
from sunode_torch.symode import cuda_codegen
from sunode_torch.symode.problem import SympyProblem

__all__ = ["make_batched_solve_fn", "BatchedSolve"]


def _poison_b(ys, status):
    return torch.where((status == 0)[:, None, None], ys, float("nan"))


def _structured_setup(problem, rhs, linear_solver, linear_solver_kwargs, options,
                      adjoint_options):
    """The Newton structure of both BDF solves, as
    ``sunode_tpu/wrappers/as_jax.py::_structured_setup``: ``(jac, options,
    adjoint_jac, adjoint_options)`` for ``linear_solver`` 'dense', 'band'
    (``linear_solver_kwargs`` with 'lower_bandwidth' and 'upper_bandwidth')
    or 'sparse' (the pattern ``linear_solver_kwargs['sparsity']`` or
    ``problem.jac_sparsity()``, 'permute' and 'border' for the plan).  The
    backward matrix is -J^T: the bandwidths swap, and the sparse plan is
    made on the transposed pattern.  Every function is batched over the
    trailing lane axis."""
    from sunode_torch.ops.banded import dense_to_banded

    kw = dict(linear_solver_kwargs or {})
    if linear_solver == "band":
        if "lower_bandwidth" not in kw or "upper_bandwidth" not in kw:
            raise ValueError(
                "linear_solver='band' requires linear_solver_kwargs with "
                "'lower_bandwidth' and 'upper_bandwidth'"
            )
        lb, ub = int(kw["lower_bandwidth"]), int(kw["upper_bandwidth"])
        options = options._replace(linear_solver="band", band_lower=lb, band_upper=ub)
        aj_dense = problem.make_adjoint_jac_dense()

        def adjoint_jac(t, y, lam, p):
            return dense_to_banded(aj_dense(t, y, lam, p), ub, lb)

        adjoint_options = adjoint_options._replace(
            linear_solver="band", band_lower=ub, band_upper=lb
        )
        return problem.make_banded_jac(lb, ub), options, adjoint_jac, adjoint_options
    if linear_solver == "sparse":
        from sunode_torch.ops.bbd import dense_to_packed
        from sunode_torch.ops.sparsity import SparsePlan, make_colored_banded_jac

        pattern = (
            np.asarray(kw["sparsity"], bool) if "sparsity" in kw else problem.jac_sparsity()
        )
        plans = [SparsePlan(pat, permute=kw.get("permute", True), border=kw.get("border", "auto"))
                 for pat in (pattern, pattern.T)]

        def fields(plan):
            return dict(linear_solver="sparse", band_lower=plan.lower, band_upper=plan.upper,
                        sparse_perm=plan.perm, sparse_border=plan.k_border)

        plan_b = plans[1]
        aj_dense = problem.make_adjoint_jac_dense()

        def adjoint_jac(t, y, lam, p):
            return dense_to_packed(aj_dense(t, y, lam, p), plan_b)

        return (make_colored_banded_jac(rhs, plans[0]), options._replace(**fields(plans[0])),
                adjoint_jac, adjoint_options._replace(**fields(plan_b)))
    if linear_solver != "dense":
        raise ValueError(
            f"linear_solver must be 'dense', 'band' or 'sparse', got {linear_solver!r}"
        )
    return problem.make_jac_dense(), options, problem.make_adjoint_jac_dense(), adjoint_options


class BatchedSolve:
    """``solve(t0, y0, p_sub, p_fix, tvals) -> ys``: y0 (B, n), p_sub (B, k)
    per lane; t0, tvals (n_t,) and p_fix (k2,) shared; ys (B, n_t, n), NaN on
    failed lanes.  Gradients flow to y0, p_sub, tvals and a tensor t0
    through ``torch.autograd``.  ``last_stats`` holds the stats of the latest
    forward (``'forward'``) and backward (``'backward'``) solves."""

    def __init__(self, problem: Problem, derivatives, options, adjoint_options,
                 method: str, interpolation: Optional[str], checkpoint_n: int,
                 linear_solver: str = "dense", linear_solver_kwargs: Optional[dict] = None):
        self.problem = problem
        self.rhs = problem.make_rhs()
        self.jac = self.adjoint_jac = None
        if method == "BDF":
            self.jac, options, self.adjoint_jac, adjoint_options = _structured_setup(
                problem, self.rhs, linear_solver, linear_solver_kwargs, options, adjoint_options
            )
        self.derivatives = derivatives
        self.options = options
        self.adjoint_options = adjoint_options
        self.method = method
        self.interpolation = interpolation
        # the checkpointed adjoints read the forward solve's recording
        # ('resolve' and 'transition' integrate y backward instead);
        # polynomial interpolation reads only (t, y) rows, so no fdot rows
        self.fwd_options = options
        if interpolation in ("hermite", "polynomial"):
            self.fwd_options = options._replace(save_steps=checkpoint_n)
            if interpolation == "polynomial":
                self.fwd_options = self.fwd_options._replace(hermite_order=3)
        self.n_deriv = problem.n_params
        self.last_stats: dict = {}
        self._device_systems: dict[tuple[str, torch.dtype], cuda_codegen.DeviceSystem] = {}

    def device_system(self, kind: str, device: torch.device, dtype=torch.float64):
        """The emitted right-hand side for the fused kernel, ``kind`` one of
        ``cuda_codegen``'s systems ('forward', 'transition', 'resolve',
        'staged_adjoint', and for forward sensitivities, which this wrapper
        does not differentiate through, 'sensitivity' and
        'staged_sensitivity', the entry points' solves), at the solve's
        ``dtype`` (float64 or float32: the kernel build of that type); None
        on CPU, and None for a problem that is not a ``SympyProblem`` (a
        ``TorchProblem`` has no symbolic form to emit), whose CUDA attempts
        then run the split kernels with the right-hand side in torch between
        them (``ops/adams_split.py``).  Decided by the problem's type, never
        by a failed emit."""
        if device.type != "cuda" or not isinstance(self.problem, SympyProblem):
            return None
        key = (kind, dtype)
        if key not in self._device_systems:
            emit = {
                "forward": cuda_codegen.forward_system,
                "transition": cuda_codegen.transition_system,
                "resolve": cuda_codegen.resolve_system,
                "staged_adjoint": cuda_codegen.staged_adjoint_system,
                "sensitivity": cuda_codegen.sensitivity_system,
                "staged_sensitivity": cuda_codegen.staged_sensitivity_system,
            }[kind]
            self._device_systems[key] = emit(self.problem, c_real(dtype))
        return self._device_systems[key]

    def combine(self, p_sub, p_fix):
        B = p_sub.shape[0]
        p_fix_b = torch.broadcast_to(p_fix, (B,) + tuple(p_fix.shape))
        return self.problem.params.combine(p_sub, p_fix_b)

    def forward_solve(self, t0, y0, p, tvals, options):
        if self.method == "BDF":
            res = bdf_solve_batched(
                self.rhs, self.jac, t0, y0, p, tvals, options, batched_fns=True
            )
        else:
            dtype = torch.promote_types(torch.as_tensor(y0).dtype, torch.float32)
            res = adams_solve_batched(
                self.rhs, t0, y0, p, tvals, options,
                batched_fns=True,
                device_system=self.device_system("forward", y0.device, dtype),
            )
        self.last_stats["forward"] = res.stats
        return res

    def __call__(self, t0, y0, p_sub, p_fix, tvals):
        inputs = (t0, y0, p_sub, p_fix, tvals)
        wants_grad = torch.is_grad_enabled() and any(
            torch.is_tensor(a) and a.requires_grad for a in inputs
        )
        if self.derivatives is None or not wants_grad:
            # the primal: no recording, as the reference's undifferentiated call
            # (per-lane grids included)
            with torch.no_grad():
                p = self.combine(p_sub, p_fix)
                res = self.forward_solve(t0, y0, p, tvals, self.options)
                return _poison_b(res.ys, res.status)
        if torch.as_tensor(tvals).ndim != 1:
            raise NotImplementedError(
                "make_batched_solve_fn: gradients through per-lane observation grids "
                "(tvals (B, n_t)) are not ported; the reference's adjoint takes shared tvals"
            )
        return _Adjoint.apply(self, *inputs)


class _Adjoint(torch.autograd.Function):
    """Forward solve, then the adjoint of the solver's interpolation."""

    @staticmethod
    def forward(ctx, solver: BatchedSolve, t0, y0, p_sub, p_fix, tvals):
        p = solver.combine(p_sub, p_fix)
        res = solver.forward_solve(t0, y0, p, tvals, solver.fwd_options)
        ys = _poison_b(res.ys, res.status)
        ctx.solver = solver
        ctx.t0 = t0
        ctx.saved = res.saved  # the recorded trajectory (checkpointed adjoint)
        ctx.tvals_is_tensor = torch.is_tensor(tvals)
        tvals_t = torch.as_tensor(tvals, dtype=ys.dtype, device=ys.device)
        ctx.save_for_backward(y0, p, p_fix, tvals_t, res.status, ys)
        return ys

    @staticmethod
    def backward(ctx, g):
        solver = ctx.solver
        y0, p, p_fix, tvals, status, ys_fwd = ctx.saved_tensors
        B = y0.shape[0]
        dtype = ys_fwd.dtype
        problem = solver.problem
        g = g.to(dtype).contiguous()
        if solver.interpolation == "transition":
            adj = adjoint_backward_transition_batched(
                solver.rhs,
                problem.make_adjoint_jac_dense(),
                problem.make_dfdp(),
                ctx.t0,
                tvals,
                g,
                p,
                solver.n_deriv,
                ys_fwd[:, -1, :],
                solver.adjoint_options,
                device_system=solver.device_system("transition", y0.device, dtype),
            )
        else:
            resolve = solver.interpolation == "resolve"
            device_system = None
            if solver.method == "ADAMS":
                kind = "resolve" if resolve else "staged_adjoint"
                device_system = solver.device_system(kind, y0.device, dtype)
            adj = adjoint_backward_batched(
                problem.make_adjoint_rhs(),
                solver.adjoint_jac,
                problem.make_adjoint_quad_rhs(),
                ctx.saved,
                ctx.t0,
                tvals,
                g,
                p,
                solver.n_deriv,
                solver.adjoint_options,
                method=solver.method,
                interpolation=solver.interpolation,
                rhs=solver.rhs if resolve else None,
                y_end=ys_fwd[:, -1, :] if resolve else None,
                device_system=device_system,
            )
        solver.last_stats["backward"] = dict(adj.stats, status=adj.status)
        bad = (status != 0) | (adj.status != 0)
        lam = torch.where(bad[:, None], float("nan"), adj.lamda)  # (B, n)
        quad = torch.where(bad[:, None], float("nan"), adj.quad)  # (B, k)

        d_tvals = None
        if ctx.tvals_is_tensor:
            # d/dtvals_i = sum_b g_bi . f(t_i, y_b(t_i)) on the emitted y
            n_t = tvals.shape[0]
            f_at = solver.rhs(
                tvals[:, None].expand(n_t, B),
                ys_fwd.permute(2, 1, 0),
                p.T[:, None, :],
            )  # (n, n_t, B)
            d_tvals = torch.einsum("bij,jib->i", g, f_at)
            d_tvals = torch.where(bad.any(), float("nan"), d_tvals)
        d_t0 = None
        if torch.is_tensor(ctx.t0):
            t0_b = torch.broadcast_to(ctx.t0.to(dtype), (B,))
            f0 = solver.rhs(t0_b, y0.T.to(dtype), p.T)  # (n, B)
            d_t0 = (-torch.sum(lam * f0.T)).reshape(ctx.t0.shape).to(ctx.t0.dtype)
        return None, d_t0, lam.to(y0.dtype), quad, torch.zeros_like(p_fix), d_tvals


def make_batched_solve_fn(
    problem: Problem,
    *,
    derivatives: Optional[str] = "adjoint",
    options: BDFOptions = BDFOptions(),
    adjoint_options: Optional[BDFOptions] = None,
    checkpoint_n: int = 1024,
    method: str = "BDF",
    adjoint_interpolation: str = "hermite",
    linear_solver: str = "dense",
    linear_solver_kwargs: Optional[dict] = None,
) -> BatchedSolve:
    """Batch-native differentiable solver; same signature and defaults as
    the JAX package's: ``derivatives=None`` or ``'adjoint'`` with
    ``method='BDF'`` and ``adjoint_interpolation`` 'hermite' or
    'polynomial', and with ``method='ADAMS'`` and 'hermite', 'polynomial',
    'resolve' or 'transition'.  With 'hermite' and 'polynomial' the forward
    solve records ``checkpoint_n`` checkpoints when gradients are wanted.
    ``linear_solver`` 'dense' (the default), 'band' or 'sparse' with
    ``linear_solver_kwargs`` as the reference's (``method='BDF'`` only; see
    :func:`_structured_setup`).  Failed lanes come back NaN, and so do their
    gradients."""
    if method not in ("BDF", "ADAMS"):
        raise ValueError("method must be 'BDF' or 'ADAMS'")
    if linear_solver not in ("dense", "band", "sparse"):
        raise ValueError(
            "make_batched_solve_fn linear_solver must be 'dense', 'band' or 'sparse'"
        )
    if linear_solver != "dense" and method != "BDF":
        raise ValueError(
            f"linear_solver={linear_solver!r} requires method='BDF' (ADAMS uses "
            "functional iteration: no Newton matrices)"
        )
    if derivatives not in (None, "adjoint"):
        raise NotImplementedError(
            "batched solver supports derivatives='adjoint' or None"
        )
    if derivatives == "adjoint":
        if adjoint_interpolation not in ("hermite", "polynomial", "resolve", "transition"):
            raise ValueError(
                f"adjoint_interpolation must be 'hermite', 'polynomial', "
                f"'resolve' or 'transition', got {adjoint_interpolation!r}"
            )
        if adjoint_interpolation in ("resolve", "transition") and method != "ADAMS":
            raise ValueError(
                f"adjoint_interpolation={adjoint_interpolation!r} requires method='ADAMS'"
            )
    if adjoint_options is None:
        adjoint_options = BDFOptions(rtol=1e-10, atol=1e-10)
    interpolation = adjoint_interpolation if derivatives == "adjoint" else None
    return BatchedSolve(problem, derivatives, options, adjoint_options, method,
                        interpolation, checkpoint_n, linear_solver, linear_solver_kwargs)
