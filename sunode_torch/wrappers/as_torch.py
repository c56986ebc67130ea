"""Differentiable solves as ``torch.autograd.Function``s: the single-chain
functional surface and the batched solve.

Port of ``sunode_tpu/wrappers/as_jax.py``.  The single-chain surface:

* :func:`make_solve_fn` -- ``solve(t0, y0, p_sub, p_fix, tvals) -> ys (n_t,
  n)`` through the single-instance BDF core (``ops/bdf.py::bdf_solve``),
  with ``derivatives`` None, 'adjoint' (the forward solve records
  ``checkpoint_n`` checkpoints and the backward is
  ``adjoint.py::adjoint_backward``, 'hermite' or 'polynomial') or
  'forward' (sensitivities of the augmented ``[params | initial values]``
  block); gradients to t0, y0, p_sub and tvals, zero to p_fix;
* :func:`solve_lanes` -- per-lane observation grids with gradients, a loop
  over lanes of such a solve through :func:`map_lanes`, the lane loop of any
  single-chain function (the counterpart of the reference's ``vmap``);
* :func:`solve_ivp` and :class:`SolveResult` -- declare and solve in one
  call, gradients through ``torch.autograd`` to every parameter given as a
  tensor that requires them.

The batched solve, :func:`make_batched_solve_fn`:

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
raises ``NotImplementedError`` that names :func:`solve_lanes`, as the
reference routes that case through the single-chain solve.

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

from typing import Any, Callable, Mapping, NamedTuple, Optional

import numpy as np
import torch

from sunode_torch.adjoint import (
    adjoint_backward,
    adjoint_backward_batched,
    adjoint_backward_transition_batched,
    make_hermite_eval,
)
from sunode_torch.ops.adams_attempt import c_real
from sunode_torch.ops.adams_batched import adams_solve_batched
from sunode_torch.ops.bdf import BDFOptions, bdf_solve
from sunode_torch.ops.bdf_batched import bdf_solve_batched
from sunode_torch.parallel.mesh import Mesh, StateShards, run_on_devices, shard_over_chains
from sunode_torch.parallel.rows import RowLayout
from sunode_torch.problem import Problem
from sunode_torch.symode import cuda_codegen
from sunode_torch.symode.problem import SympyProblem

__all__ = [
    "make_solve_fn",
    "SolveFn",
    "solve_lanes",
    "map_lanes",
    "solve_ivp",
    "SolveResult",
    "make_batched_solve_fn",
    "BatchedSolve",
]


def _poison(ys, status):
    return ys if status == 0 else torch.full_like(ys, float("nan"))


def _poison_b(ys, status):
    return torch.where((status == 0)[:, None, None], ys, float("nan"))


def _wants_grad(inputs) -> bool:
    return torch.is_grad_enabled() and any(torch.is_tensor(a) and a.requires_grad for a in inputs)


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
    forward (``'forward'``) and backward (``'backward'``) solves.

    ``y0`` may be a :class:`~sunode_torch.parallel.mesh.StateShards` (the
    state axis, ``shard_batch_state`` over a 2-D mesh; ``method='ADAMS'``,
    a problem with no emitted system, 'hermite', 'polynomial' or 'resolve',
    float64): each chain group solves with its state rows split over its row
    of the mesh, a host thread a group, ``p_sub`` cut over the chain axis,
    ``ys`` gathered on the mesh's first device; ``last_stats['chain_groups']``
    holds each group's stats."""

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

    def forward_solve(self, t0, y0, p, tvals, options, rows=None, stats=None):
        """The forward solve; ``rows`` a chain group's state-split layout,
        ``stats`` a dict its stats go to beside ``last_stats``."""
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
                rows=rows,
            )
        self.last_stats["forward"] = res.stats
        if stats is not None:
            stats["forward"] = res.stats
        return res

    def _check_state_split(self, y0: StateShards, tvals) -> None:
        """Refuse, by type and options and before any solve, what the state
        split does not take."""
        def refuse(what):
            raise ValueError(f"make_batched_solve_fn: a StateShards y0 (the state split) does not "
                             f"take {what}; ROADMAP A queues it")

        if self.method != "ADAMS":
            refuse("method='BDF' (it runs on the Adams core's split attempt)")
        if isinstance(self.problem, SympyProblem):
            refuse("a SympyProblem (its emitted history kernel holds the whole state in one "
                   "thread a lane)")
        if self.interpolation == "transition":
            refuse("adjoint_interpolation='transition'")
        if y0.dtype != torch.float64:
            refuse(f"{y0.dtype} (it runs at float64)")
        if self.options.constraints is not None:
            refuse("constraints")
        if torch.as_tensor(tvals).ndim != 1:
            refuse("per-lane observation grids")

    def _state_split(self, t0, y0: StateShards, p_sub, p_fix, tvals):
        """The solve of a :class:`StateShards` ``y0``: each chain group's
        state-split solve on its row of the mesh, a host thread a group
        (``map_over_chains``'s rule), ``ys`` concatenated on the mesh's
        first device; differentiable in every group."""
        self._check_state_split(y0, tvals)
        mesh = y0.mesh
        homes = tuple(row[0] for row in mesh.grid)
        p_subs = shard_over_chains(Mesh(homes), p_sub)  # cut as map_over_chains cuts it
        self.last_stats["chain_groups"] = groups = [{} for _ in homes]

        def on(x, dev):
            return x.to(dev) if torch.is_tensor(x) else x

        args = []
        for i, home in enumerate(homes):
            rows = RowLayout.contiguous(mesh.grid[i], [b.shape[1] for b in y0.blocks[i]])
            args.append((on(t0, home), y0.gathered(i), p_subs[i], on(torch.as_tensor(p_fix), home),
                         on(tvals, home), rows, groups[i]))
        ys = run_on_devices([self._solve_group] * len(homes), homes, args)
        return torch.cat([y.to(mesh.devices[0]) for y in ys])

    def _solve_group(self, t0, y0, p_sub, p_fix, tvals, rows, stats):
        if self.derivatives is None or not _wants_grad((t0, y0, p_sub, p_fix, tvals)):
            with torch.no_grad():
                res = self.forward_solve(t0, y0, self.combine(p_sub, p_fix), tvals, self.options,
                                         rows, stats)
                return _poison_b(res.ys, res.status)
        return _Adjoint.apply(self, t0, y0, p_sub, p_fix, tvals, rows, stats)

    def __call__(self, t0, y0, p_sub, p_fix, tvals):
        if isinstance(y0, StateShards):
            return self._state_split(t0, y0, p_sub, p_fix, tvals)
        inputs = (t0, y0, p_sub, p_fix, tvals)
        if self.derivatives is None or not _wants_grad(inputs):
            # the primal: no recording, as the reference's undifferentiated call
            # (per-lane grids included)
            with torch.no_grad():
                p = self.combine(p_sub, p_fix)
                res = self.forward_solve(t0, y0, p, tvals, self.options)
                return _poison_b(res.ys, res.status)
        if torch.as_tensor(tvals).ndim != 1:
            raise NotImplementedError(
                "make_batched_solve_fn: gradients through per-lane observation grids "
                "(tvals (B, n_t)) go lane by lane, as the reference routes them through "
                "vmap of its single-chain solve: use sunode_torch.wrappers.as_torch."
                "solve_lanes(make_solve_fn(problem, ...), t0, y0, p_sub, p_fix, tvals)"
            )
        return _Adjoint.apply(self, *inputs)


class _Adjoint(torch.autograd.Function):
    """Forward solve, then the adjoint of the solver's interpolation."""

    @staticmethod
    def forward(ctx, solver: BatchedSolve, t0, y0, p_sub, p_fix, tvals, rows=None, stats=None):
        p = solver.combine(p_sub, p_fix)
        ctx.stats = stats
        res = solver.forward_solve(t0, y0, p, tvals, solver.fwd_options, rows, stats)
        ys = _poison_b(res.ys, res.status)
        ctx.rows = rows
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
                rows=ctx.rows,
            )
        solver.last_stats["backward"] = dict(adj.stats, status=adj.status)
        if ctx.stats is not None:
            ctx.stats["backward"] = solver.last_stats["backward"]
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
        return (None, d_t0, lam.to(y0.dtype), quad, torch.zeros_like(p_fix), d_tvals, None,
                None)


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


# ---------------------------------------------------------------------------
# The single-chain functional surface
# ---------------------------------------------------------------------------
class SolveFn:
    """``solve(t0, y0, p_sub, p_fix, tvals) -> ys (n_t, n)`` for one chain
    (:func:`make_solve_fn`): y0 (n,), p_sub (k,), p_fix (k2,), tvals (n_t,);
    a failed solve returns NaN and so do its gradients.  The solve runs on
    y0's device; gradients flow to a tensor t0, y0, p_sub and a tensor
    tvals through ``torch.autograd``, and p_fix's is zero.  ``last_stats``
    holds the latest forward (``'forward'``) and backward (``'backward'``)
    solve's stats, each with its ``status``."""

    def __init__(self, problem: Problem, derivatives, options, adjoint_options,
                 checkpoint_n: int, interpolation: str, linear_solver: str,
                 linear_solver_kwargs: Optional[dict]):
        self.problem = problem
        self.rhs = problem.make_rhs()
        self.jac, self.options, self.adjoint_jac, self.adjoint_options = _structured_setup(
            problem, self.rhs, linear_solver, linear_solver_kwargs, options, adjoint_options
        )
        self.derivatives = derivatives
        self.interpolation = interpolation
        self.n_deriv = problem.n_params
        self.fwd_options = self.options._replace(save_steps=checkpoint_n)
        if interpolation == "polynomial":
            # polynomial interpolation reads only (t, y) rows
            self.fwd_options = self.fwd_options._replace(hermite_order=3)
        if derivatives == "forward":
            self._jac_dense = problem.make_jac_dense()
            self._dfdp = problem.make_dfdp()
        self.last_stats: dict = {}

    def combine(self, p_sub, p_fix):
        return self.problem.params.combine(p_sub, p_fix)

    def _sens_rhs_aug(self, t, y, S, p):
        """Sensitivities of the augmented block: rows ``[0:k]`` the
        parameters', rows ``[k:k+n]`` the initial values' (the reference's
        '__initial_values' rows): ``S J^T + [df/dp^T ; 0]``."""
        n, k = y.shape[0], self.n_deriv
        J = torch.broadcast_to(self._jac_dense(t, y, p), (n, n))
        extra = torch.cat([torch.broadcast_to(self._dfdp(t, y, p), (n, k)).T,
                           torch.zeros((n, n), dtype=S.dtype, device=S.device)])
        return S @ J.T + extra

    def solve_primal(self, t0, y0, p, tvals, options):
        res = bdf_solve(self.rhs, self.jac, t0, y0, p, tvals, options)
        self.last_stats["forward"] = dict(res.stats, status=res.status)
        return res

    def run_forward(self, t0, y0, p, tvals):
        """The 'forward' mode's solve: ``(ys, sens (n_t, k + n, n))``, both
        NaN on failure."""
        n, k = y0.shape[0], self.n_deriv
        S0 = torch.cat([torch.zeros((k, n), dtype=y0.dtype, device=y0.device),
                        torch.eye(n, dtype=y0.dtype, device=y0.device)])
        res = bdf_solve(self.rhs, self.jac, t0, y0, p, tvals, self.options,
                        sens_rhs=self._sens_rhs_aug, S0=S0)
        self.last_stats["forward"] = dict(res.stats, status=res.status)
        return _poison(res.ys, res.status), _poison(res.sens, res.status)

    def __call__(self, t0, y0, p_sub, p_fix, tvals):
        inputs = (t0, y0, p_sub, p_fix, tvals)
        wants_grad = torch.is_grad_enabled() and any(
            torch.is_tensor(a) and a.requires_grad for a in inputs
        )
        if self.derivatives is None or not wants_grad:
            with torch.no_grad():
                y0 = torch.as_tensor(y0)
                p = self.combine(torch.as_tensor(p_sub, device=y0.device),
                                 torch.as_tensor(p_fix, device=y0.device))
                if self.derivatives == "forward":
                    return self.run_forward(t0, y0, p, tvals)[0]
                res = self.solve_primal(t0, y0, p, tvals, self.options)
                return _poison(res.ys, res.status)
        fn = _SingleForward if self.derivatives == "forward" else _SingleAdjoint
        return fn.apply(self, *inputs)


def _tensor_t(t, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def _rhs_at(solver: SolveFn, tvals: torch.Tensor, ys: torch.Tensor, p: torch.Tensor):
    """``f(t_i, ys_i)`` for every row, ``(n_t, n)``: one call of the
    right-hand side over the trailing batch of the observation times."""
    return torch.broadcast_to(solver.rhs(tvals, ys.T, p[:, None]), ys.T.shape).T


class _SingleAdjoint(torch.autograd.Function):
    """The forward solve with checkpoints, then the checkpointed adjoint."""

    @staticmethod
    def forward(ctx, solver: SolveFn, t0, y0, p_sub, p_fix, tvals):
        p = solver.combine(p_sub, p_fix)
        res = solver.solve_primal(t0, y0, p, tvals, solver.fwd_options)
        ys = _poison(res.ys, res.status)
        ctx.solver, ctx.t0, ctx.saved, ctx.status = solver, t0, res.saved, res.status
        ctx.save_for_backward(y0, p, p_fix, _tensor_t(tvals, ys))
        return ys

    @staticmethod
    def backward(ctx, g):
        solver = ctx.solver
        y0, p, p_fix, tvals = ctx.saved_tensors
        g = g.to(p.dtype)
        problem = solver.problem
        adj = adjoint_backward(
            problem.make_adjoint_rhs(), solver.adjoint_jac, problem.make_adjoint_quad_rhs(),
            ctx.saved, float(ctx.t0), tvals, g, p, solver.n_deriv, solver.adjoint_options,
            interpolation=solver.interpolation,
        )
        solver.last_stats["backward"] = dict(adj.stats, status=adj.status)
        bad = ctx.status != 0 or adj.status != 0
        lam, quad = _poison(adj.lamda, int(bad)), _poison(adj.quad, int(bad))
        d_tvals = d_t0 = None
        if ctx.needs_input_grad[5]:
            # d/dtvals_i = g_i . f(t_i, y(t_i)), y from the Hermite table
            f_at = _rhs_at(solver, tvals, make_hermite_eval(ctx.saved)(tvals), p)
            d_tvals = _poison(torch.sum(g * f_at, dim=1), int(bad))
        if ctx.needs_input_grad[1]:
            # dL/dt0 = -lambda(t0)^T f(t0, y0)
            f0 = solver.rhs(_tensor_t(ctx.t0, y0).to(p.dtype), y0.to(p.dtype), p)
            d_t0 = (-torch.dot(lam, f0)).to(ctx.t0.dtype)
        return None, d_t0, lam.to(y0.dtype), quad, torch.zeros_like(p_fix), d_tvals


class _SingleForward(torch.autograd.Function):
    """The solve with forward sensitivities, the gradient by contraction."""

    @staticmethod
    def forward(ctx, solver: SolveFn, t0, y0, p_sub, p_fix, tvals):
        p = solver.combine(p_sub, p_fix)
        ys, sens = solver.run_forward(t0, y0, p, tvals)
        tv = _tensor_t(tvals, ys)
        f_at = _rhs_at(solver, tv, ys, p)
        f0 = solver.rhs(_tensor_t(t0, ys), y0.to(ys.dtype), p)
        ctx.t0 = t0
        ctx.save_for_backward(sens, f_at, f0, p_fix, y0)
        return ys

    @staticmethod
    def backward(ctx, g):
        sens, f_at, f0, p_fix, y0 = ctx.saved_tensors
        k = sens.shape[1] - y0.shape[0]
        g = g.to(sens.dtype)
        # dL/dp_k = sum_i g_i . S_k(t_i)
        contr = torch.einsum("ij,ikj->k", g, sens)
        d_y0 = contr[k:]
        d_tvals = torch.sum(g * f_at, dim=1) if ctx.needs_input_grad[5] else None
        d_t0 = (-torch.dot(d_y0, f0)).to(ctx.t0.dtype) if ctx.needs_input_grad[1] else None
        return None, d_t0, d_y0.to(y0.dtype), contr[:k], torch.zeros_like(p_fix), d_tvals


def make_solve_fn(
    problem: Problem,
    *,
    derivatives: Optional[str] = "adjoint",
    options: BDFOptions = BDFOptions(),
    adjoint_options: Optional[BDFOptions] = None,
    checkpoint_n: int = 4096,
    adjoint_interpolation: str = "hermite",
    linear_solver: str = "dense",
    linear_solver_kwargs: Optional[dict] = None,
) -> SolveFn:
    """The single-chain differentiable solve, same signature and defaults as
    the JAX package's (``sunode_tpu/wrappers/as_jax.py::make_solve_fn``):
    ``derivatives`` None, 'adjoint' (the checkpointed adjoint over
    ``checkpoint_n`` recorded steps, ``adjoint_interpolation`` 'hermite' or
    'polynomial', backward tolerances 1e-10 unless ``adjoint_options``) or
    'forward' (forward sensitivities, the gradient by contraction; the
    Newton solves keep the structured solver, the sensitivity right-hand
    side the dense Jacobian).  ``linear_solver`` 'dense', 'band' or
    'sparse' with ``linear_solver_kwargs`` as :func:`_structured_setup`
    reads them; the backward matrix -J^T gets the transposed structure."""
    if derivatives not in (None, "adjoint", "forward"):
        raise ValueError(
            f"derivatives must be 'adjoint', 'forward' or None, got {derivatives!r}"
        )
    if adjoint_interpolation not in ("hermite", "polynomial"):
        raise ValueError(
            f"interpolation must be 'hermite' or 'polynomial', got {adjoint_interpolation!r}"
        )
    if adjoint_options is None:
        adjoint_options = BDFOptions(rtol=1e-10, atol=1e-10)
    return SolveFn(problem, derivatives, options, adjoint_options, checkpoint_n,
                   adjoint_interpolation, linear_solver, linear_solver_kwargs)


def solve_lanes(solve: Callable, t0, y0, p_sub, p_fix, tvals) -> torch.Tensor:
    """Per-lane solves with gradients: ``ys (B, n_t, n)`` for y0 (B, n),
    p_sub (B, k), t0 shared or ``(B,)`` and tvals shared ``(n_t,)`` or per
    lane ``(B, n_t)``; ``solve`` is a :func:`make_solve_fn` solve, called
    once a lane through :func:`map_lanes`, so ``torch.autograd`` takes each
    lane's gradient through its own solve.  The port's counterpart of the
    reference's ``jax.vmap(make_solve_fn(...))``."""
    per_t0 = torch.is_tensor(t0) and t0.ndim == 1
    per_tv = torch.as_tensor(tvals).ndim == 2
    return map_lanes(solve, t0, y0, p_sub, p_fix, tvals,
                     in_dims=(0 if per_t0 else None, 0, 0, None, 0 if per_tv else None))


def _lane(x, b: int, batched: bool):
    return x[b] if batched else x


def _stack_lanes(outs: list):
    first = outs[0]
    if isinstance(first, tuple):
        stacked = [_stack_lanes([o[i] for o in outs]) for i in range(len(first))]
        return type(first)(*stacked) if hasattr(first, "_fields") else tuple(stacked)
    return torch.stack([torch.as_tensor(o) for o in outs])


def map_lanes(fn: Callable, *args, in_dims) -> Any:
    """``fn`` of one chain over a batch, lane by lane: argument ``i`` is
    split along its leading axis where ``in_dims[i]`` is 0 and shared where
    it is None (the ``in_axes`` of ``jax.vmap``); the outputs (tensors,
    tuples or named tuples such as :class:`HybridResult`) are stacked along
    a new leading axis.  The port's counterpart of the reference's ``vmap``
    of its single-chain functions (:func:`make_solve_fn`'s, and
    ``sunode_torch.events``' event and hybrid functions): a host loop whose
    exits depend on the data cannot be mapped by ``torch.func.vmap``.
    Gradients flow through each lane's own call."""
    sizes = {a.shape[0] for a, d in zip(args, in_dims) if d is not None}
    if len(sizes) != 1:
        raise ValueError(f"map_lanes: the mapped arguments need one batch size, got {sizes}")
    (B,) = sizes
    return _stack_lanes([fn(*(_lane(a, b, d is not None) for a, d in zip(args, in_dims)))
                         for b in range(B)])


class SolveResult(NamedTuple):
    solution: Mapping[str, Any]  # nested dict of named state tensors (n_t, ...)
    ys: torch.Tensor  # flat (n_t, n_states)
    problem: Problem
    solve_fn: Callable  # the differentiable flat solve


def solve_ivp(
    t0,
    y0: Mapping[str, Any],
    params: Mapping[str, Any],
    tvals,
    rhs: Callable,
    derivatives: Optional[str] = "adjoint",
    coords: Optional[Mapping[str, Any]] = None,
    derivative_params: Optional[list] = None,
    solver_kwargs: Optional[dict] = None,
    simplify: Optional[Callable] = None,
    use_sympy: bool = True,
    device="cuda",
) -> SolveResult:
    """Declare and solve an ODE in one call, differentiable through
    ``torch.autograd`` (``sunode_tpu/wrappers/as_jax.py::solve_ivp``).

    ``y0`` / ``params``: nested dicts whose leaves are ``(value, shape)``
    tuples or plain values (shape inferred).  ``derivative_params``: the
    paths to differentiate with respect to; None selects every parameter
    leaf given as a tensor that requires a gradient.  ``use_sympy=False``
    takes ``rhs`` as torch code on one lane's records (a
    :class:`~sunode_torch.problem.TorchProblem`).  ``solver_kwargs``:
    ``options`` (or ``rtol``/``atol``, default 1e-8), ``adjoint_options``,
    ``checkpoint_n``; any other key raises ``TypeError``.  The type follows
    the tensor and array leaves.  It runs on the card unless ``device="cpu"``;
    a leaf that is already a tensor keeps its device, which must be that
    one."""
    from sunode_torch.convert import device_or_raise
    from sunode_torch.paramspec import flatten_path_dict, nest_path_dict
    from sunode_torch.problem import TorchProblem

    dev = device_or_raise(device)
    solver_kwargs = dict(solver_kwargs or {})

    def split_leaves(nested):
        values, shapes = {}, {}
        for path, leaf in flatten_path_dict(nested).items():
            if isinstance(leaf, tuple) and len(leaf) == 2 and not isinstance(leaf[0], str):
                value, shape = leaf
                if isinstance(shape, (int, np.integer)):
                    shape = (int(shape),)
                shapes[path], values[path] = tuple(shape), value
            else:
                shapes[path] = tuple(leaf.shape) if torch.is_tensor(leaf) else np.shape(leaf)
                values[path] = leaf
        return values, shapes

    y0_values, y0_shapes = split_leaves(y0)
    p_values, p_shapes = split_leaves(params)
    if derivative_params is None:
        derivative_params = [p for p, v in p_values.items()
                             if torch.is_tensor(v) and v.requires_grad]
    if use_sympy:
        problem = SympyProblem(params=nest_path_dict(p_shapes), states=nest_path_dict(y0_shapes),
                               rhs_sympy=rhs, derivative_params=derivative_params,
                               coords=coords, simplify=simplify)
    else:
        problem = TorchProblem(params=nest_path_dict(p_shapes), states=nest_path_dict(y0_shapes),
                               rhs=rhs, derivative_params=derivative_params, coords=coords)

    options = solver_kwargs.pop("options", None) or BDFOptions(
        rtol=solver_kwargs.pop("rtol", 1e-8), atol=solver_kwargs.pop("atol", 1e-8)
    )
    solve_fn = make_solve_fn(
        problem, derivatives=derivatives, options=options,
        adjoint_options=solver_kwargs.pop("adjoint_options", None),
        checkpoint_n=solver_kwargs.pop("checkpoint_n", 4096),
    )
    if solver_kwargs:
        raise TypeError(f"Unknown solver_kwargs: {sorted(solver_kwargs)}")

    y0_flat = _flatten_traced(problem.states, y0_values, dev)
    p_sub = _flatten_subset_traced(problem.params, p_values, dev)
    p_fix = _flatten_remainder_traced(problem.params, p_values, dev)
    t0 = _leaf(t0, y0_flat.dtype, dev)
    tvals = _leaf(tvals, None, dev)
    ys = solve_fn(t0, y0_flat, p_sub, p_fix, tvals)
    return SolveResult(solution=problem.states.unflatten(ys), ys=ys, problem=problem,
                       solve_fn=solve_fn)


def _leaf(v, dtype, dev: torch.device) -> torch.Tensor:
    """A leaf as a tensor of ``dtype`` (None: its own) on ``dev``; a tensor
    keeps its device (and its graph) and must be on ``dev``."""
    if torch.is_tensor(v):
        if v.device.type != dev.type or (dev.index is not None and v.device.index != dev.index):
            raise ValueError(f"a tensor leaf is on {v.device}, the solve on {dev}")
        return v if dtype is None else v.to(dtype)
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)


def _traced_dtype(spec, values, paths) -> torch.dtype:
    """The type follows the tensor and array leaves (a float32 leaf runs the
    whole solve at float32); without a floating one, the spec's."""
    from sunode_torch.paramspec import torch_dtype

    found = [values[p].dtype if torch.is_tensor(values[p]) else torch_dtype(values[p].dtype)
             for p in paths if hasattr(values[p], "dtype")]
    if not found:
        return spec.torch_dtype
    out = found[0]
    for d in found[1:]:
        out = torch.promote_types(out, d)
    return out if out.is_floating_point else spec.torch_dtype


def _flatten_paths(spec, values, paths, dev) -> torch.Tensor:
    dtype = _traced_dtype(spec, values, paths)
    parts = [torch.broadcast_to(_leaf(values[p], dtype, dev), spec.shapes[p]).reshape(-1)
             for p in paths]
    if not parts:
        return torch.zeros((0,), dtype=spec.torch_dtype, device=dev)
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _flatten_traced(spec, values, dev) -> torch.Tensor:
    return _flatten_paths(spec, values, spec.paths, dev)


def _flatten_subset_traced(spec, values, dev) -> torch.Tensor:
    return _flatten_paths(spec, values, spec.subset_paths, dev)


def _flatten_remainder_traced(spec, values, dev) -> torch.Tensor:
    rem = [p for p in spec.paths if p not in spec.subset_paths]
    return _flatten_paths(spec, values, rem, dev)
