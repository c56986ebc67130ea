"""PyTensor/PyMC integration: differentiate through the port's ODE solvers.

Port of ``sunode_tpu/wrappers/as_pytensor.py``, itself an API-compatible
rebuild of the reference wrapper (sunode's ``wrappers/as_pytensor.py``):
the same ``solve_ivp`` entry point and Op structure (``SolveODE``,
``SolveODEAdjoint``, ``SolveODEAdjointBackward``, ``EvalRhs``), so PyMC
models written against sunode work unchanged.  Each ``perform`` runs the
port's class API (:class:`~sunode_torch.solver.Solver`,
:class:`~sunode_torch.solver.AdjointSolver`) on the solver's ``device``:
the card unless ``solver_kwargs`` passes ``device="cpu"``; without a card
the default raises.

Import of pytensor is deferred so the rest of the package works without it;
without the real package, ``sunode_torch._compat.pt_shim.install()``
provides the Op protocol.

Semantics preserved:
  - auto-detection of derivative params as non-constant PyTensor variables;
  - the '__initial_values' pseudo-param trick in forward mode;
  - NaN-poisoning on solver failure, so NUTS rejects instead of crashing;
  - d/dtvals via right-hand-side evaluation (``EvalRhs``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from sunode_torch.paramspec import flatten_path_dict, nest_path_dict
from sunode_torch.solver import AdjointSolver, Solver, SolverError
from sunode_torch.symode.problem import SympyProblem

__all__ = [
    "solve_ivp",
    "SolveODE",
    "SolveODEAdjoint",
    "SolveODEAdjointBackward",
    "EvalRhs",
]


def _require_pytensor():
    try:
        import pytensor.tensor as pt
        from pytensor.graph.basic import Constant, Variable
        from pytensor.graph.op import Op
        from pytensor.gradient import grad_not_implemented
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "sunode_torch.wrappers.as_pytensor requires pytensor; install it, or "
            "call sunode_torch._compat.pt_shim.install() for the Op-protocol shim, or "
            "use sunode_torch.wrappers.as_torch for torch.autograd."
        ) from e
    return pt, Constant, Variable, Op, grad_not_implemented


def eval_rhs(solver, params, params_fixed, y, tvals) -> np.ndarray:
    """The problem's right-hand side at each row: ``y (n_t, n)`` at ``tvals
    (n_t,)`` with the solver's params after setting ``params`` (the
    derivative subset) and ``params_fixed`` (the rest); ``(n_t, n)``
    numpy.  It runs on the solver's device, one lane a row."""
    solver.set_derivative_params(params)
    solver.set_remaining_params(params_fixed)
    rhs = solver._rhs
    f_kw = dict(dtype=solver._torch_dtype, device=solver._device)
    t = torch.as_tensor(np.asarray(tvals), **f_kw)
    y = torch.as_tensor(np.asarray(y), **f_kw)
    p = torch.as_tensor(np.asarray(solver.get_params()), **f_kw)
    out = rhs(t, y.T, p[:, None].expand(-1, t.shape[0]))
    return out.T.cpu().numpy()


_ops_cache: dict = {}


def _build_ops():
    """Define the Op classes lazily (on first use) against pytensor."""
    if _ops_cache:
        return _ops_cache
    pt, Constant, Variable, Op, grad_not_implemented = _require_pytensor()

    class EvalRhs(Op):
        # params, params_fixed, y, tvals
        itypes = [pt.dvector, pt.dvector, pt.dmatrix, pt.dvector]
        otypes = [pt.dmatrix]

        __props__ = ("_solver_id",)

        def __init__(self, solver):
            self._solver = solver
            self._solver_id = id(solver)

        def perform(self, node, inputs, outputs):
            params, params_fixed, y, tvals = inputs
            outputs[0][0] = eval_rhs(self._solver, params, params_fixed, y, tvals)

    class SolveODE(Op):
        # y0, params, params_fixed, t0, tvals
        itypes = [pt.dvector, pt.dvector, pt.dvector, pt.dscalar, pt.dvector]
        # y_out, y_sens_out
        otypes = [pt.dmatrix, pt.dtensor3]

        __props__ = ("_solver_id",)

        def __init__(self, solver):
            self._solver = solver
            self._solver_id = id(solver)
            problem = solver._problem
            n_states, n_params = problem.n_states, problem.n_params

            # S0 rows: identity for '__initial_values' pseudo-params
            sens0 = np.zeros((n_params, n_states))
            pspec = problem.params
            sspec = problem.states
            for path in pspec.subset_paths:
                psl = pspec.subset_slices[path]
                if path and path[0] == "__initial_values":
                    state_path = tuple(path[1:])
                    ssl = sspec.slices[state_path]
                    n_items = psl.stop - psl.start
                    assert n_items == ssl.stop - ssl.start
                    for i in range(n_items):
                        sens0[psl.start + i, ssl.start + i] = 1.0
            self._sens0 = sens0

        def perform(self, node, inputs, outputs):
            y0, params, params_fixed, t0, tvals = inputs
            y_out, sens_out = self._solver.make_output_buffers(tvals)
            self._solver.set_derivative_params(params)
            self._solver.set_remaining_params(params_fixed)
            try:
                self._solver.solve(
                    t0, tvals, y0, y_out, sens0=self._sens0, sens_out=sens_out
                )
            except SolverError:
                y_out[...] = np.nan
                sens_out[...] = np.nan
            outputs[0][0] = y_out
            outputs[1][0] = sens_out

        def grad(self, inputs, g):
            g, g_grad = g
            _, params, params_fixed, t0, tvals = inputs
            assert str(g_grad) == "<DisconnectedType>"
            solution, sens = self(*inputs)
            return [
                pt.zeros_like(inputs[0]),
                pt.sum(g[:, None, :] * sens, (0, -1)),
                grad_not_implemented(self, 2, params_fixed),
                grad_not_implemented(self, 3, t0),
                (EvalRhs(self._solver)(params, params_fixed, solution, tvals) * g).sum(
                    -1
                ),
            ]

    class SolveODEAdjoint(Op):
        # y0, params, params_fixed, t0, tvals
        itypes = [pt.dvector, pt.dvector, pt.dvector, pt.dscalar, pt.dvector]
        otypes = [pt.dmatrix]

        __props__ = ("_solver_id",)

        def __init__(self, solver):
            self._solver = solver
            self._solver_id = id(solver)

        def perform(self, node, inputs, outputs):
            y0, params, params_fixed, t0, tvals = inputs
            y_out, grad_out, lamda_out = self._solver.make_output_buffers(tvals)
            self._solver.set_derivative_params(params)
            self._solver.set_remaining_params(params_fixed)
            try:
                self._solver.solve_forward(t0, tvals, y0, y_out)
            except SolverError:
                y_out[:] = np.nan
            outputs[0][0] = y_out.copy()

        def grad(self, inputs, g):
            (g,) = g
            y0, params, params_fixed, t0, tvals = inputs
            solution = self(*inputs)
            backward = SolveODEAdjointBackward(self._solver)
            lamda, gradient = backward(y0, params, params_fixed, g, t0, tvals)
            return [
                -lamda,
                gradient,
                grad_not_implemented(self, 2, params_fixed),
                grad_not_implemented(self, 3, t0),
                (EvalRhs(self._solver)(params, params_fixed, solution, tvals) * g).sum(
                    -1
                ),
            ]

    class SolveODEAdjointBackward(Op):
        # y0, params, params_fixed, g, t0, tvals
        itypes = [pt.dvector, pt.dvector, pt.dvector, pt.dmatrix, pt.dscalar, pt.dvector]
        otypes = [pt.dvector, pt.dvector]

        __props__ = ("_solver_id",)

        def __init__(self, solver):
            self._solver = solver
            self._solver_id = id(solver)

        def perform(self, node, inputs, outputs):
            y0, params, params_fixed, grads, t0, tvals = inputs
            y_out, grad_out, lamda_out = self._solver.make_output_buffers(tvals)
            self._solver.set_derivative_params(params)
            self._solver.set_remaining_params(params_fixed)
            # the forward solve is repeated rather than cached, as the
            # reference does
            try:
                self._solver.solve_forward(t0, tvals, y0, y_out)
                self._solver.solve_backward(
                    tvals[-1], t0, tvals, grads, grad_out, lamda_out
                )
            except SolverError:
                lamda_out[:] = np.nan
                grad_out[:] = np.nan
            outputs[0][0] = lamda_out
            outputs[1][0] = grad_out

    _ops_cache.update(
        EvalRhs=EvalRhs,
        SolveODE=SolveODE,
        SolveODEAdjoint=SolveODEAdjoint,
        SolveODEAdjointBackward=SolveODEAdjointBackward,
    )
    return _ops_cache


def __getattr__(name):
    if name in ("EvalRhs", "SolveODE", "SolveODEAdjoint", "SolveODEAdjointBackward"):
        return _build_ops()[name]
    raise AttributeError(name)


def solve_ivp(
    t0: float,
    y0: Dict[str, Any],
    params: Dict[str, Any],
    tvals: np.ndarray,
    rhs: Callable,
    derivatives: str = "adjoint",
    coords: Optional[Dict[str, Any]] = None,
    make_solver=None,
    derivative_subset=None,
    solver_kwargs=None,
    simplify=None,
) -> Any:
    """The reference's entry point.

    ``y0``/``params`` are nested dicts of ``(tensor_or_value, shape)`` pairs
    or bare numpy values; gradients flow to every non-constant PyTensor
    variable among the params (and to y0 via the adjoint / the
    '__initial_values' trick in forward mode).  ``solver_kwargs`` go to
    ``AdjointSolver`` (``derivatives='adjoint'``) or ``Solver``
    (``'forward'``, which needs ``sens_mode``), ``device`` among them: the
    card by default.  Returns the reference's tuples.
    """
    pt, Constant, Variable, Op, grad_not_implemented = _require_pytensor()
    ops = _build_ops()

    if solver_kwargs is None:
        solver_kwargs = {}

    if derivatives == "forward":
        params = dict(params)
        params["__initial_values"] = y0

    def read_shapes(vals):
        out = {}
        for path, leaf in flatten_path_dict(vals).items():
            if isinstance(leaf, tuple):
                _, shape = leaf
                if isinstance(shape, (str, int)):
                    shape = (shape,)
                out[path] = tuple(shape)
            else:
                arr = np.asarray(leaf)
                out[path] = tuple(arr.shape)
        return out

    y0_shapes = nest_path_dict(read_shapes(y0))
    params_shapes = nest_path_dict(read_shapes(params))

    flat_params = flatten_path_dict(params)
    if derivative_subset is None:
        derivative_subset = []
        for path, val in flat_params.items():
            tensor = val[0] if isinstance(val, tuple) else val
            if isinstance(tensor, Variable) and not isinstance(tensor, Constant):
                derivative_subset.append(path)

    problem = SympyProblem(
        params_shapes,
        y0_shapes,
        rhs,
        derivative_subset,
        coords=coords,
        simplify=simplify,
    )

    def concat_paths(flat_tensors, paths):
        vars_ = []
        for path in paths:
            tensor = flat_tensors[path]
            if isinstance(tensor, tuple):
                tensor = tensor[0]
            vars_.append(
                pt.as_tensor_variable(tensor, dtype="float64").reshape((-1,))
            )
        if vars_:
            return pt.concatenate(vars_)
        return pt.as_tensor_variable(np.zeros(0), dtype="float64")

    params_subs_flat = concat_paths(flat_params, problem.params.subset_paths)
    remainder_paths = [
        p for p in problem.params.paths if p not in problem.params.subset_paths
    ]
    params_remaining_flat = concat_paths(flat_params, remainder_paths)
    y0_flat = concat_paths(flatten_path_dict(y0), problem.states.paths)

    t0 = pt.as_tensor_variable(np.float64(t0), dtype="float64")
    tvals = pt.as_tensor_variable(tvals, dtype="float64")

    if derivatives == "adjoint":
        sol = (make_solver or AdjointSolver)(problem, **solver_kwargs)
        wrapper = ops["SolveODEAdjoint"](sol)
        flat_solution = wrapper(y0_flat, params_subs_flat, params_remaining_flat, t0, tvals)
        solution = problem.flat_solution_as_dict(flat_solution)
        return solution, flat_solution, problem, sol, y0_flat, params_subs_flat
    elif derivatives == "forward":
        if "sens_mode" not in solver_kwargs:
            raise ValueError(
                'When `derivatives="forward"`, the `solver_kwargs` must contain '
                'one of `sens_mode={"simultaneous" | "staggered"}`.'
            )
        sol = (make_solver or Solver)(problem, **solver_kwargs)
        wrapper = ops["SolveODE"](sol)
        flat_solution, flat_sens = wrapper(
            y0_flat, params_subs_flat, params_remaining_flat, t0, tvals
        )
        solution = problem.flat_solution_as_dict(flat_solution)
        return (
            solution,
            flat_solution,
            problem,
            sol,
            y0_flat,
            params_subs_flat,
            flat_sens,
            wrapper,
        )
    elif derivatives in (None, False):
        # the solver is built first, as the reference builds it, so its own
        # refusals (an unknown option, a card that is not there) come first
        (make_solver or Solver)(problem, **solver_kwargs)
        raise NotImplementedError(
            "derivatives=None is not wired for the PyTensor wrapper "
            "(the reference asserts False here too); "
            "use derivatives='adjoint' or 'forward'."
        )
    raise ValueError(f"Unknown derivatives mode {derivatives!r}")
