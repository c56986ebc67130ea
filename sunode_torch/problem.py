"""Problem abstraction: named ODE problems as functions on torch tensors.

PyTorch counterpart of ``sunode_tpu/problem.py``: the spec plumbing (named
states and params, derivative subset, coords), the autodiff defaults of the
base class and :class:`TorchProblem`.  Function signature conventions (flat
float tensors, optional trailing batch dimensions after the leading item
axes):

    rhs(t, y, p)              -> (n_states, ...)      dy/dt
    jac_dense(t, y, p)        -> (n, n, ...)          df/dy
    rhs_jac_prod(t, y, v, p)  -> (n, ...)             J @ v
    adjoint_rhs(t, y, lam, p) -> (n, ...)             -J^T @ lam
    adjoint_quad_rhs(t, y, lam, p) -> (n_deriv, ...)  lam^T @ df/dp_subset
    adjoint_jac_dense(t, y, lam, p) -> (n, n, ...)    -J^T
    dfdp(t, y, p)             -> (n, n_deriv, ...)    df/dp_subset
    banded_jac(t, y, p)       -> (l+u+1, n, ...)      df/dy in banded storage
    sensitivity_rhs(t, y, S, p) -> (n_deriv, n, ...)  S @ J^T + (df/dp_subset)^T
    root_fn(t, y, p)          -> (n_roots, ...)       event functions (make_root_fn)

where ``p`` is the full flat parameter vector and the derivative subset is
selected by ``self.params.subset_indices``.  The trailing batch dims of the
arguments broadcast against each other (``t`` has only batch dims).

A subclass only has to supply ``make_rhs``; every other factory defaults to
``torch.func`` autodiff of one lane of it (``jacfwd``, ``jvp``, ``vjp``)
mapped over the batch with ``torch.func.vmap``, as the JAX package's base
class defaults to ``jax.jacfwd``/``jvp``/``vjp``.  The adjoint pieces use
``vjp`` and never build J.  ``SympyProblem`` overrides them with
symbolically derived closed forms; :class:`TorchProblem` takes a right-hand
side written in torch on one lane's records and keeps the defaults.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from sunode_torch import forward_ad
from sunode_torch.paramspec import ParamSpec, Record

__all__ = ["Problem", "TorchProblem", "flat_solution_as_dict", "solution_to_xarray"]


def over_lanes(fn: Callable, item_ndims: Sequence[int]) -> Callable:
    """``fn`` of one lane mapped over the trailing batch dims of its arguments.

    Argument ``k`` has ``item_ndims[k]`` leading item dims and any trailing
    batch dims; the batch dims of all arguments broadcast against each other
    (aligned from the right), are flattened into one axis for
    ``torch.func.vmap`` and restored on the result, after its item dims;
    arguments without batch dims (one lane) go to ``fn`` as they are.
    A non-tensor argument (a float ``t``) takes the dtype and device of the
    first floating tensor."""

    def mapped(*args):
        ref = next(a for a in args if torch.is_tensor(a) and a.is_floating_point())
        args = [a if torch.is_tensor(a) else torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
                for a in args]
        batch = torch.broadcast_shapes(*(tuple(a.shape[k:]) for a, k in zip(args, item_ndims)))
        if not batch:  # one lane (the single-instance cores): no map needed
            return fn(*args)
        size = math.prod(batch)
        flat = []
        for a, k in zip(args, item_ndims):
            item = tuple(a.shape[:k])
            a = a.reshape(item + (1,) * (len(batch) + k - a.ndim) + tuple(a.shape[k:]))
            flat.append(a.expand(item + batch).reshape(item + (size,)))
        out = torch.func.vmap(fn, in_dims=-1, out_dims=-1)(*flat)
        return out.reshape(tuple(out.shape[:-1]) + batch)

    return mapped


def _subset_taker(indices) -> Callable:
    """``take(v)``: the derivative-subset entries of the last axis of ``v``;
    the index tensor is made once per device (no host copy per call)."""
    cache: dict[torch.device, torch.Tensor] = {}

    def take(v):
        idx = cache.get(v.device)
        if idx is None:
            idx = cache[v.device] = torch.as_tensor(np.asarray(indices, np.int64), device=v.device)
        return torch.index_select(v, -1, idx)

    return take


class Problem:
    """Base class for ODE problems.

    Attributes set up by ``_init_specs``:
      - ``states``: ParamSpec of the state variables
      - ``params``: ParamSpec of the parameters (with derivative subset)
      - ``coords``: resolved coordinates for named dims
    """

    states: ParamSpec
    params: ParamSpec
    coords: dict[str, np.ndarray]

    def _init_specs(
        self,
        params: Mapping[str, Any],
        states: Mapping[str, Any],
        derivative_params: Any = (),
        coords: Optional[Mapping[str, Any]] = None,
        dtype: Any = np.float64,
    ) -> None:
        self.params = ParamSpec(
            params, derivative_params or (), coords=coords, dtype=dtype
        )
        self.states = ParamSpec(states, (), coords=coords, dtype=dtype)
        self.coords = self.params.resolved_coords

    @property
    def n_states(self) -> int:
        return self.states.n_items

    @property
    def n_params(self) -> int:
        """Number of derivative parameters."""
        return self.params.subset_n_items

    @property
    def n_all_params(self) -> int:
        return self.params.n_items

    @property
    def state_dtype(self) -> np.dtype:
        return self.states.as_numpy_dtype()

    @property
    def params_dtype(self) -> np.dtype:
        return self.params.as_numpy_dtype()

    def flatten_state(self, nested: Mapping[str, Any], device=None):
        return self.states.flatten_dict(nested, device=device)

    def flatten_params(self, nested: Mapping[str, Any], device=None):
        return self.params.flatten_dict(nested, device=device)

    # ------------------------------------------------------------------
    # Factories.  Only make_rhs is abstract.
    # ------------------------------------------------------------------
    def make_rhs(self) -> Callable:
        raise NotImplementedError

    def _lane_rhs(self) -> Callable:
        """The right-hand side of one lane, ``(t (), y (n,), p (n_p,)) ->
        (n,)``, which the autodiff defaults differentiate: ``make_rhs``
        called without batch dims."""
        return self.make_rhs()

    def make_jac_dense(self) -> Callable:
        rhs = self._lane_rhs()

        def jac_dense(t, y, p):
            return forward_ad.jacfwd(rhs, argnums=1)(t, y, p)

        return over_lanes(jac_dense, (0, 1, 1))

    def make_rhs_jac_prod(self) -> Callable:
        rhs = self._lane_rhs()

        def jac_prod(t, y, v, p):
            return forward_ad.jvp(lambda y_: rhs(t, y_, p), (y,), (v,))[1]

        return over_lanes(jac_prod, (0, 1, 1, 1))

    def make_adjoint_rhs(self) -> Callable:
        """lamda_dot = -J^T lam, one pullback a lane."""
        rhs = self._lane_rhs()

        def adjoint_rhs(t, y, lam, p):
            _, pullback = torch.func.vjp(lambda y_: rhs(t, y_, p), y)
            return -pullback(lam)[0]

        return over_lanes(adjoint_rhs, (0, 1, 1, 1))

    def make_adjoint_quad_rhs(self) -> Callable:
        """quad_dot = lam^T df/dp_subset, one pullback a lane."""
        rhs = self._lane_rhs()
        take = _subset_taker(self.params.subset_indices)

        def adjoint_quad_rhs(t, y, lam, p):
            _, pullback = torch.func.vjp(lambda p_: rhs(t, y, p_), p)
            return take(pullback(lam)[0])

        return over_lanes(adjoint_quad_rhs, (0, 1, 1, 1))

    def make_adjoint_jac_dense(self) -> Callable:
        """Jacobian of the adjoint system: -J^T over the two leading axes."""
        jac = self.make_jac_dense()

        def adjoint_jac_dense(t, y, lam, p):
            return -jac(t, y, p).transpose(0, 1)

        return adjoint_jac_dense

    def _stripe_columns(self, width: int) -> Callable:
        """``cols(t, y, p) -> (width, n, ...)``: ``cols[s] = J @ seed_s`` with
        ``seed_s[j] = (j % width == s)``, one jvp of the right-hand side a
        stripe over every lane at once (each lane's tangent its own)."""
        rhs = self.make_rhs()
        n = self.n_states

        def cols(t, y, p):
            ar = torch.arange(n, device=y.device)
            out = []
            for s in range(width):
                seed = (ar % width == s).to(y.dtype).reshape((n,) + (1,) * (y.ndim - 1))
                tangent = seed.expand(y.shape)
                out.append(forward_ad.jvp(lambda y_: rhs(t, y_, p), (y,), (tangent,))[1])
            return torch.stack([torch.broadcast_to(c, y.shape) for c in out])

        return cols

    def make_banded_jac_dense(self, lower: int, upper: int) -> Callable:
        """df/dy from ``lower + upper + 1`` striped jvps instead of n: a dense
        ``(n, n, ...)`` matrix, exactly zero outside the band
        (``sunode_tpu/problem.py::make_banded_jac_dense``)."""
        n, width = self.n_states, lower + upper + 1
        cols = self._stripe_columns(width)

        def jac(t, y, p):
            c = cols(t, y, p)
            i = torch.arange(n, device=y.device)[:, None]
            j = torch.arange(n, device=y.device)[None, :]
            band = ((j - i <= upper) & (i - j <= lower)).reshape((n, n) + (1,) * (y.ndim - 1))
            return torch.where(band, c[(j % width).expand(n, n), i.expand(n, n)], 0.0)

        return jac

    def make_banded_jac(self, lower: int, upper: int) -> Callable:
        """df/dy in banded storage ``(lower+upper+1, n, ...)``, ``ab[u + i - j,
        j] = J[i, j]``, from ``lower + upper + 1`` striped jvps: the input of
        :func:`sunode_torch.ops.banded.banded_factor`, so a banded Newton
        solve never builds a dense matrix
        (``sunode_tpu/problem.py::make_banded_jac``)."""
        n, width = self.n_states, lower + upper + 1
        cols = self._stripe_columns(width)

        def jac(t, y, p):
            c = cols(t, y, p)
            j = torch.arange(n, device=y.device)[None, :]
            r = torch.arange(width, device=y.device)[:, None]
            i = j + r - upper
            valid = ((i >= 0) & (i < n)).reshape((width, n) + (1,) * (y.ndim - 1))
            return torch.where(valid, c[(j % width).expand(width, n), i.clamp(0, n - 1)], 0.0)

        return jac

    def jac_sparsity(self, n_probes: int = 3, seed: int = 0) -> np.ndarray:
        """Structural ``(n, n)`` boolean pattern of df/dy: the union of the
        nonzero (or non-finite) entries of the Jacobian at ``n_probes``
        random points, drawn as ``sunode_tpu/problem.py::jac_sparsity`` draws
        them.  Probabilistic: ``SympyProblem`` overrides it with the exact
        pattern of its symbolic Jacobian."""
        jac = self.make_jac_dense()
        n = self.n_states
        rng = np.random.default_rng(seed)
        pattern = np.zeros((n, n), bool)
        for _ in range(n_probes):
            y = torch.as_tensor(0.5 + rng.uniform(0.1, 1.0, n))
            p = torch.as_tensor(0.5 + rng.uniform(0.1, 1.0, self.n_all_params))
            t = torch.tensor(float(rng.uniform(0.1, 1.0)), dtype=torch.float64)
            J = torch.broadcast_to(jac(t, y, p), (n, n)).numpy()
            pattern |= ~(J == 0.0)
        return pattern

    def make_dfdp(self) -> Callable:
        """df/dp_subset with shape (n_states, n_deriv_params, ...)."""
        rhs = self._lane_rhs()
        take = _subset_taker(self.params.subset_indices)

        def dfdp(t, y, p):
            return take(forward_ad.jacfwd(lambda p_: rhs(t, y, p_))(p))

        return over_lanes(dfdp, (0, 1, 1))

    def make_sensitivity_rhs(self) -> Callable:
        """S_dot[k] = J @ S[k] + df/dp_k for each derivative param k, as
        ``S @ J^T + dfdp^T`` on each lane (the reference's form): ``(t, y,
        S (k, n, ...), p) -> (k, n, ...)``."""
        rhs = self._lane_rhs()
        take = _subset_taker(self.params.subset_indices)

        def sensitivity_rhs(t, y, S, p):
            J = forward_ad.jacfwd(rhs, argnums=1)(t, y, p)
            dfdp = take(forward_ad.jacfwd(lambda p_: rhs(t, y, p_))(p))
            return S @ J.T + dfdp.T

        return over_lanes(sensitivity_rhs, (0, 1, 2, 1))

    def make_root_fn(self, roots: Callable) -> Callable:
        """Lower a record-view event function to the flat ``(t, y, p) ->
        (nrt, ...)`` contract of the integrator cores (the counterpart of
        ``sunode_tpu/problem.py``'s): ``roots(t, y_record, p_record)`` on one
        lane returns a sequence or tensor of event-function values, and the
        result is mapped over the trailing batch dims as ``make_rhs`` is."""
        states, params = self.states, self.params

        def root_fn(t, y, p):
            out = roots(t, states.record(y), params.record(p))
            if isinstance(out, (list, tuple)):
                out = torch.stack([torch.as_tensor(g, dtype=y.dtype, device=y.device)
                                   for g in out])
            return torch.as_tensor(out, dtype=y.dtype, device=y.device).reshape(-1)

        return over_lanes(root_fn, (0, 1, 1))


    # ------------------------------------------------------------------
    # Solution conversion (the reference's problem.py:100-154)
    # ------------------------------------------------------------------
    def solution_to_xarray(self, tvals, solution, *, unstack_state=True, unstack_params=False,
                           params=None, sensitivity=None):
        return solution_to_xarray(self, tvals, solution, unstack_state=unstack_state,
                                  unstack_params=unstack_params, params=params,
                                  sensitivity=sensitivity)

    def flat_solution_as_dict(self, solution) -> dict[str, Any]:
        return flat_solution_as_dict(self, solution)


class TorchProblem(Problem):
    """An ODE problem whose right-hand side is written directly in torch.

    The counterpart of the JAX package's ``JaxProblem``: the user writes

        def rhs(t, y, p):
            return {'hares': p.alpha * y.hares - p.beta * y.lynx * y.hares,
                    'lynx': ...}

    for one lane, where ``y``/``p`` are attribute-access Records of tensors
    shaped as the specs say.  ``make_rhs`` maps it over the trailing batch
    dims with ``torch.func.vmap``, and every derivative comes from
    ``torch.func`` autodiff.  For large vector states this is the mode to
    use: the expressions stay vectorised instead of thousands of scalar
    assignments.

    On the card the batched Adams core runs such a problem through the
    split attempt (``ops/adams_split.py``): its right-hand side stays torch
    code between three kernels, as no device system is emitted for it.
    """

    def __init__(
        self,
        params: Mapping[str, Any],
        states: Mapping[str, Any],
        rhs: Callable[[Any, Record, Record], Mapping[str, Any]],
        derivative_params: Any = (),
        coords: Optional[Mapping[str, Any]] = None,
        dtype: Any = np.float64,
    ):
        self._init_specs(params, states, derivative_params, coords, dtype)
        self._user_rhs = rhs

    def _lane_rhs(self) -> Callable:
        states = self.states
        params = self.params
        user_rhs = self._user_rhs

        def rhs(t, y, p):
            out = user_rhs(t, states.record(y), params.record(p))
            if not isinstance(out, Mapping):
                raise TypeError("TorchProblem rhs must return a dict of state derivatives")
            # follow the input dtype: an f32 pipeline is not upcast here
            return states.flatten_dict(out, follow_dtype=True, device=y.device)

        return rhs

    def make_rhs(self) -> Callable:
        """``(t, y (n, ...), p (n_p, ...)) -> (n, ...)``: the user's
        right-hand side on every lane."""
        return over_lanes(self._lane_rhs(), (0, 1, 1))


# ---------------------------------------------------------------------------
# Output conversion (sunode_tpu/problem.py:337-400)
# ---------------------------------------------------------------------------
def flat_solution_as_dict(problem: Problem, solution) -> dict[str, Any]:
    """Split a ``(n_times, n_states)`` solution into named nested arrays by
    slicing and reshaping only, so ``solution`` may be numpy or torch."""
    from sunode_torch.paramspec import nest_path_dict

    flat = {}
    for path in problem.states.paths:
        s = problem.states.slices[path]
        flat[path] = solution[:, s].reshape((-1,) + problem.states.shapes[path])
    return nest_path_dict(flat)


def _as_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def solution_to_xarray(problem: Problem, tvals, solution, *, unstack_state: bool = True,
                       unstack_params: bool = False, params=None, sensitivity=None):
    """A flat solution as an ``xarray.Dataset`` with named dims and coords;
    the fallback :class:`sunode_torch.dataset.Dataset` when xarray does not
    import.  Tensors are copied to numpy."""
    try:
        import xarray as xr  # type: ignore
    except ImportError:
        from sunode_torch import dataset as xr  # type: ignore
    from sunode_torch.paramspec import flatten_path_dict

    solution = _as_numpy(solution)
    data = {}
    coords: dict[str, Any] = {"time": _as_numpy(tvals)}
    for dim, vals in problem.coords.items():
        coords[dim] = np.asarray(vals)
    if unstack_state:
        for path, arr in flatten_path_dict(problem.states.unflatten(solution)).items():
            data["solution_" + "_".join(path)] = (("time",) + problem.states.dims_for(path), arr)
    else:
        data["solution"] = (("time", "state"), solution)
    if params is not None and unstack_params:
        named_p = problem.params.unflatten(_as_numpy(params))
        for path, arr in flatten_path_dict(named_p).items():
            data["parameter_" + "_".join(path)] = (problem.params.dims_for(path), arr)
    if sensitivity is not None:
        data["sensitivity"] = (("time", "dparam", "state"), _as_numpy(sensitivity))
    return xr.Dataset(data, coords=coords)
