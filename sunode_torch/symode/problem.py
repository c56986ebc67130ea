"""Symbolically-defined ODE problems (sympy) lowered to torch.

PyTorch counterpart of ``sunode_tpu/symode/problem.py``.  The user writes
the right-hand side once as a sympy expression over named (nested) states
and params; the Jacobian, df/dp and the adjoint right-hand sides are derived
symbolically and lowered twice:

  * through :func:`sunode_torch.symode.lambdify.lambdify_torch` to torch
    functions with CSE preserved (the plain path, and every evaluation that
    is not inside a kernel);
  * through :mod:`sunode_torch.symode.cuda_codegen` to ``__device__``
    functions that are compiled into the CUDA PECE kernel.

The symbolic pieces the emitter needs are public: :attr:`sym_time`,
:attr:`sym_rhs` (f),
:attr:`sym_jac` (df/dy), :attr:`sym_dfdp` (df/dp over the derivative
subset) and :attr:`sym_sens` (the sensitivity symbols); with ``simplify=``
the first three are the simplified elements, the ones the plain path
lambdifies, so an emitted system computes what the plain one does.  Event
functions are lowered from sympy by :meth:`SympyProblem.make_root_fn`.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import numpy as np
import sympy as sy
import torch

from sunode_torch import problem as problem_mod
from sunode_torch.symode.lambdify import lambdify_torch

__all__ = ["SympyProblem"]


def _symbol_leaf(prefix: str, start: int, shape: tuple[int, ...]):
    """An object array (or bare symbol for scalars) of indexed real symbols."""
    if shape == ():
        return sy.Symbol(f"{prefix}{start}", real=True)
    flat = np.array(
        [sy.Symbol(f"{prefix}{start + k}", real=True) for k in range(int(np.prod(shape)))],
        dtype=object,
    )
    return flat.reshape(shape)


class SympyProblem(problem_mod.Problem):
    """Declare an ODE symbolically.

    Parameters
    ----------
    params, states:
        Nested ``{name: shape}`` specs (shape entries may be coord names).
    rhs_sympy:
        ``f(t, y, p) -> dict`` called once with sympy-symbol Records.
    derivative_params:
        Paths of params to differentiate with respect to.
    coords:
        Coordinate arrays for named dims.
    simplify:
        Optional per-element ``sympy.Expr -> Expr`` transform applied to every
        expression array before it is lowered (``sunode_tpu``'s ``simplify``).
    """

    def __init__(
        self,
        params: Mapping[str, Any],
        states: Mapping[str, Any],
        rhs_sympy: Callable,
        derivative_params: Any = (),
        coords: Optional[Mapping[str, Any]] = None,
        simplify: Optional[Callable] = None,
        dtype: Any = np.float64,
    ):
        self._init_specs(params, states, derivative_params, coords, dtype)
        self._rhs_sympy_func = rhs_sympy
        self._simplify_elem = simplify

        n = self.n_states

        self._varmap: dict[str, str] = {"__t": "_t"}
        self._sym_time = sy.Symbol("__t", real=True)
        for i in range(n):
            self._varmap[f"__y_{i}"] = f"_y[{i}]"
        for j in range(self.n_all_params):
            self._varmap[f"__p_{j}"] = f"_p[{j}]"
        for i in range(n):
            self._varmap[f"__lam_{i}"] = f"_lam[{i}]"
        for k in range(self.n_params):
            for i in range(n):
                self._varmap[f"__s_{k}_{i}"] = f"_s[{k}, {i}]"

        self._sym_statevec = np.array(
            [sy.Symbol(f"__y_{i}", real=True) for i in range(n)], dtype=object
        )
        self._sym_paramvec = np.array(
            [sy.Symbol(f"__p_{j}", real=True) for j in range(self.n_all_params)],
            dtype=object,
        )
        self._sym_lamda = np.array(
            [sy.Symbol(f"__lam_{i}", real=True) for i in range(n)], dtype=object
        )
        self._sym_sens = np.array(
            [[sy.Symbol(f"__s_{k}_{i}", real=True) for i in range(n)]
             for k in range(self.n_params)],
            dtype=object,
        ).reshape(self.n_params, n)

        state_rec = self.states.record(
            lambda path, shape: _symbol_leaf("__y_", self.states.slices[path].start, shape)
        )
        param_rec = self.params.record(
            lambda path, shape: _symbol_leaf("__p_", self.params.slices[path].start, shape)
        )

        self._sym_dydt = self._make_dydt(state_rec, param_rec)

        dydt_mat = sy.Matrix(list(self._sym_dydt))
        statevec_mat = sy.Matrix(list(self._sym_statevec))
        derivvec = self._sym_paramvec[self.params.subset_indices]
        self._sym_dydt_jac = np.array(
            dydt_mat.jacobian(statevec_mat), dtype=object
        ).reshape(n, n)
        if len(derivvec):
            self._sym_dydp = np.array(
                dydt_mat.jacobian(sy.Matrix(list(derivvec))), dtype=object
            ).reshape(n, len(derivvec))
        else:
            self._sym_dydp = np.zeros((n, 0), dtype=object)

        # dlamda/dt_i = -sum_j lam_j J[j, i]
        lam = self._sym_lamda
        J = self._sym_dydt_jac
        self._sym_dlamdadt = np.array(
            [-sum(lam[j] * J[j, i] for j in range(n)) for i in range(n)], dtype=object
        )
        # quad_k = sum_j lam_j dydp[j, k]
        self._sym_quad_rhs = np.array(
            [
                sum(lam[j] * self._sym_dydp[j, k] for j in range(n))
                for k in range(self.n_params)
            ],
            dtype=object,
        )

        self._fn_cache: dict[str, Callable] = {}
        self._simplified_cache: dict[str, np.ndarray] = {}

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_fn_cache"] = {}
        return state

    def _simplified(self, key: str, exprs) -> np.ndarray:
        """``exprs`` with the ``simplify`` transform applied to each element
        (cached by ``key``); unchanged without one."""
        exprs = np.asarray(exprs, dtype=object)
        if self._simplify_elem is None:
            return exprs
        if key not in self._simplified_cache:
            flat = [self._simplify_elem(e) for e in exprs.reshape(-1)]
            self._simplified_cache[key] = np.array(flat, dtype=object).reshape(exprs.shape)
        return self._simplified_cache[key]

    # ------------------------------------------------------------------
    # Symbolic pieces (read by the CUDA emitter)
    # ------------------------------------------------------------------
    @property
    def sym_time(self) -> sy.Symbol:
        return self._sym_time

    @property
    def sym_rhs(self) -> np.ndarray:
        """f, shape (n,), as :meth:`make_rhs` lowers it."""
        return self._simplified("rhs", self._sym_dydt)

    @property
    def sym_jac(self) -> np.ndarray:
        """df/dy, shape (n, n), as :meth:`make_jac_dense` lowers it."""
        return self._simplified("jac_dense", self._sym_dydt_jac)

    @property
    def sym_dfdp(self) -> np.ndarray:
        """df/dp over the derivative subset, shape (n, n_deriv), as
        :meth:`make_dfdp` lowers it."""
        return self._simplified("dfdp", self._sym_dydp)

    @property
    def sym_sens(self) -> np.ndarray:
        """The sensitivity symbols ``__s_k_i``, shape (n_deriv, n)."""
        return self._sym_sens

    # ------------------------------------------------------------------
    def _make_dydt(self, state_rec, param_rec) -> np.ndarray:
        """Call the user RHS once and flatten the returned (nested) dict to a
        flat object vector, with shape/dims validation."""
        rhs = self._rhs_sympy_func(self._sym_time, state_rec, param_rec)
        if not isinstance(rhs, Mapping):
            raise ValueError("rhs_sympy must return a dict of state derivatives")
        rhs = _deep_copy_dict(rhs)

        out: list[Any] = []
        for path in self.states.paths:
            node = rhs
            for name in path[:-1]:
                if not isinstance(node, Mapping) or name not in node:
                    raise ValueError(
                        f"No right-hand-side for state {'.'.join(path)}"
                    )
                node = node[name]
            if not isinstance(node, Mapping) or path[-1] not in node:
                raise ValueError(f"No right-hand-side for state {'.'.join(path)}")
            item = node.pop(path[-1])
            shape = self.states.shapes[path]
            dims = self.states.dims_for(path)
            out.extend(
                _flatten_rhs_item(".".join(path), item, shape, dims, self.coords)
            )

        remaining = _flatten_keys(rhs)
        if remaining:
            raise ValueError(f"Unknown state variables in rhs: {remaining}")
        if len(out) != self.n_states:
            raise AssertionError("internal: dydt length mismatch")
        return np.array([sy.sympify(e) for e in out], dtype=object)

    # ------------------------------------------------------------------
    # Lowered torch functions (cached per derivative kind)
    # ------------------------------------------------------------------
    def _lower(self, key: str, argnames, exprs) -> Callable:
        if key not in self._fn_cache:
            self._fn_cache[key] = lambdify_torch(
                argnames, self._simplified(key, exprs), self._varmap, name=key
            )
        return self._fn_cache[key]

    def make_rhs(self) -> Callable:
        """Generated dy/dt: ``(t, y (n, ...), p (n_p, ...)) -> (n, ...)``."""
        return self._lower("rhs", ["_t", "_y", "_p"], self._sym_dydt)

    def make_jac_dense(self) -> Callable:
        """Generated df/dy: ``-> (n, n, ...)``."""
        return self._lower("jac_dense", ["_t", "_y", "_p"], self._sym_dydt_jac)

    def jac_sparsity(self, **_ignored) -> np.ndarray:
        """The exact structural ``(n, n)`` pattern of df/dy: the entries of
        the symbolic Jacobian that sympy did not reduce to zero
        (``sunode_tpu/symode/problem.py::jac_sparsity``)."""
        return np.asarray(self._sym_dydt_jac != 0, dtype=bool).reshape(self.n_states, self.n_states)

    def make_dfdp(self) -> Callable:
        """Generated df/dp_subset: ``-> (n, n_deriv, ...)``."""
        return self._lower("dfdp", ["_t", "_y", "_p"], self._sym_dydp)

    def make_sensitivity_rhs(self) -> Callable:
        """Forward sensitivities ``dS/dt = S J^T + (df/dp)^T`` composed from the
        generated J and df/dp, as ``sunode_tpu``'s ``make_sensitivity_rhs``
        composes them, on trailing-batch tensors: ``(t (B,), y (n, B),
        S (k, n, B), p (n_p, B)) -> (k, n, B)``, k the derivative subset."""
        jac = self.make_jac_dense()
        dfdp = self.make_dfdp()

        def sensitivity_rhs(t, y, S, p):
            k, n = S.shape[:2]
            batch = tuple(S.shape[2:])
            J = torch.broadcast_to(jac(t, y, p), (n, n) + batch)  # constant entries too
            dfdp_T = torch.broadcast_to(dfdp(t, y, p), (n, k) + batch).transpose(0, 1)
            return torch.einsum("kj...,ij...->ki...", S, J) + dfdp_T

        return sensitivity_rhs

    def make_sensitivity_rhs_explicit(self) -> Callable:
        """Fully symbolic forward sensitivities: every entry of ``J S_k +
        df/dp_k`` is one generated expression, ``(t, y, S (k, n, ...), p)
        -> (k, n, ...)``."""
        n = self.n_states
        J, S = self._sym_dydt_jac, self._sym_sens
        exprs = np.array(
            [[sum(J[i, j] * S[k, j] for j in range(n)) + self._sym_dydp[i, k]
              for i in range(n)] for k in range(self.n_params)],
            dtype=object,
        ).reshape(self.n_params, n)
        return self._lower("sensitivity_rhs_explicit", ["_t", "_y", "_s", "_p"], exprs)

    def symbolic_roots(self, roots_sympy: Callable) -> np.ndarray:
        """The event functions as an object array of sympy expressions:
        ``roots_sympy`` is called once with the same ``(t, states, params)``
        symbol records as ``rhs_sympy`` and returns an expression or a list
        or tuple of them."""
        state_rec = self.states.record(
            lambda path, shape: _symbol_leaf("__y_", self.states.slices[path].start, shape)
        )
        param_rec = self.params.record(
            lambda path, shape: _symbol_leaf("__p_", self.params.slices[path].start, shape)
        )
        exprs = roots_sympy(self._sym_time, state_rec, param_rec)
        if not isinstance(exprs, (list, tuple)):
            exprs = [exprs]
        vec = np.array([sy.sympify(e) for e in exprs], dtype=object)
        if self._simplify_elem is not None:
            vec = np.array([self._simplify_elem(e) for e in vec], dtype=object)
        return vec

    def make_root_fn(self, roots_sympy: Callable) -> Callable:
        """Symbolic event functions lowered to ``(t, y, p) -> (nrt, ...)``:
        a zero crossing of each component is an event for the batched
        cores' ``root_fn``."""
        # not cached: distinct roots_sympy callables would share any key
        return lambdify_torch(["_t", "_y", "_p"], self.symbolic_roots(roots_sympy),
                              self._varmap, name="roots")

    def make_adjoint_rhs(self) -> Callable:
        """Generated -lam^T J: ``(t, y, lam, p) -> (n, ...)``."""
        return self._lower(
            "adjoint_rhs", ["_t", "_y", "_lam", "_p"], self._sym_dlamdadt
        )

    def make_adjoint_quad_rhs(self) -> Callable:
        """Generated lam^T df/dp: ``(t, y, lam, p) -> (n_deriv, ...)``."""
        return self._lower(
            "adjoint_quad_rhs", ["_t", "_y", "_lam", "_p"], self._sym_quad_rhs
        )


# ---------------------------------------------------------------------------
def _deep_copy_dict(d: Mapping[str, Any]) -> dict:
    return {
        k: (_deep_copy_dict(v) if isinstance(v, Mapping) else v) for k, v in d.items()
    }


def _flatten_keys(d: Mapping[str, Any], prefix: str = "") -> list[str]:
    out = []
    for k, v in d.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.extend(_flatten_keys(v, name + "."))
        else:
            out.append(name)
    return out


def _flatten_rhs_item(path, value, shape, dims, coords) -> list[Any]:
    """Validate + flatten one state's RHS entry .

    Accepts: scalar sympy expr (shape ()), array-likes of the right shape,
    nested lists, or dicts keyed by coordinate values for named dims.
    """
    if isinstance(value, sy.matrices.MatrixBase):
        value = np.array(value, dtype=object).reshape(value.shape)
        if shape != () and len(shape) == 1 and value.size == shape[0]:
            value = value.reshape(shape)
    if isinstance(value, sy.NDimArray):
        value = np.array(value.tolist(), dtype=object)

    if isinstance(value, np.ndarray):
        if value.shape != tuple(shape):
            raise ValueError(
                f"Invalid shape for right-hand-side state {path}. "
                f"It is {value.shape} but we expected {tuple(shape)}."
            )
        return list(value.reshape(-1))
    if isinstance(value, (list, tuple)):
        if len(shape) == 0 or len(value) != shape[0]:
            raise ValueError(f"Invalid shape for right-hand-side state {path}.")
        out = []
        for v in value:
            out.extend(_flatten_rhs_item(path, v, shape[1:], dims[1:], coords))
        return out
    if isinstance(value, Mapping):
        if len(shape) == 0:
            raise ValueError(f"Invalid shape for right-hand-side state {path}.")
        dim = dims[0]
        if dim not in coords:
            raise ValueError(
                f"Right-hand-side for state {path} is a dict, but dim "
                f"'{dim}' has no coords to key it by."
            )
        if len(value) != shape[0]:
            raise ValueError(f"Invalid shape for right-hand-side state {path}.")
        out = []
        for key in coords[dim]:
            if key not in value:
                raise ValueError(
                    f"Right-hand-side for state {path} is missing coord {key!r}."
                )
            out.extend(_flatten_rhs_item(path, value[key], shape[1:], dims[1:], coords))
        return out
    if tuple(shape) == ():
        return [value]
    raise ValueError(f"Unknown right-hand-side for state {path}.")
