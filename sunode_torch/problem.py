"""Problem abstraction: named ODE problems as functions on torch tensors.

PyTorch counterpart of the ``Problem`` base in ``sunode_tpu/problem.py``:
the spec plumbing (named states and params, derivative subset, coords).
Function signature conventions (flat float tensors, optional trailing batch
dimensions after the leading item axis):

    rhs(t, y, p)              -> (n_states, ...)      dy/dt
    jac_dense(t, y, p)        -> (n, n, ...)          df/dy
    adjoint_jac_dense(t, y, lam, p) -> (n, n, ...)    -J^T
    dfdp(t, y, p)             -> (n, n_deriv, ...)    df/dp_subset

where ``p`` is the full flat parameter vector and the derivative subset is
selected by ``self.params.subset_indices``.  Subclasses supply the
generated functions; ``SympyProblem`` derives them symbolically.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import numpy as np

from sunode_torch.paramspec import ParamSpec

__all__ = ["Problem"]


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

    def make_rhs(self) -> Callable:
        raise NotImplementedError

    def make_jac_dense(self) -> Callable:
        raise NotImplementedError

    def make_dfdp(self) -> Callable:
        raise NotImplementedError

    def make_adjoint_jac_dense(self) -> Callable:
        """Jacobian of the adjoint system: -J^T over the two leading axes."""
        jac = self.make_jac_dense()

        def adjoint_jac_dense(t, y, lam, p):
            return -jac(t, y, p).transpose(0, 1)

        return adjoint_jac_dense
