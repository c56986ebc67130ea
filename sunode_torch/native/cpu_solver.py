"""CpuSolver: the native host execution path.

Drives the C++ integrators (native/cvbdf.cpp: BDF with modified Newton, or
Adams-Moulton PECE via ``method='ADAMS'`` for non-stiff problems — no
Jacobian, roughly half the steps) with C RHS/Jacobian functions compiled
from the problem's sympy expressions (native/codegen.py).
This is the sunode deployment mode rebuilt natively — no SUNDIALS, no numba,
no Python in the hot loop — and doubles as an independent oracle for
tolerance-matched testing of the port's torch cores.

It takes and returns numpy: this is the host route, and no tensor of a card
passes through it.

Batched solves fan out over a C++ thread pool (``cvbdf_solve_batch``), the
native replacement for the reference's fork-per-chain multiprocessing
(README.md:233-238).
"""

from __future__ import annotations

import ctypes
from typing import Any, Mapping, Optional

import numpy as np

from sunode_torch.native.codegen import compile_problem_c, native_lib_path
from sunode_torch.solver import SolverError, _STATUS_MESSAGES

__all__ = ["CpuSolver"]

_RHS_T = ctypes.CFUNCTYPE(None)  # opaque; we pass raw pointers

_STAT_KEYS = [
    "n_steps",
    "n_rhs_evals",
    "n_jac_evals",
    "n_factorizations",
    "n_newton_iters",
    "n_error_test_fails",
    "n_conv_fails",
    "final_order",
]


def _flat(value) -> np.ndarray:
    """A flat vector of the port's ``ParamSpec`` (a CPU tensor) as numpy."""
    return value.detach().cpu().numpy() if hasattr(value, "detach") else np.asarray(value)


def _assemble_stats(stats) -> dict:
    """Build a ``last_stats`` dict with the same key surface as the torch cores.

    The native C++ integrator never resumes mid-solve (its step budget is
    enforced inside one call), so ``n_resumes`` is always 0 and
    ``n_steps_total`` equals ``n_steps`` — but both keys must exist so code
    written against ``Solver.last_stats`` works regardless of routing.
    """
    d = dict(zip(_STAT_KEYS, stats.tolist()))
    d["n_resumes"] = 0
    d["n_steps_total"] = d["n_steps"]
    return d


class CpuSolver:
    """Solve ODE problems on the host with the native C++ integrator.

    API mirrors the relevant subset of :class:`sunode_torch.solver.Solver`:
    ``set_params_dict``, ``make_output_buffers``, ``solve`` (with optional
    leading batch axis on y0/params -> threaded batch execution).
    """

    def __init__(
        self,
        problem,
        *,
        abstol: float = 1e-10,
        reltol: float = 1e-10,
        max_steps: int = 100_000,
        n_threads: int = 0,
        method: str = "BDF",
        adams_max_order: int = 8,
        hermite_order: int = 5,
        interpolation: str = "hermite",
        linear_solver: str = "dense",
        linear_solver_kwargs: Optional[Mapping[str, Any]] = None,
        constraints=None,
        roots=None,
        root_directions=None,
        root_cap: int = 8,
        root_terminal: bool = True,
    ):
        if method not in ("BDF", "ADAMS"):
            raise ValueError("method must be 'BDF' or 'ADAMS'")
        if linear_solver not in ("dense", "band", "sparse", "spgmr",
                                 "spgmr_finitediff"):
            raise ValueError(
                "linear_solver must be 'dense', 'band', 'sparse' or 'spgmr'"
            )
        if linear_solver != "dense" and method != "BDF":
            raise ValueError(
                f"linear_solver='{linear_solver}' requires method='BDF' "
                "(Adams uses functional iteration — no Newton matrix)"
            )
        self._band: Optional[tuple[int, int]] = None
        self._perm: Optional[np.ndarray] = None
        # true sparse-direct (Gilbert-Peierls) config: CSC pattern + column
        # pre-order; None unless linear_solver='sparse'
        self._sp_ap: Optional[np.ndarray] = None
        self._sp_ai: Optional[np.ndarray] = None
        self._sp_q: Optional[np.ndarray] = None
        # matrix-free GMRES Newton: both 'spgmr' variants map to the native
        # difference-quotient jtimes (the CVODES CVSpilsDQJtimes default)
        self._spgmr = linear_solver in ("spgmr", "spgmr_finitediff")
        self._spgmr_maxl = int((linear_solver_kwargs or {}).get("maxl", 5))
        if linear_solver == "band":
            kw = dict(linear_solver_kwargs or {})
            if "lower_bandwidth" not in kw or "upper_bandwidth" not in kw:
                raise ValueError(
                    "linear_solver='band' requires linear_solver_kwargs with "
                    "'lower_bandwidth' and 'upper_bandwidth'"
                )
            self._band = (int(kw["lower_bandwidth"]), int(kw["upper_bandwidth"]))
        elif linear_solver == "sparse":
            # the native KLU analog proper: exact symbolic CSC pattern
            # (diagonal included) -> minimum-degree column pre-order (the
            # AMD role) -> Gilbert-Peierls LU with dynamic partial
            # pivoting and dynamic fill (SparseLin, cvbdf.cpp).  The
            # batched path keeps the RCM-banded redesign (ops/sparsity.py)
            # — one structure for every lane; the host path gets the real
            # sparse-direct factorization.
            from sunode_torch.ops.sparsity import csc_pattern, min_degree_order

            if not hasattr(problem, "_sym_dydt_jac"):
                raise ValueError(
                    "linear_solver='sparse' requires a SympyProblem (the "
                    "structural pattern comes from the symbolic Jacobian)"
                )
            jac = np.asarray(problem._sym_dydt_jac, dtype=object)
            pattern = np.vectorize(lambda e: e != 0)(jac).astype(bool)
            np.fill_diagonal(pattern, True)  # I - cJ: diagonal always live
            ap, ai = csc_pattern(pattern)
            self._sp_ap = np.ascontiguousarray(ap, np.int64)
            self._sp_ai = np.ascontiguousarray(ai, np.int64)
            self._sp_q = np.ascontiguousarray(
                min_degree_order(pattern), np.int64
            )
        self._problem = problem
        self._rtol = float(reltol)
        self._atol = np.broadcast_to(
            np.asarray(abstol, np.float64), (problem.n_states,)
        ).copy()
        self._max_steps = int(max_steps)
        self._n_threads = int(n_threads)
        self._method = method
        self._adams_max_order = int(adams_max_order)
        if hermite_order not in (3, 5):
            raise ValueError("hermite_order must be 3 or 5")
        self._hermite_order = int(hermite_order)
        if interpolation not in ("hermite", "polynomial"):
            raise ValueError("interpolation must be 'hermite' or 'polynomial'")
        # internal code passed to the C entries: 1 = CV_POLYNOMIAL
        # (barycentric Lagrange over recorded y rows), else the Hermite
        # order (3 cubic / 5 stiffness-gated quintic)
        self._herm_code = 1 if interpolation == "polynomial" else int(
            hermite_order
        )
        self._params = np.zeros(problem.n_all_params)
        # CVodeSetConstraints parity: per-state 0 none, +-1 sign, +-2 strict
        self._cons: Optional[np.ndarray] = None
        if constraints is not None:
            self._cons = np.ascontiguousarray(
                np.broadcast_to(
                    np.asarray(constraints, np.float64), (problem.n_states,)
                )
            ).copy()
            if not np.isin(self._cons, [0.0, 1.0, -1.0, 2.0, -2.0]).all():
                raise ValueError("constraints entries must be 0, +-1 or +-2")

        # rootfinding (CVodeRootInit analog on the native path): `roots` is
        # the same sympy-callable Solver(roots=...) takes; the event vector
        # is emitted as C (sunode_roots) next to the RHS/Jacobian
        self._roots_sym = None
        self._rdir: Optional[np.ndarray] = None
        self._root_cap = max(int(root_cap), 1)
        self._root_terminal = bool(root_terminal)
        if roots is not None:
            if self._spgmr:
                raise ValueError(
                    "native rootfinding is not available with "
                    "linear_solver='spgmr' — use dense/band/sparse"
                )
            if not hasattr(problem, "symbolic_roots"):
                raise ValueError(
                    "native rootfinding requires a SympyProblem (the event "
                    "functions are compiled to C from their symbolic form)"
                )
            self._roots_sym = problem.symbolic_roots(roots)
            nrt = len(self._roots_sym)
            if root_directions is not None:
                rdir = np.asarray(root_directions, np.int32).reshape(-1)
                if rdir.shape != (nrt,):
                    raise ValueError(
                        f"root_directions must have one entry per root "
                        f"component: expected shape ({nrt},), got {rdir.shape}"
                    )
                if not np.all(np.isin(rdir, (-1, 0, 1))):
                    raise ValueError(
                        "root_directions entries must be -1, 0 or +1"
                    )
                self._rdir = np.ascontiguousarray(rdir)

        self._core = ctypes.CDLL(str(native_lib_path()))
        self._plib = compile_problem_c(
            problem, band=self._band, band_perm=self._perm,
            sparse=self._sparse_pattern(), roots=self._roots_sym,
        )
        self._rhs_ptr = ctypes.cast(self._plib.sunode_rhs, ctypes.c_void_p)
        self._jac_ptr = ctypes.cast(self._plib.sunode_jac, ctypes.c_void_p)
        if self._band is not None:
            self._jacband_ptr = ctypes.cast(
                self._plib.sunode_jac_banded, ctypes.c_void_p
            )
        if self._sp_ap is not None:
            self._jacsparse_ptr = ctypes.cast(
                self._plib.sunode_jac_sparse, ctypes.c_void_p
            )
        if self._roots_sym is not None:
            self._roots_ptr = ctypes.cast(
                self._plib.sunode_roots, ctypes.c_void_p
            )
        self._rec_handle: Optional[int] = None
        self._register_restypes()
        self._dfdp_ptr = ctypes.cast(self._plib.sunode_dfdp, ctypes.c_void_p)
        self._dfdt_ptr = ctypes.cast(self._plib.sunode_dfdt, ctypes.c_void_p)
        self._adj_ptr = ctypes.cast(self._plib.sunode_adj_rhs, ctypes.c_void_p)
        self._quad_ptr = ctypes.cast(self._plib.sunode_quad_rhs, ctypes.c_void_p)

    def _sparse_pattern(self):
        """(indptr, indices) for codegen, or None off the sparse path."""
        if getattr(self, "_sp_ap", None) is None:
            return None
        return (self._sp_ap, self._sp_ai)

    def _sp_args(self):
        """The (Ap, Ai, q) pointer triple every sparse entry leads with."""
        iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
        return (iptr(self._sp_ap), iptr(self._sp_ai), iptr(self._sp_q))

    def _register_restypes(self) -> None:
        if self._sp_ap is not None:
            self._core.cvbdf_solve_sparse.restype = ctypes.c_int
            self._core.cvbdf_solve_sparse_batch.restype = None
            self._core.cvbdf_solve_sparse_roots.restype = ctypes.c_int
            self._core.cvbdf_adjoint_solve_sparse.restype = ctypes.c_int
            self._core.cvbdf_adjoint_solve_sparse_batch.restype = None
            self._core.cvbdf_sens_solve_sparse.restype = ctypes.c_int
            self._core.cvbdf_sens_staggered_solve_sparse.restype = ctypes.c_int
            self._core.cvbdf_forward_record_sparse.restype = ctypes.c_void_p
            self._core.cvbdf_backward_recorded_sparse.restype = ctypes.c_int

        if self._band is not None:
            self._core.cvbdf_solve_banded.restype = ctypes.c_int
            self._core.cvbdf_solve_banded_batch.restype = None
            self._core.cvbdf_adjoint_solve_banded.restype = ctypes.c_int
            self._core.cvbdf_adjoint_solve_banded_batch.restype = None
            self._core.cvbdf_forward_record_banded.restype = ctypes.c_void_p
            self._core.cvbdf_backward_recorded_banded.restype = ctypes.c_int

        if self._spgmr:
            self._core.cvbdf_solve_spgmr.restype = ctypes.c_int
            self._core.cvbdf_solve_spgmr_batch.restype = None
            self._core.cvbdf_adjoint_solve_spgmr.restype = ctypes.c_int
            self._core.cvbdf_adjoint_solve_spgmr_batch.restype = None
            self._core.cvbdf_forward_record_spgmr.restype = ctypes.c_void_p
            self._core.cvbdf_backward_recorded_spgmr.restype = ctypes.c_int

        if getattr(self, "_roots_sym", None) is not None:
            self._core.cvbdf_solve_roots.restype = ctypes.c_int
            self._core.cvbdf_solve_banded_roots.restype = ctypes.c_int
            self._core.cvadams_solve_roots.restype = ctypes.c_int

        self._core.cvbdf_solve.restype = ctypes.c_int
        self._core.cvbdf_solve_batch.restype = None
        self._core.cvadams_solve.restype = ctypes.c_int
        self._core.cvadams_solve_batch.restype = None
        self._core.cvadams_adjoint_solve.restype = ctypes.c_int
        self._core.cvadams_adjoint_backward.restype = ctypes.c_int
        self._core.cvbdf_adjoint_solve.restype = ctypes.c_int
        self._core.cvbdf_forward_record.restype = ctypes.c_void_p
        self._core.cvbdf_backward_recorded.restype = ctypes.c_int
        self._core.cvbdf_record_free.restype = None
        self._core.cvbdf_record_info.restype = ctypes.c_int64
        self._core.cvbdf_adjoint_solve_batch.restype = None
        self._core.cvadams_adjoint_solve_batch.restype = None
        self._core.cvadams_sens_solve.restype = ctypes.c_int

    # --- pickling (reference Solver.__getstate__ analog, solver.py:
    # 304-324: persist config + params only and rebuild the native state
    # on unpickle; ctypes handles and the record don't cross processes)
    def __getstate__(self):
        state = {
            k: v
            for k, v in self.__dict__.items()
            if not k.startswith(("_core", "_plib", "_rhs_ptr", "_jac"))
            and k
            not in (
                "_dfdp_ptr",
                "_dfdt_ptr",
                "_adj_ptr",
                "_quad_ptr",
                "_jacband_ptr",
                "_jacsparse_ptr",
                "_rec_handle",
                "_roots_ptr",
            )
        }
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._rec_handle = None
        self._core = ctypes.CDLL(str(native_lib_path()))
        self._plib = compile_problem_c(
            self._problem, band=self._band, band_perm=self._perm,
            sparse=self._sparse_pattern(),
            roots=getattr(self, "_roots_sym", None),
        )
        self._rhs_ptr = ctypes.cast(self._plib.sunode_rhs, ctypes.c_void_p)
        self._jac_ptr = ctypes.cast(self._plib.sunode_jac, ctypes.c_void_p)
        self._dfdp_ptr = ctypes.cast(self._plib.sunode_dfdp, ctypes.c_void_p)
        self._dfdt_ptr = ctypes.cast(self._plib.sunode_dfdt, ctypes.c_void_p)
        self._adj_ptr = ctypes.cast(self._plib.sunode_adj_rhs, ctypes.c_void_p)
        self._quad_ptr = ctypes.cast(
            self._plib.sunode_quad_rhs, ctypes.c_void_p
        )
        if self._band is not None:
            self._jacband_ptr = ctypes.cast(
                self._plib.sunode_jac_banded, ctypes.c_void_p
            )
        if getattr(self, "_sp_ap", None) is not None:
            self._jacsparse_ptr = ctypes.cast(
                self._plib.sunode_jac_sparse, ctypes.c_void_p
            )
        if getattr(self, "_roots_sym", None) is not None:
            self._roots_ptr = ctypes.cast(
                self._plib.sunode_roots, ctypes.c_void_p
            )
        self._register_restypes()

    # --- output conversion (Solver.as_xarray parity, solver.py:428-433) --
    def as_xarray(
        self, tvals, out, sens_out=None, unstack_state=True, unstack_params=True
    ):
        return self._problem.solution_to_xarray(
            tvals,
            out,
            sensitivity=sens_out,
            params=self._params,
            unstack_state=unstack_state,
            unstack_params=unstack_params,
        )

    # --- params ------------------------------------------------------
    def set_params_dict(self, params: Mapping[str, Any]) -> None:
        self._params = np.asarray(
            _flat(self._problem.params.flatten_dict(params)), dtype=np.float64
        )

    def get_params_dict(self):
        return self._problem.params.unflatten(self._params)

    def make_output_buffers(self, tvals):
        return np.zeros((len(tvals), self._problem.n_states))

    def _cons_ptr(self):
        """Constraints array pointer for the C entries (NULL when unset)."""
        if self._cons is None:
            return None
        return self._cons.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    def _perm_ptr(self):
        """RCM permutation pointer for the banded entries (NULL = identity,
        i.e. plain ``linear_solver='band'``)."""
        if self._perm is None:
            return None
        return self._perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    @property
    def generated_source(self) -> str:
        return self._plib._generated_source

    # --- solve -------------------------------------------------------
    def solve(self, t0, tvals, y0, y_out=None):
        n = self._problem.n_states
        y0 = _flat(self._problem.states.coerce_flat(y0))
        y0 = np.ascontiguousarray(y0, np.float64)
        tvals = np.ascontiguousarray(tvals, np.float64)
        n_t = len(tvals)

        dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731

        if y0.ndim == 2:
            if self._roots_sym is not None:
                raise SolverError(
                    "native batched event solves are not supported — the "
                    "batched torch cores (Solver with batched y0) handle "
                    "rootfinding at batch scale"
                )
            batch = y0.shape[0]
            params = np.ascontiguousarray(
                np.broadcast_to(self._params, (batch, self._params.size)), np.float64
            )
            ys = np.full((batch, n_t, n), np.nan)
            status = np.zeros(batch, np.int32)
            if self._method == "ADAMS":
                self._core.cvadams_solve_batch(
                    ctypes.c_int(n),
                    self._rhs_ptr,
                    ctypes.c_double(float(t0)),
                    dptr(y0),
                    dptr(params),
                    ctypes.c_int(params.shape[1]),
                    ctypes.c_int(n_t),
                    dptr(tvals),
                    ctypes.c_double(self._rtol),
                    dptr(self._atol),
                    ctypes.c_int64(self._max_steps),
                    ctypes.c_int(self._adams_max_order),
                    ctypes.c_int(batch),
                    ctypes.c_int(self._n_threads),
                    dptr(ys),
                    status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                    self._cons_ptr(),
                )
            elif self._spgmr:
                self._core.cvbdf_solve_spgmr_batch(
                    ctypes.c_int(n),
                    ctypes.c_int(self._spgmr_maxl),
                    self._rhs_ptr,
                    ctypes.c_double(float(t0)),
                    dptr(y0),
                    dptr(params),
                    ctypes.c_int(params.shape[1]),
                    ctypes.c_int(n_t),
                    dptr(tvals),
                    ctypes.c_double(self._rtol),
                    dptr(self._atol),
                    ctypes.c_int64(self._max_steps),
                    ctypes.c_int(batch),
                    ctypes.c_int(self._n_threads),
                    dptr(ys),
                    status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                    self._cons_ptr(),
                )
            elif self._sp_ap is not None:
                self._core.cvbdf_solve_sparse_batch(
                    ctypes.c_int(n),
                    *self._sp_args(),
                    self._rhs_ptr,
                    self._jacsparse_ptr,
                    ctypes.c_double(float(t0)),
                    dptr(y0),
                    dptr(params),
                    ctypes.c_int(params.shape[1]),
                    ctypes.c_int(n_t),
                    dptr(tvals),
                    ctypes.c_double(self._rtol),
                    dptr(self._atol),
                    ctypes.c_int64(self._max_steps),
                    ctypes.c_int(batch),
                    ctypes.c_int(self._n_threads),
                    dptr(ys),
                    status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                    self._cons_ptr(),
                )
            elif self._band is not None:
                self._core.cvbdf_solve_banded_batch(
                    ctypes.c_int(n),
                    ctypes.c_int(self._band[0]),
                    ctypes.c_int(self._band[1]),
                    self._rhs_ptr,
                    self._jacband_ptr,
                    ctypes.c_double(float(t0)),
                    dptr(y0),
                    dptr(params),
                    ctypes.c_int(params.shape[1]),
                    ctypes.c_int(n_t),
                    dptr(tvals),
                    ctypes.c_double(self._rtol),
                    dptr(self._atol),
                    ctypes.c_int64(self._max_steps),
                    ctypes.c_int(batch),
                    ctypes.c_int(self._n_threads),
                    dptr(ys),
                    status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                    self._cons_ptr(),
                    self._perm_ptr(),
                )
            else:
                self._core.cvbdf_solve_batch(
                    ctypes.c_int(n),
                    self._rhs_ptr,
                    self._jac_ptr,
                    ctypes.c_double(float(t0)),
                    dptr(y0),
                    dptr(params),
                    ctypes.c_int(params.shape[1]),
                    ctypes.c_int(n_t),
                    dptr(tvals),
                    ctypes.c_double(self._rtol),
                    dptr(self._atol),
                    ctypes.c_int64(self._max_steps),
                    ctypes.c_int(batch),
                    ctypes.c_int(self._n_threads),
                    dptr(ys),
                    status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                    self._cons_ptr(),
                )
            self.last_status = status
            if (status != 0).any():
                codes = sorted(set(int(s) for s in status if s))
                msgs = "; ".join(_STATUS_MESSAGES.get(c, f"code {c}") for c in codes)
                raise SolverError(f"Native batch solve failed: {msgs}")
        elif self._roots_sym is not None:
            ys, rc = self._solve_single_roots(t0, tvals, y0, n, n_t)
            if rc not in (0, 5):
                raise SolverError(
                    f"Native solve failed: "
                    f"{_STATUS_MESSAGES.get(rc, f'code {rc}')}"
                )
        else:
            ys = np.full((n_t, n), np.nan)
            stats = np.zeros(8, np.int64)
            if self._method == "ADAMS":
                rc = self._core.cvadams_solve(
                    ctypes.c_int(n),
                    self._rhs_ptr,
                    ctypes.c_double(float(t0)),
                    dptr(y0),
                    dptr(self._params),
                    ctypes.c_int(n_t),
                    dptr(tvals),
                    ctypes.c_double(self._rtol),
                    dptr(self._atol),
                    ctypes.c_int64(self._max_steps),
                    ctypes.c_double(-1.0),
                    ctypes.c_int(self._adams_max_order),
                    dptr(ys),
                    stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    self._cons_ptr(),
                )
            elif self._spgmr:
                rc = self._core.cvbdf_solve_spgmr(
                    ctypes.c_int(n),
                    ctypes.c_int(self._spgmr_maxl),
                    self._rhs_ptr,
                    ctypes.c_double(float(t0)),
                    dptr(y0),
                    dptr(self._params),
                    ctypes.c_int(n_t),
                    dptr(tvals),
                    ctypes.c_double(self._rtol),
                    dptr(self._atol),
                    ctypes.c_int64(self._max_steps),
                    ctypes.c_double(-1.0),
                    dptr(ys),
                    stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    self._cons_ptr(),
                )
            elif self._sp_ap is not None:
                rc = self._core.cvbdf_solve_sparse(
                    ctypes.c_int(n),
                    *self._sp_args(),
                    self._rhs_ptr,
                    self._jacsparse_ptr,
                    ctypes.c_double(float(t0)),
                    dptr(y0),
                    dptr(self._params),
                    ctypes.c_int(n_t),
                    dptr(tvals),
                    ctypes.c_double(self._rtol),
                    dptr(self._atol),
                    ctypes.c_int64(self._max_steps),
                    ctypes.c_double(-1.0),
                    dptr(ys),
                    stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    self._cons_ptr(),
                )
            elif self._band is not None:
                rc = self._core.cvbdf_solve_banded(
                    ctypes.c_int(n),
                    ctypes.c_int(self._band[0]),
                    ctypes.c_int(self._band[1]),
                    self._rhs_ptr,
                    self._jacband_ptr,
                    ctypes.c_double(float(t0)),
                    dptr(y0),
                    dptr(self._params),
                    ctypes.c_int(n_t),
                    dptr(tvals),
                    ctypes.c_double(self._rtol),
                    dptr(self._atol),
                    ctypes.c_int64(self._max_steps),
                    ctypes.c_double(-1.0),
                    dptr(ys),
                    stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    self._cons_ptr(),
                    self._perm_ptr(),
                )
            else:
                rc = self._core.cvbdf_solve(
                    ctypes.c_int(n),
                    self._rhs_ptr,
                    self._jac_ptr,
                    ctypes.c_double(float(t0)),
                    dptr(y0),
                    dptr(self._params),
                    ctypes.c_int(n_t),
                    dptr(tvals),
                    ctypes.c_double(self._rtol),
                    dptr(self._atol),
                    ctypes.c_int64(self._max_steps),
                    ctypes.c_double(-1.0),
                    dptr(ys),
                    stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    self._cons_ptr(),
                )
            self.last_stats = _assemble_stats(stats)
            if rc != 0:
                raise SolverError(
                    f"Native solve failed: {_STATUS_MESSAGES.get(rc, f'code {rc}')}"
                )
        if y_out is not None:
            y_out[...] = ys
            return y_out
        return ys

    def _solve_single_roots(self, t0, tvals, y0, n, n_t):
        """Single-instance solve with native rootfinding (cvbdf_solve_roots /
        cvbdf_solve_banded_roots / cvadams_solve_roots).  rc 5 is
        CV_ROOT_RETURN: a terminal root stopped the solve successfully —
        outputs past the root stay NaN and ``last_stats`` carries
        ``n_roots`` / ``roots_t`` / ``roots_y`` / ``roots_found`` with the
        same shapes and conventions as the torch cores."""
        nrt = len(self._roots_sym)
        cap = self._root_cap
        ys = np.full((n_t, n), np.nan)
        stats = np.zeros(8, np.int64)
        roots_t = np.full(cap, np.inf)
        roots_y = np.zeros((cap, n))
        roots_found = np.zeros((cap, nrt), np.int32)
        n_roots = np.zeros(1, np.int64)
        dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
        rdir_ptr = (
            self._rdir.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            if self._rdir is not None
            else None
        )
        root_args = (
            self._roots_ptr,
            ctypes.c_int(nrt),
            rdir_ptr,
            ctypes.c_int(1 if self._root_terminal else 0),
            ctypes.c_int(cap),
        )
        root_outs = (
            dptr(roots_t),
            dptr(roots_y),
            roots_found.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_roots.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if self._method == "ADAMS":
            rc = self._core.cvadams_solve_roots(
                ctypes.c_int(n),
                self._rhs_ptr,
                *root_args,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_int64(self._max_steps),
                ctypes.c_double(-1.0),
                ctypes.c_int(self._adams_max_order),
                dptr(ys),
                *root_outs,
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._cons_ptr(),
            )
        elif self._sp_ap is not None:
            rc = self._core.cvbdf_solve_sparse_roots(
                ctypes.c_int(n),
                *self._sp_args(),
                self._rhs_ptr,
                self._jacsparse_ptr,
                *root_args,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_int64(self._max_steps),
                ctypes.c_double(-1.0),
                dptr(ys),
                *root_outs,
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._cons_ptr(),
            )
        elif self._band is not None:
            rc = self._core.cvbdf_solve_banded_roots(
                ctypes.c_int(n),
                ctypes.c_int(self._band[0]),
                ctypes.c_int(self._band[1]),
                self._rhs_ptr,
                self._jacband_ptr,
                *root_args,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_int64(self._max_steps),
                ctypes.c_double(-1.0),
                dptr(ys),
                *root_outs,
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._cons_ptr(),
                self._perm_ptr(),
            )
        else:
            rc = self._core.cvbdf_solve_roots(
                ctypes.c_int(n),
                self._rhs_ptr,
                self._jac_ptr,
                *root_args,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_int64(self._max_steps),
                ctypes.c_double(-1.0),
                dptr(ys),
                *root_outs,
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._cons_ptr(),
            )
        self.last_stats = _assemble_stats(stats)
        self.last_stats["n_roots"] = int(n_roots[0])
        self.last_stats["roots_t"] = roots_t
        self.last_stats["roots_y"] = roots_y
        self.last_stats["roots_found"] = roots_found
        return ys, rc

    # --- adjoint gradients --------------------------------------------
    def solve_adjoint(
        self,
        t0,
        tvals,
        y0,
        grads,
        *,
        adjoint_reltol: Optional[float] = None,
        adjoint_abstol: Optional[float] = None,
        params: Optional[np.ndarray] = None,
    ):
        """One native gradient pair: forward solve + backward adjoint.

        For the scalar loss ``L = sum_k grads[k] . y(t_k)`` returns
        ``(ys, lam0, dLdp)`` with ``lam0 = dL/dy0`` (n,) and ``dLdp``
        w.r.t. the derivative-params subset (n_params,).

        Two backward engines (reference CVodeB structure, solver.py:723-784):

        - ``method='ADAMS'`` (non-stiff): re-integrates ``[y; lambda; q]``
          interval by interval in reversed time ('resolve'-style y instead
          of checkpoint interpolation — y is reset to the recorded forward
          solution at every observation, bounding drift).
        - ``method='BDF'`` (stiff): records (t, y, f[, fdot]) at every
          accepted forward step (CVodeF analog, growable host storage — no
          checkpoint cap, no thinning) and integrates the ``[lambda; q]``
          system backward with modified-Newton BDF over
          Hermite-interpolated y (CV_HERMITE analog).  With
          ``hermite_order=5`` (default) the reconstruction is quintic
          where the interval is non-stiff (h*||J||_inf <= 1) and falls
          back to cubic beyond that — the h^2*(J f) quintic term
          amplifies the forward solve's node error by (hL)^2 and is
          poison in the stiff regime (see FwdRecord::eval, cvbdf.cpp).
        """
        n = self._problem.n_states
        nq = self._problem.n_params
        y0 = np.ascontiguousarray(
            _flat(self._problem.states.coerce_flat(y0)), np.float64
        )
        tvals = np.ascontiguousarray(tvals, np.float64)
        grads = np.ascontiguousarray(grads, np.float64)
        n_t = len(tvals)
        a_rtol = self._rtol if adjoint_reltol is None else float(adjoint_reltol)
        a_atol = (
            float(np.max(self._atol))
            if adjoint_abstol is None
            else float(adjoint_abstol)
        )
        if y0.ndim == 2:
            return self._solve_adjoint_batch(
                t0, tvals, y0, grads, a_rtol, a_atol, params
            )
        if params is not None:
            raise SolverError(
                "per-lane params only apply to the batched adjoint path"
            )
        if y0.ndim != 1:
            raise SolverError("y0 must be 1-D (single) or 2-D (batch)")
        if grads.shape != (n_t, n):
            raise SolverError(f"grads must have shape {(n_t, n)}")

        ys = np.full((n_t, n), np.nan)
        lam0 = np.full(n, np.nan)
        dLdp = np.full(max(nq, 1), np.nan)
        stats = np.zeros(8, np.int64)
        dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
        if self._method == "ADAMS":
            rc = self._core.cvadams_adjoint_solve(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                self._rhs_ptr,
                self._adj_ptr,
                self._quad_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                dptr(grads),
                ctypes.c_double(a_rtol),
                dptr(self._atol),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_atol),
                ctypes.c_int64(self._max_steps),
                ctypes.c_int(self._adams_max_order),
                dptr(ys),
                dptr(lam0),
                dptr(dLdp),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
        elif self._spgmr:
            rc = self._core.cvbdf_adjoint_solve_spgmr(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                ctypes.c_int(self._spgmr_maxl),
                self._rhs_ptr,
                self._adj_ptr,
                self._quad_ptr,
                self._dfdp_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                dptr(grads),
                ctypes.c_double(a_rtol),
                dptr(self._atol),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_atol),
                ctypes.c_int64(self._max_steps),
                # matrix-free records have no ||J||: polynomial or cubic
                ctypes.c_int(1 if self._herm_code == 1 else 3),
                dptr(ys),
                dptr(lam0),
                dptr(dLdp),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
        elif self._sp_ap is not None:
            rc = self._core.cvbdf_adjoint_solve_sparse(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                *self._sp_args(),
                self._rhs_ptr,
                self._jacsparse_ptr,
                self._adj_ptr,
                self._quad_ptr,
                self._dfdp_ptr,
                self._dfdt_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                dptr(grads),
                ctypes.c_double(a_rtol),
                dptr(self._atol),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_atol),
                ctypes.c_int64(self._max_steps),
                ctypes.c_int(self._herm_code),
                dptr(ys),
                dptr(lam0),
                dptr(dLdp),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
        elif self._band is not None:
            rc = self._core.cvbdf_adjoint_solve_banded(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                ctypes.c_int(self._band[0]),
                ctypes.c_int(self._band[1]),
                self._rhs_ptr,
                self._jacband_ptr,
                self._adj_ptr,
                self._quad_ptr,
                self._dfdp_ptr,
                self._dfdt_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                dptr(grads),
                ctypes.c_double(a_rtol),
                dptr(self._atol),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_atol),
                ctypes.c_int64(self._max_steps),
                ctypes.c_int(self._herm_code),
                dptr(ys),
                dptr(lam0),
                dptr(dLdp),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._perm_ptr(),
            )
        else:
            rc = self._core.cvbdf_adjoint_solve(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                self._rhs_ptr,
                self._jac_ptr,
                self._adj_ptr,
                self._quad_ptr,
                self._dfdp_ptr,
                self._dfdt_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                dptr(grads),
                ctypes.c_double(a_rtol),
                dptr(self._atol),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_atol),
                ctypes.c_int64(self._max_steps),
                ctypes.c_int(self._herm_code),
                dptr(ys),
                dptr(lam0),
                dptr(dLdp),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
        self.last_stats = _assemble_stats(stats)
        if rc != 0:
            raise SolverError(
                f"Native adjoint solve failed: "
                f"{_STATUS_MESSAGES.get(rc, f'code {rc}')}"
            )
        return ys, lam0, dLdp[:nq]

    def solve_sens(
        self,
        t0,
        tvals,
        y0,
        sens0=None,
        *,
        abstol_sens: Optional[float] = None,
        sens_mode: str = "simultaneous",
    ):
        """Forward solve with forward sensitivities: returns ``(ys, sens)``
        with ``sens[m, k, i] = d y_i(t_m) / d p_k`` over the
        derivative-params subset.  The augmented state [y; vec(S)] is
        error-controlled jointly (CVodeSensEEtolerances + SetSensErrCon
        semantics, reference solver.py:360-392).  ``method='ADAMS'`` uses
        functional iteration; ``method='BDF'`` uses modified Newton with
        ONE shared I - cJ factorization across the y and sensitivity
        blocks (banded/permuted when ``linear_solver='band'``/``'sparse'``).
        ``sens_mode='staggered'`` (CV_STAGGERED, both methods) converges
        and error-tests the state FIRST — rejected state attempts never
        touch the sensitivity RHS — then runs a separate sensitivity
        corrector: modified Newton sharing the state's factored matrix on
        BDF, functional iteration on ADAMS."""
        if sens_mode not in ("simultaneous", "staggered"):
            raise SolverError("sens_mode must be 'simultaneous' or 'staggered'")
        n = self._problem.n_states
        nq = self._problem.n_params
        y0 = np.ascontiguousarray(
            _flat(self._problem.states.coerce_flat(y0)), np.float64
        )
        if y0.ndim != 1:
            raise SolverError("solve_sens is the single-instance path")
        if sens0 is None:
            sens0 = np.zeros((nq, n))
        sens0 = np.ascontiguousarray(sens0, np.float64)
        if sens0.shape != (nq, n):
            raise SolverError(f"sens0 must have shape {(nq, n)}")
        tvals = np.ascontiguousarray(tvals, np.float64)
        n_t = len(tvals)
        a_sens = (
            float(np.max(self._atol)) if abstol_sens is None else float(abstol_sens)
        )
        ys = np.full((n_t, n), np.nan)
        sens = np.full((n_t, max(nq, 1), n), np.nan)
        stats = np.zeros(8, np.int64)
        dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
        if self._method == "ADAMS" and sens_mode == "staggered":
            self._core.cvadams_sens_staggered_solve.restype = ctypes.c_int
            rc = self._core.cvadams_sens_staggered_solve(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                self._rhs_ptr,
                self._jac_ptr,
                self._dfdp_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(sens0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_sens),
                ctypes.c_int64(self._max_steps),
                ctypes.c_int(self._adams_max_order),
                dptr(ys),
                dptr(sens),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._cons_ptr(),
            )
        elif self._method == "ADAMS":
            rc = self._core.cvadams_sens_solve(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                self._rhs_ptr,
                self._jac_ptr,
                self._dfdp_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(sens0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_sens),
                ctypes.c_int64(self._max_steps),
                ctypes.c_int(self._adams_max_order),
                dptr(ys),
                dptr(sens),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
        elif sens_mode == "staggered" and self._sp_ap is not None:
            rc = self._core.cvbdf_sens_staggered_solve_sparse(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                *self._sp_args(),
                self._rhs_ptr,
                self._jac_ptr,
                self._jacsparse_ptr,
                self._dfdp_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(sens0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_sens),
                ctypes.c_int64(self._max_steps),
                dptr(ys),
                dptr(sens),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._cons_ptr(),
            )
        elif sens_mode == "staggered" and self._band is not None:
            self._core.cvbdf_sens_staggered_solve_banded.restype = ctypes.c_int
            rc = self._core.cvbdf_sens_staggered_solve_banded(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                ctypes.c_int(self._band[0]),
                ctypes.c_int(self._band[1]),
                self._rhs_ptr,
                self._jac_ptr,
                self._jacband_ptr,
                self._dfdp_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(sens0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_sens),
                ctypes.c_int64(self._max_steps),
                dptr(ys),
                dptr(sens),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._cons_ptr(),
                self._perm_ptr(),
            )
        elif sens_mode == "staggered" and self._spgmr:
            self._core.cvbdf_sens_staggered_solve_spgmr.restype = ctypes.c_int
            rc = self._core.cvbdf_sens_staggered_solve_spgmr(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                ctypes.c_int(self._spgmr_maxl),
                self._rhs_ptr,
                self._jac_ptr,
                self._dfdp_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(sens0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_sens),
                ctypes.c_int64(self._max_steps),
                dptr(ys),
                dptr(sens),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._cons_ptr(),
            )
        elif sens_mode == "staggered":
            self._core.cvbdf_sens_staggered_solve.restype = ctypes.c_int
            rc = self._core.cvbdf_sens_staggered_solve(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                self._rhs_ptr,
                self._jac_ptr,
                self._dfdp_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(sens0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_sens),
                ctypes.c_int64(self._max_steps),
                dptr(ys),
                dptr(sens),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._cons_ptr(),
            )
        elif self._spgmr:
            self._core.cvbdf_sens_solve_spgmr.restype = ctypes.c_int
            rc = self._core.cvbdf_sens_solve_spgmr(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                ctypes.c_int(self._spgmr_maxl),
                self._rhs_ptr,
                self._jac_ptr,
                self._dfdp_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(sens0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_sens),
                ctypes.c_int64(self._max_steps),
                dptr(ys),
                dptr(sens),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._cons_ptr(),
            )
        elif self._sp_ap is not None:
            rc = self._core.cvbdf_sens_solve_sparse(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                *self._sp_args(),
                self._rhs_ptr,
                self._jac_ptr,
                self._jacsparse_ptr,
                self._dfdp_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(sens0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_sens),
                ctypes.c_int64(self._max_steps),
                dptr(ys),
                dptr(sens),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._cons_ptr(),
            )
        elif self._band is not None:
            self._core.cvbdf_sens_solve_banded.restype = ctypes.c_int
            rc = self._core.cvbdf_sens_solve_banded(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                ctypes.c_int(self._band[0]),
                ctypes.c_int(self._band[1]),
                self._rhs_ptr,
                self._jac_ptr,
                self._jacband_ptr,
                self._dfdp_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(sens0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_sens),
                ctypes.c_int64(self._max_steps),
                dptr(ys),
                dptr(sens),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._cons_ptr(),
                self._perm_ptr(),
            )
        else:
            self._core.cvbdf_sens_solve.restype = ctypes.c_int
            rc = self._core.cvbdf_sens_solve(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                self._rhs_ptr,
                self._jac_ptr,
                self._dfdp_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(sens0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_sens),
                ctypes.c_int64(self._max_steps),
                dptr(ys),
                dptr(sens),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._cons_ptr(),
            )
        self.last_stats = _assemble_stats(stats)
        if rc != 0:
            raise SolverError(
                f"Native sensitivity solve failed: "
                f"{_STATUS_MESSAGES.get(rc, f'code {rc}')}"
            )
        return ys, sens[:, :nq, :]

    def _solve_adjoint_batch(self, t0, tvals, y0, grads, a_rtol, a_atol, params):
        """Threaded batch of full native gradient pairs — the multi-chain
        gradient executor (the reference covers this with fork-per-chain
        multiprocessing, README.md:233-238; here a C++ work-stealing pool,
        cvbdf_adjoint_solve_batch / cvadams_adjoint_solve_batch).  Each lane
        has its own ``y0``, cotangents and (optionally, via ``params`` of
        shape (B, n_all_params)) its own parameter vector.  Failed lanes
        keep NaN outputs and a nonzero entry in ``last_status`` — the
        NaN-poison contract (reference as_pytensor.py:244-247) rather than
        an exception, so one diverged chain can't kill a sampler sweep."""
        n = self._problem.n_states
        nq = self._problem.n_params
        batch = y0.shape[0]
        n_t = len(tvals)
        if grads.shape != (batch, n_t, n):
            raise SolverError(f"grads must have shape {(batch, n_t, n)}")
        if params is None:
            params = np.broadcast_to(self._params, (batch, self._params.size))
        params = np.ascontiguousarray(params, np.float64)
        if params.shape != (batch, self._params.size):
            raise SolverError(
                f"params must have shape {(batch, self._params.size)}"
            )
        ys = np.full((batch, n_t, n), np.nan)
        lam0 = np.full((batch, n), np.nan)
        dLdp = np.full((batch, max(nq, 1)), np.nan)
        status = np.zeros(batch, np.int32)
        dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
        if self._method == "ADAMS":
            self._core.cvadams_adjoint_solve_batch(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                self._rhs_ptr,
                self._adj_ptr,
                self._quad_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(params),
                ctypes.c_int(params.shape[1]),
                ctypes.c_int(n_t),
                dptr(tvals),
                dptr(grads),
                ctypes.c_double(a_rtol),
                dptr(self._atol),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_atol),
                ctypes.c_int64(self._max_steps),
                ctypes.c_int(self._adams_max_order),
                ctypes.c_int(batch),
                ctypes.c_int(self._n_threads),
                dptr(ys),
                dptr(lam0),
                dptr(dLdp),
                status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            )
        elif self._spgmr:
            self._core.cvbdf_adjoint_solve_spgmr_batch(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                ctypes.c_int(self._spgmr_maxl),
                self._rhs_ptr,
                self._adj_ptr,
                self._quad_ptr,
                self._dfdp_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(params),
                ctypes.c_int(params.shape[1]),
                ctypes.c_int(n_t),
                dptr(tvals),
                dptr(grads),
                ctypes.c_double(a_rtol),
                dptr(self._atol),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_atol),
                ctypes.c_int64(self._max_steps),
                ctypes.c_int(1 if self._herm_code == 1 else 3),
                ctypes.c_int(batch),
                ctypes.c_int(self._n_threads),
                dptr(ys),
                dptr(lam0),
                dptr(dLdp),
                status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            )
        elif self._sp_ap is not None:
            self._core.cvbdf_adjoint_solve_sparse_batch(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                *self._sp_args(),
                self._rhs_ptr,
                self._jacsparse_ptr,
                self._adj_ptr,
                self._quad_ptr,
                self._dfdp_ptr,
                self._dfdt_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(params),
                ctypes.c_int(params.shape[1]),
                ctypes.c_int(n_t),
                dptr(tvals),
                dptr(grads),
                ctypes.c_double(a_rtol),
                dptr(self._atol),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_atol),
                ctypes.c_int64(self._max_steps),
                ctypes.c_int(self._herm_code),
                ctypes.c_int(batch),
                ctypes.c_int(self._n_threads),
                dptr(ys),
                dptr(lam0),
                dptr(dLdp),
                status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            )
        elif self._band is not None:
            self._core.cvbdf_adjoint_solve_banded_batch(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                ctypes.c_int(self._band[0]),
                ctypes.c_int(self._band[1]),
                self._rhs_ptr,
                self._jacband_ptr,
                self._adj_ptr,
                self._quad_ptr,
                self._dfdp_ptr,
                self._dfdt_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(params),
                ctypes.c_int(params.shape[1]),
                ctypes.c_int(n_t),
                dptr(tvals),
                dptr(grads),
                ctypes.c_double(a_rtol),
                dptr(self._atol),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_atol),
                ctypes.c_int64(self._max_steps),
                ctypes.c_int(self._herm_code),
                ctypes.c_int(batch),
                ctypes.c_int(self._n_threads),
                dptr(ys),
                dptr(lam0),
                dptr(dLdp),
                status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                self._perm_ptr(),
            )
        else:
            self._core.cvbdf_adjoint_solve_batch(
                ctypes.c_int(n),
                ctypes.c_int(nq),
                self._rhs_ptr,
                self._jac_ptr,
                self._adj_ptr,
                self._quad_ptr,
                self._dfdp_ptr,
                self._dfdt_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(params),
                ctypes.c_int(params.shape[1]),
                ctypes.c_int(n_t),
                dptr(tvals),
                dptr(grads),
                ctypes.c_double(a_rtol),
                dptr(self._atol),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_double(a_atol),
                ctypes.c_int64(self._max_steps),
                ctypes.c_int(self._herm_code),
                ctypes.c_int(batch),
                ctypes.c_int(self._n_threads),
                dptr(ys),
                dptr(lam0),
                dptr(dLdp),
                status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            )
        self.last_status = status
        return ys, lam0, dLdp[:, :nq]

    # --- BDF record-handle pair (CVodeF / CVodeB split) ----------------
    def _free_record(self) -> None:
        if getattr(self, "_rec_handle", None):
            self._core.cvbdf_record_free(ctypes.c_void_p(self._rec_handle))
            self._rec_handle = None

    def __del__(self):  # pragma: no cover - exercised implicitly
        try:
            self._free_record()
        except Exception:
            pass

    def checkpoint_times(self) -> np.ndarray:
        """Recorded checkpoint times from the live native record
        (CVodeGetAdjCheckPointsInfo analog, 16_cvodes.h:429-439)."""
        if getattr(self, "_rec_handle", None) is None:
            raise SolverError(
                "checkpoint_times called before solve_forward_recorded"
            )
        count = int(
            self._core.cvbdf_record_info(ctypes.c_void_p(self._rec_handle), None)
        )
        ts = np.empty(count, np.float64)
        self._core.cvbdf_record_info(
            ctypes.c_void_p(self._rec_handle),
            ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return ts

    def solve_forward_recorded(self, t0, tvals, y0):
        """BDF forward solve that keeps the dense (t, y, f[, fdot]) Hermite
        record alive in native memory (CVodeF analog) for a later
        :meth:`solve_backward_recorded`.  Returns ``ys`` at ``tvals``."""
        if self._method != "BDF":
            raise SolverError("solve_forward_recorded requires method='BDF'")
        n = self._problem.n_states
        y0 = np.ascontiguousarray(
            _flat(self._problem.states.coerce_flat(y0)), np.float64
        )
        if y0.ndim != 1:
            raise SolverError("solve_forward_recorded is the single-instance path")
        tvals = np.ascontiguousarray(tvals, np.float64)
        n_t = len(tvals)
        ys = np.full((n_t, n), np.nan)
        stats = np.zeros(8, np.int64)
        rc = ctypes.c_int(-1)
        dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
        self._free_record()
        if self._spgmr:
            handle = self._core.cvbdf_forward_record_spgmr(
                ctypes.c_int(n),
                ctypes.c_int(self._spgmr_maxl),
                self._rhs_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_int64(self._max_steps),
                ctypes.c_int(1 if self._herm_code == 1 else 3),
                dptr(ys),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.byref(rc),
            )
        elif self._sp_ap is not None:
            handle = self._core.cvbdf_forward_record_sparse(
                ctypes.c_int(n),
                *self._sp_args(),
                self._rhs_ptr,
                self._jacsparse_ptr,
                self._dfdt_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_int64(self._max_steps),
                ctypes.c_int(self._herm_code),
                dptr(ys),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.byref(rc),
            )
        elif self._band is not None:
            handle = self._core.cvbdf_forward_record_banded(
                ctypes.c_int(n),
                ctypes.c_int(self._band[0]),
                ctypes.c_int(self._band[1]),
                self._rhs_ptr,
                self._jacband_ptr,
                self._dfdt_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_int64(self._max_steps),
                ctypes.c_int(self._herm_code),
                dptr(ys),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.byref(rc),
                self._perm_ptr(),
            )
        else:
            handle = self._core.cvbdf_forward_record(
                ctypes.c_int(n),
                self._rhs_ptr,
                self._jac_ptr,
                self._dfdt_ptr,
                ctypes.c_double(float(t0)),
                dptr(y0),
                dptr(self._params),
                ctypes.c_int(n_t),
                dptr(tvals),
                ctypes.c_double(self._rtol),
                dptr(self._atol),
                ctypes.c_int64(self._max_steps),
                ctypes.c_int(self._herm_code),
                dptr(ys),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.byref(rc),
            )
        self.last_stats = _assemble_stats(stats)
        if rc.value != 0 or not handle:
            raise SolverError(
                f"Native forward record failed: "
                f"{_STATUS_MESSAGES.get(rc.value, f'code {rc.value}')}"
            )
        self._rec_handle = handle
        self._rec_t0 = float(t0)
        return ys

    def solve_backward_recorded(
        self,
        t0,
        tvals,
        grads,
        *,
        adjoint_reltol: Optional[float] = None,
        adjoint_abstol: Optional[float] = None,
    ):
        """Backward stiff adjoint against the record kept by
        :meth:`solve_forward_recorded` (CVodeB/CV_HERMITE analog).  Returns
        ``(lam0, dLdp)`` for ``L = sum_k grads[k] . y(t_k)``.  The record
        stays alive, so multiple cotangent sets can be swept without
        re-integrating forward."""
        if self._rec_handle is None:
            raise SolverError(
                "solve_backward_recorded called before solve_forward_recorded"
            )
        n = self._problem.n_states
        nq = self._problem.n_params
        tvals = np.ascontiguousarray(tvals, np.float64)
        grads = np.ascontiguousarray(grads, np.float64)
        n_t = len(tvals)
        if grads.shape != (n_t, n):
            raise SolverError(f"grads must have shape {(n_t, n)}")
        a_rtol = self._rtol if adjoint_reltol is None else float(adjoint_reltol)
        a_atol = (
            float(np.max(self._atol))
            if adjoint_abstol is None
            else float(adjoint_abstol)
        )
        lam0 = np.full(n, np.nan)
        dLdp = np.full(max(nq, 1), np.nan)
        stats = np.zeros(8, np.int64)
        dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
        if self._spgmr:
            rc = self._core.cvbdf_backward_recorded_spgmr(
                ctypes.c_void_p(self._rec_handle),
                ctypes.c_int(n),
                ctypes.c_int(nq),
                ctypes.c_int(self._spgmr_maxl),
                self._adj_ptr,
                self._quad_ptr,
                self._dfdp_ptr,
                dptr(self._params),
                ctypes.c_double(float(t0)),
                ctypes.c_int(n_t),
                dptr(tvals),
                dptr(grads),
                ctypes.c_double(a_rtol),
                dptr(self._atol),
                ctypes.c_double(a_atol),
                ctypes.c_int64(self._max_steps),
                dptr(lam0),
                dptr(dLdp),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
        elif self._sp_ap is not None:
            rc = self._core.cvbdf_backward_recorded_sparse(
                ctypes.c_void_p(self._rec_handle),
                ctypes.c_int(n),
                ctypes.c_int(nq),
                *self._sp_args(),
                self._jacsparse_ptr,
                self._adj_ptr,
                self._quad_ptr,
                self._dfdp_ptr,
                dptr(self._params),
                ctypes.c_double(float(t0)),
                ctypes.c_int(n_t),
                dptr(tvals),
                dptr(grads),
                ctypes.c_double(a_rtol),
                dptr(self._atol),
                ctypes.c_double(a_atol),
                ctypes.c_int64(self._max_steps),
                dptr(lam0),
                dptr(dLdp),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
        elif self._band is not None:
            rc = self._core.cvbdf_backward_recorded_banded(
                ctypes.c_void_p(self._rec_handle),
                ctypes.c_int(n),
                ctypes.c_int(nq),
                ctypes.c_int(self._band[0]),
                ctypes.c_int(self._band[1]),
                self._jacband_ptr,
                self._adj_ptr,
                self._quad_ptr,
                self._dfdp_ptr,
                dptr(self._params),
                ctypes.c_double(float(t0)),
                ctypes.c_int(n_t),
                dptr(tvals),
                dptr(grads),
                ctypes.c_double(a_rtol),
                dptr(self._atol),
                ctypes.c_double(a_atol),
                ctypes.c_int64(self._max_steps),
                dptr(lam0),
                dptr(dLdp),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                self._perm_ptr(),
            )
        else:
            rc = self._core.cvbdf_backward_recorded(
                ctypes.c_void_p(self._rec_handle),
                ctypes.c_int(n),
                ctypes.c_int(nq),
                self._jac_ptr,
                self._adj_ptr,
                self._quad_ptr,
                self._dfdp_ptr,
                dptr(self._params),
                ctypes.c_double(float(t0)),
                ctypes.c_int(n_t),
                dptr(tvals),
                dptr(grads),
                ctypes.c_double(a_rtol),
                dptr(self._atol),
                ctypes.c_double(a_atol),
                ctypes.c_int64(self._max_steps),
                dptr(lam0),
                dptr(dLdp),
                stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
        self.last_stats = _assemble_stats(stats)
        if rc != 0:
            raise SolverError(
                f"Native backward solve failed: "
                f"{_STATUS_MESSAGES.get(rc, f'code {rc}')}"
            )
        return lam0, dLdp[:nq]

    def solve_adjoint_backward(
        self,
        t0,
        tvals,
        ys_fwd,
        grads,
        *,
        adjoint_reltol: Optional[float] = None,
        adjoint_abstol: Optional[float] = None,
    ):
        """Backward-only adjoint pass against a recorded forward solution
        (``AdjointSolver.solve_backward`` analog).  Returns (lam0, dLdp)."""
        if self._method != "ADAMS":
            raise SolverError("solve_adjoint_backward requires method='ADAMS'")
        n = self._problem.n_states
        nq = self._problem.n_params
        tvals = np.ascontiguousarray(tvals, np.float64)
        ys_fwd = np.ascontiguousarray(ys_fwd, np.float64)
        grads = np.ascontiguousarray(grads, np.float64)
        n_t = len(tvals)
        if ys_fwd.shape != (n_t, n) or grads.shape != (n_t, n):
            raise SolverError(f"ys_fwd/grads must have shape {(n_t, n)}")
        a_rtol = self._rtol if adjoint_reltol is None else float(adjoint_reltol)
        a_atol = (
            float(np.max(self._atol))
            if adjoint_abstol is None
            else float(adjoint_abstol)
        )
        lam0 = np.full(n, np.nan)
        dLdp = np.full(max(nq, 1), np.nan)
        stats = np.zeros(8, np.int64)
        dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
        rc = self._core.cvadams_adjoint_backward(
            ctypes.c_int(n),
            ctypes.c_int(nq),
            self._rhs_ptr,
            self._adj_ptr,
            self._quad_ptr,
            ctypes.c_double(float(t0)),
            dptr(self._params),
            ctypes.c_int(n_t),
            dptr(tvals),
            dptr(ys_fwd),
            dptr(grads),
            ctypes.c_double(a_rtol),
            dptr(self._atol),
            ctypes.c_double(a_atol),
            ctypes.c_int64(self._max_steps),
            ctypes.c_int(self._adams_max_order),
            dptr(lam0),
            dptr(dLdp),
            stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        self.last_stats = _assemble_stats(stats)
        if rc != 0:
            raise SolverError(
                f"Native adjoint backward failed: "
                f"{_STATUS_MESSAGES.get(rc, f'code {rc}')}"
            )
        return lam0, dLdp[:nq]
