"""The reference's class API over the port's cores: ``Solver`` and
``AdjointSolver``.

Port of ``sunode_tpu/solver.py``, the surface the reference's users start
from (README "Reference-style class API"): numpy in, numpy out, params held
on the object (flat, as a dict, the derivative subset and the remainder),
outputs returned or written into caller buffers, pickling by configuration.
Every solve runs on the solver's ``device`` (the card unless the caller
passes ``device="cpu"``; without a card the default raises) through the
port's torch cores:

* a batch axis on y0 runs the batched cores,
  ``ops/bdf_batched.py::bdf_solve_batched`` and
  ``ops/adams_batched.py::adams_solve_batched``, with staggered or
  simultaneous forward sensitivities and rootfinding; on CUDA tensors every
  Adams attempt of a ``SympyProblem`` runs the history-attempt kernel
  (``csrc/adams_attempt.cu``, the systems 'forward', 'sensitivity' and
  'staged_sensitivity'), of any other problem the split kernels
  (``csrc/adams_split.cu``); 'band' and 'sparse' factor and solve through
  the banded LU's kernels (``csrc/banded.cu``);
* one chain runs the single cores, ``ops/bdf.py::bdf_solve`` and
  ``ops/adams.py::adams_solve`` (Adams with staggered sensitivities through
  the batched core at B=1, as the reference);
* ``AdjointSolver``'s backward pass is ``adjoint.py::adjoint_backward``
  (BDF) or ``adjoint.py::adjoint_backward_batched`` at B=1 (ADAMS, the
  history-attempt kernel's 'staged_adjoint' system on the card);
* the native host route: on ``device="cpu"`` with ``native_single`` (the
  default), one chain of a float64 ``SympyProblem`` whose options the C++
  integrators take (``_native_eligible``, ``_native_sens_eligible``,
  ``_native_adj_eligible``, decided by type and options before any build)
  runs ``native/cpu_solver.py::CpuSolver``: the reference's
  ``native/cvbdf.cpp`` with the problem's system compiled by g++, as the
  reference routes it.  A solver on the card never builds or calls it, and
  a failed build or load raises (there is no fallback to the torch cores).

Where the reference resumes a ``CV_TOO_MUCH_WORK`` lane through one jitted
executable with traced ``t0``/``first_step``/``max_steps``, the port calls
its host-loop cores again with the same per-lane arguments, and merges the
outputs, statuses, statistics and root records as the reference does.

``native_single=False`` keeps a CPU solver's single chain on the torch
cores; on the card it changes nothing, and a solve never leaves its device.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from sunode_torch.adjoint import adjoint_backward, adjoint_backward_batched
from sunode_torch.convert import device_or_raise
from sunode_torch.ops.adams import adams_options, adams_solve
from sunode_torch.ops.adams_batched import adams_solve_batched
from sunode_torch.ops.bdf import MAX_ORDER, BDFOptions, bdf_solve
from sunode_torch.ops.bdf_batched import bdf_solve_batched
from sunode_torch.problem import Problem

__all__ = ["Solver", "AdjointSolver", "SolverError"]


class SolverError(RuntimeError):
    """Raised when the integrator fails (the reference's ``SolverError``)."""


# step budgets as the reference clamps them (its traced int32 budget)
_I32_MAX = 2**31 - 1

_STATUS_MESSAGES = {
    1: "too many steps (max_steps exceeded; CV_TOO_MUCH_WORK analog)",
    2: "step size underflow (CV_TOO_CLOSE/CV_CONV_FAILURE analog)",
    3: "non-finite initial condition",
    4: "repeated error-test or Newton failures",
    5: "terminal root found (CV_ROOT_RETURN — success; see stats['roots_t'])",
    97: "transition adjoint ill-conditioned (residual check failed)",
    99: "adjoint checkpoint buffer overflow",
}

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def _np(v) -> np.ndarray:
    """A stat, output or status as numpy (tensors copied off the device)."""
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _merge_root_segments(old, new, resume, batched, cap):
    """Concatenate the resumed segment's root records after the first
    segment's for resuming lanes (a resume restarts the core with fresh
    root buffers; CVODES accumulates root reports across resumes).  Buffers
    hold the first ``cap`` roots; the summed ``n_roots`` keeps counting, so
    ``n_roots > cap`` signals truncation.  As ``sunode_tpu/solver.py:56``."""
    keys = ("roots_t", "roots_y", "roots_found")

    def lead(x):
        a = np.asarray(x)
        return a if batched else a[None]

    rs = lead(resume).astype(bool)
    o_n = lead(old["n_roots"]).astype(np.int64)
    n_n = lead(new["n_roots"]).astype(np.int64)
    bufs = {k: np.array(lead(old[k]), copy=True) for k in keys}
    base = np.minimum(o_n, cap)
    for j in range(cap):
        dst = base + j
        valid = rs & (j < n_n) & (dst < cap)
        if not np.any(valid):
            break
        idx = np.nonzero(valid)[0]
        for k in keys:
            bufs[k][idx, dst[idx]] = lead(new[k])[idx, j]
    out = {k: (v if batched else v[0]) for k, v in bufs.items()}
    merged_n = np.where(rs, o_n + n_n, o_n)
    out["n_roots"] = merged_n if batched else merged_n[0]
    return out


def _make_fd_jac(rhs):
    """Finite-difference Jacobian, ``linear_solver='dense_finitediff'``:
    one forward difference a column, ``(n, n, ...)`` over any trailing lane
    axis (``sunode_tpu/solver.py:89``)."""

    def fd_jac(t, y, p):
        f0 = rhs(t, y, p)
        eps = torch.sqrt(torch.tensor(torch.finfo(y.dtype).eps, dtype=y.dtype, device=y.device))
        hs = eps * torch.clamp(torch.abs(y), min=1.0)
        cols = []
        for j in range(y.shape[0]):
            yj = y.clone()
            yj[j] = yj[j] + hs[j]
            cols.append((rhs(t, yj, p) - f0) / hs[j])
        return torch.stack(cols, dim=1)

    return fd_jac


def _make_fd_jac_prod(rhs):
    """Directional finite difference ``J v`` (``'spgmr_finitediff'``,
    CVODES's difference-quotient jtimes), per lane over a trailing axis."""

    def fd_jac_prod(t, y, v, p):
        finfo = torch.finfo(y.dtype)
        eps = torch.sqrt(torch.tensor(finfo.eps, dtype=y.dtype, device=y.device))
        nv = torch.sqrt(torch.sum(v * v, dim=0))
        # the floor stays representable in the working type
        sig = eps * torch.clamp(nv, min=1.0) / torch.clamp(nv, min=finfo.tiny)
        return (rhs(t, y + sig * v, p) - rhs(t, y, p)) / sig

    return fd_jac_prod


class _SolverBase:
    """Shared params handling, output conversion and the device."""

    _problem: Problem
    _dtype: np.dtype = np.dtype(np.float64)

    def _set_dtype(self, dtype) -> None:
        dt = np.dtype(dtype)
        if dt not in _TORCH_DTYPE:
            raise ValueError(f"dtype must be float32 or float64, got {dt}")
        self._dtype = dt

    @property
    def _torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPE[self._dtype]

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, self._dtype), device=self._device)

    def _init_params_state(self):
        self._params = np.zeros(self._problem.n_all_params, dtype=self._dtype)

    def _device_system(self, kind: str):
        """The emitted system ``kind`` of ``symode/cuda_codegen.py`` for the
        history-attempt kernel at the solver's type, on CUDA and for a
        ``SympyProblem``; else None (the CPU's plain version, or the split
        kernels for a problem with no symbolic form)."""
        from sunode_torch.ops.adams_attempt import c_real
        from sunode_torch.symode import cuda_codegen
        from sunode_torch.symode.problem import SympyProblem

        if self._device.type != "cuda" or not isinstance(self._problem, SympyProblem):
            return None
        if kind not in self._device_systems:
            emit = getattr(cuda_codegen, f"{kind}_system")
            self._device_systems[kind] = emit(self._problem, c_real(self._torch_dtype))
        return self._device_systems[kind]

    def _lower_roots(self, roots):
        return None if roots is None else self._problem.make_root_fn(roots)

    def _native_ok(self) -> bool:
        """What every native route needs: ``native_single``, the CPU, a
        ``SympyProblem`` (the system compiles from its sympy form) and
        float64 (the C++ integrators' only type)."""
        from sunode_torch.symode.problem import SympyProblem

        return (self._native_single_enabled and self._device.type == "cpu"
                and isinstance(self._problem, SympyProblem)
                and self._dtype == np.float64)

    def _native_linear_solver_kwargs(self) -> dict:
        """``CpuSolver``'s ``linear_solver`` arguments for this solver's."""
        if self._linear_solver == "band":
            kw = self._linear_solver_kwargs
            return dict(linear_solver="band", linear_solver_kwargs=dict(
                lower_bandwidth=int(kw["lower_bandwidth"]),
                upper_bandwidth=int(kw["upper_bandwidth"])))
        if self._linear_solver == "sparse":
            return dict(linear_solver="sparse")
        if self._linear_solver in ("spgmr", "spgmr_finitediff"):
            return dict(linear_solver="spgmr",
                        linear_solver_kwargs=dict(self._linear_solver_kwargs))
        return {}

    # --- the reference's dtype accessors -----------------------------------
    @property
    def params_dtype(self):
        return self._problem.params_dtype

    @property
    def derivative_params_dtype(self):
        from sunode_torch.paramspec import ParamSpec, nest_path_dict

        sub = self._problem.params
        spec = nest_path_dict({p: sub.shapes[p] for p in sub.subset_paths})
        return ParamSpec(spec, dtype=sub.dtype).as_numpy_dtype()

    @property
    def remainder_params_dtype(self):
        return self._problem.params.remainder.as_numpy_dtype()

    # --- params get/set ---------------------------------------------------
    def set_params(self, params):
        """Flat params ``(n_all,)``, per lane ``(B, n_all)``, a dict or a
        structured array."""
        self._params = np.asarray(_np(self._problem.params.coerce_flat(params)),
                                  dtype=self._dtype).copy()

    def get_params(self):
        return self._params.copy()

    def set_params_dict(self, params: Mapping[str, Any]) -> None:
        self._params = np.asarray(_np(self._problem.params.flatten_dict(params)),
                                  dtype=self._dtype)

    def get_params_dict(self):
        return self._problem.params.unflatten(self._params)

    def set_derivative_params(self, params) -> None:
        spec = self._problem.params
        if isinstance(params, Mapping):
            sub = _np(spec.flatten_subset_dict(params))
        else:
            sub = np.asarray(params, dtype=self._dtype).reshape(-1)
        self._params[spec.subset_indices] = sub

    def set_remaining_params(self, params) -> None:
        spec = self._problem.params
        if isinstance(params, Mapping):
            rem = _np(spec.remainder.flatten_dict(params))
        else:
            rem = np.asarray(params, dtype=self._dtype).reshape(-1)
        self._params[spec.remainder_indices] = rem

    def as_xarray(self, tvals, out, sens_out=None, unstack_state=True, unstack_params=True):
        return self._problem.solution_to_xarray(
            tvals, out, sensitivity=sens_out, params=self._params,
            unstack_state=unstack_state, unstack_params=unstack_params,
        )

    def _check_status(self, status, where="solve"):
        status = np.asarray(status)
        if (status != 0).any():
            codes = sorted(set(int(s) for s in status.reshape(-1) if s != 0))
            msgs = "; ".join(_STATUS_MESSAGES.get(c, f"code {c}") for c in codes)
            raise SolverError(f"Integration failed in {where}: {msgs}")


class Solver(_SolverBase):
    """Forward (and forward-sensitivity) solver, the reference's ``Solver``:
    the same arguments and defaults (tolerances 1e-10), plus ``device``.

    ``solve(t0, tvals, y0)`` with y0 ``(n,)``, a dict or a ``state_dtype``
    array runs one chain; ``(B, n)`` runs the batched cores, with params
    shared or per lane (``set_params`` of ``(B, n_all)``) and per-lane grids
    ``tvals (B, n_t)``.  A lane
    that runs out of ``max_steps`` resumes from its final time, state and
    step size with a doubled budget, up to ``max_retries`` times
    (``last_stats['n_resumes']``).  ``roots`` (a record-view event function,
    lowered by ``problem.make_root_fn``) turns on rootfinding; a terminal
    root (status 5) is a success."""

    def __init__(
        self,
        problem: Problem,
        *,
        abstol: Any = None,
        reltol: Optional[float] = None,
        sens_mode: Optional[str] = None,
        scaling_factors: Optional[np.ndarray] = None,
        constraints: Optional[np.ndarray] = None,
        solver: str = "BDF",
        linear_solver: str = "dense",
        linear_solver_kwargs: Optional[dict] = None,
        max_steps: Optional[int] = None,
        max_retries: int = 5,
        options: Optional[BDFOptions] = None,
        native_single: bool = True,
        roots: Optional[Callable] = None,
        root_cap: int = 8,
        root_terminal: bool = True,
        root_directions: Optional[Any] = None,
        dtype: Any = np.float64,
        device="cuda",
    ):
        if solver not in ("BDF", "ADAMS"):
            raise ValueError("solver must be 'BDF' or 'ADAMS'")
        self._set_dtype(dtype)
        if self._dtype == np.float32:
            _rt = 1e-10 if reltol is None else reltol
            if options is not None:
                _rt = options.rtol
            _rt = float(np.min(_rt))
            if _rt < 1e-7:
                raise ValueError(
                    f"reltol={_rt:g} is below float32 precision; pass "
                    "reltol>=1e-7 (1e-5 is a good default) with dtype=np.float32"
                )
        if sens_mode not in (None, "simultaneous", "staggered"):
            if sens_mode == "staggered1":
                raise ValueError("staggered1 not implemented.")
            raise ValueError('sens_mode must be one of "simultaneous" and "staggered"')
        known_linsol = ("dense", "dense_finitediff", "band", "sparse", "spgmr",
                        "spgmr_finitediff")
        if linear_solver not in known_linsol:
            raise ValueError(f"linear_solver must be one of {known_linsol}")
        self._device = device_or_raise(device)
        self._problem = problem
        # event functions, re-lowered on unpickle
        self._roots_src = roots
        self._root_fn = self._lower_roots(roots)
        self._root_cap = int(root_cap)
        self._root_terminal = bool(root_terminal)
        self._root_directions = None if root_directions is None else np.asarray(root_directions)
        self._solver_kind = solver
        self._sens_mode = sens_mode
        self._compute_sens = sens_mode is not None
        self._linear_solver = linear_solver
        self._max_retries = int(max_retries)
        self._init_params_state()

        if options is None:
            options = BDFOptions(
                rtol=1e-10 if reltol is None else reltol,
                atol=1e-10 if abstol is None else abstol,
                max_steps=100_000 if max_steps is None else max_steps,
                constraints=None if constraints is None else np.asarray(constraints),
                sens_pbar=scaling_factors,
                sens_staggered=(sens_mode == "staggered"),
            )
            if solver == "ADAMS":
                options = adams_options(options)
        else:
            conflicting = {"abstol": abstol, "reltol": reltol, "max_steps": max_steps,
                           "constraints": constraints, "scaling_factors": scaling_factors}
            bad = [k for k, v in conflicting.items() if v is not None]
            if bad:
                raise ValueError(
                    f"Pass {bad} inside options=BDFOptions(...) — they are "
                    "ignored when an explicit options object is given"
                )
            if sens_mode is not None:
                options = options._replace(sens_staggered=(sens_mode == "staggered"))
        self._options = options
        self._linear_solver_kwargs = dict(linear_solver_kwargs or {})
        # one chain on the CPU runs the C++ integrators (_native_eligible)
        self._native_single_enabled = bool(native_single)
        self._init_derived()
        self.last_stats: Optional[dict] = None

    def _init_derived(self):
        problem = self._problem
        linear_solver = self._linear_solver
        rhs = problem.make_rhs()
        self._jac_prod = None
        if linear_solver == "dense_finitediff":
            jacfn = _make_fd_jac(rhs)
        elif linear_solver == "band":
            kw = self._linear_solver_kwargs
            if "lower_bandwidth" not in kw or "upper_bandwidth" not in kw:
                raise ValueError(
                    "linear_solver='band' requires linear_solver_kwargs with "
                    "'lower_bandwidth' and 'upper_bandwidth'"
                )
            lb, ub = int(kw["lower_bandwidth"]), int(kw["upper_bandwidth"])
            jacfn = problem.make_banded_jac(lb, ub)
            self._options = self._options._replace(linear_solver="band", band_lower=lb,
                                                   band_upper=ub)
        elif linear_solver == "sparse":
            from sunode_torch.ops.sparsity import SparsePlan, make_colored_banded_jac

            kw = self._linear_solver_kwargs
            pattern = (np.asarray(kw["sparsity"], bool) if "sparsity" in kw
                       else problem.jac_sparsity())
            plan = SparsePlan(pattern, permute=kw.get("permute", True),
                              border=kw.get("border", "auto"))
            self._sparse_plan = plan
            jacfn = make_colored_banded_jac(rhs, plan)
            self._options = self._options._replace(
                linear_solver="sparse", band_lower=plan.lower, band_upper=plan.upper,
                sparse_perm=plan.perm, sparse_border=plan.k_border,
            )
        elif linear_solver in ("spgmr", "spgmr_finitediff"):
            jacfn = problem.make_jac_dense()  # unused by the spgmr path
            self._options = self._options._replace(linear_solver="spgmr")
            self._jac_prod = (problem.make_rhs_jac_prod() if linear_solver == "spgmr"
                              else _make_fd_jac_prod(rhs))
        else:
            jacfn = problem.make_jac_dense()
        self._rhs = rhs
        self._jac = jacfn
        self._sens_rhs = problem.make_sensitivity_rhs() if self._compute_sens else None
        self._device_systems: dict = {}
        self._fn_cache: dict = {}

    # --- pickling: derived functions dropped, rebuilt on load --------------
    def __getstate__(self):
        state = self.__dict__.copy()
        for key in ("_rhs", "_jac", "_sens_rhs", "_jac_prod", "_fn_cache", "_device_systems",
                    "last_stats", "_root_fn", "_sparse_plan", "_native_solver"):
            state.pop(key, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._init_derived()
        self._root_fn = self._lower_roots(getattr(self, "_roots_src", None))
        self.last_stats = None

    def make_output_buffers(self, tvals):
        n_states, n_params = self._problem.n_states, self._problem.n_params
        y_vals = np.zeros((len(tvals), n_states), dtype=self._dtype)
        if self._compute_sens:
            return y_vals, np.zeros((len(tvals), n_params, n_states), dtype=self._dtype)
        return y_vals

    def _adams_sens_setup(self, opts=None):
        """``solver='ADAMS'`` with simultaneous sensitivities: the augmented
        ``[y; vec S]`` through the functional-iteration core, with the
        reference's tolerances for the sensitivity rows (``sens_err_con``
        False excludes them from the norm without diluting the state's)."""
        if opts is None:
            opts = self._options
        n, k = self._problem.n_states, self._problem.n_params
        rhs, sens_rhs = self._rhs, self._sens_rhs
        atol = np.broadcast_to(np.asarray(opts.atol, np.float64), (n,))
        pbar = (np.ones(k) if opts.sens_pbar is None
                else np.broadcast_to(np.asarray(opts.sens_pbar, np.float64), (k,)))
        rtol_v = np.broadcast_to(np.asarray(opts.rtol, np.float64), (n,))
        rtol_aug = np.concatenate([rtol_v, np.tile(rtol_v, k)])
        if opts.sens_err_con:
            atol_S = (atol[None, :] / pbar[:, None]).reshape(-1)
            atol_y = atol
        else:
            atol_S = np.full(k * n, 1e12)
            f = 1.0 / np.sqrt(1.0 + k)
            atol_y = atol * f
            rtol_aug = rtol_aug * f
        cons = opts.constraints
        cons_aug = (None if cons is None else np.concatenate(
            [np.broadcast_to(np.asarray(cons, np.float64), (n,)), np.zeros(k * n)]))
        opts_aug = opts._replace(atol=np.concatenate([atol_y, atol_S]), rtol=rtol_aug,
                                 constraints=cons_aug)

        def rhs_aug(t, z, p):
            lanes = tuple(z.shape[1:])
            y, S = z[:n], z[n:].reshape((k, n) + lanes)
            return torch.cat([rhs(t, y, p), sens_rhs(t, y, S, p).reshape((k * n,) + lanes)])

        return rhs_aug, opts_aug

    def _native_common(self) -> bool:
        """The options both B=1 native routes take (``sunode_tpu/solver.py``
        ``_native_eligible`` and ``_native_sens_eligible``)."""
        o = self._options
        return (
            self._native_ok()
            and np.ndim(o.rtol) == 0
            and o.first_step is None
            and (self._solver_kind == "ADAMS" or o.max_order == MAX_ORDER)
            and not np.isfinite(o.max_step)
            and o.min_step == 0.0
            and o.save_steps == 0
        )

    def _native_eligible(self) -> bool:
        """A B=1 solve without sensitivities runs ``CpuSolver.solve``:
        'band', 'sparse' and 'spgmr' on BDF only; event functions when they
        have a symbolic form, with a direct linear solver."""
        o = self._options
        ls_ok = self._linear_solver == "dense" or (
            self._linear_solver in ("band", "sparse", "spgmr", "spgmr_finitediff")
            and self._solver_kind == "BDF"
        )
        roots_ok = self._root_fn is None or (
            self._roots_src is not None and self._linear_solver in ("dense", "band", "sparse")
        )
        return (self._native_common() and not self._compute_sens and roots_ok and ls_ok
                and not o.use_ndf)

    def _native_sens_eligible(self) -> bool:
        """A B=1 solve with forward sensitivities runs
        ``CpuSolver.solve_sens`` (ADAMS functional iteration, or BDF with
        one Newton matrix for the state and the sensitivities)."""
        o = self._options
        ls_ok = self._linear_solver == "dense" or (
            self._linear_solver in ("band", "sparse") and self._solver_kind == "BDF"
        )
        return (
            self._native_common()
            and self._compute_sens
            and self._root_fn is None
            and o.sens_pbar is None
            and ls_ok
            and (o.constraints is None or self._solver_kind == "BDF")
        )

    def _native_single(self):
        """The ``CpuSolver`` of the B=1 routes, built at first use; a failed
        build raises."""
        if getattr(self, "_native_solver", None) is None:
            from sunode_torch.native.cpu_solver import CpuSolver

            cons = self._options.constraints
            root_kw = {}
            if self._roots_src is not None:
                root_kw = dict(roots=self._roots_src, root_directions=self._root_directions,
                               root_cap=self._root_cap, root_terminal=self._root_terminal)
            self._native_solver = CpuSolver(
                self._problem,
                abstol=np.asarray(self._options.atol),
                reltol=float(self._options.rtol),
                max_steps=int(self._options.max_steps) * 2**self._max_retries,
                method=self._solver_kind,
                adams_max_order=int(self._options.adams_max_order),
                constraints=None if cons is None else np.asarray(cons),
                **root_kw,
                **self._native_linear_solver_kwargs(),
            )
        return self._native_solver

    def _solver_fn(self, n_t: int, batched: bool):
        """``run(t0, y0, params, tvals, sens0, max_steps, first_step) -> (ys,
        sens, status, stats)`` on the solver's device, built once per
        ``(n_t, batched)``; ``t0`` and ``first_step`` are per lane when
        batched (a resumed lane restarts at its own time and step)."""
        key = (n_t, batched)
        if key in self._fn_cache:
            return self._fn_cache[key]
        opts = self._options
        rhs, jac, sens_rhs, jac_prod = self._rhs, self._jac, self._sens_rhs, self._jac_prod
        n, k = self._problem.n_states, self._problem.n_params
        sens, kind = self._compute_sens, self._solver_kind
        staggered = sens and opts.sens_staggered
        root_kw = {} if self._root_fn is None else dict(
            root_fn=self._root_fn, root_cap=self._root_cap, root_terminal=self._root_terminal,
            root_directions=self._root_directions,
        )
        if kind == "ADAMS" and sens and not staggered:
            rhs_aug, opts_aug = self._adams_sens_setup(opts)
            # event functions see the state block of the augmented vector
            root_kw_aug = dict(root_kw)
            if "root_fn" in root_kw_aug:
                rf = root_kw_aug["root_fn"]
                root_kw_aug["root_fn"] = lambda t, z, p: rf(t, z[:n], p)

        def adams_staggered(t0, y0, params, tvals, sens0, ms, fs):
            return adams_solve_batched(
                rhs, t0, y0, params, tvals, opts._replace(max_steps=ms), sens_rhs=sens_rhs,
                sens0=sens0, first_step=fs, batched_fns=True,
                device_system=self._device_system("forward"),
                sens_device_system=self._device_system("staged_sensitivity"), **root_kw,
            )

        def run_batched(t0, y0, params, tvals, sens0, ms, fs):
            if kind == "ADAMS":
                if staggered:
                    res = adams_staggered(t0, y0, params, tvals, sens0, ms, fs)
                    return res.ys, res.sens, res.status, res.stats
                if sens:
                    B = y0.shape[0]
                    res = adams_solve_batched(
                        rhs_aug, t0, torch.cat([y0, sens0.reshape(B, -1)], dim=1), params,
                        tvals, opts_aug._replace(max_steps=ms), first_step=fs, batched_fns=True,
                        device_system=self._device_system("sensitivity"), **root_kw_aug,
                    )
                    stats = dict(res.stats)
                    if "roots_y" in stats:  # the state block only
                        stats["roots_y"] = stats["roots_y"][:, :, :n]
                    return (res.ys[:, :, :n], res.ys[:, :, n:].reshape(B, n_t, k, n),
                            res.status, stats)
                res = adams_solve_batched(
                    rhs, t0, y0, params, tvals, opts._replace(max_steps=ms), first_step=fs,
                    batched_fns=True, device_system=self._device_system("forward"), **root_kw,
                )
                return res.ys, None, res.status, res.stats
            res = bdf_solve_batched(
                rhs, jac, t0, y0, params, tvals, opts._replace(max_steps=ms),
                sens_rhs=sens_rhs, S0=sens0, first_step=fs, batched_fns=True,
                jac_prod=jac_prod, **root_kw,
            )
            return res.ys, (res.sens if sens else None), res.status, res.stats

        def run_single(t0, y0, params, tvals, sens0, ms, fs):
            o = opts._replace(max_steps=ms)
            if kind == "ADAMS":
                if staggered:
                    # CV_STAGGERED through the batched core at B=1
                    res = adams_staggered(t0, y0[None], params[None], tvals, sens0[None], ms, fs)
                    stats = {kk: (vv[0] if torch.is_tensor(vv) and vv.ndim > 0 else vv)
                             for kk, vv in res.stats.items()}
                    return res.ys[0], res.sens[0], res.status[0], stats
                if sens:
                    res = adams_solve(rhs_aug, t0, torch.cat([y0, sens0.reshape(-1)]), params,
                                      tvals, opts_aug._replace(max_steps=ms), first_step=fs,
                                      **root_kw_aug)
                    stats = dict(res.stats)
                    if "roots_y" in stats:
                        stats["roots_y"] = stats["roots_y"][:, :n]
                    return res.ys[:, :n], res.ys[:, n:].reshape(n_t, k, n), res.status, stats
                res = adams_solve(rhs, t0, y0, params, tvals, o, first_step=fs, **root_kw)
                return res.ys, None, res.status, res.stats
            res = bdf_solve(rhs, jac, t0, y0, params, tvals, o, sens_rhs=sens_rhs, S0=sens0,
                            jac_prod=jac_prod, first_step=fs, **root_kw)
            return res.ys, (res.sens if sens else None), res.status, res.stats

        self._fn_cache[key] = run_batched if batched else run_single
        return self._fn_cache[key]

    def _run(self, fn, t0, y0, params, tvals, sens0, ms, fs, batched):
        """One call of the solve: numpy in, numpy out (stats as numpy)."""
        T = self._tensor
        ys, sens, status, stats = fn(
            T(t0) if batched else float(t0), T(y0), T(params), T(tvals),
            None if sens0 is None else T(sens0), int(ms),
            T(fs) if batched else float(fs),
        )
        return (_np(ys), None if sens is None else _np(sens), _np(status),
                {k: _np(v) for k, v in stats.items()})

    def solve(self, t0, tvals, y0, y_out=None, *, sens0=None, sens_out=None):
        """Solve and fill ``y_out`` (the reference's ``solve``).

        ``y0`` may be a nested dict, a structured array (``state_dtype``) or
        a flat vector; a leading batch axis runs the batched cores.
        Returns ``y_out`` (and fills ``sens_out`` with sensitivities), or,
        without buffers, ``ys`` (``(ys, sens)`` with sensitivities)."""
        dt = self._dtype
        y0_flat = np.asarray(_np(self._problem.states.coerce_flat(y0)), dt)
        params = np.asarray(self._params, dt)
        batched = y0_flat.ndim == 2
        if batched:
            B = y0_flat.shape[0]
            params = np.broadcast_to(params, (B, params.shape[-1]))
        tva = np.asarray(tvals)
        if tva.ndim == 2 and (not batched or tva.shape[0] != y0_flat.shape[0]):
            raise ValueError(
                "per-lane tvals requires a matching batched y0: got "
                f"tvals {tva.shape} with y0 {np.shape(y0_flat)}"
            )
        if not batched and (self._native_eligible() or self._native_sens_eligible()):
            return self._solve_native(t0, tva, y0_flat, y_out, sens0, sens_out)
        n, k = self._problem.n_states, self._problem.n_params
        if self._compute_sens and sens0 is None:
            sens0 = np.zeros(((B,) if batched else ()) + (k, n), dtype=dt)
        fs_init = (float(self._options.first_step) if self._options.first_step is not None
                   else -1.0)
        t0_arr = np.full((B,), t0, dt) if batched else dt.type(t0)
        fs0 = np.full((B,), fs_init, dt) if batched else dt.type(fs_init)
        fn = self._solver_fn(tva.shape[-1], batched)
        base_ms = int(self._options.max_steps)
        ys, sens, status, stats = self._run(fn, t0_arr, y0_flat, params, tva, sens0,
                                            min(base_ms, _I32_MAX), fs0, batched)
        # CV_TOO_MUCH_WORK: a lane out of steps resumes from its final time,
        # state and step size with a fresh, doubled budget (the reference's
        # resume in place); the other lanes keep their first results
        retry = 0
        total_steps = np.asarray(stats["n_steps"]).copy()
        while np.any(status == 1) and retry < self._max_retries:
            retry += 1
            resume = status == 1
            t_res = np.where(resume, stats["final_time"], tva[..., -1])
            z_res = stats["final_state"]
            y_res = z_res[..., :n]
            sens_res = (z_res[..., n: n + k * n].reshape((-1, k, n) if batched else (k, n))
                        if self._compute_sens else None)
            ys2, sens2, status2, stats2 = self._run(
                fn, t_res if batched else dt.type(t_res), y_res, params, tva, sens_res,
                min(base_ms * 2**retry, _I32_MAX), stats["final_step_size"], batched,
            )
            tol_t = 1e-14 * (1.0 + np.abs(t_res))
            if batched:
                tva_b = tva if tva.ndim == 2 else tva[None, :]
                keep_old = (~resume[:, None]) | (tva_b <= (t_res + tol_t)[:, None])
            else:
                keep_old = (tva <= t_res + tol_t) | ~resume
            ys = np.where(keep_old[..., None], ys, ys2)
            if self._compute_sens:
                sens = np.where(keep_old[..., None, None], sens, sens2)
            status = np.where(resume, status2, status)
            root_merged = None
            if self._root_fn is not None and "roots_t" in stats2:
                root_merged = _merge_root_segments(stats, stats2, resume, batched,
                                                   self._root_cap)
            merged = {}
            for k2, new_a in stats2.items():
                if root_merged is not None and k2 in root_merged:
                    merged[k2] = root_merged[k2]
                    continue
                old_a = stats.get(k2, new_a)
                if (batched and new_a.shape == old_a.shape and new_a.ndim >= 1
                        and new_a.shape[0] == resume.shape[0]):
                    r = resume.reshape((-1,) + (1,) * (new_a.ndim - 1))
                    merged[k2] = np.where(r, new_a, old_a)
                else:
                    merged[k2] = new_a
            stats = merged
            total_steps = total_steps + stats2["n_steps"]
        self.last_stats = dict(stats)
        self.last_stats["n_steps_total"] = total_steps
        self.last_stats["n_resumes"] = retry
        if y_out is not None:
            y_out[...] = ys
        if self._compute_sens and sens_out is not None:
            sens_out[...] = sens
        status_f = status
        if self._root_fn is not None:
            # CV_ROOT_RETURN is a successful early return: outputs past the
            # root are NaN and the root is in last_stats['roots_*']
            status_f = np.where(status_f == 5, 0, status_f)
        self._check_status(status_f)
        if y_out is None:
            return (ys, sens) if self._compute_sens else ys
        return y_out

    def _solve_native(self, t0, tvals, y0, y_out, sens0, sens_out):
        """One chain through the C++ integrators (the reference's B=1
        routes); ``CpuSolver`` raises ``SolverError`` on a failed solve."""
        ns = self._native_single()
        ns._params = np.ascontiguousarray(self._params, np.float64)
        tvals = np.asarray(tvals, np.float64)
        sens = None
        if self._compute_sens:
            ys, sens = ns.solve_sens(t0, tvals, y0, sens0=sens0, sens_mode=self._sens_mode)
        else:
            ys = ns.solve(t0, tvals, y0)
        self.last_stats = dict(ns.last_stats)
        if sens_out is not None and sens is not None:
            sens_out[...] = sens
        if y_out is not None:
            y_out[...] = ys
            return y_out
        return (ys, sens) if self._compute_sens else ys

    @property
    def current_stats(self):
        """The counters of the last solve (the reference's ``current_stats``)."""
        return self.last_stats


class AdjointSolver(_SolverBase):
    """Adjoint-gradient solver of one chain, the reference's
    ``AdjointSolver``: ``solve_forward`` records checkpoints (CVodeF) and
    ``solve_backward`` integrates the adjoint over them (CVodeB), returning
    the parameter gradient and ``-lambda(t0)`` (the reference's sign).
    ``interpolation`` 'hermite' or 'polynomial'; ``solver``/``adjoint_solver``
    'BDF' or 'ADAMS' (ADAMS backward needs an ADAMS forward); 'band' and
    'sparse' for BDF/BDF; ``roots`` stops the recording at a terminal root.
    Plus ``device``."""

    def __init__(
        self,
        problem: Problem,
        *,
        abstol: float = 1e-10,
        reltol: float = 1e-10,
        checkpoint_n: int = 500_000,
        interpolation: str = "hermite",
        constraints: Optional[np.ndarray] = None,
        solver: str = "BDF",
        adjoint_solver: str = "BDF",
        max_steps: int = 100_000,
        max_retries: int = 5,
        adjoint_abstol: float = 1e-10,
        adjoint_reltol: float = 1e-10,
        linear_solver: str = "dense",
        linear_solver_kwargs: Optional[dict] = None,
        native_single: bool = True,
        roots: Optional[Callable] = None,
        root_directions: Optional[Any] = None,
        root_cap: int = 8,
        dtype: Any = np.float64,
        device="cuda",
    ):
        if solver not in ("BDF", "ADAMS") or adjoint_solver not in ("BDF", "ADAMS"):
            raise ValueError("solver/adjoint_solver must be 'BDF' or 'ADAMS'")
        self._set_dtype(dtype)
        if self._dtype == np.float32 and (
            float(np.min(reltol)) < 1e-7 or float(np.min(adjoint_reltol)) < 1e-7
        ):
            raise ValueError(
                f"reltol={reltol!r}/adjoint_reltol={adjoint_reltol!r} below "
                "float32 precision; pass >=1e-7 (1e-5 is a good default) "
                "with dtype=np.float32"
            )
        if adjoint_solver == "ADAMS" and solver != "ADAMS":
            raise NotImplementedError("adjoint_solver='ADAMS' requires solver='ADAMS'")
        if interpolation not in ("polynomial", "hermite"):
            raise ValueError("interpolation must be 'polynomial' or 'hermite'")
        if linear_solver not in ("dense", "band", "sparse"):
            raise ValueError("AdjointSolver linear_solver must be 'dense', 'band' or 'sparse'")
        if linear_solver != "dense" and (solver != "BDF" or adjoint_solver != "BDF"):
            raise ValueError(
                f"linear_solver={linear_solver!r} requires solver='BDF' and "
                "adjoint_solver='BDF'"
            )
        self._device = device_or_raise(device)
        self._problem = problem
        self._roots_src = roots
        self._root_fn = self._lower_roots(roots)
        self._root_cap = int(root_cap)
        self._root_directions = None if root_directions is None else np.asarray(root_directions)
        self._linear_solver = linear_solver
        self._linear_solver_kwargs = dict(linear_solver_kwargs or {})
        self._solver_kind = solver
        self._adjoint_solver_kind = adjoint_solver
        self._interpolation = interpolation
        self._checkpoint_n = int(checkpoint_n)
        self._max_retries = int(max_retries)
        self._init_params_state()
        self._options = BDFOptions(
            rtol=reltol, atol=abstol, max_steps=max_steps,
            constraints=None if constraints is None else np.asarray(constraints),
            save_steps=self._checkpoint_n,
        )
        if interpolation == "polynomial":
            # CV_POLYNOMIAL reads only the (t, y) rows
            self._options = self._options._replace(hermite_order=3)
        self._adjoint_options = BDFOptions(rtol=adjoint_reltol, atol=adjoint_abstol,
                                           max_steps=max_steps)
        # one chain on the CPU runs the C++ CVodeF/CVodeB pair (_native_adj_eligible)
        self._native_single_enabled = bool(native_single)
        self._init_derived()
        self._last_forward: Optional[dict] = None
        self.last_stats: Optional[dict] = None

    def _init_derived(self):
        from sunode_torch.wrappers.as_torch import _structured_setup

        problem = self._problem
        self._rhs = problem.make_rhs()
        self._adjoint_rhs = problem.make_adjoint_rhs()
        self._quad_rhs = problem.make_adjoint_quad_rhs()
        # the Newton structure of both directions (the backward matrix is
        # -J^T: the bandwidths swap, the sparse plan is the transpose's)
        self._jac, self._options, self._adjoint_jac, self._adjoint_options = _structured_setup(
            problem, self._rhs, self._linear_solver, self._linear_solver_kwargs, self._options,
            self._adjoint_options,
        )
        self._device_systems: dict = {}

    def __getstate__(self):
        state = self.__dict__.copy()
        for key in ("_rhs", "_jac", "_adjoint_rhs", "_adjoint_jac", "_quad_rhs",
                    "_device_systems", "_last_forward", "last_stats", "_root_fn",
                    "_native_adj_solver"):
            state.pop(key, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._init_derived()
        self._root_fn = self._lower_roots(getattr(self, "_roots_src", None))
        self._last_forward = None
        self.last_stats = None

    def make_output_buffers(self, tvals):
        """``(y_out, grad_out, lamda_out)``."""
        n_states, n_params = self._problem.n_states, self._problem.n_params
        return (np.zeros((len(tvals), n_states), dtype=self._dtype),
                np.zeros(n_params, dtype=self._dtype), np.zeros(n_states, dtype=self._dtype))

    def _native_adj_eligible(self) -> bool:
        """The pair runs the C++ integrators: ADAMS/ADAMS (the forward
        solve, then the augmented backward against its observations) or
        BDF/BDF (the recorded forward, ``cvbdf_forward_record``, and the
        backward over it), 'band' and 'sparse' on BDF/BDF; no events, no
        constraints."""
        o = self._options
        kinds = (self._solver_kind, self._adjoint_solver_kind)
        ls_ok = self._linear_solver == "dense" or kinds == ("BDF", "BDF")
        return (
            self._native_ok()
            and kinds in (("ADAMS", "ADAMS"), ("BDF", "BDF"))
            and np.ndim(o.rtol) == 0
            and ls_ok
            and self._root_fn is None
            and o.constraints is None
            and o.first_step is None
            and not np.isfinite(o.max_step)
            and o.min_step == 0.0
        )

    def _native_adj(self):
        """The ``CpuSolver`` of the native pair, built at first use; a
        failed build raises."""
        if getattr(self, "_native_adj_solver", None) is None:
            from sunode_torch.native.cpu_solver import CpuSolver

            ls_kw = self._native_linear_solver_kwargs()
            self._native_adj_solver = CpuSolver(
                self._problem,
                abstol=np.asarray(self._options.atol),
                reltol=float(self._options.rtol),
                max_steps=int(self._options.max_steps) * 2**self._max_retries,
                method=self._solver_kind,
                adams_max_order=int(self._options.adams_max_order),
                hermite_order=int(self._options.hermite_order),
                interpolation=self._interpolation,
                **ls_kw,
            )
        return self._native_adj_solver

    def _forward(self, t0, y0, params, tvals):
        root_kw = {} if self._root_fn is None else dict(
            root_fn=self._root_fn, root_cap=self._root_cap, root_terminal=True,
            root_directions=self._root_directions,
        )
        if self._solver_kind == "ADAMS":
            return adams_solve(self._rhs, t0, y0, params, tvals, self._options, **root_kw)
        return bdf_solve(self._rhs, self._jac, t0, y0, params, tvals, self._options, **root_kw)

    def _backward(self, saved, tend, tvals, grads, params, max_steps):
        """``(lambda, quad, status, stats)`` of the backward pass."""
        n_deriv = self._problem.n_params
        opts = self._adjoint_options._replace(max_steps=max_steps)
        if self._adjoint_solver_kind == "ADAMS":
            # the fused Adams backward of the batched path at B=1: the
            # recording as one lane, its (y | f [| fd]) rows packed
            yf = [saved["y"], saved["f"]] + ([saved["fd"]] if "fd" in saved else [])
            saved_b = {
                "t": saved["t"][:, None], "y": saved["y"][:, :, None],
                "f": saved["f"][:, :, None], "yf": torch.cat(yf, dim=1)[:, :, None],
                "n_saved": torch.tensor([int(saved["n_saved"])], dtype=torch.int32,
                                        device=self._device),
                "overflow": torch.tensor([bool(saved["overflow"])], device=self._device),
            }
            if "fd" in saved:
                saved_b["fd"] = saved["fd"][:, :, None]
            if "L" in saved:
                saved_b["L"] = saved["L"][:, None]
            adj = adjoint_backward_batched(
                self._adjoint_rhs, self._adjoint_jac, self._quad_rhs, saved_b, tend, tvals,
                grads[None], params[None], n_deriv, opts, method="ADAMS",
                interpolation=self._interpolation,
                device_system=self._device_system("staged_adjoint"),
            )
            stats = {k: (v[0] if torch.is_tensor(v) and v.ndim > 0 else v)
                     for k, v in adj.stats.items()}
            return adj.lamda[0], adj.quad[0], adj.status[0], stats
        adj = adjoint_backward(
            self._adjoint_rhs, self._adjoint_jac, self._quad_rhs, saved, tend, tvals, grads,
            params, n_deriv, opts, interpolation=self._interpolation,
        )
        return adj.lamda, adj.quad, adj.status, adj.stats

    def solve_forward(self, t0, tvals, y0, y_out=None):
        """Forward pass recording checkpoints (CVodeF)."""
        dt = self._dtype
        y0_flat = np.asarray(_np(self._problem.states.coerce_flat(y0)), dt)
        if y0_flat.ndim != 1:
            raise ValueError(f"AdjointSolver solves one chain: y0 must be flat, got "
                             f"{y0_flat.shape}")
        if self._native_adj_eligible():
            ns = self._native_adj()
            ns._params = np.ascontiguousarray(self._params, np.float64)
            tv = np.asarray(tvals, np.float64)
            if self._solver_kind == "BDF":
                # CVodeF: the dense record stays in native memory for the backward
                ys = ns.solve_forward_recorded(t0, tv, y0_flat)
            else:
                ys = ns.solve(t0, tv, y0_flat)
            self.last_stats = dict(ns.last_stats)
            self._last_forward = dict(native_ys=ys, native_mode=self._solver_kind,
                                      native_tvals=tv, t0=float(t0), params=self._params.copy())
            if y_out is not None:
                y_out[...] = ys
                return y_out
            return ys
        T = self._tensor
        res = self._forward(float(t0), T(y0_flat), T(self._params), T(tvals))
        self._last_forward = dict(saved=res.saved, t0=float(t0), params=self._params.copy())
        self.last_stats = {k: _np(v) for k, v in res.stats.items()}
        thin = int(np.max(self.last_stats.get("checkpoint_thinning_levels", 0)))
        if thin > 0:
            warnings.warn(
                f"adjoint checkpoint buffer filled: the recording was "
                f"thinned {thin}x (interpolation spacing grew 2^{thin}; "
                f"Hermite error grows ~16x per level).  Gradients remain "
                f"usable but degraded — increase checkpoint_n "
                f"(stats['checkpoint_thinning_levels'])",
                RuntimeWarning,
                stacklevel=2,
            )
        ys = _np(res.ys)
        if y_out is not None:
            y_out[...] = ys
        status_f = np.asarray(res.status)
        if self._root_fn is not None:
            # a terminal root is a successful early return: the record ends there
            status_f = np.where(status_f == 5, 0, status_f)
        self._check_status(status_f, "solve_forward")
        return ys if y_out is None else y_out

    def checkpoint_info(self) -> dict:
        """The checkpoint table recorded by :meth:`solve_forward` (the
        CVodeGetAdjCheckPointsInfo analog): ``n_recorded``, ``capacity``,
        ``times``, ``t_first``/``t_last``, ``dt_min``/``dt_max``/``dt_mean``,
        ``thinning_level`` and ``overflow``.  On the native route
        ``capacity`` is None (the record grows without bound)."""
        if self._last_forward is None:
            raise SolverError("checkpoint_info called before solve_forward")
        fwd = self._last_forward
        if "native_ys" in fwd:
            # BDF: the native record's times; ADAMS: the backward re-solves y
            # from the recorded observations, which are its checkpoints
            times = (self._native_adj().checkpoint_times() if fwd["native_mode"] == "BDF"
                     else fwd["native_tvals"])
            capacity, thin = None, 0
        else:
            saved = fwd["saved"]
            t_all = _np(saved["t"])
            times = t_all[:int(saved["n_saved"])]
            capacity = int(t_all.shape[0])
            thin = int(np.max((self.last_stats or {}).get("checkpoint_thinning_levels", 0)))
        dts = np.diff(times) if len(times) > 1 else np.zeros(0)
        return dict(
            n_recorded=int(len(times)),
            capacity=capacity,
            times=times,
            t_first=float(times[0]) if len(times) else np.nan,
            t_last=float(times[-1]) if len(times) else np.nan,
            dt_min=float(dts.min()) if len(dts) else np.nan,
            dt_max=float(dts.max()) if len(dts) else np.nan,
            dt_mean=float(dts.mean()) if len(dts) else np.nan,
            thinning_level=thin,
            overflow=thin > 0,
        )

    def solve_backward(self, t0, tend, tvals, grads, grad_out=None, lamda_out=None):
        """Backward adjoint pass (CVodeB).  ``t0`` is the backward start (the
        forward end time) and ``tend`` the backward end (the forward initial
        time), the reference's argument order.  Returns ``(grad, -lambda)``
        or fills the buffers."""
        if self._last_forward is None:
            raise SolverError("solve_backward called before solve_forward")
        fwd = self._last_forward
        if "native_ys" in fwd:
            return self._backward_native(fwd, tend, tvals, grads, grad_out, lamda_out)
        grads = np.asarray(grads, self._dtype)
        if self._root_fn is not None and self.last_stats is not None:
            # the recording stopped at the terminal root: observations past
            # it are NaN, so their cotangent rows are zeroed
            rt = np.asarray(self.last_stats.get("roots_t", np.inf)).reshape(-1)
            t_root = float(rt[0]) if rt.size else np.inf
            post = np.asarray(tvals, np.float64) >= t_root
            if post.any():
                grads = grads.copy()
                grads[post] = 0.0
        T = self._tensor
        args = (fwd["saved"], float(tend), T(tvals), T(grads), T(fwd["params"]))
        base_ms = int(self._adjoint_options.max_steps)
        lam, quad, status, stats = self._backward(*args, min(base_ms, _I32_MAX))
        # bounded retries with a doubled budget on step exhaustion
        retry = 0
        while int(status) == 1 and retry < self._max_retries:
            retry += 1
            lam, quad, status, stats = self._backward(*args, min(base_ms * 2**retry, _I32_MAX))
        lam, quad = _np(lam), _np(quad)
        # the reference's sign: the gradient to y0 is -lambda
        if lamda_out is not None:
            lamda_out[...] = -lam
        if grad_out is not None:
            grad_out[...] = quad
        self.last_stats = (self.last_stats or {}) | {k: _np(v) for k, v in stats.items()}
        self._check_status(_np(status), "solve_backward")
        if grad_out is None and lamda_out is None:
            return quad, -lam
        return grad_out, lamda_out

    def _backward_native(self, fwd, tend, tvals, grads, grad_out, lamda_out):
        """The native backward pass over the native forward's record (BDF)
        or observations (ADAMS).  A leading segment with lambda = 0 (``t0``
        past the last observation) contributes nothing, so the backward
        starts at the last observation."""
        if not np.array_equal(np.asarray(tvals, np.float64), fwd["native_tvals"]):
            raise SolverError(
                "solve_backward tvals must match solve_forward's on the native route "
                "(pass native_single=False to leave it)"
            )
        ns = self._native_adj()
        ns._params = np.ascontiguousarray(fwd["params"], np.float64)
        tol = dict(adjoint_reltol=float(self._adjoint_options.rtol),
                   adjoint_abstol=float(np.max(self._adjoint_options.atol)))
        grads = np.asarray(grads, np.float64)
        if fwd["native_mode"] == "BDF":
            lam0, quad = ns.solve_backward_recorded(tend, fwd["native_tvals"], grads, **tol)
        else:
            lam0, quad = ns.solve_adjoint_backward(tend, fwd["native_tvals"], fwd["native_ys"],
                                                   grads, **tol)
        self.last_stats = (self.last_stats or {}) | dict(ns.last_stats)
        if lamda_out is not None:
            lamda_out[...] = -lam0
        if grad_out is not None:
            grad_out[...] = quad
        if grad_out is None and lamda_out is None:
            return quad, -lam0
        return grad_out, lamda_out
