"""Solver options, result container, step-control and BDF constants.

The shared pieces of ``sunode_tpu/ops/bdf.py`` that the batched cores read:
``BDFOptions`` (same fields and defaults, so options carry over field by
field), ``BDFResult``, the status codes, the step-size controller constants
and the BDF/NDF order constants (:func:`_order_constants`).  The batched BDF
integrator is :mod:`sunode_torch.ops.bdf_batched`; the single-instance
``bdf_solve`` is not ported yet.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "BDFOptions",
    "BDFResult",
    "STATUS",
    "MIN_FACTOR",
    "MAX_FACTOR",
    "THRESH",
    "MAX_CONSECUTIVE_FAILS",
    "MAX_ORDER",
    "KD",
    "NEWTON_MAXITER",
    "SENS_MAXITER",
    "newton_tol_for",
]

MAX_ORDER = 5
KD = MAX_ORDER + 3  # rows of the difference array: D[0..q+2] needed
NEWTON_MAXITER = 4
SENS_MAXITER = 3
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0
# CVODES-style hysteresis: don't change h unless the proposed factor is
# at least THRESH (cvode eta THRESH = 1.5)
THRESH = 1.5
MAX_CONSECUTIVE_FAILS = 10

STATUS = {
    "SUCCESS": 0,
    "MAX_STEPS": 1,
    "STEP_UNDERFLOW": 2,
    "BAD_INIT": 3,
    "REPEATED_FAILURES": 4,
    "ROOT_RETURN": 5,
}


def _unsupported(core: str, **kwargs):
    """Raise for the first argument given (not None) that ``core`` has not
    ported yet, naming it."""
    for name, value in kwargs.items():
        if value is not None:
            raise NotImplementedError(f"{core}: {name} is not ported to sunode_torch yet")


class BDFOptions(NamedTuple):
    """Field-for-field copy of ``sunode_tpu.ops.bdf.BDFOptions``; see there
    for what each field does.  The batched Adams core of this package reads
    the tolerances, step bounds, ``max_steps``, ``newton_tol_factor``,
    ``adams_max_order``, ``constraints`` and the quadrature fields; the
    batched BDF core also ``max_order``, ``use_ndf``, ``first_step``, the
    sensitivity fields ``sens_err_con`` and ``sens_pbar`` and the recording
    fields ``save_steps``, ``checkpoint_thinning`` and ``hermite_order``."""

    rtol: Any = 1e-8
    atol: Any = 1e-8
    max_steps: int = 100_000
    first_step: Optional[float] = None
    max_order: int = MAX_ORDER
    max_step: float = np.inf
    min_step: float = 0.0
    use_ndf: bool = False
    constraints: Optional[Any] = None
    save_steps: int = 0
    newton_tol_factor: float = 1.0
    sens_err_con: bool = True
    sens_pbar: Optional[Any] = None
    sens_staggered: bool = False
    quad_err_con: bool = False
    quad_atol: Optional[Any] = None
    quad_rtol: Optional[float] = None
    linear_solver: str = "dense"
    krylov_dim: int = 5
    band_lower: int = 0
    band_upper: int = 0
    sparse_perm: Optional[Any] = None
    sparse_border: int = 0
    adams_max_order: int = 8
    inject_keep_order: int = 1
    checkpoint_thinning: bool = True
    hermite_order: int = 5


def newton_tol_for(options: BDFOptions, rtol_s: float, dtype: torch.dtype) -> float:
    """Corrector convergence tolerance of both batched cores
    (``sunode_tpu/ops/adams_batched.py:249-251``, ``bdf_batched.py:459-461``)."""
    eps = torch.finfo(dtype).eps
    return float(options.newton_tol_factor) * max(
        10 * eps / rtol_s, min(0.03, float(np.sqrt(rtol_s)))
    )


class BDFResult(NamedTuple):
    ys: torch.Tensor  # (B, n_t, n) solution at tvals (NaN where failed)
    status: torch.Tensor  # (B,) int32 status code
    stats: dict  # counters and final state
    saved: Optional[dict]  # recorded steps (BDF with save_steps > 0), else None
    sens: Optional[torch.Tensor] = None
    quad: Optional[torch.Tensor] = None  # (B, n_t, m)


def _order_constants(use_ndf: bool, dtype: torch.dtype, device=None):
    """``(gamma, alpha, error_const)``, each ``(MAX_ORDER + 1,)``, of the BDF
    (or, with ``use_ndf``, the NDF(kappa)) formulas of orders 0..5; the
    numbers of ``sunode_tpu/ops/bdf.py::_order_constants``."""
    k = np.arange(1, MAX_ORDER + 1)
    gamma = np.concatenate([[0.0], np.cumsum(1.0 / k)])  # gamma[q], q=0..5
    if use_ndf:
        kappa = np.array([0.0, -0.1850, -1 / 9, -0.0823, -0.0415, 0.0])
    else:
        kappa = np.zeros(MAX_ORDER + 1)
    alpha = (1 - kappa) * gamma
    alpha[0] = 1.0  # unused; avoid div-by-zero
    error_const = kappa * gamma + 1.0 / np.arange(1, MAX_ORDER + 2)
    return tuple(
        torch.as_tensor(a, dtype=dtype, device=device) for a in (gamma, alpha, error_const)
    )
