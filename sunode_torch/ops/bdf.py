"""Solver options, result container and step-control constants.

The shared pieces of ``sunode_tpu/ops/bdf.py`` that the batched Adams core
reads: ``BDFOptions`` (same fields and defaults, so options carry over
field by field), ``BDFResult``, the status codes and the step-size
controller constants.  The BDF integrator itself is not ported yet.
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
]

MAX_ORDER = 5
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


class BDFOptions(NamedTuple):
    """Field-for-field copy of ``sunode_tpu.ops.bdf.BDFOptions``; see there
    for what each field does.  The batched Adams core of this package reads
    the tolerances, step bounds, ``max_steps``, ``newton_tol_factor``,
    ``adams_max_order``, ``constraints`` and the quadrature fields."""

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


class BDFResult(NamedTuple):
    ys: torch.Tensor  # (B, n_t, n) solution at tvals (NaN where failed)
    status: torch.Tensor  # (B,) int32 status code
    stats: dict  # counters and final state
    saved: Optional[dict]  # recorded steps (not ported: always None)
    sens: Optional[torch.Tensor] = None
    quad: Optional[torch.Tensor] = None  # (B, n_t, m)
