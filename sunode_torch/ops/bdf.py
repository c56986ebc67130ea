"""Solver options, result container, step-control and BDF constants.

The shared pieces of ``sunode_tpu/ops/bdf.py`` that the batched cores read:
``BDFOptions`` (same fields and defaults, so options carry over field by
field), ``BDFResult``, the status codes, the step-size controller constants,
the BDF/NDF order constants (:func:`_order_constants`) and the rootfinding
both batched cores share (:func:`_root_setup`, :func:`_root_scan`,
:class:`RootRecord`).  The batched BDF integrator is
:mod:`sunode_torch.ops.bdf_batched`; the single-instance ``bdf_solve`` is
not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

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
    "RootRecord",
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


class BDFOptions(NamedTuple):
    """Field-for-field copy of ``sunode_tpu.ops.bdf.BDFOptions``; see there
    for what each field does.  The batched Adams core of this package reads
    the tolerances, step bounds, ``max_steps``, ``newton_tol_factor``,
    ``adams_max_order``, ``constraints`` and the quadrature fields; the
    batched BDF core also ``max_order``, ``use_ndf``, ``first_step``, the
    sensitivity fields ``sens_err_con`` and ``sens_pbar``, the recording
    fields ``save_steps``, ``checkpoint_thinning`` and ``hermite_order`` and
    the linear-solver fields ``linear_solver``, ``krylov_dim``,
    ``band_lower``, ``band_upper``, ``sparse_perm`` and ``sparse_border``."""

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


def _grid_columns(core: str, tvals: torch.Tensor, B: int) -> torch.Tensor:
    """The observation grid as ``(n_t, B)`` columns, one a lane: shared
    ``tvals (n_t,)`` broadcast over the lanes, or per-lane grids ``tvals (B,
    n_t)`` (each ascending; a ragged one padded with copies of its last
    time), as the reference's ``tvals_tb``."""
    if tvals.ndim == 1:
        return tvals[:, None].expand(tvals.shape[0], B)
    if tvals.ndim == 2 and tvals.shape[0] == B:
        return tvals.T
    raise ValueError(
        f"{core}: tvals must be (n_t,) or per lane (B, n_t) = ({B}, n_t), "
        f"got {tuple(tvals.shape)}"
    )


def _batched_roots(root_fn: Callable, batched_fns: bool, dtype: torch.dtype) -> Callable:
    """``root_fn`` as ``(t (B,), y (n, B), p (n_p, B)) -> (nrt, B)``: as it
    is with ``batched_fns``, else its one-lane form mapped over the lanes."""
    if batched_fns:
        return lambda t, y, p: root_fn(t, y, p).to(dtype).reshape(-1, y.shape[-1])

    def lane(t, y, p):
        g = root_fn(t, y, p)
        if isinstance(g, (list, tuple)):
            g = torch.stack([torch.as_tensor(v, dtype=dtype) for v in g])
        return torch.as_tensor(g, dtype=dtype).reshape(-1)

    return torch.func.vmap(lane, in_dims=(0, 1, 1), out_dims=1)


def _validate_rdir(nrt: int, root_directions, device) -> torch.Tensor:
    """``root_directions`` (CVodeSetRootDirection's input) as ``(nrt,)``
    int32: 0 both ways, +1 rising only, -1 falling only; None is 0 for
    every component."""
    if root_directions is None:
        return torch.zeros((nrt,), dtype=torch.int32, device=device)
    rdir = np.asarray(root_directions, np.int32).reshape(-1)
    if rdir.shape != (nrt,):
        raise ValueError(
            f"root_directions must have one entry per root_fn component: "
            f"expected shape ({nrt},), got {rdir.shape}"
        )
    if not np.all(np.isin(rdir, (-1, 0, 1))):
        raise ValueError(
            "root_directions entries must be -1 (falling only), 0 (both) or +1 "
            f"(rising only); got {rdir[~np.isin(rdir, (-1, 0, 1))][:5]}"
        )
    return torch.as_tensor(rdir, device=device)


def _root_setup(root_b: Callable, t0, y0, params, root_cap: int, root_directions):
    """``(g_init (nrt, B), rdir, root_cap)``: the event functions at the
    initial state, the validated directions and the cap (at least 1);
    ``root_b`` is the batched form of :func:`_batched_roots`."""
    g_init = root_b(t0, y0, params)
    rdir = _validate_rdir(g_init.shape[0], root_directions, g_init.device)
    return g_init, rdir, max(int(root_cap), 1)


def _root_scan(root_b: Callable, params, rdir, g_prev, t, t_new, h_use, y_new, y_at: Callable,
               accept):
    """Event detection and leftmost-root location on every lane's step
    ``[t, t_new]``, on the calling core's dense output ``y_at(tt (B,)) ->
    (n, B)``: the lane-batched form of the reference's ``_root_scan``
    (``sunode_tpu/ops/bdf.py``) that its batched cores inline.

    A component whose sign changes over an accepted step (a zero reached
    from a nonzero value counts; ``rdir`` filters by the direction of
    ``g_new - g_prev``) puts its lane in the scan.  64 halvings of one
    bracket a lane track the leftmost sign change of any such component;
    components that change sign within CVODES's ``ttol`` of it report
    together, with +1 for g rising through zero and -1 falling.  Returns
    ``(root_hit (B,), t_root (B,), dirs (nrt, B), y_root (n, B), g_new)``,
    ``t_root`` inf where no root was hit.  When no lane is hit the bisection
    is skipped (one sync): its results would be discarded."""
    g_new = root_b(t_new, y_new, params)
    changed = ((g_prev * g_new) < 0) | ((g_new == 0.0) & (g_prev != 0.0))
    cross_dir = torch.sign(g_new - g_prev).to(torch.int32)
    changed = changed & ((rdir[:, None] == 0) | (rdir[:, None] == cross_dir)) & accept[None, :]
    lane_hit = changed.any(dim=0)
    if not bool(lane_hit.any()):
        return (lane_hit, torch.full_like(t_new, float("inf")),
                torch.zeros_like(changed, dtype=torch.int32), torch.zeros_like(y_new), g_new)

    def g_at(tt):
        return root_b(tt, y_at(tt), params)

    lo, hi, glo = t, t_new, g_prev
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        gm = g_at(mid)
        in_left = (changed & ((glo * gm < 0) | ((gm == 0.0) & (glo != 0.0)))).any(dim=0)
        lo, hi = torch.where(in_left, lo, mid), torch.where(in_left, mid, hi)
        glo = torch.where(in_left[None, :], glo, gm)
    tr = 0.5 * (lo + hi)
    ttol = 100.0 * torch.finfo(t_new.dtype).eps * (torch.abs(t_new) + torch.abs(h_use))
    g_up = g_at(torch.minimum(tr + ttol, t_new))
    here = changed & (g_prev * g_up <= 0)
    sign = torch.where(g_up != 0.0, torch.sign(g_up), torch.sign(g_new - g_prev))
    dirs = torch.where(here, sign.to(torch.int32), 0)
    y_root = y_at(tr)
    return lane_hit, torch.where(lane_hit, tr, float("inf")), dirs, y_root, g_new


class RootRecord:
    """The roots a batched solve records, trailing-batch: the first
    ``root_cap`` roots of each lane (``t`` (cap, B), inf where none; ``y``
    (cap, n, B); ``dirs`` (cap, nrt, B)), ``n_roots`` counting past the cap,
    and the event functions at the last accepted step (``g_prev``)."""

    def __init__(self, g_init, n: int, root_cap: int):
        nrt, B = g_init.shape
        self.cap, self.g_prev = root_cap, g_init
        self.t = torch.full((root_cap, B), float("inf"), dtype=g_init.dtype, device=g_init.device)
        self.y = torch.zeros((root_cap, n, B), dtype=g_init.dtype, device=g_init.device)
        self.dirs = torch.zeros((root_cap, nrt, B), dtype=torch.int32, device=g_init.device)
        self.n_roots = torch.zeros((B,), dtype=torch.int32, device=g_init.device)

    def update(self, accept, root_hit, t_root, dirs, y_root, g_new) -> None:
        """Record this attempt's roots where a lane is hit and has room."""
        can_rec = root_hit & (self.n_roots < self.cap)
        ridx = torch.clamp(self.n_roots, max=self.cap - 1)
        wrec = (torch.arange(self.cap, device=ridx.device)[:, None] == ridx[None, :]) & can_rec
        self.t = torch.where(wrec, t_root[None, :], self.t)
        self.y = torch.where(wrec[:, None, :], y_root[None], self.y)
        self.dirs = torch.where(wrec[:, None, :], dirs[None], self.dirs)
        self.n_roots = self.n_roots + root_hit.to(torch.int32)
        self.g_prev = torch.where(accept[None, :], g_new, self.g_prev)

    def stats(self) -> dict:
        """The reference's stats keys, leading-batch."""
        return dict(
            n_roots=self.n_roots,
            roots_t=self.t.T,  # (B, cap)
            roots_y=self.y.permute(2, 0, 1),  # (B, cap, n)
            roots_found=self.dirs.permute(2, 0, 1),  # (B, cap, nrt)
        )


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
