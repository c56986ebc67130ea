"""Solver options, result container, step-control constants, and the
single-instance BDF integrator.

Port of ``sunode_tpu/ops/bdf.py``: ``BDFOptions`` (same fields and
defaults, so options carry over field by field), ``BDFResult``, the status
codes, the step-size controller constants, the BDF/NDF order constants
(:func:`_order_constants`), the rootfinding every core shares
(:func:`_root_setup`, :func:`_root_scan`, :class:`RootRecord`; the single
cores call the scan with one lane), and :func:`bdf_solve`, the
single-instance variable-order BDF core.  The batched BDF integrator is
:mod:`sunode_torch.ops.bdf_batched`.

:func:`bdf_solve` is a host loop: one attempt an iteration, the step
size, the order, the counters and every accept/reject decision on the host
(the step control in the solve's float type, as numpy scalars), the state,
the difference array and the Newton solve as torch tensors on the device
of ``y0``.  A device sync reads each Newton iteration's correction norm and
each attempt's error norms; the small coefficient matrices of an attempt go
to the device in one upload.  The Newton solve is
:mod:`sunode_torch.ops.linsolve`'s at one lane, so 'band' and 'sparse'
factor and solve through the banded LU's kernels on CUDA tensors.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from sunode_torch import forward_ad

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
    "bdf_solve",
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


# ---------------------------------------------------------------------------
# The single-instance BDF core
# ---------------------------------------------------------------------------
_NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


def _np_dtype(dtype: torch.dtype):
    if dtype not in _NP_DTYPE:
        raise ValueError(f"the single cores solve in float64 or float32, not {dtype}")
    return _NP_DTYPE[dtype]


def _host_vec(x, n: int, np_dtype) -> np.ndarray:
    """A scalar or per-state option as a host ``(n,)`` array of the solve's type."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.broadcast_to(np.asarray(x, np_dtype), (n,))


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory and an asynchronous
    copy on a card (no sync), as it is on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _wrms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """CVODES weighted root-mean-square norm with weights w = 1/scale."""
    return torch.sqrt(torch.mean((x * w) ** 2))


def _build_R(q: int, factor, np_dtype) -> np.ndarray:
    """The 6x6 difference-rescaling matrix on the host, the identity outside
    the leading (q+1)x(q+1) block: ``R[0, :] = 1``, ``R[i, j] = R[i-1, j]
    (i - 1 - factor j) / i``, rounded as the reference's."""
    K = MAX_ORDER + 1
    j = np.arange(K, dtype=np_dtype)
    factor = np_dtype(factor)
    rows = [np.ones(K, np_dtype)]
    for i in range(1, K):
        rows.append(rows[-1] * (i - 1 - factor * j) / i)
    ar = np.arange(K)
    inblock = (ar[:, None] <= q) & (ar[None, :] <= q)
    return np.where(inblock, np.stack(rows), np.eye(K, dtype=np_dtype))


def _rescale_P(q: int, factor, np_dtype) -> np.ndarray:
    """``(R(factor), U = R(1))`` stacked ``(2, 6, 6)``, for :func:`_apply_P`."""
    return np.stack([_build_R(q, factor, np_dtype), _build_R(q, 1.0, np_dtype)])


def _apply_P(RU: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """``head <- U^T (R^T head)`` on the leading 6 rows of ``D (KD, ...)``."""
    K = MAX_ORDER + 1
    head = D[:K].reshape(K, -1)
    head = RU[1].T @ (RU[0].T @ head)
    return torch.cat([head.reshape(D[:K].shape), D[K:]])


def _rescale_D(D: torch.Tensor, q: int, factor) -> torch.Tensor:
    """Rescale a difference array ``(KD, ...)`` for a step change h ->
    factor h (the Shampine/Reichelt transformation on rows 0..q)."""
    RU = _rescale_P(q, factor, _np_dtype(D.dtype))
    return _apply_P(_upload(RU, D.device), D)


def _predict_weights(q: int, gamma: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """``(2, 6)`` rows of the predictor, ``sum_{i<=q} D[i]``, and of
    ``psi = sum_{1<=i<=q} gamma_i D[i] / alpha_q``."""
    K = MAX_ORDER + 1
    ar = np.arange(K)
    wy = (ar <= q).astype(gamma.dtype)
    wp = np.where((ar >= 1) & (ar <= q), gamma[:K], 0.0).astype(gamma.dtype) / alpha[q]
    return np.stack([wy, wp])


def _predict(D: torch.Tensor, q: int, gamma: np.ndarray, alpha: np.ndarray):
    """``(pred, psi)`` of ``D (KD, ...)`` at order q."""
    K = MAX_ORDER + 1
    PP = _upload(_predict_weights(q, gamma, alpha), D.device)
    out = PP @ D[:K].reshape(K, -1)
    return out[0].reshape(D.shape[1:]), out[1].reshape(D.shape[1:])


def _update_weights(q: int, np_dtype):
    """``(W (KD, KD), wd (KD,))`` of the accepted-step update at order q:
    ``D_new = W D + wd d``."""
    i = np.arange(KD)[:, None]
    j = np.arange(KD)[None, :]
    low = i <= q
    W = np.where(
        low & (j >= i) & (j <= q),
        1.0,
        np.where((i == q + 2) & (j == q + 1), -1.0, ((i == j) & (i > q + 2)).astype(np_dtype)),
    ).astype(np_dtype)
    wd = (low[:, 0] | (i[:, 0] == q + 1) | (i[:, 0] == q + 2)).astype(np_dtype)
    return W, wd


def _update_D(D: torch.Tensor, q: int, d: torch.Tensor, weights=None) -> torch.Tensor:
    """After an accepted step with correction d = y_new - y_pred:
      i <= q   : D_new[i] = sum_{j=i..q} D[j] + d
      i == q+1 : D_new[i] = d
      i == q+2 : D_new[i] = d - D[q+1]
      i >  q+2 : unchanged
    ``weights`` are :func:`_update_weights`'s on ``D``'s device."""
    if weights is None:
        W, wd = _update_weights(q, _np_dtype(D.dtype))
        weights = (_upload(W, D.device), _upload(wd, D.device))
    W, wd = weights
    flat = D.reshape(KD, -1)
    return (W @ flat + wd[:, None] * d.reshape(1, -1)).reshape(D.shape)


def _interpolate(D: torch.Tensor, q: int, t_n, h, t_eval) -> torch.Tensor:
    """Newton backward-difference dense output at ``t_eval``:
    ``P(t_n + s h) = sum_{i<=q} D[i] prod_{m<i} (s + m) / (m + 1)``.  A host
    ``t_eval`` takes host weights; a tensor one (the root scan's ``(1,)``
    brackets) device weights, its trailing batch after ``D``'s."""
    if torch.is_tensor(t_eval):
        s = (t_eval - float(t_n)) / float(h)
        out, w = D[0].unsqueeze(-1) if t_eval.ndim else D[0], torch.ones_like(s)
        for i in range(1, q + 1):
            w = w * (s + i - 1) / i
            out = out + w * (D[i].unsqueeze(-1) if t_eval.ndim else D[i])
        return out
    s = (t_eval - t_n) / h
    out, w = D[0], 1.0
    for i in range(1, q + 1):
        w = w * (s + i - 1) / i
        out = out + float(w) * D[i]
    return out


def _initial_step(rhs, t0, y0, f0, p, t_end, rtol, atol, max_step, np_dtype):
    """Hairer-Wanner automatic initial step size (order-1 estimate), the
    norms on the device and the rest on the host."""
    w = 1.0 / (_upload(atol, y0.device) + _upload(rtol, y0.device) * torch.abs(y0))
    d0, d1 = (np_dtype(v) for v in torch.stack([_wrms(y0, w), _wrms(f0, w)]).tolist())
    h0 = np_dtype(1e-6) if ((d0 < 1e-5) | (d1 < 1e-5)) else np_dtype(0.01) * d0 / d1
    h0 = np.minimum(h0, np_dtype(0.5) * (t_end - t0))
    f1 = rhs(_scalar(t0 + h0, y0), y0 + float(h0) * f0, p)
    d2 = np_dtype(_wrms(f1 - f0, w).item()) / h0
    dm = np.maximum(d1, d2)
    h1 = np.maximum(np_dtype(1e-6), h0 * np_dtype(1e-3)) if dm <= 1e-15 else np.sqrt(
        np_dtype(0.01) / dm)
    h = np.minimum(np_dtype(100) * h0, h1)
    h = np.minimum(h, t_end - t0)
    h = np.minimum(h, np_dtype(max_step))
    # extreme params overflow the norms (inf/inf -> NaN h); fall back to a
    # small finite h so the solve dies through underflow instead
    return h if (np.isfinite(h) and h > 0) else np_dtype(1e-6)


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A host scalar as a 0-d tensor of ``like``'s type and device (a fill,
    no copy).  The host value rides along as ``host_value``, so a function
    that needs the time on the host (the adjoint's evaluators) reads it
    without a sync."""
    out = torch.full((), float(x), dtype=like.dtype, device=like.device)
    out.host_value = float(x)
    return out


def host_value(t):
    """A time known on the host: a Python or numpy number, or a time the
    single cores pass (its ``host_value``); None for any other tensor."""
    if torch.is_tensor(t):
        return getattr(t, "host_value", None)
    return float(t)


def host_time(t) -> float:
    """:func:`host_value`, or for any other scalar tensor its value (one
    sync on a card)."""
    v = host_value(t)
    return float(t) if v is None else v


def _fetch(*xs: torch.Tensor) -> list:
    """0-d tensors of one device and type read back in one sync."""
    return torch.stack(xs).tolist()


def _nonfinite(*xs: torch.Tensor) -> torch.Tensor:
    """0 when every entry of ``xs`` is finite, NaN otherwise (``x * 0`` is
    NaN exactly at the infinities and NaNs)."""
    flat = xs[0].reshape(-1) if len(xs) == 1 else torch.cat([x.reshape(-1) for x in xs])
    return (flat * 0).sum()


class _SingleDense:
    """Dense Newton matrices of one instance: ``M = I - c J`` factored by
    ``torch.linalg``'s LU; a matrix that is not finite or is exactly
    singular solves to NaN, the reference's contract.  Counts its
    factorizations (the initial identity's included) and solves."""

    def __init__(self, n: int, dtype, device):
        self.eye = torch.eye(n, dtype=dtype, device=device)
        self.n_factors = self.n_solves = 0

    def _factor(self, M):
        self.n_factors += 1
        lu, piv, info = torch.linalg.lu_factor_ex(M)
        bad, sing = _fetch(_nonfinite(M), info.to(M.dtype))
        return lu, piv, bad == 0 and sing == 0

    def factor(self, J, c):
        return self._factor(self.eye - float(c) * J)

    def identity(self, J):
        return self._factor(self.eye)

    def solve(self, factors, res):
        """``res (n,)`` or ``(k, n)``, every right-hand side in one call."""
        self.n_solves += 1
        lu, piv, ok = factors
        if not ok:
            return torch.full_like(res, float("nan"))
        x = torch.linalg.lu_solve(lu, piv, res[:, None] if res.ndim == 1 else res.T)
        return x[:, 0] if res.ndim == 1 else x.T

    @staticmethod
    def lip_norm(J):
        """``||J||_inf`` (row sums), the quintic recording's L."""
        return torch.abs(J).sum(dim=1).amax()[None]


class _SingleBand:
    """'band' and 'sparse' for one instance: the batched solver of
    :mod:`sunode_torch.ops.linsolve` at one lane, so a CUDA solve launches
    the banded LU's kernels (one lane tile)."""

    def __init__(self, lin):
        self.lin = lin

    @property
    def n_factors(self):
        return self.lin.n_factors

    @property
    def n_solves(self):
        return self.lin.n_solves

    def factor(self, J, c):
        return self.lin.factor(J[..., None], torch.full((1,), float(c), dtype=J.dtype,
                                                        device=J.device))

    def identity(self, J):
        return self.lin.identity(J[..., None])

    def solve(self, factors, res):
        return self.lin.solve(factors, res[..., None])[..., 0]

    def lip_norm(self, J):
        return self.lin.lip_norm(J[..., None])


def _single_roots(root_fn, dtype):
    """A one-instance ``root_fn`` as the shared scan's batched form at one
    lane: ``(t (1,), y (n, 1), p (n_p, 1)) -> (nrt, 1)``."""

    def root_b(t, y, p):
        g = root_fn(t[0], y[:, 0], p[:, 0])
        if isinstance(g, (list, tuple)):
            g = torch.stack([torch.as_tensor(v, dtype=dtype, device=y.device) for v in g])
        return torch.as_tensor(g, dtype=dtype, device=y.device).reshape(-1, 1)

    return root_b


def bdf_solve(
    rhs: Callable,
    jac: Callable,
    t0,
    y0: torch.Tensor,
    params: torch.Tensor,
    tvals: torch.Tensor,
    options: BDFOptions = BDFOptions(),
    *,
    sens_rhs: Optional[Callable] = None,
    S0: Optional[torch.Tensor] = None,
    quad_rhs: Optional[Callable] = None,
    quad0: Optional[torch.Tensor] = None,
    first_step: Optional[Any] = None,  # override; <= 0 -> automatic
    jac_prod: Optional[Callable] = None,  # (t, y, v, p) -> J v, for spgmr
    root_fn: Optional[Callable] = None,  # (t, y, p) -> (nrt,) event functions
    root_cap: int = 8,
    root_terminal: bool = True,
    root_directions: Optional[Any] = None,
) -> BDFResult:
    """Integrate dy/dt = rhs(t, y, p) from t0, emitting y(tvals): the port of
    ``sunode_tpu/ops/bdf.py::bdf_solve`` with the same contract.

    ``rhs(t, y (n,), p) -> (n,)``; ``jac -> (n, n)`` (banded storage for
    'band', the plan's packed storage for 'sparse'; unused by 'spgmr',
    whose ``jac_prod(t, y, v, p)`` defaults to a ``torch.func.jvp`` of
    rhs); ``sens_rhs(t, y, S (k, n), p) -> (k, n)`` with ``S0``;
    ``quad_rhs(t, y, p) -> (m,)`` with ``quad0``; ``root_fn(t, y, p) ->
    (nrt,)`` with the reference's ``root_cap``, ``root_terminal`` and
    ``root_directions``.  ``t`` reaches every function as a 0-d tensor.
    ``tvals`` ascending with ``tvals[0] >= t0``.

    Returns ``ys (n_t, n)`` (NaN past a failure or a terminal root),
    ``sens (n_t, k, n)``, ``quad (n_t, m)`` on ``y0``'s device; ``status``
    and the scalar stats as Python numbers, the reference's keys plus
    ``n_attempts`` and the Newton solver's ``n_linear_factors`` and
    ``n_linear_solves`` (its host calls: on a card each banded
    factorization and solve is one launch); ``saved`` the recording
    (``save_steps > 0``: ``t (S,)``, ``y``, ``f`` and, with quintic rows,
    ``fd (S, n)`` and ``L (S,)``, ``n_saved``, ``overflow``)."""
    from sunode_torch.ops._recording import (
        fill_fdot_single,
        finalize_saved_single,
        init_saved_single,
        record_step_single,
    )
    from sunode_torch.ops.krylov import gmres_solve
    from sunode_torch.ops.linsolve import newton_linear_solver

    y0 = torch.as_tensor(y0)
    device = y0.device
    dtype = torch.promote_types(y0.dtype, torch.float32)
    sc = _np_dtype(dtype)
    f_kw = dict(dtype=dtype, device=device)
    y0 = y0.detach().to(dtype)
    params = torch.as_tensor(params).detach().to(**f_kw)
    tv = [sc(v) for v in torch.as_tensor(tvals).detach().reshape(-1).tolist()]
    t0 = sc(float(t0))
    n, n_t = y0.shape[0], len(tv)
    t_end = tv[-1]

    if options.linear_solver not in ("dense", "spgmr", "band", "sparse"):
        raise ValueError("options.linear_solver must be 'dense', 'spgmr', 'band' or 'sparse'")
    use_spgmr = options.linear_solver == "spgmr"
    if use_spgmr and jac_prod is None:
        def jac_prod(t, y, v, p):  # noqa: F811 -- matrix-free default
            return forward_ad.jvp(lambda y_: rhs(t, y_, p), (y,), (v,))[1]
    if use_spgmr:
        lin = None
    elif options.linear_solver == "dense":
        lin = _SingleDense(n, dtype, device)
    else:
        lin = _SingleBand(newton_linear_solver(options, n))
    n_spgmr = 0

    with_sens = sens_rhs is not None
    with_quad = quad_rhs is not None
    staggered = with_sens and bool(options.sens_staggered)
    k_sens = S0.shape[0] if with_sens else 0
    m_quad = quad0.shape[0] if with_quad else 0
    n_S = k_sens * n
    n_tot = n + n_S + m_quad
    sl_S = slice(n, n + n_S)
    sl_Q = slice(n + n_S, n_tot)

    # scalar or per-state rtol; the heuristics use the tightest component
    rtol = _host_vec(options.rtol, n, sc)
    rtol_s = rtol.min()
    atol = _host_vec(options.atol, n, sc)
    gamma, alpha, error_const = (a.cpu().numpy() for a in _order_constants(options.use_ndf, dtype))
    max_order = min(options.max_order, MAX_ORDER)

    # combined tolerance vectors and error-norm weights over z = [y | S | q]
    n_blocks = 1 + (k_sens if (with_sens and options.sens_err_con) else 0) + (
        1 if (with_quad and options.quad_err_con) else 0
    )
    atol_p, rtol_p = [atol], [rtol]
    v_p = [np.full((n,), 1.0 / (n * n_blocks), sc)]
    if with_sens:
        pbar = (_host_vec(options.sens_pbar, k_sens, sc) if options.sens_pbar is not None
                else np.ones((k_sens,), sc))
        atol_p.append((atol[None, :] / pbar[:, None]).reshape(-1))
        rtol_p.append(np.tile(rtol, k_sens))
        v_p.append(np.full((n_S,), (1.0 / (n * n_blocks)) if options.sens_err_con else 0.0, sc))
    if with_quad:
        quad_rtol = sc(options.quad_rtol) if options.quad_rtol is not None else rtol_s
        qa = options.quad_atol if options.quad_atol is not None else options.atol
        atol_p.append(_host_vec(qa, m_quad, sc))
        rtol_p.append(np.full((m_quad,), quad_rtol, sc))
        v_p.append(np.full((m_quad,), (1.0 / (m_quad * n_blocks)) if options.quad_err_con
                           else 0.0, sc))
    tol_z = _upload(np.stack([np.concatenate(atol_p), np.concatenate(rtol_p),
                              np.concatenate(v_p)]), device)
    atol_z, rtol_z, v_err = tol_z[0], tol_z[1], tol_z[2]

    constraints = None
    if options.constraints is not None:
        constraints = _upload(_host_vec(options.constraints, n, sc), device)

    newton_tol = sc(options.newton_tol_factor) * np.maximum(
        sc(10) * sc(torch.finfo(dtype).eps) / rtol_s, np.minimum(sc(0.03), np.sqrt(rtol_s))
    )
    eps = sc(torch.finfo(dtype).eps)

    t0_t = _scalar(t0, y0)
    f0 = rhs(t0_t, y0, params)
    bad_init = _nonfinite(y0, f0).item() != 0

    h_auto = _initial_step(rhs, t0, y0, f0, params, t_end, rtol, atol, options.max_step, sc)
    if first_step is not None and sc(float(first_step)) > 0:
        h0 = np.minimum(sc(float(first_step)), t_end - t0)
    elif first_step is None and options.first_step is not None:
        h0 = sc(options.first_step)
    else:
        h0 = h_auto
    h0 = np.maximum(h0, sc(1e-12))

    z_parts, fz_parts = [y0], [f0]
    if with_sens:
        S0 = torch.as_tensor(S0).detach().to(**f_kw)
        z_parts.append(S0.reshape(-1))
        fz_parts.append(sens_rhs(t0_t, y0, S0, params).reshape(-1))
    if with_quad:
        z_parts.append(torch.as_tensor(quad0).detach().to(**f_kw))
        fz_parts.append(quad_rhs(t0_t, y0, params))
    z0 = torch.cat(z_parts)
    D = torch.zeros((KD, n_tot), **f_kw)
    D[0] = z0
    D[1] = float(h0) * torch.cat(fz_parts)

    save_steps = int(options.save_steps)
    thinning = bool(options.checkpoint_thinning)
    if options.hermite_order not in (3, 5):
        raise ValueError("options.hermite_order must be 3 or 5")
    rec_fd = save_steps > 0 and options.hermite_order == 5

    zs = torch.full((n_t, n_tot), float("nan"), **f_kw)
    i_out = sum(1 for v in tv if v <= t0)
    zs[:i_out] = z0

    if use_spgmr:
        J, factors = None, None
    else:
        J = jac(t0_t, y0, params)
        factors = lin.identity(J)

    def lip_norm(J):
        # the quintic rows' stiffness scale: +inf without a matrix (spgmr)
        if use_spgmr:
            return torch.full((1,), float("inf"), **f_kw)
        return lin.lip_norm(J)

    def record_row(t_t, y, f, J):
        # quintic rows: f' is filled for every row after the solve
        # (fill_fdot_single); L, the Newton J's scale, is this step's
        parts = [t_t[None], y, f]
        if rec_fd:
            parts += [torch.zeros_like(f), lip_norm(J)]
        return torch.cat(parts)

    saved = init_saved_single(record_row(t0_t, y0, f0, J), save_steps, thinning) \
        if save_steps > 0 else None

    with_roots = root_fn is not None
    if with_roots:
        root_b = _single_roots(root_fn, dtype)
        p_col = params[:, None]
        g_init, rdir, root_cap = _root_setup(root_b, t0_t[None], y0[:, None], p_col, root_cap,
                                             root_directions)
        roots = RootRecord(g_init, n, root_cap)

    # per-order device constants, made once an order
    pp_w: dict = {}
    upd_w: dict = {}
    ec_w: dict = {}

    # the carry: h the desired next step, h_D the spacing D represents
    t, h, h_D, q = t0, h0, h0, 1
    n_equal = 0
    J_current, need_factor = True, True
    c_factored = sc(0)
    status = STATUS["BAD_INIT"] if bad_init else -1
    cef = ccf = 0
    nsteps, nfev, njev, nfactor, nniters = 0, 2, 1, 0, 0
    nfevS = 1 if with_sens else 0
    n_err_fails = n_conv_fails = 0
    pm_t, pm_h, pm_q, pm_worst = float("nan"), float("nan"), -1, -1
    it = 0

    while status == -1 and i_out < n_t:
        it += 1
        h_min_loc = sc(10) * eps * np.maximum(np.abs(t), np.abs(t_end))
        # NaN-robust: a non-finite h ends the solve
        underflow = not (h >= np.maximum(h_min_loc, sc(options.min_step)))
        h_use = np.minimum(h, t_end - t)
        t_new = t + h_use
        t_new_t = _scalar(t_new, y0)

        # the single lazy rescale: D from spacing h_D to h_use
        D = _apply_P(_upload(_rescale_P(q, h_use / np.maximum(h_D, sc(1e-300)), sc), device), D)

        c_coef = h_use / alpha[q]
        c_changed = abs(c_coef / (c_factored if c_factored != 0 else sc(1)) - 1) > 1e-12
        if not use_spgmr and (need_factor or c_changed):
            factors = lin.factor(J, c_coef)
            c_factored, nfactor = c_coef, nfactor + 1
        elif use_spgmr:
            c_factored = c_coef

        if q not in pp_w:
            pp_w[q] = _upload(_predict_weights(q, gamma, alpha), device)
            upd_w[q] = tuple(_upload(a, device) for a in _update_weights(q, sc))
            ec_w[q] = _upload(np.asarray([error_const[q], error_const[max(q - 1, 0)],
                                          error_const[min(q + 1, MAX_ORDER)]], sc), device)
        pred_psi = pp_w[q] @ D[: MAX_ORDER + 1]
        z_pred, psi_z = pred_psi[0], pred_psi[1]
        w_z = 1.0 / (atol_z + rtol_z * torch.abs(z_pred))
        y_pred, w_y = z_pred[:n], w_z[:n]

        if use_spgmr:
            def lin_solve(res, _t=t_new_t, _y=y_pred, _c=float(c_coef)):
                nonlocal n_spgmr
                n_spgmr += 1
                return gmres_solve(lambda v: v - _c * jac_prod(_t, _y, v, params), res,
                                   maxl=options.krylov_dim)

            def solve_rows(rows):
                return torch.stack([lin_solve(r) for r in rows])
        else:
            def lin_solve(res, _f=factors):
                return lin.solve(_f, res)

            solve_rows = lin_solve

        # ---- modified Newton on the y block ----------------------------
        y, d_corr = y_pred, None  # d = 0: its first residual skips it
        dy_old = sc(np.inf)
        k = 0
        n_conv = n_div = n_bad = False
        while k < NEWTON_MAXITER and not (n_conv or n_div or n_bad):
            f = rhs(t_new_t, y, params)
            res = float(c_coef) * f - psi_z[:n]
            delta = lin_solve(res if d_corr is None else res - d_corr)
            dy_norm, nonfin = _fetch(_wrms(delta, w_y), _nonfinite(f, delta))
            fin = nonfin == 0
            dy_norm = sc(dy_norm)
            with np.errstate(all="ignore"):
                rate = dy_norm / dy_old
                diverged = k > 0 and (
                    (rate >= 2.0)
                    or ((rate < 1.0) and (rate ** (NEWTON_MAXITER - k) / (1 - rate) * dy_norm
                                          > newton_tol))
                )
                converged = (dy_norm == 0.0) or (
                    k > 0 and rate < 1.0 and rate / (1 - rate) * dy_norm < newton_tol)
            d_corr = delta if d_corr is None else d_corr + delta
            y = y + delta
            n_bad = not fin
            n_conv = converged and not n_bad
            n_div = diverged and not converged
            dy_old = dy_norm
            k += 1
        nfev_n = n_iters = k
        y_new = y
        pred_bad_t = _nonfinite(z_pred)
        conv = n_conv
        d_parts = [d_corr]

        # ---- the sensitivity corrector (linear; the cached matrix) --------
        nfevS_n = 0
        state_err_ok = True
        err_y_norm = None
        if with_sens:
            S_pred = z_pred[sl_S].reshape(k_sens, n)
            psi_S = psi_z[sl_S].reshape(k_sens, n)
            wS = w_z[sl_S].reshape(k_sens, n)
            run = True
            if staggered:
                # CV_STAGGERED: the state must converge and pass its own
                # error test before any sensitivity work
                err_y_norm, pbad = (sc(v) for v in _fetch(
                    _wrms(float(error_const[q]) * d_corr, w_y), pred_bad_t))
                state_err_ok = err_y_norm <= 1.0
                run = conv and pbad == 0 and state_err_ok
            S, dS = S_pred, torch.zeros_like(S_pred)
            s_conv = s_bad = False
            if run:
                old = sc(np.inf)
                it_s = 0
                while it_s < SENS_MAXITER and not (s_conv or s_bad):
                    FS = sens_rhs(t_new_t, y_new, S, params)
                    deltaS = solve_rows(float(c_coef) * FS - psi_S - dS)
                    norm, nonfin = _fetch(_wrms(deltaS, wS), _nonfinite(deltaS))
                    fin = nonfin == 0
                    norm = sc(norm)
                    with np.errstate(all="ignore"):
                        rate = norm / old
                        sc_new = (norm == 0.0) or (
                            it_s > 0 and rate < 1.0 and rate / (1 - rate) * norm < newton_tol
                        ) or (norm < 0.1 * newton_tol)
                    S, dS = S + deltaS, dS + deltaS
                    s_bad = not fin
                    s_conv = sc_new and not s_bad
                    old = norm
                    it_s += 1
                nfevS_n = it_s
            if staggered:
                # a skipped corrector must not mask the state's rejection
                conv = conv and (s_conv or not state_err_ok)
            else:
                conv = conv and s_conv
            d_parts.append(dS.reshape(-1))
        if with_quad:
            dQ = float(c_coef) * quad_rhs(t_new_t, y_new, params) - psi_z[sl_Q]
            pred_bad_t = _nonfinite(z_pred, dQ)  # either one fails the attempt
            d_parts.append(dQ)
        d_z = torch.cat(d_parts) if len(d_parts) > 1 else d_parts[0]

        viol_t = None
        if constraints is not None:
            c_ = constraints
            viol_t = (((c_ == 1) & (y_new < 0)) | ((c_ == -1) & (y_new > 0))
                      | ((c_ == 2) & (y_new <= 0)) | ((c_ == -2) & (y_new >= 0))).any()

        # the error test and the order-selection norms, in one read
        D_upd = _update_D(D, q, d_z, upd_w[q])
        rows = ec_w[q][:, None] * torch.stack([d_z, D_upd[q], D_upd[q + 2]])
        err3 = torch.sqrt(torch.sum((rows * w_z) ** 2 * v_err, dim=1))
        extra = [pred_bad_t] + ([viol_t.to(dtype)] if viol_t is not None else [])
        vals = _fetch(*err3, *extra)
        err_norm_tot, err_m_raw, err_p_raw = (sc(v) for v in vals[:3])
        constraint_fail = bool(vals[4]) if viol_t is not None else False
        conv = conv and vals[3] == 0

        newton_failed = not conv
        # a stale J is refreshed and the step retried at the same h (spgmr
        # has no J: its linearisation is always fresh)
        refresh_J = (not use_spgmr) and newton_failed and not J_current
        halve = newton_failed and J_current

        if staggered:
            # the state's own error test gates acceptance
            if err_y_norm is None:
                err_y_norm = sc(_wrms(float(error_const[q]) * d_corr, w_y).item())
            err_norm_tot = np.maximum(err_norm_tot, err_y_norm)
        err_ok = (err_norm_tot <= 1.0) and state_err_ok
        accept = conv and err_ok and not constraint_fail
        err_reject = conv and (not err_ok or constraint_fail)
        n_equal = n_equal + 1 if accept else 0

        # ---- rootfinding on the accepted step's dense output -------------
        t_stop = None
        root_hit = False
        if with_roots and accept:
            hit, t_root, dirs, y_root, g_new = _root_scan(
                root_b, p_col, rdir, roots.g_prev, t0_t.new_full((1,), float(t)),
                t_new_t[None], t_new_t.new_full((1,), float(h_use)), y_new[:, None],
                lambda tt: _interpolate(D_upd[:, :n], q, t_new, h_use, tt).reshape(n, 1),
                torch.ones((1,), dtype=torch.bool, device=device),
            )
            roots.update(torch.ones((1,), dtype=torch.bool, device=device), hit, t_root, dirs,
                         y_root, g_new)
            root_hit = bool(hit[0])
            if root_terminal and root_hit:
                t_stop = sc(t_root[0].item())

        # ---- emission at the observation times the step passed ----------
        if accept:
            while i_out < n_t and tv[i_out] <= t_new + sc(1e-14) * np.abs(t_new) and (
                    t_stop is None or tv[i_out] <= t_stop):
                zs[i_out] = _interpolate(D_upd, q, t_new, h_use, tv[i_out])
                i_out += 1

        # ---- checkpoint recording ---------------------------------------
        if save_steps > 0:
            J_rec = J

            def row_now():
                f_acc = rhs(t_new_t, y_new, params)
                return record_row(t_new_t, y_new, f_acc, J_rec)

            saved = record_step_single(saved, accept, row_now, save_steps, thinning)

        # ---- order and step adaptation -----------------------------------
        err_m = err_m_raw if q > 1 else sc(np.inf)
        err_p = err_p_raw if q < max_order else sc(np.inf)

        def fac(e, qq):
            if not np.isfinite(e):
                return sc(0)
            return sc(0.9) * np.clip(e, sc(1e-30), sc(1e30)) ** (sc(-1.0) / (sc(qq) + sc(1.0)))

        with np.errstate(all="ignore"):
            facs = [fac(err_m, q - 1), fac(err_norm_tot, q), fac(err_p, q + 1)]
        best = int(np.argmax(facs))
        dq = best - 1
        factor_best = np.clip(facs[best], sc(MIN_FACTOR), sc(MAX_FACTOR))
        do_change = n_equal >= q + 1 and (
            (factor_best >= THRESH) or (factor_best < 1.0) or (dq != 0))
        q_acc = int(np.clip(q + dq, 1, max_order)) if do_change else q
        factor_acc = factor_best if do_change else sc(1)
        factor_acc = np.minimum(factor_acc, sc(options.max_step) / np.maximum(h_use, sc(1e-300)))
        if do_change and accept:
            n_equal = 0

        with np.errstate(all="ignore"):
            factor_rej = np.clip(
                sc(0.9) * np.clip(err_norm_tot, sc(1e-30), sc(1e30)) ** (sc(-1.0) / (q + sc(1.0))),
                sc(MIN_FACTOR), sc(0.9))
        if constraint_fail and err_ok:
            factor_rej = sc(0.25)
        factor_fail = sc(1) if refresh_J else (sc(0.5) if halve else factor_rej)

        # breakdown detector: 4 accumulated error failures reset the history
        # (y and a fresh first difference) and restart at order 1
        reset = not accept and err_reject and cef + 1 >= 4
        factor_next = factor_acc if accept else (sc(0.25) if reset else factor_fail)
        if accept:
            D_next = D_upd
        elif reset:
            z_last = D[0]
            fz_r = [rhs(_scalar(t, y0), z_last[:n], params)]
            if with_sens:
                fz_r.append(sens_rhs(_scalar(t, y0), z_last[:n],
                                     z_last[sl_S].reshape(k_sens, n), params).reshape(-1))
            if with_quad:
                fz_r.append(quad_rhs(_scalar(t, y0), z_last[:n], params))
            D_next = torch.zeros_like(D)
            D_next[0] = z_last
            D_next[1] = float(h_use) * torch.cat(fz_r)
        else:
            D_next = D

        if accept:
            cef = max(cef - 1, 0) if err_norm_tot <= 0.9 else cef
        else:
            cef = 0 if reset else cef + int(err_reject)
        ccf = 0 if accept else ccf + int(newton_failed and not refresh_J)
        too_many = cef >= MAX_CONSECUTIVE_FAILS or ccf >= MAX_CONSECUTIVE_FAILS

        status_old = status
        if status == -1 and too_many and not accept:
            status = STATUS["REPEATED_FAILURES"]
        if status == -1 and nsteps + int(accept) >= options.max_steps:
            status = STATUS["MAX_STEPS"]
        if status == -1 and underflow:
            status = STATUS["STEP_UNDERFLOW"]
        root_ret_now = False
        if with_roots and root_terminal and status == -1 and root_hit:
            root_ret_now, status = True, STATUS["ROOT_RETURN"]

        # post-mortem: where a fatal attempt died (t, h, order, worst state)
        if status_old == -1 and status != -1 and not root_ret_now:
            e_err = torch.abs(float(error_const[q]) * d_z[:n]) * w_y
            e_newt = torch.abs(d_corr) * w_y
            pm_worst = int(torch.argmax(e_err if conv else e_newt))
            pm_t, pm_h, pm_q = float(t), float(h_use), q

        if refresh_J:
            J = jac(t_new_t, y_pred, params)
        njev += int(refresh_J)
        J_current = False if accept else (J_current or refresh_J)
        need_factor = False if accept else refresh_J
        nsteps += int(accept)
        nfev += nfev_n + (int(accept) if save_steps > 0 else 0)
        nniters += n_iters
        nfevS += nfevS_n
        n_err_fails += int(err_reject)
        n_conv_fails += int(newton_failed and not refresh_J)
        t = t_new if accept else t
        h = h_use * factor_next
        h_D = h_use
        q = q_acc if accept else (1 if reset else q)
        D = D_next

    status = STATUS["SUCCESS"] if status == -1 else status
    stats = dict(
        n_steps=nsteps,
        n_rhs_evals=nfev,
        n_jac_evals=njev,
        n_factorizations=nfactor,
        n_newton_iters=nniters,
        n_error_test_fails=n_err_fails,
        n_conv_fails=n_conv_fails,
        final_order=q,
        final_step_size=float(h),
        final_time=float(t),
        # the combined state [y | vec S | q] at final_time: resume in place
        final_state=D[0],
        n_attempts=it,
        n_linear_factors=0 if use_spgmr else lin.n_factors,
        n_linear_solves=n_spgmr if use_spgmr else lin.n_solves,
        error_time=pm_t,
        error_step_size=pm_h,
        error_order=pm_q,
        error_worst_state=pm_worst,
    )
    if with_sens:
        stats["n_sens_rhs_evals"] = nfevS
    if with_roots:
        stats.update({k: v[0] for k, v in roots.stats().items()})
    saved_out = None
    if save_steps > 0:
        stats["checkpoint_thinning_levels"] = saved["shift"] if thinning else 0
        buf, n_saved, overflow = finalize_saved_single(saved, thinning)
        if rec_fd:
            buf = fill_fdot_single(buf, min(n_saved, buf.shape[0]), n, rhs, params)
        saved_out = {"t": buf[:, 0], "y": buf[:, 1 : n + 1], "f": buf[:, n + 1 : 2 * n + 1],
                     "n_saved": n_saved, "overflow": overflow}
        if rec_fd:
            saved_out["fd"] = buf[:, 2 * n + 1 : 3 * n + 1]
            saved_out["L"] = buf[:, 3 * n + 1]
    return BDFResult(
        ys=zs[:, :n],
        status=status,
        stats=stats,
        saved=saved_out,
        sens=zs[:, sl_S].reshape(n_t, k_sens, n) if with_sens else None,
        quad=zs[:, sl_Q] if with_quad else None,
    )
