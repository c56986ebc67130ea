"""The Adams attempt with its right-hand side in torch: three kernels around it.

:func:`sunode_torch.ops.adams_attempt.adams_history_attempt` runs the
history half of an attempt in one kernel with the right-hand side generated
into it from sympy.  A problem written in torch (``TorchProblem``) has no
such emitted system, and a large state (SIR over 1,000 regions: 3,000 rows)
does not fit one thread per lane anyway.  Here the same attempt is cut at
its right-hand-side calls into three stages, and ``system.fz`` runs as
torch code between them:

  * :func:`split_predict` -- the rescale ``R(h/h_D) U`` of the history, the
    predictor ``z_pred``, the extrapolation ``f_ex``, the error weights
    ``w_z``, the corrector coefficient ``c_A = h gamma_{p-1}`` and
    ``pred_ok`` (its kernel launches on :func:`predict_geometry`'s
    geometry, the blocks of a lane tile one thread-block cluster along the
    rows, R(fac) built once a lane and block);
  * :func:`split_sweep` -- one functional corrector sweep given
    ``fz_k = fz(t, y_it)``: the next iterate, the lane's weighted
    ``dy_norm`` and the masked conv/div/bad/niter/dy_old update (its kernel
    launches on :func:`sweep_geometry`'s geometry, the blocks of a lane
    tile one thread-block cluster, and reads a lane-major ``fz_k`` as a
    right-hand side mapped over the lanes returns it);
  * :func:`split_finish` -- given the final ``fz``: ``d_fz``, ``z_new``,
    the error row ``err0``, the accepted-step difference update ``DF_upd``,
    the three error-test norms ``err3`` and the attempt's ``conv`` (its
    kernel sums the rows in chunks of ``CHUNK_ROWS``, with scratch, a
    counter and a fill, or, where they fit one chunk, on a dense tile
    without them: :func:`finish_geometry`).

:func:`adams_split_attempt_rows` runs the same attempt on a state whose
rows are split over devices (:mod:`sunode_torch.parallel.rows`): predict on
every block, and the sweep and the finish each cut at their sums over the
rows --

  * :func:`split_sweep_rows` -- first the decision of the sweep before
    (:func:`split_sweep_decide`, ``dy_norm`` and the masked state update,
    on each lane's ``ss`` over every block: the :class:`Pending` partials
    that sweep left, added by :func:`pending_sums`), then a block's next
    iterate and each lane's partial sums of squares ``ss`` and non-finite
    flags over the block's rows;
  * :func:`split_finish_rows` -- a block's ``d_fz``, ``z_new``, ``err0``,
    ``DF_upd`` and each lane's three sums of squares ``ss3`` (err3 without
    the roots);
  * :func:`split_finish_lanes` -- the last sweep's decision, err3's roots of
    the summed ``ss3``, the attempt's ``conv`` and ``niter``.

At one block the rows and the lanes forms compose to :func:`split_sweep`
and :func:`split_finish` bit for bit: the same rows summed in the same
order, one root of the same sum.

:func:`adams_split_attempt` composes them: one predict,
``FUNCTIONAL_MAXITER`` sweeps and one finish, with ``maxiter + 1``
evaluations of ``system.fz`` (the stage, where the solve has one, rides in
the parameter rows as the Adams core passes it).  It takes the arguments of
``adams_history_attempt`` and returns its ``HistoryOut``.

The three functions above are the plain PyTorch versions: the code of
``adams_history_attempt_reference`` (and of the PECE reference inside it)
regrouped, so that their composition, :func:`adams_split_attempt_reference`,
gives the same bits.  On CPU tensors :func:`adams_split_attempt` runs it.  On
CUDA tensors :func:`adams_split_attempt` launches ``csrc/adams_split.cu``
instead (built with ``nvcc`` for ``sm_90a`` at first use, one build per
history depth and type, float64 or float32, the history's: the kernels do
not depend on the problem) and raises if the build, a check or a launch
fails, or if a floating input has another type than the history; it never
runs the plain stages there and casts nothing.  It
counts its launches in ``adams_split_attempt.launches`` by kernel (each
build in its own ``.launches`` too), and each plain stage counts its calls
in ``.calls``; the rows' and the lanes' entries count theirs in
``adams_split_attempt_rows.launches`` (and each build's ``.rows_launches``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from sunode_torch.ops import adams_attempt
from sunode_torch.ops._nvcc_build import build_library
from sunode_torch.ops.adams import _GAMMA, _GAMMA_STAR
from sunode_torch.ops.adams_attempt import (
    HistoryOut,
    _rescale,
    _take_row,
    _update,
    c_real,
    real_build,
)
from sunode_torch.ops.pece_step import PeceSystem, _check, _tables_header
from sunode_torch.parallel.rows import RowBlocks, lane_all, lane_sum, scatter

__all__ = [
    "Predicted",
    "SweepState",
    "Finished",
    "sweep_start",
    "split_predict",
    "split_sweep",
    "split_finish",
    "adams_split_attempt",
    "adams_split_attempt_reference",
    "SweepRows",
    "FinishedRows",
    "Pending",
    "pending_sums",
    "split_sweep_rows",
    "split_sweep_decide",
    "split_finish_rows",
    "split_finish_lanes",
    "adams_split_attempt_rows",
    "build_split_kernels",
    "SweepGeometry",
    "sweep_geometry",
    "predict_geometry",
    "FinishGeometry",
    "finish_geometry",
    "CHUNK_ROWS",
    "ROWS_ENTRIES",
    "TILE_LANES",
]

_CSRC = Path(__file__).resolve().parents[1] / "csrc" / "adams_split.cu"
ROWS_ENTRIES = ("sweep_rows", "finish_rows", "finish_lanes")
TILE_LANES = 32  # lanes of a finish block (csrc/adams_split.cu: SPLIT_TILE)
FINISH_ROW_THREADS = 8  # row threads of a finish block (SPLIT_ROWS)
CHUNK_ROWS = 64  # history rows of a finish block (SPLIT_CHUNK)
SWEEP_THREADS = 256  # threads of a predict or sweep block (SWEEP_THREADS)
SWEEP_UNROLL = 4  # rows a sweep thread loads at once (SWEEP_UNROLL)
SWEEP_CLUSTER_MAX = 16  # blocks of a cluster, the non-portable size allowed
PREDICT_LANES_MAX = 32  # lanes of a predict tile at most (PREDICT_LANES_MAX)
ROWS_WAVE = 2  # rows a thread of the rows' sweep loads at once (ROWS_WAVE)
ROWS_BLOCKS_MAX = 16  # blocks whose partials one launch reads (ROWS_BLOCKS_MAX)
ROWS_SEGMENTS_MAX = 4  # row segments of a block's f read in place (ROWS_SEGMENTS_MAX)
CARD_SMS = 132  # streaming multiprocessors of an H100 SXM


class Predicted(NamedTuple):
    DF_resc: torch.Tensor  # (KAB, nz, B) history rescaled to h_use
    z_pred: torch.Tensor  # (nz, B)
    f_ex: torch.Tensor  # (nz, B) sum_{i<p} DF_resc[i]
    w_z: torch.Tensor  # (nz, B) 1 / (atol + rtol |z_pred|)
    c_A: torch.Tensor  # (B,) h gamma_{p-1}
    pred_ok: torch.Tensor  # (B,) bool: z_pred finite


class SweepState(NamedTuple):
    conv: torch.Tensor  # (B,) bool
    div: torch.Tensor  # (B,) bool
    bad: torch.Tensor  # (B,) bool: a non-finite fz seen
    dy_old: torch.Tensor  # (B,) the last sweep's dy_norm
    niter: torch.Tensor  # (B,) int32 sweeps taken


class Finished(NamedTuple):
    DF_upd: torch.Tensor  # (KAB, nz, B)
    z_new: torch.Tensor  # (nz, B)
    err0: torch.Tensor  # (nz, B) |gamma*_p| h d_fz
    err3: torch.Tensor  # (3, B)
    conv: torch.Tensor  # (B,) bool


class SweepRows(NamedTuple):
    y_next: torch.Tensor  # (n_d, B) the block's state rows
    # (ranks, B) the squared weighted updates summed over each rank's state
    # rows (the kernel's: sweep_geometry's clusters; the plain stage's: one)
    ss: torch.Tensor
    nonfinite: torch.Tensor  # (ranks, B) bool: a non-finite fz row in the rank's rows


class Pending(NamedTuple):
    """What a sweep of a state split leaves for its decision, which the next
    :func:`split_sweep_rows` (or :func:`split_finish_lanes`) makes."""

    k: int  # the sweep that left them
    ss: tuple  # every block's SweepRows.ss, in block order
    nonfinite: tuple  # every block's SweepRows.nonfinite
    newton_tol: float
    n: int  # the whole state's rows


class FinishedRows(NamedTuple):
    DF_upd: torch.Tensor  # (KAB, nz_d, B)
    z_new: torch.Tensor  # (nz_d, B)
    err0: torch.Tensor  # (nz_d, B)
    ss3: torch.Tensor  # (3, B) err3's sums of squares over the block's rows


class SweepGeometry(NamedTuple):
    """Launch geometry of the sweep kernel (``csrc/adams_split.cu``)."""

    lanes: int  # lanes of a tile (threadIdx.x)
    rows: int  # consecutive rows of a block
    cluster: int  # blocks of a lane tile, one cluster along the rows (gridDim.x)
    tiles: int  # lane tiles (gridDim.y)

    @property
    def row_threads(self) -> int:  # threadIdx.y
        return SWEEP_THREADS // self.lanes

    @property
    def blocks(self) -> int:
        return self.cluster * self.tiles


class FinishGeometry(NamedTuple):
    """Launch geometry of the finish kernel (``csrc/adams_split.cu``)."""

    lanes: int  # lanes of a block (threadIdx.x)
    row_threads: int  # its row threads (threadIdx.y)
    chunks: int  # row chunks of CHUNK_ROWS rows (gridDim.y)
    tiles: int  # lane tiles (gridDim.x)

    @property
    def one_chunk(self) -> bool:  # the one-chunk form: no partials, counter or fill
        return self.chunks == 1


def finish_geometry(nz: int, B: int) -> FinishGeometry:
    """The finish's geometry at ``nz`` rows and ``B`` lanes, as
    ``split_finish_launch`` takes it (``finish_tile``): rows that fit one
    chunk take the one-chunk form on a dense tile of ``min(nz, 8)`` row
    threads by as many lanes as fill 256 threads, so that no row thread is
    without a row; more rows the multi-chunk form's 32 lanes by 8 row
    threads a chunk."""
    chunks = -(-nz // CHUNK_ROWS)
    row_threads = FINISH_ROW_THREADS if chunks > 1 else min(max(nz, 1), FINISH_ROW_THREADS)
    lanes = TILE_LANES * FINISH_ROW_THREADS // row_threads
    return FinishGeometry(lanes, row_threads, chunks, -(-B // lanes))


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def _pow2_at_most(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def _check_itemsize(itemsize: int) -> None:
    if itemsize not in (4, 8):
        raise ValueError(f"the split kernels are built for 4- and 8-byte values, not {itemsize}")


def sweep_geometry(nz: int, B: int, itemsize: int = 8) -> SweepGeometry:
    """The sweep's geometry at ``nz`` rows and ``B`` lanes of ``itemsize``
    bytes (8 for the float64 build, 4 for the float32 one).

    A block is ``SWEEP_THREADS`` threads: a tile of lanes by the row threads
    that cover ``nz`` at ``SWEEP_UNROLL`` rows a thread (at most 8, so 32
    lanes at any large nz: a warp reads one 256-byte line a row); while the
    card would not get a block an SM (132) from every cluster size allowed,
    the tile halves, down to 16 lanes.  The blocks of a tile form one
    cluster along the rows: the smallest power of two that gives two blocks
    an SM, at most 8 (portable) where 8 already gives one, at most 16, and
    never more than the rows fill at one step a thread.  Each block takes
    ``ceil(nz / cluster)`` rows, so none is empty.

    The geometry is the same at both sizes: a warp's 32 lanes read one
    whole 128-byte line a row at 4 bytes as they read two at 8, and what
    sets the tile and the cluster is the SMs' count, which the element size
    does not change (the float32 build takes fewer registers and half the
    shared memory, so the card holds at least as many of its clusters:
    ``experiments/split_ab.py --dtype float32`` prints them)."""
    _check_itemsize(itemsize)
    if nz < 1 or B < 1:
        raise ValueError(f"sweep_geometry: needs nz >= 1 and B >= 1, got {nz}, {B}")
    lanes = SWEEP_THREADS // min(8, _pow2_at_least(-(-nz // SWEEP_UNROLL)))

    def plan(lanes):  # (tiles, the largest cluster whose blocks all get rows)
        steps = -(-nz // (SWEEP_THREADS // lanes * SWEEP_UNROLL))
        return -(-B // lanes), min(SWEEP_CLUSTER_MAX, _pow2_at_most(steps))

    tiles, cluster_max = plan(lanes)
    while lanes > 16 and tiles * cluster_max < CARD_SMS:
        lanes //= 2
        tiles, cluster_max = plan(lanes)
    cluster = 1
    while cluster < cluster_max and tiles * cluster < 2 * CARD_SMS:
        cluster *= 2
    if cluster > 8 and tiles * 8 >= CARD_SMS:
        cluster = 8
    return SweepGeometry(lanes, -(-nz // cluster), cluster, tiles)


def predict_geometry(nz: int, B: int, itemsize: int = 8) -> SweepGeometry:
    """Predict's geometry at ``nz`` rows and ``B`` lanes of ``itemsize``
    bytes (8 or 4), the same at both sizes as :func:`sweep_geometry`'s.

    A block is ``SWEEP_THREADS`` threads: a tile of ``PREDICT_LANES_MAX``
    (32) lanes, so that a warp reads one 256-byte line a row, by 8 row
    threads that take one row each a step.  The blocks of
    a tile form one cluster along the rows, the largest power of two up to
    16 that still gives every block a step of rows: many blocks of a few
    hundred rows spread over the card's cluster slots, whose count is no
    multiple of the tiles (an H100 holds 30 of predict's clusters of 8 at
    once and 14 of 16, against 32 tiles at B = 1,024), at the cost of one
    R(fac) table a block.  The tile halves to 16 lanes only where 32-lane
    tiles would leave half the SMs without a block.  Each block takes
    ``ceil(nz / cluster)`` rows, so none is empty."""
    _check_itemsize(itemsize)
    if nz < 1 or B < 1:
        raise ValueError(f"predict_geometry: needs nz >= 1 and B >= 1, got {nz}, {B}")
    lanes = PREDICT_LANES_MAX
    while True:
        steps = -(-nz // (SWEEP_THREADS // lanes))
        cluster, tiles = min(SWEEP_CLUSTER_MAX, _pow2_at_most(steps)), -(-B // lanes)
        if lanes == 16 or tiles * cluster >= CARD_SMS // 2:
            return SweepGeometry(lanes, -(-nz // cluster), cluster, tiles)
        lanes //= 2


def sweep_start(active: torch.Tensor, dtype=torch.float64) -> SweepState:
    """The corrector's state before the first sweep: inactive lanes count as
    converged."""
    B, device = active.shape[0], active.device
    no = torch.zeros(B, dtype=torch.bool, device=device)
    return SweepState(~active, no, no, torch.full((B,), float("inf"), dtype=dtype, device=device),
                      torch.zeros(B, dtype=torch.int32, device=device))


# ---------------------------------------------------------------------------
# The plain stages
# ---------------------------------------------------------------------------
def split_predict(DF, p, pre_factor, h_use, z_prev, atol_z, rtol_z, P_MAX: int) -> Predicted:
    """Rescale and predict; rows ``i >= p`` enter multiplied by 0.0, as in
    the JAX main path."""
    split_predict.calls += 1
    dtype, device = z_prev.dtype, z_prev.device
    DF = _rescale(DF, p, pre_factor, P_MAX + 1)
    K = DF.shape[0] - 2
    acc_z = torch.zeros_like(z_prev)
    f_ex = torch.zeros_like(z_prev)
    for i in range(K):
        m = (i <= p - 1).to(dtype)[None, :]
        acc_z = acc_z + m * float(_GAMMA[i]) * DF[i]
        f_ex = f_ex + m * DF[i]
    z_pred = z_prev + h_use[None, :] * acc_z
    c_A = h_use * torch.as_tensor(_GAMMA, dtype=dtype, device=device)[(p - 1).long()]
    w_z = 1.0 / (atol_z[:, None] + rtol_z[:, None] * torch.abs(z_pred))
    return Predicted(DF, z_pred, f_ex, w_z, c_A, torch.isfinite(z_pred).all(dim=0))


def split_sweep(k: int, fz_k, y_it, pred: Predicted, state: SweepState, newton_tol: float,
                n: int) -> tuple[torch.Tensor, SweepState]:
    """Corrector sweep ``k`` on ``fz_k (nz, B)``, the right-hand side at the
    iterate ``y_it (n, B)``: ``(y_next, state)``.  ``newton_tol <= 0`` turns
    the rate tests off (fixed sweeps)."""
    split_sweep.calls += 1
    conv, div, bad, dy_old, niter = state
    bad_f = ~torch.isfinite(fz_k).all(dim=0)
    z_next = pred.z_pred[:n] + pred.c_A[None, :] * (fz_k[:n] - pred.f_ex[:n])
    delta = z_next - y_it
    dy_norm = torch.sqrt(torch.mean((delta * pred.w_z[:n]) ** 2, dim=0))
    rate = dy_norm / dy_old
    live = ~(conv | div | bad)
    y_next = torch.where(live[None, :], z_next, y_it)
    if not newton_tol > 0:
        conv_new = torch.zeros_like(live)
        div_new = torch.zeros_like(live)
    else:
        conv_new = (
            (dy_norm == 0.0)
            | ((k > 0) & (rate < 1.0) & (rate / (1 - rate) * dy_norm < newton_tol))
            | (dy_norm < 0.1 * newton_tol)
        )
        div_new = (rate >= 2.0) & (k > 0)
    bad = bad | (live & bad_f)
    conv = conv | (live & conv_new & ~bad)
    div = div | (live & div_new & ~conv_new)
    niter = niter + live.to(torch.int32)
    dy_old = torch.where(live, dy_norm, dy_old)
    return y_next, SweepState(conv, div, bad, dy_old, niter)


def split_finish(fz, pred: Predicted, state: SweepState, p, h_use, gamma_star_abs, v_err,
                 newton_tol: float, P_MAX: int) -> Finished:
    """Final evaluation ``fz (nz, B)`` at the last iterate: new state, the
    difference update and the error rows at orders p, p - 1 and p + 1."""
    split_finish.calls += 1
    DF_upd, z_new, err0, ss3 = _finish_rows(fz, pred, p, h_use, gamma_star_abs, v_err, P_MAX)
    return Finished(DF_upd, z_new, err0, torch.sqrt(ss3),
                    _finish_conv(state, pred.pred_ok, newton_tol))


def pending_sums(pending: Pending, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Each lane's ``ss`` and non-finite flag over every block of
    ``pending``, on ``device``: a block's ranks added in rank order into its
    sum, the blocks' sums in block order (as
    :func:`~sunode_torch.parallel.rows.lane_sum` adds them), the flags
    ORed."""
    acc = flags = None
    for ss, nf in zip(pending.ss, pending.nonfinite):
        t = ss[0]
        for c in range(1, ss.shape[0]):
            t = t + ss[c]
        t, f = t.to(device), nf.any(dim=0).to(device)
        acc, flags = (t, f) if acc is None else (acc + t, flags | f)
    return acc, flags


def split_sweep_rows(fz_k, y_it, pred: Predicted, state: SweepState, n: int,
                     pending: Pending | None = None, rows=None) -> tuple[SweepRows, SweepState]:
    """:func:`split_sweep` on one block of rows up to its sums over them,
    after the decision of the sweep before: ``pending`` (None at the first
    sweep) is decided first, :func:`split_sweep_decide` on
    :func:`pending_sums`, and the block's lanes are live from the decided
    state.  ``fz_k (nz_d, B)`` holds the block's rows, its ``n`` state rows
    first, or, with ``rows`` (the block's ``(start, stop)`` segments of f's
    rows), is the whole f; ``y_it (n, B)``.  Returns the block's next
    iterate and sums as one rank, and the decided state (``state`` where
    nothing is pending)."""
    split_sweep_rows.calls += 1
    if pending is not None:
        state = split_sweep_decide(pending.k, *pending_sums(pending, y_it.device), state,
                                   pending.newton_tol, pending.n)
    if rows is not None:
        fz_k = torch.cat([fz_k[a:b] for a, b in rows])
    bad_f = ~torch.isfinite(fz_k).all(dim=0)
    z_next = pred.z_pred[:n] + pred.c_A[None, :] * (fz_k[:n] - pred.f_ex[:n])
    delta = z_next - y_it
    ss = torch.sum((delta * pred.w_z[:n]) ** 2, dim=0)
    live = ~(state.conv | state.div | state.bad)
    return SweepRows(torch.where(live[None, :], z_next, y_it), ss[None], bad_f[None]), state


def split_sweep_decide(k: int, ss, nonfinite, state: SweepState, newton_tol: float,
                       n: int) -> SweepState:
    """:func:`split_sweep`'s decision on each lane's ``ss`` and
    ``nonfinite`` over all the blocks, ``n`` the whole state's rows."""
    split_sweep_decide.calls += 1
    conv, div, bad, dy_old, niter = state
    # a true division: on the card torch multiplies by the reciprocal of a
    # Python number, and the kernel divides (on the CPU both are ss / n)
    dy_norm = torch.sqrt(ss / torch.full_like(ss, float(n)))
    rate = dy_norm / dy_old
    live = ~(conv | div | bad)
    if not newton_tol > 0:
        conv_new = torch.zeros_like(live)
        div_new = torch.zeros_like(live)
    else:
        conv_new = (
            (dy_norm == 0.0)
            | ((k > 0) & (rate < 1.0) & (rate / (1 - rate) * dy_norm < newton_tol))
            | (dy_norm < 0.1 * newton_tol)
        )
        div_new = (rate >= 2.0) & (k > 0)
    bad = bad | (live & nonfinite)
    conv = conv | (live & conv_new & ~bad)
    div = div | (live & div_new & ~conv_new)
    niter = niter + live.to(torch.int32)
    dy_old = torch.where(live, dy_norm, dy_old)
    return SweepState(conv, div, bad, dy_old, niter)


def split_finish_rows(fz, pred: Predicted, p, h_use, gamma_star_abs, v_err,
                      P_MAX: int) -> FinishedRows:
    """:func:`split_finish` on one block of rows up to err3's sums over
    them."""
    split_finish_rows.calls += 1
    DF_upd, z_new, err0, ss3 = _finish_rows(fz, pred, p, h_use, gamma_star_abs, v_err, P_MAX)
    return FinishedRows(DF_upd, z_new, err0, ss3)


def split_finish_lanes(ss3, pred_ok, state: SweepState, newton_tol: float,
                       pending: Pending | None = None):
    """:func:`split_finish`'s lanes on ``ss3`` summed over the blocks, after
    the last sweep's decision (``pending``, as :func:`split_sweep_rows`
    takes it): ``(err3, conv, niter)``."""
    split_finish_lanes.calls += 1
    if pending is not None:
        state = split_sweep_decide(pending.k, *pending_sums(pending, ss3.device), state,
                                   pending.newton_tol, pending.n)
    return torch.sqrt(ss3), _finish_conv(state, pred_ok, newton_tol), state.niter


def _finish_rows(fz, pred: Predicted, p, h_use, gamma_star_abs, v_err, P_MAX: int):
    dtype, device = fz.dtype, fz.device
    d_fz = fz - pred.f_ex
    z_new = pred.z_pred + pred.c_A[None, :] * d_fz
    g_star = torch.as_tensor(np.abs(_GAMMA_STAR), dtype=dtype, device=device)
    err0 = (g_star[p.long()] * h_use)[None, :] * d_fz
    DF_upd = _update(pred.DF_resc, p, d_fz)
    err_rows = torch.stack(
        [
            err0,
            (gamma_star_abs[torch.clamp(p - 1, min=0).long()] * h_use)[None, :]
            * _take_row(DF_upd, p - 1),
            (gamma_star_abs[torch.clamp(p + 1, max=P_MAX + 1).long()] * h_use)[None, :]
            * _take_row(DF_upd, p + 1),
        ]
    )
    ss3 = torch.sum((err_rows * pred.w_z[None]) ** 2 * v_err[None, :, None], dim=1)
    return DF_upd, z_new, err0, ss3


def _finish_conv(state: SweepState, pred_ok, newton_tol: float):
    conv = state.conv
    if not newton_tol > 0:
        conv = conv | ~state.bad
    return conv & ~state.bad & pred_ok


split_predict.calls = split_sweep.calls = split_finish.calls = 0
split_sweep_rows.calls = split_sweep_decide.calls = 0
split_finish_rows.calls = split_finish_lanes.calls = 0


# ---------------------------------------------------------------------------
# CUDA build and launches
# ---------------------------------------------------------------------------
class _SplitKernels:
    """One compiled build of ``csrc/adams_split.cu`` for one history depth
    at the C type ``real`` ('double' or 'float'); ``defines`` adds
    compile-time defines and ``source`` takes another checkout's file
    (``experiments/split_ab.py``: ``SPLIT_PHASE_CLOCKS``, the kernels'
    trace by phase; the parent's source)."""

    def __init__(self, kab: int, defines: tuple[str, ...] = (), source: Path = _CSRC,
                 real: str = "double"):
        self.kab = kab
        self.launches = {"predict": 0, "sweep": 0, "finish": 0}  # this build's, by kernel
        self.rows_launches = dict.fromkeys(ROWS_ENTRIES, 0)  # the rows' and lanes' entries
        suffix, real_defines, self.dtype = real_build(real)
        self.itemsize = torch.empty((), dtype=self.dtype).element_size()
        built = build_library(
            f"adams_split_kab{kab}{suffix}", source,
            headers={"pece_tables.h": _tables_header(real)},
            defines=(f"ADAMS_KAB={kab}", *real_defines, *defines),
        )
        self.build_log, self.build_seconds, self.lib_path = built.log, built.seconds, built.path
        lib = built.lib
        vp, c_int, c_double = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.split_predict_launch.argtypes = [vp] * 7 + [c_int] * 6 + [vp] * 6 + [vp]
        lib.split_sweep_launch.argtypes = (
            [c_int] + [vp] * 11 + [c_double] * 2 + [c_int] * 8 + [vp] * 6 + [vp]
        )
        lib.split_finish_launch.argtypes = [vp] * 13 + [c_int] * 5 + [vp] * 7 + [vp]
        for fn in (lib.split_predict_launch, lib.split_sweep_launch, lib.split_finish_launch):
            fn.restype = c_int
        # the state split's entries (an older source, split_ab.py --old-root, has
        # none, or its own: split_ab.py launches those with their signatures)
        c_ll = ctypes.c_longlong
        rows_argtypes = {
            "split_sweep_rows_launch": (
                [vp, c_ll, c_ll, c_int, vp, vp] + [vp] * 10 + [c_int] * 2 + [vp] * 3
                + [c_double] * 2 + [c_int] * 8 + [vp] * 8 + [vp]
            ),
            "split_finish_rows_launch": [vp] * 10 + [c_int] * 4 + [vp] * 6 + [vp],
            "split_finish_lanes_launch": (
                [vp] * 7 + [c_int] * 2 + [vp] * 3 + [c_double] * 2 + [c_int] * 3 + [vp] * 3
                + [vp]
            ),
        }
        for name, argtypes in rows_argtypes.items():
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes, fn.restype = argtypes, c_int
        lib.split_error_string.argtypes = [c_int]
        lib.split_error_string.restype = ctypes.c_char_p
        lib.split_finish_geometry.argtypes = [c_int, ctypes.POINTER(c_int)]
        lib.split_finish_geometry.restype = None
        self._lib = lib

    def _run(self, stage: str, fn, dev, *args) -> None:
        # the launch goes to the runtime's current device: make it the tensors'
        with torch.cuda.device(dev):
            code = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if code == -1:
            raise ValueError(f"adams_split {stage}: the shapes do not match the kernel "
                             f"built for KAB={self.kab}")
        if code == -3:
            raise ValueError(f"adams_split {stage}: a geometry that does not cover the rows and "
                             f"lanes once, or too many history rows for one grid")
        if code != 0:
            msg = self._lib.split_error_string(code).decode()
            raise RuntimeError(f"adams_split {stage} launch failed: {msg} ({code})")
        if stage in ROWS_ENTRIES:
            adams_split_attempt_rows.launches[stage] += 1
            self.rows_launches[stage] += 1
        else:
            adams_split_attempt.launches[stage] += 1
            self.launches[stage] += 1

    @staticmethod
    def _grid(nz: int, B: int) -> tuple[int, int]:
        return -(-nz // CHUNK_ROWS), -(-B // TILE_LANES)

    def finish_geometry(self, nz: int) -> tuple[int, int, int]:
        """The finish's (lanes, row threads, row chunks) at ``nz`` rows as
        the build's launcher takes them (:func:`finish_geometry` mirrors
        it)."""
        out = (ctypes.c_int * 3)()
        self._lib.split_finish_geometry(int(nz), out)
        return tuple(out)

    def predict(self, DF, p, pre_factor, h_use, z_prev, atol_z, rtol_z,
                geometry: SweepGeometry | None = None) -> Predicted:
        """Predict on :func:`predict_geometry`'s geometry or ``geometry``."""
        KAB, nz, B = DF.shape
        dev, real = DF.device, self.dtype
        _check(DF, real, (self.kab, nz, B), dev, "DF")
        _check(p, torch.int32, (B,), dev, "p")
        _check(pre_factor, real, (B,), dev, "pre_factor")
        _check(h_use, real, (B,), dev, "h_use")
        _check(z_prev, real, (nz, B), dev, "z_prev")
        _check(atol_z, real, (nz,), dev, "atol_z")
        _check(rtol_z, real, (nz,), dev, "rtol_z")
        g = predict_geometry(nz, B, self.itemsize) if geometry is None else geometry
        f_kw = dict(dtype=real, device=dev)
        out = Predicted(
            torch.empty((KAB, nz, B), **f_kw), torch.empty((nz, B), **f_kw),
            torch.empty((nz, B), **f_kw), torch.empty((nz, B), **f_kw),
            torch.empty((B,), **f_kw),
            torch.empty((B,), dtype=torch.bool, device=dev),
        )
        self._run(
            "predict", self._lib.split_predict_launch, dev,
            DF.data_ptr(), p.data_ptr(), pre_factor.data_ptr(), h_use.data_ptr(),
            z_prev.data_ptr(), atol_z.data_ptr(), rtol_z.data_ptr(), KAB, nz, B,
            g.lanes, g.rows, g.cluster, *(o.data_ptr() for o in out),
        )
        return out

    def sweep(self, k, fz_k, y_it, pred: Predicted, state: SweepState, newton_tol, n,
              geometry: SweepGeometry | None = None):
        """One sweep, on :func:`sweep_geometry`'s geometry or ``geometry``.
        ``fz_k`` may be lane-major (the transpose of a contiguous (B, nz), as
        a right-hand side mapped over the lanes returns it): the kernel
        reads it so, without a copy."""
        nz, B = pred.z_pred.shape
        lane_major = fz_k.ndim == 2 and not fz_k.is_contiguous() and fz_k.t().is_contiguous()
        fz_k, y_it = (fz_k.t() if lane_major else fz_k).contiguous(), y_it.contiguous()
        dev, real = fz_k.device, self.dtype
        _check(fz_k, real, (B, nz) if lane_major else (nz, B), dev, "fz_k")
        _check(y_it, real, (n, B), dev, "y_it")
        for name, x, dtype in (("conv", state.conv, torch.bool), ("div", state.div, torch.bool),
                               ("bad", state.bad, torch.bool),
                               ("dy_old", state.dy_old, real),
                               ("niter", state.niter, torch.int32)):
            _check(x, dtype, (B,), dev, name)
        for name in ("z_pred", "f_ex", "w_z", "c_A"):
            _check(getattr(pred, name), real, tuple(getattr(pred, name).shape), dev, name)
        g = sweep_geometry(nz, B, self.itemsize) if geometry is None else geometry
        y_next = torch.empty((n, B), dtype=real, device=dev)
        new = SweepState(*(torch.empty_like(x) for x in state))
        fixed = not newton_tol > 0
        self._run(
            "sweep", self._lib.split_sweep_launch, dev,
            int(k), fz_k.data_ptr(), y_it.data_ptr(), pred.z_pred.data_ptr(),
            pred.f_ex.data_ptr(), pred.w_z.data_ptr(), pred.c_A.data_ptr(),
            *(x.data_ptr() for x in state), float(newton_tol), 0.1 * float(newton_tol),
            int(fixed), n, nz, B, int(lane_major), g.lanes, g.rows, g.cluster,
            y_next.data_ptr(), *(x.data_ptr() for x in new),
        )
        return y_next, new

    def finish(self, fz, pred: Predicted, state: SweepState, p, h_use, gamma_star_abs, v_err,
               newton_tol) -> Finished:
        fz = fz.contiguous()
        KAB, nz, B = pred.DF_resc.shape
        dev, real = fz.device, self.dtype
        _check(fz, real, (nz, B), dev, "fz")
        _check(p, torch.int32, (B,), dev, "p")
        _check(h_use, real, (B,), dev, "h_use")
        _check(state.conv, torch.bool, (B,), dev, "conv")
        _check(state.bad, torch.bool, (B,), dev, "bad")
        _check(v_err, real, (nz,), dev, "v_err")
        for name in ("DF_resc", "z_pred", "f_ex", "w_z", "c_A"):
            _check(getattr(pred, name), real, tuple(getattr(pred, name).shape), dev, name)
        # |gamma*| up to order P_MAX + 1 = KAB - 2: at least KAB - 1 entries
        n_gamma = gamma_star_abs.shape[0] if torch.is_tensor(gamma_star_abs) else 0
        _check(gamma_star_abs, real, (max(KAB - 1, n_gamma),), dev, "gamma_star_abs")
        f_kw = dict(dtype=real, device=dev)
        out = Finished(
            torch.empty((KAB, nz, B), **f_kw), torch.empty((nz, B), **f_kw),
            torch.empty((nz, B), **f_kw), torch.empty((3, B), **f_kw),
            torch.empty((B,), dtype=torch.bool, device=dev),
        )
        part = done = None  # the multi-chunk form's scratch
        if not finish_geometry(nz, B).one_chunk:
            chunks, tiles = self._grid(nz, B)
            part = torch.empty((3, chunks, B), **f_kw)
            done = torch.empty((tiles,), dtype=torch.int32, device=dev)
        self._run(
            "finish", self._lib.split_finish_launch, dev,
            fz.data_ptr(), pred.DF_resc.data_ptr(), pred.z_pred.data_ptr(), pred.f_ex.data_ptr(),
            pred.w_z.data_ptr(), pred.c_A.data_ptr(), pred.pred_ok.data_ptr(), p.data_ptr(),
            h_use.data_ptr(), gamma_star_abs.data_ptr(), v_err.data_ptr(),
            state.conv.data_ptr(), state.bad.data_ptr(), int(not newton_tol > 0), KAB, nz, B,
            gamma_star_abs.shape[0], *(o.data_ptr() for o in out),
            *(None if x is None else x.data_ptr() for x in (part, done)),
        )
        return out

    def _pending(self, pending: Pending | None, dev, B: int, newton_tol) -> tuple:
        """The launch's arguments for ``pending``: its blocks, sweep, arrays
        of its partials' pointers and ranks, the decision's tolerances and
        the whole state's rows."""
        tol = 0.0 if pending is None else pending.newton_tol
        if pending is not None and newton_tol is not None and tol != newton_tol:
            raise ValueError(f"adams_split: the pending sweep's newton_tol {tol} is not the "
                             f"finish's {newton_tol}")
        tol_args = (float(tol), 0.1 * float(tol), int(not tol > 0))
        if pending is None:
            return (0, 0, None, None, None), tol_args, 0
        m = len(pending.ss)
        if not 1 <= m <= ROWS_BLOCKS_MAX or len(pending.nonfinite) != m:
            raise ValueError(f"adams_split: a launch reads the partials of 1 to "
                             f"{ROWS_BLOCKS_MAX} blocks, got {m}")
        for d, (ss, nf) in enumerate(zip(pending.ss, pending.nonfinite)):
            _check(ss, self.dtype, (ss.shape[0], B), dev, f"pending ss[{d}]")
            _check(nf, torch.bool, tuple(ss.shape), dev, f"pending nonfinite[{d}]")
        return ((m, int(pending.k), (ctypes.c_void_p * m)(*(x.data_ptr() for x in pending.ss)),
                 (ctypes.c_void_p * m)(*(x.data_ptr() for x in pending.nonfinite)),
                 (ctypes.c_int * m)(*(x.shape[0] for x in pending.ss))),
                tol_args, int(pending.n))

    def _check_state(self, state: SweepState, B: int, dev) -> None:
        for name, x, dtype in (("conv", state.conv, torch.bool), ("div", state.div, torch.bool),
                               ("bad", state.bad, torch.bool),
                               ("dy_old", state.dy_old, self.dtype),
                               ("niter", state.niter, torch.int32)):
            _check(x, dtype, (B,), dev, name)

    def sweep_rows(self, fz_k, y_it, pred: Predicted, state: SweepState, n,
                   pending: Pending | None = None, rows=None, decide: bool = True,
                   geometry: SweepGeometry | None = None) -> tuple[SweepRows, SweepState | None]:
        """:func:`split_sweep_rows` on the block's ``(nz_d, B)``, in
        :func:`sweep_geometry`'s blocks (or ``geometry``'s) without their
        cluster, one partial a rank.  ``fz_k`` is read in place: row-major,
        lane-major (the transpose of a contiguous (B, N), as a right-hand
        side mapped over the lanes returns it) or at any strides, the
        block's rows at ``rows`` (at most ``ROWS_SEGMENTS_MAX`` segments)
        when it is the whole f.  With ``decide`` False the decided state is
        not written and None takes its place (the route decides on every
        block and keeps one device's copy)."""
        nz, B = pred.z_pred.shape
        y_it = y_it.contiguous()
        dev, real = y_it.device, self.dtype
        segs = ((0, nz),) if rows is None else tuple((int(a), int(b)) for a, b in rows)
        N = fz_k.shape[0] if fz_k.ndim == 2 else -1
        if (len(segs) > ROWS_SEGMENTS_MAX or sum(b - a for a, b in segs) != nz
                or any(a < 0 or b > N or b <= a for a, b in segs)):
            raise ValueError(f"adams_split sweep_rows: the rows {segs} of an f of {N} rows "
                             f"are not the block's {nz}")
        if not (fz_k.stride(0) == 1 or fz_k.stride(1) == 1):
            fz_k = fz_k.contiguous()
        _check(fz_k if fz_k.stride(1) == 1 else fz_k.t(), real,
               (N, B) if fz_k.stride(1) == 1 else (B, N), dev, "fz_k")
        _check(y_it, real, (n, B), dev, "y_it")
        self._check_state(state, B, dev)
        for name in ("z_pred", "f_ex", "w_z", "c_A"):
            _check(getattr(pred, name), real, tuple(getattr(pred, name).shape), dev, name)
        pend, tol_args, n_all = self._pending(pending, dev, B, None)
        g = sweep_geometry(nz, B, self.itemsize) if geometry is None else geometry
        local = np.cumsum([0] + [b - a for a, b in segs])[:-1]
        out = SweepRows(torch.empty((n, B), dtype=real, device=dev),
                        torch.empty((g.cluster, B), dtype=real, device=dev),
                        torch.empty((g.cluster, B), dtype=torch.bool, device=dev))
        new = (SweepState(*(torch.empty_like(x) for x in state))
               if pending is not None and decide else None)
        self._run(
            "sweep_rows", self._lib.split_sweep_rows_launch, dev,
            fz_k.data_ptr(), fz_k.stride(0), fz_k.stride(1), len(segs),
            (ctypes.c_int * len(segs))(*(int(x) for x in local)),
            (ctypes.c_int * len(segs))(*(a for a, _ in segs)),
            y_it.data_ptr(), pred.z_pred.data_ptr(), pred.f_ex.data_ptr(), pred.w_z.data_ptr(),
            pred.c_A.data_ptr(), *(x.data_ptr() for x in state), *pend, *tol_args, n_all, n,
            nz, B, g.lanes, g.rows, g.cluster, *(o.data_ptr() for o in out),
            *((None,) * 5 if new is None else (x.data_ptr() for x in new)),
        )
        return out, state if pending is None else new

    def finish_rows(self, fz, pred: Predicted, p, h_use, gamma_star_abs,
                    v_err) -> FinishedRows:
        """:func:`split_finish_rows` on the finish's grid."""
        fz = fz.contiguous()
        KAB, nz, B = pred.DF_resc.shape
        dev, real = fz.device, self.dtype
        _check(fz, real, (nz, B), dev, "fz")
        _check(p, torch.int32, (B,), dev, "p")
        _check(h_use, real, (B,), dev, "h_use")
        _check(v_err, real, (nz,), dev, "v_err")
        for name in ("DF_resc", "z_pred", "f_ex", "w_z", "c_A"):
            _check(getattr(pred, name), real, tuple(getattr(pred, name).shape), dev, name)
        n_gamma = gamma_star_abs.shape[0] if torch.is_tensor(gamma_star_abs) else 0
        _check(gamma_star_abs, real, (max(KAB - 1, n_gamma),), dev, "gamma_star_abs")
        chunks, tiles = self._grid(nz, B)
        f_kw = dict(dtype=real, device=dev)
        out = FinishedRows(torch.empty((KAB, nz, B), **f_kw), torch.empty((nz, B), **f_kw),
                           torch.empty((nz, B), **f_kw), torch.empty((3, B), **f_kw))
        part = torch.empty((3, chunks, B), **f_kw)
        done = torch.empty((tiles,), dtype=torch.int32, device=dev)
        self._run(
            "finish_rows", self._lib.split_finish_rows_launch, dev,
            fz.data_ptr(), pred.DF_resc.data_ptr(), pred.z_pred.data_ptr(), pred.f_ex.data_ptr(),
            pred.w_z.data_ptr(), pred.c_A.data_ptr(), p.data_ptr(), h_use.data_ptr(),
            gamma_star_abs.data_ptr(), v_err.data_ptr(), KAB, nz, B, gamma_star_abs.shape[0],
            *(o.data_ptr() for o in out), part.data_ptr(), done.data_ptr(),
        )
        return out

    def finish_lanes(self, ss3, pred_ok, state: SweepState, newton_tol,
                     pending: Pending | None = None):
        """:func:`split_finish_lanes`, a warp a lane: ``(err3, conv,
        niter)``."""
        B = ss3.shape[1]
        dev, real = ss3.device, self.dtype
        ss3 = ss3.contiguous()
        _check(ss3, real, (3, B), dev, "ss3")
        _check(pred_ok, torch.bool, (B,), dev, "pred_ok")
        self._check_state(state, B, dev)
        pend, _, n_all = self._pending(pending, dev, B, newton_tol)
        err3 = torch.empty((3, B), dtype=real, device=dev)
        conv = torch.empty((B,), dtype=torch.bool, device=dev)
        niter = torch.empty((B,), dtype=torch.int32, device=dev)
        self._run(
            "finish_lanes", self._lib.split_finish_lanes_launch, dev,
            ss3.data_ptr(), *(x.data_ptr() for x in state), pred_ok.data_ptr(), *pend,
            float(newton_tol), 0.1 * float(newton_tol), int(not newton_tol > 0), n_all, B,
            err3.data_ptr(), conv.data_ptr(), niter.data_ptr(),
        )
        return err3, conv, niter


_KERNELS: dict[tuple[int, torch.dtype], _SplitKernels] = {}


def build_split_kernels(kab: int, dtype: torch.dtype = torch.float64) -> _SplitKernels:
    """Build (or reuse) the three kernels for one history depth and type
    (float64 or float32)."""
    kernels = _KERNELS.get((kab, dtype))
    if kernels is None:
        kernels = _KERNELS[(kab, dtype)] = _SplitKernels(kab, real=c_real(dtype))
    return kernels


class _PlainStages:
    """The plain stages behind the kernels' interface."""

    def __init__(self, P_MAX: int):
        self.P_MAX = P_MAX

    def predict(self, DF, p, pre_factor, h_use, z_prev, atol_z, rtol_z) -> Predicted:
        return split_predict(DF, p, pre_factor, h_use, z_prev, atol_z, rtol_z, self.P_MAX)

    def sweep(self, k, fz_k, y_it, pred, state, newton_tol, n):
        return split_sweep(k, fz_k, y_it, pred, state, newton_tol, n)

    def finish(self, fz, pred, state, p, h_use, gamma_star_abs, v_err, newton_tol) -> Finished:
        return split_finish(fz, pred, state, p, h_use, gamma_star_abs, v_err, newton_tol,
                            self.P_MAX)

    @staticmethod
    def sweep_rows(fz_k, y_it, pred, state, n, pending=None, rows=None, decide=True):
        return split_sweep_rows(fz_k, y_it, pred, state, n, pending, rows)

    def finish_rows(self, fz, pred, p, h_use, gamma_star_abs, v_err) -> FinishedRows:
        return split_finish_rows(fz, pred, p, h_use, gamma_star_abs, v_err, self.P_MAX)

    @staticmethod
    def finish_lanes(ss3, pred_ok, state, newton_tol, pending=None):
        return split_finish_lanes(ss3, pred_ok, state, newton_tol, pending)


def _compose(stages, system, t_new, h_use, pre_factor, p, active, DF, z_prev, params, atol_z,
             rtol_z, gamma_star_abs, v_err, newton_tol, maxiter) -> HistoryOut:
    """One predict, ``maxiter`` sweeps and one finish, ``system.fz`` between."""
    n = system.n
    pred = stages.predict(DF, p, pre_factor, h_use, z_prev, atol_z, rtol_z)
    y_it = pred.z_pred[:n]
    state = sweep_start(active, z_prev.dtype)
    for k in range(maxiter):
        y_it, state = stages.sweep(k, system.fz(t_new, y_it, params), y_it, pred, state,
                                   newton_tol, n)
    fin = stages.finish(system.fz(t_new, y_it, params), pred, state, p, h_use, gamma_star_abs,
                        v_err, newton_tol)
    return HistoryOut(pred.DF_resc, fin.DF_upd, pred.z_pred, fin.z_new, fin.err0, fin.err3,
                      fin.conv, state.niter)


def adams_split_attempt_reference(system: PeceSystem, *args) -> HistoryOut:
    """The plain stages composed as the kernels are, on either device; the
    arguments are those of :func:`adams_split_attempt`."""
    *args, P_MAX = args
    return _compose(_PlainStages(P_MAX), system, *args)


def adams_split_attempt(
    system: PeceSystem,
    t_new: torch.Tensor,  # (B,)
    h_use: torch.Tensor,  # (B,) step of this attempt
    pre_factor: torch.Tensor,  # (B,) h_use / h_D, the rescale ratio
    p: torch.Tensor,  # (B,) int32 order, 1 <= p <= P_MAX
    active: torch.Tensor,  # (B,) bool
    DF: torch.Tensor,  # (KAB, nz, B) f-difference history at the last step h_D
    z_prev: torch.Tensor,  # (nz, B)
    params: torch.Tensor,  # (n_p, B), with the stage rows where the solve has one
    atol_z: torch.Tensor,  # (nz,)
    rtol_z: torch.Tensor,  # (nz,)
    gamma_star_abs: torch.Tensor,  # (>= P_MAX + 2,) |gamma*|
    v_err: torch.Tensor,  # (nz,) weights of the error norm's squares
    newton_tol: float,
    maxiter: int,
    P_MAX: int,
) -> HistoryOut:
    """One attempt for all lanes with ``system.fz`` in torch between the
    stages: the three kernels on CUDA, the plain stages on CPU tensors.
    ``system.device`` is not read."""
    args = (t_new, h_use, pre_factor, p, active, DF, z_prev, params, atol_z, rtol_z,
            gamma_star_abs, v_err, newton_tol, maxiter)
    if not adams_attempt.on_card(DF):
        return adams_split_attempt_reference(system, *args, P_MAX)
    if DF.ndim != 3 or DF.shape[0] != P_MAX + 3:
        raise ValueError(
            f"adams_split_attempt: DF must be (P_MAX + 3, nz, B) = ({P_MAX + 3}, nz, B), "
            f"got {tuple(DF.shape)}"
        )
    return _compose(build_split_kernels(P_MAX + 3, DF.dtype), system, *args)


adams_split_attempt.launches = {"predict": 0, "sweep": 0, "finish": 0}


def _stages_on(x: torch.Tensor, P_MAX: int, kab: int):
    """The kernels for a block on the card (built for ``kab``), else the
    plain stages."""
    if adams_attempt.on_card(x):
        return build_split_kernels(kab, x.dtype)
    return _PlainStages(P_MAX)


def adams_split_attempt_rows(
    system: PeceSystem,
    t_new: torch.Tensor,  # (B,) on the home device
    h_use: torch.Tensor,  # (B,)
    pre_factor: torch.Tensor,  # (B,)
    p: torch.Tensor,  # (B,) int32
    active: torch.Tensor,  # (B,) bool
    DF: RowBlocks,  # (KAB, nz_d, B) a block
    z_prev: RowBlocks,  # (nz_d, B)
    params: torch.Tensor,  # (n_p, B) on the home device
    atol_z: RowBlocks,  # (nz_d, 1)
    rtol_z: RowBlocks,  # (nz_d, 1)
    gamma_star_abs: torch.Tensor,
    v_err: RowBlocks,  # (nz_d, 1)
    newton_tol: float,
    maxiter: int,
    P_MAX: int,
) -> HistoryOut:
    """One attempt of :func:`adams_split_attempt` on row blocks (their
    layout's state rows first in each block, the quadrature's after them on
    the home device): predict on every block and ``pred_ok`` ANDed; per
    sweep, the iterate gathered on the home device, ``system.fz`` there, its
    rows scattered to the other blocks (the home block reads its rows of f
    in place), and :func:`split_sweep_rows` on every block, each first
    deciding the sweep before from every block's partials (shared with
    every device; each device keeps its own copy of the corrector's state,
    written by its first block); then the finish's rows on every block and
    :func:`split_finish_lanes` on the home device, the last decision first.
    The per-row tolerances and weights are ``(rows, 1)`` blocks.  Blocks on
    the card run the kernels (raising if a build or a launch fails), CPU
    blocks the plain stages.  Returns a ``HistoryOut`` whose row fields
    (DF_resc, DF_upd, z_pred, z_new, err0) are :class:`RowBlocks` and whose
    lane fields are on the home device."""
    layout = DF.layout
    home, n = layout.home, system.n
    n_d = layout.state_rows(n)
    kab = P_MAX + 3
    if any(x.shape[0] != kab for x in DF.blocks):
        raise ValueError(f"adams_split_attempt_rows: DF blocks must have {kab} history rows")
    stages = [_stages_on(x, P_MAX, kab) for x in DF.blocks]
    home_stages = _stages_on(h_use, P_MAX, kab)
    lanes = layout.lanes
    h_d, pre_d, p_d, g_d = lanes(h_use), lanes(pre_factor), lanes(p), lanes(gamma_star_abs)
    preds = [st.predict(x, pd, fd, hd, z, a[:, 0], r[:, 0])
             for st, x, pd, fd, hd, z, a, r in zip(stages, DF.blocks, p_d, pre_d, h_d,
                                                    z_prev.blocks, atol_z.blocks, rtol_z.blocks)]
    pred_ok = lane_all([pr.pred_ok for pr in preds], home)
    y_it = RowBlocks(layout, [pr.z_pred[:m] for pr, m in zip(preds, n_d)])
    writer: dict = {}  # each device's first block, which writes its copy of the state
    for d, dev in enumerate(layout.devices):
        writer.setdefault(dev, d)
    start = [lanes(x) for x in sweep_start(active, preds[0].z_pred.dtype)]
    states = {dev: SweepState(*(x[d] for x in start)) for dev, d in writer.items()}

    def shared(pending, to=None):  # the pending partials on the devices of the blocks ``to``
        ss, nf = layout.share(pending.ss, to), layout.share(pending.nonfinite, to)
        return [pending._replace(ss=tuple(a), nonfinite=tuple(b)) for a, b in zip(ss, nf)]

    in_place = len(layout.segments[0]) <= ROWS_SEGMENTS_MAX  # the home block's rows of f
    pending = None
    for k in range(maxiter):
        on = [None] * len(n_d) if pending is None else shared(pending)
        fz = system.fz(t_new, y_it.gather(), params)
        fz_b = scatter(layout, fz, home=not in_place)
        outs, decided = [], {}
        for d, (st, y, pr, m) in enumerate(zip(stages, y_it.blocks, preds, n_d)):
            dev = layout.devices[d]
            here = d == 0 and in_place
            out, state = st.sweep_rows(fz if here else fz_b.blocks[d], y, pr, states[dev], m,
                                       on[d], rows=layout.segments[0] if here else None,
                                       decide=writer[dev] == d)
            outs.append(out)
            if writer[dev] == d:
                decided[dev] = state
        states = decided
        pending = Pending(k, tuple(o.ss for o in outs), tuple(o.nonfinite for o in outs),
                          newton_tol, n)
        y_it = RowBlocks(layout, [o.y_next for o in outs])
    fz = scatter(layout, system.fz(t_new, y_it.gather(), params))
    fins = [st.finish_rows(f, pr, pd, hd, g, v[:, 0])
            for st, f, pr, pd, hd, g, v in zip(stages, fz.blocks, preds, p_d, h_d, g_d,
                                               v_err.blocks)]
    err3, conv, niter = home_stages.finish_lanes(
        lane_sum([f.ss3 for f in fins], home), pred_ok, states[home], newton_tol,
        None if pending is None else shared(pending, (0,))[0])

    def rows(xs):
        return RowBlocks(layout, list(xs))

    return HistoryOut(rows(pr.DF_resc for pr in preds), rows(f.DF_upd for f in fins),
                      rows(pr.z_pred for pr in preds), rows(f.z_new for f in fins),
                      rows(f.err0 for f in fins), err3, conv, niter)


adams_split_attempt_rows.launches = dict.fromkeys(ROWS_ENTRIES, 0)
