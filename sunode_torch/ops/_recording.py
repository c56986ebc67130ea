"""Checkpoint recording with automatic thinning, for the batched and the
single-instance cores.

Port of ``sunode_tpu/ops/_recording.py``.  The forward
solve records every accepted step's ``(t, y, f[, f', L])`` row into a fixed
buffer of ``save_steps`` slots indexed by the shared attempt counter; when
the buffer fills it is compacted (every second row kept) and the recording
stride doubles, up to ``MAX_THIN`` times, after which a lane that should
record and cannot is flagged ``overflow`` (its gradient is NaN by contract).
A rolling ``tail`` row per lane keeps its most recent accepted step that
the stride skipped, so the recording always ends at the last accepted step.

The write pointer, the stride and every decision that depends only on the
shared attempt counter (record this attempt, compact, buffer full) are host
ints here, so recording adds no device sync; the buffer, ``n_saved``,
``overflow`` and ``tail`` stay on the device.

Layout: ``tyf (S, W, B)``, trailing batch; rejected attempts and empty slots
hold a pad row (``t = +inf``, zeros), compaction pads are ``+inf`` in every
column; :func:`finalize_saved_batched` sorts each lane's rows by ``t``.

The single half (``init_saved_single``, ``record_step_single``,
``finalize_saved_single``) records accepted steps only, ``tyf (S, W)`` with
its own write pointer: the single cores decide acceptance on the host, so
every decision of the recording (record, compact, full, the tail's
freshness) is a host int or bool, and a rejected attempt touches nothing.
"""

from __future__ import annotations

import torch

from sunode_torch import forward_ad

__all__ = [
    "MAX_THIN",
    "fdot",
    "pad_column",
    "init_saved_batched",
    "record_step_batched",
    "finalize_saved_batched",
    "init_saved_single",
    "record_step_single",
    "finalize_saved_single",
    "fill_fdot_single",
]

MAX_THIN = 10


def fdot(rhs, t, y, f, params):
    """Total time derivative of the right-hand side along the trajectory,
    ``d f(t, y(t)) / dt = J f + f_t``, by one forward-mode product with the
    tangent ``(1, f)``: the quintic Hermite rows (``hermite_order=5``)."""
    return forward_ad.jvp(
        lambda tt, yy: rhs(tt, yy, params), (t, y), (torch.ones_like(t), f)
    )[1]


def pad_column(W: int, like: torch.Tensor) -> torch.Tensor:
    """The pad row as ``(W, 1)``: ``+inf`` in the time row, zeros below."""
    pad = torch.zeros((W, 1), dtype=like.dtype, device=like.device)
    pad[0] = float("inf")
    return pad


def init_saved_batched(row0: torch.Tensor, save_steps: int, thinning: bool) -> dict:
    """Recording state: a buffer ``(save_steps, W, B)`` of pad rows whose
    slot 0 holds the initial row ``row0 (W, B)``."""
    W, B = row0.shape
    buf0 = pad_column(W, row0).expand(W, B).repeat(save_steps, 1, 1)
    buf0[0] = row0
    sv = {
        "tyf": buf0,
        "n_saved": torch.ones((B,), dtype=torch.int32, device=buf0.device),
        "overflow": torch.zeros((B,), dtype=torch.bool, device=buf0.device),
    }
    if thinning:
        sv["w_ptr"] = 1
        sv["shift"] = 0
        sv["tail"] = pad_column(W, buf0).expand(W, B).clone()
    return sv


def record_step_batched(sv: dict, it: int, accept: torch.Tensor, row: torch.Tensor,
                        save_steps: int, thinning: bool) -> dict:
    """One recording update: ``row (W, B)`` already holds the pad row for
    rejected lanes, ``it`` is this attempt's index (the shared counter)."""
    buf = sv["tyf"]
    if not thinning:
        # legacy clamp: once the counter clamps to the last slot, a rejected
        # attempt keeps the slot's row, and a clamped accepted write overflows
        slot = min(it + 1, save_steps - 1)
        clamped = it + 1 >= save_steps
        if clamped:
            row = torch.where(accept[None, :], row, buf[slot])
        buf[slot] = row
        return dict(
            tyf=buf,
            n_saved=sv["n_saved"] + accept.to(torch.int32),
            overflow=sv["overflow"] | accept if clamped else sv["overflow"],
        )

    shift, w_ptr = sv["shift"], sv["w_ptr"]
    if ((it + 1) & ((1 << shift) - 1)) == 0 and w_ptr >= save_steps and shift < MAX_THIN:
        kept = (save_steps + 1) // 2
        pad_rows = torch.full((save_steps - kept,) + tuple(buf.shape[1:]), float("inf"),
                              dtype=buf.dtype, device=buf.device)
        buf = torch.cat([buf[::2], pad_rows])
        w_ptr, shift = kept, shift + 1
    # the stride may have doubled: test this attempt against the new one
    rec = ((it + 1) & ((1 << shift) - 1)) == 0
    full = w_ptr >= save_steps  # only once the stride is at MAX_THIN
    tail = sv["tail"]
    if rec and not full:
        # an accepted lane records its new step; a lane that rejected this
        # attempt records its rolling tail, if it has one, in its place
        tail_fresh = torch.isfinite(tail[0])
        buf[w_ptr] = torch.where(accept[None, :], row,
                                 torch.where(tail_fresh[None, :], tail, row))
        tail = torch.where((accept | tail_fresh)[None, :], pad_column(row.shape[0], row), tail)
        w_ptr += 1
    else:
        tail = torch.where(accept[None, :], row, tail)
    return dict(
        tyf=buf,
        n_saved=sv["n_saved"] + accept.to(torch.int32),
        # a step that should record at the current stride but cannot
        overflow=sv["overflow"] | accept if (rec and full) else sv["overflow"],
        w_ptr=w_ptr,
        shift=shift,
        tail=tail,
    )


def finalize_saved_batched(sv: dict, n: int, thinning: bool) -> dict:
    """Sort each lane's rows by time (pads last) and split them into the
    dict the evaluators read: ``t (S, B)``, ``y``, ``f`` and, with quintic
    rows, ``fd`` ``(S, n, B)``, the packed ``yf (S, 2n|3n, B)``, ``L (S, B)``
    where the rows carry it, ``n_saved (B,)`` (under thinning the count of
    finite rows) and ``overflow (B,)``."""
    buf = sv["tyf"]
    if thinning:
        # append each lane's tail so that the recording ends at its last step
        buf = torch.cat([buf, sv["tail"][None]])
    order = torch.argsort(buf[:, 0, :], dim=0, stable=True)
    buf = torch.take_along_dim(buf, order[:, None, :], dim=0)
    n_rows = (
        torch.isfinite(buf[:, 0, :]).sum(dim=0).to(torch.int32) if thinning else sv["n_saved"]
    )
    W = buf.shape[1]
    has_L = W == 2 + 3 * n
    yf_end = 1 + 3 * n if (has_L or W == 1 + 3 * n) else 1 + 2 * n
    out = {
        "t": buf[:, 0, :],
        "y": buf[:, 1 : n + 1, :],
        "f": buf[:, n + 1 : 2 * n + 1, :],
        "yf": buf[:, 1:yf_end, :],
        "n_saved": n_rows,
        "overflow": sv["overflow"],
    }
    if yf_end == 1 + 3 * n:
        out["fd"] = buf[:, 2 * n + 1 : 3 * n + 1, :]
    if has_L:
        out["L"] = buf[:, 1 + 3 * n, :]
    return out


def _pad_rows(rows: int, like: torch.Tensor) -> torch.Tensor:
    """``rows`` pad rows ``(rows, W)``: ``+inf`` time, zeros below."""
    pad = torch.zeros((rows, like.shape[-1]), dtype=like.dtype, device=like.device)
    pad[:, 0] = float("inf")
    return pad


def init_saved_single(row0: torch.Tensor, save_steps: int, thinning: bool) -> dict:
    """Recording state of one solve: a buffer ``(save_steps, W)`` of pad rows
    whose slot 0 holds the initial row ``row0 (W,)``; ``n_saved`` and
    ``overflow`` host values, and under thinning the stride's ``shift``,
    the accepted-step counter ``k`` and the rolling ``tail`` (None while
    no accepted step waits unrecorded)."""
    buf = _pad_rows(save_steps, row0)
    buf[0] = row0
    sv = {"tyf": buf, "n_saved": 1, "overflow": False}
    if thinning:
        sv.update(shift=0, k=0, tail=None)
    return sv


def record_step_single(sv: dict, accept: bool, row, save_steps: int, thinning: bool) -> dict:
    """One recording update of a single-instance core
    (``sunode_tpu/ops/_recording.py::record_step_single``): ``row`` is a
    zero-argument callable giving the step's row ``(W,)``, called only
    when an accepted step is written or becomes the tail."""
    buf = sv["tyf"]
    if not thinning:
        ns = sv["n_saved"]
        if accept:
            buf[min(ns, save_steps - 1)] = row()
        return dict(
            tyf=buf,
            n_saved=min(ns + 1, save_steps) if accept else ns,
            overflow=sv["overflow"] or (accept and ns >= save_steps),
        )

    shift, ns, tail = sv["shift"], sv["n_saved"], sv["tail"]
    k_new = sv["k"] + 1 if accept else sv["k"]
    if accept and (k_new & ((1 << shift) - 1)) == 0 and ns >= save_steps and shift < MAX_THIN:
        kept = (save_steps + 1) // 2
        pad = torch.full((save_steps - kept, buf.shape[1]), float("inf"),
                         dtype=buf.dtype, device=buf.device)
        buf = torch.cat([buf[::2], pad])
        ns, shift = kept, shift + 1
    # the stride may have doubled: test this step against the new one
    rec = accept and (k_new & ((1 << shift) - 1)) == 0
    full = ns >= save_steps  # only once the stride is at MAX_THIN
    do_write = rec and not full
    if do_write:
        buf[ns] = row()
        tail = None
    elif accept:
        tail = row()
    return dict(
        tyf=buf,
        n_saved=ns + int(do_write),
        # a step that should record at the current stride but cannot
        overflow=sv["overflow"] or (rec and full),
        shift=shift,
        k=k_new,
        tail=tail,
    )


def finalize_saved_single(sv: dict, thinning: bool):
    """``(tyf, n_saved, overflow)``; under thinning the buffer gains one row
    of capacity and the rolling tail, when there is one, goes into the
    first free slot, so the recording ends at the last accepted step."""
    buf, ns = sv["tyf"], sv["n_saved"]
    if not thinning:
        return buf, ns, sv["overflow"]
    buf = torch.cat([buf, _pad_rows(1, buf)])
    if sv["tail"] is not None:
        buf[min(ns, buf.shape[0] - 1)] = sv["tail"]
        ns += 1
    return buf, ns, sv["overflow"]


def fill_fdot_single(buf: torch.Tensor, n_rows: int, n: int, rhs, params) -> torch.Tensor:
    """The quintic rows' ``f'`` columns (``2n+1 .. 3n``) of a single
    recording's first ``n_rows`` rows, from their ``(t, y, f)`` in one
    forward-mode product over all rows at once: each row's value is
    :func:`fdot` of that row, and the single cores fill the column here,
    after the solve, instead of once an accepted step."""
    if n_rows:
        rows = buf[:n_rows]
        fd = fdot(rhs, rows[:, 0], rows[:, 1 : n + 1].T, rows[:, n + 1 : 2 * n + 1].T,
                  params[:, None])
        buf[:n_rows, 2 * n + 1 : 3 * n + 1] = torch.broadcast_to(fd, (n, n_rows)).T
    return buf
