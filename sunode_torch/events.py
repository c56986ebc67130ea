"""Differentiable event times and hybrid restarts.

Port of ``sunode_tpu/events.py``.  An event time t* of ``g(t, y(t; θ), p(θ))
= 0`` is differentiable by the implicit function theorem,

    dt*/dθ = − (g_t + g_y · f)⁻¹ · (g_y · S(t*) + g_p),

with S(t*) = ∂y(t*; θ)/∂θ at fixed time.  As in the reference it is one
smooth Newton correction around the localized root t* (a constant under
autograd):

    t_event = t* − g(t*, y(t*; θ), p(θ)) / (g_t + g_y · f)|_*,

where the numerator re-evaluates y(t*) through the differentiable solve
(:func:`sunode_torch.wrappers.as_torch.make_solve_fn`, at a detached time)
and the denominator is evaluated at the detached root.  The value is the
localized root (the numerator is ~0 there); under ``torch.autograd`` the
correction carries the IFT gradient.  The event state is
``y_event = y(t*; θ) + f(t*) · (t_event − t*)``, whose gradient is the total
derivative ``S(t*) + f · dt*/dθ``.

:func:`make_hybrid_solve_fn` chains this into the hybrid pattern: integrate
to a terminal event, apply ``y⁺ = jump(t*, y⁻, p)``, re-enter the
integrator, up to ``max_events`` times, with gradients through every impact.

The solves are host loops, so whether a root was found is a host value: an
event function without a root returns ``(inf, NaN)`` at once (its gradient
zero, as the reference's masked placeholders give), and the hybrid loop
stops after its first segment without an event (the reference runs its
fixed ``3·max_events + 1`` solves, the masked ones without effect).  A
batch of chains goes lane by lane through :func:`map_lanes`, the port's
counterpart of the reference's ``vmap`` of these functions.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple, Optional

import torch

from sunode_torch.convert import device_or_raise
from sunode_torch.ops.adams import adams_solve
from sunode_torch.ops.bdf import BDFOptions, bdf_solve
from sunode_torch.wrappers.as_torch import _leaf, make_solve_fn, map_lanes

__all__ = ["make_event_fn", "make_hybrid_solve_fn", "HybridResult", "map_lanes"]


def _host(x) -> float:
    """A time's value on the host (a tensor's without its graph)."""
    return float(x.detach()) if torch.is_tensor(x) else float(x)


def _on_device(dev: torch.device, *xs):
    """The arrays of a call as tensors on the function's device (a tensor
    keeps its graph and must already be there; a number stays a number)."""
    return tuple(x if isinstance(x, (int, float)) else _leaf(x, None, dev) for x in xs)


def _zero_link(value: torch.Tensor, *inputs) -> torch.Tensor:
    """``value`` joined to every input tensor that requires a gradient with
    weight zero: the gradient of a missing event is zero, as the
    reference's masked branch gives, rather than absent."""
    for x in inputs:
        if torch.is_tensor(x) and x.requires_grad:
            value = value + 0.0 * x.sum()
    return value


def _build_event_core(
    problem,
    roots: Callable,
    *,
    which: int,
    options: BDFOptions,
    derivatives: str,
    adjoint_options: Optional[BDFOptions],
    checkpoint_n: int,
    root_directions: Optional[Any],
    root_terminal: bool,
    root_cap: int,
    solver: str,
    linear_solver: str = "dense",
    linear_solver_kwargs: Optional[dict] = None,
):
    """The shared IFT machinery (module docstring): ``core(t0, y0, p_sub,
    p_fix, t_max, stats) -> (found, t_event, y_event)`` with ``found`` a host
    bool and ``t_event``/``y_event`` None when no root was recorded; the
    forward solves' attempts are added to ``stats['n_attempts']``.  Returns
    ``(core, inner)``, ``inner`` the differentiable solve it re-solves with."""
    if solver not in ("BDF", "ADAMS"):
        raise ValueError(f"solver must be 'BDF' or 'ADAMS', got {solver!r}")
    root_fn = problem.make_root_fn(roots)
    rhs = problem.make_rhs()
    spec = problem.params
    inner = make_solve_fn(problem, derivatives=derivatives, options=options,
                          adjoint_options=adjoint_options, checkpoint_n=checkpoint_n,
                          linear_solver=linear_solver, linear_solver_kwargs=linear_solver_kwargs)
    jac = None
    if solver == "BDF":
        # the localization solve's Newton structure: the differentiable
        # solve's ('dense' | 'band' | 'sparse'), its sparse plans included
        jac, options = inner.jac, inner.options
    root_kw = dict(root_fn=root_fn, root_cap=root_cap, root_terminal=root_terminal,
                   root_directions=root_directions)

    def g_scalar(t, y, p, comp):
        # the component that fired at record `which` (from roots_found)
        return root_fn(t, y, p).reshape(-1)[comp]

    def g_derivs(t, y, p, comp):
        """``(g_t, g_y)`` at a detached point."""
        with torch.enable_grad():
            t_, y_ = t.detach().requires_grad_(True), y.detach().requires_grad_(True)
            g_t, g_y = torch.autograd.grad(g_scalar(t_, y_, p, comp), (t_, y_),
                                           allow_unused=True)
        return (torch.zeros_like(t) if g_t is None else g_t,
                torch.zeros_like(y) if g_y is None else g_y)

    def core(t0, y0, p_sub, p_fix, t_max, stats):
        y0 = torch.as_tensor(y0)
        p = spec.combine(p_sub, p_fix)
        p_sg = p.detach()
        tv = torch.as_tensor(t_max, dtype=y0.dtype, device=y0.device).detach().reshape(1)
        t0_h = _host(t0)
        if solver == "ADAMS":
            res = adams_solve(rhs, t0_h, y0.detach(), p_sg, tv, options, **root_kw)
        else:
            res = bdf_solve(rhs, jac, t0_h, y0.detach(), p_sg, tv, options, **root_kw)
        stats["n_attempts"] += int(res.stats["n_attempts"])
        # the primal root: a constant under autograd
        t_star = res.stats["roots_t"][which].detach()
        y_star = res.stats["roots_y"][which].detach()
        if not (bool(torch.isfinite(t_star)) and bool(torch.isfinite(y_star).all())):
            return False, None, None
        comp = int(torch.argmax(torch.abs(res.stats["roots_found"][which])))
        f_star = rhs(t_star, y_star, p_sg)
        g_t, g_y = g_derivs(t_star, y_star, p_sg, comp)
        den = g_t + torch.dot(g_y, f_star)
        # y(t*; θ) at the detached time: its gradient is S(t*) (and g_p below)
        y_diff = inner(t0, y0, p_sub, p_fix, t_star.reshape(1))[0]
        stats["n_attempts"] += int(inner.last_stats["forward"]["n_attempts"])
        num = g_scalar(t_star, y_diff, p, comp)
        t_event = t_star - num / den
        y_event = y_diff + f_star * (t_event - t_star)
        return True, t_event, y_event

    return core, inner


def make_event_fn(
    problem,
    roots: Callable,
    *,
    which: int = 0,
    options: BDFOptions = BDFOptions(),
    derivatives: str = "forward",
    adjoint_options: Optional[BDFOptions] = None,
    checkpoint_n: int = 4096,
    root_directions: Optional[Any] = None,
    root_terminal: bool = True,
    root_cap: int = 8,
    solver: str = "BDF",
    linear_solver: str = "dense",
    linear_solver_kwargs: Optional[dict] = None,
    device="cuda",
) -> Callable:
    """``event(t0, y0, p_sub, p_fix, t_max) -> (t_event, y_event)`` with IFT
    gradients through ``torch.autograd``; the reference's signature and
    defaults.

    ``roots(t, y, p)`` is the record-view event function of
    ``Solver(roots=...)`` (symbolic for a ``SympyProblem``, torch code for
    a ``TorchProblem``), lowered by ``problem.make_root_fn``.  ``which``
    picks the recorded root (``which > 0`` needs ``root_terminal=False``);
    ``derivatives`` 'forward' or 'adjoint' differentiates y(t*; θ);
    ``solver`` 'BDF' or 'ADAMS' localizes the root; ``linear_solver``
    'band' or 'sparse' gives the BDF Newton solves their structure.  No
    root in ``[t0, t_max]`` gives ``(inf, NaN)``.  The solves run on
    ``device``, the card unless the caller passes ``device="cpu"`` (without
    a card the default raises); a tensor argument must lie there.
    ``event.last_stats['n_attempts']`` counts the latest call's forward
    attempts (the localization's and the re-solve's; a backward's are the
    differentiable solve's own)."""
    if which > 0 and root_terminal:
        raise ValueError(
            "which > 0 requires root_terminal=False (a terminal solve "
            "stops at the first root; later roots are never recorded)"
        )
    if which >= root_cap:
        raise ValueError(f"which={which} >= root_cap={root_cap}")
    dev = device_or_raise(device)
    core, _ = _build_event_core(
        problem, roots, which=which, options=options, derivatives=derivatives,
        adjoint_options=adjoint_options, checkpoint_n=checkpoint_n,
        root_directions=root_directions, root_terminal=root_terminal, root_cap=root_cap,
        solver=solver, linear_solver=linear_solver, linear_solver_kwargs=linear_solver_kwargs,
    )

    def event(t0, y0, p_sub, p_fix, t_max):
        t0, y0, p_sub, p_fix, t_max = _on_device(dev, t0, y0, p_sub, p_fix, t_max)
        event.last_stats = {"n_attempts": 0}
        found, t_event, y_event = core(t0, y0, p_sub, p_fix, t_max, event.last_stats)
        if found:
            return t_event, y_event
        inputs = (t0, y0, p_sub, p_fix, t_max)
        return (_zero_link(torch.full((), float("inf"), dtype=y0.dtype, device=y0.device),
                           *inputs),
                _zero_link(torch.full_like(y0, float("nan")), *inputs))

    event.last_stats = {}
    return event


class HybridResult(NamedTuple):
    """Result of a hybrid (event-restart) solve.

    ys:        (n_t, n) trajectory on ``tvals``; an observation exactly at
               an event time reports the pre-jump state.
    event_ts:  (max_events,) differentiable event times; +inf in unused
               slots.
    event_ys:  (max_events, n) pre-jump states y⁻(t*); NaN in unused slots.
    event_ys_post: (max_events, n) post-jump states y⁺ = jump(t*, y⁻, p).
    n_events:  int32 scalar, the events taken.  When it equals
               ``max_events`` the last segment may have crossed further
               (untreated) roots: raise ``max_events``.
    """

    ys: torch.Tensor
    event_ts: torch.Tensor
    event_ys: torch.Tensor
    event_ys_post: torch.Tensor
    n_events: torch.Tensor


def _wrap_jump(problem, jump_fn):
    """``jump_fn`` on the record views the right-hand side gets
    ``(t, y_record, p_record)``; it returns a state dict or a flat vector."""
    states, params = problem.states, problem.params

    def jf(t, y_flat, p_flat):
        out = jump_fn(t, states.record(y_flat), params.record(p_flat))
        if isinstance(out, Mapping):
            return states.flatten_dict(out, follow_dtype=True, device=y_flat.device)
        return torch.as_tensor(out).to(y_flat.dtype)

    return jf


def make_hybrid_solve_fn(
    problem,
    roots: Callable,
    jump_fn: Callable,
    *,
    max_events: int = 4,
    options: BDFOptions = BDFOptions(),
    derivatives: str = "forward",
    adjoint_options: Optional[BDFOptions] = None,
    checkpoint_n: int = 4096,
    root_directions: Optional[Any] = None,
    solver: str = "BDF",
    linear_solver: str = "dense",
    linear_solver_kwargs: Optional[dict] = None,
    device="cuda",
) -> Callable:
    """``hybrid(t0, y0, p_sub, p_fix, tvals) -> HybridResult``: an
    event-restart loop with differentiable jumps; the reference's signature
    and defaults.

    At each terminal root t* the state is reset to ``y⁺ = jump_fn(t*, y⁻,
    p)`` and integration re-enters from (t*, y⁺), up to ``max_events``
    times; the last segment runs to ``tvals[-1]``.  ``jump_fn(t, y, p)``
    gets the same record views as the right-hand side and returns a state
    dict or a flat tensor.  Every event time carries the IFT gradient, every
    restart the jump's Jacobian and the next segment's solve.  Pass
    ``root_directions`` so that the departure from the event surface does
    not fire the same event again; roots at or before a segment's start are
    dropped.  The solves run on ``device`` as :func:`make_event_fn`'s, and
    ``hybrid.last_stats['n_attempts']`` counts the latest call's forward
    attempts as its ``event.last_stats`` does."""
    if max_events < 1:
        raise ValueError(f"max_events must be >= 1, got {max_events}")
    dev = device_or_raise(device)
    solve_kw = dict(options=options, derivatives=derivatives, adjoint_options=adjoint_options,
                    checkpoint_n=checkpoint_n, linear_solver=linear_solver,
                    linear_solver_kwargs=linear_solver_kwargs)
    core, inner = _build_event_core(problem, roots, which=0, root_directions=root_directions,
                                    root_terminal=True, root_cap=1, solver=solver, **solve_kw)
    spec = problem.params
    jump = _wrap_jump(problem, jump_fn)

    def hybrid(t0, y0, p_sub, p_fix, tvals):
        t0, y0, p_sub, p_fix, tvals = _on_device(dev, t0, y0, p_sub, p_fix, tvals)
        tvals = tvals.to(y0.dtype)
        t_end = tvals[-1]
        p = spec.combine(p_sub, p_fix)
        seg_t = torch.as_tensor(t0, dtype=y0.dtype, device=y0.device)
        seg_y = y0
        assigned = torch.zeros(tvals.shape, dtype=torch.bool, device=y0.device)
        ys = torch.zeros(tuple(tvals.shape) + tuple(y0.shape), dtype=y0.dtype, device=y0.device)
        ev_t, ev_ym, ev_yp = [], [], []
        stats = hybrid.last_stats = {"n_attempts": 0}
        for k in range(max_events + 1):
            found = False
            if k < max_events:
                found, t_e, y_e = core(seg_t, seg_y, p_sub, p_fix, t_end, stats)
                # drop roots at or inside the restart point and past the horizon
                found = found and _host(seg_t) < _host(t_e) < _host(t_end)
            seg_end = t_e if found else t_end
            # this segment's slice of the grid, clamped inside [seg_t, seg_end]
            # (the dynamics may be invalid past the event); masked below
            tv = torch.minimum(torch.maximum(tvals, seg_t), seg_end)
            ys_seg = inner(seg_t, seg_y, p_sub, p_fix, tv)
            stats["n_attempts"] += int(inner.last_stats["forward"]["n_attempts"])
            take = ~assigned & (tvals <= seg_end)
            ys = torch.where(take[:, None], ys_seg, ys)
            assigned = assigned | take
            if not found:
                break
            y_plus = jump(t_e, y_e, p)
            ev_t.append(t_e)
            ev_ym.append(y_e)
            ev_yp.append(y_plus)
            seg_t, seg_y = t_e, y_plus
        n_events = len(ev_t)
        for _ in range(max_events - n_events):
            ev_t.append(torch.full((), float("inf"), dtype=y0.dtype, device=y0.device))
            ev_ym.append(torch.full_like(y0, float("nan")))
            ev_yp.append(torch.full_like(y0, float("nan")))
        return HybridResult(
            ys=ys,
            event_ts=torch.stack([t.reshape(()) for t in ev_t]),
            event_ys=torch.stack(ev_ym),
            event_ys_post=torch.stack(ev_yp),
            n_events=torch.tensor(n_events, dtype=torch.int32, device=y0.device),
        )

    hybrid.last_stats = {}
    return hybrid
