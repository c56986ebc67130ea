"""The workloads: batched Lotka-Volterra adjoint gradients, stiff Robertson,
SIR over many regions.

:func:`build_lv_checkpointed` takes the same Lotka-Volterra gradients
through the reference's default call, BDF with the checkpointed adjoint, and
:func:`build_lv_adams` through the ADAMS adjoints that read no transition
matrix: 'resolve', 'hermite' and 'polynomial'.

:func:`build_lv_adjoint` is the port of ``__graft_entry__._build`` (method
ADAMS): a Lotka-Volterra ``SympyProblem`` (2 states, 4 params, derivatives
w.r.t. alpha and beta), the batched Adams forward solve and
transition-adjoint gradients of ``sum(ys**2)``, with the same options as
the reference workload:

  * forward: rtol = atol = ``rtol``, ``adams_max_order=6``;
  * backward: the seminorm layout, rtol ``10*rtol`` on the y rows and 1e-3
    on the M rows, quadrature rtol/atol 1e-3, ``adams_max_order=6``.

:func:`build_robertson` is ``bench.py``'s Robertson workload: stiff
three-species kinetics solved with batched BDF from t=0 to 4e6.

:func:`build_lv_sens` solves the same Lotka-Volterra chains with forward
sensitivities to alpha and beta (``bench.py``'s ``lv_sens`` workload):
staggered on the BDF or the Adams core, or simultaneous on the Adams core
as the augmented state ``[y | vec S]``.  :func:`build_lv_roots` solves them
with the event ``hares = 9``, stopping at the first root or recording up to
eight.

:func:`build_lv_adjoint_f32` is ``bench.py``'s ``lv_adjoint_f32``: the
same transition-adjoint gradients at float32 end to end (rtol 1e-6 forward,
1e-5 backward), every kernel launch the float32 build.
:func:`build_lv_per_lane` solves the Lotka-Volterra chains on seeded ragged
per-lane observation grids, ``tvals (B, 21)``.

:func:`build_sir` is ``scripts/bench_sir_scale.py``'s workload: an SIR
model over ``R`` regions coupled to their ring neighbours, written in torch
(:func:`sir_problem`, a ``TorchProblem``: 3R states), with ADAMS adjoint
gradients of ``sum(ys[:, :, R:2R]**2)`` with respect to (beta, gamma) in
'resolve' or 'hermite'.  On the card its attempts run the split Adams
kernels (``ops/adams_split.py``), the right-hand side in torch between them;
``dtype=torch.float32`` runs it at float32 with ``bench.py``'s float32
tolerances (the float32 builds of the split kernels).
:func:`build_sir_state_split` is the same gradient on a 2-D (chains x state)
mesh: each chain group's 3R state rows split over its row of devices.

The structured Newton solves: :func:`build_kpp` is
``scripts/bench_batched_structured.py``'s Fisher-KPP reaction-diffusion
chain (n states, tridiagonal Jacobian, stiff through the diffusion term)
with band, sparse or dense Newton through ``make_batched_solve_fn`` (a
forward solve and adjoint gradients), or spgmr through
``bdf_solve_batched``; :func:`build_hub` is ``tests/test_bbd.py``'s hub
problem (a chain of n nodes plus one hub coupled to every node: an
arrowhead Jacobian) with sparse Newton, whose plan borders the hub.
:func:`build_lv_spline` is the Lotka-Volterra gradient step with the prey
birth rate a cubic ``interpolate_spline`` of t whose values are
parameters: on the card the emitted forward and transition systems carry
the spline into the history-attempt kernel.

The single-chain surface: :func:`build_lv_single` is the Lotka-Volterra
gradient of :func:`build_lv_checkpointed` for one chain at a time, through
``make_solve_fn`` (the single-instance BDF core and its checkpointed
adjoint); :func:`build_kpp_single` is the Fisher-KPP chain through it with
band, sparse or dense Newton.

The class API and events: :func:`build_lv_forward` is ``bench.py``'s
``lv_forward`` at a batch, an ADAMS forward solve at rtol 1e-10 through
:class:`~sunode_torch.solver.Solver` with per-lane params;
:func:`build_ball_event` and :func:`build_ball_hybrid` are the bouncing
ball of ``tests/test_event_grads.py`` and ``tests/test_hybrid_events.py``
through :func:`~sunode_torch.events.make_event_fn` and
:func:`~sunode_torch.events.make_hybrid_solve_fn`.

The sampler: :func:`build_lv_nuts` is BASELINE config 4 at the settings of
``scripts/exp_nuts_f32.py`` (float64): the Lotka-Volterra posterior over
log(alpha, beta), whose log density runs one batched ADAMS forward solve
and one transition-adjoint solve for all chains a gradient, for
:func:`~sunode_torch.sample.nuts_sample`.

The B=1 deployment (the reference's one chain a process under PyMC):
:func:`build_lv_forward_single` is ``bench.py``'s ``lv_forward --batch 1``
and :func:`build_lv_adjoint_single` its ``lv_adjoint --batch 1``, a
forward and backward pair through ``AdjointSolver``.  On ``device="cpu"``
both take the native host route (the C++ integrators of ``native/``); on
the card the single cores.  :func:`build_lv_adjoint_sharded` is
:func:`build_lv_adjoint`'s gradient step with the chains split over a
:class:`~sunode_torch.parallel.mesh.Mesh`, the counterpart of
``__graft_entry__.dryrun_multichip``'s sharded step.
"""

from __future__ import annotations

import numpy as np
import torch

from sunode_torch.convert import device_or_raise
from sunode_torch.events import make_event_fn, make_hybrid_solve_fn
from sunode_torch.ops.adams_batched import adams_solve_batched
from sunode_torch.ops.bdf import BDFOptions
from sunode_torch.ops.bdf_batched import bdf_solve_batched
from sunode_torch.problem import TorchProblem
from sunode_torch.solver import AdjointSolver, Solver
from sunode_torch.symode.lambdify import interpolate_spline
from sunode_torch.symode.problem import SympyProblem
from sunode_torch.wrappers.as_torch import make_batched_solve_fn, make_solve_fn

__all__ = [
    "lv_problem",
    "lv_options",
    "build_lv_adjoint",
    "build_lv_adjoint_f32",
    "lv_adjoint_inputs",
    "build_lv_checkpointed",
    "build_lv_single",
    "build_kpp_single",
    "build_lv_adams",
    "LV_ADAMS_CHECKPOINTS",
    "LV_P_FIX",
    "lv_sens_inputs",
    "build_lv_sens",
    "LV_SENS_MODES",
    "lv_root_inputs",
    "build_lv_roots",
    "LV_ROOT_CAP",
    "lv_per_lane_tvals",
    "build_lv_per_lane",
    "robertson_problem",
    "robertson_options",
    "build_robertson",
    "ROBERTSON_K",
    "sir_problem",
    "sir_inputs",
    "sir_options",
    "build_sir",
    "kpp_problem",
    "kpp_inputs",
    "build_kpp",
    "hub_problem",
    "hub_inputs",
    "build_hub",
    "lv_spline_problem",
    "build_lv_spline",
    "lv_forward_inputs",
    "build_lv_forward",
    "BALL_OPTIONS",
    "build_ball_event",
    "build_ball_hybrid",
    "LV_NUTS_TIMES",
    "LV_NUTS_SIGMA",
    "lv_nuts_observations",
    "lv_nuts_init",
    "build_lv_nuts",
    "LV_FORWARD_PARAMS",
    "build_lv_forward_single",
    "build_lv_adjoint_single",
    "build_lv_adjoint_sharded",
]

LV_P_FIX = (1.0, 0.4)  # gamma, delta


def _lv(t, y, p):
    return {
        "hares": p.alpha * y.hares - p.beta * y.lynx * y.hares,
        "lynx": p.delta * y.hares * y.lynx - p.gamma * y.lynx,
    }


def lv_problem() -> SympyProblem:
    return SympyProblem(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()},
        rhs_sympy=_lv,
        derivative_params=[("alpha",), ("beta",)],
    )


def lv_options(rtol: float) -> tuple[BDFOptions, BDFOptions]:
    """(forward, backward) options of the main-path workload."""
    bwd_rtol = max(rtol * 10.0, 1e-12)
    n_state = 2
    adj_rtol = np.concatenate(
        [np.full(n_state, bwd_rtol), np.full(n_state * n_state, 1e-3)]
    )
    adj_opts = BDFOptions(
        rtol=adj_rtol, atol=bwd_rtol, adams_max_order=6,
        quad_rtol=1e-3, quad_atol=1e-3,
    )
    fwd_opts = BDFOptions(rtol=rtol, atol=rtol, adams_max_order=6)
    return fwd_opts, adj_opts


def _lv_adjoint_solve(rtol: float, problem=None):
    """The batched solve of :func:`build_lv_adjoint`."""
    fwd_opts, adj_opts = lv_options(rtol)
    return make_batched_solve_fn(
        lv_problem() if problem is None else problem,
        derivatives="adjoint",
        options=fwd_opts,
        adjoint_options=adj_opts,
        method="ADAMS",
        adjoint_interpolation="transition",
    )


def build_lv_adjoint(batch: int, tvals_n: int, rtol: float, device="cuda"):
    """``(grad_step, (y0s, p_subs))``: ``grad_step(y0s, p_subs) -> (gy, gp)``
    is one batched gradient of ``sum(ys**2)`` (what NUTS runs per leapfrog,
    across all chains at once); ``grad_step.solve`` is the solver, whose
    ``last_stats`` report the attempts of the latest step.  It runs on the
    card unless ``device="cpu"``; without a card the default raises."""
    device = device_or_raise(device)
    return _lv_grad_step(_lv_adjoint_solve(rtol), batch, tvals_n, device)


def build_lv_adjoint_sharded(batch: int, mesh, tvals_n: int = 21, rtol: float = 1e-8):
    """:func:`build_lv_adjoint` with the chains split over ``mesh`` (a
    :class:`~sunode_torch.parallel.mesh.Mesh`): ``(grad_step, (y0s,
    p_subs))``, the same inputs on ``mesh.devices[0]``.  ``grad_step(y0s,
    p_subs)`` cuts both into one contiguous chunk a device
    (``map_over_chains``), solves each chunk on its device with a batched
    solve of its own (a host thread a device where the mesh holds more than
    one distinct device), gathers ``ys`` on the first device and returns
    the gradients of ``sum(ys**2)`` there.
    ``grad_step.solves`` are the devices' solves (their ``last_stats`` the
    chunks' attempts).  ``batch`` must divide evenly over the devices."""
    from sunode_torch.parallel.mesh import map_over_chains

    if batch % mesh.size:
        raise ValueError(f"batch {batch} does not divide evenly over {mesh.size} devices")
    for d in mesh.devices:
        device_or_raise(d)
    problem = lv_problem()
    solves = [_lv_adjoint_solve(rtol, problem) for _ in mesh.devices]
    step, inputs = _lv_grad_step(solves[0], batch, tvals_n, mesh.devices[0])
    fns = [lambda y0s, p_subs, p_fix, tvals, solve=solve: solve(0.0, y0s, p_subs, p_fix, tvals)
           for solve in solves]
    mapped = map_over_chains(fns, mesh, chain_argnums=(0, 1))

    def grad_step(y0s, p_subs, tvals=step.tvals):
        y0s = y0s.detach().requires_grad_(True)
        p_subs = p_subs.detach().requires_grad_(True)
        ys = mapped(y0s, p_subs, step.p_fix, tvals)
        return torch.autograd.grad(torch.sum(ys**2), (y0s, p_subs))

    grad_step.solves, grad_step.tvals, grad_step.p_fix = solves, step.tvals, step.p_fix
    grad_step.mesh = mesh
    return grad_step, inputs


def build_lv_checkpointed(batch: int, tvals_n: int, rtol: float, interpolation="hermite",
                          device="cuda"):
    """:func:`build_lv_adjoint` through the reference's default call instead:
    ``make_batched_solve_fn(lv_problem(), options=BDFOptions(rtol=rtol,
    atol=rtol))`` with every other argument at its default (BDF, the
    checkpointed adjoint over ``checkpoint_n=1024`` recorded steps, backward
    tolerances 1e-10), ``interpolation`` 'hermite' (the default) or
    'polynomial'.  Same ``(grad_step, (y0s, p_subs))``; it runs on the card
    unless ``device="cpu"``; without a card the default raises."""
    device = device_or_raise(device)
    kw = {} if interpolation == "hermite" else dict(adjoint_interpolation=interpolation)
    solve = make_batched_solve_fn(lv_problem(), options=BDFOptions(rtol=rtol, atol=rtol), **kw)
    return _lv_grad_step(solve, batch, tvals_n, device)


def build_lv_single(batch: int = 16, tvals_n: int = 21, rtol: float = 1e-8, device="cuda"):
    """``(grad_step, (y0s, p_subs))``: ``grad_step(y0 (2,), p_sub (2,)) ->
    (gy, gp)`` is one chain's gradient of ``sum(ys**2)`` (the loss of
    :func:`build_lv_checkpointed`) through ``make_solve_fn(lv_problem(),
    options=BDFOptions(rtol=rtol, atol=rtol))`` with every other argument at
    its default (the checkpointed 'hermite' adjoint over 4,096 recorded
    steps, backward tolerances 1e-10); ``y0s``, ``p_subs`` ``(batch, 2)``
    are the bench's chains (:func:`lv_adjoint_inputs`, lanes 0-15
    ``tests/golden/lv_adjoint.npz``'s).  ``grad_step.solve`` is the solve,
    whose ``last_stats`` report the latest step's attempts.  It runs on the
    card unless ``device="cpu"``; without a card the default raises."""
    device = device_or_raise(device)
    f_kw = dict(dtype=torch.float64, device=device)
    solve = make_solve_fn(lv_problem(), options=BDFOptions(rtol=rtol, atol=rtol))
    tvals = torch.as_tensor(np.linspace(1.0, 10.0, tvals_n), **f_kw)
    p_fix = torch.as_tensor(LV_P_FIX, **f_kw)

    def grad_step(y0, p_sub, tvals=tvals):
        y0 = y0.detach().requires_grad_(True)
        p_sub = p_sub.detach().requires_grad_(True)
        ys = solve(0.0, y0, p_sub, p_fix, tvals)
        return torch.autograd.grad(torch.sum(ys**2), (y0, p_sub))

    grad_step.solve, grad_step.tvals, grad_step.p_fix = solve, tvals, p_fix
    y0s, p_subs = lv_adjoint_inputs(batch)
    return grad_step, (torch.as_tensor(y0s, **f_kw), torch.as_tensor(p_subs, **f_kw))


LV_ADAMS_CHECKPOINTS = 384  # checkpoint_n of tests/test_golden.py's ADAMS modes


def build_lv_adams(batch: int, tvals_n: int, rtol: float, interpolation: str,
                   device="cuda"):
    """:func:`build_lv_adjoint` through ``make_batched_solve_fn(lv_problem(),
    method='ADAMS', adjoint_interpolation=interpolation)``, ``interpolation``
    'resolve', 'hermite' or 'polynomial', with the options of the JAX
    package's golden test of these modes: rtol = atol = ``rtol`` forward and
    backward, ``checkpoint_n=384`` recorded steps, every other option at its
    default.  Same ``(grad_step, (y0s, p_subs))``; it runs on the card
    unless ``device="cpu"``; without a card the default raises."""
    device = device_or_raise(device)
    if interpolation not in ("resolve", "hermite", "polynomial"):
        raise ValueError(
            f"interpolation must be 'resolve', 'hermite' or 'polynomial', got {interpolation!r}"
        )
    opts = BDFOptions(rtol=rtol, atol=rtol)
    solve = make_batched_solve_fn(
        lv_problem(), options=opts, adjoint_options=opts, checkpoint_n=LV_ADAMS_CHECKPOINTS,
        method="ADAMS", adjoint_interpolation=interpolation,
    )
    return _lv_grad_step(solve, batch, tvals_n, device)


def build_lv_adjoint_f32(batch: int, tvals_n: int = 21, device="cuda"):
    """``bench.py``'s ``lv_adjoint_f32`` (``bench.py:157-229``): the
    :func:`build_lv_adjoint` gradients at float32 end to end, ADAMS with the
    transition adjoint, rtol = atol = 1e-6 forward and 1e-5 backward,
    ``adams_max_order=6``, on the bench's chains (:func:`lv_adjoint_inputs`:
    a 5% spread from ``default_rng(42)``, lanes 0-15
    ``tests/golden/lv_adjoint.npz``'s, which the bench gates at 1e-2 worst
    lane).  Same ``(grad_step, (y0s, p_subs))`` as :func:`build_lv_adjoint`,
    every tensor float32; on the card every attempt launches the float32
    builds of the history-attempt kernel.  It runs on the card unless
    ``device="cpu"``; without a card the default raises."""
    device = device_or_raise(device)
    solve = make_batched_solve_fn(
        lv_problem(),
        derivatives="adjoint",
        options=BDFOptions(rtol=1e-6, atol=1e-6, adams_max_order=6),
        adjoint_options=BDFOptions(rtol=1e-5, atol=1e-5, adams_max_order=6),
        method="ADAMS",
        adjoint_interpolation="transition",
    )
    return _lv_grad_step(solve, batch, tvals_n, device, torch.float32,
                         inputs=lv_adjoint_inputs(batch))


def _lv_grad_step(solve, batch: int, tvals_n: int, device, dtype=torch.float64, inputs=None):
    f_kw = dict(dtype=dtype, device=device)
    tvals = torch.as_tensor(np.linspace(1.0, 10.0, tvals_n), **f_kw)
    p_fix = torch.as_tensor(LV_P_FIX, **f_kw)

    def grad_step(y0s, p_subs, tvals=tvals):
        """Gradients of sum(ys**2) over the observation times ``tvals``
        (by default the step's own, ``grad_step.tvals``)."""
        y0s = y0s.detach().requires_grad_(True)
        p_subs = p_subs.detach().requires_grad_(True)
        ys = solve(0.0, y0s, p_subs, p_fix, tvals)
        return torch.autograd.grad(torch.sum(ys**2), (y0s, p_subs))

    grad_step.solve = solve
    grad_step.tvals = tvals
    grad_step.p_fix = p_fix

    if inputs is None:
        rng = np.random.default_rng(0)
        inputs = (np.array([10.0, 2.0]) * (1 + 0.1 * rng.standard_normal((batch, 2))),
                  np.array([1.0, 0.3]) * (1 + 0.1 * rng.standard_normal((batch, 2))))
    y0s, p_subs = inputs
    return grad_step, (torch.as_tensor(y0s, **f_kw), torch.as_tensor(p_subs, **f_kw))


def lv_sens_inputs(batch: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(y0s (B, 2), ps (B, 4), tvals (21,))`` of ``bench.py``'s ``lv_sens``:
    a 5% spread around (10, 2) and (1, 0.3, 1, 0.4) from ``default_rng(42)``,
    lanes 0-15 those of a 16-lane draw, which are
    ``tests/golden/lv_sens.npz``'s, as the bench sets them; 21 observation
    times on [0, 10]."""

    def draw(B):
        rng = np.random.default_rng(42)
        y0s = np.array([10.0, 2.0]) * (1 + 0.05 * rng.standard_normal((B, 2)))
        ps = np.array([1.0, 0.3, 1.0, 0.4]) * (1 + 0.05 * rng.standard_normal((B, 4)))
        return y0s, ps

    y0s, ps = draw(batch)
    m = min(batch, 16)
    head = draw(16)
    y0s[:m], ps[:m] = head[0][:m], head[1][:m]
    return y0s, ps, np.linspace(0.0, 10.0, 21)


# (method, mode) of build_lv_sens
LV_SENS_MODES = (("BDF", "staggered"), ("ADAMS", "staggered"), ("ADAMS", "simultaneous"))


def build_lv_sens(batch: int, method: str, mode: str, device="cuda"):
    """``(solve, (y0s, ps, tvals))``: ``solve(y0s, ps, tvals)`` is one batched
    solve of the Lotka-Volterra chains of :func:`lv_sens_inputs` with
    forward sensitivities to alpha and beta from S0 = 0, a ``BDFResult``
    with ``ys (B, n_t, 2)`` and ``sens (B, n_t, 2, 2)``.  ``(method, mode)``
    is one of :data:`LV_SENS_MODES`: 'staggered' (CVODES's ``CV_STAGGERED``)
    on the BDF or the Adams core at rtol = atol = 1e-9, the options of
    ``tests/golden/lv_sens.npz``; or 'simultaneous' on the Adams core as the
    augmented state ``[y | vec S]`` with its own right-hand side, at
    ``bench.py``'s rtol = atol = 1e-8.  The Adams
    core runs at ``adams_max_order=6``, the bench's.  On the card every
    Adams attempt runs the history-attempt kernel: the forward and
    'staged_sensitivity' systems staggered, the 'sensitivity' system
    simultaneous.  It runs on the card unless ``device="cpu"``; without a
    card the default raises."""
    device = device_or_raise(device)
    if (method, mode) not in LV_SENS_MODES:
        raise ValueError(f"(method, mode) must be one of {LV_SENS_MODES}, got {(method, mode)}")
    rtol = 1e-8 if mode == "simultaneous" else 1e-9
    problem = lv_problem()
    systems = make_batched_solve_fn(problem, derivatives=None, method=method)
    rhs, sens_rhs = problem.make_rhs(), problem.make_sensitivity_rhs()
    n, k = problem.n_states, problem.n_params
    f64 = dict(dtype=torch.float64, device=device)

    if mode == "simultaneous":
        opts = BDFOptions(rtol=rtol, atol=rtol, adams_max_order=6)
        aug = systems.device_system("sensitivity", device)

        def rhs_aug(t, z, p):
            y, S = z[:n], z[n:].reshape((k, n) + tuple(z.shape[1:]))
            return torch.cat([rhs(t, y, p), sens_rhs(t, y, S, p).reshape((k * n,) + S.shape[2:])])

        def solve(y0s, ps, tvals):
            B = y0s.shape[0]
            z0 = torch.cat([y0s, torch.zeros((B, k * n), **f64)], dim=1)
            res = adams_solve_batched(rhs_aug, 0.0, z0, ps, tvals, opts, batched_fns=True,
                                      device_system=aug)
            zs = res.ys
            return res._replace(ys=zs[:, :, :n], sens=zs[:, :, n:].reshape(B, -1, k, n))
    else:
        opts = BDFOptions(rtol=rtol, atol=rtol, sens_staggered=True, adams_max_order=6)

        def solve(y0s, ps, tvals):
            S0 = torch.zeros((y0s.shape[0], k, n), **f64)
            if method == "BDF":
                return bdf_solve_batched(rhs, problem.make_jac_dense(), 0.0, y0s, ps, tvals, opts,
                                         sens_rhs=sens_rhs, S0=S0, batched_fns=True)
            return adams_solve_batched(
                rhs, 0.0, y0s, ps, tvals, opts, sens_rhs=sens_rhs, sens0=S0, batched_fns=True,
                device_system=systems.device_system("forward", device),
                sens_device_system=systems.device_system("staged_sensitivity", device),
            )

    solve.options = opts
    y0s, ps, tvals = lv_sens_inputs(batch)
    return solve, tuple(torch.as_tensor(a, **f64) for a in (y0s, ps, tvals))


LV_ROOT_CAP = 8  # roots a lane records when the solve goes on past them
LV_ADJOINT_BATCH = 10_000  # the lanes of bench.py's lv_adjoint draw


def lv_adjoint_inputs(batch: int) -> tuple[np.ndarray, np.ndarray]:
    """``(y0s (B, 2), p_subs (B, 2))``: ``bench.py``'s ``lv_adjoint`` chains,
    a 5% spread around (10, 2) and (alpha, beta) = (1, 0.3) from
    ``default_rng(42)``.  Lanes 0-15 are those of the bench's draw of
    :data:`LV_ADJOINT_BATCH` lanes at every batch, which are
    ``tests/golden/lv_adjoint.npz``'s (the parameters are drawn after every
    lane's initial state, so a draw of another width gives these lanes
    other parameters)."""

    def draw(B):
        rng = np.random.default_rng(42)
        y0s = np.array([10.0, 2.0]) * (1 + 0.05 * rng.standard_normal((B, 2)))
        p_subs = np.array([1.0, 0.3]) * (1 + 0.05 * rng.standard_normal((B, 2)))
        return y0s, p_subs

    y0s, p_subs = draw(batch)
    m = min(batch, 16)
    head = draw(LV_ADJOINT_BATCH)
    y0s[:m], p_subs[:m] = head[0][:m], head[1][:m]
    return y0s, p_subs


def lv_root_inputs(batch: int) -> tuple[np.ndarray, np.ndarray]:
    """``(y0s (B, 2), ps (B, 4))``: the chains of :func:`lv_adjoint_inputs`
    with (gamma, delta) = :data:`LV_P_FIX`."""
    y0s, p_subs = lv_adjoint_inputs(batch)
    return y0s, np.concatenate([p_subs, np.tile(LV_P_FIX, (batch, 1))], axis=1)


def _hares_at_9(t, y, p):
    return [y.hares - 9.0]


def build_lv_roots(batch: int, method: str, terminal: bool, device="cuda"):
    """``(solve, (y0s, ps, tvals))``: ``solve(y0s, ps, tvals,
    root_directions=None)`` is one batched solve of the chains of
    :func:`lv_root_inputs` with the event ``hares - 9`` (the JAX package's
    ``tests/test_rootfinding.py``), ``method`` 'BDF' or 'ADAMS', rtol =
    atol = 1e-8, 21 observation times on [0, 10]: with ``terminal`` each lane
    stops at its first root (status 5); else up to :data:`LV_ROOT_CAP` roots
    a lane are recorded (``root_directions`` [-1] keeps the falling ones).
    The roots are in the result's ``stats`` (``roots_t``, ``roots_y``,
    ``roots_found``, ``n_roots``).  The Adams core runs at
    ``adams_max_order=6`` through the history-attempt kernel on the card.
    It runs on the card unless ``device="cpu"``; without a card the default
    raises."""
    device = device_or_raise(device)
    if method not in ("BDF", "ADAMS"):
        raise ValueError(f"method must be 'BDF' or 'ADAMS', got {method!r}")
    problem = lv_problem()
    systems = make_batched_solve_fn(problem, derivatives=None, method=method)
    rhs, root_fn = problem.make_rhs(), problem.make_root_fn(_hares_at_9)
    opts = BDFOptions(rtol=1e-8, atol=1e-8, adams_max_order=6)
    kw = dict(root_fn=root_fn, root_cap=LV_ROOT_CAP, root_terminal=terminal, batched_fns=True)

    def solve(y0s, ps, tvals, root_directions=None):
        if method == "BDF":
            return bdf_solve_batched(rhs, problem.make_jac_dense(), 0.0, y0s, ps, tvals, opts,
                                     root_directions=root_directions, **kw)
        return adams_solve_batched(rhs, 0.0, y0s, ps, tvals, opts,
                                   device_system=systems.device_system("forward", device),
                                   root_directions=root_directions, **kw)

    solve.options = opts
    f64 = dict(dtype=torch.float64, device=device)
    y0s, ps = lv_root_inputs(batch)
    tvals = np.linspace(0.0, 10.0, 21)
    return solve, tuple(torch.as_tensor(a, **f64) for a in (y0s, ps, tvals))


LV_PER_LANE_TIMES = (6, 21)  # the fewest and most observation times of a lane


def lv_per_lane_tvals(batch: int, seed: int = 0) -> np.ndarray:
    """``(B, 21)`` seeded ragged observation grids: lane b has 6 to 21
    sorted times uniform on [0.5, 10] (``default_rng(seed)``), padded to 21
    with copies of its last time, the reference's convention for a ragged
    dataset (``tests/test_per_lane_tvals.py``)."""
    lo, hi = LV_PER_LANE_TIMES
    rng = np.random.default_rng(seed)
    counts = rng.integers(lo, hi + 1, batch)
    pad = np.arange(hi)[None, :] >= counts[:, None]
    # a lane's first `count` draws, sorted; the slots past them take its last
    times = np.sort(np.where(pad, np.inf, rng.uniform(0.5, 10.0, (batch, hi))), axis=1)
    last = times[np.arange(batch), counts - 1]
    return np.where(pad, last[:, None], times)


def build_lv_per_lane(batch: int, method: str, device="cuda"):
    """``(solve, (y0s, ps, tvals))``: ``solve(y0s, ps, tvals)`` is one batched
    forward solve of the chains of :func:`lv_root_inputs` (phase 4's), each
    lane on its own observation grid, ``tvals (B, 21)`` from
    :func:`lv_per_lane_tvals`, a ``BDFResult`` with ``ys (B, 21, 2)``; the
    padded slots repeat the lane's last value.  ``method`` 'ADAMS' (through
    the history-attempt kernel's forward build on the card) or 'BDF', at
    the main path's forward options (rtol = atol = 1e-8,
    ``adams_max_order=6``).  It runs on the card unless ``device="cpu"``;
    without a card the default raises."""
    device = device_or_raise(device)
    if method not in ("BDF", "ADAMS"):
        raise ValueError(f"method must be 'BDF' or 'ADAMS', got {method!r}")
    problem = lv_problem()
    systems = make_batched_solve_fn(problem, derivatives=None, method=method)
    rhs = problem.make_rhs()
    opts = lv_options(1e-8)[0]

    def solve(y0s, ps, tvals):
        if method == "BDF":
            return bdf_solve_batched(rhs, problem.make_jac_dense(), 0.0, y0s, ps, tvals, opts,
                                     batched_fns=True)
        return adams_solve_batched(rhs, 0.0, y0s, ps, tvals, opts, batched_fns=True,
                                   device_system=systems.device_system("forward", device))

    solve.options = opts
    f64 = dict(dtype=torch.float64, device=device)
    y0s, ps = lv_root_inputs(batch)
    return solve, tuple(torch.as_tensor(a, **f64) for a in (y0s, ps, lv_per_lane_tvals(batch)))


ROBERTSON_K = (0.04, 3e7, 1e4)  # k1, k2, k3


def _robertson(t, y, p):
    r1 = p.k1 * y.a
    r2 = p.k2 * y.b * y.b
    r3 = p.k3 * y.b * y.c
    return {"a": -r1 + r3, "b": r1 - r2 - r3, "c": r2}


def robertson_problem() -> SympyProblem:
    """Robertson's stiff kinetics (``bench.py:446-458``).  All three rates are
    derivative params, so that the batched solve takes them per lane
    (``p_sub (B, 3)``, an empty ``p_fix``); the right-hand side is the same."""
    return SympyProblem(
        params={"k1": (), "k2": (), "k3": ()},
        states={"a": (), "b": (), "c": ()},
        rhs_sympy=_robertson,
        derivative_params=[("k1",), ("k2",), ("k3",)],
    )


def robertson_options() -> BDFOptions:
    """rtol 1e-8, atol ``[1e-10, 1e-12, 1e-10]`` (``bench.py:466``)."""
    return BDFOptions(rtol=1e-8, atol=np.array([1e-10, 1e-12, 1e-10]))


def build_robertson(batch: int, device="cuda"):
    """``(solve, (y0s, p_subs, p_fix, tvals))``: ``solve(0.0, *inputs)`` is
    one batched BDF solve of ``bench.py``'s Robertson workload, ``ys (B, 8,
    3)`` with NaN on failed lanes; ``solve.last_stats['forward']`` holds its
    stats.  Inputs: ``y0 = [1, 0, 0]``, ``tvals = 4 * 10**k`` for k = -1..6,
    and rates ``ROBERTSON_K`` with a 2% spread from ``default_rng(42)``, so
    lanes 0-15 are those of ``tests/golden/robertson.npz``.  It runs on the
    card unless ``device="cpu"``; without a card the default raises."""
    device = device_or_raise(device)
    solve = make_batched_solve_fn(
        robertson_problem(), derivatives=None, options=robertson_options(), method="BDF"
    )
    f64 = dict(dtype=torch.float64, device=device)
    rng = np.random.default_rng(42)
    ps = np.array(ROBERTSON_K) * (1 + 0.02 * rng.standard_normal((batch, 3)))
    y0s = np.tile([1.0, 0.0, 0.0], (batch, 1))
    tvals = np.array([4.0 * 10.0**k for k in range(-1, 7)])
    return solve, (
        torch.as_tensor(y0s, **f64),
        torch.as_tensor(ps, **f64),
        torch.zeros((0,), **f64),
        torch.as_tensor(tvals, **f64),
    )


SIR_CHECKPOINTS = 1024  # checkpoint_n of scripts/bench_sir_scale.py


def _sir(t, y, p):
    i_eff = y.I + p.mix * (torch.roll(y.I, 1, 0) + torch.roll(y.I, -1, 0))
    inf = p.beta * y.S * i_eff
    rec = p.gamma * y.I
    return {"S": -inf, "I": inf - rec, "R": rec}


def sir_problem(R: int) -> TorchProblem:
    """SIR over ``R`` regions on a ring (``scripts/bench_sir_scale.py:48-59``):
    states S, I, R of shape (R,), params beta, gamma and the neighbour
    mixing ``mix``, derivatives with respect to beta and gamma."""
    return TorchProblem(
        params={"beta": (), "gamma": (), "mix": ()},
        states={"S": (R,), "I": (R,), "R": (R,)},
        rhs=_sir,
        derivative_params=[("beta",), ("gamma",)],
    )


def sir_inputs(R: int, batch: int) -> tuple[np.ndarray, np.ndarray]:
    """``(y0s (B, 3R), p_subs (B, 2))`` drawn as ``scripts/bench_sir_scale.py:98-122``
    draws them (``default_rng(0)``).  That script then sets lane 0 to its
    golden case's inputs; a caller that checks lane 0 against a golden file
    sets it itself."""
    rng = np.random.default_rng(0)
    S0 = 0.99 + 0.005 * rng.standard_normal((batch, R))
    I0 = 0.01 * np.abs(1 + 0.1 * rng.standard_normal((batch, R)))
    y0s = np.concatenate([S0, I0, np.zeros((batch, R))], axis=1)
    p_subs = np.stack(
        [0.4 * (1 + 0.05 * rng.standard_normal(batch)),
         0.15 * (1 + 0.05 * rng.standard_normal(batch))],
        axis=1,
    )
    return y0s, p_subs


def sir_options(dtype=torch.float64) -> tuple[BDFOptions, BDFOptions]:
    """(forward, backward) options of :func:`build_sir`: rtol 1e-8 / atol
    1e-10 both ways at float64 (``scripts/bench_sir_scale.py``); at float32
    ``bench.py``'s float32 tolerances, rtol 1e-6 forward and 1e-5 backward,
    at the configuration's atol / rtol ratio of 1e-2."""
    if dtype == torch.float64:
        opts = BDFOptions(rtol=1e-8, atol=1e-10)
        return opts, opts
    if dtype == torch.float32:
        return BDFOptions(rtol=1e-6, atol=1e-8), BDFOptions(rtol=1e-5, atol=1e-7)
    raise ValueError(f"dtype must be torch.float64 or torch.float32, got {dtype}")


def build_sir(R: int, batch: int, mode: str, device="cuda", dtype=torch.float64):
    """``(grad_step, (y0s, p_subs))`` for ``scripts/bench_sir_scale.py``'s
    configuration: ``grad_step(y0s, p_subs) -> (ys, gp)`` is one batched
    solve and the gradient of ``sum(ys[:, :, R:2R]**2)`` with respect to
    ``p_subs`` (beta, gamma), ``ys (B, 12, 3R)`` detached.  Twelve
    observation times ``linspace(5, 60, 12)``, ``mix = 0.05``, ADAMS with
    :func:`sir_options` at ``dtype`` (float64: rtol 1e-8 / atol 1e-10
    forward and backward), ``checkpoint_n=1024``, ``mode`` 'resolve' or
    'hermite'; inputs from :func:`sir_inputs`, every tensor at ``dtype``.
    It runs on the card unless ``device="cpu"``; without a card the default
    raises."""
    device = device_or_raise(device)
    if mode not in ("resolve", "hermite"):
        raise ValueError(f"mode must be 'resolve' or 'hermite', got {mode!r}")
    fwd_opts, adj_opts = sir_options(dtype)
    solve = make_batched_solve_fn(
        sir_problem(R), options=fwd_opts, adjoint_options=adj_opts,
        checkpoint_n=SIR_CHECKPOINTS, method="ADAMS", adjoint_interpolation=mode,
    )
    f_kw = dict(dtype=dtype, device=device)
    tvals = torch.as_tensor(np.linspace(5.0, 60.0, 12), **f_kw)
    p_fix = torch.as_tensor([0.05], **f_kw)

    def grad_step(y0s, p_subs):
        p_subs = p_subs.detach().requires_grad_(True)
        ys = solve(0.0, y0s, p_subs, p_fix, tvals)
        (gp,) = torch.autograd.grad(torch.sum(ys[:, :, R : 2 * R] ** 2), (p_subs,))
        return ys.detach(), gp

    grad_step.solve = solve
    grad_step.tvals = tvals
    grad_step.p_fix = p_fix
    y0s, p_subs = sir_inputs(R, batch)
    return grad_step, (torch.as_tensor(y0s, **f_kw), torch.as_tensor(p_subs, **f_kw))


def build_sir_state_split(R: int, batch: int, mode: str, mesh):
    """:func:`build_sir` on a 2-D (chains x state) ``mesh``
    (:class:`~sunode_torch.parallel.mesh.Mesh`, ``make_mesh_2d`` on cards):
    ``(grad_step, (y0s, p_subs))``, the inputs on the mesh's first device.
    ``grad_step(y0s, p_subs)`` cuts ``y0s`` into the mesh's blocks
    (``shard_batch_state``: each chain group's rows over its row of the
    mesh), solves each group with the state split (its home device runs
    the host loop and the right-hand side, every device keeps and updates
    its block of rows) and returns ``ys`` and the gradient of
    ``sum(ys[:, :, R:2R]**2)`` with respect to ``p_subs`` on the first
    device.  The configuration is :func:`build_sir`'s at float64, ``mode``
    'resolve', 'hermite' or 'polynomial'; ``batch`` and ``3 R`` must divide
    evenly over the mesh."""
    from sunode_torch.parallel.mesh import shard_batch_state

    for d in mesh.devices:
        device_or_raise(d)
    if mode not in ("resolve", "hermite", "polynomial"):
        raise ValueError(f"mode must be 'resolve', 'hermite' or 'polynomial', got {mode!r}")
    fwd_opts, adj_opts = sir_options()
    solve = make_batched_solve_fn(
        sir_problem(R), options=fwd_opts, adjoint_options=adj_opts,
        checkpoint_n=SIR_CHECKPOINTS, method="ADAMS", adjoint_interpolation=mode,
    )
    f_kw = dict(dtype=torch.float64, device=mesh.devices[0])
    tvals = torch.as_tensor(np.linspace(5.0, 60.0, 12), **f_kw)
    p_fix = torch.as_tensor([0.05], **f_kw)

    def grad_step(y0s, p_subs, tvals=tvals):
        p_subs = p_subs.detach().requires_grad_(True)
        ys = solve(0.0, shard_batch_state(mesh, y0s), p_subs, p_fix, tvals)
        (gp,) = torch.autograd.grad(torch.sum(ys[:, :, R : 2 * R] ** 2), (p_subs,))
        return ys.detach(), gp

    grad_step.solve, grad_step.tvals, grad_step.p_fix, grad_step.mesh = solve, tvals, p_fix, mesh
    y0s, p_subs = sir_inputs(R, batch)
    return grad_step, (torch.as_tensor(y0s, **f_kw), torch.as_tensor(p_subs, **f_kw))


# ---- structured Newton: Fisher-KPP, the hub, and a spline input ------------------
KPP_RTOL, KPP_ATOL = 1e-8, 1e-10  # scripts/bench_batched_structured.py's
STRUCTURED_CHECKPOINTS = 1024  # its checkpoint_n


def _kpp(t, y, p):
    u = y.u
    zero = torch.zeros(1, dtype=u.dtype, device=u.device)
    lap = torch.cat([u[1:2] - u[0:1], u[2:] - u[1:-1], u[-2:-1] - u[-1:]])
    lap2 = torch.cat([zero, u[:-2] - u[1:-1], zero])
    return {"u": p.D * (lap + lap2) + p.r * u * (1.0 - u)}


def kpp_problem(n: int) -> TorchProblem:
    """The Fisher-KPP chain of n nodes: ``du/dt = D lap(u) + r u (1 - u)``
    with reflecting ends, derivatives with respect to D and r."""
    return TorchProblem(
        params={"D": (), "r": ()}, states={"u": (n,)}, rhs=_kpp,
        derivative_params=[("D",), ("r",)],
    )


def kpp_inputs(n: int, batch: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(y0 (B, n), params (B, 2), tvals (8,))`` as
    ``scripts/bench_batched_structured.py:68-75`` draws them from
    ``default_rng(0)``: D around ``0.25 n^2 / 64``, r around 1, t in [0.05, 1]."""
    rng = np.random.default_rng(0)
    y0 = 0.5 + 0.3 * rng.random((batch, n))
    d_scale = 0.25 * n * n / 64.0
    params = np.stack(
        [d_scale * (1 + 0.2 * rng.random(batch)), 1.0 + 0.1 * rng.random(batch)], axis=1
    )
    return y0, params, np.linspace(0.05, 1.0, 8)


def _structured_run(problem, linear_solver, p_fix, tvals, device, linear_solver_kwargs=None):
    """``(forward, grad_step)`` of one structured workload at rtol 1e-8 /
    atol 1e-10: ``forward(y0, p) -> ys`` (no gradient, failed lanes NaN;
    ``forward.last_stats`` the solve's stats) and ``grad_step(y0, p) -> (gy,
    gp)``, the gradients of ``sum(ys**2)`` (``grad_step.solve.last_stats``),
    through ``make_batched_solve_fn(method='BDF', checkpoint_n=1024)``; both
    take other observation times as ``tvals=``.  spgmr, which that wrapper
    refuses as the reference does, has the forward only, through
    ``bdf_solve_batched``."""
    f_kw = dict(dtype=torch.float64, device=device)
    tvals = torch.as_tensor(tvals, **f_kw)
    p_fix = torch.as_tensor(p_fix, **f_kw)
    options = BDFOptions(rtol=KPP_RTOL, atol=KPP_ATOL)
    if linear_solver == "spgmr":
        rhs = problem.make_rhs()
        options = options._replace(linear_solver="spgmr")

        def forward(y0, p, tvals=tvals):
            full = problem.params.combine(p, torch.broadcast_to(p_fix, (p.shape[0],) + p_fix.shape))
            res = bdf_solve_batched(rhs, None, 0.0, y0, full, tvals, options, batched_fns=True)
            forward.last_stats = res.stats
            return torch.where((res.status == 0)[:, None, None], res.ys, float("nan"))

        return forward, None
    solve = make_batched_solve_fn(
        problem, options=options, checkpoint_n=STRUCTURED_CHECKPOINTS,
        linear_solver=linear_solver, linear_solver_kwargs=linear_solver_kwargs,
    )

    def forward(y0, p, tvals=tvals):
        with torch.no_grad():
            ys = solve(0.0, y0, p, p_fix, tvals)
        forward.last_stats = solve.last_stats["forward"]
        return ys

    def grad_step(y0, p, tvals=tvals):
        y0 = y0.detach().requires_grad_(True)
        p = p.detach().requires_grad_(True)
        ys = solve(0.0, y0, p, p_fix, tvals)
        return torch.autograd.grad(torch.sum(ys**2), (y0, p))

    grad_step.solve = solve
    return forward, grad_step


def _tensors(device, *arrays):
    return tuple(torch.as_tensor(a, dtype=torch.float64, device=device) for a in arrays)


def build_kpp(n: int, batch: int, linear_solver: str = "band", device="cuda"):
    """``(forward, grad_step, (y0, params, tvals))`` of the Fisher-KPP chain
    (:func:`kpp_problem`, :func:`kpp_inputs`; ``tvals`` numpy):
    ``linear_solver`` 'band' (bandwidths 1 and 1), 'sparse', 'dense' or
    'spgmr' (forward only, ``grad_step`` None).  It runs on the card unless
    ``device="cpu"``; without a card the default raises."""
    device = device_or_raise(device)
    y0, params, tvals = kpp_inputs(n, batch)
    kw = dict(lower_bandwidth=1, upper_bandwidth=1) if linear_solver == "band" else None
    forward, grad_step = _structured_run(kpp_problem(n), linear_solver, [], tvals, device, kw)
    return forward, grad_step, (*_tensors(device, y0, params), tvals)


def build_kpp_single(n: int, linear_solver: str = "band", device="cuda"):
    """``(forward, grad_step, (y0 (n,), params (2,), tvals))``: one Fisher-KPP
    chain (:func:`kpp_problem`, lane 0 of :func:`kpp_inputs`; ``tvals``
    numpy) through ``make_solve_fn`` at rtol 1e-8 / atol 1e-10 with
    ``linear_solver`` 'band' (bandwidths 1 and 1), 'sparse' or 'dense':
    ``forward(y0, p) -> ys`` (no gradient, NaN on failure) and
    ``grad_step(y0, p) -> (gy, gp)``, the gradients of ``sum(ys**2)``;
    ``forward.solve`` and ``grad_step.solve`` are the solve, whose
    ``last_stats`` carry the Newton solver's ``n_linear_factors`` and
    ``n_linear_solves``.  It runs on the card unless ``device="cpu"``;
    without a card the default raises."""
    device = device_or_raise(device)
    y0, params, tvals = kpp_inputs(n, 1)
    kw = dict(lower_bandwidth=1, upper_bandwidth=1) if linear_solver == "band" else None
    solve = make_solve_fn(kpp_problem(n), options=BDFOptions(rtol=KPP_RTOL, atol=KPP_ATOL),
                          linear_solver=linear_solver, linear_solver_kwargs=kw)
    f_kw = dict(dtype=torch.float64, device=device)
    tv = torch.as_tensor(tvals, **f_kw)
    p_fix = torch.zeros((0,), **f_kw)

    def forward(y0, p):
        with torch.no_grad():
            return solve(0.0, y0, p, p_fix, tv)

    def grad_step(y0, p):
        y0 = y0.detach().requires_grad_(True)
        p = p.detach().requires_grad_(True)
        ys = solve(0.0, y0, p, p_fix, tv)
        return torch.autograd.grad(torch.sum(ys**2), (y0, p))

    forward.solve = grad_step.solve = solve
    return forward, grad_step, (*_tensors(device, y0[0], params[0]), tvals)


HUB_P_FIX = (30.0, 0.5)  # a, c: the hub's relaxation rate and its coupling


def _hub(t, y, p):
    u = y.u
    zero = torch.zeros(1, dtype=u.dtype, device=u.device)
    lap = torch.cat([u[1:2] - u[0:1], u[2:] - u[1:-1], u[-2:-1] - u[-1:]])
    lap2 = torch.cat([zero, u[:-2] - u[1:-1], zero])
    du = p.D * (lap + lap2) - u * (u - 1.0) + p.c * y.h
    dh = -p.a * y.h + p.b * torch.mean(u)
    return {"u": du, "h": dh}


def hub_problem(n: int) -> TorchProblem:
    """``tests/test_bbd.py:31-53``'s hub problem: a diffusion chain of n
    nodes and one hub state coupled to every node (n + 1 states, an
    arrowhead Jacobian), derivatives with respect to D and b."""
    return TorchProblem(
        params={"D": (), "a": (), "b": (), "c": ()}, states={"u": (n,), "h": ()}, rhs=_hub,
        derivative_params=[("D",), ("b",)],
    )


def hub_inputs(n: int, batch: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(y0 (B, n+1), p_sub (B, 2), tvals (6,))``: ``tests/test_bbd.py``'s
    draws (``_hub_inputs``, ``default_rng(2)``) of the initial chain, hub
    and the per-lane (D, b); (a, c) is :data:`HUB_P_FIX` for every lane."""
    rng = np.random.default_rng(2)
    y0 = np.concatenate([0.4 + 0.3 * rng.random((batch, n)), 0.1 * rng.random((batch, 1))], axis=1)
    params = np.stack(
        [
            40.0 * (1 + 0.2 * rng.random(batch)),  # D
            30.0 * (1 + 0.1 * rng.random(batch)),  # a (drawn, as the test draws it)
            2.0 + 0.2 * rng.random(batch),  # b
            0.5 + 0.1 * rng.random(batch),  # c
        ],
        axis=1,
    )
    return y0, params[:, [0, 2]], np.linspace(0.05, 1.0, 6)


def build_hub(n: int, batch: int, linear_solver: str = "sparse", device="cuda"):
    """``(forward, grad_step, (y0, p_sub, tvals))`` of the hub problem
    (:func:`hub_problem`, :func:`hub_inputs`; ``tvals`` numpy) with
    ``linear_solver`` 'sparse' (the exact pattern by probing, the plan's
    border 'auto', which takes the hub) or 'dense', as :func:`build_kpp`.
    It runs on the card unless ``device="cpu"``; without a card the default
    raises."""
    device = device_or_raise(device)
    y0, p_sub, tvals = hub_inputs(n, batch)
    forward, grad_step = _structured_run(hub_problem(n), linear_solver, HUB_P_FIX, tvals, device)
    return forward, grad_step, (*_tensors(device, y0, p_sub), tvals)


LV_SPLINE_K = 6  # spline values of the prey birth rate
LV_SPLINE_HORIZON = (0.0, 10.0)  # the span the spline covers: the solve's


def _lv_spline(t, y, p):
    alpha = interpolate_spline(t, list(p.alpha), *LV_SPLINE_HORIZON, 3)
    return {
        "hares": alpha * y.hares - p.beta * y.lynx * y.hares,
        "lynx": p.delta * y.hares * y.lynx - p.gamma * y.lynx,
    }


def lv_spline_problem() -> SympyProblem:
    """Lotka-Volterra with the prey birth rate a cubic spline of t over
    [0, 10] through :data:`LV_SPLINE_K` values, which are parameters
    (derivatives with respect to them and beta)."""
    return SympyProblem(
        params={"alpha": (LV_SPLINE_K,), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()},
        rhs_sympy=_lv_spline,
        derivative_params=[("alpha",), ("beta",)],
    )


def build_lv_spline(batch: int, tvals_n: int = 21, rtol: float = 1e-8, device="cuda"):
    """:func:`build_lv_adjoint` on :func:`lv_spline_problem`: the Adams
    forward solve and transition-adjoint gradients of ``sum(ys**2)``, with
    :func:`lv_options`; ``(grad_step, (y0s, p_subs))``, p_subs the spline's
    values around 1 (5% seeded spread a value) and beta as
    :func:`lv_adjoint_inputs` draws it.  It runs on the card unless
    ``device="cpu"``; without a card the default raises."""
    device = device_or_raise(device)
    fwd_opts, adj_opts = lv_options(rtol)
    solve = make_batched_solve_fn(
        lv_spline_problem(), derivatives="adjoint", options=fwd_opts,
        adjoint_options=adj_opts, method="ADAMS", adjoint_interpolation="transition",
    )
    y0s, p_lv = lv_adjoint_inputs(batch)
    rng = np.random.default_rng(7)
    alpha = p_lv[:, :1] * (1 + 0.05 * rng.standard_normal((batch, LV_SPLINE_K)))
    return _lv_grad_step(solve, batch, tvals_n, device,
                         inputs=(y0s, np.concatenate([alpha, p_lv[:, 1:]], axis=1)))


# ---- the class API and events -----------------------------------------------------
LV_FORWARD_TIMES = 50  # bench.py's lv_forward: 50 times on [0, 10]


def lv_forward_inputs(batch: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(y0s (B, 2), ps (B, 4), tvals (50,))`` of ``bench.py``'s batched
    ``lv_forward`` (``bench.py:279-285``): ``default_rng(42)``, y0 then p,
    a 5% spread around (10, 2) and (1, 0.3, 1, 0.4); lanes 0-15 those of a
    16-lane draw, ``tests/golden/lv_forward.npz``'s own; 50 times on [0, 10]."""

    def draw(B):
        rng = np.random.default_rng(42)
        y0s = np.array([10.0, 2.0]) * (1 + 0.05 * rng.standard_normal((B, 2)))
        ps = np.array([1.0, 0.3, 1.0, 0.4]) * (1 + 0.05 * rng.standard_normal((B, 4)))
        return y0s, ps

    y0s, ps = draw(batch)
    m = min(batch, 16)
    head = draw(16)
    y0s[:m], ps[:m] = head[0][:m], head[1][:m]
    return y0s, ps, np.linspace(0.0, 10.0, LV_FORWARD_TIMES)


def build_lv_forward(batch: int, device="cuda"):
    """``(solve, (y0s, ps, tvals))``: ``bench.py``'s ``lv_forward`` through
    the class API.  ``solve(y0s, ps, tvals) -> ys (B, n_t, 2)`` (numpy) sets
    the per-lane params ``ps (B, 4)`` on ``Solver(lv_problem(),
    solver='ADAMS', reltol=1e-10, abstol=1e-10)`` and solves the chains
    batched from t = 0; ``solve.solver`` is the solver, whose
    ``last_stats`` holds the solve's statistics.  On the card every
    attempt runs the history-attempt kernel's forward system at the
    default Adams order cap (8: history depth 11).  It runs on the card
    unless ``device="cpu"``; without a card the default raises."""
    solver = Solver(lv_problem(), solver="ADAMS", reltol=1e-10, abstol=1e-10, device=device)

    def solve(y0s, ps, tvals):
        solver.set_params(ps)
        return solver.solve(0.0, tvals, y0s)

    solve.solver = solver
    return solve, lv_forward_inputs(batch)


BALL_OPTIONS = BDFOptions(rtol=1e-10, atol=1e-12)  # the ball tests' OPTS
BALL_H, BALL_G = 2.0, 9.81  # tests/test_event_grads.py's drop height and gravity


def _ball_roots(t, y, p):
    return [y.x]


def build_ball_event(derivatives: str = "forward", device="cuda"):
    """``(event, (y0, p_sub, p_fix, t_max))``: ``tests/test_event_grads.py``'s
    ball, x'' = -g dropped from h0 = 2 (a ``SympyProblem``, the gradient to
    g), through ``make_event_fn`` with the event ``x = 0``, the tests'
    tolerances (rtol 1e-10, atol 1e-12) and ``derivatives`` 'forward' or
    'adjoint'; ``event(0.0, y0, p_sub, p_fix, t_max) -> (t*, y(t*))``.  It
    runs on the card unless ``device="cpu"``; without a card the default
    raises."""
    dev = device_or_raise(device)
    ball = SympyProblem(
        params={"g": ()}, states={"x": (), "v": ()},
        rhs_sympy=lambda t, y, p: {"x": y.v, "v": -p.g}, derivative_params=[("g",)],
    )
    event = make_event_fn(ball, _ball_roots, options=BALL_OPTIONS, derivatives=derivatives,
                          device=dev)
    f_kw = dict(dtype=torch.float64, device=dev)
    return event, (torch.tensor([BALL_H, 0.0], **f_kw), torch.tensor([BALL_G], **f_kw),
                   torch.zeros(0, **f_kw), 3.0)


def ball_hybrid_problem() -> TorchProblem:
    """``tests/test_hybrid_events.py``'s ball: h'' = -g, the restitution e
    entering only through the jump."""
    return TorchProblem(
        params={"g": (), "e": ()}, states={"h": (), "v": ()},
        rhs=lambda t, y, p: {"h": y.v, "v": -p.g}, derivative_params=[("g",), ("e",)],
    )


def build_ball_hybrid(max_events: int = 3, derivatives="forward", device="cuda"):
    """``(hybrid, (y0, p_sub, p_fix, tvals))``: ``tests/test_hybrid_events.py``'s
    bouncing ball through ``make_hybrid_solve_fn``: the event ``h = 0``
    falling only, the jump ``(h, v) -> (h, -e v)``, ``max_events`` impacts,
    the tests' tolerances, ``derivatives`` 'forward' (the reference's
    default), 'adjoint' or None (values only); the inputs of its
    final-state gradient case (h0 = 1, g = 9.81, e = 0.8, four times on
    [0, 2.2], three impacts).  It runs on the card unless ``device="cpu"``;
    without a card the default raises."""
    dev = device_or_raise(device)
    hybrid = make_hybrid_solve_fn(
        ball_hybrid_problem(), roots=lambda t, y, p: torch.stack([y.h]),
        jump_fn=lambda t, y, p: {"h": y.h, "v": -p.e * y.v}, max_events=max_events,
        root_directions=[-1], options=BALL_OPTIONS, derivatives=derivatives, device=dev,
    )
    f_kw = dict(dtype=torch.float64, device=dev)
    return hybrid, (torch.tensor([1.0, 0.0], **f_kw), torch.tensor([BALL_G, 0.8], **f_kw),
                    torch.zeros(0, **f_kw), torch.linspace(0.0, 2.2, 4, **f_kw))


# ---- the sampler: BASELINE config 4 ------------------------------------------------
LV_NUTS_TIMES = np.linspace(1.0, 10.0, 12)  # scripts/exp_nuts_f32.py's observation times
LV_NUTS_SIGMA = 0.1  # its observation noise
LV_NUTS_TRUE = (1.0, 0.3)  # alpha, beta of its synthetic data, and its prior's centre


def lv_nuts_observations(tvals=LV_NUTS_TIMES) -> np.ndarray:
    """``log y(tvals) + sigma N(0, 1)`` ``(n_t, 2)``: the script's synthetic
    data (:118-140), y from alpha 1.0, beta 0.3, y0 (10, 2) solved by ADAMS
    at rtol = atol 1e-10 (order 6) on the CPU, the noise from
    ``default_rng(0)``; the same data on every device."""
    solve = make_batched_solve_fn(
        lv_problem(), derivatives=None, method="ADAMS",
        options=BDFOptions(rtol=1e-10, atol=1e-10, adams_max_order=6),
    )
    f64 = dict(dtype=torch.float64)
    ys = solve(0.0, torch.tensor([[10.0, 2.0]], **f64), torch.tensor([LV_NUTS_TRUE], **f64),
               torch.tensor(LV_P_FIX, **f64), torch.as_tensor(np.asarray(tvals), **f64))[0]
    rng = np.random.default_rng(0)
    return np.log(ys.numpy()) + LV_NUTS_SIGMA * rng.standard_normal(tuple(ys.shape))


def lv_nuts_init(chains: int, scale: float = 0.3, seed: int = 0) -> np.ndarray:
    """``log(alpha, beta) (chains, 2)``: the prior's centre plus ``scale``
    N(0, 1) from ``default_rng(seed)``; the first rows of a wide draw are a
    narrow draw's."""
    rng = np.random.default_rng(seed)
    return np.log(np.asarray(LV_NUTS_TRUE))[None, :] + scale * rng.standard_normal((chains, 2))


def build_lv_nuts(chains: int, device="cuda", tvals=LV_NUTS_TIMES, rtol: float = 1e-8,
                  adjoint_rtol: float = 1e-7):
    """``(logp_fn, (init, mu0))``: BASELINE config 4, the Lotka-Volterra
    posterior of ``scripts/exp_nuts_f32.py`` (float64; ``tvals``, ``rtol``
    and ``adjoint_rtol`` at its settings by default).  ``logp_fn(theta)``
    takes ``theta (C, 2)`` = log(alpha, beta) on ``device`` and returns the
    log density ``(C,)``: the Gaussian log likelihood (sigma 0.1) of the
    log observations :func:`lv_nuts_observations` under the batched ADAMS
    solve with the transition adjoint (y0 (10, 2), gamma, delta = 1.0, 0.4)
    plus a unit-normal prior around
    ``mu0 = log(1.0, 0.3)``; a non-finite value (a failed solve NaN-poisons)
    becomes ``-inf``, which the sampler takes as a divergent leaf.  Its
    gradient through ``torch.autograd`` is one batched forward and one
    backward solve for all chains.  ``init`` is ``lv_nuts_init(chains)``
    (the script's spread of 0.3); ``logp_fn.solve`` is the solver, whose
    ``last_stats`` report the latest gradient's attempts.  It runs on the
    card unless ``device="cpu"``; without a card the default raises."""
    device = device_or_raise(device)
    # the script's options (:47-66): Adams order 6, rtol = atol, max_steps
    # 2,000 forward and 4,000 backward, so that a doomed solve in early
    # warmup dies in milliseconds and NaN-poisons into an ordinary
    # rejection instead of making every chain of the lockstep batch pay
    # the library's budget
    solve = make_batched_solve_fn(
        lv_problem(), derivatives="adjoint", method="ADAMS", adjoint_interpolation="transition",
        options=BDFOptions(rtol=rtol, atol=rtol, adams_max_order=6, max_steps=2000),
        adjoint_options=BDFOptions(rtol=adjoint_rtol, atol=adjoint_rtol, adams_max_order=6,
                                   max_steps=4000),
    )
    f_kw = dict(dtype=torch.float64, device=device)
    tvals_t = torch.as_tensor(np.asarray(tvals), **f_kw)
    obs_log = torch.as_tensor(lv_nuts_observations(tvals), **f_kw)
    p_fix = torch.as_tensor(LV_P_FIX, **f_kw)
    y0 = torch.tensor([10.0, 2.0], **f_kw)
    mu0 = torch.log(torch.tensor(LV_NUTS_TRUE, **f_kw))

    def logp_fn(theta):
        ys = solve(0.0, y0.expand(theta.shape[0], 2).contiguous(), torch.exp(theta), p_fix,
                   tvals_t)
        ys_safe = torch.clamp_min(ys, 1e-10)
        loglik = -0.5 * torch.sum((torch.log(ys_safe) - obs_log[None]) ** 2 / LV_NUTS_SIGMA**2,
                                  dim=(1, 2))
        logprior = -0.5 * torch.sum((theta - mu0) ** 2, dim=1)
        lp = loglik + logprior
        return torch.where(torch.isfinite(lp), lp, -torch.inf)

    logp_fn.solve, logp_fn.obs_log, logp_fn.tvals = solve, obs_log, tvals_t
    return logp_fn, (torch.as_tensor(lv_nuts_init(chains), **f_kw), mu0)


LV_FORWARD_PARAMS = {"alpha": 1.0, "beta": 0.3, "gamma": 1.0, "delta": 0.4}  # bench.py:260


def build_lv_forward_single(device="cuda"):
    """``(solve, (t0, tvals, y0))``: ``bench.py``'s ``lv_forward --batch 1``
    (``bench.py:249-282``).  ``solve()`` is one chain through
    ``Solver(lv_problem(), reltol=1e-10, abstol=1e-10, solver='ADAMS')``
    with :data:`LV_FORWARD_PARAMS`, y0 (10, 2), 50 times on [0, 10];
    ``solve.solver`` is the solver.  ``solve.oracle()`` is the bench's gate
    reference, the 1e-13 BDF solve on the CPU (the native route).  On
    ``device="cpu"`` the solve takes the native route, on the card the
    single Adams core; without a card the default raises."""
    solver = Solver(lv_problem(), reltol=1e-10, abstol=1e-10, solver="ADAMS", device=device)
    solver.set_params_dict(LV_FORWARD_PARAMS)
    t0, tvals, y0 = 0.0, np.linspace(0.0, 10.0, LV_FORWARD_TIMES), np.array([10.0, 2.0])

    def solve():
        return solver.solve(t0, tvals, y0)

    def oracle():
        ref = Solver(lv_problem(), reltol=1e-13, abstol=1e-13, device="cpu")
        ref.set_params_dict(LV_FORWARD_PARAMS)
        return ref.solve(t0, tvals, y0)

    solve.solver, solve.oracle = solver, oracle
    return solve, (t0, tvals, y0)


def build_lv_adjoint_single(device="cuda", rtol: float = 1e-8):
    """``(pair, (y0, p_sub, tvals))``: ``bench.py``'s ``lv_adjoint --batch 1``
    (``_bench_lv_adjoint_single``, ``bench.py:100-154``), one chain's
    forward and backward pair through ``AdjointSolver(lv_problem(),
    solver='ADAMS', adjoint_solver='ADAMS')`` at rtol = atol = ``rtol``
    forward and ``10 * rtol`` backward, lane 0 of
    ``tests/golden/lv_adjoint.npz`` (:func:`lv_adjoint_inputs`; p_fix
    :data:`LV_P_FIX`; 21 times on [1, 10]).  ``pair() -> (ys, gy, gp)``, the
    gradients of ``sum(ys**2)`` as the bench takes them; ``pair.solver`` is
    the solver.  On ``device="cpu"`` the pair takes the native route (the
    forward solve and the augmented backward in C++), on the card the
    single Adams core and the batched Adams backward at B=1; without a card
    the default raises."""
    solver = AdjointSolver(lv_problem(), reltol=rtol, abstol=rtol, adjoint_reltol=rtol * 10,
                           adjoint_abstol=rtol * 10, solver="ADAMS", adjoint_solver="ADAMS",
                           device=device)
    y0s, p_subs = lv_adjoint_inputs(1)
    y0, p_sub = y0s[0], p_subs[0]
    solver.set_params_dict({"alpha": p_sub[0], "beta": p_sub[1], "gamma": LV_P_FIX[0],
                            "delta": LV_P_FIX[1]})
    tvals = np.linspace(1.0, 10.0, 21)

    def pair():
        ys = solver.solve_forward(0.0, tvals, y0)
        quad, lam = solver.solve_backward(tvals[-1], 0.0, tvals, 2.0 * ys)
        return ys, -np.asarray(lam), np.asarray(quad)

    pair.solver = solver
    return pair, (y0, p_sub, tvals)
