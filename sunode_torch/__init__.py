"""sunode_torch: batched differentiable ODE solving on PyTorch and CUDA.

The PyTorch/CUDA port of ``sunode_tpu``.  This package imports torch and
never jax, works in float64 per tensor and changes no global torch state
(in particular not the default dtype).  The public surface of this slice:

  * :class:`ParamSpec` -- named nested states/params as flat vectors;
  * :class:`SympyProblem` -- an ODE declared in sympy;
  * :class:`TorchProblem` -- an ODE whose right-hand side is torch code on
    one lane's named records, every derivative from ``torch.func``;
  * :func:`make_solve_fn` and :func:`solve_ivp` -- the single-chain
    functional surface: one chain through the single-instance BDF core,
    gradients through ``torch.autograd`` by the checkpointed adjoint or
    forward sensitivities; :func:`solve_lanes` takes per-lane observation
    grids lane by lane through such a solve;
  * :func:`make_batched_solve_fn` -- batched solves with gradients through
    ``torch.autograd``: BDF with the checkpointed adjoint (the default
    call; 'hermite' or 'polynomial' interpolation), and Adams with the
    transition, the backsolve ('resolve') or the checkpointed ('hermite',
    'polynomial') adjoint;
  * :func:`build_lv_checkpointed` and :func:`build_lv_adams` -- the
    Lotka-Volterra gradient step through the default call and through
    the ADAMS adjoints; :func:`build_sir` -- SIR over many regions (a
    ``TorchProblem``) through the ADAMS adjoints;
  * :func:`build_lv_sens` and :func:`build_lv_roots` -- Lotka-Volterra with
    forward sensitivities (staggered on either core, simultaneous on the
    Adams core) and with an event function (rootfinding on either core);
  * :class:`Solver` and :class:`AdjointSolver` -- the reference's class
    API (numpy in and out, params on the object, forward sensitivities,
    rootfinding, the CV_TOO_MUCH_WORK resume, checkpointed adjoints),
    raising :class:`SolverError`; on ``device="cpu"`` one chain of a
    ``SympyProblem`` takes the native host route unless
    ``native_single=False``, and a solver on the card stays on the card;
  * :class:`CpuSolver` -- the native host route itself: the reference's
    C++ integrators (``native/cvbdf.cpp``: BDF and Adams, band, sparse and
    spgmr Newton, sensitivities, rootfinding, the CVodeF/CVodeB adjoint
    pair, a thread pool over a batch) with the problem's system compiled by
    g++, numpy in and out;
  * :class:`Mesh`, :func:`make_mesh`, :func:`shard_over_chains` and
    :func:`map_over_chains` -- the chain axis split over several devices,
    one host thread a device, gradients through ``torch.autograd``;
    :func:`make_mesh_2d` and :func:`shard_batch_state` -- the state axis:
    a (chains x state) mesh, and a :class:`StateShards` batch that
    ``make_batched_solve_fn``'s ADAMS solve takes in place of ``y0``, each
    chain group's state rows split over its row of devices
    (``entry.build_sir_state_split``);
  * :func:`make_event_fn` and :func:`make_hybrid_solve_fn` -- differentiable
    event times (the implicit function theorem around the localized root)
    and event-restart solves with differentiable jumps
    (:class:`HybridResult`); :func:`map_lanes` runs them lane by lane over
    a batch;
  * :func:`nuts_sample` -- batch-lockstep multinomial NUTS (:class:`NUTSResult`)
    whose every gradient is one batched log-density call, with
    :func:`split_rhat` and :func:`ess_bulk`; ``entry.build_lv_nuts`` is
    BASELINE config 4's Lotka-Volterra posterior through the batched ADAMS
    transition adjoint;
  * ``sunode_torch.wrappers.as_pytensor.solve_ivp`` -- the reference's
    PyTensor Ops over :class:`Solver` and :class:`AdjointSolver` (for PyMC;
    without pytensor, ``sunode_torch._compat.pt_shim.install()`` provides
    the Op protocol).

On CUDA tensors the history half of every Adams attempt, forward and
backward, runs the hand-written kernel ``sunode_torch/csrc/adams_attempt.cu``
for a ``SympyProblem`` (its right-hand side emitted into the kernel), and
the three kernels of ``sunode_torch/csrc/adams_split.cu`` for any other
problem, its right-hand side in torch between them; on CPU tensors the
plain PyTorch version of the same math runs instead.  The
BDF core (:mod:`sunode_torch.ops.bdf_batched`, forward sensitivities and
checkpoint recording included) and its checkpointed adjoint are torch code
with a ``torch.linalg`` Newton solve on either device, as are the
single-instance cores (``ops/bdf.py::bdf_solve``, ``ops/adams.py::
adams_solve``); 'band' and 'sparse' Newton solves factor and solve through
the banded LU's kernels (``sunode_torch/csrc/banded.cu``) on CUDA tensors.
"""

from sunode_torch.entry import (
    build_lv_adams,
    build_lv_checkpointed,
    build_lv_roots,
    build_lv_sens,
    build_sir,
    build_sir_state_split,
)
from sunode_torch.native.cpu_solver import CpuSolver
from sunode_torch.parallel.mesh import (
    Mesh,
    StateShards,
    make_mesh,
    make_mesh_2d,
    map_over_chains,
    shard_batch_state,
    shard_over_chains,
)
from sunode_torch.events import HybridResult, make_event_fn, make_hybrid_solve_fn, map_lanes
from sunode_torch.paramspec import ParamSpec, Record
from sunode_torch.problem import TorchProblem
from sunode_torch.sample import NUTSResult, ess_bulk, nuts_sample, split_rhat
from sunode_torch.solver import AdjointSolver, Solver, SolverError
from sunode_torch.symode.problem import SympyProblem
from sunode_torch.wrappers.as_torch import (
    SolveResult,
    make_batched_solve_fn,
    make_solve_fn,
    solve_ivp,
    solve_lanes,
)

__version__ = "0.1.0"

__all__ = [
    "ParamSpec",
    "Record",
    "SympyProblem",
    "TorchProblem",
    "build_lv_adams",
    "build_lv_checkpointed",
    "build_lv_roots",
    "build_lv_sens",
    "build_sir",
    "build_sir_state_split",
    "make_batched_solve_fn",
    "make_solve_fn",
    "solve_ivp",
    "solve_lanes",
    "SolveResult",
    "Solver",
    "AdjointSolver",
    "SolverError",
    "CpuSolver",
    "Mesh",
    "make_mesh",
    "shard_over_chains",
    "map_over_chains",
    "make_mesh_2d",
    "shard_batch_state",
    "StateShards",
    "make_event_fn",
    "make_hybrid_solve_fn",
    "HybridResult",
    "map_lanes",
    "nuts_sample",
    "NUTSResult",
    "split_rhat",
    "ess_bulk",
    "__version__",
]
