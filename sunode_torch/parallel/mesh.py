"""Chains and state rows over several devices.

The reference's only parallelism is fork-per-chain multiprocessing, one
CVODES instance per OS process.  The batched cores take thousands of chains
in one lockstep solve on one device; this module splits the chain (batch)
axis over several, the counterpart of the JAX package's
``jax.sharding`` over a 1-D mesh, and one chain's state vector over a
second axis:

  * :class:`Mesh` -- the devices as ``torch.device`` s and the axis names,
    the counterpart of ``jax.sharding.Mesh``: a tuple of devices along one
    axis, or a grid (a tuple of rows, or an object array) along two;
    :func:`make_mesh` is the first ``n_devices`` cards, :func:`make_mesh_2d`
    the first ``n_chains * n_state`` as a (chains x state) grid;
  * :func:`shard_over_chains` -- every array's leading axis cut into one
    contiguous chunk a device and placed there (``NamedSharding(mesh,
    P("chains"))``);
  * :func:`map_over_chains` -- ``fn`` run on each device's chunk, one host
    thread a device, the results concatenated on the first device: the
    counterpart of ``jax.jit(fn, in_shardings=NamedSharding(mesh,
    P("chains")))``.  The copies are differentiable, so gradients flow back
    through ``torch.autograd`` to the unsplit inputs;
  * :func:`shard_batch_state` -- a ``(B, n)`` initial-state batch cut into
    the (chain, state) grid of blocks of a 2-D mesh (``NamedSharding(mesh,
    P("chains", "state"))``), a :class:`StateShards` that
    ``make_batched_solve_fn``'s solve takes in place of ``y0``.

Chains are independent, so the only traffic of the chain axis is the
scatter of the inputs and the gather of the results.  Every core is a host
loop: the threads share the GIL, so on several cards they overlap the
cards' work, not the Python.  The state axis splits each chain group's
state rows over its row of the mesh: the group's first device (its home)
runs the host loop, every per-lane quantity and the right-hand side on the
gathered iterate, and each device keeps and updates its block of every
array with a state-row axis (:mod:`sunode_torch.parallel.rows`; the split
attempt's partial norms, ``ops/adams_split.py::adams_split_attempt_rows``).
In the reference XLA's partitioner does this inside the jitted solve, with
the halos and the norms' psums it inserts (``sunode_tpu/parallel/mesh.py``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from sunode_torch.convert import canonical_device, device_or_raise

__all__ = ["CHAINS_AXIS", "STATE_AXIS", "Mesh", "make_mesh", "make_mesh_2d", "StateShards",
           "shard_over_chains", "map_over_chains", "shard_batch_state"]

CHAINS_AXIS = "chains"
STATE_AXIS = "state"


@dataclass(frozen=True)
class Mesh:
    """A mesh of ``devices`` (anything ``torch.device`` takes; one device
    may appear more than once) along ``axis_names``: a sequence of devices
    for one axis, or for two a grid, a tuple of rows or an object array,
    row ``i`` the devices of chain group ``i`` along the second axis.
    ``grid`` holds the devices as a tuple of rows (a 1-D mesh is one
    column, ``grid[i] == (devices[i],)``), ``devices`` them in row-major
    order."""

    devices: Any
    axis_names: tuple = (CHAINS_AXIS,)

    def __post_init__(self):
        names = tuple(self.axis_names)
        rows = np.asarray(self.devices, dtype=object)
        if rows.ndim != len(names) or len(names) not in (1, 2):
            raise ValueError(f"a mesh of {rows.ndim} axes needs as many names, got {names}")
        if rows.size == 0:
            raise ValueError("a mesh needs at least one device")
        grid = tuple(tuple(canonical_device(d) for d in r)
                     for r in rows.reshape(rows.shape[0], -1))
        object.__setattr__(self, "grid", grid)
        object.__setattr__(self, "devices", tuple(d for r in grid for d in r))
        object.__setattr__(self, "axis_names", names)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> tuple:
        return (len(self.grid), len(self.grid[0])) if len(self.axis_names) == 2 else (self.size,)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = CHAINS_AXIS) -> Mesh:
    """The first ``n_devices`` cards (all of them by default) along
    ``axis_name``; raises without a card, or with fewer than asked for."""
    device_or_raise("cuda")
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if not 1 <= n <= have:
        raise ValueError(f"need {n} CUDA devices, have {have}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), (axis_name,))


def make_mesh_2d(n_chains: int, n_state: int, chain_axis: str = CHAINS_AXIS,
                 state_axis: str = STATE_AXIS) -> Mesh:
    """The first ``n_chains * n_state`` cards as a (chains x state) grid,
    row ``i`` the cards of chain group ``i``; raises without a card, or
    with fewer than the grid needs.  A CPU mesh (the tests') is built
    directly: ``Mesh(((cpu, cpu),) * k, ("chains", "state"))``."""
    device_or_raise("cuda")
    need, have = int(n_chains) * int(n_state), torch.cuda.device_count()
    if n_chains < 1 or n_state < 1:
        raise ValueError(f"a 2-D mesh needs n_chains, n_state >= 1, got {n_chains}, {n_state}")
    if have < need:
        raise ValueError(f"need {need} devices, have {have}")
    devs = [torch.device("cuda", i) for i in range(need)]
    return Mesh(tuple(tuple(devs[i * n_state:(i + 1) * n_state]) for i in range(n_chains)),
                (chain_axis, state_axis))


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, tuple):  # a NamedTuple
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    return fn(tree)


def _check_axis(mesh: Mesh, axis_name: str) -> None:
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh has axes {mesh.axis_names}, not {axis_name!r}")


def _check_1d(mesh: Mesh, what: str) -> None:
    if len(mesh.axis_names) != 1:
        raise ValueError(f"{what} takes a 1-D mesh; a 2-D mesh's chains go through "
                         f"shard_batch_state and the batched solve")


def _chunks(mesh: Mesh, x) -> list:
    """``x``'s leading axis in ``mesh.size`` contiguous chunks, chunk ``d``
    on device ``d`` (a differentiable copy of a tensor)."""
    if not (torch.is_tensor(x) or isinstance(x, np.ndarray)) or x.ndim == 0:
        raise ValueError(f"a chain-axis argument must be an array with a leading axis, "
                         f"got {type(x).__name__}")
    B = x.shape[0]
    if B % mesh.size:
        raise ValueError(f"the chain axis ({B}) does not divide evenly over "
                         f"{mesh.size} devices")
    t = torch.as_tensor(x)
    return [c.to(d) for c, d in zip(torch.chunk(t, mesh.size), mesh.devices)]


def shard_over_chains(mesh: Mesh, tree: Any, axis_name: str = CHAINS_AXIS) -> list:
    """Every array in ``tree`` (nested dicts, lists and tuples) cut along
    its leading axis into one contiguous chunk a device: a list with one
    tree a device, its arrays tensors on that device.  Raises
    ``ValueError`` when an axis does not divide evenly."""
    _check_axis(mesh, axis_name)
    _check_1d(mesh, "shard_over_chains")
    leaves: list = []
    # the leaves' chunks, in the order the second walk meets the leaves
    _tree_map(lambda x: leaves.append(iter(_chunks(mesh, x))), tree)
    return [_tree_map(lambda _x, it=iter(leaves): next(next(it)), tree)
            for _ in range(mesh.size)]


def _gather(results: Sequence, device: torch.device):
    """Leaf-wise concatenation of the devices' results on ``device``: tensors
    along their leading axis, a scalar a device stacked."""
    first = results[0]
    if isinstance(first, dict):
        return {k: _gather([r[k] for r in results], device) for k in first}
    if isinstance(first, (list, tuple)):
        parts = [_gather([r[i] for r in results], device) for i in range(len(first))]
        return type(first)(*parts) if hasattr(first, "_fields") else type(first)(parts)
    if not torch.is_tensor(first):
        raise TypeError(f"map_over_chains gathers tensors, got {type(first).__name__}")
    join = torch.stack if first.ndim == 0 else torch.cat
    return join([r.to(device) for r in results])


def run_on_devices(fns: Sequence[Callable], devices: Sequence[torch.device],
                   args: Sequence[Sequence]) -> list:
    """``[fns[d](*args[d]) for d]``, one host thread a device, each under its
    device (``torch.cuda.device``) for a card, with the caller's grad mode
    and intra-op thread count; a single device runs in the calling thread."""
    grad, n_threads = torch.is_grad_enabled(), torch.get_num_threads()

    def run(d):
        torch.set_num_threads(n_threads)
        dev = torch.device(devices[d])
        with torch.set_grad_enabled(grad):
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    return fns[d](*args[d])
            return fns[d](*args[d])

    if len(devices) == 1:
        return [run(0)]
    with ThreadPoolExecutor(len(devices)) as pool:
        return list(pool.map(run, range(len(devices))))


def map_over_chains(fn, mesh: Mesh, chain_argnums: Optional[Sequence[int]] = None,
                    axis_name: str = CHAINS_AXIS) -> Callable:
    """``mapped(*args)``: ``fn`` on each device of ``mesh``, one host thread
    a device, with the positional arguments in ``chain_argnums`` (all of
    them by default; each an array or a tree of arrays whose leading axis
    is the chain axis) cut into the devices' chunks and every other tensor
    argument copied to each device; the results (tensors, or trees of
    them) are concatenated along the chain axis on ``mesh.devices[0]``.

    ``fn`` may be a sequence of callables, one a device, for a function
    that keeps state of its own (a solver's ``last_stats``).  Each thread
    runs under its device (``torch.cuda.device``) for a card, with the
    caller's grad mode and intra-op thread count.  The copies and the
    concatenation are differentiable: a gradient of the result flows to the
    unsplit arguments, each device's backward on its own device."""
    _check_axis(mesh, axis_name)
    _check_1d(mesh, "map_over_chains")
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn] * mesh.size
    if len(fns) != mesh.size:
        raise ValueError(f"{len(fns)} functions for {mesh.size} devices")

    def mapped(*args):
        split_at = range(len(args)) if chain_argnums is None else chain_argnums
        per_device = [list(args) for _ in range(mesh.size)]
        for i, a in enumerate(args):
            if i in split_at:
                for d, chunk in enumerate(shard_over_chains(mesh, a, axis_name)):
                    per_device[d][i] = chunk
            else:
                for d, dev in enumerate(mesh.devices):
                    per_device[d][i] = _tree_map(
                        lambda x, dev=dev: x.to(dev) if torch.is_tensor(x) else x, a)

        results = run_on_devices(fns, mesh.devices, per_device)
        return _gather(results, mesh.devices[0])

    return mapped


@dataclass(frozen=True)
class StateShards:
    """A ``(B, n)`` batch cut over a 2-D mesh (:func:`shard_batch_state`):
    ``blocks[i][j]`` is ``(B / n_chains, n / n_state)``, chains ``i`` and
    state rows ``j`` in contiguous cuts, on ``mesh.grid[i][j]``."""

    blocks: tuple
    mesh: Mesh
    chain_axis: str = CHAINS_AXIS
    state_axis: str = STATE_AXIS

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0][0].dtype

    def gathered(self, i: int) -> torch.Tensor:
        """Chain group ``i``'s rows ``(B / n_chains, n)`` on its home device
        (the first of its row of the mesh), a differentiable copy."""
        home = self.mesh.grid[i][0]
        return torch.cat([b.to(home) for b in self.blocks[i]], dim=1)


def shard_batch_state(mesh: Mesh, y0, chain_axis: str = CHAINS_AXIS,
                      state_axis: str = STATE_AXIS) -> StateShards:
    """``y0 (B, n)`` with the chains cut over ``chain_axis`` and the state
    vector over ``state_axis`` of a 2-D ``mesh``, each block a
    differentiable copy with storage of its own on its device (a device
    that appears twice gets two blocks, never views of one tensor), so
    gradients reach ``y0``.  Raises ``ValueError`` when B or n does not
    divide evenly."""
    for name in (chain_axis, state_axis):
        _check_axis(mesh, name)
    if mesh.axis_names != (chain_axis, state_axis):
        raise ValueError(f"the mesh's axes are {mesh.axis_names}, not "
                         f"({chain_axis!r}, {state_axis!r})")
    y0 = torch.as_tensor(y0)
    if y0.ndim != 2:
        raise ValueError(f"shard_batch_state: y0 must be (B, n), got {tuple(y0.shape)}")
    (B, n), (nc, ns) = y0.shape, mesh.shape
    if B % nc or n % ns:
        raise ValueError(f"y0 {tuple(y0.shape)} does not divide evenly over the "
                         f"({nc}, {ns}) mesh")
    bc, bn = B // nc, n // ns
    blocks = tuple(
        tuple(y0[i * bc:(i + 1) * bc, j * bn:(j + 1) * bn].to(mesh.grid[i][j], copy=True)
              .contiguous() for j in range(ns))
        for i in range(nc)
    )
    return StateShards(blocks, mesh, chain_axis, state_axis)
