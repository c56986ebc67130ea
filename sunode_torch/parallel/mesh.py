"""The chain axis over several devices: split a batch of independent solves.

The reference's only parallelism is fork-per-chain multiprocessing, one
CVODES instance per OS process.  The batched cores take thousands of chains
in one lockstep solve on one device; this module splits the chain (batch)
axis over several, the counterpart of the JAX package's
``jax.sharding`` over a 1-D mesh:

  * :class:`Mesh` -- the devices as ``torch.device`` s and the axis names,
    the counterpart of ``jax.sharding.Mesh``; :func:`make_mesh` is the first
    ``n_devices`` cards;
  * :func:`shard_over_chains` -- every array's leading axis cut into one
    contiguous chunk a device and placed there (``NamedSharding(mesh,
    P("chains"))``);
  * :func:`map_over_chains` -- ``fn`` run on each device's chunk, one host
    thread a device, the results concatenated on the first device: the
    counterpart of ``jax.jit(fn, in_shardings=NamedSharding(mesh,
    P("chains")))``.  The copies are differentiable, so gradients flow back
    through ``torch.autograd`` to the unsplit inputs.

Chains are independent, so the only traffic is the scatter of the inputs
and the gather of the results.  Every core is a host loop: the threads
share the GIL, so on several cards they overlap the cards' work, not the
Python.  The state axis (``make_mesh_2d``, ``shard_batch_state``), which
splits one chain's state vector over devices, is not part of this module.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from sunode_torch.convert import device_or_raise

__all__ = ["CHAINS_AXIS", "STATE_AXIS", "Mesh", "make_mesh", "shard_over_chains",
           "map_over_chains"]

CHAINS_AXIS = "chains"
STATE_AXIS = "state"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` (anything ``torch.device`` takes; one device
    may appear more than once) along the axis ``axis_names[0]``."""

    devices: tuple
    axis_names: tuple = (CHAINS_AXIS,)

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        names = tuple(self.axis_names)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len(names) != 1:
            raise ValueError(f"a chain mesh has one axis, got {names}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = CHAINS_AXIS) -> Mesh:
    """The first ``n_devices`` cards (all of them by default) along
    ``axis_name``; raises without a card, or with fewer than asked for."""
    device_or_raise("cuda")
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if not 1 <= n <= have:
        raise ValueError(f"need {n} CUDA devices, have {have}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), (axis_name,))


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

        # grad mode and the intra-op thread count are the calling thread's:
        # each device's thread takes them
        grad, n_threads = torch.is_grad_enabled(), torch.get_num_threads()

        def run(d):
            torch.set_num_threads(n_threads)
            dev = mesh.devices[d]
            with torch.set_grad_enabled(grad):
                if dev.type == "cuda":
                    with torch.cuda.device(dev):
                        return fns[d](*per_device[d])
                return fns[d](*per_device[d])

        with ThreadPoolExecutor(mesh.size) as pool:
            results = list(pool.map(run, range(mesh.size)))
        return _gather(results, mesh.devices[0])

    return mapped
