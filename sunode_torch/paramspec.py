"""Nested named-variable specifications as flat vectors, over torch tensors.

PyTorch counterpart of ``sunode_tpu/paramspec.py``: the same metadata
(paths, shapes, dims/coords, flat slices, derivative-subset indices) and the
same transforms between

  * nested dicts of arrays         (user-facing)
  * a flat 1-D vector              (what the integrator steps)
  * the "subset" vector            (derivative params)
  * the "remainder" vector         (fixed params)

The array transforms produce ``torch.Tensor``s.  The element type is float64
unless the inputs say otherwise; torch's global default dtype is never read.
"""

from __future__ import annotations

import math
from typing import Any, Iterable, Mapping, Sequence

import numpy as np
import torch

Path = tuple[str, ...]

__all__ = [
    "ParamSpec",
    "Record",
    "flatten_path_dict",
    "nest_path_dict",
    "count_items",
    "as_path",
    "torch_dtype",
]


def torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype of a numpy dtype (or a torch dtype, unchanged)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), dtype=np.dtype(dtype))).dtype


def as_path(p: str | Sequence[str]) -> Path:
    """Normalise a path spec: 'a' -> ('a',), ('a','b') -> ('a','b')."""
    if isinstance(p, str):
        return (p,)
    return tuple(p)


def flatten_path_dict(nested: Mapping[str, Any], prefix: Path = ()) -> dict[Path, Any]:
    """Flatten a nested dict into {path-tuple: leaf} preserving insertion order."""
    out: dict[Path, Any] = {}
    for key, value in nested.items():
        if not isinstance(key, str):
            raise ValueError(f"Keys must be strings, got {key!r}")
        path = prefix + (key,)
        if isinstance(value, Mapping):
            out.update(flatten_path_dict(value, path))
        else:
            out[path] = value
    return out


def nest_path_dict(flat: Mapping[Path, Any]) -> dict[str, Any]:
    """Inverse of `flatten_path_dict`."""
    out: dict[str, Any] = {}
    for path, value in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
            if not isinstance(node, dict):
                raise ValueError(f"Conflicting paths at {path}")
        node[path[-1]] = value
    return out


def count_items(shape: Sequence[int]) -> int:
    return int(math.prod(shape)) if len(shape) else 1


class Record:
    """Attribute-access view over a nested dict of leaves.

    Passed to user RHS functions so they can write ``y.hares`` /
    ``p.rates.alpha``.  Leaves may be sympy symbol arrays (symbolic path) or
    tensors.
    """

    def __init__(self, entries: Mapping[str, Any]):
        object.__setattr__(self, "_entries", dict(entries))

    def __getattr__(self, name: str) -> Any:
        entries = object.__getattribute__(self, "_entries")
        try:
            return entries[name]
        except KeyError:
            raise AttributeError(name) from None

    def __getitem__(self, name: str) -> Any:
        return self._entries[name]

    def __iter__(self):
        return iter(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def keys(self):
        return self._entries.keys()

    def items(self):
        return self._entries.items()

    def as_dict(self) -> dict[str, Any]:
        return {
            k: (v.as_dict() if isinstance(v, Record) else v)
            for k, v in self._entries.items()
        }

    def __repr__(self) -> str:
        return f"Record({self._entries!r})"


def _normalise_shape(
    path: Path, raw: Any, coords: Mapping[str, Any]
) -> tuple[tuple[int, ...], tuple[str | None, ...]]:
    """A shape entry is a tuple whose elements are ints or named-dim strings,
    named dims resolved through `coords` (dim name -> coordinate array)."""
    if isinstance(raw, (int, np.integer)):
        raw = (int(raw),)
    if not isinstance(raw, (tuple, list)):
        raise ValueError(
            f"Shape for {'.'.join(path)} must be a tuple of ints or dim names, got {raw!r}"
        )
    sizes: list[int] = []
    dims: list[str | None] = []
    for entry in raw:
        if isinstance(entry, str):
            if entry not in coords:
                raise KeyError(
                    f"Dim '{entry}' of {'.'.join(path)} not found in coords"
                )
            sizes.append(len(coords[entry]))
            dims.append(entry)
        elif isinstance(entry, (int, np.integer)):
            if entry < 0:
                raise ValueError(f"Negative dim in shape for {'.'.join(path)}")
            sizes.append(int(entry))
            dims.append(None)
        else:
            raise ValueError(
                f"Shape entry {entry!r} for {'.'.join(path)} must be int or str"
            )
    return tuple(sizes), tuple(dims)


def _float_result_dtype(values: Iterable[Any], default: torch.dtype) -> torch.dtype:
    """Common floating dtype of the tensor values; ``default`` when none of
    them is a floating tensor."""
    found = [v.dtype for v in values if torch.is_tensor(v) and v.is_floating_point()]
    if not found:
        return default
    out = found[0]
    for d in found[1:]:
        out = torch.promote_types(out, d)
    return out


class ParamSpec:
    """Metadata for a nested {name: shape} spec flattened to one vector.

    Parameters
    ----------
    spec:
        Nested dict mapping names to shapes.  A shape is a tuple whose entries
        are ints or coordinate names (resolved via ``coords``); ``()`` is a
        scalar.  Numpy arrays are also accepted as "shape by example".
    subset_paths:
        Paths (strings or tuples) selecting the derivative subset.
    coords:
        Mapping from dim name to coordinate values.
    dtype:
        Element dtype of the flat vector (default float64).
    """

    def __init__(
        self,
        spec: Mapping[str, Any],
        subset_paths: Iterable[str | Sequence[str]] = (),
        *,
        coords: Mapping[str, Any] | None = None,
        dtype: Any = np.float64,
    ):
        self.coords: dict[str, np.ndarray] = {
            k: np.asarray(v) for k, v in (coords or {}).items()
        }
        self.dtype = np.dtype(dtype)
        self.torch_dtype = torch_dtype(self.dtype)

        flat = flatten_path_dict(spec)
        self.paths: list[Path] = []
        self.shapes: dict[Path, tuple[int, ...]] = {}
        self._dims: dict[Path, tuple[str | None, ...]] = {}
        for path, raw in flat.items():
            if isinstance(raw, np.ndarray):
                shape, dims = tuple(raw.shape), (None,) * raw.ndim
            else:
                shape, dims = _normalise_shape(path, raw, self.coords)
            self.paths.append(path)
            self.shapes[path] = shape
            self._dims[path] = dims

        # Flat layout: depth-first insertion order.
        self.slices: dict[Path, slice] = {}
        offset = 0
        for path in self.paths:
            n = count_items(self.shapes[path])
            self.slices[path] = slice(offset, offset + n)
            offset += n
        self.n_items = offset

        # Subset bookkeeping.  A subset path may name an interior node, in
        # which case all leaves under it are selected.
        requested = [as_path(p) for p in subset_paths]
        self.subset_paths: list[Path] = []
        for req in requested:
            matches = [p for p in self.paths if p[: len(req)] == req]
            if not matches:
                raise KeyError(f"subset path {req} not found in spec")
            for m in matches:
                if m not in self.subset_paths:
                    self.subset_paths.append(m)
        idx: list[int] = []
        for p in self.subset_paths:
            s = self.slices[p]
            idx.extend(range(s.start, s.stop))
        self.subset_indices = np.asarray(idx, dtype=np.int64)
        self.subset_n_items = len(idx)
        rem_mask = np.ones(self.n_items, dtype=bool)
        rem_mask[self.subset_indices] = False
        self.remainder_indices = np.nonzero(rem_mask)[0]

        # Subset flat layout (contiguous vector of just the subset).
        self.subset_slices: dict[Path, slice] = {}
        off = 0
        for p in self.subset_paths:
            n = count_items(self.shapes[p])
            self.subset_slices[p] = slice(off, off + n)
            off += n

    # ------------------------------------------------------------------
    # dims / coords
    # ------------------------------------------------------------------
    def dims_for(self, path: str | Sequence[str]) -> tuple[str, ...]:
        """xarray dim names for a leaf; unnamed dims get generated names."""
        path = as_path(path)
        dims = self._dims[path]
        base = "_".join(path)
        return tuple(
            d if d is not None else f"{base}_dim_{i}" for i, d in enumerate(dims)
        )

    @property
    def resolved_coords(self) -> dict[str, np.ndarray]:
        return dict(self.coords)

    # ------------------------------------------------------------------
    # flatten / unflatten
    # ------------------------------------------------------------------
    def flatten_dict(
        self, nested: Mapping[str, Any], follow_dtype: bool = False, device=None
    ) -> torch.Tensor:
        """Nested dict of tensors/arrays/scalars -> flat tensor (ordered per spec).

        Missing leaves are an error; extra leaves are an error.
        ``follow_dtype=True`` keeps the leaves' common floating dtype instead
        of coercing to ``self.dtype``; non-floating leaves still promote to
        ``self.dtype``.
        """
        flat = flatten_path_dict(nested)
        extra = set(flat) - set(self.paths)
        if extra:
            raise KeyError(f"Unknown entries: {sorted(extra)}")
        missing = set(self.paths) - set(flat)
        if missing:
            raise KeyError(f"Missing entries: {sorted(missing)}")
        dtype = self.torch_dtype
        if follow_dtype:
            dtype = _float_result_dtype(flat.values(), self.torch_dtype)
        parts = []
        for path in self.paths:
            value = torch.as_tensor(flat[path], dtype=dtype, device=device)
            expected = self.shapes[path]
            if tuple(value.shape) != expected:
                value = torch.broadcast_to(value, expected)
            parts.append(value.reshape(-1))
        if not parts:
            return torch.zeros((0,), dtype=self.torch_dtype, device=device)
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def unflatten(self, vec: Any, *, paths: Sequence[Path] | None = None) -> dict[str, Any]:
        """Flat vector -> nested dict of correctly-shaped arrays."""
        if paths is None:
            paths = self.paths
        flat = {}
        for path in paths:
            s = self.slices[path]
            leaf = vec[..., s]
            flat[path] = leaf.reshape(tuple(vec.shape[:-1]) + self.shapes[path])
        return nest_path_dict(flat)

    def record(self, vec_or_fn: Any) -> Record:
        """Attribute-access Record over the flat vector, or over the leaves a
        callable ``(path, shape) -> leaf`` builds (sympy symbol arrays)."""
        flat: dict[Path, Any] = {}
        for path in self.paths:
            if callable(vec_or_fn):
                flat[path] = vec_or_fn(path, self.shapes[path])
            else:
                s = self.slices[path]
                flat[path] = vec_or_fn[..., s].reshape(
                    tuple(vec_or_fn.shape[:-1]) + self.shapes[path]
                )
        return _as_record(nest_path_dict(flat))

    # ------------------------------------------------------------------
    # subset gather / scatter
    # ------------------------------------------------------------------
    def take_subset(self, full_vec: torch.Tensor) -> torch.Tensor:
        """Gather the derivative-subset entries out of the full flat vector."""
        idx = torch.as_tensor(self.subset_indices, device=full_vec.device)
        return full_vec[..., idx]

    def take_remainder(self, full_vec: torch.Tensor) -> torch.Tensor:
        idx = torch.as_tensor(self.remainder_indices, device=full_vec.device)
        return full_vec[..., idx]

    def combine(self, subset_vec: torch.Tensor, remainder_vec: torch.Tensor) -> torch.Tensor:
        """Scatter subset + remainder vectors back into the full flat vector.

        The output dtype follows the input dtypes (zero-size halves do not
        vote); non-floating inputs promote to ``self.dtype``.  Index
        assignment into a fresh tensor, so autograd flows to both halves."""
        batch = torch.broadcast_shapes(
            tuple(subset_vec.shape[:-1]), tuple(remainder_vec.shape[:-1])
        )
        voting = [v for v in (subset_vec, remainder_vec) if v.shape[-1:] != (0,)]
        dtype = _float_result_dtype(voting, self.torch_dtype)
        device = subset_vec.device
        out = torch.zeros(tuple(batch) + (self.n_items,), dtype=dtype, device=device)
        sub_idx = torch.as_tensor(self.subset_indices, device=device)
        rem_idx = torch.as_tensor(self.remainder_indices, device=device)
        out[..., sub_idx] = subset_vec.to(dtype)
        out[..., rem_idx] = remainder_vec.to(dtype)
        return out

    def flatten_subset_dict(self, nested: Mapping[str, Any], device=None) -> torch.Tensor:
        """Nested dict containing exactly the subset leaves -> subset vector."""
        flat = flatten_path_dict(nested)
        parts = []
        for path in self.subset_paths:
            if path not in flat:
                raise KeyError(f"Missing subset entry {path}")
            value = torch.as_tensor(flat[path], dtype=self.torch_dtype, device=device)
            if tuple(value.shape) != self.shapes[path]:
                value = torch.broadcast_to(value, self.shapes[path])
            parts.append(value.reshape(-1))
        if not parts:
            return torch.zeros((0,), dtype=self.torch_dtype, device=device)
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def unflatten_subset(self, subset_vec: Any) -> dict[str, Any]:
        flat = {}
        for path in self.subset_paths:
            s = self.subset_slices[path]
            leaf = subset_vec[..., s]
            flat[path] = leaf.reshape(tuple(subset_vec.shape[:-1]) + self.shapes[path])
        return nest_path_dict(flat)

    @property
    def remainder(self) -> "ParamSpec":
        """A ParamSpec over only the non-subset leaves."""
        spec = nest_path_dict(
            {p: self.shapes[p] for p in self.paths if p not in self.subset_paths}
        )
        return ParamSpec(spec, (), coords=self.coords, dtype=self.dtype)

    # ------------------------------------------------------------------
    # numpy structured-dtype parity
    # ------------------------------------------------------------------
    def as_numpy_dtype(self) -> np.dtype:
        """Nested numpy structured dtype equivalent of this spec."""

        def build(node: Mapping[str, Any], prefix: Path) -> np.dtype:
            fields = []
            for key, value in node.items():
                path = prefix + (key,)
                if isinstance(value, Mapping):
                    fields.append((key, build(value, path)))
                else:
                    fields.append((key, self.dtype, self.shapes[path]))
            return np.dtype(fields)

        return build(nest_path_dict({p: None for p in self.paths}), ())

    def flatten_structured(self, arr: np.ndarray) -> np.ndarray:
        """Flatten a numpy structured array (of `as_numpy_dtype`) to the flat
        vector layout.  Leading batch dims are preserved."""
        arr = np.asarray(arr)
        parts = []
        for path in self.paths:
            leaf = arr
            for key in path:
                leaf = leaf[key]
            leaf = np.asarray(leaf, dtype=self.dtype)
            parts.append(leaf.reshape(arr.shape + (-1,)))
        if not parts:
            return np.zeros(arr.shape + (0,), dtype=self.dtype)
        return np.concatenate(parts, axis=-1)

    def coerce_flat(self, value: Any, device=None) -> torch.Tensor:
        """Accept nested dict / structured array / flat vector and return the
        flat tensor."""
        if isinstance(value, Mapping):
            return self.flatten_dict(value, device=device)
        if isinstance(value, np.ndarray) and value.dtype.fields:
            value = self.flatten_structured(value)
        arr = torch.as_tensor(value, dtype=self.torch_dtype, device=device)
        if tuple(arr.shape[-1:]) != (self.n_items,):
            raise ValueError(
                f"Expected flat vector of length {self.n_items}, got shape {tuple(arr.shape)}"
            )
        return arr

    def __repr__(self) -> str:
        return (
            f"ParamSpec(n_items={self.n_items}, subset={self.subset_n_items}, "
            f"paths={['.'.join(p) for p in self.paths]})"
        )


def _as_record(nested: Mapping[str, Any]) -> Record:
    return Record(
        {
            k: (_as_record(v) if isinstance(v, Mapping) else v)
            for k, v in nested.items()
        }
    )
