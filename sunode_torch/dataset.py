"""Minimal xarray.Dataset stand-in (a copy of ``sunode_tpu/utils/dataset.py``).

xarray is an optional dependency; when it imports,
:func:`sunode_torch.problem.solution_to_xarray` returns a real
``xarray.Dataset``.  Otherwise it returns this module's tiny API-compatible
fallback (named data vars, dims, coords, attribute access, ``to_dict``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

__all__ = ["Dataset", "DataArray"]


class DataArray:
    def __init__(self, data: np.ndarray, dims: tuple[str, ...], coords: Mapping[str, Any] | None = None, name: str | None = None):
        self.values = np.asarray(data)
        self.dims = tuple(dims)
        self.coords = dict(coords or {})
        self.name = name

    @property
    def shape(self):
        return self.values.shape

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.values, dtype=dtype)

    def __getitem__(self, idx):
        return self.values[idx]

    def __repr__(self):
        return f"<DataArray {self.name or ''} {self.dims} {self.values.shape}>"


class Dataset:
    def __init__(self, data_vars: Mapping[str, tuple], coords: Mapping[str, Any] | None = None):
        self.coords = {k: np.asarray(v) for k, v in (coords or {}).items()}
        self.data_vars: dict[str, DataArray] = {}
        for name, (dims, data) in data_vars.items():
            rel = {d: self.coords[d] for d in dims if d in self.coords}
            self.data_vars[name] = DataArray(data, dims, rel, name)

    def __getattr__(self, name: str) -> DataArray:
        try:
            return object.__getattribute__(self, "data_vars")[name]
        except KeyError:
            raise AttributeError(name) from None

    def __getitem__(self, name: str) -> DataArray:
        return self.data_vars[name]

    def __contains__(self, name: str) -> bool:
        return name in self.data_vars

    def keys(self):
        return self.data_vars.keys()

    def to_dict(self) -> dict[str, Any]:
        return {
            "coords": {k: v for k, v in self.coords.items()},
            "data_vars": {
                k: {"dims": v.dims, "data": v.values} for k, v in self.data_vars.items()
            },
        }

    def __repr__(self):
        vars_ = ", ".join(
            f"{k}{v.dims}" for k, v in self.data_vars.items()
        )
        return f"<sunode_torch.Dataset vars=[{vars_}] coords={list(self.coords)}>"
