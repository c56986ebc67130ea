"""Carry inputs and solver options over from numpy (and so from the JAX package).

For this system the "weights" are the ODE inputs and the solver options;
the problem itself is rebuilt from the same ``rhs_sympy`` callable.  Nothing
here imports jax: a caller holding JAX arrays turns them into numpy first.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from sunode_torch.ops.bdf import BDFOptions

__all__ = ["inputs_from_numpy", "options_from_fields"]


def inputs_from_numpy(y0s, p_subs, p_fix, tvals, device="cpu"):
    """(y0s (B, n), p_subs (B, k), p_fix (k2,), tvals (n_t,)) as float64
    tensors on ``device``."""
    return tuple(
        torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)
        for a in (y0s, p_subs, p_fix, tvals)
    )


def options_from_fields(fields: Mapping[str, Any]) -> BDFOptions:
    """The port's ``BDFOptions`` from the fields of the reference's
    (``BDFOptions._asdict()``), array fields given as numpy arrays."""
    unknown = set(fields) - set(BDFOptions._fields)
    if unknown:
        raise ValueError(f"unknown BDFOptions fields: {sorted(unknown)}")
    return BDFOptions(**dict(fields))
