"""Carry inputs and solver options over from numpy (and so from the JAX package).

For this system the "weights" are the ODE inputs and the solver options;
the problem itself is rebuilt from the same ``rhs_sympy`` callable.  Nothing
here imports jax: a caller holding JAX arrays turns them into numpy first.

The entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); :func:`device_or_raise` refuses a CUDA device on a
machine without one instead of running anywhere else.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from sunode_torch.ops.bdf import BDFOptions

__all__ = ["device_or_raise", "df_pairs_to_f64", "inputs_from_numpy", "options_from_fields"]


def device_or_raise(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when no
    card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the entry points run on the card unless the "
            "caller passes device='cpu'"
        )
    return dev


def canonical_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index: a card named without
    one is the current card (``cuda`` and ``cuda:0`` compare equal then)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return dev


def inputs_from_numpy(y0s, p_subs, p_fix, tvals, device="cuda"):
    """(y0s (B, n), p_subs (B, k), p_fix (k2,), tvals (n_t,)) as float64
    tensors on ``device``."""
    dev = device_or_raise(device)
    return tuple(
        torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)
        for a in (y0s, p_subs, p_fix, tvals)
    )


def df_pairs_to_f64(hi, lo, device="cuda") -> torch.Tensor:
    """The float64 tensor ``hi + lo`` of a double-float operand of the TPU
    kernels (float32 ``hi`` and ``lo`` of one shape, given as numpy); the
    sum is exact in float64."""
    hi, lo = np.asarray(hi), np.asarray(lo)
    if hi.dtype != np.float32 or lo.dtype != np.float32 or hi.shape != lo.shape:
        raise ValueError(
            f"expected float32 (hi, lo) of one shape, got {hi.dtype}{hi.shape} "
            f"and {lo.dtype}{lo.shape}"
        )
    both = hi.astype(np.float64) + lo.astype(np.float64)
    return torch.as_tensor(both, device=device_or_raise(device))


def options_from_fields(fields: Mapping[str, Any]) -> BDFOptions:
    """The port's ``BDFOptions`` from the fields of the reference's
    (``BDFOptions._asdict()``), array fields given as numpy arrays."""
    unknown = set(fields) - set(BDFOptions._fields)
    if unknown:
        raise ValueError(f"unknown BDFOptions fields: {sorted(unknown)}")
    return BDFOptions(**dict(fields))
