"""One Adams PECE attempt for all lanes: the CUDA kernel and its plain version.

Port of ``sunode_tpu/ops/pallas_step.py``.  The TPU kernel
(``adams_pece_attempt_pallas``) ran predictor, fixed corrector sweeps, final
evaluation and error estimate in double-float f32 pairs with a static order.
Here the same attempt runs in native float64 with a per-lane order and the
main path's corrector (``sunode_tpu/ops/adams_batched.py:427-502``):

  * :func:`adams_pece_attempt` -- the wrapper.  On CUDA tensors it launches
    ``csrc/pece_step.cu`` (built with ``nvcc`` for ``sm_90a`` at first use,
    one build per generated right-hand side) and raises if the build, a
    check or the launch fails.  On CPU tensors it runs the plain version.
    It counts its kernel launches in ``adams_pece_attempt.launches``.
  * :func:`adams_pece_attempt_reference` -- the plain PyTorch version of the
    same math, kept operation for operation with the JAX main path.

The integrator runs this PECE core inside the history attempt of
:mod:`sunode_torch.ops.adams_attempt` (its plain version calls
:func:`adams_pece_attempt_reference`; its kernel shares the corrector with
this one through ``csrc/pece_core.cuh``).  ``maxiter=FUNCTIONAL_MAXITER``
with the main path's ``newton_tol`` is the main-path corrector;
``maxiter=FUNCTIONAL_ITERS`` with ``newton_tol=0`` turns the rate tests off
and runs the TPU kernel's fixed sweeps.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from sunode_torch.ops._nvcc_build import build_library
from sunode_torch.ops.adams import _GAMMA, _GAMMA_STAR
from sunode_torch.symode.cuda_codegen import DeviceSystem

__all__ = [
    "PeceSystem",
    "PeceOut",
    "adams_pece_attempt",
    "adams_pece_attempt_reference",
    "build_kernel",
    "FUNCTIONAL_ITERS",
]

FUNCTIONAL_ITERS = 3  # the TPU kernel's fixed sweep count

_CSRC = Path(__file__).resolve().parents[1] / "csrc" / "pece_step.cu"


@dataclass(frozen=True)
class PeceSystem:
    """The combined right-hand side of one solve.

    ``fz(t (B,), y (n, B), params (n_p, B)) -> (nz, B)`` evaluates the state
    rows and any quadrature rows from the first ``n`` (iterated) rows;
    ``device`` is the same system emitted for the kernel (required on CUDA)."""

    fz: Callable
    n: int
    nz: int
    device: Optional[DeviceSystem] = None


class PeceOut(NamedTuple):
    y_it: torch.Tensor  # (n, B) corrector iterate (the TPU kernel's y)
    d_fz: torch.Tensor  # (nz, B) f(t, y_it) - f_extrap (its d_f)
    err: torch.Tensor  # (nz, B) |gamma*_p| h d_fz (its err)
    z_pred: torch.Tensor  # (nz, B)
    z_new: torch.Tensor  # (nz, B) z_pred + h gamma_{p-1} d_fz
    conv: torch.Tensor  # (B,) bool: converged & finite & predictor finite
    niter: torch.Tensor  # (B,) int32 corrector sweeps taken


def adams_pece_attempt_reference(
    fz: Callable,
    t_new: torch.Tensor,
    h: torch.Tensor,
    p: torch.Tensor,
    active: torch.Tensor,
    DF: torch.Tensor,
    z_prev: torch.Tensor,
    params: torch.Tensor,
    atol_z: torch.Tensor,
    rtol_z: torch.Tensor,
    newton_tol: float,
    maxiter: int,
    n: int,
) -> PeceOut:
    """Plain PyTorch PECE attempt; the arguments are those of
    :func:`adams_pece_attempt` with the system's ``fz`` and ``n`` spelled
    out.  ``DF`` is (KAB, nz, B) and already rescaled to ``h``; rows
    ``i >= p`` enter multiplied by 0.0, as in the JAX main path."""
    dtype, device = z_prev.dtype, z_prev.device
    K = DF.shape[0] - 2  # P_MAX + 1
    B = z_prev.shape[1]
    gamma = torch.as_tensor(_GAMMA, dtype=dtype, device=device)
    gamma_star_abs = torch.as_tensor(np.abs(_GAMMA_STAR), dtype=dtype, device=device)

    acc_z = torch.zeros_like(z_prev)
    f_extrap = torch.zeros_like(z_prev)
    for i in range(K):
        m = (i <= p - 1).to(dtype)[None, :]
        acc_z = acc_z + m * float(_GAMMA[i]) * DF[i]
        f_extrap = f_extrap + m * DF[i]
    z_pred = z_prev + h[None, :] * acc_z
    c_A = h * gamma[(p - 1).long()]

    scale_z = atol_z[:, None] + rtol_z[:, None] * torch.abs(z_pred)
    w_y = (1.0 / scale_z)[:n]
    pred_ok = torch.isfinite(z_pred).all(dim=0)

    fixed = not newton_tol > 0
    y_it = z_pred[:n]
    conv = ~active
    div = torch.zeros(B, dtype=torch.bool, device=device)
    bad = torch.zeros(B, dtype=torch.bool, device=device)
    dy_old = torch.full((B,), float("inf"), dtype=dtype, device=device)
    niter = torch.zeros(B, dtype=torch.int32, device=device)
    for k in range(maxiter):
        fz_k = fz(t_new, y_it, params)
        bad_f = ~torch.isfinite(fz_k).all(dim=0)
        z_next = z_pred + c_A[None, :] * (fz_k - f_extrap)
        delta = z_next[:n] - y_it
        dy_norm = torch.sqrt(torch.mean((delta * w_y) ** 2, dim=0))
        rate = dy_norm / dy_old
        live = ~(conv | div | bad)
        y_it = torch.where(live[None, :], z_next[:n], y_it)
        if fixed:
            conv_new = torch.zeros_like(live)
            div_new = torch.zeros_like(live)
        else:
            conv_new = (
                (dy_norm == 0.0)
                | ((k > 0) & (rate < 1.0) & (rate / (1 - rate) * dy_norm < newton_tol))
                | (dy_norm < 0.1 * newton_tol)
            )
            div_new = (rate >= 2.0) & (k > 0)
        bad = bad | (live & bad_f)
        conv = conv | (live & conv_new & ~bad)
        div = div | (live & div_new & ~conv_new)
        niter = niter + live.to(torch.int32)
        dy_old = torch.where(live, dy_norm, dy_old)
    if fixed:
        conv = conv | ~bad
    conv = conv & ~bad & pred_ok

    d_fz = fz(t_new, y_it, params) - f_extrap
    z_new = z_pred + c_A[None, :] * d_fz
    err = (gamma_star_abs[p.long()] * h)[None, :] * d_fz
    return PeceOut(y_it, d_fz, err, z_pred, z_new, conv, niter)


# ---------------------------------------------------------------------------
# CUDA build and launch
# ---------------------------------------------------------------------------
def _u_table(K: int) -> np.ndarray:
    """U = R(1) of the Adams rescale, (K, K) with U[j][i] the running index j
    and column i: U[0][i] = 1, U[j][i] = (U[j-1][i] ((j-1) - i)) / j, the
    signed binomials (-1)^j C(i, j).  Every product and quotient is an exact
    integer in float64."""
    U = np.ones((K, K))
    i = np.arange(K, dtype=np.float64)
    for j in range(1, K):
        U[j] = U[j - 1] * ((j - 1) - i) / j
    return U


def _tables_header(real: str = "double") -> str:
    """The coefficient tables at the C type ``real``: 'double', the float64
    values' exact repr, or 'float', each value rounded to float32 as
    ``torch.as_tensor(..., dtype=torch.float32)`` rounds it, printed
    exactly with an F suffix."""
    if real == "double":
        vals = lambda xs: ", ".join(repr(float(x)) for x in xs)  # noqa: E731
    elif real == "float":
        vals = lambda xs: ", ".join(  # noqa: E731
            repr(float(np.float32(x))) + "F" for x in xs)
    else:
        raise ValueError(f"_tables_header: real must be 'double' or 'float', got {real!r}")
    L = len(_GAMMA)
    U = _u_table(L - 1)  # the deepest rescale block the tables allow
    return "\n".join(
        [
            "// Adams coefficient tables (sunode_torch.ops.adams), exact repr",
            "#pragma once",
            f"#define PECE_TABLE_LEN {L}",
            f"__constant__ {real} PECE_GAMMA[{L}] = {{{vals(_GAMMA)}}};",
            f"__constant__ {real} PECE_GAMMA_STAR_ABS[{L}] = "
            f"{{{vals(np.abs(_GAMMA_STAR))}}};",
            f"__constant__ {real} PECE_U[{L - 1}][{L - 1}] = "
            f"{{{', '.join('{' + vals(row) + '}' for row in U)}}};",
            "",
        ]
    )


class _PeceKernel:
    """One compiled build of ``csrc/pece_step.cu`` for one right-hand side."""

    def __init__(self, system: DeviceSystem):
        self.system = system
        self.launches = 0
        built = build_library(
            f"pece_{system.name}", _CSRC,
            headers={"pece_rhs.h": system.source, "pece_tables.h": _tables_header()},
        )
        self.build_log, self.build_seconds, self.lib_path = built.log, built.seconds, built.path
        lib = built.lib
        vp, c_int, c_double = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.pece_attempt_launch.argtypes = (
            [vp] * 9 + [c_double] + [c_int] * 6 + [vp] * 7 + [vp]
        )
        lib.pece_attempt_launch.restype = c_int
        lib.pece_error_string.argtypes = [c_int]
        lib.pece_error_string.restype = ctypes.c_char_p
        self._lib = lib

    def launch(self, t_new, h, p, active, DF, z_prev, params, atol_z, rtol_z,
               newton_tol, maxiter) -> PeceOut:
        s = self.system
        KAB, nz, B = DF.shape
        dev = DF.device
        _check(DF, torch.float64, (KAB, s.nz, B), dev, "DF")
        _check(z_prev, torch.float64, (s.nz, B), dev, "z_prev")
        _check(params, torch.float64, (s.n_p, B), dev, "params")
        _check(t_new, torch.float64, (B,), dev, "t_new")
        _check(h, torch.float64, (B,), dev, "h")
        _check(p, torch.int32, (B,), dev, "p")
        _check(active, torch.bool, (B,), dev, "active")
        _check(atol_z, torch.float64, (s.nz,), dev, "atol_z")
        _check(rtol_z, torch.float64, (s.nz,), dev, "rtol_z")
        f64 = dict(dtype=torch.float64, device=dev)
        out = PeceOut(
            torch.empty((s.n, B), **f64),
            torch.empty((s.nz, B), **f64),
            torch.empty((s.nz, B), **f64),
            torch.empty((s.nz, B), **f64),
            torch.empty((s.nz, B), **f64),
            torch.empty((B,), dtype=torch.bool, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev),
        )
        # the launch goes to the runtime's current device: make it the tensors'
        with torch.cuda.device(dev):
            code = self._lib.pece_attempt_launch(
                t_new.data_ptr(), h.data_ptr(), p.data_ptr(), active.data_ptr(),
                DF.data_ptr(), z_prev.data_ptr(), params.data_ptr(),
                atol_z.data_ptr(), rtol_z.data_ptr(), float(newton_tol), int(maxiter),
                s.n, s.nz, KAB, s.n_p, B,
                *(o.data_ptr() for o in out), torch.cuda.current_stream(dev).cuda_stream,
            )
        if code == -1:
            raise ValueError(f"PECE kernel built for {s.name} does not match the shapes")
        if code == -2:
            raise ValueError(f"history of {KAB} rows exceeds the Adams tables")
        if code != 0:
            msg = self._lib.pece_error_string(code).decode()
            raise RuntimeError(f"PECE kernel launch failed: {msg} ({code})")
        self.launches += 1
        return out


def _check(x, dtype, shape, device, name):
    if not (
        torch.is_tensor(x)
        and x.dtype == dtype
        and tuple(x.shape) == tuple(shape)
        and x.device == device
        and x.is_contiguous()
    ):
        got = (
            (x.dtype, tuple(x.shape), x.device, x.is_contiguous())
            if torch.is_tensor(x)
            else type(x)
        )
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor {tuple(shape)} on "
            f"{device}, got {got}"
        )


_KERNELS: dict[DeviceSystem, _PeceKernel] = {}


def build_kernel(system: DeviceSystem) -> _PeceKernel:
    """Build (or reuse) the kernel for one emitted system."""
    kernel = _KERNELS.get(system)
    if kernel is None:
        kernel = _PeceKernel(system)
        _KERNELS[system] = kernel
    return kernel


def adams_pece_attempt(
    system: PeceSystem,
    t_new: torch.Tensor,  # (B,)
    h: torch.Tensor,  # (B,) step of this attempt
    p: torch.Tensor,  # (B,) int32 order, 1 <= p <= KAB - 2
    active: torch.Tensor,  # (B,) bool
    DF: torch.Tensor,  # (KAB, nz, B) f-difference history, rescaled to h
    z_prev: torch.Tensor,  # (nz, B)
    params: torch.Tensor,  # (n_p, B)
    atol_z: torch.Tensor,  # (nz,)
    rtol_z: torch.Tensor,  # (nz,)
    newton_tol: float,
    maxiter: int,
) -> PeceOut:
    """One PECE attempt for all lanes: the kernel on CUDA, the plain version
    on CPU tensors."""
    if DF.device.type == "cpu":
        return adams_pece_attempt_reference(
            system.fz, t_new, h, p, active, DF, z_prev, params, atol_z, rtol_z,
            newton_tol, maxiter, system.n,
        )
    if DF.device.type != "cuda":
        raise ValueError(f"adams_pece_attempt: unsupported device {DF.device}")
    if system.device is None:
        raise ValueError("adams_pece_attempt: a CUDA solve needs the emitted device system")
    out = build_kernel(system.device).launch(
        t_new, h, p, active, DF, z_prev, params, atol_z, rtol_z, newton_tol, maxiter
    )
    adams_pece_attempt.launches += 1
    return out


adams_pece_attempt.launches = 0
