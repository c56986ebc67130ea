"""The order-specialised PECE attempt on a flat history: CUDA kernel and plain version.

Port of ``scripts/exp_pallas2d.py::pece_2d_pallas``, the TPU kernel that
ran one Adams PECE attempt at a static order ``P``, with
``FUNCTIONAL_ITERS`` fixed corrector sweeps, on a flattened ``(K*N, B)``
history, with the Lotka-Volterra right-hand side built in.  Here it runs in
native float64 (the TPU kernel's f32 pairs are not ported):

  * :func:`pece_2d_attempt` -- the wrapper.  On CUDA tensors it launches
    ``csrc/pece_2d.cu``, built with ``nvcc`` for ``sm_90a`` at first use,
    one build per order, and raises if the build, a check or the launch
    fails.  On CPU tensors it runs the plain version.  It counts its kernel
    launches in ``pece_2d_attempt.launches``.
  * :func:`pece_2d_reference` -- the plain PyTorch version, operation for
    operation with ``sunode_tpu/ops/pallas_step.py::adams_pece_attempt_reference``
    at a static order.

The right-hand side is the LV system of :func:`sunode_torch.entry.lv_problem`
with one ``(alpha, beta, gamma, delta)`` vector shared by every lane: the
kernel includes the forward system that ``symode/cuda_codegen.py`` emits for
it, and the plain version calls its torch lowering.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from sunode_torch.ops._nvcc_build import build_library
from sunode_torch.ops.adams import _GAMMA, _GAMMA_STAR, ADAMS_MAX_ORDER
from sunode_torch.ops.pece_step import FUNCTIONAL_ITERS, _check, _tables_header

__all__ = ["pece_2d_attempt", "pece_2d_reference", "build_pece_2d", "lv_system", "P_ORDER"]

P_ORDER = 6  # the TPU kernel's order (adams_max_order 6)

_CSRC = Path(__file__).resolve().parents[1] / "csrc" / "pece_2d.cu"


@functools.cache
def lv_system():
    """(torch rhs, emitted device system, n, n_p) of the built-in LV problem."""
    from sunode_torch.entry import lv_problem
    from sunode_torch.symode.cuda_codegen import forward_system

    problem = lv_problem()
    system = forward_system(problem)
    return problem.make_rhs(), system, system.n, system.n_p


def pece_2d_reference(DF2, y_prev, h, t_new, params, *, p_order: int = P_ORDER):
    """Plain PyTorch attempt; the arguments are those of :func:`pece_2d_attempt`."""
    rhs, _, n, _ = lv_system()
    par = params[:, None]
    t = t_new[0]
    acc = 0.0
    fex = 0.0
    for i in range(p_order):
        blk = DF2[i * n : (i + 1) * n]
        acc = acc + float(_GAMMA[i]) * blk
        fex = fex + blk
    y_pred = y_prev + h * acc
    c_A = h * float(_GAMMA[p_order - 1])
    y = y_pred
    for _ in range(FUNCTIONAL_ITERS):
        f = rhs(t, y, par)
        y = y_pred + c_A * (f - fex)
    f = rhs(t, y, par)
    d_f = f - fex
    err = float(abs(_GAMMA_STAR[p_order])) * h * d_f
    return y, d_f, err


class _Pece2dKernel:
    """One compiled build of ``csrc/pece_2d.cu`` at one order."""

    def __init__(self, p_order: int):
        _, system, self.n, self.n_p = lv_system()
        self.p_order = p_order
        self.launches = 0
        built = build_library(
            f"pece2d_p{p_order}", _CSRC,
            headers={"pece_rhs.h": system.source, "pece_tables.h": _tables_header()},
            defines=[f"PECE2D_P={p_order}", f"PECE2D_SWEEPS={FUNCTIONAL_ITERS}"],
        )
        self.build_log, self.build_seconds, self.lib_path = built.log, built.seconds, built.path
        lib = built.lib
        vp, c_int = ctypes.c_void_p, ctypes.c_int
        lib.pece_2d_launch.argtypes = [vp] * 5 + [c_int] * 4 + [vp] * 3 + [vp]
        lib.pece_2d_launch.restype = c_int
        lib.pece_2d_error_string.argtypes = [c_int]
        lib.pece_2d_error_string.restype = ctypes.c_char_p
        self._lib = lib

    def launch(self, DF2, y_prev, h, t_new, params):
        K = DF2.shape[0] // self.n
        B = DF2.shape[1]
        dev = DF2.device
        outs = tuple(torch.empty((self.n, B), dtype=torch.float64, device=dev) for _ in range(3))
        # the launch goes to the runtime's current device: make it the tensors'
        with torch.cuda.device(dev):
            code = self._lib.pece_2d_launch(
                DF2.data_ptr(), y_prev.data_ptr(), h.data_ptr(), t_new.data_ptr(),
                params.data_ptr(), K, self.n, self.n_p, B,
                *(o.data_ptr() for o in outs), torch.cuda.current_stream(dev).cuda_stream,
            )
        if code == -1:
            raise ValueError("pece_2d kernel: shapes do not match the built-in LV system")
        if code == -2:
            raise ValueError(f"pece_2d kernel: history of {K} blocks is shallower than p={self.p_order}")
        if code != 0:
            msg = self._lib.pece_2d_error_string(code).decode()
            raise RuntimeError(f"pece_2d kernel launch failed: {msg} ({code})")
        self.launches += 1
        return outs


_KERNELS: dict[int, _Pece2dKernel] = {}


def build_pece_2d(p_order: int = P_ORDER) -> _Pece2dKernel:
    """Build (or reuse) the kernel for one order."""
    kernel = _KERNELS.get(p_order)
    if kernel is None:
        kernel = _Pece2dKernel(p_order)
        _KERNELS[p_order] = kernel
    return kernel


def pece_2d_attempt(
    DF2: torch.Tensor,  # (K*N, B) f-difference history, block i = rows [i*N, (i+1)*N)
    y_prev: torch.Tensor,  # (N, B)
    h: torch.Tensor,  # (1, B)
    t_new: torch.Tensor,  # (1, B)
    params: torch.Tensor,  # (n_p,) shared by every lane
    *,
    p_order: int = P_ORDER,
):
    """One order-``p_order`` PECE attempt for all lanes: ``(y, d_f, err)``,
    each ``(N, B)`` float64.  The kernel on CUDA, the plain version on CPU
    tensors; any other device raises."""
    _, _, n, n_p = lv_system()
    if not 1 <= p_order <= ADAMS_MAX_ORDER:
        raise ValueError(f"p_order {p_order} outside 1..{ADAMS_MAX_ORDER}")
    if not (torch.is_tensor(DF2) and DF2.dim() == 2):
        raise ValueError("DF2: expected a 2-D (K*N, B) history")
    rows, B = DF2.shape
    if rows % n or rows // n < p_order:
        raise ValueError(
            f"DF2: {rows} rows are not whole blocks of {n}, or fewer than p={p_order} blocks"
        )
    dev = DF2.device
    _check(DF2, torch.float64, (rows, B), dev, "DF2")
    _check(y_prev, torch.float64, (n, B), dev, "y_prev")
    _check(h, torch.float64, (1, B), dev, "h")
    _check(t_new, torch.float64, (1, B), dev, "t_new")
    _check(params, torch.float64, (n_p,), dev, "params")
    if dev.type == "cpu":
        return pece_2d_reference(DF2, y_prev, h, t_new, params, p_order=p_order)
    if dev.type != "cuda":
        raise ValueError(f"pece_2d_attempt: unsupported device {dev}")
    out = build_pece_2d(p_order).launch(DF2, y_prev, h, t_new, params)
    pece_2d_attempt.launches += 1
    return out


pece_2d_attempt.launches = 0
