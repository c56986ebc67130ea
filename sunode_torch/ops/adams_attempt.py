"""The history half of one Adams attempt for all lanes: the CUDA kernel and
its plain version.

One attempt of the batched Adams integrator, up to the scalar tail
(acceptance, order and step adaptation, emission), touches the whole
``(KAB, nz, B)`` f-difference history four times: it rescales it to the new
step (``R(h/h_D) U``), predicts and corrects from it (the PECE core), updates
it with the new difference, and reads two of its updated rows for the
order-selection error estimates.  Here those steps are one function:

  * :func:`adams_history_attempt` -- the wrapper the integrator calls.  On
    CUDA tensors it launches ``csrc/adams_attempt.cu`` (built with ``nvcc``
    for ``sm_90a`` at first use, one build per generated right-hand side,
    history depth and type: float64, or float32 for a system emitted at
    ``real='float'``) and raises if the build, a check or the launch fails;
    every floating input of a launch has the build's type, or it raises.  On
    CPU tensors it runs the plain version, at the inputs' type.  It counts its kernel launches in
    ``adams_history_attempt.launches``.  A CUDA solve without an emitted
    system takes the split attempt of :mod:`sunode_torch.ops.adams_split`
    instead, whose right-hand side stays outside the kernels.
  * :func:`adams_history_attempt_reference` -- the plain PyTorch version,
    operation for operation the code of the integrator's loop
    (``sunode_tpu/ops/adams_batched.py``: ``_rescale`` :376-399, the error
    rows :617-632, ``_update`` :989-1007) around the plain PECE attempt of
    :mod:`sunode_torch.ops.pece_step`.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from sunode_torch.ops._nvcc_build import build_library
from sunode_torch.ops.pece_step import (
    PeceSystem,
    _check,
    _tables_header,
    adams_pece_attempt_reference,
)
from sunode_torch.symode.cuda_codegen import DeviceSystem

__all__ = [
    "HistoryOut",
    "c_real",
    "on_card",
    "adams_history_attempt",
    "adams_history_attempt_reference",
    "build_attempt_kernel",
]

_CSRC = Path(__file__).resolve().parents[1] / "csrc" / "adams_attempt.cu"
# nvcc contracts no product and sum of the emitted right-hand side into an
# FMA either, so its f rounds as its C reads (the kernel's own arithmetic
# is rounded op by op in the source): the emitted forward system's f is
# then the plain one's bit for bit (ROADMAP C6)
FMAD_FLAGS = ("-fmad=false",)
def c_real(dtype: torch.dtype) -> str:
    """The C type of the kernel builds for ``dtype`` (csrc/real.cuh's
    ``SUNODE_REAL``): 'double' or 'float'."""
    if dtype == torch.float64:
        return "double"
    if dtype == torch.float32:
        return "float"
    raise ValueError(f"the kernels are built for float64 and float32, not {dtype}")


def real_build(real: str) -> tuple[str, tuple[str, ...], torch.dtype]:
    """(name suffix, defines, torch dtype) of a build at the C type ``real``:
    float64 keeps the unsuffixed name and no define (real.cuh's default)."""
    if real == "double":
        return "", (), torch.float64
    if real == "float":
        return "_f32", ("SUNODE_REAL=float",), torch.float32
    raise ValueError(f"real must be 'double' or 'float', got {real!r}")


class HistoryOut(NamedTuple):
    DF_resc: torch.Tensor  # (KAB, nz, B) history rescaled to h_use
    DF_upd: torch.Tensor  # (KAB, nz, B) history after an accepted step
    z_pred: torch.Tensor  # (nz, B)
    z_new: torch.Tensor  # (nz, B)
    err0: torch.Tensor  # (nz, B) |gamma*_p| h d_fz, the local error
    err3: torch.Tensor  # (3, B) weighted error norms at orders p, p-1, p+1
    conv: torch.Tensor  # (B,) bool
    niter: torch.Tensor  # (B,) int32 corrector sweeps taken


def _rescale_matrix(fac, p, K):
    """(K, K, B) factor R(fac) of the rescale, restricted to each lane's
    leading p block (identity elsewhere): entry [j][i] is the running product
    over j for column i, R[j][i] = R[j-1][i] ((j-1) - fac i) / j; at fac = 1
    it is U."""
    B = fac.shape[0]
    f_kw = dict(dtype=fac.dtype, device=fac.device)
    ar_K = torch.arange(K, device=fac.device)
    j_K = torch.arange(K, **f_kw)[:, None]  # (K, 1)
    rows = [torch.ones((K, B), **f_kw)]
    for i in range(1, K):
        # the divisor a tensor: torch on CUDA divides by a host number as a
        # product with its reciprocal, an ulp from the true quotient that the
        # CPU and the kernels take
        rows.append(rows[-1] * (i - 1 - fac[None, :] * j_K) / j_K[i])
    R = torch.stack(rows)  # (K_i, K_j, B)
    inblock = (ar_K[:, None, None] <= p - 1) & (ar_K[None, :, None] <= p - 1)
    return torch.where(inblock, R, torch.eye(K, **f_kw)[:, :, None])


def _rescale(DF, p, factor, K):
    """R(factor)U rescale of the leading p block (per element the same
    products and sums, in the same order, as the unrolled reference)."""
    B, nz = DF.shape[2], DF.shape[1]
    f_kw = dict(dtype=DF.dtype, device=DF.device)
    R = _rescale_matrix(factor, p, K)
    U = _rescale_matrix(torch.ones_like(factor), p, K)
    t1 = torch.zeros((K, nz, B), **f_kw)
    for j in range(K):
        t1 = t1 + R[j][:, None, :] * DF[j][None]
    head = torch.zeros((K, nz, B), **f_kw)
    for j in range(K):
        head = head + U[j][:, None, :] * t1[j][None]
    return torch.cat([head, DF[K:]])


def _onehot_rows(idx, rows, dtype):
    """(rows, 1, B) float selector of row idx per lane."""
    r = torch.arange(rows, device=idx.device)[:, None]
    return (r == idx[None, :]).to(dtype)[:, None, :]


def _take_row(DF, idx):
    # masked sum, as the reference: exact DF[idx] on finite histories
    idx = torch.clamp(idx, 0, DF.shape[0] - 1)
    return (_onehot_rows(idx, DF.shape[0], DF.dtype) * DF).sum(dim=0)


def _update(DF, p, d_fz):
    """Accepted-step f-difference update (J = p-1):
    i<=p-1: sum_{j=i..p-1} DF[j] + d;  i==p: d;  i==p+1: d - DF[p]."""
    KAB = DF.shape[0]
    S = [None] * (KAB + 1)
    S[KAB] = torch.zeros_like(DF[0])
    for i in range(KAB - 1, -1, -1):
        S[i] = S[i + 1] + DF[i]
    S = torch.stack(S)  # (KAB + 1, nz, B)
    Sp = (_onehot_rows(p, KAB + 1, DF.dtype) * S).sum(dim=0)
    DFp = _take_row(DF, p)
    i = torch.arange(KAB, device=DF.device)[:, None, None]
    low = i <= (p - 1)[None, None, :]
    is_p = i == p[None, None, :]
    is_p1 = i == (p + 1)[None, None, :]
    return torch.where(
        low,
        S[:KAB] - Sp[None] + d_fz[None],
        torch.where(is_p, d_fz[None], torch.where(is_p1, (d_fz - DFp)[None], DF)),
    )


def adams_history_attempt_reference(
    system: PeceSystem,
    t_new, h_use, pre_factor, p, active, DF, z_prev, params, atol_z, rtol_z,
    gamma_star_abs, v_err, newton_tol: float, maxiter: int, P_MAX: int,
) -> HistoryOut:
    """Plain PyTorch history attempt; the arguments are those of
    :func:`adams_history_attempt`."""
    DF = _rescale(DF, p, pre_factor, P_MAX + 1)
    out = adams_pece_attempt_reference(
        system.fz, t_new, h_use, p, active, DF, z_prev, params, atol_z, rtol_z,
        newton_tol, maxiter, system.n,
    )
    w_z = 1.0 / (atol_z[:, None] + rtol_z[:, None] * torch.abs(out.z_pred))

    # error test: LTE = |gamma*_p| h d_fz, and the estimates at p -+ 1
    DF_upd = _update(DF, p, out.d_fz)
    err_rows = torch.stack(
        [
            out.err,
            (gamma_star_abs[torch.clamp(p - 1, min=0).long()] * h_use)[None, :]
            * _take_row(DF_upd, p - 1),
            (gamma_star_abs[torch.clamp(p + 1, max=P_MAX + 1).long()] * h_use)[None, :]
            * _take_row(DF_upd, p + 1),
        ]
    )
    err3 = torch.sqrt(
        torch.sum((err_rows * w_z[None]) ** 2 * v_err[None, :, None], dim=1)
    )
    return HistoryOut(DF, DF_upd, out.z_pred, out.z_new, out.err, err3, out.conv, out.niter)


# ---------------------------------------------------------------------------
# CUDA build and launch
# ---------------------------------------------------------------------------
class _AttemptKernel:
    """One compiled build of ``csrc/adams_attempt.cu`` for one right-hand
    side and history depth, at the type the system was emitted at
    (``system.real``); ``defines`` adds compile-time defines
    (``ADAMS_PHASE_CLOCKS``, the trace by phase of ``history_ab.py``)."""

    def __init__(self, system: DeviceSystem, kab: int, defines: tuple[str, ...] = ()):
        self.system, self.kab = system, kab
        self.launches = 0
        suffix, real_defines, self.dtype = real_build(system.real)
        built = build_library(
            f"adams_attempt_{system.name}_kab{kab}{suffix}", _CSRC,
            headers={"pece_rhs.h": system.source, "pece_tables.h": _tables_header(system.real)},
            defines=(f"ADAMS_KAB={kab}", *real_defines, *defines), extra_flags=FMAD_FLAGS,
        )
        self.build_log, self.build_seconds, self.lib_path = built.log, built.seconds, built.path
        lib = built.lib
        vp, c_int, c_double = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.adams_attempt_launch.argtypes = (
            [vp] * 12 + [c_double] + [c_int] * 7 + [vp] * 8 + [vp]
        )
        lib.adams_attempt_launch.restype = c_int
        lib.adams_attempt_error_string.argtypes = [c_int]
        lib.adams_attempt_error_string.restype = ctypes.c_char_p
        self._lib = lib

    def launch(self, t_new, h_use, pre_factor, p, active, DF, z_prev, params, atol_z,
               rtol_z, gamma_star_abs, v_err, newton_tol, maxiter) -> HistoryOut:
        s, real = self.system, self.dtype
        KAB, nz, B = DF.shape
        dev = DF.device
        # every floating input at the build's type: nothing is cast
        _check(DF, real, (self.kab, s.nz, B), dev, "DF")
        _check(z_prev, real, (s.nz, B), dev, "z_prev")
        _check(params, real, (s.n_p, B), dev, "params")
        _check(t_new, real, (B,), dev, "t_new")
        _check(h_use, real, (B,), dev, "h_use")
        _check(pre_factor, real, (B,), dev, "pre_factor")
        _check(p, torch.int32, (B,), dev, "p")
        _check(active, torch.bool, (B,), dev, "active")
        _check(atol_z, real, (s.nz,), dev, "atol_z")
        _check(rtol_z, real, (s.nz,), dev, "rtol_z")
        _check(v_err, real, (s.nz,), dev, "v_err")
        # |gamma*| up to order P_MAX + 1 = KAB - 2: at least KAB - 1 entries
        g = gamma_star_abs
        n_gamma = max(KAB - 1, g.shape[0] if torch.is_tensor(g) and g.ndim == 1 else 0)
        _check(gamma_star_abs, real, (n_gamma,), dev, "gamma_star_abs")
        f_kw = dict(dtype=real, device=dev)
        out = HistoryOut(
            torch.empty((KAB, s.nz, B), **f_kw),
            torch.empty((KAB, s.nz, B), **f_kw),
            torch.empty((s.nz, B), **f_kw),
            torch.empty((s.nz, B), **f_kw),
            torch.empty((s.nz, B), **f_kw),
            torch.empty((3, B), **f_kw),
            torch.empty((B,), dtype=torch.bool, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev),
        )
        # the launch goes to the runtime's current device: make it the tensors'
        with torch.cuda.device(dev):
            code = self._lib.adams_attempt_launch(
                t_new.data_ptr(), h_use.data_ptr(), pre_factor.data_ptr(), p.data_ptr(),
                active.data_ptr(), DF.data_ptr(), z_prev.data_ptr(), params.data_ptr(),
                atol_z.data_ptr(), rtol_z.data_ptr(), gamma_star_abs.data_ptr(),
                v_err.data_ptr(), float(newton_tol), int(maxiter),
                s.n, s.nz, KAB, s.n_p, n_gamma, B,
                *(o.data_ptr() for o in out), torch.cuda.current_stream(dev).cuda_stream,
            )
        if code == -1:
            raise ValueError(f"attempt kernel built for {s.name} does not match the shapes")
        if code == -2:
            raise ValueError(f"history of {KAB} rows exceeds the Adams tables")
        if code != 0:
            msg = self._lib.adams_attempt_error_string(code).decode()
            raise RuntimeError(f"attempt kernel launch failed: {msg} ({code})")
        with _COUNT_LOCK:
            self.launches += 1
        return out


_KERNELS: dict[tuple[DeviceSystem, int], _AttemptKernel] = {}
# the counts stay exact when threads launch at once (parallel/mesh.py)
_COUNT_LOCK = threading.Lock()


def build_attempt_kernel(system: DeviceSystem, kab: int) -> _AttemptKernel:
    """Build (or reuse) the kernel for one emitted system (its right-hand
    side and type) and history depth."""
    kernel = _KERNELS.get((system, kab))
    if kernel is None:
        # threads that build at once all take the first one stored
        kernel = _KERNELS.setdefault((system, kab), _AttemptKernel(system, kab))
    return kernel


def on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` lies on the card, where the attempt launches a kernel
    (True) or on the CPU, where it runs the plain version (False); any
    other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"adams_history_attempt: unsupported device {x.device}")
    return x.device.type == "cuda"


def adams_history_attempt(
    system: PeceSystem,
    t_new: torch.Tensor,  # (B,)
    h_use: torch.Tensor,  # (B,) step of this attempt
    pre_factor: torch.Tensor,  # (B,) h_use / h_D, the rescale ratio
    p: torch.Tensor,  # (B,) int32 order, 1 <= p <= P_MAX
    active: torch.Tensor,  # (B,) bool
    DF: torch.Tensor,  # (KAB, nz, B) f-difference history at the last step h_D
    z_prev: torch.Tensor,  # (nz, B)
    params: torch.Tensor,  # (n_p, B)
    atol_z: torch.Tensor,  # (nz,)
    rtol_z: torch.Tensor,  # (nz,)
    gamma_star_abs: torch.Tensor,  # (>= P_MAX + 2,) |gamma*|
    v_err: torch.Tensor,  # (nz,) weights of the error norm's squares
    newton_tol: float,
    maxiter: int,
    P_MAX: int,
) -> HistoryOut:
    """Rescale, PECE, difference update and error rows for all lanes: the
    kernel on CUDA, the plain version on CPU tensors.  A CUDA solve whose
    ``system.device`` is None (a problem with no emitted right-hand side)
    goes to :func:`sunode_torch.ops.adams_split.adams_split_attempt`: the
    same attempt in three kernels with ``system.fz`` in torch between
    them."""
    args = (t_new, h_use, pre_factor, p, active, DF, z_prev, params, atol_z, rtol_z,
            gamma_star_abs, v_err, newton_tol, maxiter)
    if not on_card(DF):
        return adams_history_attempt_reference(system, *args, P_MAX)
    if system.device is None:
        # no emitted system (a problem written in torch): the right-hand side
        # runs as torch code between the split attempt's three kernels
        from sunode_torch.ops.adams_split import adams_split_attempt

        return adams_split_attempt(system, *args, P_MAX)
    if DF.ndim != 3 or DF.shape[0] != P_MAX + 3:
        raise ValueError(
            f"adams_history_attempt: DF must be (P_MAX + 3, nz, B) = ({P_MAX + 3}, nz, B), "
            f"got {tuple(DF.shape)}"
        )
    out = build_attempt_kernel(system.device, P_MAX + 3).launch(*args)
    with _COUNT_LOCK:
        adams_history_attempt.launches += 1
    return out


adams_history_attempt.launches = 0
