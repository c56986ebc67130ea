"""Batched banded LU with partial pivoting: the CUDA kernels and their plain
versions.

Port of ``sunode_tpu/ops/banded.py`` (LAPACK ``gbtrf``/``gbtrs`` re-derived
as a loop over columns) in the port's trailing-batch layout: one banded
matrix a lane, ``ab (l+u+1, n, B)`` with ``ab[u + i - j, j] = A[i, j]``.
A Newton matrix ``M = I - c J`` keeps J's bandwidths, so a factorization
costs O(n (l+u)^2) a lane instead of the dense O(n^3).

  * :func:`banded_factor` -- ``(lu (2l+u+1, n+l+u, B), piv (n, B) int32,
    sing (B,) bool)``: the reference's expanded working storage (A from row
    l down, l fill rows above for the pivoting, the right-padding columns'
    diagonal 1), the pivot offsets 0..l below the diagonal, and whether a
    pivot was not above ``_TINY`` in magnitude (the lane is singular).
  * :func:`banded_solve` -- ``x (m, n, B)`` for ``b (m, n, B)``: m
    right-hand sides a lane in one call (the sensitivities' ``(k, n, B)``,
    the BBD border's ``F^T``); a singular lane's solution is NaN, so a
    Newton loop's finiteness check rejects it, unless ``sing`` is None.

On CUDA tensors each launches its kernel (``csrc/banded.cu``, built with
``nvcc`` for ``sm_90a`` at first use, one build a bandwidth pair and type;
one thread a lane, each lane's factors streamed through a ring in shared
memory that :func:`banded_geometry` sizes) and raises on a tensor it does
not take; on CPU tensors each runs its plain
version (:func:`banded_factor_reference`, :func:`banded_solve_reference`),
column for column the reference's loop.  Both round every operation on its
own in the same order, so the kernels give the plain versions' outputs bit
for bit.  ``banded_factor.launches`` and ``banded_solve.launches`` count
the kernel launches.

These kernels replace no TPU kernel: the reference's loop is one XLA device
loop, and the port's counterpart of one device loop is one launch (a torch
column loop on the host would launch thousands of kernels an attempt).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from sunode_torch.ops._nvcc_build import build_library
from sunode_torch.ops.adams_attempt import FMAD_FLAGS, c_real, real_build
from sunode_torch.ops.pece_step import _check

__all__ = [
    "dense_to_banded",
    "banded_to_dense",
    "banded_factor",
    "banded_solve",
    "banded_factor_reference",
    "banded_solve_reference",
    "banded_geometry",
    "BandedGeometry",
    "build_banded_kernels",
]

_TINY = 1e-300
_CSRC = Path(__file__).resolve().parents[1] / "csrc" / "banded.cu"


def dense_to_banded(A: torch.Tensor, lower: int, upper: int) -> torch.Tensor:
    """Pack dense ``A (n, n, ...)`` into banded storage ``(l+u+1, n, ...)``
    (zeros outside the matrix), any trailing batch dims."""
    n = A.shape[0]
    i = torch.arange(n, device=A.device)
    r = torch.arange(lower + upper + 1, device=A.device)[:, None]
    j = i[None, :]
    row = j + r - upper  # the row of A at storage slot [r, j]
    valid = (row >= 0) & (row < n)
    vals = A[row.clamp(0, n - 1), j.expand_as(row)]
    return torch.where(valid.reshape(valid.shape + (1,) * (A.ndim - 2)), vals, 0.0)


def banded_to_dense(ab: torch.Tensor, lower: int, upper: int) -> torch.Tensor:
    """The dense ``(n, n, ...)`` matrix of banded storage ``ab``."""
    n = ab.shape[1]
    i = torch.arange(n, device=ab.device)[:, None]
    j = torch.arange(n, device=ab.device)[None, :]
    r = upper + i - j
    valid = (r >= 0) & (r <= lower + upper)
    vals = ab[r.clamp(0, lower + upper), j.expand_as(r)]
    return torch.where(valid.reshape(valid.shape + (1,) * (ab.ndim - 2)), vals, 0.0)


def _tiny(dtype, device) -> torch.Tensor:
    """The reference's 1e-300 at ``dtype``: 0 at float32."""
    return torch.tensor(_TINY, dtype=dtype, device=device)


def banded_factor_reference(ab: torch.Tensor, lower: int, upper: int):
    """The plain version of :func:`banded_factor` (any device)."""
    l, u = lower, upper
    w = l + u
    _, n, B = ab.shape
    dev = ab.device
    lu = torch.zeros((2 * l + u + 1, n + w, B), dtype=ab.dtype, device=dev)
    lu[l:, :n] = ab
    lu[w, n:] = 1.0
    piv = torch.zeros((n, B), dtype=torch.int32, device=dev)
    sing = torch.zeros((B,), dtype=torch.bool, device=dev)
    tiny = _tiny(ab.dtype, dev)
    c_idx = torch.arange(w + 1, device=dev)
    row_k = (w - c_idx)[None, :, None].expand(1, w + 1, B)  # row k at window column c
    d_idx = torch.arange(1, l + 1, device=dev)
    tgt = (w + d_idx[:, None] - c_idx[None, :])[:, :, None].expand(l, w + 1, B)  # rows k+d
    minus_one = torch.full((), -1.0, dtype=ab.dtype, device=dev)
    for k in range(n):
        W = lu[:, k : k + w + 1]  # (2l+u+1, w+1, B), a view
        valid = (k + torch.arange(l + 1, device=dev) < n)[:, None]
        score = torch.where(valid, W[w : w + l + 1, 0].abs(), minus_one)
        p = torch.argmax(score, dim=0)  # the first largest, NaN the largest
        rows_p = (w + p[None, None, :] - c_idx[None, :, None]).expand(1, w + 1, B)
        v1, v2 = W.gather(0, row_k), W.gather(0, rows_p)
        W.scatter_(0, row_k, v2)
        W.scatter_(0, rows_p, v1)
        pivot = W[w, 0]
        sing = sing | (pivot.abs() <= tiny)
        pivot = torch.where(pivot.abs() > tiny, pivot, tiny)
        if l:
            mult = W[w + 1 : w + l + 1, 0] / pivot  # (l, B)
            urow = W.gather(0, row_k)[0]  # (w+1, B), U's row k
            T = W.gather(0, tgt)
            T = T - mult[:, None, :] * urow[None]
            T[:, 0] = mult
            W.scatter_(0, tgt, T)
        piv[k] = p.to(torch.int32)
    return lu, piv, sing


def banded_solve_reference(factors, b: torch.Tensor, lower: int, upper: int) -> torch.Tensor:
    """The plain version of :func:`banded_solve` (any device); ``b (m, n,
    B)``."""
    lu, piv, sing = factors
    l, u = lower, upper
    w = l + u
    m, n, B = b.shape
    dev = b.device
    tiny = _tiny(b.dtype, dev)
    bp = torch.cat([b, b.new_zeros((m, l, B))], dim=1)
    pivs = piv.long()[:, None, None, :].expand(n, m, 1, B)
    for k in range(n):
        seg = bp[:, k : k + l + 1]  # (m, l+1, B), a view
        p = pivs[k]
        bk = seg.gather(1, p)  # (m, 1, B)
        seg.scatter_(1, p, seg[:, :1].clone())
        seg[:, :1] = bk
        if l:
            seg[:, 1:] -= lu[w + 1 : w + l + 1, k] * bk
    xp = torch.cat([bp[:, :n], b.new_zeros((m, w, B))], dim=1)
    c_idx = torch.arange(1, w + 1, device=dev)
    k_idx = torch.arange(n, device=dev)[None, :]
    U = lu[(w - c_idx)[:, None], k_idx + c_idx[:, None]]  # (w, n, B): U[k, k+c]
    diag = lu[w, :n]
    diag = torch.where(diag.abs() > tiny, diag, tiny)
    for k in range(n - 1, -1, -1):
        s = xp[:, k]
        if w:
            prods = U[:, k] * xp[:, k + 1 : k + w + 1]  # (m, w, B)
            acc = prods[:, 0]
            for c in range(1, w):
                acc = acc + prods[:, c]
            s = s - acc
        xp[:, k] = s / diag[k]
    x = xp[:, :n]
    if sing is not None:
        x = torch.where(sing[None, None, :], float("nan"), x)
    return x


# ---------------------------------------------------------------------------
# CUDA build and launch
# ---------------------------------------------------------------------------
LANES = 32  # lanes a tile; a block is one tile, a producer and a consumer warp (kLanes)
STAGES = 4  # chunks a ring (csrc/banded.cu's kStages)
ROWS_MAX = 16  # records a chunk at most: 48 records ahead of the step reading them
SMS = 132  # an H100 SXM's streaming multiprocessors
SMEM_BLOCK = 232_448  # the most dynamic shared memory a block can have (227 KB)
SMEM_SM = 233_472  # an SM's shared memory for blocks (228 KB), 1 KB reserved a block
RESIDENT_MAX = 8  # blocks an SM is sized to hold at once, at most
BARRIER = 8  # bytes of one mbarrier: two a stage in the factor, four in the solve


class BandedGeometry(NamedTuple):
    factor_rows: int  # records a chunk of the factor's ring
    solve_rows: int  # records a chunk of each of the solve's two rings
    stages: int  # chunks a ring
    keep: int  # forward results the solve keeps in shared memory (the last rows)
    factor_smem: int  # dynamic shared memory of a factor block, bytes
    solve_smem: int  # of a solve block


def _fit_rows(records: int, per_record: int, fixed, budget: int) -> int:
    """The most records a chunk, at most ROWS_MAX and no more than the
    stream needs, whose ring (and ``fixed(rows)`` bytes beside it) fits in
    ``budget``; 0 if one record a chunk does not."""
    rows = ROWS_MAX
    while rows > 1 and rows // 2 >= records:
        rows //= 2
    while rows >= 1 and STAGES * rows * per_record + fixed(rows) > budget:
        rows //= 2
    return rows


def banded_geometry(n: int, B: int, lower: int, upper: int, itemsize: int,
                    m: int = 1) -> BandedGeometry:
    """The rings of ``csrc/banded.cu`` for ``B`` lanes of order ``n``,
    bandwidths ``(lower, upper)``, ``itemsize``-byte values and ``m``
    right-hand sides a solve: records a chunk (at most 16), the solve's
    kept rows and each block's dynamic shared memory.

    A block is one lane tile; its shared memory is sized so that an SM
    holds every block of a launch at once, up to 8 an SM (at B = 1,024 the
    32 tiles, one an SM: the largest rings and every forward result kept up
    to n ~ 500 at float64).  The solve keeps at least the rows its backward
    ring's first chunks cover (so they never read x), all n when they fit.
    Raises ``ValueError`` when one record a chunk does not fit in a block
    (a band too wide for the kernel)."""
    if n < 1 or B < 1 or m < 1 or lower < 0 or upper < 0:
        raise ValueError(f"banded_geometry: n, B, m must be >= 1 and l, u >= 0, got "
                         f"{(n, B, m, lower, upper)}")
    w = lower + upper
    tiles = -(-B // LANES)

    def budget(blocks: int) -> int:
        resident = min(RESIDENT_MAX, max(1, -(-blocks // SMS)))
        return min(SMEM_BLOCK, SMEM_SM // resident - 1024)

    value = itemsize * LANES  # one value of every lane of a tile
    factor_record = (w + 1) * value
    solve_record = (lower + 1 + w + 2) * value + 4 * LANES  # forward + backward, the pivot
    factor_bars, solve_bars = 2 * STAGES * BARRIER, 4 * STAGES * BARRIER
    factor_rows = _fit_rows(n + lower + 1, factor_record, lambda r: factor_bars, budget(tiles))
    if factor_rows == 0:
        factor_rows = _fit_rows(n + lower + 1, factor_record, lambda r: factor_bars, SMEM_BLOCK)
    solve_budget = budget(tiles * m)

    def least_keep(rows):
        return solve_bars + min(n, STAGES * rows) * value

    solve_rows = _fit_rows(n + lower + 1, solve_record, least_keep, solve_budget)
    if solve_rows == 0:
        solve_budget = SMEM_BLOCK
        solve_rows = _fit_rows(n + lower + 1, solve_record, least_keep, solve_budget)
    if factor_rows == 0 or solve_rows == 0:
        raise ValueError(f"banded_geometry: bandwidths ({lower}, {upper}) at {itemsize} bytes "
                         f"a value need more shared memory than a block has")
    ring = solve_bars + STAGES * solve_rows * solve_record
    keep = min(n, max(STAGES * solve_rows, (solve_budget - ring) // value))
    return BandedGeometry(factor_rows, solve_rows, STAGES, keep,
                          factor_bars + STAGES * factor_rows * factor_record, ring + keep * value)


class _BandedKernels:
    """One build of ``csrc/banded.cu`` for a bandwidth pair and a type."""

    def __init__(self, lower: int, upper: int, dtype: torch.dtype, defines=()):
        self.lower, self.upper = lower, upper
        self.factor_launches = self.solve_launches = 0  # this build's
        suffix, real_defines, self.dtype = real_build(c_real(dtype))
        built = build_library(
            f"banded_l{lower}_u{upper}{suffix}", _CSRC,
            defines=(f"BAND_L={lower}", f"BAND_U={upper}", *real_defines, *defines),
            extra_flags=FMAD_FLAGS,
        )
        self.build_log, self.build_seconds, self.lib_path = built.log, built.seconds, built.path
        lib = built.lib
        vp, c_int = ctypes.c_void_p, ctypes.c_int
        lib.banded_factor_launch.argtypes = [vp] + [c_int] * 6 + [vp] * 4
        lib.banded_factor_launch.restype = c_int
        lib.banded_solve_launch.argtypes = [vp] * 4 + [c_int] * 8 + [vp] * 2
        lib.banded_solve_launch.restype = c_int
        lib.banded_factor_smem.argtypes = [c_int]
        lib.banded_solve_smem.argtypes = [c_int, c_int]
        lib.banded_factor_smem.restype = lib.banded_solve_smem.restype = ctypes.c_longlong
        lib.banded_stages.restype = c_int
        if lib.banded_stages() != STAGES:
            raise RuntimeError(f"banded: the build has {lib.banded_stages()} stages, "
                               f"the geometry {STAGES}")
        lib.banded_error_string.argtypes = [c_int]
        lib.banded_error_string.restype = ctypes.c_char_p
        self._lib = lib

    def _raise(self, what: str, code: int) -> None:
        if code == -1:
            raise ValueError(f"{what}: the build is for bandwidths ({self.lower}, {self.upper})")
        if code == -2:
            raise ValueError(f"{what}: the build does not take this geometry")
        if code != 0:
            msg = self._lib.banded_error_string(code).decode()
            raise RuntimeError(f"{what} launch failed: {msg} ({code})")

    def geometry(self, n: int, B: int, m: int = 1) -> BandedGeometry:
        return banded_geometry(n, B, self.lower, self.upper, self.dtype.itemsize, m)

    def factor(self, ab: torch.Tensor):
        _, n, B = ab.shape
        w = self.lower + self.upper
        dev = ab.device
        g = self.geometry(n, B)
        lu = torch.empty((2 * self.lower + self.upper + 1, n + w, B), dtype=ab.dtype, device=dev)
        piv = torch.empty((n, B), dtype=torch.int32, device=dev)
        sing = torch.empty((B,), dtype=torch.bool, device=dev)
        with torch.cuda.device(dev):
            code = self._lib.banded_factor_launch(
                ab.data_ptr(), self.lower, self.upper, n, B, g.factor_rows, g.stages,
                lu.data_ptr(), piv.data_ptr(), sing.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        self._raise("banded_factor", code)
        self.factor_launches += 1
        return lu, piv, sing

    def solve(self, lu, piv, sing, b):
        m, n, B = b.shape
        g = self.geometry(n, B, m)
        x = torch.empty_like(b)
        with torch.cuda.device(b.device):
            code = self._lib.banded_solve_launch(
                lu.data_ptr(), piv.data_ptr(), None if sing is None else sing.data_ptr(),
                b.data_ptr(), self.lower, self.upper, n, m, B, g.solve_rows, g.stages, g.keep,
                x.data_ptr(), torch.cuda.current_stream(b.device).cuda_stream,
            )
        self._raise("banded_solve", code)
        self.solve_launches += 1
        return x


_KERNELS: dict[tuple[int, int, torch.dtype], _BandedKernels] = {}


def build_banded_kernels(lower: int, upper: int, dtype=torch.float64) -> _BandedKernels:
    """Build (or reuse) the factor and solve kernels for one bandwidth pair
    and type."""
    key = (int(lower), int(upper), dtype)
    kernels = _KERNELS.get(key)
    if kernels is None:
        kernels = _KERNELS[key] = _BandedKernels(*key)
    return kernels


def _on_card(x: torch.Tensor, name: str) -> bool:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type == "cuda"


def banded_factor(ab: torch.Tensor, lower: int, upper: int):
    """Factor B banded matrices ``ab (l+u+1, n, B)``: the kernel on a CUDA
    tensor (contiguous float64 or float32, or it raises), the plain
    version on a CPU tensor.  Returns ``(lu, piv, sing)``."""
    if ab.ndim != 3 or ab.shape[0] != lower + upper + 1:
        raise ValueError(
            f"banded_factor: ab must be (l+u+1, n, B) = ({lower + upper + 1}, n, B), "
            f"got {tuple(ab.shape)}"
        )
    if not _on_card(ab, "banded_factor"):
        return banded_factor_reference(ab, lower, upper)
    if ab.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"banded_factor: the kernel takes float64 or float32, not {ab.dtype}")
    _check(ab, ab.dtype, tuple(ab.shape), ab.device, "ab")
    out = build_banded_kernels(lower, upper, ab.dtype).factor(ab)
    banded_factor.launches += 1
    return out


def banded_solve(factors, b: torch.Tensor, lower: int, upper: int) -> torch.Tensor:
    """Solve ``A x = b`` for ``b (m, n, B)`` with :func:`banded_factor`'s
    ``factors``; NaN in a lane whose ``sing`` is set (``sing`` None: no
    poisoning).  The kernel on CUDA tensors (every input contiguous, of the
    factors' device and type, or it raises), the plain version on CPU
    tensors."""
    lu, piv, sing = factors
    if b.ndim != 3:
        raise ValueError(f"banded_solve: b must be (m, n, B), got {tuple(b.shape)}")
    if not _on_card(b, "banded_solve"):
        return banded_solve_reference(factors, b, lower, upper)
    m, n, B = b.shape
    w = lower + upper
    dtype, dev = lu.dtype, lu.device
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"banded_solve: the kernel takes float64 or float32, not {dtype}")
    _check(lu, dtype, (2 * lower + upper + 1, n + w, B), dev, "lu")
    _check(piv, torch.int32, (n, B), dev, "piv")
    if sing is not None:
        _check(sing, torch.bool, (B,), dev, "sing")
    _check(b, dtype, (m, n, B), dev, "b")
    x = build_banded_kernels(lower, upper, dtype).solve(lu, piv, sing, b)
    banded_solve.launches += 1
    return x


banded_factor.launches = 0
banded_solve.launches = 0
