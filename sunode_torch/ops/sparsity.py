"""Structural sparsity for the Newton solve: the host plan and the colored
Jacobian.

Port of ``sunode_tpu/ops/sparsity.py``.  The plan is host numpy fixed at
setup and is copied as the reference writes it (``color_columns``,
``rcm_permutation``, ``min_degree_order``, ``csc_pattern``, ``bandwidths``,
``_select_border``, :class:`SparsePlan`, ``plan_sparse_jacobian``): the
exact pattern of the Jacobian feeds a greedy column coloring (the Jacobian
from ``n_colors`` jvps instead of n), a reverse Cuthill-McKee permutation
that concentrates it into a band around the banded LU
(:mod:`sunode_torch.ops.banded`), and, for patterns with a few dense rows
and columns, a border of those vertices ordered last, solved by the
bordered-block-diagonal Schur complement of :mod:`sunode_torch.ops.bbd`.

:func:`make_colored_banded_jac` gathers the colored jvps of a batched
right-hand side into that packed storage, on every lane at once.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sunode_torch import forward_ad

__all__ = [
    "color_columns",
    "rcm_permutation",
    "min_degree_order",
    "csc_pattern",
    "bandwidths",
    "plan_sparse_jacobian",
    "SparsePlan",
    "make_colored_banded_jac",
]


def color_columns(pattern: np.ndarray) -> np.ndarray:
    """Greedy structurally-orthogonal column coloring.

    Columns j, k may share a color iff no row has nonzeros in both
    (Curtis-Powell-Reid).  Returns (n,) int colors, ordered by descending
    column degree (a standard near-optimal greedy order).
    """
    pattern = np.asarray(pattern, bool)
    n = pattern.shape[1]
    colors = np.full(n, -1, np.int64)
    order = np.argsort(-pattern.sum(axis=0), kind="stable")
    # rows_hit[c] = union of rows covered by columns of color c
    rows_hit: list[np.ndarray] = []
    for j in order:
        rows_j = pattern[:, j]
        for c, hit in enumerate(rows_hit):
            if not np.any(hit & rows_j):
                colors[j] = c
                rows_hit[c] = hit | rows_j
                break
        else:
            colors[j] = len(rows_hit)
            rows_hit.append(rows_j.copy())
    return colors


def rcm_permutation(pattern: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the symmetrized pattern.

    Returns perm (n,) such that A[perm][:, perm] has (near-)minimal
    bandwidth.  Plain BFS from a minimum-degree peripheral node per
    component, neighbors visited in increasing-degree order, then reversed.
    """
    pattern = np.asarray(pattern, bool)
    sym = pattern | pattern.T
    np.fill_diagonal(sym, False)
    n = sym.shape[0]
    degree = sym.sum(axis=1)
    visited = np.zeros(n, bool)
    order: list[int] = []
    while len(order) < n:
        unvisited = np.flatnonzero(~visited)
        start = unvisited[np.argmin(degree[unvisited])]
        queue = [int(start)]
        visited[start] = True
        while queue:
            v = queue.pop(0)
            order.append(v)
            nbrs = np.flatnonzero(sym[v] & ~visited)
            nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
            for w in nbrs:
                visited[w] = True
                queue.append(int(w))
    return np.asarray(order[::-1], np.int64)


def min_degree_order(pattern: np.ndarray) -> np.ndarray:
    """Greedy minimum-degree elimination ordering of the symmetrized
    pattern — the fill-reducing role AMD plays inside KLU (the reference's
    sparse-direct solver, linear_solver_wrapper.py:99-122).

    Returns ``order`` (n,) with ``order[k]`` = original index eliminated at
    step k; feeding it as the column pre-order of the native
    Gilbert-Peierls LU (``SparseLin``, cvbdf.cpp) keeps fill near-minimal
    for patterns RCM handles badly (arrowheads, star graphs: RCM bandwidth
    is O(n) there, minimum degree eliminates the apex last for zero fill).
    Classic quotient-free formulation: eliminate the minimum-degree node,
    clique its surviving neighbors.  Setup-time host numpy — O(sum deg^2),
    fine for the symbolic-Jacobian sizes this feeds.
    """
    pattern = np.asarray(pattern, bool)
    n = pattern.shape[0]
    sym = pattern | pattern.T
    np.fill_diagonal(sym, False)
    adj = [set(np.flatnonzero(sym[i]).tolist()) for i in range(n)]
    alive = np.ones(n, bool)
    order = np.empty(n, np.int64)
    for k in range(n):
        live = np.flatnonzero(alive)
        v = int(live[np.argmin([len(adj[i]) for i in live])])
        order[k] = v
        alive[v] = False
        nbrs = [w for w in adj[v] if alive[w]]
        for w in nbrs:
            adj[w].discard(v)
            adj[w].update(x for x in nbrs if x != w)
        adj[v].clear()
    return order


def csc_pattern(pattern: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """CSC (indptr, indices) of a boolean pattern, both int64 — the static
    symbolic structure handed to the native sparse-direct entries."""
    pattern = np.asarray(pattern, bool)
    n = pattern.shape[1]
    indptr = np.zeros(n + 1, np.int64)
    cols = []
    for j in range(n):
        rows = np.flatnonzero(pattern[:, j])
        indptr[j + 1] = indptr[j] + rows.size
        cols.append(rows)
    indices = (
        np.concatenate(cols).astype(np.int64)
        if cols
        else np.zeros(0, np.int64)
    )
    return indptr, indices


def bandwidths(pattern: np.ndarray) -> Tuple[int, int]:
    """(lower, upper) bandwidths of a boolean pattern."""
    idx = np.argwhere(np.asarray(pattern, bool))
    if idx.size == 0:
        return 0, 0
    d = idx[:, 0] - idx[:, 1]  # i - j
    return int(max(d.max(), 0)), int(max((-d).max(), 0))


def _select_border(pattern: np.ndarray, cap: int):
    """Greedy max-degree peel for the bordered-block-diagonal plan.

    Returns (border_idx list, interior_perm original-indices) — empty border
    when no peel beats the plain RCM-banded cost model by >25% (so nicely
    banded patterns keep the existing plan exactly).  The cost model is the
    Newton factor cost: banded O(n (w+1)^2) vs BBD
    O(n_i (w_i+1)^2 + 2 k n_i (w_i+1) + k^2 n_i + k^3) (ops/bbd.py).
    """
    pattern = np.asarray(pattern, bool)
    n = pattern.shape[0]
    sym = pattern | pattern.T
    np.fill_diagonal(sym, True)

    def _interior(alive_idx):
        sub = pattern[np.ix_(alive_idx, alive_idx)]
        permi = rcm_permutation(sub)
        pi = sub[permi][:, permi]
        np.fill_diagonal(pi, True)
        li, ui = bandwidths(pi)
        return alive_idx[permi], li + ui

    all_idx = np.arange(n)
    _, w0 = _interior(all_idx)
    baseline = n * (w0 + 1) ** 2
    best = (baseline, [], None)
    alive = np.ones(n, bool)
    peeled: list[int] = []
    for _ in range(cap):
        deg = (sym & alive[None, :] & alive[:, None]).sum(axis=1)
        deg[~alive] = -1
        v = int(np.argmax(deg))
        if deg[v] <= 1:
            break
        peeled.append(v)
        alive[v] = False
        k = len(peeled)
        interior, wi = _interior(np.flatnonzero(alive))
        n_i = n - k
        cost = (
            n_i * (wi + 1) ** 2
            + 2 * k * n_i * (wi + 1)
            + k * k * n_i
            + k**3
        )
        if cost < 0.75 * baseline and cost < best[0]:
            best = (cost, list(peeled), interior)
    return best[1], best[2]


class SparsePlan:
    """Static plan for colored-jvp structured Jacobian construction.

    With ``border='auto'`` (default), patterns whose RCM bandwidth is
    dominated by a few dense rows/columns (arrowheads, hubs) pull those
    ``k_border`` vertices into a border ordered LAST; the Jacobian is then
    gathered into the bordered packed storage of ops/bbd.py and the Newton
    solve runs banded-LU-plus-Schur at O(n w_i^2 + k n w_i + k^3) instead
    of the O(n^3) a bandwidth-only ordering degrades to.  ``k_border == 0``
    keeps the plain RCM-banded plan (packed storage == banded storage).

    Attributes (all host numpy, fixed at setup):
      perm        (n,) permutation (permuted index -> original index);
                  border vertices come last
      inv_perm    (n,)
      k_border    int — border size (0 = plain banded plan)
      colors      (n,) color of each PERMUTED column
      n_colors    int
      seeds       (n_colors, n) jvp seed vectors in ORIGINAL coordinates
      lower/upper bandwidths of the INTERIOR block of the permuted pattern
      row_gather  (w+1+2k, n) original-row index feeding packed slot [r, j]
      col_gather  (w+1+2k, n) color index feeding packed slot [r, j]
      mask        (w+1+2k, n) validity of each packed slot
    """

    def __init__(
        self,
        pattern: np.ndarray,
        permute: bool = True,
        border="auto",
    ):
        pattern = np.asarray(pattern, bool)
        n = pattern.shape[0]
        self.n = n
        border_idx: list = []
        interior = None
        if permute and border and n > 2:
            cap = min(n // 2, 32) if border == "auto" else int(border)
            if cap > 0:
                border_idx, interior = _select_border(pattern, cap)
        self.k_border = k = len(border_idx)
        n_i = n - k
        if k:
            self.perm = np.concatenate(
                [interior, np.asarray(border_idx, np.int64)]
            )
        elif permute:
            self.perm = rcm_permutation(pattern)
        else:
            self.perm = np.arange(n, dtype=np.int64)
        self.inv_perm = np.argsort(self.perm)
        pat_p = pattern[self.perm][:, self.perm]
        # the Newton matrix is I - c J: the diagonal is always structurally
        # present whatever the RHS looks like
        np.fill_diagonal(pat_p, True)
        self.lower, self.upper = bandwidths(pat_p[:n_i, :n_i])
        self.colors = color_columns(pat_p)
        self.n_colors = int(self.colors.max()) + 1 if n else 0
        # seed c hits original columns {perm[j] : colors[j] == c}
        seeds = np.zeros((self.n_colors, n))
        for j in range(n):
            seeds[self.colors[j], self.perm[j]] = 1.0
        self.seeds = seeds
        # packed gather maps (ops/bbd.py layout; k = 0 is plain banded).
        # band region: ab[r, j] = J_p[i_p, j] with i_p = r - upper + j
        w = self.lower + self.upper
        r_idx = np.arange(w + 1)[:, None]
        j_idx = np.arange(n)[None, :]
        i_p = r_idx - self.upper + j_idx
        valid = (i_p >= 0) & (i_p < n_i) & (j_idx < n_i)
        i_p_c = np.clip(i_p, 0, n - 1)
        mask = valid & pat_p[i_p_c, j_idx]
        # J_p[i_p, j] = (J @ seed[colors[j]])[perm[i_p]]
        row_gather = self.perm[i_p_c]
        col_gather = np.broadcast_to(self.colors[None, :], i_p_c.shape).copy()
        if k:
            jj = np.arange(n)
            # border rows [E | C]: packed[w+1+a, j] = J_p[n_i + a, j]
            ec_mask = pat_p[n_i:, :]  # (k, n)
            ec_rows = np.broadcast_to(
                self.perm[n_i:][:, None], (k, n)
            ).copy()
            ec_cols = np.broadcast_to(self.colors[None, :], (k, n)).copy()
            # border columns F^T: packed[w+1+k+a, j] = J_p[j, n_i + a]
            ft_mask = (jj[None, :] < n_i) & pat_p[:, n_i:].T  # (k, n)
            ft_rows = np.broadcast_to(self.perm[None, :], (k, n)).copy()
            ft_cols = np.broadcast_to(
                self.colors[n_i:][:, None], (k, n)
            ).copy()
            mask = np.concatenate([mask, ec_mask, ft_mask], axis=0)
            row_gather = np.concatenate([row_gather, ec_rows, ft_rows], axis=0)
            col_gather = np.concatenate([col_gather, ec_cols, ft_cols], axis=0)
        self.mask = mask
        self.row_gather = row_gather
        self.col_gather = col_gather

    def density_summary(self) -> str:
        w = self.lower + self.upper + 1
        return (
            f"n={self.n} nnz_band_width={w} border={self.k_border} "
            f"colors={self.n_colors} (dense would be n={self.n} columns)"
        )


def plan_sparse_jacobian(pattern: np.ndarray, permute: bool = True) -> SparsePlan:
    """Build the static plan; see :class:`SparsePlan`."""
    return SparsePlan(pattern, permute=permute)


def make_colored_banded_jac(rhs, plan: SparsePlan):
    """Jacobian function returning the plan's packed storage
    (``ab[r, j] = J_p[r - upper + j, j]`` in the permuted coordinates, the
    BBD border rows after the band), ``(w+1+2k, n, ...)``, from
    ``plan.n_colors`` jvps of ``rhs`` and one masked gather.

    ``rhs(t, y (n, ...), p)`` takes the state in the original coordinates
    and any trailing batch dims; each lane's jvp takes its own tangent."""
    cache: dict = {}

    def maps(device, dtype):
        key = (device, dtype)
        if key not in cache:
            cache[key] = (
                torch.as_tensor(plan.seeds, dtype=dtype, device=device),
                torch.as_tensor(plan.row_gather, device=device),
                torch.as_tensor(plan.col_gather, device=device),
                torch.as_tensor(plan.mask, device=device),
            )
        return cache[key]

    def jac_banded(t, y, p):
        seeds, row_g, col_g, mask = maps(y.device, y.dtype)
        tail = (1,) * (y.ndim - 1)
        Jv = torch.stack([
            torch.broadcast_to(
                forward_ad.jvp(lambda yy: rhs(t, yy, p), (y,),
                               (s.reshape((-1,) + tail).expand(y.shape),))[1],
                y.shape,
            )
            for s in seeds
        ])  # (n_colors, n, ...) in the original rows
        return torch.where(mask.reshape(mask.shape + tail), Jv[col_g, row_g], 0.0)

    return jac_banded
