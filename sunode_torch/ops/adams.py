"""Adams-Moulton coefficient tables (from ``sunode_tpu/ops/adams.py``).

Backward-difference form: the predictor is
``y_pred = y_prev + h * sum_{i<p} gamma_i DF[i]``, the corrector
``y_n = y_pred + h * gamma_{p-1} * d_f`` and the local error
``h * gamma*_p * d_f``.  The tables are computed by the same numpy code as
the reference, so the numbers are identical bit for bit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ADAMS_MAX_ORDER", "FUNCTIONAL_MAXITER", "_GAMMA", "_GAMMA_STAR", "_C_INT"]

ADAMS_MAX_ORDER = 12
FUNCTIONAL_MAXITER = 4


def _adams_gammas():
    """Adams-Bashforth gammas (backward-difference form) and Moulton gammas.

    gamma_m: 1, 1/2, 5/12, 3/8, ...   via gamma_m = 1 - sum_{k<m} gamma_k/(m+1-k)
    gamma*_m = gamma_m - gamma_{m-1}  (error constants)."""
    K = ADAMS_MAX_ORDER + 2
    g = np.zeros(K)
    for m in range(K):
        g[m] = 1.0 - sum(g[k] / (m + 1 - k) for k in range(m))
    gs = np.empty(K)
    gs[0] = 1.0
    gs[1:] = g[1:] - g[:-1]
    return g, gs


_GAMMA, _GAMMA_STAR = _adams_gammas()


def _integral_basis_coeffs():
    """Coefficients of c_i(s) = integral_0^s prod_{m<i}(u+m)/(m+1) du.

    c_i is a degree-(i+1) polynomial; returns a (K, K+2) nested tuple of
    monomial coefficients (ascending powers) for i = 0..K-1."""
    K = ADAMS_MAX_ORDER + 1
    out = np.zeros((K, K + 2))
    for i in range(K):
        poly = np.polynomial.Polynomial([1.0])
        for m in range(i):
            poly = poly * np.polynomial.Polynomial([m, 1.0]) / (m + 1)
        coefs = poly.integ().coef
        out[i, : len(coefs)] = coefs
    return tuple(tuple(float(c) for c in row) for row in out)


_C_INT = _integral_basis_coeffs()
