"""MCMC convergence diagnostics (numpy post-processing).

Split-Rhat and bulk ESS per Vehtari et al. (2021) "Rank-normalization,
folding, and localization", simplified: split chains in half, compute the
classic potential scale reduction over the 2C half-chains, and a
pairwise-geyer autocorrelation ESS.  These serve the sampler tests
(parameter recovery + Rhat ~ 1) — the analog of what a PyMC user gets from
arviz when sampling through the reference (README.md "Usage in PyMC").

A copy of ``sunode_tpu/sample/diagnostics.py`` (numpy only), kept in the
port so that nothing here imports the JAX package; a tensor argument is
taken as numpy (copied off its device first).
"""

from __future__ import annotations

import numpy as np

__all__ = ["split_rhat", "ess_bulk"]


def _as_numpy(samples) -> np.ndarray:
    if hasattr(samples, "detach"):  # a torch tensor, possibly on the card
        samples = samples.detach().cpu().numpy()
    return np.asarray(samples)


def _split(x):
    """(C, S, ...) -> (2C, S//2, ...)"""
    C, S = x.shape[:2]
    h = S // 2
    return np.concatenate([x[:, :h], x[:, h : 2 * h]], axis=0)


def split_rhat(samples: np.ndarray) -> np.ndarray:
    """samples (C, S, d) -> split-Rhat (d,)."""
    x = _split(_as_numpy(samples))
    m, n = x.shape[:2]
    chain_mean = x.mean(axis=1)  # (m, d)
    chain_var = x.var(axis=1, ddof=1)  # (m, d)
    B = n * chain_mean.var(axis=0, ddof=1)
    W = chain_var.mean(axis=0)
    var_plus = (n - 1) / n * W + B / n
    return np.sqrt(var_plus / np.where(W > 0, W, 1.0))


def ess_bulk(samples: np.ndarray) -> np.ndarray:
    """samples (C, S, d) -> bulk effective sample size (d,) via the
    initial-monotone-positive-pair estimator (Geyer 1992) on split chains."""
    x = _split(_as_numpy(samples))
    m, n, d = x.shape
    out = np.empty(d)
    for j in range(d):
        xc = x[:, :, j] - x[:, :, j].mean(axis=1, keepdims=True)
        # per-chain autocovariance via FFT
        nfft = 1 << (2 * n - 1).bit_length()
        f = np.fft.rfft(xc, nfft, axis=1)
        acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :n].real / n
        chain_var = acov[:, 0] * n / (n - 1)
        W = chain_var.mean()
        B = n * x[:, :, j].mean(axis=1).var(ddof=1) if m > 1 else 0.0
        var_plus = (n - 1) / n * W + B / n
        if var_plus <= 0:
            out[j] = m * n
            continue
        rho = 1.0 - (W - acov.mean(axis=0)) / var_plus  # (n,)
        # tau = -1 + 2 * sum of initial monotone positive pairs
        tau = max(-1.0 + 2.0 * _pair_sum(rho, n), 1e-8)
        out[j] = m * n / tau
    return out


def _pair_sum(rho, n):
    """sum of monotone positive pairs (rho_0 + rho_1), (rho_2 + rho_3), ..."""
    s = 0.0
    prev = np.inf
    for k in range(0, n - 1, 2):
        pair = rho[k] + rho[k + 1]
        if pair < 0:
            break
        pair = min(pair, prev)
        s += pair
        prev = pair
    return s
