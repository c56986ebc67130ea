"""Batch-lockstep No-U-Turn Sampler (NUTS) in PyTorch.

Port of ``sunode_tpu/sample/nuts.py``, the sampler end of BASELINE config 4
("LV adjoint gradients inside PyMC NUTS").  The chain axis is explicit, so
EVERY gradient evaluation is one call of the *batched* logp across all
chains: with ``make_batched_solve_fn`` as the likelihood, each leapfrog step
runs one batched forward ODE solve and one batched adjoint solve for all
chains together on the card, where the reference's PyMC route forks a
process per chain.

Algorithm: multinomial NUTS (trajectory sampled proportionally to
exp(-H)) with biased progressive doubling, the iterative O(log L)-memory
U-turn bookkeeping (a power-of-two checkpoint stack instead of recursion),
dual-averaging step-size adaptation and windowed diagonal mass-matrix
adaptation.  Design choices for lockstep batching, as the reference's:

  * the doubling depth is a SHARED counter, so all still-active chains
    always build the same-size subtree: the checkpoint-stack slots are
    shared indices into a ``(D + 1, C, d)`` tensor and every subtree is one
    loop over 2^depth leapfrog steps with per-chain masks;
  * the step size is adapted SHARED across chains (from the across-chain
    mean acceptance statistic): per-chain step sizes would desynchronize
    tree sizes and serialize the batch to the deepest lane;
  * a failed ODE solve NaN-poisons logp, which the likelihood maps to
    ``-inf``; energies that are not provably finite are classified
    divergent (leaf weight exp(-inf) = 0), so the proposal is rejected the
    way PyMC NUTS rejects a failed sunode solve.

Where the reference traces ``lax.while_loop``/``lax.fori_loop``/``lax.scan``,
the port runs host loops: the substep index is a Python int, and the exit
test of a doubling, ``any(going) and depth < D``, is its one host sync
besides the likelihood's own.  A subtree stops early once no chain is
active in it: the reference's remaining substeps are masked no-ops.

Random draws come from a draw source whose interface follows the
reference's draw points (:class:`TorchDraws` documents it).  The default is
one CPU ``torch.Generator`` seeded from ``key``; its draws move to the
chains' device, so a run on the card and one on the CPU with the same seed
take the same draws.  No global RNG state is touched.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["nuts_sample", "NUTSResult", "TorchDraws", "ChainRows", "DIVERGENCE_THRESHOLD"]

DIVERGENCE_THRESHOLD = 1000.0


class NUTSResult(NamedTuple):
    samples: torch.Tensor  # (C, S, d)
    logp: torch.Tensor  # (C, S)
    diverging: torch.Tensor  # (C, S) bool
    tree_depth: torch.Tensor  # (C, S) int32
    accept_prob: torch.Tensor  # (C, S)
    step_size: float
    inv_mass: torch.Tensor  # (d,)


class TorchDraws:
    """The default draw source: one CPU ``torch.Generator``, drawn in order.

    A draw source has the reference's draw points as methods, each returning
    CPU tensors that the sampler moves to the chains' device:

      * ``step_size_momentum(shape, dtype)``: the step-size search's
        momentum (``sunode_tpu/sample/nuts.py:325``);
      * ``transition()``: the draws of one transition (the key split of a
        warmup or sampling step, :409, :478), an object with
      * ``momentum(shape, dtype)``: the transition's momentum (:88-89), and
      * ``doubling(C, n_steps, dtype)`` -> ``(forward (C,) bool, leaf_u
        (n_steps, C), merge_u (C,))``: one doubling's direction (:125-128),
        its leaves' uniforms (``fold_in(k_sub, i)``, :170-171) and the
        merge uniform (:240).

    Here ``transition()`` returns the source itself: every draw comes from
    the one generator in the order the sampler asks for them.  A doubling
    draws all its leaves' uniforms at once, so a subtree that stops early
    leaves the stream where a full one would.
    """

    def __init__(self, seed_or_generator):
        if isinstance(seed_or_generator, torch.Generator):
            if seed_or_generator.device.type != "cpu":
                raise ValueError("the draw source's generator must be a CPU generator")
            self.generator = seed_or_generator
        else:
            self.generator = torch.Generator(device="cpu")
            self.generator.manual_seed(int(seed_or_generator))

    def step_size_momentum(self, shape, dtype) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator, dtype=dtype)

    def transition(self) -> "TorchDraws":
        return self

    def momentum(self, shape, dtype) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator, dtype=dtype)

    def doubling(self, C: int, n_steps: int, dtype):
        forward = torch.rand((C,), generator=self.generator, dtype=torch.float64) < 0.5
        leaf_u = torch.rand((n_steps, C), generator=self.generator, dtype=dtype)
        merge_u = torch.rand((C,), generator=self.generator, dtype=dtype)
        return forward, leaf_u, merge_u


class ChainRows:
    """The rows ``rows`` of another source's draws at ``n_chains`` chains:
    every draw is made at full width and its chain rows taken, so a run over
    a subset of the chains takes those chains' draws of the full run
    (chains are independent within a transition at a fixed step size and
    mass)."""

    def __init__(self, source, n_chains: int, rows):
        self.source, self.n_chains, self.rows = source, int(n_chains), rows

    def step_size_momentum(self, shape, dtype) -> torch.Tensor:
        full = self.source.step_size_momentum((self.n_chains, *tuple(shape)[1:]), dtype)
        return full[self.rows]

    def transition(self) -> "ChainRows":
        return ChainRows(self.source.transition(), self.n_chains, self.rows)

    def momentum(self, shape, dtype) -> torch.Tensor:
        return self.source.momentum((self.n_chains, *tuple(shape)[1:]), dtype)[self.rows]

    def doubling(self, C: int, n_steps: int, dtype):
        forward, leaf_u, merge_u = self.source.doubling(self.n_chains, n_steps, dtype)
        return forward[self.rows], leaf_u[:, self.rows], merge_u[self.rows]


def _draw_source(key):
    """``key`` as a draw source: an int seeds a :class:`TorchDraws`, a CPU
    generator is drawn from, and an object with the draw points is used as
    it is."""
    if isinstance(key, torch.Generator) or isinstance(key, (int, np.integer)):
        return TorchDraws(key)
    if all(hasattr(key, m) for m in ("step_size_momentum", "transition")):
        return key
    raise TypeError(f"key must be an int, a CPU torch.Generator or a draw source, got {key!r}")


def _value_and_grad_batched(logp_fn, q):
    """(C, d) -> logp (C,), grad (C, d) with ONE batched evaluation: one
    backward pass of ``logp.sum()``, the reference's ``vjp`` with ones."""
    q = q.detach().requires_grad_(True)
    with torch.enable_grad():
        logp = logp_fn(q)
        (grad,) = torch.autograd.grad(logp.sum(), q)
    return logp.detach(), grad


def _popcount(i: int) -> int:
    return bin(i).count("1")


def _trailing_zeros(i: int) -> int:
    """Number of trailing zero bits of i (i > 0)."""
    return (i & -i).bit_length() - 1


def _where_rows(mask, new, old):
    return torch.where(mask[:, None], new, old)


def _turn(psum, v_a, v_b):
    return (torch.sum(psum * v_a, dim=1) <= 0) | (torch.sum(psum * v_b, dim=1) <= 0)


def _transition(logp_fn, q0, logp0, grad0, eps, inv_mass, draws, max_treedepth,
                return_leaf=False):
    """One batched NUTS transition for all chains; ``draws`` are one
    transition's (a draw source's ``transition()``), ``eps`` a float or a
    0-d tensor, taken at the chains' type.

    Returns (q, logp, grad, accept_stat (C,), diverged (C,), depth (C,)),
    and with ``return_leaf`` also the proposal's leaf (C,): its signed
    position along the trajectory, 0 the start.
    """
    C, d = q0.shape
    D = int(max_treedepth)
    dev, dt = q0.device, q0.dtype
    eps = float(torch.as_tensor(float(eps), dtype=dt))
    im = inv_mass[None, :]
    sqrt_mass = 1.0 / torch.sqrt(inv_mass)

    p0 = draws.momentum((C, d), dt).to(dev) * sqrt_mass[None, :]
    H0 = -logp0 + 0.5 * torch.sum(p0 * p0 * im, dim=1)

    def leapfrog(q, p, grad, eps_signed):
        p_half = p + 0.5 * eps_signed[:, None] * grad
        q_new = q + eps_signed[:, None] * (im * p_half)
        logp_new, grad_new = _value_and_grad_batched(logp_fn, q_new)
        p_new = p_half + 0.5 * eps_signed[:, None] * grad_new
        return q_new, p_new, logp_new, grad_new

    zeros = torch.zeros((C,), dtype=dt, device=dev)
    qL = qR = q0
    pL = pR = p0
    gL = gR = grad0
    lpL = lpR = logp0
    psum = p0
    prop_q, prop_lp, prop_g = q0, logp0, grad0
    logw = zeros
    going = torch.ones((C,), dtype=torch.bool, device=dev)
    diverged = torch.zeros((C,), dtype=torch.bool, device=dev)
    depth_reached = torch.zeros((C,), dtype=torch.int32, device=dev)
    sum_alpha, n_alpha = zeros, zeros
    posL = posR = prop_pos = torch.zeros((C,), dtype=torch.int64, device=dev)
    one = torch.ones((), dtype=dt, device=dev)

    depth = 0
    while depth < D and bool(going.any()):
        n_steps = 1 << depth
        fwd, leaf_u, merge_u = (x.to(dev) for x in draws.doubling(C, n_steps, dt))
        direction = torch.where(fwd, one, -one)
        eps_signed = eps * direction
        step = torch.where(fwd, 1, -1)

        # subtree start: the tree edge in the chosen direction
        q = _where_rows(fwd, qR, qL)
        p = _where_rows(fwd, pR, pL)
        g = _where_rows(fwd, gR, gL)
        lp = torch.where(fwd, lpR, lpL)
        pos = torch.where(fwd, posR, posL)

        s_psum = torch.zeros((C, d), dtype=dt, device=dev)
        s_logw = torch.full((C,), -torch.inf, dtype=dt, device=dev)
        s_prop_q, s_prop_lp, s_prop_g, s_prop_pos = q, lp, g, pos
        turning = torch.zeros((C,), dtype=torch.bool, device=dev)
        s_div = torch.zeros((C,), dtype=torch.bool, device=dev)
        # U-turn checkpoint stack: per slot (v, cumulative psum before)
        ckpt_v = torch.zeros((D + 1, C, d), dtype=dt, device=dev)
        ckpt_psum = torch.zeros((D + 1, C, d), dtype=dt, device=dev)
        s_sum_alpha, s_n_alpha = zeros, zeros

        for i in range(n_steps):
            active = going & ~turning & ~s_div
            if not bool(active.any()):
                break  # every later substep is masked out in every chain
            q_new, p_new, lp_new, g_new = leapfrog(q, p, g, eps_signed)
            H_new = -lp_new + 0.5 * torch.sum(p_new * p_new * im, dim=1)
            dH = H0 - H_new  # log leaf weight (0 at the start point)
            # NaN-safe divergence: anything not provably small is divergent
            div_new = ~(dH > -DIVERGENCE_THRESHOLD)
            dH_safe = torch.where(div_new, -torch.inf, dH)

            # multinomial within the subtree (progressive)
            logw_new = torch.logaddexp(s_logw, dH_safe)
            take = active & (
                torch.log(leaf_u[i])
                < dH_safe - torch.where(torch.isfinite(logw_new), logw_new, dH_safe)
            )
            psum_before = s_psum
            psum_incl = psum_before + p_new
            v_new = im * p_new

            # ---- iterative U-turn bookkeeping ------------------------------
            # even leaf i starts aligned subintervals: store at slot pc(i);
            # odd leaf i closes subintervals of sizes 2^m, m = 1..tz(i+1),
            # whose start states live in slots [pc(i+1)-1, pc(i+1)-2+tz].
            turning_new = torch.zeros((C,), dtype=torch.bool, device=dev)
            if i % 2 == 0:
                ckpt_v[_popcount(i)] = v_new
                ckpt_psum[_popcount(i)] = psum_before
            else:
                idx_min = _popcount(i + 1) - 1
                for slot in range(idx_min, idx_min + _trailing_zeros(i + 1)):
                    seg = psum_incl - ckpt_psum[slot]
                    turning_new = turning_new | _turn(seg, ckpt_v[slot], v_new)

            alpha = torch.where(torch.isfinite(dH), torch.clamp_max(torch.exp(dH_safe), 1.0), 0.0)
            pos_new = pos + step
            q = _where_rows(active, q_new, q)
            p = _where_rows(active, p_new, p)
            g = _where_rows(active, g_new, g)
            lp = torch.where(active, lp_new, lp)
            pos = torch.where(active, pos_new, pos)
            s_psum = _where_rows(active, psum_incl, s_psum)
            s_logw = torch.where(active, logw_new, s_logw)
            s_prop_q = _where_rows(take, q_new, s_prop_q)
            s_prop_lp = torch.where(take, lp_new, s_prop_lp)
            s_prop_g = _where_rows(take, g_new, s_prop_g)
            s_prop_pos = torch.where(take, pos_new, s_prop_pos)
            turning = turning | (active & turning_new)
            s_div = s_div | (active & div_new)
            s_sum_alpha = s_sum_alpha + torch.where(active, alpha, 0.0)
            s_n_alpha = s_n_alpha + active.to(dt)

        # ---- merge subtree into tree (biased progressive doubling) --------
        complete = going & ~turning & ~s_div
        # biased: take the new half with prob min(1, w_sub / w_tree)
        take = complete & (torch.log(merge_u) < s_logw - logw)
        right, left = complete & fwd, complete & ~fwd

        qR = _where_rows(right, q, qR)
        pR = _where_rows(right, p, pR)
        gR = _where_rows(right, g, gR)
        lpR = torch.where(right, lp, lpR)
        posR = torch.where(right, pos, posR)
        qL = _where_rows(left, q, qL)
        pL = _where_rows(left, p, pL)
        gL = _where_rows(left, g, gL)
        lpL = torch.where(left, lp, lpL)
        posL = torch.where(left, pos, posL)

        psum = _where_rows(complete, psum + s_psum, psum)
        turn_glob = _turn(psum, im * pL, im * pR)
        logw = torch.where(complete, torch.logaddexp(logw, s_logw), logw)

        going = complete & ~turn_glob
        prop_q = _where_rows(take, s_prop_q, prop_q)
        prop_lp = torch.where(take, s_prop_lp, prop_lp)
        prop_g = _where_rows(take, s_prop_g, prop_g)
        prop_pos = torch.where(take, s_prop_pos, prop_pos)
        diverged = diverged | s_div
        depth_reached = depth_reached + complete.to(torch.int32)
        sum_alpha = sum_alpha + s_sum_alpha
        n_alpha = n_alpha + s_n_alpha
        depth += 1

    accept_stat = sum_alpha / torch.clamp_min(n_alpha, 1.0)
    out = (prop_q, prop_lp, prop_g, accept_stat, diverged, depth_reached)
    return out + (prop_pos,) if return_leaf else out


class _DAState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_stat: torch.Tensor
    mu: torch.Tensor
    t: torch.Tensor


def _da_init(eps0, dtype=None):
    """The dual-averaging state, 0-d CPU tensors at ``dtype`` (by default
    ``eps0``'s, float64 for a Python float): the type follows the chains,
    so a float32 batch adapts in float32 as the reference's does."""
    if torch.is_tensor(eps0):
        eps0 = eps0.detach().to("cpu", dtype or eps0.dtype)
    else:
        eps0 = torch.tensor(eps0, dtype=dtype or torch.float64)
    return _DAState(
        log_eps=torch.log(eps0),
        log_eps_avg=torch.log(eps0),
        h_stat=torch.zeros((), dtype=eps0.dtype),
        mu=torch.log(10.0 * eps0),
        t=torch.zeros((), dtype=eps0.dtype),
    )


def _da_update(da: _DAState, accept_mean, target):
    gamma, t0, kappa = 0.05, 10.0, 0.75
    accept_mean = torch.as_tensor(accept_mean).to("cpu", da.t.dtype)
    t = da.t + 1.0
    w = 1.0 / (t + t0)
    h_stat = (1 - w) * da.h_stat + w * (target - accept_mean)
    log_eps = da.mu - torch.sqrt(t) / gamma * h_stat
    eta = t ** (-kappa)
    log_eps_avg = eta * log_eps + (1 - eta) * da.log_eps_avg
    return _DAState(log_eps, log_eps_avg, h_stat, da.mu, t)


def _find_reasonable_step_size(logp_fn, q, logp, grad, inv_mass, draws, eps0):
    """Crude doubling/halving search for eps with joint accept prob ~ 0.5
    (mean over chains), bounded to 30 iterations; ``draws`` a draw source.
    Returns eps as a 0-d CPU tensor of the chains' type."""
    C, d = q.shape
    im = inv_mass[None, :]
    sqrt_mass = 1.0 / torch.sqrt(inv_mass)
    p = draws.step_size_momentum((C, d), q.dtype).to(q.device) * sqrt_mass[None, :]
    H0 = -logp + 0.5 * torch.sum(p * p * im, dim=1)

    def accept_mean(eps):
        eps = float(eps)
        p_half = p + 0.5 * eps * grad
        q1 = q + eps * im * p_half
        lp1, g1 = _value_and_grad_batched(logp_fn, q1)
        p1 = p_half + 0.5 * eps * g1
        H1 = -lp1 + 0.5 * torch.sum(p1 * p1 * im, dim=1)
        a = torch.exp(torch.clamp_max(H0 - H1, 0.0))
        return float(torch.mean(torch.where(torch.isfinite(a), a, 0.0)))

    eps = torch.tensor(eps0, dtype=q.dtype)
    a = accept_mean(eps)
    up = a > 0.5
    it = 0
    # the reference's while_loop tests accept_mean at the current eps, then
    # doubles or halves it; its first test repeats a0's evaluation
    while (a > 0.5 if up else a < 0.5) and it < 30 and 1e-10 < float(eps) < 1e10:
        eps = eps * (2.0 if up else 0.5)
        it += 1
        if not (it < 30 and 1e-10 < float(eps) < 1e10):
            break  # the loop ends here whatever accept_mean says
        a = accept_mean(eps)
    return eps


def nuts_sample(
    logp_fn: Callable,
    key,
    init: torch.Tensor,  # (C, d) initial positions, one row per chain
    *,
    num_warmup: int = 400,
    num_samples: int = 400,
    max_treedepth: int = 8,
    target_accept: float = 0.8,
    initial_step_size: float = 0.1,
    adapt_mass: bool = True,
    inv_mass: Optional[torch.Tensor] = None,
    dispatch_chunk: Optional[int] = None,
) -> NUTSResult:
    """Sample with multinomial NUTS; all chains advance in lockstep and every
    gradient is one batched ``logp_fn`` evaluation.

    ``logp_fn``: (C, d) -> (C,) batched log density, differentiable through
    ``torch.autograd`` (e.g. a closure over ``make_batched_solve_fn``; see
    ``entry.build_lv_nuts``).  The chains run on ``init``'s device and at
    its type.  ``key`` is an int seed, a CPU ``torch.Generator`` or a draw
    source (:class:`TorchDraws`).  Returns draws AFTER warmup.  Warmup
    schedule: dual-averaging throughout; with ``adapt_mass`` the diagonal
    mass matrix is re-estimated from the middle warmup window [0.25, 0.75]
    (Welford, pooled across chains) and dual averaging restarts at the
    window end — a compact version of Stan's windowed scheme.

    ``dispatch_chunk`` is accepted for the reference's call sites and
    changes nothing: there it splits the warmup and sampling scans into
    device programs of at most that many draws, bitwise identical to the
    unchunked run; here every transition is its own host loop already.
    """
    del dispatch_chunk
    init = torch.as_tensor(init).detach()
    C, d = init.shape
    dtype, device = init.dtype, init.device
    if inv_mass is None:
        inv_mass = torch.ones((d,), dtype=dtype, device=device)
    else:
        inv_mass = torch.as_tensor(inv_mass).to(device, dtype)
    draws = _draw_source(key)

    logp0, grad0 = _value_and_grad_batched(logp_fn, init)
    eps0 = _find_reasonable_step_size(logp_fn, init, logp0, grad0, inv_mass, draws,
                                      initial_step_size)

    w_lo = int(0.25 * num_warmup)
    w_hi = int(0.75 * num_warmup)
    q, lp, g = init, logp0, grad0
    da = _da_init(eps0)
    im = inv_mass
    # Welford over the adaptation window, pooled across chains
    w_n = torch.zeros((), dtype=dtype, device=device)
    w_mean = torch.zeros((d,), dtype=dtype, device=device)
    w_m2 = torch.zeros((d,), dtype=dtype, device=device)
    for i in range(num_warmup):
        q, lp, g, acc, _, _ = _transition(logp_fn, q, lp, g, torch.exp(da.log_eps), im,
                                          draws.transition(), max_treedepth)
        acc_mean = torch.mean(torch.where(torch.isfinite(acc), acc, 0.0))
        da = _da_update(da, acc_mean, target_accept)
        if w_lo <= i < w_hi:
            n_new = w_n + C
            delta = q - w_mean[None, :]
            mean_new = w_mean + torch.sum(delta, dim=0) / n_new
            w_m2 = w_m2 + torch.sum(delta * (q - mean_new[None, :]), dim=0)
            w_n, w_mean = n_new, mean_new
        # window end: swap in the estimated mass, restart dual averaging
        if adapt_mass and i == w_hi:
            n = w_n
            var = w_m2 / torch.clamp_min(n - 1, 1)
            # Stan-style regularization toward unit; an (effectively) empty
            # window (n < 2, e.g. a tiny num_warmup) must leave the mass
            # matrix untouched rather than install the bare regularizer
            var_reg = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
            im = torch.where((n >= 2) & (var_reg > 0), var_reg, im)
            da = _da_init(torch.exp(da.log_eps))
    eps_final = torch.exp(da.log_eps_avg)

    qs, lps, divs, depths, accs = [], [], [], [], []
    for _ in range(num_samples):
        q, lp, g, acc, div, depth = _transition(logp_fn, q, lp, g, eps_final, im,
                                                draws.transition(), max_treedepth)
        qs.append(q)
        lps.append(lp)
        divs.append(div)
        depths.append(depth)
        accs.append(acc)

    def stack(xs, tail, kind):
        if xs:
            return torch.stack(xs, dim=1)
        return torch.zeros((C, 0) + tail, dtype=kind, device=device)

    return NUTSResult(
        samples=stack(qs, (d,), dtype),
        logp=stack(lps, (), dtype),
        diverging=stack(divs, (), torch.bool),
        tree_depth=stack(depths, (), torch.int32),
        accept_prob=stack(accs, (), dtype),
        step_size=float(eps_final),
        inv_mass=im,
    )
