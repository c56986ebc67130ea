"""sunode_torch's batch-lockstep NUTS and diagnostics against sunode_tpu's.

Every random draw of the port's sampler goes through a draw source; here it
is one that replays the reference's key tree (``jax.random`` in this file,
at the reference's draw points), so both samplers take the same draws:

  * ``split_rhat`` and ``ess_bulk``: bit for bit;
  * ``_da_update`` over a seeded sequence of accept means: 1e-15 relative
    (``t ** -kappa`` is the libraries' ``pow``, ROADMAP C1);
  * ``_find_reasonable_step_size``, ``_transition`` and a short
    ``nuts_sample`` on the correlated Gaussian of ``tests/test_nuts.py``:
    draws, logp, grad, accept statistics, step size and ``inv_mass`` within
    1e-12 relative (float64), tree depth and divergence equal; float32
    within 1e-5;
  * a log density that is ``-inf`` on a half-space: divergences equal;
  * one Lotka-Volterra transition through the port's batched ADAMS
    transition adjoint on the CPU against the reference's over its
    ``make_batched_solve_fn``: 1e-8, depth and divergence equal.

Each JAX reference is computed inside the one test that reads it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunode_tpu.sample import diagnostics as ref_diag
from sunode_tpu.sample import nuts as rn
from sunode_torch.sample import diagnostics as port_diag
from sunode_torch.sample import nuts as pn

jax.config.update("jax_enable_x64", True)

COV = np.array([[4.0, 1.0, 0.0], [1.0, 1.0, 0.3], [0.0, 0.3, 0.25]])
PREC = np.linalg.inv(COV)
MU = np.array([1.0, -2.0, 0.5])
F64_REL = 1e-12
F32_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The chains are a few values each: one CPU thread is faster than
    many; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_dtype(dtype):
    return {torch.float64: np.float64, torch.float32: np.float32}[dtype]


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _doubling_draws(key, C, n_steps, dtype):
    # nuts.py:121-128, 170-171, 240
    key, k_dir, k_take, k_sub = jax.random.split(key, 4)
    forward = jax.random.bernoulli(k_dir, 0.5, (C,))
    leaf_u = jnp.stack([jax.random.uniform(jax.random.fold_in(k_sub, i), (C,), dtype)
                        for i in range(n_steps)])
    return key, forward, leaf_u, jax.random.uniform(k_take, (C,), dtype)


class ReplayTransition:
    """The draws of one reference transition from its key ``key``."""

    def __init__(self, key):
        self.key = key

    def momentum(self, shape, dtype):
        self.key, k_mom = jax.random.split(self.key)  # nuts.py:88-89
        return torch.tensor(np.asarray(jax.random.normal(k_mom, tuple(shape), _np_dtype(dtype))))

    def doubling(self, C, n_steps, dtype):
        self.key, forward, leaf_u, merge_u = _doubling_draws(self.key, C, n_steps,
                                                             np.dtype(_np_dtype(dtype)))
        return tuple(torch.tensor(np.asarray(x)) for x in (forward, leaf_u, merge_u))


class Replay:
    """The draws of the reference's ``nuts_sample(logp, seed, ...)``: the
    step-size search's key and one transition key a warmup or sampling step
    (nuts.py:399, :409, :478)."""

    def __init__(self, seed):
        self.key, self.k_eps = jax.random.split(jax.random.PRNGKey(seed))

    def step_size_momentum(self, shape, dtype):
        return torch.tensor(np.asarray(jax.random.normal(self.k_eps, tuple(shape),
                                                         _np_dtype(dtype))))

    def transition(self):
        self.key, k_t = jax.random.split(self.key)
        return ReplayTransition(k_t)


def _jax_gauss(dtype=jnp.float64, half_space=None):
    prec, mu = jnp.asarray(PREC, dtype), jnp.asarray(MU, dtype)

    def logp(q):  # tests/test_nuts.py:23-33
        r = q - mu[None, :]
        lp = -0.5 * jnp.einsum("ci,ij,cj->c", r, prec, r)
        if half_space is not None:
            lp = jnp.where(q[:, 0] > half_space, -jnp.inf, lp)
        return lp

    return logp


def _torch_gauss(dtype=torch.float64, half_space=None):
    prec, mu = torch.tensor(PREC, dtype=dtype), torch.tensor(MU, dtype=dtype)

    def logp(q):
        r = q - mu[None, :]
        lp = -0.5 * torch.einsum("ci,ij,cj->c", r, prec, r)
        if half_space is not None:
            lp = torch.where(q[:, 0] > half_space, -torch.inf, lp)
        return lp

    return logp


def _rel(got, want):
    """Worst |got - want| / |want| elementwise (0 where both are equal,
    infinities included)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.where(same, 0.0, np.abs(got - want) / np.abs(want))
    return float(np.max(rel, initial=0.0))


def _normwise(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _init(C, d=3, dtype=np.float64, seed=0):
    return (np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (C, d))) * 0.5).astype(dtype)


def _check_transition(ref, got, rel):
    """The reference's 6-tuple against the port's, field by field."""
    q, lp, g, acc, div, depth = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(got[4].numpy(), div)
    np.testing.assert_array_equal(got[5].numpy(), depth)
    assert got[5].dtype == torch.int32 and got[4].dtype == torch.bool
    assert _normwise(got[0].numpy(), q) <= rel
    assert _rel(got[1].numpy(), lp) <= rel
    assert _normwise(got[2].numpy(), g) <= rel
    assert _rel(got[3].numpy(), acc) <= rel


# ---- diagnostics ---------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(4, 100, 2), (2, 51, 3), (8, 200, 1), (1, 40, 2)])
def test_diagnostics_bit_for_bit(shape):
    """split_rhat and ess_bulk equal the reference's bit for bit on seeded
    (C, S, d) draws (an autocorrelated walk, so the Geyer pairs matter), and
    take a tensor as its values."""
    rng = np.random.default_rng(sum(shape))
    x = np.cumsum(rng.standard_normal(shape), axis=1) * 0.1 + rng.standard_normal(shape)
    np.testing.assert_array_equal(port_diag.split_rhat(x), ref_diag.split_rhat(x))
    np.testing.assert_array_equal(port_diag.ess_bulk(x), ref_diag.ess_bulk(x))
    np.testing.assert_array_equal(port_diag.ess_bulk(torch.tensor(x)), ref_diag.ess_bulk(x))


# ---- dual averaging ------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_da_update_sequence(dtype):
    """The dual-averaging state over 50 seeded accept means, restarted at
    step 30 as at the mass swap, against the reference's: 1e-15 relative at
    float64 (its ``t ** -kappa`` is XLA's pow), 1e-6 at float32, and at the
    chains' type throughout."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    means = np.random.default_rng(5).uniform(0.0, 1.0, 50)
    ref = rn._da_init(jnp.asarray(0.25, jdt))
    got = pn._da_init(torch.tensor(0.25, dtype=dtype))
    tol = 1e-15 if dtype == torch.float64 else 1e-6
    update = jax.jit(rn._da_update)
    for i, m in enumerate(means):
        ref = update(ref, jnp.asarray(m, jdt), 0.8)
        got = pn._da_update(got, torch.tensor(m, dtype=dtype), 0.8)
        if i == 30:
            ref = rn._da_init(jnp.exp(ref.log_eps))
            got = pn._da_init(torch.exp(got.log_eps))
        for a, b in zip(ref, got):
            assert b.dtype == dtype and b.device.type == "cpu"
            assert _rel(b.numpy(), np.asarray(a)) <= tol, (i, a, b)


# ---- the correlated Gaussian ---------------------------------------------------------
def test_find_reasonable_step_size():
    """The doubling/halving search from 0.1 (it halves) and from 1e-3 (it
    doubles) with the reference's momentum key: the same step size."""
    C = 4
    q0 = _init(C)
    jlogp, tlogp = _jax_gauss(), _torch_gauss()
    lp0, g0 = rn._value_and_grad_batched(jlogp, jnp.asarray(q0))
    tq0 = torch.tensor(q0)
    tlp0, tg0 = pn._value_and_grad_batched(tlogp, tq0)
    search = jax.jit(functools.partial(rn._find_reasonable_step_size, jlogp),
                     static_argnums=(5,))
    for eps0 in (0.1, 1e-3, 4.0):
        key = jax.random.PRNGKey(int(1e3 * eps0))
        want = float(search(jnp.asarray(q0), lp0, g0, jnp.ones(3), key, eps0))

        class Draws:
            def step_size_momentum(self, shape, dtype):
                return torch.tensor(np.asarray(jax.random.normal(key, shape, _np_dtype(dtype))))

        got = pn._find_reasonable_step_size(tlogp, tq0, tlp0, tg0,
                                            torch.ones(3, dtype=torch.float64), Draws(), eps0)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        assert _rel(float(got), want) <= F64_REL, (eps0, float(got), want)


@pytest.mark.parametrize("seed,eps,depth", [(3, 0.3, 6), (7, 0.05, 4), (11, 1.3, 5)])
def test_transition_gaussian_f64(seed, eps, depth):
    """One transition at a fixed step size and unit mass from the
    reference's key: q, logp, grad and the accept statistic within 1e-12
    relative, depth and divergence equal; at 1.3 the trajectories diverge,
    at 0.05 they hit the depth cap."""
    C = 6
    q0 = _init(C, seed=seed)
    jlogp, tlogp = _jax_gauss(), _torch_gauss()
    key = jax.random.PRNGKey(seed)
    lp0, g0 = rn._value_and_grad_batched(jlogp, jnp.asarray(q0))
    ref = jax.jit(lambda q, lp, g, k: rn._transition(jlogp, q, lp, g, eps, jnp.ones(3), k, depth))(
        jnp.asarray(q0), lp0, g0, key)
    tq0 = torch.tensor(q0)
    tlp0, tg0 = pn._value_and_grad_batched(tlogp, tq0)
    got = pn._transition(tlogp, tq0, tlp0, tg0, eps, torch.ones(3, dtype=torch.float64),
                         ReplayTransition(key), depth)
    _check_transition(ref, got, F64_REL)


def test_transition_gaussian_f32():
    """The same transition with every array float32, against the
    reference's float32 run: within 1e-5, at float32 throughout."""
    C = 6
    q0 = _init(C, dtype=np.float32, seed=3)
    jlogp, tlogp = _jax_gauss(jnp.float32), _torch_gauss(torch.float32)
    key = jax.random.PRNGKey(3)
    lp0, g0 = rn._value_and_grad_batched(jlogp, jnp.asarray(q0))
    ref = jax.jit(lambda q, lp, g, k: rn._transition(jlogp, q, lp, g, jnp.float32(0.3),
                                                    jnp.ones(3, jnp.float32), k, 6))(
        jnp.asarray(q0), lp0, g0, key)
    assert np.asarray(ref[0]).dtype == np.float32
    tq0 = torch.tensor(q0)
    tlp0, tg0 = pn._value_and_grad_batched(tlogp, tq0)
    got = pn._transition(tlogp, tq0, tlp0, tg0, 0.3, torch.ones(3, dtype=torch.float32),
                         ReplayTransition(key), 6)
    assert all(x.dtype == torch.float32 for x in got[:4])
    _check_transition(ref, got, F32_REL)


def test_transition_half_space_is_divergent():
    """A log density that is -inf for q0 > 0.6 (a failed solve's, after the
    NaN -> -inf map): the leaves past it are divergent, the proposal never
    lands there, and every field equals the reference's."""
    C = 8
    q0 = _init(C, seed=4) * 0.2
    jlogp, tlogp = _jax_gauss(half_space=0.6), _torch_gauss(half_space=0.6)
    key = jax.random.PRNGKey(4)
    lp0, g0 = rn._value_and_grad_batched(jlogp, jnp.asarray(q0))
    ref = jax.jit(lambda q, lp, g, k: rn._transition(jlogp, q, lp, g, 0.4, jnp.ones(3), k, 6))(
        jnp.asarray(q0), lp0, g0, key)
    tq0 = torch.tensor(q0)
    tlp0, tg0 = pn._value_and_grad_batched(tlogp, tq0)
    got = pn._transition(tlogp, tq0, tlp0, tg0, 0.4, torch.ones(3, dtype=torch.float64),
                         ReplayTransition(key), 6)
    _check_transition(ref, got, F64_REL)
    assert got[4].any() and not got[4].all()
    assert bool((got[0][:, 0] <= 0.6).all()) and bool(torch.isfinite(got[1]).all())


def test_nuts_sample_gaussian_draw_for_draw():
    """A short run, 24 warmup draws (the mass swap and the dual-averaging
    restart at draw 18) and 12 kept, through the replaying source: every
    kept draw within 1e-12 normwise, logp, accept statistics, the adapted
    step size and inv_mass within 1e-12 relative, depth and divergence
    equal.

    Longer runs part further, and not through the port: the reference's XLA
    contracts the leapfrog's ``a * b + c`` into FMAs where torch rounds
    twice, a few ulps a transition, and adapted NUTS amplifies a
    difference in its start about tenfold every five draws.  Measured on
    this target: the reference against itself from a start one ulp apart
    parts by 5.3e-14 / 1.0e-11 / 6.7e-7 normwise after 24+12 / 40+20 /
    80+40 draws, the port against the reference by 1.6e-14 / 3.0e-12 /
    2.0e-7."""
    C = 4
    q0 = _init(C)
    jlogp, tlogp = _jax_gauss(), _torch_gauss()
    ref = rn.nuts_sample(jlogp, 0, jnp.asarray(q0), num_warmup=24, num_samples=12,
                         max_treedepth=6)
    got = pn.nuts_sample(tlogp, Replay(0), torch.tensor(q0), num_warmup=24, num_samples=12,
                         max_treedepth=6)
    assert got.samples.shape == (C, 12, 3) and got.tree_depth.dtype == torch.int32
    np.testing.assert_array_equal(got.tree_depth.numpy(), np.asarray(ref.tree_depth))
    np.testing.assert_array_equal(got.diverging.numpy(), np.asarray(ref.diverging))
    assert _normwise(got.samples.numpy(), ref.samples) <= F64_REL
    assert _rel(got.logp.numpy(), ref.logp) <= F64_REL
    assert _rel(got.accept_prob.numpy(), ref.accept_prob) <= F64_REL
    assert _rel(got.step_size, float(ref.step_size)) <= F64_REL
    assert _rel(got.inv_mass.numpy(), ref.inv_mass) <= F64_REL
    assert not np.allclose(got.inv_mass.numpy(), 1.0)  # the swap happened


def test_nuts_sample_seeds_and_chunks():
    """The default draw source: an int seed and a CPU generator seeded alike
    give the same run; ``dispatch_chunk`` changes nothing, bit for bit, as
    the reference's chunked and unchunked runs; a float32 start samples at
    float32; ``ChainRows`` takes the same chains' draws of a wider run."""
    tlogp = _torch_gauss()
    q0 = torch.tensor(_init(4))
    kw = dict(num_warmup=6, num_samples=4, max_treedepth=4)
    a = pn.nuts_sample(tlogp, 5, q0, **kw)
    b = pn.nuts_sample(tlogp, torch.Generator().manual_seed(5), q0, dispatch_chunk=2, **kw)
    for x, y in zip(a, b):
        if torch.is_tensor(x):
            assert torch.equal(x, y)
        else:
            assert x == y
    f32 = pn.nuts_sample(_torch_gauss(torch.float32), 5, q0.float(), **kw)
    assert f32.samples.dtype == torch.float32 and f32.inv_mass.dtype == torch.float32
    full, rows = pn.TorchDraws(9), pn.ChainRows(pn.TorchDraws(9), 8, slice(2, 5))
    t_full, t_rows = full.transition(), rows.transition()
    assert torch.equal(t_rows.momentum((3, 2), torch.float64),
                       t_full.momentum((8, 2), torch.float64)[2:5])
    for x, y in zip(t_rows.doubling(3, 4, torch.float64), t_full.doubling(8, 4, torch.float64)):
        assert torch.equal(x, y[..., 2:5])
    with pytest.raises(TypeError):
        pn.nuts_sample(tlogp, "seed", q0, **kw)
    assert pn.nuts_sample(tlogp, 5, q0, num_warmup=2, num_samples=0).samples.shape == (4, 0, 3)


# ---- Lotka-Volterra through the batched transition adjoint ---------------------------
LV_TVALS = np.linspace(1.0, 6.0, 4)
LV_RTOL, LV_ADJ_RTOL = 1e-6, 1e-5
LV_REL = 1e-8


def test_lv_transition_through_the_batched_adjoint():
    """BASELINE config 4's log density (``entry.build_lv_nuts``: ADAMS with
    the transition adjoint, max_steps 2,000 / 4,000, here at C = 2, 4 times
    on [1, 6], rtol 1e-6 forward and 1e-5 backward) and one transition at
    max_treedepth 3 against the reference's ``_transition`` over its
    ``make_batched_solve_fn`` logp on the same observations (logp0, grad0
    and the transition in one ``jax.jit``): logp0, grad0, q, logp, grad and
    the accept statistic within 1e-8, depth and divergence equal."""
    from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
    from sunode_tpu.symode import SympyProblem as JaxSympyProblem
    from sunode_tpu.wrappers.as_jax import make_batched_solve_fn as jax_batched
    from sunode_torch.entry import (LV_NUTS_SIGMA, LV_NUTS_TRUE, LV_P_FIX, _lv, build_lv_nuts,
                                    lv_nuts_init)

    C, eps, depth = 2, 0.03, 3
    logp, (init, mu0) = build_lv_nuts(C, device="cpu", tvals=LV_TVALS, rtol=LV_RTOL,
                                      adjoint_rtol=LV_ADJ_RTOL)
    assert init.shape == (C, 2) and init.device.type == "cpu"
    q0 = lv_nuts_init(C, 0.02, seed=1)

    prob = JaxSympyProblem(params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
                           states={"hares": (), "lynx": ()}, rhs_sympy=_lv,
                           derivative_params=[("alpha",), ("beta",)])
    solve = jax_batched(
        prob, derivatives="adjoint", method="ADAMS", adjoint_interpolation="transition",
        options=JaxOptions(rtol=LV_RTOL, atol=LV_RTOL, adams_max_order=6, max_steps=2000),
        adjoint_options=JaxOptions(rtol=LV_ADJ_RTOL, atol=LV_ADJ_RTOL, adams_max_order=6,
                                   max_steps=4000),
    )
    obs_log = jnp.asarray(logp.obs_log.numpy())
    y0s = jnp.broadcast_to(jnp.asarray([10.0, 2.0]), (C, 2))
    p_fix, tvals = jnp.asarray(LV_P_FIX), jnp.asarray(LV_TVALS)
    jmu0 = jnp.log(jnp.asarray(LV_NUTS_TRUE))

    def jlogp(theta):  # scripts/exp_nuts_f32.py:68-77
        ys = solve(0.0, y0s, jnp.exp(theta), p_fix, tvals)
        ys_safe = jnp.maximum(ys, 1e-10)
        loglik = -0.5 * jnp.sum((jnp.log(ys_safe) - obs_log[None]) ** 2 / LV_NUTS_SIGMA**2,
                                axis=(1, 2))
        lp = loglik - 0.5 * jnp.sum((theta - jmu0) ** 2, axis=1)
        return jnp.where(jnp.isfinite(lp), lp, -jnp.inf)

    @jax.jit
    def run(q, key):
        lp0, g0 = rn._value_and_grad_batched(jlogp, q)
        return (lp0, g0) + rn._transition(jlogp, q, lp0, g0, eps, jnp.ones(2), key, depth)

    key = jax.random.PRNGKey(2)
    ref = run(jnp.asarray(q0), key)
    tq0 = torch.tensor(q0)
    tlp0, tg0 = pn._value_and_grad_batched(logp, tq0)
    assert _rel(tlp0.numpy(), ref[0]) <= LV_REL and _normwise(tg0.numpy(), ref[1]) <= LV_REL
    got = pn._transition(logp, tq0, tlp0, tg0, eps, torch.ones(2, dtype=torch.float64),
                         ReplayTransition(key), depth)
    _check_transition(ref[2:], got, LV_REL)
    assert int(got[5].max()) >= 2
