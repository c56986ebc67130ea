"""sunode_torch PECE attempt against the TPU kernel and its f64 reference.

The plain version is what every CPU solve runs; the CUDA kernel is held to
it on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import torch

from sunode_tpu.ops.df64 import DF
from sunode_tpu.ops.pallas_step import (
    adams_pece_attempt_pallas,
    adams_pece_attempt_reference as jax_reference,
)
from sunode_torch.entry import lv_problem
from sunode_torch.ops.adams import FUNCTIONAL_MAXITER
from sunode_torch.ops.pece_step import (
    FUNCTIONAL_ITERS,
    PeceSystem,
    adams_pece_attempt,
    adams_pece_attempt_reference,
)

# the shapes and inputs of tests/test_pallas_step.py
B, n, K, P = 128, 2, 8, 4
LV_P = np.array([1.0, 0.3, 1.0, 0.4])  # alpha, beta, gamma, delta


def lv_rhs_df(t, y):
    a, b, g, d = LV_P
    h_ = y[0]
    l_ = y[1]
    f0 = h_ * a - (h_ * l_) * b
    f1 = (h_ * l_) * d - l_ * g
    return DF(jnp.stack([f0.hi, f1.hi]), jnp.stack([f0.lo, f1.lo]))


def lv_rhs_f64(t, y):
    a, b, g, d = LV_P
    return np.stack([a * y[0] - b * y[0] * y[1], d * y[0] * y[1] - g * y[1]])


def _inputs(seed=0, K=K):
    rng = np.random.default_rng(seed)
    DF64 = rng.standard_normal((K, n, B)) * (0.5 ** np.arange(K))[:, None, None]
    y64 = 1.0 + rng.uniform(0.2, 1.0, (n, B))
    h64 = rng.uniform(0.01, 0.05, B)
    t = np.full(B, 1.5)
    return DF64, y64, h64, t


def _split(x):
    hi = np.float32(x)
    lo = np.float32(np.asarray(x, np.float64) - np.asarray(hi, np.float64))
    return jnp.asarray(hi), jnp.asarray(lo)


def _torch_fixed_sweeps(DF64, y64, h64, t, p):
    """The port in the TPU kernel's mode: FUNCTIONAL_ITERS sweeps, no tests."""
    T = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    params = T(np.broadcast_to(LV_P[:, None], (4, B)).copy())
    return adams_pece_attempt_reference(
        lv_problem().make_rhs(), T(t), T(h64), torch.as_tensor(p, dtype=torch.int32),
        torch.ones(B, dtype=torch.bool), T(DF64), T(y64), params,
        T(np.full(n, 1e-8)), T(np.full(n, 1e-8)), 0.0, FUNCTIONAL_ITERS, n,
    )


def test_plain_matches_f64_reference():
    DF64, y64, h64, t = _inputs()
    out = _torch_fixed_sweeps(DF64, y64, h64, t, np.full(B, P))
    y_ref, d_ref, e_ref = jax_reference(lv_rhs_f64, t, DF64, y64, h64, P)
    np.testing.assert_allclose(out.y_it.numpy(), y_ref, rtol=1e-12)
    np.testing.assert_allclose(out.d_fz.numpy(), d_ref, rtol=1e-12)
    np.testing.assert_allclose(out.err.numpy(), e_ref, rtol=1e-12)
    assert out.conv.all() and (out.niter == FUNCTIONAL_ITERS).all()


def test_plain_matches_pallas_kernel_interpret():
    DF64, y64, h64, t = _inputs(1)
    dfh, dfl = _split(DF64)
    yh, yl = _split(y64)
    hh, hl = _split(h64)
    y_hi, y_lo, d_hi, d_lo, e_hi, e_lo = adams_pece_attempt_pallas(
        lv_rhs_df, jnp.asarray(t, jnp.float32), dfh, dfl, yh, yl, hh, hl, P,
        interpret=True,
    )
    # the kernel's inputs are the f32 pairs: hand the port the same values
    as64 = lambda hi, lo: np.asarray(hi, np.float64) + np.asarray(lo, np.float64)  # noqa: E731
    out = _torch_fixed_sweeps(as64(dfh, dfl), as64(yh, yl), as64(hh, hl), t, np.full(B, P))
    y_got = np.asarray(y_hi, np.float64) + np.asarray(y_lo, np.float64)
    # interpret mode contracts FP expressions: the bound of test_pallas_step
    err = np.abs(y_got - out.y_it.numpy()) / np.abs(out.y_it.numpy())
    assert err.max() < 1e-7, f"max rel err {err.max():.2e}"
    d_got = np.asarray(d_hi, np.float64) + np.asarray(d_lo, np.float64)
    d_ref = out.d_fz.numpy()
    assert (np.abs(d_got - d_ref) / np.abs(d_ref).max()).max() < 1e-6


def test_mixed_per_lane_order_matches_static_reference():
    DF64, y64, h64, t = _inputs(2, K=9)  # KAB = 9: orders up to 6
    p = np.random.default_rng(3).integers(1, 7, B)
    out = _torch_fixed_sweeps(DF64, y64, h64, t, p)
    for q in range(1, 7):
        lanes = p == q
        y_ref, d_ref, e_ref = jax_reference(lv_rhs_f64, t, DF64, y64, h64, q)
        np.testing.assert_allclose(out.y_it.numpy()[:, lanes], y_ref[:, lanes], rtol=1e-12)
        np.testing.assert_allclose(out.d_fz.numpy()[:, lanes], d_ref[:, lanes], rtol=1e-12)
        np.testing.assert_allclose(out.err.numpy()[:, lanes], e_ref[:, lanes], rtol=1e-12)


def _main_path_case(seed):
    rng = np.random.default_rng(seed)
    KAB = 9
    DF64 = rng.standard_normal((KAB, n, B)) * (0.5 ** np.arange(KAB))[:, None, None]
    f64 = dict(dtype=torch.float64)
    params = np.array([1.0, 0.3, 1.0, 0.4])[:, None] * (1 + 0.1 * rng.standard_normal((4, B)))
    return (
        torch.as_tensor(rng.uniform(0.0, 10.0, B), **f64),
        torch.as_tensor(10.0 ** rng.uniform(-6, -2, B), **f64),
        torch.as_tensor(rng.integers(1, 7, B), dtype=torch.int32),
        torch.as_tensor(rng.uniform(size=B) < 0.9),
        torch.as_tensor(DF64, **f64),
        torch.as_tensor(1.0 + rng.uniform(0.2, 1.0, (n, B)), **f64),
        torch.as_tensor(params, **f64),
        torch.full((n,), 1e-8, **f64),
        torch.full((n,), 1e-8, **f64),
        1e-4,
        FUNCTIONAL_MAXITER,
    )


def test_wrapper_takes_plain_path_on_cpu():
    problem = lv_problem()
    system = PeceSystem(fz=problem.make_rhs(), n=n, nz=n)  # no device system
    args = _main_path_case(5)
    before = adams_pece_attempt.launches
    out = adams_pece_attempt(system, *args)
    ref = adams_pece_attempt_reference(problem.make_rhs(), *args, n)
    assert adams_pece_attempt.launches == before == 0
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    # the main-path corrector really iterates and tests per lane
    assert 0 < int(out.conv.sum()) <= B and int(out.niter.max()) > 1
