"""Per-lane observation grids, ``tvals (B, n_t)``, in sunode_torch's batched
cores against the JAX package's: the counterparts of
``tests/test_per_lane_tvals.py``'s batched-core cases (:50 BDF, :64 Adams,
:78 the padding of ragged grids, :161 terminal roots), each held against the
JAX core's own per-lane solve at the tolerance that file states, with equal
statuses.  The JAX references run once a module, in one compile
(``jax_runs``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunode_tpu.ops.adams_batched import adams_solve_batched as jax_adams
from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_tpu.ops.bdf_batched import bdf_solve_batched as jax_bdf
from sunode_torch.entry import build_lv_per_lane, lv_per_lane_tvals
from sunode_torch.ops.adams_batched import adams_solve_batched
from sunode_torch.ops.bdf import STATUS, BDFOptions
from sunode_torch.ops.bdf_batched import bdf_solve_batched
from sunode_torch.wrappers.as_torch import make_batched_solve_fn

B = 4
OPTS = dict(rtol=1e-9, atol=1e-11)
PADDED = np.array([
    [1.0, 2.0, 3.0, 3.0, 3.0],
    [0.5, 1.5, 2.5, 3.5, 4.5],
    [2.0, 4.0, 4.0, 4.0, 4.0],
    [1.0, 1.1, 1.2, 1.3, 6.0],
])
W = np.array([1.0, 1.3, 0.7])  # the oscillators of the root case
T_STAR = np.pi / (2 * W)  # their first roots


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: torch is faster on one CPU thread; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    """The reference file's draws: (y0 (4, 2), ps (4, 1), tvals (4, 6))."""
    rng = np.random.default_rng(0)
    y0 = np.tile([10.0, 5.0], (B, 1)) + rng.random((B, 2))
    ps = 1.0 + 0.1 * rng.random((B, 1))
    tv = np.sort(rng.uniform(0.5, 8.0, (B, 6)), axis=1)
    return y0, ps, tv


def _jax_rhs(t, y, p):
    return jnp.array([p[0] * y[0] - 0.3 * y[0] * y[1], 0.4 * y[0] * y[1] - y[1]])


def _jax_jac(t, y, p):
    return jnp.array([[p[0] - 0.3 * y[1], -0.3 * y[0]], [0.4 * y[1], 0.4 * y[0] - 1.0]])


def _rhs(t, y, p):
    return torch.stack([p[0] * y[0] - 0.3 * y[0] * y[1], 0.4 * y[0] * y[1] - y[1]])


def _jac(t, y, p):
    return torch.stack([torch.stack([p[0] - 0.3 * y[1], -0.3 * y[0]]),
                        torch.stack([0.4 * y[1], 0.4 * y[0] - 1.0])])


def _osc_tvals():
    return np.stack([np.array([0.5, 0.9, 1.5]) * ts for ts in T_STAR])


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """The JAX cores' per-lane solves, once: BDF and Adams on the drawn
    grids, BDF on the padded grids, and BDF with the terminal root."""
    opts = JaxOptions(**OPTS)

    def run(y0, ps, tv, padded, osc_y0, osc_w, osc_tv):
        out = {
            "bdf": jax_bdf(_jax_rhs, _jax_jac, 0.0, y0, ps, tv, opts),
            "adams": jax_adams(_jax_rhs, 0.0, y0, ps, tv, opts),
            "padded": jax_bdf(_jax_rhs, _jax_jac, 0.0, y0, ps, padded, opts),
            "roots": jax_bdf(
                lambda t, y, p: jnp.array([y[1], -p[0] ** 2 * y[0]]),
                lambda t, y, p: jnp.array([[0.0, 1.0], [-p[0] ** 2, 0.0]]),
                0.0, osc_y0, osc_w, osc_tv, opts, root_fn=lambda t, y, p: y[:1]),
        }
        return {k: (r.ys, r.status, r.stats.get("roots_t")) for k, r in out.items()}

    args = (*inputs, PADDED, np.tile([1.0, 0.0], (3, 1)), W[:, None], _osc_tvals())
    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(*(jnp.asarray(a) for a in args)))


def _port(core, inputs, tvals=None, **kw):
    y0, ps, tv = (torch.as_tensor(a) for a in inputs)
    tv = tv if tvals is None else torch.as_tensor(tvals)
    if core == "bdf":
        return bdf_solve_batched(_rhs, _jac, 0.0, y0, ps, tv, BDFOptions(**OPTS), **kw)
    return adams_solve_batched(_rhs, 0.0, y0, ps, tv, BDFOptions(**OPTS), **kw)


@pytest.mark.parametrize("core, rtol, atol", [("bdf", 1e-7, 1e-9), ("adams", 1e-5, 1e-7)])
def test_per_lane_tvals_match_jax(inputs, jax_runs, core, rtol, atol):
    """test_per_lane_tvals.py:50 (BDF, rtol 1e-7 / atol 1e-9) and :64 (Adams,
    rtol 1e-5 / atol 1e-7): each lane emits on its own grid; statuses 0 and
    ys within those tolerances of the JAX core's."""
    res = _port(core, inputs)
    ys_j, status_j, _ = jax_runs[core]
    assert (res.status.numpy() == 0).all() and (status_j == 0).all()
    np.testing.assert_allclose(res.ys.numpy(), ys_j, rtol=rtol, atol=atol)


def test_ragged_grid_padding_convention(inputs, jax_runs):
    """test_per_lane_tvals.py:78: a lane with fewer observations pads with
    copies of its last time, and its padded slots repeat the last value
    (here bit for bit); the JAX core's within rtol 1e-7 / atol 1e-9."""
    res = _port("bdf", inputs, PADDED)
    assert (res.status.numpy() == 0).all()
    ys = res.ys.numpy()
    assert (ys[0, 3:] == ys[0, 2]).all() and (ys[2, 2:] == ys[2, 1]).all()
    np.testing.assert_allclose(ys, jax_runs["padded"][0], rtol=1e-7, atol=1e-9)


def test_per_lane_tvals_with_terminal_roots(jax_runs):
    """test_per_lane_tvals.py:161: per-lane grids straddling each lane's
    root t* = pi/(2w): each lane stops at its own root (status ROOT_RETURN,
    root time within 1e-8 of t* and of the JAX core's), its grid's points
    before it emitted (y0 = cos(w t) within 1e-8), the one after it NaN."""
    res = bdf_solve_batched(
        lambda t, y, p: torch.stack([y[1], -p[0] ** 2 * y[0]]),
        lambda t, y, p: torch.stack([torch.stack([torch.zeros_like(y[0]), torch.ones_like(y[0])]),
                                     torch.stack([-p[0] ** 2 + 0 * y[0], torch.zeros_like(y[0])])]),
        0.0, torch.as_tensor(np.tile([1.0, 0.0], (3, 1))), torch.as_tensor(W[:, None]),
        torch.as_tensor(_osc_tvals()), BDFOptions(**OPTS), root_fn=lambda t, y, p: y[:1],
    )
    ys_j, status_j, roots_j = jax_runs["roots"]
    assert (res.status.numpy() == STATUS["ROOT_RETURN"]).all()
    assert (status_j == STATUS["ROOT_RETURN"]).all()
    roots = res.stats["roots_t"][:, 0].numpy()
    np.testing.assert_allclose(roots, T_STAR, atol=1e-8)
    np.testing.assert_allclose(roots, roots_j[:, 0], atol=1e-8)
    ys = res.ys.numpy()
    assert np.isfinite(ys[:, :2]).all() and np.isnan(ys[:, 2]).all()
    np.testing.assert_allclose(ys[:, 0, 0], np.cos(W * _osc_tvals()[:, 0]), atol=1e-8)
    np.testing.assert_allclose(ys[:, :2], ys_j[:, :2], rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("core", ["bdf", "adams"])
def test_shared_grid_as_rows_is_the_shared_solve(inputs, core):
    """A per-lane grid whose rows are all the shared grid gives the shared
    solve bit for bit (at rtol = atol = 1e-6: the tolerance does not enter)."""
    tv = inputs[2][0]
    opts = BDFOptions(rtol=1e-6, atol=1e-6)
    y0, ps = (torch.as_tensor(a) for a in inputs[:2])

    def solve(tvals):
        tvals = torch.as_tensor(tvals)
        if core == "bdf":
            return bdf_solve_batched(_rhs, _jac, 0.0, y0, ps, tvals, opts)
        return adams_solve_batched(_rhs, 0.0, y0, ps, tvals, opts)

    shared, rows = solve(tv), solve(np.tile(tv, (B, 1)))
    assert torch.equal(shared.ys, rows.ys) and torch.equal(shared.status, rows.status)


def test_per_lane_tvals_refusals(inputs):
    """A grid of another lane count raises; per-lane grids with injections,
    a stage or a gradient through the wrapper raise NotImplementedError,
    as they are not the reference's either."""
    y0, ps, tv = inputs
    with pytest.raises(ValueError, match="per lane"):
        _port("bdf", inputs, tv[:3])
    with pytest.raises(NotImplementedError, match="per-lane"):
        _port("adams", inputs, inject_times=[1.0],
              inject_deltas=torch.zeros((1, 2, B), dtype=torch.float64))
    from sunode_torch.entry import lv_problem

    solve = make_batched_solve_fn(lv_problem(), method="ADAMS",
                                  adjoint_interpolation="resolve")
    p_sub = torch.tensor([[1.0, 0.3]] * B, dtype=torch.float64, requires_grad=True)
    p_fix = torch.tensor([1.0, 0.4], dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="per-lane"):
        solve(0.0, torch.as_tensor(y0), p_sub, p_fix, torch.as_tensor(tv))
    with torch.no_grad():  # the undifferentiated call takes them
        ys = solve(0.0, torch.as_tensor(y0), p_sub, p_fix, torch.as_tensor(tv))
    assert ys.shape == (B, 6, 2) and torch.isfinite(ys).all()


@pytest.mark.parametrize("method", ["ADAMS", "BDF"])
def test_build_lv_per_lane(method):
    """``entry.build_lv_per_lane`` on the CPU at 8 lanes: 6 to 21 sorted
    times a lane on [0.5, 10], padded with its last; status 0, and every
    padded slot its lane's last value bit for bit."""
    tv = lv_per_lane_tvals(200)
    counts = (tv < tv[:, -1:]).sum(axis=1) + 1
    assert counts.min() >= 6 and counts.max() <= 21 and (np.diff(tv, axis=1) >= 0).all()
    assert tv.min() >= 0.5 and tv.max() <= 10.0
    solve, (y0s, ps, tvals) = build_lv_per_lane(8, method, device="cpu")
    res = solve(y0s, ps, tvals)
    assert (res.status == 0).all() and res.ys.shape == (8, 21, 2)
    for b in range(8):
        last = int((tvals[b] < tvals[b, -1]).sum())
        assert torch.equal(res.ys[b, last:], res.ys[b, last].expand_as(res.ys[b, last:]))
