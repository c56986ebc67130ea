"""The split Adams attempt (``sunode_torch/ops/adams_split.py``) and the SIR
workload written in torch.

The three plain stages, composed as ``adams_split_attempt`` composes them
on the CPU, give bit for bit what ``adams_history_attempt_reference`` gives:
they are its operations regrouped at the right-hand-side calls.  Then a
``TorchProblem`` through ``make_batched_solve_fn(method='ADAMS')``: the
golden gate of ``tests/golden/sir_regions.npz`` (the JAX package's
``tests/test_golden.py::test_sir_regions_golden``, same options and
tolerances) and 'resolve' and 'hermite' at R = 4 against ``jax.grad`` of the
JAX package's ``JaxProblem``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_tpu.problem import JaxProblem
from sunode_tpu.wrappers.as_jax import make_batched_solve_fn as jax_make
from sunode_torch.entry import build_sir, lv_problem, sir_problem
from sunode_torch.ops import adams_split
from sunode_torch.ops.adams import _GAMMA_STAR, FUNCTIONAL_MAXITER
from sunode_torch.ops.adams_attempt import adams_history_attempt, adams_history_attempt_reference
from sunode_torch.ops.bdf import BDFOptions
from sunode_torch.ops.pece_step import PeceSystem
from sunode_torch.wrappers.as_torch import make_batched_solve_fn

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
P_MAX = 8  # adams_max_order's default: KAB = 11


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: torch is faster on one CPU thread; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _attempt_case(system, B, seed, nan_lane=False, n_stage=0):
    """Seeded arguments of one attempt: orders 1..P_MAX, 90% of lanes
    active, steps log-uniform in [1e-6, 1] (some too long to converge), step
    ratios log-uniform in [0.2, 2], the parameter rows [LV's 4
    | a staged y(t)]; ``nan_lane`` poisons lane 1's history."""
    rng = np.random.default_rng(seed)
    KAB, nz = P_MAX + 3, system.nz
    DF = rng.standard_normal((KAB, nz, B)) * (0.5 ** np.arange(KAB))[:, None, None]
    if nan_lane:
        DF[2, :, 1] = np.nan
    params = np.array([1.0, 0.3, 1.0, 0.4])[:, None] * (1 + 0.1 * rng.standard_normal((4, B)))
    params = np.concatenate([params, rng.uniform(0.5, 12.0, (n_stage, B))])
    T = torch.as_tensor
    return (
        T(rng.uniform(0.0, 10.0, B)), T(10.0 ** rng.uniform(-6, 0, B)),
        T(np.exp(rng.uniform(np.log(0.2), np.log(2.0), B))),
        T(rng.integers(1, P_MAX + 1, B).astype(np.int32)), T(rng.uniform(size=B) < 0.9),
        T(DF), T(1.0 + rng.uniform(0.2, 1.0, (nz, B))), T(params),
        torch.full((nz,), 1e-8, dtype=torch.float64), torch.full((nz,), 1e-7, dtype=torch.float64),
        T(np.abs(_GAMMA_STAR)), torch.full((nz,), 1.0 / nz, dtype=torch.float64),
    )


def _lv_system(staged):
    problem = lv_problem()
    if not staged:
        return PeceSystem(fz=problem.make_rhs(), n=2, nz=2)
    # the parameter rows are [params | y(t)], as the Adams core passes a
    # stage; the adjoint lambda rows and the two quadrature rows
    aj, qr = problem.make_adjoint_rhs(), problem.make_adjoint_quad_rhs()
    return PeceSystem(
        fz=lambda t, lam, p: torch.cat([-aj(t, p[4:], lam, p[:4]), qr(t, p[4:], lam, p[:4])]),
        n=2, nz=4,
    )


@pytest.mark.parametrize(
    "staged, newton_tol, nan_lane",
    [(False, 3e-4, False), (False, 3e-4, True), (False, 0.0, False), (True, 3e-4, False)],
    ids=["forward", "nan-lane", "fixed-sweeps", "staged"],
)
def test_plain_stages_compose_to_the_history_reference(staged, newton_tol, nan_lane):
    """The split attempt on CPU tensors equals the history attempt's plain
    version bit for bit on every field, at orders 1..8, inactive lanes
    included: with the rate tests, with fixed sweeps (``newton_tol = 0``),
    with a NaN history lane and with a stage in the parameter rows."""
    system = _lv_system(staged)
    args = _attempt_case(system, 512, 7, nan_lane, n_stage=2 if staged else 0)
    calls = [adams_split.split_predict.calls, adams_split.split_sweep.calls,
             adams_split.split_finish.calls]
    got = adams_split.adams_split_attempt(system, *args, newton_tol, FUNCTIONAL_MAXITER, P_MAX)
    ref = adams_history_attempt_reference(system, *args, newton_tol, FUNCTIONAL_MAXITER, P_MAX)
    assert [adams_split.split_predict.calls, adams_split.split_sweep.calls,
            adams_split.split_finish.calls] == [calls[0] + 1, calls[1] + FUNCTIONAL_MAXITER,
                                                calls[2] + 1]
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a.isnan(), b.isnan()) if a.is_floating_point() else True, name
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), name
    if newton_tol > 0:  # the rate tests decide both ways in these inputs
        assert ref.conv.any() and not ref.conv.all()
    if nan_lane:
        assert not bool(got.conv[1]) and torch.isnan(got.DF_resc[:, :, 1]).any()


# the sweep's path shapes (nz, B): SIR-1000's forward and 'resolve' backward at
# B=1,024, the staged 'hermite' backward and forward at B=256, and the
# sensitivity block of Lotka-Volterra's staggered solve at B=10,000
SWEEP_PATH_SHAPES = [(3000, 1024), (6002, 1024), (3002, 256), (3000, 256), (4, 10000)]
SWEEP_EDGE_SHAPES = [(1, 1024), (1, 1), (3001, 1024), (513, 300), (3000, 1), (3000, 1025),
                     (3002, 257), (4, 10001), (6002, 33)]


@pytest.mark.parametrize(
    "nz, B, path",
    [(*s, True) for s in SWEEP_PATH_SHAPES] + [(*s, False) for s in SWEEP_EDGE_SHAPES],
)
def test_sweep_geometry_covers_every_row_and_lane_once(nz, B, path):
    """The sweep kernel's geometry (``sweep_geometry``) walked as the kernel
    walks it: cluster rank c takes rows [c rows, min((c + 1) rows, nz)),
    its row thread y the rows c rows + y + j row_threads, tile t the lanes t
    lanes + x below B.  Every (row, lane) is covered once, no block is
    empty, the block is SWEEP_THREADS threads, the cluster a power of two
    the card allows (16 at most, above the portable 8 only where 8 would not
    give the card a block an SM), and every path shape fills the card with
    a block an SM at least."""
    g = adams_split.sweep_geometry(nz, B)
    assert g.lanes * g.row_threads == adams_split.SWEEP_THREADS and g.lanes >= 16
    assert g.cluster in (1, 2, 4, 8, 16)
    assert g.cluster <= 8 or g.tiles * 8 < adams_split.CARD_SMS
    rows = np.zeros(nz, dtype=np.int64)
    for c in range(g.cluster):
        lo, hi = c * g.rows, min((c + 1) * g.rows, nz)
        assert hi > lo, f"block {c} of a cluster has no rows"
        for y in range(g.row_threads):
            rows[np.arange(lo + y, hi, g.row_threads)] += 1
    lanes = np.zeros(B, dtype=np.int64)
    for t in range(g.tiles):
        b = t * g.lanes + np.arange(g.lanes)
        lanes[b[b < B]] += 1
    assert (rows == 1).all() and (lanes == 1).all()
    assert g.tiles == -(-B // g.lanes)
    if path:
        assert g.blocks >= adams_split.CARD_SMS


# predict's edge shapes beside the five path shapes: a history of one row,
# the sensitivity block's four, a row short of and past a 64-row step, the
# deepest SIR backward; one lane, a lane short of a 32-lane tile, B=10,000
PREDICT_EDGE_SHAPES = [(nz, B) for nz in (1, 4, 63, 65, 6002) for B in (1, 31, 10_000)]


@pytest.mark.parametrize(
    "nz, B, path",
    [(*s, True) for s in SWEEP_PATH_SHAPES] + [(*s, False) for s in PREDICT_EDGE_SHAPES],
)
def test_predict_geometry_covers_every_row_and_lane_once(nz, B, path):
    """Predict's geometry (``predict_geometry``) walked as the kernel walks
    it: cluster rank c takes rows [c rows, min((c + 1) rows, nz)), its
    row thread y the rows c rows + y + j row_threads, j = 0, 1, ...; tile t
    the lanes t lanes + x below B.  Every (row, lane) is covered once, no block is
    empty, every block gets a step of rows, the cluster is one the card
    allows, a tile's R(fac) tables fit the kernel's static shared memory up
    to order 12 (K = 13), and at the SIR path shapes the tiles are 32 lanes
    (a warp reads 256-byte lines) in clusters of 16 blocks."""
    g = adams_split.predict_geometry(nz, B)
    assert g.lanes * g.row_threads == adams_split.SWEEP_THREADS
    assert 16 <= g.lanes <= adams_split.PREDICT_LANES_MAX
    assert 8 * 13 * 13 * adams_split.PREDICT_LANES_MAX + 4 * adams_split.SWEEP_THREADS <= 48 * 1024
    assert g.cluster in (1, 2, 4, 8, 16)
    T = g.row_threads
    assert g.cluster == 1 or g.rows >= T
    rows = np.zeros(nz, dtype=np.int64)
    for c in range(g.cluster):
        lo, hi = c * g.rows, min((c + 1) * g.rows, nz)
        assert hi > lo, f"block {c} of a cluster has no rows"
        for y in range(T):
            rows[lo + y:hi:T] += 1
    lanes = np.zeros(B, dtype=np.int64)
    for t in range(g.tiles):
        b = t * g.lanes + np.arange(g.lanes)
        lanes[b[b < B]] += 1
    assert (rows == 1).all() and (lanes == 1).all()
    assert g.tiles == -(-B // g.lanes)
    if path and nz > 4:
        assert (g.lanes, g.cluster) == (32, 16)


# the finish at the edges of its forms: one to eight rows (a row thread each),
# past them up to a chunk of 64 and a row past it, and SIR's shapes
FINISH_NZ = (1, 2, 3, 4, 5, 7, 8, 9, 63, 64, 65, 128, 129, 3002, 6002)


@pytest.mark.parametrize("nz", FINISH_NZ)
def test_finish_geometry_pins_the_form_by_rows(nz):
    """The finish's geometry (``finish_geometry``, the mirror of the launch's
    ``finish_tile``) walked as the kernel walks it at B = 10,000 and 31:
    rows that fit one chunk (nz <= 64) take the one-chunk form (no scratch,
    counter or fill) on a tile of min(nz, 8) row threads, none of them
    without a row, by 256 // min(nz, 8) lanes; more rows the multi-chunk
    form's 32 lanes by 8 row threads a chunk.  Either way row thread y of
    chunk c takes rows 64 c + y + j row_threads, so each lane's rows add in
    the same order into the same row thread's sum: every (row, lane) is
    covered once, and the one-chunk form's sums are the multi-chunk form's."""
    for B in (10_000, 31):
        g = adams_split.finish_geometry(nz, B)
        assert g.one_chunk == (nz <= adams_split.CHUNK_ROWS)
        assert g.chunks == -(-nz // adams_split.CHUNK_ROWS)
        T = g.row_threads
        if g.one_chunk:
            assert T == min(nz, 8) and g.lanes == 256 // T
        else:
            assert (g.lanes, T) == (adams_split.TILE_LANES, 8)
        assert g.lanes * T <= 256 and T <= nz
        rows = np.zeros(nz, dtype=np.int64)
        for c in range(g.chunks):
            hi = min((c + 1) * adams_split.CHUNK_ROWS, nz)
            for y in range(T):
                assert 64 * c + y < hi or not g.one_chunk, "a row thread without a row"
                rows[64 * c + y:hi:T] += 1
        lanes = np.zeros(B, dtype=np.int64)
        for t in range(g.tiles):
            b = t * g.lanes + np.arange(g.lanes)
            lanes[b[b < B]] += 1
        assert (rows == 1).all() and (lanes == 1).all()


def test_cpu_solve_keeps_the_fused_plain_path(monkeypatch):
    """On CPU tensors the history attempt runs its own plain version, never
    the split one; a CUDA solve without an emitted system is what takes
    the split attempt (on the card)."""
    monkeypatch.setattr(adams_split, "adams_split_attempt",
                        lambda *a, **k: pytest.fail("split attempt on the CPU"))
    system = _lv_system(False)
    args = _attempt_case(system, 8, 1)
    out = adams_history_attempt(system, *args, 3e-4, FUNCTIONAL_MAXITER, P_MAX)
    assert out.DF_upd.shape == (P_MAX + 3, 2, 8)


def _jax_sir(R):
    def rhs(t, y, p):
        i_eff = y.I + p.mix * (jnp.roll(y.I, 1) + jnp.roll(y.I, -1))
        inf = p.beta * y.S * i_eff
        rec = p.gamma * y.I
        return {"S": -inf, "I": inf - rec, "R": rec}

    return JaxProblem(
        params={"beta": (), "gamma": (), "mix": ()},
        states={"S": (R,), "I": (R,), "R": (R,)},
        rhs=rhs,
        derivative_params=[("beta",), ("gamma",)],
    )


def test_sir_regions_golden_through_the_port():
    """tests/test_golden.py::test_sir_regions_golden through the port: the
    same R = 16 model as a TorchProblem, ADAMS with the default 'hermite'
    adjoint, the same options and the same gates (ys rtol 1e-6 / atol
    1e-10, gradient rtol 5e-4 / atol 1e-6)."""
    g = np.load(os.path.join(GOLDEN, "sir_regions.npz"))
    R = int(g["R"])
    opts = BDFOptions(rtol=1e-10, atol=1e-12)
    solve = make_batched_solve_fn(sir_problem(R), derivatives="adjoint", options=opts,
                                  adjoint_options=opts, checkpoint_n=2048, method="ADAMS")
    y0 = torch.as_tensor(g["y0"])[None, :]
    psub = torch.as_tensor(g["p0"][:2])[None, :].requires_grad_(True)
    ys = solve(0.0, y0, psub, torch.as_tensor(g["p0"][2:]), torch.as_tensor(g["tvals"]))
    np.testing.assert_allclose(ys.detach().numpy()[0], g["ys"], rtol=1e-6, atol=1e-10)
    (gp,) = torch.autograd.grad(torch.sum(ys[:, :, R : 2 * R] ** 2), (psub,))
    np.testing.assert_allclose(gp.numpy()[0], g["gp"], rtol=5e-4, atol=1e-6)
    assert (solve.last_stats["backward"]["status"] == 0).all()


@pytest.mark.parametrize("mode", ["resolve", "hermite"])
def test_build_sir_matches_jax_grad(mode):
    """``entry.build_sir`` at R = 4 on two lanes of its seeded inputs, on the
    CPU, against ``jax.grad`` of the JAX package's ``JaxProblem`` with
    ``scripts/bench_sir_scale.py``'s options (one compile per mode)."""
    R, B = 4, 2
    step, (y0s, p_subs) = build_sir(R, B, mode, device="cpu")
    ys, gp = step(y0s, p_subs)
    opts = JaxOptions(rtol=1e-8, atol=1e-10)
    jsolve = jax_make(_jax_sir(R), options=opts, adjoint_options=opts, checkpoint_n=1024,
                      method="ADAMS", adjoint_interpolation=mode)
    tvals = jnp.asarray(np.linspace(5.0, 60.0, 12))
    y0j = jnp.asarray(y0s.numpy())

    def loss(psub):
        ys = jsolve(0.0, y0j, psub, jnp.asarray([0.05]), tvals)
        return jnp.sum(ys[:, :, R : 2 * R] ** 2), ys

    (_, ys_j), gp_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(p_subs.numpy()))
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(gp.numpy(), np.asarray(gp_j), rtol=1e-9)
    stats = step.solve.last_stats
    assert (stats["backward"]["status"] == 0).all() and stats["backward"]["n_attempts"] > 0
