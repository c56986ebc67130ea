"""The state axis (``sunode_torch.parallel.mesh``: ``make_mesh_2d``,
``shard_batch_state``) on CPU meshes of repeated devices: the port's
counterparts of ``tests/test_sharding_state.py``'s two cases (BASELINE config
5, SIR over many regions, ADAMS, ``checkpoint_n=512``, 'hermite'), at R = 32
(96 state rows, which divide by 2 and 4) and B = 4.

Each chain group's state rows are split over its row of the mesh: the
row-block route of the batched Adams core and of its fused backward
(``ops/adams_batched.py``'s ``rows``, ``parallel/rows.py``), whose attempt
sums each lane's partial norms over the blocks
(``ops/adams_split.py::adams_split_attempt_rows``).  At one block it is the
unsplit solve bit for bit; over several, the lanes' sums of squares add in
another order, so the results are held at the reference test's 1e-10 /
1e-12.  Torch runs on one thread while each test runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_tpu.problem import JaxProblem
from sunode_tpu.wrappers.as_jax import make_batched_solve_fn as jax_make
from sunode_torch.entry import lv_problem, sir_problem
from sunode_torch.ops import adams_split as sp
from sunode_torch.ops.adams import _GAMMA_STAR, FUNCTIONAL_MAXITER
from sunode_torch.ops.adams_batched import adams_solve_batched
from sunode_torch.ops.bdf import BDFOptions
from sunode_torch.ops.pece_step import PeceSystem
from sunode_torch.parallel.mesh import Mesh, make_mesh_2d, shard_batch_state
from sunode_torch.parallel.rows import RowBlocks, RowLayout, lane_all, lane_any, lane_sum
from sunode_torch.parallel.rows import scatter
from sunode_torch.wrappers.as_torch import make_batched_solve_fn

R, B = 32, 4
CPU = torch.device("cpu")
OPTS = BDFOptions(rtol=1e-8, atol=1e-10)
TVALS = np.linspace(5.0, 40.0, 6)
P_FIX = np.array([0.05])


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n_chains, n_state):
    return Mesh(((CPU,) * n_state,) * n_chains, ("chains", "state"))


def _inputs():
    """The reference test's draws (``default_rng(3)``) at R regions."""
    rng = np.random.default_rng(3)
    S0 = 0.99 + 0.005 * rng.standard_normal((B, R))
    I0 = 0.01 * np.abs(1 + 0.1 * rng.standard_normal((B, R)))
    y0 = np.concatenate([S0, I0, np.zeros((B, R))], axis=1)
    psub = np.stack([0.4 * (1 + 0.05 * rng.standard_normal(B)),
                     0.15 * (1 + 0.05 * rng.standard_normal(B))], axis=1)
    return y0, psub


def _solve(derivatives="adjoint", mode="hermite", method="ADAMS", problem=None):
    return make_batched_solve_fn(sir_problem(R) if problem is None else problem,
                                 derivatives=derivatives, options=OPTS, adjoint_options=OPTS,
                                 checkpoint_n=512, method=method, adjoint_interpolation=mode)


def _grad(solve, y0, psub, mesh=None):
    """ys, d loss / d psub and d loss / d y0 of the reference's loss,
    ``sum(ys[:, :, R:2R]**2)``, with ``y0`` cut over ``mesh`` where given."""
    p = torch.as_tensor(psub).requires_grad_(True)
    y = torch.as_tensor(y0).requires_grad_(True)
    ys = solve(0.0, y if mesh is None else shard_batch_state(mesh, y), p,
               torch.as_tensor(P_FIX), torch.as_tensor(TVALS))
    gp, gy = torch.autograd.grad(torch.sum(ys[:, :, R:2 * R] ** 2), (p, y))
    return ys.detach().numpy(), gp.numpy(), gy.numpy()


def _jax_sir():
    def rhs(t, y, p):
        i_eff = y.I + p.mix * (jnp.roll(y.I, 1) + jnp.roll(y.I, -1))
        inf = p.beta * y.S * i_eff
        rec = p.gamma * y.I
        return {"S": -inf, "I": inf - rec, "R": rec}

    return JaxProblem(params={"beta": (), "gamma": (), "mix": ()},
                      states={"S": (R,), "I": (R,), "R": (R,)}, rhs=rhs,
                      derivative_params=[("beta",), ("gamma",)])


def _jax_options():
    return JaxOptions(rtol=1e-8, atol=1e-10)


def test_state_axis_sharded_gradient_matches():
    """The reference's first case: the 'hermite' gradient on a 4 x 2 mesh
    (four chain groups of one lane, each lane's 96 rows over two devices)
    within 1e-10 / 1e-12 of the port's unsplit gradient, and within the
    split SIR tests' 1e-9 of the JAX package's unsplit ``jax.grad``.
    Against the same unsplit gradient: a 1 x 1 mesh runs the row-block
    route over one block, the same rows summed in the same order and one
    root of the same sum, so it is the unsplit port bit for bit; a 2 x 1
    mesh splits the chains only (ROADMAP C10: held at 1e-12, as the chain
    split's tests)."""
    y0, psub = _inputs()
    solve = _solve()
    ref = _grad(solve, y0, psub)
    assert all(np.isfinite(x).all() for x in ref)
    split = _grad(solve, y0, psub, _mesh(4, 2))
    for got, want in zip(split, ref):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    groups = solve.last_stats["chain_groups"]
    assert len(groups) == 4 and all((g["backward"]["status"] == 0).all() for g in groups)
    for got, want in zip(_grad(solve, y0, psub, _mesh(1, 1)), ref):
        assert np.array_equal(got, want)
    for got, want in zip(_grad(solve, y0, psub, _mesh(2, 1)), ref):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    ys_s, gp_s, _ = split

    jsolve = jax_make(_jax_sir(), options=_jax_options(), adjoint_options=_jax_options(),
                      checkpoint_n=512, method="ADAMS")

    def loss(p):
        out = jsolve(0.0, jnp.asarray(y0), p, jnp.asarray(P_FIX), jnp.asarray(TVALS))
        return jnp.sum(out[:, :, R:2 * R] ** 2), out

    (_, ys_j), gp_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(psub))
    np.testing.assert_allclose(ys_s, np.asarray(ys_j), rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(gp_s, np.asarray(gp_j), rtol=1e-9)


def test_state_axis_sharded_forward_matches():
    """The reference's second case: the forward solve on a 2 x 4 mesh (a
    deeper state split, 24 rows a device) within 1e-10 / 1e-12 of the port's
    unsplit solve, and within 1e-9 / 1e-14 of the JAX package's jitted
    unsplit solve."""
    y0, psub = _inputs()
    solve = _solve(derivatives=None)
    args = (torch.as_tensor(psub), torch.as_tensor(P_FIX), torch.as_tensor(TVALS))
    ys = solve(0.0, torch.as_tensor(y0), *args).numpy()
    ys_s = solve(0.0, shard_batch_state(_mesh(2, 4), torch.as_tensor(y0)), *args).numpy()
    np.testing.assert_allclose(ys_s, ys, rtol=1e-10, atol=1e-12)
    jsolve = jax_make(_jax_sir(), options=_jax_options(), method="ADAMS")
    ys_j = jax.jit(lambda y, p: jsolve(0.0, y, p, jnp.asarray(P_FIX), jnp.asarray(TVALS)))(
        jnp.asarray(y0), jnp.asarray(psub))
    np.testing.assert_allclose(ys_s, np.asarray(ys_j), rtol=1e-9, atol=1e-14)


@pytest.mark.parametrize("mode", ["resolve", "polynomial"])
def test_state_split_adjoint_modes(mode):
    """'resolve' ([y | lam] split so that each device holds y and lam of
    the same state rows) and 'polynomial' (the recording's y rows read
    where they lie) on a 1 x 2 mesh within 1e-10 of the unsplit port."""
    y0, psub = _inputs()
    solve = _solve(mode=mode)
    for got, ref in zip(_grad(solve, y0, psub, _mesh(1, 2)), _grad(solve, y0, psub)):
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


def _attempt(nz_rows, n, seed):
    """One attempt's seeded arguments on ``nz_rows`` rows, the first ``n``
    state rows (history depth 11, orders 1..8, 90% of lanes active)."""
    rng = np.random.default_rng(seed)
    KAB, Bw = 11, 6
    T = torch.as_tensor
    DF = rng.standard_normal((KAB, nz_rows, Bw)) * (0.5 ** np.arange(KAB))[:, None, None]
    return dict(
        t_new=T(rng.uniform(0, 10, Bw)), h_use=T(10.0 ** rng.uniform(-4, -1, Bw)),
        pre_factor=T(np.exp(rng.uniform(np.log(0.2), np.log(2.0), Bw))),
        p=T(rng.integers(1, 9, Bw).astype(np.int32)), active=T(rng.uniform(size=Bw) < 0.9),
        DF=T(DF), z_prev=T(1.0 + rng.uniform(0.2, 1.0, (nz_rows, Bw))),
        params=T(np.array([0.4, 0.15, 0.05])[:, None] * (1 + 0.05 * rng.standard_normal((3, Bw)))),
        atol_z=torch.full((nz_rows,), 1e-8, dtype=torch.float64),
        rtol_z=torch.full((nz_rows,), 1e-7, dtype=torch.float64),
        v_err=T(np.r_[np.full(n, 0.5 / n), np.full(nz_rows - n, 0.5 / max(nz_rows - n, 1))]),
    )


@pytest.mark.parametrize("blocks", [1, 3])
def test_partial_stages_compose_to_the_split_attempt(blocks):
    """The rows' and the lanes' plain stages over row blocks (the staged
    adjoint's shape: 96 lambda rows and 2 quadratures, these on the home
    block) against ``split_sweep`` / ``split_finish`` composed as the
    unsplit attempt: bit for bit over one block, within 1e-14 over three."""
    problem = sir_problem(R)
    rhs = problem.make_rhs()
    n, m = 3 * R, 2

    def fz(t, y, par):
        f = rhs(t, y, par)
        return torch.cat([f, f[:m] * f[m:2 * m]])

    system = PeceSystem(fz=fz, n=n, nz=n + m)
    x = _attempt(n + m, n, 5 + blocks)
    g = torch.as_tensor(np.abs(_GAMMA_STAR))
    tol = 3e-4
    ref = sp.adams_split_attempt_reference(
        system, x["t_new"], x["h_use"], x["pre_factor"], x["p"], x["active"], x["DF"],
        x["z_prev"], x["params"], x["atol_z"], x["rtol_z"], g, x["v_err"], tol,
        FUNCTIONAL_MAXITER, 8)
    sizes = [n // blocks] * (blocks - 1) + [n - n // blocks * (blocks - 1)]
    L = RowLayout.contiguous((CPU,) * blocks, sizes).with_rows(m)

    def col(v):
        return scatter(L, v[:, None])

    got = sp.adams_split_attempt_rows(
        system, x["t_new"], x["h_use"], x["pre_factor"], x["p"], x["active"],
        scatter(L, x["DF"]), scatter(L, x["z_prev"]), x["params"], col(x["atol_z"]),
        col(x["rtol_z"]), g, col(x["v_err"]), tol, FUNCTIONAL_MAXITER, 8)
    assert torch.equal(got.conv, ref.conv) and torch.equal(got.niter, ref.niter)
    for name in ("DF_resc", "DF_upd", "z_pred", "z_new", "err0"):
        assert torch.equal(getattr(got, name).gather(), getattr(ref, name))
    if blocks == 1:
        assert torch.equal(got.err3, ref.err3)
    else:
        np.testing.assert_allclose(got.err3.numpy(), ref.err3.numpy(), rtol=1e-14, atol=0)


def _bits(a, b):
    """Bit for bit, a NaN equal to a NaN."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("tol", [3e-4, 0.0])
@pytest.mark.parametrize("blocks", [1, 2, 3])
def test_folded_decision_is_the_composed_one(blocks, tol):
    """The folded plain stages -- each block's ``split_sweep_rows`` deciding
    the sweep before from every block's pending partials, the home block
    reading its rows of f in place, and ``split_finish_lanes`` deciding the
    last sweep -- bit for bit the composition they replace (the rows'
    sweep on each block, ``lane_sum`` / ``lane_any`` of its sums and
    ``split_sweep_decide`` after every sweep, the lanes' finish on the last
    state) over one attempt's sweeps: y_next, every sweep's decided state,
    err3, conv and niter.  One lane's f has a non-finite state row on the
    last block; ``tol = 0`` runs fixed sweeps."""
    problem = sir_problem(R)
    rhs = problem.make_rhs()
    n, m = 3 * R, 2

    def fz(t, y, par):
        f = rhs(t, y, par)
        out = torch.cat([f, f[:m] * f[m:2 * m]])
        out[n - 1, 1] = float("inf")
        return out

    x = _attempt(n + m, n, 11 + blocks)
    sizes = [n // blocks] * (blocks - 1) + [n - n // blocks * (blocks - 1)]
    L = RowLayout.contiguous((CPU,) * blocks, sizes).with_rows(m)
    n_d = L.state_rows(n)
    preds = [sp.split_predict(D, x["p"], x["pre_factor"], x["h_use"], z, a[:, 0], r[:, 0], 8)
             for D, z, a, r in zip(scatter(L, x["DF"]).blocks, scatter(L, x["z_prev"]).blocks,
                                   scatter(L, x["atol_z"][:, None]).blocks,
                                   scatter(L, x["rtol_z"][:, None]).blocks)]
    y = [pr.z_pred[:k] for pr, k in zip(preds, n_d)]
    composed = folded = sp.sweep_start(x["active"])
    pending = None
    for k in range(FUNCTIONAL_MAXITER):
        f_all = fz(x["t_new"], RowBlocks(L, y).gather(), x["params"])
        f_b = scatter(L, f_all).blocks
        outs = [sp.split_sweep_rows(f, yy, pr, composed, k_d)[0]
                for f, yy, pr, k_d in zip(f_b, y, preds, n_d)]
        ss = lane_sum([o.ss[0] for o in outs], CPU)
        nf = lane_any([o.nonfinite[0] for o in outs], CPU)
        folds = [sp.split_sweep_rows(f_all if d == 0 else f_b[d], yy, pr, folded, k_d, pending,
                                     rows=L.segments[0] if d == 0 else None)
                 for d, (yy, pr, k_d) in enumerate(zip(y, preds, n_d))]
        for (got, state), want in zip(folds, outs):
            assert _bits(got.y_next, want.y_next) and _bits(got.ss, want.ss)
            assert torch.equal(got.nonfinite, want.nonfinite)
            assert all(_bits(a, b) for a, b in zip(state, composed))
        composed = sp.split_sweep_decide(k, ss, nf, composed, tol, n)
        folded = folds[0][1]
        pending = sp.Pending(k, tuple(o.ss for o, _ in folds),
                             tuple(o.nonfinite for o, _ in folds), tol, n)
        y = [o.y_next for o, _ in folds]
    g = torch.as_tensor(np.abs(_GAMMA_STAR))
    f_b = scatter(L, fz(x["t_new"], RowBlocks(L, y).gather(), x["params"])).blocks
    ss3 = lane_sum([sp.split_finish_rows(f, pr, x["p"], x["h_use"], g, v[:, 0], 8).ss3
                    for f, pr, v in zip(f_b, preds, scatter(L, x["v_err"][:, None]).blocks)],
                   CPU)
    pred_ok = lane_all([pr.pred_ok for pr in preds], CPU)
    err3, conv, niter = sp.split_finish_lanes(ss3, pred_ok, composed, tol)
    got = sp.split_finish_lanes(ss3, pred_ok, folded, tol, pending)
    assert _bits(got[0], err3) and torch.equal(got[1], conv) and torch.equal(got[2], niter)
    assert torch.equal(niter, composed.niter) and bool(composed.bad[1])


def test_row_blocks_scatter_gather_and_own_storage():
    """A layout's blocks hold their segments in local order (the state rows
    first, the quadrature's after them on the home block; 'resolve''s y and
    lambda of the same rows together), gather restores the rows' order, and
    every block owns its storage on a repeated device, as every block of a
    StateShards does."""
    L = RowLayout.contiguous((CPU, CPU, CPU), (2, 3, 1))
    assert L.with_rows(2).sizes == (4, 3, 1) and L.with_rows(2).state_rows(6) == (2, 3, 1)
    stacked = L.repeated(2)
    assert stacked.segments[1] == ((2, 5), (8, 11)) and stacked.state_rows(6) == (2, 3, 1)
    x = torch.arange(24.0).reshape(12, 2)
    blocks = scatter(stacked, x)
    assert torch.equal(blocks.blocks[1][:, 0], torch.tensor([4.0, 6, 8, 16, 18, 20]))
    assert torch.equal(blocks.gather(), x)
    blocks.blocks[0].add_(1.0)
    assert torch.equal(x, torch.arange(24.0).reshape(12, 2))
    y0 = torch.arange(8.0, dtype=torch.float64).reshape(2, 4)
    shards = shard_batch_state(_mesh(1, 2), y0)
    shards.blocks[0][0].add_(10.0)
    assert torch.equal(y0, torch.arange(8.0, dtype=torch.float64).reshape(2, 4))
    assert [b.shape for b in shards.blocks[0]] == [(2, 2), (2, 2)]
    assert isinstance(blocks, RowBlocks)


def test_mesh_2d_and_shard_batch_state_errors():
    """``make_mesh_2d`` raises without a card; ``shard_batch_state`` raises
    ``ValueError`` on a batch or a state that does not divide evenly, and on
    a 1-D mesh."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh_2d(1, 2)
    mesh = _mesh(2, 2)
    assert mesh.shape == (2, 2) and mesh.size == 4
    with pytest.raises(ValueError, match="divide evenly"):
        shard_batch_state(mesh, torch.zeros((4, 5), dtype=torch.float64))
    with pytest.raises(ValueError, match="divide evenly"):
        shard_batch_state(mesh, torch.zeros((3, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="axes"):
        shard_batch_state(Mesh((CPU, CPU)), torch.zeros((4, 4), dtype=torch.float64))


def _refused():
    y0, psub = _inputs()
    shards = shard_batch_state(_mesh(1, 2), torch.as_tensor(y0))
    args = (torch.as_tensor(psub), torch.as_tensor(P_FIX), torch.as_tensor(TVALS))
    lv = lv_problem()
    lv_y0 = shard_batch_state(_mesh(1, 2), torch.ones((B, 2), dtype=torch.float64))
    lv_args = (torch.ones((B, 2), dtype=torch.float64),
               torch.tensor([1.0, 0.4], dtype=torch.float64), torch.as_tensor(TVALS))
    return {
        "BDF": lambda: _solve(method="BDF")(0.0, shards, *args),
        "SympyProblem": lambda: _solve(problem=lv)(0.0, lv_y0, *lv_args),
        "transition": lambda: _solve(mode="transition")(0.0, shards, *args),
        "float32": lambda: _solve()(0.0, shard_batch_state(
            _mesh(1, 2), torch.as_tensor(y0, dtype=torch.float32)), *args),
        "per-lane grids": lambda: _solve()(0.0, shards, *args[:2],
                                           torch.as_tensor(TVALS).expand(B, -1)),
        "constraints": lambda: make_batched_solve_fn(
            sir_problem(R), options=OPTS._replace(constraints=np.ones(3 * R)),
            method="ADAMS")(0.0, shards, *args),
        "sensitivities": lambda: adams_solve_batched(
            sir_problem(R).make_rhs(), 0.0, torch.as_tensor(y0), torch.ones((B, 3)),
            torch.as_tensor(TVALS), OPTS, batched_fns=True,
            sens_rhs=lambda t, y, S, p: S, sens0=torch.zeros((B, 1, 3 * R)),
            rows=RowLayout.contiguous((CPU, CPU), (48, 48))),
        "roots": lambda: adams_solve_batched(
            sir_problem(R).make_rhs(), 0.0, torch.as_tensor(y0), torch.ones((B, 3)),
            torch.as_tensor(TVALS), OPTS, batched_fns=True,
            root_fn=lambda t, y, p: y[:1], rows=RowLayout.contiguous((CPU, CPU), (48, 48))),
    }


@pytest.mark.parametrize("case", ["BDF", "SympyProblem", "transition", "float32",
                                  "per-lane grids", "constraints", "sensitivities", "roots"])
def test_refused_combinations_raise_before_any_solve(case, monkeypatch):
    """What the state split does not take raises ``ValueError`` naming
    ROADMAP A, decided by type and options before any solve (never a
    silent unsplit solve)."""
    import sunode_torch.wrappers.as_torch as as_torch

    def no_solve(*a, **k):
        raise AssertionError("a solve ran")

    monkeypatch.setattr(as_torch, "adams_solve_batched", no_solve)
    monkeypatch.setattr(as_torch, "bdf_solve_batched", no_solve)
    monkeypatch.setattr(sp, "adams_split_attempt_rows", no_solve)
    import sunode_torch.ops.adams_batched as ab

    monkeypatch.setattr(ab, "adams_split_attempt_rows", no_solve)
    with pytest.raises(ValueError, match="ROADMAP A"):
        _refused()[case]()
