"""sunode_torch on an NVIDIA GPU: the CUDA PECE kernels, the history-attempt
kernel and the split attempt's three kernels against their plain versions
and each other, and the CUDA main path,
the batched BDF solve, with and without sensitivities, the default call
(BDF with the checkpointed adjoint) and the ADAMS adjoints 'resolve',
'hermite' and 'polynomial', the SIR workload (a ``TorchProblem``,
through the split kernels), forward sensitivities in every mode
(``build_lv_sens``, and a ``TorchProblem``'s staggered sensitivity block
through the split kernels) and rootfinding on both cores
(``build_lv_roots``) against the CPU ones; the float32 builds of the
history-attempt and split kernels against their plain versions at float32,
float32 solves through them (``build_lv_adjoint_f32``, ``build_sir`` at
float32), per-lane observation grids on both cores
(``build_lv_per_lane``), the banded LU's kernels against their plain
versions and the structured Newton paths (``build_kpp``, ``build_hub``)
against the CPU, and the spline LV's emitted builds.

Every test here needs a card and skips without one.  The file imports no
jax, so on a GPU machine without jax it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from sunode_torch.adjoint import resolve_fz, staged_adjoint_fz, transition_fz
from sunode_torch.entry import (
    LV_SENS_MODES,
    build_lv_adams,
    build_lv_adjoint,
    build_lv_adjoint_f32,
    build_lv_per_lane,
    build_lv_roots,
    build_lv_sens,
    build_robertson,
    build_sir,
    lv_problem,
    sir_problem,
)
from sunode_torch.experiments import exp_pece2d
from sunode_torch.ops.adams import _GAMMA_STAR, FUNCTIONAL_MAXITER
from sunode_torch.ops.adams_attempt import (
    adams_history_attempt,
    adams_history_attempt_reference,
    build_attempt_kernel,
)
from sunode_torch.ops.adams_batched import adams_solve_batched
from sunode_torch.ops import adams_split
from sunode_torch.ops.adams_split import adams_split_attempt, adams_split_attempt_reference
from sunode_torch.ops.bdf import BDFOptions
from sunode_torch.ops.bdf_batched import bdf_solve_batched
from sunode_torch.ops.pece_2d import pece_2d_attempt, pece_2d_reference
from sunode_torch.ops.pece_step import (
    PeceSystem,
    adams_pece_attempt,
    adams_pece_attempt_reference,
)
from sunode_torch.symode import cuda_codegen
from sunode_torch.wrappers.as_torch import make_batched_solve_fn

pytestmark = pytest.mark.cuda
B = 1000


@functools.cache
def _chip_smoke():
    """``chip_smoke.py`` (beside the tests' directory) as a module, for its
    checks."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _system(kind, real="double"):
    """The emitted system ``kind`` of Lotka-Volterra at the C type ``real``
    beside its plain right-hand side, composed as the Adams core composes it."""
    problem = lv_problem()
    rhs = problem.make_rhs()
    emit = functools.partial(getattr(cuda_codegen, f"{kind}_system"), problem, real)
    if kind == "forward":
        return PeceSystem(fz=rhs, n=2, nz=2, device=emit())
    aj, qr = problem.make_adjoint_rhs(), problem.make_adjoint_quad_rhs()
    if kind == "resolve":
        rhs_c, quad_c = resolve_fz(rhs, aj, qr, 2)
        return PeceSystem(
            fz=lambda t, y, p: torch.cat([rhs_c(t, y, p), quad_c(t, y, p)]),
            n=4, nz=6, device=emit(),
        )
    sens = problem.make_sensitivity_rhs()
    if kind == "sensitivity":  # [y | vec S]
        return PeceSystem(
            fz=lambda t, z, p: torch.cat(
                [rhs(t, z[:2], p), sens(t, z[:2], z[2:].reshape(2, 2, -1), p).reshape(4, -1)]),
            n=6, nz=6, device=emit(),
        )
    if kind == "staged_sensitivity":  # vec S, the parameter rows [params | y_new]
        return PeceSystem(
            fz=lambda t, S, p: sens(t, p[4:], S.reshape(2, 2, -1), p[:4]).reshape(4, -1),
            n=4, nz=4, device=emit(),
        )
    if kind == "staged_adjoint":
        # the parameter rows are [params | y(t)], as the Adams core passes them
        rhs_s, quad_s = staged_adjoint_fz(aj, qr)
        return PeceSystem(
            fz=lambda t, y, p: torch.cat([rhs_s(t, y, p[:4], p[4:]), quad_s(t, y, p[:4], p[4:])]),
            n=2, nz=4, device=emit(),
        )
    rhs_c, quad_c = transition_fz(
        rhs, problem.make_adjoint_jac_dense(), problem.make_dfdp(), 2
    )
    return PeceSystem(
        fz=lambda t, y, p: torch.cat([rhs_c(t, y, p), quad_c(t, y, p)]),
        n=6, nz=10, device=emit(),
    )


def _case(system, device, seed, kab=9, width=B):
    """Seeded inputs of one PECE attempt at history depth ``kab`` over
    ``width`` lanes, orders 1..kab-3."""
    rng = np.random.default_rng(seed)
    KAB, n, nz = kab, system.n, system.nz
    f64 = dict(dtype=torch.float64, device=device)
    DF = rng.standard_normal((KAB, nz, width)) * (0.5 ** np.arange(KAB))[:, None, None]
    params = np.array([1.0, 0.3, 1.0, 0.4])[:, None] * (1 + 0.1 * rng.standard_normal((4, width)))
    n_stage = system.device.n_p - 4  # a staged y(t) after the problem's parameters
    params = np.concatenate([params, rng.uniform(0.5, 12.0, (n_stage, width))])
    return (
        torch.as_tensor(rng.uniform(0.0, 10.0, width), **f64),
        torch.as_tensor(10.0 ** rng.uniform(-6, -2, width), **f64),
        torch.as_tensor(rng.integers(1, kab - 2, width), dtype=torch.int32, device=device),
        torch.as_tensor(rng.uniform(size=width) < 0.9, device=device),
        torch.as_tensor(DF, **f64),
        torch.as_tensor(1.0 + rng.uniform(0.2, 1.0, (nz, width)), **f64),
        torch.as_tensor(params, **f64),
        torch.full((nz,), 1e-8, **f64),
        torch.full((nz,), 1e-7, **f64),
        3e-4,
        FUNCTIONAL_MAXITER,
    )


@pytest.mark.parametrize("kind", ["forward", "transition"])
def test_kernel_matches_plain(cuda, kind):
    system = _system(kind)
    args = _case(system, cuda, 0)
    before = adams_pece_attempt.launches
    got = adams_pece_attempt(system, *args)
    ref = adams_pece_attempt_reference(system.fz, *args, system.n)
    torch.cuda.synchronize()
    assert adams_pece_attempt.launches == before + 1
    # FMA contraction and the symbolic RHS's own rounding only
    for name in ("y_it", "z_new", "d_fz", "err", "z_pred"):
        a, b = getattr(got, name), getattr(ref, name)
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-12, name
    assert torch.equal(got.conv, ref.conv) and torch.equal(got.niter, ref.niter)


def test_kernel_refuses_bad_inputs(cuda):
    system = _system("forward")
    args = list(_case(system, cuda, 1))
    args[4] = args[4].transpose(1, 2).contiguous().transpose(1, 2)  # non-contiguous DF
    with pytest.raises(ValueError, match="DF"):
        adams_pece_attempt(system, *args)
    no_device = PeceSystem(fz=system.fz, n=2, nz=2)
    with pytest.raises(ValueError, match="device system"):
        adams_pece_attempt(no_device, *_case(system, cuda, 1))


def _history_case(system, device, seed, kab=9, width=B):
    """_case plus the step ratio (log-uniform in [0.2, 2]), |gamma*|, the
    error weights and P_MAX = kab - 3, in the history attempt's order."""
    t_new, h, p, active, DF, z_prev, params, atol_z, rtol_z, tol, maxiter = _case(
        system, device, seed, kab, width
    )
    rng = np.random.default_rng(100 + seed)
    f64 = dict(dtype=torch.float64, device=device)
    n, nz = system.n, system.nz
    v_err = (np.full(n, 1.0 / n) if nz == n else
             np.concatenate([np.full(n, 0.5 / n), np.full(nz - n, 0.5 / (nz - n))]))
    return [
        t_new, h, torch.as_tensor(np.exp(rng.uniform(np.log(0.2), np.log(2.0), width)), **f64),
        p, active, DF, z_prev, params, atol_z, rtol_z,
        torch.as_tensor(np.abs(_GAMMA_STAR), **f64), torch.as_tensor(v_err, **f64),
        tol, maxiter, kab - 3,
    ]


HISTORY_FIELDS = ("DF_resc", "DF_upd", "z_pred", "z_new", "err0", "err3")


def _history_against_plain(system, args, lanes=None, tol=1e-12):
    """One launch of the history kernel against the plain version on
    ``args``, on every lane or on the ``lanes`` mask's; returns the kernel's
    result.  Normwise within ``tol`` (the emitted right-hand side's own
    rounding: 1e-12 at float64, 1e-5 at float32), and ROADMAP C6's checks:
    DF_resc and z_pred bit for bit,
    z_new, err0 and DF_upd bit for bit in the lanes where the emitted
    right-hand side gives the plain one's f bit for bit at every point the
    plain attempt evaluates it (``chip_smoke.rhs_agreement``)."""
    before = adams_history_attempt.launches
    got = adams_history_attempt(system, *args)
    ref = adams_history_attempt_reference(system, *args)
    torch.cuda.synchronize()
    assert adams_history_attempt.launches == before + 1
    mask = torch.ones_like(args[4]) if lanes is None else lanes
    for name in HISTORY_FIELDS:
        a, b = getattr(got, name)[..., mask], getattr(ref, name)[..., mask]
        assert float((a - b).abs().max() / b.abs().max()) <= tol, name
    assert torch.equal(got.conv[mask], ref.conv[mask])
    assert torch.equal(got.niter[mask], ref.niter[mask])
    names = ("t_new", "h", "pre_factor", "p", "active", "DF", "z_prev", "params", "atol_z",
             "rtol_z", "gamma_star_abs", "v_err", "newton_tol")

    def launch(p, DF, z, maxiter):
        a = list(args)
        a[3], a[5], a[6], a[13] = p, DF, z, maxiter
        return adams_history_attempt(system, *a)

    agree = _chip_smoke().rhs_agreement(launch, system.fz, system.n, dict(zip(names, args)),
                                        args[-1]) & mask
    for name in ("DF_resc", "z_pred"):
        assert torch.equal(getattr(got, name)[..., mask], getattr(ref, name)[..., mask]), name
    for name in ("z_new", "err0", "DF_upd"):
        assert torch.equal(getattr(got, name)[..., agree], getattr(ref, name)[..., agree]), name
    return got


@pytest.mark.parametrize("kab", [9, 11])
@pytest.mark.parametrize("kind", ["forward", "transition", "resolve", "staged_adjoint",
                                  "sensitivity", "staged_sensitivity"])
def test_history_kernel_matches_plain(cuda, kind, kab):
    system = _system(kind)
    _history_against_plain(system, _history_case(system, cuda, 2, kab))


@pytest.mark.parametrize("order", ["one", "P_MAX"])
@pytest.mark.parametrize("kab", [9, 11])
def test_history_kernel_at_one_order_in_every_lane(cuda, kab, order):
    """Every lane at p = 1 (no rescale), or every lane at the deepest order
    (the whole R and U tables)."""
    system = _system("transition")
    args = _history_case(system, cuda, 5, kab)
    args[3] = torch.full_like(args[3], 1 if order == "one" else kab - 3)
    _history_against_plain(system, args)


@pytest.mark.parametrize("width", [5, 1000])
def test_history_kernel_partial_lane_tiles(cuda, width):
    """Fewer lanes than one tile of 32, and a ragged last tile."""
    system = _system("resolve")
    _history_against_plain(system, _history_case(system, cuda, 6, 11, width))


@pytest.mark.parametrize("kab", [9, 11])
def test_history_kernel_poisons_lanes_outside_the_history(cuda, kab):
    """Lanes at p = 0 and p = KAB - 1 come back NaN in every output row,
    not converged, with no sweep; the other lanes as the plain version."""
    system = _system("transition")
    args = _history_case(system, cuda, 7, kab)
    bad = torch.zeros(B, dtype=torch.bool, device=cuda)
    bad[3::17] = True
    args[3] = args[3].clone()
    args[3][3::34] = 0
    args[3][20::34] = kab - 1
    got = _history_against_plain(system, args, ~bad)
    for name in HISTORY_FIELDS:
        assert torch.isnan(getattr(got, name)[..., bad]).all(), name
    assert not got.conv[bad].any() and (got.niter[bad] == 0).all()


def test_history_kernel_refuses_bad_inputs(cuda):
    system = _system("transition")
    good = _history_case(system, cuda, 3)
    bad_cases = {
        "DF": good[5][:, :4],  # rows of another system
        "p": good[3].long(),  # int64 orders
        "v_err": good[11][:-1],  # one weight short
        "pre_factor": good[2].float(),  # float32
        "z_prev": good[6].t().contiguous().t(),  # non-contiguous
    }
    where = {"pre_factor": 2, "p": 3, "DF": 5, "z_prev": 6, "v_err": 11}
    for name, value in bad_cases.items():
        args = list(good)
        args[where[name]] = value
        with pytest.raises(ValueError, match=f"^{name}:"):
            adams_history_attempt(system, *args)
    deeper = list(good)
    deeper[-1] = 7  # P_MAX 7 needs a history of 10 rows
    with pytest.raises(ValueError, match="P_MAX"):
        adams_history_attempt(system, *deeper)
    # without an emitted system the attempt takes the split kernels, which
    # refuse a history of another depth too
    no_device = PeceSystem(fz=system.fz, n=system.n, nz=system.nz)
    before = adams_split_attempt.launches["predict"]
    adams_history_attempt(no_device, *good)
    assert adams_split_attempt.launches["predict"] == before + 1
    with pytest.raises(ValueError, match="P_MAX"):
        adams_history_attempt(no_device, *deeper)


def test_cuda_main_path_matches_cpu(cuda):
    step_c, (y0s, p_subs) = build_lv_adjoint(batch=8, tvals_n=5, rtol=1e-8, device=cuda)
    step_h, _ = build_lv_adjoint(batch=8, tvals_n=5, rtol=1e-8, device="cpu")
    launches = adams_history_attempt.launches
    pece_launches = adams_pece_attempt.launches
    gy, gp = step_c(y0s, p_subs)
    hy, hp = step_h(y0s.cpu(), p_subs.cpu())
    stats = step_c.solve.last_stats
    attempts = stats["forward"]["n_attempts"] + stats["backward"]["n_attempts"]
    assert adams_history_attempt.launches - launches == attempts > 0
    assert adams_pece_attempt.launches == pece_launches
    np.testing.assert_allclose(gy.cpu().numpy(), hy.numpy(), rtol=1e-8)
    np.testing.assert_allclose(gp.cpu().numpy(), hp.numpy(), rtol=1e-8)


def test_cuda_bdf_robertson_matches_cpu(cuda):
    """Stiff Robertson, the 16 golden lanes, through the BDF wrapper: no
    kernel of the package runs, only torch code and torch.linalg's LU."""
    solve_c, inputs = build_robertson(16, device=cuda)
    solve_h, inputs_h = build_robertson(16, device="cpu")
    launches = adams_history_attempt.launches
    ys_c = solve_c(0.0, *inputs).cpu().numpy()
    ys_h = solve_h(0.0, *inputs_h).numpy()
    assert adams_history_attempt.launches == launches
    assert np.isfinite(ys_c).all()
    assert solve_c.last_stats["forward"]["n_attempts"] > 0
    np.testing.assert_allclose(ys_c, ys_h, rtol=1e-6, atol=1e-12)


def test_cuda_bdf_sensitivities_match_cpu(cuda):
    """The 16 lanes of lv_sens.npz with forward sensitivities: the Newton
    solve's multi-right-hand-side LU, make_sensitivity_rhs and the (k, n, B)
    masking on the card against the CPU, 1e-6 relative floored at the
    solver's atol of 1e-9."""
    g = np.load(Path(__file__).parent / "golden" / "lv_sens.npz")
    problem = lv_problem()
    out = {}
    for device in (cuda, "cpu"):
        f64 = dict(dtype=torch.float64, device=device)
        res = bdf_solve_batched(
            problem.make_rhs(), problem.make_jac_dense(), 0.0,
            torch.as_tensor(g["y0s"], **f64), torch.as_tensor(g["ps"], **f64),
            torch.as_tensor(g["tvals"], **f64), BDFOptions(rtol=1e-9, atol=1e-9),
            sens_rhs=problem.make_sensitivity_rhs(), S0=torch.zeros((16, 2, 2), **f64),
            batched_fns=True,
        )
        assert (res.status == 0).all()
        out[device] = (res.ys.cpu().numpy(), res.sens.cpu().numpy())
    for got, ref in zip(out[cuda], out["cpu"]):
        assert np.isfinite(got).all()
        assert np.max(np.abs(got - ref) / (np.abs(ref) + 1e-9)) <= 1e-6


@pytest.mark.parametrize("interpolation", ["hermite", "polynomial"])
def test_cuda_default_call_matches_cpu(cuda, interpolation):
    """``make_batched_solve_fn(problem)`` (BDF, the checkpointed adjoint) on
    the 16 lanes of lv_adjoint.npz, rtol = atol = 1e-8: the card's gradients
    within 1e-6 of the CPU's and inside the golden gate; no kernel of the
    package runs."""
    from sunode_torch.ops.bdf import BDFOptions as Options
    from sunode_torch.wrappers.as_torch import make_batched_solve_fn

    g = np.load(Path(__file__).parent / "golden" / "lv_adjoint.npz")
    kw = {} if interpolation == "hermite" else dict(adjoint_interpolation=interpolation)
    solve = make_batched_solve_fn(lv_problem(), options=Options(rtol=1e-8, atol=1e-8), **kw)
    launches = adams_history_attempt.launches
    out = {}
    for device in (cuda, "cpu"):
        f64 = dict(dtype=torch.float64, device=device)
        y0 = torch.as_tensor(g["y0s"], **f64).requires_grad_()
        p = torch.as_tensor(g["p_subs"], **f64).requires_grad_()
        ys = solve(0.0, y0, p, torch.as_tensor(g["p_fix"], **f64), torch.as_tensor(g["tvals"], **f64))
        out[device] = [a.cpu().numpy() for a in torch.autograd.grad(torch.sum(ys**2), (y0, p))]
        assert (solve.last_stats["backward"]["status"] == 0).all()
    assert adams_history_attempt.launches == launches
    for got, ref, gold in zip(out[cuda], out["cpu"], (g["gy"], g["gp"])):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=1e-6)
        np.testing.assert_allclose(got, gold, rtol=2e-3, atol=1e-3)


def test_pece_2d_kernel_matches_plain_and_kernel1(cuda):
    x = exp_pece2d.make_inputs(B, cuda)
    fns = exp_pece2d.arms(x)
    before = pece_2d_attempt.launches
    got = fns["kernel2"](x["y_prev"])
    assert pece_2d_attempt.launches == before + 1
    ref = pece_2d_reference(x["DF2"], x["y_prev"], x["h"], x["t"], x["params"])
    k1 = fns["kernel1"](x["y_prev"])  # fixed-sweep mode, p = 6, padded history
    torch.cuda.synchronize()
    # FMA contraction and the symbolic RHS's own rounding only
    for other in (ref, k1):
        for name, a, b in zip(("y", "d_f", "err"), got, other):
            assert float((a - b).abs().max() / b.abs().max()) <= 1e-12, name


def test_pece_2d_kernel_refuses_bad_history(cuda):
    x = exp_pece2d.make_inputs(B, cuda)
    rest = (x["y_prev"], x["h"], x["t"], x["params"])
    with pytest.raises(ValueError, match="DF2"):
        pece_2d_attempt(x["DF2"].t().contiguous().t(), *rest)  # non-contiguous
    with pytest.raises(ValueError, match="DF2"):
        pece_2d_attempt(x["DF2"][:-1], *rest)  # not whole blocks
    with pytest.raises(ValueError, match="DF2"):
        pece_2d_attempt(x["DF2"][None], *rest)  # not 2-D


@pytest.mark.parametrize("mode", ["resolve", "hermite", "polynomial"])
def test_cuda_adams_modes_match_cpu(cuda, mode):
    """``build_lv_adams`` on the 16 lanes of lv_adjoint.npz: every forward
    and backward attempt on the card through the history-attempt kernel,
    the gradients within 1e-6 of the CPU's and inside the golden gate."""
    g = np.load(Path(__file__).parent / "golden" / "lv_adjoint.npz")
    out = {}
    for device in (cuda, "cpu"):
        step, _ = build_lv_adams(16, 21, 1e-8, mode, device=device)
        f64 = dict(dtype=torch.float64, device=device)
        launches = adams_history_attempt.launches
        grads = step(torch.as_tensor(g["y0s"], **f64), torch.as_tensor(g["p_subs"], **f64))
        stats = step.solve.last_stats
        attempts = stats["forward"]["n_attempts"] + stats["backward"]["n_attempts"]
        expected = attempts if device == cuda else 0
        assert adams_history_attempt.launches - launches == expected
        assert (stats["backward"]["status"] == 0).all()
        out[device] = [a.cpu().numpy() for a in grads]
    for got, ref, gold in zip(out[cuda], out["cpu"], (g["gy"], g["gp"])):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=1e-6)
        np.testing.assert_allclose(got, gold, rtol=2e-3, atol=1e-3)


def _relerr(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("kind", ["forward", "transition", "resolve", "staged_adjoint",
                                  "staged_sensitivity"])
def test_split_kernels_match_plain(cuda, kind):
    """A CUDA attempt without an emitted system goes to the split kernels:
    one predict, four sweeps and one finish, against the plain stages
    composed on the card (and the fused plain version) within 1e-12
    normwise, ``conv``/``niter`` equal; the systems' own ``fz`` in torch."""
    system = _system(kind)
    no_device = PeceSystem(fz=system.fz, n=system.n, nz=system.nz)
    args = _history_case(system, cuda, 4)
    before = dict(adams_split_attempt.launches)
    history = adams_history_attempt.launches
    got = adams_history_attempt(no_device, *args)
    ref = adams_split_attempt_reference(no_device, *args)
    fused = adams_history_attempt_reference(no_device, *args)
    torch.cuda.synchronize()
    assert adams_history_attempt.launches == history
    assert {k: v - before[k] for k, v in adams_split_attempt.launches.items()} == {
        "predict": 1, "sweep": FUNCTIONAL_MAXITER, "finish": 1}
    for name in ("DF_resc", "DF_upd", "z_pred", "z_new", "err0", "err3"):
        assert _relerr(getattr(got, name), getattr(ref, name)) <= 1e-12, name
        assert _relerr(getattr(got, name), getattr(fused, name)) <= 1e-12, name
    assert torch.equal(got.conv, ref.conv) and torch.equal(got.niter, ref.niter)


def test_split_kernels_at_many_chunks(cuda):
    """SIR over 200 regions (600 rows: ten row chunks) at a ragged 100 lanes
    (four lane tiles), stage by stage against the plain stages."""
    R, B = 200, 100
    rng = np.random.default_rng(9)
    KAB, nz = 11, 3 * R
    f64 = dict(dtype=torch.float64, device=cuda)
    T = lambda a: torch.as_tensor(a, **f64)  # noqa: E731
    DF = T(1e-2 * rng.standard_normal((KAB, nz, B)) * (0.5 ** np.arange(KAB))[:, None, None])
    p = torch.as_tensor(rng.integers(1, 9, B).astype(np.int32), device=cuda)
    pre, h = T(np.exp(rng.uniform(np.log(0.2), np.log(2.0), B))), T(10.0 ** rng.uniform(-3, 0, B))
    z_prev = T(np.repeat([0.99, 0.01, 0.01], R)[:, None] * (1 + 0.05 * rng.uniform(size=(nz, B))))
    params = T(np.array([0.4, 0.15, 0.05])[:, None] * (1 + 0.05 * rng.standard_normal((3, B))))
    atol, rtol = T(np.full(nz, 1e-10)), T(np.full(nz, 1e-8))
    active = torch.as_tensor(rng.uniform(size=B) < 0.9, device=cuda)
    t = T(rng.uniform(0.0, 60.0, B))
    fz = sir_problem(R).make_rhs()
    kernels = adams_split.build_split_kernels(KAB)
    pk = kernels.predict(DF, p, pre, h, z_prev, atol, rtol)
    pp = adams_split.split_predict(DF, p, pre, h, z_prev, atol, rtol, 8)
    for name in ("DF_resc", "z_pred", "f_ex", "w_z", "c_A"):
        assert _relerr(getattr(pk, name), getattr(pp, name)) <= 1e-12, name
    assert torch.equal(pk.pred_ok, pp.pred_ok)
    y, state = pp.z_pred[:nz], adams_split.sweep_start(active)
    for k in range(FUNCTIONAL_MAXITER):
        fz_k = fz(t, y, params)
        yk, sk = kernels.sweep(k, fz_k, y, pp, state, 1e-3, nz)
        y, state = adams_split.split_sweep(k, fz_k, y, pp, state, 1e-3, nz)
        assert _relerr(yk, y) <= 1e-12
        for f in ("conv", "div", "bad", "niter"):
            assert torch.equal(getattr(sk, f), getattr(state, f)), f
    gsa, v = T(np.abs(_GAMMA_STAR)), T(np.full(nz, 1.0 / nz))
    fin_in = (fz(t, y, params), pp, state, p, h, gsa, v, 1e-3)
    fk, fp = kernels.finish(*fin_in), adams_split.split_finish(*fin_in, 8)
    for name in ("DF_upd", "z_new", "err0", "err3"):
        assert _relerr(getattr(fk, name), getattr(fp, name)) <= 1e-12, name
    assert torch.equal(fk.conv, fp.conv)


@pytest.mark.parametrize("kind,B", [("resolve", 100), ("staged_adjoint", 40)])
def test_split_kernels_at_backward_shapes(cuda, kind, B):
    """chip_smoke.py's phase 3d at SIR over 200 regions: the backward
    systems, whose corrected rows are fewer than the history's (n < nz: the
    quadratures stay out of dy_norm and y_next), over 19 and 10 row chunks,
    stage by stage against the plain stages, per-lane errors on err3, c_A
    and dy_old; it exits on a disagreement."""
    out = _chip_smoke().compare_split(kind, B, 5, adams_split.build_split_kernels(11), R=200)
    assert out["n"] == (1200 if kind == "resolve" else 600)


# the sweep's path shapes (nz, n, B): SIR-1000's forward attempts at B=1,024
# and 256, its 'resolve' and staged 'hermite' backward attempts, and the
# sensitivity block of Lotka-Volterra's staggered solve at B=10,000
SWEEP_SHAPES = [(3000, 3000, 1024), (6002, 6000, 1024), (3002, 3000, 256), (3000, 3000, 256),
                (4, 4, 10_000)]


def _sweep_case(nz, n, B, seed, device):
    """Seeded inputs of one sweep: a prediction near 1 with error weights at
    rtol 1e-8, an iterate and f within small corrections of it, steps
    log-uniform, and a state with a tenth of the lanes converged, a tenth
    diverged, a tenth bad, some not yet swept (dy_old inf)."""
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=device)
    T = lambda a: torch.as_tensor(a, **f64)  # noqa: E731
    z_pred = 1.0 + rng.uniform(size=(nz, B))
    f_ex = rng.standard_normal((nz, B))
    pred = adams_split.Predicted(
        torch.empty(0, **f64), T(z_pred), T(f_ex), T(1.0 / (1e-10 + 1e-8 * z_pred)),
        T(10.0 ** rng.uniform(-6, -2, B)), torch.ones(B, dtype=torch.bool, device=device))
    fz = T(f_ex + 1e-4 * rng.standard_normal((nz, B)))
    y_it = T(z_pred[:n] + 1e-9 * rng.standard_normal((n, B)))
    flags = rng.uniform(size=(3, B)) < 0.1
    dy_old = np.where(rng.uniform(size=B) < 0.1, np.inf, 10.0 ** rng.uniform(-3, 3, B))
    state = adams_split.SweepState(
        *(torch.as_tensor(f, device=device) for f in flags), T(dy_old),
        torch.as_tensor(rng.integers(0, 3, B).astype(np.int32), device=device))
    return fz, y_it, pred, state


def _same(a, b) -> bool:
    """Bit for bit, a NaN equal to a NaN (a lane whose f is not finite)."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())


def _sweep_against_plain(fz, y_it, pred, state, n, k=1, newton_tol=1e-1):
    """The sweep kernel against ``split_sweep``: y_next bit for bit, dy_old
    within 1e-12 lane by lane (the sums over the rows add in another order),
    conv, div, bad and niter equal, and a second launch bit for bit the
    first; returns the kernel's state."""
    kernels = adams_split.build_split_kernels(11)
    before = adams_split_attempt.launches["sweep"]
    y_k, st_k = kernels.sweep(k, fz, y_it, pred, state, newton_tol, n)
    y_k2, st_k2 = kernels.sweep(k, fz, y_it, pred, state, newton_tol, n)
    y_p, st_p = adams_split.split_sweep(k, fz, y_it, pred, state, newton_tol, n)
    torch.cuda.synchronize()
    assert adams_split_attempt.launches["sweep"] == before + 2
    assert _same(y_k, y_p)
    assert _same(y_k, y_k2) and all(_same(a, b) for a, b in zip(st_k, st_k2))
    for f in ("conv", "div", "bad", "niter"):
        assert torch.equal(getattr(st_k, f), getattr(st_p, f)), f
    fin = torch.isfinite(st_p.dy_old)
    assert torch.equal(fin, torch.isfinite(st_k.dy_old))
    rel = (st_k.dy_old[fin] - st_p.dy_old[fin]).abs() / st_p.dy_old[fin].abs()
    assert float(rel.max()) <= 1e-12
    return st_k


def _lane_major(fz):
    """``fz`` laid out as a right-hand side mapped over the lanes returns
    it: the transpose of a contiguous (B, nz)."""
    return fz.t().contiguous().t()


@pytest.mark.parametrize("layout", ["row-major", "lane-major"])
@pytest.mark.parametrize("nz, n, B", SWEEP_SHAPES)
def test_split_sweep_matches_plain_at_path_shapes(cuda, nz, n, B, layout):
    """The sweep at each shape the card's paths give it, on the geometry
    ``sweep_geometry`` chooses there (clusters of 8 and 16 blocks, and
    none at the sensitivity block), with f row-major and lane-major."""
    fz, y_it, pred, state = _sweep_case(nz, n, B, 40, cuda)
    if layout == "lane-major":
        fz = _lane_major(fz)
    st = _sweep_against_plain(fz, y_it, pred, state, n)
    assert st.conv.any() and not st.conv.all()


@pytest.mark.parametrize("nz, n, B, layout", [(3002, 3000, 256, "row-major"),
                                               (3000, 3000, 1024, "lane-major"),
                                               (4, 4, 10_000, "lane-major")])
def test_split_sweep_finds_a_nonfinite_last_row(cuda, nz, n, B, layout):
    """A lane whose only non-finite f is in the last row, which the last
    block of its lane tile's cluster holds (a quadrature row where n < nz),
    is bad after the sweep, as in the plain sweep."""
    fz, y_it, pred, state = _sweep_case(nz, n, B, 41, cuda)
    state = state._replace(conv=torch.zeros_like(state.conv), div=torch.zeros_like(state.div),
                           bad=torch.zeros_like(state.bad))
    g = adams_split.sweep_geometry(nz, B)
    assert (g.cluster - 1) * g.rows <= nz - 1 < g.cluster * g.rows
    lane = B - 1 - g.lanes // 2  # inside the last lane tile
    fz = fz.clone()
    fz[nz - 1, lane] = float("nan")
    if layout == "lane-major":
        fz = _lane_major(fz)
    st = _sweep_against_plain(fz, y_it, pred, state, n)
    assert bool(st.bad[lane]) and int(st.bad.sum()) == 1


# predict's path shapes (chip_smoke.split_inputs' kinds at B): SIR-1000's
# forward and 'resolve' backward at B=1,024, its staged 'hermite' backward and
# forward at B=256, and the sensitivity block of Lotka-Volterra's staggered
# solve at B=10,000 (history depth 9)
PREDICT_SHAPES = [("forward", 1024), ("resolve", 1024), ("staged_adjoint", 256),
                  ("forward", 256), ("staged_sensitivity", 10_000)]


def _predict_against_plain(args, keep):
    """Predict's kernel against ``split_predict`` in the lanes ``keep``: all
    six outputs bit for bit (a NaN equal to a NaN), and a second launch on
    the same inputs bit for bit the first in every lane; returns the
    kernel's outputs."""
    kab = args[0].shape[0]
    kernels = adams_split.build_split_kernels(kab)
    before = adams_split_attempt.launches["predict"]
    got, again = kernels.predict(*args), kernels.predict(*args)
    ref = adams_split.split_predict(*args, kab - 3)
    torch.cuda.synchronize()
    assert adams_split_attempt.launches["predict"] == before + 2
    for name in adams_split.Predicted._fields:
        assert _same(getattr(got, name)[..., keep], getattr(ref, name)[..., keep]), name
        assert _same(getattr(got, name), getattr(again, name)), name
    return got


@pytest.mark.parametrize("kind, B", PREDICT_SHAPES)
def test_split_predict_matches_plain_at_path_shapes(cuda, kind, B):
    """Predict at each shape the card's paths give it, on the geometry
    ``predict_geometry`` chooses there (clusters of 16 blocks, and none at
    the sensitivity block), at phase 3d's seeded orders and with
    every lane at p = 1 and at P_MAX: bit for bit the plain version's.  One
    lane's order lies outside the history (its outputs NaN, pred_ok false),
    and one history element, in the last row (which the last block of its
    tile's cluster holds), is infinite: pred_ok is false in that lane alone,
    and the NaNs spread as in the plain version."""
    x = _chip_smoke().split_inputs(B, 50, cuda, kind=kind)
    DF, p = x["DF"].clone(), x["p"].clone()
    kab, nz = DF.shape[0], DF.shape[1]
    g = adams_split.predict_geometry(nz, B)
    assert (g.cluster - 1) * g.rows <= nz - 1 < g.cluster * g.rows
    bad_order, bad_row = B - 1 - g.lanes // 2, B // 3
    p[bad_order] = kab - 1  # p <= KAB - 2 is the history's
    DF[0, nz - 1, bad_row] = float("inf")
    args = [DF, p, x["pre_factor"], x["h"], x["z_prev"], x["atol_z"], x["rtol_z"]]
    keep = torch.ones(B, dtype=torch.bool, device=cuda)
    keep[bad_order] = False
    got = _predict_against_plain(args, keep)
    for name in ("DF_resc", "z_pred", "f_ex", "w_z", "c_A"):
        assert torch.isnan(getattr(got, name)[..., bad_order]).all(), name
    lanes = torch.arange(B, device=cuda)
    assert torch.equal(got.pred_ok, (lanes != bad_order) & (lanes != bad_row))
    for order in (1, kab - 3):
        args[1] = torch.full_like(p, order)
        got = _predict_against_plain(args, torch.ones_like(keep))
        assert torch.equal(got.pred_ok, lanes != bad_row)
    launches = adams_split_attempt.launches["predict"]
    # a block short of the rows, an empty block, or a tile wider than
    # predict's tables is refused before any launch
    kernels = adams_split.build_split_kernels(kab)
    for bad in (g._replace(rows=g.rows - 1), g._replace(cluster=g.cluster + 1),
                adams_split.SweepGeometry(64, nz, 1, -(-B // 64))):
        with pytest.raises(ValueError, match="geometry"):
            kernels.predict(*args, geometry=bad)
        assert adams_split_attempt.launches["predict"] == launches


def test_split_kernels_refuse_bad_inputs(cuda):
    kernels = adams_split.build_split_kernels(11)
    f64 = dict(dtype=torch.float64, device=cuda)
    B, nz = 40, 6
    DF = torch.zeros((11, nz, B), **f64)
    p = torch.ones(B, dtype=torch.int32, device=cuda)
    lanes = torch.ones(B, **f64)
    rows = torch.ones(nz, **f64)
    with pytest.raises(ValueError, match="^DF:"):
        kernels.predict(torch.zeros((9, nz, B), **f64), p, lanes, lanes, lanes.expand(nz, B),
                        rows, rows)
    with pytest.raises(ValueError, match="^p:"):
        kernels.predict(DF, p.long(), lanes, lanes, torch.ones((nz, B), **f64), rows, rows)
    with pytest.raises(ValueError, match="^z_prev:"):
        kernels.predict(DF, p, lanes, lanes, torch.ones((B, nz), **f64).T, rows, rows)
    pred = kernels.predict(DF, p, lanes, lanes, torch.ones((nz, B), **f64), rows, rows)
    state = adams_split.sweep_start(torch.ones(B, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError, match="^fz_k:"):
        kernels.sweep(0, torch.ones((nz, B + 1), **f64), pred.z_pred, pred, state, 1e-3, nz)
    with pytest.raises(ValueError, match="^gamma_star_abs:"):
        kernels.finish(torch.ones((nz, B), **f64), pred, state, p, lanes,
                       torch.ones(5, **f64), rows, 1e-3)


@pytest.mark.parametrize("mode", ["resolve", "hermite"])
def test_cuda_sir_matches_cpu(cuda, mode):
    """``build_sir`` at 30 regions on 8 lanes: every attempt through the
    split kernels (no fused launch, no plain stage), the gradients within
    1e-8 of the CPU's."""
    step_c, (y0s, p_subs) = build_sir(30, 8, mode, device=cuda)
    step_h, _ = build_sir(30, 8, mode, device="cpu")
    before = dict(adams_split_attempt.launches)
    history = adams_history_attempt.launches
    calls = adams_split.split_predict.calls
    ys_c, gp_c = step_c(y0s, p_subs)
    stats = step_c.solve.last_stats
    attempts = stats["forward"]["n_attempts"] + stats["backward"]["n_attempts"]
    assert {k: v - before[k] for k, v in adams_split_attempt.launches.items()} == {
        "predict": attempts, "sweep": FUNCTIONAL_MAXITER * attempts, "finish": attempts}
    assert adams_history_attempt.launches == history
    assert adams_split.split_predict.calls == calls
    ys_h, gp_h = step_h(y0s.cpu(), p_subs.cpu())
    np.testing.assert_allclose(ys_c.cpu().numpy(), ys_h.numpy(), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(gp_c.cpu().numpy(), gp_h.numpy(), rtol=1e-8)


def test_cuda_torch_problem_transition_matches_cpu(cuda):
    """The transition adjoint of a TorchProblem (SIR over 2 regions: 6
    states, 42 backward rows) reaches the split kernels through its ``fz``
    closure, forward and backward, and matches the CPU within 1e-8."""
    out = {}
    for device in (cuda, "cpu"):
        solve = make_batched_solve_fn(
            sir_problem(2), options=BDFOptions(rtol=1e-8, atol=1e-10),
            adjoint_options=BDFOptions(rtol=1e-8, atol=1e-10), method="ADAMS",
            adjoint_interpolation="transition",
        )
        f64 = dict(dtype=torch.float64, device=device)
        y0 = torch.tensor([[0.99, 0.98, 0.01, 0.02, 0.0, 0.0]] * 4, **f64)
        p_sub = torch.tensor([[0.4, 0.15], [0.42, 0.14], [0.38, 0.16], [0.41, 0.15]],
                             **f64).requires_grad_(True)
        before = adams_split_attempt.launches["predict"]
        ys = solve(0.0, y0, p_sub, torch.tensor([0.05], **f64),
                   torch.linspace(5.0, 30.0, 4, **f64))
        (gp,) = torch.autograd.grad(torch.sum(ys[:, :, 2:4] ** 2), (p_sub,))
        stats = solve.last_stats
        attempts = stats["forward"]["n_attempts"] + stats["backward"]["n_attempts"]
        expected = attempts if device == cuda else 0
        assert adams_split_attempt.launches["predict"] - before == expected
        assert (stats["backward"]["status"] == 0).all()
        out[device] = (ys.detach().cpu().numpy(), gp.cpu().numpy())
    for got, ref in zip(out[cuda], out["cpu"]):
        np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("method, mode", LV_SENS_MODES, ids=["-".join(m) for m in LV_SENS_MODES])
def test_cuda_lv_sens_matches_cpu(cuda, method, mode):
    """``build_lv_sens`` on the 16 lanes of lv_sens.npz: on the Adams core
    every attempt is one launch of the forward and one of the
    'staged_sensitivity' build (staggered) or one of the 'sensitivity' build
    (simultaneous), none on the BDF core; ys and sensitivities within 1e-8
    of the CPU's (floored at 1e-9) and inside the fixture's gate."""
    g = np.load(Path(__file__).parent / "golden" / "lv_sens.npz")
    problem = lv_problem()
    kinds = {"forward": cuda_codegen.forward_system(problem),
             "sensitivity": cuda_codegen.sensitivity_system(problem),
             "staged_sensitivity": cuda_codegen.staged_sensitivity_system(problem)}
    out = {}
    for device in (cuda, "cpu"):
        solve, (y0s, ps, tvals) = build_lv_sens(16, method, mode, device=device)
        before = {k: build_attempt_kernel(ds, 9).launches for k, ds in kinds.items()}
        res = solve(y0s, ps, tvals)
        assert (res.status == 0).all()
        out[device] = (res.ys.cpu().numpy(), res.sens.cpu().numpy())
        if device == cuda:
            n = res.stats["n_attempts"]
            want = ({} if method == "BDF" else
                    {"forward": n, "staged_sensitivity": n} if mode == "staggered" else
                    {"sensitivity": n})
            got = {k: build_attempt_kernel(ds, 9).launches - before[k] for k, ds in kinds.items()}
            assert {k: v for k, v in got.items() if v} == want
    for got, ref in zip(out[cuda], out["cpu"]):
        assert np.max(np.abs(got - ref) / (np.abs(ref) + 1e-9)) <= 1e-8
    np.testing.assert_allclose(out[cuda][0], g["ys"], rtol=5e-6 if mode == "simultaneous" else 1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(out[cuda][1], g["sens"], rtol=2e-4, atol=5e-4)


@pytest.mark.parametrize("method", ["BDF", "ADAMS"])
@pytest.mark.parametrize("terminal", [True, False])
def test_cuda_lv_roots_match_cpu(cuda, method, terminal):
    """``build_lv_roots`` on 16 lanes: statuses, n_roots and directions
    equal to the CPU's, root times within 1e-8 (non-terminal with falling
    crossings only)."""
    directions = None if terminal else [-1]
    out = {}
    for device in (cuda, "cpu"):
        solve, (y0s, ps, tvals) = build_lv_roots(16, method, terminal, device=device)
        res = solve(y0s, ps, tvals, root_directions=directions)
        out[device] = (res.status.cpu().numpy(),
                       *(res.stats[k].cpu().numpy() for k in ("n_roots", "roots_found", "roots_t")))
    for got, ref in zip(out[cuda][:3], out["cpu"][:3]):
        np.testing.assert_array_equal(got, ref)
    hit = np.isfinite(out["cpu"][3])
    assert hit[:, 0].all() and np.array_equal(np.isfinite(out[cuda][3]), hit)
    np.testing.assert_allclose(out[cuda][3][hit], out["cpu"][3][hit], rtol=1e-8)


def test_cuda_torch_problem_staggered_matches_cpu(cuda):
    """Staggered sensitivities of SIR over 30 regions written in torch (a
    ``TorchProblem``, no emitted system) on 8 lanes: the state and the
    sensitivity block both through the split kernels, two predicts an
    attempt, no fused launch; within 1e-8 of the CPU's."""
    problem = sir_problem(30)
    rng = np.random.default_rng(8)
    y0s = np.concatenate([0.99 + 0.005 * rng.standard_normal((8, 30)),
                          0.01 * (1 + 0.1 * np.abs(rng.standard_normal((8, 30)))),
                          np.zeros((8, 30))], axis=1)
    ps = np.array([0.4, 0.15, 0.05]) * (1 + 0.05 * rng.standard_normal((8, 3)))
    out = {}
    for device in (cuda, "cpu"):
        f64 = dict(dtype=torch.float64, device=device)
        before, history = adams_split_attempt.launches["predict"], adams_history_attempt.launches
        res = adams_solve_batched(
            problem.make_rhs(), 0.0, torch.as_tensor(y0s, **f64), torch.as_tensor(ps, **f64),
            torch.linspace(5.0, 30.0, 4, **f64),
            BDFOptions(rtol=1e-8, atol=1e-10, sens_staggered=True), batched_fns=True,
            sens_rhs=problem.make_sensitivity_rhs(), sens0=torch.zeros((8, 2, 90), **f64),
        )
        assert (res.status == 0).all()
        expected = 2 * res.stats["n_attempts"] if device == cuda else 0
        assert adams_split_attempt.launches["predict"] - before == expected
        assert adams_history_attempt.launches == history
        out[device] = (res.ys.cpu().numpy(), res.sens.cpu().numpy())
    for got, ref in zip(out[cuda], out["cpu"]):
        assert np.max(np.abs(got - ref) / (np.abs(ref) + 1e-12)) <= 1e-8


HISTORY_KINDS = ["forward", "transition", "resolve", "staged_adjoint", "sensitivity",
                 "staged_sensitivity"]


def _f32(args):
    """A history case at float32: its floating tensors rounded, with
    lv_adjoint_f32's forward tolerances (rtol = atol = 1e-6 on every row)
    and their float32 corrector tolerance (``newton_tol_for``), as float32
    solves meet it; at the float64 case's 1e-7 the corrector's tests would
    compare rounding noise."""
    from sunode_torch.ops.bdf import newton_tol_for

    out = [a.float() if torch.is_tensor(a) and a.is_floating_point() else a for a in args]
    out[8], out[9] = torch.full_like(out[8], 1e-6), torch.full_like(out[9], 1e-6)
    out[12] = newton_tol_for(BDFOptions(rtol=1e-6, atol=1e-6), 1e-6, torch.float32)
    return out


@pytest.mark.parametrize("kab", [9, 11])
@pytest.mark.parametrize("kind", HISTORY_KINDS)
def test_history_kernel_f32_matches_plain(cuda, kind, kab):
    """The float32 build of every emitted system against the plain version at
    float32: DF_resc and z_pred bit for bit, the rest within 1e-5 normwise
    (float32's rounding of the emitted right-hand side where it is not the
    plain one's) and bit for bit where the emitted f equals the plain f;
    every output float32."""
    system = _system(kind, "float")
    got = _history_against_plain(system, _f32(_history_case(system, cuda, 2, kab)), tol=1e-5)
    assert all(getattr(got, name).dtype == torch.float32 for name in HISTORY_FIELDS)


def test_kernels_refuse_mixed_types(cuda):
    """A launch whose floating inputs are not all of its build's type raises,
    on the history kernel and on the split kernels; nothing is cast."""
    system = _system("forward", "float")
    args = _f32(_history_case(system, cuda, 3))
    args[6] = args[6].double()  # z_prev float64 beside a float32 history
    with pytest.raises(ValueError, match="^z_prev:"):
        adams_history_attempt(system, *args)
    with pytest.raises(ValueError, match="^DF:"):  # a float64 attempt on the float32 build
        adams_history_attempt(system, *_history_case(system, cuda, 3))
    no_device = PeceSystem(fz=system.fz, n=system.n, nz=system.nz)
    args = _f32(_history_case(system, cuda, 3))
    args[2] = args[2].double()  # pre_factor
    with pytest.raises(ValueError, match="^pre_factor:"):
        adams_history_attempt(no_device, *args)
    kernels = adams_split.build_split_kernels(9, torch.float32)
    args = _f32(_history_case(system, cuda, 3))
    pred = kernels.predict(*(args[i] for i in (5, 3, 2, 1, 6, 8, 9)))
    state = adams_split.sweep_start(args[4], torch.float64)  # dy_old float64
    with pytest.raises(ValueError, match="^dy_old:"):
        kernels.sweep(0, system.fz(args[0], pred.z_pred, args[7]), pred.z_pred, pred, state,
                      1e-3, 2)


@pytest.mark.parametrize("kind", ["forward", "resolve", "staged_adjoint"])
def test_split_kernels_f32_match_plain(cuda, kind):
    """The split attempt on float32 inputs runs the float32 build (its own
    counts; the float64 build's unchanged), against the plain stages
    composed at float32 on the card: DF_resc and z_pred bit for bit, the
    rest within 1e-5 normwise (the row sums' order), flags equal."""
    system = _system(kind)
    no_device = PeceSystem(fz=system.fz, n=system.n, nz=system.nz)
    args = _f32(_history_case(system, cuda, 4))
    f32_build = adams_split.build_split_kernels(9, torch.float32)
    before = dict(f32_build.launches)
    got = adams_history_attempt(no_device, *args)
    ref = adams_split_attempt_reference(no_device, *args)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in f32_build.launches.items()} == {
        "predict": 1, "sweep": FUNCTIONAL_MAXITER, "finish": 1}
    for name in ("DF_resc", "z_pred"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    for name in ("DF_upd", "z_new", "err0", "err3"):
        assert getattr(got, name).dtype == torch.float32
        assert _relerr(getattr(got, name), getattr(ref, name)) <= 1e-5, name
    assert torch.equal(got.conv, ref.conv) and torch.equal(got.niter, ref.niter)


def test_split_kernels_f32_stage_by_stage(cuda):
    """chip_smoke.py's phase 10(a) at SIR over 200 regions and 100 lanes:
    each float32 kernel against its plain stage at float32 (1e-5; it exits
    on a disagreement)."""
    out = _chip_smoke().compare_split("forward", 100, 5,
                                      adams_split.build_split_kernels(11, torch.float32), R=200,
                                      dtype=torch.float32)
    assert out["x"]["DF"].dtype == torch.float32


def test_cuda_lv_adjoint_f32_launches_the_f32_builds(cuda):
    """``build_lv_adjoint_f32`` on the 16 golden lanes: float32 gradients
    inside bench.py's gate (1e-2 worst lane against lv_adjoint.npz), every
    attempt one launch of the float32 forward or transition build and no
    other launch."""
    step, (y0s, p_subs) = build_lv_adjoint_f32(16, device=cuda)
    builds = {kind: build_attempt_kernel(step.solve.device_system(kind, cuda, torch.float32), 9)
              for kind in ("forward", "transition")}
    before = {kind: k.launches for kind, k in builds.items()}
    total = adams_history_attempt.launches
    gy, gp = step(y0s, p_subs)
    stats = step.solve.last_stats
    assert {kind: k.launches - before[kind] for kind, k in builds.items()} == {
        "forward": stats["forward"]["n_attempts"], "transition": stats["backward"]["n_attempts"]}
    assert adams_history_attempt.launches - total == sum(
        stats[s]["n_attempts"] for s in ("forward", "backward"))
    assert gy.dtype == gp.dtype == torch.float32
    golden = np.load(Path(__file__).resolve().parent / "golden" / "lv_adjoint.npz")
    err = np.max(np.abs(gy.cpu().numpy().astype(np.float64) - golden["gy"])
                 / (np.abs(golden["gy"]) + 1e-3))
    assert err < 1e-2


def test_cuda_sir_f32_launches_the_f32_build(cuda):
    """``build_sir`` at float32 (30 regions, 4 lanes, 'resolve'): every
    attempt through the float32 split build, none through the float64 one,
    the gradient within 1e-2 of the float64 run's."""
    out = {}
    for dtype in (torch.float64, torch.float32):
        step, (y0s, p_subs) = build_sir(30, 4, "resolve", device=cuda, dtype=dtype)
        build = adams_split.build_split_kernels(11, dtype)
        other = adams_split.build_split_kernels(
            11, torch.float64 if dtype == torch.float32 else torch.float32)
        before, before_other = dict(build.launches), dict(other.launches)
        ys, gp = step(y0s, p_subs)
        stats = step.solve.last_stats
        attempts = stats["forward"]["n_attempts"] + stats["backward"]["n_attempts"]
        assert {k: v - before[k] for k, v in build.launches.items()} == {
            "predict": attempts, "sweep": FUNCTIONAL_MAXITER * attempts, "finish": attempts}
        assert other.launches == before_other
        assert ys.dtype == gp.dtype == dtype and (stats["backward"]["status"] == 0).all()
        out[dtype] = gp.cpu().numpy().astype(np.float64)
    np.testing.assert_allclose(out[torch.float32], out[torch.float64], rtol=1e-2)


@pytest.mark.parametrize("method", ["ADAMS", "BDF"])
def test_cuda_lv_per_lane_matches_cpu(cuda, method):
    """``build_lv_per_lane`` on 64 ragged grids: status 0, the CPU's ys
    within 1e-8, padded slots their lane's last value bit for bit, and on
    the Adams core one history launch an attempt."""
    solve, (y0s, ps, tvals) = build_lv_per_lane(64, method, device=cuda)
    total = adams_history_attempt.launches
    res = solve(y0s, ps, tvals)
    launches = adams_history_attempt.launches - total
    assert launches == (res.stats["n_attempts"] if method == "ADAMS" else 0)
    assert (res.status == 0).all()
    cpu, inputs = build_lv_per_lane(64, method, device="cpu")
    ref = cpu(*inputs)
    np.testing.assert_allclose(res.ys.cpu().numpy(), ref.ys.numpy(), rtol=1e-8, atol=1e-8)
    ys, tv = res.ys.cpu(), tvals.cpu()
    last = (tv == tv[:, -1:]).int().argmax(dim=1)  # the first slot at the lane's last time
    for b in range(64):
        assert torch.equal(ys[b, last[b]:], ys[b, last[b]].expand_as(ys[b, last[b]:]))


# ---- the banded LU's kernels and the structured Newton paths ---------------------
def _banded_case(n, l, u, B, dtype, device, seed):
    """Random band entries (lane 1 zero: singular; lane 2 a NaN first pivot),
    and three right-hand sides."""
    rng = np.random.default_rng(seed)
    ab = rng.standard_normal((l + u + 1, n, B))
    ab[:, :, 1] = 0.0
    ab[u, 0, 2] = np.nan
    b = rng.standard_normal((3, n, B))
    return (torch.as_tensor(ab, dtype=dtype, device=device),
            torch.as_tensor(b, dtype=dtype, device=device))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("l, u", [(1, 1), (2, 1), (0, 2), (3, 0), (4, 3)])
@pytest.mark.parametrize("n, B", [(37, 45), (1, 45), (200, 77), (1500, 45)])
def test_banded_kernels_match_plain(cuda, l, u, dtype, n, B):
    """lu, piv, sing and the solutions (one and three right-hand sides,
    poisoned and not) bit for bit the plain versions', with partial lane
    tiles (B = 45 and 77), the singular lane NaN in both: at n = 1, at n
    over several ring chunks, and at n = 1,500, whose solve keeps only its
    last rows in shared memory (the rest leave through x and come back)."""
    from sunode_torch.ops import banded as bd

    bits = _chip_smoke().bits_equal
    ab, b = _banded_case(n, l, u, B, dtype, cuda, l + 7 * u + n)
    itemsize = torch.finfo(dtype).bits // 8
    kernels = bd.build_banded_kernels(l, u, dtype)
    for m in (1, 3):
        g = bd.banded_geometry(n, B, l, u, itemsize, m)
        assert kernels._lib.banded_factor_smem(g.factor_rows) == g.factor_smem
        assert kernels._lib.banded_solve_smem(g.solve_rows, g.keep) == g.solve_smem
        assert (g.keep < n) == (n == 1500)
    before = (bd.banded_factor.launches, bd.banded_solve.launches)
    got, ref = bd.banded_factor(ab, l, u), bd.banded_factor_reference(ab, l, u)
    for x, y in zip(got, ref):
        assert bits(x, y)
    for m in (1, 3):
        for sing in (got[2], None):
            x = bd.banded_solve((got[0], got[1], sing), b[:m].contiguous(), l, u)
            y = bd.banded_solve_reference((ref[0], ref[1], sing), b[:m].contiguous(), l, u)
            assert bits(x, y)
            if sing is not None:  # unpoisoned, the zero pivot gives inf or NaN
                assert torch.isnan(x[:, :, 1]).all()
    assert (bd.banded_factor.launches, bd.banded_solve.launches) == (before[0] + 1,
                                                                     before[1] + 4)
    assert bool(got[2][1])
    if n == 37:  # the long random bands at (3, 0) underflow pivots in other lanes too
        assert not bool(got[2][0])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("l, u", [(1, 1), (2, 1), (0, 2)])
@pytest.mark.parametrize("n", [1, 37, 200])
def test_banded_kernels_match_plain_at_one_lane(cuda, l, u, dtype, n):
    """B=1, the single-instance cores' width: one lane tile with 31 idle
    lanes, a lane stride of one value for the producer's copies; lu, piv,
    sing and the solutions (one and three right-hand sides) bit for bit the
    plain versions', and one launch a call."""
    from sunode_torch.ops import banded as bd

    bits = _chip_smoke().bits_equal
    rng = np.random.default_rng(l + 7 * u + n)
    ab = torch.as_tensor(rng.standard_normal((l + u + 1, n, 1)), dtype=dtype, device=cuda)
    b = torch.as_tensor(rng.standard_normal((3, n, 1)), dtype=dtype, device=cuda)
    before = (bd.banded_factor.launches, bd.banded_solve.launches)
    got, ref = bd.banded_factor(ab, l, u), bd.banded_factor_reference(ab, l, u)
    for x, y in zip(got, ref):
        assert bits(x, y)
    for m in (1, 3):
        x = bd.banded_solve(got, b[:m].contiguous(), l, u)
        assert bits(x, bd.banded_solve_reference(ref, b[:m].contiguous(), l, u))
    assert (bd.banded_factor.launches, bd.banded_solve.launches) == (before[0] + 1,
                                                                     before[1] + 2)


def test_single_surface_on_the_card(cuda):
    """make_solve_fn's gradient on the card (the dense Newton in
    torch.linalg) against the CPU's, and build_kpp_single's banded
    gradient: its banded launches equal to the Newton solver's calls, within
    rtol 1e-4 / atol 1e-8 of the dense solver's."""
    from sunode_torch.entry import build_kpp_single, build_lv_single
    from sunode_torch.ops import banded as bd

    grads = {}
    for dev in ("cpu", "cuda"):
        step, (y0s, p_subs) = build_lv_single(1, device=dev)
        grads[dev] = [g.cpu().numpy() for g in step(y0s[0], p_subs[0])]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-8)
    out = {}
    for ls in ("band", "dense"):
        _, grad_step, (y0, p, _) = build_kpp_single(64, ls, device="cuda")
        before = (bd.banded_factor.launches, bd.banded_solve.launches)
        out[ls] = [g.cpu().numpy() for g in grad_step(y0, p)]
        st = grad_step.solve.last_stats
        calls = tuple(st["forward"][k] + st["backward"][k]
                      for k in ("n_linear_factors", "n_linear_solves"))
        launched = (bd.banded_factor.launches - before[0], bd.banded_solve.launches - before[1])
        assert launched == (calls if ls == "band" else (0, 0))
    for a, b in zip(out["band"], out["dense"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-8)


def test_banded_wrappers_refuse(cuda):
    """A CUDA tensor goes to the kernel or raises: a type, shape or layout the
    kernel does not take is refused, never solved by the plain version."""
    from sunode_torch.ops import banded as bd

    ab, b = _banded_case(12, 1, 1, 8, torch.float64, cuda, 0)
    lu, piv, sing = bd.banded_factor(ab, 1, 1)
    before = (bd.banded_factor.launches, bd.banded_solve.launches)
    with pytest.raises(ValueError, match="float64 or float32"):
        bd.banded_factor(ab.half(), 1, 1)
    with pytest.raises(ValueError, match="l\\+u\\+1"):
        bd.banded_factor(ab, 2, 1)
    with pytest.raises(ValueError, match="^ab:"):
        bd.banded_factor(ab.transpose(1, 2).contiguous().transpose(1, 2), 1, 1)
    with pytest.raises(ValueError, match="^b:"):
        bd.banded_solve((lu, piv, sing), b.float(), 1, 1)
    with pytest.raises(ValueError, match="^piv:"):
        bd.banded_solve((lu, piv.long(), sing), b, 1, 1)
    with pytest.raises(ValueError, match="^lu:"):
        bd.banded_solve((lu, piv, sing), b, 2, 0)
    assert (bd.banded_factor.launches, bd.banded_solve.launches) == before


@pytest.mark.parametrize("case", ["kpp_band", "hub_sparse", "kpp_spgmr"])
def test_cuda_structured_forward_matches_cpu(cuda, case):
    """``build_kpp`` (band, spgmr) and ``build_hub`` (sparse with the BBD
    border) on 8 lanes at n = 32: the CPU's ys within 1e-8, and the banded
    launches equal to the Newton solver's lockstep factorizations and solves
    (one solve more a factorization with the border; none with spgmr)."""
    from sunode_torch.entry import build_hub, build_kpp
    from sunode_torch.ops import banded as bd

    make, solver = {"kpp_band": (build_kpp, "band"), "hub_sparse": (build_hub, "sparse"),
                       "kpp_spgmr": (build_kpp, "spgmr")}[case]
    forward, _, (y0, p, _) = make(32, 8, solver, device=cuda)
    before = (bd.banded_factor.launches, bd.banded_solve.launches)
    ys = forward(y0, p)
    st = forward.last_stats
    launched = (bd.banded_factor.launches - before[0], bd.banded_solve.launches - before[1])
    f, s = st["n_linear_factors"], st["n_linear_solves"]
    want = {"kpp_band": (f, s), "hub_sparse": (f, s + f), "kpp_spgmr": (0, 0)}[case]
    assert launched == want and (case == "kpp_spgmr" or f > 0)
    cpu_forward, _, _ = make(32, 8, solver, device="cpu")
    ref = cpu_forward(y0.cpu(), p.cpu())
    np.testing.assert_allclose(ys.cpu().numpy(), ref.numpy(), rtol=1e-8, atol=1e-12)


def test_cuda_band_gradient_matches_cpu(cuda):
    """The band adjoint's gradient (forward and backward through the banded
    kernels) on 4 lanes at n = 24 against the CPU's plain path (1e-8)."""
    from sunode_torch.entry import build_kpp
    from sunode_torch.ops import banded as bd

    _, grad_step, (y0, p, _) = build_kpp(24, 4, "band", device=cuda)
    before = bd.banded_factor.launches
    gy, gp = grad_step(y0, p)
    st = grad_step.solve.last_stats
    assert bd.banded_factor.launches - before == (st["forward"]["n_linear_factors"]
                                                  + st["backward"]["n_linear_factors"])
    _, cpu_grad, _ = build_kpp(24, 4, "band", device="cpu")
    hy, hp = cpu_grad(y0.cpu(), p.cpu())
    np.testing.assert_allclose(gy.cpu().numpy(), hy.numpy(), rtol=1e-8)
    np.testing.assert_allclose(gp.cpu().numpy(), hp.numpy(), rtol=1e-8)


def _spline_system(kind, real):
    from sunode_torch.entry import lv_spline_problem

    problem = lv_spline_problem()
    ds = getattr(cuda_codegen, f"{kind}_system")(problem, real)
    return PeceSystem(fz=_chip_smoke().lv_plain_fz(problem, kind), n=ds.n, nz=ds.nz, device=ds)


@pytest.mark.parametrize("real", ["double", "float"])
@pytest.mark.parametrize("kind", ["forward", "transition"])
def test_spline_history_builds_match_plain(cuda, kind, real):
    """The spline LV's emitted systems (the spline as C ternaries) build at
    both types and match their plain versions with C6's checks."""
    system = _spline_system(kind, real)
    args = _history_case(system, cuda, 6)
    if real == "float":
        _history_against_plain(system, _f32(args), tol=1e-5)
    else:
        _history_against_plain(system, args)


def test_cuda_lv_spline_gradient_matches_cpu(cuda):
    """``build_lv_spline`` on 4 lanes: one history launch an attempt (the
    spline's forward and transition builds), the CPU's gradients within
    1e-8."""
    from sunode_torch.entry import build_lv_spline

    step, (y0s, p_subs) = build_lv_spline(4, device=cuda)
    before = adams_history_attempt.launches
    gy, gp = step(y0s, p_subs)
    st = step.solve.last_stats
    assert adams_history_attempt.launches - before == (st["forward"]["n_attempts"]
                                                       + st["backward"]["n_attempts"])
    cpu, _ = build_lv_spline(4, device="cpu")
    hy, hp = cpu(y0s.cpu(), p_subs.cpu())
    np.testing.assert_allclose(gy.cpu().numpy(), hy.numpy(), rtol=1e-8)
    np.testing.assert_allclose(gp.cpu().numpy(), hp.numpy(), rtol=1e-8)


def _rows_case(cuda, R=200, B=40, seed=21):
    """One staged-adjoint attempt's inputs on SIR over ``R`` regions (3R
    lambda rows and two quadratures) cut in two row blocks on the card, the
    quadratures on the home block."""
    from sunode_torch.parallel.rows import RowLayout, scatter

    rng = np.random.default_rng(seed)
    KAB, n, m = 11, 3 * R, 2
    f64 = dict(dtype=torch.float64, device=cuda)
    T = lambda a: torch.as_tensor(a, **f64)  # noqa: E731
    L = RowLayout.contiguous((cuda, cuda), (n // 2, n - n // 2)).with_rows(m)
    DF = T(1e-2 * rng.standard_normal((KAB, n + m, B)) * (0.5 ** np.arange(KAB))[:, None, None])
    x = dict(
        p=torch.as_tensor(rng.integers(1, 9, B).astype(np.int32), device=cuda),
        pre=T(np.exp(rng.uniform(np.log(0.2), np.log(2.0), B))), h=T(10.0 ** rng.uniform(-3, 0, B)),
        z=T(0.1 * rng.standard_normal((n + m, B))), t=T(rng.uniform(0.0, 60.0, B)),
        params=T(np.array([0.4, 0.15, 0.05])[:, None] * (1 + 0.05 * rng.standard_normal((3, B)))),
        y=T(np.repeat([0.99, 0.01, 0.01], R)[:, None] * (1 + 0.05 * rng.uniform(size=(n, B)))),
        active=torch.as_tensor(rng.uniform(size=B) < 0.9, device=cuda),
        gsa=T(np.abs(_GAMMA_STAR)), DF=DF,
        atol=T(np.full(n + m, 1e-10)), rtol=T(np.full(n + m, 1e-8)),
        v=T(np.r_[np.full(n, 0.5 / n), np.full(m, 0.5 / m)]),
    )
    aj, qr = sir_problem(R).make_adjoint_rhs(), sir_problem(R).make_adjoint_quad_rhs()
    rhs_s, quad_s = staged_adjoint_fz(aj, qr)

    def fz(t, lam, par):
        return torch.cat([rhs_s(t, lam, par, x["y"]), quad_s(t, lam, par, x["y"])])

    return L, x, PeceSystem(fz=fz, n=n, nz=n + m), scatter


ROWS_CASES = {  # (R, B, dtype, f lane-major, a non-finite last row)
    "base": (200, 40, torch.float64, False, False),
    # nz not a multiple of a rank's rows, B not a multiple of 16
    "odd": (201, 37, torch.float64, True, True),
    "one_rank": (5, 24, torch.float64, False, True),
    "waves": (1000, 1024, torch.float64, True, False),  # 188 rows a rank, 3 waves a thread
    "float32": (200, 40, torch.float32, False, True),
}


@pytest.mark.parametrize("case", list(ROWS_CASES))
def test_partial_norm_entries_match_plain(cuda, case):
    """The state split's three entries against their plain versions on two
    row blocks of one card, the folded decision in both: one attempt's four
    rows' sweeps (the home block's f read in place, row-major or
    lane-major), the finish's rows and its lanes.  Each decides the sweep
    before on the plain stages' partials, and again on the kernel's own:
    y_next, the flags and the decided state bit for bit, each block's sums
    (its ranks in order) within 1e-12 of the plain ``torch.sum`` (1e-5 at
    float32); DF_upd, z_new and err0 bit for bit, ss3 within the bound; the
    lanes' err3, conv and niter bit for bit.  One launch each a block (the
    rows') or an attempt (the lanes')."""
    from sunode_torch.parallel.rows import RowBlocks, lane_sum

    R, B, dtype, lane_major, poison = ROWS_CASES[case]
    bound = 1e-12 if dtype == torch.float64 else 1e-5
    L, x, system, scatter = _rows_case(cuda, R=R, B=B)
    x = {k: v.to(dtype) if v.is_floating_point() else v for k, v in x.items()}
    kernels = adams_split.build_split_kernels(11, dtype)
    n, n_d = system.n, L.state_rows(system.n)
    lane = int(torch.nonzero(x["active"])[0])  # an active lane's last state row poisoned

    def fz(t, y, par):
        f = system.fz(t, y, par).to(dtype)
        if poison:
            f[n - 1, lane] = float("inf")
        return f.t().contiguous().t() if lane_major else f

    def same(a, b):
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())

    def close(a, b):  # the finite lanes within the bound, the rest alike
        ok = torch.isfinite(b)
        return torch.equal(torch.isfinite(a), ok) and _relerr(a[ok], b[ok]) <= bound

    blocks = {k: scatter(L, x[k]).blocks for k in ("DF", "z")}
    col = {k: [b[:, 0] for b in scatter(L, x[k][:, None]).blocks] for k in ("atol", "rtol", "v")}
    preds = [adams_split.split_predict(D, x["p"], x["pre"], x["h"], z, a, r, 8)
             for D, z, a, r in zip(blocks["DF"], blocks["z"], col["atol"], col["rtol"])]
    y = [pr.z_pred[:m] for pr, m in zip(preds, n_d)]
    state = adams_split.sweep_start(x["active"], dtype)
    before = dict(adams_split.adams_split_attempt_rows.launches)
    pending = own = None
    for k in range(FUNCTIONAL_MAXITER):
        f_all = fz(x["t"], RowBlocks(L, y).gather(), x["params"])
        f_b = scatter(L, f_all).blocks
        outs, states, mine = [], [], []
        for d, (yy, pr, m) in enumerate(zip(y, preds, n_d)):
            where = dict(rows=L.segments[0]) if d == 0 else {}
            f = f_all if d == 0 else f_b[d]
            got, st = kernels.sweep_rows(f, yy, pr, state, m, pending, decide=d == 0, **where)
            ref, st_p = adams_split.split_sweep_rows(f, yy, pr, state, m, pending, **where)
            assert same(got.y_next, ref.y_next)
            assert torch.equal(got.nonfinite.any(dim=0), ref.nonfinite[0])
            ss = adams_split.pending_sums(adams_split.Pending(k, (got.ss,), (got.nonfinite,),
                                                              1e-3, n), cuda)[0]
            assert close(ss, ref.ss[0])
            if d == 0:
                assert all(same(a, b) for a, b in zip(st, st_p))
                if own is not None:  # the kernel's own partials, decided by both
                    st_k = kernels.sweep_rows(f, yy, pr, state, m, own, **where)[1]
                    st_o = adams_split.split_sweep_rows(f, yy, pr, state, m, own, **where)[1]
                    assert all(same(a, b) for a, b in zip(st_k, st_o))
            else:
                assert st is None or pending is None
            outs.append(ref)
            states.append(st_p)
            mine.append(got)
        state = states[0]
        pending = adams_split.Pending(k, tuple(o.ss for o in outs),
                                      tuple(o.nonfinite for o in outs), 1e-3, n)
        own = adams_split.Pending(k, tuple(o.ss for o in mine),
                                  tuple(o.nonfinite for o in mine), 1e-3, n)
        y = [o.y_next for o in outs]
    f = scatter(L, fz(x["t"], RowBlocks(L, y).gather(), x["params"])).blocks
    fins = []
    for fb, pr, v in zip(f, preds, col["v"]):
        got = kernels.finish_rows(fb, pr, x["p"], x["h"], x["gsa"], v)
        ref = adams_split.split_finish_rows(fb, pr, x["p"], x["h"], x["gsa"], v, 8)
        for name in ("DF_upd", "z_new", "err0"):
            assert same(getattr(got, name), getattr(ref, name)), name
        assert close(got.ss3, ref.ss3)
        fins.append(ref)
    pred_ok = preds[0].pred_ok & preds[1].pred_ok
    ss3 = lane_sum([fi.ss3 for fi in fins], cuda)
    for pend in (pending, own):
        got = kernels.finish_lanes(ss3, pred_ok, state, 1e-3, pend)
        ref = adams_split.split_finish_lanes(ss3, pred_ok, state, 1e-3, pend)
        torch.cuda.synchronize()
        assert same(got[0], ref[0])
        assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    assert bool(state.bad[lane]) == poison
    launched = {k: v - before[k] for k, v in adams_split.adams_split_attempt_rows.launches.items()}
    assert launched == {"sweep_rows": 2 * FUNCTIONAL_MAXITER + FUNCTIONAL_MAXITER - 1,
                        "finish_rows": 2, "finish_lanes": 2}


def test_state_split_attempt_at_one_block_is_the_unsplit_attempt(cuda):
    """``adams_split_attempt_rows`` over one block on the card launches the
    rows' and the lanes' entries and gives the unsplit kernels' attempt bit
    for bit: the same rows summed in the same order, one root of the same
    sum; over two blocks within 1e-12."""
    from sunode_torch.parallel.rows import RowLayout

    L2, x, system, scatter = _rows_case(cuda, seed=22)
    args = (x["t"], x["h"], x["pre"], x["p"], x["active"])
    ref = adams_split_attempt(system, *args, x["DF"], x["z"], x["params"], x["atol"], x["rtol"],
                              x["gsa"], x["v"], 1e-3, FUNCTIONAL_MAXITER, 8)
    for L in (RowLayout.contiguous((cuda,), (system.n,)).with_rows(system.nz - system.n), L2):
        got = adams_split.adams_split_attempt_rows(
            system, *args, scatter(L, x["DF"]), scatter(L, x["z"]), x["params"],
            scatter(L, x["atol"][:, None]), scatter(L, x["rtol"][:, None]), x["gsa"],
            scatter(L, x["v"][:, None]), 1e-3, FUNCTIONAL_MAXITER, 8)
        torch.cuda.synchronize()
        one = len(L.devices) == 1
        for name in ("DF_resc", "DF_upd", "z_pred", "z_new", "err0"):
            a, b = getattr(got, name).gather(), getattr(ref, name)
            assert torch.equal(a, b) if one else _relerr(a, b) <= 1e-12, name
        assert torch.equal(got.err3, ref.err3) if one else _relerr(got.err3, ref.err3) <= 1e-12
        assert torch.equal(got.conv, ref.conv) and torch.equal(got.niter, ref.niter)


def test_cuda_state_split_sir_matches_unsplit(cuda):
    """``entry.build_sir_state_split`` ('hermite', R = 32, B = 8) on a 1 x 2
    mesh of the card against ``build_sir``'s unsplit step: within 1e-10 /
    1e-12 in every lane whose accepted forward and backward steps are the
    unsplit solve's, within 1e-8 in a lane whose steps parted on a norm's
    last bit (the two sum each lane's rows in other orders: chip_smoke.py's
    phase 17(b) rule); the rows' entries launched, no plain stage called."""
    from sunode_torch.entry import build_sir_state_split
    from sunode_torch.parallel.mesh import Mesh

    step, (y0s, p_subs) = build_sir(32, 8, "hermite", device="cuda")
    ys, gp = step(y0s, p_subs)
    ref = step.solve.last_stats
    steps = (ref["forward"]["n_steps"].clone(), ref["backward"]["n_backward_steps"].clone())
    mesh = Mesh(((cuda, cuda),), ("chains", "state"))
    split, (y0s2, p_subs2) = build_sir_state_split(32, 8, "hermite", mesh)
    assert torch.equal(y0s, y0s2) and torch.equal(p_subs, p_subs2)
    calls = adams_split.split_sweep_rows.calls
    before = adams_split.adams_split_attempt_rows.launches["finish_lanes"]
    ys2, gp2 = split(y0s2, p_subs2)
    torch.cuda.synchronize()
    assert adams_split.split_sweep_rows.calls == calls
    assert adams_split.adams_split_attempt_rows.launches["finish_lanes"] > before
    got = split.solve.last_stats
    same = ((got["forward"]["n_steps"] == steps[0])
            & (got["backward"]["n_backward_steps"] == steps[1])).cpu().numpy()
    for a, b in ((ys2, ys), (gp2, gp)):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        np.testing.assert_allclose(a[same], b[same], rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(a[~same], b[~same], rtol=1e-8, atol=1e-10)


def _pending_case(cuda, ranks, B, seed):
    """A state split's last sweep as the lanes' finish takes it: every
    block's ``ranks[d]`` partial sums of squares a lane (spanning the rate
    tests' thresholds, a few non-finite flags), the lanes' state (some
    converged, diverged or bad, some never swept) and err3's sums."""
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=cuda)
    n = 3000
    scale = 10.0 ** rng.uniform(-12, 0, B)  # each lane's dy_norm, across the thresholds
    ss = tuple(torch.as_tensor(10.0 ** rng.uniform(-6, 0, (r, B)) * scale * n / sum(ranks), **f64)
               for r in ranks)
    nf = tuple(torch.as_tensor(rng.uniform(size=(r, B)) < 0.002, device=cuda) for r in ranks)
    flags = [torch.as_tensor(rng.uniform(size=B) < q, device=cuda) for q in (0.1, 0.05, 0.05)]
    dy_old = 10.0 ** rng.uniform(-12, -2, B)
    dy_old[rng.uniform(size=B) < 0.1] = np.inf
    state = adams_split.SweepState(
        *flags, torch.as_tensor(dy_old, **f64),
        torch.as_tensor(rng.integers(0, 4, B), dtype=torch.int32, device=cuda))
    ss3 = torch.as_tensor(10.0 ** rng.uniform(-6, 2, (3, B)), **f64)
    ss3[1, 3] = float("nan")
    pred_ok = torch.as_tensor(rng.uniform(size=B) < 0.95, device=cuda)
    return adams_split.Pending(3, ss, nf, 1e-3, n), state, ss3, pred_ok


# (ranks of each block): the state split's home shape (2 blocks of the sweep's
# 16 ranks), 3 blocks of unequal ranks (one a single rank, as the plain stage's
# partials), and 16 blocks of 16, the most a lane takes
FINISH_LANES_RANKS = {2: (16, 16), 3: (16, 1, 7), 16: (16,) * 16}


@pytest.mark.parametrize("blocks", list(FINISH_LANES_RANKS))
def test_finish_lanes_matches_plain(cuda, blocks):
    """``split_finish_lanes``' kernel, a warp a lane, against its plain
    version on the same partials at 2, 3 and 16 blocks (32, 24 and 256
    partials a lane, past a warp's 32 in chunks of it), B = 301 (a last
    block of one lane): the decided sweep's err3 roots, conv and niter bit
    for bit (the plain version adds in the kernel's left-fold order, which
    the parent kernel's outputs matched bit for bit too); with the rate
    tests and with fixed sweeps, and without a sweep pending.  One launch a
    call; more blocks, or more ranks a block, than the kernel holds are
    refused."""
    kernels = adams_split.build_split_kernels(11)
    pending, state, ss3, pred_ok = _pending_case(cuda, FINISH_LANES_RANKS[blocks], 301, blocks)

    def same(a, b):
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())

    before = adams_split.adams_split_attempt_rows.launches["finish_lanes"]
    fixed = pending._replace(newton_tol=0.0)
    for pend, tol in ((pending, 1e-3), (fixed, 0.0), (None, 1e-3)):
        got = kernels.finish_lanes(ss3, pred_ok, state, tol, pend)
        ref = adams_split.split_finish_lanes(ss3, pred_ok, state, tol, pend)
        torch.cuda.synchronize()
        assert same(got[0], ref[0])
        assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    decided = adams_split.split_sweep_decide(
        3, *adams_split.pending_sums(pending, cuda), state, 1e-3, pending.n)
    for flag in ("conv", "div", "bad"):  # the decision sets each flag in some lane
        assert (getattr(decided, flag) & ~getattr(state, flag)).any(), flag
    assert adams_split.adams_split_attempt_rows.launches["finish_lanes"] == before + 3
    if blocks == 16:  # 17 blocks: refused by the wrapper; 16 x 17 ranks: by the launch
        with pytest.raises(ValueError):
            kernels.finish_lanes(ss3, pred_ok, state, 1e-3, pending._replace(
                ss=pending.ss + pending.ss[:1], nonfinite=pending.nonfinite[:1] * 17))
        more = tuple(torch.cat([s, s[:1]]) for s in pending.ss)
        more_nf = tuple(torch.cat([f, f[:1]]) for f in pending.nonfinite)
        with pytest.raises(ValueError):
            kernels.finish_lanes(ss3, pred_ok, state, 1e-3,
                                 pending._replace(ss=more, nonfinite=more_nf))


def _finish_case(cuda, nz, B, seed, kab=9):
    """The finish's inputs at ``nz`` rows and ``B`` lanes: the plain predict
    on a seeded history (orders 1..P_MAX, one lane outside the history), a
    final f with one lane's row not finite, the sweeps' state."""
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=cuda)
    T = lambda a: torch.as_tensor(a, **f64)  # noqa: E731
    P = kab - 3
    p = rng.integers(1, P + 1, B).astype(np.int32)
    if B > 1:
        p[B // 2] = kab - 1  # past KAB - 2, outside the history: poisoned
    DF = T(rng.standard_normal((kab, nz, B)) * (0.5 ** np.arange(kab))[:, None, None])
    p = torch.as_tensor(p, device=cuda)
    h = T(10.0 ** rng.uniform(-4, -1, B))
    pred = adams_split.split_predict(DF, p, T(np.exp(rng.uniform(-1.5, 0.7, B))), h,
                                     T(1.0 + rng.uniform(0.2, 1.0, (nz, B))),
                                     T(np.full(nz, 1e-8)), T(np.full(nz, 1e-7)), P)
    fz = pred.f_ex + T(1e-3 * rng.standard_normal((nz, B)))
    if B > 3:
        fz[nz - 1, 3] = float("inf")
    state = adams_split.SweepState(
        torch.as_tensor(rng.uniform(size=B) < 0.7, device=cuda),
        torch.as_tensor(rng.uniform(size=B) < 0.05, device=cuda),
        torch.as_tensor(rng.uniform(size=B) < 0.05, device=cuda),
        T(10.0 ** rng.uniform(-9, -3, B)),
        torch.as_tensor(rng.integers(1, 5, B), dtype=torch.int32, device=cuda))
    return (fz, pred, state, p, h, T(np.abs(_GAMMA_STAR)), T(rng.uniform(0.5, 1.5, nz) / nz),
            1e-3), P


def _finish_fold(fin_in, ref, P):
    """err3 with each lane's squares added in the finish kernel's order:
    row thread y of a chunk adds its rows 64 c + y + 8 j (y + j nz, at fewer
    than 8 rows) in row order from 0, the chunk its row threads in order
    from 0, the lane its chunks in order from 0."""
    fz, pred, _, p, h, gsa, v, _ = fin_in
    nz = fz.shape[0]
    rows = torch.stack([
        ref.err0,
        (gsa[torch.clamp(p - 1, min=0).long()] * h)[None] * adams_split._take_row(ref.DF_upd, p - 1),
        (gsa[torch.clamp(p + 1, max=P + 1).long()] * h)[None] * adams_split._take_row(ref.DF_upd,
                                                                                     p + 1),
    ])
    sq = (rows * pred.w_z[None]) ** 2 * v[None, :, None]
    T = adams_split.finish_geometry(nz, 1).row_threads
    total = torch.zeros_like(sq[:, 0])
    for c in range(-(-nz // 64)):
        chunk = torch.zeros_like(total)
        for y in range(T):
            s = torch.zeros_like(total)
            for r in range(64 * c + y, min(64 * (c + 1), nz), T):
                s = s + sq[:, r]
            chunk = chunk + s
        total = total + chunk
    return torch.sqrt(total)


@pytest.mark.parametrize("nz", [1, 2, 4, 63, 64, 65])
def test_split_finish_one_chunk_matches_plain(cuda, nz):
    """The finish where its rows fit one chunk (nz <= 64) takes its one-chunk
    form: the launcher's tile is ``finish_geometry``'s (the wrapper's
    mirror), no fill runs before the kernel, and at B = 1, 31 and 10,000
    DF_upd, z_new, err0 and conv are bit for bit the plain ``split_finish``'s
    (a lane outside the history poisoned, a non-finite f), err3 bit for bit
    the multi-chunk form's order of the same squares (the parent kernel's)
    and within 1e-12 of the plain sums.  At nz = 65 the multi-chunk form:
    its fill, the same checks."""
    kernels = adams_split.build_split_kernels(9)
    g = adams_split.finish_geometry(nz, 31)
    assert kernels.finish_geometry(nz) == (g.lanes, g.row_threads, g.chunks)
    for seed, B in enumerate((1, 31, 10_000)):
        fin_in, P = _finish_case(cuda, nz, B, seed)
        ref = adams_split.split_finish(*fin_in, P)
        got = kernels.finish(*fin_in)
        assert _chip_smoke().finish_fills(kernels, fin_in) == (1, 0 if g.one_chunk else 1)
        valid = fin_in[3] <= P + 1  # the kernel poisons the rest, as the fused one does
        # the plain error rows take DF_upd's rows by a masked sum, NaN (0 x inf)
        # where f is not finite: there the kernel's err3 is inf, taken as it is
        clean = valid & torch.isfinite(fin_in[0]).all(dim=0)
        fold = _finish_fold(fin_in, ref, P)
        for name in ("DF_upd", "z_new", "err0", "err3"):
            lanes = clean if name == "err3" else valid
            a, b = getattr(got, name)[..., lanes], getattr(ref, name)[..., lanes]
            assert torch.equal(a.isnan(), b.isnan()), name
            if name != "err3":
                assert torch.equal(a.nan_to_num(), b.nan_to_num()), name
            assert torch.isnan(getattr(got, name)[..., ~valid]).all(), name
        assert torch.equal(got.err3[:, clean].nan_to_num(), fold[:, clean].nan_to_num())
        assert torch.isinf(got.err3[:, valid & ~clean]).all()
        ok = torch.isfinite(ref.err3) & clean
        assert _relerr(got.err3[ok], ref.err3[ok]) <= 1e-12
        assert torch.equal(got.conv, ref.conv) and bool((~valid).any()) == (B > 1)
        assert bool((valid & ~clean).any()) == (B > 3)
