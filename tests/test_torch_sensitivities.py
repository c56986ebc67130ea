"""Forward sensitivities in sunode_torch against the JAX package: staggered
on both batched cores, simultaneous on the Adams core, the new symbolic
factories and the two new emitted systems' plain attempts.

Both packages run the same float64 inputs from numpy (Lotka-Volterra,
``tests/golden/lv_sens.npz``'s chains; SIR over 4 regions as a
``TorchProblem``).  As in the existing parity tests, torch's and XLA's
``pow`` differ in the last ulp (ROADMAP C1), so only ``final_step_size``
among the step statistics may differ; ys and sensitivities agree within
1e-9 relative (floored at 1e-12 absolute, the sensitivities start at 0).
The staggered Adams attempt joins its two blocks' error norms as
``sqrt(a^2 + b^2)``, a few ulps from the reference's one sum: no step
statistic changed for that on these inputs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sympy as sy
import torch

from sunode_tpu.ops.adams_batched import adams_solve_batched as jax_adams
from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_tpu.ops.bdf_batched import bdf_solve_batched as jax_bdf
from sunode_tpu.problem import JaxProblem
from sunode_tpu.symode import SympyProblem as JaxSympyProblem
from sunode_torch import TorchProblem
from sunode_torch.entry import LV_SENS_MODES, _lv, build_lv_sens, lv_problem, lv_sens_inputs
from sunode_torch.ops import adams_attempt, adams_batched, adams_split
from sunode_torch.ops.adams import _GAMMA, _GAMMA_STAR, FUNCTIONAL_MAXITER
from sunode_torch.ops.adams_attempt import adams_history_attempt_reference
from sunode_torch.ops.bdf import BDFOptions, newton_tol_for
from sunode_torch.ops.pece_step import PeceSystem
from sunode_torch.symode import cuda_codegen

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
B = 8
# step statistics that may differ by the ulp of pow (ROADMAP C1)
C1_STATS = ("final_step_size",)
IGNORED = ("final_state", "error_time", "error_step_size")  # NaN on success


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: torch is faster on one CPU thread; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_lv():
    return JaxSympyProblem(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()},
        rhs_sympy=_lv,
        derivative_params=[("alpha",), ("beta",)],
    )


def _rel(got, ref, floor=1e-12):
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), floor)))


def _stats_equal(got, ref, relaxed=C1_STATS):
    """Every statistic of the reference's is in ``got``, and equal but the
    ``relaxed`` ones and the NaN fields."""
    missing = sorted(set(ref) - set(IGNORED) - set(got))
    assert not missing, f"statistics missing from the port's result: {missing}"
    for key, want in ref.items():
        if key in IGNORED or key in relaxed:
            continue
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want), err_msg=key)


def _lv_case():
    y0s, ps, tvals = lv_sens_inputs(B)
    return y0s, ps, tvals[::4]  # 6 observation times over the whole horizon


# ---- the factories -------------------------------------------------------------
def test_sensitivity_rhs_explicit_matches_jax(jax_lv):
    """``make_sensitivity_rhs_explicit`` (every entry one generated
    expression) against the JAX package's, lane by lane, and against the
    composed ``make_sensitivity_rhs``; 1e-13."""
    rng = np.random.default_rng(0)
    t, y = rng.uniform(0, 10, 5), rng.uniform(0.5, 12, (2, 5))
    S, p = rng.standard_normal((2, 2, 5)), rng.uniform(0.2, 1.2, (4, 5))
    T = torch.as_tensor
    got = lv_problem().make_sensitivity_rhs_explicit()(T(t), T(y), T(S), T(p)).numpy()
    fn = jax_lv.make_sensitivity_rhs_explicit()
    want = np.stack([np.asarray(fn(t[b], y[:, b], S[:, :, b], p[:, b])) for b in range(5)], -1)
    composed = lv_problem().make_sensitivity_rhs()(T(t), T(y), T(S), T(p)).numpy()
    assert got.shape == (2, 2, 5)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(got, composed, rtol=1e-13, atol=1e-13)


def _roots(t, y, p):
    return [y.hares - 9.0, y.lynx * p.delta - p.gamma * t]


def test_symbolic_roots_and_root_fn_match_jax(jax_lv):
    """``symbolic_roots`` gives the reference's expressions, and
    ``make_root_fn`` (SympyProblem, lowered from sympy; a ``TorchProblem``
    through the base class's record view) evaluates as the JAX package's on
    batched inputs; 1e-13."""
    tp = lv_problem()
    assert [sy.simplify(a - b) for a, b in zip(tp.symbolic_roots(_roots),
                                               jax_lv.symbolic_roots(_roots))] == [0, 0]
    rng = np.random.default_rng(1)
    t, y, p = rng.uniform(0, 10, 6), rng.uniform(0.5, 12, (2, 6)), rng.uniform(0.2, 1.2, (4, 6))
    T = torch.as_tensor
    jfn = jax_lv.make_root_fn(_roots)
    want = np.stack([np.asarray(jfn(t[b], y[:, b], p[:, b])) for b in range(6)], -1)
    got = tp.make_root_fn(_roots)(T(t), T(y), T(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)

    spec = dict(params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
                states={"hares": (), "lynx": ()}, derivative_params=[("alpha",), ("beta",)])
    jp = JaxProblem(rhs=_lv, **spec)
    torch_p = TorchProblem(rhs=_lv, **spec)
    jfn = jp.make_root_fn(_roots)
    want = np.stack([np.asarray(jfn(t[b], y[:, b], p[:, b])) for b in range(6)], -1)
    got = torch_p.make_root_fn(_roots)(T(t), T(y), T(p)).numpy()
    assert got.shape == (2, 6)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("kind", ["sensitivity", "staged_sensitivity"])
def test_emitted_sensitivity_rows_match_the_plain_right_hand_side(kind):
    """The expressions each new emitted system prints, in its row layout
    (``[y | vec S]`` and ``vec S`` with y in the parameter rows after the
    problem's), evaluated with sympy's numpy printer, against the plain
    right-hand side the CPU path runs; 1e-13."""
    problem = lv_problem()
    system = getattr(cuda_codegen, f"{kind}_system")(problem)
    n, k, n_p = 2, 2, 4
    rng = np.random.default_rng(2)
    t = rng.uniform(0, 10, 7)
    y, S = rng.uniform(0.5, 12, (n, 7)), rng.standard_normal((k, n, 7))
    p = rng.uniform(0.2, 1.2, (n_p, 7))
    syms = [problem.sym_time, *problem._sym_statevec, *problem.sym_sens.reshape(-1),
            *problem._sym_paramvec]
    rows = cuda_codegen._sensitivity_rows(problem)
    if kind == "sensitivity":
        rows = list(problem.sym_rhs) + rows
        assert (system.n, system.nz, system.n_p) == (n + k * n, n + k * n, n_p)
    else:
        assert (system.n, system.nz, system.n_p) == (k * n, k * n, n_p + n)
    got = np.stack([np.broadcast_to(np.asarray(f(t, *y, *S.reshape(k * n, 7), *p), float), (7,))
                    for f in (sy.lambdify(syms, r, "numpy") for r in rows)])
    T = torch.as_tensor
    fS = problem.make_sensitivity_rhs()(T(t), T(y), T(S), T(p)).reshape(k * n, 7).numpy()
    want = np.concatenate([problem.make_rhs()(T(t), T(y), T(p)).numpy(), fS]) \
        if kind == "sensitivity" else fS
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    # the emitted source reads y from the parameter rows after the problem's
    assert ("p[4]" in system.source) == (kind == "staged_sensitivity")


# ---- one sensitivity block: the plain attempt against the reference's corrector
def _reference_sens_corrector(sens_rhs_b, t_new, y_new, S_pred, fS_ex, c_A, wS, params, gate,
                              newton_tol):
    """``sunode_tpu/ops/adams_batched.py``'s staggered sensitivity corrector
    (the ``sbody`` loop and the final evaluation, :525-586), transcribed in
    jnp: ``(FS_fin, s_conv, s_div, s_bad, nfs)``."""
    it_s, S_it, old = 0, S_pred, jnp.full(gate.shape, jnp.inf)
    s_conv, s_div, s_bad = ~gate, jnp.zeros_like(gate), jnp.zeros_like(gate)
    nfs = jnp.zeros(gate.shape, jnp.int32)
    for it_s in range(FUNCTIONAL_MAXITER):
        FS = sens_rhs_b(t_new, y_new, S_it, params)
        bad_f = ~jnp.all(jnp.isfinite(FS), axis=(0, 1))
        S_next = S_pred + c_A[None, None, :] * (FS - fS_ex)
        norm = jnp.sqrt(jnp.mean(((S_next - S_it) * wS) ** 2, axis=(0, 1)))
        rate = norm / old
        live = ~(s_conv | s_div | s_bad)
        S_it = jnp.where(live[None, None, :], S_next, S_it)
        conv_new = ((norm == 0.0) | ((it_s > 0) & (rate < 1.0)
                                     & (rate / (1 - rate) * norm < newton_tol))
                    | (norm < 0.1 * newton_tol))
        div_new = (it_s > 0) & (rate >= 2.0)
        s_bad = s_bad | (live & bad_f)
        s_conv = s_conv | (live & conv_new & ~s_bad)
        s_div = s_div | (live & div_new & ~conv_new)
        nfs = nfs + live.astype(jnp.int32)
        old = jnp.where(live, norm, old)
    return sens_rhs_b(t_new, y_new, S_it, params), s_conv, s_div, s_bad, nfs


def _sir(roll):
    def rhs(t, y, p):
        i_eff = y.I + p.mix * (roll(y.I, 1) + roll(y.I, -1))
        inf = p.beta * y.S * i_eff
        rec = p.gamma * y.I
        return {"S": -inf, "I": inf - rec, "R": rec}

    return rhs


SIR_SPEC = dict(params={"beta": (), "gamma": (), "mix": ()},
                states={"S": (4,), "I": (4,), "R": (4,)},
                derivative_params=[("beta",), ("gamma",)])


def _sens_block_case(model):
    """The S block of one staggered attempt: (torch sens rhs, JAX sens rhs,
    n, n_p, y levels, params levels)."""
    if model == "lv":
        jp = JaxSympyProblem(params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
                             states={"hares": (), "lynx": ()}, rhs_sympy=_lv,
                             derivative_params=[("alpha",), ("beta",)])
        return (lv_problem().make_sensitivity_rhs(), jp.make_sensitivity_rhs(), 2,
                np.array([10.0, 2.0]), np.array([1.0, 0.3, 1.0, 0.4]))
    tp = TorchProblem(rhs=_sir(lambda x, k: torch.roll(x, k, 0)), **SIR_SPEC)
    jp = JaxProblem(rhs=_sir(jnp.roll), **SIR_SPEC)
    return (tp.make_sensitivity_rhs(), jp.make_sensitivity_rhs(), 12,
            np.repeat([0.99, 0.01, 0.01], 4), np.array([0.4, 0.15, 0.05]))


@pytest.mark.parametrize("model, route", [("lv", "history"), ("sir", "split")])
def test_sensitivity_block_attempt_matches_the_reference_corrector(model, route):
    """One staggered S-block attempt as the Adams core makes it (``vec S``
    rows, y_new staged after the problem's parameter rows, the gated lanes
    active), through the history attempt's plain version (LV, the form the
    kernel replaces) or the split attempt's plain stages composed (SIR over
    4 regions, a ``TorchProblem``: the route of its S block on the card),
    against the reference's corrector transcribed in jnp on the same
    predictor: converged flags and sweeps in every gated lane, the new
    sensitivities within 1e-13; the split route also bit for bit the history
    route."""
    sens_t, sens_j, n, y_lvl, p_lvl = _sens_block_case(model)
    k, Bc, P_MAX = 2, 64, 6
    nS, n_p = k * n, p_lvl.shape[0]
    rng = np.random.default_rng(3)
    KAB = P_MAX + 3
    DF = 0.1 * rng.standard_normal((KAB, nS, Bc)) * (0.5 ** np.arange(KAB))[:, None, None]
    y_new = y_lvl[:, None] * (1 + 0.05 * rng.uniform(size=(n, Bc)))
    params = p_lvl[:, None] * (1 + 0.05 * rng.standard_normal((n_p, Bc)))
    T = torch.as_tensor
    args = (T(rng.uniform(0, 10, Bc)), T(10.0 ** rng.uniform(-4, -1, Bc)),
            T(np.exp(rng.uniform(np.log(0.2), np.log(2.0), Bc))),
            T(rng.integers(1, P_MAX + 1, Bc).astype(np.int32)), T(rng.uniform(size=Bc) < 0.8),
            T(DF), T(rng.standard_normal((nS, Bc))), T(np.concatenate([params, y_new])),
            torch.full((nS,), 1e-9, dtype=torch.float64),
            torch.full((nS,), 1e-9, dtype=torch.float64),
            T(np.abs(_GAMMA_STAR)), torch.full((nS,), 1.0 / (n * 3), dtype=torch.float64))
    tol = newton_tol_for(BDFOptions(rtol=1e-9), 1e-9, torch.float64)

    def fz_S(t, S, par):  # as adams_solve_batched stages it
        return sens_t(t, par[n_p:], S.reshape(k, n, -1), par[:n_p]).reshape(nS, -1)

    system = PeceSystem(fz=fz_S, n=nS, nz=nS)
    got = adams_history_attempt_reference(system, *args, tol, FUNCTIONAL_MAXITER, P_MAX)
    if route == "split":
        split = adams_split.adams_split_attempt_reference(system, *args, tol, FUNCTIONAL_MAXITER,
                                                          P_MAX)
        for name in got._fields:
            assert torch.equal(getattr(split, name).nan_to_num(), getattr(got, name).nan_to_num())
    # the reference's corrector from the same predictor and extrapolation
    p = args[3].long()
    mask = (torch.arange(P_MAX + 1)[:, None] <= p[None, :] - 1).double()
    f_ex = (mask[:, None, :] * got.DF_resc[: P_MAX + 1]).cumsum(0)[-1].numpy()  # in row order
    c_A = (args[1] * torch.as_tensor(_GAMMA)[p - 1]).numpy()
    wS = 1.0 / (1e-9 + 1e-9 * np.abs(got.z_pred.numpy()))
    gate = args[4].numpy()
    sens_b = jax.vmap(sens_j, in_axes=(0, 1, 2, 1), out_axes=2)
    FS, s_conv, s_div, s_bad, nfs = _reference_sens_corrector(
        sens_b, jnp.asarray(args[0].numpy()), jnp.asarray(y_new),
        jnp.asarray(got.z_pred.numpy().reshape(k, n, Bc)), jnp.asarray(f_ex.reshape(k, n, Bc)),
        jnp.asarray(c_A), jnp.asarray(wS.reshape(k, n, Bc)), jnp.asarray(params),
        jnp.asarray(gate), tol,
    )
    conv_ref = np.asarray(s_conv & ~s_bad & ~s_div)
    assert gate.any() and (~gate).any() and conv_ref[gate].any()
    np.testing.assert_array_equal(got.conv.numpy()[gate], conv_ref[gate])
    np.testing.assert_array_equal(got.niter.numpy()[gate], np.asarray(nfs)[gate])
    z_ref = got.z_pred.numpy() + c_A[None, :] * (np.asarray(FS).reshape(nS, Bc) - f_ex)
    np.testing.assert_allclose(got.z_new.numpy()[:, gate], z_ref[:, gate], rtol=1e-13, atol=1e-13)


# ---- whole solves -----------------------------------------------------------------
@pytest.mark.parametrize("method", ["BDF", "ADAMS"])
def test_staggered_matches_jax(jax_lv, method):
    """Staggered sensitivities through ``build_lv_sens`` on 8 of
    ``lv_sens.npz``'s chains against the JAX package's batched core with the
    same options: ys and sensitivities within 1e-9, statuses and every step
    statistic equal (``n_sens_rhs_evals`` too) but ``final_step_size``."""
    y0s, ps, tvals = _lv_case()
    solve, _ = build_lv_sens(B, method, "staggered", device="cpu")
    T = torch.as_tensor
    res = solve(T(y0s), T(ps), T(tvals))
    opts = JaxOptions(**solve.options._asdict())
    S0 = jnp.zeros((B, 2, 2))
    rhs, sens_rhs = jax_lv.make_rhs(), jax_lv.make_sensitivity_rhs()
    if method == "BDF":
        jac = jax_lv.make_jac_dense()
        run = lambda y, p: jax_bdf(rhs, jac, 0.0, y, p, jnp.asarray(tvals), opts,  # noqa: E731
                                   sens_rhs=sens_rhs, S0=S0)
    else:
        run = lambda y, p: jax_adams(rhs, 0.0, y, p, jnp.asarray(tvals), opts,  # noqa: E731
                                     sens_rhs=sens_rhs, sens0=S0)
    ref = jax.jit(run)(jnp.asarray(y0s), jnp.asarray(ps))
    assert (res.status == 0).all() and (np.asarray(ref.status) == 0).all()
    assert _rel(res.ys.numpy(), np.asarray(ref.ys)) <= 1e-9
    assert _rel(res.sens.numpy(), np.asarray(ref.sens)) <= 1e-9
    _stats_equal(res.stats, ref.stats)
    assert (res.stats["n_sens_rhs_evals"] > 0).all()


def test_simultaneous_matches_bench_rhs_aug(jax_lv):
    """Simultaneous sensitivities on the Adams core (the augmented state
    ``[y | vec S]``) against ``bench.py``'s ``lv_sens`` solve: the JAX
    package's ``adams_solve_batched`` on its ``rhs_aug`` at rtol 1e-8 and
    ``adams_max_order=6``; within 1e-9, step statistics equal but
    ``final_step_size``."""
    y0s, ps, tvals = _lv_case()
    solve, _ = build_lv_sens(B, "ADAMS", "simultaneous", device="cpu")
    T = torch.as_tensor
    res = solve(T(y0s), T(ps), T(tvals))
    rhs, sens_rhs = jax_lv.make_rhs(), jax_lv.make_sensitivity_rhs()

    def rhs_aug(t, z, p):  # bench.py:397-400
        S = z[2:].reshape(2, 2)
        return jnp.concatenate([rhs(t, z[:2], p), sens_rhs(t, z[:2], S, p).reshape(-1)])

    opts = JaxOptions(rtol=1e-8, atol=1e-8, adams_max_order=6)
    z0 = np.concatenate([y0s, np.zeros((B, 4))], axis=1)
    ref = jax.jit(lambda y, p: jax_adams(rhs_aug, 0.0, y, p, jnp.asarray(tvals), opts))(
        jnp.asarray(z0), jnp.asarray(ps))
    zs = np.asarray(ref.ys)
    assert _rel(res.ys.numpy(), zs[:, :, :2]) <= 1e-9
    assert _rel(res.sens.numpy(), zs[:, :, 2:].reshape(B, -1, 2, 2)) <= 1e-9
    _stats_equal(res.stats, ref.stats)


@pytest.mark.parametrize("method, mode", LV_SENS_MODES, ids=["-".join(m) for m in LV_SENS_MODES])
def test_lv_sens_golden_in_every_mode(method, mode):
    """``tests/golden/lv_sens.npz``'s gate (``tests/test_golden.py``: ys rtol
    1e-6 / atol 1e-8, sensitivities rtol 2e-4 / atol 5e-4; ys rtol 5e-6 at
    the simultaneous mode's rtol 1e-8, as ``bench.py`` gates it) through
    ``build_lv_sens`` on its 16 lanes, which are its lanes 0-15 at any width."""
    g = np.load(os.path.join(GOLDEN, "lv_sens.npz"))
    solve, (y0s, ps, tvals) = build_lv_sens(16, method, mode, device="cpu")
    np.testing.assert_array_equal(y0s.numpy(), g["y0s"])
    np.testing.assert_array_equal(ps.numpy(), g["ps"])
    res = solve(y0s, ps, tvals)
    assert (res.status == 0).all()
    np.testing.assert_allclose(res.ys.numpy(), g["ys"],
                               rtol=5e-6 if mode == "simultaneous" else 1e-6, atol=1e-8)
    np.testing.assert_allclose(res.sens.numpy(), g["sens"], rtol=2e-4, atol=5e-4)


def test_torch_problem_staggered_adams_matches_jax():
    """SIR over 4 regions written in torch (a ``TorchProblem``, whose S
    block takes the split kernels on the card) and in jnp (``JaxProblem``):
    staggered Adams sensitivities to (beta, gamma) on 2 lanes, 6
    observation times, rtol 1e-8 / atol 1e-10; within 1e-9, step statistics
    equal but ``final_step_size``."""
    tp = TorchProblem(rhs=_sir(lambda x, k: torch.roll(x, k, 0)), **SIR_SPEC)
    jp = JaxProblem(rhs=_sir(jnp.roll), **SIR_SPEC)
    rng = np.random.default_rng(4)
    y0s = np.concatenate([0.99 + 0.005 * rng.standard_normal((2, 4)),
                          0.01 * (1 + 0.1 * np.abs(rng.standard_normal((2, 4)))),
                          np.zeros((2, 4))], 1)
    ps = np.array([0.4, 0.15, 0.05]) * (1 + 0.05 * rng.standard_normal((2, 3)))
    tvals = np.linspace(5.0, 30.0, 6)
    o = dict(rtol=1e-8, atol=1e-10, sens_staggered=True)
    T = torch.as_tensor
    res = adams_batched.adams_solve_batched(
        tp.make_rhs(), 0.0, T(y0s), T(ps), T(tvals), BDFOptions(**o), batched_fns=True,
        sens_rhs=tp.make_sensitivity_rhs(), sens0=torch.zeros((2, 2, 12), dtype=torch.float64),
    )
    ref = jax.jit(lambda y, p: jax_adams(jp.make_rhs(), 0.0, y, p, jnp.asarray(tvals),
                                         JaxOptions(**o), sens_rhs=jp.make_sensitivity_rhs(),
                                         sens0=jnp.zeros((2, 2, 12))))(
        jnp.asarray(y0s), jnp.asarray(ps))
    assert (res.status == 0).all()
    assert _rel(res.ys.numpy(), np.asarray(ref.ys)) <= 1e-9
    assert _rel(res.sens.numpy(), np.asarray(ref.sens)) <= 1e-9
    _stats_equal(res.stats, ref.stats)


# ---- no fallback on the card ------------------------------------------------------
def test_cuda_sensitivities_never_fall_back(monkeypatch):
    """With the attempt's device check made to answer "on the card", a
    staggered Adams solve never runs a plain attempt: without the
    sensitivity block's emitted system it raises before the first attempt,
    with both systems a failing build raises, and a problem with neither
    goes to the split kernels, whose failing build raises too."""
    monkeypatch.setattr(adams_attempt, "on_card", lambda x: True)
    fail = lambda *a, **k: pytest.fail("a plain attempt ran on the card")  # noqa: E731
    monkeypatch.setattr(adams_attempt, "adams_history_attempt_reference", fail)
    monkeypatch.setattr(adams_split, "adams_split_attempt_reference", fail)

    def no_nvcc(*a, **k):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(adams_attempt, "build_attempt_kernel", no_nvcc)
    monkeypatch.setattr(adams_split, "build_split_kernels", no_nvcc)
    problem = lv_problem()
    y0s, ps, tvals = (torch.as_tensor(a) for a in _lv_case())
    kw = dict(sens_rhs=problem.make_sensitivity_rhs(),
              sens0=torch.zeros((B, 2, 2), dtype=torch.float64), batched_fns=True)
    opts = BDFOptions(rtol=1e-9, atol=1e-9, adams_max_order=6)
    forward = cuda_codegen.forward_system(problem)
    with pytest.raises(ValueError, match="both need an emitted system"):
        adams_batched.adams_solve_batched(problem.make_rhs(), 0.0, y0s, ps, tvals, opts,
                                          device_system=forward, **kw)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        adams_batched.adams_solve_batched(
            problem.make_rhs(), 0.0, y0s, ps, tvals, opts, device_system=forward,
            sens_device_system=cuda_codegen.staged_sensitivity_system(problem), **kw)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        adams_batched.adams_solve_batched(problem.make_rhs(), 0.0, y0s, ps, tvals, opts, **kw)
