"""sunode_torch's history attempt (rescale, PECE, difference update, error
rows) against the JAX reference's arithmetic, lane by lane.

The plain version is what every CPU solve runs; the CUDA kernel is held to
it on the card by tests/test_torch_cuda.py and chip_smoke.py.  Inputs are
seeded numpy draws at the main path's history depth (adams_max_order 6)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sunode_torch.ops.adams_batched as torch_adams_batched
from sunode_tpu.ops.adams import _GAMMA_STAR as JAX_GAMMA_STAR
from sunode_tpu.ops.adams_batched import adams_solve_batched as jax_solve
from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_torch.adjoint import transition_fz
from sunode_torch.entry import lv_problem
from sunode_torch.ops.adams import FUNCTIONAL_MAXITER
from sunode_torch.ops.adams_attempt import (
    _rescale_matrix,
    adams_history_attempt,
    adams_history_attempt_reference,
)
from sunode_torch.ops.adams_batched import adams_solve_batched
from sunode_torch.ops.bdf import BDFOptions
from sunode_torch.ops.pece_step import PeceSystem, _tables_header, adams_pece_attempt_reference
from test_torch_adams_batched import problems  # noqa: F401  (the shared fixture)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
B, P_MAX = 64, 6
KAB, K = P_MAX + 3, P_MAX + 1
RTOL = 1e-13  # the same operations in the same order: rounding of the sums only


def _system(kind):
    problem = lv_problem()
    rhs = problem.make_rhs()
    if kind == "forward":
        return PeceSystem(fz=rhs, n=2, nz=2)
    rhs_c, quad_c = transition_fz(
        rhs, problem.make_adjoint_jac_dense(), problem.make_dfdp(), 2
    )
    return PeceSystem(
        fz=lambda t, y, p: torch.cat([rhs_c(t, y, p), quad_c(t, y, p)]), n=6, nz=10
    )


def _case(system, seed):
    """Seeded inputs of one attempt: order 1..6 and step ratio log-uniform in
    [0.2, 2] per lane, the main path's error weights and |gamma*|."""
    rng = np.random.default_rng(seed)
    n, nz = system.n, system.nz
    DF = rng.standard_normal((KAB, nz, B)) * (0.5 ** np.arange(KAB))[:, None, None]
    params = np.array([1.0, 0.3, 1.0, 0.4])[:, None] * (1 + 0.1 * rng.standard_normal((4, B)))
    if nz == n:
        v_err = np.full(n, 1.0 / n)
    else:  # quadrature under error control, as in the transition solve
        v_err = np.concatenate([np.full(n, 0.5 / n), np.full(nz - n, 0.5 / (nz - n))])
    T = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    return dict(
        t_new=T(rng.uniform(0.0, 10.0, B)),
        h_use=T(10.0 ** rng.uniform(-4, -1, B)),
        pre_factor=T(np.exp(rng.uniform(np.log(0.2), np.log(2.0), B))),
        p=torch.as_tensor(rng.integers(1, P_MAX + 1, B), dtype=torch.int32),
        active=torch.as_tensor(rng.uniform(size=B) < 0.9),
        DF=T(DF),
        z_prev=T(1.0 + rng.uniform(0.2, 1.0, (nz, B))),
        params=T(params),
        atol_z=T(np.full(nz, 1e-8)),
        rtol_z=T(np.full(nz, 1e-7)),
        gamma_star_abs=T(np.abs(JAX_GAMMA_STAR)),
        v_err=T(v_err),
        newton_tol=3e-4,
        maxiter=FUNCTIONAL_MAXITER,
        P_MAX=P_MAX,
    )


# --- per-lane numpy transcriptions of sunode_tpu/ops/adams_batched.py --------
def _np_rescale(DF, p, factor):
    """``_rescale`` (:376-399) for one lane: DF (KAB, nz)."""

    def build(fac):
        rows = [[1.0] * K]
        for i in range(1, K):
            rows.append([rows[-1][j] * (i - 1 - fac * j) / i for j in range(K)])
        return [
            [rows[i][j] if (i <= p - 1 and j <= p - 1) else float(i == j) for j in range(K)]
            for i in range(K)
        ]

    R, U = build(factor), build(1.0)
    t1 = [sum(R[j][i] * DF[j] for j in range(K)) for i in range(K)]
    head = [sum(U[j][i] * t1[j] for j in range(K)) for i in range(K)]
    out = DF.copy()
    out[:K] = np.stack(head)
    return out


def _np_update(DF, p, d):
    """``_update`` (:989-1007) for one lane."""
    S = np.zeros((KAB + 1,) + DF.shape[1:])
    for i in range(KAB - 1, -1, -1):
        S[i] = S[i + 1] + DF[i]
    Sp, DFp = S[p], DF[min(max(p, 0), KAB - 1)]
    out = DF.copy()
    for i in range(KAB):
        if i <= p - 1:
            out[i] = S[i] - Sp + d
        elif i == p:
            out[i] = d
        elif i == p + 1:
            out[i] = d - DFp
    return out


def _np_err3(DF_upd, p, h, d, z_pred, atol, rtol, v_err):
    """The error-test rows and their weighted norms (:617-632) for one lane."""
    gsa = np.abs(JAX_GAMMA_STAR)
    rows = np.stack([
        gsa[p] * h * d,
        gsa[max(p - 1, 0)] * h * DF_upd[min(max(p - 1, 0), KAB - 1)],
        gsa[min(p + 1, P_MAX + 1)] * h * DF_upd[min(p + 1, KAB - 1)],
    ])
    w_z = 1.0 / (atol + rtol * np.abs(z_pred))
    return np.sqrt(np.sum((rows * w_z) ** 2 * v_err, axis=1))


@pytest.fixture(scope="module", params=["forward", "transition"])
def attempt(request):
    """(system, inputs, the plain history attempt, the plain PECE attempt
    on its rescaled history)."""
    system = _system(request.param)
    x = _case(system, seed=11 if request.param == "forward" else 12)
    out = adams_history_attempt_reference(system, **x)
    pece = adams_pece_attempt_reference(
        system.fz, x["t_new"], x["h_use"], x["p"], x["active"], out.DF_resc,
        x["z_prev"], x["params"], x["atol_z"], x["rtol_z"], x["newton_tol"],
        x["maxiter"], system.n,
    )
    return system, x, out, pece


def test_rescale_matches_jax_transcription(attempt):
    _, x, out, _ = attempt
    DF, p, fac = x["DF"].numpy(), x["p"].numpy(), x["pre_factor"].numpy()
    want = np.stack([_np_rescale(DF[:, :, b], int(p[b]), float(fac[b])) for b in range(B)], -1)
    np.testing.assert_allclose(out.DF_resc.numpy(), want, rtol=RTOL, atol=0)


def test_pece_part_is_the_plain_pece_attempt(attempt):
    """Bit for bit: the plain PECE attempt on the same rescaled history."""
    _, _, out, ref = attempt
    for got, want in [(out.z_pred, ref.z_pred), (out.z_new, ref.z_new),
                      (out.err0, ref.err), (out.conv, ref.conv), (out.niter, ref.niter)]:
        assert torch.equal(got, want)
    # the main-path corrector really iterates and tests per lane
    assert 0 < int(out.conv.sum()) and int(out.niter.max()) > 1


def test_update_and_error_rows_match_jax_transcription(attempt):
    _, x, out, ref = attempt
    DF_resc, d = out.DF_resc.numpy(), ref.d_fz.numpy()
    p, h = x["p"].numpy(), x["h_use"].numpy()
    upd = np.stack([_np_update(DF_resc[:, :, b], int(p[b]), d[:, b]) for b in range(B)], -1)
    np.testing.assert_allclose(out.DF_upd.numpy(), upd, rtol=RTOL, atol=0)
    err3 = np.stack([
        _np_err3(upd[:, :, b], int(p[b]), h[b], d[:, b], out.z_pred.numpy()[:, b],
                 x["atol_z"].numpy(), x["rtol_z"].numpy(), x["v_err"].numpy())
        for b in range(B)
    ], -1)
    np.testing.assert_allclose(out.err3.numpy(), err3, rtol=RTOL, atol=0)


def test_wrapper_takes_plain_path_on_cpu(attempt):
    system, x, out, _ = attempt
    before = adams_history_attempt.launches
    got = adams_history_attempt(system, **x)
    assert adams_history_attempt.launches == before == 0
    for a, b in zip(got, out):
        assert torch.equal(a, b)


def test_whole_solve_goes_through_the_wrapper_and_matches_jax(problems, monkeypatch):  # noqa: F811
    """adams_solve_batched on the CPU, every attempt through
    adams_history_attempt, against the JAX solve at adams_max_order 6."""
    jp, tp = problems
    g = np.load(os.path.join(GOLDEN, "lv_forward.npz"))
    y0s, ps, tvals = g["y0s"][:8], g["ps"][:8], g["tvals"]
    kw = dict(rtol=1e-8, atol=1e-8, adams_max_order=P_MAX)
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[-1])
        return adams_history_attempt(*args, **kwargs)

    monkeypatch.setattr(torch_adams_batched, "adams_history_attempt", spy)
    tres = adams_solve_batched(
        tp.make_rhs(), 0.0, torch.as_tensor(y0s), torch.as_tensor(ps),
        torch.as_tensor(tvals), BDFOptions(**kw),
    )
    jres = jax.jit(
        lambda y, p: jax_solve(jp.make_rhs(), 0.0, y, p, jnp.asarray(tvals), JaxOptions(**kw))
    )(jnp.asarray(y0s), jnp.asarray(ps))
    assert len(calls) == tres.stats["n_attempts"] == int(jres.stats["n_attempts"])
    assert set(calls) == {P_MAX}
    assert (tres.status == 0).all()
    np.testing.assert_array_equal(tres.stats["n_steps"].numpy(), np.asarray(jres.stats["n_steps"]))
    np.testing.assert_allclose(tres.ys.numpy(), np.asarray(jres.ys), rtol=1e-8)


@pytest.mark.parametrize("kab", [9, 11])
def test_emitted_u_table_is_the_plain_rescale_u(kab):
    """The kernel's constant U = R(1) (the generated tables header's
    PECE_U) is the plain rescale's U, bit for bit, signed zeros included."""
    line = next(ln for ln in _tables_header().splitlines() if "PECE_U[" in ln)
    n = int(re.search(r"PECE_U\[(\d+)\]", line).group(1))
    body = line.split("=", 1)[1]
    emitted = np.array([float(v) for v in re.findall(r"-?[0-9.e+-]+", body)]).reshape(n, n)
    k = kab - 2
    U = _rescale_matrix(torch.ones(1, dtype=torch.float64), torch.tensor([k]), k)[..., 0]
    assert np.array_equal(emitted[:k, :k].view(np.int64), U.numpy().view(np.int64))
