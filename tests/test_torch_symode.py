"""sunode_torch symbolic layer against the JAX package: lambdify, the
generated problem functions, and the CUDA emitter compiled as host C++."""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sympy as sy
import torch

from sunode_tpu.symode import SympyProblem as JaxSympyProblem
from sunode_tpu.symode.lambdify import lambdify_jax
from sunode_torch.adjoint import resolve_fz, staged_adjoint_fz, transition_fz
from sunode_torch.symode import SympyProblem, cuda_codegen
from sunode_torch.symode.lambdify import expit, lambdify_torch, logaddexp

RTOL = 1e-13  # same expressions, same CSE: only libm rounding differs
B = 64


def _lv(t, y, p):
    return {
        "hares": p.alpha * y.hares - p.beta * y.lynx * y.hares,
        "lynx": p.delta * y.hares * y.lynx - p.gamma * y.lynx,
    }


def _special(t, y, p):
    """expit, logaddexp, a guarded Piecewise, sqrt, exp and a power."""
    return {
        "a": expit(p.k * y.a) - logaddexp(y.a, p.c * y.b),
        "b": sy.Piecewise((sy.log(y.b), y.b > 1), (y.b - 1, True))
        + sy.sqrt(y.a) * sy.exp(-t) * p.c**2,
        "c": y.a * y.b**3 - p.k * y.c,
    }


SPECS = {
    "lv": dict(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()},
        rhs_sympy=_lv,
        derivative_params=[("alpha",), ("beta",)],
    ),
    "special": dict(
        params={"k": (), "c": ()},
        states={"a": (), "b": (), "c": ()},
        rhs_sympy=_special,
        derivative_params=[("k",), ("c",)],
    ),
}


def _inputs(problem, seed):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 3.0, B)
    # b straddles 1 so both Piecewise branches are taken
    y = rng.uniform(0.3, 2.0, (problem.n_states, B))
    p = rng.uniform(0.2, 1.5, (problem.n_all_params, B))
    return t, y, p


def _jax_batched(fn):
    # JAX problem functions take one lane; batch them with the lane axis last
    return jax.vmap(fn, in_axes=(0, 1, 1), out_axes=-1)


@pytest.fixture(scope="module", params=sorted(SPECS))
def problems(request):
    spec = SPECS[request.param]
    return request.param, JaxSympyProblem(**spec), SympyProblem(**spec)


def test_lambdify_torch_matches_lambdify_jax(problems):
    name, jp, tp = problems
    t, y, p = _inputs(tp, 0)
    exprs = np.concatenate(
        [np.asarray(tp._sym_dydt).reshape(-1), np.asarray(tp._sym_dydt_jac).reshape(-1)]
    )
    fj = lambdify_jax(["_t", "_y", "_p"], exprs, tp._varmap)
    ft = lambdify_torch(["_t", "_y", "_p"], exprs, tp._varmap)
    got = ft(torch.as_tensor(t), torch.as_tensor(y), torch.as_tensor(p)).numpy()
    want = np.asarray(_jax_batched(fj)(jnp.asarray(t), jnp.asarray(y), jnp.asarray(p)))
    assert got.shape == want.shape == (exprs.size, B)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-300)


def test_lambdify_torch_follows_dtype_and_constants():
    x = sy.Symbol("x", real=True)
    f = lambdify_torch(["_x"], np.array([sy.sqrt(2) * x, sy.exp(1), sy.Max(x, 1)]), {"x": "_x"})
    out32 = f(torch.tensor([0.5, 2.0], dtype=torch.float32))
    assert out32.dtype == torch.float32
    out = f(torch.tensor([0.5, 2.0], dtype=torch.float64))
    assert out.dtype == torch.float64
    np.testing.assert_allclose(
        out.numpy(), [[np.sqrt(2) * 0.5, np.sqrt(2) * 2.0], [np.e, np.e], [1.0, 2.0]],
        rtol=1e-15,
    )


@pytest.mark.parametrize("fn", ["make_rhs", "make_jac_dense", "make_dfdp"])
def test_problem_functions_match_jax(problems, fn):
    name, jp, tp = problems
    t, y, p = _inputs(tp, 1)
    got = getattr(tp, fn)()(torch.as_tensor(t), torch.as_tensor(y), torch.as_tensor(p))
    want = _jax_batched(getattr(jp, fn)())(jnp.asarray(t), jnp.asarray(y), jnp.asarray(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-300)


@pytest.mark.parametrize("fn", ["make_adjoint_jac_dense", "make_adjoint_rhs", "make_adjoint_quad_rhs"])
def test_adjoint_functions_match_jax(problems, fn):
    name, jp, tp = problems
    t, y, p = _inputs(tp, 2)
    lam = np.random.default_rng(5).standard_normal(y.shape)
    args = [np.asarray(a) for a in (t, y, lam, p)]
    got = getattr(tp, fn)()(*map(torch.as_tensor, args))
    want = jax.vmap(getattr(jp, fn)(), in_axes=(0, 1, 1, 1), out_axes=-1)(*map(jnp.asarray, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-14)


def _host_compile(system, tmp_path):
    """Compile the emitted header as host C++ and return a per-lane caller."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to compile the emitted source on the host")
    src = tmp_path / f"{system.name}.cpp"
    src.write_text(
        system.source
        + '\nextern "C" void call(double t, const double* y, const double* p, double* out)'
        " { pece_fz(t, y, p, out); }\n"
    )
    lib_path = tmp_path / f"{system.name}.so"
    subprocess.run(
        [cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-D__device__=",
         "-D__forceinline__=inline", "-o", str(lib_path), str(src)],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.call.argtypes = [ctypes.c_double, dp, dp, dp]
    lib.call.restype = None

    def run(t, z, p):
        out = np.empty((system.nz, z.shape[1]))
        for b in range(z.shape[1]):
            zb = np.ascontiguousarray(z[:, b])
            pb = np.ascontiguousarray(p[:, b])
            ob = np.empty(system.nz)
            lib.call(float(t[b]), zb.ctypes.data_as(dp), pb.ctypes.data_as(dp),
                     ob.ctypes.data_as(dp))
            out[:, b] = ob
        return out

    return run


@pytest.mark.parametrize("kind", ["forward", "transition", "resolve", "staged_adjoint"])
def test_cuda_emitter_host_compiled_matches_torch(problems, kind, tmp_path):
    name, _, tp = problems
    t, y, p = _inputs(tp, 3)
    n = tp.n_states
    if kind == "forward":
        system = cuda_codegen.forward_system(tp)
        z = y
        want = tp.make_rhs()(torch.as_tensor(t), torch.as_tensor(z), torch.as_tensor(p))
    elif kind in ("resolve", "staged_adjoint"):
        lam = np.random.default_rng(5).standard_normal((n, B))
        tau, pt = torch.as_tensor(-t), torch.as_tensor(p)
        aj, qr = tp.make_adjoint_rhs(), tp.make_adjoint_quad_rhs()
        if kind == "resolve":
            system = cuda_codegen.resolve_system(tp)
            z = np.concatenate([y, lam])
            rhs_c, quad_c = resolve_fz(tp.make_rhs(), aj, qr, n)
            zt = torch.as_tensor(z)
            want = torch.cat([rhs_c(tau, zt, pt), quad_c(tau, zt, pt)])
        else:
            # y(t) staged in the parameter rows after the problem's
            system = cuda_codegen.staged_adjoint_system(tp)
            z = lam
            rhs_s, quad_s = staged_adjoint_fz(aj, qr)
            args = (tau, torch.as_tensor(lam), pt, torch.as_tensor(y))
            want = torch.cat([rhs_s(*args), quad_s(*args)])
            p = np.concatenate([p, y])
            assert system.n_p == tp.n_all_params + n
        t = -t  # the emitted backward systems take tau
    else:
        system = cuda_codegen.transition_system(tp)
        rng = np.random.default_rng(4)
        z = np.concatenate([y, rng.standard_normal((n * n, B))])
        rhs_c, quad_c = transition_fz(
            tp.make_rhs(), tp.make_adjoint_jac_dense(), tp.make_dfdp(), n
        )
        tau, zt, pt = torch.as_tensor(-t), torch.as_tensor(z), torch.as_tensor(p)
        want = torch.cat([rhs_c(tau, zt, pt), quad_c(tau, zt, pt)])
        t = -t  # the emitted backward system takes tau
    assert (system.n, system.nz) == (z.shape[0], want.shape[0])
    got = _host_compile(system, tmp_path)(t, z, p)
    np.testing.assert_allclose(got, want.numpy(), rtol=RTOL, atol=1e-14)


def test_cuda_emitter_refuses_unprintable_functions():
    problem = SympyProblem(
        params={"k": ()},
        states={"a": ()},
        rhs_sympy=lambda t, y, p: {"a": sy.besselj(1, p.k * y.a)},
    )
    with pytest.raises(ValueError, match="no CUDA spelling"):
        cuda_codegen.forward_system(problem)
