"""float32 end to end in sunode_torch: the port's counterparts of
``tests/test_f32_mode.py`` (:49, :60, :68, :125, :137 on both cores and the
five adjoint modes of :194).

Every output and gradient of a float32 call is float32.  Each case is held
against the JAX package's float32 run of the same call within 1e-3 relative
(measured: at most 3e-5; the two packages round the same float32 arithmetic
in another order, and at float32 an ulp is 6e-8), and against the port's
own float64 run within ``test_f32_mode.py``'s 5e-2 (float32's accuracy class
at these tolerances).  The JAX references are compile-bound (~7 s a solve
here), so they run once a module, each group in one compile: the five
adjoint modes' gradients in one (``jax_grads``, 37 s against 47 s in five),
the forward and the two extreme-parameter solves in another
(``jax_solves``).  A text test holds the float32-emitted CUDA systems to
float code: no ``double`` and no floating literal without its ``F``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunode_tpu.ops.adams_batched import adams_solve_batched as jax_adams
from sunode_tpu.ops.bdf import BDFOptions as JaxOptions
from sunode_tpu.ops.bdf_batched import bdf_solve_batched as jax_bdf
from sunode_tpu.problem import JaxProblem
from sunode_tpu.symode import SympyProblem as JaxSympyProblem
from sunode_tpu.wrappers.as_jax import make_batched_solve_fn as jax_make
from sunode_torch.entry import _lv, lv_problem
from sunode_torch.ops.adams_batched import adams_solve_batched
from sunode_torch.ops.bdf import BDFOptions
from sunode_torch.ops.bdf_batched import bdf_solve_batched
from sunode_torch.problem import TorchProblem
from sunode_torch.symode import cuda_codegen
from sunode_torch.wrappers.as_torch import make_batched_solve_fn

B = 8
TVALS = np.linspace(1.0, 10.0, 6).astype(np.float32)
Y0S = np.tile(np.asarray([10.0, 2.0], np.float32), (B, 1))
PSUB = np.tile(np.asarray([1.0, 0.3], np.float32), (B, 1))
PFIX = np.asarray([1.0, 0.4], np.float32)
JAX_REL = 1e-3  # the port's float32 against the JAX package's float32
F64_REL = 5e-2  # float32 against float64, test_f32_mode.py's class
EXTREME = np.asarray(
    [[1.0, 0.3, 1.0, 0.4], [7e16, 0.7, 1.0, 0.4], [1e-26, 28.0, 1.0, 0.4], [2e15, 6.0, 1.0, 0.4]],
    np.float32,
)  # test_f32_mode.py:155-163: lane 0 sane, lanes 1-3 overflow the float32 norms
ADJOINT_MODES = [("hermite", "BDF"), ("hermite", "ADAMS"), ("polynomial", "ADAMS"),
                 ("resolve", "ADAMS"), ("transition", "ADAMS")]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: torch is faster on one CPU thread; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problems():
    """(the port's Lotka-Volterra SympyProblem, the JAX package's)."""
    jax_lv = JaxSympyProblem(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()},
        rhs_sympy=_lv,
        derivative_params=[("alpha",), ("beta",)],
    )
    return lv_problem(), jax_lv


def _extreme_inputs():
    """test_f32_mode.py:137's four lanes: (y0s, ps, tvals) at float32."""
    y0s = np.tile(np.asarray([10.0, 2.0], np.float32), (4, 1))
    return y0s, EXTREME, np.linspace(1.0, 10.0, 6).astype(np.float32)


EXTREME_OPTS = dict(rtol=1e-5, atol=1e-5, max_steps=2000, adams_max_order=6)


@pytest.fixture(scope="module")
def jax_solves(problems):
    """The JAX package's float32 solves, in one compile: the undifferentiated
    BDF call of test_f32_mode.py:125 ('forward') and the extreme-parameter
    solves of :137 on both cores (ys, status)."""
    _, ref = problems
    fwd = jax_make(ref, derivatives=None, options=JaxOptions(rtol=1e-5, atol=1e-5), method="BDF")
    jopts = JaxOptions(**EXTREME_OPTS)
    rhs, jac = ref.make_rhs(), ref.make_jac_dense()

    def run(fwd_args, ext_args):
        adams = jax_adams(rhs, 0.0, *ext_args, jopts)
        bdf = jax_bdf(rhs, jac, 0.0, *ext_args, jopts)
        return {"forward": fwd(0.0, *fwd_args), "adams": (adams.ys, adams.status),
                "bdf": (bdf.ys, bdf.status)}

    out = jax.jit(run)(tuple(jnp.asarray(a) for a in (Y0S, PSUB, PFIX, TVALS)),
                       tuple(jnp.asarray(a) for a in _extreme_inputs()))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def jax_grads(problems):
    """The JAX package's float32 gradients of sum(ys**2) in the five adjoint
    modes of test_f32_mode.py:194, in one compile: {mode: (gy, gp)}."""
    _, ref = problems
    solves = {m: jax_make(ref, **_adjoint_kwargs(*m, JaxOptions)) for m in ADJOINT_MODES}

    def grads(y0s, p_subs):
        out = {}
        for m, jsolve in solves.items():
            def loss(a, b, jsolve=jsolve):
                return jnp.sum(jsolve(0.0, a, b, jnp.asarray(PFIX), jnp.asarray(TVALS)) ** 2)

            out[m] = jax.grad(loss, argnums=(0, 1))(y0s, p_subs)
        return out

    out = jax.jit(grads)(jnp.asarray(Y0S), jnp.asarray(PSUB))
    return {m: tuple(np.asarray(a) for a in v) for m, v in out.items()}


def _rel(a, b, floor=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(b) + floor)))


def test_generated_functions_follow_input_dtype(problems):
    """test_f32_mode.py:49: rhs, Jacobian, df/dp and the adjoint Jacobian at
    float32 inputs are float32 and the JAX package's values; float64 inputs
    stay float64."""
    port, ref = problems
    y, p = np.asarray([10.0, 2.0], np.float32), np.asarray([1.0, 0.3, 1.0, 0.4], np.float32)
    ty, tp = torch.as_tensor(y), torch.as_tensor(p)
    jy, jp = jnp.asarray(y), jnp.asarray(p)
    calls = {
        "rhs": (port.make_rhs()(0.0, ty, tp), ref.make_rhs()(0.0, jy, jp)),
        "jac": (port.make_jac_dense()(0.0, ty, tp), ref.make_jac_dense()(0.0, jy, jp)),
        "dfdp": (port.make_dfdp()(0.0, ty, tp), ref.make_dfdp()(0.0, jy, jp)),
        "adjoint_jac": (port.make_adjoint_jac_dense()(0.0, ty, ty, tp),
                        ref.make_adjoint_jac_dense()(0.0, jy, jy, jp)),
    }
    for name, (got, want) in calls.items():
        assert got.dtype == torch.float32 and want.dtype == jnp.float32, name
        assert _rel(got, want, 1e-30) <= JAX_REL, name
    f64 = port.make_rhs()(0.0, ty.double(), tp)
    assert f64.dtype == torch.float64
    assert _rel(calls["rhs"][0], f64) <= F64_REL


def test_paramspec_combine_follows_input_dtype(problems):
    """test_f32_mode.py:60: ParamSpec.combine keeps float32 and float64."""
    port, ref = problems
    sub, rem = np.full((B, 2), 0.5, np.float32), np.full((B, 2), 0.25, np.float32)
    got = port.params.combine(torch.as_tensor(sub), torch.as_tensor(rem))
    want = ref.params.combine(jnp.asarray(sub), jnp.asarray(rem), xp=jnp)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    f64 = port.params.combine(torch.as_tensor(sub).double(), torch.as_tensor(rem))
    assert f64.dtype == torch.float64 and _rel(got, f64) <= F64_REL


def test_torch_problem_rhs_follows_input_dtype():
    """test_f32_mode.py:68: a TorchProblem's right-hand side (the port's
    JaxProblem) at float32 inputs is float32 and the JAX package's value;
    float64 inputs stay float64."""
    spec = dict(params={"k": ()}, states={"x": (2,)}, derivative_params=[("k",)])
    port = TorchProblem(rhs=lambda t, y, p: {"x": -p.k * y.x}, **spec).make_rhs()
    ref = JaxProblem(rhs=lambda t, y, p: {"x": -p.k * y.x}, **spec).make_rhs()
    y, k = np.ones(2, np.float32), np.asarray([0.5], np.float32)
    got = port(torch.tensor(0.0), torch.as_tensor(y), torch.as_tensor(k))
    want = ref(0.0, jnp.asarray(y), jnp.asarray(k))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert _rel(got, want) <= JAX_REL
    f64 = port(torch.tensor(0.0, dtype=torch.float64), torch.as_tensor(y).double(),
               torch.as_tensor(k).double())
    assert f64.dtype == torch.float64 and _rel(got, f64) <= F64_REL


def test_forward_solve_f32(problems, jax_solves):
    """test_f32_mode.py:125: the undifferentiated BDF solve at float32."""
    port, _ = problems
    tsolve = make_batched_solve_fn(port, derivatives=None,
                                   options=BDFOptions(rtol=1e-5, atol=1e-5), method="BDF")
    args = (Y0S, PSUB, PFIX, TVALS)
    ys = tsolve(0.0, *(torch.as_tensor(a) for a in args))
    want = jax_solves["forward"]
    assert ys.dtype == torch.float32 and want.dtype == np.float32
    assert torch.isfinite(ys).all()
    assert _rel(ys, want) <= JAX_REL
    ys64 = tsolve(0.0, *(torch.as_tensor(a).double() for a in args))
    assert ys64.dtype == torch.float64 and _rel(ys, ys64) <= F64_REL


@pytest.mark.parametrize("core", ["adams", "bdf"])
def test_extreme_params_no_livelock(problems, jax_solves, core):
    """test_f32_mode.py:137: parameters near 1e16 overflow the float32 norms
    of the initial step; the lanes die promptly with a nonzero status
    (status for status the JAX core's), and lane 0 solves, its ys the JAX
    core's and the float64 run's."""
    port, _ = problems
    ty0, tps, ttv = (torch.as_tensor(a) for a in _extreme_inputs())
    opts = BDFOptions(**EXTREME_OPTS)
    rhs = port.make_rhs()
    if core == "adams":
        def solve(*args):
            return adams_solve_batched(rhs, 0.0, *args, opts)
    else:
        def solve(*args):
            return bdf_solve_batched(rhs, port.make_jac_dense(), 0.0, *args, opts)
    res = solve(ty0, tps, ttv)
    res64 = solve(ty0[:1].double(), tps[:1].double(), ttv.double())
    want_ys, want_status = jax_solves[core]
    status = res.status.numpy()
    assert status[0] == 0 and (status[1:] != 0).all(), status
    np.testing.assert_array_equal(status, want_status)
    assert res.ys.dtype == torch.float32 and torch.isfinite(res.ys[0]).all()
    assert _rel(res.ys[0], want_ys[0]) <= JAX_REL
    assert _rel(res.ys[0], res64.ys[0]) <= F64_REL


def _adjoint_kwargs(mode, method, opts):
    return dict(derivatives="adjoint", options=opts(rtol=1e-5, atol=1e-5),
                adjoint_options=opts(rtol=1e-4, atol=1e-4), method=method,
                adjoint_interpolation=mode, checkpoint_n=256)


def _port_grads(problem, mode, method, dtype):
    solve = make_batched_solve_fn(problem, **_adjoint_kwargs(mode, method, BDFOptions))
    y0s, p_subs = (torch.as_tensor(a).to(dtype).requires_grad_() for a in (Y0S, PSUB))
    ys = solve(0.0, y0s, p_subs, torch.as_tensor(PFIX).to(dtype), torch.as_tensor(TVALS).to(dtype))
    return torch.autograd.grad(torch.sum(ys**2), (y0s, p_subs))


@pytest.mark.parametrize("mode, method", ADJOINT_MODES, ids=["-".join(m) for m in ADJOINT_MODES])
def test_adjoint_modes_f32(problems, jax_grads, mode, method):
    """test_f32_mode.py:194: every adjoint interpolation mode stays float32;
    its gradients within 1e-3 of the JAX package's float32 ones and within
    test_f32_mode.py's 5e-2 of the port's float64 run (|a - b| / (|b| +
    1e-2), that file's measure)."""
    port, _ = problems
    want = jax_grads[(mode, method)]
    gy, gp = _port_grads(port, mode, method, torch.float32)
    assert gy.dtype == gp.dtype == torch.float32
    assert torch.isfinite(gy).all() and torch.isfinite(gp).all()
    for got, w in zip((gy, gp), want):
        assert w.dtype == np.float32
        assert _rel(got, w, 1e-2) <= JAX_REL, f"{mode}/{method} against JAX"
    gy64, gp64 = _port_grads(port, mode, method, torch.float64)
    assert gy64.dtype == torch.float64
    rel = max(_rel(gy, gy64, 1e-2), _rel(gp, gp64, 1e-2))
    assert rel < F64_REL, f"{mode}/{method}: float32 against float64 {rel:.2e}"


# a C floating literal: digits with a point or an exponent, and its suffix
_FLOAT_LITERAL = re.compile(r"(?<![\w.])(\d+\.\d*|\.\d+|\d+(?=[eE]))([eE][+-]?\d+)?([fFlL]?)")


@pytest.mark.parametrize("kind", ["forward", "transition", "resolve", "staged_adjoint",
                                  "sensitivity", "staged_sensitivity"])
def test_f32_systems_are_float_code(problems, kind):
    """Every system emitted at ``real='float'`` is float code: no ``double``,
    every floating literal with its ``F`` suffix (a double literal would
    promote its expression, and the kernel's f would stop rounding as the
    plain float32 version's), the float forms of the functions; the same
    system at float64 keeps its double code."""
    port, _ = problems
    emit = getattr(cuda_codegen, f"{kind}_system")
    src = emit(port, "float").source
    assert emit(port, "float").real == "float"
    assert "double" not in src
    literals = [m.group(0) for m in _FLOAT_LITERAL.finditer(src)]
    assert literals and all(lit.endswith("F") for lit in literals), literals
    assert "expf(" in src and not re.search(r"\b(exp|log1p|fmax|fabs)\(", src)
    assert "pece_fz(float t, const float* y, const float* p, float* out)" in src
    assert "double" in emit(port).source and emit(port).real == "double"


def test_f32_printer_spells_float_forms():
    """The printer at float: rational and irrational constants as F
    literals (pi too, where C's macro is double), functions in their float
    forms, small negative powers over 1.0F."""
    import sympy as sy

    x, y = sy.symbols("x y", real=True)
    code = cuda_codegen.emit_device_function(
        "f", [sy.exp(-x) + sy.Rational(1, 3) * y, sy.pi * x / y**2, sy.sqrt(x) + sy.Abs(y)],
        {"x": "y[0]", "y": "y[1]"}, "const float* y, float* out", "float")
    assert "double" not in code and "M_PI" not in code
    assert "expf(" in code and "sqrtf(" in code and "fabsf(" in code and "1.0F/" in code
    literals = [m.group(0) for m in _FLOAT_LITERAL.finditer(code)]
    assert all(lit.endswith("F") for lit in literals), literals
    with pytest.raises(ValueError, match="real"):
        cuda_codegen.emit_device_function("f", [x], {"x": "y[0]"}, "", "half")
