"""sunode_torch must import torch and never jax, and leave torch's global
state alone, through an Adams gradient step, a BDF solve, a BDF gradient
step with the checkpointed (hermite) adjoint, a ``solve_ivp`` gradient
through ``torch.autograd`` (the single-chain surface), a TorchProblem's
derivatives, staggered and simultaneous sensitivities, rootfinding on both
cores and the two emitted sensitivity systems, with the split attempt's
module imported, and through the class API (``Solver``, ``AdjointSolver``)
and the event functions, the sampler (one NUTS transition and a short
``nuts_sample``) and the PyTensor wrapper on the port's own Op-protocol shim
(a loss and its gradient compiled with ``pytensor.function``, which runs
the Ops' ``perform``), the native host route (``sunode_torch.native``: a
native solve and a native adjoint pair) and a gradient split over two
devices (``sunode_torch.parallel``), imported and run with jax and
sunode_tpu blocked from import; checked in a fresh interpreter."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROGRAM = r"""
import json, sys
import numpy as np
import torch


class _Blocked:
    # any import of jax or the JAX package fails
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sunode_tpu"):
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, _Blocked())
default_before = torch.get_default_dtype()
import sunode_torch
import sunode_torch.solver
import sunode_torch.events
import sunode_torch.experiments.exp_pece2d
import sunode_torch.ops.pece_2d
import sunode_torch.ops.adams_split
from sunode_torch.entry import (build_lv_adjoint, build_lv_checkpointed, build_lv_roots,
                                build_lv_sens, build_robertson, sir_problem, LV_SENS_MODES)
from sunode_torch.symode import cuda_codegen

step, (y0s, p_subs) = build_lv_adjoint(batch=2, tvals_n=3, rtol=1e-6, device="cpu")
gy, gp = step(y0s, p_subs)
solve, inputs = build_robertson(2, device="cpu")
ys = solve(0.0, *inputs)
cstep, (cy0s, cp_subs) = build_lv_checkpointed(batch=2, tvals_n=2, rtol=1e-6, device="cpu")
cgy, cgp = cstep(cy0s, cp_subs)
sir = sir_problem(3)
f64 = dict(dtype=torch.float64)
lam = sir.make_adjoint_rhs()(torch.zeros(2, **f64), torch.ones(9, 2, **f64),
                             torch.ones(9, 2, **f64), torch.ones(3, 2, **f64))
sens_ok = []
for method, mode in LV_SENS_MODES:
    solve, (sy0, sps, stv) = build_lv_sens(2, method, mode, device="cpu")
    res = solve(sy0, sps, stv[:3])
    sens_ok.append(bool((res.status == 0).all()) and bool(torch.isfinite(res.sens).all()))
roots_ok = []
for method in ("BDF", "ADAMS"):
    rsolve, (ry0, rps, rtv) = build_lv_roots(2, method, True, device="cpu")
    rres = rsolve(ry0, rps, rtv[:3])
    roots_ok.append(bool((rres.status == 5).all()) and bool((rres.stats["n_roots"] == 1).all()))
from sunode_torch.entry import _lv, lv_problem
from sunode_torch.ops.bdf import BDFOptions
alpha = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
ivp = sunode_torch.solve_ivp(
    0.0, {"hares": (10.0, ()), "lynx": (2.0, ())},
    {"alpha": alpha, "beta": (0.3, ()), "gamma": np.array(1.0), "delta": np.array(0.4)},
    np.linspace(1.0, 3.0, 3), _lv,
    solver_kwargs=dict(rtol=1e-5, atol=1e-5, adjoint_options=BDFOptions(rtol=1e-5, atol=1e-5)),
    device="cpu")
(g_ivp,) = torch.autograd.grad(torch.sum(ivp.solution["hares"] ** 2), alpha)
lvp = lv_problem()
solver = sunode_torch.Solver(lvp, solver="ADAMS", reltol=1e-6, abstol=1e-6, device="cpu")
solver.set_params_dict({"alpha": 1.0, "beta": 0.3, "gamma": 1.0, "delta": 0.4})
class_ys = solver.solve(0.0, np.linspace(0.5, 3.0, 4), np.tile([10.0, 2.0], (2, 1)))
adj = sunode_torch.AdjointSolver(lvp, reltol=1e-6, abstol=1e-6, checkpoint_n=512, device="cpu",
                                 native_single=False)
adj.set_params_dict({"alpha": 1.0, "beta": 0.3, "gamma": 1.0, "delta": 0.4})
adj.solve_forward(0.0, np.linspace(0.5, 3.0, 4), np.array([10.0, 2.0]))
adj_grad, _ = adj.solve_backward(3.0, 0.0, np.linspace(0.5, 3.0, 4), np.ones((4, 2)))
from sunode_torch.entry import build_ball_event
event, (by0, bp, bfix, btmax) = build_ball_event("forward", device="cpu")
bp = bp.clone().requires_grad_(True)
t_ev, _ = event(0.0, by0, bp, bfix, btmax)
(dt_dg,) = torch.autograd.grad(t_ev, bp)
from sunode_torch._compat.pt_shim import install, is_shim_active
shim_installed = install()
import pytensor
import pytensor.tensor as pt
import sunode_torch.sample
from sunode_torch.sample.nuts import TorchDraws, _transition, _value_and_grad_batched
from sunode_torch.wrappers.as_pytensor import solve_ivp as pt_solve_ivp
gauss = lambda q: -0.5 * torch.sum((q - 1.0) ** 2, dim=1)
q0 = torch.zeros(3, 2, dtype=torch.float64)
lp0, g0 = _value_and_grad_batched(gauss, q0)
tr = _transition(gauss, q0, lp0, g0, 0.5, torch.ones(2, dtype=torch.float64),
                 TorchDraws(0).transition(), 4)
run = sunode_torch.sample.nuts_sample(gauss, 0, q0, num_warmup=4, num_samples=3, max_treedepth=3)
p_alpha = pt.dscalar("alpha")
pt_flat = pt_solve_ivp(0.0, {"hares": (np.float64(10.0), ()), "lynx": (np.float64(2.0), ())},
                       {"alpha": (p_alpha, ()), "beta": np.float64(0.3), "gamma": np.float64(1.0),
                        "delta": np.float64(0.4)}, np.linspace(0.5, 2.0, 3), _lv,
                       solver_kwargs={"device": "cpu", "reltol": 1e-6, "abstol": 1e-6,
                                      "native_single": False})[1]
pt_loss = (pt_flat ** 2).sum()
pt_out = pytensor.function([p_alpha], [pt_loss, pytensor.grad(pt_loss, p_alpha)])(1.0)
emitted = [cuda_codegen.sensitivity_system(lvp).nz, cuda_codegen.staged_sensitivity_system(lvp).n_p]
import sunode_torch.native.cpu_solver
import sunode_torch.parallel.mesh
from sunode_torch.entry import build_lv_adjoint_sharded
native = sunode_torch.Solver(lvp, solver="ADAMS", reltol=1e-6, abstol=1e-6, device="cpu")
native.set_params_dict({"alpha": 1.0, "beta": 0.3, "gamma": 1.0, "delta": 0.4})
native_ys = native.solve(0.0, np.linspace(0.5, 3.0, 4), np.array([10.0, 2.0]))
nadj = sunode_torch.AdjointSolver(lvp, reltol=1e-6, abstol=1e-6, device="cpu")
nadj.set_params_dict({"alpha": 1.0, "beta": 0.3, "gamma": 1.0, "delta": 0.4})
nadj.solve_forward(0.0, np.linspace(0.5, 3.0, 4), np.array([10.0, 2.0]))
native_grad, _ = nadj.solve_backward(3.0, 0.0, np.linspace(0.5, 3.0, 4), np.ones((4, 2)))
mesh = sunode_torch.Mesh((torch.device("cpu"),) * 2)
sstep, (sy0s, sps) = build_lv_adjoint_sharded(2, mesh, tvals_n=3, rtol=1e-6)
sgy, sgp = sstep(sy0s, sps)
from sunode_torch.entry import build_sir_state_split
cpu = torch.device("cpu")
rstep, (ry0s, rps) = build_sir_state_split(4, 2, "hermite",
                                           sunode_torch.Mesh(((cpu, cpu),), ("chains", "state")))
rys, rgp = rstep(ry0s, rps, tvals=rstep.tvals[:3])
print(json.dumps({
    "sens_ok": sens_ok,
    "roots_ok": roots_ok,
    "emitted": emitted,
    "jax_loaded": sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "tpu_loaded": sorted(m for m in sys.modules if m.startswith("sunode_tpu")),
    "default_dtype_kept": torch.get_default_dtype() == default_before,
    "finite": bool(torch.isfinite(gy).all() and torch.isfinite(gp).all()),
    "bdf_finite": bool(torch.isfinite(ys).all()) and tuple(ys.shape) == (2, 8, 3),
    "checkpointed_finite": bool(torch.isfinite(cgy).all() and torch.isfinite(cgp).all()),
    "recorded": cstep.solve.last_stats["forward"]["checkpoint_thinning_levels"] == 0,
    "torch_problem_finite": bool(torch.isfinite(lam).all()) and tuple(lam.shape) == (9, 2),
    "dtype": str(gy.dtype),
    "ivp_grad_finite": bool(torch.isfinite(g_ivp)) and ivp.problem.n_params == 1,
    "class_api_ok": bool(np.isfinite(class_ys).all()) and class_ys.shape == (2, 4, 2)
    and bool(np.isfinite(adj_grad).all()),
    "sampler_ok": bool(torch.isfinite(tr[0]).all()) and tuple(tr[5].shape) == (3,)
    and tuple(run.samples.shape) == (3, 3, 2) and bool(torch.isfinite(run.samples).all()),
    "pytensor_ok": shim_installed and is_shim_active() and bool(np.isfinite(pt_out).all()),
    "native_ok": native._native_solver is not None and bool(np.isfinite(native_ys).all())
    and "native_ys" in nadj._last_forward and bool(np.isfinite(native_grad).all()),
    "split_ok": bool(torch.isfinite(sgy).all() and torch.isfinite(sgp).all())
    and tuple(sgy.shape) == (2, 2),
    "state_split_ok": bool(torch.isfinite(rys).all() and torch.isfinite(rgp).all())
    and tuple(rys.shape) == (2, 3, 12) and tuple(rgp.shape) == (2, 2),
    "event_ok": abs(float(t_ev.detach()) - (2 * 2.0 / 9.81) ** 0.5) < 1e-8
    and bool(torch.isfinite(dt_dg).all()),
}))
"""


def test_import_and_cpu_solve_never_load_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROGRAM],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax_loaded"] == []
    assert out["tpu_loaded"] == []
    assert out["default_dtype_kept"]
    assert out["finite"] and out["dtype"] == "torch.float64"
    assert out["bdf_finite"]
    assert out["checkpointed_finite"] and out["recorded"]
    assert out["torch_problem_finite"]
    assert out["sens_ok"] == [True] * 3 and out["roots_ok"] == [True] * 2
    assert out["emitted"] == [6, 6]
    assert out["ivp_grad_finite"]
    assert out["class_api_ok"] and out["event_ok"]
    assert out["sampler_ok"] and out["pytensor_ok"]
    assert out["native_ok"] and out["split_ok"] and out["state_split_ok"]
