"""chip_smoke.py refuses to run without a CUDA device and prints no result."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok": true' not in proc.stdout


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kind", ["resolve", "staged_adjoint"])
def test_phase_3c_inputs_of_the_new_builds(kind):
    """Phase 3c's inputs for phase 7's backward builds, on the CPU at B=64:
    the history depth of adams_max_order 8, 1e-8 on every row, the staged
    build's y(t) rows after the parameters; the plain history attempt runs
    on them, and the bound counts their bytes and operations."""
    from sunode_torch.adjoint import resolve_fz, staged_adjoint_fz
    from sunode_torch.entry import lv_problem
    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER
    from sunode_torch.ops.adams_attempt import adams_history_attempt_reference
    from sunode_torch.ops.pece_step import PeceSystem
    from sunode_torch.symode import cuda_codegen

    cs = _chip_smoke()
    problem = lv_problem()
    aj, qr = problem.make_adjoint_rhs(), problem.make_adjoint_quad_rhs()
    if kind == "resolve":
        ds = cuda_codegen.resolve_system(problem)
        rhs_c, quad_c = resolve_fz(problem.make_rhs(), aj, qr, 2)
        fz = lambda t, y, p: torch.cat([rhs_c(t, y, p), quad_c(t, y, p)])  # noqa: E731
    else:
        ds = cuda_codegen.staged_adjoint_system(problem)
        rhs_s, quad_s = staged_adjoint_fz(aj, qr)
        fz = lambda t, y, p: torch.cat([rhs_s(t, y, p[:4], p[4:]), quad_s(t, y, p[:4], p[4:])])  # noqa: E731
    x = cs.history_inputs(ds, 64, 2, "cpu", cs.P_MAX_ADAMS, cs.ADAMS_RTOL)
    assert x["DF"].shape == (cs.P_MAX_ADAMS + 3, ds.nz, 64) and x["params"].shape == (ds.n_p, 64)
    assert (x["rtol_z"] == 1e-8).all() and (x["atol_z"] == 1e-8).all()
    assert int(x["p"].max()) <= cs.P_MAX_ADAMS and x["v_err"].shape == (ds.nz,)
    out = adams_history_attempt_reference(
        PeceSystem(fz=fz, n=ds.n, nz=ds.nz, device=ds), x["t_new"], x["h"], x["pre_factor"],
        x["p"], x["active"], x["DF"], x["z_prev"], x["params"], x["atol_z"], x["rtol_z"],
        x["gamma_star_abs"], x["v_err"], x["newton_tol"], FUNCTIONAL_MAXITER, cs.P_MAX_ADAMS,
    )
    assert torch.isfinite(out.DF_upd).all() and out.conv.any()
    nbytes, flops = cs.history_cost(ds, x, out.niter)
    assert nbytes > 8 * 3 * x["DF"].numel() and flops > 0


def test_phase_7_counts():
    cs = _chip_smoke()
    assert cs.ADAMS_MODES == ("resolve", "hermite", "polynomial")
    assert cs.adams_expected_launches("resolve", 3, 5) == {"forward": 3, "resolve": 5}
    assert cs.adams_expected_launches("hermite", 3, 5) == {"forward": 3, "staged_adjoint": 5}
    assert cs.adams_table_bytes("resolve", 10) == 0
    # 384 slots and the tail; (t, y, f, fdot) and (t, y, f) rows of 2 states
    assert cs.adams_table_bytes("hermite", 10) == 8 * 385 * 7 * 10
    assert cs.adams_table_bytes("polynomial", 10) == 8 * 385 * 5 * 10
