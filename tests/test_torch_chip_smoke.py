"""chip_smoke.py refuses to run without a CUDA device and prints no result."""

import os
import shutil
import subprocess
import sys

import numpy as np
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



def test_history_ab_fails_without_cuda():
    """history_ab.py (the history kernel against another version, beside
    chip_smoke.py) imports what it needs and stops without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: history_ab.py would run for real")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "history_ab.py"), "--phase-clocks"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "history_ab: no CUDA device" in proc.stderr

def test_split_ab_fails_without_cuda():
    """split_ab.py (the split predict and sweep against another version)
    imports what it needs and stops without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: split_ab.py would run for real")
    proc = subprocess.run(
        [sys.executable, "-m", "sunode_torch.experiments.split_ab", "--phase-clocks",
         "--geometry", "32,8"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "split_ab: no CUDA device" in proc.stderr


def test_sass_ab_fails_without_a_toolkit():
    """sass_ab.py (the float64 builds' machine code against another
    checkout's) imports what it needs and stops without nvcc."""
    if shutil.which("nvcc"):
        pytest.skip("a CUDA toolkit is present: sass_ab.py would build for real")
    proc = subprocess.run(
        [sys.executable, "-m", "sunode_torch.experiments.sass_ab", "--old-root", ROOT],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "sass_ab: no CUDA toolkit" in proc.stderr or "sass_ab: no cuobjdump" in proc.stderr


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


def test_phase_3d_inputs():
    """Phase 3d's inputs at a small width on the CPU: SIR's rows (3R), the
    history depth of adams_max_order 8, orders 1..8, the workload's
    tolerances; the split attempt's plain stages run on them, and the
    bounds count every stage's bytes."""
    from sunode_torch.entry import sir_problem
    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER
    from sunode_torch.ops.adams_split import adams_split_attempt_reference
    from sunode_torch.ops.pece_step import PeceSystem

    cs = _chip_smoke()
    R, B = 10, 64
    x = cs.split_inputs(B, 11, "cpu", R)
    assert x["DF"].shape == (cs.P_MAX_ADAMS + 3, 3 * R, B) and x["params"].shape == (3, B)
    assert int(x["p"].min()) >= 1 and int(x["p"].max()) == cs.P_MAX_ADAMS
    assert (x["rtol_z"] == 1e-8).all() and (x["atol_z"] == 1e-10).all()
    system = PeceSystem(fz=sir_problem(R).make_rhs(), n=3 * R, nz=3 * R)
    out = adams_split_attempt_reference(
        system, x["t_new"], x["h"], x["pre_factor"], x["p"], x["active"], x["DF"], x["z_prev"],
        x["params"], x["atol_z"], x["rtol_z"], x["gamma_star_abs"], x["v_err"],
        x["newton_tol"], FUNCTIONAL_MAXITER, cs.P_MAX_ADAMS,
    )
    assert torch.isfinite(out.DF_upd).all() and out.conv.any() and not out.conv.all()
    costs = cs.split_costs(x, 3 * R)
    history = 8 * x["DF"].numel()
    assert costs["predict"][0] > 2 * history and costs["finish"][0] > 2 * history
    assert 0 < costs["sweep"][0] < history and all(ops > 0 for _, ops in costs.values())


@pytest.mark.parametrize("kind", ["resolve", "staged_adjoint"])
def test_phase_3d_backward_inputs(kind):
    """Phase 3d's backward shapes at a small width on the CPU: 'resolve'
    corrects [y | lam] (6R rows) under two quadratures, the 'hermite' staged
    system lam (3R rows) with y(t) after the three parameters; the error
    norm weighs the two blocks equally; the plain stages run on them."""
    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER
    from sunode_torch.ops.adams_split import adams_split_attempt_reference
    from sunode_torch.ops.pece_step import PeceSystem

    cs = _chip_smoke()
    R, B = 10, 64
    fz, n, nz = cs.split_system(kind, R)
    assert (n, nz) == ((6 * R, 6 * R + 2) if kind == "resolve" else (3 * R, 3 * R + 2))
    x = cs.split_inputs(B, 12, "cpu", R, kind)
    assert x["DF"].shape == (cs.P_MAX_ADAMS + 3, nz, B) and x["z_prev"].shape == (nz, B)
    assert x["params"].shape == ((3, B) if kind == "resolve" else (3 + 3 * R, B))
    assert (x["t_new"] <= 0).all()
    assert torch.isclose(x["v_err"][:n].sum(), x["v_err"][n:].sum())
    out = adams_split_attempt_reference(
        PeceSystem(fz=fz, n=n, nz=nz), x["t_new"], x["h"], x["pre_factor"], x["p"],
        x["active"], x["DF"], x["z_prev"], x["params"], x["atol_z"], x["rtol_z"],
        x["gamma_star_abs"], x["v_err"], x["newton_tol"], FUNCTIONAL_MAXITER, cs.P_MAX_ADAMS,
    )
    assert torch.isfinite(out.DF_upd).all() and torch.isfinite(out.err3).all()
    assert cs.SPLIT_CASES == (("forward", 1024), ("resolve", 1024), ("staged_adjoint", 256))


def test_phase_3d_lane_errors():
    """Per-lane errors see a lane that is wrong only where its values are
    small, which a normwise error hides; a zero needs an exact zero."""
    cs = _chip_smoke()
    ref = torch.tensor([[1.0, 1e-6, 0.0], [2.0, 3e-9, 5.0]], dtype=torch.float64)
    got = ref.clone()
    got[1, 1] *= 1 + 1e-9
    (rel, _), lane = cs.rel_errors({"e": (got, ref)}), cs.lane_rel(got, ref)
    assert rel["e"] < 1e-12 < lane and lane == pytest.approx(1e-9, rel=1e-6)
    assert cs.lane_rel(ref, ref.clone()) == 0.0
    bumped = ref.clone()
    bumped[0, 2] = 1e-300
    assert cs.lane_rel(bumped, ref) == float("inf")
    rel, worst = cs.split_errors({"z": (ref, ref)}, {"err3": (got, ref)})
    assert set(rel) == {"z", "err3/lane"} and rel["err3/lane"] == lane and worst > 0


def test_phase_8_bookkeeping():
    """Phase 8's expected launches (one predict and finish an attempt, four
    sweeps), the split counts read and reset as one, and the SIR table."""
    from sunode_torch.ops.adams_split import adams_split_attempt

    cs = _chip_smoke()
    assert cs.SIR_MODES == (("resolve", 1024), ("hermite", 256))
    assert cs.SIR_PROFILED_TIMES == 2  # the profiled warm-up's horizon, t <= 10 (4 before phase 17's cut)
    assert cs.split_expected_launches(7) == {"predict": 7, "sweep": 28, "finish": 7}
    saved = dict(adams_split_attempt.launches)
    try:
        count = cs.SplitLaunches()
        adams_split_attempt.launches.update(predict=2, sweep=8, finish=2)
        assert count.launches == 12
        count.launches = 0
        assert adams_split_attempt.launches == {"predict": 0, "sweep": 0, "finish": 0}
    finally:
        adams_split_attempt.launches.update(saved)
    # 1,024 slots and the tail, quintic rows of 3,000 states: 18.9 GB at 256 lanes
    assert cs.sir_table_bytes("hermite", 256) == 8 * 1025 * 9001 * 256
    assert cs.sir_table_bytes("resolve", 1024) == 0


def test_history_cost_builds_the_tables_once_a_lane():
    """The history attempt's operations: R(fac) once a lane (3 p (p - 1) + p),
    U not at all, each row 4 p^2 for applying both; still bytes-bound at
    phase 3c's width and deepest order."""
    from sunode_torch.entry import lv_problem
    from sunode_torch.symode import cuda_codegen

    cs = _chip_smoke()
    forward = cuda_codegen.forward_system(lv_problem())
    assert cs.rhs_flops(forward) == 9
    x = {"DF": torch.zeros((9, 2, 2), dtype=torch.float64),
         "p": torch.tensor([1, 3], dtype=torch.int32),
         "gamma_star_abs": torch.zeros(14, dtype=torch.float64)}
    # per lane 1 and 21 (R), per row 41 and 83; two sweeps of (9 + 12) and
    # one; the final evaluation and the lane's scalars 2 x 25
    assert cs.history_cost(forward, x, torch.tensor([1, 2])) == (1332, 383)
    transition = cuda_codegen.transition_system(lv_problem())
    x = cs.history_inputs(transition, cs.B_MAIN, 1, "cpu")
    x["p"] = torch.full_like(x["p"], cs.P_MAX)
    nbytes, flops = cs.history_cost(transition, x, torch.full_like(x["p"], 4))
    assert cs.bound(nbytes, flops)["bound_by"] == "bytes"


def test_phase_6_profiled_horizon():
    """The profiled solves (phase 9(b)'s, and phase 6's step's before it ran
    none) take a tenth of the horizon: the leading observation times at the
    same spacing (here the first alone), and a quarter would take the
    leading four."""
    cs = _chip_smoke()
    tvals = torch.linspace(1.0, 10.0, 21, dtype=torch.float64)
    short = cs.leading_times(tvals, cs.PROFILED_HORIZON)
    assert cs.PROFILED_HORIZON == 0.1
    assert torch.equal(short, tvals[:1]) and float(short[-1]) == pytest.approx(1.0)
    quarter = cs.leading_times(tvals, 0.25)
    assert torch.equal(quarter, tvals[:4]) and float(quarter[-1]) == pytest.approx(2.35)
    assert torch.equal(cs.leading_times(tvals, 1.0), tvals)


def test_phase_9_bookkeeping():
    """Phase 9's expected launches by system, its runs of the root solve,
    the sensitivity block's split-stage inputs on the CPU at B=8 (one
    attempt of the Adams staggered solve, on which the split stages run and
    every lane converges), and the plain right-hand sides of both new
    systems on phase 3c's inputs at B=64, which take the rows their emitted
    systems take."""
    from sunode_torch.entry import lv_problem
    from sunode_torch.ops import adams_split as sp
    from sunode_torch.ops.adams import FUNCTIONAL_MAXITER
    from sunode_torch.ops.pece_step import PeceSystem
    from sunode_torch.symode import cuda_codegen

    cs = _chip_smoke()
    assert cs.sens_expected_launches("BDF", "staggered", 9) == {}
    assert cs.sens_expected_launches("ADAMS", "staggered", 9) == {
        "forward": 9, "staged_sensitivity": 9}
    assert cs.sens_expected_launches("ADAMS", "simultaneous", 9) == {"sensitivity": 9}
    assert cs.ROOT_RUNS == ((True, None), (False, None), (False, [-1]))
    fz, n, nz = cs.split_system("staged_sensitivity")
    x = cs.lv_sens_split_inputs(8, "cpu")
    assert (n, nz) == (4, 4) and x["params"].shape == (6, 8)
    assert x["DF"].shape == (cs.P_MAX + 3, 4, 8)
    # a real attempt: the solve's orders and gate, and every lane converges
    assert x["active"].all() and (x["p"] >= 1).all() and (x["p"] <= cs.P_MAX).all()
    out = sp.adams_split_attempt(
        PeceSystem(fz=fz, n=n, nz=nz), x["t_new"], x["h"], x["pre_factor"], x["p"], x["active"],
        x["DF"], x["z_prev"], x["params"], x["atol_z"], x["rtol_z"], x["gamma_star_abs"],
        x["v_err"], x["newton_tol"], FUNCTIONAL_MAXITER, cs.P_MAX)
    assert torch.isfinite(out.DF_upd).all() and out.conv.all()
    for kind in cs.SENS_KINDS:
        ds = getattr(cuda_codegen, f"{kind}_system")(lv_problem())
        xh = cs.history_inputs(ds, 64, 2, "cpu")
        rows = cs.lv_sens_fz(kind)(xh["t_new"], xh["z_prev"], xh["params"])
        assert rows.shape == (ds.nz, 64) and torch.isfinite(rows).all()
        nbytes, flops = cs.history_cost(ds, xh, torch.ones(64, dtype=torch.int32))
        assert cs.bound(nbytes, flops)["bound_by"] == "bytes"


# synthetic device records (name, µs) of one split attempt: predict, four
# sweeps and finish, the finish after its launcher's fill of tile counters
_ATTEMPT = ([("split_predict_kernel(double const*, ...)", 1.0)]
            + [("void split_sweep_kernel<true>(int, ...)", 1.0)] * 4
            + [("Memset (Device)", 0.1), ("split_finish_kernel(double const*, ...)", 1.0)])
_SPLIT = ["split_predict_kernel", "split_sweep_kernel", "split_finish_kernel"]


def test_fills_before_counts_records_right_after_a_memset():
    """Each kernel's records, and those that directly follow a memset: a
    memset two records back, or a copy, does not count."""
    cs = _chip_smoke()
    events = (_ATTEMPT * 3 + [("Memset (Device)", 0.1), ("elementwise_kernel", 1.0)]
              + _ATTEMPT[:1] + [("Memcpy DtoD (Device -> Device)", 0.1)] + _ATTEMPT[1:2])
    assert cs.fills_before(events, _SPLIT) == {
        "split_predict_kernel": (4, 0), "split_sweep_kernel": (13, 0),
        "split_finish_kernel": (3, 3)}
    assert cs.fills_before([], _SPLIT) == dict.fromkeys(_SPLIT, (0, 0))
    assert cs.fills_before([("Memset (Device)", 0.1)] + _ATTEMPT[:1], _SPLIT)[
        "split_predict_kernel"] == (1, 1)


@pytest.mark.parametrize("case, ok", [
    ("attempts", True),
    ("fill before a predict", False),
    ("fill before a sweep", False),
    ("no predict", False),
    ("no sweep", False),
    ("finish without its fill", False),
])
def test_split_fills_ok(case, ok):
    """Phase 8's fill check: no fill right before a predict or a sweep, both
    seen, and the finish's fill seen."""
    cs = _chip_smoke()
    events = _ATTEMPT * 2
    if case == "fill before a predict":
        events = events + [("Memset (Device)", 0.1)] + _ATTEMPT
    elif case == "fill before a sweep":
        events = events[:3] + [("Memset (Device)", 0.1)] + events[3:]
    elif case == "no predict":
        events = [e for e in events if "predict" not in e[0]]
    elif case == "no sweep":
        events = [e for e in events if "sweep" not in e[0]]
    elif case == "finish without its fill":
        events = [e for e in events if not e[0].startswith("Memset")]
    assert cs.split_fills_ok(cs.fills_before(events, _SPLIT)) is ok


def test_phase_10_float32_inputs_and_bounds():
    """Phase 10(a)'s inputs at float32 on the CPU: the same draws rounded,
    lv_adjoint_f32's tolerances with their float32 corrector tolerance, the
    bytes bound at 4 bytes a value (the float64 one's floating bytes
    halved), the operations at float32's rate and counted from the float
    source as from the double one; the split inputs at SIR's float32
    tolerances, their costs at 4 bytes."""
    from sunode_torch.entry import lv_problem
    from sunode_torch.ops.bdf import BDFOptions, newton_tol_for
    from sunode_torch.symode import cuda_codegen

    cs = _chip_smoke()
    problem = lv_problem()
    for kind in cs.F32_KINDS:
        ds64 = getattr(cuda_codegen, f"{kind}_system")(problem)
        ds32 = getattr(cuda_codegen, f"{kind}_system")(problem, "float")
        assert cs.rhs_flops(ds32) == cs.rhs_flops(ds64) > 0
        x64 = cs.history_inputs(ds64, 64, 1, "cpu", cs.P_MAX, cs.F32_FWD_TOL)
        x32 = cs.history_inputs(ds32, 64, 1, "cpu", cs.P_MAX, cs.F32_FWD_TOL, torch.float32)
        for k, v in x64.items():
            if torch.is_tensor(v) and v.is_floating_point():
                assert x32[k].dtype == torch.float32 and torch.equal(x32[k], v.float()), k
        assert x32["newton_tol"] == newton_tol_for(
            BDFOptions(rtol=1e-6, atol=1e-6), 1e-6, torch.float32) > x64["newton_tol"]
        niter = torch.full((64,), 2, dtype=torch.int32)
        (b64, f64), (b32, f32) = (cs.history_cost(ds, x, niter) for ds, x in ((ds64, x64),
                                                                              (ds32, x32)))
        lanes_int = 4 * 64 + 64 + 64 + 4 * 64  # p, active, conv, niter
        assert f32 == f64 and b32 - lanes_int == (b64 - lanes_int) // 2
        assert cs.bound(b32, f32, torch.float32)["bound_ms"] <= cs.bound(b64, f64)["bound_ms"]
    x = cs.split_inputs(32, 11, "cpu", 10, dtype=torch.float32)
    assert x["DF"].dtype == torch.float32
    assert (x["rtol_z"] == np.float32(1e-6)).all() and (x["atol_z"] == np.float32(1e-8)).all()
    x64 = cs.split_inputs(32, 11, "cpu", 10)
    c32, c64 = cs.split_costs(x, 30), cs.split_costs(x64, 30)
    assert all(c32[k][1] == c64[k][1] and c32[k][0] < 0.6 * c64[k][0] for k in c32)


def test_phase_10_counts_a_build():
    """Phase 10(c) reads and resets one split build's counts, apart from
    every build's."""
    from sunode_torch.ops.adams_split import adams_split_attempt

    cs = _chip_smoke()

    class Build:
        launches = {"predict": 1, "sweep": 4, "finish": 1}

    build, saved = Build(), dict(adams_split_attempt.launches)
    try:
        count = cs.SplitLaunches(build)
        assert count.launches == 6
        count.launches = 0
        assert build.launches == {"predict": 0, "sweep": 0, "finish": 0}
        assert adams_split_attempt.launches == saved
    finally:
        adams_split_attempt.launches.update(saved)


def test_phase_11_grids():
    """Phase 11's grids: 6 to 21 times a lane on [0.5, 10], sorted, padded
    with the last, the first slot at the last time where phase 11 looks for
    it; lanes 0-15 of the 10,000-lane chains are the golden ones whatever
    the width."""
    from sunode_torch.entry import lv_per_lane_tvals, lv_root_inputs

    tv = torch.as_tensor(lv_per_lane_tvals(1000))
    last = (tv == tv[:, -1:]).int().argmax(dim=1)
    assert int(last.min()) + 1 == 6 and int(last.max()) + 1 == 21
    pad = torch.arange(21)[None, :] >= last[:, None]
    assert (tv[pad] == tv[:, -1:].expand_as(tv)[pad]).all()
    assert (tv[~pad] < tv[:, -1:].expand_as(tv)[~pad]).all()
    y16, p16 = lv_root_inputs(16)
    y, p = lv_root_inputs(100)
    assert np.array_equal(y[:16], y16) and np.array_equal(p[:16], p16)


def test_phase_12_bits_and_costs():
    """Phase 12(a)'s bit-for-bit check tells -0.0 from +0.0 and matches NaN
    patterns; its bounds count each input once and each output once."""
    cs = _chip_smoke()
    a = torch.tensor([0.0, float("nan"), 1.5], dtype=torch.float64)
    assert cs.bits_equal(a, a.clone())
    assert not cs.bits_equal(a, torch.tensor([-0.0, float("nan"), 1.5], dtype=torch.float64))
    assert not cs.bits_equal(a, torch.tensor([0.0, 2.0, 1.5], dtype=torch.float64))
    assert not cs.bits_equal(a, a.float())
    assert cs.bits_equal(torch.arange(3, dtype=torch.int32), torch.arange(3, dtype=torch.int32))
    n, B = 128, 1024
    cost = cs.banded_cost(n, B, 1, 1, 1, 8)
    ab, lu = 3 * n * B * 8, 4 * (n + 2) * B * 8
    assert cost["factor"] == (ab + lu + 4 * n * B + B, n * B * 5)
    assert cost["solve"] == (lu + 4 * n * B + B + 2 * n * B * 8, n * B * 7)
    assert cs.expected_banded({"n_linear_factors": 3, "n_linear_solves": 10}, False) == {
        "factor": 3, "solve": 10}
    assert cs.expected_banded({"n_linear_factors": 3, "n_linear_solves": 10}, True) == {
        "factor": 3, "solve": 13}


def test_phase_12_counts_every_banded_build():
    """Phase 12's counter sets the banded wrappers' and builds' counts to 0
    at once and reads the wrappers' by kind."""
    from sunode_torch.ops import banded as bd

    cs = _chip_smoke()

    class Build:
        factor_launches, solve_launches = 2, 5

    saved = (bd.banded_factor.launches, bd.banded_solve.launches)
    try:
        bd.banded_factor.launches, bd.banded_solve.launches = 1, 3
        build = Build()
        count = cs.BandedCounts((build,))
        assert count.launches == 4 and count.by_kind() == {"factor": 1, "solve": 3}
        count.launches = 0
        assert (bd.banded_factor.launches, bd.banded_solve.launches) == (0, 0)
        assert (build.factor_launches, build.solve_launches) == (0, 0)
    finally:
        bd.banded_factor.launches, bd.banded_solve.launches = saved


def test_phase_12_lsoda_oracle_agrees_with_the_plain_band_path():
    """Phase 12's oracle (scipy's LSODA at rtol 1e-11) against the port's
    band solve on the CPU, on the chain's first lanes at n = 12: within the
    gate of 5e-6, as phase 12 holds the card's solve to it; lanes 0-15 of
    a wide draw are a narrow draw's initial states."""
    from sunode_torch.entry import build_kpp, kpp_inputs

    cs = _chip_smoke()
    forward, _, (y0, p, tvals) = build_kpp(12, 3, "band", device="cpu")
    ys = forward(y0, p).numpy()
    worst = cs.lsoda_gate("test", ys, y0.numpy(), p.numpy(), tvals)
    assert worst < 5e-6
    wide = kpp_inputs(12, 64)
    assert np.array_equal(wide[0][:3], y0.numpy()) and np.array_equal(wide[2], tvals)


def test_cpu_refs_from_a_worker_equal_the_inline_ones():
    """chip_smoke's CPU references run in spawned worker processes give what
    the phase would compute inline, and ``close`` stops the workers."""
    cs = _chip_smoke()
    # the workers import the script by name, as they import it as __main__
    # when it runs
    sys.modules["chip_smoke"] = cs
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    refs = cs.CpuRefs()
    try:
        refs.submit(cs.ref_structured, "kpp", 12, "band")
        cs.CPU_REFS = refs
        got = cs.cpu_ref(cs.ref_structured, "kpp", 12, "band")
        assert not refs.futures  # read once
    finally:
        cs.CPU_REFS = None
        refs.close()
        del sys.modules["chip_smoke"]
    want = cs.cpu_ref(cs.ref_structured, "kpp", 12, "band")  # no worker: inline
    np.testing.assert_array_equal(got["ys"], want["ys"])
    assert got["ys"].shape == (4, 8, 12)
    assert not any(p.is_alive() for p in (refs.pool._processes or {}).values())


def test_phase_12a_bounds():
    """Phase 12(a)'s bounds of the banded kernels at the path's shape: the
    bytes each call must move, and the chain of dependent steps (n columns
    or rows of measured latencies), which is the larger by far."""
    cs = _chip_smoke()
    cost = cs.banded_cost(128, 1024, 1, 1, 1, 8)
    assert cost["factor"][0] == 3 * 128 * 1024 * 8 + 4 * 130 * 1024 * 8 + 4 * 128 * 1024 + 1024
    chain = cs.banded_chain(128, 1, 1, "double")
    for kind in ("factor", "solve"):
        cycles, seconds = chain[kind]
        assert seconds == cycles / cs.SM_CLOCK_HZ
        assert seconds > 4 * cost[kind][0] / 3.35e12  # the chain, not the bytes, bounds it
    lat = cs.CHAIN_LATENCY["double"]
    assert chain["factor"][0] == 128 * (2 * lat["compare_select"] + lat["div"] + lat["mul"]
                                        + lat["add"])
    assert cs.banded_chain(128, 1, 1, "float")["solve"][0] < chain["solve"][0]


def test_banded_ab_needs_a_card():
    """The banded A/B harness measures only on a card: without one it stops
    before building anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the harness would run for real")
    proc = subprocess.run(
        [sys.executable, "-m", "sunode_torch.experiments.banded_ab"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "banded_ab: no CUDA device" in proc.stderr


def test_phase_13_inputs_gates_and_counts():
    """Phase 13's bookkeeping on the CPU: (a) runs lanes 0-1 of
    lv_adjoint.npz's chains, the lanes its golden gate reads; (c) is the
    README's quickstart call; (d)'s two grids are ragged, padded with their
    last time; the banded launches a gradient expects are its Newton
    solver's calls; and the counting wrapper of (d) adds a lane's forward
    attempts at its call and its backward's once the backward has run."""
    from sunode_torch.entry import build_lv_single, lv_problem
    from sunode_torch.ops.bdf import BDFOptions
    from sunode_torch.wrappers.as_torch import make_solve_fn, solve_lanes

    cs = _chip_smoke()
    golden = np.load(os.path.join(ROOT, "tests", "golden", "lv_adjoint.npz"))
    _, (y0s, p_subs) = build_lv_single(cs.SINGLE_LANES, device="cpu")
    np.testing.assert_array_equal(y0s.numpy(), golden["y0s"][: cs.SINGLE_LANES])
    np.testing.assert_array_equal(p_subs.numpy(), golden["p_subs"][: cs.SINGLE_LANES])
    kw = cs.single_ivp_kwargs(1.0)
    assert kw["y0"] == {"hares": (10.0, ()), "lynx": (2.0, ())}
    np.testing.assert_array_equal(kw["tvals"], np.linspace(1.0, 10.0, 21))
    grids = cs.single_lane_grids()
    assert grids.shape == (cs.SINGLE_LANES, 21) and (np.diff(grids, axis=1) >= 0).all()
    assert (grids[:, -1] == grids.max(axis=1)).all()
    assert cs.SINGLE_KPP_N == 128 and cs.SINGLE_B1_N[-1] == 128
    assert cs.expected_banded({"n_linear_factors": 4, "n_linear_solves": 9}, False) == {
        "factor": 4, "solve": 9}
    opts = BDFOptions(rtol=1e-4, atol=1e-4)
    solve = make_solve_fn(lv_problem(), options=opts, adjoint_options=opts)
    attempts = []
    y = y0s.clone().requires_grad_(True)
    ys = solve_lanes(cs._CountingSolve(solve, attempts), 0.0, y, p_subs,
                     torch.tensor([1.0, 0.4], dtype=torch.float64),
                     torch.as_tensor(grids[:, :4]))
    assert len(attempts) == cs.SINGLE_LANES and all(a > 0 for a in attempts)
    torch.autograd.grad(ys.sum(), y)
    assert len(attempts) == 2 * cs.SINGLE_LANES
    assert attempts[-1] == solve.last_stats["backward"]["n_attempts"]


def test_phase_6_polynomial_horizon():
    """Phase 6 holds 'polynomial' to the CPU over the first POLY_TIMES of the
    step's 21 observation times (t <= 2.35)."""
    from sunode_torch.entry import build_lv_checkpointed

    cs = _chip_smoke()
    step, _ = build_lv_checkpointed(1, 21, 1e-8, "polynomial", device="cpu")
    assert cs.POLY_TIMES == 4 and float(step.tvals[cs.POLY_TIMES - 1]) == 2.35


def test_phase_14_parts_gates_and_budget():
    """Phase 14's static checks on the CPU: its parts (lv_forward through the
    Solver, the AdjointSolver pair, the events and the sweep) and their
    CPU references submitted to the workers; the gates (lv_forward.npz's
    rtol 2e-7 / atol 2e-9, lanes 0-3 against the CPU), the 45 s budget, the
    4-lane sweep; the kernel line's KAB=11 forward and staged_adjoint
    entries counting the phase's launches; the closed forms of the ball
    against the port's CPU hybrid solve; phase 14's inputs those of
    bench.py's lv_forward (lanes 0-15 the fixture's)."""
    import inspect

    from sunode_torch.entry import BALL_G, BALL_H, build_ball_hybrid, lv_forward_inputs

    cs = _chip_smoke()
    assert cs.LV_FORWARD_GATE == (2e-7, 2e-9) and cs.LV_FORWARD_CPU_LANES == 4
    assert cs.PHASE14_BUDGET_S == 45.0 and cs.SWEEP_LANES == 4
    assert cs.CLASS_KINDS == (("BDF", "BDF"), ("ADAMS", "ADAMS"))
    doc = cs.__doc__
    assert "  14. the class API and events" in doc and "  18. the kernel table" in doc
    submitted = inspect.getsource(cs.submit_cpu_refs)
    assert "refs.submit(ref_lv_forward)" in submitted
    assert "refs.submit(ref_class_adjoint)" in submitted
    phase = inspect.getsource(cs.class_api_phase)
    for part in ("14(a)", "14(b)", "14(c) event", "14(c) hybrid", "14(c) sweep"):
        assert part in phase, part
    run = inspect.getsource(cs.run)
    assert "phase14 = class_api_phase(" in run
    assert "launches=(adams_launches[kind] + phase14.get(kind, 0)" in run
    golden = np.load(os.path.join(ROOT, "tests", "golden", "lv_forward.npz"))
    y0s, ps, tvals = lv_forward_inputs(20)
    np.testing.assert_array_equal(y0s[:16], golden["y0s"])
    np.testing.assert_array_equal(ps[:16], golden["ps"])
    np.testing.assert_array_equal(tvals, golden["tvals"])
    t_star, dt_dg, dt_dh = cs.ball_event_closed_forms()
    assert t_star == np.sqrt(2 * BALL_H / BALL_G) and dt_dg == -t_star / (2 * BALL_G)
    # the hybrid's closed forms against the port's CPU solve
    hybrid, (y0, p_sub, p_fix, tv) = build_ball_hybrid(3, derivatives=None, device="cpu")
    res = hybrid(0.0, y0, p_sub, p_fix, tv)
    f64 = dict(dtype=torch.float64)
    ts, yK = cs.hybrid_closed_form(torch.tensor(1.0, **f64), torch.tensor(9.81, **f64),
                                   torch.tensor(0.8, **f64), float(tv[-1]))
    np.testing.assert_allclose(res.event_ts.numpy(), ts.numpy(), atol=1e-8)
    np.testing.assert_allclose(res.ys[-1].numpy(), yK.numpy(), atol=1e-7)


def test_phase_15_bookkeeping():
    """Phase 15's static parts on the CPU: the counting log density adds each
    call's forward and backward attempts once its gradient has run, and
    refuses a call without one; the start's first rows are a narrow draw's;
    (b)'s run crosses the mass swap; (c)'s case on the CPU compiles the
    loss and its gradients through the port's wrapper, its outputs finite
    and shaped as the graph's."""
    import inspect

    from sunode_torch.entry import lv_nuts_init

    cs = _chip_smoke()

    class FakeSolve:
        last_stats = {"forward": None, "backward": None}

    solve = FakeSolve()

    def logp(theta):
        solve.last_stats = {"forward": {"n_attempts": 3}, "backward": solve.last_stats["backward"]}
        return theta.sum(dim=1)

    logp.solve = solve
    counting = cs.CountingLogp(logp)
    for n_bwd in (5, 7):
        counting(torch.zeros(2, 2))
        solve.last_stats["backward"] = {"n_attempts": n_bwd}
    assert counting.totals() == {"forward": 6, "transition": 12} and counting.calls == 2
    counting(torch.zeros(2, 2))
    with pytest.raises(SystemExit):
        counting.totals()
    wide = lv_nuts_init(cs.NUTS_CHAINS, *cs.NUTS_START)
    np.testing.assert_array_equal(wide[:cs.NUTS_CPU_CHAINS],
                                  lv_nuts_init(cs.NUTS_CPU_CHAINS, *cs.NUTS_START))
    assert int(0.75 * cs.NUTS_RUN["num_warmup"]) < cs.NUTS_RUN["num_warmup"]
    assert cs.NUTS_CHAINS == 512 and cs.NUTS_TREEDEPTH == 3  # 4, cut to 3 for phase 17
    assert "  15. the sampler path" in cs.__doc__
    submitted = inspect.getsource(cs.submit_cpu_refs)
    assert "refs.submit(ref_nuts_transition)" in submitted
    assert "refs.submit(ref_pytensor)" in submitted
    run = inspect.getsource(cs.run)
    assert "phase15 = sampler_phase(" in run and "+ phase15[kind]" in run
    res = cs.pytensor_case("adjoint", None, "cpu")
    loss, flat, *grads = res["out"]
    assert flat.shape == (len(cs.PYTENSOR_TVALS), 2) and len(grads) == 3
    assert all(np.isfinite(x).all() for x in res["out"]) and res["attempts"] > 0


@pytest.mark.parametrize("kind", ["sensitivity", "staged_sensitivity"])
def test_phase_9_emitted_f_against_the_core(kind):
    """Phase 9's plain f of a sensitivity build is read from the C it emits
    (C6); beside C6's bit-for-bit gates, that f is held to the f the Adams
    core composes from ``make_sensitivity_rhs`` within SENS_CORE_REL at
    every point an attempt evaluates it, here on phase 3c's draws at B=64
    on the CPU.  A wrong emitted row fails that gate."""
    from sunode_torch.entry import lv_problem
    from sunode_torch.symode import cuda_codegen

    cs = _chip_smoke()
    assert cs.SENS_CORE_REL == 1e-14
    ds = getattr(cuda_codegen, f"{kind}_system")(lv_problem())
    x = cs.history_inputs(ds, 64, 3, "cpu")
    fz, core = cs.lv_sens_fz(kind), cs.lv_sens_core_fz(kind)
    worst = cs.core_agreement(fz, core, ds.n, x, cs.P_MAX)
    assert 0.0 <= worst <= cs.SENS_CORE_REL
    points = cs.attempt_points(fz, ds.n, x, cs.P_MAX)
    assert len(points) == 5 and all(torch.isfinite(f).all() for _, f in points)

    def one_row_wrong(t, y, p):
        f = fz(t, y, p)
        return torch.cat([f[:-1], f[-1:] * (1 + 1e-12)])

    assert cs.core_agreement(one_row_wrong, core, ds.n, x, cs.P_MAX) > cs.SENS_CORE_REL


def test_phase_16_bookkeeping_and_the_cut():
    """Phase 16's static parts on the CPU: its gates and repetitions, the
    g++ builds first in the workers, its launches in the kernel line; the
    B=1 configurations' inputs (bench.py's lv_forward --batch 1 and lane 0
    of lv_adjoint.npz) through the native route, within their gates; the
    host's CPU line; the plain f of phase 9(a)'s builds read from the C they
    emit (ROADMAP C6), bit for bit that C compiled by g++ without
    contraction; and the cut that made room for the phase: phase 12's
    structured gradients (b), (d) and spgmr forward (e) over their first 2
    observation times, with 15(b) at tree depth 2."""
    import inspect

    from sunode_torch.entry import (LV_FORWARD_PARAMS, build_lv_adjoint_single,
                                    build_lv_forward_single, lv_problem)
    from sunode_torch.symode import cuda_codegen

    cs = _chip_smoke()
    assert (cs.NATIVE_REPS, cs.CARD_REPS, cs.SPLIT_REL) == (50, 2, 1e-12)
    assert cs.LV_FORWARD_SINGLE_GATE == (1e-6, 1e-8)
    assert cs.LV_ADJOINT_SINGLE_GATE == (2e-3, 1e-3)
    assert "  16. the native host route and the chain split" in cs.__doc__
    submitted = inspect.getsource(cs.submit_cpu_refs)
    assert submitted.index("refs.submit(ref_native_build)") < submitted.index(
        "refs.submit(ref_main_path)")
    run = inspect.getsource(cs.run)
    assert "phase16 = native_phase(" in run and "+ phase15[kind] + phase16[kind]" in run
    assert 'phase16["staged_adjoint"]' in run and "main_grads = (gy, gp)" in run
    phase = inspect.getsource(cs.native_phase)
    for part in ("16(a) card", "16(b) card", "16(c)", "make_mesh()", '"cuda:0", "cuda:0"'):
        assert part in phase, part
    built = cs.ref_native_build()
    assert built["core_s"] >= 0 and built["problem_s"] >= 0
    assert cs.host_cpu().endswith(f"{os.cpu_count()} threads")

    solve, (t0, tvals, y0) = build_lv_forward_single(device="cpu")
    assert LV_FORWARD_PARAMS == {"alpha": 1.0, "beta": 0.3, "gamma": 1.0, "delta": 0.4}
    np.testing.assert_array_equal(tvals, np.linspace(0.0, 10.0, 50))
    ys = solve()
    assert solve.solver._native_solver is not None and t0 == 0.0 and list(y0) == [10.0, 2.0]
    np.testing.assert_allclose(ys, solve.oracle(), rtol=cs.LV_FORWARD_SINGLE_GATE[0],
                               atol=cs.LV_FORWARD_SINGLE_GATE[1])
    golden = np.load(os.path.join(ROOT, "tests", "golden", "lv_adjoint.npz"))
    pair, (y0, p_sub, tvals) = build_lv_adjoint_single(device="cpu")
    np.testing.assert_array_equal(y0, golden["y0s"][0])
    np.testing.assert_array_equal(p_sub, golden["p_subs"][0])
    np.testing.assert_array_equal(tvals, golden["tvals"])
    _, gy, gp = pair()
    assert "native_ys" in pair.solver._last_forward
    rtol, atol = cs.LV_ADJOINT_SINGLE_GATE
    np.testing.assert_allclose(gy, golden["gy"][0], rtol=rtol, atol=atol)
    np.testing.assert_allclose(gp, golden["gp"][0], rtol=rtol, atol=atol)

    # C6: the plain f of phase 9(a)'s builds is their emitted C, statement by
    # statement: bit for bit the same source compiled by g++ without contraction
    import ctypes
    import subprocess
    import tempfile

    rng = np.random.default_rng(6)
    B = 64
    for kind in cs.SENS_KINDS:
        ds = getattr(cuda_codegen, f"{kind}_system")(lv_problem())
        src = ds.source.replace("__device__", "").replace("__forceinline__", "").replace(
            "#pragma once", "")
        src = src.replace("void pece_fz(", 'extern "C" void pece_fz(')
        with tempfile.TemporaryDirectory() as tmp:
            cpp, so = os.path.join(tmp, "fz.cpp"), os.path.join(tmp, "fz.so")
            with open(cpp, "w") as f:
                f.write(src)
            subprocess.run(["g++", "-O0", "-ffp-contract=off", "-shared", "-fPIC", "-o", so, cpp],
                           check=True)
            lib = ctypes.CDLL(so)
        dp = ctypes.POINTER(ctypes.c_double)
        t = rng.uniform(0, 10, B)
        y = rng.normal(size=(ds.n, B)) * 5
        par = rng.uniform(0.2, 2, (ds.n_p, B))
        want = np.zeros((ds.nz, B))
        for b in range(B):
            yb, pb, ob = (np.ascontiguousarray(a) for a in (y[:, b], par[:, b], np.zeros(ds.nz)))
            lib.pece_fz(ctypes.c_double(t[b]), yb.ctypes.data_as(dp), pb.ctypes.data_as(dp),
                        ob.ctypes.data_as(dp))
            want[:, b] = ob
        T = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
        got = cs.lv_sens_fz(kind)(T(t), T(y), T(par))
        assert torch.equal(got, T(want)), kind

    assert cs.NUTS_RUN["max_treedepth"] == 2
    from sunode_torch.entry import hub_inputs, kpp_inputs

    assert cs.STRUCT_LEADING_TIMES == 2
    for inputs, t_end in ((kpp_inputs, 0.05 + 0.95 / 7), (hub_inputs, 0.05 + 0.95 / 5)):
        t = cs.leading_tvals(inputs(8, 2)[2], "cpu")
        assert t.dtype == torch.float64 and t.shape == (2,)
        assert float(t[-1]) == pytest.approx(t_end) and t_end < 0.25
    for part in ("structured_grad", "leading=True"):
        assert part in inspect.getsource(cs.structured_phase), part
    assert "leading_tvals(tvals" in inspect.getsource(cs.ref_kpp_dense)
    assert "leading_tvals(tvals" in inspect.getsource(cs.ref_hub_dense)



def test_phase_17_bookkeeping():
    """Phase 17's static parts on the CPU: its constants and gates, the
    block shapes of 17(a) (phase 8's 'hermite' backward shape cut in two
    row blocks, the quadratures on the home block), the launches 17(b)
    expects of an attempt count, the entries' bytes by ``split_costs``'
    rule, the rows' count in every phase's counts, and its place in the
    script and the kernel line; phase 8 hands it the 'hermite' step's
    accepted steps."""
    import inspect

    from sunode_torch.parallel.rows import RowLayout

    cs = _chip_smoke()
    assert (cs.STATE_SPLIT_MODE, cs.STATE_SPLIT_B, cs.STATE_SPLIT_EXACT_TIMES) == ("hermite",
                                                                                  256, 2)
    assert (cs.STATE_SPLIT_RTOL, cs.STATE_SPLIT_ATOL, cs.STATE_SPLIT_PARTED) == (1e-10, 1e-12,
                                                                                 1e-8)
    assert (cs.STATE_SPLIT_MODE, cs.STATE_SPLIT_B) in cs.SIR_MODES
    _, n, nz = cs.split_system("staged_adjoint")
    cpu = torch.device("cpu")
    layout = RowLayout.contiguous((cpu, cpu), (n // 2, n - n // 2)).with_rows(nz - n)
    assert layout.sizes == (1502, 1500) and layout.state_rows(n) == (1500, 1500)
    split, rows = cs.rows_expected_launches(427, 2)
    assert split == {"predict": 854, "sweep": 0, "finish": 0}
    assert rows == {"sweep_rows": 3416, "finish_rows": 854, "finish_lanes": 427}
    assert "sweep_decide" not in cs.ROWS_KERNELS
    costs = cs.rows_costs(11, 1502, 1500, 256, 13)
    assert set(costs) == set(cs.ROWS_KERNELS) and all(b > 0 and f > 0 for b, f in costs.values())
    assert costs["finish_rows"][0] > 2 * 8 * 11 * 1502 * 256  # the history in and out
    # the rows' sweep: f and five state-row fields, 2 x 16 ranks' partials read, 16 written
    rows_only = 8 * 1502 * 256 + 5 * 8 * 1500 * 256
    assert costs["sweep_rows"][0] - rows_only == 256 * (8 + 2 * 15 + 9 * 32 + 9 * 16)
    assert costs["finish_lanes"][0] < 512 * 256  # lanes only, the partials with them
    count = cs.RowsLaunches()
    count.launches = 3
    assert count.launches == 9
    count.launches = 0
    assert "  17. the state axis" in cs.__doc__ and "  18. the kernel table" in cs.__doc__
    run = inspect.getsource(cs.run)
    for part in ("state_split_kernels(smi", "phase17 = state_split_phase(",
                 "split_launches[stage] + phase17.get(stage, 0)", "RowsLaunches(), split_count)",
                 "split_launches, sir_hermite = sir_phase("):
        assert part in run, part
    assert "fwd_steps" in inspect.getsource(cs.sir_phase)
    assert cs.STATE_SPLIT_EXACT_LANES == 64 and cs.STATE_SPLIT_B % cs.STATE_SPLIT_EXACT_LANES == 0
    phase = inspect.getsource(cs.state_split_phase)
    for part in ('Mesh(((dev, dev),), ("chains", "state"))', "build_sir_state_split",
                 "STATE_SPLIT_EXACT_TIMES", "sir_1000.npz", "plain stage"):
        assert part in phase, part
