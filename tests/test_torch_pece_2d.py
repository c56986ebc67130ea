"""sunode_torch's flat-history PECE attempt (ops/pece_2d.py) and its A/B
experiment against scripts/exp_pallas2d.py and the JAX reference.

The plain version is what CPU tensors run; the CUDA kernel is held to it on
the card by tests/test_torch_cuda.py and chip_smoke.py."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunode_tpu.ops.pallas_step import adams_pece_attempt_reference as jax_reference
from sunode_torch.convert import df_pairs_to_f64
from sunode_torch.experiments import exp_pece2d
from sunode_torch.ops.pece_2d import P_ORDER, pece_2d_attempt, pece_2d_reference
from sunode_torch.ops.pece_step import adams_pece_attempt

B = 128
SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scripts", "exp_pallas2d.py")


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("exp_pallas2d", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(B=B, seed=0):
    return exp_pece2d.make_inputs(B, "cpu", seed)


def _split(x):
    hi = np.float32(x)
    return hi, np.float32(np.asarray(x, np.float64) - hi.astype(np.float64))


def test_script_shapes_match_the_experiment(script):
    assert (script.K, script.N, script.P, script.B) == (
        exp_pece2d.K, exp_pece2d.N, P_ORDER, exp_pece2d.B_SCRIPT
    )


def test_plain_matches_jax_reference(script):
    x = _inputs()
    y, d_f, err = pece_2d_reference(x["DF2"], x["y_prev"], x["h"], x["t"], x["params"])
    DF64 = x["DF2"].numpy().reshape(exp_pece2d.K, exp_pece2d.N, B)
    y_ref, d_ref, e_ref = jax_reference(
        script.lv_rhs_f64, 0.0, DF64, x["y_prev"].numpy(), x["h"][0].numpy(), P_ORDER
    )
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-12)
    np.testing.assert_allclose(d_f.numpy(), np.asarray(d_ref), rtol=1e-12)
    np.testing.assert_allclose(err.numpy(), np.asarray(e_ref), rtol=1e-12)


def test_plain_matches_pallas_kernel_interpret(script, monkeypatch):
    monkeypatch.setattr(script, "B", B)  # the kernel's out_shape reads the global
    x = _inputs(seed=1)
    dfh, dfl = _split(x["DF2"].numpy())
    yh, yl = _split(x["y_prev"].numpy())
    hh, hl = _split(x["h"].numpy())
    th, _ = _split(x["t"].numpy())
    y_hi, y_lo, d_hi, d_lo, e_hi, e_lo = script.pece_2d_pallas(
        jnp.asarray(th), *map(jnp.asarray, (dfh, dfl, yh, yl, hh, hl)), interpret=True
    )
    # the kernel's inputs are the f32 pairs: hand the port the same values
    as64 = lambda hi, lo: df_pairs_to_f64(hi, lo, device="cpu")  # noqa: E731
    y, d_f, err = pece_2d_attempt(
        as64(dfh, dfl), as64(yh, yl), as64(hh, hl), x["t"], x["params"]
    )
    got = lambda hi, lo: as64(np.asarray(hi), np.asarray(lo)).numpy()  # noqa: E731
    # interpret mode contracts FP expressions: the bounds of test_pallas_step
    y_rel = np.abs(got(y_hi, y_lo) - y.numpy()) / np.abs(y.numpy())
    assert y_rel.max() < 1e-7, f"max rel err {y_rel.max():.2e}"
    for (hi, lo), ref in (((d_hi, d_lo), d_f), ((e_hi, e_lo), err)):
        ref = ref.numpy()
        assert (np.abs(got(hi, lo) - ref) / np.abs(ref).max()).max() < 1e-6


def test_plain_matches_kernel1_plain_fixed_mode():
    x = _inputs(seed=2)
    fns = exp_pece2d.arms(x)
    before = adams_pece_attempt.launches, pece_2d_attempt.launches
    got = fns["kernel2"](x["y_prev"])
    ref = fns["kernel1"](x["y_prev"])  # the padded 8-row history, p = 6 in every lane
    assert (adams_pece_attempt.launches, pece_2d_attempt.launches) == before
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)


def test_experiment_runs_on_cpu():
    lines = []
    rows = exp_pece2d.run([64, 200], device="cpu", log=lines.append)
    assert [(r["B"], r["arm"]) for r in rows] == [
        (b, arm) for b in (64, 200) for arm in ("plain", "kernel1", "kernel2")
    ]
    assert len(lines) == len(rows)
    for r in rows:
        assert not {"graph_us", "stream_us", "device_us"} & set(r)  # no time on the CPU
        if r["arm"] == "kernel2":
            assert r["rel_vs_plain"] <= 1e-12 and r["rel_vs_kernel1"] <= 1e-12


def _bad(x, **change):
    args = dict(DF2=x["DF2"], y_prev=x["y_prev"], h=x["h"], t_new=x["t"], params=x["params"])
    args.update(change)
    return args


@pytest.mark.parametrize(
    "change, match",
    [
        (lambda x: dict(DF2=x["DF2"].t().contiguous().t()), "DF2"),
        (lambda x: dict(DF2=x["DF2"][:-1]), "whole blocks"),
        (lambda x: dict(DF2=x["DF2"][: 2 * (P_ORDER - 1)]), "fewer than p"),
        (lambda x: dict(DF2=x["DF2"][None]), "2-D"),
        (lambda x: dict(h=x["h"][0]), "h"),
        (lambda x: dict(y_prev=x["y_prev"].float()), "y_prev"),
        (lambda x: dict(params=x["params"][:3]), "params"),
    ],
    ids=["non-contiguous", "ragged", "shallow", "3-D", "h-shape", "f32", "params"],
)
def test_wrapper_refuses_bad_inputs(change, match):
    x = _inputs(B=8)
    with pytest.raises(ValueError, match=match):
        pece_2d_attempt(**_bad(x, **change(x)))


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    x = _inputs(B=8)
    before = pece_2d_attempt.launches
    out = pece_2d_attempt(**_bad(x))
    ref = pece_2d_reference(x["DF2"], x["y_prev"], x["h"], x["t"], x["params"])
    assert pece_2d_attempt.launches == before
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    meta = {k: v.to("meta") for k, v in _bad(x).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        pece_2d_attempt(**meta)


def test_df_pairs_to_f64_is_exact_and_checks_its_operands():
    x = np.random.default_rng(3).standard_normal(50)
    hi, lo = _split(x)
    back = df_pairs_to_f64(hi, lo, device="cpu").numpy()
    assert np.all(np.abs(back - x) <= 2.0**-46 * np.abs(x))
    with pytest.raises(ValueError):
        df_pairs_to_f64(hi, lo[:-1], device="cpu")
    with pytest.raises(ValueError):
        df_pairs_to_f64(x, lo, device="cpu")
