"""sunode_torch.ParamSpec against sunode_tpu.ParamSpec: same layout, and
the same flatten / combine / subset results on tensors."""

import numpy as np
import pytest
import torch

from sunode_tpu.paramspec import ParamSpec as JaxParamSpec
from sunode_torch import ParamSpec

SPEC = {"rates": {"alpha": (), "beta": (2,)}, "init": ("region",), "k": (2, 3)}
COORDS = {"region": ["north", "south", "east"]}
SUBSET = [("rates",), ("k",)]


@pytest.fixture(scope="module")
def specs():
    return (
        JaxParamSpec(SPEC, SUBSET, coords=COORDS),
        ParamSpec(SPEC, SUBSET, coords=COORDS),
    )


@pytest.mark.parametrize(
    "attr",
    ["paths", "shapes", "slices", "n_items", "subset_paths", "subset_indices",
     "subset_n_items", "remainder_indices", "subset_slices"],
)
def test_layout_matches_jax(specs, attr):
    js, ts = specs
    want, got = getattr(js, attr), getattr(ts, attr)
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_dims_and_structured_dtype_match_jax(specs):
    js, ts = specs
    for path in js.paths:
        assert ts.dims_for(path) == js.dims_for(path)
    assert ts.as_numpy_dtype() == js.as_numpy_dtype()


def test_flatten_unflatten_and_combine_match_jax(specs):
    js, ts = specs
    rng = np.random.default_rng(0)
    nested = {
        "rates": {"alpha": 0.5, "beta": rng.standard_normal(2)},
        "init": rng.standard_normal(3),
        "k": rng.standard_normal((2, 3)),
    }
    flat_j = js.flatten_dict(nested)
    flat_t = ts.flatten_dict(nested)
    assert flat_t.dtype == torch.float64
    np.testing.assert_array_equal(flat_t.numpy(), flat_j)
    back = ts.unflatten(flat_t)
    np.testing.assert_array_equal(back["k"].numpy(), nested["k"])

    sub = rng.standard_normal((5, ts.subset_n_items))
    rem = rng.standard_normal((5, ts.n_items - ts.subset_n_items))
    full_t = ts.combine(torch.as_tensor(sub), torch.as_tensor(rem))
    np.testing.assert_array_equal(full_t.numpy(), js.combine(sub, rem))
    np.testing.assert_array_equal(ts.take_subset(full_t).numpy(), sub)
    np.testing.assert_array_equal(ts.take_remainder(full_t).numpy(), rem)
    # float32 inputs stay float32; autograd flows through the scatter
    sub32 = torch.as_tensor(sub, dtype=torch.float32).requires_grad_()
    out32 = ts.combine(sub32, torch.as_tensor(rem, dtype=torch.float32))
    assert out32.dtype == torch.float32
    out32.sum().backward()
    assert torch.equal(sub32.grad, torch.ones_like(sub32))


def test_record_views(specs):
    _, ts = specs
    vec = torch.arange(ts.n_items, dtype=torch.float64)
    rec = ts.record(vec)
    assert float(rec.rates.alpha) == 0.0
    assert tuple(rec.k.shape) == (2, 3)
    with pytest.raises(KeyError):
        ts.flatten_dict({"rates": {"alpha": 1.0}})


def test_subset_remainder_and_coercion_match_jax(specs):
    js, ts = specs
    rng = np.random.default_rng(1)
    subset = {"rates": {"alpha": 0.25, "beta": rng.standard_normal(2)},
              "k": rng.standard_normal((2, 3))}
    sub_t = ts.flatten_subset_dict(subset)
    np.testing.assert_array_equal(sub_t.numpy(), js.flatten_subset_dict(subset))
    np.testing.assert_array_equal(ts.unflatten_subset(sub_t)["k"].numpy(), subset["k"])
    assert ts.remainder.paths == js.remainder.paths == [("init",)]

    structured = np.zeros((4,), dtype=ts.as_numpy_dtype())
    structured["k"] = rng.standard_normal((4, 2, 3))
    np.testing.assert_array_equal(
        ts.flatten_structured(structured), js.flatten_structured(structured)
    )
    np.testing.assert_array_equal(
        ts.coerce_flat(structured).numpy(), js.coerce_flat(structured)
    )
    flat = rng.standard_normal(ts.n_items)
    np.testing.assert_array_equal(ts.coerce_flat(flat).numpy(), flat)
    with pytest.raises(ValueError):
        ts.coerce_flat(np.zeros(ts.n_items + 1))


def test_problem_spec_plumbing_matches_jax():
    from sunode_tpu.symode import SympyProblem as JaxSympyProblem
    from sunode_torch import SympyProblem

    spec = dict(
        params={"alpha": (), "beta": (), "gamma": (), "delta": ()},
        states={"hares": (), "lynx": ()},
        rhs_sympy=lambda t, y, p: {"hares": p.alpha * y.hares, "lynx": -p.gamma * y.lynx},
        derivative_params=[("alpha",), ("beta",)],
    )
    jp, tp = JaxSympyProblem(**spec), SympyProblem(**spec)
    assert (tp.n_states, tp.n_params, tp.n_all_params) == (jp.n_states, jp.n_params, jp.n_all_params)
    assert tp.state_dtype == jp.state_dtype and tp.params_dtype == jp.params_dtype
    state = {"hares": 10.0, "lynx": 2.0}
    params = {"alpha": 1.0, "beta": 0.3, "gamma": 1.0, "delta": 0.4}
    np.testing.assert_array_equal(tp.flatten_state(state).numpy(), np.asarray(jp.flatten_state(state)))
    np.testing.assert_array_equal(tp.flatten_params(params).numpy(), np.asarray(jp.flatten_params(params)))
