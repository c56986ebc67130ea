"""The port's Adams step-size factors differ from the reference's only where
torch's ``pow`` and XLA's round differently.

Both packages spell the factor ``0.9 * clip(e, 1e-30, 1e30) ** (-1 / (q + 1))``
op for op (``sunode_torch/ops/adams_batched.py``, ``fac``;
``sunode_tpu/ops/adams_batched.py``, ``fac``).  On 100,000 seeded error norms
and orders this test holds that torch's, numpy's and XLA's ``pow`` differ at
the last ulp only, and that every lane where the two factors differ is a lane
where the bare ``pow`` calls differ: the expression adds nothing.  Run as a
script to print the counts:

    JAX_PLATFORMS=cpu python tests/test_torch_pow_ulp.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

jax.config.update("jax_enable_x64", True)

N = 100_000


def _ulps(a, b):
    return np.abs(a.view(np.int64) - b.view(np.int64))


def _evaluate():
    rng = np.random.default_rng(0)
    e = 10.0 ** rng.uniform(-12, 2, N)  # error norms the controller sees
    q = rng.integers(0, 13, N).astype(np.float64)  # orders p - 1, p, p + 1
    x = -1.0 / (q + 1.0)
    pw = {
        "torch": torch.pow(torch.as_tensor(e), torch.as_tensor(x)).numpy(),
        "numpy": np.power(e, x),
        "jax": np.asarray(jnp.power(jnp.asarray(e), jnp.asarray(x))),
    }
    e_t, q_t = torch.as_tensor(e), torch.as_tensor(q)
    fac_torch = (0.9 * torch.clamp(e_t, 1e-30, 1e30) ** (-1.0 / (q_t + 1.0))).numpy()
    fac_jax = np.asarray(
        jax.jit(lambda e, q: 0.9 * jnp.clip(e, 1e-30, 1e30) ** (-1.0 / (q + 1.0)))(e, q)
    )
    return pw, fac_torch, fac_jax


def test_pow_differs_by_at_most_one_ulp():
    pw, _, _ = _evaluate()
    # each library's pow is within one ulp of the exact value
    for a, b in (("torch", "jax"), ("numpy", "jax"), ("torch", "numpy")):
        assert _ulps(pw[a], pw[b]).max() <= 2, (a, b)


def test_factor_differs_only_where_pow_does():
    pw, fac_torch, fac_jax = _evaluate()
    fac_differs = fac_torch != fac_jax
    assert not np.any(fac_differs & (pw["torch"] == pw["jax"]))
    # two ulps of pow times 0.9, rounded, can land three ulps apart
    assert _ulps(fac_torch, fac_jax).max() <= 3


if __name__ == "__main__":
    pw, fac_torch, fac_jax = _evaluate()
    for a, b in (("torch", "jax"), ("numpy", "jax"), ("torch", "numpy")):
        print(f"pow {a} != {b}: {int(np.sum(pw[a] != pw[b]))} of {N}, "
              f"max {int(_ulps(pw[a], pw[b]).max())} ulp")
    differs = fac_torch != fac_jax
    print(f"fac torch != jax: {int(differs.sum())} of {N}, "
          f"{int(np.sum(differs & (pw['torch'] != pw['jax'])))} of them where pow differs, "
          f"max {int(_ulps(fac_torch, fac_jax).max())} ulp")
