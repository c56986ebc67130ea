"""The chain axis split over devices (``sunode_torch.parallel.mesh``) on a
mesh of four CPU devices: the counterparts of ``tests/test_sir.py``'s
sharded SIR gradient and ``tests/test_nuts_sharded.py``'s sharded NUTS run,
and of ``__graft_entry__.dryrun_multichip``'s sharded Lotka-Volterra step.

Lanes of the batched cores are independent, so a split batch gives each
lane's result bit for bit where a lane's arithmetic does not depend on the
batch's width: the Lotka-Volterra runs equal their unsplit runs exactly;
SIR's 48 states do not (``test_sir_adjoint_sharded_equals_unsplit``).
Torch runs on one thread while each test runs."""

import numpy as np
import pytest
import torch

from sunode_torch.parallel.mesh import (CHAINS_AXIS, Mesh, make_mesh, map_over_chains,
                                        shard_over_chains)

CPU4 = Mesh((torch.device("cpu"),) * 4, (CHAINS_AXIS,))
CPU2 = Mesh(("cpu", "cpu"))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mesh_and_shard():
    assert CPU4.size == 4 and CPU4.axis_names == ("chains",)
    x = np.arange(16.0).reshape(8, 2)
    parts = shard_over_chains(CPU4, {"x": x, "pair": (torch.ones(8), torch.zeros(4, 3))})
    assert len(parts) == 4
    for d, part in enumerate(parts):
        assert torch.equal(part["x"], torch.as_tensor(x[2 * d: 2 * d + 2]))
        assert part["pair"][0].shape == (2,) and part["pair"][1].shape == (1, 3)
    with pytest.raises(ValueError, match="does not divide evenly"):
        shard_over_chains(CPU4, np.zeros((10, 2)))
    with pytest.raises(ValueError, match="axes"):
        shard_over_chains(CPU4, x, axis_name="state")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_map_over_chains_gathers_and_differentiates():
    """Results concatenate on the first device in chain order, per-device
    functions see their own chunks, and gradients reach the unsplit
    inputs."""
    x = torch.linspace(0.0, 1.0, 8, dtype=torch.float64, requires_grad=True)
    seen = []

    def fn(chunk, scale):
        seen.append(chunk.shape[0])
        return {"y": scale * chunk**2, "n": (chunk.sum(),)}

    out = map_over_chains(fn, CPU4, chain_argnums=(0,))(x, torch.tensor(3.0))
    assert seen == [2, 2, 2, 2] and out["n"][0].shape == (4,)
    (g,) = torch.autograd.grad(out["y"].sum(), x)
    assert torch.equal(out["y"], 3.0 * x.detach() ** 2) and torch.equal(g, 6.0 * x.detach())
    with pytest.raises(ValueError, match="functions"):
        map_over_chains([fn, fn], CPU4)


@pytest.mark.parametrize("mesh, batch, tvals_n", [(CPU4, 8, 3), (CPU2, 4, 3)])
def test_lv_adjoint_sharded_equals_unsplit(mesh, batch, tvals_n):
    """``build_lv_adjoint_sharded`` at B=8 over four devices and at B=4
    over two, a thread a device, over 3 observation times: each lane's
    gradient equals the unsplit step's bit for bit, and the chunks'
    attempts are each at most the unsplit solve's."""
    from sunode_torch.entry import build_lv_adjoint, build_lv_adjoint_sharded

    step, (y0s, p_subs) = build_lv_adjoint(batch, tvals_n, 1e-6, device="cpu")
    gy, gp = step(y0s, p_subs)
    split, (y0s2, p_subs2) = build_lv_adjoint_sharded(batch, mesh, tvals_n=tvals_n, rtol=1e-6)
    assert torch.equal(y0s, y0s2) and torch.equal(p_subs, p_subs2)
    gy2, gp2 = split(y0s2, p_subs2)
    assert torch.equal(gy, gy2) and torch.equal(gp, gp2)
    whole = step.solve.last_stats["forward"]["n_attempts"]
    chunks = [s.last_stats["forward"]["n_attempts"] for s in split.solves]
    assert len(chunks) == mesh.size and max(chunks) <= whole
    with pytest.raises(ValueError, match="divide evenly"):
        build_lv_adjoint_sharded(10, CPU4)


def _sir_inputs(n_regions=16, batch=16, seed=0):
    """``tests/test_sir.py::_inputs``."""
    rng = np.random.default_rng(seed)
    S0 = 0.99 + 0.005 * rng.standard_normal((batch, n_regions))
    I0 = 0.01 * np.abs(1 + 0.1 * rng.standard_normal((batch, n_regions)))
    y0 = np.concatenate([S0, I0, np.zeros((batch, n_regions))], axis=1)
    psub = np.stack([0.4 * (1 + 0.05 * rng.standard_normal(batch)),
                     0.15 * (1 + 0.05 * rng.standard_normal(batch))], axis=1)
    return torch.as_tensor(y0), torch.as_tensor(psub)


def test_sir_adjoint_sharded_equals_unsplit():
    """``tests/test_sir.py::test_sir_sharded_over_mesh`` (R=16, B=16, ADAMS,
    rtol 1e-6 / atol 1e-8, 512 checkpoints, 8 times on [5, 60]) split over
    four devices: finite, and within 1e-12 of the unsplit gradient.  It
    is not bit for bit the unsplit one: torch's CPU reduction over the state
    axis of an (n, B) tensor (the error norms over SIR's 48 states) sums in
    an order that depends on B, so a lane's norms round differently at
    another batch width (Lotka-Volterra's two states sum exactly)."""
    from sunode_torch.entry import sir_problem
    from sunode_torch.ops.bdf import BDFOptions
    from sunode_torch.wrappers.as_torch import make_batched_solve_fn

    opts = BDFOptions(rtol=1e-6, atol=1e-8)
    sir = sir_problem(16)
    solves = [make_batched_solve_fn(sir, derivatives="adjoint", options=opts,
                                    adjoint_options=opts, checkpoint_n=512, method="ADAMS")
              for _ in range(1 + CPU4.size)]
    tvals = torch.linspace(5.0, 60.0, 8, dtype=torch.float64)
    p_fix = torch.tensor([0.05], dtype=torch.float64)
    y0, psub = _sir_inputs()

    def grad(solve_fn, y=y0, p=psub):
        p = p.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(solve_fn(y, p) ** 2), p)
        return g

    whole = grad(lambda y, p: solves[0](0.0, y, p, p_fix, tvals))
    fns = [lambda y, p, s=s: s(0.0, y, p, p_fix, tvals) for s in solves[1:]]
    split = grad(map_over_chains(fns, CPU4))
    assert torch.isfinite(split).all() and (split != 0).all()
    torch.testing.assert_close(split, whole, rtol=1e-12, atol=0)
    x = torch.randn(48, 16, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    narrow = torch.cat([x[:, 4 * d: 4 * d + 4].pow(2).sum(dim=0) for d in range(4)])
    assert not torch.equal(x.pow(2).sum(dim=0), narrow)  # the width-dependent order
    assert torch.equal(x[:2].pow(2).sum(dim=0), torch.cat([x[:2, 4 * d: 4 * d + 4].pow(2)
                                                           .sum(dim=0) for d in range(4)]))


def test_nuts_with_sharded_logp_takes_the_same_draws():
    """``tests/test_nuts_sharded.py``'s posterior (LV, the ADAMS transition
    adjoint, sigma 0.1) with C=8 chains, 2 + 2 draws (the mass swap at the
    second warmup draw) at max_treedepth 3: the
    log density solved through ``map_over_chains`` on two devices takes the
    same draws as the unsplit one: samples, step size, tree depths,
    divergences and mass equal.  The log densities and acceptance
    probabilities agree to 1e-12, not bit for bit: the unsplit solve returns ``ys`` as a permuted
    view and the gather a contiguous tensor, so the log density's sum over
    times and states reduces in another order.  Cut to 3 times on [0.5, 2]
    at rtol 1e-4 and 200 / 400 steps (the reference's 5 on [1, 6] at 1e-6):
    each device's chunk runs every attempt of the host loop, so a split
    gradient costs about as many unsplit ones as the mesh has devices."""
    from sunode_torch.entry import lv_problem
    from sunode_torch.ops.bdf import BDFOptions
    from sunode_torch.sample import nuts_sample
    from sunode_torch.wrappers.as_torch import make_batched_solve_fn

    # a step budget, as build_lv_nuts's: a far-flung warmup proposal fails
    # fast (NaN, a rejection) instead of making every chain pay for its solve
    opts = BDFOptions(rtol=1e-4, atol=1e-4, max_steps=200)
    prob = lv_problem()
    solves = [make_batched_solve_fn(prob, derivatives="adjoint", options=opts,
                                    adjoint_options=opts._replace(max_steps=400),
                                    method="ADAMS", adjoint_interpolation="transition")
              for _ in range(1 + CPU2.size)]
    f64 = dict(dtype=torch.float64)
    p_fix, tvals = torch.tensor([1.0, 0.4], **f64), torch.linspace(0.5, 2.0, 3, **f64)
    C = 8
    y0s = torch.tensor([10.0, 2.0], **f64).expand(C, 2).contiguous()
    mu0 = torch.log(torch.tensor([1.0, 0.3], **f64))
    obs_log = torch.log(torch.clamp_min(solves[0](0.0, y0s[:1], torch.exp(mu0)[None], p_fix,
                                                  tvals)[0], 1e-10)).detach()

    def make_logp(solve_ys):
        def logp(theta):
            ys = torch.clamp_min(solve_ys(y0s, torch.exp(theta)), 1e-10)
            ll = -0.5 * torch.sum((torch.log(ys) - obs_log[None]) ** 2 / 0.1**2, dim=(1, 2))
            lp = ll - 0.5 * torch.sum((theta - mu0) ** 2, dim=1)
            return torch.where(torch.isfinite(lp), lp, -torch.inf)

        return logp

    whole = make_logp(lambda y, p: solves[0](0.0, y, p, p_fix, tvals))
    split = make_logp(map_over_chains([lambda y, p, s=s: s(0.0, y, p, p_fix, tvals)
                                       for s in solves[1:]], CPU2))
    init = mu0[None, :] + 0.1 * torch.as_tensor(np.random.default_rng(0).standard_normal((C, 2)))
    run = dict(num_warmup=2, num_samples=2, max_treedepth=3)
    a = nuts_sample(whole, 0, init, **run)
    b = nuts_sample(split, 0, init, **run)
    assert torch.isfinite(b.samples).all() and tuple(b.samples.shape) == (C, 2, 2)
    assert torch.equal(a.samples, b.samples)
    assert a.step_size == b.step_size and torch.equal(a.inv_mass, b.inv_mass)
    for field in ("tree_depth", "diverging"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field
    for field in ("logp", "accept_prob"):
        torch.testing.assert_close(getattr(b, field), getattr(a, field), rtol=1e-12, atol=0)
