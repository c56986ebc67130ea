"""The state split's attempt (``adams_split_attempt_rows``) with its row
blocks on more than one device: each device keeps its own copy of the
corrector's state, written by that device's first block from every block's
partials of the sweep before (copied to each device), and the lanes' finish
reads the home device's copy.

On the CPU a second device is ``cpu:0``: a device of its own to the route
(its own copy of the state, its own writer), the same memory to torch.  The
``cuda`` case puts blocks on the card and on the CPU.  Every block's rows'
sweep is logged: the state it was given, whether the route asked it to
write the decided state, and the state it decided.  After every sweep each
device's decided state is bit for bit the home device's, and the attempt is
the same blocks' attempt on one device.  Torch runs on one thread while
each test runs."""

import numpy as np
import pytest
import torch

from sunode_torch.entry import sir_problem
from sunode_torch.ops import adams_split as sp
from sunode_torch.ops.adams import _GAMMA_STAR, FUNCTIONAL_MAXITER
from sunode_torch.ops.pece_step import PeceSystem
from sunode_torch.parallel.rows import RowLayout, scatter

R = 16  # SIR regions: 48 state rows, and 2 quadrature rows after them
CPU = torch.device("cpu")
CPU0 = torch.device("cpu", 0)  # a second device to the route, the same memory to torch
CUDA = torch.device("cuda", 0)
ROW_FIELDS = ("DF_resc", "DF_upd", "z_pred", "z_new", "err0")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _attempt(nz, n, seed, B=7):
    """One attempt's seeded arguments (history depth 11, orders 1..8, 90%
    of the lanes active) and its right-hand side: SIR's, its first two
    rows' products as the quadrature's."""
    rng = np.random.default_rng(seed)
    T = torch.as_tensor
    DF = rng.standard_normal((11, nz, B)) * (0.5 ** np.arange(11))[:, None, None]
    rhs = sir_problem(R).make_rhs()

    def fz(t, y, par):
        f = rhs(t, y, par)
        return torch.cat([f, f[:2] * f[2:4]])

    x = dict(
        t_new=T(rng.uniform(0, 10, B)), h_use=T(10.0 ** rng.uniform(-4, -1, B)),
        pre_factor=T(np.exp(rng.uniform(np.log(0.2), np.log(2.0), B))),
        p=T(rng.integers(1, 9, B).astype(np.int32)), active=T(rng.uniform(size=B) < 0.9),
        DF=T(DF), z_prev=T(1.0 + rng.uniform(0.2, 1.0, (nz, B))),
        params=T(np.array([0.4, 0.15, 0.05])[:, None] * (1 + 0.05 * rng.standard_normal((3, B)))),
        atol_z=torch.full((nz,), 1e-8, dtype=torch.float64),
        rtol_z=torch.full((nz,), 1e-7, dtype=torch.float64),
        v_err=T(np.r_[np.full(n, 0.5 / n), np.full(nz - n, 0.5 / (nz - n))]),
    )
    return PeceSystem(fz=fz, n=n, nz=nz), x


class _Logged:
    """A block's stages whose rows' sweep always decides (so that every
    block's decision can be held to the others'), logs (block, the state it
    was given, whether the route asked for the decided state, the decided
    state), and hands the route None where it did not ask, as the kernel
    does."""

    def __init__(self, stages, block, log):
        self._stages, self._block, self._log = stages, block, log

    def __getattr__(self, name):
        return getattr(self._stages, name)

    def sweep_rows(self, fz_k, y_it, pred, state, n, pending=None, rows=None, decide=True):
        out, new = self._stages.sweep_rows(fz_k, y_it, pred, state, n, pending, rows=rows,
                                           decide=True)
        self._log.append((self._block, state, decide, new))
        return out, new if decide else None


def _run(devices, system, x, monkeypatch=None, log=None):
    """The attempt on ``len(devices)`` contiguous blocks of the state rows
    (the quadrature's on the home block), every lane argument on the home
    device; with ``log``, every block's stages logged."""
    n, home = system.n, devices[0]
    blocks = len(devices)
    sizes = [n // blocks] * (blocks - 1) + [n - n // blocks * (blocks - 1)]
    L = RowLayout.contiguous(devices, sizes).with_rows(system.nz - n)
    if log is not None:
        made = []
        stages_on = sp._stages_on

        def logged(t, P_MAX, kab):
            made.append(_Logged(stages_on(t, P_MAX, kab), len(made), log))
            return made[-1]

        monkeypatch.setattr(sp, "_stages_on", logged)
    h = {k: v.to(home) for k, v in x.items()}

    def col(v):
        return scatter(L, v[:, None])

    out = sp.adams_split_attempt_rows(
        system, h["t_new"], h["h_use"], h["pre_factor"], h["p"], h["active"],
        scatter(L, h["DF"]), scatter(L, h["z_prev"]), h["params"], col(h["atol_z"]),
        col(h["rtol_z"]), torch.as_tensor(np.abs(_GAMMA_STAR), device=home), col(h["v_err"]),
        3e-4, FUNCTIONAL_MAXITER, 8)
    if log is not None:
        monkeypatch.undo()
    return L, out


def _bits(a, b):
    """Bit for bit on the CPU, a NaN equal to a NaN."""
    a, b = a.cpu(), b.cpu()
    if not a.is_floating_point():
        return torch.equal(a, b)
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("devices", [
    (CPU, CPU0), (CPU, CPU0, CPU, CPU0),
    pytest.param((CUDA, CPU, CUDA), marks=pytest.mark.cuda, id="cuda-cpu-cuda"),
], ids=lambda d: "-".join(str(x) for x in d))
def test_each_device_decides_the_same_state(devices, monkeypatch):
    """Every sweep: the first block on each device (only it) is asked for
    the decided state; every block is given its device's copy, bit for bit
    the home device's; every block's decision is bit for bit the home
    block's.  The attempt: bit for bit the same blocks on the home device
    alone (on the CPU); with blocks on the card and the CPU, its rows bit
    for bit the card's alone and err3 within 1e-14 (the CPU block's plain
    sums add its rows in another order than the kernel's)."""
    if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    system, x = _attempt(3 * R + 2, 3 * R, 41)
    log = []
    L, got = _run(devices, system, x, monkeypatch, log)
    nb = len(devices)
    first = [devices.index(d) == i for i, d in enumerate(devices)]
    assert len(log) == FUNCTIONAL_MAXITER * nb
    for k in range(FUNCTIONAL_MAXITER):
        sweep = sorted(log[k * nb:(k + 1) * nb], key=lambda e: e[0])
        assert [e[0] for e in sweep] == list(range(nb))
        assert [e[2] for e in sweep] == first
        for block, state, _, new in sweep:
            assert state.conv.device.type == devices[block].type
            assert all(_bits(a, b) for a, b in zip(state, sweep[0][1]))
            assert all(_bits(a, b) for a, b in zip(new, sweep[0][3]))
    _, ref = _run((devices[0],) * nb, system, x)
    assert torch.equal(got.conv, ref.conv) and torch.equal(got.niter, ref.niter)
    for name in ROW_FIELDS:
        assert _bits(getattr(got, name).gather(), getattr(ref, name).gather())
    if devices[0].type == "cpu":
        assert _bits(got.err3, ref.err3)
    else:
        np.testing.assert_allclose(got.err3.cpu().numpy(), ref.err3.cpu().numpy(),
                                   rtol=1e-14, atol=0)
