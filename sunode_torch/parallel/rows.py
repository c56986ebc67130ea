"""Row blocks: one chain group's state rows kept on several devices.

The counterpart of what XLA's partitioner inserts for the reference's state
axis (``sunode_tpu/parallel/mesh.py``: ``P("chains", "state")``): every
array of a solve with a state-row axis -- the history ``DF (KAB, nz, B)``,
the state, the tolerances and weights, the recording's rows, the
observations -- is kept as one block of rows a device, and what needs the
whole state (the right-hand side, each lane's norms) goes through the home
device, the first of the group's devices.

  * :class:`RowLayout` -- which rows of the ``N``-row vector each block
    holds, in its own order (the state rows before any quadrature row), and
    on which device;
  * :class:`RowBlocks` -- the blocks of one array, its rows on the
    second-to-last axis (the lane axis is last everywhere);
  * :func:`scatter`, :meth:`RowBlocks.gather` -- the copies between a whole
    array on the home device and its blocks;
  * :func:`lane_sum`, :func:`lane_all`, :func:`lane_any` -- each lane's
    partial sums (or flags) of the blocks added (or ANDed, ORed) on the home
    device in block order, so that the result does not depend on the
    devices' schedule; :meth:`RowLayout.share` -- every block's partials on
    every block's device, where each adds them itself.

``traffic`` counts the bytes that these copies move to or from the blocks
other than the home block's, by kind ('gather', 'scatter', 'lanes'): what
crosses between cards where each block has a card of its own.

Plain torch, no kernel.  All blocks of a group are driven from one host
thread; their launches are asynchronous, so the cards overlap without a
thread a device.  One device may hold several blocks (a CPU mesh of
repeated devices): every block owns its storage.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from sunode_torch.convert import canonical_device

__all__ = ["RowLayout", "RowBlocks", "scatter", "lane_sum", "lane_all", "lane_any", "traffic"]

traffic = {"gather": 0, "scatter": 0, "lanes": 0}


def _off_home(kind: str, xs) -> None:
    traffic[kind] += sum(x.numel() * x.element_size() for x in xs[1:])


@dataclass(frozen=True)
class RowLayout:
    """Block ``d`` on ``devices[d]`` holds the rows ``segments[d]``, global
    ``(start, stop)`` ranges of the ``n_rows``-row vector in its local
    order; the segments of all blocks cover ``[0, n_rows)`` once.
    ``devices[0]`` is the home device."""

    devices: tuple
    segments: tuple

    def __post_init__(self):
        object.__setattr__(self, "devices", tuple(canonical_device(d) for d in self.devices))
        object.__setattr__(self, "segments", tuple(tuple((int(a), int(b)) for a, b in seg)
                                                   for seg in self.segments))
        covered = sorted(ab for seg in self.segments for ab in seg)
        if len(self.devices) != len(self.segments) or not covered or any(
                b <= a for a, b in covered) or covered[0][0] != 0 or any(
                covered[i][1] != covered[i + 1][0] for i in range(len(covered) - 1)):
            raise ValueError(f"the row segments {self.segments} do not cover the rows once "
                             f"on {len(self.devices)} devices")

    @classmethod
    def contiguous(cls, devices: Sequence, sizes: Sequence[int]) -> "RowLayout":
        """Contiguous cuts: block ``d`` holds the next ``sizes[d]`` rows."""
        offs = [0]
        for s in sizes:
            offs.append(offs[-1] + int(s))
        return cls(tuple(devices), tuple(((offs[d], offs[d + 1]),) for d in range(len(sizes))))

    @property
    def n_rows(self) -> int:
        return max(b for seg in self.segments for _, b in seg)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    @property
    def sizes(self) -> tuple:
        return tuple(sum(b - a for a, b in seg) for seg in self.segments)

    def with_rows(self, m: int) -> "RowLayout":
        """``m`` rows more after the last (the quadrature's), on the home
        device after its block's rows."""
        if m == 0:
            return self
        N = self.n_rows
        return RowLayout(self.devices, (self.segments[0] + ((N, N + m),), *self.segments[1:]))

    def repeated(self, k: int) -> "RowLayout":
        """The layout of ``[x_0 | ... | x_{k-1}]``, each ``x_j`` of this
        layout's rows: block ``d`` holds block ``d``'s rows of each (the
        backsolve's ``[y | lambda]``, y and lambda of the same state rows on
        one device)."""
        N = self.n_rows
        return RowLayout(self.devices, tuple(tuple((a + j * N, b + j * N) for j in range(k)
                                                   for a, b in seg) for seg in self.segments))

    def state_rows(self, n: int) -> tuple:
        """Each block's count of rows below ``n``: its leading rows, which
        the split attempt takes as state rows (the rest, the quadrature's,
        follow them)."""
        out = []
        for seg in self.segments:
            below = [min(b, n) - min(a, n) for a, b in seg]
            if any(below[i] < b - a and below[i + 1] > 0
                   for i, (a, b) in enumerate(seg[:-1])):
                raise ValueError(f"a block holds a row past {n} before a state row: {seg}")
            out.append(sum(below))
        return tuple(out)

    def global_rows(self, d: int) -> torch.Tensor:
        """Block ``d``'s global row indices in its local order, on its device."""
        return torch.cat([torch.arange(a, b) for a, b in self.segments[d]]).to(self.devices[d])

    def share(self, parts: Sequence[torch.Tensor], to: Sequence[int] | None = None) -> list:
        """Every block's part on the devices of the blocks ``to`` (all by
        default): ``out[i][e]`` is ``parts[e]`` on ``devices[to[i]]``, one
        copy a distinct device.  :data:`traffic` counts each part once for
        every receiving block but its own, as if each block had a card of
        its own."""
        sizes = [x.numel() * x.element_size() for x in parts]
        copies: dict = {}
        out = []
        for d in range(len(self.devices)) if to is None else to:
            traffic["lanes"] += sum(size for e, size in enumerate(sizes) if e != d)
            dev = self.devices[d]
            if dev not in copies:
                copies[dev] = [x.to(dev) for x in parts]
            out.append(copies[dev])
        return out

    def lanes(self, x: torch.Tensor) -> list:
        """``x`` on every block's device (one copy a distinct device)."""
        traffic["lanes"] += (len(self.devices) - 1) * x.numel() * x.element_size()
        copies: dict = {}
        for dev in self.devices:
            if dev not in copies:
                copies[dev] = x.to(dev)
        return [copies[dev] for dev in self.devices]


@dataclass
class RowBlocks:
    """One array's blocks of rows (the rows on axis -2), block ``d`` on
    ``layout.devices[d]`` holding ``layout.segments[d]``."""

    layout: RowLayout
    blocks: list

    def gather(self, device=None) -> torch.Tensor:
        """The whole array on ``device`` (the home device by default), its
        rows in global order."""
        dev = self.layout.home if device is None else torch.device(device)
        _off_home("gather", self.blocks)
        pieces, at = [], 0
        for seg, x in zip(self.layout.segments, self.blocks):
            for a, b in seg:
                pieces.append((a, x[..., at:at + b - a, :] if len(seg) > 1 else x))
                at += b - a
            at = 0
        return torch.cat([p.to(dev) for _, p in sorted(pieces, key=lambda ap: ap[0])], dim=-2)

    def map(self, fn: Callable, *others) -> "RowBlocks":
        """``fn(block_d, other_d, ...)`` on every block; each of ``others``
        is a :class:`RowBlocks` of the same layout, or a list of one value a
        block."""
        parts = [o.blocks if isinstance(o, RowBlocks) else o for o in others]
        return RowBlocks(self.layout, [fn(*args) for args in zip(self.blocks, *parts)])


def scatter(layout: RowLayout, x: torch.Tensor, home: bool = True) -> RowBlocks:
    """``x``'s rows (axis -2, ``layout.n_rows`` of them) cut into the blocks
    of ``layout``, each a copy with storage of its own on its device; with
    ``home`` False the home block is None (its reader takes its rows of
    ``x`` in place)."""
    if x.shape[-2] != layout.n_rows:
        raise ValueError(f"scatter: {x.shape[-2]} rows for a layout of {layout.n_rows}")
    blocks = [None if d == 0 and not home else
              torch.cat([x[..., a:b, :] for a, b in seg], dim=-2).to(dev)
              for d, (seg, dev) in enumerate(zip(layout.segments, layout.devices))]
    _off_home("scatter", blocks)
    return RowBlocks(layout, blocks)


def lane_sum(partials: Sequence[torch.Tensor], home) -> torch.Tensor:
    """The blocks' per-lane partial sums added on ``home`` in block order
    (one block's partial is returned as it is)."""
    _off_home("lanes", partials)
    acc = partials[0].to(home)
    for p in partials[1:]:
        acc = acc + p.to(home)
    return acc


def lane_all(flags: Sequence[torch.Tensor], home) -> torch.Tensor:
    """The AND of the blocks' per-lane flags on ``home``."""
    _off_home("lanes", flags)
    acc = flags[0].to(home)
    for f in flags[1:]:
        acc = acc & f.to(home)
    return acc


def lane_any(flags: Sequence[torch.Tensor], home) -> torch.Tensor:
    """The OR of the blocks' per-lane flags on ``home``."""
    _off_home("lanes", flags)
    acc = flags[0].to(home)
    for f in flags[1:]:
        acc = acc | f.to(home)
    return acc
