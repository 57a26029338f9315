"""The collectives of the sharded programs, on ``torch.distributed``.

One ``Axis`` is one mesh axis as this rank sees it: its process group,
its size and this rank's index along it.  It offers the four
collectives the sharded step, fork step and stream need, each a no-op
on a one-rank axis:

- ``sum`` and ``max``: an all-reduce over the axis;
- ``gather``: equal shards concatenated along one dimension in axis
  order, written as an all-reduce SUM of a zero-filled buffer into
  which each rank copies its own slot (exact for integers, and for
  floats since every other slot adds 0);
- ``broadcast`` from the axis's first rank.

Only ``broadcast`` and ``all_reduce`` are used: gloo runs those two on
CUDA tensors, NCCL runs everything, so one code path serves both
backends with no branch on the backend.  Booleans travel as uint8.

``ColumnShard`` is what a compare-count site sees of the participant
("p") axis inside a step: the global column range ``[lo, hi)`` this
rank holds of an ``n``-column tensor, and the axis to reduce over.
``count`` sums a partial compare-count over the axis and records, per
site, the widths of the partials it was handed, so a test can show
that each rank counted over its own ``hi - lo`` columns only.

``STATS`` counts, per kind, the calls and bytes that went to the
backend (one-rank axes send nothing and count nothing).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

import torch

#: kind -> [calls, bytes] handed to the backend by this process
STATS: Dict[str, list] = {}


def reset_stats() -> None:
    STATS.clear()


def stats() -> Dict[str, dict]:
    """A copy of ``STATS`` as ``{kind: {"calls": c, "bytes": b}}``."""
    return {k: {"calls": v[0], "bytes": v[1]} for k, v in sorted(STATS.items())}


def _note(kind: str, t: torch.Tensor) -> None:
    row = STATS.setdefault(kind, [0, 0])
    row[0] += 1
    row[1] += t.numel() * t.element_size()


class Axis:
    """One mesh axis of this rank: ``group`` (None on a one-rank axis),
    ``size``, ``index`` (this rank's position along the axis) and
    ``ranks`` (the global ranks of the axis, in axis order)."""

    def __init__(self, name: str, ranks, index: int, group=None):
        self.name = name
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.index = index
        self.group = group

    def __repr__(self) -> str:
        return f"Axis({self.name!r}, size={self.size}, index={self.index})"

    def _reduce(self, kind: str, t: torch.Tensor, op) -> torch.Tensor:
        import torch.distributed as dist

        is_bool = t.dtype == torch.bool
        buf = (t.to(torch.uint8) if is_bool else t).contiguous().clone()
        _note(kind, buf)
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.bool() if is_bool else buf

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce SUM over the axis (a new tensor)."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        return self._reduce("sum", t, dist.ReduceOp.SUM)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce MAX over the axis (a new tensor; OR for bool)."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        return self._reduce("max", t, dist.ReduceOp.MAX)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
        axis order."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        dim = dim % t.dim()
        is_bool = t.dtype == torch.bool
        src = t.to(torch.uint8) if is_bool else t
        shape = list(src.shape)
        width = shape[dim]
        shape[dim] = width * self.size
        buf = torch.zeros(shape, dtype=src.dtype, device=src.device)
        buf.narrow(dim, self.index * width, width).copy_(src)
        _note("gather", buf)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf.bool() if is_bool else buf

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """The axis's first rank's ``t`` on every rank, in place (``t``
        must be contiguous and of the same shape everywhere)."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        _note("broadcast", t)
        dist.broadcast(t, src=self.ranks[0], group=self.group)
        return t


class ColumnShard:
    """This rank's column range ``[lo, hi)`` of an ``n``-column axis
    split over ``axis`` (module docstring).  ``seen[site]`` counts the
    widths of the partial compare-counts handed to ``count``."""

    def __init__(self, axis: Axis, lo: int, hi: int, n: int):
        self.axis = axis
        self.lo, self.hi, self.n = lo, hi, n
        self.seen: Dict[str, Counter] = {}

    @property
    def width(self) -> int:
        return self.hi - self.lo

    def count(self, site: str, partial: torch.Tensor,
              cols: int) -> torch.Tensor:
        """The full compare-count from this rank's partial over ``cols``
        columns: an all-reduce SUM over the axis."""
        self.seen.setdefault(site, Counter())[cols] += 1
        return self.axis.sum(partial)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.axis.sum(t)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self.axis.max(t)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return self.axis.gather(t, dim)

    def widths(self) -> Dict[str, list]:
        """``{site: sorted distinct widths}`` of the recorded counts."""
        return {s: sorted(c) for s, c in sorted(self.seen.items())}


def column_shard(axis: Axis, n: int, unit: int = 1) -> ColumnShard:
    """The shard of ``n`` columns (whole ``unit``-column groups) that
    rank ``axis.index`` holds: ``n / size`` contiguous columns."""
    if n % (axis.size * unit):
        raise ValueError(f"{n} columns do not split into {axis.size} "
                         f"shards of whole {unit}-column groups")
    w = n // axis.size
    return ColumnShard(axis, axis.index * w, (axis.index + 1) * w, n)
