"""The ("ev", "p") mesh over the ranks of a ``torch.distributed`` group
(the port's twin of the JAX package's ``parallel/mesh.py``).

One 2-D mesh covers both parallel axes of the consensus computation:

- ``ev`` — the event axis (the DAG's long axis): per-event rows;
- ``p``  — the participant axis: coordinate and witness-table columns
  split by creator, where every strongly-see compare-count becomes a
  partial count and an all-reduce SUM.

A JAX mesh is a grid of devices in one SPMD program; here it is a grid
of ranks, each a process that runs the same host code.  Rank ``r`` sits
at ``grid[r // p, r % p]``: the ``p`` ranks of one grid row form its
"p" group (on one host they share NVLink), the ``ev`` ranks of one grid
column its "ev" group.  Every rank creates every subgroup, in the same
order, as ``torch.distributed.new_group`` requires.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .collectives import Axis, ColumnShard, column_shard


def _factor(n: int) -> Tuple[int, int]:
    """Split n into (ev, p) with p the largest power-of-two factor <= sqrt(n)."""
    p = 1
    while n % (p * 2) == 0 and (p * 2) ** 2 <= n:
        p *= 2
    return n // p, p


#: this process's card among its host's: torchrun's ``LOCAL_RANK``, read
#: once at import (torchrun sets it before the process starts), 0 unset
LOCAL_RANK = int(os.environ.get("LOCAL_RANK", "0"))


def default_device() -> torch.device:
    """``cuda:LOCAL_RANK``."""
    return torch.device("cuda", LOCAL_RANK)


class Mesh:
    """This rank's view of an (ev, p) grid of ranks.

    ``shape`` is ``{"ev": ev, "p": p}``, ``grid`` the ``[ev, p]`` array of
    global ranks, ``rank`` and ``coords`` this rank's place in it,
    ``axes["ev"]`` / ``axes["p"]`` its two groups (``Axis``), ``world``
    the whole grid, ``device`` the ``torch.device`` its tensors live on."""

    axis_names = ("ev", "p")

    def __init__(self, grid: np.ndarray, rank: int, device):
        self.grid = np.asarray(grid, dtype=np.int64)
        ev, p = self.grid.shape
        self.shape = {"ev": ev, "p": p}
        self.rank = int(rank)
        where = np.argwhere(self.grid == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not in the mesh grid {grid}")
        i_ev, i_p = (int(v) for v in where[0])
        self.coords = {"ev": i_ev, "p": i_p}
        self.device = torch.device(device)
        groups = _subgroups(self.grid)
        col, row = self.grid[:, i_p], self.grid[i_ev, :]
        self.axes = {
            "ev": Axis("ev", col, i_ev, groups.get(tuple(col))),
            "p": Axis("p", row, i_p, groups.get(tuple(row))),
        }
        flat = self.grid.reshape(-1)
        self.world = Axis("world", flat, int(np.argmax(flat == self.rank)),
                          groups.get(tuple(flat)))

    def block_shard(self, n_blocks: int) -> ColumnShard:
        """This rank's ``n_blocks / p`` consecutive blocks of a stacked
        block axis split over "p", with the reducers over that axis
        (the wide stream's ``mesh=``)."""
        return column_shard(self.axes["p"], n_blocks)

    @property
    def size(self) -> int:
        return int(self.grid.size)

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rank={self.rank}, "
                f"coords={self.coords}, device={self.device})")


def _subgroups(grid: np.ndarray) -> dict:
    """Every column group, then every row group, then the whole grid,
    each of more than one rank, made by ``new_group`` in that order on
    every rank; ``{ranks: group}``."""
    out = {}
    if grid.size == 1:
        return out
    import torch.distributed as dist

    ev, p = grid.shape
    wanted = [tuple(grid[:, j]) for j in range(p)]
    wanted += [tuple(grid[i, :]) for i in range(ev)]
    wanted.append(tuple(grid.reshape(-1)))
    for ranks in wanted:
        if len(ranks) > 1 and ranks not in out:
            out[ranks] = dist.new_group(ranks=[int(r) for r in ranks])
    return out


def _world() -> Tuple[int, int]:
    """(world size, rank) of the default group; (1, 0) when no group is
    initialised."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, int]] = None,
              device=None) -> Mesh:
    """Build the ("ev", "p") mesh over the ``n_devices`` ranks of the
    default group (all of them), rank r at ``grid[r // p, r % p]``.
    ``device`` is this rank's ``torch.device`` (``cuda:LOCAL_RANK`` by
    default; "cpu" for a CPU rehearsal, "cuda:0" for ranks that share
    one card).  A world of one rank needs no initialised group."""
    world, rank = _world()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(
            f"requested {n_devices} devices, only {world} available"
        )
    if n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} ranks in a world of {world}: every "
            "rank runs the one SPMD program, so the mesh takes them all"
        )
    if shape is None:
        shape = _factor(n_devices)
    ev, p = shape
    if ev * p != n_devices:
        raise ValueError(f"mesh shape {shape} != device count {n_devices}")
    grid = np.arange(n_devices).reshape(ev, p)
    return Mesh(grid, rank, default_device() if device is None else device)
