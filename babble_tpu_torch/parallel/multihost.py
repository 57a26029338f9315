"""Multi-host execution on ``torch.distributed`` (the port's twin of the
JAX package's ``parallel/multihost.py``).

One SPMD program over a global mesh of every rank of every host: each
rank is one process on one card, all ranks run the same host code on
bit-identical inputs.  The bandwidth hierarchy drives the axis
placement, as in JAX, with a host standing where a TPU slice stood:

- the **participant axis "p"** carries the hot collectives (every
  strongly-see count is a partial count and an all-reduce SUM over "p"),
  so "p" stays *inside* a host, on NVLink;
- the **event axis "ev"** spans hosts, as in JAX.  In this port "ev"
  only spreads the state at rest: every "ev" rank gathers all rows at
  step entry and computes the whole step over its "p" columns
  (``sharded.ShardedStep.entry``), so ranks along "ev" repeat each
  other's work, and a second host adds no compute and pays a cross-host
  gather a step.  A row-parallel "ev" is open work.

``bootstrap`` joins the process group, ``global_mesh`` builds that
layout from the ranks' host names (``dcn_axis`` overrides the host
count, for rehearsing on one machine), ``broadcast_batch`` ships rank
0's batch to every rank, and ``make_multihost_step`` is the sharded
step (``sharded.py``) over that mesh: the mesh is the only thing that
changes.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import numpy as np
import torch

from ..ops.ingest import EventBatch
from ..ops.state import DagConfig
from .collectives import Axis
from .mesh import Mesh, _world, default_device, make_mesh
from .sharded import make_sharded_step, pad_cfg_for_mesh, sharded_init_state


def _env(*names) -> Optional[str]:
    for name in names:
        v = os.environ.get(name)
        if v:
            return v
    return None


def bootstrap(coordinator: Optional[str] = None,
              num_processes: Optional[int] = None,
              process_id: Optional[int] = None,
              backend: str = "nccl") -> None:
    """Join the process group (one call per rank, before any collective).

    ``coordinator`` is ``host:port`` of rank 0's store.  Each argument
    defaults from torchrun's variables (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``), then from the JAX package's
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``).  ``backend`` is "nccl" unless the caller asks
    for "gloo"; nothing falls back."""
    import torch.distributed as dist

    if coordinator is None:
        addr, port = _env("MASTER_ADDR"), _env("MASTER_PORT")
        coordinator = f"{addr}:{port}" if addr and port \
            else _env("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        v = _env("WORLD_SIZE", "JAX_NUM_PROCESSES")
        num_processes = int(v) if v else None
    if process_id is None:
        v = _env("RANK", "JAX_PROCESS_ID")
        process_id = int(v) if v is not None else None
    missing = [name for name, v in (("coordinator", coordinator),
                                    ("num_processes", num_processes),
                                    ("process_id", process_id)) if v is None]
    if missing:
        raise ValueError(f"bootstrap: no {', '.join(missing)} given or "
                         "found in the environment")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def _host_index(world: int) -> list:
    """Per rank, the index of its host among the hosts in order of their
    lowest rank (one all-gather of the host names)."""
    import torch.distributed as dist

    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    order = list(dict.fromkeys(names))
    return [order.index(h) for h in names]


def global_mesh(dcn_axis: Optional[int] = None, device=None) -> Mesh:
    """("ev", "p") mesh over every rank of every host.

    Several hosts: "ev" spans the hosts (hosts x per-host rows) and "p"
    stays inside a host.  One host: the balanced (ev, p) split of the
    local path.  ``dcn_axis`` overrides the detected host count (a
    rehearsal on one machine)."""
    world, rank = _world()
    host = _host_index(world) if world > 1 else [0]
    slices = dcn_axis or (max(host) + 1)
    if world % slices:
        raise ValueError(f"{world} devices do not split into {slices} slices")
    per_slice = world // slices
    if slices == 1:
        return make_mesh(device=device)
    # ranks host-major, so each "ev" row group lies in one host and the
    # "p" neighbours share it; "p" takes the largest power-of-two
    # intra-host factor, "ev" spans hosts x the remaining rows
    ranks = sorted(range(world), key=lambda r: (host[r], r))
    p = 1
    while per_slice % (p * 2) == 0:
        p *= 2
    grid = np.asarray(ranks).reshape(world // p, p)
    return Mesh(grid, rank, default_device() if device is None else device)


#: wire codes of the batch dtypes
_DTYPES = (torch.int32, torch.int64, torch.bool)


def broadcast_batch(batch: Optional[EventBatch],
                    mesh: Optional[Mesh] = None) -> EventBatch:
    """The first rank's batch on every rank of ``mesh`` (of the default
    group, on ``cuda:LOCAL_RANK``, without one): the shapes and dtypes
    first, then each field.  Other ranks may pass None.

    SPMD correctness requires every rank to feed a *bit-identical*
    batch; independently built host batches (per-host gossip arrival
    order) do NOT qualify and would silently diverge the replicated
    state.  Route every batch through this broadcast, or build it
    deterministically and identically everywhere."""
    if mesh is None:
        import torch.distributed as dist

        n, rank = dist.get_world_size(), dist.get_rank()
        world, dev = Axis("world", range(n), rank), default_device()
    else:
        world, dev, rank = mesh.world, mesh.device, mesh.rank
    lead = world.ranks[0] == rank
    head = torch.zeros((len(EventBatch._fields), 4), dtype=torch.int64,
                       device=dev)
    if lead:
        for i, t in enumerate(batch):
            if t.dim() > 2:
                raise ValueError(f"broadcast_batch: {t.dim()}-d field")
            head[i, 0] = _DTYPES.index(t.dtype)
            head[i, 1] = t.dim()
            head[i, 2:2 + t.dim()] = torch.tensor(t.shape)
    head = world.broadcast(head).cpu().tolist()
    out = []
    for i, (code, ndim, d0, d1) in enumerate(head):
        dtype, shape = _DTYPES[code], (d0, d1)[:ndim]
        wire = torch.uint8 if dtype == torch.bool else dtype
        if lead:
            buf = batch[i].to(device=dev, dtype=wire).contiguous().clone()
        else:
            buf = torch.empty(shape, dtype=wire, device=dev)
        out.append(world.broadcast(buf).to(dtype))
    return EventBatch(*out)


def make_multihost_step(cfg: DagConfig, mesh: Optional[Mesh] = None,
                        fd_mode: str = "full"):
    """The full consensus step over the global mesh.  Returns (mesh,
    padded_cfg, initial sharded state, step fn).

    Every rank must call the step with a bit-identical batch (see
    broadcast_batch); outputs are then identical everywhere (SPMD)."""
    mesh = mesh or global_mesh()
    pcfg = pad_cfg_for_mesh(cfg, mesh)
    step = make_sharded_step(pcfg, mesh, fd_mode)
    state = sharded_init_state(pcfg, mesh)
    return mesh, pcfg, state, step

