"""Sharding layout and the sharded consensus programs, on
``torch.distributed`` (the port's twin of the JAX package's
``parallel/sharded.py``).

Layout at rest (``state_specs``, copied from JAX as data):

- per-event vectors (sp, op, creator, seq, ts, mbit, round, witness, rr,
  cts): row slices over "ev" → ``P("ev")``;
- coordinates la/fd ``[E+1, N]``: event rows over "ev", participant
  columns over "p" → ``P("ev", "p")``;
- witness tables wslot/famous ``[R+1, N]``: columns over "p" →
  ``P(None, "p")``;
- creator tables, scalars, packed bitplanes and ingest batches:
  replicated → ``P()``.

JAX annotates that layout and lets XLA partition one program and insert
the collectives.  Here every rank runs the same host code on
bit-identical inputs (``multihost.broadcast_batch``) and the
decomposition is written out:

- **Step entry / exit.**  The "ev" axis is gathered at entry and sliced
  at exit: the level scans and the frontier march read parent and chain
  rows anywhere in the DAG (an XLA partition of a data-dependent gather
  moves the same rows).  The witness tables are gathered over "p" at
  entry (a few KB; every rank reads every witness slot) and sliced at
  exit.  la/fd stay column shards ``[E+1, N/p]`` through the step.
- **Coordinate fills are column-local.**  la[e, c] = max(la[sp, c],
  la[op, c]) with the creator's own column taking seq, fd by a reverse
  min-scatter: each rank fills its own N/p columns, the creator test
  shifted by its column origin (``ops/ingest.py``).  Mode "walk" runs
  the hand-written ``la_walk`` kernel on the rank's column range.  The
  chain-view fd fill (``_fd_full``) reads every creator's column of a
  chain's events, so it gathers la's columns, then computes its own fd
  columns; the incremental fill OR-s its ancestor flags over "p".
  Every fd mode runs sharded but "absorb", whose log-depth passes read
  whole rows.
- **Every strongly-see compare-count is a partial count over the
  rank's columns, then an all-reduce SUM over "p"** (the frontier
  march, the level scan, both fame forms, the see count of round
  received).  Fame votes are column-local in the voted-on witness, so
  each rank decides its own witness columns, gathered before the lcr
  reduction; the median gathers the masked timestamp columns before its
  row sort.

Padding (``pad_cfg_for_mesh``): the event capacity rounds up so that
e_cap+1 divides "ev", the participant width to a multiple of "p" with
dead columns.  A dead column holds la = -1 and fd = INF, so it adds 0 to
every count; ``DagConfig.n_real`` keeps the thresholds on the true count.

The byzantine (fork) pipeline shards its branch columns B = n*k over
"p" the same way, whole creators to a rank (see the fork section).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.ingest import SHARDED_FD_MODES, EventBatch
from ..ops.state import DagConfig, DagState, init_state
from ..step import consensus_step
from .collectives import column_shard
from .mesh import Mesh

#: the JAX package's name for the unsharded step
consensus_step_impl = consensus_step


class P(tuple):
    """A partition spec: one mesh axis name (or None) per leading tensor
    dimension; dimensions past the spec are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(a) for a in self) + ")"


class Sharding(NamedTuple):
    """A spec on a mesh (JAX's ``NamedSharding``)."""

    mesh: Mesh
    spec: P


def state_specs() -> DagState:
    """DagState-shaped tuple of PartitionSpecs."""
    ev = P("ev")
    return DagState(
        sp=ev, op=ev, creator=ev, seq=ev, ts=ev, mbit=ev,
        la=P("ev", "p"), fd=P("ev", "p"),
        round=ev, witness=ev, rr=ev, cts=ev,
        ce=P(), cnt=P(),
        wslot=P(None, "p"), famous=P(None, "p"),
        sm=P(),
        # packed witness bitplanes: replicated (8 participant columns a
        # lane, so "p" rarely divides the lane axis; tiny)
        mbr=P(), fmr=P(),
        n_events=P(), max_round=P(), lcr=P(),
        e_off=P(), s_off=P(), r_off=P(),
    )


def state_shardings(mesh: Mesh) -> DagState:
    return DagState(*(Sharding(mesh, spec) for spec in state_specs()))


def batch_shardings(mesh: Mesh) -> EventBatch:
    """Ingest batches are small relative to state: replicate them."""
    rep = Sharding(mesh, P())
    return EventBatch(
        sp=rep, op=rep, creator=rep, seq=rep, ts=rep, mbit=rep, k=rep,
        sched=rep,
    )


def shard_of(t: torch.Tensor, spec: P, mesh: Mesh,
             axes=("ev", "p")) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` along the named
    ``axes`` of ``spec`` (a view)."""
    for dim, name in enumerate(spec):
        if name in axes and mesh.shape[name] > 1:
            size = mesh.shape[name]
            if t.shape[dim] % size:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"divide mesh axis {name!r}={size}")
            w = t.shape[dim] // size
            t = t.narrow(dim, mesh.coords[name] * w, w)
    return t


def gather_blocks(t: torch.Tensor, spec: P, mesh: Mesh,
                  axes=("ev", "p")) -> torch.Tensor:
    """The inverse of ``shard_of``: every rank's block gathered along the
    named ``axes`` of ``spec``."""
    for dim, name in enumerate(spec):
        if name in axes:
            t = mesh.axes[name].gather(t, dim)
    return t


def place_state(state: DagState, mesh: Mesh) -> DagState:
    """A full state → this rank's shard (own memory, on the mesh's
    device)."""
    return DagState(*(
        None if t is None
        else shard_of(t.to(mesh.device), spec, mesh).contiguous().clone()
        for t, spec in zip(state, state_specs())
    ))


def gather_state(state: DagState, mesh: Mesh) -> DagState:
    """Every rank's shard gathered into the full state (for checks)."""
    return DagState(*(
        None if t is None else gather_blocks(t, spec, mesh)
        for t, spec in zip(state, state_specs())
    ))


def sharded_init_state(cfg: DagConfig, mesh: Mesh) -> DagState:
    return place_state(init_state(cfg, device=mesh.device), mesh)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_cfg_for_mesh(cfg: DagConfig, mesh: Mesh) -> DagConfig:
    """Round capacities up so every sharded dim divides its mesh axis."""
    ev = mesh.shape["ev"]
    p = mesh.shape["p"]
    n_pad = _ceil_to(cfg.n, p)
    e_cap = _ceil_to(cfg.e_cap + 1, ev) - 1
    n_real = cfg.n_real or cfg.n
    return DagConfig(
        n=n_pad, e_cap=e_cap, s_cap=cfg.s_cap, r_cap=cfg.r_cap,
        n_real=n_real, coord16=cfg.coord16, coord8=cfg.coord8,
        packed=cfg.packed,
    )


#: fields that stay column shards inside a step
_COLUMN_LOCAL = ("la", "fd")


class ShardedStep:
    """The consensus step on one rank of ``mesh`` (module docstring):
    ``step(state, batch)`` takes this rank's shard of the state and the
    replicated batch, and returns this rank's shard of the result.
    ``shard`` is the rank's ``ColumnShard`` of the participant axis
    (``shard.widths()``: the columns its compare-counts saw)."""

    def __init__(self, cfg: DagConfig, mesh: Mesh, fd_mode: str = "full"):
        if fd_mode not in SHARDED_FD_MODES:
            raise ValueError(f"the sharded step runs fd modes "
                             f"{SHARDED_FD_MODES}, not {fd_mode!r}")
        if (cfg.e_cap + 1) % mesh.shape["ev"]:
            raise ValueError(f"e_cap+1={cfg.e_cap + 1} does not divide "
                             f"mesh 'ev'={mesh.shape['ev']}: pad_cfg_for_mesh")
        self.cfg, self.mesh, self.fd_mode = cfg, mesh, fd_mode
        self.shard = column_shard(mesh.axes["p"], cfg.n)

    def entry(self, state: DagState) -> DagState:
        """At-rest shard → the step's view: "ev" gathered everywhere,
        "p" gathered except on la/fd."""
        return DagState(*(
            None if t is None else gather_blocks(
                t, spec, self.mesh,
                ("ev",) if f in _COLUMN_LOCAL else ("ev", "p"))
            for f, t, spec in zip(DagState._fields, state, state_specs())
        ))

    def exit(self, state: DagState) -> DagState:
        """The step's view → this rank's shard at rest."""
        return DagState(*(
            None if t is None else shard_of(
                t, spec, self.mesh,
                ("ev",) if f in _COLUMN_LOCAL else ("ev", "p")
            ).contiguous()
            for f, t, spec in zip(DagState._fields, state, state_specs())
        ))

    def __call__(self, state: DagState, batch: EventBatch) -> DagState:
        dev = self.mesh.device
        batch = EventBatch(*(t.to(dev) for t in batch))
        out = consensus_step(self.cfg, self.fd_mode, self.entry(state),
                             batch, axis=self.shard)
        return self.exit(out)


def make_sharded_step(cfg: DagConfig, mesh: Mesh,
                      fd_mode: str = "full") -> ShardedStep:
    """The full consensus step over ``mesh`` (JAX: jitted with the mesh
    shardings annotated in and out)."""
    return ShardedStep(cfg, mesh, fd_mode)


# ----------------------------------------------------------------------
# byzantine (fork) pipeline sharding: the branch-column axis B = n*k is
# the wide dimension; partition it over "p" exactly like the honest N
# axis.  Branch columns are creator-major (column c*k + kk), so "p" must
# divide n: a contiguous B/p range then holds whole creators, and the
# creator-grouped reductions (strided OR over the k branch slots,
# fork detection) stay on one rank.  Which parts of the pipeline are
# column-local and which gather inside it: ops/forks.py module
# docstring.


def fork_batch_specs():
    from ..ops.forks import ForkBatch

    ev = P("ev")
    return ForkBatch(
        sp=ev, op=ev, ebr=ev, eseq=ev, ecr=ev, ts=ev, mbit=ev,
        sched=P(), cp=P("p", None), ce=P("p", None), cnt=P("p"),
        owner=P("p", None), n_events=P(),
        rseed=ev, wseed=ev, s_off=P("p"),
    )


def fork_out_specs():
    from ..ops.forks import ForkOut

    ev = P("ev")
    return ForkOut(
        la=P("ev", "p"), det=P("ev", None), fd=P("ev", "p"),
        round=ev, witness=ev, wslot=P(None, "p"), famous=P(None, "p"),
        rr=ev, cts=ev, max_round=P(), lcr=P(),
    )


def pad_fork_for_mesh(cfg, batch, mesh: Mesh):
    """Round the fork batch's event axis up so e_cap+1 divides the "ev"
    mesh axis.  Padding rows replicate the sentinel (sp=-1, eseq=-1 ...),
    so they are invisible; the old sentinel row just becomes one more
    dead event row."""
    ev = mesh.shape["ev"]
    e1_new = _ceil_to(cfg.e_cap + 1, ev)
    if e1_new == cfg.e_cap + 1:
        return cfg, batch
    pad = e1_new - (cfg.e_cap + 1)

    def pad1(a, fill):
        return torch.cat([a, torch.full((pad,), fill, dtype=a.dtype,
                                        device=a.device)])

    batch = batch._replace(
        sp=pad1(batch.sp, -1), op=pad1(batch.op, -1),
        ebr=pad1(batch.ebr, cfg.b), eseq=pad1(batch.eseq, -1),
        ecr=pad1(batch.ecr, cfg.n), ts=pad1(batch.ts, 0),
        mbit=pad1(batch.mbit, False),
        rseed=pad1(batch.rseed, -1), wseed=pad1(batch.wseed, -1),
    )
    return cfg._replace(e_cap=e1_new - 1), batch


class ShardedForkStep:
    """The fork pipeline on one rank of ``mesh``: ``step(batch)`` takes
    the replicated batch (``multihost.broadcast_batch``) and returns
    this rank's shard of the ``ForkOut`` (``fork_out_specs``).
    ``shard`` is the rank's ``ColumnShard`` of the branch columns."""

    def __init__(self, cfg, mesh: Mesh, ss=None):
        if cfg.n % mesh.shape["p"]:
            raise ValueError(
                f"mesh 'p'={mesh.shape['p']} must divide creators n={cfg.n}"
            )
        if (cfg.e_cap + 1) % mesh.shape["ev"]:
            raise ValueError(f"e_cap+1={cfg.e_cap + 1} does not divide "
                             f"mesh 'ev'={mesh.shape['ev']}: "
                             "pad_fork_for_mesh")
        from ..ops.forks import ss_counts

        self.cfg, self.mesh = cfg, mesh
        self.ss = ss_counts if ss is None else ss
        self.shard = column_shard(mesh.axes["p"], cfg.b, cfg.k)

    def __call__(self, batch, stats: Optional[dict] = None):
        from ..ops.forks import ForkBatch, ForkOut, fork_pipeline

        dev = self.mesh.device
        batch = ForkBatch(*(t.to(dev) for t in batch))
        out = fork_pipeline(self.cfg, batch, ss=self.ss, stats=stats,
                            axis=self.shard)
        return ForkOut(*(
            shard_of(t, spec, self.mesh,
                     ("ev",) if f in _COLUMN_LOCAL else ("ev", "p")
                     ).contiguous()
            for f, t, spec in zip(ForkOut._fields, out, fork_out_specs())
        ))


def make_sharded_fork_step(cfg, mesh: Mesh, ss=None) -> ShardedForkStep:
    """The whole fork pipeline over ``mesh`` (JAX: jitted with the mesh
    shardings annotated).  ``ss`` replaces the compare-count, as in
    ``fork_pipeline`` (the plain twin for a check run)."""
    return ShardedForkStep(cfg, mesh, ss)


def gather_fork_out(out, mesh: Mesh):
    """Every rank's ``ForkOut`` shard gathered into the whole output."""
    from ..ops.forks import ForkOut

    return ForkOut(*(gather_blocks(t, spec, mesh)
                     for t, spec in zip(out, fork_out_specs())))
