"""WideStream: rolling-window streaming for the blocked wide pipeline
(the port's twin of the JAX package's ``ops/stream.py``).

The 10k-participant north star (BASELINE "10k-node / 1M-event") needs
ordering to exist at n=10k, which needs max_round >= 3: about a million
events, or ~20 GB of int8 coordinates if held at once.  This module
streams the event axis through a rolling window instead: ingest a
mega-batch, resume the frontier march over the open rounds only, vote
fame for the undecided window, compute round-received for the rounds
decided by this batch, then evict the ordered prefix and rebase the
window.

Correctness arguments the incremental phases lean on (each is held
against the fused pipeline by ``tests/test_torch_stream.py``):

- **Append-invariance of rounds.** strongly_see(x, w) > 0 only for
  witnesses w that are ancestors of x, and ancestors precede x in any
  topological delivery, so an inserted event's round criterion never
  changes when events are appended.  Found march positions are frozen;
  open rounds bisect only over the appended suffix.
- **Receive-once.** see(w, x) requires x's first descendant on w's
  chain at seq <= seq(w), an ancestor of w, so an event inserted after
  round i's witnesses is never received at round i.  Each batch tests
  only the rounds it decided.
- **Eviction safety.** A slot is evicted only when (a) ordered, (b) its
  round is below r_off = lcr - round_margin, (c) every future parent
  reference stays in-window (``stream_consensus`` knows the generated
  stream's suffix-min of parent slots; a live node uses the seq_window
  contract instead), and (d) it sits seq_window seqs behind its
  creator's final head.  The median counts any below-window first-descendant selected
  by a newly-ordered row, and the pipeline asserts the count is zero.

Entry points run on ``device`` ("cuda" unless the caller asks for the
CPU).  ``stacked=True`` holds la/fd as one [C, E+1, w] tensor on that
device.  ``mesh=`` (a ``parallel.mesh.Mesh``; every rank of it runs the
same stream on the same DAG) shards the stacked blocks over the mesh's
"p" axis, C/p to a rank on the mesh's device, and turns the cross-block
reductions into collectives over that axis (``ops/wide.py`` module
docstring); the window's state stays replicated.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..obs import Registry
from ..obs.spans import Span, host_read, stage
from ..sim.arrays import build_schedule
from .ingest import EventBatch
from .state import (
    DagConfig,
    DagState,
    I32,
    INT32_MAX,
    bucket,
    compact as compact_state,
    init_state,
)
from .wide import (
    MarchCarry,
    _init_blocks,
    _init_blocks_stacked,
    _is_stacked,
    _jits,
    _sync,
    block_count,
    run_wide_coords,
    run_wide_fame,
    run_wide_order,
    run_wide_rounds,
)


class WideStream:
    """Drives the blocked wide pipeline over a rolling window.

    cfg.e_cap is the WINDOW capacity (not the total stream length);
    cfg.s_cap bounds the in-window chain depth (int8 coordinates stay
    valid forever because values are window-local — ops/wide.py)."""

    def __init__(self, cfg: DagConfig, n_blocks: Optional[int] = None,
                 round_margin: int = 0, seq_window: int = 64,
                 record_ordered: bool = True, stacked: bool = False,
                 mesh=None, registry: Optional[Registry] = None,
                 device="cuda"):
        """``stacked=True`` holds la/fd as one [C, E+1, w] tensor driven
        by the stacked programs; with ``mesh`` (an axis named "p") the
        block axis is sharded over the mesh's ranks and the cross-block
        reductions become collectives (module docstring).  A mesh
        stream runs on the mesh's device."""
        self.cfg = cfg
        self.C = n_blocks or block_count(cfg)
        self.round_margin = round_margin
        self.seq_window = seq_window
        self.record_ordered = record_ordered
        self.mesh = mesh
        self.shard = None
        if mesh is not None:
            device = mesh.device
        self.device = torch.device(device)
        self.state: DagState = init_state(cfg, include_coords=False,
                                          device=self.device)
        if stacked or mesh is not None:
            self.la_blocks, self.fd_blocks = _init_blocks_stacked(
                cfg, self.C, mesh, device=self.device
            )
            if mesh is not None:
                self.shard = mesh.block_shard(self.C)
        else:
            self.la_blocks, self.fd_blocks = _init_blocks(
                cfg, self.C, device=self.device
            )
        self.carry: Optional[MarchCarry] = None
        self.e_off = 0                  # host mirror (global slot of row 0)
        self.lcr = -1                   # host mirror after last consensus
        self.evicted = 0
        self.ordered_total = 0
        self.ordered: dict = {}         # global slot -> (rr, cts) if recorded
        self.stats: dict = {"n_blocks": self.C}
        self.timings: dict = {}
        # per-stage registry histograms beside the cumulative dict: the
        # dict holds totals, the histograms the per-call distribution
        self.registry = Registry() if registry is None else registry
        self._m_stage = self.registry.histogram(
            "babble_wide_stage_seconds",
            "wide-pipeline stage wall time per call",
            labelnames=("stage",),
        )
        self._rr_seen = np.zeros((cfg.e_cap + 1,), bool)  # window rows

    def rebind_registry(self, registry: Registry) -> None:
        """Re-register the per-stage histograms on ``registry`` (a
        stream restored from a checkpoint or snapshot was built with a
        private registry; the owning node rebinds it here)."""
        self.registry = registry
        self._m_stage = registry.histogram(
            "babble_wide_stage_seconds",
            "wide-pipeline stage wall time per call",
            labelnames=("stage",),
        )

    # ------------------------------------------------------------------

    def _timed(self, name: str, st: Span) -> None:
        """Feed a closed stage's wall time to ``timings[name]`` and the
        per-stage histogram."""
        self.timings[name] = self.timings.get(name, 0.0) + st.dur_s
        self._m_stage.labels(name).observe(st.dur_s)

    @property
    def n_live(self) -> int:
        return int(host_read(self.state.n_events.item))

    def ingest(self, batch: EventBatch, fd_slot_sched=None) -> None:
        """Coords phase for one mega-batch (parents are window rows).
        ``fd_slot_sched``: window-wide level schedule for the fd sweep
        (run_wide_coords docstring), required for exactness whenever
        earlier batches are still live."""
        with stage("wide.ingest") as st:
            k = int(host_read(batch.k.item))
            if k + self.n_live > self.cfg.e_cap:
                raise ValueError(
                    f"batch of {k} events overflows the window "
                    f"({self.n_live} live / {self.cfg.e_cap} cap) — "
                    "compact first or shrink the batch"
                )
            self.state, self.la_blocks, self.fd_blocks = run_wide_coords(
                self.cfg, self.state, batch, self.la_blocks,
                self.fd_blocks, self.C, fd_slot_sched=fd_slot_sched,
                shard=self.shard,
            )
            with stage("wide.coords.wait"):
                _sync(self.state.sp)
        self._timed("coords", st)

    def consensus(self, final: bool = False) -> int:
        """Rounds -> fame -> order for the current window; returns the
        number of newly ordered events.

        ``final=True`` declares the stream complete: the witness-set
        finality gate (run_wide_fame ``complete``) lifts, so the last
        rounds decide exactly as the whole-DAG batch would."""
        with stage("wide.consensus"):
            max_round = self._rounds()
            with stage("wide.fame") as st:
                lcr_prev = self.lcr
                self.state = run_wide_fame(
                    self.cfg, self.state, self.la_blocks, self.fd_blocks,
                    self.C, self.stats, complete=final, shard=self.shard,
                )
                lcr_now = int(host_read(self.state.lcr.item))
            self._timed("fame", st)
            with stage("wide.order") as st:
                fresh = self._order(lcr_prev, lcr_now, max_round)
            self._timed("order", st)
        return fresh

    def _rounds(self) -> int:
        """The resumed frontier march (stage ``wide.rounds``); returns
        max_round."""
        cfg = self.cfg
        with stage("wide.rounds") as st:
            if self.carry is None:
                # empty carry: a fresh march that persists its table
                self.carry = MarchCarry(
                    torch.full((cfg.r_cap + 1, cfg.n), INT32_MAX,
                               dtype=I32, device=self.device),
                    torch.zeros((cfg.n,), dtype=I32, device=self.device),
                )
            self.state = run_wide_rounds(
                cfg, self.state, self.la_blocks, self.fd_blocks, self.C,
                self.stats, carry=self.carry, shard=self.shard,
            )
            max_round, r_off = (int(v) for v in host_read(torch.stack(
                [self.state.max_round, self.state.r_off]).tolist))
            if max_round - r_off >= cfg.r_cap - 1:
                raise ValueError(
                    f"round window saturated (max_round {max_round}, "
                    f"r_off {r_off}, r_cap {cfg.r_cap}) — raise r_cap or "
                    "compact more often"
                )
        self._timed("rounds", st)
        return max_round

    def _order(self, lcr_prev: int, lcr_now: int, max_round: int) -> int:
        """Round received and timestamps for the rounds fame decided
        since the last call, and the host's count of newly ordered
        rows; returns that count."""
        self.state = run_wide_order(
            self.cfg, self.state, self.la_blocks, self.fd_blocks, self.C,
            self.stats, r_lo_abs=lcr_prev + 1, r_hi_abs=lcr_now,
            shard=self.shard,
        )
        self.lcr = lcr_now
        self.stats["max_round"] = max_round
        # count newly ordered rows (window-local bookkeeping survives
        # compaction because _rr_seen shifts with the window)
        ne = self.n_live
        rr = host_read(self.state.rr[:ne].cpu).numpy()
        newly = (rr >= 0) & ~self._rr_seen[:ne]
        fresh = int(np.count_nonzero(newly))
        if fresh:
            self._rr_seen[:ne] |= rr >= 0
            self.ordered_total += fresh
            if self.record_ordered:
                cts = host_read(self.state.cts[:ne].cpu).numpy()
                for s in np.nonzero(newly)[0]:
                    self.ordered[self.e_off + int(s)] = (
                        int(rr[s]), int(cts[s])
                    )
        return fresh

    # ------------------------------------------------------------------

    def compact(self, min_future_parent: int,
                head_seqs: Optional[np.ndarray] = None,
                compact_min: int = 1024) -> int:
        """Evict the longest safe ordered prefix (module docstring) and
        rebase the window.  ``min_future_parent`` is the smallest global
        slot any future batch will reference as a parent;
        ``head_seqs[c]`` is creator c's final head seq over the whole
        stream (defaults to the current in-window heads)."""
        with stage("wide.compact"):
            cfg = self.cfg
            ne = self.n_live
            if ne == 0:
                return 0
            r_off = int(host_read(self.state.r_off.item))
            new_r_off = max(r_off, self.lcr - self.round_margin)
            rr = host_read(self.state.rr[:ne].cpu).numpy()
            rnd = host_read(self.state.round[:ne].cpu).numpy()
            seq = host_read(self.state.seq[:ne].cpu).numpy()
            creator = host_read(self.state.creator[:ne].cpu).numpy()
            s_off = host_read(self.state.s_off.cpu).numpy()
            dr = max(0, new_r_off - r_off)

            if head_seqs is None:
                # absolute head seq per creator: cnt counts the whole
                # history (compaction never decrements it)
                head_seqs = host_read(
                    self.state.cnt[: cfg.n].cpu).numpy() - 1
            ok = (
                (rr >= 0)
                & (rnd < new_r_off)
                & (np.arange(ne) + self.e_off < min_future_parent)
                & (seq < head_seqs[np.clip(creator, 0, cfg.n - 1)]
                   - self.seq_window)
            )
            k = int(np.argmin(ok)) if not ok.all() else ne
            if k < compact_min and dr == 0:
                return 0
            with stage("wide.compact.evict") as st:
                self._evict(k, ne, s_off, creator, dr)
            self._timed("compact", st)
            return k

    def _evict(self, k: int, ne: int, s_off: np.ndarray,
               creator: np.ndarray, dr: int) -> None:
        """Drop the first ``k`` of the window's ``ne`` live rows and
        ``dr`` rounds: rebase the state, the blocks and the march
        carry."""
        cfg, C = self.cfg, self.C
        # per-creator seq shifts from the evicted slot prefix
        dcount = np.bincount(creator[:k], minlength=cfg.n + 1)
        new_s_off = (s_off + dcount[: cfg.n + 1].astype(np.int32)).astype(
            np.int32
        )
        ds_np = (new_s_off[: cfg.n] - s_off[: cfg.n]).astype(np.int32)
        assert int(ds_np.max(initial=0)) < int(cfg.fd_inf) - 1, \
            "per-compaction seq shift exceeds coordinate dtype headroom"
        dev = self.device
        ds = host_read(torch.tensor, ds_np, device=dev)

        self.state = compact_state(
            cfg, self.state, k, host_read(torch.tensor, new_s_off,
                                          device=dev), dr,
        )
        j = _jits(cfg, C)
        w = j["width"]
        n = cfg.n
        ds_pad = (
            torch.cat([ds, torch.zeros((C * w - n,), dtype=I32, device=dev)])
            if C * w > n else ds
        )
        if _is_stacked(self.la_blocks):
            ds_stack = ds_pad.reshape(C, w)
            if self.shard is not None:
                ds_stack = ds_stack[self.shard.lo:self.shard.hi]
            self.la_blocks = j["compact_stacked"](
                self.la_blocks, k, ds_stack, False
            )
            self.fd_blocks = j["compact_stacked"](
                self.fd_blocks, k, ds_stack, True
            )
        else:
            self.la_blocks = tuple(
                j["compact_block"](self.la_blocks[c], k,
                                   ds_pad[c * w:(c + 1) * w], False)
                for c in range(C)
            )
            self.fd_blocks = tuple(
                j["compact_block"](self.fd_blocks[c], k,
                                   ds_pad[c * w:(c + 1) * w], True)
                for c in range(C)
            )
        if self.carry is not None:
            pt, cp = j["compact_march"](
                self.carry.pos_table, self.carry.cnt_prev, dr, ds,
            )
            self.carry = MarchCarry(pt, cp)
        self._rr_seen[: ne - k] = self._rr_seen[k:ne]
        self._rr_seen[ne - k:] = False
        self.e_off += k
        self.evicted += k
        _sync(self.state.sp)


def _padded_schedule(levels: np.ndarray, fill: int) -> np.ndarray:
    """Level schedule with empty rows dropped and shapes bucketed (rows
    to x64, width to pow2), as in JAX.  ``fill`` pads unused lanes (-1
    for batch schedules, e_cap-as-sentinel for direct slot
    schedules)."""
    with stage("wide.schedule"):
        sched = build_schedule(levels - levels.min())
        sched = sched[(sched >= 0).any(axis=1)]
        t, bw = sched.shape
        tp, bp = -(-t // 64) * 64, bucket(bw, 1)
        out = np.full((tp, bp), fill, np.int32)
        out[:t, :bw] = np.where(sched >= 0, sched, fill)
    return out


def slice_batch(dag, a: int, b: int, e_off: int,
                device="cuda") -> EventBatch:
    """ArrayDag[a:b) -> EventBatch with window-row parents, on
    ``device``.

    Slot order is topological (parents precede children), and within a
    batch the schedule groups by level value, so any cut is valid: a
    parent is either in an earlier batch (window row < current fill) or
    at a strictly lower level (scheduled earlier)."""
    k = b - a
    kpad = bucket(k)

    def pad1(x, fill, dtype):
        out = np.full(kpad, fill, dtype)
        out[:k] = x
        return out

    def loc(p):
        # global parent slot -> window row (negative = missing root)
        q = np.where(p[a:b] >= 0, p[a:b] - e_off, -1)
        if k and q.min(initial=0) < -1:
            raise ValueError("batch references an evicted parent slot")
        return pad1(q, -1, np.int32)

    def dev(x, **kw):
        # a copy from pageable host memory waits for the device's queue
        return host_read(torch.tensor, x, device=device, **kw)

    with stage("wide.slice_batch"):
        sched_p = _padded_schedule(dag.levels[a:b], -1)
        return EventBatch(
            sp=dev(loc(dag.sp)),
            op=dev(loc(dag.op)),
            creator=dev(pad1(dag.creator[a:b], 0, np.int32)),
            seq=dev(pad1(dag.seq[a:b], 0, np.int32)),
            ts=dev(pad1(dag.ts[a:b], 0, np.int64)),
            mbit=dev(pad1(dag.mbit[a:b], False, bool)),
            k=dev(k, dtype=I32),
            sched=dev(sched_p),
        )


def _past(stream: WideStream, late: bool) -> bool:
    """Whether any rank of the stream's mesh is past its deadline (this
    rank's own reading without a mesh)."""
    if stream.mesh is None:
        return late
    flag = host_read(torch.tensor, int(late), dtype=I32,
                     device=stream.device)
    return bool(host_read(stream.mesh.world.max(flag).item))


def stream_consensus(
    cfg: DagConfig,
    dag,
    batch_events: int,
    n_blocks: Optional[int] = None,
    round_margin: int = 0,
    seq_window: int = 64,
    compact_min: int = 1024,
    record_ordered: bool = True,
    log=None,
    stacked: bool = False,
    mesh=None,
    deadline_s: Optional[float] = None,
    registry: Optional[Registry] = None,
    device="cuda",
) -> WideStream:
    """Stream an ArrayDag (sim.arrays) through a rolling window:
    ingest -> consensus -> compact per mega-batch of ~batch_events.

    ``deadline_s`` (wall seconds from the call): stop cleanly after the
    current batch when exceeded, marking ``stats["truncated"]``.
    ``mesh``: the sharded stacked form (``WideStream``); every rank of
    the mesh calls this with the same arguments, and a deadline stops
    every rank once any rank's clock passes it."""
    stream = WideStream(cfg, n_blocks=n_blocks,
                        round_margin=round_margin, seq_window=seq_window,
                        record_ordered=record_ordered, stacked=stacked,
                        mesh=mesh, registry=registry, device=device)
    E = dag.n_events
    # suffix-min of parent slots: the eviction bound for "no future
    # batch references below here"
    par = np.minimum(
        np.where(dag.sp >= 0, dag.sp.astype(np.int64), np.iinfo(np.int64).max),
        np.where(dag.op >= 0, dag.op.astype(np.int64), np.iinfo(np.int64).max),
    )
    sufmin = (
        np.minimum.accumulate(par[::-1])[::-1] if E else np.zeros(0)
    )
    head_seqs = np.full(cfg.n, -1, np.int64)
    np.maximum.at(head_seqs, dag.creator, dag.seq)

    t_start = time.perf_counter()
    s_off_np = np.zeros(cfg.n, np.int64)
    a = 0
    bi = 0
    while a < E:
        if (deadline_s is not None and bi > 0
                and _past(stream, time.perf_counter() - t_start > deadline_s)):
            stream.stats["truncated"] = True
            stream.stats["events_ingested"] = a
            if log is not None:
                log(f"[stream] deadline {deadline_s:.0f}s hit after "
                    f"{bi} batches ({a}/{E} events) — stopping cleanly")
            break
        b = min(E, a + batch_events)
        batch = slice_batch(dag, a, b, stream.e_off, device=stream.device)
        # in-window chain depth must fit the ce table: the scatter in
        # _write_batch_fields clamps out-of-range columns into the dump
        # column, which would silently drop chain entries
        depth = int(np.max(dag.seq[a:b] - s_off_np[dag.creator[a:b]],
                           initial=0))
        if depth >= cfg.s_cap:
            raise ValueError(
                f"in-window chain depth {depth} >= s_cap {cfg.s_cap}: "
                "shrink batches, evict more (seq_window), or raise s_cap"
            )
        # window-wide fd sweep schedule (all live rows after this batch)
        fd_slot_sched = host_read(
            torch.tensor,
            _padded_schedule(dag.levels[stream.e_off: b], cfg.e_cap),
            device=stream.device,
        )
        stream.ingest(batch, fd_slot_sched=fd_slot_sched)
        fresh = stream.consensus(final=(b == E))
        evicted = stream.compact(
            min_future_parent=int(sufmin[b]) if b < E else E,
            head_seqs=head_seqs,
            compact_min=compact_min,
        )
        s_off_np[:] = host_read(stream.state.s_off[: cfg.n].cpu).numpy()
        bi += 1
        if log is not None:
            log(f"[stream] batch {bi}: +{b - a} events, ordered +{fresh} "
                f"(total {stream.ordered_total}), lcr={stream.lcr} "
                f"max_round={stream.stats.get('max_round')} "
                f"evicted +{evicted} (live {stream.n_live})")
        a = b
    return stream
