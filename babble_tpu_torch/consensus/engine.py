"""TorchHashgraph: the consensus engine, in torch (the port's twin of the
JAX package's ``TpuHashgraph``, every method name kept).

Host/device split:
- Host (``core.dag.HostDag``): hash <-> slot index, insert validation,
  level scheduling, the final sort and the commit.
- Device (``ops.*``): the dense DagState tensors and the pipeline —
  ingest (coordinates + rounds), decide_fame, decide_order.

``insert_event`` only indexes on the host; device ingest happens at the
next consensus call (or an explicit ``flush``), so a gossip sync's worth
of events rides one batch.  Batch shapes are bucketed to powers of two,
as in JAX, where each bucket is one compiled program.

Each ``run_consensus`` picks one of two surfaces:
- **latency**: the live flush (``ops/flush.py``: incremental ingest, then
  fame and order over a window of W open rounds and an F-row event
  frontier) for gossip-sized batches;
- **throughput**: the full-table phases (ingest with fd mode
  ``"incremental"`` or ``"full"``, ``decide_fame_auto``,
  ``decide_order``) for bulk batches and any shape the window cannot
  cover.
Both commit the same order on the same flush sequence.

Membership plane: a committed, subject-signed join or leave
(``membership/transition.py``) schedules an epoch transition at the
decided-round boundary ``round_received + EPOCH_LAG``; later ones queue
behind it.  Commits above a pending boundary are held until the engine
re-shapes (``apply_epoch_transition``: a join appends a participant
column, a leave retires one) and re-decides them under the new peer
set.  ``membership_log`` is the chain of custody a joiner verifies.

Not in this port yet: the AOT executable map (ROADMAP.md Queue 1, item
10, CUDA graphs).  Entry points run on ``device`` ("cuda" unless the
caller asks for the CPU).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..common import OffsetList
from ..core.dag import HostDag
from ..core.event import Event, WireEvent
from ..membership.transition import MEMBERSHIP_MAGIC, parse_membership_tx
from ..ops import fame as fame_ops
from ..ops import flush as flush_ops
from ..ops import ingest as ingest_ops
from ..ops import order as order_ops
from ..ops.state import (
    FAME_TRUE,
    FAME_UNDEFINED,
    HEAD_GATE_HORIZON,
    INT32_MAX,
    DagConfig,
    DagState,
    bucket,
    compact as compact_op,
    grow_state,
    init_state,
    state_from_numpy,
    ts32_ok,
)
from .digest import CommitDigest
from .ordering import consensus_sort

_FD_FULL_THRESHOLD = 2048  # batch size above which full FD recompute wins

#: pending-batch size above which the throughput path wins over the
#: latency flush (gossip flushes are tens of events; catch-up ships
#: thousands)
LATENCY_K_MAX = 256

#: membership plane: a committed transition takes effect at decided
#: round ``round_received(tx) + EPOCH_LAG``
EPOCH_LAG = 2

#: most transitions queued behind the pending boundary; equal to
#: ``membership.epoch.PIPELINE_WINDOW`` (the verifier accepts exactly
#: this stamp window)
MEMBERSHIP_QUEUE_MAX = 64

#: membership_log entries kept after truncation; older entries fold
#: into (membership_base_epoch, membership_addrs)
MEMBERSHIP_LOG_KEEP = 256


def node_engine_kwargs(cache_size: int = 500) -> dict:
    """The engine settings a live ``Node`` of the JAX package builds
    through its ``Core`` (node/node.py, node/core.py) for a given
    ``cache_size`` (the node's default is 500)."""
    return dict(
        e_cap=max(cache_size, 64),
        auto_compact=bool(cache_size),
        seq_window=cache_size or 256,
        consensus_window=2 * cache_size if cache_size else None,
        finality_gate=True,
        kernel_class="auto",
        inactive_rounds=32,
        packed_votes=True,
        frontier=True,
    )


class TorchHashgraph:
    def __init__(
        self,
        participants: Dict[str, int],
        commit_callback: Optional[Callable[[List[Event]], None]] = None,
        verify_signatures: bool = True,
        e_cap: int = 4096,
        s_cap: int = 1024,
        r_cap: int = 64,
        auto_compact: bool = False,
        seq_window: int = 256,
        round_margin: int = 2,
        compact_min: Optional[int] = None,
        consensus_window: Optional[int] = None,
        finality_gate: bool = False,
        ts32: bool = False,
        kernel_class: str = "auto",
        inactive_rounds: Optional[int] = 32,
        packed_votes: bool = True,
        frontier: bool = True,
        device="cuda",
    ):
        n = len(participants)
        self.participants = participants
        self.commit_callback = commit_callback
        self.dag = HostDag(participants, verify_signatures=verify_signatures)
        self.device = torch.device(device)
        # packed_votes rides the DagConfig (it selects kernel math);
        # frontier is engine policy (it only sizes the F bucket the
        # order phase scans).  Both keep results bit-identical.
        self.cfg = DagConfig(n=n, e_cap=e_cap, s_cap=s_cap, r_cap=r_cap,
                             ts32=ts32, packed=packed_votes)
        self.state: DagState = init_state(self.cfg, device=self.device)
        self.frontier = frontier
        # host mirror of the reception frontier: a monotone lower bound
        # on the first live slot with rr undecided (it only sizes the F
        # bucket; under-counting is safe, over-counting would skip
        # receptions)
        self._frontier_cache = 0

        # finality_gate: a round's fame decides only once every chain's
        # head round has passed it (the live node runs gated);
        # kernel_class: "auto" picks the latency flush for gossip-sized
        # batches and the throughput phases for bulk ones, "latency" /
        # "throughput" pin one; ts32: int32 relative timestamps in the
        # order median (span guard in build_batch)
        if kernel_class not in ("auto", "latency", "throughput"):
            raise ValueError(f"unknown kernel_class {kernel_class!r}")
        self.finality_gate = finality_gate
        self.kernel_class = kernel_class
        self.last_kernel_class: Optional[str] = None
        self._max_round_cache = -1        # host mirror of state.max_round
        self._ts_lo: Optional[int] = None  # ts32 span guard mirrors
        self._ts_hi: Optional[int] = None

        # rolling-window policy (reference caches.go semantics):
        # - seq_window: newest events per creator always kept
        # - round_margin: decided rounds kept below lcr
        # - compact_min: evictable-prefix length worth a compaction pass
        # - consensus_window: committed-log entries kept (None = all)
        self.auto_compact = auto_compact
        self.seq_window = seq_window
        self.round_margin = round_margin
        self.compact_min = compact_min if compact_min is not None else max(
            e_cap // 4, 32
        )
        self.consensus_window = consensus_window
        # per-creator eviction: a creator whose chain head is more than
        # inactive_rounds decided rounds behind lcr loses its seq_window
        # retention (None disables)
        self.inactive_rounds = inactive_rounds
        #: creators whose whole retained window has been evicted
        self._evicted_creators_cache = 0
        #: flushes where the latency window could not cover the
        #: undecided round span (deferred in place under a stalled gate,
        #: or finished on the throughput surface)
        self.flush_fallbacks = 0
        self._fallback_counted = False   # per-flush dedup
        #: per-flush bytes-touched estimate ({"ingest","fame","order",
        #: "total"}, ops/flush.py) and the phase timings of the last
        #: probed flush; None when nothing flushed
        self.last_flush_bytes: Optional[dict] = None
        self._last_phase_timings: Optional[dict] = None
        #: run the latency flush as three synchronised, timed phases
        #: (``ops/flush.probed_flush``; the same result)
        self.phase_probe = False

        # membership plane: the validator set is consensus state (module
        # docstring)
        self.epoch = 0
        self.pending_membership: Optional[dict] = None
        self.membership_log: List[dict] = []
        self.membership_rejects = 0
        #: transitions committed while one is pending, applied FIFO at
        #: successive boundaries
        self.membership_queue: List[dict] = []
        #: bounded membership_log: base epoch + truncated-join addresses
        self.membership_log_keep = MEMBERSHIP_LOG_KEEP
        self.membership_base_epoch = 0
        self.membership_addrs: Dict[str, str] = {}
        #: wall split of the last apply_epoch_transition (None before one)
        self.last_transition: Optional[dict] = None

        self.consensus = OffsetList()             # hex ids in consensus order
        #: rolling hash chain over the committed order
        self._digest = CommitDigest()
        self.consensus_transactions = 0
        self.last_committed_round_events = 0
        self._received: set = set()               # global slots already ordered
        self._ordered_total = 0                   # |_received| incl. evicted
        self._view: Dict[str, np.ndarray] = {}    # host copies of state tensors
        self._lcr_cache = -1                      # host mirror for lock-free stats
        self._r_off = 0                           # host mirror of state.r_off

    # ------------------------------------------------------------------
    # properties mirroring the oracle/reference

    @property
    def n(self) -> int:
        return self.cfg.n

    def super_majority(self) -> int:
        return self.cfg.super_majority

    @property
    def last_consensus_round(self) -> Optional[int]:
        self.flush()
        lcr = int(self.state.lcr)
        self._lcr_cache = lcr
        return None if lcr < 0 else lcr

    @property
    def undetermined_count(self) -> int:
        self.flush()
        return self.dag.n_events - self._ordered_total

    def stats_snapshot(self) -> Dict[str, int]:
        """Stats from host mirrors only (no flush, no device reads)."""
        return {
            "last_consensus_round": self._lcr_cache,
            "undetermined_events": self.dag.n_events - self._ordered_total,
            "consensus_events": len(self.consensus),
            "consensus_transactions": self.consensus_transactions,
            "last_committed_round_events": self.last_committed_round_events,
            "evicted_events": self.dag.slot_base,
            "live_window": self.dag.n_events - self.dag.slot_base,
            "evicted_creators": self._evicted_creators_cache,
            "epoch": self.epoch,
            "membership_transitions": self.epoch,
        }

    # ------------------------------------------------------------------
    # commit digest

    @property
    def commit_digest(self) -> str:
        """Digest over the full committed order so far (O(1) state)."""
        return self._digest.head

    @property
    def commit_length(self) -> int:
        return self._digest.length

    def commit_digest_at(self, position: int) -> Optional[str]:
        """Digest after the first ``position`` commits; None when the
        position is ahead of us or rolled off history."""
        return self._digest.digest_at(position)

    # ------------------------------------------------------------------
    # ingestion

    def insert_event(self, event: Event) -> None:
        self.dag.insert(event)

    def _check_narrow_seq_range(self) -> None:
        """la/fd hold absolute seqs, which compaction never rebases:
        narrow coordinates are only sound while every chain head is
        clear of the dtype's INF sentinel."""
        if not (self.cfg.coord16 or self.cfg.coord8):
            return
        head = max((len(c) for c in self.dag.chains), default=0)
        if head >= int(self.cfg.fd_inf) - 1:
            raise OverflowError(
                f"narrow-coordinate engine exceeded seq range (head seq "
                f"{head}); rebuild with wider coordinates"
            )

    def flush(self) -> None:
        """Push pending host events through the device ingest pipeline."""
        if not self.dag.pending:
            return
        self._check_narrow_seq_range()
        batch, fd_mode = self.build_batch()
        self.state = ingest_ops.ingest_impl(self.cfg, self.state, fd_mode,
                                            batch)
        self._view = {}
        # round-capacity saturation: if the highest assigned round is at
        # the capacity edge, witness-table writes may have clipped — grow
        # the window and recompute the suspect suffix
        self._max_round_cache = int(self.state.max_round)
        if self._max_round_cache - self._r_off >= self.cfg.r_cap - 1:
            self._repair_rounds()

    def _repair_rounds(self) -> None:
        """Double r_cap and recompute rounds for events whose assignment may
        have clipped: exactly ``round >= r_off + old_r_cap`` (descendants
        of a wrong event carry a stored round >= their wrong parent's),
        rescanned level by level against the intact lower witness rows."""
        base = self.dag.slot_base
        while True:
            old_r_cap = self.cfg.r_cap
            new_cfg = self.cfg._replace(r_cap=old_r_cap * 2)
            self.state = grow_state(self.state, self.cfg, new_cfg)
            self.cfg = new_cfg
            self._view = {}

            rnd = self._arr("round")
            ne = self.dag.n_events - base
            sus = np.nonzero(
                rnd[:ne] >= self._r_off + old_r_cap
            )[0].astype(np.int32)
            if len(sus):
                self.state = ingest_ops.rescan_rounds_impl(
                    self.cfg, self.state,
                    torch.tensor(self._level_sched(sus), device=self.device),
                )
                self._view = {}
            self._max_round_cache = int(self.state.max_round)
            if self._max_round_cache - self._r_off < self.cfg.r_cap - 1:
                return

    def build_batch(self):
        """Drain pending host events into a padded EventBatch on the
        engine's device.  Returns (batch, fd_mode).  Every tensor is a
        copy: none shares memory with the host arrays."""
        k = len(self.dag.pending)
        self._ensure_capacity(k)
        sp, op, creator, seq, ts, mbit, sched = self.dag.take_pending()
        if self.cfg.ts32 and k:
            # span guard for the int32 relative-timestamp median
            lo, hi = int(ts.min()), int(ts.max())
            self._ts_lo = lo if self._ts_lo is None else min(self._ts_lo, lo)
            self._ts_hi = hi if self._ts_hi is None else max(self._ts_hi, hi)
            if not ts32_ok(self._ts_lo, self._ts_hi):
                raise OverflowError(
                    f"ts32 engine exceeded the int32 timestamp span "
                    f"({self._ts_hi - self._ts_lo} ns): rebuild with "
                    "ts32=False (wall-clock fleets must keep i64)"
                )

        kpad = bucket(k)
        t, b = sched.shape
        tpad, bpad = bucket(t, 1), bucket(b, 1)
        dev = self.device

        def pad1(a, fill, dtype):
            out = np.full(kpad, fill, dtype)
            out[:k] = a
            return torch.tensor(out, device=dev)

        sched_p = np.full((tpad, bpad), -1, np.int32)
        sched_p[:t, :b] = sched

        batch = ingest_ops.EventBatch(
            sp=pad1(sp, -1, np.int32),
            op=pad1(op, -1, np.int32),
            creator=pad1(creator, 0, np.int32),
            seq=pad1(seq, 0, np.int32),
            ts=pad1(ts, 0, np.int64),
            mbit=pad1(mbit, False, bool),
            k=torch.tensor(k, dtype=torch.int32, device=dev),
            sched=torch.tensor(sched_p, device=dev),
        )
        fd_mode = "full" if k > _FD_FULL_THRESHOLD else "incremental"
        return batch, fd_mode

    def _ensure_capacity(self, k_new: int) -> None:
        cfg = self.cfg
        # live (windowed) extents — capacities bound the window, not history
        need_e = self.dag.n_events - self.dag.slot_base
        max_chain = max(
            (len(c) - c.start for c in self.dag.chains), default=0
        )
        # a level raises the max round by at most 1, but a round spans
        # several levels, so r_cap is sized by a quarter of the levels;
        # undershoot is safe (flush repairs saturation)
        levels_new = len({self.dag.levels[s] for s in self.dag.pending})
        need_r = (
            max(int(self.state.max_round) - self._r_off, 0)
            + 2
            + min(levels_new, max(8, levels_new // 4))
        )

        e_cap, s_cap, r_cap = cfg.e_cap, cfg.s_cap, cfg.r_cap
        while need_e > e_cap:
            e_cap *= 2
        while max_chain >= s_cap:
            s_cap *= 2
        while need_r >= r_cap:
            r_cap *= 2
        if (e_cap, s_cap, r_cap) != (cfg.e_cap, cfg.s_cap, cfg.r_cap):
            new_cfg = cfg._replace(e_cap=e_cap, s_cap=s_cap, r_cap=r_cap)
            self.state = grow_state(self.state, cfg, new_cfg)
            self.cfg = new_cfg
            self._view = {}

    # ------------------------------------------------------------------
    # consensus pipeline

    def divide_rounds(self) -> None:
        # rounds are assigned during ingest; dividing == flushing
        self.flush()

    def decide_fame(self) -> None:
        self.flush()
        # batch_window=False: the live engine rolls windows
        self.state = fame_ops.decide_fame_auto_impl(
            self.cfg, self.state, False, self.finality_gate
        )
        self._view = {}

    def find_order(self) -> List[Event]:
        self.flush()
        self.state = order_ops.decide_order_impl(self.cfg, self.state)
        self._view = {}
        return self._collect_ordered()

    def _collect_ordered(self) -> List[Event]:
        """Host half of the order phase, shared by both surfaces: read
        rr/cts, commit newly received events in consensus_sort order,
        roll the window.

        The JAX engine walks the live rows in slot order in Python; this
        takes the same rows in the same order with numpy.  Every
        candidate gets its round_received and consensus_timestamp.
        Membership commit gate: while a transition is pending at
        boundary B, events received in rounds > B are held (not
        committed, not marked received); they are re-decided under the
        new peer set once the epoch applies."""
        rr = self._arr("rr")
        cts = self._arr("cts")
        base = self.dag.slot_base
        ne = self.dag.n_events - base          # live rows
        self._lcr_cache = int(self.state.lcr)
        # reception-frontier mirror: first live row still undecided (a
        # monotone lower bound for every later flush)
        und = rr[:ne] < 0
        self._frontier_cache = int(np.argmax(und)) if und.any() else int(ne)
        got = np.nonzero(~und)[0]
        if self._received and len(got):
            seen = np.fromiter(self._received, np.int64, len(self._received))
            got = got[~np.isin(got + base, seen)]
        if not len(got):
            self._maybe_apply_membership()
            if self.auto_compact:
                self.maybe_compact()
            return []

        candidates: List[Event] = []
        for s in got.tolist():
            ev = self.dag.events[base + s]
            ev.round_received = int(rr[s])
            ev.consensus_timestamp = int(cts[s])
            candidates.append(ev)

        candidates = consensus_sort(candidates, self._round_prn)
        new_events: List[Event] = []
        for ev in candidates:
            pend = self.pending_membership
            if pend is not None and ev.round_received > pend["boundary"]:
                # held: re-received and committed by the next epoch
                continue
            new_events.append(ev)
            self._received.add(self.dag.slot_of[ev.hex()])
            self.consensus.append(ev.hex())
            self._digest.note(ev.hex())
            self.consensus_transactions += len(ev.transactions)
            self._maybe_schedule_membership(ev)
        self._ordered_total += len(new_events)

        lcr = int(self.state.lcr)
        self._lcr_cache = lcr
        if lcr >= 1:
            rounds = self._arr("round")
            self.last_committed_round_events = int(
                np.count_nonzero(rounds[:ne] == lcr - 1)
            )

        if self.commit_callback is not None and new_events:
            self.commit_callback(new_events)
        self._maybe_apply_membership()
        if self.auto_compact:
            self.maybe_compact()
        return new_events

    def run_consensus(self) -> List[Event]:
        events, _ = self.run_consensus_timed()
        return events

    def run_consensus_timed(self) -> Tuple[List[Event], Dict[str, float]]:
        """One full consensus pass on the latency or the throughput
        surface (module docstring); ``last_kernel_class`` records the
        pick.  Each dispatch runs inside a ``record_function`` region
        (the JAX engine's TraceAnnotation names), and
        ``last_flush_bytes`` carries the flush's traffic estimate."""
        k_pending = len(self.dag.pending)
        t0 = time.perf_counter()
        if self._latency_ok():
            # _flush_live overwrites this with "throughput" when it
            # degrades to the full-table phases
            self.last_kernel_class = "latency"
            with record_function("babble_flush_latency"):
                events = self._flush_live()
            out = {"flush_s": time.perf_counter() - t0}
            if self._last_phase_timings:
                out.update(self._last_phase_timings)
            return events, out
        self.last_kernel_class = "throughput"
        with record_function("babble_flush_ingest"):
            self.divide_rounds()
        t1 = time.perf_counter()
        with record_function("babble_flush_fame"):
            self.decide_fame()
        t2 = time.perf_counter()
        with record_function("babble_flush_order"):
            events = self.find_order()
        t3 = time.perf_counter()
        if k_pending:
            self.last_flush_bytes = flush_ops.throughput_bytes_estimate(
                self.cfg, k_pending
            )
        return events, {
            "divide_rounds_s": t1 - t0,
            "decide_fame_s": t2 - t1,
            "find_order_s": t3 - t2,
        }

    def _latency_ok(self) -> bool:
        """Host-mirror-only check (no device read) that the latency flush
        can cover this flush exactly."""
        if self.kernel_class == "throughput":
            return False
        k = len(self.dag.pending)
        if self.kernel_class == "auto" and k > LATENCY_K_MAX:
            return False
        # the windowed median runs unchunked
        if (self.cfg.e_cap + 1) * self.cfg.n > order_ops.MEDIAN_CHUNK_THRESHOLD:
            return False
        # open rounds the window must cover: the undecided span plus what
        # this batch can add (a round spans about 4 levels; an
        # underestimate defers rounds to the next flush)
        levels_new = len({self.dag.levels[s] for s in self.dag.pending})
        est = (
            self._max_round_cache - max(self._lcr_cache, -1)
            + max(2, levels_new // 4 + 1)
        )
        if self.finality_gate and est > HEAD_GATE_HORIZON + 2:
            # stalled-gate cap: rounds beyond head_round_min + 1 cannot
            # decide while the gate stalls, so a window of the staleness
            # horizon is all fame/order can use
            self.flush_fallbacks += 1
            self._fallback_counted = True
            est = HEAD_GATE_HORIZON + 2
        else:
            self._fallback_counted = False
        w = flush_ops.bucket_w(max(est, 1), self.cfg.r_cap)
        if w == 0:
            return False
        # the window slice must fit below the round-capacity edge with
        # saturation headroom (the throughput path owns round repair)
        top = max(self._lcr_cache + 1, 0) - self._r_off + w
        if top > self.cfg.r_cap - 1:
            return False
        if self._max_round_cache + levels_new - self._r_off \
                >= self.cfg.r_cap - 2:
            return False
        self._latency_w = w
        return True

    def _frontier_f(self) -> int:
        """Frontier bucket for this flush: a power-of-two cover of every
        event row from the first undecided slot (host lower-bound mirror)
        through the batch; full height e_cap+1 with frontier=False."""
        e1 = self.cfg.e_cap + 1
        if not self.frontier:
            return e1
        live = self.dag.n_events - self.dag.slot_base
        f = flush_ops.bucket_f(live - self._frontier_cache, e1)
        self._last_frontier_f = f
        return f

    def _flush_live(self) -> List[Event]:
        """One latency flush: build the (possibly empty) bucketed batch,
        run the live flush, refresh the host mirrors, commit."""
        self._check_narrow_seq_range()
        w = self._latency_w
        k_pending = len(self.dag.pending)
        batch, _ = self.build_batch()
        # sized after build_batch: its _ensure_capacity may have grown
        # e_cap, and bucket_f clamps against e1
        f = self._frontier_f()
        self._last_phase_timings = None
        if self.phase_probe:
            self.state, self._last_phase_timings = flush_ops.probed_flush(
                self.cfg, w, f, self.finality_gate, self.state, batch
            )
        else:
            self.state = flush_ops.live_flush(
                self.cfg, w, f, self.finality_gate, self.state, batch
            )
        self.last_flush_bytes = flush_ops.flush_bytes_estimate(
            self.cfg, w, k_pending, f
        )
        self._view = {}
        lcr_pre = self._lcr_cache
        self._max_round_cache = int(self.state.max_round)
        if self._max_round_cache - self._r_off >= self.cfg.r_cap - 1:
            # the headroom check should make this unreachable; degrade to
            # the repairing throughput path rather than trust clipped rounds
            self.last_kernel_class = "throughput"
            self._book_fallback_bytes()
            self._repair_rounds()
            self.decide_fame()
            return self.find_order()
        if self._max_round_cache > max(lcr_pre, -1) + w:
            if not self._fallback_counted:
                self.flush_fallbacks += 1
            if (self.finality_gate
                    and self._head_round_min_host() <= max(lcr_pre, -1) + w):
                # stalled finality gate: rounds above the window top are
                # beyond the head-round minimum and cannot decide on any
                # surface this flush, so defer them in place
                return self._collect_ordered()
            # the W estimate undershot: run_consensus runs to completion,
            # so finish with the full-table phases
            self.last_kernel_class = "throughput"
            self._book_fallback_bytes()
            self.decide_fame()
            return self.find_order()
        return self._collect_ordered()

    def _book_fallback_bytes(self) -> None:
        """A latency flush degrading to the full-table phases touches the
        windowed bytes and the r_cap tables (the batch already ingested,
        so the throughput term carries k=0)."""
        lat = self.last_flush_bytes or {}
        thr = flush_ops.throughput_bytes_estimate(self.cfg, 0)
        self.last_flush_bytes = {
            k: lat.get(k, 0) + thr[k] for k in thr
        }

    def _head_round_min_host(self) -> int:
        """Host mirror of ops.state.head_round_min_math (same chain and
        staleness semantics): the round below which the finality gate
        can still decide.  INT32_MAX when every minted chain is stale."""
        base = self.dag.slot_base
        rnd = self._arr("round")
        out = None
        for chain in self.dag.chains:
            if len(chain) == 0 or not chain.window:
                hr = -1   # never minted, or tail evicted: stale once the
                          # fleet is >HORIZON rounds ahead
            else:
                hr = int(rnd[chain[-1] - base])
            if hr + HEAD_GATE_HORIZON < self._max_round_cache:
                continue
            out = hr if out is None else min(out, hr)
        return int(INT32_MAX) if out is None else out

    # ------------------------------------------------------------------
    # membership plane: validator join/leave as a consensus operation

    def _maybe_schedule_membership(self, ev: Event) -> None:
        """Scan one just-committed event for valid membership
        transactions.  The first valid one with no transition in flight
        becomes the pending transition at boundary rr + EPOCH_LAG; later
        ones queue behind it.  Runs on the commit path, so every check
        is deterministic: the same transaction is queued (or rejected)
        identically everywhere."""
        for tx in ev.transactions:
            if not tx.startswith(MEMBERSHIP_MAGIC):
                continue
            spec = parse_membership_tx(tx)
            err = self._validate_membership(spec)
            if err is not None:
                self.membership_rejects += 1
                continue
            entry = {
                "kind": spec.kind,
                "pub": spec.pub_hex,
                "addr": spec.net_addr,
                "boundary": ev.round_received + EPOCH_LAG,
                "position": len(self.consensus),
                "tx": bytes(tx),
            }
            if self.pending_membership is None:
                self.pending_membership = entry
            else:
                self.membership_queue.append(entry)

    def _in_flight_membership(self) -> List[dict]:
        head = [self.pending_membership] if self.pending_membership else []
        return head + list(self.membership_queue)

    def _validate_membership(self, spec) -> Optional[str]:
        """Admissibility of a parsed transition against the projected
        epoch state (the current peer set with every in-flight
        transition applied).  The epoch stamp may name any epoch from
        the current one through the projected apply epoch; a stale stamp
        is rejected."""
        if spec is None:
            return "unparseable transition"
        queue = self._in_flight_membership()
        if len(queue) >= MEMBERSHIP_QUEUE_MAX:
            return "transition queue full"
        apply_epoch = self.epoch + len(queue)
        if not (self.epoch <= spec.epoch <= apply_epoch):
            return (
                f"transition stamped epoch {spec.epoch}, valid range "
                f"[{self.epoch}, {apply_epoch}]"
            )
        known = set(self.participants)
        active = {
            pub for pub, cid in self.participants.items()
            if cid not in self.cfg.retired
        }
        for q in queue:
            if q["kind"] == "join":
                known.add(q["pub"])
                active.add(q["pub"])
            else:
                active.discard(q["pub"])
        if spec.kind == "join":
            if spec.pub_hex in known:
                return "join for an existing or queued participant"
        else:
            if spec.pub_hex not in known:
                return "leave for an unknown participant"
            if spec.pub_hex not in active:
                return "leave for a retired or already-leaving participant"
            if len(active) - 1 < 2:
                return "leave would drop the fleet below 2 members"
        if not spec.verify():
            return "bad subject signature"
        return None

    def _maybe_apply_membership(self) -> None:
        if self.pending_membership is None:
            return
        if int(self.state.lcr) >= self.pending_membership["boundary"]:
            self.apply_epoch_transition()

    def apply_epoch_transition(self) -> None:
        """Re-shape the engine at the epoch boundary: every event
        received in rounds <= B is committed (apply requires lcr >= B),
        so decided history below B stays under the outgoing peer set and
        everything above is reset and re-decided under the incoming one.

        Join appends one participant column (survivor ids are stable);
        leave retires the column in the config.  The host image of the
        re-shaped state is copied onto the device (no tensor of the new
        state shares memory with the host arrays, or with the old
        state), then the rounds above the boundary are rescanned.
        ``last_transition`` records its wall seconds, split into host,
        upload and rescan, and the suspect count."""
        from ..ops.epoch import epoch_transition_arrays

        t0 = time.perf_counter()
        spec = self.pending_membership
        boundary = spec["boundary"]
        old_cfg = self.cfg

        # suspects must be read before the reset wipes their rounds
        base = self.dag.slot_base
        ne = self.dag.n_events - base
        rnd = self._arr("round")
        suspects = np.nonzero(rnd[:ne] > boundary)[0].astype(np.int32)

        if spec["kind"] == "join":
            cid = self.dag.add_participant(spec["pub"])
            new_cfg = old_cfg._replace(n=old_cfg.n + 1)
        else:
            cid = self.participants[spec["pub"]]
            new_cfg = old_cfg._replace(
                retired=old_cfg.retired + (cid,)
            )

        arrays = epoch_transition_arrays(
            old_cfg, new_cfg, self.state, boundary
        )
        t1 = time.perf_counter()
        self.cfg = new_cfg
        self.state = state_from_numpy(new_cfg, DagState(**arrays),
                                      device=self.device)
        self._view = {}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        if len(suspects):
            self.state = ingest_ops.rescan_rounds_impl(
                self.cfg, self.state,
                torch.tensor(self._level_sched(suspects), device=self.device),
            )
            self._view = {}
        self._max_round_cache = int(self.state.max_round)
        self._lcr_cache = int(self.state.lcr)
        t3 = time.perf_counter()
        self.last_transition = {
            "wall_s": t3 - t0, "host_s": t1 - t0, "upload_s": t2 - t1,
            "rescan_s": t3 - t2, "suspects": int(len(suspects)),
        }
        # the reset wiped rr above the boundary: held events are
        # undecided again, so the frontier mirror drops to the floor
        self._frontier_cache = 0
        self.epoch += 1
        self.membership_log.append({
            "epoch": self.epoch,
            "kind": spec["kind"],
            "pub": spec["pub"],
            "addr": spec["addr"],
            "boundary": boundary,
            "position": spec["position"],
            "cid": cid,
            "tx": spec["tx"],
        })
        self._truncate_membership_log()
        self.pending_membership = None
        if self.membership_queue:
            # promote the next queued transition; its boundary must clear
            # the one just applied
            nxt = dict(self.membership_queue.pop(0))
            nxt["boundary"] = max(nxt["boundary"], boundary + 1)
            self.pending_membership = nxt

    def _truncate_membership_log(self) -> None:
        """Bound membership_log: fold entries past the retention window
        into (membership_base_epoch, membership_addrs)."""
        keep = self.membership_log_keep
        if not keep or len(self.membership_log) <= keep:
            return
        cut = self.membership_log[:-keep]
        for e in cut:
            if e["kind"] == "join":
                self.membership_addrs[e["pub"]] = e["addr"]
        self.membership_base_epoch = cut[-1]["epoch"]
        self.membership_log = self.membership_log[-keep:]

    def _level_sched(self, sus: np.ndarray) -> np.ndarray:
        """Level-grouped rescan schedule for local slots ``sus`` (the
        shape rescan_rounds_impl consumes; shared by round repair and
        epoch transitions)."""
        base = self.dag.slot_base
        lev = np.array(
            [self.dag.levels[base + int(s)] for s in sus], np.int64
        )
        order = np.argsort(lev, kind="stable")
        ulev, starts = np.unique(lev[order], return_index=True)
        bounds = list(starts) + [len(sus)]
        t = len(ulev)
        b = max(int(np.max(np.diff(bounds))), 1)
        tpad, bpad = bucket(t, 1), bucket(b, 1)
        slot_sched = np.full((tpad, bpad), -1, np.int32)
        for row in range(t):
            grp = sus[order[bounds[row]: bounds[row + 1]]]
            slot_sched[row, : len(grp)] = grp
        return slot_sched

    # ------------------------------------------------------------------
    # rolling-window compaction (reference caches.go:45-76 applied to the
    # dense device state; see ops/state.py compact_impl)

    def maybe_compact(self, force: bool = False) -> int:
        """Evict the longest committed prefix that nothing can reference
        again, and roll the round window up to ``lcr - round_margin``.

        A slot is evictable when (a) it is committed, (b) its round is
        below the new round-window base, and (c) it sits ``seq_window``
        seqs behind its creator's head — or its creator is inactive
        (head round more than ``inactive_rounds`` decided rounds behind
        lcr), in which case ``dag.evicted_heads`` records the eviction
        horizon its return resumes from.  Returns the evicted count; a
        no-op while host events are pending and while a membership
        transition is pending (held commits must not be mistaken for an
        evictable prefix)."""
        if self.dag.pending or self.pending_membership is not None:
            return 0
        lcr = int(self.state.lcr)
        new_r_off = lcr - self.round_margin
        if new_r_off <= 0:
            return 0
        base = self.dag.slot_base
        ne = self.dag.n_events - base
        dr = max(0, new_r_off - self._r_off)

        rr = self._arr("rr")[:ne]
        rnd = self._arr("round")[:ne]
        seq = self._arr("seq")[:ne]
        creator = self._arr("creator")[:ne]
        counts = np.fromiter(
            (len(c) for c in self.dag.chains), np.int64, self.n
        )
        past_window = seq < counts[creator] - self.seq_window
        if self.inactive_rounds is not None:
            inactive = np.zeros(self.n + 1, bool)
            for c, chain in enumerate(self.dag.chains):
                if not chain.window:
                    continue
                head_round = int(rnd[chain[-1] - base])
                inactive[c] = head_round < lcr - self.inactive_rounds
            past_window = past_window | inactive[creator]
        ok = (rr >= 0) & (rnd < new_r_off) & past_window
        k = int(np.argmin(ok)) if not ok.all() else ne
        if (k < self.compact_min and not force) or (k == 0 and dr == 0):
            return 0

        # host first: chain starts after eviction define the seq windows
        self.dag.evict_prefix(base + k)
        new_s_off = np.zeros(self.n + 1, np.int32)
        new_s_off[: self.n] = [c.start for c in self.dag.chains]
        self.state = compact_op(
            self.cfg, self.state, k,
            torch.tensor(new_s_off, device=self.device), dr,
        )
        self._received = {g for g in self._received if g >= base + k}
        self._r_off += dr
        # the evicted prefix is all received, so the frontier shifts
        # with the slots
        self._frontier_cache = max(self._frontier_cache - k, 0)
        self._view = {}
        self._evicted_creators_cache = sum(
            1 for c in self.dag.chains if len(c) and not c.window
        )
        if self.cfg.ts32:
            # rolling ts32 rebase: the span guard tracks the live window
            ne2 = self.dag.n_events - self.dag.slot_base
            ts = self._arr("ts")[:ne2]
            live = self._arr("seq")[:ne2] >= 0
            if live.any():
                self._ts_lo = int(ts[live].min())
                self._ts_hi = int(ts[live].max())
            else:
                self._ts_lo = self._ts_hi = None
        if self.consensus_window is not None:
            self.consensus.evict_to(
                max(self.consensus.start,
                    len(self.consensus) - self.consensus_window)
            )
            # keep the digest anchored at the trimmed window's start
            self._digest.evict_to(self.consensus.start)
        return k

    def _round_prn(self, r: int) -> int:
        """Whitening seed: XOR of the round's famous-witness hashes
        (reference roundInfo.go:109-118)."""
        r_loc = r - self._r_off
        if r_loc < 0 or r_loc >= self.cfg.r_cap:
            return 0
        wslot = self._arr("wslot")
        famous = self._arr("famous")
        base = self.dag.slot_base
        res = 0
        for j in range(self.n):
            if wslot[r_loc, j] >= 0 and famous[r_loc, j] == FAME_TRUE:
                res ^= int(
                    self.dag.events[base + int(wslot[r_loc, j])].hex(), 16
                )
        return res

    # ------------------------------------------------------------------
    # wire conversion

    def to_wire(self, event: Event) -> WireEvent:
        return self.dag.to_wire(event)

    def read_wire_info(self, wevent: WireEvent, overlay=None) -> Event:
        return self.dag.read_wire_info(wevent, overlay)

    # ------------------------------------------------------------------
    # predicate surface (host queries against the state; tests + runtime)

    def _arr(self, name: str) -> np.ndarray:
        """Host copy of a state tensor, cached until the state changes.
        Always a copy: on the CPU ``Tensor.numpy()`` shares memory, and
        the device ops write some state tensors in place."""
        if name not in self._view:
            self._view[name] = getattr(self.state, name).detach().to(
                "cpu", copy=True).numpy()
        return self._view[name]

    def _slot(self, x: str) -> int:
        """Device-local row of event hex x (KeyError if unknown/evicted)."""
        s = self.dag.slot_of.get(x, -1)
        if s < 0:
            raise KeyError(x)
        return s - self.dag.slot_base

    def _event_at(self, local_slot: int) -> Event:
        return self.dag.events[self.dag.slot_base + local_slot]

    def ancestor(self, x: str, y: str) -> bool:
        if x == "" or y == "":
            return False
        if x == y:
            return True
        self.flush()
        try:
            sx, sy = self._slot(x), self._slot(y)
        except KeyError:
            return False
        la = self._arr("la")
        ey = self._event_at(sy)
        cy = self.participants[ey.creator]
        return bool(la[sx, cy] >= ey.index)

    def see(self, x: str, y: str) -> bool:
        return self.ancestor(x, y)

    def self_ancestor(self, x: str, y: str) -> bool:
        if x == "" or y == "":
            return False
        if x == y:
            return True
        try:
            ex = self._event_at(self._slot(x))
            ey = self._event_at(self._slot(y))
        except KeyError:
            return False
        return ex.creator == ey.creator and ex.index >= ey.index

    def strongly_see(self, x: str, y: str) -> bool:
        self.flush()
        try:
            sx, sy = self._slot(x), self._slot(y)
        except KeyError:
            return False
        la, fd = self._arr("la"), self._arr("fd")
        return int(np.count_nonzero(la[sx] >= fd[sy])) >= self.super_majority()

    def oldest_self_ancestor_to_see(self, x: str, y: str) -> str:
        self.flush()
        try:
            sx, sy = self._slot(x), self._slot(y)
        except KeyError:
            return ""
        fd = self._arr("fd")
        ex = self._event_at(sx)
        j = self.participants[ex.creator]
        f = int(fd[sy, j])
        if f <= ex.index and f < int(self.cfg.fd_inf):
            return self.dag.events[self.dag.chains[j][f]].hex()
        return ""

    def round(self, x: str) -> int:
        self.flush()
        return int(self._arr("round")[self._slot(x)])

    def witness(self, x: str) -> bool:
        self.flush()
        return bool(self._arr("witness")[self._slot(x)])

    def round_witnesses(self, r: int) -> List[str]:
        self.flush()
        wslot = self._arr("wslot")
        r_loc = r - self._r_off
        if r_loc < 0 or r_loc >= self.cfg.r_cap:
            return []
        return [
            self._event_at(int(s)).hex() for s in wslot[r_loc] if s >= 0
        ]

    def famous_of(self, r: int, x: str) -> Optional[bool]:
        """Fame trilean of witness x in round r (None = undecided)."""
        self.flush()
        r_loc = r - self._r_off
        if r_loc < 0 or r_loc >= self.cfg.r_cap:
            return None
        wslot = self._arr("wslot")
        famous = self._arr("famous")
        sx = self._slot(x)
        for j in range(self.n):
            if wslot[r_loc, j] == sx:
                f = famous[r_loc, j]
                return None if f == FAME_UNDEFINED else bool(f == FAME_TRUE)
        return None

    def rounds(self) -> int:
        self.flush()
        return int(self.state.max_round) + 1

    # ------------------------------------------------------------------

    def known(self) -> Dict[int, int]:
        return self.dag.known()

    def consensus_events(self) -> List[str]:
        return list(self.consensus)

    def consensus_events_count(self) -> int:
        return len(self.consensus)
