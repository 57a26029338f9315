"""WideHashgraph: the windowed wide pipeline behind the live Core surface
(the port's twin of the JAX package's ``consensus/wide_engine.py``).

``stream_consensus`` (ops/stream.py) is a batch runner fed by generator
knowledge a live node cannot have: the suffix-min of future parent slots
and the whole-stream head seqs.  This engine replaces those inputs with
the **seq_window contract**:

- eviction keeps every creator's last ``seq_window`` events relative to
  its CURRENT head, the reference's rolling-cache bound
  (hashgraph/caches.go:45-76);
- a peer referencing anything older gets TooLateError through the sync
  path and must fast-forward;
- there is no ``min_future_parent`` oracle: an arriving event whose
  parent fell below the window is rejected at insert (HostDag refuses
  unknown parents).

Fame mid-stream uses the witness-set finality gate (ops/wide.py
``complete=False``): a round decides only once every chain's head round
passed it, so the committed order is scheduling-invariant.

The fused DagState holds la/fd as [E+1, N] tensors; this engine holds
them as per-block column slices (ops/wide.py) with window capacities
fixed at construction, so a live wide-N node runs in bounded memory.
It runs on ``device`` ("cuda" unless the caller asks for the CPU).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..common import OffsetList
from ..core.dag import HostDag
from ..core.event import Event
from ..obs import SIZE_BUCKETS
from ..ops.ingest import EventBatch
from ..ops.state import DagConfig, bucket as _bucket
from ..ops.stream import WideStream, _padded_schedule
from .digest import CommitDigest
from .engine import TorchHashgraph
from .ordering import consensus_sort

INT64_MAX = np.iinfo(np.int64).max


class WideHashgraph(TorchHashgraph):
    """Live honest-mode engine over the blocked rolling window.

    Capacities are FIXED at construction (cfg.e_cap = window capacity,
    cfg.s_cap = in-window chain depth): instead of growing, the engine
    compacts, and raises if a batch cannot fit even after compaction."""

    # no fused coordinate tensors -> no latency flush; the inherited
    # dispatcher always takes the three-phase branch through this
    # class's divide_rounds/decide_fame/find_order
    KERNEL_SPLIT = False
    kernel_class = "throughput"
    finality_gate = False

    def __init__(
        self,
        participants: Dict[str, int],
        commit_callback: Optional[Callable[[List[Event]], None]] = None,
        verify_signatures: bool = True,
        e_cap: int = 4096,
        s_cap: int = 128,
        r_cap: int = 32,
        n_blocks: Optional[int] = None,
        auto_compact: bool = True,
        seq_window: int = 64,
        round_margin: int = 1,
        compact_min: Optional[int] = None,
        consensus_window: Optional[int] = None,
        coord8: bool = False,
        registry=None,
        device="cuda",
    ):
        # no super().__init__: it would allocate the fused [E+1, N]
        # la/fd tensors this engine exists to avoid
        n = len(participants)
        self.participants = participants
        self.commit_callback = commit_callback
        self.dag = HostDag(participants, verify_signatures=verify_signatures)
        self.device = torch.device(device)
        self.cfg = DagConfig(n=n, e_cap=e_cap, s_cap=s_cap, r_cap=r_cap,
                             coord8=coord8)
        self.auto_compact = auto_compact
        self.seq_window = seq_window
        self.round_margin = round_margin
        self.compact_min = compact_min if compact_min is not None else max(
            e_cap // 4, 32
        )
        self.consensus_window = consensus_window

        self.stream = WideStream(
            self.cfg, n_blocks=n_blocks, round_margin=round_margin,
            seq_window=seq_window, record_ordered=False,
            registry=registry, device=self.device,
        )
        self.state = self.stream.state
        # flush telemetry: events per drained batch and the wall time of
        # the pad + device coords phase per drain
        self._bind_flush_histograms(self.stream.registry)

        self.consensus = OffsetList()
        self._digest = CommitDigest()
        self.inactive_rounds = None   # per-creator eviction: fused-only
        self._evicted_creators_cache = 0
        self.consensus_transactions = 0
        self.last_committed_round_events = 0
        self._received: set = set()
        self._ordered_total = 0
        self._view: Dict[str, np.ndarray] = {}
        self._lcr_cache = -1
        self._r_off = 0

    def _bind_flush_histograms(self, registry) -> None:
        self._m_flush_events = registry.histogram(
            "babble_wide_flush_events",
            "host events drained per wide-engine flush",
            buckets=SIZE_BUCKETS,
        )
        self._m_flush_seconds = registry.histogram(
            "babble_wide_flush_seconds",
            "wide-engine flush wall time (pad + device coords phase)",
        )

    def rebind_registry(self, registry) -> None:
        """Re-register flush + stage histograms on ``registry`` (called
        by Core after adopting this engine from a fast-forward snapshot
        or a checkpoint resume, which build engines with a private
        registry)."""
        self.stream.rebind_registry(registry)
        self._bind_flush_histograms(registry)

    # ------------------------------------------------------------------
    # ingest

    def flush(self) -> None:
        """Drain pending host events through the blocked coords phase."""
        if not self.dag.pending:
            return
        t_flush = time.perf_counter()
        k = len(self.dag.pending)
        if self.stream.n_live + k > self.cfg.e_cap:
            # compaction under pending events is safe up to the smallest
            # slot they still reference as a parent
            min_parent = min(
                (p for s in self.dag.pending
                 for p in (self.dag.sp_slot[s], self.dag.op_slot[s])
                 if p >= 0),
                default=INT64_MAX,
            )
            self.maybe_compact(force=True, min_future_parent=min_parent)
            if self.stream.n_live + k > self.cfg.e_cap:
                raise ValueError(
                    f"batch of {k} events overflows the window "
                    f"({self.stream.n_live} live / {self.cfg.e_cap} cap) "
                    "even after compaction — raise e_cap or gossip less "
                    "per sync"
                )
        # in-window chain depth must fit the ce table.  Checked BEFORE
        # the queue is drained: a refused batch stays pending so the
        # caller can recover.
        sp, op, creator, seq, ts, mbit, sched = self.dag.peek_pending()
        s_off = self.state.s_off[: self.cfg.n].cpu().numpy()
        depth = int(np.max(seq - s_off[creator], initial=0))
        if depth >= self.cfg.s_cap:
            raise ValueError(
                f"in-window chain depth {depth} >= s_cap {self.cfg.s_cap}:"
                " raise s_cap or shrink seq_window"
            )
        self.dag.drop_pending()

        kpad = _bucket(k)
        t, b = sched.shape
        sched_p = np.full((-(-t // 64) * 64, _bucket(b, 1)), -1, np.int32)
        sched_p[:t, :b] = sched

        def dev(a, fill, dtype):
            out = np.full(kpad, fill, dtype)
            out[:k] = a
            return torch.tensor(out, device=self.device)

        batch = EventBatch(
            sp=dev(sp, -1, np.int32),
            op=dev(op, -1, np.int32),
            creator=dev(creator, 0, np.int32),
            seq=dev(seq, 0, np.int32),
            ts=dev(ts, 0, np.int64),
            mbit=dev(mbit, False, bool),
            k=torch.tensor(k, dtype=torch.int32, device=self.device),
            sched=torch.tensor(sched_p, device=self.device),
        )
        # window-wide fd sweep schedule: all live rows
        base = self.dag.slot_base
        levels_live = np.fromiter(
            (self.dag.levels[s] for s in range(base, self.dag.n_events)),
            np.int64, self.dag.n_events - base,
        )
        fd_slot_sched = torch.tensor(
            _padded_schedule(levels_live, self.cfg.e_cap), device=self.device
        )
        self.stream.ingest(batch, fd_slot_sched=fd_slot_sched)
        self.state = self.stream.state
        self._view = {}
        self._m_flush_events.observe(k)
        self._m_flush_seconds.observe(time.perf_counter() - t_flush)

    # ------------------------------------------------------------------
    # consensus pipeline (Core.run_consensus calls these in order)

    def divide_rounds(self) -> None:
        self.flush()

    def decide_fame(self) -> None:
        pass  # rounds+fame+order run together in find_order

    def find_order(self) -> List[Event]:
        self.flush()
        if self.stream.n_live == 0:
            return []
        self.stream.consensus(final=False)
        self.state = self.stream.state
        self._view = {}

        rr = self._arr("rr")
        cts = self._arr("cts")
        base = self.dag.slot_base
        ne = self.dag.n_events - base
        self._lcr_cache = int(self.state.lcr.item())
        self._r_off = int(self.state.r_off.item())
        new_slots = [
            s for s in range(ne)
            if rr[s] >= 0 and (base + s) not in self._received
        ]
        if not new_slots:
            if self.auto_compact:
                self.maybe_compact()
            return []

        new_events: List[Event] = []
        for s in new_slots:
            ev = self.dag.events[base + s]
            ev.round_received = int(rr[s])
            ev.consensus_timestamp = int(cts[s])
            new_events.append(ev)
            self._received.add(base + s)
        self._ordered_total += len(new_slots)

        new_events = consensus_sort(new_events, self._round_prn)
        for ev in new_events:
            self.consensus.append(ev.hex())
            self._digest.note(ev.hex())
            self.consensus_transactions += len(ev.transactions)

        lcr = self._lcr_cache
        if lcr >= 1:
            rounds = self._arr("round")
            self.last_committed_round_events = int(
                np.count_nonzero(rounds[:ne] == lcr - 1)
            )
        if self.commit_callback is not None and new_events:
            self.commit_callback(new_events)
        if self.auto_compact:
            self.maybe_compact()
        return new_events

    # ------------------------------------------------------------------
    # rolling window — the live seq_window contract (module docstring)

    def maybe_compact(self, force: bool = False,
                      min_future_parent: int = INT64_MAX) -> int:
        if self.dag.pending and min_future_parent == INT64_MAX:
            # pending events still reference parents by slot: without a
            # bound on their smallest parent, eviction could strand them
            return 0
        ne = self.stream.n_live
        if ne == 0:
            return 0
        k = self.stream.compact(
            min_future_parent=min_future_parent,  # live: no future oracle
            head_seqs=None,                # current heads (state.cnt - 1)
            compact_min=1 if force else self.compact_min,
        )
        self.state = self.stream.state
        self._view = {}
        if k == 0:
            return 0
        base = self.dag.slot_base
        self.dag.evict_prefix(base + k)
        self._received = {g for g in self._received if g >= base + k}
        self._r_off = int(self.state.r_off.item())
        if self.consensus_window is not None:
            self.consensus.evict_to(
                max(self.consensus.start,
                    len(self.consensus) - self.consensus_window)
            )
            self._digest.evict_to(self.consensus.start)
        return k

    # ------------------------------------------------------------------
    # unsupported fused-only surface

    def _ensure_capacity(self, k_new: int) -> None:  # pragma: no cover
        raise NotImplementedError(
            "WideHashgraph capacities are fixed at construction"
        )

    def _unsupported(self, name: str):
        raise NotImplementedError(
            f"{name} needs the fused [E,N] coordinate tensors; the wide "
            "engine holds them as column blocks (use TorchHashgraph for "
            "predicate-level queries)"
        )

    def ancestor(self, x: str, y: str) -> bool:
        self._unsupported("ancestor")

    def see(self, x: str, y: str) -> bool:
        self._unsupported("see")

    def strongly_see(self, x: str, y: str) -> bool:
        self._unsupported("strongly_see")

    def oldest_self_ancestor_to_see(self, x: str, y: str) -> str:
        self._unsupported("oldest_self_ancestor_to_see")
