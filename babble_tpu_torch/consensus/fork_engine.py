"""ForkHashgraph: byzantine-mode consensus engine (batch execution) — the
port's copy of the JAX package's ``consensus/fork_engine.py``, over the
port's ``ops/forks.py`` on ``device`` ("cuda" unless the caller asks for
the CPU).

Pairs the host ForkDag (branch assignment, chain views) with the dense
branch kernels (ops/forks.py) and emits the same commit surface as
TpuHashgraph.  Differentially tested against consensus/byzantine.py
(the definition-first oracle) on forked DAGs, and against the honest
engine on fork-free DAGs.

Execution model is whole-WINDOW batch: each run_consensus() call re-runs
the pipeline over the live window from a fresh device state.  That
matches the byzantine bench shape (BASELINE "1024-node, 1/3 forks") and,
with the rolling window, bounds a live node's
per-tick cost forever:

- ``maybe_compact`` evicts the longest committed slot prefix whose
  rounds sit below lcr - round_margin, that is seq_window chain indexes
  behind every branch tip, and that no unordered event still needs for
  its median timestamp (the per-branch min-fd bound).  Slot order is a
  chain prefix on every branch, so chain INDEX values (eseq, cp, la/fd
  units) stay absolute and nothing rebases.
- round and witness status are functions of an event's fixed ancestry,
  so values computed once are final: the engine seeds them back into
  the next run (ForkBatch.rseed/wseed) and the rounds closure only
  assigns events inserted since.  Rounds are window-local; r_off maps
  them back to absolute for commits and stats.
- capacities only grow (the JAX package's rule, which keeps its jit
  shapes few); the port keeps the same capacities so that both packages
  run the pipeline at the same shapes and give the same outputs.

Live scope: the engine exposes the full Core surface (known/diff/
full-event wire form/commit counters), so a node can run byzantine mode
end to end (Config.byzantine).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

import torch

from ..common import TooLateError
from ..core.event import Event, FullWireEvent
from ..ops import aot as aot_ops
from ..ops.forks import (
    FAME_TRUE,
    FAME_UNDEFINED,
    FORK_SS_MAX_K,
    ForkConfig,
    ForkDag,
    fork_pipeline,
)
from ..ops.state import bucket as _bucket
from .digest import CommitDigest
from .ordering import consensus_sort


class ForkHashgraph:
    def __init__(
        self,
        participants: Dict[str, int],
        k: int = 2,
        commit_callback=None,
        verify_signatures: bool = False,
        auto_compact: bool = False,
        round_margin: int = 1,
        seq_window: int = 16,
        compact_min: int = 64,
        initial_caps: Optional[tuple] = None,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and k > FORK_SS_MAX_K:
            raise ValueError(
                f"ForkHashgraph: k={k} branch slots on {self.device}; the "
                f"fork_ss kernel is built for k in [1, {FORK_SS_MAX_K}]")
        self.participants = participants
        self.k = k
        self.dag = ForkDag(participants, k=k)
        self.commit_callback = commit_callback
        self.verify_signatures = verify_signatures
        self.auto_compact = auto_compact
        self.round_margin = round_margin
        self.seq_window = seq_window
        self.compact_min = compact_min
        self.consensus: List[str] = []
        self._digest = CommitDigest()
        self.consensus_transactions = 0
        self.last_committed_round_events = 0
        self._received: set = set()     # event hexes already ordered
        self._out = None
        self._host: Dict[str, np.ndarray] = {}  # host copies of _out's fields
        self._dirty = True
        self._lcr_cache = -1    # host mirror: /Stats must never touch device
        # monotone (e_cap, s_cap, r_cap) — see _run.  Pre-sizing
        # (initial_caps) collapses the demand-driven growth sequence to
        # one compiled shape at boot (Config.fork_caps rationale).
        self._caps = tuple(initial_caps) if initial_caps else (0, 0, 0)
        #: AOT manifest directory (ops/aot.prewarm_engine): when set,
        #: every pipeline shape run is recorded for the next boot's
        #: prewarm
        self._aot_dir: Optional[str] = None

    def pre_size(self, caps: tuple) -> None:
        """Raise the monotone pipeline capacities to at least ``caps``
        (e_cap, s_cap, r_cap) — one compiled shape at the next run
        instead of a demand-driven growth sequence.  Used when resuming
        a checkpoint under Config.fork_caps (the checkpoint itself
        carries no capacity hints)."""
        self._caps = tuple(
            max(a, b) for a, b in zip(self._caps, caps)
        )

    @property
    def n(self) -> int:
        return len(self.participants)

    def insert_event(self, event: Event) -> None:
        if self.verify_signatures:
            if event.creator not in self.participants:
                raise ValueError("creator is not a participant")
            if not event.chain_verified and not event.verify():
                raise ValueError("bad event signature")
        self.dag.insert(event)
        self._dirty = True

    # ------------------------------------------------------------------
    # Core surface (gossip protocol; mirrors TpuHashgraph's)

    def known(self) -> Dict[int, int]:
        """Per-CREATOR event counts.  Under equivocation this vector
        clock is approximate: two nodes can hold equally-sized but
        DIFFERENT event sets for a byzantine creator, and count-skip
        diffs alone then wedge at a stable fixpoint that never exchanges
        the symmetric difference.  participant_events
        self-heals in two layers:

        1. tip exchange — when the peer's count is >= ours (suffix
           empty), our chain tip for that creator is sent anyway.  Equal
           sets drop it as a duplicate; diverged sets make the receiver
           insert a foreign tip whose self-parent is not its local tip,
           which IS the fork detection (ForkDag.insert allocates a
           branch), collapsing the undetectable case to the detected one.
        2. detected-fork resend — for creators with a locally detected
           fork, diffs ignore count-skip past the earliest divergence
           and resend the whole ambiguous suffix; receivers drop
           duplicates by hash and random gossip converges the fleet."""
        return {
            cid: self.dag.cr_evicted[cid] + len(self.dag.cr_events[cid])
            for cid in self.participants.values()
        }

    def _fork_suffix_start(self, cid: int) -> Optional[int]:
        """Earliest divergence index of creator cid, or None if no fork
        observed locally.  Events with seq < that index form the shared
        linear prefix: topological insertion puts exactly those events in
        the first ``div`` positions of cr_events (any seq>=div event on
        either branch self-parent-chains through the whole prefix), so
        count-skip is sound only there."""
        dag = self.dag
        alts = [
            dag.br_div[c]
            for c in range(cid * self.k, (cid + 1) * self.k)
            if dag.br_used[c] and dag.br_parent[c] >= 0
        ]
        return min(alts) if alts else None

    def participant_events(self, pub: str, skip: int) -> List[str]:
        cid = self.participants[pub]
        evicted = self.dag.cr_evicted[cid]
        div = self._fork_suffix_start(cid)
        if div is not None:
            # detected-fork resend reaches at most down to the window
            # base (anything below is committed on both sides)
            skip = min(skip, max(div, evicted))
        slots = self.dag.cr_events[cid]
        if skip < evicted:
            # the peer is below the rolling window; byzantine mode has
            # no fast-forward (node.py refusal), so it cannot catch up
            # through this sync path
            raise TooLateError(skip)
        if slots and skip >= evicted + len(slots):
            # equal-or-ahead count: send the tip anyway (see known()
            # docstring, layer 1) so set divergence becomes detectable
            return [self.dag.events[slots[-1]].hex()]
        return [
            self.dag.events[s].hex() for s in slots[skip - evicted:]
        ]

    def to_wire(self, event: Event) -> FullWireEvent:
        # the compact (creatorID, index) form is ambiguous under forks
        return FullWireEvent.from_event(event)

    def read_wire_info(self, w: FullWireEvent, overlay=None) -> Event:
        # FullWireEvents carry parents by hash — self-contained, no
        # batch overlay needed (accepted for interface uniformity)
        return w.to_event()

    # ------------------------------------------------------------------
    # consensus pipeline surface (Core.run_consensus calls these)

    def divide_rounds(self) -> None:
        pass          # lazy: _run() computes everything at find_order

    def decide_fame(self) -> None:
        pass

    def find_order(self) -> List[Event]:
        return self.run_consensus()

    @property
    def undetermined_count(self) -> int:
        return len(self.dag.events) - len(self._received)

    @property
    def last_consensus_round(self) -> Optional[int]:
        """Host mirror only: forcing ``self.lcr`` here would
        trigger a whole-DAG device pipeline recompute from the stats path
        and could race a concurrent consensus run.  The cache is advanced
        by every _run(); use ``self.lcr`` to force a computation."""
        lcr = self._lcr_cache
        return None if lcr < 0 else lcr

    def consensus_events_count(self) -> int:
        return len(self.consensus)

    # commit-digest surface (verified fast-forward, store/proof.py):
    # the fork engine's consensus list is append-only, so the rolling
    # hash chain is position-exact with anchor 0

    @property
    def commit_digest(self) -> str:
        return self._digest.head

    @property
    def commit_length(self) -> int:
        return self._digest.length

    def commit_digest_at(self, position: int):
        return self._digest.digest_at(position)

    def stats_snapshot(self) -> Dict[str, int]:
        # forked_creators is the operator-facing equivocation signal
        # (tests and dashboards read detection from the stats surface,
        # not by forcing a device recompute):
        # a creator counts as forked once any non-primary branch column
        # materialized — which happens exactly when two same-index
        # events of that creator entered the window (ForkDag.insert).
        k = self.dag.k
        forked = sum(
            1 for cid in self.participants.values()
            if any(self.dag.br_used[c]
                   for c in range(cid * k + 1, (cid + 1) * k))
        )
        return {
            "last_consensus_round": self._lcr_cache,
            "undetermined_events": self.undetermined_count,
            "consensus_events": len(self.consensus),
            "consensus_transactions": self.consensus_transactions,
            "last_committed_round_events": self.last_committed_round_events,
            "evicted_events": self.dag.evicted,
            "live_window": len(self.dag.events),
            "forked_creators": forked,
        }

    # ------------------------------------------------------------------

    def _run(self):
        if not self._dirty and self._out is not None:
            return self._out
        dag = self.dag
        ne = len(dag.events)
        max_chain = max(
            (len(dag._chain_slots(c))
             for c in range(dag.b) if dag.br_used[c]),
            default=0,
        )
        # window-local round capacity: seeded top + headroom for the
        # new levels (a level lifts the max round by at most one, and in
        # practice a round spans several levels)
        prev_top = max(
            (r - dag.r_off for r in dag.rseed if r >= 0), default=0
        )
        lvl_new = len({dag.levels[s] for s in range(ne)
                       if dag.rseed[s] < 0})
        r_cap = _bucket(prev_top + 2 + min(lvl_new, max(8, lvl_new // 3)),
                        8)
        # monotone capacities: every distinct shape is a full pipeline
        # re-jit, so caps only ever grow (the rolling window keeps the
        # fixpoint small; without monotonicity the r_cap heuristic flaps
        # between buckets and a 4-node fleet on one core spends minutes
        # per tick inside XLA)
        e_cap = max(self._caps[0], _bucket(ne))
        s_cap = max(self._caps[1], _bucket(max_chain + 1, 8))
        r_cap = max(self._caps[2], r_cap)
        while True:
            self._caps = (e_cap, s_cap, r_cap)
            cfg = ForkConfig(
                n=self.n, k=self.k,
                e_cap=e_cap,
                s_cap=s_cap,
                r_cap=r_cap,
            )
            batch = self.dag.build_batch(cfg, self.device)
            aot_ops.note_dispatch((cfg, tuple(batch.sched.shape)))
            out = fork_pipeline(cfg, batch)
            if int(out.max_round) < cfg.r_cap - 1:
                break
            r_cap *= 2      # saturated: recompute with headroom
        if self._aot_dir is not None:
            aot_ops.record_fork_caps(
                self._aot_dir, self.n, self.k, self._caps,
                sched=tuple(batch.sched.shape),
            )
        self._out = (cfg, out)
        self._host = {}
        self._dirty = False
        lcr_loc = int(out.lcr)
        if lcr_loc >= 0:
            self._lcr_cache = max(self._lcr_cache, lcr_loc + dag.r_off)
        # seed back: rounds/witness are ancestry-fixed, so this run's
        # assignments are final and the next run skips them
        rnd = self._np("round")[:ne]
        wit = self._np("witness")[:ne]
        for s in range(ne):
            if rnd[s] >= 0:
                dag.rseed[s] = int(rnd[s]) + dag.r_off
                dag.wseed[s] = int(wit[s])
        return self._out

    def _np(self, name: str) -> np.ndarray:
        """Host copy of one field of the last run's ``ForkOut``, read
        from the device once per run."""
        arr = self._host.get(name)
        if arr is None:
            arr = getattr(self._out[1], name).cpu().numpy().copy()
            self._host[name] = arr
        return arr

    # ------------------------------------------------------------------
    # predicate surface (differential tests)

    def _slot(self, x: str) -> int:
        return self.dag.slot_of[x]

    def round(self, x: str) -> int:
        cfg, out = self._run()
        return int(self._np("round")[self._slot(x)]) + self.dag.r_off

    def witness(self, x: str) -> bool:
        cfg, out = self._run()
        return bool(self._np("witness")[self._slot(x)])

    def see(self, x: str, y: str) -> bool:
        cfg, out = self._run()
        sx, sy = self._slot(x), self._slot(y)
        la = self._np("la")
        det = self._np("det")
        br = self.dag.ebr[sy]
        cy = self.participants[self.dag.events[sy].creator]
        return bool(
            la[sx, br] >= self.dag.events[sy].index and not det[sx, cy]
        )

    def detects_fork(self, x: str, cid: int) -> bool:
        cfg, out = self._run()
        return bool(self._np("det")[self._slot(x), cid])

    def famous_of(self, r: int, x: str) -> Optional[bool]:
        cfg, out = self._run()
        r_loc = r - self.dag.r_off
        if r_loc < 0 or r_loc >= cfg.r_cap:
            return None
        wslot = self._np("wslot")
        famous = self._np("famous")
        sx = self._slot(x)
        for col in range(cfg.b):
            if wslot[r_loc, col] == sx:
                f = famous[r_loc, col]
                return None if f == FAME_UNDEFINED else bool(f == FAME_TRUE)
        return None

    def max_round(self) -> int:
        cfg, out = self._run()
        return int(self._np("max_round")) + self.dag.r_off

    @property
    def lcr(self) -> int:
        self._run()
        return self._lcr_cache

    # ------------------------------------------------------------------

    def run_consensus(self) -> List[Event]:
        cfg, out = self._run()
        r_off = self.dag.r_off
        rr = self._np("rr")
        cts = self._np("cts")
        wslot = self._np("wslot")
        famous = self._np("famous")
        ne = len(self.dag.events)

        new_events: List[Event] = []
        for s in range(ne):
            if rr[s] < 0:
                continue
            ev = self.dag.events[s]
            if ev.hex() in self._received:
                continue
            ev.round_received = int(rr[s]) + r_off
            ev.consensus_timestamp = int(cts[s])
            new_events.append(ev)
            self._received.add(ev.hex())
        if not new_events:
            if self.auto_compact:
                self.maybe_compact()
            return []

        def prn(r: int) -> int:
            r_loc = r - r_off
            if r_loc < 0 or r_loc >= cfg.r_cap:
                return 0
            res = 0
            for col in range(cfg.b):
                if wslot[r_loc, col] >= 0 and famous[r_loc, col] == FAME_TRUE:
                    res ^= int(
                        self.dag.events[int(wslot[r_loc, col])].hex(), 16
                    )
            return res

        new_events = consensus_sort(new_events, prn)
        for ev in new_events:
            self.consensus.append(ev.hex())
            self._digest.note(ev.hex())
            self.consensus_transactions += len(ev.transactions)
        lcr = self._lcr_cache
        if lcr >= 1:
            rnd = self._np("round")[:ne]
            self.last_committed_round_events = int(
                np.count_nonzero(rnd + r_off == lcr - 1)
            )
        if self.commit_callback is not None:
            self.commit_callback(new_events)
        if self.auto_compact:
            self.maybe_compact()
        return new_events

    # ------------------------------------------------------------------
    # rolling window (module docstring; honest analogue:
    # consensus/engine.py maybe_compact over caches.go:45-76 semantics)

    def maybe_compact(self, force: bool = False) -> int:
        """Evict the longest committed slot prefix nothing live needs:
        ordered, round below lcr - round_margin, seq_window chain
        indexes behind every branch tip, and strictly below the
        smallest first-descendant any UNORDERED event still holds on
        that branch (so median timestamps keep resolving).  Returns the
        number of evicted slots.

        Known bound: a detected equivocator's excluded branch events
        are never ordered, and the prefix cut stops at the earliest of
        them — so the live window floor grows with the equivocator's
        branch length.  Evicting them would need a proof that an
        unordered fork event can never be received later (its receive
        chance at undecided high rounds depends on which witnesses
        detect the fork), and a wrong guess is consensus divergence —
        so the engine keeps them.  The fork budget (K-1 branches per
        creator) bounds branch COUNT; branch length is bounded only by
        how long peers keep resending, which the seq_window cap on
        diffs limits per sync."""
        if self._out is None or self._dirty:
            return 0
        cfg, out = self._out
        dag = self.dag
        ne = len(dag.events)
        if ne == 0:
            return 0
        r_off = dag.r_off
        new_r_off_target = self._lcr_cache - self.round_margin
        rr = self._np("rr")[:ne]
        rnd = self._np("round")[:ne] + r_off
        fd = self._np("fd")[:ne]
        eseq = np.fromiter(
            (ev.index for ev in dag.events), np.int64, ne
        )
        ebr = np.asarray(dag.ebr[:ne])
        # per-branch safety bounds
        unordered = rr < 0
        m_fd = np.full(cfg.b, np.iinfo(np.int64).max)
        if unordered.any():
            fd_u = np.where(
                fd[unordered] >= np.iinfo(np.int32).max,
                np.iinfo(np.int64).max, fd[unordered].astype(np.int64),
            )
            m_fd = fd_u.min(axis=0)
        tip_idx = np.asarray(dag.br_extent) - 1
        ebr_c = np.clip(ebr, 0, cfg.b - 1)
        ok = (
            (rr >= 0)
            & (rnd < new_r_off_target)
            & (eseq < m_fd[ebr_c])
            & (eseq <= tip_idx[ebr_c] - self.seq_window)
        )
        k = int(np.argmin(ok)) if not ok.all() else ne
        # Round-consistency gate: lcr advances on a
        # supermajority and can outrun laggard chains, so the window may
        # hold live low-round events whose FUTURE children recompute
        # rounds — those computations need every witness of any round
        # >= the eventual r_off.  Rounds are not monotone in slot order,
        # so a plain prefix cut can evict a round-p witness while a
        # round-(p-2) laggard stays live, and a differently-windowed
        # replica then assigns different rounds (consensus divergence).
        # Sound invariant: max(round evicted) < min(round retained) —
        # every future event's round is >= some retained parent's round,
        # so all witnesses at reachable rounds stay in-window.  Chain
        # tips are always retained (seq_window), which subsumes gating
        # by the minimum live chain-head round (the ops/wide.py
        # _head_round_min analogue).  Take the largest admissible k.
        if k > 0:
            pref_max = np.maximum.accumulate(
                np.concatenate(([-1], rnd))
            )                               # pref_max[j] = max(rnd[:j])
            suf_min = np.minimum.accumulate(
                np.concatenate((rnd, [np.iinfo(np.int64).max]))[::-1]
            )[::-1]                         # suf_min[j] = min(rnd[j:])
            admissible = np.nonzero(
                pref_max[: k + 1] < suf_min[: k + 1]
            )[0]
            k = int(admissible.max())       # j=0 always admissible
        new_r_off = int(rnd[k:].min(initial=new_r_off_target))
        new_r_off = max(r_off, min(new_r_off, new_r_off_target))
        assert k == 0 or int(rnd[:k].max()) < new_r_off, (
            "eviction would remove a witness round still reachable by "
            "live chains"
        )
        if (k < self.compact_min and not force) and new_r_off == r_off:
            return 0
        for s in range(k):
            self._received.discard(dag.events[s].hex())
        dag.evict_prefix(k, new_r_off)
        self._out = None
        self._dirty = True
        return k

    def consensus_events(self) -> List[str]:
        return list(self.consensus)
