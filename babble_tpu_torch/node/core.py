"""Core: one participant's consensus state (reference node/core.go:30-257).

Wraps a TorchHashgraph with the node's signing key, tracks the head of the
node's own event chain, computes gossip diffs from Known vector clocks, and
applies incoming syncs by inserting peer events and creating a new signed
self-event whose parents are (own head, peer head) carrying the pooled
transactions.

The port's copy of the JAX package's ``node/core.py`` over the fused
engine or, with ``byzantine``, the fork-aware ``ForkHashgraph``; it
builds either on ``device``.  The wide engine is not ported yet: asking
for it raises ``NotImplementedError`` naming its ROADMAP.md item, and an
injected engine must be a ``TorchHashgraph`` or a ``ForkHashgraph``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

from ..common import TooLateError
from ..consensus.engine import TorchHashgraph
from ..consensus.fork_engine import ForkHashgraph
from ..core.event import Event, WireEvent, new_event
from ..crypto.keys import KeyPair
from ..obs import Registry
from ..ops.forks import ParentUnknownError
from ..quorum import sync_quorum
from ..store.checkpoint import engine_mode
from ..wal import WriteAheadLog

NOT_PORTED_WIDE = (
    "the wide engine (WideHashgraph) is not ported yet (ROADMAP.md "
    "Queue 1, item 8: the wide-N engine)"
)


def _mark_chain_verified(events: List[Event]) -> None:
    """Signature elision over contiguous self-parent chains.

    For each creator, the batch (already topologically ordered, so a
    creator's events appear oldest-first) is split into runs where each
    event's ``self_parent`` is the previous event's full id and the
    index is contiguous.  The newest event of a run >= 2 is verified
    HERE, upfront; success marks the entire run ``chain_verified`` (the
    insert paths then skip per-event ECDSA).  Soundness: an event's id
    hashes body+signature, and the id is inside the successor's SIGNED
    body — so the head signature authenticates every predecessor byte
    transitively, and a fabricated prefix event would break the hash
    chain it claims membership of.  A failed head verify marks nothing:
    the per-event insert checks then reject exactly as before.  Runs of
    one (idle fleets) keep the plain per-event verify."""
    runs: Dict[str, List[Event]] = {}
    for ev in events:
        run = runs.setdefault(ev.creator, [])
        if run and not (ev.self_parent == run[-1].hex()
                        and ev.index == run[-1].index + 1):
            if len(run) >= 2 and run[-1].verify():
                for e in run:
                    e.chain_verified = True
            runs[ev.creator] = run = []
        run.append(ev)
    for run in runs.values():
        if len(run) >= 2 and run[-1].verify():
            for e in run:
                e.chain_verified = True


class Core:
    def __init__(
        self,
        core_id: int,
        key: KeyPair,
        participants: Dict[str, int],
        commit_callback: Optional[Callable[[List[Event]], None]] = None,
        engine: Optional[TorchHashgraph] = None,
        e_cap: int = 4096,
        cache_size: Optional[int] = None,
        seq_window: Optional[int] = None,
        byzantine: bool = False,
        fork_k: int = 2,
        fork_caps: Optional[tuple] = None,
        wide: bool = False,
        wide_caps: Optional[tuple] = None,
        registry: Optional[Registry] = None,
        wal: Optional[WriteAheadLog] = None,
        kernel_class: str = "auto",
        inactive_rounds: Optional[int] = 32,
        lineage=None,
        phase_probe: bool = False,
        packed_votes: bool = True,
        frontier: bool = True,
        device="cuda",
    ):
        self.id = core_id
        self.kernel_class = kernel_class
        # kernel working-set diet (ROADMAP item 4): both knobs are
        # bit-parity-preserving pins — packed popcount vote tallies and
        # the event-axis frontier bucket on the fused latency kernel
        self.packed_votes = packed_votes
        self.frontier = frontier
        # attribution plane: the owning node's commit-lineage
        # recorder.  Hooks live at the two places only the Core can see
        # — the mint (tx -> event hash join pivot) and the peer insert.
        # None (or a disabled recorder) makes every hook a no-op.
        self.lineage = lineage
        self.phase_probe = phase_probe
        self.key = key
        self.pub_hex = key.pub_hex
        self.participants = participants
        # Membership plane: a node whose key is not (yet) in the epoch's
        # peer set runs as an OBSERVER — it syncs, validates and commits
        # like any replica but never mints, because no honest peer would
        # accept an event from a non-member.  A committed join naming
        # our key flips this (adopt_membership); a committed leave sets
        # the retired flag the same way.
        self._observer = key.pub_hex not in participants
        self._retired_self = False
        self.registry = registry
        # event-timestamp clock, overridable for deterministic replay:
        # the chaos scenario runner installs a seeded logical clock here
        # so event bodies (and therefore hashes, signatures and
        # timestamp-median tie-breaks) are identical across runs
        self.now_ns: Callable[[], int] = time.time_ns
        if engine is not None:
            # an injected engine is authoritative: the mode flag must
            # match its type, or diff()/head restore would misbehave —
            # and so is its PARTICIPANT set: a checkpoint restored from
            # a later epoch legitimately differs from the boot peer
            # list (membership plane), so the engine's epoch ledger
            # wins and observer status is recomputed against it.
            # engine_mode raises for a kind the port does not have
            self.hg = engine
            byzantine = engine_mode(engine) == "byzantine"
            participants = engine.participants
            self.participants = participants
            self._observer = self.pub_hex not in participants
            self.id = participants.get(self.pub_hex, -1)
        elif byzantine:
            # fork-aware live mode: equivocations are accepted, detected
            # and discounted instead of rejected (ops/forks.py); gossip
            # ships the self-contained FullWireEvent form because the
            # compact (creatorID, index) references are ambiguous under
            # forks.  Batch execution per consensus tick over a rolling
            # window (fork_engine.maybe_compact) keeps per-tick cost
            # bounded forever.
            self.hg = ForkHashgraph(
                participants, k=fork_k,
                commit_callback=commit_callback,
                verify_signatures=True,
                auto_compact=bool(cache_size),
                seq_window=min(seq_window or cache_size or 256, 256),
                compact_min=max((cache_size or 256) // 4, 32),
                initial_caps=fork_caps,
                device=device,
            )
        elif wide:
            raise NotImplementedError(NOT_PORTED_WIDE)
        else:
            # The live path runs with rolling windows on (auto_compact):
            # memory stays bounded and peers that fall behind the
            # cache_size window get TooLateError through the sync path,
            # like the reference's rolling caches (caches.go:45-76).
            self.hg = TorchHashgraph(
                participants, commit_callback=commit_callback, e_cap=e_cap,
                auto_compact=bool(cache_size),   # 0/None = unbounded history
                seq_window=seq_window or cache_size or 256,
                consensus_window=2 * cache_size if cache_size else None,
                # live semantics: a round's fame (and therefore its prn
                # whitening and cts medians) freezes only once every
                # chain's head round has passed it — the witness-set
                # finality gate (the wide engine's complete=False rule on
                # the fused path: no premature intra-round finality)
                finality_gate=True,
                kernel_class=kernel_class,
                # per-creator eviction: a peer silent for
                # this many decided rounds stops pinning the window
                inactive_rounds=inactive_rounds,
                packed_votes=packed_votes,
                frontier=frontier,
                device=device,
            )
        self.byzantine = byzantine
        self._apply_live_engine_policy()
        # tolerated insert failures (byzantine-mode per-event insert
        # failures, unconvertible wire events, merge skips): counted,
        # not raised — surfaced for stats/tests
        self.insert_failures = 0
        self.last_insert_error: Optional[str] = None
        #: merge mints skipped because the sync partner's head was
        #: minted by a creator retired in the current epoch
        self.retired_merge_skips = 0
        # self-stabilizing gossip: count-skip
        # diffs can hide the symmetric difference under equivocation.
        # The fork engine's tip exchange makes a hidden divergence
        # surface as a parent-not-known failure on an event of the
        # DIVERGED creator; each such failure doubles that creator's
        # backoff, and known() under-advertises that creator's count by
        # it — so diffs reach ever deeper into its chain until the
        # fork's shared prefix arrives and the branch materializes
        # (duplicates are dropped by hash).  The backoff is per-creator
        # and resets only when a NEW event of that creator inserts
        # (progress), so interleaved healthy syncs cannot wipe it:
        # divergence depth d heals in ~log2(d) failing syncs total.
        self._creator_backoff: Dict[int, int] = {}
        # Durability plane (wal/): the write-ahead log is replayed on
        # top of whatever engine we booted with (fresh or checkpoint-
        # restored), so the node resumes at its true head seq and never
        # re-mints a sequence number it already published (the
        # crash-recovery amnesia defect).  _min_next_seq is the mint floor the
        # recovery ladder established; while the engine's own chain sits
        # below it, minting is deferred and gossip/fast-forward restore
        # the published tail first.
        self.wal = wal
        self._wal_own_max = -1
        self._wal_orphans: List[Event] = []
        self._min_next_seq = 0
        # Peer-negotiated seq skip-ahead (the WAL-missing fallback): no
        # durable memory of our own chain exists, so minting waits for a
        # supermajority of peers (counting ourselves) to answer a sync —
        # each applied response merges that peer's view of our chain, so
        # at quorum the engine head IS the max published seq any
        # supermajority member has seen, and _min_next_seq lands one
        # past it.
        self._probing = False
        self._probe_seen: set = set()
        #: transactions of an unrecoverable own-chain suffix discarded
        #: by the last horizon bootstrap (node re-pools them)
        self.last_bootstrap_lost_txs: List[bytes] = []
        # supermajority is 2n//3+1 members counting ourselves, so the
        # probe needs 2n//3 PEER answers — 0 for a single-participant
        # fleet, where our own durable state is the only authority.
        # Routed through the epoch-aware helper: with dynamic
        # membership this count must track the ACTIVE set.
        self._probe_quorum = sync_quorum(self._active_count())
        if wal is not None:
            self._recover_from_wal()
        self.head: str = ""
        self.seq: int = -1
        # A resumed engine (store.load_checkpoint) already holds our chain —
        # pick up where the checkpoint left off.  Observers have no chain.
        if self._observer:
            pass
        elif byzantine:
            own = self.hg.dag.cr_events[participants[self.pub_hex]]
            if own:
                head_ev = self.hg.dag.events[own[-1]]
                self.head = head_ev.hex()
                self.seq = head_ev.index
        else:
            chain = self.hg.dag.chains[participants[self.pub_hex]]
            if chain:
                head_ev = self.hg.dag.events[chain[-1]]
                self.head = head_ev.hex()
                self.seq = head_ev.index
        if wal is not None:
            # the mint floor: one past the newest self-event the WAL
            # (records + head receipt) remembers publishing.  A torn
            # tail may have lost the newest receipt-less records, so a
            # truncated log ALSO probes — re-minting a seq a minority of
            # peers already hold would read as an equivocation.
            self._min_next_seq = max(
                self._wal_own_max + 1, wal.receipt_seq + 1
            )
            # probe whenever recovery cannot vouch for every published
            # seq: missing log, torn tail, or an unclean shutdown under
            # a batched fsync policy (a whole record suffix can be lost
            # at a clean fsync boundary with nothing left to detect)
            self._probing = self._probe_quorum > 0 and wal.needs_probe

        if registry is not None:
            # sampled at scrape time through self.hg so the gauges stay
            # correct across a fast-forward engine swap (bootstrap
            # rebinds self.hg; the callbacks read the live one).  All
            # are host-side mirrors (stats_snapshot) — no device sync on
            # a /metrics scrape.  One cached snapshot serves every gauge
            # of a single exposition pass: the families are read
            # back-to-back, so a short reuse window keeps the exposed
            # mirrors mutually consistent (no torn scrape across a
            # concurrent commit) and builds the snapshot once, not once
            # per gauge.
            snap_cache = {"t": float("-inf"), "v": {}}

            def _snap() -> dict:
                now = time.monotonic()
                if now - snap_cache["t"] > 0.2:
                    snap_cache["v"] = self.hg.stats_snapshot()
                    snap_cache["t"] = now
                return snap_cache["v"]

            for gname, key in (
                ("babble_consensus_events", "consensus_events"),
                ("babble_consensus_transactions", "consensus_transactions"),
                ("babble_undetermined_events", "undetermined_events"),
                ("babble_last_consensus_round", "last_consensus_round"),
                ("babble_evicted_events", "evicted_events"),
                ("babble_live_window_events", "live_window"),
            ):
                registry.gauge(
                    gname, f"host mirror of /Stats {key}",
                ).set_function(lambda k=key: _snap().get(k, 0))
            registry.gauge(
                "babble_insert_failures",
                "per-event insert failures tolerated in byzantine mode",
            ).set_function(lambda: self.insert_failures)
            registry.gauge(
                "babble_retired_merge_skips",
                "merge mints skipped because the sync partner's head "
                "was minted by a retired creator",
            ).set_function(lambda: self.retired_merge_skips)
            if byzantine:
                registry.gauge(
                    "babble_forked_creators",
                    "creators with a detected live equivocation",
                ).set_function(lambda: _snap().get("forked_creators", 0))

    # ------------------------------------------------------------------
    # durability (wal/): recovery, the mint floor, the seq probe

    def _recover_from_wal(self) -> None:
        """Replay the WAL tail on top of the booted engine (recovery
        already truncated it at the first torn/corrupt record).  Replay
        is best-effort per event: a record whose parents predate a
        restored checkpoint's window simply fails to insert — the fleet
        re-delivers through gossip/fast-forward — but every surviving
        SELF record still raises the mint floor, insertable or not,
        because those seqs were published."""
        replayed = 0
        for ev in self.wal.recovered_events:
            if ev.creator == self.pub_hex:
                self._wal_own_max = max(self._wal_own_max, ev.index)
            if ev.hex() in self.hg.dag.slot_of:
                continue
            try:
                self.hg.insert_event(ev)
                replayed += 1
            except ValueError:
                if ev.creator == self.pub_hex:
                    # a durably-logged SELF event whose parents predate
                    # the restored window (e.g. the checkpoint rotted
                    # away): it raised the mint floor above, so it must
                    # stay retryable — once gossip restores its parents,
                    # re-inserting the SAME signed event un-wedges
                    # minting without any equivocation risk.  Dropping
                    # it here would leave the floor unreachable and the
                    # node mute forever.
                    self._wal_orphans.append(ev)
                continue
        self.wal.mark_replayed(replayed)

    def _wal_append(self, event: Event) -> None:
        if self.wal is not None:
            self.wal.append(event)

    @property
    def probing(self) -> bool:
        return self._probing

    @property
    def min_next_seq(self) -> int:
        return self._min_next_seq

    def mint_blocked(self) -> bool:
        """True while creating a self-event could re-mint a published
        sequence number — or while this node is not a member of the
        current epoch's peer set at all (observer waiting on its join,
        or retired by a committed leave): either the seq probe is still
        negotiating, or the engine's view of our own chain sits below
        the recovery ladder's mint floor (gossip / fast-forward will
        restore the published tail, at which point minting resumes
        naturally)."""
        if self._observer or self._retired_self:
            return True
        return self._probing or self.seq + 1 < self._min_next_seq

    # ------------------------------------------------------------------
    # membership plane

    def _active_count(self) -> int:
        """Active members of the current epoch (retired columns
        excluded) — the n every quorum is computed against."""
        retired = getattr(getattr(self.hg, "cfg", None), "retired", ())
        return len(self.participants) - len(retired)

    def refresh_quorums(self) -> None:
        """Re-derive every membership-dependent threshold after an
        epoch transition (or an engine swap that carried one)."""
        self._probe_quorum = sync_quorum(self._active_count())

    def adopt_membership(self) -> None:
        """A committed join named OUR key: we are a validator from the
        epoch boundary on.  Idempotent (checkpoint-restored nodes
        replay their ledger at boot)."""
        cid = self.participants.get(self.pub_hex)
        if cid is None:
            return
        self.id = cid
        self._observer = False
        chain = self.hg.dag.chains[cid]
        if chain and chain.window:
            head_ev = self.hg.dag.events[chain[-1]]
            self.head = head_ev.hex()
            self.seq = head_ev.index
        self.refresh_quorums()

    def retire_membership(self) -> None:
        """A committed leave named OUR key: stop minting permanently
        (the node keeps serving as an observer — its history remains
        useful to the fleet until it shuts down)."""
        self._retired_self = True
        self.refresh_quorums()

    def probe_note(self, peer: str) -> bool:
        """One sync response from ``peer`` was applied while probing.
        Returns True exactly when this response completed the quorum:
        the engine head now reflects the max seq a supermajority
        (counting ourselves) has seen of us, so minting resumes one
        past it."""
        if not self._probing:
            return False
        self._probe_seen.add(peer)
        if len(self._probe_seen) < self._probe_quorum:
            return False
        self._probing = False
        self._min_next_seq = max(self._min_next_seq, self.seq + 1)
        return True

    def _adopt_own_event(self, ev: Event) -> None:
        """A peer (or snapshot) delivered one of OUR published events
        that the crash lost: advance head/seq so the next mint extends
        the true chain instead of re-minting its index."""
        if ev.creator == self.pub_hex and ev.index > self.seq:
            self.head = ev.hex()
            self.seq = ev.index

    def _retry_wal_orphans(self) -> None:
        """Re-attempt the recovered self events whose first insert
        failed (parents were outside the restored window).  Called
        after each sync's peer inserts: once gossip has restored the
        missing ancestry, the orphan inserts, head/seq adopt it, and
        the mint floor it pinned becomes reachable again."""
        if not self._wal_orphans:
            return
        rest: List[Event] = []
        for ev in sorted(self._wal_orphans, key=lambda e: e.index):
            if ev.hex() in self.hg.dag.slot_of:
                self._adopt_own_event(ev)
                continue
            try:
                self.hg.insert_event(ev)
                self._adopt_own_event(ev)
            except ValueError:
                rest.append(ev)
        self._wal_orphans = rest

    # ------------------------------------------------------------------

    def _apply_live_engine_policy(self) -> None:
        """Live-path engine semantics a restored/injected fused engine
        must adopt: the witness-set finality gate (checkpoints and
        fast-forward snapshots don't serialize it — it is a property of
        the LIVE path, not of the DAG state) and this core's kernel-
        class pin.  Both are per-call static arguments on the compiled
        entries, so flipping the attributes is safe at any flush
        boundary.  (The fused engine keeps no instruments of its own, so
        an adopted engine needs no registry rebind; the fork engine has
        none of these knobs.)"""
        if not isinstance(self.hg, TorchHashgraph):
            return
        self.hg.finality_gate = True
        self.hg.kernel_class = self.kernel_class
        self.hg.phase_probe = self.phase_probe
        # diet pins (kernel working-set diet): an adopted snapshot
        # carries the peer's packed flag in its cfg — override with
        # this core's policy (bit-parity either way; a restore re-packs
        # the vote planes, so either flag reads valid planes)
        self.hg.frontier = self.frontier
        if self.hg.cfg.packed != self.packed_votes:
            self.hg.cfg = self.hg.cfg._replace(packed=self.packed_votes)

    def bootstrap(self, engine) -> None:
        """Replace the consensus engine with a fast-forward snapshot (the
        catch-up path, node.py): adopt the peer's windowed state and pick
        our own chain back up from whatever the snapshot knows of us.

        Validates before swapping so a bad snapshot can't leave the Core
        half-migrated.  The eviction policy keeps every creator's last
        seq_window events, so a non-empty chain always has a live tail;
        an empty window despite a non-zero count means a corrupt snapshot.

        If our local chain is *ahead* of the snapshot's view of us (our
        newer events already reached other peers before the partition), we
        must not roll head/seq back — the next self-event would reuse an
        index and read as an equivocation, permanently poisoning our
        gossip.  The local tail beyond the snapshot is replayed into the
        new engine; if any of it is not insertable there (an other-parent
        outside the snapshot window), bootstrap refuses and the old
        engine stays in place."""
        # full KIND check, not just byzantine-ness: a wide core must
        # not silently adopt a fused snapshot (abandoning the memory
        # layout the operator configured) or vice versa
        if engine_mode(engine) != engine_mode(self.hg):
            raise ValueError(
                f"bootstrap engine kind '{engine_mode(engine)}' does "
                f"not match this core's '{engine_mode(self.hg)}'"
            )
        # flush_fallbacks backs a *_total metric series read through
        # self.hg: carry the old engine's count across the swap or the
        # monotone counter goes backwards at every fast-forward
        if hasattr(engine, "flush_fallbacks"):
            engine.flush_fallbacks = (
                getattr(engine, "flush_fallbacks", 0)
                + getattr(self.hg, "flush_fallbacks", 0)
            )
        if self.byzantine:
            self._bootstrap_fork(engine)
            self._note_ff_adopted()
            return
        # Membership plane: the adopted engine's epoch ledger is
        # authoritative (validate_ff_snapshot verified its membership
        # chain against our trusted set before we got here) — rebind
        # our participant view and observer status to it.  A joiner
        # bootstrapping through fast-forward becomes a member exactly
        # when the snapshot's epoch says so.
        self.participants = engine.participants
        self._observer = self.pub_hex not in engine.participants
        self.id = engine.participants.get(self.pub_hex, -1)
        if self._observer:
            # not (yet) a member: adopt the window wholesale; minting
            # stays blocked until a later epoch admits us.  The WAL
            # receipt/prune and the lost-tx reset still apply — stale
            # records predating the adopted window would fail replay
            # on the next restart, and a leftover lost-tx list from an
            # earlier member-path bootstrap must not be re-pooled
            self.hg = engine
            self.head = ""
            self.seq = -1
            self.last_bootstrap_lost_txs = []
            self.refresh_quorums()
            self._apply_live_engine_policy()
            self._note_ff_adopted()
            return
        cid = self.participants[self.pub_hex]
        chain = engine.dag.chains[cid]
        horizon = engine.dag.evicted_heads.get(cid)
        if chain and not chain.window:
            # Per-creator eviction: the fleet evicted our
            # ENTIRE retained tail during the outage — legitimate
            # exactly when the snapshot records our eviction horizon at
            # the chain's logical tip.  The horizon's (index, hex) IS
            # the fleet's view of our published chain head: we resume
            # from it (continuation events are insertable fleet-wide
            # via the horizon rule in HostDag.insert).  A window-less
            # chain with no matching horizon is still a corrupt
            # snapshot.
            if horizon is None or horizon[0] != len(chain) - 1:
                raise ValueError(
                    "snapshot window holds none of our own chain tail "
                    "and records no matching eviction horizon"
                )
            snap_seq = horizon[0]
        else:
            snap_seq = engine.dag.events[chain[-1]].index if chain else -1
        lost_txs: List[bytes] = []
        tail_lost = False
        if self.seq > snap_seq:
            if chain and not chain.window:
                # Horizon rejoin: replay our local tail as far as the
                # adopted window allows (the first event rides the
                # continuation rule).  A suffix whose ancestry the
                # whole fleet evicted is UNRECOVERABLE — no other peer
                # can serve a snapshot that still holds it — so
                # refusing here (the strict path below) would wedge the
                # node forever.  The suffix is discarded, its
                # transactions surface for re-mint, and the seq probe
                # re-arms: minting stays deferred until a supermajority
                # of sync partners confirm nobody holds a higher seq of
                # ours, so a fresh event can reuse the first lost index
                # without equivocation risk (same residual trust as the
                # WAL-missing probe).
                lost_txs, tail_lost = self._replay_continuation_tail(
                    engine, cid, snap_seq
                )
            else:
                # in-window tail: the snapshot peer is merely behind —
                # a refusal keeps the old engine and a later snapshot
                # (or plain gossip) reconciles losslessly
                self._replay_own_tail(engine, cid, snap_seq)
        chain = engine.dag.chains[cid]
        if chain and chain.window:
            head_ev = engine.dag.events[chain[-1]]
            self.hg = engine
            self.head = head_ev.hex()
            self.seq = head_ev.index
        elif chain:
            # window still empty after reconciliation: our local head
            # is at or below the fleet's horizon — adopt the horizon as
            # our chain tip.  Those seqs were published under our key
            # (every peer ordered them before evicting), so the next
            # mint extends at horizon+1 instead of ever re-minting.
            self.hg = engine
            self.head = horizon[1]
            self.seq = horizon[0]
        else:
            # the snapshot knows nothing of us (our pre-partition events
            # never propagated): mint a fresh root so syncs have a head
            self.hg = engine
            self.head = ""
            self.seq = -1
            self.init()
        if tail_lost:
            # unrecoverable suffix discarded: allow the next mint to
            # reuse its first index — guarded by the re-armed probe
            self._min_next_seq = self.seq + 1
            self._probing = self._probe_quorum > 0
            self._probe_seen = set()
        self.last_bootstrap_lost_txs = lost_txs
        self.refresh_quorums()
        self._apply_live_engine_policy()
        self._note_ff_adopted()

    def _replay_continuation_tail(
        self, engine: TorchHashgraph, cid: int, snap_seq: int
    ) -> Tuple[List[bytes], bool]:
        """Replay our own events past the adopted snapshot's eviction
        horizon, as far as the new window can resolve them (the first
        rides the continuation insert rule).  Returns ``(lost_txs,
        tail_lost)``: the transactions of the unrecoverable suffix
        (events whose other-parents the whole fleet evicted) so the
        node can re-pool them for a fresh mint, and whether any suffix
        was discarded at all (re-arms the seq probe even when the lost
        events carried no transactions)."""
        old_chain = self.hg.dag.chains[cid]
        lost: List[bytes] = []
        broken = False
        for q in range(snap_seq + 1, self.seq + 1):
            if q < old_chain.start:
                # locally evicted too: nothing left to replay or re-pool
                broken = True
                continue
            ev = self.hg.dag.events[old_chain[q]]
            if not broken:
                try:
                    engine.insert_event(ev)
                    continue
                except ValueError:
                    broken = True
            lost.extend(ev.transactions)
        return lost, broken

    def _note_ff_adopted(self) -> None:
        """WAL-aware fast-forward receipts: the adopted
        snapshot supersedes everything the WAL recorded — replaying
        those records over the new window would just fail on the next
        restart (their ancestry predates the adopted window) while the
        lost head receipt would force a needless seq probe.  Prune the
        records the snapshot now covers and stamp the receipt with the
        adopted head; a crash before the next checkpoint then recovers
        by fast-forwarding again, mint floor intact."""
        if self.wal is not None:
            self.wal.checkpointed(self.seq, self.head)
        self._min_next_seq = max(self._min_next_seq, self.seq + 1)

    def _bootstrap_fork(self, engine) -> None:
        """Byzantine-mode bootstrap: adopt a
        fork-aware snapshot engine.  Beyond the honest checks, a
        snapshot that records an equivocation by US is refused outright:
        our key never forks, so either the snapshot is corrupt or our
        key is compromised — and replaying our local tail onto a
        diverged view of our own chain would MINT a fork under our
        signature, permanently poisoning our gossip."""
        cid = self.participants[self.pub_hex]
        dag = engine.dag
        if any(dag.br_used[c]
               for c in range(cid * dag.k + 1, (cid + 1) * dag.k)):
            raise ValueError(
                "snapshot records an equivocation by our own key; "
                "refusing bootstrap"
            )
        own = dag.cr_events[cid]
        if not own and dag.cr_evicted[cid] > 0:
            raise ValueError(
                "snapshot window holds none of our own chain tail"
            )
        snap_seq = max(
            (dag.events[s].index for s in own), default=-1
        )
        if self.seq > snap_seq:
            old = self.hg.dag
            by_idx = {
                old.events[s].index: old.events[s]
                for s in old.cr_events[cid]
            }
            tail = []
            for q in range(snap_seq + 1, self.seq + 1):
                ev = by_idx.get(q)
                if ev is None:
                    raise ValueError(
                        f"own-chain tail seq {q} locally evicted; cannot "
                        "reconcile snapshot behind our published chain"
                    )
                tail.append(ev)
            saved = [(ev, ev.topological_index) for ev in tail]
            try:
                for ev in tail:
                    engine.insert_event(ev)
            except Exception as e:
                for ev, ti in saved:
                    ev.topological_index = ti
                raise ValueError(
                    f"snapshot is behind our published chain (local seq "
                    f"{self.seq} > snapshot {snap_seq}) and the tail is "
                    f"not insertable into it: {e}"
                ) from e
        own = dag.cr_events[cid]
        if own:
            tip = max(own, key=lambda s: dag.events[s].index)
            self.hg = engine
            self.head = dag.events[tip].hex()
            self.seq = dag.events[tip].index
        else:
            # the snapshot knows nothing of us: mint a fresh root
            self.hg = engine
            self.head = ""
            self.seq = -1
            self.init()
        self._apply_live_engine_policy()

    def _replay_own_tail(
        self, engine: TorchHashgraph, cid: int, snap_seq: int
    ) -> None:
        """Re-insert our own events with index in (snap_seq, self.seq] from
        the current engine into ``engine``.  Raises ValueError (refusing the
        bootstrap) if the tail is locally evicted or not insertable there.
        ``topological_index`` is restored on failure: insert() stamps it
        with the new engine's slots, and the old engine's gossip diff sort
        must stay intact when we keep it."""
        old_chain = self.hg.dag.chains[cid]
        tail = []
        for q in range(snap_seq + 1, self.seq + 1):
            if q < old_chain.start:
                raise ValueError(
                    f"own-chain tail seq {q} locally evicted; cannot "
                    "reconcile snapshot behind our published chain"
                )
            tail.append(self.hg.dag.events[old_chain[q]])
        saved = [(ev, ev.topological_index) for ev in tail]
        try:
            for ev in tail:
                engine.insert_event(ev)
        except Exception as e:
            for ev, ti in saved:
                ev.topological_index = ti
            raise ValueError(
                f"snapshot is behind our published chain (local seq "
                f"{self.seq} > snapshot {snap_seq}) and the tail is not "
                f"insertable into it: {e}"
            ) from e

    def init(self) -> None:
        """Create + insert the node's root event (reference core.go:79-97).
        A no-op while the durability ladder blocks minting (seq probe in
        flight, or the WAL says seq 0 was already published)."""
        if self.mint_blocked():
            return
        ev = new_event([], ("", ""), self.key.pub_bytes, 0,
                       timestamp=self.now_ns())
        self.sign_and_insert_self_event(ev)

    def sign_and_insert_self_event(self, event: Event) -> None:
        event.sign(self.key)
        # write-AHEAD: the event hits the log (fsynced per policy)
        # before the insert that makes it gossipable, so a crash can
        # never forget a seq any peer might have seen.  An insert
        # failure leaves an orphan record; replay dedups it.
        self._wal_append(event)
        self.hg.insert_event(event)
        self.head = event.hex()
        self.seq = event.index
        if self.lineage is not None:
            # the mint record is the tx -> event hash-join pivot
            self.lineage.note_mint(event.hex(), event.transactions)

    def insert_event(self, event: Event) -> None:
        self.hg.insert_event(event)

    # ------------------------------------------------------------------
    # gossip protocol

    def known(self) -> Dict[int, int]:
        """The vector clock this core advertises to sync partners.  In
        byzantine mode, creators with an active gossip backoff (see
        __init__) are under-advertised so hidden set divergences
        eventually resync."""
        k = self.hg.known()
        if self.byzantine and self._creator_backoff:
            # Cap the under-advertisement at our own retained window
            # depth for that creator: resync
            # material below our window base is committed on both sides
            # (participant_events caps its resend there too), and an
            # advertised count below the PEER's eviction point turns
            # every sync into TooLate — with no byzantine fast-forward
            # that wedges the pair permanently, and the backoff could
            # never reset because no sync ever succeeded.
            k2 = {}
            for cid, c in k.items():
                b = self._creator_backoff.get(cid, 0)
                if b:
                    b = min(b, len(self.hg.dag.cr_events[cid]))
                k2[cid] = max(0, c - b)
            k = k2
        return k


    def reset_gossip_backoff(self) -> None:
        """Drop all per-creator resync backoff.  Called when a sync
        returns too_late: the under-advertised counts fell below the
        peer's rolling window, so deeper probing can only wedge — the
        fast-forward path takes over from there."""
        self._creator_backoff.clear()

    def diff(self, known: Dict[int, int]) -> List[Event]:
        """Events we know that the peer doesn't, topologically sorted
        (reference core.go:108-132)."""
        out: List[Event] = []
        src = self.hg if self.byzantine else self.hg.dag
        for pub, cid in self.participants.items():
            skip = known.get(cid, 0)
            for hex_id in src.participant_events(pub, skip):
                out.append(self.hg.dag.events[self.hg.dag.slot_of[hex_id]])
        out.sort(key=lambda e: e.topological_index)
        return out

    def to_wire(self, events: List[Event]) -> List[WireEvent]:
        return [self.hg.to_wire(e) for e in events]

    def from_wire(self, wire_events: List[WireEvent]) -> List[Event]:
        return [self.hg.read_wire_info(w) for w in wire_events]

    def sync(
        self,
        other_head: str,
        wire_events: List[WireEvent],
        payload: List[bytes],
    ) -> bool:
        """Insert peer events, then create the new head (core.go:134-157).

        Byzantine mode inserts per-event instead of all-or-nothing: one
        bad event (ForkBudgetError when a creator exceeds its fork
        budget, bad signature, unknown parent) must not drop the
        remaining valid events from OTHER creators in the same
        response, or a single spamming equivocator would permanently
        poison every future sync that includes its events.  Honest mode
        stays strict — there an insert error means a protocol violation
        and the whole sync is rejected (reference core.go:139-146).

        Signature elision (ingress plane): the batch is scanned for
        contiguous self-parent chains per creator; one upfront ECDSA
        verify of each chain's newest event transitively authenticates
        the whole run (the signed body names the predecessor's full
        body+signature hash), so under load per-event verify cost
        divides by the batch depth instead of pacing the fleet."""
        # convert the whole batch upfront (the elision scan needs every
        # hash before the first insert); the overlay resolves compact
        # parent references into the not-yet-inserted batch prefix with
        # the same semantics the old convert-one-insert-one loop had.
        # Conversion is TOLERANT per event (membership plane): a peer
        # one epoch ahead legitimately ships events of a creator we do
        # not know yet, woven into the founders' chains as parents —
        # those convert-fail (unknown creator id / unresolvable ref)
        # and are SKIPPED, which recursively prunes everything built on
        # them (children resolve parents through the overlay or local
        # chains, both of which lack the skipped event).  What survives
        # is exactly the old-epoch-reachable prefix — enough to reach
        # the boundary, apply the transition, and accept the rest on
        # the next exchange.  Without this, one cross-epoch sync wedged
        # the laggard forever.
        overlay: Dict[Tuple[int, int], str] = {}
        events: List[Event] = []
        skipped = 0
        for w in wire_events:
            try:
                ev = self.hg.read_wire_info(w, overlay)
            except (KeyError, IndexError, TooLateError) as e:
                skipped += 1
                self.last_insert_error = f"wire conversion skipped: {e}"
                continue
            creator_cid = self.participants.get(ev.creator)
            if creator_cid is not None:
                overlay[(creator_cid, ev.index)] = ev.hex()
            events.append(ev)
        if skipped:
            self.insert_failures += skipped
        _mark_chain_verified(events)
        for ev in events:
            if ev.hex() in self.hg.dag.slot_of:
                continue
            if self.byzantine:
                cid = self.participants.get(ev.creator)
                try:
                    self.insert_event(ev)
                    self._wal_append(ev)
                    self._adopt_own_event(ev)
                    if self.lineage is not None:
                        self.lineage.note_event(ev.hex(), "insert",
                                                index=ev.index)
                    self._creator_backoff.pop(cid, None)  # progress
                except ValueError as e:   # includes ForkBudgetError
                    self.insert_failures += 1
                    self.last_insert_error = str(e)
                    # only missing-ancestry failures warrant deeper
                    # resync; malformed events (bad index, foreign
                    # self-parent, fork budget) must not inflate the
                    # backoff of a creator that needs no resync (typed,
                    # not substring-matched)
                    if isinstance(e, ParentUnknownError) and cid is not None:
                        self._creator_backoff[cid] = min(
                            2 * max(self._creator_backoff.get(cid, 0), 1),
                            1 << 20,
                        )
                    continue
            else:
                self.insert_event(ev)
                self._wal_append(ev)
                self._adopt_own_event(ev)
                if self.lineage is not None:
                    self.lineage.note_event(ev.hex(), "insert",
                                            index=ev.index)
        self._retry_wal_orphans()
        if (other_head not in self.hg.dag.slot_of
                and (self.byzantine or other_head)):
            # the peer's head is not resolvable here — byzantine mode:
            # its parents reference events we don't hold yet; honest
            # mode: a truncated push frame (multi-frame catch-up) named
            # a head beyond what it shipped.  Keep everything inserted,
            # but the merge event cannot name it — later gossip (or the
            # next continuation frame) retries.  Returning False tells
            # the node NO self-event carried the payload, so it must
            # re-queue the pooled transactions.
            self.insert_failures += 1
            self.last_insert_error = "peer head not insertable; merge skipped"
            return False
        if self.mint_blocked():
            # recovery gate: the peer's events are in, but minting here
            # could reuse a published index (WAL replay gap, or the seq
            # probe still negotiating).  Returning False tells the node
            # the payload never rode a self-event, so it requeues.
            return False
        if other_head and self._head_creator_retired(other_head):
            # membership plane: never mint a merge on a RETIRED
            # creator's head — an honest leaver stops minting at its
            # boundary, so a post-boundary head from it is spam, and a
            # merge naming it would weave that spam into honest
            # ancestry (forcing every peer to accept it forever).
            # The payload re-queues and rides the next exchange.
            self.retired_merge_skips += 1
            self.last_insert_error = "peer head creator retired; merge skipped"
            return False
        if other_head == "":
            # headless responder: an observer (a joiner waiting on its
            # epoch boundary) or a probe-blocked peer has no chain yet,
            # so there is no merge parent to name — carry the payload
            # on a self-parent event instead of minting an event with
            # an empty other-parent (which every insert path rejects)
            return self.add_self_event(payload)
        if self.head == "":
            # a freshly-admitted member's first mint (a joiner at its
            # epoch boundary): the chain needs its root before a merge
            # event can reference it
            self.init()
        ev = new_event(
            payload, (self.head, other_head), self.key.pub_bytes,
            self.seq + 1, timestamp=self.now_ns(),
        )
        self.sign_and_insert_self_event(ev)
        return True

    def _head_creator_retired(self, head_hex: str) -> bool:
        """True when ``head_hex`` is held and its creator's column is
        retired in the current epoch (the merge gate's predicate)."""
        slot = self.hg.dag.slot_of.get(head_hex)
        if slot is None:
            return False
        retired = getattr(getattr(self.hg, "cfg", None), "retired", ())
        if not retired:
            return False
        ev = self.hg.dag.events[slot]
        return self.participants.get(ev.creator) in retired

    def add_self_event(self, payload: List[bytes]) -> bool:
        """Self-parent-only event carrying pooled txs (used when there is
        nothing to sync but transactions wait; reference core.go:159-169).
        Returns False (payload not minted) while recovery blocks minting."""
        if self.mint_blocked():
            return False
        if self.head == "":
            self.init()
        ev = new_event(
            payload, (self.head, self.head), self.key.pub_bytes,
            self.seq + 1, timestamp=self.now_ns(),
        )
        self.sign_and_insert_self_event(ev)
        return True

    # ------------------------------------------------------------------

    def run_consensus(self) -> Tuple[List[Event], Dict[str, float]]:
        """DivideRounds → DecideFame → FindOrder with per-phase timings
        (reference core.go:179-202).  The fused engine dispatches per
        flush between its latency and throughput compiled surfaces
        (engine.run_consensus_timed); the fork engine keeps the
        three-phase protocol."""
        timed = getattr(self.hg, "run_consensus_timed", None)
        if timed is not None:
            return timed()
        t0 = time.perf_counter()
        self.hg.divide_rounds()
        t1 = time.perf_counter()
        self.hg.decide_fame()
        t2 = time.perf_counter()
        new_events = self.hg.find_order()
        t3 = time.perf_counter()
        timings = {
            "divide_rounds_s": t1 - t0,
            "decide_fame_s": t2 - t1,
            "find_order_s": t3 - t2,
        }
        return new_events, timings

    # ------------------------------------------------------------------
    # stats (reference core.go:222-256)

    def consensus_events_count(self) -> int:
        return self.hg.consensus_events_count()

    def consensus_transactions_count(self) -> int:
        return self.hg.consensus_transactions

    def undetermined_events_count(self) -> int:
        return self.hg.undetermined_count

    def last_consensus_round(self) -> Optional[int]:
        return self.hg.last_consensus_round

    def last_committed_round_events_count(self) -> int:
        return self.hg.last_committed_round_events

    def stats_snapshot(self) -> Dict[str, int]:
        """Lock-free host-side counters (see engine.stats_snapshot)."""
        return self.hg.stats_snapshot()
