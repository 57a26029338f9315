"""Node: the gossip event loop (reference node/node.go:35-351).

One asyncio task multiplexes, exactly like the reference's select loop:
- inbound sync/push RPCs from the transport consumer,
- a randomized heartbeat timer triggering outbound gossip,
- app transactions from the proxy's submit queue (buffered in a pool until
  the next self-event),
- commit batches flowing back to the app,
- shutdown.

Core access is serialized by an asyncio lock (the reference's coreLock);
consensus itself stays single-threaded while the device programs run batched.

The ingress plane reworked the live hot path around that loop:

- **pipelined gossip** — each heartbeat speculatively PUSHES the events
  a peer lacks, keyed on the last Known map seen from it (its pull
  requests, push acks and sync responses all refresh the cache),
  instead of the reference's lockstep ask-wait-apply exchange; the
  classic pull sync stays as the reconciliation path (every
  ``pipeline_reconcile``-th gossip, after any push failure, and
  whenever an ack shows the peer ahead).  Inbound pushes mint a merge
  event exactly like applied sync responses do, so event creation is no
  longer bounded by one outbound RPC per heartbeat.
- **greedy submit drain + adaptive coalescing** — one select wakeup
  drains the whole submitted burst into the pool (the reference woke
  once per tx, node.py:272,291 pre-PR), and a minted event carries up
  to ``coalesce_max`` pooled txs; a pooled tx waits at most
  ``coalesce_latency`` before a self-parent event is minted for it.
- **saturation visibility** — a heartbeat that cannot launch gossip
  because ``gossip_inflight`` is full increments
  ``babble_gossip_skipped_total`` instead of passing silently.

The port's copy of the JAX package's ``node/node.py``, over the port's
``Core`` and ``TorchHashgraph`` on ``Config.device``.  Consensus and sync
work run in the default executor, as in the JAX package, so several
nodes of one process may drive the card from worker threads.  With
``Config.byzantine`` the ``Core`` runs the fork-aware ``ForkHashgraph``,
and with ``Config.engine == "wide"`` the column-blocked
``WideHashgraph``.  With ``Config.aot_dir`` the node records its
engine's shapes, prewarms them at boot on the card (``ops/aot.py``; a
CPU engine warms none) and shows the build and dispatch counters on
``/metrics``.
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Dict, List, Optional

from ..common import TooLateError
from ..consensus.digest import fold
from ..consensus.engine import TorchHashgraph
from ..core.event import Event
from ..crypto.keys import KeyPair
from ..membership.epoch import verify_membership_chain
from ..net.commands import (
    FastForwardRequest,
    FastForwardResponse,
    PushRequest,
    PushResponse,
    StateProofRequest,
    StateProofResponse,
    SyncRequest,
    SyncResponse,
)
from ..net.peers import Peer, canonical_ids
from ..net.transport import Transport, TransportError
from ..obs import (
    SIZE_BUCKETS,
    FlightRecorder,
    LineageRecorder,
    LoopLagProbe,
    Registry,
    SpanTracer,
)
from ..membership.quorum import attestation_quorum, supermajority
from ..store.checkpoint import (
    engine_mode, load_snapshot, save_checkpoint, snapshot_bytes,
)
from ..store.proof import (
    sign_attestation, sign_snapshot_proof, snapshot_hash, verify_attestation,
    verify_snapshot_digest, verify_snapshot_proof,
)
from ..wal import WriteAheadLog
from .config import Config
from .core import Core
from .peer_selector import RandomPeerSelector

#: /Stats timing keys are rendered from these phase histograms; the
#: children are pre-created so /metrics shows the full consensus-phase
#: distribution from boot, not from first observation.  "flush" is the
#: fused latency program (the streaming engine's single-launch path);
#: the three legacy phases are the throughput surface.
_CONSENSUS_PHASES = ("divide_rounds", "decide_fame", "find_order", "flush")

#: kernel classes the flush histogram splits on (engine.last_kernel_class)
_KERNEL_CLASSES = ("latency", "throughput")

#: bounds for one speculative push frame.  The diff is topologically
#: sorted and parents precede children, so a PREFIX is ancestry-closed
#: relative to the peer's advertised Known — the tail simply rides the
#: next rounds.  Both a count cap AND a byte budget apply: coalesced
#: events can carry a KB of transactions each, so an event-count cap
#: alone could still assemble a frame past MAX_FRAME — which would
#: fail the push (FrameTooLarge) on every retry after paying the full
#: encode each time.  Deep catch-up belongs to pull/fast-forward.
PUSH_MAX_EVENTS = 512
PUSH_MAX_BYTES = 4 * 1024 * 1024

#: rolling attestation checkpoints kept (newest last) — enough depth
#: that a joiner's snapshot window always spans one, tiny enough that
#: the ring is noise in the node's footprint
ANCHOR_RING = 8


class FFProofError(Exception):
    """A fast-forward snapshot failed signed-state-proof verification
    (missing/invalid responder signature, digest inconsistent with the
    snapshot bytes, or attestation quorum not reached).  The joiner
    refuses the snapshot LOUDLY — babble_ff_proof_rejects_total — and
    retries against another peer on a later gossip round, instead of
    silently installing a forged state (the FAST'18 protocol-aware-
    recovery failure mode)."""


def _push_prefix(diff: List[Event]) -> List[Event]:
    """Ancestry-closed prefix of a topologically-sorted diff that fits
    the push frame bounds (len()-based estimate, never encodes).  A
    truncated diff no longer falls back to pull rounds: the sender
    streams continuation frames over the multiplexed connection
    (Node._gossip_push), each keyed on the peer's post-insert Known
    from the previous ack, until the diff drains or
    ``Config.push_stream_max`` frames have flown."""
    if len(diff) > PUSH_MAX_EVENTS:
        diff = diff[:PUSH_MAX_EVENTS]
    budget = PUSH_MAX_BYTES
    for i, ev in enumerate(diff):
        budget -= 96 + sum(len(t) for t in ev.body.transactions)
        if budget < 0:
            return diff[: max(i, 1)]
    return diff


class Node:
    def __init__(
        self,
        conf: Config,
        key: KeyPair,
        peers: List[Peer],
        transport: Transport,
        proxy,
        engine: Optional[TorchHashgraph] = None,
        registry: Optional[Registry] = None,
    ):
        self.conf = conf
        self.logger = conf.logger
        self.transport = transport
        self.proxy = proxy
        # per-node telemetry: the registry backs /metrics (and the
        # legacy /Stats timing keys), the tracer backs /debug/spans.
        # Each node owns its own so in-process fleets (tests) don't
        # cross streams; the node instruments its transport below so
        # the wire-level series land on the same /metrics page.
        self.registry = registry if registry is not None else Registry()
        self.tracer = SpanTracer()
        # Attribution plane: the lineage recorder holds the
        # per-tx/per-event lifecycle ledgers behind /debug/lineage and
        # `fleet trace`; the flight recorder the state-transition ring
        # behind /debug/flight and the chaos post-mortems.  Both are
        # NODE-owned (like the tracer): a fast-forward engine swap or
        # checkpoint restart replaces self.core.hg, never these —
        # tests/test_lineage.py pins that records survive the swap.
        self.lineage = LineageRecorder(enabled=conf.lineage)
        self.flight = FlightRecorder(enabled=conf.flight)

        # Membership plane: the epoch-0 validator set may be a strict
        # subset of the gossip address book — a joiner knows the
        # founders (bootstrap_peers) but is not a member until its
        # signed join tx commits and the boundary admits it.
        member_peers = conf.bootstrap_peers or peers
        participants = canonical_ids(member_peers)
        if key.pub_hex not in participants and conf.bootstrap_peers is None:
            # fail FAST on the static-deployment misconfiguration: a
            # key missing from peers.json used to KeyError at boot, and
            # silently degrading it to a permanent observer would run
            # the fleet one validator short until someone noticed.
            # Observer mode is only for DECLARED joiners
            # (Config.bootstrap_peers set).
            raise ValueError(
                "this node's key is not in the peer set — add it to "
                "peers.json, or declare the node a joiner via "
                "Config.bootstrap_peers / --bootstrap_peers"
            )
        self.participants = participants
        local_addr = transport.local_addr()
        own_id = participants.get(key.pub_hex, -1)
        #: gossip address -> participant id (the push reconciliation
        #: check needs to know which Known column is the peer's own).
        #: Address-book entries outside the epoch's validator set (a
        #: joiner's own row before its join commits) have no column yet
        #: — _sync_membership fills them at the boundary.
        self._addr_cid = {
            p.net_addr: participants[p.pub_key_hex]
            for p in peers if p.pub_key_hex in participants
        }
        #: gossip address -> participant pub hex (fast-forward proof
        #: verification resolves the responder's/attester's key by the
        #: address the RPC went to)
        self._addr_pub = {p.net_addr: p.pub_key_hex for p in peers}

        # durability plane: the WAL constructor performs recovery
        # (scan + truncate-at-first-bad-record); Core replays the
        # surviving tail on top of `engine` below, so head/seq resume
        # at the node's true published position
        wal = None
        if conf.wal_dir:
            wal = WriteAheadLog(
                conf.wal_dir, fsync=conf.wal_fsync, registry=self.registry
            )
        self.core = Core(
            own_id, key, participants,
            commit_callback=None, engine=engine,
            wal=wal,
            e_cap=max(conf.cache_size, 64),
            cache_size=conf.cache_size,
            seq_window=conf.seq_window,
            byzantine=conf.byzantine,
            fork_k=conf.fork_k,
            fork_caps=conf.fork_caps,
            wide=(getattr(conf, "engine", "fused") == "wide"),
            wide_caps=conf.wide_caps,
            registry=self.registry,
            kernel_class=conf.kernel_class,
            inactive_rounds=conf.inactive_rounds,
            lineage=self.lineage,
            phase_probe=conf.phase_probe,
            packed_votes=getattr(conf, "packed_votes", True),
            frontier=getattr(conf, "frontier", True),
            device=conf.device,
        )
        if self.core.probing:
            self.flight.note("probe_armed",
                             quorum=self.core._probe_quorum)
        # AOT prewarm (ops/aot.py): on the card, run the recorded shapes
        # before the first flush (fused, fork or wide: prewarm_engine
        # dispatches on the engine kind), moving the CUDA context, the
        # kernel module loads and any kernel build out of it; a CPU node
        # only records its shapes (aot.warms_at_boot).  The build and
        # dispatch counters show on /metrics either way
        if conf.aot_dir:
            from ..ops import aot as _aot

            _aot.bind_registry(self.registry)
            if _aot.warms_at_boot(self.core.hg.device):
                res = _aot.prewarm_engine(self.core.hg, conf.aot_dir)
                self.logger.info(
                    "AOT prewarm: %d programs compiled (%d from manifest)",
                    res["compiled"], res["from_manifest"],
                )
            else:
                _aot.configure(conf.aot_dir)
                self.core.hg._aot_dir = conf.aot_dir
        self.core_lock = asyncio.Lock()
        self.peer_selector = RandomPeerSelector(peers, local_addr)
        #: membership-log entries already reconciled into the node's
        #: address maps / selector / metrics, tracked by EPOCH (epochs
        #: are strictly increasing, so the cursor survives both engine
        #: swaps AND the bounded log's truncation — an entry index
        #: would go stale the first time the log trims its head)
        self._membership_seen_epoch = 0
        #: rolling attestation checkpoints: bounded
        #: ring of quorum-co-signed CommitDigest anchors, newest last.
        #: Each entry: position, digest, epoch, sigs=[(pub, r, s), ...]
        #: A checkpoint-restored engine carries the pre-restart ring
        #: (store.checkpoint v6 meta) — seed from it so a restarted
        #: responder serves proofs immediately instead of re-collecting
        #: at the next boundary.  Fast-forward snapshots serialize an
        #: empty ring, so adopted engines never donate one.
        self._anchors: List[dict] = list(
            getattr(self.core.hg, "restored_anchors", None) or ()
        )[-ANCHOR_RING:]
        # newest position already attempted — a restored ring means its
        # newest entry was already collected; don't re-canvass peers
        # for a boundary the pre-restart node anchored
        self._anchor_target = (
            self._anchors[-1]["position"] if self._anchors else 0
        )
        self._anchor_collecting = False
        # heartbeat pacing draws from a per-identity seeded stream, not
        # the process-global RNG (found by the consensus-nondeterminism
        # taint pass): the jitter exists to desynchronize heartbeats
        # ACROSS nodes, which distinct ids provide, and a seeded stream
        # makes live chaos pacing replayable per identity
        self._pacing_rng = random.Random(f"heartbeat:{own_id}")
        self.transaction_pool: List[bytes] = []
        #: monotonic time the OLDEST pooled tx entered an empty pool —
        #: the coalesce latency bound is measured from here
        self._pool_since: Optional[float] = None
        #: pipelined gossip: last Known map seen from each peer (their
        #: pull requests, push acks and sync responses all refresh it);
        #: the next speculative push to that peer is keyed on it
        self._peer_known: Dict[str, Dict[int, int]] = {}
        #: per-peer gossip counter driving the periodic pull
        #: reconciliation cadence (conf.pipeline_reconcile)
        self._gossip_count: Dict[str, int] = {}
        #: peers with an exchange in flight: a second concurrent push to
        #: the same peer would be keyed on the SAME stale Known map and
        #: re-ship the same events — pure duplicate decode/insert work
        #: at the receiver — so the scheduler picks another peer instead
        self._busy_peers: set = set()

        self._shutdown = asyncio.Event()
        self._tasks: List[asyncio.Task] = []
        self._gossip_tasks: set = set()
        #: short-lived helper tasks (post-push consensus runs) — kept so
        #: shutdown can cancel them and GC can't reap them mid-flight
        self._aux_tasks: set = set()
        # Commit batches flow through a queue drained by one committer task
        # (the reference's commitCh, node.go:137-141): batches are enqueued
        # under the core lock, so the app always sees consensus order even
        # when gossip tasks overlap.
        self._commit_queue: "asyncio.Queue[List[Event]]" = asyncio.Queue()
        self._committer: Optional[asyncio.Task] = None
        self._consensus_task: Optional[asyncio.Task] = None
        self._consensus_dirty = False

        self._last_consensus = 0.0
        self._fast_forwarding = False
        self.start_time = time.monotonic()

        # instruments (the reference declares but never increments its
        # sync counters, node.go:64-65; here they are real registry
        # counters, and the per-phase ns durations it only logs
        # (node.go:166-255, core.go:180-196) are histograms whose last
        # samples render the /Stats *_ms keys fleet-wide)
        m = self.registry
        self._m_sync_requests = m.counter(
            "babble_sync_requests_total", "outbound gossip syncs attempted")
        self._m_sync_errors = m.counter(
            "babble_sync_errors_total", "outbound gossip syncs failed")
        self._m_gossip_rtt = m.histogram(
            "babble_gossip_rtt_seconds",
            "sync RPC round-trip time (request sent to response parsed)")
        self._m_gossip_events = m.counter(
            "babble_gossip_events_received_total",
            "events carried by applied sync responses")
        self._m_ff_total = m.counter(
            "babble_fast_forwards_total",
            "snapshot catch-ups attempted after a too_late sync")
        self._m_ff_seconds = m.histogram(
            "babble_fast_forward_seconds",
            "fast-forward fetch+validate+bootstrap wall time")
        self._m_ff_rejects = m.counter(
            "babble_ff_proof_rejects_total",
            "fast-forward snapshots refused because the signed state "
            "proof was missing, invalid, inconsistent with the snapshot "
            "bytes, or short of the attestation quorum")
        # rolling attestation checkpoints
        self._m_anchor_collected = m.counter(
            "babble_anchor_checkpoints_total",
            "rolling attestation checkpoints collected (a quorum "
            "co-signed one CommitDigest anchor)")
        self._m_ff_anchor_adopts = m.counter(
            "babble_ff_anchor_verifies_total",
            "fast-forward adoptions that verified the commit suffix "
            "against a rolling attestation checkpoint because the "
            "live attestation quorum was unreachable")
        m.gauge(
            "babble_anchor_position",
            "committed position of the newest quorum-signed rolling "
            "attestation checkpoint held (0 = none yet)",
        ).set_function(
            lambda: self._anchors[-1]["position"] if self._anchors else 0)
        # transport-level drop of retired creators (membership plane)
        self._m_retired_rejects = m.counter(
            "babble_retired_ingress_rejects_total",
            "inbound pushes refused because the sender's creator key "
            "is retired in the current epoch (plus merge mints "
            "skipped on a retired peer's head)")
        self._m_sync_seconds = m.histogram(
            "babble_sync_seconds",
            "insert+mint wall time per applied sync response")
        self._m_consensus_seconds = m.histogram(
            "babble_consensus_seconds",
            "consensus pipeline wall time per run")
        self._m_phase_seconds = m.histogram(
            "babble_consensus_phase_seconds",
            "per-phase consensus pipeline wall time",
            labelnames=("phase",))
        for phase in _CONSENSUS_PHASES:
            self._m_phase_seconds.labels(phase)
        # flush wall time split by surface: the latency flush's
        # distribution and the throughput (bulk-ingest) one's
        self._m_flush_seconds = m.histogram(
            "babble_flush_seconds",
            "consensus flush wall time per kernel class",
            labelnames=("kernel",))
        for kc in _KERNEL_CLASSES:
            self._m_flush_seconds.labels(kc)
        self._m_gossip_skipped = m.counter(
            "babble_gossip_skipped_total",
            "heartbeats that launched no gossip because gossip_inflight "
            "was saturated")
        self._m_push_total = m.counter(
            "babble_push_total", "speculative event pushes attempted")
        self._m_push_errors = m.counter(
            "babble_push_errors_total",
            "speculative pushes that failed (reconciled via pull)")
        self._m_push_rtt = m.histogram(
            "babble_push_rtt_seconds",
            "push RPC round-trip time (request sent to ack parsed)")
        self._m_push_apply = m.histogram(
            "babble_push_apply_seconds",
            "insert+mint wall time per applied inbound push")
        self._m_push_frames = m.counter(
            "babble_push_stream_frames_total",
            "continuation frames streamed for push diffs past the "
            "per-frame event cap (deep catch-up without pull rounds)")
        self._m_coalesce_txs = m.histogram(
            "babble_coalesce_batch_txs",
            "client transactions coalesced into one minted event",
            buckets=SIZE_BUCKETS)
        self._m_deadline_mints = m.counter(
            "babble_coalesce_deadline_mints_total",
            "self-parent events minted because a pooled tx hit the "
            "coalesce_latency bound before any gossip carried it")
        self._m_mint_backpressure = m.counter(
            "babble_mint_backpressure_total",
            "deadline mint passes skipped because the undetermined "
            "backlog exceeded mint_backpressure")
        self._m_submitted_tx = m.counter(
            "babble_submitted_tx_total",
            "transactions accepted into the pool from the app")
        self._m_commit_tx = m.counter(
            "babble_commit_tx_total", "transactions delivered to the app")
        self._m_commit_retries = m.counter(
            "babble_commit_retries_total", "commit_tx delivery retries")
        self._m_commit_latency = m.histogram(
            "babble_commit_latency_seconds",
            "commit batch delivery wall time (dequeue to last app ack)")
        # sampled at scrape time: no bookkeeping at the mutation sites
        m.gauge(
            "babble_commit_queue_depth",
            "commit batches awaiting delivery to the app",
        ).set_function(self._commit_queue.qsize)
        m.gauge(
            "babble_transaction_pool",
            "transactions pooled for the next self-event",
        ).set_function(lambda: len(self.transaction_pool))
        m.gauge(
            "babble_gossip_backoff_creators",
            "creators under per-creator resync backoff (byzantine mode)",
        ).set_function(lambda: len(self.core._creator_backoff))
        # read through self.core.hg so both survive fast-forward engine
        # swaps; host-mirror reads only, no device sync on scrape
        m.gauge(
            "babble_evicted_creators",
            "creators whose retained tail was evicted for inactivity "
            "(their return must bootstrap via verified fast-forward)",
        ).set_function(
            lambda: getattr(self.core.hg, "_evicted_creators_cache", 0))
        m.gauge(
            "babble_flush_fallbacks_total",
            "flushes whose latency window could not cover the undecided "
            "round span (stalled-gate deferrals + throughput degrades)",
        ).set_function(
            lambda: getattr(self.core.hg, "flush_fallbacks", 0))
        # membership plane: the epoch the engine is at, and transitions
        # applied over this node's lifetime (both survive engine swaps
        # — read through self.core.hg)
        m.gauge(
            "babble_epoch",
            "consensus epoch (peer-set transitions applied since boot "
            "of the fleet's history)",
        ).set_function(lambda: getattr(self.core.hg, "epoch", 0))
        self._m_transitions = m.counter(
            "babble_membership_transitions_total",
            "peer-set transitions (join/leave) this node applied at an "
            "epoch boundary")
        m.gauge(
            "babble_membership_pending",
            "1 while a committed transition awaits its epoch boundary",
        ).set_function(
            lambda: 1 if getattr(self.core.hg, "pending_membership", None)
            else 0)
        # attribution plane: per-flush device-traffic estimates
        # (ops/flush.flush_bytes_estimate — item 4's before/after meter)
        # and the consensus-health gauges behind /healthz
        self._m_flush_bytes = m.histogram(
            "babble_flush_bytes_estimate",
            "estimated bytes touched per consensus flush (dominant-"
            "tensor model over the live DagState shapes)",
            buckets=SIZE_BUCKETS)
        self._m_flush_bytes_phase = m.counter(
            "babble_flush_bytes_estimate_total",
            "cumulative estimated flush bytes, by pipeline phase",
            labelnames=("phase",))
        for ph in ("ingest", "fame", "order"):
            self._m_flush_bytes_phase.labels(ph)
        #: health mirror: sampled on the consensus path (where the host
        #: views are already warm), read by gauges and /healthz with no
        #: device sync at scrape time
        self._health: Dict[str, object] = {
            "lcr_samples": [],       # (monotonic, lcr) ring, cap 32
            "creator_lags": {},      # cid -> decided rounds behind lcr
            "commit_lat": [],        # recent commit-batch latencies
        }
        m.gauge(
            "babble_round_advance_rate",
            "decided rounds per second over the recent consensus runs "
            "(0 while ordering is stalled)",
        ).set_function(self._round_advance_rate)
        m.gauge(
            "babble_quorum_margin",
            "active validators beyond the witness supermajority — how "
            "many more can fail before rounds stop deciding",
        ).set_function(self._quorum_margin)
        m.gauge(
            "babble_commit_slo_burn",
            "fraction of recent commit batch deliveries slower than "
            "Config.commit_slo",
        ).set_function(self._commit_slo_burn)
        self._m_creator_lag = m.gauge(
            "babble_creator_lag_rounds",
            "per-creator chain-head lag behind the last consensus "
            "round (sampled after each consensus run)",
            labelnames=("creator",))
        #: flight-recorder change detection (kernel fallbacks, eviction
        #: horizons) — previous values noted on the consensus path
        self._flight_seen = {"fallbacks": 0, "horizons": {},
                             "kernel": None}
        self._loop_probe = LoopLagProbe(m)
        # transport-level series (bytes in/out, pool reuse) land on the
        # same /metrics page when the transport supports instrumentation
        # (TCPTransport.instrument; in-memory test transports need not)
        instrument = getattr(transport, "instrument", None)
        if instrument is not None:
            instrument(m)
        # admission-control series (queue depth, sheds, client count)
        # land on the same page when the proxy fronts a real ingress
        proxy_instrument = getattr(proxy, "instrument", None)
        if proxy_instrument is not None:
            proxy_instrument(m)
        # ... and the ingress-side lineage/flight hooks (submit/admit/
        # shed records) bind the same late way
        bind_obs = getattr(proxy, "bind_observability", None)
        if bind_obs is not None:
            bind_obs(self.lineage, self.flight)
        # a checkpoint-restored engine may carry epochs this node's
        # boot peer list predates: reconcile the ledger now
        self._sync_membership()

    # ------------------------------------------------------------------
    # registry-backed mirrors of the legacy counters/dict

    @property
    def sync_requests(self) -> int:
        return int(self._m_sync_requests.value)

    @property
    def sync_errors(self) -> int:
        return int(self._m_sync_errors.value)

    @property
    def timings(self) -> Dict[str, float]:
        """The legacy last-gossip timing map (ms), rendered from the
        registry histograms' last samples — same /Stats keys as the
        ad-hoc dict this replaces, keys appearing on first observation."""
        out: Dict[str, float] = {}
        if self._m_sync_seconds.count:
            out["sync_ms"] = self._m_sync_seconds.last * 1e3
        if self._m_consensus_seconds.count:
            out["consensus_ms"] = self._m_consensus_seconds.last * 1e3
        for phase in _CONSENSUS_PHASES:
            h = self._m_phase_seconds.labels(phase)
            if h.count:
                out[f"{phase}_ms"] = h.last * 1e3
        return out

    # ------------------------------------------------------------------
    # consensus-health plane

    #: newest consensus run older than this = the node is not running
    #: consensus at all — /healthz must read stalled, not replay its
    #: last healthy rate forever
    HEALTH_STALL_AFTER_S = 30.0

    def _round_advance_rate(self) -> float:
        """Decided rounds per second, measured to NOW: a node whose
        consensus stopped running (full partition, dead fleet) decays
        toward zero instead of freezing at its pre-outage rate —
        samples only accrue while consensus runs, so the last sample's
        age is part of the denominator."""
        samples = self._health["lcr_samples"]
        if len(samples) < 2:
            return 0.0
        (t0, l0), (_t1, l1) = samples[0], samples[-1]
        dt = time.monotonic() - t0
        return (max(l1 - l0, 0) / dt) if dt > 0 else 0.0

    def _quorum_margin(self) -> int:
        active = self.core._active_count()
        return active - supermajority(active)

    def _commit_slo_burn(self) -> float:
        lat = self._health["commit_lat"]
        if not lat:
            return 0.0
        slo = self.conf.commit_slo
        return sum(1 for v in lat if v > slo) / len(lat)

    def _sample_health(self) -> None:
        """Update the health mirror after a consensus run.  Reads only
        host-side structures (and the engine's post-flush cached round
        view when present), so neither this nor any gauge scrape ever
        syncs the device."""
        snap = self.core.stats_snapshot()
        lcr = int(snap.get("last_consensus_round", -1))
        samples = self._health["lcr_samples"]
        samples.append((time.monotonic(), lcr))
        del samples[:-32]
        hg = self.core.hg
        rnd = getattr(hg, "_view", {}).get("round")
        chains = getattr(getattr(hg, "dag", None), "chains", None)
        if rnd is None or chains is None or lcr < 0:
            return
        base = hg.dag.slot_base
        lags: Dict[int, int] = {}
        for cid, chain in enumerate(chains):
            if len(chain) == 0:
                continue   # never minted (a declared joiner): no lag yet
            if not chain.window:
                # tail evicted for inactivity: lag is "the whole decided
                # history since its horizon" — report the eviction lag
                lags[cid] = lcr + 1
                continue
            try:
                head_round = int(rnd[chain[-1] - base])
            except (IndexError, ValueError):
                continue
            lags[cid] = max(lcr - head_round, 0)
        self._health["creator_lags"] = lags
        for cid, lag in lags.items():
            self._m_creator_lag.labels(str(cid)).set(lag)

    def healthz(self) -> Dict[str, object]:
        """The structured consensus-health verdict behind GET /healthz
        (and `fleet health`).  Everything here is a host mirror — safe
        to serve while a worker thread drives the device pipeline."""
        core = self.core
        hg = core.hg
        snap = core.stats_snapshot()
        reasons: List[str] = []
        if core._observer:
            reasons.append("observer")
        if core._retired_self:
            reasons.append("retired")
        if core.probing:
            reasons.append("seq_probe")
        if (not reasons) and core.seq + 1 < core.min_next_seq:
            reasons.append("below_mint_floor")
        pending = getattr(hg, "pending_membership", None)
        lags = dict(self._health["creator_lags"])
        # inactive_rounds None/0 = per-creator eviction DISABLED: there
        # is no horizon, so nobody is "behind" it — reporting one would
        # tell the operator a window was evicted that never will be
        inact = self.conf.inactive_rounds
        behind = sorted(
            cid for cid, lag in lags.items() if lag > inact
        ) if inact else []
        rate = self._round_advance_rate()
        samples = self._health["lcr_samples"]
        idle_s = (time.monotonic() - samples[-1][0]) if samples else 0.0
        stalled = (
            (rate == 0.0 or idle_s > self.HEALTH_STALL_AFTER_S)
            and int(snap.get("undetermined_events", 0)) > 0
            and len(samples) >= 2
        )
        status = "ok"
        if reasons or stalled:
            status = "degraded"
        dg = getattr(hg, "_digest", None)
        return {
            "status": status,
            "id": core.id,
            "minting_blocked": bool(reasons),
            "reasons": reasons,
            "probe_armed": bool(core.probing),
            "epoch_pending": bool(pending),
            "epoch_queue": len(getattr(hg, "membership_queue", ())),
            "epoch": int(snap.get("epoch", 0)),
            "lcr": int(snap.get("last_consensus_round", -1)),
            "commit_length": int(getattr(hg, "commit_length", 0)),
            "digest": getattr(hg, "commit_digest", ""),
            "digest_anchor": (
                {"pos": dg.anchor_pos, "hash": dg.anchor}
                if dg is not None else None
            ),
            "round_advance_rate": round(rate, 4),
            "consensus_idle_s": round(idle_s, 2),
            "stalled": stalled,
            "quorum_margin": self._quorum_margin(),
            "active_n": core._active_count(),
            "commit_slo_s": self.conf.commit_slo,
            "commit_slo_burn": round(self._commit_slo_burn(), 4),
            "creator_lags": {str(k): v for k, v in sorted(lags.items())},
            "behind_horizon": behind,
            "undetermined": int(snap.get("undetermined_events", 0)),
            "evicted_creators": int(snap.get("evicted_creators", 0)),
            "transaction_pool": len(self.transaction_pool),
        }

    # ------------------------------------------------------------------

    def _sync_membership(self) -> None:
        """Reconcile the node's address maps, gossip selector and
        metrics with the engine's membership log (membership plane).
        Called after every consensus run and after any engine swap —
        the log is consensus state, so entries arrive in the same order
        on every node, and processing is idempotent per epoch."""
        hg = self.core.hg
        # bounded membership_log: entries below the engine's base epoch
        # are truncated — their join ADDRESSES survive on the engine
        # (membership_addrs).  Fill only gaps: a gossip address we
        # already resolved must never be redirected by adopted state.
        base = int(getattr(hg, "membership_base_epoch", 0) or 0)
        if base > self._membership_seen_epoch:
            for pub, addr in getattr(hg, "membership_addrs", {}).items():
                if addr in self._addr_pub:
                    continue
                self._addr_pub[addr] = pub
                cid = self.core.participants.get(pub)
                if cid is not None:
                    self._addr_cid[addr] = cid
                    if cid not in getattr(
                            getattr(hg, "cfg", None), "retired", ()):
                        self.peer_selector.add_peer(
                            Peer(net_addr=addr, pub_key_hex=pub)
                        )
            self._membership_seen_epoch = base
        log = getattr(hg, "membership_log", ())
        for entry in log:
            if entry["epoch"] <= self._membership_seen_epoch:
                continue
            self._membership_seen_epoch = entry["epoch"]
            self._m_transitions.inc()
            pub, addr, kind = entry["pub"], entry["addr"], entry["kind"]
            self.flight.note("epoch_apply", epoch=entry["epoch"],
                             op=kind, pub=pub[:16],
                             boundary=entry["boundary"])
            if kind == "join":
                if pub == self.core.pub_hex:
                    self.core.adopt_membership()
                    self.logger.warning(
                        "epoch %s: this node JOINED the validator set "
                        "(id %d) at round %d", entry["epoch"],
                        self.core.id, entry["boundary"],
                    )
                else:
                    self._addr_pub[addr] = pub
                    cid = self.core.participants.get(pub)
                    if cid is not None:
                        self._addr_cid[addr] = cid
                    self.peer_selector.add_peer(
                        Peer(net_addr=addr, pub_key_hex=pub)
                    )
                    self.logger.warning(
                        "epoch %s: validator %s… joined at %s (round %d)",
                        entry["epoch"], pub[:18], addr, entry["boundary"],
                    )
            else:
                if pub == self.core.pub_hex:
                    self.core.retire_membership()
                    self.logger.warning(
                        "epoch %s: this node LEFT the validator set at "
                        "round %d; continuing as observer",
                        entry["epoch"], entry["boundary"],
                    )
                else:
                    # stop gossiping TO the departed member; inbound
                    # straggler events remain decodable (its column
                    # and address book entry stay)
                    for p in self.peer_selector.peers():
                        if p.pub_key_hex == pub:
                            self.peer_selector.remove_peer(p.net_addr)
                    self.logger.warning(
                        "epoch %s: validator %s… left (round %d)",
                        entry["epoch"], pub[:18], entry["boundary"],
                    )
            self.core.refresh_quorums()

    # ------------------------------------------------------------------
    # rolling attestation checkpoints: every
    # anchor_interval commits, gather an attestation quorum for the
    # (position, digest) anchor just crossed and keep the co-signed
    # bundle in a bounded ring.  The bundle is the portable proof a
    # fast-forward joiner verifies OFFLINE when every live attester's
    # frontier is below the snapshot — the bootstrap residual.

    def _maybe_collect_anchor(self) -> None:
        """Called after each consensus run (under the core lock — reads
        host mirrors only).  Launches at most one collection task."""
        k = self.conf.anchor_interval
        if not k or self._anchor_collecting or self.core._observer:
            return
        hg = self.core.hg
        length = int(getattr(hg, "commit_length", 0))
        target = (length // k) * k
        if target <= self._anchor_target or target <= 0:
            return
        digest = None
        if hasattr(hg, "commit_digest_at"):
            digest = hg.commit_digest_at(target)
        if digest is None:
            # rolled off the retained per-position history before we
            # got here (deep catch-up): skip to the next boundary
            self._anchor_target = target
            return
        self._anchor_collecting = True
        t = asyncio.create_task(
            self._collect_anchor(target, digest,
                                 int(getattr(hg, "epoch", 0)))
        )
        self._aux_tasks.add(t)
        t.add_done_callback(self._aux_tasks.discard)

    async def _collect_anchor(self, position: int, digest: str,
                              epoch: int) -> None:
        """Ask every peer to co-sign the anchor over the existing
        StateProof RPC; a quorum of matching signatures (ours included)
        makes it a rolling attestation checkpoint."""
        try:
            local = self.transport.local_addr()
            own_r, own_s = sign_attestation(
                self.core.key, position, digest, epoch
            )
            sigs = [(self.core.pub_hex, own_r, own_s)]
            needed = attestation_quorum(self.core._active_count())
            peers = sorted(
                p.net_addr for p in self.peer_selector.peers()
                if p.net_addr != local
            )
            answers = await asyncio.gather(
                *(self.transport.request(
                    peer,
                    StateProofRequest(from_addr=local, position=position,
                                      epoch=epoch),
                    timeout=self.conf.tcp_timeout,
                ) for peer in peers),
                return_exceptions=True,
            )
            seen = {self.core.pub_hex}
            for peer, att in zip(peers, answers):
                if isinstance(att, BaseException):
                    if isinstance(att, asyncio.CancelledError):
                        raise att
                    continue
                pub = self._addr_pub.get(peer)
                if (pub is None or pub in seen or not att.digest
                        or att.position != position
                        or att.digest != digest
                        or att.epoch != epoch):
                    continue
                if verify_attestation(pub, position, digest,
                                      att.sig_r, att.sig_s, epoch):
                    seen.add(pub)
                    sigs.append((pub, att.sig_r, att.sig_s))
            self._anchor_target = position
            if len(sigs) >= needed:
                self._anchors.append({
                    "position": position, "digest": digest,
                    "epoch": epoch, "sigs": sigs,
                })
                del self._anchors[:-ANCHOR_RING]
                self._m_anchor_collected.inc()
                self.flight.note("anchor", position=position,
                                 signers=len(sigs))
            else:
                # short of quorum (partition, laggards): the NEXT
                # boundary retries — anchors are periodic, not precious
                self.logger.debug(
                    "anchor at %d short of quorum (%d/%d)",
                    position, len(sigs), needed,
                )
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self.logger.warning("anchor collection failed: %s", e)
        finally:
            # single-flight guard, same shape as _fast_forwarding: set
            # before the awaits, cleared here, checked at entry with no
            # await between check and set
            self._anchor_collecting = False

    def _serve_anchor(self, position: int) -> Optional[list]:
        """Newest quorum-signed anchor at or below ``position``, in the
        wire bundle shape (StateProofResponse.anchor)."""
        for a in reversed(self._anchors):
            if a["position"] <= position:
                return [a["position"], a["digest"], a["epoch"],
                        [[pub, r, s] for pub, r, s in a["sigs"]]]
        return None

    def init(self) -> None:
        """Create the root event (reference node.go:105-112).  Skipped
        when WAL recovery already restored a head, deferred while the
        seq probe negotiates (a node whose durable state vanished must
        not mint seq 0 until a supermajority confirms nobody holds a
        higher seq under our key), and skipped entirely for an
        observer (a joiner mints its root at the epoch boundary)."""
        if self.core._observer:
            self.logger.warning(
                "not in the epoch's validator set: observing until a "
                "join transition admits this key"
            )
            return
        if self.core.probing:
            self.logger.warning(
                "WAL missing or truncated: deferring first mint until a "
                "supermajority of peers confirm our published head seq"
            )
            return
        if self.core.head == "":
            self.core.init()

    async def save_checkpoint(self, path: str) -> None:
        """Snapshot consensus state under the core lock (see store.checkpoint
        — persistence the reference's Store seam never implemented).
        A successful save prunes the WAL: the checkpoint now carries
        everything the pruned records did.  The serialize + fsync runs
        in a worker thread (codec-on-loop discipline): a multi-MB
        checkpoint built inline would stall every RPC and heartbeat for
        its duration — the async lock still serializes core access."""
        loop = asyncio.get_running_loop()
        async with self.core_lock:
            def work():
                save_checkpoint(self.core.hg, path,
                                anchors=list(self._anchors))
                if self.core.wal is not None:
                    self.core.wal.checkpointed(self.core.seq, self.core.head)

            await loop.run_in_executor(None, work)

    async def run(self, gossip: bool = True) -> None:
        """The select loop (reference node.go:119-147)."""
        consumer = self.transport.consumer
        if self._committer is None:
            self._committer = asyncio.create_task(self._commit_loop())
        # loop-lag probe: one histogram saying whether the event loop
        # itself is starved (cancelled with the rest of _tasks)
        self._tasks.append(self._loop_probe.start())
        if (gossip and self.conf.consensus_interval > 0
                and self._consensus_task is None):
            self._consensus_task = asyncio.create_task(
                self._consensus_loop()
            )
            self._tasks.append(self._consensus_task)
        # The heartbeat is a fixed deadline, not an idle timeout: inbound
        # traffic must not postpone outbound gossip (the reference's timer
        # channel keeps ticking across select iterations, node.go:127-133).
        deadline = (
            time.monotonic() + self._random_timeout() if gossip else None
        )

        # The pool is bounded at one full mint burst: while it is at
        # capacity the loop does NOT drain the submit queue, so
        # backpressure propagates front-door-ward — the admission queue
        # fills and SHEDS (structured `overloaded`) instead of the node
        # buffering an unbounded backlog it cannot mint (the mint
        # backpressure gate pauses minting while consensus is behind)
        pool_cap = max(self.conf.coalesce_max, 1) * self.MINT_BURST_MAX

        while not self._shutdown.is_set():
            get_rpc = asyncio.ensure_future(consumer.get())
            get_tx = (
                asyncio.ensure_future(self.proxy.submit_queue.get())
                if len(self.transaction_pool) < pool_cap else None
            )
            shutdown = asyncio.ensure_future(self._shutdown.wait())
            waiters = [w for w in (get_rpc, get_tx, shutdown)
                       if w is not None]
            # the wakeup serves two deadlines: the heartbeat, and the
            # coalesce latency bound of the oldest pooled tx (gossip
            # mode only — the scenario runner's heartbeat-less loops
            # must stay wall-clock-free for determinism)
            eff_deadline = deadline
            if gossip and self._pool_since is not None:
                mint_at = self._pool_since + self.conf.coalesce_latency
                eff_deadline = (
                    mint_at if eff_deadline is None
                    else min(eff_deadline, mint_at)
                )
            timeout = (
                None if eff_deadline is None
                else max(0.0, eff_deadline - time.monotonic())
            )
            done, pending = await asyncio.wait(
                waiters,
                timeout=timeout,
                return_when=asyncio.FIRST_COMPLETED,
            )
            for p in pending:
                p.cancel()
            if shutdown in done:
                break
            if get_rpc in done:
                await self._process_rpc(get_rpc.result())
            if get_tx is not None and get_tx in done:
                # greedy burst drain: one wakeup pools the whole burst
                # instead of one tx per select iteration (the pre-PR
                # loop re-entered asyncio.wait per submitted tx) — up
                # to the pool cap, past which admission must shed
                self._note_tx(get_tx.result())
                q = self.proxy.submit_queue
                while len(self.transaction_pool) < pool_cap:
                    try:
                        self._note_tx(q.get_nowait())
                    except asyncio.QueueEmpty:
                        break
            if gossip and self._pool_since is not None \
                    and time.monotonic() >= (
                        self._pool_since + self.conf.coalesce_latency):
                # latency bound: no gossip carried the pooled txs in
                # time (unreachable peers, saturated pipeline) — mint a
                # self-parent event so the batch stops aging
                await self._mint_pooled()
            if gossip and time.monotonic() >= deadline:
                # backpressure: never queue more in-flight syncs than
                # the fleet can serve (Config.gossip_inflight); a
                # heartbeat fans out to gossip_fanout distinct peers on
                # the multiplexed transport
                for _ in range(max(1, self.conf.gossip_fanout)):
                    if not self._launch_gossip():
                        break
                # ABSOLUTE pacing: advance from the previous deadline, not
                # from now — rebasing to monotonic() leaks the loop's
                # servicing time into every cycle.  After a long stall,
                # re-anchor instead of bursting to catch up.
                deadline += self._random_timeout()
                now = time.monotonic()
                if deadline < now:
                    deadline = now + 0.2 * self._random_timeout()

    def run_task(self, gossip: bool = True) -> asyncio.Task:
        """RunAsync (reference node.go:114-117)."""
        t = asyncio.create_task(self.run(gossip))
        self._tasks.append(t)
        return t

    # ------------------------------------------------------------------
    # ingress: submit pooling + coalescing

    def _note_tx(self, tx: bytes) -> None:
        if not self.transaction_pool:
            self._pool_since = time.monotonic()
        self.transaction_pool.append(tx)
        self._m_submitted_tx.inc()
        self.lineage.note_tx(tx, "pool")

    def _take_payload(self) -> List[bytes]:
        """Pop up to ``coalesce_max`` pooled txs for the next minted
        event (caller holds the core lock).  The pool IS the adaptive
        batch: small under light load, up to the cap under backlog."""
        take = self.transaction_pool[: self.conf.coalesce_max]
        if take:
            del self.transaction_pool[: len(take)]
            # the remaining backlog gets a fresh latency window — it
            # was not starved, the cap simply split the burst
            self._pool_since = (
                time.monotonic() if self.transaction_pool else None
            )
        return take

    def _requeue(self, payload: List[bytes]) -> None:
        """A mint never happened (recovery gate, merge-skip,
        insert failure): the payload goes back to the FRONT of the pool
        so client ordering is preserved for the retry."""
        if not payload:
            return
        self.transaction_pool[:0] = payload
        if self._pool_since is None:
            self._pool_since = time.monotonic()

    #: self events minted per _mint_pooled call: bounds the core-lock
    #: hold (each mint is one ECDSA sign) while letting a deep backlog
    #: drain at thousands of events/s across deadline ticks
    MINT_BURST_MAX = 64

    async def _mint_pooled(self) -> None:
        """The coalesce latency bound: mint self-parent events for the
        pooled txs when no gossip carried them in time.  A backlog
        deeper than one batch mints a CHAIN of events (each carrying up
        to coalesce_max txs) in one executor call — receivers verify
        the chain head once (signature elision), so event creation is
        not bounded by the gossip exchange rate."""
        loop = asyncio.get_running_loop()
        async with self.core_lock:
            if not self.transaction_pool:
                return
            # engine backpressure: creating events faster than consensus
            # decides them eventually jams the window and ordering stops
            # dead — pause deadline mints (the pool keeps coalescing, so
            # the NEXT mint is fuller) until the backlog drains.  Merge
            # mints on gossip keep running; they advance rounds.
            limit = self.conf.mint_backpressure
            if limit is None:
                limit = max((self.conf.cache_size or 4096) // 4, 64)
            undet = self.core.stats_snapshot().get(
                "undetermined_events", 0)   # host mirror: no device sync
            if undet > limit:
                self._m_mint_backpressure.inc()
                self.flight.note_limited("mint_backpressure",
                                         backlog=undet)
                self._pool_since = time.monotonic()   # re-arm, don't spin
                return
            batches: List[List[bytes]] = []
            while self.transaction_pool and len(batches) < self.MINT_BURST_MAX:
                batches.append(self._take_payload())
            done = {"n": 0}

            def work():
                for b in batches:
                    if not self.core.add_self_event(b):
                        return
                    done["n"] += 1

            try:
                await loop.run_in_executor(None, work)
            finally:
                # mint_blocked (recovery gate) or an exception: the
                # unminted tail goes back to the pool front, in order
                for b in reversed(batches[done["n"]:]):
                    self._requeue(b)
            for b in batches[: done["n"]]:
                self._m_coalesce_txs.observe(len(b))
            if done["n"]:
                self._m_deadline_mints.inc(done["n"])
                if self.conf.consensus_interval > 0:
                    self._consensus_dirty = True

    # ------------------------------------------------------------------
    # ingress: gossip scheduling

    def _launch_gossip(self, eager: bool = False) -> bool:
        """Start one gossip task if the in-flight cap allows.  Heartbeat
        launches count a skip against babble_gossip_skipped_total when
        blocked; eager refills don't (they are opportunistic)."""
        if len(self._gossip_tasks) >= self.conf.gossip_inflight:
            if not eager:
                self._m_gossip_skipped.inc()
            return False
        peer = None
        for _ in range(max(len(self.peer_selector.peers()), 1)):
            cand = self.peer_selector.next()
            if cand is None:
                break
            if cand.net_addr not in self._busy_peers:
                peer = cand
                break
        if peer is None:
            return False
        self._busy_peers.add(peer.net_addr)
        t = asyncio.create_task(self._gossip_step(peer.net_addr))
        t._babble_peer = peer.net_addr
        self._gossip_tasks.add(t)
        t.add_done_callback(self._gossip_finished)
        return True

    def _gossip_finished(self, t: asyncio.Task) -> None:
        self._gossip_tasks.discard(t)
        self._busy_peers.discard(getattr(t, "_babble_peer", None))
        # eager pipeline refill: while client txs are pooled, a finished
        # PRODUCTIVE gossip immediately launches the next one instead of
        # waiting out the heartbeat — the heartbeat is the idle pace,
        # gossip_inflight the loaded pipeline depth.  Failed gossips
        # don't refill (the heartbeat retries), so an unreachable fleet
        # can't spin the loop.
        if not self.conf.gossip_eager or self._shutdown.is_set():
            return
        if t.cancelled() or t.exception() is not None:
            return
        if t.result() is not True or not self.transaction_pool:
            return
        self._launch_gossip(eager=True)

    async def _gossip_step(self, peer_addr: str) -> bool:
        """One scheduled gossip to ``peer_addr``: speculative push when
        we hold a cached Known for the peer, the classic pull exchange
        for reconciliation (periodically, and on any push failure).
        Returns True when an exchange was applied."""
        count = self._gossip_count.get(peer_addr, 0) + 1
        self._gossip_count[peer_addr] = count
        peer_known = self._peer_known.get(peer_addr)
        if not self.conf.pipeline or peer_known is None:
            return await self._gossip(peer_addr)
        # the transitive `_fast_forwarding` writes flagged on this call
        # are the documented busy-guard inside _fast_forward itself
        # (entry check + finally clear, no await between check and set)
        # — the flag's intermediate visibility is its designed semantics
        ok = await self._gossip_push(peer_addr, peer_known)  # babble-lint: disable=await-state-race
        if not ok:
            # wrong speculation (peer restarted, our cache stale): drop
            # the cache so the next rounds re-seed through pull
            self._peer_known.pop(peer_addr, None)
            return await self._gossip(peer_addr)
        if count % max(2, self.conf.pipeline_reconcile) == 0:
            # periodic full exchange: pulls events pushes can't see
            # (creators the peer learned of from others) and re-seeds
            # the Known cache from an authoritative response
            return await self._gossip(peer_addr)  # babble-lint: disable=await-state-race
        return True

    async def _gossip_push(
        self, peer_addr: str, peer_known: Dict[int, int]
    ) -> bool:
        """Speculatively ship the events ``peer_addr`` lacks per its
        last advertised Known.  The ack carries the peer's updated
        clock; if it shows the peer AHEAD of us for any creator, the
        pull exchange runs immediately as reconciliation."""
        loop = asyncio.get_running_loop()
        try:
            with self.tracer.span("push", peer=peer_addr):
                known_view = peer_known
                frames = 0
                while True:
                    async with self.core_lock:
                        def work():
                            diff = self.core.diff(known_view)
                            prefix = _push_prefix(diff)
                            for ev in prefix:
                                self.lineage.note_event(
                                    ev.hex(), "ship", peer=peer_addr
                                )
                            head = self.core.head
                            if len(prefix) < len(diff):
                                # truncated frame: our absolute head is
                                # NOT shipped, and the receiver's merge
                                # mint names the head as other-parent —
                                # point it at the newest own event this
                                # frame delivers instead (the receiver
                                # guards against unresolvable heads
                                # either way, Core.sync)
                                own = [e for e in prefix
                                       if e.creator == self.core.pub_hex]
                                if own:
                                    head = own[-1].hex()
                            return (self.core.to_wire(prefix),
                                    self.core.known(), head,
                                    len(diff) - len(prefix))

                        wire, my_known, head, rest = (
                            await loop.run_in_executor(None, work)
                        )
                    self._m_push_total.inc()
                    t0 = time.perf_counter()
                    resp = await self.transport.request(
                        peer_addr,
                        PushRequest(
                            from_addr=self.transport.local_addr(),
                            known=my_known, head=head, events=wire,
                        ),
                        timeout=self.conf.tcp_timeout,
                    )
                    self._m_push_rtt.observe(time.perf_counter() - t0)
                    self._peer_known[peer_addr] = dict(resp.known)
                    known_view = dict(resp.known)
                    self.peer_selector.update_last(peer_addr)
                    frames += 1
                    # multi-frame streaming: a diff past the per-frame
                    # cap (deep catch-up) chains continuation frames
                    # over the same multiplexed connection, each keyed
                    # on the peer's authoritative post-insert Known —
                    # instead of shipping one frame per heartbeat and
                    # leaving the tail to pull rounds.  The frame cap
                    # bounds one stream; the busy-peer guard already
                    # keeps concurrent pushes off this target.
                    if rest > 0 and frames <= self.conf.push_stream_max:
                        self._m_push_frames.inc()
                        continue
                    break
                # reconciliation trigger: the peer knows events of a
                # THIRD creator (or of us) that we lack — pull now.
                # The peer's OWN column is deliberately excluded: it is
                # always ahead by the merge event it just minted for
                # this very push, and that event reaches us on the
                # peer's next push (it knows our Known from this
                # request) — pulling for it doubled every exchange
                peer_cid = self._addr_cid.get(peer_addr)
                if any(v > my_known.get(cid, 0)
                       for cid, v in resp.known.items()
                       if cid != peer_cid):
                    await self._gossip(peer_addr)
            return True
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # push failures are part of the pipelined protocol (stale
            # speculation reconciles via pull) — they get their own
            # counter and never dent sync_rate
            self._m_push_errors.inc()
            self.logger.debug("push to %s failed: %s", peer_addr, e)
            return False

    async def shutdown(self) -> None:
        self._shutdown.set()
        committer = [self._committer] if self._committer is not None else []
        # Quiesce first: every insert and mint runs under the core lock,
        # its core work in an executor thread that cancellation cannot
        # stop.  Cancelling a task inside such a section would requeue a
        # payload the thread still mints (a duplicate as soon as the
        # pool is minted again or the WAL replays), or lose it once the
        # thread reaches the closed WAL.  asyncio.Lock serves its
        # waiters in order, so the section in flight and every section
        # queued for the lock before this acquire run to their end
        # first, all before the WAL closes; a task that asks for the
        # lock after it is cancelled while it waits, before it takes
        # anything.  (The JAX package's Node cancels first.)
        async with self.core_lock:
            for t in (list(self._gossip_tasks) + list(self._aux_tasks)
                      + self._tasks + committer):
                t.cancel()
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass
        await self.transport.close()
        if self.core.wal is not None:
            # graceful close writes the head receipt, so the next boot
            # trusts the (possibly just-pruned) log without a seq probe
            self.core.wal.close(self.core.seq, self.core.head)

    # ------------------------------------------------------------------
    # inbound

    async def _process_rpc(self, rpc) -> None:
        req = rpc.command
        try:
            if isinstance(req, FastForwardRequest):
                resp = await self._process_fast_forward_request(req)
            elif isinstance(req, StateProofRequest):
                resp = await self._process_state_proof_request(req)
            elif isinstance(req, PushRequest):
                resp = await self._process_push_request(req)
            else:
                resp = await self._process_sync_request(req)
            rpc.respond(resp)
        except TooLateError as e:
            # structured marker: the requester's Known fell below our
            # rolling window — it must fast-forward, not retry
            self.logger.info("sync request too late: %s", e)
            rpc.respond(None, error=f"too_late: {e}")
        except Exception as e:
            self.logger.warning("sync request failed: %s", e)
            rpc.respond(None, error=str(e))

    async def _process_sync_request(self, req: SyncRequest) -> SyncResponse:
        """Diff + wire conversion under the core lock (node.go:160-191).
        Runs in a worker thread so the event loop keeps serving submits
        and RPCs while the host index churns; the async lock still
        serializes all core access.  The requester's Known map seeds our
        speculative-push cache for that peer, and our own Known rides
        the response so the requester can seed ITS cache of us."""
        self._peer_known[req.from_addr] = dict(req.known)
        loop = asyncio.get_running_loop()
        async with self.core_lock:
            def work():
                diff = self.core.diff(req.known)
                for ev in diff:
                    self.lineage.note_event(
                        ev.hex(), "ship", peer=req.from_addr
                    )
                return (self.core.to_wire(diff), self.core.head,
                        self.core.known())

            wire, head, known = await loop.run_in_executor(None, work)
        return SyncResponse(
            from_addr=self.transport.local_addr(), head=head, events=wire,
            known=known,
        )

    async def _process_push_request(self, req: PushRequest) -> PushResponse:
        """Apply a speculative push: insert the shipped events and mint
        a merge event carrying our pooled transactions — the same apply
        path as a pull response, so inbound pushes create events too
        (event creation is no longer bounded by one outbound RPC per
        heartbeat).  The ack returns our post-insert Known.

        Transport-level drop of retired creators (membership plane): a
        push FROM a member retired in the current epoch is refused
        before any decode/insert/mint work — post-boundary, an honest
        leaver mints nothing (retire_membership blocks it), so its
        pushes can only carry spam mints or redundant relays, and a
        merge minted on its head would smuggle the spam into honest
        ancestry.  Pre-boundary straggler events it minted as a member
        still arrive through honest relays' frames, so no legitimate
        history is lost."""
        cid = self._addr_cid.get(req.from_addr)
        if cid is not None and cid in getattr(
                getattr(self.core.hg, "cfg", None), "retired", ()):
            self._m_retired_rejects.inc()
            raise ValueError(
                f"push from retired creator {cid} refused"
            )
        loop = asyncio.get_running_loop()
        async with self.core_lock:
            payload = self._take_payload()
            t0 = time.perf_counter()
            try:
                minted = await loop.run_in_executor(
                    None, self.core.sync, req.head, req.events, payload
                )
                if minted is False:
                    self._requeue(payload)
            except BaseException:
                # insert failure (our view genuinely lacked ancestry
                # the sender assumed): the error frame tells the sender
                # its speculation was stale; it reconciles via pull
                self._requeue(payload)
                raise
            self._m_push_apply.observe(time.perf_counter() - t0)
            self._m_gossip_events.inc(len(req.events))
            if minted is not False and payload:
                self._m_coalesce_txs.observe(len(payload))
            known = self.core.known()
            if self.conf.consensus_interval > 0:
                self._consensus_dirty = True
        if self.conf.consensus_interval <= 0:
            # interval<=0 keeps consensus-after-every-sync semantics,
            # but OFF the pusher's RPC window: the ack must not pay our
            # pipeline latency, so the run happens in its own task — launched
            # outside the lock block; it re-acquires the core lock on
            # its own schedule
            t = asyncio.create_task(self._consensus_after_push())
            self._aux_tasks.add(t)
            t.add_done_callback(self._aux_tasks.discard)
        self._peer_known[req.from_addr] = dict(req.known)
        return PushResponse(
            from_addr=self.transport.local_addr(), known=known
        )

    async def _consensus_after_push(self) -> None:
        try:
            async with self.core_lock:
                await self._run_consensus_locked(0)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self.logger.warning("post-push consensus failed: %s", e, exc_info=True)

    async def _process_fast_forward_request(
        self, req: FastForwardRequest
    ) -> FastForwardResponse:
        """Serve a catch-up snapshot (no reference counterpart — a peer
        behind the reference's rolling caches can never rejoin).  In
        byzantine mode the snapshot ships branch tips + divergence
        points + detection-relevant seeds, so the rejoining node resumes
        fork-aware with the same equivocation knowledge we hold.

        The response carries our SIGNED state proof (store/proof.py):
        the signature binds the exact snapshot bytes to our committed
        frontier ``(lcr, position, digest)``, which any honest peer can
        attest — the joiner's quorum check is what makes a forged
        snapshot rejectable instead of silently installable."""
        loop = asyncio.get_running_loop()
        async with self.core_lock:
            snap = await loop.run_in_executor(
                None, snapshot_bytes, self.core.hg
            )
            hg = self.core.hg
            lcr = int(hg._lcr_cache)
            position = hg.commit_length
            digest = hg.commit_digest
            epoch = int(getattr(hg, "epoch", 0))
            r, s = sign_snapshot_proof(
                self.core.key, snapshot_hash(snap), lcr, position,
                digest, epoch,
            )
        self.logger.info(
            "served fast-forward snapshot (%d bytes, frontier %d, "
            "epoch %d) to %s",
            len(snap), position, epoch, req.from_addr,
        )
        return FastForwardResponse(
            from_addr=self.transport.local_addr(), snapshot=snap,
            lcr=lcr, position=position, digest=digest, sig_r=r, sig_s=s,
            epoch=epoch,
        )

    async def _process_state_proof_request(
        self, req: StateProofRequest
    ) -> StateProofResponse:
        """Attest our commit digest at the requested position (a
        fast-forward joiner's quorum check).  When the position is
        ahead of our own frontier we attest what we CAN vouch for —
        our current frontier — and the joiner re-folds the snapshot
        window to compare.  Positions rolled off the retained digest
        history answer with an empty digest, which never counts toward
        anyone's quorum.  ``anchor`` requests are answered from the
        rolling-attestation-checkpoint ring instead: the newest
        quorum-co-signed anchor at or below the position (None when
        the ring holds none — the joiner falls back to another peer)."""
        if req.anchor:
            return StateProofResponse(
                from_addr=self.transport.local_addr(),
                position=req.position,
                epoch=int(getattr(self.core.hg, "epoch", 0)),
                anchor=self._serve_anchor(req.position),
            )
        async with self.core_lock:
            hg = self.core.hg
            digest = None
            pos = req.position
            epoch = int(getattr(hg, "epoch", 0))
            if pos >= 0 and hasattr(hg, "commit_digest_at"):
                pos = min(pos, hg.commit_length)
                digest = hg.commit_digest_at(pos)
            if digest is None:
                return StateProofResponse(
                    from_addr=self.transport.local_addr(),
                    position=req.position, epoch=epoch,
                )
            r, s = sign_attestation(self.core.key, pos, digest, epoch)
        return StateProofResponse(
            from_addr=self.transport.local_addr(), position=pos,
            digest=digest, sig_r=r, sig_s=s, epoch=epoch,
        )

    # ------------------------------------------------------------------
    # outbound gossip (node.go:193-261)

    async def _gossip(self, peer_addr: str) -> bool:
        """The classic pull exchange (and the pipelined path's
        reconciliation leg).  Returns True when a response was applied."""
        try:
            with self.tracer.span("gossip", peer=peer_addr):
                async with self.core_lock:
                    known = self.core.known()
                self._m_sync_requests.inc()
                t0 = time.perf_counter()
                resp = await self.transport.sync(
                    peer_addr,
                    SyncRequest(
                        from_addr=self.transport.local_addr(), known=known
                    ),
                    timeout=self.conf.tcp_timeout,
                )
                self._m_gossip_rtt.observe(time.perf_counter() - t0)
                if resp.known:
                    # authoritative re-seed of the push cache: the
                    # responder's own clock at response time
                    self._peer_known[peer_addr] = dict(resp.known)
                await self._process_sync_response(resp)
                self.peer_selector.update_last(peer_addr)
                return True
        except asyncio.CancelledError:
            raise
        except TransportError as e:
            if str(e).startswith("too_late"):
                # we fell behind the peer's rolling window: bootstrap from
                # a snapshot instead of retrying a sync that can never
                # work.  Any resync backoff is moot now — probing deeper
                # is what tripped the window
                async with self.core_lock:
                    self.core.reset_gossip_backoff()
                await self._fast_forward(peer_addr)
                return False
            self._m_sync_errors.inc()
            self.logger.warning("gossip to %s failed: %s", peer_addr, e)
        except Exception as e:  # any failure counts against sync_rate
            self._m_sync_errors.inc()
            self.logger.warning("gossip to %s failed: %s", peer_addr, e)
        return False

    def ff_max_caps(self) -> tuple:
        """(max_e, max_s, max_r) capacity bounds a fast-forward snapshot
        may declare — generous multiples of our own memory policy, so a
        hostile peer cannot OOM us with absurd array shapes."""
        n = len(self.core.participants)
        max_e = max(1 << 22, 64 * (self.conf.cache_size or 256) * n)
        return (max_e, 1 << 20, 1 << 16)

    def validate_ff_snapshot(self, engine) -> None:
        """Trust boundary for catch-up: snapshot trust
        extends to *ordering metadata only*, never membership.  A snapshot
        whose participant set differs from what we can DERIVE could swap
        in a fabricated validator set whose self-consistent signatures
        pass every later check — reject it outright.

        With the membership plane the derivable set is no longer just
        our boot peers.json: a snapshot from a later epoch carries its
        membership log — a chain of SUBJECT-SIGNED transitions — and is
        accepted exactly when replaying that chain on top of our
        current trusted set yields its claimed peer set
        (membership/epoch.verify_membership_chain).  The attestation
        quorum then ties the chain to committed history (the
        transitions are in the order the quorum co-signs).  A snapshot
        at OUR epoch must still match our set exactly."""
        local_epoch = int(getattr(self.core.hg, "epoch", 0))
        snap_epoch = int(getattr(engine, "epoch", 0))
        if snap_epoch == local_epoch:
            if engine.participants != self.core.participants:
                raise ValueError(
                    "fast-forward snapshot participant set does not "
                    "match local peers ({} vs {} entries)".format(
                        len(engine.participants),
                        len(self.core.participants),
                    )
                )
        else:
            local_retired = tuple(
                getattr(getattr(self.core.hg, "cfg", None), "retired", ())
            )
            err = verify_membership_chain(
                self.core.participants, local_retired, local_epoch,
                engine,
            )
            if err is not None:
                raise ValueError(f"fast-forward membership chain: {err}")
        # engine KIND must match: a fused node must not adopt a fork
        # snapshot or the reverse — byzantine is its own world
        if engine_mode(engine) != engine_mode(self.core.hg):
            raise ValueError(
                f"fast-forward snapshot engine kind "
                f"'{engine_mode(engine)}' does not match local "
                f"'{engine_mode(self.core.hg)}'"
            )
        max_e, max_s, max_r = self.ff_max_caps()
        if self.core.byzantine:
            # fork engines carry no DagConfig; the bounds are the window
            # length (checked against max_e pre-materialization too) and
            # the branch budget, which must match ours or branch-column
            # layouts diverge across the fleet
            if len(engine.dag.events) > max_e:
                raise ValueError(
                    "fast-forward snapshot window out of bounds: "
                    f"{len(engine.dag.events)} events"
                )
            if engine.dag.k != self.core.hg.dag.k:
                raise ValueError(
                    f"fast-forward snapshot fork budget k={engine.dag.k} "
                    f"differs from local k={self.core.hg.dag.k}"
                )
            return
        cap = engine.cfg
        if cap.e_cap > max_e or cap.s_cap > max_s or cap.r_cap > max_r:
            raise ValueError(
                f"fast-forward snapshot capacities out of bounds: {cap}"
            )

    def _ff_proof_quorum(self, engine=None) -> int:
        """Matching signed digests required to adopt a snapshot
        (responder included): with fewer than a third of the active set
        byzantine, any attestation_quorum(n) matching signers include
        an honest node, so a rewritten history can never gather a
        quorum.  ``n`` is the SNAPSHOT epoch's active count when an
        engine is given — the set that actually attests — else the
        local epoch's."""
        if self.conf.ff_proof_quorum is not None:
            return max(1, self.conf.ff_proof_quorum)
        n = None
        if engine is not None:
            cfg = getattr(engine, "cfg", None)
            if cfg is not None and hasattr(cfg, "active_n"):
                n = cfg.active_n
            else:
                n = len(engine.participants)
        if n is None:
            n = self.core._active_count()
        return attestation_quorum(n)

    def _verify_ff_responder(self, peer_addr: str,
                             resp: FastForwardResponse) -> None:
        """Cheap first gate: the responder's signature must bind the
        exact snapshot bytes to the claimed frontier before anything is
        parsed or any peer is bothered."""
        pub = self._addr_pub.get(peer_addr)
        if pub is None:
            raise FFProofError(f"responder {peer_addr} is not a known peer")
        if not resp.digest:
            raise FFProofError("response carries no signed state proof")
        if resp.epoch < int(getattr(self.core.hg, "epoch", 0)):
            # a snapshot from an OLDER epoch can never be adoptable
            # (its peer set is behind ours) — reject before parsing
            raise FFProofError(
                f"snapshot epoch {resp.epoch} behind local epoch "
                f"{getattr(self.core.hg, 'epoch', 0)}"
            )
        if not verify_snapshot_proof(
            pub, snapshot_hash(resp.snapshot), resp.lcr, resp.position,
            resp.digest, resp.sig_r, resp.sig_s, resp.epoch,
        ):
            raise FFProofError("responder proof signature invalid")

    async def _verify_ff_quorum(self, peer_addr: str,
                                resp: FastForwardResponse,
                                engine) -> None:
        """Gather the attestation quorum for the snapshot's committed
        frontier.  Attesters behind the responder answer at their OWN
        frontier (StateProofResponse.position <= requested); those are
        checked by re-folding the snapshot's consensus window up to
        that position over its digest anchor — so a lagging-but-honest
        fleet still reaches quorum, while any rewrite at or below an
        attested position mismatches some honest signer.  (Commits
        beyond every honest attester's current frontier are not yet
        quorum-verifiable — a forgery confined there defers detection
        to the first post-bootstrap divergence, the residual any
        bootstrap protocol under partial synchrony carries.)  Raises
        FFProofError when the quorum cannot be reached."""
        needed = self._ff_proof_quorum(engine)
        have = 1   # the responder's own signature
        local = self.transport.local_addr()
        dg = engine._digest
        window = list(engine.consensus)
        start = getattr(engine.consensus, "start", 0)
        # every attester is asked CONCURRENTLY (a joiner fast-forwards
        # exactly when parts of the fleet may be unreachable — serial
        # requests would stack one tcp_timeout per dead peer), and the
        # answers are evaluated in sorted-address order so the count is
        # deterministic under the chaos runner
        attesters = [
            peer for peer in
            sorted(p.net_addr for p in self.peer_selector.peers())
            if peer != peer_addr and peer != local
        ]
        answers = await asyncio.gather(
            *(self.transport.request(
                peer,
                StateProofRequest(from_addr=local,
                                  position=resp.position,
                                  epoch=resp.epoch),
                timeout=self.conf.tcp_timeout,
            ) for peer in attesters),
            return_exceptions=True,
        )
        for peer, att in zip(attesters, answers):
            if have >= needed:
                break
            if isinstance(att, BaseException):
                if isinstance(att, asyncio.CancelledError):
                    raise att
                self.logger.debug(
                    "attestation from %s failed: %s", peer, att)
                continue
            apub = self._addr_pub.get(peer)
            if not att.digest or apub is None \
                    or att.position > resp.position:
                continue
            # epoch discipline (membership plane): an attestation from
            # the WRONG epoch is a reject.  At the snapshot's frontier
            # the attester must be at the snapshot's epoch (same
            # position, different peer set = different history); a
            # lagging attester may be at an earlier epoch — its digest
            # vouches for the shared prefix — but never a later one at
            # a lower position.
            if att.position == resp.position and att.epoch != resp.epoch:
                continue
            if att.position < resp.position and att.epoch > resp.epoch:
                continue
            if att.position == resp.position:
                expected = resp.digest
            elif (dg.anchor is not None and dg.anchor_pos == start
                    and start <= att.position <= start + len(window)):
                expected = fold(dg.anchor, window[: att.position - start])
            else:
                continue   # attester frontier below the snapshot window
            if att.digest == expected and verify_attestation(
                apub, att.position, att.digest, att.sig_r, att.sig_s,
                att.epoch,
            ):
                have += 1
        if have < needed:
            # Rolling attestation checkpoints (the bootstrap residual): the
            # snapshot extends beyond every live attester's frontier
            # (or they are unreachable), so the LIVE quorum cannot
            # form.  Fall back to the newest quorum-co-signed anchor:
            # its signature set verifies offline against the snapshot's
            # peer set, and the commit suffix from the anchor to the
            # signed head re-folds against it.  Forged anchors die in
            # _verify_ff_anchor with FFProofError.
            await self._verify_ff_anchor(peer_addr, resp, engine,
                                         have, needed)

    async def _verify_ff_anchor(self, peer_addr: str,
                                resp: FastForwardResponse,
                                engine, have: int, needed: int) -> None:
        """Verify the snapshot's commit suffix against a rolling
        attestation checkpoint served by the responder.  Raises
        FFProofError unless a quorum-co-signed anchor (a) verifies
        signature-by-signature against the snapshot epoch's peer set,
        (b) lands inside the snapshot's consensus window at or below
        the signed frontier, and (c) the window re-folds from our
        digest anchor THROUGH the co-signed anchor — which, combined
        with verify_snapshot_digest's window->head re-fold, pins the
        whole suffix (anchor, head] to quorum-backed history."""
        local = self.transport.local_addr()
        try:
            ans = await self.transport.request(
                peer_addr,
                StateProofRequest(from_addr=local,
                                  position=resp.position,
                                  epoch=resp.epoch, anchor=1),
                timeout=self.conf.tcp_timeout,
            )
        except asyncio.CancelledError:
            raise
        except Exception as e:
            raise FFProofError(
                f"attestation quorum not reached ({have}/{needed}) and "
                f"no rolling anchor served: {e}"
            )
        if ans.anchor is None:
            raise FFProofError(
                f"attestation quorum not reached ({have}/{needed}) and "
                "the responder holds no rolling attestation checkpoint"
            )
        a_pos, a_digest, a_epoch, sigs = ans.anchor
        if not isinstance(a_digest, str) or len(a_digest) != 64 \
                or len(sigs) > len(engine.participants):
            raise FFProofError("rolling anchor malformed")
        if a_epoch > resp.epoch or a_pos > resp.position:
            raise FFProofError(
                f"rolling anchor ({a_pos}, epoch {a_epoch}) ahead of "
                f"the signed frontier ({resp.position}, epoch "
                f"{resp.epoch})"
            )
        dg = engine._digest
        window = list(engine.consensus)
        start = getattr(engine.consensus, "start", 0)
        if not (start <= a_pos <= start + len(window)):
            raise FFProofError(
                f"rolling anchor position {a_pos} outside the snapshot "
                f"window [{start}, {start + len(window)}]"
            )
        # the signer set: the snapshot epoch's ACTIVE participants —
        # validate_ff_snapshot later ties that set to its signed
        # membership chain before anything is adopted
        cfg = getattr(engine, "cfg", None)
        retired = set(getattr(cfg, "retired", ()))
        active = {
            pub for pub, cid in engine.participants.items()
            if cid not in retired
        }
        a_needed = attestation_quorum(len(active))
        good = set()
        for pub, r, s in sigs:
            if pub in good or pub not in active:
                continue
            if verify_attestation(pub, a_pos, a_digest, r, s, a_epoch):
                good.add(pub)
        if len(good) < a_needed:
            raise FFProofError(
                f"rolling anchor quorum invalid: {len(good)}/{a_needed} "
                f"verifiable signatures for ({a_pos}, {a_digest[:12]}…)"
            )
        if dg.anchor is None or dg.anchor_pos != start:
            raise FFProofError(
                "snapshot window carries no digest anchor to re-fold "
                "against the rolling checkpoint"
            )
        if fold(dg.anchor, window[: a_pos - start]) != a_digest:
            raise FFProofError(
                "snapshot consensus window does not re-fold to the "
                "quorum-signed rolling anchor — committed history at "
                "or below the checkpoint was rewritten"
            )
        self._m_ff_anchor_adopts.inc()
        self.flight.note("ff_anchor", peer=peer_addr, position=a_pos,
                         signers=len(good))
        self.logger.warning(
            "fast-forward verified against rolling attestation "
            "checkpoint (%d, %s…, %d signers); live quorum was %d/%d",
            a_pos, a_digest[:12], len(good), have, needed,
        )

    async def _fast_forward(self, peer_addr: str) -> None:
        """Catch-up: fetch a snapshot and restart consensus from it.

        Trust model: event signatures in the snapshot are
        re-verified, AND the snapshot must carry the responder's signed
        state proof over ``(snapshot_hash, lcr, position, digest)``
        co-attested by an n//3+1 quorum (``_verify_ff_proof``), with
        the consensus window re-folded against the signed digest after
        restore — a forged snapshot is rejected loudly
        (babble_ff_proof_rejects_total) instead of silently installed.
        Pooled transactions survive the swap and ride the next
        self-event."""
        if self._fast_forwarding:
            return
        self._fast_forwarding = True
        self._m_ff_total.inc()
        self.flight.note("ff_attempt", peer=peer_addr)
        t_ff = time.perf_counter()
        try:
            resp = await self.transport.request(
                peer_addr,
                FastForwardRequest(from_addr=self.transport.local_addr()),
                timeout=max(self.conf.tcp_timeout, 30.0),
            )
            if self.conf.ff_verify:
                self._verify_ff_responder(peer_addr, resp)
            # local policy overrides whatever the peer serialized — a
            # snapshot must not disable our signature checks or replace
            # our memory bounds
            cs = self.conf.cache_size
            if self.core.byzantine:
                # mirror Core.__init__'s byzantine knob derivation so a
                # fast-forwarded engine behaves like a fresh-boot one
                policy = {
                    "verify_signatures": True,
                    "auto_compact": bool(cs),
                    "seq_window": min(self.conf.seq_window or cs or 256, 256),
                    "compact_min": max((cs or 256) // 4, 32),
                    # explicit: the restore falls back to the PEER's
                    # serialized value for missing/None entries, and a
                    # hostile round_margin would freeze our window
                    "round_margin": 1,
                }
            elif engine_mode(self.core.hg) == "wide":
                # mirror Core's wide boot knobs exactly (cs fallback
                # included: the wide engine's fixed-memory contract
                # needs a bounded commit log and active compaction
                # whatever cache_size says); the restore path clamps
                # seq_window to the snapshot's s_cap//2
                cs_eff = cs or 4096
                policy = {
                    "verify_signatures": True,
                    "auto_compact": True,
                    "seq_window": self.conf.seq_window or cs_eff,
                    "consensus_window": 2 * cs_eff,
                    "compact_min": None,
                    "round_margin": 1,
                }
            else:
                policy = {
                    "verify_signatures": True,
                    "auto_compact": bool(cs),
                    "seq_window": self.conf.seq_window or cs or 256,
                    "consensus_window": 2 * cs if cs else None,
                    # None -> the engine derives its own default from
                    # e_cap; the peer's serialized values must not
                    # survive
                    "compact_min": None,
                    "round_margin": 2,
                    # LOCAL inactivity policy, not the peer's: a hostile
                    # round count here could freeze our window exactly
                    # like a hostile round_margin.  "Disabled" is
                    # spelled 0, NOT None — None is _pol's absent-key
                    # sentinel and would silently fall back to the
                    # peer's value
                    "inactive_rounds": (
                        0 if self.conf.inactive_rounds is None
                        else self.conf.inactive_rounds
                    ),
                }
            loop = asyncio.get_running_loop()
            # capacity + participant-count bounds are enforced INSIDE
            # load_snapshot on the declared meta and the npy headers,
            # before any array decompresses or any signature verifies —
            # a hostile snapshot must cost nothing to reject.  The
            # exact membership check happens on the restored engine
            # (validate_ff_snapshot): a later-epoch snapshot's set is
            # verified against its signed membership chain, so an
            # equality pre-check against OUR epoch's set would wrongly
            # reject every legitimate churned snapshot.  The load is
            # pure construction (no core state), so it runs OUTSIDE
            # the core lock, as does the attestation round-trip.
            engine = await loop.run_in_executor(
                None,
                lambda: load_snapshot(
                    resp.snapshot,
                    policy=policy,
                    max_participants=(
                        len(self.core.participants) + 1024
                    ),
                    max_caps=self.ff_max_caps(),
                    device=self.conf.device,
                ),
            )
            if self.conf.ff_verify:
                # local half of the proof: the restored engine's
                # committed window must re-fold to the digest the
                # responder signed — a forger that kept the honest
                # digest while rewriting the window is caught here,
                # before any peer is bothered for an attestation
                err = verify_snapshot_digest(
                    engine, resp.digest, resp.position
                )
                if err is not None:
                    raise FFProofError(err)
                await self._verify_ff_quorum(peer_addr, resp, engine)
            async with self.core_lock:
                # off-loop: membership-chain verification decodes the
                # log's embedded signed transitions (msgpack + ECDSA) —
                # codec-on-loop discipline, and the crypto is real work
                await loop.run_in_executor(
                    None, self.validate_ff_snapshot, engine
                )
                self.core.bootstrap(engine)
                # the adopted engine may be epochs ahead of our maps
                self._sync_membership()
                lost = self.core.last_bootstrap_lost_txs
                if lost:
                    # an unrecoverable own-chain suffix was discarded
                    # at the horizon (Core._replay_continuation_tail):
                    # its transactions re-enter the pool and ride the
                    # next mint under fresh, probe-guarded indexes
                    self._requeue(list(lost))
                    self.core.last_bootstrap_lost_txs = []
                    self.logger.warning(
                        "fast-forward discarded %d unrecoverable "
                        "own-chain transactions; re-pooled for re-mint",
                        len(lost),
                    )
                if (engine_mode(engine) == "byzantine"
                        and self.conf.fork_caps):
                    # snapshots carry no capacity hints: re-apply the
                    # pre-size so that the fast-forwarded engine runs at
                    # the configured capacities from its first tick
                    engine.pre_size(self.conf.fork_caps)
            window_len = (
                len(engine.dag.events) if self.core.byzantine
                else engine.dag.n_events - engine.dag.slot_base
            )
            self.logger.warning(
                "fast-forwarded from %s: %d events in window, lcr=%s",
                peer_addr, window_len, engine._lcr_cache,
            )
            self.flight.note("ff_adopt", peer=peer_addr,
                             lcr=int(engine._lcr_cache),
                             window=window_len)
            # The app missed every commit between its last delivery and
            # the snapshot cursor — surface the gap so state-machine apps
            # can restore from their own snapshot (the babbleio fast-sync
            # Snapshot/Restore seam; InmemAppProxy just records it).
            on_gap = getattr(self.proxy, "on_fast_forward", None)
            if on_gap is not None:
                try:
                    await on_gap(engine._lcr_cache)
                except Exception as e:
                    self.logger.warning(
                        "app fast-forward hook failed: %s", e
                    )
        except FFProofError as e:
            # a forged (or unprovable) snapshot: refuse loudly and keep
            # the current engine — the next too_late gossip retries the
            # fast-forward against another (honest) peer
            self._m_ff_rejects.inc()
            self.flight.note("ff_reject", peer=peer_addr, reason=str(e))
            self.logger.warning(
                "fast-forward snapshot from %s REJECTED: %s", peer_addr, e
            )
        except Exception as e:
            self._m_sync_errors.inc()
            self.logger.warning(
                "fast-forward from %s failed: %s", peer_addr, e
            )
        finally:
            dur = time.perf_counter() - t_ff
            self._m_ff_seconds.observe(dur)
            self.tracer.record("fast_forward", dur, peer=peer_addr)
            # deliberate re-entrancy flag: set before the awaits, checked
            # at entry, cleared in the finally — the check-then-set pair
            # has no await between them, so no second task can slip in
            self._fast_forwarding = False  # babble-lint: disable=await-state-race

    async def _process_sync_response(self, resp: SyncResponse) -> None:
        loop = asyncio.get_running_loop()
        async with self.core_lock:
            payload = self._take_payload()
            t0 = time.perf_counter()
            try:
                # Device compute runs in a
                # worker thread so the loop keeps serving; the async lock
                # still serializes all core access.
                minted = await loop.run_in_executor(
                    None, self.core.sync, resp.head, resp.events, payload
                )
                if minted is False:
                    # merge-skip: events inserted but no
                    # self-event minted — the payload must ride a later
                    # sync instead of vanishing
                    self._requeue(payload)
            except BaseException:
                # the sync never produced a self-event carrying the pooled
                # txs — put them back for the next attempt
                self._requeue(payload)
                raise
            if minted is not False and payload:
                self._m_coalesce_txs.observe(len(payload))
            t1 = time.perf_counter()
            self._m_sync_seconds.observe(t1 - t0)
            self._m_gossip_events.inc(len(resp.events))
            self.tracer.record("sync_apply", t1 - t0,
                               events=len(resp.events))
            if self.core.probing and self.core.probe_note(resp.from_addr):
                # seq skip-ahead resolved: a supermajority answered, the
                # engine head is the max published seq any of them saw
                self.flight.note("probe_resolved", seq=self.core.seq + 1)
                self.logger.warning(
                    "seq probe complete: resuming mints at seq %d",
                    self.core.seq + 1,
                )
                if self.core.head == "":
                    self.core.init()
            # Consensus cadence (Config.consensus_interval > 0): the
            # pipeline runs in its own task (_consensus_loop), OFF the
            # gossip critical path — a device pipeline call in the
            # middle of a sync response stalls both this node's next
            # heartbeat and every peer waiting on our diff.  interval
            # <= 0 keeps the reference's
            # consensus-after-every-sync shape (node.go:224).
            if self.conf.consensus_interval > 0:
                self._consensus_dirty = True
                return
            await self._run_consensus_locked(len(resp.events))

    async def _run_consensus_locked(self, n_events) -> None:
        """Run the consensus pipeline; caller holds the core lock."""
        loop = asyncio.get_running_loop()
        self._last_consensus = time.monotonic()
        t1 = time.perf_counter()
        # the span wraps the await so the device work dispatched to the
        # worker thread is timed from the awaiting coroutine; phase
        # records inside the span become its children in /debug/spans
        with self.tracer.span("consensus", events=n_events):
            new_events, phase_timings = await loop.run_in_executor(
                None, self.core.run_consensus
            )
            t2 = time.perf_counter()
            for k, v in phase_timings.items():
                phase = k[: -len("_s")]
                self._m_phase_seconds.labels(phase).observe(v)
                self.tracer.record(phase, v)
        kc = getattr(self.core.hg, "last_kernel_class", None)
        if kc in _KERNEL_CLASSES:
            self._m_flush_seconds.labels(kc).observe(t2 - t1)
        self._m_consensus_seconds.observe(t2 - t1)
        self.logger.debug(
            "sync %d events, consensus %.1fms",
            n_events, (t2 - t1) * 1e3,
        )
        self._note_flush_obs(kc, new_events)
        if new_events:
            # enqueue under the lock: batches reach the committer in
            # consensus order even when gossip tasks overlap
            self._commit_queue.put_nowait(new_events)
        # membership plane: the run may have applied an epoch boundary
        self._sync_membership()
        # rolling attestation checkpoints: commits may have crossed an
        # anchor boundary — gather the quorum off the consensus path
        self._maybe_collect_anchor()
        self._sample_health()

    def _note_flush_obs(self, kc, new_events) -> None:
        """Post-consensus observability bookkeeping: lineage
        commit records, flush-byte estimates, and flight-recorder
        transitions (kernel fallback, eviction horizon advance) — all
        host-mirror reads on the consensus path, where the views are
        already warm."""
        hg = self.core.hg
        for ev in new_events:
            self.lineage.note_commit(
                ev.hex(), ev.transactions, ev.round_received
            )
        fb = getattr(hg, "last_flush_bytes", None)
        if fb is not None:
            self._m_flush_bytes.observe(fb["total"])
            for ph in ("ingest", "fame", "order"):
                self._m_flush_bytes_phase.labels(ph).inc(fb[ph])
            hg.last_flush_bytes = None   # book each flush exactly once
        seen = self._flight_seen
        fallbacks = int(getattr(hg, "flush_fallbacks", 0))
        if fallbacks > seen["fallbacks"]:
            self.flight.note_limited("kernel_fallback", total=fallbacks)
        seen["fallbacks"] = fallbacks
        if kc is not None and kc != seen["kernel"]:
            if seen["kernel"] is not None:
                # rate-limited: a catch-up phase can flip the dispatch
                # per flush, and per-flip records would wash the ring
                self.flight.note_limited("kernel_class", to=kc)
            seen["kernel"] = kc
        heads = getattr(getattr(hg, "dag", None), "evicted_heads", None)
        if heads:
            for cid, horizon in heads.items():
                prev = seen["horizons"].get(cid)
                if prev is None or horizon[0] > prev:
                    seen["horizons"][cid] = horizon[0]
                    self.flight.note("eviction_horizon", creator=cid,
                                     index=horizon[0])

    async def _consensus_loop(self) -> None:
        """Dedicated consensus cadence (Config.consensus_interval > 0):
        one pipeline call per interval, batching every sync inserted
        since — same total order, fewer/larger kernel launches, and the
        only gossip cost is the lock hold of the call itself."""
        interval = self.conf.consensus_interval
        while not self._shutdown.is_set():
            await asyncio.sleep(interval)
            if not self._consensus_dirty:
                continue      # nothing inserted since the last run
            self._consensus_dirty = False
            try:
                async with self.core_lock:
                    await self._run_consensus_locked(0)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.logger.warning("consensus loop failed: %s", e, exc_info=True)

    async def _commit_loop(self) -> None:
        """Deliver consensus transactions to the app, strictly in batch
        order (reference node.go:263-272 via commitCh).  Delivery is
        at-least-once: transient app failures are retried with backoff —
        dropping would silently break the app's state-machine ordering.

        Delivery is batched when the proxy supports it (commit_batch:
        one RPC per consensus batch instead of one per tx — at fleet
        commit rates the per-call round trip IS the app-side
        bottleneck); an app answering `unknown method` demotes this
        node to the reference per-tx protocol permanently."""
        use_batch = getattr(self.proxy, "commit_batch", None)
        while True:
            events = await self._commit_queue.get()
            t0 = time.perf_counter()
            txs = [tx for ev in events for tx in ev.transactions]
            all_txs = txs
            if use_batch is not None and txs:
                try:
                    await self._deliver(use_batch, txs, len(txs),
                                        probe=True)
                    txs = []
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    # only the unknown-method probe escapes _deliver
                    # (transient failures retry inside it): demote to
                    # the reference per-tx protocol and redeliver this
                    # batch tx-by-tx — at-least-once is the app's
                    # contract already
                    self.logger.info(
                        "app lacks State.CommitTxBatch (%s); falling "
                        "back to per-tx commits", e,
                    )
                    use_batch = None
            for tx in txs:
                await self._deliver(self.proxy.commit_tx, tx, 1)
            for tx in all_txs:
                self.lineage.note_tx(tx, "deliver")
            dur = time.perf_counter() - t0
            self._m_commit_latency.observe(dur)
            lat = self._health["commit_lat"]
            lat.append(dur)
            del lat[:-128]
            self.tracer.record("commit_batch", dur, events=len(events))
            # completion signal for Queue.join() waiters: "queue empty"
            # alone cannot distinguish drained from batch-in-flight (the
            # chaos runner samples committed logs only once this fires)
            self._commit_queue.task_done()

    async def _deliver(self, call, payload, n_txs: int,
                       probe: bool = False) -> None:
        """One at-least-once delivery (batch or single tx) with the
        retry/backoff policy.  ``probe=True`` (the batch-verb capability
        probe only) re-raises `unknown method` so the caller can demote
        to the per-tx protocol; on the per-tx path the same error is
        just another app failure — retried and at worst dropped with a
        log line, never allowed to kill the committer task."""
        delay = 0.2
        for attempt in range(8):
            try:
                await call(payload)
                self._m_commit_tx.inc(n_txs)
                return
            except asyncio.CancelledError:
                raise
            except Exception as e:
                if probe and "unknown method" in str(e):
                    raise
                self._m_commit_retries.inc()
                self.logger.warning(
                    "commit delivery failed (attempt %d): %s",
                    attempt + 1, e,
                )
                await asyncio.sleep(delay)
                delay = min(delay * 2, 3.0)
        self.logger.error("commit delivery dropped after retries")

    def _random_timeout(self) -> float:
        """Randomized heartbeat pacing (reference node.go:345-351:
        uniform in [heartbeat, 2*heartbeat)), drawn from the node's
        seeded per-identity stream."""
        hb = self.conf.heartbeat
        return hb + self._pacing_rng.random() * hb

    # ------------------------------------------------------------------
    # stats (reference node.go:285-343)

    def get_stats(self) -> Dict[str, str]:
        # Host-side mirrors only (core.stats_snapshot): /Stats must answer
        # instantly and race-free while a worker thread drives the device
        # pipeline under the core lock.
        snap = self.core.stats_snapshot()
        elapsed = max(time.monotonic() - self.start_time, 1e-9)
        consensus_events = snap["consensus_events"]
        lcr = snap["last_consensus_round"]
        rounds = lcr + 1
        events_per_sec = consensus_events / elapsed
        rounds_per_sec = (rounds / elapsed) if rounds > 0 else 0.0
        total = self.sync_requests
        sync_rate = 1.0 if total == 0 else 1.0 - self.sync_errors / total
        return {
            "last_consensus_round": "nil" if lcr < 0 else str(lcr),
            "consensus_events": str(consensus_events),
            "consensus_transactions": str(snap["consensus_transactions"]),
            "undetermined_events": str(snap["undetermined_events"]),
            "transaction_pool": str(len(self.transaction_pool)),
            "num_peers": str(len(self.peer_selector.peers())),
            "sync_rate": f"{sync_rate:.2f}",
            "events_per_second": f"{events_per_sec:.2f}",
            "rounds_per_second": f"{rounds_per_sec:.2f}",
            "round_events": str(snap["last_committed_round_events"]),
            "evicted_events": str(snap["evicted_events"]),
            "live_window": str(snap["live_window"]),
            "id": str(self.core.id),
            # byzantine mode only: live equivocation count
            **({"forked_creators": str(snap["forked_creators"])}
               if "forked_creators" in snap else {}),
            **{k: f"{v:.2f}" for k, v in self.timings.items()},
        }
