"""Runtime configuration (reference node/config.go:26-57): the port's copy
of the JAX package's ``node/config.py``, every field and default kept,
plus ``device``, the one place a node learns its card."""

from __future__ import annotations

import logging
from dataclasses import dataclass, field


def _default_logger() -> logging.Logger:
    logger = logging.getLogger("babble_tpu_torch")
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s %(message)s"
        ))
        logger.addHandler(h)
        logger.setLevel(logging.WARNING)
    return logger


@dataclass
class Config:
    heartbeat: float = 1.0          # seconds (reference default 1000ms)
    tcp_timeout: float = 1.0        # seconds
    cache_size: int = 500           # engine event capacity hint
    # Consensus cadence: 0 = run the pipeline after every sync (reference
    # node.go:224 behavior, whose per-sync cost is microseconds).  The
    # batched engine has a fixed per-call dispatch floor, so under fast
    # gossip a positive interval amortizes many syncs into one device
    # pipeline call — more events per kernel launch, and the core lock
    # stays free for serving peers.
    consensus_interval: float = 0.0  # seconds between pipeline runs
    # Outbound gossip backpressure: the heartbeat keeps ticking regardless
    # of how long syncs take (reference node.go:127-133), so without a cap
    # a slow patch floods the fleet with queued sync tasks whose timeouts
    # then read as failures.  The reference never hits this (its per-sync
    # work is microseconds); with a batched engine it matters.  A
    # heartbeat skipped because the cap is full increments
    # babble_gossip_skipped_total — saturation is visible on /metrics,
    # not inferred from a flat sync_rate.
    gossip_inflight: int = 4
    # ---- ingress plane (pipelined gossip + coalescing) ----
    # Pipelined sync: speculatively PUSH events to a peer keyed on the
    # last Known map we saw from it (ack carries its updated clock),
    # with the classic pull exchange as the reconciliation path — every
    # pipeline_reconcile-th gossip to a peer, on any push failure, and
    # whenever the ack shows the peer ahead of us.  False restores the
    # reference's lockstep request/response gossip.
    pipeline: bool = True
    pipeline_reconcile: int = 8
    # Peers gossiped per heartbeat tick (distinct targets, still under
    # the gossip_inflight cap).  The multiplexed transport carries the
    # concurrent exchanges on one connection per peer.
    gossip_fanout: int = 1
    # Eager gossip under load: when a gossip task finishes and client
    # transactions are pooled, launch the next gossip immediately
    # instead of waiting for the heartbeat deadline — the heartbeat
    # stays the *idle* pace, the pipeline depth (gossip_inflight) the
    # loaded one.
    gossip_eager: bool = True
    # Adaptive tx coalescing: a minted event carries at most
    # coalesce_max pooled transactions (batch size adapts to backlog —
    # the pool IS the batch, capped); a pooled tx waits at most
    # coalesce_latency seconds before a self-parent event is minted for
    # it even when no gossip completes (the latency bound; only active
    # while the gossip loop runs heartbeats).
    coalesce_max: int = 1024
    coalesce_latency: float = 0.05
    # Mint backpressure: deadline self-mints pause while the engine's
    # undetermined backlog exceeds this (None = cache_size // 4).  The
    # batch size is what adapts: with mints paused the pool keeps
    # growing toward coalesce_max, so overload produces fewer, FULLER
    # events instead of outrunning consensus until the window jams
    # (observed live: creation past the consensus window wedges
    # ordering at 0 ev/s).  Merge mints on gossip keep running — they
    # are what advances rounds and drains the backlog.
    mint_backpressure: int | None = None
    # Per-creator rolling-window length (TooLate beyond it).  None = use
    # cache_size, the reference's ParticipantEventsCache semantics; set it
    # smaller to keep the device window (and therefore the flush shapes)
    # fixed under sustained load — eviction then holds e_cap flat forever.
    seq_window: int | None = None
    # Fork-aware live mode: accept + detect equivocations instead of
    # rejecting them (the reference's only answer, hashgraph.go:366-396).
    byzantine: bool = False
    fork_k: int = 2      # branch slots per creator (fork budget K-1)
    # Honest-mode engine selection: "fused" (default; la/fd as [E+1, N]
    # device tensors) or "wide" (column-blocked rolling window — the
    # 10k-participant memory layout behind the same Core surface,
    # consensus/wide_engine.py).  Byzantine mode ignores this.
    engine: str = "fused"
    # Wide-engine window capacities (e_cap, s_cap, r_cap); None derives
    # a default from cache_size.  Fixed at boot — the wide engine
    # compacts instead of growing.
    wide_caps: tuple | None = None
    # Pre-sized byzantine pipeline capacities (e_cap, s_cap, r_cap).
    # None = grow monotone buckets on demand.  Pre-sizing gives every
    # node ONE pipeline shape at boot instead of a timing-dependent
    # growth sequence.
    fork_caps: tuple | None = None
    # ---- streaming incremental engine ----
    # Surface selection for the fused engine: "auto" picks the latency
    # flush (ops/flush.py, over persisted device frontiers) for
    # gossip-sized flushes and the throughput phases for bulk ingest;
    # "latency"/"throughput" pin one path (parity tests, benches).
    # Wide/byzantine engines ignore this.
    kernel_class: str = "auto"
    # ---- kernel working-set diet ----
    # Bit-packed votes: the latency flush's see/strongly-see/
    # vote tallies run over 8:1 uint8 lanes with popcount
    # supermajorities instead of f32 einsums.  Bit-parity-preserving;
    # False pins the pre-diet f32 tally (differential tests, the
    # bench's before/after arm).
    packed_votes: bool = True
    # Event-axis frontier: the windowed order phase scans only the
    # F-row frontier slice of fd (power-of-two-bucketed live frontier
    # height) instead of the full [E+1, N] column per round.  False
    # pins full-height scans.
    frontier: bool = True
    # AOT prewarm (ops/aot.py): a directory makes the node record the
    # shapes its engine runs there (babble_aot_manifest.json) and, on
    # the card, run the recorded shapes once at boot, so a restart pays
    # the CUDA context, the kernels' module loads and any kernel build
    # before its first flush instead of in it.  "" disables the prewarm.
    aot_dir: str = ""
    # Maximum continuation frames one gossip may stream when a push
    # diff exceeds the per-frame event cap (deep catch-up pushes chain
    # frames over the multiplexed connection instead of falling back
    # to pull rounds); 0 restores single-frame pushes.
    push_stream_max: int = 16
    # ---- silent-peer survival ----
    # Per-creator eviction: a creator whose chain head falls more than
    # this many DECIDED rounds behind lcr loses its seq-window
    # retention — its tail evicts, memory stays bounded through the
    # outage, and its return is forced through (verified) fast-forward.
    # None disables (one dead peer then pins eviction fleet-wide).
    # Fused engine only; wide/byzantine engines keep prefix eviction.
    inactive_rounds: int | None = 32
    # Verified fast-forward: require the responder's signed state proof
    # AND ff_proof_quorum matching peer attestations of the committed
    # frontier before adopting a snapshot.  Off = the pre-proof trust
    # model (any serving peer can feed a forged state).
    ff_verify: bool = True
    # Matching signed digests required to adopt (responder included).
    # None = n//3 + 1: any such set contains an honest signer while
    # fewer than a third of participants are byzantine.
    ff_proof_quorum: int | None = None
    # Rolling attestation checkpoints: every
    # anchor_interval commits the node gathers an attestation quorum
    # for the (position, digest) anchor it just crossed and keeps the
    # co-signed bundle in a bounded ring, served over the StateProof
    # RPC.  A joiner whose snapshot extends beyond every live
    # attester's frontier verifies the commit suffix against the
    # newest anchor instead of failing the quorum.  0 disables
    # collection (serving/verifying stays on).
    anchor_interval: int = 2048
    # ---- membership plane ----
    # Epoch-0 validator set when it differs from the gossip address
    # book: a JOINER boots knowing the founding peers (its consensus
    # bootstrap set) while its own address is only in `peers` — it runs
    # as an observer until its signed join tx commits and the epoch
    # boundary admits it.  None = the peers list IS the validator set
    # (the static pre-membership behavior).
    bootstrap_peers: list | None = None
    # ---- attribution plane ----
    # Commit-lineage tracing: a bounded per-tx/per-event lifecycle
    # ledger (obs/lineage.py) keyed on the hashes consensus already
    # computes — served loopback-gated at /debug/lineage?tx= and
    # stitched fleet-wide by `fleet trace <txid>`.  Zero wire or
    # consensus changes; False turns every hook into a no-op (the
    # bench's tracing-overhead A/B switch).
    lineage: bool = True
    # Flight recorder: a bounded ring of structured state-transition
    # records (obs/flight.py) — epoch applies, eviction horizon
    # advances, FF attempts/rejects, probe arm/resolve, admission shed
    # episodes, kernel fallbacks — dumped at /debug/flight, on node
    # crash, and attached to chaos invariant violations.
    flight: bool = True
    # Commit-latency SLO (seconds) for the /healthz burn gauge: the
    # fraction of recent commit batch deliveries slower than this.
    commit_slo: float = 1.0
    # Phase probe: dispatch the fused latency
    # flush as three separately-timed sub-programs (ingest / fame /
    # order) so babble_consensus_phase_seconds splits the fused
    # kernel's wall time per phase.  Bit-identical results (the same
    # impl functions run in the same order); costs one host sync per
    # phase, so it is a profiling posture, not the default.
    phase_probe: bool = False
    # Durability plane (wal/): "" disables the write-ahead
    # log (the pre-WAL behavior — restarts may re-mint published seqs
    # unless a fresh checkpoint exists).  With a directory set, every
    # inserted event is logged (self-events before they're gossipable)
    # and restart replays the tail on top of the newest checkpoint.
    wal_dir: str = ""
    # Fsync policy: "always", "batch(n,ms)" (bare "batch" = 64,50ms),
    # or "off" (flush only — the tier-1 test fast path).
    wal_fsync: str = "batch"
    # The card the node's engine runs on ("cuda" by default; "cpu" runs
    # every stage in plain torch on the host).  Fast-forward snapshots
    # are restored onto the same device.
    device: str = "cuda"
    logger: logging.Logger = field(default_factory=_default_logger)

    @classmethod
    def test_config(cls, heartbeat: float = 0.005,
                    device: str = "cuda") -> "Config":
        logger = logging.getLogger("babble_tpu_torch.test")
        logger.setLevel(logging.WARNING)
        return cls(heartbeat=heartbeat, tcp_timeout=0.2, device=device,
                   logger=logger)
