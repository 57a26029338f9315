"""Scenario runner: execute a FaultPlan against a real node cluster (the
port's copy of the JAX package's ``chaos/scenario.py``).

Two execution modes over the same plan:

**Deterministic in-memory cluster** (:class:`ScenarioRunner`) — full
Node objects (gossip protocol, core lock, commit queue, fast-forward
path) over ``InmemNetwork`` transports wrapped in ``FaultyTransport``,
driven *sequentially*: the runner owns the only source of initiative
(one gossip exchange per step, consensus on an explicit cadence), node
select-loops run with heartbeats off and exist purely to serve inbound
RPCs and drain commits.  Combined with seed-derived identities
(:func:`~babble_tpu_torch.crypto.keys.key_from_scalar`), deterministic ECDSA
nonces, a seeded logical event clock and the injector's per-link RNG
streams, two runs of the same (scenario, seed) produce bit-identical
fault schedules AND bit-identical committed orders — the property the
acceptance tests fingerprint.

**Live fleet** (:func:`run_live`) — a ``testnet.TestnetRunner``
subprocess fleet where every node self-injects faults from the same
(plan, seed) via ``cli run --chaos_plan`` (cli.py wraps the TCP
transport in a FaultyTransport), the runner drives crash/restart from
the plan's schedule against wall-clock ticks, and the report is a
fleet-wide /Stats + /metrics sweep (``babble_chaos_faults_total``
distinguishes injected faults from organic ones).  Wall-clock fleets
are not bit-reproducible — the *fault schedule* still is, per link.

Every node's engine lives on ``device``, the card by default: the fused
engine, or the fork-aware ``ForkHashgraph`` for a scenario with
``"engine": "byzantine"`` (``fork-attack``).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import random
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ..crypto.keys import P256_ORDER, KeyPair, key_from_scalar, sha256
from ..net.inmem_transport import InmemNetwork
from ..net.peers import Peer
from ..node.config import Config
from ..node.node import Node
from ..proxy.inmem import InmemAppProxy
from .disk import apply_disk_faults
from .injector import FaultInjector
from .invariants import InvariantChecker, InvariantReport
from .plan import ByzantineSpec, Scenario, crash_schedule
from .transport import FaultyTransport

#: the runner makes one gossip exchange a step and a consensus pass
#: every this many steps
CONSENSUS_EVERY = 6

#: the runner's nodes wait this long for an answer to an RPC.  Every
#: fault the runner injects fails or delays an exchange outside that
#: wait, so a wait that ran out would be the host's own slowness (a
#: serve thread held up by load, a first call on the card) and would
#: change the run's result; Config.test_config's 0.2 s is within reach
#: of both
RPC_TIMEOUT_S = 30.0


def deterministic_keys(seed: int, n: int) -> List[KeyPair]:
    """n keypairs derived from the seed, sorted by pub hex so list
    index == canonical participant id."""
    keys = []
    for i in range(n):
        digest = sha256(f"babble-chaos-key:{seed}:{i}".encode())
        d = int.from_bytes(digest, "big") % (P256_ORDER - 1) + 1
        keys.append(key_from_scalar(d))
    return sorted(keys, key=lambda k: k.pub_hex)


def joiner_keys(seed: int, n: int) -> List[KeyPair]:
    """Keypairs for mid-run joiners (membership plane) — a SEPARATE
    derivation stream, unsorted: joiner ids are assigned by consensus
    (append order at each epoch boundary), not by pub-hex rank."""
    keys = []
    for i in range(n):
        digest = sha256(f"babble-chaos-joiner:{seed}:{i}".encode())
        d = int.from_bytes(digest, "big") % (P256_ORDER - 1) + 1
        keys.append(key_from_scalar(d))
    return keys


@dataclass
class ScenarioResult:
    """Everything a scenario run observed, in JSON-able form."""

    name: str
    seed: int
    steps: int
    fault_schedule: List[tuple] = field(default_factory=list)
    fault_counts: Dict[str, int] = field(default_factory=dict)
    committed: Dict[int, List[str]] = field(default_factory=dict)
    consensus: Dict[int, List[str]] = field(default_factory=dict)
    submitted: List[str] = field(default_factory=list)
    honest: List[int] = field(default_factory=list)
    restarted: Set[int] = field(default_factory=set)
    alive: Set[int] = field(default_factory=set)
    heal_tick: Optional[int] = None
    consensus_counts_at_heal: Dict[int, int] = field(default_factory=dict)
    consensus_counts_at_bound: Dict[int, int] = field(default_factory=dict)
    consensus_counts_final: Dict[int, int] = field(default_factory=dict)
    fork_detected: Dict[int, bool] = field(default_factory=dict)
    fast_forwards: Dict[int, int] = field(default_factory=dict)
    fork_attack: Optional[dict] = None
    #: per-creator eviction observations: for every crashed
    #: creator, the highest eviction-horizon index a surviving node
    #: recorded for it during the outage (-1 = its tail never evicted)
    eviction_horizons: Dict[int, int] = field(default_factory=dict)
    #: max live-window slot count observed on survivors while any node
    #: was down — the memory-bounded half of eviction_advanced
    outage_live_window_max: int = 0
    #: fast-forward snapshots each node refused on proof failure
    #: (babble_ff_proof_rejects_total at run end)
    ff_proof_rejects: Dict[int, int] = field(default_factory=dict)
    #: membership plane: per-node final epoch and membership ledger
    #: ((epoch, kind, pub, boundary) tuples — the epoch_agreement
    #: invariant requires them identical on every honest node)
    epochs: Dict[int, int] = field(default_factory=dict)
    membership_logs: Dict[int, list] = field(default_factory=dict)
    #: scenario indices that joined mid-run (prefix agreement treats
    #: them like restarts: their log starts mid-stream)
    joined: Set[int] = field(default_factory=set)
    #: committed logs of the drift-free twin run (skew_robust_order)
    noskew_committed: Optional[Dict[int, List[str]]] = None
    #: per-node committed tx -> (round_received, consensus_ts) keys of
    #: the drift-free twin — the strict-order baseline drift must not
    #: permute ((rr, cts)-TIED commits fall to the whitened-signature
    #: tiebreak, which legitimately differs between runs because the
    #: drifted timestamps are inside the signed bodies)
    noskew_keys: Optional[Dict[int, dict]] = None
    #: this run's own committed-key map (kept so a run can serve as a
    #: twin)
    committed_keys: Dict[int, dict] = field(default_factory=dict)
    #: per-node flight-recorder dumps: captured at each
    #: crash and at run end, so an invariant violation ships its own
    #: last-N-transitions post-mortem instead of demanding a re-run.
    #: Embedded in to_dict() only when the report has violations.
    flight_dumps: Dict[int, list] = field(default_factory=dict)
    report: Optional[InvariantReport] = None

    def fingerprint(self) -> str:
        """SHA-256 over the canonical fault schedule + every node's
        committed/consensus order — identical across runs iff the run
        was bit-for-bit reproduced."""
        payload = json.dumps({
            "schedule": [list(t) for t in self.fault_schedule],
            "committed": {str(k): v for k, v in sorted(self.committed.items())},
            "consensus": {str(k): v for k, v in sorted(self.consensus.items())},
        }, sort_keys=True).encode()
        return hashlib.sha256(payload).hexdigest()

    def to_dict(self) -> dict:
        return {
            "name": self.name, "seed": self.seed, "steps": self.steps,
            "fingerprint": self.fingerprint(),
            "fault_counts": dict(self.fault_counts),
            "fault_schedule": [list(t) for t in self.fault_schedule],
            "committed": {str(k): v for k, v in sorted(self.committed.items())},
            "submitted": list(self.submitted),
            "honest": list(self.honest),
            "restarted": sorted(self.restarted),
            "alive": sorted(self.alive),
            "heal_tick": self.heal_tick,
            "consensus_counts": {
                str(k): v
                for k, v in sorted(self.consensus_counts_final.items())
            },
            "fork_detected": {
                str(k): v for k, v in sorted(self.fork_detected.items())
            },
            "fast_forwards": {
                str(k): v for k, v in sorted(self.fast_forwards.items())
            },
            "fork_attack": self.fork_attack,
            "eviction_horizons": {
                str(k): v for k, v in sorted(self.eviction_horizons.items())
            },
            "outage_live_window_max": self.outage_live_window_max,
            "ff_proof_rejects": {
                str(k): v for k, v in sorted(self.ff_proof_rejects.items())
            },
            "epochs": {str(k): v for k, v in sorted(self.epochs.items())},
            "membership_logs": {
                str(k): [list(t) for t in v]
                for k, v in sorted(self.membership_logs.items())
            },
            "joined": sorted(self.joined),
            "invariants": self.report.to_dict() if self.report else None,
            # post-mortem artifact: the per-node flight narratives ride
            # the FAILURE (chaos run --json), never a green run's JSON
            **({"flight": {str(k): v
                           for k, v in sorted(self.flight_dumps.items())}}
               if self.report is not None and not self.report.ok
               and self.flight_dumps else {}),
        }


@dataclass
class _Handle:
    idx: int
    addr: str
    key: KeyPair
    node: Optional[Node] = None
    proxy: Optional[InmemAppProxy] = None
    alive: bool = True
    saved_engine: object = None
    engine_at_restart: object = None
    restarted: bool = False


class ScenarioRunner:
    """Deterministic in-memory execution of one scenario."""

    def __init__(self, scenario: Scenario, seed: Optional[int] = None,
                 _twin: bool = False, device: str = "cuda"):
        #: torch device of every node's engine (Config.device)
        self.device = device
        #: this run IS a drift-free twin (skew_robust_order): collect
        #: committed keys, never recurse into another twin
        self._twin = _twin
        self.scenario = scenario
        self.seed = scenario.seed if seed is None else seed

    def run(self) -> ScenarioResult:
        result = asyncio.run(self._run())
        sc = self.scenario
        byz = sc.plan.byzantine
        lying = byz is not None and byz.mode == "lying_ts"
        if ((sc.plan.clock_skew is not None or lying)
                and "skew_robust_order" in sc.invariants):
            # the invariant is a differential claim: the same (scenario,
            # seed) with adversarial time OFF — clock drift removed,
            # the lying_ts actor made honest — must commit the same
            # strict (rr, cts) order.  Median timestamps absorb bounded
            # per-creator skew, and the insert-time clamp pins a lying
            # minority's claims into the honest envelope.  Run the
            # honest-time twin and re-check.
            d = sc.to_dict()
            d["plan"].pop("clock_skew", None)
            if lying:
                d["plan"].pop("byzantine", None)
            d["invariants"] = [
                i for i in d["invariants"] if i != "skew_robust_order"
            ]
            from .plan import Scenario as _Scenario

            twin = ScenarioRunner(
                _Scenario.from_dict(d), seed=self.seed,
                _twin=True, device=self.device,
            ).run()
            result.noskew_committed = dict(twin.committed)
            result.noskew_keys = dict(twin.committed_keys)
            result.report = InvariantChecker().check(sc, result)
        return result

    async def _membership_op(self, op, handles, boot, injector,
                             result, n_founders: int) -> None:
        """Execute one scheduled churn verb: boot the joiner (observer)
        and submit its signed join tx, or submit a leave tx signed by
        the departing key — both through an ordinary live node's pool,
        because membership transitions ARE transactions.  The subject's
        key signs either way (the runner holds every scenario key, so
        leave-mid-outage works even while the leaver is down)."""
        from ..membership.transition import build_membership_tx

        h = handles[op.node]
        if op.kind == "join" and h.node is None:
            boot(h)
            result.joined.add(op.node)
        via = None
        if op.via is not None and handles[op.via].alive:
            via = handles[op.via]
        if via is None:
            via = next(
                (x for x in handles
                 if x.alive and x.idx != op.node and x.idx < n_founders),
                None,
            )
        if via is None:
            return   # nobody alive to carry the transition
        epoch = int(getattr(via.node.core.hg, "epoch", 0))
        tx = build_membership_tx(op.kind, h.key, h.addr, epoch)
        async with via.node.core_lock:
            via.node.transaction_pool.append(tx)
        injector.record(op.kind, op.node, via.idx, epoch=epoch)

    # ------------------------------------------------------------------

    async def _run(self) -> ScenarioResult:
        sc = self.scenario
        n = sc.nodes
        seed = self.seed
        injector = FaultInjector(sc.plan, seed,
                                 tick_seconds=sc.tick_seconds)
        rng = random.Random(f"babble-chaos-scenario:{seed}")
        # logical event clock: strictly increasing ns, identical across
        # runs because every event creation happens inside one of the
        # runner's sequential awaits
        tick_ns = {"t": 1_700_000_000_000_000_000}

        def clock() -> int:
            tick_ns["t"] += 1_000_000
            return tick_ns["t"]

        # membership plane: founders get canonical ids (sorted keys);
        # joiner identities come from a separate stream and take the
        # scenario indices past the founding set
        total = n + sc.joiners
        keys = deterministic_keys(seed, n) + joiner_keys(seed, sc.joiners)
        addrs = [f"inmem://chaos{i}" for i in range(total)]
        addr_index = {a: i for i, a in enumerate(addrs)}
        peers = [
            Peer(net_addr=addrs[i], pub_key_hex=keys[i].pub_hex)
            for i in range(n)
        ]
        net = InmemNetwork()
        handles = [
            _Handle(idx=i, addr=addrs[i], key=keys[i],
                    alive=(i < n))
            for i in range(total)
        ]

        # Honest crash scenarios run DURABLY: each node writes a real
        # on-disk WAL (fsync=off — in-process durability, the tier-1
        # fast path) plus optional periodic checkpoints, a crash drops
        # the live engine on the floor, and the restart recovers
        # through the real ladder (checkpoint -> WAL replay -> seq
        # probe -> gossip/fast-forward).  This is what lets crash
        # scenarios run honest-mode: recovery is seq-exact, so a
        # restarted node never re-mints a published index and no peer
        # ever reads it as an equivocator.  (Byzantine-engine crashes
        # keep the keep-the-engine model: fork-aware restarts are
        # exercised by the live tier.)
        durable = (sc.engine == "fused"
                   and bool(sc.plan.crashes or sc.plan.disk))
        durable_root = (
            tempfile.mkdtemp(prefix="babble-chaos-durable-")
            if durable else None
        )

        def ckpt_dir(i: int) -> str:
            return os.path.join(durable_root, f"node{i}", "ckpt")

        def make_conf(i: int) -> Config:
            conf = Config.test_config(heartbeat=1.0, device=self.device)
            conf.tcp_timeout = RPC_TIMEOUT_S
            conf.byzantine = (sc.engine == "byzantine")
            conf.cache_size = sc.cache_size
            conf.seq_window = sc.seq_window
            if sc.inactive_rounds is not None:
                conf.inactive_rounds = sc.inactive_rounds
            # flight stays ON (invariant violations attach its dumps);
            # lineage OFF — nothing scrapes /debug/lineage in the
            # in-memory runner, and its per-insert/ship records are
            # pure overhead on the scenario hot loop
            conf.lineage = False
            # anchor collection OFF: its background RPC rounds would
            # cross partitions at timing-dependent moments and perturb
            # the recorded fault schedule (the node-level anchor tests
            # own this path; live fleets keep the default interval)
            conf.anchor_interval = 0
            # positive interval with gossip=False means: syncs only mark
            # the pipeline dirty and the RUNNER decides when consensus
            # runs (a timer task would reintroduce wall-clock
            # nondeterminism) — see _maybe_consensus
            conf.consensus_interval = 1e9
            if durable:
                conf.wal_dir = os.path.join(durable_root, f"node{i}", "wal")
                conf.wal_fsync = "off"
            return conf

        def boot(h: _Handle, engine=None) -> None:
            inner = net.transport(h.addr)
            transport = FaultyTransport(
                inner, injector, h.idx, addr_index,
                forge_key=(h.key if injector.is_snapshot_forger(h.idx)
                           else None),
            )
            h.proxy = InmemAppProxy()
            conf = make_conf(h.idx)
            node_peers = peers
            if h.idx >= n:
                # joiner: the founders are its consensus bootstrap set;
                # its own address rides only the address book (it is an
                # observer until its join tx's epoch boundary)
                conf.bootstrap_peers = list(peers)
                node_peers = peers + [
                    Peer(net_addr=h.addr, pub_key_hex=h.key.pub_hex)
                ]
            h.node = Node(conf, h.key, node_peers, transport,
                          h.proxy, engine=engine)
            # adversarial time: a per-node
            # bounded drift offset from the injector's seeded stream
            # rides on the shared logical clock through the Core.now_ns
            # hook — event bodies stay deterministic per (seed, node)
            drift = injector.clock_drift_ns(h.idx)
            if injector.is_ts_liar(h.idx):
                # the lying_ts byzantine actor: per-mint EXTREME claimed
                # timestamps from a dedicated seeded stream — the
                # creator-claimed-median attack the insert-time clamp
                # absorbs.  Still deterministic per (seed, node): every
                # mint happens inside one of the runner's sequential
                # awaits.
                h.node.core.now_ns = (
                    lambda d=drift, i=h.idx:
                    clock() + d + injector.lying_ts_offset_ns(i)
                )
            elif drift:
                h.node.core.now_ns = (lambda d=drift: clock() + d)
            else:
                h.node.core.now_ns = clock
            if engine is None:
                # recovery-aware: skipped when WAL replay restored a
                # head, deferred while the seq probe negotiates
                h.node.init()
            h.node.run_task(gossip=False)
            h.alive = True

        for h in handles[:n]:
            boot(h)
        if sc.plan.clock_skew is not None:
            for h in handles[:n]:
                d = injector.clock_drift_ns(h.idx)
                if d:
                    injector.record("clock_skew", h.idx, h.idx,
                                    drift_ns=d)

        byz = sc.plan.byzantine
        honest = [i for i in range(n) if byz is None or byz.node != i]
        result = ScenarioResult(name=sc.name, seed=seed, steps=sc.steps,
                                honest=honest)
        honest.extend(range(n, total))   # joiners are never byzantine
        sched = crash_schedule(sc.plan)
        #: membership churn schedule: tick -> ops (declaration order)
        member_sched: Dict[int, List] = {}
        for op in list(sc.plan.joins) + list(sc.plan.leaves):
            member_sched.setdefault(op.tick, []).append(op)
        heal_ticks = [p.heal for p in sc.plan.partitions
                      if p.heal is not None]
        heal_ticks += [c.restart for c in sc.plan.crashes
                       if c.restart is not None]
        heal_tick = max(heal_ticks) if heal_ticks else None
        result.heal_tick = heal_tick
        submitted = 0
        fork_done = False
        #: deterministic forger encounters: a node restarting under a
        #: forge_snapshot actor gossips AT the forger first, so the
        #: forged-fast-forward path is exercised on every seed instead
        #: of depending on the random peer draw finding the actor
        forced_gossip: List[tuple] = []

        async def gossip_once(a: int, b: int) -> None:
            await handles[a].node._gossip(addrs[b])

        async def sample_counts() -> Dict[int, int]:
            out = {}
            for h in handles:
                if h.alive:
                    out[h.idx] = h.node.core.hg.consensus_events_count()
            return out

        try:
            for step in range(sc.steps):
                injector.advance_to(step)
                for action, node_idx in sched.get(step, ()):
                    h = handles[node_idx]
                    if action == "crash" and h.alive:
                        # the crash IS the interesting transition: grab
                        # the ring before the node object goes away (a
                        # restart builds a fresh recorder).  APPEND —
                        # a second crash of the same node must not
                        # overwrite the first narrative
                        result.flight_dumps[node_idx] = (
                            result.flight_dumps.get(node_idx, [])
                            + h.node.flight.dump()
                        )
                        if durable:
                            # power-cut semantics: drop the file handles
                            # with NO clean-shutdown receipt and discard
                            # the live engine — whatever the WAL (and
                            # any periodic checkpoint) captured is all
                            # the restart gets
                            h.saved_engine = None
                            h.node.core.wal.abort()
                        else:
                            h.saved_engine = h.node.core.hg
                        await h.node.shutdown()
                        h.alive = False
                        injector.record("crash", node_idx, node_idx)
                    elif action == "restart" and not h.alive:
                        if durable:
                            # the real recovery ladder: seeded disk rot
                            # first (that is when fsync lies surface),
                            # then checkpoint -> WAL replay -> probe
                            if sc.plan.disk is not None:
                                # off-loop: the structure-relative
                                # draws decode checkpoint meta
                                def rot(idx=node_idx):
                                    apply_disk_faults(
                                        injector, sc.plan.disk, idx,
                                        ckpt_dir(idx),
                                        os.path.join(durable_root,
                                                     f"node{idx}", "wal"),
                                    )
                                await asyncio.get_running_loop() \
                                    .run_in_executor(None, rot)
                            from ..store import load_checkpoint_tolerant

                            engine, _err = load_checkpoint_tolerant(
                                ckpt_dir(node_idx), device=self.device
                            ) if os.path.isdir(ckpt_dir(node_idx)) \
                                else (None, None)
                            boot(h, engine=engine)
                        else:
                            # byzantine crashes restart from the engine
                            # held at crash time (the fork-aware
                            # checkpoint-restored-process model)
                            boot(h, engine=h.saved_engine)
                        h.engine_at_restart = h.node.core.hg
                        h.restarted = True
                        result.restarted.add(node_idx)
                        injector.record("restart", node_idx, node_idx)
                        if (byz is not None
                                and byz.mode == "forge_snapshot"
                                and byz.node != node_idx):
                            forced_gossip.append((node_idx, byz.node))
                if (durable and sc.checkpoint_every > 0
                        and step % sc.checkpoint_every
                        == sc.checkpoint_every - 1):
                    for h in handles:
                        if h.alive:
                            await h.node.save_checkpoint(ckpt_dir(h.idx))
                for op in member_sched.get(step, ()):
                    await self._membership_op(
                        op, handles, boot, injector, result, n
                    )
                if heal_tick is not None and step == heal_tick:
                    result.consensus_counts_at_heal = await sample_counts()
                if (heal_tick is not None
                        and step == heal_tick + sc.liveness_bound):
                    result.consensus_counts_at_bound = await sample_counts()

                if (submitted < sc.txs and sc.tx_every > 0
                        and step % sc.tx_every == 0):
                    live = [h for h in handles if h.alive]
                    target = rng.choice(live)
                    payload = (
                        f"chaos-tx-{submitted}-"
                        f"{rng.getrandbits(32):08x}".encode()
                    )
                    async with target.node.core_lock:
                        target.node.transaction_pool.append(payload)
                    result.submitted.append(payload.hex())
                    submitted += 1

                if (byz is not None and byz.mode == "fork"
                        and not fork_done and step >= byz.at):
                    attack = await self._inject_fork(
                        handles, byz, rng, clock, injector
                    )
                    if attack.get("deferred"):
                        # the branch's self-parent hasn't reached two
                        # honest peers yet — a fork nobody can insert
                        # proves nothing; retry next step
                        pass
                    else:
                        result.fork_attack = attack
                        fork_done = True

                live_idx = [h.idx for h in handles if h.alive]
                # the dialable universe: founders plus joiners that have
                # BOOTED (a joiner's address exists only from its join
                # tick on).  Identical to range(n) for churn-free
                # scenarios, so their draws — and fingerprints — are
                # untouched.
                uni = n + sum(
                    1 for h in handles[n:] if h.node is not None
                )
                if (forced_gossip and handles[forced_gossip[0][0]].alive
                        and handles[forced_gossip[0][1]].alive):
                    a, b = forced_gossip.pop(0)
                    await gossip_once(a, b)
                elif len(live_idx) >= 2:
                    a = rng.choice(live_idx)
                    # deliberate: the target draw includes crashed nodes
                    # — a real peer selector dials from peers.json with
                    # no liveness oracle, so the fleet keeps paying the
                    # dial-a-dead-peer failure exactly like production
                    b = rng.choice([i for i in range(uni) if i != a])
                    await gossip_once(a, b)

                # silent-peer observations (eviction_advanced): while
                # any node is down, sample the survivors' live-window
                # size and any eviction horizon recorded for the dead
                # creators — host mirrors only, no device sync
                down = [h.idx for h in handles if not h.alive]
                if down:
                    for h in handles:
                        if not h.alive:
                            continue
                        snap = h.node.core.hg.stats_snapshot()
                        result.outage_live_window_max = max(
                            result.outage_live_window_max,
                            int(snap.get("live_window", 0)),
                        )
                        heads = getattr(
                            h.node.core.hg.dag, "evicted_heads", {}
                        )
                        for d in down:
                            horizon = heads.get(d)
                            if horizon is not None:
                                result.eviction_horizons[d] = max(
                                    result.eviction_horizons.get(d, -1),
                                    horizon[0],
                                )

                if step % CONSENSUS_EVERY == CONSENSUS_EVERY - 1:
                    await self._consensus_pass(handles)

            # settle: the network behaves, everyone reconciles — the
            # phase that makes convergence invariants meaningful
            injector.advance_to(sc.steps)
            injector.quiesce = True
            for _ in range(sc.settle_rounds):
                for a in range(total):
                    if not handles[a].alive:
                        continue
                    for b in range(total):
                        if b != a and handles[b].alive:
                            await gossip_once(a, b)
                await self._consensus_pass(handles)
            await self._consensus_pass(handles, force=True)
            await self._drain_commits(handles)

            result.consensus_counts_final = await sample_counts()
            if heal_tick is not None and not result.consensus_counts_at_bound:
                result.consensus_counts_at_bound = dict(
                    result.consensus_counts_final
                )
            for h in handles:
                if not h.alive:
                    continue
                result.alive.add(h.idx)
                result.committed[h.idx] = [
                    tx.hex() for tx in h.proxy.committed_transactions()
                ]
                result.consensus[h.idx] = list(
                    h.node.core.hg.consensus_events()
                )
                if sc.plan.clock_skew is not None or self._twin:
                    # committed (rr, cts) keys for skew_robust_order:
                    # read from the retained window (these scenarios
                    # never evict it)
                    dag = h.node.core.hg.dag
                    keys: Dict[str, tuple] = {}
                    for hx in h.node.core.hg.consensus_events():
                        slot = dag.slot_of.get(hx)
                        if slot is None:
                            continue
                        ev = dag.events[slot]
                        for tx in ev.transactions:
                            keys[tx.hex()] = (
                                ev.round_received,
                                ev.consensus_timestamp,
                            )
                    result.committed_keys[h.idx] = keys
                snap = h.node.core.hg.stats_snapshot()
                result.fork_detected[h.idx] = (
                    snap.get("forked_creators", 0) > 0
                )
                result.ff_proof_rejects[h.idx] = int(
                    h.node._m_ff_rejects.value
                )
                # a completed fast-forward swapped the engine object the
                # node restarted with — attempt counters alone can't
                # distinguish a failed catch-up from a successful one
                swapped = (h.restarted
                           and h.node.core.hg is not h.engine_at_restart)
                result.fast_forwards[h.idx] = 1 if swapped else 0
                # membership plane: the epoch ledger every honest node
                # must agree on (epoch_agreement invariant)
                result.epochs[h.idx] = int(
                    getattr(h.node.core.hg, "epoch", 0)
                )
                result.membership_logs[h.idx] = [
                    (e["epoch"], e["kind"], e["pub"], e["boundary"])
                    for e in getattr(h.node.core.hg, "membership_log", ())
                ]
                # APPEND to any crash-time capture: a restarted node's
                # fresh recorder only holds post-restart records, and
                # the pre-crash narrative is the part a post-mortem
                # needs most
                result.flight_dumps[h.idx] = (
                    result.flight_dumps.get(h.idx, [])
                    + h.node.flight.dump()
                )
        finally:
            for h in handles:
                if h.alive:
                    await h.node.shutdown()
            if durable_root is not None:
                shutil.rmtree(durable_root, ignore_errors=True)

        result.fault_schedule = injector.schedule_fingerprint()
        counts: Dict[str, int] = {}
        for entry in injector.log:
            counts[entry["kind"]] = counts.get(entry["kind"], 0) + 1
        result.fault_counts = counts
        result.report = InvariantChecker().check(self.scenario, result)
        return result

    # ------------------------------------------------------------------

    async def _consensus_pass(self, handles, force: bool = False) -> None:
        """Run the consensus pipeline on every dirty live node, in node
        order (the runner-owned cadence that replaces the wall-clock
        _consensus_loop timer)."""
        for h in handles:
            if not h.alive:
                continue
            if not (force or h.node._consensus_dirty):
                continue
            h.node._consensus_dirty = False
            async with h.node.core_lock:
                await h.node._run_consensus_locked(0)

    async def _drain_commits(self, handles) -> None:
        """Wait until every committer has fully DELIVERED its queue —
        an empty queue still races the batch the committer already
        popped, and a wall-clock sleep there would make the sampled
        committed logs (and the reproducibility fingerprint) timing-
        dependent.  Queue.join() fires on the committer's task_done,
        after the last app ack."""
        for h in handles:
            if not h.alive:
                continue
            try:
                await asyncio.wait_for(h.node._commit_queue.join(), 60.0)
            except asyncio.TimeoutError:
                # a wedged committer (app refusing every retry) must not
                # hang the whole run — the invariant checker will say
                # what's missing
                pass

    async def _inject_fork(self, handles, byz: ByzantineSpec, rng, clock,
                           injector) -> dict:
        """The fork-emitting peer: mint an equivocating event (same
        creator, same index, different content) off the byzantine
        node's earliest live event and plant each branch at a different
        honest peer.  Fork-aware engines accept and later *detect* it;
        honest engines reject the branch at insert — which is exactly
        why the fork-attack-with-detection-disabled variant fails its
        fork_detected invariant."""
        from ..core.event import new_event

        h = handles[byz.node]
        if not h.alive:
            return {"injected": False, "reason": "byzantine node down"}
        core = h.node.core
        cid = byz.node
        async with h.node.core_lock:
            if core.byzantine:
                slots = core.hg.dag.cr_events[cid]
                base = core.hg.dag.events[slots[0]] if slots else None
            else:
                chain = core.hg.dag.chains[cid]
                base = (core.hg.dag.events[chain[chain.start]]
                        if len(chain) else None)
        if base is None:
            return {"injected": False, "reason": "no base event"}

        def _knows_fork_site(target_core) -> bool:
            # the target must hold the base AND a genuine event at the
            # forged index: without the genuine sibling, the branch is
            # just the next chain event (no equivocation to detect, and
            # honest engines would accept it as real)
            dag = target_core.hg.dag
            if base.hex() not in dag.slot_of:
                return False
            if target_core.byzantine:
                slots = dag.cr_events[cid]
            else:
                slots = list(dag.chains[cid])
            return any(
                dag.events[s].index == base.index + 1 for s in slots
            )

        ready = []
        for x in handles:
            if x.idx == byz.node or not x.alive:
                continue
            async with x.node.core_lock:
                if _knows_fork_site(x.node.core):
                    ready.append(x)
        if len(ready) < 2:
            return {"injected": False, "deferred": True}
        targets = rng.sample(ready, 2)
        accepted, rejected = [], []
        for t, tag in zip(targets, (b"a", b"b")):
            async with t.node.core_lock:
                other = t.node.core.head
            ev = new_event(
                [b"chaos-fork-" + tag], (base.hex(), other),
                h.key.pub_bytes, base.index + 1, timestamp=clock(),
            )
            ev.sign(h.key)
            try:
                async with t.node.core_lock:
                    t.node.core.insert_event(ev)
                accepted.append(t.idx)
            except ValueError as e:
                rejected.append({"node": t.idx, "error": str(e)})
        injector.record("fork_attack", byz.node, -1,
                        accepted=len(accepted))
        return {"injected": True, "accepted": accepted,
                "rejected": rejected}


def run_scenario(scenario: Scenario,
                 seed: Optional[int] = None,
                 device: str = "cuda") -> ScenarioResult:
    """One deterministic in-memory run on ``device``; result carries the
    invariant report (``result.report.ok``)."""
    return ScenarioRunner(scenario, seed=seed, device=device).run()


# ----------------------------------------------------------------------
# live fleets


def _live_membership_op(runner, base_dir: str, op, log) -> bool:
    """Execute one scheduled churn verb against a live subprocess
    fleet: boot the joiner (spawn_joiner) and submit its subject-signed
    join tx — or submit a leave tx — through a live node's SubmitTx
    front door, exactly as an operator would.  The runner holds every
    scenario key (the datadirs it built), so leaves work even while the
    leaver is down.  Returns False when the submit should be retried
    (the via node is still booting/compiling)."""
    from ..crypto.keys import PemKeyFile
    from ..membership.transition import build_membership_tx
    from ..proxy.jsonrpc import JsonRpcClient, b64e
    from .. import testnet as tn

    if op.kind == "join":
        log(f"[chaos] boot joiner node {op.node}")
        runner.spawn_joiner(op.node)
    via = op.via if op.via is not None else 0
    d = os.path.join(base_dir, f"node{op.node}")
    key = PemKeyFile(d).read()
    addr = runner.ports.of(op.node)["gossip"]
    # stamp the CURRENT epoch (pipelined transitions accept stamps from
    # the current epoch through the projected apply epoch, so a burst
    # of same-epoch submissions queues cleanly)
    epoch = 0
    try:
        h = tn.fetch_healthz(runner.ports.of(via)["service"])
        epoch = int(h.get("epoch", 0))
    except Exception:
        pass
    tx = build_membership_tx(op.kind, key, addr, epoch)

    async def _submit() -> None:
        client = JsonRpcClient(runner.ports.of(via)["submit"],
                               timeout=15.0)
        try:
            await client.call("Babble.SubmitTx", b64e(tx))
        finally:
            await client.close()

    try:
        asyncio.run(_submit())
    except Exception as e:
        log(f"[chaos] {op.kind} tx for node {op.node} via {via} "
            f"failed ({e}); will retry")
        return False
    log(f"[chaos] submitted {op.kind} tx for node {op.node} "
        f"via {via} (epoch {epoch})")
    return True


def run_live(
    scenario: Scenario,
    base_dir: str,
    rate: float = 25.0,
    log=print,
    device: str = "cuda",
    ports=None,
) -> dict:
    """Execute a scenario against a live subprocess fleet.  Every node
    self-injects link faults from the shared (plan, seed) via
    ``--chaos_plan`` (see cli.py); this runner owns only the
    crash/restart schedule and the workload.  Returns a fleet report
    (stats sweep + per-node injected-fault counters); invariant depth
    belongs to the deterministic runner.  Every node runs ``cli run
    --device device``; ``ports`` (a ``testnet.PortLayout``) defaults to
    the testnet's fixed layout."""
    import threading
    import time

    from .. import testnet as tn

    os.makedirs(base_dir, exist_ok=True)
    plan_path = os.path.join(base_dir, "scenario.json")
    with open(plan_path, "w") as f:
        json.dump(scenario.to_dict(), f, indent=1)
    # exact link identities for every node's injector: gossip address
    # -> scenario index over founders AND scheduled joiners, so
    # founder->joiner links carry their planned faults and multiple
    # joiners never collide on one index (cli --chaos_addrs)
    ports = ports if ports is not None else tn.PortLayout()
    addrs_path = os.path.join(base_dir, "chaos_addrs.json")
    with open(addrs_path, "w") as f:
        json.dump({
            ports.of(i)["gossip"]: i
            for i in range(scenario.nodes + scenario.joiners)
        }, f, indent=1)

    # one shared tick-0 for the whole fleet, restarts included — each
    # node's injector maps wall time to plan ticks from this epoch, so
    # a relaunched node rejoins the schedule in phase
    epoch = time.time()
    runner = tn.TestnetRunner(
        base_dir, scenario.nodes, heartbeat_ms=20, ports=ports,
        # membership plane: datadirs for scheduled joiners are prepared
        # up front; spawn_joiner boots each at its join op's tick
        joiners=scenario.joiners,
        # generous sync timeout: injected delays ride on top of real
        # RTTs, and byzantine-mode consensus per sync is heavy on
        # oversubscribed hosts — 200 ms would read every slow response
        # as a failure and drown the chaos signal in organic timeouts
        tcp_timeout_ms=1500,
        extra_node_args=[
            "--chaos_plan", plan_path, "--chaos_seed", str(scenario.seed),
            "--chaos_epoch", repr(epoch),
            "--chaos_addrs", addrs_path,
        ],
        # crash/restart runs HONEST since the durability plane landed:
        # a killed node replays its per-event WAL on top of the newest
        # checkpoint and resumes at its true head seq, so no peer ever
        # reads the restart as an equivocation (the old workaround —
        # fork-aware engines + tight checkpoints tolerating re-minted
        # indexes — is gone)
        byzantine=(scenario.engine == "byzantine"),
        checkpoints=bool(scenario.plan.crashes),
        wal=bool(scenario.plan.crashes or scenario.plan.disk),
        device=device,
    )
    duration = scenario.steps * scenario.tick_seconds
    sched = crash_schedule(scenario.plan)
    # runner-side injector: only its disk stream is consumed, so the
    # node processes' own (plan, seed) fault streams are untouched
    disk_injector = FaultInjector(scenario.plan, scenario.seed)
    report: dict = {"name": scenario.name, "seed": scenario.seed,
                    "duration_s": duration}
    runner.start()
    try:
        bomber = threading.Thread(
            target=lambda: asyncio.run(tn.bombard(
                scenario.nodes, rate, duration, runner.ports,
                seed=scenario.seed,
            )),
            daemon=True,
        )
        bomber.start()
        #: membership churn schedule (live mode): tick -> ops.  A
        #: failed submit (target node still compiling its first flush)
        #: re-queues the op a couple of seconds later instead of
        #: silently dropping the transition; a submit whose epoch stamp
        #: proves STALE (the fleet applied an earlier transition after
        #: the stamp was fetched — deterministic reject) is detected by
        #: the verify pass below and resubmitted with a fresh stamp,
        #: exactly as an operator's tooling would.
        member_sched: Dict[int, list] = {}
        for op in list(scenario.plan.joins) + list(scenario.plan.leaves):
            member_sched.setdefault(op.tick, []).append(op)
        #: ordered (op, verify_tick) list of submitted transitions:
        #: when op k's verify comes due, the fleet must have k+1
        #: transitions applied or in flight (pending + queue)
        awaiting: list = []
        ops_confirmed = 0

        def _epoch_of(node: int) -> int:
            h = tn.fetch_healthz(runner.ports.of(node)["service"])
            return int(h.get("epoch", 0))

        def _in_flight(node: int) -> int:
            """Transitions applied or in flight at ``node``: its epoch
            plus the pending boundary plus the queued tail — the one
            definition both the verify pass and the settle loop use."""
            h = tn.fetch_healthz(runner.ports.of(node)["service"])
            return (int(h.get("epoch", 0))
                    + (1 if h.get("epoch_pending") else 0)
                    + int(h.get("epoch_queue", 0)))

        # the runner walks the SAME epoch the nodes' injectors use, so
        # crash/restart actions stay in phase with the plan's partition
        # windows; ticks that elapsed during fleet boot are processed
        # immediately (their sleep clamps to zero)
        for tick in range(scenario.steps):
            for op in member_sched.pop(tick, []):
                ok = _live_membership_op(runner, base_dir, op, log)
                if ok:
                    awaiting.append((op, tick + 50))
                elif tick + 20 < scenario.steps:
                    member_sched.setdefault(tick + 20, []).append(op)
            while awaiting and awaiting[0][1] <= tick:
                op, _ = awaiting.pop(0)
                via = op.via if op.via is not None else 0
                try:
                    flight = _in_flight(via)
                except Exception:
                    flight = 0
                if flight >= ops_confirmed + 1:
                    ops_confirmed += 1
                elif tick + 20 < scenario.steps:
                    log(f"[chaos] {op.kind} for node {op.node} did not "
                        "take (stale stamp?); resubmitting")
                    member_sched.setdefault(tick + 1, []).append(op)
            for action, node_idx in sched.get(tick, ()):
                if action == "crash":
                    log(f"[chaos] tick {tick}: crash node {node_idx}")
                    runner.kill_node(node_idx)
                else:
                    if scenario.plan.disk is not None:
                        d = os.path.join(base_dir, f"node{node_idx}")
                        fired = apply_disk_faults(
                            disk_injector, scenario.plan.disk, node_idx,
                            os.path.join(d, "ckpt"),
                            os.path.join(d, "wal"),
                        )
                        if fired:
                            log(f"[chaos] tick {tick}: disk rot on node "
                                f"{node_idx}: {', '.join(fired)}")
                    log(f"[chaos] tick {tick}: restart node {node_idx}")
                    runner.restart_node(node_idx)
            deadline = epoch + (tick + 1) * scenario.tick_seconds
            time.sleep(max(0.0, deadline - time.time()))
        bomber.join(timeout=30)
        total = scenario.nodes + scenario.joiners
        n_ops = len(scenario.plan.joins) + len(scenario.plan.leaves)
        if n_ops:
            # membership settle (the live analog of the deterministic
            # runner's settle rounds): transitions submitted late in
            # the run still need their epoch boundary DECIDED, and an
            # oversubscribed CPU fleet decides rounds slowly while the
            # bombard load runs — poll (and re-drive any op the verify
            # loop left unconfirmed) until every reachable node applied
            # every scheduled transition, or the settle budget runs out
            all_ops = (list(scenario.plan.joins)
                       + list(scenario.plan.leaves))
            deadline = time.time() + 90.0
            next_redrive = 0.0
            while time.time() < deadline:
                views, flights = [], []
                for i in range(total):
                    try:
                        views.append(_epoch_of(i))
                        flights.append(_in_flight(i))
                    except Exception:
                        pass
                if views and all(v >= n_ops for v in views):
                    break
                if (flights and max(flights) < n_ops
                        and time.time() >= next_redrive):
                    # some transition neither applied nor in flight
                    # anywhere (a stale stamp was deterministically
                    # rejected): re-drive every op — duplicates of
                    # applied ones are rejected identically everywhere,
                    # so re-driving is idempotent
                    for op in all_ops:
                        _live_membership_op(runner, base_dir, op, log)
                    next_redrive = time.time() + 15.0
                time.sleep(2.0)
        report["stats"] = tn.watch_once(total, runner.ports)
        if n_ops:
            # membership plane: the fleet-wide epoch view — live churn's
            # pass/fail surface (every reachable node must have applied
            # every scheduled transition)
            epochs: Dict[str, object] = {}
            for i in range(total):
                try:
                    h = tn.fetch_healthz(runner.ports.of(i)["service"])
                    epochs[str(i)] = int(h.get("epoch", 0))
                except Exception as e:
                    epochs[str(i)] = f"error: {e}"
            report["epochs"] = epochs
        faults: Dict[str, Dict[str, float]] = {}
        for i in range(scenario.nodes):
            addr = runner.ports.of(i)["service"]
            try:
                text = tn.fetch_metrics(addr)
            except Exception as e:   # a crashed-for-good node has none
                faults[str(i)] = {"error": str(e)}
                continue
            per = {}
            for line in text.splitlines():
                if line.startswith("babble_chaos_faults_total{"):
                    kind = line.split('kind="', 1)[1].split('"', 1)[0]
                    per[kind] = float(line.rsplit(" ", 1)[1])
            faults[str(i)] = per
        report["chaos_faults"] = faults

        def _events(row) -> int:
            try:
                return int(row.get("consensus_events", "0"))
            except (TypeError, ValueError):
                return 0

        # every REACHABLE node must have advanced, and at least one node
        # must actually be reachable — without the any(), a fleet that
        # never booted (all rows are error rows) would vacuously pass
        report["advanced"] = all(
            "error" in row or _events(row) > 0 for row in report["stats"]
        ) and any(_events(row) > 0 for row in report["stats"])
    finally:
        runner.stop()
    return report
