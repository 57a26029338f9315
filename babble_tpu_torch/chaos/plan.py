"""Declarative fault plans: what the chaos plane may do to the network.

A :class:`FaultPlan` is pure data — per-link fault probabilities,
scheduled partitions with heal times, node crash/restart points, and an
optional byzantine actor — with a stable JSON form (see README "Chaos
testing" for the schema).  The plan never draws randomness itself: the
:class:`~babble_tpu_torch.chaos.injector.FaultInjector` turns a (plan, seed)
pair into concrete fault decisions, which is what makes every scenario
reproducible from ``--seed`` alone.

Time is measured in abstract **ticks**: the deterministic scenario
runner advances one tick per gossip step, the live runner maps ticks to
wall time through ``Scenario.tick_seconds``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: invariants the checker knows how to enforce (invariants.py)
KNOWN_INVARIANTS = (
    "prefix_agreement",   # safety: honest nodes commit identical order
    "liveness",           # commits resume within a bound after heal
    "all_committed",      # every submitted tx reaches the honest logs
    "fork_detected",      # every honest node flagged the equivocation
    "fast_forwarded",     # a restarted node caught up via snapshot
    "eviction_advanced",  # a silent creator's tail evicted; memory bounded
    "ff_proof_rejected",  # a forged snapshot was refused (proof quorum)
    "epoch_agreement",    # every honest node applied every membership
                          # transition at the same decided round
    "skew_robust_order",  # committed order identical to the same run
                          # with clock drift off / timestamp lying off
                          # (cts median robustness)
)

BYZANTINE_MODES = ("fork", "stale_replay", "forge_snapshot", "lying_ts")


def _prob(v, name: str) -> float:
    f = float(v)
    if not 0.0 <= f <= 1.0:
        raise ValueError(f"{name} must be a probability in [0, 1], got {v}")
    return f


def _ms_range(v, name: str) -> Tuple[float, float]:
    lo, hi = (float(v[0]), float(v[1]))
    if lo < 0 or hi < lo:
        raise ValueError(f"{name} must be 0 <= lo <= hi ms, got {v}")
    return (lo, hi)


@dataclass(frozen=True)
class LinkFaults:
    """Per-directed-link fault probabilities plus WAN-shaped link
    models.  ``delay``/``reorder`` are
    probabilities; the matching ``*_ms`` ranges bound the injected
    latency (reordering is modeled as extra delay on the affected
    message relative to the messages behind it).

    WAN models (both off by default, so pre-existing plans — and their
    per-link RNG streams — are untouched):

    - **bandwidth**: ``bw_kbps`` (kilobits/s; 0 = unlimited) applies a
      token-bucket cap with ``bw_burst_kb`` of burst: every
      gossip-class message pays a size-proportional serialization
      delay, and messages past the bucket queue behind the deficit.
      Draws no randomness — the schedule is a pure function of the
      (deterministic) message sizes and ticks.
    - **Gilbert–Elliott burst loss**: a two-state good/bad loss chain
      (``ge_p_gb``/``ge_p_bg`` transition probabilities per message,
      ``ge_drop_good``/``ge_drop_bad`` loss rates per state), drawn
      from the same per-link seeded RNG stream as the classic faults —
      loss arrives in bursts, the shape one lossy WAN hop actually has.
    """

    drop: float = 0.0
    delay: float = 0.0
    delay_ms: Tuple[float, float] = (1.0, 5.0)
    duplicate: float = 0.0
    reorder: float = 0.0
    reorder_ms: Tuple[float, float] = (1.0, 10.0)
    bw_kbps: float = 0.0
    bw_burst_kb: float = 64.0
    ge_p_gb: float = 0.0
    ge_p_bg: float = 0.0
    ge_drop_good: float = 0.0
    ge_drop_bad: float = 1.0

    def __post_init__(self):
        _prob(self.drop, "drop")
        _prob(self.delay, "delay")
        _prob(self.duplicate, "duplicate")
        _prob(self.reorder, "reorder")
        _prob(self.ge_p_gb, "ge_p_gb")
        _prob(self.ge_p_bg, "ge_p_bg")
        _prob(self.ge_drop_good, "ge_drop_good")
        _prob(self.ge_drop_bad, "ge_drop_bad")
        if self.bw_kbps < 0:
            raise ValueError(f"bw_kbps must be >= 0, got {self.bw_kbps}")
        if self.bw_burst_kb <= 0:
            raise ValueError(
                f"bw_burst_kb must be positive, got {self.bw_burst_kb}"
            )
        object.__setattr__(self, "delay_ms",
                           _ms_range(self.delay_ms, "delay_ms"))
        object.__setattr__(self, "reorder_ms",
                           _ms_range(self.reorder_ms, "reorder_ms"))

    @property
    def ge_enabled(self) -> bool:
        return self.ge_p_gb > 0

    def to_dict(self) -> dict:
        out = {
            "drop": self.drop, "delay": self.delay,
            "delay_ms": list(self.delay_ms),
            "duplicate": self.duplicate, "reorder": self.reorder,
            "reorder_ms": list(self.reorder_ms),
        }
        # WAN keys ride only when set: pre-WAN plan JSON stays stable
        if self.bw_kbps:
            out["bw_kbps"] = self.bw_kbps
            out["bw_burst_kb"] = self.bw_burst_kb
        if self.ge_enabled:
            out["ge_p_gb"] = self.ge_p_gb
            out["ge_p_bg"] = self.ge_p_bg
            out["ge_drop_good"] = self.ge_drop_good
            out["ge_drop_bad"] = self.ge_drop_bad
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "LinkFaults":
        known = {"drop", "delay", "delay_ms", "duplicate", "reorder",
                 "reorder_ms", "bw_kbps", "bw_burst_kb", "ge_p_gb",
                 "ge_p_bg", "ge_drop_good", "ge_drop_bad"}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown link fault keys: {sorted(extra)}")
        kw = dict(d)
        for k in ("delay_ms", "reorder_ms"):
            if k in kw:
                kw[k] = tuple(kw[k])
        return cls(**kw)


@dataclass(frozen=True)
class LinkOverride:
    """Override the default link faults for links matching (src, dst);
    ``None`` matches any node — ``src=2, dst=None`` degrades every link
    *out of* node 2 (the slow-peer shape)."""

    faults: LinkFaults
    src: Optional[int] = None
    dst: Optional[int] = None

    def matches(self, src: int, dst: int) -> bool:
        return ((self.src is None or self.src == src)
                and (self.dst is None or self.dst == dst))


@dataclass(frozen=True)
class Partition:
    """From tick ``start`` until ``heal`` (exclusive; ``None`` = never),
    the listed group cannot exchange messages with everyone else in
    either direction."""

    group: Tuple[int, ...]
    start: int
    heal: Optional[int] = None

    def __post_init__(self):
        if self.heal is not None and self.heal <= self.start:
            raise ValueError(
                f"partition heal {self.heal} must be after start {self.start}"
            )
        object.__setattr__(self, "group", tuple(self.group))

    def active(self, tick: float) -> bool:
        return tick >= self.start and (self.heal is None or tick < self.heal)

    def separates(self, src: int, dst: int, tick: float) -> bool:
        if not self.active(tick):
            return False
        return (src in self.group) != (dst in self.group)


@dataclass(frozen=True)
class Crash:
    """Node ``node`` goes down at tick ``crash``; ``restart=None``
    means it stays down."""

    node: int
    crash: int
    restart: Optional[int] = None

    def __post_init__(self):
        if self.restart is not None and self.restart <= self.crash:
            raise ValueError(
                f"restart {self.restart} must be after crash {self.crash}"
            )


@dataclass(frozen=True)
class MembershipOp:
    """One scheduled churn verb (membership plane).  ``join``: node
    ``node`` (an index at or past the founding set — the runner boots
    it as an observer at this tick) submits its signed join tx through
    node ``via``'s pool.  ``leave``: founding-or-joined node ``node``
    announces departure — the tx is signed by the SUBJECT's key but may
    be submitted via any live node, which is what makes
    leave-mid-outage possible (the runner holds every scenario key)."""

    kind: str            # "join" | "leave"
    tick: int
    node: int
    via: Optional[int] = None

    def __post_init__(self):
        if self.kind not in ("join", "leave"):
            raise ValueError(f"unknown membership kind {self.kind!r}")
        if self.tick < 0:
            raise ValueError("membership tick must be >= 0")


@dataclass(frozen=True)
class ClockSkew:
    """Per-node bounded clock drift (adversarial time):
    every affected node's ``Core.now_ns`` is offset by a constant drawn
    from the injector's seeded per-node stream, uniform in
    ``[-max_ms, +max_ms]``.  ``nodes=None`` drifts everyone.  The
    ``skew_robust_order`` invariant asserts the committed order is
    IDENTICAL to the drift-free twin run — median timestamps absorb
    bounded per-creator skew."""

    max_ms: float = 0.5
    nodes: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.max_ms < 0:
            raise ValueError("clock skew max_ms must be >= 0")
        if self.nodes is not None:
            object.__setattr__(self, "nodes", tuple(self.nodes))

    def affects(self, node: int) -> bool:
        return self.nodes is None or node in self.nodes


#: disk-fault kinds, in the order the injector draws them at restart
DISK_FAULT_KINDS = (
    "checkpoint_corrupt", "checkpoint_truncate",
    "wal_corrupt", "wal_truncate",
)


@dataclass(frozen=True)
class DiskFaults:
    """Durable-state rot applied to a node's checkpoint/WAL files at
    *restart* time (a crash is when fsync lies surface): each field is
    the probability that kind fires on a given restart, drawn from the
    injector's per-node seeded disk stream.  Corrupt = flip one byte at
    a seeded offset; truncate = chop a seeded number of tail bytes.
    The restarted node must recover through the durability ladder
    (checkpoint -> WAL replay truncated at the damage -> seq probe ->
    gossip/fast-forward) without ever violating prefix agreement."""

    checkpoint_corrupt: float = 0.0
    checkpoint_truncate: float = 0.0
    wal_corrupt: float = 0.0
    wal_truncate: float = 0.0

    def __post_init__(self):
        for kind in DISK_FAULT_KINDS:
            _prob(getattr(self, kind), kind)

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in DISK_FAULT_KINDS}

    @classmethod
    def from_dict(cls, d: dict) -> "DiskFaults":
        extra = set(d) - set(DISK_FAULT_KINDS)
        if extra:
            raise ValueError(f"unknown disk fault keys: {sorted(extra)}")
        return cls(**d)


@dataclass(frozen=True)
class ByzantineSpec:
    """One byzantine actor.  ``fork`` mints an equivocating event at
    tick ``at`` and plants the branches at two different peers;
    ``stale_replay`` answers inbound syncs with a cached stale response
    with probability ``prob`` from tick ``at`` on; ``forge_snapshot``
    answers every fast-forward request from tick ``at`` on with a
    DOCTORED snapshot — committed history rewritten, digest recomputed
    self-consistently, proof re-signed under the actor's own key — the
    protocol-aware-recovery attack verified fast-forward exists to
    refuse; ``lying_ts`` mints events whose claimed timestamps are
    EXTREME lies (each mint lies with probability ``prob`` from tick
    ``at`` on, offsets drawn from a dedicated seeded stream) — the
    creator-claimed-median ordering attack the per-creator timestamp
    clamp (core/dag.py TS_CLAMP_WINDOW_NS) exists to absorb."""

    node: int
    mode: str = "fork"
    at: int = 0
    prob: float = 0.3

    def __post_init__(self):
        if self.mode not in BYZANTINE_MODES:
            raise ValueError(
                f"byzantine mode {self.mode!r} not in {BYZANTINE_MODES}"
            )
        _prob(self.prob, "byzantine prob")


@dataclass
class FaultPlan:
    """The full declarative fault surface for one scenario."""

    default: LinkFaults = field(default_factory=LinkFaults)
    overrides: List[LinkOverride] = field(default_factory=list)
    partitions: List[Partition] = field(default_factory=list)
    crashes: List[Crash] = field(default_factory=list)
    byzantine: Optional[ByzantineSpec] = None
    #: durable-state rot applied at restart time (None = disks behave)
    disk: Optional[DiskFaults] = None
    #: membership churn verbs (membership plane): scheduled join/leave
    #: transitions submitted as signed txs through the ordinary ingress
    joins: List[MembershipOp] = field(default_factory=list)
    leaves: List[MembershipOp] = field(default_factory=list)
    #: per-node bounded clock drift (None = clocks honest)
    clock_skew: Optional[ClockSkew] = None

    def link(self, src: int, dst: int) -> LinkFaults:
        """Resolved faults for the directed link src -> dst (last
        matching override wins; most-specific plans list specific
        overrides last)."""
        out = self.default
        for ov in self.overrides:
            if ov.matches(src, dst):
                out = ov.faults
        return out

    def partitioned(self, src: int, dst: int, tick: float) -> bool:
        return any(p.separates(src, dst, tick) for p in self.partitions)

    def validate(self, n_nodes: int, joiners: int = 0) -> None:
        total = n_nodes + joiners

        def _node(i, what, bound=n_nodes):
            if not 0 <= i < bound:
                raise ValueError(
                    f"{what} node {i} out of range 0..{bound - 1}"
                )

        for ov in self.overrides:
            for v, what in ((ov.src, "override src"), (ov.dst, "override dst")):
                if v is not None:
                    _node(v, what, total)
        for p in self.partitions:
            for i in p.group:
                _node(i, "partition", total)
            if len(p.group) >= total:
                raise ValueError("partition group must leave someone outside")
        for c in self.crashes:
            _node(c.node, "crash", total)
        if self.byzantine is not None:
            _node(self.byzantine.node, "byzantine")
        if len(self.joins) != joiners:
            raise ValueError(
                f"plan schedules {len(self.joins)} joins but the "
                f"scenario declares {joiners} joiners"
            )
        for j, op in enumerate(self.joins):
            if op.kind != "join":
                raise ValueError("joins list carries a non-join op")
            if op.node != n_nodes + j:
                raise ValueError(
                    f"join #{j} must target node {n_nodes + j} (joiner "
                    f"indices follow the founding set in schedule order)"
                )
            if op.via is not None:
                _node(op.via, "join via")
        for op in self.leaves:
            if op.kind != "leave":
                raise ValueError("leaves list carries a non-leave op")
            _node(op.node, "leave", total)
            if op.via is not None:
                _node(op.via, "leave via", total)

    def to_dict(self) -> dict:
        out: dict = {"default": self.default.to_dict()}
        if self.overrides:
            out["overrides"] = [
                {"src": ov.src, "dst": ov.dst, **ov.faults.to_dict()}
                for ov in self.overrides
            ]
        if self.partitions:
            out["partitions"] = [
                {"group": list(p.group), "start": p.start, "heal": p.heal}
                for p in self.partitions
            ]
        if self.crashes:
            out["crashes"] = [
                {"node": c.node, "crash": c.crash, "restart": c.restart}
                for c in self.crashes
            ]
        if self.byzantine is not None:
            b = self.byzantine
            out["byzantine"] = {"node": b.node, "mode": b.mode,
                                "at": b.at, "prob": b.prob}
        if self.disk is not None:
            out["disk"] = self.disk.to_dict()
        if self.joins:
            out["joins"] = [
                {"tick": op.tick, "node": op.node, "via": op.via}
                for op in self.joins
            ]
        if self.leaves:
            out["leaves"] = [
                {"tick": op.tick, "node": op.node, "via": op.via}
                for op in self.leaves
            ]
        if self.clock_skew is not None:
            out["clock_skew"] = {
                "max_ms": self.clock_skew.max_ms,
                "nodes": (list(self.clock_skew.nodes)
                          if self.clock_skew.nodes is not None else None),
            }
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        known = {"default", "overrides", "partitions", "crashes",
                 "byzantine", "disk", "joins", "leaves", "clock_skew"}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown fault plan keys: {sorted(extra)}")
        overrides = []
        for ov in d.get("overrides", []):
            ov = dict(ov)
            src, dst = ov.pop("src", None), ov.pop("dst", None)
            overrides.append(LinkOverride(
                faults=LinkFaults.from_dict(ov), src=src, dst=dst,
            ))
        byz = d.get("byzantine")
        disk = d.get("disk")
        skew = d.get("clock_skew")
        return cls(
            default=LinkFaults.from_dict(d.get("default", {})),
            overrides=overrides,
            partitions=[Partition(**p) for p in d.get("partitions", [])],
            crashes=[Crash(**c) for c in d.get("crashes", [])],
            byzantine=ByzantineSpec(**byz) if byz else None,
            disk=DiskFaults.from_dict(disk) if disk else None,
            joins=[MembershipOp(kind="join", **j)
                   for j in d.get("joins", [])],
            leaves=[MembershipOp(kind="leave", **lv)
                    for lv in d.get("leaves", [])],
            clock_skew=ClockSkew(**skew) if skew else None,
        )


@dataclass
class Scenario:
    """A fault plan plus the cluster + workload it runs against and the
    invariants the result must satisfy."""

    name: str
    nodes: int = 4
    steps: int = 240
    seed: int = 7
    #: membership plane: nodes beyond the founding set that JOIN during
    #: the run (plan.joins schedules when; joiner i takes scenario index
    #: nodes + i).  Joiners boot as observers at their join tick.
    joiners: int = 0
    plan: FaultPlan = field(default_factory=FaultPlan)
    #: consensus engine the cluster runs: "fused" (honest) or
    #: "byzantine" (fork-aware).  A fork-attack scenario run with
    #: "fused" is the intentionally-broken demo — the attack's branches
    #: are rejected instead of detected, and the fork_detected
    #: invariant fails loudly.
    engine: str = "fused"
    cache_size: int = 512
    seq_window: Optional[int] = None
    #: per-creator eviction: decided rounds of silence after which a
    #: creator's retained tail evicts (None = node-config default; the
    #: dead-creator scenario sets it low so the outage crosses it)
    inactive_rounds: Optional[int] = None
    txs: int = 16
    tx_every: int = 5
    invariants: Tuple[str, ...] = ("prefix_agreement", "liveness")
    #: liveness bound: consensus must advance on every honest live node
    #: within this many ticks of the last heal/restart
    liveness_bound: int = 120
    #: fault-free all-to-all gossip rounds appended after the plan runs
    #: (the "network eventually behaves" phase convergence checks need)
    settle_rounds: int = 6
    #: in-memory runner: save a durable checkpoint for every live node
    #: each N ticks (0 = WAL-only durability).  Only meaningful when the
    #: plan crashes nodes — a stale checkpoint plus the WAL tail is
    #: exactly the state a restart must recover from.
    checkpoint_every: int = 0
    #: live mode: wall seconds per tick
    tick_seconds: float = 0.05

    def __post_init__(self):
        if self.nodes < 2:
            raise ValueError("a scenario needs at least 2 nodes")
        if self.steps <= 0:
            raise ValueError("steps must be positive")
        if self.engine not in ("fused", "byzantine"):
            raise ValueError(f"unknown engine {self.engine!r}")
        unknown = set(self.invariants) - set(KNOWN_INVARIANTS)
        if unknown:
            raise ValueError(
                f"unknown invariants {sorted(unknown)}; "
                f"known: {KNOWN_INVARIANTS}"
            )
        if self.joiners < 0:
            raise ValueError("joiners must be >= 0")
        if self.joiners and self.engine != "fused":
            raise ValueError(
                "membership churn requires the fused engine (epoch "
                "transitions are not implemented for wide/byzantine)"
            )
        object.__setattr__(self, "invariants", tuple(self.invariants))
        self.plan.validate(self.nodes, self.joiners)

    def to_dict(self) -> dict:
        return {
            "name": self.name, "nodes": self.nodes, "steps": self.steps,
            "seed": self.seed, "joiners": self.joiners,
            "engine": self.engine,
            "cache_size": self.cache_size, "seq_window": self.seq_window,
            "inactive_rounds": self.inactive_rounds,
            "txs": self.txs, "tx_every": self.tx_every,
            "invariants": list(self.invariants),
            "liveness_bound": self.liveness_bound,
            "settle_rounds": self.settle_rounds,
            "checkpoint_every": self.checkpoint_every,
            "tick_seconds": self.tick_seconds,
            "plan": self.plan.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        d = dict(d)
        plan = FaultPlan.from_dict(d.pop("plan", {}))
        known = {
            "name", "nodes", "steps", "seed", "joiners", "engine",
            "cache_size", "seq_window", "inactive_rounds", "txs",
            "tx_every", "invariants", "liveness_bound", "settle_rounds",
            "checkpoint_every", "tick_seconds",
        }
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown scenario keys: {sorted(extra)}")
        if "invariants" in d:
            d["invariants"] = tuple(d["invariants"])
        return cls(plan=plan, **d)

    @classmethod
    def from_json_file(cls, path: str) -> "Scenario":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


#: per-tick schedule of crash/restart actions, derived once per run
def crash_schedule(plan: FaultPlan) -> Dict[int, List[Tuple[str, int]]]:
    """tick -> [("crash"|"restart", node)] in declaration order."""
    out: Dict[int, List[Tuple[str, int]]] = {}
    for c in plan.crashes:
        out.setdefault(c.crash, []).append(("crash", c.node))
        if c.restart is not None:
            out.setdefault(c.restart, []).append(("restart", c.node))
    return out
