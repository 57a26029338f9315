"""Seeded fault injector: turns a (FaultPlan, seed) pair into decisions.

Every random draw comes from a **per-directed-link child RNG** derived
from the seed (``random.Random(f"{seed}:{src}>{dst}")``), never from the
process-global RNG: the k-th sync attempt on a given link sees the same
fault decision in every run, regardless of how syncs on other links
interleave.  That is the property the acceptance test pins — the fault
schedule is a pure function of (plan, seed, per-link attempt ordinal).

The injector is clock-agnostic: the deterministic scenario runner
advances ticks manually (:meth:`advance_to`), the live node path
installs a wall-clock tick callback.  Schedule state (partitions) is
read at decision time from whichever clock is installed.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .plan import FaultPlan

#: fault kinds as exposed on babble_chaos_faults_total{kind=...}
#: (disk kinds are runner-applied at restart; they land in the
#: injector log / fault_counts and pre-exist as metric series)
FAULT_KINDS = (
    "drop", "delay", "duplicate", "reorder", "partition", "stale_replay",
    "forged_snapshot",
    "checkpoint_corrupt", "checkpoint_truncate", "wal_corrupt",
    "wal_truncate",
    # membership churn + adversarial time (runner-applied; recorded so
    # the schedule fingerprint covers them)
    "join", "leave", "clock_skew",
    # WAN link models: token-bucket serialization
    # delay and Gilbert–Elliott burst loss; lying_ts is the
    # adversarial-timestamp byzantine actor's per-mint lie
    "bw_delay", "ge_drop", "lying_ts",
)

#: one bandwidth-model sleep never exceeds this (a hostile/absurd plan
#: must not wedge the runner behind a multi-minute awaited sleep)
BW_DELAY_MAX_S = 1.0

#: lying_ts offsets are uniform in ±this many ns (an hour: far outside
#: any honest clamp window, so the defense — not luck — is what keeps
#: the medians in the honest envelope)
LIE_MAX_NS = 3_600_000_000_000


@dataclass(frozen=True)
class OutboundFaults:
    """Concrete decisions for one outbound sync attempt."""

    drop: bool = False
    delay_s: float = 0.0
    duplicate: bool = False
    reorder_s: float = 0.0
    #: the drop came from the Gilbert–Elliott loss chain (metrics
    #: split burst loss from uniform loss)
    ge: bool = False


class FaultInjector:
    def __init__(
        self,
        plan: FaultPlan,
        seed: int,
        clock: Optional[Callable[[], float]] = None,
        tick_seconds: float = 0.05,
    ):
        self.plan = plan
        self.seed = seed
        self._clock = clock
        self._tick = 0.0
        #: wall seconds one plan tick represents — the token bucket's
        #: replenish clock (Scenario.tick_seconds; the deterministic
        #: runner advances ticks manually, so bucket state stays a pure
        #: function of the per-link message sequence)
        self.tick_seconds = float(tick_seconds)
        self._rngs: Dict[Tuple[int, int], random.Random] = {}
        self._node_rngs: Dict[object, random.Random] = {}
        self._link_seq: Dict[Tuple[int, int], int] = {}
        #: per-link token-bucket fill (bytes, may run negative as
        #: queueing deficit) + the tick it was last updated
        self._bw_state: Dict[Tuple[int, int], Tuple[float, float]] = {}
        #: per-link Gilbert–Elliott state (True = bad/bursty)
        self._ge_bad: Dict[Tuple[int, int], bool] = {}
        #: decision log — only fired faults are recorded; ``seq`` is the
        #: per-link attempt ordinal, so sorting by (src, dst, seq) gives
        #: a canonical schedule independent of global interleaving
        self.log: List[dict] = []
        #: faults are suppressed while quiesced (the settle phase at the
        #: end of a deterministic run: "the network eventually behaves")
        self.quiesce = False

    # ------------------------------------------------------------------
    # clock

    @property
    def tick(self) -> float:
        if self._clock is not None:
            return self._clock()
        return self._tick

    def advance_to(self, tick: float) -> None:
        self._tick = float(tick)

    # ------------------------------------------------------------------
    # seeded streams

    def _rng(self, src: int, dst: int) -> random.Random:
        rng = self._rngs.get((src, dst))
        if rng is None:
            # string seeding is content-based (not hash()-based), so the
            # stream is stable across processes and PYTHONHASHSEED
            rng = self._rngs[(src, dst)] = random.Random(
                f"babble-chaos:{self.seed}:{src}>{dst}"
            )
        return rng

    def node_rng(self, node: int) -> random.Random:
        rng = self._node_rngs.get(node)
        if rng is None:
            rng = self._node_rngs[node] = random.Random(
                f"babble-chaos:{self.seed}:node:{node}"
            )
        return rng

    def disk_rng(self, node: int) -> random.Random:
        """Per-node disk-rot stream (chaos/disk.py), separate from the
        byzantine node stream so adding disk faults to a plan never
        shifts a stale-replay actor's draws."""
        key = ("disk", node)
        rng = self._node_rngs.get(key)
        if rng is None:
            rng = self._node_rngs[key] = random.Random(
                f"babble-chaos:{self.seed}:disk:{node}"
            )
        return rng

    def clock_drift_ns(self, node: int) -> int:
        """Per-node bounded clock drift (adversarial time):
        one constant offset per node per run, uniform in ±max_ms, from
        a dedicated seeded stream — so enabling skew never shifts any
        other fault stream's draws.  0 when the plan drifts no clocks
        or this node is excluded."""
        skew = self.plan.clock_skew
        if skew is None or not skew.affects(node) or skew.max_ms <= 0:
            return 0
        key = ("skew", node)
        rng = self._node_rngs.get(key)
        if rng is None:
            rng = self._node_rngs[key] = random.Random(
                f"babble-chaos:{self.seed}:skew:{node}"
            )
        return int(rng.uniform(-skew.max_ms, skew.max_ms) * 1e6)

    # ------------------------------------------------------------------
    # decisions

    def record(self, kind: str, src: int, dst: int, **extra) -> dict:
        seq = self._link_seq.get((src, dst), 0)
        entry = {"kind": kind, "src": src, "dst": dst,
                 "tick": self.tick, "seq": seq, **extra}
        self.log.append(entry)
        return entry

    def link_blocked(self, src: int, dst: int) -> bool:
        if self.quiesce:
            return False
        return self.plan.partitioned(src, dst, self.tick)

    def outbound(self, src: int, dst: int) -> OutboundFaults:
        """Draw the fault decisions for one sync attempt src -> dst.
        Quiesced attempts draw nothing, so the faulted portion of the
        per-link stream stays aligned with its attempt count.  Links
        without Gilbert–Elliott config draw nothing for it either —
        adding the model to one link never shifts another link's (or a
        pre-WAN plan's) stream."""
        if self.quiesce:
            return OutboundFaults()
        f = self.plan.link(src, dst)
        rng = self._rng(src, dst)
        self._link_seq[(src, dst)] = self._link_seq.get((src, dst), 0) + 1
        if f.ge_enabled:
            key = (src, dst)
            bad = self._ge_bad.get(key, False)
            if bad:
                if rng.random() < f.ge_p_bg:
                    bad = False
            elif rng.random() < f.ge_p_gb:
                bad = True
            self._ge_bad[key] = bad
            p_loss = f.ge_drop_bad if bad else f.ge_drop_good
            if p_loss and rng.random() < p_loss:
                self.record("ge_drop", src, dst, bad=bad)
                return OutboundFaults(drop=True, ge=True)
        if f.drop and rng.random() < f.drop:
            self.record("drop", src, dst)
            return OutboundFaults(drop=True)
        delay_s = 0.0
        if f.delay and rng.random() < f.delay:
            delay_s = rng.uniform(*f.delay_ms) / 1e3
            self.record("delay", src, dst, ms=round(delay_s * 1e3, 3))
        duplicate = bool(f.duplicate and rng.random() < f.duplicate)
        if duplicate:
            self.record("duplicate", src, dst)
        reorder_s = 0.0
        if f.reorder and rng.random() < f.reorder:
            reorder_s = rng.uniform(*f.reorder_ms) / 1e3
            self.record("reorder", src, dst, ms=round(reorder_s * 1e3, 3))
        return OutboundFaults(drop=False, delay_s=delay_s,
                              duplicate=duplicate, reorder_s=reorder_s)

    def bw_delay_s(self, src: int, dst: int, nbytes: int) -> float:
        """Token-bucket bandwidth model for one gossip-class message of
        ``nbytes`` on the directed link (WAN emulation): a size-proportional serialization delay, plus queueing
        delay once the burst bucket is exhausted.  Draws NO randomness
        — the schedule is a pure function of the deterministic message
        sizes and tick times, so bit-reproducibility is free.  0 when
        the link is uncapped or the run is quiescing."""
        if self.quiesce:
            return 0.0
        f = self.plan.link(src, dst)
        if not f.bw_kbps:
            return 0.0
        rate = f.bw_kbps * 125.0            # kilobits/s -> bytes/s
        burst = f.bw_burst_kb * 1024.0
        key = (src, dst)
        now = self.tick
        tokens, last = self._bw_state.get(key, (burst, now))
        tokens = min(
            burst, tokens + max(now - last, 0.0) * self.tick_seconds * rate
        )
        deficit = nbytes - max(tokens, 0.0)
        tokens -= nbytes
        self._bw_state[key] = (tokens, now)
        delay = nbytes / rate
        if deficit > 0:
            delay += deficit / rate
        return min(delay, BW_DELAY_MAX_S)

    # ------------------------------------------------------------------
    # byzantine

    def is_stale_replayer(self, node: int) -> bool:
        b = self.plan.byzantine
        return (b is not None and b.mode == "stale_replay"
                and b.node == node)

    def stale_replay(self, node: int) -> bool:
        """Should this inbound sync be answered with a stale cached
        response?  Only for the configured stale-replay actor, only
        once its activation tick passed."""
        if self.quiesce or not self.is_stale_replayer(node):
            return False
        b = self.plan.byzantine
        if self.tick < b.at:
            return False
        return self.node_rng(node).random() < b.prob

    def stale_pick(self, node: int, n_cached: int) -> int:
        return self.node_rng(node).randrange(n_cached)

    def is_ts_liar(self, node: int) -> bool:
        b = self.plan.byzantine
        return (b is not None and b.mode == "lying_ts"
                and b.node == node)

    def lying_ts_offset_ns(self, node: int) -> int:
        """One mint's timestamp lie for the lying_ts actor: 0 (honest
        mint), or an extreme ±offset uniform in ±LIE_MAX_NS, with
        probability ``prob`` per mint once the activation tick passed.
        Drawn from a dedicated seeded stream (like clock_skew), so
        enabling the actor never shifts any other fault stream's
        draws.  Suppressed while quiescing so the settle phase
        converges on honest time."""
        if self.quiesce or not self.is_ts_liar(node):
            return 0
        b = self.plan.byzantine
        if self.tick < b.at:
            return 0
        key = ("liar", node)
        rng = self._node_rngs.get(key)
        if rng is None:
            rng = self._node_rngs[key] = random.Random(
                f"babble-chaos:{self.seed}:liar:{node}"
            )
        if rng.random() >= b.prob:
            return 0
        off = int(rng.uniform(-LIE_MAX_NS, LIE_MAX_NS))
        self.record("lying_ts", node, node)
        return off

    def is_snapshot_forger(self, node: int) -> bool:
        b = self.plan.byzantine
        return (b is not None and b.mode == "forge_snapshot"
                and b.node == node)

    def snapshot_forge(self, node: int) -> bool:
        """Should this outgoing fast-forward response be doctored?
        Deterministic (every response once the activation tick passed —
        forging draws no randomness, so adding the actor never shifts
        any other fault stream); suppressed during quiesce like every
        other fault so the settle phase can converge."""
        if self.quiesce or not self.is_snapshot_forger(node):
            return False
        return self.tick >= self.plan.byzantine.at

    # ------------------------------------------------------------------

    def schedule_fingerprint(self) -> List[tuple]:
        """Canonical fault schedule: (src, dst, seq, kind) sorted — the
        reproducibility tests compare this across runs."""
        return sorted(
            (e["src"], e["dst"], e["seq"], e["kind"]) for e in self.log
        )
