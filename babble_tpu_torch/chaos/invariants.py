"""Consensus invariants the chaos plane checks after every scenario.

Safety and liveness in the hashgraph sense, stated over what a scenario
run actually observed:

- **prefix_agreement** (safety): every pair of honest nodes committed
  the same transaction order — the shorter log is a prefix of the
  longer.  A node that crashed and restarted re-joins mid-stream (its
  pre-restart deliveries happened in a previous incarnation, and a
  fast-forward legitimately skips a gap), so its log must instead be a
  contiguous sublist of the longest honest log.
- **liveness**: consensus resumes after the network heals — every
  honest live node's consensus-event count strictly increases between
  the last heal/restart tick and ``liveness_bound`` ticks later.
- **all_committed**: every submitted transaction appears in every
  honest non-restarted node's committed log (checked after the settle
  phase, when the network has been allowed to behave).
- **fork_detected**: every honest node flagged the byzantine creator's
  equivocation.  This is the invariant the intentionally-broken
  fork-attack variant (fork detection disabled — ``engine: fused``)
  fails loudly, which is exactly the point: without the fork-aware
  engine the attack is invisible.
- **fast_forwarded**: a crashed-and-restarted node caught back up via
  the snapshot RPC (at least one fast-forward completed).
- **eviction_advanced**: while a creator was down, the
  surviving fleet's eviction horizon moved PAST it (its retained tail
  evicted, a per-creator horizon recorded) and the live slot window
  stayed bounded — the silent peer no longer pins memory for the
  length of its outage.
- **ff_proof_rejected**: the forge_snapshot byzantine
  actor's doctored snapshot was refused by at least one joiner
  (babble_ff_proof_rejects_total >= 1) — paired with prefix_agreement
  and fast_forwarded, this is "reject the forgery loudly AND still
  recover through an honest peer".

The checker never raises mid-collection: it gathers every violation and
reports them all, because a scenario that breaks two invariants at once
is exactly the run you want the full picture of.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence


@dataclass(frozen=True)
class Violation:
    invariant: str
    detail: str

    def format(self) -> str:
        return f"INVARIANT VIOLATION [{self.invariant}]: {self.detail}"


@dataclass
class InvariantReport:
    checked: List[str] = field(default_factory=list)
    violations: List[Violation] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def format(self) -> str:
        lines = [f"invariants checked: {', '.join(self.checked) or '(none)'}"]
        if self.ok:
            lines.append("all invariants hold")
        else:
            lines.extend(v.format() for v in self.violations)
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "checked": list(self.checked),
            "violations": [
                {"invariant": v.invariant, "detail": v.detail}
                for v in self.violations
            ],
        }


def _is_prefix(a: Sequence, b: Sequence) -> bool:
    small, big = (a, b) if len(a) <= len(b) else (b, a)
    return list(big[: len(small)]) == list(small)


def _is_contiguous_sublist(small: Sequence, big: Sequence) -> bool:
    if not small:
        return True
    small, big = list(small), list(big)
    first = small[0]
    start = 0
    while True:
        try:
            i = big.index(first, start)
        except ValueError:
            return False
        if big[i: i + len(small)] == small:
            return True
        start = i + 1


def _windows_agree(a: Sequence, b: Sequence) -> bool:
    """Two rolling *windows* of one logical sequence agree iff their
    overlap matches (either may have evicted a prefix the other still
    holds, and either may extend further).  Disjoint windows cannot be
    falsified and count as agreement."""
    a, b = list(a), list(b)
    if not a or not b:
        return True
    for small, big in ((a, b), (b, a)):
        if small[0] in big:
            i = big.index(small[0])
            n = min(len(small), len(big) - i)
            if big[i: i + n] == small[:n]:
                return True
    # no shared elements at all: windows over disjoint ranges of the
    # log cannot be falsified.  Any shared element with misaligned
    # heads, though, is a real disagreement.
    return not (set(a) & set(b))


class InvariantChecker:
    """Checks a ScenarioResult (scenario.py) against the scenario's
    declared invariant list."""

    def check(self, scenario, result) -> InvariantReport:
        report = InvariantReport(checked=list(scenario.invariants))
        for name in scenario.invariants:
            getattr(self, f"_check_{name}")(scenario, result, report)
        return report

    # ------------------------------------------------------------------

    def _check_prefix_agreement(self, scenario, result, report) -> None:
        # a crashed-for-good node has no final log to compare (the plan
        # explicitly supports restart=None) — agreement is checked over
        # the nodes that finished the run
        present = [i for i in result.honest if i in result.committed]
        # restarted nodes AND mid-run joiners (membership plane) enter
        # the stream mid-way: their logs are checked as contiguous
        # slices instead of strict prefixes
        midstream = set(result.restarted) | set(
            getattr(result, "joined", ())
        )
        honest = [i for i in present if i not in midstream]
        logs = {i: result.committed[i] for i in present}
        if honest:
            ref = max(honest, key=lambda i: len(logs[i]))
            for i in honest:
                if i == ref:
                    continue
                if not _is_prefix(logs[i], logs[ref]):
                    k = next(
                        (j for j, (x, y) in enumerate(zip(logs[i], logs[ref]))
                         if x != y),
                        min(len(logs[i]), len(logs[ref])),
                    )
                    report.violations.append(Violation(
                        "prefix_agreement",
                        f"nodes {i} and {ref} diverge at commit #{k}: "
                        f"{logs[i][k:k + 1]} vs {logs[ref][k:k + 1]}",
                    ))
            for i in sorted(midstream):
                if i not in result.honest or i not in logs:
                    continue
                if not _is_contiguous_sublist(logs[i], logs[ref]):
                    report.violations.append(Violation(
                        "prefix_agreement",
                        f"restarted/joined node {i}'s committed log is "
                        f"not a contiguous slice of node {ref}'s "
                        f"({len(logs[i])} vs {len(logs[ref])} commits)",
                    ))
        # consensus event order must agree too (stronger than tx order:
        # empty events count).  Engines expose a rolling *window* of the
        # consensus log (the evicted prefix is gone), so agreement is
        # checked on the overlap, not as a strict prefix.
        events = {i: result.consensus[i] for i in honest}
        if len(events) > 1:
            ref = max(events, key=lambda i: len(events[i]))
            for i in events:
                if i != ref and not _windows_agree(events[i], events[ref]):
                    report.violations.append(Violation(
                        "prefix_agreement",
                        f"nodes {i} and {ref} disagree on consensus "
                        "event order",
                    ))

    def _check_liveness(self, scenario, result, report) -> None:
        if result.heal_tick is None:
            # no partition/crash schedule: liveness = consensus happened
            for i in result.honest:
                if i in result.alive and result.consensus_counts_final[i] <= 0:
                    report.violations.append(Violation(
                        "liveness", f"node {i} never reached consensus",
                    ))
            return
        for i in result.honest:
            if i not in result.alive:
                continue
            at_heal = result.consensus_counts_at_heal.get(i, 0)
            at_bound = result.consensus_counts_at_bound.get(
                i, result.consensus_counts_final[i]
            )
            if at_bound <= at_heal:
                report.violations.append(Violation(
                    "liveness",
                    f"node {i} made no consensus progress within "
                    f"{scenario.liveness_bound} ticks of the heal at "
                    f"tick {result.heal_tick} "
                    f"({at_heal} -> {at_bound} events)",
                ))

    def _check_all_committed(self, scenario, result, report) -> None:
        submitted = set(result.submitted)
        for i in result.honest:
            if i in result.restarted or i not in result.alive:
                continue
            missing = submitted - set(result.committed[i])
            if missing:
                sample = sorted(missing)[:3]
                report.violations.append(Violation(
                    "all_committed",
                    f"node {i} never committed {len(missing)} submitted "
                    f"tx(s), e.g. {sample}",
                ))

    def _check_fork_detected(self, scenario, result, report) -> None:
        if scenario.plan.byzantine is None:
            report.violations.append(Violation(
                "fork_detected",
                "scenario declares the fork_detected invariant but no "
                "byzantine actor",
            ))
            return
        for i in result.honest:
            if i not in result.alive:
                continue
            if not result.fork_detected.get(i, False):
                report.violations.append(Violation(
                    "fork_detected",
                    f"honest node {i} never detected node "
                    f"{scenario.plan.byzantine.node}'s equivocation "
                    + ("(the attack's branches were rejected at insert — "
                       "fork-aware mode is off, so the fork is invisible)"
                       if scenario.engine != "byzantine" else ""),
                ))

    def _check_eviction_advanced(self, scenario, result, report) -> None:
        crashed = [c.node for c in scenario.plan.crashes]
        if not crashed:
            report.violations.append(Violation(
                "eviction_advanced",
                "scenario declares the eviction_advanced invariant but "
                "no node ever crashes",
            ))
            return
        for node in crashed:
            if result.eviction_horizons.get(node, -1) < 0:
                report.violations.append(Violation(
                    "eviction_advanced",
                    f"no surviving node ever evicted silent creator "
                    f"{node}'s retained tail — the eviction horizon "
                    "never moved past the dead peer",
                ))
        bound = 8 * scenario.cache_size
        if result.outage_live_window_max > bound:
            report.violations.append(Violation(
                "eviction_advanced",
                f"live slot window reached "
                f"{result.outage_live_window_max} during the outage "
                f"(bound {bound} = 8x cache_size) — memory grew with "
                "the outage instead of staying bounded",
            ))

    def _check_ff_proof_rejected(self, scenario, result, report) -> None:
        byz = scenario.plan.byzantine
        if byz is None or byz.mode != "forge_snapshot":
            report.violations.append(Violation(
                "ff_proof_rejected",
                "scenario declares the ff_proof_rejected invariant but "
                "no forge_snapshot byzantine actor",
            ))
            return
        if not any(v > 0 for v in result.ff_proof_rejects.values()):
            report.violations.append(Violation(
                "ff_proof_rejected",
                "no node ever rejected the forged snapshot "
                "(babble_ff_proof_rejects_total stayed 0) — either the "
                "forgery was silently installed or the joiner never "
                "met the forger",
            ))

    def _check_epoch_agreement(self, scenario, result, report) -> None:
        """Membership plane: every honest node applied every scheduled
        transition, at the same decided-round boundary, yielding the
        same epoch — the ledger is consensus state, so any divergence
        here is a safety bug."""
        expected = len(scenario.plan.joins) + len(scenario.plan.leaves)
        if expected == 0:
            report.violations.append(Violation(
                "epoch_agreement",
                "scenario declares the epoch_agreement invariant but "
                "schedules no membership transitions",
            ))
            return
        logs = {
            i: tuple(result.membership_logs.get(i, ()))
            for i in result.honest if i in result.alive
        }
        for i, log in sorted(logs.items()):
            if len(log) != expected:
                report.violations.append(Violation(
                    "epoch_agreement",
                    f"node {i} applied {len(log)} of {expected} "
                    f"scheduled membership transitions",
                ))
        distinct = {log for log in logs.values()}
        if len(distinct) > 1:
            report.violations.append(Violation(
                "epoch_agreement",
                "honest nodes disagree on the membership ledger "
                f"({len(distinct)} distinct (epoch, kind, pub, "
                "boundary) sequences)",
            ))
        epochs = {result.epochs.get(i) for i in logs}
        if len(epochs) > 1:
            report.violations.append(Violation(
                "epoch_agreement",
                f"honest nodes ended at different epochs: {epochs}",
            ))

    def _check_skew_robust_order(self, scenario, result, report) -> None:
        """Adversarial time: bounded clock drift — or a lying_ts
        byzantine minority claiming EXTREME timestamps — must never
        REORDER two commits that the honest-time twin run orders
        strictly by (round_received, consensus_ts).  (rr, cts)-TIED
        commits fall to the whitened-signature tiebreak —
        deterministic across the fleet within each run, but
        legitimately different between the two runs, because the
        drifted/lying timestamps live inside the signed event bodies.
        So the claim checked is exactly this: median-timestamp
        ORDER over honest pairs is unaffected by bounded drift, and
        unperturbed by up to n/3 timestamp liars (the insert-time
        clamp pins their median contributions into the honest
        envelope)."""
        byz = scenario.plan.byzantine
        lying = byz is not None and byz.mode == "lying_ts"
        if scenario.plan.clock_skew is None and not lying:
            report.violations.append(Violation(
                "skew_robust_order",
                "scenario declares the skew_robust_order invariant but "
                "drifts no clocks and configures no lying_ts actor",
            ))
            return
        twin = result.noskew_committed
        keys_all = result.noskew_keys
        if twin is None or keys_all is None:
            report.violations.append(Violation(
                "skew_robust_order",
                "drift-free twin run missing (runner did not attach "
                "noskew_committed/noskew_keys)",
            ))
            return
        for i in sorted(result.honest):
            if i not in result.alive:
                continue
            a = result.committed.get(i)
            b = twin.get(i)
            keys = keys_all.get(i, {})
            if a is None or b is None:
                continue
            if set(a) != set(b):
                report.violations.append(Violation(
                    "skew_robust_order",
                    f"node {i}: drift changed WHICH transactions "
                    f"committed ({len(a)} vs {len(b)})",
                ))
                continue
            pos_a = {tx: j for j, tx in enumerate(a)}
            bad = None
            for j in range(len(b)):
                for k in range(j + 1, len(b)):
                    x, y = b[j], b[k]
                    kx, ky = keys.get(x), keys.get(y)
                    if kx is None or ky is None or kx == ky:
                        continue   # tie (or key rolled off): may permute
                    if pos_a[x] > pos_a[y]:
                        bad = (x, y, kx, ky)
                        break
                if bad:
                    break
            if bad:
                cause = (
                    f"±{scenario.plan.clock_skew.max_ms} ms drift"
                    if scenario.plan.clock_skew is not None
                    else f"the lying_ts actor (node {byz.node})"
                )
                report.violations.append(Violation(
                    "skew_robust_order",
                    f"node {i}: {cause} reordered two strictly-"
                    f"(rr, cts)-ordered commits "
                    f"({bad[2]} vs {bad[3]})",
                ))

    def _check_fast_forwarded(self, scenario, result, report) -> None:
        restarted = sorted(result.restarted)
        if not restarted:
            report.violations.append(Violation(
                "fast_forwarded",
                "scenario declares the fast_forwarded invariant but "
                "no node ever restarts",
            ))
            return
        if not any(result.fast_forwards.get(i, 0) > 0 for i in restarted):
            report.violations.append(Violation(
                "fast_forwarded",
                f"no restarted node ({restarted}) completed a "
                "fast-forward — the fleet never evicted past their "
                "windows, or the snapshot path failed",
            ))
