"""Deterministic chaos plane: seedable fault injection for consensus (the
port's copy of the JAX package's ``chaos``).

Babble's value proposition is BFT ordering under hostile networks; this
package makes hostile networks *reproducible on purpose*:

- :mod:`.plan` — declarative :class:`FaultPlan` / :class:`Scenario`
  (per-link drop/delay/duplicate/reorder, scheduled partitions with
  heal times, crash/restart, byzantine actors) with a stable JSON form;
- :mod:`.injector` — :class:`FaultInjector`: (plan, seed) -> concrete
  fault decisions via per-link seeded RNG streams, so the fault
  schedule is reproducible from ``--seed`` alone;
- :mod:`.transport` — :class:`FaultyTransport`, wrapping any
  ``Transport`` (in-memory or TCP) and counting injected faults on
  ``babble_chaos_faults_total{kind=...}``;
- :mod:`.scenario` — the deterministic in-memory cluster runner
  (bit-for-bit reproducible fault schedule AND committed order) and the
  live ``TestnetRunner`` fleet runner;
- :mod:`.invariants` — :class:`InvariantChecker`: safety (cross-node
  prefix agreement), liveness (commits resume after heal), fork
  detection, fast-forward recovery;
- :mod:`.disk` — seeded durable-state rot (checkpoint/WAL corruption +
  truncation) applied at restart time, the "disk faults" tier;
- :mod:`.scenarios` — canned scenarios (flaky-link, minority-partition,
  crash-restart, disk-rot, fork-attack, slow-peer, stale-replay)
  behind ``python -m babble_tpu_torch.cli chaos run <name> [--seed N]``.  Crash/restart
  scenarios run HONEST: the durability plane (``wal/``) makes
  restarts seq-exact, so the old fork-aware workaround is gone.

Reproducibility is enforced mechanically: babble-lint's
``chaos-unseeded-random`` rule bans module-level ``random.*`` calls in
chaos code paths — every draw must come from an injector-held seeded
``random.Random``.
"""

from .disk import apply_disk_faults
from .injector import FAULT_KINDS, FaultInjector, OutboundFaults
from .invariants import InvariantChecker, InvariantReport, Violation
from .plan import (
    DISK_FAULT_KINDS,
    KNOWN_INVARIANTS,
    ByzantineSpec,
    Crash,
    DiskFaults,
    FaultPlan,
    LinkFaults,
    LinkOverride,
    Partition,
    Scenario,
)
from .scenario import (
    ScenarioResult,
    ScenarioRunner,
    deterministic_keys,
    run_live,
    run_scenario,
)
from .scenarios import CANNED, canned_names, load_scenario
from .transport import FaultyTransport

__all__ = [
    "CANNED",
    "DISK_FAULT_KINDS",
    "FAULT_KINDS",
    "KNOWN_INVARIANTS",
    "ByzantineSpec",
    "Crash",
    "DiskFaults",
    "FaultInjector",
    "FaultPlan",
    "FaultyTransport",
    "InvariantChecker",
    "InvariantReport",
    "LinkFaults",
    "LinkOverride",
    "OutboundFaults",
    "Partition",
    "Scenario",
    "ScenarioResult",
    "ScenarioRunner",
    "Violation",
    "apply_disk_faults",
    "canned_names",
    "deterministic_keys",
    "load_scenario",
    "run_live",
    "run_scenario",
]
