"""babble-lint: repo-native static analysis (stdlib-only, tier-1).

Rule families (see the rules' module docstrings):

- :mod:`.tracer` — JAX tracer safety inside jitted functions
- :mod:`.races` — asyncio interleaving races across ``await``
  (interprocedural: helper calls carry their self-write closures)
- :mod:`.blocking` — blocking calls (time.sleep, socket I/O) in coroutines
- :mod:`.invariants` — drain-before-validate + falsy-config fallback
- :mod:`.randomness` — unseeded global RNG in chaos code paths
- :mod:`.determinism` — project-wide taint from entropy sources to
  consensus-order sinks (``consensus-nondeterminism``)
- :mod:`.guards` — lock re-entry through call chains
  (``held-guard-escape``)
- :mod:`.walgossip` — self-event mint paths must pass through
  ``wal.append`` before gossiping (``wal-before-gossip``)
- :mod:`.snapshotadopt` — engines built from peer-supplied snapshot
  bytes must reach the signed-state-proof verification helpers
  (``unverified-snapshot-adopt``)
- :mod:`.device` — the device-plane family: donated-buffer
  discipline (``donate-use-after-free``), static-arg bucketing
  (``recompile-hazard``), partition-rule and SPMD-sentinel coverage
  (``partition-spec-coverage``), flush-traffic-model coverage
  (``bytes-model-coverage``)
- :mod:`.hostile` — trust-boundary taint: peer-decoded values must
  pass a bounds guard before any size-bearing sink
  (``unbounded-hostile-input``)
- :mod:`.parity` — declarative insert-path invariant registry diffed
  against every engine surface's call closure (``engine-parity``)
- :mod:`.serial` — serialization-plane schema lint:
  writer/reader field-inventory diffs (``pack-unpack-parity``),
  exact-partition coverage of checkpoint meta across bounds guards
  and restores (``checkpoint-field-coverage``), and the committed
  ``.babble-format-manifest.json`` keyed to version constants
  (``format-version-ratchet``, bumped via ``--write-format-manifest``)

The flow-aware rules stand on :mod:`.graph` (module symbol table +
project call graph), built once per run by the engine and attached to
every FileContext as ``ctx.project``.

Run as ``python -m babble_tpu_torch.analysis [--json|--format=...] [--cache
FILE] [paths]``; suppress a finding with ``# babble-lint:
disable=<rule-name>`` on the flagged line (or the line above).  A
suppression whose rule no longer fires is itself a finding
(``stale-suppression``).  The full rule set runs over ``babble_tpu_torch/``
in tier-1 (tests/test_static_analysis.py), so a new finding — or a
blanket/stale suppression — fails the build.

Adding a rule: subclass :class:`~.engine.Rule`, implement
``check(ctx)``, append an instance to :data:`ALL_RULES`.  Keep rules
stdlib-only — this package must import in environments without jax.
"""

from .engine import (
    ANALYSIS_VERSION,
    BAD_SUPPRESSION,
    PARSE_ERROR,
    STALE_SUPPRESSION,
    FileContext,
    Finding,
    Rule,
    check_file,
    run_paths,
)
from .cache import run_paths_cached
from .graph import ProjectContext
from .blocking import AsyncioBlockingCallRule
from .codecloop import CodecOnLoopRule
from .determinism import ConsensusNondeterminismRule
from .device import (
    BytesModelCoverageRule,
    DonateUseAfterFreeRule,
    PartitionSpecCoverageRule,
    RecompileHazardRule,
)
from .guards import HeldGuardEscapeRule
from .hostile import UnboundedHostileInputRule
from .invariants import DrainBeforeValidateRule, FalsyOrFallbackRule
from .parity import EngineParityRule
from .races import AwaitStateRaceRule
from .randomness import ChaosUnseededRandomRule
from .tracer import (
    JitHostSyncRule,
    JitTracedBranchRule,
    JitUnhashableStaticRule,
)
from .quorummath import StaleQuorumMathRule
from .serial import (
    CheckpointFieldCoverageRule,
    FormatVersionRatchetRule,
    PackUnpackParityRule,
)
from .snapshotadopt import UnverifiedSnapshotAdoptRule
from .walgossip import WalBeforeGossipRule

ALL_RULES = [
    JitTracedBranchRule(),
    JitHostSyncRule(),
    JitUnhashableStaticRule(),
    AwaitStateRaceRule(),
    AsyncioBlockingCallRule(),
    CodecOnLoopRule(),
    ChaosUnseededRandomRule(),
    ConsensusNondeterminismRule(),
    HeldGuardEscapeRule(),
    DrainBeforeValidateRule(),
    FalsyOrFallbackRule(),
    WalBeforeGossipRule(),
    UnverifiedSnapshotAdoptRule(),
    StaleQuorumMathRule(),
    DonateUseAfterFreeRule(),
    RecompileHazardRule(),
    PartitionSpecCoverageRule(),
    BytesModelCoverageRule(),
    UnboundedHostileInputRule(),
    EngineParityRule(),
    PackUnpackParityRule(),
    CheckpointFieldCoverageRule(),
    FormatVersionRatchetRule(),
]

RULE_NAMES = ({r.name for r in ALL_RULES}
              | {BAD_SUPPRESSION, PARSE_ERROR, STALE_SUPPRESSION})

__all__ = [
    "ALL_RULES",
    "RULE_NAMES",
    "ANALYSIS_VERSION",
    "BAD_SUPPRESSION",
    "PARSE_ERROR",
    "STALE_SUPPRESSION",
    "FileContext",
    "Finding",
    "ProjectContext",
    "Rule",
    "check_file",
    "run_paths",
    "run_paths_cached",
    "AsyncioBlockingCallRule",
    "AwaitStateRaceRule",
    "BytesModelCoverageRule",
    "CheckpointFieldCoverageRule",
    "CodecOnLoopRule",
    "ChaosUnseededRandomRule",
    "ConsensusNondeterminismRule",
    "DonateUseAfterFreeRule",
    "DrainBeforeValidateRule",
    "EngineParityRule",
    "FalsyOrFallbackRule",
    "FormatVersionRatchetRule",
    "HeldGuardEscapeRule",
    "JitHostSyncRule",
    "JitTracedBranchRule",
    "JitUnhashableStaticRule",
    "PackUnpackParityRule",
    "PartitionSpecCoverageRule",
    "RecompileHazardRule",
    "StaleQuorumMathRule",
    "UnboundedHostileInputRule",
    "UnverifiedSnapshotAdoptRule",
    "WalBeforeGossipRule",
]
