"""Canned chaos scenarios — the regression suite for hostile networks.

Each is a plain dict (the JSON schema the ``chaos`` verb of the CLI
accepts from a file, README "Chaos testing"), so ``chaos show <name>``
doubles as schema-by-example.  Step counts are sized for the
deterministic in-memory runner on a CPU-only host; a seed sweep over
all of them is the ``slow``-marked chaos pytest tier.

The intentionally-broken demo is not canned: take ``fork-attack`` and
flip ``engine`` to ``"fused"`` (fork detection off) — the attack's
branches are rejected instead of detected and the ``fork_detected``
invariant fails loudly (tests/test_chaos_scenarios.py pins this).
"""

from __future__ import annotations

from typing import Dict

from .plan import Scenario

CANNED: Dict[str, dict] = {
    # every link is lossy, latent, duplicating and reordering at once —
    # the baseline "hostile but connected" network
    "flaky-link": {
        "name": "flaky-link",
        "nodes": 4, "steps": 240, "seed": 7,
        "txs": 20, "tx_every": 8,
        "invariants": ["prefix_agreement", "liveness", "all_committed"],
        "plan": {
            "default": {
                "drop": 0.12, "delay": 0.2, "delay_ms": [1, 4],
                "duplicate": 0.08, "reorder": 0.08, "reorder_ms": [1, 6],
            },
        },
    },
    # one node is cut from the supermajority for a third of the run;
    # the majority must keep committing, the minority must rejoin
    "minority-partition": {
        "name": "minority-partition",
        "nodes": 4, "steps": 320, "seed": 11,
        "txs": 16, "tx_every": 10, "liveness_bound": 120,
        "invariants": ["prefix_agreement", "liveness"],
        "plan": {
            "default": {"drop": 0.05},
            "partitions": [{"group": [3], "start": 60, "heal": 180}],
        },
    },
    # a node crashes and restarts HONEST (non-fork-aware), recovering
    # through the durability ladder: the runner gives every node a real
    # on-disk WAL, the crash drops the live engine, and the restart
    # replays the log to resume at its published head seq — no peer
    # ever reads it as an equivocator (this scenario ran fork-aware
    # before the WAL landed).  The crash predates propagation and the fleet's rolling
    # windows evict far past the outage, so the rejoin also exercises
    # the snapshot RPC (fast_forwarded).  Crashing at tick 0 still
    # matters for eviction: slot-prefix eviction retains every known
    # creator's last seq_window events, so a MID-life crash would wedge
    # the window at the silent creator's tail and no fast-forward could
    # ever trigger (the eviction wedge).
    "crash-restart": {
        "name": "crash-restart",
        "nodes": 4, "steps": 480, "seed": 13,
        "cache_size": 64, "seq_window": 8,
        "txs": 12, "tx_every": 12, "liveness_bound": 100,
        "invariants": ["prefix_agreement", "liveness", "fast_forwarded"],
        "plan": {
            "crashes": [{"node": 3, "crash": 0, "restart": 340}],
        },
    },
    # durable-state rot: a mid-life crash restarts into a checkpoint
    # with a flipped byte and a WAL with a torn tail.  The boot must
    # degrade (refuse the checkpoint, truncate the log at the damage,
    # defer minting behind the seq probe) and rejoin through gossip
    # without ever re-minting a published index — prefix agreement
    # holds across the rot.  cache_size is sized so nothing evicts:
    # the mid-life crash + eviction wedge interaction is not this
    # scenario's subject
    "disk-rot": {
        "name": "disk-rot",
        "nodes": 4, "steps": 360, "seed": 29,
        "cache_size": 2048,
        "txs": 12, "tx_every": 10, "liveness_bound": 120,
        "checkpoint_every": 40,
        "invariants": ["prefix_agreement", "liveness"],
        "plan": {
            "default": {"drop": 0.03},
            "crashes": [{"node": 2, "crash": 120, "restart": 200}],
            "disk": {"checkpoint_corrupt": 1.0, "wal_truncate": 1.0},
        },
    },
    # a fork-emitting peer plants equivocating branches at two honest
    # nodes; the fork-aware engine must detect it AND keep agreeing
    "fork-attack": {
        "name": "fork-attack",
        "nodes": 4, "steps": 160, "seed": 17,
        "engine": "byzantine",
        "txs": 12, "tx_every": 8,
        "invariants": ["prefix_agreement", "fork_detected", "liveness"],
        "plan": {
            "default": {"drop": 0.05},
            "byzantine": {"node": 3, "mode": "fork", "at": 30},
        },
    },
    # every link touching one node is slow in both directions — the
    # laggard must neither stall the fleet nor fall out of agreement
    "slow-peer": {
        "name": "slow-peer",
        "nodes": 4, "steps": 240, "seed": 19,
        "txs": 16, "tx_every": 10,
        "invariants": ["prefix_agreement", "liveness", "all_committed"],
        "plan": {
            "default": {"drop": 0.03},
            "overrides": [
                {"src": 2, "delay": 1.0, "delay_ms": [2, 6],
                 "drop": 0.03},
                {"dst": 2, "delay": 1.0, "delay_ms": [2, 6],
                 "drop": 0.03},
            ],
        },
    },
    # silent-peer survival: a peer goes down mid-life — after
    # its events propagated — and stays silent for hundreds of ticks.
    # Pre-PR this wedged eviction fleet-wide: the dead creator's
    # seq-window tail could never evict, the slot prefix could never
    # advance past it, and memory grew for the whole outage (the
    # eviction wedge).  With per-creator eviction the fleet
    # must (a) evict the silent creator's tail once it falls
    # inactive_rounds decided rounds behind (eviction_advanced: horizon
    # recorded AND live window bounded), and (b) bootstrap its return
    # through verified fast-forward + post-horizon chain continuation
    # (fast_forwarded + prefix agreement across the rejoin)
    "dead-creator": {
        "name": "dead-creator",
        "nodes": 4, "steps": 560, "seed": 31,
        "cache_size": 64, "seq_window": 8, "inactive_rounds": 8,
        "txs": 12, "tx_every": 10, "liveness_bound": 110,
        "invariants": ["prefix_agreement", "liveness", "fast_forwarded",
                       "eviction_advanced"],
        "plan": {
            "crashes": [{"node": 3, "crash": 60, "restart": 430}],
        },
    },
    # byzantine bootstrap peer (FAST'18 protocol-aware
    # recovery): node 1 answers fast-forward requests with a DOCTORED
    # snapshot — committed history rewritten, digest recomputed
    # self-consistently, proof re-signed under its own key.  The
    # restarted joiner is steered at the forger first (deterministic
    # encounter), must refuse the forgery on the attestation quorum
    # (ff_proof_rejected) and still catch up through an honest peer
    # (fast_forwarded + prefix agreement)
    "forged-snapshot": {
        "name": "forged-snapshot",
        "nodes": 4, "steps": 520, "seed": 37,
        "cache_size": 64, "seq_window": 8, "inactive_rounds": 8,
        "txs": 12, "tx_every": 10, "liveness_bound": 110,
        "invariants": ["prefix_agreement", "liveness", "fast_forwarded",
                       "ff_proof_rejected"],
        "plan": {
            "crashes": [{"node": 3, "crash": 50, "restart": 400}],
            "byzantine": {"node": 1, "mode": "forge_snapshot", "at": 0},
        },
    },
    # membership plane: a 4-node fleet GROWS to 5 and
    # SHRINKS back to 4 under live client load.  The joiner boots as
    # an observer at tick 60, its signed join tx is ordered like any
    # transaction, every node applies the transition at the same
    # decided-round boundary (epoch_agreement), the engine re-shapes
    # [*,4,4] -> [*,5,5] and the joiner mints from the boundary on;
    # at tick 230 founder 3 announces its leave and the quorum math
    # tightens to the 4-member active set — with prefix agreement
    # intact across BOTH epochs and every submitted tx committing
    "join-under-load": {
        "name": "join-under-load",
        "nodes": 4, "steps": 400, "seed": 41, "joiners": 1,
        "txs": 24, "tx_every": 6,
        "invariants": ["prefix_agreement", "liveness", "all_committed",
                       "epoch_agreement"],
        "plan": {
            "default": {"drop": 0.05},
            "joins": [{"tick": 60, "node": 4, "via": 0}],
            "leaves": [{"tick": 230, "node": 3, "via": 0}],
        },
    },
    # a validator announces its leave while ANOTHER node is down: the
    # transition must still order, apply at the same boundary on every
    # live node (epoch_agreement), tighten the quorum math to the
    # 3-member active set, and keep committing once the crashed node
    # returns and catches up across the epoch boundary
    "leave-mid-outage": {
        "name": "leave-mid-outage",
        "nodes": 4, "steps": 420, "seed": 43,
        "txs": 16, "tx_every": 10, "liveness_bound": 140,
        "invariants": ["prefix_agreement", "liveness",
                       "epoch_agreement"],
        "plan": {
            "crashes": [{"node": 2, "crash": 80, "restart": 200}],
            "leaves": [{"tick": 100, "node": 3, "via": 0}],
        },
    },
    # a join is ordered while a founder sits on the wrong side of a
    # partition: the cut node must apply the SAME boundary from the
    # replayed history after healing (the straggler round-rescan path —
    # old-epoch rounds keep old-epoch thresholds via the per-round sm
    # array), and the whole 5-node fleet converges on one ledger
    "join-under-partition": {
        "name": "join-under-partition",
        "nodes": 4, "steps": 400, "seed": 47, "joiners": 1,
        "txs": 16, "tx_every": 10, "liveness_bound": 140,
        "invariants": ["prefix_agreement", "liveness",
                       "epoch_agreement"],
        "plan": {
            "default": {"drop": 0.03},
            "partitions": [{"group": [3], "start": 50, "heal": 170}],
            "joins": [{"tick": 60, "node": 4, "via": 0}],
        },
    },
    # adversarial time, first slice: every node's
    # claimed-timestamp clock drifts by a bounded per-node offset from
    # the injector's seeded stream.  The committed order must be
    # IDENTICAL to the drift-free twin run (skew_robust_order): median
    # consensus timestamps absorb bounded per-creator skew
    "clock-skew": {
        "name": "clock-skew",
        "nodes": 4, "steps": 240, "seed": 53,
        "txs": 16, "tx_every": 8,
        "invariants": ["prefix_agreement", "liveness", "all_committed",
                       "skew_robust_order"],
        "plan": {
            "default": {"drop": 0.05},
            "clock_skew": {"max_ms": 0.4},
        },
    },
    # adversarial time, second slice: one
    # byzantine creator CLAIMS extreme timestamps (±up to an hour, far
    # outside any honest clamp window) on half its mints.  Consensus
    # timestamps are creator-claimed medians, so without the
    # insert-time clamp (core/dag.py TS_CLAMP_WINDOW_NS) this skews
    # round-received medians and permutes the committed order.  The
    # skew_robust_order invariant runs the honest-time twin (same
    # scenario, actor removed) and asserts no strictly-(rr, cts)-
    # ordered honest pair was reordered — the n/3-liar claim, checked
    # differentially.
    "lying-ts": {
        "name": "lying-ts",
        "nodes": 4, "steps": 240, "seed": 61,
        "txs": 16, "tx_every": 8,
        "invariants": ["prefix_agreement", "liveness", "all_committed",
                       "skew_robust_order"],
        "plan": {
            "default": {"drop": 0.05},
            "byzantine": {"node": 1, "mode": "lying_ts",
                          "at": 10, "prob": 0.5},
        },
    },
    # WAN-shaped links: every link carries a
    # token-bucket bandwidth cap with size-proportional serialization
    # delay plus Gilbert–Elliott burst loss, and one directed pair is
    # a thin transcontinental hop — the instrument that lets one host
    # emulate WAN topology honestly.  The fleet must keep committing
    # and agreeing through bursty loss and bandwidth queueing.
    "wan-lossy": {
        "name": "wan-lossy",
        "nodes": 4, "steps": 280, "seed": 59,
        "txs": 16, "tx_every": 10, "liveness_bound": 140,
        "invariants": ["prefix_agreement", "liveness", "all_committed"],
        "plan": {
            "default": {
                "bw_kbps": 8000, "bw_burst_kb": 32,
                "ge_p_gb": 0.04, "ge_p_bg": 0.35,
                "ge_drop_good": 0.01, "ge_drop_bad": 0.85,
                "delay": 0.15, "delay_ms": [1, 4],
            },
            "overrides": [
                {"src": 0, "dst": 3, "bw_kbps": 1500, "bw_burst_kb": 16,
                 "ge_p_gb": 0.08, "ge_p_bg": 0.3,
                 "ge_drop_good": 0.02, "ge_drop_bad": 0.9,
                 "delay": 0.3, "delay_ms": [2, 6]},
                {"src": 3, "dst": 0, "bw_kbps": 1500, "bw_burst_kb": 16,
                 "ge_p_gb": 0.08, "ge_p_bg": 0.3,
                 "ge_drop_good": 0.02, "ge_drop_bad": 0.9,
                 "delay": 0.3, "delay_ms": [2, 6]},
            ],
        },
    },
    # a stale-sync replayer answers a sampled fraction of inbound syncs
    # with cached old state; dedup-by-hash must shrug it off
    "stale-replay": {
        "name": "stale-replay",
        "nodes": 4, "steps": 240, "seed": 23,
        "txs": 16, "tx_every": 10,
        "invariants": ["prefix_agreement", "liveness", "all_committed"],
        "plan": {
            "default": {"drop": 0.05},
            "byzantine": {"node": 1, "mode": "stale_replay",
                          "at": 20, "prob": 0.4},
        },
    },
}


def canned_names() -> list:
    return sorted(CANNED)


def load_scenario(name_or_path: str) -> Scenario:
    """A canned scenario by name, or any scenario JSON file by path."""
    if name_or_path in CANNED:
        return Scenario.from_dict(CANNED[name_or_path])
    return Scenario.from_json_file(name_or_path)
