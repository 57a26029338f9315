"""Commit-lineage tracing: per-tx / per-event lifecycle ledgers.

The metrics registry says *how much* and the span tracer says *where
one cycle's time went on one node*; neither can answer the operator
question "where did THIS transaction's commit latency go, across the
fleet?".  This module is the third tier: every node records a bounded
ledger of lifecycle stage records keyed on the hashes consensus already
computes — the tx payload hash and the event id — so a fleet-wide
scrape can be JOINED on those keys into one cross-node timeline with
zero wire or consensus changes (stitching is read-side only; nothing
about event bodies, gossip frames or ordering is touched, which is what
keeps the ``consensus-nondeterminism`` invariant clean by
construction).

Stages (one record each, timestamped at the hook site):

- ``submit``  — the tx arrived at a node's ingress (proxy server)
- ``admit`` / ``shed`` — admission control's verdict
- ``pool``    — the tx entered the node's transaction pool
- ``mint``    — a self-event carrying the tx was created (the record
  links ``event=<event id>``, which is the hash-join pivot)
- ``ship``    — an event left this node in a push/pull response
- ``insert``  — an event was inserted into this node's DAG
- ``commit``  — the event reached consensus order on this node
- ``deliver`` — the tx was acked by this node's app

Clock model (same as spans.py): ``wall`` is epoch time for cross-node
alignment in a stitched trace, ``mono`` is ``time.monotonic()`` for
exact intra-node durations.  Wall-clock skew across nodes is the
operator's problem to note, not ours to hide — the stitcher reports
negative cross-node deltas as-is.

Bounded by construction: the recorder holds at most ``capacity`` keys
(LRU — an old tx's ledger falls off when new ones arrive) of at most
``per_key`` records each, and counts what it dropped so a scraper can
tell truncation from quiescence.  Stdlib-only like the rest of obs/.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from hashlib import sha256
from typing import Dict, List, Optional

#: canonical stage order — attribution milestones in lifecycle order
STAGES = (
    "submit", "admit", "shed", "pool", "mint", "ship", "insert",
    "commit", "deliver",
)

_STAGE_RANK = {s: i for i, s in enumerate(STAGES)}


def tx_id(tx: bytes) -> str:
    """The lineage key of a transaction payload: sha256 hex.  Clients
    that want to trace a tx compute this over the exact submitted
    bytes (``fleet trace`` accepts it directly)."""
    return sha256(tx).hexdigest()


class LineageRecorder:
    """Bounded per-key lifecycle ledger (see module docstring).  Safe
    from the event loop and worker threads; every mutation is a few
    instructions under one lock.  ``enabled=False`` turns every hook
    into a cheap no-op (the bench's tracing-overhead A/B switch)."""

    def __init__(self, capacity: int = 4096, per_key: int = 64,
                 enabled: bool = True):
        self.capacity = capacity
        self.per_key = per_key
        self.enabled = enabled
        #: wall time this recorder came up — a stitched trace whose
        #: earlier stages predate a node's boot renders that node's
        #: missing prefix as an explicit restart gap
        self.boot = time.time()
        self._lock = threading.Lock()
        self._keys: "OrderedDict[str, List[dict]]" = OrderedDict()
        self.dropped_keys = 0
        self.dropped_records = 0

    # ------------------------------------------------------------------
    # write side (hot-path hooks)

    def record(self, key: str, stage: str, **attrs) -> None:
        if not self.enabled:
            return
        rec = {"stage": stage, "wall": time.time(),
               "mono": time.monotonic()}
        if attrs:
            rec["attrs"] = attrs
        with self._lock:
            lst = self._keys.get(key)
            if lst is None:
                while len(self._keys) >= self.capacity:
                    self._keys.popitem(last=False)
                    self.dropped_keys += 1
                self._keys[key] = lst = []
            else:
                self._keys.move_to_end(key)
            if len(lst) >= self.per_key:
                self.dropped_records += 1
                return
            lst.append(rec)

    def note_tx(self, tx: bytes, stage: str, **attrs) -> None:
        # enabled check BEFORE the hash: a disabled recorder must not
        # charge a sha256 per tx per hook to the path it isn't tracing
        if not self.enabled:
            return
        self.record("tx:" + tx_id(tx), stage, **attrs)

    def note_event(self, ev_hex: str, stage: str, **attrs) -> None:
        self.record("ev:" + ev_hex, stage, **attrs)

    def note_mint(self, ev_hex: str, transactions) -> None:
        """One minted self-event: the event gets its ``mint`` record and
        every carried tx a ``mint`` record linking the event id — the
        pivot a cross-node stitch joins tx and event timelines on."""
        if not self.enabled:
            return
        self.record("ev:" + ev_hex, "mint", txs=len(transactions))
        for tx in transactions:
            self.record("tx:" + tx_id(tx), "mint", event=ev_hex)

    def note_commit(self, ev_hex: str, transactions, round_received=None):
        if not self.enabled:
            return
        at = {} if round_received is None else {"rr": int(round_received)}
        self.record("ev:" + ev_hex, "commit", **at)
        for tx in transactions:
            self.record("tx:" + tx_id(tx), "commit", event=ev_hex)

    # ------------------------------------------------------------------
    # read side (the /debug/lineage endpoint)

    def get(self, key: str) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._keys.get(key, ())]

    def lookup_tx(self, txid: str) -> dict:
        """Everything this node knows about one tx: its own records
        plus the full ledgers of every event its records link to."""
        tx_recs = self.get("tx:" + txid)
        events: Dict[str, List[dict]] = {}
        for r in tx_recs:
            ev = (r.get("attrs") or {}).get("event")
            if ev and ev not in events:
                events[ev] = self.get("ev:" + ev)
        return {"boot": self.boot, "txid": txid, "tx": tx_recs,
                "events": events}

    def stats(self) -> dict:
        with self._lock:
            return {
                "keys": len(self._keys),
                "capacity": self.capacity,
                "per_key": self.per_key,
                "dropped_keys": self.dropped_keys,
                "dropped_records": self.dropped_records,
                "enabled": self.enabled,
            }


# ----------------------------------------------------------------------
# fleet-side stitching (pure functions — unit-testable without a fleet)


def _dedup(records: List[dict]) -> List[dict]:
    """Hash-join discipline for duplicate delivery: the same (node,
    key, stage) may be recorded more than once (push + pull racing the
    same event into one node); the EARLIEST record wins — later ones
    are re-deliveries, not lifecycle progress."""
    best: Dict[tuple, dict] = {}
    for r in records:
        k = (r.get("node"), r.get("key"), r["stage"])
        cur = best.get(k)
        if cur is None or r["wall"] < cur["wall"]:
            best[k] = r
    return sorted(best.values(),
                  key=lambda r: (r["wall"], _STAGE_RANK.get(r["stage"], 99)))


def stitch(node_dumps: List[dict]) -> dict:
    """Join per-node ``lookup_tx`` dumps (each tagged ``node``) into
    one cross-node timeline with per-stage latency attribution.

    Returns ``{"txid", "timeline", "nodes", "stages", "attribution",
    "gaps"}`` where

    - ``timeline`` is every deduped record, wall-ordered, each tagged
      with its node and key kind;
    - ``attribution`` is the list of consecutive lifecycle milestone
      hops (earliest record per stage) with the seconds each hop ate —
      the "which hop ate the p99" answer;
    - ``gaps`` renders restarts explicitly: a node whose recorder
      booted AFTER the trace began lost whatever it recorded before
      the restart, and the stitch says so instead of presenting the
      survivor records as the whole story.
    """
    flat: List[dict] = []
    txid = None
    for dump in node_dumps:
        node = dump.get("node", "?")
        txid = txid or dump.get("txid")
        for r in dump.get("tx", ()):
            flat.append({**r, "node": node, "key": "tx"})
        for ev, recs in (dump.get("events") or {}).items():
            for r in recs:
                flat.append({**r, "node": node, "key": f"ev:{ev[:16]}"})
    timeline = _dedup(flat)
    if not timeline:
        return {"txid": txid, "timeline": [], "nodes": [], "stages": {},
                "attribution": [], "gaps": []}

    stages: Dict[str, int] = {}
    for r in timeline:
        stages[r["stage"]] = stages.get(r["stage"], 0) + 1

    # milestone per stage: the earliest record fleet-wide.  For
    # "insert" prefer the earliest on a node OTHER than the minting
    # node — the cross-node hop is what gossip latency means.
    first: Dict[str, dict] = {}
    for r in timeline:
        if r["stage"] not in first:
            first[r["stage"]] = r
    mint_node = first.get("mint", {}).get("node")
    if mint_node is not None:
        for r in timeline:
            if r["stage"] == "insert" and r["node"] != mint_node:
                first["insert"] = r
                break
    milestones = [first[s] for s in STAGES if s in first]
    attribution = []
    for a, b in zip(milestones, milestones[1:]):
        attribution.append({
            "from_stage": a["stage"], "to_stage": b["stage"],
            "from_node": a["node"], "to_node": b["node"],
            "seconds": b["wall"] - a["wall"],
        })

    t0 = timeline[0]["wall"]
    gaps = []
    for dump in node_dumps:
        boot = dump.get("boot")
        node = dump.get("node", "?")
        has_records = any(r["node"] == node for r in timeline)
        if boot is not None and has_records and boot > t0:
            # this node's recorder came up after the trace began: its
            # pre-restart records are gone — an explicit gap segment
            gaps.append({"node": node, "stage": "gap",
                         "from_wall": t0, "to_wall": boot})
    return {
        "txid": txid,
        "timeline": timeline,
        "nodes": sorted({r["node"] for r in timeline}),
        "stages": stages,
        "attribution": attribution,
        "gaps": gaps,
    }


def format_trace(st: dict) -> str:
    """Human rendering of a stitched trace (``fleet trace``)."""
    lines = [f"tx {st.get('txid') or '?'} — {len(st['timeline'])} records "
             f"across {len(st['nodes'])} nodes "
             f"({', '.join(str(n) for n in st['nodes'])})"]
    t0 = st["timeline"][0]["wall"] if st["timeline"] else 0.0
    for g in st["gaps"]:
        lines.append(
            f"  [gap] node {g['node']} restarted "
            f"{g['to_wall'] - g['from_wall']:+.3f}s into the trace — "
            "earlier records lost"
        )
    for r in st["timeline"]:
        attrs = r.get("attrs")
        extra = (" " + " ".join(f"{k}={v}" for k, v in attrs.items())
                 if attrs else "")
        lines.append(
            f"  +{r['wall'] - t0:8.3f}s  {str(r['node']):<22} "
            f"{r['stage']:<8} {r['key']}{extra}"
        )
    if st["attribution"]:
        lines.append("latency attribution:")
        total = sum(h["seconds"] for h in st["attribution"])
        for h in st["attribution"]:
            share = (100.0 * h["seconds"] / total) if total > 0 else 0.0
            lines.append(
                f"  {h['from_stage']:>7} → {h['to_stage']:<8} "
                f"{h['seconds']*1e3:9.1f} ms  ({share:4.1f}%)  "
                f"[{h['from_node']} → {h['to_node']}]"
            )
        lines.append(f"  {'total':>7} → {'':8} {total*1e3:9.1f} ms")
    return "\n".join(lines)
