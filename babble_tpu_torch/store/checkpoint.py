"""Checkpoint / resume of the engine's consensus state (the port's copy
of the JAX package's ``store/checkpoint.py``, fused engine).

A checkpoint captures
- the host DAG window (full signed events plus the per-slot index arrays
  — levels, parent slots, wire coordinates — so restore is a direct
  reconstruction, not a replay that would need evicted ancestors),
- the consensus log window, the commit bookkeeping and the epoch ledger,
- the dense state tensors (DagState, with the rolling-window offsets).

Layout: ``<dir>/meta.msgpack`` + ``<dir>/device.npz``, the JAX package's
FORMAT v6 bytes: the meta is byte-equal to the JAX package's for the
same engine state (the port's own msgpack, ``codec.py``), and the npz
holds the same arrays in the same dtypes, so a checkpoint written by
either package restores in the other.  Restore reads v2–v6 with the same
version gate and backfills.  Writes go to a temporary directory swapped
in atomically.  ``snapshot_bytes``/``load_snapshot`` are the same state
as one msgpack pair ``[meta, npz]`` (the fast-forward payload), checked
against hostile input before any array is materialised.

Byzantine (``ForkHashgraph``) and wide (``WideHashgraph``) checkpoints
wait for their engines (ROADMAP.md Queue 1, items 7 and 8).  Entry
points restore onto ``device`` ("cuda" unless the caller asks for the
CPU).
"""

from __future__ import annotations

import io
import os
import shutil
import tempfile
from typing import Callable, Dict, Optional

import numpy as np

from ..codec import packb, unpack_pair, unpackb
from ..common import OffsetList
from ..consensus.digest import CommitDigest
from ..consensus.engine import MEMBERSHIP_QUEUE_MAX, TorchHashgraph
from ..core.event import Event, FullWireEvent
from ..membership.epoch import MAX_LOG, check_log_entry
from ..membership.transition import parse_membership_tx
from ..ops.state import (
    DagConfig, DagState, config_from_fields, coord8_ok, coord16_ok,
    repack_round_bits_np, state_from_numpy, state_to_numpy,
)

#: v4 added the membership plane (cfg ``retired``, the ``sm`` array, the
#: epoch ledger), v5 the ``packed`` cfg flag and the ``mbr``/``fmr``
#: planes (re-packed on every restore, never trusted), v6 the attestation
#: anchor ring.  Readers restore v2–v6; older readers refuse v6.
FORMAT_VERSION = 6
_READABLE = (2, 3, 4, 5, FORMAT_VERSION)

_META = "meta.msgpack"
_DEVICE = "device.npz"

NOT_PORTED_BYZANTINE = (
    "byzantine (ForkHashgraph) checkpoints are not ported yet (ROADMAP.md "
    "Queue 1, item 7: the byzantine pair)"
)
NOT_PORTED_WIDE = (
    "wide (WideHashgraph) checkpoints are not ported yet (ROADMAP.md "
    "Queue 1, item 8: the wide-N engine)"
)


def _pack_event(ev: Event) -> list:
    """Full self-contained encoding (parent hashes): the byte format is
    FullWireEvent's."""
    return FullWireEvent.from_event(ev).pack()


def _unpack_event(obj: list) -> Event:
    return FullWireEvent.unpack(obj).to_event()


def _scalar_out(v: int) -> bytes:
    """256-bit ECDSA scalar as a 32-byte big-endian blob (msgpack ints
    cap at 64 bits)."""
    return int(v).to_bytes(32, "big")


def _scalar_in(v) -> int:
    return int.from_bytes(v, "big") if isinstance(v, (bytes, bytearray)) \
        else int(v)


def _build_meta(engine: TorchHashgraph, anchors=None) -> dict:
    dag = engine.dag
    return {
        "version": FORMAT_VERSION,
        "participants": sorted(engine.participants.items()),
        "cfg": list(engine.cfg),
        "verify_signatures": dag.verify_signatures,
        "policy": [
            engine.auto_compact, engine.seq_window, engine.round_margin,
            engine.compact_min, engine.consensus_window,
            engine.inactive_rounds,
        ],
        # per-creator eviction horizons: the (index, hex)
        # anchor a creator's post-eviction chain continuation resumes
        # from — first-class state, not re-derivable from the window
        "evicted_heads": sorted(
            [cid, idx, hx] for cid, (idx, hx) in dag.evicted_heads.items()
        ),
        # rolling commit digest (verified fast-forward): the attestable
        # frontier + its window anchor must survive restart or a
        # resumed responder could neither attest nor serve proofs
        "digest": engine._digest.to_meta(),
        # membership plane: the epoch ledger.  The log's embedded signed
        # transitions are what lets a fast-forward joiner verify a peer
        # set it has never seen against its trusted bootstrap set; the
        # pending entry keeps a mid-transition crash consistent.
        "epoch": engine.epoch,
        "membership_log": [dict(e) for e in engine.membership_log],
        "pending_membership": (
            dict(engine.pending_membership)
            if engine.pending_membership else None
        ),
        # pipelined membership: transitions queued behind the pending
        # boundary (FIFO; each re-checked like the pending entry)
        "membership_queue": [
            dict(e) for e in engine.membership_queue
        ],
        # bounded membership_log: the truncation base + the gossip
        # addresses of members whose join entries were truncated
        "membership_base_epoch": engine.membership_base_epoch,
        "membership_addrs": sorted(engine.membership_addrs.items()),
        # adversarial-ts defense: effective-timestamp overrides — the
        # (window-local slot, clamped ns) pairs where the clamp fired.
        # Honest fleets serialize an empty list; future inserts' clamp
        # windows derive from these, so they are first-class state.
        "ts_clamped": [
            [i, int(dag.eff_ts[dag.slot_base + i])]
            for i in range(dag.n_events - dag.slot_base)
            if dag.eff_ts[dag.slot_base + i]
            != dag.events[dag.slot_base + i].body.timestamp
        ],
        "slot_base": dag.slot_base,
        "events": [_pack_event(ev) for ev in dag.events],  # window, slot order
        "levels": list(dag.levels),
        "sp_slot": list(dag.sp_slot),
        "op_slot": list(dag.op_slot),
        "wire_meta": [list(m) for m in dag.wire_meta],
        "chains": [[c.start, list(c)] for c in dag.chains],
        "consensus": [engine.consensus.start, list(engine.consensus)],
        "consensus_transactions": engine.consensus_transactions,
        "last_committed_round_events": engine.last_committed_round_events,
        "ordered_total": engine._ordered_total,
        "received": sorted(engine._received),
        # attestation anchor ring (v6): the quorum-signed checkpoint
        # proofs the node serves to verified-fast-forward joiners.
        # Node passes its ring on local checkpoints; the fast-forward
        # snapshot payload serializes an empty ring (a joiner must not
        # adopt a responder's proof inventory as its own).  Signature
        # scalars ride as 32-byte blobs, never raw msgpack ints.
        "anchors": [
            [a["position"], a["digest"], a["epoch"],
             [[p, _scalar_out(r), _scalar_out(s)] for p, r, s in a["sigs"]]]
            for a in (anchors or [])
        ],
    }


def _build_arrays(engine: TorchHashgraph) -> Dict[str, np.ndarray]:
    """Host copies of every DagState field, in the JAX package's dtypes."""
    return state_to_numpy(engine.state)._asdict()


def engine_mode(engine) -> str:
    """Checkpoint dispatch key: "fused" for ``TorchHashgraph`` (the
    byzantine and wide engines are not ported)."""
    if isinstance(engine, TorchHashgraph):
        return "fused"
    raise NotImplementedError(
        f"no checkpoint for {type(engine).__name__}: {NOT_PORTED_BYZANTINE}"
        f"; {NOT_PORTED_WIDE}"
    )


def save_checkpoint(engine, path: str, anchors=None) -> None:
    """Write a consistent snapshot of ``engine`` to directory ``path``
    (every inserted event flushed first).  ``anchors`` is the node's
    attestation anchor ring (v6 meta); engine-only callers omit it."""
    engine_mode(engine)
    engine.flush()
    meta = _build_meta(engine, anchors)
    arrays = _build_arrays(engine)
    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(path)) or ".")
    try:
        with open(os.path.join(tmp, _META), "wb") as f:
            f.write(packb(meta))
        np.savez_compressed(os.path.join(tmp, _DEVICE), **arrays)
        if os.path.isdir(path):
            old = path + ".old"
            os.rename(path, old)
            os.rename(tmp, path)
            shutil.rmtree(old)
        else:
            os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def snapshot_bytes(engine) -> bytes:
    """A consistent snapshot as bytes — the fast-forward payload: the
    msgpack pair [meta, compressed npz] (its anchor ring empty)."""
    engine_mode(engine)
    engine.flush()
    meta, arrays = _build_meta(engine), _build_arrays(engine)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return packb([packb(meta), buf.getvalue()])


def _check_consensus_log(cons, wrapped: bool) -> None:
    """Bounds for the serialized consensus order: host meta wraps it as
    ``[start, items]`` (OffsetList), fork meta serializes the flat
    window list.  Entries are event-hash hex strings; both the count
    and each string's length bound the restore's allocation."""
    if wrapped:
        if not isinstance(cons, (list, tuple)) or len(cons) != 2:
            raise ValueError("snapshot consensus log malformed")
        start, items = cons
        if not isinstance(start, int) or not (0 <= start <= 1 << 48):
            raise ValueError(
                f"snapshot consensus start {start!r} out of bounds"
            )
    else:
        items = cons
    if not isinstance(items, (list, tuple)) or len(items) > 1 << 20:
        raise ValueError("snapshot consensus log out of bounds")
    for h in items:
        if not isinstance(h, str) or not (8 <= len(h) <= 128):
            raise ValueError("snapshot consensus entry malformed")


def _check_received(received, slots: bool = True) -> None:
    """The already-ordered set that seeds ``_received`` and every
    future dedup comparison.  The fused/wide engines track GLOBAL
    SLOTS (ints); the fork engine tracks event-hash hex strings
    (slots are ambiguous under equivocation) — ``slots`` selects the
    shape, both bounded before they allocate."""
    if not isinstance(received, (list, tuple)) or len(received) > 1 << 20:
        raise ValueError("snapshot received set out of bounds")
    for v in received:
        if slots:
            if not isinstance(v, int) or not (0 <= v <= 1 << 48):
                raise ValueError(
                    f"snapshot received slot {v!r} out of bounds"
                )
        elif not isinstance(v, str) or not (8 <= len(v) <= 128):
            raise ValueError("snapshot received hash out of bounds")


def _check_pending_entry(pend, label: str) -> None:
    """Structural + signature bounds for one serialized in-flight
    membership transition (the pending entry or a queued one)."""
    if pend is None:
        return
    if not isinstance(pend, dict):
        raise ValueError(f"snapshot {label} malformed")
    for key, typ in (("kind", str), ("pub", str), ("addr", str),
                     ("boundary", int), ("position", int)):
        if not isinstance(pend.get(key), typ):
            raise ValueError(
                f"snapshot {label} field {key} malformed"
            )
    tx = pend.get("tx")
    if not isinstance(tx, (bytes, bytearray)) or len(tx) > 4096:
        raise ValueError(f"snapshot {label} tx malformed")
    spec = parse_membership_tx(bytes(tx))
    if spec is None or (spec.kind, spec.pub_hex, spec.net_addr) != (
            pend["kind"], pend["pub"], pend["addr"]):
        raise ValueError(
            f"snapshot {label} contradicts its signed tx"
        )
    if not spec.verify():
        raise ValueError(
            f"snapshot {label} tx has a bad subject signature"
        )


def _check_host_meta(meta: dict) -> None:
    """Hostile-snapshot bounds for the host fields on the fused/wide
    path (the byzantine twin is not ported):
    eviction horizons must be per-creator unique, in participant range
    and strictly below the declared chain windows, and the serialized
    commit digest must pass CommitDigest.check_meta — all before any
    object is built from the snapshot."""
    n = len(meta["participants"])
    # 6th policy entry (inactive_rounds): the override normally masks
    # it, but local-checkpoint restores and absent override keys fall
    # back here — a hostile value must not freeze the window (huge) or
    # TypeError inside maybe_compact (non-int)
    if len(meta["policy"]) > 5:
        ir = meta["policy"][5]
        if ir is not None and (
                not isinstance(ir, int) or not (0 <= ir <= 1 << 20)):
            raise ValueError(
                f"snapshot policy inactive_rounds={ir!r} out of bounds"
            )
    heads = meta.get("evicted_heads", [])
    if not isinstance(heads, (list, tuple)) or len(heads) > n:
        raise ValueError("snapshot evicted_heads out of bounds")
    seen = set()
    chains = meta["chains"]
    for item in heads:
        cid, idx, hx = item
        if not isinstance(cid, int) or not (0 <= cid < n) or cid in seen:
            raise ValueError(
                f"snapshot evicted_heads creator {cid!r} out of range"
            )
        seen.add(cid)
        if not isinstance(idx, int) or not (0 <= idx <= 1 << 48):
            raise ValueError(
                f"snapshot evicted_heads index {idx!r} out of bounds"
            )
        if not isinstance(hx, str) or not (8 <= len(hx) <= 128):
            raise ValueError("snapshot evicted_heads hash malformed")
        # the horizon names an EVICTED event: it must sit strictly
        # below that creator's declared chain window, or a hostile
        # snapshot could shadow a live event with a forged horizon
        if cid < len(chains) and idx >= int(chains[cid][0]):
            raise ValueError(
                f"snapshot evicted_heads[{cid}]={idx} not below the "
                f"chain window start {chains[cid][0]}"
            )
    CommitDigest.check_meta(meta.get("digest"))
    # membership plane (v4): epoch ledger bounds.  The chain-of-custody
    # verification itself (signatures, set derivation) happens in
    # node.validate_ff_snapshot via membership.epoch — here only the
    # cheap structural rejection before any object is built.
    epoch = meta.get("epoch", 0)
    if not isinstance(epoch, int) or not (0 <= epoch <= 1 << 32):
        raise ValueError(f"snapshot epoch={epoch!r} out of bounds")
    log = meta.get("membership_log", [])
    if not isinstance(log, list) or len(log) > MAX_LOG:
        raise ValueError("snapshot membership log out of bounds")
    for entry in log:
        err = check_log_entry(entry)
        if err is not None:
            raise ValueError(f"snapshot {err}")
    if len(log) > epoch:
        raise ValueError(
            f"snapshot membership log ({len(log)} entries) longer than "
            f"its epoch {epoch}"
        )
    # the pending transition (and everything queued behind it) is
    # CONSUMED by apply_epoch_transition at its boundary — without
    # re-verifying the embedded signed txs here, a byzantine responder
    # could smuggle a validator join nobody signed (or an unauthorized
    # leave) through an otherwise genuine, quorum-attested snapshot
    _check_pending_entry(meta.get("pending_membership"),
                         "pending_membership")
    queue = meta.get("membership_queue", [])
    if not isinstance(queue, list) or len(queue) > MEMBERSHIP_QUEUE_MAX:
        raise ValueError("snapshot membership_queue out of bounds")
    for q in queue:
        if q is None:
            raise ValueError("snapshot membership_queue entry malformed")
        _check_pending_entry(q, "membership_queue entry")
    base = meta.get("membership_base_epoch", 0)
    if not isinstance(base, int) or not (0 <= base <= epoch):
        raise ValueError(
            f"snapshot membership_base_epoch={base!r} out of bounds"
        )
    addrs = meta.get("membership_addrs", [])
    if not isinstance(addrs, (list, tuple)) or len(addrs) > n:
        raise ValueError("snapshot membership_addrs out of bounds")
    for item in addrs:
        pub, addr = item
        if not isinstance(pub, str) or not (8 <= len(pub) <= 256) \
                or not isinstance(addr, str) or len(addr) > 256:
            raise ValueError("snapshot membership_addrs entry malformed")
    clamped = meta.get("ts_clamped", [])
    n_events = len(meta["events"])
    if not isinstance(clamped, (list, tuple)) or len(clamped) > n_events:
        raise ValueError("snapshot ts_clamped out of bounds")
    for item in clamped:
        i, eff = item
        # int64-exact bound: 2**63 itself does not fit the np.int64
        # batch arrays and would OverflowError the adopting node's
        # next flush — exactly the hostile DoS this check exists for
        if not isinstance(i, int) or not (0 <= i < n_events) \
                or not isinstance(eff, int) \
                or not (-(1 << 63) <= eff < (1 << 63)):
            raise ValueError("snapshot ts_clamped entry malformed")
    # retired columns (cfg field 9) must name real, unique columns
    cfg_fields = meta.get("cfg", [])
    retired = cfg_fields[8] if len(cfg_fields) > 8 else ()
    if retired:
        if (not isinstance(retired, (list, tuple))
                or len(set(retired)) != len(retired)
                or any(not isinstance(c, int) or not (0 <= c < n)
                       for c in retired)):
            raise ValueError(
                f"snapshot retired columns {retired!r} out of bounds"
            )
    # format header + engine-mode tag (the byzantine twin never reaches
    # this checker; load_snapshot dispatched it to _check_fork_meta)
    ver = meta["version"]
    if not isinstance(ver, int) or not (0 <= ver <= 1 << 16):
        raise ValueError(f"snapshot version {ver!r} out of bounds")
    if not isinstance(meta["verify_signatures"], bool):
        raise ValueError("snapshot verify_signatures is not a bool")
    mode = meta.get("mode")
    if mode not in (None, "wide"):
        raise ValueError(f"snapshot mode {mode!r} unknown")
    if mode == "wide":
        nb = meta["n_blocks"]
        if not isinstance(nb, int) or not (1 <= nb <= 1 << 16):
            raise ValueError(f"snapshot n_blocks={nb!r} out of bounds")
        if not isinstance(meta.get("has_carry", False), bool):
            raise ValueError("snapshot has_carry is not a bool")
    # window geometry: slot_base anchors every OffsetList the restore
    # builds, and the per-slot tables must all match the window length
    # (the npz twin of this check, _peek_npz_layout, never sees them)
    base = meta["slot_base"]
    if not isinstance(base, int) or not (0 <= base <= 1 << 48):
        raise ValueError(f"snapshot slot_base={base!r} out of bounds")
    for name in ("levels", "sp_slot", "op_slot", "wire_meta"):
        if len(meta[name]) != n_events:
            raise ValueError(
                f"snapshot field {name} has {len(meta[name])} entries, "
                f"expected {n_events}"
            )
    top = base + n_events
    for lvl in meta["levels"]:
        if not isinstance(lvl, int) or not (0 <= lvl <= 1 << 24):
            raise ValueError(f"snapshot level {lvl!r} out of bounds")
    for v in meta["sp_slot"] + meta["op_slot"]:
        # absolute slots on the host path (OffsetList-based), unlike
        # the window-relative fork encoding
        if not isinstance(v, int) or not (-1 <= v < max(top, 1)):
            raise ValueError(f"snapshot parent slot {v!r} out of range")
    for m in meta["wire_meta"]:
        if not isinstance(m, (list, tuple)) or len(m) > 16:
            raise ValueError("snapshot wire_meta entry malformed")
    _check_consensus_log(meta["consensus"], wrapped=True)
    for name, hi in (("consensus_transactions", 1 << 48),
                     ("last_committed_round_events", 1 << 32),
                     ("ordered_total", 1 << 48)):
        v = meta[name]
        if not isinstance(v, int) or not (0 <= v <= hi):
            raise ValueError(f"snapshot {name}={v!r} out of bounds")
    _check_received(meta["received"])
    # attestation anchor ring (v6; absent pre-v6): positions/epochs are
    # offsets into histories the node will serve proofs against, and
    # signature scalars are 32-byte blobs (or legacy ints) — all sized
    # before Node seeds its ring from them
    anchors = meta.get("anchors", [])
    if not isinstance(anchors, (list, tuple)) or len(anchors) > 64:
        raise ValueError("snapshot anchors out of bounds")
    for a in anchors:
        if not isinstance(a, (list, tuple)) or len(a) != 4:
            raise ValueError("snapshot anchor entry malformed")
        pos, dig, ep, sigs = a
        if not isinstance(pos, int) or not (0 <= pos <= 1 << 48) \
                or not isinstance(dig, str) or not (8 <= len(dig) <= 128) \
                or not isinstance(ep, int) or not (0 <= ep <= 1 << 32):
            raise ValueError("snapshot anchor entry malformed")
        if not isinstance(sigs, (list, tuple)) or len(sigs) > 256:
            raise ValueError("snapshot anchor signatures out of bounds")
        for s in sigs:
            if not isinstance(s, (list, tuple)) or len(s) != 3:
                raise ValueError("snapshot anchor signature malformed")
            pub, r, sv = s
            if not isinstance(pub, str) or not (8 <= len(pub) <= 256):
                raise ValueError("snapshot anchor signer malformed")
            for scalar in (r, sv):
                if isinstance(scalar, (bytes, bytearray)):
                    if len(scalar) > 32:
                        raise ValueError(
                            "snapshot anchor scalar out of bounds"
                        )
                elif not isinstance(scalar, int) \
                        or not (0 <= scalar < 1 << 256):
                    raise ValueError(
                        "snapshot anchor scalar out of bounds"
                    )


def _pol(policy: dict, key: str, snap_val):
    """Policy override with a None sentinel, shared by every restore
    path: an explicit falsy value (``seq_window=0``) is real
    configuration and must be honored; only an absent key or an
    explicit ``None`` falls back to the snapshot's value.  Never use
    ``policy.get(k, snap) or snap`` here (babble-lint
    falsy-or-fallback — the historical checkpoint.py bug class)."""
    v = policy.get(key, snap_val)
    return snap_val if v is None else v


def _expected_layout(cfg: DagConfig) -> Dict[str, tuple]:
    """(shape, dtype) of every DagState field for capacity cfg, as numpy
    dtypes (the npz's) — mirrors init_state without allocating."""
    e1, n, s1, r1 = cfg.e_cap + 1, cfg.n, cfg.s_cap + 1, cfg.r_cap + 1
    i32, i64 = np.dtype(np.int32), np.dtype(np.int64)
    b, i8 = np.dtype(np.bool_), np.dtype(np.int8)
    cd = np.dtype({1: np.int8, 2: np.int16, 4: np.int32}[
        cfg.coord_dtype.itemsize])
    ev, sc = (e1,), ()
    return {
        "sp": (ev, i32), "op": (ev, i32), "creator": (ev, i32),
        "seq": (ev, i32), "ts": (ev, i64), "mbit": (ev, b),
        "la": ((e1, n), cd),
        "fd": ((e1, n), cd),
        "round": (ev, i32), "witness": (ev, b), "rr": (ev, i32),
        "cts": (ev, i64),
        "ce": ((n + 1, s1), i32), "cnt": ((n + 1,), i32),
        "wslot": ((r1, n), i32), "famous": ((r1, n), i8),
        "sm": ((r1,), i32),
        "mbr": ((r1, cfg.lp), np.dtype(np.uint8)),
        "fmr": ((r1, cfg.lp), np.dtype(np.uint8)),
        "n_events": (sc, i32), "max_round": (sc, i32), "lcr": (sc, i32),
        "e_off": (sc, i32), "s_off": ((n + 1,), i32), "r_off": (sc, i32),
    }


def _peek_npz_layout(z) -> Dict[str, tuple]:
    """Read each member's (shape, dtype) from its npy header WITHOUT
    decompressing the payload — a zlib-bombed snapshot must be rejected
    before its arrays are materialized."""
    out = {}
    for name in z.files:
        with z.zip.open(name + ".npy") as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, _, dtype = np.lib.format.read_array_header_1_0(f)
            else:
                shape, _, dtype = np.lib.format.read_array_header_2_0(f)
        out[name] = (shape, dtype)
    return out


def load_snapshot(
    data: bytes,
    commit_callback: Optional[Callable] = None,
    verify_events: bool = True,
    policy: Optional[dict] = None,
    expected_participants: Optional[Dict[str, int]] = None,
    max_caps: Optional[tuple] = None,
    max_participants: Optional[int] = None,
    device="cuda",
) -> TorchHashgraph:
    """Reconstruct an engine from snapshot bytes (the fast-forward
    bootstrap).  The snapshot comes from a peer: every event signature
    in the window is re-verified by default, and the local ``policy``
    knobs (verify_signatures, auto_compact, seq_window, compact_min,
    consensus_window, round_margin, inactive_rounds) override the
    serialised ones.  ``expected_participants``, ``max_participants``
    and ``max_caps`` (``(max_e, max_s, max_r)``) are enforced on the
    declared meta before any array is materialised, and the npy headers
    are checked against the declared config before decompression."""
    meta_b, npz_b = unpack_pair(data)
    meta = unpackb(meta_b)
    participants = {k: int(v) for k, v in meta["participants"]}
    if expected_participants is not None and participants != expected_participants:
        raise ValueError(
            "snapshot participant set does not match local peers "
            f"({len(participants)} vs {len(expected_participants)} entries)"
        )
    if max_participants is not None and len(participants) > max_participants:
        raise ValueError(
            f"snapshot declares {len(participants)} participants, "
            f"bound {max_participants}"
        )
    if meta.get("mode") == "byzantine":
        raise NotImplementedError(NOT_PORTED_BYZANTINE)
    _check_host_meta(meta)
    if meta.get("mode") == "wide":
        raise NotImplementedError(NOT_PORTED_WIDE)
    cfg = config_from_fields(meta["cfg"])
    if max_caps is not None:
        max_e, max_s, max_r = max_caps
        if cfg.e_cap > max_e or cfg.s_cap > max_s or cfg.r_cap > max_r:
            raise ValueError(f"snapshot capacities out of bounds: {cfg}")
    expected = _expected_layout(cfg)
    with np.load(io.BytesIO(npz_b)) as z:
        layout = _peek_npz_layout(z)
        for name in expected:
            if name not in layout:
                # pre-v4: no per-round threshold array (uniform at epoch
                # 0, so the backfill is exact); pre-v5: no packed planes
                if name == "sm" and meta["version"] < 4:
                    continue
                if name in ("mbr", "fmr") and meta["version"] < 5:
                    continue
                raise ValueError(f"snapshot missing array {name}")
            shape, dtype = layout[name]
            eshape, edtype = expected[name]
            if shape != eshape or dtype != edtype:
                raise ValueError(
                    f"snapshot array {name} is {dtype}{shape}, declared "
                    f"cfg implies {edtype}{eshape}"
                )
        arrays = {name: z[name] for name in expected if name in layout}
    _backfill_sm(arrays, cfg)
    _backfill_packed(arrays, cfg)
    engine = _restore_engine(meta, arrays, commit_callback, policy, device)
    if verify_events:
        for ev in engine.dag.events:
            if not ev.verify():
                raise ValueError(
                    f"snapshot event {ev.hex()[:18]}… has a bad signature"
                )
    return engine


def _backfill_sm(arrays: Dict[str, np.ndarray], cfg: DagConfig) -> None:
    """Pre-v4 state carries no per-round threshold array; epoch-0
    thresholds are uniform, so a constant backfill is exact."""
    if "sm" not in arrays:
        arrays["sm"] = np.full((cfg.r_cap + 1,), cfg.super_majority,
                               np.int32)


def _backfill_packed(arrays: Dict[str, np.ndarray],
                     cfg: DagConfig) -> None:
    """Re-pack the per-round witness bitplanes from the wide tensors on
    every restore: they are derived caches, so recomputation backfills
    pre-v5 checkpoints and refuses serialised planes inconsistent with
    the tables they cache."""
    arrays["mbr"], arrays["fmr"] = repack_round_bits_np(
        cfg, np.asarray(arrays["wslot"]), np.asarray(arrays["famous"]),
        np.asarray(arrays["mbit"]),
    )


def load_checkpoint_tolerant(
    path: str,
    commit_callback: Optional[Callable] = None,
    device="cuda",
):
    """Corruption-tolerant restart: the checkpoint, or on any failure
    (missing files, truncated msgpack, bit-rotted npz, validation
    errors) ``(None, reason)`` instead of an exception."""
    try:
        return load_checkpoint(path, commit_callback, device=device), None
    except Exception as e:
        return None, f"{type(e).__name__}: {e}"


def load_checkpoint(
    path: str,
    commit_callback: Optional[Callable] = None,
    device="cuda",
) -> TorchHashgraph:
    """Reconstruct an engine from a checkpoint directory on ``device``."""
    with open(os.path.join(path, _META), "rb") as f:
        meta = unpackb(f.read())
    if meta.get("mode") == "byzantine":
        raise NotImplementedError(NOT_PORTED_BYZANTINE)
    if meta.get("mode") == "wide":
        raise NotImplementedError(NOT_PORTED_WIDE)
    cfg = config_from_fields(meta["cfg"])
    with np.load(os.path.join(path, _DEVICE)) as z:
        arrays = {name: z[name]
                  for name in DagState._fields if name in z.files}
    _backfill_sm(arrays, cfg)
    _backfill_packed(arrays, cfg)
    return _restore_engine(meta, arrays, commit_callback, device=device)


def _restore_engine(
    meta: dict,
    arrays: Dict[str, np.ndarray],
    commit_callback: Optional[Callable] = None,
    policy: Optional[dict] = None,
    device="cuda",
) -> TorchHashgraph:
    # v2 lacks the coord16 cfg field, v3 the membership-plane fields, v5
    # the anchor ring: all default-filled
    if meta["version"] not in _READABLE:
        raise ValueError(f"unsupported checkpoint version {meta['version']}")
    cfg = config_from_fields(meta["cfg"])
    # the soundness bounds init_state enforces: a narrow-coordinate
    # config past them would carry already-wrapped seqs
    if cfg.coord8 and not coord8_ok(cfg.s_cap):
        raise ValueError(f"snapshot declares unsound coord8 cfg: {cfg}")
    if cfg.coord16 and not cfg.coord8 and not coord16_ok(cfg.s_cap):
        raise ValueError(f"snapshot declares unsound coord16 cfg: {cfg}")
    policy = policy or {}

    participants: Dict[str, int] = {k: int(v) for k, v in meta["participants"]}
    auto_compact, seq_window, round_margin, compact_min, cons_window = (
        meta["policy"][:5]
    )
    # 6th policy entry (inactive_rounds) is absent on older checkpoints:
    # the engine's default.  The override spells "disabled" as 0, the
    # engine as None.
    snap_ir = meta["policy"][5] if len(meta["policy"]) > 5 else 32
    ir = _pol(policy, "inactive_rounds", snap_ir)
    engine = TorchHashgraph(
        participants,
        commit_callback=commit_callback,
        verify_signatures=_pol(
            policy, "verify_signatures", meta["verify_signatures"]
        ),
        e_cap=cfg.e_cap, s_cap=cfg.s_cap, r_cap=cfg.r_cap,
        auto_compact=_pol(policy, "auto_compact", auto_compact),
        seq_window=_pol(policy, "seq_window", seq_window),
        round_margin=_pol(policy, "round_margin", round_margin),
        compact_min=_pol(policy, "compact_min", compact_min),
        consensus_window=_pol(policy, "consensus_window", cons_window),
        inactive_rounds=None if not ir else int(ir),
        device=device,
    )
    engine.cfg = cfg
    _restore_host(engine, meta)
    # every array is copied onto the device (none shares memory with the
    # loaded host arrays)
    engine.state = state_from_numpy(cfg, DagState(**arrays), device=device)
    engine._r_off = int(arrays["r_off"])
    engine._lcr_cache = int(arrays["lcr"])
    engine._max_round_cache = int(arrays["max_round"])
    return engine


def _restore_host(engine, meta: dict) -> None:
    """Rebuild the host index + consensus log directly from the saved
    window (no replay: signatures were verified before the events
    entered the saved state, and parents below the window no longer
    exist)."""
    dag = engine.dag
    base = meta["slot_base"]
    events = [_unpack_event(o) for o in meta["events"]]
    for i, ev in enumerate(events):
        ev.topological_index = base + i
    dag.events = OffsetList(events, base)
    dag.slot_of = {ev.hex(): base + i for i, ev in enumerate(events)}
    dag.levels = OffsetList(meta["levels"], base)
    dag.sp_slot = OffsetList(meta["sp_slot"], base)
    dag.op_slot = OffsetList(meta["op_slot"], base)
    dag.wire_meta = OffsetList(
        [tuple(m) for m in meta["wire_meta"]], base
    )
    # effective timestamps (adversarial-ts defense): claimed values
    # with the serialized clamp overrides applied — future inserts'
    # clamp windows derive from these, so they must round-trip exactly
    eff = [ev.body.timestamp for ev in events]
    for i, v in meta.get("ts_clamped", []):
        eff[int(i)] = int(v)
    dag.eff_ts = OffsetList(eff, base)
    dag.chains = [
        OffsetList(items, start) for start, items in meta["chains"]
    ]
    dag.pending = []  # the device tensors already contain them
    dag.evicted_heads = {
        int(cid): (int(idx), str(hx))
        for cid, idx, hx in meta.get("evicted_heads", [])
    }
    # the window's emptied chains define the evicted-creator gauge
    engine._evicted_creators_cache = sum(
        1 for c in dag.chains if len(c) and not c.window
    )

    cons_start, cons_items = meta["consensus"]
    engine.consensus = OffsetList(cons_items, cons_start)
    engine._digest = CommitDigest.from_meta(meta.get("digest"))
    engine.consensus_transactions = meta["consensus_transactions"]
    engine.last_committed_round_events = meta["last_committed_round_events"]
    engine._ordered_total = meta["ordered_total"]
    engine._received = set(meta["received"])
    # membership plane (v4; pre-v4 restores at epoch 0 with empty log)
    engine.epoch = int(meta.get("epoch", 0))
    engine.membership_log = [
        {**e, "tx": bytes(e["tx"])} for e in meta.get("membership_log", [])
    ]
    pend = meta.get("pending_membership")
    engine.pending_membership = (
        {**pend, "tx": bytes(pend["tx"])} if pend else None
    )
    # pipelined membership + bounded-log state (pre-existing
    # checkpoints restore with the empty defaults)
    engine.membership_queue = [
        {**q, "tx": bytes(q["tx"])}
        for q in meta.get("membership_queue", [])
    ]
    engine.membership_base_epoch = int(
        meta.get("membership_base_epoch", 0)
    )
    engine.membership_addrs = {
        str(pub): str(addr)
        for pub, addr in meta.get("membership_addrs", [])
    }
    # attestation anchor ring (v6; pre-v6 checkpoints backfill empty —
    # the node re-collects at its next boundary exactly as before).
    # Stashed on the engine in Node's in-memory shape; Node.init seeds
    # its ring from here so a restarted responder can serve proofs for
    # pre-restart positions immediately.
    engine.restored_anchors = [
        {"position": int(a[0]), "digest": str(a[1]), "epoch": int(a[2]),
         "sigs": [(str(p), _scalar_in(r), _scalar_in(s))
                  for p, r, s in a[3]]}
        for a in meta.get("anchors", [])
    ]
