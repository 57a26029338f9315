"""Durable per-event write-ahead log (the consensus "head receipt").

The crash-recovery-amnesia defect (found by live chaos): an
honest node restarting from a stale checkpoint re-mints sequence
numbers it already published, peers read the duplicate indexes as an
equivocation, and the restarted identity poisons a 3-node fleet at
supermajority.  Protocol-aware storage fixes it at the source: every
event a node inserts — and, critically, every self-event *before* it
becomes gossipable — is appended to this log, so a restart replays the
tail on top of the newest checkpoint and resumes at its true head seq
(cf. Protocol-Aware Recovery for Consensus-Based Storage, FAST'18; the
hashgraph model assumes a node never forgets its own head).

Format — append-only segments ``seg-<n>.wal`` of CRC32-framed records::

    [u32 payload length][u32 crc32(payload)][payload]

where the payload is the checkpoint/byzantine-gossip ``FullWireEvent``
msgpack tuple (one event encoding to evolve, not three).  Recovery
scans segments in order and **truncates at the first torn or corrupt
record instead of crashing**: a short header, a zero/garbage length, a
short payload, a CRC mismatch or an undecodable payload all end the
log there — the file is physically truncated to the last whole record,
later segments are discarded (they were written after the corruption
point, so their ordering context is gone), and the damage is counted
on ``babble_wal_truncated_records_total``.

Fsync policy (``FsyncPolicy.parse``):

- ``always``    — flush + fsync on every append (no acked event can be
  lost, torn tails only for the in-flight record);
- ``batch(n,ms)`` (also accepted as ``batch:n,ms`` / bare ``batch``) —
  flush every append, fsync when ``n`` appends or ``ms`` milliseconds
  accumulated since the last sync; a crash can lose at most one batch,
  which the restart-time seq probe (node/core.py) covers;
- ``off``       — flush only, never fsync: the tier-1 test fast path
  (in-process durability without paying the disk).

Beside the records the directory holds a tiny **head receipt**
(``head.receipt``: msgpack ``[seq, head_hex]``), written atomically on
clean close and after every checkpoint prune.  The receipt lets a
restart distinguish "WAL legitimately empty (just pruned / clean
shutdown)" from "WAL missing entirely" — only the latter falls back to
the peer-negotiated seq skip-ahead probe.

**Per-record commit markers** (``fsync=always`` only): after each
record's fsync returns, a 8-byte marker frame ``[u32 0][u32 crc]``
(zero length = marker; crc = the committed record's payload crc) is
buffered behind it — durable by the NEXT record's fsync.  The marker
is in-file proof of the always discipline: append fsyncs before the
event can gossip, so a recovered log whose records are all
marker-confirmed except at most the final one can only have lost the
in-flight record nobody ever saw.  Recovery therefore skips the peer
seq probe for such torn tails (``needs_probe``), where otherwise every
truncation would arm the probe even under ``always``.  Markers only
prove a PREFIX, though: a later batch/off incarnation's buffered
suffix can vanish without a trace, so every
probe-skip arm additionally requires the durable ``policy`` stamp
each incarnation fsyncs at open to say the PREVIOUS one ran
``always``.  The one window that remains: bit rot landing exactly on
the final, acked-but-unmarked record is indistinguishable from an
in-flight tear — unless its marker already made it to disk, which
recovery does check.

Records and receipts are encoded with the port's ``codec.py`` and decoded
with msgpack's default ``strict_map_key=True``, as the JAX package does.
"""

from __future__ import annotations

import os
import re
import struct
import time
import zlib
from typing import List, Optional, Tuple

from ..codec import packb, unpackb
from ..core.event import Event, FullWireEvent
from ..obs import Registry

_HDR = struct.Struct("<II")
#: sanity bound on one record — a length past this reads as corruption,
#: not as an instruction to allocate gigabytes
MAX_RECORD = 1 << 24

_SEG_RE = re.compile(r"^seg-(\d{8})\.wal$")
_RECEIPT = "head.receipt"
#: fsync policy of the CURRENT incarnation, written (fsynced) at open:
#: recovery must know what the PREVIOUS incarnation actually ran —
#: commit markers prove some PREFIX was written under `always`, but a
#: later batch/off incarnation's buffered suffix can vanish without a
#: trace, so the probe-skip arms require this durable policy evidence,
#: never the current config or the markers alone
_POLICY = "policy"
#: present only between a graceful close and the next open — its
#: absence at boot means the previous incarnation crashed, and under a
#: batched fsync policy a crash can lose a whole SUFFIX of records
#: ending exactly at the last fsync boundary (no torn tail to detect),
#: so an unclean shutdown must arm the seq probe
_CLEAN = "clean"


class FsyncPolicy:
    """Parsed fsync policy: ``always`` / ``batch(n,ms)`` / ``off``."""

    __slots__ = ("mode", "batch_n", "batch_ms")

    def __init__(self, mode: str, batch_n: int = 64, batch_ms: float = 50.0):
        if mode not in ("always", "batch", "off"):
            raise ValueError(f"unknown fsync mode {mode!r}")
        if batch_n < 1 or batch_ms < 0:
            raise ValueError(
                f"batch fsync wants n >= 1 and ms >= 0, got ({batch_n}, {batch_ms})"
            )
        self.mode = mode
        self.batch_n = batch_n
        self.batch_ms = batch_ms

    @classmethod
    def parse(cls, spec: str) -> "FsyncPolicy":
        s = (spec or "batch").strip().lower()
        if s in ("always", "off"):
            return cls(s)
        m = re.fullmatch(r"batch(?:[(:]([0-9]+)\s*,\s*([0-9.]+)\)?)?", s)
        if not m:
            raise ValueError(
                f"unknown fsync policy {spec!r}; want always, off, or "
                "batch(n,ms)"
            )
        if m.group(1) is None:
            return cls("batch")
        return cls("batch", int(m.group(1)), float(m.group(2)))

    def __repr__(self) -> str:
        if self.mode == "batch":
            return f"batch({self.batch_n},{self.batch_ms:g})"
        return self.mode


def _pack_record(ev: Event) -> Tuple[bytes, int]:
    payload = packb(FullWireEvent.from_event(ev).pack())
    crc = zlib.crc32(payload)
    return _HDR.pack(len(payload), crc) + payload, crc


class WriteAheadLog:
    """One node's event WAL.  Construction performs recovery: segments
    are scanned, the tail is truncated at the first bad record, and the
    surviving events are exposed as ``recovered_events`` for the Core
    to replay on top of its checkpoint.  Appends then continue into a
    fresh segment."""

    def __init__(
        self,
        path: str,
        fsync: str = "batch",
        segment_bytes: int = 4 << 20,
        registry: Optional[Registry] = None,
    ):
        self.dir = path
        self.policy = FsyncPolicy.parse(fsync)
        self.segment_bytes = int(segment_bytes)
        self._closed = False
        self._pending = 0
        # monotonic is pacing, not a wall clock: it drives only the
        # batch-fsync deadline, never event bodies (those go through
        # Core.now_ns)
        self._clock = time.monotonic
        self._last_sync = self._clock()
        self._bind_metrics(registry if registry is not None else Registry())

        os.makedirs(path, exist_ok=True)
        # previous incarnation's fsync policy (see _POLICY), then stamp
        # our own before any append can land
        self._prev_always = self._read_policy() == "always"
        self._write_policy()
        self.receipt: Optional[Tuple[int, str]] = self._read_receipt()
        clean_path = os.path.join(path, _CLEAN)
        self.had_clean_close = os.path.isfile(clean_path)
        if self.had_clean_close:
            os.remove(clean_path)   # we are the running incarnation now
        self.recovered_events: List[Event] = []
        self.truncated_records = 0
        #: commit-marker recovery state (fsync=always discipline):
        #: per-record confirmation flags, and whether the truncation —
        #: if any — is provably an unacked in-flight tear
        self._marked_flags: List[bool] = []
        self._torn_tail_safe = False
        self._seg_index = self._scan()
        self._m_truncated.inc(self.truncated_records)

        self._active_path = os.path.join(
            self.dir, f"seg-{self._seg_index:08d}.wal"
        )
        self._active = open(self._active_path, "ab")
        self._size = self._active.tell()

    # ------------------------------------------------------------------
    # metrics

    def _bind_metrics(self, registry: Registry) -> None:
        self._m_appended = registry.counter(
            "babble_wal_appended_total",
            "events appended to the write-ahead log")
        self._m_fsync = registry.histogram(
            "babble_wal_fsync_seconds",
            "WAL flush+fsync wall time per sync")
        self._m_replayed = registry.counter(
            "babble_wal_replayed_events_total",
            "events replayed from the WAL tail at recovery")
        self._m_truncated = registry.counter(
            "babble_wal_truncated_records_total",
            "WAL records lost to torn/corrupt tails at recovery "
            "(corruption points plus records in discarded later segments)")

    def mark_replayed(self, n: int) -> None:
        """Count events the Core actually re-inserted at recovery."""
        if n > 0:
            self._m_replayed.inc(n)

    # ------------------------------------------------------------------
    # recovery

    @property
    def is_fresh(self) -> bool:
        """True when the directory held neither records nor a head
        receipt — the node has no durable memory of its own chain and
        must seq-probe its peers before minting anything."""
        return not self.recovered_events and self.receipt is None

    @property
    def marker_disciplined(self) -> bool:
        """True when the recovered log carries in-file proof of the
        ``fsync=always`` commit-marker discipline: at least one marker,
        and every record except possibly the FINAL one confirmed (the
        final record's marker rides the next append's fsync, so a crash
        may legitimately lose exactly that one marker).

        Markers alone only prove some PREFIX was appended under
        ``always`` — a later batch/off incarnation's entire buffered
        suffix can vanish with no trace on disk — so every probe-skip
        arm pairs this with ``_prev_always`` (the fsynced policy stamp
        the previous incarnation wrote at ITS open)."""
        if not self._marked_flags:
            return False
        if not any(self._marked_flags):
            return False
        return all(self._marked_flags[:-1])

    @property
    def needs_probe(self) -> bool:
        """True when recovery cannot vouch that every PUBLISHED seq
        survived, so minting must wait for the peer-negotiated
        skip-ahead: the log is missing entirely, its tail was
        torn/corrupt, or the previous incarnation crashed under a
        batched/disabled fsync policy — there a whole suffix of
        records can be lost at a clean fsync boundary with nothing
        left to detect.

        ``fsync=always`` logs carry per-record commit markers, and a
        truncation that is provably an unacked in-flight tear — the
        previous incarnation's policy stamp says ``always``, marker
        discipline intact, damage confined to the unmarked tail of the
        final segment, nothing decodable beyond it — skips the probe:
        append fsynced before the event could gossip, so the lost
        record was never published.  The unclean-shutdown arm likewise
        trusts the previous incarnation's STAMPED policy, never the
        current config (which says nothing about what the dead process
        ran) and never the markers alone (which only prove a prefix)."""
        if self.is_fresh:
            return True
        if self.truncated_records > 0:
            return not (self._prev_always and self._torn_tail_safe
                        and self.marker_disciplined)
        if self._prev_always and (self.marker_disciplined
                                  or not self.recovered_events):
            # the stamp alone is not enough: recovered records must
            # also SHOW the always discipline (an earlier batch-era
            # tail that vanished at a clean EOF leaves unmarked
            # records behind — those seqs were published unvouched).
            # An empty-but-receipted log is fine: under always, any
            # post-prune append would have been fsynced and present.
            return False
        return not self.had_clean_close

    @property
    def receipt_seq(self) -> int:
        return self.receipt[0] if self.receipt is not None else -1

    def _read_policy(self) -> Optional[str]:
        try:
            with open(os.path.join(self.dir, _POLICY)) as f:
                return f.read().strip() or None
        except OSError:
            return None

    def _write_policy(self) -> None:
        try:
            tmp = os.path.join(self.dir, _POLICY + ".tmp")
            with open(tmp, "w") as f:
                f.write(self.policy.mode)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.dir, _POLICY))
        except OSError:
            # a read-only dir only loses the NEXT boot's probe-skip
            # evidence — recovery then stays conservative (probes)
            pass

    def _read_receipt(self) -> Optional[Tuple[int, str]]:
        try:
            with open(os.path.join(self.dir, _RECEIPT), "rb") as f:
                seq, head = unpackb(f.read())
            if not isinstance(seq, int) or not isinstance(head, str):
                return None
            return (seq, head)
        except (OSError, ValueError, TypeError):
            # disk rot may hit the receipt too — an unreadable receipt
            # is the same as a missing one (the probe path covers it)
            return None

    def _segments(self) -> List[Tuple[int, str]]:
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in names:
            m = _SEG_RE.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.dir, name)))
        out.sort()
        return out

    def _scan(self) -> int:
        """Recover every whole record; returns the index the next
        (fresh) active segment should use."""
        segs = self._segments()
        next_index = (segs[-1][0] + 1) if segs else 0
        for si, (_, seg_path) in enumerate(segs):
            with open(seg_path, "rb") as f:
                data = f.read()
            good = self._scan_segment(data)
            if good is None:
                continue
            # torn/corrupt tail: truncate the file to the last whole
            # record and discard every LATER segment — records after
            # the corruption point lost their ordering context.  The
            # counter reflects actual damage: 1 for the corruption
            # point plus every decodable record in the discarded
            # segments (an operator triaging disk rot must not see a
            # hundred-record loss reported as 1).
            with open(seg_path, "r+b") as f:
                f.truncate(good)
            discarded = 0
            for _, later in segs[si + 1:]:
                with open(later, "rb") as f:
                    discarded += self._count_records(f.read())
                os.remove(later)
            # ...and conversely must not see "1 record lost" when the
            # damaged frame is a trailing commit MARKER whose record
            # was recovered intact: a bad or torn zero-length frame at
            # the very tail (nothing decodable beyond, no later
            # segments) lost no event data at all.  The tell apart
            # from a torn in-flight RECORD: markers directly follow
            # their record, so a torn marker leaves the final
            # recovered record UNMARKED, while a torn record leaves it
            # marked (and stays counted, as before).
            frag = len(data) - good
            bad_is_marker_frame = (
                frag < _HDR.size
                or (_HDR.unpack_from(data, good)[0] == 0
                    and self._count_records(data[good + _HDR.size:]) == 0)
            )
            marker_only_tear = (
                si == len(segs) - 1
                and discarded == 0
                and bad_is_marker_frame
                # ...and the log must actually show marker discipline
                # with the final record awaiting its marker — a
                # zero-FILL tail on a marker-less batch/off log stays
                # conservatively counted as one possibly-lost record
                and any(self._marked_flags)
                and not self._marked_flags[-1]
            )
            if not marker_only_tear:
                self.truncated_records += 1
            self.truncated_records += discarded
            # unacked-in-flight-tear classification (needs_probe):
            # damage confined to the final segment's tail, nothing
            # decodable beyond the corruption point, and no marker
            # vouching that the damaged record was ever acked
            self._torn_tail_safe = (
                si == len(segs) - 1
                and discarded == 0
                and self._tail_is_unacked_tear(data, good)
            )
            break
        return next_index

    @staticmethod
    def _count_records(data: bytes) -> int:
        """Whole records in a segment being discarded (count only).
        Zero-length commit-marker frames are skipped, not counted —
        but markers never appear back to back (record, marker, record,
        ...), so a SECOND consecutive zero frame is zero fill and ends
        the walk (a largely zero-filled 4 MB segment must not cost
        half a million header parses at recovery)."""
        off, n, count, zrun = 0, len(data), 0, 0
        while off + _HDR.size <= n:
            length, _ = _HDR.unpack_from(data, off)
            if length == 0:
                zrun += 1
                if zrun >= 2:
                    break           # zero fill, nothing decodable follows
                off += _HDR.size    # a (plausible) commit marker
                continue
            zrun = 0
            if length > MAX_RECORD or off + _HDR.size + length > n:
                break
            count += 1
            off += _HDR.size + length
        return count

    @staticmethod
    def _tail_is_unacked_tear(data: bytes, off: int) -> bool:
        """True when the bad region at ``off`` can only be the record
        that was in flight when the process died: a torn header or
        payload at EOF, or a whole-but-corrupt final frame with NO
        commit marker behind it (a marker would prove the record was
        fsynced-and-acked — bit rot on durable history, not a tear)."""
        n = len(data)
        if n - off < _HDR.size:
            return True             # torn header at EOF
        length, _ = _HDR.unpack_from(data, off)
        if length == 0:
            # a corrupt MARKER frame: its record was already recovered,
            # but whether later records existed is unknowable — probe
            return False
        if length > MAX_RECORD:
            # garbage length (zero-fill / rot): safe only when nothing
            # decodable follows the corruption point
            return WriteAheadLog._count_records(data[off:]) == 0
        end = off + _HDR.size + length
        if end > n:
            return True             # torn payload at EOF
        # whole frame, bad crc / undecodable: if a commit marker
        # follows, the record was acked before the crash — rot, probe
        return not (
            n - end >= _HDR.size and _HDR.unpack_from(data, end)[0] == 0
        )

    def _scan_segment(self, data: bytes) -> Optional[int]:
        """Decode records from one segment into ``recovered_events``
        (zero-length frames are commit markers confirming the record
        immediately before them).  Returns None if the whole segment
        was clean, else the byte offset of the first bad frame (the
        truncation point)."""
        off = 0
        n = len(data)
        last_crc: Optional[int] = None   # unconfirmed previous record
        while off < n:
            if n - off < _HDR.size:
                return off          # torn header
            length, crc = _HDR.unpack_from(data, off)
            if length == 0:
                # commit marker: must confirm the immediately-previous
                # record by payload crc, exactly once — anything else
                # (orphan marker, wrong crc, duplicate) is corruption
                if last_crc is None or crc != last_crc:
                    return off
                self._marked_flags[-1] = True
                last_crc = None
                off += _HDR.size
                continue
            if length > MAX_RECORD or off + _HDR.size + length > n:
                return off          # zero-fill / garbage length / torn payload
            payload = data[off + _HDR.size: off + _HDR.size + length]
            if zlib.crc32(payload) != crc:
                return off          # bit rot
            try:
                ev = FullWireEvent.unpack(unpackb(payload)).to_event()
            except Exception:
                return off          # CRC-valid but undecodable payload
            self.recovered_events.append(ev)
            self._marked_flags.append(False)
            last_crc = crc
            off += _HDR.size + length
        return None

    # ------------------------------------------------------------------
    # append path

    def append(self, event: Event) -> None:
        """Durably record one event per the fsync policy.  Called for
        every event the Core inserts; for self-created events the call
        happens BEFORE the engine insert that makes them gossipable —
        that ordering is the whole point of the log (babble-lint
        ``wal-before-gossip`` pins it at the mint sites)."""
        if self._closed:
            raise ValueError("write-ahead log is closed")
        buf, crc = _pack_record(event)
        self._active.write(buf)
        self._size += len(buf)
        self._pending += 1
        self._m_appended.inc()
        self._sync_per_policy()
        if self.policy.mode == "always":
            # commit marker: the fsync above returned, so this record is
            # durable BEFORE the event can gossip — the marker (durable
            # by the next append's fsync) is the in-file proof recovery
            # needs to skip the seq probe on a torn in-flight tail
            self._active.write(_HDR.pack(0, crc))
            self._size += _HDR.size
            self._active.flush()
        if self._size >= self.segment_bytes:
            self._rotate()

    def _sync_per_policy(self) -> None:
        p = self.policy
        if p.mode == "off":
            self._active.flush()
            return
        due = (
            p.mode == "always"
            or self._pending >= p.batch_n
            or (self._clock() - self._last_sync) * 1e3 >= p.batch_ms
        )
        self._active.flush()
        if due:
            self._fsync_active()

    def _fsync_active(self) -> None:
        t0 = time.perf_counter()
        os.fsync(self._active.fileno())
        self._m_fsync.observe(time.perf_counter() - t0)
        self._pending = 0
        self._last_sync = self._clock()

    def _rotate(self) -> None:
        if self.policy.mode != "off":
            self._active.flush()
            self._fsync_active()
        self._active.close()
        self._seg_index += 1
        self._active_path = os.path.join(
            self.dir, f"seg-{self._seg_index:08d}.wal"
        )
        self._active = open(self._active_path, "ab")
        self._size = 0

    # ------------------------------------------------------------------
    # checkpoint coordination / shutdown

    def _write_receipt(self, seq: int, head: str) -> None:
        tmp = os.path.join(self.dir, _RECEIPT + ".tmp")
        with open(tmp, "wb") as f:
            f.write(packb([int(seq), head]))
            f.flush()
            if self.policy.mode != "off":
                os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.dir, _RECEIPT))
        self.receipt = (int(seq), head)

    def checkpointed(self, seq: int, head: str) -> None:
        """A checkpoint covering everything appended so far was just
        saved (caller holds the core lock): rotate to a fresh segment
        and prune the records the checkpoint now carries.  The head
        receipt keeps the true head seq durable even through the
        empty-log window right after a prune."""
        if self._closed:
            return
        self._write_receipt(seq, head)
        self._rotate()
        for idx, seg_path in self._segments():
            if idx < self._seg_index:
                os.remove(seg_path)

    def close(self, seq: Optional[int] = None, head: str = "") -> None:
        """Graceful shutdown: final fsync, a head receipt, and the
        clean marker — so the next boot trusts the (possibly empty)
        log without a probe."""
        if self._closed:
            return
        if self.policy.mode != "off":
            self._active.flush()
            self._fsync_active()
        else:
            self._active.flush()
        if seq is not None:
            self._write_receipt(seq, head)
        with open(os.path.join(self.dir, _CLEAN), "wb") as f:
            f.write(b"")
        self._active.close()
        self._closed = True

    def abort(self) -> None:
        """Crash-style close: drop the handles, write NO receipt.  The
        chaos runner uses this so a simulated crash leaves exactly what
        a real power cut would."""
        if self._closed:
            return
        self._active.close()
        self._closed = True
