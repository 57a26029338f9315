"""Seeded disk rot: the chaos plane's durable-state faults.

Link faults model the network lying; these model the *disk* lying —
the classic fsync-adjacent failure modes a restart actually meets
(cf. Protocol-Aware Recovery for Consensus-Based Storage, FAST'18):

- ``checkpoint_corrupt``  — one byte inside a seeded-chosen FIELD of
  the checkpoint's ``meta.msgpack`` flipped (bit rot in the snapshot;
  the restore must refuse it and the boot must degrade to WAL replay,
  not crash);
- ``checkpoint_truncate`` — the checkpoint meta chopped at a seeded
  field boundary (a torn checkpoint swap);
- ``wal_corrupt``         — one byte inside a seeded-chosen record
  frame of the newest WAL segment flipped (recovery must truncate at
  the damaged record and keep everything before it);
- ``wal_truncate``        — the newest WAL segment torn inside its
  final record frame (the torn final write of a power cut).

The draws are STRUCTURE-relative, not offset-relative: the corruption
point is chosen over the decoded meta's key spans / the WAL's parsed
record frames, never ``randrange(file_size)``.  Checkpoint-layout
growth (a new meta field, a wider value) therefore stops churning the
canned disk-rot fingerprints — the damaged thing is "field k of the
meta" / "record i of the segment", which survives byte-layout change,
retiring the thrice-used "justified churn" review precedent (PRs 8, 9,
15).  When a target file does not decode as the expected structure
(already-rotten input), the draw falls back to the legacy whole-file
offset so the fault still fires deterministically.

Every choice comes from the injector's per-node seeded disk stream
(:meth:`FaultInjector.disk_rng`), and the files being damaged are
themselves deterministic functions of the scenario seed (events carry
the logical clock, keys are seed-derived), so a disk-rot run replays
bit-for-bit like every other chaos scenario.

Shared by the deterministic in-memory runner and the live fleet runner
(both apply faults at restart time, before the node comes back up).
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

from .. import codec
from .injector import FaultInjector
from .plan import DISK_FAULT_KINDS, DiskFaults

#: checkpoint member the corrupt/truncate kinds target — it is fully
#: deterministic (msgpack of host state), unlike the npz whose zip
#: headers embed write timestamps
_CKPT_META = "meta.msgpack"

#: the WAL record frame header (mirrors wal/log.py): [u32 len][u32 crc]
_WAL_HDR = struct.Struct("<II")

#: refuse to treat absurd lengths as frames when scanning a segment
#: that is itself damaged
_WAL_MAX_RECORD = 64 << 20


def _newest_wal_segment(wal_dir: str) -> Optional[str]:
    try:
        segs = sorted(
            f for f in os.listdir(wal_dir)
            if f.startswith("seg-") and f.endswith(".wal")
            and os.path.getsize(os.path.join(wal_dir, f)) > 0
        )
    except OSError:
        return None
    return os.path.join(wal_dir, segs[-1]) if segs else None


def _flip_byte(path: str, offset: int, xor: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ xor]))


def meta_field_spans(data: bytes) -> Optional[List[Tuple[str, int, int, int]]]:
    """``(key, key_off, value_off, value_len)`` for every top-level
    pair of the msgpack map in ``data``, in serialized order — the
    structure the corruption draw is relative to.  None when the bytes
    are not a byte-faithful msgpack map (already rotten, or not a
    checkpoint meta): the caller falls back to offset draws.

    A msgpack map is its header followed by the packed key/value pairs
    in order, so re-packing each pair walks the exact byte spans —
    guarded by requiring the whole-map re-pack to reproduce ``data``
    byte for byte."""
    try:
        meta = codec.unpackb(data, strict_map_key=False)
    except Exception:
        return None
    if not isinstance(meta, dict) or not meta:
        return None
    try:
        # codec.packb refuses floats, which a checkpoint meta never
        # holds: a meta that decodes to one is rotten input, refused here
        # as a re-pack mismatch
        if codec.packb(meta) != data:
            return None
    except Exception:
        return None
    pair_sizes = [
        (k, len(codec.packb(k)), len(codec.packb(v)))
        for k, v in meta.items()
    ]
    off = len(data) - sum(kl + vl for _, kl, vl in pair_sizes)
    if off < 1:
        return None
    spans = []
    for k, klen, vlen in pair_sizes:
        spans.append((str(k), off, off + klen, vlen))
        off += klen + vlen
    return spans


def wal_record_frames(data: bytes) -> List[Tuple[int, int]]:
    """``(offset, length)`` of every whole payload-carrying record
    frame (header + payload; commit markers are skipped — flipping a
    marker byte is indistinguishable from flipping its record's crc).
    Stops at the first frame that does not parse."""
    frames: List[Tuple[int, int]] = []
    off, n = 0, len(data)
    while off + _WAL_HDR.size <= n:
        length, _crc = _WAL_HDR.unpack_from(data, off)
        if length == 0:                       # commit marker
            off += _WAL_HDR.size
            continue
        if length > _WAL_MAX_RECORD or off + _WAL_HDR.size + length > n:
            break
        frames.append((off, _WAL_HDR.size + length))
        off += _WAL_HDR.size + length
    return frames


def _apply(kind: str, rng, ckpt_dir: str, wal_dir: str) -> bool:
    """Damage the durable state for one fault kind; False when the
    target file does not exist (nothing to rot — not recorded)."""
    if kind.startswith("checkpoint"):
        target = os.path.join(ckpt_dir, _CKPT_META)
        if not os.path.isfile(target) or os.path.getsize(target) == 0:
            return False
        with open(target, "rb") as f:
            data = f.read()
        spans = meta_field_spans(data)
        if kind == "checkpoint_corrupt":
            if spans:
                _, _koff, voff, vlen = spans[rng.randrange(len(spans))]
                _flip_byte(target, voff + rng.randrange(vlen),
                           1 + rng.randrange(255))
            else:
                _flip_byte(target, rng.randrange(len(data)),
                           1 + rng.randrange(255))
        else:
            if spans:
                # torn at a field boundary: the map header still claims
                # the full pair count, the tail pairs are gone
                cut = spans[rng.randrange(len(spans))][1]
            else:
                cut = rng.randrange(len(data))
            with open(target, "r+b") as f:
                f.truncate(cut)
        return True
    target = _newest_wal_segment(wal_dir)
    if target is None:
        return False
    with open(target, "rb") as f:
        data = f.read()
    size = len(data)
    frames = wal_record_frames(data)
    if kind == "wal_corrupt":
        if frames:
            # damage a record in the latter half so recovery
            # demonstrably keeps the records before the corruption
            lo = len(frames) // 2
            foff, flen = frames[lo + rng.randrange(len(frames) - lo)]
            _flip_byte(target, foff + rng.randrange(flen),
                       1 + rng.randrange(255))
        else:
            _flip_byte(target, size // 2 + rng.randrange(size - size // 2),
                       1 + rng.randrange(255))
    else:
        if frames:
            # the torn final write of a power cut: cut inside the last
            # record frame (possibly right after its header)
            foff, flen = frames[-1]
            cut = foff + rng.randrange(flen)
        else:
            cut = size - min(size, 1 + rng.randrange(64))
        with open(target, "r+b") as f:
            f.truncate(cut)
    return True


def apply_disk_faults(
    injector: FaultInjector,
    disk: DiskFaults,
    node: int,
    ckpt_dir: str,
    wal_dir: str,
) -> List[str]:
    """Roll the seeded dice for every disk-fault kind (fixed order, so
    the stream stays reproducible) and damage the node's durable state
    accordingly.  Fired kinds are recorded in the injector log — they
    show up in ``fault_counts`` / the schedule fingerprint like any
    other injected fault."""
    rng = injector.disk_rng(node)
    fired: List[str] = []
    for kind in DISK_FAULT_KINDS:
        p = getattr(disk, kind)
        if p and rng.random() < p and _apply(kind, rng, ckpt_dir, wal_dir):
            injector.record(kind, node, node)
            fired.append(kind)
    return fired
