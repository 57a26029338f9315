"""Durability plane: per-event write-ahead logging for consensus state.

The checkpoint (store/checkpoint.py) is a periodic snapshot; this
package is the protocol-aware tail that makes restarts *seq-exact*: a
node appends every inserted event — self-created events before they
become gossipable — so recovery replays the WAL on top of the newest
checkpoint, resumes at its true head seq, and never re-mints a
sequence number it already published (the crash-recovery amnesia
defect).  Corruption tolerance is built in: recovery truncates
at the first torn/corrupt record instead of crashing, and a missing
log falls back to the peer-negotiated seq skip-ahead probe in
node/core.py.  See log.py for the record format and fsync policies.

The port's copy of the JAX package's ``wal``: the segments, receipts and
markers either package writes recover in the other.
"""

from .log import MAX_RECORD, FsyncPolicy, WriteAheadLog

__all__ = ["FsyncPolicy", "WriteAheadLog", "MAX_RECORD"]
