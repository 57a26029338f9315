"""Checkpoints and fast-forward snapshots of the engine (``checkpoint``),
the signed state proofs a snapshot is adopted under (``proof``), and the
reference's in-memory Store seam the oracle reads (``inmem``)."""

from .checkpoint import (
    FORMAT_VERSION, engine_mode, load_checkpoint, load_checkpoint_tolerant,
    load_snapshot, save_checkpoint, snapshot_bytes,
)
from .inmem import InmemStore, RoundEvent, RoundInfo, Store

__all__ = [
    "Store", "InmemStore", "RoundInfo", "RoundEvent", "FORMAT_VERSION",
    "engine_mode", "load_checkpoint", "load_checkpoint_tolerant",
    "load_snapshot", "save_checkpoint", "snapshot_bytes",
]
