"""Checkpoints and fast-forward snapshots of the engine (``checkpoint``)
and the signed state proofs a snapshot is adopted under (``proof``)."""

from .checkpoint import (
    FORMAT_VERSION, engine_mode, load_checkpoint, load_checkpoint_tolerant,
    load_snapshot, save_checkpoint, snapshot_bytes,
)

__all__ = [
    "FORMAT_VERSION", "engine_mode", "load_checkpoint",
    "load_checkpoint_tolerant", "load_snapshot", "save_checkpoint",
    "snapshot_bytes",
]
