"""The batch consensus step on one device.

The port's twin of the JAX package's ``parallel/sharded.py
consensus_step_impl`` (single device; the mesh form is not ported yet):
ingest a topologically ordered gossip batch (coordinates, then rounds),
decide fame, then assign round received and consensus timestamps.  It
runs on the device of ``state``.
"""

from __future__ import annotations

from .ops.fame import decide_fame_auto_impl
from .ops.ingest import EventBatch, ingest_impl
from .ops.order import decide_order_impl
from .ops.state import DagConfig, DagState


def consensus_step(cfg: DagConfig, fd_mode: str, state: DagState,
                   batch: EventBatch, batch_window: bool = True) -> DagState:
    """The full step: ingest (any ``ingest.PORTED_FD_MODES`` mode; the
    batch step runs "walk" or "fast"), DecideFame,
    then FindOrder's device half.  ``batch_window`` asserts the
    all-window-offsets-zero invariant of fresh batch states."""
    state = ingest_impl(cfg, state, fd_mode, batch)
    state = decide_fame_auto_impl(cfg, state, batch_window)
    return decide_order_impl(cfg, state)
