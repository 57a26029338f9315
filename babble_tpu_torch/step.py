"""The batch consensus step.

The port's twin of the JAX package's ``parallel/sharded.py
consensus_step_impl``: ingest a topologically ordered gossip batch
(coordinates, then rounds), decide fame, then assign round received and
consensus timestamps.  It runs on the device of ``state``; with an
``axis`` it is one rank's part of the sharded step
(``parallel/sharded.py make_sharded_step``).
"""

from __future__ import annotations

from .ops.fame import decide_fame_auto_impl
from .ops.ingest import EventBatch, ingest_impl
from .ops.order import decide_order_impl
from .ops.state import DagConfig, DagState


def consensus_step(cfg: DagConfig, fd_mode: str, state: DagState,
                   batch: EventBatch, batch_window: bool = True,
                   axis=None) -> DagState:
    """The full step: ingest (any ``ingest.PORTED_FD_MODES`` mode; the
    batch step runs "walk" or "fast"), DecideFame,
    then FindOrder's device half.  ``batch_window`` asserts the
    all-window-offsets-zero invariant of fresh batch states.  ``axis``
    (a ``parallel.collectives.ColumnShard``): la/fd hold its columns,
    and every compare-count sums its partials over it."""
    state = ingest_impl(cfg, state, fd_mode, batch, axis)
    state = decide_fame_auto_impl(cfg, state, batch_window, axis=axis)
    return decide_order_impl(cfg, state, axis)
