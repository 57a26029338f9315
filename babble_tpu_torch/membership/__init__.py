"""Membership plane: validator join/leave as a consensus operation (the
port's copy of the JAX package's ``membership``).

- :mod:`.transition` — signed join/leave transactions that ride the
  ordinary transaction stream and are ordered by consensus itself;
- :mod:`.epoch` — the epoch ledger: replaying and verifying a
  membership log from a trusted base peer set.

A committed transition takes effect at the decided-round boundary
``B = round_received(tx) + EPOCH_LAG`` (``consensus/engine.py``): every
node commits exactly the events received in rounds <= B under the old
peer set, then re-shapes its engine (join: one more participant column;
leave: the column retired) and re-decides rounds > B under the new set.
"""

from .quorum import (
    attestation_quorum, coin_period, supermajority, sync_quorum,
)
from .epoch import (
    MAX_LOG, PIPELINE_WINDOW, check_log_entry, replay_log,
    verify_membership_chain,
)
from .transition import (
    MEMBERSHIP_MAGIC, MembershipTx, build_membership_tx, parse_membership_tx,
)

__all__ = [
    "MAX_LOG", "MEMBERSHIP_MAGIC", "MembershipTx", "PIPELINE_WINDOW",
    "attestation_quorum", "build_membership_tx", "check_log_entry",
    "coin_period", "parse_membership_tx", "replay_log", "supermajority",
    "sync_quorum", "verify_membership_chain",
]
