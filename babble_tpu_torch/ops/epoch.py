"""Epoch transitions on the dense state (the port's copy of the JAX
package's ``ops/epoch.py``; host numpy, as there).

``epoch_transition_arrays`` is the host half of
``TorchHashgraph.apply_epoch_transition``: re-shape the state for a
join (one appended participant column) or a leave (the column retired
in the config), and reset every consensus decision above the boundary
round B so that the new epoch re-decides it under the new peer set.

- every event with round_received <= B is already committed when the
  transition applies (apply requires ``lcr >= B``);
- decisions for rounds > B were never committed (the engine's commit
  gate holds them) and are discarded here;
- round assignment is a per-event function of ancestry plus the
  per-round threshold array ``sm``: old rounds keep the old epoch's
  threshold, rounds above B take the new one.

The arrays returned may share memory with the input's host copies (an
untouched field passes through); the engine copies every one of them
onto the device before it uses the result.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .state import (
    DagConfig, FAME_UNDEFINED, repack_round_bits_np, state_to_numpy,
)

I32 = np.int32


def widen_arrays(old: DagConfig, new: DagConfig,
                 a: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Grow the participant axis from old.n to new.n columns (a join):
    every N-shaped array gains sentinel-filled columns/rows for the new
    member, and the ``creator`` sentinel value moves from old.n to
    new.n.  Survivor columns keep their values (a new member always
    takes the next free id)."""
    no, nn = old.n, new.n
    if nn <= no:
        raise ValueError(f"widen requires new n {nn} > old n {no}")
    d = nn - no
    out = dict(a)
    fd_inf = np.asarray(new.fd_inf, a["fd"].dtype)

    def pad_cols(x, fill):
        pad = np.full(x.shape[:-1] + (d,), fill, x.dtype)
        return np.concatenate([x, pad], axis=-1)

    # the creator sentinel (padding lanes + row e_cap) was old.n; that
    # value now names the new member — remap it to the new sentinel
    out["creator"] = np.where(a["creator"] == no, nn,
                              a["creator"]).astype(I32)
    out["la"] = pad_cols(a["la"], -1)
    out["fd"] = pad_cols(a["fd"], fd_inf)
    out["wslot"] = pad_cols(a["wslot"], -1)
    out["famous"] = pad_cols(a["famous"], np.int8(FAME_UNDEFINED))
    # ce/cnt/s_off carry an (n+1)-th sentinel row: the old sentinel row
    # becomes the new member's (init-valued by construction) and fresh
    # sentinel rows are appended
    ce_pad = np.full((d,) + a["ce"].shape[1:], -1, a["ce"].dtype)
    out["ce"] = np.concatenate([a["ce"], ce_pad], axis=0)
    out["cnt"] = np.concatenate([a["cnt"], np.zeros(d, a["cnt"].dtype)])
    out["s_off"] = np.concatenate(
        [a["s_off"], np.zeros(d, a["s_off"].dtype)]
    )
    return out


def epoch_transition_arrays(
    old: DagConfig, new: DagConfig, state, boundary: int
) -> Dict[str, np.ndarray]:
    """Numpy image of the post-transition state, before the round
    rescan: widened/retired shapes, decisions above ``boundary`` reset,
    per-round thresholds split at the boundary.  ``state`` is a DagState
    of tensors or a dict of host arrays."""
    a = state if isinstance(state, dict) else state_to_numpy(state)._asdict()
    if new.n != old.n:
        a = widen_arrays(old, new, a)

    r_off = int(a["r_off"])
    r_cap = new.r_cap
    b_loc = boundary - r_off
    if not (0 <= b_loc < r_cap):
        raise ValueError(
            f"epoch boundary {boundary} outside the round window "
            f"(r_off {r_off}, r_cap {r_cap})"
        )

    a = dict(a)
    # rounds above the boundary: fame undecided, witness tables empty
    # (the rescan re-registers under the new config), reception reset
    a["famous"] = a["famous"].copy()
    a["famous"][b_loc + 1:] = FAME_UNDEFINED
    a["wslot"] = a["wslot"].copy()
    a["wslot"][b_loc + 1:] = -1
    held = a["rr"] > boundary
    a["rr"] = np.where(held, -1, a["rr"]).astype(I32)
    a["cts"] = np.where(held, 0, a["cts"])
    a["lcr"] = np.asarray(min(int(a["lcr"]), boundary), I32)

    # per-round thresholds: old rounds keep the old epoch's quorum, the
    # boundary's future (and the compact backfill sentinel row) take the
    # new epoch's
    sm = a["sm"].copy()
    sm[b_loc + 1:] = new.super_majority
    a["sm"] = sm.astype(I32)

    # rounds above the boundary are rescanned; reset them here so
    # max_round is consistent even when the rescan set is empty
    stale_round = a["round"] > boundary
    a["round"] = np.where(stale_round, -1, a["round"]).astype(I32)
    a["witness"] = a["witness"] & ~stale_round
    live = (np.arange(len(a["seq"])) < int(a["n_events"])) \
        & (a["seq"] >= 0)
    mr = a["round"][live].max() if live.any() else -1
    a["max_round"] = np.asarray(int(mr), I32)

    # packed witness bitplanes: recomputed from the re-shaped tensors (a
    # join can move the lane count, ceil(n/8))
    a["mbr"], a["fmr"] = repack_round_bits_np(
        new, a["wslot"], a["famous"], a["mbit"]
    )
    return a
