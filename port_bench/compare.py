"""The comparison that decides ``correct``: the program's outputs for one
job against the plain reference's, event by event.

Every number is a count of events (or witnesses) on which the two
disagree, and its limit is 0: consensus is exact.  An event the
program has not ordered yet, in a job the window cut, is late and not
wrong; in a job that ran to its end every event the reference orders
has to be ordered.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List

import numpy as np


def check(record, ref: Dict[str, np.ndarray]) -> List[dict]:
    """``record``: an entry's record (per-event ``round``,
    ``witness`` with ``witness_read``, ``rr``, ``cts``, with -2 in
    ``round`` where the program gave no reading; ``fame`` by witness
    slot; ``completed``).  ``ref``: the reference's arrays over the
    same job; where the reference gives fork detection (``det``, per
    event and creator) it is compared too.  Returns the compared numbers, each ``{"name", "value",
    "limit", "op"}``."""
    done = bool(record.completed)
    have = record.round != -2
    rows = have if done else have & (record.round >= 0)
    ordered = have & (record.rr >= 0)
    wit = rows & record.witness_read
    fame_bad = fame_n = 0
    for s, f in record.fame.items():
        if done or f != 0:
            fame_n += 1
            fame_bad += int(ref["fame"][s]) != f
    rr_rows = have if done else ordered
    out = [
        ("missing_events", int(np.count_nonzero(~have)) if done else 0),
        ("round_diff", int(np.count_nonzero(
            rows & (record.round != ref["round"])))),
        ("witness_diff", int(np.count_nonzero(
            wit & (record.witness != ref["witness"])))),
        ("fame_diff", fame_bad),
        ("rr_diff", int(np.count_nonzero(
            rr_rows & (record.rr != ref["rr"])))),
        ("cts_diff", int(np.count_nonzero(
            ordered & (record.cts != ref["cts"])))),
    ]
    if "det" in ref:
        out.append(("det_diff", int(np.count_nonzero(
            rows[:, None] & (record.det != ref["det"])))))
    checks = [{"name": k, "value": v, "limit": 0, "op": "<="}
              for k, v in out]
    checks += [
        {"name": "ordered_compared", "value": int(np.count_nonzero(ordered)),
         "limit": 1, "op": ">="},
        {"name": "fame_compared", "value": fame_n, "limit": 1, "op": ">="},
    ]
    return checks


def passed(checks: List[dict]) -> bool:
    return all((c["value"] <= c["limit"]) if c["op"] == "<="
               else (c["value"] >= c["limit"]) for c in checks)


def answers(ref: Dict[str, np.ndarray]):
    """Reference arrays in the form ``check`` reads a program's record
    in, for a whole job: how the control (the reference in a lower
    precision) is put in the program's place."""
    wit = np.nonzero(ref["fame"] >= 0)[0]
    return SimpleNamespace(
        round=ref["round"], witness=ref["witness"],
        witness_read=np.ones(len(ref["round"]), bool), rr=ref["rr"],
        cts=ref["cts"], fame=dict(zip(wit.tolist(),
                                      ref["fame"][wit].tolist())),
        det=ref.get("det"), completed=True)
