"""WAL discipline: self events hit the log before they can gossip.

The durability plane's whole guarantee (babble_tpu_torch/wal) is that a
crash can never forget a sequence number any peer might have seen —
which holds only if every path that constructs a new SELF event and
inserts it into the node's own engine (the act that makes it
gossipable) passes through ``wal.append`` first.  One new mint helper
that skips the log quietly reintroduces the crash-recovery-amnesia
defect the WAL exists to fix (ROADMAP: restart re-mints published
seqs, peers read it as an equivocation, the fleet freezes at
supermajority).

Detection rides the project call graph: a method is a *mint
site* when it calls ``new_event`` and its same-object call closure
(itself plus the methods it transitively calls on ``self``) both
signs an event (``.sign(...)`` / ``sign_and_insert_self_event``) and
inserts into self-owned state (a ``self.…insert_event`` /
``self.sign_and_insert_self_event`` call).  The closure must then
also contain a WAL append — ``self.wal.append(...)`` in any spelling
(``*.wal.append``) or a ``*wal_append*`` helper.  Presence, not
ordering, is what is checked statically; the ordering convention
(append before the engine insert) lives in
``Core.sign_and_insert_self_event``.

Deliberately out of scope: free functions (test/sim DAG builders mint
unsigned-for-real events with no node identity) and inserts into
OTHER objects' engines (the chaos fork injector plants events at a
*target* node — that is an attack, not our gossip path).
"""

from __future__ import annotations

import re
from typing import Iterator, List

from .engine import FileContext, Finding, Rule
from .graph import CallSite, FunctionInfo, ProjectContext

_WAL_APPEND_RE = re.compile(r"(^|\.)_?wal\.append$")
_SELF_INSERT_RE = re.compile(
    r"^self\.([A-Za-z_][\w.]*\.)?insert_event$"
)
_SIGN_INSERT = "sign_and_insert_self_event"


def _is_new_event(site: CallSite) -> bool:
    if site.text == "new_event" or site.text.endswith(".new_event"):
        return True
    return any(q.endswith(":new_event") for q in site.callees)


def _is_sign(site: CallSite) -> bool:
    return (site.text.endswith(".sign")
            or site.text.endswith("." + _SIGN_INSERT))


def _is_self_insert(site: CallSite) -> bool:
    return bool(_SELF_INSERT_RE.match(site.text)) or site.text == (
        "self." + _SIGN_INSERT
    )


def _is_wal_append(site: CallSite) -> bool:
    if _WAL_APPEND_RE.search(site.text):
        return True
    # a helper like self._wal_append(ev) counts at the call site too —
    # its body is usually in the closure anyway, but a project may
    # route through an attribute the graph cannot type
    return "wal_append" in site.text.rsplit(".", 1)[-1]


def _self_closure(project: ProjectContext,
                  fi: FunctionInfo) -> List[FunctionInfo]:
    """``fi`` plus every method it transitively calls on ``self``
    (through all edges, locked or not — WAL reachability is about the
    dynamic extent, not lock context)."""
    out: List[FunctionInfo] = []
    seen = set()
    queue = [fi.qualname]
    while queue:
        q = queue.pop()
        if q in seen:
            continue
        seen.add(q)
        f = project.functions.get(q)
        if f is None:
            continue
        out.append(f)
        if f.cls is None:
            continue
        for site in f.calls:
            if site.via_self:
                nxt = project.lookup_method(
                    (f.module, f.cls), site.text.split(".")[1]
                )
                if nxt is not None:
                    queue.append(nxt)
    return out


class WalBeforeGossipRule(Rule):
    name = "wal-before-gossip"
    description = (
        "a path that constructs-and-inserts a new self event must pass "
        "through wal.append before the event becomes gossipable — a "
        "mint that skips the write-ahead log reintroduces "
        "crash-recovery amnesia (restart re-mints published seqs)"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project = ctx.project
        if project is None:
            return
        for fi in project.functions.values():
            if fi.path != ctx.path or fi.cls is None:
                continue
            mint_sites = [s for s in fi.calls if _is_new_event(s)]
            if not mint_sites:
                continue
            closure = _self_closure(project, fi)
            sites = [s for f in closure for s in f.calls]
            if not any(_is_sign(s) for s in sites):
                continue
            if not any(_is_self_insert(s) for s in sites):
                continue
            if any(_is_wal_append(s) for s in sites):
                continue
            yield self.finding(
                ctx, mint_sites[0].node,
                f"`{fi.name}` constructs and inserts a new self event "
                "but its call closure never touches `wal.append` — "
                "append to the write-ahead log before the event becomes "
                "gossipable, or a crash will re-mint this seq and peers "
                "will read the restart as an equivocation",
            )
