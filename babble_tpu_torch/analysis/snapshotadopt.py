"""Snapshot trust discipline: peer-supplied state must be proof-checked.

Verified fast-forward (store/proof.py) closes the
protocol-aware-recovery hole — a byzantine bootstrap peer feeding a
forged state — but only if EVERY path that builds an engine from
peer-supplied snapshot bytes actually reaches the proof-verification
helpers before (or around) adopting it.  One new catch-up path that
calls ``load_snapshot`` and skips verification quietly reopens the
hole.

Detection rides the project call graph, the same shape as
``wal-before-gossip``: a function whose calls include ``load_snapshot``
(the only constructor for peer-supplied snapshot *bytes*; the local
disk path is ``load_checkpoint``/``load_checkpoint_tolerant`` and is
out of scope) must reach one of the proof helpers —
``verify_snapshot_digest`` / ``verify_snapshot_proof`` /
``verify_attestation`` — either directly or through its same-object
call closure.  ``store/checkpoint.py`` itself (the definition site) is
exempt, as are the proof/test helpers.

Presence, not ordering or conditionality, is what is checked
statically; the runtime gate (``Config.ff_verify``) and the
reject-before-adopt ordering live in ``Node._fast_forward``.
"""

from __future__ import annotations

import re
from typing import Iterator, List

from .engine import FileContext, Finding, Rule
from .graph import CallSite, FunctionInfo, ProjectContext

_VERIFY_RE = re.compile(
    r"(^|\.)(_?verify_snapshot_digest|_?verify_snapshot_proof|"
    r"_?verify_attestation|_?verify_ff_\w+)$"
)

#: modules where load_snapshot legitimately appears unverified: its own
#: definition module, and the proof module documenting it
_EXEMPT_PATH_RE = re.compile(r"store[/\\](checkpoint|proof)\.py$")


def _is_load_snapshot(site: CallSite) -> bool:
    if site.text == "load_snapshot" or site.text.endswith(".load_snapshot"):
        return True
    return any(q.endswith(":load_snapshot") for q in site.callees)


def _is_verify(site: CallSite) -> bool:
    return bool(_VERIFY_RE.search(site.text))


def _self_closure(project: ProjectContext,
                  fi: FunctionInfo) -> List[FunctionInfo]:
    """``fi`` plus every method it transitively calls on ``self``
    (all edges — proof reachability is about the dynamic extent)."""
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


class UnverifiedSnapshotAdoptRule(Rule):
    name = "unverified-snapshot-adopt"
    description = (
        "a path that builds an engine from peer-supplied snapshot bytes "
        "(load_snapshot) must reach the signed-state-proof verification "
        "helpers in its call closure — an unverified adoption reopens "
        "the forged-bootstrap hole (FAST'18 protocol-aware recovery)"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project = ctx.project
        if project is None:
            return
        if _EXEMPT_PATH_RE.search(ctx.path):
            return
        for fi in project.functions.values():
            if fi.path != ctx.path:
                continue
            load_sites = [s for s in fi.calls if _is_load_snapshot(s)]
            if not load_sites:
                continue
            closure = (
                _self_closure(project, fi) if fi.cls is not None else [fi]
            )
            sites = [s for f in closure for s in f.calls]
            if any(_is_verify(s) for s in sites):
                continue
            yield self.finding(
                ctx, load_sites[0].node,
                f"`{fi.name}` builds an engine from peer-supplied "
                "snapshot bytes but its call closure never reaches a "
                "state-proof verification helper "
                "(verify_snapshot_digest / verify_snapshot_proof / "
                "verify_attestation) — an unverified adoption lets a "
                "byzantine bootstrap peer feed a forged state",
            )
