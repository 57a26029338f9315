"""Cross-engine invariant parity: ``engine-parity``.

ROADMAP item 4 documents the failure mode this rule closes: the stack
has three engine surfaces (fused ``TpuHashgraph``, windowed
``WideHashgraph``, byzantine ``ForkHashgraph``) and every insert-path
protection — the timestamp clamp, the retired-creator ingress
gate, WAL-before-gossip, quorum-helper routing, hostile snapshot-meta
checks — has historically been ported *by hand*, and the porting
already failed once (the fork engine's ingestion shipped without the
timestamp clamp; this rule fired on that gap on landing and the same
PR fixed it).

The check is a diff between a *declarative invariant registry* and
each engine surface's call closure over the project graph:

- **engine surfaces** are project classes whose name ends with
  ``Hashgraph`` and that define (or inherit) ``insert_event``.
  ``Oracle``-named classes are exempt by design: oracles are the
  definition-first differential ground truths — they mirror semantics
  (see ``OracleHashgraph._eff_ts``) but are never on a trust boundary.
- each invariant names a **witness** (a call basename, a call-text
  suffix, or an attribute read) and a **scope**:

  - ``engine`` — the witness must appear in the closure of the
    engine's own ingest/tick anchors (``__init__``, ``insert_event``,
    ``flush``, ``run_consensus``, ``_run``, ``build_batch``,
    ``maybe_compact``), expanded through resolved call edges,
    attr-typed ``self.dag.insert`` hops, and *constructor expansion*
    (a call that resolves to a project class pulls that class's
    method bodies in — ``ForkConfig(...)`` exposes its
    ``super_majority`` property);
  - ``integration`` — the witness may instead live in an integration
    class (any project class holding an attribute constructor-typed to
    the engine, e.g. ``Core``): gates like WAL append and retired-
    creator refusal are deliberately engine-agnostic, and demanding
    them per-engine would force N copies of one seam;
  - ``adoption`` — for every ``load_snapshot``-named function whose
    forward closure *constructs* the engine, that closure must also
    reach a ``check*meta``-family bounds helper (vacuous when no
    adoption path builds the engine).

A missing witness is a finding anchored at the engine's
``insert_event`` (or class) line, so a genuinely-not-yet-ported
invariant is waived with a *named, justified* suppression there —
turning the ROADMAP drift list into a build-gated contract instead of
a prose promise.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .engine import FileContext, Finding, Rule
from .graph import FunctionInfo, ProjectContext

#: ingest/tick anchor methods whose closure IS the engine surface
_ANCHORS = ("__init__", "insert_event", "flush", "run_consensus",
            "_run", "build_batch", "maybe_compact")

_ENGINE_SUFFIX = "Hashgraph"
_ORACLE_MARK = "Oracle"

_META_CHECK_RE = re.compile(r"^_?check_(\w+_)?meta$|^check_meta$"
                            r"|^_?check_pending_entry$")


@dataclass(frozen=True)
class Invariant:
    """One insert-path protection every engine surface must witness."""

    name: str
    #: regex over call basenames (resolved callee or trailing text)
    call_re: Optional[str]
    #: regex over attribute-read names
    attr_re: Optional[str]
    #: regex over full dotted call text
    text_re: Optional[str]
    #: 'engine' | 'integration' (= engine closure OR integration class)
    scope: str
    rationale: str


#: the declarative registry the engine surfaces are diffed against —
#: adding a protection to one engine means adding its witness here,
#: which makes the OTHER engines fail lint until ported or waived
PARITY_REGISTRY: Tuple[Invariant, ...] = (
    Invariant(
        name="timestamp-clamp",
        call_re=r"^clamp_eff_ts$",
        attr_re=None,
        text_re=None,
        scope="engine",
        rationale=(
            "per-creator effective-timestamp clamp (core/dag.py "
            "clamp_eff_ts): without it a lying-clock creator skews "
            "every round-received median this surface commits"
        ),
    ),
    Invariant(
        name="retired-ingress-gate",
        call_re=r"retired",
        attr_re=r"retired",
        text_re=None,
        scope="integration",
        rationale=(
            "retired-creator ingress gate: events minted by a creator "
            "past its leave epoch must be refused at ingest, or a "
            "stale key keeps steering consensus after handoff"
        ),
    ),
    Invariant(
        name="wal-append",
        call_re=None,
        attr_re=None,
        text_re=r"(^|\.)wal\.append$",
        scope="integration",
        rationale=(
            "WAL append on the ingest path: an event adopted without "
            "a durable record is amnesia after crash-restart "
            "(wal-before-gossip covers the mint side; this covers "
            "the surface)"
        ),
    ),
    Invariant(
        name="quorum-helper-routing",
        call_re=r"^(supermajority|sync_quorum|attestation_quorum)$",
        attr_re=r"^(supermaj|super_majority)$",
        text_re=None,
        scope="engine",
        rationale=(
            "quorum thresholds must route through the shared helpers "
            "(membership/quorum.py): a hand-rolled 2n/3 forgets the "
            "+1 and admits a one-third-byzantine quorum "
            "(stale-quorum-math's interprocedural twin)"
        ),
    ),
    Invariant(
        name="hostile-meta-check",
        call_re=None,
        attr_re=None,
        text_re=None,        # special-cased: adoption-closure check
        scope="adoption",
        rationale=(
            "every load_snapshot path that constructs this engine "
            "must bounds-check the peer-supplied meta "
            "(_check_fork_meta/_check_host_meta family) before any "
            "array is materialized — the forged-snapshot OOM class"
        ),
    ),
)


def _basename(text: str) -> str:
    return text.rsplit(".", 1)[-1]


def _qual_basename(qual: str) -> str:
    return qual.rsplit(":", 1)[-1].rsplit(".", 1)[-1]


class _Witnesses:
    """Witness facts of one closure: call basenames, call texts,
    attribute-read names."""

    def __init__(self) -> None:
        self.call_names: Set[str] = set()
        self.call_texts: Set[str] = set()
        self.attr_names: Set[str] = set()

    def absorb(self, fi: FunctionInfo) -> None:
        for site in fi.calls:
            self.call_texts.add(site.text)
            self.call_names.add(_basename(site.text))
            for q in site.callees:
                self.call_names.add(_qual_basename(q))
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Attribute):
                self.attr_names.add(node.attr)

    def has(self, inv: Invariant) -> bool:
        if inv.call_re and any(re.search(inv.call_re, n)
                               for n in self.call_names):
            return True
        if inv.attr_re and any(re.search(inv.attr_re, n)
                               for n in self.attr_names):
            return True
        if inv.text_re and any(re.search(inv.text_re, t)
                               for t in self.call_texts):
            return True
        return False


def _closure_functions(
    project: ProjectContext, seeds: List[str],
) -> List[FunctionInfo]:
    """Seed qualnames expanded through every resolved call edge, plus
    constructor expansion: a call whose text resolves to a project
    class pulls in that class's own methods (NamedTuple configs carry
    their quorum properties; no ``__init__`` edge exists for them)."""
    out: List[FunctionInfo] = []
    seen: Set[str] = set()
    queue = list(seeds)
    while queue:
        q = queue.pop()
        if q in seen:
            continue
        seen.add(q)
        fi = project.functions.get(q)
        if fi is None:
            continue
        out.append(fi)
        mod = project.modules.get(fi.module)
        for site in fi.calls:
            queue.extend(site.callees)
            if mod is not None and site.text and "." not in site.text:
                key = project._resolve_class(mod, site.text)
                ci = project.classes.get(key) if key else None
                if ci is not None:
                    queue.extend(ci.methods.values())
    return out


def _engine_surfaces(project: ProjectContext):
    """(ClassInfo, insert_event qualname) for every engine surface."""
    for key, ci in sorted(project.classes.items()):
        if not ci.name.endswith(_ENGINE_SUFFIX):
            continue
        if _ORACLE_MARK in ci.name:
            continue
        ins = project.lookup_method(key, "insert_event")
        if ins is not None:
            yield ci, ins


class _ParityState:
    """Project-wide diff, computed once per run and cached like
    ``_determinism_state``."""

    def __init__(self, project: ProjectContext):
        #: (module, class) -> [(invariant, message)]
        self.missing: Dict[Tuple[str, str], List[Tuple[Invariant, str]]] = {}
        self._compute(project)

    def _compute(self, project: ProjectContext) -> None:
        surfaces = list(_engine_surfaces(project))
        if not surfaces:
            return
        loaders = [
            (qual, _closure_functions(project, [qual]))
            for qual, fi in sorted(project.functions.items())
            if fi.name == "load_snapshot"
        ]
        for ci, ins_qual in surfaces:
            seeds = []
            for anchor in _ANCHORS:
                meth = project.lookup_method(ci.key, anchor)
                if meth is not None:
                    seeds.append(meth)
            engine_w = _Witnesses()
            for fi in _closure_functions(project, seeds):
                engine_w.absorb(fi)
            integ_w = _Witnesses()
            for other in project.classes.values():
                holds = any(ci.key in cands
                            for cands in other.attr_types.values())
                if not holds or other.key == ci.key:
                    continue
                for meth_qual in other.methods.values():
                    fi = project.functions.get(meth_qual)
                    if fi is not None:
                        integ_w.absorb(fi)
            for inv in PARITY_REGISTRY:
                if inv.scope == "adoption":
                    msg = self._check_adoption(project, ci, loaders)
                    if msg:
                        self.missing.setdefault(ci.key, []).append(
                            (inv, msg))
                    continue
                ok = engine_w.has(inv)
                if not ok and inv.scope == "integration":
                    ok = integ_w.has(inv)
                if not ok:
                    where = ("its ingest/tick closure"
                             if inv.scope == "engine" else
                             "its ingest/tick closure or any "
                             "integration class holding it")
                    self.missing.setdefault(ci.key, []).append((inv, (
                        f"engine surface `{ci.name}` never witnesses "
                        f"insert-path invariant `{inv.name}` in {where} "
                        f"— {inv.rationale}; port the protection or "
                        "waive it here with a justified suppression"
                    )))

    @staticmethod
    def _check_adoption(project: ProjectContext, ci,
                        loaders) -> Optional[str]:
        """A load_snapshot closure that constructs this engine must
        also reach a check*meta helper."""
        for qual, closure in loaders:
            constructs = False
            checked = False
            for fi in closure:
                for site in fi.calls:
                    if _basename(site.text) == ci.name:
                        constructs = True
                    base = _basename(site.text)
                    if _META_CHECK_RE.match(base) or any(
                            _META_CHECK_RE.match(_qual_basename(q))
                            for q in site.callees):
                        checked = True
            if constructs and not checked:
                lname = _qual_basename(qual)
                return (
                    f"`{lname}` adopts peer-supplied snapshot bytes "
                    f"into `{ci.name}` without a check*meta-family "
                    "bounds pass in its closure — "
                    "invariant `hostile-meta-check`: a hostile meta "
                    "can size allocations before any signature is "
                    "looked at"
                )
        return None


class EngineParityRule(Rule):
    name = "engine-parity"
    description = (
        "every engine surface (class *Hashgraph with insert_event; "
        "oracles exempt) must witness the declarative insert-path "
        "invariant registry — timestamp clamp, retired-creator ingress "
        "gate, WAL append, quorum-helper routing, hostile meta checks "
        "— in its ingest/adoption call closure; a protection added to "
        "one engine fails lint on the others until ported or waived "
        "with a justified suppression"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project: ProjectContext = ctx.project
        if project is None:
            return
        state = getattr(project, "_parity_state", None)
        if state is None:
            state = _ParityState(project)
            project._parity_state = state
        for key, misses in sorted(state.missing.items()):
            ci = project.classes.get(key)
            if ci is None:
                continue
            mod = project.modules.get(ci.module)
            if mod is None or mod.path != ctx.path:
                continue
            anchor = self._anchor(project, ci, mod)
            for _inv, msg in misses:
                yield self.finding(ctx, anchor, msg)

    @staticmethod
    def _anchor(project: ProjectContext, ci, mod) -> ast.AST:
        """The engine's own insert_event def when it has one, else its
        class statement — a line the surface's author owns, so a
        waiver suppression has a stable home."""
        own = ci.methods.get("insert_event")
        fi = project.functions.get(own) if own else None
        if fi is not None:
            return fi.node
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and node.name == ci.name:
                return node
        return ast.Pass(lineno=1, col_offset=0)
