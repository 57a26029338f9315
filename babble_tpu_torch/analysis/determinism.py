"""Interprocedural determinism taint: ``consensus-nondeterminism``.

Virtual voting (PAPER.md) is BFT-safe only if every honest node computes
the same rounds/fame/order from the same DAG, and the chaos plane
(chaos/) turned that into a hard, tested contract: committed order and
fault schedules are pure functions of ``(plan, seed)``.  A single wall
clock read, global-RNG draw or unordered-``set`` walk that flows into
the commit path breaks the contract *silently* — the run still passes,
it just stops being replayable, and divergence shows up as a consensus
fault on one node out of N.

The per-file v1 rules could only see a source and a sink in the same
function.  This pass works on the project call graph (graph.py):

**Sources** (nondeterministic inputs)
  - wall clocks: ``time.time()`` / ``time.time_ns()`` /
    ``datetime.now()`` — OUTSIDE the ``Core.now_ns`` hook, which is the
    sanctioned seam (the chaos runner swaps in a seeded logical clock
    there; a bare *reference* to ``time.time_ns`` stored into the hook
    is not a read and does not taint);
  - the process-global RNG (``random.random()`` &c., unseeded
    ``random.Random()``) and OS entropy (``os.urandom``,
    ``secrets.*``, ``uuid.uuid4``);
  - ``id(...)`` — CPython address, differs per process;
  - environment reads (``os.environ[...]`` / ``.get`` / ``os.getenv``);
  - order-sensitive iteration over a statically-evident ``set``
    (literal, ``set(...)``/``frozenset(...)``, set comprehension,
    ``.union()``-family results, or a local assigned from one) that is
    not wrapped in ``sorted(...)``: ``list(s)``/``tuple(s)``,
    ``"".join(s)``, a ``for`` loop that appends or yields, or a list
    comprehension over it.  Plain membership tests, counting and
    reductions are order-insensitive and stay clean.  (``dict``
    iteration is insertion-ordered in CPython and therefore
    deterministic given deterministic inserts — not a source.)

**Sinks** (consensus-order-bearing)
  - ``consensus_sort`` (consensus/ordering.py),
  - event construction/hashing: ``new_event``, ``.canonical_bytes()``,
  - checkpoint serialization: ``save_checkpoint`` / ``snapshot_bytes``,
  - the chaos plane's canonical ``.schedule_fingerprint()``.

**Propagation**: a function is *nondet* if it contains a source or
calls a nondet function; it is *sink-reaching* if it is a sink, makes a
sink call, or calls a sink-reaching function.  Findings are reported at
the deepest point that pins the defect:

  - a source expression inside a sink-reaching function, or
  - a call from a sink-reaching function to a nondet function that is
    not itself sink-reaching (the taint frontier) — so a clock read two
    frames away from the commit path reports exactly once, at the call
    that carries it in, with the witness chain in the message.

This is an over-approximation by design (no value-level dataflow: any
entropy inside a commit-reaching function is flagged even if the value
provably never reaches the sink call's arguments).  False positives
document themselves with a named suppression + justification; a missed
source diverges a fleet.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .engine import FileContext, Finding, Rule
from .graph import CallSite, FunctionInfo, ProjectContext, dotted_name
from .randomness import _GLOBAL_RNG_FUNCS

#: wall-clock reads (value-producing; a bare reference is not a read)
_WALL_CLOCKS = {
    "time.time", "time.time_ns",
    "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
}
#: OS-entropy draws
_ENTROPY = {
    "os.urandom", "secrets.token_bytes", "secrets.token_hex",
    "secrets.token_urlsafe", "secrets.randbits", "secrets.choice",
    "uuid.uuid1", "uuid.uuid4",
}
_ENV_CALLS = {"os.getenv", "os.environ.get", "os.environ.setdefault"}

#: free functions whose NAME is a sink (resolution-independent so
#: fixtures and vendored copies count too)
SINK_FUNCS = {"consensus_sort", "new_event", "save_checkpoint",
              "snapshot_bytes"}
#: method attrs that are sinks on any receiver
SINK_ATTRS = {"canonical_bytes", "schedule_fingerprint"}

#: set-producing method names (receiver-independent)
_SET_METHODS = {"union", "intersection", "difference",
                "symmetric_difference"}
#: order-sensitive consumers of an iterable argument
_ORDER_SENSITIVE_FUNCS = {"list", "tuple", "iter", "next", "enumerate"}


class _Source:
    __slots__ = ("node", "label")

    def __init__(self, node: ast.AST, label: str):
        self.node = node
        self.label = label


def _is_set_expr(node: ast.AST, set_locals: Set[str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Name) and node.id in set_locals:
        return True
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in ("set", "frozenset"):
            return True
        if isinstance(f, ast.Attribute) and f.attr in _SET_METHODS:
            return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return (_is_set_expr(node.left, set_locals)
                or _is_set_expr(node.right, set_locals))
    return False


def _loop_is_order_sensitive(loop: ast.For) -> bool:
    """Appending/yielding from the loop makes iteration order
    observable; counting/summing/membership does not."""
    for sub in ast.walk(loop):
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            continue
        if isinstance(sub, (ast.Yield, ast.YieldFrom)):
            return True
        if (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in ("append", "extend", "appendleft")):
            return True
    return False


def _collect_sources(fi: FunctionInfo, aliases: Dict[str, str]) -> List[_Source]:
    """Direct nondeterminism sources in one function's subtree (nested
    defs included: a closure's draw runs within its owner's extent)."""
    out: List[_Source] = []
    set_locals: Set[str] = set()
    sorted_wrapped: Set[int] = set()
    # first pass: locals statically bound to set expressions
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Assign) and _is_set_expr(node.value, set()):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    set_locals.add(t.id)
        # note every expression under a sorted(...) call: order is fixed
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "sorted"):
            for sub in ast.walk(node):
                sorted_wrapped.add(id(sub))

    def absolute(dotted: str) -> str:
        """Rewrite the leading segment through the module's import
        aliases: `_time.time` -> `time.time`, a bare `urandom` from
        `from os import urandom` -> `os.urandom` — renaming an import
        must not hide a source."""
        if not dotted:
            return dotted
        parts = dotted.split(".")
        tgt = aliases.get(parts[0])
        if tgt and tgt != parts[0]:
            return ".".join([tgt] + parts[1:])
        return dotted

    def rng_alias(name: str) -> bool:
        tgt = aliases.get(name, "")
        return (tgt.startswith("random.")
                and tgt.split(".", 1)[1] in _GLOBAL_RNG_FUNCS)

    for node in ast.walk(fi.node):
        if isinstance(node, ast.Call):
            dotted = absolute(dotted_name(node.func))
            if dotted in _WALL_CLOCKS:
                out.append(_Source(node, f"wall clock `{dotted}()`"))
            elif dotted in _ENTROPY:
                out.append(_Source(node, f"OS entropy `{dotted}()`"))
            elif dotted in _ENV_CALLS:
                out.append(_Source(node, f"environment read `{dotted}()`"))
            elif dotted.startswith("random."):
                fn = dotted.split(".", 1)[1]
                if fn in _GLOBAL_RNG_FUNCS:
                    out.append(_Source(node, f"global RNG `{dotted}()`"))
                elif fn == "Random" and not node.args and not node.keywords:
                    out.append(_Source(
                        node, "unseeded `random.Random()` (OS-entropy)"))
            elif (isinstance(node.func, ast.Name)
                    and node.func.id == "id" and len(node.args) == 1):
                out.append(_Source(node, "`id(...)` (per-process address)"))
            elif isinstance(node.func, ast.Name) and rng_alias(node.func.id):
                out.append(_Source(
                    node, f"global RNG `{node.func.id}()` (from random)"))
            elif (isinstance(node.func, ast.Name)
                    and node.func.id in _ORDER_SENSITIVE_FUNCS
                    and node.args
                    and id(node) not in sorted_wrapped
                    and _is_set_expr(node.args[0], set_locals)):
                out.append(_Source(
                    node, f"`{node.func.id}(<set>)` materializes "
                          "unordered set iteration"))
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "join" and node.args
                    and id(node) not in sorted_wrapped
                    and _is_set_expr(node.args[0], set_locals)):
                out.append(_Source(
                    node, "`.join(<set>)` serializes unordered set "
                          "iteration"))
        elif isinstance(node, ast.Subscript):
            if absolute(dotted_name(node.value)) == "os.environ":
                out.append(_Source(node, "environment read `os.environ[...]`"))
        elif isinstance(node, ast.For):
            if (id(node.iter) not in sorted_wrapped
                    and _is_set_expr(node.iter, set_locals)
                    and _loop_is_order_sensitive(node)):
                out.append(_Source(
                    node, "order-sensitive `for` over an unordered set"))
        elif isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            gen = node.generators[0] if node.generators else None
            if (gen is not None and id(gen.iter) not in sorted_wrapped
                    and id(node) not in sorted_wrapped
                    and _is_set_expr(gen.iter, set_locals)):
                out.append(_Source(
                    node, "comprehension over an unordered set"))
    return out


def _func_basename(qualname: str) -> str:
    """'pkg.mod:Class.meth' -> 'meth'; 'pkg.mod:func' -> 'func'."""
    return qualname.rsplit(":", 1)[-1].rsplit(".", 1)[-1]


def _is_sink_call(site: CallSite) -> Optional[str]:
    """Sink name if this call lands in a consensus-order sink.  Matches
    by resolved qualname when the graph resolved the call, and by the
    raw trailing name otherwise — a vendored/fixture `consensus_sort`
    or a `.schedule_fingerprint()` on an unresolvable receiver still
    counts (unresolved must never read as safe)."""
    for q in site.callees:
        base = _func_basename(q)
        if base in SINK_FUNCS or base in SINK_ATTRS:
            return base
    last = site.text.rsplit(".", 1)[-1]
    if last in SINK_FUNCS or last in SINK_ATTRS:
        return last
    return None


class _TaintState:
    """Project-wide fixpoint, computed once and shared by every
    per-file check() call of the same run."""

    def __init__(self, project: ProjectContext):
        self.sources: Dict[str, List[_Source]] = {}
        self.nondet: Set[str] = set()
        self.sink_reaching: Set[str] = set()
        #: witness edges: f -> (callee, site) explaining membership
        self.nondet_via: Dict[str, Tuple[str, CallSite]] = {}
        self.sink_via: Dict[str, str] = {}
        self._functions = project.functions
        self._compute(project)

    def _compute(self, project: ProjectContext) -> None:
        for qual, fi in project.functions.items():
            mod = project.modules.get(fi.module)
            aliases = mod.aliases if mod else {}
            srcs = _collect_sources(fi, aliases)
            if srcs:
                self.sources[qual] = srcs
                self.nondet.add(qual)
            if fi.name in SINK_FUNCS:
                self.sink_reaching.add(qual)
                self.sink_via[qual] = f"is sink `{fi.name}`"
            else:
                for site in fi.calls:
                    sink = _is_sink_call(site)
                    if sink is not None:
                        self.sink_reaching.add(qual)
                        self.sink_via[qual] = f"calls sink `{sink}`"
                        break
        callers = project.callers()
        self._propagate(self.nondet, callers, self.nondet_via)
        self._propagate_sink(project)

    @staticmethod
    def _propagate(seed: Set[str], callers, via) -> None:
        queue = list(seed)
        while queue:
            g = queue.pop()
            for caller, site in callers.get(g, ()):
                if caller not in seed:
                    seed.add(caller)
                    via[caller] = (g, site)
                    queue.append(caller)

    def _propagate_sink(self, project: ProjectContext) -> None:
        callers = project.callers()
        queue = list(self.sink_reaching)
        while queue:
            g = queue.pop()
            gname = g.rsplit(":", 1)[-1]
            for caller, _site in callers.get(g, ()):
                if caller not in self.sink_reaching:
                    self.sink_reaching.add(caller)
                    self.sink_via[caller] = f"reaches sink via `{gname}`"
                    queue.append(caller)

    def source_chain(self, qual: str) -> Tuple[str, _Source]:
        """Walk witness edges down to a concrete source expression.
        The via chain is acyclic by construction (an edge is recorded
        only when a function first enters the nondet set) and always
        ends at a function with direct sources; the seen-guard and
        def-line fallback below keep a future invariant slip from
        crashing the whole lint run."""
        hops: List[str] = []
        q = qual
        seen: Set[str] = set()
        while (q not in self.sources and q in self.nondet_via
               and q not in seen):
            seen.add(q)
            nxt, _site = self.nondet_via[q]
            hops.append(nxt.rsplit(":", 1)[-1])
            q = nxt
        shown = hops if len(hops) <= 6 else hops[:6] + ["..."]
        chain = " -> ".join(shown) if shown else ""
        src = self.sources.get(q)
        if src:
            return chain, src[0]
        fi = self._functions.get(q)
        node = (fi.node if fi is not None
                else ast.Pass(lineno=0, col_offset=0))
        return chain, _Source(node, "a nondeterministic input")


class ConsensusNondeterminismRule(Rule):
    name = "consensus-nondeterminism"
    description = (
        "nondeterministic input (wall clock outside Core.now_ns, global "
        "RNG, os.urandom, id(), env read, unordered set iteration) "
        "inside or feeding a function that reaches a consensus-order "
        "sink (consensus_sort / event hashing / checkpoint "
        "serialization / schedule_fingerprint) — honest nodes must "
        "compute identical orders from identical DAGs"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project: ProjectContext = ctx.project
        state = getattr(project, "_determinism_state", None)
        if state is None:
            state = _TaintState(project)
            project._determinism_state = state
        for qual, fi in project.functions.items():
            if fi.path != ctx.path or qual not in state.sink_reaching:
                continue
            why_sink = state.sink_via.get(qual, "reaches a sink")
            for src in state.sources.get(qual, ()):
                yield self.finding(
                    ctx, src.node,
                    f"{src.label} inside `{fi.name}`, which {why_sink} — "
                    "consensus inputs must be pure functions of the DAG "
                    "and the seed (route clocks through Core.now_ns, "
                    "RNG through a seeded stream, sort set iteration)",
                )
            for site in fi.calls:
                frontier = [
                    c for c in site.callees
                    if c in state.nondet and c not in state.sink_reaching
                ]
                if not frontier:
                    continue
                g = frontier[0]
                chain, src = state.source_chain(g)
                gname = g.rsplit(":", 1)[-1]
                hop = f"{gname}" + (f" -> {chain}" if chain else "")
                yield self.finding(
                    ctx, site.node,
                    f"`{site.text}(...)` taints `{fi.name}` with "
                    f"{src.label} (via {hop}, line {src.node.lineno}), "
                    f"and `{fi.name}` {why_sink} — a nondet value this "
                    "close to the commit path diverges honest nodes",
                )
