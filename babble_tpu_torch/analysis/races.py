"""Asyncio shared-state race detection.

The gossip runtime (node/node.py, net/, fleet.py) is single-threaded
asyncio, so races here are not data races but *interleaving* races:
every ``await`` is a scheduling point where another coroutine of the
same node may run and observe or overwrite shared attributes.  The bug
shape this rule targets: a coroutine mutates ``self.x``, awaits, then
mutates ``self.x`` again — between the two writes the object is in a
state the author thought was private, and a second task entering the
same method corrupts it (lost updates, double-drains, torn multi-field
invariants).

A write is exempt when it happens under a held lock — any ``with`` /
``async with`` whose context expression mentions ``lock`` or ``mutex``
in an attribute/variable name (``async with self.core_lock:``).  The
await itself may be inside or outside the lock: holding a lock across
an await still yields the loop, but other writers of the same attr are
excluded, which is the invariant that matters.

**Interprocedural (v2)**: a call to ``self.helper(...)`` counts as a
write of every attribute in the helper's *transitive unlocked
self-write closure* (graph.ProjectContext.self_write_closure), at the
call site, under the caller's lock context.  Extracting the mutation
into a method no longer blinds the rule:

    async def refill(self):
        self._reset()            # _reset writes self.level -> "write"
        await self.pump.fill()
        self._reset()            # second write across the await: race

Helper writes performed under the helper's OWN lock are excluded from
the closure (they are serialized against other writers), which keeps
``_process_sync_response``-style lock-everything helpers clean.

Heuristic boundaries: statements are linearized in source order (a
write in an ``if`` arm counts as "before" a later await even when the
branch is not taken at runtime), and lock detection is by name.  Both
favor recall: a false positive documents itself with a named
suppression; a missed race corrupts a node.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Tuple

from .engine import FileContext, Finding, Rule
from .graph import names_lock as _names_lock

# event: (kind, attr, node, locked, via) where via is the helper method
# name for closure-derived writes ("" for direct writes/awaits)
_Event = Tuple[str, str, ast.AST, bool, str]


class AwaitStateRaceRule(Rule):
    name = "await-state-race"
    description = (
        "coroutine mutates the same self.<attr> both before and after "
        "an await without holding a lock — directly or via called "
        "helpers — another task can interleave at the await and "
        "observe/clobber the intermediate state"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        # class membership for self-call resolution: direct methods only
        # (a nested async def is its own schedule and owns no `self`)
        method_cls: Dict[int, str] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, ast.AsyncFunctionDef):
                        method_cls[id(sub)] = node.name
        project = getattr(ctx, "project", None)
        module = (project.path_module.get(ctx.path)
                  if project is not None else None)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.AsyncFunctionDef):
                yield from self._check_coroutine(
                    ctx, node, project, module, method_cls.get(id(node)))

    def _helper_writes(self, project, module: Optional[str],
                       cls: Optional[str], method: str) -> frozenset:
        """Transitive unlocked self-write set of self.<method>()."""
        if project is None or module is None or cls is None:
            return frozenset()
        qual = project.lookup_method((module, cls), method)
        if qual is None:
            return frozenset()
        return frozenset(project.self_write_closure(qual))

    def _check_coroutine(
        self, ctx: FileContext, fn: ast.AsyncFunctionDef,
        project, module: Optional[str], cls: Optional[str],
    ) -> Iterator[Finding]:
        self._project = project
        self._module = module
        self._cls = cls
        events: List[_Event] = []
        self._collect(fn.body, locked=False, events=events)

        seen_await_after_write: Dict[str, ast.AST] = {}
        pending: Dict[str, ast.AST] = {}
        for kind, attr, node, locked, via in events:
            if kind == "await":
                for a, n in pending.items():
                    seen_await_after_write.setdefault(a, n)
                pending.clear()
                continue
            if locked:
                continue
            if attr in seen_await_after_write:
                how = (f" (write via call to `self.{via}()`)" if via
                       else "")
                yield self.finding(
                    ctx, node,
                    f"self.{attr} is written both before (line "
                    f"{seen_await_after_write[attr].lineno}) and after an "
                    f"await in `{fn.name}` without a lock{how} — an "
                    "interleaving task sees the intermediate state",
                )
                # report once per attr per coroutine
                del seen_await_after_write[attr]
                continue
            pending.setdefault(attr, node)

    def _collect(self, body: List[ast.stmt], locked: bool,
                 events: List[_Event]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested scopes have their own schedule
            self._collect_stmt(stmt, locked, events)

    def _awaits_in(self, expr: ast.AST, locked: bool,
                   events: List[_Event]) -> None:
        for node in ast.walk(expr):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.Await):
                events.append(("await", "", node, locked, ""))

    def _self_calls_in(self, expr: ast.AST, locked: bool,
                       events: List[_Event]) -> None:
        """Closure-derived writes: `self.m(...)` writes everything m
        (transitively) writes on self outside a lock."""
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"):
                for attr in sorted(self._helper_writes(
                        self._project, self._module, self._cls,
                        node.func.attr)):
                    events.append(
                        ("write", attr, node, locked, node.func.attr))
            stack.extend(ast.iter_child_nodes(node))

    def _collect_stmt(self, stmt: ast.stmt, locked: bool,
                      events: List[_Event]) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._awaits_in(item.context_expr, locked, events)
                self._self_calls_in(item.context_expr, locked, events)
            if isinstance(stmt, ast.AsyncWith):
                # `async with x:` awaits __aenter__ even without an
                # explicit Await node in the source
                events.append(("await", "", stmt, locked, ""))
            inner_locked = locked or any(
                _names_lock(item.context_expr) for item in stmt.items
            )
            self._collect(stmt.body, inner_locked, events)
        elif isinstance(stmt, (ast.If, ast.While)):
            self._awaits_in(stmt.test, locked, events)
            self._self_calls_in(stmt.test, locked, events)
            self._collect(stmt.body, locked, events)
            self._collect(stmt.orelse, locked, events)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._awaits_in(stmt.iter, locked, events)
            self._self_calls_in(stmt.iter, locked, events)
            if isinstance(stmt, ast.AsyncFor):
                events.append(("await", "", stmt, locked, ""))
            self._collect(stmt.body, locked, events)
            self._collect(stmt.orelse, locked, events)
        elif isinstance(stmt, ast.Try):
            self._collect(stmt.body, locked, events)
            for h in stmt.handlers:
                self._collect(h.body, locked, events)
            self._collect(stmt.orelse, locked, events)
            self._collect(stmt.finalbody, locked, events)
        else:
            # simple statement: awaits evaluate before the binding lands
            self._awaits_in(stmt, locked, events)
            self._self_calls_in(stmt, locked, events)
            if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                for t in targets:
                    self._collect_write(t, stmt, locked, events)

    def _collect_write(self, target: ast.AST, stmt: ast.stmt, locked: bool,
                       events: List[_Event]) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._collect_write(elt, stmt, locked, events)
        elif isinstance(target, ast.Starred):
            self._collect_write(target.value, stmt, locked, events)
        elif (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"):
            events.append(("write", target.attr, stmt, locked, ""))
