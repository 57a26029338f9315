"""Lock/guard discipline: ``held-guard-escape``.

``asyncio.Lock`` is not reentrant.  The gossip loop serializes all core
access behind ``self.core_lock``; the discipline that keeps it
deadlock-free is purely conventional — helpers that run under the lock
(``_run_consensus_locked``) must never acquire it, and their docstrings
say so.  Nothing enforced it: move one ``async with self.core_lock``
into a helper that is also called from a locked context and the node
freezes forever on its own lock, with no traceback (the chaos tier
would find it as a liveness violation, minutes later, per seed).

This rule enforces the convention statically, project-wide: inside the
body of a ``with``/``async with`` on a lockish ``self.<attr>``
(``lock``/``mutex``/``sem`` word segments — the same naming heuristic
the race rule uses), any call to ``self.m(...)`` whose *transitive
guard closure* (graph.ProjectContext.guard_closure) re-acquires the
same attribute is a finding.  The closure walks ``self.m()`` edges
only: a method of a DIFFERENT object acquiring its own ``core_lock``
is that object's (distinct) lock, not a re-entry.

The rule checks sync and async functions alike — a sync helper cannot
await, but it can call a coroutine-returning factory or be refactored
async later; flagging the call-under-guard is cheap insurance either
way.  Re-entry through unresolved calls (callbacks, getattr dispatch)
is invisible; the rule's contract is "the resolvable part of the graph
is clean", not "no deadlock exists".
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

from .engine import FileContext, Finding, Rule
from .graph import lockish_name


class HeldGuardEscapeRule(Rule):
    name = "held-guard-escape"
    description = (
        "a call made while holding a lockish self.<attr> guard reaches "
        "a method that re-acquires the same guard (directly or through "
        "its call chain) — asyncio locks are not reentrant; the task "
        "deadlocks on itself"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project = getattr(ctx, "project", None)
        if project is None:
            return
        module = project.path_module.get(ctx.path)
        if module is None:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield from self._check_function(
                        ctx, project, module, node.name, sub)

    def _check_function(self, ctx, project, module: str, cls: str,
                        fn) -> Iterator[Finding]:
        yield from self._walk(ctx, project, module, cls, fn.name,
                              fn.body, held=frozenset())

    def _walk(self, ctx, project, module: str, cls: str, fname: str,
              body: List[ast.stmt], held: frozenset) -> Iterator[Finding]:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # own schedule, own (future) guard context
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                acquired: Set[str] = set()
                for item in stmt.items:
                    cx = item.context_expr
                    if (isinstance(cx, ast.Attribute)
                            and isinstance(cx.value, ast.Name)
                            and cx.value.id == "self"
                            and lockish_name(cx.attr)):
                        acquired.add(cx.attr)
                    yield from self._calls_in(
                        ctx, project, module, cls, fname, cx, held)
                yield from self._walk(ctx, project, module, cls, fname,
                                      stmt.body, held | acquired)
            elif isinstance(stmt, (ast.If, ast.While)):
                yield from self._calls_in(
                    ctx, project, module, cls, fname, stmt.test, held)
                yield from self._walk(ctx, project, module, cls, fname,
                                      stmt.body, held)
                yield from self._walk(ctx, project, module, cls, fname,
                                      stmt.orelse, held)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                yield from self._calls_in(
                    ctx, project, module, cls, fname, stmt.iter, held)
                yield from self._walk(ctx, project, module, cls, fname,
                                      stmt.body, held)
                yield from self._walk(ctx, project, module, cls, fname,
                                      stmt.orelse, held)
            elif isinstance(stmt, ast.Try):
                yield from self._walk(ctx, project, module, cls, fname,
                                      stmt.body, held)
                for h in stmt.handlers:
                    yield from self._walk(ctx, project, module, cls,
                                          fname, h.body, held)
                yield from self._walk(ctx, project, module, cls, fname,
                                      stmt.orelse, held)
                yield from self._walk(ctx, project, module, cls, fname,
                                      stmt.finalbody, held)
            else:
                yield from self._calls_in(
                    ctx, project, module, cls, fname, stmt, held)

    def _calls_in(self, ctx, project, module: str, cls: str, fname: str,
                  expr: ast.AST, held: frozenset) -> Iterator[Finding]:
        if not held:
            return
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
                meth = node.func.attr
                qual = project.lookup_method((module, cls), meth)
                if qual is not None:
                    reacquired = held & project.guard_closure(qual)
                    for g in sorted(reacquired):
                        yield self.finding(
                            ctx, node,
                            f"`self.{meth}(...)` re-acquires "
                            f"`self.{g}` already held by `{fname}` — "
                            "asyncio locks are not reentrant; the task "
                            "deadlocks on itself (pass control in "
                            "already-locked form, like "
                            "`_run_consensus_locked`)",
                        )
            stack.extend(ast.iter_child_nodes(node))
