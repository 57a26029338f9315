"""Consensus host-state invariant rules.

Two bug classes that have each produced a real defect in this tree:

``drain-before-validate`` — the wide_engine.flush shape: a method
drains a consuming queue (``take_pending()``, ``pop()``, ``clear()``)
and only *afterwards* runs a guard that raises.  When the guard fires,
the drained items are gone but were never processed: the engine
survives the exception with silently corrupted state (events that
exist in the host DAG but will never reach the device window).  The
fix shape is always the same — compute the bound from the un-drained
source and raise first — so the rule flags any raise-guard that
follows a draining call in the same statement block.

``falsy-or-fallback`` — the checkpoint.py policy shape:
``cfg.get(key, default) or default`` returns ``default`` when the
caller explicitly configured ``0``/``""``/``False``.  Config plumbing
must distinguish "unset" from "explicitly falsy"; the rule flags any
``or`` whose left side is a two-argument ``.get`` call and whose right
side is structurally identical to the ``.get`` default.
"""

from __future__ import annotations

import ast
from typing import Iterator, List

from .engine import FileContext, Finding, Rule

# methods that consume their receiver's state when called
_DRAIN_METHODS = {"take_pending", "drop_pending", "pop", "popleft",
                  "clear", "drain"}


def _self_rooted(node: ast.AST) -> bool:
    """Is this expression an attribute chain rooted at ``self``?  The
    rule only fires for draining *instance* state: popping a local
    temp is not the bug class (nothing outlives the exception)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return isinstance(node, ast.Name) and node.id == "self"


def _drain_call(stmt: ast.stmt):
    """The draining Call in this simple statement, if any."""
    for node in ast.walk(stmt):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _DRAIN_METHODS
                and _self_rooted(node.func.value)):
            return node
    return None


def _is_raise_guard(stmt: ast.stmt) -> bool:
    """``if <cond>: raise ...`` with nothing else in the body — the
    canonical capacity/bounds check shape."""
    return (isinstance(stmt, ast.If)
            and len(stmt.body) == 1
            and isinstance(stmt.body[0], ast.Raise)
            and not stmt.orelse)


class DrainBeforeValidateRule(Rule):
    name = "drain-before-validate"
    description = (
        "a consuming call (take_pending/pop/clear/...) on self-owned "
        "state precedes a raise-guard in the same block — if the guard "
        "fires, the drained items are lost and state is corrupted"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in ast.walk(ctx.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_block(ctx, fn.name, fn.body)

    def _check_block(self, ctx: FileContext, fname: str,
                     body: List[ast.stmt]) -> Iterator[Finding]:
        drained = None  # (call node, method name) of the first drain seen
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if drained is not None and _is_raise_guard(stmt):
                call, method = drained
                yield self.finding(
                    ctx, stmt,
                    f"guard raises after `{method}()` already drained "
                    f"state at line {call.lineno} in `{fname}` — "
                    "validate before mutating (or re-queue on failure)",
                )
                drained = None  # one finding per drain/guard pair
                continue
            call = None
            if not isinstance(stmt, (ast.If, ast.While, ast.For,
                                     ast.AsyncFor, ast.With, ast.AsyncWith,
                                     ast.Try)):
                call = _drain_call(stmt)
            if call is not None and drained is None:
                drained = (call, call.func.attr)
            # recurse into nested blocks with a fresh window: a guard
            # inside an `if` does not protect a drain outside it
            if isinstance(stmt, (ast.If, ast.While)):
                yield from self._check_block(ctx, fname, stmt.body)
                yield from self._check_block(ctx, fname, stmt.orelse)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                yield from self._check_block(ctx, fname, stmt.body)
                yield from self._check_block(ctx, fname, stmt.orelse)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                yield from self._check_block(ctx, fname, stmt.body)
            elif isinstance(stmt, ast.Try):
                yield from self._check_block(ctx, fname, stmt.body)
                for h in stmt.handlers:
                    yield from self._check_block(ctx, fname, h.body)
                yield from self._check_block(ctx, fname, stmt.orelse)
                yield from self._check_block(ctx, fname, stmt.finalbody)


class FalsyOrFallbackRule(Rule):
    name = "falsy-or-fallback"
    description = (
        "`cfg.get(key, default) or default` silently overrides an "
        "explicitly-configured 0/\"\"/False — use an is-None sentinel"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.BoolOp)
                    and isinstance(node.op, ast.Or)
                    and len(node.values) >= 2):
                continue
            left = node.values[0]
            if not (isinstance(left, ast.Call)
                    and isinstance(left.func, ast.Attribute)
                    and left.func.attr == "get"
                    and len(left.args) == 2
                    and not left.keywords):
                continue
            default_dump = ast.dump(left.args[1])
            for other in node.values[1:]:
                if ast.dump(other) == default_dump:
                    yield self.finding(
                        ctx, node,
                        "`.get(key, default) or default` drops an "
                        "explicit falsy value — check `is None` instead "
                        "so a configured 0/\"\" is honored",
                    )
                    break
