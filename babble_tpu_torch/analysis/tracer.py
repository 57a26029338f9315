"""JAX tracer-safety rules.

Inside a jitted function, traced values are abstract: Python ``if`` /
``while`` / ``for`` on them raises ``TracerBoolConversionError`` at
trace time in the best case and silently bakes in a constant in the
worst (when the branch condition happens to be concrete during one
trace and the function is retraced with different shapes).  Host syncs
(``.item()``, ``float(x)``, ``np.asarray(x)``) on tracers are always
errors.  These rules do a lightweight, file-local taint analysis:

- a function is *jitted* when decorated with ``jax.jit`` / ``pjit`` /
  ``partial(jax.jit, ...)``, or when the module wraps it by name in a
  ``jax.jit(fn, ...)`` call (the dominant idiom in ``ops/wide.py``);
- its parameters are traced except those named by ``static_argnums`` /
  ``static_argnames`` (and positions pre-bound through ``partial``);
- taint propagates through assignments; ``.shape`` / ``.dtype`` /
  ``.ndim`` / ``len()`` of a tracer are static and break the chain.

The analysis is file-local and heuristic by design: it cannot see
through dynamic dispatch, and it would rather miss an exotic case than
drown real kernels in noise — cross-checked by running the full rule
set over ``ops/`` in tier-1 (tests/test_static_analysis.py).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .engine import FileContext, Finding, Rule

_JIT_NAMES = {"jit", "pjit"}
# attribute reads on a tracer that yield static (host) values
_STATIC_ATTRS = {"shape", "dtype", "ndim", "size", "aval", "weak_type",
                 "sharding", "_fields"}
_HOST_SYNC_METHODS = {"item", "tolist", "block_until_ready"}
_HOST_SYNC_CASTS = {"float", "int", "bool", "complex"}
_NUMPY_MODULES = {"np", "numpy", "onp"}
_UNHASHABLE = (ast.List, ast.Set, ast.Dict, ast.ListComp, ast.SetComp,
               ast.DictComp, ast.GeneratorExp)


def _is_jit_ref(node: ast.AST) -> bool:
    """Does this expression denote jax.jit / jax.pjit / bare jit?"""
    if isinstance(node, ast.Name):
        return node.id in _JIT_NAMES
    if isinstance(node, ast.Attribute):
        return node.attr in _JIT_NAMES
    return False


def _is_partial_ref(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return node.id == "partial"
    if isinstance(node, ast.Attribute):
        return node.attr == "partial"
    return False


def _literal_ints(node: ast.AST) -> Optional[Set[int]]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List)):
        out: Set[int] = set()
        for elt in node.elts:
            if not (isinstance(elt, ast.Constant)
                    and isinstance(elt.value, int)):
                return None
            out.add(elt.value)
        return out
    return None


def _literal_strs(node: ast.AST) -> Optional[Set[str]]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List)):
        out: Set[str] = set()
        for elt in node.elts:
            if not (isinstance(elt, ast.Constant)
                    and isinstance(elt.value, str)):
                return None
            out.add(elt.value)
        return out
    return None


def _statics_from_call(call: ast.Call) -> Tuple[Set[int], Set[str]]:
    """static_argnums / static_argnames from a jit(...) or
    partial(jax.jit, ...) call's keywords."""
    nums: Set[int] = set()
    names: Set[str] = set()
    for kw in call.keywords:
        if kw.arg == "static_argnums":
            nums |= _literal_ints(kw.value) or set()
        elif kw.arg == "static_argnames":
            names |= _literal_strs(kw.value) or set()
    return nums, names


class _JitSpec:
    """How one FunctionDef is jitted: which params are non-traced."""

    def __init__(self, static_nums: Set[int], static_names: Set[str],
                 prebound: int):
        self.static_nums = static_nums
        self.static_names = static_names
        self.prebound = prebound


def _decorator_spec(fn: ast.FunctionDef) -> Optional[_JitSpec]:
    for dec in fn.decorator_list:
        if _is_jit_ref(dec):
            return _JitSpec(set(), set(), 0)
        if isinstance(dec, ast.Call):
            if _is_jit_ref(dec.func):
                nums, names = _statics_from_call(dec)
                return _JitSpec(nums, names, 0)
            if (_is_partial_ref(dec.func) and dec.args
                    and _is_jit_ref(dec.args[0])):
                nums, names = _statics_from_call(dec)
                return _JitSpec(nums, names, 0)
    return None


def _wrapped_specs(tree: ast.Module) -> Dict[str, _JitSpec]:
    """Functions jitted by name at a call site: ``jax.jit(fn, ...)``,
    ``jax.jit(partial(fn, a, b), ...)``, ``jax.jit(jax.vmap(fn))``."""
    specs: Dict[str, _JitSpec] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _is_jit_ref(node.func)
                and node.args):
            continue
        target = node.args[0]
        nums, names = _statics_from_call(node)
        prebound = 0
        if isinstance(target, ast.Call):
            if _is_partial_ref(target.func) and target.args:
                prebound = len(target.args) - 1
                target = target.args[0]
            elif target.args:
                # vmap/checkpoint-style wrapper: params pass through
                target = target.args[0]
        if isinstance(target, ast.Name):
            # static indices are positions of the callable jit actually
            # sees; partial pre-binding shifts them onto the inner fn
            specs[target.id] = _JitSpec(
                {i + prebound for i in nums}, names, prebound
            )
    return specs


def _iter_functions(tree: ast.Module):
    """Every FunctionDef with its enclosing-module visibility (nested
    functions are yielded too, so decorated inner defs are covered)."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


class _TaintScan:
    """One pass over a jitted function body.

    ``report=False`` only propagates taint through assignments (so a
    name bound late in a loop body taints earlier uses on the second
    pass); ``report=True`` emits findings."""

    def __init__(self, ctx: FileContext, fn: ast.FunctionDef,
                 spec: _JitSpec, branch_rule: "JitTracedBranchRule",
                 sync_rule: "JitHostSyncRule"):
        self.ctx = ctx
        self.fn = fn
        self.branch_rule = branch_rule
        self.sync_rule = sync_rule
        self.tainted: Set[str] = set()
        args = fn.args
        params = [a.arg for a in args.posonlyargs + args.args]
        for i, name in enumerate(params):
            if i < spec.prebound or i in spec.static_nums:
                continue
            if name in spec.static_names:
                continue
            self.tainted.add(name)
        for a in args.kwonlyargs:
            if a.arg not in spec.static_names:
                self.tainted.add(a.arg)

    # -- expression taint ------------------------------------------------

    def expr_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.expr_tainted(node.value)
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Name) and func.id == "len":
                return False  # len(tracer) is the static leading dim
            parts: List[ast.AST] = list(node.args)
            parts += [kw.value for kw in node.keywords]
            if isinstance(func, ast.Attribute):
                parts.append(func.value)
            return any(self.expr_tainted(p) for p in parts)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return False
        return any(
            self.expr_tainted(child)
            for child in ast.iter_child_nodes(node)
            if isinstance(child, ast.expr)
        )

    # -- statement walk --------------------------------------------------

    def run(self, report: bool) -> Iterator[Finding]:
        yield from self._walk(self.fn.body, report)

    def _taint_target(self, target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self.tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._taint_target(elt)
        elif isinstance(target, ast.Starred):
            self._taint_target(target.value)

    def _scan_calls(self, stmt: ast.AST) -> Iterator[Finding]:
        """Host-sync findings in one statement or expression subtree
        (callers pass compound statements' own expressions only)."""
        for node in ast.walk(stmt):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if (isinstance(func, ast.Attribute)
                    and func.attr in _HOST_SYNC_METHODS
                    and self.expr_tainted(func.value)):
                yield self.sync_rule.finding(
                    self.ctx, node,
                    f".{func.attr}() forces a host sync on a traced "
                    f"value inside jitted `{self.fn.name}`",
                )
            elif (isinstance(func, ast.Name)
                    and func.id in _HOST_SYNC_CASTS and node.args
                    and self.expr_tainted(node.args[0])):
                yield self.sync_rule.finding(
                    self.ctx, node,
                    f"{func.id}() concretizes a traced value inside "
                    f"jitted `{self.fn.name}`",
                )
            elif (isinstance(func, ast.Attribute)
                    and func.attr in ("asarray", "array")
                    and isinstance(func.value, ast.Name)
                    and func.value.id in _NUMPY_MODULES
                    and any(self.expr_tainted(a) for a in node.args)):
                yield self.sync_rule.finding(
                    self.ctx, node,
                    f"{func.value.id}.{func.attr}() pulls a traced value "
                    f"to host inside jitted `{self.fn.name}`",
                )

    def _walk(self, body: List[ast.stmt], report: bool) -> Iterator[Finding]:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested defs analyzed only via their own spec
            if report:
                # scan only THIS statement's own expressions — nested
                # block bodies are scanned when the recursion reaches
                # them, so scanning the whole subtree here would emit
                # each inner finding once per nesting level
                if isinstance(stmt, (ast.If, ast.While)):
                    yield from self._scan_calls(stmt.test)
                elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                    yield from self._scan_calls(stmt.iter)
                elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                    for item in stmt.items:
                        yield from self._scan_calls(item.context_expr)
                elif not isinstance(stmt, ast.Try):
                    yield from self._scan_calls(stmt)
            if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                value = stmt.value
                if value is not None and self.expr_tainted(value):
                    targets = (stmt.targets
                               if isinstance(stmt, ast.Assign)
                               else [stmt.target])
                    for t in targets:
                        self._taint_target(t)
            elif isinstance(stmt, (ast.If, ast.While)):
                if report and self.expr_tainted(stmt.test):
                    kind = "if" if isinstance(stmt, ast.If) else "while"
                    yield self.branch_rule.finding(
                        self.ctx, stmt,
                        f"Python `{kind}` on a traced value inside jitted "
                        f"`{self.fn.name}` — use jnp.where/lax.cond (or "
                        "mark the argument static)",
                    )
                yield from self._walk(stmt.body, report)
                yield from self._walk(stmt.orelse, report)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                if self.expr_tainted(stmt.iter):
                    if report:
                        yield self.branch_rule.finding(
                            self.ctx, stmt,
                            f"Python `for` iterates a traced value inside "
                            f"jitted `{self.fn.name}` — use lax.scan/"
                            "fori_loop",
                        )
                    self._taint_target(stmt.target)
                yield from self._walk(stmt.body, report)
                yield from self._walk(stmt.orelse, report)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                yield from self._walk(stmt.body, report)
            elif isinstance(stmt, ast.Try):
                yield from self._walk(stmt.body, report)
                for h in stmt.handlers:
                    yield from self._walk(h.body, report)
                yield from self._walk(stmt.orelse, report)
                yield from self._walk(stmt.finalbody, report)


def _jitted_functions(ctx: FileContext):
    wrapped = _wrapped_specs(ctx.tree)
    for fn in _iter_functions(ctx.tree):
        spec = _decorator_spec(fn)
        if spec is None:
            spec = wrapped.get(fn.name)
        if spec is not None:
            yield fn, spec


def _taint_findings(ctx: FileContext) -> List[Finding]:
    """Both tracer rules' findings from ONE taint scan per file.

    The branch and sync rules share the scan (taint propagation is
    identical for both), so the result is cached on the FileContext —
    each rule's ``check`` filters by its own name instead of re-walking
    every jitted function."""
    cached = getattr(ctx, "_tracer_taint_findings", None)
    if cached is None:
        branch, sync = JitTracedBranchRule(), JitHostSyncRule()
        cached = []
        for fn, spec in _jitted_functions(ctx):
            scan = _TaintScan(ctx, fn, spec, branch, sync)
            for _ in scan.run(report=False):
                pass  # first pass: taint fixup only
            cached.extend(scan.run(report=True))
        ctx._tracer_taint_findings = cached
    return cached


class JitTracedBranchRule(Rule):
    name = "jit-traced-branch"
    description = (
        "Python if/while/for control flow on a value derived from a "
        "traced argument inside a jitted function"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for f in _taint_findings(ctx):
            if f.rule == self.name:
                yield f


class JitHostSyncRule(Rule):
    name = "jit-host-sync"
    description = (
        ".item()/.tolist()/float()/np.asarray() on a traced value "
        "inside a jitted function (forces a device sync or fails to "
        "trace)"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for f in _taint_findings(ctx):
            if f.rule == self.name:
                yield f


class JitUnhashableStaticRule(Rule):
    name = "jit-unhashable-static"
    description = (
        "static_argnums/static_argnames passed a list/set/dict literal "
        "— statics are hashed per call; use a tuple"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            is_jit = _is_jit_ref(node.func)
            is_jit_partial = (_is_partial_ref(node.func) and node.args
                              and _is_jit_ref(node.args[0]))
            if not (is_jit or is_jit_partial):
                continue
            for kw in node.keywords:
                if kw.arg in ("static_argnums", "static_argnames") and \
                        isinstance(kw.value, _UNHASHABLE):
                    yield self.finding(
                        ctx, kw.value,
                        f"{kw.arg} should be an int/str or tuple, not a "
                        f"{type(kw.value).__name__.lower()} — jit hashes "
                        "statics on every call",
                    )
