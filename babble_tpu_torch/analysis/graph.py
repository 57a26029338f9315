"""Project-wide symbol table + call graph for flow-aware rules.

babble-lint v1 was a per-file rule runner: every rule saw one AST and
nothing else.  The defect classes the chaos tier keeps finding at
runtime (ROADMAP: premature intra-round finality, crash-recovery
amnesia) are exactly the ones that *cross* function and module
boundaries — a wall-clock read two helpers away from the commit path,
an attribute mutated by a callee across an ``await``, a lock re-entered
through a call chain.  This module is the shared substrate those rules
stand on: parse every file once, build a module-level symbol table, and
resolve calls into a project call graph.

What resolves (deliberately static and syntactic — no imports are
executed, the analysis stays stdlib-only and safe on broken trees):

- free functions of the same module, and names bound by ``import`` /
  ``from ... import`` (absolute or relative, module- or
  function-level);
- ``self.m(...)`` to the enclosing class's method, walking base classes
  project-wide (``WideHashgraph(TpuHashgraph)`` resolves inherited
  helpers);
- ``self.attr.m(...)`` through *constructor-assignment attr typing*:
  ``self.hg = WideHashgraph(...)`` in any method (or an annotated
  ``self.hg: TpuHashgraph``) types the attribute; a conditionally
  assigned attr carries the UNION of candidate classes and a call edge
  to each — over-approximation in the direction that favors recall;
- ``alias.func(...)`` where the alias names a project module.

Everything else (locals, higher-order callables, ``**kwargs``
dispatch) is an unresolved call: rules must treat unresolved edges as
"no information", never as "safe".

On top of the raw graph, two same-object closures that the
interprocedural race and guard rules consume:

- :meth:`ProjectContext.self_write_closure` — attrs a method writes on
  ``self`` *outside any lockish ``with``*, unioned over the methods it
  (transitively) calls on ``self``;
- :meth:`ProjectContext.guard_closure` — lockish ``self.<attr>``
  guards a method acquires, unioned the same way.

Both propagate only through ``self.m()`` edges: a helper called on a
DIFFERENT object mutates that object's state and holds that object's
locks, which is a different invariant.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

_LOCKISH = {"lock", "mutex", "sem", "semaphore"}
# identifier -> words: snake_case segments and camelCase humps, so
# `core_lock`/`coreLock` match but `block_writer`/`unblock` do not
WORD_RE = re.compile(r"[A-Z]?[a-z0-9]+|[A-Z]+(?![a-z])")


def lockish_name(name: str) -> bool:
    return any(w.lower() in _LOCKISH for w in WORD_RE.findall(name))


def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` -> "a.b.c"; anything non-trivial -> ""."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def module_name_for(path: str) -> str:
    """Dotted module name, rooted at the outermost package directory
    (the first ancestor without an ``__init__.py``).  A file outside
    any package (lint fixtures) is just its stem — fixture modules can
    then import each other by stem when linted together."""
    path = os.path.abspath(path)
    stem = os.path.splitext(os.path.basename(path))[0]
    parts = [] if stem == "__init__" else [stem]
    d = os.path.dirname(path)
    while os.path.isfile(os.path.join(d, "__init__.py")):
        parts.append(os.path.basename(d))
        d = os.path.dirname(d)
    return ".".join(reversed(parts)) or stem


@dataclass
class CallSite:
    """One call expression inside a function, with its resolution."""

    node: ast.Call
    text: str                       # dotted source text ("self.core.sync")
    callees: Tuple[str, ...] = ()   # resolved qualnames (union over attr types)
    via_self: bool = False          # `self.m(...)` — same-object method call


@dataclass
class FunctionInfo:
    qualname: str                   # "pkg.mod:Class.meth" | "pkg.mod:func"
    module: str
    cls: Optional[str]
    name: str
    path: str
    node: ast.AST                   # FunctionDef | AsyncFunctionDef
    is_async: bool = False
    calls: List[CallSite] = field(default_factory=list)
    #: attrs written on self OUTSIDE any lockish with-block
    self_writes_unlocked: Set[str] = field(default_factory=set)
    #: method names called on self OUTSIDE any lockish with-block —
    #: the only edges the write closure propagates through (a helper
    #: invoked under the caller's lock is serialized, like a direct
    #: locked write)
    self_calls_unlocked: Set[str] = field(default_factory=set)
    #: lockish self.<attr> guards acquired via with / async with
    guards: Set[str] = field(default_factory=set)


@dataclass
class ClassInfo:
    module: str
    name: str
    methods: Dict[str, str] = field(default_factory=dict)   # name -> qualname
    base_refs: List[str] = field(default_factory=list)      # raw dotted refs
    #: self.<attr> -> candidate class keys, from constructor assignments
    attr_types: Dict[str, Set[Tuple[str, str]]] = field(default_factory=dict)
    #: class-body annotated field names, in declaration order — for
    #: NamedTuple-derived classes this IS the constructor signature,
    #: which the device-plane coverage rules diff against partition
    #: specs and the bytes-traffic model
    fields: List[str] = field(default_factory=list)

    @property
    def key(self) -> Tuple[str, str]:
        return (self.module, self.name)

    @property
    def is_namedtuple(self) -> bool:
        return any(ref == "NamedTuple" or ref.endswith(".NamedTuple")
                   for ref in self.base_refs)


@dataclass
class ModuleInfo:
    name: str
    path: str
    tree: ast.Module
    #: local name -> absolute dotted target (module, module.func, ...)
    aliases: Dict[str, str] = field(default_factory=dict)
    functions: Dict[str, str] = field(default_factory=dict)  # name -> qualname
    classes: Dict[str, ClassInfo] = field(default_factory=dict)


def names_lock(node: ast.AST) -> bool:
    """Does this with-context expression look like a lock acquisition?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and lockish_name(sub.attr):
            return True
        if isinstance(sub, ast.Name) and lockish_name(sub.id):
            return True
    return False


class ProjectContext:
    """Symbol table + call graph over a set of parsed files.

    Built once per lint run by the engine and attached to every
    FileContext as ``ctx.project``; a single-file check gets a
    single-file project, so rules never need a "no project" branch —
    they just resolve less."""

    def __init__(self, files: Iterable[Tuple[str, ast.Module]]):
        self.modules: Dict[str, ModuleInfo] = {}
        self.path_module: Dict[str, str] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[Tuple[str, str], ClassInfo] = {}
        for path, tree in files:
            name = module_name_for(path)
            mod = ModuleInfo(name=name, path=path, tree=tree)
            # last writer wins on duplicate module names (shadowed
            # fixtures); real packages are unique by construction
            self.modules[name] = mod
            self.path_module[path] = name
        for mod in list(self.modules.values()):
            self._scan_module(mod)
        for mod in list(self.modules.values()):
            self._scan_bodies(mod)
        self._write_closure_cache: Dict[str, Set[str]] = {}
        self._guard_closure_cache: Dict[str, Set[str]] = {}
        self._callers: Optional[Dict[str, List[Tuple[str, CallSite]]]] = None

    # ------------------------------------------------------------------
    # pass 1: symbols + imports

    def _scan_module(self, mod: ModuleInfo) -> None:
        # imports anywhere in the module (function-local imports are the
        # house idiom for jax-optional modules); binding them
        # module-wide over-approximates visibility, which only ever
        # ADDS resolution
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else local
                    mod.aliases.setdefault(local, target)
            elif isinstance(node, ast.ImportFrom):
                base = self._import_base(mod.name, node.level, node.module)
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    target = f"{base}.{alias.name}" if base else alias.name
                    mod.aliases.setdefault(local, target)
        for stmt in mod.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._register_function(mod, None, stmt)
            elif isinstance(stmt, ast.ClassDef):
                ci = ClassInfo(module=mod.name, name=stmt.name)
                ci.base_refs = [dotted_name(b) for b in stmt.bases
                                if dotted_name(b)]
                mod.classes[stmt.name] = ci
                self.classes[ci.key] = ci
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self._register_function(mod, ci, sub)
                    elif (isinstance(sub, ast.AnnAssign)
                            and isinstance(sub.target, ast.Name)):
                        ci.fields.append(sub.target.id)

    @staticmethod
    def _import_base(module: str, level: int,
                     target: Optional[str]) -> str:
        if level == 0:
            return target or ""
        parts = module.split(".")
        base = ".".join(parts[:-level]) if level <= len(parts) else ""
        if target:
            base = f"{base}.{target}" if base else target
        return base

    def _register_function(self, mod: ModuleInfo, ci: Optional[ClassInfo],
                           node) -> None:
        if ci is None:
            qual = f"{mod.name}:{node.name}"
            mod.functions[node.name] = qual
        else:
            qual = f"{mod.name}:{ci.name}.{node.name}"
            ci.methods[node.name] = qual
        self.functions[qual] = FunctionInfo(
            qualname=qual, module=mod.name,
            cls=ci.name if ci else None, name=node.name,
            path=mod.path, node=node,
            is_async=isinstance(node, ast.AsyncFunctionDef),
        )

    # ------------------------------------------------------------------
    # pass 2: bodies (calls, writes, guards, attr types)

    def _scan_bodies(self, mod: ModuleInfo) -> None:
        for qual, fi in self.functions.items():
            if fi.module != mod.name:
                continue
            self._scan_function(mod, fi)

    def _scan_function(self, mod: ModuleInfo, fi: FunctionInfo) -> None:
        # calls: the full subtree, nested defs included — a closure's
        # call usually runs within its owner's dynamic extent, and
        # taint propagation wants recall
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Call):
                fi.calls.append(self._resolve_call(mod, fi, node))
        # writes + guards: linearized schedule semantics — nested defs
        # are pruned (they execute on their own schedule), lock context
        # is tracked through with-blocks
        self._collect_writes(fi.node.body, fi, locked=False)
        # constructor-assignment attr typing for the enclosing class
        if fi.cls is not None:
            ci = self.classes[(fi.module, fi.cls)]
            for node in ast.walk(fi.node):
                self._collect_attr_type(mod, ci, node)

    def _collect_writes(self, body, fi: FunctionInfo, locked: bool) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    ctx = item.context_expr
                    if (isinstance(ctx, ast.Attribute)
                            and isinstance(ctx.value, ast.Name)
                            and ctx.value.id == "self"
                            and lockish_name(ctx.attr)):
                        fi.guards.add(ctx.attr)
                    self._note_self_calls(ctx, fi, locked)
                inner = locked or any(
                    names_lock(i.context_expr) for i in stmt.items)
                self._collect_writes(stmt.body, fi, inner)
            elif isinstance(stmt, (ast.If, ast.While)):
                self._note_self_calls(stmt.test, fi, locked)
                self._collect_writes(stmt.body, fi, locked)
                self._collect_writes(stmt.orelse, fi, locked)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._note_self_calls(stmt.iter, fi, locked)
                self._collect_writes(stmt.body, fi, locked)
                self._collect_writes(stmt.orelse, fi, locked)
            elif isinstance(stmt, ast.Try):
                self._collect_writes(stmt.body, fi, locked)
                for h in stmt.handlers:
                    self._collect_writes(h.body, fi, locked)
                self._collect_writes(stmt.orelse, fi, locked)
                self._collect_writes(stmt.finalbody, fi, locked)
            else:
                self._note_self_calls(stmt, fi, locked)
                if locked or not isinstance(
                        stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    continue
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                for t in targets:
                    self._collect_write_target(t, fi)

    def _note_self_calls(self, expr: ast.AST, fi: FunctionInfo,
                         locked: bool) -> None:
        if locked:
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
                fi.self_calls_unlocked.add(node.func.attr)
            stack.extend(ast.iter_child_nodes(node))

    def _collect_write_target(self, target: ast.AST,
                              fi: FunctionInfo) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._collect_write_target(elt, fi)
        elif isinstance(target, ast.Starred):
            self._collect_write_target(target.value, fi)
        elif (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"):
            fi.self_writes_unlocked.add(target.attr)

    def _collect_attr_type(self, mod: ModuleInfo, ci: ClassInfo,
                           node: ast.AST) -> None:
        tref = None
        attr = None
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            tref = dotted_name(node.value.func)
            for t in node.targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    attr = t.attr
        elif (isinstance(node, ast.AnnAssign)
                and isinstance(node.target, ast.Attribute)
                and isinstance(node.target.value, ast.Name)
                and node.target.value.id == "self"):
            tref = dotted_name(node.annotation)
            attr = node.target.attr
        if not tref or attr is None:
            return
        key = self._resolve_class(mod, tref)
        if key is not None:
            ci.attr_types.setdefault(attr, set()).add(key)

    # ------------------------------------------------------------------
    # resolution

    def _resolve_class(self, mod: ModuleInfo,
                       dotted: str) -> Optional[Tuple[str, str]]:
        kind, val = self._resolve_dotted(mod, dotted)
        return val if kind == "class" else None

    def _resolve_dotted(self, mod: ModuleInfo, dotted: str):
        """-> ("func", qualname) | ("class", key) | ("module", name)
        | (None, None)."""
        parts = dotted.split(".")
        head = parts[0]
        if len(parts) == 1:
            if head in mod.functions:
                return "func", mod.functions[head]
            if head in mod.classes:
                return "class", mod.classes[head].key
        if head in mod.aliases:
            absolute = ".".join([mod.aliases[head]] + parts[1:])
        else:
            absolute = dotted
        return self._resolve_absolute(absolute)

    def _resolve_absolute(self, dotted: str):
        parts = dotted.split(".")
        for cut in range(len(parts), 0, -1):
            mname = ".".join(parts[:cut])
            target = self.modules.get(mname)
            if target is None:
                continue
            rest = parts[cut:]
            if not rest:
                return "module", mname
            if len(rest) == 1:
                if rest[0] in target.functions:
                    return "func", target.functions[rest[0]]
                if rest[0] in target.classes:
                    return "class", target.classes[rest[0]].key
            elif len(rest) == 2 and rest[0] in target.classes:
                meth = self.lookup_method(target.classes[rest[0]].key,
                                          rest[1])
                if meth:
                    return "func", meth
            return None, None
        return None, None

    def lookup_method(self, cls_key: Tuple[str, str],
                      name: str) -> Optional[str]:
        """Method resolution walking base classes project-wide."""
        seen: Set[Tuple[str, str]] = set()
        queue = [cls_key]
        while queue:
            key = queue.pop(0)
            if key in seen:
                continue
            seen.add(key)
            ci = self.classes.get(key)
            if ci is None:
                continue
            if name in ci.methods:
                return ci.methods[name]
            mod = self.modules.get(ci.module)
            if mod is None:
                continue
            for ref in ci.base_refs:
                base = self._resolve_class(mod, ref)
                if base is not None:
                    queue.append(base)
        return None

    def attr_types_of(self, module: str, cls: str,
                      attr: str) -> Set[Tuple[str, str]]:
        """Candidate classes for self.<attr>, walking base classes (an
        attribute assigned in an inherited __init__ types the subclass
        too)."""
        out: Set[Tuple[str, str]] = set()
        seen: Set[Tuple[str, str]] = set()
        queue = [(module, cls)]
        while queue:
            key = queue.pop(0)
            if key in seen:
                continue
            seen.add(key)
            ci = self.classes.get(key)
            if ci is None:
                continue
            out |= ci.attr_types.get(attr, set())
            mod = self.modules.get(ci.module)
            if mod is None:
                continue
            for ref in ci.base_refs:
                base = self._resolve_class(mod, ref)
                if base is not None:
                    queue.append(base)
        return out

    def _resolve_call(self, mod: ModuleInfo, fi: FunctionInfo,
                      call: ast.Call) -> CallSite:
        func = call.func
        text = dotted_name(func)
        site = CallSite(node=call, text=text or "<dynamic>")
        if not text:
            return site
        parts = text.split(".")
        if parts[0] == "self" and fi.cls is not None:
            if len(parts) == 2:
                meth = self.lookup_method((fi.module, fi.cls), parts[1])
                if meth:
                    site.callees = (meth,)
                    site.via_self = True
                return site
            if len(parts) == 3:
                callees = []
                for key in self.attr_types_of(fi.module, fi.cls, parts[1]):
                    meth = self.lookup_method(key, parts[2])
                    if meth:
                        callees.append(meth)
                site.callees = tuple(sorted(set(callees)))
                return site
            return site
        kind, val = self._resolve_dotted(mod, text)
        if kind == "func":
            site.callees = (val,)
        elif kind == "class":
            # constructor: edge to __init__ if the project defines one
            init = self.lookup_method(val, "__init__")
            if init:
                site.callees = (init,)
        return site

    # ------------------------------------------------------------------
    # derived closures

    def callers(self) -> Dict[str, List[Tuple[str, CallSite]]]:
        """Reverse call edges: callee qualname -> [(caller, site)]."""
        if self._callers is None:
            rev: Dict[str, List[Tuple[str, CallSite]]] = {}
            for qual, fi in self.functions.items():
                for site in fi.calls:
                    for callee in site.callees:
                        rev.setdefault(callee, []).append((qual, site))
            self._callers = rev
        return self._callers

    def self_write_closure(self, qualname: str) -> Set[str]:
        """Attrs (transitively) written on ``self`` outside a lock by
        this method and the methods it calls on ``self`` *outside a
        lock* — a helper invoked under the caller's lock is serialized
        against other writers, so its writes do not propagate."""
        return self._closure(
            qualname, self._write_closure_cache,
            lambda fi: fi.self_writes_unlocked,
            lambda fi: fi.self_calls_unlocked)

    def guard_closure(self, qualname: str) -> Set[str]:
        """Lockish self.<attr> guards (transitively) acquired by this
        method through same-object calls.  Propagates through EVERY
        ``self.m()`` edge — acquiring a guard while holding another is
        still acquiring (that nesting is the deadlock shape)."""
        return self._closure(
            qualname, self._guard_closure_cache,
            lambda fi: fi.guards,
            lambda fi: {s.text.split(".")[1] for s in fi.calls
                        if s.via_self})

    def _closure(self, qualname: str, cache: Dict[str, Set[str]],
                 base, hops) -> Set[str]:
        if qualname in cache:
            return cache[qualname]
        out: Set[str] = set()
        seen: Set[str] = set()
        queue = [qualname]
        while queue:
            q = queue.pop()
            if q in seen:
                continue
            seen.add(q)
            fi = self.functions.get(q)
            if fi is None:
                continue
            out |= base(fi)
            if fi.cls is None:
                continue
            for name in hops(fi):
                nxt = self.lookup_method((fi.module, fi.cls), name)
                if nxt is not None:
                    queue.append(nxt)
        cache[qualname] = out
        return out
