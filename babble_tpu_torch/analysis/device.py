"""Device-plane rules: donation safety, recompile hazards,
partition-spec and bytes-model coverage.

Tier-1 runs on CPU (``JAX_PLATFORMS=cpu``), where the whole device
plane degrades to semantics that HIDE its bug classes: donated buffers
are not actually invalidated (use-after-donate silently works until
TPU hardware rejects the dead buffer), per-flush retraces are cheap
enough to miss, and SPMD partitioning never runs at all.  These rules
are the static gate in front of that blind spot — the invariants the
multi-chip lift (ROADMAP item 1) and the kernel working-set diet
(item 4) stand on must fail the build on a laptop, not a v5e.

Four rules over one shared :class:`DeviceIndex` (built lazily, once
per project pass):

- ``donate-use-after-free`` — a name passed at a ``donate_argnums``
  position of a jitted entry must not be read after the call unless
  rebound from its result.  Entries resolve through module-level
  ``X = jax.jit(...)`` assignments, jit-returning factories
  (``make_sharded_step``), the ``_jits``-style dict factories of
  ops/wide.py (``j["write_batch"](...)``), and — interprocedurally —
  project functions that pass a parameter through to a donated
  position (``run_wide_coords`` donates its caller's state).
- ``recompile-hazard`` — a static arg of a jitted entry fed from
  runtime-varying data (``len(...)``, ``.shape``) without routing
  through a bucketing helper (``bucket``/``bucket_w``/
  ``_padded_schedule``) retraces per flush: compile storms measured in
  the tens of seconds on v5e (ops/aot.py module docstring).
- ``partition-spec-coverage`` — (a) every ``*_specs``/``*_shardings``
  function constructing a project NamedTuple must name EVERY field of
  that NamedTuple, so a new ``DagState`` field fails lint until
  parallel/sharded.py carries a partition rule for it; (b) static
  sentinel-row writes (``a.at[cfg.e_cap].set(v)``) are flagged in
  jax modules — under SPMD partitioning the lowered
  dynamic-update-slice start is CLAMPED per shard and the write lands
  on the last row of every earlier shard (the documented corruption at
  ops/state.py set_sentinel; route through ``set_sentinel``).
- ``bytes-model-coverage`` — the axis classification of the state
  NamedTuple (``AXIS_CLASSIFIED_STATE`` + ``PER_*_FIELDS`` in
  ops/state.py) must partition its fields exactly, and every
  per-event/per-round field must own a row in the flush traffic model
  (``FIELD_TRAFFIC`` in ops/flush.py) — ROADMAP item 4's before/after
  meter stays honest as fields are added.

Like every babble-lint rule this is stdlib-only ``ast`` work: no jax
import, safe on broken trees, and unresolved constructs mean "no
information", never "finding".
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .engine import FileContext, Finding, Rule
from .graph import FunctionInfo, ModuleInfo, ProjectContext, dotted_name

#: function names whose results are trace-time-safe static args: they
#: collapse runtime-varying sizes onto a small closed set of shapes
_BUCKET_NAME_RE = re.compile(r"bucket|_padded_schedule|padded_schedule")
#: host-static sentinel-ish index names/attrs (cap scalars)
_CAP_NAME_RE = re.compile(r"^(?:[ers]_?cap|[ers]1|sentinel\w*)$")

_SPECS_FN_RE = re.compile(r"(?:_specs|_shardings)$")

_AXIS_TUPLES = ("PER_EVENT_FIELDS", "PER_ROUND_FIELDS",
                "PER_CREATOR_FIELDS", "SCALAR_FIELDS")
_MODELED_TUPLES = ("PER_EVENT_FIELDS", "PER_ROUND_FIELDS")


def _int_tuple(node: ast.AST) -> Tuple[int, ...]:
    """Constant donate_argnums/static_argnums value -> positions."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            if (isinstance(elt, ast.Constant)
                    and isinstance(elt.value, int)):
                out.append(elt.value)
            else:
                return ()
        return tuple(out)
    return ()


@dataclass(frozen=True)
class JitSpec:
    """One jitted entry: which positional args are donated / static."""

    name: str
    donate: Tuple[int, ...] = ()
    static: Tuple[int, ...] = ()


@dataclass
class DeviceIndex:
    """Project-wide registry of jitted entries, built once per pass."""

    #: (module, attr) -> spec, from module-level ``X = jax.jit(...)``
    entries: Dict[Tuple[str, str], JitSpec] = field(default_factory=dict)
    #: function qualname -> spec, for functions returning jax.jit(...)
    factories: Dict[str, JitSpec] = field(default_factory=dict)
    #: function qualname -> {dict key -> spec}, for _jits-style
    #: factories returning a dict of locally-jitted programs
    dict_factories: Dict[str, Dict[str, JitSpec]] = field(
        default_factory=dict)
    #: function qualname -> param positions it (transitively) passes to
    #: a donated position — calling it donates the caller's buffer
    donate_through: Dict[str, Tuple[int, ...]] = field(
        default_factory=dict)


def _resolve_alias(mod: ModuleInfo, text: str) -> str:
    head = text.split(".")[0]
    if head in mod.aliases:
        return ".".join([mod.aliases[head]] + text.split(".")[1:])
    return text


def _jit_spec_from_keywords(call: ast.Call) -> JitSpec:
    donate: Tuple[int, ...] = ()
    static: Tuple[int, ...] = ()
    for kw in call.keywords:
        if kw.arg == "donate_argnums":
            donate = _int_tuple(kw.value)
        elif kw.arg == "static_argnums":
            static = _int_tuple(kw.value)
    return JitSpec(name="jax.jit", donate=donate, static=static)


def _is_jit_call(mod: ModuleInfo, call: ast.Call) -> Optional[JitSpec]:
    """Is this expression a ``jax.jit(...)`` call?  Returns its spec."""
    text = dotted_name(call.func)
    if not text or _resolve_alias(mod, text) != "jax.jit":
        return None
    return _jit_spec_from_keywords(call)


def _decorator_jit_spec(mod: ModuleInfo,
                        dec: ast.AST) -> Optional[JitSpec]:
    """Spec for a jit DECORATOR: ``@functools.partial(jax.jit,
    donate_argnums=..., static_argnums=...)`` — the other common entry
    shape (ops/pallas_ingest.py la_walk).  A bare ``@jax.jit`` carries
    no donate/static config, so there is nothing to check."""
    if not isinstance(dec, ast.Call):
        return None
    text = dotted_name(dec.func)
    if not text:
        return None
    if _resolve_alias(mod, text) != "functools.partial":
        return None
    if not dec.args:
        return None
    first = dotted_name(dec.args[0])
    if not first or _resolve_alias(mod, first) != "jax.jit":
        return None
    return _jit_spec_from_keywords(dec)


def device_index(project: ProjectContext) -> DeviceIndex:
    """Build (and cache on the project) the jit-entry registry."""
    cached = getattr(project, "_device_index", None)
    if cached is not None:
        return cached
    idx = DeviceIndex()
    for mod in project.modules.values():
        for stmt in mod.tree.body:
            if (isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Call)):
                spec = _is_jit_call(mod, stmt.value)
                if spec is not None:
                    name = stmt.targets[0].id
                    idx.entries[(mod.name, name)] = JitSpec(
                        name=name, donate=spec.donate, static=spec.static)
    for qual, fi in project.functions.items():
        mod = project.modules.get(fi.module)
        if mod is None:
            continue
        # decorator-form entries: @functools.partial(jax.jit, ...)
        if fi.cls is None:
            for dec in getattr(fi.node, "decorator_list", ()):
                spec = _decorator_jit_spec(mod, dec)
                if spec is not None:
                    idx.entries[(fi.module, fi.name)] = JitSpec(
                        name=fi.name, donate=spec.donate,
                        static=spec.static)
                    break
        _scan_factory(idx, mod, qual, fi)
    _fix_donate_through(project, idx)
    project._device_index = idx
    return idx


def _scan_factory(idx: DeviceIndex, mod: ModuleInfo, qual: str,
                  fi: FunctionInfo) -> None:
    """Detect jit-returning factories and _jits-style dict factories."""
    local_specs: Dict[str, JitSpec] = {}
    returns_jit: Optional[JitSpec] = None
    returned_dict: Optional[ast.AST] = None
    # own statements only: a nested def's returns are ITS returns, not
    # the factory's — walking them would clobber the dict return
    for node, _bctx, _loops in _iter_statements(fi.node.body):
        if (isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)):
            spec = _is_jit_call(mod, node.value)
            if spec is not None:
                name = node.targets[0].id
                local_specs[name] = JitSpec(
                    name=name, donate=spec.donate, static=spec.static)
        elif isinstance(node, ast.Return) and node.value is not None:
            if isinstance(node.value, ast.Call):
                spec = _is_jit_call(mod, node.value)
                if spec is not None:
                    returns_jit = JitSpec(
                        name=fi.name, donate=spec.donate,
                        static=spec.static)
                    continue
            returned_dict = node.value
    if returns_jit is not None:
        idx.factories[qual] = returns_jit
        return
    if not local_specs or returned_dict is None:
        return
    mapping: Dict[str, JitSpec] = {}
    if isinstance(returned_dict, ast.Dict):
        for k, v in zip(returned_dict.keys, returned_dict.values):
            if (isinstance(k, ast.Constant) and isinstance(k.value, str)
                    and isinstance(v, ast.Name)
                    and v.id in local_specs):
                mapping[k.value] = local_specs[v.id]
    elif (isinstance(returned_dict, ast.Call)
            and isinstance(returned_dict.func, ast.Name)
            and returned_dict.func.id == "dict"):
        for kw in returned_dict.keywords:
            if (kw.arg is not None and isinstance(kw.value, ast.Name)
                    and kw.value.id in local_specs):
                mapping[kw.arg] = local_specs[kw.value.id]
    if mapping:
        idx.dict_factories[qual] = mapping


def _fix_donate_through(project: ProjectContext, idx: DeviceIndex) -> None:
    """Fixpoint: param positions a function passes (as a bare name) to
    a donated position — of a jit entry, or of another donating
    function.  Calling such a function donates the caller's buffer, so
    call sites are checked exactly like direct jit-entry calls."""
    param_names: Dict[str, List[str]] = {}
    for qual, fi in project.functions.items():
        args = fi.node.args
        names = [a.arg for a in args.posonlyargs + args.args]
        if fi.cls is not None and names and names[0] in ("self", "cls"):
            names = names[1:]
        param_names[qual] = names
    locals_maps: Dict[str, Dict[str, object]] = {}
    changed = True
    while changed:
        changed = False
        for qual, fi in project.functions.items():
            names = param_names[qual]
            if not names:
                continue
            mod = project.modules.get(fi.module)
            if mod is None:
                continue
            if qual not in locals_maps:
                locals_maps[qual] = _build_locals_map(project, idx,
                                                      mod, fi)
            current = set(idx.donate_through.get(qual, ()))
            found = set(current)
            for site in fi.calls:
                donated = _donated_positions(
                    project, idx, mod, fi, site.node,
                    locals_map=locals_maps[qual])
                for pos in donated:
                    if pos >= len(site.node.args):
                        continue
                    arg = site.node.args[pos]
                    if isinstance(arg, ast.Name) and arg.id in names:
                        found.add(names.index(arg.id))
            if found != current:
                idx.donate_through[qual] = tuple(sorted(found))
                changed = True


def _resolve_spec(project: ProjectContext, idx: DeviceIndex,
                  mod: ModuleInfo, fi: FunctionInfo, call: ast.Call,
                  locals_map: Optional[Dict[str, object]]):
    """Resolve a call expression to a JitSpec (or a donate-through
    tuple for project functions).  Returns (donate, static, label) or
    None."""
    func = call.func
    # j["key"](...) — subscript into a local bound to a dict factory
    if (isinstance(func, ast.Subscript)
            and isinstance(func.value, ast.Name)
            and locals_map is not None):
        bound = locals_map.get(func.value.id)
        if isinstance(bound, dict):
            key = func.slice
            if (isinstance(key, ast.Constant)
                    and isinstance(key.value, str)
                    and key.value in bound):
                spec = bound[key.value]
                return spec.donate, spec.static, f"jit `{spec.name}`"
        return None
    text = dotted_name(func)
    if not text:
        return None
    # a local variable bound to a jit-returning factory's result
    if locals_map is not None and text in locals_map:
        bound = locals_map[text]
        if isinstance(bound, JitSpec):
            return bound.donate, bound.static, f"jit `{bound.name}`"
    # module-level entry: bare name in this module, or alias.attr
    parts = text.split(".")
    if len(parts) == 1:
        if (mod.name, text) in idx.entries:
            spec = idx.entries[(mod.name, text)]
            return spec.donate, spec.static, f"jit `{spec.name}`"
        if text in mod.aliases:
            tgt = mod.aliases[text]
            tmod, _, tname = tgt.rpartition(".")
            if (tmod, tname) in idx.entries:
                spec = idx.entries[(tmod, tname)]
                return spec.donate, spec.static, f"jit `{spec.name}`"
    elif parts[0] in mod.aliases:
        base = mod.aliases[parts[0]]
        absolute = ".".join([base] + parts[1:])
        tmod, _, tname = absolute.rpartition(".")
        if (tmod, tname) in idx.entries:
            spec = idx.entries[(tmod, tname)]
            return spec.donate, spec.static, f"jit `{spec.name}`"
    # project function that donates through a parameter
    for qual in _callees(project, mod, fi, call):
        through = idx.donate_through.get(qual)
        if through:
            return tuple(through), (), f"`{qual.split(':')[-1]}`"
    return None


def _callees(project: ProjectContext, mod: ModuleInfo,
             fi: FunctionInfo, call: ast.Call) -> Tuple[str, ...]:
    """Resolved callee qualnames for a raw call node (re-resolves so
    calls found outside the graph's recorded sites still work)."""
    for site in fi.calls:
        if site.node is call:
            return site.callees
    return ()


def _donated_positions(project, idx, mod, fi, call,
                       locals_map) -> Tuple[int, ...]:
    res = _resolve_spec(project, idx, mod, fi, call, locals_map)
    return res[0] if res is not None else ()


# ----------------------------------------------------------------------
# per-function statement walk (shared by the donate + recompile rules)


#: branch context: ((id(branching_stmt), arm_index), ...) for every
#: exclusive-arm ancestor — two statements whose contexts name the
#: same branching statement with DIFFERENT arms can never both run in
#: one execution, so a line-number-later read in the else arm of a
#: donating if is NOT a read-after-donate.  Only if/else arms qualify:
#: an except handler runs AFTER the try body partially executed, so a
#: handler read of a buffer the body donated is a real use-after-free.
BranchCtx = Tuple[Tuple[int, int], ...]

#: enclosing-loop line spans ((start, end), ...), innermost last — a
#: donate without a rebind inside the loop feeds the dead buffer back
#: to the call on the next iteration
LoopSpans = Tuple[Tuple[int, int], ...]


def _iter_statements(body: Sequence[ast.stmt],
                     ctx: BranchCtx = (),
                     loops: LoopSpans = ()) -> Iterator[
                         Tuple[ast.stmt, BranchCtx, LoopSpans]]:
    """All statements in execution-ish order with their branch context
    and enclosing-loop spans; nested functions pruned (they run on
    their own schedule)."""
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield stmt, ctx, loops
        if isinstance(stmt, ast.If):
            yield from _iter_statements(stmt.body,
                                        ctx + ((id(stmt), 0),), loops)
            yield from _iter_statements(stmt.orelse,
                                        ctx + ((id(stmt), 1),), loops)
        elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            span = (stmt.lineno,
                    getattr(stmt, "end_lineno", stmt.lineno)
                    or stmt.lineno)
            yield from _iter_statements(stmt.body, ctx, loops + (span,))
            yield from _iter_statements(stmt.orelse, ctx, loops)
        else:
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if sub:
                    yield from _iter_statements(sub, ctx, loops)
            for h in getattr(stmt, "handlers", ()) or ():
                yield from _iter_statements(h.body, ctx, loops)


def _exclusive(a: BranchCtx, b: BranchCtx) -> bool:
    """Can the two contexts never both execute in one run?"""
    arms = dict(a)
    return any(nid in arms and arms[nid] != arm for nid, arm in b)


def _own_nodes(stmt: ast.stmt) -> Iterator[ast.AST]:
    """Nodes belonging to this statement's own expressions — nested
    block statements excluded (they are separate statements with their
    own branch contexts)."""
    nested: Set[int] = set()
    for attr in ("body", "orelse", "finalbody"):
        for sub in getattr(stmt, attr, None) or ():
            for n in ast.walk(sub):
                nested.add(id(n))
    for h in getattr(stmt, "handlers", ()) or ():
        for sub in h.body:
            for n in ast.walk(sub):
                nested.add(id(n))
    for node in ast.walk(stmt):
        if id(node) not in nested:
            yield node


def _own_calls(stmt: ast.stmt) -> List[ast.Call]:
    return [n for n in _own_nodes(stmt) if isinstance(n, ast.Call)]


def _assign_target_texts(stmt: ast.stmt) -> List[str]:
    """Dotted texts of every name/attr this statement rebinds (for
    loops: the iteration variable is rebound every pass)."""
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign,
                           ast.For, ast.AsyncFor)):
        targets = [stmt.target]
    out: List[str] = []
    stack = targets
    while stack:
        t = stack.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        elif isinstance(t, ast.Starred):
            stack.append(t.value)
        else:
            text = dotted_name(t)
            if text:
                out.append(text)
    return out


def _rebinds(text: str, targets: List[str]) -> bool:
    """Does rebinding any of ``targets`` rebind ``text``?  Assigning a
    prefix (``self.carry = ...``) rebinds the whole chain under it."""
    for t in targets:
        if text == t or text.startswith(t + "."):
            return True
    return False


def _build_locals_map(project: ProjectContext, idx: DeviceIndex,
                      mod: ModuleInfo,
                      fi: FunctionInfo) -> Dict[str, object]:
    """name -> JitSpec (factory result) | {key: JitSpec} (dict
    factory result), from this function's local assignments."""
    out: Dict[str, object] = {}
    for node in ast.walk(fi.node):
        if not (isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)):
            continue
        name = node.targets[0].id
        for qual in _callees(project, mod, fi, node.value):
            if qual in idx.dict_factories:
                out[name] = idx.dict_factories[qual]
                break
            if qual in idx.factories:
                out[name] = idx.factories[qual]
                break
    return out


# ----------------------------------------------------------------------
# rule 1: donate-use-after-free


class DonateUseAfterFreeRule(Rule):
    name = "donate-use-after-free"
    description = (
        "a buffer passed at a donate_argnums position of a jitted "
        "entry is dead after the call — reading it again without "
        "rebinding from the result works silently on CPU (tier-1) and "
        "crashes on TPU, where donation actually invalidates the "
        "buffer"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project = ctx.project
        if project is None:
            return
        idx = device_index(project)
        for fi in project.functions.values():
            if fi.path != ctx.path:
                continue
            yield from self._check_function(ctx, project, idx, fi)

    def _check_function(self, ctx, project, idx, fi) -> Iterator[Finding]:
        mod = project.modules.get(fi.module)
        if mod is None:
            return
        locals_map = _build_locals_map(project, idx, mod, fi)
        stmts = list(_iter_statements(fi.node.body))
        # every rebinding of every dotted target: (END line, branch
        # ctx).  The end line matters: `state = state._replace(...)`
        # reads the old buffer BEFORE the rebind takes effect, so a
        # rebind only sanitizes reads on strictly later lines
        rebind_at: Dict[str, List[Tuple[int, BranchCtx]]] = {}
        for stmt, bctx, _loops in stmts:
            for t in _assign_target_texts(stmt):
                end = getattr(stmt, "end_lineno", stmt.lineno)
                # a for-loop target rebinds at the loop HEAD line, and
                # completes there on every iteration
                if isinstance(stmt, (ast.For, ast.AsyncFor)):
                    end = stmt.lineno
                rebind_at.setdefault(t, []).append(
                    (end or stmt.lineno, bctx))
        for stmt, call_ctx, loops in stmts:
            targets = _assign_target_texts(stmt)
            for call in _own_calls(stmt):
                res = _resolve_spec(project, idx, mod, fi, call,
                                    locals_map)
                if res is None:
                    continue
                donate, _static, label = res
                for pos in donate:
                    if pos >= len(call.args):
                        continue
                    expr = call.args[pos]
                    text = dotted_name(expr)
                    if not text or text == "self":
                        continue
                    if isinstance(stmt, ast.Return):
                        continue
                    if _rebinds(text, targets):
                        continue
                    end = getattr(stmt, "end_lineno", stmt.lineno)
                    rebinds = [
                        rb for t, entries in rebind_at.items()
                        if t == text or text.startswith(t + ".")
                        for rb in entries
                    ]
                    # loop back-edge: with no rebind anywhere inside
                    # the enclosing loop, the NEXT iteration feeds the
                    # dead buffer straight back into this call — the
                    # shape line-ordered read scanning cannot see
                    if loops and not any(
                        lo <= r <= hi
                        and not _exclusive(rctx, call_ctx)
                        for lo, hi in loops for r, rctx in rebinds
                    ):
                        yield self.finding(
                            ctx, expr,
                            f"`{text}` is donated to {label} inside a "
                            "loop and never rebound within it — the "
                            "next iteration passes the invalidated "
                            "buffer back in (a use-after-free CPU's "
                            "no-op donation hides); rebind the name "
                            "from the call's result",
                        )
                        continue
                    yield from self._flag_reads(
                        ctx, stmts, text, end or stmt.lineno, call_ctx,
                        label, rebinds,
                    )

    def _flag_reads(self, ctx, stmts, text, after_line, call_ctx,
                    label, rebinds) -> Iterator[Finding]:
        for stmt, bctx, _loops in stmts:
            if _exclusive(call_ctx, bctx):
                # an arm the donating path can never reach — reading
                # the name there is not a read-after-donate
                continue
            for node in _own_nodes(stmt):
                if not isinstance(node, (ast.Name, ast.Attribute)):
                    continue
                if not isinstance(getattr(node, "ctx", None), ast.Load):
                    continue       # Store/Del targets are not reads
                load = dotted_name(node)
                if not load:
                    continue
                if load != text and not load.startswith(text + "."):
                    continue
                line = getattr(node, "lineno", 0)
                if line <= after_line:
                    continue
                # a rebinding that COMPLETED between the donation and
                # the read sanitizes, but only on the donating path —
                # strict <: a read inside the rebinding statement's own
                # RHS (`state = state._replace(...)`) still reads the
                # dead buffer
                if any(after_line < r < line
                       and not _exclusive(rctx, call_ctx)
                       for r, rctx in rebinds):
                    continue
                yield self.finding(
                    ctx, node,
                    f"`{text}` was donated to {label} (donate_argnums) "
                    "and is read again here without being rebound from "
                    "the result — a use-after-free that only CPU's "
                    "no-op donation lets pass; rebind the name from "
                    "the call's output (or drop the read)",
                )
                return  # one finding per donate event keeps noise down


# ----------------------------------------------------------------------
# rule 2: recompile-hazard


class RecompileHazardRule(Rule):
    name = "recompile-hazard"
    description = (
        "a static_argnums arg of a jitted entry fed from "
        "runtime-varying data (len(), .shape) without a bucketing "
        "helper retraces the program per flush — the compile-storm "
        "failure mode the AOT manifest exists to prevent"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project = ctx.project
        if project is None:
            return
        idx = device_index(project)
        for fi in project.functions.values():
            if fi.path != ctx.path:
                continue
            mod = project.modules.get(fi.module)
            if mod is None:
                continue
            locals_map = _build_locals_map(project, idx, mod, fi)
            assigns = self._local_assignments(fi)
            for site in fi.calls:
                res = _resolve_spec(project, idx, mod, fi, site.node,
                                    locals_map)
                if res is None:
                    continue
                _donate, static, label = res
                for pos in static:
                    if pos >= len(site.node.args):
                        continue
                    arg = site.node.args[pos]
                    if self._varying(arg, assigns, set()):
                        yield self.finding(
                            ctx, arg,
                            f"static arg {pos} of {label} is fed from "
                            "runtime-varying data — every distinct "
                            "value traces and compiles a fresh "
                            "program; route it through a bucketing "
                            "helper (bucket/bucket_w/_padded_schedule) "
                            "so a flush stream shares one executable",
                        )

    @staticmethod
    def _local_assignments(fi: FunctionInfo) -> Dict[str, List[ast.AST]]:
        out: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t, v = node.targets[0], node.value
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, []).append(v)
                elif (isinstance(t, ast.Tuple)
                        and isinstance(v, ast.Tuple)
                        and len(t.elts) == len(v.elts)):
                    for te, ve in zip(t.elts, v.elts):
                        if isinstance(te, ast.Name):
                            out.setdefault(te.id, []).append(ve)
                elif isinstance(t, ast.Tuple):
                    # unpacking a single expression (x, y = a.shape):
                    # each target inherits the source expression
                    for te in t.elts:
                        if isinstance(te, ast.Name):
                            out.setdefault(te.id, []).append(v)
        return out

    def _varying(self, node: ast.AST, assigns, seen: Set[str]) -> bool:
        """Is this expression demonstrably runtime-varying AND not
        routed through a bucketing helper?  Unresolved constructs are
        'no information' (False)."""
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func).rsplit(".", 1)[-1]
            if _BUCKET_NAME_RE.search(fname):
                return False               # sanitized
            if fname == "len":
                return True
            if fname in ("int", "min", "max", "abs"):
                return any(self._varying(a, assigns, seen)
                           for a in node.args)
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in ("shape", "size", "ndim"):
                return True
            return False
        if isinstance(node, ast.Name):
            if node.id in seen:
                return False
            values = assigns.get(node.id)
            if not values:
                return False               # param/self attr: no info
            seen = seen | {node.id}
            sanitized = any(
                isinstance(v, ast.Call)
                and _BUCKET_NAME_RE.search(
                    dotted_name(v.func).rsplit(".", 1)[-1])
                for v in values
            )
            if sanitized:
                return False
            return any(self._varying(v, assigns, seen) for v in values)
        if isinstance(node, ast.IfExp):
            # the TEST may vary freely — selecting between static
            # values IS two-way bucketing
            return (self._varying(node.body, assigns, seen)
                    or self._varying(node.orelse, assigns, seen))
        if isinstance(node, (ast.BinOp,)):
            return (self._varying(node.left, assigns, seen)
                    or self._varying(node.right, assigns, seen))
        if isinstance(node, ast.UnaryOp):
            return self._varying(node.operand, assigns, seen)
        if isinstance(node, ast.BoolOp):
            return any(self._varying(v, assigns, seen)
                       for v in node.values)
        if isinstance(node, ast.Subscript):
            return self._varying(node.value, assigns, seen)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self._varying(e, assigns, seen)
                       for e in node.elts)
        return False


# ----------------------------------------------------------------------
# rule 3: partition-spec-coverage


def _module_imports_jax(mod: ModuleInfo) -> bool:
    return any(v == "jax" or v.startswith("jax.")
               for v in mod.aliases.values())


def _static_capish_index(node: ast.AST) -> bool:
    """A trace-time-constant nonzero row index — the sentinel-row write
    shape.  Constant 0 is exempt (never clamps); traced names are 'no
    information'."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, int) and node.value != 0
    if (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub)
            and isinstance(node.operand, ast.Constant)):
        return True
    if isinstance(node, ast.Name):
        return bool(_CAP_NAME_RE.match(node.id))
    if isinstance(node, ast.Attribute):
        return bool(_CAP_NAME_RE.match(node.attr))
    if isinstance(node, ast.Tuple) and node.elts:
        return _static_capish_index(node.elts[0])
    return False


class PartitionSpecCoverageRule(Rule):
    name = "partition-spec-coverage"
    description = (
        "every *_specs/*_shardings constructor must name every field "
        "of its NamedTuple (a new DagState field needs a partition "
        "rule before the sharded path can carry it), and sentinel-row "
        "writes into device arrays must use set_sentinel, not "
        "a.at[cap].set() — the lowered dynamic-update-slice start is "
        "clamped per shard under SPMD and corrupts earlier shards"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project = ctx.project
        if project is None:
            return
        mod = project.modules.get(project.path_module.get(ctx.path, ""))
        if mod is None:
            return
        yield from self._check_spec_functions(ctx, project, mod)
        if _module_imports_jax(mod):
            yield from self._check_sentinel_writes(ctx)

    def _check_spec_functions(self, ctx, project, mod) -> Iterator[Finding]:
        for fi in project.functions.values():
            if fi.path != ctx.path or not _SPECS_FN_RE.search(fi.name):
                continue
            for site in fi.calls:
                call = site.node
                kind, val = project._resolve_dotted(mod, site.text)
                if kind != "class":
                    continue
                ci = project.classes.get(val)
                if ci is None or not ci.is_namedtuple or not ci.fields:
                    continue
                if any(kw.arg is None for kw in call.keywords):
                    continue           # **kwargs: no information
                if any(isinstance(a, ast.Starred) for a in call.args):
                    continue           # *args: no information either
                given = {kw.arg for kw in call.keywords}
                given |= set(ci.fields[: len(call.args)])
                missing = [f for f in ci.fields if f not in given]
                if missing:
                    yield self.finding(
                        ctx, call,
                        f"`{fi.name}` constructs {ci.name} without "
                        f"partition rules for field(s) {missing} — "
                        "every field needs an explicit spec here or "
                        "the sharded path silently drops/replicates "
                        "new state",
                    )

    def _check_sentinel_writes(self, ctx) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("set", "add", "min", "max")
                    and isinstance(node.func.value, ast.Subscript)
                    and isinstance(node.func.value.value, ast.Attribute)
                    and node.func.value.value.attr == "at"):
                continue
            idx_expr = node.func.value.slice
            if isinstance(idx_expr, ast.Slice):
                continue               # slice copies, not row sentinels
            if _static_capish_index(idx_expr):
                base = dotted_name(node.func.value.value.value) or "array"
                yield self.finding(
                    ctx, node,
                    f"static sentinel-row write `{base}.at[...].{node.func.attr}()` "
                    "lowers to a dynamic-update-slice whose per-shard "
                    "start index is clamped under SPMD partitioning — "
                    "the write also lands on the last row of every "
                    "earlier shard (ops/state.py set_sentinel "
                    "docstring); use set_sentinel with an iota mask",
                )


# ----------------------------------------------------------------------
# rule 4: bytes-model-coverage


def _module_tuple_consts(mod: ModuleInfo) -> Dict[str, Tuple[str, ...]]:
    """Module-level NAME = ("a", "b", ...) string-tuple constants."""
    out: Dict[str, Tuple[str, ...]] = {}
    for stmt in mod.tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, (ast.Tuple, ast.List))):
            vals = []
            for elt in stmt.value.elts:
                if (isinstance(elt, ast.Constant)
                        and isinstance(elt.value, str)):
                    vals.append(elt.value)
                else:
                    vals = None
                    break
            if vals is not None:
                out[stmt.targets[0].id] = tuple(vals)
    return out


def _module_str_const(mod: ModuleInfo, name: str) -> Optional[str]:
    for stmt in mod.tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and stmt.targets[0].id == name
                and isinstance(stmt.value, ast.Constant)
                and isinstance(stmt.value.value, str)):
            return stmt.value.value
    return None


def _find_assign(mod: ModuleInfo, name: str) -> Optional[ast.Assign]:
    for stmt in mod.tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and stmt.targets[0].id == name):
            return stmt
    return None


class BytesModelCoverageRule(Rule):
    name = "bytes-model-coverage"
    description = (
        "the state NamedTuple's axis classification (PER_*_FIELDS) "
        "must partition its fields exactly, and every per-event/"
        "per-round tensor must own a FIELD_TRAFFIC row in the flush "
        "bytes model — item 4's before/after meter must not silently "
        "under-count new state"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project = ctx.project
        if project is None:
            return
        mod = project.modules.get(project.path_module.get(ctx.path, ""))
        if mod is None:
            return
        yield from self._check_classification(ctx, project, mod)
        yield from self._check_traffic(ctx, project, mod)

    def _check_classification(self, ctx, project, mod) -> Iterator[Finding]:
        cls_name = _module_str_const(mod, "AXIS_CLASSIFIED_STATE")
        if cls_name is None:
            return
        anchor = _find_assign(mod, "AXIS_CLASSIFIED_STATE")
        ci = mod.classes.get(cls_name)
        if ci is None or not ci.fields:
            yield self.finding(
                ctx, anchor,
                f"AXIS_CLASSIFIED_STATE names `{cls_name}`, which is "
                "not a NamedTuple with fields in this module",
            )
            return
        consts = _module_tuple_consts(mod)
        union: List[str] = []
        for name in _AXIS_TUPLES:
            union.extend(consts.get(name, ()))
        missing = [f for f in ci.fields if f not in union]
        if missing:
            yield self.finding(
                ctx, anchor,
                f"{cls_name} field(s) {missing} are not classified in "
                f"any of {list(_AXIS_TUPLES)} — state which axis the "
                "new field grows along so the traffic model and "
                "partition specs can be held to it",
            )
        stale = [f for f in union if f not in ci.fields]
        if stale:
            yield self.finding(
                ctx, anchor,
                f"axis classification names field(s) {stale} that "
                f"{cls_name} no longer has — delete the stale entries",
            )
        dupes = [f for f in set(union) if union.count(f) > 1]
        if dupes:
            yield self.finding(
                ctx, anchor,
                f"field(s) {sorted(dupes)} appear in more than one "
                "axis tuple — the classification must be a partition",
            )

    def _check_traffic(self, ctx, project, mod) -> Iterator[Finding]:
        anchor = _find_assign(mod, "FIELD_TRAFFIC")
        if anchor is None or not isinstance(anchor.value, ast.Dict):
            return
        keys = {
            k.value for k in anchor.value.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)
        }

        # the axis tuples live together in ONE state module: find it
        # through whichever required tuple this module imports (falling
        # back to this module for self-contained layouts), then read
        # ALL four tuples from there — per-name alias resolution would
        # lose the tuples the traffic module does not import and
        # misreport voluntarily-modeled fields (per-creator tensors) as
        # stale
        state_mod = mod
        for name in _MODELED_TUPLES:
            target = mod.aliases.get(name)
            if target is not None:
                state_mod = project.modules.get(
                    target.rpartition(".")[0], mod)
                break
        state_consts = _module_tuple_consts(state_mod)

        required: List[str] = []
        for name in _MODELED_TUPLES:
            required.extend(state_consts.get(name, ()))
        # legal keys: ANY classified field (voluntarily modeling a
        # per-creator tensor is fine) plus derived:* temporaries
        universe: Set[str] = set()
        for name in _AXIS_TUPLES:
            universe.update(state_consts.get(name, ()))
        missing = [f for f in required if f not in keys]
        if missing:
            yield self.finding(
                ctx, anchor,
                f"FIELD_TRAFFIC has no row for field(s) {missing} — "
                "every per-event/per-round state tensor must be "
                "modeled or the flush bytes estimate silently "
                "under-counts as fields are added",
            )
        if universe:
            stale = sorted(
                k for k in keys
                if k not in universe and not k.startswith("derived:")
            )
            if stale:
                yield self.finding(
                    ctx, anchor,
                    f"FIELD_TRAFFIC models field(s) {stale} that the "
                    "state no longer classifies — a removed/renamed "
                    "field's orphaned row silently INFLATES every "
                    "flush bytes estimate; delete it (kernel "
                    "temporaries belong under a `derived:` key)",
                )
