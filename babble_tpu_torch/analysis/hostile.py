"""Trust-boundary taint: ``unbounded-hostile-input``.

The byzantine 1.1 TB OOM (BENCH_r05) and the forged-snapshot hardening
are the same bug class seen twice: a *peer-chosen
integer* — a declared window size, a branch extent, a round seed —
flowed into an allocation shape or a loop bound before anything checked
it against local memory bounds.  The checkpoint layer now carries the
bounds doctrine by hand (``_check_fork_meta`` / ``_check_host_meta``
reject before materializing); this pass makes the doctrine static:
*no* value decoded from peer bytes may reach a size-bearing sink
without passing a sanctioning guard.

Built on the project call graph, value-level and statement-ordered (the
v2 determinism pass tracks tainted *functions*; hostile sizes need
tainted *names*, because ``load_snapshot`` legitimately holds hostile
meta — the point is what happens to it before the guard call):

**Sources**
  - results of ``msgpack.unpackb(...)`` / any ``*.unpack(...)`` call —
    the wire-command (net/commands.py), WAL-replay, snapshot/checkpoint
    (``load_snapshot``/``load_checkpoint*``) and struct-header decode
    seams are all ``unpack``-shaped, deliberately;
  - parameters fed a hostile argument at any *resolved* call site, and
    results of calls whose callee returns a hostile value (fixpoint
    over the project graph, witness chains in messages).

**Propagation**: attribute/subscript reads off a hostile root,
arithmetic, ``max``/``sum``/``int``/``abs``, tuple/list packing,
comprehensions, loop targets over hostile iterables.

**Sanctioning guards** (what stops the taint)
  - a call to a ``check``/``validate``/``verify``-prefixed helper (the
    ``_check_fork_meta``/``_check_host_meta``/``check_meta`` family)
    taking the hostile name as an argument sanitizes that name from
    that statement on — exactly how ``load_snapshot`` sanctions meta
    before ``_restore_*`` sees it;
  - ``min(...)`` with at least one clean operand (an upper clamp);
  - an ``if``-guard over the hostile name whose body raises or
    returns, and ``assert`` — the in-function bounds idiom the check
    helpers themselves are written in;
  - ``len(...)`` is clean by construction: a *materialized* container's
    length is already bounded by the decoded frame size.

**Sinks**
  - ``np``/``jnp`` allocation shapes (``zeros``/``ones``/``empty``/
    ``full``/``arange``/``fromiter``/``tile``), ``bytearray``/
    ``bytes`` sizes, sequence repetition (``[0] * n``), ``OffsetList``
    extents;
  - ``range(n)`` loop bounds;
  - subscript *store* indices (``arr[i] = v`` materializes position
    ``i`` on growable targets).  Plain subscript reads raise rather
    than allocate and are excluded by design.

Unresolved call *results* are treated as clean (the unpack pattern
above is what makes a decode hostile, resolved or not) — the rule
trades that recall for a signal clean enough to gate the build;
a genuine false positive documents itself with a named suppression.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .engine import FileContext, Finding, Rule
from .graph import FunctionInfo, ProjectContext, dotted_name

_GUARD_RE = re.compile(r"^_?(check|validate|verify)_\w+$|^check_meta$")
_UNPACK_NAMES = {"unpack", "unpackb"}
_ALLOC_FUNCS = {"zeros", "ones", "empty", "full", "arange", "fromiter",
                "tile"}
_NUMPY_HEADS = {"np", "jnp", "numpy", "onp"}
_PASS_THROUGH = {"int", "abs", "round", "max", "sum", "sorted", "list",
                 "tuple"}
_MAX_LABEL = 200


def _basename(text: str) -> str:
    return text.rsplit(".", 1)[-1]


def _qual_basename(qual: str) -> str:
    return qual.rsplit(":", 1)[-1].rsplit(".", 1)[-1]


def _clip(label: str) -> str:
    if len(label) <= _MAX_LABEL:
        return label
    return label[: _MAX_LABEL - 3] + "..."


def _param_names(fi: FunctionInfo) -> List[str]:
    a = fi.node.args
    names = [p.arg for p in a.posonlyargs + a.args]
    if fi.cls is not None and names and names[0] in ("self", "cls"):
        names = names[1:]
    return names


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _is_numpy_call(fi_aliases: Dict[str, str], text: str) -> bool:
    if "." not in text:
        return False
    head = text.split(".", 1)[0]
    if head in _NUMPY_HEADS:
        return True
    target = fi_aliases.get(head, "")
    return target.startswith(("numpy", "jax"))


class _Analysis:
    """One function, statement-ordered: tracks hostile locals (name ->
    witness label), emits sink hits / return label / callee-arg taint."""

    def __init__(self, project: ProjectContext, fi: FunctionInfo,
                 aliases: Dict[str, str], param_taint: Dict[str, str],
                 returns: Dict[str, str]):
        self.project = project
        self.fi = fi
        self.aliases = aliases
        self.returns = returns
        self.hostile: Dict[str, str] = dict(param_taint)
        self.sinks: List[Tuple[ast.AST, str, str]] = []  # node, what, label
        self._sink_ids: Set[int] = set()  # loop bodies run twice; dedupe
        self.ret_label: Optional[str] = None
        self.arg_taint: List[Tuple[str, str, str]] = []  # qual, param, label
        self.run()

    def sink(self, node: ast.AST, what: str, label: str) -> None:
        if id(node) not in self._sink_ids:
            self._sink_ids.add(id(node))
            self.sinks.append((node, what, label))

    def run(self) -> None:
        self.block(self.fi.node.body)

    # -- expression labels ------------------------------------------------

    def label(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name):
            return self.hostile.get(node.id)
        if isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred,
                             ast.UnaryOp, ast.Await)):
            inner = (node.value if not isinstance(node, ast.UnaryOp)
                     else node.operand)
            return self.label(inner)
        if isinstance(node, ast.BinOp):
            left, right = self.label(node.left), self.label(node.right)
            if isinstance(node.op, ast.Mod) and right is None:
                return None        # h % clean is bounded by the divisor
            return left or right
        if isinstance(node, (ast.BoolOp, ast.Tuple, ast.List, ast.Set)):
            kids = (node.values if isinstance(node, ast.BoolOp)
                    else node.elts)
            for k in kids:
                lab = self.label(k)
                if lab:
                    return lab
        if isinstance(node, ast.IfExp):
            return self.label(node.body) or self.label(node.orelse)
        if isinstance(node, ast.Dict):
            for k in list(node.keys) + list(node.values):
                if k is not None:
                    lab = self.label(k)
                    if lab:
                        return lab
            return None
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            for gen in node.generators:
                lab = self.label(gen.iter)
                if lab:
                    return lab
            return None
        if isinstance(node, ast.Compare):
            return None
        if isinstance(node, ast.Call):
            return self.call_label(node)
        return None

    def call_label(self, node: ast.Call) -> Optional[str]:
        text = dotted_name(node.func)
        base = _basename(text) if text else ""
        arg_labels = [self.label(a) for a in node.args]
        kw_labels = [self.label(kw.value) for kw in node.keywords]
        any_hostile = next(
            (l for l in arg_labels + kw_labels if l), None)
        site = self.site_for(node)
        callees = site.callees if site else ()
        # sanctioning guards: result clean, hostile Name args sanitized
        if _GUARD_RE.match(base) or any(
                _GUARD_RE.match(_qual_basename(q)) for q in callees):
            for a in node.args:
                if isinstance(a, ast.Name):
                    self.hostile.pop(a.id, None)
            return None
        if base == "min":
            if any(l is None for l in arg_labels) or not arg_labels:
                return None        # clamped by a clean operand
            return arg_labels[0]
        if base == "len":
            return None
        if base in _UNPACK_NAMES and isinstance(node.func, ast.Attribute):
            return _clip(
                f"peer-decoded bytes from `{text}(...)` "
                f"({self.fi.path}:{node.lineno})"
            )
        # resolved callee returning hostile data
        for q in callees:
            ret = self.returns.get(q)
            if ret:
                return _clip(f"{ret} via `{_qual_basename(q)}(...)`")
        if base in _PASS_THROUGH:
            return any_hostile
        return None

    def site_for(self, node: ast.Call):
        for s in self.fi.calls:
            if s.node is node:
                return s
        return None

    # -- sinks ------------------------------------------------------------

    def check_sinks(self, node: ast.AST) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                continue
            if isinstance(sub, ast.Call):
                self.check_call_sink(sub)
            elif isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Mult):
                self.check_repeat_sink(sub)

    def check_call_sink(self, node: ast.Call) -> None:
        text = dotted_name(node.func)
        base = _basename(text) if text else ""
        shape_args = list(node.args[:1]) + [
            kw.value for kw in node.keywords
            if kw.arg in ("shape", "size", "count")
        ]
        if base in _ALLOC_FUNCS and _is_numpy_call(self.aliases, text):
            for a in shape_args:
                lab = self.label(a)
                if lab:
                    self.sink(node, f"array allocation `{text}(...)`", lab)
                    return
        elif base in ("bytearray", "bytes") and node.args:
            lab = self.label(node.args[0])
            if lab:
                self.sink(node, f"buffer allocation `{base}(...)`", lab)
        elif base == "OffsetList" and node.args:
            for a in node.args:
                lab = self.label(a)
                if lab:
                    self.sink(node, "`OffsetList(...)` extent", lab)
                    return
        elif base == "range":
            for a in node.args:
                lab = self.label(a)
                if lab:
                    self.sink(node, "loop bound `range(...)`", lab)
                    return

    def check_repeat_sink(self, node: ast.BinOp) -> None:
        def is_seq_literal(n: ast.AST) -> bool:
            return isinstance(n, (ast.List, ast.Tuple)) or (
                isinstance(n, ast.Constant)
                and isinstance(n.value, (str, bytes)))

        for seq, count in ((node.left, node.right),
                           (node.right, node.left)):
            if is_seq_literal(seq):
                lab = self.label(count)
                if lab:
                    self.sink(node, "sequence repetition `seq * n`", lab)
                return

    # -- statements -------------------------------------------------------

    def block(self, body: List[ast.stmt]) -> None:
        for stmt in body:
            self.stmt(stmt)

    def stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.If):
            self.check_sinks(stmt.test)
            guard_names = self.guarded_names(stmt)
            before = dict(self.hostile)
            self.block(stmt.body)
            after_body = self.hostile
            self.hostile = dict(before)
            self.block(stmt.orelse)
            for k, v in after_body.items():
                self.hostile.setdefault(k, v)
            for name in guard_names:
                self.hostile.pop(name, None)
            return
        if isinstance(stmt, ast.Assert):
            self.check_sinks(stmt.test)
            for name in _names_in(stmt.test):
                self.hostile.pop(name, None)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self.check_sinks(stmt.iter)
            lab = self.label(stmt.iter)
            if lab and isinstance(stmt.target, ast.Name):
                self.hostile[stmt.target.id] = lab
            elif lab and isinstance(stmt.target, (ast.Tuple, ast.List)):
                for elt in stmt.target.elts:
                    if isinstance(elt, ast.Name):
                        self.hostile[elt.id] = lab
            for _ in range(2):      # loop-carried taint needs a 2nd pass
                self.block(stmt.body)
            self.block(stmt.orelse)
            return
        if isinstance(stmt, ast.While):
            self.check_sinks(stmt.test)
            for _ in range(2):
                self.block(stmt.body)
            self.block(stmt.orelse)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self.visit_expr(item.context_expr)
            self.block(stmt.body)
            return
        if isinstance(stmt, ast.Try):
            self.block(stmt.body)
            for h in stmt.handlers:
                self.block(h.body)
            self.block(stmt.orelse)
            self.block(stmt.finalbody)
            return
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self.visit_expr(stmt.value)
                lab = self.label(stmt.value)
                if lab and self.ret_label is None:
                    self.ret_label = lab
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = stmt.value
            if value is not None:
                self.visit_expr(value)
            lab = self.label(value) if value is not None else None
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                self.assign_target(t, lab, value,
                                   aug=isinstance(stmt, ast.AugAssign))
            return
        if isinstance(stmt, ast.Expr):
            self.visit_expr(stmt.value)
            return
        for sub in ast.iter_child_nodes(stmt):
            if isinstance(sub, ast.expr):
                self.visit_expr(sub)

    def guarded_names(self, stmt: ast.If) -> Set[str]:
        """Names sanitized by a raise/return-guarded if: the bounds
        idiom (`if not (0 <= k <= cap): raise`)."""
        def exits(body: List[ast.stmt]) -> bool:
            return any(isinstance(s, (ast.Raise, ast.Return, ast.Continue,
                                      ast.Break)) for s in body)

        if exits(stmt.body) or (stmt.orelse and exits(stmt.orelse)):
            return _names_in(stmt.test) & set(self.hostile)
        return set()

    def assign_target(self, t: ast.AST, lab: Optional[str],
                      value: Optional[ast.AST], aug: bool = False) -> None:
        if isinstance(t, ast.Name):
            if lab:
                self.hostile[t.id] = lab
            elif not aug:
                self.hostile.pop(t.id, None)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for i, elt in enumerate(t.elts):
                sub_lab = lab
                if (lab is None and isinstance(value, (ast.Tuple, ast.List))
                        and i < len(value.elts)):
                    sub_lab = self.label(value.elts[i])
                self.assign_target(elt, sub_lab, None)
        elif isinstance(t, ast.Subscript):
            idx_lab = self.label(t.slice)
            if idx_lab:
                self.sink(t, "subscript store index", idx_lab)

    def visit_expr(self, expr: ast.AST) -> None:
        """Sink-check an expression tree and record callee-arg taint."""
        self.check_sinks(expr)
        for sub in ast.walk(expr):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                continue
            if not isinstance(sub, ast.Call):
                continue
            site = self.site_for(sub)
            if site is None or not site.callees:
                continue
            for q in site.callees:
                fi = self.project.functions.get(q)
                if fi is None:
                    continue
                params = _param_names(fi)
                for i, a in enumerate(sub.args):
                    lab = self.label(a)
                    if lab and i < len(params):
                        self.arg_taint.append((q, params[i], lab))
                for kw in sub.keywords:
                    lab = self.label(kw.value)
                    if lab and kw.arg in params:
                        self.arg_taint.append((q, kw.arg, lab))
            # evaluating the call also applies guard sanitization
            self.call_label(sub)


class _HostileState:
    """Project-wide fixpoint over function summaries: which params
    receive hostile data, which returns carry it — then a final pass
    collects sink findings per function."""

    _MAX_ROUNDS = 8

    def __init__(self, project: ProjectContext):
        self.project = project
        #: qual -> {param name -> witness label}
        self.params: Dict[str, Dict[str, str]] = {}
        #: qual -> label of a hostile return value
        self.returns: Dict[str, str] = {}
        #: qual -> [(node, sink description, label)]
        self.sinks: Dict[str, List[Tuple[ast.AST, str, str]]] = {}
        self._compute()

    def _aliases(self, fi: FunctionInfo) -> Dict[str, str]:
        mod = self.project.modules.get(fi.module)
        return mod.aliases if mod else {}

    def _compute(self) -> None:
        quals = sorted(self.project.functions)
        for _ in range(self._MAX_ROUNDS):
            changed = False
            for qual in quals:
                fi = self.project.functions[qual]
                a = _Analysis(self.project, fi, self._aliases(fi),
                              self.params.get(qual, {}), self.returns)
                if a.ret_label and qual not in self.returns:
                    self.returns[qual] = _clip(a.ret_label)
                    changed = True
                for callee, param, lab in a.arg_taint:
                    cur = self.params.setdefault(callee, {})
                    if param not in cur:
                        cfi = self.project.functions.get(callee)
                        cname = _qual_basename(callee)
                        cur[param] = _clip(
                            f"{lab}, fed to param `{param}` of "
                            f"`{cname}` from {fi.path}:{fi.node.lineno}"
                        ) if cfi is not None else lab
                        changed = True
            if not changed:
                break
        for qual in quals:
            fi = self.project.functions[qual]
            a = _Analysis(self.project, fi, self._aliases(fi),
                          self.params.get(qual, {}), self.returns)
            if a.sinks:
                self.sinks[qual] = a.sinks


class UnboundedHostileInputRule(Rule):
    name = "unbounded-hostile-input"
    description = (
        "a peer-decoded value (msgpack.unpackb / *.unpack wire, WAL, "
        "snapshot and checkpoint seams) flows into a size-bearing sink "
        "(np/jnp allocation shape, bytearray/bytes size, sequence "
        "repetition, OffsetList extent, range() loop bound, subscript "
        "store index) without a sanctioning bounds guard (check_*-"
        "family helper, min() clamp, raise-guarded if) — the byzantine "
        "1.1 TB OOM class, closed statically"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project: ProjectContext = ctx.project
        if project is None:
            return
        state = getattr(project, "_hostile_state", None)
        if state is None:
            state = _HostileState(project)
            project._hostile_state = state
        for qual in sorted(state.sinks):
            fi = project.functions.get(qual)
            if fi is None or fi.path != ctx.path:
                continue
            for node, what, label in state.sinks[qual]:
                yield self.finding(
                    ctx, node,
                    f"{what} in `{fi.name}` is sized by {label} that "
                    "never passed a sanctioning bounds guard "
                    "(check_*-family helper, min() clamp, or a "
                    "raise-guarded if) — a hostile peer chooses the "
                    "size; clamp it against local bounds first",
                )
