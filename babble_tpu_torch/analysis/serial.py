"""Serialization-plane schema lint (babble-lint v5): three rule
families over every byte that crosses a process boundary.

Every serialized surface in this tree — wire commands, checkpoint
meta, fast-forward snapshots, WAL records, the AOT manifest — is both
a trust boundary (peers are hostile) and the compatibility surface the
engine-unification and multi-host lifts will churn hardest.  The
repo's history shows the defect class the other rule families do not
gate: ECDSA scalars packed as raw 256-bit ints that only the
serialization-free in-memory transport tolerated, ``bytes()``
on a peer-decoded int, and checkpoint-meta growth silently
invalidating the canned disk-rot fingerprint three PRs running.

1. ``pack-unpack-parity`` — for every class carrying a writer/reader
   pair (``pack``/``unpack``, ``to_dict``/``from_dict``,
   ``to_meta``/``from_meta``), the field inventory WRITTEN (msgpack
   list positions or dict keys, resolved through local assignment
   chains) is diffed against the inventory READ.  A field packed but
   never unpacked, a read at a position the writer never emits, or an
   unguarded positional read ABOVE a default-guarded one (the tail a
   pre-upgrade peer omits would crash it) is a finding whose witness
   names both sides.  Readers that absorb the payload generically
   (``cls(**d)``) are opaque: only their explicit reads are checked.

2. ``checkpoint-field-coverage`` — the exact-partition discipline of
   ``partition-spec-coverage``/``bytes-model-coverage`` applied to the
   checkpoint plane: every key a ``_build_*meta`` builder writes must
   be read by the paired ``_check_*_meta`` bounds guard on the hostile
   adoption path AND by a paired restore/loader function (a ``.get``
   with default IS the sanctioned older-version backfill).  A checker
   that bounds a key no builder writes is the same drift from the
   other side.  Builders/checkers/restores pair by module and by
   fork-ness (``fork`` in the function name).

3. ``format-version-ratchet`` — a committed manifest
   (``.babble-format-manifest.json``, discovered by walking up from
   each surface's module) records the field inventory per serialized
   surface keyed to its version constant (``FORMAT_VERSION``,
   ``FORK_FORMAT_VERSION``, ``ENGINE_CACHE_VERSION``).  Changing an
   inventory without bumping the paired constant fails lint like a new
   finding; ``--write-format-manifest`` (analysis/cli.py) is the
   sanctioned bump path and itself refuses to record a changed
   inventory under an unbumped constant.  A tree with no manifest in
   scope is not checked by this rule — the tier-1 suite asserts the
   committed manifest exists and equals the tree's inventory.

All three stand on the project graph and stay stdlib-only.
"""

from __future__ import annotations

import ast
import json
import os
import re
import struct as _struct  # noqa: F401  (kept: mirrored surface docs)
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .engine import FileContext, Finding, Rule
from .graph import FunctionInfo, ProjectContext, dotted_name

MANIFEST_NAME = ".babble-format-manifest.json"

#: writer/reader method-name pairs that define a serialization surface
PAIR_NAMES: Tuple[Tuple[str, str], ...] = (
    ("pack", "unpack"),
    ("to_dict", "from_dict"),
    ("to_meta", "from_meta"),
)

_BUILDER_RE = re.compile(r"^_?build_(\w+_)?meta$")
_CHECKER_RE = re.compile(r"^_?check_(\w+_)?meta$")
_RESTORE_RE = re.compile(r"^_?restore_\w+$")
_LOADER_RE = re.compile(r"^load_\w+$")


# ----------------------------------------------------------------------
# manifest discovery


def manifest_candidate_paths(files) -> List[str]:
    """Every path where a format manifest could shadow one of `files`,
    walking each file's directory chain upward until an existing
    manifest, a ``.git`` directory (repo root) or the filesystem root.
    cache.py stats ALL of these: creating or editing a manifest
    anywhere on the chain must invalidate the whole-run cache, because
    the ratchet rule's findings depend on the manifest's content."""
    out: List[str] = []
    seen_dirs: Set[str] = set()
    for path in files:
        path = os.path.abspath(path)
        # a directory is its own first candidate (the CLI passes the
        # linted directory here); a file starts at its parent
        d = path if os.path.isdir(path) else os.path.dirname(path)
        while d not in seen_dirs:
            seen_dirs.add(d)
            cand = os.path.join(d, MANIFEST_NAME)
            out.append(cand)
            if os.path.exists(cand) or os.path.isdir(
                    os.path.join(d, ".git")):
                break
            parent = os.path.dirname(d)
            if parent == d:
                break
            d = parent
    return sorted(set(out))


def find_manifest(path: str) -> Optional[str]:
    """Nearest existing manifest on `path`'s directory chain."""
    for cand in manifest_candidate_paths([path]):
        if os.path.isfile(cand):
            return cand
    return None


# ----------------------------------------------------------------------
# writer-side inventory extraction


@dataclass
class WriteInv:
    """Statically resolved field inventory of one writer function."""

    kind: str                                   # "list" | "dict"
    labels: List[str]
    label_nodes: Dict[str, ast.AST] = field(default_factory=dict)
    #: Name referenced by the "version" dict entry, if any
    version_const: Optional[str] = None
    #: builders this one delegates to (``meta = _build_meta(...)``)
    inherits: List[str] = field(default_factory=list)


def _simple_assigns(fn: ast.AST) -> Dict[str, List[ast.AST]]:
    out: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            out.setdefault(node.targets[0].id, []).append(node.value)
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Name):
            out.setdefault(node.target.id, []).append(node.value)
    return out


def _unwrap_packb(node: ast.AST) -> ast.AST:
    """``msgpack.packb(X, ...)`` -> X; anything else unchanged."""
    if isinstance(node, ast.Call):
        base = dotted_name(node.func).rsplit(".", 1)[-1]
        if base == "packb" and node.args:
            return node.args[0]
    return node


def _self_attr_in(node: ast.AST) -> Optional[str]:
    """First ``self.<attr>`` read inside `node` (depth-first)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and \
                isinstance(sub.value, ast.Name) and sub.value.id == "self":
            return sub.attr
    return None


def _element_label(elt: ast.AST) -> str:
    attr = _self_attr_in(elt)
    if attr is not None:
        return attr
    try:
        return ast.unparse(elt)[:60]
    except Exception:
        return "<expr>"


def extract_write(fi: FunctionInfo) -> Optional[WriteInv]:
    """The field inventory `fi` writes, or None when it cannot be
    statically resolved (no list/dict literal reachable from a return,
    or a dict built with ``**`` expansion)."""
    assigns = _simple_assigns(fi.node)
    for node in ast.walk(fi.node):
        if not isinstance(node, ast.Return) or node.value is None:
            continue
        value = _unwrap_packb(node.value)
        ret_name: Optional[str] = None
        hops = 0
        while isinstance(value, ast.Name) and hops < 4:
            ret_name = value.id
            cands = assigns.get(value.id)
            if not cands:
                break
            value = _unwrap_packb(cands[0])
            hops += 1
        if isinstance(value, (ast.List, ast.Tuple)):
            labels, nodes = [], {}
            for elt in value.elts:
                label = _element_label(elt)
                labels.append(label)
                nodes.setdefault(label, elt)
            return WriteInv(kind="list", labels=labels, label_nodes=nodes)
        inherits: List[str] = []
        if isinstance(value, ast.Call):
            base = dotted_name(value.func).rsplit(".", 1)[-1]
            if _BUILDER_RE.match(base):
                inherits.append(base)
                value = ast.Dict(keys=[], values=[])
        if isinstance(value, ast.Dict):
            labels, nodes = [], {}
            version_const = None
            for k, v in zip(value.keys, value.values):
                if k is None:
                    return None            # **expansion: opaque writer
                if not (isinstance(k, ast.Constant)
                        and isinstance(k.value, str)):
                    return None
                labels.append(k.value)
                nodes.setdefault(k.value, k)
                if k.value == "version" and isinstance(v, ast.Name):
                    version_const = v.id
            # augmenting writes: name["k"] = ... anywhere in the body
            if ret_name is not None:
                for sub in ast.walk(fi.node):
                    if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                        targets = (sub.targets
                                   if isinstance(sub, ast.Assign)
                                   else [sub.target])
                        for t in targets:
                            if isinstance(t, ast.Subscript) \
                                    and isinstance(t.value, ast.Name) \
                                    and t.value.id == ret_name \
                                    and isinstance(t.slice, ast.Constant) \
                                    and isinstance(t.slice.value, str):
                                if t.slice.value not in nodes:
                                    labels.append(t.slice.value)
                                    nodes[t.slice.value] = t
            return WriteInv(kind="dict", labels=labels, label_nodes=nodes,
                            version_const=version_const,
                            inherits=inherits)
    return None


# ----------------------------------------------------------------------
# reader-side inventory extraction


@dataclass
class ReadInv:
    """What one reader function reads from its decoded payload."""

    #: position -> guarded (True = only ever read under a len() guard
    #: or with an inline default; an unguarded read anywhere wins False)
    positions: Dict[int, bool] = field(default_factory=dict)
    position_nodes: Dict[int, ast.AST] = field(default_factory=dict)
    #: key -> has-default (``.get``/guarded; unguarded wins False)
    keys: Dict[str, bool] = field(default_factory=dict)
    key_nodes: Dict[str, ast.AST] = field(default_factory=dict)
    #: reader forwards the payload wholesale (``cls(**d)``): its
    #: explicit reads are still checked, but missing reads are not
    absorbing: bool = False
    #: False when no payload root or read was recognized at all
    resolvable: bool = False


def _payload_roots(fi: FunctionInfo) -> Set[str]:
    """Names holding the decoded payload inside a reader: any name
    assigned from ``*.unpackb(...)`` (chained through ``dict(x)`` /
    plain rebinds), else every non-cls/self parameter — restore
    helpers take the decoded meta at any position
    (``_restore_host(engine, meta)``), and only string-key /
    whole-tuple reads are ever collected from the extra roots."""
    roots: Set[str] = set()
    args = getattr(fi.node, "args", None)
    params = [a.arg for a in args.args] if args is not None else []
    params = [p for p in params if p not in ("self", "cls")]
    has_unpackb = False
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Call):
            base = dotted_name(node.func).rsplit(".", 1)[-1]
            if base == "unpackb":
                has_unpackb = True
    if not has_unpackb:
        roots.update(params)
    # propagate through simple assignment chains, to fixpoint (the
    # bodies are small; two passes cover `d = dict(d)` style chains)
    for _ in range(3):
        grew = False
        for node in ast.walk(fi.node):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            tgt = node.targets[0].id
            if tgt in roots:
                continue
            v = node.value
            is_root_expr = False
            if isinstance(v, ast.Call):
                base = dotted_name(v.func).rsplit(".", 1)[-1]
                if base == "unpackb":
                    is_root_expr = True
                elif base == "dict" and v.args \
                        and isinstance(v.args[0], ast.Name) \
                        and v.args[0].id in roots:
                    is_root_expr = True
            elif isinstance(v, ast.Name) and v.id in roots:
                is_root_expr = True
            if is_root_expr:
                roots.add(tgt)
                grew = True
        if not grew:
            break
    return roots


def _test_guards_payload(test: ast.AST, roots: Set[str]) -> bool:
    """Does a branch/conditional test inspect the payload's shape —
    ``len(root)`` comparisons, ``"k" in root``, truthiness of root?"""
    for sub in ast.walk(test):
        if isinstance(sub, ast.Call):
            base = dotted_name(sub.func).rsplit(".", 1)[-1]
            if base == "len" and sub.args \
                    and isinstance(sub.args[0], ast.Name) \
                    and sub.args[0].id in roots:
                return True
        if isinstance(sub, ast.Compare):
            for cmp in sub.comparators:
                if isinstance(cmp, ast.Name) and cmp.id in roots:
                    return True
        if isinstance(sub, ast.Name) and sub.id in roots \
                and isinstance(test, (ast.Name, ast.UnaryOp)):
            return True
    return False


def _for_string_bindings(node: ast.For) -> Dict[str, Set[str]]:
    """Loop variables bound to constant strings by THIS for statement's
    iteration over a literal tuple/list — ``for name, want in
    (("levels", ne), ...)`` reads ``meta[name]`` for every such name,
    and the checker-coverage table in _check_fork_meta is exactly this
    shape.  Scoped per loop: two loops reusing one variable name must
    not merge their key sets."""
    out: Dict[str, Set[str]] = {}
    if not isinstance(node.iter, (ast.Tuple, ast.List)):
        return out
    tgt = node.target
    if isinstance(tgt, ast.Name):
        names = [tgt.id]
    elif isinstance(tgt, ast.Tuple) and all(
            isinstance(e, ast.Name) for e in tgt.elts):
        names = [e.id for e in tgt.elts]
    else:
        return out
    for elt in node.iter.elts:
        vals = elt.elts if isinstance(elt, ast.Tuple) else [elt]
        for name, v in zip(names, vals):
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                out.setdefault(name, set()).add(v.value)
    return out


def extract_read(fi: FunctionInfo) -> ReadInv:
    inv = ReadInv()
    roots = _payload_roots(fi)
    if not roots:
        return inv
    loop_stack: List[Dict[str, Set[str]]] = []

    def lookup_loop_var(name: str) -> Optional[Set[str]]:
        for bindings in reversed(loop_stack):
            if name in bindings:
                return bindings[name]
        return None

    def record_pos(pos: int, guarded: bool, node: ast.AST) -> None:
        inv.resolvable = True
        if pos in inv.positions:
            inv.positions[pos] = inv.positions[pos] and guarded
        else:
            inv.positions[pos] = guarded
            inv.position_nodes[pos] = node

    def record_key(key: str, guarded: bool, node: ast.AST) -> None:
        inv.resolvable = True
        if key in inv.keys:
            inv.keys[key] = inv.keys[key] and guarded
        else:
            inv.keys[key] = guarded
            inv.key_nodes[key] = node

    def visit(node: ast.AST, depth: int) -> None:
        if isinstance(node, ast.For):
            visit(node.iter, depth)
            visit(node.target, depth)
            loop_stack.append(_for_string_bindings(node))
            for child in node.body + node.orelse:
                visit(child, depth)
            loop_stack.pop()
            return
        if isinstance(node, ast.If):
            guarded = _test_guards_payload(node.test, roots)
            visit(node.test, depth)
            bump = 1 if guarded else 0
            for child in node.body + node.orelse:
                visit(child, depth + bump)
            return
        if isinstance(node, ast.IfExp):
            guarded = _test_guards_payload(node.test, roots)
            visit(node.test, depth)
            bump = 1 if guarded else 0
            visit(node.body, depth + bump)
            visit(node.orelse, depth + bump)
            return
        if isinstance(node, ast.Assign) and isinstance(
                node.value, (ast.Name, ast.Call)):
            # tuple unpacking of the whole payload: positions 0..m-1
            v = node.value
            is_payload = (isinstance(v, ast.Name) and v.id in roots) or (
                isinstance(v, ast.Call)
                and dotted_name(v.func).rsplit(".", 1)[-1] == "unpackb"
            )
            if is_payload and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Tuple):
                for i, _t in enumerate(node.targets[0].elts):
                    record_pos(i, depth > 0, node)
        if isinstance(node, ast.Subscript) \
                and isinstance(node.value, ast.Name) \
                and node.value.id in roots \
                and not isinstance(getattr(node, "ctx", None), ast.Store):
            if isinstance(node.slice, ast.Constant):
                if isinstance(node.slice.value, int) \
                        and not isinstance(node.slice.value, bool):
                    record_pos(node.slice.value, depth > 0, node)
                elif isinstance(node.slice.value, str):
                    record_key(node.slice.value, depth > 0, node)
            elif isinstance(node.slice, ast.Name):
                bound = lookup_loop_var(node.slice.id)
                for k in bound or ():
                    record_key(k, depth > 0, node)
        if isinstance(node, ast.Call):
            base = dotted_name(node.func).rsplit(".", 1)[-1]
            recv = node.func.value if isinstance(
                node.func, ast.Attribute) else None
            on_root = isinstance(recv, ast.Name) and recv.id in roots
            if on_root and base in ("get", "pop") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                has_default = len(node.args) > 1
                record_key(node.args[0].value,
                           has_default or depth > 0, node)
            for kw in node.keywords:
                if kw.arg is None and isinstance(kw.value, ast.Name) \
                        and kw.value.id in roots:
                    inv.absorbing = True
                    inv.resolvable = True
        for child in ast.iter_child_nodes(node):
            visit(child, depth)

    body = getattr(fi.node, "body", [])
    for stmt in body:
        visit(stmt, 0)
    return inv


# ----------------------------------------------------------------------
# project-wide serialization state (computed once, cached on project)


@dataclass
class Surface:
    """One manifest-tracked serialized surface of the tree."""

    name: str
    path: str                       # absolute module path
    fields: List[str]
    node: ast.AST                   # anchor for ratchet findings
    version_const: Optional[str] = None
    version: object = None          # resolved constant value


def _module_constants(tree: ast.Module) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant):
            out[node.targets[0].id] = node.value.value
    return out


class _SerialState:
    """All three families' findings, computed in one pass over the
    project graph and grouped by file — the parity-rule pattern."""

    def __init__(self, project: ProjectContext):
        self.project = project
        #: path -> list of (rule_name, anchor_node_or_line, message)
        self.by_path: Dict[str, List[Tuple[str, object, str]]] = {}
        self.surfaces: Dict[str, Surface] = {}
        self._scan_pairs()
        self._scan_builders()
        self._scan_frames()
        self._scan_versioned_manifests()
        self._ratchet()

    def _emit(self, rule: str, path: str, node, msg: str) -> None:
        self.by_path.setdefault(path, []).append((rule, node, msg))

    # -- family 1: pack/unpack parity ---------------------------------

    def _scan_pairs(self) -> None:
        project = self.project
        for ci in project.classes.values():
            mod = project.modules.get(ci.module)
            if mod is None:
                continue
            for w_name, r_name in PAIR_NAMES:
                wq, rq = ci.methods.get(w_name), ci.methods.get(r_name)
                if not wq or not rq:
                    continue
                wfi, rfi = project.functions.get(wq), project.functions.get(rq)
                if wfi is None or rfi is None:
                    continue
                winv = extract_write(wfi)
                if winv is None:
                    continue
                self._register_pair_surface(ci, mod, wfi, winv)
                rinv = extract_read(rfi)
                if not rinv.resolvable:
                    continue
                wl = f"{ci.name}.{w_name}"
                rl = f"{ci.name}.{r_name}"
                if winv.kind == "list":
                    self._diff_positional(mod.path, winv, rinv, wl, rl,
                                          wfi)
                else:
                    self._diff_keyed(mod.path, winv, rinv, wl, rl)

    def _diff_positional(self, path, winv, rinv, wl, rl, wfi) -> None:
        n = len(winv.labels)
        for p in range(n):
            if p not in rinv.positions:
                label = winv.labels[p]
                self._emit(
                    "pack-unpack-parity", path,
                    winv.label_nodes.get(label, wfi.node),
                    f"field `{label}` is packed at position {p} by "
                    f"`{wl}` but `{rl}` never reads position {p} — "
                    "the value crosses the wire and is dropped "
                    "(or every later position is off by one)",
                )
        for p, node in sorted(rinv.position_nodes.items()):
            if p >= n:
                self._emit(
                    "pack-unpack-parity", path, node,
                    f"`{rl}` reads position {p} but `{wl}` writes only "
                    f"{n} field(s) (0..{n - 1}) — a drifted read that "
                    "can only bind a foreign field or raise",
                )
        guarded_only = [p for p, g in rinv.positions.items() if g]
        if guarded_only:
            lo = min(guarded_only)
            for p, g in sorted(rinv.positions.items()):
                if not g and p > lo and p < n:
                    self._emit(
                        "pack-unpack-parity", path,
                        rinv.position_nodes[p],
                        f"`{rl}` reads position {p} without a "
                        f"missing-field default while position {lo} is "
                        "guarded — a peer speaking the older format "
                        "omits the tail and this read raises; guard it "
                        "or give it an explicit default",
                    )

    def _diff_keyed(self, path, winv, rinv, wl, rl) -> None:
        for k in winv.labels:
            if k not in rinv.keys and not rinv.absorbing:
                self._emit(
                    "pack-unpack-parity", path,
                    winv.label_nodes[k],
                    f"key `{k}` is written by `{wl}` but `{rl}` never "
                    "reads it — serialized state that silently "
                    "vanishes on the read side",
                )
        for k, has_default in rinv.keys.items():
            if k not in winv.labels and not has_default:
                self._emit(
                    "pack-unpack-parity", path, rinv.key_nodes[k],
                    f"`{rl}` reads key `{k}` without a default but "
                    f"`{wl}` never writes it — raises on every "
                    "payload the paired writer produces",
                )

    def _register_pair_surface(self, ci, mod, wfi, winv) -> None:
        fields = (list(winv.labels) if winv.kind == "list"
                  else sorted(winv.labels))
        name = f"wire:{ci.module}:{ci.name}"
        self.surfaces[name] = Surface(
            name=name, path=mod.path, fields=fields, node=wfi.node,
        )

    # -- family 2: checkpoint-field-coverage --------------------------

    def _scan_builders(self) -> None:
        project = self.project
        builders = [
            fi for fi in project.functions.values()
            if fi.cls is None and _BUILDER_RE.match(fi.name)
        ]
        if not builders:
            return
        # keyed by (module, name): distinct modules may define
        # same-named builders, and delegation is same-module only
        invs: Dict[Tuple[str, str], Optional[WriteInv]] = {
            (fi.module, fi.name): extract_write(fi) for fi in builders
        }

        def full_keys(module: str, name: str,
                      seen: Set[Tuple[str, str]]) -> Tuple[
                List[str], Optional[str]]:
            """Builder's keys incl. delegated builders; returns
            (keys, version_const)."""
            inv = invs.get((module, name))
            if inv is None or (module, name) in seen:
                return [], None
            seen.add((module, name))
            keys = list(inv.labels)
            vc = inv.version_const
            for parent in inv.inherits:
                pk, pvc = full_keys(module, parent, seen)
                keys.extend(k for k in pk if k not in keys)
                vc = vc or pvc
            return keys, vc

        modules = {fi.module for fi in builders}
        for module in modules:
            mod = self.project.modules.get(module)
            if mod is None:
                continue
            mod_builders = [fi for fi in builders if fi.module == module]
            checkers = [
                fi for fi in project.functions.values()
                if fi.cls is None and fi.module == module
                and _CHECKER_RE.match(fi.name)
            ]
            restores = [
                fi for fi in project.functions.values()
                if fi.cls is None and fi.module == module
                and (_RESTORE_RE.match(fi.name)
                     or _LOADER_RE.match(fi.name))
            ]
            loaders = [fi for fi in restores if _LOADER_RE.match(fi.name)]
            for fork in (False, True):
                side = [fi for fi in mod_builders
                        if ("fork" in fi.name) == fork]
                if not side:
                    continue
                chk = [fi for fi in checkers if ("fork" in fi.name) == fork]
                rst = [fi for fi in restores
                       if _RESTORE_RE.match(fi.name)
                       and ("fork" in fi.name) == fork] + loaders
                chk_reads: Set[str] = set()
                chk_nodes: Dict[str, Tuple[str, ast.AST, str]] = {}
                for fi in chk:
                    rinv = extract_read(fi)
                    chk_reads |= set(rinv.keys)
                    for k, node in rinv.key_nodes.items():
                        chk_nodes.setdefault(k, (fi.path, node, fi.name))
                rst_reads: Set[str] = set()
                for fi in rst:
                    rst_reads |= set(extract_read(fi).keys)
                written: Set[str] = set()
                for fi in side:
                    inv = invs.get((fi.module, fi.name))
                    if inv is None:
                        continue
                    keys, vc = full_keys(fi.module, fi.name, set())
                    written |= set(keys)
                    self._register_builder_surface(fi, mod, keys, vc)
                    chk_names = ", ".join(c.name for c in chk) or \
                        "a _check_*_meta guard"
                    for k in inv.labels:     # own keys only: inherited
                        # ones are reported at their own builder
                        node = inv.label_nodes[k]
                        if chk and k not in chk_reads:
                            self._emit(
                                "checkpoint-field-coverage", fi.path,
                                node,
                                f"meta key `{k}` written by `{fi.name}`"
                                f" never reaches {chk_names} — the "
                                "hostile adoption path consumes it "
                                "with no structural bound; add a "
                                "bounds check before any object is "
                                "built from it",
                            )
                        if rst and k not in rst_reads:
                            self._emit(
                                "checkpoint-field-coverage", fi.path,
                                node,
                                f"meta key `{k}` written by `{fi.name}`"
                                " has no restore-side read or "
                                "older-version backfill — serialized "
                                "state that a restart silently drops",
                            )
                # exact partition, other direction: a checker bounding
                # a key no builder on its side writes is the same
                # drift seen from the guard
                for k in sorted(chk_reads - written):
                    path, node, cname = chk_nodes[k]
                    self._emit(
                        "checkpoint-field-coverage", path, node,
                        f"`{cname}` bounds meta key `{k}` that no "
                        "paired builder writes — either dead guard "
                        "code or a builder rename the checker missed",
                    )

    def _register_builder_surface(self, fi, mod, keys, vc) -> None:
        consts = _module_constants(mod.tree)
        name = f"meta:{fi.module}:{fi.name}"
        self.surfaces[name] = Surface(
            name=name, path=fi.path, fields=sorted(set(keys)),
            node=fi.node, version_const=vc,
            version=consts.get(vc) if vc else None,
        )

    # -- frame + versioned-manifest surfaces --------------------------

    def _scan_frames(self) -> None:
        """Module-level ``NAME = struct.Struct("<fmt>")`` constants in
        WAL modules: the record frame header is a wire inventory."""
        for mod in self.project.modules.values():
            if "wal" not in mod.name.split("."):
                continue
            for node in mod.tree.body:
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and isinstance(node.value, ast.Call)):
                    continue
                base = dotted_name(node.value.func).rsplit(".", 1)[-1]
                if base != "Struct" or not node.value.args:
                    continue
                fmt = node.value.args[0]
                if not (isinstance(fmt, ast.Constant)
                        and isinstance(fmt.value, str)):
                    continue
                cname = node.targets[0].id
                name = f"frame:{mod.name}:{cname}"
                self.surfaces[name] = Surface(
                    name=name, path=mod.path, fields=[fmt.value],
                    node=node,
                )

    def _scan_versioned_manifests(self) -> None:
        """Dict literals whose "version" entry names a module-level
        version constant (the AOT manifest shape): the dict's keys are
        the surface, the constant is the paired version."""
        for mod in self.project.modules.values():
            consts = _module_constants(mod.tree)
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Dict):
                    continue
                keys: List[str] = []
                vc: Optional[str] = None
                for k, v in zip(node.keys, node.values):
                    if not (isinstance(k, ast.Constant)
                            and isinstance(k.value, str)):
                        keys = []
                        break
                    keys.append(k.value)
                    if k.value == "version" and isinstance(v, ast.Name) \
                            and v.id in consts \
                            and v.id.endswith("_VERSION"):
                        vc = v.id
                if vc is None or not keys:
                    continue
                name = f"manifest:{mod.name}:{vc}"
                if name in self.surfaces:
                    prev = self.surfaces[name]
                    merged = sorted(set(prev.fields) | set(keys))
                    prev.fields = merged
                    continue
                self.surfaces[name] = Surface(
                    name=name, path=mod.path, fields=sorted(set(keys)),
                    node=node, version_const=vc, version=consts.get(vc),
                )

    # -- family 3: format-version-ratchet -----------------------------

    def _ratchet(self) -> None:
        by_manifest: Dict[str, List[Surface]] = {}
        for s in self.surfaces.values():
            mpath = find_manifest(s.path)
            if mpath is not None:
                by_manifest.setdefault(mpath, []).append(s)
        for mpath, surfaces in sorted(by_manifest.items()):
            recorded, err = load_manifest(mpath)
            if err is not None:
                s0 = min(surfaces, key=lambda s: (s.path, s.name))
                self._emit(
                    "format-version-ratchet", s0.path, s0.node,
                    f"format manifest {mpath} is unreadable ({err}) — "
                    "the serialization ratchet is off until it parses; "
                    "regenerate it with --write-format-manifest",
                )
                continue
            seen = set()
            for s in sorted(surfaces, key=lambda s: s.name):
                seen.add(s.name)
                entry = recorded.get(s.name)
                if entry is None:
                    self._emit(
                        "format-version-ratchet", s.path, s.node,
                        f"serialized surface `{s.name}` is not "
                        "recorded in the format manifest — record its "
                        "field inventory with --write-format-manifest",
                    )
                    continue
                old_fields = entry.get("fields")
                old_version = entry.get("format_version")
                if s.fields != old_fields:
                    added = sorted(set(s.fields) - set(old_fields or []))
                    removed = sorted(set(old_fields or []) - set(s.fields))
                    delta = "; ".join(
                        p for p in (
                            f"added {added}" if added else "",
                            f"removed {removed}" if removed else "",
                            "" if added or removed else "reordered",
                        ) if p
                    )
                    if s.version_const and s.version == old_version:
                        self._emit(
                            "format-version-ratchet", s.path, s.node,
                            f"field inventory of `{s.name}` changed "
                            f"({delta}) without bumping "
                            f"`{s.version_const}` (still "
                            f"{s.version!r}) — peers cannot "
                            "distinguish the formats; bump the "
                            "constant, add the restore backfill, then "
                            "re-run --write-format-manifest",
                        )
                    else:
                        self._emit(
                            "format-version-ratchet", s.path, s.node,
                            f"field inventory of `{s.name}` changed "
                            f"({delta}) but the committed manifest "
                            "still records the old inventory — re-run "
                            "--write-format-manifest to make the "
                            "change reviewable",
                        )
                elif s.version_const and s.version != old_version:
                    self._emit(
                        "format-version-ratchet", s.path, s.node,
                        f"`{s.version_const}` is now {s.version!r} but "
                        f"the manifest records {old_version!r} for "
                        f"`{s.name}` — re-run --write-format-manifest",
                    )
            mdir = os.path.dirname(mpath)
            for name in sorted(set(recorded) - seen):
                rel = recorded[name].get("path", "")
                apath = os.path.normpath(os.path.join(mdir, rel))
                if apath in self.project.path_module or any(
                        os.path.abspath(p) == apath
                        for p in self.project.path_module):
                    self._emit(
                        "format-version-ratchet", apath, 1,
                        f"surface `{name}` is recorded in the format "
                        "manifest but no longer exists in the tree — "
                        "re-run --write-format-manifest to retire it",
                    )


def serial_state(project: ProjectContext) -> _SerialState:
    state = getattr(project, "_serial_state", None)
    if state is None:
        state = _SerialState(project)
        project._serial_state = state
    return state


# ----------------------------------------------------------------------
# manifest I/O (shared with analysis/cli.py --write-format-manifest)


def load_manifest(path: str) -> Tuple[Dict[str, dict], Optional[str]]:
    """(surfaces, error).  Surfaces is {} on a missing file ONLY when
    the caller checked existence; here a missing/corrupt file is an
    error string so the ratchet can fail loudly, never silently."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError) as e:
        return {}, f"{type(e).__name__}: {e}"
    surfaces = data.get("surfaces") if isinstance(data, dict) else None
    if not isinstance(surfaces, dict):
        return {}, "missing 'surfaces' object"
    return surfaces, None


def compute_surfaces(paths) -> Dict[str, Surface]:
    """Parse `paths` (reusing the engine's file discovery) and return
    the tree's current surface inventory — the writer side of the
    ratchet."""
    from .engine import _load_context, iter_python_files

    contexts = []
    for p in iter_python_files(paths):
        ctx, _errors = _load_context(p)
        if ctx is not None:
            contexts.append((ctx.path, ctx.tree))
    project = ProjectContext(contexts)
    return _SerialState(project).surfaces


def manifest_entry(s: Surface, manifest_dir: str) -> dict:
    entry = {
        "path": os.path.relpath(os.path.abspath(s.path),
                                manifest_dir).replace(os.sep, "/"),
        "fields": s.fields,
    }
    if s.version_const:
        entry["version_const"] = s.version_const
        entry["format_version"] = s.version
    return entry


def write_manifest(path: str, surfaces: Dict[str, Surface]) -> List[str]:
    """Write the manifest; returns the list of REFUSALS — surfaces
    whose inventory changed while their paired version constant did
    not.  When refusals are non-empty nothing is written: the
    sanctioned bump path demands the constant move with the format."""
    old, _err = load_manifest(path) if os.path.exists(path) else ({}, None)
    mdir = os.path.dirname(os.path.abspath(path)) or "."
    refusals: List[str] = []
    for name, s in sorted(surfaces.items()):
        entry = old.get(name)
        if entry is None or not s.version_const:
            continue
        if s.fields != entry.get("fields") \
                and s.version == entry.get("format_version"):
            refusals.append(
                f"{name}: inventory changed but {s.version_const} is "
                f"still {s.version!r} — bump the constant first"
            )
    if refusals:
        return refusals
    doc = {
        "version": 1,
        "surfaces": {
            name: manifest_entry(s, mdir)
            for name, s in sorted(surfaces.items())
        },
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return []


# ----------------------------------------------------------------------
# the three Rule fronts


class _SerialRuleBase(Rule):
    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project = ctx.project
        if project is None:
            return
        state = serial_state(project)
        for rule, anchor, msg in state.by_path.get(ctx.path, []):
            if rule != self.name:
                continue
            if isinstance(anchor, int):
                yield Finding(rule=self.name, path=ctx.path,
                              line=anchor, col=0, message=msg)
            else:
                yield self.finding(ctx, anchor, msg)


class PackUnpackParityRule(_SerialRuleBase):
    name = "pack-unpack-parity"
    description = (
        "every writer/reader pair (pack/unpack, to_dict/from_dict, "
        "to_meta/from_meta) must read exactly the field inventory it "
        "writes — a field packed but never unpacked, a read past the "
        "written arity, or an unguarded read above a default-guarded "
        "position is wire-format drift the in-memory transport would "
        "never surface"
    )


class CheckpointFieldCoverageRule(_SerialRuleBase):
    name = "checkpoint-field-coverage"
    description = (
        "every key a _build_*meta builder serializes must be bounds-"
        "checked by the paired _check_*_meta guard on the hostile "
        "adoption path AND read (or explicitly backfilled) by the "
        "paired restore functions; a checker bounding an unwritten "
        "key is the same drift from the other side"
    )


class FormatVersionRatchetRule(_SerialRuleBase):
    name = "format-version-ratchet"
    description = (
        "the committed .babble-format-manifest.json records each "
        "serialized surface's field inventory keyed to its version "
        "constant; changing an inventory without bumping the paired "
        "constant (FORMAT_VERSION, FORK_FORMAT_VERSION, "
        "ENGINE_CACHE_VERSION) fails lint — --write-format-manifest "
        "is the sanctioned bump path"
    )
