"""Wire codecs on the event loop: ``codec-on-loop``.

The ingress plane moved gossip-frame msgpack encode/decode off the
event loop (net/codec.py): a loaded sync/push response carries hundreds
of events, and transcoding it inline stalls every other RPC, heartbeat
and submit for the duration — the codec twin of the blocking-socket
mistake ``asyncio-blocking-call`` polices.  This rule keeps big-frame
codecs from creeping back onto the loop:

Flagged inside any ``async def`` (nested sync ``def``/``lambda`` bodies
pruned — a closure handed to ``run_in_executor`` is the *correct*
pattern):

- direct ``msgpack.packb(...)`` / ``msgpack.unpackb(...)`` calls
  (import aliases resolved);
- calls that the project call graph (graph.py) resolves into a function
  whose transitive call closure reaches ``msgpack.packb``/``unpackb``
  — serializing a checkpoint two frames down still happens on the
  loop (propagation follows only non-nested call sites, so a chain
  routed through an executor closure breaks the taint exactly where
  the work leaves the loop);
- *unresolved* ``.pack()`` / ``.unpack()`` method calls — the wire
  command objects are duck-typed at the transport, so the graph cannot
  see them; name-based recall is the same trade the race rule makes
  for locks.  Receivers bound to ``struct.Struct`` at module level
  (frame headers, fixed few-byte encodes) are exempt.

The sanctioned escape is net/codec.py: ``encode_frame``/``decode_frame``
run small frames inline (named suppressions at the two fast-path call
sites — the size gate is the justification) and big frames on the
dedicated codec thread.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set, Tuple

from .engine import FileContext, Finding, Rule
from .graph import CallSite, ProjectContext, dotted_name

_MSGPACK = {"msgpack.packb", "msgpack.unpackb"}
_CODEC_ATTRS = {"pack", "unpack"}


def _aliased(project: ProjectContext, module: str, dotted: str) -> str:
    """Rewrite the leading segment through the module's import aliases
    (``mp.packb`` -> ``msgpack.packb``; a bare ``packb`` from
    ``from msgpack import packb`` -> ``msgpack.packb``)."""
    if not dotted:
        return dotted
    mod = project.modules.get(module)
    if mod is None:
        return dotted
    parts = dotted.split(".")
    tgt = mod.aliases.get(parts[0])
    if tgt and tgt != parts[0]:
        return ".".join([tgt] + parts[1:])
    return dotted


def _nested_call_ids(fn: ast.AST) -> Set[int]:
    """ids of Call nodes living inside nested def/lambda bodies of
    ``fn`` — those run on whatever thread invokes the closure (usually
    an executor), not on this coroutine's schedule."""
    out: Set[int] = set()
    for node in ast.walk(fn):
        if node is fn:
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    out.add(id(sub))
    return out


def _module_struct_names(tree: ast.Module) -> Set[str]:
    """Module-level names bound to ``struct.Struct(...)`` — fixed-size
    header codecs, a few bytes each, exempt from the name heuristic."""
    out: Set[str] = set()
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign):
            continue
        v = stmt.value
        if (isinstance(v, ast.Call)
                and dotted_name(v.func) in ("struct.Struct", "Struct")):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


class _CodecState:
    """Project-wide closure of functions reaching msgpack, computed
    once per run and cached on the ProjectContext."""

    def __init__(self, project: ProjectContext):
        #: qualname -> pruned (non-nested) call sites
        self.live_calls: Dict[str, List[CallSite]] = {}
        self.codecful: Set[str] = set()
        self.via: Dict[str, str] = {}
        for qual, fi in project.functions.items():
            nested = _nested_call_ids(fi.node)
            live = [s for s in fi.calls if id(s.node) not in nested]
            self.live_calls[qual] = live
            for site in live:
                dotted = _aliased(project, fi.module,
                                  dotted_name(site.node.func))
                if dotted in _MSGPACK:
                    self.codecful.add(qual)
                    self.via[qual] = f"calls `{dotted}` directly"
                    break
        # propagate caller-ward over the pruned edges only: an
        # executor-routed closure breaks the chain by construction
        changed = True
        while changed:
            changed = False
            for qual, live in self.live_calls.items():
                if qual in self.codecful:
                    continue
                for site in live:
                    hit = next(
                        (c for c in site.callees if c in self.codecful),
                        None,
                    )
                    if hit is not None:
                        self.codecful.add(qual)
                        self.via[qual] = (
                            f"reaches msgpack via `{hit.rsplit(':', 1)[-1]}`"
                        )
                        changed = True
                        break


def _state(project: ProjectContext) -> _CodecState:
    st = getattr(project, "_codec_on_loop_state", None)
    if st is None:
        st = _CodecState(project)
        project._codec_on_loop_state = st
    return st


class CodecOnLoopRule(Rule):
    name = "codec-on-loop"
    description = (
        "msgpack wire codec running on the event loop inside an async "
        "def — route through net/codec.py (size-gated off-loop "
        "transcode) or a run_in_executor closure"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        project = ctx.project
        if project is None:
            return
        st = _state(project)
        struct_names = _module_struct_names(ctx.tree)
        for qual, fi in project.functions.items():
            if fi.path != ctx.path or not fi.is_async:
                continue
            for site in st.live_calls.get(qual, ()):
                yield from self._check_site(
                    ctx, project, fi, site, st, struct_names
                )

    def _check_site(
        self, ctx: FileContext, project: ProjectContext, fi, site: CallSite,
        st: _CodecState, struct_names: Set[str],
    ) -> Iterator[Finding]:
        dotted = _aliased(project, fi.module, dotted_name(site.node.func))
        if dotted in _MSGPACK:
            yield self.finding(
                ctx, site.node,
                f"`{dotted}(...)` transcodes on the event loop inside "
                f"coroutine `{fi.name}` — route through net/codec.py or "
                "run_in_executor",
            )
            return
        hit = next((c for c in site.callees if c in st.codecful), None)
        if hit is not None:
            chain = st.via.get(hit, "")
            yield self.finding(
                ctx, site.node,
                f"`{site.text}(...)` inside coroutine `{fi.name}` "
                f"reaches a msgpack codec on the event loop "
                f"(`{hit.rsplit(':', 1)[-1]}` {chain}) — move the call "
                "into a run_in_executor closure or net/codec.py",
            )
            return
        func = site.node.func
        if (not site.callees
                and isinstance(func, ast.Attribute)
                and func.attr in _CODEC_ATTRS):
            root = dotted_name(func.value).split(".")[0]
            if root and root in struct_names:
                return      # fixed-size struct.Struct header codec
            yield self.finding(
                ctx, site.node,
                f"duck-typed `.{func.attr}()` inside coroutine "
                f"`{fi.name}` looks like a wire codec on the event loop "
                "— route through net/codec.py, or suppress with the "
                "justification if the frame is provably small",
            )
