"""Blocking calls inside coroutines.

The gossip runtime is one event loop serving every peer, deadline and
commit; a single ``time.sleep`` or blocking socket call inside an
``async def`` freezes all of them for its full duration — and the
symptom (every latency stretches at once) is exactly what the loop-lag
probe (obs/probe.py) measures but cannot attribute to a line.  This
rule attributes it statically.

What is flagged inside any ``async def`` body:

- ``time.sleep(...)`` — the canonical mistake (``await asyncio.sleep``
  is the fix);
- module-level blocking socket/name-resolution calls:
  ``socket.create_connection``, ``socket.getaddrinfo``,
  ``socket.gethostbyname``/``_ex``, ``socket.gethostbyaddr``;
- ``urllib.request.urlopen`` — a whole blocking HTTP round-trip;
- blocking socket *methods* (``connect``, ``accept``, ``recv``,
  ``recvfrom``, ``recv_into``, ``send``, ``sendall``) when the receiver
  identifier contains a ``sock`` word segment (``self.sock.recv`` yes,
  ``writer.send`` no) — the same name-based heuristic the race rule
  uses for locks: favor recall, document false positives with a named
  suppression.

Nested ``def``/``lambda`` bodies are skipped: a sync closure handed to
``run_in_executor`` is the *correct* pattern, not a violation.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from .engine import FileContext, Finding, Rule

#: dotted module-level callables that block the calling thread
_BLOCKING_FUNCS = {
    "time.sleep",
    "socket.create_connection",
    "socket.getaddrinfo",
    "socket.gethostbyname",
    "socket.gethostbyname_ex",
    "socket.gethostbyaddr",
    "urllib.request.urlopen",
}

#: blocking methods, flagged only on sock-ish receivers
_BLOCKING_METHODS = {
    "connect", "accept", "recv", "recvfrom", "recv_into", "send",
    "sendall",
}

_WORD_RE = re.compile(r"[A-Z]?[a-z0-9]+|[A-Z]+(?![a-z])")


def _sockish(name: str) -> bool:
    return any(w.lower() in ("sock", "socket")
               for w in _WORD_RE.findall(name))


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` -> "a.b.c"; anything non-trivial -> ""."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class AsyncioBlockingCallRule(Rule):
    name = "asyncio-blocking-call"
    description = (
        "blocking call (time.sleep / blocking socket I/O) inside an "
        "async def — it stalls the whole event loop; use the asyncio "
        "equivalent or run_in_executor"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.AsyncFunctionDef):
                yield from self._check_coroutine(ctx, node)

    def _check_coroutine(
        self, ctx: FileContext, fn: ast.AsyncFunctionDef
    ) -> Iterator[Finding]:
        for call in self._calls(fn.body):
            func = call.func
            dotted = _dotted(func)
            if dotted in _BLOCKING_FUNCS:
                yield self.finding(
                    ctx, call,
                    f"`{dotted}(...)` blocks the event loop inside "
                    f"coroutine `{fn.name}` — use the asyncio "
                    "equivalent (asyncio.sleep / open_connection / "
                    "getaddrinfo on the loop) or run_in_executor",
                )
            elif (isinstance(func, ast.Attribute)
                    and func.attr in _BLOCKING_METHODS
                    and _sockish(_dotted(func.value) or "")):
                yield self.finding(
                    ctx, call,
                    f"blocking socket method `.{func.attr}()` on "
                    f"`{_dotted(func.value)}` inside coroutine "
                    f"`{fn.name}` — use loop.sock_* / streams, or "
                    "run_in_executor",
                )

    def _calls(self, body) -> Iterator[ast.Call]:
        """Call nodes in this coroutine's own schedule: nested function
        bodies (sync helpers destined for executors, nested coroutines
        with their own schedule) are pruned, not merely skipped."""
        stack = list(body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.Call):
                yield node
            stack.extend(ast.iter_child_nodes(node))
