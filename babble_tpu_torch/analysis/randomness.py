"""Unseeded randomness in chaos code paths.

The chaos plane's contract is that every run is reproducible from
``--seed`` alone: the fault schedule, the byzantine actors' choices and
the scenario workload must all flow from seeded ``random.Random``
instances held by the injector/runner.  One ``random.random()`` against
the process-global RNG silently breaks that contract — the scenario
still *runs*, it just stops being replayable, which is the worst kind
of chaos-tooling bug (you hit a consensus violation once and can never
summon it again).

Flagged, in any file whose path contains a ``chaos`` segment (the
package itself plus its fixtures):

- module-level ``random.<fn>(...)`` calls (``random.random``,
  ``random.choice``, ``random.randint``, ...) — the global RNG;
- ``random.Random()`` with no arguments — an OS-entropy-seeded
  instance is just the global RNG with extra steps;
- bare calls to names imported via ``from random import ...``.

The fix is always the same: draw from an injector-held
``random.Random(seed-derived-string)`` (see chaos/injector.py).
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Set

from .engine import FileContext, Finding, Rule

#: module-level random callables that consume the global RNG
_GLOBAL_RNG_FUNCS = {
    "random", "randint", "randrange", "randbytes", "choice", "choices",
    "shuffle", "sample", "uniform", "getrandbits", "gauss",
    "normalvariate", "lognormvariate", "expovariate", "betavariate",
    "gammavariate", "triangular", "vonmisesvariate", "paretovariate",
    "weibullvariate", "seed",
}

_CHAOS_SEG = re.compile(r"(^|[\\/])[^\\/]*chaos[^\\/]*([\\/]|$)")


def _dotted(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class ChaosUnseededRandomRule(Rule):
    name = "chaos-unseeded-random"
    description = (
        "global-RNG call (random.random() etc.) in chaos code — fault "
        "schedules must be reproducible from the scenario seed; draw "
        "from an injector-held seeded random.Random instead"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _CHAOS_SEG.search(ctx.path):
            return
        from_imports: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "random":
                for alias in node.names:
                    if alias.name in _GLOBAL_RNG_FUNCS:
                        from_imports.add(alias.asname or alias.name)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            if dotted.startswith("random."):
                fn = dotted.split(".", 1)[1]
                if fn in _GLOBAL_RNG_FUNCS:
                    yield self.finding(
                        ctx, node,
                        f"`{dotted}(...)` draws from the process-global "
                        "RNG — chaos must be reproducible from the "
                        "scenario seed; use the injector's seeded "
                        "random.Random",
                    )
                elif fn == "Random" and not node.args and not node.keywords:
                    yield self.finding(
                        ctx, node,
                        "`random.Random()` with no seed is OS-entropy "
                        "seeded — pass a seed-derived value so the "
                        "stream is replayable",
                    )
            elif (isinstance(node.func, ast.Name)
                    and node.func.id in from_imports):
                yield self.finding(
                    ctx, node,
                    f"`{node.func.id}(...)` (imported from random) "
                    "draws from the process-global RNG — use the "
                    "injector's seeded random.Random",
                )
