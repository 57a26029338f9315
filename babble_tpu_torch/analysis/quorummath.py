"""stale-quorum-math: quorum thresholds must route through the
epoch-aware helpers (membership plane).

With dynamic membership, the participant count is EPOCH STATE: a quorum
expression inlined at a call site — ``2 * n // 3 (+ 1)`` or
``n // 3 + 1`` — silently closes over whichever ``n`` was in scope when
the line was written, and keeps enforcing the OLD epoch's threshold
after a join/leave re-shapes the fleet.  That bug class is invisible to
tests that never churn membership, which is every test written before
the churn chaos tier existed.  The fix shape is mechanical: call
``babble_tpu_torch.membership.quorum.supermajority / sync_quorum /
attestation_quorum`` with the epoch's active count.

Detection is syntactic and deliberately precise — only the two
unambiguous quorum shapes are flagged, so capacity heuristics that
merely divide by 3 (``lvl_new // 3`` window sizing) stay clean:

- ``2 * X // 3`` (either operand order of the multiplication), with or
  without a trailing ``+ 1``;
- ``X // 3 + 1`` (the attestation-quorum shape).

The helper module itself is exempt (it is the definition site), as are
test fixtures.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from .engine import FileContext, Finding, Rule

#: the one module allowed to spell the arithmetic out
_EXEMPT_PATH_RE = re.compile(r"membership[/\\]quorum\.py$")


def _is_const(node: ast.AST, value: int) -> bool:
    return isinstance(node, ast.Constant) and node.value == value


def _is_two_thirds(node: ast.AST) -> bool:
    """``2 * X // 3`` or ``X * 2 // 3``."""
    if not (isinstance(node, ast.BinOp)
            and isinstance(node.op, ast.FloorDiv)
            and _is_const(node.right, 3)):
        return False
    left = node.left
    return (isinstance(left, ast.BinOp) and isinstance(left.op, ast.Mult)
            and (_is_const(left.left, 2) or _is_const(left.right, 2)))


def _is_third_plus_one(node: ast.AST) -> bool:
    """``X // 3 + 1`` (X itself not already the 2/3 shape — that form
    is flagged at the inner node with the supermajority message)."""
    if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add)
            and _is_const(node.right, 1)):
        return False
    left = node.left
    return (isinstance(left, ast.BinOp)
            and isinstance(left.op, ast.FloorDiv)
            and _is_const(left.right, 3)
            and not _is_two_thirds(left))


class StaleQuorumMathRule(Rule):
    name = "stale-quorum-math"
    description = (
        "quorum thresholds (2*n//3, n//3+1) must route through the "
        "epoch-aware helpers in babble_tpu_torch.membership.quorum — an "
        "inlined expression keeps enforcing a stale epoch's threshold "
        "after membership churn"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if _EXEMPT_PATH_RE.search(ctx.path):
            return
        for node in ast.walk(ctx.tree):
            if _is_two_thirds(node):
                yield self.finding(
                    ctx, node,
                    "inlined 2/3 quorum expression; route through "
                    "membership.quorum.supermajority / sync_quorum "
                    "with the epoch's active participant count",
                )
            elif _is_third_plus_one(node):
                yield self.finding(
                    ctx, node,
                    "inlined n//3+1 quorum expression; route through "
                    "membership.quorum.attestation_quorum with the "
                    "epoch's active participant count",
                )
