"""babble-lint core: rule registry, suppression handling, project runner.

Why a repo-native linter instead of more pylint plugins: the bug
classes that threaten this codebase are *domain* invariants — Python
control flow on JAX tracers inside jitted kernels, shared-state
mutation across ``await`` in the gossip loop, wall clocks feeding the
commit path, draining a queue before the capacity guard that protects
it — none of which a general-purpose linter models.  Each rule here
encodes one mechanically-detectable bug class that has actually bitten
the tree.

Design: a rule is a class with ``name``/``description`` metadata and a
``check(ctx)`` generator over :class:`Finding`.  v2 made the runner
project-wide: every file is parsed once, a
:class:`~.graph.ProjectContext` (symbol table + call graph) is built
over the whole set and attached to each :class:`FileContext` as
``ctx.project`` before any rule runs — per-file rules ignore it,
flow-aware rules (determinism taint, interprocedural races, guard
discipline) resolve calls through it.  A single-file check gets a
single-file project, so the rule API stays uniform.  Everything is
stdlib-only (``ast`` + ``tokenize``): the linter must run in
environments where jax / cryptography are absent, because it is
tier-1.

Suppression syntax::

    something_flagged()  # babble-lint: disable=rule-name
    # babble-lint: disable=rule-a,rule-b   (own line: applies to next line)

Blanket disables are themselves findings (``bad-suppression``): every
suppression must carry the names of real rules.  And a suppression
whose named rule no longer fires on its line is ALSO a finding
(``stale-suppression``): suppressions cannot outlive their reason, so
the suppression inventory stays an honest map of what is waived where.
Suppressed findings are retained with ``suppressed=True`` (the
``--json`` stream carries them; exit status counts only live ones).
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

from .graph import ProjectContext

#: cache-key component: bump when rule semantics change so a stale
#: result cache (cache.py) can never mask a new finding
ANALYSIS_VERSION = "5"


@dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    #: True when a named per-line suppression waived this finding —
    #: kept (not dropped) so tooling can audit what is being waived
    suppressed: bool = False

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "suppressed": self.suppressed,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(
            rule=d["rule"], path=d["path"], line=int(d["line"]),
            col=int(d["col"]), message=d["message"],
            suppressed=bool(d.get("suppressed", False)),
        )


class FileContext:
    """Parsed view of one source file, shared by every rule.  The
    engine attaches the run's :class:`~.graph.ProjectContext` as
    ``self.project`` before rules see it."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.project: Optional[ProjectContext] = None


class Rule:
    """Base class: subclasses set ``name``/``description`` and implement
    ``check``.  ``name`` is the suppression/CLI identifier (kebab-case)."""

    name: str = ""
    description: str = ""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST, message: str) -> Finding:
        return Finding(
            rule=self.name,
            path=ctx.path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            message=message,
        )


# ----------------------------------------------------------------------
# suppressions

_SUPPRESS_RE = re.compile(r"#\s*babble-lint:\s*disable=([A-Za-z0-9_.,\- ]*)")
# a suppression comment that names nothing, or names a wildcard
_BLANKET = {"", "all", "*"}

BAD_SUPPRESSION = "bad-suppression"
PARSE_ERROR = "parse-error"
STALE_SUPPRESSION = "stale-suppression"


@dataclass(frozen=True)
class SuppressionEntry:
    """One suppression comment: which line it targets, where the
    comment itself sits (stale findings anchor there), what it names."""

    target_line: int
    comment_line: int
    col: int
    names: frozenset = field(default_factory=frozenset)


def parse_suppressions(
    source: str, path: str, known_rules: Set[str]
) -> Tuple[Dict[int, Set[str]], List[Finding], List[SuppressionEntry]]:
    """Map 1-based line number -> suppressed rule names.

    Only real COMMENT tokens count (the syntax quoted in a docstring is
    documentation, not a directive).  A trailing comment suppresses its
    own line; a comment alone on a line suppresses the next line.
    Returns (map, bad-suppression findings, entries) — blanket or
    unknown-rule suppressions are errors, not silently honored; the
    entries feed the stale-suppression meta-check."""
    suppressed: Dict[int, Set[str]] = {}
    bad: List[Finding] = []
    entries: List[SuppressionEntry] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError):
        return suppressed, bad, entries  # parse-error path reports this file
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        i, col = tok.start
        own_line = tok.line.lstrip().startswith("#")
        names = {p.strip() for p in m.group(1).split(",") if p.strip()}
        if not names or names & _BLANKET:
            bad.append(Finding(
                BAD_SUPPRESSION, path, i, col,
                "blanket suppression: name the rule(s) being disabled "
                "(babble-lint: disable=<rule-name>)",
            ))
            continue
        unknown = names - known_rules
        if unknown:
            bad.append(Finding(
                BAD_SUPPRESSION, path, i, col,
                f"suppression names unknown rule(s): {sorted(unknown)}",
            ))
            names -= unknown
        target = i + 1 if own_line else i
        suppressed.setdefault(target, set()).update(names)
        if names:
            entries.append(SuppressionEntry(
                target_line=target, comment_line=i, col=col,
                names=frozenset(names),
            ))
    return suppressed, bad, entries


# ----------------------------------------------------------------------
# runner

def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git", "_build")
                )
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        else:
            # an explicitly named file is always checked, whatever its
            # extension — skipping it would let the CLI exit 0 ("checked
            # and clean") having checked nothing; a non-Python file
            # surfaces as a parse-error finding instead
            yield p


def _load_context(path: str) -> Tuple[Optional[FileContext], List[Finding]]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
    except (OSError, UnicodeDecodeError) as e:
        return None, [Finding(PARSE_ERROR, path, 0, 0, f"unreadable: {e}")]
    try:
        return FileContext(path, source), []
    except SyntaxError as e:
        return None, [Finding(
            PARSE_ERROR, path, e.lineno or 0, e.offset or 0,
            f"syntax error: {e.msg}",
        )]


def _check_ctx(
    ctx: FileContext, rules: Sequence[Rule], known: Set[str],
) -> List[Finding]:
    """Run rules over one parsed file (``ctx.project`` already set).
    Returns EVERY finding, suppressed ones flagged, sorted by location.

    The stale-suppression meta-check runs here, after all rules: a
    suppression entry naming a rule that was executed this run but
    produced no finding (suppressed or not) on the targeted line is
    itself a finding, anchored at the comment."""
    suppressed, bad, entries = parse_suppressions(ctx.source, ctx.path, known)
    raw: List[Finding] = list(bad)
    for rule in rules:
        raw.extend(rule.check(ctx))

    executed = {r.name for r in rules} | {BAD_SUPPRESSION}
    fired: Set[Tuple[int, str]] = {(f.line, f.rule) for f in raw}
    for entry in entries:
        for name in sorted(entry.names & executed):
            if (entry.target_line, name) not in fired:
                raw.append(Finding(
                    STALE_SUPPRESSION, ctx.path, entry.comment_line,
                    entry.col,
                    f"suppression for `{name}` no longer matches a "
                    "finding on its line — the rule was fixed or the "
                    "code moved; delete the comment so the waiver "
                    "inventory stays honest",
                ))

    out: List[Finding] = []
    for f in raw:
        if f.rule in suppressed.get(f.line, ()):
            f = replace(f, suppressed=True)
        out.append(f)
    out.sort(key=lambda f: (f.line, f.col, f.rule))
    return out


def check_file(
    path: str, rules: Sequence[Rule],
    known_rules: Optional[Set[str]] = None,
    include_suppressed: bool = False,
) -> List[Finding]:
    """Run ``rules`` over one file (single-file project: ``self.``/
    same-module resolution still works).  ``known_rules`` is the
    vocabulary suppressions may legally name — pass the FULL rule set
    even when running a subset, so a suppression for an unselected rule
    is not misreported as unknown."""
    ctx, errors = _load_context(path)
    if ctx is None:
        return errors
    ctx.project = ProjectContext([(ctx.path, ctx.tree)])
    known = known_rules if known_rules is not None else {
        r.name for r in rules
    }
    findings = _check_ctx(ctx, rules, known)
    if not include_suppressed:
        findings = [f for f in findings if not f.suppressed]
    return findings


def run_paths(
    paths: Iterable[str], rules: Sequence[Rule],
    known_rules: Optional[Set[str]] = None,
    include_suppressed: bool = False,
) -> List[Finding]:
    """The project-wide pass: parse everything, build ONE call graph,
    then run every rule per file against it."""
    contexts: List[FileContext] = []
    findings: List[Finding] = []
    for path in iter_python_files(paths):
        ctx, errors = _load_context(path)
        findings.extend(errors)
        if ctx is not None:
            contexts.append(ctx)
    project = ProjectContext([(c.path, c.tree) for c in contexts])
    known = known_rules if known_rules is not None else {
        r.name for r in rules
    }
    for ctx in contexts:
        ctx.project = project
        findings.extend(_check_ctx(ctx, rules, known))
    if not include_suppressed:
        findings = [f for f in findings if not f.suppressed]
    return findings
