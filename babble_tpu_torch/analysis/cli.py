"""babble-lint CLI: ``python -m babble_tpu_torch.analysis [paths...]``
(also mounted as ``python -m babble_tpu_torch.cli lint ...``).

Exit status is the contract CI keys off: 0 = clean, 1 = findings,
2 = usage error.  Output formats:

- text (default): ``path:line:col: rule: message`` — the shape
  compilers use, so editors and CI annotators parse it for free;
- ``--json``: one finding per line (JSONL) with keys
  ``rule/path/line/col/message/suppressed`` — suppressed findings ARE
  emitted (that is the point of the flag: tooling audits what is
  waived), but only live findings drive the exit status;
- ``--sarif``: one SARIF 2.1.0 document (the same finding stream as
  ``--json``) so CI annotates findings inline on PRs — suppressed
  findings ride along as level ``note`` with an ``inSource``
  suppression object, live findings are ``warning``;
- ``--format=json``: legacy single-array form (live findings only).

``--cache FILE`` keys the whole project-wide result on every file's
(mtime, size) plus the rule set — an untouched tree replays findings
without parsing anything (see cache.py for why per-file caching would
be unsound under cross-module analysis).

``--changed`` scopes REPORTING to files touched per git (worktree +
index vs HEAD, plus untracked) while the analysis itself still runs
over the full project graph — cross-module rules need every file to
resolve, but the dev loop only wants findings for what it touched.

``--write-format-manifest`` records the tree's serialized-surface
field inventory into ``.babble-format-manifest.json`` — the sanctioned
bump path for the ``format-version-ratchet`` rule.  It refuses (exit
2) to record a changed inventory whose paired version constant did not
move: bump the constant first, then re-run.

``--baseline FILE`` is the suppression ratchet: the committed file
(``.babble-lint-baseline.json``) records how many waived findings each
``path::rule`` pair is allowed.  Pre-existing waivers pass; a NEW
suppression — any pair exceeding its baseline count — fails the run
with a diff on stderr, exactly like a new live finding does.  Counts
are keyed per (path, rule), not per line, so routine edits that shift
line numbers never invalidate the baseline; ``--write-baseline``
regenerates the file when a waiver is deliberately added or retired
(shrinking counts only loosens the ratchet when committed, which is
what code review is for).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from . import ALL_RULES
from .cache import run_paths_cached
from .engine import Finding, Rule, run_paths

_SARIF_SCHEMA = "https://json.schemastore.org/sarif-2.1.0.json"


def sarif_document(findings: List[Finding],
                   rules: List[Rule]) -> dict:
    """The finding stream as one SARIF 2.1.0 run, for CI inline
    annotation.  Locations are repo-relative URIs with 1-based
    line/column regions; suppressed findings carry an ``inSource``
    suppression object (SARIF's native waiver representation) and
    level ``note`` so annotators render them dimmed, not failing."""
    results = []
    for f in findings:
        result = {
            "ruleId": f.rule,
            "level": "note" if f.suppressed else "warning",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path.replace(os.sep, "/"),
                    },
                    "region": {
                        "startLine": max(f.line, 1),
                        "startColumn": f.col + 1,
                    },
                },
            }],
        }
        if f.suppressed:
            result["suppressions"] = [{"kind": "inSource"}]
        results.append(result)
    return {
        "version": "2.1.0",
        "$schema": _SARIF_SCHEMA,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "babble-lint",
                    "rules": [
                        {
                            "id": r.name,
                            "shortDescription": {"text": r.description},
                        }
                        for r in sorted(rules, key=lambda r: r.name)
                    ],
                },
            },
            "results": results,
        }],
    }


def _git_changed_files() -> Optional[set]:
    """Absolute paths of files changed vs HEAD (worktree + index) plus
    untracked files, or None when git is unavailable — the dev-loop
    scope for ``--changed``.  The lint itself still runs whole-graph;
    only the report is filtered, so a cross-module finding in an
    untouched file stays visible on a full run."""
    import subprocess

    out: set = set()
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        for cmd in (
            ["git", "diff", "--name-only", "HEAD"],
            ["git", "ls-files", "--others", "--exclude-standard"],
        ):
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 check=True, cwd=top)
            for line in res.stdout.splitlines():
                if line.strip():
                    out.add(os.path.abspath(os.path.join(top, line.strip())))
    except (OSError, subprocess.CalledProcessError):
        return None
    return out


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m babble_tpu_torch.analysis",
        description="babble-lint: repo-native static analysis for JAX "
                    "tracer safety, asyncio races, consensus "
                    "determinism and invariants.",
    )
    parser.add_argument(
        "paths", nargs="*", default=["babble_tpu_torch"],
        help="files or directories to check (default: babble_tpu_torch)",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="output format (default: text)",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="emit one finding per line as JSON (JSONL), including "
             "suppressed findings flagged suppressed=true",
    )
    parser.add_argument(
        "--sarif", action="store_true",
        help="emit one SARIF 2.1.0 document (same finding stream as "
             "--json) for CI inline annotation",
    )
    parser.add_argument(
        "--cache", default=None, metavar="FILE",
        help="whole-run result cache keyed on file mtime+size; an "
             "untouched tree skips re-parsing entirely",
    )
    parser.add_argument(
        "--baseline", default=None, metavar="FILE",
        help="suppression ratchet: fail when any path::rule pair "
             "carries more waived findings than the committed "
             "baseline allows",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="write the current waiver inventory to --baseline FILE "
             "and exit (requires --baseline)",
    )
    parser.add_argument(
        "--write-format-manifest", action="store_true",
        help="record the tree's serialized-surface field inventory "
             "into the nearest .babble-format-manifest.json (the "
             "sanctioned format-version-ratchet bump path); refuses "
             "when an inventory changed under an unbumped version "
             "constant",
    )
    parser.add_argument(
        "--changed", action="store_true",
        help="report only findings in files changed per git (vs HEAD, "
             "plus untracked); the analysis still runs over the full "
             "project graph",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    parser.add_argument(
        "--rules", default=None, metavar="RULE[,RULE...]",
        help="run only the named rules (default: all)",
    )
    args = parser.parse_args(argv)

    if args.json and args.sarif:
        # each claims stdout whole — silently picking one would feed a
        # SARIF upload step JSONL (or vice versa) with exit 0
        print("--json and --sarif are mutually exclusive",
              file=sys.stderr)
        return 2
    if args.write_baseline and not args.baseline:
        print("--write-baseline requires --baseline FILE",
              file=sys.stderr)
        return 2

    rules = list(ALL_RULES)
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",") if r.strip()}
        known = {r.name for r in rules}
        unknown = wanted - known
        if unknown:
            print(f"unknown rule(s): {sorted(unknown)}", file=sys.stderr)
            return 2
        rules = [r for r in rules if r.name in wanted]

    if args.list_rules:
        for r in sorted(ALL_RULES, key=lambda r: r.name):
            print(f"{r.name}: {r.description}")
        return 0

    # a path that matches nothing is a usage error, not a clean run —
    # exit 0 must mean "these files were checked and are clean", or a
    # typo'd CI invocation stays green forever
    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(f"no such file or directory: {missing}", file=sys.stderr)
        return 2

    if args.write_format_manifest:
        from .serial import (
            MANIFEST_NAME, compute_surfaces, find_manifest, write_manifest,
        )
        surfaces = compute_surfaces(args.paths)
        target = find_manifest(os.path.abspath(args.paths[0]))
        if target is None:
            target = os.path.join(os.getcwd(), MANIFEST_NAME)
        refusals = write_manifest(target, surfaces)
        if refusals:
            print("refusing to record a changed inventory under an "
                  "unbumped version constant:", file=sys.stderr)
            for line in refusals:
                print(f"  {line}", file=sys.stderr)
            return 2
        print(f"format manifest written: {target} "
              f"({len(surfaces)} surface(s))", file=sys.stderr)
        return 0

    from . import RULE_NAMES

    include_suppressed = bool(args.json or args.sarif or args.baseline)
    if args.cache:
        findings, _hit = run_paths_cached(
            args.paths, rules, args.cache, known_rules=RULE_NAMES,
            include_suppressed=include_suppressed,
        )
    else:
        findings = run_paths(args.paths, rules, known_rules=RULE_NAMES,
                             include_suppressed=include_suppressed)

    if args.changed:
        changed = _git_changed_files()
        if changed is None:
            print("--changed requires a git checkout (git diff failed)",
                  file=sys.stderr)
            return 2
        findings = [f for f in findings
                    if os.path.abspath(f.path) in changed]

    live = [f for f in findings if not f.suppressed]

    ratchet_broken = []
    if args.baseline:
        counts: dict = {}
        for f in findings:
            if f.suppressed:
                key = f"{f.path.replace(os.sep, '/')}::{f.rule}"
                counts[key] = counts.get(key, 0) + 1
        if args.write_baseline:
            doc = {"version": 1, "waived": counts}
            with open(args.baseline, "w", encoding="utf-8") as fh:
                json.dump(doc, fh, indent=2, sort_keys=True)
                fh.write("\n")
            print(f"baseline written: {args.baseline} "
                  f"({sum(counts.values())} waived finding(s) across "
                  f"{len(counts)} path::rule pair(s))", file=sys.stderr)
        else:
            # a missing or unreadable baseline must fail loudly: exit 0
            # with the ratchet silently off would never fail again
            try:
                with open(args.baseline, encoding="utf-8") as fh:
                    allowed = json.load(fh).get("waived", {})
            except (OSError, ValueError) as exc:
                print(f"cannot read baseline {args.baseline}: {exc}",
                      file=sys.stderr)
                return 2
            if not isinstance(allowed, dict):
                print(f"malformed baseline {args.baseline}: 'waived' "
                      "must be an object", file=sys.stderr)
                return 2
            for key in sorted(counts):
                if counts[key] > allowed.get(key, 0):
                    ratchet_broken.append(
                        f"NEW suppression: {key} — {counts[key]} "
                        f"waived, baseline allows {allowed.get(key, 0)}"
                    )
            retired = sorted(k for k in allowed if k not in counts)
            if retired:
                print("note: baseline entries no longer needed "
                      "(re-run with --write-baseline to tighten): "
                      + ", ".join(retired), file=sys.stderr)

    if args.json:
        for f in findings:
            print(json.dumps(f.to_dict(), sort_keys=True))
    elif args.sarif:
        print(json.dumps(sarif_document(findings, rules), indent=2,
                         sort_keys=True))
    elif args.format == "json":
        print(json.dumps([f.to_dict() for f in live], indent=2))
    else:
        for f in live:
            print(f.format())
        if live:
            print(f"\n{len(live)} finding(s)", file=sys.stderr)
    if ratchet_broken:
        print("suppression ratchet failed against "
              f"{args.baseline}:", file=sys.stderr)
        for line in ratchet_broken:
            print(f"  {line}", file=sys.stderr)
    return 1 if live or ratchet_broken else 0
