"""Whole-run result cache: ``--cache .babble_lint_cache``.

The v2 analyses are project-wide: a finding in file A can depend on a
helper in file B (taint through the call graph, write closures).  A
per-file finding cache is therefore UNSOUND — editing B can change A's
findings while A's mtime never moves.  What *is* sound, and what the
tier-1 gate actually needs (the same unchanged tree linted on every
verify run), is a whole-run cache: key the complete result on the
(path, mtime_ns, size) vector of every discovered file plus the rule
set and engine version.  Any edit — content, rename, add, delete —
changes the vector and forces a full recompute; an untouched tree
skips parsing entirely and replays the stored findings.

The cache file is JSON, one object, atomically replaced.  A corrupt,
stale-version or mismatched cache is silently treated as a miss — the
cache can make a run faster, never wrong.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .engine import ANALYSIS_VERSION, Finding, Rule, iter_python_files, run_paths
from .serial import manifest_candidate_paths


def _stat_vector(paths: Iterable[str]) -> Dict[str, Tuple[int, int]]:
    """path -> (mtime_ns, size) for every file the run would lint,
    PLUS every path where a ``.babble-format-manifest.json`` could
    shadow one of them — the format-version-ratchet findings depend on
    the manifest's content, so creating, editing or shadowing a
    manifest must miss the cache exactly like a source edit.
    A vanished file maps to (-1, -1): still a key change, not a crash."""
    paths = list(paths)
    out: Dict[str, Tuple[int, int]] = {}
    for p in list(paths) + manifest_candidate_paths(paths):
        try:
            st = os.stat(p)
            out[p] = (st.st_mtime_ns, st.st_size)
        except OSError:
            out[p] = (-1, -1)
    return out


def _cache_key(stats: Dict[str, Tuple[int, int]], rules: Sequence[Rule],
               known_rules: Optional[Set[str]]) -> dict:
    # include_suppressed is deliberately NOT part of the key: the cache
    # always stores the suppressed-inclusive result and the caller's
    # view is filtered on read, so plain and --json runs sharing one
    # cache file hit the same entry instead of evicting each other
    return {
        "version": ANALYSIS_VERSION,
        "rules": sorted(r.name for r in rules),
        # known_rules changes which suppressions read as unknown
        # (bad-suppression findings), so it is part of the result
        # identity too — a cache can be faster, never wrong
        "known_rules": sorted(known_rules) if known_rules else None,
        "files": {p: list(v) for p, v in sorted(stats.items())},
    }


def _load(cache_path: str) -> Optional[dict]:
    try:
        with open(cache_path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) else None


def _store(cache_path: str, key: dict, findings: List[Finding]) -> None:
    payload = {"key": key, "findings": [f.to_dict() for f in findings]}
    d = os.path.dirname(os.path.abspath(cache_path)) or "."
    try:
        fd, tmp = tempfile.mkstemp(prefix=".babble_lint_", dir=d)
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        os.replace(tmp, cache_path)
    except OSError:
        # read-only checkout / full disk: the run still succeeded, the
        # next one just pays full price again
        pass


def run_paths_cached(
    paths: Sequence[str], rules: Sequence[Rule], cache_path: str,
    known_rules: Optional[Set[str]] = None,
    include_suppressed: bool = False,
) -> Tuple[List[Finding], bool]:
    """Like :func:`~.engine.run_paths`, plus (findings, cache_hit).
    On a hit nothing is parsed — the stat vector alone decides."""
    files = list(iter_python_files(paths))
    stats = _stat_vector(files)
    key = _cache_key(stats, rules, known_rules)

    def view(findings: List[Finding]) -> List[Finding]:
        if include_suppressed:
            return findings
        return [f for f in findings if not f.suppressed]

    cached = _load(cache_path)
    if cached is not None and cached.get("key") == key:
        try:
            findings = [Finding.from_dict(d) for d in cached["findings"]]
        except (KeyError, TypeError, ValueError):
            findings = None
        if findings is not None:
            return view(findings), True
    findings = run_paths(files, rules, known_rules=known_rules,
                         include_suppressed=True)
    _store(cache_path, key, findings)
    return view(findings), False
