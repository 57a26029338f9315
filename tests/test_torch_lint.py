"""babble-lint on the port: ``babble_tpu_torch/analysis`` (the JAX
package's ``analysis/``, with the text that names the package changed)
and the port's own lint gate, held to the JAX analyzer on the CPU.

- the port's analyzer over ``babble_tpu_torch/`` finds nothing live, and
  its suppressed findings are exactly the port's baseline
  (``babble_tpu_torch/.babble-lint-baseline.json``), which ``--baseline``
  accepts;
- the port's analyzer and JAX's give the same findings (rule, path,
  line, col, suppressed, message) over ``tests/lint_fixtures/``,
  ``babble_tpu/`` and ``babble_tpu_torch/``: the copy's rules were not
  loosened;
- the copy's sources equal JAX's, docstrings and comments aside, once
  ``babble_tpu`` reads ``babble_tpu_torch``;
- the port's format manifest is JAX's with the package renamed, every
  surface included (``ops/aot.py``'s since the port has the module);
- ``lint --json`` gives the same output through both clis, and the
  port's runs without torch;
- the codec's two allocations the analyzer once flagged are bounded: a
  hostile decoded integer never sizes one.
"""

import ast
import json
import os
import subprocess
import sys
import tracemalloc

import msgpack
import pytest

from babble_tpu.analysis import ALL_RULES as J_RULES
from babble_tpu.analysis import RULE_NAMES as J_NAMES
from babble_tpu.analysis import run_paths as j_run_paths
from babble_tpu_torch import codec
from babble_tpu_torch.analysis import ALL_RULES as P_RULES
from babble_tpu_torch.analysis import RULE_NAMES as P_NAMES
from babble_tpu_torch.analysis import run_paths as p_run_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "babble_tpu_torch")
BASELINE = "babble_tpu_torch/.babble-lint-baseline.json"
MANIFEST = ".babble-format-manifest.json"


def _run_all(cmds):
    """Start every command at once (cwd = the repo), wait for all."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=240)
        out.append((p.returncode, stdout, stderr))
    return out


_TREE = {}


def _tree(name):
    """Both analyzers over one tree, run once per module: ``(port, jax)``
    as ``(rc, stdout, stderr)``.  Over the port's tree the port runs
    through its cli's ``lint`` verb and JAX through ``babble_tpu.cli
    lint``; a third run takes the port's baseline."""
    if name not in _TREE:
        if name == "babble_tpu_torch":
            _TREE[name] = _run_all([
                [sys.executable, "-m", "babble_tpu_torch.cli", "lint",
                 "--json", name],
                [sys.executable, "-m", "babble_tpu.cli", "lint", "--json",
                 name],
                [sys.executable, "-m", "babble_tpu_torch.analysis", name,
                 "--baseline", BASELINE],
            ])
        else:
            _TREE[name] = _run_all([
                [sys.executable, "-m", "babble_tpu_torch.analysis", "--json",
                 name],
                [sys.executable, "-m", "babble_tpu.analysis", "--json", name],
            ])
    return _TREE[name]


def _rows(stdout):
    return [json.loads(line) for line in stdout.splitlines() if line]


def test_port_is_lint_clean_against_its_baseline():
    (rc, out, err), _jax, (brc, bout, berr) = _tree("babble_tpu_torch")
    assert rc == 0, err[-2000:]
    rows = _rows(out)
    assert [r for r in rows if not r["suppressed"]] == []
    counts = {}
    for r in rows:
        key = f"{r['path']}::{r['rule']}"
        counts[key] = counts.get(key, 0) + 1
    with open(os.path.join(REPO, BASELINE)) as f:
        assert json.load(f) == {"version": 1, "waived": counts}
    assert brc == 0, berr[-2000:]
    assert "no longer needed" not in berr and bout == ""


@pytest.mark.parametrize("tree", ["babble_tpu_torch", "babble_tpu",
                                  "tests/lint_fixtures"])
def test_both_analyzers_give_the_same_findings(tree):
    """Rule, path, line, col, suppressed and message, finding by finding
    (over the port's tree through both clis' ``lint --json``)."""
    if tree == "tests/lint_fixtures":
        path = os.path.join(REPO, tree)
        port = [f.to_dict() for f in p_run_paths(
            [path], P_RULES, known_rules=P_NAMES, include_suppressed=True)]
        jax = [f.to_dict() for f in j_run_paths(
            [path], J_RULES, known_rules=J_NAMES, include_suppressed=True)]
        assert len(port) > 50 and any(f["suppressed"] for f in port)
        assert len({f["rule"] for f in port}) > 20
    else:
        (prc, pout, perr), (jrc, jout, jerr) = _tree(tree)[:2]
        assert (prc, jrc) == (0, 0), (perr[-2000:], jerr[-2000:])
        assert pout == jout
        port, jax = _rows(pout), _rows(jout)
        assert any(f["suppressed"] for f in port)
    assert port == jax


def _code(path, rename):
    """The module's AST without docstrings, dumped; ``rename`` maps the
    JAX package's name to the port's in every string first."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    if rename:
        text = text.replace("babble_tpu", "babble_tpu_torch")
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_the_rules_are_jax_rules_with_the_package_renamed():
    jdir = os.path.join(REPO, "babble_tpu", "analysis")
    pdir = os.path.join(PORT, "analysis")
    names = sorted(f for f in os.listdir(jdir) if f.endswith(".py"))
    assert len(names) == 21
    assert sorted(f for f in os.listdir(pdir) if f.endswith(".py")) == names
    for name in names:
        assert _code(os.path.join(pdir, name), False) == _code(
            os.path.join(jdir, name), True), name


def test_port_manifest_is_jax_manifest_renamed():
    with open(os.path.join(REPO, MANIFEST)) as f:
        jax = json.load(f)
    with open(os.path.join(PORT, MANIFEST)) as f:
        port = json.load(f)
    assert port["version"] == jax["version"] == 1
    renamed = {k.replace("babble_tpu.", "babble_tpu_torch."): v
               for k, v in jax["surfaces"].items()}
    assert set(port["surfaces"]) == set(renamed)
    assert "manifest:babble_tpu_torch.ops.aot:ENGINE_CACHE_VERSION" in \
        port["surfaces"]
    assert len(port["surfaces"]) == 22
    for name, entry in port["surfaces"].items():
        want = dict(renamed[name])
        assert want.pop("path") == "babble_tpu/" + entry["path"]
        got = {k: v for k, v in entry.items() if k != "path"}
        assert got == want, name


def test_lint_verb_equals_jax_and_imports_no_torch():
    """A short tree through both clis in one process each; the port's
    cli runs it with torch not imported, as JAX's runs without jax."""
    script = (
        "import sys, contextlib, io\n"
        "from {pkg}.cli import main\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    rc = main(['lint', '--json', 'babble_tpu_torch/proxy'])\n"
        "print(rc, sorted(m for m in ('torch', 'jax', 'numpy')\n"
        "                 if m in sys.modules))\n"
        "print(out.getvalue(), end='')\n"
    )
    (prc, pout, perr), (jrc, jout, jerr) = _run_all([
        [sys.executable, "-c", script.format(pkg=pkg)]
        for pkg in ("babble_tpu_torch", "babble_tpu")])
    assert (prc, jrc) == (0, 0), (perr[-2000:], jerr[-2000:])
    phead, pbody = pout.split("\n", 1)
    jhead, jbody = jout.split("\n", 1)
    assert phead == jhead == "0 []"
    assert pbody == jbody
    rows = _rows(pbody)
    assert rows and all(r["suppressed"] for r in rows)
    assert {r["rule"] for r in rows} == {"await-state-race"}


_INTS = [0, 1, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF, 0x10000, 0xFFFFFFFF,
         0x100000000, (1 << 64) - 1, -1, -0x20, -0x21, -0x80, -0x81,
         -0x8000, -0x8001, -(1 << 31), -(1 << 31) - 1, -(1 << 63)]


def test_a_hostile_decoded_int_never_sizes_an_allocation():
    """Every msgpack integer form, decoded from peer bytes and packed
    again, gives msgpack's bytes: at most 9, whatever the value (the
    positive fixint is one struct byte, never ``bytes(v)``-sized), in a
    few hundred bytes of heap; a decoded bin is copied at its own
    length."""
    for v in _INTS:
        wire = msgpack.packb(v)
        decoded = codec.unpackb(wire)
        tracemalloc.start()
        again = codec.packb(decoded)
        peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        assert decoded == v and again == wire, v
        assert len(again) <= 9 and peak < 4096, (v, peak)
        assert codec.packb([decoded, {b"k": decoded}]) == msgpack.packb(
            [v, {b"k": v}]), v
    for n in (0, 1, 31, 255, 256, 70_000):
        for form in (bytes, bytearray, memoryview):
            blob = form(bytes(range(256)) * (n // 256) + bytes(n % 256))
            assert codec.packb(blob) == msgpack.packb(bytes(blob)), n
            assert codec.unpackb(codec.packb(blob)) == bytes(blob)
