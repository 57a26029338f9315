"""The port's ``chaos`` verb, ``run --chaos_plan`` and the testnet knobs
the chaos plane drives, against the JAX package's, on the CPU.

- ``chaos list``, ``show`` and ``run --json`` print what the JAX cli
  prints (``run`` with ``--device cpu``), and the ``chaos`` parser keeps
  the JAX flags plus ``--device``;
- ``_chaos_wrap`` gives a node the JAX package's link identity, address
  map, seed and tick clock for the same datadir and plan;
- a 3-process port testnet under ``--chaos_plan`` with a partition plan
  (``chaos.run_live``) counts its injected faults on ``/metrics`` and
  reaches consensus;
- ``TestnetRunner``'s ``joiners``, ``checkpoints``, ``wal`` and
  ``extra_node_args`` and ``build_conf(joiners=)`` give the JAX
  runner's node arguments and datadirs;
- (slow) the live ``join-under-load`` of the JAX package's own slow
  tier.
"""

import argparse
import contextlib
import io
import json
import os
import types

import pytest

from babble_tpu import cli as jcli
from babble_tpu import testnet as jtn

from babble_tpu_torch import cli as pcli
from babble_tpu_torch import testnet as tn
from babble_tpu_torch.chaos import Scenario, load_scenario, run_live

from tests.test_chaos_scenarios import _MINI_FLAKY


def _out(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    return rc, out.getvalue()


def _chaos_parsers(monkeypatch):
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def spy(self, *a, **k):
        seen.setdefault("parser", self)
        return real(self, *a, **k)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    monkeypatch.setattr(jcli, "cmd_chaos", lambda args: 0)
    jcli.main(["chaos", "list"])
    monkeypatch.undo()
    return seen["parser"], pcli.build_parser()


def _subparser(parser, *names):
    for name in names:
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        parser = sub.choices[name]
    return parser


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     tuple(a.choices) if a.choices else None,
                     type(a).__name__, a.nargs)
            for a in parser._actions if a.dest != "help"}


def test_chaos_parser_matches_jax(monkeypatch):
    jp, pp = _chaos_parsers(monkeypatch)
    for verb, extra in (("list", set()), ("show", set()),
                        ("run", {"device"})):
        jf = _flags(_subparser(jp, "chaos", verb))
        pf = _flags(_subparser(pp, "chaos", verb))
        assert set(pf) - set(jf) == extra, verb
        assert all(pf[d] == jf[d] for d in jf), verb
    assert _flags(_subparser(pp, "chaos", "run"))["device"][:2] == (
        ("--device",), "cuda")


def test_chaos_list_and_show_print_the_jax_texts():
    assert _out(pcli.main, ["chaos", "list"]) == _out(
        jcli.main, ["chaos", "list"])
    for name in ("flaky-link", "disk-rot", "join-under-load", "wan-lossy",
                 "fork-attack"):
        assert _out(pcli.main, ["chaos", "show", name]) == _out(
            jcli.main, ["chaos", "show", name])


def test_chaos_run_json_prints_the_jax_result(tmp_path):
    path = tmp_path / "mini.json"
    path.write_text(json.dumps({**_MINI_FLAKY, "steps": 24, "txs": 2}))
    prc, port = _out(pcli.main, ["chaos", "run", str(path), "--json",
                                 "--device", "cpu"])
    jrc, jax = _out(jcli.main, ["chaos", "run", str(path), "--json"])
    assert prc == jrc == 0
    assert json.loads(port) == json.loads(jax)
    # the text form: the same lines
    prc, port = _out(pcli.main, ["chaos", "run", str(path), "--seed", "3",
                                 "--device", "cpu"])
    jrc, jax = _out(jcli.main, ["chaos", "run", str(path), "--seed", "3"])
    assert (prc, port) == (jrc, jax)
    assert "fingerprint " in port


def test_chaos_run_flaky_link_prints_chip_smokes_fingerprint():
    """The canned flaky-link at seed 1 through the port's cli: the
    fingerprint the JAX cli prints (chip_smoke.CHAOS_EXPECT, held to the
    JAX package by tests/test_torch_chaos_scenarios.py)."""
    import chip_smoke

    rc, out = _out(pcli.main, ["chaos", "run", "flaky-link", "--seed", "1",
                               "--json", "--device", "cpu"])
    assert rc == 0
    assert (json.loads(out)["fingerprint"]
            == chip_smoke.CHAOS_EXPECT["flaky-link"][1]["fingerprint"])


def test_chaos_run_of_a_byzantine_scenario_exits_naming_item_7(
        tmp_path, monkeypatch):
    """The byzantine scenarios (ROADMAP item 7, refused before the port
    had the engine): ``chaos run fork-attack`` prints the JAX cli's
    fingerprint (chip_smoke.CHAOS_EXPECT, held to the JAX package by
    tests/test_torch_chaos_scenarios.py), and ``--live`` hands a
    byzantine scenario to ``run_live`` unrefused.  The name is the
    refusal test's that this one replaced in place."""
    import chip_smoke
    from babble_tpu_torch import chaos

    rc, out = _out(pcli.main, ["chaos", "run", "fork-attack", "--seed", "1",
                               "--json", "--device", "cpu"])
    got = json.loads(out)
    assert rc == 0 and got["invariants"]["ok"]
    assert got["fingerprint"] == \
        chip_smoke.CHAOS_EXPECT["fork-attack"][1]["fingerprint"]
    assert got["fault_counts"]["fork_attack"] == 1
    path = tmp_path / "fork.json"
    path.write_text(json.dumps({**_MINI_FLAKY, "engine": "byzantine"}))
    seen = {}

    def live(sc, root, device="cuda"):
        seen.update(engine=sc.engine, root=root, device=device)
        return {"advanced": True}

    monkeypatch.setattr(chaos, "run_live", live)
    rc, _ = _out(pcli.main, ["chaos", "run", str(path), "--live", "--dir",
                             str(tmp_path / "live"), "--device", "cpu"])
    assert rc == 0
    assert seen == dict(engine="byzantine", root=str(tmp_path / "live"),
                        device="cpu")


# ----------------------------------------------------------------------
# run --chaos_plan: the link identities of _chaos_wrap


class _Inner:
    """A transport stand-in with an address (all ``_chaos_wrap`` reads)."""

    def __init__(self, addr):
        self.addr = addr
        self.consumer = None

    def local_addr(self):
        return self.addr


def _wrap_args(**kw):
    base = dict(chaos_plan="", chaos_seed=None, chaos_epoch=1000.0,
                chaos_addrs="", bootstrap_peers="")
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("joiner,bare", [(False, False), (False, True),
                                         (True, False)])
def test_chaos_wrap_gives_the_jax_link_identities(tmp_path, joiner, bare):
    from babble_tpu.crypto.keys import PemKeyFile as JPem
    from babble_tpu.net.peers import JSONPeers as JPeers

    from babble_tpu_torch.crypto.keys import PemKeyFile
    from babble_tpu_torch.net.peers import JSONPeers

    ports = tn.PortLayout(gossip=21000, submit=22000, commit=23000,
                          service=24000)
    tn.build_conf(str(tmp_path / "net"), 4, ports, joiners=1)
    # a bare plan declares no joiners, so it takes a plan without joins
    sc = load_scenario("slow-peer" if bare else "join-under-load").to_dict()
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(sc["plan"] if bare else sc))
    kw = dict(chaos_plan=str(plan), chaos_seed=5)
    if joiner:
        kw["bootstrap_peers"] = str(tmp_path / "net" / "node4"
                                    / "bootstrap_peers.json")
    node = 4 if joiner else 2
    d = str(tmp_path / "net" / f"node{node}")
    addr = ports.of(node)["gossip"]
    port = pcli._chaos_wrap(_Inner(addr), _wrap_args(**kw),
                            PemKeyFile(d).read(), JSONPeers(d).peers())
    jax = jcli._chaos_wrap(_Inner(addr), _wrap_args(**kw),
                           JPem(d).read(), JPeers(d).peers())
    assert (port.node_id, port.addr_index) == (jax.node_id, jax.addr_index)
    assert port.injector.seed == jax.injector.seed == 5
    assert port.injector.tick_seconds == jax.injector.tick_seconds
    assert (port.injector.plan.to_dict()
            == jax.injector.plan.to_dict())
    # the chaos_addrs map, when given, is the identity source
    amap = tmp_path / "addrs.json"
    amap.write_text(json.dumps({ports.of(i)["gossip"]: i for i in range(5)}))
    kw["chaos_addrs"] = str(amap)
    if not bare:
        port = pcli._chaos_wrap(_Inner(addr), _wrap_args(**kw),
                                PemKeyFile(d).read(), JSONPeers(d).peers())
        assert port.node_id == node and len(port.addr_index) == 5


# ----------------------------------------------------------------------
# a live port fleet under --chaos_plan


def test_three_process_testnet_under_a_partition_plan(tmp_path):
    """Node 2 is cut off for the first half of the run: the fleet counts
    partition faults on /metrics and every node reaches consensus."""
    sc = Scenario.from_dict({
        "name": "live-partition", "nodes": 3, "steps": 200, "seed": 3,
        "tick_seconds": 0.1, "invariants": ["prefix_agreement"],
        "plan": {"default": {"drop": 0.05},
                 "partitions": [{"group": [2], "start": 0, "heal": 100}]},
    })
    lines = []
    report = run_live(sc, str(tmp_path / "live"), rate=10.0,
                      log=lines.append, device="cpu",
                      ports=tn.free_port_layout(3))
    assert report["advanced"], report["stats"]
    faults = report["chaos_faults"]
    assert set(faults) == {"0", "1", "2"}
    assert sum(f.get("partition", 0) for f in faults.values()) > 0, faults
    assert all("error" not in f for f in faults.values()), faults
    for i in range(3):
        log = (tmp_path / "live" / f"node{i}" / "node.log").read_text()
        assert " on cpu listening on " in log
        assert "chaos plan" in log and "active (seed 3)" in log


# ----------------------------------------------------------------------
# the testnet knobs


def test_testnet_knobs_give_the_jax_node_arguments(tmp_path):
    kw = dict(heartbeat_ms=20, tcp_timeout_ms=1500, joiners=1,
              checkpoints=True, wal=True, byzantine=True,
              extra_node_args=["--chaos_plan", "p.json"])
    port = tn.TestnetRunner(str(tmp_path / "p"), 3, device="cpu", **kw)
    jax = jtn.TestnetRunner(str(tmp_path / "j"), 3, **kw)
    for i in range(4):
        p, j = port._node_args(i), jax._node_args(i)
        assert p[1:3] == ["-m", "babble_tpu_torch.cli"]
        p = [a.replace(str(tmp_path / "p"), "D") for a in p[3:]]
        j = [a.replace(str(tmp_path / "j"), "D") for a in j[3:]]
        at = p.index("--device")
        assert p[at:at + 2] == ["--device", "cpu"]
        assert p[:at] + p[at + 2:] == j
        assert ("--bootstrap_peers" in p) == (i >= 3)
        at = p.index("--checkpoint_interval")
        assert p[at + 1] == str(tn.CHECKPOINT_INTERVAL_S)
    for bad in (2, 4):
        with pytest.raises(ValueError, match="joiner index"):
            port.spawn_joiner(bad)


def test_build_conf_writes_joiner_datadirs_as_jax(tmp_path):
    from babble_tpu_torch.crypto.keys import PemKeyFile
    from babble_tpu_torch.net.peers import JSONPeers

    ports = tn.PortLayout(gossip=21000, submit=22000, commit=23000,
                          service=24000)
    dirs = tn.build_conf(str(tmp_path), 3, ports, joiners=2)
    assert len(dirs) == 5
    keys = [PemKeyFile(d).read().pub_hex for d in dirs]
    founders = [{"NetAddr": ports.of(i)["gossip"], "PubKeyHex": keys[i]}
                for i in range(3)]
    for i, d in enumerate(dirs):
        peers = [(p.net_addr, p.pub_key_hex) for p in JSONPeers(d).peers()]
        want = [(f["NetAddr"], f["PubKeyHex"]) for f in founders]
        if i >= 3:
            want.append((ports.of(i)["gossip"], keys[i]))
            with open(os.path.join(d, "bootstrap_peers.json")) as f:
                assert json.load(f) == founders
        else:
            assert not os.path.exists(os.path.join(d,
                                                   "bootstrap_peers.json"))
        assert peers == want
    # the JAX runner's joiner reads the port's datadir as its own
    jdirs = jtn.build_conf(str(tmp_path), 3, jtn.PortLayout(
        gossip=21000, submit=22000, commit=23000, service=24000), joiners=2)
    assert jdirs == dirs
    assert [PemKeyFile(d).read().pub_hex for d in dirs] == keys


@pytest.mark.slow
def test_live_join_under_load(tmp_path):
    """The JAX package's slow live-churn case through the port: a joiner
    process boots mid-run as an observer, its join tx is submitted
    through a founder's SubmitTx, a founder leaves later, and every
    reachable node ends at epoch 2 with consensus advanced."""
    sc = load_scenario("join-under-load")
    sc = Scenario.from_dict({**sc.to_dict(), "tick_seconds": 0.3})
    report = run_live(sc, str(tmp_path / "live"), rate=10.0,
                      log=lambda *_: None, device="cpu",
                      ports=tn.free_port_layout(sc.nodes + sc.joiners))
    assert report["advanced"], report.get("stats")
    reached = [v for v in report.get("epochs", {}).values()
               if isinstance(v, int)]
    assert reached and all(v == 2 for v in reached), report.get("epochs")
    joiner_row = report["stats"][sc.nodes]
    assert "error" not in joiner_row, joiner_row
    assert int(joiner_row["consensus_events"]) > 0, joiner_row

