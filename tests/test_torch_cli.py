"""The port's ``cli`` and testnet runner against the JAX package's, on the
CPU.

- ``run``'s parser has every flag of JAX ``run`` with the same option
  strings, destination, default, type, choices and action, plus
  ``--device`` (default ``cuda``) and without ``--jax_cache`` (the port
  has no XLA cache);
- ``keygen`` writes a PEM key file that JAX ``PemKeyFile`` reads to the
  same identity, and prints the JAX package's PEM;
- ``sim --device cpu`` prints JAX ``cli sim``'s ``ordered``,
  ``last_consensus_round`` and ``max_round`` on the same DAG;
- the flags and verbs whose machinery is not ported raise naming their
  ROADMAP.md item, ``run``'s byzantine flags (``--byzantine``,
  ``--fork_k``, ``--fork_caps``) reach the node's engine as the JAX cli
  sets them, and ``run`` without ``--device`` takes the card (so it
  fails on a machine without one instead of falling back);
- ``run``'s ``--chaos_*`` flags are accepted and reach ``_chaos_wrap``;
- three port node processes (``TestnetRunner(device="cpu")``) with dummy
  apps commit a few dozen transactions submitted over JSON-RPC, every
  app's messages.txt holding each once, in one order.
"""

import argparse
import asyncio
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import pytest

from babble_tpu import cli as jcli
from babble_tpu.crypto.keys import PemKeyFile as JPemKeyFile
from babble_tpu.crypto.keys import pem_dump as jpem_dump

from babble_tpu_torch import cli as pcli
from babble_tpu_torch import testnet as tn
from babble_tpu_torch.crypto.keys import PemKeyFile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_run_parser(monkeypatch):
    """The JAX package's ``run`` subparser, captured as its ``main``
    builds it."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def spy(self, *a, **k):
        seen.setdefault("parser", self)
        return real(self, *a, **k)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    monkeypatch.setattr(jcli, "cmd_run", lambda args: args)
    jcli.main(["run"])
    return _subparser(seen["parser"], "run")


def _subparser(parser, name):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices[name]


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     tuple(a.choices) if a.choices else None,
                     type(a).__name__, a.nargs)
            for a in parser._actions if a.dest != "help"}


def test_run_parser_matches_jax_run(monkeypatch):
    jflags = _flags(_jax_run_parser(monkeypatch))
    pflags = _flags(_subparser(pcli.build_parser(), "run"))
    assert set(jflags) - set(pflags) == {"jax_cache"}
    assert set(pflags) - set(jflags) == {"device"}
    for dest in jflags.keys() & pflags.keys():
        assert pflags[dest] == jflags[dest], dest
    assert pflags["device"][:2] == (("--device",), "cuda")
    args = pcli.build_parser().parse_args(["run"])
    assert args.device == "cuda" and args.fn is pcli.cmd_run


def test_other_verbs_match_jax(monkeypatch):
    """keygen, sim, dummy and testnet conf/run/bombard/watch keep the
    JAX flags; sim and testnet run add --device."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def spy(self, *a, **k):
        seen.setdefault("parser", self)
        return real(self, *a, **k)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    monkeypatch.setattr(jcli, "cmd_keygen", lambda args: args)
    jcli.main(["keygen"])
    jp, pp = seen["parser"], pcli.build_parser()
    for verb, extra in (("keygen", set()), ("sim", {"device"}),
                        ("dummy", set())):
        jf, pf = _flags(_subparser(jp, verb)), _flags(_subparser(pp, verb))
        assert set(pf) - set(jf) == extra, verb
        assert all(pf[d] == jf[d] for d in jf), verb
    jt, pt = _subparser(jp, "testnet"), _subparser(pp, "testnet")
    for verb, extra in (("conf", set()), ("run", {"device"}),
                        ("bombard", set()), ("watch", set())):
        jf = _flags(_subparser(jt, verb))
        pf = _flags(_subparser(pt, verb))
        assert set(pf) - set(jf) == extra, verb
        assert all(pf[d] == jf[d] for d in jf), verb


def test_keygen_writes_a_key_jax_reads(tmp_path):
    d = str(tmp_path / "k")
    os.makedirs(d)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert pcli.main(["keygen", "--datadir", d]) == 0
    key = PemKeyFile(d).read()
    jkey = JPemKeyFile(d).read()
    assert jkey.pub_hex == key.pub_hex
    _, pub = jpem_dump(jkey)
    assert out.getvalue() == f"wrote {PemKeyFile(d).path}\nPublicKey:\n{pub}\n"
    # a second keygen into the same datadir refuses, as in JAX
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        assert pcli.main(["keygen", "--datadir", d]) == 1
    assert "key already exists" in err.getvalue()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert pcli.main(["keygen"]) == 0
    assert "PrivateKey:" in out.getvalue()


def _sim(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sim_prints_the_jax_counts():
    argv = ["sim", "--nodes", "8", "--events", "512", "--rounds", "64",
            "--seed", "5"]
    port = _sim(pcli.main, argv + ["--device", "cpu"])
    jax = _sim(jcli.main, argv)
    keys = ("nodes", "events", "ordered", "last_consensus_round",
            "max_round")
    assert {k: port[k] for k in keys} == {k: jax[k] for k in keys}
    assert port["ordered"] > 0 and port["device"] == "cpu"
    assert set(jax) <= set(port)


NOT_PORTED = [
    (["--engine", "wide"], "item 8"),
    (["--wide_caps", "4,4,4"], "item 8"),
]


@pytest.mark.parametrize("flags,item", NOT_PORTED)
def test_unported_run_flags_raise_naming_their_item(flags, item):
    with pytest.raises(SystemExit) as err:
        pcli.main(["run", "--datadir", "/nonexistent"] + flags)
    msg = str(err.value)
    assert msg.startswith(f"{flags[0]} ") and f"ROADMAP.md Queue 1, {item}" \
        in msg


class _Wrapped(Exception):
    pass


@pytest.mark.parametrize("flags,want", [
    (["--byzantine"], dict(byzantine=True, fork_k=2, fork_caps=None)),
    (["--byzantine", "--fork_k", "3"],
     dict(byzantine=True, fork_k=3, fork_caps=None)),
    (["--byzantine", "--fork_caps", "4096,64,16"],
     dict(byzantine=True, fork_k=2, fork_caps=(4096, 64, 16))),
])
def test_byzantine_run_flags_reach_the_node(tmp_path, monkeypatch, flags,
                                            want):
    """The byzantine run flags (ROADMAP item 7, refused before the port
    had the engine): the node boots a ``ForkHashgraph`` with the budget
    and capacities asked for, from the Config the JAX cli builds."""
    from babble_tpu_torch.consensus.fork_engine import ForkHashgraph
    from babble_tpu_torch.node import node as pnode

    tn.build_conf(str(tmp_path), 2)
    seen = {}

    class Spy(pnode.Node):
        def __init__(self, conf, *a, **k):
            super().__init__(conf, *a, **k)
            seen.update(conf=conf, hg=self.core.hg)
            raise _Wrapped

    monkeypatch.setattr(pnode, "Node", Spy)
    with pytest.raises(_Wrapped):
        pcli.main(["run", "--datadir", str(tmp_path / "node0"),
                   "--no_client", "--node_addr", "127.0.0.1:0",
                   "--device", "cpu"] + flags)
    conf, hg = seen["conf"], seen["hg"]
    assert {k: getattr(conf, k) for k in want} == want
    assert isinstance(hg, ForkHashgraph) and hg.k == want["fork_k"]
    assert hg._caps == (want["fork_caps"] or (0, 0, 0))
    jargs = _jax_run_parser(monkeypatch).parse_args(
        ["--datadir", "x"] + flags)
    assert (jargs.byzantine, jargs.fork_k,
            jcli._parse_fork_caps(jargs.fork_caps)) == \
        (want["byzantine"], want["fork_k"], want["fork_caps"])
    for bad in ("4,4", "a,b,c", "0,4,4"):
        with pytest.raises(SystemExit) as perr:
            pcli._parse_fork_caps(bad)
        with pytest.raises(SystemExit) as jerr:
            jcli._parse_fork_caps(bad)
        assert str(perr.value) == str(jerr.value)


def test_run_refuses_a_fork_k_the_card_kernel_lacks():
    """``--fork_k`` past the fork_ss kernel's k on the card exits at the
    flag, before the node boots; on the CPU the plain twin takes it."""
    argv = ["run", "--datadir", "/nonexistent", "--byzantine", "--fork_k",
            "9"]
    with pytest.raises(SystemExit) as err:
        pcli.main(argv)
    assert str(err.value) == ("--fork_k 9: the fork_ss kernel on cuda is "
                              "built for k in [1, 8]")
    args = pcli.build_parser().parse_args(argv + ["--device", "cpu"])
    pcli.check_fork_k(args)
    pcli.check_fork_k(pcli.build_parser().parse_args(argv[:3] + [
        "--byzantine", "--fork_k", "8"]))


@pytest.mark.parametrize("flags,attr,value", [
    ([], "chaos_plan", None),
    (["--chaos_seed", "3"], "chaos_seed", 3),
    (["--chaos_epoch", "1.5"], "chaos_epoch", 1.5),
    (["--chaos_addrs", "a.json"], "chaos_addrs", "a.json"),
])
def test_chaos_run_flags_reach_chaos_wrap(tmp_path, monkeypatch, flags,
                                          attr, value):
    """The flags the port refused before the chaos plane was ported: a
    node with ``--chaos_plan`` wraps its TCP transport in
    ``_chaos_wrap``, which sees every ``--chaos_*`` value."""
    tn.build_conf(str(tmp_path), 2)
    plan = tmp_path / "plan.json"
    plan.write_text("{}")
    seen = {}

    def wrap(transport, args, key, peers):
        seen.update(args=args, addr=transport.local_addr(), key=key,
                    peers=peers)
        raise _Wrapped

    monkeypatch.setattr(pcli, "_chaos_wrap", wrap)
    with pytest.raises(_Wrapped):
        pcli.main(["run", "--datadir", str(tmp_path / "node0"),
                   "--no_client", "--node_addr", "127.0.0.1:0",
                   "--device", "cpu", "--chaos_plan", str(plan)] + flags)
    assert getattr(seen["args"], attr) == (str(plan) if value is None
                                           else value)
    assert len(seen["peers"]) == 2 and seen["addr"].startswith("127.0.0.1:")


@pytest.mark.parametrize("argv,item", [
    (["fleet", "watch", "--hosts", "h"], "item 5e"),
    (["lint", "--json", "x"], "item 5e"),
    (["testnet", "health"], "item 5e"),
    (["testnet", "trace", "ab"], "item 5e"),
])
def test_unported_verbs_raise_naming_their_item(argv, item):
    with pytest.raises(SystemExit) as err:
        pcli.main(argv)
    assert f"ROADMAP.md Queue 1, {item}" in str(err.value)


def test_run_takes_the_card_by_default(tmp_path):
    """No --device: the node's engine is built on cuda, which this CPU
    machine does not have, so the process fails instead of falling back
    (with --device cpu the same datadir boots: the testnet test)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a CUDA card")
    tn.build_conf(str(tmp_path), 1)
    ports = tn.free_port_layout(1).of(0)
    proc = subprocess.run(
        [sys.executable, "-m", "babble_tpu_torch.cli", "run",
         "--datadir", str(tmp_path / "node0"), "--no_client",
         "--node_addr", ports["gossip"], "--service_addr", ports["service"]],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr, proc.stderr[-2000:]


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} not reached in {timeout} s")
        time.sleep(0.2)


def test_three_process_testnet_commits_in_one_order(tmp_path):
    n, n_txs = 3, 36
    ports = tn.free_port_layout(n)
    runner = tn.TestnetRunner(str(tmp_path / "net"), n, heartbeat_ms=20,
                              tcp_timeout_ms=1000, cache_size=500,
                              ports=ports, device="cpu")
    logs = [tmp_path / "net" / f"node{i}" / "messages.txt" for i in range(n)]

    def lines(i):
        return logs[i].read_text().splitlines() if logs[i].exists() else []

    def up():
        rows = tn.watch_once(n, ports)
        return all("error" not in r for r in rows)

    with runner:
        _wait(up, 90, "every node's /Stats")
        txs = [b"cli-%02d" % i for i in range(n_txs)]

        async def submit():
            from babble_tpu_torch.proxy.jsonrpc import JsonRpcClient, b64e

            clients = [JsonRpcClient(ports.of(i)["submit"], timeout=15.0)
                       for i in range(n)]
            try:
                for k, tx in enumerate(txs):
                    assert await clients[k % n].call(
                        "Babble.SubmitTx", b64e(tx)) is True
            finally:
                for c in clients:
                    await c.close()

        asyncio.run(asyncio.wait_for(submit(), 60))
        _wait(lambda: all(len(lines(i)) >= n_txs for i in range(n)), 90,
              "every app holding every transaction")
        stats = tn.watch_once(n, ports)
        alive = [p.poll() is None for p in runner.node_procs.values()]
    order = lines(0)
    assert sorted(order) == sorted(tx.decode() for tx in txs)
    assert all(lines(i) == order for i in range(n))
    assert alive == [True] * n
    assert all(int(r["consensus_transactions"]) >= n_txs for r in stats)
    assert "consensus_events" in tn.format_stats(stats)
    for i in range(n):
        boot = (tmp_path / "net" / f"node{i}" / "node.log").read_text()
        assert " on cpu listening on " + ports.of(i)["gossip"] in boot
