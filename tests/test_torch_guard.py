"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package nor msgpack nor cryptography (the card's machine has none), and
runs a consensus step, a live stream, the engine, a churn flow, a
checkpoint save and load, a 3-node fleet of its ``Node`` (gossip to
committed transactions, then a restart from the write-ahead log), its
cli's ``keygen`` and ``sim --device cpu`` as ``python -m`` runs them, a
round trip between two of its TCP transports, a chaos scenario through
its runner (the disk-rot mini: crash, checkpoint and WAL rot,
recovery), its C++ generator and baseline (built by its own loader),
its straight-line oracle, its AOT prewarm (a fused stream's manifest
prewarming a twin, and the fork and wide warm-ups), its host tools
(``lint`` over the whole port, ``fleet conf`` and a ``testnet health``
sweep) and its sharded step on a 2-rank gloo group (each rank a child
interpreter with the same blocks), with all four blocked."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "babble_tpu_torch")


def _banned(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "babble_tpu", "msgpack",
                                  "cryptography")


def _port_sources():
    for root, _dirs, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_import_no_jax():
    found = []
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    assert {"cli.py", "testnet.py", "net/codec.py", "net/tcp_transport.py",
            "proxy/admission.py", "proxy/jsonrpc.py", "proxy/socket_app.py",
            "proxy/socket_babble.py", "proxy/dummy.py",
            "service/service.py", "chaos/__init__.py", "chaos/plan.py",
            "chaos/injector.py", "chaos/transport.py", "chaos/invariants.py",
            "chaos/disk.py", "chaos/forge.py", "chaos/scenarios.py",
            "chaos/scenario.py", "native/__init__.py",
            "consensus/oracle.py", "store/inmem.py", "fleet.py",
            "membership/quorum.py"} <= scanned
    analysis = os.path.join(REPO, "babble_tpu", "analysis")
    assert {f"analysis/{f}" for f in os.listdir(analysis)
            if f.endswith(".py")} <= scanned
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                      for n in names if _banned(n)]
    assert found == [], "\n".join(found)


_BLOCKED_STEP = r"""
import sys
BLOCKED = ("jax", "jaxlib", "babble_tpu", "msgpack", "cryptography")
for name in BLOCKED:
    sys.modules[name] = None
import babble_tpu_torch as bt
dag = bt.random_gossip_arrays(4, 200, seed=3)
cfg = bt.DagConfig(n=4, e_cap=256, s_cap=max(64, dag.max_chain + 1), r_cap=32)
for mode in ("walk", "fast"):
    out = bt.consensus_step(cfg, mode, bt.init_state(cfg, device="cpu"),
                            bt.batch_from_arrays(dag, device="cpu"))
    assert int(out.lcr) > 0, int(out.lcr)
    assert int((out.rr >= 0).sum()) > 0
from babble_tpu_torch.sim.live import live_stream
live, log = live_stream(cfg, dag, 8, gate=True, device="cpu")
assert int(live.lcr) > 0 and log[-1].k == 0, (int(live.lcr), log[-1])
gen = bt.random_gossip_dag(4, 120, seed=3)
eng = bt.TorchHashgraph(gen.participants, verify_signatures=False, device="cpu",
                        e_cap=64, s_cap=16, r_cap=8, auto_compact=True,
                        seq_window=8, compact_min=16, finality_gate=True)
for i, ev in enumerate(gen.events):
    eng.insert_event(ev)
    if i % 16 == 15:
        eng.run_consensus()
eng.run_consensus()
assert eng.commit_length > 0 and eng.dag.slot_base > 0, eng.stats_snapshot()
import tempfile
from babble_tpu_torch.sim.generator import feed_churn, random_churn_dag
from babble_tpu_torch.store import load_checkpoint, save_checkpoint
churn = random_churn_dag(4, 300, 5, [(30, "join", 4, 0), (50, "forged", 5, 0),
                                     (150, "start", 4, 1)])
eng = bt.TorchHashgraph(dict(churn.participants), verify_signatures=False,
                        device="cpu", e_cap=64, s_cap=16, r_cap=8,
                        auto_compact=True, seq_window=6, compact_min=16,
                        finality_gate=True)
for lo in range(0, 300, 24):
    feed_churn(eng, churn, lo, min(lo + 24, 300))
    eng.run_consensus()
assert eng.epoch == 1 and eng.cfg.n == 5 and eng.membership_rejects == 1
path = tempfile.mkdtemp() + "/ckpt"
save_checkpoint(eng, path)
back = load_checkpoint(path, device="cpu")
assert back.commit_digest == eng.commit_digest and back.epoch == 1
assert back.membership_log == eng.membership_log
# the wide pipeline's rolling-window stream (compaction engaged, C > 1)
# and a wide engine's checkpoint round trip
wide = bt.stream_consensus(bt.DagConfig(n=8, e_cap=256, s_cap=64, r_cap=16,
                                        coord8=True),
                           bt.random_gossip_arrays(8, 600, seed=3),
                           batch_events=100, n_blocks=3, seq_window=8,
                           compact_min=32, device="cpu")
assert wide.evicted > 0 and wide.ordered_total > 0, wide.stats
weng = bt.WideHashgraph(gen.participants, verify_signatures=False,
                        device="cpu", e_cap=96, s_cap=32, r_cap=16,
                        n_blocks=2, seq_window=6, compact_min=16)
for lo in range(0, 120, 24):
    for ev in gen.events[lo:lo + 24]:
        weng.insert_event(ev.clone())
    weng.run_consensus()
assert weng.commit_length > 0 and weng.dag.slot_base > 0
path = tempfile.mkdtemp() + "/wide"
save_checkpoint(weng, path)
wback = load_checkpoint(path, device="cpu")
assert type(wback).__name__ == "WideHashgraph"
assert wback.commit_digest == weng.commit_digest
assert wback.known() == weng.known()
import asyncio
from babble_tpu_torch.crypto.keys import key_from_scalar
from babble_tpu_torch.net import InmemNetwork, Peer
from babble_tpu_torch.node import Config, Node
from babble_tpu_torch.proxy import InmemAppProxy


async def fleet():
    net = InmemNetwork()
    keys = [key_from_scalar(101 + i) for i in range(3)]
    ts = [net.transport(f"inmem://{i}") for i in range(3)]
    peers = [Peer(t.local_addr(), k.pub_hex) for t, k in zip(ts, keys)]
    wal = tempfile.mkdtemp()

    def conf(i):
        c = Config.test_config(heartbeat=0.01, device="cpu")
        c.wal_dir, c.wal_fsync = f"{wal}/{i}", "off"
        return c

    proxies = [InmemAppProxy() for _ in range(3)]
    nodes = [Node(conf(i), keys[i], peers, ts[i], proxies[i])
             for i in range(3)]

    async def committed(k):
        while not all(len(p.committed) >= k for p in proxies):
            await asyncio.sleep(0.05)

    for nd in nodes:
        nd.init()
        nd.run_task()
    for i in range(6):
        await proxies[i % 3].submit_tx(b"tx%d" % i)
    await asyncio.wait_for(committed(6), 120)
    await nodes[2].shutdown()
    seq = nodes[2].core.seq
    proxies[2] = InmemAppProxy()
    nodes[2] = Node(conf(2), keys[2], peers, net.transport("inmem://2"),
                    proxies[2])
    assert nodes[2].core.seq == seq and not nodes[2].core.probing
    nodes[2].init()
    nodes[2].run_task()
    await proxies[0].submit_tx(b"after")
    await asyncio.wait_for(committed(7), 120)
    for nd in nodes:
        await nd.shutdown()
    orders = [p.committed[:7] for p in proxies]
    assert orders[0] == orders[1] == orders[2], orders
    assert set(orders[0]) == {b"tx%d" % i for i in range(6)} | {b"after"}


asyncio.run(fleet())

# the process around the node: the cli as ``python -m`` runs it, and one
# round trip between two port TCP transports
import contextlib
import io
import json
import runpy


def cli(*argv, rc=0):
    out = io.StringIO()
    sys.argv = ["babble_tpu_torch.cli", *argv]
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            runpy.run_module("babble_tpu_torch.cli", run_name="__main__")
        except SystemExit as e:
            code = e.code
    assert code == rc, (code, out.getvalue()[-2000:])
    return out.getvalue()


assert cli("keygen").startswith("PublicKey:")
sim = json.loads(cli("sim", "--device", "cpu", "--nodes", "4", "--events",
                     "200", "--rounds", "32", "--seed", "3").splitlines()[-1])
assert sim["ordered"] > 0 and sim["device"] == "cpu", sim
from babble_tpu_torch.net import SyncRequest, SyncResponse, new_tcp_transport


async def round_trip():
    a = await new_tcp_transport("127.0.0.1:0")
    b = await new_tcp_transport("127.0.0.1:0")

    async def serve():
        rpc = await b.consumer.get()
        rpc.respond(SyncResponse(b.local_addr(), "0xH", [], {1: 2}))

    t = asyncio.ensure_future(serve())
    resp = await a.sync(b.local_addr(), SyncRequest(a.local_addr(), {0: 1}))
    await t
    await a.close()
    await b.close()
    assert (resp.head, resp.known) == ("0xH", {1: 2})


asyncio.run(round_trip())

# the chaos plane: a scenario through the deterministic runner, with
# seeded disk rot on the restarted node's checkpoint and WAL
import logging
from babble_tpu_torch.chaos import Scenario, run_scenario
from chip_smoke import CHAOS_EXPECT, CHAOS_MINI_DISKROT, chaos_summary

logging.disable(logging.WARNING)
r = run_scenario(Scenario.from_dict({**CHAOS_MINI_DISKROT, "seed": 1}),
                 seed=1, device="cpu")
assert r.fault_counts["checkpoint_corrupt"] == 1, r.fault_counts
assert chaos_summary(r) == CHAOS_EXPECT["mini-disk-rot"][1], chaos_summary(r)
# the independent references: the C++ generator and baseline built by
# the port's loader, and the straight-line oracle with its Store
from babble_tpu_torch import OracleHashgraph, native
from babble_tpu_torch.store import InmemStore
small = bt.random_gossip_arrays(8, 500, seed=3)
twin = bt.random_gossip_arrays(8, 500, seed=3, force_python=True)
assert all((getattr(small, f) == getattr(twin, f)).all()
           for f in ("sp", "op", "creator", "seq", "ts", "mbit", "levels"))
ordered, base = native.baseline_consensus(small)
cfg8 = bt.DagConfig(n=8, e_cap=500, s_cap=small.max_chain + 1, r_cap=64)
out = bt.consensus_step(cfg8, "fast", bt.init_state(cfg8, device="cpu"),
                        bt.batch_from_arrays(small, device="cpu"))
assert ordered == 370 == int((out.rr[:500] >= 0).sum()), ordered
assert (out.rr[:500].numpy() == base["rr"]).all()
oracle = OracleHashgraph(participants=gen.participants, verify_signatures=False,
                         store=InmemStore(gen.participants, 100_000))
for ev in gen.events:
    oracle.insert_event(ev.clone())
oracle.run_consensus()
assert len(oracle.consensus_events()) > 0
# the AOT prewarm: a fused stream records its shape manifest, and twins
# prewarmed from it (fused, fork, wide) commit what the cold runs commit
from babble_tpu_torch.ops import aot
root = tempfile.mkdtemp()
aot.configure(root)


def feed(engine, every=8):
    for i, ev in enumerate(gen.events):
        engine.insert_event(ev.clone())
        if i % every == every - 1:
            engine.run_consensus()
    engine.run_consensus()
    return engine


def fused():
    return bt.TorchHashgraph(gen.participants, verify_signatures=False,
                             device="cpu", finality_gate=True)


def forked():
    return bt.ForkHashgraph(gen.participants, device="cpu")


cold, cold_fork = fused(), forked()
cold._aot_dir = cold_fork._aot_dir = root
feed(cold)
feed(cold_fork, every=24)
twin, twin_fork = fused(), forked()
n_keys = len([e for e in aot.load_manifest(root) if "key" in e])
assert aot.prewarm_engine(twin, root) == {"compiled": n_keys,
                                         "from_manifest": n_keys}
assert aot.prewarm_engine(twin_fork, root)["compiled"] > 0
assert twin_fork._caps == cold_fork._caps
assert feed(twin).commit_digest == cold.commit_digest
assert feed(twin_fork, every=24).consensus == cold_fork.consensus
wide_twin = bt.WideHashgraph(gen.participants, verify_signatures=False,
                             device="cpu", e_cap=96, s_cap=32, r_cap=16,
                             n_blocks=2, seq_window=6, compact_min=16)
assert aot.prewarm_engine(wide_twin, root)["compiled"] == 1
for lo in range(0, 120, 24):
    for ev in gen.events[lo:lo + 24]:
        wide_twin.insert_event(ev.clone())
    wide_twin.run_consensus()
assert wide_twin.commit_digest == weng.commit_digest
blocked = [m for m in sys.modules if m.split(".")[0] in BLOCKED
           and sys.modules[m] is not None]
# the host tools: babble-lint over the whole port, a fleet's conf and
# deploy scripts, and a health sweep of a testnet that is not running
assert cli("lint", "babble_tpu_torch") == ""
import os
import socket
conf = tempfile.mkdtemp()
with open(conf + "/hosts.txt", "w") as f:
    f.write("10.0.0.1\n10.0.0.2\n10.0.0.3\n")
cli("fleet", "conf", "--hosts", conf + "/hosts.txt", "--dir", conf)
assert sorted(os.listdir(conf + "/conf")) == ["node0", "node1", "node2"]
assert os.access(conf + "/start.sh", os.X_OK)
sock = socket.socket()
sock.bind(("127.0.0.1", 0))
base = sock.getsockname()[1]
sock.close()
health = cli("testnet", "health", "--n", "2", "--base_port",
             str(base - 3000), rc=1)
assert health.count("<unreachable") == 2, health
# the sharded step on a 2-rank gloo group: each rank its own interpreter
# with the same four blocked, joined through bootstrap's torchrun vars
RANK = '''
import sys
BLOCKED = ("jax", "jaxlib", "babble_tpu", "msgpack", "cryptography")
for name in BLOCKED:
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
import babble_tpu_torch as bt
from babble_tpu_torch.parallel import (
    bootstrap, make_mesh, make_sharded_step, pad_cfg_for_mesh,
    sharded_init_state)
from babble_tpu_torch.parallel.sharded import gather_state
bootstrap(backend="gloo")
mesh = make_mesh(2, shape=(1, 2), device="cpu")
dag = bt.random_gossip_arrays(6, 300, seed=3)
cfg = pad_cfg_for_mesh(bt.DagConfig(n=6, e_cap=300,
                                    s_cap=max(64, dag.max_chain + 1),
                                    r_cap=32), mesh)
batch = bt.batch_from_arrays(dag, device="cpu")
step = make_sharded_step(cfg, mesh, "fast")
out = gather_state(step(sharded_init_state(cfg, mesh), batch), mesh)
ref = bt.consensus_step(cfg, "fast", bt.init_state(cfg, device="cpu"), batch)
bt.assert_consensus_parity(ref, out, 300, "2 ranks")
assert int(out.lcr) > 0 and step.shard.widths()["frontier"] == [3]
blocked = [m for m in sys.modules if m.split(".")[0] in BLOCKED
           and sys.modules[m] is not None]
assert not blocked, blocked
torch.distributed.destroy_process_group()
print("rank ok")
'''
import subprocess
sock = socket.socket()
sock.bind(("127.0.0.1", 0))
port = sock.getsockname()[1]
sock.close()
env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
           WORLD_SIZE="2")
ranks = [subprocess.Popen([sys.executable, "-c", RANK],
                          env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True)
         for r in range(2)]
for proc in ranks:
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0 and out.strip().endswith("rank ok"), err[-2000:]
blocked = [m for m in sys.modules if m.split(".")[0] in BLOCKED
           and sys.modules[m] is not None]
assert not blocked, blocked
print("ok")
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_STEP], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
