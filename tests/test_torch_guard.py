"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package nor msgpack nor cryptography (the card's machine has none), and
runs a consensus step, a live stream, the engine, a churn flow, a
checkpoint save and load, and a 3-node fleet of its ``Node`` (gossip to
committed transactions, then a restart from the write-ahead log) with
all four blocked."""

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
