"""Local testnet tooling — the docker/terraform scripts, rebuilt as code:
the port's copy of the JAX package's ``testnet.py``, spawning port nodes
(``python -m babble_tpu_torch.cli run --device ...``) and dummy apps.

The reference ships its fleet ops as shell around Docker (reference
docker/makefile:1-28, docker/scripts/build-conf.sh, run-testnet.sh,
watch.sh, bombard.sh, demo.sh) and Terraform for AWS.  Here the same
workflow is a library + CLI that works on any host with a Python:

- ``build_conf``  — N keypairs + the shared peers.json   (build-conf.sh)
- ``TestnetRunner`` — spawn N nodes (+ dummy chat apps) as subprocesses
  with run-testnet.sh's port layout
- ``watch``       — poll every node's /Stats into a table (watch.sh)
- ``bombard``     — flood random transactions at a target rate
  (bombard.sh, minus the netcat)

Port layout per node i (single host): node gossip 12000+i, node SubmitTx
13000+i, app CommitTx 14000+i, /Stats 15000+i (overridable;
``free_port_layout`` finds bases whose ports are free right now).
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import urllib.request
from http.client import HTTPException
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .crypto.keys import PemKeyFile, generate_key
from .net.peers import JSONPeers, Peer

#: seconds between a checkpointing node's saves (--checkpoint_interval)
CHECKPOINT_INTERVAL_S = 5.0


@dataclass
class PortLayout:
    gossip: int = 12000
    submit: int = 13000
    commit: int = 14000
    service: int = 15000

    def of(self, i: int) -> Dict[str, str]:
        return {
            "gossip": f"127.0.0.1:{self.gossip + i}",
            "submit": f"127.0.0.1:{self.submit + i}",
            "commit": f"127.0.0.1:{self.commit + i}",
            "service": f"127.0.0.1:{self.service + i}",
        }


def free_port_layout(n: int, tries: int = 64) -> PortLayout:
    """A ``PortLayout`` whose 4 x ``n`` ports were all free a moment ago:
    each base is a port the kernel handed out for ``127.0.0.1:0``, kept
    only when the ``n - 1`` ports above it bind too.  (Another process
    may still take one before the fleet binds it.)"""
    bases = []
    held = []
    try:
        for _ in range(tries):
            if len(bases) == 4:
                break
            first = socket.socket()
            first.bind(("127.0.0.1", 0))
            base = first.getsockname()[1]
            group = [first]
            try:
                for i in range(1, n):
                    s = socket.socket()
                    group.append(s)
                    s.bind(("127.0.0.1", base + i))
            except OSError:
                for s in group:
                    s.close()
                continue
            held += group
            bases.append(base)
    finally:
        for s in held:
            s.close()
    if len(bases) < 4:
        raise RuntimeError(f"no free port ranges of {n} after {tries} tries")
    return PortLayout(*bases)


def build_conf(base_dir: str, n: int, ports: Optional[PortLayout] = None,
               overwrite: bool = False, joiners: int = 0) -> List[str]:
    """Create node datadirs with keys + the shared peers.json
    (reference docker/scripts/build-conf.sh:1-45).

    ``joiners`` (membership plane) creates ``joiners`` extra datadirs
    past the founding set: each gets its own key, a peers.json naming
    the founders PLUS itself (its gossip address book), and a
    ``bootstrap_peers.json`` naming the founders only (its epoch-0
    validator set — the node runs as an observer until its signed join
    tx commits; cli --bootstrap_peers)."""
    ports = ports or PortLayout()
    if overwrite and os.path.isdir(base_dir):
        shutil.rmtree(base_dir)
    keys = []
    datadirs = []
    for i in range(n + joiners):
        d = os.path.join(base_dir, f"node{i}")
        os.makedirs(d, exist_ok=True)
        pem = PemKeyFile(d)
        keys.append(pem.read() if pem.exists() else generate_key())
        if not pem.exists():
            pem.write(keys[-1])
        datadirs.append(d)
    founders = [
        Peer(net_addr=ports.of(i)["gossip"], pub_key_hex=keys[i].pub_hex)
        for i in range(n)
    ]
    for i, d in enumerate(datadirs):
        if i < n:
            JSONPeers(d).set_peers(founders)
        else:
            JSONPeers(d).set_peers(founders + [
                Peer(net_addr=ports.of(i)["gossip"],
                     pub_key_hex=keys[i].pub_hex)
            ])
            with open(os.path.join(d, "bootstrap_peers.json"), "w") as f:
                json.dump([{"NetAddr": p.net_addr,
                            "PubKeyHex": p.pub_key_hex}
                           for p in founders], f, indent=1)
    return datadirs


@dataclass
class TestnetRunner:
    """Spawn + manage a local fleet (reference docker/scripts/run-testnet.sh;
    default knobs mirror its heartbeat=10ms, cache_size=50000,
    tcp_timeout=200ms)."""

    base_dir: str
    n: int
    heartbeat_ms: int = 10
    cache_size: int = 50000
    tcp_timeout_ms: int = 200
    with_clients: bool = True
    ports: PortLayout = field(default_factory=PortLayout)
    extra_node_args: List[str] = field(default_factory=list)
    #: run fork-aware nodes (accept + detect equivocations).  No longer
    #: required for crash/restart chaos: with `wal` on, an honest node
    #: replays its write-ahead log at restart and resumes at its
    #: published head seq instead of re-minting indexes
    byzantine: bool = False
    #: per-node checkpoint dirs + a tight save interval, so a killed
    #: node restarts from recent state instead of a fresh root
    checkpoints: bool = False
    #: per-node write-ahead logs (<datadir>/wal): restart recovery is
    #: seq-exact — an honest node replays its log at restart and
    #: resumes at its published head seq instead of re-minting indexes
    wal: bool = False
    #: membership plane: datadirs prepared for nodes past the founding
    #: set (indices n..n+joiners-1).  They are NOT booted by start() —
    #: the runner calls spawn_joiner(i) at its scheduled tick; the
    #: joiner runs as an observer (--bootstrap_peers) until its signed
    #: join tx commits at an epoch boundary.
    joiners: int = 0
    #: AOT prewarm at node boot (ops/aot.py): every node runs the shared
    #: cache root's recorded shapes before its first flush.  False
    #: passes --no_aot_prewarm (and the nodes record no shapes)
    aot: bool = True
    #: every node's --device: the card by default; "cpu" runs each node
    #: in plain torch on the CPU (the nodes of one host share one card
    #: as separate CUDA contexts, time-sliced without MPS)
    device: str = "cuda"

    procs: List[subprocess.Popen] = field(default_factory=list)
    node_procs: Dict[int, subprocess.Popen] = field(default_factory=dict)
    client_procs: Dict[int, subprocess.Popen] = field(default_factory=dict)

    def _env(self) -> Dict[str, str]:
        """The children import this checkout's package, wherever the
        runner was started from."""
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH", "")) if p)
        return env

    def _node_args(self, i: int) -> List[str]:
        p = self.ports.of(i)
        d = os.path.join(self.base_dir, f"node{i}")
        args = [
            sys.executable, "-m", "babble_tpu_torch.cli", "run",
            "--datadir", d,
            "--node_addr", p["gossip"],
            "--proxy_addr", p["submit"],
            "--client_addr", p["commit"],
            "--service_addr", p["service"],
            "--heartbeat", str(self.heartbeat_ms),
            "--tcp_timeout", str(self.tcp_timeout_ms),
            "--cache_size", str(self.cache_size),
            "--log_level", "warning",
            "--device", self.device,
        ] + self.extra_node_args
        if i >= self.n:
            # joiner: founders-only epoch-0 validator set; observer
            # until its join tx's boundary admits it
            args += ["--bootstrap_peers",
                     os.path.join(d, "bootstrap_peers.json")]
        if self.byzantine:
            args.append("--byzantine")
        if self.checkpoints:
            args += ["--checkpoint_dir", os.path.join(d, "ckpt"),
                     "--checkpoint_interval",
                     str(CHECKPOINT_INTERVAL_S)]
        if self.wal:
            # batch fsync: a kill -9 may tear the final record, which
            # recovery truncates and the seq probe then covers
            args += ["--wal_dir", os.path.join(d, "wal"),
                     "--wal_fsync", "batch(32,50)"]
        if not self.aot:
            args.append("--no_aot_prewarm")
        if not self.with_clients:
            args.append("--no_client")
        return args

    def _spawn_node(self, i: int) -> subprocess.Popen:
        d = os.path.join(self.base_dir, f"node{i}")
        with open(os.path.join(d, "node.log"), "a") as log:
            proc = subprocess.Popen(
                self._node_args(i), env=self._env(), stdout=log,
                stderr=subprocess.STDOUT,
            )
        self.node_procs[i] = proc
        return proc

    def spawn_client(self, i: int) -> subprocess.Popen:
        """Start node i's dummy app (``cli dummy --quiet``), appending
        the committed transactions to <datadir>/messages.txt."""
        p = self.ports.of(i)
        d = os.path.join(self.base_dir, f"node{i}")
        with open(os.path.join(d, "dummy.log"), "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "babble_tpu_torch.cli", "dummy",
                 "--node_addr", p["submit"],
                 "--listen", p["commit"],
                 "--log", os.path.join(d, "messages.txt"),
                 "--quiet"],
                env=self._env(), stdin=subprocess.DEVNULL, stdout=log,
                stderr=subprocess.STDOUT,
            )
        self.client_procs[i] = proc
        self.procs.append(proc)
        return proc

    def spawn_joiner(self, i: int) -> None:
        """Boot joiner ``i`` (an index past the founding set) plus its
        dummy app when the fleet runs clients — the membership plane's
        live-churn runner calls this at the join op's scheduled tick."""
        if not (self.n <= i < self.n + self.joiners):
            raise ValueError(f"joiner index {i} outside "
                             f"[{self.n}, {self.n + self.joiners})")
        if i in self.node_procs:
            return
        self.procs.append(self._spawn_node(i))
        if self.with_clients:
            self.spawn_client(i)

    def kill_client(self, i: int) -> None:
        """Hard-stop node i's dummy app."""
        proc = self.client_procs.pop(i, None)
        if proc is None:
            return
        proc.kill()
        proc.wait(timeout=5)
        self.procs.remove(proc)

    def start(self) -> None:
        build_conf(self.base_dir, self.n, self.ports,
                   joiners=self.joiners)
        if "--jax_cache" not in self.extra_node_args:
            # one cache root for the whole fleet: every node records to
            # and prewarms from one shape manifest
            shared = os.path.join(self.base_dir, "jax_cache_shared")
            os.makedirs(shared, exist_ok=True)
            self.extra_node_args = list(self.extra_node_args) + [
                "--jax_cache", shared
            ]
        for i in range(self.n):
            self.procs.append(self._spawn_node(i))
            if self.with_clients:
                self.spawn_client(i)

    def kill_node(self, i: int) -> None:
        """Hard-stop node i's process (the chaos plane's crash fault;
        dummy clients stay up, like a real app surviving its node)."""
        proc = self.node_procs.pop(i, None)
        if proc is None:
            return
        proc.kill()
        try:
            proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            pass
        if proc in self.procs:
            self.procs.remove(proc)

    def restart_node(self, i: int) -> None:
        """Relaunch node i with its original arguments.  Its datadir
        (key + peers) survives, so the node rejoins under the same
        identity and catches up through gossip or fast-forward."""
        if i in self.node_procs:
            self.kill_node(i)
        self.procs.append(self._spawn_node(i))

    def stop(self) -> None:
        for p in self.procs:
            p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
        self.procs.clear()
        self.node_procs.clear()
        self.client_procs.clear()

    def __enter__(self) -> "TestnetRunner":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def fetch_stats(service_addr: str, timeout: float = 3.0) -> Dict[str, str]:
    with urllib.request.urlopen(
        f"http://{service_addr}/Stats", timeout=timeout
    ) as r:
        return json.load(r)


def fetch_metrics(service_addr: str, timeout: float = 3.0) -> str:
    """One node's Prometheus text exposition (service /metrics)."""
    with urllib.request.urlopen(
        f"http://{service_addr}/metrics", timeout=timeout
    ) as r:
        return r.read().decode("utf-8", errors="replace")


def fetch_spans(service_addr: str, timeout: float = 3.0) -> Dict:
    """One node's span-tracer dump (service /debug/spans: capacity,
    dropped, parent/child trees).  Loopback-gated by default — a
    non-local sweep gets a 403, which fleet.scrape_spans classifies as
    the distinct ``gated`` failure kind."""
    with urllib.request.urlopen(
        f"http://{service_addr}/debug/spans", timeout=timeout
    ) as r:
        return json.load(r)


def fetch_healthz(service_addr: str, timeout: float = 3.0) -> Dict:
    """One node's /healthz consensus-health verdict."""
    with urllib.request.urlopen(
        f"http://{service_addr}/healthz", timeout=timeout
    ) as r:
        return json.load(r)


def fetch_lineage(service_addr: str, txid: str,
                  timeout: float = 3.0) -> Dict:
    """One node's commit-lineage dump for ``txid`` (/debug/lineage —
    loopback-gated like the other /debug endpoints)."""
    with urllib.request.urlopen(
        f"http://{service_addr}/debug/lineage?tx={txid}", timeout=timeout
    ) as r:
        return json.load(r)


def fetch_flight(service_addr: str, timeout: float = 3.0) -> Dict:
    """One node's flight-recorder dump (/debug/flight, loopback-gated)."""
    with urllib.request.urlopen(
        f"http://{service_addr}/debug/flight", timeout=timeout
    ) as r:
        return json.load(r)


def watch_once(n: int, ports: Optional[PortLayout] = None) -> List[Dict[str, str]]:
    """One /Stats sweep across the fleet (reference docker/scripts/watch.sh)."""
    ports = ports or PortLayout()
    out = []
    for i in range(n):
        addr = ports.of(i)["service"]
        try:
            out.append(fetch_stats(addr))
        except (OSError, ValueError, HTTPException) as e:
            # ValueError covers a malformed JSON body, HTTPException a
            # garbage status line — one bad host must not crash the sweep
            out.append({"id": str(i), "error": str(e)})
    return out


def format_stats(rows: List[Dict[str, str]]) -> str:
    cols = ["id", "consensus_events", "consensus_transactions",
            "events_per_second", "rounds_per_second", "undetermined_events",
            "sync_rate"]
    widths = {c: max(len(c), *(len(str(r.get(c, "?"))) for r in rows))
              for c in cols}
    head = "  ".join(c.ljust(widths[c]) for c in cols)
    lines = [head, "-" * len(head)]
    for r in rows:
        if "error" in r:
            lines.append(f"{r['id'].ljust(widths['id'])}  <{r['error']}>")
        else:
            lines.append("  ".join(
                str(r.get(c, "?")).ljust(widths[c]) for c in cols
            ))
    return "\n".join(lines)


async def bombard(
    n: int, rate: float, duration: float,
    ports: Optional[PortLayout] = None, seed: int = 0,
) -> int:
    """Flood random transactions round-robin at ~`rate` tx/s total
    (reference docker/scripts/bombard.sh).  Returns the count submitted."""
    import random

    from .proxy.jsonrpc import JsonRpcClient, b64e

    ports = ports or PortLayout()
    rng = random.Random(seed)
    # generous timeout: a node may still be booting for its first syncs
    clients = [
        JsonRpcClient(ports.of(i)["submit"], timeout=15.0) for i in range(n)
    ]
    sent = 0
    attempt = 0
    t_end = time.monotonic() + duration
    try:
        while time.monotonic() < t_end:
            i = attempt % n
            attempt += 1
            payload = f"bomb-{sent}-{rng.getrandbits(32):08x}".encode()
            try:
                await clients[i].call("Babble.SubmitTx", b64e(payload))
                sent += 1
            except (OSError, RuntimeError, asyncio.TimeoutError):
                # node not up (yet), or busy and slow to answer
                # — move on to the next one (an escaping TimeoutError
                # used to kill the whole bombard thread)
                await asyncio.sleep(0.05)
                continue
            await asyncio.sleep(1.0 / rate)
    finally:
        for c in clients:
            await c.close()
    return sent


async def bombard_many(
    n: int, clients: int = 16, rate: float = 1000.0, duration: float = 10.0,
    ports: Optional[PortLayout] = None, seed: int = 0, tx_bytes: int = 32,
    batch: int = 1,
) -> Dict[str, int]:
    """The many-client bombard harness: ``clients`` concurrent
    JSON-RPC connections — each its own TCP connection, hence its own
    admission-control fairness identity — spread round-robin over the
    fleet, together targeting ~``rate`` tx/s.  ``batch`` > 1 submits
    through ``Babble.SubmitTxBatch`` (one round trip per batch — a
    single connection's rate is RTT-bound otherwise).  Clients handle
    the structured ``overloaded`` shed the front door is contracted to
    return: they back off ``retry_after_ms``, resubmitting only what
    the error's ``admitted`` count says was refused — so the harness
    measures sustained admitted throughput, not a queue filling once.
    Returns {"sent", "shed", "errors", "clients"}."""
    from .proxy.admission import OverloadedError
    from .proxy.jsonrpc import JsonRpcClient, b64e

    ports = ports or PortLayout()
    counts = {"sent": 0, "shed": 0, "errors": 0, "clients": clients}
    t_end = time.monotonic() + duration
    per_client = max(rate / max(clients, 1), 0.001)
    batch = max(1, batch)

    async def one_client(ci: int) -> None:
        import random

        rng = random.Random((seed << 16) ^ ci)
        node = ci % n
        client = JsonRpcClient(ports.of(node)["submit"], timeout=15.0)
        pad = "x" * max(tx_bytes - 24, 0)
        seq = 0
        pending: list = []
        try:
            while time.monotonic() < t_end:
                while len(pending) < batch:
                    pending.append(
                        f"bomb{ci}-{seq}-"
                        f"{rng.getrandbits(32):08x}{pad}".encode()
                    )
                    seq += 1
                try:
                    if batch == 1:
                        await client.call(
                            "Babble.SubmitTx", b64e(pending[0])
                        )
                        counts["sent"] += 1
                        pending.clear()
                    else:
                        await client.call(
                            "Babble.SubmitTxBatch",
                            [b64e(p) for p in pending],
                        )
                        counts["sent"] += len(pending)
                        pending.clear()
                except OverloadedError as e:
                    counts["sent"] += e.admitted
                    counts["shed"] += len(pending) - e.admitted
                    del pending[: e.admitted]
                    await asyncio.sleep(e.retry_after_ms / 1000.0)
                    continue
                except (OSError, RuntimeError):
                    counts["errors"] += 1
                    pending.clear()     # unknown fate: don't double-send
                    await asyncio.sleep(0.05)
                    continue
                await asyncio.sleep(batch / per_client)
        finally:
            await client.close()

    await asyncio.gather(*(one_client(ci) for ci in range(clients)))
    return counts
