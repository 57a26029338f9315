"""The port's fleet tools (``babble_tpu_torch/fleet.py``) and their verbs
(``cli fleet ...``, ``cli testnet health|trace``), held to the JAX
package's on the CPU.

- the conf layout: the same datadirs, one shared ``peers.json`` against
  the hosts' addresses, the same deploy scripts with the package
  renamed, keys kept across re-runs of either package's conf;
- the sweeps (``watch_hosts``, ``scrape_hosts``, ``scrape_spans``) give
  JAX's rows on the same stub hosts: ok, malformed, gated, unreachable;
- ``parse_exposition``, ``rollup_metrics``, ``format_rollup``,
  ``health_divergence`` and ``format_health`` give JAX's values on the
  same inputs (``tests/test_fleet.py``, ``tests/test_health_flight.py``);
- a live 3-node port fleet with its HTTP services: ``trace_tx`` stitches
  one marked transaction across the nodes (``tests/test_lineage.py``),
  and the port's and JAX's ``fleet health|trace`` verbs read it alike;
- a mixed fleet (port and JAX nodes, each with its own package's
  service) swept by the port's tools.
"""

import asyncio
import contextlib
import io
import json
import os
import stat
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from babble_tpu import cli as jcli
from babble_tpu import fleet as jfl
from babble_tpu.crypto import keys as jkeys
from babble_tpu.net import Peer as JPeer
from babble_tpu.node import Config as JConfig
from babble_tpu.node import Node as JNode
from babble_tpu.proxy.inmem import InmemAppProxy as JProxy
from babble_tpu.service.service import Service as JService

from babble_tpu_torch import cli as pcli
from babble_tpu_torch import fleet as pfl
from babble_tpu_torch.crypto import keys as pkeys
from babble_tpu_torch.net import InmemNetwork, Peer
from babble_tpu_torch.node import Config, Node
from babble_tpu_torch.obs import tx_id
from babble_tpu_torch.obs.lineage import format_trace, stitch
from babble_tpu_torch.proxy import InmemAppProxy
from babble_tpu_torch.service.service import Service

from .torch_bridge import BridgeNetwork

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ----------------------------------------------------------------------
# conf and deploy scripts


def _tree(base):
    return sorted(os.path.relpath(os.path.join(r, f), base)
                  for r, _d, fs in os.walk(base) for f in fs)


def _addrs(datadir):
    with open(os.path.join(datadir, "peers.json")) as f:
        return [p["NetAddr"] for p in json.load(f)]


def test_fleet_conf_and_scripts_equal_jax(tmp_path):
    """Per-host datadirs with one shared peers.json against the hosts'
    gossip addresses, and the push/start/stop scripts, makefile and
    hosts.txt of JAX's conf, with the package renamed."""
    hosts = ["10.0.1.10", "10.0.1.11", "10.0.1.12", "10.0.1.13"]
    out = {}
    for name, fl in (("torch", pfl), ("jax", jfl)):
        base = str(tmp_path / name)
        layout = fl.HostLayout(hosts, gossip_port=7000)
        dirs = fl.build_fleet_conf(os.path.join(base, "conf"), layout)
        files = fl.write_deploy_scripts(base, layout)
        assert [os.path.relpath(d, base) for d in dirs] == [
            f"conf/node{i}" for i in range(4)]
        assert [os.path.relpath(f, base) for f in files] == [
            "start.sh", "stop.sh", "push.sh", "makefile", "hosts.txt"]
        peer_sets = set()
        for d in dirs:
            with open(os.path.join(d, "peers.json")) as f:
                peer_sets.add(f.read())
            assert sorted(_addrs(d)) == [f"{h}:7000" for h in hosts]
        assert len(peer_sets) == 1
        for script in ("start.sh", "stop.sh", "push.sh"):
            mode = os.stat(os.path.join(base, script)).st_mode
            assert mode & stat.S_IEXEC, script
        texts = {}
        for f in files:
            with open(f) as fh:
                texts[os.path.basename(f)] = fh.read()
        out[name] = (_tree(base), texts)
    (ptree, ptexts), (jtree, jtexts) = out["torch"], out["jax"]
    assert ptree == jtree
    assert "babble_tpu_torch.cli run" in ptexts["start.sh"]
    assert "__" not in ptexts["start.sh"]
    for name, text in ptexts.items():
        assert text.replace("babble_tpu_torch", "babble_tpu") == \
            jtexts[name], name


def test_fleet_conf_keeps_keys_across_packages(tmp_path):
    """Re-running conf keeps the existing keys (peers.json unchanged),
    whichever package wrote them first: the PEM files are the same
    bytes."""
    hosts = ["192.168.0.1", "192.168.0.2", "192.168.0.3"]
    for first, second in ((jfl, pfl), (pfl, jfl), (pfl, pfl)):
        base = str(tmp_path / f"{first.__name__}-{second.__name__}")
        first.build_fleet_conf(base, first.HostLayout(hosts))
        with open(os.path.join(base, "node0", "peers.json")) as f:
            before = f.read()
        second.build_fleet_conf(base, second.HostLayout(hosts))
        with open(os.path.join(base, "node0", "peers.json")) as f:
            assert f.read() == before


# ----------------------------------------------------------------------
# the sweeps against stub hosts (tests/test_fleet.py)

_METRICS_TEXT = (
    "# HELP babble_sync_requests_total syncs\n"
    "# TYPE babble_sync_requests_total counter\n"
    "babble_sync_requests_total 3\n"
)
_SPANS_BODY = json.dumps({
    "capacity": 1024, "dropped": 0,
    "trees": [{"name": "gossip", "id": 1, "parent": None,
               "start": 0.0, "dur_s": 0.01, "children": []}],
}).encode()


class _Stub(BaseHTTPRequestHandler):
    """A fleet host: valid /metrics and /debug/spans, a GARBAGE /Stats
    body, 404 elsewhere."""

    def do_GET(self):
        bodies = {"/metrics": (_METRICS_TEXT.encode(), "text/plain"),
                  "/Stats": (b"<html>not json</html>", "application/json"),
                  "/debug/spans": (_SPANS_BODY, "application/json")}
        if self.path not in bodies:
            self.send_error(404)
            return
        body, ctype = bodies[self.path]
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


class _NoSpansStub(_Stub):
    """Valid /metrics, a 404 for /debug/spans (a host without spans)."""

    def do_GET(self):
        if self.path == "/debug/spans":
            self.send_error(404)
            return
        super().do_GET()


class _ErrorStub(BaseHTTPRequestHandler):
    """A host that answers with an HTTP error (a 500ing service)."""

    def do_GET(self):
        self.send_error(500)

    def log_message(self, *a):
        pass


class _GatedStub(_ErrorStub):
    """A loopback-gated host: /debug/* answers 403."""

    def do_GET(self):
        self.send_error(403, "debug endpoints are loopback-only")


@contextlib.contextmanager
def _stub(handler):
    srv = HTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield srv.server_port
    finally:
        srv.shutdown()
        srv.server_close()


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("sweep,handler,kind", [
    ("watch_hosts", _Stub, "malformed"),
    ("watch_hosts", _ErrorStub, "malformed"),
    ("watch_hosts", None, "unreachable"),
    ("scrape_hosts", _Stub, None),
    ("scrape_hosts", _ErrorStub, "malformed"),
    ("scrape_hosts", None, "unreachable"),
    ("scrape_spans", _Stub, None),
    ("scrape_spans", _GatedStub, "gated"),
    ("scrape_spans", None, "unreachable"),
    ("health_hosts", _ErrorStub, "malformed"),
])
def test_sweeps_classify_hosts_as_jax_does(sweep, handler, kind):
    """'host down' (unreachable), 'host answered garbage or an HTTP
    error' (malformed) and 'host declined by policy' (gated, a 403) are
    told apart, row for row as the JAX package's sweep."""
    with (_stub(handler) if handler else contextlib.nullcontext(
            _free_port())) as port:
        rows = [getattr(fl, sweep)(fl.HostLayout(["127.0.0.1", "127.0.0.1"],
                                                 service_port=port))
                for fl in (pfl, jfl)]
    assert rows[0] == rows[1]
    assert len(rows[0]) == 2
    for row in rows[0]:
        assert row.get("kind") == kind, row
    if sweep == "scrape_hosts" and kind is None:
        assert rows[0][0]["metrics"] == _METRICS_TEXT
    if sweep == "scrape_spans" and kind is None:
        assert rows[0][0]["spans"]["trees"][0]["name"] == "gossip"
    if kind == "gated":
        assert "403" in rows[0][0]["error"]


def _cli(pkg, *argv):
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.cli", *argv], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)


@pytest.mark.parametrize("handler,mode,rc", [
    (_NoSpansStub, "--spans", 1),
    (_Stub, "--spans", 0),
    (_Stub, "--json", 0),
    (_Stub, "--rollup", 0),
])
def test_fleet_scrape_verb_equals_jax(tmp_path, handler, mode, rc):
    """`fleet scrape` through both clis as ``python -m`` runs them: the
    same stdout and exit code (--spans: a host 404ing its spans fails
    the sweep, a gated one would not; --rollup: counters summed over
    the hosts, whose missing /healthz leaves no divergence)."""
    hosts = tmp_path / "hosts.txt"
    hosts.write_text("127.0.0.1\nlocalhost\n")
    with _stub(handler) as port:
        argv = ("fleet", "scrape", "--hosts", str(hosts), "--service_port",
                str(port), mode)
        port_run, jax_run = _cli("babble_tpu_torch", *argv), _cli(
            "babble_tpu", *argv)
    assert (port_run.returncode, port_run.stdout) == (
        jax_run.returncode, jax_run.stdout)
    if mode == "--rollup":
        assert "# fleet rollup over 2 hosts" in port_run.stdout
        assert "babble_sync_requests_total 6" in port_run.stdout
    else:
        rows = json.loads(port_run.stdout)
        assert [r["metrics"] for r in rows] == [_METRICS_TEXT] * 2
    assert port_run.returncode == rc, port_run.stderr[-2000:]


# ----------------------------------------------------------------------
# the pure functions (tests/test_health_flight.py's fleet cases)


def _health_row(host, **kw):
    h = {"status": "ok", "epoch": 0, "lcr": 10, "commit_length": 50,
         "digest": "d0", "round_advance_rate": 1.0, "quorum_margin": 1,
         "commit_slo_burn": 0.0, "reasons": [], "behind_horizon": []}
    h.update(kw)
    return {"host": host, "health": h}


_HEALTH_CASES = {
    "epoch-and-digest": [_health_row("a:1"), _health_row("b:1", epoch=1),
                         _health_row("c:1", digest="d-FORGED")],
    "lcr-lag": [_health_row("a:1", lcr=100), _health_row("b:1", lcr=10)],
    "clean": [_health_row("a:1"), _health_row("b:1")],
    "degraded-and-down": [
        _health_row("a:1", status="degraded", reasons=["probe_armed"],
                    behind_horizon=[2, 3], commit_slo_burn=1.5),
        {"host": "b:1", "error": "refused", "kind": "unreachable"},
        _health_row("c:1", commit_length=51, digest="d1")],
    "all-down": [{"host": "a:1", "error": "x", "kind": "malformed"}],
}


@pytest.mark.parametrize("case", sorted(_HEALTH_CASES))
def test_health_divergence_and_table_equal_jax(case):
    rows = _HEALTH_CASES[case]
    div = pfl.health_divergence(rows)
    assert div == jfl.health_divergence(rows)
    assert pfl.format_health(rows, div) == jfl.format_health(rows, div)
    kinds = [d["kind"] for d in div]
    if case == "epoch-and-digest":
        dig = next(d for d in div if d["kind"] == "digest")
        assert "epoch" in kinds and dig["position"] == 50
        assert "FLEET DIVERGENCE" in pfl.format_health(rows, div)
    if case == "lcr-lag":
        assert kinds == ["lcr_lag"] and div[0]["severity"] == "warning"
    if case == "clean":
        assert div == [] and "no cross-node divergence" in \
            pfl.format_health(rows, div)


def _blob(epoch, txs, depth):
    return (
        "# TYPE babble_epoch gauge\n"
        f"babble_epoch {epoch}\n"
        "# TYPE babble_commit_tx_total counter\n"
        f"babble_commit_tx_total {txs}\n"
        "# TYPE babble_ingress_queue_depth gauge\n"
        f"babble_ingress_queue_depth {depth}\n"
        "# TYPE babble_flush_seconds histogram\n"
        'babble_flush_seconds_bucket{kernel="latency",le="+Inf"} 4\n'
        'babble_flush_seconds_count{kernel="latency"} 4\n'
    )


_ROLLUP_CASES = {
    "split-epoch": [{"host": "a:1", "metrics": _blob(0, 100, 5)},
                    {"host": "b:1", "metrics": _blob(1, 50, 9)},
                    {"host": "c:1", "error": "boom", "kind": "unreachable"}],
    "agreeing": [{"host": "a:1", "metrics": _blob(2, 7, 1)},
                 {"host": "b:1", "metrics": _blob(2, 8, 3)}],
    "odd-lines": [{"host": "a:1", "metrics": (
        "# HELP x y\n# TYPE g gauge\n\ng NaN\nbad line here\n"
        "h_sum 2.5\nh_count 1\n# TYPE h histogram\nnovalue\n")}],
}


@pytest.mark.parametrize("case", sorted(_ROLLUP_CASES))
def test_rollup_and_exposition_equal_jax(case):
    rows = _ROLLUP_CASES[case]
    for row in rows:
        if "metrics" in row:
            # repr: a NaN sample equals itself only as text
            assert repr(pfl.parse_exposition(row["metrics"])) == \
                repr(jfl.parse_exposition(row["metrics"]))
    r = pfl.rollup_metrics(rows)
    j = jfl.rollup_metrics(rows)
    assert json.dumps(r, sort_keys=True) == json.dumps(j, sort_keys=True)
    assert pfl.format_rollup(r) == jfl.format_rollup(j)
    if case == "split-epoch":
        assert r["series"]["babble_commit_tx_total"]["sum"] == 150
        assert r["series"]["babble_ingress_queue_depth"]["max"] == 9
        assert r["unparsed"] == ["c:1"]
        assert [d["series"] for d in r["divergence"]] == ["babble_epoch"]
        text = pfl.format_rollup(r)
        assert "FLEET DIVERGENCE" in text
        assert "babble_ingress_queue_depth sum=14 max=9" in text
    if case == "agreeing":
        assert r["divergence"] == []


def test_host_port_entries_are_for_the_read_only_sweeps(tmp_path):
    """'host:service_port' entries name service endpoints: the layout
    says so, and both clis refuse them for conf and bombard with the
    same words."""
    for fl in (pfl, jfl):
        assert fl.HostLayout(["127.0.0.1:15000"]).explicit_service_ports()
        assert not fl.HostLayout(["10.0.0.1"]).explicit_service_ports()
        assert fl.HostLayout(["127.0.0.1:15003"]).of(0) == {
            "gossip": "127.0.0.1:1337", "submit": "127.0.0.1:1338",
            "commit": "127.0.0.1:1339", "service": "127.0.0.1:15003"}
    hosts = tmp_path / "hosts.txt"
    hosts.write_text("127.0.0.1:15000\n")
    for verb in ("conf", "bombard"):
        argv = ["fleet", verb, "--hosts", str(hosts), "--dir",
                str(tmp_path / "d")]
        errs = []
        for cli in (pcli, jcli):
            with pytest.raises(SystemExit) as e:
                cli.main(argv)
            errs.append(str(e.value))
        assert errs[0] == errs[1] and f"not '{verb}'" in errs[0]
    assert not (tmp_path / "d").exists()


def test_empty_stitch_equals_jax():
    """A txid nobody recorded stitches to an empty timeline (the trace
    verbs exit 1 on it)."""
    from babble_tpu.obs import stitch as jstitch

    dumps = [{"node": "A", "boot": 0.0, "txid": "nope", "tx": [],
              "events": {}}]
    assert stitch(dumps) == jstitch(dumps)
    assert stitch(dumps)["timeline"] == []


# ----------------------------------------------------------------------
# live fleets


def _run_verb(cli, argv):
    """One cli call in this process: (exit code, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    return rc, out.getvalue()


async def _serve_and_sweep(nodes, proxies, services, marked, sweep):
    for nd in nodes:
        nd.init()
        nd.run_task(gossip=True)
    for svc in services:
        await svc.start()
    try:
        await proxies[0].submit_tx(marked)

        async def committed_everywhere():
            while not all(marked in p.committed_transactions()
                          for p in proxies):
                await asyncio.sleep(0.05)

        await asyncio.wait_for(committed_everywhere(), 90.0)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, sweep, [svc.bind_addr for svc in services])
    finally:
        for svc in services:
            await svc.close()
        for nd in nodes:
            await nd.shutdown()


def _check_trace(st, n_nodes):
    assert not st["errors"], st["errors"]
    assert len(st["nodes"]) == n_nodes, st["nodes"]
    for stage in ("pool", "mint", "commit", "deliver"):
        assert stage in st["stages"], st["stages"]
    assert st["attribution"], "no latency attribution hops"
    assert st["timeline"] == sorted(st["timeline"], key=lambda r: r["wall"])
    assert "latency attribution" in format_trace(st)


def _check_health(out):
    doc = json.loads(out)
    assert [r.get("kind") for r in doc["nodes"]] == [None] * 3, doc
    assert not any(d["severity"] == "error" for d in doc["divergence"])
    ok = all(r["health"]["status"] == "ok" for r in doc["nodes"])
    return doc, ok


def test_fleet_trace_and_health_of_a_live_port_fleet(tmp_path):
    """Three port Nodes with their HTTP services commit a marked tx:
    ``trace_tx`` stitches one timeline over all three (pool, mint,
    commit, deliver, with latency attribution), and the port's and the
    JAX package's ``fleet trace|health`` verbs read the fleet alike."""
    marked = b"marked-trace-tx"
    hosts = tmp_path / "hosts.txt"

    def sweep(addrs):
        hosts.write_text("\n".join(addrs) + "\n")
        st = pfl.trace_tx(pfl.HostLayout(addrs), tx_id(marked))
        verbs = {}
        for name, cli in (("torch", pcli), ("jax", jcli)):
            verbs[name] = {
                "trace": _run_verb(cli, ["fleet", "trace", tx_id(marked),
                                         "--hosts", str(hosts), "--json"]),
                "unknown": _run_verb(cli, ["fleet", "trace", "ab" * 32,
                                           "--hosts", str(hosts)]),
                "health": _run_verb(cli, ["fleet", "health", "--hosts",
                                          str(hosts), "--json"]),
            }
        return st, verbs

    async def go():
        net = InmemNetwork()
        keys = sorted([pkeys.key_from_scalar(61 + i) for i in range(3)],
                      key=lambda k: k.pub_hex)
        ts = [net.transport() for _ in keys]
        peers = [Peer(t.local_addr(), k.pub_hex) for t, k in zip(ts, keys)]
        proxies = [InmemAppProxy() for _ in keys]
        nodes = [Node(Config.test_config(heartbeat=0.01, device="cpu"),
                      keys[i], peers, ts[i], proxies[i]) for i in range(3)]
        services = [Service("127.0.0.1:0", nd) for nd in nodes]
        return await _serve_and_sweep(nodes, proxies, services, marked,
                                      sweep)

    st, verbs = asyncio.run(go())
    _check_trace(st, 3)
    for name in ("torch", "jax"):
        rc, out = verbs[name]["trace"]
        assert rc == 0 and json.loads(out)["txid"] == tx_id(marked), name
        _check_trace(json.loads(out), 3)
        assert verbs[name]["unknown"][0] == 1, name
        rc, out = verbs[name]["health"]
        doc, ok = _check_health(out)
        assert rc == (0 if ok else 1), (name, doc)
    health = [json.loads(verbs[n]["health"][1]) for n in ("torch", "jax")]
    assert [sorted(r["health"]) for r in health[0]["nodes"]] == \
        [sorted(r["health"]) for r in health[1]["nodes"]]
    assert verbs["torch"]["unknown"][1] == verbs["jax"]["unknown"][1]


def test_port_tools_sweep_a_mixed_fleet():
    """Port, JAX and port Nodes on one bridge network, each serving its
    own package's service: the port's ``trace_tx`` stitches the marked
    tx across all three and its health sweep reads every node with no
    error-severity divergence."""
    marked = b"mixed-fleet-tx"
    kinds = ["torch", "jax", "torch"]

    def sweep(addrs):
        layout = pfl.HostLayout(addrs)
        rows = pfl.health_hosts(layout)
        return pfl.trace_tx(layout, tx_id(marked)), rows

    async def go():
        net = BridgeNetwork()
        scalars = [71, 72, 73]
        ts = [net.transport(f"inmem://{i}", k) for i, k in enumerate(kinds)]
        pubs = [pkeys.key_from_scalar(s).pub_hex for s in scalars]
        nodes, proxies, services = [], [], []
        for i, kind in enumerate(kinds):
            if kind == "torch":
                proxies.append(InmemAppProxy())
                nodes.append(Node(
                    Config.test_config(heartbeat=0.01, device="cpu"),
                    pkeys.key_from_scalar(scalars[i]),
                    [Peer(t.local_addr(), p) for t, p in zip(ts, pubs)],
                    ts[i], proxies[-1]))
                services.append(Service("127.0.0.1:0", nodes[-1]))
            else:
                proxies.append(JProxy())
                nodes.append(JNode(
                    JConfig.test_config(heartbeat=0.01),
                    jkeys.key_from_scalar(scalars[i]),
                    [JPeer(t.local_addr(), p) for t, p in zip(ts, pubs)],
                    ts[i], proxies[-1]))
                services.append(JService("127.0.0.1:0", nodes[-1]))
        return await _serve_and_sweep(nodes, proxies, services, marked,
                                      sweep)

    st, rows = asyncio.run(go())
    _check_trace(st, 3)
    assert all("health" in r for r in rows), rows
    assert not any(d["severity"] == "error"
                   for d in pfl.health_divergence(rows))
    assert pfl.health_divergence(rows) == jfl.health_divergence(rows)
    assert {r["health"]["epoch"] for r in rows} == {0}
