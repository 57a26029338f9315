"""Multi-host fleet ops — the port's copy of the JAX package's
``fleet.py``: the cloud/terraform workflow, rebuilt as code.

The reference drives cloud testnets with Terraform plus ssh shell
(reference terraform/makefile:1-34, terraform/scripts/build-conf.sh,
remote-run.sh, remote-kill.sh, watch.sh, bombard.sh): provision hosts,
generate per-node datadirs against the hosts' private IPs, push, start
over ssh, watch /Stats, bombard.  Provisioning belongs to whatever IaC
the operator runs; everything after the host list exists is here:

- ``build_fleet_conf`` — datadirs keyed to real host addresses
  (terraform/scripts/build-conf.sh)
- ``write_deploy_scripts`` — push/start/stop ssh scripts + a makefile
  mirroring the reference verbs (remote-run.sh / remote-kill.sh /
  makefile)
- ``watch_hosts`` / ``bombard_hosts`` — the fleet-wide /Stats sweep and
  transaction flood against arbitrary addresses (watch.sh / bombard.sh)

``python -m babble_tpu_torch.cli fleet`` fronts all of it.  The
single-host subprocess variant lives in testnet.py.
"""

from __future__ import annotations

import os
import stat
import urllib.error
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .crypto.keys import PemKeyFile, generate_key
from .net.peers import JSONPeers, Peer
from .testnet import (
    HTTPException,
    fetch_healthz,
    fetch_lineage,
    fetch_metrics,
    fetch_spans,
    fetch_stats,
)

GOSSIP_PORT = 1337   # the reference's conventional ports
SUBMIT_PORT = 1338   # (terraform/scripts/remote-run.sh:12-19)
COMMIT_PORT = 1339
SERVICE_PORT = 8080


@dataclass
class HostLayout:
    """One node per host, reference port conventions."""

    hosts: List[str]                 # routable addresses, one per node
    gossip_port: int = GOSSIP_PORT
    submit_port: int = SUBMIT_PORT
    commit_port: int = COMMIT_PORT
    service_port: int = SERVICE_PORT

    def explicit_service_ports(self) -> bool:
        """True when any host entry carries an explicit service port —
        valid only for the read-only sweeps (watch/scrape/trace/
        health); the write verbs (conf/bombard) would silently target
        every node at one shared default port."""
        return any(":" in h for h in self.hosts)

    def of(self, i: int) -> Dict[str, str]:
        h = self.hosts[i]
        if ":" in h:
            # an explicit "host:port" entry names the node's SERVICE
            # endpoint directly — the same-host-testnet case, where
            # every node shares one address but not one port (the
            # read-only sweeps: watch/scrape/trace/health).  The
            # gossip/submit/commit ports keep the layout defaults.
            host, _, svc = h.rpartition(":")
            return {
                "gossip": f"{host}:{self.gossip_port}",
                "submit": f"{host}:{self.submit_port}",
                "commit": f"{host}:{self.commit_port}",
                "service": f"{host}:{svc}",
            }
        return {
            "gossip": f"{h}:{self.gossip_port}",
            "submit": f"{h}:{self.submit_port}",
            "commit": f"{h}:{self.commit_port}",
            "service": f"{h}:{self.service_port}",
        }


def build_fleet_conf(base_dir: str, layout: HostLayout) -> List[str]:
    """Per-host datadirs (key + shared peers.json) against the hosts'
    routable addresses (terraform/scripts/build-conf.sh)."""
    datadirs = []
    keys = []
    for i, _ in enumerate(layout.hosts):
        d = os.path.join(base_dir, f"node{i}")
        os.makedirs(d, exist_ok=True)
        pem = PemKeyFile(d)
        keys.append(pem.read() if pem.exists() else generate_key())
        if not pem.exists():
            pem.write(keys[-1])
        datadirs.append(d)
    peers = [
        Peer(net_addr=layout.of(i)["gossip"], pub_key_hex=keys[i].pub_hex)
        for i in range(len(layout.hosts))
    ]
    for d in datadirs:
        JSONPeers(d).set_peers(peers)
    return datadirs


_START_SH = """#!/bin/bash
# start node $2 on host $1 (terraform/scripts/remote-run.sh analogue)
set -eu
host=$1; i=$2
ssh ${SSH_OPTS:-} "${SSH_USER:-$USER}@${host}" <<-EOF
    cd __REMOTE_DIR__
    nohup __PYTHON__ -m babble_tpu_torch.cli run \\
        --datadir conf/node${i} \\
        --node_addr ${host}:__GOSSIP__ \\
        --proxy_addr 0.0.0.0:__SUBMIT__ \\
        --client_addr ${host}:__COMMIT__ \\
        --service_addr 0.0.0.0:__SERVICE__ \\
        --heartbeat __HEARTBEAT__ --tcp_timeout __TCP_TIMEOUT__ \\
        --cache_size __CACHE__ --seq_window __SEQ_WINDOW__ \\
        --consensus_interval __CONSENSUS_INTERVAL__ \\
        --no_client --log_level warning \\
        > node${i}.log 2>&1 &
EOF
"""

_STOP_SH = """#!/bin/bash
# stop the node on host $1 (terraform/scripts/remote-kill.sh analogue)
set -eu
host=$1
ssh ${SSH_OPTS:-} "${SSH_USER:-$USER}@${host}" \\
    "pkill -f 'babble_tpu_torch.cli run' || true"
"""

_PUSH_SH = """#!/bin/bash
# ship the package + this node's conf to host $1 (index $2)
set -eu
host=$1; i=$2
ssh ${SSH_OPTS:-} "${SSH_USER:-$USER}@${host}" "mkdir -p __REMOTE_DIR__/conf"
scp ${SSH_OPTS:-} -r __PACKAGE_DIR__ \\
    "${SSH_USER:-$USER}@${host}:__REMOTE_DIR__/babble_tpu_torch"
scp ${SSH_OPTS:-} -r conf/node${i} \\
    "${SSH_USER:-$USER}@${host}:__REMOTE_DIR__/conf/"
"""

_MAKEFILE = """# fleet driver (reference terraform/makefile verbs)
HOSTS ?= hosts.txt

conf:
\t__PYTHON__ -m babble_tpu_torch.cli fleet conf --hosts $(HOSTS) --dir .

push:
\tawk '{system("./push.sh "$$1" "NR-1)}' $(HOSTS)

start:
\tawk '{system("./start.sh "$$1" "NR-1)}' $(HOSTS)

watch:
\t__PYTHON__ -m babble_tpu_torch.cli fleet watch --hosts $(HOSTS)

scrape:
\t__PYTHON__ -m babble_tpu_torch.cli fleet scrape --hosts $(HOSTS)

bombard:
\t__PYTHON__ -m babble_tpu_torch.cli fleet bombard --hosts $(HOSTS) --rate 100 --duration 10

stop:
\tawk '{system("./stop.sh "$$1)}' $(HOSTS)
"""


def write_deploy_scripts(
    base_dir: str,
    layout: HostLayout,
    remote_dir: str = "~/babble-tpu",
    python: str = "python3",
    heartbeat_ms: int = 50,
    tcp_timeout_ms: int = 1000,
    cache_size: int = 4096,
    seq_window: int = 256,
    consensus_interval_ms: int = 250,
) -> List[str]:
    """Emit push/start/stop ssh scripts + the makefile driver.  Knob
    defaults follow the reference's cloud profile (heartbeat=50ms,
    remote-run.sh) with this framework's window/cadence settings."""
    subst = {
        "__REMOTE_DIR__": remote_dir, "__PYTHON__": python,
        "__GOSSIP__": str(layout.gossip_port),
        "__SUBMIT__": str(layout.submit_port),
        "__COMMIT__": str(layout.commit_port),
        "__SERVICE__": str(layout.service_port),
        "__HEARTBEAT__": str(heartbeat_ms),
        "__TCP_TIMEOUT__": str(tcp_timeout_ms),
        "__CACHE__": str(cache_size), "__SEQ_WINDOW__": str(seq_window),
        "__CONSENSUS_INTERVAL__": str(consensus_interval_ms),
        "__PACKAGE_DIR__": os.path.dirname(os.path.abspath(__file__)),
    }
    out = []
    for name, tpl in (
        ("start.sh", _START_SH), ("stop.sh", _STOP_SH),
        ("push.sh", _PUSH_SH), ("makefile", _MAKEFILE),
    ):
        path = os.path.join(base_dir, name)
        body = tpl
        for token, value in subst.items():
            body = body.replace(token, value)
        with open(path, "w") as f:
            f.write(body)
        if name.endswith(".sh"):
            os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
        out.append(path)
    with open(os.path.join(base_dir, "hosts.txt"), "w") as f:
        f.write("\n".join(layout.hosts) + "\n")
    out.append(os.path.join(base_dir, "hosts.txt"))
    return out


def _sweep(layout: HostLayout,
           fetch: Callable[[str], object],
           ) -> List[Tuple[int, str, object, Optional[str], str]]:
    """One ``fetch(service_addr)`` per host; one bad host must not crash
    the sweep.  "The host is down" and "the host answered garbage" are
    different operator problems — the first is networking/provisioning,
    the second a broken, outdated or misbound service — so every failure
    is classified once, here, for both the /Stats and /metrics sweeps:

    - ``urllib.error.HTTPError`` 403: the host answered and *declined
      by policy* (the /debug endpoints are loopback-gated unless the
      node ran with --allow_remote_debug) — ``gated``, a configuration
      statement, not a fault;
    - any other ``urllib.error.HTTPError`` (a 404 from a pre-telemetry
      binary, a 500ing service): something ANSWERED — ``malformed``,
      despite HTTPError being an OSError subclass;
    - ``ValueError`` (json.JSONDecodeError) / ``HTTPException`` (garbage
      status line): answered, but not the expected body — ``malformed``;
    - any other ``OSError`` (connect refused / timeout / DNS): nothing
      answered — ``unreachable``.

    Yields ``(index, addr, result, kind, error)`` rows; ``kind`` is
    ``None`` on success."""
    rows = []
    for i in range(len(layout.hosts)):
        addr = layout.of(i)["service"]
        try:
            rows.append((i, addr, fetch(addr), None, ""))
        except urllib.error.HTTPError as e:
            kind = "gated" if e.code == 403 else "malformed"
            rows.append((i, addr, None, kind, str(e)))
        except (ValueError, HTTPException) as e:
            rows.append((i, addr, None, "malformed", str(e)))
        except OSError as e:
            rows.append((i, addr, None, "unreachable", str(e)))
    return rows


def watch_hosts(layout: HostLayout) -> List[Dict[str, str]]:
    """One /Stats sweep across the hosts (terraform/scripts/watch.sh).
    Failure rows carry the :func:`_sweep` ``kind`` (``unreachable`` vs
    ``malformed``) plus the probed address."""
    rows = []
    for i, addr, stats, kind, err in _sweep(layout, fetch_stats):
        if kind is None:
            rows.append(stats)
        else:
            rows.append({"id": str(i), "host": addr, "error": err,
                         "kind": kind})
    return rows


def scrape_hosts(layout: HostLayout,
                 timeout: float = 3.0) -> List[Dict[str, str]]:
    """Fleet-wide /metrics sweep: one Prometheus text blob per host
    (the fleet-scale close of the telemetry loop).  Rows are
    ``{"host", "metrics"}`` on success, ``{"host", "error", "kind"}``
    on failure with the same unreachable/malformed split as
    :func:`watch_hosts`."""
    rows = []
    for _i, addr, text, kind, err in _sweep(
            layout, lambda a: fetch_metrics(a, timeout=timeout)):
        if kind is None:
            rows.append({"host": addr, "metrics": text})
        else:
            rows.append({"host": addr, "error": err, "kind": kind})
    return rows


def scrape_spans(layout: HostLayout,
                 timeout: float = 3.0) -> List[Dict[str, object]]:
    """Fleet-wide /debug/spans sweep (span dumps shipped in the fleet
    sweep, not per-node loopback only).  Rows are ``{"host", "spans"}``
    on success; failures carry the :func:`_sweep` kind, where a 403 from
    a loopback-gated host is the distinct ``gated`` kind (expected
    policy, not an outage) rather than ``unreachable``."""
    rows = []
    for _i, addr, spans, kind, err in _sweep(
            layout, lambda a: fetch_spans(a, timeout=timeout)):
        if kind is None:
            rows.append({"host": addr, "spans": spans})
        else:
            rows.append({"host": addr, "error": err, "kind": kind})
    return rows


# ----------------------------------------------------------------------
# consensus-health plane: /healthz sweep + divergence


def health_hosts(layout: HostLayout,
                 timeout: float = 3.0) -> List[Dict[str, object]]:
    """Fleet-wide /healthz sweep.  Rows are ``{"host", "health"}`` on
    success, ``{"host", "error", "kind"}`` with the :func:`_sweep`
    classification on failure."""
    rows = []
    for _i, addr, health, kind, err in _sweep(
            layout, lambda a: fetch_healthz(a, timeout=timeout)):
        if kind is None:
            rows.append({"host": addr, "health": health})
        else:
            rows.append({"host": addr, "error": err, "kind": kind})
    return rows


def health_divergence(rows: List[Dict[str, object]],
                      lcr_lag_warn: int = 16) -> List[Dict[str, object]]:
    """Cross-node divergence verdicts over a health sweep.  Hard flags:

    - ``epoch``: honest nodes must agree on the applied epoch ledger —
      any spread is a membership-plane split;
    - ``digest``: two nodes at the SAME commit position reporting
      different rolling digests hold different committed histories —
      the loudest possible alarm;

    and a soft flag ``lcr_lag`` for nodes more than ``lcr_lag_warn``
    decided rounds behind the fleet maximum (slow or stalled, not
    necessarily split)."""
    ok = [(r["host"], r["health"]) for r in rows if "health" in r]
    out: List[Dict[str, object]] = []
    if not ok:
        return out
    epochs = {h: hl.get("epoch", 0) for h, hl in ok}
    if len(set(epochs.values())) > 1:
        out.append({"kind": "epoch", "severity": "error",
                    "values": epochs})
    by_pos: Dict[int, Dict[str, str]] = {}
    for h, hl in ok:
        by_pos.setdefault(int(hl.get("commit_length", 0)), {})[h] = (
            hl.get("digest", "")
        )
    for pos, digests in sorted(by_pos.items()):
        if len(set(digests.values())) > 1:
            out.append({"kind": "digest", "severity": "error",
                        "position": pos, "values": digests})
    lcrs = {h: int(hl.get("lcr", -1)) for h, hl in ok}
    top = max(lcrs.values())
    lagging = {h: v for h, v in lcrs.items() if top - v > lcr_lag_warn}
    if lagging:
        out.append({"kind": "lcr_lag", "severity": "warning",
                    "fleet_max": top, "values": lagging})
    return out


def format_health(rows: List[Dict[str, object]],
                  divergence: List[Dict[str, object]]) -> str:
    """One fleet table + the divergence section, loudly."""
    cols = ("host", "status", "epoch", "lcr", "commits", "rate",
            "margin", "burn", "blocked", "behind")
    table = []
    for r in rows:
        if "health" not in r:
            table.append((r["host"], f"<{r['kind']}: {r['error']}>",) +
                         ("",) * (len(cols) - 2))
            continue
        h = r["health"]
        table.append((
            r["host"], h.get("status", "?"), str(h.get("epoch", "?")),
            str(h.get("lcr", "?")), str(h.get("commit_length", "?")),
            f"{h.get('round_advance_rate', 0):.2f}",
            str(h.get("quorum_margin", "?")),
            f"{h.get('commit_slo_burn', 0):.2f}",
            ",".join(h.get("reasons", [])) or "-",
            ",".join(str(c) for c in h.get("behind_horizon", [])) or "-",
        ))
    widths = [max(len(cols[i]), *(len(row[i]) for row in table))
              for i in range(len(cols))] if table else [len(c) for c in cols]
    lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths))]
    lines.append("-" * len(lines[0]))
    for row in table:
        lines.append("  ".join(v.ljust(w) for v, w in zip(row, widths)))
    if divergence:
        lines.append("")
        lines.append("!!! FLEET DIVERGENCE !!!")
        for d in divergence:
            lines.append(f"  [{d['severity']}] {d['kind']}: " + ", ".join(
                f"{h}={v}" for h, v in sorted(d["values"].items())
            ) + (f" (position {d['position']})" if "position" in d else "")
              + (f" (fleet max {d['fleet_max']})" if "fleet_max" in d
                 else ""))
    else:
        lines.append("no cross-node divergence detected")
    return "\n".join(lines)


# ----------------------------------------------------------------------
# commit-lineage tracing: fleet-stitched tx timelines


def trace_tx(layout: HostLayout, txid: str,
             timeout: float = 3.0) -> dict:
    """Scrape every node's /debug/lineage for ``txid`` and stitch one
    cross-node timeline (obs/lineage.stitch).  Unreachable or gated
    hosts are reported in ``"errors"`` — a partial trace beats none."""
    from .obs.lineage import stitch

    dumps = []
    errors = []
    for _i, addr, dump, kind, err in _sweep(
            layout, lambda a: fetch_lineage(a, txid, timeout=timeout)):
        if kind is None:
            dump["node"] = addr
            dumps.append(dump)
        else:
            errors.append({"host": addr, "kind": kind, "error": err})
    st = stitch(dumps)
    st["errors"] = errors
    return st


# ----------------------------------------------------------------------
# fleet scrape rollup: per-node series aggregated
# into fleet-wide sums/maxes with a loud divergence section


def parse_exposition(text: str) -> Tuple[Dict[str, str], Dict[str, float]]:
    """Parse one Prometheus text blob into ``(types, samples)`` where
    ``types`` maps family name -> kind and ``samples`` maps the full
    sample key (name + label string) -> value."""
    types: Dict[str, str] = {}
    samples: Dict[str, float] = {}
    for ln in text.splitlines():
        if not ln:
            continue
        if ln.startswith("# TYPE "):
            parts = ln.split()
            if len(parts) >= 4:
                types[parts[2]] = parts[3]
            continue
        if ln.startswith("#"):
            continue
        key, _, val = ln.rpartition(" ")
        try:
            samples[key] = float(val)
        except ValueError:
            continue
    return types, samples


def rollup_metrics(rows: List[Dict[str, str]],
                   expect_same: Tuple[str, ...] = ("babble_epoch",),
                   ) -> dict:
    """Aggregate a :func:`scrape_hosts` sweep into fleet-wide numbers.

    Counters (and histogram buckets/sums/counts, which are just
    counter samples) SUM across nodes; gauges report sum AND max.
    Series named in ``expect_same`` are consensus state every honest
    node must agree on — disagreement lands in ``divergence`` as a
    warning row with per-host values, never averaged away silently."""
    types: Dict[str, str] = {}
    per_host: Dict[str, Dict[str, float]] = {}
    for row in rows:
        if "metrics" not in row:
            continue
        t, s = parse_exposition(row["metrics"])
        types.update(t)
        per_host[row["host"]] = s
    agg: Dict[str, Dict[str, float]] = {}
    for host, samples in per_host.items():
        for key, val in samples.items():
            a = agg.setdefault(key, {"sum": 0.0, "max": float("-inf"),
                                     "min": float("inf"), "nodes": 0})
            if val == val:   # NaN-safe: dead gauge callbacks stay out
                a["sum"] += val
                a["max"] = max(a["max"], val)
                a["min"] = min(a["min"], val)
                a["nodes"] += 1
    divergence = []
    for name in expect_same:
        values = {
            host: samples[name]
            for host, samples in per_host.items() if name in samples
        }
        if len(set(values.values())) > 1:
            # expect-same series ARE consensus state (babble_epoch): a
            # split is an error, same as health_divergence's verdict —
            # the rollup exit code must not read green over it
            divergence.append({"kind": "series", "series": name,
                               "severity": "error", "values": values})
    return {"types": types, "series": agg, "divergence": divergence,
            "hosts": sorted(per_host),
            "unparsed": [r["host"] for r in rows if "metrics" not in r]}


def format_rollup(rollup: dict) -> str:
    """Aggregated exposition-style text: counters as fleet sums, gauges
    as sum+max, divergence section first (and loud)."""
    lines = []
    if rollup["divergence"]:
        lines.append("!!! FLEET DIVERGENCE !!!")
        for d in rollup["divergence"]:
            label = d.get("series") or d.get("kind")
            lines.append(f"  [{d['severity']}] {label}: " + ", ".join(
                f"{h}={v}" for h, v in sorted(d["values"].items())
            ))
        lines.append("")
    lines.append(f"# fleet rollup over {len(rollup['hosts'])} hosts"
                 + (f" ({len(rollup['unparsed'])} missing)"
                    if rollup["unparsed"] else ""))
    types = rollup["types"]
    for key in sorted(rollup["series"]):
        a = rollup["series"][key]
        family = key.split("{", 1)[0]
        kind = types.get(family)
        if kind is None and family.endswith(("_bucket", "_sum", "_count")):
            kind = types.get(family.rsplit("_", 1)[0], "counter")
        if kind == "gauge":
            lines.append(f"{key} sum={a['sum']:g} max={a['max']:g}")
        else:
            lines.append(f"{key} {a['sum']:g}")
    return "\n".join(lines)


async def bombard_hosts(
    layout: HostLayout, rate: float, duration: float, seed: int = 0
) -> int:
    """Flood transactions round-robin across the hosts' submit ports
    (terraform/scripts/bombard.sh)."""
    import asyncio
    import random
    import time

    from .proxy.jsonrpc import JsonRpcClient, b64e

    rng = random.Random(seed)
    clients = [
        JsonRpcClient(layout.of(i)["submit"], timeout=15.0)
        for i in range(len(layout.hosts))
    ]
    sent = 0
    attempt = 0
    t_end = time.monotonic() + duration
    try:
        while time.monotonic() < t_end:
            i = attempt % len(clients)
            attempt += 1
            payload = f"bomb-{sent}-{rng.getrandbits(32):08x}".encode()
            try:
                await clients[i].call("Babble.SubmitTx", b64e(payload))
                sent += 1
            except (OSError, RuntimeError):
                await asyncio.sleep(0.05)
                continue
            await asyncio.sleep(1.0 / rate)
    finally:
        for c in clients:
            await c.close()
    return sent
