"""CLI (reference cmd/main.go:39-260): the port's copy of the JAX package's
``cli.py``, run as ``python -m babble_tpu_torch.cli``.

- ``keygen``  — print (or write to a datadir) a PEM keypair.
- ``run``     — boot a node: key + peers from the datadir, TCP transport,
  socket or inmem proxy, /Stats service, then the gossip loop.
- ``sim``     — generate a random gossip DAG and run the batch consensus
  step (mode ``"fast"``) on the device (no networking).
- ``dummy``   — the reference's chat client (``proxy/dummy.py``).
- ``testnet`` — ``conf``, ``run``, ``bombard``, ``watch``, ``health`` and
  ``trace`` for a local fleet of port nodes (``testnet.py``).
- ``fleet``   — ``conf``, ``watch``, ``scrape``, ``health``, ``trace`` and
  ``bombard`` for a fleet of one node a host (``fleet.py``).
- ``chaos``   — ``list``, ``show`` and ``run`` the chaos plane's
  scenarios (``chaos/``): the deterministic in-memory cluster, or a live
  subprocess fleet with ``--live``.
- ``lint``    — babble-lint (``analysis/``), forwarded whole to
  ``python -m babble_tpu_torch.analysis``.

The flags and defaults are the JAX package's, plus ``--device`` (the
card by default; ``--device cpu`` runs every stage in plain torch on the
CPU).  ``run --jax_cache`` keeps JAX's name and default
(``<datadir>/jax_cache``, ``off`` for none) for the port's cache root:
the AOT shape manifest (``ops/aot.py``), which ``Node`` prewarms from at
boot unless ``--no_aot_prewarm``.  The kernel libraries stay in the
package's hash-named ``_build/``, shared by every node of a checkout.  This
module imports no torch: ``lint`` and the fleet and testnet sweeps run without
it, and the verbs that drive an engine import it when they run.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time


def check_fork_k(args) -> None:
    """Raise ``SystemExit`` for a ``--fork_k`` the card's fork_ss kernel
    is not built for (the CPU's plain twin takes any k)."""
    from .ops.forks import FORK_SS_MAX_K

    if args.byzantine and args.device.startswith("cuda") \
            and args.fork_k > FORK_SS_MAX_K:
        raise SystemExit(
            f"--fork_k {args.fork_k}: the fork_ss kernel on {args.device} "
            f"is built for k in [1, {FORK_SS_MAX_K}]")


def _parse_fork_caps(spec: str, flag: str = "--fork_caps"):
    """'e,s,r' -> (e, s, r), failing at the flag instead of as a bare
    IndexError inside the consensus loop."""
    if not spec:
        return None
    parts = spec.split(",")
    if len(parts) != 3:
        raise SystemExit(
            f"{flag} wants exactly 'e,s,r' (got {spec!r})"
        )
    try:
        caps = tuple(int(x) for x in parts)
    except ValueError:
        raise SystemExit(f"{flag} values must be integers: {spec!r}")
    if any(v <= 0 for v in caps):
        raise SystemExit(f"{flag} values must be positive: {spec!r}")
    return caps


def cmd_keygen(args) -> int:
    from .crypto.keys import PemKeyFile, generate_key, pem_dump

    key = generate_key()
    if args.datadir:
        pem = PemKeyFile(args.datadir)
        if pem.exists():
            print(f"key already exists in {args.datadir}", file=sys.stderr)
            return 1
        pem.write(key)
        print(f"wrote {pem.path}")
    priv, pub = pem_dump(key)
    print(f"PublicKey:\n{pub}")
    if not args.datadir:
        print(f"PrivateKey:\n{priv}")
    return 0


def _device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


async def _run_node(args) -> int:
    # the cache root, shared by every node under one testnet root: the
    # AOT shape manifest there is what Node prewarms from at boot
    cache_dir = ""
    if args.jax_cache != "off":
        from .ops import aot

        cache_dir = args.jax_cache or os.path.join(
            os.path.abspath(args.datadir), "jax_cache"
        )
        aot.configure(cache_dir)

    from .crypto.keys import PemKeyFile
    from .net.peers import JSONPeers
    from .net.tcp_transport import new_tcp_transport
    from .node.config import Config
    from .node.node import Node
    from .proxy.inmem import InmemAppProxy
    from .proxy.socket_app import SocketAppProxy
    from .service.service import Service

    key = PemKeyFile(args.datadir).read()
    peers = JSONPeers(args.datadir).peers()
    # membership plane: a JOINER's epoch-0 validator set is the
    # founders' peers.json, while its own address rides only the
    # gossip book — it observes until its signed join tx commits
    bootstrap_peers = None
    if args.bootstrap_peers:
        from .net.peers import peers_from_file

        bootstrap_peers = peers_from_file(args.bootstrap_peers)

    engine = None
    ckpt_dir = args.checkpoint_dir
    if ckpt_dir and os.path.isdir(ckpt_dir):
        # corruption-tolerant restart: a rotten checkpoint degrades to
        # a fresh engine + WAL replay + gossip/fast-forward instead of
        # a dead node
        from .store import load_checkpoint_tolerant

        engine, ckpt_err = load_checkpoint_tolerant(ckpt_dir,
                                                    device=args.device)
        if ckpt_err is not None:
            if not args.wal_dir:
                # without a WAL there is no mint floor and no seq
                # probe: booting a fresh root here would re-mint every
                # published seq and peers would read this identity as
                # an equivocator (the crash-recovery-amnesia defect) —
                # refuse instead of silently poisoning the fleet
                raise SystemExit(
                    f"checkpoint {ckpt_dir} is unreadable ({ckpt_err}) "
                    "and no --wal_dir is configured: a fresh boot would "
                    "re-mint published sequence numbers.  Configure "
                    "--wal_dir (recovery degrades safely through the "
                    "WAL + seq probe), restore the checkpoint, or "
                    "remove the directory to explicitly start over."
                )
            print(
                f"warning: checkpoint {ckpt_dir} unreadable ({ckpt_err}); "
                "starting fresh and recovering from the WAL",
                file=sys.stderr,
            )
    if engine is not None:
        from .store.checkpoint import engine_mode

        mode = engine_mode(engine)
        want = "byzantine" if args.byzantine else args.engine
        if mode != want:
            raise SystemExit(
                f"checkpoint {ckpt_dir} engine kind '{mode}' does not "
                f"match the configured engine '{want}'"
            )
        if mode == "byzantine":
            caps = _parse_fork_caps(args.fork_caps)
            if caps:
                # the checkpoint carries no capacity hints: re-apply the
                # pre-sizing or every resume grows its capacities anew
                engine.pre_size(caps)
        elif mode == "wide":
            want_caps = _parse_fork_caps(args.wide_caps, flag="--wide_caps")
            have = (engine.cfg.e_cap, engine.cfg.s_cap, engine.cfg.r_cap)
            if want_caps and tuple(want_caps) != have:
                # wide capacities are fixed at boot; the checkpoint's
                # shapes win on resume — say so
                print(
                    f"warning: --wide_caps {want_caps} ignored — the "
                    f"resumed checkpoint's window capacities are {have} "
                    "and cannot change post-boot",
                    file=sys.stderr,
                )
        n_ev = (len(engine.dag.events) if mode == "byzantine"
                else engine.dag.n_events)
        print(f"resumed from checkpoint {ckpt_dir}: "
              f"{n_ev} events, "
              f"{engine.consensus_events_count()} in consensus order")

    conf = Config(
        heartbeat=args.heartbeat / 1000.0,
        tcp_timeout=args.tcp_timeout / 1000.0,
        cache_size=args.cache_size,
        consensus_interval=args.consensus_interval / 1000.0,
        pipeline=not args.no_pipeline,
        gossip_fanout=args.gossip_fanout,
        gossip_inflight=args.gossip_inflight,
        gossip_eager=not args.no_eager_gossip,
        coalesce_max=args.coalesce_max,
        coalesce_latency=args.coalesce_latency / 1000.0,
        mint_backpressure=args.mint_backpressure or None,
        seq_window=args.seq_window or None,
        # 0 disables the inactivity policy (a silent peer then pins
        # eviction fleet-wide); -1 = default
        inactive_rounds=(
            None if args.inactive_rounds == 0
            else (args.inactive_rounds if args.inactive_rounds > 0
                  else 32)
        ),
        ff_verify=not args.no_ff_verify,
        anchor_interval=args.anchor_interval,
        bootstrap_peers=bootstrap_peers,
        byzantine=args.byzantine,
        fork_k=args.fork_k,
        fork_caps=_parse_fork_caps(args.fork_caps),
        engine=args.engine,
        wide_caps=_parse_fork_caps(args.wide_caps, flag="--wide_caps"),
        wal_dir=args.wal_dir,
        wal_fsync=args.wal_fsync,
        kernel_class=args.kernel_class,
        packed_votes=not args.no_packed_votes,
        frontier=not args.no_frontier,
        aot_dir="" if args.no_aot_prewarm else cache_dir,
        lineage=not args.no_lineage,
        flight=not args.no_flight,
        phase_probe=args.phase_probe,
        commit_slo=args.commit_slo / 1000.0,
        device=args.device,
    )
    conf.logger.setLevel(args.log_level.upper())

    transport = await new_tcp_transport(
        args.node_addr, max_pool=args.max_pool,
        timeout=conf.tcp_timeout,
    )
    if args.chaos_plan:
        # self-injected faults for live fleets: every node wraps its TCP
        # transport in the same (plan, seed)-driven FaultyTransport the
        # in-memory scenario runner uses, deriving its own link identity
        # from the canonical peer order — no per-node flags needed.  The
        # wall clock drives only the injector's tick cursor (--chaos_epoch
        # keeps a restarted node in phase), never event bodies (those go
        # through Core.now_ns)
        transport = _chaos_wrap(transport, args, key, peers)  # babble-lint: disable=consensus-nondeterminism
        print(f"chaos plan {args.chaos_plan} active "
              f"(seed {transport.injector.seed})", file=sys.stderr)
    if args.no_client:
        proxy = InmemAppProxy()
    else:
        proxy = SocketAppProxy(
            args.client_addr, args.proxy_addr,
            timeout=conf.tcp_timeout,
            submit_per_client=args.submit_per_client,
            submit_total=args.submit_total,
            submit_adaptive=args.submit_adaptive,
        )
        await proxy.start()

    node = Node(conf, key, peers, transport, proxy, engine=engine)
    if engine is None:
        # Node.init is recovery-aware: it skips the root mint when WAL
        # replay already restored a head, and defers it while the seq
        # probe negotiates a skip-ahead with the fleet
        node.init()
    service = Service(args.service_addr, node,
                      allow_remote_debug=args.allow_remote_debug)
    await service.start()
    print(f"node {node.core.id} on {_device_name(node.core.hg.device)} "
          f"listening on {transport.local_addr()}, "
          f"stats on http://{service.bind_addr}/Stats, "
          f"metrics on http://{service.bind_addr}/metrics", flush=True)

    saver = None
    if ckpt_dir:
        saver = asyncio.create_task(
            _checkpoint_loop(node, ckpt_dir, args.checkpoint_interval)
        )
    try:
        await node.run(gossip=True)
    except Exception:
        # crash post-mortem: an unhandled select-loop error dumps the
        # flight recorder's last-N-transitions narrative next to the
        # datadir before the process dies — the in-memory ring would
        # otherwise die with it
        _dump_flight_on_crash(node, args.datadir)
        raise
    finally:
        if saver is not None:
            saver.cancel()
        if ckpt_dir:
            await node.save_checkpoint(ckpt_dir)
        await service.close()
        # Node.shutdown takes the core lock before it cancels, so the
        # section in flight mints its payload once
        await node.shutdown()
    return 0


def _dump_flight_on_crash(node, datadir: str) -> None:
    try:
        path = os.path.join(datadir, "flight-crash.json")
        with open(path, "w") as f:
            json.dump({"stats": node.flight.stats(),
                       "records": node.flight.dump()}, f, indent=1)
        print(f"flight recorder dumped to {path}", file=sys.stderr)
    except Exception as e:   # the dump must never mask the real crash
        print(f"flight dump failed: {e}", file=sys.stderr)


def _chaos_wrap(transport, args, key, peers):
    """Wrap a live node's transport in a FaultyTransport driven by the
    scenario (or bare fault-plan) JSON at --chaos_plan.  Ticks map to
    wall time through the scenario's tick_seconds; link identities are
    canonical participant ids, so every node in the fleet derives the
    same per-link fault streams from the shared seed."""
    from .chaos import FaultInjector, FaultPlan, FaultyTransport, Scenario
    from .net.peers import canonical_ids

    with open(args.chaos_plan) as f:
        spec = json.load(f)
    joiners = 0
    if "plan" in spec:
        sc = Scenario.from_dict(spec)
        plan, tick_seconds, seed = sc.plan, sc.tick_seconds, sc.seed
        joiners = sc.joiners
    else:
        plan, tick_seconds, seed = FaultPlan.from_dict(spec), 0.05, 0
    if args.chaos_seed is not None:
        seed = args.chaos_seed
    # Link identities: the fleet runner's address map when provided
    # (--chaos_addrs, written by chaos run --live next to the scenario
    # JSON) — the only exact source once joiners exist, because it
    # names every scheduled joiner's address/index before the joiner's
    # transition commits.  Without it, canonical ids over the FOUNDING
    # set (a joiner's peers.json carries its own address too, and
    # folding that key into the sort would renumber every founder's
    # per-link fault stream); extra address-book entries take the
    # joiner indices in address order.
    if args.bootstrap_peers:
        from .net.peers import peers_from_file

        founders = peers_from_file(args.bootstrap_peers)
    else:
        founders = peers
    if args.chaos_addrs:
        with open(args.chaos_addrs) as f:
            addr_index = {a: int(i) for a, i in json.load(f).items()}
        own = addr_index[transport.local_addr()]
    else:
        ids = canonical_ids(founders)
        addr_index = {p.net_addr: ids[p.pub_key_hex] for p in founders}
        extra = sorted(
            p.net_addr for p in peers if p.pub_key_hex not in ids
        )
        for j, addr in enumerate(extra):
            addr_index[addr] = len(founders) + j
        own = (ids[key.pub_hex] if key.pub_hex in ids
               else addr_index[transport.local_addr()])
    plan.validate(len(founders), joiners=joiners)
    # tick 0 is the FLEET's epoch, not this process's boot: a node
    # relaunched mid-run must rejoin the shared timeline, or it would
    # replay the plan's partition/byzantine schedule out of phase with
    # everyone else.  Without --chaos_epoch, boot time is the epoch.
    epoch = args.chaos_epoch
    if epoch is None:
        epoch = time.time()
    injector = FaultInjector(
        plan, seed,
        clock=lambda: (time.time() - epoch) / tick_seconds,
        # the token bucket's refill clock: elapsed ticks x tick_seconds
        # must equal elapsed wall seconds
        tick_seconds=tick_seconds,
    )
    return FaultyTransport(
        transport, injector, own, addr_index,
        # the forge_snapshot actor needs its own participant key to
        # re-sign the doctored proof
        forge_key=(key if injector.is_snapshot_forger(own) else None),
    )


async def _checkpoint_loop(node, ckpt_dir: str, interval: float) -> None:
    while True:
        await asyncio.sleep(interval)
        try:
            await node.save_checkpoint(ckpt_dir)
        except Exception as e:
            print(f"checkpoint failed: {e}", file=sys.stderr)


def cmd_run(args) -> int:
    check_fork_k(args)
    try:
        return asyncio.run(_run_node(args))
    except KeyboardInterrupt:
        return 0


def cmd_sim(args) -> int:
    import torch

    from . import native
    from .ops.state import DagConfig, init_state
    from .sim.arrays import batch_from_arrays, random_gossip_arrays
    from .step import consensus_step

    dev = torch.device(args.device)
    t0 = time.perf_counter()
    dag = random_gossip_arrays(args.nodes, args.events, seed=args.seed)
    batch = batch_from_arrays(dag, device=dev)
    cfg = DagConfig(
        n=args.nodes, e_cap=args.events,
        s_cap=max(64, dag.max_chain + 1), r_cap=args.rounds,
    )
    print(f"host build: {time.perf_counter()-t0:.2f}s "
          f"(native={native.available()})", file=sys.stderr)

    def step():
        out = consensus_step(cfg, "fast", init_state(cfg, device=dev), batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    # the first run pays the CUDA context and the allocator's warm-up
    # (the JAX package's compile_s is its jit compile)
    t0 = time.perf_counter()
    out = step()
    compile_s = time.perf_counter() - t0
    if args.profile:
        # torch.profiler trace of the steady-state step, as a Chrome
        # trace in the given directory
        from .service.service import TraceSession

        os.makedirs(args.profile, exist_ok=True)
        session = TraceSession(args.profile)
        session.start()
        try:
            out = step()
        finally:
            session.stop()
        print(f"profile written to {args.profile}", file=sys.stderr)
    t0 = time.perf_counter()
    out = step()
    run_s = time.perf_counter() - t0
    ordered = int((out.rr[: args.events] >= 0).sum())
    print(json.dumps({
        "nodes": args.nodes,
        "events": args.events,
        "ordered": ordered,
        "last_consensus_round": int(out.lcr),
        "max_round": int(out.max_round),
        "compile_s": round(compile_s, 3),
        "run_s": round(run_s, 4),
        "events_per_sec": round(ordered / run_s, 1) if run_s > 0 else None,
        "device": str(dev),
    }))
    return 0


async def _run_dummy(args) -> int:
    from .proxy.dummy import DummySocketClient

    client = DummySocketClient(args.node_addr, args.listen, log_path=args.log)
    await client.start()
    if not args.quiet:
        print(f"dummy client: submit -> {args.node_addr}, "
              f"commits <- {client.proxy.bind_addr}; type messages:")

    loop = asyncio.get_running_loop()
    last_seen = 0

    async def print_commits():
        nonlocal last_seen
        while True:
            await asyncio.sleep(0.3)
            msgs = client.state.get_messages()
            for m in msgs[last_seen:]:
                print(f"<< {m}")
            last_seen = len(msgs)

    printer = None if args.quiet else asyncio.create_task(print_commits())
    try:
        if args.quiet:
            await asyncio.Event().wait()  # serve until killed
        else:
            while True:
                line = await loop.run_in_executor(None, sys.stdin.readline)
                if not line:
                    break
                line = line.strip()
                if line:
                    await client.submit_tx(line.encode())
    finally:
        if printer is not None:
            printer.cancel()
        await client.close()
    return 0


def cmd_dummy(args) -> int:
    """Interactive chat client (reference cmd/dummy_client/main.go)."""
    try:
        return asyncio.run(_run_dummy(args))
    except KeyboardInterrupt:
        return 0


def cmd_testnet(args) -> int:
    from . import testnet as tn

    ports = tn.PortLayout(
        gossip=args.base_port, submit=args.base_port + 1000,
        commit=args.base_port + 2000, service=args.base_port + 3000,
    )
    if args.testnet_cmd == "conf":
        dirs = tn.build_conf(args.dir, args.n, ports, overwrite=args.overwrite)
        print(f"wrote {len(dirs)} node configs under {args.dir}")
        return 0
    if args.testnet_cmd == "watch":
        while True:
            print("\x1b[2J\x1b[H" + tn.format_stats(
                tn.watch_once(args.n, ports)))
            if args.once:
                return 0
            time.sleep(args.interval)
    if args.testnet_cmd in ("health", "trace"):
        # the read-only observability sweeps share the fleet helpers:
        # a same-host testnet is just a HostLayout of explicit
        # host:service_port entries
        from . import fleet as fl

        layout = fl.HostLayout(
            [ports.of(i)["service"] for i in range(args.n)]
        )
        if args.testnet_cmd == "health":
            return _print_health(fl, layout, args.json)
        return _print_trace(fl, layout, args.txid, args.json)
    if args.testnet_cmd == "bombard":
        if args.clients > 1:
            # many-client harness: per-connection admission identities,
            # structured-overloaded backoff, shed/error accounting
            counts = asyncio.run(tn.bombard_many(
                args.n, clients=args.clients, rate=args.rate,
                duration=args.duration, ports=ports, batch=args.batch))
            print(f"submitted {counts['sent']} transactions "
                  f"({counts['shed']} shed, {counts['errors']} errors, "
                  f"{counts['clients']} clients)")
            return 0
        sent = asyncio.run(
            tn.bombard(args.n, args.rate, args.duration, ports))
        print(f"submitted {sent} transactions")
        return 0
    if args.testnet_cmd == "run":
        runner = tn.TestnetRunner(
            args.dir, args.n, heartbeat_ms=args.heartbeat,
            with_clients=not args.no_clients, ports=ports,
            device=args.device,
        )
        runner.start()
        print(f"{args.n} nodes up on {args.device}; /Stats at "
              f"http://127.0.0.1:{args.base_port + 3000}..{args.base_port + 3000 + args.n - 1}"
              f"; ctrl-C to stop")
        try:
            while True:
                time.sleep(args.interval)
                print(tn.format_stats(tn.watch_once(args.n, ports)))
        except KeyboardInterrupt:
            pass
        finally:
            runner.stop()
        return 0
    raise SystemExit(f"unknown testnet subcommand {args.testnet_cmd}")


def _print_health(fl, layout, as_json: bool) -> int:
    """One /healthz sweep rendered as the fleet table (or JSON).  Exit
    1 when any node is unreachable, degraded, or the fleet diverges —
    a health verb that always exits 0 is a decoration."""
    rows = fl.health_hosts(layout)
    divergence = fl.health_divergence(rows)
    if as_json:
        print(json.dumps({"nodes": rows, "divergence": divergence},
                         indent=1))
    else:
        print(fl.format_health(rows, divergence))
    ok = (
        all("health" in r for r in rows)
        and all(r["health"].get("status") == "ok" for r in rows)
        and not any(d["severity"] == "error" for d in divergence)
    )
    return 0 if ok else 1


def _print_trace(fl, layout, txid: str, as_json: bool) -> int:
    """Stitch one tx's cross-node lineage; exit 1 when nothing was
    found (wrong txid, lineage disabled, or the ledgers rolled off)."""
    from .obs.lineage import format_trace

    st = fl.trace_tx(layout, txid)
    if as_json:
        print(json.dumps(st, indent=1))
    else:
        if st["errors"]:
            for e in st["errors"]:
                print(f"{e['host']}: {e['kind']}: {e['error']}",
                      file=sys.stderr)
        print(format_trace(st))
    return 0 if st["timeline"] else 1


def cmd_fleet(args) -> int:
    from . import fleet as fl
    from . import testnet as tn

    with open(args.hosts) as f:
        hosts = [ln.strip() for ln in f if ln.strip()]
    if not hosts:
        raise SystemExit(f"{args.hosts} lists no hosts")
    if getattr(args, "rate", 1.0) <= 0:
        raise SystemExit("--rate must be positive")
    layout = fl.HostLayout(
        hosts, gossip_port=args.gossip_port, submit_port=args.submit_port,
        commit_port=args.commit_port, service_port=args.service_port,
    )
    if (layout.explicit_service_ports()
            and args.fleet_cmd not in ("watch", "scrape", "trace",
                                       "health")):
        # 'host:port' entries name SERVICE endpoints; conf/bombard
        # would resolve every node to one shared default gossip/submit
        # port on the same host and silently misroute
        raise SystemExit(
            "host:port entries are only valid for the read-only "
            f"sweeps (watch/scrape/trace/health), not '{args.fleet_cmd}'"
            " — list bare hosts and use the port flags instead"
        )
    if args.fleet_cmd == "conf":
        dirs = fl.build_fleet_conf(os.path.join(args.dir, "conf"), layout)
        scripts = fl.write_deploy_scripts(args.dir, layout)
        print(f"wrote {len(dirs)} node configs + "
              f"{len(scripts)} deploy files under {args.dir}")
        return 0
    if args.fleet_cmd == "watch":
        while True:
            print("\x1b[2J\x1b[H" + tn.format_stats(fl.watch_hosts(layout)))
            if args.once:
                return 0
            time.sleep(args.interval)
    if args.fleet_cmd == "bombard":
        sent = asyncio.run(
            fl.bombard_hosts(layout, args.rate, args.duration))
        print(f"submitted {sent} transactions")
        return 0
    if args.fleet_cmd == "health":
        return _print_health(fl, layout, args.json)
    if args.fleet_cmd == "trace":
        return _print_trace(fl, layout, args.txid, args.json)
    if args.fleet_cmd == "scrape":
        rows = fl.scrape_hosts(layout)
        if getattr(args, "rollup", False):
            rollup = fl.rollup_metrics(rows)
            # digest-anchor divergence comes from /healthz (a hash
            # cannot be a metric sample); best-effort — rollup output
            # must not require every node to serve the health surface
            try:
                hrows = fl.health_hosts(layout)
                # epoch divergence is already covered by the
                # babble_epoch series check above
                rollup["divergence"].extend(
                    d for d in fl.health_divergence(hrows)
                    if d["kind"] == "digest"
                )
            except Exception as e:
                rollup["health_error"] = str(e)
            if args.json:
                print(json.dumps(rollup, indent=1))
            else:
                print(fl.format_rollup(rollup))
            # a diverged fleet must fail the sweep the same way fleet
            # health would — CI scripted on this exit code must not
            # see green over a split committed history
            diverged = any(
                d.get("severity") == "error"
                for d in rollup["divergence"]
            )
            return 0 if not rollup["unparsed"] and not diverged else 1
        if getattr(args, "spans", False):
            # merge the span sweep into the metrics rows; span output is
            # structured (trees), so this mode is always JSON.  A
            # loopback-gated host's spans row carries kind='gated' —
            # expected policy, so it does not flip the exit code the way
            # a missing /metrics blob does.
            for row, srow in zip(rows, fl.scrape_spans(layout)):
                if "spans" in srow:
                    row["spans"] = srow["spans"]
                else:
                    row["spans_kind"] = srow["kind"]
                    row["spans_error"] = srow["error"]
            print(json.dumps(rows, indent=1))
            ok = all(
                "metrics" in r
                and ("spans" in r or r.get("spans_kind") == "gated")
                for r in rows
            )
            return 0 if ok else 1
        if args.json:
            print(json.dumps(rows, indent=1))
        else:
            # one exposition blob per host, comment-separated so the
            # output stays valid Prometheus text; failures go to stderr
            # and flip the exit code (a silent half-sweep reads as a
            # healthy fleet)
            for row in rows:
                if "metrics" in row:
                    print(f"# ==== {row['host']} ====")
                    print(row["metrics"], end="")
                else:
                    print(f"{row['host']}: {row['kind']}: {row['error']}",
                          file=sys.stderr)
        return 0 if all("metrics" in r for r in rows) else 1
    raise SystemExit(f"unknown fleet subcommand {args.fleet_cmd}")


def cmd_chaos(args) -> int:
    from .chaos import (
        CANNED,
        Scenario,
        canned_names,
        load_scenario,
        run_live,
        run_scenario,
    )

    if args.chaos_cmd == "list":
        for name in canned_names():
            sc = CANNED[name]
            print(f"{name}: {sc['nodes']} nodes, {sc['steps']} steps, "
                  f"engine={sc.get('engine', 'fused')}, "
                  f"invariants={','.join(sc['invariants'])}")
        return 0
    if args.chaos_cmd == "show":
        print(json.dumps(load_scenario(args.scenario).to_dict(), indent=1))
        return 0
    if args.chaos_cmd == "run":
        sc = load_scenario(args.scenario)
        overrides = {}
        if args.seed is not None:
            overrides["seed"] = args.seed
        if args.steps is not None:
            overrides["steps"] = args.steps
        if args.nodes is not None:
            overrides["nodes"] = args.nodes
        if overrides:
            sc = Scenario.from_dict({**sc.to_dict(), **overrides})
        if args.live:
            report = run_live(sc, args.dir, device=args.device)
            print(json.dumps(report, indent=1))
            return 0 if report.get("advanced") else 1
        result = run_scenario(sc, device=args.device)
        if args.json:
            print(json.dumps(result.to_dict(), indent=1))
        else:
            print(f"scenario {result.name} seed={result.seed} "
                  f"steps={result.steps}")
            print(f"fingerprint {result.fingerprint()}")
            print(f"faults injected: {result.fault_counts or '{}'}")
            print("consensus events: " + ", ".join(
                f"node{i}={c}"
                for i, c in sorted(result.consensus_counts_final.items())
            ))
            print(result.report.format())
        if not result.report.ok:
            print("CHAOS RUN FAILED: invariant violation(s) above",
                  file=sys.stderr)
        return 0 if result.report.ok else 1
    raise SystemExit(f"unknown chaos subcommand {args.chaos_cmd}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="babble-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    kg = sub.add_parser("keygen", help="generate an ECDSA P-256 keypair")
    kg.add_argument("--datadir", default="", help="write priv_key.pem here")
    kg.set_defaults(fn=cmd_keygen)

    rn = sub.add_parser("run", help="run a consensus node")
    rn.add_argument("--datadir", default=".",
                    help="dir with priv_key.pem and peers.json")
    rn.add_argument("--node_addr", default="127.0.0.1:1337")
    rn.add_argument("--no_client", action="store_true",
                    help="use an in-memory app proxy instead of sockets")
    rn.add_argument("--proxy_addr", default="127.0.0.1:1338",
                    help="where we listen for the app's SubmitTx")
    rn.add_argument("--client_addr", default="127.0.0.1:1339",
                    help="the app's CommitTx server")
    rn.add_argument("--service_addr", default="127.0.0.1:8000")
    rn.add_argument("--allow_remote_debug", action="store_true",
                    help="serve /debug/* to non-loopback callers "
                         "(default: loopback only)")
    rn.add_argument("--log_level", default="info")
    rn.add_argument("--heartbeat", type=int, default=1000, help="ms")
    rn.add_argument("--max_pool", type=int, default=2)
    rn.add_argument("--tcp_timeout", type=int, default=1000, help="ms")
    rn.add_argument("--cache_size", type=int, default=500)
    rn.add_argument("--no_pipeline", action="store_true",
                    help="disable pipelined gossip (speculative push); "
                         "restores the lockstep pull exchange")
    rn.add_argument("--gossip_fanout", type=int, default=1,
                    help="peers gossiped per heartbeat tick")
    rn.add_argument("--gossip_inflight", type=int, default=4,
                    help="max concurrent outbound gossip exchanges")
    rn.add_argument("--no_eager_gossip", action="store_true",
                    help="don't launch the next gossip immediately when "
                         "one finishes with txs pooled")
    rn.add_argument("--coalesce_max", type=int, default=1024,
                    help="max client txs coalesced into one event")
    rn.add_argument("--coalesce_latency", type=int, default=50,
                    help="ms a pooled tx may wait before a self-parent "
                         "event is minted for it")
    rn.add_argument("--mint_backpressure", type=int, default=0,
                    help="pause deadline mints while undetermined "
                         "backlog exceeds this (0 = cache_size/4)")
    rn.add_argument("--submit_per_client", type=int, default=1024,
                    help="admission control: per-client submit queue cap")
    rn.add_argument("--submit_total", type=int, default=8192,
                    help="admission control: total submit queue cap")
    rn.add_argument("--submit_adaptive", action="store_true",
                    help="derive admission caps from the observed "
                         "commit drain rate (EWMA) instead of the "
                         "static caps")
    rn.add_argument("--bootstrap_peers", default="",
                    help="membership: path to the FOUNDING peers.json "
                         "when this node is a joiner (its own address "
                         "is only in the datadir peers.json; it "
                         "observes until its signed join tx commits)")
    rn.add_argument("--consensus_interval", type=int, default=0,
                    help="ms between consensus pipeline runs (0 = every sync)")
    rn.add_argument("--byzantine", action="store_true",
                    help="fork-aware live mode: accept + detect "
                         "equivocations instead of rejecting them")
    rn.add_argument("--fork_k", type=int, default=2,
                    help="branch slots per creator (fork budget K-1)")
    rn.add_argument("--fork_caps", default="",
                    help="pre-sized byzantine pipeline capacities "
                         "'e,s,r' (one pipeline shape at boot instead of "
                         "demand-driven growth)")
    rn.add_argument("--engine", default="fused",
                    choices=("fused", "wide"),
                    help="honest-mode engine: fused [E,N] coordinate "
                         "tensors, or the column-blocked rolling-window "
                         "wide engine (the 10k-participant layout)")
    rn.add_argument("--wide_caps", default="",
                    help="wide-engine window capacities 'e,s,r' "
                         "(fixed at boot; the engine compacts instead "
                         "of growing)")
    rn.add_argument("--seq_window", type=int, default=0,
                    help="per-creator rolling window (0 = cache_size)")
    rn.add_argument("--inactive_rounds", type=int, default=-1,
                    help="per-creator eviction: decided rounds of "
                         "silence before a creator's retained tail "
                         "evicts (its return then fast-forwards); "
                         "-1 = default 32, 0 = disabled")
    rn.add_argument("--no_ff_verify", action="store_true",
                    help="skip signed-state-proof verification on "
                         "fast-forward snapshots (trust any serving "
                         "peer)")
    rn.add_argument("--anchor_interval", type=int, default=2048,
                    help="rolling attestation checkpoints: co-sign a "
                         "CommitDigest anchor with a peer quorum every "
                         "N commits (joiners verify deep fast-forwards "
                         "against it); 0 disables collection")
    rn.add_argument("--kernel_class", default="auto",
                    choices=("auto", "latency", "throughput"),
                    help="surface pin for the fused engine: auto picks "
                         "the latency flush for gossip-sized flushes, "
                         "throughput for bulk")
    rn.add_argument("--no_packed_votes", action="store_true",
                    help="pin the f32 vote tallies on the latency "
                         "flush (bit-identical; the packed popcount "
                         "path is the default)")
    rn.add_argument("--no_frontier", action="store_true",
                    help="pin full-height fd scans in the windowed "
                         "order phase (bit-identical; the event-axis "
                         "frontier slice is the default)")
    rn.add_argument("--no_aot_prewarm", action="store_true",
                    help="skip the AOT prewarm of the recorded shapes at "
                         "boot, and the recording of new ones")
    rn.add_argument("--jax_cache", default="",
                    help="cache root for the AOT shape manifest "
                         "('' = <datadir>/jax_cache, 'off' = none)")
    rn.add_argument("--checkpoint_dir", default="",
                    help="resume from + periodically checkpoint to this dir")
    rn.add_argument("--checkpoint_interval", type=float, default=30.0,
                    help="seconds between checkpoints")
    rn.add_argument("--wal_dir", default="",
                    help="per-event write-ahead log dir: restart replays "
                         "the tail on top of the newest checkpoint, so "
                         "the node resumes at its published head seq")
    rn.add_argument("--wal_fsync", default="batch",
                    help="WAL fsync policy: always | batch(n,ms) | off "
                         "(default batch = 64 appends / 50 ms)")
    rn.add_argument("--no_lineage", action="store_true",
                    help="disable commit-lineage tracing (per-tx/per-"
                         "event lifecycle ledgers behind /debug/lineage)")
    rn.add_argument("--no_flight", action="store_true",
                    help="disable the flight recorder (state-transition "
                         "ring behind /debug/flight + crash dumps)")
    rn.add_argument("--phase_probe", action="store_true",
                    help="dispatch the latency flush as three "
                         "separately-timed phases (ingest/fame/order "
                         "wall histograms; bit-identical results, one "
                         "host sync per phase — profiling posture)")
    rn.add_argument("--commit_slo", type=int, default=1000,
                    help="commit-latency SLO in ms for the /healthz "
                         "burn gauge")
    rn.add_argument("--chaos_plan", default="",
                    help="scenario/fault-plan JSON: wrap the transport "
                         "in a seeded FaultyTransport (chaos testing)")
    rn.add_argument("--chaos_seed", type=int, default=None,
                    help="override the chaos plan's seed")
    rn.add_argument("--chaos_epoch", type=float, default=None,
                    help="fleet-wide tick-0 (unix seconds) so restarted "
                         "nodes rejoin the shared chaos timeline "
                         "(default: this process's boot time)")
    rn.add_argument("--chaos_addrs", default="",
                    help="JSON map of gossip address -> scenario node "
                         "index (written by chaos run --live): the "
                         "exact link-identity source once joiners "
                         "exist; default derives identities from the "
                         "founding peer set")
    rn.add_argument("--device", default="cuda",
                    help="torch device of the node's engine (the card "
                         "by default; 'cpu' runs plain torch on the CPU)")
    rn.set_defaults(fn=cmd_run)

    sm = sub.add_parser("sim", help="batch consensus over a generated DAG")
    sm.add_argument("--nodes", type=int, default=64)
    sm.add_argument("--events", type=int, default=16384)
    sm.add_argument("--rounds", type=int, default=256)
    sm.add_argument("--seed", type=int, default=7)
    sm.add_argument("--profile", default="",
                    help="write a torch.profiler Chrome trace to this dir")
    sm.add_argument("--device", default="cuda")
    sm.set_defaults(fn=cmd_sim)

    dm = sub.add_parser("dummy", help="interactive chat client "
                        "(reference cmd/dummy_client)")
    dm.add_argument("--node_addr", default="127.0.0.1:1338",
                    help="the node's SubmitTx JSON-RPC server")
    dm.add_argument("--listen", default="127.0.0.1:1339",
                    help="where we serve the node's CommitTx calls")
    dm.add_argument("--log", default="messages.txt")
    dm.add_argument("--quiet", action="store_true",
                    help="no stdin/stdout chat; just serve commits")
    dm.set_defaults(fn=cmd_dummy)

    tnp = sub.add_parser("testnet", help="local fleet ops "
                         "(reference docker/scripts)")
    tsub = tnp.add_subparsers(dest="testnet_cmd", required=True)
    for name, hlp in (("conf", "write node datadirs + peers.json"),
                      ("run", "launch nodes + dummy apps"),
                      ("watch", "poll fleet /Stats"),
                      ("health", "one /healthz sweep + divergence table"),
                      ("trace", "stitch a tx's cross-node lineage"),
                      ("bombard", "flood random transactions")):
        sp = tsub.add_parser(name, help=hlp)
        sp.add_argument("--n", type=int, default=4)
        sp.add_argument("--dir", default="testnet-data")
        sp.add_argument("--base_port", type=int, default=12000)
        if name == "conf":
            sp.add_argument("--overwrite", action="store_true")
        if name == "health":
            sp.add_argument("--json", action="store_true")
        if name == "trace":
            sp.add_argument("txid", help="sha256 hex of the exact "
                                         "submitted tx bytes")
            sp.add_argument("--json", action="store_true")
        if name == "run":
            sp.add_argument("--heartbeat", type=int, default=10, help="ms")
            sp.add_argument("--no_clients", action="store_true")
            sp.add_argument("--interval", type=float, default=5.0)
            sp.add_argument("--device", default="cuda",
                            help="every node's --device")
        if name == "watch":
            sp.add_argument("--interval", type=float, default=2.0)
            sp.add_argument("--once", action="store_true")
        if name == "bombard":
            sp.add_argument("--rate", type=float, default=50.0, help="tx/s")
            sp.add_argument("--duration", type=float, default=10.0)
            sp.add_argument("--clients", type=int, default=1,
                            help=">1 uses the many-client harness "
                                 "(per-connection admission identities, "
                                 "overloaded-aware backoff)")
            sp.add_argument("--batch", type=int, default=1,
                            help="txs per Babble.SubmitTxBatch call "
                                 "(many-client harness only)")
        sp.set_defaults(fn=cmd_testnet)

    flp = sub.add_parser("fleet", help="multi-host fleet ops "
                         "(reference terraform/makefile + scripts)")
    fsub = flp.add_subparsers(dest="fleet_cmd", required=True)
    for name, hlp in (
        ("conf", "node datadirs + peers.json + ssh deploy scripts"),
        ("watch", "poll every host's /Stats"),
        ("scrape", "sweep every host's /metrics (Prometheus text)"),
        ("health", "sweep every host's /healthz into one fleet table "
                   "flagging epoch/lcr/digest divergence"),
        ("trace", "scrape + stitch one tx's cross-node commit lineage"),
        ("bombard", "flood transactions across the hosts"),
    ):
        sp = fsub.add_parser(name, help=hlp)
        sp.add_argument("--hosts", required=True,
                        help="file with one routable host address per "
                             "line ('host' or 'host:service_port' — the "
                             "latter for same-host fleets)")
        sp.add_argument("--dir", default="fleet-data")
        sp.add_argument("--gossip_port", type=int, default=1337)
        sp.add_argument("--submit_port", type=int, default=1338)
        sp.add_argument("--commit_port", type=int, default=1339)
        sp.add_argument("--service_port", type=int, default=8080)
        if name == "watch":
            sp.add_argument("--interval", type=float, default=2.0)
            sp.add_argument("--once", action="store_true")
        if name == "scrape":
            sp.add_argument("--json", action="store_true",
                            help="emit the sweep as a JSON row list "
                                 "instead of concatenated text")
            sp.add_argument("--spans", action="store_true",
                            help="also fetch each host's /debug/spans "
                                 "(loopback-gated hosts report kind="
                                 "'gated'); implies JSON output")
            sp.add_argument("--rollup", action="store_true",
                            help="aggregate per-node series into fleet "
                                 "sums/maxes with a divergence section "
                                 "(disagreeing babble_epoch / digest "
                                 "anchors render as warning rows)")
        if name == "health":
            sp.add_argument("--json", action="store_true")
        if name == "trace":
            sp.add_argument("txid", help="sha256 hex of the exact "
                                         "submitted tx bytes")
            sp.add_argument("--json", action="store_true")
        if name == "bombard":
            sp.add_argument("--rate", type=float, default=50.0, help="tx/s")
            sp.add_argument("--duration", type=float, default=10.0)
        sp.set_defaults(fn=cmd_fleet)

    chp = sub.add_parser("chaos", help="seeded fault injection + "
                         "consensus invariant checking "
                         "(babble_tpu_torch/chaos)")
    csub = chp.add_subparsers(dest="chaos_cmd", required=True)
    cl = csub.add_parser("list", help="list the canned scenarios")
    cl.set_defaults(fn=cmd_chaos)
    cs = csub.add_parser("show", help="print a scenario as JSON "
                         "(schema-by-example for custom plans)")
    cs.add_argument("scenario", help="canned name or scenario JSON path")
    cs.set_defaults(fn=cmd_chaos)
    cr = csub.add_parser("run", help="run a scenario and check its "
                         "invariants (exit 1 on violation)")
    cr.add_argument("scenario", help="canned name or scenario JSON path")
    cr.add_argument("--seed", type=int, default=None,
                    help="override the scenario seed (same seed = "
                         "bit-identical fault schedule + committed order)")
    cr.add_argument("--steps", type=int, default=None)
    cr.add_argument("--nodes", type=int, default=None)
    cr.add_argument("--json", action="store_true",
                    help="dump the full result (fault schedule, per-node "
                         "orders, invariant report) as JSON")
    cr.add_argument("--live", action="store_true",
                    help="run against a live subprocess testnet instead "
                         "of the deterministic in-memory cluster")
    cr.add_argument("--dir", default="chaos-data",
                    help="datadir for --live fleets")
    cr.add_argument("--device", default="cuda",
                    help="torch device of every node's engine (the card "
                         "by default; 'cpu' runs plain torch on the CPU)")
    cr.set_defaults(fn=cmd_chaos)

    # `lint` never reaches argparse — main() forwards its whole tail
    # verbatim (REMAINDER cannot capture a leading option like `lint
    # --json`); registered here only so the verb appears in --help
    sub.add_parser(
        "lint",
        help="babble-lint static analysis (see python -m "
             "babble_tpu_torch.analysis --help for the full surface)",
    )
    return p


def main(argv=None) -> int:
    # `lint` forwards verbatim BEFORE argparse sees the tail: the
    # analysis CLI owns its whole surface, and runs without torch
    raw = sys.argv[1:] if argv is None else list(argv)
    if raw and raw[0] == "lint":
        from .analysis.cli import main as lint_main

        return lint_main(raw[1:])
    args = build_parser().parse_args(raw)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
