"""The port's chaos data layer against the JAX package's, on the CPU.

- ``CANNED`` is the JAX catalogue, and every scenario's ``to_dict``
  round-trips to the JAX package's form;
- the injector makes the JAX injector's decisions, draw for draw, over
  every canned plan, every link and every tick (link faults, partitions,
  the WAN models, stale replays, lying timestamps, forged snapshots,
  clock drift), and folds them into the same ``schedule_fingerprint``;
- the WAN models' cases of ``tests/test_hostile_fleet.py``;
- ``FaultyTransport`` over the port's in-memory transport (the cases of
  ``tests/test_chaos_transport.py``);
- ``InvariantChecker`` gives the JAX report on the same results;
- the disk-rot draws damage the same bytes as JAX ``chaos/disk.py``
  (the cases of ``tests/test_disk_rot_draws.py``, and a real checkpoint);
- ``forge`` gives the JAX package's bytes and signature for the same
  fast-forward response.
"""

import asyncio
import dataclasses
import json
import os
import random
import shutil

import msgpack
import pytest

from babble_tpu.chaos import disk as jdisk
from babble_tpu.chaos import injector as jinjector
from babble_tpu.chaos import invariants as jinvariants
from babble_tpu.chaos import plan as jplan
from babble_tpu.chaos import scenario as jscenario
from babble_tpu.chaos import scenarios as jscenarios

from babble_tpu_torch.chaos import (
    CANNED,
    DISK_FAULT_KINDS,
    FAULT_KINDS,
    ByzantineSpec,
    FaultInjector,
    FaultPlan,
    FaultyTransport,
    InvariantChecker,
    LinkFaults,
    OutboundFaults,
    Partition,
    Scenario,
    ScenarioResult,
    canned_names,
    deterministic_keys,
    load_scenario,
)
from babble_tpu_torch.chaos import disk as pdisk
from babble_tpu_torch.chaos import injector as pinjector
from babble_tpu_torch.chaos import plan as pplan
from babble_tpu_torch.chaos.plan import KNOWN_INVARIANTS
from babble_tpu_torch.chaos.scenario import joiner_keys
from babble_tpu_torch.net.commands import SyncRequest, SyncResponse
from babble_tpu_torch.net.inmem_transport import InmemNetwork
from babble_tpu_torch.net.transport import TransportError
from babble_tpu_torch.obs import Registry

# ----------------------------------------------------------------------
# the plan model


def test_canned_catalogue_and_schema_are_the_jax_packages():
    assert CANNED == jscenarios.CANNED
    assert canned_names() == jscenarios.canned_names()
    assert FAULT_KINDS == jinjector.FAULT_KINDS
    assert DISK_FAULT_KINDS == jplan.DISK_FAULT_KINDS
    assert KNOWN_INVARIANTS == jplan.KNOWN_INVARIANTS
    for name in canned_names():
        sc = load_scenario(name)
        d = sc.to_dict()
        assert Scenario.from_dict(json.loads(json.dumps(d))).to_dict() == d
        assert d == jscenarios.load_scenario(name).to_dict(), name


def test_plan_validation_refuses_what_jax_refuses():
    bad = [
        lambda m: m.LinkFaults(drop=1.5),
        lambda m: m.LinkFaults(delay_ms=(5, 1)),
        lambda m: m.LinkFaults.from_dict({"drpo": 0.1}),
        lambda m: m.LinkFaults(ge_p_gb=1.5),
        lambda m: m.LinkFaults(bw_kbps=-1),
        lambda m: m.FaultPlan(partitions=[
            m.Partition(group=(3,), start=0, heal=10)]).validate(3),
        lambda m: m.FaultPlan(partitions=[
            m.Partition(group=(0, 1), start=0)]).validate(2),
        lambda m: m.Partition(group=(0,), start=10, heal=10),
        lambda m: m.ByzantineSpec(node=0, mode="evil"),
        lambda m: m.Scenario(name="x", invariants=("no_such",)),
        lambda m: m.DiskFaults.from_dict({"wal_melt": 1.0}),
        lambda m: m.Scenario.from_dict({"name": "x", "joiners": 1}),
    ]
    for make in bad:
        with pytest.raises(ValueError) as p:
            make(pplan)
        with pytest.raises(ValueError) as j:
            make(jplan)
        assert str(p.value) == str(j.value)


def test_crash_schedule_and_link_resolution():
    from babble_tpu_torch.chaos.plan import crash_schedule

    for name in canned_names():
        p, j = load_scenario(name), jscenarios.load_scenario(name)
        assert crash_schedule(p.plan) == jplan.crash_schedule(j.plan)
        n = p.nodes + p.joiners
        for a in range(n):
            for b in range(n):
                assert (dataclasses.asdict(p.plan.link(a, b))
                        == dataclasses.asdict(j.plan.link(a, b)))


# ----------------------------------------------------------------------
# the injector, draw for draw


def _drive(mod, plan, seed, nodes, steps, tick_seconds):
    """Every decision an injector of ``mod`` makes over ``steps`` ticks
    of ``nodes`` nodes, then its log and schedule fingerprint."""
    inj = mod.FaultInjector(plan, seed, tick_seconds=tick_seconds)
    seen = [tuple(inj.clock_drift_ns(i) for i in range(nodes))]
    for tick in range(steps):
        inj.advance_to(tick)
        for a in range(nodes):
            seen.append((inj.stale_replay(a), inj.lying_ts_offset_ns(a),
                         inj.snapshot_forge(a)))
            if inj.is_stale_replayer(a):
                seen.append(inj.stale_pick(a, 1 + tick % 8))
            for b in range(nodes):
                if a == b:
                    continue
                seen.append(inj.link_blocked(a, b))
                seen.append(dataclasses.astuple(inj.outbound(a, b)))
                seen.append(inj.bw_delay_s(a, b, 200 + (97 * tick) % 9000))
    inj.quiesce = True
    seen.append(dataclasses.astuple(inj.outbound(0, 1)))
    seen.append(inj.link_blocked(0, 1))
    rng = inj.disk_rng(0)
    seen.append([rng.random() for _ in range(4)])
    return seen, inj.log, inj.schedule_fingerprint()


@pytest.mark.parametrize("name", sorted(jscenarios.CANNED))
@pytest.mark.parametrize("seed", [1, 2])
def test_injector_draws_are_the_jax_injectors(name, seed):
    p, j = load_scenario(name), jscenarios.load_scenario(name)
    n = p.nodes + p.joiners
    got = _drive(pinjector, p.plan, seed, n, p.steps, p.tick_seconds)
    want = _drive(jinjector, j.plan, seed, n, j.steps, j.tick_seconds)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]


def test_injector_streams_are_seed_deterministic_and_link_local():
    plan = FaultPlan(default=LinkFaults(drop=0.5, duplicate=0.5,
                                        delay=0.3, reorder=0.3))
    a = FaultInjector(plan, 9)
    seq_a = [a.outbound(0, 1) for _ in range(20)]
    b = FaultInjector(plan, 9)
    seq_b = []
    for _ in range(20):
        b.outbound(1, 0)       # traffic on another link, interleaved
        seq_b.append(b.outbound(0, 1))
        b.outbound(2, 1)
    assert seq_a == seq_b
    assert seq_a != [FaultInjector(plan, 10).outbound(0, 1)
                     for _ in range(20)]
    quiet = FaultInjector(plan, 9)
    quiet.quiesce = True
    assert quiet.outbound(0, 1) == OutboundFaults()


# ----------------------------------------------------------------------
# the WAN models (tests/test_hostile_fleet.py's cases, under both)


def _wan_plans(m):
    base = m.FaultPlan(default=m.LinkFaults(drop=0.3, delay=0.3,
                                            duplicate=0.2, reorder=0.2))
    wan = m.FaultPlan(
        default=m.LinkFaults(drop=0.3, delay=0.3, duplicate=0.2,
                             reorder=0.2),
        overrides=[m.LinkOverride(
            faults=m.LinkFaults(drop=0.3, delay=0.3, duplicate=0.2,
                                reorder=0.2, bw_kbps=512, ge_p_gb=0.5,
                                ge_p_bg=0.5, ge_drop_bad=1.0),
            src=2, dst=3)],
    )
    ge = m.FaultPlan(default=m.LinkFaults(
        ge_p_gb=0.2, ge_p_bg=0.3, ge_drop_good=0.0, ge_drop_bad=1.0))
    bucket = m.FaultPlan(overrides=[m.LinkOverride(
        faults=m.LinkFaults(bw_kbps=800, bw_burst_kb=4), src=0, dst=1)])
    return base, wan, ge, bucket


def _wan_draws(m, inj_mod):
    base, wan, ge, bucket = _wan_plans(m)
    i1, i2 = inj_mod.FaultInjector(base, 17), inj_mod.FaultInjector(wan, 17)
    out = {
        "base": [dataclasses.astuple(i1.outbound(0, 1)) for _ in range(60)],
        "wan": [dataclasses.astuple(i2.outbound(0, 1)) for _ in range(60)],
        "wan23": [dataclasses.astuple(i2.outbound(2, 3))
                  for _ in range(60)],
    }
    for seed in (5, 6):
        inj = inj_mod.FaultInjector(ge, seed)
        out[f"ge{seed}"] = [inj.outbound(0, 1).drop for _ in range(200)]
        out[f"ge_log{seed}"] = inj.log
    inj = inj_mod.FaultInjector(bucket, 3)
    out["bucket"] = [inj.bw_delay_s(0, 1, 1000), inj.bw_delay_s(0, 1, 8192),
                     inj.bw_delay_s(1, 0, 10 ** 6)]
    inj.advance_to(40)
    out["bucket"] += [inj.bw_delay_s(0, 1, 3000) for _ in range(5)]
    return out


def test_wan_models_match_jax():
    got = _wan_draws(pplan, pinjector)
    assert got == _wan_draws(jplan, jinjector)
    # the properties tests/test_hostile_fleet.py pins
    assert got["base"] == got["wan"]
    a = got["ge5"]
    assert any(a) and not all(a) and a != got["ge6"]
    assert any(x and y for x, y in zip(a, a[1:]))
    rate = 800 * 125.0
    assert got["bucket"][0] == pytest.approx(1000 / rate)
    assert got["bucket"][1] > 8192 / rate and got["bucket"][2] == 0.0
    lf = LinkFaults(drop=0.1, bw_kbps=1500, bw_burst_kb=16, ge_p_gb=0.08,
                    ge_p_bg=0.3, ge_drop_good=0.02, ge_drop_bad=0.9)
    assert LinkFaults.from_dict(lf.to_dict()) == lf
    assert "bw_kbps" not in LinkFaults(drop=0.1).to_dict()


# ----------------------------------------------------------------------
# FaultyTransport over the port's in-memory transport


def _pair(plan, seed=1):
    net = InmemNetwork()
    addrs = ["inmem://t0", "inmem://t1"]
    idx = {a: i for i, a in enumerate(addrs)}
    inj = FaultInjector(plan, seed)
    t0 = FaultyTransport(net.transport(addrs[0]), inj, 0, idx)
    t1 = FaultyTransport(net.transport(addrs[1]), inj, 1, idx)
    return inj, t0, t1, addrs


def _echo_server(transport, seen):
    async def loop():
        while True:
            rpc = await transport.consumer.get()
            seen.append(rpc.command)
            rpc.respond(SyncResponse(
                from_addr=transport.local_addr(),
                head=repr(sorted(rpc.command.known.items())), events=[]))
    return asyncio.ensure_future(loop())


async def _close(*ts):
    for t in ts:
        await t.close()


def test_drop_and_partition_raise_transport_error():
    async def go():
        inj, t0, t1, addrs = _pair(FaultPlan(
            default=LinkFaults(drop=1.0),
            partitions=[Partition(group=(1,), start=10, heal=20)]))
        with pytest.raises(TransportError, match="chaos: dropped"):
            await t0.sync(addrs[1], SyncRequest(addrs[0], {}))
        inj.advance_to(10)
        with pytest.raises(TransportError, match="partitioned"):
            await t0.sync(addrs[1], SyncRequest(addrs[0], {}))
        await _close(t0, t1)
        return inj.schedule_fingerprint()

    assert asyncio.run(go()) == [(0, 1, 1, "drop"), (0, 1, 1, "partition")]


def test_inbound_partition_enforced_by_receiver_pump():
    async def go():
        inj, t0, t1, addrs = _pair(FaultPlan(
            partitions=[Partition(group=(1,), start=0, heal=None)]))
        seen = []
        server = _echo_server(t1, seen)
        await asyncio.sleep(0)
        with pytest.raises(TransportError, match="partitioned"):
            await t0.inner.sync(addrs[1], SyncRequest(addrs[0], {}))
        assert seen == []
        server.cancel()
        await _close(t0, t1)

    asyncio.run(go())


def test_duplicate_delivers_twice_but_responds_once():
    async def go():
        inj, t0, t1, addrs = _pair(FaultPlan(
            default=LinkFaults(duplicate=1.0)))
        seen = []
        server = _echo_server(t1, seen)
        resp = await t0.sync(addrs[1], SyncRequest(addrs[0], {0: 7}))
        assert resp.head == repr([(0, 7)])
        await asyncio.sleep(0.05)
        assert len(seen) == 2
        server.cancel()
        await _close(t0, t1)

    asyncio.run(go())


def test_concurrent_reorder_duplicate_never_crosses_responses():
    async def go():
        inj, t0, t1, addrs = _pair(FaultPlan(default=LinkFaults(
            duplicate=0.7, reorder=0.7, reorder_ms=(0.1, 3.0),
            delay=0.5, delay_ms=(0.1, 2.0))))
        seen = []
        server = _echo_server(t1, seen)

        async def one(i):
            resp = await t0.sync(addrs[1], SyncRequest(addrs[0], {0: i}),
                                 timeout=10.0)
            assert resp.head == repr([(0, i)])

        await asyncio.gather(*(one(i) for i in range(40)))
        assert len(seen) >= 40
        server.cancel()
        await _close(t0, t1)

    asyncio.run(go())


def test_stale_replay_answers_from_cache():
    async def go():
        inj, t0, t1, addrs = _pair(FaultPlan(byzantine=ByzantineSpec(
            node=1, mode="stale_replay", at=0, prob=1.0)))
        served = []

        async def server_loop():
            while True:
                rpc = await t1.consumer.get()
                served.append(rpc.command)
                rpc.respond(SyncResponse(from_addr=addrs[1],
                                         head=f"fresh-{len(served)}",
                                         events=[]))
        server = asyncio.ensure_future(server_loop())
        first = await t0.sync(addrs[1], SyncRequest(addrs[0], {0: 1}))
        second = await t0.sync(addrs[1], SyncRequest(addrs[0], {0: 2}))
        assert (first.head, second.head) == ("fresh-1", "fresh-1")
        assert len(served) == 1
        server.cancel()
        await _close(t0, t1)

    asyncio.run(go())


def test_instrument_rehomes_chaos_counters():
    async def go():
        inj, t0, t1, addrs = _pair(FaultPlan(default=LinkFaults(drop=1.0)))
        reg = Registry()
        t0.instrument(reg)
        fam = reg.get("babble_chaos_faults_total")
        assert fam.labels("drop").value == 0
        with pytest.raises(TransportError):
            await t0.sync(addrs[1], SyncRequest(addrs[0], {}))
        assert fam.labels("drop").value == 1
        text = reg.exposition()
        for kind in FAULT_KINDS:
            assert f'kind="{kind}"' in text
        await _close(t0, t1)

    asyncio.run(go())


def test_too_late_marker_survives_the_pump():
    async def go():
        inj, t0, t1, addrs = _pair(FaultPlan(byzantine=ByzantineSpec(
            node=1, mode="stale_replay", at=0, prob=0.0)))

        async def too_late_server():
            while True:
                rpc = await t1.consumer.get()
                rpc.respond(None, error="too_late: window moved")
        server = asyncio.ensure_future(too_late_server())
        with pytest.raises(TransportError, match="^too_late"):
            await t0.sync(addrs[1], SyncRequest(addrs[0], {}))
        server.cancel()
        await _close(t0, t1)

    asyncio.run(go())


# ----------------------------------------------------------------------
# deterministic identities


def test_scenario_keys_are_the_jax_packages():
    for seed in (1, 7, 41):
        assert ([k.pub_hex for k in deterministic_keys(seed, 4)]
                == [k.pub_hex for k in jscenario.deterministic_keys(seed, 4)])
        assert ([k.pub_hex for k in joiner_keys(seed, 2)]
                == [k.pub_hex for k in jscenario.joiner_keys(seed, 2)])
    key = deterministic_keys(7, 1)[0]
    jkey = jscenario.deterministic_keys(7, 1)[0]
    assert key.sign_digest(b"\x11" * 32) == jkey.sign_digest(b"\x11" * 32)


# ----------------------------------------------------------------------
# the invariant checker


def _result(cls, **kw):
    base = dict(
        committed={0: ["a", "b"], 1: ["a", "b"]},
        consensus={0: ["x"], 1: ["x"]},
        honest=[0, 1], alive={0, 1},
        consensus_counts_final={0: 5, 1: 5},
        fork_detected={0: True, 1: True},
    )
    base.update(kw)
    r = cls(name="t", seed=0, steps=10)
    for k, v in base.items():
        setattr(r, k, v)
    return r


#: (scenario dict, result fields): each checked by both checkers
CHECKS = [
    ({"nodes": 2, "invariants": ["prefix_agreement"]}, {}),
    ({"nodes": 2, "invariants": ["prefix_agreement"]},
     {"committed": {0: ["a", "b"], 1: ["a", "c"]}}),
    ({"nodes": 3, "invariants": ["prefix_agreement"]},
     {"committed": {0: ["a", "b", "c"], 1: ["a", "b"], 2: ["b", "d"]},
      "honest": [0, 1, 2], "alive": {0, 1, 2}, "restarted": {2},
      "consensus": {0: ["x", "y"], 1: ["y", "z"], 2: ["y"]}}),
    ({"nodes": 2, "invariants": ["liveness"], "liveness_bound": 50},
     {"heal_tick": 100, "consensus_counts_at_heal": {0: 5, 1: 5},
      "consensus_counts_at_bound": {0: 9, 1: 5}}),
    ({"nodes": 2, "invariants": ["liveness"]},
     {"consensus_counts_final": {0: 5, 1: 0}}),
    ({"nodes": 2, "invariants": ["all_committed"]},
     {"submitted": ["a", "b", "q"]}),
    ({"nodes": 3, "invariants": ["fork_detected"],
      "plan": {"byzantine": {"node": 2, "mode": "fork"}}},
     {"fork_detected": {0: True, 1: False}}),
    ({"nodes": 2, "invariants": ["fork_detected"]}, {}),
    ({"nodes": 4, "invariants": ["eviction_advanced"], "cache_size": 64,
      "plan": {"crashes": [{"node": 3, "crash": 5, "restart": 9}]}},
     {"eviction_horizons": {3: -1}, "outage_live_window_max": 900}),
    ({"nodes": 4, "invariants": ["fast_forwarded"],
      "plan": {"crashes": [{"node": 3, "crash": 5, "restart": 9}]}},
     {"restarted": {3}, "fast_forwards": {3: 0}}),
    ({"nodes": 4, "invariants": ["ff_proof_rejected"],
      "plan": {"byzantine": {"node": 1, "mode": "forge_snapshot"}}},
     {"ff_proof_rejects": {0: 0, 2: 0}}),
    ({"nodes": 2, "invariants": ["epoch_agreement"],
      "plan": {"leaves": [{"tick": 3, "node": 1, "via": 0}]}},
     {"membership_logs": {0: [(1, "leave", "p", 5)], 1: []},
      "epochs": {0: 1, 1: 0}}),
    ({"nodes": 2, "invariants": ["skew_robust_order"],
      "plan": {"clock_skew": {"max_ms": 0.4}}},
     {"noskew_committed": {0: ["b", "a"], 1: ["a", "b"]},
      "noskew_keys": {0: {"a": (2, 5), "b": (1, 5)},
                      1: {"a": (1, 5), "b": (1, 5)}}}),
]


@pytest.mark.parametrize("spec,fields", CHECKS)
def test_invariant_checker_reports_as_jax(spec, fields):
    d = {"name": "t", **spec}
    got = InvariantChecker().check(Scenario.from_dict(d),
                                   _result(ScenarioResult, **fields))
    want = jinvariants.InvariantChecker().check(
        jplan.Scenario.from_dict(d), _result(jscenario.ScenarioResult,
                                             **fields))
    assert got.to_dict() == want.to_dict()
    assert got.format() == want.format()


def test_result_json_matches_jax_for_the_same_fields():
    fields = dict(fault_schedule=[(0, 1, 0, "drop")],
                  fault_counts={"drop": 1}, submitted=["aa"],
                  restarted={1}, heal_tick=4, epochs={0: 0},
                  membership_logs={0: [(1, "join", "p", 3)]},
                  flight_dumps={0: [{"k": 1}]})
    a = _result(ScenarioResult, **fields)
    b = _result(jscenario.ScenarioResult, **fields)
    a.report = InvariantChecker().check(
        Scenario(name="t", nodes=2), a)
    b.report = jinvariants.InvariantChecker().check(
        jplan.Scenario(name="t", nodes=2), b)
    assert a.fingerprint() == b.fingerprint()
    assert json.dumps(a.to_dict()) == json.dumps(b.to_dict())


# ----------------------------------------------------------------------
# disk rot: the same bytes damaged the same way


def _write_wal(path, payloads):
    os.makedirs(path, exist_ok=True)
    blob = b"".join(pdisk._WAL_HDR.pack(len(p), 0xDEAD) + p
                    + (pdisk._WAL_HDR.pack(0, 0) if i % 3 == 2 else b"")
                    for i, p in enumerate(payloads))
    with open(os.path.join(path, "seg-00000001.wal"), "wb") as f:
        f.write(blob)


def _real_checkpoint(path):
    """A checkpoint of a port engine that committed a few rounds."""
    from babble_tpu_torch.consensus.engine import TorchHashgraph
    from babble_tpu_torch.sim.generator import random_gossip_dag
    from babble_tpu_torch.store import save_checkpoint

    g = random_gossip_dag(4, 160, seed=3)
    h = TorchHashgraph(g.participants, verify_signatures=False,
                       device="cpu", e_cap=64, auto_compact=True,
                       seq_window=16, finality_gate=True)
    for i, ev in enumerate(g.events):
        h.insert_event(ev)
        if i % 32 == 31:
            h.run_consensus()
    h.run_consensus()
    save_checkpoint(h, path)


#: the files each damaged tree starts from
def _tree(root):
    metas = {
        "small": {"version": 5, "levels": [1, 2], "carry": 0,
                  "received": [3]},
        "wide": {"version": 5, "levels": list(range(200)),
                 "carry": 1 << 40, "received": [9] * 120},
        "digest": {"version": 6, "levels": [1, 2, 3], "carry": True,
                   "digest": "ab" * 20},
    }
    for name, meta in metas.items():
        os.makedirs(os.path.join(root, name, "ckpt"))
        with open(os.path.join(root, name, "ckpt", "meta.msgpack"),
                  "wb") as f:
            f.write(msgpack.packb(meta, use_bin_type=True))
        _write_wal(os.path.join(root, name, "wal"),
                   [bytes([i]) * (4 + 30 * (name == "wide"))
                    for i in range(7)])
    os.makedirs(os.path.join(root, "rotten", "ckpt"))
    with open(os.path.join(root, "rotten", "ckpt", "meta.msgpack"),
              "wb") as f:
        f.write(b"\xc1 not msgpack at all")
    os.makedirs(os.path.join(root, "rotten", "wal"))
    with open(os.path.join(root, "rotten", "wal", "seg-00000001.wal"),
              "wb") as f:
        f.write(b"\xff" * 40)
    os.makedirs(os.path.join(root, "real"))
    _real_checkpoint(os.path.join(root, "real", "ckpt"))
    _write_wal(os.path.join(root, "real", "wal"),
               [os.urandom(20 + i) for i in range(9)])
    return list(metas) + ["rotten", "real"]


def _read_all(root):
    out = {}
    for base, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_disk_rot_draws_damage_the_same_bytes(tmp_path):
    src = str(tmp_path / "src")
    names = _tree(src)
    with open(os.path.join(src, "real", "ckpt", "meta.msgpack"), "rb") as f:
        real_meta = f.read()
    # the port's codec walks the same spans of a real meta as msgpack
    assert pdisk.meta_field_spans(real_meta) == jdisk.meta_field_spans(
        real_meta)
    assert pdisk.meta_field_spans(real_meta) is not None
    for name in names:
        for kind in DISK_FAULT_KINDS:
            for seed in range(6):
                trees = []
                for mod in (pdisk, jdisk):
                    dst = str(tmp_path / f"{mod.__name__}")
                    shutil.rmtree(dst, ignore_errors=True)
                    shutil.copytree(os.path.join(src, name), dst)
                    fired = mod._apply(kind, random.Random(seed),
                                       os.path.join(dst, "ckpt"),
                                       os.path.join(dst, "wal"))
                    trees.append((fired, _read_all(dst)))
                assert trees[0] == trees[1], (name, kind, seed)
                assert trees[0][0] is True


def test_apply_disk_faults_fires_and_records_as_jax(tmp_path):
    src = str(tmp_path / "src")
    _tree(src)
    for seed in (1, 2, 3):
        logs = []
        for pkg, plan_mod, inj_mod, disk_mod in (
                ("p", pplan, pinjector, pdisk), ("j", jplan, jinjector, jdisk)):
            dst = str(tmp_path / pkg)
            shutil.rmtree(dst, ignore_errors=True)
            shutil.copytree(os.path.join(src, "real"), dst)
            faults = plan_mod.DiskFaults(
                checkpoint_corrupt=0.7, checkpoint_truncate=0.5,
                wal_corrupt=0.5, wal_truncate=0.7)
            inj = inj_mod.FaultInjector(plan_mod.FaultPlan(), seed)
            fired = disk_mod.apply_disk_faults(
                inj, faults, 2, os.path.join(dst, "ckpt"),
                os.path.join(dst, "wal"))
            logs.append((fired, inj.log, _read_all(dst)))
        assert logs[0] == logs[1], seed


# ----------------------------------------------------------------------
# the forged snapshot


def test_forge_gives_the_jax_packages_bytes():
    from babble_tpu.chaos.forge import forge_snapshot_response as jforge
    from babble_tpu.crypto.keys import key_from_scalar as jkey_from_scalar
    from babble_tpu.net.commands import FastForwardResponse as JFFR

    from babble_tpu_torch.chaos.forge import forge_snapshot_response
    from babble_tpu_torch.consensus.engine import TorchHashgraph
    from babble_tpu_torch.crypto.keys import key_from_scalar
    from babble_tpu_torch.net.commands import FastForwardResponse
    from babble_tpu_torch.sim.generator import random_gossip_dag
    from babble_tpu_torch.store import snapshot_bytes

    g = random_gossip_dag(4, 200, seed=5)
    h = TorchHashgraph(g.participants, verify_signatures=False,
                       device="cpu", e_cap=64, auto_compact=True,
                       seq_window=16, finality_gate=True)
    for i, ev in enumerate(g.events):
        h.insert_event(ev)
        if i % 32 == 31:
            h.run_consensus()
    h.run_consensus()
    assert h.commit_length > 2
    snap = snapshot_bytes(h)
    fields = dict(from_addr="inmem://f", snapshot=snap,
                  lcr=h.last_consensus_round, position=h.commit_length,
                  digest=h.commit_digest, sig_r=1, sig_s=2, epoch=0)
    got = forge_snapshot_response(FastForwardResponse(**fields),
                                  key_from_scalar(77))
    want = jforge(JFFR(**fields), jkey_from_scalar(77))
    assert got.snapshot != snap
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    # a window too short to rewrite is served as it came
    short = FastForwardResponse(**{**fields, "snapshot": msgpack.packb(
        [msgpack.packb({"consensus": [0, ["a"]]}), b""])})
    assert forge_snapshot_response(short, key_from_scalar(77)) is short
