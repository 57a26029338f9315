"""The port's live wide engine (``consensus/wide_engine.py
WideHashgraph``), ``Core(wide=True)``, wide checkpoints and snapshots,
and ``cli run --engine wide``, against the JAX package's, on the CPU.

- the JAX package's ``tests/test_wide_engine.py`` cases, each against
  JAX engines fed the same events: committed order, round received and
  consensus timestamp after every ``run_consensus``; checkpoint meta
  bytes and npz arrays equal, restorable in either package; the s_cap
  refusal before the drain; explicit-zero restore policy; fast-forward
  snapshots; a live port fleet of wide nodes;
- the two ``tests/test_registry_rebind.py`` cases and its bucket check:
  the flush and stage histograms survive engine swaps;
- mixed fleets of port and JAX ``Core(wide=True)`` in lockstep, and
  ``cli run --engine wide --wide_caps`` as two node processes that
  commit in one order.

``python -m tests.test_torch_wide_engine`` (with ``JAX_PLATFORMS=cpu``)
prints ``WIDE_ENGINE_EXPECT`` for ``chip_smoke.py`` phase 12(d): four
JAX ``Core(wide=True)`` through ``chip_smoke.WIDE_ENGINE``'s replay and
the checkpoint of core 0.
"""

import asyncio
import json
import os
import tempfile
import time

import pytest

from babble_tpu.consensus.wide_engine import WideHashgraph as JWide
from babble_tpu.crypto import keys as jkeys
from babble_tpu.net import commands as jcmd
from babble_tpu.node.core import Core as JCore
from babble_tpu.obs import Registry as JRegistry
from babble_tpu.sim.generator import random_gossip_dag as jdag
from babble_tpu.store import checkpoint as jck

from babble_tpu_torch.consensus.engine import TorchHashgraph
from babble_tpu_torch.consensus.wide_engine import WideHashgraph
from babble_tpu_torch.crypto import keys as pkeys
from babble_tpu_torch.net import InmemNetwork, Peer
from babble_tpu_torch.net import commands as pcmd
from babble_tpu_torch.node import Config, Node
from babble_tpu_torch.node.core import Core as PCore
from babble_tpu_torch.obs import Registry
from babble_tpu_torch.proxy import InmemAppProxy
from babble_tpu_torch.sim.generator import random_gossip_dag
from babble_tpu_torch.sim.replay import replay_scalars, sync_schedule
from babble_tpu_torch.store import checkpoint as pck

from .test_torch_checkpoint import _eq_files
from .test_torch_core import lockstep

CPU = "cpu"
KW = dict(verify_signatures=False, e_cap=384, s_cap=96, r_cap=32,
          n_blocks=2, auto_compact=True, seq_window=8, round_margin=1,
          compact_min=16)


def _pair(n, events, seed, **kw):
    kw = {**KW, **kw}
    jd, pd = jdag(n, events, seed=seed), random_gossip_dag(n, events,
                                                          seed=seed)
    return (JWide(jd.participants, **kw), jd,
            WideHashgraph(pd.participants, device=CPU, **kw), pd)


def _feed(engines_dags, lo, hi):
    out = []
    for eng, dag in engines_dags:
        for ev in dag.events[lo:hi]:
            eng.insert_event(ev.clone())
        out.append([(e.hex(), e.round_received, e.consensus_timestamp)
                    for e in eng.run_consensus()])
    return out


def test_wide_engine_equals_jax_and_is_a_prefix_of_fused():
    """tests/test_wide_engine.py's parity case: the port's wide engine
    commits what the JAX wide engine commits after every chunk, and its
    list stays a prefix of the port's fused engine's (the witness-set
    finality gate defers, never diverges), with the window rolling."""
    je, jd, pe, pd = _pair(8, 600, 21)
    fused = TorchHashgraph(pd.participants, verify_signatures=False,
                           e_cap=1024, s_cap=128, r_cap=64, device=CPU)
    cw, cf = [], []
    for i in range(0, 600, 64):
        want, got, f = _feed([(je, jd), (pe, pd), (fused, pd)], i, i + 64)
        assert got == want, f"diverged from JAX at chunk {i // 64}"
        cw += got
        cf += f
        assert cw == cf[:len(cw)], f"not a prefix at chunk {i // 64}"
    assert len(cw) > 200 and pe.dag.slot_base > 0
    assert pe.stream.evicted == pe.dag.slot_base == je.dag.slot_base
    assert pe.commit_digest == je.commit_digest
    assert pe.stats_snapshot() == je.stats_snapshot()
    assert pe.last_kernel_class == "throughput" and pe.last_flush_bytes \
        is None


def test_wide_checkpoints_equal_jax_and_resume_across_packages(tmp_path):
    """Checkpoint/resume: the blocked la/fd hold what evicted events
    taught, so they are saved state.  Meta bytes equal JAX's and the npz
    the same arrays; the port restores JAX's checkpoint and JAX the
    port's, and both continue committing as the engines that never
    stopped."""
    je, jd, pe, pd = _pair(8, 600, 21)
    for i in range(0, 300, 64):
        assert _feed([(pe, pd)], i, min(i + 64, 300)) == \
            _feed([(je, jd)], i, min(i + 64, 300))
    assert pe.dag.slot_base > 0
    jck.save_checkpoint(je, str(tmp_path / "j"))
    pck.save_checkpoint(pe, str(tmp_path / "p"))
    meta = _eq_files(str(tmp_path / "j"), str(tmp_path / "p"), "wide")
    assert (meta["mode"], meta["n_blocks"], meta["has_carry"]) == \
        ("wide", 2, True)
    p_from_j = pck.load_checkpoint(str(tmp_path / "j"), device=CPU)
    j_from_p = jck.load_checkpoint(str(tmp_path / "p"))
    assert pck.engine_mode(p_from_j) == "wide"
    assert p_from_j.known() == pe.known()
    assert p_from_j.consensus_events() == pe.consensus_events()
    assert p_from_j.stream.evicted == pe.stream.evicted
    assert tuple(p_from_j.stream.la_blocks.shape) == (2, 385, 4)
    for i in range(300, 600, 64):
        want = _feed([(je, jd)], i, i + 64)
        assert _feed([(pe, pd)], i, i + 64) == want
        assert _feed([(p_from_j, pd)], i, i + 64) == want
        assert _feed([(j_from_p, jd)], i, i + 64) == want
    assert p_from_j.commit_digest == pe.commit_digest == je.commit_digest


def test_wide_engine_scap_overrun_raises_before_drain():
    """A burst whose in-window chain depth overruns s_cap is refused
    before the drain, with JAX's message: the batch stays pending and the
    window untouched, and the refusal repeats."""
    je, jd, pe, pd = _pair(8, 400, 5, e_cap=1024, s_cap=16)
    for eng, dag in ((je, jd), (pe, pd)):
        for ev in dag.events:
            eng.insert_event(ev.clone())
    known = pe.known()
    with pytest.raises(ValueError, match="s_cap") as jerr:
        je.flush()
    for _ in range(2):
        with pytest.raises(ValueError, match="s_cap") as perr:
            pe.flush()
        assert str(perr.value) == str(jerr.value)
        assert len(pe.dag.pending) == 400 and pe.stream.n_live == 0
    assert pe.known() == known
    je2, jd2, pe2, pd2 = _pair(8, 400, 5, e_cap=1024)
    for i in range(0, 400, 64):
        assert _feed([(pe2, pd2)], i, i + 64) == _feed([(je2, jd2)], i,
                                                       i + 64)
    assert pe2.commit_length > 0


def test_wide_restore_honors_explicit_zero_policy():
    """policy={"seq_window": 0, "round_margin": 0} is configuration, not
    'unset' (is-None sentinels); absent keys fall back to the snapshot's
    values; both as in JAX."""
    je, jd, pe, pd = _pair(8, 200, 29)
    _feed([(je, jd), (pe, pd)], 0, 200)
    snap = pck.snapshot_bytes(pe)
    for policy in ({"seq_window": 0, "round_margin": 0},
                   {"round_margin": None}):
        p = pck.load_snapshot(snap, verify_events=False, device=CPU,
                              expected_participants=pe.participants,
                              policy=policy)
        j = jck.load_snapshot(snap, verify_events=False,
                              expected_participants=je.participants,
                              policy=policy)
        assert (p.seq_window, p.round_margin) == (j.seq_window,
                                                  j.round_margin)
        assert p.known() == pe.known()
    assert (p.seq_window, p.round_margin) == (pe.seq_window, pe.round_margin)


def test_wide_fast_forward_snapshot_round_trip():
    """Snapshots (the rolling-cache rejoin path) under local policy
    overrides: the port's snapshot loads in JAX and JAX's in the port,
    and both keep committing as the source does."""
    je, jd, pe, pd = _pair(8, 400, 23)
    for i in range(0, 300, 100):
        assert _feed([(pe, pd)], i, i + 100) == _feed([(je, jd)], i,
                                                      i + 100)
    pol = {"verify_signatures": False}
    p = pck.load_snapshot(jck.snapshot_bytes(je), verify_events=False,
                          expected_participants=pe.participants,
                          policy=pol, device=CPU)
    j = jck.load_snapshot(pck.snapshot_bytes(pe), verify_events=False,
                          expected_participants=je.participants, policy=pol)
    assert p.known() == pe.known() and j.known() == je.known()
    assert p.consensus_events() == pe.consensus_events()
    want = _feed([(je, jd)], 300, 400)
    assert _feed([(p, pd)], 300, 400) == want == _feed([(j, jd)], 300, 400)


def test_wide_node_fleet_commits_one_order():
    """Three port Nodes on the wide engine over the in-memory network
    (asyncio gossip, heartbeat): every transaction committed everywhere
    in one order, with the window rolling under the seq_window
    contract. The window rolls with gossip, and gossip under CPU load is
    slower than commits, so the fleet keeps gossiping until every proxy
    holds the 24 transactions and some node's window has rolled."""
    async def go():
        net = InmemNetwork()
        keys = [pkeys.key_from_scalar(31 + i) for i in range(3)]
        keys.sort(key=lambda k: k.pub_hex)
        ts = [net.transport() for _ in keys]
        peers = [Peer(t.local_addr(), k.pub_hex) for t, k in zip(ts, keys)]
        parts = {k.pub_hex: i for i, k in enumerate(keys)}
        proxies = [InmemAppProxy() for _ in keys]
        conf = Config.test_config(heartbeat=0.01, device=CPU)
        nodes = [Node(conf, keys[i], peers, ts[i], proxies[i],
                      engine=WideHashgraph(parts, e_cap=256, s_cap=96,
                                           r_cap=32, n_blocks=2,
                                           seq_window=8, round_margin=1,
                                           compact_min=16, device=CPU))
                 for i in range(3)]
        for nd in nodes:
            nd.init()
            nd.run_task()
        for i in range(24):
            await proxies[i % 3].submit_tx(b"tx%d" % i)
            await asyncio.sleep(0.02)
        try:
            while (min(len(p.committed) for p in proxies) < 24
                   or max(nd.core.hg.dag.slot_base for nd in nodes) == 0):
                await asyncio.sleep(0.05)
        finally:
            for nd in nodes:
                await nd.shutdown()
        orders = [p.committed[:24] for p in proxies]
        assert orders[0] == orders[1] == orders[2]
        assert sorted(orders[0]) == sorted(b"tx%d" % i for i in range(24))
        assert all(isinstance(nd.core.hg, WideHashgraph) for nd in nodes)
        return max(nd.core.hg.dag.slot_base for nd in nodes)

    assert asyncio.run(asyncio.wait_for(go(), 120)) > 0


@pytest.mark.parametrize("kinds", [("torch", "jax", "torch", "jax"),
                                   ("jax", "torch", "torch", "torch")])
def test_mixed_wide_cores_equal_jax_in_lockstep(kinds):
    """Core(wide=True) of both packages in one fleet, held step by step
    to four JAX wide Cores on the same schedule: the same diffs, heads,
    commits and digests after every pull and every consensus run."""
    steps = sync_schedule(4, 240, 3)
    ref, mix = lockstep(steps, list(kinds), replay_scalars(4, 3),
                        wide=True, wide_caps=(512, 64, 32), cache_size=64)
    hg = mix[kinds.index("torch")].hg
    assert isinstance(hg, WideHashgraph) and hg.dag.slot_base > 0
    assert hg.commit_digest == ref[kinds.index("torch")].hg.commit_digest


# ----------------------------------------------------------------------
# registry rebinds (tests/test_registry_rebind.py)

_PATTERN = [(0, 1), (1, 2), (2, 0), (1, 0), (2, 1), (0, 2)]


def _wide_cores(registry):
    keys = sorted([pkeys.key_from_scalar(41 + i) for i in range(3)],
                  key=lambda k: k.pub_hex)
    parts = {k.pub_hex: i for i, k in enumerate(keys)}
    cores = [PCore(i, keys[i], parts, cache_size=64, wide=True,
                   wide_caps=(256, 64, 32), device=CPU,
                   registry=registry if i == 0 else None)
             for i in range(3)]
    for c in cores:
        c.init()
    return keys, parts, cores


def _gossip_rounds(cores, rounds=2):
    for r in range(rounds):
        for i, (a, b) in enumerate(_PATTERN):
            diff = cores[a].diff(cores[b].known())
            cores[b].sync(cores[a].head, cores[a].to_wire(diff),
                          [f"tx{r}-{i}".encode()])
        for c in cores:
            c.run_consensus()


def test_wide_flush_series_survive_fast_forward_engine_swap():
    """A bootstrap-restored engine is rebound onto the node's registry,
    so its flush series keep observing there, under one family."""
    reg = Registry()
    keys, parts, cores = _wide_cores(reg)
    _gossip_rounds(cores)
    fam = reg.get("babble_wide_flush_seconds")
    assert fam is not None and fam.count > 0
    assert reg.get("babble_wide_stage_seconds") is not None
    restored = pck.load_snapshot(pck.snapshot_bytes(cores[0].hg),
                                 device=CPU)
    assert restored.stream.registry is not reg
    before = fam.count
    cores[0].bootstrap(restored)
    assert cores[0].hg is restored and restored.stream.registry is reg
    _gossip_rounds(cores)
    assert fam.count > before
    assert reg.exposition().count(
        "# TYPE babble_wide_flush_seconds histogram") == 1


def test_wide_engine_injected_at_boot_is_rebound():
    """The checkpoint-resume path: an engine built before the node's
    registry existed is rebound in Core.__init__."""
    keys, parts, cores = _wide_cores(None)
    _gossip_rounds(cores)
    restored = pck.load_snapshot(pck.snapshot_bytes(cores[0].hg),
                                 device=CPU)
    reg = Registry()
    resumed = PCore(0, keys[0], parts, engine=restored, registry=reg,
                    device=CPU)
    assert restored.stream.registry is reg
    resumed.add_self_event([b"resume-tx"])
    resumed.run_consensus()
    fam = reg.get("babble_wide_flush_seconds")
    assert fam is not None and fam.count > 0


def test_wide_rebind_bucket_layouts_stay_consistent():
    """The rebound histograms re-register under the JAX package's names
    and bucket layouts; a clashing layout raises, in both packages."""
    reg = Registry()
    keys, parts, cores = _wide_cores(reg)
    _gossip_rounds(cores, rounds=1)
    cores[0].bootstrap(pck.load_snapshot(pck.snapshot_bytes(cores[0].hg),
                                         device=CPU))
    with pytest.raises(ValueError, match="buckets"):
        reg.histogram("babble_wide_flush_events", "clash",
                      buckets=(1.0, 2.0))
    jreg = JRegistry()
    JWide({k: v for k, v in parts.items()}, registry=jreg, e_cap=256,
          s_cap=64, r_cap=32)
    names = ("babble_wide_flush_events", "babble_wide_flush_seconds",
             "babble_wide_stage_seconds")
    for name in names:
        assert reg.get(name).buckets == jreg.get(name).buckets, name


# ----------------------------------------------------------------------
# cli run --engine wide as a process


def test_cli_run_engine_wide_commits_in_one_order(tmp_path):
    """``python -m babble_tpu_torch.cli run --engine wide --wide_caps``
    as two node processes with their dummy apps (CPU): both boot on the
    wide engine and every app holds every transaction in one order."""
    from babble_tpu_torch import testnet as tn
    from babble_tpu_torch.proxy.jsonrpc import JsonRpcClient, b64e

    n, n_txs = 2, 8
    ports = tn.free_port_layout(n)
    runner = tn.TestnetRunner(
        str(tmp_path / "net"), n, heartbeat_ms=20, tcp_timeout_ms=1000,
        cache_size=500, ports=ports, device=CPU,
        extra_node_args=["--engine", "wide", "--wide_caps", "1024,64,32"])
    logs = [tmp_path / "net" / f"node{i}" / "messages.txt" for i in range(n)]

    def lines(i):
        return logs[i].read_text().splitlines() if logs[i].exists() else []

    def wait(pred, timeout, what):
        deadline = time.monotonic() + timeout
        while not pred():
            assert time.monotonic() < deadline, f"{what} not reached"
            time.sleep(0.2)

    txs = [b"wide-%02d" % i for i in range(n_txs)]

    async def submit():
        clients = [JsonRpcClient(ports.of(i)["submit"], timeout=15.0)
                   for i in range(n)]
        try:
            for k, tx in enumerate(txs):
                assert await clients[k % n].call(
                    "Babble.SubmitTx", b64e(tx)) is True
        finally:
            for c in clients:
                await c.close()

    with runner:
        wait(lambda: all("error" not in r for r in tn.watch_once(n, ports)),
             90, "every node's /Stats")
        asyncio.run(asyncio.wait_for(submit(), 60))
        wait(lambda: all(len(lines(i)) >= n_txs for i in range(n)), 90,
             "every app holding every transaction")
    order = lines(0)
    assert sorted(order) == sorted(tx.decode() for tx in txs)
    assert lines(1) == order


# ----------------------------------------------------------------------
# chip_smoke.py phase 12(d)'s reference


def test_chip_smokes_wide_engine_flow_equals_jax_on_a_short_replay(
        tmp_path, monkeypatch):
    """chip_smoke.wide_replay and wide_engine_summary over both packages'
    Cores on a shortened replay: the same commits and the same checkpoint
    bytes and arrays (the full replay is this file's ``main``)."""
    import chip_smoke

    monkeypatch.setitem(chip_smoke.WIDE_ENGINE, "syncs", 240)
    monkeypatch.setitem(chip_smoke.WIDE_ENGINE, "wide_caps", (512, 64, 32))
    monkeypatch.setitem(chip_smoke.WIDE_ENGINE, "cache_size", 64)
    out = []
    for core_cls, keys, cmds, save, kw in (
            (JCore, jkeys, jcmd, jck.save_checkpoint, {}),
            (PCore, pkeys, pcmd, pck.save_checkpoint,
             dict(device=CPU))):
        cores = chip_smoke.wide_replay(core_cls, keys.key_from_scalar, cmds,
                                       **kw)
        path = str(tmp_path / core_cls.__module__.split(".")[0])
        save(cores[0].hg, path)
        out.append(chip_smoke.wide_engine_summary(cores, path))
    assert out[0] == out[1]
    assert min(out[1]["commit_length"]) > 0


def main() -> None:
    import chip_smoke

    cores = chip_smoke.wide_replay(JCore, jkeys.key_from_scalar, jcmd)
    path = os.path.join(tempfile.mkdtemp(), "wide")
    jck.save_checkpoint(cores[0].hg, path)
    print("WIDE_ENGINE_EXPECT = " + json.dumps(
        chip_smoke.wide_engine_summary(cores, path), indent=4))


if __name__ == "__main__":
    main()
