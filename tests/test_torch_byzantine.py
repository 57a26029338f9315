"""The port's byzantine Cores and fork checkpoints against the JAX
package's, on the CPU.

- a mixed fleet of two JAX and two port byzantine ``Core``s over the
  wire (each side packs with its own ``net/commands.py``), with an
  equivocator, held step by step to four JAX Cores: the same diffs,
  heads, insert failures and committed order;
- the byzantine Core's edges (bad signature, the equal-count diff wedge
  healing itself, a sync skipping a bad event, stats that never touch
  the device, merge-skip, the per-creator backoff), each on both
  packages with the same outcome;
- fork checkpoints: meta bytes equal across the packages, a port engine
  restored from a JAX checkpoint and the reverse, windowed resume, the
  Core resuming its head, and every hostile meta refused by both
  packages with the same message.
"""

import random

import numpy as np
import pytest

from babble_tpu.consensus.fork_engine import ForkHashgraph as JForkHashgraph
from babble_tpu.core import event as jevent
from babble_tpu.crypto import keys as jkeys
from babble_tpu.net import commands as jcmd
from babble_tpu.node.core import Core as JCore
from babble_tpu.sim import generator as jgen
from babble_tpu.store import checkpoint as jck

from babble_tpu_torch import codec
from babble_tpu_torch.consensus.fork_engine import ForkHashgraph
from babble_tpu_torch.core import event as pevent
from babble_tpu_torch.crypto import keys as pkeys
from babble_tpu_torch.net import commands as pcmd
from babble_tpu_torch.node.core import Core as PCore
from babble_tpu_torch.sim import generator as pgen
from babble_tpu_torch.sim.replay import LogicalClock, replay_scalars
from babble_tpu_torch.store import checkpoint as pck

CPU = "cpu"
PKG = {"jax": (JCore, jkeys, jcmd, jevent),
       "torch": (PCore, pkeys, pcmd, pevent)}


def _pkg(core):
    return PKG["torch" if isinstance(core, PCore) else "jax"]


def make_cores(kinds, scalars, clock=None, **kw):
    """One byzantine Core per entry of ``kinds``, identity i from
    ``scalars[i]``, roots minted in id order."""
    keys = [pkeys.key_from_scalar(d) for d in scalars]
    participants = {k.pub_hex: i for i, k in enumerate(keys)}
    cores = []
    for i, kind in enumerate(kinds):
        core_cls, keys_mod, _, _ = PKG[kind]
        extra = dict(kw, byzantine=True)
        if kind == "torch":
            extra["device"] = CPU
        c = core_cls(i, keys_mod.key_from_scalar(scalars[i]),
                     dict(participants), **extra)
        if clock is not None:
            c.now_ns = clock
        cores.append(c)
    for c in cores:
        c.init()
    return cores


def pull(frm, to, payload=()):
    """``to`` pulls from ``frm`` over the wire; returns (diff ids, minted)."""
    req = _pkg(to)[2].SyncRequest("to", to.known())
    req = _pkg(frm)[2].SyncRequest.unpack(req.pack())
    diff = frm.diff(req.known)
    resp = _pkg(frm)[2].SyncResponse("frm", frm.head, frm.to_wire(diff),
                                     frm.known())
    resp = _pkg(to)[2].SyncResponse.unpack(resp.pack())
    assert all(type(w).__name__ == "FullWireEvent" for w in resp.events)
    minted = to.sync(resp.head, resp.events, list(payload))
    return [e.hex() for e in diff], minted


def view(core) -> dict:
    return dict(known=core.known(), head=core.head, seq=core.seq,
                insert_failures=core.insert_failures,
                error=core.last_insert_error,
                backoff=dict(core._creator_backoff))


def fork_events(core, key_scalar, base_hex, index, others):
    """Two signed equivocating children of ``base_hex`` (one per entry
    of ``others``, the other-parent of each), minted with ``core``'s
    package on its clock."""
    _, keys_mod, _, ev_mod = _pkg(core)
    key = keys_mod.key_from_scalar(key_scalar)
    out = []
    for tag, other in zip((b"branch-a", b"branch-b"), others):
        ev = ev_mod.new_event([tag], (base_hex, other), key.pub_bytes, index,
                              timestamp=core.now_ns())
        ev.sign(key)
        out.append(ev)
    return out


def test_mixed_fleet_with_an_equivocator_commits_one_order():
    """Two JAX and two port byzantine Cores, node 3 equivocating once,
    held after every pull and every consensus run to four JAX Cores."""
    scalars = replay_scalars(4, 5)
    ref = make_cores(["jax"] * 4, scalars, LogicalClock())
    mix = make_cores(["jax", "torch", "jax", "torch"], scalars,
                     LogicalClock())
    for fleet in (ref, mix):
        _warm(fleet)
        # node 3 forks off its root: one branch planted at node 0, the
        # other at node 1, as a two-faced peer would
        byz = fleet[3]
        root = byz.hg.dag.events[byz.hg.dag.cr_events[3][0]]
        a, b = fork_events(byz, scalars[3], root.hex(), 1,
                           (fleet[0].head, fleet[1].head))
        fleet[0].insert_event(a)
        fleet[1].insert_event(b)
    assert [view(c) for c in mix] == [view(c) for c in ref]
    rng = random.Random(7)
    for step in range(150):
        frm, to = rng.sample(range(4), 2)
        payload = [f"tx{step}".encode()]
        assert pull(mix[frm], mix[to], payload) == \
            pull(ref[frm], ref[to], payload), step
        assert [view(c) for c in mix] == [view(c) for c in ref], step
        if step % 10 == 9:
            for c_ref, c_mix in zip(ref[:3], mix[:3]):
                want = [e.hex() for e in c_ref.run_consensus()[0]]
                got = [e.hex() for e in c_mix.run_consensus()[0]]
                assert got == want, step
                assert c_mix.hg.commit_digest == c_ref.hg.commit_digest
    for c_ref, c_mix in zip(ref[:3], mix[:3]):
        c_ref.run_consensus()
        c_mix.run_consensus()
        assert c_mix.stats_snapshot() == c_ref.stats_snapshot()
        # the fork is visible on the stats surface of every honest node
        assert c_mix.stats_snapshot()["forked_creators"] == 1
        assert c_mix.hg.consensus_events() == c_ref.hg.consensus_events()
    lists = [c.hg.consensus_events() for c in mix[:3]]
    m = min(len(x) for x in lists)
    assert m > 10, [len(x) for x in lists]
    assert all(x[:m] == lists[0][:m] for x in lists)


def test_fullwire_events_cross_the_packages():
    mix = make_cores(["torch", "jax"], replay_scalars(2, 3), LogicalClock())
    pull(mix[0], mix[1])
    pull(mix[1], mix[0])
    for frm, to in ((mix[0], mix[1]), (mix[1], mix[0])):
        diff = frm.diff({0: 0, 1: 0})
        resp = _pkg(frm)[2].SyncResponse("x", frm.head, frm.to_wire(diff),
                                          frm.known())
        back = _pkg(to)[2].SyncResponse.unpack(resp.pack())
        assert back.pack() == resp.pack()
        evs = [to.hg.read_wire_info(w) for w in back.events]
        assert [e.hex() for e in evs] == [e.hex() for e in diff]
        assert all(e.verify() for e in evs)


def test_byzantine_core_rejects_bad_signature():
    errs = []
    for kind in ("jax", "torch"):
        core = make_cores([kind, kind], replay_scalars(2, 3))[0]
        _, keys_mod, _, ev_mod = PKG[kind]
        stranger = keys_mod.key_from_scalar(999)
        ev = ev_mod.new_event([], ("", ""), stranger.pub_bytes, 0,
                              timestamp=5)
        ev.sign(stranger)
        with pytest.raises(ValueError) as err:
            core.insert_event(ev)
        errs.append(str(err.value))
    assert errs[0] == errs[1]


def _warm(fleet):
    for a in range(len(fleet)):
        for b in range(len(fleet)):
            if a != b:
                pull(fleet[a], fleet[b])


@pytest.mark.parametrize("kinds", [["jax"] * 4, ["torch", "jax", "torch",
                                                 "jax"]])
def test_byzantine_diff_self_heals_equal_count_wedge(kinds):
    """Two peers holding equally-sized but different event sets for a
    forked creator: the tip exchange makes the wedge detectable and the
    detected-fork resend heals it, with the JAX package's diffs."""
    scalars = replay_scalars(4, 9)
    ref = make_cores(["jax"] * 4, scalars, LogicalClock())
    mix = make_cores(kinds, scalars, LogicalClock())
    for fleet in (ref, mix):
        _warm(fleet)
        tip0 = fleet[0].hg.dag.events[fleet[0].hg.dag.cr_events[3][-1]]
        tip1 = fleet[1].hg.dag.events[fleet[1].hg.dag.cr_events[3][-1]]
        assert tip0.hex() == tip1.hex()
        a, b = fork_events(fleet[3], scalars[3], tip0.hex(), tip0.index + 1,
                           (fleet[0].head, fleet[1].head))
        fleet[0].insert_event(a)
        fleet[1].insert_event(b)
        assert fleet[0].hg._fork_suffix_start(3) is None
        assert fleet[0].known()[3] == fleet[1].known()[3]
        assert a.hex() in [e.hex() for e in fleet[0].diff(fleet[1].known())]
    assert pull(mix[0], mix[1]) == pull(ref[0], ref[1])
    assert mix[1].hg._fork_suffix_start(3) is not None
    assert pull(mix[1], mix[0]) == pull(ref[1], ref[0])
    for c_mix, c_ref in zip(mix[:2], ref[:2]):
        assert view(c_mix) == view(c_ref)
        hexes = {c_mix.hg.dag.events[s].hex()
                 for s in c_mix.hg.dag.cr_events[3]}
        assert len(hexes) == len(c_mix.hg.dag.cr_events[3])
        assert c_mix.hg._fork_suffix_start(3) is not None


@pytest.mark.parametrize("kind", ["jax", "torch"])
def test_byzantine_sync_skips_bad_events(kind):
    """A fork-budget violation in a sync response must not drop the
    valid events of other creators nor the merge head; the result is
    the JAX package's."""
    scalars = replay_scalars(4, 11)
    out = []
    for kinds in (["jax"] * 4, [kind] * 4):
        cores = make_cores(kinds, scalars, LogicalClock())
        _warm(cores)
        pull(cores[1], cores[0])
        root = cores[3].hg.dag.events[cores[3].hg.dag.cr_events[3][0]]
        forks = fork_events(cores[3], scalars[3], root.hex(), 1,
                            (cores[0].head, cores[0].head))
        cores[0].insert_event(forks[0])
        ev_mod = _pkg(cores[1])[3]
        key = _pkg(cores[1])[1].key_from_scalar(scalars[1])
        honest = ev_mod.new_event([b"tx"], (cores[1].head, cores[0].head),
                                  key.pub_bytes, cores[1].seq + 1,
                                  timestamp=cores[1].now_ns())
        honest.sign(key)
        wire_cls = type(cores[1].to_wire([honest])[0])
        wire = [wire_cls.from_event(forks[1]), wire_cls.from_event(honest)]
        old_seq = cores[0].seq
        assert cores[0].sync(cores[1].head, wire, []) is True
        assert cores[0].insert_failures == 1
        assert "exceeded" in cores[0].last_insert_error
        assert honest.hex() in cores[0].hg.dag.slot_of
        assert cores[0].seq == old_seq + 1
        assert cores[0]._creator_backoff == {}   # a fork budget: no resync
        out.append(view(cores[0]))
    assert out[1] == out[0]


def test_byzantine_stats_never_touch_device(monkeypatch):
    core = make_cores(["torch"] * 4, replay_scalars(4, 3))[0]

    def boom(self):
        raise AssertionError("stats path triggered a device run")

    monkeypatch.setattr(ForkHashgraph, "_run", boom)
    assert core.last_consensus_round() is None
    assert core.stats_snapshot()["last_consensus_round"] == -1
    assert core.stats_snapshot()["forked_creators"] == 0


@pytest.mark.parametrize("kind", ["jax", "torch"])
def test_sync_merge_skip_reports_unminted_payload(kind):
    """A sync whose peer head is not insertable mints nothing and says
    so; a head whose parents are missing backs the creator off."""
    cores = make_cores([kind, kind], replay_scalars(2, 3), LogicalClock())
    ev_mod, keys_mod = _pkg(cores[0])[3], _pkg(cores[0])[1]
    key = keys_mod.key_from_scalar(replay_scalars(2, 3)[1])
    ghost = ev_mod.new_event([b"g"], ("ff" * 32, "ee" * 32), key.pub_bytes,
                             7, timestamp=9)
    ghost.sign(key)
    seq = cores[0].seq
    assert cores[0].sync(ghost.hex(), [], [b"precious-tx"]) is False
    assert cores[0].seq == seq
    wire = cores[1].to_wire([ghost])
    assert cores[0].sync(ghost.hex(), wire, []) is False
    assert cores[0]._creator_backoff == {1: 2}
    assert cores[0].last_insert_error == "peer head not insertable; " \
        "merge skipped"
    _, minted = pull(cores[1], cores[0], [b"precious-tx"])
    assert minted is True and cores[0].seq == seq + 1
    assert cores[0]._creator_backoff == {}


def test_gossip_backoff_capped_and_resettable():
    cores = make_cores(["torch", "torch"], replay_scalars(2, 3))
    pull(cores[1], cores[0])
    depth = len(cores[0].hg.dag.cr_events[1])
    true_count = cores[0].hg.known()[1]
    cores[0]._creator_backoff[1] = 1 << 18
    assert cores[0].known()[1] == max(0, true_count - depth)
    cores[0].reset_gossip_backoff()
    assert cores[0].known()[1] == true_count


# ----------------------------------------------------------------------
# fork checkpoints


def _engines(n=6, n_events=400, seed=13, **kw):
    dj = jgen.random_byzantine_dag(n, n_events, seed=seed, fork_rate=0.05)
    dp = pgen.random_byzantine_dag(n, n_events, seed=seed, fork_rate=0.05)
    return (dj, JForkHashgraph(dj.participants, k=2, **kw),
            dp, ForkHashgraph(dp.participants, k=2, device=CPU, **kw))


def test_fork_checkpoint_bytes_and_cross_restores(tmp_path):
    kw = dict(auto_compact=True, round_margin=1, seq_window=6,
              compact_min=16)
    dj, je, dp, pe = _engines(n_events=600, seed=11, **kw)
    half = 300
    for ev in dj.events[:half]:
        je.insert_event(ev)
    for ev in dp.events[:half]:
        pe.insert_event(ev)
    jc = [(e.hex(), e.round_received) for e in je.run_consensus()]
    pc = [(e.hex(), e.round_received) for e in pe.run_consensus()]
    assert pc == jc and pe.dag.evicted == je.dag.evicted > 0
    jck.save_checkpoint(je, str(tmp_path / "j"))
    pck.save_checkpoint(pe, str(tmp_path / "p"))
    for name in ("meta.msgpack",):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir())
    assert pck.snapshot_bytes(pe) == jck.snapshot_bytes(je)
    assert pck.engine_mode(pe) == jck.engine_mode(je) == "byzantine"

    # a port engine from the JAX checkpoint, a JAX engine from the port's
    p_from_j = pck.load_checkpoint(str(tmp_path / "j"), device=CPU)
    j_from_p = jck.load_checkpoint(str(tmp_path / "p"))
    assert isinstance(p_from_j, ForkHashgraph)
    assert p_from_j.commit_digest == j_from_p.commit_digest == pe.commit_digest
    streams = {"jax": je, "port": pe, "port<-jax": p_from_j,
               "jax<-port": j_from_p}
    got = {k: [] for k in streams}
    for i in range(half, 600, 60):
        for name, eng in streams.items():
            events = dj.events if name.startswith("jax") else dp.events
            for ev in events[i:i + 60]:
                eng.insert_event(ev.clone())
            got[name] += [(e.hex(), e.round_received)
                          for e in eng.run_consensus()]
    assert len(got["jax"]) > 100
    assert all(v == got["jax"] for v in got.values())
    assert p_from_j.known() == je.known() and p_from_j.lcr == je.lcr
    # the predicate surface of the restored engine, fork detection too
    for s in range(0, len(p_from_j.dag.events), 23):
        x = p_from_j.dag.events[s].hex()
        assert p_from_j.round(x) == je.round(x)
        assert p_from_j.witness(x) == je.witness(x)
        for cid in range(p_from_j.n):
            assert p_from_j.detects_fork(x, cid) == je.detects_fork(x, cid)


def test_fork_core_resumes_head(tmp_path):
    scalars = replay_scalars(3, 4)
    cores = make_cores(["torch"] * 3, scalars, LogicalClock(), fork_k=2)
    pull(cores[0], cores[1], [b"tx"])
    pck.save_checkpoint(cores[1].hg, str(tmp_path / "c"))
    engine = pck.load_checkpoint(str(tmp_path / "c"), device=CPU)
    resumed = PCore(1, pkeys.key_from_scalar(scalars[1]),
                    dict(cores[1].participants), engine=engine, device=CPU)
    assert resumed.byzantine
    assert (resumed.head, resumed.seq) == (cores[1].head, cores[1].seq)
    resumed.add_self_event([b"after-restart"])
    assert resumed.seq == cores[1].seq + 1
    # a JAX Core resumes from the port's checkpoint the same way
    jresumed = JCore(1, jkeys.key_from_scalar(scalars[1]),
                     dict(cores[1].participants),
                     engine=jck.load_checkpoint(str(tmp_path / "c")))
    assert (jresumed.head, jresumed.seq) == (cores[1].head, cores[1].seq)


def test_fork_bootstrap_refuses_snapshot_forking_us():
    scalars = replay_scalars(3, 6)
    for kind in ("jax", "torch"):
        cores = make_cores([kind] * 3, scalars, LogicalClock(), fork_k=2)
        ck = pck if kind == "torch" else jck
        extra = dict(device=CPU) if kind == "torch" else {}
        roots = {i: cores[i].hg.dag.events[cores[i].hg.dag.cr_events[i][0]]
                 for i in range(3)}
        for i in (0, 2):
            cores[1].insert_event(roots[i].clone())
        for ev in fork_events(cores[0], scalars[0], roots[0].hex(), 1,
                              (cores[1].head, roots[2].hex())):
            cores[1].insert_event(ev)
        snap = ck.snapshot_bytes(cores[1].hg)
        engine = ck.load_snapshot(snap, verify_events=True, **extra)
        with pytest.raises(ValueError, match="our own key"):
            cores[0].bootstrap(engine)
        cores[2].bootstrap(ck.load_snapshot(snap, verify_events=True,
                                            **extra))
        assert cores[2].head and cores[2].hg.stats_snapshot()[
            "forked_creators"] == 1


def _hostile_metas(meta):
    """(label, hostile meta) pairs: every bound ``_check_fork_meta`` and
    the restore's ancestry checks enforce."""
    ne = len(meta["events"])
    used = next(c for c, u in enumerate(meta["br_used"]) if u)
    child = next(i for i in range(ne) if meta["sp_slot"][i] >= 0)

    def lie(**kw):
        m = dict(meta)
        for k, v in kw.items():
            m[k] = v
        return m

    def at(name, i, v):
        lst = list(meta[name])
        lst[i] = v
        return lie(**{name: lst})

    yield "k", lie(k=500)
    yield "version", lie(version=1 << 20)
    yield "verify_signatures", lie(verify_signatures=1)
    yield "policy", lie(policy=[True, -1, 6, 16])
    yield "r_off", lie(r_off=-1)
    yield "rseed", at("rseed", 0, 1 << 20)
    yield "wseed", at("wseed", 0, 2)
    yield "levels length", lie(levels=meta["levels"][:-1])
    yield "sp_slot", at("sp_slot", ne - 1, ne + 7)
    yield "br_extent", at("br_extent", 0, 1 << 50)
    yield "br_div", at("br_div", used, meta["br_extent"][used] + 3)
    yield "cr_evicted negative", at("cr_evicted", 0, -1)
    yield "cr_evicted sum", at("cr_evicted", 0, int(meta["evicted"]) + 1)
    yield "levels", at("levels", child,
                       meta["levels"][meta["sp_slot"][child]])
    yield "evicted", lie(evicted=-5)
    yield "ebr", at("ebr", 0, 10 ** 6)
    yield "br_parent cycle", lie(br_parent=[1, 0] + list(meta["br_parent"][2:]))
    yield "br_events", at("br_events", used, [ne + 3])
    yield "chain_tip", lie(chain_tip=[[0, ne + 5]])
    yield "ts_clamped", lie(ts_clamped=[[0, 1 << 63]])
    yield "consensus", lie(consensus=["zz"])
    yield "consensus_transactions", lie(consensus_transactions=-1)
    yield "received", lie(received=[7])
    yield "lcr", lie(lcr=-2)
    yield "digest", lie(digest={"head": 3})
    yield "signed parent", at("sp_slot", child, -1)
    other_col = (meta["ebr"][0] + meta["k"]) % (len(meta["participants"])
                                                * meta["k"])
    yield "column owner", at("ebr", 0, other_col)


def test_fork_snapshot_hostile_metas_refused_alike():
    dj, je, dp, pe = _engines(n=5, n_events=120)
    for ev in dj.events:
        je.insert_event(ev)
    for ev in dp.events:
        pe.insert_event(ev)
    je.run_consensus()
    pe.run_consensus()
    snap = pck.snapshot_bytes(pe)
    assert snap == jck.snapshot_bytes(je)
    meta_b, npz_b = codec.unpack_pair(snap)
    meta = codec.unpackb(meta_b, strict_map_key=False)
    caps = (1 << 22, 1 << 20, 1 << 16)
    assert pck.load_snapshot(snap, verify_events=False, max_caps=caps,
                             expected_participants=pe.participants,
                             device=CPU).known() == pe.known()
    other = dict(pe.participants)
    first = next(iter(other))
    other[first + "ff"] = other.pop(first)
    cases = [("participants", snap, dict(expected_participants=other)),
             ("window bound", snap, dict(max_caps=(16, 1 << 20, 1 << 16)))]
    cases += [(label, codec.packb([codec.packb(m), npz_b]), {})
              for label, m in _hostile_metas(meta)]
    for label, data, kw in cases:
        with pytest.raises(ValueError) as jerr:
            jck.load_snapshot(data, verify_events=False, **kw)
        with pytest.raises(ValueError) as perr:
            pck.load_snapshot(data, verify_events=False, device=CPU, **kw)
        assert str(perr.value) == str(jerr.value), label
    # the untouched snapshot still restores after all that, and a tampered
    # event signature is refused when the events are verified
    assert pck.load_snapshot(snap, verify_events=False,
                             device=CPU).known() == pe.known()
    events = list(meta["events"])
    bad = list(events[3])
    bad[-1] = bytes(32)          # the signature's s scalar (FullWireEvent)
    events[3] = bad
    tampered = codec.packb([codec.packb(dict(meta, events=events)), npz_b])
    for load, kw in ((jck.load_snapshot, {}),
                     (pck.load_snapshot, dict(device=CPU))):
        with pytest.raises(ValueError):
            load(tampered, verify_events=True, **kw)
    assert np.array_equal(pe.dag.common_prefix(), je.dag.common_prefix())
