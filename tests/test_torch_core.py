"""The port's node ``Core`` against the JAX package's, on the CPU.

- the scripted playbook of ``tests/test_node.py`` (pulls cycling over
  fixed pairs, one transaction each) over four Cores, two of the JAX
  package and two of the port, under one logical clock, every pull
  crossing the wire as ``SyncRequest``/``SyncResponse`` bytes; a fleet of
  four JAX Cores replays the same script as the reference.  After every
  pull each Core's ``known()``, head and the diff it served equal the
  reference's; after every ``run_consensus`` the committed order and the
  commit digest do;
- a seeded replay (``sim/replay.py``) that compacts, through mixed Cores;
- the write-ahead log: a crash and a restart resume at the published
  head (``tests/test_wal.py:111``), the WAL of either package restores a
  Core of the other, and a checkpoint plus the WAL tail resumes
  (``tests/test_wal.py:306``).

Reference helper (run on the CPU, about five minutes):

    JAX_PLATFORMS=cpu python -m tests.test_torch_core

prints ``NODE_EXPECT`` for ``chip_smoke.py`` phase 8(a): four JAX Cores
through ``sync_schedule(4, 4000, 7)`` with ``run_consensus`` after every
pull, at the node's default cache size.
"""

import json

import pytest

from babble_tpu.crypto import keys as jkeys
from babble_tpu.net import commands as jcmd
from babble_tpu.node.core import Core as JCore
from babble_tpu.store import load_checkpoint as jload_checkpoint
from babble_tpu.wal import WriteAheadLog as JWal

from babble_tpu_torch.crypto import keys as pkeys
from babble_tpu_torch.net import commands as pcmd
from babble_tpu_torch.node.core import Core as PCore
from babble_tpu_torch.sim.replay import (
    LogicalClock, replay_scalars, sync_schedule,
)
from babble_tpu_torch.store import load_checkpoint, save_checkpoint
from babble_tpu_torch.wal import WriteAheadLog as PWal

CPU = "cpu"

#: chip_smoke.py phase 8(a): the replay NODE_EXPECT is made from
NODE = dict(n=4, syncs=4000, seed=7, cache_size=500)

PKG = {
    "jax": (JCore, jkeys, jcmd, JWal),
    "torch": (PCore, pkeys, pcmd, PWal),
}


def make_cores(kinds, scalars, clock, wal_dirs=None, **kw):
    """One Core per entry of ``kinds`` ("jax" or "torch"), identity i
    from ``scalars[i]``, all on ``clock``; roots minted in id order."""
    keys = [pkeys.key_from_scalar(d) for d in scalars]
    participants = {k.pub_hex: i for i, k in enumerate(keys)}
    cores = []
    for i, kind in enumerate(kinds):
        core_cls, keys_mod, _, wal_cls = PKG[kind]
        extra = dict(kw)
        if kind == "torch":
            extra["device"] = CPU
        if wal_dirs is not None:
            extra["wal"] = wal_cls(wal_dirs[i], fsync="off")
        c = core_cls(i, keys_mod.key_from_scalar(scalars[i]),
                     dict(participants), **extra)
        c.now_ns = clock
        cores.append(c)
    for c in cores:
        c.init()
    return cores


def _cmd(core):
    return pcmd if isinstance(core, PCore) else jcmd


def pull(frm, to, payload):
    """``to`` pulls from ``frm`` over the wire (each side packs with its
    own package's commands and reads the other's bytes).  Returns the
    ids of the diff ``frm`` served."""
    req = _cmd(to).SyncRequest("to", to.known())
    req = _cmd(frm).SyncRequest.unpack(req.pack())
    diff = frm.diff(req.known)
    resp = _cmd(frm).SyncResponse("frm", frm.head, frm.to_wire(diff),
                                  frm.known())
    resp = _cmd(to).SyncResponse.unpack(resp.pack())
    assert to.sync(resp.head, resp.events, payload) is True
    return [e.hex() for e in diff]


def core_view(core) -> dict:
    return dict(known=core.known(), head=core.head, seq=core.seq,
                insert_failures=core.insert_failures)


def commit_view(core) -> dict:
    hg = core.hg
    return dict(order=hg.consensus_events(), length=hg.commit_length,
                digest=hg.commit_digest,
                txs=core.consensus_transactions_count())


def lockstep(steps, kinds, scalars, consensus_every=1, **kw):
    """Run ``steps`` through the mixed fleet ``kinds`` and through four
    JAX Cores, comparing after every pull and every consensus run.
    Returns both fleets."""
    ref = make_cores(["jax"] * len(kinds), scalars, LogicalClock(), **kw)
    mix = make_cores(kinds, scalars, LogicalClock(), **kw)
    for c_ref, c_mix in zip(ref, mix):
        assert core_view(c_mix) == core_view(c_ref)
    for i, (frm, to, payload) in enumerate(steps):
        want = pull(ref[frm], ref[to], payload)
        got = pull(mix[frm], mix[to], payload)
        assert got == want, f"diff at step {i}"
        for j, (c_ref, c_mix) in enumerate(zip(ref, mix)):
            assert core_view(c_mix) == core_view(c_ref), (i, j)
        if i % consensus_every == consensus_every - 1:
            want = [e.hex() for e in ref[to].run_consensus()[0]]
            got = [e.hex() for e in mix[to].run_consensus()[0]]
            assert got == want, f"commits at step {i}"
            assert commit_view(mix[to]) == commit_view(ref[to]), i
    return ref, mix


def test_scripted_playbook_mixed_cores_equal_jax():
    """``tests/test_node.py``'s playbook on four Cores: pulls cycle over
    fixed pairs with one transaction each, consensus after every pull."""
    pattern = [(0, 1), (1, 0), (2, 1), (1, 2), (0, 2), (2, 0),
               (3, 0), (0, 3), (3, 2), (2, 3), (1, 3), (3, 1)]
    steps = [(*pattern[i % len(pattern)], [f"tx{i}".encode()])
             for i in range(48)]
    ref, mix = lockstep(steps, ["jax", "torch", "jax", "torch"],
                        replay_scalars(4, 1), e_cap=64)
    for c_ref, c_mix in zip(ref, mix):
        c_ref.run_consensus()
        c_mix.run_consensus()
        assert commit_view(c_mix) == commit_view(c_ref)
    assert all(c.hg.commit_length > 0 for c in mix)
    # the port Cores' committed prefix is the JAX Cores'
    base = mix[0].hg.consensus_events()
    for c in mix[1:]:
        got = c.hg.consensus_events()
        k = min(len(got), len(base))
        assert k > 0 and got[:k] == base[:k]


def test_seeded_replay_with_compaction_equals_jax():
    """``sim/replay.py``'s schedule (1–16 transactions of 64 bytes a
    pull) through a rolling window small enough to compact, the port
    Cores in the other seats."""
    steps = sync_schedule(4, 100, seed=3)
    ref, mix = lockstep(steps, ["torch", "jax", "torch", "jax"],
                        replay_scalars(4, 3), consensus_every=2,
                        e_cap=64, cache_size=8)
    assert all(c.hg.dag.slot_base > 0 for c in mix)
    assert sum(c.hg.commit_length for c in mix) > 0


def test_schedule_and_scalars_are_stable():
    steps = sync_schedule(4, 50, seed=7)
    assert steps == sync_schedule(4, 50, seed=7)
    assert all(frm != to and 1 <= len(p) <= 16
               and all(len(t) == 64 for t in p) for frm, to, p in steps)
    assert len({t for _, _, p in steps for t in p}) == \
        sum(len(p) for _, _, p in steps)
    pubs = [pkeys.key_from_scalar(d).pub_hex for d in replay_scalars(4, 7)]
    assert pubs == sorted(pubs)
    assert pubs == [jkeys.key_from_scalar(d).pub_hex
                    for d in replay_scalars(4, 7)]


def test_core_builds_the_byzantine_and_wide_engines_as_jax_does():
    """The byzantine engine (item 7) and the wide engine (item 8, which
    the Core refused before the port had it) are built with the JAX
    Core's knobs; a foreign engine is refused.  Renamed from
    ``test_core_refuses_the_unported_engines``, which now says the
    opposite."""
    from babble_tpu_torch.consensus.fork_engine import ForkHashgraph
    from babble_tpu_torch.consensus.wide_engine import WideHashgraph

    k = pkeys.key_from_scalar(11)
    parts = {k.pub_hex: 0}
    core = PCore(0, k, parts, byzantine=True, fork_k=3, cache_size=64,
                 fork_caps=(128, 16, 8), device=CPU)
    jcore = JCore(0, jkeys.key_from_scalar(11), parts, byzantine=True,
                  fork_k=3, cache_size=64, fork_caps=(128, 16, 8))
    assert isinstance(core.hg, ForkHashgraph) and core.byzantine
    for name in ("k", "verify_signatures", "auto_compact", "seq_window",
                 "compact_min", "round_margin", "_caps"):
        assert getattr(core.hg, name) == getattr(jcore.hg, name), name
    for kw in (dict(), dict(cache_size=64, seq_window=40,
                            wide_caps=(512, 64, 16))):
        core = PCore(0, k, parts, wide=True, device=CPU, **kw)
        jcore = JCore(0, jkeys.key_from_scalar(11), parts, wide=True, **kw)
        assert isinstance(core.hg, WideHashgraph) and not core.byzantine
        assert tuple(core.hg.cfg) == tuple(jcore.hg.cfg)
        for name in ("auto_compact", "seq_window", "round_margin",
                     "compact_min", "consensus_window", "inactive_rounds",
                     "kernel_class", "finality_gate"):
            assert getattr(core.hg, name) == getattr(jcore.hg, name), name
        assert core.hg.stream.C == jcore.hg.stream.C

    class Stranger:
        participants = parts

    with pytest.raises(NotImplementedError):
        PCore(0, k, parts, engine=Stranger(), device=CPU)


# ----------------------------------------------------------------------
# write-ahead log


def _complete_probe(core):
    for peer in ("probe-a", "probe-b", "probe-c"):
        if not core.probing:
            return
        core.probe_note(peer)


@pytest.mark.parametrize("writer,reader", [("torch", "torch"),
                                           ("jax", "torch"),
                                           ("torch", "jax")])
def test_crash_recovery_resumes_at_published_head_seq(tmp_path, writer,
                                                      reader):
    """Mint, crash (no receipt), reboot a fresh engine over the same WAL
    — in either package: the Core resumes at its true head behind the
    seq probe and the next mint extends the chain."""
    scalars = replay_scalars(3, 5)
    wal_dir = str(tmp_path / "wal")
    clock = LogicalClock()
    kinds = [writer, "torch", "torch"]
    core = make_cores(kinds, scalars, clock,
                      [wal_dir, str(tmp_path / "w1"), str(tmp_path / "w2")],
                      e_cap=256)[0]
    assert core.probing and core.head == ""
    _complete_probe(core)
    core.init()
    assert core.add_self_event([b"tx-1"])
    assert core.add_self_event([b"tx-2"])
    head, seq = core.head, core.seq
    assert seq == 2
    core.wal.abort()                       # power cut

    core_cls, keys_mod, _, wal_cls = PKG[reader]
    wal2 = wal_cls(wal_dir, fsync="off")
    assert len(wal2.recovered_events) == 3
    extra = {"device": CPU} if reader == "torch" else {}
    core2 = core_cls(0, keys_mod.key_from_scalar(scalars[0]),
                     dict(core.participants), e_cap=256, wal=wal2, **extra)
    assert (core2.head, core2.seq) == (head, seq)
    assert core2.probing and core2.mint_blocked()
    _complete_probe(core2)
    core2.now_ns = clock
    assert core2.add_self_event([b"tx-3"])
    assert core2.seq == seq + 1
    assert core2.hg.dag.events[core2.hg.dag.slot_of[core2.head]] \
        .self_parent == head


def test_peer_events_ride_the_wal_and_always_skips_the_probe(tmp_path):
    """Sync WALs the peer events (recovery rebuilds the whole window) and
    an ``always`` log that crashed clean needs no probe round."""
    scalars = replay_scalars(2, 6)
    clock = LogicalClock()
    keys = [pkeys.key_from_scalar(d) for d in scalars]
    parts = {k.pub_hex: i for i, k in enumerate(keys)}
    a = PCore(0, keys[0], dict(parts), e_cap=256, device=CPU,
              wal=PWal(str(tmp_path / "a"), fsync="always"))
    b = PCore(1, keys[1], dict(parts), e_cap=256, device=CPU)
    a.now_ns = b.now_ns = clock
    _complete_probe(a)
    a.init()
    b.init()
    assert a.sync(b.head, b.to_wire(b.diff(a.known())), [b"tx"]) is True
    a.wal.abort()
    a2 = PCore(0, keys[0], dict(parts), e_cap=256, device=CPU,
               wal=PWal(str(tmp_path / "a"), fsync="always"))
    assert len(a2.wal.recovered_events) == 3
    assert not a2.probing and not a2.mint_blocked()
    assert a2.seq == 1 and a2.head == a.head and b.head in a2.hg.dag.slot_of


def test_checkpoint_prunes_wal_and_resume_replays_the_tail(tmp_path):
    """Checkpoint + WAL tail = full state, and a JAX engine restored from
    the port's checkpoint agrees: after a prune the WAL holds only the
    post-checkpoint records, and a clean close's receipt means no probe
    on the next boot."""
    scalars = replay_scalars(3, 8)
    wal_dir, ckpt = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    clock = LogicalClock()
    keys = [pkeys.key_from_scalar(d) for d in scalars]
    parts = {k.pub_hex: i for i, k in enumerate(keys)}
    core = PCore(0, keys[0], dict(parts), e_cap=256, device=CPU,
                 wal=PWal(wal_dir, fsync="off"))
    core.now_ns = clock
    _complete_probe(core)
    core.init()
    core.add_self_event([b"pre-1"])
    save_checkpoint(core.hg, ckpt)
    core.wal.checkpointed(core.seq, core.head)
    core.add_self_event([b"post-1"])
    core.add_self_event([b"post-2"])
    head, seq = core.head, core.seq
    core.wal.abort()

    wal2 = PWal(wal_dir, fsync="off")
    assert len(wal2.recovered_events) == 2
    assert wal2.receipt_seq == 1
    core2 = PCore(0, keys[0], dict(parts), engine=load_checkpoint(
        ckpt, device=CPU), wal=wal2, device=CPU)
    assert (core2.head, core2.seq) == (head, seq)
    assert core2.hg.dag.slot_of.keys() == core.hg.dag.slot_of.keys()
    jengine = jload_checkpoint(ckpt)
    assert set(jengine.dag.slot_of) < set(core2.hg.dag.slot_of)
    core2.wal.close(core2.seq, core2.head)
    wal3 = PWal(wal_dir, fsync="off")
    assert not wal3.needs_probe and wal3.receipt_seq == seq
    wal3.abort()


# ----------------------------------------------------------------------
# the reference for chip_smoke.py phase 8(a)


def replay_summary(cores) -> dict:
    return {
        "commit_length": [c.hg.commit_length for c in cores],
        "commit_digest": [c.hg.commit_digest for c in cores],
        "consensus_txs": [c.consensus_transactions_count() for c in cores],
        "seq": [c.seq for c in cores],
    }


def chip_reference():
    """Four JAX Cores through phase 8(a)'s replay (``NODE_EXPECT``)."""
    scalars = replay_scalars(NODE["n"], NODE["seed"])
    cache = NODE["cache_size"]
    cores = make_cores(["jax"] * NODE["n"], scalars, LogicalClock(),
                       e_cap=max(cache, 64), cache_size=cache)
    steps = sync_schedule(NODE["n"], NODE["syncs"], NODE["seed"])
    for i, (frm, to, payload) in enumerate(steps):
        pull(cores[frm], cores[to], payload)
        cores[to].run_consensus()
        if i % 500 == 499:
            print(i + 1, [c.hg.commit_length for c in cores], flush=True)
    print("NODE_EXPECT = " + json.dumps(replay_summary(cores), indent=4))


def test_chip_smoke_runs_the_reference_replay():
    """chip_smoke.py cannot import the tests (they import jax): its
    replay constants must be this file's."""
    import chip_smoke

    assert chip_smoke.NODE_REPLAY == NODE


if __name__ == "__main__":
    chip_reference()
