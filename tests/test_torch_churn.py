"""The port's membership plane against the JAX package's, on the CPU.

Churn flows (``sim/generator.py random_churn_dag``: real P-256
identities, signed join/leave transactions, hostile ones, joiners that
start minting and leavers that stop) go through JAX ``TpuHashgraph`` and
the port's ``TorchHashgraph`` with the same ``run_consensus`` calls, at
tiny capacities so that growth, compaction and the held-commit gate all
happen, and one flow repairs clipped rounds (``_repair_rounds``) before
its transition (``tests/test_torch_engine.py``'s flows hold repair
without churn).  After every call: committed ids, commit digest, epoch,
membership log, pending transition, queue, rejects, the config and the
live rows of every state tensor.  The flows with leaves are in
``tests/test_torch_membership.py``.

Reference helper (run on the CPU, about ten minutes):

    JAX_PLATFORMS=cpu python -m tests.test_torch_churn

prints ``CHURN_EXPECT`` and ``GOLDEN_EXPECT`` for ``chip_smoke.py``
phase 7: the JAX engine over ``random_churn_dag(64, 65536, seed=7,
CHURN_SCHEDULE)`` as a live node, with the two restarts phase 7 makes
(``save_checkpoint``/``load_checkpoint`` mid-transition,
``snapshot_bytes``/``load_snapshot`` after the third transition), and the
golden v3/v4/v5 checkpoints restored and extended.
"""

import hashlib
import json
import os
import sys
import tempfile

import pytest

from babble_tpu.consensus.engine import TpuHashgraph
from babble_tpu.core import event as jevent

from babble_tpu_torch import TorchHashgraph
from babble_tpu_torch.consensus import engine as pengine
from babble_tpu_torch.sim.generator import (
    ChurnScheduleError, feed_churn, random_churn_dag,
)

from .test_torch_engine import _eq_engines

CPU = "cpu"

#: the membership state both engines must agree on after every call
MEMBERSHIP_FIELDS = ("epoch", "pending_membership", "membership_queue",
                     "membership_log", "membership_rejects",
                     "membership_base_epoch", "membership_addrs")

#: phase 7's flow (chip_smoke.py CHURN_SCHEDULE is this list)
CHURN = dict(n=64, e=65536, seed=7, chunk=256, snap_slot=49152)
CHURN_SCHEDULE = [
    (8192, "join", 64, 0), (8448, "join", 65, 0),
    (12288, "garbage", 0, 0), (12544, "forged", 66, 0),
    (20480, "start", 64, 1), (24576, "start", 65, 2),
    (32768, "leave", 5, 2), (40960, "stop", 5, 0),
]


def jax_event(ev):
    """A JAX Event with the port event's body, r and s."""
    b = ev.body
    return jevent.Event(
        body=jevent.EventBody(list(b.transactions), b.self_parent,
                              b.other_parent, b.creator, b.timestamp,
                              b.index),
        r=ev.r, s=ev.s,
    )


def membership_view(engine) -> dict:
    return {f: getattr(engine, f) for f in MEMBERSHIP_FIELDS}


def log_summary(engine) -> list:
    """membership_log as (epoch, kind, cid, boundary, position,
    sha256(tx)[:8])."""
    return [[e["epoch"], e["kind"], e["cid"], e["boundary"], e["position"],
             hashlib.sha256(e["tx"]).hexdigest()[:8]]
            for e in engine.membership_log]


_TINY = dict(e_cap=32, s_cap=8, r_cap=4, auto_compact=True, seq_window=6,
             compact_min=16)


def _flow(n, e, seed, schedule, chunk=8, keep=None, **kw):
    """One churn flow through both engines, compared after every call,
    then drained.  Returns the JAX engine and the features seen."""
    dag = random_churn_dag(n, e, seed, schedule)
    je = TpuHashgraph(dict(dag.participants), verify_signatures=False, **kw)
    pe = TorchHashgraph(dict(dag.participants), verify_signatures=False,
                        device=CPU, **kw)
    if keep is not None:
        je.membership_log_keep = pe.membership_log_keep = keep
    seen, lo, drained = set(), 0, 0
    while drained < 2:
        hi = min(lo + chunk, e)
        feed_churn(je, dag, lo, hi, jax_event)
        feed_churn(pe, dag, lo, hi)
        want = [x.hex() for x in je.run_consensus()]
        got = [x.hex() for x in pe.run_consensus()]
        label = f"call at slot {lo}"
        assert got == want, label
        _eq_engines(je, pe, label)
        assert membership_view(pe) == membership_view(je), label
        assert pe.participants == je.participants, label
        if je.pending_membership and je.membership_queue:
            seen.add("pipelined")
        if je.pending_membership and \
                je.dag.n_events - je._ordered_total > 0:
            seen.add("pending")
        seen.add(je.last_kernel_class)
        drained += lo == hi
        lo = hi
    if je.dag.slot_base > 0:
        seen.add("compact")
    return je, seen


def check_flow(n, e, seed, schedule, chunk, keep, kw, want):
    """``_flow`` and what it must reach: ``want`` holds epoch, n, retired
    and rejects; every flow compacts and holds commits at a pending
    boundary."""
    je, seen = _flow(n, e, seed, schedule, chunk=chunk, keep=keep, **kw)
    got = dict(epoch=je.epoch, n=je.cfg.n, retired=je.cfg.retired,
               rejects=je.membership_rejects)
    assert got == want
    assert je.commit_length > 0 and "compact" in seen and "pending" in seen
    assert je.cfg.e_cap > kw["e_cap"] and je.cfg.r_cap > kw["r_cap"]
    return je, seen


@pytest.mark.parametrize("name", ["join", "pipelined"])
def test_churn_flow_equals_jax_per_call(name):
    if name == "join":
        # two pipelined joins (the second queued behind the first), a
        # forged and a garbage transaction, both joiners minting, and a
        # membership log kept to one entry
        je, seen = check_flow(
            4, 300, 5, [(30, "join", 4, 0), (34, "join", 5, 0),
                        (50, "forged", 6, 0), (56, "garbage", 0, 0),
                        (150, "start", 4, 1), (170, "start", 5, 2)],
            24, 1, dict(finality_gate=True, **_TINY),
            dict(epoch=2, n=6, retired=(), rejects=2))
        assert len(je.membership_log) == 1
        assert je.membership_base_epoch == 1
        assert len(je.membership_addrs) == 1
    else:
        # 8 -> 9 -> 10 columns (the packed lane count moves from 1 to 2),
        # then a leave retires a column
        je, seen = check_flow(
            8, 900, 5, [(40, "join", 8, 0), (48, "join", 9, 0),
                        (300, "start", 8, 1), (340, "start", 9, 2),
                        (500, "leave", 5, 2), (700, "stop", 5, 0)],
            32, None, dict(finality_gate=True, **_TINY),
            dict(epoch=3, n=10, retired=(5,), rejects=0))
    assert "pipelined" in seen and "latency" in seen


def test_churn_flow_with_round_repair_equals_jax_per_call(monkeypatch):
    """Round repair and an epoch transition in one flow: two validators
    outrun the round capacity (grown from 4 to 16), so a throughput flush
    repairs clipped rounds (``_repair_rounds``, r_cap 16 -> 32) in epoch
    0 at slot 150; then a join takes the engine to epoch 1 and the joiner
    mints.  Held to the JAX engine after every call; both engines repair
    at the same slot."""
    from babble_tpu.consensus import engine as jengine

    repairs = {"jax": [], "torch": []}
    for name, cls in (("jax", jengine.TpuHashgraph),
                      ("torch", pengine.TorchHashgraph)):
        orig = cls._repair_rounds

        def spy(self, orig=orig, log=repairs[name]):
            log.append((self.epoch, self.dag.n_events, self.cfg.r_cap))
            return orig(self)

        monkeypatch.setattr(cls, "_repair_rounds", spy)
    je, seen = _flow(2, 300, 4, [(200, "join", 2, 0), (260, "start", 2, 1)],
                     chunk=30, finality_gate=True, **_TINY)
    assert repairs["torch"] == repairs["jax"] == [(0, 150, 16)]
    assert (je.epoch, je.cfg.n, je.membership_rejects) == (1, 3, 0)
    assert je.cfg.r_cap > _TINY["r_cap"] and je.commit_length > 0
    assert {"throughput", "compact"} <= seen


def test_feed_churn_refuses_an_early_joiner():
    dag = random_churn_dag(4, 120, 3, [(40, "join", 4, 0),
                                       (60, "start", 4, 1)])
    assert dag.starts == {60: (4, 1)}
    assert [a for a, _ in dag.txs.values()] == ["join"]
    pe = TorchHashgraph(dict(dag.participants), verify_signatures=False,
                        device=CPU, e_cap=128, s_cap=32, r_cap=16)
    with pytest.raises(ChurnScheduleError, match="move slot 60 later"):
        feed_churn(pe, dag, 0, 120)
    for bad in ([(2, "join", 4, 0)], [(50, "kick", 4, 0)],
                [(50, "join", 4, 0), (50, "leave", 1, 0)]):
        with pytest.raises(ValueError):
            random_churn_dag(4, 120, 3, bad)
    assert pengine.EPOCH_LAG == 2


# ----------------------------------------------------------------------
# the reference for chip_smoke.py phase 7


def churn_flow(engine, dag, chunk, restart, convert=None, on_call=None):
    """Phase 7's flow: ``chunk`` events per ``run_consensus``, then
    drained; ``restart(engine, kind)`` returns the engine to continue
    in, called once with "files" at the first call after which a
    transition is pending and another queued, once with "bytes" at
    ``CHURN["snap_slot"]``.  Returns (engine, each call's kernel class,
    the slot of each restart and the counters the restarted engines no
    longer hold: ``COUNTERS`` summed over the engines left behind)."""
    kinds, lo, drains, marks = [], 0, 0, {}
    carried = dict.fromkeys(COUNTERS, 0)

    def restarted(engine, kind):
        marks[kind] = hi
        for k in COUNTERS:
            carried[k] += getattr(engine, k)
        return restart(engine, kind)

    e = len(dag.events)
    while True:
        hi = min(lo + chunk, e)
        feed_churn(engine, dag, lo, hi, convert)
        out = engine.run_consensus()
        kinds.append(engine.last_kernel_class)
        if on_call is not None:
            on_call(engine, out)
        if ("files" not in marks and engine.pending_membership
                and engine.membership_queue):
            engine = restarted(engine, "files")
        if "bytes" not in marks and hi == CHURN["snap_slot"]:
            engine = restarted(engine, "bytes")
        if lo >= e:
            drains += 1
            if not out or drains >= 64:     # chip_smoke.DRAIN_MAX
                break
        lo = hi
    for k in COUNTERS:
        carried[k] += getattr(engine, k)
    return engine, kinds, marks, carried


#: engine counters a restart does not carry (metrics, not state)
COUNTERS = ("membership_rejects", "flush_fallbacks")


def churn_summary(engine, kinds, marks, carried) -> dict:
    return dict(
        commit_length=engine.commit_length,
        commit_digest=engine.commit_digest,
        epoch=engine.epoch,
        membership_log=log_summary(engine),
        membership_rejects=carried["membership_rejects"],
        n=engine.cfg.n, retired=list(engine.cfg.retired),
        e_cap=engine.cfg.e_cap, r_cap=engine.cfg.r_cap,
        calls=len(kinds), latency=kinds.count("latency"),
        throughput=kinds.count("throughput"),
        flush_fallbacks=carried["flush_fallbacks"],
        evicted=engine.dag.slot_base,
        restarts=marks,
    )


def live_policy(engine):
    """What a Node sets on a restored engine (checkpoints do not carry
    the live path's gate: node/core.py _apply_live_engine_policy)."""
    engine.finality_gate = True
    return engine


def chip_reference():
    from babble_tpu.store import checkpoint as jck

    from tests.golden.make_golden_checkpoints import (
        GOLDEN_DIR, PREFIX, SPEC,
    )
    from babble_tpu_torch.sim.generator import random_gossip_dag

    # golden fixtures: restored, extended with the rest of the DAG
    golden = {}
    dag = random_gossip_dag(SPEC["n"], SPEC["n_events"], seed=SPEC["seed"])
    for v in (3, 4, 5):
        eng = jck.load_checkpoint(os.path.join(GOLDEN_DIR, f"v{v}"))
        for ev in dag.events[PREFIX:]:
            eng.insert_event(jax_event(ev))
        eng.run_consensus()
        golden[f"v{v}"] = dict(commit_length=eng.commit_length,
                               commit_digest=eng.commit_digest)
    print("GOLDEN_EXPECT = " + json.dumps(golden, indent=4), flush=True)

    dag = random_churn_dag(CHURN["n"], CHURN["e"], CHURN["seed"],
                           CHURN_SCHEDULE)
    eng = TpuHashgraph(dict(dag.participants), verify_signatures=False,
                       **pengine.node_engine_kwargs())
    tmp = tempfile.mkdtemp()

    def restart(engine, kind):
        print(f"restart {kind}: epoch {engine.epoch}, commits "
              f"{engine.commit_length}", flush=True)
        if kind == "files":
            jck.save_checkpoint(engine, os.path.join(tmp, "ckpt"))
            return live_policy(jck.load_checkpoint(os.path.join(tmp, "ckpt")))
        return live_policy(jck.load_snapshot(
            jck.snapshot_bytes(engine), verify_events=False,
            expected_participants=dict(engine.participants)))

    epochs = [0]

    def on_call(engine, out):
        if engine.epoch != epochs[-1]:
            epochs.append(engine.epoch)
            print(f"epoch {engine.epoch} at commit {engine.commit_length}: "
                  f"{engine.cfg}", flush=True)

    eng, kinds, marks, carried = churn_flow(eng, dag, CHURN["chunk"],
                                            restart, jax_event, on_call)
    out = churn_summary(eng, kinds, marks, carried)
    print("CHURN_EXPECT = " + json.dumps(out, indent=4), flush=True)


if __name__ == "__main__":
    sys.exit(chip_reference())


def test_chip_smoke_runs_the_reference_flow():
    """chip_smoke.py (which cannot import the tests: they import jax)
    keeps copies of this flow and of the golden extension; they must not
    drift from what chip_reference ran."""
    import chip_smoke

    from tests.golden.make_golden_checkpoints import PREFIX, SPEC

    assert chip_smoke.CHURN == CHURN
    assert chip_smoke.CHURN_SCHEDULE == CHURN_SCHEDULE
    assert chip_smoke.GOLDEN_DAG == dict(n=SPEC["n"], e=SPEC["n_events"],
                                         seed=SPEC["seed"], prefix=PREFIX)
    assert chip_smoke.DRAIN_MAX == 64
