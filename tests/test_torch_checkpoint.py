"""The port's checkpoint, snapshot and state proofs against the JAX
package's, on the CPU.

- ``meta.msgpack`` is byte-equal to the JAX package's for the same engine
  state, mid-transition and after it, and ``device.npz`` holds equal
  arrays (same names, dtypes, shapes, values; the zip bytes differ);
- a checkpoint written by either package restores in the other, and both
  restored engines extend to the same commits as the engine that never
  stopped;
- the committed golden v3/v4/v5 fixtures restore and extend under the
  port as under JAX;
- ``snapshot_bytes``/``load_snapshot`` round-trip, and hostile snapshots
  (the JAX package's cases) are refused by both packages before any
  array is materialised;
- ``load_checkpoint_tolerant`` returns ``(None, reason)`` on a truncated
  file; ``store/proof.py`` signs and verifies as the JAX package does.
"""

import io
import os

import msgpack
import numpy as np
import pytest

from babble_tpu.consensus.engine import TpuHashgraph
from babble_tpu.crypto import keys as jkeys
from babble_tpu.store import checkpoint as jck
from babble_tpu.store import proof as jproof

from babble_tpu_torch import TorchHashgraph, codec
from babble_tpu_torch.crypto import keys as pkeys
from babble_tpu_torch.sim.generator import (
    feed_churn, random_churn_dag, random_gossip_dag,
)
from babble_tpu_torch.store import checkpoint as pck
from babble_tpu_torch.store import proof as pproof

from .test_torch_churn import jax_event, live_policy, membership_view
from .test_torch_engine import _eq_engines

CPU = "cpu"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "checkpoints")

#: a join flow at capacities that need no growth (few XLA programs)
_KW = dict(e_cap=256, s_cap=64, r_cap=32, auto_compact=True, seq_window=6,
           compact_min=16, finality_gate=True)
_SCHEDULE = [(30, "join", 4, 0), (34, "join", 5, 0), (50, "forged", 6, 0),
             (150, "start", 5, 1), (170, "start", 4, 2)]


def _eq_files(jdir, pdir, label):
    with open(os.path.join(jdir, "meta.msgpack"), "rb") as f:
        jm = f.read()
    with open(os.path.join(pdir, "meta.msgpack"), "rb") as f:
        pm = f.read()
    assert pm == jm, f"{label}: meta.msgpack differs"
    with np.load(os.path.join(jdir, "device.npz")) as a, \
            np.load(os.path.join(pdir, "device.npz")) as b:
        assert a.files == b.files, label
        for k in a.files:
            x, y = a[k], b[k]
            assert x.dtype == y.dtype and x.shape == y.shape, (label, k)
            np.testing.assert_array_equal(x, y, err_msg=f"{label} {k}")
    return codec.unpackb(pm)


def _step_all(engines, dag, lo, hi):
    out = []
    for eng in engines:
        feed_churn(eng, dag, lo, hi,
                   jax_event if isinstance(eng, TpuHashgraph) else None)
        out.append([x.hex() for x in eng.run_consensus()])
    return out


def test_checkpoints_equal_jax_and_restore_across_packages(tmp_path):
    dag = random_churn_dag(4, 300, 5, _SCHEDULE)
    je = TpuHashgraph(dict(dag.participants), verify_signatures=False, **_KW)
    pe = TorchHashgraph(dict(dag.participants), verify_signatures=False,
                        device=CPU, **_KW)
    restored, marks, lo = None, [], 0
    while lo < len(dag.events):
        hi = min(lo + 32, len(dag.events))
        engines = [je, pe] + (list(restored) if restored else [])
        outs = _step_all(engines, dag, lo, hi)
        assert outs[1] == outs[0]
        _eq_engines(je, pe, f"slot {lo}")
        if restored:
            # the port's engine restored from JAX bytes and the JAX engine
            # restored from the port's commit what the unstopped ones do
            assert outs[2] == outs[3] == outs[0], f"restored, slot {lo}"
            _eq_engines(restored[1], restored[0], f"restored, slot {lo}")
            # the reject counter is a metric: checkpoints do not carry it
            want = dict(membership_view(je), membership_rejects=0)
            assert membership_view(restored[0]) == want
        mid = je.pending_membership is not None and je.membership_queue
        after = je.epoch == 2 and je.pending_membership is None
        if (mid and "mid" not in marks) or (after and "after" not in marks):
            tag = "mid" if mid else "after"
            marks.append(tag)
            jd, pd = str(tmp_path / f"j{tag}"), str(tmp_path / f"p{tag}")
            jck.save_checkpoint(je, jd)
            pck.save_checkpoint(pe, pd)
            meta = _eq_files(jd, pd, tag)
            assert meta["version"] == pck.FORMAT_VERSION == 6
            if tag == "mid":
                assert meta["pending_membership"] and meta["membership_queue"]
                restored = (live_policy(pck.load_checkpoint(jd, device=CPU)),
                            live_policy(jck.load_checkpoint(pd)))
                _eq_engines(restored[1], restored[0], "restored")
                assert restored[0].state.sp.device.type == CPU
            else:
                assert len(meta["membership_log"]) == 2
        lo = hi
    assert marks == ["mid", "after"]
    assert restored[0].commit_digest == je.commit_digest
    assert je.epoch == restored[0].epoch == 2


@pytest.mark.parametrize("version", [3, 4, 5])
def test_golden_checkpoints_restore_and_extend_as_in_jax(version, tmp_path):
    path = os.path.join(GOLDEN, f"v{version}")
    je = jck.load_checkpoint(path)
    pe = pck.load_checkpoint(path, device=CPU)
    _eq_engines(je, pe, f"golden v{version}")
    assert membership_view(pe) == membership_view(je)
    dag = random_gossip_dag(3, 72, seed=11)
    for ev in dag.events[48:]:
        je.insert_event(jax_event(ev))
        pe.insert_event(ev.clone())
    assert [x.hex() for x in pe.run_consensus()] == \
        [x.hex() for x in je.run_consensus()]
    _eq_engines(je, pe, f"golden v{version} extended")
    assert pe.commit_length > 0 and pe.commit_digest == je.commit_digest
    # the port re-saves in the current format, byte-equal to JAX's resave
    jck.save_checkpoint(je, str(tmp_path / "j"))
    pck.save_checkpoint(pe, str(tmp_path / "p"))
    assert _eq_files(str(tmp_path / "j"), str(tmp_path / "p"),
                     "resave")["version"] == 6


def _snap_engines(n=4, events=60):
    dag = random_gossip_dag(n, events, seed=11)
    je = TpuHashgraph(dict(dag.participants), verify_signatures=False,
                      e_cap=128, s_cap=32, r_cap=32)
    pe = TorchHashgraph(dict(dag.participants), verify_signatures=False,
                        device=CPU, e_cap=128, s_cap=32, r_cap=32)
    for ev in dag.events:
        je.insert_event(jax_event(ev))
        pe.insert_event(ev.clone())
    je.run_consensus()
    pe.run_consensus()
    return je, pe


def test_snapshot_round_trip_and_policy():
    je, pe = _snap_engines()
    snap = pck.snapshot_bytes(pe)
    jsnap = jck.snapshot_bytes(je)
    pm, pz = codec.unpack_pair(snap)
    jm, jz = msgpack.unpackb(jsnap, raw=False)
    assert pm == jm
    back = pck.load_snapshot(snap, verify_events=False, device=CPU,
                             expected_participants=dict(pe.participants),
                             max_caps=(1 << 22, 1 << 20, 1 << 16),
                             max_participants=4)
    jback = jck.load_snapshot(jsnap, verify_events=False)
    _eq_engines(jback, back, "snapshot")
    _eq_engines(jck.load_snapshot(snap, verify_events=False), back,
                "port bytes in JAX")
    _eq_engines(jback, pck.load_snapshot(jsnap, verify_events=False,
                                         device=CPU), "JAX bytes in port")
    assert back.commit_digest == je.commit_digest
    pol = dict(seq_window=0, auto_compact=True, inactive_rounds=0,
               consensus_window=None, verify_signatures=None)
    a = pck.load_snapshot(snap, verify_events=False, policy=pol, device=CPU)
    b = jck.load_snapshot(snap, verify_events=False, policy=pol)
    for f in ("seq_window", "auto_compact", "inactive_rounds",
              "consensus_window", "compact_min", "round_margin"):
        assert getattr(a, f) == getattr(b, f), f
    # pseudo-signed events fail verification in both
    for load in (lambda: pck.load_snapshot(snap, device=CPU),
                 lambda: jck.load_snapshot(snap)):
        with pytest.raises(ValueError, match="bad signature"):
            load()
    with pytest.raises(ValueError, match="declares 4 participants"):
        pck.load_snapshot(snap, verify_events=False, max_participants=3,
                          device=CPU)


def _mutated(snap, edit_meta=None, edit_arrays=None):
    meta_b, npz_b = codec.unpack_pair(snap)
    meta = codec.unpackb(meta_b)
    if edit_meta:
        edit_meta(meta)
    if edit_arrays:
        with np.load(io.BytesIO(npz_b)) as z:
            arrays = {k: z[k] for k in z.files}
        edit_arrays(arrays)
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        npz_b = buf.getvalue()
    return msgpack.packb([msgpack.packb(meta, use_bin_type=True), npz_b],
                         use_bin_type=True)


_SIG = ["c1" * 16, b"\x01" * 32, b"\x02" * 32]


def _set(key, value):
    def edit(meta):
        meta[key] = value
    return edit


def _cfg(i, value):
    def edit(meta):
        meta["cfg"][i] = value
    return edit


def _pending(**over):
    k = jkeys.key_from_scalar(4242)
    from babble_tpu.membership.transition import build_membership_tx

    tx = build_membership_tx("join", k, "tcp://a:1", 0)
    entry = {"kind": "join", "pub": k.pub_hex, "addr": "tcp://a:1",
             "boundary": 4, "position": 9, "tx": tx}
    entry.update(over)
    return entry


_HOSTILE = {
    "swap-participants": (None, dict(expected_participants="swap")),
    "e_cap-lie-big": (_cfg(1, 1 << 30), {}),
    "e_cap-lie-small": (_cfg(1, 64), {}),
    "ring-too-long": (_set("anchors", [[128, "ab" * 20, 2, []]] * 65), {}),
    "ring-short-entry": (_set("anchors", [[128, "ab" * 20, 2]]), {}),
    "ring-neg-pos": (_set("anchors", [[-1, "ab" * 20, 2, []]]), {}),
    "ring-short-digest": (_set("anchors", [[128, "ab", 2, []]]), {}),
    "ring-many-sigs": (_set("anchors", [[128, "ab" * 20, 2, [_SIG] * 257]]),
                       {}),
    "ring-bad-signer": (_set("anchors", [[128, "ab" * 20, 2,
                                          [["xy", 1, 2]]]]), {}),
    "ring-long-scalar": (_set("anchors", [[128, "ab" * 20, 2,
                                           [["c1" * 16, b"\xff" * 33, 2]]]]),
                         {}),
    "ring-neg-scalar": (_set("anchors", [[128, "ab" * 20, 2,
                                          [["c1" * 16, 1, -1]]]]), {}),
    "pending-contradicts": (_set("pending_membership",
                                 _pending(kind="leave")), {}),
    "pending-bad-sig": (_set("pending_membership",
                             _pending(tx=_pending()["tx"][:-8]
                                      + b"\x00" * 8)), {}),
    "queue-none": (_set("membership_queue", [None]), {}),
    "log-longer-than-epoch": (_set("membership_log", [{
        "epoch": 1, "kind": "join", "pub": "ab" * 8, "addr": "",
        "boundary": 1, "position": 1, "tx": b"x"}]), {}),
    "epoch-negative": (_set("epoch", -1), {}),
    "retired-out-of-range": (_cfg(8, [9]), {}),
    "version-string": (_set("version", "6"), {}),
    "slot-base-negative": (_set("slot_base", -5), {}),
    "digest-malformed": (_set("digest", {"len": 1, "anchor_pos": 0,
                                         "head": "zz", "anchor": None}), {}),
    "evicted-head-live": (_set("evicted_heads", [[0, 0, "ab" * 8]]), {}),
    "received-negative": (_set("received", [-1]), {}),
    "inactive-rounds-huge": (lambda m: m["policy"].__setitem__(5, 1 << 30),
                             {}),
    "missing-array": (None, dict(drop="sm")),
    "dtype-lie": (None, dict(cast=("famous", np.int32))),
}


@pytest.mark.parametrize("case", sorted(_HOSTILE))
def test_hostile_snapshots_refused_by_both(case):
    je, pe = _snap_engines(events=40)
    snap = pck.snapshot_bytes(pe)
    edit, how = _HOSTILE[case]
    edit_arrays = None
    if "drop" in how:
        edit_arrays = lambda a: a.pop(how["drop"])            # noqa: E731
    if "cast" in how:
        name, dt = how["cast"]
        edit_arrays = lambda a: a.__setitem__(                # noqa: E731
            name, a[name].astype(dt))
    hostile = _mutated(snap, edit, edit_arrays)
    kw = dict(verify_events=False, max_caps=(1 << 22, 1 << 20, 1 << 16))
    if how.get("expected_participants") == "swap":
        other = dict(pe.participants)
        first = next(iter(other))
        other[first + "ff"] = other.pop(first)
        kw["expected_participants"] = other
    with pytest.raises(ValueError) as jerr:
        jck.load_snapshot(hostile, **kw)
    with pytest.raises(ValueError) as perr:
        pck.load_snapshot(hostile, device=CPU, **kw)
    assert str(perr.value) == str(jerr.value)


def test_tolerant_load_version_gate_and_other_engines(tmp_path):
    je, pe = _snap_engines(events=30)
    path = str(tmp_path / "c")
    pck.save_checkpoint(pe, path)
    pck.save_checkpoint(pe, path)            # an atomic overwrite
    eng, err = pck.load_checkpoint_tolerant(path, device=CPU)
    assert err is None and eng.known() == pe.known()
    meta_path = os.path.join(path, "meta.msgpack")
    with open(meta_path, "rb") as f:
        raw = f.read()
    with open(meta_path, "wb") as f:
        f.write(raw[: len(raw) // 2])
    eng, err = pck.load_checkpoint_tolerant(path, device=CPU)
    jeng, jerr = jck.load_checkpoint_tolerant(path)
    assert eng is None and jeng is None and err.startswith("ValueError")
    meta = codec.unpackb(raw)
    # a fused meta tagged "byzantine" goes to the fork restore (ported
    # with the byzantine engine, ROADMAP item 7), which refuses its
    # version as the JAX package's does; "wide" is not ported (item 8)
    for version, mode, exc in ((7, None, ValueError), (1, None, ValueError),
                               (6, "byzantine", ValueError),
                               (6, "wide", NotImplementedError)):
        bad = dict(meta, version=version)
        if mode:
            bad["mode"] = mode
        with open(meta_path, "wb") as f:
            f.write(codec.packb(bad))
        with pytest.raises(exc) as perr:
            pck.load_checkpoint(path, device=CPU)
        if exc is ValueError:
            with pytest.raises(ValueError) as jerr:
                jck.load_checkpoint(path)
            assert str(perr.value) == str(jerr.value)
    with pytest.raises(NotImplementedError, match="item 8"):
        pck.load_snapshot(codec.packb([codec.packb(dict(
            meta, mode="wide", n_blocks=2)), b""]), device=CPU)
    hostile = codec.packb([codec.packb(dict(meta, mode="byzantine")), b""])
    with pytest.raises(KeyError) as jerr:
        jck.load_snapshot(hostile)
    with pytest.raises(KeyError) as perr:
        pck.load_snapshot(hostile, device=CPU)
    assert str(perr.value) == str(jerr.value)
    assert pck.engine_mode(pe) == "fused"
    with pytest.raises(NotImplementedError):
        pck.engine_mode(je)
    # the anchor ring round-trips (scalars above 64 bits as blobs)
    ring = [{"position": 128, "digest": "ab" * 20, "epoch": 2,
             "sigs": [("c1" * 16, 12345, (1 << 200) + 7)]}]
    pck.save_checkpoint(pe, path, anchors=ring)
    jck.save_checkpoint(je, str(tmp_path / "j"), anchors=ring)
    _eq_files(str(tmp_path / "j"), path, "ring")
    assert pck.load_checkpoint(path, device=CPU).restored_anchors == \
        jck.load_checkpoint(path).restored_anchors


def test_state_proofs_equal_jax():
    je, pe = _snap_engines(events=60)
    pk, jk = pkeys.key_from_scalar(99), jkeys.key_from_scalar(99)
    snap = pck.snapshot_bytes(pe)
    h = pproof.snapshot_hash(snap)
    assert h == jproof.snapshot_hash(snap)
    args = (h, 7, pe.commit_length, pe.commit_digest)
    for ep in (0, 3):
        r, s = pproof.sign_snapshot_proof(pk, *args, epoch=ep)
        assert (r, s) == jproof.sign_snapshot_proof(jk, *args, epoch=ep)
        assert pproof.verify_snapshot_proof(pk.pub_hex, *args, r, s, epoch=ep)
        assert not pproof.verify_snapshot_proof(pk.pub_hex, *args, r, s,
                                                epoch=ep + 1)
        a = pproof.sign_attestation(pk, 5, "ab" * 32, epoch=ep)
        assert a == jproof.sign_attestation(jk, 5, "ab" * 32, epoch=ep)
        assert pproof.verify_attestation(pk.pub_hex, 5, "ab" * 32, *a,
                                         epoch=ep)
        assert not pproof.verify_attestation("0x00", 5, "ab" * 32, *a,
                                             epoch=ep)
    back = pck.load_snapshot(snap, verify_events=False, device=CPU)
    for dg, pos in ((pe.commit_digest, pe.commit_length),
                    (pe.commit_digest, pe.commit_length + 1),
                    ("00" * 32, pe.commit_length)):
        assert pproof.verify_snapshot_digest(back, dg, pos) == \
            jproof.verify_snapshot_digest(je, dg, pos)
    assert pproof.verify_snapshot_digest(back, pe.commit_digest,
                                         pe.commit_length) is None
    back.consensus._items.reverse()
    assert "rewritten" in pproof.verify_snapshot_digest(
        back, pe.commit_digest, pe.commit_length)

