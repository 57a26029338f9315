"""The port's msgpack codec, crypto, wire forms and membership units
against the JAX package's, on the CPU.

- ``codec``: byte equality with ``msgpack.packb`` and value equality
  with ``msgpack.unpackb`` on seeded nested values and at every length
  and integer edge; truncated, overlong, trailing and hostile inputs
  raise ``ValueError`` without allocating from a declared length;
- ``crypto``: the port's signatures equal the JAX package's fallback
  signer's for the same key and digest, and verify under the JAX
  package's ``cryptography`` backend and back;
- wire forms and ``Event.sign``/``verify``;
- ``membership``: parsing and signature checks on the JAX package's own
  cases, ``replay_log``/``verify_membership_chain``/``check_log_entry``,
  the quorum helpers;
- ``ops/epoch.py`` and ``repack_round_bits_np``/``config_from_fields``
  on a small engine's state, with the aliasing hazard pinned.
"""

import hashlib

import msgpack
import numpy as np
import pytest
import torch

from babble_tpu.consensus.engine import TpuHashgraph
from babble_tpu.core import event as jevent
from babble_tpu.crypto import _fallback as jfb
from babble_tpu.crypto import keys as jkeys
from babble_tpu.membership import epoch as jepoch
from babble_tpu.membership import quorum as jquorum
from babble_tpu.membership import transition as jtx
from babble_tpu.ops import epoch as jops_epoch
from babble_tpu.ops import state as jstate
from babble_tpu.sim.generator import random_gossip_dag as jgossip

from babble_tpu_torch import codec, TorchHashgraph
from babble_tpu_torch.membership import quorum
from babble_tpu_torch.consensus import engine as pengine
from babble_tpu_torch.core import event as pevent
from babble_tpu_torch.crypto import _fallback as pfb
from babble_tpu_torch.crypto import keys as pkeys
from babble_tpu_torch.membership import epoch as pepoch
from babble_tpu_torch.membership import transition as ptx
from babble_tpu_torch.ops import epoch as pops_epoch
from babble_tpu_torch.ops import state as pstate

CPU = "cpu"


# ----------------------------------------------------------------------
# codec


_INTS = [0, 1, 31, 32, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
         2**63 - 1, 2**63, 2**64 - 1, -1, -31, -32, -33, -127, -128, -129,
         -32768, -32769, -2**31, -2**31 - 1, -2**63]
_LENS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


def _random_value(rng, depth=0):
    kind = int(rng.integers(0, 9 if depth < 4 else 6))
    if kind == 0:
        return [None, True, False][int(rng.integers(0, 3))]
    if kind == 1:
        return _INTS[int(rng.integers(0, len(_INTS)))]
    if kind == 2:
        return int(rng.integers(-2**62, 2**62))
    if kind == 3:
        return "é" * int(rng.integers(0, 3)) + "x" * int(rng.choice(_LENS[:7]))
    if kind == 4:
        return rng.bytes(int(rng.choice(_LENS[:8])))
    if kind == 5:
        return ""
    n = int(rng.choice([0, 1, 3, 15, 16, 17]))
    if kind == 6:
        return [_random_value(rng, depth + 1) for _ in range(n)]
    if kind == 7:
        return tuple(_random_value(rng, depth + 1) for _ in range(n))
    return {f"k{i}" if i % 3 else i: _random_value(rng, depth + 1)
            for i in range(n)}


def _listed(v):
    """What msgpack decodes ``v`` to (tuples become lists)."""
    if isinstance(v, (list, tuple)):
        return [_listed(x) for x in v]
    if isinstance(v, dict):
        return {k: _listed(x) for k, x in v.items()}
    return v


@pytest.mark.parametrize("seed", range(3))
def test_codec_equals_msgpack_on_seeded_values(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        v = _random_value(rng)
        want = msgpack.packb(v, use_bin_type=True)
        assert codec.packb(v) == want
        back = msgpack.unpackb(want, raw=False, strict_map_key=False)
        assert codec.unpackb(want, strict_map_key=False) == back \
            == _listed(v)


def test_codec_edges_equal_msgpack():
    objs = list(_INTS)
    for n in _LENS:
        objs += ["s" * n, b"b" * n, list(range(n)) if n < 70000 else [],
                 {str(i): i for i in range(n)} if n <= 256 else {}]
    objs += [{"a": None, 1: [True, (2, b"3")]}, {(): 1} if False else {},
             1.5, -0.25]
    for o in objs:
        raw = msgpack.packb(o, use_bin_type=True)
        if not isinstance(o, float):
            assert codec.packb(o) == raw
        assert codec.unpackb(raw, strict_map_key=False) == msgpack.unpackb(
            raw, raw=False, strict_map_key=False)
    # float32 decodes as msgpack does
    f32 = b"\xca" + np.float32(0.1).byteswap().tobytes()
    assert codec.unpackb(f32) == msgpack.unpackb(f32)


@pytest.mark.parametrize("bad", [
    b"",                                   # nothing
    b"\x92\x01",                           # array short an element
    b"\xc6\xff\xff\xff\xff\x00",           # bin32 declaring 4 GiB
    b"\xdd\xff\xff\xff\xff",               # array32 declaring 2^32 elements
    b"\xdf\x7f\xff\xff\xff\x01",           # map32 declaring 2^31 pairs
    b"\xdb\x00\x00\x01\x00abc",            # str32 short
    b"\xcd\x01",                           # uint16 short
    b"\x01\x02",                           # trailing byte
    b"\xc1",                               # never-used type byte
    b"\xa2\xff\xfe",                       # invalid utf-8
    b"\x81\x91\x01\x02",                   # unhashable map key
    b"\x91" * 200 + b"\xc0",               # nesting past the bound
], ids=lambda b: b[:8].hex() or "empty")
def test_codec_refuses_bad_input(bad):
    with pytest.raises(ValueError):
        codec.unpackb(bad)
    if len(bad) < 100:
        with pytest.raises(Exception):
            msgpack.unpackb(bad, raw=False, strict_map_key=False)


def test_codec_refuses_unencodable_and_pairs():
    for bad in (1.5, 2**64, -2**63 - 1, np.int32(1), {1, 2}, object()):
        with pytest.raises((TypeError, OverflowError)):
            codec.packb(bad)
    assert codec.unpack_pair(codec.packb([b"a", b"b"])) == (b"a", b"b")
    for bad in ([b"a"], {"a": 1}, 3):
        with pytest.raises(ValueError, match="pair"):
            codec.unpack_pair(codec.packb(bad))
    with pytest.raises(TypeError):
        codec.unpackb("text")
    # ext types: msgpack returns an ExtType that every later type check
    # refuses; the port's decoder refuses it outright
    assert isinstance(msgpack.unpackb(b"\xd4\x01\x00"), msgpack.ExtType)
    with pytest.raises(ValueError, match="0xd4"):
        codec.unpackb(b"\xd4\x01\x00")


@pytest.mark.parametrize("key", [1, -3, 2**40, 1.5, None, True, [1],
                                 "k", b"k"],
                         ids=lambda k: type(k).__name__ + repr(k)[:6])
@pytest.mark.parametrize("nested", [False, True])
def test_codec_strict_map_key_equals_msgpack(key, nested):
    """msgpack's ``strict_map_key``, both ways: under its default True
    only str and bytes keys decode.  The port refuses the key before it
    reads the value, so a map whose value is truncated is refused for
    its key; msgpack reports the truncation, and both refuse."""
    if isinstance(key, list):
        body = b"\x81\x91\x01"               # {[1]: ...}
    else:
        body = b"\x81" + msgpack.packb(key, use_bin_type=True)
    whole = body + b"\x05"
    if nested:
        body, whole = b"\x92\x01" + body, b"\x92\x01" + whole
    if isinstance(key, (str, bytes)):
        for strict in (True, False):
            want = msgpack.unpackb(whole, raw=False, strict_map_key=strict)
            assert codec.unpackb(whole, strict_map_key=strict) == want
        assert codec.unpackb(whole) == want
        return
    with pytest.raises(ValueError):
        msgpack.unpackb(body + b"\xcd\x01", raw=False)
    with pytest.raises(ValueError, match="not allowed for map key"):
        codec.unpackb(body + b"\xcd\x01")
    if not isinstance(key, list):
        with pytest.raises(ValueError) as jerr:
            msgpack.unpackb(whole, raw=False)
        with pytest.raises(ValueError) as perr:
            codec.unpackb(whole)
        assert str(perr.value) == str(jerr.value)
    # the snapshot's outer pair keeps the default too
    with pytest.raises(ValueError):
        codec.unpack_pair(whole if nested else b"\x92" + whole + b"\x01")
    if isinstance(key, list):
        # unhashable: refused under either option, as msgpack does
        with pytest.raises(ValueError):
            codec.unpackb(whole, strict_map_key=False)
        return
    want = msgpack.unpackb(whole, raw=False, strict_map_key=False)
    assert codec.unpackb(whole, strict_map_key=False) == want


def test_codec_checkpoint_meta_reads_accept_int_keys(tmp_path):
    """The checkpoint meta reads are the one place the JAX package passes
    ``strict_map_key=False`` (``store/checkpoint.py:985``, ``:1111``),
    and a meta with an int-keyed map still loads there, while the
    snapshot's outer pair keeps the default."""
    meta = {"cfg": {"n": 1}, 7: {3: b"x"}}
    raw = msgpack.packb(meta, use_bin_type=True)
    assert codec.unpackb(raw, strict_map_key=False) == msgpack.unpackb(
        raw, raw=False, strict_map_key=False)
    with pytest.raises(ValueError):
        codec.unpackb(raw)
    pair = msgpack.packb([raw, b"npz"], use_bin_type=True)
    assert codec.unpack_pair(pair) == (raw, b"npz")
    hostile = msgpack.packb([{1: 2}, b"npz"], use_bin_type=True)
    with pytest.raises(ValueError):
        codec.unpack_pair(hostile)
    with pytest.raises(ValueError):
        msgpack.unpackb(hostile, raw=False)
    from babble_tpu_torch.store import checkpoint as pckpt

    with pytest.raises(ValueError):
        pckpt.load_snapshot(hostile, device=CPU)


# ----------------------------------------------------------------------
# crypto


def _scalar(i):
    return int.from_bytes(hashlib.sha256(b"k%d" % i).digest(), "big") \
        % (pfb.N - 1) + 1


def test_signatures_equal_the_jax_fallback_and_cross_verify():
    assert pfb.N == jfb.N and pkeys.P256_ORDER == jkeys.P256_ORDER
    for i in range(6):
        pk, jk = pkeys.key_from_scalar(_scalar(i)), \
            jkeys.key_from_scalar(_scalar(i))
        assert pk.pub_bytes == jk.pub_bytes and pk.pub_hex == jk.pub_hex
        for j in range(3):
            d = hashlib.sha256(b"msg%d-%d" % (i, j)).digest()
            r, s = pk.sign_digest(d)
            assert (r, s) == jk.sign_digest(d)
            # the JAX package's cryptography-backed key verifies the
            # port's signature, and the port verifies a random-nonce one
            hz = jkeys.from_pub_bytes(pk.pub_bytes)
            assert jkeys.verify(hz, d, r, s)
            assert not jkeys.verify(hz, d, r, s ^ 1)
    gk = jkeys.generate_key()
    d = hashlib.sha256(b"random nonce").digest()
    r, s = gk.sign_digest(d)
    pub = pkeys.from_pub_bytes(gk.pub_bytes)
    assert pkeys.verify(pub, d, r, s)
    assert not pkeys.verify(pub, hashlib.sha256(b"other").digest(), r, s)
    assert not pkeys.verify(pub, d[:31], r, s)
    assert not pkeys.verify(pub, d, 0, s)
    g = pkeys.generate_key()
    assert pkeys.verify(g.public, d, *g.sign_digest(d))
    with pytest.raises(ValueError):
        pkeys.key_from_scalar(0)
    with pytest.raises(ValueError):
        pkeys.from_pub_bytes(b"\x04" + bytes(64))
    assert pkeys.pub_hex_to_bytes("0xAB01") == b"\xab\x01" == \
        jkeys.pub_hex_to_bytes("0XAB01")
    assert pkeys.sha256(b"x") == jkeys.sha256(b"x")


def _pair_events(key, jkey, txs, parents=("", ""), index=0, ts=5):
    p = pevent.new_event(txs, parents, key.pub_bytes, index, ts)
    j = jevent.new_event(txs, parents, jkey.pub_bytes, index, ts)
    p.sign(key)
    j.sign(jkey)
    return p, j


def test_events_sign_verify_and_wire_forms_equal_jax():
    key, jk = pkeys.key_from_scalar(_scalar(9)), \
        jkeys.key_from_scalar(_scalar(9))
    p, j = _pair_events(key, jk, [b"a", b"\x00" * 40])
    assert p.hex() == j.hex() and (p.r, p.s) == (j.r, j.s)
    assert p.verify() and j.verify()
    tampered = pevent.Event(body=pevent.EventBody(
        [b"b"], "", "", key.pub_bytes, 5, 0), r=p.r, s=p.s)
    assert not tampered.verify()
    assert not pevent.Event(body=p.body, r=p.r).verify()
    junk = pevent.Event(body=pevent.EventBody(
        [], "", "", b"\x04" + bytes(64), 5, 0), r=1, s=1)
    assert not junk.verify()

    w = p.to_wire(3, 1, 7, 2)
    jw = j.to_wire(3, 1, 7, 2)
    assert w.pack() == jw.pack()
    packed = codec.packb(w.pack())
    assert packed == msgpack.packb(jw.pack(), use_bin_type=True)
    back = pevent.WireEvent.unpack(codec.unpackb(packed))
    assert back == w
    assert jevent.WireEvent.unpack(codec.unpackb(packed)) == jw
    fw = pevent.FullWireEvent.from_event(p)
    jfw = jevent.FullWireEvent.from_event(j)
    assert fw.pack() == jfw.pack()
    assert fw.to_event().hex() == p.hex()
    assert pevent.FullWireEvent.unpack(codec.unpackb(codec.packb(
        fw.pack()))).to_event().hex() == p.hex()
    bad = fw.pack()
    bad[3] = 2**40                     # an int where bytes belong
    with pytest.raises(TypeError):
        pevent.FullWireEvent.unpack(bad)


def test_quorum_helpers_equal_jax():
    for n in range(0, 70):
        for f in ("supermajority", "sync_quorum", "attestation_quorum",
                  "coin_period"):
            assert getattr(quorum, f)(n) == getattr(jquorum, f)(n), (f, n)


# ----------------------------------------------------------------------
# membership transactions and the epoch ledger


def _keys(n, tag):
    return [(pkeys.key_from_scalar(_scalar(1000 * len(tag) + i)),
             jkeys.key_from_scalar(_scalar(1000 * len(tag) + i)))
            for i in range(n)]


def test_membership_tx_bytes_parse_and_verify_equal_jax():
    assert ptx.MEMBERSHIP_MAGIC == jtx.MEMBERSHIP_MAGIC
    assert pengine.MEMBERSHIP_QUEUE_MAX == pepoch.PIPELINE_WINDOW \
        == jepoch.PIPELINE_WINDOW and pepoch.MAX_LOG == jepoch.MAX_LOG
    (key, jk), (other, jo) = _keys(2, "tx")
    for kind, addr, ep in (("join", "tcp://host:1234", 3),
                           ("leave", "", 0), ("join", "a" * 256, 2**32 - 1)):
        tx = ptx.build_membership_tx(kind, key, addr, ep)
        assert tx == jtx.build_membership_tx(kind, jk, addr, ep)
        spec, jspec = ptx.parse_membership_tx(tx), jtx.parse_membership_tx(tx)
        assert spec.__dict__ == jspec.__dict__
        assert spec.verify() and jspec.verify()
        assert spec.signing_digest() == jspec.signing_digest()
        forged = ptx.MembershipTx(spec.kind, other.pub_hex, spec.net_addr,
                                  spec.epoch, spec.sig_r, spec.sig_s)
        assert not forged.verify()
        flipped = ptx.MembershipTx(
            "leave" if kind == "join" else "join", spec.pub_hex,
            spec.net_addr, spec.epoch, spec.sig_r, spec.sig_s)
        assert not flipped.verify()
    # a cryptography-signed (random nonce) transition verifies in the port
    gk = jkeys.generate_key()
    assert ptx.parse_membership_tx(
        jtx.build_membership_tx("join", gk, "x", 1)).verify()
    with pytest.raises(ValueError):
        ptx.build_membership_tx("evict", key, "x", 0)
    m = ptx.MEMBERSHIP_MAGIC
    good_body = codec.packb(["join", key.pub_hex, "a", 1, bytes(32),
                             bytes(32)])
    cases = [b"", b"ordinary client payload", m, m + b"\xff\xff\xff",
             m + b"\x91\xa4junk", bytearray(m + good_body), 12345,
             m + good_body + b"\x00",
             m + codec.packb(["kick", key.pub_hex, "a", 1, bytes(32),
                              bytes(32)]),
             m + codec.packb(["join", "0x12", "a", 1, bytes(32), bytes(32)]),
             m + codec.packb(["join", key.pub_hex, "a" * 257, 1, bytes(32),
                              bytes(32)]),
             m + codec.packb(["join", key.pub_hex, "a", -1, bytes(32),
                              bytes(32)]),
             m + codec.packb(["join", key.pub_hex, "a", True, bytes(32),
                              bytes(32)]),
             m + codec.packb(["join", key.pub_hex, "a", 1, bytes(31),
                              bytes(32)]),
             m + codec.packb(["join", key.pub_hex, "a", 1, 5, bytes(32)])]
    for c in cases:
        got, want = ptx.parse_membership_tx(c), jtx.parse_membership_tx(c)
        assert (got is None) == (want is None), c
        if got is not None:
            assert got.__dict__ == want.__dict__
            assert not got.verify() and not want.verify()


def _entry(kind, key, addr, epoch_applied, tx_epoch, build):
    return {
        "epoch": epoch_applied, "kind": kind, "pub": key.pub_hex,
        "addr": addr, "boundary": 5 * epoch_applied,
        "position": 10 * epoch_applied,
        "tx": build(kind, key, addr, tx_epoch),
    }


class _FakeEngine:
    def __init__(self, participants, retired, epoch, log, base=0):
        self.participants = participants
        self.cfg = pstate.DagConfig(n=len(participants), e_cap=8, s_cap=4,
                                    r_cap=4, retired=retired)
        self.epoch = epoch
        self.membership_log = log
        self.membership_base_epoch = base


def _outcome(fn, *a):
    try:
        return ("ok", fn(*a))
    except ValueError as e:
        return ("err", str(e))


def test_replay_log_and_chain_verification_equal_jax():
    pairs = _keys(7, "chain")
    base_p = sorted(pairs[:4], key=lambda kk: kk[0].pub_hex)
    base = {k.pub_hex: i for i, (k, _) in enumerate(base_p)}
    joiner, joiner2 = pairs[4], pairs[5]

    def both(kind, idx_pair, addr, applied, stamped):
        k, j = idx_pair
        pe = _entry(kind, k, addr, applied, stamped, ptx.build_membership_tx)
        je = _entry(kind, j, addr, applied, stamped, jtx.build_membership_tx)
        assert pe == je
        return pe

    log = [both("join", joiner, "tcp://j:1", 1, 0),
           both("leave", base_p[2], "tcp://x:1", 2, 1)]
    window = pepoch.PIPELINE_WINDOW
    logs = {
        "good": log,
        "pipelined": [both("join", joiner, "w", 1, 0),
                      both("join", joiner2, "w", 2, 0)],
        "future stamp": [both("join", joiner, "w", 1, 5)],
        "old stamp": [both("join", joiner, "w", window + 2, 0)],
        "skip": [both("join", joiner, "w", 2, 0)],
        "stale": [both("join", joiner, "tcp://j:1", 1, 3)],
        "tampered": [{**log[0], "pub": pairs[6][0].pub_hex}],
        "redirected": [{**log[0], "addr": "tcp://attacker:666"}],
        "rejoin": [log[0], both("join", joiner, "w", 2, 1)],
        "leave non-member": [both("leave", pairs[6], "w", 1, 0)],
        "double leave": [log[1] | {"epoch": 1},
                         both("leave", base_p[2], "tcp://x:1", 2, 1)],
        "garbage tx": [{**log[0], "tx": b"\x00junk"}],
        "malformed": [{**log[0], "kind": "kick"}],
        "too long": [log[0]] * (pepoch.MAX_LOG + 1),
    }
    for name, entries in logs.items():
        got = _outcome(pepoch.replay_log, base, (), entries, 0)
        want = _outcome(jepoch.replay_log, base, (), entries, 0)
        assert got == want, name
    for from_epoch in (0, 1, 2):
        assert _outcome(pepoch.replay_log, base, (), log, from_epoch) == \
            _outcome(jepoch.replay_log, base, (), log, from_epoch)

    participants = dict(base)
    participants[joiner[0].pub_hex] = 4
    engines = [
        (base, 0, _FakeEngine(participants, (2,), 2, log)),
        (base, 0, _FakeEngine({**base, pairs[6][0].pub_hex: 4}, (), 1, [])),
        (base, 0, _FakeEngine(participants, (), 1, logs["stale"])),
        (base, 0, _FakeEngine(participants, (), 1, logs["redirected"])),
        (base, 3, _FakeEngine(participants, (2,), 2, log)),
        (base, 0, _FakeEngine(participants, (), 2, log)),
        (base, 0, _FakeEngine(participants, (2,), 3, log)),
        (base, 0, _FakeEngine(participants, (2,), 2, log, base=1)),
        (base, 0, _FakeEngine(base, (), 0, [])),
    ]
    for trusted, base_epoch, eng in engines:
        got = pepoch.verify_membership_chain(trusted, (), base_epoch, eng)
        want = jepoch.verify_membership_chain(trusted, (), base_epoch, eng)
        assert got == want
    assert pepoch.verify_membership_chain(base, (), 0, engines[0][2]) is None

    hostile = [None, 3, {}, {**log[0], "epoch": 0},
               {**log[0], "epoch": True}, {**log[0], "boundary": -1},
               {**log[0], "position": 1 << 49}, {**log[0], "tx": "str"},
               {**log[0], "tx": b"x" * 4097}, {**log[0], "addr": 5}, log[0]]
    for e in hostile:
        assert pepoch.check_log_entry(e) == jepoch.check_log_entry(e)


# ----------------------------------------------------------------------
# ops/epoch.py and the state helpers


def _tiny_states(n=4, events=40, seed=9):
    """A JAX engine's state after one run_consensus, and the port's copy
    of it."""
    dag = jgossip(n, events, seed=seed)
    eng = TpuHashgraph(dag.participants, verify_signatures=False,
                       e_cap=256, s_cap=64, r_cap=16)
    for ev in dag.events:
        eng.insert_event(ev.clone())
    eng.run_consensus()
    cfg = pstate.DagConfig(**eng.cfg._asdict())
    return eng, cfg, pstate.state_from_numpy(cfg, eng.state, device=CPU)


def _eq_arrays(want, got, label):
    assert set(want) == set(got), label
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (label, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{label} {k}")


@pytest.mark.parametrize("n", [4, 8])
def test_epoch_transition_arrays_equal_jax(n):
    eng, cfg, ps = _tiny_states(n=n, events=40 * n)
    lcr = int(eng.state.lcr)
    assert lcr >= 2, "test DAG too shallow"
    jn = eng.cfg._replace(n=eng.cfg.n + 1)
    pn = cfg._replace(n=cfg.n + 1)
    a = {k: np.asarray(getattr(eng.state, k)) for k in jstate.DagState._fields}
    _eq_arrays(jops_epoch.widen_arrays(eng.cfg, jn, a),
               pops_epoch.widen_arrays(cfg, pn,
                                         pstate.state_to_numpy(ps)._asdict()),
               "widen")
    with pytest.raises(ValueError, match="widen"):
        pops_epoch.widen_arrays(pn, cfg, a)
    for new_j, new_p in ((jn, pn),
                         (eng.cfg._replace(retired=(1,)),
                          cfg._replace(retired=(1,)))):
        for boundary in (lcr - 1, lcr):
            want = jops_epoch.epoch_transition_arrays(
                eng.cfg, new_j, eng.state, boundary)
            got = pops_epoch.epoch_transition_arrays(cfg, new_p, ps, boundary)
            _eq_arrays(want, got, f"{new_p} B={boundary}")
    if n == 8:
        # the join moves the packed lane count from 1 to 2
        assert got["mbr"].shape[1] == 1
        assert pops_epoch.epoch_transition_arrays(
            cfg, pn, ps, lcr)["mbr"].shape[1] == 2
    with pytest.raises(ValueError, match="outside the round window"):
        pops_epoch.epoch_transition_arrays(cfg, pn, ps, cfg.r_cap + 5)


def test_epoch_upload_does_not_alias_the_host_image():
    """Hazard (d): the re-shaped host image passes untouched fields
    through as views of the old state's host copy; the engine's upload
    copies them, so mutating the image (or the old state) afterwards
    leaves the new state as it was."""
    eng, cfg, ps = _tiny_states()
    new = cfg._replace(n=cfg.n + 1)
    a = pops_epoch.epoch_transition_arrays(cfg, new, ps, int(eng.state.lcr))
    st = pstate.state_from_numpy(new, pstate.DagState(**a), device=CPU)
    before = {k: getattr(st, k).clone() for k in st._fields}
    for k, v in a.items():
        if v.ndim:
            v[...] = 0
        for t in ps:
            assert not np.shares_memory(v, t.numpy())
    for t in ps:
        if t.dtype != torch.bool:
            t.fill_(3)
    for k in st._fields:
        assert torch.equal(getattr(st, k), before[k]), k


def test_state_helpers_equal_jax():
    eng, cfg, ps = _tiny_states()
    for fields in (list(eng.cfg), list(eng.cfg)[:9],
                   list(eng.cfg._replace(retired=(2, 0)))[:9] + [True]):
        fields = [list(f) if isinstance(f, tuple) else f for f in fields]
        j, p = jstate.config_from_fields(fields), \
            pstate.config_from_fields(fields)
        assert j._asdict() == p._asdict() and isinstance(p.retired, tuple)
        assert hash(p) is not None
    for n in (4, 9, 16):
        jc = eng.cfg._replace(n=n)
        pc = cfg._replace(n=n)
        rng = np.random.default_rng(n)
        wslot = rng.integers(-1, cfg.e_cap + 1, (cfg.r_cap + 1, n)).astype(
            np.int32)
        famous = rng.integers(0, 3, (cfg.r_cap + 1, n)).astype(np.int8)
        mbit = rng.random(cfg.e_cap + 1) < 0.5
        for a, b in zip(jstate.repack_round_bits_np(jc, wslot, famous, mbit),
                        pstate.repack_round_bits_np(pc, wslot, famous, mbit)):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)


def test_engine_add_participant_and_validation_equal_jax():
    """The projected-set checks of _validate_membership on both engines,
    transaction by transaction (each scheduled as if committed)."""
    pairs = _keys(6, "val")
    founders = pairs[:3]
    parts = {k.pub_hex: i for i, (k, _) in enumerate(founders)}
    je = TpuHashgraph(dict(parts), e_cap=64, verify_signatures=False)
    pe = TorchHashgraph(dict(parts), e_cap=64, verify_signatures=False,
                        device=CPU)

    class _Ev:
        def __init__(self, txs, rr):
            self.transactions = txs
            self.round_received = rr

    seq = [("join", 3, 0), ("join", 3, 0), ("leave", 0, 0), ("leave", 1, 1),
           ("leave", 0, 2), ("join", 4, 3), ("join", 4, 9), ("leave", 5, 0)]
    for i, (kind, who, ep) in enumerate(seq):
        k, j = pairs[who]
        pt = ptx.build_membership_tx(kind, k, f"inmem://{who}", ep)
        assert pt == jtx.build_membership_tx(kind, j, f"inmem://{who}", ep)
        je._maybe_schedule_membership(_Ev([pt], 2 + i))
        pe._maybe_schedule_membership(_Ev([pt], 2 + i))
        for f in ("pending_membership", "membership_queue",
                  "membership_rejects"):
            assert getattr(pe, f) == getattr(je, f), (i, f)
    assert pe.membership_rejects > 0 and pe.membership_queue
    cid = pe.dag.add_participant(pairs[5][0].pub_hex)
    assert cid == 3 and len(pe.dag.chains) == 4
    assert pe.participants[pairs[5][0].pub_hex] == 3
    with pytest.raises(ValueError, match="already known"):
        pe.dag.add_participant(pairs[5][0].pub_hex)


# ----------------------------------------------------------------------
# churn flows with leaves (the joins are in tests/test_torch_churn.py)


@pytest.mark.parametrize("name", ["leave", "floor"])
def test_churn_leave_flows_equal_jax_per_call(name):
    from .test_torch_churn import _TINY, check_flow

    if name == "leave":
        # a leave, then a join stamped with the epoch it has left behind
        je, seen = check_flow(
            5, 300, 6, [(40, "leave", 2, 0), (150, "join", 5, 0),
                        (200, "stop", 2, 0)],
            24, None, dict(finality_gate=True, **_TINY),
            dict(epoch=1, n=5, retired=(2,), rejects=1))
        assert "latency" in seen
    else:
        # three founders: a leave applies, the next is refused at the
        # 2-member floor; ungated, on the throughput surface
        je, seen = check_flow(
            3, 360, 8, [(30, "leave", 2, 0), (100, "stop", 2, 0),
                        (140, "leave", 1, 1)],
            30, None, dict(kernel_class="throughput", **_TINY),
            dict(epoch=1, n=3, retired=(2,), rejects=1))
        assert seen >= {"throughput"}


def _map_encoded_join(real_churn_tx):
    """``_churn_tx`` with every join's body re-encoded as a msgpack map
    whose six keys are its six fields in order, each with the value 0.
    The epoch key is an int, which msgpack's default decode refuses."""
    def churn_tx(action, member, epoch, keys):
        tx = real_churn_tx(action, member, epoch, keys)
        if action != "join":
            return tx
        body = msgpack.unpackb(tx[len(ptx.MEMBERSHIP_MAGIC):], raw=False)
        return ptx.MEMBERSHIP_MAGIC + msgpack.packb(
            {field: 0 for field in body}, use_bin_type=True)
    return churn_tx


def test_churn_map_encoded_join_is_refused_as_in_jax(monkeypatch):
    """A join whose body is a msgpack map is garbage to the JAX package
    (its parse decodes with msgpack's default ``strict_map_key=True``)
    and must be garbage to the port too: one reject, nothing pending,
    the peer set unchanged, and the same commits after every call."""
    from babble_tpu_torch.sim import generator as pgen

    from .test_torch_churn import _TINY, _flow

    monkeypatch.setattr(pgen, "_churn_tx", _map_encoded_join(pgen._churn_tx))
    je, seen = _flow(4, 300, 5, [(30, "join", 4, 0)], chunk=24,
                     finality_gate=True, **_TINY)
    assert (je.membership_rejects, je.pending_membership, je.epoch,
            je.cfg.n) == (1, None, 0, 4)
    assert je.commit_length > 0 and "compact" in seen
    dag = pgen.random_churn_dag(4, 300, 5, [(30, "join", 4, 0)])
    tx = next(t for ev in dag.events for t in ev.transactions)
    assert jtx.parse_membership_tx(tx) is None
    assert ptx.parse_membership_tx(tx) is None
