"""The PyTorch port's building blocks against the JAX package, on the CPU.

Each test feeds the same numpy inputs (made from a seed) to a JAX
function and to its counterpart in ``babble_tpu_torch`` and requires
exactly equal outputs — dtypes included: every tensor here is an
integer or boolean tensor.  The port runs with ``device="cpu"``, where
every wrapper takes its plain torch version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from babble_tpu.ops import pack as jpack
from babble_tpu.ops import state as jstate
from babble_tpu.ops.pallas_ingest import la_walk as jax_la_walk
from babble_tpu.ops.pallas_ingest import unpack_la
from babble_tpu.sim import arrays as jarrays

from babble_tpu_torch import quorum
from babble_tpu_torch.ops import pack, ss, state
from babble_tpu_torch.ops.pallas_ingest import (
    la_walk, la_walk_plain, walk_supported,
)
from babble_tpu_torch.sim import arrays

CPU = "cpu"


def _eq(a, b, what=""):
    """Exact equality of a JAX/numpy array and a torch tensor, dtype too."""
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    np.testing.assert_array_equal(a, b, err_msg=what)


# ----------------------------------------------------------------------
# quorum and bit packing


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 64, 100, 1024])
def test_supermajority_matches(n):
    from babble_tpu.membership.quorum import supermajority

    assert quorum.supermajority(n) == supermajority(n)


@pytest.mark.parametrize("shape", [(5,), (3, 8), (4, 13), (2, 3, 64), (7, 1)])
def test_pack_bits_and_count_bits(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.random(shape) < 0.4
    _eq(jpack.pack_bits(jnp.asarray(x)), pack.pack_bits(torch.from_numpy(x)),
        "pack_bits")
    _eq(jpack.count_bits(jnp.asarray(x)),
        pack.count_bits(torch.from_numpy(x)), "count_bits")
    _eq(np.packbits(x, axis=-1, bitorder="little"),
        pack.pack_bits(torch.from_numpy(x)), "np.packbits little-endian")
    lanes = rng.integers(0, 256, shape, dtype=np.uint8)
    _eq(jpack.popcount_sum(jnp.asarray(lanes)),
        pack.popcount_sum(torch.from_numpy(lanes)), "popcount_sum")


# ----------------------------------------------------------------------
# device state


CFGS = [
    dict(n=4, e_cap=32, s_cap=16, r_cap=8),
    dict(n=13, e_cap=100, s_cap=40, r_cap=12, coord16=True),
    dict(n=6, e_cap=64, s_cap=20, r_cap=8, coord8=True, retired=(2,)),
    dict(n=8, e_cap=50, s_cap=30, r_cap=10, n_real=7, ts32=True),
]


@pytest.mark.parametrize("kw", CFGS)
def test_init_state_matches(kw):
    jcfg = jstate.DagConfig(**kw)
    cfg = state.DagConfig(**kw)
    assert cfg.super_majority == jcfg.super_majority
    assert cfg.lp == jcfg.lp and cfg.active_n == jcfg.active_n
    assert cfg.fd_inf == int(jcfg.fd_inf)
    js = jstate.init_state(jcfg)
    ts = state.init_state(cfg, device=CPU)
    assert ts._fields == js._fields
    for f in js._fields:
        _eq(getattr(js, f), getattr(ts, f), f)


def test_state_field_partition_matches():
    assert state.DagState._fields == jstate.DagState._fields
    for name in ("PER_EVENT_FIELDS", "PER_ROUND_FIELDS",
                 "PER_CREATOR_FIELDS", "SCALAR_FIELDS"):
        assert getattr(state, name) == getattr(jstate, name), name
    parts = (state.PER_EVENT_FIELDS + state.PER_ROUND_FIELDS
             + state.PER_CREATOR_FIELDS + state.SCALAR_FIELDS)
    assert sorted(parts) == sorted(state.DagState._fields)
    assert state.CONSENSUS_EVENT_FIELDS == jstate.CONSENSUS_EVENT_FIELDS
    assert state.CONSENSUS_TABLE_FIELDS == jstate.CONSENSUS_TABLE_FIELDS


def test_guards_and_cost_model_match():
    for s in (0, 100, 119, 120, 16383, 16384, 32766):
        assert state.coord16_ok(s) == jstate.coord16_ok(s)
        assert state.coord8_ok(s) == jstate.coord8_ok(s)
    for lo, hi in ((0, 10), (5, (1 << 31) - 5), (0, 1 << 40)):
        assert state.ts32_ok(lo, hi) == jstate.ts32_ok(lo, hi)
    for rows, e in ((3494, 65536), (392, 100000), (10, 1024), (600, 32)):
        assert state.fd_reverse_scan_wins(rows, e) == \
            jstate.fd_reverse_scan_wins(rows, e)
    with pytest.raises(ValueError):
        state.init_state(state.DagConfig(n=2, e_cap=4, s_cap=200, r_cap=4,
                                         coord8=True), device=CPU)


@pytest.mark.parametrize("kw", CFGS[:3])
def test_repack_round_bits_matches(kw):
    rng = np.random.default_rng(5)
    jcfg = jstate.DagConfig(**kw)
    cfg = state.DagConfig(**kw)
    r1, n, e1 = cfg.r_cap + 1, cfg.n, cfg.e_cap + 1
    js = jstate.init_state(jcfg)
    js = js._replace(
        wslot=jnp.asarray(np.where(rng.random((r1, n)) < 0.7,
                                   rng.integers(0, e1, (r1, n)), -1)
                          .astype(np.int32)),
        famous=jnp.asarray(rng.integers(0, 3, (r1, n)).astype(np.int8)),
        mbit=jnp.asarray(rng.random(e1) < 0.5),
    )
    ts = state.state_from_numpy(cfg, js, device=CPU)
    jout = jstate.repack_round_bits(jcfg, js)
    tout = state.repack_round_bits(cfg, ts)
    _eq(jout.mbr, tout.mbr, "mbr")
    _eq(jout.fmr, tout.fmr, "fmr")


def test_state_numpy_round_trip_copies():
    cfg = state.DagConfig(n=4, e_cap=16, s_cap=8, r_cap=4)
    ts = state.init_state(cfg, device=CPU)
    host = state.state_to_numpy(ts)
    host.la[0, 0] = 7                 # the host copy must not alias
    assert int(ts.la[0, 0]) == -1
    back = state.state_from_numpy(cfg, host, device=CPU)
    host.fd[1, 1] = 3
    assert int(back.la[0, 0]) == 7 and int(back.fd[1, 1]) == cfg.fd_inf
    with pytest.raises(ValueError):
        state.state_from_numpy(cfg._replace(e_cap=17), host, device=CPU)


def test_sanitize_and_set_sentinel():
    idx = torch.tensor([-1, 0, 3, -5], dtype=torch.int32)
    assert state.sanitize(idx, 9).tolist() == [9, 0, 3, 9]
    a = torch.zeros(4, dtype=torch.int64)
    out = state.set_sentinel(a, torch.arange(4) == 3, 5)
    assert out.tolist() == [0, 0, 0, 5] and out.dtype == torch.int64


def test_assert_consensus_parity_detects_a_difference():
    cfg = state.DagConfig(n=4, e_cap=16, s_cap=8, r_cap=4)
    a = state.init_state(cfg, device=CPU)
    state.assert_consensus_parity(a, state.state_to_numpy(a), 16)
    b = a._replace(rr=a.rr.clone())
    b.rr[3] = 2
    with pytest.raises(AssertionError, match="rr differs"):
        state.assert_consensus_parity(a, b, 16)
    with pytest.raises(AssertionError, match="lcr"):
        state.assert_consensus_parity(
            a, a._replace(lcr=torch.tensor(4, dtype=torch.int32)), 16)


# ----------------------------------------------------------------------
# DAG generation


@pytest.mark.parametrize("n,e,seed", [(4, 50, 0), (16, 800, 3), (64, 3000, 9)])
def test_generator_bit_identical(n, e, seed):
    want = jarrays.random_gossip_arrays(n, e, seed=seed)
    got = arrays.random_gossip_arrays(n, e, seed=seed)
    for f in ("sp", "op", "creator", "seq", "ts", "mbit", "levels"):
        _eq(getattr(want, f), getattr(got, f), f)
    assert got.max_chain == want.max_chain
    assert got.n_levels == want.n_levels
    _eq(jarrays.build_schedule(want.levels),
        arrays.build_schedule(got.levels), "schedule")


def test_batch_from_arrays_matches():
    dag = arrays.random_gossip_arrays(8, 300, seed=4)
    jb = jarrays.batch_from_arrays(jarrays.random_gossip_arrays(8, 300, seed=4),
                                   bucket=jstate.bucket)
    tb = arrays.batch_from_arrays(dag, bucket=jstate.bucket, device=CPU)
    assert tb._fields == jb._fields
    for f in jb._fields:
        _eq(getattr(jb, f), getattr(tb, f), f)


# ----------------------------------------------------------------------
# strongly-see counts


@pytest.mark.parametrize("a,b,k,chunk", [(5, 7, 4, 512), (37, 9, 6, 8)])
def test_ss_counts_compare_matches(a, b, k, chunk):
    from babble_tpu.ops.ss import ss_counts_compare

    rng = np.random.default_rng(a * b)
    la = rng.integers(-1, 20, (a, k)).astype(np.int32)
    fd = np.where(rng.random((b, k)) < 0.2, np.iinfo(np.int32).max,
                  rng.integers(0, 20, (b, k))).astype(np.int32)
    _eq(ss_counts_compare(jnp.asarray(la), jnp.asarray(fd), chunk),
        ss.ss_counts_compare(torch.from_numpy(la), torch.from_numpy(fd),
                             chunk), "ss counts")


# ----------------------------------------------------------------------
# the last-ancestor walk (plain version; the CUDA kernel runs on the card)


def _walk_args(n, e, seed):
    dag = arrays.random_gossip_arrays(n, e, seed=seed)
    e1 = e + 1

    def pad(a, fill):
        out = np.full(e1, fill, np.int32)
        out[:e] = a
        return out

    return dict(sp=pad(dag.sp, -1), op=pad(dag.op, -1),
                creator=pad(dag.creator, n), seq=pad(dag.seq, -1),
                n_events=e, e_cap=e, n=n)


@pytest.mark.parametrize("n,e,seed,n_live", [
    (4, 300, 1, 300), (8, 1024, 13, 1024), (8, 512, 2, 400),
])
def test_la_walk_plain_matches_pallas_interpret(n, e, seed, n_live):
    a = _walk_args(n, e, seed)
    assert walk_supported(n, e, 64)
    packed = jax_la_walk(e, n, jnp.asarray(a["sp"]), jnp.asarray(a["op"]),
                         jnp.asarray(a["creator"]), jnp.asarray(a["seq"]),
                         n_live, True)
    want = unpack_la(e, n, packed, n_live)
    t = {k: torch.from_numpy(a[k]) for k in ("sp", "op", "creator", "seq")}
    ne = torch.tensor(n_live, dtype=torch.int32)
    got = la_walk_plain(t["sp"], t["op"], t["creator"], t["seq"], ne, e, n)
    _eq(want, got, "la")
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = la_walk.launches
    _eq(want, la_walk(t["sp"], t["op"], t["creator"], t["seq"], ne, e, n),
        "la_walk on cpu")
    assert la_walk.launches == before


def test_la_walk_rejects_bad_arguments():
    a = _walk_args(4, 64, 0)
    t = {k: torch.from_numpy(a[k]) for k in ("sp", "op", "creator", "seq")}
    ne = torch.tensor(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        la_walk(t["sp"].long(), t["op"], t["creator"], t["seq"], ne, 64, 4)
    with pytest.raises(ValueError, match="n=65"):
        la_walk(t["sp"], t["op"], t["creator"], t["seq"], ne, 64, 65)
    with pytest.raises(ValueError, match="n_events"):
        la_walk(t["sp"], t["op"], t["creator"], t["seq"], 64, 64, 4)
    with pytest.raises(ValueError, match="contiguous"):
        sp2 = torch.stack([t["sp"], t["sp"]], 1)[:, 0]
        la_walk(sp2, t["op"], t["creator"], t["seq"], ne, 64, 4)


def test_walk_supported_matches():
    from babble_tpu.ops.pallas_ingest import walk_supported as jws

    for n, e, s in ((64, 65536, 1107), (65, 1024, 10), (8, 1 << 20, 10),
                    (8, 1024, 40000), (64, 70000, 100)):
        assert walk_supported(n, e, s) == jws(n, e, s)
