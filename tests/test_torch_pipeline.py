"""The PyTorch port's consensus pipeline against the JAX package, on the CPU.

Stage by stage (first descendants, the frontier march, fame, order) and
then the whole batch step, the same DAG (made from a seed) goes through
the JAX function and its port; outputs must be exactly equal on every
field, dtypes included.  Stage inputs are JAX states carried into the
port with ``state_from_numpy``, so each stage is held on its own.  JAX's
``"walk"`` mode runs its Pallas kernel in interpret mode here.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from babble_tpu.ops import fame as jfame
from babble_tpu.ops import ingest as jingest
from babble_tpu.ops import order as jorder
from babble_tpu.ops import state as jstate
from babble_tpu.parallel.sharded import consensus_step_impl
from babble_tpu.sim import arrays as jarrays

from babble_tpu_torch import consensus_step
from babble_tpu_torch.ops import fame, ingest, order, state
from babble_tpu_torch.sim import arrays

CPU = "cpu"
SHAPES = [(4, 300, 1), (8, 1024, 13)]


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def _eq_states(ref, out, fields=None):
    for f in fields or ref._fields:
        _eq(getattr(ref, f), getattr(out, f), f)


@functools.lru_cache(maxsize=None)
def _setup(n, e, seed):
    """(jax cfg, port cfg, jax batch, port batch) for one gossip DAG."""
    jdag = jarrays.random_gossip_arrays(n, e, seed=seed)
    jcfg = jstate.DagConfig(n=n, e_cap=e, s_cap=max(64, jdag.max_chain + 1),
                            r_cap=64)
    cfg = state.DagConfig(**jcfg._asdict())
    jb = jarrays.batch_from_arrays(jdag)
    tb = arrays.batch_from_arrays(
        arrays.random_gossip_arrays(n, e, seed=seed), device=CPU)
    return jcfg, cfg, jb, tb


@functools.lru_cache(maxsize=None)
def _jax_stages(n, e, seed):
    """JAX states after each stage of the "fast" step."""
    jcfg, _, jb, _ = _setup(n, e, seed)
    s0 = jstate.init_state(jcfg)

    @jax.jit
    def pre_fd(s, b):
        s = jingest._write_batch_fields(s, jcfg, b)
        sched = jingest._slot_sched(s.n_events - b.k, jcfg, b.sched)
        s = jingest._la_level_scan(s, jcfg, sched)
        return jingest._fd_init_own(s, jcfg, b)

    coords = jax.jit(lambda s, b: jingest.ingest_coords_impl(
        jcfg, s, "fast", b))(s0, jb)
    ingested = jax.jit(lambda s, b: jingest.ingest_rounds_impl(
        jcfg, s, "fast", b))(coords, jb)
    famed = jax.jit(lambda s: jfame.decide_fame_impl(jcfg, s))(ingested)
    return dict(pre_fd=pre_fd(s0, jb), coords=coords, ingested=ingested,
                famed=famed)


def _port(cfg, jax_state):
    return state.state_from_numpy(cfg, jax_state, device=CPU)


@pytest.mark.parametrize("n,e,seed", SHAPES)
def test_fd_full_matches(n, e, seed):
    jcfg, cfg, _, _ = _setup(n, e, seed)
    pre = _jax_stages(n, e, seed)["pre_fd"]
    want = jax.jit(lambda s: jingest._fd_full(s, jcfg))(pre)
    got = ingest._fd_full(_port(cfg, pre), cfg)
    _eq(want.fd, got.fd, "fd")


@pytest.mark.parametrize("n,e,seed", SHAPES)
def test_fd_reverse_scan_matches(n, e, seed):
    jcfg, cfg, jb, tb = _setup(n, e, seed)
    pre = _jax_stages(n, e, seed)["pre_fd"]

    @jax.jit
    def ref(s):
        sched = jingest._slot_sched(s.n_events - jb.k, jcfg, jb.sched)
        return jingest._fd_reverse_scan(s, jcfg, sched)

    ps = _port(cfg, pre)
    got = ingest._fd_reverse_scan(
        ps, cfg, ingest._slot_sched(ps.n_events - tb.k, cfg, tb.sched))
    _eq(ref(pre).fd, got.fd, "fd")
    # both strategies give the same table
    _eq(ref(pre).fd, ingest._fd_full(ps, cfg).fd, "reverse scan vs full")


@pytest.mark.parametrize("n,e,seed", SHAPES)
@pytest.mark.parametrize("mode", ["walk", "fast"])
def test_ingest_coords_matches(n, e, seed, mode):
    jcfg, cfg, jb, tb = _setup(n, e, seed)
    want = jax.jit(lambda s, b: jingest.ingest_coords_impl(
        jcfg, s, mode, b))(jstate.init_state(jcfg), jb)
    got = ingest.ingest_coords_impl(
        cfg, state.init_state(cfg, device=CPU), mode, tb)
    _eq_states(want, got)


@pytest.mark.parametrize("n,e,seed", SHAPES)
def test_rounds_frontier_matches(n, e, seed):
    jcfg, cfg, _, _ = _setup(n, e, seed)
    coords = _jax_stages(n, e, seed)["coords"]
    want = jax.jit(lambda s: jingest._rounds_frontier(s, jcfg))(coords)
    got = ingest._rounds_frontier(_port(cfg, coords), cfg)
    _eq_states(want, got, ("round", "witness", "wslot", "max_round"))


@pytest.mark.parametrize("n,e,seed", SHAPES)
@pytest.mark.parametrize("gate", [False, True])
def test_decide_fame_matches(n, e, seed, gate):
    jcfg, cfg, _, _ = _setup(n, e, seed)
    ingested = _jax_stages(n, e, seed)["ingested"]
    want = jax.jit(lambda s: jfame.decide_fame_impl(jcfg, s, gate))(ingested)
    got = fame.decide_fame_impl(cfg, _port(cfg, ingested), gate)
    _eq_states(want, got)


@pytest.mark.parametrize("n,e,seed", SHAPES)
@pytest.mark.parametrize("ts32", [False, True])
def test_decide_order_matches(n, e, seed, ts32):
    jcfg, cfg, _, _ = _setup(n, e, seed)
    jcfg, cfg = jcfg._replace(ts32=ts32), cfg._replace(ts32=ts32)
    famed = _jax_stages(n, e, seed)["famed"]
    want = jax.jit(lambda s: jorder.decide_order_impl(jcfg, s))(famed)
    got = order.decide_order_impl(cfg, _port(cfg, famed))
    _eq_states(want, got)
    assert int((got.rr >= 0).sum()) > 0


def test_decide_order_chunked_median_matches(monkeypatch):
    n, e, seed = 8, 1024, 13
    jcfg, cfg, _, _ = _setup(n, e, seed)
    famed = _jax_stages(n, e, seed)["famed"]
    want = jax.jit(lambda s: jorder.decide_order_impl(jcfg, s))(famed)
    monkeypatch.setattr(order, "MEDIAN_CHUNK_THRESHOLD", 1)
    monkeypatch.setattr(order, "MEDIAN_CHUNK_ELEMS", 96 * n)   # ragged tail
    got = order.decide_order_impl(cfg, _port(cfg, famed))
    _eq_states(want, got)


@pytest.mark.parametrize("n,e,seed", SHAPES)
@pytest.mark.parametrize("mode", ["walk", "fast"])
def test_consensus_step_matches(n, e, seed, mode):
    """The whole slice: the port's step against consensus_step_impl."""
    jcfg, cfg, jb, tb = _setup(n, e, seed)
    want = jax.jit(lambda s, b: consensus_step_impl(jcfg, mode, s, b))(
        jstate.init_state(jcfg), jb)
    got = consensus_step(cfg, mode, state.init_state(cfg, device=CPU), tb)
    state.assert_consensus_parity(want, got, e, f"{mode} {n}x{e}")
    _eq_states(want, got)
    assert int(got.lcr) > 0 and int((got.rr[:e] >= 0).sum()) > 0


def test_unported_modes_raise(monkeypatch):
    """Every fd mode of the JAX package is ported, and so is block fame:
    past ``BLOCK_FAME_THRESHOLD`` the dispatch takes the block form
    (tests/test_torch_engine.py holds it to JAX) where it used to
    raise."""
    assert set(ingest.PORTED_FD_MODES) == {
        "incremental", "full", "fast", "walk", "absorb"}
    jcfg, cfg, _, _ = _setup(4, 300, 1)
    wide = cfg._replace(n=64, r_cap=1 << 17)
    assert fame.fame_mode(wide) == jfame.fame_mode(jcfg._replace(
        n=64, r_cap=1 << 17)) == "block"
    calls = []
    monkeypatch.setattr(fame, "decide_fame_block_impl",
                        lambda *a: calls.append(a) or "block")
    assert fame.decide_fame_auto_impl(wide, None, False, True) == "block"
    assert calls == [(wide, None, False, True)]


def test_walk_rejects_unsupported_config():
    _, cfg, _, tb = _setup(4, 300, 1)
    big = cfg._replace(s_cap=40000)
    with pytest.raises(ValueError, match="walk mode"):
        ingest.ingest_coords_impl(big, state.init_state(big, device=CPU),
                                  "walk", tb)
