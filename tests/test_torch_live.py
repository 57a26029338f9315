"""The port's live path against the JAX package, on the CPU.

The live path is incremental ingest (fd modes ``"incremental"``,
``"full"``, ``"absorb"``), then windowed fame and windowed order over
persisted frontiers (``ops/flush.py``).  Every case builds its inputs
from a seed with numpy; outputs must be exactly equal on every field,
dtypes included.

- Per flush: the port's ``sim/live.py live_stream`` picks each flush's
  (k, W, F) as the JAX engine would; the same batches go through the
  port's ``live_flush_impl`` and the JAX ``live_flush_impl``, and the
  whole state is compared after every flush.
- Units: each ported function against its JAX twin, on JAX states
  carried into the port with ``state_from_numpy``.
- Whole stream: a drained live stream equals the batch step.

JAX compiles one program per (cfg, W, F, batch shape), so the cases
share shapes where they can.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from babble_tpu.ops import flush as jflush
from babble_tpu.ops import ingest as jingest
from babble_tpu.ops import state as jstate
from babble_tpu.parallel.sharded import consensus_step_impl
from babble_tpu.sim import arrays as jarrays

from babble_tpu_torch import consensus_step
from babble_tpu_torch.ops import flush, ingest, state
from babble_tpu_torch.sim import arrays, live

CPU = "cpu"

_jlive = jax.jit(jflush.live_flush_impl, static_argnums=(0, 1, 2, 3))


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def _eq_states(ref, out, fields=None, label=""):
    for f in fields or ref._fields:
        _eq(getattr(ref, f), getattr(out, f), f"{label} {f}")


def _cfgs(n, e_cap, dag, r_cap=64, **kw):
    jcfg = jstate.DagConfig(n=n, e_cap=e_cap,
                            s_cap=max(64, dag.max_chain + 1), r_cap=r_cap,
                            **kw)
    return jcfg, state.DagConfig(**jcfg._asdict())


def _jbatch(b):
    """The port's EventBatch as a JAX one (same values, same dtypes)."""
    return jingest.EventBatch(*(jnp.asarray(t.numpy()) for t in b))


def _replay(jcfg, cfg, dag, log, gate, pstate=None, jst=None):
    """Flush ``dag`` through both packages with the (k, W, F) of
    ``log``, comparing the whole state after every flush."""
    pstate = pstate if pstate is not None else state.init_state(cfg, device=CPU)
    jst = jst if jst is not None else jstate.init_state(jcfg)
    lo = int(pstate.n_events)
    for i, rec in enumerate(log):
        b = live.stream_batch(dag, lo, lo + rec.k, CPU)
        pstate = flush.live_flush_impl(cfg, rec.W, rec.F, gate, pstate, b)
        jst = _jlive(jcfg, rec.W, rec.F, gate, jst, _jbatch(b))
        _eq_states(jst, pstate, label=f"flush {i} (k={rec.k} W={rec.W} F={rec.F})")
        assert int(pstate.lcr) == rec.lcr
        lo += rec.k
    return jst, pstate


# (n, events, seed, e_cap, chunk, gate, packed)
STREAMS = {
    # the BENCH_DIET stream: 4 x 360, seed 17, chunks of 8, gated
    "diet-packed": (4, 360, 17, 512, 8, True, True),
    "diet-f32": (4, 360, 17, 512, 8, True, False),
    "8x1024-ungated": (8, 1024, 13, 1024, 64, False, True),
    # ungated, and a round is abandoned (test_ungated_stream_...)
    "seed4-ungated": (4, 360, 4, 512, 8, False, True),
    # n = 2: a coin round at every even voting distance
    "n2-packed": (2, 120, 1, 128, 8, True, True),
    "n2-f32": (2, 120, 1, 128, 8, True, False),
    # n = 5: padding bits in every packed lane
    "n5-packed": (5, 200, 3, 256, 8, True, True),
}


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_live_stream_matches_jax_per_flush(case):
    n, e, seed, e_cap, chunk, gate, packed = STREAMS[case]
    dag = arrays.random_gossip_arrays(n, e, seed=seed)
    jcfg, cfg = _cfgs(n, e_cap, dag, packed=packed)
    out, log = live.live_stream(cfg, dag, chunk, gate, device=CPU)
    assert sum(r.k for r in log) == e and log[-1].k == 0
    jst, pstate = _replay(jcfg, cfg, dag, log, gate)
    _eq_states(out, pstate, label="stream vs replay")
    assert int(out.lcr) > 0 and int((out.rr[:e] >= 0).sum()) > 0
    if n == 2:
        # coin rounds came up: some voting distance d > 1 is even
        assert any(r.W >= 4 for r in log)


def test_live_flush_with_clamped_window_matches_jax():
    """lcr + 1 > r_cap - W: the fame and order windows start at the
    clamped offset r_cap - W, below lcr + 1; the port reads and writes
    back at the same offset and runs every voting distance."""
    n, e, seed = 4, 360, 17
    dag = arrays.random_gossip_arrays(n, e, seed=seed)
    jcfg, cfg = _cfgs(n, 512, dag, r_cap=28)
    mid, log = live.live_stream(cfg, dag, 8, True, device=CPU, stop=240,
                                drain=False)
    lcr, W = int(mid.lcr), 16
    assert lcr + 1 > cfg.r_cap - W, (lcr, cfg.r_cap)
    js = _jax_state(mid)
    for lo, hi in ((240, 248), (248, 248)):
        b = live.stream_batch(dag, lo, hi, CPU)
        mid = flush.live_flush_impl(cfg, W, 512 + 1, True, mid, b)
        js = _jlive(jcfg, W, 512 + 1, True, js, _jbatch(b))
        _eq_states(js, mid, label=f"clamped {lo}:{hi}")
    assert int(mid.lcr) >= lcr


def _jax_state(pstate):
    return jstate.DagState(*(None if t is None else jnp.asarray(t.numpy())
                             for t in pstate))


def test_frontier_bucket_equals_full_height():
    """The F-row frontier slice gives what a full-height scan gives."""
    dag = arrays.random_gossip_arrays(8, 1024, seed=13)
    _, cfg = _cfgs(8, 1024, dag)
    mid, _ = live.live_stream(cfg, dag, 64, False, device=CPU, stop=640,
                              drain=False)
    m = live.read_mirrors(mid)
    b = live.stream_batch(dag, 640, 704, CPU)
    W, F = live.flush_shape(cfg, m, 64, live.chunk_levels(dag, 640, 704),
                            False)
    assert F < cfg.e_cap + 1
    a = flush.live_flush_impl(cfg, W, F, False, mid, b)
    full = flush.live_flush_impl(cfg, W, cfg.e_cap + 1, False, mid, b)
    _eq_states(a, full)


# ----------------------------------------------------------------------
# units


@functools.lru_cache(maxsize=None)
def _mid_stream(n, e, seed, e_cap, stop, packed=True):
    """(jax cfg, port cfg, dag, JAX state after slots [0, stop) were
    streamed in chunks of 64 (ungated), the next batch [stop, stop+64))."""
    dag = arrays.random_gossip_arrays(n, e, seed=seed)
    jcfg, cfg = _cfgs(n, e_cap, dag, packed=packed)
    mid, _ = live.live_stream(cfg, dag, 64, False, device=CPU, stop=stop,
                              drain=False)
    return jcfg, cfg, dag, _jax_state(mid), live.stream_batch(
        dag, stop, stop + 64, CPU)


def _port(cfg, jax_state):
    return state.state_from_numpy(cfg, jax_state, device=CPU)


@pytest.mark.parametrize("packed", [True, False])
def test_fd_incremental_and_level_scan_match(packed):
    jcfg, cfg, _, js, b = _mid_stream(8, 1024, 13, 1024, 512, packed)
    jb = _jbatch(b)

    @jax.jit
    def pre_fd(s, bb):
        s = jingest._write_batch_fields(s, jcfg, bb)
        sched = jingest._slot_sched(s.n_events - bb.k, jcfg, bb.sched)
        s = jingest._la_level_scan(s, jcfg, sched)
        return jingest._fd_init_own(s, jcfg, bb)

    pre = pre_fd(js, jb)
    want = jax.jit(lambda s, bb: jingest._fd_incremental(s, jcfg, bb))(pre, jb)
    got = ingest._fd_incremental(_port(cfg, pre), cfg, b)
    _eq(want.fd, got.fd, "fd")

    coords = jax.jit(lambda s, bb: jingest.ingest_coords_impl(
        jcfg, s, "incremental", bb))(js, jb)

    @jax.jit
    def rounds(s, bb):
        sched = jingest._slot_sched(s.n_events - bb.k, jcfg, bb.sched)
        return jingest._rounds_level_scan(s, jcfg, sched, bb.sched)

    pc = _port(cfg, coords)
    got = ingest._rounds_level_scan(
        pc, cfg, ingest._slot_sched(pc.n_events - b.k, cfg, b.sched), b.sched)
    # the dump rows included: they hold what the padding lanes wrote
    _eq_states(rounds(coords, jb), got,
               ("round", "witness", "wslot", "max_round"))


@pytest.mark.parametrize("mode", ["incremental", "full", "absorb"])
@pytest.mark.parametrize("n,e,seed", [(4, 300, 1), (8, 1024, 13)])
def test_ingest_modes_match(mode, n, e, seed):
    """Each live-path mode on the whole DAG in one batch."""
    dag = arrays.random_gossip_arrays(n, e, seed=seed)
    jcfg, cfg = _cfgs(n, e, dag)
    jdag = jarrays.random_gossip_arrays(n, e, seed=seed)
    want = jax.jit(lambda s, bb: jingest.ingest_impl(jcfg, s, mode, bb))(
        jstate.init_state(jcfg), jarrays.batch_from_arrays(jdag))
    got = ingest.ingest_impl(cfg, state.init_state(cfg, device=CPU), mode,
                             arrays.batch_from_arrays(dag, device=CPU))
    _eq_states(want, got)


def test_ingest_incremental_mid_stream_matches():
    """Mode "incremental" on a batch appended to a mid-stream state."""
    jcfg, cfg, _, js, b = _mid_stream(8, 1024, 13, 1024, 512)
    for mode in ("incremental", "full"):
        want = jax.jit(lambda s, bb: jingest.ingest_impl(jcfg, s, mode, bb))(
            js, _jbatch(b))
        got = ingest.ingest_impl(cfg, _port(cfg, js), mode, b)
        _eq_states(want, got, label=mode)


def _level_sched(levels, sus):
    """The engine's level-grouped rescan schedule of slots ``sus``."""
    lev = levels[sus].astype(np.int64)
    order = np.argsort(lev, kind="stable")
    ulev, starts = np.unique(lev[order], return_index=True)
    bounds = list(starts) + [len(sus)]
    t, b = len(ulev), max(int(np.max(np.diff(bounds))), 1)
    out = np.full((state.bucket(t, 1), state.bucket(b, 1)), -1, np.int32)
    for row in range(t):
        grp = sus[order[bounds[row]: bounds[row + 1]]]
        out[row, : len(grp)] = grp
    return out


def test_rescan_rounds_matches():
    """Rescan the slots of rounds above 8 after wiping their rounds,
    witness flags and witness rows (as an epoch transition does)."""
    jcfg, cfg, dag, js, _ = _mid_stream(8, 1024, 13, 1024, 896)
    rnd = np.asarray(js.round)
    sus = np.nonzero(rnd[:896] > 8)[0].astype(np.int32)
    assert len(sus) > 64
    wiped = js._replace(
        round=js.round.at[sus].set(3),
        wslot=js.wslot.at[9:jcfg.r_cap].set(-1),
    )
    sched = _level_sched(dag.levels, sus)
    want = jax.jit(lambda s, sc: jingest.rescan_rounds_impl(jcfg, s, sc))(
        wiped, jnp.asarray(sched))
    got = ingest.rescan_rounds_impl(cfg, _port(cfg, wiped),
                                    torch.from_numpy(sched))
    _eq_states(want, got)
    # the rescan restores what the stream assigned
    _eq_states(js, got, ("round", "witness", "wslot"))


def test_buckets_and_bytes_model_match():
    for x, m in ((0, 8), (1, 8), (8, 8), (9, 8), (300, 1), (1, 1), (257, 256)):
        assert state.bucket(x, m) == jstate.bucket(x, m)
    for r in range(0, 20):
        for r_cap in (4, 8, 12, 16, 64):
            assert flush.bucket_w(r, r_cap) == jflush.bucket_w(r, r_cap)
    for h in (0, 1, 255, 256, 257, 1000, 4096, 65537):
        for e1 in (257, 1025, 65537):
            assert flush.bucket_f(h, e1) == jflush.bucket_f(h, e1)
    assert flush.W_BUCKETS == jflush.W_BUCKETS and flush.F_MIN == jflush.F_MIN
    # every public function and type of the JAX module has a twin
    public = [k for k, v in vars(jflush).items() if not k.startswith("_")
              and getattr(v, "__module__", None) == jflush.__name__]
    assert "live_flush" in public
    assert [k for k in public if not hasattr(flush, k)] == []
    assert set(flush.FIELD_TRAFFIC) == set(jflush.FIELD_TRAFFIC)
    for kw in ({}, {"packed": True}, {"coord16": True}, {"n_real": 5}):
        jcfg = jstate.DagConfig(n=8, e_cap=4096, s_cap=600, r_cap=128, **kw)
        cfg = state.DagConfig(**jcfg._asdict())
        for W, k, F in ((4, 8, 256), (16, 256, None), (8, 0, 4097)):
            assert flush.flush_bytes_estimate(cfg, W, k, F) == \
                jflush.flush_bytes_estimate(jcfg, W, k, F)
        assert flush.throughput_bytes_estimate(cfg, 64) == \
            jflush.throughput_bytes_estimate(jcfg, 64)


def test_probed_flush_equals_live_flush():
    jcfg, cfg, dag, js, b = _mid_stream(8, 1024, 13, 1024, 512)
    ps = _port(cfg, js)
    m = live.read_mirrors(ps)
    W, F = live.flush_shape(cfg, m, 64, live.chunk_levels(dag, 512, 576), False)
    one = flush.live_flush_impl(cfg, W, F, False, ps, b)
    probed, t = flush.probed_flush(cfg, W, F, False, ps, b)
    _eq_states(one, probed)
    assert set(t) == {"ingest_s", "fame_s", "order_s"}
    assert all(v >= 0 for v in t.values())


def test_ungated_stream_can_abandon_a_round():
    """Ungated lcr takes the highest decided round in the window (the
    reference's semantics), so a flush can decide round i+1 while a
    witness of round i is undecided: lcr jumps past i, round i never
    enters a window again, and its events are received a round later
    than the batch step receives them.  The JAX live flush does the
    same (the "seed4-ungated" stream replays it flush by flush); the
    gate's contiguous lcr is what prevents it."""
    n, e, seed = 4, 360, 4
    dag = arrays.random_gossip_arrays(n, e, seed=seed)
    _, cfg = _cfgs(n, 512, dag, packed=True)
    ref = consensus_step(cfg, "fast", state.init_state(cfg, device=CPU),
                         arrays.batch_from_arrays(dag, device=CPU))
    out, _ = live.live_stream(cfg, dag, 8, False, device=CPU)
    _eq_states(ref, out, ("la", "fd", "round", "witness", "wslot", "lcr",
                          "max_round"))
    assert int((out.rr[:e] != ref.rr[:e]).sum()) > 0
    R, lcr = cfg.r_cap, int(out.lcr)
    open_rows = ((out.famous[:R] == 0) & (out.wslot[:R] >= 0)).any(dim=1)
    abandoned = torch.nonzero(open_rows[: lcr + 1]).flatten().tolist()
    assert abandoned == [16]
    assert (ref.famous[16] != 0).all()
    gated, _ = live.live_stream(cfg, dag, 8, True, device=CPU)
    _assert_gated_prefix(ref, gated, e)


# ----------------------------------------------------------------------
# the stand-in engine's dispatch


def test_stream_batch_matches_engine_padding():
    """Batch padding and schedule as the engine builds them: kpad =
    bucket(k), the chunk's levels grouped in order, T and B padded to
    powers of two; an empty drain batch has k = 0 and one -1 cell."""
    dag = arrays.random_gossip_arrays(8, 1024, seed=13)
    b = live.stream_batch(dag, 100, 150, CPU)
    assert b.sp.shape == (64,) and int(b.k) == 50
    sched = b.sched.numpy()
    t = live.chunk_levels(dag, 100, 150)
    assert sched.shape[0] == state.bucket(t, 1)
    lev = dag.levels[100:150]
    rows = [sorted(int(lev[p]) for p in r if p >= 0) for r in sched[:t]]
    assert all(len(set(r)) == 1 for r in rows)
    assert [r[0] for r in rows] == sorted(set(lev.tolist()))
    got = sorted(int(p) for p in sched.ravel() if p >= 0)
    assert got == list(range(50))
    empty = live.stream_batch(dag, 150, 150, CPU)
    assert int(empty.k) == 0 and empty.sp.shape == (8,)
    assert empty.sched.numpy().tolist() == [[-1]]


def test_flush_shape_refuses_like_the_engine():
    dag = arrays.random_gossip_arrays(4, 200, seed=3)
    _, cfg = _cfgs(4, 256, dag)
    m = live.Mirrors(max_round=10, lcr=8, frontier=100, n_events=120, r_off=0)
    assert live.flush_shape(cfg, m, 8, 3, False) == (4, 256)
    # the gate caps the estimate at HEAD_GATE_HORIZON + 2
    far = m._replace(max_round=30)
    assert live.flush_shape(cfg, far, 8, 3, True) == (16, 256)
    with pytest.raises(live.LatencyRefused, match="no W bucket"):
        live.flush_shape(cfg, far, 8, 3, False)
    with pytest.raises(live.LatencyRefused, match="LATENCY_K_MAX"):
        live.flush_shape(cfg, m, 257, 3, False)
    with pytest.raises(live.LatencyRefused, match="window top"):
        live.flush_shape(cfg, m._replace(lcr=59, max_round=60), 0, 0, False)
    with pytest.raises(live.LatencyRefused, match="r_cap"):
        live.flush_shape(cfg, m._replace(lcr=58, max_round=60), 8, 3, False)
    with pytest.raises(live.LatencyRefused, match="e_cap"):
        live.flush_shape(cfg, m._replace(n_events=250), 8, 3, False)
    with pytest.raises(ValueError, match="chunk"):
        live.live_stream(cfg, dag, 0, device=CPU)


# ----------------------------------------------------------------------
# whole stream


def _assert_gated_prefix(ref, out, n_events):
    """Hold a drained gated stream ``out`` against the ungated batch step
    ``ref`` on the same DAG.  The gate only defers fame decisions, so:
    ``la``, ``fd``, ``round``, ``witness`` and ``wslot`` are equal; lcr
    is at most the batch step's; ``rr`` and ``cts`` are equal wherever
    the stream received an event; and the stream's ``rr`` is -1 exactly
    where the batch step's is -1 or above the stream's lcr."""
    def host(t, rows=None):
        a = t.detach().cpu().numpy()
        return a if rows is None else a[:rows]

    for f in ("la", "fd", "round", "witness"):
        if not np.array_equal(host(getattr(ref, f), n_events),
                              host(getattr(out, f), n_events)):
            raise AssertionError(f"gated stream: {f} differs from the batch step")
    if not np.array_equal(host(ref.wslot), host(out.wslot)):
        raise AssertionError("gated stream: wslot differs from the batch step")
    lcr, ref_lcr = int(out.lcr), int(ref.lcr)
    if lcr > ref_lcr:
        raise AssertionError(f"gated stream: lcr {lcr} > batch step's {ref_lcr}")
    rr, ref_rr = host(out.rr, n_events), host(ref.rr, n_events)
    got = rr >= 0
    if not (np.array_equal(rr[got], ref_rr[got]) and np.array_equal(
            host(out.cts, n_events)[got], host(ref.cts, n_events)[got])):
        raise AssertionError("gated stream: rr/cts differ where it received")
    if not np.array_equal(~got, (ref_rr < 0) | (ref_rr > lcr)):
        raise AssertionError(
            "gated stream: rr is -1 where the batch step received at or "
            f"below lcr {lcr}, or set where it did not")


def test_drained_stream_equals_batch_step():
    """The drained ungated stream at 8 x 1,024 equals the JAX batch step
    ("fast") on the same DAG, every consensus field and lcr."""
    n, e, seed = 8, 1024, 13
    dag = arrays.random_gossip_arrays(n, e, seed=seed)
    jcfg, cfg = _cfgs(n, e, dag)
    jdag = jarrays.random_gossip_arrays(n, e, seed=seed)
    want = jax.jit(lambda s, b: consensus_step_impl(jcfg, "fast", s, b))(
        jstate.init_state(jcfg), jarrays.batch_from_arrays(jdag))
    out, log = live.live_stream(cfg, dag, 64, False, device=CPU)
    state.assert_consensus_parity(want, out, e, "drained stream vs batch")
    _eq_states(want, out, state.CONSENSUS_EVENT_FIELDS
               + state.CONSENSUS_TABLE_FIELDS + ("lcr", "max_round"))
    # and the port's own batch step agrees
    batch = consensus_step(cfg, "fast", state.init_state(cfg, device=CPU),
                           arrays.batch_from_arrays(dag, device=CPU))
    state.assert_consensus_parity(batch, out, e, "port batch vs stream")


@pytest.mark.parametrize("n,e,seed,chunk", [(8, 1024, 13, 64), (4, 360, 17, 8)])
def test_gated_stream_is_a_prefix_of_the_batch_step(n, e, seed, chunk):
    """The gated stream agrees with the ungated batch step on every
    coordinate and witness, and on reception below its own lcr."""
    dag = arrays.random_gossip_arrays(n, e, seed=seed)
    _, cfg = _cfgs(n, max(e, 512), dag)
    ref = consensus_step(cfg, "fast", state.init_state(cfg, device=CPU),
                         arrays.batch_from_arrays(dag, device=CPU))
    out, _ = live.live_stream(cfg, dag, chunk, True, device=CPU)
    _assert_gated_prefix(ref, out, e)
    assert 0 < int(out.lcr) <= int(ref.lcr)


def test_consensus_digest_matches_jax_state():
    """consensus_digest hashes a JAX state and its port the same, and
    moves when one decision moves."""
    jcfg, cfg, _, js, _ = _mid_stream(8, 1024, 13, 1024, 512)
    ps = _port(cfg, js)
    assert state.consensus_digest(js, 512) == state.consensus_digest(ps, 512)
    moved = ps._replace(rr=ps.rr.clone())
    moved.rr[3] += 1
    assert state.consensus_digest(moved, 512) != state.consensus_digest(ps, 512)


# ----------------------------------------------------------------------
# the reference values chip_smoke.py phase 5 holds the card against


def chip_reference(n=64, e=65536, seed=7, chunk=256, r_cap=512):
    """The JAX package's live stream at chip_smoke.py's phase-5 size:
    for each of the ungated and the gated stream, the port picks every
    flush's (k, W, F) on the CPU, the JAX ``live_flush_impl`` replays
    the flushes (the port is compared with it after each one), and the
    drained JAX state gives the counts and ``consensus_digest`` that
    chip_smoke.py's ``LIVE_EXPECT`` records.  Minutes of CPU:

        JAX_PLATFORMS=cpu python -m tests.test_torch_live
    """
    dag = arrays.random_gossip_arrays(n, e, seed=seed)
    jcfg, cfg = _cfgs(n, e, dag, r_cap=r_cap, packed=True)
    jcfg = jcfg._replace(s_cap=dag.max_chain + 1)
    cfg = cfg._replace(s_cap=dag.max_chain + 1)
    out = {}
    for name, gate in (("ungated", False), ("gated", True)):
        ported, log = live.live_stream(cfg, dag, chunk, gate, device=CPU)
        jst, pstate = _replay(jcfg, cfg, dag, log, gate)
        _eq_states(ported, pstate)
        out[name] = dict(
            flushes=len(log), max_round=int(jst.max_round),
            lcr=int(jst.lcr),
            ordered=int((np.asarray(jst.rr)[:e] >= 0).sum()),
            digest=state.consensus_digest(jst, e),
        )
        print(name, out[name], flush=True)
    return out


if __name__ == "__main__":
    chip_reference()
