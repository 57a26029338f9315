"""The port's fork-aware pipeline against the JAX package's, on the CPU.

Every case builds its inputs from a seed and runs them through the JAX
function and its counterpart in the port; outputs must be equal:

- the generators (``random_byzantine_dag``, ``random_byzantine_fork_batch``,
  ``cap_schedule_width``) and ``ForkDag``'s batches;
- every ``ForkOut`` field of ``fork_pipeline`` on the DAGs of the JAX
  package's ``tests/test_forks.py`` (honest at k 1 and 2, byzantine at
  three seeds), and the port's ``ForkOracle`` against JAX's;
- the strongly-see compare-count's plain twin (``ss_counts_plain``,
  which the CPU takes) against JAX ``_ss_counts`` at both call shapes,
  ``_order``'s timestamp gather against the JAX loop, ``_fd_reverse``
  against ``_fd_chains``, and the rounds closure against the level scan;
- the rolling window (windowed engine against an unevicted one, laggard
  chains, sentinel rows, the lying-timestamp clamp), each held to the
  JAX engine.

Reference helper (run on the CPU, under a minute):

    JAX_PLATFORMS=cpu python -m tests.test_torch_forks

prints ``BYZ_EXPECT`` for ``chip_smoke.py`` phase 11(c): the JAX
``fork_pipeline`` over ``random_byzantine_fork_batch(128, 16384,
seed=11, fork_rate=0.02)``.
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax

from babble_tpu.consensus.byzantine import ForkOracle as JForkOracle
from babble_tpu.consensus.fork_engine import ForkHashgraph as JForkHashgraph
from babble_tpu.core.event import new_event as jnew_event
from babble_tpu.ops import forks as JF
from babble_tpu.ops.forks import ForkBudgetError as JForkBudgetError
from babble_tpu.sim import arrays as jarrays
from babble_tpu.sim import generator as jgen

from babble_tpu_torch.consensus.byzantine import ForkOracle
from babble_tpu_torch.consensus.fork_engine import ForkHashgraph
from babble_tpu_torch.core.event import new_event
from babble_tpu_torch.ops import forks as F
from babble_tpu_torch.ops.forks import ForkBudgetError
from babble_tpu_torch.sim import arrays as parrays
from babble_tpu_torch.sim import generator as pgen
from chip_smoke import byz_summary

HONEST = dict(n=4, e=120, seed=7)
BYZ = [(6, 200, 0.08, 3), (7, 260, 0.05, 4), (9, 300, 0.1, 5)]
#: chip_smoke.py phase 11(c)'s mid-size batch
BYZ_MID = dict(n=128, e=16384, seed=11, fork_rate=0.02)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_equal(name, a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (
        f"{name}: JAX {a.dtype}{a.shape}, port {b.dtype}{b.shape}")
    bad = np.argwhere(a != b)
    assert bad.size == 0, f"{name}: {len(bad)} entries differ, first {bad[:4]}"


def _assert_forkout(jout, pout):
    for name in JF.ForkOut._fields:
        _assert_equal(name, getattr(jout, name), getattr(pout, name))


def _batch_pair(jcfg, jbatch):
    """The port's ``ForkBatch`` on the CPU holding a JAX batch's arrays."""
    return F.fork_batch_from_numpy(
        {f: np.asarray(getattr(jbatch, f)) for f in JF.ForkBatch._fields},
        "cpu")


def _engines(dag_j, dag_p, k=2, **kw):
    jh = JForkHashgraph(dag_j.participants, k=k, **kw)
    ph = ForkHashgraph(dag_p.participants, k=k, device="cpu", **kw)
    return jh, ph


def _dags(n, e, rate=None, seed=0, **kw):
    if rate is None:
        dj = jgen.random_gossip_dag(n, e, seed=seed)
        dp = pgen.random_gossip_dag(n, e, seed=seed)
    else:
        dj = jgen.random_byzantine_dag(n, e, seed=seed, fork_rate=rate, **kw)
        dp = pgen.random_byzantine_dag(n, e, seed=seed, fork_rate=rate, **kw)
    assert [ev.hex() for ev in dj.events] == [ev.hex() for ev in dp.events]
    assert dj.participants == dp.participants
    return dj, dp


def _fill(events, *engines):
    for ev in events:
        for e in engines:
            e.insert_event(ev.clone())


def _assert_oracles(dj, jo, po):
    assert po.consensus_events() == jo.consensus_events()
    assert po.lcr == jo.lcr
    assert po.max_round() == jo.max_round()
    for ev in dj.events:
        x = ev.hex()
        assert po.round(x) == jo.round(x), x[:10]
        assert po.witness(x) == jo.witness(x), x[:10]
        assert po.famous[x] == jo.famous[x], x[:10]
        assert po.rr.get(x) == jo.rr.get(x), x[:10]
        assert po.cts.get(x) == jo.cts.get(x), x[:10]
    assert po._fork_pairs == jo._fork_pairs


def _assert_engine_matches_oracle(dag, fo, fh):
    for ev in dag.events:
        x = ev.hex()
        assert fh.round(x) == fo.round(x), f"round {x[:10]}"
        assert fh.witness(x) == fo.witness(x), f"witness {x[:10]}"
    for r in range(fo.max_round() + 1):
        for w in fo.round_witnesses(r):
            assert fh.famous_of(r, w) == fo.famous[w], f"fame r={r} {w[:10]}"
    assert fh.consensus_events() == fo.consensus_events()
    assert fh.lcr == fo.lcr


def _run_pair(dj, dp, k):
    """JAX and port engines and oracles over the same DAG: every ForkOut
    field, the commits and the oracles equal."""
    jh, ph = _engines(dj, dp, k=k)
    jo, po = JForkOracle(dj.participants), ForkOracle(dp.participants)
    _fill(dj.events, jh, jo)
    _fill(dp.events, ph, po)
    jc = [(e.hex(), e.round_received, e.consensus_timestamp)
          for e in jh.run_consensus()]
    pc = [(e.hex(), e.round_received, e.consensus_timestamp)
          for e in ph.run_consensus()]
    assert pc == jc and pc, "committed orders differ (or are empty)"
    jcfg, jout = jh._run()
    pcfg, pout = ph._run()
    assert tuple(pcfg) == tuple(jcfg)
    _assert_forkout(jout, pout)
    assert ph.commit_digest == jh.commit_digest
    assert ph.stats_snapshot() == jh.stats_snapshot()
    jo.run_consensus()
    po.run_consensus()
    _assert_oracles(dj, jo, po)
    _assert_engine_matches_oracle(dp, po, ph)
    return jo


# ----------------------------------------------------------------------
# generators and batches


def test_generators_match_jax():
    dj, dp = _dags(7, 260, rate=0.05, seed=4)
    for i, (a, b) in enumerate(zip(dj.events, dp.events)):
        assert (a.r, a.s, a.body.timestamp) == (b.r, b.s, b.body.timestamp), i
    jcfg, jb = jarrays.random_byzantine_fork_batch(32, 2048, seed=11,
                                                   fork_rate=0.02, r_cap=16)
    pcfg, pb = parrays.random_byzantine_fork_batch(32, 2048, seed=11,
                                                   fork_rate=0.02, r_cap=16,
                                                   device="cpu")
    assert tuple(pcfg) == tuple(jcfg)
    for f in JF.ForkBatch._fields:
        _assert_equal(f, getattr(jb, f), getattr(pb, f))
    rng = np.random.default_rng(2)
    sched = np.full((9, 70), -1, np.int32)
    for r in range(9):
        w = int(rng.integers(1, 71))
        sched[r, :w] = rng.permutation(1000)[:w]
    for width in (8, 32, 70, 128):
        _assert_equal(f"cap {width}", jarrays.cap_schedule_width(sched, width),
                      parrays.cap_schedule_width(sched, width))


def test_fork_dag_batches_match_jax():
    dj, dp = _dags(9, 300, rate=0.1, seed=5)
    jh, ph = _engines(dj, dp)
    _fill(dj.events, jh)
    _fill(dp.events, ph)
    cfg = JF.ForkConfig(n=9, k=2, e_cap=512, s_cap=128, r_cap=32)
    jb = jh.dag.build_batch(cfg)
    pb = ph.dag.build_batch(F.ForkConfig(*cfg), "cpu")
    for f in JF.ForkBatch._fields:
        _assert_equal(f, getattr(jb, f), getattr(pb, f))


# ----------------------------------------------------------------------
# the pipeline and the oracle


@pytest.mark.parametrize("k", [1, 2])
def test_pipeline_matches_jax_on_honest_dag(k):
    dj, dp = _dags(HONEST["n"], HONEST["e"], seed=HONEST["seed"])
    _run_pair(dj, dp, k)


@pytest.mark.parametrize("n,e,rate,seed", BYZ)
def test_pipeline_matches_jax_on_byzantine_dag(n, e, rate, seed):
    dj, dp = _dags(n, e, rate=rate, seed=seed)
    jo = _run_pair(dj, dp, 2)
    assert sum(len(v) for v in jo._fork_pairs.values()) > 0, "no forks"


def test_pipeline_matches_jax_past_the_kernels_k():
    """k = 9 branch slots, one more than ``csrc/fork_ss.cu`` is built
    for: the CPU's plain twin takes it and gives the JAX package's
    pipeline; on the card the engine refuses it when it is built."""
    dj, dp = _dags(6, 200, rate=0.08, seed=3)
    _run_pair(dj, dp, F.FORK_SS_MAX_K + 1)
    with pytest.raises(ValueError, match=r"fork_ss kernel is built for k "
                                         r"in \[1, 8\]"):
        ForkHashgraph(dp.participants, k=F.FORK_SS_MAX_K + 1, device="cuda")
    ForkHashgraph(dp.participants, k=F.FORK_SS_MAX_K, device="cuda")


def test_forked_events_are_unseeable_once_detected():
    dj, dp = _dags(6, 200, rate=0.08, seed=3)
    jh, ph = _engines(dj, dp)
    fo = ForkOracle(dp.participants)
    _fill(dj.events, jh)
    _fill(dp.events, ph, fo)
    fo.run_consensus()
    ph.run_consensus()
    jh.run_consensus()
    checked = 0
    for cid, pairs in fo._fork_pairs.items():
        if not pairs:
            continue
        for x in dp.events[-20:]:
            hx = x.hex()
            det = fo.detects_fork(hx, cid)
            assert ph.detects_fork(hx, cid) == det == jh.detects_fork(hx, cid)
            if not det:
                continue
            for y in dp.events:
                if fo.participants[y.creator] == cid:
                    assert not ph.see(hx, y.hex())
                    assert not jh.see(hx, y.hex())
                    checked += 1
    assert checked > 0, "no detection case exercised"


def test_fork_budget_rejects_spam():
    dj, dp = _dags(6, 300, rate=0.5, seed=11, forks_per_node=5)
    jh, ph = _engines(dj, dp, k=2)
    with pytest.raises(JForkBudgetError) as je:
        _fill(dj.events, jh)
    with pytest.raises(ForkBudgetError) as pe:
        _fill(dp.events, ph)
    assert str(pe.value) == str(je.value)
    assert len(ph.dag.events) == len(jh.dag.events)
    jh6, ph6 = _engines(dj, dp, k=6)
    _fill(dj.events, jh6)
    _fill(dp.events, ph6)
    assert [e.hex() for e in ph6.run_consensus()] == \
        [e.hex() for e in jh6.run_consensus()]
    assert len(ph6.consensus_events()) > 0


# ----------------------------------------------------------------------
# the phases: compare-count twin, order gather, fd strategies, rounds


def _phase_inputs(n=7, e=300, rate=0.08, seed=9, k=2):
    dj, dp = _dags(n, e, rate=rate, seed=seed)
    jh, ph = _engines(dj, dp, k=k)
    _fill(dj.events, jh)
    _fill(dp.events, ph)
    cfg, _ = jh._run()
    jb = jh.dag.build_batch(cfg)
    return JF.ForkConfig(*cfg), jb, _batch_pair(cfg, jb), jh, ph


def _jax_front(cfg, jb):
    la = jax.jit(lambda b: JF._la_scan(cfg, b))(jb)
    det = jax.jit(lambda b, l: JF._detect(cfg, b, l))(jb, la)
    fdet = jax.jit(lambda b, d: JF._first_det(cfg, b, d))(jb, det)
    fd = jax.jit(lambda b: JF._fd_reverse(cfg, b))(jb)
    helper = jax.jit(lambda b, f, r: JF._helper(cfg, b, f, r))(jb, fd, fdet)
    return la, det, fdet, fd, helper


def test_ss_counts_plain_matches_jax_at_both_call_shapes():
    cfg, jb, pb, jh, _ = _phase_inputs()
    la, det, _, _, helper = _jax_front(cfg, jb)
    _, out = jh._run()
    la_n, det_n, h_n = (np.asarray(a) for a in (la, det, helper))
    # the closure's shape: every event against one candidate per branch
    ws = np.asarray(out.wslot)[1]
    hw = np.where((ws >= 0)[:, None], h_n[np.where(ws < 0, cfg.e_cap, ws)],
                  np.iinfo(np.int32).max).astype(np.int32)
    want = jax.jit(lambda a, d, h: JF._ss_counts(
        cfg, a[:, None, :], d[:, None, :], h[None, :, :]))(la_n, det_n, hw)
    got = F.ss_counts(torch.tensor(la_n)[None], torch.tensor(det_n)[None],
                      torch.tensor(hw)[None], cfg.k)[0]
    _assert_equal("closure shape", want, got)
    assert int(np.asarray(want).max()) >= cfg.super_majority
    # the fame's shape: [R, A, W] over the witness table
    wsl = np.asarray(out.wslot)[:cfg.r_cap]
    wsx = np.where(wsl < 0, cfg.e_cap, wsl)
    law, detw = la_n[wsx], det_n[wsx]
    hww = np.where((wsl >= 0)[:, :, None], h_n[wsx],
                   np.iinfo(np.int32).max).astype(np.int32)
    want = jax.jit(lambda a, d, h: JF._ss_counts(
        cfg, a[:, :, None, :], d[:, :, None, :], h[:, None, :, :]))(
            law, detw, hww)
    got = F.ss_counts(torch.tensor(law), torch.tensor(detw),
                      torch.tensor(hww), cfg.k)
    _assert_equal("fame shape", want, got)


@pytest.mark.parametrize("g,x,w,n,k", [(1, 37, 70, 13, 2), (3, 65, 129, 11, 3),
                                       (2, 5, 3, 40, 1)])
def test_ss_counts_plain_matches_jax_on_random_inputs(g, x, w, n, k):
    rng = np.random.default_rng(g * 100 + x)
    la = rng.integers(-1, 40, (g, x, n * k)).astype(np.int32)
    hw = rng.integers(0, 45, (g, w, n * k)).astype(np.int32)
    hw[hw >= 40] = np.iinfo(np.int32).max
    det = rng.random((g, x, n)) < 0.2
    cfg = JF.ForkConfig(n=n, k=k, e_cap=8, s_cap=8, r_cap=8)
    want = JF._ss_counts(cfg, la[:, :, None, :], det[:, :, None, :],
                         hw[:, None, :, :])
    got = F.ss_counts(torch.tensor(la), torch.tensor(det), torch.tensor(hw), k)
    _assert_equal("random", want, got)
    # the chunked path: a budget of one row per chunk
    budget = F.PLAIN_BUDGET_BYTES
    try:
        F.PLAIN_BUDGET_BYTES = 1
        got = F.ss_counts(torch.tensor(la), torch.tensor(det),
                          torch.tensor(hw), k)
    finally:
        F.PLAIN_BUDGET_BYTES = budget
    _assert_equal("chunked", want, got)


def test_ss_counts_checks_its_arguments():
    la = torch.zeros((1, 4, 6), dtype=torch.int32)
    det = torch.zeros((1, 4, 3), dtype=torch.bool)
    hw = torch.zeros((1, 5, 6), dtype=torch.int32)
    assert F.ss_counts(la, det, hw, 2).shape == (1, 4, 5)
    with pytest.raises(ValueError):
        F.ss_counts(la, det, hw, 3)
    with pytest.raises(ValueError):
        F.ss_counts(la.long(), det, hw, 2)
    with pytest.raises(ValueError):
        F.ss_counts(la, det[:, :3], hw, 2)


def test_order_gather_matches_the_jax_loop():
    """``_order``'s one gather against the JAX package's s_cap+1 masked
    passes, on a rolled window (nonzero chain offsets, INF fds)."""
    dj, dp = _dags(6, 600, rate=0.05, seed=11)
    kw = dict(auto_compact=True, round_margin=1, seq_window=6, compact_min=16)
    jh, ph = _engines(dj, dp, **kw)
    for i in range(0, 600, 100):
        _fill(dj.events[i:i + 100], jh)
        _fill(dp.events[i:i + 100], ph)
        jh.run_consensus()
        ph.run_consensus()
    assert jh.dag.evicted > 0
    jh._dirty = ph._dirty = True
    cfg, jout = jh._run()
    jb = jh.dag.build_batch(cfg)
    assert int(np.asarray(jb.s_off).max()) > 0
    la, det, fdet, fd, helper = _jax_front(cfg, jb)
    args = (fd, fdet, jout.wslot, jout.famous, jout.round, jout.max_round)
    want = jax.jit(lambda b, *a: JF._order(cfg, b, *a))(jb, *args)
    pb = _batch_pair(cfg, jb)
    got = F._order(F.ForkConfig(*cfg), pb,
                   *(torch.tensor(np.asarray(a)) for a in args))
    _assert_equal("rr", want[0], got[0])
    _assert_equal("cts", want[1], got[1])
    assert (np.asarray(want[0]) >= 0).any()
    # the gather itself against the loop, written out
    ts_grid = np.asarray(jb.ts)[np.where(np.asarray(jb.ce) < 0, cfg.e_cap,
                                         np.asarray(jb.ce))]
    fdc = np.clip(np.asarray(fd) - np.asarray(jb.s_off)[None], 0, cfg.s_cap)
    tv = np.full(fdc.shape, np.iinfo(np.int64).max)
    for s in range(cfg.s_cap + 1):
        tv = np.where(fdc == s, ts_grid[:, s][None, :], tv)
    got_tv = torch.gather(torch.tensor(ts_grid).T, 0,
                          torch.tensor(fdc).long())
    _assert_equal("tv", tv, got_tv)


def test_fd_reverse_matches_fd_chains():
    cfg, jb, pb, _, _ = _phase_inputs()
    la = F._la_scan(cfg, pb)
    a = F._fd_reverse(cfg, pb)
    c = F._fd_chains(cfg, pb, la)
    _assert_equal("reverse vs chains", a, c)
    _assert_equal("la", jax.jit(lambda b: JF._la_scan(cfg, b))(jb), la)
    _assert_equal("fd", jax.jit(lambda b: JF._fd_reverse(cfg, b))(jb), a)
    jc = jax.jit(lambda b, l: JF._fd_chains(cfg, b, l))(jb, np.asarray(la))
    _assert_equal("fd chains", jc, c)


@pytest.mark.parametrize("seed,tight", [(3, False), (9, True), (21, True)])
def test_rounds_closure_matches_level_scan(seed, tight):
    dj, dp = _dags(9, 400, rate=0.06, seed=seed)
    jh, ph = _engines(dj, dp)
    _fill(dj.events, jh)
    _fill(dp.events, ph)
    cfg, _ = jh._run()

    def run(cfg):
        jb = jh.dag.build_batch(cfg)
        la, det, _, _, helper = _jax_front(cfg, jb)
        jscan = jax.jit(functools.partial(JF._rounds_scan, cfg))(
            jb, la, det, helper)
        jclos = jax.jit(functools.partial(JF._rounds_closure, cfg))(
            jb, la, det, helper)
        pcfg = F.ForkConfig(*cfg)
        args = (_batch_pair(cfg, jb),
                *(torch.tensor(np.asarray(a)) for a in (la, det, helper)))
        return (jscan, jclos, F._rounds_scan(pcfg, *args),
                F._rounds_closure(pcfg, *args))

    outs = run(cfg)
    if tight:
        cfg = cfg._replace(r_cap=int(outs[0][3]) + 1)
        outs = run(cfg)
    for label, got in zip(("JAX closure", "port scan", "port closure"),
                          outs[1:]):
        for name, a, b in zip(("round", "witness", "wslot", "max_round"),
                              outs[0], got):
            _assert_equal(f"{label} {name}", a, b)
    assert int(outs[0][3]) >= 1


def test_pipeline_sentinel_rows_stay_sentinel():
    cfg, jb, pb, _, _ = _phase_inputs(6, 220, 0.1, 4)
    la = F._la_scan(cfg, pb)
    fd = F._fd_reverse(cfg, pb)
    assert (la[cfg.e_cap] == -1).all()
    assert (fd[cfg.e_cap] == np.iinfo(np.int32).max).all()
    out = F.fork_pipeline(cfg, pb)
    assert int(out.round[cfg.e_cap]) == -1
    assert not bool(out.witness[cfg.e_cap])
    assert (out.wslot[cfg.r_cap] == -1).all()
    _assert_forkout(JF.fork_pipeline(cfg, jb), out)


# ----------------------------------------------------------------------
# the rolling window


def test_windowed_fork_engine_matches_unevicted():
    dj, dp = _dags(6, 600, rate=0.05, seed=11)
    kw = dict(auto_compact=True, round_margin=1, seq_window=6, compact_min=16)
    jr, pr = _engines(dj, dp, **kw)
    plain = ForkHashgraph(dp.participants, k=2, device="cpu")
    step = 100
    got, want, flat = [], [], []
    for i in range(0, 600, step):
        for ev in dp.events[i:i + step]:
            plain.insert_event(ev)
            pr.insert_event(pr.read_wire_info(plain.to_wire(ev)))
        for ev in dj.events[i:i + step]:
            jr.insert_event(ev.clone())
        flat += [(e.hex(), e.round_received, e.consensus_timestamp)
                 for e in plain.run_consensus()]
        got += [(e.hex(), e.round_received, e.consensus_timestamp)
                for e in pr.run_consensus()]
        want += [(e.hex(), e.round_received, e.consensus_timestamp)
                 for e in jr.run_consensus()]
        assert pr.dag.evicted == jr.dag.evicted
        assert pr.dag.r_off == jr.dag.r_off
        assert pr.stats_snapshot() == jr.stats_snapshot()
    assert pr.dag.evicted > 0, "window never rolled"
    assert got == want == flat
    assert pr._lcr_cache == jr._lcr_cache == plain._lcr_cache
    assert pr.max_round() == jr.max_round() == plain.max_round()
    for s in range(len(pr.dag.events)):
        x = pr.dag.events[s].hex()
        assert pr.round(x) == plain.round(x) == jr.round(x), x
    assert pr.known() == plain.known() == jr.known()
    assert pr.commit_digest == jr.commit_digest


def _laggard_events(make_event):
    """The JAX package's laggard-chain DAG: a fast supermajority gossips
    among itself while two laggards whisper to each other, then merge."""
    n, n_fast = 9, 7
    rng = np.random.default_rng(5)

    def fake_pub(i):
        return b"\x04" + i.to_bytes(32, "big") + bytes(32)

    participants = {("0x" + fake_pub(i).hex().upper()): i for i in range(n)}
    pubs = [fake_pub(i) for i in range(n)]
    heads, seqs = [None] * n, [0] * n
    events = []
    t = [0]

    def mint(recv, send):
        t[0] += 1
        ts = 1_700_000_000_000_000_000 + t[0] * 2_000_000
        parents = ("", "") if heads[recv] is None else (
            heads[recv], heads[send])
        ev = make_event([], parents, pubs[recv], seqs[recv], timestamp=ts)
        ev.r = int(rng.integers(1, 1 << 62))
        ev.s = int(rng.integers(1, 1 << 62))
        events.append(ev)
        heads[recv] = ev.hex()
        seqs[recv] += 1

    for i in range(n):
        mint(i, i)
    for step in range(700):
        recv = int(rng.integers(0, n_fast))
        send = int(rng.integers(0, n_fast - 1))
        if send >= recv:
            send += 1
        mint(recv, send)
        if step % 60 == 30:
            mint(7, 8)
        if step % 60 == 45:
            mint(8, 7)
    mint(7, 8)
    mint(0, 7)
    for _ in range(60):
        recv = int(rng.integers(0, n_fast))
        send = int(rng.integers(0, n_fast - 1))
        if send >= recv:
            send += 1
        mint(recv, send)
    return participants, events


def test_laggard_chains_block_unsafe_eviction():
    parts, pev = _laggard_events(new_event)
    _, jev = _laggard_events(jnew_event)
    assert [e.hex() for e in pev] == [e.hex() for e in jev]
    kw = dict(auto_compact=True, round_margin=1, seq_window=4, compact_min=8)
    jr = JForkHashgraph(parts, k=2, **kw)
    pr = ForkHashgraph(parts, k=2, device="cpu", **kw)
    plain = ForkHashgraph(parts, k=2, device="cpu")
    got, want, flat = [], [], []
    for i in range(0, len(pev), 80):
        for ev in pev[i:i + 80]:
            plain.insert_event(ev)
            pr.insert_event(pr.read_wire_info(plain.to_wire(ev)))
        _fill(jev[i:i + 80], jr)
        flat += [(e.hex(), e.round_received) for e in plain.run_consensus()]
        got += [(e.hex(), e.round_received) for e in pr.run_consensus()]
        want += [(e.hex(), e.round_received) for e in jr.run_consensus()]
        assert pr.dag.evicted == jr.dag.evicted
    assert plain.max_round() >= 4, "fast group never outran the laggards"
    assert got == want == flat
    assert pr._lcr_cache == jr._lcr_cache == plain._lcr_cache
    for s in range(len(pr.dag.events)):
        x = pr.dag.events[s].hex()
        assert pr.round(x) == plain.round(x) == jr.round(x), x


def _liar_events(make_event):
    n, liar = 4, 3
    lie_ns = 3_600_000_000_000
    rng = np.random.default_rng(11)

    def fake_pub(i):
        return b"\x04" + i.to_bytes(32, "big") + bytes(32)

    participants = {("0x" + fake_pub(i).hex().upper()): i for i in range(n)}
    pubs = [fake_pub(i) for i in range(n)]
    heads, seqs = [None] * n, [0] * n
    events = []
    t = [0]

    def mint(recv, send):
        t[0] += 1
        ts = 1_700_000_000_000_000_000 + t[0] * 2_000_000
        if recv == liar and heads[recv] is not None:
            ts += lie_ns
        parents = ("", "") if heads[recv] is None else (
            heads[recv], heads[send])
        ev = make_event([], parents, pubs[recv], seqs[recv], timestamp=ts)
        ev.r = int(rng.integers(1, 1 << 62))
        ev.s = int(rng.integers(1, 1 << 62))
        events.append(ev)
        heads[recv] = ev.hex()
        seqs[recv] += 1

    for i in range(n):
        mint(i, i)
    for _ in range(140):
        recv = int(rng.integers(0, n))
        send = int(rng.integers(0, n - 1))
        if send >= recv:
            send += 1
        mint(recv, send)
    return participants, events, liar


def test_fork_engine_clamps_lying_timestamps():
    from babble_tpu.store.checkpoint import snapshot_bytes as jsnap
    from babble_tpu_torch.store.checkpoint import load_snapshot, snapshot_bytes

    parts, pev, liar = _liar_events(new_event)
    _, jev, _ = _liar_events(jnew_event)
    fo = ForkOracle(parts)
    ph = ForkHashgraph(parts, k=2, device="cpu")
    jh = JForkHashgraph(parts, k=2)
    _fill(pev, fo, ph)
    _fill(jev, jh)
    committed = ph.run_consensus()
    committed_o = fo.run_consensus()
    committed_j = jh.run_consensus()
    clamped = 0
    for s, ev in enumerate(ph.dag.events):
        eff, claimed = ph.dag.eff_ts[s], ev.body.timestamp
        assert fo._eff_ts[ev.hex()] == eff == jh.dag.eff_ts[s]
        if parts[ev.creator] == liar and ev.body.index > 0:
            clamped += eff < claimed
        else:
            assert eff >= claimed
    assert clamped > 0, "generator produced no lying events"
    rows = [(e.hex(), e.consensus_timestamp) for e in committed]
    assert rows and rows == [(e.hex(), e.consensus_timestamp)
                             for e in committed_o]
    assert rows == [(e.hex(), e.consensus_timestamp) for e in committed_j]
    # the clamp state survives the snapshot seam, across the packages
    snap = snapshot_bytes(ph)
    assert snap == jsnap(jh)
    ph2 = load_snapshot(snap, verify_events=False, device="cpu")
    assert ph2.dag.eff_ts == ph.dag.eff_ts


# ----------------------------------------------------------------------
# chip_smoke.py phase 11(c)'s reference


def test_byz_summary_and_chip_smokes_mid_size():
    """chip_smoke.py phase 11(c) holds the card to ``BYZ_EXPECT``, this
    file's ``main`` over ``BYZ_MID``: the same summary of a JAX and a
    port run of one batch.  Its max_round sits far below r_cap - 1, so
    the port's fame loop, which stops at max_round (read once), is held
    to JAX's fori_loop where most of the round rows are empty."""
    import chip_smoke

    assert chip_smoke.BYZ_MID == BYZ_MID
    jcfg, jb = jarrays.random_byzantine_fork_batch(16, 600, seed=11,
                                                   fork_rate=0.05)
    pcfg, pb = parrays.random_byzantine_fork_batch(16, 600, seed=11,
                                                   fork_rate=0.05,
                                                   device="cpu")
    want = byz_summary(JF.fork_pipeline(jcfg, jb), 600)
    assert byz_summary(F.fork_pipeline(pcfg, pb), 600) == want
    assert want["ordered"] > 0 and want["detecting"] > 0
    assert want["max_round"] < pcfg.r_cap // 8


def test_chip_smokes_engine_expectation(capsys):
    """chip_smoke.py phase 11(d)'s byzantine engine: the JAX
    ``ForkHashgraph`` over ``random_byzantine_dag(**BYZ_ENGINE)`` commits
    ``BYZ_ENGINE_EXPECT``, and the smoke's own round trip passes on the
    CPU engine."""
    import chip_smoke

    dag = jgen.random_byzantine_dag(**chip_smoke.BYZ_ENGINE)
    jh = JForkHashgraph(dag.participants)
    for ev in dag.events:
        jh.insert_event(ev)
    jh.run_consensus()
    assert dict(commit_length=jh.commit_length, lcr=jh.lcr,
                commit_digest=jh.commit_digest) == \
        chip_smoke.BYZ_ENGINE_EXPECT
    chip_smoke.byz_engine_round_trip("cpu", 0)
    assert "== BYZ_ENGINE_EXPECT" in capsys.readouterr().out


def test_chip_smokes_fork_ss_bound():
    """fork_ss' bound at the 1024 x 100k run's two call shapes: the
    fewest lane operations any design reading the window-relative 16-bit
    coordinates needs (one a 32-bit word pair, two creators' branch k,
    and one a word of results OR'd over the K planes, at 128 a clock an
    SM), about 12.3 ms at the closure's shape and 3.1 ms at the fame's;
    beside it the int32 figure (X*W*B compares on the ALU pipe, the adds
    beside them), 32.867 and 8.217 ms; and bytes bound a tiny call."""
    import chip_smoke

    ms, by, int32_ms = chip_smoke.ss_bound(1, 131_073, 2048, 1024, 2)
    assert by == "operations"
    assert ms == pytest.approx(131_073 * 2048 * 512 * 3
                               / (132 * 128 * 1.98e9) * 1e3)
    assert ms == pytest.approx(12.32, abs=0.01)
    assert int32_ms == pytest.approx(131_073 * 2048 * 2048
                                     / (132 * 64 * 1.98e9) * 1e3)
    assert int32_ms == pytest.approx(32.867, abs=0.001)
    ms, _, int32_ms = chip_smoke.ss_bound(16, 2048, 2048, 1024, 2)
    assert ms == pytest.approx(3.08, abs=0.01)
    assert int32_ms == pytest.approx(8.217, abs=0.001)
    # odd N: a word holds two creators, so 131 creators are 66 words
    ms, _, _ = chip_smoke.ss_bound(1, 10_000, 10_000, 131, 3)
    assert ms == pytest.approx(10_000 * 10_000 * 66 * 4
                               / (132 * 128 * 1.98e9) * 1e3)
    ms, by, _ = chip_smoke.ss_bound(1, 4, 4, 1024, 2)
    assert by == "bytes"


def main() -> None:
    m = BYZ_MID
    cfg, batch = jarrays.random_byzantine_fork_batch(
        m["n"], m["e"], seed=m["seed"], fork_rate=m["fork_rate"])
    out = JF.fork_pipeline(cfg, batch)
    print("BYZ_EXPECT = " + json.dumps(byz_summary(out, m["e"])))


if __name__ == "__main__":
    main()
