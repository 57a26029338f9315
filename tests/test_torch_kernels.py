"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: each test decides in its body whether a CUDA card is
present and skips itself otherwise (so every pytest worker collects the
same tests).  On a machine with a card and the CUDA toolkit, run

    python -m pytest tests/test_torch_kernels.py -m gpu
"""

import os

import pytest
import torch

from babble_tpu_torch import (
    DagConfig, assert_consensus_parity, batch_from_arrays, consensus_step,
    init_state, random_gossip_arrays,
)
from babble_tpu_torch.ops.ingest import _write_batch_fields
from babble_tpu_torch.ops.pallas_ingest import (
    kernel_attributes, la_walk, la_walk_phases, la_walk_plain,
    walk_supported,
)
from babble_tpu_torch.sim.arrays import random_walk_arrays
from chip_smoke import FORK_SS_CASES

# csrc/la_walk.cu resolves slot order in windows of this many slots (kW)
WINDOW = 1024
# the walk gate's largest e_cap, and the shared memory a Hopper block may use
GATE_E_CAP = 94661
SMEM_OPTIN = 232_448
# seqs across 32,767 (int16 wrap) and 65,536 (the TPU kernel's lane spill)
WRAPPED = [32700, 65500, 0, 40000, 70000, 131000, 5, 65536]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _walk_inputs(n, e, seed, dev, n_live=None):
    dag = random_gossip_arrays(n, e, seed=seed)
    cfg = DagConfig(n=n, e_cap=e, s_cap=max(64, dag.max_chain + 1), r_cap=64)
    st = _write_batch_fields(init_state(cfg, device=dev), cfg,
                             batch_from_arrays(dag, device=dev))
    ne = st.n_events if n_live is None else torch.tensor(
        n_live, dtype=torch.int32, device=dev)
    return (st.sp, st.op, st.creator, st.seq, ne, cfg.e_cap, cfg.n)


def _synthetic_inputs(n, e, seed, dev, n_live=None, **kw):
    a = random_walk_arrays(n, e, seed=seed, **kw)
    t = [torch.from_numpy(a[k]).to(dev) for k in ("sp", "op", "creator", "seq")]
    ne = torch.tensor(e if n_live is None else n_live, dtype=torch.int32,
                      device=dev)
    return (*t, ne, e, n)


def _check_kernel(args):
    before = la_walk.launches
    got = la_walk(*args)
    torch.cuda.synchronize()
    assert la_walk.launches == before + 1
    want = la_walk_plain(*args)
    e, n = args[5], args[6]
    assert got.dtype == torch.int32 and got.shape == (e + 1, n)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,e,seed,n_live", [
    (2, 64, 0, None), (4, 300, 1, None), (8, 1024, 13, 700),
    (33, 5000, 2, None), (64, 8192, 7, None),
    (4, WINDOW - 1, 3, None), (4, WINDOW, 3, None), (4, WINDOW + 1, 3, None),
    (8, 1024, 13, 0),
])
def test_la_walk_kernel_matches_plain(n, e, seed, n_live):
    _need_card()
    _check_kernel(_walk_inputs(n, e, seed, torch.device("cuda"), n_live))


@pytest.mark.gpu
@pytest.mark.parametrize("n,e,kw", [
    (1, 3000, {}),
    (64, 4000, {}),
    (8, 4096, dict(seq_base=WRAPPED)),
    (3, 2000, dict(seq_base=2**31 - 1000)),
    (64, GATE_E_CAP, {}),
    (5, 3000, dict(topological=False)),
    (64, 4000, dict(topological=False)),
])
def test_la_walk_kernel_matches_plain_synthetic(n, e, kw):
    """n = 1 and n = 64, wrapped seqs, the walk gate's largest e_cap, and
    input that is not topological (which must return, not hang)."""
    _need_card()
    _check_kernel(_synthetic_inputs(n, e, 5, torch.device("cuda"), **kw))


@pytest.mark.gpu
def test_la_walk_kernel_limits():
    _need_card()
    attrs = kernel_attributes(GATE_E_CAP)
    assert attrs["local_bytes"] == 0, "la_walk_kernel spills to local memory"
    assert attrs["static_smem"] + attrs["dynamic_smem"] <= SMEM_OPTIN
    assert walk_supported(64, GATE_E_CAP, 64)
    assert not walk_supported(64, GATE_E_CAP + 1, 64)
    args = list(_synthetic_inputs(4, GATE_E_CAP + 1, 0,
                                  torch.device("cuda"), n_live=10))
    with pytest.raises(ValueError, match="walk mode admits"):
        la_walk(*args)


@pytest.mark.gpu
def test_la_walk_phases_reads_the_kernel_clock():
    _need_card()
    args = _synthetic_inputs(16, 5000, 1, torch.device("cuda"))
    la, prof = la_walk_phases(*args)
    assert torch.equal(la, la_walk_plain(*args))
    assert prof.shape == (16, 4)
    assert bool((prof[:, 1] >= prof[:, 0]).all())
    assert bool((prof[:, 2] >= prof[:, 1]).all())
    # a window takes at least its 32 lanes' share of slots in rounds, and
    # at most one round a slot (rounds run four between warp votes)
    windows = -(-5000 // WINDOW)
    assert bool((prof[:, 3] >= 5000 // 32).all())
    assert bool((prof[:, 3] <= windows * (WINDOW + 4)).all())


@pytest.mark.gpu
def test_la_walk_kernel_rejects_mixed_devices():
    _need_card()
    args = list(_walk_inputs(4, 300, 1, torch.device("cuda")))
    args[1] = args[1].cpu()
    with pytest.raises(ValueError, match="op on cpu"):
        la_walk(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["walk", "fast"])
def test_step_on_card_matches_cpu(mode):
    _need_card()
    dag = random_gossip_arrays(8, 1024, seed=13)
    cfg = DagConfig(n=8, e_cap=1024, s_cap=max(64, dag.max_chain + 1),
                    r_cap=64)
    ref = consensus_step(cfg, mode, init_state(cfg, device="cpu"),
                         batch_from_arrays(dag, device="cpu"))
    out = consensus_step(cfg, mode, init_state(cfg, device="cuda"),
                         batch_from_arrays(dag, device="cuda"))
    assert_consensus_parity(ref, out, cfg.e_cap, f"{mode} cpu vs card")


@pytest.mark.gpu
@pytest.mark.parametrize("gate", [False, True])
def test_live_stream_on_card_matches_cpu(gate):
    from babble_tpu_torch import live_stream

    _need_card()
    dag = random_gossip_arrays(8, 1024, seed=13)
    cfg = DagConfig(n=8, e_cap=1024, s_cap=max(64, dag.max_chain + 1),
                    r_cap=64, packed=True)
    ref, ref_log = live_stream(cfg, dag, 64, gate, device="cpu")
    out, log = live_stream(cfg, dag, 64, gate, device="cuda")
    assert [(r.k, r.W, r.F, r.lcr) for r in log] == \
        [(r.k, r.W, r.F, r.lcr) for r in ref_log]
    for f, a, b in zip(ref._fields, ref, out):
        assert torch.equal(a, b.cpu()), f


def _engine_run(device, kw, chunk):
    """A small engine flow on ``device``: committed ids per call, the
    commit digest and the final state on the host."""
    from babble_tpu_torch import TorchHashgraph, random_gossip_dag

    gen = random_gossip_dag(8, 600, seed=17)
    eng = TorchHashgraph(gen.participants, verify_signatures=False,
                         device=device, **kw)
    calls = []
    for lo in range(0, 600, chunk):
        for ev in gen.events[lo:lo + chunk]:
            eng.insert_event(ev.clone())
        calls.append(([e.hex() for e in eng.run_consensus()],
                      eng.last_kernel_class))
    calls.append(([e.hex() for e in eng.run_consensus()],
                  eng.last_kernel_class))
    host = [None if t is None else t.cpu() for t in eng.state]
    return calls, eng.commit_digest, eng.stats_snapshot(), host


@pytest.mark.gpu
@pytest.mark.parametrize("chunk,kw", [
    # a live node: gated, auto dispatch, rolling windows from small caps
    (32, dict(finality_gate=True, e_cap=64, s_cap=16, r_cap=8,
              auto_compact=True, seq_window=16, compact_min=32)),
    # catch-up: one bulk call on the throughput surface
    (600, dict()),
])
def test_engine_on_card_matches_cpu(chunk, kw):
    _need_card()
    ref = _engine_run("cpu", kw, chunk)
    out = _engine_run("cuda", kw, chunk)
    assert out[:3] == ref[:3]
    for a, b in zip(ref[3], out[3]):
        assert (a is None and b is None) or torch.equal(a, b)


def _churn_run(device, tmp):
    """A small churn flow on ``device`` (a pipelined pair of joins, a
    leave) with a save_checkpoint/load_checkpoint while one transition is
    pending and another queued: committed ids per call, the membership
    log, the commit digest and the final state on the host."""
    from babble_tpu_torch import TorchHashgraph
    from babble_tpu_torch.sim.generator import feed_churn, random_churn_dag
    from babble_tpu_torch.store import load_checkpoint, save_checkpoint

    dag = random_churn_dag(8, 900, 5, [
        (40, "join", 8, 0), (48, "join", 9, 0), (100, "garbage", 0, 0),
        (300, "start", 8, 1), (340, "start", 9, 2), (500, "leave", 5, 2),
        (700, "stop", 5, 0)])
    eng = TorchHashgraph(dict(dag.participants), verify_signatures=False,
                         device=device, finality_gate=True, e_cap=32,
                         s_cap=8, r_cap=4, auto_compact=True, seq_window=6,
                         compact_min=16)
    calls, restarted = [], False
    for lo in range(0, 900 + 64, 32):
        feed_churn(eng, dag, min(lo, 900), min(lo + 32, 900))
        calls.append([e.hex() for e in eng.run_consensus()])
        if not restarted and eng.pending_membership and eng.membership_queue:
            path = os.path.join(tmp, device)
            save_checkpoint(eng, path)
            eng = load_checkpoint(path, device=device)
            eng.finality_gate = True
            assert eng.state.sp.device.type == device
            restarted = True
    assert restarted and eng.epoch == 3
    log = [(e["epoch"], e["kind"], e["cid"], e["boundary"])
           for e in eng.membership_log]
    host = [t.cpu() for t in eng.state]
    return calls, log, eng.commit_digest, host


@pytest.mark.gpu
def test_churn_with_checkpoint_on_card_matches_cpu(tmp_path):
    _need_card()
    ref = _churn_run("cpu", str(tmp_path))
    out = _churn_run("cuda", str(tmp_path))
    assert out[:3] == ref[:3]
    for a, b in zip(ref[3], out[3]):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# fork_ss: the fork strongly-see compare-count (csrc/fork_ss.cu)


@pytest.mark.gpu
@pytest.mark.parametrize("g,x,w,n,k", [(1, 1000, 77, 37, 2), (3, 130, 64, 9, 3),
                                       (2, 64, 200, 1025, 2),
                                       (1, 65, 63, 9, 8), (4, 1, 1, 1, 1)])
def test_fork_ss_kernel_matches_plain(g, x, w, n, k):
    _need_card()
    from babble_tpu_torch.ops.forks import ss_counts, ss_counts_plain

    gen = torch.Generator().manual_seed(x + w)
    la = torch.randint(-1, 40, (g, x, n * k), generator=gen,
                       dtype=torch.int32).cuda()
    hw = torch.randint(0, 45, (g, w, n * k), generator=gen,
                       dtype=torch.int32)
    hw[hw >= 40] = 2**31 - 1
    hw = hw.cuda()
    det = (torch.rand((g, x, n), generator=gen) < 0.2).cuda()
    before = ss_counts.launches
    got = ss_counts(la, det, hw, k)
    torch.cuda.synchronize()
    assert ss_counts.launches == before + 1
    assert torch.equal(got, ss_counts_plain(la, det, hw, k))
    assert torch.equal(got.cpu(), ss_counts(la.cpu(), det.cpu(), hw.cpu(), k))


@pytest.mark.gpu
def test_fork_pipeline_on_card_matches_cpu():
    """A small byzantine DAG through the whole fork pipeline on the card
    (fork_ss launched) and on the CPU (the plain twin): every field."""
    _need_card()
    from babble_tpu_torch.ops import forks as F
    from babble_tpu_torch.sim.arrays import random_byzantine_fork_arrays

    cfg, arrays = random_byzantine_fork_arrays(32, 2048, seed=11,
                                               fork_rate=0.02)
    before = F.ss_counts.launches
    out = F.fork_pipeline(cfg, F.fork_batch_from_numpy(arrays, "cuda"))
    ref = F.fork_pipeline(cfg, F.fork_batch_from_numpy(arrays, "cpu"))
    assert F.ss_counts.launches > before
    for name in F.ForkOut._fields:
        assert torch.equal(getattr(out, name).cpu(), getattr(ref, name)), name


@pytest.mark.gpu
@pytest.mark.parametrize("k", range(1, 9))
def test_fork_ss_packed_matches_plain(k):
    """The packed kernel on window-relative int16 planes (absolute
    indices past 40,000, evicted-looking ancestors, detected creators,
    INF witnesses, N off the 8-creator planes) against the plain twin on
    the int32 rows and on the planes, and the CPU's narrowed path."""
    _need_card()
    from babble_tpu_torch.ops import forks as F
    from chip_smoke import fork_ss_case

    la, det, hw, s_off, s_cap = fork_ss_case(2, 300, 200, 13 + 2 * k, k,
                                             seed=k, device="cuda")
    win = F.SsWindow(s_off, s_cap)
    before = F.ss_counts.launches
    got = F.ss_counts(la, det, hw, k, window=win)
    torch.cuda.synchronize()
    assert F.ss_counts.launches == before + 1
    assert torch.equal(got, F.ss_counts_plain(la, det, hw, k))
    assert torch.equal(got, F.ss_counts_planes_plain(
        win.viewer(la, det, k), win.witness(hw, k), k))
    cpu = F.ss_counts(la.cpu(), det.cpu(), hw.cpu(), k,
                      window=F.SsWindow(s_off.cpu(), s_cap))
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("name,g,x,w,n,k,opts", FORK_SS_CASES)
def test_fork_ss_cases_on_card(name, g, x, w, n, k, opts):
    """chip_smoke.py phase 11(a)'s cases: the packed path with the
    window and the int32 path without one, each one launch, exact."""
    _need_card()
    from babble_tpu_torch.ops import forks as F
    from chip_smoke import fork_ss_case

    la, det, hw, s_off, s_cap = fork_ss_case(g, x, w, n, k, seed=5,
                                             device="cuda", **opts)
    want = F.ss_counts_plain(la, det, hw, k)
    for win in (F.SsWindow(s_off, s_cap), None):
        before = F.ss_counts.launches
        got = F.ss_counts(la, det, hw, k, window=win)
        torch.cuda.synchronize()
        assert F.ss_counts.launches == before + 1
        assert torch.equal(got, want), (name, win is None)


@pytest.mark.gpu
def test_fork_engine_with_evicted_window_on_card_matches_cpu():
    """A rolling-window ``ForkHashgraph`` (chain offsets past 0) on the
    card, its fork_ss calls packed, against the same engine on the CPU:
    the commits after every call and every ``ForkOut`` field."""
    _need_card()
    from babble_tpu_torch.consensus.fork_engine import ForkHashgraph
    from babble_tpu_torch.ops import forks as F
    from babble_tpu_torch.sim.generator import random_byzantine_dag

    dag = random_byzantine_dag(6, 600, seed=11, fork_rate=0.05)
    kw = dict(k=2, auto_compact=True, round_margin=1, seq_window=6,
              compact_min=16)
    card = ForkHashgraph(dag.participants, device="cuda", **kw)
    cpu = ForkHashgraph(dag.participants, device="cpu", **kw)
    before = F.ss_counts.launches
    for i in range(0, 600, 100):
        rows = []
        for eng in (card, cpu):
            for ev in dag.events[i:i + 100]:
                eng.insert_event(ev.clone())
            rows.append([(e.hex(), e.round_received, e.consensus_timestamp)
                         for e in eng.run_consensus()])
        assert rows[0] == rows[1]
    assert card.dag.evicted > 0 and F.ss_counts.launches > before
    (_, out), (_, ref) = card._run(), cpu._run()
    for name in F.ForkOut._fields:
        assert torch.equal(getattr(out, name).cpu(), getattr(ref, name)), name


@pytest.mark.gpu
def test_fork_ss_rejects_what_it_does_not_take():
    _need_card()
    from babble_tpu_torch.ops.forks import ss_counts

    la = torch.zeros((1, 4, 6), dtype=torch.int32, device="cuda")
    det = torch.zeros((1, 4, 3), dtype=torch.bool, device="cuda")
    hw = torch.zeros((1, 5, 6), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        ss_counts(la, det.cpu(), hw, 2)
    with pytest.raises(ValueError):
        ss_counts(la, det, hw, 3)
    with pytest.raises(ValueError):
        ss_counts(la.float(), det, hw, 2)
    # k = 9: the kernel is built for k up to 8; the CPU twin takes it
    la9 = torch.zeros((1, 4, 18), dtype=torch.int32, device="cuda")
    det9 = torch.zeros((1, 4, 2), dtype=torch.bool, device="cuda")
    hw9 = torch.zeros((1, 5, 18), dtype=torch.int32, device="cuda")
    before = ss_counts.launches
    with pytest.raises(ValueError, match=r"k in \[1, 8\]"):
        ss_counts(la9, det9, hw9, 9)
    assert ss_counts.launches == before
    assert ss_counts(la9.cpu(), det9.cpu(), hw9.cpu(), 9).shape == (1, 4, 5)
