"""The fork strongly-see compare-count's narrowing, on the CPU.

The packed kernel of ``csrc/fork_ss.cu`` reads window-relative int16
branch planes with the detection mask folded into the viewer side
(``ops/forks.py viewer_planes``, ``witness_planes``), not the int32
rows.  Here the narrowing runs in plain torch and ``ss_counts_plain``
runs on its planes (``ss_counts_planes_plain``, the packed kernel's
twin); that must equal ``ss_counts_plain`` on the int32 rows and the
JAX package's ``_ss_counts``:

- at K 1 to 8, on ``chip_smoke.fork_ss_case``'s inputs: absolute chain
  indices past 40,000 (far outside int16), evicted-looking ancestors
  (below the window), detected creators, INF witnesses, N off the
  8-creator planes; and at the edges (every creator detected, all-INF
  witness rows, s_cap at the int16 edge, the int32 path past it);
- ``fork_pipeline`` on batches of a ``ForkHashgraph`` whose rolling
  window has evicted (``s_off > 0``), with the narrowed plain path as
  its ``ss``, and on the same batches moved 40,000 chain indices up:
  every ``ForkOut`` field equal to the int32 plain run.
"""

import numpy as np
import pytest
import torch

from babble_tpu.ops import forks as JF

from babble_tpu_torch.consensus.fork_engine import ForkHashgraph
from babble_tpu_torch.ops import forks as F
from babble_tpu_torch.ops.state import INT32_MAX
from babble_tpu_torch.sim import generator as pgen
from chip_smoke import FORK_SS_CASES, fork_ss_case, plain_fork_ss


def _jax_counts(la, det, hw, k):
    n = det.shape[2]
    cfg = JF.ForkConfig(n=n, k=k, e_cap=8, s_cap=8, r_cap=8)
    return np.asarray(JF._ss_counts(cfg, la.numpy()[:, :, None, :],
                                    det.numpy()[:, :, None, :],
                                    hw.numpy()[:, None, :, :]))


def _check_planes(view, wit, la, det, hw, s_off, s_cap, k):
    """The planes' layout and values, entry by entry: plane kk, creator c
    holds column c*k + kk, window-relative plus one (0 for a detected
    creator or an ancestor below the window), LANE_MAX for no helper,
    and the pads lose every compare."""
    g, x, b = la.shape
    n = b // k
    np_ = -(-n // F.PLANE_ALIGN) * F.PLANE_ALIGN
    assert view.dtype == wit.dtype == torch.int16
    assert tuple(view.shape) == (g, x, k, np_)
    assert tuple(wit.shape) == (g, hw.shape[1], k, np_)
    assert view.is_contiguous() and wit.is_contiguous()
    assert (view[..., n:] == 0).all() and (wit[..., n:] == F.LANE_MAX).all()
    v = torch.where((la >= s_off) & ~det.repeat_interleave(k, -1),
                    la - s_off + 1, 0)
    h = torch.where(hw == INT32_MAX, F.LANE_MAX, hw - s_off + 1)
    # the window's top reaches the planes (fork_ss_case puts it there)
    if (~det).any():
        assert int(v.max()) == s_cap
    if (hw < INT32_MAX).any():
        assert int(h[hw < INT32_MAX].max()) == s_cap
    assert torch.equal(view[..., :n].transpose(-1, -2).reshape(g, x, b),
                       v.to(torch.int16))
    assert torch.equal(wit[..., :n].transpose(-1, -2).reshape(g, -1, b),
                       h.to(torch.int16))


@pytest.mark.parametrize("k", range(1, F.FORK_SS_MAX_K + 1))
def test_narrowed_planes_count_as_the_int32_rows(k):
    n = 13 + 2 * k                       # never a multiple of 8
    la, det, hw, s_off, s_cap = fork_ss_case(2, 37, 29, n, k, seed=k)
    # the case holds what the narrowing must survive
    assert int(s_off.max()) >= 40_000 and n % F.PLANE_ALIGN
    assert ((la >= 0) & (la < s_off)).any(), "no evicted-looking ancestor"
    assert (la == -1).any() and det.any() and (~det).any()
    assert (hw == INT32_MAX).any() and (hw < INT32_MAX).any()
    win = F.SsWindow(s_off, s_cap)
    assert win.narrow
    view, wit = win.viewer(la, det, k), win.witness(hw, k)
    _check_planes(view, wit, la, det, hw, s_off, s_cap, k)
    want = F.ss_counts_plain(la, det, hw, k)
    assert torch.equal(F.ss_counts_planes_plain(view, wit, k), want)
    assert torch.equal(F.ss_counts(la, det, hw, k, window=win), want)
    assert np.array_equal(_jax_counts(la, det, hw, k), want.numpy())
    assert int(want.max()) > 0
    # the viewer planes are kept for the next call on the same rows
    assert win.viewer(la, det, k) is view
    assert win.viewer(la.clone(), det, k) is not view


@pytest.mark.parametrize("name,g,x,w,n,k,opts", FORK_SS_CASES)
def test_narrowing_at_the_edges(name, g, x, w, n, k, opts):
    """``chip_smoke.py`` phase 11(a)'s cases, cut to CPU size: the
    narrowed count, the int32 count and JAX's agree, and a window past
    the int16 edge takes the int32 path."""
    la, det, hw, s_off, s_cap = fork_ss_case(g, min(x, 60), min(w, 50),
                                             min(n, 40), k, seed=3, **opts)
    n = det.shape[2]
    win = F.SsWindow(s_off, s_cap)
    view, wit = win.viewer(la, det, k), win.witness(hw, k)
    _check_planes(view, wit, la, det, hw, s_off, s_cap, k)
    want = F.ss_counts_plain(la, det, hw, k)
    assert torch.equal(F.ss_counts_planes_plain(view, wit, k), want), name
    assert torch.equal(F.ss_counts(la, det, hw, k, window=win), want)
    assert np.array_equal(_jax_counts(la, det, hw, k), want.numpy())
    if opts.get("det_rate") == 1.0 or opts.get("inf_rate") == 1.0:
        assert int(want.max()) == 0
    else:
        assert int(want.max()) > 0
    if opts.get("s_cap") == "edge":
        assert s_cap == F.FORK_SS_NARROW_S_CAP
        assert int(view.max()) > 30_000
        wide = F.SsWindow(s_off, s_cap + 1)
        assert not wide.narrow
        assert torch.equal(F.ss_counts(la, det, hw, k, window=wide), want)


def test_the_width_is_chosen_without_reading_the_device():
    """The narrow/int32 choice reads ``s_cap`` alone: a window over a
    ``meta`` tensor (no data at all) answers it."""
    s_off = torch.empty(64, dtype=torch.int32, device="meta")
    assert F.SsWindow(s_off, F.FORK_SS_NARROW_S_CAP).narrow
    assert not F.SsWindow(s_off, F.FORK_SS_NARROW_S_CAP + 1).narrow


def _shifted(cfg, b, d):
    """``b`` with every absolute chain index ``d`` higher: event indices,
    window offsets and the finite common-prefix lengths (a chain
    membership test ``q < cp`` moves with them)."""
    cp = b.cp
    return b._replace(
        eseq=torch.where(b.eseq >= 0, b.eseq + d, b.eseq),
        s_off=b.s_off + d,
        cp=torch.where((cp > 0) & (cp < INT32_MAX), cp + d, cp))


def test_pipeline_narrowed_equals_int32_on_evicted_windows():
    dag = pgen.random_byzantine_dag(6, 600, seed=11, fork_rate=0.05)
    eng = ForkHashgraph(dag.participants, k=2, device="cpu",
                        auto_compact=True, round_margin=1, seq_window=6,
                        compact_min=16)
    seen = []

    def narrowed(la_x, det_x, helper_w, k, window):
        assert window.narrow
        seen.append(int(window.s_off.max()))
        return F.ss_counts_planes_plain(window.viewer(la_x, det_x, k),
                                        window.witness(helper_w, k), k)

    runs = 0
    for i in range(0, 600, 100):
        for ev in dag.events[i:i + 100]:
            eng.insert_event(ev)
        eng.run_consensus()
        if eng.dag.evicted == 0:
            continue
        eng._dirty = True
        cfg, _ = eng._run()
        batch = eng.dag.build_batch(cfg, "cpu")
        assert int(batch.s_off.max()) > 0
        want = F.fork_pipeline(cfg, batch, ss=plain_fork_ss)
        got = F.fork_pipeline(cfg, batch, ss=narrowed)
        for name in F.ForkOut._fields:
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        # the same window 40,000 chain indices up: the counts, hence
        # rounds, witnesses, fame and order, are unchanged
        up = _shifted(cfg, batch, 40_000)
        got = F.fork_pipeline(cfg, up, ss=narrowed)
        ref = F.fork_pipeline(cfg, up, ss=plain_fork_ss)
        for name in F.ForkOut._fields:
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
        for name in ("det", "round", "witness", "wslot", "famous", "rr",
                     "cts", "max_round", "lcr"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert torch.equal(got.la, torch.where(want.la >= 0,
                                               want.la + 40_000, -1))
        runs += 1
    assert runs >= 3 and max(seen) >= 40_000
    assert int(want.lcr) >= 0
