"""The port's rolling-window stream (``ops/stream.py``) against the JAX
package's, on the CPU.

The JAX package's ``tests/test_stream.py`` cases run here through both
packages' ``stream_consensus`` on the same DAG: the ordered set (global
slot -> round received, consensus timestamp), lcr, the evictions, every
state tensor, the blocked la/fd, the march carry and the stats are
compared exactly, with compaction and window rolls engaged, at C > 1
and at int8, int16 and int32 coordinates.  The stacked form runs on one
device, and its mesh-sharded form (``mesh=``) on two gloo rank
processes (``tests/torch_parallel_ranks.py``) against JAX's sharded
stream.
"""

import json

import numpy as np
import pytest
import torch

from babble_tpu.ops.state import DagConfig as JConfig
from babble_tpu.ops.stream import _padded_schedule as j_padded_schedule
from babble_tpu.ops.stream import slice_batch as j_slice_batch
from babble_tpu.ops.stream import stream_consensus as jstream
from babble_tpu.sim.arrays import random_gossip_arrays as jarrays

from babble_tpu_torch import random_gossip_arrays
from babble_tpu_torch.obs import Registry
from babble_tpu_torch.ops import wide as W
from babble_tpu_torch.ops.state import DagConfig
from babble_tpu_torch.ops.stream import (
    WideStream, _padded_schedule, slice_batch, stream_consensus,
)

CPU = "cpu"
STATE = ("round", "witness", "rr", "cts", "wslot", "famous", "lcr",
         "max_round", "n_events", "e_off", "r_off", "s_off", "ce", "cnt",
         "sp", "op", "creator", "seq", "ts", "mbit")


def _blocks(b):
    if isinstance(b, (tuple, list)):
        return np.stack([np.asarray(x) if not hasattr(x, "numpy")
                         else x.numpy() for x in b])
    return b.numpy() if hasattr(b, "numpy") else np.asarray(b)


def _run_both(n, e, seed, cfg, **run):
    """The JAX package's and the port's stream over one DAG."""
    js = jstream(JConfig(**cfg), jarrays(n, e, seed=seed), **run)
    ps = stream_consensus(DagConfig(**cfg), random_gossip_arrays(n, e,
                                                                 seed=seed),
                          device=CPU, **run)
    return js, ps


def _assert_streams_equal(js, ps, label=""):
    assert ps.ordered_total == js.ordered_total, label
    assert ps.ordered == js.ordered, f"{label}: rr/cts diverged"
    assert (ps.lcr, ps.evicted, ps.e_off) == (js.lcr, js.evicted, js.e_off)
    assert ps.stats == js.stats, label
    assert set(ps.timings) == set(js.timings), label
    for f in STATE:
        a, b = np.asarray(getattr(js.state, f)), getattr(ps.state, f).numpy()
        assert a.dtype == b.dtype and (a == b).all(), f"{label}: {f}"
    for name in ("la_blocks", "fd_blocks"):
        a, b = _blocks(getattr(js, name)), _blocks(getattr(ps, name))
        assert a.dtype == b.dtype and (a == b).all(), f"{label}: {name}"
    assert (np.asarray(js.carry.pos_table)
            == ps.carry.pos_table.numpy()).all(), label
    assert (np.asarray(js.carry.cnt_prev)
            == ps.carry.cnt_prev.numpy()).all(), label
    assert (ps._rr_seen == js._rr_seen).all(), label


@pytest.mark.parametrize("narrow", [{}, dict(coord8=True),
                                    dict(coord16=True)])
def test_stream_with_compaction_equals_jax(narrow):
    """~18 rounds of a 24-participant DAG through a ~1.5-round window
    with aggressive eviction and forced 3-way blocking."""
    cfg = dict(n=24, e_cap=1400, s_cap=110, r_cap=16, **narrow)
    js, ps = _run_both(24, 2800, 13, cfg, batch_events=350, n_blocks=3,
                       round_margin=0, seq_window=16, compact_min=64)
    assert ps.evicted > 400 and ps.ordered_total > 2000
    _assert_streams_equal(js, ps, str(narrow))


def test_stream_single_batch_equals_jax_and_the_pipeline():
    """One mega-batch (no compaction) equals JAX's stream, and its rr the
    one-shot wide pipeline's."""
    from babble_tpu_torch import batch_from_arrays

    dag = random_gossip_arrays(24, 900, seed=5)
    cfg = dict(n=24, e_cap=900, s_cap=dag.max_chain + 3, r_cap=32)
    js, ps = _run_both(24, 900, 5, cfg, batch_events=900, n_blocks=3,
                       compact_min=10**9)
    _assert_streams_equal(js, ps, "single batch")
    wide = W.run_wide_pipeline(DagConfig(**cfg),
                               batch_from_arrays(dag, device=CPU), n_blocks=3)
    assert torch.equal(wide.rr[:900], ps.state.rr[:900])


def test_stream_round_values_survive_window_roll():
    """Rounds of still-live events after several compactions (the
    frontier-finalize stale-round merge) equal JAX's, at C = 2."""
    cfg = dict(n=24, e_cap=1300, s_cap=110, r_cap=16)
    js, ps = _run_both(24, 2000, 21, cfg, batch_events=300, n_blocks=2,
                       seq_window=16, compact_min=64)
    assert ps.evicted > 0
    _assert_streams_equal(js, ps, "window roll")


def test_stream_refuses_window_overflow_as_jax_does():
    cfg = dict(n=8, e_cap=128, s_cap=64, r_cap=16)
    run = dict(batch_events=200, compact_min=10**9)
    with pytest.raises(ValueError, match="overflow|depth") as jerr:
        jstream(JConfig(**cfg), jarrays(8, 400, seed=2), **run)
    with pytest.raises(ValueError, match="overflow|depth") as perr:
        stream_consensus(DagConfig(**cfg), random_gossip_arrays(8, 400,
                                                                seed=2),
                         device=CPU, **run)
    assert str(perr.value) == str(jerr.value)


def test_stream_stacked_equals_jax_and_mesh_sharded_equals_jax(tmp_path):
    """The stacked block form (one [C, E+1, w] tensor on one device)
    equals JAX's stacked stream; the mesh-sharded form (``mesh=`` over a
    (1, 2) mesh of gloo ranks, 2 blocks a rank) equals JAX's sharded
    stream (mesh (1, 4), one block a device) on everything the stacked
    form is held to, its blocks gathered over "p"."""
    from babble_tpu.parallel.mesh import make_mesh as jmake_mesh

    from tests.torch_parallel_ranks import launch

    cfg = dict(n=24, e_cap=1400, s_cap=110, r_cap=16)
    run = dict(batch_events=350, n_blocks=4, round_margin=0,
               seq_window=16, compact_min=64, stacked=True)
    js, ps = _run_both(24, 2800, 13, cfg, **run)
    assert ps.evicted > 0 and ps.la_blocks.shape == (4, 1401, 6)
    _assert_streams_equal(js, ps, "stacked")

    run.pop("stacked")
    jm = jstream(JConfig(**cfg), jarrays(24, 2800, seed=13),
                 mesh=jmake_mesh(4, shape=(1, 4)), **run)
    launch(str(tmp_path), "stream")
    got = np.load(tmp_path / "stream2.npz")
    ordered = {int(k): (int(r), int(c)) for k, r, c in got["ordered"]}
    assert ordered == jm.ordered == js.ordered
    assert got["scalars"].tolist() == [jm.ordered_total, jm.lcr, jm.evicted,
                                       jm.e_off]
    assert str(got["stats"]) == json.dumps(jm.stats, sort_keys=True)
    assert got["timings"].tolist() == sorted(jm.timings)
    for f in STATE:
        a, b = np.asarray(getattr(jm.state, f)), got[f"state_{f}"]
        assert a.dtype == b.dtype and (a == b).all(), f"mesh: {f}"
    for name in ("la_blocks", "fd_blocks"):
        a, b = _blocks(getattr(jm, name)), got[name]
        assert a.dtype == b.dtype and (a == b).all(), f"mesh: {name}"
    assert (np.asarray(jm.carry.pos_table) == got["pos_table"]).all()
    assert (np.asarray(jm.carry.cnt_prev) == got["cnt_prev"]).all()
    assert (jm._rr_seen == got["rr_seen"]).all()
    assert got["local_blocks"].tolist() == [2, 1401, 6]
    widths = [json.loads(w) for w in got["widths"]]
    assert widths == [{"ss_count": [12]}] * 2


def test_stream_deadline_and_registry_stages():
    """``deadline_s`` stops cleanly after the current batch as in JAX
    (``truncated``, ``events_ingested``), and every stage lands in the
    ``babble_wide_stage_seconds`` histogram of the given registry."""
    cfg = dict(n=24, e_cap=1400, s_cap=110, r_cap=16, coord8=True)
    reg = Registry()
    run = dict(batch_events=350, n_blocks=3, seq_window=16, compact_min=64,
               deadline_s=0.0)
    js = jstream(JConfig(**cfg), jarrays(24, 2800, seed=13), **run)
    ps = stream_consensus(DagConfig(**cfg), random_gossip_arrays(
        24, 2800, seed=13), device=CPU, registry=reg, **run)
    assert ps.stats == js.stats and ps.stats["truncated"] is True
    assert ps.stats["events_ingested"] == 350 == js.stats["events_ingested"]
    assert ps.ordered == js.ordered
    fam = reg.get("babble_wide_stage_seconds")
    assert [fam.labels(st).count for st in ("coords", "rounds", "fame",
                                            "order")] == [1, 1, 1, 1]
    assert "babble_wide_stage_seconds" in reg.exposition()
    other = Registry()
    ps.rebind_registry(other)
    assert ps.registry is other
    assert other.get("babble_wide_stage_seconds") is not None


def test_slice_batch_and_schedules_equal_jax():
    """slice_batch (window-row parents, bucketed shapes) and the padded
    level schedules equal JAX's; an evicted parent is refused."""
    jd, pd = jarrays(16, 700, seed=9), random_gossip_arrays(16, 700, seed=9)
    for a, b, e_off in ((0, 300, 0), (300, 650, 120), (100, 101, 40)):
        jb, pb = j_slice_batch(jd, a, b, e_off), slice_batch(pd, a, b, e_off,
                                                             device=CPU)
        for f in jb._fields:
            x, y = np.asarray(getattr(jb, f)), getattr(pb, f).numpy()
            assert x.dtype == y.dtype and (x == y).all(), (a, b, f)
    for lo, hi, fill in ((0, 700, -1), (200, 650, 699)):
        assert (j_padded_schedule(jd.levels[lo:hi], fill)
                == _padded_schedule(pd.levels[lo:hi], fill)).all()
    with pytest.raises(ValueError, match="evicted parent"):
        slice_batch(pd, 300, 650, 600, device=CPU)


def test_compact_block_in_row_chunks(monkeypatch):
    """compact_block shifts and rebases a block in place in ascending row
    chunks; any chunk size gives JAX's compaction (here 7 rows, so the
    shift crosses chunk edges)."""
    from babble_tpu.ops.wide import _jits as jjits

    cfg = dict(n=5, e_cap=40, s_cap=60, r_cap=8, coord8=True)
    gen = np.random.default_rng(3)
    for is_fd in (False, True):
        blk = gen.integers(-1, 50, (41, 3)).astype(np.int8)
        blk[gen.random((41, 3)) < 0.2] = 127 if is_fd else -1
        blk[40] = 127 if is_fd else -1
        ds = np.array([3, 0, 9], np.int32)
        want = np.asarray(jjits(JConfig(**cfg), 2)["compact_block"](
            blk.copy(), 11, ds, is_fd))
        monkeypatch.setattr(W, "COMPACT_ROWS", 7)
        got = torch.from_numpy(blk.copy())
        out = W._jits(DagConfig(**cfg), 2)["compact_block"](
            got, 11, torch.from_numpy(ds), is_fd)
        assert out is got and (got.numpy() == want).all(), is_fd
