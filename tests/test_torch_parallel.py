"""The port's multi-device layer (``babble_tpu_torch/parallel/``) against
the JAX package's, on the CPU.

The JAX side runs here, on the virtual 8-device CPU mesh of
``tests/conftest.py``.  The port's side runs once for the module: one
group of 8 gloo rank processes (``tests/torch_parallel_ranks.py``, no
jax imported) that runs every case and writes its outputs.  Each case of
``tests/test_parallel.py`` is mirrored at its shapes, seeds and meshes,
and held to the JAX sharded program and to JAX's single device; so are
mode "walk" at p = 2 (``la_walk`` on a column range) and the sharded
stream of ``tests/test_stream.py`` at p = 4.  Every integer tensor is
compared exactly (tolerance zero), and every case asserts the columns
each rank's compare-counts received: N/p (B/p for the fork step, C/p
blocks of w for the stream), never the whole width.  The dry run's
entry point (``parallel/dryrun.py main``) runs over four spawned gloo
ranks, and its refusal of NCCL without a card a rank is pinned.
"""

import functools
import json
from types import SimpleNamespace

import numpy as np
import pytest

import jax

from babble_tpu.consensus.engine import TpuHashgraph
from babble_tpu.ops.forks import fork_pipeline_impl
from babble_tpu.ops.pallas_ingest import la_walk as jax_la_walk
from babble_tpu.ops.pallas_ingest import unpack_la
from babble_tpu.ops.state import DagConfig as JConfig
from babble_tpu.ops.state import init_state as jinit_state
from babble_tpu.ops.stream import stream_consensus as jstream
from babble_tpu.ops.wide import _init_blocks_stacked as j_init_blocks
from babble_tpu.parallel import make_mesh as jmake_mesh
from babble_tpu.parallel import make_sharded_step as jmake_sharded_step
from babble_tpu.parallel import pad_cfg_for_mesh as jpad_cfg
from babble_tpu.parallel import sharded_init_state as jsharded_init
from babble_tpu.parallel.mesh import _factor as jfactor
from babble_tpu.parallel.multihost import global_mesh as jglobal_mesh
from babble_tpu.parallel.multihost import make_multihost_step as jmultihost
from babble_tpu.parallel.sharded import consensus_step_impl as jstep_impl
from babble_tpu.parallel.sharded import make_sharded_fork_step as jfork_step
from babble_tpu.parallel.sharded import pad_fork_for_mesh as jpad_fork
from babble_tpu.sim.arrays import batch_from_arrays as jbatch
from babble_tpu.sim.arrays import random_byzantine_fork_batch as jfork_batch
from babble_tpu.sim.arrays import random_gossip_arrays as jarrays
from babble_tpu.sim.generator import random_gossip_dag

import torch

from babble_tpu_torch.ops.pallas_ingest import la_walk, la_walk_plain
from babble_tpu_torch.ops.state import DagConfig
from babble_tpu_torch.parallel.mesh import _factor, make_mesh
from babble_tpu_torch.parallel.multihost import bootstrap
from babble_tpu_torch.parallel.sharded import (
    make_sharded_fork_step, make_sharded_step, pad_cfg_for_mesh,
)
from babble_tpu_torch.ops.wide import _init_blocks_stacked
from babble_tpu_torch.sim.arrays import (
    batch_from_arrays, random_gossip_arrays, random_walk_arrays,
)

from tests.torch_parallel_ranks import launch

STATE = ("sp", "op", "creator", "seq", "ts", "mbit", "la", "fd", "round",
         "witness", "rr", "cts", "ce", "cnt", "wslot", "famous", "sm",
         "mbr", "fmr", "n_events", "max_round", "lcr", "e_off", "s_off",
         "r_off")
FORK = ("la", "det", "fd", "round", "witness", "wslot", "famous", "rr",
        "cts", "max_round", "lcr")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's outputs, one npz a case, from one 8-rank gloo group."""
    out = tmp_path_factory.mktemp("ranks")
    launch(str(out), "all")
    return lambda name: np.load(out / f"{name}.npz")


def _equal(jax_tree, got, fields, label):
    for f in fields:
        a, b = np.asarray(getattr(jax_tree, f)), got[f]
        assert a.dtype == b.dtype and a.shape == b.shape, (label, f)
        assert (a == b).all(), f"{label}: {f} differs on {(a != b).sum()}"


def _widths(got, want_cols, sites):
    """Every rank's compare-counts saw ``want_cols`` columns, at each of
    ``sites`` (and nowhere a different width)."""
    per_rank = [json.loads(w) for w in got["widths"]]
    assert len(per_rank) == 8
    for rank, widths in enumerate(per_rank):
        assert set(widths) == set(sites), (rank, widths)
        assert all(v == [want_cols] for v in widths.values()), (rank, widths)


def _single_chip(dag, caps):
    eng = TpuHashgraph(dag.participants, verify_signatures=False, **caps)
    for ev in dag.events:
        eng.insert_event(ev)
    eng.run_consensus()
    return eng


@pytest.mark.parametrize("n_part,fd_mode",
                         [(6, "full"), (8, "full"), (6, "fast"),
                          (6, "incremental")])
def test_sharded_step_equals_jax_sharded_and_single_chip(port, n_part,
                                                         fd_mode):
    """test_parallel.py's first case on the port's (4, 2) mesh: equal to
    JAX's sharded step on every state field and to the single-chip engine
    on the consensus decisions; n = 6 pads N to the p = 2 axis.  Mode
    "incremental" (the live fd fill) is one case more."""
    caps = dict(e_cap=255, s_cap=64, r_cap=32)
    dag = random_gossip_dag(n_part, 180, seed=5)
    eng = _single_chip(dag, caps)
    ne = eng.dag.n_events
    eng2 = TpuHashgraph(dag.participants, verify_signatures=False, **caps)
    for ev in dag.events:
        eng2.insert_event(ev)
    batch, _ = eng2.build_batch()
    mesh = jmake_mesh(8)
    cfg = jpad_cfg(JConfig(n=n_part, e_cap=eng.cfg.e_cap,
                           s_cap=eng.cfg.s_cap, r_cap=eng.cfg.r_cap), mesh)
    out = jmake_sharded_step(cfg, mesh, fd_mode)(jsharded_init(cfg, mesh),
                                                  batch)

    got = port(f"step_{n_part}_{fd_mode}")
    _equal(out, got, STATE, f"step {n_part} {fd_mode}")
    ref = eng.state
    for f in ("round", "witness", "rr", "cts"):
        assert (got[f][:ne] == np.asarray(getattr(ref, f))[:ne]).all(), f
    r = eng.cfg.r_cap
    assert (got["famous"][:r, :n_part]
            == np.asarray(ref.famous)[:r, :n_part]).all()
    assert int(got["lcr"]) == int(ref.lcr)
    rounds = "frontier" if fd_mode == "fast" else "rounds_level"
    _widths(got, cfg.n // 2, (rounds, "fame_diag", "order_sees"))


def test_pad_cfg_for_mesh_and_factor_equal_jax():
    mesh = jmake_mesh(8)
    shape = SimpleNamespace(shape=dict(mesh.shape))
    for n, e in ((5, 100), (8, 127), (13, 999)):
        want = jpad_cfg(JConfig(n=n, e_cap=e, s_cap=16, r_cap=8), mesh)
        got = pad_cfg_for_mesh(DagConfig(n=n, e_cap=e, s_cap=16, r_cap=8),
                               shape)
        assert tuple(got) == tuple(want)
        assert got.super_majority == want.super_majority
    cfg = pad_cfg_for_mesh(DagConfig(n=5, e_cap=100, s_cap=16, r_cap=8),
                           shape)
    assert cfg.n % 2 == 0 and (cfg.e_cap + 1) % 4 == 0
    assert cfg.n_real == 5 and cfg.super_majority == 2 * 5 // 3 + 1
    assert [_factor(n) for n in range(1, 65)] \
        == [jfactor(n) for n in range(1, 65)]


def test_mesh_factorization_and_collectives(port):
    """make_mesh's shapes equal JAX's; a shape that does not match the
    world raises; the four collectives give their values on the (4, 2)
    grid, and rank 0's batch reaches every rank."""
    got = port("mesh")
    shapes = json.loads(str(got["shapes"]))
    assert shapes["default"] == list(jmake_mesh(8).shape.values()) == [4, 2]
    assert shapes["2x4"] == [2, 4]
    assert make_mesh(1, device="cpu").shape == {"ev": 1, "p": 1} \
        == dict(jmake_mesh(1).shape)
    assert _factor(4) == (2, 2) == tuple(jmake_mesh(4).shape.values())
    refused = list(got["refused"])
    assert len(refused) == 3
    assert "world of 8" in refused[0]
    assert "mesh shape (3, 3) != device count 8" == refused[1]
    assert "requested 16 devices, only 8 available" == refused[2]
    assert (got["grid"] == np.arange(8).reshape(4, 2)).all()
    assert (got["gather_p"] == np.repeat([0, 1], 3)[None, :]).all()
    assert (got["gather_ev"][:, 0] == np.repeat([0, 2, 4, 6], 2)).all()
    assert (got["sum_world"] == 28).all() and (got["max_p"] == 1).all()
    assert got["any_world"].tolist() == [True, False]
    assert got["bcast"].tolist() == [0, 1, 2, 3]
    assert got["big"].tolist() == [2 ** 62, 2 ** 62 + 1]
    assert json.loads(str(got["coll_stats"])) == {
        "broadcast": {"calls": 1, "bytes": 32},
        "gather": {"calls": 3, "bytes": 96 + 192 + 16},
        "max": {"calls": 2, "bytes": 48 + 2},
        "sum": {"calls": 1, "bytes": 48},
    }
    src = batch_from_arrays(random_gossip_arrays(5, 60, seed=0),
                            device="cpu")
    for f, t in zip(src._fields, src):
        b = got[f"batch_{f}"]
        assert b.dtype == t.numpy().dtype and (b == t.numpy()).all(), f


def test_multihost_hybrid_mesh_parity(port):
    """2 pretend hosts x 4 ranks ("ev" across hosts, "p" inside one):
    the port's grid is JAX's, and its step equals JAX's hybrid step and
    the single device."""
    n, e = 8, 768
    dag = jarrays(n, e, seed=21)
    cfg = JConfig(n=n, e_cap=e, s_cap=max(64, dag.max_chain + 1), r_cap=32)
    mesh = jglobal_mesh(jax.devices(), dcn_axis=2)
    _, pcfg, state, step = jmultihost(cfg, mesh)
    batch = jbatch(dag)
    out = step(state, batch)
    ref = jax.jit(functools.partial(jstep_impl, pcfg, "full"))(
        jinit_state(pcfg), batch)

    got = port("hybrid")
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    assert got["grid"].shape == ids.shape == (2, 4)
    assert (got["grid"] == ids).all()
    assert int(got["e_cap"]) == pcfg.e_cap
    _equal(out, got, STATE, "hybrid")
    _equal(ref, got, STATE, "hybrid vs one device")
    _widths(got, 2, ("rounds_level", "fame_diag", "order_sees"))


def test_sharded_fork_pipeline_parity(port):
    """The fork pipeline with branch columns over "p" (B = 24 -> 12 a
    rank) equals JAX's sharded and single-device runs on every field."""
    cfg, batch = jfork_batch(12, 600, seed=13, fork_rate=0.08, r_cap=16)
    mesh = jmake_mesh(8)
    cfg, batch = jpad_fork(cfg, batch, mesh)
    sharded = jfork_step(cfg, mesh)(batch)
    ref = jax.jit(functools.partial(fork_pipeline_impl, cfg))(batch)
    got = port("fork")
    _equal(sharded, got, FORK, "fork")
    _equal(ref, got, FORK, "fork vs one device")
    assert int(got["det"].sum()) > 0
    _widths(got, cfg.b // 2, ("fork_closure", "fork_fame",
                              "fork_order_sees"))


def test_sharded_honest_parity_larger_shape(port):
    """256 x 20k in mode "fast" on the (4, 2) mesh: 128 columns a rank."""
    n, e = 256, 20_000
    dag = jarrays(n, e, seed=31)
    batch = jbatch(dag)
    mesh = jmake_mesh(8)
    cfg = jpad_cfg(JConfig(n=n, e_cap=e, s_cap=dag.max_chain + 2,
                           r_cap=16), mesh)
    sharded = jmake_sharded_step(cfg, mesh, "fast")(jsharded_init(cfg, mesh),
                                                     batch)
    ref = jax.jit(functools.partial(jstep_impl, cfg, "fast"))(
        jinit_state(cfg), batch)
    got = port("large")
    keep = ("round", "witness", "rr", "cts", "wslot", "famous", "lcr",
            "n_events", "la", "fd")
    _equal(sharded, got, keep, "256x20k")
    _equal(ref, got, keep, "256x20k vs one device")
    assert int(got["lcr"]) >= 1
    assert int((got["rr"][:e] >= 0).sum()) > 1000
    _widths(got, 128, ("frontier", "fame_diag", "order_sees"))


def test_sharded_walk_mode_equals_jax(port):
    """Mode "walk" at p = 2: each rank's la_walk fills its 4 of the 8
    columns; the step equals JAX's walk step (Pallas in interpret mode)
    on every state field."""
    dag = jarrays(8, 400, seed=3)
    cfg = jpad_cfg(JConfig(n=8, e_cap=400, s_cap=max(64, dag.max_chain + 1),
                           r_cap=32), jmake_mesh(8))
    ref = jax.jit(functools.partial(jstep_impl, cfg, "walk"))(
        jinit_state(cfg), jbatch(dag))
    got = port("walk")
    _equal(ref, got, STATE, "walk")
    assert int(got["lcr"]) > 0
    _widths(got, 4, ("frontier", "fame_diag", "order_sees"))


def test_sharded_block_fame_equals_jax(port):
    """The block form of fame on column shards (forced past its
    threshold in the ranks; per round, the votes over each rank's
    witness columns and the undecided test OR-ed over "p") equals JAX's
    diagonal fame on one device, the walk case's DAG in mode "fast"."""
    dag = jarrays(8, 400, seed=3)
    cfg = jpad_cfg(JConfig(n=8, e_cap=400, s_cap=max(64, dag.max_chain + 1),
                           r_cap=32), jmake_mesh(8))
    ref = jax.jit(functools.partial(jstep_impl, cfg, "fast"))(
        jinit_state(cfg), jbatch(dag))
    got = port("block_fame")
    _equal(ref, got, STATE, "block fame")
    _widths(got, 4, ("frontier", "fame_block", "order_sees"))


def test_sharded_stream_equals_jax(port):
    """tests/test_stream.py's sharded stream (JAX: mesh (1, 8), 8 blocks)
    on the port's (2, 4) mesh: 2 blocks a rank, every ordered event,
    lcr, eviction and window state equal."""
    cfg = JConfig(n=24, e_cap=1400, s_cap=110, r_cap=16)
    dag = jarrays(24, 2800, seed=13)
    js = jstream(cfg, dag, batch_events=350, n_blocks=8, round_margin=0,
                 seq_window=16, compact_min=64,
                 mesh=jmake_mesh(8, shape=(1, 8)))
    got = port("stream")
    ordered = {int(k): (int(r), int(c)) for k, r, c in got["ordered"]}
    assert js.evicted > 0 and int(got["evicted"]) == js.evicted
    assert ordered == js.ordered and len(ordered) == js.ordered_total
    assert int(got["lcr"]) == js.lcr
    assert got["blocks"].tolist() == [2, 1401, 3]
    state = {f: got[f"state_{f}"] for f in STATE if f not in ("la", "fd")}
    _equal(js.state, state, state, "stream state")
    _widths(got, 6, ("ss_count",))


def test_la_walk_plain_column_range_equals_jax():
    """la_walk's plain twin over a column range [c0, c0 + w) is that
    slice of the JAX kernel's table, wrapped seqs and spilled lanes
    included; a range past n is refused."""
    import jax.numpy as jnp

    for n, e, base in ((8, 1000, [32700, 65500, 0, 40000, 70000, 131000,
                                  5, 65536]),
                       (6, 300, [0] * 6)):
        a = random_walk_arrays(n, e, seed=n + e, seq_base=base)
        packed = jax_la_walk(e, n, *(jnp.asarray(a[f]) for f in
                                     ("sp", "op", "creator", "seq")),
                             e, True)
        full = np.asarray(unpack_la(e, n, packed, e))
        t = {f: torch.from_numpy(np.ascontiguousarray(a[f]))
             for f in ("sp", "op", "creator", "seq")}
        ne = torch.tensor(e, dtype=torch.int32)
        for c0, w in ((0, n), (0, n // 2), (n // 2, n // 2), (n - 1, 1)):
            got = la_walk_plain(t["sp"], t["op"], t["creator"], t["seq"],
                                ne, e, n, c0, w)
            assert (got.numpy() == full[:, c0:c0 + w]).all(), (n, c0, w)
            via = la_walk(t["sp"], t["op"], t["creator"], t["seq"], ne, e,
                          n, c0, w)
            assert torch.equal(via, got)
        with pytest.raises(ValueError, match="outside"):
            la_walk(t["sp"], t["op"], t["creator"], t["seq"], ne, e, n,
                    n - 1, 2)


def test_refusals_equal_jax():
    """The sharded forms refuse what JAX's refuse, with JAX's texts: a
    "p" that does not divide the creators (fork step) or the blocks
    (stream); the honest step runs every fd mode but "absorb"."""
    mesh = SimpleNamespace(shape={"ev": 1, "p": 5})
    cfg, batch = jfork_batch(12, 200, seed=13, fork_rate=0.08, r_cap=16)
    with pytest.raises(ValueError) as jerr:
        jfork_step(cfg, SimpleNamespace(shape={"p": 5}))
    with pytest.raises(ValueError) as perr:
        make_sharded_fork_step(cfg, mesh)
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        j_init_blocks(JConfig(n=24, e_cap=100, s_cap=16, r_cap=8), 4,
                      SimpleNamespace(shape={"p": 3}))
    with pytest.raises(ValueError) as perr:
        _init_blocks_stacked(DagConfig(n=24, e_cap=100, s_cap=16, r_cap=8),
                             4, SimpleNamespace(shape={"p": 3}), device="cpu")
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="fd modes"):
        make_sharded_step(DagConfig(n=8, e_cap=63, s_cap=16, r_cap=8),
                          mesh, "absorb")


def test_dryrun_main_certifies_four_gloo_ranks():
    """The dry-run entry point as its users run it: four spawned gloo
    ranks on the CPU (mesh (2, 2), so both axes are real) certify the
    five programs against the single-device port; exit 0."""
    from babble_tpu_torch.parallel import dryrun

    assert dryrun.main(["--ranks", "4", "--backend", "gloo",
                        "--device", "cpu"]) == 0


@pytest.mark.parametrize("argv", [
    ["--ranks", "2", "--backend", "nccl", "--device", "cpu"],
    ["--ranks", "1", "--backend", "nccl", "--device", "cpu"],
])
def test_dryrun_refuses_nccl_without_a_card_a_rank(argv, capsys):
    """NCCL takes one card a rank: more ranks than cards (or the CPU)
    exit 2 with the reason, before any rank starts."""
    from babble_tpu_torch.parallel import dryrun

    assert dryrun.main(argv) == 2
    assert "one card a rank" in capsys.readouterr().err


def test_bootstrap_reads_torchrun_then_jax_variables(monkeypatch):
    """bootstrap's defaults: torchrun's variables first, then the JAX
    package's; nothing given and nothing set raises; the backend is
    NCCL unless asked."""
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        bootstrap()
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    bootstrap()
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.2")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "3")
    bootstrap(backend="gloo")
    assert calls == [
        ("nccl", dict(init_method="tcp://10.0.0.1:1234", world_size=4,
                      rank=0)),
        ("gloo", dict(init_method="tcp://10.0.0.2:29500", world_size=8,
                      rank=3)),
    ]
