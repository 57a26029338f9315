"""The port's side of ``tests/test_torch_parallel.py``: one group of rank
processes that runs every sharded case and writes one ``.npz`` a case
(and, with ``--case stream``, the 2-rank stream of
``tests/test_torch_stream.py``).

    python -m tests.torch_parallel_ranks OUT_DIR [--case all|stream]

starts the ranks as separate interpreters with torchrun's variables
(``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``), so each
joins the gloo group through ``parallel.multihost.bootstrap``.  Nothing
here imports jax: the test process holds these results to the JAX
package.  Per case rank 0 writes the gathered outputs, and every rank's
compare-count widths travel with them (``widths`` in the npz, one JSON
text a rank).  Each rank runs one torch thread.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

RANKS = 8

#: the honest-step cases of tests/test_parallel.py, on mesh (4, 2)
STEP_CASES = [(6, "full"), (8, "full"), (6, "fast"), (6, "incremental")]


def _save(out_dir, name, rank, mesh, arrays, widths):
    """Rank 0 writes ``arrays`` and every rank's ``widths``."""
    import torch.distributed as dist

    every = [None] * mesh.size
    dist.all_gather_object(every, json.dumps(widths, sort_keys=True))
    if rank == 0:
        arrays = {k: (v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v))
                  for k, v in arrays.items()}
        np.savez(os.path.join(out_dir, f"{name}.npz"),
                 widths=np.asarray(every), **arrays)


def _state_arrays(state, prefix=""):
    return {prefix + f: t for f, t in zip(state._fields, state)
            if t is not None}


def _engine_batch(n_part, device):
    """The events of test_parallel's single-chip case as one batch."""
    from babble_tpu_torch.consensus.engine import TorchHashgraph
    from babble_tpu_torch.sim.generator import random_gossip_dag

    dag = random_gossip_dag(n_part, 180, seed=5)
    eng = TorchHashgraph(dag.participants, verify_signatures=False,
                         e_cap=255, s_cap=64, r_cap=32, device=device)
    for ev in dag.events:
        eng.insert_event(ev)
    batch, _ = eng.build_batch()
    return eng.cfg, batch


def run_cases(rank: int, out_dir: str) -> None:
    import torch

    from babble_tpu_torch.ops.state import DagConfig
    from babble_tpu_torch.parallel import collectives
    from babble_tpu_torch.parallel.mesh import make_mesh
    from babble_tpu_torch.parallel.multihost import (
        broadcast_batch, global_mesh, make_multihost_step,
    )
    from babble_tpu_torch.parallel.sharded import (
        gather_fork_out, gather_state, make_sharded_fork_step,
        make_sharded_step, pad_cfg_for_mesh, pad_fork_for_mesh,
        sharded_init_state,
    )
    from babble_tpu_torch.sim.arrays import (
        batch_from_arrays, random_byzantine_fork_batch, random_gossip_arrays,
    )
    from babble_tpu_torch.ops.stream import stream_consensus

    cpu = torch.device("cpu")
    mesh = make_mesh(RANKS, device="cpu")
    t0 = time.perf_counter()

    # the mesh and its collectives
    shapes = {"default": list(make_mesh(RANKS, device="cpu").shape.values()),
              "2x4": list(make_mesh(RANKS, shape=(2, 4),
                                    device="cpu").shape.values())}
    refused = []
    for bad in (dict(n_devices=4), dict(shape=(3, 3)), dict(n_devices=16)):
        try:
            make_mesh(device="cpu", **bad)
        except ValueError as exc:
            refused.append(str(exc))
    p, ev = mesh.axes["p"], mesh.axes["ev"]
    mine = torch.full((2, 3), rank, dtype=torch.int64)
    flag = torch.tensor([rank == 5, False])
    collectives.reset_stats()
    coll = dict(
        gather_p=p.gather(mine, 1), gather_ev=ev.gather(mine, 0),
        sum_world=mesh.world.sum(mine), max_p=p.max(mine),
        any_world=mesh.world.max(flag),
        bcast=mesh.world.broadcast(torch.arange(4) + 10 * rank),
        big=p.gather(torch.full((1,), 2 ** 62 + rank, dtype=torch.int64), 0),
    )
    coll_stats = json.dumps(collectives.stats())
    src = batch_from_arrays(random_gossip_arrays(5, 60, seed=rank),
                            device=cpu)
    got = broadcast_batch(src if rank == 0 else None, mesh)
    _save(out_dir, "mesh", rank, mesh, dict(
        shapes=np.asarray(json.dumps(shapes)),
        refused=np.asarray(refused), coll_stats=np.asarray(coll_stats),
        grid=mesh.grid, **coll,
        **{f"batch_{f}": t for f, t in zip(got._fields, got)},
    ), {})

    # the honest step in modes full, fast and incremental, with padding
    # (n = 6)
    for n_part, mode in STEP_CASES:
        cfg, batch = _engine_batch(n_part, cpu)
        cfg = pad_cfg_for_mesh(DagConfig(n=n_part, e_cap=cfg.e_cap,
                                         s_cap=cfg.s_cap, r_cap=cfg.r_cap),
                               mesh)
        step = make_sharded_step(cfg, mesh, mode)
        out = gather_state(step(sharded_init_state(cfg, mesh), batch), mesh)
        _save(out_dir, f"step_{n_part}_{mode}", rank, mesh,
              _state_arrays(out), step.shard.widths())

    # mode "walk" at p = 2: la_walk on the rank's column range
    dag = random_gossip_arrays(8, 400, seed=3)
    cfg = pad_cfg_for_mesh(DagConfig(n=8, e_cap=400,
                                     s_cap=max(64, dag.max_chain + 1),
                                     r_cap=32), mesh)
    step = make_sharded_step(cfg, mesh, "walk")
    out = gather_state(step(sharded_init_state(cfg, mesh),
                            batch_from_arrays(dag, device=cpu)), mesh)
    _save(out_dir, "walk", rank, mesh, _state_arrays(out),
          step.shard.widths())

    # the block form of fame (forced): the same DAG in mode "fast"
    from babble_tpu_torch.ops import fame

    fame.BLOCK_FAME_THRESHOLD = 0
    step = make_sharded_step(cfg, mesh, "fast")
    out = gather_state(step(sharded_init_state(cfg, mesh),
                            batch_from_arrays(dag, device=cpu)), mesh)
    fame.BLOCK_FAME_THRESHOLD = 1 << 28
    _save(out_dir, "block_fame", rank, mesh, _state_arrays(out),
          step.shard.widths())

    # the hybrid multi-host mesh: 2 pretend hosts x 4 ranks
    dag = random_gossip_arrays(8, 768, seed=21)
    cfg = DagConfig(n=8, e_cap=768, s_cap=max(64, dag.max_chain + 1),
                    r_cap=32)
    hmesh = global_mesh(dcn_axis=2, device="cpu")
    _, pcfg, state, step = make_multihost_step(cfg, hmesh)
    out = gather_state(step(state, batch_from_arrays(dag, device=cpu)),
                       hmesh)
    _save(out_dir, "hybrid", rank, hmesh, dict(
        grid=hmesh.grid, e_cap=np.asarray(pcfg.e_cap),
        **_state_arrays(out)), step.shard.widths())

    # the fork pipeline at 12 creators (branch columns over "p")
    fcfg, fbatch = random_byzantine_fork_batch(12, 600, seed=13,
                                               fork_rate=0.08, r_cap=16,
                                               device=cpu)
    fcfg, fbatch = pad_fork_for_mesh(fcfg, fbatch, mesh)
    fstep = make_sharded_fork_step(fcfg, mesh)
    fout = gather_fork_out(fstep(fbatch), mesh)
    _save(out_dir, "fork", rank, mesh, _state_arrays(fout),
          fstep.shard.widths())

    # the sharded stream of tests/test_stream.py at p = 4
    smesh = make_mesh(RANKS, shape=(2, 4), device="cpu")
    sdag = random_gossip_arrays(24, 2800, seed=13)
    stream = stream_consensus(DagConfig(n=24, e_cap=1400, s_cap=110,
                                        r_cap=16),
                              sdag, batch_events=350, n_blocks=8,
                              round_margin=0, seq_window=16,
                              compact_min=64, mesh=smesh)
    keys = sorted(stream.ordered)
    _save(out_dir, "stream", rank, smesh, dict(
        ordered=np.asarray([(k,) + stream.ordered[k] for k in keys]),
        lcr=np.asarray(stream.lcr), evicted=np.asarray(stream.evicted),
        blocks=np.asarray(stream.la_blocks.shape),
        **_state_arrays(stream.state, "state_"),
    ), stream.shard.widths())

    # 256 x 20k, mode "fast"
    dag = random_gossip_arrays(256, 20_000, seed=31)
    cfg = pad_cfg_for_mesh(DagConfig(n=256, e_cap=20_000,
                                     s_cap=dag.max_chain + 2, r_cap=16),
                           mesh)
    step = make_sharded_step(cfg, mesh, "fast")
    out = gather_state(step(sharded_init_state(cfg, mesh),
                            batch_from_arrays(dag, device=cpu)), mesh)
    keep = ("round", "witness", "rr", "cts", "wslot", "famous", "lcr",
            "n_events", "la", "fd")
    _save(out_dir, "large", rank, mesh,
          {f: getattr(out, f) for f in keep}, step.shard.widths())
    if rank == 0:
        print(f"ranks: {time.perf_counter() - t0:.1f} s", flush=True)


def run_stream_case(rank: int, out_dir: str) -> None:
    """test_torch_stream.py's stacked stream (24 x 2800, 4 blocks) with
    ``mesh=`` over a (1, 2) mesh: 2 blocks a rank.  Rank 0 writes what
    that test compares, the blocks gathered over "p"."""
    from babble_tpu_torch.ops.state import DagConfig
    from babble_tpu_torch.ops.stream import stream_consensus
    from babble_tpu_torch.parallel.mesh import make_mesh
    from babble_tpu_torch.sim.arrays import random_gossip_arrays

    mesh = make_mesh(2, shape=(1, 2), device="cpu")
    st = stream_consensus(DagConfig(n=24, e_cap=1400, s_cap=110, r_cap=16),
                          random_gossip_arrays(24, 2800, seed=13),
                          batch_events=350, n_blocks=4, round_margin=0,
                          seq_window=16, compact_min=64, mesh=mesh)
    p = mesh.axes["p"]
    keys = sorted(st.ordered)
    _save(out_dir, "stream2", rank, mesh, dict(
        ordered=np.asarray([(k,) + st.ordered[k] for k in keys]),
        scalars=np.asarray([st.ordered_total, st.lcr, st.evicted, st.e_off]),
        stats=np.asarray(json.dumps(st.stats, sort_keys=True)),
        timings=np.asarray(sorted(st.timings)),
        local_blocks=np.asarray(st.la_blocks.shape),
        la_blocks=p.gather(st.la_blocks, 0), fd_blocks=p.gather(st.fd_blocks, 0),
        pos_table=st.carry.pos_table, cnt_prev=st.carry.cnt_prev,
        rr_seen=st._rr_seen, **_state_arrays(st.state, "state_"),
    ), st.shard.widths())


CASES = {"all": (RANKS, run_cases), "stream": (2, run_stream_case)}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank(out_dir: str, rank: int, case: str) -> None:
    import torch

    torch.set_num_threads(1)
    from babble_tpu_torch.parallel.multihost import bootstrap

    bootstrap(backend="gloo")
    import torch.distributed as dist

    try:
        CASES[case][1](rank, out_dir)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(out_dir: str, case: str = "all", timeout: float = 600) -> str:
    """Run the case's ranks as separate interpreters; returns rank 0's
    output.  Raises with every failing rank's error output."""
    ranks = CASES[case][0]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(ranks),
               PYTHONPATH=repo, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_parallel_ranks", out_dir,
         "--case", case, "--rank", str(r)], cwd=repo,
        env=dict(env, RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(ranks)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [f"rank {r} (exit {p.returncode}):\n{err[-3000:]}"
           for r, (p, (_, err)) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    if bad:
        raise RuntimeError("\n".join(bad))
    return outs[0][0]


if __name__ == "__main__":
    args = sys.argv[1:]
    case = args[args.index("--case") + 1] if "--case" in args else "all"
    if "--rank" in args:
        _rank(args[0], int(args[args.index("--rank") + 1]), case)
    else:
        print(launch(args[0], case))
