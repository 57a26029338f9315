"""The multi-rank dry run: the port's ``dryrun_multichip``.

    python -m babble_tpu_torch.parallel.dryrun --ranks R \\
        --backend nccl|gloo --device cuda|cpu

spawns R rank processes (the ``spawn`` start method) joined through a
``TCPStore`` on a free port, builds the ("ev", "p") mesh over them and
runs the five certifications of the JAX package's dry run
(``__graft_entry__.py dryrun_multichip``) at its shapes, each held bit
for bit to the single-device port on the same rank:

1. the sharded step, fd mode "full", 8 creators x 96 events;
2. the column-blocked wide pipeline (4 blocks) against the fused step;
3. the sharded fork pipeline, 8 creators x 160 events;
4. the rolling-window stream against the fused whole-DAG step;
5. the same stream with its blocks sharded over the mesh's "p" axis.

With ``--device cuda`` each rank takes card ``rank % device_count``:
gloo ranks may share a card, NCCL needs a card a rank, so ``main``
refuses NCCL with more ranks than cards, or on the CPU.  Exit 0 when every
rank certified all five.  ``spawn_ranks`` is the launcher, for any
picklable ``fn(mesh_args...)``.
"""

from __future__ import annotations

import argparse
import sys
import time


def _rank_main(rank: int, fn, world: int, port: int, backend: str,
               device: str, args: tuple) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.TCPStore("127.0.0.1", port, world, False)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    try:
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device(device)
        fn(rank, world, dev, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, ranks: int, backend: str, device: str,
                *args) -> None:
    """Run ``fn(rank, world, device, *args)`` in ``ranks`` spawned
    processes, each in the process group (``backend``) before ``fn``
    starts; raises if any rank fails."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    store = dist.TCPStore("127.0.0.1", 0, None, True,
                          wait_for_workers=False)
    mp.start_processes(_rank_main, nprocs=ranks, start_method="spawn",
                       join=True,
                       args=(fn, ranks, store.port, backend, device, args))


def _tiny_workload(n: int, n_events: int, e_cap: int, s_cap: int,
                   r_cap: int, device):
    """(cfg, batch) of a deterministic random-gossip DAG, built through
    the engine's batching as the JAX dry run builds it."""
    from ..consensus.engine import TorchHashgraph
    from ..sim.generator import random_gossip_dag

    dag = random_gossip_dag(n, n_events, seed=42)
    eng = TorchHashgraph(dag.participants, verify_signatures=False,
                         e_cap=e_cap, s_cap=s_cap, r_cap=r_cap,
                         device=device)
    for ev in dag.events:
        eng.insert_event(ev)
    batch, _ = eng.build_batch()
    return eng.cfg, batch


def certify(rank: int, world: int, device) -> None:
    """The five certifications (module docstring) on this rank."""
    import numpy as np

    from ..ops.forks import fork_pipeline
    from ..ops.state import DagConfig, assert_consensus_parity, init_state
    from ..ops.stream import stream_consensus
    from ..ops.wide import run_wide_pipeline
    from ..sim.arrays import (
        batch_from_arrays, random_byzantine_fork_batch, random_gossip_arrays,
    )
    from ..step import consensus_step
    from .mesh import make_mesh
    from .sharded import (
        gather_fork_out, gather_state, make_sharded_fork_step,
        make_sharded_step, pad_cfg_for_mesh, pad_fork_for_mesh,
        sharded_init_state,
    )

    mesh = make_mesh(world, device=device)
    say = print if rank == 0 else (lambda *a, **k: None)
    t0 = time.perf_counter()

    cfg, batch = _tiny_workload(8, 96, 127, 32, 16, device)
    cfg = pad_cfg_for_mesh(cfg, mesh)
    step = make_sharded_step(cfg, mesh, "full")
    out = gather_state(step(sharded_init_state(cfg, mesh), batch), mesh)
    assert int(out.n_events) == 96, int(out.n_events)
    assert int(out.max_round) >= 1, int(out.max_round)
    ref = consensus_step(cfg, "full", init_state(cfg, device=device), batch)
    assert_consensus_parity(ref, out, int(ref.n_events), label="multichip")
    say(f"[dryrun] 1 sharded step (mesh {mesh.shape}, full): == one "
        f"device; compare-count columns {step.shard.widths()}", flush=True)

    cfg_w, batch_w = _tiny_workload(12, 96, 127, 32, 16, device)
    ref_w = consensus_step(cfg_w, "fast", init_state(cfg_w, device=device),
                           batch_w)
    wide = run_wide_pipeline(cfg_w, batch_w, n_blocks=4)
    assert_consensus_parity(ref_w, wide, int(ref_w.n_events),
                            label="wide-blocked")
    say("[dryrun] 2 wide pipeline, 4 blocks: == fused step", flush=True)

    fcfg, fbatch = random_byzantine_fork_batch(8, 160, seed=5, fork_rate=0.1,
                                               r_cap=16, device=device)
    fcfg, fbatch = pad_fork_for_mesh(fcfg, fbatch, mesh)
    fstep = make_sharded_fork_step(fcfg, mesh)
    fsharded = gather_fork_out(fstep(fbatch), mesh)
    fref = fork_pipeline(fcfg, fbatch)
    for name in ("la", "det", "fd", "round", "witness", "wslot",
                 "famous", "rr", "cts"):
        a, b = getattr(fref, name), getattr(fsharded, name)
        assert bool((a == b).all()), f"fork multichip parity: {name}"
    assert int(fref.lcr) == int(fsharded.lcr)
    assert int(fref.det.sum()) > 0
    say(f"[dryrun] 3 sharded fork step: == one device; compare-count "
        f"columns {fstep.shard.widths()}", flush=True)

    adag = random_gossip_arrays(16, 900, seed=9)
    scfg = DagConfig(n=16, e_cap=900, s_cap=adag.max_chain + 3, r_cap=64)
    sref = consensus_step(scfg, "fast", init_state(scfg, device=device),
                          batch_from_arrays(adag, device=device))
    rr_ref = sref.rr[:900].cpu().numpy()
    cts_ref = sref.cts[:900].cpu().numpy()
    ordered_ref = {int(s): (int(rr_ref[s]), int(cts_ref[s]))
                   for s in np.nonzero(rr_ref >= 0)[0]}
    wcfg = DagConfig(n=16, e_cap=560, s_cap=96, r_cap=16)
    stream = stream_consensus(wcfg, adag, batch_events=150, n_blocks=2,
                              seq_window=12, compact_min=32, device=device)
    assert stream.evicted > 0, "stream dry-run never compacted"
    assert stream.ordered == ordered_ref, "stream multichip parity: rr/cts"
    assert stream.lcr == int(sref.lcr)
    say("[dryrun] 4 stream: == fused whole-DAG step", flush=True)

    p = mesh.shape["p"]
    stream_sh = stream_consensus(wcfg, adag, batch_events=150,
                                 n_blocks=2 * p, seq_window=12,
                                 compact_min=32, mesh=mesh)
    assert stream_sh.evicted > 0, "sharded stream dry-run never compacted"
    assert stream_sh.ordered == ordered_ref, \
        "sharded stream multichip parity: rr/cts"
    assert stream_sh.lcr == int(sref.lcr)
    say(f"[dryrun] 5 sharded stream ({2 * p} blocks, "
        f"{stream_sh.la_blocks.shape[0]} a rank): == fused whole-DAG step; "
        f"{time.perf_counter() - t0:.1f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m babble_tpu_torch.parallel.dryrun",
        description="Certify the sharded programs over R rank processes.")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("dryrun: no CUDA device (pass --device cpu --backend "
                  "gloo for a CPU rehearsal)", file=sys.stderr)
            return 2
        cards = torch.cuda.device_count()
    else:
        cards = 0
    if args.backend == "nccl" and args.ranks > cards:
        print(f"dryrun: nccl takes one card a rank: {args.ranks} ranks on "
              f"{cards} {args.device} card(s) (pass --backend gloo to "
              "share cards, or for the CPU)", file=sys.stderr)
        return 2
    spawn_ranks(certify, args.ranks, args.backend, args.device)
    print(f"[dryrun] {args.ranks} ranks, {args.backend} on {args.device}: "
          "all five certified", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
