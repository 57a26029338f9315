#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``babble_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase swallows an exception):

1. device — print the card's name and power limit (nvidia-smi); no CUDA
   device is a failure.
2. build  — compile every kernel of the main path from ``csrc/`` (one
   nvcc per source, all started together) and print ``-Xptxas -v``,
   then each kernel's registers and shared memory as the runtime sees
   them (la_walk: static staging plus the dynamic int16 column).
3. kernel — each kernel's wrapper on the card against its plain torch
   version on the same card inputs, at the main path's shapes (the
   64 x 65,536 slice DAG), on one small DAG, at the largest size the
   walk gate admits (64 x 94,661) and on seqs that wrap int16; exact
   equality (the outputs are integers).  Kernel time by CUDA events:
   ``ms`` warm (mean of 10 back-to-back launches, the first one's host
   enqueue inside the span, as in earlier versions of this script),
   ``ms_device`` the same with the host enqueued ahead behind a device
   sleep (device time alone), ``ms_cold`` with L2 cold (a 256 MB scratch
   write before each launch); and the kernel's own clock per block:
   walk, epilogue and the walking warp's rounds.
4. slice  — the batch consensus step ``consensus_step(cfg, "walk", ...)``
   at n=64, e_cap=65,536, s_cap=max_chain+1, r_cap=512 on the gossip DAG
   of seed 7 (the bench's 64-node config).  The launch counters are set
   to 0 just before the run and read just after; every kernel must have
   launched.  The same step in mode "fast" (la by the plain level scan)
   must agree bit for bit on every consensus field, and the run must
   reproduce the JAX package's counts for this DAG: max_round 93, lcr
   91, 63,340 events ordered.
5. live   — the live path (``sim/live.py live_stream``: incremental
   ingest, windowed fame and order per flush) on the same DAG and
   config with ``packed=True``, as a gossip stream flushed 256 events at
   a time (256 flushes) and then drained, ungated and gated (as a live
   node runs it).  Each drained state must equal the JAX package's
   stream bit for bit (its counts and ``consensus_digest``, from a CPU
   run) and the walk step on la, fd, round, witness and wslot.  Gated,
   drained, it must equal the walk step on every consensus field.
   Ungated, lcr can jump a round whose fame is still open, which
   is then never decided, so rr and cts may differ from the batch
   step's (as they do in the JAX stream); the phase prints how many.
   In mid-stream
   one flush runs with the dispatch's frontier bucket F and with the
   full height F = e_cap + 1, which must agree, and 8 flushes run as
   ``probed_flush`` (ingest / fame / order each synchronised), which
   must equal the same flushes unprobed.  It prints each stream's flush
   count, the W and F values used, per-flush wall ms (p50, p99, max) and
   events per second, and the probed phase split.

6. engine — the consensus engine (``TorchHashgraph``) on the same DAG,
   turned into events (``events_from_arrays``, unsigned, as the JAX
   simulations run).  (a) Catch-up: a fresh engine takes all 65,536
   events and one ``run_consensus`` (the throughput surface: fd mode
   "full", fame, order); its round, witness, wslot, famous and lcr must
   equal the walk step's.  (b) Live node: the engine a ``Node`` builds
   (``node_engine_kwargs()``: e_cap 500, rolling windows, gated), fed
   256 events per ``run_consensus`` and drained.  Both must reproduce
   the JAX engine's flows (``ENGINE_EXPECT``: commit length, commit
   digest, calls per surface, lcr, evicted slots, final capacities,
   fallbacks).  It prints per-call wall ms, events committed per
   second, the growth steps, the evictions and the share of host code
   (inserts, ``build_batch``, ``_collect_ordered``).  (c) Block fame on
   phase 4's ingested state, gated and ungated, against the diagonal
   form.  The engine path launches no kernel of the port (it ingests
   with fd modes "incremental" and "full", never "walk"), which the
   phase checks on la_walk's count.

7. churn — the membership plane and the checkpoint: 64 founders with
   real P-256 identities (``random_churn_dag(64, 65536, seed=7,
   CHURN_SCHEDULE)``) through the engine a ``Node`` builds, 256 events a
   call, then drained.  Two joins (the second queued behind the first),
   a garbage and a forged membership transaction (both rejected), both
   joiners minting from their slots, then a leave of founder 5, who
   stops minting later.  Two restarts inside the flow: files
   (``save_checkpoint`` + ``load_checkpoint``) at the first call after
   which one transition is pending and another queued, and bytes
   (``snapshot_bytes`` + ``load_snapshot``) at slot 49,152, after the
   third transition; each restored engine must equal the saving one on
   every DagState field and the host mirrors, and the flow continues in
   it.  The flow is held to the JAX engine's (``CHURN_EXPECT``: commit
   length and digest, epoch, membership log, rejects, final config,
   calls per surface, fallbacks, evictions; made on the CPU by
   ``JAX_PLATFORMS=cpu python -m tests.test_torch_churn``).  The golden
   v3/v4/v5 checkpoints in ``tests/golden/checkpoints`` restore on the
   card and extend, held to ``GOLDEN_EXPECT``.  It prints per-call wall
   ms and events committed per second, each epoch transition's wall ms
   (host numpy, upload, rescan; suspects), each restart's save and load
   ms and bytes, and ``Event.verify`` per event over 256 signed events.
   The phase launches la_walk 0 times.

8. node  — the node runtime (``node/``, ``net/``, ``wal/``, ``obs/``).
   (a) Core replay: four ``Core``s on the card with seeded P-256
   identities and one logical clock as ``Core.now_ns``, through
   ``sim/replay.py``'s seeded schedule of 4,000 syncs (each carrying 1–16
   transactions of 64 bytes; every sync crosses as ``SyncRequest`` and
   ``SyncResponse`` bytes) with ``run_consensus`` after every sync, at
   the node's default cache size.  Every Core's committed length,
   commit digest, committed transactions and head seq must equal the
   JAX Cores' (``NODE_EXPECT``, made on the CPU by ``JAX_PLATFORMS=cpu
   python -m tests.test_torch_core``).  (b) The reference's Docker
   testnet (heartbeat 10 ms, cache_size 50,000, tcp_timeout 200 ms, every
   other ``Config`` field at its default): four ``Node``s on the
   in-memory network, each with its own WAL directory, take bombard
   traffic (5,000 transactions of 64 bytes per node, in bursts of 100
   every 50 ms).  Node 3 is shut down after half its bursts, restarts
   from its WAL with a new proxy and rejoins.  Every proxy must hold all
   20,000 transactions, each once, in one order (the restarted node's
   new proxy from the first), ``consensus_events()`` must agree, no
   Core may count an insert failure, and nothing may be logged that a
   node carries on from but the pulls and pushes that timed out or
   found their peer gone, counted by class, and the notices of a WAL
   restart (a ``run_consensus`` that raised inside a pull, or a failed
   consensus run or served RPC, fails the phase).  Four engines flush from the default
   executor's threads onto one card, so the phase times by wall clock
   and the nodes' registries.  It prints transactions committed per
   second, submit-to-commit p50/p99 at the submitting node, events
   minted, each node's ``run_consensus`` calls with their registry
   p50/p99 and surfaces, the restart's replay time and the host time
   spent signing and verifying.  The phase launches la_walk 0 times.

It prints the card line, then one JSON line describing every kernel,
then ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import hashlib
import json
import logging
import subprocess
import sys
import time

# the JAX package's counts for random_gossip_arrays(64, 65536, seed=7)
# under consensus_step_impl(cfg, "walk"), from a CPU run
SLICE = dict(n=64, e=65536, seed=7, r_cap=512)
EXPECT = dict(max_round=93, lcr=91, ordered=63340)
SMALL = dict(n=8, e=1024, seed=13)
# synthetic walk inputs (sim.arrays.random_walk_arrays): the walk gate's
# largest e_cap at n=64, and seqs across 32,767 and 65,536
GATE = dict(n=64, e=94661, seed=7, seq_base=0)
WRAP = dict(n=8, e=4096, seed=3,
            seq_base=[32700, 65500, 0, 40000, 70000, 131000, 5, 65536])
SCRATCH_BYTES = 256 << 20    # > 5x the 50 MB L2
# the live stream: flush size (the JAX engine's LATENCY_K_MAX), the slot
# of the mid-stream checks, and how many flushes the phase probe times
LIVE_CHUNK = 256
LIVE_MID = 32768
LIVE_PROBED = 8
# the JAX package's drained live streams of the slice DAG (packed, flushes
# of LIVE_CHUNK, W and F as its engine picks them): counts and
# ops.state.consensus_digest, from a CPU run of
# ``JAX_PLATFORMS=cpu python -m tests.test_torch_live`` (chip_reference)
LIVE_EXPECT = {
    "ungated": dict(max_round=93, lcr=91, ordered=63340, digest=(
        "47deae5b37a8ef15bae8b1a3f4d3c99e76c3b2098965e555a65096cbeeaef645")),
    "gated": dict(max_round=93, lcr=91, ordered=63340, digest=(
        "a3b853b0cabea581d84e91839a6e8e72bea6170526e521f39b32888fe753195c")),
}

# the JAX engine's two flows over the slice DAG (the catch-up: one
# run_consensus over every event; the live node: node_engine_kwargs(),
# LIVE_CHUNK events per call, then drained), from a CPU run of
# ``JAX_PLATFORMS=cpu python -m tests.test_torch_engine`` (chip_reference)
ENGINE_EXPECT = {
    "catchup": dict(
        commit_length=63340, commit_digest=(
            "ba5d3c5b1c444f47ee429937051809165fd8c1a21234da0c3b947fd78335217b"),
        calls=1, latency=0, throughput=1, lcr=91, evicted=0, e_cap=65536,
        r_cap=1024, flush_fallbacks=0),
    "live": dict(
        commit_length=63340, commit_digest=(
            "ba5d3c5b1c444f47ee429937051809165fd8c1a21234da0c3b947fd78335217b"),
        calls=257, latency=213, throughput=44, lcr=91, evicted=30001,
        e_cap=64000, r_cap=64, flush_fallbacks=5),
}
# most empty calls the live node's drain makes
DRAIN_MAX = 64

# phase 7: the churn flow (tests/test_torch_churn.py CHURN and
# CHURN_SCHEDULE: (slot, action, member, epoch); members 64 and 65 are
# the joiners, 66 the subject of the forged join)
CHURN = dict(n=64, e=65536, seed=7, chunk=256, snap_slot=49152)
CHURN_SCHEDULE = [
    (8192, "join", 64, 0), (8448, "join", 65, 0),
    (12288, "garbage", 0, 0), (12544, "forged", 66, 0),
    (20480, "start", 64, 1), (24576, "start", 65, 2),
    (32768, "leave", 5, 2), (40960, "stop", 5, 0),
]
# the JAX engine over that flow with the same two restarts (counters
# that a restart does not carry are summed over the engines), and the
# golden checkpoints restored and extended with random_gossip_dag(3, 72,
# seed=11)[48:], from a CPU run of ``JAX_PLATFORMS=cpu python -m
# tests.test_torch_churn`` (chip_reference)
CHURN_EXPECT = dict(
    commit_length=62693, commit_digest=(
        "4f0164e113bcc281761931e0bd2e5b9d8f9d8007ad2d46b2200efc31ab3f57b5"),
    epoch=3, membership_log=[
        [1, "join", 64, 14, 8103, "779c49a2"],
        [2, "join", 65, 15, 8402, "276c4605"],
        [3, "leave", 5, 49, 32746, "84dce3c8"],
    ],
    membership_rejects=2, n=66, retired=[5], e_cap=64000,
    r_cap=64, calls=257, latency=215, throughput=42,
    flush_fallbacks=19, evicted=8871,
    restarts={"files": 10496, "bytes": 49152},
)
GOLDEN_EXPECT = {
    "v3": dict(commit_length=26, commit_digest=(
        "d45bcb52ebb4cc0bf1f3391f168884b95d0c39615cc3e37108cdfd18227b2098")),
    "v4": dict(commit_length=40, commit_digest=(
        "0768605e12ce3b635cfd4626aecceb89e14a9028915393da407e1329b8954914")),
    "v5": dict(commit_length=40, commit_digest=(
        "0768605e12ce3b635cfd4626aecceb89e14a9028915393da407e1329b8954914")),
}
GOLDEN_DAG = dict(n=3, e=72, seed=11, prefix=48)
# really signed events Event.verify is timed over
VERIFY_EVENTS = 256

# phase 8(a): the Core replay (tests/test_torch_core.py NODE): four
# Cores, sim/replay.py's seeded schedule of syncs, run_consensus after
# every sync, the node's default cache size
NODE_REPLAY = dict(n=4, syncs=4000, seed=7, cache_size=500)
# four JAX Cores through that replay, from a CPU run of
# ``JAX_PLATFORMS=cpu python -m tests.test_torch_core`` (chip_reference)
NODE_EXPECT = {
    "commit_length": [3964, 3964, 3964, 3978],
    "commit_digest": [
        "7f0c8463a8337bac0a49236f690910d691badddf84bdad20595f9bb011052cfd",
        "7f0c8463a8337bac0a49236f690910d691badddf84bdad20595f9bb011052cfd",
        "7f0c8463a8337bac0a49236f690910d691badddf84bdad20595f9bb011052cfd",
        "747699d1e9bdd4aad75557a3d0a4a51141e15fd484531d6dda33fff5a312a3c9",
    ],
    "consensus_txs": [33956, 33956, 33956, 34073],
    "seq": [992, 1018, 986, 1004],
}
# phase 8(b): the reference's Docker testnet (mpitid/babble
# docker/scripts/run-testnet.sh: heartbeat 10 ms, cache_size 50,000,
# tcp_timeout 200 ms; every other Config field at its default) on the
# in-memory network, and bombard.sh's traffic: 5,000 transactions of
# 64 bytes per node in bursts of 100 every 50 ms; node 3 shut down
# after half the bursts and restarted from its WAL
TESTNET = dict(nodes=4, heartbeat=0.01, cache_size=50000, tcp_timeout=0.2,
               txs_per_node=5000, burst=100, burst_every=0.05,
               tx_bytes=64, crash_node=3, down_s=0.5, drain_s=300.0,
               seed=11)

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor f32 ops/s
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, ahead: bool = False) -> float:
    """Mean time of ``fn()`` over ``reps`` launches (CUDA events, after
    one warm-up).  The first launch's host enqueue falls inside the
    span; with ``ahead`` a device sleep first lets the host enqueue all
    of them before the card starts, so the span is device time alone."""
    import torch

    fn()
    if ahead:
        torch.cuda._sleep(1_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int) -> float:
    """Mean time of ``fn()`` with L2 cold: a ``SCRATCH_BYTES`` write just
    before each launch, CUDA events around the launch alone (its host
    enqueue may fall inside the span, as in ``cuda_ms``)."""
    import torch

    scratch = torch.empty(SCRATCH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    marks = []
    for i in range(reps):
        scratch.fill_(i & 0xFF)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks) / reps


def wall_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def walk_inputs(n: int, e: int, seed: int, dev):
    """The slice DAG written into a fresh state, as the walk reads it."""
    from babble_tpu_torch import (
        DagConfig, batch_from_arrays, init_state, random_gossip_arrays,
    )
    from babble_tpu_torch.ops.ingest import _write_batch_fields

    dag = random_gossip_arrays(n, e, seed=seed)
    cfg = DagConfig(n=n, e_cap=e, s_cap=max(64, dag.max_chain + 1), r_cap=64)
    st = _write_batch_fields(init_state(cfg, device=dev), cfg,
                             batch_from_arrays(dag, device=dev))
    return (st.sp, st.op, st.creator, st.seq, st.n_events, cfg.e_cap, cfg.n)


def synthetic_inputs(shape: dict, dev):
    """Synthetic walk inputs (any n, seqs from ``seq_base``) on the card."""
    import torch

    from babble_tpu_torch.sim.arrays import random_walk_arrays

    a = random_walk_arrays(shape["n"], shape["e"], seed=shape["seed"],
                           seq_base=shape["seq_base"])
    t = [torch.from_numpy(a[k]).to(dev)
         for k in ("sp", "op", "creator", "seq")]
    ne = torch.tensor(shape["e"], dtype=torch.int32, device=dev)
    return (*t, ne, shape["e"], shape["n"])


def kernel_phases(args) -> str:
    """One profiled launch: per-block walk and epilogue time by the
    kernel's own clock (globaltimer), and the walking warp's rounds."""
    from babble_tpu_torch.ops.pallas_ingest import la_walk_phases

    _, prof = la_walk_phases(*args)
    start, walk_end, end, rounds = (prof[:, i].double() for i in range(4))
    span = (end.max() - start.min()) / 1e6
    walk = ((walk_end - start) / 1e6).mean()
    epi = ((end - walk_end) / 1e6).mean()
    return (f"span {span:.4f} ms (first block start to last block end), "
            f"walk {walk:.4f} ms, epilogue {epi:.4f} ms (means over "
            f"blocks; epilogue share {epi / span:.3f}), block start skew "
            f"{(start.max() - start.min()) / 1e6:.4f} ms, rounds "
            f"{int(rounds.min())}..{int(rounds.max())} "
            f"(mean {rounds.mean():.1f})")


def phase_kernel(dev) -> dict:
    """la_walk against la_walk_plain on the card; returns its JSON row
    (launches filled in by the slice phase)."""
    import torch

    from babble_tpu_torch.ops.pallas_ingest import la_walk, la_walk_plain

    row = None
    for name, shape in (("small", SMALL), ("slice", SLICE),
                        ("gate", GATE), ("wrap", WRAP)):
        if "seq_base" in shape:
            args = synthetic_inputs(shape, dev)
        else:
            args = walk_inputs(shape["n"], shape["e"], shape["seed"], dev)
        e_cap, n = args[5], args[6]
        got = la_walk(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = la_walk_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = int((got.long() - want.long()).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(
                f"la_walk != la_walk_plain ({name}, n={n} e={e_cap}): "
                f"{int((got != want).sum())} entries differ"
            )
        ms = cuda_ms(lambda: la_walk(*args), reps=10)
        ms_device = cuda_ms(lambda: la_walk(*args), reps=10, ahead=True)
        ms_cold = cuda_ms_cold(lambda: la_walk(*args), reps=10)
        print(f"[kernel] la_walk {name} n={n} e_cap={e_cap}: exact; "
              f"{ms:.4f} ms warm, {ms_device:.4f} ms warm device only "
              f"(host enqueued ahead), {ms_cold:.4f} ms L2 cold (CUDA "
              f"events, means of 10); plain {plain_ms:.1f} ms", flush=True)
        print(f"[kernel] la_walk {name} clock: {kernel_phases(args)}",
              flush=True)
        if name == "slice":
            e1 = e_cap + 1
            n_ev = int(args[4].item())
            nbytes = 4 * e1 * 4 + 4 + e1 * n * 4    # 4 index arrays + n_events in, la out
            nops = 2 * n_ev * n                     # one max and one select per cell
            row = {
                "name": "la_walk", "route": "cuda",
                "source": "babble_tpu_torch/csrc/la_walk.cu",
                "replaces": "babble_tpu/ops/pallas_ingest.py:118",
                "launches": 0, "max_abs_err": err,
                "ms": ms, "ms_device": ms_device, "ms_cold": ms_cold,
                "plain_ms": plain_ms,
                "bound_ms": max(nbytes / PEAK_BYTES_S,
                                nops / PEAK_OPS_S) * 1e3,
                "bound_by": ("bytes" if nbytes / PEAK_BYTES_S
                             >= nops / PEAK_OPS_S else "operations"),
                "library_ms": None,
            }
    return row


def kernel_resources() -> None:
    """What the runtime reports for each compiled kernel, and la_walk's
    shared memory at the main path's size and at the gate's edge."""
    from babble_tpu_torch.ops import pallas_ingest as pi

    if not pi.walk_supported(GATE["n"], GATE["e"], 64) or \
            pi.walk_supported(GATE["n"], GATE["e"] + 1, 64):
        raise AssertionError("GATE is not the walk gate's edge")
    a = pi.kernel_attributes(SLICE["e"])
    gate = pi.kernel_attributes(GATE["e"])
    static = a["static_smem"]
    print(f"[build] la_walk_kernel: {a['registers']} registers/thread, "
          f"{a['local_bytes']} B local/thread, {a['max_threads']} "
          f"threads/block max, {static} B static shared + the int16 column "
          f"dynamic: {static + a['dynamic_smem']} B at e_cap "
          f"{SLICE['e']}, {static + gate['dynamic_smem']} B at the gate's "
          f"edge {GATE['e']} (of 232,448)", flush=True)


def phase_slice(dev, card: str):
    """Drive the main path; returns (la_walk's launch count in that run,
    the run's wall ms)."""
    import torch

    from babble_tpu_torch import (
        DagConfig, assert_consensus_parity, batch_from_arrays,
        consensus_step, init_state, random_gossip_arrays,
    )
    from babble_tpu_torch.ops import fame, ingest, order
    from babble_tpu_torch.ops.pallas_ingest import la_walk, walk_supported

    t0 = time.perf_counter()
    dag = random_gossip_arrays(SLICE["n"], SLICE["e"], seed=SLICE["seed"])
    cfg = DagConfig(n=SLICE["n"], e_cap=SLICE["e"],
                    s_cap=dag.max_chain + 1, r_cap=SLICE["r_cap"])
    batch = batch_from_arrays(dag, device=dev)
    print(f"[slice] {cfg}; {dag.n_levels} levels; host DAG build "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if not walk_supported(cfg.n, cfg.e_cap, cfg.s_cap):
        raise AssertionError("walk mode not supported at the slice config")

    # warm-up run (first-use costs of torch's own kernels), not counted
    consensus_step(cfg, "walk", init_state(cfg, device=dev), batch)
    torch.cuda.synchronize()

    state0 = init_state(cfg, device=dev)
    la_walk.launches = 0
    box = {}
    step_ms = wall_ms(lambda: box.setdefault(
        "out", consensus_step(cfg, "walk", state0, batch)))
    launches = la_walk.launches
    out = box["out"]
    if launches < 1:
        raise AssertionError("the walk step never launched la_walk")

    # per-phase wall times of the same step (synchronised between phases)
    st = init_state(cfg, device=dev)
    phases = {}
    for name, fn in (
        ("ingest_coords", lambda s: ingest.ingest_coords_impl(cfg, s, "walk", batch)),
        ("ingest_rounds", lambda s: ingest.ingest_rounds_impl(cfg, s, "walk", batch)),
        ("fame", lambda s: fame.decide_fame_auto_impl(cfg, s)),
        ("order", lambda s: order.decide_order_impl(cfg, s)),
    ):
        box = {}
        phases[name] = wall_ms(lambda: box.setdefault("s", fn(st)))
        st = box["s"]
        if name == "ingest_rounds":
            ingested = st
    assert_consensus_parity(out, st, cfg.e_cap, "phased-vs-step")

    fast = consensus_step(cfg, "fast", init_state(cfg, device=dev), batch)
    torch.cuda.synchronize()
    assert_consensus_parity(fast, out, cfg.e_cap, "walk-vs-fast on card")

    got = dict(
        max_round=int(out.max_round.item()), lcr=int(out.lcr.item()),
        ordered=int((out.rr[: cfg.e_cap] >= 0).sum().item()),
    )
    if got != EXPECT:
        raise AssertionError(f"slice counts {got} != JAX package's {EXPECT}")
    finite = bool(torch.all(out.cts[: cfg.e_cap][out.rr[: cfg.e_cap] >= 0] > 0))
    if not finite:
        raise AssertionError("an ordered event has no consensus timestamp")
    print(f"[slice] walk step {step_ms:.1f} ms wall ({card}); "
          f"la_walk launches {launches}; counts {got}; walk == fast",
          flush=True)
    print("[slice] phases (ms wall): " + ", ".join(
        f"{k} {v:.1f}" for k, v in phases.items()), flush=True)
    return launches, step_ms, out, cfg, dag, ingested


def stream_stats(name: str, log, card: str) -> str:
    """One line on a stream's flush log: flush count, the W and F
    values, per-flush wall ms (p50, p99, max) and events per second."""
    import numpy as np

    ms = np.array([r.ms for r in log])
    events = sum(r.k for r in log)
    drains = sum(1 for r in log if r.k == 0)
    return (f"[live] {name}: {len(log)} flushes ({len(log) - drains} of "
            f"up to {LIVE_CHUNK} events, {drains} drain), W "
            f"{sorted({r.W for r in log})}, F {sorted({r.F for r in log})}; "
            f"per-flush wall ms p50 {np.percentile(ms, 50):.3f}, p99 "
            f"{np.percentile(ms, 99):.3f}, max {ms.max():.3f}; "
            f"{events / (ms.sum() / 1e3):.1f} events/s over "
            f"{ms.sum() / 1e3:.3f} s of flushes; lcr {log[-1].lcr} ({card})")


def check_stream(name: str, state, walk_out, e: int) -> None:
    """A drained stream against the JAX package's (``LIVE_EXPECT``), and
    its coordinates and witnesses against the walk step's."""
    import torch

    from babble_tpu_torch.ops.state import consensus_digest

    got = dict(max_round=int(state.max_round.item()),
               lcr=int(state.lcr.item()),
               ordered=int((state.rr[:e] >= 0).sum().item()),
               digest=consensus_digest(state, e))
    if got != LIVE_EXPECT[name]:
        raise AssertionError(
            f"{name} live stream {got} != JAX package's {LIVE_EXPECT[name]}")
    for f in ("la", "fd", "round", "witness"):
        if not torch.equal(getattr(state, f)[:e], getattr(walk_out, f)[:e]):
            raise AssertionError(f"{name} live stream: {f} != walk step")
    if not torch.equal(state.wslot, walk_out.wslot):
        raise AssertionError(f"{name} live stream: wslot != walk step")


def phase_live(dev, card: str, walk_out, cfg, dag) -> None:
    """The live stream, ungated and gated, against the walk step."""
    import torch

    from babble_tpu_torch import assert_consensus_parity
    from babble_tpu_torch.ops.flush import live_flush_impl, probed_flush
    from babble_tpu_torch.sim.live import (
        chunk_levels, flush_shape, live_stream, read_mirrors, stream_batch,
    )

    cfg = cfg._replace(packed=True)
    e, mid = cfg.e_cap, LIVE_MID
    # warm-up (first-use costs of torch's kernels), not counted
    live_stream(cfg, dag, LIVE_CHUNK, True, device=dev, stop=2048)

    state, log = live_stream(cfg, dag, LIVE_CHUNK, False, device=dev)
    print(stream_stats("ungated", log, card), flush=True)
    if sum(r.k > 0 for r in log) != -(-dag.n_events // LIVE_CHUNK):
        raise AssertionError("the ungated stream did not flush every chunk")
    check_stream("ungated", state, walk_out, e)
    # ungated lcr is the highest decided round in the window, so a round
    # whose witness is still open can be jumped and never revisited: its
    # events are received later than in the batch step (the JAX stream
    # does the same; LIVE_EXPECT holds the card to it)
    R, lcr = cfg.r_cap, int(state.lcr.item())
    open_rows = ((state.famous[:R] == 0) & (state.wslot[:R] >= 0)).any(dim=1)
    abandoned = torch.nonzero(open_rows[: lcr + 1]).flatten().tolist()
    rr_diff = int((state.rr[:e] != walk_out.rr[:e]).sum().item())
    cts_diff = int((state.cts[:e] != walk_out.cts[:e]).sum().item())
    print(f"[live] ungated drained state == the JAX package's stream "
          f"(counts and consensus digest); la, fd, round, witness, wslot "
          f"== walk step; against the walk step rr differs on {rr_diff} "
          f"events and cts on {cts_diff}, rounds left with an open witness "
          f"at or below lcr: {abandoned}", flush=True)

    # gated, in two halves: the frontier check and the probed flushes
    # run on the state at slot LIVE_MID (flushes do not modify their
    # input state)
    half, log1 = live_stream(cfg, dag, LIVE_CHUNK, True, device=dev,
                             stop=mid, drain=False)
    m = read_mirrors(half)
    batch = stream_batch(dag, mid, mid + LIVE_CHUNK, dev)
    W, F = flush_shape(cfg, m, LIVE_CHUNK,
                       chunk_levels(dag, mid, mid + LIVE_CHUNK), True)
    if F >= e + 1:
        raise AssertionError(f"F {F} at slot {mid} is the full height")
    a = live_flush_impl(cfg, W, F, True, half, batch)
    b = live_flush_impl(cfg, W, e + 1, True, half, batch)
    for f, x, y in zip(a._fields, a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"frontier F={F} vs F={e + 1}: {f} differs")
    print(f"[live] frontier: flush at slot {mid} (W {W}) with F {F} == "
          f"with F {e + 1} on every field", flush=True)

    probe, split = half, {"ingest_s": 0.0, "fame_s": 0.0, "order_s": 0.0}
    m, lo = read_mirrors(half), mid
    for _ in range(LIVE_PROBED):
        hi = lo + LIVE_CHUNK
        W, F = flush_shape(cfg, m, hi - lo, chunk_levels(dag, lo, hi), True)
        probe, t = probed_flush(cfg, W, F, True, probe,
                                stream_batch(dag, lo, hi, dev))
        split = {k: split[k] + t[k] for k in split}
        m, lo = read_mirrors(probe), hi
    plain, _ = live_stream(cfg, dag, LIVE_CHUNK, True, state=half, stop=lo,
                           drain=False)
    for f, x, y in zip(plain._fields, plain, probe):
        if not torch.equal(x, y):
            raise AssertionError(f"probed flushes differ from plain: {f}")
    print(f"[live] probed_flush over {LIVE_PROBED} flushes from slot {mid} "
          f"(== unprobed), mean ms per flush: " + ", ".join(
              f"{k[:-2]} {v * 1e3 / LIVE_PROBED:.3f}" for k, v in split.items())
          + f" ({card})", flush=True)

    state, log2 = live_stream(cfg, dag, LIVE_CHUNK, True, state=half)
    print(stream_stats("gated", log1 + log2, card), flush=True)
    check_stream("gated", state, walk_out, e)
    # drained, the gated stream decides every round the batch step does
    assert_consensus_parity(walk_out, state, e, "gated live vs walk step")
    print(f"[live] gated drained state == the JAX package's stream (counts "
          f"and consensus digest) == walk step on every consensus field "
          f"(lcr {int(state.lcr.item())}, "
          f"{int((state.rr[:e] >= 0).sum().item())} ordered)", flush=True)


def engine_summary(eng, kinds) -> dict:
    """What ENGINE_EXPECT holds the engine to after a flow (the fields of
    tests/test_torch_engine.py flow_summary)."""
    return dict(
        commit_length=eng.commit_length, commit_digest=eng.commit_digest,
        calls=len(kinds), latency=kinds.count("latency"),
        throughput=kinds.count("throughput"),
        lcr=eng.last_consensus_round, evicted=eng.dag.slot_base,
        e_cap=eng.cfg.e_cap, r_cap=eng.cfg.r_cap,
        flush_fallbacks=eng.flush_fallbacks,
    )


def check_engine(name: str, got: dict) -> None:
    if got != ENGINE_EXPECT[name]:
        diff = {k: (got[k], v) for k, v in ENGINE_EXPECT[name].items()
                if got[k] != v}
        raise AssertionError(
            f"engine {name} != the JAX engine's (port, JAX): {diff}")


def timed(fn, acc: list):
    """``fn`` with its wall seconds added to ``acc[0]`` on every call."""
    def run(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            acc[0] += time.perf_counter() - t0
    return run


def phase_engine(dev, card: str, walk_out, walk_cfg, dag) -> None:
    """The engine as a catch-up and as a live node (module docstring)."""
    import numpy as np
    import torch

    from babble_tpu_torch import TorchHashgraph, events_from_arrays
    from babble_tpu_torch.consensus.engine import node_engine_kwargs

    t0 = time.perf_counter()
    events = events_from_arrays(dag)
    participants = dag.participants()
    print(f"[engine] {len(events)} events built on the host in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # (a) catch-up
    eng = TorchHashgraph(participants, verify_signatures=False, device=dev)
    t0 = time.perf_counter()
    for ev in events:
        eng.insert_event(ev.clone())
    t1 = time.perf_counter()
    committed = eng.run_consensus()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    got = engine_summary(eng, [eng.last_kernel_class])
    check_engine("catchup", got)
    e, R = walk_cfg.e_cap, walk_cfg.r_cap
    st = eng.state
    for f in ("round", "witness"):
        if not torch.equal(getattr(st, f)[:e], getattr(walk_out, f)[:e]):
            raise AssertionError(f"catch-up engine: {f} != walk step")
    for f, none in (("wslot", -1), ("famous", 0)):
        a, b = getattr(st, f), getattr(walk_out, f)
        if not (torch.equal(a[:R], b[:R]) and bool((a[R:] == none).all())):
            raise AssertionError(f"catch-up engine: {f} != walk step")
    if int(st.lcr) != int(walk_out.lcr):
        raise AssertionError("catch-up engine: lcr != walk step")
    print(f"[engine] catch-up: {len(committed)} committed in one "
          f"run_consensus ({eng.last_kernel_class}); inserts "
          f"{(t1 - t0) * 1e3:.1f} ms, run_consensus {(t2 - t1) * 1e3:.1f} "
          f"ms wall; {len(committed) / (t2 - t1):.1f} events committed/s "
          f"over run_consensus, {len(committed) / (t2 - t0):.1f} over "
          f"inserts + run_consensus; cfg e_cap {eng.cfg.e_cap} s_cap "
          f"{eng.cfg.s_cap} r_cap {eng.cfg.r_cap} ({card})", flush=True)
    print(f"[engine] catch-up == the JAX engine (commit length, digest, "
          f"dispatch) and == walk step on round, witness, wslot, famous, "
          f"lcr ({int(st.lcr)})", flush=True)
    del eng, st

    # (b) the live node
    eng = TorchHashgraph(participants, verify_signatures=False, device=dev,
                         **node_engine_kwargs())
    build_s, collect_s = [0.0], [0.0]
    eng.build_batch = timed(eng.build_batch, build_s)
    eng._collect_ordered = timed(eng._collect_ordered, collect_s)
    kinds, call_ms, insert_s, n_committed = [], [], 0.0, 0
    caps, steps = (eng.cfg.e_cap, eng.cfg.r_cap), []
    lo, drains = 0, 0
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        for ev in events[lo:lo + LIVE_CHUNK]:
            eng.insert_event(ev.clone())
        t1 = time.perf_counter()
        out = eng.run_consensus()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        insert_s += t1 - t0
        call_ms.append((t2 - t1) * 1e3)
        kinds.append(eng.last_kernel_class)
        n_committed += len(out)
        if (eng.cfg.e_cap, eng.cfg.r_cap) != caps:
            caps = (eng.cfg.e_cap, eng.cfg.r_cap)
            steps.append((lo, caps))
        if lo >= len(events):
            drains += 1
            if not out or drains >= DRAIN_MAX:
                break
        lo = min(lo + LIVE_CHUNK, len(events))
    total_s = time.perf_counter() - t_start
    got = engine_summary(eng, kinds)
    check_engine("live", got)
    if got["evicted"] <= 0:
        raise AssertionError("the live node never compacted")
    ms = np.array(call_ms)
    lat = np.array([m for m, k in zip(call_ms, kinds) if k == "latency"])
    thr = np.array([m for m, k in zip(call_ms, kinds) if k == "throughput"])
    calls_s = ms.sum() / 1e3
    host_s = insert_s + build_s[0] + collect_s[0]
    print(f"[engine] live node ({node_engine_kwargs()}): {len(kinds)} "
          f"calls ({drains} drain), {got['latency']} latency, "
          f"{got['throughput']} throughput, flush_fallbacks "
          f"{eng.flush_fallbacks}; per-call wall ms p50 "
          f"{np.percentile(ms, 50):.3f}, p99 {np.percentile(ms, 99):.3f}, "
          f"max {ms.max():.3f} (latency calls p50 "
          f"{np.percentile(lat, 50):.3f}, throughput calls p50 "
          f"{np.percentile(thr, 50) if len(thr) else float('nan'):.3f}); "
          f"{n_committed / total_s:.1f} events committed/s over "
          f"{total_s:.3f} s of inserts and calls ({card})", flush=True)
    print(f"[engine] live node: growth (slot, (e_cap, r_cap)) {steps}; "
          f"evicted {eng.dag.slot_base} slots, final live window "
          f"{eng.dag.n_events - eng.dag.slot_base} events, consensus "
          f"window {len(list(eng.consensus))}; stats "
          f"{eng.stats_snapshot()}", flush=True)
    print(f"[engine] live node host split: inserts {insert_s:.3f} s, "
          f"build_batch {build_s[0]:.3f} s, _collect_ordered (with "
          f"compaction) {collect_s[0]:.3f} s, rest of run_consensus (the "
          f"flush) {calls_s - build_s[0] - collect_s[0]:.3f} s; host share "
          f"{host_s / (insert_s + calls_s):.4f} of inserts + calls",
          flush=True)
    print(f"[engine] live node == the JAX engine (commit length "
          f"{got['commit_length']}, digest, dispatch, lcr {got['lcr']}, "
          f"evictions, capacities, fallbacks)", flush=True)


def phase_block_fame(card: str, cfg, ingested) -> None:
    """Block fame against the diagonal form on phase 4's ingested state."""
    import torch

    from babble_tpu_torch.ops import fame

    for gate in (False, True):
        box = {}
        diag_ms = wall_ms(lambda: box.setdefault(
            "d", fame.decide_fame_impl(cfg, ingested, gate)))
        block_ms = wall_ms(lambda: box.setdefault(
            "b", fame.decide_fame_block_impl(cfg, ingested, True, gate)))
        d, b = box["d"], box["b"]
        for f in ("famous", "lcr", "mbr", "fmr"):
            if not torch.equal(getattr(d, f), getattr(b, f)):
                raise AssertionError(f"block fame != diagonal (gate={gate}): {f}")
        print(f"[engine] block fame == diagonal fame on phase 4's ingested "
              f"state, gate={gate} (lcr {int(b.lcr)}): block "
              f"{block_ms:.1f} ms, diagonal {diag_ms:.1f} ms wall ({card})",
              flush=True)


#: host mirrors a restored engine must hold as the saving one did (the
#: frontier mirror restarts at its floor, and counters are metrics)
MIRRORS = ("cfg", "participants", "epoch", "pending_membership",
           "membership_queue", "membership_log", "membership_base_epoch",
           "membership_addrs", "_r_off", "_lcr_cache", "_max_round_cache",
           "_received", "_ordered_total", "consensus_transactions",
           "last_committed_round_events", "commit_digest", "commit_length",
           "auto_compact", "seq_window", "round_margin", "compact_min",
           "consensus_window", "inactive_rounds")


def check_restored(kind: str, a, b) -> None:
    """``b`` (restored) equals ``a`` (saving) on every DagState field and
    the host mirrors."""
    import torch

    for f, x, y in zip(a.state._fields, a.state, b.state):
        if not (x.dtype == y.dtype and x.shape == y.shape
                and x.device == y.device and torch.equal(x, y)):
            raise AssertionError(f"{kind} restart: state {f} differs")
    for f in MIRRORS:
        if getattr(a, f) != getattr(b, f):
            raise AssertionError(f"{kind} restart: {f} differs")
    da, db = a.dag, b.dag
    if list(a.consensus) != list(b.consensus) or \
            a.consensus.start != b.consensus.start:
        raise AssertionError(f"{kind} restart: consensus window differs")
    for f in ("levels", "sp_slot", "op_slot", "wire_meta", "eff_ts"):
        if list(getattr(da, f)) != list(getattr(db, f)):
            raise AssertionError(f"{kind} restart: dag {f} differs")
    if [e.hex() for e in da.events] != [e.hex() for e in db.events] or \
            da.slot_base != db.slot_base or da.slot_of != db.slot_of or \
            da.evicted_heads != db.evicted_heads or \
            [(c.start, list(c)) for c in da.chains] != \
            [(c.start, list(c)) for c in db.chains]:
        raise AssertionError(f"{kind} restart: host DAG differs")


def phase_churn(dev, card: str) -> None:
    """The churn flow with its two restarts, the golden checkpoints and
    the verify timing (module docstring, phase 7)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from babble_tpu_torch import TorchHashgraph
    from babble_tpu_torch.consensus.engine import node_engine_kwargs
    from babble_tpu_torch.core.event import new_event
    from babble_tpu_torch.sim.generator import (
        feed_churn, random_churn_dag, random_gossip_dag,
    )
    from babble_tpu_torch.store import (
        load_checkpoint, load_snapshot, save_checkpoint, snapshot_bytes,
    )

    t0 = time.perf_counter()
    dag = random_churn_dag(CHURN["n"], CHURN["e"], CHURN["seed"],
                           CHURN_SCHEDULE)
    print(f"[churn] {len(dag.events)} events over {CHURN['n']} founders and "
          f"{len(dag.keys) - CHURN['n']} other identities built on the host "
          f"in {time.perf_counter() - t0:.2f} s; transactions at "
          f"{sorted(dag.txs.items())}, joiners start at "
          f"{sorted(dag.starts.items())}", flush=True)
    transitions, restarts = [], []
    tmp = tempfile.mkdtemp(prefix="babble-churn-")

    def restart(eng, kind):
        torch.cuda.synchronize()
        if kind == "files":
            path = os.path.join(tmp, "ckpt")
            t0 = time.perf_counter()
            save_checkpoint(eng, path)
            t1 = time.perf_counter()
            back = load_checkpoint(path, device=dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            sizes = {f: os.path.getsize(os.path.join(path, f))
                     for f in ("meta.msgpack", "device.npz")}
        else:
            t0 = time.perf_counter()
            snap = snapshot_bytes(eng)
            t1 = time.perf_counter()
            back = load_snapshot(snap, verify_events=False, device=dev,
                                 expected_participants=dict(eng.participants))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            sizes = {"snapshot": len(snap)}
        check_restored(kind, eng, back)
        back.finality_gate = True     # the live path's gate (a Node sets it)
        restarts.append(dict(kind=kind, slot=hi, save_ms=(t1 - t0) * 1e3,
                             load_ms=(t2 - t1) * 1e3, window=(
                                 back.dag.n_events - back.dag.slot_base),
                             epoch=back.epoch, **sizes))
        print(f"[churn] restart from {kind} after slot {hi}: save "
              f"{(t1 - t0) * 1e3:.1f} ms, load {(t2 - t1) * 1e3:.1f} ms, "
              f"{sizes} bytes, live window {restarts[-1]['window']} events, "
              f"epoch {back.epoch}; restored == saving engine on every "
              f"DagState field and the host mirrors ({card})", flush=True)
        return back

    eng = TorchHashgraph(dict(dag.participants), verify_signatures=False,
                         device=dev, **node_engine_kwargs())
    kinds, call_ms, slots, marks, n_committed = [], [], [], {}, 0
    carried = {"membership_rejects": 0, "flush_fallbacks": 0}
    lo, drains, e = 0, 0, len(dag.events)
    t_start = time.perf_counter()
    while True:
        hi = min(lo + CHURN["chunk"], e)
        feed_churn(eng, dag, lo, hi)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = eng.run_consensus()
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t1) * 1e3)
        slots.append(hi)
        kinds.append(eng.last_kernel_class)
        n_committed += len(out)
        if eng.epoch > len(transitions):
            # one transition at most a call: the next one's boundary is
            # past the applied one's
            transitions.append(dict(eng.last_transition, epoch=eng.epoch))
        for kind, due in (("files", eng.pending_membership is not None
                           and bool(eng.membership_queue)),
                          ("bytes", hi == CHURN["snap_slot"])):
            if due and kind not in marks:
                marks[kind] = hi
                for k in carried:
                    carried[k] += getattr(eng, k)
                eng = restart(eng, kind)
        if lo >= e:
            drains += 1
            if not out or drains >= DRAIN_MAX:
                break
        lo = hi
    total_s = time.perf_counter() - t_start
    for k in carried:
        carried[k] += getattr(eng, k)
    got = dict(
        commit_length=eng.commit_length, commit_digest=eng.commit_digest,
        epoch=eng.epoch, membership_log=[
            [x["epoch"], x["kind"], x["cid"], x["boundary"], x["position"],
             hashlib.sha256(x["tx"]).hexdigest()[:8]]
            for x in eng.membership_log],
        membership_rejects=carried["membership_rejects"],
        n=eng.cfg.n, retired=list(eng.cfg.retired), e_cap=eng.cfg.e_cap,
        r_cap=eng.cfg.r_cap, calls=len(kinds),
        latency=kinds.count("latency"), throughput=kinds.count("throughput"),
        flush_fallbacks=carried["flush_fallbacks"],
        evicted=eng.dag.slot_base, restarts=marks,
    )
    if got != CHURN_EXPECT:
        diff = {k: (got[k], v) for k, v in CHURN_EXPECT.items()
                if got[k] != v}
        raise AssertionError(f"churn flow != the JAX engine's (port, JAX): "
                             f"{diff}")
    ms = np.array(call_ms)
    slow = sorted(zip(call_ms, slots, kinds), reverse=True)[:3]
    print(f"[churn] live node with churn: {len(kinds)} calls ({drains} "
          f"drain), {got['latency']} latency, {got['throughput']} "
          f"throughput, flush_fallbacks {got['flush_fallbacks']}; per-call "
          f"wall ms p50 {np.percentile(ms, 50):.3f}, p99 "
          f"{np.percentile(ms, 99):.3f}, max {ms.max():.3f}; "
          f"{n_committed / total_s:.1f} events committed/s over "
          f"{total_s:.3f} s of inserts, calls and restarts ({card}); "
          f"slowest calls (ms, slot, surface): " + ", ".join(
              f"({m:.1f}, {sl}, {k})" for m, sl, k in slow), flush=True)
    for t in transitions:
        print(f"[churn] epoch transition to epoch {t['epoch']}: "
              f"{t['wall_s'] * 1e3:.1f} ms wall = host numpy "
              f"{t['host_s'] * 1e3:.1f} + upload {t['upload_s'] * 1e3:.1f} + "
              f"rescan {t['rescan_s'] * 1e3:.1f} ms, {t['suspects']} "
              f"suspects ({card})", flush=True)
    first = eng.dag.events[eng.dag.slot_base]
    cid = eng.participants[first.creator]
    print(f"[churn] evicted {eng.dag.slot_base} slots; the first live slot "
          f"holds creator {cid}'s seq {first.index} of "
          f"{len(eng.dag.chains[cid])}, live window "
          f"{eng.dag.n_events - eng.dag.slot_base} events", flush=True)
    print(f"[churn] == the JAX engine: commit length {got['commit_length']}, "
          f"digest, epoch {got['epoch']}, log {got['membership_log']}, "
          f"rejects {got['membership_rejects']}, cfg n {got['n']} retired "
          f"{got['retired']} e_cap {got['e_cap']} r_cap {got['r_cap']}, "
          f"calls, evicted {got['evicted']}", flush=True)

    # the golden checkpoints, restored on the card and extended
    g = GOLDEN_DAG
    gdag = random_gossip_dag(g["n"], g["e"], seed=g["seed"])
    here = os.path.dirname(os.path.abspath(__file__))
    for v in (3, 4, 5):
        geng = load_checkpoint(os.path.join(
            here, "tests", "golden", "checkpoints", f"v{v}"), device=dev)
        if geng.state.sp.device.type != torch.device(dev).type:
            raise AssertionError("golden restore did not land on the card")
        for ev in gdag.events[g["prefix"]:]:
            geng.insert_event(ev.clone())
        geng.run_consensus()
        gg = dict(commit_length=geng.commit_length,
                  commit_digest=geng.commit_digest)
        if gg != GOLDEN_EXPECT[f"v{v}"]:
            raise AssertionError(f"golden v{v} extended {gg} != JAX's "
                                 f"{GOLDEN_EXPECT[f'v{v}']}")
    print(f"[churn] golden v3/v4/v5 checkpoints restored on the card and "
          f"extended == the JAX package's (commit length and digest)",
          flush=True)

    # Event.verify over really signed events
    keys = dag.keys[:8]
    signed = []
    t0 = time.perf_counter()
    for i in range(VERIFY_EVENTS):
        ev = new_event([b"tx%d" % i], ("", ""), keys[i % 8].pub_bytes, 0,
                       timestamp=1_700_000_000_000_000_000 + i)
        ev.sign(keys[i % 8])
        signed.append(ev)
    sign_us = (time.perf_counter() - t0) / VERIFY_EVENTS * 1e6
    passes = []
    for _ in range(2):
        t0 = time.perf_counter()
        ok = all(ev.verify() for ev in signed)
        passes.append((time.perf_counter() - t0) / VERIFY_EVENTS * 1e6)
        if not ok:
            raise AssertionError("a signed event failed Event.verify")
    if signed[0].clone().verify() is not True or new_event(
            [b"x"], ("", ""), keys[0].pub_bytes, 0, 1).verify():
        raise AssertionError("Event.verify accepted an unsigned event")
    print(f"[churn] Event.verify over {VERIFY_EVENTS} signed events by 8 "
          f"keys: {passes[0]:.1f} us/event first pass (one comb table "
          f"built per key), {passes[1]:.1f} us/event warm; sign "
          f"{sign_us:.1f} us/event (host CPU of the card's machine)",
          flush=True)


def replay_summary(cores) -> dict:
    """What NODE_EXPECT holds the replay's Cores to (the fields of
    tests/test_torch_core.py replay_summary)."""
    return {
        "commit_length": [c.hg.commit_length for c in cores],
        "commit_digest": [c.hg.commit_digest for c in cores],
        "consensus_txs": [c.consensus_transactions_count() for c in cores],
        "seq": [c.seq for c in cores],
    }


def pctl(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def replay_cores(device):
    """Four Cores through NODE_REPLAY's schedule, ``run_consensus`` after
    every sync.  Returns the Cores, the host seconds of the syncs and
    each call's wall ms and surface."""
    from babble_tpu_torch.crypto.keys import key_from_scalar
    from babble_tpu_torch.net.commands import SyncRequest, SyncResponse
    from babble_tpu_torch.node.core import Core
    from babble_tpu_torch.sim.replay import (
        LogicalClock, replay_scalars, sync_schedule,
    )

    cfg = NODE_REPLAY
    keys = [key_from_scalar(d)
            for d in replay_scalars(cfg["n"], cfg["seed"])]
    parts = {k.pub_hex: i for i, k in enumerate(keys)}
    clock = LogicalClock()
    cache = cfg["cache_size"]
    cores = [Core(i, keys[i], dict(parts), e_cap=max(cache, 64),
                  cache_size=cache, device=device)
             for i in range(cfg["n"])]
    for c in cores:
        c.now_ns = clock
    for c in cores:
        c.init()
    steps = sync_schedule(cfg["n"], cfg["syncs"], cfg["seed"])
    sync_s, call_ms, kinds = 0.0, [], []
    for i, (frm, to, payload) in enumerate(steps):
        a, b = cores[frm], cores[to]
        t1 = time.perf_counter()
        req = SyncRequest.unpack(SyncRequest("b", b.known()).pack())
        diff = a.diff(req.known)
        resp = SyncResponse.unpack(SyncResponse(
            "a", a.head, a.to_wire(diff), a.known()).pack())
        if not b.sync(resp.head, resp.events, payload):
            raise AssertionError(f"replay sync {i} minted no event")
        t2 = time.perf_counter()
        b.run_consensus()
        sync_s += t2 - t1
        call_ms.append((time.perf_counter() - t2) * 1e3)
        kinds.append(b.hg.last_kernel_class)
    return cores, sync_s, call_ms, kinds


def calls_line(call_ms, kinds) -> str:
    return (f"run_consensus {sum(call_ms) / 1e3:.1f} s ({len(call_ms)} "
            f"calls, p50 {pctl(call_ms, 0.5):.2f} / p99 "
            f"{pctl(call_ms, 0.99):.2f} / max {max(call_ms):.2f} ms; "
            f"latency {kinds.count('latency')}, throughput "
            f"{kinds.count('throughput')})")


def phase_node_replay(card: str, device="cuda") -> None:
    """Phase 8(a): four Cores through the seeded sync replay, held to
    NODE_EXPECT bit for bit (module docstring)."""
    cfg = NODE_REPLAY
    t0 = time.perf_counter()
    cores, sync_s, call_ms, kinds = replay_cores(device)
    wall = time.perf_counter() - t0
    got = replay_summary(cores)
    if got != NODE_EXPECT:
        diff = {k: (got[k], v) for k, v in NODE_EXPECT.items()
                if got[k] != v}
        raise AssertionError(f"Core replay != the JAX Cores' (port, JAX): "
                             f"{diff}")
    commits = sum(got["commit_length"])
    print(f"[node] (a) Core replay == NODE_EXPECT: {cfg['syncs']} syncs over "
          f"{cfg['n']} Cores, commit lengths {got['commit_length']}, "
          f"digest {got['commit_digest'][0][:16]}", flush=True)
    print(f"[node] (a) wall {wall:.1f} s: syncs (diff, wire bytes both ways, "
          f"insert, verify, sign) {sync_s:.1f} s, {calls_line(call_ms, kinds)}"
          f"; {commits / wall:.0f} events committed/s over the four Cores; "
          f"{card}", flush=True)


class FailureLog(logging.Handler):
    """Sorts what the testnet's nodes log and carry on from.

    A pull or push that failed is read by its exception: a timeout
    (asyncio's, with empty text: the exchange outlived ``tcp_timeout``)
    or a peer that is unreachable or gone (the in-memory transport's
    ``transport closed``, ``not connected to``, ``unknown peer``: node 3
    while it is down) is counted by that class.  Any other exception is
    a failure: with ``consensus_interval`` 0 a ``run_consensus`` that
    raises inside a pull surfaces only here.  Of the other warnings,
    the two notices of a WAL restart are counted, and every other one
    (a failed consensus run or served RPC among them) is a failure."""

    EXCHANGES = ("gossip to %s failed: %s", "push to %s failed: %s")
    UNREACHABLE = ("transport closed", "not connected to", "unknown peer")
    NOTICES = ("WAL missing or truncated", "seq probe complete")

    def __init__(self, transport_error):
        super().__init__(logging.DEBUG)
        self.transport_error = transport_error
        self.kinds = {}
        self.failures = []

    def count(self, kind):
        self.kinds[kind] = self.kinds.get(kind, 0) + 1

    def emit(self, record):
        if record.msg in self.EXCHANGES:
            e = record.args[-1]
            verb = record.msg.split()[0]
            if isinstance(e, TimeoutError):
                self.count(f"{verb} timeout")
            elif (isinstance(e, self.transport_error)
                  and str(e).startswith(self.UNREACHABLE)):
                self.count(f"{verb} unreachable")
            else:
                self.failures.append(
                    f"{record.getMessage()} ({type(e).__name__})")
        elif record.levelno >= logging.WARNING:
            msg = record.getMessage()
            notice = next((m for m in self.NOTICES if msg.startswith(m)),
                          None)
            if notice is None:
                self.failures.append(msg)
            else:
                self.count(notice)


def hist_pctl(h, q: float) -> str:
    """The upper bound of the registry histogram bucket holding quantile
    ``q`` (the registry keeps buckets, not samples)."""
    d = h.to_dict()
    if not d["count"]:
        return "-"
    for bound, cum in d["buckets"]:
        if cum >= q * d["count"]:
            return f"<= {bound * 1e3:g} ms" if bound != "+Inf" else "> 60 s"
    return "-"


def phase_testnet(card: str, device="cuda") -> None:
    """Phase 8(b): the reference's 4-node testnet under bombard traffic,
    node 3 crashed and restarted from its WAL (module docstring)."""
    import asyncio
    import os
    import shutil
    import tempfile
    import threading

    from babble_tpu_torch.crypto import _fallback as fb
    from babble_tpu_torch.crypto.keys import key_from_scalar
    from babble_tpu_torch.net import InmemNetwork, Peer, TransportError
    from babble_tpu_torch.node import Config, Node
    from babble_tpu_torch.proxy import InmemAppProxy
    from babble_tpu_torch.sim.replay import replay_scalars

    T = TESTNET
    n, crash = T["nodes"], T["crash_node"]
    bursts = T["txs_per_node"] // T["burst"]
    total = n * T["txs_per_node"]
    keys = [key_from_scalar(d) for d in replay_scalars(n, T["seed"])]
    logger = logging.getLogger("babble_tpu_torch.testnet")
    logger.propagate = False
    logger.setLevel(logging.DEBUG)  # a failed push is logged at DEBUG
    counts = FailureLog(TransportError)
    logger.addHandler(counts)
    tmp = tempfile.mkdtemp(prefix="babble-testnet-")

    crypto = {"sign": [0, 0.0], "verify": [0, 0.0]}
    lock = threading.Lock()
    originals = (fb.sign, fb.verify)

    def timed_crypto(name, fn):
        def run(*a):
            t = time.perf_counter()
            try:
                return fn(*a)
            finally:
                dt = time.perf_counter() - t
                with lock:
                    crypto[name][0] += 1
                    crypto[name][1] += dt
        return run

    class TimedProxy(InmemAppProxy):
        """Records when each transaction first commits at its node."""

        def __init__(self, seen):
            super().__init__()
            self.seen = seen

        async def commit_batch(self, txs):
            now = time.perf_counter()
            for tx in txs:
                self.seen.setdefault(bytes(tx), now)
            await super().commit_batch(txs)

    def conf(i):
        return Config(heartbeat=T["heartbeat"], tcp_timeout=T["tcp_timeout"],
                      cache_size=T["cache_size"], device=device,
                      wal_dir=os.path.join(tmp, f"wal{i}"), logger=logger)

    async def until(pred, timeout, what):
        async def poll():
            while not pred():
                await asyncio.sleep(0.05)
        try:
            await asyncio.wait_for(poll(), timeout)
        except asyncio.TimeoutError:
            raise AssertionError(f"testnet: {what} not reached in "
                                 f"{timeout:.0f} s") from None

    async def run():
        net = InmemNetwork()
        ts = [net.transport(f"inmem://{i}") for i in range(n)]
        peers = [Peer(t.local_addr(), k.pub_hex) for t, k in zip(ts, keys)]
        seen = [dict() for _ in range(n)]
        proxies = [TimedProxy(seen[i]) for i in range(n)]
        nodes = [Node(conf(i), keys[i], peers, ts[i], proxies[i])
                 for i in range(n)]
        old = {}
        submit_at = {}
        half, restarted = asyncio.Event(), asyncio.Event()
        try:
            for nd in nodes:
                nd.init()
                nd.run_task()
            t_start = time.perf_counter()

            async def submitter(i):
                for b in range(bursts):
                    if i == crash and b == bursts // 2:
                        half.set()
                        await restarted.wait()
                    for k in range(T["burst"]):
                        tx = (b"tx-%d-%05d-" % (i, b * T["burst"] + k)).ljust(
                            T["tx_bytes"], b".")
                        submit_at[tx] = time.perf_counter()
                        proxies[i].submit_tx_nowait(tx)
                    wake = t_start + (b + 1) * T["burst_every"]
                    await asyncio.sleep(max(0.0, wake - time.perf_counter()))

            async def crash_and_restart():
                await half.wait()
                nd = nodes[crash]
                await until(lambda: (proxies[crash].submit_queue.empty()
                                     and not nd.transaction_pool), 120,
                            "node 3's pool drained before the crash")
                t = time.perf_counter()
                await nd.shutdown()
                # a shutdown drops what is still pooled (no event carries
                # it); the node's client submits it again after the
                # restart, so it is still delivered exactly once
                old.update(node=nd, proxy=proxies[crash],
                           shutdown_ms=(time.perf_counter() - t) * 1e3,
                           seq=nd.core.seq, head=nd.core.head,
                           committed=len(proxies[crash].committed),
                           resubmitted=list(nd.transaction_pool))
                await asyncio.sleep(T["down_s"])
                proxies[crash] = TimedProxy(seen[crash])
                t = time.perf_counter()
                nodes[crash] = Node(conf(crash), keys[crash], peers,
                                    net.transport(f"inmem://{crash}"),
                                    proxies[crash])
                old["replay_ms"] = (time.perf_counter() - t) * 1e3
                old["replayed"] = len(nodes[crash].core.wal.recovered_events)
                core = nodes[crash].core
                if (core.seq, core.head) != (old["seq"], old["head"]):
                    raise AssertionError(
                        f"node {crash} restarted at seq {core.seq}, "
                        f"published {old['seq']}")
                if core.probing:
                    raise AssertionError("a clean close left a seq probe")
                nodes[crash].init()
                nodes[crash].run_task()
                old["restarted_at"] = time.perf_counter()
                for tx in old["resubmitted"]:
                    proxies[crash].submit_tx_nowait(tx)
                restarted.set()

            await asyncio.wait_for(asyncio.gather(
                crash_and_restart(), *(submitter(i) for i in range(n))),
                T["drain_s"])
            t_submitted = time.perf_counter()
            await until(lambda: all(len(p.committed) >= total
                                    for p in proxies), T["drain_s"],
                        f"all {total} transactions at every proxy")
            t_done = time.perf_counter()
        finally:
            for nd in nodes:
                await nd.shutdown()
        return dict(nodes=nodes, proxies=proxies, old=old, seen=seen,
                    submit_at=submit_at, t_start=t_start,
                    t_submitted=t_submitted, t_done=t_done)

    fb.sign = timed_crypto("sign", fb.sign)
    fb.verify = timed_crypto("verify", fb.verify)
    try:
        r = asyncio.run(run())
    finally:
        fb.sign, fb.verify = originals
        logger.removeHandler(counts)
        shutil.rmtree(tmp, ignore_errors=True)

    nodes, proxies, old = r["nodes"], r["proxies"], r["old"]
    order = proxies[0].committed
    want = set(r["submit_at"])
    for i, p in enumerate(proxies):
        got = p.committed
        if len(got) != total or len(set(got)) != total or set(got) != want:
            raise AssertionError(
                f"proxy {i} holds {len(got)} transactions, {len(set(got))} "
                f"distinct, {len(set(got) & want)} of the {total} submitted")
        if got != order:
            k = next(j for j, (a, b) in enumerate(zip(got, order)) if a != b)
            raise AssertionError(f"proxy {i} leaves node 0's order at {k}")
    if old["proxy"].committed != order[:len(old["proxy"].committed)]:
        raise AssertionError("node 3's proxy before the crash left the order")
    lists = [nd.core.hg.consensus_events() for nd in nodes]
    k = min(len(x) for x in lists)
    if not k or any(x[:k] != lists[0][:k] for x in lists):
        raise AssertionError("consensus_events() disagree")
    failures = {i: nd.core.insert_failures
                for i, nd in enumerate(nodes + [old["node"]])}
    if any(failures.values()):
        raise AssertionError(f"insert failures: {failures}")
    if counts.failures:
        raise AssertionError(f"{len(counts.failures)} failures logged, "
                             f"first: {counts.failures[:3]}")

    span = r["t_done"] - r["t_start"]
    lat = []
    for tx, t in r["submit_at"].items():
        node = int(tx.split(b"-")[1])
        lat.append(r["seen"][node][tx] - t)
    minted = [nd.core.seq + 1 for nd in nodes]
    print(f"[node] (b) testnet: all {total} transactions at every proxy, "
          f"each once, one order; node {crash}'s new proxy got that order "
          f"from the first ({old['committed']} had reached its old proxy); "
          f"consensus_events agree over {k}; insert failures 0; failures "
          f"logged 0", flush=True)
    print(f"[node] (b) {total / span:.0f} transactions committed/s (first "
          f"submit to the last proxy's {total}th: {span:.1f} s; submission "
          f"took {r['t_submitted'] - r['t_start']:.1f} s); submit->commit at "
          f"the submitting node p50 {pctl(lat, 0.5) * 1e3:.0f} ms, p99 "
          f"{pctl(lat, 0.99) * 1e3:.0f} ms; events minted {sum(minted)} "
          f"({minted}); {card}", flush=True)
    for i, nd in enumerate([*nodes, old["node"]]):
        reg = nd.registry
        cons = reg.get("babble_consensus_seconds")
        flush = reg.get("babble_flush_seconds")
        lat_n = flush.labels("latency").count
        thr_n = flush.labels("throughput").count
        tag = f"node {i}" if i < n else f"node {crash} before the crash"
        print(f"[node] (b) {tag}: run_consensus {cons.count} calls, mean "
              f"{cons.sum / max(cons.count, 1) * 1e3:.1f} ms, p50 "
              f"{hist_pctl(cons, 0.5)}, p99 {hist_pctl(cons, 0.99)} "
              f"(registry buckets); surfaces latency {lat_n}, throughput "
              f"{thr_n}; flush fallbacks {nd.core.hg.flush_fallbacks}; "
              f"syncs {nd.sync_requests} ({nd.sync_errors} failed), pushes "
              f"{int(reg.get('babble_push_total').value)}", flush=True)
    (n_sign, s_sign), (n_ver, s_ver) = crypto["sign"], crypto["verify"]
    print(f"[node] (b) restart of node {crash}: shutdown "
          f"{old['shutdown_ms']:.0f} ms ({len(old['resubmitted'])} pooled "
          f"transactions submitted again), WAL recovery + replay of "
          f"{old['replayed']} events into a fresh engine "
          f"{old['replay_ms']:.0f} ms; host crypto: {n_sign} signs "
          f"{s_sign:.2f} s ({s_sign / max(n_sign, 1) * 1e3:.2f} ms each), "
          f"{n_ver} verifies {s_ver:.2f} s ({s_ver / max(n_ver, 1) * 1e3:.2f} "
          f"ms each), wall per call under the GIL", flush=True)
    every = [*nodes, old["node"]]
    pulls = sum(nd.sync_requests for nd in every)
    pushes = sum(int(nd.registry.get("babble_push_total").value)
                 for nd in every)
    kinds = counts.kinds
    print(f"[node] (b) exchanges that failed, by class: pulls "
          f"{kinds.get('gossip timeout', 0)} of {pulls} timed out "
          f"({kinds.get('gossip timeout', 0) / max(pulls, 1):.1%}), "
          f"{kinds.get('gossip unreachable', 0)} unreachable; pushes "
          f"{kinds.get('push timeout', 0)} of {pushes} timed out, "
          f"{kinds.get('push unreachable', 0)} unreachable; notices "
          f"{ {k: v for k, v in kinds.items() if k in FailureLog.NOTICES} }",
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from babble_tpu_torch import cuda_build

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    logs = cuda_build.build(["la_walk"])
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in logs.items():
        print(f"[build] {name}:\n{text.strip()}", flush=True)
    kernel_resources()

    row = phase_kernel(dev)
    launches, step_ms, out, cfg, dag, ingested = phase_slice(dev, card)
    row["launches"] = launches
    print(f"[slice] la_walk share of the walk step: "
          f"{row['ms'] * launches / step_ms:.4f}", flush=True)
    phase_live(dev, card, out, cfg, dag)
    from babble_tpu_torch.ops.pallas_ingest import la_walk

    la_walk.launches = 0
    phase_engine(dev, card, out, cfg, dag)
    if la_walk.launches:
        raise AssertionError("the engine path launched la_walk")
    print("[engine] la_walk launches in the engine's flows: 0 (fd modes "
          "incremental and full)", flush=True)
    phase_block_fame(card, cfg, ingested)

    la_walk.launches = 0
    phase_churn(dev, card)
    if la_walk.launches:
        raise AssertionError("the churn flow launched la_walk")
    print("[churn] la_walk launches in phase 7: 0", flush=True)

    la_walk.launches = 0
    t0 = time.perf_counter()
    phase_node_replay(card)
    t1 = time.perf_counter()
    phase_testnet(card)
    if la_walk.launches:
        raise AssertionError("the node path launched la_walk")
    print(f"[node] la_walk launches in phase 8: 0; (a) {t1 - t0:.1f} s, "
          f"(b) {time.perf_counter() - t1:.1f} s", flush=True)

    print(card_line(), flush=True)
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
