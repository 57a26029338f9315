#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``babble_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase swallows an exception):

1. device — print the card's name and power limit (nvidia-smi); no CUDA
   device is a failure.
2. build  — compile every kernel of the main paths from ``csrc/``
   (``la_walk.cu``, ``fork_ss.cu`` and ``ss_count.cu``, one nvcc per
   source, all started together) and print ``-Xptxas -v``, then la_walk's registers and
   shared memory as the runtime sees them (static staging plus the
   dynamic int16 column), and ss_count's and fork_ss's SASS
   (``cuobjdump -sass``; fork_ss's packed and int32 kernels at K = 2):
   each kernel's instructions and its innermost loop's by opcode, per
   dp4a (one 32-bit word pair in ss_count, one word of two creators'
   OR'd results in fork_ss) in the packed kernels, per ISETP in the
   int32 ones.
3. kernel — each kernel's wrapper on the card against its plain torch
   version on the same card inputs, at the main path's shapes (the
   64 x 65,536 slice DAG), on one small DAG, at the largest size the
   walk gate admits (64 x 94,661) and on seqs that wrap int16; exact
   equality (the outputs are integers).  la_walk on column ranges (a
   rank's shard in phase 16: p = 2's halves, an odd range, the last
   column) equals those columns of the whole table, and the plain twin
   on the range; the half-width launch is timed at the slice.  Kernel time by CUDA events:
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
9. tcp   — the process around the node (``cli``, ``testnet.py``,
   ``net/tcp_transport.py``, ``proxy/``, ``service/``): the reference's
   testnet as four ``python -m babble_tpu_torch.cli run --device cuda``
   processes (heartbeat 10 ms, cache_size 50,000, tcp_timeout 200 ms, a
   WAL each with ``--wal_fsync batch(32,50)``) gossiping over loopback
   TCP on run-testnet.sh's port layout, and a ``cli dummy`` app process
   per node.  Phase 8(b)'s traffic (5,000 transactions of 64 bytes per
   node, bursts of 100 every 50 ms) goes to each node's JSON-RPC
   ``Babble.SubmitTxBatch``, once every node's /Stats answers.  After
   half its bursts, once every transaction it took in is minted (so in
   its WAL), node 3 is killed with SIGKILL and restarted from its WAL;
   its app, which keeps no snapshot of its own, is restarted with it on
   a fresh messages.txt.  Every app's messages.txt must hold each of the
   20,000 transactions once, in one order (node 3's old one a prefix of
   it).  Round 2 sends 2,000 more a node and kills node 3 again a seeded
   delay after a seeded burst of its own was admitted, whatever it is
   doing (minting, appending to its WAL); then the apps must hold one
   order with no transaction twice, round 1's first, and only node 3's
   transactions from before that kill may be missing.  No node or app
   process may exit but the killed one; each node's boot line must name
   the card; and every warning in every ``node.log`` must be a notice of
   a WAL restart or a pull that timed out (``rpc to X timed out``,
   ``dial to X timed out``, or the empty text of the peer's own error
   frame, no more of them from a peer than the handler timeouts it
   counts in ``babble_net_serve_timeouts_total``) or found its peer
   gone (``sync to X failed`` with a refused dial, a reset or an end of
   stream, or ``connection to X closed``) while that peer was down: at
   boot or after a SIGKILL, until its /Stats answered.  It prints
   transactions committed per second (first submit to the last app's
   last), submit-to-commit p50/p99 at the submitting node's app, events
   minted, each node's ``run_consensus`` calls with their p50/p99 and
   its syncs and pushes from ``/metrics`` after round 1, node 3's
   restarts and WAL replay, the failed pulls by class with the
   unreachable ones by peer and reason, how long a fifth dummy app
   takes to ack a 1 MiB commit batch under the fleet's load (the
   node-side proxy waits one second a MiB, and awaits a late ack
   instead of sending the batch again), and then what one large sync
   and one fast-forward frame cost through ``net/codec.py``.  The nodes
   run in their own processes, so la_walk's count is not visible here;
   the engine never takes the walk mode (phases 6-8).  The fleet's
   observability sweeps run against it as ``python -m
   babble_tpu_torch.cli`` processes (``fleet.py``): after round 1,
   ``testnet health --json`` must exit 0 with 4 rows, every one ``ok``,
   and no divergence; ``testnet trace`` of the last committed
   transaction must stitch its lineage from all 4 nodes; and ``fleet
   watch --once``, ``fleet scrape --rollup``, ``fleet health`` and
   ``fleet trace`` over a hosts file of ``127.0.0.1:<service port>``
   lines must give the same verdicts (the rollup with no divergence).
   While node 3 is down after its first SIGKILL, one ``testnet health``
   sweep must exit 1 naming node 3 unreachable; after its restart, a
   sweep must exit 0 again.  Each sweep's wall ms (on the card's host)
   is printed.
10. chaos — the chaos plane (``chaos/``).  (a) The deterministic
   in-memory cluster runner (``run_scenario(..., device="cuda")``: real
   ``Node``s over ``FaultyTransport``-wrapped in-memory transports, one
   gossip exchange a step, consensus every 6 steps, a logical clock) on
   every canned scenario that runs the fused engine (``CHAOS_SWEEP``: 14
   of the 15; fork-attack runs in phase 11(d)) and on the JAX package's
   mini-disk-rot, each at seeds 1 and 2 (``CHAOS_RUNS``), spread over
   ``CHAOS_WORKERS`` processes that share the card: crash
   and WAL restarts, rotten checkpoints and torn WALs, eviction past a
   dead creator and fast-forward rejoins, a forged snapshot refused on
   its proof, joins and leaves under load and partition, clock skew and
   lying timestamps (each with its drift-free twin run), stale replays,
   WAN loss models, partitions, slow peers and flaky links.  Each run's
   fingerprint (SHA-256 over the fault schedule and every node's
   committed and consensus order), committed transactions per node,
   faults by kind and invariant verdict must equal the JAX package's
   (``CHAOS_EXPECT``, made on the CPU by ``JAX_PLATFORMS=cpu python -m
   tests.test_torch_chaos_scenarios --jobs 4``); the mini-disk-rot
   fingerprints are the JAX package's committed pins.  It prints each
   run's wall time, its ``run_consensus`` calls with their p50/p99 ms
   and surfaces, and its faults.  (b) crash-restart as a live fleet:
   ``chaos.run_live`` with four ``cli run --device cuda --chaos_plan``
   processes over loopback TCP (checkpoints and a WAL each), node 3
   SIGKILLed at tick 0 and restarted at tick 340 from the plan, the tick
   stretched to ``CHAOS_LIVE["tick_seconds"]`` and a drop rate
   (``CHAOS_LIVE["drop"]``) added on every link; every node must report
   consensus on /Stats (node 3 back after its restart), every node's
   ``babble_chaos_faults_total`` must be read from ``/metrics``, the
   drops counted there must be above 0, and every node must have booted
   on the card under the plan.  la_walk's
   count stays 0.
11. byzantine — the fork-aware pair (``ops/forks.py``, its kernel
   ``csrc/fork_ss.cu``, ``ForkHashgraph``, byzantine nodes).  (b) the
   BASELINE byzantine config, ``random_byzantine_fork_batch(1024,
   100_000, seed=11, fork_rate=0.02, r_cap=16)`` as bench.py builds it,
   through ``fork_pipeline`` on the card: the counts set to 0 just
   before, fork_ss launched, la_walk not; bench's checks (events ordered
   > 0, events detecting forks > 0, max_round < r_cap - 1); every
   ``ForkOut`` field equal to a second run with the plain twin
   (``ss_counts_plain``), bit for bit.  It prints the host build, the
   first and warm runs with events ordered/s, the closure's round and
   pass counts, the fd strategy and peak device memory.  (a) fork_ss
   against its plain twin ``ss_counts_plain`` (int32, no narrowing),
   exact, one counted launch a call, at that run's two call shapes (the
   rounds closure's 1 x 131,073 x 2,048 and the fame's 16 x 2,048 x
   2,048, inputs and the batch's window rebuilt from the run's
   outputs), with ms warm and L2 cold by CUDA events of the packed
   kernel alone, the wrapper with both narrowings and with the viewer
   planes kept (as the closure's later rounds run it), the int32 kernel
   on the same call, the viewer narrowing alone, the plain ms, the
   bound (``ss_bound``) and the int32 figure, and fork_ss's share of
   the warm pipeline; then one small DAG's two shapes, and
   ``FORK_SS_CASES`` (``fork_ss_case``: windows past 2^15 with
   evicted-looking ancestors, detected creators, INF witnesses, ragged
   N, K = 1, 2, 3 and 8, every creator detected, all-INF witness rows,
   s_cap at the int16 edge) through the packed path and, without a
   window, the int32 path.  (c) ``BYZ_MID`` against the JAX package's
   counts and digest (``BYZ_EXPECT``, made on the CPU by
   ``JAX_PLATFORMS=cpu python -m tests.test_torch_forks``).  (d)
   fork-attack at seeds 1 and 2 through the deterministic runner's
   byzantine Nodes, held to ``CHAOS_EXPECT`` with the fork_detected
   invariant checked, fork_ss launched and la_walk not; then a
   ``ForkHashgraph`` on the card over ``random_byzantine_dag(
   **BYZ_ENGINE)`` equal to the JAX engine's commits
   (``BYZ_ENGINE_EXPECT``) and a checkpoint save and load of it,
   digests equal.
12. wide — the wide-N engine (``ops/wide.py``, ``ops/stream.py``, its
   kernel ``csrc/ss_count.cu``, ``WideHashgraph``, ``Core(wide=True)``).
   (a) ss_count against its plain twin ``ss_counts_compare``, exact,
   from a non-zero tally, at int8, int16 and int32, over
   ``ss_count_cases`` (ragged rows and columns with the -1 and fd_inf
   sentinels, widths off 4 and 16 bytes, rows off the 128 x 128 tile,
   stacked G = 2-4, the type's extremes on both sides, gathered rows
   and strided views), then timed at bench's config-5 block (10,000 x
   10,000 x 1,667 int8) and config 3's int32 shape (1,024 x 1,024 x
   1,024), each beside ``ss_count_bound``.  (b)
   BASELINE config 3 through ``run_wide_pipeline`` (1024 x 100,000,
   int32, as bench.py's run_wide fallback runs it), first and warm, and
   a 256 x 48,000 stream with compaction in 3 int8 blocks, both held to
   the JAX package's summaries (``WIDE_EXPECT``, made on the CPU by
   ``JAX_PLATFORMS=cpu python -m tests.test_torch_wide``).  (c)
   BASELINE config 5 (``random_gossip_arrays(10_000, 1_000_000,
   seed=7)``): bench's run_10k config refuses (its window overflows
   before lcr reaches 1; in a window that holds the stream int8 refuses
   the in-window depth; the script no longer runs either on the card,
   to make room for phase 16), so the stream runs with int16
   coordinates in a 1,000,000-event window (``WIDE10K_RUN``), every
   event ingested, evicted > 0, bad rows 0, held to ``WIDE10K_EXPECT``
   (this script's first reading); it prints events ordered, lcr,
   rounds to fame, the phase split (the rounds phase holds ss_count),
   peak memory, ss_count's launches, its ms at the run's march shape
   beside the bound and its share of the wall.  (d) four
   ``Core(wide=True)`` through a seeded replay and core 0's checkpoint
   restored on the card, held to the JAX Cores' commits and the JAX
   checkpoint's meta bytes and arrays (``WIDE_ENGINE_EXPECT``, made by
   ``JAX_PLATFORMS=cpu python -m tests.test_torch_wide_engine``).  (e)
   ss_count launched and la_walk not on every wide flow.  (b)'s config-3
   run is also held to phase 13(d)'s C++ baseline (round, witness, rr,
   cts and fame over its 100,000 events, 61,900 ordered).
13. reference — run right after phase 4: the independent references
   (``native/``, ``consensus/oracle.py``).  (a) both C++ libraries built
   by the port's loader (g++ -O3 -shared -fPIC -std=c++17, hash-named in
   ``_build/``), with their build time.  (b) the C++
   ``random_gossip_arrays`` against its pure-Python twin at 64 x 65,536
   and 1024 x 100,000 (seed 7), every field, max_chain and the level
   schedule, with both host times.  (c) BASELINE config 2: phase 4's
   walk step against ``baseline_consensus`` (``hold_to_baseline``:
   round, witness, rr exactly, cts where received, fame through every
   wslot cell), 63,340 ordered.  (d) BASELINE config 3 as bench.py's
   ``run_config`` builds it (``REF_FULL``: s_cap max(64, max_chain + 1),
   r_cap 16, "walk" where ``walk_supported`` admits it, else "fast"):
   the C++ baseline on a thread beside the device work, a first run and
   three timed runs from fresh states (median), max_round < r_cap - 1,
   held to the baseline in the same fields, 61,900 ordered; it prints
   first and warm wall, events ordered/s, the ingest/fame/order split,
   peak memory, each kernel's launches (none: n = 1,024 takes "fast"),
   the baseline's wall and events/s on the card's host and the ratio.
   (e), config 3 through the wide pipeline against the same baseline,
   is phase 12(b), which takes (d)'s baseline result.  (f)
   ``TorchHashgraph`` on the card held to ``OracleHashgraph`` on the
   host (``oracle_flow``: ``random_gossip_dag(8, 600, seed=17)``, gated,
   rolling windows, one ``run_consensus`` every 64 inserts; rounds and
   witness flags after every call, then commit order, round received,
   consensus timestamps, lcr and fame).
14. host tools — run right after phase 9: ``python -m
   babble_tpu_torch.cli lint --json babble_tpu_torch`` (babble-lint, the
   port's ``analysis/``, with the port's own format manifest) must exit
   0 with no live finding, and ``fleet conf`` must write a 4-host layout
   into a temporary directory: 4 datadirs with a key each, one shared
   ``peers.json`` against the hosts' addresses, and executable deploy
   scripts.  It prints both wall times (the card's host).
15. prewarm — the AOT prewarm (``ops/aot.py``), run before phase 16.  Each part
   runs fresh child processes on one new cache root, cold (empty) and
   then warm (the root the cold child left).  (a) fused: bench.py's
   stream child on the port (``prewarm_child_fused``: the DAG of
   ``PREWARM_STREAM``, a gated ``TorchHashgraph``, ``prewarm_engine``
   with limit 2, a flush every 8 events, then one bulk throughput
   flush), and a third child with no prewarm (a ``--no_aot_prewarm``
   boot); all commit ``PREWARM_EXPECT`` (the JAX engine's, pinned by
   ``tests/test_torch_aot.py``) and the warm child's first flush
   dispatches no unwarmed shape; it prints boot to first flush, the
   prewarm's wall and result, the first flush's wall, flush p50/p95/max
   by surface, events/s and the four counters.  (b) fork: the
   ``test_torch_aot`` child DAG (``prewarm_child_fork``), cold then
   warm: the cold child loads fork_ss at its first run, the warm one at
   boot, where it pre-sizes and launches fork_ss; its caps do not grow,
   it dispatches no cold pipeline shape, and both commit one order (the
   library itself sits in the checkout's ``_build/``, which phase 2
   filled, for both); then at config
   4's width, a ``ForkHashgraph(n=1024, k=2)`` prewarmed from a
   manifest holding phase 11(b)'s caps and schedule (``PREWARM_FORK4``),
   with its wall, fork_ss launches and peak memory.  (c) wide: phase
   12(d)'s four ``Core(wide=True)``, each engine prewarmed before the
   replay, still equal ``WIDE_ENGINE_EXPECT``; a ``WideHashgraph`` at
   config 3's width (``PREWARM_WIDE3``) prewarmed, with its wall and
   ss_count launches.  (d) phase 9's nodes prewarm at boot (the
   testnet's default, one shared cache root); phase 9 prints each
   node's spawn to /Stats and the four counters from every node's
   ``/metrics`` after node 3's last restart, and a fresh child
   (``prewarm_child_manifest``) prewarms from the fleet's manifest as
   a restarting node does, its first key and the rest timed apart.
16. mesh — the multi-device layer (``babble_tpu_torch/parallel/``), run
   last, on the one card.  Four programs, run twice (first and warm)
   in (a) and once in (b), for time: the sharded step at config 3 (phase 13(d)'s DAG and config,
   mode "fast"), the sharded walk step at config 2 (phase 4's), the
   sharded fork step on phase 11(b)'s 1024 x 100,000 batch and
   ``stream_consensus(mesh=)`` at config 3 (``MESH_STREAM``: a rolling
   window, 4 stacked blocks).  (a) one NCCL rank (``make_mesh(1)`` in a
   real process group of one): each program equals the single-device
   port (``consensus_step`` on every consensus field, ``fork_pipeline``
   on every ``ForkOut`` field, the stacked stream's ordered events, lcr
   and evictions, 61,900 ordered); the walk launches ``la_walk``, the
   fork step ``fork_ss``, the stream ``ss_count``.  (b) gloo groups of 2
   and 4 rank processes (``MESH_GROUPS``: meshes (1, 2) and (2, 2),
   every rank on cuda:0, spawned by ``parallel/dryrun.py
   spawn_ranks``): every rank's output digest of each program equals
   (a)'s, and each kernel launches on its sharded path on every rank.
   On both ranks of the 2-rank group (p = 2) the fork step's and the
   stream's run keep copies of the kernels' inputs and results, which
   are then held exactly to the plain twins at the shapes the shard
   gives them (``MeshKernelCapture``: fork_ss once a distinct shape,
   on det and the branch rows cut to the rank's creators; ss_count on
   every call, over the rank's 2 of 4 blocks).
   Per rank and program it prints the walls, the kernel launches, the
   columns each compare-count saw (N/p, B/p, or C/p blocks of w), the
   collectives' calls and bytes and the peak memory; the ranks share
   one card, so the walls are not a multi-GPU speed.

It prints the card line, then one JSON line describing every kernel,
then ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import re
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

# phase 9: the reference's testnet as processes (mpitid/babble
# docker/scripts/run-testnet.sh: 4 nodes, heartbeat 10 ms, cache_size
# 50,000, tcp_timeout 200 ms; the WAL flags testnet.py passes), one
# ``cli run --device cuda`` process and one dummy app process per node,
# over loopback TCP on run-testnet.sh's port layout; phase 8(b)'s
# traffic, submitted over JSON-RPC, and node 3 SIGKILLed after half its
# bursts and restarted from its WAL
#: phase 15(a): bench.py's stream child (``_run_stream_child``) on the
#: port, and its commit count and digest from the JAX package's engine
#: (pinned on the CPU by tests/test_torch_aot.py)
PREWARM_STREAM = dict(n=4, e=360, seed=17, every=8, limit=2)
PREWARM_EXPECT = {
    "ordered": 324,
    "digest": "25e4d5870cc188aee9282048359b7143b11598436a8d0e86c19f59db933a812d",
}
#: phase 15(b): config 4's width (phase 11(b)'s ForkConfig and schedule)
PREWARM_FORK4 = dict(n=1024, k=2, caps=(131072, 256, 16), sched=(3315, 32))
#: phase 15(c): a wide engine at config 3's width (phase 12(b)'s s_cap and
#: r_cap, a window of the whole DAG)
PREWARM_WIDE3 = dict(n=1024, e_cap=100_000, s_cap=133, r_cap=16)
#: the four series ops/aot.py keeps on a node's /metrics
AOT_SERIES = ("babble_compile_cache_hits_total",
              "babble_compile_cache_misses_total",
              "babble_xla_compiles_total", "babble_jit_traces_total")
TCP_TESTNET = dict(nodes=4, heartbeat_ms=10, cache_size=50000,
                   tcp_timeout_ms=200, txs_per_node=5000, burst=100,
                   burst_every=0.05, tx_bytes=64, crash_node=3, down_s=0.5,
                   boot_s=300.0, drain_s=300.0, base_port=12000,
                   round2_txs_per_node=2000, kill2_seed=9, settle_s=3.0,
                   probe_txs=11400, probe_every_s=2.0, trace_s=0.5)
# phase 9's codec costs: one large sync (a SyncResponse of this many
# gossip events, 64-byte transactions) and one fast-forward frame (a
# FastForwardResponse with the snapshot of an engine holding them)
CODEC_FRAME = dict(n=4, events=4096, seed=11, tx_bytes=64)

# phase 10: the chaos plane (babble_tpu_torch/chaos): the canned scenarios
# that run the fused engine (all but fork-attack, which phase 11(d) runs
# on the byzantine engine), 4 nodes each at the JAX package's step
# counts, at seeds 1 and 2, and the JAX package's mini-disk-rot
# (tests/test_chaos_scenarios.py _MINI_DISKROT) at seeds 1 and 2
CHAOS_SWEEP = [
    "clock-skew", "crash-restart", "dead-creator", "disk-rot", "flaky-link",
    "forged-snapshot", "join-under-load", "join-under-partition",
    "leave-mid-outage", "lying-ts", "minority-partition", "slow-peer",
    "stale-replay", "wan-lossy",
]
CHAOS_SEEDS = (1, 2)
#: phase 10(a)'s runs, and the processes they are dealt to in turn: the
#: runs are host-bound, and one after another they took 250-330 s
CHAOS_RUNS = [(name, seed) for name in CHAOS_SWEEP + ["mini-disk-rot"]
              for seed in CHAOS_SEEDS]
CHAOS_WORKERS = 4
# phase 11(d): the canned scenarios that run the byzantine engine
CHAOS_BYZANTINE = ["fork-attack"]
CHAOS_MINI_DISKROT = {
    "name": "mini-disk-rot", "nodes": 3, "steps": 130, "seed": 5,
    "cache_size": 1024,
    "txs": 6, "tx_every": 10, "settle_rounds": 4, "liveness_bound": 70,
    "checkpoint_every": 16,
    "invariants": ["prefix_agreement", "liveness"],
    "plan": {
        "crashes": [{"node": 2, "crash": 40, "restart": 60}],
        "disk": {"checkpoint_corrupt": 1.0, "wal_truncate": 1.0},
    },
}
# phase 10(b): crash-restart as a live fleet of cli processes over TCP;
# a tick stretched from the scenario's 0.05 s so that a node's boot on
# the card (torch import, CUDA context: 6-17 s in phase 9) fits inside
# the ticks after its restart, as the JAX package's slow live test
# stretches its tick for a CPU container; a drop rate on every link, so
# that FaultyTransport over TcpTransport injects faults the phase counts
CHAOS_LIVE = dict(scenario="crash-restart", tick_seconds=0.2, rate=25.0,
                  drop=0.05)
# each run of both sweeps under the JAX package: fingerprint (fault
# schedule, every node's committed and consensus order), committed
# transactions per node, faults by kind, invariants held; from a CPU run
# of ``JAX_PLATFORMS=cpu python -m tests.test_torch_chaos_scenarios
# --jobs 4`` (chip_reference)
CHAOS_EXPECT = {'clock-skew': {1: {'fingerprint': '7415e8d361432a754088de1b90a0a58ffcf35f944ac02456eaa54f5d8c802aff',
                    'committed': {0: 16, 1: 16, 2: 16, 3: 16},
                    'fault_counts': {'clock_skew': 4, 'drop': 10},
                    'ok': True},
                2: {'fingerprint': '7e5880eb34b02058ffd007e011d491ba4863682b1af63763a868b646cd8d1808',
                    'committed': {0: 16, 1: 16, 2: 16, 3: 16},
                    'fault_counts': {'clock_skew': 4, 'drop': 11},
                    'ok': True}},
 'crash-restart': {1: {'fingerprint': 'c863f0fa3ad78e201be58e47726dc6e16d41072bce05ce1ddcbb414956b1a0f6',
                       'committed': {0: 12, 1: 12, 2: 12, 3: 0},
                       'fault_counts': {'crash': 1, 'restart': 1},
                       'ok': True},
                   2: {'fingerprint': 'b7773cbad86a037f0ef456422e44fa170d70958a04f78aa909dfaf21400f7cac',
                       'committed': {0: 12, 1: 12, 2: 12, 3: 0},
                       'fault_counts': {'crash': 1, 'restart': 1},
                       'ok': True}},
 'dead-creator': {1: {'fingerprint': '9c8d46a537a85872ad7bdb22e4ac69e05db963ee155f8eafef09b18da0c37f93',
                      'committed': {0: 12, 1: 12, 2: 12, 3: 0},
                      'fault_counts': {'crash': 1, 'restart': 1},
                      'ok': True},
                  2: {'fingerprint': 'f2a81cb01167e1fa859c509edeae2cc9b0a6d84266def96fc85692e1a9bb9ca6',
                      'committed': {0: 12, 1: 12, 2: 12, 3: 0},
                      'fault_counts': {'crash': 1, 'restart': 1},
                      'ok': True}},
 'disk-rot': {1: {'fingerprint': 'c026c1ea5449979147fa6cd938746cc52a38b2c8781df65b8f928fcd0a0df1ab',
                  'committed': {0: 12, 1: 12, 2: 12, 3: 12},
                  'fault_counts': {'checkpoint_corrupt': 1,
                                   'crash': 1,
                                   'drop': 7,
                                   'restart': 1},
                  'ok': True},
              2: {'fingerprint': '2d2c819be263b28243ae6fa91a8ea13dc1113e5df36e2e3f50bcef040f008005',
                  'committed': {0: 12, 1: 12, 2: 12, 3: 12},
                  'fault_counts': {'checkpoint_corrupt': 1,
                                   'crash': 1,
                                   'drop': 12,
                                   'restart': 1,
                                   'wal_truncate': 1},
                  'ok': True}},
 'flaky-link': {1: {'fingerprint': '8bdd06cbb0bbaefd39a4afd745a3a5eb464baf214e437e6c8cad36eb4ac1b947',
                    'committed': {0: 20, 1: 20, 2: 20, 3: 20},
                    'fault_counts': {'delay': 44,
                                     'drop': 37,
                                     'duplicate': 16,
                                     'reorder': 25},
                    'ok': True},
                2: {'fingerprint': 'd9ddd249b25a5396354558f9da94224fb30aecbf53f330b8821bfc0b1a8469a1',
                    'committed': {0: 20, 1: 20, 2: 20, 3: 20},
                    'fault_counts': {'delay': 41,
                                     'drop': 27,
                                     'duplicate': 21,
                                     'reorder': 17},
                    'ok': True}},
 'fork-attack': {1: {'fingerprint': '78925cebb445cb71d0deefa709fdba13ba1c1aa3ef65d83e6a004a9d69aa2d5c',
                     'committed': {0: 12, 1: 12, 2: 12, 3: 12},
                     'fault_counts': {'drop': 5, 'fork_attack': 1},
                     'ok': True},
                 2: {'fingerprint': '61eadba8228b48941de11dae57734a8c53770be7b9bac3d5f4701c615cc548e6',
                     'committed': {0: 12, 1: 12, 2: 12, 3: 12},
                     'fault_counts': {'drop': 8, 'fork_attack': 1},
                     'ok': True}},
 'forged-snapshot': {1: {'fingerprint': '34cbe2f22078e13b34ee8fd89c3f491627c8287197045509d8d18da8e07cded2',
                         'committed': {0: 12, 1: 12, 2: 12, 3: 0},
                         'fault_counts': {'crash': 1,
                                          'forged_snapshot': 2,
                                          'restart': 1},
                         'ok': True},
                     2: {'fingerprint': '7c2c019f37575924db0e82c8d9a159c1e9c4e25f686c6a1f574c21a7b7f99937',
                         'committed': {0: 12, 1: 12, 2: 12, 3: 0},
                         'fault_counts': {'crash': 1,
                                          'forged_snapshot': 1,
                                          'restart': 1},
                         'ok': True}},
 'join-under-load': {1: {'fingerprint': '22f32452f8ad66185f78fc725e207c849468f0f4d1a8c71b0c8adff2685230c9',
                         'committed': {0: 26, 1: 26, 2: 26, 3: 26, 4: 26},
                         'fault_counts': {'drop': 20,
                                          'join': 1,
                                          'leave': 1},
                         'ok': True},
                     2: {'fingerprint': '1c3dad457137b70fe593ad85c692e8a720ccedbf8f69de2b5cbef32b5287c9a9',
                         'committed': {0: 26, 1: 26, 2: 26, 3: 26, 4: 26},
                         'fault_counts': {'drop': 17,
                                          'join': 1,
                                          'leave': 1},
                         'ok': True}},
 'join-under-partition': {1: {'fingerprint': '064bfa624c1f356b7287bfc7a2a03373ab806cc4ea8640b0ead7ca234fc4a314',
                              'committed': {0: 17,
                                            1: 17,
                                            2: 17,
                                            3: 17,
                                            4: 17},
                              'fault_counts': {'drop': 11,
                                               'join': 1,
                                               'partition': 50},
                              'ok': True},
                          2: {'fingerprint': '2239d1298644203db652cb0a5c441fd6e96c4b0fc528835f0c779196cf1e2386',
                              'committed': {0: 17,
                                            1: 17,
                                            2: 17,
                                            3: 17,
                                            4: 17},
                              'fault_counts': {'drop': 10,
                                               'join': 1,
                                               'partition': 51},
                              'ok': True}},
 'leave-mid-outage': {1: {'fingerprint': 'bf3ffd8c2d92865750b15dcc7c1da6269b15cdf12d3e54fa52fd47e2d9b38056',
                          'committed': {0: 17, 1: 17, 2: 17, 3: 17},
                          'fault_counts': {'crash': 1,
                                           'leave': 1,
                                           'restart': 1},
                          'ok': True},
                      2: {'fingerprint': '3801b10c3f4daa220613fe8d8811e0974ef82059e21427db911167c4c6f84a2f',
                          'committed': {0: 17, 1: 17, 2: 17, 3: 17},
                          'fault_counts': {'crash': 1,
                                           'leave': 1,
                                           'restart': 1},
                          'ok': True}},
 'lying-ts': {1: {'fingerprint': '9ef23e38a45c8c3e6a938d7e2729456d8f63afb945c288ed974ecb2b6795586c',
                  'committed': {0: 16, 1: 16, 2: 16, 3: 16},
                  'fault_counts': {'drop': 10, 'lying_ts': 27},
                  'ok': True},
              2: {'fingerprint': 'e08741edf122edb42bf53ae09ca36b2637f86cd33c2002bf6dbb5f08e1808ba1',
                  'committed': {0: 16, 1: 16, 2: 16, 3: 16},
                  'fault_counts': {'drop': 11, 'lying_ts': 30},
                  'ok': True}},
 'mini-disk-rot': {1: {'fingerprint': 'c8b4c577887e3a12d3b969afefcbfd38596afef716b136b5b3ace47ca4c6b959',
                       'committed': {0: 6, 1: 6, 2: 6},
                       'fault_counts': {'checkpoint_corrupt': 1,
                                        'crash': 1,
                                        'restart': 1,
                                        'wal_truncate': 1},
                       'ok': True},
                   2: {'fingerprint': '28b549da395d0dff11449b6eac6c562a98d1e5769d8e7bf691c23153ad0cf1df',
                       'committed': {0: 6, 1: 6, 2: 6},
                       'fault_counts': {'checkpoint_corrupt': 1,
                                        'crash': 1,
                                        'restart': 1,
                                        'wal_truncate': 1},
                       'ok': True}},
 'minority-partition': {1: {'fingerprint': 'd07d43189fc7e534406b487f6b0f0355ed4b01903d4ff43c0d8f57b608f9a7e5',
                            'committed': {0: 16, 1: 16, 2: 16, 3: 16},
                            'fault_counts': {'drop': 10, 'partition': 54},
                            'ok': True},
                        2: {'fingerprint': 'b9d080a926cdaa848eebd179564c09e68f189cddeeceaba12d08d9d8dbec561a',
                            'committed': {0: 16, 1: 16, 2: 16, 3: 16},
                            'fault_counts': {'drop': 12, 'partition': 57},
                            'ok': True}},
 'slow-peer': {1: {'fingerprint': '535999092a57cec6eeef0333f907f0fd1e3d233d7b58cecbd373c3634c501d3f',
                   'committed': {0: 16, 1: 16, 2: 16, 3: 16},
                   'fault_counts': {'delay': 109, 'drop': 6},
                   'ok': True},
               2: {'fingerprint': '30e4e86fb31b6e96ba8409040950c19102487c05a75831f8e3ad481bea28a492',
                   'committed': {0: 16, 1: 16, 2: 16, 3: 16},
                   'fault_counts': {'delay': 111, 'drop': 8},
                   'ok': True}},
 'stale-replay': {1: {'fingerprint': '181955537bb98b43323a4ced5c117abea497eef339ca6ba139e2c0d835bdf6b7',
                      'committed': {0: 16, 1: 16, 2: 16, 3: 16},
                      'fault_counts': {'drop': 9, 'stale_replay': 29},
                      'ok': True},
                  2: {'fingerprint': '68a7226a632b959f0444767870b6fcd7bc7def2c2a641f9bf7abca510b6de63e',
                      'committed': {0: 16, 1: 16, 2: 16, 3: 16},
                      'fault_counts': {'drop': 10, 'stale_replay': 24},
                      'ok': True}},
 'wan-lossy': {1: {'fingerprint': '6d6554caa008c4a95cd02b8ea907904a04bdbfa49cc63f2bd8766e6aacdf28cd',
                   'committed': {0: 16, 1: 16, 2: 16, 3: 16},
                   'fault_counts': {'bw_delay': 254,
                                    'delay': 44,
                                    'ge_drop': 26},
                   'ok': True},
               2: {'fingerprint': 'f687b6bd3dba9c82734d1de891f98f0f52df17b3e048aecf88b0297e535fb84a',
                   'committed': {0: 16, 1: 16, 2: 16, 3: 16},
                   'fault_counts': {'bw_delay': 223,
                                    'delay': 35,
                                    'ge_drop': 57},
                   'ok': True}}}

# phase 11: the byzantine pair (ops/forks.py, the fork_ss kernel, the
# fork engine and byzantine nodes).  (b) BASELINE.json's second config,
# "1024-node DAG with 1/3 byzantine forks", as bench.py's run_byzantine
# builds it: nothing cut
BYZ_FULL = dict(n=1024, e=100_000, seed=11, fork_rate=0.02, r_cap=16)
# (c) a mid-size batch the JAX pipeline finishes on a CPU, and its
# counts and SHA-256 over round, witness, famous, rr and cts (byz_summary)
# from ``JAX_PLATFORMS=cpu python -m tests.test_torch_forks``
BYZ_MID = dict(n=128, e=16384, seed=11, fork_rate=0.02)
BYZ_EXPECT = {
    "max_round": 8, "lcr": 6, "ordered": 8764, "detecting": 15361,
    "digest": "8c212408d3f2ac4c986084ea78dd7fd0e62d757aa808da73a22a1b64b2ade923",
}
# (d) a byzantine engine for the checkpoint round trip, and the JAX
# ForkHashgraph's commits over the same DAG
# (tests/test_torch_forks.py test_chip_smokes_engine_expectation)
BYZ_ENGINE = dict(n=32, n_events=4000, seed=5, fork_rate=0.05)
BYZ_ENGINE_EXPECT = {
    "commit_length": 2797, "lcr": 10,
    "commit_digest":
        "1f54707866494609ee01dd5474f733fbda235618e56882b92ce8ccef2c027189",
}
# (a) one small DAG, and fork_ss_case's inputs: ragged tiles (X, W
# and N off the tiles and the 8-creator planes; K = 1, 3 and 8 as well
# as 2) and the edges: (name, g, x, w, n, k, fork_ss_case options)
BYZ_SMALL = dict(n=32, e=2048, seed=11, fork_rate=0.02)
FORK_SS_CASES = [
    ("ragged k=3", 3, 1000, 77, 37, 3, {}),
    ("ragged k=2", 2, 4097, 130, 1025, 2, {}),
    ("ragged k=8", 1, 65, 63, 9, 8, {}),
    ("ragged k=1", 2, 300, 129, 13, 1, {}),
    ("every creator detected", 1, 200, 140, 20, 2, dict(det_rate=1.0)),
    ("all-INF witness rows", 2, 150, 90, 11, 2, dict(inf_rate=1.0)),
    ("s_cap at the int16 edge", 1, 257, 131, 33, 2, dict(s_cap="edge")),
]

# phase 12: the wide-N pipeline (ops/wide.py, ops/stream.py, the
# ss_count kernel, WideHashgraph).  (b) BASELINE config 3 through the
# wide pipeline, as bench.py's run_wide runs its fallback (1024 x 100k,
# s_cap = max_chain + 3, r_cap 16, int32, one block), and a mid-size
# stream the JAX package finishes on a CPU (compaction engaged, C = 3,
# int8): their summaries (pipeline_summary, stream_summary) from
# ``JAX_PLATFORMS=cpu python -m tests.test_torch_wide``
WIDE_FULL = dict(n=1024, e=100_000, seed=7, r_cap=16)
WIDE_STREAM = dict(
    n=256, e=48_000, seed=7,
    cfg=dict(n=256, e_cap=24_000, s_cap=110, r_cap=16, coord8=True),
    run=dict(batch_events=4000, n_blocks=3, round_margin=0, seq_window=16,
             compact_min=1024),
)
WIDE_EXPECT = {
    "full": {"ordered": 61900, "lcr": 4, "max_round": 6, "digest":
             "642f345fe96cb0caf00fc22094c5c6ce2b58ff8e4963c7426f4b108e88c6fa50"},
    "stream": {"ordered": 37684, "lcr": 11, "max_round": 13,
               "evicted": 36404, "digest":
               "f255ffb2582fc60f9d150f3d685d331cdf7d154b1011f63f8983ba47b776afd1"},
}
# (c) BASELINE config 5, "10k-node / 1M-event", as bench.py's run_10k
# builds it (the tuple path).  That config cannot order the stream on
# any platform: lcr first reaches 1 at 640,000 events, past its 620,000
# window, and int8 cannot hold the in-window chain depth (127 at 800,000
# events once the window is large enough; coord8 needs s_cap < 120).
# Phase 12(c) runs the nearest config that orders the whole stream: int16 coordinates, s_cap max_chain + 3 (as
# bench.py's run_wide sizes it) and a window that holds the stream,
# every other knob bench's.  No platform holds an ordering for it, so
# WIDE10K_EXPECT is this script's own first reading on the card.
WIDE10K = dict(
    n=10_000, e=1_000_000, seed=7,
    cfg=dict(n=10_000, e_cap=620_000, s_cap=110, r_cap=16, coord8=True),
    run=dict(batch_events=160_000, round_margin=0, seq_window=48,
             compact_min=4096),
)
# (a) bench's config-5 block for ss_count: 10,000 rows a side, 1,667 int8
# columns (6 blocks of the 10,000-wide, 620,000-event window)
WIDE_INT8_BLOCK = (10_000, 1667)
WIDE10K_RUN = dict(e_cap=1_000_000, coord8=False, coord16=True)
WIDE10K_EXPECT = {
    "ordered": 129275, "lcr": 1, "max_round": 4, "evicted": 52684,
    "digest": "03d878f516bd95b7344bb1f096c4495d6ddd78b8bc0034527e411bd88b7b486d",
}
# (d) four Core(wide=True) nodes through sim/replay.py's seeded sync
# schedule, and a checkpoint of one: the JAX Cores' commits and the
# checkpoint's meta bytes and arrays (wide_engine_summary), from
# ``JAX_PLATFORMS=cpu python -m tests.test_torch_wide_engine``
WIDE_ENGINE = dict(n=4, syncs=600, seed=11, cache_size=256,
                   wide_caps=(2048, 128, 32))
WIDE_ENGINE_EXPECT = {
    "commit_length": [573, 573, 573, 573],
    "commit_digest": [
        "346cc05f3b9758609628d952131652ea2b1d639de7a2d146970fac740f596816"] * 4,
    "lcr": [43, 43, 43, 43], "evicted": 313,
    "meta_sha256":
        "db59a8b4482bc0bd9e6bbd033a255fa22f66d974eb36dde03888214df5def8cb",
    "npz_sha256":
        "c4b11d3fa601e5ba4fb497c9828c2850d23a371615303c879913354b2b9bef7e",
}

# phase 13: the independent references (native/, consensus/oracle.py).
# REF_FULL is BASELINE config 3 as bench.py's run_config builds its
# headline (CONFIGS[0]: s_cap max(64, max_chain + 1), r_cap 16, the
# "walk" mode where walk_supported admits it, else "fast"; three timed
# runs after the first).  REF_EXPECT: the C++ baseline's ordered counts
# for the two seed-7 DAGs (the JAX package's native/baseline_consensus.cpp
# on a CPU; BENCH_r02.json holds the same two counts).
REF_FULL = dict(n=1024, e=100_000, seed=7, s_cap_min=64, r_cap=16,
                repeats=3)
REF_EXPECT = {"slice": 63340, "full": 61900}

# phase 16: the multi-device layer (parallel/) on the one card.  (a) one
# NCCL rank; (b) gloo groups of MESH_GROUPS (ranks, mesh shape), every
# rank on cuda:0 (p = 2 in both).  The stream is config 3's DAG through
# a rolling window in 4 stacked blocks (C/p blocks a rank).
MESH_GROUPS = ((2, (1, 2)), (4, (2, 2)))
#: the group whose ranks also hold fork_ss and ss_count to their plain
#: twins on the shard (``mesh_kernel_check``)
MESH_CHECKED = 2
MESH_STREAM = dict(batch_events=25_000, n_blocks=4, round_margin=0,
                   seq_window=16, compact_min=4096)
# (f): the engine on the card held to OracleHashgraph on README.md's
# engine flow (gated, rolling windows)
REF_ORACLE = dict(n=8, e=600, seed=17, every=64,
                  engine=dict(e_cap=128, auto_compact=True, seq_window=32,
                              finality_gate=True))
ARRAY_FIELDS = ("sp", "op", "creator", "seq", "ts", "mbit", "levels")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor f32 ops/s
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# integer rates for fork_ss' and ss_count's bounds, 132 SMs at 1.98 GHz
# boost.  The CUDA C++ Programming Guide's throughput table gives
# compute capability 9.0
# 64 results a clock an SM for 32-bit integer compare and for 32-bit
# integer multiply-add; Nsight Compute's pipe list puts the compares
# (ISETP) on the ALU pipe and IMAD on the FMA pipe, so the two can run
# side by side, and the four warp schedulers issue at most 128 lane
# operations a clock an SM.  The table's f32 rate is twice the first.
PEAK_INT32_OPS_S = 132 * 64 * 1.98e9      # ALU pipe: compares
PEAK_IMAD_OPS_S = 132 * 64 * 1.98e9       # FMA pipe: IMAD accumulations
PEAK_ISSUE_OPS_S = 132 * 128 * 1.98e9     # all lane operations issued


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
    walk_ranges(dev)
    return row


def walk_ranges(dev) -> None:
    """la_walk on a column range (a rank's shard, phase 16): exact against
    the same columns of the whole table (held to the plain twin above)
    at the slice, including p = 2's halves, and against the plain twin
    on the range at the small and wrapped shapes; the half-width launch
    timed at the slice."""
    import torch

    from babble_tpu_torch.ops.pallas_ingest import la_walk, la_walk_plain

    for name, shape in (("small", SMALL), ("slice", SLICE), ("wrap", WRAP)):
        if "seq_base" in shape:
            args = synthetic_inputs(shape, dev)
        else:
            args = walk_inputs(shape["n"], shape["e"], shape["seed"], dev)
        n = args[6]
        whole = la_walk(*args)
        ranges = ((0, n // 2), (n // 2, n - n // 2), (n // 3, n // 4 or 1),
                  (n - 1, 1))
        for c0, w in ranges:
            got = la_walk(*args, c0, w)
            if not torch.equal(got, whole[:, c0:c0 + w]):
                raise AssertionError(f"la_walk columns [{c0}, {c0 + w}) != "
                                     f"the whole table's ({name})")
            if name != "slice" and not torch.equal(
                    got, la_walk_plain(*args, c0, w)):
                raise AssertionError(f"la_walk columns [{c0}, {c0 + w}) != "
                                     f"la_walk_plain's ({name})")
        line = f"[kernel] la_walk {name} column ranges {ranges}: exact"
        if name == "slice":
            half = cuda_ms(lambda: la_walk(*args, 0, n // 2), reps=10)
            line += (f"; columns [0, {n // 2}) {half:.4f} ms warm (CUDA "
                     f"events, mean of 10)")
        print(line, flush=True)


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


def sass_listing(lib_path: str, match: str = "", dump: str = "") -> dict:
    """The SASS of every kernel in a built library whose mangled name
    holds ``match``, by ``cuobjdump -sass`` (the CUDA toolkit's, beside
    nvcc): {kernel: [(address, opcode, branch target or None)]}, the
    opcode without its modifiers but IMAD's first (IMAD.IADD, IMAD.MOV,
    ... run as IMAD on the FMA pipe).  With ``dump``, the whole listing
    is also written to that file."""
    import os

    from babble_tpu_torch import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    if dump:
        with open(dump, "w") as f:
            f.write(text)
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if match in m.group(1) else None
            if name:
                out[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)(?:\s+(0x[0-9a-f]+))?", line)
        if name and m:
            op = m.group(2)
            op = ".".join(op.split(".")[:2 if op.startswith("IMAD") else 1])
            target = int(m.group(3), 16) if op == "BRA" and m.group(3) \
                else None
            out[name].append((int(m.group(1), 16), op, target))
    return out


def _counts(ins) -> dict:
    ops = {}
    for _, op, _ in ins:
        ops[op] = ops.get(op, 0) + 1
    return ops


def kernel_sass(lib_path: str, match: str, label: str) -> None:
    """Prints, for each kernel of ``lib_path`` matching ``match``, its
    instruction count and its compare loop: the backward branch's body
    densest in the compare-count's own instruction (IDP, the dp4a of one
    32-bit word pair, in the packed kernels; else ISETP, one pair), by
    opcode and per that instruction, split by pipe (ALU: LOP3, IADD3,
    ISETP, LEA, SHF, SEL; FMA: IMAD*, IDP; VIADD, Hopper's add of an
    immediate, neither)."""
    keys = ("LOP3", "IADD3", "IMAD", "IMAD.IADD", "IMAD.MOV", "VIADD",
            "IDP", "ISETP", "LEA", "SHF", "LDS", "STS", "LDG", "BAR",
            "BRA")
    for name, ins in sass_listing(lib_path, match).items():
        key = "IDP" if any(op == "IDP" for _, op, _ in ins) else "ISETP"
        loops = [[x for x in ins if t <= x[0] <= at]
                 for at, op, t in ins if t is not None and t < at]
        hot = max(loops, key=lambda body: _counts(body).get(key, 0)
                  / len(body), default=[])
        ops = _counts(hot)
        line = ", ".join(f"{k} {ops[k]}" for k in keys if ops.get(k))
        per = ""
        if ops.get(key):
            alu = sum(ops.get(k, 0) for k in ("LOP3", "IADD3", "ISETP",
                                              "LEA", "SHF", "SEL"))
            fma = sum(v for k, v in ops.items()
                      if k.startswith("IMAD") or k == "IDP")
            per = (f"; per {key}: {len(hot) / ops[key]:.3f} instructions, "
                   f"ALU pipe {alu / ops[key]:.3f}, FMA pipe "
                   f"{fma / ops[key]:.3f}, LDS "
                   f"{ops.get('LDS', 0) / ops[key]:.3f}")
        print(f"[build] {label} SASS {name[:64]}: {len(ins)} instructions; "
              f"compare loop {len(hot)}: {line}{per}", flush=True)


def ss_count_turns(other: str, card: str) -> dict:
    """ss_count against another source of it (``other``, a former
    version of ``csrc/ss_count.cu`` with the same C interface for rows
    with any row stride), built here with the same nvcc flags, timed in
    turns on this card: other, this, this, other, at the 10k run's march
    shape (10,000 x 10,000 x 527 int16), bench's config-5 block (10,000
    x 10,000 x 1,667 int8) and config 3's int32 shape (1,024 x 1,024 x
    1,024); seeded rows with the -1 floor and the fd_inf sentinel.  The
    two versions must agree exactly.  ``this`` is the wrapper
    ``ss_counts_acc``, its row padding included.  Prints and returns
    each version's ms warm and L2 cold (CUDA events, means of 5 and 3)
    and the share of the bound."""
    import ctypes
    import os
    import tempfile

    import torch

    from babble_tpu_torch import cuda_build
    from babble_tpu_torch.ops.ss import ss_counts_acc

    lib = os.path.join(tempfile.mkdtemp(), "libss_count_other.so")
    built = subprocess.run(
        [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, other],
        capture_output=True, text=True, timeout=600)
    if built.returncode != 0:
        raise RuntimeError(f"building {other} failed:\n{built.stdout}"
                           f"{built.stderr}")
    print(f"[turns] built {other}:\n{(built.stdout + built.stderr).strip()}",
          flush=True)
    kernel_sass(lib, "ss_count", "other")
    fn = ctypes.CDLL(lib).ss_count_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run_other(a, b, acc):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), acc.data_ptr(), a.shape[0],
                b.shape[0], a.shape[1], 1, a.stride(0), b.stride(0), 0, 0,
                a.element_size(), stream)
        if rc:
            raise RuntimeError(f"the other ss_count failed: {rc}")
        return acc

    gen = torch.Generator().manual_seed(12)
    out = {}
    for label, rows, w, dt, top in (
            ("10k march shape", 10_000, 527, torch.int16, 142),
            ("config-5 int8 block", 10_000, 1667, torch.int8, 100),
            ("config-3 int32 shape", 1024, 1024, torch.int32, 133)):
        inf = torch.iinfo(dt).max
        a = torch.randint(-1, top, (rows, w), generator=gen).to(dt).cuda()
        b = torch.randint(-1, top + 20, (rows, w), generator=gen)
        b[b >= top] = inf
        b = b.to(dt).cuda()
        zero = torch.zeros((rows, rows), dtype=torch.int32, device="cuda")
        want = run_other(a, b, zero.clone())
        got = ss_counts_acc(a, b, zero.clone())
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"ss_count != the other version at {label}")
        bound, _ = ss_count_bound(1, rows, rows, w, a.element_size())
        acc = zero.clone()
        times = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            f = (lambda: run_other(a, b, acc)) if who == "other" else \
                (lambda: ss_counts_acc(a, b, acc))
            times[who].append((cuda_ms(f, reps=5), cuda_ms_cold(f, reps=3)))
        out[label] = dict(times, bound_ms=bound)
        fmt = lambda ts: "; ".join(f"{w_:.3f} warm / {c_:.3f} cold"
                                   for w_, c_ in ts)
        print(f"[turns] {label} ({dt}, {rows} x {rows} x {w}): other "
              f"{fmt(times['other'])}; this {fmt(times['this'])}; bound "
              f"{bound:.3f} ms, bound / warm: other "
              f"{bound / min(t[0] for t in times['other']):.3f}, this "
              f"{bound / min(t[0] for t in times['this']):.3f}; {card}",
              flush=True)
        del a, b, zero, acc, want, got
    return out


def step_phases(cfg, mode: str, batch, dev):
    """The batch step's phases one after another on a fresh state, each
    synchronised: (wall ms by phase, the state after the rounds phase,
    the final state)."""
    from babble_tpu_torch import init_state
    from babble_tpu_torch.ops import fame, ingest, order

    st = init_state(cfg, device=dev)
    phases = {}
    for name, fn in (
        ("ingest_coords", lambda s: ingest.ingest_coords_impl(cfg, s, mode, batch)),
        ("ingest_rounds", lambda s: ingest.ingest_rounds_impl(cfg, s, mode, batch)),
        ("fame", lambda s: fame.decide_fame_auto_impl(cfg, s)),
        ("order", lambda s: order.decide_order_impl(cfg, s)),
    ):
        box = {}
        phases[name] = wall_ms(lambda: box.setdefault("s", fn(st)))
        st = box["s"]
        if name == "ingest_rounds":
            ingested = st
    return phases, ingested, st


def phase_slice(dev, card: str):
    """Drive the main path; returns (la_walk's launch count in that run,
    the run's wall ms)."""
    import torch

    from babble_tpu_torch import (
        DagConfig, assert_consensus_parity, batch_from_arrays,
        consensus_step, init_state, random_gossip_arrays,
    )
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

    phases, ingested, st = step_phases(cfg, "walk", batch, dev)
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


class NodeLogCheck:
    """Sorts what a testnet node process logged (``node.log``, the
    logger's ``asctime levelname name message`` lines at ``--log_level
    warning``).  A pull that failed is read by the TCP transport's text.
    A timeout (``rpc to X timed out after Ys``, ``dial to X timed out``)
    is counted for any peer.  An empty text is the peer's error frame
    when its own handler outlived ``tcp_timeout`` (asyncio's empty
    ``TimeoutError`` text, ``tcp_transport.py _serve_rpc``); the pulls
    that read it from a peer may not outnumber that peer's
    ``babble_net_serve_timeouts_total`` (``check_peer_timeouts``).  A
    peer that is gone (``sync to X failed: <reason>``, ``connection to X
    closed``) is counted only while X was down (``down``: gossip address
    -> wall-clock spans, from the fleet's start or X's SIGKILL to X's
    /Stats answering, plus ``SLACK`` seconds of logging lag), and only
    for a refused dial, a reset, or an end of stream.  The notices of a WAL
    restart are counted.  Every other warning or error, and any
    traceback, is a failure.  (A failed push is logged at DEBUG, so it is
    not in the log; ``/metrics`` counts them.)"""

    LINE = re.compile(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d),(\d+) "
                      r"(DEBUG|INFO|WARNING|ERROR|CRITICAL) \S+ (.*)$")
    PULL = re.compile(r"^gossip to (\S+) failed: (.*)$")
    TIMEOUTS = ("rpc to ", "dial to ")
    GONE = re.compile(r"^(?:sync to (\S+) failed: (.*)|connection to (\S+) "
                      r"closed)$")
    REASONS = (("Connect call failed", "refused"),
               ("Connection refused", "refused"),
               ("Connection reset by peer", "reset"),
               ("Broken pipe", "reset"),
               # asyncio's ConnectionResetError from drain(): the write
               # found the connection already lost under it
               ("Connection lost", "reset"),
               ("bytes read on a total of", "end of stream"),
               ("connection closed", "end of stream"))
    NOTICES = ("WAL missing or truncated", "seq probe complete")
    SLACK = 2.0

    def __init__(self, down=None):
        self.down = down or {}
        self.kinds = {}
        self.failures = []
        #: target -> pulls that read the peer's empty timeout text
        self.peer_timeouts = {}
        #: (target, reason) -> pulls that found the target gone
        self.gone = {}

    def count(self, kind):
        self.kinds[kind] = self.kinds.get(kind, 0) + 1

    def _gone_reason(self, target: str, why: str, at: float):
        m = self.GONE.match(why)
        if m is None or (m.group(1) or m.group(3)) != target:
            return None
        if not any(t0 <= at <= t1 + self.SLACK
                   for t0, t1 in self.down.get(target, ())):
            return None
        if m.group(3):
            return "closed"
        return next((r for p, r in self.REASONS if p in m.group(2)), None)

    def read(self, i: int, text: str) -> None:
        for line in text.splitlines():
            if line.startswith("Traceback"):
                self.failures.append(f"node {i}: {line}")
                continue
            m = self.LINE.match(line)
            if m is None or m.group(3) in ("DEBUG", "INFO"):
                continue
            at = time.mktime(time.strptime(m.group(1), "%Y-%m-%d %H:%M:%S")) \
                + int(m.group(2)) / 1000
            msg = m.group(4)
            pull = self.PULL.match(msg)
            notice = next((n for n in self.NOTICES if msg.startswith(n)),
                          None)
            if pull and pull.group(2) == "":
                target = pull.group(1)
                self.peer_timeouts[target] = \
                    self.peer_timeouts.get(target, 0) + 1
                self.count("pull timeout (peer)")
            elif pull and pull.group(2).startswith(self.TIMEOUTS):
                self.count("pull timeout")
            elif pull and self._gone_reason(*pull.groups(), at):
                key = (pull.group(1), self._gone_reason(*pull.groups(), at))
                self.gone[key] = self.gone.get(key, 0) + 1
                self.count("pull unreachable")
            elif notice:
                self.count(notice)
            else:
                self.failures.append(f"node {i}: {line}")

    def check_peer_timeouts(self, served: dict) -> None:
        """``served``: gossip address -> the peer's own count of handler
        timeouts, summed over its lifetimes."""
        for target, n in sorted(self.peer_timeouts.items()):
            if n > served.get(target, 0):
                self.failures.append(
                    f"{n} pulls read an empty error text from {target}, "
                    f"which counts {served.get(target, 0):.0f} handler "
                    "timeouts")


def scrape(text: str) -> dict:
    """Prometheus text -> {series name with labels: value}."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def scraped_pctl(m: dict, name: str, q: float) -> str:
    """The upper bound of the bucket holding quantile ``q`` of a scraped
    histogram."""
    count = m.get(f"{name}_count", 0.0)
    if not count:
        return "-"
    buckets = sorted(
        (float("inf") if k.split('le="')[1][:-2] == "+Inf"
         else float(k.split('le="')[1][:-2]), v)
        for k, v in m.items() if k.startswith(f"{name}_bucket{{"))
    for bound, cum in buckets:
        if cum >= q * count:
            return f"<= {bound * 1e3:g} ms" if bound != float("inf") else \
                "> 60 s"
    return "-"


def trace_busy(path: str) -> dict:
    """A ``torch.profiler`` Chrome trace (``trace.json``) -> its device
    activities (kernels, copies, sets), the union of their spans (busy)
    and the span of every recorded event (window), in ms."""
    with open(path) as f:
        text = f.read()
    events = [e for e in json.loads(text).get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for t0, t1 in device:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    window = (max(float(e["ts"]) + float(e["dur"]) for e in events)
              - min(float(e["ts"]) for e in events)) if events else 0.0
    return {"events": len(events), "device": len(device),
            "busy_ms": busy / 1e3,
            "window_ms": window / 1e3, "mb": len(text) / 1e6}


def codec_costs(device) -> None:
    """Phase 9's codec line: one large sync and one fast-forward frame
    through ``net/codec.py`` (both past the 64 KB gate, so on the codec
    thread), with the event loop's longest stall while each decodes."""
    import asyncio

    from babble_tpu_torch.consensus.engine import TorchHashgraph
    from babble_tpu_torch.core.dag import HostDag
    from babble_tpu_torch.net import codec
    from babble_tpu_torch.net.commands import (
        FastForwardResponse, SyncResponse)
    from babble_tpu_torch.sim.generator import random_gossip_dag
    from babble_tpu_torch.store.checkpoint import snapshot_bytes

    c = CODEC_FRAME
    g = random_gossip_dag(c["n"], c["events"], seed=c["seed"],
                          tx_bytes=c["tx_bytes"])
    dag = HostDag(dict(g.participants), verify_signatures=False)
    for ev in g.events:
        dag.insert(ev)
    sync = SyncResponse("127.0.0.1:12000", g.events[-1].hex(),
                        [dag.to_wire(e) for e in g.events], {})
    eng = TorchHashgraph(dict(g.participants), verify_signatures=False,
                         device=device)
    for ev in g.events:
        eng.insert_event(ev)
    eng.run_consensus()
    ff = FastForwardResponse("127.0.0.1:12000", snapshot_bytes(eng),
                             lcr=eng.last_consensus_round)

    async def measure(msg):
        loop = asyncio.get_running_loop()
        gap, stop = [0.0], [False]

        async def tick():
            t = loop.time()
            while not stop[0]:
                await asyncio.sleep(0.001)
                now = loop.time()
                gap[0] = max(gap[0], now - t)
                t = now

        ticker = asyncio.ensure_future(tick())
        await asyncio.sleep(0.01)
        t0 = time.perf_counter()
        body = await codec.encode_frame(msg)
        t1 = time.perf_counter()
        back = await codec.decode_frame(type(msg), body)
        t2 = time.perf_counter()
        stop[0] = True
        await ticker
        if back.pack() != body:
            raise AssertionError(f"{type(msg).__name__} does not round-trip")
        return len(body), (t1 - t0) * 1e3, (t2 - t1) * 1e3, gap[0] * 1e3

    for name, msg in (("large sync", sync), ("fast-forward frame", ff)):
        size, enc, dec, gap = asyncio.run(measure(msg))
        print(f"[tcp] codec: {name} ({type(msg).__name__}, "
              f"{len(sync.events)} events) {size / 1e6:.3f} MB: encode "
              f"{enc:.1f} ms, decode {dec:.1f} ms on the codec thread; the "
              f"event loop's longest stall meanwhile {gap:.1f} ms",
              flush=True)


def phase_tcp_testnet(card: str, device="cuda") -> str:
    """Phase 9: the reference's testnet as four ``cli run`` processes
    over TCP, node 3 SIGKILLed and restarted from its WAL twice: once
    with every transaction it took in minted, once at a seeded moment
    (module docstring).  Returns a directory holding a copy of the
    fleet's shape manifest (phase 15(d) prewarms from it)."""
    import asyncio
    import os
    import random
    import shutil
    import socket
    import tempfile
    import threading
    import urllib.request

    from babble_tpu_torch import testnet as tn
    from babble_tpu_torch.net.peers import JSONPeers
    from babble_tpu_torch.proxy.admission import OverloadedError
    from babble_tpu_torch.proxy.jsonrpc import JsonRpcClient, b64e
    from babble_tpu_torch.wal import WriteAheadLog

    T = TCP_TESTNET
    n, crash = T["nodes"], T["crash_node"]
    bursts, bursts2 = (T["txs_per_node"] // T["burst"],
                       T["round2_txs_per_node"] // T["burst"])
    total = n * T["txs_per_node"]
    base = T["base_port"]
    ports = tn.PortLayout(base, base + 1000, base + 2000, base + 3000)
    crash_addr = ports.of(crash)["gossip"]
    tmp = tempfile.mkdtemp(prefix="babble-tcp-testnet-")
    runner = tn.TestnetRunner(
        tmp, n, heartbeat_ms=T["heartbeat_ms"], cache_size=T["cache_size"],
        tcp_timeout_ms=T["tcp_timeout_ms"], ports=ports, wal=True,
        device=device)
    ddir = [os.path.join(tmp, f"node{i}") for i in range(n)]
    logs = [os.path.join(d, "messages.txt") for d in ddir]
    # node 3's apps before each kill (an app keeps no snapshot, so it is
    # restarted with its node on a fresh messages.txt)
    befores = [os.path.join(ddir[crash], f"messages-before-kill{k}.txt")
               for k in (1, 2)]
    rng = random.Random(T["kill2_seed"])
    kill2_burst = rng.randrange(1, bursts2)
    kill2_delay = rng.uniform(0.0, T["burst_every"])

    # when each transaction first shows in each app's log (node 3's
    # across its apps) and how many lines each log holds, read every
    # 50 ms from the files the dummy processes append to
    seen = [dict() for _ in range(n)]
    offsets, nlines, full_at = {}, {}, {}
    done = threading.Event()
    tail_lock = threading.Lock()

    def tail_once():
        with tail_lock:
            _tail_once()

    def _tail_once():
        now = time.perf_counter()
        for i, path in enumerate(logs):
            try:
                with open(path, "rb") as f:
                    f.seek(offsets.get(path, 0))
                    chunk = f.read()
            except FileNotFoundError:
                continue
            cut = chunk.rfind(b"\n") + 1
            offsets[path] = offsets.get(path, 0) + cut
            got = chunk[:cut].splitlines()
            for tx in got:
                seen[i].setdefault(tx, now)
            nlines[path] = nlines.get(path, 0) + len(got)
            if nlines[path] >= total:
                full_at.setdefault(path, now)

    def tailer():
        while not done.wait(0.05):
            tail_once()

    def lines(path):
        if not os.path.exists(path):
            return []
        with open(path, "rb") as f:
            return f.read().splitlines()

    def metrics(i):
        return scrape(tn.fetch_metrics(ports.of(i)["service"]))

    # the fleet's observability sweeps (fleet.py), each a `cli` process
    hosts_file = os.path.join(tmp, "hosts.txt")
    with open(hosts_file, "w") as f:
        f.writelines(f"{ports.of(i)['service']}\n" for i in range(n))
    sweep_ms = []

    def verb(*argv):
        """One verb of the port's cli in its own process, timed."""
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "babble_tpu_torch.cli", *argv],
            env=runner._env(), capture_output=True, text=True, timeout=120)
        ms = (time.perf_counter() - t) * 1e3
        sweep_ms.append(ms)
        print(f"[tcp] sweep `{' '.join(argv[:2])}`: exit "
              f"{proc.returncode}, {ms:.1f} ms host wall",
              flush=True)
        return proc

    def health(*via):
        """One health sweep, ``testnet health`` unless ``via`` names the
        fleet form: (exit code, the JSON document)."""
        argv = via or ("testnet", "health", "--n", str(n), "--base_port",
                       str(base))
        proc = verb(*argv, "--json")
        return proc.returncode, json.loads(proc.stdout)

    def all_ok(doc):
        return (len(doc["nodes"]) == n and not doc["divergence"]
                and all(r.get("health", {}).get("status") == "ok"
                        for r in doc["nodes"]))

    def health_until_ok(what):
        t0 = time.monotonic()
        while True:
            rc, doc = health()
            if rc == 0 and all_ok(doc):
                return time.monotonic() - t0
            if time.monotonic() - t0 > 120:
                raise AssertionError(f"testnet health {what}: exit {rc}, "
                                     f"{json.dumps(doc)[:2000]}")
            time.sleep(1.0)

    def trace(txid, *via):
        argv = via or ("testnet", "trace", txid, "--n", str(n),
                       "--base_port", str(base))
        proc = verb(*argv, "--json")
        st = json.loads(proc.stdout)
        if proc.returncode or st["errors"] or len(st["nodes"]) != n or \
                not {"commit", "deliver"} <= set(st["stages"]):
            raise AssertionError(f"`{' '.join(argv[:2])}` of {txid}: exit "
                                 f"{proc.returncode}, {len(st['nodes'])} "
                                 f"nodes, stages {st['stages']}, errors "
                                 f"{st['errors']}")
        return st

    def sweeps(tx):
        """Every sweep verb over the whole fleet, every node up: the
        testnet forms, then the fleet forms over the hosts file."""
        waited = health_until_ok("after round 1")
        txid = hashlib.sha256(tx).hexdigest()
        st = trace(txid)
        hosts = ("--hosts", hosts_file)
        watch = verb("fleet", "watch", *hosts, "--once")
        if watch.returncode or watch.stdout.count("<") or \
                watch.stdout.count("\n") < n + 1:
            raise AssertionError(f"fleet watch: exit {watch.returncode}, "
                                 f"{watch.stdout[-2000:]}")
        roll = verb("fleet", "scrape", *hosts, "--rollup")
        if roll.returncode or f"# fleet rollup over {n} hosts\n" not in \
                roll.stdout or "FLEET DIVERGENCE" in roll.stdout:
            raise AssertionError(f"fleet scrape --rollup: exit "
                                 f"{roll.returncode}, {roll.stdout[:2000]}")
        rc, doc = health("fleet", "health", *hosts)
        if rc or not all_ok(doc):
            raise AssertionError(f"fleet health: exit {rc}, "
                                 f"{json.dumps(doc)[:2000]}")
        fst = trace(txid, "fleet", "trace", txid, *hosts)
        if set(fst["stages"]) != set(st["stages"]):
            raise AssertionError(f"fleet trace stages {fst['stages']} != "
                                 f"testnet trace's {st['stages']}")
        info["sweeps"] = (waited, len(st["timeline"]), st["stages"],
                          len(roll.stdout.splitlines()))

    def log_check():
        check = NodeLogCheck(info["down"])
        for i, d in enumerate(ddir):
            with open(os.path.join(d, "node.log")) as f:
                check.read(i, f.read())
        return check

    async def until(pred, timeout, what):
        t0 = time.monotonic()
        while not await pred():
            if time.monotonic() - t0 > timeout:
                raise AssertionError(f"tcp testnet: {what} not reached in "
                                     f"{timeout:.0f} s")
            await asyncio.sleep(0.1)

    async def stats_up(i):
        loop = asyncio.get_running_loop()
        if runner.node_procs[i].poll() is not None:
            with open(os.path.join(ddir[i], "node.log")) as f:
                raise AssertionError(f"node {i} exited at boot: "
                                     f"{f.read()[-2000:]}")
        try:
            await loop.run_in_executor(None, tn.fetch_stats,
                                       ports.of(i)["service"])
            return True
        except OSError:
            return False

    # a fifth dummy app, alone, times its ack of a 1 MiB commit batch
    # every few seconds while the fleet runs round 1 (the node-side
    # proxy waits one second a MiB before it logs the ack as late)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        probe_addr = "127.0.0.1:%d" % s.getsockname()[1]
    probe_wire = [b64e((b"probe-%06d-" % k).ljust(T["tx_bytes"], b"."))
                  for k in range(T["probe_txs"])]
    probe_mib = len(json.dumps({"method": "State.CommitTxBatch",
                                "params": [probe_wire], "id": 1})) / 2**20
    probe_acks = []

    submit_at, submit_at2 = {}, {}
    # each node's spans down: from the fleet's start to its /Stats, and
    # node 3's from each SIGKILL to its /Stats again
    info = {"down": {ports.of(i)["gossip"]: [] for i in range(n)},
            "shed": 0}

    async def submit(client, txs):
        rest = list(txs)
        while rest:
            try:
                await client.call("Babble.SubmitTxBatch",
                                  [b64e(tx) for tx in rest])
                return
            except OverloadedError as e:
                info["shed"] += len(rest) - e.admitted
                del rest[:e.admitted]
                await asyncio.sleep(e.retry_after_ms / 1000.0)

    async def kill_and_restart(k):
        """SIGKILL node 3 and its app, then start both again; records
        the wall-clock span it was down for the log check."""
        loop = asyncio.get_running_loop()
        t_kill = time.time()
        runner.kill_node(crash)
        info[f"at_kill{k}"] = await loop.run_in_executor(
            None, tn.fetch_stats, ports.of(0)["service"])
        runner.kill_client(crash)
        with tail_lock:
            _tail_once()
            if os.path.exists(logs[crash]):
                os.replace(logs[crash], befores[k - 1])
            offsets.pop(logs[crash], None)
            nlines.pop(logs[crash], None)
        if k == 1:
            rc, doc = await loop.run_in_executor(None, health)
            down = [(r["host"], r["kind"]) for r in doc["nodes"]
                    if "health" not in r]
            if rc != 1 or down != [(ports.of(crash)["service"],
                                    "unreachable")]:
                raise AssertionError(f"testnet health with node {crash} "
                                     f"down: exit {rc}, down {down}")
        runner.spawn_client(crash)
        t = time.perf_counter()
        runner.restart_node(crash)
        await until(lambda: stats_up(crash), T["boot_s"],
                    f"node {crash}'s /Stats after restart {k}")
        info["down"][crash_addr].append((t_kill, time.time()))
        info[f"restart{k}_s"] = time.perf_counter() - t
        info[f"at_back{k}"] = await loop.run_in_executor(
            None, tn.fetch_stats, ports.of(0)["service"])
        info[f"down{k}_s"] = time.perf_counter() - t + T["down_s"]
        if k == 1:
            info["ok_again_s"] = await loop.run_in_executor(
                None, health_until_ok, f"after node {crash}'s restart")

    async def round1():
        loop = asyncio.get_running_loop()
        half, restarted = asyncio.Event(), asyncio.Event()
        t_start = time.perf_counter()
        info["t_start"] = t_start

        async def submitter(i):
            client = JsonRpcClient(ports.of(i)["submit"], timeout=15.0)
            try:
                for b in range(bursts):
                    if i == crash and b == bursts // 2:
                        half.set()
                        await restarted.wait()
                        await client.close()
                    txs = [(b"tx-%d-%05d-" % (i, b * T["burst"] + k)).ljust(
                        T["tx_bytes"], b".") for k in range(T["burst"])]
                    now = time.perf_counter()
                    for tx in txs:
                        submit_at[tx] = now
                    await submit(client, txs)
                    wake = t_start + (b + 1) * T["burst_every"]
                    await asyncio.sleep(max(0.0, wake - time.perf_counter()))
            finally:
                await client.close()

        async def crash_and_restart():
            await half.wait()

            async def minted():
                # every transaction the node took in is in a minted
                # event, so in its WAL: a mint takes its batches out of
                # the pool before it signs them, so an empty pool alone
                # can be a mint in flight, which a SIGKILL would lose
                m = await loop.run_in_executor(None, metrics, crash)
                return (m.get("babble_ingress_queue_depth", 1) == 0
                        and m.get("babble_transaction_pool", 1) == 0
                        and m.get("babble_coalesce_batch_txs_sum", -1)
                        == m.get("babble_submitted_tx_total"))

            await until(minted, 120, f"node {crash}'s transactions minted")
            info["before"] = await loop.run_in_executor(None, metrics, crash)
            await kill_and_restart(1)
            restarted.set()

        async def prober():
            client = JsonRpcClient(probe_addr, timeout=60.0)
            try:
                while True:
                    t = time.perf_counter()
                    await client.call("State.CommitTxBatch", probe_wire)
                    probe_acks.append(time.perf_counter() - t)
                    await asyncio.sleep(T["probe_every_s"])
            finally:
                await client.close()

        probe = asyncio.ensure_future(prober())
        await asyncio.gather(crash_and_restart(),
                             *(submitter(i) for i in range(n)))
        info["t_submitted"] = time.perf_counter()

        async def delivered():
            return all(path in full_at for path in logs)

        try:
            await until(delivered, T["drain_s"],
                        f"all {total} transactions in every app's log")
        except AssertionError as e:
            counts = [nlines.get(path, 0) for path in logs]
            health = []
            for i in range(n):
                try:
                    h = await loop.run_in_executor(
                        None, tn.fetch_healthz, ports.of(i)["service"])
                    health.append({k: h.get(k) for k in (
                        "lcr", "commit_length", "undetermined",
                        "transaction_pool", "reasons", "probe_armed")})
                except OSError as err:
                    health.append(str(err))
            raise AssertionError(f"{e}: the apps hold {counts}; /healthz "
                                 f"{health}; failures logged "
                                 f"{log_check().failures[:8]}") from None
        finally:
            probe.cancel()
        info["t_done"] = max(full_at.values())
        info["metrics"] = [await loop.run_in_executor(None, metrics, i)
                           for i in range(n)]
        info["apps1"] = [lines(p) for p in logs]
        await loop.run_in_executor(None, sweeps, info["apps1"][0][-1])

    async def round2():
        """More traffic; node 3 is killed a seeded delay after a seeded
        burst of its own was admitted, whatever it is doing then."""
        loop = asyncio.get_running_loop()
        scrape_now, scraped = asyncio.Event(), asyncio.Event()
        go, restarted = asyncio.Event(), asyncio.Event()
        t_start = time.perf_counter()

        async def submitter(i):
            client = JsonRpcClient(ports.of(i)["submit"], timeout=15.0)
            try:
                for b in range(bursts2):
                    if i == crash and b == kill2_burst:
                        scrape_now.set()
                        await scraped.wait()
                    txs = [(b"tx2-%d-%05d-" % (i, b * T["burst"] + k)).ljust(
                        T["tx_bytes"], b".") for k in range(T["burst"])]
                    for tx in txs:
                        submit_at2[tx] = (i, b)
                    await submit(client, txs)
                    if i == crash and b == kill2_burst:
                        go.set()
                        await restarted.wait()
                        await client.close()
                    wake = t_start + (b + 1) * T["burst_every"]
                    await asyncio.sleep(max(0.0, wake - time.perf_counter()))
            finally:
                await client.close()

        async def profile_node0():
            # node 0's own /debug/trace (torch.profiler) over part of
            # the round: its device activities and busy share
            url = (f"http://{ports.of(0)['service']}/debug/trace"
                   f"?seconds={T['trace_s']}")

            def get():
                with urllib.request.urlopen(url, timeout=120) as r:
                    return json.load(r)

            out = await loop.run_in_executor(None, get)
            info["trace"] = trace_busy(os.path.join(out["trace_dir"],
                                                    "trace.json"))
            shutil.rmtree(out["trace_dir"], ignore_errors=True)

        async def crash_and_restart():
            await scrape_now.wait()
            info["before2"] = await loop.run_in_executor(None, metrics,
                                                         crash)
            scraped.set()
            await go.wait()
            await asyncio.sleep(kill2_delay)
            await kill_and_restart(2)
            restarted.set()

        await asyncio.gather(crash_and_restart(), profile_node0(),
                             *(submitter(i) for i in range(n)))
        # what every app must come to hold: all but node 3's
        # transactions from before the kill, which may be lost
        need = len(info["apps1"][0]) + sum(
            1 for i, b in submit_at2.values()
            if i != crash or b > kill2_burst)
        t0, last, stable = time.monotonic(), None, time.monotonic()
        while True:
            tail_once()
            now = [nlines.get(p, 0) for p in logs]
            if now != last:
                last, stable = now, time.monotonic()
            if min(now) >= need and len(set(now)) == 1 and \
                    time.monotonic() - stable > T["settle_s"]:
                break
            if time.monotonic() - t0 > T["drain_s"]:
                raise AssertionError(
                    f"tcp testnet round 2: the apps hold {now}, want at "
                    f"least {need} each and all equal; failures logged "
                    f"{log_check().failures[:8]}")
            await asyncio.sleep(0.1)
        info["final"] = [await loop.run_in_executor(None, metrics, i)
                         for i in range(n)]
        info["alive"] = {i: p.poll() for i, p in runner.node_procs.items()}
        info["apps"] = {i: p.poll() for i, p in runner.client_procs.items()}

    async def run():
        t0, wall = info["t_spawn_perf"], info["t_spawn"]

        async def up(i):
            await until(lambda: stats_up(i), T["boot_s"],
                        f"node {i}'s /Stats")
            info["boot_each"][i] = time.perf_counter() - t0
            info["down"][ports.of(i)["gossip"]].append((wall, time.time()))

        info["boot_each"] = {}
        await asyncio.gather(*(up(i) for i in range(n)))
        info["boot_s"] = time.perf_counter() - t0
        await round1()
        await round2()

    tail = threading.Thread(target=tailer, daemon=True)
    probe_proc = None
    try:
        try:
            info["t_spawn"] = time.time()
            info["t_spawn_perf"] = time.perf_counter()
            runner.start()
            probe_proc = subprocess.Popen(
                [sys.executable, "-m", "babble_tpu_torch.cli", "dummy",
                 "--node_addr", "127.0.0.1:1", "--listen", probe_addr,
                 "--log", os.path.join(tmp, "probe.txt"), "--quiet"],
                env=runner._env(), stdin=subprocess.DEVNULL,
                stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
            tail.start()
            asyncio.run(run())
            tail_once()
        finally:
            done.set()
            runner.stop()
            if probe_proc is not None:
                probe_proc.kill()
                probe_proc.wait()
        check = log_check()
        boots = []
        for i, d in enumerate(ddir):
            with open(os.path.join(d, "node.log")) as f:
                boots += [(i, m.group(1)) for m in re.finditer(
                    r"^node \d+ on (.+?) listening on ", f.read(), re.M)]
            with open(os.path.join(d, "dummy.log")) as f:
                if "Traceback" in f.read():
                    check.failures.append(f"app {i}: a traceback")
        served = {ports.of(i)["gossip"]: m.get(
            "babble_net_serve_timeouts_total", 0)
            for i, m in enumerate(info["final"])}
        served[crash_addr] += sum(info[k].get(
            "babble_net_serve_timeouts_total", 0) for k in ("before",
                                                            "before2"))
        check.check_peer_timeouts(served)
        peers = JSONPeers(ddir[0]).peers()
        wal = WriteAheadLog(os.path.join(ddir[0], "wal"), fsync="off")
        by_creator = {}
        for ev in wal.recovered_events:
            by_creator[ev.creator] = by_creator.get(ev.creator, 0) + 1
        wal.close()
        minted = [by_creator.get(p.pub_key_hex, 0) for p in peers]
        olds = [lines(p) for p in befores]
        apps = [lines(p) for p in logs]
        # the fleet's shape manifest outlives the testnet, for phase 15(d)
        fleet_root = tempfile.mkdtemp(prefix="babble-fleet-manifest-")
        shutil.copy(os.path.join(tmp, "jax_cache_shared",
                                 "babble_aot_manifest.json"), fleet_root)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # round 1: every transaction once, in one order
    want = set(submit_at)
    order = info["apps1"][0]
    for i, got in enumerate(info["apps1"]):
        if len(got) != total or len(set(got)) != total or set(got) != want:
            raise AssertionError(
                f"app {i} holds {len(got)} transactions, {len(set(got))} "
                f"distinct, {len(set(got) & want)} of the {total} submitted")
        if got != order:
            k = next(j for j, (a, b) in enumerate(zip(got, order)) if a != b)
            raise AssertionError(f"app {i} leaves app 0's order at {k}")
    # round 2: one order, no transaction twice, round 1's order first,
    # and only node 3's transactions from before the kill may be missing
    final = apps[0]
    for i, got in enumerate(apps):
        if got != final:
            k = next((j for j, (a, b) in enumerate(zip(got, final))
                      if a != b), min(len(got), len(final)))
            raise AssertionError(f"round 2: app {i} ({len(got)}) leaves app "
                                 f"0's order ({len(final)}) at {k}")
    if len(set(final)) != len(final):
        raise AssertionError(f"round 2: {len(final) - len(set(final))} "
                             "transactions delivered twice")
    if final[:total] != order:
        raise AssertionError("round 2 changed round 1's order")
    for k, old in enumerate(olds, 1):
        if old != final[:len(old)]:
            raise AssertionError(f"node {crash}'s app before kill {k} left "
                                 "the order")
    lost = set(submit_at2) - set(final[total:])
    stray = set(final[total:]) - set(submit_at2)
    may_lose = {tx for tx, (i, b) in submit_at2.items()
                if i == crash and b <= kill2_burst}
    if stray or not lost <= may_lose:
        raise AssertionError(
            f"round 2: {len(stray)} transactions never submitted, "
            f"{len(lost - may_lose)} lost that node {crash} did not hold "
            "at the kill")
    if any(v is not None for v in info["alive"].values()) or \
            any(v is not None for v in info["apps"].values()):
        raise AssertionError(f"processes exited: nodes {info['alive']}, "
                             f"apps {info['apps']}")
    # every node's own boot line (node 3's three times) names the card
    if len(boots) != n + 2 or any(not dev.startswith(device)
                                  for _, dev in boots):
        raise AssertionError(f"boot lines: {boots}")
    if check.failures:
        raise AssertionError(f"{len(check.failures)} failures logged, "
                             f"first: {check.failures[:3]}")

    span = info["t_done"] - info["t_start"]
    lat, lat_up = [], []
    for tx, t in submit_at.items():
        node = int(tx.split(b"-")[1])
        lat.append(seen[node][tx] - t)
        if node != crash:
            lat_up.append(lat[-1])
    print(f"[tcp] testnet: {n} `cli run` processes on {boots[0][1]} over "
          f"TCP and {n} dummy apps; round 1: all {total} transactions in "
          f"every app's messages.txt, each once, one order; node {crash}'s "
          f"new app got that order from the first ({len(olds[0])} had "
          f"reached its old app); no process exited but the killed one; "
          f"failures logged 0; boot {info['boot_s']:.1f} s", flush=True)
    print(f"[tcp] each node prewarmed at boot from one shared cache root "
          f"(the testnet's default): spawn to /Stats "
          f"{', '.join(f'node {i} {s:.2f} s' for i, s in sorted(info['boot_each'].items()))}"
          f"; node {crash}'s restarts boot to /Stats "
          f"{info['restart1_s']:.2f} s and {info['restart2_s']:.2f} s; "
          f"{card}", flush=True)
    for i, m in enumerate(info["final"]):
        print(f"[tcp] node {i} /metrics after node {crash}'s last restart: "
              + ", ".join(f"{c} {m.get(c, 'absent')}" for c in AOT_SERIES)
              + f"; {card}", flush=True)
    missing = [(i, c) for i, m in enumerate(info["final"])
               for c in AOT_SERIES if c not in m]
    if missing:
        raise AssertionError(f"prewarmed nodes without the AOT counters on "
                             f"/metrics: {missing}")
    print(f"[tcp] {total / span:.0f} transactions committed/s (first submit "
          f"to the last app's {total}th: {span:.1f} s; submission took "
          f"{info['t_submitted'] - info['t_start']:.1f} s; "
          f"{info['shed']} shed and resubmitted in both rounds); "
          f"submit->commit at "
          f"the submitting node's app p50 {pctl(lat, 0.5) * 1e3:.0f} ms, "
          f"p99 {pctl(lat, 0.99) * 1e3:.0f} ms (the nodes never killed: "
          f"{pctl(lat_up, 0.5) * 1e3:.0f} / {pctl(lat_up, 0.99) * 1e3:.0f} "
          f"ms); events minted in both rounds "
          f"{sum(minted)} ({minted}, as node 0's WAL holds them); {card}",
          flush=True)
    for i, m in enumerate(info["metrics"] + [info["before"]]):
        tag = f"node {i}" if i < n else f"node {crash} before kill 1"
        calls = m.get("babble_consensus_seconds_count", 0)
        mean = m.get("babble_consensus_seconds_sum", 0) / max(calls, 1)
        print(f"[tcp] round 1, {tag}: run_consensus {calls:.0f} calls, mean "
              f"{mean * 1e3:.1f} ms, p50 "
              f"{scraped_pctl(m, 'babble_consensus_seconds', 0.5)}, p99 "
              f"{scraped_pctl(m, 'babble_consensus_seconds', 0.99)} "
              f"(registry buckets over /metrics); app delivery p50 "
              f"{scraped_pctl(m, 'babble_commit_latency_seconds', 0.5)}; syncs "
              f"{m.get('babble_sync_requests_total', 0):.0f} "
              f"({m.get('babble_sync_errors_total', 0):.0f} failed), pushes "
              f"{m.get('babble_push_total', 0):.0f} "
              f"({m.get('babble_push_errors_total', 0):.0f} failed)",
              flush=True)
    pulls = sum(m.get("babble_sync_requests_total", 0)
                for m in info["final"] + [info["before"], info["before2"]])
    kinds = check.kinds
    for k in (1, 2):
        a, z = info[f"at_kill{k}"], info[f"at_back{k}"]
        print(f"[tcp] kill {k}: node {crash} down {info[f'down{k}_s']:.1f} "
              f"s (SIGKILL, then boot to /Stats {info[f'restart{k}_s']:.1f} "
              f"s); node 0's last consensus round went from "
              f"{a['last_consensus_round']} to {z['last_consensus_round']} "
              f"and its committed transactions from "
              f"{a['consensus_transactions']} to "
              f"{z['consensus_transactions']}", flush=True)
    b2 = info["before2"]
    unminted = (b2.get("babble_transaction_pool", 0)
                + b2.get("babble_ingress_queue_depth", 0)
                + b2.get("babble_submitted_tx_total", 0)
                - b2.get("babble_coalesce_batch_txs_sum", 0))
    m3 = info["final"][crash]
    print(f"[tcp] round 2: {len(submit_at2)} more transactions, node "
          f"{crash} SIGKILLed {kill2_delay * 1e3:.1f} ms after its burst "
          f"{kill2_burst} of {bursts2} was admitted, with {unminted:.0f} of "
          f"its transactions not yet minted before that burst; every app "
          f"holds one order of {len(final)}, none twice, round 1's first; "
          f"{len(lost)} of node {crash}'s {len(may_lose)} transactions from "
          f"before the kill lost; WAL replay at the last restart "
          f"{m3.get('babble_wal_replayed_events_total', 0):.0f} events",
          flush=True)
    node_of = {ports.of(i)["gossip"]: i for i in range(n)}
    split = ", ".join(f"node {node_of[a]} {r} {c}"
                      for (a, r), c in sorted(check.gone.items()))
    print(f"[tcp] pulls that failed, by class, both rounds: "
          f"{kinds.get('pull timeout', 0)} of {pulls:.0f} timed out "
          f"({kinds.get('pull timeout', 0) / max(pulls, 1):.1%}); "
          f"{kinds.get('pull timeout (peer)', 0)} got the peer's own "
          f"timeout (the peers counted {sum(served.values()):.0f}); "
          f"{kinds.get('pull unreachable', 0)} unreachable, all to a "
          f"node while it was down ({split or 'none'}); notices "
          f"{ {k: v for k, v in kinds.items() if k in NodeLogCheck.NOTICES} }",
          flush=True)
    tr = info["trace"]
    print(f"[tcp] node 0 profiled by its own /debug/trace for "
          f"{T['trace_s']} s in round 2: {tr['events']} events, "
          f"{tr['device']} of them device activities, "
          f"busy {tr['busy_ms']:.1f} ms of the trace's {tr['window_ms']:.1f} "
          f"ms = {tr['busy_ms'] / max(tr['window_ms'], 1e-9):.4f}; trace "
          f"{tr['mb']:.2f} MB", flush=True)
    waited, steps, stages, roll_lines = info["sweeps"]
    print(f"[tcp] sweeps: {len(sweep_ms)} `cli` processes (testnet "
          f"health|trace, fleet watch|scrape --rollup|health|trace), wall "
          f"p50 {pctl(sweep_ms, 0.5):.1f} ms, max {max(sweep_ms):.1f} ms "
          f"(host wall); after round 1 every node ok with no "
          f"divergence ({waited:.1f} s of polling), the last transaction "
          f"traced on all {n} nodes ({steps} records, stages "
          f"{sorted(stages)}), "
          f"rollup {roll_lines} lines; node {crash} named unreachable while "
          f"down, every node ok {info['ok_again_s']:.1f} s after its "
          f"restart's /Stats; {card}", flush=True)
    acks = sorted(probe_acks)
    if acks:
        worst = acks[-1] / probe_mib
        print(f"[tcp] app ack: a fifth dummy app acked a {probe_mib:.2f} MiB "
              f"CommitTxBatch ({T['probe_txs']} transactions) in p50 "
              f"{pctl(acks, 0.5) * 1e3:.1f} ms, max {acks[-1] * 1e3:.1f} ms "
              f"({len(acks)} probes during round 1): at worst "
              f"{worst * 1e3:.1f} ms a MiB against the proxy's wait of "
              f"1,000 ms a MiB, a margin of {1 / worst:.1f}x", flush=True)
    codec_costs(device)
    return fleet_root


def phase_host_tools(card: str) -> None:
    """Phase 14: babble-lint over the port and a fleet's conf, as
    ``python -m babble_tpu_torch.cli`` processes from the checkout's
    root (module docstring)."""
    import shutil
    import stat
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)

    def cli(*argv):
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "babble_tpu_torch.cli", *argv], cwd=root,
            env=env, capture_output=True, text=True, timeout=300)
        return proc, time.perf_counter() - t

    lint, lint_s = cli("lint", "--json", "babble_tpu_torch")
    found = [json.loads(line) for line in lint.stdout.splitlines() if line]
    live = [f for f in found if not f["suppressed"]]
    if lint.returncode or live:
        raise AssertionError(f"lint: exit {lint.returncode}, live findings "
                             f"{live[:5]}; {lint.stderr[-2000:]}")
    tmp = tempfile.mkdtemp(prefix="babble-fleet-conf-")
    try:
        hosts = [f"10.0.0.{i + 1}" for i in range(4)]
        with open(os.path.join(tmp, "hosts.txt"), "w") as f:
            f.write("\n".join(hosts) + "\n")
        conf, conf_s = cli("fleet", "conf", "--hosts",
                           os.path.join(tmp, "hosts.txt"), "--dir", tmp)
        if conf.returncode:
            raise AssertionError(f"fleet conf: exit {conf.returncode}, "
                                 f"{conf.stderr[-2000:]}")
        dirs = sorted(os.listdir(os.path.join(tmp, "conf")))
        peers = set()
        for d in dirs:
            path = os.path.join(tmp, "conf", d)
            if sorted(os.listdir(path)) != ["peers.json", "priv_key.pem"]:
                raise AssertionError(f"fleet conf: {d} holds "
                                     f"{os.listdir(path)}")
            with open(os.path.join(path, "peers.json")) as f:
                peers.add(f.read())
        addrs = sorted(p["NetAddr"] for p in json.loads(min(peers)))
        scripts = [name for name in ("start.sh", "stop.sh", "push.sh")
                   if os.stat(os.path.join(tmp, name)).st_mode & stat.S_IXUSR]
        if dirs != [f"node{i}" for i in range(4)] or len(peers) != 1 or \
                addrs != [f"{h}:1337" for h in hosts] or len(scripts) != 3:
            raise AssertionError(f"fleet conf: datadirs {dirs}, "
                                 f"{len(peers)} peers.json texts, addresses "
                                 f"{addrs}, executable scripts {scripts}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[host] lint: `cli lint --json babble_tpu_torch` exit 0, "
          f"{len(found)} findings, all suppressed by name, none live, "
          f"{lint_s:.1f} s host wall; fleet conf: 4 datadirs, one peers.json, "
          f"{len(scripts)} executable deploy scripts, {conf_s:.1f} s host "
          f"wall; {card}", flush=True)


def chaos_summary(result) -> dict:
    """What CHAOS_EXPECT holds of a run."""
    return {
        "fingerprint": result.fingerprint(),
        "committed": {i: len(v) for i, v in sorted(result.committed.items())},
        "fault_counts": dict(sorted(result.fault_counts.items())),
        "ok": result.report.ok,
    }


class ConsensusCalls:
    """Wall ms and surface of every ``run_consensus`` of every engine
    while it is entered (the nodes call ``run_consensus_timed`` from the
    default executor's thread, one at a time)."""

    def __enter__(self):
        from babble_tpu_torch.consensus.engine import TorchHashgraph

        self.ms, self.kinds = [], []
        self._cls = TorchHashgraph
        self._real = real = TorchHashgraph.run_consensus_timed
        calls = self

        def timed(engine):
            t0 = time.perf_counter()
            out = real(engine)
            calls.ms.append((time.perf_counter() - t0) * 1e3)
            calls.kinds.append(engine.last_kernel_class)
            return out

        TorchHashgraph.run_consensus_timed = timed
        return self

    def __exit__(self, *exc):
        self._cls.run_consensus_timed = self._real

    def line(self) -> str:
        if not self.ms:
            return "no run_consensus calls"
        return calls_line(self.ms, self.kinds)


def chaos_scenario(name: str, seed: int):
    from babble_tpu_torch.chaos import Scenario, load_scenario

    if name == "mini-disk-rot":
        return Scenario.from_dict({**CHAOS_MINI_DISKROT, "seed": seed})
    return load_scenario(name)


def chaos_worker(runs: list, device: str = "cuda") -> None:
    """Phase 10(a)'s worker process: each (name, seed) of ``runs``
    through the deterministic runner, and as its last line one JSON
    object: each run's report line and its differences from
    CHAOS_EXPECT (none when equal), and the la_walk launches."""
    from babble_tpu_torch.chaos import run_scenario
    from babble_tpu_torch.ops.pallas_ingest import la_walk

    # every dropped or partitioned sync is a logged warning: thousands
    # of lines a run, none of them a failure (the invariants judge)
    logging.disable(logging.WARNING)
    la_walk.launches = 0
    out = []
    for name, seed in runs:
        t0 = time.perf_counter()
        with ConsensusCalls() as calls:
            result = run_scenario(chaos_scenario(name, seed), seed=seed,
                                  device=device)
        wall = time.perf_counter() - t0
        got, want = chaos_summary(result), CHAOS_EXPECT[name][seed]
        verdict = "== CHAOS_EXPECT" if got == want else "!= CHAOS_EXPECT"
        out.append({
            "line": f"[chaos] (a) {name} seed {seed}: {verdict}, fingerprint "
                    f"{got['fingerprint'][:16]}, committed "
                    f"{list(got['committed'].values())}, invariants "
                    f"{'hold' if got['ok'] else 'VIOLATED'}; wall "
                    f"{wall:.1f} s, {calls.line()}; faults "
                    f"{got['fault_counts']}",
            "diff": {k: repr((got[k], want[k])) for k in got
                     if got[k] != want[k]},
            "report": "" if got["ok"] else result.report.format(),
        })
    print(json.dumps({"runs": out, "la_walk": la_walk.launches}), flush=True)


def phase_chaos_sweep(card: str, device="cuda", runs=None,
                      workers: int = CHAOS_WORKERS) -> None:
    """Phase 10(a): the canned scenarios through the deterministic
    in-memory runner on the card, each run held to CHAOS_EXPECT (module
    docstring), dealt in turn to ``workers`` processes run together."""
    if runs is None:
        runs = CHAOS_RUNS
    t_all = time.perf_counter()
    groups = [runs[i::workers] for i in range(workers)]
    outs = _children([f"chaos_worker({g!r}, {device!r})"
                      for g in groups if g])
    by_run = {}
    for g, o in zip(groups, outs):
        if o["la_walk"]:
            raise AssertionError("the chaos sweep launched la_walk")
        by_run.update(zip(g, o["runs"]))
    failed = []
    for run in runs:
        r = by_run[run]
        print(r["line"], flush=True)
        if r["diff"]:
            if r["report"]:
                print(r["report"], flush=True)
            failed.append((*run, r["diff"]))
    print(f"[chaos] (a) {len(runs)} runs in {len(outs)} processes in "
          f"{time.perf_counter() - t_all:.1f} s; {card}", flush=True)
    if failed:
        raise AssertionError(f"chaos runs != the JAX package's (port, JAX): "
                             f"{failed}")


def phase_chaos_live(card: str, device="cuda") -> None:
    """Phase 10(b): crash-restart against four ``cli run --chaos_plan``
    processes over TCP (``chaos.run_live``; module docstring)."""
    import os
    import shutil
    import tempfile

    from babble_tpu_torch import testnet as tn
    from babble_tpu_torch.chaos import Scenario, load_scenario, run_live

    L = CHAOS_LIVE
    d = load_scenario(L["scenario"]).to_dict()
    d["plan"]["default"] = {**d["plan"].get("default", {}),
                            "drop": L["drop"]}
    sc = Scenario.from_dict({**d, "tick_seconds": L["tick_seconds"]})
    crashed = sorted({c.node for c in sc.plan.crashes})
    tmp = tempfile.mkdtemp(prefix="babble-chaos-live-")
    t0 = time.perf_counter()
    try:
        report = run_live(sc, tmp, rate=L["rate"], device=device,
                          ports=tn.free_port_layout(sc.nodes),
                          log=lambda m: print(f"[chaos] (b) {m}", flush=True))
        wall = time.perf_counter() - t0
        logs = {i: open(os.path.join(tmp, f"node{i}", "node.log")).read()
                for i in range(sc.nodes)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stats, faults = report["stats"], report["chaos_faults"]
    for i, row in enumerate(stats):
        print(f"[chaos] (b) node {i}: "
              + (f"/Stats error {row['error']}" if "error" in row else
                 f"consensus events {row.get('consensus_events')}, "
                 f"transactions {row.get('consensus_transactions')}, last "
                 f"round {row.get('last_consensus_round')}")
              + f"; chaos faults {faults.get(str(i))}", flush=True)
    print(f"[chaos] (b) {sc.name} live: {sc.nodes} cli run --device "
          f"{device} --chaos_plan processes, tick_seconds "
          f"{L['tick_seconds']} (the scenario's 0.05 stretched), drop "
          f"{L['drop']} on every link, {sc.steps} ticks, {L['rate']} tx/s "
          f"bombard; advanced "
          f"{report['advanced']}; wall {wall:.1f} s; {card}", flush=True)
    if not report["advanced"]:
        raise AssertionError(f"live {sc.name}: consensus did not advance on "
                             f"every reachable node: {stats}")
    bad = {i: f for i, f in faults.items() if "error" in f or not f}
    if bad or len(faults) != sc.nodes:
        raise AssertionError(f"live {sc.name}: babble_chaos_faults_total not "
                             f"read on every node: {faults}")
    dropped = sum(f.get("drop", 0) for f in faults.values())
    print(f"[chaos] (b) drops injected over TCP: {dropped:g}", flush=True)
    if dropped <= 0:
        raise AssertionError(f"live {sc.name}: no drop injected on any link "
                             f"under drop {L['drop']}: {faults}")
    for i in crashed:
        if "error" in stats[i] or int(stats[i]["consensus_events"]) <= 0:
            raise AssertionError(f"live {sc.name}: restarted node {i} not "
                                 f"back on /Stats with consensus: {stats[i]}")
    for i, text in logs.items():
        if f" on {device}" not in text or "chaos plan " not in text:
            raise AssertionError(f"live {sc.name}: node {i} did not boot on "
                                 f"{device} under the chaos plan:\n"
                                 f"{text[-2000:]}")


def byz_summary(out, n_events: int) -> dict:
    """What ``BYZ_EXPECT`` holds of a ``ForkOut`` (the JAX package's or
    the port's): the counts bench.py checks and a SHA-256 over round,
    witness, famous, rr and cts in their dtypes."""
    import numpy as np

    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    h = hashlib.sha256()
    for name, dt in (("round", np.int32), ("witness", np.bool_),
                     ("famous", np.int8), ("rr", np.int32),
                     ("cts", np.int64)):
        h.update(np.ascontiguousarray(host(getattr(out, name)), dt)
                 .tobytes())
    rr = host(out.rr)[:n_events]
    det = host(out.det)[:n_events]
    return dict(max_round=int(host(out.max_round)), lcr=int(host(out.lcr)),
                ordered=int((rr >= 0).sum()),
                detecting=int(det.any(axis=1).sum()), digest=h.hexdigest())


def pipeline_summary(out) -> dict:
    """What WIDE_EXPECT holds of a ``run_wide_pipeline`` state (the JAX
    package's or the port's): the ordered count, lcr, max_round and a
    SHA-256 over round, witness, famous, rr and cts in their dtypes."""
    import numpy as np

    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    ne = int(host(out.n_events))
    h = hashlib.sha256()
    for name, dt in (("round", np.int32), ("witness", np.bool_),
                     ("famous", np.int8), ("rr", np.int32),
                     ("cts", np.int64)):
        a = host(getattr(out, name))
        if name != "famous":
            a = a[:ne]
        h.update(np.ascontiguousarray(a, dt).tobytes())
    return dict(ordered=int((host(out.rr)[:ne] >= 0).sum()),
                lcr=int(host(out.lcr)), max_round=int(host(out.max_round)),
                digest=h.hexdigest())


def stream_summary(stream) -> dict:
    """What WIDE_EXPECT and WIDE10K_EXPECT hold of a ``stream_consensus``
    run (the JAX package's or the port's, ``record_ordered``): ordered
    total, lcr, max_round, events evicted and a SHA-256 over every
    ordered event's (global slot, round received, consensus timestamp)
    in slot order."""
    h = hashlib.sha256()
    for slot in sorted(stream.ordered):
        rr, cts = stream.ordered[slot]
        h.update(f"{slot},{rr},{cts};".encode())
    return dict(ordered=stream.ordered_total, lcr=stream.lcr,
                max_round=stream.stats.get("max_round"),
                evicted=stream.evicted, digest=h.hexdigest())


def wide_replay(core_cls, key_from_scalar, cmds, prewarm=None, **core_kw):
    """Four ``Core(wide=True)`` of one package (its ``Core`` class,
    ``key_from_scalar`` and ``net.commands`` module) through
    WIDE_ENGINE's seeded sync schedule on one logical clock,
    ``run_consensus`` after every sync.  With ``prewarm`` (a cache root;
    the port's only) each engine is prewarmed before the replay, as a
    Node does at boot.  Returns the Cores."""
    from babble_tpu_torch.sim.replay import (
        LogicalClock, replay_scalars, sync_schedule,
    )

    cfg = WIDE_ENGINE
    scalars = replay_scalars(cfg["n"], cfg["seed"])
    keys = [key_from_scalar(d) for d in scalars]
    parts = {k.pub_hex: i for i, k in enumerate(keys)}
    clock = LogicalClock()
    cores = [core_cls(i, keys[i], dict(parts), wide=True,
                      wide_caps=cfg["wide_caps"],
                      cache_size=cfg["cache_size"], **core_kw)
             for i in range(cfg["n"])]
    for c in cores:
        c.now_ns = clock
    if prewarm is not None:
        from babble_tpu_torch.ops import aot

        for c in cores:
            aot.prewarm_engine(c.hg, prewarm)
    for c in cores:
        c.init()
    for i, (frm, to, payload) in enumerate(
            sync_schedule(cfg["n"], cfg["syncs"], cfg["seed"])):
        a, b = cores[frm], cores[to]
        req = cmds.SyncRequest.unpack(cmds.SyncRequest("b", b.known()).pack())
        diff = a.diff(req.known)
        resp = cmds.SyncResponse.unpack(cmds.SyncResponse(
            "a", a.head, a.to_wire(diff), a.known()).pack())
        if not b.sync(resp.head, resp.events, payload):
            raise AssertionError(f"wide replay sync {i} minted no event")
        b.run_consensus()
    return cores


def checkpoint_digest(path: str) -> dict:
    """SHA-256 of a checkpoint's ``meta.msgpack`` bytes, and one over its
    ``device.npz`` arrays (name, dtype, shape, bytes, in file order: the
    zip bytes carry timestamps)."""
    import os

    import numpy as np

    with open(os.path.join(path, "meta.msgpack"), "rb") as f:
        meta = hashlib.sha256(f.read()).hexdigest()
    h = hashlib.sha256()
    with np.load(os.path.join(path, "device.npz")) as z:
        for name in z.files:
            a = z[name]
            h.update(f"{name}:{a.dtype}:{a.shape};".encode())
            h.update(np.ascontiguousarray(a).tobytes())
    return dict(meta_sha256=meta, npz_sha256=h.hexdigest())


def wide_engine_summary(cores, ckpt_path: str) -> dict:
    """What WIDE_ENGINE_EXPECT holds of ``wide_replay``'s Cores: commit
    lengths and digests, and core 0's checkpoint (``checkpoint_digest``;
    its window must have rolled)."""
    hg = cores[0].hg
    if hg.dag.slot_base <= 0 or hg.stream.evicted != hg.dag.slot_base:
        raise AssertionError(f"the wide window never rolled: slot_base "
                             f"{hg.dag.slot_base}, evicted "
                             f"{hg.stream.evicted}")
    return dict(commit_length=[c.hg.commit_length for c in cores],
                commit_digest=[c.hg.commit_digest for c in cores],
                lcr=[c.hg.last_consensus_round for c in cores],
                evicted=hg.stream.evicted,
                **checkpoint_digest(ckpt_path))


def ss_bound(g: int, x: int, w: int, n: int, k: int):
    """The least time one fork_ss call could take on the card, for any
    design that reads the window-relative 16-bit coordinates the packed
    kernel reads: the larger of its operations and its bytes (la, hw,
    det read once, the counts written once) over the memory rate.  A
    lane operation reads at most one 32-bit word of each side, two
    creators' branch k; each word pair needs one operation that compares
    it, and each word of results OR'd over the K planes one that counts
    it: g*x*w*ceil(n/2)*(k + 1) lane operations, at most 128 a clock an
    SM (``PEAK_ISSUE_OPS_S``).  Returns (ms, "operations" or "bytes",
    the int32 figure in ms: X*W*B compares on the ALU pipe with the
    X*W*N adds beside them on the FMA pipe, one coordinate a word)."""
    b = n * k
    words = -(-n // 2)
    t_ops = g * x * w * words * (k + 1) / PEAK_ISSUE_OPS_S
    nbytes = 4 * g * (x * b + w * b + x * w) + g * x * n
    t_bytes = nbytes / PEAK_BYTES_S
    cmp, add = g * x * w * b, g * x * w * n
    t32 = max(cmp / PEAK_INT32_OPS_S, add / PEAK_IMAD_OPS_S,
              (cmp + add) / PEAK_ISSUE_OPS_S)
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            max(t32, t_bytes) * 1e3)


def byz_call_inputs(cfg, batch, out):
    """The two fork_ss call shapes of a pipeline run, rebuilt from its
    outputs, each with the batch's window as the call sites hand it: the
    rounds closure's (every event against one candidate witness per
    branch, here round 1's witness row) and the fame's (every round's
    witnesses against the previous round's)."""
    import torch

    from babble_tpu_torch.ops import forks as F
    from babble_tpu_torch.ops.state import INT32_MAX, sanitize

    fdet = F._first_det(cfg, batch, out.det)
    helper = F._helper(cfg, batch, out.fd, fdet)
    row = out.wslot[min(1, cfg.r_cap - 1)]
    hw = torch.where((row >= 0)[:, None],
                     helper[sanitize(row, cfg.e_cap).long()], INT32_MAX)
    closure = (out.la[None], out.det[None], hw[None].contiguous(), cfg.k,
               F.SsWindow(batch.s_off, cfg.s_cap))
    wsl = out.wslot[:cfg.r_cap]
    ws = sanitize(wsl, cfg.e_cap).long()
    hww = torch.where((wsl >= 0)[:, :, None], helper[ws], INT32_MAX)
    law, detw = out.la[ws], out.det[ws]
    fame = (torch.cat([law[1:], torch.full_like(law[:1], -1)]),
            torch.cat([detw[1:], torch.zeros_like(detw[:1])]),
            hww.contiguous(), cfg.k, F.SsWindow(batch.s_off, cfg.s_cap))
    return {"closure": closure, "fame": fame}


def fork_ss_case(g: int, x: int, w: int, n: int, k: int, seed: int,
                 det_rate: float = 0.2, inf_rate: float = 0.15,
                 s_cap=64, device="cpu"):
    """Seeded fork_ss inputs that keep the pipeline's window invariant
    (every la value below its column's ``s_off`` or in ``[s_off, s_off +
    s_cap - 1]``, every hw value there or INT32_MAX) with absolute
    indices far outside int16: ``s_off`` 0 on every fourth column, past
    40,000 on the next and anywhere below 70,000 on the rest; la -1,
    evicted-looking (below ``s_off``) or in the window, the window's top
    on every column of the last viewer row; hw in the window (its top on
    the last witness row), INT32_MAX at ``inf_rate`` and on every column
    of witness row 0; creators detected at ``det_rate`` and all of viewer
    row 0's.  ``s_cap="edge"`` is the
    largest the packed kernel takes (``FORK_SS_NARROW_S_CAP``).  Returns
    ``(la, det, hw, s_off, s_cap)`` on ``device``."""
    import torch

    from babble_tpu_torch.ops.forks import FORK_SS_NARROW_S_CAP
    from babble_tpu_torch.ops.state import INT32_MAX

    if s_cap == "edge":
        s_cap = FORK_SS_NARROW_S_CAP
    gen = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)

    b = n * k
    s_off = ints(0, 70_000, (b,))
    s_off[0::4] = 0
    s_off[1::4] = ints(40_000, 70_000, (len(range(1, b, 4)),))
    rel = ints(-3, s_cap, (g, x, b))
    below = (s_off - ints(1, 1_000, (g, x, b))).clamp_(min=-1)
    la = torch.where(rel >= 0, s_off + rel,
                     torch.where(rel == -1, -1, below))
    la[:, -1] = s_off + s_cap - 1                    # the window's top
    hw = s_off + ints(0, s_cap, (g, w, b))
    hw[:, -1] = s_off + s_cap - 1
    inf = torch.rand((g, w, b), generator=gen, device=device) < inf_rate
    inf[:, 0] = True
    hw.masked_fill_(inf, INT32_MAX)
    det = torch.rand((g, x, n), generator=gen, device=device) < det_rate
    det[:, 0] = True
    return la, det, hw, s_off, s_cap


def plain_fork_ss(la_x, det_x, helper_w, k, window=None):
    """The pipeline's ``ss`` for the plain-twin run: ``ss_counts_plain``
    on the int32 rows, the window not used."""
    from babble_tpu_torch.ops.forks import ss_counts_plain

    return ss_counts_plain(la_x, det_x, helper_w, k)


def check_fork_ss(name: str, args, timed: bool = False) -> dict:
    """fork_ss (``ss_counts`` with the call's window, one counted launch)
    against its plain twin ``ss_counts_plain`` on the int32 rows, on the
    card, exact.  ``args`` is ``(la, det, hw, k, window or None)``.  With
    ``timed`` (a window that narrows): ms warm (CUDA events, mean of 5
    after one warm-up) and L2 cold (mean of 3) of the packed kernel
    alone on the call's planes; the wrapper with both narrowings
    (``call_ms``: a fresh window) and with the viewer planes kept
    (``cached_ms``: the closure's later rounds); the int32 kernel on the
    same rows (``int32_ms``); the viewer narrowing alone
    (``viewer_ms``); and the plain twin's ms (one run)."""
    import torch

    from babble_tpu_torch.ops import forks as F

    la, det, hw, k, win = args
    g, x, b = la.shape
    w, n = hw.shape[1], det.shape[2]
    before = F.ss_counts.launches
    got = F.ss_counts(la, det, hw, k, window=win)
    torch.cuda.synchronize()
    if F.ss_counts.launches != before + 1:
        raise AssertionError(f"fork_ss ({name}) was not one counted launch")
    t0 = time.perf_counter()
    want = F.ss_counts_plain(la, det, hw, k)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((got.long() - want.long()).abs().max().item()) \
        if got.numel() else 0
    path = "packed" if win is not None and win.narrow else "int32"
    if not torch.equal(got, want):
        raise AssertionError(f"fork_ss ({path}) != ss_counts_plain ({name}, "
                             f"g={g} x={x} w={w} n={n} k={k}): "
                             f"{int((got != want).sum())} entries differ")
    bound, by, bound32 = ss_bound(g, x, w, n, k)
    line = (f"[byz] (a) fork_ss {name} g={g} x={x} w={w} n={n} k={k}, "
            f"{path}: exact (max count "
            f"{int(got.max()) if got.numel() else 0}); plain "
            f"{plain_ms:.2f} ms")
    row = dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=bound,
               bound_by=by, bound_int32_ms=bound32)
    if timed:
        view, wit = win.viewer(la, det, k), win.witness(hw, k)

        def kernel():
            return F._launch_fork_ss_packed(view, wit, k)

        row["ms"] = cuda_ms(kernel, reps=5)
        row["ms_cold"] = cuda_ms_cold(kernel, reps=3)
        row["call_ms"] = cuda_ms(lambda: F.ss_counts(
            la, det, hw, k, window=F.SsWindow(win.s_off, win.s_cap)), reps=5)
        row["cached_ms"] = cuda_ms(
            lambda: F.ss_counts(la, det, hw, k, window=win), reps=5)
        row["int32_ms"] = cuda_ms(lambda: F.ss_counts(la, det, hw, k), reps=5)
        row["viewer_ms"] = cuda_ms(
            lambda: F.viewer_planes(la, det, win.s_off, k), reps=5)
        line += (f"; packed kernel {row['ms']:.3f} ms warm, "
                 f"{row['ms_cold']:.3f} ms L2 cold; wrapper "
                 f"{row['call_ms']:.3f} ms with both narrowings, "
                 f"{row['cached_ms']:.3f} with the viewer planes kept; "
                 f"viewer narrowing {row['viewer_ms']:.3f} ms; int32 "
                 f"kernel {row['int32_ms']:.3f} ms (CUDA events, means of "
                 f"5, cold of 3); bound {bound:.3f} ms ({by}), bound / "
                 f"warm {bound / row['ms']:.3f}; int32 figure "
                 f"{bound32:.3f} ms, / warm {bound32 / row['ms']:.3f}")
    print(line, flush=True)
    return row


def fork_ss_turns(other: str, card: str) -> dict:
    """fork_ss against another source of it (``other``, a former version
    of ``csrc/fork_ss.cu`` with the int32 C interface ``fork_ss_launch(la,
    det, hw, out, G, X, W, N, K, stream)``), built here with the same nvcc
    flags, timed in turns on this card: other, this, this, other, at the
    1024 x 100k run's two call shapes (closure 1 x 131,073 x 2,048, fame
    16 x 2,048 x 2,048; N = 1,024, K = 2) on ``fork_ss_case``'s seeded
    inputs (a window past 2^15, s_cap 256 as the run's).  The two
    versions must agree exactly.  ``this`` is the wrapper ``ss_counts``
    with the window, its witness narrowing included and the viewer
    planes kept from the warm-up, as the closure's rounds run it; the
    viewer narrowing, once a pipeline phase, is timed beside it.  Prints
    and returns each version's ms warm and L2 cold (CUDA events, means
    of 5 and 3) and the shares of both bounds."""
    import ctypes
    import os
    import tempfile

    import torch

    from babble_tpu_torch import cuda_build
    from babble_tpu_torch.ops import forks as F

    lib = os.path.join(tempfile.mkdtemp(), "libfork_ss_other.so")
    built = subprocess.run(
        [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, other],
        capture_output=True, text=True, timeout=600)
    if built.returncode != 0:
        raise RuntimeError(f"building {other} failed:\n{built.stdout}"
                           f"{built.stderr}")
    print(f"[turns] built {other}", flush=True)
    kernel_sass(lib, "fork_ss_kernelILi2E", "other")
    fn = ctypes.CDLL(lib).fork_ss_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run_other(la, det, hw, k, out):
        g, x, _ = la.shape
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(la.data_ptr(), det.data_ptr(), hw.data_ptr(), out.data_ptr(),
                g, x, hw.shape[1], det.shape[2], k, stream)
        if rc:
            raise RuntimeError(f"the other fork_ss failed: {rc}")
        return out

    out = {}
    for label, g, x, w in (("closure shape", 1, 131_073, 2048),
                           ("fame shape", 16, 2048, 2048)):
        la, det, hw, s_off, s_cap = fork_ss_case(
            g, x, w, 1024, 2, seed=13, s_cap=256, device="cuda")
        win = F.SsWindow(s_off, s_cap)
        res = torch.empty((g, x, w), dtype=torch.int32, device="cuda")
        want = run_other(la, det, hw, 2, res)
        got = F.ss_counts(la, det, hw, 2, window=win)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"fork_ss != the other version at {label}")
        del got
        bound, _, bound32 = ss_bound(g, x, w, 1024, 2)
        times = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            f = (lambda: run_other(la, det, hw, 2, res)) if who == "other" \
                else (lambda: F.ss_counts(la, det, hw, 2, window=win))
            times[who].append((cuda_ms(f, reps=5), cuda_ms_cold(f, reps=3)))
        viewer = cuda_ms(lambda: F.viewer_planes(la, det, s_off, 2), reps=3)
        best = {who: min(t[0] for t in ts) for who, ts in times.items()}
        out[label] = dict(times, bound_ms=bound, bound_int32_ms=bound32,
                          viewer_ms=viewer)
        fmt = lambda ts: "; ".join(f"{w_:.3f} warm / {c_:.3f} cold"
                                   for w_, c_ in ts)
        print(f"[turns] {label} ({g} x {x} x {w}, n 1024, k 2): other "
              f"{fmt(times['other'])}; this {fmt(times['this'])} (viewer "
              f"narrowing {viewer:.3f} ms once a phase); other / this "
              f"{best['other'] / best['this']:.3f}; bound {bound:.3f} ms, "
              f"/ warm: other {bound / best['other']:.3f}, this "
              f"{bound / best['this']:.3f}; int32 figure {bound32:.3f} ms, "
              f"/ warm: other {bound32 / best['other']:.3f}, this "
              f"{bound32 / best['this']:.3f}; {card}", flush=True)
        del la, det, hw, res, want, win
    return out


def byz_engine_round_trip(device: str, node_launches: int) -> None:
    """A ``ForkHashgraph`` on the card over ``random_byzantine_dag(
    **BYZ_ENGINE)``, held to the JAX engine's commits
    (``BYZ_ENGINE_EXPECT``), then a checkpoint save and load of it."""
    import os
    import shutil
    import tempfile

    from babble_tpu_torch.consensus.fork_engine import ForkHashgraph
    from babble_tpu_torch.sim.generator import random_byzantine_dag
    from babble_tpu_torch.store import load_checkpoint, save_checkpoint

    dag = random_byzantine_dag(**BYZ_ENGINE)
    eng = ForkHashgraph(dag.participants, device=device)
    for ev in dag.events:
        eng.insert_event(ev)
    eng.run_consensus()
    got = dict(commit_length=eng.commit_length, lcr=eng.lcr,
               commit_digest=eng.commit_digest)
    tmp = tempfile.mkdtemp(prefix="babble-byz-ckpt-")
    try:
        save_checkpoint(eng, os.path.join(tmp, "c"))
        back = load_checkpoint(os.path.join(tmp, "c"), device=device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = (back.commit_digest == eng.commit_digest
            and back.commit_length == eng.commit_length
            and back.known() == eng.known() and back.lcr == eng.lcr
            and back.max_round() == eng.max_round())
    verdict = "==" if got == BYZ_ENGINE_EXPECT else "!="
    print(f"[byz] (d) engine over random_byzantine_dag({BYZ_ENGINE}): "
          f"{verdict} BYZ_ENGINE_EXPECT ({eng.commit_length} committed, "
          f"lcr {eng.lcr}); checkpoint round trip: digests "
          f"{'equal' if same else 'DIFFER'}; fork_ss launches in the "
          f"fork-attack runs {node_launches}, la_walk 0",
          flush=True)
    if got != BYZ_ENGINE_EXPECT:
        raise AssertionError(f"the byzantine engine != the JAX package's: "
                             f"{got} vs {BYZ_ENGINE_EXPECT}")
    if not same:
        raise AssertionError("byzantine checkpoint round trip changed the "
                             "engine")


def phase_byzantine(dev, card: str) -> dict:
    """Phase 11 (module docstring).  Returns fork_ss's JSON row."""
    import torch

    from babble_tpu_torch.chaos import ScenarioRunner
    from babble_tpu_torch.ops import forks as F
    from babble_tpu_torch.ops.pallas_ingest import la_walk
    from babble_tpu_torch.sim.arrays import random_byzantine_fork_arrays

    device = dev.type
    t_phase = time.perf_counter()
    # (b) the BASELINE byzantine config on the card, the main path
    full = {k: v for k, v in BYZ_FULL.items() if k not in ("n", "e")}
    t0 = time.perf_counter()
    cfg, arrays = random_byzantine_fork_arrays(BYZ_FULL["n"], BYZ_FULL["e"],
                                               **full)
    t1 = time.perf_counter()
    batch = F.fork_batch_from_numpy(arrays, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"[byz] (b) host build {(t1 - t0) * 1e3:.1f} ms (numpy over "
          f"{BYZ_FULL['e']} events), copy to the card {(t2 - t1) * 1e3:.1f} "
          f"ms; {cfg}, schedule {tuple(batch.sched.shape)}", flush=True)
    F.ss_counts.launches = 0
    la_walk.launches = 0
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    out = F.fork_pipeline(cfg, batch, stats=stats)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = F.ss_counts.launches
    peak = torch.cuda.max_memory_allocated()
    if launches == 0 or la_walk.launches:
        raise AssertionError(f"the byzantine pipeline launched fork_ss "
                             f"{launches} times and la_walk "
                             f"{la_walk.launches} times")
    got = byz_summary(out, BYZ_FULL["e"])
    if got["ordered"] <= 0 or got["detecting"] <= 0 \
            or got["max_round"] >= cfg.r_cap - 1:
        raise AssertionError(f"bench's checks fail at the BASELINE size: "
                             f"{got}, r_cap {cfg.r_cap}")
    warm = []
    for _ in range(2):
        t0 = time.perf_counter()
        F.fork_pipeline(cfg, batch)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    warm_ms = min(warm)
    print(f"[byz] (b) fork_pipeline {BYZ_FULL['n']} x {BYZ_FULL['e']}: "
          f"ordered {got['ordered']}, events detecting forks "
          f"{got['detecting']}, max_round {got['max_round']} (r_cap "
          f"{cfg.r_cap}), lcr {got['lcr']}; fd {stats['fd']}; closure "
          f"rounds {stats['rounds']}, closure passes "
          f"{stats['closure_passes']}; fork_ss launches {launches}; first "
          f"run {first_ms:.1f} ms, warm {warm[0]:.1f} / {warm[1]:.1f} ms "
          f"({got['ordered'] / warm_ms * 1e3:,.0f} events ordered/s); "
          f"peak {peak / 2**30:.2f} GiB; {card}", flush=True)
    t0 = time.perf_counter()
    plain = F.fork_pipeline(cfg, batch, ss=plain_fork_ss)
    torch.cuda.synchronize()
    plain_run_ms = (time.perf_counter() - t0) * 1e3
    bad = [f for f in F.ForkOut._fields
           if not torch.equal(getattr(out, f), getattr(plain, f))]
    if bad:
        raise AssertionError(f"the kernel's run != the plain twin's on "
                             f"{bad}")
    print(f"[byz] (b) the same pipeline with the plain twin: every ForkOut "
          f"field equal; {plain_run_ms:.1f} ms", flush=True)
    del plain

    # (a) the kernel against its twin: this run's two call shapes, one
    # small DAG and ragged tiles
    calls = byz_call_inputs(cfg, batch, out)
    row_c = check_fork_ss("closure shape", calls["closure"], timed=True)
    row_f = check_fork_ss("fame shape", calls["fame"], timed=True)
    n_fame = 1
    n_closure = launches - n_fame
    # the closure narrows la once and its witness rows every round; the
    # fame narrows both sides once
    spent = (row_c["call_ms"] + (n_closure - 1) * row_c["cached_ms"]
             + n_fame * row_f["call_ms"])
    kernels = n_closure * row_c["ms"] + n_fame * row_f["ms"]
    print(f"[byz] (a) fork_ss share of the warm pipeline: {spent / warm_ms:.3f}"
          f" with the narrowing ({spent:.1f} ms: {n_closure} closure calls, "
          f"the first with the viewer narrowing, + {n_fame} fame call), "
          f"{kernels / warm_ms:.3f} the packed kernel alone ({kernels:.1f} "
          f"ms); the int32 kernel's would be "
          f"{n_closure * row_c['int32_ms'] + n_fame * row_f['int32_ms']:.1f}"
          f" ms", flush=True)
    del calls, out
    small = {k: v for k, v in BYZ_SMALL.items() if k not in ("n", "e")}
    scfg, sarr = random_byzantine_fork_arrays(BYZ_SMALL["n"], BYZ_SMALL["e"],
                                              **small)
    sb = F.fork_batch_from_numpy(sarr, dev)
    sout = F.fork_pipeline(scfg, sb)
    for name, args in byz_call_inputs(scfg, sb, sout).items():
        check_fork_ss(f"small {name}", args)
    for i, (name, g, x, w, n, k, opts) in enumerate(FORK_SS_CASES):
        la, det, hw, s_off, s_cap = fork_ss_case(g, x, w, n, k, seed=i,
                                                 **opts)
        la, det, hw, s_off = (t.to(dev) for t in (la, det, hw, s_off))
        check_fork_ss(name, (la, det, hw, k, F.SsWindow(s_off, s_cap)))
        check_fork_ss(f"{name}, no window", (la, det, hw, k, None))

    # (c) the mid-size batch against the JAX package's counts and digest
    mid = {k: v for k, v in BYZ_MID.items() if k not in ("n", "e")}
    t0 = time.perf_counter()
    mcfg, marr = random_byzantine_fork_arrays(BYZ_MID["n"], BYZ_MID["e"],
                                              **mid)
    mout = F.fork_pipeline(mcfg, F.fork_batch_from_numpy(marr, dev))
    got = byz_summary(mout, BYZ_MID["e"])
    verdict = "== BYZ_EXPECT" if got == BYZ_EXPECT else "!= BYZ_EXPECT"
    print(f"[byz] (c) {BYZ_MID['n']} x {BYZ_MID['e']}: {verdict} {got}; "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms with the host build",
          flush=True)
    if got != BYZ_EXPECT:
        raise AssertionError(f"mid-size batch != the JAX package's: {got} "
                             f"vs {BYZ_EXPECT}")
    del mout

    # (d) the node path: fork-attack through the deterministic runner's
    # byzantine Nodes, then a checkpoint round trip of one node's engine
    logging.disable(logging.WARNING)
    F.ss_counts.launches = 0
    la_walk.launches = 0
    failed = []
    try:
        for name in CHAOS_BYZANTINE:
            for seed in CHAOS_SEEDS:
                t0 = time.perf_counter()
                result = ScenarioRunner(chaos_scenario(name, seed),
                                        seed=seed, device=device).run()
                g = chaos_summary(result)
                want = CHAOS_EXPECT[name][seed]
                ok = g == want and "fork_detected" in result.report.checked
                print(f"[byz] (d) {name} seed {seed}: "
                      f"{'== CHAOS_EXPECT' if ok else '!= CHAOS_EXPECT'}, "
                      f"fingerprint {g['fingerprint'][:16]}, committed "
                      f"{list(g['committed'].values())}, invariants "
                      f"{'hold' if g['ok'] else 'VIOLATED'} "
                      f"({', '.join(result.report.checked)}); faults "
                      f"{g['fault_counts']}; wall "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
                if not ok:
                    failed.append((name, seed, g))
    finally:
        logging.disable(logging.NOTSET)
    node_launches = F.ss_counts.launches
    if failed:
        raise AssertionError(f"fork-attack runs != the JAX package's: "
                             f"{failed}")
    if node_launches == 0 or la_walk.launches:
        raise AssertionError(f"the byzantine nodes launched fork_ss "
                             f"{node_launches} times and la_walk "
                             f"{la_walk.launches} times")
    byz_engine_round_trip(device, node_launches)
    print(f"[byz] phase 11: {time.perf_counter() - t_phase:.1f} s; {card}",
          flush=True)
    return {
        "name": "fork_ss", "route": "cuda",
        "source": "babble_tpu_torch/csrc/fork_ss.cu",
        "replaces": "babble_tpu/ops/forks.py:649",
        "launches": launches, "max_abs_err": row_c["max_abs_err"],
        "ms": row_c["ms"], "ms_cold": row_c["ms_cold"],
        "call_ms": row_c["call_ms"], "cached_ms": row_c["cached_ms"],
        "int32_ms": row_c["int32_ms"], "plain_ms": row_c["plain_ms"],
        "bound_ms": row_c["bound_ms"], "bound_by": row_c["bound_by"],
        "bound_int32_ms": row_c["bound_int32_ms"], "library_ms": None,
        "fame_ms": row_f["ms"], "fame_call_ms": row_f["call_ms"],
        "fame_int32_ms": row_f["int32_ms"],
        "fame_plain_ms": row_f["plain_ms"],
        "fame_bound_ms": row_f["bound_ms"],
        "fame_bound_int32_ms": row_f["bound_int32_ms"],
    }


def ss_count_bound(g: int, a: int, b: int, w: int, elem: int):
    """The least time one ss_count launch could take on the card, for any
    design: the larger of its operations and its bytes.  The function
    compares g*a*b*w pairs of ``elem``-byte values.  A lane operation
    reads at most one 32-bit word of each row, so 4 / elem pairs (4
    int8, 2 int16, 1 int32); a word pair needs at least two lane
    operations, one that compares and one that adds into a count; and an
    SM dispatches at most 128 lane operations a clock (4 schedulers x 32
    lanes; the ALU and FMA pipes 64 each at compute capability 9.0).  So
    g*a*b*w / (4 / elem) word pairs at ``PEAK_INT32_OPS_S`` bound every
    design.  (The tensor cores' one-hot product needs 2*a*b*w*S1 int8
    operations for S1 seq buckets: 7.6 ms at the 10k run's shape with
    S1 = 143, 2.6 ms with a 48-wide band, at the 1,979 TOP/s int8 peak.)
    Its bytes are both row sets read once and the int32 tally read and
    written once.  Returns (ms, "operations" or "bytes")."""
    t_ops = g * a * b * w / (4 // elem) / PEAK_INT32_OPS_S
    t_bytes = (elem * g * (a + b) * w + 8 * a * b) / PEAK_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ss_count_cases(dt, gen):
    """ss_count's exactness cases at one coordinate type, as CPU tensors
    ``(name, rows_a, rows_b, acc0)`` (the twin is ``acc0 + sum_g
    ss_counts_compare``): ragged rows and columns with the -1 floor and
    the fd_inf sentinel; widths not a multiple of 4 or of 16 bytes; rows
    under one 128 x 128 tile and not a multiple of it; stacked G = 2, 3,
    4; the type's minimum and maximum on both sides (la = max against
    fd = min and the reverse); gathered rows whose stride is off a
    4-byte boundary; strided views.  Phase 12(a) and
    tests/test_torch_wide.py's card test run them all."""
    import torch

    info = torch.iinfo(dt)
    lo, hi = info.min, info.max

    def acc0(na, nb):
        return torch.randint(0, 5, (na, nb), generator=gen,
                             dtype=torch.int32)

    cases = []
    for g, na, nb, w in ((1, 65, 63, 1), (1, 130, 257, 1667),
                         (3, 1000, 77, 333), (2, 64, 64, 64),
                         (1, 7, 5, 3), (1, 129, 300, 527), (2, 3, 130, 13),
                         (4, 200, 129, 22), (1, 256, 128, 40)):
        a = torch.randint(-1, 110, (g, na, w), generator=gen).to(dt)
        b = torch.randint(-1, 120, (g, nb, w), generator=gen)
        b[b >= 110] = hi
        b = b.to(dt)
        cases.append((f"ragged g={g} {na}x{nb}x{w}", a if g > 1 else a[0],
                      b if g > 1 else b[0], acc0(na, nb)))
    ext = torch.tensor([lo, lo + 1, -1, 0, 1, hi - 1, hi])
    a = ext[torch.randint(0, 7, (2, 150, 37), generator=gen)].to(dt)
    b = ext[torch.randint(0, 7, (2, 141, 37), generator=gen)].to(dt)
    a[:, 0], b[:, 0] = hi, lo
    a[:, 1], b[:, 1] = lo, hi
    cases.append(("extremes g=2 150x141x37", a, b, acc0(150, 141)))
    full = torch.randint(lo, hi + 1, (300, 531), generator=gen).to(dt)
    idx = torch.randint(0, 300, (190,), generator=gen)
    cases.append(("gathered rows 190x170x527", full[idx, :527],
                  full[idx.flip(0)[:170], 4:], acc0(190, 170)))
    cases.append(("strided views 300x150x530", full[:, 1:],
                  full[::2, :530], acc0(300, 150)))
    stk = torch.randint(lo, hi + 1, (3, 70, 91), generator=gen).to(dt)
    cases.append(("stacked strided views g=3 70x65x87", stk[:, :, 2:89],
                  stk[:, 5:, :87], acc0(70, 65)))
    return cases


def card_view(x, dev):
    """CPU tensor ``x`` on ``dev`` with its strides and storage offset:
    a view stays the same view of its base moved to the card."""
    if x._base is None:
        return x.to(dev)
    return x._base.to(dev).as_strided(x.shape, x.stride(),
                                      x.storage_offset())


def check_ss_count(name: str, rows_a, rows_b, timed: bool = False,
                   tag: str = "(a)", acc0=None) -> dict:
    """ss_count (``ss_counts_acc``) against its plain twin
    ``ss_counts_compare`` on the card, exact, from a non-zero tally (the
    kernel adds in place; ``acc0``, else a seeded one); with ``timed`` the
    kernel's ms warm (CUDA events, mean of 5 after one warm-up) and L2
    cold (mean of 3), and the twin's ms (one run)."""
    import torch

    from babble_tpu_torch.ops.ss import ss_counts_acc, ss_counts_compare

    a3 = rows_a if rows_a.dim() == 3 else rows_a[None]
    b3 = rows_b if rows_b.dim() == 3 else rows_b[None]
    g, na, w = a3.shape
    nb = b3.shape[1]
    if acc0 is None:
        acc0 = torch.arange(na * nb, device=rows_a.device,
                            dtype=torch.int32).reshape(na, nb) % 7
    before = ss_counts_acc.launches
    got = ss_counts_acc(rows_a, rows_b, acc0.clone())
    torch.cuda.synchronize()
    if ss_counts_acc.launches != before + 1:
        raise AssertionError(f"ss_count ({name}) was not one counted launch")
    t0 = time.perf_counter()
    want = acc0.clone()
    for c in range(g):
        want += ss_counts_compare(a3[c], b3[c])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((got.long() - want.long()).abs().max().item())
    if not torch.equal(got, want):
        raise AssertionError(f"ss_count != ss_counts_compare ({name}, "
                             f"{rows_a.dtype} g={g} a={na} b={nb} w={w}): "
                             f"{int((got != want).sum())} entries differ")
    bound, by = ss_count_bound(g, na, nb, w, rows_a.element_size())
    line = (f"[wide] {tag} ss_count {name} {str(rows_a.dtype)[6:]} g={g} "
            f"a={na} b={nb} w={w}: exact; plain {plain_ms:.2f} ms")
    row = dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=bound,
               bound_by=by)
    if timed:
        acc = acc0.clone()
        row["ms"] = cuda_ms(lambda: ss_counts_acc(rows_a, rows_b, acc),
                            reps=5)
        row["ms_cold"] = cuda_ms_cold(
            lambda: ss_counts_acc(rows_a, rows_b, acc), reps=3)
        line += (f"; kernel {row['ms']:.3f} ms warm, {row['ms_cold']:.3f} "
                 f"ms L2 cold (CUDA events, means of 5 and 3); bound "
                 f"{bound:.3f} ms ({by}: {4 // rows_a.element_size()} "
                 f"pairs a 32-bit word pair, a word pair a lane operation "
                 f"of one pipe); bound / warm {bound / row['ms']:.3f}")
    print(line, flush=True)
    return row


def wide_march_rows(stream):
    """ss_count's inputs at the 10k run's frontier-march shape, taken
    from its final state: block 0's la rows of every chain's middle
    in-window event (the bisect's candidates) and fd rows of the last
    witness row still in the window (the round's witnesses; missing
    witnesses read the sentinel row, as in the march)."""
    import torch

    from babble_tpu_torch.ops.state import sanitize

    st, cfg = stream.state, stream.cfg
    n = cfg.n
    cnt_w = st.cnt[:n] - st.s_off[:n]
    xs = st.ce[torch.arange(n, device=cnt_w.device),
               torch.clamp(cnt_w // 2, 0, cfg.s_cap).long()]
    valid = (st.wslot[:cfg.r_cap] >= 0).any(dim=1)
    r = int(torch.nonzero(valid).max().item())
    ws = st.wslot[r]
    la = stream.la_blocks[0][sanitize(xs, cfg.e_cap).long()]
    fd = stream.fd_blocks[0][sanitize(ws, cfg.e_cap).long()]
    return la, fd, r


def wide_coords_split(stream, dag, batch: int) -> str:
    """The coords phase split, by one timed re-run of each scan over the
    finished 10k stream's window (la over the last batch's levels, the
    fd sweep over every live level with no own-seq seeding), all blocks,
    host clock with a synchronize.  The scans write their blocks, so
    this runs after every check that reads them."""
    import torch

    from babble_tpu_torch.ops.stream import _padded_schedule
    from babble_tpu_torch.ops.wide import _jits

    cfg, st = stream.cfg, stream.state
    j = _jits(cfg, stream.C)
    w = j["width"]
    dev = st.sp.device
    E, ne = dag.n_events, stream.n_live
    sched = torch.tensor(_padded_schedule(dag.levels[E - batch:E], -1),
                         device=dev)
    la_sched = torch.where(sched >= 0, ne - batch + sched, cfg.e_cap)
    fd_sched = torch.tensor(_padded_schedule(dag.levels[stream.e_off:E],
                                             cfg.e_cap), device=dev)
    args = (st.sp, st.op, st.creator, st.seq, st.s_off)
    none = torch.zeros((0,), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre = j["la_sched"](*args, la_sched)
    for c, blk in enumerate(stream.la_blocks):
        j["la_block_scan"](*args, blk, la_sched, c * w, pre)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pre = j["fd_sched"](st.sp, st.op, fd_sched)
    for c, blk in enumerate(stream.fd_blocks):
        j["fd_block_scan"](*args, none, 0, st.n_events, blk, fd_sched,
                           c * w, pre)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (f"la over the last batch ({batch} events, {la_sched.shape[0]} "
            f"schedule rows) {(t1 - t0) * 1e3:.1f} ms; fd sweep over the "
            f"window ({ne} live events, {fd_sched.shape[0]} rows) "
            f"{(t2 - t1) * 1e3:.1f} ms; {stream.C} blocks")


def phase_wide(dev, card: str, base3) -> dict:
    """Phase 12 (module docstring).  ``base3`` is the C++ baseline's
    result on config 3's DAG (phase 13(d)).  Returns ss_count's JSON
    row."""
    import os
    import tempfile

    import torch

    from babble_tpu_torch import (
        DagConfig, batch_from_arrays, random_gossip_arrays,
    )
    from babble_tpu_torch.crypto.keys import key_from_scalar
    from babble_tpu_torch.net import commands
    from babble_tpu_torch.node.core import Core
    from babble_tpu_torch.ops.pallas_ingest import la_walk
    from babble_tpu_torch.ops.ss import ss_counts_acc
    from babble_tpu_torch.ops.stream import stream_consensus
    from babble_tpu_torch.ops.wide import block_count, run_wide_pipeline
    from babble_tpu_torch.store import load_checkpoint, save_checkpoint

    t_phase = time.perf_counter()
    # (a) the kernel against its twin: every type, the cases of
    # tests/test_torch_wide.py's card test (ragged, odd widths, extremes,
    # gathered rows and strided views, stacked), each from a non-zero tally
    gen = torch.Generator().manual_seed(11)
    for dt in (torch.int8, torch.int16, torch.int32):
        for name, a, b, acc0 in ss_count_cases(dt, gen):
            check_ss_count(name, card_view(a, dev), card_view(b, dev),
                           acc0=acc0.to(dev))
    # bench's config-5 block, seeded rows with the sentinels
    rows, w = WIDE_INT8_BLOCK
    a = torch.randint(-1, 100, (rows, w), generator=gen)
    b = torch.randint(-1, 120, (rows, w), generator=gen)
    b[b >= 100] = 127
    row8 = check_ss_count("config-5 block, seeded rows",
                          a.to(torch.int8).to(dev), b.to(torch.int8).to(dev),
                          timed=True)
    # config 3's int32 shape (one block of 1,024 creators, 1,024 rows)
    n3 = WIDE_FULL["n"]
    a = torch.randint(-1, 140, (n3, n3), generator=gen, dtype=torch.int32)
    b = torch.randint(-1, 150, (n3, n3), generator=gen, dtype=torch.int32)
    b[b >= 140] = 2**31 - 1
    row32 = check_ss_count("config-3 shape, seeded rows", a.to(dev),
                           b.to(dev), timed=True)
    del a, b

    # (b) runs held to the JAX package: BASELINE config 3 through the
    # wide pipeline, and the mid-size stream
    f = WIDE_FULL
    t0 = time.perf_counter()
    dag = random_gossip_arrays(f["n"], f["e"], seed=f["seed"])
    cfg = DagConfig(n=f["n"], e_cap=f["e"], s_cap=dag.max_chain + 3,
                    r_cap=f["r_cap"])
    batch = batch_from_arrays(dag, device=dev)
    host_ms = (time.perf_counter() - t0) * 1e3
    ss_counts_acc.launches = 0
    la_walk.launches = 0
    walls = []
    for rep in range(2):
        timings, stats = {}, {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_wide_pipeline(cfg, batch, timings=timings, stats=stats,
                                assemble=False)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if rep == 0:
            full_launches = ss_counts_acc.launches
            got = pipeline_summary(out)
            held = hold_to_baseline("(b) config 3 wide pipeline", out,
                                    base3, int(out.n_events.item()))
        del out
    if full_launches == 0 or la_walk.launches:
        raise AssertionError(f"run_wide_pipeline launched ss_count "
                             f"{full_launches} times and la_walk "
                             f"{la_walk.launches} times")
    verdict = "== WIDE_EXPECT" if got == WIDE_EXPECT["full"] else \
        "!= WIDE_EXPECT"
    print(f"[wide] (b) run_wide_pipeline {f['n']} x {f['e']} (BASELINE "
          f"config 3, C={block_count(cfg)}, int32, s_cap {cfg.s_cap}, "
          f"r_cap {cfg.r_cap}): {verdict} {got}; host build {host_ms:.1f} "
          f"ms; first {walls[0]:.1f} ms, warm {walls[1]:.1f} ms "
          f"({got['ordered'] / walls[1] * 1e3:,.0f} events ordered/s); "
          f"phases {', '.join(f'{k} {v * 1e3:.1f} ms' for k, v in timings.items())}; "
          f"ss_count launches {full_launches}; rounds to fame "
          f"{stats.get('fame_decision_distance')}; == C++ baseline (phase "
          f"13(d)) on round, witness, rr, cts and fame, {held:,} ordered; "
          f"{card}", flush=True)
    if got != WIDE_EXPECT["full"]:
        raise AssertionError(f"config 3 through run_wide != the JAX "
                             f"package's: {got} vs {WIDE_EXPECT['full']}")
    del batch, dag
    s = WIDE_STREAM
    ss_counts_acc.launches = 0
    t0 = time.perf_counter()
    mid = stream_consensus(DagConfig(**s["cfg"]), random_gossip_arrays(
        s["n"], s["e"], seed=s["seed"]), device=dev, **s["run"])
    got = stream_summary(mid)
    verdict = "== WIDE_EXPECT" if got == WIDE_EXPECT["stream"] else \
        "!= WIDE_EXPECT"
    print(f"[wide] (b) stream_consensus {s['n']} x {s['e']} (window "
          f"{s['cfg']['e_cap']}, C={mid.C}, int8): {verdict} {got}; "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms with the host build; "
          f"ss_count launches {ss_counts_acc.launches}", flush=True)
    if got != WIDE_EXPECT["stream"] or ss_counts_acc.launches == 0 \
            or la_walk.launches:
        raise AssertionError(f"the mid-size stream != the JAX package's "
                             f"({got} vs {WIDE_EXPECT['stream']}) or "
                             f"launched ss_count {ss_counts_acc.launches} "
                             f"and la_walk {la_walk.launches} times")
    del mid

    # (c) BASELINE config 5: the nearest config to bench.py's run_10k
    # that orders the stream (bench's own refuses on every platform, by
    # a window overflow and by the in-window chain depth; those refusal
    # paths are pinned on the CPU by tests/test_torch_stream.py and
    # tests/test_torch_wide_engine.py; their runs at config 5 on the card
    # are left out to make room for phase 16)
    k = WIDE10K
    t0 = time.perf_counter()
    dag = random_gossip_arrays(k["n"], k["e"], seed=k["seed"])
    print(f"[wide] (c) host build {time.perf_counter() - t0:.1f} s; "
          f"max_chain {dag.max_chain}, levels {dag.n_levels}", flush=True)
    la_walk.launches = 0
    cfg = DagConfig(**dict(k["cfg"], **WIDE10K_RUN,
                           s_cap=dag.max_chain + 3))
    torch.cuda.reset_peak_memory_stats()
    ss_counts_acc.launches = 0
    t0 = time.perf_counter()
    stream = stream_consensus(
        cfg, dag, device=dev, log=lambda m: print(f"[wide] (c) {m}",
                                                  flush=True), **k["run"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ss_counts_acc.launches
    peak = torch.cuda.max_memory_allocated()
    if launches == 0 or la_walk.launches:
        raise AssertionError(f"the 10k stream launched ss_count {launches} "
                             f"times and la_walk {la_walk.launches} times")
    st = stream.stats
    got = stream_summary(stream)
    ingested = st.get("events_ingested", k["e"])
    if st.get("truncated") or ingested != k["e"] \
            or st.get("median_bad_rows") != 0 or got["ordered"] <= 0 \
            or stream.evicted <= 0:
        raise AssertionError(f"the 10k stream did not order the whole DAG "
                             f"cleanly: ingested {ingested}, evicted "
                             f"{stream.evicted}, stats {st}")
    rtf = {r: d for r, d in st.get("fame_decision_distance", {}).items()}
    verdict = ("(first reading: WIDE10K_EXPECT unset)" if WIDE10K_EXPECT
               is None else "== WIDE10K_EXPECT" if got == WIDE10K_EXPECT
               else "!= WIDE10K_EXPECT")
    print(f"[wide] (c) stream_consensus {k['n']} x {k['e']} (config 5 with "
          f"int16, s_cap {cfg.s_cap}, window {cfg.e_cap}, C={stream.C}, "
          f"batches {k['run']['batch_events']}): ingested {ingested}, "
          f"ordered {got['ordered']}, lcr {got['lcr']}, max_round "
          f"{got['max_round']}, evicted {got['evicted']}; wall {wall:.1f} s "
          f"({got['ordered'] / wall:,.0f} events ordered/s, "
          f"{ingested / wall:,.0f} ingested/s); phases "
          f"{', '.join(f'{n} {v:.1f} s' for n, v in stream.timings.items())}; "
          f"rounds to fame (fame_decision_distance) {rtf}; ss tallies "
          f"{st.get('ss_tallies')}, round steps {st.get('round_steps')}, "
          f"fame vote steps {st.get('fame_vote_steps')}, median chunks "
          f"{st.get('median_chunks')}, bad rows {st.get('median_bad_rows')}; "
          f"peak {peak / 2**30:.2f} GiB; ss_count launches {launches}; "
          f"{verdict} {got}; {card}", flush=True)
    if WIDE10K_EXPECT is not None and got != WIDE10K_EXPECT:
        raise AssertionError(f"the 10k stream != WIDE10K_EXPECT: {got} vs "
                             f"{WIDE10K_EXPECT}")
    # the kernel at the 10k run's march shape, from its final state
    la, fd, r = wide_march_rows(stream)
    row = check_ss_count(f"10k march shape (witness row {r})", la, fd,
                         timed=True, tag="(c)")
    share = launches * row["ms"] / (wall * 1e3)
    print(f"[wide] (c) ss_count share of the 10k wall: {share:.3f} "
          f"({launches} launches at the march shape's warm ms)", flush=True)
    del la, fd
    print(f"[wide] (c) coords split, one re-run of each scan: "
          f"{wide_coords_split(stream, dag, k['run']['batch_events'])}",
          flush=True)
    del stream, dag
    torch.cuda.empty_cache()

    # (d) four Core(wide=True) through the seeded replay, and core 0's
    # checkpoint, held to the JAX Cores and the JAX checkpoint
    ss_counts_acc.launches = 0
    t0 = time.perf_counter()
    cores = wide_replay(Core, key_from_scalar, commands, device=dev.type)
    path = os.path.join(tempfile.mkdtemp(), "wide")
    save_checkpoint(cores[0].hg, path)
    got = wide_engine_summary(cores, path)
    node_launches = ss_counts_acc.launches
    back = load_checkpoint(path, device=dev.type)
    if type(back).__name__ != "WideHashgraph" \
            or back.commit_digest != cores[0].hg.commit_digest \
            or back.known() != cores[0].hg.known():
        raise AssertionError("the wide checkpoint did not round-trip")
    verdict = "== WIDE_ENGINE_EXPECT" if got == WIDE_ENGINE_EXPECT else \
        "!= WIDE_ENGINE_EXPECT"
    print(f"[wide] (d) {WIDE_ENGINE['n']} Core(wide=True) x "
          f"{WIDE_ENGINE['syncs']} syncs: {verdict} (commits "
          f"{got['commit_length']}, lcr {got['lcr']}, evicted "
          f"{got['evicted']}, meta {got['meta_sha256'][:16]}, npz "
          f"{got['npz_sha256'][:16]}); checkpoint restored on the card, "
          f"digests equal; ss_count launches {node_launches}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if got != WIDE_ENGINE_EXPECT:
        raise AssertionError(f"the wide Cores != the JAX package's: {got} "
                             f"vs {WIDE_ENGINE_EXPECT}")
    # (e) no wide flow walks la
    if node_launches == 0 or la_walk.launches:
        raise AssertionError(f"the wide Cores launched ss_count "
                             f"{node_launches} times and la_walk "
                             f"{la_walk.launches} times")
    print(f"[wide] (e) la_walk launches on every wide flow: 0; phase 12 "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return {
        "name": "ss_count", "route": "cuda",
        "source": "babble_tpu_torch/csrc/ss_count.cu",
        "replaces": "babble_tpu/ops/wide.py:209",
        "launches": launches, "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "ms_cold": row["ms_cold"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
        "int8_block_ms": row8["ms"], "int8_block_ms_cold": row8["ms_cold"],
        "int8_block_plain_ms": row8["plain_ms"],
        "int8_block_bound_ms": row8["bound_ms"],
        "int32_config3_ms": row32["ms"],
        "int32_config3_bound_ms": row32["bound_ms"],
    }


def hold_to_baseline(label: str, out, base, e: int) -> int:
    """Hold a step state's first ``e`` events to the C++ baseline's
    arrays (``native.baseline_consensus``): round, witness and rr
    exactly, cts where rr >= 0, and fame through every ``wslot`` cell
    that names an event (tests/test_arrays.py's mapping).  Raises naming
    the first field and slot that differ; returns the ordered count."""
    import numpy as np

    ordered, want = base

    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    rr = host(out.rr)[:e]
    recv = want["rr"] >= 0
    wslot, famous = host(out.wslot), host(out.famous)
    cell = (wslot >= 0) & (wslot < e)
    pairs = (
        ("round", host(out.round)[:e], want["round"]),
        ("witness", host(out.witness)[:e].astype(bool), want["witness"]),
        ("rr", rr, want["rr"]),
        ("cts", host(out.cts)[:e][recv], want["cts"][recv]),
        ("fame", famous[cell], want["fame"][wslot[cell]]),
    )
    for name, got, ref in pairs:
        if got.shape != ref.shape or not np.array_equal(got, ref):
            i = int(np.flatnonzero(got != ref)[0]) if got.shape == \
                ref.shape else -1
            raise AssertionError(
                f"{label}: {name} differs from the C++ baseline (first "
                f"index {i}: {got[i] if i >= 0 else got.shape} vs "
                f"{ref[i] if i >= 0 else ref.shape})")
    got = int((rr >= 0).sum())
    if got != ordered:
        raise AssertionError(f"{label}: ordered {got} != the C++ "
                             f"baseline's {ordered}")
    return got


def oracle_flow(device, n: int, e: int, seed: int, every: int,
                engine: dict) -> dict:
    """``TorchHashgraph`` on ``device`` held to ``OracleHashgraph``: the
    same events (``random_gossip_dag(n, e, seed)``, unsigned) into both,
    one ``run_consensus`` of each every ``every`` inserts and at the end.
    After every call, the round and witness flag of every event the
    engine still holds; at the end, the commit order, each committed
    event's round received and consensus timestamp, the last consensus
    round, and the fame of every witness of the rounds the engine still
    holds (tests/test_engine.py ``_compare_all``, on a rolling window).
    Raises at the first difference; returns what it compared."""
    from babble_tpu_torch import (
        OracleHashgraph, TorchHashgraph, random_gossip_dag,
    )
    from babble_tpu_torch.store import InmemStore

    g = random_gossip_dag(n, e, seed=seed)
    oracle = OracleHashgraph(
        participants=g.participants, verify_signatures=False,
        store=InmemStore(g.participants, cache_size=100_000))
    eng = TorchHashgraph(g.participants, verify_signatures=False,
                         device=device, **engine)
    got, want = [], []
    rounds = 0
    for i, ev in enumerate(g.events):
        oracle.insert_event(ev.clone())
        eng.insert_event(ev.clone())
        if i % every != every - 1 and i != len(g.events) - 1:
            continue
        got += eng.run_consensus()
        want += oracle.run_consensus()
        for x in (v.hex() for v in g.events[:i + 1]):
            if x not in eng.dag.slot_of:
                continue
            if (eng.round(x), eng.witness(x)) != (oracle.round(x),
                                                  oracle.witness(x)):
                raise AssertionError(
                    f"engine vs oracle after insert {i}: {x[:12]} round/"
                    f"witness {(eng.round(x), eng.witness(x))} vs "
                    f"{(oracle.round(x), oracle.witness(x))}")
            rounds += 1
    if [x.hex() for x in got] != [x.hex() for x in want]:
        raise AssertionError(f"engine vs oracle: commit order differs "
                             f"({len(got)} vs {len(want)} committed)")
    for a, b in zip(got, want):
        if (a.round_received, a.consensus_timestamp) != \
                (b.round_received, b.consensus_timestamp):
            raise AssertionError(
                f"engine vs oracle: {a.hex()[:12]} round received / "
                f"consensus timestamp {(a.round_received, a.consensus_timestamp)}"
                f" vs {(b.round_received, b.consensus_timestamp)}")
    if eng.last_consensus_round != oracle.last_consensus_round:
        raise AssertionError(f"engine vs oracle: lcr "
                             f"{eng.last_consensus_round} vs "
                             f"{oracle.last_consensus_round}")
    fame = 0
    for r in range(eng._r_off, oracle.store.rounds()):
        info = oracle.store.get_round(r)
        for w in info.witnesses():
            if w in eng.dag.slot_of:
                if eng.famous_of(r, w) != info.events[w].famous:
                    raise AssertionError(f"engine vs oracle: fame of "
                                         f"{w[:12]} in round {r}")
                fame += 1
    return dict(committed=len(got), lcr=eng.last_consensus_round,
                round_checks=rounds, fame_checks=fame,
                evicted=eng.dag.slot_base)


def phase_reference(dev, card: str, walk_out, walk_cfg, walk_dag,
                    walk_launches: int, full=REF_FULL,
                    oracle=REF_ORACLE) -> tuple:
    """Phase 13 (module docstring).  Returns the C++ baseline's result on
    config 3's DAG, which phase 12(b) holds the wide pipeline to."""
    import threading

    import numpy as np
    import torch

    from babble_tpu_torch import (
        DagConfig, assert_consensus_parity, batch_from_arrays,
        consensus_step, init_state, native, random_gossip_arrays,
    )
    from babble_tpu_torch.ops.forks import ss_counts
    from babble_tpu_torch.ops.pallas_ingest import la_walk, walk_supported
    from babble_tpu_torch.ops.ss import ss_counts_acc
    from babble_tpu_torch.sim.arrays import (
        build_schedule, build_schedule_numpy,
    )

    t_phase = time.perf_counter()
    # (a) both host libraries through the port's loader
    for name in ("graph_builder", "baseline_consensus"):
        built = os.path.exists(native.library_path(name))
        t0 = time.perf_counter()
        path = native.build(name)
        print(f"[reference] (a) {name}: {'cached' if built else 'built'} "
              f"in {time.perf_counter() - t0:.2f} s "
              f"({native.CXX} {' '.join(native.CXX_FLAGS)}) -> "
              f"{os.path.relpath(path)}", flush=True)
    native.load_baseline()

    # (b) the C++ generator against its pure-Python twin
    dags = {}
    for tag, n, e in (("slice", SLICE["n"], SLICE["e"]),
                      ("full", full["n"], full["e"])):
        t0 = time.perf_counter()
        cpp = random_gossip_arrays(n, e, seed=full["seed"])
        t_cpp = time.perf_counter() - t0
        t0 = time.perf_counter()
        twin = random_gossip_arrays(n, e, seed=full["seed"],
                                    force_python=True)
        t_py = time.perf_counter() - t0
        bad = [f for f in ARRAY_FIELDS
               if getattr(cpp, f).dtype != getattr(twin, f).dtype
               or not np.array_equal(getattr(cpp, f), getattr(twin, f))]
        if cpp.max_chain != twin.max_chain:
            bad.append("max_chain")
        if not np.array_equal(build_schedule(cpp.levels),
                              build_schedule_numpy(twin.levels)):
            bad.append("schedule")
        if bad:
            raise AssertionError(f"C++ generator != its Python twin at "
                                 f"{n} x {e}: {bad}")
        print(f"[reference] (b) random_gossip_arrays({n}, {e}, seed="
              f"{full['seed']}): C++ == Python twin on {', '.join(ARRAY_FIELDS)}, "
              f"max_chain {cpp.max_chain}, schedule ({cpp.n_levels} "
              f"levels); C++ {t_cpp * 1e3:.1f} ms, Python {t_py:.2f} s on "
              f"the card's host", flush=True)
        dags[tag] = cpp
    del twin

    # (c) BASELINE config 2: phase 4's walk step against the baseline
    t0 = time.perf_counter()
    base = native.baseline_consensus(walk_dag)
    t_base = time.perf_counter() - t0
    got = hold_to_baseline("(c) 64 x 65,536 walk step", walk_out, base,
                           walk_cfg.e_cap)
    if got != REF_EXPECT["slice"]:
        raise AssertionError(f"(c) ordered {got} != {REF_EXPECT['slice']}")
    print(f"[reference] (c) {walk_cfg.n} x {walk_cfg.e_cap} walk step "
          f"(phase 4, la_walk launches {walk_launches}) == C++ baseline on "
          f"round, witness, rr, cts and fame; ordered {got:,}; baseline "
          f"{t_base:.2f} s on the card's host", flush=True)

    # (d) BASELINE config 3 through the batch step, as run_config runs it
    dag = dags["full"]
    cfg = DagConfig(n=full["n"], e_cap=full["e"],
                    s_cap=max(full["s_cap_min"], dag.max_chain + 1),
                    r_cap=full["r_cap"])
    mode = "walk" if walk_supported(cfg.n, cfg.e_cap, cfg.s_cap) else "fast"
    batch = batch_from_arrays(dag, device=dev)
    box = {}

    def baseline():
        t0 = time.perf_counter()
        try:
            box["out"] = native.baseline_consensus(dag)
        except BaseException as exc:   # re-raised after the join
            box["err"] = exc
        box["s"] = time.perf_counter() - t0

    thread = threading.Thread(target=baseline, daemon=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    la_walk.launches = ss_counts_acc.launches = ss_counts.launches = 0
    thread.start()
    box_out = {}
    first = wall_ms(lambda: box_out.setdefault("out", consensus_step(
        cfg, mode, init_state(cfg, device=dev), batch)))
    out = box_out["out"]
    walls = []
    for _ in range(full["repeats"]):
        s0 = init_state(cfg, device=dev)
        box_out = {}
        walls.append(wall_ms(lambda: box_out.setdefault(
            "out", consensus_step(cfg, mode, s0, batch))))
    launches = dict(la_walk=la_walk.launches, ss_count=ss_counts_acc.launches,
                    fork_ss=ss_counts.launches)
    peak = torch.cuda.max_memory_allocated()
    assert_consensus_parity(out, box_out["out"], cfg.e_cap,
                            "config 3 first vs last run")
    del s0, box_out
    phases, _, _ = step_phases(cfg, mode, batch, dev)
    thread.join()
    if "err" in box:
        raise box["err"]
    base3, t_base = box["out"], box["s"]
    warm = sorted(walls)[len(walls) // 2]
    max_round = int(out.max_round.item())
    if max_round >= cfg.r_cap - 1:
        raise AssertionError(f"(d) round capacity saturated: max_round "
                             f"{max_round}, r_cap {cfg.r_cap}")
    got = hold_to_baseline("(d) config 3 batch step", out, base3,
                           cfg.e_cap)
    if got != REF_EXPECT["full"]:
        raise AssertionError(f"(d) ordered {got} != {REF_EXPECT['full']}")
    eps, base_eps = got / warm * 1e3, base3[0] / t_base
    cells = int((out.wslot[:cfg.r_cap] >= 0).sum().item())
    print(f"[reference] (d) config 3 batch step ({cfg.n} x {cfg.e_cap}, "
          f"mode {mode}, s_cap {cfg.s_cap}, r_cap {cfg.r_cap}): == C++ "
          f"baseline on round, witness, rr, cts and fame ({cells} witness "
          f"cells of {cfg.r_cap} x {cfg.n}); ordered {got:,}, max_round "
          f"{max_round}, lcr {int(out.lcr.item())}; first {first:.1f} ms, "
          f"warm {', '.join(f'{w:.1f}' for w in walls)} ms (median "
          f"{warm:.1f}: {eps:,.0f} events ordered/s); phases (ms wall) "
          f"{', '.join(f'{k} {v:.1f}' for k, v in phases.items())}; peak "
          f"{peak / 2**30:.2f} GiB; launches {launches}; C++ baseline "
          f"{t_base:.2f} s on the card's host ({base_eps:,.0f} events "
          f"ordered/s; step / baseline {eps / base_eps:.1f} x); {card}",
          flush=True)
    del out, batch
    torch.cuda.empty_cache()

    # (f) the engine on the card against the oracle on its host
    t0 = time.perf_counter()
    summary = oracle_flow(dev.type, oracle["n"], oracle["e"], oracle["seed"],
                          oracle["every"], oracle["engine"])
    print(f"[reference] (f) TorchHashgraph({dev.type}) == OracleHashgraph "
          f"on random_gossip_dag({oracle['n']}, {oracle['e']}, seed="
          f"{oracle['seed']}), run_consensus every {oracle['every']}: "
          f"{summary}; {time.perf_counter() - t0:.1f} s; phase 13 "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return base3


def _pct(xs, q: float):
    """bench.py's percentile of a list (None when empty)."""
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def prewarm_child_fused(cache_dir: str, device: str = "cuda",
                        prewarm: bool = True) -> None:
    """Phase 15(a)'s child: bench.py's ``_run_stream_child`` on the port.
    One process boot, the cache root, ``prewarm_engine`` (limit 2; none
    without ``prewarm``, as a node with ``--no_aot_prewarm`` boots),
    then ``PREWARM_STREAM`` as gossip flushes through a gated fused
    engine and one bulk flush through the throughput surface.  Prints
    one JSON line."""
    t_boot = time.perf_counter()
    from babble_tpu_torch.ops import aot

    aot.configure(cache_dir)
    import torch

    from babble_tpu_torch.consensus.engine import TorchHashgraph
    from babble_tpu_torch.sim.generator import random_gossip_dag

    def sync():
        if device.startswith("cuda"):
            torch.cuda.synchronize()

    S = PREWARM_STREAM
    dag = random_gossip_dag(S["n"], S["e"], seed=S["seed"])
    eng = TorchHashgraph(dag.participants, verify_signatures=False,
                         kernel_class="auto", finality_gate=True,
                         device=device)
    t0 = time.perf_counter()
    pre = (aot.prewarm_engine(eng, cache_dir, limit=S["limit"]) if prewarm
           else None)
    prewarm_s = time.perf_counter() - t0
    at_boot = aot.compile_counts()

    lat = {"latency": [], "throughput": []}
    first = None
    ordered = 0
    t_stream = time.perf_counter()
    for i, ev in enumerate(dag.events):
        eng.insert_event(ev.clone())
        if (i + 1) % S["every"] == 0:
            f0 = time.perf_counter()
            ordered += len(eng.run_consensus())
            sync()
            dt = time.perf_counter() - f0
            lat[eng.last_kernel_class or "latency"].append(dt)
            if first is None:
                first = dict(
                    boot_to_first_flush_s=time.perf_counter() - t_boot,
                    first_flush_s=dt,
                    first_flush_traces=(aot.compile_counts()["traces"]
                                        - at_boot["traces"]))
    stream_s = time.perf_counter() - t_stream
    traces_after_boot = aot.compile_counts()["traces"] - at_boot["traces"]

    bulk = TorchHashgraph(dag.participants, verify_signatures=False,
                          kernel_class="throughput", device=device)
    for ev in dag.events:
        bulk.insert_event(ev.clone())
    f0 = time.perf_counter()
    bulk_ordered = len(bulk.run_consensus())
    sync()
    lat["throughput"].append(time.perf_counter() - f0)
    print(json.dumps({
        **first,
        "prewarm_s": prewarm_s,
        "prewarm": pre,
        "warmed": sorted(list(k) for k in eng._aot),
        "flush_latency_s": {
            k: {"count": len(v), "p50": _pct(v, 0.5), "p95": _pct(v, 0.95),
                "max": _pct(v, 1.0)} for k, v in lat.items()},
        "stream_events_per_sec": len(dag.events) / stream_s,
        "ordered_incremental": ordered,
        "ordered_bulk": bulk_ordered,
        "commit": {"ordered": eng.commit_length,
                   "digest": eng.commit_digest},
        "traces_after_boot": traces_after_boot,
        "compile_counters": aot.compile_counts(),
    }), flush=True)


def prewarm_child_fork(cache_dir: str, warm: bool,
                       device: str = "cuda") -> None:
    """Phase 15(b)'s child: ``tests/test_torch_aot.py``'s fork child on
    the card, cold (no prewarm) or warm.  Prints one JSON line."""
    t_boot = time.perf_counter()
    from babble_tpu_torch.ops import aot

    aot.configure(cache_dir)
    import torch

    from babble_tpu_torch.consensus.fork_engine import ForkHashgraph
    from babble_tpu_torch.ops.forks import ss_counts
    from babble_tpu_torch.sim.generator import random_gossip_dag

    dag = random_gossip_dag(4, 56, seed=21)
    eng = ForkHashgraph(dag.participants, k=2, verify_signatures=False,
                        device=device)
    eng._aot_dir = cache_dir
    t0 = time.perf_counter()
    res = aot.prewarm_engine(eng, cache_dir) if warm else None
    prewarm_s = time.perf_counter() - t0
    boot, caps = aot.compile_counts(), eng._caps
    boot_launches = ss_counts.launches
    runs = []
    for i, ev in enumerate(dag.events):
        eng.insert_event(ev.clone())
        if (i + 1) % 6 == 0:
            f0 = time.perf_counter()
            eng.run_consensus()
            if device.startswith("cuda"):
                torch.cuda.synchronize()
            runs.append(time.perf_counter() - f0)
            if len(runs) == 1:
                first_s = time.perf_counter() - t_boot
    eng.run_consensus()
    print(json.dumps({
        "boot_to_first_run_s": first_s,
        "first_run_s": runs[0],
        "run_p50_s": _pct(runs, 0.5),
        "run_max_s": _pct(runs, 1.0),
        "prewarm_s": prewarm_s,
        "prewarm": res,
        "caps_at_boot": list(caps), "caps": list(eng._caps),
        "cold_dispatches": aot.compile_counts()["traces"] - boot["traces"],
        "fork_ss_launches": {"boot": boot_launches,
                             "stream": ss_counts.launches - boot_launches},
        "consensus": len(eng.consensus),
        "digest": eng.commit_digest,
        "compile_counters": aot.compile_counts(),
    }), flush=True)


def prewarm_child_manifest(cache_dir: str, device: str = "cuda") -> None:
    """Phase 15(d)'s child: a node's boot prewarm from a fleet's shared
    manifest, in a fresh process.  For each DagConfig the manifest's
    fused keys carry, a gated engine of that config warms its first key,
    then the rest; prints one JSON line with both walls."""
    t_boot = time.perf_counter()
    from babble_tpu_torch.ops import aot

    aot.configure(cache_dir)
    from babble_tpu_torch.consensus.engine import TorchHashgraph
    from babble_tpu_torch.ops.state import DagConfig

    cfgs = []
    for e in aot.load_manifest(cache_dir):
        if "key" in e and e["cfg"] not in cfgs:
            cfgs.append(e["cfg"])
    out = []
    for raw in cfgs:
        cfg = DagConfig(*[tuple(v) if isinstance(v, list) else v
                          for v in raw])
        eng = TorchHashgraph(
            {f"fleet-{i}": i for i in range(cfg.n)}, verify_signatures=False,
            e_cap=cfg.e_cap, s_cap=cfg.s_cap, r_cap=cfg.r_cap, ts32=cfg.ts32,
            packed_votes=cfg.packed, finality_gate=True, device=device)
        if tuple(eng.cfg) != tuple(cfg):
            raise AssertionError(f"cannot rebuild the manifest's config "
                                 f"{raw}: got {tuple(eng.cfg)}")
        t0 = time.perf_counter()
        first = aot.prewarm_engine(eng, cache_dir, limit=1)
        t1 = time.perf_counter()
        rest = aot.prewarm_engine(eng, cache_dir)
        t2 = time.perf_counter()
        out.append({"cfg": raw, "first_key_s": t1 - t0, "first": first,
                    "rest_s": t2 - t1, "rest": rest,
                    "since_boot_s": t2 - t_boot})
    print(json.dumps({"configs": out}), flush=True)


def _children(calls: list, timeout: float = 600) -> list:
    """Run each ``chip_smoke.<call>`` in a fresh process from this
    checkout, all at once; the last line of each one's output, parsed,
    with its process wall."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH", "")) if p)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke as c; c.{call}"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for call in calls]
    outs, failed = [], []
    try:
        for call, proc in zip(calls, procs):
            left = max(1.0, timeout - (time.perf_counter() - t0))
            stdout, stderr = proc.communicate(timeout=left)
            if proc.returncode != 0:
                failed.append(f"child {call} exited {proc.returncode}: "
                              f"{stderr[-3000:]}")
                continue
            out = json.loads(stdout.strip().splitlines()[-1])
            out["process_wall_s"] = time.perf_counter() - t0
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise AssertionError("\n".join(failed))
    return outs


def phase_prewarm(card: str, device: str = "cuda",
                  fleet_root: str = "") -> None:
    """Phase 15: the AOT prewarm, cold and warm (module docstring);
    ``fleet_root``: phase 9's shared cache root, for (d)."""
    import tempfile

    import torch

    from babble_tpu_torch.consensus.fork_engine import ForkHashgraph
    from babble_tpu_torch.consensus.wide_engine import WideHashgraph
    from babble_tpu_torch.crypto.keys import key_from_scalar
    from babble_tpu_torch.net import commands
    from babble_tpu_torch.node.core import Core
    from babble_tpu_torch.ops import aot
    from babble_tpu_torch.ops.forks import ss_counts
    from babble_tpu_torch.ops.ss import ss_counts_acc
    from babble_tpu_torch.store.checkpoint import save_checkpoint

    on_card = device.startswith("cuda")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    # (a) the fused engine: bench.py's stream child, cold then warm
    root = tempfile.mkdtemp(prefix="babble-prewarm-fused-")
    a = {tag: _children([f"prewarm_child_fused({root!r}, {device!r})"])[0]
         for tag in ("cold", "warm")}
    # and a node that boots with --no_aot_prewarm, on a root of its own
    a["off"] = _children([
        f"prewarm_child_fused({tempfile.mkdtemp()!r}, {device!r}, False)"])[0]
    for tag, c in a.items():
        lat = c["flush_latency_s"]
        print(f"[prewarm] (a) {tag}: boot to first flush "
              f"{c['boot_to_first_flush_s']:.3f} s (process wall "
              f"{c['process_wall_s']:.1f} s), prewarm {c['prewarm_s']:.3f} s "
              f"{c['prewarm']}, first flush {c['first_flush_s'] * 1e3:.1f} "
              f"ms ({c['first_flush_traces']} unwarmed dispatches); flush "
              + "; ".join(
                  f"{k} n={v['count']} p50 {v['p50'] * 1e3:.1f} / p95 "
                  f"{v['p95'] * 1e3:.1f} / max {v['max'] * 1e3:.1f} ms"
                  for k, v in lat.items() if v["count"])
              + f"; {c['stream_events_per_sec']:.1f} events/s; ordered "
              f"{c['commit']['ordered']} (bulk {c['ordered_bulk']}); "
              f"unwarmed dispatches after boot {c['traces_after_boot']}; "
              f"counters {c['compile_counters']}; {card}", flush=True)
    cold, warm = a["cold"], a["warm"]
    if not (cold["commit"] == warm["commit"] == a["off"]["commit"]
            == PREWARM_EXPECT):
        raise AssertionError(f"prewarm stream commits: cold "
                             f"{cold['commit']}, warm {warm['commit']}, "
                             f"off {a['off']['commit']}, want "
                             f"{PREWARM_EXPECT}")
    if warm["first_flush_traces"] != 0 or not warm["prewarm"]["compiled"] \
            or warm["prewarm"]["from_manifest"] != PREWARM_STREAM["limit"]:
        raise AssertionError(f"the warm child's first flush hit an unwarmed "
                             f"shape or it warmed nothing from the "
                             f"manifest: {warm}")
    print(f"[prewarm] (a) cold and warm == PREWARM_EXPECT; warm first flush "
          f"{warm['first_flush_s'] * 1e3:.1f} ms against the warm p50 "
          f"{warm['flush_latency_s']['latency']['p50'] * 1e3:.1f} ms (cold "
          f"{cold['first_flush_s'] * 1e3:.1f} ms, no prewarm "
          f"{a['off']['first_flush_s'] * 1e3:.1f} ms); {card}", flush=True)

    # (b) the fork engine: the test's child DAG cold then warm, then a
    # prewarm at config 4's width
    root = tempfile.mkdtemp(prefix="babble-prewarm-fork-")
    b = {tag: _children([f"prewarm_child_fork({root!r}, "
                         f"{tag == 'warm'}, {device!r})"])[0]
         for tag in ("cold", "warm")}
    for tag, c in b.items():
        print(f"[prewarm] (b) fork {tag}: boot to first run "
              f"{c['boot_to_first_run_s']:.3f} s (process wall "
              f"{c['process_wall_s']:.1f} s), prewarm {c['prewarm_s']:.3f} s "
              f"{c['prewarm']}, first run {c['first_run_s'] * 1e3:.1f} ms, "
              f"run p50 {c['run_p50_s'] * 1e3:.1f} / max "
              f"{c['run_max_s'] * 1e3:.1f} ms; caps at boot "
              f"{c['caps_at_boot']}, at the end {c['caps']}; cold shapes "
              f"dispatched after boot {c['cold_dispatches']}; fork_ss "
              f"launches {c['fork_ss_launches']}; committed "
              f"{c['consensus']}; counters {c['compile_counters']}; {card}",
              flush=True)
    cold, warm = b["cold"], b["warm"]
    if not (warm["consensus"] == cold["consensus"] > 0
            and warm["digest"] == cold["digest"]
            and warm["caps"] == warm["caps_at_boot"] == cold["caps"]
            and warm["cold_dispatches"] == 0 and cold["cold_dispatches"] > 0
            and warm["prewarm"]["compiled"] > 0):
        raise AssertionError(f"fork prewarm: cold {cold}, warm {warm}")
    if on_card and not (cold["fork_ss_launches"]["boot"] == 0
                        and warm["fork_ss_launches"]["boot"] > 0):
        raise AssertionError(f"the warm boot launched no fork_ss, or the "
                             f"cold one did: cold {cold}, warm {warm}")

    F = PREWARM_FORK4
    root = tempfile.mkdtemp(prefix="babble-prewarm-fork4-")
    aot.record_fork_caps(root, F["n"], F["k"], F["caps"],
                         sched=F["sched"])
    eng = ForkHashgraph({f"fork4-{i:04d}": i for i in range(F["n"])},
                        k=F["k"], device=device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ss_counts.launches = 0
    sync()
    t0 = time.perf_counter()
    res = aot.prewarm_engine(eng, root)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    print(f"[prewarm] (b) ForkHashgraph(n={F['n']}, k={F['k']}) from "
          f"phase 11(b)'s caps {F['caps']} and schedule {F['sched']}: "
          f"{res}; wall {wall:.2f} s; fork_ss launches "
          f"{ss_counts.launches}; peak {peak / 2**30:.2f} GiB; caps "
          f"{eng._caps}; {card}", flush=True)
    if eng._caps != F["caps"] or res["compiled"] != 1 \
            or (on_card and ss_counts.launches == 0):
        raise AssertionError(f"config-4 prewarm: {res}, caps "
                             f"{eng._caps}, fork_ss launches "
                             f"{ss_counts.launches}")
    del eng
    if on_card:
        torch.cuda.empty_cache()

    # (c) the wide engine: phase 12(d)'s Cores prewarmed, then a
    # prewarm at config 3's width
    root = tempfile.mkdtemp(prefix="babble-prewarm-wide-")
    ss_counts_acc.launches = 0
    t0 = time.perf_counter()
    cores = wide_replay(Core, key_from_scalar, commands, prewarm=root,
                        device=device)
    path = os.path.join(tempfile.mkdtemp(), "wide")
    save_checkpoint(cores[0].hg, path)
    got = wide_engine_summary(cores, path)
    print(f"[prewarm] (c) {WIDE_ENGINE['n']} Core(wide=True), each "
          f"engine prewarmed, x {WIDE_ENGINE['syncs']} syncs: "
          f"{'==' if got == WIDE_ENGINE_EXPECT else '!='} "
          f"WIDE_ENGINE_EXPECT (commits {got['commit_length']}); "
          f"manifest {aot.load_manifest(root)}; ss_count launches "
          f"{ss_counts_acc.launches}; {time.perf_counter() - t0:.1f} s; "
          f"{card}", flush=True)
    if got != WIDE_ENGINE_EXPECT:
        raise AssertionError(f"the prewarmed wide Cores != the JAX "
                             f"package's: {got} vs {WIDE_ENGINE_EXPECT}")
    del cores
    W = PREWARM_WIDE3
    weng = WideHashgraph(
        {f"wide3-{i:04d}": i for i in range(W["n"])},
        verify_signatures=False, e_cap=W["e_cap"], s_cap=W["s_cap"],
        r_cap=W["r_cap"], device=device)
    ss_counts_acc.launches = 0
    sync()
    t0 = time.perf_counter()
    res = aot.prewarm_engine(weng, tempfile.mkdtemp(
        prefix="babble-prewarm-wide3-"))
    wall = time.perf_counter() - t0
    print(f"[prewarm] (c) WideHashgraph(n={W['n']}, e_cap={W['e_cap']}, "
          f"s_cap={W['s_cap']}, r_cap={W['r_cap']}, C={weng.stream.C}): "
          f"{res}; wall {wall:.2f} s; ss_count launches "
          f"{ss_counts_acc.launches}; {card}", flush=True)
    if on_card and ss_counts_acc.launches == 0:
        raise AssertionError("the wide prewarm launched no ss_count")
    del weng
    if on_card:
        torch.cuda.empty_cache()

    # (d) phase 9's fleet: a node's boot prewarm from the fleet's shared
    # manifest, its first key and the rest apart
    if fleet_root:
        d = _children([f"prewarm_child_manifest({fleet_root!r}, "
                       f"{device!r})"])[0]
        for c in d["configs"]:
            print(f"[prewarm] (d) phase 9's manifest, config {c['cfg']}: "
                  f"first key {c['first_key_s']:.3f} s {c['first']}, the "
                  f"other {c['rest']['compiled']} keys {c['rest_s']:.3f} s "
                  f"({c['rest_s'] / max(c['rest']['compiled'], 1) * 1e3:.1f} "
                  f"ms a key); {c['since_boot_s']:.1f} s from the child's "
                  f"start (process wall {d['process_wall_s']:.1f} s); {card}",
                  flush=True)
        if not d["configs"]:
            raise AssertionError(f"phase 9's fleet recorded no fused key in "
                                 f"{fleet_root}")
    print(f"[prewarm] phase 15: {time.perf_counter() - t_phase:.1f} s; "
          f"{card}", flush=True)


# ----------------------------------------------------------------------
# phase 16: the multi-device layer (babble_tpu_torch/parallel/)


def mesh_inputs(root: str) -> None:
    """Phase 11(b)'s fork batch (BYZ_FULL) written once as host arrays
    into ``root``, for every rank to load (the numpy build is the slow
    part; the gossip DAGs come from the C++ generator in milliseconds)."""
    import numpy as np

    from babble_tpu_torch.sim.arrays import random_byzantine_fork_arrays

    full = {k: v for k, v in BYZ_FULL.items() if k not in ("n", "e")}
    cfg, arrays = random_byzantine_fork_arrays(BYZ_FULL["n"], BYZ_FULL["e"],
                                               **full)
    np.savez(os.path.join(root, "fork.npz"), **arrays)
    with open(os.path.join(root, "fork_cfg.json"), "w") as f:
        json.dump(list(cfg), f)


def tensors_digest(named) -> str:
    """SHA-256 over ``(name, tensor)`` pairs, each in its dtype's bytes."""
    import numpy as np

    h = hashlib.sha256()
    for name, t in named:
        a = t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)
        h.update(name.encode() + str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def mesh_programs(mesh, dev, root: str, runs: int = 2,
                  check: bool = False) -> tuple:
    """Phase 16's four programs on this rank of ``mesh`` (module
    docstring), each run ``runs`` times from fresh inputs: the sharded
    step at config 3, the walk step at config 2, the fork step at
    config 4 and the stream at config 3.  Returns (report, outputs,
    checks): per program its digest, walls, launches, the columns its
    compare-counts saw, its collectives and peak memory; the last run's
    gathered outputs; and, with ``check``, ``MeshKernelCapture``'s
    record (else {}).  The walls, launches and collectives cover the
    program alone: the gather of its outputs over the mesh and their
    digest come after.  With ``check`` the fork step's and the stream's
    runs carry the capture hooks (device copies of the compared calls'
    inputs and results); the comparisons come after."""
    import torch

    from babble_tpu_torch import (
        DagConfig, batch_from_arrays, random_gossip_arrays,
    )
    from babble_tpu_torch.ops import forks as F
    from babble_tpu_torch.ops.pallas_ingest import la_walk
    from babble_tpu_torch.ops.ss import ss_counts_acc
    from babble_tpu_torch.ops.state import consensus_digest
    from babble_tpu_torch.ops.stream import stream_consensus
    from babble_tpu_torch.parallel import collectives
    from babble_tpu_torch.parallel.sharded import (
        gather_fork_out, gather_state, make_sharded_fork_step,
        make_sharded_step, pad_cfg_for_mesh, pad_fork_for_mesh,
        sharded_init_state,
    )
    import numpy as np

    g3 = random_gossip_arrays(REF_FULL["n"], REF_FULL["e"],
                              seed=REF_FULL["seed"])
    g2 = random_gossip_arrays(SLICE["n"], SLICE["e"], seed=SLICE["seed"])
    with open(os.path.join(root, "fork_cfg.json")) as f:
        fcfg = F.ForkConfig(*json.load(f))
    fbatch = F.fork_batch_from_numpy(
        dict(np.load(os.path.join(root, "fork.npz"))), dev)
    fcfg, fbatch = pad_fork_for_mesh(fcfg, fbatch, mesh)

    # each program: (run -> (result at rest, shard), collect -> (whole
    # output, digest))
    def step_program(dag, mode, s_cap, r_cap):
        cfg = pad_cfg_for_mesh(DagConfig(n=dag.n, e_cap=dag.n_events,
                                         s_cap=s_cap, r_cap=r_cap), mesh)
        batch = batch_from_arrays(dag, device=dev)

        def run():
            step = make_sharded_step(cfg, mesh, mode)
            return step(sharded_init_state(cfg, mesh), batch), step.shard

        def collect(res):
            out = gather_state(res, mesh)
            return out, consensus_digest(out, dag.n_events)
        return run, collect

    capture = MeshKernelCapture() if check else None

    def fork_run():
        step = make_sharded_fork_step(
            fcfg, mesh, ss=capture.fork_ss if check else None)
        return step(fbatch), step.shard

    def fork_collect(res):
        out = gather_fork_out(res, mesh)
        ne = BYZ_FULL["e"]
        return out, tensors_digest(
            (f, t[:ne] if t.dim() and t.shape[0] == fcfg.e_cap + 1 else t)
            for f, t in zip(out._fields, out))

    scfg = DagConfig(n=REF_FULL["n"], e_cap=REF_FULL["e"],
                     s_cap=g3.max_chain + 3, r_cap=REF_FULL["r_cap"])

    def stream_run():
        with (capture.capturing() if check else contextlib.nullcontext()):
            st = stream_consensus(scfg, g3, mesh=mesh, **MESH_STREAM)
        return st, st.shard

    def stream_collect(st):
        keys = sorted(st.ordered)
        h = hashlib.sha256(json.dumps(
            [[k, *st.ordered[k]] for k in keys]
            + [st.lcr, st.evicted, st.e_off]).encode())
        return st, h.hexdigest()

    programs = {
        "step": step_program(g3, "fast",
                             max(REF_FULL["s_cap_min"], g3.max_chain + 1),
                             REF_FULL["r_cap"]),
        "walk": step_program(g2, "walk", g2.max_chain + 1, SLICE["r_cap"]),
        "fork": (fork_run, fork_collect),
        "stream": (stream_run, stream_collect),
    }
    report, outputs = {}, {}
    for name, (run, collect) in programs.items():
        walls, peak = [], 0
        for _ in range(runs):
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            la_walk.launches = F.ss_counts.launches = 0
            ss_counts_acc.launches = 0
            collectives.reset_stats()
            t0 = time.perf_counter()
            res, shard = run()
            torch.cuda.synchronize(dev)
            walls.append((time.perf_counter() - t0) * 1e3)
            peak = max(peak, torch.cuda.max_memory_allocated(dev))
            launches = dict(la_walk=la_walk.launches,
                            fork_ss=F.ss_counts.launches,
                            ss_count=ss_counts_acc.launches)
            sent = collectives.stats()
        out, digest = collect(res)
        report[name] = dict(
            digest=digest, runs=runs, first_ms=walls[0], warm_ms=walls[-1],
            launches=launches, columns=shard.widths(), collectives=sent,
            peak_gib=peak / 2 ** 30,
        )
        outputs[name] = out
        del out, res
        torch.cuda.empty_cache()
    return report, outputs, capture.verify() if check else {}


class MeshKernelCapture:
    """fork_ss and ss_count held to their plain twins at the shapes a
    sharded run hands them.  ``fork_ss`` is the fork step's ``ss=``
    hook and ``ss_count`` stands in for ``ops.wide``'s
    ``ss_counts_acc`` during the stream (``capturing``); each calls the
    kernel and keeps device copies of its inputs and result: the first
    fork_ss call of each distinct shape (the plain twin takes seconds a
    call at this size), every ss_count call.  ``verify``, after the
    run and outside its wall, compares each kept result exactly with
    ``ss_counts_plain`` (the int32 rows, det cut to the rank's
    creators) or ``ss_counts_compare`` over the rank's blocks, raises
    on the first difference, and returns per kernel the calls, the
    calls compared, the shapes compared and the columns each saw."""

    def __init__(self):
        self.kept = {"fork_ss": [], "ss_count": []}
        self.rec = {kern: dict(calls=0, compared=0, shapes=[], columns=[])
                    for kern in self.kept}

    def _note(self, kern, key, cols, every=False) -> bool:
        r = self.rec[kern]
        r["calls"] += 1
        if key in r["shapes"] and not every:
            return False
        if key not in r["shapes"]:
            r["shapes"].append(key)
        if cols not in r["columns"]:
            r["columns"].append(cols)
        return True

    def fork_ss(self, la_x, det_x, helper_w, k, window=None):
        from babble_tpu_torch.ops import forks as F

        got = F.ss_counts(la_x, det_x, helper_w, k, window=window)
        key = [list(la_x.shape), list(helper_w.shape), window is None]
        if self._note("fork_ss", key, int(la_x.shape[-1])):
            self.kept["fork_ss"].append((key, k, la_x.clone(), det_x.clone(),
                                         helper_w.clone(), got.clone()))
        return got

    def ss_count(self, rows_a, rows_b, acc):
        before = acc.clone()
        got = self._kernel_acc(rows_a, rows_b, acc)
        key = [list(rows_a.shape), list(rows_b.shape)]
        self._note("ss_count", key, int(rows_a.shape[0] * rows_a.shape[-1]),
                   every=True)
        self.kept["ss_count"].append((key, rows_a.clone(), rows_b.clone(),
                                      before, got.clone()))
        return got

    @contextlib.contextmanager
    def capturing(self):
        from babble_tpu_torch.ops import wide as W

        self._kernel_acc = W.ss_counts_acc
        W.ss_counts_acc = self.ss_count
        try:
            yield self
        finally:
            W.ss_counts_acc = self._kernel_acc

    def verify(self) -> dict:
        import torch

        from babble_tpu_torch.ops import forks as F
        from babble_tpu_torch.ops.ss import ss_counts_compare

        for key, k, la_x, det_x, helper_w, got in self.kept["fork_ss"]:
            want = F.ss_counts_plain(la_x, det_x, helper_w, k)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"fork_ss on the rank's creators != ss_counts_plain at "
                    f"{key}: {int((got != want).sum())} counts differ")
        for key, rows_a, rows_b, want, got in self.kept["ss_count"]:
            for c in range(rows_a.shape[0]):
                want += ss_counts_compare(rows_a[c], rows_b[c])
            if not torch.equal(got, want):
                raise AssertionError(
                    f"ss_count on the rank's blocks != ss_counts_compare at "
                    f"{key}: {int((got != want).sum())} counts differ")
        for kern, kept in self.kept.items():
            self.rec[kern]["compared"] = len(kept)
            if not kept:
                raise AssertionError(f"{kern} was never called in its "
                                     f"captured sharded run: {self.rec[kern]}")
        self.kept = {kern: [] for kern in self.kept}
        torch.cuda.empty_cache()
        return self.rec


def mesh_worker(rank: int, world: int, dev, shape, root: str) -> None:
    """Phase 16(b)'s rank: the four programs on a ``shape`` mesh of the
    gloo group; rank 0 writes every rank's report to ``root``."""
    import torch.distributed as dist

    from babble_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(world, shape=tuple(shape), device=dev)
    report, outputs, checks = mesh_programs(mesh, dev, root, runs=1,
                                            check=world == MESH_CHECKED)
    del outputs
    every = [None] * world
    dist.all_gather_object(every, dict(report=report, checks=checks))
    if rank == 0:
        with open(os.path.join(root, f"group_{world}.json"), "w") as f:
            json.dump(every, f)


def mesh_line(tag: str, rank: int, name: str, r: dict) -> str:
    walls = (f"first {r['first_ms']:.1f} ms, warm {r['warm_ms']:.1f} ms"
             if r["runs"] > 1 else f"one run {r['first_ms']:.1f} ms")
    return (f"[mesh] {tag} rank {rank} {name}: {walls}; launches "
            f"{r['launches']}; "
            f"compare-count columns {r['columns']}; collectives "
            f"{r['collectives']}; peak {r['peak_gib']:.2f} GiB")


#: the kernel each program's run must launch (the honest step at
#: n = 1,024 takes mode "fast": no hand-written kernel on its path)
MESH_KERNEL = {"step": None, "walk": "la_walk", "fork": "fork_ss",
               "stream": "ss_count"}


def check_mesh_report(tag: str, report: dict, want: dict) -> None:
    for name, r in report.items():
        if r["digest"] != want[name]:
            raise AssertionError(f"{tag} {name}: output digest "
                                 f"{r['digest']} != (a)'s {want[name]}")
        kernel = MESH_KERNEL[name]
        if kernel and r["launches"][kernel] < 1:
            raise AssertionError(f"{tag} {name}: {kernel} never launched "
                                 f"on its sharded path: {r['launches']}")


def phase_mesh(dev, card: str) -> dict:
    """Phase 16 (module docstring).  Returns each kernel's launches in
    (a)'s run of its program."""
    import socket
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from babble_tpu_torch import (
        DagConfig, assert_consensus_parity, batch_from_arrays,
        consensus_step, init_state, random_gossip_arrays,
    )
    from babble_tpu_torch.ops import forks as F
    from babble_tpu_torch.ops.stream import stream_consensus
    from babble_tpu_torch.parallel.dryrun import spawn_ranks
    from babble_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="mesh16_")
    t0 = time.perf_counter()
    mesh_inputs(root)
    print(f"[mesh] inputs (phase 11(b)'s fork arrays) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (a) one NCCL rank on the card, a real process group
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        one = torch.ones(4, device=dev)
        dist.all_reduce(one)
        mesh = make_mesh(1, device=dev)
        print(f"[mesh] (a) NCCL {torch.cuda.nccl.version()} world 1: "
              f"{mesh}; all_reduce {one.tolist()}", flush=True)
        report, outputs, _ = mesh_programs(mesh, dev, root)
    finally:
        dist.destroy_process_group()
    for name, r in report.items():
        print(mesh_line("(a) nccl 1", 0, name, r) + f"; {card}", flush=True)

    # (a)'s outputs against the single-device port
    g3 = random_gossip_arrays(REF_FULL["n"], REF_FULL["e"],
                              seed=REF_FULL["seed"])
    cfg3 = DagConfig(n=REF_FULL["n"], e_cap=REF_FULL["e"],
                     s_cap=max(REF_FULL["s_cap_min"], g3.max_chain + 1),
                     r_cap=REF_FULL["r_cap"])
    ref = consensus_step(cfg3, "fast", init_state(cfg3, device=dev),
                         batch_from_arrays(g3, device=dev))
    assert_consensus_parity(ref, outputs["step"], cfg3.e_cap, "(a) step")
    del ref
    g2 = random_gossip_arrays(SLICE["n"], SLICE["e"], seed=SLICE["seed"])
    cfg2 = DagConfig(n=SLICE["n"], e_cap=SLICE["e"],
                     s_cap=g2.max_chain + 1, r_cap=SLICE["r_cap"])
    ref = consensus_step(cfg2, "walk", init_state(cfg2, device=dev),
                         batch_from_arrays(g2, device=dev))
    assert_consensus_parity(ref, outputs["walk"], cfg2.e_cap, "(a) walk")
    del ref
    with open(os.path.join(root, "fork_cfg.json")) as f:
        fcfg = F.ForkConfig(*json.load(f))
    fref = F.fork_pipeline(fcfg, F.fork_batch_from_numpy(
        dict(np.load(os.path.join(root, "fork.npz"))), dev))
    for name, a in zip(fref._fields, fref):
        if not torch.equal(a, getattr(outputs["fork"], name)):
            raise AssertionError(f"(a) fork step != fork_pipeline on {name}")
    del fref
    scfg = DagConfig(n=REF_FULL["n"], e_cap=REF_FULL["e"],
                     s_cap=g3.max_chain + 3, r_cap=REF_FULL["r_cap"])
    sref = stream_consensus(scfg, g3, stacked=True, device=dev,
                            **MESH_STREAM)
    st = outputs["stream"]
    if (st.ordered, st.lcr, st.evicted) != (sref.ordered, sref.lcr,
                                            sref.evicted) \
            or st.ordered_total != REF_EXPECT["full"]:
        raise AssertionError(f"(a) mesh stream != the stacked stream: "
                             f"{st.ordered_total} / {sref.ordered_total} "
                             f"ordered, lcr {st.lcr} / {sref.lcr}")
    del outputs, sref, st
    torch.cuda.empty_cache()
    want = {name: r["digest"] for name, r in report.items()}
    check_mesh_report("(a)", report, want)
    print(f"[mesh] (a) == the single-device port: step at config 3 "
          f"(every consensus field), walk at config 2, fork at config 4 "
          f"(every ForkOut field), stream at config 3 (ordered "
          f"{REF_EXPECT['full']:,}, the C++ baseline's count)", flush=True)

    # (b) gloo groups, every rank on this card
    for ranks, shape in MESH_GROUPS:
        t0 = time.perf_counter()
        spawn_ranks(mesh_worker, ranks, "gloo", "cuda", list(shape), root)
        wall = time.perf_counter() - t0
        with open(os.path.join(root, f"group_{ranks}.json")) as f:
            every = json.load(f)
        tag = f"(b) gloo {ranks} mesh {shape}"
        for rank, got in enumerate(every):
            rep = got["report"]
            check_mesh_report(f"{tag} rank {rank}", rep, want)
            for name, r in rep.items():
                print(mesh_line(tag, rank, name, r), flush=True)
            if ranks == MESH_CHECKED:
                if set(got["checks"]) != {"fork_ss", "ss_count"}:
                    raise AssertionError(f"{tag} rank {rank}: the kernel "
                                         f"check did not run: {got['checks']}")
                for kern, r in got["checks"].items():
                    print(f"[mesh] {tag} rank {rank} {kern} == its plain "
                          f"twin on the shard, exact: {r['compared']} of "
                          f"{r['calls']} calls compared, shapes "
                          f"{r['shapes']}, columns {r['columns']}",
                          flush=True)
        print(f"[mesh] {tag}: every rank == (a) on all four programs; "
              f"group wall {wall:.1f} s (spawn, inputs, one run each); "
              f"the {ranks} ranks share one card, so these walls are not "
              f"a multi-GPU speed; {card}", flush=True)
    print(f"[mesh] phase 16 {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {MESH_KERNEL[n]: r["launches"][MESH_KERNEL[n]]
            for n, r in report.items() if MESH_KERNEL[n]}


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
    logs = cuda_build.build(["la_walk", "fork_ss", "ss_count"])
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in logs.items():
        print(f"[build] {name}:\n{text.strip()}", flush=True)
    kernel_resources()
    kernel_sass(cuda_build.library_path("ss_count"), "ss_count", "ss_count")
    kernel_sass(cuda_build.library_path("fork_ss"),
                "fork_ss_packed_kernelILi2E", "fork_ss")
    kernel_sass(cuda_build.library_path("fork_ss"), "fork_ss_kernelILi2E",
                "fork_ss int32")

    row = phase_kernel(dev)
    launches, step_ms, out, cfg, dag, ingested = phase_slice(dev, card)
    row["launches"] = launches
    print(f"[slice] la_walk share of the walk step: "
          f"{row['ms'] * launches / step_ms:.4f}", flush=True)
    base3 = phase_reference(dev, card, out, cfg, dag, launches)
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

    t0 = time.perf_counter()
    fleet_root = phase_tcp_testnet(card)
    print(f"[tcp] phase 9: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_host_tools(card)
    print(f"[host] phase 14: {time.perf_counter() - t0:.1f} s", flush=True)

    la_walk.launches = 0
    t0 = time.perf_counter()
    phase_chaos_sweep(card)
    t1 = time.perf_counter()
    phase_chaos_live(card)
    if la_walk.launches:
        raise AssertionError("the chaos sweep launched la_walk")
    print(f"[chaos] la_walk launches in phase 10: 0; phase 10 "
          f"{time.perf_counter() - t0:.1f} s ((a) {t1 - t0:.1f} s, (b) "
          f"{time.perf_counter() - t1:.1f} s)", flush=True)

    byz_row = phase_byzantine(dev, card)
    wide_row = phase_wide(dev, card, base3)
    phase_prewarm(card, fleet_root=fleet_root)
    mesh = phase_mesh(dev, card)
    for r, kernel in ((row, "la_walk"), (byz_row, "fork_ss"),
                      (wide_row, "ss_count")):
        r["mesh_launches"] = mesh[kernel]

    print(card_line(), flush=True)
    print(json.dumps({"kernels": [row, byz_row, wide_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
