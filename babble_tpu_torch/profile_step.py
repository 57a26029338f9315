"""Profile one batch consensus step, one live flush, or one call of a
live node's engine, on the card.

    python -m babble_tpu_torch.profile_step [--mode walk|fast|live|engine]

Modes ``walk`` and ``fast`` run the slice configuration (64
participants x 65,536 events, seed 7, r_cap 512) once to warm up, then
once under ``torch.profiler`` with CPU and CUDA activities.  Mode
``live`` streams the same DAG (``packed``, gated, flushes of 256
events) up to slot 32,768, runs the next flush once to warm up, then
profiles that flush again from the same state.  Mode ``engine`` builds
the engine a live node builds (``node_engine_kwargs()``), feeds it the
same DAG as events, 256 per ``run_consensus``, up to slot 32,768, runs
one more call to warm up and profiles the next one (its inserts
included).  It prints: the wall time, the number of device activities
(kernels and copies), the device busy share (the union of their
intervals over the wall time; 1 - busy is the idle share), the ten
kernels with the most device time and, for ``live`` and ``engine``, the
host span of each region (``engine``: the inserts, ``build_batch``, the
flush's phases and ``_collect_ordered`` with its compaction).  It needs
a CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


#: the record_function regions of ops/flush.py live_flush_impl
PHASES = ("babble_ingest", "babble_fame", "babble_order")
#: the engine's dispatch regions (consensus/engine.py), and the host
#: regions the engine mode wraps around inserts, batch building and the
#: commit
ENGINE_REGIONS = ("babble_flush_latency", "babble_flush_ingest",
                  "babble_flush_fame", "babble_flush_order",
                  "babble_insert", "babble_build_batch", "babble_collect")
#: the live mode's flush size and the slot of the profiled flush
LIVE_CHUNK = 256
LIVE_MID = 32768


def _live_flush(cfg, dag, dev):
    """Stream ``dag`` (gated) up to slot LIVE_MID and return a function
    that runs the next flush from that state (flushes do not modify
    their input state, so it can run twice)."""
    from .ops.flush import live_flush_impl
    from .sim.live import (
        chunk_levels, flush_shape, live_stream, read_mirrors, stream_batch,
    )

    state, _ = live_stream(cfg, dag, LIVE_CHUNK, True, device=dev,
                           stop=LIVE_MID, drain=False)
    lo, hi = LIVE_MID, LIVE_MID + LIVE_CHUNK
    W, F = flush_shape(cfg, read_mirrors(state), hi - lo,
                       chunk_levels(dag, lo, hi), True)
    batch = stream_batch(dag, lo, hi, dev)
    print(f"[profile] live flush at slot {lo}: k {hi - lo}, W {W}, F {F}, "
          f"sched {tuple(batch.sched.shape)}")
    return lambda: live_flush_impl(cfg, W, F, True, state, batch)


def _engine_call(dag, dev):
    """Feed ``dag`` as events to a live node's engine up to slot LIVE_MID
    (256 per call) and return a function that runs the next call, its
    inserts included; each call of it takes the next 256 events."""
    from torch.profiler import record_function

    from .consensus.engine import TorchHashgraph, node_engine_kwargs
    from .sim.arrays import events_from_arrays

    events = events_from_arrays(dag)
    eng = TorchHashgraph(dag.participants(), verify_signatures=False,
                         device=dev, **node_engine_kwargs())

    def regioned(name, fn):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    eng.build_batch = regioned("babble_build_batch", eng.build_batch)
    eng._collect_ordered = regioned("babble_collect", eng._collect_ordered)
    pos = [0]

    def call():
        lo = pos[0]
        with record_function("babble_insert"):
            for ev in events[lo:lo + LIVE_CHUNK]:
                eng.insert_event(ev)
        pos[0] = lo + LIVE_CHUNK
        return eng.run_consensus()

    while pos[0] < LIVE_MID:
        call()
    print(f"[profile] engine at slot {LIVE_MID}: {eng.stats_snapshot()}, "
          f"cfg e_cap {eng.cfg.e_cap} r_cap {eng.cfg.r_cap}")
    return call


def main(argv=None) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from . import batch_from_arrays, consensus_step, init_state
    from .ops.state import DagConfig
    from .sim.arrays import random_gossip_arrays

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("walk", "fast", "live", "engine"),
                    default="walk")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[profile] {card}")
    dag = random_gossip_arrays(64, 65536, seed=7)
    cfg = DagConfig(n=64, e_cap=65536, s_cap=dag.max_chain + 1, r_cap=512)
    if args.mode == "live":
        run = _live_flush(cfg._replace(packed=True), dag, dev)
    elif args.mode == "engine":
        run = _engine_call(dag, dev)
    else:
        batch = batch_from_arrays(dag, device=dev)
        state0 = init_state(cfg, device=dev)

        def run():
            return consensus_step(cfg, args.mode, state0, batch)

    run()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    # device activities; a record_function region also leaves a device
    # span (a user annotation), which is no work of the card
    regions_all = PHASES + ENGINE_REGIONS
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in regions_all]
    if not kernels:
        print("profile_step: the profiler recorded no device activity",
              file=sys.stderr)
        return 1
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    print(f"[profile] {torch.cuda.get_device_name(0)}; mode {args.mode}; "
          f"wall {wall_us / 1e3:.3f} ms; {len(kernels)} device activities; "
          f"device busy {busy / 1e3:.3f} ms = {busy / wall_us:.4f} of wall")
    for name, (t, c) in top:
        print(f"[profile]   {t / 1e3:9.3f} ms  x{c:<6d} {name[:90]}")
    regions = {}
    for e in prof.events():
        if e.name in regions_all and e.device_type != DeviceType.CUDA:
            regions[e.name] = regions.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    if regions:
        print("[profile] phase regions (host span, ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in regions.items()))
    print(json.dumps({
        "mode": args.mode, "card": card, "device": torch.cuda.get_device_name(0),
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3, "busy_share": busy / wall_us,
        "device_activities": len(kernels), "phase_regions_ms": regions,
        "top": [{"name": n[:120], "ms": t / 1e3, "count": c}
                for n, (t, c) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
