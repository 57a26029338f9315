"""Profile one batch consensus step on the card.

    python -m babble_tpu_torch.profile_step [--mode walk|fast]

Runs the slice configuration (64 participants x 65,536 events, seed 7,
r_cap 512) once to warm up, then once under ``torch.profiler`` with CPU
and CUDA activities, and prints: the step's wall time, the number of
device kernels it ran, the device busy share (the union of kernel
intervals over the wall time; 1 - busy is the idle share) and the ten
kernels with the most device time.  It needs a CUDA card and fails
without one.
"""

from __future__ import annotations

import argparse
import json
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


def main(argv=None) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from . import batch_from_arrays, consensus_step, init_state
    from .ops.state import DagConfig
    from .sim.arrays import random_gossip_arrays

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("walk", "fast"), default="walk")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    dag = random_gossip_arrays(64, 65536, seed=7)
    cfg = DagConfig(n=64, e_cap=65536, s_cap=dag.max_chain + 1, r_cap=512)
    batch = batch_from_arrays(dag, device=dev)
    consensus_step(cfg, args.mode, init_state(cfg, device=dev), batch)
    state0 = init_state(cfg, device=dev)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        consensus_step(cfg, args.mode, state0, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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
          f"wall {wall_us / 1e3:.1f} ms; {len(kernels)} device activities; "
          f"device busy {busy / 1e3:.1f} ms = {busy / wall_us:.4f} of wall")
    for name, (t, c) in top:
        print(f"[profile]   {t / 1e3:9.3f} ms  x{c:<6d} {name[:90]}")
    print(json.dumps({
        "mode": args.mode, "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3, "busy_share": busy / wall_us,
        "device_activities": len(kernels),
        "top": [{"name": n[:120], "ms": t / 1e3, "count": c}
                for n, (t, c) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
