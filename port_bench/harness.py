"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

Driven by data: the cell names a configuration and a traffic mix; the
configuration names the program's entry (``entries/<entry>.py``) and
its plain reference (``reference/<name>.py``); the metrics are read by
``metrics/<metric>.py``.  Nothing here names a cell.
"""

from __future__ import annotations

import sys
import time

import torch

from . import compare, spec
from .trace import Tracer, device_info


def run_cell(bench: dict, cell: dict, seed: int, seconds: int, trace: bool,
             t_start: float, device="cuda", config=None, traffic=None) -> dict:
    """Runs ``cell`` once and returns the result line's object.
    ``config``/``traffic`` stand in for the files (tests run tiny
    versions on the CPU)."""
    config = config or spec.config(bench, cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    entry = spec.entry(config["entry"])
    reference = spec.reference(config["reference"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    tracer = Tracer(entry.recorders()) if trace and cuda else None
    session = entry.Session(config, traffic, seed, device=dev,
                            trace=tracer)
    session.warm_up()
    if tracer is not None:
        tracer.warm_up()
    setup_s = time.perf_counter() - t_start

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    window_s = session.window(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    info = device_info() if cuda else None
    if tracer is not None:
        tracer.finish()

    job = session.pick_job()
    batches = session.batches
    session.release()
    t_ref = time.perf_counter()
    ref = reference.consensus(job.dag, device=dev)
    checks = compare.check(job, ref)
    print(f"port_bench: window {window_s:.3f} s, {len(batches)} batches, "
          f"{len(session.records)} jobs; checked job "
          f"{session.records.index(job)} ({'whole' if job.completed else 'cut'})"
          f"; reference and check {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    correct = compare.passed(checks)

    run = {
        "window_s": window_s, "setup_s": setup_s, "peak_bytes": peak,
        "ordered": sum(b["ordered"] for b in batches), "batches": batches,
        "trace": tracer.summary if tracer else None, "device_info": info,
        "calls": ({k: r.calls for k, r in tracer.recorders.items()}
                  if tracer else {}),
    }
    metrics = {}
    for m in spec.metrics(bench, cell["name"], trace):
        v = spec.metric_reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    result = {
        "correct": correct, "attempted": len(batches), "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": info["name"] if info else str(dev),
            "count": int(cell["chips"]),
            "memory_peak_bytes": peak,
        },
    }
    if tracer is not None and tracer.summary is not None:
        s = tracer.summary
        result["device"].update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = {"device_ops": s["device_ops"],
                               "idle_gaps": s["idle_gaps"]}
    result["checks"] = {c["name"]: {"value": c["value"],
                                    "limit": f"{c['op']} {c['limit']}"}
                        for c in checks}
    for c in checks:
        print(f"check {c['name']} {c['value']} (limit {c['op']} "
              f"{c['limit']})", file=sys.stderr)
    return result
