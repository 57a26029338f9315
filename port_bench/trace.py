"""The traced run's instruments: a ``torch.profiler`` window over a
bounded part of the measured window, its reduction to device busy time,
kernel time by name and idle gaps by host stage, and the shapes of the
compare-count calls made while it records.

The reduction is the one ``chip_smoke.py trace_busy`` uses (the union of
kernel, copy and set intervals over the span of every recorded event),
copied here so that the yardstick cannot change with the program.  The
trace file goes under ``TMPDIR`` and is deleted once read.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def device_info() -> dict:
    """The card's name, SM count, maximum SM clock and power limit
    (``nvidia-smi``); clock and limit are None where it cannot say."""
    props = torch.cuda.get_device_properties(0)
    info = {"name": torch.cuda.get_device_name(0),
            "sm_count": int(props.multi_processor_count),
            "sm_clock_max_hz": None, "power_limit_w": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm,power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=60, check=True)
        clock, limit = (v.strip() for v in out.stdout.splitlines()[0].split(","))
        info["sm_clock_max_hz"] = float(clock) * 1e6
        info["power_limit_w"] = float(limit)
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return info


class CallRecorder:
    """Records the shapes of the calls of a program function: those made
    through ``wrap(fn)``, and while active (``start``/``stop``) every
    call of ``module.<attr>``, which is wrapped in place and restored."""

    def __init__(self, shape_of, module=None, attr=None):
        self.shape_of, self.module, self.attr = shape_of, module, attr
        self.calls: List[tuple] = []
        self._orig = None

    def wrap(self, fn):
        def wrapped(*args, **kw):
            self.calls.append(self.shape_of(*args, **kw))
            return fn(*args, **kw)

        return wrapped

    def start(self) -> None:
        if self.module is not None:
            self._orig = getattr(self.module, self.attr)
            setattr(self.module, self.attr, self.wrap(self._orig))

    def stop(self) -> None:
        if self._orig is not None:
            setattr(self.module, self.attr, self._orig)
            self._orig = None


class Tracer:
    """One profiler window, started and stopped by the entry at batch
    boundaries; ``recorders`` run alongside it.  ``finish`` reads the
    trace once the measured window has closed."""

    def __init__(self, recorders: Optional[Dict[str, CallRecorder]] = None):
        self.recorders = recorders or {}
        self.summary: Optional[dict] = None
        self.active = False
        self._prof = None

    @staticmethod
    def _profile():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def warm_up(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        (CUPTI's initialisation) takes seconds, and would otherwise fall
        inside the window."""
        with self._profile():
            torch.ones(8).add_(1)
            _sync()

    def start(self) -> None:
        _sync()
        self._prof = self._profile()
        self._prof.__enter__()
        for r in self.recorders.values():
            r.start()
        self.active = True

    def stop(self) -> None:
        _sync()
        for r in self.recorders.values():
            r.stop()
        self._prof.__exit__(None, None, None)
        self.active = False

    def finish(self) -> None:
        """Export and reduce the trace (after the measured window)."""
        if self._prof is None:
            return
        fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.summary = reduce_trace(json.load(f))
        finally:
            os.unlink(path)
        self._prof = None


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _merge(spans):
    out = []
    for t0, t1 in sorted(spans):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def reduce_trace(trace: dict) -> dict:
    """A Chrome trace -> ``busy_s`` (union of device activity),
    ``window_s`` (span of every event), ``kernels_s`` (device seconds by
    kernel name), ``device_ops`` and ``idle_gaps`` (the ten largest, as
    ``[name, seconds]``; a gap is named by the benchmark's host stage
    and the innermost host operation open at its middle)."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    spans = _merge((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev)
    busy = sum(t1 - t0 for t0, t1 in spans)
    window = (max(float(e["ts"]) + float(e["dur"]) for e in events)
              - min(float(e["ts"]) for e in events)) if events else 0.0
    kernels: Dict[str, float] = defaultdict(float)
    for e in dev:
        kernels[e.get("name", "?")] += float(e["dur"]) * 1e-6

    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("name", "?"), e.get("cat"))
                  for e in events if e.get("cat") in ("cpu_op",
                                                      "user_annotation"))
    gaps: Dict[str, float] = defaultdict(float)
    i, open_ = 0, []
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        mid = (a1 + b0) / 2
        while i < len(host) and host[i][0] <= mid:
            open_.append(host[i])
            i += 1
        open_ = [h for h in open_ if h[1] >= mid]
        stage, op, op_len = "outside", "python", float("inf")
        for t0, t1, name, cat in open_:
            if cat == "user_annotation" and name.startswith("bench."):
                stage = name
            elif cat == "cpu_op" and t1 - t0 < op_len:
                op, op_len = name, t1 - t0
        gaps[f"{stage}:{op}"] += (b0 - a1) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"busy_s": busy * 1e-6, "window_s": window * 1e-6,
            "kernels_s": dict(kernels), "device_ops": top(kernels),
            "idle_gaps": top(gaps)}
