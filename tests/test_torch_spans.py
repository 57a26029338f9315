"""Stage spans and host-read counters inside the benchmarked paths
(``babble_tpu_torch/obs/spans.py``; ``ops/stream.py``, ``ops/wide.py``,
``ops/forks.py``) and the per-layer metrics that read them
(``port_bench/metrics/``).

On the CPU: the span trees of one ``WideStream`` batch and one
``fork_pipeline`` call, the counters against ``stats`` and the
schedules, ``timings`` against the spans, no ``record_function`` while
no profiler records, the spans as ``user_annotation`` events of a
profiler's Chrome trace, and the five metric readers on a tiny
``run_cell``.  One test is marked ``gpu``: on the card, every call that
synchronises goes through the host-read helper, at toy shapes and at
the benchmark cells' own.

    python -m pytest tests/test_torch_spans.py -q
    python -m pytest tests/test_torch_spans.py -m gpu --noconftest
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import torch

from babble_tpu_torch.obs import spans
from babble_tpu_torch.ops import forks as F
from babble_tpu_torch.ops import stream as S
from babble_tpu_torch.ops.state import DagConfig
from babble_tpu_torch.sim.arrays import (
    batch_from_arrays, random_byzantine_fork_arrays, random_gossip_arrays,
)
from port_bench import harness, spec
from port_bench.test_port_bench import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
HONEST, BYZ = "honest-1024.batch", "byzantine-1024.catchup"
WIDE_METRICS = ("wide.fd_sweep_share", "wide.host_ms_per_batch",
                "wide.host_reads_per_batch")
FORK_METRICS = ("fork.level_loops_share", "fork.host_ms_per_call")


@pytest.fixture
def ring(monkeypatch):
    """A fresh process-wide stage ring for one test."""
    tr = spans.SpanTracer(capacity=spans.STAGE_CAPACITY, counters=True)
    monkeypatch.setattr(spans, "STAGES", tr)
    return tr


def _shape(t):
    return (t["name"], [_shape(c) for c in t["children"]])


def _stream_batch(dev, n=12, e=600, seed=5):
    """One batch of a DAG through a ``WideStream`` as the benchmark's
    entry drives it: slice, fd schedule, ingest, consensus, compact."""
    dag = random_gossip_arrays(n, e, seed=seed)
    cfg = DagConfig(n=n, e_cap=max(1024, e), s_cap=dag.max_chain + 2,
                    r_cap=32)
    st = S.WideStream(cfg, record_ordered=False, seq_window=4, device=dev)
    batch = S.slice_batch(dag, 0, e, 0, device=dev)
    sched = spans.host_read(torch.tensor,
                            S._padded_schedule(dag.levels[:e], cfg.e_cap),
                            device=dev)
    st.ingest(batch, fd_slot_sched=sched)
    st.consensus(final=True)
    evicted = st.compact(min_future_parent=e, compact_min=1)
    return st, batch, sched, evicted


def _fork_call(dev, mode=None, monkeypatch=None):
    cfg, arrays = random_byzantine_fork_arrays(10, 700, seed=3,
                                               fork_rate=0.06, r_cap=16)
    if mode is not None:
        monkeypatch.setattr(F, "fd_reverse_scan_wins",
                            lambda *a: mode == "reverse")
    stats = {}
    b = F.fork_batch_from_numpy(arrays, device=dev)
    out = F.fork_pipeline(cfg, b, stats=stats)
    return cfg, b, out, stats


def test_stream_batch_span_tree_counters_and_timings(ring):
    st, batch, sched, evicted = _stream_batch(CPU)
    assert evicted > 0
    roots = ring.trees()
    assert [_shape(t) for t in roots] == [
        ("wide.slice_batch", [("wide.schedule", [])]),
        ("wide.schedule", []),
        ("wide.ingest", [("wide.coords.write", []),
                         ("wide.coords.la_scan", []),
                         ("wide.coords.fd_sweep", []),
                         ("wide.coords.wait", [])]),
        ("wide.consensus", [("wide.rounds", []), ("wide.fame", []),
                            ("wide.order", [])]),
        ("wide.compact", [("wide.compact.evict", [])]),
    ]
    by = {s["name"]: s for s in ring.dump()}
    # timings are the spans' durations, key by key
    assert st.timings == {k: by[name]["dur_s"] for k, name in (
        ("coords", "wide.ingest"), ("rounds", "wide.rounds"),
        ("fame", "wide.fame"), ("order", "wide.order"),
        ("compact", "wide.compact.evict"))}
    for s in ring.dump():
        a = s["attrs"]
        assert a["profiled"] is False and a["read_wait_s"] <= s["dur_s"]
    # a read counts on every open stage: a parent holds its children's
    cons = by["wide.consensus"]["attrs"]["host_reads"]
    assert cons >= sum(by[n]["attrs"]["host_reads"]
                       for n in ("wide.rounds", "wide.fame", "wide.order"))
    assert by["wide.slice_batch"]["attrs"]["host_reads"] == 8
    # the eviction plan's reads count on wide.compact: n_live, r_off,
    # five columns and the creators' heads (none given here)
    compact = by["wide.compact"]["attrs"]["host_reads"]
    assert compact >= 8 + by["wide.compact.evict"]["attrs"]["host_reads"]


def test_run_wide_pipeline_timings_are_its_spans(ring):
    from babble_tpu_torch.ops.wide import run_wide_pipeline

    dag = random_gossip_arrays(10, 400, seed=2)
    cfg = DagConfig(n=10, e_cap=400, s_cap=dag.max_chain + 2, r_cap=32)
    timings, stats = {}, {}
    run_wide_pipeline(cfg, batch_from_arrays(dag, device=CPU),
                      timings=timings, stats=stats)
    (root,) = ring.trees()
    assert _shape(root) == ("wide.pipeline", [
        ("wide.ingest", [("wide.coords.write", []),
                         ("wide.coords.la_scan", []),
                         ("wide.coords.fd_sweep", []),
                         ("wide.coords.wait", [])]),
        ("wide.rounds", []), ("wide.fame", []), ("wide.order", [])])
    by = {c["name"]: c for c in root["children"]}
    assert timings == {"coords": by["wide.ingest"]["dur_s"],
                       "rounds": by["wide.rounds"]["dur_s"],
                       "fame": by["wide.fame"]["dur_s"],
                       "order": by["wide.order"]["dur_s"]}


@pytest.mark.parametrize("mode", ["reverse", "chains"])
def test_fork_pipeline_span_tree_and_counters(ring, monkeypatch, mode):
    cfg, b, out, stats = _fork_call(CPU, mode, monkeypatch)
    roots = ring.trees()
    assert [_shape(t) for t in roots] == [
        ("fork.upload", []),
        ("fork.pipeline", [(name, []) for name in (
            "fork.la_scan", "fork.detect", "fork.first_det", "fork.fd",
            "fork.helper", "fork.rounds", "fork.fame", "fork.order")]),
    ]
    by = {c["name"]: c["attrs"] for c in roots[1]["children"]}
    assert by["fork.fd"]["mode"] == mode
    rounds = by["fork.rounds"]
    assert rounds["passes"] == stats["closure_passes"] > 0
    assert rounds["rounds"] >= 1
    # the closure reads once a pass and once a round
    assert rounds["host_reads"] == rounds["passes"] + rounds["rounds"]
    assert roots[0]["attrs"]["host_reads"] == len(F.ForkBatch._fields)
    assert set(stats) == {"closure_passes"}


def test_no_record_function_while_no_profiler_records(ring, monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _stream_batch(CPU)
    _fork_call(CPU)
    assert calls == [] and len(ring.dump()) > 20
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _fork_call(CPU)
    profiled = [s for s in ring.dump() if s["attrs"]["profiled"]]
    assert sorted(calls) == sorted(s["name"] for s in profiled)
    assert len(profiled) == 10


def test_obs_imports_and_stages_run_without_torch():
    code = (
        "import sys; sys.modules['torch'] = None\n"
        "from babble_tpu_torch.obs import spans\n"
        "with spans.stage('a') as a:\n"
        "    with spans.stage('b', x=3):\n"
        "        spans.count('k', 2); spans.host_read(int, '7')\n"
        "(t,) = spans.STAGES.trees()\n"
        "b = t['children'][0]['attrs']\n"
        "assert a.attrs['host_reads'] == b['host_reads'] == 1, a.attrs\n"
        "assert b['k'] == 2 and b['x'] == 3 and 'k' not in a.attrs\n"
        "assert not a.attrs['profiled'] and 'torch' not in "
        "[m for m in sys.modules if sys.modules[m] is not None]\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _enclosing(ev, events):
    """The innermost event of ``events`` whose interval holds ``ev``'s."""
    best = None
    for o in events:
        if o is not ev and o["ts"] <= ev["ts"] and \
                ev["ts"] + ev["dur"] <= o["ts"] + o["dur"]:
            if best is None or o["dur"] < best["dur"]:
                best = o
    return best


def test_stages_are_user_annotations_of_the_chrome_trace(ring, tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.region"):
            _stream_batch(CPU)
            _fork_call(CPU)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    names = {s["name"] for s in ring.dump()}
    ann = [e for e in trace["traceEvents"]
           if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    stages = sorted((e for e in ann if e["name"] in names),
                    key=lambda e: (e["ts"], -e["dur"]))
    recs = sorted(ring.dump(), key=lambda s: (s["start"], -s["dur_s"]))
    assert [e["name"] for e in stages] == [s["name"] for s in recs]
    by_id = {s["id"]: s for s in recs}
    region = next(e for e in ann if e["name"] == "bench.region")
    for e, s in zip(stages, recs):
        assert s["attrs"]["profiled"] is True
        t0 = (e["ts"] + base_us) / 1e6
        t1 = t0 + e["dur"] / 1e6
        assert s["start"] - 1e-3 <= t0 and t1 <= s["start"] + s["dur_s"] \
            + 1e-3, (s["name"], t0 - s["start"], t1 - s["start"] - s["dur_s"])
        parent = _enclosing(e, stages + [region])
        want = by_id[s["parent"]]["name"] if s["parent"] else "bench.region"
        assert parent is not None and parent["name"] == want, s["name"]


@pytest.mark.parametrize("name,metrics,events", [
    (HONEST, WIDE_METRICS, 3000), (BYZ, FORK_METRICS, 1500)])
def test_metric_readers_on_a_tiny_traced_run(ring, monkeypatch, name,
                                             metrics, events):
    bench = spec.load()
    cell, cfg, tr = tiny(bench, name, events=events)
    res = harness.run_cell(bench, cell, 2 ** 31 + 11, 1, True,
                           time.perf_counter(), device="cpu", config=cfg,
                           traffic=tr)
    assert res["correct"]
    got = {m: res["metrics"][m]["value"] for m in metrics}
    for m in metrics:
        entry = next(e for e in bench["per_layer"] if e["name"] == m)
        assert entry["workloads"] == [name]
        assert res["metrics"][m]["unit"] == entry["unit"]
    first = "wide.slice_batch" if name == HONEST else "fork.upload"
    roots = ring.trees()
    starts = [i for i, t in enumerate(roots) if t["name"] == first]
    assert len(starts) == res["attempted"] + 1    # the warm-up's call too
    if name == HONEST:
        assert 0 < got["wide.fd_sweep_share"] < 1
        assert 0 < got["wide.host_ms_per_batch"]
        assert got["wide.host_reads_per_batch"] >= 30
    else:
        assert 0 < got["fork.level_loops_share"] < 1
        assert 0 < got["fork.host_ms_per_call"]

    # batch records pair with the newest calls, and a profiled one is
    # left out: of two records the first reads the second-newest call
    run = {"batches": [{"seconds": 1.0, "profiled": False},
                       {"seconds": 1.0, "profiled": True}]}
    warm = roots[starts[-2]:starts[-1]]
    if name == HONEST:
        assert spec.metric_reader("wide.host_reads_per_batch").read(run) \
            == sum(t["attrs"]["host_reads"] for t in warm)
        assert spec.metric_reader("wide.host_ms_per_batch").read(run) == \
            pytest.approx(1e3 * sum(t["dur_s"] - t["attrs"]["read_wait_s"]
                                    for t in warm))
    else:
        assert spec.metric_reader("fork.host_ms_per_call").read(run) == \
            pytest.approx(1e3 * sum(t["dur_s"] - t["attrs"]["read_wait_s"]
                                    for t in warm))
    more = {"batches": [{"seconds": 1.0, "profiled": False}]
            * (len(starts) + 1)}                # more records than calls
    assert {m: spec.metric_reader(m).read(more) for m in metrics} == \
        dict.fromkeys(metrics)

    # a ring that dropped a span of the window's calls reads nothing
    small = spans.SpanTracer(capacity=6)
    for s in ring.dump()[-6:]:
        small._finish(s["name"], s["id"], s["parent"], s["start"],
                      s["dur_s"], s["attrs"], None)
    monkeypatch.setattr(spans, "STAGES", small)
    assert {m: spec.metric_reader(m).read(run) for m in metrics} == \
        dict.fromkeys(metrics)
    # ... and so does a program that keeps no stage ring
    monkeypatch.delattr(spans, "STAGES")
    assert {m: spec.metric_reader(m).read(run) for m in metrics} == \
        dict.fromkeys(metrics)


def _cell_paths(dev):
    """One batch of the honest cell and one call of the byzantine cell,
    at the cells' own shapes, driven as ``_stream_batch`` and
    ``_fork_call`` drive the toy ones."""
    from port_bench.entries import fork_pipeline, wide_stream

    bench = spec.load()

    def session(entry, name):
        cell = spec.workload(bench, name)
        tr = dict(spec.traffic(cell["traffic"]), pool=1)
        return entry.Session(spec.config(bench, cell["config"]), tr,
                             2 ** 31 + 7, device=dev)

    h = session(wide_stream, HONEST)
    dag = h.own                 # the traffic's job is one whole batch
    e = dag.n_events

    def honest():
        st = S.WideStream(h.cfg, n_blocks=h.n_blocks, record_ordered=False,
                          device=dev, **h.stream_kw)
        batch = S.slice_batch(dag, 0, e, 0, device=dev)
        sched = spans.host_read(
            torch.tensor, S._padded_schedule(dag.levels[:e], h.cfg.e_cap),
            device=dev)
        st.ingest(batch, fd_slot_sched=sched)
        st.consensus(final=True)
        st.compact(min_future_parent=e, compact_min=h.compact_min)

    sizes, arrays = session(fork_pipeline, BYZ).own

    def byzantine():
        b = F.fork_batch_from_numpy(arrays, device=dev)
        F.fork_pipeline(F.ForkConfig(**sizes), b, stats={})

    return honest, byzantine


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["toy", "cells"])
def test_host_reads_count_every_synchronising_call_on_card(monkeypatch,
                                                           shape):
    """On the card the helper's ``host_reads`` over one call of each
    path equals the synchronising calls that CUDA's sync debug mode
    reports plus the explicit synchronises: an implicit sync (a
    boolean-mask index, an unrouted read) would show as a difference.
    Sync debug mode does not see every synchronising operation, so the
    equality bounds the unrouted syncs from below only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    explicit = []
    real_sync = torch.cuda.synchronize

    def sync(*a, **kw):
        explicit.append(1)
        return real_sync(*a, **kw)

    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    paths = ((lambda: _stream_batch(dev, n=64, e=4000),
              lambda: _fork_call(dev))
             if shape == "toy" else _cell_paths(dev))
    for path in paths:
        path()                                  # builds and warms
        real_sync()
        explicit.clear()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                with spans.stage("test.path") as outer:
                    path()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        flagged = [w for w in seen
                   if "synchroniz" in str(w.message).lower()]
        where = sorted({f"{w.filename}:{w.lineno}" for w in flagged})
        assert flagged                  # the path's uploads at least
        assert outer.attrs["host_reads"] == len(flagged) + len(explicit), \
            (outer.attrs["host_reads"], len(flagged), len(explicit), where)
        assert np.isfinite(outer.attrs["read_wait_s"])
