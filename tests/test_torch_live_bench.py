"""The live node's engine as the benchmark cell ``gossip-64.live`` drives
it (``port_bench/entries/live_node.py``), and the engine's stage spans
(``consensus/engine.py``, ``ops/flush.py``) that its per-layer metrics
read (``port_bench/metrics/live.*.py``).

On the CPU: ``TorchHashgraph(**node_engine_kwargs(cache))`` fed in
flushes and held to the plain reference (``port_bench/reference/
hashgraph.py``) on seeded gossip DAGs, through a compacting window and
through the throughput surface; the entry through ``harness.run_cell``
with a fault planted where the answer is made; one ``live.flush`` tree a
flush on each surface; ``host_reads`` against the routed reads; the four
readers on a made-up ring.  One test is marked ``gpu``: on the card,
every synchronising call of a flush goes through the host-read helper.

    python -m pytest tests/test_torch_live_bench.py -q
    python -m pytest tests/test_torch_live_bench.py -m gpu --noconftest
"""

from __future__ import annotations

import gc
import json
import time
import warnings
import weakref

import pytest
import torch

from babble_tpu_torch.consensus import engine as E
from babble_tpu_torch.obs import spans
from babble_tpu_torch.ops import fame as fame_ops
from babble_tpu_torch.ops import flush as flush_ops
from babble_tpu_torch.ops import ingest as ingest_ops
from babble_tpu_torch.ops import order as order_ops
from port_bench import compare, harness, spec
from port_bench.entries import live_node
from port_bench.reference import hashgraph

CELL = "gossip-64.live"
METRICS = ("live.flush_ms_p95", "live.ingest_share",
           "live.host_reads_per_flush", "live.throughput_flush_share")
CHILDREN = ["live.build_batch", "live.ingest", "live.fame", "live.order",
            "live.sync", "live.collect"]


@pytest.fixture
def ring(monkeypatch):
    """A fresh process-wide stage ring for one test."""
    tr = spans.SpanTracer(capacity=spans.STAGE_CAPACITY, counters=True)
    monkeypatch.setattr(spans, "STAGES", tr)
    return tr


def _session(n, cache, events, flush, seed, device="cpu"):
    kw = E.node_engine_kwargs(cache)
    traffic = {"job_events": events, "flush_events": flush, "pool": 0,
               "pool_seed": 1, "warmup_flushes": 1, "trace_skip_batches": 1,
               "trace_batches": 1}
    return live_node.Session({"n": n, "window": kw}, traffic, seed,
                             device=device)


def _tiny(bench, n=8, cache=64, events=1200, flush=64):
    """The cell's configuration and traffic cut to a CPU-sized job."""
    cell = spec.workload(bench, CELL)
    cfg = spec.config(bench, cell["config"])
    kw = E.node_engine_kwargs(cache)
    cfg = dict(cfg, n=n, cache_size=cache,
               window={k: kw[k] for k in cfg["window"]})
    tr = dict(spec.traffic(cell["traffic"]), job_events=events,
              flush_events=flush, pool=1, warmup_flushes=2)
    return cell, cfg, tr


# ---------------------------------------------------------------------
# the node's engine against the plain reference


@pytest.mark.parametrize("n,cache,events,flush,seed,compacts,held", [
    (8, 64, 2000, 64, 1, True, False),    # ~4 windows a creator
    (8, 32, 2000, 64, 2 ** 31 + 5, True, False),
    (4, 64, 1500, 300, 3, True, False),   # flushes above LATENCY_K_MAX
    (16, 64, 3000, 256, 4, True, False),
    (16, 500, 2500, 100, 9, False, False),  # the node's default cache
    (64, 50000, 2048, 256, 7, False, False),  # the cell's own window
    (8, 64, 1000, 64, 59, True, True),    # a round the DAG leaves undecided
])
def test_the_node_engine_orders_as_the_reference(n, cache, events, flush,
                                                 seed, compacts, held):
    s = _session(n, cache, events, flush, seed)
    rec = live_node.JobRecord(s.first)
    flushes = []
    s._run_job(s.first, rec, on_batch=flushes.append)
    found = compare.check(rec, hashgraph.consensus(s.first.dag))
    checks = {c["name"]: c["value"] for c in found}
    assert rec.completed and compare.passed(found), checks
    assert checks["ordered_compared"] > events // 8
    assert sum(f["ordered"] for f in flushes) == checks["ordered_compared"]
    evicted = flushes[-1]["evicted"]
    assert evicted > events // 4 if compacts else evicted == 0
    paths = {f["path"] for f in flushes[:-1]}
    if flush > E.LATENCY_K_MAX:
        assert paths == {"throughput"}
    else:
        assert "latency" in paths
    # the finished job's last flush, gate lifted, holds no events; it
    # commits what the gated engine held above an undecided round
    drain = flushes[-1]
    assert drain["events"] == 0 and (drain["ordered"] > 0) == held


def test_a_finished_job_frees_its_engine_without_a_collection():
    # the next job's engine starts while this one's memory is freed, so
    # the window's peak is one engine's, whatever job it reaches
    s = _session(8, 64, 600, 64, 5)
    engines = []
    make = s._engine

    def keep(job, record):
        eng = make(job, record)
        engines.append(weakref.ref(eng))
        return eng

    s._engine = keep
    gc.disable()
    try:
        s._run_job(s.first, live_node.JobRecord(s.first))
        assert engines and engines[0]() is None
    finally:
        gc.enable()


def test_the_config_is_the_window_a_node_builds_for_its_cache():
    bench = spec.load()
    cell = spec.workload(bench, CELL)
    assert cell["chips"] == 1 and cell["traffic"] == "live"
    cfg = spec.config(bench, cell["config"])
    assert cfg["window"] == E.node_engine_kwargs(cfg["cache_size"])
    assert set(cfg["window"]) == set(live_node.ENGINE_KEYS)
    assert (cfg["entry"], cfg["reference"], cfg["n"]) == (
        "live_node", "hashgraph", 64)
    tr = spec.traffic("live")
    assert tr["flush_events"] == E.LATENCY_K_MAX
    assert tr["job_events"] > 2 * cfg["cache_size"]
    layer = {m["name"]: m for m in bench["per_layer"]}
    for name in METRICS:
        m = layer[name]
        assert m["workloads"] == [CELL]
        assert m["moves"] == "ordered_events_per_s"
        assert m["layer"] == "engine (consensus/engine.py, ops/flush.py)"


# ---------------------------------------------------------------------
# the entry through the harness


def _run(bench, seconds=1, trace=False):
    cell, cfg, tr = _tiny(bench)
    return harness.run_cell(bench, cell, 2 ** 31 + 23, seconds, trace,
                            time.perf_counter(), device="cpu", config=cfg,
                            traffic=tr)


def test_a_sound_live_run_is_correct(ring):
    bench = spec.load()
    res = _run(bench)
    assert res["correct"] and res["attempted"] > 0
    # no card, so no peak
    assert set(res["metrics"]) == {"ordered_events_per_s", "setup_s"}
    assert res["checks"]["ordered_compared"]["value"] >= 1
    json.dumps(res)


def test_a_round_received_altered_where_it_is_made_is_caught(ring,
                                                            monkeypatch):
    orig = flush_ops.order_window_impl

    def altered(*args, **kw):
        state = orig(*args, **kw)
        hit = torch.nonzero(state.rr >= 0)
        if hit.numel():
            rr = state.rr.clone()
            rr[hit[-1, 0]] += 1
            state = state._replace(rr=rr)
        return state

    monkeypatch.setattr(flush_ops, "order_window_impl", altered)
    res = _run(spec.load())
    assert not res["correct"]
    assert res["checks"]["rr_diff"]["value"] > 0


# ---------------------------------------------------------------------
# the engine's stage spans


def _shape(t):
    return (t["name"], [_shape(c) for c in t["children"]])


def _flushes(n, cache, events, flush, seed=5, first=None):
    """Feed one job to a node's engine; returns the engine."""
    s = _session(n, cache, events, flush, seed)
    eng = s._engine(s.first, None)
    evs = s.first.events
    a = 0
    while a < len(evs):
        b = min(len(evs), a + (first if a == 0 and first else flush))
        for ev in evs[a:b]:
            eng.insert_event(ev)
        eng.run_consensus_timed()
        a = b
    return eng


@pytest.mark.parametrize("flush,path", [(64, "latency"),
                                        (300, "throughput")])
def test_one_live_flush_tree_a_flush_on_each_surface(ring, flush, path):
    eng = _flushes(8, 64, 1500, flush)
    roots = ring.trees()
    assert len(roots) == -(-1500 // flush)
    assert all(r["name"] == "live.flush" for r in roots)
    want = ("live.flush", [(c, [("live.compact", [])] if c == "live.collect"
                            else []) for c in CHILDREN])
    on_path = [r for r in roots if r["attrs"]["path"] == path]
    assert on_path and all(_shape(r) == want for r in on_path)
    assert eng.dag.slot_base > 0              # the window rolled
    for r in roots:
        a = r["attrs"]
        assert a["k"] == min(flush, 1500 - flush * roots.index(r))
        # the latency flush's round window and frontier; the full tables
        # on the throughput path
        assert 1 <= a["F"] <= eng.cfg.e_cap + 1 and a["W"] <= eng.cfg.r_cap
        if a["path"] != "throughput":
            assert a["W"] in flush_ops.W_BUCKETS
        for c in r["children"]:
            assert c["attrs"]["host_reads"] <= a["host_reads"]
            assert c["dur_s"] <= r["dur_s"]


def test_a_latency_flush_that_falls_back_says_so(ring, monkeypatch):
    # a window of four rounds cannot cover a first flush of 256 events at
    # n = 4: the latency flush finishes on the full-table phases
    monkeypatch.setattr(flush_ops, "bucket_w", lambda active, r_cap: 4)
    _flushes(4, 64, 600, 64, first=256)
    roots = ring.trees()
    fell = [r for r in roots if r["attrs"]["path"] == "fallback"]
    assert fell
    names = [c["name"] for c in fell[0]["children"]]
    assert names == ["live.build_batch", "live.ingest", "live.fame",
                     "live.order", "live.sync", "live.fame", "live.order",
                     "live.sync", "live.collect"]


@pytest.mark.parametrize("flush,path", [(64, "latency"),
                                        (300, "throughput")])
def test_host_reads_count_every_routed_read(ring, monkeypatch, flush, path):
    calls = []
    real = spans.host_read

    def counting(fn, *a, **kw):
        calls.append(fn)
        return real(fn, *a, **kw)

    for mod in (E, flush_ops, ingest_ops, fame_ops, order_ops):
        monkeypatch.setattr(mod, "host_read", counting)
    s = _session(8, 64, 900, flush, 11)
    eng = s._engine(s.first, None)
    per_flush = []
    for a in range(0, 900, flush):
        for ev in s.first.events[a:a + flush]:
            eng.insert_event(ev)
        calls.clear()
        eng.run_consensus_timed()
        per_flush.append(len(calls))
    roots = ring.trees()
    assert path in {r["attrs"]["path"] for r in roots}
    assert [r["attrs"]["host_reads"] for r in roots] == per_flush
    assert min(per_flush) >= 10      # the batch's 8 uploads and the reads
    for r in roots:
        assert 0 <= r["attrs"]["read_wait_s"] <= r["dur_s"]


# ---------------------------------------------------------------------
# the readers


def _made_up_ring(flushes):
    """A ring of ``live.flush`` trees: ``flushes`` lists (seconds, ingest
    seconds, host reads, path); each tree has a ``live.ingest`` child."""
    tr = spans.SpanTracer(capacity=1 << 12, counters=True)
    sid = 0
    for dur, ing, reads, path in flushes:
        root, child = sid + 1, sid + 2
        sid += 2
        tr._finish("live.ingest", child, root, 0.0, ing,
                   {"host_reads": 1, "read_wait_s": 0.0}, None)
        tr._finish("live.flush", root, None, 0.0, dur,
                   {"host_reads": reads, "read_wait_s": 0.0, "path": path,
                    "k": 256, "W": 4, "F": 256, "profiled": False}, None)
    return tr


def test_the_four_readers_on_a_made_up_ring(monkeypatch):
    flushes = [(0.050, 0.030, 20, "latency"), (0.070, 0.040, 22, "latency"),
               (0.100, 0.080, 30, "throughput"),
               (0.060, 0.020, 18, "fallback"), (0.040, 0.010, 16, "latency")]
    monkeypatch.setattr(spans, "STAGES", _made_up_ring(flushes))
    # the window's four flushes are the newest four; the profiled one
    # (the second of them) is left out
    run = {"batches": [{"profiled": p} for p in (False, True, False, False)]}
    kept = [flushes[1], flushes[3], flushes[4]]
    got = {m: spec.metric_reader(m).read(run) for m in METRICS}
    assert got["live.flush_ms_p95"] == pytest.approx(
        1e3 * spec.percentile([f[0] for f in kept], 95))
    assert got["live.ingest_share"] == pytest.approx(
        sum(f[1] for f in kept) / sum(f[0] for f in kept))
    assert got["live.host_reads_per_flush"] == pytest.approx(
        sum(f[2] for f in kept) / 3)
    assert got["live.throughput_flush_share"] == pytest.approx(1 / 3)

    # a ring that dropped a span of the window's flushes reads nothing
    small = spans.SpanTracer(capacity=7, counters=True)
    for s in _made_up_ring(flushes).dump()[-7:]:
        small._finish(s["name"], s["id"], s["parent"], s["start"],
                      s["dur_s"], s["attrs"], None)
    monkeypatch.setattr(spans, "STAGES", small)
    assert {m: spec.metric_reader(m).read(run) for m in METRICS} == \
        dict.fromkeys(METRICS)
    # ... and so does a program without the engine's spans
    monkeypatch.setattr(spans, "STAGES", spans.SpanTracer(counters=True))
    assert {m: spec.metric_reader(m).read(run) for m in METRICS} == \
        dict.fromkeys(METRICS)


def test_the_readers_on_a_tiny_traced_run(ring):
    bench = spec.load()
    cell, cfg, tr = _tiny(bench)
    res = harness.run_cell(bench, cell, 2 ** 31 + 29, 1, True,
                           time.perf_counter(), device="cpu", config=cfg,
                           traffic=tr)
    assert res["correct"]
    # the CPU run has no profiler window: the readers still read the ring
    run = {"batches": [{"profiled": False}] * res["attempted"]}
    got = {m: spec.metric_reader(m).read(run) for m in METRICS}
    assert 0 < got["live.flush_ms_p95"]
    assert 0 < got["live.ingest_share"] < 1
    assert got["live.host_reads_per_flush"] >= 10
    assert 0 <= got["live.throughput_flush_share"] < 1
    calls = [t for t in ring.trees() if t["name"] == "live.flush"]
    assert len(calls) >= res["attempted"] + tr["warmup_flushes"]


# ---------------------------------------------------------------------
# on the card


@pytest.mark.gpu
def test_host_reads_count_every_synchronising_call_on_card(monkeypatch):
    """On the card a flush's ``host_reads`` equals the synchronising calls
    CUDA's sync debug mode reports (a lower bound on unrouted ones, as
    in ``tests/test_torch_spans.py``), on both surfaces.  A session's
    first flush builds and warms (``ops/pack.py`` copies its tables to
    the card once a process) and is not counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for flush in (256, 300):
        s = _session(64, 50000, 4096, flush, 13, device="cuda")
        eng = s._engine(s.first, None)
        evs = s.first.events
        for a in range(0, len(evs), flush):
            for ev in evs[a:a + flush]:
                eng.insert_event(ev)
            if a == 0:
                eng.run_consensus_timed()
                continue
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as seen:
                    warnings.simplefilter("always")
                    with spans.stage("test.flush") as outer:
                        eng.run_consensus_timed()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            flagged = [w for w in seen
                       if "synchroniz" in str(w.message).lower()]
            where = sorted({f"{w.filename}:{w.lineno}" for w in flagged})
            assert outer.attrs["host_reads"] == len(flagged), \
                (flush, a, outer.attrs["host_reads"], len(flagged), where)
