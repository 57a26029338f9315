"""Tests of the port's benchmark (``port_bench/``), on the CPU at tiny
sizes; the one marked ``gpu`` runs a cell on the card.

    python -m pytest port_bench -q
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time

import numpy as np
import pytest
import torch

from port_bench import compare, control, harness, run, spec, trace
from port_bench.entries import wide_stream
from port_bench.gen import byzantine, gossip
from port_bench.reference import hashgraph
from port_bench.roofline import ss_count

CELL = "honest-1024.batch"
BYZ = "byzantine-1024.catchup"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def bench():
    return spec.load()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny(bench, name=CELL, n=32, events=3000):
    """A cell's configuration and traffic cut to a CPU-sized job."""
    cell = spec.workload(bench, name)
    cfg = spec.config(bench, cell["config"])
    if "window" in cfg:
        cfg = dict(cfg, n=n, window=dict(cfg["window"], e_cap=8192))
    else:
        cfg = dict(cfg, n=n, generator=dict(cfg["generator"], fork_rate=0.05,
                                            r_cap=0))
    tr = dict(spec.traffic(cell["traffic"]), job_events=events,
              batch_events=events, pool=2)
    return cell, cfg, tr


# ---------------------------------------------------------------------
# the definition and finding things by name


def test_benchmark_json_names_files_that_exist(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "port_bench/run.py"]
    assert bench["paths"] == ["port_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert NAME.match(c["name"])
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert spec.config(bench, c["name"])["name"] == c["name"]
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert spec.traffic(w["traffic"])["job_events"] > 0
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert hasattr(spec.metric_reader(m["name"]), "read")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


def test_cells_configs_and_metrics_are_found_by_name(bench):
    cell = spec.workload(bench, CELL)
    assert cell["config"] == "honest-1024"
    assert spec.config(bench, "honest-1024")["entry"] == "wide_stream"
    assert spec.entry("wide_stream").Session is wide_stream.Session
    assert spec.reference("hashgraph") is hashgraph
    assert spec.metric_reader("wide.coords_share").read
    names = [m["name"] for m in spec.metrics(bench, CELL, trace=False)]
    assert "setup_s" in names and "ordered_events_per_s" in names
    layer = [m["name"] for m in spec.metrics(bench, CELL, trace=True)]
    assert "ss_count_roofline" in layer and "setup_s" not in layer
    for missing in (lambda: spec.workload(bench, "no-such-cell"),
                    lambda: spec.config(bench, "no-such-config")):
        with pytest.raises(KeyError):
            missing()


@pytest.mark.parametrize("modules,found", [
    (["babble_tpu_torch", "babble_tpu_torch.ops.stream", "numpy"], []),
    (["babble_tpu"], ["babble_tpu"]),
    (["babble_tpu.ops.forks", "babble_tpu_torch.ops"], ["babble_tpu.ops.forks"]),
    (["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client"]),
    (["jaxtyping", "babble_tpu_tools", "flaxen"], []),
])
def test_the_guard_compares_whole_top_level_names(modules, found):
    assert spec.forbidden_modules(modules) == found


def test_the_run_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    for var in ("OMP_NUM_THREADS", "USE_FLAX"):     # restored afterwards
        monkeypatch.setenv(var, os.environ.get(var, ""))
    assert run.main(["--workload", CELL, "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err


# ---------------------------------------------------------------------
# arithmetic


def test_roofline_on_hand_worked_shapes():
    dev = {"sm_count": 132, "sm_clock_max_hz": 1.98e9}
    peak = 128 * 132 * 1.98e9                     # lane operations a second
    # int32, 1,024 rows a side, 1,024 columns: 2 * 2^30 lane operations
    t_ops, t_bytes = ss_count.bounds((1, 1024, 1024, 1024, 4), 132, 1.98e9)
    assert t_ops == pytest.approx(2 * 2 ** 30 / peak)
    assert t_ops * 1e3 == pytest.approx(0.0642, abs=1e-4)
    assert t_bytes == pytest.approx((4 * 2048 * 1024 + 8 * 2 ** 20) / 3.35e12)
    # int16 packs two to a lane: half the operations; 3 stacked blocks
    t16, b16 = ss_count.bounds((3, 1024, 512, 100, 2), 132, 1.98e9)
    assert t16 == pytest.approx(2 * 3 * 1024 * 512 * 100 / 2 / peak)
    assert b16 == pytest.approx((2 * 3 * 1536 * 100 + 8 * 1024 * 512) / 3.35e12)
    least, bound = ss_count.least_seconds(
        [(1, 1024, 1024, 1024, 4), (1, 8, 8, 8, 2)], dev)
    small = max(ss_count.bounds((1, 8, 8, 8, 2), 132, 1.98e9))
    assert least == pytest.approx(t_ops + small) and bound == "operations"


def test_call_shape_reads_two_and_three_dimensional_calls():
    a = torch.zeros((5, 7), dtype=torch.int16)
    b = torch.zeros((3, 7), dtype=torch.int16)
    assert ss_count.call_shape(a, b, None) == (1, 5, 3, 7, 2)
    assert ss_count.call_shape(a[None].expand(4, 5, 7), b[None], None) == (
        4, 5, 3, 7, 2)


def test_metric_readers_on_a_made_up_run():
    batches = [{"latency_s": 0.1 * (i + 1), "seconds": 0.2, "ordered": 10,
                "profiled": i == 0,
                "stages": {"coords": 0.1, "rounds": 0.01, "fame": 0.01,
                           "order": 0.01, "compact": 0.01}}
               for i in range(20)]
    run_ = {"window_s": 4.0, "setup_s": 3.5, "peak_bytes": 2 ** 31,
            "ordered": 200, "batches": batches, "calls": {},
            "trace": {"busy_s": 0.25, "window_s": 1.0, "kernels_s": {}},
            "device_info": None}

    def read(name):
        return spec.metric_reader(name).read(run_)

    assert read("ordered_events_per_s") == 50.0
    assert read("batch_latency_p95_ms") == pytest.approx(
        np.percentile([0.1 * (i + 1) for i in range(20)], 95) * 1e3)
    assert read("peak_device_gib") == 2.0 and read("setup_s") == 3.5
    assert read("wide.coords_share") == pytest.approx(0.5)
    assert read("wide.consensus_ms_p95") == pytest.approx(40.0)
    assert read("device_idle_share") == 0.75
    assert read("ss_count_roofline") is None      # nothing recorded


def test_trace_reduction_unions_device_time_and_names_gaps():
    us = [  # two overlapping kernels, a copy after a gap, host regions
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 40,
         "dur": 5},
        {"ph": "X", "cat": "user_annotation", "name": "bench.ingest",
         "ts": 0, "dur": 50},
        {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 16,
         "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 20,
         "dur": 5},
    ]
    s = trace.reduce_trace({"traceEvents": us})
    assert s["busy_s"] == pytest.approx(20e-6)
    assert s["window_s"] == pytest.approx(50e-6)
    assert s["kernels_s"]["k1"] == pytest.approx(10e-6)
    assert s["idle_gaps"] == [["bench.ingest:aten::nonzero",
                               pytest.approx(25e-6)]]


# ---------------------------------------------------------------------
# traffic


def test_the_gossip_generator_is_pinned():
    dag = gossip.gossip_dag(64, 5000, 2 ** 31 + 11)
    assert gossip.digest(dag) == (
        "490bd48cc96127a9f781182a66c169b23c61da75d8106652c60cb5b5046d91fc")
    assert (dag.sp[64:] < np.arange(64, 5000)).all()       # topological


def test_the_byzantine_generator_is_pinned():
    cfg, arrays = byzantine.random_byzantine_fork_arrays(
        48, 3000, fork_rate=0.05, seed=2 ** 31 + 11)
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    assert cfg == {"n": 48, "k": 2, "e_cap": 4096, "s_cap": 128,
                   "r_cap": 128}
    assert h.hexdigest() == (
        "370989d546fd6bb34ef287e02523039b511b982b0048547ba0300542550d91b6")


# ---------------------------------------------------------------------
# correctness: the reference, its control, and faults the check catches


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5, 4_000_000_007])
def test_the_reference_agrees_with_the_port_on_the_cpu(bench, seed):
    _, cfg, tr = tiny(bench)
    s = wide_stream.Session(cfg, tr, seed, device="cpu")
    rec = wide_stream.JobRecord(s.dags[1])
    s._run_job(s.dags[1], rec)
    checks = compare.check(rec, hashgraph.consensus(s.dags[1]))
    assert compare.passed(checks), checks
    assert rec.completed and (rec.rr >= 0).sum() > 1000


@pytest.mark.parametrize("n,events,seed", [(4, 300, 1), (16, 1500, 9),
                                             (32, 6000, 2 ** 31 + 5)])
def test_the_reference_equals_the_ports_cpp_baseline(n, events, seed):
    """The program's C++ baseline (``native/baseline_consensus.cpp``,
    its own independent reference) gives the same rounds, witnesses,
    fame, rounds received and timestamps on whole DAGs."""
    from babble_tpu_torch import native

    dag = gossip.gossip_dag(n, events, seed)
    ref = hashgraph.consensus(dag)
    _, base = native.baseline_consensus(dag)
    for k in ("round", "witness", "fame", "rr", "cts"):
        assert np.array_equal(ref[k], base[k]), k


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_the_fork_reference_agrees_with_the_port_on_the_cpu(bench, seed):
    from port_bench.entries import fork_pipeline
    from port_bench.reference import forkgraph

    _, cfg, tr = tiny(bench, BYZ, n=48, events=4000)
    s = fork_pipeline.Session(cfg, tr, seed, device="cpu")
    s._call(s.own, True, s._ss())
    rec = s.records[0]
    checks = compare.check(rec, forkgraph.consensus(rec.dag))
    assert compare.passed(checks), checks
    assert rec.det.any() and (rec.rr >= 0).sum() > 500


@pytest.mark.parametrize("name", [CELL, BYZ])
def test_the_control_fails_the_check(bench, name):
    cell, cfg, tr = tiny(bench, name, n=32, events=6000)
    out = control.control(bench, cell, 5, device="cpu", config=cfg,
                          traffic=tr)
    assert not out["passed"]
    assert out["checks"]["cts_diff"] > 0 and out["checks"]["round_diff"] > 0


def _run(bench, name=CELL):
    cell, cfg, tr = tiny(bench, name)
    return harness.run_cell(bench, cell, 2 ** 31 + 3, 1, False,
                            time.perf_counter(), device="cpu", config=cfg,
                            traffic=tr)


@pytest.mark.parametrize("name,metrics", [
    (CELL, {"ordered_events_per_s", "batch_latency_p95_ms", "setup_s"}),
    (BYZ, {"ordered_events_per_s", "setup_s"}),
])
def test_a_sound_run_is_correct_and_reports_its_metrics(bench, capsys, name,
                                                        metrics):
    res = _run(bench, name)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == metrics
    assert list(res)[-1] == "checks"
    err = capsys.readouterr().err.strip().splitlines()
    assert all(line.startswith("check ") for line in err[-len(res["checks"]):])
    json.dumps(res)


def test_a_step_that_leaves_its_state_unchanged_is_caught(bench, monkeypatch):
    from babble_tpu_torch.ops.stream import WideStream

    monkeypatch.setattr(WideStream, "consensus",
                        lambda self, final=False: 0)
    res = _run(bench)
    assert not res["correct"]
    assert res["checks"]["round_diff"]["value"] > 0
    assert res["checks"]["rr_diff"]["value"] > 0


def test_a_fork_pipeline_that_orders_nothing_is_caught(bench, monkeypatch):
    from babble_tpu_torch.ops import forks

    orig = forks.fork_pipeline

    def unchanged(*args, **kw):
        out = orig(*args, **kw)
        return out._replace(rr=torch.full_like(out.rr, -1),
                            round=torch.full_like(out.round, -1))

    monkeypatch.setattr(forks, "fork_pipeline", unchanged)
    res = _run(bench, BYZ)
    assert not res["correct"]
    assert res["checks"]["rr_diff"]["value"] > 0


def test_a_fork_detection_altered_where_it_is_produced_is_caught(
        bench, monkeypatch):
    from babble_tpu_torch.ops import forks

    orig = forks._detect

    def altered(*args, **kw):
        det = orig(*args, **kw).clone()
        det[0, 0] = ~det[0, 0]
        return det

    monkeypatch.setattr(forks, "_detect", altered)
    res = _run(bench, BYZ)
    assert not res["correct"]
    assert res["checks"]["det_diff"]["value"] > 0


def test_an_answer_altered_where_it_is_produced_is_caught(bench, monkeypatch):
    from babble_tpu_torch.ops import stream

    orig = stream.run_wide_order

    def altered(*args, **kw):
        state = orig(*args, **kw)
        hit = torch.nonzero(state.rr >= 0)
        if hit.numel():
            cts = state.cts.clone()
            cts[hit[0, 0]] += 1
            state = state._replace(cts=cts)
        return state

    monkeypatch.setattr(stream, "run_wide_order", altered)
    res = _run(bench)
    assert not res["correct"]
    assert res["checks"]["cts_diff"]["value"] > 0


# ---------------------------------------------------------------------
# on the card


@pytest.mark.gpu
@pytest.mark.parametrize("name,seconds,roofline", [
    (CELL, 10, "ss_count_roofline"), (BYZ, 25, "fork_ss_roofline")])
def test_the_cell_runs_on_the_card_and_is_correct(bench, cuda, name, seconds,
                                                  roofline):
    cell = spec.workload(bench, name)
    res = harness.run_cell(bench, cell, 2 ** 31 + 7, seconds, True,
                           time.perf_counter(), device=cuda)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert 0 < res["metrics"][roofline]["value"] <= 100
    assert spec.forbidden_modules() == []
