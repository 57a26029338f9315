"""The port's AOT prewarm (``ops/aot.py``) against the JAX package's, on
the CPU.

- the fused engine records the JAX package's manifest entries, in the
  same order, for the same flush stream; a prewarmed engine warms
  exactly those keys, counts no trace in the stream and commits JAX's
  order, and ``chip_smoke.py`` phase 15's stream gives ``PREWARM_EXPECT``
  in both packages;
- a manifest from either package prewarms the other, and one of another
  version prewarms neither;
- the fork engine records JAX's entries, pre-sizes to them at boot and
  commits JAX's order; cold and warm processes: the warm one's caps do
  not grow and it dispatches no cold pipeline shape;
- the wide warm-up pass is a semantic no-op against JAX;
- the build counters count a g++ build as a miss, then a hit, and the
  CUDA build module reports a built library as a hit;
- concurrent writers lose no manifest entry;
- none of the five matmul sites of the tallies touches the process's
  TF32 flag, and their outputs do not depend on it;
- a prewarm flush touches neither the engine's state nor any row of its
  scratch state (padding lanes write only sentinel rows).
"""

import json
import os
import subprocess
import sys
import threading

import pytest
import torch

import jax
from jax._src import compilation_cache as jcompilation_cache

from babble_tpu.consensus.engine import TpuHashgraph
from babble_tpu.consensus.fork_engine import ForkHashgraph as JForkHashgraph
from babble_tpu.consensus.wide_engine import WideHashgraph as JWideHashgraph
from babble_tpu.ops import aot as jaot
from babble_tpu.sim import generator as jgen

import babble_tpu_torch as bt
from babble_tpu_torch import cuda_build, native
from babble_tpu_torch.consensus.fork_engine import ForkHashgraph
from babble_tpu_torch.consensus.wide_engine import WideHashgraph
from babble_tpu_torch.obs import Registry
from babble_tpu_torch.ops import aot, flush, ingest, ss
from babble_tpu_torch.ops import wide as pwide
from babble_tpu_torch.ops import fame as pfame
from babble_tpu_torch.ops.state import DagConfig, init_state
from babble_tpu_torch.sim import generator as pgen
from chip_smoke import PREWARM_EXPECT, PREWARM_STREAM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture
def fresh_process(monkeypatch):
    """Each test sees the counters and dispatched shapes of a fresh
    process, and leaves the worker's as it found them (JAX's
    ``configure`` included: it points the persistent XLA cache at the
    test's directory)."""
    monkeypatch.setattr(aot, "_dispatched", set())
    monkeypatch.setattr(aot, "_bound", [])
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)
    jcompilation_cache.reset_cache()


def _stream(eng, dag, every):
    for i, ev in enumerate(dag.events):
        eng.insert_event(ev.clone())
        if (i + 1) % every == 0:
            eng.run_consensus()


def _fused_pair(n, e, seed, **kw):
    jdag, pdag = jgen.random_gossip_dag(n, e, seed=seed), \
        pgen.random_gossip_dag(n, e, seed=seed)
    j = TpuHashgraph(jdag.participants, verify_signatures=False, **kw)
    p = bt.TorchHashgraph(pdag.participants, verify_signatures=False,
                          device="cpu", **kw)
    return (j, jdag), (p, pdag)


FUSED = dict(kernel_class="auto", finality_gate=True)


def test_fused_manifest_equals_jax_and_prewarm_warms_exactly_it(
        tmp_path, fresh_process):
    jcache, pcache = str(tmp_path / "jax"), str(tmp_path / "port")
    (j, jdag), (p, pdag) = _fused_pair(4, 80, 13, **FUSED)
    j._aot_dir, p._aot_dir = jcache, pcache
    _stream(j, jdag, 4)
    _stream(p, pdag, 4)
    entries = aot.load_manifest(pcache)
    assert entries and entries == jaot.load_manifest(jcache)
    assert all(e["cfg"] == jaot._cfg_key(j.cfg) for e in entries)

    # a cold engine in a fresh process traces each new key once
    cold = bt.TorchHashgraph(pdag.participants, verify_signatures=False,
                             device="cpu", **FUSED)
    aot._dispatched.clear()
    c0 = aot.compile_counts()["traces"]
    _stream(cold, pdag, 4)
    assert aot.compile_counts()["traces"] - c0 == len(entries)

    aot._dispatched.clear()
    warm = bt.TorchHashgraph(pdag.participants, verify_signatures=False,
                             device="cpu", **FUSED)
    res = aot.prewarm_engine(warm, pcache)
    assert res == {"compiled": len(entries), "from_manifest": len(entries)}
    assert warm._aot == {tuple(e["key"]) for e in entries}
    c0 = aot.compile_counts()["traces"]
    _stream(warm, pdag, 4)
    assert aot.compile_counts()["traces"] == c0
    assert warm.consensus_events() == cold.consensus_events() \
        == j.consensus_events()
    assert warm.commit_digest == j.commit_digest
    assert aot.load_manifest(pcache) == entries


def test_chip_smokes_prewarm_stream_equals_jax(tmp_path, fresh_process):
    """chip_smoke.py phase 15(a)'s stream: a cold-root prewarm (the
    default keys, limit 2) then flushes of 8; the JAX engine's order
    pins ``PREWARM_EXPECT``."""
    n, e, seed, every = (PREWARM_STREAM[k]
                         for k in ("n", "e", "seed", "every"))
    (j, jdag), (p, pdag) = _fused_pair(n, e, seed, **FUSED)
    _stream(j, jdag, every)
    res = aot.prewarm_engine(p, str(tmp_path / "aot"),
                             limit=PREWARM_STREAM["limit"])
    assert res == {"compiled": 2, "from_manifest": 0}
    _stream(p, pdag, every)
    want = {"ordered": j.commit_length, "digest": j.commit_digest}
    assert want == PREWARM_EXPECT
    assert {"ordered": p.commit_length, "digest": p.commit_digest} == want


def test_manifests_cross_packages_and_other_versions_are_ignored(
        tmp_path, fresh_process):
    jcache, pcache = str(tmp_path / "jax"), str(tmp_path / "port")
    (j, jdag), (p, pdag) = _fused_pair(4, 40, 13, **FUSED)
    j._aot_dir, p._aot_dir = jcache, pcache
    _stream(j, jdag, 4)
    _stream(p, pdag, 4)
    jentries = jaot.load_manifest(jcache)

    # the JAX package's manifest prewarms the port ...
    p2 = bt.TorchHashgraph(pdag.participants, verify_signatures=False,
                           device="cpu", **FUSED)
    assert aot.prewarm_engine(p2, jcache) == {
        "compiled": len(jentries), "from_manifest": len(jentries)}
    assert p2._aot == {tuple(e["key"]) for e in jentries}
    # ... and the port's prewarms the JAX package
    j2 = TpuHashgraph(jdag.participants, verify_signatures=False, **FUSED)
    assert jaot.prewarm_engine(j2, pcache, limit=2) == {
        "compiled": 2, "from_manifest": 2}

    other = str(tmp_path / "other")
    os.makedirs(other)
    with open(aot.manifest_path(other), "w") as f:
        json.dump({"version": "8.0", "entries": jentries}, f)
    assert aot.load_manifest(other) == [] == jaot.load_manifest(other)
    p3 = bt.TorchHashgraph(pdag.participants, verify_signatures=False,
                           device="cpu", **FUSED)
    assert aot.prewarm_engine(p3, other) == {"compiled": 2,
                                             "from_manifest": 0}
    assert aot.prewarm_engine(
        bt.TorchHashgraph(pdag.participants, verify_signatures=False,
                          device="cpu", **FUSED),
        other, defaults=False) == {"compiled": 0, "from_manifest": 0}


FORK = dict(n=4, e=32, seed=21, k=2, every=16)


def _fork_stream(eng, dag, every):
    _stream(eng, dag, every)
    eng.run_consensus()


def test_fork_prewarm_presizes_and_matches_jax(tmp_path, fresh_process):
    jcache, pcache = str(tmp_path / "jax"), str(tmp_path / "port")
    jdag = jgen.random_gossip_dag(FORK["n"], FORK["e"], seed=FORK["seed"])
    pdag = pgen.random_gossip_dag(FORK["n"], FORK["e"], seed=FORK["seed"])
    j = JForkHashgraph(jdag.participants, k=FORK["k"],
                       verify_signatures=False)
    p1 = ForkHashgraph(pdag.participants, k=FORK["k"],
                       verify_signatures=False, device="cpu")
    j._aot_dir, p1._aot_dir = jcache, pcache
    _fork_stream(j, jdag, FORK["every"])
    _fork_stream(p1, pdag, FORK["every"])
    entries = aot.load_manifest(pcache)
    assert len(entries) > 1 and entries == jaot.load_manifest(jcache)
    assert all("sched" in e for e in entries)

    p2 = ForkHashgraph(pdag.participants, k=FORK["k"],
                       verify_signatures=False, device="cpu")
    res = aot.prewarm_engine(p2, pcache)
    scheds = {tuple(e["sched"]) for e in entries}
    assert res == {"compiled": len(scheds), "from_manifest": len(entries),
                   "xla_compiles": 0}
    assert p2._caps == p1._caps
    caps_at_boot = p2._caps
    c0 = aot.compile_counts()["traces"]
    _fork_stream(p2, pdag, FORK["every"])
    assert p2._caps == caps_at_boot
    assert aot.compile_counts()["traces"] == c0
    assert p2.consensus == p1.consensus == j.consensus and j.consensus
    assert p2.commit_digest == j.commit_digest


_FORK_CHILD = r"""
import json, sys
from babble_tpu_torch.ops import aot
from babble_tpu_torch.consensus.fork_engine import ForkHashgraph
from babble_tpu_torch.sim.generator import random_gossip_dag

cache, warm = sys.argv[1], sys.argv[2] == "warm"
aot.configure(cache)
dag = random_gossip_dag(4, 40, seed=21)
eng = ForkHashgraph(dag.participants, k=2, verify_signatures=False,
                    device="cpu")
eng._aot_dir = cache
res = aot.prewarm_engine(eng, cache) if warm else None
boot, caps = aot.compile_counts()["traces"], eng._caps
for i, ev in enumerate(dag.events):
    eng.insert_event(ev.clone())
    if (i + 1) % 6 == 0:
        eng.run_consensus()
eng.run_consensus()
print(json.dumps({"consensus": eng.consensus, "prewarm": res,
                  "caps_at_boot": list(caps), "caps": list(eng._caps),
                  "cold_dispatches": aot.compile_counts()["traces"] - boot}))
"""


def test_fork_prewarm_cold_vs_warm_processes(tmp_path):
    cache = str(tmp_path / "aot")

    def run(mode):
        out = subprocess.run(
            [sys.executable, "-c", _FORK_CHILD, cache, mode], cwd=REPO,
            capture_output=True, text=True, timeout=300,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    cold, warm = run("cold"), run("warm")
    assert cold["cold_dispatches"] > 0, cold
    assert warm["cold_dispatches"] == 0, (cold, warm)
    assert warm["prewarm"]["compiled"] > 0
    assert warm["caps"] == warm["caps_at_boot"] == cold["caps"]
    assert warm["consensus"] == cold["consensus"] and cold["consensus"]


WIDE = dict(n=4, e=48, seed=23, e_cap=512, s_cap=128, r_cap=16, every=48)


def test_wide_prewarm_is_a_semantic_noop_against_jax(tmp_path, monkeypatch,
                                                     fresh_process):
    cache = str(tmp_path / "aot")
    caps = {k: WIDE[k] for k in ("e_cap", "s_cap", "r_cap")}
    jdag = jgen.random_gossip_dag(WIDE["n"], WIDE["e"], seed=WIDE["seed"])
    pdag = pgen.random_gossip_dag(WIDE["n"], WIDE["e"], seed=WIDE["seed"])
    w1 = WideHashgraph(pdag.participants, verify_signatures=False,
                       device="cpu", **caps)
    calls = []
    real = ss.ss_counts_acc

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pwide, "ss_counts_acc", spy)
    res = aot.prewarm_engine(w1, cache)
    assert res == {"compiled": 1, "from_manifest": 0, "xla_compiles": 0}
    assert calls, "the warm-up pass must reach the ss_count wrapper"
    jw = JWideHashgraph(jdag.participants, verify_signatures=False, **caps)
    assert aot.load_manifest(cache) == [{
        "kind": "wide", "cfg": jaot._cfg_key(jw.cfg),
        "n_blocks": jw.stream.C}]
    w2 = WideHashgraph(pdag.participants, verify_signatures=False,
                       device="cpu", **caps)
    for eng, dag in ((w1, pdag), (w2, pdag), (jw, jdag)):
        _fork_stream(eng, dag, WIDE["every"])
    assert w1.consensus_events() == w2.consensus_events() \
        == jw.consensus_events()
    assert len(w1.consensus_events()) > 0
    assert w1.commit_digest == jw.commit_digest


def test_build_counters_count_a_gpp_build_then_a_hit(tmp_path, monkeypatch,
                                                     fresh_process):
    # configure names the manifest's root and leaves the libraries in
    # the package's hash-named build; the builds here go to a fresh one
    builds = (cuda_build.BUILD_DIR, native.BUILD_DIR)
    aot.configure(str(tmp_path / "cache"))
    assert (cuda_build.BUILD_DIR, native.BUILD_DIR) == builds
    root = str(tmp_path / "build")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", root)
    monkeypatch.setattr(native, "BUILD_DIR", root)
    reg = Registry()
    aot.bind_registry(reg)
    c0 = aot.compile_counts()
    path = native.build("graph_builder")
    assert os.path.dirname(path) == root and os.path.exists(path)
    c1 = aot.compile_counts()
    assert native.build("graph_builder") == path
    c2 = aot.compile_counts()
    delta = {k: (c1[k] - c0[k], c2[k] - c1[k]) for k in c0}
    assert delta == {"cache_misses": (1, 0), "xla_compiles": (1, 0),
                     "cache_hits": (0, 1), "traces": (0, 0)}
    # the CUDA build module reports a library found built as a hit (no nvcc
    # here, so the miss side runs only on the card)
    open(cuda_build.library_path("la_walk"), "wb").close()
    assert cuda_build.build(["la_walk"]) == {"la_walk": "cached"}
    assert aot.compile_counts()["cache_hits"] - c2["cache_hits"] == 1
    text = reg.exposition().splitlines()
    for series, want in (("babble_compile_cache_hits_total", 2),
                         ("babble_compile_cache_misses_total", 1),
                         ("babble_xla_compiles_total", 1),
                         ("babble_jit_traces_total", 0)):
        assert f"{series} {want}" in text, (series, text)


def test_concurrent_writers_lose_no_entry(tmp_path):
    cache = str(tmp_path / "aot")
    writers, each = 8, 25
    start = threading.Barrier(writers)

    def write(w):
        start.wait(timeout=30)
        for i in range(each):
            aot.record_fork_caps(cache, n=w, k=2, caps=(64, 16, 8),
                                 sched=(i, 4))

    threads = [threading.Thread(target=write, args=(w,))
               for w in range(writers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    got = {(e["n"], e["sched"][0]) for e in aot.load_manifest(cache)}
    assert got == {(w, i) for w in range(writers) for i in range(each)}
    with open(aot.manifest_path(cache)) as f:
        assert json.load(f)["version"] == aot.ENGINE_CACHE_VERSION \
            == jaot.ENGINE_CACHE_VERSION


def _ingested(n=8, e=512, seed=3, r_cap=32):
    dag = bt.random_gossip_arrays(n, e, seed=seed)
    cfg = DagConfig(n=n, e_cap=e, s_cap=max(64, dag.max_chain + 1),
                    r_cap=r_cap)
    st = ingest.ingest_impl(cfg, init_state(cfg, device="cpu"), "full",
                            bt.batch_from_arrays(dag, device="cpu"))
    return cfg, st, dag


def _tf32_site(name):
    if name == "fame_diagonal":
        cfg, st, _ = _ingested()
        return lambda: pfame.decide_fame_impl(cfg, st, gate=True)
    if name == "fame_block":
        cfg, st, _ = _ingested()
        return lambda: pfame.decide_fame_block_impl(cfg, st, True, True)
    if name == "flush_f32_votes":
        from babble_tpu_torch.sim.live import live_stream

        dag = bt.random_gossip_arrays(4, 360, seed=17)
        cfg = DagConfig(n=4, e_cap=512, s_cap=max(64, dag.max_chain + 1),
                        r_cap=64)
        return lambda: live_stream(cfg, dag, 8, gate=True, device="cpu")[0]
    if name == "wide_fame_tally":
        dag = bt.random_gossip_arrays(8, 600, seed=3)
        cfg = DagConfig(n=8, e_cap=256, s_cap=64, r_cap=16, coord8=True)
        return lambda: bt.stream_consensus(
            cfg, dag, batch_events=100, n_blocks=3, seq_window=8,
            compact_min=32, device="cpu").state
    gen = torch.Generator().manual_seed(5)
    la = torch.randint(-1, 40, (24, 300), generator=gen, dtype=torch.int32)
    fd = torch.randint(0, 40, (20, 300), generator=gen, dtype=torch.int32)
    fd[fd > 36] = torch.iinfo(torch.int32).max
    return lambda: (ss.ss_counts_onehot(la, fd, 39, k_chunk_elems=4096),
                    ss.ss_counts_compare(la, fd))


def _flat(out):
    return [out] if isinstance(out, torch.Tensor) else list(out)


@pytest.mark.parametrize("site", ["fame_diagonal", "fame_block",
                                  "flush_f32_votes", "wide_fame_tally",
                                  "ss_onehot"])
def test_tally_sites_leave_the_tf32_flag_alone(site):
    run = _tf32_site(site)
    flag = torch.backends.cuda.matmul
    before = flag.allow_tf32
    try:
        flag.allow_tf32 = False
        want = _flat(run())
        flag.allow_tf32 = True
        got = _flat(run())
        assert flag.allow_tf32 is True
    finally:
        flag.allow_tf32 = before
    assert len(got) == len(want)
    assert all(a is b is None or torch.equal(a, b)
               for a, b in zip(got, want))
    if site == "ss_onehot":
        assert torch.equal(got[0], got[1])


def test_prewarm_touches_neither_the_engine_state_nor_a_scratch_row(
        fresh_process, tmp_path):
    """A prewarm flush runs on a scratch state with an all-padding batch
    built on the device: the engine's state tensors stay the same
    objects with the same values, and the padding lanes (every lane)
    write only sentinel rows, so the flushed scratch (input and output)
    equals a fresh ``init_state`` on every field, packed and not, gated
    and not."""
    for packed in (True, False):
        for gate in (True, False):
            cfg = DagConfig(n=4, e_cap=64, s_cap=16, r_cap=16,
                            packed=packed)
            scratch = init_state(cfg, device="cpu")
            out = flush.live_flush(cfg, 4, flush.bucket_f(1, 65), gate,
                                   scratch,
                                   aot._padding_batch(8, (2, 4), CPU))
            fresh = init_state(cfg, device="cpu")
            # the prewarm reuses one scratch across keys: both the input
            # and the output stay a fresh init_state
            assert all(torch.equal(getattr(st, f), getattr(fresh, f))
                       for st in (out, scratch)
                       for f in fresh._fields), (packed, gate)

    dag = pgen.random_gossip_dag(4, 40, seed=13)
    eng = bt.TorchHashgraph(dag.participants, verify_signatures=False,
                            device="cpu", **FUSED)
    _stream(eng, dag, 8)
    before = {f: (getattr(eng.state, f), getattr(eng.state, f).clone())
              for f in eng.state._fields}
    assert aot.prewarm_engine(eng, str(tmp_path / "aot"))["compiled"] == 2
    for f, (obj, val) in before.items():
        assert getattr(eng.state, f) is obj and torch.equal(obj, val), f
