"""babble-tpu's consensus math in PyTorch, for one NVIDIA H100.

A port of the JAX package ``babble_tpu`` (which stays the reference):
the same dense struct-of-arrays DAG state, the same batch consensus
step — coordinate ingest, round assignment, fame, order — and the same
live flush (incremental ingest, then fame and order over a window of
open rounds; ``ops/flush.py``, driven by ``sim/live.py live_stream``) as
torch tensor code, with the JAX package's one Pallas TPU kernel (the
last-ancestor walk) rewritten by hand in CUDA for Hopper
(``csrc/la_walk.cu``), and the consensus engine around them
(``consensus/engine.py TorchHashgraph``: host DAG, batching, the
latency/throughput dispatch, compaction, commit order and digest, and
the membership plane's join/leave epoch transitions), the fork-aware
byzantine pair (``ops/forks.py`` with its hand-written strongly-see
compare-count ``csrc/fork_ss.cu``, ``consensus/fork_engine.py
ForkHashgraph`` and the ``ForkOracle``), the column-blocked wide-N
pipeline and its rolling-window stream (``ops/wide.py``,
``ops/stream.py stream_consensus``, with the hand-written blocked
strongly-see count ``csrc/ss_count.cu``) and the live engine over it
(``consensus/wide_engine.py WideHashgraph``), with its
checkpoints and fast-forward snapshots (``store/``: the JAX package's
FORMAT v6 bytes, restorable across the packages) and the crypto and
msgpack they stand on (``crypto/``, ``codec.py``), and the node runtime
around the engine (``node/`` ``Core`` and ``Node``: gossip, commits,
fast-forward, membership sync; ``net/`` commands and the in-memory
transport; ``wal/``; ``obs/``), whose wire bytes, WAL segments and PEM
key files are the JAX package's, and the independent references the
engines are held to: the JAX package's C++ gossip generator and
consensus baseline (``native/``, built with g++ at first use) and the
straight-line ``OracleHashgraph`` (``consensus/oracle.py``, over
``store/inmem.py``), and the operator's host tools: the fleet's conf,
sweeps and traces (``fleet.py``, the ``fleet`` and ``testnet
health|trace`` verbs of ``cli.py``) and babble-lint (``analysis/``,
the ``lint`` verb), which run without torch.  It imports torch, numpy
and the standard library only.

Entry points take an explicit ``device`` ("cuda" by default); pass
``device="cpu"`` to run every stage in plain torch on the CPU.

    from babble_tpu_torch import (
        DagConfig, batch_from_arrays, consensus_step, init_state,
        random_gossip_arrays,
    )

    dag = random_gossip_arrays(64, 65536, seed=7)
    cfg = DagConfig(n=64, e_cap=65536, s_cap=dag.max_chain + 1, r_cap=512)
    out = consensus_step(cfg, "walk", init_state(cfg), batch_from_arrays(dag))
    live, log = live_stream(cfg._replace(packed=True), dag, chunk=256)

    eng = TorchHashgraph(dag.participants(), verify_signatures=False)
    for ev in events_from_arrays(dag):
        eng.insert_event(ev)
    committed = eng.run_consensus()
    save_checkpoint(eng, "ckpt")
    eng = load_checkpoint("ckpt")

    wide = DagConfig(n=24, e_cap=1400, s_cap=110, r_cap=16, coord8=True)
    stream = stream_consensus(wide, random_gossip_arrays(24, 2800, seed=13),
                              batch_events=350, n_blocks=3, seq_window=16,
                              compact_min=64)
"""

# Names resolve on first use (PEP 562), so that host tools which never
# touch a tensor (``python -m babble_tpu_torch.cli lint``, the fleet
# sweeps) start without importing torch.
_EXPORTS = {
    "TorchHashgraph": "consensus.engine",
    "ForkHashgraph": "consensus.fork_engine",
    "OracleHashgraph": "consensus.oracle",
    "WideHashgraph": "consensus.wide_engine",
    "EventBatch": "ops.ingest",
    "DagConfig": "ops.state", "DagState": "ops.state",
    "assert_consensus_parity": "ops.state", "init_state": "ops.state",
    "state_from_numpy": "ops.state", "state_to_numpy": "ops.state",
    "ArrayDag": "sim.arrays", "batch_from_arrays": "sim.arrays",
    "events_from_arrays": "sim.arrays",
    "random_byzantine_fork_batch": "sim.arrays",
    "random_gossip_arrays": "sim.arrays",
    "random_byzantine_dag": "sim.generator",
    "random_churn_dag": "sim.generator",
    "random_gossip_dag": "sim.generator",
    "WideStream": "ops.stream", "stream_consensus": "ops.stream",
    "run_wide_pipeline": "ops.wide",
    "live_stream": "sim.live",
    "consensus_step": "step",
    "load_checkpoint": "store.checkpoint",
    "load_snapshot": "store.checkpoint",
    "save_checkpoint": "store.checkpoint",
    "snapshot_bytes": "store.checkpoint",
}


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = [
    "ArrayDag", "DagConfig", "DagState", "EventBatch", "ForkHashgraph",
    "OracleHashgraph", "TorchHashgraph", "WideHashgraph", "WideStream",
    "assert_consensus_parity", "batch_from_arrays", "consensus_step",
    "events_from_arrays", "init_state", "live_stream", "load_checkpoint",
    "load_snapshot", "random_byzantine_dag", "random_byzantine_fork_batch",
    "random_churn_dag", "random_gossip_arrays",
    "random_gossip_dag", "run_wide_pipeline", "save_checkpoint",
    "snapshot_bytes", "state_from_numpy", "state_to_numpy",
    "stream_consensus",
]
