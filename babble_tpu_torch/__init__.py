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
``store/inmem.py``).  It imports torch, numpy and the standard library
only.

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

from .consensus.engine import TorchHashgraph
from .consensus.fork_engine import ForkHashgraph
from .consensus.oracle import OracleHashgraph
from .consensus.wide_engine import WideHashgraph
from .ops.ingest import EventBatch
from .ops.state import (
    DagConfig, DagState, assert_consensus_parity, init_state,
    state_from_numpy, state_to_numpy,
)
from .sim.arrays import (
    ArrayDag, batch_from_arrays, events_from_arrays, random_byzantine_fork_batch,
    random_gossip_arrays,
)
from .sim.generator import (
    random_byzantine_dag, random_churn_dag, random_gossip_dag,
)
from .ops.stream import WideStream, stream_consensus
from .ops.wide import run_wide_pipeline
from .sim.live import live_stream
from .step import consensus_step
from .store.checkpoint import (
    load_checkpoint, load_snapshot, save_checkpoint, snapshot_bytes,
)

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
