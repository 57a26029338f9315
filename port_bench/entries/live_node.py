"""Entry ``live_node``: a validator's node ordering gossip as it
arrives, through the engine a ``Node`` builds for its cache size:
``babble_tpu_torch/consensus/engine.py TorchHashgraph`` with the
configuration's ``window`` (``node_engine_kwargs(cache_size)``, key by
key).

A job is one seeded gossip DAG fed to a fresh engine in flushes of
``flush_events`` events, each flush what ``Core`` does after a sync:
``insert_event`` for each event, then one ``run_consensus_timed``
(the latency flush, or its throughput fallback, then the commit and the
rolling window).  One node, flushes back to back, closed loop.  The
first job is a DAG made from the run's seed, the one the check
compares; then the jobs cycle over a fixed pool of ``pool`` DAGs (from
``pool_seed``) in an order drawn from the run's seed, so that every
seed times the same work.  The window cuts the last job.

The events are built in set-up, unsigned (``verify_signatures`` off),
as ``sim/arrays.py events_from_arrays`` builds them: fixed identity
keys, a pseudo-signature from the slot.  An event's coin (the middle
bit of its hash, which the engine's coin rounds read) is part of the
event, so the DAG the reference reads carries the events' coins.

A finished job ends with one flush of no events with the engine's
finality gate lifted, as a finished ``WideStream`` ends with
``consensus(final=True)``: a live node advances its last consensus
round over the contiguous prefix of decided rounds, and holds the
events a later round receives while an earlier round has a witness
whose fame is undecided; the whole-DAG algorithm, which the reference
is, skips such a round.  Only the last rounds of a finite job differ so.

What the window records, per flush: its wall from the first insert to
the end of ``run_consensus_timed``, the events it committed, its
surface.  For the check (``JobRecord``): each event's round and witness
flag as the flush that ingested it left them, its round received and
consensus timestamp as the commit hands them over, each witness's fame
as the witness table holds it after every flush; and before a
compaction evicts a prefix, all of these over the whole live window.
"""

from __future__ import annotations

import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from ..gen import gossip

#: ``TorchHashgraph`` keywords a configuration's ``window`` may set
ENGINE_KEYS = ("e_cap", "auto_compact", "seq_window", "consensus_window",
               "finality_gate", "kernel_class", "inactive_rounds",
               "packed_votes", "frontier")


def _pub(i: int) -> bytes:
    """Creator ``i``'s identity key: 65 bytes shaped as an uncompressed
    SEC1 point (an identity only; nothing is signed)."""
    return b"\x04" + i.to_bytes(32, "big") + bytes(32)


class Job:
    """One DAG of the traffic: its arrays, as the reference reads them,
    and its events, in slot (topological) order."""

    def __init__(self, dag):
        from babble_tpu_torch.core.event import Event, EventBody

        pubs = [_pub(i) for i in range(dag.n)]
        events: List = []
        hexes: List[str] = []
        for k in range(dag.n_events):
            sp, op = int(dag.sp[k]), int(dag.op[k])
            body = EventBody(
                transactions=[],
                self_parent=hexes[sp] if sp >= 0 else "",
                other_parent=hexes[op] if op >= 0 else "",
                creator=pubs[int(dag.creator[k])],
                timestamp=int(dag.ts[k]),
                index=int(dag.seq[k]),
            )
            ev = Event(body=body, r=(k << 1) | 1, s=(k << 2) | 1)
            events.append(ev)
            hexes.append(ev.hex())
        self.events = events
        self.slot_of: Dict[str, int] = {h: k for k, h in enumerate(hexes)}
        coins = np.fromiter((ev.middle_bit() for ev in events), bool,
                            len(events))
        self.dag = gossip.GossipDag(dag.n, dag.sp, dag.op, dag.creator,
                                    dag.seq, dag.ts, coins, dag.levels,
                                    dag.seed)
        self.participants = {"0x" + p.hex().upper(): i
                             for i, p in enumerate(pubs)}


class JobRecord:
    """The program's outputs for one job, by slot: per event ``round``,
    ``witness``, ``rr`` and ``cts`` (-2 in ``round`` = never read), and
    ``fame`` by witness slot."""

    def __init__(self, job: Job):
        E = job.dag.n_events
        self.dag = job.dag
        self.slot_of = job.slot_of
        self.round = np.full(E, -2, np.int32)
        self.witness = np.zeros(E, bool)
        self.witness_read = np.zeros(E, bool)
        self.rr = np.full(E, -2, np.int32)
        self.cts = np.zeros(E, np.int64)
        self.fame: Dict[int, int] = {}    # witness slot -> trilean
        self.completed = False

    def read_rows(self, eng, g0: int, g1: int) -> None:
        """Round and witness flag of the live slots in ``[g0, g1)``."""
        base = eng.dag.slot_base
        g0 = max(g0, base)
        if g1 <= g0:
            return
        st = eng.state
        rows = slice(g0, g1)
        self.round[rows] = st.round[g0 - base:g1 - base].cpu().numpy()
        self.witness[rows] = st.witness[g0 - base:g1 - base].cpu().numpy()
        self.witness_read[rows] = True
        undecided = self.rr[rows] == -2
        self.rr[rows] = np.where(undecided, -1, self.rr[rows])

    def read_fame(self, eng) -> None:
        """Every witness's fame in the engine's witness table."""
        wslot = eng.state.wslot.cpu().numpy()
        famous = eng.state.famous.cpu().numpy()
        got = wslot >= 0
        self.fame.update(zip((wslot[got] + eng.dag.slot_base).tolist(),
                             famous[got].tolist()))

    def commit(self, events) -> None:
        for ev in events:
            s = self.slot_of[ev.hex()]
            self.rr[s] = ev.round_received
            self.cts[s] = ev.consensus_timestamp


class Session:
    """Set-up, the measured window and the records of one run."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device="cuda", trace=None):
        self.n = int(config["n"])
        self.engine_kw = {k: config["window"][k] for k in ENGINE_KEYS}
        self.traffic = traffic
        self.flush = int(traffic["flush_events"])
        self.seed = int(seed)
        self.device = torch.device(device)
        self.trace = trace
        events = int(traffic["job_events"])
        pool = [self._job(int(traffic["pool_seed"]), j, events)
                for j in range(int(traffic["pool"]))]
        order = np.random.default_rng(self.seed & ((1 << 63) - 1)).permutation(
            len(pool))
        self.first = self._job(self.seed, 0, events)
        self.own = self.first.dag
        self.jobs = [pool[i] for i in order]
        self.warm = self._job(self.seed, -1, int(traffic["warmup_flushes"])
                              * self.flush + 2 * self.flush)
        self.records: List[JobRecord] = []
        self.batches: List[dict] = []

    # ------------------------------------------------------------------

    def _job(self, seed: int, j: int, events: int) -> Job:
        """Job ``j`` of the family of ``seed``."""
        s = (seed * 1_000_003 + 7919 * (j + 1)) & ((1 << 63) - 1)
        return Job(gossip.gossip_dag(self.n, events, s))

    def _engine(self, job: Job, record: Optional[JobRecord]):
        from babble_tpu_torch.consensus.engine import TorchHashgraph

        eng = TorchHashgraph(dict(job.participants), verify_signatures=False,
                             device=self.device, **self.engine_kw)
        if record is not None:
            evict = eng.dag.evict_prefix
            # weak: a strong reference from the engine's own DAG would
            # keep a finished job's engine, and its device memory, alive
            # into the next job until a full garbage collection
            ref = weakref.ref(eng)

            def read_then_evict(new_base):
                # the rows leave the window with their final values
                e = ref()
                record.read_rows(e, e.dag.slot_base, e.dag.n_events)
                record.read_fame(e)
                return evict(new_base)

            eng.dag.evict_prefix = read_then_evict
        return eng

    def _run_job(self, job: Job, record: Optional[JobRecord], deadline=None,
                 on_batch=None, first_flush: Optional[int] = None) -> None:
        eng = self._engine(job, record)
        events = job.events
        E = len(events)

        def flush(a, b):
            t0 = time.perf_counter()
            with _region("bench.insert"):
                for ev in events[a:b]:
                    eng.insert_event(ev)
            with _region("bench.consensus"):
                committed, _ = eng.run_consensus_timed()
            t1 = time.perf_counter()
            if record is not None:
                with _region("bench.record"):
                    record.commit(committed)
                    record.read_rows(eng, a, b)
                    record.read_fame(eng)
            if on_batch is not None:
                on_batch({"latency_s": t1 - t0,
                          "ordered": len(committed), "events": b - a,
                          "path": eng.last_kernel_class,
                          "evicted": eng.dag.slot_base})

        a = 0
        while a < E:
            b = min(E, a + (first_flush if a == 0 and first_flush
                            else self.flush))
            flush(a, b)
            a = b
            if deadline is not None and a < E and \
                    time.perf_counter() >= deadline:
                break
        if a >= E:
            # A finished job ends as a finished stream does (WideStream's
            # final batch): one more flush with the finality gate lifted.
            # The live engine advances lcr over a contiguous decided
            # prefix only, so it holds the rounds above a round whose
            # fame the whole DAG never decides; the whole-DAG algorithm
            # skips that round and receives events above it.
            eng.finality_gate = False
            flush(E, E)
        if record is not None:
            record.completed = a >= E
        del eng

    # ------------------------------------------------------------------

    def warm_up(self) -> None:
        """One short job through both surfaces: a first flush of twice
        the flush size (above the latency surface's largest, so the
        throughput phases run), then flushes of the traffic's size."""
        self._run_job(self.warm, None, first_flush=2 * self.flush)
        _sync(self.device)

    def window(self, seconds: float) -> float:
        """Jobs back to back until ``seconds`` have passed; returns the
        window's length in seconds (it ends with the flush that passes
        the limit)."""
        tr = self.trace
        skip = int(self.traffic["trace_skip_batches"])
        span = int(self.traffic["trace_batches"])

        def on_batch(rec):
            rec["profiled"] = tr is not None and tr.active
            self.batches.append(rec)
            if tr is None:
                return
            i = len(self.batches)
            if i == skip:
                tr.start()
            elif i == skip + span:
                tr.stop()

        t0 = time.perf_counter()
        deadline = t0 + seconds
        j = 0
        while time.perf_counter() < deadline:
            job = self.first if j == 0 else self.jobs[(j - 1) % len(self.jobs)]
            rec = JobRecord(job)
            self.records.append(rec)
            self._run_job(job, rec, deadline=deadline, on_batch=on_batch)
            j += 1
        _sync(self.device)
        if tr is not None and tr.active:
            tr.stop()
        return time.perf_counter() - t0

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.jobs = self.first = self.warm = None
        _sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def pick_job(self) -> JobRecord:
        """The job the check compares: the first, the run's own DAG."""
        return self.records[0]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _region(name: str):
    """A profiler annotation: the traced run's idle gaps are named by the
    host stage they fall in."""
    return torch.profiler.record_function(name)


def recorders() -> dict:
    """No call recorders: the cell reads no kernel's roofline."""
    return {}

