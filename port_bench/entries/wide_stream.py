"""Entry ``wide_stream``: a node catching up on a backlog through the
wide engine's device path, ``babble_tpu_torch/ops/stream.py WideStream``.

A job is one seeded gossip DAG streamed through one ``WideStream`` in
batches, each batch the cycle that ``stream_consensus`` and a wide node
run: ``slice_batch``, ``ingest`` with the window-wide fd schedule,
``consensus``, then ``compact`` (the suffix-min of parent slots and the
creators' final heads, as ``stream_consensus`` computes them, bound the
eviction).  Jobs run back to back, one client, closed loop; the window
cuts the last one.  The first job streams a DAG made from the run's
seed, the one the check compares; then the jobs cycle over a fixed pool
of ``pool`` DAGs (from ``pool_seed``) in an order drawn from the run's
seed, so that every seed times the same work.

What the window records, per batch: the latency from handing the batch
over until its ordering decisions are on the host (``consensus`` ends
in a read of ``rr``), the stage seconds ``WideStream.timings`` adds, and
the events newly ordered.  For the check, after every
``consensus``, the live window's rounds, witness flags, rounds received,
timestamps and witness table (``JobRecord``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..gen import gossip

STAGES = ("coords", "rounds", "fame", "order", "compact")


class JobRecord:
    """The program's outputs for one job, by global slot: per event
    ``round``, ``witness``, ``rr`` and ``cts`` (-2 in ``round`` = never
    read), and ``fame`` by witness slot.

    Read after every ``consensus``, over the whole live window, so an
    evicted row keeps the values it had when it left.  The witness flags
    and the witness table row of the window's first round are left out
    of a reading once a compaction has rolled the window: the program
    re-derives that row from a refreshed frontier and never reads it
    again (its fame and order were decided before), so what it holds
    there is not the program's answer.  Those values were read while the
    round was above the window's first row."""

    def __init__(self, dag):
        E = dag.n_events
        self.dag = dag
        self.round = np.full(E, -2, np.int32)
        self.witness = np.zeros(E, bool)
        self.witness_read = np.zeros(E, bool)
        self.rr = np.full(E, -2, np.int32)
        self.cts = np.zeros(E, np.int64)
        self.fame: Dict[int, int] = {}    # witness slot -> trilean
        self.completed = False

    def read(self, stream) -> None:
        st = stream.state
        ne, e0 = stream.n_live, stream.e_off
        r_off = int(st.r_off.item())
        rolled = e0 > 0 or r_off > 0
        rows = slice(e0, e0 + ne)
        rnd = st.round[:ne].cpu().numpy()
        self.round[rows] = rnd
        self.rr[rows] = st.rr[:ne].cpu().numpy()
        self.cts[rows] = st.cts[:ne].cpu().numpy()
        ok = rnd > r_off if rolled else rnd >= 0
        self.witness[rows] = np.where(ok, st.witness[:ne].cpu().numpy(),
                                      self.witness[rows])
        self.witness_read[rows] |= ok
        nr = int(st.max_round.item()) - r_off + 1
        lo = 1 if rolled else 0
        if nr > lo:
            wslot = st.wslot[lo:nr].cpu().numpy()
            famous = st.famous[lo:nr].cpu().numpy()
            got = wslot >= 0
            self.fame.update(zip((wslot[got] + e0).tolist(),
                                 famous[got].tolist()))


class Session:
    """Set-up, the measured window and the records of one run."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device="cuda", trace=None):
        from babble_tpu_torch.ops.state import DagConfig

        w = config["window"]
        self.n = int(config["n"])
        self.cfg = DagConfig(
            n=self.n, e_cap=int(w["e_cap"]), s_cap=int(w["s_cap"]),
            r_cap=int(w["r_cap"]), coord8=w["coord"] == "int8",
            coord16=w["coord"] == "int16",
        )
        self.n_blocks = int(w["n_blocks"])
        self.stream_kw = dict(round_margin=int(w["round_margin"]),
                              seq_window=int(w["seq_window"]))
        self.compact_min = int(w["compact_min"])
        self.traffic = traffic
        self.batch = int(traffic["batch_events"])
        self.seed = int(seed)
        self.device = torch.device(device)
        self.trace = trace
        events = int(traffic["job_events"])
        pool = [self._dag(int(traffic["pool_seed"]), j, events)
                for j in range(int(traffic["pool"]))]
        order = np.random.default_rng(self.seed & ((1 << 63) - 1)).permutation(
            len(pool))
        self.own = self._dag(self.seed, 0, events)
        self.dags = [pool[i] for i in order]
        self.records: List[JobRecord] = []
        self.batches: List[dict] = []

    # ------------------------------------------------------------------

    def _dag(self, seed: int, j: int, events: int):
        """DAG ``j`` of the family of ``seed``."""
        s = (seed * 1_000_003 + 7919 * (j + 1)) & ((1 << 63) - 1)
        return gossip.gossip_dag(self.n, events, s)

    def _run_job(self, dag, record: Optional[JobRecord], deadline=None,
                 on_batch=None) -> None:
        from babble_tpu_torch.ops.stream import (
            WideStream, _padded_schedule, slice_batch)

        cfg = self.cfg
        stream = WideStream(cfg, n_blocks=self.n_blocks,
                            record_ordered=False, device=self.device,
                            **self.stream_kw)
        E = dag.n_events
        big = np.iinfo(np.int64).max
        par = np.minimum(np.where(dag.sp >= 0, dag.sp.astype(np.int64), big),
                         np.where(dag.op >= 0, dag.op.astype(np.int64), big))
        sufmin = np.minimum.accumulate(par[::-1])[::-1]
        head_seqs = np.full(cfg.n, -1, np.int64)
        np.maximum.at(head_seqs, dag.creator, dag.seq)
        s_off = np.zeros(cfg.n, np.int64)
        a = 0
        while a < E:
            b = min(E, a + self.batch)
            before = {s: stream.timings.get(s, 0.0) for s in STAGES}
            t0 = time.perf_counter()
            depth = int(np.max(dag.seq[a:b] - s_off[dag.creator[a:b]],
                               initial=0))
            if depth >= cfg.s_cap:
                raise ValueError(f"in-window chain depth {depth} >= s_cap "
                                 f"{cfg.s_cap}")
            with _region("bench.slice_batch"):
                batch = slice_batch(dag, a, b, stream.e_off,
                                    device=self.device)
                sched = torch.tensor(
                    _padded_schedule(dag.levels[stream.e_off:b], cfg.e_cap),
                    device=self.device)
            with _region("bench.ingest"):
                stream.ingest(batch, fd_slot_sched=sched)
            with _region("bench.consensus"):
                fresh = stream.consensus(final=b == E)
            t1 = time.perf_counter()
            if record is not None:
                with _region("bench.record"):
                    record.read(stream)
            with _region("bench.compact"):
                k = stream.compact(
                    min_future_parent=int(sufmin[b]) if b < E else E,
                    head_seqs=head_seqs, compact_min=self.compact_min)
            s_off[:] = stream.state.s_off[:cfg.n].cpu().numpy()
            t2 = time.perf_counter()
            if on_batch is not None:
                on_batch({
                    "latency_s": t1 - t0, "seconds": t2 - t0,
                    "ordered": fresh, "evicted": k,
                    "stages": {s: stream.timings.get(s, 0.0) - before[s]
                               for s in STAGES},
                })
            a = b
            if deadline is not None and a < E and time.perf_counter() >= deadline:
                break
        if record is not None:
            record.completed = a >= E
        del stream

    # ------------------------------------------------------------------

    def warm_up(self) -> None:
        """One short job through every stage and batch shape the window
        uses: full batches, compaction, the final short batch."""
        t = self.traffic
        rest = int(t["job_events"]) % self.batch
        events = int(t["warmup_batches"]) * self.batch + rest
        self._run_job(self._dag(self.seed, -1, events), None)
        _sync(self.device)

    def window(self, seconds: float) -> float:
        """Jobs back to back until ``seconds`` have passed; returns the
        window's length in seconds (it ends with the batch that passes
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
            dag = self.own if j == 0 else self.dags[(j - 1) % len(self.dags)]
            rec = JobRecord(dag)
            self.records.append(rec)
            self._run_job(dag, rec, deadline=deadline, on_batch=on_batch)
            j += 1
        _sync(self.device)
        if tr is not None and tr.active:
            tr.stop()
        return time.perf_counter() - t0

    def release(self) -> None:
        """Free the program's device state before the reference runs."""
        self.dags = self.own = None
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
    """The traced run's call recorders: the shapes of every
    ``ss_counts_acc`` call the wide engine makes (``ops/wide.py`` calls
    it through its module namespace) for the ss_count roofline."""
    from babble_tpu_torch.ops import wide

    from ..roofline import ss_count
    from ..trace import CallRecorder

    return {"ss_count": CallRecorder(ss_count.call_shape, wide,
                                     "ss_counts_acc")}
