"""Entry ``fork_pipeline``: the fork-aware (byzantine) engine's device
path, ``babble_tpu_torch/ops/forks.py fork_pipeline``, over whole DAGs.

Each call uploads one byzantine DAG's batch (``fork_batch_from_numpy``)
and runs ``fork_pipeline`` over it, as ``ForkHashgraph._run`` does over
its window on each ``run_consensus``, then reads its round-received and
timestamp decisions back to the host.  Calls run back to back, one
client, closed loop: the first on a DAG made from the run's seed, the
one the check compares, then over a fixed pool of ``pool`` DAGs (from
``pool_seed``) in an order drawn from the run's seed.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from ..gen import byzantine
from ..roofline import fork_ss
from ..trace import CallRecorder


class ForkRecord:
    """The program's outputs for one DAG, in ``compare.check``'s form."""

    def __init__(self, dag, out):
        E = int(dag[1]["n_events"])
        self.dag = dag          # (sizes, arrays), as the reference reads it
        self.round = out.round[:E].cpu().numpy()
        self.witness = out.witness[:E].cpu().numpy()
        self.witness_read = np.ones(E, bool)
        self.det = out.det[:E].cpu().numpy()
        self.rr = out.rr[:E].cpu().numpy()
        self.cts = out.cts[:E].cpu().numpy()
        wslot = out.wslot.cpu().numpy()
        famous = out.famous.cpu().numpy()
        ok = wslot >= 0
        self.fame: Dict[int, int] = dict(zip(wslot[ok].tolist(),
                                             famous[ok].tolist()))
        self.completed = True


class Session:
    """Set-up, the measured window and the records of one run."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device="cuda", trace=None):
        self.n = int(config["n"])
        self.gen = dict(config["generator"])
        self.events = int(traffic["job_events"])
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.trace = trace
        pool = [self._dag(int(traffic["pool_seed"]), j)
                for j in range(int(traffic["pool"]))]
        order = np.random.default_rng(self.seed & ((1 << 63) - 1)).permutation(
            len(pool))
        self.own = self._dag(self.seed, 0)
        self.dags = [pool[i] for i in order]
        self.records: List[ForkRecord] = []
        self.batches: List[dict] = []

    def _dag(self, seed: int, j: int):
        """DAG ``j`` of the family of ``seed``: ``(sizes, arrays)``."""
        s = (seed * 1_000_003 + 7919 * (j + 1)) & ((1 << 63) - 1)
        return byzantine.random_byzantine_fork_arrays(
            self.n, self.events, seed=s, **self.gen)

    def _call(self, dag, record: bool, ss) -> dict:
        from babble_tpu_torch.ops.forks import (
            ForkConfig, fork_batch_from_numpy, fork_pipeline)

        sizes, arrays = dag
        stats: dict = {}
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.upload"):
            batch = fork_batch_from_numpy(arrays, device=self.device)
        with torch.profiler.record_function("bench.fork_pipeline"):
            out = fork_pipeline(ForkConfig(**sizes), batch, ss=ss,
                                stats=stats)
            rr = out.rr.cpu()
        t1 = time.perf_counter()
        if record:
            self.records.append(ForkRecord(dag, out))
        return {"latency_s": t1 - t0, "seconds": time.perf_counter() - t0,
                "ordered": int((rr >= 0).sum()),
                "closure_passes": stats.get("closure_passes", 0)}

    def warm_up(self) -> None:
        """One call on the first pool DAG: every kernel and shape a call
        uses."""
        self._call(self.dags[0], False, self._ss())
        _sync(self.device)

    def _ss(self):
        from babble_tpu_torch.ops import forks

        tr = self.trace
        if tr is not None and tr.active:
            return tr.recorders["fork_ss"].wrap(forks.ss_counts)
        return forks.ss_counts

    def window(self, seconds: float) -> float:
        tr = self.trace
        skip = int(self.traffic["trace_skip_batches"])
        span = int(self.traffic["trace_batches"])
        t0 = time.perf_counter()
        deadline = t0 + seconds
        j = 0
        while time.perf_counter() < deadline:
            dag = self.own if j == 0 else self.dags[(j - 1) % len(self.dags)]
            rec = self._call(dag, j == 0, self._ss())
            rec["profiled"] = tr is not None and tr.active
            self.batches.append(rec)
            j += 1
            if tr is not None:
                if j == skip:
                    tr.start()
                elif j == skip + span:
                    tr.stop()
        _sync(self.device)
        if tr is not None and tr.active:
            tr.stop()
        return time.perf_counter() - t0

    def release(self) -> None:
        self.dags = self.own = None
        _sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def pick_job(self) -> ForkRecord:
        """The job the check compares: the first, the run's own DAG."""
        return self.records[0]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def recorders() -> dict:
    """The traced run's recorders: the shapes of every strongly-see
    compare-count the pipeline makes, for the fork_ss roofline."""
    return {"fork_ss": CallRecorder(fork_ss.call_shape)}
