"""Live flushes over an array DAG: a gossip stream fed to
``ops/flush.py live_flush_impl`` chunk by chunk.

The port has no engine yet, so this module stands in for the JAX
package's ``TpuHashgraph`` latency surface (``consensus/engine.py``
``build_batch``, ``_latency_ok``, ``_frontier_f``, ``_flush_live`` and
the frontier mirror of ``_collect_ordered``).  It copies the engine's
dispatch rules and adds no policy of its own:

- the batch of slots ``[lo, hi)``: padded to ``bucket(k)`` lanes, its
  level schedule padded to ``bucket(t, 1) x bucket(b, 1)``;
- W from host mirrors of ``max_round`` and ``lcr`` read after each
  flush (capped at ``HEAD_GATE_HORIZON + 2`` with the gate on);
- F from the mirror of the first live row whose ``rr`` is undecided;
- where the engine would leave the latency surface (no W bucket fits,
  the window top or the rounds overrun ``r_cap``, the window undershoots
  without the gate to explain it), it raises ``LatencyRefused``: there
  is no throughput fallback here.

Slots of an ``ArrayDag`` are device slots (the engine's ``slot_base``
stays 0: nothing is compacted), and the stream runs on the device of
its state.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.flush import bucket_f, bucket_w, live_flush_impl
from ..ops.ingest import EventBatch
from ..ops.order import MEDIAN_CHUNK_THRESHOLD
from ..ops.state import (
    HEAD_GATE_HORIZON, DagConfig, DagState, bucket, head_round_min_math,
    init_state,
)
from .arrays import ArrayDag, build_schedule

#: pending-batch size above which the engine takes the throughput
#: surface (the JAX package's ``engine.LATENCY_K_MAX``)
LATENCY_K_MAX = 256


class LatencyRefused(RuntimeError):
    """The engine would leave the latency surface for this flush."""


class Mirrors(NamedTuple):
    """Host copies of the scalars the dispatch reads, taken after a
    flush: ``frontier`` is the first live row whose ``rr`` is undecided
    (``n_events`` when there is none)."""

    max_round: int
    lcr: int
    frontier: int
    n_events: int
    r_off: int


class FlushRecord(NamedTuple):
    """One flush of a stream: events in the batch, the window W, the
    frontier height F, lcr after the flush, and the flush's wall ms
    (batch build and copy, the flush, and the mirror read that waits
    for the device)."""

    k: int
    W: int
    F: int
    lcr: int
    ms: float


def read_mirrors(state: DagState) -> Mirrors:
    """The dispatch mirrors, in one read from the device."""
    e1 = state.rr.shape[0]
    idx = torch.arange(e1, dtype=torch.int32, device=state.rr.device)
    und = (idx < state.n_events) & (state.rr < 0)
    f0 = torch.where(und, idx, state.n_events).min()
    vals = torch.stack([state.max_round, state.lcr, f0, state.n_events,
                        state.r_off]).tolist()
    return Mirrors(*(int(v) for v in vals))


def chunk_levels(dag: ArrayDag, lo: int, hi: int) -> int:
    """Distinct topological levels among slots ``[lo, hi)``."""
    return len(np.unique(dag.levels[lo:hi]))


def stream_batch(dag: ArrayDag, lo: int, hi: int, device="cuda") -> EventBatch:
    """The EventBatch of slots ``[lo, hi)`` as the engine builds it:
    ``kpad = bucket(k)`` lanes, and the chunk's levels (ranked, so the
    schedule rows are the chunk's own levels in order) grouped by
    ``build_schedule`` and padded to powers of two.  ``lo == hi`` gives
    the empty drain batch (k = 0)."""
    k = hi - lo
    kpad = bucket(k)
    _, rank = np.unique(dag.levels[lo:hi], return_inverse=True)
    sched = build_schedule(rank.reshape(-1).astype(np.int32))
    t, b = sched.shape
    sched_p = np.full((bucket(t, 1), bucket(b, 1)), -1, np.int32)
    sched_p[:t, :b] = sched

    def pad1(a, fill, dtype):
        out = np.full(kpad, fill, dtype)
        out[:k] = a[lo:hi]
        return torch.from_numpy(out).to(device)

    return EventBatch(
        sp=pad1(dag.sp, -1, np.int32),
        op=pad1(dag.op, -1, np.int32),
        creator=pad1(dag.creator, 0, np.int32),
        seq=pad1(dag.seq, 0, np.int32),
        ts=pad1(dag.ts, 0, np.int64),
        mbit=pad1(dag.mbit, False, bool),
        k=torch.tensor(k, dtype=torch.int32, device=device),
        sched=torch.from_numpy(sched_p).to(device),
    )


def flush_shape(cfg: DagConfig, m: Mirrors, k: int, levels_new: int,
                gate: bool) -> Tuple[int, int]:
    """(W, F) for a flush of ``k`` events spanning ``levels_new`` levels,
    from the mirrors of the previous flush, as the engine's
    ``_latency_ok`` and ``_frontier_f`` pick them; raises where the
    engine would not take the latency surface, or would have to grow a
    capacity first."""
    e1 = cfg.e_cap + 1
    if k > LATENCY_K_MAX:
        raise LatencyRefused(f"batch of {k} > LATENCY_K_MAX {LATENCY_K_MAX}")
    if e1 * cfg.n > MEDIAN_CHUNK_THRESHOLD:
        raise LatencyRefused("the windowed median would need chunking")
    if m.n_events + k > cfg.e_cap:
        raise LatencyRefused(f"{m.n_events + k} events > e_cap {cfg.e_cap}")
    need_r = (max(m.max_round - m.r_off, 0) + 2
              + min(levels_new, max(8, levels_new // 4)))
    if need_r >= cfg.r_cap:
        raise LatencyRefused(f"rounds need r_cap > {need_r}")
    # open rounds the window must cover: the undecided span plus what
    # this batch can add (a round spans about 4 levels)
    est = m.max_round - max(m.lcr, -1) + max(2, levels_new // 4 + 1)
    if gate and est > HEAD_GATE_HORIZON + 2:
        est = HEAD_GATE_HORIZON + 2
    w = bucket_w(max(est, 1), cfg.r_cap)
    if w == 0:
        raise LatencyRefused(f"no W bucket covers {est} open rounds")
    if max(m.lcr + 1, 0) - m.r_off + w > cfg.r_cap - 1:
        raise LatencyRefused("the window top does not fit below r_cap")
    if m.max_round + levels_new - m.r_off >= cfg.r_cap - 2:
        raise LatencyRefused("no round headroom below r_cap")
    return w, bucket_f(m.n_events + k - m.frontier, e1)


def check_flush(cfg: DagConfig, state: DagState, before: Mirrors,
                after: Mirrors, W: int, gate: bool) -> None:
    """The engine's checks after a live flush: raise where it would
    finish the flush on the full-table surface instead."""
    if after.max_round - after.r_off >= cfg.r_cap - 1:
        raise LatencyRefused("rounds reached r_cap - 1")
    top = max(before.lcr, -1) + W
    if after.max_round > top:
        # a stalled gate explains rounds above the window top: the
        # engine defers them in place and stays on the latency surface
        if not (gate and int(head_round_min_math(cfg, state).item()) <= top):
            raise LatencyRefused(
                f"window undershoot: max_round {after.max_round} > {top}")


def live_stream(cfg: DagConfig, dag: ArrayDag, chunk: int, gate: bool = True,
                device="cuda", state: Optional[DagState] = None,
                stop: Optional[int] = None, drain: bool = True,
                ) -> Tuple[DagState, List[FlushRecord]]:
    """Stream ``dag`` through live flushes of ``chunk`` events, starting
    at slot ``state.n_events`` (a fresh state on ``device`` when none is
    given) and ending at slot ``stop`` (all slots by default); then,
    with ``drain``, flush empty batches until lcr stops moving.  Returns
    the final state and one ``FlushRecord`` per flush."""
    if not 1 <= chunk <= LATENCY_K_MAX:
        raise ValueError(f"chunk {chunk} not in [1, {LATENCY_K_MAX}]")
    if dag.max_chain >= cfg.s_cap:
        raise ValueError(f"chains of {dag.max_chain} need s_cap > {cfg.s_cap}")
    if state is None:
        state = init_state(cfg, device=device)
    dev = state.sp.device
    end = dag.n_events if stop is None else min(stop, dag.n_events)
    m = read_mirrors(state)
    lo = m.n_events
    log: List[FlushRecord] = []
    while lo < end or drain:
        hi = min(lo + chunk, end) if lo < end else lo
        t0 = time.perf_counter()
        batch = stream_batch(dag, lo, hi, dev)
        W, F = flush_shape(cfg, m, hi - lo, chunk_levels(dag, lo, hi), gate)
        state = live_flush_impl(cfg, W, F, gate, state, batch)
        after = read_mirrors(state)
        ms = (time.perf_counter() - t0) * 1e3
        check_flush(cfg, state, m, after, W, gate)
        log.append(FlushRecord(hi - lo, W, F, after.lcr, ms))
        if lo == hi and after.lcr == m.lcr:
            break
        m, lo = after, hi
    return state, log
