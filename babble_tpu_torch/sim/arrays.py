"""Array-native DAG generation: the zero-object simulation path.

The port's copy of the JAX package's ``sim/arrays.py`` generator and
schedule builder (the pure-Python/numpy branches; the native C++ builder
is not copied — both give bit-identical arrays).  ``batch_from_arrays``
returns a torch ``EventBatch`` on a given device.

The gossip shape follows the reference's live loop (node/node.go:193-222):
each step one receiver syncs from one random sender, minting an event
with parents (own head, sender head).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

_BASE_TS = 1_700_000_000_000_000_000
_MASK64 = (1 << 64) - 1


@dataclass
class ArrayDag:
    """Struct-of-arrays DAG; slot == generation order == topological."""

    n: int
    sp: np.ndarray        # i32[E] self-parent slot, -1 for roots
    op: np.ndarray        # i32[E] other-parent slot, -1 for roots
    creator: np.ndarray   # i32[E]
    seq: np.ndarray       # i32[E]
    ts: np.ndarray        # i64[E]
    mbit: np.ndarray      # bool[E]
    levels: np.ndarray    # i32[E]
    seed: int

    @property
    def n_events(self) -> int:
        return len(self.sp)

    @property
    def n_levels(self) -> int:
        return int(self.levels.max()) + 1 if len(self.levels) else 0

    @property
    def max_chain(self) -> int:
        return int(self.seq.max()) + 1 if len(self.seq) else 0

    def participants(self) -> Dict[str, int]:
        """Fake identities compatible with ``sim.generator``'s naming."""
        from .generator import _fake_pub

        return {
            ("0x" + _fake_pub(i).hex().upper()): i for i in range(self.n)
        }


def _splitmix64(state: int) -> Tuple[int, int]:
    state = (state + 0x9E3779B97F4A7C15) & _MASK64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return state, z ^ (z >> 31)


def random_gossip_arrays(
    n: int,
    n_events: int,
    seed: int = 0,
    ts_granularity_ns: int = 1_000,
    base_ts: int = _BASE_TS,
) -> ArrayDag:
    """Generate a gossip DAG as dense numpy arrays (pure Python; the
    same arrays as the JAX package's generator for the same seed)."""
    sp = np.full(n_events, -1, np.int32)
    op = np.full(n_events, -1, np.int32)
    creator = np.zeros(n_events, np.int32)
    seq = np.zeros(n_events, np.int32)
    ts = np.full(n_events, base_ts, np.int64)
    mbit = np.zeros(n_events, bool)
    levels = np.zeros(n_events, np.int32)

    st = (seed * 2 + 1) & _MASK64
    heads = [0] * n
    seqs = [1] * n
    lv = [0] * n_events
    k = 0
    for i in range(min(n, n_events)):
        creator[k] = i
        st, z = _splitmix64(st)
        mbit[k] = bool(z & 1)
        heads[i] = k
        k += 1

    t = 0
    while k < n_events:
        t += 1
        st, z = _splitmix64(st)
        r = int(z % n)
        st, z = _splitmix64(st)
        s = int(z % (n - 1))
        if s >= r:
            s += 1
        raw = t * 1_987_963
        ts[k] = base_ts + (raw // ts_granularity_ns) * ts_granularity_ns
        sps, opsl = heads[r], heads[s]
        sp[k], op[k] = sps, opsl
        creator[k] = r
        seq[k] = seqs[r]
        seqs[r] += 1
        lv[k] = 1 + max(lv[sps], lv[opsl])
        st, z = _splitmix64(st)
        mbit[k] = bool(z & 1)
        heads[r] = k
        k += 1

    levels[:] = lv
    return ArrayDag(n, sp, op, creator, seq, ts, mbit, levels, seed)


def random_walk_arrays(n: int, e_cap: int, seed: int = 0, seq_base=0,
                       n_events=None, topological: bool = True):
    """The walk's ``[E+1]`` int32 inputs (``sp``, ``op``, ``creator``,
    ``seq``) for ``n_events`` events (default ``e_cap``), made with numpy
    from ``seed``; any ``n >= 1``, unlike the gossip generator.  Creators
    are uniform; ``sp`` is the creator's previous event (-1 for its
    first); ``op`` is a uniform earlier slot (-1 for slot 0); creator
    ``c``'s seqs count up from ``seq_base`` (an int, or one per creator).
    With ``topological=False``, ``op`` is any index in
    ``[-3, e_cap + 3]``, forward references and out-of-range ones
    included.  Rows past the events hold sp = op = -1, creator n, seq -1."""
    rng = np.random.default_rng(seed)
    k = e_cap if n_events is None else n_events
    base = np.broadcast_to(np.asarray(seq_base, np.int64), (n,))
    creator = rng.integers(0, n, size=k)
    sp = np.full(e_cap + 1, -1, np.int32)
    op = np.full(e_cap + 1, -1, np.int32)
    cr = np.full(e_cap + 1, n, np.int32)
    seq = np.full(e_cap + 1, -1, np.int32)
    head = np.full(n, -1, np.int64)
    count = np.zeros(n, np.int64)
    for x, c in enumerate(creator.tolist()):
        sp[x] = head[c]
        seq[x] = base[c] + count[c]
        head[c] = x
        count[c] += 1
    cr[:k] = creator
    if not topological:
        op[:k] = rng.integers(-3, e_cap + 4, size=k)
    elif k > 1:
        op[1:k] = (rng.random(k - 1) * np.arange(1, k)).astype(np.int32)
    return dict(sp=sp, op=op, creator=cr, seq=seq)


def build_schedule(levels: np.ndarray, n_levels: int = 0) -> np.ndarray:
    """Group indices by level into an i32[T, B] table, -1 padded (the
    ingest schedule; stable order within a level)."""
    k = len(levels)
    if k == 0:
        return np.full((1, 1), -1, np.int32)
    if not n_levels:
        n_levels = int(levels.max()) + 1
    order = np.argsort(levels, kind="stable")
    sorted_lv = levels[order]
    ulev, starts, counts = np.unique(
        sorted_lv, return_index=True, return_counts=True
    )
    width = int(counts.max())
    sched = np.full((n_levels, width), -1, np.int32)
    cols = np.arange(k) - starts[np.searchsorted(ulev, sorted_lv)]
    sched[sorted_lv, cols] = order.astype(np.int32)
    return sched


def events_from_arrays(dag: ArrayDag):
    """Materialize Event objects from an ArrayDag (engine interop).
    Pseudo-signatures derive from the slot so hashes are deterministic."""
    from ..core.event import Event, EventBody
    from .generator import _fake_pub

    pubs = [_fake_pub(i) for i in range(dag.n)]
    events = []
    hexes = []
    for k in range(dag.n_events):
        body = EventBody(
            transactions=[],
            self_parent=hexes[dag.sp[k]] if dag.sp[k] >= 0 else "",
            other_parent=hexes[dag.op[k]] if dag.op[k] >= 0 else "",
            creator=pubs[dag.creator[k]],
            timestamp=int(dag.ts[k]),
            index=int(dag.seq[k]),
        )
        ev = Event(body=body, r=(k << 1) | 1, s=(k << 2) | 1)
        events.append(ev)
        hexes.append(ev.hex())
    return events


def batch_from_arrays(dag: ArrayDag, bucket=None, device="cuda"):
    """ArrayDag -> ops.ingest.EventBatch on ``device`` (one full-DAG
    batch, padded to ``bucket(k)`` when a bucketing function is given)."""
    from ..ops.ingest import EventBatch

    k = dag.n_events
    kpad = bucket(k) if bucket else k
    sched = build_schedule(dag.levels)

    def pad1(a, fill, dtype):
        out = np.full(kpad, fill, dtype)
        out[:k] = a
        return torch.from_numpy(out).to(device)

    return EventBatch(
        sp=pad1(dag.sp, -1, np.int32),
        op=pad1(dag.op, -1, np.int32),
        creator=pad1(dag.creator, 0, np.int32),
        seq=pad1(dag.seq, 0, np.int32),
        ts=pad1(dag.ts, 0, np.int64),
        mbit=pad1(dag.mbit, False, bool),
        k=torch.tensor(k, dtype=torch.int32, device=device),
        sched=torch.from_numpy(sched).to(device),
    )
