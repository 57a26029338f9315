"""The benchmark's byzantine traffic: a frozen numpy copy of the
program's ``babble_tpu_torch/sim/arrays.py random_byzantine_fork_arrays``
(with ``cap_schedule_width`` and the numpy level schedule), kept here so
that later changes to the program cannot change the traffic.  No cell
runs it yet; ``test_port_bench.py`` pins its output to a digest.
"""

from __future__ import annotations

import numpy as np

INT32_MAX = int(np.iinfo(np.int32).max)
_BASE_TS = 1_700_000_000_000_000_000


def supermajority(n: int) -> int:
    """More than two thirds of ``n`` (reference ``superMajority``)."""
    return 2 * n // 3 + 1


def build_schedule(levels: np.ndarray) -> np.ndarray:
    """Slots grouped by level into an i32[T, B] table, -1 padded, stable
    within a level (the program's ``build_schedule_numpy``)."""
    k = len(levels)
    if k == 0:
        return np.full((1, 1), -1, np.int32)
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


def cap_schedule_width(sched: np.ndarray, max_width: int) -> np.ndarray:
    """Split wide schedule rows into several rows of <= max_width entries.

    Any partition of a topological level is still a valid schedule (its
    members are mutually non-ancestral, and splitting preserves order), so
    this only bounds the per-step working set of the fork pipeline's
    level scans."""
    t, w = sched.shape
    if w <= max_width:
        return sched
    parts = -(-w // max_width)
    out = np.full((t * parts, max_width), -1, np.int32)
    for r in range(t):
        row = sched[r][sched[r] >= 0]
        for p in range(-(-max(len(row), 1) // max_width)):
            chunk = row[p * max_width : (p + 1) * max_width]
            out[r * parts + p, : len(chunk)] = chunk
    keep = (out >= 0).any(axis=1)
    keep[0] = True
    return out[keep]


def random_byzantine_fork_arrays(
    n: int,
    n_events: int,
    byz_frac: float = 1 / 3,
    fork_rate: float = 0.05,
    seed: int = 0,
    ts_granularity_ns: int = 1_000,
    base_ts: int = _BASE_TS,
    sched_width: int = 32,
    r_cap: int = 0,
):
    """The program's ``random_byzantine_fork_arrays``: a gossip DAG in
    which (up to the BFT bound) a third of the creators equivocate
    once.  Returns the fork pipeline's sizes (``ForkConfig`` fields, as
    a dict) and the batch's numpy arrays (``ForkBatch`` field names)."""
    rng = np.random.default_rng(seed)
    k = 2
    b_total = n * k
    n_byz = min(int(byz_frac * n), n - supermajority(n))

    sp = np.full(n_events, -1, np.int32)
    op = np.full(n_events, -1, np.int32)
    ebr = np.zeros(n_events, np.int32)
    eseq = np.zeros(n_events, np.int32)
    ecr = np.zeros(n_events, np.int32)
    ts = np.zeros(n_events, np.int64)
    mbit = rng.integers(0, 2, n_events).astype(bool)
    levels = np.zeros(n_events, np.int32)

    heads = np.full(n, -1, np.int32)          # current head slot per node
    cur_col = np.arange(n, dtype=np.int32) * k
    cur_idx = np.full(n, -1, np.int32)
    forked = np.zeros(n, bool)
    fork_div = np.full(n, -1, np.int32)       # divergence index per creator
    own_slots: list = [[] for _ in range(n)]  # all own slots in order

    e = 0
    for i in range(min(n, n_events)):
        ebr[e] = i * k
        ecr[e] = i
        ts[e] = base_ts
        heads[i] = e
        cur_idx[i] = 0
        own_slots[i].append(e)
        e += 1

    t = 0
    while e < n_events:
        t += 1
        r = int(rng.integers(0, n))
        s = int(rng.integers(0, n - 1))
        if s >= r:
            s += 1
        raw = t * 1_987_963
        tstamp = base_ts + (raw // ts_granularity_ns) * ts_granularity_ns

        sp_slot = heads[r]
        idx = cur_idx[r] + 1
        col = cur_col[r]
        if (r < n_byz and not forked[r] and cur_idx[r] >= 1
                and rng.random() < fork_rate):
            # equivocate once: branch off a random earlier own event
            j = int(rng.integers(0, len(own_slots[r]) - 1))
            sp_slot = own_slots[r][j]
            idx = eseq[sp_slot] + 1
            col = r * k + 1
            forked[r] = True
            fork_div[r] = idx
            cur_col[r] = col
        sp[e] = sp_slot
        op[e] = heads[s]
        ebr[e] = col
        eseq[e] = idx
        ecr[e] = r
        ts[e] = tstamp
        levels[e] = 1 + max(levels[sp_slot], levels[heads[s]])
        heads[r] = e
        cur_idx[r] = idx
        own_slots[r].append(e)
        e += 1

    max_chain = int(eseq.max()) + 1
    # fame tensors are [R, B, B]: keep r_cap tight (callers size it to
    # the expected round count and check the headroom after the run)
    cfg = dict(
        n=n, k=k,
        e_cap=1 << (n_events - 1).bit_length(),
        s_cap=1 << max(3, (max_chain + 1 - 1).bit_length()),
        r_cap=r_cap or 1 << max(
            3, (int(levels.max()) // 3 + 4 - 1).bit_length()
        ),
    )
    e1, s1 = cfg["e_cap"] + 1, cfg["s_cap"] + 1

    ce = np.full((b_total, s1), -1, np.int32)
    owner = np.zeros((b_total, s1), bool)
    cnt = np.zeros(b_total, np.int32)
    cp = np.zeros((b_total, b_total), np.int32)
    np.fill_diagonal(cp, INT32_MAX)
    for i in range(n):
        main, alt = i * k, i * k + 1
        main_slots = [s_ for s_ in own_slots[i] if ebr[s_] == main]
        ce[main, : len(main_slots)] = main_slots
        owner[main, : len(main_slots)] = True
        cnt[main] = len(main_slots)
        if forked[i]:
            d = int(fork_div[i])
            alt_slots = [s_ for s_ in own_slots[i] if ebr[s_] == alt]
            chain = main_slots[:d] + alt_slots
            ce[alt, : len(chain)] = chain
            owner[alt, d : len(chain)] = True
            cnt[alt] = len(chain)
            cp[main, alt] = cp[alt, main] = d

    sched = cap_schedule_width(build_schedule(levels), sched_width)

    def pad1(a, fill):
        out = np.full(e1, fill, a.dtype)
        out[:n_events] = a
        return out

    arrays = dict(
        sp=pad1(sp, -1), op=pad1(op, -1), ebr=pad1(ebr, b_total),
        eseq=pad1(eseq, -1), ecr=pad1(ecr, n), ts=pad1(ts, 0),
        mbit=pad1(mbit, False), sched=sched, cp=cp, ce=ce, cnt=cnt,
        owner=owner, n_events=np.int32(n_events),
        rseed=np.full(e1, -1, np.int32), wseed=np.full(e1, -1, np.int8),
        s_off=np.zeros(b_total, np.int32),
    )
    return cfg, arrays
