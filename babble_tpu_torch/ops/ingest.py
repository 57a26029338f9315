"""Event ingestion: coordinate fill, first-descendant fill, round
assignment — the batch modes ``"walk"`` and ``"fast"`` of the JAX
package's ``ops/ingest.py``, in torch.

- ``"walk"``: la by the one-pass walk (``pallas_ingest.la_walk``, a CUDA
  kernel on the card), fd by the cheaper of the chain-view compare-count
  and the reverse level scan, rounds by the witness-frontier march.
- ``"fast"``: the same, with la by the level scan (one vectorised step
  per topological level).

Both give identical tensors.  The modes ``"incremental"``, ``"full"``
and ``"absorb"`` are not ported yet (ROADMAP.md Queue 1, item 1).

Loops whose trip count JAX keeps on the device (``lax.while_loop`` with
a traced bound) are Python loops here, with one ``.item()`` per trip to
read the bound: see ``_rounds_frontier``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .pallas_ingest import la_walk, walk_supported
from .ss import ss_counts_compare
from .state import (
    INT32_MAX, DagConfig, DagState, I32, fd_reverse_scan_wins,
    repack_round_bits, sanitize, set_sentinel,
)

PORTED_FD_MODES = ("walk", "fast")


class EventBatch(NamedTuple):
    """Host-built tensors for K new events (padded to a bucketed size).
    Parent references are device slots; events are topologically ordered."""

    sp: torch.Tensor       # i32[K] self-parent slot, -1
    op: torch.Tensor       # i32[K] other-parent slot, -1
    creator: torch.Tensor  # i32[K]
    seq: torch.Tensor      # i32[K]
    ts: torch.Tensor       # i64[K]
    mbit: torch.Tensor     # bool[K]
    k: torch.Tensor        # i32 scalar: real count (<= K)
    sched: torch.Tensor    # i32[T, B] batch positions grouped by level, -1 pad


def _iota(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


def _reset_coord_sentinels(state: DagState, cfg: DagConfig) -> DagState:
    """Restore the sentinel row/col of everything the coords phase
    writes (batch fields, la/fd, chain tables): padding lanes dump their
    writes there, and gathers of missing refs must stay neutral."""
    e, n, s = cfg.e_cap, cfg.n, cfg.s_cap
    e_row = _iota(e + 1, state.sp) == e        # [E+1]
    n_row = _iota(n + 1, state.sp) == n        # [N+1]
    s_col = _iota(s + 1, state.sp) == s        # [S+1]
    setv = set_sentinel
    return state._replace(
        sp=setv(state.sp, e_row, -1),
        op=setv(state.op, e_row, -1),
        creator=setv(state.creator, e_row, n),
        seq=setv(state.seq, e_row, -1),
        ts=setv(state.ts, e_row, 0),
        mbit=setv(state.mbit, e_row, False),
        ce=setv(state.ce, n_row[:, None] | s_col[None, :], -1),
        cnt=setv(state.cnt, n_row, 0),
        la=setv(state.la, e_row[:, None], -1),
        fd=setv(state.fd, e_row[:, None], cfg.fd_inf),
    )


def _reset_round_sentinels(state: DagState, cfg: DagConfig) -> DagState:
    """Restore the sentinel rows the rounds phase writes."""
    e, r = cfg.e_cap, cfg.r_cap
    e_row = _iota(e + 1, state.sp) == e        # [E+1]
    r_row = _iota(r + 1, state.sp) == r        # [R+1]
    setv = set_sentinel
    return state._replace(
        round=setv(state.round, e_row, -1),
        witness=setv(state.witness, e_row, False),
        rr=setv(state.rr, e_row, -1),
        cts=setv(state.cts, e_row, 0),
        wslot=setv(state.wslot, r_row[:, None], -1),
    )


def _write_batch_fields(state: DagState, cfg: DagConfig,
                        b: EventBatch) -> DagState:
    """Scatter the batch into its slots.  Padding lanes all write the
    same padding values into dump row ``e_cap`` (and ce's ``(n, s_cap)``
    cell), which ``_reset_coord_sentinels`` restores."""
    kpad = b.sp.shape[0]
    pos = torch.arange(kpad, dtype=I32, device=b.sp.device)
    real = pos < b.k
    slots = torch.where(real, state.n_events + pos, cfg.e_cap).long()
    c_dump = torch.where(real, b.creator, cfg.n).long()
    # ce columns are seq-window-local: col = seq - s_off[c]
    s_loc = b.seq - state.s_off[torch.clamp(b.creator, 0, cfg.n).long()]
    s_dump = torch.where(real, s_loc, cfg.s_cap).long()

    def put(a, v):
        a = a.clone()
        a[slots] = v
        return a

    ce = state.ce.clone()
    ce[c_dump, s_dump] = slots.to(I32)
    # cnt.at[c].add: duplicate indices (every padding lane hits row n)
    # must accumulate, so index_put_ with accumulate=True
    cnt = state.cnt.clone()
    cnt.index_put_((c_dump,), real.to(I32), accumulate=True)
    return state._replace(
        sp=put(state.sp, b.sp),
        op=put(state.op, b.op),
        creator=put(state.creator, b.creator),
        seq=put(state.seq, b.seq),
        ts=put(state.ts, b.ts),
        mbit=put(state.mbit, b.mbit),
        ce=ce,
        cnt=cnt,
        n_events=state.n_events + b.k,
    )


def _slot_sched(state_n0: torch.Tensor, cfg: DagConfig,
                sched: torch.Tensor) -> torch.Tensor:
    """Schedule of batch positions -> schedule of device slots (pad ->
    sentinel)."""
    return torch.where(sched >= 0, state_n0 + sched, cfg.e_cap)


def la_step_math(cfg: DagConfig, sp, op, creator, seq, la, idx):
    """One topological level of last-ancestor fill, in place on ``la``:
    la[x] = max(la[sp(x)], la[op(x)]) with own slot := own seq.  ``idx``
    are device slots (sentinel e_cap for padding lanes, which all write
    the same row there)."""
    idx = idx.long()
    spx = sanitize(sp[idx], cfg.e_cap).long()
    opx = sanitize(op[idx], cfg.e_cap).long()
    rows = torch.maximum(la[spx], la[opx])                   # [B, N]
    own_col = torch.clamp(creator[idx], 0, cfg.n - 1).long()
    rows[torch.arange(idx.shape[0], device=la.device), own_col] = \
        seq[idx].to(rows.dtype)
    la[idx] = rows
    return la


def fd_step_math(cfg: DagConfig, sp, op, fd, idx):
    """One reversed topological level of first-descendant fill, in place
    on ``fd``: scatter-min each event's final fd row into its parents'
    rows (duplicate parents reduce by min, whatever their order)."""
    idx = idx.long()
    rows = fd[idx]                                           # [B, N]
    spx = sanitize(sp[idx], cfg.e_cap).long()
    opx = sanitize(op[idx], cfg.e_cap).long()
    n = fd.shape[1]
    fd.scatter_reduce_(0, spx[:, None].expand(-1, n), rows, "amin")
    fd.scatter_reduce_(0, opx[:, None].expand(-1, n), rows, "amin")
    return fd


def _la_level_scan(state: DagState, cfg: DagConfig,
                   slot_sched: torch.Tensor) -> DagState:
    """Fill last-ancestor rows one topological level at a time."""
    la = state.la.clone()
    for idx in slot_sched:
        la_step_math(cfg, state.sp, state.op, state.creator, state.seq,
                     la, idx)
    return state._replace(la=la)


def _fd_init_own(state: DagState, cfg: DagConfig, b: EventBatch) -> DagState:
    kpad = b.sp.shape[0]
    pos = torch.arange(kpad, dtype=I32, device=b.sp.device)
    real = pos < b.k
    # slots of the just-written batch: n_events already advanced by k
    slots = torch.where(real, state.n_events - b.k + pos, cfg.e_cap).long()
    own_col = torch.clamp(b.creator, 0, cfg.n - 1).long()
    fd = state.fd.clone()
    fd[slots, own_col] = b.seq.to(fd.dtype)
    return state._replace(fd=fd)


def _fd_reverse_scan(state: DagState, cfg: DagConfig,
                     slot_sched: torch.Tensor) -> DagState:
    """First-descendant fill by reverse level scan: walking levels
    deepest-first, every event's fd row is already final, so one
    scatter-min into its parents' rows closes the recurrence."""
    fd = state.fd.clone()
    for idx in slot_sched.flip(0):
        fd_step_math(cfg, state.sp, state.op, fd, idx)
    # pad lanes dumped mins into the sentinel row; restore it
    e_row = (_iota(cfg.e_cap + 1, fd) == cfg.e_cap)[:, None]
    return state._replace(fd=set_sentinel(fd, e_row, cfg.fd_inf))


def _fd_full(state: DagState, cfg: DagConfig) -> DagState:
    """Full first-descendant recompute via the chain-view compare-count.

    fd[y, j] = smallest s with la[ce[j, s], creator[y]] >= seq[y].  The
    lookup V[j, s, c] = la[ce[j, s], c] is monotone non-decreasing in s,
    so the search is the count |{s : V[j, s, c] < t}|, computed in chunks
    of t so the [N, S+1, N, Tc] compare stays near 256 MB."""
    n, s_cap = cfg.n, cfg.s_cap
    s_off = state.s_off[:n]                                      # [N]
    cnt_w = state.cnt[:n] - s_off                                # windowed lengths
    cej = state.ce[:n]                                           # [N, S+1]
    s_idx = _iota(s_cap + 1, cej)

    # V[j, s, c] = la[chain_j[s], c], +INF past the chain tail
    V = state.la[sanitize(cej, cfg.e_cap).long()].to(I32)        # [N, S+1, N]
    V = torch.where(
        (s_idx[None, :] < cnt_w[:, None])[:, :, None], V, INT32_MAX
    )

    t_total = s_cap + 1
    chunk = max(1, min(t_total, 2 ** 28 // max(1, n * n * (s_cap + 1))))
    counts = []
    for t0 in range(0, t_total, chunk):
        t_idx = t0 + _iota(chunk, cej)                           # [Tc]
        thr = t_idx[None, None, None, :] + s_off[None, None, :, None]
        lt = V[:, :, :, None] < thr                              # [N,S+1,N,Tc]
        counts.append(lt.sum(dim=1, dtype=I32))                  # [N, N, Tc]
    out = torch.cat(counts, dim=2)[:, :, :t_total]
    found = out < cnt_w[:, None, None]
    # fd values are absolute seqs: window-local count + chain j's offset
    out = torch.where(found, out + s_off[:, None, None], cfg.fd_inf)

    # scatter back to event rows: fd[ce[c, t], j] = out[j, c, t]; rows
    # past a chain's tail all dump into the sentinel row, reset below
    out_ctj = out.permute(1, 2, 0).to(cfg.coord_dtype)          # [N(c), T, N(j)]
    tgt = torch.where(s_idx[None, :] < cnt_w[:, None], cej, cfg.e_cap)
    fd_new = state.fd.clone()
    fd_new[tgt.long()] = out_ctj
    e_row = (_iota(cfg.e_cap + 1, fd_new) == cfg.e_cap)[:, None]
    return state._replace(fd=set_sentinel(fd_new, e_row, cfg.fd_inf))


def frontier_init(state: DagState, cfg: DagConfig):
    """Initial carry of the witness-frontier march."""
    n, r_cap = cfg.n, cfg.r_cap
    cnt = state.cnt[:n] - state.s_off[:n]
    pos0 = torch.where(cnt > 0, 0, INT32_MAX).to(I32)
    pos_table0 = torch.full((r_cap + 1, n), INT32_MAX, dtype=I32,
                            device=cnt.device)
    pos_table0[0] = pos0
    return pos0, pos_table0


def frontier_step_math(state: DagState, cfg: DagConfig, r: int,
                       pos: torch.Tensor, pos_table: torch.Tensor):
    """One frontier-march round step: advance pos[j] — the seq of the
    first chain-j event with round >= r — to round r+1.  Writes row
    min(r+1, r_cap) of ``pos_table`` in place.

    Returns (pos_next, pos_table, any_next)."""
    n, sm, s_cap, r_cap = cfg.n, cfg.super_majority, cfg.s_cap, cfg.r_cap
    e_cap = cfg.e_cap
    s_off = state.s_off[:n]
    cnt = state.cnt[:n] - s_off                            # windowed lengths
    cej = state.ce[:n]                                     # [N, S+1]
    rows = _iota(n, cej)
    bisect_iters = max(1, (s_cap + 1).bit_length())

    def chain(col):
        return cej[rows, torch.clamp(col, 0, s_cap).long()]

    valid_w = pos < cnt
    ws = chain(pos)
    fdw = state.fd[sanitize(torch.where(valid_w, ws, -1), e_cap).long()]

    # bisection for the first self-inc position per chain
    lo = torch.where(valid_w, pos, cnt)
    hi = cnt
    for _ in range(bisect_iters):
        mid = (lo + hi) >> 1
        lax_rows = state.la[sanitize(chain(mid), e_cap).long()]   # [N, N]
        ss_cnt = ss_counts_compare(lax_rows, fdw)
        ss = (ss_cnt >= sm) & valid_w[None, :]
        ok = ss.sum(-1) >= sm
        active = lo < hi
        hi = torch.where(ok & active, mid, hi)
        lo = torch.where(~ok & active, mid + 1, lo)
    s_star = lo
    found = s_star < cnt

    # descent inheritance: fd rows of the per-chain first inc events
    e_star = chain(s_star)
    fde = state.fd[sanitize(torch.where(found, e_star, -1), e_cap).long()]
    inherit = fde.min(dim=0).values.to(I32)                # [N] absolute
    inherit = torch.where(inherit >= cfg.fd_inf, INT32_MAX, inherit - s_off)
    pos_next = torch.minimum(torch.where(found, s_star, INT32_MAX), inherit)
    pos_next = torch.maximum(pos_next, pos)  # monotone safety
    any_next = (pos_next < cnt).any()
    pos_table[min(r + 1, r_cap)] = pos_next
    return pos_next, pos_table, any_next


def frontier_finalize(state: DagState, cfg: DagConfig,
                      pos_table: torch.Tensor) -> DagState:
    """Derive per-event rounds, witness flags and the witness table from
    the finished frontier position table."""
    n, s_cap, r_cap = cfg.n, cfg.s_cap, cfg.r_cap
    cnt = state.cnt[:n] - state.s_off[:n]
    cej = state.ce[:n]
    rows = _iota(n, cej)

    # per-event rounds from the pos table: round(x) = |{r : pos[r, c] <= seq}| - 1
    e1 = cfg.e_cap + 1
    c_x = torch.clamp(state.creator, 0, n - 1).long()
    wseq = state.seq - state.s_off[c_x]                    # window-local seqs
    pos_c = pos_table[:, c_x]                              # [R+1, E+1]
    rnd = (pos_c <= wseq[None, :]).sum(0, dtype=I32) - 1 + state.r_off
    valid_e = (_iota(e1, cej) < state.n_events) & (state.seq >= 0)
    rnd = torch.where(valid_e, rnd, -1)

    # rolled windows keep a laggard's stored round (no-op on fresh states)
    stale = valid_e & (state.round >= 0) & (state.round < state.r_off)
    rnd = torch.where(stale, state.round, rnd)

    wit = valid_e & (
        pos_table[torch.clamp(rnd - state.r_off, 0, r_cap).long(), c_x] == wseq
    )
    wit = torch.where(stale, state.witness, wit)

    # exact witness table: chain j's round-r witness exists iff the
    # frontier strictly advances past it
    pos_nxt = torch.cat(
        [pos_table[1:], torch.full((1, n), INT32_MAX, dtype=I32,
                                   device=cej.device)], dim=0
    )
    w_valid = pos_table < torch.minimum(pos_nxt, cnt[None, :])
    w_slots = cej[rows[None, :], torch.clamp(pos_table, 0, s_cap).long()]
    wslot_new = torch.where(w_valid, w_slots, -1)[: r_cap + 1]

    max_round = torch.where(valid_e, rnd, -1).max()
    return state._replace(
        round=rnd, witness=wit, wslot=wslot_new, max_round=max_round
    )


def _rounds_frontier(state: DagState, cfg: DagConfig) -> DagState:
    """Round assignment as a per-round witness-frontier march — O(actual
    rounds) sequential steps instead of O(levels).

    pos[r, j] := seq of the first chain-j event with round >= r.  Step r
    advances the frontier: an event has round >= r+1 iff it strongly
    sees a supermajority of round-r witnesses or descends from such an
    event (hashgraph.go:263-305).  Exact on fresh states (all window
    offsets zero), which is the only way the batch modes reach it.

    JAX runs the march as a ``lax.while_loop`` whose condition is a
    device value; here it is a Python loop that reads that condition
    with one ``.item()`` per round."""
    pos, pos_table = frontier_init(state, cfg)
    r, alive = 0, True
    while alive and r < cfg.r_cap - 1:
        pos, pos_table, any_next = frontier_step_math(
            state, cfg, r, pos, pos_table
        )
        r += 1
        alive = bool(any_next.item())
    return frontier_finalize(state, cfg, pos_table)


def _check_fd_mode(fd_mode: str) -> None:
    if fd_mode not in PORTED_FD_MODES:
        raise NotImplementedError(
            f"fd_mode {fd_mode!r} is not ported yet (ROADMAP.md Queue 1, "
            f"item 1 'Live path'); the port runs {PORTED_FD_MODES}"
        )


def ingest_coords_impl(cfg: DagConfig, state: DagState, fd_mode: str,
                       batch: EventBatch) -> DagState:
    """Phase 1 of ingest: write batch fields and fill the la/fd
    coordinate tensors (everything before round assignment)."""
    _check_fd_mode(fd_mode)
    state = _write_batch_fields(state, cfg, batch)
    slot_sched = _slot_sched(state.n_events - batch.k, cfg, batch.sched)
    if fd_mode == "walk":
        if not walk_supported(cfg.n, cfg.e_cap, cfg.s_cap):
            raise ValueError(f"walk mode does not support {cfg}")
        la = la_walk(state.sp, state.op, state.creator, state.seq,
                     state.n_events, cfg.e_cap, cfg.n)
        state = state._replace(la=la.to(cfg.coord_dtype))
    else:
        state = _la_level_scan(state, cfg, slot_sched)
    state = _fd_init_own(state, cfg, batch)
    # the schedule covers the whole DAG, so the cheaper of reverse scan
    # and compare-count applies (both are bit-identical)
    if fd_reverse_scan_wins(batch.sched.shape[0], cfg.e_cap):
        state = _fd_reverse_scan(state, cfg, slot_sched)
    else:
        state = _fd_full(state, cfg)
    return _reset_coord_sentinels(state, cfg)


def ingest_rounds_impl(cfg: DagConfig, state: DagState, fd_mode: str,
                       batch: EventBatch) -> DagState:
    """Phase 2 of ingest: round/witness assignment + sentinel reset."""
    _check_fd_mode(fd_mode)
    state = _rounds_frontier(state, cfg)
    # the rounds phase rewrote the witness tables: refresh the packed
    # per-round bitplanes
    return repack_round_bits(cfg, _reset_round_sentinels(state, cfg))


def ingest_impl(cfg: DagConfig, state: DagState, fd_mode: str,
                batch: EventBatch) -> DagState:
    """Ingest a topologically-ordered batch of events end to end.

    fd_mode:
    - 'walk' — la by the one-pass walk kernel; gated by walk_supported().
    - 'fast' — la by the level scan; otherwise the same as 'walk'.
    """
    state = ingest_coords_impl(cfg, state, fd_mode, batch)
    return ingest_rounds_impl(cfg, state, fd_mode, batch)
