"""Event ingestion: coordinate fill, first-descendant fill, round
assignment — every fd mode of the JAX package's ``ops/ingest.py``, in
torch.

- ``"incremental"`` (the live gossip path): la by the level scan, fd by
  a [K, E+1] ancestor mask and a column scatter-min, rounds by the
  level scan.
- ``"full"``: la by the level scan, fd by the chain-view compare-count,
  rounds by the level scan.
- ``"fast"``: la by the level scan, fd by the cheaper of the
  compare-count and the reverse level scan, rounds by the
  witness-frontier march.
- ``"walk"``: ``"fast"`` with la by the one-pass walk
  (``pallas_ingest.la_walk``, a CUDA kernel on the card).
- ``"absorb"``: ``"fast"`` with la by log-depth self-absorption and fd
  by the compare-count.

All five give identical tensors on a batch that holds the whole DAG;
``"incremental"`` and ``"full"`` also append a batch to a filled state.
As in the JAX package, an unknown mode takes the ``"full"`` branches.

Column shards (``parallel/sharded.py``): the la/fd fills of modes
``"incremental"``, ``"full"``, ``"fast"`` and ``"walk"`` take an
optional ``axis``, a
``parallel.collectives.ColumnShard``.  With one, la and fd hold only the
global columns ``[axis.lo, axis.hi)``: the fills are column-local (the
creator test is shifted by ``axis.lo``), every strongly-see
compare-count is a partial count over those columns summed over the
axis, and the chain-view fd fill gathers la's columns first (its count
runs over chain positions, and fd column j reads every creator's
column of chain j's events); the incremental fill OR-s its ancestor
flags over the axis.  Without one, nothing changes.

Loops whose trip count JAX keeps on the device (``lax.while_loop`` with
a traced bound) are Python loops here, with one ``.item()`` per trip to
read the bound: see ``_rounds_frontier`` and ``_la_absorb``.  Every
read to the host goes through ``obs/spans.py host_read``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..obs.spans import host_read
from .pack import count_bits
from .pallas_ingest import la_walk, walk_supported
from .ss import ss_counts_compare
from .state import (
    INT32_MAX, DagConfig, DagState, I32, fd_reverse_scan_wins,
    repack_round_bits, retired_mask, sanitize, set_sentinel,
)

PORTED_FD_MODES = ("incremental", "full", "fast", "walk", "absorb")


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


def _reset_coord_sentinels(state: DagState, cfg: DagConfig,
                           include_coords: bool = True) -> DagState:
    """Restore the sentinel row/col of everything the coords phase
    writes (batch fields, la/fd, chain tables): padding lanes dump their
    writes there, and gathers of missing refs must stay neutral.
    ``include_coords=False`` leaves la/fd alone (the wide engine holds
    them as column blocks, outside the state)."""
    e, n, s = cfg.e_cap, cfg.n, cfg.s_cap
    e_row = _iota(e + 1, state.sp) == e        # [E+1]
    n_row = _iota(n + 1, state.sp) == n        # [N+1]
    s_col = _iota(s + 1, state.sp) == s        # [S+1]
    setv = set_sentinel
    state = state._replace(
        sp=setv(state.sp, e_row, -1),
        op=setv(state.op, e_row, -1),
        creator=setv(state.creator, e_row, n),
        seq=setv(state.seq, e_row, -1),
        ts=setv(state.ts, e_row, 0),
        mbit=setv(state.mbit, e_row, False),
        ce=setv(state.ce, n_row[:, None] | s_col[None, :], -1),
        cnt=setv(state.cnt, n_row, 0),
    )
    if include_coords:
        state = state._replace(
            la=setv(state.la, e_row[:, None], -1),
            fd=setv(state.fd, e_row[:, None], cfg.fd_inf),
        )
    return state


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


def _own_cols(creator: torch.Tensor, cfg: DagConfig, axis):
    """(column of ``la``/``fd`` each event's own seq goes to, whether it
    is held here): the clamped creator, shifted by the shard's origin."""
    own = torch.clamp(creator, 0, cfg.n - 1).long()
    if axis is None:
        return own, None
    own = own - axis.lo
    held = (own >= 0) & (own < axis.width)
    return torch.clamp(own, 0, axis.width - 1), held


def _put_own(t: torch.Tensor, rows, cols, vals, held) -> None:
    """``t[rows, cols] = vals`` where ``held`` (all when None); a cell not
    held gets its own value back (real rows are distinct; padding lanes
    share the sentinel row, which the caller resets)."""
    vals = vals.to(t.dtype)
    if held is not None:
        vals = torch.where(held, vals, t[rows, cols])
    t[rows, cols] = vals


def la_step_math(cfg: DagConfig, sp, op, creator, seq, la, idx, axis=None):
    """One topological level of last-ancestor fill, in place on ``la``:
    la[x] = max(la[sp(x)], la[op(x)]) with own slot := own seq.  ``idx``
    are device slots (sentinel e_cap for padding lanes, which all write
    the same row there).  With ``axis``, ``la`` holds its columns."""
    idx = idx.long()
    spx = sanitize(sp[idx], cfg.e_cap).long()
    opx = sanitize(op[idx], cfg.e_cap).long()
    rows = torch.maximum(la[spx], la[opx])                   # [B, N]
    own_col, held = _own_cols(creator[idx], cfg, axis)
    _put_own(rows, torch.arange(idx.shape[0], device=la.device), own_col,
             seq[idx], held)
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
                   slot_sched: torch.Tensor, axis=None) -> DagState:
    """Fill last-ancestor rows one topological level at a time."""
    la = state.la.clone()
    for idx in slot_sched:
        la_step_math(cfg, state.sp, state.op, state.creator, state.seq,
                     la, idx, axis)
    return state._replace(la=la)


def _batch_slots(state: DagState, cfg: DagConfig, b: EventBatch):
    """(real, slots) of the just-written batch: n_events has already
    advanced by k; padding lanes point at the sentinel row e_cap."""
    pos = torch.arange(b.sp.shape[0], dtype=I32, device=b.sp.device)
    real = pos < b.k
    return real, torch.where(real, state.n_events - b.k + pos,
                             cfg.e_cap).long()


def _fd_init_own(state: DagState, cfg: DagConfig, b: EventBatch,
                 axis=None) -> DagState:
    _, slots = _batch_slots(state, cfg, b)
    own_col, held = _own_cols(b.creator, cfg, axis)
    fd = state.fd.clone()
    _put_own(fd, slots, own_col, b.seq, held)
    return state._replace(fd=fd)


def _fd_incremental(state: DagState, cfg: DagConfig, b: EventBatch,
                    axis=None) -> DagState:
    """For each new event e (creator c, seq q): every ancestor y gains a
    first descendant by c at q unless it already has an earlier one,
    fd[y, c] = min(fd[y, c], q) over ancestors — an O(K·E) masked
    min-scatter.  Several events of one creator share a column and every
    padding lane writes column n, so the scatter reduces by min
    (``scatter_reduce_``), never by last write.  With ``axis`` each rank
    tests the ancestors whose creator column it holds, the flags are
    OR-ed over the axis, and it scatters into its own columns."""
    real, slots = _batch_slots(state, cfg, b)
    e1, n, cd = cfg.e_cap + 1, cfg.n, cfg.coord_dtype

    la_b = state.la[slots]                                        # [K, N]
    cy, held = _own_cols(state.creator, cfg, axis)                # [E+1]
    valid_y = (_iota(e1, cy) < state.n_events) & (state.seq >= 0)
    # anc[b, y]: y is an ancestor of batch event b
    anc = la_b[:, cy] >= state.seq[None, :]                       # [K, E+1]
    if axis is not None:
        anc = axis.max(anc & held[None, :])
    anc = anc & valid_y[None, :] & real[:, None]

    vals = torch.where(anc, b.seq[:, None].to(cd), cfg.fd_inf).to(cd)
    own, own_held = _own_cols(b.creator, cfg, axis)
    w = n if axis is None else axis.width
    keep = real if own_held is None else real & own_held
    c_dump = torch.where(keep, own if axis is not None else b.creator, w)
    upd = torch.full((e1, w + 1), cfg.fd_inf, dtype=cd, device=cy.device)
    upd.scatter_reduce_(1, c_dump.long()[None, :].expand(e1, -1), vals.T,
                        "amin")
    return state._replace(fd=torch.minimum(state.fd, upd[:, :w]))


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


def _fd_full(state: DagState, cfg: DagConfig, axis=None) -> DagState:
    """Full first-descendant recompute via the chain-view compare-count.

    fd[y, j] = smallest s with la[ce[j, s], creator[y]] >= seq[y].  The
    lookup V[j, s, c] = la[ce[j, s], c] is monotone non-decreasing in s,
    so the search is the count |{s : V[j, s, c] < t}|, computed in chunks
    of t so the [N, S+1, N, Tc] compare stays near 256 MB.  With
    ``axis`` this rank computes its own fd columns j, from la's columns
    gathered over the axis."""
    n, s_cap = cfg.n, cfg.s_cap
    s_off = state.s_off[:n]                                      # [N]
    cnt_w = state.cnt[:n] - s_off                                # windowed lengths
    cej = state.ce[:n]                                           # [N, S+1]
    s_idx = _iota(s_cap + 1, cej)
    la, jl = state.la, slice(0, n)
    if axis is not None:
        la, jl = axis.gather(la, 1), slice(axis.lo, axis.hi)
    nj = jl.stop - jl.start

    # V[j, s, c] = la[chain_j[s], c], +INF past the chain tail
    V = la[sanitize(cej[jl], cfg.e_cap).long()].to(I32)         # [Nj, S+1, N]
    V = torch.where(
        (s_idx[None, :] < cnt_w[jl, None])[:, :, None], V, INT32_MAX
    )

    t_total = s_cap + 1
    chunk = max(1, min(t_total, 2 ** 28 // max(1, nj * n * (s_cap + 1))))
    counts = []
    for t0 in range(0, t_total, chunk):
        t_idx = t0 + _iota(chunk, cej)                           # [Tc]
        thr = t_idx[None, None, None, :] + s_off[None, None, :, None]
        lt = V[:, :, :, None] < thr                              # [N,S+1,N,Tc]
        counts.append(lt.sum(dim=1, dtype=I32))                  # [N, N, Tc]
    out = torch.cat(counts, dim=2)[:, :, :t_total]
    found = out < cnt_w[jl, None, None]
    # fd values are absolute seqs: window-local count + chain j's offset
    out = torch.where(found, out + s_off[jl, None, None], cfg.fd_inf)

    # scatter back to event rows: fd[ce[c, t], j] = out[j, c, t]; rows
    # past a chain's tail all dump into the sentinel row, reset below
    out_ctj = out.permute(1, 2, 0).to(cfg.coord_dtype)          # [N(c), T, N(j)]
    tgt = torch.where(s_idx[None, :] < cnt_w[:, None], cej, cfg.e_cap)
    fd_new = state.fd.clone()
    fd_new[tgt.long()] = out_ctj
    e_row = (_iota(cfg.e_cap + 1, fd_new) == cfg.e_cap)[:, None]
    return state._replace(fd=set_sentinel(fd_new, e_row, cfg.fd_inf))


def _rounds_level_scan(state: DagState, cfg: DagConfig,
                       slot_sched: torch.Tensor,
                       raw_sched: torch.Tensor, axis=None) -> DagState:
    """Assign round + witness per topological level (hashgraph.go:211-305):

        parent_round = max(round[sp], round[op])      (roots: 0)
        inc          = |{j : strongly_see(x, w_{parent_round, j})}| >= sm[pr]
        round        = parent_round + inc
        witness      = no self-parent, or round > round[sp]

    The increment threshold is read per parent round from ``state.sm``,
    and retired creators never enter a witness table (their writes go
    to the dump row ``r_cap``, as do non-witnesses and padding lanes).

    Writes land where JAX writes them: padding lanes on event row
    ``e_cap`` and on the dump row ``r_cap`` of ``wslot``, which a later
    level gathers only for a parent round outside the window (where
    lanes of one level write one dump cell, CUDA leaves open which write
    wins); the caller's sentinel reset restores both rows.  A witness
    row past ``r_cap`` (JAX drops that scatter) goes to one spare row
    that is cut off at the end."""
    n, e_cap, r_cap = cfg.n, cfg.e_cap, cfg.r_cap
    dev = state.sp.device
    # (a config with no retired column skips the mask and its host copy)
    retired = host_read(torch.from_numpy(retired_mask(cfg)).to, dev) \
        if cfg.retired else None
    sp, op, creator = state.sp, state.op, state.creator

    rnd = state.round.clone()
    wit = state.witness.clone()
    # one spare row past the dump row takes the writes JAX drops
    wslot = torch.cat([state.wslot, torch.full((1, n), -1, dtype=I32,
                                               device=dev)])
    max_round = state.max_round
    for idx, raw in zip(slot_sched, raw_sched):
        idx = idx.long()
        real = raw >= 0
        sp_i, op_i = sp[idx], op[idx]
        spx = sanitize(sp_i, e_cap).long()
        opx = sanitize(op_i, e_cap).long()
        is_root = (sp_i < 0) & (op_i < 0)
        pr = torch.where(is_root, 0, torch.maximum(rnd[spx], rnd[opx]))

        # parent rounds below the rolled window gather the dump row
        pr_loc = torch.where(pr >= state.r_off, pr - state.r_off, r_cap)
        pr_row = torch.clamp(pr_loc, 0, r_cap).long()
        wsl = wslot[pr_row]                                       # [B, N]
        fdw = state.fd[sanitize(wsl, e_cap).long()]               # [B, N, N]
        ss_see = state.la[idx][:, None, :] >= fdw                 # [B, N, N]
        ss_cnt = count_bits(ss_see) if cfg.packed else ss_see.sum(-1)
        if axis is not None:
            ss_cnt = axis.count("rounds_level", ss_cnt, fdw.shape[-1])
        sm_x = state.sm[pr_row]                                   # [B]
        ss = (ss_cnt >= sm_x[:, None]) & (wsl >= 0)
        inc = ss.sum(-1) >= sm_x
        r_x = pr + inc.to(I32)
        w_x = (sp_i < 0) | (r_x > rnd[spx])

        rnd[idx] = torch.where(real, r_x, -1)
        wit[idx] = w_x & real
        c_i = torch.clamp(creator[idx], 0, n).long()
        registers = w_x & real & (r_x >= state.r_off)
        if retired is not None:
            registers = registers & ~retired[c_i]
        w_row = torch.where(registers, r_x - state.r_off, r_cap)
        w_row = torch.clamp(w_row, max=r_cap + 1).long()
        wslot[w_row, torch.clamp(c_i, max=n - 1)] = idx.to(I32)
        max_round = torch.maximum(
            max_round, torch.where(real, r_x, -1).max())
    return state._replace(round=rnd, witness=wit, wslot=wslot[: r_cap + 1],
                          max_round=max_round)


def _la_init_direct(state: DagState, cfg: DagConfig,
                    b: EventBatch) -> DagState:
    """Seed the new events' last-ancestor rows with their direct parent
    positions only (own seq at own creator, each parent's seq at its
    creator); ``_la_absorb`` closes the transitive reachability.
    Missing parents contribute nothing: they are masked on ``sp``/``op``
    validity, since the sentinel row still holds the padding lanes'
    dumped creator and seq at this point."""
    real, slots = _batch_slots(state, cfg, b)
    kpad, n, cd = b.sp.shape[0], cfg.n, cfg.coord_dtype
    dev = b.sp.device

    def put_max(rows, col, val):
        # rows.at[arange, col].max(val): one cell per row
        return rows.scatter_reduce_(1, col.long()[:, None],
                                    val.to(cd)[:, None], "amax")

    rows = torch.full((kpad, n), -1, dtype=cd, device=dev)
    put_max(rows, torch.clamp(b.creator, 0, n - 1), b.seq)
    for par in (b.sp, b.op):
        px = sanitize(par, cfg.e_cap).long()
        put_max(rows, torch.clamp(state.creator[px], 0, n - 1),
                torch.where(par >= 0, state.seq[px], -1))
    # padding lanes all write the sentinel row; their rows stay -1
    rows = torch.where(real[:, None], rows, -1).to(cd)
    la = state.la.clone()
    la[slots] = rows
    return state._replace(la=la)


def _la_absorb(state: DagState, cfg: DagConfig) -> DagState:
    """Close last-ancestor rows by frontier self-absorption:

        la[x, j] <- max(la[x, j], max_k la[ce[k, la[x, k]], j])

    Each pass composes reachability with itself, so it converges in
    O(log depth) passes.  JAX runs the passes as a ``lax.while_loop``
    on a device flag; here a Python loop reads the flag with one
    ``.item()`` per pass."""
    n, s_cap, e_cap = cfg.n, cfg.s_cap, cfg.e_cap
    cols = _iota(n, state.ce)
    spx = sanitize(state.sp, e_cap).long()
    opx = sanitize(state.op, e_cap).long()
    s_off = state.s_off[:n]

    def absorb(la):
        # ce columns are window-local; a JAX gather clamps a column past
        # s_cap, so the port clamps it explicitly
        wi = la - s_off[None, :]
        col = torch.where((la >= 0) & (wi >= 0), wi, s_cap)
        fr = state.ce[cols[None, :], torch.clamp(col, max=s_cap).long()]
        absorbed = la[sanitize(fr, e_cap).long()]                 # [E+1, N, N]
        out = torch.maximum(la, absorbed.max(dim=1).values)
        return torch.maximum(out, torch.maximum(la[spx], la[opx]))

    la, changed = state.la, True
    while changed:
        la2 = absorb(la)
        changed = bool(host_read((la2 != la).any().item))
        la = la2
    return state._replace(la=la)


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
                       pos: torch.Tensor, pos_table: torch.Tensor,
                       axis=None):
    """One frontier-march round step: advance pos[j] — the seq of the
    first chain-j event with round >= r — to round r+1.  Writes row
    min(r+1, r_cap) of ``pos_table`` in place.  With ``axis`` each
    strongly-see count is a partial over la/fd's columns, summed.

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
        if axis is not None:
            ss_cnt = axis.count("frontier", ss_cnt, fdw.shape[-1])
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
    inherit = fde.min(dim=0).values                        # [N] absolute
    if axis is not None:
        inherit = axis.gather(inherit, 0)
    inherit = inherit.to(I32)
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


def _rounds_frontier(state: DagState, cfg: DagConfig,
                     axis=None) -> DagState:
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
            state, cfg, r, pos, pos_table, axis
        )
        r += 1
        alive = bool(host_read(any_next.item))
    return frontier_finalize(state, cfg, pos_table)


#: fd modes that run on column shards (``parallel/sharded.py``); the
#: log-depth absorption reads every column of a row, so "absorb" does not
SHARDED_FD_MODES = ("incremental", "full", "fast", "walk")


def ingest_coords_impl(cfg: DagConfig, state: DagState, fd_mode: str,
                       batch: EventBatch, axis=None) -> DagState:
    """Phase 1 of ingest: write batch fields and fill the la/fd
    coordinate tensors (everything before round assignment).  With
    ``axis`` (modes ``SHARDED_FD_MODES``), la/fd hold its columns."""
    if axis is not None and fd_mode not in SHARDED_FD_MODES:
        raise ValueError(f"fd mode {fd_mode!r} does not run on column "
                         f"shards; use one of {SHARDED_FD_MODES}")
    state = _write_batch_fields(state, cfg, batch)
    slot_sched = _slot_sched(state.n_events - batch.k, cfg, batch.sched)

    def fd_batch(state):
        # the schedule covers the whole DAG, so the cheaper of reverse
        # scan and compare-count applies (both are bit-identical)
        if fd_reverse_scan_wins(batch.sched.shape[0], cfg.e_cap):
            return _fd_reverse_scan(state, cfg, slot_sched)
        return _fd_full(state, cfg, axis)

    if fd_mode == "walk":
        if not walk_supported(cfg.n, cfg.e_cap, cfg.s_cap):
            raise ValueError(f"walk mode does not support {cfg}")
        c0, w = (0, cfg.n) if axis is None else (axis.lo, axis.width)
        la = la_walk(state.sp, state.op, state.creator, state.seq,
                     state.n_events, cfg.e_cap, cfg.n, c0, w)
        state = _fd_init_own(state._replace(la=la.to(cfg.coord_dtype)),
                             cfg, batch, axis)
        return _reset_coord_sentinels(fd_batch(state), cfg)
    if fd_mode == "absorb":
        state = _la_absorb(_la_init_direct(state, cfg, batch), cfg)
        state = _fd_init_own(state, cfg, batch)
        return _reset_coord_sentinels(_fd_full(state, cfg), cfg)
    state = _la_level_scan(state, cfg, slot_sched, axis)
    state = _fd_init_own(state, cfg, batch, axis)
    if fd_mode == "incremental":
        state = _fd_incremental(state, cfg, batch, axis)
    elif fd_mode == "fast":
        state = fd_batch(state)
    else:
        state = _fd_full(state, cfg, axis)
    return _reset_coord_sentinels(state, cfg)


def ingest_rounds_impl(cfg: DagConfig, state: DagState, fd_mode: str,
                       batch: EventBatch, axis=None) -> DagState:
    """Phase 2 of ingest: round/witness assignment + sentinel reset."""
    if fd_mode in ("walk", "absorb", "fast"):
        state = _rounds_frontier(state, cfg, axis)
    else:
        slot_sched = _slot_sched(state.n_events - batch.k, cfg, batch.sched)
        state = _rounds_level_scan(state, cfg, slot_sched, batch.sched,
                                   axis)
    # the rounds phase rewrote the witness tables: refresh the packed
    # per-round bitplanes
    return repack_round_bits(cfg, _reset_round_sentinels(state, cfg))


def ingest_impl(cfg: DagConfig, state: DagState, fd_mode: str,
                batch: EventBatch, axis=None) -> DagState:
    """Ingest a topologically-ordered batch of events end to end.

    fd_mode (``PORTED_FD_MODES``; identical outputs where they overlap):
    - 'incremental' — O(K·E) fd min-scatter + level-scan rounds (the
      live gossip path: small batches, shallow schedules).
    - 'full'        — chain-view fd compare-count + level-scan rounds.
    - 'fast'        — the cheaper batch fd + frontier-march rounds.
    - 'walk'        — 'fast' with la by the one-pass walk kernel; gated
      by walk_supported().
    - 'absorb'      — 'fast' with la by log-depth self-absorption.

    ``axis`` (a ``ColumnShard``): la/fd hold its columns (module
    docstring).
    """
    state = ingest_coords_impl(cfg, state, fd_mode, batch, axis)
    return ingest_rounds_impl(cfg, state, fd_mode, batch, axis)


def rescan_rounds_impl(cfg: DagConfig, state: DagState,
                       sched: torch.Tensor) -> DagState:
    """Re-run round assignment for a level-grouped schedule of suspect
    slots (the engine's round repair after growing r_cap): reset the
    suspects' round/witness, then replay the level scan against the
    intact lower witness rows, and restore the sentinels its padding
    lanes dumped into."""
    e1 = cfg.e_cap + 1
    raw = sched
    slots = torch.where(raw >= 0, raw, cfg.e_cap)
    # mask.at[slots].max(raw >= 0): duplicate slots reduce by max
    mask = torch.zeros(e1, dtype=I32, device=raw.device)
    mask.scatter_reduce_(0, slots.reshape(-1).long(),
                         (raw.reshape(-1) >= 0).to(I32), "amax")
    e_row = _iota(e1, raw) == cfg.e_cap
    mask = (mask > 0) & ~e_row
    rnd = torch.where(mask, -1, state.round)
    live = (_iota(e1, raw) < state.n_events) & (state.seq >= 0)
    state = state._replace(
        round=rnd,
        witness=state.witness & ~mask,
        max_round=torch.where(live, rnd, -1).max(),
    )
    state = _rounds_level_scan(state, cfg, slots, raw)
    r_row = (_iota(cfg.r_cap + 1, raw) == cfg.r_cap)[:, None]
    state = state._replace(
        round=set_sentinel(state.round, e_row, -1),
        witness=set_sentinel(state.witness, e_row, False),
        wslot=set_sentinel(state.wslot, r_row, -1),
    )
    return repack_round_bits(cfg, state)
