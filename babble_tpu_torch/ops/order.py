"""DecideRoundReceived + consensus timestamps, dense, in torch.

The port's twin of the JAX package's ``ops/order.py`` (reference
semantics hashgraph.go:676-721): an undetermined event x is received in
the first round i > round(x) whose witnesses are all decided and where
more than half of the famous witnesses see x; its consensus timestamp is
the median of the timestamps of each such witness's oldest self-ancestor
that sees x.

- see(w, x) is the first-descendant form fd[x, creator(w)] <= seq(w).
- The oldest self-ancestor of witness w (creator j) to see x is creator
  j's event at seq fd[x, j], so the median inputs are ts[ce[j, fd[x, j]]]
  masked to the famous witnesses that see x: one gather and a row sort.
  (The JAX package's S-step select-accumulate form of that gather is a
  TPU cost choice; the port takes the gather.)

Undecided rounds are skipped, not break points (the reference uses
``continue``, hashgraph.go:684-686).
"""

from __future__ import annotations

import torch

from .state import (
    FAME_TRUE, FAME_UNDEFINED, INT32_MAX, INT64_MAX, DagConfig, DagState,
    I32, I64, sanitize,
)

# e1*n element count above which the median chunks the event axis, and
# the chunk size (the JAX package's constants; module-level so tests can
# force the chunked branch at small shapes)
MEDIAN_CHUNK_THRESHOLD = 1 << 28
MEDIAN_CHUNK_ELEMS = 1 << 26


def order_tables(cfg: DagConfig, state: DagState):
    """Small per-round tables the round-received scan reads."""
    R = cfg.r_cap
    wsl = state.wslot[:R]
    valid_w = wsl >= 0
    ws = sanitize(wsl, cfg.e_cap).long()
    seqw = state.seq[ws]                                   # [R, N]
    fam = (state.famous[:R] == FAME_TRUE) & valid_w        # [R, N]
    decided = ((~valid_w) | (state.famous[:R] != FAME_UNDEFINED)).all(dim=1)
    has_w = valid_w.any(dim=1)
    fam_cnt = fam.sum(dim=1)                               # [R]
    return seqw, fam, decided, has_w, fam_cnt


def order_rr_round(cfg, state, tables, und, i: int, rr):
    """One round's round-received update: events received in round
    i_abs = i + r_off when >1/2 of its famous witnesses see them."""
    seqw, fam, decided, has_w, fam_cnt = tables
    i_abs = i + state.r_off
    active = (
        decided[i] & has_w[i] & (i_abs <= state.max_round)
        & (i_abs <= state.lcr)
    )
    sees = fam[i][None, :] & (state.fd <= seqw[i][None, :])      # [E+1, N]
    c = sees.sum(dim=1)
    cond = (
        und
        & (rr == -1)
        & (i_abs > state.round)
        & active
        & (c > fam_cnt[i] // 2)
    )
    return torch.where(cond, i_abs, rr)


def order_undetermined(cfg: DagConfig, state: DagState):
    e1 = cfg.e_cap + 1
    valid_e = (torch.arange(e1, device=state.seq.device) < state.n_events) \
        & (state.seq >= 0)
    return valid_e & (state.rr == -1)


def decide_order_impl(cfg: DagConfig, state: DagState) -> DagState:
    """Round received for every undetermined event, then consensus
    timestamps for the newly received ones."""
    n, R, e1 = cfg.n, cfg.r_cap, cfg.e_cap + 1

    tables = order_tables(cfg, state)
    seqw, fam = tables[0], tables[1]
    und = order_undetermined(cfg, state)

    # JAX folds every one of the R rounds; a round that is not active
    # leaves rr as it is, so only active rounds run here (one host read
    # of the [R] activity mask)
    decided, has_w = tables[2], tables[3]
    i_abs = torch.arange(R, dtype=I32, device=seqw.device) + state.r_off
    active = (decided & has_w & (i_abs <= state.max_round)
              & (i_abs <= state.lcr))
    rr = state.rr
    for i in torch.nonzero(active).flatten().tolist():
        rr = order_rr_round(cfg, state, tables, und, i, rr)
    newly = und & (rr != -1)

    # consensus timestamps for newly-received events
    i_of = torch.clamp(rr - state.r_off, 0, R - 1).long()

    if e1 * n <= MEDIAN_CHUNK_THRESHOLD:
        med = order_median_rows(cfg, state, seqw, fam, state.fd, i_of)
    else:
        # large-E shapes: chunk the event axis so each block's [rows, N]
        # i64 working set (and its sort double) stays bounded
        chunk = max(1, MEDIAN_CHUNK_ELEMS // n)
        med = torch.cat([
            order_median_rows(cfg, state, seqw, fam,
                              state.fd[e0:e0 + chunk], i_of[e0:e0 + chunk])
            for e0 in range(0, e1, chunk)
        ])

    cts = torch.where(newly, med, state.cts)
    return state._replace(rr=rr, cts=cts)


def order_median_rows(cfg, state, seqw, fam, fd_rows, i_rows):
    """Median consensus timestamp for a block of event rows.

    tv[x, j] = timestamp of chain j's event at seq fd[x, j] (the oldest
    self-ancestor of witness j to see x), gathered from the per-chain
    timestamp grid, masked to the famous witnesses that see x, sorted;
    the median is element ``clip(cnt // 2, 0, n-1)``."""
    n = cfg.n
    dev = fd_rows.device
    cej = state.ce[:n]                                     # [N, S+1]
    ts_grid = state.ts[sanitize(cej, cfg.e_cap).long()]    # i64[N, S+1]
    if cfg.ts32:
        # rebase against the minimum LIVE timestamp: a constant shift
        # preserves sort order, so the median is bit-identical to the
        # i64 path while the live span fits int32 (state.ts32_ok)
        valid_e = (
            (torch.arange(cfg.e_cap + 1, device=dev) < state.n_events)
            & (state.seq >= 0)
        )
        ts_base = torch.where(valid_e, state.ts, INT64_MAX).min()
        ts_base = torch.clamp(ts_base, max=INT64_MAX - 1)   # empty-DAG guard
        ts_grid = torch.clamp(ts_grid - ts_base, 0, INT32_MAX).to(I32)
        tmax = INT32_MAX
    else:
        ts_base = None
        tmax = INT64_MAX

    rows = fd_rows.shape[0]
    sees_rows = fam[i_rows] & (fd_rows <= seqw[i_rows])
    # fd values are absolute seqs; the grid columns are window-local
    fdc = torch.clamp(fd_rows - state.s_off[None, :n], 0, cfg.s_cap).long()
    tv = ts_grid[torch.arange(n, device=dev)[None, :], fdc]
    tv = torch.where(sees_rows, tv, tmax)
    tv_sorted = torch.sort(tv, dim=1).values
    cnt_s = sees_rows.sum(dim=1)
    med = tv_sorted[torch.arange(rows, device=dev),
                    torch.clamp(cnt_s // 2, 0, n - 1)]
    if cfg.ts32:
        # widen back: sentinel medians (no seer) stay INT64_MAX like the
        # i64 path (such rows are never newly received)
        med = torch.where(med == INT32_MAX, INT64_MAX,
                          med.to(I64) + ts_base)
    return med
