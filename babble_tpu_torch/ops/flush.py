"""The live flush: incremental ingest, then windowed fame and windowed
order over persisted frontiers — the port's twin of the JAX package's
``ops/flush.py``.

- **Resumed from frontiers.**  ``state.lcr`` is the order frontier and
  ``state.max_round`` bounds the undecided window, so fame and order
  work on a W-round window starting at lcr+1 instead of re-deriving
  from genesis; W is a small bucket the caller picks from host mirrors.
- **Event-axis frontier.**  Reception scans slice ``fd[o:o+F]``, where
  ``o`` is derived on the device from the first row with ``rr``
  undecided and F is a power-of-two bucket of the live frontier height
  (``bucket_f``).
- **Packed votes.**  With ``cfg.packed`` the vote tensors ride as uint8
  lanes and every tally is a popcount; otherwise the tally is an f32
  batched matmul.  Counts are exact integers on both paths.
- **Witness-set finality gate.**  With ``gate`` a round decides only once
  every non-stale chain head has passed it (``head_round_min_math``).

JAX runs a flush as one compiled program with its dynamic slices and
loop bounds on the device.  Here a flush is a sequence of torch calls
and reads no value back to the host: every clamped dynamic slice is an
index gather (``_window``), and the fame loop runs all ``W - 1`` voting
distances instead of stopping at the device-valued ``d_max`` (the extra
steps change nothing: see ``fame_window_impl``).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch
from torch.profiler import record_function

from .fame import F32, _lcr_candidates
from .ingest import EventBatch, ingest_coords_impl, ingest_rounds_impl
from .order import order_median_rows
from .pack import count_bits, pack_bits, popcount_sum
from .state import (
    FAME_FALSE,
    FAME_TRUE,
    FAME_UNDEFINED,
    DagConfig,
    DagState,
    I32,
    PER_EVENT_FIELDS,
    PER_ROUND_FIELDS,
    bucket,
    head_round_min_math,
    repack_round_bits,
    sanitize,
)

#: round-window buckets: W is rounded up to one of these so a live
#: stream (2-4 open rounds) keeps a few shapes
W_BUCKETS = (4, 8, 16)
W_MAX = W_BUCKETS[-1]

#: smallest frontier bucket (event rows the windowed order scans)
F_MIN = 256


def bucket_w(active_rounds: int, r_cap: int) -> int:
    """Smallest W bucket covering ``active_rounds`` open rounds, or 0
    when no bucket fits (the engine then leaves the latency surface)."""
    for w in W_BUCKETS:
        if active_rounds <= w and w <= r_cap:
            return w
    return 0


def bucket_f(height: int, e1: int) -> int:
    """Power-of-two frontier bucket of the live frontier height (a host
    mirror that must never under-count), clamped to the full height
    ``e1`` when the bucket would not fit."""
    f = bucket(max(int(height), 1), F_MIN)
    return e1 if f >= e1 else f


def _window(start: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """Row indices of ``lax.dynamic_slice(a, (start,), (size,))`` on an
    axis of length ``dim``: XLA clamps the start so the window fits, and
    ``dynamic_update_slice`` writes back at the same clamped start."""
    s = torch.clamp(start, 0, max(dim - size, 0)).long()
    return s + torch.arange(size, device=start.device)


def fame_window_impl(cfg: DagConfig, W: int, state: DagState,
                     gate: bool) -> DagState:
    """Diagonal-scan fame voting over the W-round window starting at
    lcr+1 (clamped so the window fits below r_cap): the recursion of
    ``fame.decide_fame_impl`` with the round axis cut to the window.
    Rounds above the window stay undecided until a later flush.

    JAX loops to the device-valued ``d_max = min(max(max_round -
    max(lcr, -1), 2), W)``; this loop runs every distance up to W, which
    reads nothing back to the host and decides the same: past ``d_max``
    every in-window row has ``can_vote`` false; rows at or below lcr
    (present when the window start is clamped) are not in the window,
    so they never decide; and a row's votes depend on that row alone."""
    n, sm, R = cfg.n, cfg.super_majority, cfg.r_cap
    dev = state.wslot.device

    lo = torch.clamp(state.lcr + 1 - state.r_off, 0, max(R - W, 0))
    rows = _window(lo, W, R + 1)
    wsl = state.wslot[rows]                            # [W, N]
    valid_w = wsl >= 0
    ws = sanitize(wsl, cfg.e_cap).long()
    law = state.la[ws]                                 # [W, N, N]
    fdw = state.fd[ws]                                 # [W, N, N]
    seqw = state.seq[ws]                               # [W, N]
    famous_w = state.famous[rows]                      # i8[W, N]

    law_next = torch.cat(
        [law[1:], torch.full((1, n, n), -1, dtype=law.dtype, device=dev)])
    valid_next = torch.cat(
        [valid_w[1:], torch.zeros((1, n), dtype=torch.bool, device=dev)])

    ss_see = law_next[:, :, None, :] >= fdw[:, None, :, :]
    ss_cnt = count_bits(ss_see) if cfg.packed else ss_see.sum(-1)
    ss_next_b = (ss_cnt >= sm) & valid_next[:, :, None] & valid_w[:, None, :]
    see_next_b = ((law_next >= seqw[:, None, :])
                  & valid_next[:, :, None] & valid_w[:, None, :])

    # window row i holds absolute round lo + i + r_off
    i_idx = torch.arange(W, dtype=I32, device=dev) + lo + state.r_off
    in_window = (i_idx > state.lcr) & (i_idx < state.max_round)
    if gate:
        in_window = in_window & (i_idx <= head_round_min_math(cfg, state))

    def decide(d, famous, v, strong, can_vote):
        """The decision update, the same on both vote layouts."""
        undecided = (famous == FAME_UNDEFINED) & valid_w & in_window[:, None]
        # coin-round period = number of active participants
        normal = (d % cfg.active_n) != 0
        if not normal:
            return famous, normal
        deciding = strong & can_vote[:, None, None]
        decide_x = deciding.any(dim=1)
        v_star = (deciding & v).any(dim=1)
        famous = torch.where(
            undecided & decide_x,
            torch.where(v_star, FAME_TRUE, FAME_FALSE).to(torch.int8),
            famous,
        )
        return famous, normal

    def zpad(x):
        # zero rows past the window, so the slice at distance d fits
        return torch.cat([x, torch.zeros_like(x)])

    if cfg.packed:
        # the voter (contraction) axis packed into uint8 lanes
        ss_pad = zpad(pack_bits(ss_next_b))                 # [2W, N, LP]
        tot_pad = zpad(popcount_sum(ss_pad[:W]))            # [2W, N]
        mb_pad = zpad(state.mbr[rows])                      # [2W, LP]
        votes = pack_bits(see_next_b.transpose(1, 2))       # [W, N, LP]
    else:
        # exact integer counts: keep the f32 matmul out of TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        ss_pad = zpad(ss_next_b.to(F32))                    # [2W, N, N]
        tot_pad = zpad(ss_pad[:W].sum(-1))                  # [2W, N]
        mb_pad = zpad(state.mbit[ws])                       # [2W, N]
        votes = see_next_b.to(F32)                          # [W, N, N]

    for d in range(2, W + 1):
        can_vote = (i_idx + d) <= state.max_round           # [W]
        ss_d = ss_pad[d - 1:d - 1 + W]
        tot_d = tot_pad[d - 1:d - 1 + W]
        mb_d = mb_pad[d:d + W]
        if cfg.packed:
            # yays[i, y, x] = popcount(ss[i, y] & votes[i, x])
            yays = popcount_sum(ss_d[:, :, None, :] & votes[:, None, :, :])
        else:
            yays = torch.bmm(ss_d, votes)
        nays = tot_d[:, :, None] - yays
        v = yays >= nays
        strong = torch.maximum(yays, nays) >= sm

        famous_w, normal = decide(d, famous_w, v, strong, can_vote)

        if cfg.packed:
            # next votes packed over the new voter axis; coin rounds
            # select per bit against the packed witness coin plane (its
            # padding bits are 0, so ~s_pk's set padding bits drop out)
            v_pk = pack_bits(v.transpose(1, 2))
            if normal:
                new = v_pk
            else:
                s_pk = pack_bits(strong.transpose(1, 2))
                new = (s_pk & v_pk) | (~s_pk & mb_d[:, None, :])
        else:
            new = (v if normal else torch.where(strong, v, mb_d[:, :, None])
                   ).to(F32)
        votes = torch.where(can_vote[:, None, None], new, votes)

    decided_round = ((~valid_w) | (famous_w != FAME_UNDEFINED)).all(dim=1)
    has_w = valid_w.any(dim=1)
    # gated: contiguous-prefix advance; the window always contains the
    # first failing round
    cand = _lcr_candidates(state, i_idx, in_window, decided_round, has_w,
                           gate)
    lcr = torch.maximum(state.lcr, torch.where(cand, i_idx, -1).max())

    famous = state.famous.clone()
    famous[rows] = famous_w
    # fame rewrote the famous table: refresh the packed bitplanes
    return repack_round_bits(cfg, state._replace(famous=famous, lcr=lcr))


def order_window_impl(cfg: DagConfig, W: int, F: int, state: DagState,
                      lcr_prev: torch.Tensor) -> DagState:
    """Round received + consensus timestamps over the W-round window
    starting at lcr_prev+1 — the only rounds that can newly receive
    events this flush (a round's reception set is frozen when it
    decides) — scanning only the F-row event-axis frontier: every row
    below the first one with ``rr == -1`` is already received.  The
    caller's F must cover every live undecided row (``F >= n_events -
    f0``); a row above the slice would never be scanned again."""
    n, e1, R = cfg.n, cfg.e_cap + 1, cfg.r_cap
    dev = state.wslot.device

    lo = torch.clamp(lcr_prev + 1 - state.r_off, 0, max(R - W, 0))
    rows = _window(lo, W, R + 1)
    wsl = state.wslot[rows]
    valid_w = wsl >= 0
    seqw = state.seq[sanitize(wsl, cfg.e_cap).long()]     # [W, N]
    fam_tab = state.famous[rows]
    fam = (fam_tab == FAME_TRUE) & valid_w                 # [W, N]
    decided = ((~valid_w) | (fam_tab != FAME_UNDEFINED)).all(dim=1)
    has_w = valid_w.any(dim=1)
    fam_cnt = fam.sum(dim=1)                               # [W]

    # event-axis frontier: first row whose reception is still open
    idx = torch.arange(e1, dtype=I32, device=dev)
    f0 = torch.where(state.rr < 0, idx, e1).min()
    o = torch.clamp(f0, 0, max(e1 - F, 0))
    erows = _window(o, F, e1)
    fd_f = state.fd[erows]                                 # [F, N]
    rr_f = state.rr[erows]
    rnd_f = state.round[erows]
    seq_f = state.seq[erows]
    und_f = (erows < state.n_events) & (seq_f >= 0) & (rr_f == -1)

    if cfg.packed:
        fmr_w = state.fmr[rows]                            # [W, LP]
    i_abs0 = lo + state.r_off
    for i in range(W):
        i_abs = i_abs0 + i
        active = (decided[i] & has_w[i] & (i_abs <= state.max_round)
                  & (i_abs <= state.lcr))
        sees_b = fd_f <= seqw[i][None, :]                  # [F, N]
        if cfg.packed:
            # reception supermajority by popcount against the round's
            # famous bit plane
            c = popcount_sum(pack_bits(sees_b) & fmr_w[i][None, :])
        else:
            c = (fam[i][None, :] & sees_b).sum(dim=1)
        cond = (und_f & (rr_f == -1) & (i_abs > rnd_f) & active
                & (c > fam_cnt[i] // 2))
        rr_f = torch.where(cond, i_abs, rr_f)
    newly_f = und_f & (rr_f != -1)

    i_of = torch.clamp(rr_f - i_abs0, 0, W - 1).long()
    med = order_median_rows(cfg, state, seqw, fam, fd_f, i_of)
    rr = state.rr.clone()
    rr[erows] = rr_f
    cts = state.cts.clone()
    cts[erows] = torch.where(newly_f, med, state.cts[erows])
    return state._replace(rr=rr, cts=cts)


def _ingest_flush(cfg: DagConfig, state: DagState,
                  batch: EventBatch) -> DagState:
    state = ingest_coords_impl(cfg, state, "incremental", batch)
    return ingest_rounds_impl(cfg, state, "incremental", batch)


def live_flush_impl(cfg: DagConfig, W: int, F: int, gate: bool,
                    state: DagState, batch: EventBatch) -> DagState:
    """One live flush end to end: incremental ingest (coords + rounds),
    then windowed fame and order.  ``batch`` may be empty (k=0, the
    drain call when gossip stops): ingest is a no-op on padded lanes and
    fame/order still advance.  The ``record_function`` regions carry the
    phase names into ``torch.profiler`` traces."""
    with record_function("babble_ingest"):
        state = _ingest_flush(cfg, state, batch)
    lcr_prev = state.lcr
    with record_function("babble_fame"):
        state = fame_window_impl(cfg, W, state, gate)
    with record_function("babble_order"):
        return order_window_impl(cfg, W, F, state, lcr_prev)


#: the JAX package's compiled entry point; eager torch runs the impl
live_flush = live_flush_impl


def _sync(state: DagState) -> None:
    if state.sp.is_cuda:
        torch.cuda.synchronize(state.sp.device)


def probed_flush(cfg: DagConfig, W: int, F: int, gate: bool,
                 state: DagState, batch: EventBatch):
    """One live flush as three timed phases, the same calls in the same
    order as ``live_flush_impl`` (so the same result).  Returns
    ``(state, {"ingest_s", "fame_s", "order_s"})``, wall times to
    completion (the card is synchronised after each phase)."""
    _sync(state)
    t0 = time.perf_counter()
    state = _ingest_flush(cfg, state, batch)
    _sync(state)
    t1 = time.perf_counter()
    lcr_prev = state.lcr
    state = fame_window_impl(cfg, W, state, gate)
    _sync(state)
    t2 = time.perf_counter()
    state = order_window_impl(cfg, W, F, state, lcr_prev)
    _sync(state)
    t3 = time.perf_counter()
    return state, {"ingest_s": t1 - t0, "fame_s": t2 - t1,
                   "order_s": t3 - t2}


# ----------------------------------------------------------------------
# bytes-touched estimates: a per-flush memory-traffic model from the
# state's shapes (first-order: logical passes over the dominant tensors,
# not a measurement).  Every per-event and per-round DagState field owns
# a FIELD_TRAFFIC row; the ``derived:*`` rows model kernel temporaries.
# Order rows scale with ``f`` (the frontier height scanned), vote
# temporaries with ``vb`` (bytes of one vote row: uint8 lanes packed,
# 4-byte f32 otherwise).


class TrafficDims(NamedTuple):
    """Inputs to one traffic row: participant width, event rows, round
    window (W, or r_cap for the full-table surface), batch size,
    coordinate itemsize, frontier height, packed lanes, vote-row bytes."""

    n: int
    e1: int
    w: int
    k: int
    isz: int
    f: int
    lp: int
    vb: int


#: field (or ``derived:*`` temporary) -> ((phase, bytes_fn), ...)
FIELD_TRAFFIC = {
    # per-event bookkeeping lanes: written once per ingested event
    "sp": (("ingest", lambda d: 4 * d.k),),
    "op": (("ingest", lambda d: 4 * d.k),),
    "creator": (("ingest", lambda d: 4 * d.k),),
    "seq": (("ingest", lambda d: 4 * d.k),
            ("fame", lambda d: 4 * d.w * d.n),       # seqw window gather
            ("order", lambda d: 4 * d.w * d.n)),
    "ts": (("ingest", lambda d: 8 * d.k),
           ("order", lambda d: 8 * d.e1)),           # median grid gather
    "mbit": (("ingest", lambda d: d.k),
             ("fame", lambda d: d.w * d.n)),         # coin-round bits
    # coordinate tensors: ingest reads two parent rows and writes the
    # new rows; fame gathers the [W, N, N] witness tables (la twice);
    # order scans the F-row frontier slice of fd per window round
    "la": (("ingest", lambda d: 3 * d.k * d.n * d.isz),
           ("fame", lambda d: 2 * d.w * d.n * d.n * d.isz)),
    "fd": (("ingest", lambda d: 3 * d.k * d.n * d.isz),
           ("fame", lambda d: d.w * d.n * d.n * d.isz),
           ("order", lambda d: d.w * d.f * d.n * d.isz)),
    "round": (("ingest", lambda d: 4 * d.k),
              ("order", lambda d: 4 * d.f)),         # frontier slice read
    "witness": (("ingest", lambda d: d.k),),
    "rr": (("order", lambda d: 2 * 4 * d.f),),       # read mask + write
    "cts": (("order", lambda d: 2 * 8 * d.f),),
    # per-round tables: window slices read (famous also written back)
    "wslot": (("fame", lambda d: 4 * d.w * d.n),),
    "famous": (("fame", lambda d: 2 * d.w * d.n),),
    "sm": (("ingest", lambda d: 4 * d.k),),          # per-event threshold gather
    # packed witness bitplanes: read by the vote recursion and the
    # reception popcounts, re-packed by the phases that own them
    "mbr": (("fame", lambda d: 2 * d.w * d.lp),),
    "fmr": (("fame", lambda d: 2 * d.w * d.lp),
            ("order", lambda d: d.w * d.lp),),
    # temporaries: the vote-row tensors (built once, ~3 touched per
    # voting distance) and the median's tv tensor + sort double
    "derived:votes": (
        ("fame", lambda d: (3 * d.w + 3 * d.w * d.w) * d.n * d.vb),
    ),
    "derived:median": (("order", lambda d: 2 * 4 * d.f * d.n),),
}

# a field that reaches runtime unmodeled fails at import
assert set(FIELD_TRAFFIC) >= set(PER_EVENT_FIELDS) | set(PER_ROUND_FIELDS), (
    "flush traffic model is missing DagState fields: "
    f"{sorted((set(PER_EVENT_FIELDS) | set(PER_ROUND_FIELDS)) - set(FIELD_TRAFFIC))}"
)


def _traffic_estimate(cfg: DagConfig, window: int, k: int,
                      f: int, packed: bool) -> dict:
    lp = cfg.lp
    d = TrafficDims(
        n=cfg.n, e1=cfg.e_cap + 1, w=window, k=k,
        isz=torch.empty((), dtype=cfg.coord_dtype).element_size(),
        f=f, lp=lp, vb=(lp if packed else 4 * cfg.n),
    )
    out = {"ingest": 0, "fame": 0, "order": 0}
    for field_rows in FIELD_TRAFFIC.values():
        for phase, fn in field_rows:
            out[phase] += int(fn(d))
    out["total"] = out["ingest"] + out["fame"] + out["order"]
    return out


def flush_bytes_estimate(cfg: DagConfig, W: int, k: int,
                         F: int | None = None) -> dict:
    """Estimated bytes touched by one live flush of ``k`` events over a
    W-round window and an F-row event frontier (full height when F is
    None), per phase and in total."""
    return _traffic_estimate(cfg, W, k,
                             cfg.e_cap + 1 if F is None else F,
                             cfg.packed)


def throughput_bytes_estimate(cfg: DagConfig, k: int) -> dict:
    """The same model for the full-table surface: fame over all r_cap
    rounds with f32 votes, order over the full [E+1, N] fd table."""
    return _traffic_estimate(cfg, cfg.r_cap, k, cfg.e_cap + 1, False)
