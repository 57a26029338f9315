"""Host-orchestrated, column-blocked consensus pipeline for wide
participant axes (the port's twin of the JAX package's ``ops/wide.py``).

The la/fd coordinate tensors are [E+1, N]: at the 10k-participant
config (a 620,001-row window) 6.2 GB each even in int8.  They are
stored **column-blocked**, as C separate tensors of shape
[E+1, ceil(N/C)], with C from ``block_count``'s rule of 1 GiB blocks
(kept as in JAX so the same forced-blocking shapes apply).  Every
consensus reduction is independent or accumulative across the
participant axis, so each step touches one block:

- la/fd level scans: column-independent recurrences, one per block;
- strongly-see counts (frontier march, fame voting): per-block partial
  counts accumulated into an [A, B] i32 tally by ``ss.ss_counts_acc``,
  which launches the hand-written ``csrc/ss_count.cu`` on the card;
- round-received / median timestamps: per-block partial see-counts and
  per-block timestamp columns, concatenated only at [chunk, N] size.

Loops live on the host, with one read of a loop-control scalar per
step, as in JAX.

Rolling-window support (``ops/stream.py`` runs it): the blocked
la/fd store **window-local** seq values — ``abs_seq - s_off[col]`` —
with a floor clamp at -1.  On fresh states (offsets zero) this is the
absolute convention.  Under compaction:

- la: any value < 0 means "no ancestor on this chain at or above the
  window base"; one sentinel (-1) serves both that and "no ancestor".
- fd: INF (``cfg.fd_inf``) keeps "no descendant"; -1 means "first
  descendant below the window base", which compares exactly in every
  consumer (the strongly-see right side only gathers witness rows of
  live rounds, and the order phase's ``fd <= seq_w`` is true for any
  below-window descendant).
- the one inexact family, la vs fd with BOTH sides below the window,
  never occurs on witness rows; the median additionally counts ``bad``
  rows (below-window fd selected by a newly-ordered row), which the
  stream asserts is 0.

All chain positions the march/fame/order steps exchange (pos tables,
bisect bounds, witness seqs) are window-local as well; compaction
shifts block rows and rebases values per column.

Torch against JAX: every program of ``_jits`` is a plain function over
torch tensors.  Where JAX donates a block (the la/fd scans, compaction,
the ss tally's ``acc``, the march's pos table) the port updates that
tensor in place and returns it, which keeps one copy of each 1 GB block;
every other program returns new tensors.  Gathers go through explicit
clamps (``sanitize``, ``_col_gather``'s clip on the ragged last block).
The JAX package's TPU-only forms (the one-hot partial count, the
select-accumulate median loop) are not taken: the port runs the forms
JAX runs off the TPU.  The stacked forms hold the blocks as one
[C, E+1, w] tensor on one device.

Mesh-sharded stacked form (``ops/stream.py WideStream(mesh=)``, JAX's
``P("p", None, None)`` block layout): each rank of the mesh's "p" axis
holds C/p consecutive blocks ``[C/p, E+1, w]``, described by the
``shard`` the mesh builds (``Mesh.block_shard``: blocks ``[lo, hi)``
and the reducers over the "p" axis), which the ``run_wide_*``
functions take and hand to the stacked twins at call time.  The
per-block work stays local, with ``offs`` holding each local block's
global column origin; the cross-block reductions of the stacked twins
go over the axis: ``ss_stacked`` and
``sees_stacked`` sum their local partials, ``votes0_stacked``,
``inherit_stacked`` and ``med_tv_stacked``'s timestamp columns gather
along the blocks, its counts sum and its ``bad`` rows take the max.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..obs.spans import host_read, stage
from . import fame as fame_ops
from . import ingest as ingest_ops
from . import order as order_ops
from .ingest import EventBatch
from .ss import ss_counts_acc
from .state import (
    FAME_FALSE,
    FAME_TRUE,
    FAME_UNDEFINED,
    I32,
    I64,
    INT32_MAX,
    INT64_MAX,
    DagConfig,
    DagState,
    init_state,
    sanitize,
)

F32 = torch.float32

# target bytes per coordinate block (the JAX package's constant)
BLOCK_TARGET_BYTES = 1 << 30

#: rows of a block rebased per step of ``compact_block`` (bounds its
#: int32 temporaries at the 10k config to a few hundred MB)
COMPACT_ROWS = 1 << 16

def wide_wins(cfg: DagConfig) -> bool:
    """Same working-set bound as ops.fame.fame_mode."""
    return fame_ops.fame_mode(cfg) == "block"


def block_count(cfg: DagConfig) -> int:
    bytes_per = (cfg.e_cap + 1) * cfg.n * cfg.coord_dtype.itemsize
    return max(1, -(-bytes_per // BLOCK_TARGET_BYTES))


def _block_width(cfg: DagConfig, C: int) -> int:
    return -(-cfg.n // C)


def _use_onehot_partial(cfg: DagConfig) -> bool:
    """The JAX package takes an int8 one-hot matmul for the per-block
    partial only on a TPU backend; off the TPU it takes the compare
    count, and so does the port (hazard (f))."""
    return False


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        host_read(torch.cuda.synchronize, t.device)


@functools.lru_cache(maxsize=8)
def _jits(cfg: DagConfig, C: int):
    """Per-(config, block-count) step programs (JAX: jitted; here plain
    functions over torch tensors).  The stacked twins that reduce across
    blocks take the rank's ``shard`` of a mesh-sharded stacked form at
    call time (module docstring; None on one device)."""
    n, e_cap, s_cap, r_cap = cfg.n, cfg.e_cap, cfg.s_cap, cfg.r_cap
    w = _block_width(cfg, C)
    sm = cfg.super_majority
    fd_inf = int(cfg.fd_inf)

    def _ar(k, like, dtype=torch.int64):
        return torch.arange(k, dtype=dtype, device=like.device)

    # ---------------- coords ----------------

    def write_batch(state, batch):
        # la/fd are block tensors, never part of `state` here
        return ingest_ops._write_batch_fields(state, cfg, batch)

    def _la_sched(sp, op, creator, seq, s_off, slot_sched):
        """Schedule-wide gathers the la scan reads, computed once for all
        C blocks (only la changes during the scan)."""
        idx = slot_sched.long()
        spx = sanitize(sp[idx], e_cap).long()
        opx = sanitize(op[idx], e_cap).long()
        cr = creator[idx]
        seq_loc = seq[idx] - s_off[torch.clamp(cr, 0, n).long()]
        return idx, spx, opx, cr, seq_loc

    def la_block_scan(sp, op, creator, seq, s_off, la_blk, slot_sched,
                      blk_off, pre=None):
        """Whole-schedule la fill for one column block, in place on
        ``la_blk``.  Own-seq writes are window-local (module
        docstring).  Padding lanes (slot e_cap) rewrite the sentinel row
        with its own -1 values."""
        idx, spx, opx, cr, seq_loc = pre or _la_sched(
            sp, op, creator, seq, s_off, slot_sched)
        col = _ar(w, la_blk)
        own = (cr - blk_off).long()
        own_here = (own >= 0) & (own < w)
        for t in range(idx.shape[0]):
            rows = torch.maximum(la_blk[spx[t]], la_blk[opx[t]])   # [B, w]
            put = own_here[t][:, None] & (col[None, :] == own[t][:, None])
            rows = torch.where(put, seq_loc[t][:, None].to(rows.dtype), rows)
            la_blk[idx[t]] = rows
        la_blk[e_cap] = -1
        return la_blk

    def _fd_sched(sp, op, slot_sched):
        """Schedule-wide gathers the fd sweep reads, once for all C
        blocks."""
        idx = slot_sched.long()
        return (idx, sanitize(sp[idx], e_cap).long(),
                sanitize(op[idx], e_cap).long())

    def fd_block_scan(sp, op, creator, seq, s_off, b_seq, b_k, n_events,
                      fd_blk, slot_sched, blk_off, pre=None):
        """Whole-schedule reversed fd fill for one column block, in place
        on ``fd_blk``, including the own-seq seeding (window-local
        values).  Padding and foreign lanes seed the sentinel row, which
        only feeds the sentinel row and is reset at the end."""
        kpad = b_seq.shape[0]
        pos = _ar(kpad, b_seq, I32)
        real = pos < b_k
        slots = torch.where(real, n_events - b_k + pos, e_cap).long()
        own_c = torch.where(real, creator[slots], n)
        own = own_c - blk_off
        own_here = (own >= 0) & (own < w) & real
        b_seq_loc = b_seq - s_off[torch.clamp(own_c, 0, n).long()]
        fd_blk[torch.where(own_here, slots, e_cap),
               torch.clamp(own, 0, w - 1).long()] = b_seq_loc.to(fd_blk.dtype)
        idx, spx, opx = pre or _fd_sched(sp, op, slot_sched)
        for t in range(idx.shape[0] - 1, -1, -1):
            rows = fd_blk[idx[t]]                                  # [B, w]
            fd_blk.scatter_reduce_(0, spx[t][:, None].expand(-1, w), rows,
                                   "amin")
            fd_blk.scatter_reduce_(0, opx[t][:, None].expand(-1, w), rows,
                                   "amin")
        fd_blk[e_cap] = fd_inf
        return fd_blk

    def coord_sent(state):
        return ingest_ops._reset_coord_sentinels(state, cfg,
                                                 include_coords=False)

    # ---------------- blocked strongly-see partials ----------------

    def ss_partial(rows_a, rows_b, acc):
        """acc += |{k in block : rows_a[a,k] >= rows_b[b,k]}|, in place:
        the exact per-block partial of the strongly-see count (the
        compare form; hazard (f))."""
        return ss_counts_acc(rows_a, rows_b, acc)

    def gather_rows(blk, idx):
        """[A, w] rows of one coordinate block (sentinel row for idx<0)."""
        return blk[sanitize(idx, e_cap).long()]

    # ---------------- frontier march ----------------

    def frontier_prep(state):
        cnt = state.cnt[:n] - state.s_off[:n]
        pos0 = torch.where(cnt > 0, 0, INT32_MAX).to(I32)
        pos_table0 = torch.full((r_cap + 1, n), INT32_MAX, dtype=I32,
                                device=cnt.device)
        pos_table0[0] = pos0
        return cnt, pos0, pos_table0

    def _chain(state, col):
        return state.ce[:n][_ar(n, col), torch.clamp(col, 0, s_cap).long()]

    def round_witnesses(state, cnt, pos):
        valid_w = pos < cnt
        return torch.where(valid_w, _chain(state, pos), -1), valid_w

    def bisect_candidates(state, lo, hi):
        mid = (lo + hi) >> 1
        return mid, _chain(state, mid)

    def bisect_update(cnt_ab, valid_w, lo, hi, mid, chains_cnt):
        ss = (cnt_ab >= sm) & valid_w[None, :]
        ok = ss.sum(-1) >= sm
        active = lo < hi
        hi = torch.where(ok & active, mid, hi)
        lo = torch.where(~ok & active, mid + 1, lo)
        return lo, hi

    def _col_gather(v, blk_off, fill=None):
        """Block-columns of a length-n vector via a clipped gather (a
        slice would misalign the ragged last block: hazard (a))."""
        cols = blk_off + _ar(w, v)
        out = v[torch.clamp(cols, 0, v.shape[0] - 1)]
        if fill is not None:
            out = torch.where(cols < n, out, fill)
        return out

    def inherit_block(fde_blk):
        """Per-block descent inheritance: min over witnesses of their
        first-inc events' fd rows (already window-local positions)."""
        m = fde_blk.amin(dim=0).to(I32)                       # [w] local
        return torch.where(m >= fd_inf, INT32_MAX, m)

    def frontier_next(cnt, pos, pos_table, r, s_star, found, inherit,
                      frozen, prev_next):
        """Row min(r+1, r_cap) of ``pos_table`` is written in place."""
        pos_next = torch.minimum(
            torch.where(found, s_star, INT32_MAX).to(I32), inherit)
        pos_next = torch.maximum(pos_next, pos)  # monotone safety
        # resumed march: positions found at an earlier march are frozen
        pos_next = torch.where(frozen, prev_next, pos_next)
        any_next = (pos_next < cnt).any()
        pos_table[min(r + 1, r_cap)] = pos_next
        return pos_next, pos_table, any_next

    def march_bounds(pos_r, prev_next, cnt, cnt_prev):
        """Bisect bounds for one resumed march step: frozen chains pin
        lo=hi at their known position; open chains search only the
        events appended since the last march (window-local).  On fresh
        runs (cnt_prev=0) these are the full-range bounds."""
        frozen = prev_next < cnt_prev
        valid_w = pos_r < cnt
        lo_u = torch.where(valid_w, torch.maximum(pos_r, cnt_prev), cnt)
        lo = torch.where(frozen, prev_next, lo_u)
        hi = torch.where(frozen, prev_next, cnt)
        span = torch.clamp(hi - lo, min=0).max()
        return frozen, lo, hi, span

    def march_open(pos_table, cnt_prev):
        """Per-round-row openness: a row is closed once every chain's
        position was found before the last march."""
        return (pos_table >= cnt_prev[None, :]).any(dim=1)

    def wit_seq_loc(state_seq, state_s_off, ws):
        """Window-local witness seqs per creator column (ws is creator-
        indexed, [N] or [R, N]).  Sentinel rows yield negatives, masked
        by the callers' validity masks."""
        return state_seq[sanitize(ws, e_cap).long()] - state_s_off[:n]

    def frontier_fin(state, pos_table):
        state = ingest_ops.frontier_finalize(state, cfg, pos_table)
        return ingest_ops._reset_round_sentinels(state, cfg)

    # ---------------- fame ----------------

    def fame_wits(state, i):
        """Witness slots/validity of window round row i (clamped)."""
        ws = fame_ops._wrow(state.wslot, i)
        return ws, ws >= 0

    def head_round_min(state):
        """Smallest chain-head round over all minted chains: round i's
        witness set is final iff every chain's head round >= i.  Never-
        minted chains map to -1, so mid-stream fame decides nothing
        until every participant has minted (the JAX package's liveness
        assumption, kept)."""
        cnt_w = state.cnt[:n] - state.s_off[:n]
        heads = state.ce[_ar(n, cnt_w),
                         torch.clamp(cnt_w - 1, 0, s_cap).long()]
        hr = state.round[sanitize(torch.where(cnt_w > 0, heads, -1),
                                  e_cap).long()]
        return torch.where(state.cnt[:n] > 0, hr, -1).min()

    def votes0_block(la1_blk_rows, seqw_i, blk_off, valid_1, valid_i):
        """Block-columns of the d=1 direct see votes."""
        sw = _col_gather(seqw_i, blk_off)
        vi = _col_gather(valid_i, blk_off, fill=False)
        return ((la1_blk_rows >= sw[None, :])
                & valid_1[:, None] & vi[None, :]).to(F32)

    def fame_tally(cnt_ab, valid_j, valid_p, valid_i, votes, famous_i,
                   mb_j, d):
        """One voting step (hazard (g)): the JAX package tallies with a
        bf16 dot_general into f32; here an f32 matmul.  Votes and
        strong-see flags are 0/1 (exact in TF32 and bf16 too) and the
        counts stay under 2^24, so both are exact under any matmul
        precision the process sets."""
        ss = ((cnt_ab >= sm) & valid_j[:, None] & valid_p[None, :]).to(F32)
        tot = ss.sum(-1)
        yays = ss @ votes
        nays = tot[:, None] - yays
        v = yays >= nays
        strong = torch.maximum(yays, nays) >= sm
        normal = (d % cfg.active_n) != 0

        deciding = strong & normal
        decide_x = deciding.any(dim=0)
        v_star = (deciding & v).any(dim=0)
        und = (famous_i == FAME_UNDEFINED) & valid_i
        famous_i = torch.where(
            und & decide_x,
            torch.where(v_star, FAME_TRUE, FAME_FALSE).to(torch.int8),
            famous_i,
        )
        coin_vote = torch.where(strong, v, mb_j[:, None])
        votes = (v if normal else coin_vote).to(F32)
        und2 = (famous_i == FAME_UNDEFINED) & valid_i
        return votes, famous_i, und2.any()

    def fame_write(famous_tab, famous_i, i):
        """Row i of ``famous_tab`` in place (the caller owns a copy)."""
        famous_tab[min(max(i, 0), famous_tab.shape[0] - 1)] = famous_i
        return famous_tab

    def fame_fin(state, famous_out):
        return fame_ops.fame_advance_lcr(cfg, state, famous_out)

    # ---------------- order ----------------

    def order_prep(state):
        R = r_cap
        wsl = state.wslot[:R]
        valid_w = wsl >= 0
        # window-local witness seqs (fd block values are local too)
        seqw = state.seq[sanitize(wsl, e_cap).long()] \
            - state.s_off[None, :n]
        fam = (state.famous[:R] == FAME_TRUE) & valid_w
        decided = ((~valid_w)
                   | (state.famous[:R] != FAME_UNDEFINED)).all(dim=1)
        has_w = valid_w.any(dim=1)
        fam_cnt = fam.sum(dim=1)
        und = order_ops.order_undetermined(cfg, state)
        return seqw, fam, decided, has_w, fam_cnt, und

    def sees_partial_block(fd_blk, seqw_i, fam_i, blk_off, acc):
        """acc + per-event count of famous round-i witnesses in this
        block that see the event."""
        sw = _col_gather(seqw_i, blk_off)
        fm = _col_gather(fam_i, blk_off, fill=False)
        sees = fm[None, :] & (fd_blk <= sw[None, :])          # [E+1, w]
        return acc + sees.sum(dim=1, dtype=I32)

    def order_rr_update(state, und, decided_i, has_w_i, fam_cnt_i, i, c,
                        rr):
        i_abs = state.r_off + i
        active = decided_i & has_w_i & (i_abs <= state.max_round)
        cond = (und & (rr == -1) & (i_abs > state.round) & active
                & (c > fam_cnt_i // 2))
        return torch.where(cond, i_abs, rr)

    med_chunk = max(1, min(order_ops.MEDIAN_CHUNK_ELEMS // n,
                           cfg.e_cap + 1))

    def _col_gather_t(tab, blk_off, fill=None):
        """Block-columns of an [R, n] table (clipped gather)."""
        cols = blk_off + _ar(w, tab)
        out = tab[:, torch.clamp(cols, 0, tab.shape[1] - 1)]
        if fill is not None:
            out = torch.where(cols[None, :] < n, out, fill)
        return out

    def ts_range(state):
        valid = state.seq >= 0
        tmin = torch.where(valid, state.ts, INT64_MAX).min()
        tmax = torch.where(valid, state.ts, -INT64_MAX - 1).max()
        # timestamps are granular (the sim quantizes to 1 us): dividing
        # by the granularity brings a long span under 2^31 for the i32
        # median path
        div1000 = (torch.where(valid, torch.remainder(state.ts - tmin, 1000),
                               0) == 0).all()
        return tmin, tmax, div1000

    def med_tv_block(state, fd_blk_rows, i_rows, seqw, fam, blk_off,
                     tmin, scale, rel32):
        """Per-block tv columns for a chunk of events: the timestamp of
        chain j's event at seq fd[x, j], masked to famous seers.  With
        ``rel32`` the median runs on i32 offsets from tmin divided by
        ``scale``.  Rows with no seers surface INF and are masked by
        ``newly`` downstream.  The gather form (hazard (f): JAX's TPU
        branch is a select-accumulate loop over seqs)."""
        rows_c = torch.clamp(blk_off + _ar(w, fd_blk_rows), 0, n)
        cej = state.ce[rows_c]                               # [w, S+1]
        ts_grid = state.ts[sanitize(cej, e_cap).long()]      # i64[w, S+1]
        if rel32:
            # invalid grid cells wrap to garbage, but every cell a `sees`
            # row selects is a real event (fd <= seqw implies existence)
            ts_grid = torch.div(ts_grid - tmin, scale,
                                rounding_mode="floor").to(I32)
            inf = INT32_MAX
        else:
            inf = INT64_MAX
        sw = _col_gather_t(seqw, blk_off)[i_rows.long()]      # [chunk, w]
        fm = _col_gather_t(fam, blk_off, fill=False)[i_rows.long()]
        sees = fm & (fd_blk_rows <= sw)
        # below-window fd selected by a seer: counted, asserted 0 upstream
        bad = (sees & (fd_blk_rows < 0)).any(dim=1)
        fdc = torch.clamp(fd_blk_rows, 0, s_cap).long()
        tv = ts_grid[_ar(w, fdc)[None, :], fdc]
        return (torch.where(sees, tv, inf), sees.sum(dim=1, dtype=I32),
                bad)

    def med_reduce(tv_full, cnt_s, newly_rows, cts_rows, tmin, scale,
                   rel32):
        tv_sorted = torch.sort(tv_full, dim=1).values
        rows = tv_full.shape[0]
        med = tv_sorted[_ar(rows, tv_full),
                        torch.clamp(cnt_s // 2, 0, n - 1).long()]
        if rel32:
            med = med.to(I64) * scale + tmin
        return torch.where(newly_rows, med, cts_rows)

    def slice_rows(a, e0, rows):
        e0 = min(max(e0, 0), a.shape[0] - rows)
        return a[e0:e0 + rows]

    def write_rows(a, e0, rows):
        """Rows in place (the caller owns ``a``)."""
        e0 = min(max(e0, 0), a.shape[0] - rows.shape[0])
        a[e0:e0 + rows.shape[0]] = rows
        return a

    # ---------------- rolling-window compaction ----------------

    def compact_block(blk, de, ds_cols, is_fd):
        """Shift a coordinate block down by de rows, in place (the tail
        back-fills from the sentinel row, like state.compact_impl) and
        rebase values to the new window base: local -= ds, floored at
        -1 ("below window").  la negatives and fd INF are fixpoints.
        Runs in ascending row chunks: a chunk reads rows at or above its
        own, none of which an earlier chunk wrote."""
        e1 = e_cap + 1
        ds = ds_cols[None, :].to(I32)
        for r0 in range(0, e1, COMPACT_ROWS):
            r1 = min(r0 + COMPACT_ROWS, e1)
            eidx = torch.clamp(_ar(r1 - r0, blk) + r0 + de, max=e_cap)
            v = blk[eidx]
            vi = v.to(I32)
            shifted = torch.clamp(vi - ds, min=-1)
            keep = vi >= fd_inf if is_fd else v < 0
            blk[r0:r1] = torch.where(keep, v, shifted.to(v.dtype))
        return blk

    def compact_march(pos_table, cnt_prev, dr, ds):
        """Roll the march carry: round rows shift by dr (row r_cap is
        never written by the march, so the clamp back-fills INF), and
        window-local positions rebase by each chain's seq shift."""
        ridx = torch.clamp(_ar(r_cap + 1, pos_table) + dr, max=r_cap)
        pt = pos_table[ridx]
        pt = torch.where(pt == INT32_MAX, INT32_MAX,
                         torch.clamp(pt - ds[None, :], min=0)).to(I32)
        return pt, torch.clamp(cnt_prev - ds, min=0).to(I32)

    def newly_range(newly):
        """[lo, hi) slot bounds of the newly-ordered rows
        (INT32_MAX/-1+1 when empty)."""
        idx = _ar(newly.shape[0], newly)
        lo = torch.where(newly, idx, INT32_MAX).min()
        hi = torch.where(newly, idx, -1).max() + 1
        return lo, hi

    # ---------------- stacked twins ----------------
    # The same block programs over one [C, E+1, w] tensor; ``offs`` is
    # the per-block column origin (block c starts at column c*w).  The
    # scans and compaction update each block's view in place; the
    # strongly-see partial is one ss_count launch over all C blocks.

    def la_scan_stacked(sp, op, creator, seq, s_off, LA, slot_sched,
                        offs):
        pre = _la_sched(sp, op, creator, seq, s_off, slot_sched)
        for c in range(LA.shape[0]):
            la_block_scan(sp, op, creator, seq, s_off, LA[c], slot_sched,
                          offs[c], pre)
        return LA

    def fd_scan_stacked(sp, op, creator, seq, s_off, b_seq, b_k, n_events,
                        FD, slot_sched, offs):
        pre = _fd_sched(sp, op, slot_sched)
        for c in range(FD.shape[0]):
            fd_block_scan(sp, op, creator, seq, s_off, b_seq, b_k,
                          n_events, FD[c], slot_sched, offs[c], pre)
        return FD

    def gather_stacked(blocks, idx):
        return blocks[:, sanitize(idx, e_cap).long()]

    def _over_blocks(t, dim, shard):
        # local blocks' columns -> every block's, in block order
        return t if shard is None else shard.gather(t, dim)

    def ss_stacked(law, fdw, shard=None):
        z = torch.zeros((law.shape[1], fdw.shape[1]), dtype=I32,
                        device=law.device)
        acc = ss_counts_acc(law, fdw, z)
        if shard is None:
            return acc
        return shard.count("ss_count", acc, law.shape[0] * law.shape[2])

    def votes0_stacked(law, seqw_i, offs, valid_1, valid_i, shard=None):
        v = torch.cat([votes0_block(law[c], seqw_i, offs[c], valid_1,
                                    valid_i) for c in range(law.shape[0])],
                      dim=1)
        return _over_blocks(v, 1, shard)[:, :n]

    def inherit_stacked(fde, shard=None):
        return _over_blocks(torch.cat([inherit_block(fde[c])
                                       for c in range(fde.shape[0])]), 0,
                            shard)[:n]

    def sees_stacked(FD, seqw_i, fam_i, offs, shard=None):
        acc = torch.zeros((e_cap + 1,), dtype=I32, device=FD.device)
        for c in range(FD.shape[0]):
            acc = sees_partial_block(FD[c], seqw_i, fam_i, offs[c], acc)
        return acc if shard is None else shard.sum(acc)

    def med_tv_stacked(state, FD_rows, i_rows, seqw, fam, offs, tmin,
                       scale, rel32, shard=None):
        outs = [med_tv_block(state, FD_rows[c], i_rows, seqw, fam, offs[c],
                             tmin, scale, rel32)
                for c in range(FD_rows.shape[0])]
        tvf = _over_blocks(torch.cat([o[0] for o in outs], dim=1), 1,
                           shard)[:, :n]
        cnt = outs[0][1]
        for o in outs[1:]:
            cnt = cnt + o[1]
        bad = torch.stack([o[2] for o in outs]).any(dim=0)
        if shard is not None:
            cnt, bad = shard.sum(cnt), shard.max(bad)
        return tvf, cnt, bad

    def slice_stacked(A, e0, rows):
        e0 = min(max(e0, 0), A.shape[1] - rows)
        return A[:, e0:e0 + rows]

    def compact_stacked(blocks, de, ds_stack, is_fd):
        for c in range(blocks.shape[0]):
            compact_block(blocks[c], de, ds_stack[c], is_fd)
        return blocks

    return dict(
        write_batch=write_batch, la_block_scan=la_block_scan,
        fd_block_scan=fd_block_scan, coord_sent=coord_sent,
        la_sched=_la_sched, fd_sched=_fd_sched,
        ss_partial=ss_partial, gather_rows=gather_rows,
        frontier_prep=frontier_prep, round_witnesses=round_witnesses,
        bisect_candidates=bisect_candidates, bisect_update=bisect_update,
        inherit_block=inherit_block, frontier_next=frontier_next,
        march_bounds=march_bounds, march_open=march_open,
        wit_seq_loc=wit_seq_loc,
        frontier_fin=frontier_fin,
        fame_wits=fame_wits, head_round_min=head_round_min,
        votes0_block=votes0_block,
        fame_tally=fame_tally, fame_write=fame_write, fame_fin=fame_fin,
        order_prep=order_prep, sees_partial_block=sees_partial_block,
        order_rr_update=order_rr_update, med_tv_block=med_tv_block,
        ts_range=ts_range,
        med_reduce=med_reduce, slice_rows=slice_rows,
        write_rows=write_rows, med_chunk=med_chunk, width=w,
        compact_block=compact_block, compact_march=compact_march,
        newly_range=newly_range,
        la_scan_stacked=la_scan_stacked, fd_scan_stacked=fd_scan_stacked,
        gather_stacked=gather_stacked, ss_stacked=ss_stacked,
        votes0_stacked=votes0_stacked, inherit_stacked=inherit_stacked,
        sees_stacked=sees_stacked, med_tv_stacked=med_tv_stacked,
        slice_stacked=slice_stacked, compact_stacked=compact_stacked,
    )


class MarchCarry:
    """Persistent frontier-march state for windowed streaming
    (ops/stream.py): the per-round first-position table plus the chain
    lengths at the last march (what freezes already-found positions)."""

    __slots__ = ("pos_table", "cnt_prev")

    def __init__(self, pos_table, cnt_prev):
        self.pos_table = pos_table
        self.cnt_prev = cnt_prev


def _init_blocks(cfg: DagConfig, C: int, device="cuda"):
    w = _block_width(cfg, C)
    e1 = cfg.e_cap + 1
    cd = cfg.coord_dtype
    la = tuple(torch.full((e1, w), -1, dtype=cd, device=device)
               for _ in range(C))
    fd = tuple(torch.full((e1, w), cfg.fd_inf, dtype=cd, device=device)
               for _ in range(C))
    return la, fd


def _init_blocks_stacked(cfg: DagConfig, C: int, mesh=None, device="cuda"):
    """Stacked block tensors [C, E+1, w] on one device; with ``mesh``
    (an axis named "p") this rank's C/p blocks ``[C/p, E+1, w]``, as
    JAX's ``P("p", None, None)`` places them, on the mesh's device."""
    w = _block_width(cfg, C)
    e1 = cfg.e_cap + 1
    cd = cfg.coord_dtype
    c_loc = C
    if mesh is not None:
        if C % mesh.shape["p"]:
            raise ValueError(
                f"block count C={C} must be a multiple of mesh "
                f"'p'={mesh.shape['p']}"
            )
        c_loc, device = C // mesh.shape["p"], mesh.device
    la = torch.full((c_loc, e1, w), -1, dtype=cd, device=device)
    fd = torch.full((c_loc, e1, w), cfg.fd_inf, dtype=cd, device=device)
    return la, fd


def _is_stacked(blocks) -> bool:
    return not isinstance(blocks, (tuple, list))


def _block_offs(C: int, w: int, shard=None):
    """Global column origin of each block held here (all C blocks, or
    the shard's)."""
    blocks = range(C) if shard is None else range(shard.lo, shard.hi)
    return [c * w for c in blocks]


def _gather_all(j, C, blocks, idx):
    """Rows of every block for slot indices idx: stacked [C, A, w] or a
    list of C [A, w] tensors."""
    if _is_stacked(blocks):
        return j["gather_stacked"](blocks, idx)
    return [j["gather_rows"](blocks[c], idx) for c in range(C)]


def _ss_all(j, C, w, law, fdw, n, shard=None):
    """Full strongly-see counts from per-block gathered rows."""
    if _is_stacked(law):
        return j["ss_stacked"](law, fdw, shard)
    return _blocked_ss(j, C, w, law, fdw, n)


def _split_blocks(cfg: DagConfig, C: int, full: torch.Tensor, fill):
    """Split a full [E+1, N] tensor into C padded column blocks."""
    w = _block_width(cfg, C)
    e1 = cfg.e_cap + 1
    out = []
    for c in range(C):
        blk = full[:, c * w:(c + 1) * w]
        if blk.shape[1] < w:
            blk = torch.cat([blk, torch.full((e1, w - blk.shape[1]), fill,
                                             dtype=blk.dtype,
                                             device=blk.device)], dim=1)
        out.append(blk.contiguous().clone())
    return tuple(out)


def _assemble_blocks(cfg: DagConfig, blocks) -> torch.Tensor:
    if _is_stacked(blocks):
        blocks = list(blocks)
    return torch.cat(list(blocks), dim=1)[:, :cfg.n]


def run_wide_coords(cfg: DagConfig, state: DagState, batch: EventBatch,
                    la_blocks, fd_blocks, C: int, fd_slot_sched=None,
                    shard=None):
    """Blocked coordinate fill: batch write + per-block la/fd scans
    (window-local values; exact on fresh states where offsets are 0).
    The blocks are updated in place and returned.

    ``fd_slot_sched`` (streaming): a level schedule of WINDOW slots the
    reversed fd sweep must cover.  An la row is final at insert, so la
    scans only the batch; fd rows keep gaining first-descendants until
    every chain has one, and min is idempotent, so re-sweeping all live
    levels reaches the exact transitive closure.  Default (one-shot
    batch): the batch schedule is the whole window.  ``shard``: the
    rank's blocks of a mesh-sharded stacked form (module docstring)."""
    j = _jits(cfg, C)
    with stage("wide.coords.write"):
        state = j["write_batch"](state, batch)
        base = state.n_events - batch.k
        slot_sched = torch.where(batch.sched >= 0, base + batch.sched,
                                 cfg.e_cap)
    if fd_slot_sched is None:
        fd_slot_sched = slot_sched
    w = j["width"]
    sp, op, creator, seq = state.sp, state.op, state.creator, state.seq
    s_off = state.s_off
    stacked = _is_stacked(la_blocks)
    offs = _block_offs(C, w, shard) if stacked else None
    with stage("wide.coords.la_scan"):
        if stacked:
            la_blocks = j["la_scan_stacked"](sp, op, creator, seq, s_off,
                                             la_blocks, slot_sched, offs)
        else:
            la_pre = j["la_sched"](sp, op, creator, seq, s_off, slot_sched)
            la_blocks = tuple(
                j["la_block_scan"](sp, op, creator, seq, s_off,
                                   la_blocks[c], slot_sched, c * w, la_pre)
                for c in range(C)
            )
    with stage("wide.coords.fd_sweep"):
        if stacked:
            fd_blocks = j["fd_scan_stacked"](sp, op, creator, seq, s_off,
                                             batch.seq, batch.k,
                                             state.n_events, fd_blocks,
                                             fd_slot_sched, offs)
        else:
            fd_pre = j["fd_sched"](sp, op, fd_slot_sched)
            fd_blocks = tuple(
                j["fd_block_scan"](sp, op, creator, seq, s_off, batch.seq,
                                   batch.k, state.n_events, fd_blocks[c],
                                   fd_slot_sched, c * w, fd_pre)
                for c in range(C)
            )
    state = j["coord_sent"](state)
    return state, la_blocks, fd_blocks


def _blocked_ss(j, C, w, la_rows_by_block, fd_rows_by_block, n):
    """Accumulate per-block strongly-see partials into [A, B] counts:
    one ss_count launch a block into one int32 tally."""
    acc = torch.zeros(
        (la_rows_by_block[0].shape[0], fd_rows_by_block[0].shape[0]),
        dtype=I32, device=la_rows_by_block[0].device,
    )
    for c in range(C):
        acc = j["ss_partial"](la_rows_by_block[c], fd_rows_by_block[c], acc)
    return acc


def run_wide_rounds(cfg: DagConfig, state: DagState, la_blocks,
                    fd_blocks, C: int, stats=None,
                    carry: Optional[MarchCarry] = None,
                    shard=None) -> DagState:
    """Blocked host-driven frontier march (twin of the fused
    ``_rounds_frontier``).

    With ``carry`` (windowed streaming) the march resumes: rows whose
    positions were all found at the last march are frozen (appended
    events cannot change them: an event's round criterion only counts
    ancestor witnesses), and open rows bisect only over the appended
    suffix.  The carry is updated for the next resume.  ``shard``: as in
    ``run_wide_coords``."""
    j = _jits(cfg, C)
    w = j["width"]
    n, s_cap, r_cap = cfg.n, cfg.s_cap, cfg.r_cap

    cnt, pos0, pos_table0 = j["frontier_prep"](state)
    if carry is None:
        pos_table = pos_table0
        cnt_prev = torch.zeros((n,), dtype=I32, device=cnt.device)
        r = 0
    else:
        # refresh row 0 (chains empty at the last march may be live now)
        pos_table = carry.pos_table.clone()
        pos_table[0] = pos0
        cnt_prev = carry.cnt_prev
        open_rows = host_read(
            j["march_open"](pos_table, cnt_prev).cpu).numpy()
        first_open = int(np.argmax(open_rows)) if open_rows.any() else 0
        r = max(0, first_open - 1)
    pos = pos_table[r].clone()

    steps = 0
    alive = True
    while alive and r < r_cap - 1:
        prev_next = pos_table[r + 1].clone()
        frozen, lo, hi, span = j["march_bounds"](pos, prev_next, cnt,
                                                 cnt_prev)
        ws, valid_w = j["round_witnesses"](state, cnt, pos)
        fdw = _gather_all(j, C, fd_blocks, ws)

        bisect_iters = max(1, int(host_read(span.item)).bit_length())
        for _ in range(bisect_iters):
            mid, xs = j["bisect_candidates"](state, lo, hi)
            law = _gather_all(j, C, la_blocks, xs)
            cnt_ab = _ss_all(j, C, w, law, fdw, n, shard)
            lo, hi = j["bisect_update"](cnt_ab, valid_w, lo, hi, mid, cnt)
        if stats is not None:
            stats["ss_tallies"] = stats.get("ss_tallies", 0) + bisect_iters
        s_star = lo
        found = s_star < cnt

        # descent inheritance via the first-inc events' fd rows
        _, e_star = j["bisect_candidates"](state, s_star, s_star)
        e_star = torch.where(found, e_star, -1)
        if _is_stacked(fd_blocks):
            inherit = j["inherit_stacked"](
                j["gather_stacked"](fd_blocks, e_star), shard
            )
        else:
            inh = [
                j["inherit_block"](j["gather_rows"](fd_blocks[c], e_star))
                for c in range(C)
            ]
            inherit = torch.cat(inh)[:n]
        pos, pos_table, any_next = j["frontier_next"](
            cnt, pos, pos_table, r, s_star, found, inherit, frozen,
            prev_next,
        )
        alive = bool(host_read(any_next.item))
        r += 1
        steps += 1

    if stats is not None:
        stats["round_steps"] = stats.get("round_steps", 0) + steps
        stats["bisect_iters"] = max(1, (s_cap + 1).bit_length())
    if carry is not None:
        carry.pos_table = pos_table
        carry.cnt_prev = cnt
    return j["frontier_fin"](state, pos_table)


def run_wide_fame(cfg: DagConfig, state: DagState, la_blocks, fd_blocks,
                  C: int, stats=None, complete: bool = True,
                  shard=None) -> DagState:
    """Blocked host-driven fame voting (twin of the fused
    ``decide_fame_block_impl``).  Round indices into the witness/fame
    tables are window rows (i_abs - r_off); witness seqs are window-
    local to match the blocked coordinates.

    ``complete=False`` (mid-stream): decisions are gated to rounds
    whose witness set is final (every chain head's round >= i), so a
    late witness can never reopen a decided round and the stream's
    output is the whole-DAG batch's whatever the batch boundaries.
    ``shard``: as in ``run_wide_coords``."""
    j = _jits(cfg, C)
    w = j["width"]
    n = cfg.n
    offs = _block_offs(C, w, shard) if _is_stacked(la_blocks) else None
    lcr, max_round, r_off = (int(v) for v in host_read(torch.stack(
        [state.lcr, state.max_round, state.r_off]).tolist))
    hi = max_round
    if not complete:
        hi = min(hi, int(host_read(j["head_round_min"](state).item)) + 1)
    famous = state.famous.clone()
    for i_abs in range(max(lcr + 1, r_off), hi):
        i = i_abs - r_off
        if i >= cfg.r_cap:
            break
        ws_i, valid_i = j["fame_wits"](state, i)
        seqw_i = j["wit_seq_loc"](state.seq, state.s_off, ws_i)
        famous_i = famous[i].clone()

        ws_1, valid_1 = j["fame_wits"](state, i + 1)
        if _is_stacked(la_blocks):
            votes = j["votes0_stacked"](
                j["gather_stacked"](la_blocks, ws_1), seqw_i,
                offs, valid_1, valid_i, shard,
            )
        else:
            votes = torch.cat(
                [
                    j["votes0_block"](
                        j["gather_rows"](la_blocks[c], ws_1), seqw_i,
                        c * w, valid_1, valid_i,
                    )
                    for c in range(C)
                ],
                dim=1,
            )[:, :n]

        und_any = bool(host_read(
            ((famous_i == FAME_UNDEFINED) & valid_i).any().item))
        d = 2
        while und_any and i_abs + d <= max_round:
            ws_j, valid_j = j["fame_wits"](state, i + d)
            ws_p, valid_p = j["fame_wits"](state, i + d - 1)
            law = _gather_all(j, C, la_blocks, ws_j)
            fdw = _gather_all(j, C, fd_blocks, ws_p)
            cnt_ab = _ss_all(j, C, w, law, fdw, n, shard)
            mb_j = state.mbit[sanitize(ws_j, cfg.e_cap).long()]
            votes, famous_i, und = j["fame_tally"](
                cnt_ab, valid_j, valid_p, valid_i, votes, famous_i, mb_j, d,
            )
            und_any = bool(host_read(und.item))
            d += 1
        if stats is not None:
            # rounds-to-fame latency: the voting distance at which round
            # i's witnesses were all decided (BASELINE's north-star
            # metric); None marks "ran out of voting rounds"
            stats.setdefault("fame_decision_distance", {})[i_abs] = (
                d - 1 if not und_any else None
            )
            stats["fame_vote_steps"] = stats.get("fame_vote_steps", 0) \
                + (d - 2)
        famous = j["fame_write"](famous, famous_i, i)
    state = state._replace(famous=famous)
    return state._replace(lcr=j["fame_fin"](state, famous))


def run_wide_order(cfg: DagConfig, state: DagState, la_blocks, fd_blocks,
                   C: int, stats=None,
                   r_lo_abs: Optional[int] = None,
                   r_hi_abs: Optional[int] = None,
                   shard=None) -> DagState:
    """Blocked host-driven round-received + median timestamps (twin of
    the fused ``decide_order_impl``).

    ``r_lo_abs``/``r_hi_abs`` restrict the round-received scan to the
    absolute rounds decided since the last call (windowed streaming):
    later-arriving events can never be received in an earlier-decided
    round.  Default: all window rows (the batch path).  The median pass
    streams only the slot range holding newly-received rows.  ``shard``:
    as in ``run_wide_coords``."""
    j = _jits(cfg, C)
    w = j["width"]
    n, e1 = cfg.n, cfg.e_cap + 1
    r_off = int(host_read(state.r_off.item))
    lo_r = 0 if r_lo_abs is None else max(0, r_lo_abs - r_off)
    hi_r = cfg.r_cap if r_hi_abs is None else min(
        cfg.r_cap, r_hi_abs - r_off + 1
    )
    seqw, fam, decided, has_w, fam_cnt, und = j["order_prep"](state)

    rr = state.rr
    stacked = _is_stacked(fd_blocks)
    offs = _block_offs(C, w, shard) if stacked else None
    dev = rr.device
    for i in range(lo_r, hi_r):
        if stacked:
            c = j["sees_stacked"](fd_blocks, seqw[i], fam[i], offs, shard)
        else:
            c = torch.zeros((e1,), dtype=I32, device=dev)
            for blk in range(C):
                c = j["sees_partial_block"](
                    fd_blocks[blk], seqw[i], fam[i], blk * w, c,
                )
        rr = j["order_rr_update"](state, und, decided[i], has_w[i],
                                  fam_cnt[i], i, c, rr)
    newly = und & (rr != -1)
    i_of = torch.clamp(rr - state.r_off, 0, cfg.r_cap - 1)

    # only the slot range holding newly-received rows needs the median
    n_lo, n_hi = (int(v) for v in host_read(torch.stack(
        j["newly_range"](newly)).tolist))
    if n_hi <= n_lo:
        if stats is not None:   # accumulate-only: streaming reuses stats
            stats.setdefault("median_chunks", 0)
            stats.setdefault("median_chunk_rows", j["med_chunk"])
            stats.setdefault("median_rel32", True)
            stats.setdefault("median_bad_rows", 0)
        return state._replace(rr=rr)

    tmin, tmax, div1000 = j["ts_range"](state)
    span = int(host_read((tmax - tmin).item))
    scale = 1000 if (bool(host_read(div1000.item))
                     and span // 1000 < (1 << 31) - 1
                     and span >= (1 << 31) - 1) else 1
    rel32 = span // scale < (1 << 31) - 1
    cts = state.cts.clone()
    chunk = min(j["med_chunk"], e1)
    bad_total = torch.zeros((), dtype=I32, device=dev)
    n_chunks = 0
    for e0 in range(n_lo, n_hi, chunk):
        e0 = min(e0, e1 - chunk)
        i_rows = j["slice_rows"](i_of, e0, chunk)
        new_rows = j["slice_rows"](newly, e0, chunk)
        if stacked:
            fd_rows = j["slice_stacked"](fd_blocks, e0, chunk)
            tv_full, cnt_s, bad_rows = j["med_tv_stacked"](
                state, fd_rows, i_rows, seqw, fam, offs, tmin, scale, rel32,
                shard,
            )
            bad_total = bad_total + (bad_rows & new_rows).sum(dtype=I32)
        else:
            tvs, cnts = [], []
            for blk in range(C):
                fd_rows = j["slice_rows"](fd_blocks[blk], e0, chunk)
                tv_b, cnt_b, bad_b = j["med_tv_block"](
                    state, fd_rows, i_rows, seqw, fam, blk * w, tmin,
                    scale, rel32,
                )
                tvs.append(tv_b)
                cnts.append(cnt_b)
                bad_total = bad_total + (bad_b & new_rows).sum(dtype=I32)
            tv_full = torch.cat(tvs, dim=1)[:, :n]
            cnt_s = sum(cnts[1:], cnts[0])
        cts_rows = j["slice_rows"](cts, e0, chunk)
        upd = j["med_reduce"](tv_full, cnt_s, new_rows, cts_rows, tmin,
                              scale, rel32)
        cts = j["write_rows"](cts, e0, upd)
        n_chunks += 1
    bad = int(host_read(bad_total.item))
    if bad:
        raise AssertionError(
            f"median read {bad} below-window first-descendants for "
            "newly-ordered rows — eviction policy violated "
            "(ops/stream.py margin contract)"
        )
    if stats is not None:
        stats["median_chunks"] = stats.get("median_chunks", 0) + n_chunks
        stats["median_chunk_rows"] = chunk
        stats["median_rel32"] = rel32
        stats["median_bad_rows"] = stats.get("median_bad_rows", 0)
    return state._replace(rr=rr, cts=cts)


def run_wide_pipeline(
    cfg: DagConfig,
    batch: EventBatch,
    state: Optional[DagState] = None,
    fd_mode: str = "fast",
    timings: Optional[dict] = None,
    n_blocks: Optional[int] = None,
    assemble: bool = True,
    stats: Optional[dict] = None,
) -> DagState:
    """Full batch pipeline at wide N: coords -> rounds -> fame -> order,
    on the batch's device.

    ``timings``, if given, receives per-phase wall seconds, each phase
    ended by a device synchronise: the durations of the stages
    ``wide.ingest`` (as "coords"), ``wide.rounds``, ``wide.fame`` and
    ``wide.order`` inside ``wide.pipeline``.  ``assemble=False`` skips
    rebuilding the full [E+1, N] la/fd from their blocks; the returned
    state then has la/fd = None and only consensus-observable fields
    are meaningful."""
    if fd_mode != "fast":
        raise ValueError("wide pipeline supports the 'fast' batch mode")
    C = n_blocks or block_count(cfg)
    if stats is not None:
        stats["n_blocks"] = C
        stats["onehot_partials"] = _use_onehot_partial(cfg)
        stats["levels"] = int(batch.sched.shape[0])

    dev = batch.sp.device
    if state is None:
        state = init_state(cfg, include_coords=False, device=dev)
    if (int(host_read(state.r_off.item)) != 0
            or int(host_read(state.e_off.item)) != 0):
        raise ValueError(
            "run_wide_pipeline is the one-shot batch wrapper; drive "
            "compacted/windowed states through ops.stream.WideStream"
        )
    la_full, fd_full = state.la, state.fd
    if la_full is not None and int(host_read(state.n_events.item)) > 0:
        la_blocks = _split_blocks(cfg, C, la_full, -1)
        fd_blocks = _split_blocks(cfg, C, fd_full, cfg.fd_inf)
    else:
        la_blocks, fd_blocks = _init_blocks(cfg, C, device=dev)
    state = state._replace(la=None, fd=None)
    del la_full, fd_full
    _sync(state.sp)

    with stage("wide.pipeline"):
        with stage("wide.ingest") as coords:
            state, la_blocks, fd_blocks = run_wide_coords(
                cfg, state, batch, la_blocks, fd_blocks, C
            )
            with stage("wide.coords.wait"):
                _sync(state.sp)
        with stage("wide.rounds") as rounds:
            state = run_wide_rounds(cfg, state, la_blocks, fd_blocks, C,
                                    stats)
            _sync(state.sp)
        with stage("wide.fame") as fame:
            state = run_wide_fame(cfg, state, la_blocks, fd_blocks, C,
                                  stats)
            _sync(state.sp)
        with stage("wide.order") as order:
            state = run_wide_order(cfg, state, la_blocks, fd_blocks, C,
                                   stats)
            _sync(state.sp)
    if timings is not None:
        for name, st in (("coords", coords), ("rounds", rounds),
                         ("fame", fame), ("order", order)):
            timings[name] = timings.get(name, 0.0) + st.dur_s
    if assemble:
        state = state._replace(
            la=_assemble_blocks(cfg, la_blocks),
            fd=_assemble_blocks(cfg, fd_blocks),
        )
    return state
