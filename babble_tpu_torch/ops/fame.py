"""DecideFame: virtual voting as a diagonal vote scan, in torch.

The port's twin of the JAX package's ``ops/fame.py`` diagonal form
(reference hashgraph.go:598-664):

- Witness tensors are creator-indexed: ``law/fdw[R, N, N]`` gather the
  coordinate rows of every round's witnesses once.
- ``ss_next[r, a, b]`` (round-(r+1) witness a strongly sees round-r
  witness b) and ``see_next[r, a, x]`` (direct votes at distance 1) are
  precomputed compare-counts.
- The vote recursion runs over the diagonal d = j - i: at step d every
  undecided round i is voted on by round i+d at once.  The tally
      yays[i, y, x] = sum_w ss[i+d-1, y, w] * votes[i, w, x]
  is a batched (R, N, N) @ (R, N, N) f32 matmul; the counts are exact
  integers (N < 2^24).
- Normal rounds (d % N != 0) decide at a supermajority tally; coin rounds
  flip undecided votes on the middle bit of the voter's hash.

Past ``BLOCK_FAME_THRESHOLD`` elements of [R, N, N] working set the
round-serial ``"block"`` form takes over (``decide_fame_block_impl``):
rounds are voted one at a time, each over consecutive-round witness
pairs, so nothing of shape [R, N, N] exists.

Column shards (``parallel/sharded.py``): with an ``axis``
(``parallel.collectives.ColumnShard``) la/fd hold the columns
``[axis.lo, axis.hi)``.  The strongly-see counts are partials over
those columns summed over the axis; the votes are column-local in the
voted-on witness x (``votes[.., w, x]`` reads la column x), so each rank
decides the fame of its own witness columns, and the decisions are
gathered over the axis before the lcr reduction.
"""

from __future__ import annotations

import torch

from ..obs.spans import host_read
from .ss import ss_counts, ss_counts_compare
from .state import (
    FAME_FALSE,
    FAME_TRUE,
    FAME_UNDEFINED,
    DagConfig,
    DagState,
    I32,
    head_round_min_math,
    repack_round_bits,
    sanitize,
)

F32 = torch.float32

# diagonal-scan working-set bound (elements of [R, N, N]) above which the
# JAX package takes the round-serial block form (the same constant)
BLOCK_FAME_THRESHOLD = 1 << 28


# elements of the [Rc, N, N, N] compare the diagonal form's strongly-see
# counts materialise at once (XLA fuses the compare into its reduction;
# eager torch does not): 256 MB of bools
SS_NEXT_CHUNK_ELEMS = 1 << 28


def _ss_next_counts(law_next: torch.Tensor,
                    fdw: torch.Tensor) -> torch.Tensor:
    """cnt[r, a, b] = sum_k [law_next[r, a, k] >= fdw[r, b, k]] (i32), in
    chunks of rounds whose compare stays within ``SS_NEXT_CHUNK_ELEMS``;
    where one round alone passes it (N = 1,024 in BASELINE config 3),
    round by round through ``ss_counts_compare``'s row chunks."""
    R, N, K = law_next.shape
    rc = SS_NEXT_CHUNK_ELEMS // max(1, N * N * K)
    if rc == 0:
        return torch.stack([ss_counts_compare(law_next[r], fdw[r])
                            for r in range(R)])
    return torch.cat([
        (law_next[r0:r0 + rc, :, None, :] >= fdw[r0:r0 + rc, None, :, :])
        .sum(-1, dtype=I32) for r0 in range(0, R, rc)
    ])


def _cols(axis, n: int) -> slice:
    """The columns of la/fd this rank holds (all without an axis)."""
    return slice(0, n) if axis is None else slice(axis.lo, axis.hi)


def decide_fame_impl(cfg: DagConfig, state: DagState,
                     gate: bool = False, axis=None) -> DagState:
    """Diagonal-scan DecideFame.  ``gate=True`` applies the witness-set
    finality gate of the live engine (a round may only decide once every
    non-stale chain head has passed it); the batch step runs ungated.
    ``axis``: la/fd hold its columns (module docstring)."""
    n, r_cap, sm = cfg.n, cfg.r_cap, cfg.super_majority
    R = r_cap
    dev = state.wslot.device
    xl = _cols(axis, n)

    wsl = state.wslot[:R]                              # i32[R, N]
    valid_w = wsl >= 0
    ws = sanitize(wsl, cfg.e_cap).long()
    law = state.la[ws]                                 # [R, N, N]
    fdw = state.fd[ws]                                 # [R, N, N]
    seqw = state.seq[ws]                               # i32[R, N]
    mbw = state.mbit[ws]                               # bool[R, N]

    # law rows of the *next* round, aligned to index r (-1 rows past end)
    law_next = torch.cat(
        [law[1:], torch.full((1,) + law.shape[1:], -1, dtype=law.dtype,
                             device=dev)]
    )
    valid_next = torch.cat(
        [valid_w[1:], torch.zeros((1, n), dtype=torch.bool, device=dev)]
    )

    # ss_next[r, a, b]: witness a of round r+1 strongly sees witness b of round r
    ss_cnt = _ss_next_counts(law_next, fdw)
    if axis is not None:
        ss_cnt = axis.count("fame_diag", ss_cnt, fdw.shape[-1])
    ss_next = (
        (ss_cnt >= sm) & valid_next[:, :, None] & valid_w[:, None, :]
    ).to(F32)
    tot_next = ss_next.sum(-1)                         # f32[R, N]

    # see_next[r, a, x]: witness a of round r+1 sees witness x of round r
    # (x over this rank's columns)
    see_next = (
        (law_next >= seqw[:, None, xl])
        & valid_next[:, :, None]
        & valid_w[:, None, xl]
    ).to(F32)

    # zero-padded doubles so the slice at offset d stays in range
    ss_pad = torch.cat([ss_next, torch.zeros_like(ss_next)])    # [2R, N, N]
    tot_pad = torch.cat([tot_next, torch.zeros_like(tot_next)])
    mb_pad = torch.cat([mbw, torch.zeros_like(mbw)])

    # table row i holds absolute round i + r_off (rolling round window)
    i_idx = torch.arange(R, dtype=I32, device=dev) + state.r_off
    in_window = (i_idx > state.lcr) & (i_idx < state.max_round)
    if gate:
        in_window = in_window & (i_idx <= head_round_min_math(cfg, state))

    # The tallies are exact integers whatever the process's matmul
    # precision: the operands are 0/1 (exact in TF32 and bf16 too) and
    # each sum, at most N < 2^24, accumulates exactly in f32.

    # JAX runs the diagonal as a fori_loop with a device-valued bound;
    # here the bound is read once with .item()
    d_max = max(int(host_read(
        (state.max_round - torch.clamp(state.lcr, min=-1)).item)), 2)
    votes = see_next
    famous = state.famous[:R, xl].clone()
    valid_x = valid_w[:, xl]
    for d in range(2, d_max + 1):
        # voting round j = i + d exists only while j <= max_round
        can_vote = (i_idx + d) <= state.max_round                   # [R]
        # lax.dynamic_slice clamps its start so the window fits
        s1, s0 = min(d - 1, R), min(d, R)
        ss_d = ss_pad[s1:s1 + R]
        tot_d = tot_pad[s1:s1 + R]
        mb_d = mb_pad[s0:s0 + R]

        yays = torch.bmm(ss_d, votes)
        nays = tot_d[:, :, None] - yays
        v = yays >= nays
        t = torch.maximum(yays, nays)
        strong = t >= sm                                            # [R, N, N]

        undecided = (famous == FAME_UNDEFINED) & valid_x & in_window[:, None]
        # coin-round period = number of real participants (hashgraph.go:643)
        normal = (d % cfg.active_n) != 0

        deciding = strong & can_vote[:, None, None] if normal \
            else torch.zeros_like(strong)
        decide_x = deciding.any(dim=1)                              # [R, N]
        v_star = (deciding & v).any(dim=1)                          # agree (proof in oracle)
        famous = torch.where(
            undecided & decide_x,
            torch.where(v_star, FAME_TRUE, FAME_FALSE).to(torch.int8),
            famous,
        )

        new_votes = v if normal else torch.where(strong, v, mb_d[:, :, None])
        votes = torch.where(can_vote[:, None, None], new_votes.to(F32), votes)

    if axis is not None:
        famous = axis.gather(famous, 1)
    # advance last consensus round: highest window round with all
    # witnesses decided
    decided_round = ((~valid_w) | (famous != FAME_UNDEFINED)).all(dim=1)
    has_w = valid_w.any(dim=1)
    cand = _lcr_candidates(state, i_idx, in_window, decided_round, has_w,
                           gate)
    new_lcr = torch.where(cand, i_idx, -1).max()
    lcr = torch.maximum(state.lcr, new_lcr)

    famous_out = state.famous.clone()
    famous_out[:R] = famous
    # fame rewrote the famous table: refresh the packed bitplanes
    return repack_round_bits(
        cfg, state._replace(famous=famous_out, lcr=lcr)
    )


def _lcr_candidates(state, i_idx, in_window, decided_round, has_w,
                    gate: bool):
    """Rounds lcr may advance to.  Ungated (reference semantics,
    hashgraph.go:654-673): every decided in-window round.  Gated (live
    semantics): the contiguous decided prefix only."""
    if not gate:
        return in_window & decided_round & has_w
    passing = in_window & decided_round
    fail = (i_idx > state.lcr) & ~passing
    first_fail = torch.where(fail, i_idx, torch.iinfo(I32).max).min()
    return passing & has_w & (i_idx < first_fail)




def fame_mode(cfg: DagConfig) -> str:
    """Static dispatch: the diagonal scan precomputes [R, N, N] witness
    tensors, so past ~1 GB of working set the block form takes over."""
    return "block" if cfg.r_cap * cfg.n * cfg.n > BLOCK_FAME_THRESHOLD \
        else "diag"


def decide_fame_block_impl(cfg: DagConfig, state: DagState,
                           batch_window: bool = True,
                           gate: bool = False, axis=None) -> DagState:
    """Memory-blocked DecideFame (the JAX package's block form): the same
    decisions as ``decide_fame_impl`` with nothing of shape [R, N, N].

    The vote recursion for round i reads only witness coordinates of
    rounds i..max_round, never another round's fame, so rounds are
    voted one after the other, each over the strongly-see matrices of
    consecutive-round witness pairs (``ss.ss_counts``).  Voting for a
    round stops once its witnesses are all decided; decisions are
    sticky, so the result equals the diagonal scan's.

    JAX runs the rounds as a ``fori_loop`` and each round's voting as a
    ``while_loop`` whose condition is a device value; here both are
    Python loops, with the bounds read once and one ``.item()`` per
    voting step.  ``batch_window`` asserts the all-offsets-zero state the
    one-hot count needs; pass False on rolled-window (live) states."""
    R = cfg.r_cap
    lo = torch.clamp(state.lcr + 1 - state.r_off, 0, R)
    hi_abs = state.max_round
    if gate:
        # witness-set finality gate: only rounds every chain head has
        # passed may decide (int32 arithmetic, as in JAX)
        hi_abs = torch.minimum(hi_abs, head_round_min_math(cfg, state) + 1)
    hi = torch.clamp(hi_abs - state.r_off, 0, R)
    lo, hi, max_round, r_off = (int(v) for v in host_read(torch.stack(
        [lo, hi, state.max_round, state.r_off]).tolist))

    famous_tab = state.famous.clone()

    def undecided(famous_i, valid_i):
        und = ((famous_i == FAME_UNDEFINED) & valid_i).any()
        return bool(host_read((und if axis is None else axis.max(und)).item))

    for i in range(lo, hi):
        i_abs = i + r_off
        votes, famous_i, valid_i = fame_round_init(cfg, state, i, famous_tab,
                                                   axis)
        d = 2
        while i_abs + d <= max_round and undecided(famous_i, valid_i):
            votes, famous_i = fame_vote_math(
                cfg, state, i, d, votes, famous_i, valid_i, batch_window,
                axis,
            )
            d += 1
        famous_tab[i] = famous_i if axis is None \
            else axis.gather(famous_i, 0)
    return repack_round_bits(cfg, state._replace(
        famous=famous_tab,
        lcr=fame_advance_lcr(cfg, state, famous_tab, gate),
    ))


def fame_round_init(cfg: DagConfig, state: DagState, i: int, famous_tab,
                    axis=None):
    """Per-round voting setup: d=1 direct see votes by round i+1
    witnesses (creator-indexed columns, as in the diagonal scan's
    see_next).  Returns (votes0, famous_i, valid_i); with ``axis``, over
    its witness columns x.  la/fd then hold those columns."""
    e_cap = cfg.e_cap
    xl = _cols(axis, cfg.n)
    ws_i = _wrow(state.wslot, i)[xl]
    valid_i = ws_i >= 0
    seqw_i = state.seq[sanitize(ws_i, e_cap).long()]
    famous_i = _wrow(famous_tab, i)[xl]

    ws_1 = _wrow(state.wslot, i + 1)
    valid_1 = ws_1 >= 0
    law_1 = state.la[sanitize(ws_1, e_cap).long()]
    votes0 = (
        (law_1 >= seqw_i[None, :]) & valid_1[:, None] & valid_i[None, :]
    ).to(F32)
    return votes0, famous_i, valid_i


def fame_vote_math(cfg: DagConfig, state: DagState, i: int, d: int, votes,
                   famous_i, valid_i, batch_window: bool, axis=None):
    """One voting step at distance d for round i: round i+d's witnesses
    tally round i+d-1's votes on round i's witnesses.  The tally is an
    f32 matmul of 0/1 operands (JAX: bf16 operands, f32 accumulation),
    exact under any matmul precision: 0 and 1 are exact in TF32 and
    bf16, and the sums stay below 2^24.  Returns (votes', famous_i').
    With ``axis`` the count is a partial over la/fd's columns, summed,
    and the votes cover its witness columns x."""
    sm, e_cap = cfg.super_majority, cfg.e_cap
    jl = i + d                      # window row of voting round j
    ws_j = _wrow(state.wslot, jl)
    valid_j = ws_j >= 0
    wsx_j = sanitize(ws_j, e_cap).long()
    law_j = state.la[wsx_j]
    ws_p = _wrow(state.wslot, jl - 1)
    valid_p = ws_p >= 0
    fdw_p = state.fd[sanitize(ws_p, e_cap).long()]

    cnt = ss_counts(law_j, fdw_p, cfg.s_cap, batch_window)
    if axis is not None:
        cnt = axis.count("fame_block", cnt, fdw_p.shape[-1])
    ss = ((cnt >= sm) & valid_j[:, None] & valid_p[None, :]).to(F32)
    tot = ss.sum(-1)                                    # [N]
    yays = ss @ votes                                   # [N_y, N_x]
    nays = tot[:, None] - yays
    v = yays >= nays
    strong = torch.maximum(yays, nays) >= sm
    normal = (d % cfg.active_n) != 0

    und = (famous_i == FAME_UNDEFINED) & valid_i
    if normal:
        decide_x = strong.any(dim=0)                    # over voters
        v_star = (strong & v).any(dim=0)
        famous_i = torch.where(
            und & decide_x,
            torch.where(v_star, FAME_TRUE, FAME_FALSE).to(torch.int8),
            famous_i,
        )
        return v.to(F32), famous_i
    mb_j = state.mbit[wsx_j]
    return torch.where(strong, v, mb_j[:, None]).to(F32), famous_i


def fame_advance_lcr(cfg: DagConfig, state: DagState, famous_out,
                     gate: bool = False):
    """Advance last consensus round: highest window round with all
    witnesses decided (the same reduction as the diagonal scan)."""
    R = cfg.r_cap
    valid_w = state.wslot[:R] >= 0
    i_idx = torch.arange(R, dtype=I32, device=valid_w.device) + state.r_off
    in_window = (i_idx > state.lcr) & (i_idx < state.max_round)
    if gate:
        in_window = in_window & (i_idx <= head_round_min_math(cfg, state))
    decided_round = (
        (~valid_w) | (famous_out[:R] != FAME_UNDEFINED)
    ).all(dim=1)
    has_w = valid_w.any(dim=1)
    cand = _lcr_candidates(state, i_idx, in_window, decided_round, has_w,
                           gate)
    return torch.maximum(state.lcr, torch.where(cand, i_idx, -1).max())


def _wrow(tab: torch.Tensor, r_loc: int) -> torch.Tensor:
    """Row ``r_loc`` of ``tab`` as ``lax.dynamic_slice_in_dim`` reads it:
    the start is clamped into the table."""
    return tab[min(max(r_loc, 0), tab.shape[0] - 1)]


def decide_fame_auto_impl(cfg: DagConfig, state: DagState,
                          batch_window: bool = True,
                          gate: bool = False, axis=None) -> DagState:
    """Static shape-based dispatch between the two DecideFame forms."""
    if fame_mode(cfg) == "block":
        return decide_fame_block_impl(cfg, state, batch_window, gate, axis)
    return decide_fame_impl(cfg, state, gate, axis)
