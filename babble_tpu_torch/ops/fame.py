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

The round-serial ``"block"`` form, which the JAX package takes past
``BLOCK_FAME_THRESHOLD``, is not ported yet (ROADMAP.md Queue 1,
item 2).
"""

from __future__ import annotations

import torch

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


def decide_fame_impl(cfg: DagConfig, state: DagState,
                     gate: bool = False) -> DagState:
    """Diagonal-scan DecideFame.  ``gate=True`` applies the witness-set
    finality gate of the live engine (a round may only decide once every
    non-stale chain head has passed it); the batch step runs ungated."""
    n, r_cap, sm = cfg.n, cfg.r_cap, cfg.super_majority
    R = r_cap
    dev = state.wslot.device

    wsl = state.wslot[:R]                              # i32[R, N]
    valid_w = wsl >= 0
    ws = sanitize(wsl, cfg.e_cap).long()
    law = state.la[ws]                                 # [R, N, N]
    fdw = state.fd[ws]                                 # [R, N, N]
    seqw = state.seq[ws]                               # i32[R, N]
    mbw = state.mbit[ws]                               # bool[R, N]

    # law rows of the *next* round, aligned to index r (-1 rows past end)
    law_next = torch.cat(
        [law[1:], torch.full((1, n, n), -1, dtype=law.dtype, device=dev)]
    )
    valid_next = torch.cat(
        [valid_w[1:], torch.zeros((1, n), dtype=torch.bool, device=dev)]
    )

    # ss_next[r, a, b]: witness a of round r+1 strongly sees witness b of round r
    ss_cnt = (law_next[:, :, None, :] >= fdw[:, None, :, :]).sum(-1)
    ss_next = (
        (ss_cnt >= sm) & valid_next[:, :, None] & valid_w[:, None, :]
    ).to(F32)
    tot_next = ss_next.sum(-1)                         # f32[R, N]

    # see_next[r, a, x]: witness a of round r+1 sees witness x of round r
    see_next = (
        (law_next >= seqw[:, None, :])
        & valid_next[:, :, None]
        & valid_w[:, None, :]
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

    # The tallies are exact integers: keep the f32 matmul in full f32
    # (TF32 would keep ~11 mantissa bits and could round a count).
    torch.backends.cuda.matmul.allow_tf32 = False

    # JAX runs the diagonal as a fori_loop with a device-valued bound;
    # here the bound is read once with .item()
    d_max = max(int((state.max_round - torch.clamp(state.lcr, min=-1)).item()), 2)
    votes = see_next
    famous = state.famous[:R].clone()
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

        undecided = (famous == FAME_UNDEFINED) & valid_w & in_window[:, None]
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


def decide_fame_auto_impl(cfg: DagConfig, state: DagState,
                          batch_window: bool = True,
                          gate: bool = False) -> DagState:
    """Static shape-based dispatch between the DecideFame forms."""
    if fame_mode(cfg) == "block":
        raise NotImplementedError(
            f"fame mode 'block' (r_cap*n*n > {BLOCK_FAME_THRESHOLD}) is "
            "not ported yet (ROADMAP.md Queue 1, item 2 'Block fame')"
        )
    return decide_fame_impl(cfg, state, gate)
