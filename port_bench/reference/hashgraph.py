"""Plain PyTorch reference of honest hashgraph consensus over a whole
DAG: rounds, witnesses, fame, round received and consensus timestamps.

The yardstick of ``correct`` for the cells whose configuration names
``"reference": "hashgraph"``.  It imports nothing of the program and
takes nothing the program made: it reads the generated arrays (``sp``,
``op``, ``creator``, ``seq``, ``ts``, ``mbit``, ``levels``) and works
everything out again, on whatever device it is given.

Semantics are those of mpitid/babble ``hashgraph/hashgraph.go``, as the
program states them:

- ``la[x, c]``: the highest seq of creator c among x's ancestors (x
  included), -1 for none; ``fd[x, c]``: the lowest seq of creator c
  among x's descendants (x included), INF for none.
- ``see(w, x) = la[w, creator(x)] >= seq(x)``;
  ``strongly_see(x, w) = |{c : la[x, c] >= fd[w, c]}| >= sm``, with
  ``sm = 2n/3 + 1``.
- DivideRounds: a root is round 0; an event with one parent missing has
  parent round 0, else the larger of its parents' rounds; it goes one
  round up when it strongly sees ``sm`` witnesses of its parent round.
  A witness is a root or an event whose round exceeds its self-parent's.
- DecideFame: round i+1's witnesses vote ``see``; a witness of round
  j >= i+2 collects the votes of the round j-1 witnesses it strongly
  sees and decides with ``sm`` of one value (the first such witness in
  insertion order decides); every n-th round is a coin round (the
  witness's middle bit where no value has ``sm``).  Decisions stick.
- DecideRoundReceived: an event is received in the first round above
  its own whose witnesses are all decided and more than half of whose
  famous witnesses see it (undecided rounds are skipped); its consensus
  timestamp is the median (element len/2 of the sorted list) of the
  timestamps of the oldest self-ancestor of each seeing famous witness
  that sees the event (its creator's chain event at seq
  ``fd[x, creator(w)]``).

Every stage runs level by level over the DAG or round by round, with
whole-tensor operations, so that a 1,024-creator, million-event DAG
takes seconds on one card.  ``coord_bits`` below 32 keeps every
coordinate in a narrower signed integer (seqs wrap, INF is the type's
maximum), and ``ts_bits`` below 64 every timestamp, taken relative to
the DAG's first, in a narrower one: the control of ``correct`` is the
same algorithm one precision below the configuration's (8-bit
coordinates, 32-bit timestamps).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

I32 = torch.int32
I64 = torch.int64
INT64_MAX = int(np.iinfo(np.int64).max)

#: rows of the [rows, n, n] compare that one step of a strongly-see
#: count materialises (64 x 1024 x 1024 booleans = 64 MiB)
SS_ROWS = 64
#: events of one round-received step (their [events, famous] gathers)
RR_ROWS = 4096


def supermajority(n: int) -> int:
    return 2 * n // 3 + 1


def _narrow(v: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 ``v`` as a ``bits``-wide signed integer would hold it
    (wrapped), kept in int64."""
    if bits >= 64:
        return v
    half = 1 << (bits - 1)
    return torch.remainder(v + half, 2 * half) - half


def _ss_count(la_rows: torch.Tensor, fd_rows: torch.Tensor) -> torch.Tensor:
    """cnt[a, b] = |{c : la_rows[a, c] >= fd_rows[b, c]}| (int32)."""
    out = torch.empty((la_rows.shape[0], fd_rows.shape[0]), dtype=I32,
                      device=la_rows.device)
    for a0 in range(0, la_rows.shape[0], SS_ROWS):
        out[a0:a0 + SS_ROWS] = (
            la_rows[a0:a0 + SS_ROWS, None, :] >= fd_rows[None, :, :]
        ).sum(-1, dtype=I32)
    return out


def _level_slices(levels: np.ndarray):
    order = np.argsort(levels, kind="stable")
    counts = np.bincount(levels)
    ends = np.cumsum(counts)
    return order, [(int(e - c), int(e)) for c, e in zip(counts, ends) if c]


def consensus(dag, device="cpu", coord_bits: int = 32,
              ts_bits: int = 64) -> Dict[str, np.ndarray]:
    """Whole-DAG consensus of ``dag`` (slots in topological order).
    Returns numpy arrays over the events: ``round`` (i32), ``witness``
    (bool), ``fame`` (i8: -1 not a witness, 0 undecided, 1 famous, 2
    not famous), ``rr`` (i32, -1 not received) and ``cts`` (i64)."""
    dev = torch.device(device)
    n, E = int(dag.n), int(dag.n_events)
    sm = supermajority(n)
    inf = torch.iinfo(torch.int32).max if coord_bits >= 32 else (
        (1 << (coord_bits - 1)) - 1)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    sp = t(dag.sp, I64)
    op = t(dag.op, I64)
    spE = torch.where(sp < 0, E, sp)     # missing parent -> sentinel row E
    opE = torch.where(op < 0, E, op)
    creator = t(dag.creator, I64)
    seq = t(dag.seq, I64)
    seqc = _narrow(seq, coord_bits).to(I32)
    ts = t(dag.ts, I64)
    ts_base = ts.min() if E else ts.new_zeros(())
    if ts_bits < 64:
        ts = _narrow(ts - ts_base, ts_bits)
    mbit = t(dag.mbit, torch.bool)
    order_np, slices = _level_slices(np.asarray(dag.levels))
    order = t(order_np, I64)
    rows = torch.arange(E, device=dev)

    # ---- coordinates: la forward over levels, fd backward ----
    la = torch.full((E + 1, n), -1, dtype=I32, device=dev)
    for a, b in slices:
        X = order[a:b]
        la[X] = torch.maximum(la[spE[X]], la[opE[X]])
        la[X, creator[X]] = seqc[X]
    fd = torch.full((E + 1, n), inf, dtype=I32, device=dev)
    fd[rows, creator] = seqc
    for a, b in reversed(slices):
        X = order[a:b]
        X = X[(sp[X] >= 0) | (op[X] >= 0)]
        if X.numel() == 0:
            continue
        idx = torch.cat([spE[X], opE[X]])
        src = fd[X].repeat(2, 1)
        fd.scatter_reduce_(0, idx[:, None].expand(-1, n), src, "amin")
    fd[E] = inf

    # ---- rounds and witnesses, level by level ----
    rnd = torch.full((E + 1,), -1, dtype=I64, device=dev)
    witness = torch.zeros((E,), dtype=torch.bool, device=dev)
    wfd: List[torch.Tensor] = []     # round -> [n, n] fd rows by creator
    wok: List[torch.Tensor] = []     # round -> [n] has a witness
    wslot: List[torch.Tensor] = []   # round -> [n] witness slot, -1

    def add_witnesses(W, rW):
        for r in torch.unique(rW).tolist():
            while len(wfd) <= r:
                wfd.append(torch.full((n, n), inf, dtype=I32, device=dev))
                wok.append(torch.zeros((n,), dtype=torch.bool, device=dev))
                wslot.append(torch.full((n,), -1, dtype=I64, device=dev))
            Wr = W[rW == r]
            wfd[r][creator[Wr]] = fd[Wr]
            wok[r][creator[Wr]] = True
            wslot[r][creator[Wr]] = Wr

    for a, b in slices:
        X = order[a:b]
        root = (sp[X] < 0) & (op[X] < 0)
        one = (sp[X] < 0) ^ (op[X] < 0)
        pr = torch.maximum(rnd[spE[X]], rnd[opE[X]])
        pr = torch.where(root | one, 0, pr)
        rX = pr.clone()
        for r in torch.unique(pr[~root]).tolist():
            if r >= len(wfd):
                continue
            g = (pr == r) & ~root
            Xg = X[g]
            ss = _ss_count(la[Xg], wfd[r])
            inc = ((ss >= sm) & wok[r][None, :]).sum(-1) >= sm
            rX[g] = r + inc.to(I64)
        rnd[X] = rX
        wX = (sp[X] < 0) | (rX > rnd[spE[X]])
        witness[X] = wX
        if bool(wX.any()):
            add_witnesses(X[wX], rX[wX])
    rnd = rnd[:E]

    # ---- fame: virtual voting, round pairs (i, j) ----
    R = len(wfd)
    wits = [torch.sort(wslot[r][wok[r]]).values for r in range(R)]
    fame = torch.full((E,), -1, dtype=torch.int8, device=dev)
    fame[witness] = 0
    ss_memo: Dict[int, torch.Tensor] = {}

    def ss_between(j):
        """[|W_j|, |W_j-1|]: W_j's witnesses strongly see W_j-1's."""
        if j not in ss_memo:
            ss_memo[j] = _ss_count(la[wits[j]], fd[wits[j - 1]]) >= sm
        return ss_memo[j]

    for i in range(R - 1):
        Wi = wits[i]
        und = torch.ones((Wi.numel(),), dtype=torch.bool, device=dev)
        fame_i = torch.zeros((Wi.numel(),), dtype=torch.int8, device=dev)
        votes = None
        for j in range(i + 1, R):
            if not bool(und.any()):
                break
            Wj = wits[j]
            if j - i == 1:
                votes = la[Wj][:, creator[Wi]] >= seqc[Wi][None, :]
                continue
            ss = ss_between(j).to(torch.float32)
            yays = (ss @ votes.to(torch.float32)).to(I32)
            nays = ss.sum(1, dtype=I32)[:, None] - yays
            v = yays >= nays
            tally = torch.where(v, yays, nays)
            if (j - i) % n > 0:
                dec = (tally >= sm) & und[None, :]
                hit = dec.any(0)
                first = torch.argmax(dec.to(torch.int8), dim=0)
                val = v[first, torch.arange(Wi.numel(), device=dev)]
                fame_i = torch.where(hit, torch.where(val, 1, 2).to(
                    torch.int8), fame_i)
                und = und & ~hit
                votes = v
            else:
                votes = torch.where(tally >= sm, v, mbit[Wj][:, None])
        fame[Wi] = fame_i

    # ---- round received and consensus timestamps ----
    ce = torch.full((n, int(seq.max()) + 2 if E else 1), E, dtype=I64,
                    device=dev)
    ce[creator, seq] = rows
    ts_pad = torch.cat([ts, ts.new_zeros(1)])
    rr = torch.full((E,), -1, dtype=I64, device=dev)
    cts = torch.zeros((E,), dtype=I64, device=dev)
    s_hi = ce.shape[1] - 1
    for i in range(R):
        fw = fame[wits[i]]
        if wits[i].numel() == 0 or bool((fw == 0).any()):
            continue
        F = wits[i][fw == 1]
        cand = torch.nonzero((rr < 0) & (rnd < i)).flatten()
        if cand.numel() == 0:
            continue
        laF = la[F]
        cF = creator[F]
        for c0 in range(0, cand.numel(), RR_ROWS):
            x = cand[c0:c0 + RR_ROWS]
            S = laF[:, creator[x]].T >= seqc[x][:, None]      # [x, F]
            cnt = S.sum(1)
            got = 2 * cnt > F.numel()
            if not bool(got.any()):
                continue
            x, S, cnt = x[got], S[got], cnt[got]
            q = fd[x][:, cF].to(I64).clamp(0, s_hi)
            tsw = ts_pad[ce[cF[None, :], q]]
            tsw = torch.where(S, tsw, INT64_MAX)
            med = torch.sort(tsw, dim=1).values
            cts[x] = med[torch.arange(x.numel(), device=dev), cnt // 2] + (
                ts_base if ts_bits < 64 else 0)
            rr[x] = i

    return {
        "round": rnd.to(I32).cpu().numpy(),
        "witness": witness.cpu().numpy(),
        "fame": fame.cpu().numpy(),
        "rr": rr.to(I32).cpu().numpy(),
        "cts": cts.cpu().numpy(),
    }
