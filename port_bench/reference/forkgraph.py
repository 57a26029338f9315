"""Plain PyTorch reference of fork-aware (byzantine) hashgraph consensus
over a whole DAG: fork detection, rounds, witnesses, fame, round
received and consensus timestamps.

The yardstick of ``correct`` for the cells whose configuration names
``"reference": "forkgraph"``.  It imports nothing of the program: it
reads the generated arrays (``gen/byzantine.py``: slots with their
self- and other-parent, creator, branch column ``ebr`` and chain index
``eseq``, timestamps, middle bits, and the common-prefix lengths ``cp``
and chain views ``ce`` the generator assigned) and works the rest out.

Semantics, from the hashgraph paper's definitions as the program states
them (fork-free, they are ``hashgraph.go``'s):

- A creator's branch columns hold its chains, root to tip; chains share
  their common prefix.  ``la[x, b]``: the highest chain-b index among
  x's ancestors; ``fd[x, b]``: the lowest chain-b index among x's
  descendants.
- ``det(x, c)``: x's ancestry holds two events of c neither of which is
  a self-ancestor of the other (two branches of c past their common
  prefix).
- ``see(x, y)``: y is an ancestor of x and not ``det(x, creator(y))``.
- ``strongly_see(x, y)``: at least ``sm = 2n/3 + 1`` creators c have an
  event w with ``see(x, w)`` and ``see(w, y)``.  Along a chain both
  ancestry and detection only grow, so chain b has such a w iff
  ``la[x, b] >= helper[y, b]``, the first chain-b index at or after
  ``fd[y, b]`` and before chain b first detects creator(y)'s fork.
- Rounds: a root is round 0; else the larger parent round, plus one
  when x strongly sees round-pr witnesses of ``sm`` distinct creators.
  A witness is a root or an event above its self-parent's round (a
  forking creator can have one a branch).
- Fame: round i+1 votes ``see``; a round-j witness (j >= i+2) takes, of
  each creator, the first round j-1 witness (insertion order) it
  strongly sees, and decides with ``sm`` of one value, the first such
  witness in insertion order deciding; every n-th round is a coin round.
- Round received: the first decided round above x's where more than
  half of the famous witnesses see x; the consensus timestamp is the
  median (element len/2) of the effective timestamps of each seeing
  witness's oldest self-ancestor to see x, its chain's event at
  ``fd[x, chain]``.  Effective timestamps clamp a claim into
  ``[parents' + 1, parents' + 10 min]``.

``coord_bits``/``ts_bits`` below 32/64 narrow coordinates and relative
timestamps for the control of ``correct``, as in ``hashgraph.py``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .hashgraph import INT64_MAX, _narrow, supermajority

I32 = torch.int32
I64 = torch.int64
TS_CLAMP_WINDOW_NS = 600_000_000_000
#: viewer rows of one strongly-see step ([rows, witnesses, branch
#: columns] booleans: 8 x 1,400 x 2,048 = 23 MiB)
SS_ROWS = 8
RR_ROWS = 2048


def _levels(sp: np.ndarray, op: np.ndarray) -> np.ndarray:
    lv = np.zeros(len(sp), np.int64)
    for x in range(len(sp)):
        p = max(lv[sp[x]] if sp[x] >= 0 else -1,
                lv[op[x]] if op[x] >= 0 else -1)
        lv[x] = p + 1
    return lv


def consensus(dag, device="cpu", coord_bits: int = 32,
              ts_bits: int = 64) -> Dict[str, np.ndarray]:
    """Whole-DAG fork-aware consensus.  ``dag``: the generator's
    ``(sizes, arrays)`` (``n_events`` real slots in topological order).  Returns numpy
    arrays over the events: ``round``, ``witness``, ``det`` (bool
    ``[E, n]``), ``fame`` (-1 not a witness, 0 undecided, 1 famous, 2
    not), ``rr`` and ``cts``."""
    sizes, arrays = dag
    n, k = int(sizes["n"]), int(sizes["k"])
    dev = torch.device(device)
    E = int(arrays["n_events"])
    B = n * k
    sm = supermajority(n)
    inf = torch.iinfo(I32).max if coord_bits >= 32 else (
        (1 << (coord_bits - 1)) - 1)

    def t(name, dtype):
        a = np.ascontiguousarray(np.asarray(arrays[name])[:E])
        return torch.as_tensor(a, device=dev).to(dtype)

    sp_np = np.asarray(arrays["sp"])[:E].astype(np.int64)
    op_np = np.asarray(arrays["op"])[:E].astype(np.int64)
    sp, op = t("sp", I64), t("op", I64)
    spE = torch.where(sp < 0, E, sp)
    opE = torch.where(op < 0, E, op)
    br, cr = t("ebr", I64), t("ecr", I64)
    q = t("eseq", I64)
    qc = _narrow(q, coord_bits).to(I32)
    mbit = t("mbit", torch.bool)
    cp = torch.as_tensor(np.asarray(arrays["cp"]), device=dev).to(I64)
    ce = torch.as_tensor(np.asarray(arrays["ce"]), device=dev).to(I64)
    cnt = torch.as_tensor(np.asarray(arrays["cnt"]), device=dev).to(I64)
    rows = torch.arange(E, device=dev)
    lv = _levels(sp_np, op_np)
    order_np = np.argsort(lv, kind="stable")
    counts = np.bincount(lv)
    ends = np.cumsum(counts)
    slices = [(int(e - c), int(e)) for c, e in zip(counts, ends) if c]
    order = torch.as_tensor(order_np, device=dev)

    # the columns each event sits on: its own, and every sibling chain
    # that shares it as common prefix
    cols = cr[:, None] * k + torch.arange(k, device=dev)[None, :]     # [E, k]
    on = (cols == br[:, None]) | (q[:, None] < cp[br[:, None], cols])

    # ---- effective timestamps (topological order, level by level) ----
    eff = torch.cat([t("ts", I64), torch.full((1,), -1, dtype=I64,
                                               device=dev)])
    for a, b in slices:
        X = order[a:b]
        ref = torch.maximum(eff[spE[X]], eff[opE[X]])
        eff[X] = torch.where(ref >= 0, torch.minimum(
            torch.maximum(eff[X], ref + 1), ref + TS_CLAMP_WINDOW_NS), eff[X])
    ts = eff[:E]
    ts_base = ts.min() if E else ts.new_zeros(())
    if ts_bits < 64:
        ts = _narrow(ts - ts_base, ts_bits)

    # ---- coordinates over branch columns ----
    la = torch.full((E + 1, B), -1, dtype=I32, device=dev)
    for a, b in slices:
        X = order[a:b]
        la[X] = torch.maximum(la[spE[X]], la[opE[X]])
        for j in range(k):
            m = on[X, j]
            Xj, cj = X[m], cols[X[m], j]
            la[Xj, cj] = torch.maximum(la[Xj, cj], qc[Xj])
    fd = torch.full((E + 1, B), inf, dtype=I32, device=dev)
    for j in range(k):
        m = on[:, j]
        fd[rows[m], cols[m, j]] = qc[m]
    for a, b in reversed(slices):
        X = order[a:b]
        X = X[(sp[X] >= 0) | (op[X] >= 0)]
        if X.numel():
            idx = torch.cat([spE[X], opE[X]])
            fd.scatter_reduce_(0, idx[:, None].expand(-1, B),
                               fd[X].repeat(2, 1), "amin")
    fd[E] = inf

    # ---- fork detection: two chains of c both past their common prefix
    det = torch.zeros((E + 1, n), dtype=torch.bool, device=dev)
    for j1 in range(k):
        for j2 in range(j1 + 1, k):
            c1 = torch.arange(n, device=dev) * k + j1
            c2 = torch.arange(n, device=dev) * k + j2
            used = (cnt[c1] > 0) & (cnt[c2] > 0)
            d = _narrow(cp[c1, c2], coord_bits).to(I32)
            det |= used[None, :] & (la[:, c1] >= d) & (la[:, c2] >= d)
    det[E] = False

    # first chain-b index that detects creator c's fork (INF if none)
    S1 = ce.shape[1]
    pos_ok = torch.arange(S1, device=dev)[None, :] < cnt[:, None]    # [B, S1]
    slot = torch.where(pos_ok & (ce >= 0), ce, E)
    first_det = torch.full((B, n), inf, dtype=I32, device=dev)
    for b0 in range(0, B, 64):
        dd = det[slot[b0:b0 + 64]]                                   # [b, S1, n]
        hit = dd.any(1)
        first = torch.argmax(dd.to(torch.int8), dim=1).to(I32)
        first_det[b0:b0 + 64] = torch.where(hit, _narrow(
            first.to(I64), coord_bits).to(I32), inf)
    fdet_y = first_det.T[cr]                                         # [E, B]
    helper = torch.where(fd[:E] < fdet_y, fd[:E], inf)

    def ss_count(xs, ws):
        """[|xs|, |ws|]: distinct creators through which xs strongly
        sees ws."""
        hw = helper[ws]
        out = torch.empty((xs.numel(), ws.numel()), dtype=I32, device=dev)
        for a0 in range(0, xs.numel(), SS_ROWS):
            xa = xs[a0:a0 + SS_ROWS]
            ok = la[xa][:, None, :] >= hw[None, :, :]                # [a, w, B]
            per = ok.view(xa.numel(), ws.numel(), n, k).any(-1)
            per &= ~det[xa][:, None, :]
            out[a0:a0 + SS_ROWS] = per.sum(-1, dtype=I32)
        return out

    def per_creator(flags, ws):
        """[A, |ws|] flags -> distinct creators flagged, per row."""
        c = torch.zeros((flags.shape[0], n), dtype=torch.bool, device=dev)
        c.index_put_((torch.arange(flags.shape[0], device=dev)[:, None]
                      .expand_as(flags)[flags], cr[ws][None, :]
                      .expand_as(flags)[flags]),
                     torch.ones((), dtype=torch.bool, device=dev))
        return c.sum(1)

    # ---- rounds ----
    rnd = torch.full((E + 1,), -1, dtype=I64, device=dev)
    witness = torch.zeros((E,), dtype=torch.bool, device=dev)
    wits: List[List[torch.Tensor]] = []
    for a, b in slices:
        X = order[a:b]
        root = (sp[X] < 0) & (op[X] < 0)
        pr = torch.where(root, 0, torch.maximum(rnd[spE[X]], rnd[opE[X]]))
        rX = pr.clone()
        for r in torch.unique(pr[~root]).tolist():
            if r >= len(wits) or not wits[r]:
                continue
            g = (pr == r) & ~root
            W = torch.cat(wits[r])
            hits = per_creator(ss_count(X[g], W) >= sm, W)
            rX[g] = r + (hits >= sm).to(I64)
        rnd[X] = rX
        wX = (sp[X] < 0) | (rX > rnd[spE[X]])
        witness[X] = wX
        for r in torch.unique(rX[wX]).tolist():
            while len(wits) <= r:
                wits.append([])
            wits[r].append(X[wX & (rX == r)])
    rnd = rnd[:E]
    wits_s = [torch.sort(torch.cat(w)).values if w else
              torch.zeros(0, dtype=I64, device=dev) for w in wits]

    def see(ys, xs):
        """[|ys|, |xs|]: ys see xs."""
        return ((la[ys][:, br[xs]] >= qc[xs][None, :])
                & ~det[ys][:, cr[xs]])

    # ---- fame ----
    R = len(wits_s)
    fame = torch.full((E,), -1, dtype=torch.int8, device=dev)
    fame[witness] = 0
    memo: Dict[int, torch.Tensor] = {}

    def first_per_creator(j):
        """[|W_j|, |W_j-1|]: of each creator, the first round j-1 witness
        (insertion order) a round-j witness strongly sees."""
        if j not in memo:
            W, P = wits_s[j], wits_s[j - 1]
            ss = ss_count(W, P) >= sm
            keep = ss.clone()
            same = cr[P][:, None] == cr[P][None, :]
            earlier = torch.triu(same, diagonal=1)    # [p', p]: p' < p
            blocked = (ss.to(torch.float32) @ earlier.to(torch.float32)) > 0
            memo[j] = keep & ~blocked
        return memo[j]

    for i in range(R - 1):
        Wi = wits_s[i]
        if Wi.numel() == 0:
            continue
        und = torch.ones((Wi.numel(),), dtype=torch.bool, device=dev)
        fame_i = torch.zeros((Wi.numel(),), dtype=torch.int8, device=dev)
        votes = None
        for j in range(i + 1, R):
            if not bool(und.any()):
                break
            Wj = wits_s[j]
            if j - i == 1:
                votes = see(Wj, Wi)
                continue
            use = first_per_creator(j).to(torch.float32)
            yays = (use @ votes.to(torch.float32)).to(I32)
            nays = use.sum(1, dtype=I32)[:, None] - yays
            v = yays >= nays
            tally = torch.maximum(yays, nays)
            if (j - i) % n:
                dec = (tally >= sm) & und[None, :]
                hit = dec.any(0)
                first = torch.argmax(dec.to(torch.int8), dim=0)
                val = v[first, torch.arange(Wi.numel(), device=dev)]
                fame_i = torch.where(hit, torch.where(val, 1, 2).to(
                    torch.int8), fame_i)
                und &= ~hit
                votes = v
            else:
                votes = torch.where(tally >= sm, v, mbit[Wj][:, None])
        fame[Wi] = fame_i

    # ---- round received and consensus timestamps ----
    ts_pad = torch.cat([ts, ts.new_zeros(1)])
    rr = torch.full((E,), -1, dtype=I64, device=dev)
    cts = torch.zeros((E,), dtype=I64, device=dev)
    s_hi = S1 - 1
    for i in range(R):
        W = wits_s[i]
        if W.numel() == 0 or bool((fame[W] == 0).any()):
            continue
        F = W[fame[W] == 1]
        ce_F = ce[br[F]]
        cand = torch.nonzero((rr < 0) & (rnd < i)).flatten()
        for c0 in range(0, cand.numel(), RR_ROWS):
            x = cand[c0:c0 + RR_ROWS]
            S = see(F, x).T                                          # [x, F]
            c = S.sum(1)
            got = c > F.numel() // 2
            if not bool(got.any()):
                continue
            x, S, c = x[got], S[got], c[got]
            qx = fd[x][:, br[F]].to(I64).clamp(0, s_hi)
            slots = ce_F[torch.arange(F.numel(), device=dev)[None, :], qx]
            tsw = ts_pad[torch.where(slots >= 0, slots, E)]
            tsw = torch.where(S, tsw, INT64_MAX)
            med = torch.sort(tsw, dim=1).values
            cts[x] = med[torch.arange(x.numel(), device=dev), c // 2] + (
                ts_base if ts_bits < 64 else 0)
            rr[x] = i

    return {
        "round": rnd.to(I32).cpu().numpy(),
        "witness": witness.cpu().numpy(),
        "det": det[:E].cpu().numpy(),
        "fame": fame.cpu().numpy(),
        "rr": rr.to(I32).cpu().numpy(),
        "cts": cts.cpu().numpy(),
    }
