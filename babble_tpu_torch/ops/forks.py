"""Fork-aware (byzantine-mode) consensus pipeline: the port's copy of the
JAX package's ``ops/forks.py``.

Semantics anchor: ``consensus/byzantine.py`` (the definition-first
oracle).  The column axis is (creator, branch slot): creator i owns K
consecutive columns, branch k of creator i lives at column i*K + k, so a
"per creator" reduction is an OR over K strided column slices.

A branch's chain is its full root->tip path, so chains share prefixes.
``cp[B, B]`` (common-prefix lengths, built on the host) decides
membership: event (b, q) is on chain(b') iff q < cp[b, b'].

- ``la[x, b]``: highest chain-(b) index among x's ancestors.
- fork detection is a pure function of la: creator i's fork pair is
  visible to x iff la reaches past the pair's common prefix on both
  branches.
- ``see(x, y) = la[x, br(y)] >= seq(y) and not det[x, creator(y)]``.
- ``helper[y, b]``: the first chain-(b) index whose event sees y (INF
  when none); strongly-see is the creator count of
  ``la[x, b] >= helper[y, b]``, masked by detection.

That last count is the one piece this module does not write as tensor
code.  The JAX package leaves it to XLA, which fuses the compare into
the reduction; eager torch fuses nothing, and at the 1024-creator
byzantine DAG the unfused ``[E+1, B, N]`` grid is 1.1 TB.  So
``ss_counts`` launches ``csrc/fork_ss.cu`` (a hand-written tiled
compare-count) on CUDA tensors and runs its plain twin
``ss_counts_plain`` (the same formula, chunked so that no temporary
passes ``PLAIN_BUDGET_BYTES``) on CPU tensors.  The call sites hand it
the batch's chain window (``SsWindow``), and where the window's
coordinates fit 15 bits it compares window-relative int16 branch
planes, two creators to a 32-bit word, with the detection mask folded
into the viewer side (``viewer_planes``, ``witness_planes``).

Column shards (``parallel/sharded.py make_sharded_fork_step``): the
pipeline takes an optional ``axis`` (``parallel.collectives
.ColumnShard`` over the B branch columns, whole creators to a rank:
columns are creator-major, so a contiguous B/p range holds the creators
``[lo/k, hi/k)``).  With one, la, fd and helper hold the rank's branch
columns and ``first_det`` its branch rows.  What is column-local and
what is gathered:

- column-local: the la scan (``_la_scan``: own rows and the max over
  parents), the reverse fd scan, ``first_det`` and ``helper`` (rows of
  the rank's branches), fame's votes on its witness columns and the
  see count of round received;
- gathered over the axis inside the pipeline: ``det`` (each rank
  detects forks of its own creators, then every rank needs every
  creator's flag: ``first_det`` reads det at its chains' events for all
  creators), la's columns for the chain-view fd fill (``_fd_chains``
  counts over chain positions and reads every branch column of a
  chain's events), fame's decisions before the lcr reduction, and the
  median's masked timestamp columns before its row sort;
- every strongly-see compare-count (``ss``: the closure's and fame's)
  counts over the rank's creators, with det, the la/helper rows and the
  int16 planes cut to them, then an all-reduce SUM.

Device control: each ``lax.scan`` over the level schedule is a Python
loop over the schedule rows, each ``while_loop`` a Python loop with one
``.item()`` a pass, and the fame ``fori_loop`` runs to ``max_round``,
read once.  Every gather of a possibly missing index goes through
``sanitize`` or a clamp; every scatter of a padding lane lands on a
sentinel row that ``set_sentinel`` restores.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..core.dag import clamp_eff_ts
from ..core.event import Event
from ..membership.quorum import supermajority
from .state import (
    I32, INT32_MAX, INT64_MAX, bucket, fd_reverse_scan_wins, sanitize,
    set_sentinel,
)

I8 = torch.int8
F32 = torch.float32

FAME_UNDEFINED = 0
FAME_TRUE = 1
FAME_FALSE = 2

#: largest temporary the plain compare-count (and ``_fd_chains``) makes
PLAIN_BUDGET_BYTES = 1 << 30


class ForkConfig(NamedTuple):
    n: int          # creators
    k: int          # branch slots per creator (1 = honest)
    e_cap: int
    s_cap: int      # chain-index capacity (root->tip length)
    r_cap: int

    @property
    def b(self) -> int:
        return self.n * self.k

    @property
    def super_majority(self) -> int:
        return supermajority(self.n)


class ForkBatch(NamedTuple):
    """Whole-window arrays built on the host (slots = insertion order),
    as torch tensors on one device.

    ``rseed``/``wseed`` carry the rolling live window: round and witness
    status are functions of an event's fixed ancestry, so values computed
    in an earlier run are final and seed the next one.  Seeds are
    window-local rounds (absolute - r_off); -1 = not yet computed."""

    sp: torch.Tensor       # i32[E+1] self-parent slot, -1 (sentinel row incl.)
    op: torch.Tensor       # i32[E+1]
    ebr: torch.Tensor      # i32[E+1] branch column of event; B = dump
    eseq: torch.Tensor     # i32[E+1] chain index of event; -1 sentinel
    ecr: torch.Tensor      # i32[E+1] creator; N = dump
    ts: torch.Tensor       # i64[E+1]
    mbit: torch.Tensor     # bool[E+1]
    sched: torch.Tensor    # i32[T, Bt] slots by level, -1 pad
    cp: torch.Tensor       # i32[B, B] common-prefix lengths (diag = INF)
    ce: torch.Tensor       # i32[B, S+1] chain view (slots, -1 pad)
    cnt: torch.Tensor      # i32[B] chain lengths (0 for unused branch slots)
    owner: torch.Tensor    # bool[B, S+1] position is owned (assigned) by b
    n_events: torch.Tensor # i32 0-d
    rseed: torch.Tensor    # i32[E+1] seeded window-local round, -1 unknown
    wseed: torch.Tensor    # i8[E+1]  seeded witness trilean (-1/0/1)
    s_off: torch.Tensor    # i32[B] absolute chain index of window position 0


class ForkOut(NamedTuple):
    """Consensus outputs (per event / per witness-branch)."""

    la: torch.Tensor       # i32[E+1, B]
    det: torch.Tensor      # bool[E+1, N]
    fd: torch.Tensor       # i32[E+1, B]
    round: torch.Tensor    # i32[E+1]
    witness: torch.Tensor  # bool[E+1]
    wslot: torch.Tensor    # i32[R+1, B]
    famous: torch.Tensor   # i8[R+1, B]
    rr: torch.Tensor       # i32[E+1]
    cts: torch.Tensor      # i64[E+1]
    max_round: torch.Tensor
    lcr: torch.Tensor


def fork_batch_from_numpy(arrays: dict, device="cuda") -> ForkBatch:
    """A ``ForkBatch`` on ``device`` from host numpy arrays, each copied
    (the tensors never share memory with the arrays)."""
    return ForkBatch(**{
        name: torch.tensor(np.asarray(arrays[name]), device=device)
        for name in ForkBatch._fields
    })


# ----------------------------------------------------------------------
# host: branch assignment + chain views


class ForkBudgetError(ValueError):
    """Creator exceeded its K-1 fork budget (equivocation spam guard)."""


class ParentUnknownError(ValueError):
    """Event references a parent hash outside the window — a missing-
    ancestry case that a deeper resync can heal, as opposed to a
    malformed or forged event (Core.sync classifies insert failures by
    type, not message)."""


@dataclass
class ForkDag:
    """Host index for byzantine mode: assigns branch columns, builds the
    chain views + common-prefix matrix the device code needs."""

    participants: Dict[str, int]
    k: int = 2

    events: List[Event] = field(default_factory=list)
    slot_of: Dict[str, int] = field(default_factory=dict)
    levels: List[int] = field(default_factory=list)
    sp_slot: List[int] = field(default_factory=list)
    op_slot: List[int] = field(default_factory=list)
    ebr: List[int] = field(default_factory=list)
    # per branch column: creator, parent branch col (-1), divergence index,
    # and the slots of OWNED events (the segment past the divergence)
    br_creator: List[int] = field(init=False)
    br_parent: List[int] = field(init=False)
    br_div: List[int] = field(init=False)
    br_events: List[List[int]] = field(init=False)
    br_used: List[bool] = field(init=False)
    _chain_tip: Dict[int, int] = field(default_factory=dict)   # col -> tip slot
    # per-CREATOR slots in insertion order (the gossip Known/diff view)
    cr_events: List[List[int]] = field(init=False)
    # rolling-window seeds (ForkBatch docstring): ABSOLUTE round and
    # witness trilean per slot, -1 until the pipeline computes them;
    # r_off = absolute round of window row 0; evicted = total dropped
    rseed: List[int] = field(default_factory=list)
    wseed: List[int] = field(default_factory=list)
    r_off: int = 0
    evicted: int = 0
    # effective (clamp-enforced) timestamp per slot (core/dag.py
    # clamp_eff_ts), derived at insert from the parents' effective
    # values; the median consumes these, never the signed claims
    eff_ts: List[int] = field(default_factory=list)
    # absolute chain extent per branch (max index + 1) — survives eviction
    br_extent: List[int] = field(init=False)
    # per-CREATOR evicted counts: the gossip vector clock stays absolute
    cr_evicted: List[int] = field(init=False)

    def __post_init__(self):
        n = len(self.participants)
        b = n * self.k
        self.br_creator = [c for c in range(n) for _ in range(self.k)]
        self.br_parent = [-1] * b
        self.br_div = [0] * b
        self.br_events = [[] for _ in range(b)]
        self.br_used = [False] * b
        self.cr_events = [[] for _ in range(n)]
        self.br_extent = [0] * b
        self.cr_evicted = [0] * n

    @property
    def n(self) -> int:
        return len(self.participants)

    @property
    def b(self) -> int:
        return self.n * self.k

    def insert(self, event: Event) -> int:
        x = event.hex()
        if x in self.slot_of:
            raise ValueError("duplicate event")
        cid = self.participants[event.creator]
        sp, op = event.self_parent, event.other_parent
        slot = len(self.events)
        if sp == "" and op == "":
            if event.index != 0:
                raise ValueError("root must have index 0")
            sps = ops = -1
            col = cid * self.k
            if self.br_used[col]:
                raise ValueError("duplicate root (index-0 fork unsupported)")
            self.br_used[col] = True
        else:
            sps = self.slot_of.get(sp, -1)
            ops = self.slot_of.get(op, -1)
            if sps < 0 or ops < 0:
                raise ParentUnknownError("parent not known")
            spe = self.events[sps]
            if spe.creator != event.creator:
                raise ValueError("self-parent has different creator")
            if event.index != spe.index + 1:
                raise ValueError("bad index")
            pcol = self.ebr[sps]
            if self._chain_tip.get(pcol) == sps:
                col = pcol                      # extends the branch tip
            else:
                # fork: claim a fresh branch slot of this creator
                col = -1
                for kk in range(self.k):
                    cand = cid * self.k + kk
                    if not self.br_used[cand]:
                        col = cand
                        break
                if col < 0:
                    raise ForkBudgetError(
                        f"creator {cid} exceeded {self.k - 1} forks"
                    )
                self.br_used[col] = True
                self.br_parent[col] = pcol
                self.br_div[col] = event.index
        self.events.append(event)
        self.slot_of[x] = slot
        event.topological_index = self.evicted + slot
        self.cr_events[cid].append(slot)
        self.sp_slot.append(sps)
        self.op_slot.append(ops)
        self.ebr.append(col)
        self.br_events[col].append(slot)
        self._chain_tip[col] = slot
        self.br_extent[col] = max(self.br_extent[col], event.index + 1)
        self.rseed.append(-1)
        self.wseed.append(-1)
        # per-creator eff-ts clamp; evicted parents contribute nothing
        parent_ref = None
        if sps >= 0:
            parent_ref = self.eff_ts[sps]
        if ops >= 0:
            op_eff = self.eff_ts[ops]
            parent_ref = op_eff if parent_ref is None \
                else max(parent_ref, op_eff)
        self.eff_ts.append(clamp_eff_ts(event.body.timestamp, parent_ref))
        lvl = 0
        if sps >= 0 or ops >= 0:
            lvl = 1 + max(
                self.levels[sps] if sps >= 0 else -1,
                self.levels[ops] if ops >= 0 else -1,
            )
        self.levels.append(lvl)
        return slot

    # ------------------------------------------------------------------

    def evict_prefix(self, k: int, new_r_off: int) -> None:
        """Drop the first k slots (a committed prefix the engine proved
        safe — fork_engine.maybe_compact) and rebase slot references.
        Slot order is insertion order and chain positions ascend with
        slot, so a slot prefix is a chain prefix on every branch; chain
        INDEX values (eseq, cp, la/fd units) are absolute and survive
        unchanged.  Evicted parents become -1: the pipeline treats such
        events as pseudo-roots whose round/witness come from rseed/wseed
        instead of the root rule."""
        if k <= 0:
            self.r_off = new_r_off
            return
        for s in range(k):
            del self.slot_of[self.events[s].hex()]
        self.events = self.events[k:]
        self.levels = self.levels[k:]
        self.rseed = self.rseed[k:]
        self.wseed = self.wseed[k:]
        self.eff_ts = self.eff_ts[k:]

        def remap(v: int) -> int:
            return v - k if v >= k else -1

        self.sp_slot = [remap(v) for v in self.sp_slot[k:]]
        self.op_slot = [remap(v) for v in self.op_slot[k:]]
        self.ebr = self.ebr[k:]
        for h in list(self.slot_of):
            self.slot_of[h] -= k
        self.br_events = [
            [s - k for s in lst if s >= k] for lst in self.br_events
        ]
        for cid, lst in enumerate(self.cr_events):
            kept = [s - k for s in lst if s >= k]
            self.cr_evicted[cid] += len(lst) - len(kept)
            self.cr_events[cid] = kept
        self._chain_tip = {
            col: s - k for col, s in self._chain_tip.items() if s >= k
        }
        self.evicted += k
        self.r_off = new_r_off

    # ------------------------------------------------------------------

    def _chain_slots(self, col: int) -> List[int]:
        """Full root->tip slot list of branch col (inherited prefix +
        owned segment)."""
        segs = []
        c, upto = col, None
        while c >= 0:
            seg = self.br_events[c]
            if upto is not None:
                seg = [s for s in seg if self.events[s].index < upto]
            segs.append(seg)
            upto = self.br_div[c]
            c = self.br_parent[c]
        out: List[int] = []
        for seg in reversed(segs):
            out.extend(seg)
        return out

    def common_prefix(self) -> np.ndarray:
        """cp[b1, b2]: shared chain-prefix length (diag INF-ish)."""
        b = self.b
        cp = np.zeros((b, b), np.int32)

        def path(col):
            p = []
            c = col
            while c >= 0:
                p.append(c)
                c = self.br_parent[c]
            return list(reversed(p))

        paths = [path(c) if self.br_used[c] else [] for c in range(b)]
        # ABSOLUTE chain extents: window lengths would understate
        # divergence fallbacks after prefix eviction
        lens = list(self.br_extent)
        for b1 in range(b):
            if not self.br_used[b1]:
                continue
            for b2 in range(b):
                if not self.br_used[b2]:
                    continue
                if self.br_creator[b1] != self.br_creator[b2]:
                    cp[b1, b2] = 0
                    continue
                if b1 == b2:
                    cp[b1, b2] = INT32_MAX
                    continue
                p1, p2 = paths[b1], paths[b2]
                common = 0
                for a, bb in zip(p1, p2):
                    if a != bb:
                        break
                    common += 1
                # divergence = div of the first differing segment
                d1 = (self.br_div[p1[common]] if common < len(p1)
                      else lens[b1])
                d2 = (self.br_div[p2[common]] if common < len(p2)
                      else lens[b2])
                cp[b1, b2] = min(d1, d2)
        return cp

    def build_arrays(self, cfg: ForkConfig) -> dict:
        """The batch as host numpy arrays (``ForkBatch`` field names)."""
        e1 = cfg.e_cap + 1
        ne = len(self.events)
        assert ne <= cfg.e_cap, "e_cap too small"
        B, s1 = cfg.b, cfg.s_cap + 1

        sp = np.full(e1, -1, np.int32)
        op = np.full(e1, -1, np.int32)
        ebr = np.full(e1, B, np.int32)
        eseq = np.full(e1, -1, np.int32)
        ecr = np.full(e1, cfg.n, np.int32)
        ts = np.zeros(e1, np.int64)
        mbit = np.zeros(e1, bool)
        for s, ev in enumerate(self.events):
            sp[s] = self.sp_slot[s]
            op[s] = self.op_slot[s]
            ebr[s] = self.ebr[s]
            eseq[s] = ev.index
            ecr[s] = self.participants[ev.creator]
            # effective (clamped) timestamps, never the signed claims
            ts[s] = self.eff_ts[s]
            mbit[s] = ev.middle_bit()

        lev = np.asarray(self.levels, np.int64)
        order = np.argsort(lev, kind="stable")
        ulev, starts = np.unique(lev[order], return_index=True)
        bounds = list(starts) + [ne]
        # schedule dims bucketed to powers of two, as the JAX package
        # does (its shape buckets); padding holds -1 slots
        t = bucket(max(len(ulev), 1), 1)
        wid = bucket(
            max(int(np.max(np.diff(bounds))), 1) if len(ulev) else 1, 1
        )
        sched = np.full((t, wid), -1, np.int32)
        for row in range(len(ulev)):
            grp = order[bounds[row] : bounds[row + 1]]
            sched[row, : len(grp)] = grp

        ce = np.full((B, s1), -1, np.int32)
        owner = np.zeros((B, s1), bool)
        cnt = np.zeros(B, np.int32)
        s_off = np.zeros(B, np.int32)
        for col in range(B):
            if not self.br_used[col]:
                continue
            chain = self._chain_slots(col)
            assert len(chain) <= cfg.s_cap, "s_cap too small"
            ce[col, : len(chain)] = chain
            cnt[col] = len(chain)
            # window positions map to absolute chain indexes by a per-
            # branch offset (prefix eviction drops a chain prefix)
            s_off[col] = self.events[chain[0]].index if chain else 0
            for i, s in enumerate(chain):
                owner[col, i] = self.ebr[s] == col

        rseed = np.full(e1, -1, np.int32)
        wseed = np.full(e1, -1, np.int8)
        for s in range(ne):
            if self.rseed[s] >= 0:
                rseed[s] = self.rseed[s] - self.r_off
                wseed[s] = self.wseed[s]
        return dict(
            sp=sp, op=op, ebr=ebr, eseq=eseq, ecr=ecr, ts=ts, mbit=mbit,
            sched=sched, cp=self.common_prefix(), ce=ce, cnt=cnt,
            owner=owner, n_events=np.int32(ne), rseed=rseed, wseed=wseed,
            s_off=s_off,
        )

    def build_batch(self, cfg: ForkConfig, device="cuda") -> ForkBatch:
        return fork_batch_from_numpy(self.build_arrays(cfg), device)


# ----------------------------------------------------------------------
# the strongly-see compare-count: kernels and plain twin


#: the largest k (branch slots per creator) ``csrc/fork_ss.cu`` is
#: instantiated for; the plain twin takes any k
FORK_SS_MAX_K = 8

#: the largest ``s_cap`` whose window-relative coordinates the packed
#: kernel takes: values 0 .. s_cap and the witness's 0x7FFF, 15 bits
FORK_SS_NARROW_S_CAP = 32766

#: the packed kernel's lane range and plane alignment (8 int16 creators,
#: one 16-byte piece)
LANE_MAX = 0x7FFF
PLANE_ALIGN = 8


def _check_ss_args(la_x, det_x, helper_w, k):
    if la_x.dim() != 3 or det_x.dim() != 3 or helper_w.dim() != 3:
        raise ValueError("ss_counts: la_x, det_x and helper_w must be 3-d "
                         "[G, X, B], [G, X, N] and [G, W, B]")
    g, x, b = la_x.shape
    n = det_x.shape[2]
    if k < 1 or n * k != b:
        raise ValueError(f"ss_counts: k={k} with {n} creators does not "
                         f"give {b} branch columns")
    if tuple(det_x.shape[:2]) != (g, x) or helper_w.shape[0] != g \
            or helper_w.shape[2] != b:
        raise ValueError(
            f"ss_counts: shapes la {tuple(la_x.shape)}, det "
            f"{tuple(det_x.shape)}, helper {tuple(helper_w.shape)} disagree")
    if la_x.dtype != I32 or helper_w.dtype != I32 \
            or det_x.dtype not in (torch.bool, torch.uint8):
        raise ValueError("ss_counts: la_x and helper_w must be int32, det_x "
                         "bool or uint8")
    dev = la_x.device
    if det_x.device != dev or helper_w.device != dev:
        raise ValueError("ss_counts: tensors on different devices")


class SsWindow:
    """The chain window one pipeline phase's strongly-see counts read:
    ``s_off`` (i32[B], the batch's absolute chain index of window
    position 0 on each branch column) and ``s_cap``.  ``narrow`` says,
    from ``s_cap`` alone (no device read), whether the packed kernel
    takes the window's coordinates.

    The viewer planes of the last ``(la_x, det_x)`` pair are kept, so
    the closure's rounds, which share ``la`` and ``det``, narrow them
    once: ``la_x`` and ``det_x`` must not change between the calls that
    share a window."""

    def __init__(self, s_off: torch.Tensor, s_cap: int):
        self.s_off = s_off
        self.s_cap = s_cap
        self.narrow = s_cap <= FORK_SS_NARROW_S_CAP
        self._viewer = None

    def viewer(self, la_x, det_x, k: int) -> torch.Tensor:
        got = self._viewer
        if got is None or got[0] is not la_x or got[1] is not det_x \
                or got[2] != k:
            got = (la_x, det_x, k, viewer_planes(la_x, det_x, self.s_off, k))
            self._viewer = got
        return got[3]

    def witness(self, helper_w, k: int) -> torch.Tensor:
        return witness_planes(helper_w, self.s_off, k)


def _planes(rows: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """An int16 ``[G, R, K, Np]`` plane tensor for ``rows`` ``[G, R,
    N*K]``, every entry ``fill`` (Np = N rounded up to PLANE_ALIGN)."""
    g, r, b = rows.shape
    n = b // k
    np_ = -(-n // PLANE_ALIGN) * PLANE_ALIGN
    return torch.full((g, r, k, np_), fill, dtype=torch.int16,
                      device=rows.device)


def _row_step(rows: torch.Tensor) -> int:
    """Rows a chunk, so that a chunk's int32 temporaries stay within
    ``PLAIN_BUDGET_BYTES`` / 8."""
    g, _, b = rows.shape
    return max(1, PLAIN_BUDGET_BYTES // 8 // max(1, g * b * 4))


def viewer_planes(la_x: torch.Tensor, det_x: torch.Tensor,
                  s_off: torch.Tensor, k: int) -> torch.Tensor:
    """The viewer side as the packed kernel reads it: int16 ``[G, X, K,
    Np]`` branch planes (``la_x`` column ``c*k + kk`` at plane ``kk``,
    creator ``c``), window-relative and with NOT det folded in:

        v = 0                                   where det[c] or la < s_off
        v = min(la - s_off, LANE_MAX - 2) + 1   elsewhere

    and 0 in the pad creators.  Exactness (with ``witness_planes``):
    the batch puts every in-window chain index, so every ``la`` value at
    or past ``s_off`` and every finite ``fd`` (hence ``helper``) value,
    in ``[s_off, s_off + s_cap - 1]`` on its column (``build_arrays``:
    a column's window holds at most ``s_cap`` consecutive indices from
    ``s_off``; ``_fd_chains`` adds ``s_off`` to a window position).  For
    ``s_cap <= FORK_SS_NARROW_S_CAP`` the ``min`` then never bites and,
    per column,

    - det or la < s_off: v = 0 < 1 <= h, false; and the count masks det,
      and la < s_off <= hw is false as well;
    - hw = INT32_MAX: h = LANE_MAX > s_cap >= v, false; and la <= s_off +
      s_cap - 1 < INT32_MAX is false as well;
    - otherwise v and h are la and hw shifted by the same s_off - 1, so
      v >= h iff la >= hw.

    A pad creator is 0 against the witness's LANE_MAX (and a real
    witness value >= 1), and a real viewer value <= s_cap against
    LANE_MAX: it counts nothing.  So the OR over the planes and the sum
    over creators give ``ss_counts_plain``'s count bit for bit."""
    g, x, b = la_x.shape
    n = b // k
    out = _planes(la_x, k, 0)
    step = _row_step(la_x)
    for x0 in range(0, x, step):
        rel = la_x[:, x0:x0 + step] - s_off                    # [G, Xc, B]
        rel.clamp_(-1, LANE_MAX - 2).add_(1)
        xc = rel.shape[1]
        rel = rel.view(g, xc, n, k)
        rel.masked_fill_(det_x[:, x0:x0 + step, :, None].bool(), 0)
        out[:, x0:x0 + step, :, :n] = rel.transpose(-1, -2)
    return out


def witness_planes(helper_w: torch.Tensor, s_off: torch.Tensor,
                   k: int) -> torch.Tensor:
    """The witness side as the packed kernel reads it: int16 ``[G, W, K,
    Np]`` branch planes, ``h = min(max(hw - s_off, 0), LANE_MAX - 1) + 1``
    (INT32_MAX becomes LANE_MAX), LANE_MAX in the pad creators (the
    proof is ``viewer_planes``')."""
    g, w, b = helper_w.shape
    n = b // k
    out = _planes(helper_w, k, LANE_MAX)
    step = _row_step(helper_w)
    for w0 in range(0, w, step):
        rel = helper_w[:, w0:w0 + step] - s_off
        rel.clamp_(0, LANE_MAX - 1).add_(1)
        out[:, w0:w0 + step, :, :n] = \
            rel.view(g, rel.shape[1], n, k).transpose(-1, -2)
    return out


def ss_counts(la_x: torch.Tensor, det_x: torch.Tensor,
              helper_w: torch.Tensor, k: int,
              window: Optional[SsWindow] = None) -> torch.Tensor:
    """Creator count of strongly-see middlemen, i32 ``[G, X, W]``:

        cnt[g, x, w] = sum_c [ (OR_k la_x[g, x, c*k+kk] >= helper_w[g, w, c*k+kk])
                               AND NOT det_x[g, x, c] ]

    (the JAX package's ``_ss_counts`` with the viewer and witness axes
    written out).  With a ``window`` that narrows (the call sites hand
    the batch's), the rows go to ``viewer_planes`` / ``witness_planes``
    and the count is taken on those; without one, on the int32 rows.
    On CUDA tensors this launches ``csrc/fork_ss.cu`` (the packed kernel
    on the planes, the int32 kernel otherwise) on the current stream,
    counted in ``ss_counts.launches``, or raises; on CPU tensors it runs
    the plain twin (``ss_counts_planes_plain`` on the planes,
    ``ss_counts_plain`` otherwise)."""
    _check_ss_args(la_x, det_x, helper_w, k)
    narrow = window is not None and window.narrow
    if narrow and window.s_off.device != la_x.device:
        raise ValueError("ss_counts: the window's s_off is on "
                         f"{window.s_off.device}, the rows on {la_x.device}")
    if la_x.device.type == "cpu":
        if not narrow:
            return ss_counts_plain(la_x, det_x, helper_w, k)
        return ss_counts_planes_plain(window.viewer(la_x, det_x, k),
                                      window.witness(helper_w, k), k)
    if la_x.device.type != "cuda":
        raise ValueError(f"fork_ss: the kernel needs CUDA tensors, got "
                         f"{la_x.device}")
    if k > FORK_SS_MAX_K:
        raise ValueError(f"fork_ss: k={k} branch slots, the kernel is built "
                         f"for k in [1, {FORK_SS_MAX_K}]")
    if not narrow:
        return _launch_fork_ss(la_x, det_x, helper_w, k)
    return _launch_fork_ss_packed(window.viewer(la_x, det_x, k),
                                  window.witness(helper_w, k), k)


ss_counts.launches = 0


def _fork_ss_lib() -> ctypes.CDLL:
    """The built ``csrc/fork_ss.cu``, its C functions declared."""
    from .. import cuda_build

    lib = cuda_build.load("fork_ss")
    lib.fork_ss_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.fork_ss_launch.restype = ctypes.c_int
    lib.fork_ss_packed_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.fork_ss_packed_launch.restype = ctypes.c_int
    return lib


def _launch_fork_ss(la_x, det_x, helper_w, k):
    dev = la_x.device
    g, x, b = la_x.shape
    w, n = helper_w.shape[1], det_x.shape[2]
    out = torch.empty((g, x, w), dtype=I32, device=dev)
    if out.numel() == 0:
        return out
    la_c, hw_c = la_x.contiguous(), helper_w.contiguous()
    det_c = det_x.contiguous()
    fn = _fork_ss_lib().fork_ss_launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(la_c.data_ptr(), det_c.data_ptr(), hw_c.data_ptr(),
                out.data_ptr(), g, x, w, n, k, stream)
    if rc != 0:
        raise RuntimeError(f"fork_ss: kernel launch failed, cudaError_t {rc}")
    ss_counts.launches += 1
    return out


def _launch_fork_ss_packed(view, wit, k):
    """The packed kernel on ``viewer_planes`` / ``witness_planes``
    output (contiguous int16 ``[G, X, K, Np]`` / ``[G, W, K, Np]``)."""
    dev = view.device
    g, x, kp, np_ = view.shape
    w = wit.shape[1]
    if view.dtype != torch.int16 or wit.dtype != torch.int16 \
            or not (view.is_contiguous() and wit.is_contiguous()) \
            or kp != k or np_ % PLANE_ALIGN or wit.device != dev \
            or tuple(wit.shape) != (g, w, k, np_):
        raise ValueError(
            f"fork_ss: planes must be contiguous int16 [G, X, {k}, Np] and "
            f"[G, W, {k}, Np] with Np a multiple of {PLANE_ALIGN}, got "
            f"{view.dtype} {tuple(view.shape)} and {wit.dtype} "
            f"{tuple(wit.shape)}")
    out = torch.empty((g, x, w), dtype=I32, device=dev)
    if out.numel() == 0:
        return out
    fn = _fork_ss_lib().fork_ss_packed_launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(view.data_ptr(), wit.data_ptr(), out.data_ptr(), g, x, w,
                np_ // 2, k, stream)
    if rc != 0:
        raise RuntimeError(f"fork_ss: packed kernel launch failed, "
                           f"cudaError_t {rc}")
    ss_counts.launches += 1
    return out


def ss_counts_plain(la_x: torch.Tensor, det_x: torch.Tensor,
                    helper_w: torch.Tensor, k: int) -> torch.Tensor:
    """The same count in plain torch, on the device of the inputs: the
    strided OR over the K branch columns of ``_ss_counts``, chunked over
    X so that no temporary passes ``PLAIN_BUDGET_BYTES``."""
    g, x, _ = la_x.shape
    w, n = helper_w.shape[1], det_x.shape[2]
    out = torch.empty((g, x, w), dtype=I32, device=la_x.device)
    step = max(1, PLAIN_BUDGET_BYTES // max(1, g * w * n * 4))
    nd = ~det_x.bool()
    for x0 in range(0, x, step):
        la_c = la_x[:, x0:x0 + step, None, :]
        hw = helper_w[:, None, :, :]
        ok = la_c[..., 0::k] >= hw[..., 0::k]                 # [G, Xc, W, N]
        for kk in range(1, k):
            ok |= la_c[..., kk::k] >= hw[..., kk::k]
        ok &= nd[:, x0:x0 + step, None, :]
        out[:, x0:x0 + step] = ok.sum(-1, dtype=I32)
    return out


def ss_counts_planes_plain(view: torch.Tensor, wit: torch.Tensor,
                           k: int) -> torch.Tensor:
    """The packed kernel's plain twin: ``ss_counts_plain`` on the int16
    branch planes (laid back out as column ``c*k + kk``, NOT det already
    folded in, so no creator is masked)."""
    g, x, _, np_ = view.shape
    w = wit.shape[1]
    nodet = torch.zeros((g, x, np_), dtype=torch.bool, device=view.device)
    return ss_counts_plain(view.transpose(-1, -2).reshape(g, x, np_ * k),
                           nodet,
                           wit.transpose(-1, -2).reshape(g, w, np_ * k), k)


# ----------------------------------------------------------------------
# device phases


def _e_row(cfg: ForkConfig, dev) -> torch.Tensor:
    return (torch.arange(cfg.e_cap + 1, device=dev) == cfg.e_cap)[:, None]


def _cols(axis, b: int) -> slice:
    """The branch columns this rank holds (all without an axis)."""
    return slice(0, b) if axis is None else slice(axis.lo, axis.hi)


def _own_rows(cfg: ForkConfig, b: ForkBatch, none: int,
              axis=None) -> torch.Tensor:
    """Each event's own contribution row: its chain index on every chain
    that contains it (the cp mask), ``none`` elsewhere."""
    q = b.eseq[:, None]
    cp_rows = b.cp[b.ebr.clamp(0, cfg.b - 1).long()][:, _cols(axis, cfg.b)]
    return torch.where((cp_rows > q) & (q >= 0), q,
                       torch.full((), none, dtype=I32, device=q.device))


def _sched_rows(cfg: ForkConfig, b: ForkBatch):
    """Per schedule row: the sanitized slots and their sanitized parents
    (int64 index rows)."""
    idx = sanitize(b.sched, cfg.e_cap).long()                  # [T, Bt]
    spx = sanitize(b.sp, cfg.e_cap).long()[idx]
    opx = sanitize(b.op, cfg.e_cap).long()[idx]
    return idx, spx, opx


def _la_scan(cfg: ForkConfig, b: ForkBatch, axis=None) -> torch.Tensor:
    """la[x, br] = highest chain-(br) index among x's ancestors.  The own
    row seeds la (a slot is written by exactly one schedule step, after
    its parents), and each step takes the max with the parents' rows;
    pad lanes read and write the sentinel row, which stays -1."""
    la = _own_rows(cfg, b, -1, axis)
    idx, spx, opx = _sched_rows(cfg, b)
    for t in range(idx.shape[0]):
        rows = torch.maximum(la[idx[t]],
                             torch.maximum(la[spx[t]], la[opx[t]]))
        la.index_copy_(0, idx[t], rows)
    return set_sentinel(la, _e_row(cfg, la.device), -1)


def _detect(cfg: ForkConfig, b: ForkBatch, la: torch.Tensor,
            axis=None) -> torch.Tensor:
    """det[x, i]: x's ancestry contains a fork pair by creator i — some
    pair of i's branches is visible past their common prefix.  With
    ``axis``, each rank detects its own creators and the flags are
    gathered."""
    n, k = cfg.n, cfg.k
    c0 = 0 if axis is None else axis.lo // k
    nl = la.shape[1] // k
    lg = la.reshape(la.shape[0], nl, k)                        # [E+1, N, K]
    cpg = b.cp.reshape(n, k, n, k)
    ar = torch.arange(c0, c0 + nl, device=la.device)
    cpk = cpg[ar, :, ar, :]                                    # [N, K, K]
    off = ~torch.eye(k, dtype=torch.bool, device=la.device)
    det = torch.empty((la.shape[0], nl), dtype=torch.bool, device=la.device)
    step = max(1, PLAIN_BUDGET_BYTES // max(1, n * k * k))
    for x0 in range(0, la.shape[0], step):
        vis = lg[x0:x0 + step, :, :, None] >= cpk[None]        # [Xc, N, K, K]
        pair = vis & vis.transpose(-1, -2)
        det[x0:x0 + step] = (pair & off).flatten(2).any(-1)
    return det if axis is None else axis.gather(det, 1)


def _first_det(cfg: ForkConfig, b: ForkBatch, det: torch.Tensor,
               axis=None) -> torch.Tensor:
    """first_det[br, c]: first ABSOLUTE chain index on branch br whose
    event detects a fork by c (INT32_MAX if none).  Detection is
    monotone along a chain, so it is a count of the False prefix plus the
    branch's window offset.  With ``axis``, the rank's branch rows."""
    bl = _cols(axis, cfg.b)
    dchain = det[sanitize(b.ce[bl], cfg.e_cap).long()]          # [B, S+1, N]
    live = (torch.arange(cfg.s_cap + 1, device=det.device)[None, :]
            < b.cnt[bl, None])[:, :, None]
    first = ((~dchain) & live).sum(1, dtype=I32) + b.s_off[bl, None]
    hit = (dchain & live).any(1)
    return torch.where(hit, first, INT32_MAX)


def _fd_reverse(cfg: ForkConfig, b: ForkBatch, axis=None) -> torch.Tensor:
    """First-descendant fill by reverse level scan: walking levels
    deepest-first, an event's fd row is final before its parents absorb
    it by scatter-min (several children may share a parent: ``amin``
    with the old value included, which no write order changes); the own
    contribution covers every chain containing the event."""
    fd = _own_rows(cfg, b, INT32_MAX, axis)
    idx, spx, opx = _sched_rows(cfg, b)
    B = fd.shape[1]
    for t in range(idx.shape[0] - 1, -1, -1):
        rows = fd[idx[t]]
        tgt = torch.cat([spx[t], opx[t]])[:, None].expand(-1, B)
        fd.scatter_reduce_(0, tgt, torch.cat([rows, rows]), "amin",
                           include_self=True)
    return set_sentinel(fd, _e_row(cfg, fd.device), INT32_MAX)


def _fd_chains(cfg: ForkConfig, b: ForkBatch, la: torch.Tensor,
               axis=None) -> torch.Tensor:
    """fd[y, br] = first chain-(br) index of a descendant of y: a
    compare-count over the monotone chain view, processed in chain-column
    chunks (and threshold chunks inside) so that the ``[Cb, S+1, B]``
    gather and the ``[Cb, B, T]`` counts stay bounded.  With ``axis``,
    the rank's fd columns from la's columns gathered over it."""
    B, s_cap = cfg.b, cfg.s_cap
    e1 = cfg.e_cap + 1
    dev = la.device
    s1 = s_cap + 1
    s_idx = torch.arange(s1, device=dev)
    bl = _cols(axis, B)
    if axis is not None:
        la = axis.gather(la, 1)

    cb = max(1, min(B, 2 ** 27 // max(1, s1 * B)))
    tc = max(1, min(s1, 2 ** 27 // max(1, cb * s1 * B)))
    # all-chains owned-target grid (rows disjoint across chains; every
    # unowned position dumps into the sentinel row)
    tgt = sanitize(torch.where(b.owner, b.ce, -1), cfg.e_cap).long()
    fd = torch.full((e1, bl.stop - bl.start), INT32_MAX, dtype=I32,
                    device=dev)
    for c0 in range(bl.start, bl.stop, cb):
        c1 = min(bl.stop, c0 + cb)
        ce_c, cnt_c, s_off_c = b.ce[c0:c1], b.cnt[c0:c1], b.s_off[c0:c1]
        V = la[sanitize(ce_c, cfg.e_cap).long()]               # [Cb, S+1, B]
        V = torch.where((s_idx[None, :] < cnt_c[:, None])[:, :, None], V,
                        INT32_MAX)
        counts = []
        for t0 in range(0, s1, tc):
            # thresholds are ABSOLUTE target-chain indexes (window
            # position t on chain `by` is index t + s_off[by])
            t_idx = torch.arange(t0, min(s1, t0 + tc), device=dev,
                                 dtype=I32)
            thr = t_idx[None, None, None, :] + b.s_off[None, None, :, None]
            counts.append((V[:, :, :, None] < thr).sum(1, dtype=I32))
        out = torch.cat(counts, 2)                             # [Cb, B, S+1]
        found = out < cnt_c[:, None, None]
        out = torch.where(found, out + s_off_c[:, None, None], INT32_MAX)
        block = torch.full((e1, c1 - c0), INT32_MAX, dtype=I32, device=dev)
        block[tgt.reshape(-1)] = out.permute(1, 2, 0).reshape(-1, c1 - c0)
        fd[:, c0 - bl.start:c1 - bl.start] = set_sentinel(
            block, _e_row(cfg, dev), INT32_MAX)
    return fd


def _helper(cfg: ForkConfig, b: ForkBatch, fd: torch.Tensor,
            first_det: torch.Tensor) -> torch.Tensor:
    """helper[y, br]: first chain-(br) index whose event *sees* y — the
    left end of the interval [fd, first_det[br, creator(y)]), INF when
    the first descendant already detects creator(y)'s fork."""
    fdet_y = first_det.T[b.ecr.clamp(0, cfg.n - 1).long()]     # [E+1, B]
    return torch.where(fd < fdet_y, fd, INT32_MAX)


def _or_creators(x: torch.Tensor, k: int) -> torch.Tensor:
    """OR over each creator's K branch columns (strided slices)."""
    out = x[..., 0::k]
    for kk in range(1, k):
        out = out | x[..., kk::k]
    return out


def _window(cfg: ForkConfig, b: ForkBatch, axis) -> SsWindow:
    """The chain window of the rank's branch columns."""
    return SsWindow(b.s_off[_cols(axis, cfg.b)], cfg.s_cap)


def _det_cols(cfg: ForkConfig, det: torch.Tensor, axis) -> torch.Tensor:
    """det's columns of the rank's creators (all without an axis)."""
    if axis is None:
        return det
    return det[..., axis.lo // cfg.k:axis.hi // cfg.k]


def _ss_total(ss, axis, site: str, la_x, det_x, helper_w, k, window):
    """The strongly-see count: ``ss`` on the rank's creators, summed
    over the axis."""
    cnt = ss(la_x, det_x, helper_w, k, window=window)
    if axis is None:
        return cnt
    return axis.count(site, cnt, la_x.shape[-1])


def _rounds_closure(cfg: ForkConfig, b: ForkBatch, la: torch.Tensor,
                    det: torch.Tensor, helper: torch.Tensor, ss=ss_counts,
                    stats: Optional[dict] = None, axis=None):
    """Round assignment as a per-round closure iteration (the JAX
    package's ``_rounds_closure``; see its docstring for the argument).

    Per round r: the candidate witnesses are each branch's first event
    with no round below r; S = unassigned events that strongly see
    >= sm candidate creators (or whose parents already sit above r); the
    events with round > r are the descent closure of S within the
    unassigned set; every other unassigned event gets round r."""
    k, B, sm, r_cap = cfg.k, cfg.b, cfg.super_majority, cfg.r_cap
    e1 = cfg.e_cap + 1
    s_cap = cfg.s_cap
    dev = la.device
    rows = torch.arange(B, device=dev)

    valid_e = (torch.arange(e1, device=dev) < b.n_events) & (b.eseq >= 0)
    spx = sanitize(b.sp, cfg.e_cap).long()
    opx = sanitize(b.op, cfg.e_cap).long()

    seeded = valid_e & (b.rseed >= 0)
    rnd = torch.where(seeded, b.rseed, -1)
    cex = sanitize(b.ce, cfg.e_cap).long()                     # [B, S+1]
    live_chain = (torch.arange(s_cap + 1, device=dev)[None, :]
                  < b.cnt[:, None])

    # witness rows pre-populated from seeds: one owned witness per
    # (branch, seeded round); the rest dump into row r_cap as -1
    w_chain = (b.wseed[cex] == 1) & b.owner & live_chain & (b.rseed[cex] >= 0)
    w_round = torch.where(w_chain, b.rseed[cex], r_cap).clamp(0, r_cap)
    wslot = torch.full(((r_cap + 1) * B,), -1, dtype=I32, device=dev)
    flat = (w_round.long() * B + rows[:, None]).reshape(-1)
    wslot.scatter_reduce_(0, flat, torch.where(w_chain, b.ce, -1).reshape(-1),
                          "amax", include_self=True)
    wslot = wslot.reshape(r_cap + 1, B)

    unassigned = valid_e & ~seeded
    r, passes = 0, 0
    alive = True
    # every round counts against the same la and det: narrowed once
    win = _window(cfg, b, axis)
    la_g, det_g = la[None], _det_cols(cfg, det, axis)[None]
    while alive and r < r_cap:
        # candidate frontier: first chain position with round >= r
        rnd_chain = torch.where(live_chain, rnd[cex], -1)
        pos = ((rnd_chain >= 0) & (rnd_chain < r)).sum(-1, dtype=I32)
        valid_w = pos < b.cnt
        pos_c = pos.clamp(0, s_cap).long()
        ws = b.ce[rows, pos_c]
        wsx = sanitize(torch.where(valid_w, ws, -1), cfg.e_cap).long()
        hw = torch.where(valid_w[:, None], helper[wsx], INT32_MAX)  # [B, B]

        ss_cnt = _ss_total(ss, axis, "fork_closure", la_g, det_g,
                           hw[None].contiguous(), k, win)[0]
        ss_c = _or_creators((ss_cnt >= sm) & valid_w[None, :], k)
        pr_gt = torch.maximum(rnd[spx], rnd[opx]) > r
        S = unassigned & ((ss_c.sum(-1) >= sm) | pr_gt)

        # descent closure of S within the unassigned set
        D = S
        while True:
            D2 = (S | (unassigned & (D[spx] | D[opx]))) & valid_e
            passes += 1
            changed = bool((D2 != D).any())
            D = D2
            if not changed:
                break

        newly = unassigned & ~D
        rnd = torch.where(newly, r, rnd)
        owner_w = b.owner[rows, pos_c]
        is_w = valid_w & newly[wsx] & owner_w
        row = min(r, r_cap)
        wslot[row] = torch.where(is_w, ws, wslot[row])

        alive = bool(D.any())
        unassigned = D
        r += 1
    if stats is not None:
        stats["rounds"] = stats.get("rounds", 0) + r
        stats["closure_passes"] = stats.get("closure_passes", 0) + passes

    wit = valid_e & ((b.sp < 0) | (rnd > rnd[spx]))
    wit = torch.where(b.wseed >= 0, b.wseed == 1, wit) & valid_e
    max_round = torch.where(valid_e, rnd, -1).max()
    return rnd, wit, wslot, max_round


def _rounds_scan(cfg: ForkConfig, b: ForkBatch, la: torch.Tensor,
                 det: torch.Tensor, helper: torch.Tensor, ss=ss_counts):
    """Round assignment level scan (branch-witness tables); the tests
    hold the closure to it."""
    k, B, sm, r_cap = cfg.k, cfg.b, cfg.super_majority, cfg.r_cap
    e1 = cfg.e_cap + 1
    dev = la.device

    rnd = torch.full((e1,), -1, dtype=I32, device=dev)
    wit = torch.zeros((e1,), dtype=torch.bool, device=dev)
    wslot = torch.full(((r_cap + 1) * B,), -1, dtype=I32, device=dev)
    max_round = torch.full((), -1, dtype=I32, device=dev)
    sp_s = sanitize(b.sp, cfg.e_cap).long()
    op_s = sanitize(b.op, cfg.e_cap).long()
    win = SsWindow(b.s_off, cfg.s_cap)

    for t in range(b.sched.shape[0]):
        idx = b.sched[t]
        real = idx >= 0
        idx_s = sanitize(idx, cfg.e_cap).long()
        spx, opx = sp_s[idx_s], op_s[idx_s]
        is_root = (b.sp[idx_s] < 0) & (b.op[idx_s] < 0)
        pr = torch.where(is_root, 0, torch.maximum(rnd[spx], rnd[opx]))

        wsl = wslot.view(r_cap + 1, B)[pr.clamp(0, r_cap).long()]  # [Bt, B]
        valid_w = wsl >= 0
        hw = helper[sanitize(wsl, cfg.e_cap).long()]           # [Bt, B, B]
        hw = torch.where(valid_w[:, :, None], hw, INT32_MAX)
        ss_cnt = ss(la[idx_s][:, None, :], det[idx_s][:, None, :], hw, k,
                    window=win)
        ss_c = _or_creators((ss_cnt[:, 0, :] >= sm) & valid_w, k)  # [Bt, N]
        inc = ss_c.sum(-1) >= sm
        r_x = pr + inc.to(I32)
        w_x = (b.sp[idx_s] < 0) | (r_x > rnd[spx])

        rnd.index_copy_(0, idx_s, torch.where(real, r_x, -1))
        wit.index_copy_(0, idx_s, w_x & real)
        w_row = torch.where(w_x & real, r_x, r_cap).long()
        w_col = b.ebr[idx_s].clamp(0, B - 1).long()
        wslot.index_copy_(0, w_row * B + w_col, idx_s.to(I32))
        max_round = torch.maximum(
            max_round, torch.where(real, r_x, -1).max())
    # restore the dump row and the sentinels
    wslot = wslot.view(r_cap + 1, B)
    r_row = (torch.arange(r_cap + 1, device=dev) == r_cap)[:, None]
    wslot = set_sentinel(wslot, r_row, -1)
    e_row = _e_row(cfg, dev)[:, 0]
    rnd = set_sentinel(rnd, e_row, -1)
    wit = set_sentinel(wit, e_row, False)
    return rnd, wit, wslot, max_round


def _fame(cfg: ForkConfig, b: ForkBatch, la: torch.Tensor, det: torch.Tensor,
          helper: torch.Tensor, wslot: torch.Tensor, max_round: torch.Tensor,
          ss=ss_counts, axis=None):
    """Virtual voting over branch witnesses (diagonal scan).  Baird's
    strongly-seeing lemma keeps vote tallies per-creator unique, so
    summing over branch columns never double-counts.  With ``axis`` the
    votes run over the rank's witness columns x (``la_ax`` reads la
    column ``brw[x]``, which is x for every valid witness: a branch
    registers only events it owns)."""
    n, k, B, sm, R = cfg.n, cfg.k, cfg.b, cfg.super_majority, cfg.r_cap
    dev = la.device
    xl = _cols(axis, B)
    bw = la.shape[1]

    wsl = wslot[:R]                                            # [R, B]
    valid_w = wsl >= 0
    ws = sanitize(wsl, cfg.e_cap).long()
    law = la[ws]                                               # [R, B, B]
    detw = det[ws]                                             # [R, B, N]
    hw = torch.where(valid_w[:, :, None], helper[ws], INT32_MAX)
    seqw = torch.where(valid_w, b.eseq[ws], INT32_MAX)         # [R, B]
    brw = (b.ebr[ws][:, xl] - xl.start).clamp(0, bw - 1).long()
    crw = b.ecr[ws][:, xl].clamp(0, n - 1).long()
    mbw = b.mbit[ws]

    law_next = torch.cat([law[1:], torch.full((1, B, bw), -1, dtype=I32,
                                              device=dev)])
    detw_next = torch.cat([detw[1:], torch.zeros((1, B, n), dtype=torch.bool,
                                                 device=dev)])
    valid_next = torch.cat([valid_w[1:], torch.zeros((1, B), dtype=torch.bool,
                                                     device=dev)])

    # ss_next[r, a, w]: round r+1 witness a strongly sees round r witness w
    ss_cnt = _ss_total(ss, axis, "fork_fame", law_next,
                       _det_cols(cfg, detw_next, axis), hw, k,
                       _window(cfg, b, axis))                  # [R, A, W]
    ss_next = ((ss_cnt >= sm) & valid_next[:, :, None]
               & valid_w[:, None, :]).to(F32)
    tot_next = ss_next.sum(-1)

    # see_next[r, a, x]: direct votes — a sees x
    la_ax = torch.gather(law_next, 2, brw[:, None, :].expand(R, B, bw))
    det_ax = torch.gather(detw_next, 2, crw[:, None, :].expand(R, B, bw))
    see_next = ((la_ax >= seqw[:, None, xl]) & ~det_ax
                & valid_next[:, :, None] & valid_w[:, None, xl]).to(F32)

    ss_pad = torch.cat([ss_next, torch.zeros((R, B, B), dtype=F32,
                                             device=dev)])
    tot_pad = torch.cat([tot_next, torch.zeros((R, B), dtype=F32,
                                               device=dev)])
    mb_pad = torch.cat([mbw, torch.zeros((R, B), dtype=torch.bool,
                                         device=dev)])

    i_idx = torch.arange(R, dtype=I32, device=dev)
    in_window = i_idx < max_round
    votes = see_next
    famous = torch.zeros((R, bw), dtype=I8, device=dev)
    valid_x = valid_w[:, xl]
    one = torch.full((), FAME_TRUE, dtype=I8, device=dev)
    two = torch.full((), FAME_FALSE, dtype=I8, device=dev)
    # steps past max_round vote nowhere (can_vote is False), so the loop
    # stops at the JAX package's d_max = max(max_round, 2), read once
    d_max = max(int(max_round.item()), 2)
    for d in range(2, d_max + 1):
        can_vote = (i_idx + d) <= max_round
        s0, m0 = min(d - 1, R), min(d, R)      # dynamic_slice's clamp
        ss_d = ss_pad[s0:s0 + R]
        tot_d = tot_pad[s0:s0 + R]
        mb_d = mb_pad[m0:m0 + R]

        # operands are 0/1 and sums at most B < 2**24: exact in f32, and
        # exact in TF32 as well (0 and 1 are exact, the sum is f32)
        yays = torch.bmm(ss_d, votes)
        nays = tot_d[:, :, None] - yays
        v = yays >= nays
        t = torch.maximum(yays, nays)
        strong = t >= sm

        undecided = (famous == FAME_UNDEFINED) & valid_x & in_window[:, None]
        normal = (d % n) != 0
        deciding = strong & can_vote[:, None, None] if normal \
            else torch.zeros_like(strong)
        decide_x = deciding.any(1)
        v_star = (deciding & v).any(1)
        famous = torch.where(undecided & decide_x,
                             torch.where(v_star, one, two), famous)
        new_votes = v if normal else torch.where(strong, v, mb_d[:, :, None])
        votes = torch.where(can_vote[:, None, None], new_votes.to(F32), votes)

    if axis is not None:
        famous = axis.gather(famous, 1)
    decided_round = ((~valid_w) | (famous != FAME_UNDEFINED)).all(1)
    has_w = valid_w.any(1)
    cand = in_window & decided_round & has_w
    lcr = torch.where(cand, i_idx, -1).max()
    famous_full = torch.zeros((R + 1, B), dtype=I8, device=dev)
    famous_full[:R] = famous
    return famous_full, lcr


def _order(cfg: ForkConfig, b: ForkBatch, fd: torch.Tensor,
           first_det: torch.Tensor, wslot: torch.Tensor,
           famous: torch.Tensor, rnd: torch.Tensor, max_round: torch.Tensor,
           axis=None):
    """Round received + median consensus timestamps (fork-aware sees).
    With ``axis``: the see count over the rank's branch columns, summed;
    the median's timestamp columns gathered before the sort."""
    n, B, R, e1 = cfg.n, cfg.b, cfg.r_cap, cfg.e_cap + 1
    dev = fd.device
    xl = _cols(axis, B)

    wsl = wslot[:R]
    valid_w = wsl >= 0
    ws = sanitize(wsl, cfg.e_cap).long()
    seqw = torch.where(valid_w, b.eseq[ws], -1)                # [R, B]
    fam = (famous[:R] == FAME_TRUE) & valid_w
    decided = ((~valid_w) | (famous[:R] != FAME_UNDEFINED)).all(1)
    has_w = valid_w.any(1)
    fam_cnt = fam.sum(1)

    valid_e = (torch.arange(e1, device=dev) < b.n_events) & (b.eseq >= 0)
    fdet_x = first_det.T[b.ecr.clamp(0, n - 1).long()]         # [E+1, B]

    rr = torch.full((e1,), -1, dtype=I32, device=dev)
    for i in range(1, R):
        active = decided[i] & has_w[i] & (i <= max_round)
        sees = fam[i][None, xl] & (fd <= seqw[i][None, xl]) \
            & (seqw[i][None, xl] < fdet_x)                     # [E+1, B]
        c = sees.sum(1)
        if axis is not None:
            c = axis.count("fork_order_sees", c, sees.shape[1])
        cond = (valid_e & (rr == -1) & (i > rnd) & active
                & (c > fam_cnt[i] // 2))
        rr = torch.where(cond, i, rr)
    newly = valid_e & (rr != -1)

    i_of = rr.clamp(0, R - 1).long()
    fam_i, seqw_i = fam[i_of][:, xl], seqw[i_of][:, xl]
    sees_i = fam_i & (fd <= seqw_i) & (seqw_i < fdet_x)        # [E+1, B]

    # tv[x, br] = ts of chain-br's event at index fd[x, br] (the oldest
    # self-ancestor of that branch's witness to see x).  fdc lies in
    # [0, s_cap], so the JAX package's s_cap+1 masked passes write every
    # entry exactly once: one gather computes the same tv
    ts_grid = b.ts[sanitize(b.ce[xl], cfg.e_cap).long()]       # i64[B, S+1]
    fdc = (fd - b.s_off[None, xl]).clamp(0, cfg.s_cap).long()
    tv = torch.gather(ts_grid.T, 0, fdc)                       # [E+1, B]
    tv = torch.where(sees_i, tv, INT64_MAX)
    cnt_s = sees_i.sum(1)
    if axis is not None:
        tv = axis.gather(tv, 1)
        cnt_s = axis.sum(cnt_s)
    tv_sorted = torch.sort(tv, dim=1).values
    med = tv_sorted.gather(1, (cnt_s // 2).clamp(0, B - 1)[:, None])[:, 0]
    cts = torch.where(newly, med, 0)
    return rr, cts


def fork_pipeline(cfg: ForkConfig, b: ForkBatch, ss=ss_counts,
                  stats: Optional[dict] = None, axis=None) -> ForkOut:
    """The whole fork-aware pipeline on ``b``'s device.  ``ss`` is the
    strongly-see compare-count, called as ``ss(la_x, det_x, helper_w,
    k, window=SsWindow(b.s_off, cfg.s_cap))``: ``ss_counts``, which
    launches the kernels on CUDA tensors, or, for the plain run, a
    function that passes the first four to ``ss_counts_plain``;
    ``stats``, if given, receives the closure's round and pass counts
    and the fd strategy.  ``axis`` (a ``ColumnShard`` over the branch
    columns): one rank's part of the sharded fork step (module
    docstring); its ``la``, ``fd`` are the rank's columns, ``det``,
    ``wslot``, ``famous`` and the per-event outputs whole."""
    if axis is not None and (axis.lo % cfg.k or axis.hi % cfg.k):
        raise ValueError(f"branch columns [{axis.lo}, {axis.hi}) do not "
                         f"hold whole creators of k={cfg.k}")
    la = _la_scan(cfg, b, axis)
    det = _detect(cfg, b, la, axis)
    first_det = _first_det(cfg, b, det, axis)
    # the JAX package's static choice between the two fd strategies
    if fd_reverse_scan_wins(b.sched.shape[0], cfg.e_cap, cfg.k):
        fd = _fd_reverse(cfg, b, axis)
        fd_mode = "reverse"
    else:
        fd = _fd_chains(cfg, b, la, axis)
        fd_mode = "chains"
    if stats is not None:
        stats["fd"] = fd_mode
    helper = _helper(cfg, b, fd, first_det)
    rnd, wit, wslot, max_round = _rounds_closure(cfg, b, la, det, helper,
                                                 ss=ss, stats=stats,
                                                 axis=axis)
    famous, lcr = _fame(cfg, b, la, det, helper, wslot, max_round, ss=ss,
                        axis=axis)
    rr, cts = _order(cfg, b, fd, first_det, wslot, famous, rnd, max_round,
                     axis)
    return ForkOut(
        la=la, det=det, fd=fd, round=rnd, witness=wit, wslot=wslot,
        famous=famous, rr=rr, cts=cts, max_round=max_round, lcr=lcr,
    )

