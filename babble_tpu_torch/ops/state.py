"""Dense device-side DAG state: the struct-of-arrays hashgraph, in torch.

The port's twin of the JAX package's ``ops/state.py``.  The whole DAG
lives in device memory as tensors indexed by *slot* (insertion order on
this replica):

- ``la[E+1, N]``  last-ancestor seq per participant   (-1 = none)
- ``fd[E+1, N]``  first-descendant seq per participant (INF = none)

Row ``E`` (the capacity row) is a sentinel: gathering a missing parent
(slot -1 is remapped to E by ``sanitize``) yields neutral values.  Every
consensus predicate is an elementwise/reduction op over these tensors:

    ancestor(x, y)      = la[x, creator[y]] >= seq[y]
    strongly_see(x, y)  = sum_k(la[x, k] >= fd[y, k]) >= 2N/3+1
    see(w, x)           = fd[x, creator[w]] <= seq[w]

Index discipline: JAX gathers clamp out-of-range indices and JAX
scatters drop them; torch raises on the CPU and device-asserts on CUDA.
So every gather here goes through ``sanitize`` or an explicit clamp, and
every scatter of a padding lane goes to a dump row that a sentinel reset
restores afterwards.

``DagState`` keeps the JAX package's fields in the same order, so a JAX
state carries over with ``state_from_numpy`` and back with
``state_to_numpy``.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..quorum import supermajority
from .pack import lane_count, pack_bits

I8 = torch.int8
I16 = torch.int16
I32 = torch.int32
I64 = torch.int64
INT32_MAX = int(np.iinfo(np.int32).max)
INT64_MAX = int(np.iinfo(np.int64).max)

# famous trilean encoding (reference roundInfo.go:24-30)
FAME_UNDEFINED = 0
FAME_TRUE = 1
FAME_FALSE = 2


class DagConfig(NamedTuple):
    """Static shape/threshold configuration — the same fields, defaults
    and meaning as the JAX package's ``DagConfig``.

    ``n`` is the participant-axis width (``n_real`` the true count when
    it is padded, 0 = ``n``); ``coord16``/``coord8`` narrow la/fd;
    ``ts32`` narrows the order median to int32 relative timestamps;
    ``retired`` lists the columns of departed members; ``packed``
    selects popcount tallies (bit-parity-preserving)."""

    n: int
    e_cap: int
    s_cap: int
    r_cap: int
    n_real: int = 0
    coord16: bool = False
    coord8: bool = False
    ts32: bool = False
    retired: Tuple[int, ...] = ()
    packed: bool = False

    @property
    def n_cols(self) -> int:
        return self.n_real or self.n

    @property
    def active_n(self) -> int:
        return self.n_cols - len(self.retired)

    @property
    def super_majority(self) -> int:
        return supermajority(self.active_n)

    @property
    def lp(self) -> int:
        """uint8 lanes of the packed participant axis: ``ceil(n/8)``."""
        return lane_count(self.n)

    @property
    def coord_dtype(self) -> torch.dtype:
        if self.coord8:
            return I8
        return I16 if self.coord16 else I32

    @property
    def fd_inf(self) -> int:
        """The 'no first descendant' sentinel of the coordinate dtype.
        Compare with >= (never ==)."""
        return int(torch.iinfo(self.coord_dtype).max)


def config_from_fields(fields) -> DagConfig:
    """Rebuild a DagConfig from its serialised field list (checkpoint
    meta).  msgpack round-trips the ``retired`` tuple as a list:
    normalise it back so the config stays hashable and comparable."""
    cfg = DagConfig(*fields)
    if not isinstance(cfg.retired, tuple):
        cfg = cfg._replace(
            retired=tuple(int(c) for c in (cfg.retired or ()))
        )
    return cfg


def coord16_ok(s_cap: int) -> bool:
    """int16 coordinates are exact when every seq (plus slack) stays
    clear of the INF sentinel."""
    return s_cap < (1 << 14)


def ts32_ok(ts_min: int, ts_max: int) -> bool:
    """int32 relative timestamps are exact when the live span (plus a
    little slack for the sentinel) stays clear of INT32_MAX."""
    return (ts_max - ts_min) < (1 << 31) - 4


def coord8_ok(s_cap: int) -> bool:
    """int8 coordinates: seqs (plus slack) must stay below 127."""
    return s_cap < 120


class DagState(NamedTuple):
    """Device tensors.  Every per-event tensor has e_cap+1 rows, every
    per-round tensor r_cap+1 rows, ce an (n+1)-th dump row; the last
    row/col of each is the write dump and gather sentinel.  Window
    offsets (e_off, s_off, r_off) stay zero on the batch path."""

    # per-event
    sp: torch.Tensor        # i32[E+1]   self-parent slot, -1 = none
    op: torch.Tensor        # i32[E+1]   other-parent slot, -1 = none
    creator: torch.Tensor   # i32[E+1]
    seq: torch.Tensor       # i32[E+1]   index within creator chain; -1
    ts: torch.Tensor        # i64[E+1]   claimed timestamp (ns)
    mbit: torch.Tensor      # bool[E+1]  middle bit of identity hash
    la: Optional[torch.Tensor]   # coord[E+1, N]
    fd: Optional[torch.Tensor]   # coord[E+1, N]
    round: torch.Tensor     # i32[E+1]   -1 undefined
    witness: torch.Tensor   # bool[E+1]
    rr: torch.Tensor        # i32[E+1]   round received, -1 undecided
    cts: torch.Tensor       # i64[E+1]   consensus timestamp

    # per-creator
    ce: torch.Tensor        # i32[N+1, S+1]  (creator, seq) -> slot, -1
    cnt: torch.Tensor       # i32[N+1]       events per creator

    # per-round
    wslot: torch.Tensor     # i32[R+1, N]    witness slot, -1 = none
    famous: torch.Tensor    # i8[R+1, N]     trilean
    sm: torch.Tensor        # i32[R+1]       round-increment threshold
    mbr: torch.Tensor       # u8[R+1, LP]    packed witness coin bits
    fmr: torch.Tensor       # u8[R+1, LP]    packed famous==TRUE bits

    # scalars
    n_events: torch.Tensor  # i32
    max_round: torch.Tensor # i32
    lcr: torch.Tensor       # i32

    # rolling-window offsets
    e_off: torch.Tensor     # i32
    s_off: torch.Tensor     # i32[N+1]
    r_off: torch.Tensor     # i32


#: Axis classification of every DagState field (the JAX package's
#: ``ops/state.py`` tuples): the four tuples partition DagState._fields.
AXIS_CLASSIFIED_STATE = "DagState"
PER_EVENT_FIELDS = ("sp", "op", "creator", "seq", "ts", "mbit",
                    "la", "fd", "round", "witness", "rr", "cts")
PER_ROUND_FIELDS = ("wslot", "famous", "sm", "mbr", "fmr")
PER_CREATOR_FIELDS = ("ce", "cnt", "s_off")
SCALAR_FIELDS = ("n_events", "max_round", "lcr", "e_off", "r_off")


def init_state(cfg: DagConfig, include_coords: bool = True,
               device="cuda") -> DagState:
    """A fresh (empty) DAG state on ``device``."""
    if cfg.coord8 and not coord8_ok(cfg.s_cap):
        raise ValueError(
            f"coord8 requires s_cap < 120 (got {cfg.s_cap}): int8 "
            "coordinates would wrap"
        )
    if cfg.coord16 and not cfg.coord8 and not coord16_ok(cfg.s_cap):
        raise ValueError(
            f"coord16 requires s_cap < 2^14 (got {cfg.s_cap}): int16 "
            "coordinates would wrap"
        )
    e1, n, s1, r1 = cfg.e_cap + 1, cfg.n, cfg.s_cap + 1, cfg.r_cap + 1

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    cd = cfg.coord_dtype
    return DagState(
        sp=full((e1,), -1, I32),
        op=full((e1,), -1, I32),
        creator=full((e1,), n, I32),       # sentinel creator = dump col
        seq=full((e1,), -1, I32),
        ts=full((e1,), 0, I64),
        mbit=full((e1,), False, torch.bool),
        la=full((e1, n), -1, cd) if include_coords else None,
        fd=full((e1, n), cfg.fd_inf, cd) if include_coords else None,
        round=full((e1,), -1, I32),
        witness=full((e1,), False, torch.bool),
        rr=full((e1,), -1, I32),
        cts=full((e1,), 0, I64),
        ce=full((n + 1, s1), -1, I32),
        cnt=full((n + 1,), 0, I32),
        wslot=full((r1, n), -1, I32),
        famous=full((r1, n), 0, I8),
        sm=full((r1,), cfg.super_majority, I32),
        mbr=full((r1, cfg.lp), 0, torch.uint8),
        fmr=full((r1, cfg.lp), 0, torch.uint8),
        n_events=full((), 0, I32),
        max_round=full((), -1, I32),
        lcr=full((), -1, I32),
        e_off=full((), 0, I32),
        s_off=full((n + 1,), 0, I32),
        r_off=full((), 0, I32),
    )


def grow_state(state: DagState, old: DagConfig, new: DagConfig) -> DagState:
    """Copy a state into larger-capacity tensors on its own device, the
    sentinel rows kept at the new last index (the JAX package's
    ``grow_state``)."""
    if old.coord_dtype != new.coord_dtype:
        raise ValueError(
            "cannot grow across coordinate dtypes: values would be "
            f"silently cast ({old.coord_dtype} -> {new.coord_dtype})"
        )
    fresh = init_state(new, include_coords=state.la is not None,
                       device=state.sp.device)
    out = {}
    for f in PER_EVENT_FIELDS:
        dst, src = getattr(fresh, f), getattr(state, f)
        if src is not None:
            dst[: old.e_cap] = src[: old.e_cap]
        out[f] = dst
    for f in ("wslot", "famous", "sm", "mbr", "fmr"):
        dst = getattr(fresh, f)
        dst[: old.r_cap] = getattr(state, f)[: old.r_cap]
        out[f] = dst
    fresh.ce[: old.n + 1, : old.s_cap] = state.ce[:, : old.s_cap]
    fresh.cnt[: old.n + 1] = state.cnt
    fresh.s_off[: old.n + 1] = state.s_off
    return fresh._replace(
        **out, ce=fresh.ce, cnt=fresh.cnt, s_off=fresh.s_off,
        n_events=state.n_events, max_round=state.max_round, lcr=state.lcr,
        e_off=state.e_off, r_off=state.r_off,
    )


def compact_impl(cfg: DagConfig, state: DagState, de, new_s_off: torch.Tensor,
                 dr) -> DagState:
    """Roll the windows (the JAX package's ``compact_impl``): evict the
    first ``de`` event slots (a decided prefix), move each creator's seq
    window to start at ``new_s_off[c]`` and roll ``dr`` rounds off the
    witness tables, every tensor keeping its shape.  The caller
    (``TorchHashgraph.maybe_compact``) guarantees the evicted prefix is
    never referenced again.

    Row ``e_cap`` of every per-event tensor holds an untouched (init)
    row, so the gather ``a[min(arange + de, e_cap)]`` both shifts the
    live rows down and back-fills the tail with fresh rows; likewise the
    sentinel column of ``ce`` and the sentinel row of the round tables.
    Slot values are remapped to the new rows (-1 where evicted)."""
    e1, s1, r1 = cfg.e_cap + 1, cfg.s_cap + 1, cfg.r_cap + 1
    dev = state.sp.device

    eidx = torch.clamp(torch.arange(e1, device=dev) + de, max=cfg.e_cap)

    def remap(v):
        return torch.where(v >= de, v - de, -1).to(v.dtype)

    # ce: per-creator column shift by (new_s_off - s_off), values remapped
    ds = (new_s_off - state.s_off)[:, None].long()               # [N+1, 1]
    scol = torch.clamp(torch.arange(s1, device=dev)[None, :] + ds,
                       max=cfg.s_cap)
    ce = remap(torch.gather(state.ce, 1, scol))

    ridx = torch.clamp(torch.arange(r1, device=dev) + dr, max=cfg.r_cap)

    return state._replace(
        sp=remap(state.sp[eidx]),
        op=remap(state.op[eidx]),
        creator=state.creator[eidx],
        seq=state.seq[eidx],
        ts=state.ts[eidx],
        mbit=state.mbit[eidx],
        la=state.la[eidx] if state.la is not None else None,
        fd=state.fd[eidx] if state.fd is not None else None,
        round=state.round[eidx],
        witness=state.witness[eidx],
        rr=state.rr[eidx],
        cts=state.cts[eidx],
        ce=ce,
        wslot=remap(state.wslot[ridx]),
        famous=state.famous[ridx],
        # fresh rounds inherit the current threshold from the sentinel row
        sm=state.sm[ridx],
        mbr=state.mbr[ridx],
        fmr=state.fmr[ridx],
        n_events=state.n_events - de,
        e_off=state.e_off + de,
        s_off=new_s_off.to(device=dev, dtype=I32),
        r_off=state.r_off + dr,
    )


#: the JAX package's compiled entry point; eager torch runs the impl
compact = compact_impl


def state_from_numpy(cfg: DagConfig, arrays, device="cuda") -> DagState:
    """Carry a state given as numpy arrays (a JAX ``DagState`` passed
    through ``np.asarray``, or any object with the DagState field names
    as attributes) onto ``device``.  Every field is copied: no tensor of
    the result shares memory with ``arrays``.  Shapes are checked against
    ``cfg``."""
    ref = init_state(cfg, include_coords=True, device="meta")
    out = {}
    for f in DagState._fields:
        v = getattr(arrays, f)
        if v is None:
            out[f] = None
            continue
        a = np.array(v, copy=True)
        want = getattr(ref, f)
        if tuple(a.shape) != tuple(want.shape):
            raise ValueError(
                f"state_from_numpy: {f} has shape {a.shape}, "
                f"config wants {tuple(want.shape)}"
            )
        out[f] = torch.from_numpy(a).to(device=device, dtype=want.dtype)
    return DagState(**out)


def state_to_numpy(state: DagState) -> DagState:
    """A DagState of numpy arrays, copied off the device (no array
    aliases a tensor of ``state``)."""
    return DagState(*(
        None if t is None else t.detach().cpu().numpy().copy()
        for t in state
    ))


#: staleness horizon (rounds) for the live finality gate (the JAX
#: package's ``HEAD_GATE_HORIZON``).
HEAD_GATE_HORIZON = 8


def head_round_min_math(cfg: DagConfig, state: DagState) -> torch.Tensor:
    """Effective head-round minimum for the witness-set finality gate:
    the smallest chain-head round over minted, non-stale, non-retired
    chains (-1 while a live participant has never minted)."""
    n = cfg.n_cols
    dev = state.cnt.device
    cnt_w = state.cnt[:n] - state.s_off[:n]
    heads = state.ce[torch.arange(n, device=dev),
                     torch.clamp(cnt_w - 1, 0, cfg.s_cap).long()]
    hr = state.round[sanitize(torch.where(cnt_w > 0, heads, -1),
                              cfg.e_cap).long()]
    hr = torch.where(state.cnt[:n] > 0, hr, -1)
    stale = hr + HEAD_GATE_HORIZON < state.max_round
    if cfg.retired:
        stale = stale | torch.from_numpy(retired_mask(cfg)[:n]).to(dev)
    return torch.where(stale, INT32_MAX, hr).min()


def retired_mask(cfg: DagConfig) -> np.ndarray:
    """bool[N+1] constant marking retired participant columns."""
    mask = np.zeros(cfg.n + 1, bool)
    if cfg.retired:
        mask[list(cfg.retired)] = True
    return mask


def bucket(x: int, minimum: int = 8) -> int:
    """Round a capacity up to a power of two (the JAX package's shape
    buckets: batch padding, schedule padding, the flush frontier)."""
    v = max(x, minimum)
    return 1 << (v - 1).bit_length()


def fd_reverse_scan_wins(sched_rows: int, e_cap: int, k: int = 1) -> bool:
    """The JAX package's static choice between the two first-descendant
    strategies (reverse level scan vs chain-view compare-count), copied
    unchanged so the port takes the same branch on the same shapes."""
    return sched_rows < ((k * e_cap) ** 2) * 4.8e-7


def sanitize(idx: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Remap negative (missing) indices to the sentinel row."""
    return torch.where(idx < 0, sentinel, idx)


def set_sentinel(a: torch.Tensor, mask: torch.Tensor, v) -> torch.Tensor:
    """Sentinel restore: ``where(mask, v, a)`` over an iota mask.  Every
    duplicate-index scatter of a padding lane lands on a sentinel row,
    where CUDA leaves which write wins unspecified; this reset is what
    makes such rows deterministic again."""
    return torch.where(mask, torch.full((), v, dtype=a.dtype,
                                        device=a.device), a)


def repack_round_bits(cfg: DagConfig, state: DagState) -> DagState:
    """Recompute the packed per-round witness bitplanes (``mbr``,
    ``fmr``) from the wide tensors."""
    valid = state.wslot >= 0
    ws = sanitize(state.wslot, cfg.e_cap).long()
    mb = state.mbit[ws] & valid
    fm = (state.famous == FAME_TRUE) & valid
    return state._replace(mbr=pack_bits(mb), fmr=pack_bits(fm))


def repack_round_bits_np(cfg: DagConfig, wslot: np.ndarray,
                         famous: np.ndarray, mbit: np.ndarray):
    """Numpy twin of ``repack_round_bits`` for host-side rebuilds: epoch
    re-shapes (the lane count re-buckets when a join widens the
    participant axis) and checkpoint restore (the planes are re-packed,
    never trusted).  Bit order matches ``ops/pack.py``:
    ``np.packbits(..., bitorder="little")``."""
    valid = wslot >= 0
    ws = np.where(valid, wslot, cfg.e_cap)
    mb = mbit[np.clip(ws, 0, cfg.e_cap)] & valid
    fm = (famous == FAME_TRUE) & valid
    lp = cfg.lp
    mbr = np.packbits(mb, axis=-1, bitorder="little")[..., :lp]
    fmr = np.packbits(fm, axis=-1, bitorder="little")[..., :lp]
    return mbr.astype(np.uint8), fmr.astype(np.uint8)


# Consensus-observable tensors: every decision the pipeline emits.
CONSENSUS_EVENT_FIELDS = ("la", "fd", "round", "witness", "rr", "cts")
CONSENSUS_TABLE_FIELDS = ("wslot", "famous")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_consensus_parity(ref, out, n_events: int, label: str = "") -> None:
    """Assert bit-identical consensus decisions between two states
    (per-event fields compared on the first n_events rows).  Either
    side may hold torch tensors or numpy arrays."""
    tag = label and f" ({label})"
    for f in CONSENSUS_EVENT_FIELDS + CONSENSUS_TABLE_FIELDS:
        a = _host(getattr(ref, f))
        b = _host(getattr(out, f))
        if f in CONSENSUS_EVENT_FIELDS:
            a, b = a[:n_events], b[:n_events]
        if a.shape != b.shape or not (a == b).all():
            diff = int((a != b).sum()) if a.shape == b.shape else a.size
            raise AssertionError(
                f"consensus parity broken{tag}: "
                f"{f} differs on {diff}/{a.size} entries"
            )
    if int(_host(ref.lcr)) != int(_host(out.lcr)):
        raise AssertionError(
            f"consensus parity broken{tag}: "
            f"lcr {int(_host(ref.lcr))} != {int(_host(out.lcr))}"
        )


def consensus_digest(state, n_events: int) -> str:
    """sha256 over every consensus decision of ``state`` (the fields
    ``assert_consensus_parity`` compares, per-event ones cut to the
    first ``n_events`` rows, each in its own dtype's bytes), then lcr
    and max_round.  Either torch tensors or numpy arrays: a JAX state
    passed through ``np.asarray`` hashes the same."""
    h = hashlib.sha256()
    for f in CONSENSUS_EVENT_FIELDS + CONSENSUS_TABLE_FIELDS:
        a = _host(getattr(state, f))
        if f in CONSENSUS_EVENT_FIELDS:
            a = a[:n_events]
        h.update(f.encode() + str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    for f in ("lcr", "max_round"):
        h.update(f.encode() + str(int(_host(getattr(state, f)))).encode())
    return h.hexdigest()
