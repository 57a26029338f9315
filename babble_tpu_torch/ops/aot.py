"""The AOT prewarm: the port's copy of the JAX package's ``ops/aot.py``.

It moves a node's first-use costs from its first gossip flush to its
boot.  In the port those costs are the CUDA context, the lazy loading
of each torch kernel's module at its first launch, the caching
allocator's growth, and the ``nvcc``/``g++`` builds of the hand-written
kernels (``cuda_build``, ``native``).  Three layers, as in JAX:

1. **Cache root** (``configure``): the directory that holds the shape
   manifest, where JAX keeps its persistent XLA cache.  A testnet's
   nodes share one.  The kernel libraries are not kept there: they stay
   in the package's ``_build/`` (``cuda_build``, ``native``), whose file
   names carry a hash of the source, so every node of a checkout shares
   one build and a fresh cache root rebuilds nothing.
2. **Shape manifest** (``record_shape``, ``record_fork_caps``,
   ``record_wide_cfg``, ``load_manifest``): the engines record every
   live-flush key, fork pipeline shape and wide config they ran in
   ``babble_aot_manifest.json`` under the cache root.  The entries are
   the JAX package's JSON, so both packages read one manifest.
3. **Prewarm** (``prewarm_engine``): before the first flush, each
   recorded shape runs once on scratch inputs through the engine's own
   entry (``live_flush``, ``fork_pipeline``, the wide pass), and the
   engine's ``_aot`` set holds the warmed fused keys.  The port has no
   executable to keep: the warm-up is the run itself.

The counters keep JAX's four series names (``bind_registry``,
``compile_counts``), with the port's meanings:

- ``babble_compile_cache_hits_total``: a kernel library found built;
- ``babble_compile_cache_misses_total``: a library that had to be built
  (an ``nvcc`` or ``g++`` run);
- ``babble_xla_compiles_total``: a kernel build that finished;
- ``babble_jit_traces_total``: the first dispatch in this process of a
  fused flush key or a fork pipeline shape (``note_dispatch``); a
  same-shape stream adds zero, and so does a prewarmed shape.

The module imports only the standard library at the top: the kernel
build modules report to it without importing torch.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

#: bump when a change to the flush/ingest/fame/order kernels makes old
#: manifest entries meaningless.  The JAX package's value: both packages
#: key their entries alike and read one manifest.
ENGINE_CACHE_VERSION = "9.0"

_MANIFEST = "babble_aot_manifest.json"

# ----------------------------------------------------------------------
# counters (build events and first dispatches -> obs registries + tests)

_stats = {"cache_hits": 0, "cache_misses": 0, "xla_compiles": 0,
          "traces": 0}
_bound: List[dict] = []          # registry counters fed by _count
_dispatched: set = set()         # shape keys dispatched in this process
_lock = threading.Lock()         # engines flush from several threads
_installed = False


def _count(key: str) -> None:
    with _lock:
        _stats[key] += 1
        bound = list(_bound)
    for b in bound:
        b[key].inc()


def install_listeners() -> None:
    """Subscribe the counters to the kernel build events, once per
    process."""
    global _installed
    from .. import cuda_build

    with _lock:
        if _installed:
            return
        cuda_build.LISTENERS.append(_count)
        _installed = True


def bind_registry(registry) -> None:
    """Expose the counters on a node's registry."""
    install_listeners()
    counters = {
        "cache_hits": registry.counter(
            "babble_compile_cache_hits_total",
            "kernel libraries found already built"),
        "cache_misses": registry.counter(
            "babble_compile_cache_misses_total",
            "kernel libraries that had to be built (an nvcc or g++ run)"),
        "xla_compiles": registry.counter(
            "babble_xla_compiles_total",
            "kernel builds that finished"),
        "traces": registry.counter(
            "babble_jit_traces_total",
            "first dispatches of a flush or pipeline shape not warmed "
            "(a same-shape flush stream adds zero)"),
    }
    with _lock:
        _bound.append(counters)


def compile_counts() -> Dict[str, int]:
    """Process-wide counters (the tests' hook)."""
    with _lock:
        return dict(_stats)


def note_dispatch(key: tuple) -> bool:
    """Count the first dispatch of shape ``key`` in this process as a
    trace; True if it was the first."""
    with _lock:
        if key in _dispatched:
            return False
        _dispatched.add(key)
    _count("traces")
    return True


# ----------------------------------------------------------------------
# cache root

def configure(cache_dir: str) -> None:
    """Make ``cache_dir`` the cache root that holds the shape manifest,
    and count the kernel builds (every surface, cli, testnet and
    prewarm, routes through here).  The libraries stay in ``_build/``
    (module docstring).  Idempotent."""
    os.makedirs(cache_dir, exist_ok=True)
    install_listeners()


def warms_at_boot(device) -> bool:
    """Whether a node on ``device`` prewarms at boot.  Only a card has
    first-use costs to move (the CUDA context, the kernel modules' loads,
    the kernel builds).  On the CPU a first flush costs what any flush
    costs, and the warm-up's flushes, each node process's first torch
    work, only hold back its listen on a host that runs a fleet: such a
    node records its shapes and warms none."""
    return device.type == "cuda"


# ----------------------------------------------------------------------
# shape manifest

def _cfg_key(cfg) -> list:
    # JSON round-trips tuples (the membership plane's retired columns)
    # as lists: normalize so manifest comparison survives reload
    return [list(v) if isinstance(v, tuple) else v for v in cfg]


def manifest_path(cache_dir: str) -> str:
    return os.path.join(cache_dir, _MANIFEST)


def load_manifest(cache_dir: str) -> List[dict]:
    try:
        with open(manifest_path(cache_dir)) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return []
    if not isinstance(data, dict) or data.get("version") != \
            ENGINE_CACHE_VERSION:
        return []
    entries = data.get("entries")
    return entries if isinstance(entries, list) else []


def _record_entry(cache_dir: str, entry: dict) -> None:
    """Append one manifest entry (idempotent; best effort: a read-only
    cache root only loses prewarm).  The read-modify-replace runs under
    an flock'd sidecar, since fleet nodes share one root and concurrent
    writers would otherwise drop each other's entries."""
    try:
        import fcntl

        os.makedirs(cache_dir, exist_ok=True)
        with open(manifest_path(cache_dir) + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            entries = load_manifest(cache_dir)
            if entry in entries:
                return
            entries.append(entry)
            tmp = manifest_path(cache_dir) + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"version": ENGINE_CACHE_VERSION,
                           "entries": entries}, f)
            os.replace(tmp, manifest_path(cache_dir))
    except (OSError, ImportError):
        pass


def record_shape(cache_dir: str, cfg, key: tuple) -> None:
    """Record one fused live-flush key ``(W, F, gate, kpad, t, b)``."""
    _record_entry(cache_dir, {"cfg": _cfg_key(cfg), "key": list(key)})


def record_fork_caps(cache_dir: str, n: int, k: int, caps: tuple,
                     sched: Optional[tuple] = None) -> None:
    """Record a fork pipeline's shape: the monotone capacity triple and
    the bucketed level-schedule dims."""
    entry = {"kind": "fork", "n": int(n), "k": int(k),
             "caps": [int(c) for c in caps]}
    if sched is not None:
        entry["sched"] = [int(s) for s in sched]
    _record_entry(cache_dir, entry)


def record_wide_cfg(cache_dir: str, cfg, n_blocks: int) -> None:
    """Record a wide engine's config and block count."""
    _record_entry(cache_dir, {"kind": "wide", "cfg": _cfg_key(cfg),
                              "n_blocks": int(n_blocks)})


# ----------------------------------------------------------------------
# prewarm

#: keys warmed when the manifest has nothing for this cfg yet: an
#: 8-event flush with 1-4 topological levels under the first W bucket
#: and the smallest frontier bucket, what a fresh live fleet hits within
#: its first heartbeats
_DEFAULT_SHAPES: Tuple[Tuple[int, Tuple[int, int]], ...] = (
    (8, (1, 4)),
    (8, (2, 4)),
)


def _padding_batch(kpad: int, tb: Tuple[int, int], device):
    """An all-padding EventBatch (k = 0) with ``build_batch``'s padding
    values, made on the device (no host array to share memory with)."""
    import torch

    from .ingest import EventBatch

    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=device)

    return EventBatch(
        sp=full((kpad,), -1, torch.int32),
        op=full((kpad,), -1, torch.int32),
        creator=full((kpad,), 0, torch.int32),
        seq=full((kpad,), 0, torch.int32),
        ts=full((kpad,), 0, torch.int64),
        mbit=full((kpad,), False, torch.bool),
        k=torch.tensor(0, dtype=torch.int32, device=device),
        sched=full(tuple(tb), -1, torch.int32),
    )


def _sync(device) -> None:
    """Finish the warm-up's device work at boot, not in the first flush."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prewarm_engine(engine, cache_dir: str,
                   defaults: bool = True,
                   limit: Optional[int] = None) -> Dict[str, int]:
    """Warm the shapes this engine will need, by engine kind.

    **Fused** engines run ``live_flush`` once for each manifest key of
    their exact (DagConfig, ENGINE_CACHE_VERSION), or the default keys
    when the manifest holds none, on an all-padding batch over a
    scratch ``init_state`` (never the engine's state), and add each key
    to ``engine._aot``.  **Fork** engines pre-size to the merged
    recorded capacities and run ``fork_pipeline`` once for each
    recorded schedule bucket on an empty batch (building and launching
    fork_ss).  **Wide** engines run one consensus pass over their empty
    state (launching ss_count), a semantic no-op.

    ``limit`` caps how many fused manifest entries warm, oldest first:
    manifest order is usage order.  Returns {"compiled": shapes warmed,
    "from_manifest": entries used}; the fork and wide results add
    "xla_compiles", the kernel builds the warm-up ran."""
    from . import flush as flush_ops

    configure(cache_dir)
    engine._aot_dir = cache_dir
    if hasattr(engine, "pre_size") and hasattr(engine, "k"):
        return _prewarm_fork(engine, cache_dir)
    if hasattr(engine, "stream"):
        return _prewarm_wide(engine, cache_dir)
    from .state import init_state

    cfg = engine.cfg
    gate = engine.finality_gate

    keys = []
    from_manifest = 0
    for e in load_manifest(cache_dir):
        if e.get("cfg") == _cfg_key(cfg):
            if limit is not None and from_manifest >= limit:
                break
            keys.append(tuple(e["key"]))
            from_manifest += 1
    if not keys and defaults:
        w0 = flush_ops.bucket_w(1, cfg.r_cap)
        # a frontier-off engine's live keys always carry f = e1
        f0 = (flush_ops.bucket_f(1, cfg.e_cap + 1)
              if getattr(engine, "frontier", True) else cfg.e_cap + 1)
        if w0:
            keys = [(w0, f0, gate, kpad) + tb
                    for kpad, tb in _DEFAULT_SHAPES]

    compiled = 0
    scratch = None   # live_flush leaves its input state as it was
    for key in keys:
        if key in engine._aot:
            continue
        w, f, kgate, kpad, t, b = key
        if w > cfg.r_cap or f > cfg.e_cap + 1 or kgate != gate:
            continue
        if scratch is None:
            scratch = init_state(cfg, device=engine.device)
        flush_ops.live_flush(
            cfg, int(w), int(f), bool(kgate), scratch,
            _padding_batch(int(kpad), (int(t), int(b)), engine.device),
        )
        note_dispatch((cfg, key))
        engine._aot.add(key)
        engine._aot_recorded.add(key)
        compiled += 1
    _sync(engine.device)
    return {"compiled": compiled, "from_manifest": from_manifest}


def _empty_fork_batch(cfg, t: int, w: int, device):
    """JAX ``_prewarm_fork``'s empty ForkBatch, on the device."""
    import torch

    from .forks import ForkBatch

    e1, B, s1 = cfg.e_cap + 1, cfg.b, cfg.s_cap + 1

    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=device)

    i32 = torch.int32
    return ForkBatch(
        sp=full((e1,), -1, i32),
        op=full((e1,), -1, i32),
        ebr=full((e1,), B, i32),
        eseq=full((e1,), -1, i32),
        ecr=full((e1,), cfg.n, i32),
        ts=full((e1,), 0, torch.int64),
        mbit=full((e1,), False, torch.bool),
        sched=full((t, w), -1, i32),
        cp=full((B, B), 0, i32),
        ce=full((B, s1), -1, i32),
        cnt=full((B,), 0, i32),
        owner=full((B, s1), False, torch.bool),
        n_events=torch.tensor(0, dtype=i32, device=device),
        rseed=full((e1,), -1, i32),
        wseed=full((e1,), -1, torch.int8),
        s_off=full((B,), 0, i32),
    )


def _prewarm_fork(engine, cache_dir: str) -> Dict[str, int]:
    """Pre-size to the largest recorded capacities for this (n, k) and
    run the pipeline at those caps for every recorded schedule bucket:
    the presized engine calls with exactly these shapes."""
    from .forks import ForkConfig, fork_pipeline

    caps = None
    scheds = set()
    from_manifest = 0
    for e in load_manifest(cache_dir):
        if (e.get("kind") == "fork" and e.get("n") == engine.n
                and e.get("k") == engine.k):
            c = tuple(int(v) for v in e.get("caps", ()))
            if len(c) == 3:
                caps = c if caps is None else tuple(
                    max(a, b) for a, b in zip(caps, c)
                )
                from_manifest += 1
            s = e.get("sched")
            if isinstance(s, list) and len(s) == 2:
                scheds.add((int(s[0]), int(s[1])))
    if caps is None:
        return {"compiled": 0, "from_manifest": 0}
    engine.pre_size(caps)
    cfg = ForkConfig(n=engine.n, k=engine.k, e_cap=caps[0],
                     s_cap=caps[1], r_cap=caps[2])
    before = compile_counts()["xla_compiles"]
    compiled = 0
    for (t, w) in sorted(scheds):
        fork_pipeline(cfg, _empty_fork_batch(cfg, t, w, engine.device))
        note_dispatch((cfg, (t, w)))
        compiled += 1
    _sync(engine.device)
    return {"compiled": compiled,
            "from_manifest": from_manifest,
            "xla_compiles": compile_counts()["xla_compiles"] - before}


def _prewarm_wide(engine, cache_dir: str) -> Dict[str, int]:
    """One consensus pass over the empty window.  Fame and order over an
    all-sentinel window decide nothing, so the pass cannot perturb
    consensus."""
    from_manifest = sum(
        1 for e in load_manifest(cache_dir)
        if e.get("kind") == "wide" and e.get("cfg") == _cfg_key(engine.cfg)
    )
    record_wide_cfg(cache_dir, engine.cfg, engine.stream.C)
    before = compile_counts()["xla_compiles"]
    engine.stream.consensus(final=False)
    engine.state = engine.stream.state
    engine._view = {}
    _sync(engine.device)
    return {"compiled": 1, "from_manifest": from_manifest,
            "xla_compiles": compile_counts()["xla_compiles"] - before}
