"""The benchmark's gossip traffic: seeded random-gossip DAGs as dense
arrays, from the frozen C++ builder beside this file.

A copy of ``babble_tpu_torch/sim/arrays.py random_gossip_arrays`` and of
the ctypes loader in ``babble_tpu_torch/native/__init__.py``, kept here
so that later changes to the program cannot change the traffic.  The
library is built once with g++ into ``port_bench/_build/`` (a fixed
directory inside the checkout, named by a hash of the source) and read
from there by every later run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from dataclasses import dataclass

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "graph_builder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
BASE_TS = 1_700_000_000_000_000_000

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)


@dataclass
class GossipDag:
    """Struct-of-arrays DAG; slot == generation order == topological.
    Roots have ``sp = op = -1``; every other event has both parents."""

    n: int
    sp: np.ndarray        # i32[E] self-parent slot
    op: np.ndarray        # i32[E] other-parent slot
    creator: np.ndarray   # i32[E]
    seq: np.ndarray       # i32[E]
    ts: np.ndarray        # i64[E]
    mbit: np.ndarray      # bool[E]
    levels: np.ndarray    # i32[E]
    seed: int

    @property
    def n_events(self) -> int:
        return len(self.sp)


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libgraph_builder-{digest}.so")


def _build() -> str:
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", SOURCE, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ build of the graph builder failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return out


_LIB = []


def load() -> ctypes.CDLL:
    """The graph-builder library, built if needed."""
    if not _LIB:
        lib = ctypes.CDLL(_build())
        lib.gossip_dag.restype = ctypes.c_long
        lib.gossip_dag.argtypes = [
            ctypes.c_uint64, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, _i32p, _i32p, _i32p, _i32p, _i64p, _u8p, _i32p,
            _i32p,
        ]
        _LIB.append(lib)
    return _LIB[0]


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def gossip_dag(n: int, n_events: int, seed: int,
               ts_granularity_ns: int = 1_000) -> GossipDag:
    """A seeded random-gossip DAG of ``n_events`` events over ``n``
    creators (bit for bit the program's ``random_gossip_arrays``)."""
    if n < 2:
        raise ValueError("gossip needs at least two creators")
    lib = load()
    sp = np.empty(n_events, np.int32)
    op = np.empty(n_events, np.int32)
    creator = np.empty(n_events, np.int32)
    seq = np.empty(n_events, np.int32)
    ts = np.empty(n_events, np.int64)
    mbit = np.empty(n_events, np.uint8)
    levels = np.empty(n_events, np.int32)
    heads = np.empty(n, np.int32)
    lib.gossip_dag(
        ctypes.c_uint64(seed & ((1 << 64) - 1)), n, n_events,
        ts_granularity_ns, BASE_TS,
        _ptr(sp, ctypes.c_int32), _ptr(op, ctypes.c_int32),
        _ptr(creator, ctypes.c_int32), _ptr(seq, ctypes.c_int32),
        _ptr(ts, ctypes.c_int64), _ptr(mbit, ctypes.c_uint8),
        _ptr(levels, ctypes.c_int32), _ptr(heads, ctypes.c_int32),
    )
    return GossipDag(n, sp, op, creator, seq, ts, mbit.astype(bool),
                     levels, seed)


def digest(dag) -> str:
    """sha256 over the DAG's arrays, for pinning the generator."""
    h = hashlib.sha256()
    for f in ("sp", "op", "creator", "seq", "ts", "mbit", "levels"):
        h.update(np.ascontiguousarray(getattr(dag, f)).tobytes())
    return h.hexdigest()
