"""Native (C++) host components, loaded with ctypes: the port's copy of
the JAX package's ``native/``.

- ``graph_builder.cpp``: bulk random-gossip DAG generation, levels and
  the level schedule (``sim/arrays.py random_gossip_arrays`` and
  ``build_schedule``), bit for bit the pure-Python twin;
- ``baseline_consensus.cpp``: the reference algorithm's consensus
  pipeline (per-event coordinate vectors, memoised strongly-see, virtual
  voting, round received, median timestamps), the independent yardstick
  the batch step is held to at scale.

The sources are the JAX package's, byte for byte.  Each compiles with
``g++ -O3 -shared -fPIC -std=c++17`` at first use into
``babble_tpu_torch/_build/lib<name>-<hash>.so``; the hash is of the source,
so an edited source never loads a stale library.  Builds report to
``cuda_build.LISTENERS`` as the CUDA builds do.  A build
writes a temporary file and renames it into place, so processes that
build one library at once (test workers, a booting testnet) each load a
whole one.  A failed build raises with the compiler's output: there is
no silent fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict

import numpy as np

from .. import cuda_build

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(SRC_DIR), "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIBS: Dict[str, ctypes.CDLL] = {}

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i8p = ctypes.POINTER(ctypes.c_int8)

#: (restype, argtypes) of every exported function, by library
SIGNATURES = {
    "graph_builder": {
        "gossip_dag": (ctypes.c_long, [
            ctypes.c_uint64, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            _i32p, _i32p, _i32p, _i32p, _i64p, _u8p, _i32p, _i32p,
        ]),
        "build_schedule": (ctypes.c_int32, [
            _i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, _i32p,
            _i32p,
        ]),
        "max_level_width": (ctypes.c_int32, [
            _i32p, ctypes.c_int64, ctypes.c_int32, _i32p,
        ]),
    },
    "baseline_consensus": {
        "baseline_consensus": (ctypes.c_int64, [
            ctypes.c_int32, ctypes.c_int64,
            _i32p, _i32p, _i32p, _i32p, _i64p, _u8p,
            _i32p, _u8p, _i32p, _i64p, _i8p,
        ]),
    },
}


@functools.lru_cache(maxsize=None)
def compiler(cxx: str) -> str:
    """The path of the C++ compiler ``cxx``, looked up on PATH once a
    process, as ``cuda_build.nvcc`` is; a name not found stays as given,
    so the build's error names it."""
    return shutil.which(cxx) or cxx


def source_path(name: str) -> str:
    return os.path.join(SRC_DIR, f"{name}.cpp")


def library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str) -> str:
    """Compile ``native/<name>.cpp`` unless its library exists; returns
    the library's path.  Raises ``RuntimeError`` with the compiler's
    output if the compile fails or the compiler is missing."""
    out = library_path(name)
    if os.path.exists(out):
        cuda_build.emit("cache_hits")
        return out
    cuda_build.emit("cache_misses")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(out), suffix=".tmp")
    os.close(fd)
    cmd = [compiler(CXX), *CXX_FLAGS, source_path(name), "-o", tmp]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except OSError as e:
            raise RuntimeError(f"C++ build of {name} failed: {cmd[0]}: "
                               f"{e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"C++ build of {name} failed ({cmd[0]} exit "
                f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
        cuda_build.emit("xla_compiles")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return lib


def load() -> ctypes.CDLL:
    """The graph-builder library, built if needed."""
    return _load("graph_builder")


def available() -> bool:
    """True once the graph builder loads (a failed build raises)."""
    return load() is not None


def load_baseline() -> ctypes.CDLL:
    """The C++ reference-algorithm consensus baseline, built if needed."""
    return _load("baseline_consensus")


def as_ptr(a: np.ndarray, t):
    """A ctypes pointer of type ``t`` to a contiguous array's data (the
    caller keeps ``a`` alive across the native call)."""
    return a.ctypes.data_as(ctypes.POINTER(t))


def baseline_consensus(dag):
    """Run the C++ reference-algorithm pipeline over an ``ArrayDag``.

    Returns ``(ordered_count, arrays)`` with ``round``, ``witness``,
    ``rr``, ``cts`` and ``fame`` (per event: -1 not a witness, 0
    undecided, 1 famous, 2 not famous).  ctypes releases the interpreter
    lock for the call, so it runs beside device work on another thread."""
    lib = load_baseline()
    e = int(dag.n_events)
    rnd = np.empty(e, np.int32)
    wit = np.empty(e, np.uint8)
    rr = np.empty(e, np.int32)
    cts = np.empty(e, np.int64)
    fame = np.empty(e, np.int8)
    sp = np.ascontiguousarray(dag.sp, np.int32)
    op = np.ascontiguousarray(dag.op, np.int32)
    creator = np.ascontiguousarray(dag.creator, np.int32)
    seq = np.ascontiguousarray(dag.seq, np.int32)
    ts = np.ascontiguousarray(dag.ts, np.int64)
    mbit = np.ascontiguousarray(dag.mbit, np.uint8)
    ordered = lib.baseline_consensus(
        int(dag.n), e,
        as_ptr(sp, ctypes.c_int32), as_ptr(op, ctypes.c_int32),
        as_ptr(creator, ctypes.c_int32), as_ptr(seq, ctypes.c_int32),
        as_ptr(ts, ctypes.c_int64), as_ptr(mbit, ctypes.c_uint8),
        as_ptr(rnd, ctypes.c_int32), as_ptr(wit, ctypes.c_uint8),
        as_ptr(rr, ctypes.c_int32), as_ptr(cts, ctypes.c_int64),
        as_ptr(fame, ctypes.c_int8),
    )
    if ordered < 0:
        raise ValueError(f"baseline_consensus refused n={dag.n}, e={e}")
    return int(ordered), {
        "round": rnd, "witness": wit.astype(bool), "rr": rr,
        "cts": cts, "fame": fame,
    }
