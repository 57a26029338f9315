"""Build the port's CUDA sources (``csrc/*.cu``) into shared libraries
with a plain C interface, and load them with ctypes.

Each source compiles on its own with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC -Xptxas -v``
into ``_build/lib<name>-<hash>.so`` beside this module, at first use.
The file name carries a hash of the source, so an edited source never
loads a stale library, and a finished library is reused.  ``build``
starts one ``nvcc`` for each source that needs it, all together.

Nothing is built at import: the CPU tests import every module of the
port on machines without a CUDA toolkit.  The toolkit is read once:
``CUDA_HOME`` at import, the compiler's path at the first build.  A
process picks its compiler once, and which compiler runs decides only
whether a library exists, never a value the libraries compute.

Every build reports to ``LISTENERS`` (``ops/aot.py install_listeners``
adds the compile counters): ``"cache_hits"`` for a library found built,
``"cache_misses"`` for one that had to be built, ``"xla_compiles"`` for
a compile that finished.  ``native/`` reports its g++ builds here too.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Callable, Dict, Iterable, List

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: the toolkit root named by the environment, read once at import
CUDA_HOME = os.environ.get("CUDA_HOME", "")

_LIBS: Dict[str, ctypes.CDLL] = {}

#: callables taking one build event name (module docstring)
LISTENERS: List[Callable[[str], None]] = []


def emit(event: str) -> None:
    """Hand one build event to every listener."""
    for fn in LISTENERS:
        fn(event)


@functools.lru_cache(maxsize=1)
def nvcc() -> str:
    """The CUDA compiler, resolved at the first call and kept:
    ``$CUDA_HOME/bin/nvcc``, else the one on PATH, else the toolkit's
    default install location."""
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together.  Returns each name's compiler output
    (the ``-Xptxas -v`` register/shared-memory report), or ``"cached"``.
    Raises if any compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    logs: Dict[str, str] = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            logs[name] = "cached"
            emit("cache_hits")
            continue
        emit("cache_misses")
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
        emit("xla_compiles")
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _LIBS[name] = lib
    return lib
