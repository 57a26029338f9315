"""Reading the benchmark's definition: ``BENCHMARK.json`` at the root of
the checkout, and the files it names by name.

Nothing here is specific to one cell.  A configuration is
``configs/<config>.json`` (named by its ``file`` in BENCHMARK.json), a
traffic mix ``traffic/<traffic>.json``, a metric ``metrics/<metric>.py``,
an entry (the program's path a configuration drives)
``entries/<entry>.py`` and a plain reference ``reference/<name>.py``.
A later change adds one of each by adding its file and its entry in
BENCHMARK.json.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from typing import List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: top-level module names the run may not hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "babble_tpu")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(items: List[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    entry = _named(bench["configs"], name, "configuration")
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    with ``trace`` off, its per-layer metrics with it on.  A metric with
    a ``workloads`` list is reported only in the cells it lists."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell in m["workloads"]]


def metric_reader(name: str):
    """``metrics/<name>.py`` (a metric name may hold dots, so the file
    is loaded by path)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_name = "port_bench.metrics." + name.replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules[mod_name] = mod
    return mod


def entry(name: str):
    return importlib.import_module(f"port_bench.entries.{name}")


def reference(name: str):
    return importlib.import_module(f"port_bench.reference.{name}")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``babble_tpu_torch`` is not ``babble_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def percentile(values, q: float) -> Optional[float]:
    """The ``q``-th percentile by linear interpolation (numpy's
    default), or None for no values."""
    if not len(values):
        return None
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=float), q))
